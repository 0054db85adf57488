"""The paper's three DLRM configs, Tab. I (twin of ``repro/configs/dlrm_paper.py``).

Batch sizes are the paper's strong-scaling global minibatches.
"""

from repro_torch.core.dlrm import DLRMConfig

# the 26 Criteo Terabyte categorical table sizes (copy of repro/configs/fm_arch.py)
CRITEO_TB = (39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
             38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14,
             39979771, 25641295, 39664984, 585935, 12972, 108, 36)


def dlrm_small(mode="row", batch=8192):
    return DLRMConfig(
        name="dlrm-small", num_dense=512, bottom=(512, 512, 64),
        top=(1024, 1024, 1024, 1024), table_rows=(1_000_000,) * 8,
        emb_dim=64, pooling=50, batch=batch, emb_mode=mode)


def dlrm_large(mode="row", batch=16384):
    return DLRMConfig(
        name="dlrm-large", num_dense=2048,
        bottom=(2048,) * 7 + (256,), top=(4096,) * 16,
        table_rows=(6_000_000,) * 64, emb_dim=256, pooling=100,
        batch=batch, emb_mode=mode)


def dlrm_mlperf(mode="row", batch=16384):
    return DLRMConfig(
        name="dlrm-mlperf", num_dense=13, bottom=(512, 256, 128),
        top=(512, 512, 256), table_rows=CRITEO_TB, emb_dim=128,
        pooling=1, batch=batch, emb_mode=mode)
