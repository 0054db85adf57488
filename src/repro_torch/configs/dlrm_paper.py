"""The paper's three DLRM configs, Tab. I, as archs of the registry (twin of
``repro/configs/dlrm_paper.py``).

Each gets TWO train cells: row mode (the production placement beyond the
paper) and table mode (the paper's table-wise hybrid parallelism).  Batch
sizes are the paper's strong-scaling global minibatches.
"""

from repro_torch.configs.base import ArchDef, Cell, CellBuild, register
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


def _archdef(name, cfg_fn, default_batch):
    cells = [Cell("train", "train"), Cell("train_tablewise", "train")]

    def build(shape: str, mesh, batch: int | None = None,
              n_layers: int | None = None,
              cost_mode: bool = False) -> CellBuild:
        """This rank's train step of the cell on ``mesh`` (``train``: row
        mode; ``train_tablewise``: table mode); ``args`` are this rank's
        state and the global batch."""
        from repro_torch.core import dlrm, hybrid

        mode = "table" if shape == "train_tablewise" else "row"
        cfg = cfg_fn(mode=mode, batch=batch or default_batch)
        fn = dlrm.make_train_step(cfg, mesh)
        sstructs = hybrid.state_struct(cfg, mesh)
        bstructs = hybrid.batch_struct(cfg, mesh, hybrid.make_layout(cfg, mesh))
        meta = dict(arch=name, shape=shape, kind="train", family="dlrm",
                    batch=cfg.batch, slots=len(cfg.table_rows),
                    pooling=cfg.pooling, emb_dim=cfg.emb_dim,
                    emb_rows=cfg.spec.total_rows,
                    bottom=cfg.bottom_sizes, top=cfg.top_sizes,
                    scan_unit=1, scan_outside=0, n_layers=1)
        return CellBuild(fn, (sstructs, bstructs), meta, specs=(None, hybrid.batch_specs(cfg, mesh)),
                         model=cfg)

    return register(ArchDef(name, "dlrm", cells, build, notes="paper Tab. I config"))


ARCH_SMALL = _archdef("dlrm-small", dlrm_small, 8192)
ARCH_LARGE = _archdef("dlrm-large", dlrm_large, 16384)
ARCH_MLPERF = _archdef("dlrm-mlperf", dlrm_mlperf, 16384)
