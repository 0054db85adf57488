"""fm [Rendle ICDM'10]: 39 sparse fields, embed_dim 10, 2-way FM via the
O(nk) sum-square trick (twin of ``repro/configs/fm_arch.py``).  Tables: the
26 Criteo-TB categorical sizes + 13 bucketized-dense fields of 1000 rows.
The unified rows are E = 11: dims 0..9 the factor vector, dim 10 the linear
weight."""

from repro_torch.configs.dlrm_paper import CRITEO_TB
from repro_torch.configs.recsys_common import recsys_archdef
from repro_torch.models.recsys import make_fm

TABLES = CRITEO_TB + (1000,) * 13          # 39 fields
TARGET_SLOT = 0


def make_mdef(batch):
    return make_fm(TABLES, batch=batch)


ARCH = recsys_archdef("fm", make_mdef, target_slot=TARGET_SLOT,
                      notes="unified E=11 rows: dims 0..9 factor vector, "
                            "dim 10 linear weight")
