"""sasrec [arXiv:1808.09781]: embed_dim=50, 2 blocks, 1 head, seq_len=50
(twin of ``repro/configs/sasrec_arch.py``).  Item vocab 4M shared across
seq/pos/neg slots."""

from repro_torch.configs.recsys_common import recsys_archdef
from repro_torch.models.recsys import make_sasrec

ITEM_VOCAB = 4_000_000
# slot 50 = first "positive" slot doubles as the scoring target at serve time
TARGET_SLOT = 50


def make_mdef(batch):
    return make_sasrec(ITEM_VOCAB, batch=batch)


ARCH = recsys_archdef("sasrec", make_mdef, target_slot=TARGET_SLOT)
