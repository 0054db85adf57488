"""bst [arXiv:1905.06874]: embed_dim=32, behavior seq 20 + target, 1
transformer block (8 heads), MLP 1024-512-256 (twin of
``repro/configs/bst_arch.py``).  Item vocab 10M (shared across all sequence
slots), 8 context fields of 100k."""

from repro_torch.configs.recsys_common import recsys_archdef
from repro_torch.models.recsys import make_bst

ITEM_VOCAB = 10_000_000
CTX = (100_000,) * 8
# slot 20 is the target item (seq_len=20 -> slots 0..19 history, 20 target)
TARGET_SLOT = 20


def make_mdef(batch):
    return make_bst(ITEM_VOCAB, CTX, batch=batch)


ARCH = recsys_archdef("bst", make_mdef, target_slot=TARGET_SLOT)
