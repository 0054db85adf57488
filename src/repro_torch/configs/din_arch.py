"""din [arXiv:1706.06978]: embed_dim=18, history 100, attention MLP 80-40,
main MLP 200-80 (twin of ``repro/configs/din_arch.py``).  Item vocab 10M
shared across history+target slots, 4 context fields."""

from repro_torch.configs.recsys_common import recsys_archdef
from repro_torch.models.recsys import make_din

ITEM_VOCAB = 10_000_000
CTX = (100_000, 10_000, 1_000, 100)
# slot 100 is the target item (history slots 0..99)
TARGET_SLOT = 100


def make_mdef(batch):
    return make_din(ITEM_VOCAB, CTX, batch=batch)


ARCH = recsys_archdef("din", make_mdef, target_slot=TARGET_SLOT)
