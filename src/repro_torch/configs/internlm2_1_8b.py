"""internlm2-1.8b [arXiv:2403.17297]: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92544 (twin of ``repro/configs/internlm2_1_8b.py``)."""

from repro_torch.configs.base import lm_archdef
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=8, d_head=128, d_ff=8192, vocab=92544,
        tie_embeddings=False, rope_theta=1e6)


ARCH = lm_archdef("internlm2-1.8b", config, sub_quadratic=False,
                  momentum=False, pure_dp=True,
                  notes="pure-DP on the train shape (HC1)")
