"""phi3-medium-14b [arXiv:2404.14219]: 40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352, RoPE + SwiGLU (twin of
``repro/configs/phi3_medium_14b.py``)."""

from repro_torch.configs.base import lm_archdef
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=10, d_head=128, d_ff=17920, vocab=100352, microbatch=2,
        tie_embeddings=False)


ARCH = lm_archdef("phi3-medium-14b", config, sub_quadratic=False,
                  momentum=False)
