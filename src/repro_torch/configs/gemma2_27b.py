"""gemma2-27b [arXiv:2408.00118]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; alternating local(4096)/global attention, attn softcap 50,
final softcap 30, tied + scaled embeddings (twin of
``repro/configs/gemma2_27b.py``)."""

from repro_torch.configs.base import lm_archdef
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
        n_kv_heads=16, d_head=128, d_ff=36864, vocab=256000,
        local_global=True, window=4096, attn_softcap=50.0,
        final_softcap=30.0, microbatch=4, loss_chunk=256, embed_scale=True, tie_embeddings=True)


ARCH = lm_archdef("gemma2-27b", config, sub_quadratic=True, momentum=False,
                  notes="hybrid local/global -> long_500k runs")
