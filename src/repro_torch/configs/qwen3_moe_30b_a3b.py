"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d_model=2048 32H (GQA kv=4)
moe intermediate 768, vocab 151936, 128 experts top-8 (twin of
``repro/configs/qwen3_moe_30b_a3b.py``)."""

from repro_torch.configs.base import lm_archdef
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=768, vocab=151936,
        n_experts=128, top_k=8, moe_d_ff=768, capacity_factor=1.0, microbatch=4,
        tie_embeddings=False, rope_theta=1e6)


ARCH = lm_archdef("qwen3-moe-30b-a3b", config, sub_quadratic=False,
                  momentum=True,
                  notes="MoE EP over 'data' x TP over 'model'; the MoE "
                        "dispatch reshard is the paper's hybrid-parallel "
                        "all-to-all pattern")
