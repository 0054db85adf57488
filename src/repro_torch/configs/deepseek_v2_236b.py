"""deepseek-v2-236b [arXiv:2405.04434]: 60L d_model=5120 128H, MLA
kv_lora=512 q_lora=1536 qk_nope=128 qk_rope=64 v_head=128; 2 shared + 160
routed experts top-6 (moe intermediate 1536), first layer dense (ff 12288),
vocab 102400 (twin of ``repro/configs/deepseek_v2_236b.py``)."""

from repro_torch.configs.base import lm_archdef
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, d_head=128, d_ff=12288, vocab=102400,
        n_experts=160, top_k=6, moe_d_ff=1536, n_shared_experts=2,
        first_dense_layers=1, capacity_factor=1.0, microbatch=16, prefill_microbatch=2,
        mla=True, q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
        v_head=128, tie_embeddings=False)


ARCH = lm_archdef("deepseek-v2-236b", config, sub_quadratic=False,
                  momentum=False,
                  notes="MLA latent cache (absorbed decode); EP x TP; "
                        "momentum-free Split-SGD for capacity")
