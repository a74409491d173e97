"""olmoe-1b-7b [moe]: 64 experts, top-8.

16L d_model=2048 16H (kv=16) d_ff=1024/expert vocab=50304
[arXiv:2409.02060; hf].
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304,
        n_experts=64, moe_top_k=8, qk_norm=True, rope_theta=10000.0,
    )
