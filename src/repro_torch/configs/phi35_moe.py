"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2.

32L d_model=4096 32H (kv=8) d_ff=6400/expert vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct].
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
        n_experts=16, moe_top_k=2, rope_theta=10000.0,
    )
