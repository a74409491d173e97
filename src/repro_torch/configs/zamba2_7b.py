"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified].  Shared attn block applied every 6 mamba
layers (weights shared across applications).  Sub-quadratic (Mamba state is
O(1); only the shared-attn KV grows) -> eligible for long_500k.
Paper technique (CoralTDA/PrunIT): inapplicable to the forward path (not a
graph model).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_period=6,
        rope_theta=10000.0, supports_long_context=True,
    )
