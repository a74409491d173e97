"""qwen3-1.7b [dense]: qk_norm + GQA.

28L d_model=2048 16H (kv=8) d_ff=6144 vocab=151936 [hf:Qwen/Qwen3-8B].
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=6144, vocab_size=151936,
        d_head=128, qk_norm=True, rope_theta=1_000_000.0,
    )
