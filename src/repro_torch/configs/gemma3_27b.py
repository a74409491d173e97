"""gemma3-27b [dense]: 5:1 local:global attention, 128k context.

62L d_model=5376 32H (kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-1b-pt; unverified].  62 = 10x(5 local + 1 global) + 2
local tail.  Local window 1024.  Global layers are full attention ->
long_500k skipped (pure-quadratic global path).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
        n_heads=32, n_kv_heads=16, d_ff=21504, vocab_size=262144,
        d_head=128, qk_norm=True, sliding_window=1024,
        local_global_pattern=(5, 1), rope_theta=1_000_000.0,
    )
