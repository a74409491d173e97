"""qwen2-vl-2b [vlm]: M-RoPE, dynamic resolution (frontend STUB: precomputed
patch embeddings passed as ``vision``).

28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191; hf].
M-RoPE sections (16, 24, 24) over head_dim/2 = 64.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
        d_head=128, qkv_bias=True, mrope_sections=(16, 24, 24),
        vision_tokens=256, rope_theta=1_000_000.0,
    )
