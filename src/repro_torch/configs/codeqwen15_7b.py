"""codeqwen1.5-7b [dense]: qwen1.5 arch (QKV bias, MHA).

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416 [hf:Qwen/CodeQwen1.5-7B].
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=13440, vocab_size=92416,
        qkv_bias=True, rope_theta=1_000_000.0,
    )
