"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified].
O(1) decode state -> eligible for long_500k.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm", rwkv=True, n_layers=24,
        d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
        vocab_size=65536, supports_long_context=True,
    )
