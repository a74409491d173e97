"""whisper-base [audio]: enc-dec backbone; conv frontend is a STUB
(precomputed frame embeddings are passed as ``frames``).

6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048 vocab=51865
[arXiv:2212.04356; unverified].  Deviation: RoPE instead of learned
positional embeddings (keeps cache shapes static across shape cells); noted
in ``repro``'s config.  Plain (non-gated) GELU MLP as in the original.
long_500k skipped (full-attention decoder).

Vocab padded 51865 -> 51872 (Megatron-style padding to the 16-way TP axis;
the 7 pad ids are never emitted by the tokenizer stub and never appear as
labels, so the loss is unchanged).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec", n_layers=6, n_enc_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51872,
        enc_seq=1500, gated_mlp=False, rope_theta=10000.0,
    )
