"""The LM model zoo (counterpart of ``repro.models``): dense, MoE,
Mamba2-hybrid, RWKV6, enc-dec and VLM families built from a
``ModelConfig``."""
