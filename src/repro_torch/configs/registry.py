"""Architecture registry: --arch <id> -> ModelConfig (counterpart of
``repro.configs.registry``)."""
from __future__ import annotations

import importlib

ARCHS = {
    "zamba2-7b": "zamba2_7b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen1.5-4b": "qwen15_4b",
    "gemma3-27b": "gemma3_27b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "whisper-base": "whisper_base",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "tda_ego": "tda_ego",
}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config()


def reduced_config(arch: str):
    """Tiny same-family config for CPU smoke tests."""
    import dataclasses

    cfg = get_config(arch)
    if arch == "tda_ego":
        return cfg
    updates = dict(
        n_layers=min(cfg.n_layers, 4), d_model=128, d_ff=256, vocab_size=512,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // cfg.n_heads, 4)),
        d_head=32 if cfg.d_head else 0, attn_chunk=64, ssm_chunk=32,
    )
    if cfg.family == "moe":
        updates.update(n_experts=8, moe_top_k=2)
    if cfg.family == "hybrid":
        updates.update(n_layers=7, attn_period=3, ssm_state=16, ssm_head_dim=16)
    if cfg.local_global_pattern != (0, 0):
        updates.update(n_layers=5, local_global_pattern=(1, 1), sliding_window=8)
    if cfg.family == "encdec":
        updates.update(n_layers=2, n_enc_layers=2, enc_seq=16)
    if cfg.mrope_sections:
        updates.update(mrope_sections=(4, 6, 6), vision_tokens=4)
    return dataclasses.replace(cfg, **updates)
