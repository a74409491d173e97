"""Model configuration for the assigned architecture zoo (counterpart of
``repro.models.config``, field for field)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    sliding_window: int = 0  # 0 = full attention
    local_global_pattern: Tuple[int, int] = (0, 0)  # (n_local, n_global) per period

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # Mamba2 (hybrid / ssm families)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_period: int = 0  # hybrid: one shared attn block per `attn_period` ssm layers

    # RWKV6
    rwkv: bool = False

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0  # stubbed conv-frontend frames
    gated_mlp: bool = True

    # VLM (qwen2-vl)
    mrope_sections: Tuple[int, ...] = ()
    vision_tokens: int = 0

    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    # long_500k eligibility (sub-quadratic sequence mixing)
    supports_long_context: bool = False

    # compute knobs (not architecture): chunk sizes etc.
    attn_chunk: int = 1024  # query-chunked attention threshold block
    ssm_chunk: int = 256
    # MoE dispatch group size (tokens per routing block).  0 = one global
    # group (the naive formulation: (T,E,C) dispatch tensors with C ∝ T,
    # quadratic flops).  Block-local capacity is the standard
    # GSPMD-MoE/Switch "group_size".
    moe_group: int = 4096

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def q_heads(self) -> int:
        return self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, dh = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * dh * (self.q_heads + 2 * self.kv_heads) + self.q_heads * dh * d
        if self.gated_mlp:
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family == "moe":
            mlp_layer = self.n_experts * mlp + d * self.n_experts
            per_layer = attn + mlp_layer
            total = self.n_layers * per_layer
        elif self.family in ("ssm",) and self.rwkv:
            # rwkv6: r/k/v/g/o (D,D) + w lora + channel-mix (D,3.5D-ish)
            tm = 5 * d * d + 2 * d * 64
            cm = 2 * d * self.d_ff
            total = self.n_layers * (tm + cm)
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            m_layer = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * d
            n_attn = self.n_layers // max(self.attn_period, 1)
            total = self.n_layers * m_layer + (attn + mlp)  # attn block shared
            total += 0 * n_attn
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp)
            dec = self.n_layers * (2 * attn + mlp)
            total = enc + dec
        else:
            total = self.n_layers * (attn + mlp)
        return int(total + emb + d)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dh = self.head_dim
        attn = d * dh * (self.q_heads + 2 * self.kv_heads) + self.q_heads * dh * d
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff * self.moe_top_k
        emb = self.vocab_size * d
        return int(self.n_layers * (attn + mlp + d * self.n_experts) + emb + d)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length, global batch, kind."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    grad_accum: int = 1  # train only


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256, grad_accum=8),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
