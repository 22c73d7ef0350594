"""Unified model configuration for the 10 assigned architectures.

Counterpart of ``repro/models/config.py``, copied as plain data: one
``ModelConfig`` drives :mod:`repro_torch.models.transformer`, for every
block kind, and ``param_count`` agrees with the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "RGLRUConfig",
           "EncoderConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeek-style
    d_expert: int = 0            # FFN hidden size per routed expert
    aux_loss_coef: float = 0.01  # load-balance auxiliary loss
    first_dense: int = 0         # leading layers that stay dense (DeepSeek: 1)
    # "ragged": sort + grouped matmuls (exact, no token dropping).
    # "capacity": fixed-capacity gather -> batched einsum -> scatter
    #           (MaxText-style; drops overflow tokens at capacity_factor).
    dispatch: str = "ragged"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank queries (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU temporal-mixing block."""

    d_conv: int = 4
    c: float = 8.0               # the RG-LRU exponent scale
    block_width: int = 0         # lru width; 0 -> d_model


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder for enc-dec archs (whisper). Frontend is a stub: input_specs
    provides (batch, n_frames, d_model) frame embeddings."""

    n_layers: int = 24
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # block pattern: tuple of per-layer kinds cycled over n_layers.
    # kinds: "attn", "mla", "ssd", "rglru", "local"  (local = sliding attn)
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp_act: str = "swiglu"      # swiglu | gelu
    attn_bias: bool = False      # qwen2-style QKV bias
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 = full attention ("local" blocks need > 0)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_prefix_tokens: int = 0     # VLM: patch-embedding prefix length
    remat: bool = True           # checkpoint each block (training)
    logit_chunk: int = 0         # 0 = unchunked LM head / loss

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k routed experts).
        Used for MODEL_FLOPS = 6·N_active·D in the roofline."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        e = self.moe
        mult = 3 if self.mlp_act == "swiglu" else 2
        per_expert = mult * self.d_model * e.d_expert
        n_moe_layers = max(self.n_layers - e.first_dense, 0)
        inactive = n_moe_layers * (e.n_experts - e.top_k) * per_expert
        return total - inactive

    def param_count(self) -> int:
        """Exact parameter count of the constructed model (counted at init in
        tests; this analytic version is used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            total += d if kind == "ssd" else 2 * d  # RMSNorm gains
            if kind in ("attn", "local"):
                q = d * self.n_heads * hd + (self.n_heads * hd if self.attn_bias else 0)
                kv = 2 * (d * self.n_kv_heads * hd + (self.n_kv_heads * hd if self.attn_bias else 0))
                o = self.n_heads * hd * d
                total += q + kv + o
            elif kind == "mla":
                m = self.mla
                total += d * m.kv_lora_rank                       # W_dkv
                total += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                total += d * m.qk_rope_head_dim                   # shared rope key
                total += d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                total += self.n_heads * m.v_head_dim * d          # W_o
            elif kind == "ssd":
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
                total += s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
                total += 3 * nheads                               # A_log, D, dt_bias
                total += d_in                                     # gate norm
                total += d_in * d                                 # out proj
            elif kind == "rglru":
                r = self.rglru
                w = r.block_width or d
                # w_in + w_a + w_x + conv + Λ + w_out
                total += d * w + 2 * w * w + r.d_conv * w + w + w * d
            # MLP / MoE
            if kind == "ssd":
                continue  # mamba block has no separate MLP
            if self.moe is not None and i >= self.moe.first_dense:
                e = self.moe
                total += d * e.n_experts                          # router
                mult = 3 if self.mlp_act == "swiglu" else 2
                total += e.n_experts * mult * d * e.d_expert
                total += e.n_shared * mult * d * (e.d_expert or self.d_ff)
            else:
                mult = 3 if self.mlp_act == "swiglu" else 2
                total += mult * d * self.d_ff
        total += d  # final norm
        if self.n_prefix_tokens:
            total += d * d  # VLM projector
        if self.encoder is not None:
            enc = self.encoder
            total += d  # encoder final norm
            for _ in range(enc.n_layers):
                total += 2 * d
                total += 4 * d * self.n_heads * hd                # self-attn (MHA)
                mult = 3 if self.mlp_act == "swiglu" else 2
                total += mult * d * self.d_ff
            # decoder cross-attention (added to every decoder layer)
            total += self.n_layers * (4 * d * self.n_heads * hd + d)
        return total
