"""Unified model configuration covering the 10 assigned architectures.

One ModelConfig describes: decoder-only dense/GQA transformers (global,
sliding-window, and patterned local:global attention), MoE FFNs (top-k,
optional shared expert), Mamba-1 SSM blocks, RG-LRU (Griffin) hybrid blocks,
encoder-decoder (whisper), and stubbed modality frontends (audio frames /
vision patches supplied as precomputed embeddings per the assignment).

Layer structure = `pattern` (a tuple of mixer kinds) cycled over `n_layers`;
layers whose index falls outside full pattern periods are appended verbatim.
Mixer kinds: 'global' | 'local' | 'rglru' | 'mamba'.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False      # llama4-style always-on shared expert
    group_size: int = 1024           # tokens per dispatch group
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    dispatch: str = "gather"         # 'gather' (take/scatter, ~0 dispatch
                                     # FLOPs) | 'einsum' (GShard one-hot
                                     # matmuls; the §Perf baseline)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None    # default ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    conv_width: int = 4
    c: float = 8.0                   # gate exponent constant (Griffin)
    lru_width: Optional[int] = None  # default d_model


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder consuming precomputed frame embeddings (stub)."""
    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple = ("global",)
    head_dim: Optional[int] = None
    window: int = 4096               # sliding window for 'local' mixers
    ffn: str = "mlp"                 # 'mlp' | 'moe' | 'none'
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple] = None   # e.g. (16, 24, 24) for M-RoPE
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    frontend: str = "none"           # 'none' | 'audio_stub' | 'vision_stub'
    # numerics / structure
    dtype: str = "bfloat16"          # activation compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    loss_chunk: int = 512            # sequence chunk for the vocab CE
    attn_q_chunk: Optional[int] = None  # online-softmax q chunking (None=auto)
    scan_layers: bool = True

    # ---- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer mixer kind, pattern cycled across n_layers."""
        return tuple(self.pattern[i % len(self.pattern)]
                     for i in range(self.n_layers))

    @property
    def n_periods(self) -> int:
        """Full pattern periods (scanned); remainder layers are unrolled."""
        return self.n_layers // len(self.pattern)

    @property
    def remainder_kinds(self) -> tuple:
        r = self.n_layers % len(self.pattern)
        return tuple(self.pattern[:r])

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    @property
    def attention_free(self) -> bool:
        return all(k in ("mamba", "rglru") for k in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True if no mixer requires a full-length KV cache at decode
        (SSM / recurrent / bounded-window only)."""
        return all(k in ("mamba", "rglru", "local")
                   for k in self.layer_kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6ND roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.resolved_head_dim, self.n_heads, self.n_kv_heads
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layer_kinds:
            if kind in ("global", "local"):
                total += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            elif kind == "rglru":
                rg = self.rglru or RGLRUConfig()
                w = rg.lru_width or d
                total += (2 * d * w + w * d + rg.conv_width * w
                          + 2 * w * w + 2 * w)
            elif kind == "mamba":
                ssm = self.ssm or SSMConfig()
                di = ssm.expand * d
                dt = ssm.resolved_dt_rank(d)
                total += (2 * d * di + ssm.conv_width * di
                          + di * (dt + 2 * ssm.state_dim) + dt * di
                          + di * ssm.state_dim + di + di * d)
            # FFN
            if self.ffn == "mlp" and kind != "mamba":
                total += 3 * d * f
            elif self.ffn == "moe" and kind != "mamba":
                moe = self.moe
                total += moe.n_experts * 3 * d * f + d * moe.n_experts
                if moe.shared_expert:
                    total += 3 * d * f
            total += 2 * d  # the two norms
        if self.encoder is not None:
            for _ in range(self.encoder.n_layers):
                total += (d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                          + 3 * d * f + 2 * d)
            # decoder cross-attention
            total += self.n_layers * (d * nh * hd + 2 * d * nkv * hd
                                      + nh * hd * d + d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.ffn != "moe":
            return self.param_count()
        moe = self.moe
        dense_ffn = 3 * self.d_model * self.d_ff
        inactive = (moe.n_experts - moe.top_k) * dense_ffn
        return int(self.param_count() - self.n_layers * inactive)
