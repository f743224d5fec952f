"""Architecture + shape registry: the 40 assigned (arch x shape) cells.

`get(name)` -> full ModelConfig (exact assigned dimensions).
`smoke(name)` -> reduced same-family config for CPU smoke tests.
`cells()` -> the dry-run matrix with the long_500k skip rules applied
             (sub-quadratic archs run it; pure full-attention archs skip,
             recorded with the reason — see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    falcon_mamba_7b,
    gemma3_12b,
    granite_moe_3b_a800m,
    llama4_scout_17b_a16e,
    minitron_4b,
    qwen2_vl_72b,
    recurrentgemma_9b,
    stablelm_1_6b,
    whisper_tiny,
    yi_34b,
)
from repro_torch.models.config import (
    EncoderConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
)

ARCHS = {
    "recurrentgemma-9b": recurrentgemma_9b.config,
    "minitron-4b": minitron_4b.config,
    "gemma3-12b": gemma3_12b.config,
    "stablelm-1.6b": stablelm_1_6b.config,
    "yi-34b": yi_34b.config,
    "qwen2-vl-72b": qwen2_vl_72b.config,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.config,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.config,
    "whisper-tiny": whisper_tiny.config,
    "falcon-mamba-7b": falcon_mamba_7b.config,
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]()


def smoke(name: str, seq: int = 64) -> ModelConfig:
    """Reduced same-family config: same pattern/ffn/mixers, tiny dims."""
    cfg = get(name)
    period = len(cfg.pattern)
    n_layers = period * 2 + (1 if cfg.remainder_kinds else 0)
    # capacity_factor = n_experts makes routing dropless, so smoke tests can
    # check prefill/decode == full-forward exactly (capacity drops depend on
    # token grouping and legitimately break that equivalence).
    moe = cfg.moe and MoEConfig(
        n_experts=min(cfg.moe.n_experts, 8),
        top_k=min(cfg.moe.top_k, 2),
        capacity_factor=float(min(cfg.moe.n_experts, 8)),
        shared_expert=cfg.moe.shared_expert,
        group_size=seq,
    )
    enc = cfg.encoder and EncoderConfig(n_layers=2, n_frames=32)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        window=min(cfg.window, seq // 4),
        moe=moe,
        ssm=cfg.ssm and SSMConfig(state_dim=4, conv_width=4, expand=2),
        rglru=cfg.rglru and RGLRUConfig(conv_width=4, lru_width=64),
        encoder=enc,
        mrope_sections=cfg.mrope_sections and (4, 2, 2),
        dtype="float32",
        loss_chunk=32,
        remat=False,
    )


# ---------------------------------------------------------------------------
# Shapes (the per-arch input-shape set from the assignment)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k runs only for archs that decode 500k with bounded attention
# (SSM / recurrent / local-dominant); pure full-attention archs skip it.
LONG_OK = {"recurrentgemma-9b", "falcon-mamba-7b", "gemma3-12b"}
SKIP_REASONS = {
    ("minitron-4b", "long_500k"): "pure full attention (O(S) KV per layer)",
    ("stablelm-1.6b", "long_500k"): "pure full attention",
    ("yi-34b", "long_500k"): "pure full attention",
    ("qwen2-vl-72b", "long_500k"): "pure full attention",
    ("llama4-scout-17b-a16e", "long_500k"):
        "1-in-4 global full-attention layers at 500k batch-1 decode",
    ("granite-moe-3b-a800m", "long_500k"): "pure full attention",
    ("whisper-tiny", "long_500k"):
        "enc-dec: decoder positions bounded by design; 500k inapplicable",
}


def cells(include_skipped: bool = False):
    """The (arch, shape, skip_reason|None) dry-run matrix — 40 cells."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            reason = None
            if shape.name == "long_500k" and arch not in LONG_OK:
                reason = SKIP_REASONS[(arch, shape.name)]
            if reason is None or include_skipped:
                out.append((arch, shape.name, reason))
    return out
