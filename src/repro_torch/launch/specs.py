"""Input, cache and parameter specs for every (arch x shape) cell, as
meta tensors: shapes and dtypes, nothing allocated (the port's
counterpart of ``repro.launch.specs``'s ``ShapeDtypeStruct``s).

Modality frontends are stubs: ``batch_specs`` supplies precomputed
frame / patch embeddings beside the token ids.
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig

N_PATCHES = 256  # vision stub: fixed patch count folded into the sequence

_META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, with_labels: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    out = {"tokens": _spec((b, s), i32)}
    if with_labels:
        out["labels"] = _spec((b, s), i32)
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = _spec((b, N_PATCHES, cfg.d_model),
                                    torch.bfloat16)
        if cfg.mrope_sections is not None:
            out["positions"] = _spec((b, s, len(cfg.mrope_sections)), i32)
    if cfg.is_encoder_decoder:
        out["frames"] = _spec((b, cfg.encoder.n_frames, cfg.d_model),
                              torch.bfloat16)
    return out


def decode_token_specs(shape: ShapeSpec) -> torch.Tensor:
    return _spec((shape.global_batch, 1), torch.int32)


def _meta_model(model: Model) -> Model:
    return model if model.device.type == "meta" else Model(model.cfg,
                                                           device=_META)


def cache_specs(model: Model, shape: ShapeSpec) -> dict:
    """The decode cache at full length (the decode cells run one step
    against a seq_len-deep cache), on meta."""
    return _meta_model(model).init_cache(shape.global_batch, shape.seq_len,
                                         device=_META)


def params_specs(model: Model) -> dict:
    """``{state_dict name: meta tensor}`` of the model's parameters."""
    return {n: p.detach() for n, p in
            _meta_model(model).named_parameters()}
