"""The entry points per architecture: train_step, prefill, decode_step."""
from __future__ import annotations

from typing import Optional

from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw


def build_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                     accum_steps: int = 1):
    """``train_step(opt_state, batch) -> (opt_state, stats)`` over the
    model's parameters, updated in place (``adamw.make_train_step``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    return adamw.make_train_step(model.loss, dict(model.named_parameters()),
                                 opt_cfg, accum_steps)


def build_prefill(model: Model, max_len: int):
    def prefill(batch):
        return model.prefill(batch, max_len)
    return prefill


def build_decode(model: Model):
    def decode(cache, tokens):
        return model.decode_step(cache, tokens)
    return decode
