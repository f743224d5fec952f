"""The lowered serving entry points per architecture: prefill and
decode_step (``build_train_step`` comes with the training slice)."""
from __future__ import annotations

from repro_torch.models import Model


def build_prefill(model: Model, max_len: int):
    def prefill(batch):
        return model.prefill(batch, max_len)
    return prefill


def build_decode(model: Model):
    def decode(cache, tokens):
        return model.decode_step(cache, tokens)
    return decode
