"""Deterministic synthetic token pipeline with exact skip-ahead resume
(the port's counterpart of ``repro.data.pipeline``).

The stream is a pure function of (seed, step): restoring a run at step k
regenerates exactly the batches a non-failing run would have seen — the
foundation of the exact checkpoint/restart guarantee (no iterator state to
snapshot, no data loss on preemption).

Sequences are learnable, not uniform noise: each sequence is an affine
progression  tok[t] = (a + b*t) % vocab  with per-sequence (a, b),
corrupted at `noise` rate. A model that infers (a, b) from context
predicts the rest, so a falling training loss is a real signal.

The draws come from a CPU ``torch.Generator`` seeded from
``np.random.SeedSequence([seed, step])`` and the batch is then moved to
the stream's device: the CUDA and CPU generators give different numbers,
and one stream must give the card and the CPU the same batches. They
cannot equal ``jax.random``'s: the reference's stream has the same law,
not the same draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05


class TokenStream:
    """Stateless counted stream; ``batch(step)`` is pure. ``device=None``
    is the CUDA card (raises without one); pass ``"cpu"`` here."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _generator(self, step: int) -> torch.Generator:
        seed = np.random.SeedSequence([self.cfg.seed, step]).generate_state(
            2, np.uint32)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed[0]) << 32 | int(seed[1]))
        return gen

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        gen = self._generator(step)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        a = torch.randint(0, v, (b, 1), generator=gen)
        bb = torch.randint(1, min(v, 64), (b, 1), generator=gen)
        t = torch.arange(s + 1)[None, :]
        seq = (a + bb * t) % v
        noise_tok = torch.randint(0, v, (b, s + 1), generator=gen)
        corrupt = torch.rand((b, s + 1), generator=gen) < cfg.noise
        seq = torch.where(corrupt, noise_tok, seq).to(torch.int32)
        seq = seq.to(self.device)
        return {"tokens": seq[:, :-1].contiguous(),
                "labels": seq[:, 1:].contiguous()}

    def batches(self, start_step: int = 0):
        """Infinite iterator starting at `start_step` (resume = seek)."""
        step = start_step
        while True:
            yield step, self.batch(step)
            step += 1
