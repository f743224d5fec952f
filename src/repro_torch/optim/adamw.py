"""AdamW with global-norm clipping, cosine schedule, grad accumulation
(the port's counterpart of ``repro.optim.adamw``).

Parameters, gradients and the moments are flat dicts ``{name: tensor}``
keyed by ``state_dict`` names (``dict(model.named_parameters())``), so
the checkpoint and the weight carrier (``models.convert``) line up. The
update writes the parameters and the moments in place under
``torch.no_grad()``; its arithmetic is the reference's, operation for
operation: the step counted before the schedule, the bias corrections
``1 - b**step`` in float32, the global norm over float32 squares of
every gradient, weight decay on every leaf inside the step.

Elementwise work goes over each leaf in slices of ``_SLICE`` elements,
so the update's temporaries stay a few slices in size whatever the
largest leaf (an embedding table of 1.25 B entries is 5 GB in float32);
elementwise results do not depend on the slicing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def cosine_schedule(cfg: AdamWConfig) -> Callable:
    """``lr(step)``: linear warmup to ``lr_peak``, then a cosine to
    ``lr_min`` at ``decay_steps``; a float32 0-d tensor (on ``step``'s
    device when it is a tensor)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = cfg.lr_peak * torch.clamp(step / max(cfg.warmup_steps, 1),
                                         max=1.0)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.decay_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def init(params: dict) -> dict:
    """Zero moments (float32, each on its parameter's device) and step 0."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"mu": zeros, "nu": {n: torch.zeros_like(z)
                                for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _slices(*tensors):
    """Matching flat slices of same-shaped contiguous tensors."""
    flat = [t.reshape(-1) for t in tensors]
    return zip(*(f.split(_SLICE) for f in flat))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over every leaf of its float32 squares."""
    total = None
    for x in tree.values():
        sq = None
        for (xs,) in _slices(x):
            part = torch.sum(torch.square(xs.to(torch.float32)))
            sq = part if sq is None else sq + part
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
           gnorm: Optional[torch.Tensor] = None):
    """One AdamW step: writes ``params`` and ``state``'s moments in place
    and sets its step. Returns (params, state, stats); stats are 0-d
    tensors ``grad_norm`` (before clipping) and ``lr``.

    ``gnorm``: the global norm when ``grads`` is not the whole gradient
    (the slabs of a sharded one, copies included); ``global_norm(grads)``
    when None. Leaves may lie on several devices: the step's scalars are
    copied to each."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = cosine_schedule(cfg)(step)
    sf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, sf)
    b2c = 1.0 - torch.pow(cfg.b2, sf)
    here = {lr.device: (lr, scale, b1c, b2c)}
    for name, p in params.items():
        if p.device not in here:
            here[p.device] = tuple(None if v is None else v.to(p.device)
                                   for v in (lr, scale, b1c, b2c))
        lr_, scale_, b1c_, b2c_ = here[p.device]
        for ps, gs, ms, vs in _slices(p, grads[name], state["mu"][name],
                                      state["nu"][name]):
            g = gs.to(torch.float32)
            if scale_ is not None:
                g = g * scale_
            ms.copy_(cfg.b1 * ms + (1 - cfg.b1) * g)
            vs.copy_(cfg.b2 * vs + (1 - cfg.b2) * g * g)
            upd = (ms / b1c_) / (torch.sqrt(vs / b2c_) + cfg.eps) \
                + cfg.weight_decay * ps
            ps.copy_(ps - lr_ * upd)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _microbatches(batch: dict, n: int):
    """``batch`` cut along axis 0 into ``n`` contiguous microbatches (the
    reference's reshape to (n, B / n, ...))."""
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} not divisible into {n} "
                         "microbatches")
    m = size // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(loss_fn: Callable, params: dict, cfg: AdamWConfig,
                    accum_steps: int = 1) -> Callable:
    """Builds ``train_step(opt_state, batch) -> (opt_state, stats)`` over
    ``params`` (``{name: Parameter}``, updated in place).

    ``loss_fn(batch)`` returns a 0-d loss on the graph of ``params``.
    accum_steps > 1: the batch is split along axis 0 into microbatches run
    one after another, their losses and gradients averaged, then one
    update. Stats are 0-d tensors ``loss``, ``grad_norm``, ``lr``: nothing
    is read back to the host."""

    def train_step(opt_state, batch):
        for p in params.values():
            p.grad = None
        losses = []
        for mb in _microbatches(batch, accum_steps):
            loss = loss_fn(mb)
            loss.backward()
            losses.append(loss.detach())
        loss = losses[0] if accum_steps == 1 else \
            torch.stack(losses).mean()
        grads = {}
        for n, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = g if accum_steps == 1 else g / accum_steps
            p.grad = None
        _, opt_state, stats = update(params, grads, opt_state, cfg)
        return opt_state, dict(stats, loss=loss)

    return train_step
