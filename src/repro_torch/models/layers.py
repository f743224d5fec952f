"""Shared LM building blocks: norms, MLP, RoPE/M-RoPE, embedding, chunked CE.

Every layer that holds weights is an ``nn.Module`` (``ParamModule``) whose
parameters keep the reference's names, so the functional code reads them
as ``p["name"]`` from a module or from a plain dict of tensors alike (the
compute copy of ``model.cast_params_for_compute`` is such a dict).
Parameters are float32; activations are cast to the config's compute
dtype at use. Sharding is expressed through ``models.sharding``'s
logical-axis layout changes (the identity on one device).

Under a rank that splits the compute over "model"
(``models.sharding.Rank``): ``mlp`` is column-parallel in ``wi_gate`` /
``wi_up`` and row-parallel in ``wo``; ``embed`` and the loss are
vocab-parallel. A row-parallel product's partial sums are formed and
reduced in float32 (``matmul_f32`` then ``reduce_to``) and cast to the
compute dtype once after the sum: one device's bf16 product sums in
float32 and rounds once, and rounding each rank's partial sum to bf16
before the reduction would round M times — the drift the reference's
``gather_for_compute`` docstring measures in whole units of the loss.
The embedding's partial lookups are reduced in the compute dtype: one
rank holds each token's row and the others add zeros, which is exact. In
the backward the column-parallel products' input gradients are partial
sums the same way (over the rank's heads, hidden columns or vocabulary
rows): each rank's is its product's, rounded to the compute dtype as one
device's product rounds and as the reference's transposed ``dot`` rounds
its shard, and the ranks' are summed in float32 and rounded once
(``distributed.mesh.Group``). At bf16 neither order is one device's
(its product sums the whole contraction before rounding once): a split
step's update moves as far from one device's as one device's own step
with its output projections summed in two halves (``chip_smoke.py``
phase 24 (a) holds the split to the step that sums as the ranks do).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.sharding import (carry_context, gather_for_compute,
                                         gather_ranks,
                                         model_dim, own, reduce_to, shard,
                                         sum_ranks, tp_index, tp_size,
                                         unshard, whole_layer, whole_params)

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A config's dtype name ('bfloat16', 'float32', 'f32', ...) as a
    ``torch.dtype``; a ``torch.dtype`` as given."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES.get(dtype) or getattr(torch, dtype)


def cast(x, dtype, *keep):
    """Cast a parameter to the compute dtype at its use site (a no-op on
    the compute copy), and un-shard its FSDP dims (identity on one
    device; see ``sharding.gather_for_compute``). ``keep`` names the
    logical axes of tensor-parallel output dims to leave sharded."""
    return gather_for_compute(x.to(as_dtype(dtype)), *keep)


def truncated_normal(generator: torch.Generator, shape,
                     std) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn from
    ``generator`` on its device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std)


def uniform(generator: torch.Generator, shape, lo: float,
            hi: float) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.uniform_(lo, hi, generator=generator)


class ParamModule(nn.Module):
    """A layer's weights: float32 parameters allocated empty on ``device``
    (``reset_parameters(generator)`` draws them), read as ``p["name"]``."""

    def __init__(self, device=None):
        super().__init__()
        self._device = torch.device(device) if device is not None else None

    def param(self, name: str, shape) -> None:
        self.register_parameter(name, nn.Parameter(torch.empty(
            shape, dtype=torch.float32, device=self._device)))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def _fill(self, name: str, value: torch.Tensor) -> None:
        with torch.no_grad():
            getattr(self, name).copy_(value)


def param_tree(module: nn.Module, values: Optional[dict] = None,
               prefix: str = ""):
    """The reference's parameter pytree of a module: nested dicts (lists
    for ``nn.ModuleList``) of its parameters, no copies — or, given
    ``values`` (``{state_dict name: tensor}``), of those tensors in the
    module's structure."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m, values, f"{prefix}{i}.")
                for i, m in enumerate(module)]
    out = {k: v if values is None else values[prefix + k]
           for k, v in module._parameters.items() if v is not None}
    out.update({k: param_tree(m, values, f"{prefix}{k}.")
                for k, m in module._modules.items()})
    return out


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(ParamModule):
    def __init__(self, d: int, device=None):
        super().__init__(device)
        self.param("scale", (d,))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x, eps: float = 1e-6):
        return rmsnorm(self, x, eps)


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * p["scale"]
    return y.to(dt)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

# jax.nn.gelu is the tanh approximation by default
ACTS = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
        "relu": F.relu}


class MLP(ParamModule):
    def __init__(self, d: int, f: int, device=None):
        super().__init__(device)
        self.param("wi_gate", (d, f))
        self.param("wi_up", (d, f))
        self.param("wo", (f, d))

    def reset_parameters(self, generator: torch.Generator):
        d, f = self.wi_gate.shape
        self._fill("wi_gate", truncated_normal(generator, (d, f), d ** -0.5))
        self._fill("wi_up", truncated_normal(generator, (d, f), d ** -0.5))
        self._fill("wo", truncated_normal(generator, (f, d), f ** -0.5))

    def forward(self, x, act: str = "silu"):
        return mlp(self, x, act)


def mlp(p, x, act: str = "silu"):
    """The gated MLP of ``x`` (B, S, D). Under a rank, ``x`` and the result
    are in the residual stream's layout (its slice of the sequence where
    that is cut): ``x`` is gathered for the rank's columns of the hidden
    dim, its rows of ``wo`` take them, the partial sums reduced in
    float32; where the hidden dim does not divide the ranks, the MLP runs
    whole."""
    if tp_size() > 1:
        dt = x.dtype
        if model_dim(p["wi_gate"]) != 1:
            return whole_layer(lambda pw, xw: (mlp(pw, xw, act),), p, x)[0]
        x = unshard(x, "batch", "seq", None)
        gate = ACTS[act](x @ cast(p["wi_gate"], dt, None, "ff"))
        h = gate * (x @ cast(p["wi_up"], dt, None, "ff"))
        y = matmul_f32(h, cast(p["wo"], dt, "ff", None))
        return reduce_to(y, "batch", "seq", None).to(dt)
    dt = x.dtype
    gate = ACTS[act](x @ cast(p["wi_gate"], dt, None, "ff"))
    up = x @ cast(p["wi_up"], dt, None, "ff")
    return (gate * up) @ cast(p["wo"], dt)


# ---------------------------------------------------------------------------
# RoPE and M-RoPE
# ---------------------------------------------------------------------------

def rope_inv_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_angles(positions, head_dim: int, theta: float,
                sections: Optional[tuple] = None) -> torch.Tensor:
    """positions: (B, S) int or (B, S, C) for M-RoPE with len(sections)==C
    frequency groups. Returns angles (B, S, head_dim // 2) float32."""
    inv = rope_inv_freqs(head_dim, theta, positions.device)
    if sections is None:
        return positions[..., None].to(torch.float32) * inv
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    parts, start = [], 0
    for c, sec in enumerate(sections):
        p = positions[..., c].to(torch.float32)
        parts.append(p[..., None] * inv[start:start + sec])
        start += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x, angles):
    """x: (B, S, H, Dh); angles: (B, S, Dh//2). Split-half rotation."""
    dt = x.dtype
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Embedding + chunked cross-entropy
# ---------------------------------------------------------------------------

class Embedding(ParamModule):
    def __init__(self, vocab: int, d: int, device=None):
        super().__init__(device)
        self.param("table", (vocab, d))

    def reset_parameters(self, generator: torch.Generator):
        self._fill("table", truncated_normal(generator, self.table.shape,
                                             1.0))


def embed(p, tokens, dtype):
    """The rows of ``tokens`` (B, S), cast to ``dtype``, in the residual
    stream's layout. Under a rank holding rows [lo, lo + V / M) of the
    table (vocab-parallel) it looks up the tokens in its rows, zeros for
    the rest, and the ranks' lookups are summed (exactly) into it."""
    table = p["table"]
    if tp_size() > 1 and model_dim(table) == 0:
        n = table.shape[0]
        local = tokens - tp_index() * n
        hit = (local >= 0) & (local < n)
        y = table[torch.where(hit, local, 0)] * hit[..., None]
        return reduce_to(cast(y, dtype), "batch", "seq", None)
    if tp_size() > 1:
        table = whole_params(table)
    # the rows first, then the cast: the same values as casting the table
    y = cast(table[tokens], dtype)
    return shard(y, "batch", "seq", None)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings, (n, d) float32."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    t = torch.arange(n, dtype=torch.float32, device=device)[:, None] \
        * freq[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` (``torch.bmm`` of 3-D
    operands) on 16-bit operands, with the backward PyTorch does not
    define for it: ``g @ b^T`` and ``a^T @ g`` with the cotangent at the
    operands' dtype, products on the tensor cores and float32 sums, each
    cast to its operand's dtype — the transpose of the reference's
    ``dot_general(..., preferred_element_type=float32)`` at the TPU's
    default precision, whose passes take 16-bit operands."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.ndim == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mm = torch.bmm if a.ndim == 3 else torch.mm
        g16 = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = mm(g16, b.transpose(-1, -2),
                    out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = mm(a.transpose(-1, -2), g16,
                    out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def matmul_f32(a, b):
    """``a @ b`` with float32 products, sums and result, whatever the
    operands' dtype (``preferred_element_type=float32``): 16-bit operands
    go through ``torch.mm(..., out_dtype=float32)`` on the card (its
    gradient by ``_MatmulF32``) and are widened first elsewhere (a product
    of two 16-bit values is exact in float32 either way). A 2-D ``b``
    takes ``a``'s leading dims as rows; a 3-D ``b`` (one matrix a batch
    entry, as each expert's) takes a 3-D ``a`` batch by batch."""
    if a.dtype != torch.float32 and a.device.type == "cuda":
        if b.ndim == 3:
            return _MatmulF32.apply(a, b.to(a.dtype))
        lead = a.shape[:-1]
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b.to(a.dtype))
        return out.reshape(*lead, b.shape[-1])
    return a.to(torch.float32) @ b.to(torch.float32)


def lm_loss_chunked(x, table, labels, mask=None, chunk: int = 512,
                    z_loss: float = 0.0, denom=None):
    """Mean next-token CE without materializing (B, S, V) logits.

    x: (B, S, D) final hidden states; table: (V, D) (tied) output
    embedding; labels: (B, S) int; mask: (B, S) 0/1. Logits are formed one
    sequence chunk at a time: ``s // chunk`` full chunks, then the
    remainder, as the reference splits them. With gradients enabled each
    chunk is recomputed in backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), so only one chunk's (B, c, V)
    float32 logits is ever alive. ``denom``: the count to divide the
    summed NLL by (a data position's share of a global batch divides by
    the global batch's mask sum); the mask's own sum when None.

    Under a rank (``x`` in the residual stream's layout): vocab-parallel
    when the table's rows are cut over the ranks — each rank forms its (B,
    c, V / M) logits of the whole chunk, its log-sum-exp and label logit
    are combined across the ranks, and it sums the NLL of its own tokens
    (``own``); otherwise it forms the whole vocabulary's logits of its
    own tokens alone. The ranks' sums add up to the position's."""
    if mask is None:
        mask = torch.ones(labels.shape[:2], dtype=torch.float32,
                          device=x.device)
    mask = mask.to(torch.float32)
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    if tp_size() > 1:
        total = _rank_loss_sum(x, table, labels, mask, chunk, z_loss)
        return total / denom
    s = x.shape[1]
    nll = _nll_sum(cast(table, x.dtype, "vocab", None), z_loss)
    return _chunked(nll, s, chunk, x.device,
                    lambda lo, hi: (x[:, lo:hi], labels[:, lo:hi],
                                    mask[:, lo:hi])) / denom


def _nll_sum(wt, z_loss: float):
    """A chunk's summed NLL against the whole vocabulary's table ``wt``."""
    def chunk_nll(xc, yc, mc):
        logits = matmul_f32(xc, wt.T)                  # (B, c, V) float32
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        nll = (lse - ll) * mc
        if z_loss:
            nll = nll + z_loss * (lse ** 2) * mc
        return nll.sum()
    return chunk_nll


def _chunked(fn, s: int, chunk: int, device, args) -> torch.Tensor:
    """The sum of ``fn(*args(lo, hi))`` over the sequence's chunks
    (``s // chunk`` full ones, then the remainder), each recomputed in the
    backward when gradients are enabled (under the rank and data position
    of its forward, ``_recomputed``)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    if s == 0:
        return total
    chunk = min(chunk, s)
    n_chunks = s // chunk
    again = _recomputed(fn)

    def one(lo, hi):
        if torch.is_grad_enabled():
            return checkpoint(again, *args(lo, hi), use_reentrant=False)
        return fn(*args(lo, hi))

    for i in range(n_chunks):
        total = total + one(i * chunk, (i + 1) * chunk)
    if s > n_chunks * chunk:
        total = total + one(n_chunks * chunk, s)
    return total


def _recomputed(fn):
    """``fn`` run under the mesh rules, data position and rank active now,
    on whichever thread autograd recomputes it."""
    enter = carry_context()

    def run(*args):
        with enter():
            return fn(*args)
    return run


def _rank_loss_sum(x, table, labels, mask, chunk: int, z_loss: float):
    """``lm_loss_chunked``'s summed NLL of a rank's own tokens."""
    dt = x.dtype
    x = unshard(x, "batch", "seq", None)
    b, s, d = x.shape
    mine = own(s)
    if model_dim(table) != 0:
        nll = _nll_sum(cast(whole_params(table), dt), z_loss)
        lo0 = mine.start
        return _chunked(nll, mine.stop - lo0, chunk, x.device,
                        lambda lo, hi: (x[:, lo0 + lo:lo0 + hi],
                                        labels[:, lo0 + lo:lo0 + hi],
                                        mask[:, lo0 + lo:lo0 + hi]))
    wt = cast(table, dt, "vocab", None)                 # (V / M, D)
    n = wt.shape[0]
    first = tp_index() * n

    def stats(xc, yc):
        logits = matmul_f32(xc, wt.T)                   # (B, c, V / M)
        local = yc.long() - first
        hit = (local >= 0) & (local < n)
        ll = torch.gather(logits, -1, torch.where(hit, local, 0)[..., None])
        return torch.logsumexp(logits, dim=-1), ll[..., 0] * hit

    chunk = min(chunk, s)
    bounds = [(lo, min(lo + chunk, s)) for lo in range(0, s // chunk * chunk,
                                                       chunk)]
    if s % chunk:
        bounds.append((s // chunk * chunk, s))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    again = _recomputed(stats)
    for lo, hi in bounds:
        args = (x[:, lo:hi], labels[:, lo:hi])
        if torch.is_grad_enabled():
            lse, ll = checkpoint(again, *args, use_reentrant=False)
        else:
            lse, ll = stats(*args)
        lse = torch.logsumexp(gather_ranks(lse[None], 0), dim=0)
        ll = sum_ranks(ll)
        keep = torch.zeros((hi - lo,), dtype=torch.float32, device=x.device)
        keep[max(mine.start - lo, 0):max(mine.stop - lo, 0)] = 1.0
        mc = mask[:, lo:hi] * keep
        nll = (lse - ll) * mc
        if z_loss:
            nll = nll + z_loss * (lse ** 2) * mc
        total = total + nll.sum()
    return total


def logits_last(x_last, table):
    """Decode-step logits: (B, D) @ (V, D)^T -> (B, V) float32. Under a
    rank holding rows of the table, its (B, V / M) logits all-gathered
    whole on every rank."""
    if tp_size() > 1:
        if model_dim(table) == 0:
            return gather_ranks(matmul_f32(x_last, table.T), 1)
        table = whole_params(table)
    return matmul_f32(x_last, table.T)
