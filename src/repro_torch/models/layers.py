"""Shared LM building blocks: norms, MLP, RoPE/M-RoPE, embedding, chunked CE.

Every layer that holds weights is an ``nn.Module`` (``ParamModule``) whose
parameters keep the reference's names, so the functional code reads them
as ``p["name"]`` from a module or from a plain dict of tensors alike (the
compute copy of ``model.cast_params_for_compute`` is such a dict).
Parameters are float32; activations are cast to the config's compute
dtype at use. Sharding is expressed through ``models.sharding.shard``
logical-axis constraints (identity on one device).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.sharding import gather_for_compute, shard

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
    dt = x.dtype
    gate = ACTS[act](x @ cast(p["wi_gate"], dt, None, "ff"))
    up = x @ cast(p["wi_up"], dt, None, "ff")
    h = shard(gate * up, "batch", None, "ff")
    return h @ cast(p["wo"], dt)


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
    # the rows first, then the cast: the same values as casting the table
    y = cast(p["table"][tokens], dtype)
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
    """``torch.mm(a, b, out_dtype=float32)`` on 16-bit operands, with the
    backward PyTorch does not define for it: ``g @ b^T`` and ``a^T @ g``
    with the cotangent at the operands' dtype, products on the tensor
    cores and float32 sums, each cast to its operand's dtype — the
    transpose of the reference's ``dot_general(...,
    preferred_element_type=float32)`` at the TPU's default precision,
    whose passes take 16-bit operands."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g16 = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g16, b.T, out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.T, g16, out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def matmul_f32(a, b):
    """``a @ b`` with float32 products, sums and result, whatever the
    operands' dtype (``preferred_element_type=float32``): 16-bit operands
    go through ``torch.mm(..., out_dtype=float32)`` on the card (its
    gradient by ``_MatmulF32``) and are widened first elsewhere (a product
    of two 16-bit values is exact in float32 either way)."""
    if a.dtype != torch.float32 and a.device.type == "cuda":
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
    the global batch's mask sum); the mask's own sum when None."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    wt = cast(table, x.dtype, "vocab", None)

    def chunk_nll(xc, yc, mc):
        logits = matmul_f32(xc, wt.T)                  # (B, c, V) float32
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        nll = (lse - ll) * mc
        if z_loss:
            nll = nll + z_loss * (lse ** 2) * mc
        return nll.sum()

    def one(lo, hi):
        args = (x[:, lo:hi], labels[:, lo:hi], mask[:, lo:hi])
        if torch.is_grad_enabled():
            return checkpoint(chunk_nll, *args, use_reentrant=False)
        return chunk_nll(*args)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        total = total + one(i * chunk, (i + 1) * chunk)
    if s > n_chunks * chunk:
        total = total + one(n_chunks * chunk, s)
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    return total / denom


def logits_last(x_last, table):
    """Decode-step logits: (B, D) @ (V, D)^T -> (B, V) float32."""
    return matmul_f32(x_last, table.T)
