"""Recurrent mixers: Mamba-1 selective SSM and RG-LRU (Griffin/RecurrentGemma).

Both recurrences are input-gated (time-varying), so the FFT-convolution
path of LTI SSMs — where the fused spectral kernel would apply — does NOT
apply. Prefill solves h_t = a_t h_{t-1} + b_t with a log-depth
(Hillis-Steele) scan over time chunks carrying the state; decode is an
O(1) state update. The last state of a prefill is the decode state.

Memory: Mamba's hidden state is (d_inner, n_state) per position; the
prefill materializes it only per time chunk.

Under a rank that splits the compute over "model"
(``models.sharding.Rank``, M ranks; the reference's ``ff`` rules) each
rank holds d_inner / M (RG-LRU: W / M) channels and runs the conv, the
scan and the decode state on them alone; the layer takes its input in
the residual stream's layout, gathered whole, and returns its output
there. Mamba: its ``in_proj`` columns of its channels of both halves
(``xin`` and ``z``), taken from the ranks that store them
(``sharding.paired_blocks``); ``x_proj`` contracts over the channels, so
its small (dt_rank + 2 state) output is summed over the ranks;
``dt_proj``, ``a_log`` and ``d_skip`` are its channel slices;
``out_proj`` is row-parallel. RG-LRU: its columns of ``gate_proj`` /
``rec_proj``; ``wa`` / ``wx`` contract over the whole width, so the
16-bit ``xc`` is all-gathered once before the products and the rank
computes its output columns; ``out_proj`` is row-parallel. Every sum of
partial products over the ranks is formed in float32 and rounded once.
Where the channels do not divide M the weights are stored whole and the
layer runs as one device (``sharding.whole_layer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import RGLRUConfig, SSMConfig
from repro_torch.models.layers import (ParamModule, cast, matmul_f32,
                                       truncated_normal, uniform)
from repro_torch.models.sharding import (gather_ranks, model_dim,
                                         paired_blocks, reduce_to,
                                         sum_ranks, tp_size, unshard,
                                         whole_layer)

# the channel dim of each decode-state tensor, (h, conv_buf)
STATE_CHANNEL_DIMS = (1, 2)


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (shared by both mixers)
# ---------------------------------------------------------------------------

class Conv1d(ParamModule):
    def __init__(self, width: int, channels: int, device=None):
        super().__init__(device)
        self.param("w", (width, channels))
        self.param("b", (channels,))

    def reset_parameters(self, generator: torch.Generator):
        width = self.w.shape[0]
        self._fill("w", truncated_normal(generator, self.w.shape,
                                         width ** -0.5))
        self._fill("b", torch.zeros_like(self.b))


def conv1d(p, x):
    """Causal depthwise conv. x: (B, S, C) -> (B, S, C); under a rank, its
    channels."""
    dt = x.dtype
    w = cast(p["w"], dt, None, "ff")
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    return y + cast(p["b"], dt, "ff")


def conv1d_step(p, x, buf):
    """Single-step causal conv. x: (B, 1, C); buf: (B, width-1, C) holds the
    previous width-1 inputs. Returns (y, new_buf)."""
    dt = x.dtype
    w = cast(p["w"], dt, None, "ff")
    xs = torch.cat([buf.to(dt), x], dim=1)                 # (B, width, C)
    y = torch.einsum("bwc,wc->bc", xs, w)[:, None, :] + cast(p["b"], dt,
                                                              "ff")
    return y, xs[:, 1:, :].to(buf.dtype)


# ---------------------------------------------------------------------------
# Linear recurrence h_t = a_t * h_{t-1} + b_t  (log-depth scan + chunking)
# ---------------------------------------------------------------------------

def linear_scan(a, b, h0=None, axis: int = 1):
    """Solve h_t = a_t h_{t-1} + b_t along `axis`; a, b same shape.
    h0: initial state (shape = a with `axis` removed). Returns all h_t.

    Hillis-Steele doubling: after the step of offset k every position
    holds the composition of the (up to) 2k maps ending at it."""
    a = a.movedim(axis, 0)
    b = b.movedim(axis, 0)
    s = a.shape[0]
    k = 1
    while k < s:
        b = torch.cat([b[:k], b[k:] + a[k:] * b[:-k]], dim=0)
        a = torch.cat([a[:k], a[k:] * a[:-k]], dim=0)
        k *= 2
    if h0 is not None:
        b = b + a * h0[None]
    return b.movedim(0, axis)


def chunked_linear_scan(a, b, chunk: int, h0):
    """Scan over time chunks carrying the state; within a chunk use the
    log-depth scan. a, b: (B, S, ...); h0: (B, ...). Returns (h, h_last)."""
    s = a.shape[1]
    if s <= chunk:
        h = linear_scan(a, b, h0)
        return h, h[:, -1]
    n = s // chunk
    assert s == n * chunk, "sequence not divisible by ssm chunk"
    hs = []
    h = h0
    for lo in range(0, s, chunk):
        hc = linear_scan(a[:, lo:lo + chunk], b[:, lo:lo + chunk], h)
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1), h


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------

class DtProj(ParamModule):
    def __init__(self, dtr: int, di: int, device=None):
        super().__init__(device)
        self.param("w", (dtr, di))
        self.param("b", (di,))


class Mamba(ParamModule):
    def __init__(self, d: int, cfg: SSMConfig, device=None):
        super().__init__(device)
        di = cfg.expand * d
        dtr = cfg.resolved_dt_rank(d)
        self.param("in_proj", (d, 2 * di))
        self.conv = Conv1d(cfg.conv_width, di, device)
        self.param("x_proj", (di, dtr + 2 * cfg.state_dim))
        self.dt_proj = DtProj(dtr, di, device)
        self.param("a_log", (di, cfg.state_dim))
        self.param("d_skip", (di,))
        self.param("out_proj", (di, d))

    def reset_parameters(self, generator: torch.Generator):
        d, di2 = self.in_proj.shape
        di, n = self.a_log.shape
        dtr = self.dt_proj.w.shape[0]
        self._fill("in_proj", truncated_normal(generator, (d, di2),
                                               d ** -0.5))
        self.conv.reset_parameters(generator)
        self._fill("x_proj", truncated_normal(generator, self.x_proj.shape,
                                              di ** -0.5))
        self.dt_proj._fill("w", truncated_normal(generator, (dtr, di),
                                                 dtr ** -0.5))
        # softplus^-1 of U(1e-3, 1e-1)
        self.dt_proj._fill("b", torch.log(torch.expm1(
            uniform(generator, (di,), 1e-3, 1e-1))))
        # S4D-real initialization for A
        a_init = torch.arange(1, n + 1, dtype=torch.float32,
                              device=self.a_log.device).repeat(di, 1)
        self._fill("a_log", torch.log(a_init))
        self._fill("d_skip", torch.ones_like(self.d_skip))
        self._fill("out_proj", truncated_normal(generator, (di, d),
                                                di ** -0.5))


def _mamba_split(p) -> bool:
    """Whether this rank computes its own channels (no rank: False)."""
    return tp_size() > 1 and model_dim(p["x_proj"]) == 0


def _mamba_terms(p, x, cfg: SSMConfig):
    """Input projection shared by scan/step: x -> (ssm-path input, gate);
    under a rank, of its channels."""
    del cfg
    w = paired_blocks(cast(p["in_proj"], x.dtype, None, "ff"), 1)
    xz = x @ w
    xin, z = torch.chunk(xz, 2, dim=-1)
    return xin, z


def _mamba_ssm_params(p, xc, cfg: SSMConfig):
    dt_ = xc.dtype
    dtr = p["dt_proj"]["w"].shape[0]
    n = cfg.state_dim
    if tp_size() > 1:       # row-parallel: the ranks' partial sums added
        proj = sum_ranks(matmul_f32(
            xc, cast(p["x_proj"], dt_, "ff", None))).to(dt_)
    else:
        proj = xc @ cast(p["x_proj"], dt_)
    dt_in, b_in, c_out = torch.split(
        proj, [dtr, n, proj.shape[-1] - dtr - n], dim=-1)
    dt = F.softplus((dt_in @ cast(p["dt_proj"]["w"], dt_, None, "ff"))
                    .to(torch.float32) + p["dt_proj"]["b"])
    return dt, b_in.to(torch.float32), c_out.to(torch.float32)


def _out(p, y, dt):
    """``y @ out_proj``; under a rank row-parallel over its channels, the
    partial sums reduced in float32 into the residual stream's layout."""
    if tp_size() > 1:
        out = matmul_f32(y, cast(p["out_proj"], dt, "ff", None))
        return reduce_to(out, "batch", "seq", None).to(dt)
    return y @ cast(p["out_proj"], dt)


def mamba_forward(p, x, cfg: SSMConfig, chunk: int = 128, h0=None):
    """x: (B, S, D) -> (y (B, S, D), (h_last, conv_buf)). Training/prefill.

    Discretization, the scan and the C-readout happen per time chunk;
    only the (B, S, d_inner) readout survives the chunk."""
    if tp_size() > 1 and not _mamba_split(p):
        return whole_layer(mamba_forward, p, x, cfg, chunk, h0)
    x = unshard(x, "batch", "seq", None)
    dt_ = x.dtype
    xin, z = _mamba_terms(p, x, cfg)
    xc = F.silu(conv1d(p["conv"], xin))
    dt, b_in, c_out = _mamba_ssm_params(p, xc, cfg)
    y, h = _mamba_scan(p, xc, z, dt, b_in, c_out, cfg, chunk, h0)
    out = _out(p, y, dt_)
    conv_buf = xin[:, -(cfg.conv_width - 1):, :].to(torch.float32)
    return out, (h, conv_buf)


def _mamba_scan(p, xc, z, dt, b_in, c_out, cfg: SSMConfig, chunk: int,
                h0=None):
    """The selective scan of ``xc``'s channels, its C-readout, skip and
    gate: (y (B, S, channels), h_last)."""
    dt_ = xc.dtype
    b, s, _ = xc.shape
    a = -torch.exp(p["a_log"])                                # (di, n)
    if h0 is None:
        h0 = torch.zeros((b, a.shape[0], cfg.state_dim), dtype=torch.float32,
                         device=xc.device)

    xcf = xc.to(torch.float32)
    nc = max(1, s // chunk)
    assert s % nc == 0, (s, chunk)
    cs = s // nc
    h = h0
    ys = []
    for lo in range(0, s, cs):
        sl = slice(lo, lo + cs)
        xck, dtk, bk, ck = xcf[:, sl], dt[:, sl], b_in[:, sl], c_out[:, sl]
        abar = torch.exp(dtk[..., None] * a)           # (B,cs,di,n) transient
        bx = (dtk * xck)[..., None] * bk[:, :, None, :]
        hc = linear_scan(abar, bx, h)
        ys.append(torch.einsum("bsdn,bsn->bsd", hc, ck).to(dt_))
        h = hc[:, -1]
    y = torch.cat(ys, dim=1)
    y = (y.to(torch.float32) + xcf * p["d_skip"]).to(dt_)
    return y * F.silu(z), h


def mamba_step(p, x, cfg: SSMConfig, state):
    """Decode step. x: (B, 1, D); state = (h (B,di,n) f32, conv_buf), under
    a rank of its channels."""
    if tp_size() > 1 and not _mamba_split(p):
        return whole_layer(mamba_step, p, x, cfg, state)
    x = unshard(x, "batch", "seq", None)
    dt_ = x.dtype
    h, buf = state
    xin, z = _mamba_terms(p, x, cfg)
    xc_, new_buf = conv1d_step(p["conv"], xin, buf)
    xc = F.silu(xc_)
    dt, b_in, c_out = _mamba_ssm_params(p, xc, cfg)
    a = -torch.exp(p["a_log"])
    abar = torch.exp(dt[:, 0, :, None] * a)                   # (B,di,n)
    bx = (dt[:, 0] * xc[:, 0].to(torch.float32))[..., None] \
        * b_in[:, 0, None, :]
    h = abar * h + bx
    y = torch.einsum("bdn,bn->bd", h, c_out[:, 0])
    y = (y + xc[:, 0].to(torch.float32) * p["d_skip"]).to(dt_)
    y = (y * F.silu(z[:, 0]))[:, None, :]
    return _out(p, y, dt_), (h, new_buf)


def init_mamba_state(batch: int, d: int, cfg: SSMConfig, device=None):
    di = cfg.expand * d
    return (torch.zeros((batch, di, cfg.state_dim), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, cfg.conv_width - 1, di), dtype=torch.float32,
                        device=device))


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

class RGLRU(ParamModule):
    def __init__(self, d: int, cfg: RGLRUConfig, device=None):
        super().__init__(device)
        w = cfg.lru_width or d
        self.c = cfg.c
        self.param("gate_proj", (d, w))        # gelu branch
        self.param("rec_proj", (d, w))         # recurrent branch
        self.conv = Conv1d(cfg.conv_width, w, device)
        self.param("wa", (w, w))               # recurrence gate
        self.param("wx", (w, w))               # input gate
        self.param("lambda", (w,))
        self.param("out_proj", (w, d))

    def reset_parameters(self, generator: torch.Generator):
        d, w = self.gate_proj.shape
        self._fill("gate_proj", truncated_normal(generator, (d, w),
                                                 d ** -0.5))
        self._fill("rec_proj", truncated_normal(generator, (d, w),
                                                d ** -0.5))
        self.conv.reset_parameters(generator)
        self._fill("wa", truncated_normal(generator, (w, w), w ** -0.5))
        self._fill("wx", truncated_normal(generator, (w, w), w ** -0.5))
        # Lambda init so that a = sigmoid(L)^c spreads over (0.9, 0.999)
        u = uniform(generator, (w,), 0.9, 0.999)
        uc = u ** (1.0 / self.c)
        self._fill("lambda", torch.log(uc / (1.0 - uc)))
        self._fill("out_proj", truncated_normal(generator, (w, d),
                                                w ** -0.5))


def _rglru_split(p) -> bool:
    """Whether this rank computes its own channels (no rank: False)."""
    return tp_size() > 1 and model_dim(p["wa"]) == 1


def _rglru_core(p, xc, cfg: RGLRUConfig):
    """Gate computations shared by scan and step. xc: (B,S,W); under a
    rank its channels, all-gathered whole over W for the gate products,
    which give its columns."""
    xw = gather_ranks(xc, xc.ndim - 1)
    ra = xw @ cast(p["wa"], xc.dtype, None, "ff")
    ia = xw @ cast(p["wx"], xc.dtype, None, "ff")
    return _rglru_gates(p, xc, ra, ia, cfg)


def _rglru_gates(p, xc, ra, ia, cfg: RGLRUConfig):
    """The decay ``a`` and input ``b`` of the recurrence from the gate
    products ``ra`` / ``ia`` of ``xc`` (each of its channels alone)."""
    r = torch.sigmoid(ra.to(torch.float32))
    i = torch.sigmoid(ia.to(torch.float32))
    log_a = -cfg.c * r * F.softplus(p["lambda"])               # (B,S,W) f32
    a = torch.exp(log_a)
    gated_x = i * xc.to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x
    return a, b


def _gelu(x):
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def rglru_forward(p, x, cfg: RGLRUConfig, h0=None, chunk: int = 512):
    """x: (B,S,D) -> (y, (h_last, conv_buf))."""
    if tp_size() > 1 and not _rglru_split(p):
        return whole_layer(rglru_forward, p, x, cfg, h0, chunk)
    x = unshard(x, "batch", "seq", None)
    dt_ = x.dtype
    b_, s, d = x.shape
    gate = _gelu(x @ cast(p["gate_proj"], dt_, None, "ff"))
    xr = x @ cast(p["rec_proj"], dt_, None, "ff")
    xc = conv1d(p["conv"], xr)
    a, bterm = _rglru_core(p, xc, cfg)
    if h0 is None:
        h0 = torch.zeros((b_, a.shape[-1]), dtype=torch.float32,
                         device=x.device)
    h, hlast = chunked_linear_scan(a, bterm, chunk, h0)
    y = _out(p, h.to(dt_) * gate, dt_)
    conv_buf = xr[:, -(cfg.conv_width - 1):, :].to(torch.float32)
    return y, (hlast, conv_buf)


def rglru_step(p, x, cfg: RGLRUConfig, state):
    """Decode step. x: (B, 1, D); state = (h (B,W) f32, conv_buf), under a
    rank of its channels."""
    if tp_size() > 1 and not _rglru_split(p):
        return whole_layer(rglru_step, p, x, cfg, state)
    x = unshard(x, "batch", "seq", None)
    dt_ = x.dtype
    h, buf = state
    gate = _gelu(x @ cast(p["gate_proj"], dt_, None, "ff"))
    xr = x @ cast(p["rec_proj"], dt_, None, "ff")
    xc, new_buf = conv1d_step(p["conv"], xr, buf)
    a, bterm = _rglru_core(p, xc, cfg)
    h = a[:, 0] * h + bterm[:, 0]
    y = _out(p, h[:, None, :].to(dt_) * gate, dt_)
    return y, (h, new_buf)


def init_rglru_state(batch: int, d: int, cfg: RGLRUConfig, device=None):
    w = cfg.lru_width or d
    return (torch.zeros((batch, w), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.conv_width - 1, w), dtype=torch.float32,
                        device=device))
