"""GQA attention: global causal, sliding-window local, bidirectional
(encoder), cross-attention, with full and ring KV caches for decode.

Numerics: logits and softmax in float32 regardless of compute dtype (the
operands are widened before the score product, as the reference's
``preferred_element_type=float32``), the weights cast back to the query's
dtype. Masked edges take ``NEG_INF``, not -inf, so a fully masked ring
slot stays finite. Memory: optional query chunking keeps the (Sq, Skv)
score matrix bounded at Sq_chunk * Skv.

Decode writes the new key and value into the cache in place and returns
the same cache dict. A cache cut along its sequence (batch-1 decode under
a mesh: ``kv_seq`` over "data") comes as ``{"parts": [KVPart, ...]}``,
the parts in sequence order: the new key and value are written into the
part holding the slot, and each part is attended apart, the parts merged
by log-sum-exp (``sdpa_parts``), its mask on the part's absolute
positions.

Under a rank that splits the compute over "model"
(``models.sharding.Rank``, M ranks): the input, in the residual stream's
layout, is all-gathered (``sharding.unshard``), and each rank computes its
``n_heads / M`` query heads from its columns of ``wq``, attends, and
multiplies by its rows of ``wo``; the partial sums are reduced in
float32 into the residual stream's layout. Keys and
values take ``_kv_spec``'s layout: where the kv heads divide M a rank
projects its own kv heads (and its KV cache slab holds them); otherwise
its column slab of ``wk`` / ``wv`` is projected and the products are
all-gathered whole (a collective of the activations, not the weights),
and the rank reads the kv heads its query heads use (``_kv_select``);
its cache slab is then its part of head_dim, and the serving layer
hands it the cache whole over "model" to read, writing back its slab
alone. Cross-attention (whisper's decoder) splits the same way: its
queries from the rank's stream, its keys and values from the encoder
output whole over the sequence, and in decode the rank reads its own
heads of the cross cache (or, where the kv heads do not divide M, the
cache whole and ``_kv_select``). Where ``n_heads % M != 0``
(minitron-4b, yi-34b, granite and llama4 at M = 16, whisper-tiny at M =
4) every rank computes the attention whole, on weights all-gathered
whole (``sharding.whole_layer``, a collective counted as such), and
keeps its slice of the output: the simpler of the two ways the
reference's GSPMD padding allows, at M times the attention's compute.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.layers import (ParamModule, apply_rope, cast,
                                       matmul_f32, rope_angles,
                                       truncated_normal)
from repro_torch.models.sharding import (axis_size, model_dim, reduce_to,
                                         tp_index, tp_size, unshard,
                                         whole_layer)


def _kv_spec(n_kv: int, head_dim: int) -> tuple:
    """KV tensors (B, S, K, Dh): shard heads over "model" only when K
    divides it; fall back to head_dim, then replicated."""
    m = axis_size("heads")
    if m > 1 and n_kv % m == 0:
        return (None, "heads", None)
    if m > 1 and head_dim % m == 0:
        return (None, None, "heads")
    return (None, None, None)


def _heads_split(p, spec) -> bool:
    """Whether a rank computes its own heads (the query heads divide the
    ranks and ``wq``'s columns are cut over them)."""
    m = tp_size()
    return m > 1 and spec.n_heads % m == 0 and model_dim(p["wq"]) == 1


def _kv_local(spec) -> bool:
    """Under a head-split rank: whether it holds its own kv heads."""
    return _kv_spec(spec.n_kv, spec.head_dim)[1] == "heads"


def _qkv(p, spec, x, src):
    """q of ``x`` and k, v of ``src``, split into heads: all of them, or
    under a head-split rank its query heads, and its kv heads or (where
    they do not divide the ranks) all of them."""
    dt = x.dtype
    hq = spec.n_heads // tp_size()
    q = _split_heads(x @ cast(p["wq"], dt, None, "heads"), hq, spec.head_dim)
    out = [q]
    for name in ("wk", "wv"):
        y = src @ cast(p[name], dt, None, "heads")
        n = spec.n_kv
        if tp_size() > 1:
            if _kv_local(spec):
                n //= tp_size()
            elif model_dim(p[name]) == 1:
                y = unshard(y, None, None, "heads")
        out.append(_split_heads(y, n, spec.head_dim))
    return out


def _kv_select(spec):
    """Under a head-split rank whose kv heads are whole: the kv heads its
    query heads read, in order (a contiguous run where each is read by
    equally many of them, else one a query head); the identity
    otherwise."""
    m = tp_size()
    if m == 1 or _kv_local(spec):
        return lambda t: t
    hq = spec.n_heads // m
    g = spec.n_heads // spec.n_kv
    idx = [(tp_index() * hq + j) // g for j in range(hq)]
    run = sorted(set(idx))
    if hq % len(run) == 0 and idx == [h for h in run
                                      for _ in range(hq // len(run))]:
        return lambda t: t[:, :, run[0]:run[-1] + 1]
    return lambda t: t[:, :, idx]


def _out(p, o, dt):
    """The output projection of ``o`` (B, S, heads x Dh): under a rank, its
    rows of ``wo``, the partial sums reduced in float32 into the residual
    stream's layout."""
    if tp_size() > 1:
        y = matmul_f32(o, cast(p["wo"], dt, "heads", None))
        return reduce_to(y, "batch", "seq", None).to(dt)
    return o @ cast(p["wo"], dt)


NEG_INF = -1e30


class Attention(ParamModule):
    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int,
                 device=None):
        super().__init__(device)
        self.param("wq", (d, n_heads * head_dim))
        self.param("wk", (d, n_kv * head_dim))
        self.param("wv", (d, n_kv * head_dim))
        self.param("wo", (n_heads * head_dim, d))

    def reset_parameters(self, generator: torch.Generator):
        d, hq = self.wq.shape
        for name in ("wq", "wk", "wv"):
            self._fill(name, truncated_normal(
                generator, getattr(self, name).shape, d ** -0.5))
        self._fill("wo", truncated_normal(generator, self.wo.shape,
                                          hq ** -0.5))


def _split_heads(x, n, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n, head_dim)


def _score_mask(q_pos, k_pos, causal: bool, window: Optional[int],
                k_valid=None):
    """(B, Sq, Skv) bool mask of allowed attention edges.

    q_pos/k_pos: (B, Sq)/(B, Skv) int absolute positions.
    window W: only k in (q - W, q] (combined with causal).
    k_valid: (B, Skv) bool for cache slots that are populated.
    """
    d = q_pos[:, :, None] - k_pos[:, None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m = m & (d >= 0)
    if window is not None:
        m = m & (d < window)
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return m


def sdpa(q, k, v, mask, q_chunk: Optional[int] = None):
    """q: (B,Sq,H,Dh), k/v: (B,Skv,K,Dh), mask: (B,Sq,Skv) -> (B,Sq,H,Dh).

    GQA: H = G*K query heads share K kv heads. float32 softmax.

    Prefill (Sq > 1) repeats the kv heads to H; decode (Sq == 1) keeps the
    grouped einsum, so the KV cache is read once.
    """
    b, sq, h, dh = q.shape
    kheads = k.shape[2]
    g = h // kheads
    scale = dh ** -0.5

    if sq == 1:
        qg = q.reshape(b, sq, kheads, g, dh)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                              k.to(torch.float32)) * scale
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
        return o.reshape(b, sq, h, dh)

    kf = torch.repeat_interleave(k, g, dim=2) if g > 1 else k   # (B,Skv,H,Dh)
    vf = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
    kf32 = kf.to(torch.float32)

    def block(qc, mc):
        # qc: (B,c,H,Dh), mc: (B,c,Skv)
        logits = torch.einsum("bqhd,bshd->bhqs", qc.to(torch.float32),
                              kf32) * scale
        logits = torch.where(mc[:, None], logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqs,bshd->bqhd", w, vf)

    if q_chunk is None or sq <= q_chunk:
        return block(q, mask)
    return torch.cat([block(q[:, lo:lo + q_chunk], mask[:, lo:lo + q_chunk])
                      for lo in range(0, sq, q_chunk)], dim=1)


def sdpa_parts(q, parts):
    """Decode attention over a sequence in parts: q (B, 1, H, Dh), parts a
    list of (k, v, mask), k / v (B, S_j, K, Dh) and mask (B, 1, S_j).
    Each part's float32 logits give its max m_j and sum l_j of
    exp(logit - m_j); the parts merge by log-sum-exp (M = max m_j, L =
    sum exp(m_j - M) l_j), each part's weights exp(logit - m_j) exp(m_j -
    M) / L are cast to q's dtype as ``sdpa``'s softmax is, and the parts'
    products with v are summed in float32."""
    b, sq, h, dh = q.shape
    kheads = parts[0][0].shape[2]
    g = h // kheads
    scale = dh ** -0.5
    qg = q.reshape(b, sq, kheads, g, dh).to(torch.float32)
    stats = []
    for k, _, mask in parts:
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                              k.to(torch.float32)) * scale
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        stats.append((m, e, e.sum(dim=-1, keepdim=True)))
    big = torch.stack([m for m, _, _ in stats]).amax(dim=0)
    total = sum(torch.exp(m - big) * s for m, _, s in stats)
    o = None
    for (m, e, _), (_, v, _) in zip(stats, parts):
        w = (e * (torch.exp(m - big) / total)).to(q.dtype)
        oj = torch.einsum("bkgqs,bskd->bqkgd", w.to(torch.float32),
                          v.to(torch.float32))
        o = oj if o is None else o + oj
    return o.to(q.dtype).reshape(b, sq, h, dh)


@dataclasses.dataclass
class KVPart:
    """One part of a KV cache cut along its sequence: ``k`` / ``v`` (B,
    S_j, K, Dh) the cache's slots [lo, lo + S_j), and for a ring cache
    ``pos`` (B, S_j) those slots' positions (-1: empty)."""
    k: torch.Tensor
    v: torch.Tensor
    lo: int
    pos: Optional[torch.Tensor] = None


def decode_slot(pos: int, length: int, ring: bool) -> int:
    """The cache slot a decode step at ``pos`` writes: ``pos`` in a full
    cache, ``pos % length`` in a ring."""
    return pos % length if ring else pos


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_full_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                    dtype, device=None) -> dict:
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ring_cache(batch: int, window: int, n_kv: int, head_dim: int,
                    dtype, device=None) -> dict:
    shape = (batch, window, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, window), -1, dtype=torch.int32,
                              device=device)}


# ---------------------------------------------------------------------------
# The attention block (train / prefill / decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None          # None = global
    theta: float = 10_000.0
    sections: Optional[tuple] = None      # M-RoPE
    use_rope: bool = True
    q_chunk: Optional[int] = None


def attn_forward(p, spec: AttnSpec, x, positions, k_pos=None, xkv=None):
    """Training/prefill forward. x: (B,S,D). Returns (out, (k, v)) with k/v
    rotated (ready for caching). Under a rank ``x`` and ``out`` are in the
    residual stream's layout; ``xkv`` (cross-attention's keys' and
    values' source, the encoder output) is whole over its sequence."""
    if tp_size() > 1 and not _heads_split(p, spec):
        return whole_layer(
            lambda pw, xw: attn_forward(pw, spec, xw, positions, k_pos, xkv),
            p, x)
    x = unshard(x, "batch", "seq", None)
    q, k, v = _qkv(p, spec, x, x if xkv is None else xkv)
    dt = q.dtype
    kp = positions if k_pos is None else k_pos
    if spec.use_rope:
        q = apply_rope(q, rope_angles(positions, spec.head_dim, spec.theta,
                                      spec.sections))
        k = apply_rope(k, rope_angles(kp, spec.head_dim, spec.theta,
                                      spec.sections))
    mask = _score_mask(positions if positions.ndim == 2 else positions[..., 0],
                       kp if kp.ndim == 2 else kp[..., 0],
                       spec.causal, spec.window)
    sel = _kv_select(spec)
    o = sdpa(q, sel(k), sel(v), mask, spec.q_chunk)
    return _out(p, o.reshape(*q.shape[:2], -1), dt), (k, v)


def attn_decode(p, spec: AttnSpec, x, cache: dict, pos: int):
    """One-token decode. x: (B,1,D); pos: int (uniform batch).

    Full cache: k/v written at index pos; ring cache: at pos % window,
    both in place. Returns (out, cache). Under a head-split rank the cache
    holds its kv heads, or (``_kv_select``) all of them."""
    if tp_size() > 1 and not _heads_split(p, spec):
        return whole_layer(
            lambda pw, xw: attn_decode(pw, spec, xw, cache, pos), p, x)
    b = x.shape[0]
    dev = x.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    if spec.sections is not None:
        positions = positions[..., None].repeat(1, 1, len(spec.sections))
    q, k, v = _qkv(p, spec, x, x)
    dt = q.dtype
    if spec.use_rope:
        ang = rope_angles(positions, spec.head_dim, spec.theta, spec.sections)
        q, k = apply_rope(q, ang), apply_rope(k, ang)
    sel = _kv_select(spec)

    if "parts" in cache:
        o = _decode_parts(spec, q, k, v, cache["parts"], pos, positions, sel)
        return _out(p, o.reshape(b, 1, -1), dt), cache
    ring = "pos" in cache
    ck, cv = cache["k"], cache["v"]
    slot = decode_slot(pos, ck.shape[1], ring)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    if ring:
        cache["pos"][:, slot] = pos
        k_pos = cache["pos"]
        k_valid = k_pos >= 0
    else:
        idx = torch.arange(ck.shape[1], dtype=torch.int32, device=dev)
        k_pos = idx.expand(b, ck.shape[1])
        k_valid = k_pos <= pos
    qpos2 = positions if positions.ndim == 2 else positions[..., 0]
    mask = _score_mask(qpos2, k_pos, spec.causal, spec.window, k_valid)
    o = sdpa(q, sel(ck.to(dt)), sel(cv.to(dt)), mask)
    return _out(p, o.reshape(b, 1, -1), dt), cache


def _decode_parts(spec: AttnSpec, q, k, v, parts: list, pos: int,
                  positions, sel=lambda t: t):
    """``attn_decode``'s attention on a cache cut along its sequence: the
    new key and value written into the part holding slot ``pos`` (ring:
    ``pos % W``), then each part attended on its own absolute positions
    (ring: its slots' ``pos`` entries) and the parts merged
    (``sdpa_parts``)."""
    dt, dev = q.dtype, q.device
    b = q.shape[0]
    ring = parts[0].pos is not None
    slot = decode_slot(pos, sum(pt.k.shape[1] for pt in parts), ring)
    qpos2 = positions if positions.ndim == 2 else positions[..., 0]
    att = []
    for pt in parts:
        n = pt.k.shape[1]
        if pt.lo <= slot < pt.lo + n:
            pt.k[:, slot - pt.lo] = k[:, 0].to(pt.k.dtype)
            pt.v[:, slot - pt.lo] = v[:, 0].to(pt.v.dtype)
            if ring:
                pt.pos[:, slot - pt.lo] = pos
        if ring:
            k_pos = pt.pos
            k_valid = k_pos >= 0
        else:
            k_pos = torch.arange(pt.lo, pt.lo + n, dtype=torch.int32,
                                 device=dev).expand(b, n)
            k_valid = k_pos <= pos
        mask = _score_mask(qpos2, k_pos, spec.causal, spec.window, k_valid)
        att.append((sel(pt.k.to(dt)), sel(pt.v.to(dt)), mask))
    return sdpa_parts(q, att)


def cross_decode(p, spec: AttnSpec, x, cache: dict):
    """Decoder cross-attention against a fixed encoder cache {k, v}. Under
    a head-split rank: its query heads, against its kv heads of the cache
    (or, where they do not divide the ranks, the cache whole and
    ``_kv_select``), its rows of ``wo`` reduced over the ranks."""
    if tp_size() > 1 and not _heads_split(p, spec):
        return whole_layer(lambda pw, xw: (cross_decode(pw, spec, xw,
                                                        cache),), p, x)[0]
    dt = x.dtype
    b = x.shape[0]
    q = _split_heads(x @ cast(p["wq"], dt, None, "heads"),
                     spec.n_heads // tp_size(), spec.head_dim)
    sel = _kv_select(spec)
    if "parts" in cache:
        o = sdpa_parts(q, [(sel(pt.k.to(dt)), sel(pt.v.to(dt)),
                            torch.ones((b, 1, pt.k.shape[1]),
                                       dtype=torch.bool, device=x.device))
                           for pt in cache["parts"]])
    else:
        k, v = cache["k"].to(dt), cache["v"].to(dt)
        mask = torch.ones((b, 1, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        o = sdpa(q, sel(k), sel(v), mask)
    return _out(p, o.reshape(b, 1, -1), dt)
