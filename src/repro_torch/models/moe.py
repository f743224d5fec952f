"""GShard-style mixture-of-experts FFN: top-k routing with capacity, the
gather/scatter or einsum dispatch and combine, optional shared expert.

Tokens are processed in groups of `group_size`; each expert takes at most
`_capacity` tokens of a group, first choices before second choices
(choice-major) and in token order within a choice. A token past an
expert's capacity is dropped from that expert: drops depend on the
grouping, as in the reference.

Top-k takes the lower expert index first on ties (``jax.lax.top_k``): a
stable descending sort.

Groups are groups of the flattened *global* batch. Under a data position
(``models.sharding.Position``) holding 1 / P of the batch's rows, a
position whose tokens are whole groups routes them alone; where a group
spans positions (``spans_positions``) each position all-gathers the
group's top-k choices, routes the whole group (capacity and drops are
the reference's) and runs the experts on its own tokens
(``_moe_ffn_spanning``). The aux loss of a position is its share of the
mean over the global groups, so the positions' sum is the global one.

Under a rank that splits the compute over "model"
(``models.sharding.Rank``, M ranks) the layer takes its input in the
residual stream's layout and gathers it whole; every rank routes the
position's tokens alike (the router is whole, ``("embed", None)``) and
splits the expert MLP by the reference's rule (``ep = E %
axis_size("experts") == 0``, ``_split``): expert parallel, a rank
dispatches to its E / M experts alone, runs them, and the experts'
outputs are all-gathered (exact) before the combine; otherwise (granite's
40 experts on 16) it runs every expert on its ``ff`` columns of
``wi_gate`` / ``wi_up`` and rows of ``wo``, and the partial outputs are
summed over the ranks in float32 and rounded once, each rank keeping its
columns of D (a reduce-scatter), which it combines; the combined columns
are all-gathered. The combine runs alike on every rank, which keeps its
slice of the output; the aux loss counts once (``Model.loss``). An
``ff`` that does not divide M leaves the expert weights whole, and the
layer runs as one device (``sharding.whole_layer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import (ACTS, MLP, ParamModule, cast,
                                       matmul_f32, mlp, truncated_normal)
from repro_torch.models.sharding import (axis_size, current_position,
                                         gather_ranks, model_dim, shard,
                                         sum_ranks, tp_index, tp_size,
                                         unshard, whole_layer)


class MoE(ParamModule):
    def __init__(self, d: int, f: int, cfg: MoEConfig, device=None):
        super().__init__(device)
        e = cfg.n_experts
        self.param("router", (d, e))
        self.param("wi_gate", (e, d, f))
        self.param("wi_up", (e, d, f))
        self.param("wo", (e, f, d))
        if cfg.shared_expert:
            self.shared = MLP(d, f, device)

    def reset_parameters(self, generator: torch.Generator):
        e, d, f = self.wi_gate.shape
        self._fill("router", truncated_normal(generator, (d, e), d ** -0.5))
        self._fill("wi_gate", truncated_normal(generator, (e, d, f),
                                               d ** -0.5))
        self._fill("wi_up", truncated_normal(generator, (e, d, f), d ** -0.5))
        self._fill("wo", truncated_normal(generator, (e, f, d), f ** -0.5))
        if "shared" in self:
            self.shared.reset_parameters(generator)


def _capacity(sg: int, cfg: MoEConfig) -> int:
    c = int(sg * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs, cfg: MoEConfig, c: int):
    """Top-k choices and their capacity slots: (topv, topi, pos_k,
    within_k, onehot); ``within_k[k]`` is 1 where choice k keeps its
    token, 0 where the expert's capacity dropped it."""
    topv, topi = top_k(probs, cfg.top_k)                       # (G,Sg,K)
    return (topv, topi, *slots(topi, cfg, c))


def slots(topi, cfg: MoEConfig, c: int):
    """The capacity slots of the top-k choices ``topi`` (G, Sg, K) of
    whole groups: (pos_k, within_k, onehot)."""
    e = cfg.n_experts
    g = topi.shape[0]
    onehot = F.one_hot(topi, e).to(torch.float32)              # (G,Sg,K,E)
    counts = torch.zeros((g, 1, e), dtype=torch.float32, device=topi.device)
    pos_k, within_k = [], []
    for k in range(cfg.top_k):
        oh = onehot[:, :, k, :]                                # (G,Sg,E)
        pos = counts + torch.cumsum(oh, dim=1) - oh            # (G,Sg,E)
        pos_k.append((pos * oh).sum(-1))                       # (G,Sg) slot
        within_k.append(((pos < c).to(torch.float32) * oh).sum(-1))
        counts = counts + oh.sum(dim=1, keepdim=True)
    return pos_k, within_k, onehot


def _gates(topv):
    """The top-k probabilities renormalised to sum to 1. A top-1 gate is
    identically 1 (``t / t``, exact in float32): it is taken as 1, so its
    gradient is the exact zero, not the rounding residue of ``g / t - g t
    / t^2``, which is all the main loss gives the router and differs
    between any two summation orders of the same gradient."""
    if topv.shape[-1] == 1:
        return torch.ones_like(topv)
    return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)


def spans_positions(cfg: MoEConfig, local_tokens: int, position) -> bool:
    """Whether a routing group of the global batch (``local_tokens`` a
    position, ``position.count`` positions) spans data positions."""
    if position is None or position.count == 1:
        return False
    sg = min(cfg.group_size, local_tokens * position.count)
    return local_tokens % sg != 0


def _split(p, cfg: MoEConfig):
    """How this rank splits the expert MLP: "experts" (expert parallel:
    its E / M experts), "ff" (its ``ff`` columns of every expert), or None
    (no rank splits, or the expert weights are stored whole: an ``ff``
    that does not divide M)."""
    if tp_size() == 1:
        return None
    ep = cfg.n_experts % max(axis_size("experts"), 1) == 0
    if model_dim(p["wi_gate"]) == (0 if ep else 2):
        return "experts" if ep else "ff"
    return None


def _own_experts(split, e: int) -> slice:
    """The experts whose buffers this rank dispatches and runs."""
    if split != "experts":
        return slice(0, e)
    n = e // tp_size()
    return slice(tp_index() * n, (tp_index() + 1) * n)


def _experts(p, xe, split, act: str, dt):
    """The expert MLP of the dispatched buffers ``xe`` (E', G, C, D) ->
    every expert's output (E, G, C, D'), as ``split`` cuts it: expert
    parallel, the rank's experts (E' = E / M), their outputs all-gathered;
    ``ff``, every expert (E' = E) on the rank's hidden columns, the
    partial outputs formed in float32, summed over the ranks and rounded
    once: reduce-scattered along D where the ranks divide it (D' = D / M,
    the rank's columns of the sum; the combine, column by column, runs on
    them), else all-reduced (D' = D)."""
    keep = {"experts": ("experts", None, None),
            "ff": (None, None, "ff")}.get(split, ())
    h = ACTS[act](torch.einsum("egcd,edf->egcf", xe,
                               cast(p["wi_gate"], dt, *keep)))
    h = h * torch.einsum("egcd,edf->egcf", xe, cast(p["wi_up"], dt, *keep))
    if split == "ff":
        e, g, c, f = h.shape
        ye = matmul_f32(h.reshape(e, g * c, f),
                        cast(p["wo"], dt, None, "ff", None))
        ye = sum_ranks(ye, None if ye.shape[-1] % tp_size() else 2)
        return ye.to(dt).reshape(e, g, c, -1)
    ye = torch.einsum("egcf,efd->egcd", h, cast(p["wo"], dt, *keep))
    return gather_ranks(ye, 0) if split == "experts" else ye


def moe_ffn(p, x, cfg: MoEConfig, act: str = "silu", train: bool = True):
    """x: (B, S, D) -> (y, aux_loss). Group, route, dispatch, expert MLP,
    combine. Under a rank ``x`` and ``y`` are in the residual stream's
    layout."""
    split = _split(p, cfg)
    if tp_size() > 1 and split is None:
        return whole_layer(moe_ffn, p, x, cfg, act, train)
    if tp_size() == 1:
        return _moe(p, x, cfg, act, None, shared=True)
    # the routed experts on the tokens whole; the shared expert as the
    # dense MLP runs under a rank, on the stream's layout
    y, aux = _moe(p, unshard(x, "batch", "seq", None), cfg, act, split,
                  shared=False)
    y = shard(y, "batch", "seq", None)
    if cfg.shared_expert:
        y = y + mlp(p["shared"], x, act)
    return y, aux


def _moe(p, x, cfg: MoEConfig, act: str, split, shared: bool):
    """``moe_ffn`` of whole tokens, the expert MLP split as ``split``
    says; the shared expert added where ``shared``."""
    b, s, d = x.shape
    position = current_position()
    if spans_positions(cfg, b * s, position):
        y, aux = _moe_ffn_spanning(p, x, cfg, act, position, split, shared)
    else:
        routed = _dispatch(p, x, cfg, split, position)
        ye = _experts(p, routed["xe"], split, act, x.dtype)    # (E,G,C,D')
        y, aux = _combine(p, routed, ye, cfg, act, shared)
    # the ``ff`` route's columns of the output gathered: (B, S, D) in 16
    # bits, where the expert outputs hold top_k x capacity factor slots a
    # token (10 in granite's) and, under remat, would be kept whole
    return (y if y.shape[-1] == d else gather_ranks(y, 2)), aux


def _dispatch(p, x, cfg: MoEConfig, split, position) -> dict:
    """Group and route the tokens of ``x`` (B, S, D), whole groups of the
    global batch, and dispatch them to the experts this rank runs: their
    capacity buffers ``xe`` (E', G, C, D) and what the combine needs."""
    dt = x.dtype
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    # groups of the global batch: a position's tokens are whole groups
    count = 1 if position is None else position.count
    sg = min(cfg.group_size, t * count)
    pad = (-t) % sg
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    g = (t + pad) // sg
    xg = tokens.reshape(g, sg, d)
    xg = shard(xg, "batch", None, None)

    logits = (xg @ cast(p["router"], dt)).to(torch.float32)    # (G,Sg,E)
    probs = torch.softmax(logits, dim=-1)

    e, c = cfg.n_experts, _capacity(sg, cfg)
    topv, topi, pos_k, within_k, onehot = route(probs, cfg, c)
    gates = _gates(topv)
    mine = _own_experts(split, e)
    dev = x.device

    if cfg.dispatch == "gather":
        # gather/scatter dispatch: ~zero FLOPs
        garange = torch.arange(g, device=dev)[:, None]
        sarange = torch.arange(sg, device=dev).expand(g, sg)
        buf = torch.full((g * e * c,), sg, dtype=torch.int64, device=dev)
        for k in range(cfg.top_k):
            ek = topi[:, :, k]
            slot = torch.clamp(pos_k[k].to(torch.int64), 0, c - 1)
            keep = within_k[k] > 0
            # kept slots are unique per expert by construction; overflow
            # entries (clipped to slot c-1) carry the sentinel, and `amin`
            # makes them no-ops even when they collide with a kept write
            flat = (garange * e + ek) * c + slot
            buf.scatter_reduce_(0, flat.reshape(-1),
                                torch.where(keep, sarange, sg).reshape(-1),
                                reduce="amin")
        xg_pad = torch.cat([xg, torch.zeros((g, 1, d), dtype=dt, device=dev)],
                           dim=1)                              # (G,Sg+1,D)
        ne = mine.stop - mine.start
        idx = buf.reshape(g, e, c)[:, mine].reshape(g, ne * c)
        # an index, not ``torch.gather``: a token kept by several experts
        # sums their cotangents, which on the card an index's backward
        # does in a sorted, fixed order and a gather's in atomic adds,
        # whose order (and 16-bit rounding) differs from run to run
        xe = xg_pad[garange, idx]
        xe = xe.reshape(g, ne, c, d).permute(1, 0, 2, 3)       # (E',G,C,D)
    else:
        # GShard einsum dispatch (baseline; kept for ablation)
        disp = torch.zeros((g, sg, e, c), dtype=torch.float32, device=dev)
        for k in range(cfg.top_k):
            slot_oh = F.one_hot(pos_k[k].to(torch.int64)
                                * (within_k[k] > 0), c).to(torch.float32)
            disp = disp + within_k[k][..., None, None] * \
                slot_oh[:, :, None, :] * onehot[:, :, k, :, None]
        xe = torch.einsum("gsd,gsec->egcd", xg, disp[:, :, mine].to(dt))
    return dict(xe=xe, xg=xg, probs=probs, topi=topi, pos_k=pos_k,
                within_k=within_k, onehot=onehot, gates=gates, shape=(b, s),
                groups=(g, sg, e, c), t=t, pad=pad, count=count)


def _combine(p, routed: dict, ye, cfg: MoEConfig, act: str, shared: bool):
    """Each token's experts' outputs ``ye`` (E, G, C, D) weighted by its
    gates, the shared expert added where ``shared``: (y (B, S, D), the
    aux loss)."""
    dt, dev = routed["xg"].dtype, ye.device
    b, s = routed["shape"]
    g, sg, e, c = routed["groups"]
    d = ye.shape[-1]
    topi, pos_k, within_k = (routed[k] for k in ("topi", "pos_k",
                                                 "within_k"))
    gates, onehot, t, pad = (routed[k] for k in ("gates", "onehot", "t",
                                                 "pad"))
    if cfg.dispatch == "gather":
        # combine: per (token, choice) gather from the expert outputs
        ye_flat = ye.permute(1, 0, 2, 3).reshape(g, e * c, d)
        ye_flat = torch.cat(
            [ye_flat, torch.zeros((g, 1, d), dtype=ye.dtype, device=dev)],
            dim=1)
        y = torch.zeros((g, sg, d), dtype=dt, device=dev)
        for k in range(cfg.top_k):
            ek = topi[:, :, k]
            slot = torch.clamp(pos_k[k].to(torch.int64), 0, c - 1)
            flat = torch.where(within_k[k] > 0, ek * c + slot, e * c)
            yk = torch.gather(ye_flat, 1, flat[..., None].expand(g, sg, d))
            y = y + yk * gates[:, :, k, None].to(dt)
    else:
        combine = torch.zeros((g, sg, e, c), dtype=torch.float32, device=dev)
        for k in range(cfg.top_k):
            slot_oh = F.one_hot(pos_k[k].to(torch.int64)
                                * (within_k[k] > 0), c).to(torch.float32)
            dk = within_k[k][..., None, None] * \
                slot_oh[:, :, None, :] * onehot[:, :, k, :, None]
            combine = combine + dk * gates[:, :, k, None, None]
        y = torch.einsum("egcd,gsec->gsd", ye, combine.to(dt))

    if shared and cfg.shared_expert:
        y = y + mlp(p["shared"], routed["xg"], act)

    # load-balancing aux loss (Switch/GShard)
    me = routed["probs"].mean(dim=1)                           # (G,E)
    kept = sum(within_k[k][..., None] * onehot[:, :, k, :]
               for k in range(cfg.top_k))                      # (G,Sg,E)
    ce_frac = kept.mean(dim=1)                                 # (G,E)
    aux = (me * ce_frac).sum(-1).mean() * e * cfg.aux_loss_weight
    if routed["count"] > 1:  # the position's share of the global groups'
        aux = aux / routed["count"]
    y = y.reshape(-1, d)[:t] if pad else y.reshape(-1, d)
    return y.reshape(b, s, d), aux


def _moe_ffn_spanning(p, x, cfg: MoEConfig, act: str, position, split,
                      shared: bool):
    """``moe_ffn`` for a data position whose tokens share routing groups
    with other positions. Its tokens are global tokens [i T, (i + 1) T)
    (T a position's, i its index); the last position also holds the
    global batch's padding. The top-k choices of every position are
    all-gathered (in the backward's recomputation, taken from the
    forward's: ``position.memo``), the global groups routed whole, and
    each kept (token, choice) of this position's tokens runs its expert
    in a buffer of the groups the position touches."""
    dt = x.dtype
    b, s, d = x.shape
    dev = x.device
    t = b * s
    count, i = position.count, position.index
    t_all = t * count
    sg = min(cfg.group_size, t_all)
    pad = (-t_all) % sg
    n_groups = (t_all + pad) // sg
    tokens = x.reshape(t, d)
    if pad and i == count - 1:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    n = tokens.shape[0]
    start = i * t                                  # first global token

    logits = (tokens @ cast(p["router"], dt)).to(torch.float32)  # (n, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, cfg.top_k)                       # (n, K)
    key = id(p["router"])       # a layer's router: one call a forward
    if key in position.memo:
        every = position.memo[key]       # the backward's recomputation
    else:
        every = torch.cat([v.to(dev) for v in
                           position.exchange.all_gather(i, topi)])
        position.memo[key] = every
    e, c = cfg.n_experts, _capacity(sg, cfg)
    pos_all, within_all, onehot_all = slots(
        every.reshape(n_groups, sg, cfg.top_k), cfg, c)
    mine = slice(start, start + n)
    pos_k = [v.reshape(-1)[mine] for v in pos_all]             # (n,)
    within_k = [v.reshape(-1)[mine] for v in within_all]
    gates = _gates(topv)

    g0 = start // sg                                # first group touched
    ng = (start + n - 1) // sg - g0 + 1
    gi = (torch.arange(start, start + n, device=dev) // sg) - g0  # (n,)
    own = _own_experts(split, e)
    ne = own.stop - own.start

    if cfg.dispatch == "gather":
        buf = torch.full((ng * e * c,), n, dtype=torch.int64, device=dev)
        arange = torch.arange(n, device=dev)
        for k in range(cfg.top_k):
            slot = torch.clamp(pos_k[k].to(torch.int64), 0, c - 1)
            flat = (gi * e + topi[:, k]) * c + slot
            buf.scatter_reduce_(0, flat, torch.where(
                within_k[k] > 0, arange, n), reduce="amin")
        x_pad = torch.cat([tokens, torch.zeros((1, d), dtype=dt,
                                               device=dev)])
        buf = buf.reshape(ng, e, c)[:, own].reshape(-1)
        xe = x_pad[buf].reshape(ng, ne, c, d).permute(1, 0, 2, 3)
    else:
        disp = torch.zeros((n, ng, e, c), dtype=torch.float32, device=dev)
        g_oh = F.one_hot(gi, ng).to(torch.float32)
        for k in range(cfg.top_k):
            slot_oh = F.one_hot(pos_k[k].to(torch.int64)
                                * (within_k[k] > 0), c).to(torch.float32)
            e_oh = F.one_hot(topi[:, k], e).to(torch.float32)
            disp = disp + within_k[k][:, None, None, None] * \
                g_oh[:, :, None, None] * e_oh[:, None, :, None] * \
                slot_oh[:, None, None, :]
        xe = torch.einsum("td,tnec->encd", tokens,
                          disp[:, :, own].to(dt))

    ye = _experts(p, xe, split, act, dt)                       # (E,ng,C,D')
    d = ye.shape[-1]        # the ``ff`` route's columns of the output

    if cfg.dispatch == "gather":
        ye_flat = torch.cat([ye.permute(1, 0, 2, 3).reshape(ng, e * c, d),
                             torch.zeros((ng, 1, d), dtype=ye.dtype,
                                         device=dev)], dim=1)
        ye_flat = ye_flat.reshape(ng * (e * c + 1), d)
        y = torch.zeros((n, d), dtype=dt, device=dev)
        for k in range(cfg.top_k):
            slot = torch.clamp(pos_k[k].to(torch.int64), 0, c - 1)
            idx = gi * (e * c + 1) + torch.where(
                within_k[k] > 0, topi[:, k] * c + slot, e * c)
            y = y + ye_flat[idx] * gates[:, k, None].to(dt)
    else:
        combine = torch.zeros((n, ng, e, c), dtype=torch.float32,
                              device=dev)
        g_oh = F.one_hot(gi, ng).to(torch.float32)
        for k in range(cfg.top_k):
            slot_oh = F.one_hot(pos_k[k].to(torch.int64)
                                * (within_k[k] > 0), c).to(torch.float32)
            e_oh = F.one_hot(topi[:, k], e).to(torch.float32)
            combine = combine + (within_k[k] * gates[:, k])[
                :, None, None, None] * g_oh[:, :, None, None] * \
                e_oh[:, None, :, None] * slot_oh[:, None, None, :]
        y = torch.einsum("encd,tnec->td", ye, combine.to(dt))

    if shared and cfg.shared_expert:
        y = y + mlp(p["shared"], tokens, act)

    # this position's share of the mean over the global groups of
    # sum_e me[g, e] * ce_frac[g, e] (me the group's mean probability)
    kept = sum(within_all[k][..., None] * onehot_all[:, :, k, :]
               for k in range(cfg.top_k))                      # (G,Sg,E)
    ce_frac = kept.mean(dim=1)                                 # (G,E)
    aux = (probs * ce_frac[gi + g0]).sum() / (sg * n_groups) * e * \
        cfg.aux_loss_weight
    return y[:t].reshape(b, s, d), aux
