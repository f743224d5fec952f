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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import (ACTS, MLP, ParamModule, cast, mlp,
                                       truncated_normal)
from repro_torch.models.sharding import axis_size, current_position, shard


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


def moe_ffn(p, x, cfg: MoEConfig, act: str = "silu", train: bool = True):
    """x: (B, S, D) -> (y, aux_loss). Group, route, dispatch, expert MLP,
    combine."""
    dt = x.dtype
    b, s, d = x.shape
    position = current_position()
    if spans_positions(cfg, b * s, position):
        return _moe_ffn_spanning(p, x, cfg, act, position)
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

    ep = cfg.n_experts % max(axis_size("experts"), 1) == 0
    e_ax = "experts" if ep else None
    f_ax = None if ep else "ff"
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
        idx = buf.reshape(g, e * c, 1).expand(g, e * c, d)
        xe = torch.gather(xg_pad, 1, idx)
        xe = xe.reshape(g, e, c, d).permute(1, 0, 2, 3)        # (E,G,C,D)
    else:
        # GShard einsum dispatch (baseline; kept for ablation)
        disp = torch.zeros((g, sg, e, c), dtype=torch.float32, device=dev)
        for k in range(cfg.top_k):
            slot_oh = F.one_hot(pos_k[k].to(torch.int64)
                                * (within_k[k] > 0), c).to(torch.float32)
            disp = disp + within_k[k][..., None, None] * \
                slot_oh[:, :, None, :] * onehot[:, :, k, :, None]
        xe = torch.einsum("gsd,gsec->egcd", xg, disp.to(dt))

    xe = shard(xe, e_ax, "batch", None, None)
    h = ACTS[act](torch.einsum("egcd,edf->egcf", xe, cast(p["wi_gate"], dt)))
    h = h * torch.einsum("egcd,edf->egcf", xe, cast(p["wi_up"], dt))
    h = shard(h, e_ax, "batch", None, f_ax)
    ye = torch.einsum("egcf,efd->egcd", h, cast(p["wo"], dt))
    ye = shard(ye, e_ax, "batch", None, None)

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

    if cfg.shared_expert:
        y = y + mlp(p["shared"], xg, act)

    # load-balancing aux loss (Switch/GShard)
    me = probs.mean(dim=1)                                     # (G,E)
    kept = sum(within_k[k][..., None] * onehot[:, :, k, :]
               for k in range(cfg.top_k))                      # (G,Sg,E)
    ce_frac = kept.mean(dim=1)                                 # (G,E)
    aux = (me * ce_frac).sum(-1).mean() * e * cfg.aux_loss_weight
    if count > 1:   # this position's share of the mean over global groups
        aux = aux / count
    y = y.reshape(-1, d)[:t] if pad else y.reshape(-1, d)
    return y.reshape(b, s, d), aux


def _moe_ffn_spanning(p, x, cfg: MoEConfig, act: str, position):
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
    ep = cfg.n_experts % max(axis_size("experts"), 1) == 0
    e_ax = "experts" if ep else None
    f_ax = None if ep else "ff"

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
        xe = x_pad[buf].reshape(ng, e, c, d).permute(1, 0, 2, 3)
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
        xe = torch.einsum("td,tnec->encd", tokens, disp.to(dt))

    xe = shard(xe, e_ax, "batch", None, None)
    h = ACTS[act](torch.einsum("egcd,edf->egcf", xe, cast(p["wi_gate"], dt)))
    h = h * torch.einsum("egcd,edf->egcf", xe, cast(p["wi_up"], dt))
    h = shard(h, e_ax, "batch", None, f_ax)
    ye = torch.einsum("egcf,efd->egcd", h, cast(p["wo"], dt))  # (E,ng,C,D)

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

    if cfg.shared_expert:
        y = y + mlp(p["shared"], tokens, act)

    # this position's share of the mean over the global groups of
    # sum_e me[g, e] * ce_frac[g, e] (me the group's mean probability)
    kept = sum(within_all[k][..., None] * onehot_all[:, :, k, :]
               for k in range(cfg.top_k))                      # (G,Sg,E)
    ce_frac = kept.mean(dim=1)                                 # (G,E)
    aux = (probs * ce_frac[gi + g0]).sum() / (sg * n_groups) * e * \
        cfg.aux_loss_weight
    return y[:t].reshape(b, s, d), aux
