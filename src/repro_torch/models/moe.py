"""GShard-style mixture-of-experts FFN: top-k routing with capacity, the
gather/scatter or einsum dispatch and combine, optional shared expert.

Tokens are processed in groups of `group_size`; each expert takes at most
`_capacity` tokens of a group, first choices before second choices
(choice-major) and in token order within a choice. A token past an
expert's capacity is dropped from that expert: drops depend on the
grouping, as in the reference.

Top-k takes the lower expert index first on ties (``jax.lax.top_k``): a
stable descending sort.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import (ACTS, MLP, ParamModule, cast, mlp,
                                       truncated_normal)
from repro_torch.models.sharding import axis_size, shard


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
    e = cfg.n_experts
    g = probs.shape[0]
    topv, topi = top_k(probs, cfg.top_k)                       # (G,Sg,K)
    onehot = F.one_hot(topi, e).to(torch.float32)              # (G,Sg,K,E)
    counts = torch.zeros((g, 1, e), dtype=torch.float32, device=probs.device)
    pos_k, within_k = [], []
    for k in range(cfg.top_k):
        oh = onehot[:, :, k, :]                                # (G,Sg,E)
        pos = counts + torch.cumsum(oh, dim=1) - oh            # (G,Sg,E)
        pos_k.append((pos * oh).sum(-1))                       # (G,Sg) slot
        within_k.append(((pos < c).to(torch.float32) * oh).sum(-1))
        counts = counts + oh.sum(dim=1, keepdim=True)
    return topv, topi, pos_k, within_k, onehot


def moe_ffn(p, x, cfg: MoEConfig, act: str = "silu", train: bool = True):
    """x: (B, S, D) -> (y, aux_loss). Group, route, dispatch, expert MLP,
    combine."""
    dt = x.dtype
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    sg = min(cfg.group_size, t)
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
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

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
    y = y.reshape(-1, d)[:t] if pad else y.reshape(-1, d)
    return y.reshape(b, s, d), aux
