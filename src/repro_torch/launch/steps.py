"""The entry points per architecture: train_step, prefill, decode_step —
on one device, or over a mesh.

Over a mesh (the port's counterpart of the reference's jitted steps
under ``jax.sharding``): the parameters, AdamW's moments and the decode
caches are ``ShardedTensor``s in ``launch/sharding.py``'s layout, and
the batch is cut over the batch axes ("pod", "data"). Each data position
runs the model on its rows with every weight gathered whole and exact on
its device (``models/sharding.py``); the results are the single-device
run's up to reduction order. A batch that does not divide over the batch
axes (as ``batch_shardings`` leaves it whole) runs once, on the first
position's device.

- Train: each position's loss is its summed NLL over the global batch's
  mask sum, plus its share of the MoE aux loss, so the positions' losses
  and gradients add up to the global ones. The gradients are reduced in
  float32 into every device's slab, the global norm is taken once over
  one copy of each slab, and AdamW updates every slab in place.
- Serve: prefill and decode run a position's rows against its cache
  rows, the model seeing plain local tensors (``local_cache``) that are
  written back into the slabs after the step (``write_back``). A batch-1
  decode leaves the cache cut along its sequence over "data": the step
  runs once, the model gets each slab's part of the sequence
  (``attention.KVPart``) and attends over each apart
  (``attention.sdpa_parts``).

Positions run one after another, except where an MoE routing group spans
positions: then one thread a position, in lockstep (``run_positions``).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

from repro_torch.distributed.mesh import (ShardedTensor, axis_positions,
                                          current_view, distribute,
                                          note_collective, placed,
                                          position_device, sharded_empty,
                                          sharded_zeros)
from repro_torch.launch import sharding as shd
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models.moe import spans_positions
from repro_torch.models.sharding import (Position, held_positions,
                                        run_positions)
from repro_torch.optim import AdamWConfig, adamw


def build_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                     accum_steps: int = 1, mesh=None,
                     rules: Optional[dict] = None,
                     params: Optional[dict] = None):
    """``train_step(opt_state, batch) -> (opt_state, stats)``.

    On one device (``mesh`` None): over the model's parameters, updated in
    place (``adamw.make_train_step``). Over ``mesh``: over ``params``
    (``{name: ShardedTensor}``, ``shard_params``), updated in place slab
    by slab, with ``opt_state``'s moments ``ShardedTensor``s of the same
    layouts (``init_sharded_opt``); ``model`` only lends its structure
    (a ``Model`` on ``"meta"`` does)."""
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is None:
        return adamw.make_train_step(
            model.loss, dict(model.named_parameters()), opt_cfg,
            accum_steps)
    return _sharded_train_step(model, params, opt_cfg, accum_steps, mesh,
                               rules)


def shard_params(values: dict, shardings: dict) -> dict:
    """``{name: tensor}`` laid out by ``{name: NamedSharding}``."""
    with torch.no_grad():
        return {n: distribute(v.detach(), shardings[n])
                for n, v in values.items()}


def init_sharded_opt(params: dict) -> dict:
    """Zero AdamW moments in the parameters' layouts, step 0."""
    first = next(iter(params.values()))
    return {"mu": {n: sharded_zeros(st.shape, st.sharding)
                   for n, st in params.items()},
            "nu": {n: sharded_zeros(st.shape, st.sharding)
                   for n, st in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=first.slabs.flat[0].device)}


def _batch_axes(rules) -> tuple:
    baxes = rules.get("batch") or ()
    return (baxes,) if isinstance(baxes, str) else tuple(baxes)


def _batch_positions(mesh, rules):
    """The data positions (``{axis: index}``) and their devices."""
    where = axis_positions(mesh, _batch_axes(rules))
    return where, [position_device(mesh, w) for w in where]


def _count(where: list, batch: int) -> int:
    """Positions a batch of ``batch`` rows is cut over: every one when it
    divides (``batch_shardings``), else the batch runs once."""
    return len(where) if batch % len(where) == 0 else 1


def _lockstep(model: Model, local_tokens: int, count: int) -> bool:
    moe = model.cfg.moe
    return moe is not None and spans_positions(moe, local_tokens,
                                               Position(0, count))


def _rows(batch: dict, i: int, count: int, device) -> dict:
    out = {}
    for k, v in batch.items():
        m = v.shape[0] // count
        out[k] = v[i * m:(i + 1) * m].to(device)
    return out


def _reduce(acc: dict, grads: dict):
    """Add each whole float32 gradient into every slab (each copy) of its
    accumulator."""
    for name, g in grads.items():
        if g is None:
            continue
        st = acc[name]
        for coords, slab in st.items():
            part = g[st.sharding.slices(coords, st.shape)]
            slab.add_(part.to(slab.device, torch.float32))


def _note_reduction(acc: dict, count: int, rules: dict):
    """Record the positions' reduction into each slab: in the reference's
    terms a reduce-scatter where the slab is cut over a batch axis, an
    all-reduce where the batch axes hold copies of it."""
    baxes = set(_batch_axes(rules))
    for st in acc.values():
        named = {a for e in st.spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        op = "reduce-scatter" if named & baxes else "all-reduce"
        for coords, slab in st.items():
            note_collective(op, slab.numel() * slab.element_size(), count,
                            coords)


def sharded_value_and_grad(loss_fn: Callable, params: dict, batch: dict,
                           mesh, rules: dict, denom: torch.Tensor,
                           lockstep: bool = False,
                           acc: Optional[dict] = None):
    """The loss and the gradients of a global batch over ``mesh``.

    ``loss_fn(local_batch, leaves, denom)`` is one data position's share
    of the loss: ``leaves`` its weights gathered whole on its device
    (``{name: tensor}`` requiring grad), ``denom`` the global batch's
    normaliser on that device. Each position's float32 gradients are
    added into every slab of ``acc`` (``{name: ShardedTensor}`` zeros in
    the parameters' layouts, made when None) in position order. Returns
    (loss, acc): the positions' shares summed on the first one's device.
    """
    where, devices = _batch_positions(mesh, rules)
    count = _count(where, next(iter(batch.values())).shape[0])
    if acc is None:
        acc = {n: sharded_zeros(st.shape, st.sharding)
               for n, st in params.items()}

    def one(i):
        dev = devices[i]
        leaves = {n: st.gather(dev).detach().requires_grad_()
                  for n, st in params.items()}
        loss = loss_fn(_rows(batch, i, count, dev), leaves, denom.to(dev))
        loss.backward()
        grads = {n: t.grad for n, t in leaves.items()}
        if keep:            # reduced in position order below
            return loss.detach(), grads
        _reduce(acc, grads)
        return loss.detach(), None

    # a dry run's view runs one position for all: each adds its gradients
    keep = lockstep or current_view() is not None
    outs = run_positions(one, count, lockstep, mesh, rules)
    total = None
    for loss, grads in outs:
        if grads is not None:
            _reduce(acc, grads)
        loss = loss.to(devices[0])
        total = loss if total is None else total + loss
    if count > 1:
        _note_reduction(acc, count, rules)
    return total, acc


def make_sharded_train_step(loss_fn: Callable, params: dict,
                            opt_cfg: AdamWConfig, mesh, rules: dict,
                            accum_steps: int = 1,
                            denom_fn: Optional[Callable] = None,
                            lockstep_fn: Optional[Callable] = None):
    """``train_step(opt_state, batch) -> (opt_state, stats)`` over
    ``params`` (``{name: ShardedTensor}``, updated in place), the sharded
    counterpart of ``adamw.make_train_step``: microbatches as there, each
    through ``sharded_value_and_grad``; the global norm over one copy of
    each slab; AdamW on every slab. ``denom_fn(batch)`` is a global
    (micro)batch's normaliser (its rows when None), ``lockstep_fn(batch,
    count)`` whether its positions run in lockstep."""
    where, devices = _batch_positions(mesh, rules)
    names = list(params)
    denom_fn = denom_fn or (lambda b: torch.tensor(
        float(next(iter(b.values())).shape[0])))

    def train_step(opt_state, batch):
        acc = {n: sharded_zeros(st.shape, st.sharding)
               for n, st in params.items()}
        losses = []
        for mb in adamw._microbatches(batch, accum_steps):
            count = _count(where, next(iter(mb.values())).shape[0])
            lockstep = bool(lockstep_fn and lockstep_fn(mb, count))
            losses.append(sharded_value_and_grad(
                loss_fn, params, mb, mesh, rules, denom_fn(mb), lockstep,
                acc)[0])
        loss = losses[0] if accum_steps == 1 else torch.stack(losses).mean()
        if accum_steps > 1:
            for st in acc.values():
                for _, slab in st.items():
                    slab.div_(accum_steps)
        sq = None
        for n in names:
            part = acc[n].sq_sum().to(devices[0])
            sq = part if sq is None else sq + part
        flat = [(n, c) for n in names for c, _ in params[n].items()]
        state = {"mu": {k: opt_state["mu"][k[0]].slabs[k[1]] for k in flat},
                 "nu": {k: opt_state["nu"][k[0]].slabs[k[1]] for k in flat},
                 "step": opt_state["step"]}
        _, state, stats = adamw.update(
            {k: params[k[0]].slabs[k[1]] for k in flat},
            {k: acc[k[0]].slabs[k[1]] for k in flat}, state, opt_cfg,
            gnorm=torch.sqrt(sq))
        opt_state["step"] = state["step"]
        return opt_state, dict(stats, loss=loss)

    return train_step


def lm_share(model: Model) -> Callable:
    """A data position's share of ``Model.loss`` (``sharded_value_and_grad``'s
    ``loss_fn``)."""
    def share(local, leaves, denom):
        return model.loss(local, params=model.compute_params(leaves),
                          denom=denom)
    return share


def lm_denom(batch: dict) -> torch.Tensor:
    """The global batch's mask sum (its tokens when it has no mask), as
    ``lm_loss_chunked`` divides by it."""
    mask = batch.get("loss_mask")
    if mask is not None:
        return torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    b, s = batch["labels"].shape[:2]
    return torch.tensor(float(b * s))


def lm_value_and_grad(model: Model, params: dict, batch: dict, mesh,
                      rules: dict):
    """``Model.loss`` of a global batch over ``mesh`` and its gradients,
    reduced into the parameters' layouts (``sharded_value_and_grad``)."""
    where, _ = _batch_positions(mesh, rules)
    b, s = batch["tokens"].shape[:2]
    count = _count(where, b)
    return sharded_value_and_grad(
        lm_share(model), params, batch, mesh, rules, lm_denom(batch),
        _lockstep(model, (b // count) * s, count))


def _sharded_train_step(model: Model, params: dict, opt_cfg: AdamWConfig,
                        accum_steps: int, mesh, rules: dict):
    def lockstep(batch, count):
        b, s = batch["tokens"].shape[:2]
        return _lockstep(model, (b // count) * s, count)

    return make_sharded_train_step(lm_share(model), params, opt_cfg, mesh,
                                   rules, accum_steps, lm_denom, lockstep)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def build_prefill(model: Model, max_len: int, mesh=None,
                  rules: Optional[dict] = None,
                  params: Optional[dict] = None):
    """``prefill(batch) -> (cache, logits)``; over ``mesh`` the cache's
    tensors are ``ShardedTensor``s in ``cache_shardings``' layout and the
    weights ``params`` (``{name: ShardedTensor}``)."""
    if mesh is None:
        def prefill(batch):
            return model.prefill(batch, max_len)
        return prefill
    serving = ShardedServing(model, mesh, rules, params)
    return lambda batch: serving.prefill(batch, max_len)


def build_decode(model: Model, mesh=None, rules: Optional[dict] = None,
                 params: Optional[dict] = None):
    """``decode(cache, tokens) -> (logits, cache)``."""
    if mesh is None:
        def decode(cache, tokens):
            return model.decode_step(cache, tokens)
        return decode
    return ShardedServing(model, mesh, rules, params).decode


class ShardedServing:
    """Prefill and decode over ``mesh``: one compute copy of the weights
    on each position's device (made on first use and kept for the
    object's life, as ``Model.compute_cast`` keeps one a call)."""

    def __init__(self, model: Model, mesh, rules: dict, params: dict):
        self.model = model
        self.mesh = mesh
        self.rules = rules
        self.params = params
        self.where, self.devices = _batch_positions(mesh, rules)
        self._copies = {}
        self._lock = threading.Lock()

    def compute(self, i: int, count: int = 1):
        """The compute copy on position ``i``'s device (of ``count``
        positions), made there. On a meta mesh, where every position's
        device reads "meta", one a position; within a dry run's view
        (``distributed.mesh.view``) the positions it does not hold, run
        only for an MoE exchange, share the held one's."""
        device = self.devices[i]
        key = device
        if device.type == "meta":
            held = held_positions(count, self.mesh, self.rules)
            key = i = held[0] if held and i not in held else i
        with self._lock:
            if key not in self._copies:
                at = tuple(self.where[i].get(a, 0)
                           for a in self.mesh.axis_names)
                with torch.no_grad(), placed(at):
                    self._copies[key] = self.model.compute_params(
                        {n: st.gather(device)
                         for n, st in self.params.items()})
            return self._copies[key]

    def count(self, batch: int) -> int:
        """Positions the batch is cut over: as ``cache_shardings``, a batch
        of one (or one that does not divide) runs once."""
        return _count(self.where, batch) if batch > 1 else 1

    def _run(self, fn, count: int, local_tokens: int) -> list:
        return run_positions(fn, count,
                             _lockstep(self.model, local_tokens, count),
                             self.mesh, self.rules)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        b, s = batch["tokens"].shape[:2]
        count = self.count(b)

        def one(i):
            dev = self.devices[i]
            return self.model.prefill(_rows(batch, i, count, dev), max_len,
                                      params=self.compute(i, count))

        outs = self._run(one, count, (b // count) * s)
        caches = [c for c, _ in outs]

        def global_shape(t):
            if not isinstance(t, torch.Tensor):
                return t
            return torch.empty((t.shape[0] * count, *t.shape[1:]),
                               dtype=t.dtype, device="meta")

        shape = shd.tree_map(global_shape, caches[0])
        layout = shd.cache_shardings(shape, self.model.cfg, self.mesh,
                                     self.rules, b)
        per_leaf = list(zip(*[shd.tree_leaves(c) for c in caches]))
        out = []
        for parts, lay, meta in zip(per_leaf, shd.tree_leaves(layout),
                                    shd.tree_leaves(shape)):
            if not isinstance(parts[0], torch.Tensor):
                out.append(parts[0])
                continue
            if count == 1:
                out.append(distribute(parts[0], lay))
                continue
            st = sharded_empty(meta.shape, lay, meta.dtype)
            for i, part in enumerate(parts):
                st.write(part, (i * part.shape[0],) + (0,) * (part.ndim - 1))
            out.append(st)
        it = iter(out)
        cache = shd.tree_map(lambda _: next(it), shape)
        logits = torch.cat([lg.to(self.devices[0]) for _, lg in outs])
        return cache, logits

    @torch.no_grad()
    def decode(self, cache: dict, tokens: torch.Tensor):
        b = tokens.shape[0]
        count = self.count(b)
        pos = int(cache["step"])

        def one(i):
            dev = self.devices[i]
            where = self.where[i] if count > 1 else {}
            local = local_cache(cache, where, dev)
            logits, new = self.model.decode_step(
                local, _rows({"t": tokens}, i, count, dev)["t"],
                params=self.compute(i, count))
            write_back(cache, new, where, pos)
            return logits, new["step"]

        outs = self._run(one, count, b // count)
        logits = torch.cat([lg.to(self.devices[0]) for lg, _ in outs])
        return logits, dict(cache, step=outs[0][1])


def _seq_cut(entry) -> bool:
    """Whether a cache entry is an attention cache cut along its sequence
    (``cache_shardings`` cuts it so only where the batch is not cut)."""
    k = entry.get("k") if isinstance(entry, dict) else None
    return (isinstance(k, ShardedTensor) and len(k.spec) > 1
            and k.spec[1] is not None)


def _kv_parts(entry: dict, dev) -> list:
    """An attention cache entry cut along its sequence as ``KVPart``s on
    ``dev``, one a slab of the sequence in order (the slab itself where it
    is one slab on ``dev``); a ring's slot positions gathered whole and
    cut to the parts' bounds."""
    ck, cv = entry["k"], entry["v"]
    e = ck.spec[1]
    where = axis_positions(ck.mesh, (e,) if isinstance(e, str) else e)
    ring = entry.get("pos")
    ring = None if ring is None else ring.gather(dev)
    n, s = len(where), ck.shape[1]
    parts = []
    for j, w in enumerate(where):
        lo, hi = j * s // n, (j + 1) * s // n
        parts.append(attn.KVPart(ck.gather(dev, w), cv.gather(dev, w), lo,
                                 None if ring is None else ring[:, lo:hi]))
    return parts


def local_cache(cache: dict, where: dict, dev) -> dict:
    """The model's view of a sharded decode cache at the data position
    ``where`` (``{}``: the whole batch): every ``ShardedTensor`` gathered
    to that position's block on ``dev``, an attention cache cut along its
    sequence as ``{"parts": [KVPart, ...]}``."""
    def view(entry):
        if _seq_cut(entry):
            return {"parts": _kv_parts(entry, dev)}
        return shd.tree_map(lambda t: t.gather(dev, where)
                            if isinstance(t, ShardedTensor) else t, entry)

    out = dict(cache, layers=[view(e) for e in cache["layers"]])
    if "cross" in cache:
        out["cross"] = [view(e) for e in cache["cross"]]
    return out


def write_back(cache: dict, new: dict, where: dict, pos: int):
    """Write a decode step at ``pos`` on ``local_cache``'s view into the
    slabs of ``cache``: a sequence-cut attention cache's new slot, every
    other entry's block at ``where`` (the cross caches are never
    written)."""
    for st, t in zip(cache["layers"], new["layers"]):
        if not _seq_cut(st):
            for a, b in zip(shd.tree_leaves(st), shd.tree_leaves(t)):
                if isinstance(a, ShardedTensor):
                    a.write_block(b, where)
            continue
        ring = "pos" in st
        slot = attn.decode_slot(pos, st["k"].shape[1], ring)
        pt = next(p for p in t["parts"]
                  if p.lo <= slot < p.lo + p.k.shape[1])
        i = slot - pt.lo
        st["k"].write(pt.k[:, i:i + 1], (0, slot, 0, 0))
        st["v"].write(pt.v[:, i:i + 1], (0, slot, 0, 0))
        if ring:
            st["pos"].write(pt.pos[:, i:i + 1], (0, slot))

