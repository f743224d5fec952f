"""The entry points per architecture: train_step, prefill, decode_step —
on one device, or over a mesh.

Over a mesh (the port's counterpart of the reference's jitted steps
under ``jax.sharding``): the parameters, AdamW's moments and the decode
caches are ``ShardedTensor``s in ``launch/sharding.py``'s layout, and
the batch is cut over the batch axes ("pod", "data"). Each data position
runs the model on its rows as M ranks, one a device of its "model" row
(``models/sharding.py``): rank r holds its model slab of every weight,
its FSDP dims gathered whole and exact on its device, and computes its
part; the results are the single-device run's up to reduction order.
Where "model" has one device (M = 1) a position runs whole, its weights
gathered whole. A batch that does not divide over the batch axes (as
``batch_shardings`` leaves it whole) runs once, on the first position's
devices.

- Train: each position's loss is its summed NLL over the global batch's
  mask sum, plus its share of the MoE aux loss, so the positions' losses
  and gradients add up to the global ones. A position's ranks' losses
  are summed and its backward is one ``backward()``. A weight's gradient
  is reduced in float32 over "data" only, into its rank's model slab; a
  weight whole over "model" (norms) has one leaf a position, copied to
  its ranks (``distributed.mesh.group_copy``), whose gradient is the
  all-reduce of theirs. The global norm is taken once over one copy of
  each slab, and AdamW updates every slab in place.
- Serve: prefill and decode run a position's rows against its cache
  rows, each rank seeing plain local tensors (``local_cache``): its slab
  of the KV caches (self- and cross-attention's) where their kv heads
  are cut over "model", else the caches whole over "model" (their slabs
  gathered); its channel slice of a recurrent state, which is stored
  whole over "model" as the reference stores it. It writes back its own
  slab alone, and its channel slice into every copy of the state
  (``write_back``). A batch-1 decode leaves the cache cut
  along its sequence over "data": the step runs once, the model gets
  each slab's part of the sequence (``attention.KVPart``) and attends
  over each apart (``attention.sdpa_parts``).

Positions run one after another, their ranks in lockstep threads, except
where an MoE routing group spans positions: then every position's ranks
at once (``models.sharding.run_ranks``; one rank a position where M = 1,
or where the loss is not an LM's, which runs a position whole).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

from repro_torch.distributed.mesh import (Group, ShardedTensor,
                                          axis_positions, current_view,
                                          distribute, group_copy,
                                          note_collective, placed,
                                          position_device, sharded_empty,
                                          sharded_zeros)
from repro_torch.launch import sharding as shd
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import param_tree
from repro_torch.models.moe import spans_positions
from repro_torch.models.sharding import (Position, current_rank,
                                        held_positions, run_ranks,
                                        split_table)
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


def _model_ranks(mesh, rules: dict) -> int:
    """M: the devices of a data position's "model" row (the mesh size
    behind the "heads" rule)."""
    axes = rules.get("heads") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def _model_cut(st: ShardedTensor) -> Optional[int]:
    """The dim of ``st`` cut over "model" (None: whole over it)."""
    for d, e in enumerate(st.spec):
        if e is not None and "model" in ((e,) if isinstance(e, str) else e):
            return d
    return None


def _groups(mesh, where: list, m: int) -> list:
    """A ``Group`` of M ranks for each data position at ``where``; within
    a dry run's view, running the view's rank alone."""
    view = current_view()
    solo = None if view is None else view[mesh.axis_names.index("model")]
    out = []
    for w in where:
        coords = [tuple({**w, "model": r}.get(a, 0)
                        for a in mesh.axis_names) for r in range(m)]
        out.append(Group([mesh.devices[c] for c in coords], coords, solo))
    return out


def _reduce_rank(st: ShardedTensor, g: torch.Tensor, r: int):
    """Add rank ``r``'s float32 gradient of its model slab (whole over the
    other axes) into that slab's copies."""
    block = st._block({"model": r})
    axis = st.mesh.axis_names.index("model")
    for coords, slab in st.items():
        if coords[axis] != r:
            continue
        sl = st.sharding.slices(coords, st.shape)
        part = g[tuple(slice(a.start - b.start, a.stop - b.start)
                       for a, b in zip(sl, block))]
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
    of the loss: ``leaves`` its weights on its device (``{name: tensor}``
    requiring grad), ``denom`` the global batch's normaliser on that
    device. An LM's share (``LMShare``) splits its compute over "model"
    where that axis has M > 1 devices: the position runs as M ranks
    (``models/sharding.py``), rank r's leaves its model slabs gathered
    over "data" on its device and one leaf a position of each weight
    whole over "model" (``group_copy``: its gradient is the all-reduce of
    the ranks'). Any other ``loss_fn`` (the FFTConvMixer's, which the
    reference splits over the batch alone) runs a position whole on its
    weights gathered whole. A position's ranks' losses are summed and go through one
    ``backward()``, and its float32 gradients are added into the slabs of
    ``acc`` (``{name: ShardedTensor}`` zeros in the parameters' layouts,
    made when None), each rank's into its model slab, before the next
    position runs. Returns (loss, acc): the positions' shares summed on
    the first one's device."""
    where, devices = _batch_positions(mesh, rules)
    count = _count(where, next(iter(batch.values())).shape[0])
    where = where[:count]
    if acc is None:
        acc = {n: sharded_zeros(st.shape, st.sharding)
               for n, st in params.items()}
    m = _model_ranks(mesh, rules)
    cuts = {n: _model_cut(st) for n, st in params.items()}
    split = m > 1 and isinstance(loss_fn, LMShare)
    if not split:
        cuts = dict.fromkeys(params)
    groups = _groups(mesh, where, m) if split else None
    shared, made, kept = {}, {}, {}

    def setup(i, r, rank):
        if not split:
            with placed(_coords(mesh, where[i])):
                leaves = {n: st.gather(devices[i]).detach().requires_grad_()
                          for n, st in params.items()}
            made[i, r] = leaves
            return leaves
        g = groups[i]
        if i not in shared:
            with placed(g.coords[0]):
                whole = {n: st.gather(g.devices[0]).detach()
                         .requires_grad_() for n, st in params.items()
                         if cuts[n] is None}
                shared[i] = whole, {n: group_copy(g, t)
                                    for n, t in whole.items()}
        whole, copies = shared[i]
        with placed(g.coords[r]):
            made[i, r] = {n: st.gather(g.devices[r], {"model": r}).detach()
                          .requires_grad_() for n, st in params.items()
                          if cuts[n] is not None}
        return {n: made[i, r][n] if cuts[n] is not None else copies[n][r]
                for n in params}

    def one(i, r, leaves):
        dev = devices[i] if not split else groups[i].devices[r]
        local, den = _rows(batch, i, count, dev), denom.to(dev)
        if split:
            return loss_fn(local, leaves, den, cuts)
        return loss_fn(local, leaves, den)

    def finish(i, losses):
        # the position's one backward, and its gradients reduced into the
        # slabs, before the next position runs
        ranks = [0] if not split else groups[i].ranks()
        total = losses[0]
        if split:
            g = groups[i]
            with placed(g.coords[0]):
                total = torch.stack([losses[r].to(g.devices[0])
                                     for r in ranks]).sum()
        total.backward()
        grads = [(r, n, t.grad) for r in ranks
                 for n, t in made.pop((i, r)).items()]
        if split:
            grads += [(0, n, t.grad) for n, t in shared.pop(i)[0].items()]
        _reduce_grads(acc, cuts, grads)
        if current_view() is not None:
            kept[i] = grads
        return [total.detach()] * len(losses)

    outs = run_ranks(one, count, groups, lockstep, mesh, rules, setup,
                     finish)
    total = None
    for i in range(count):
        # a dry run's view runs one position for all: each adds its
        # gradients
        if kept and i not in kept:
            _reduce_grads(acc, cuts, kept[next(iter(kept))])
        loss = outs[i][0].to(devices[0])
        total = loss if total is None else total + loss
    if count > 1:
        _note_reduction(acc, count, rules)
    return total, acc


def _coords(mesh, where: dict) -> tuple:
    """The mesh coordinates of a data position's first device."""
    return tuple(where.get(a, 0) for a in mesh.axis_names)


def _reduce_grads(acc: dict, cuts: dict, grads: list):
    """Add a position's ``(rank, name, gradient)`` into the slabs: a
    weight cut over "model" into rank's own, any other into every slab."""
    for r, n, g in grads:
        if g is None:
            continue
        if cuts[n] is None:
            _reduce(acc, {n: g})
        else:
            _reduce_rank(acc[n], g, r)


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


class LMShare:
    """A data position's share of ``Model.loss`` (``sharded_value_and_grad``'s
    ``loss_fn``). Called with ``cuts`` (``{name: dim cut over "model"}``)
    it runs as a rank that splits the compute: its ``split`` table names
    the compute copies of the slabs it was given."""

    def __init__(self, model: Model):
        self.model = model

    def __call__(self, local, leaves, denom, cuts: Optional[dict] = None):
        tree = self.model.compute_params(leaves)
        if cuts is not None:
            current_rank().split = split_table(
                param_tree(self.model, {n: n for n in leaves}), tree, cuts)
        return self.model.loss(local, params=tree, denom=denom)


def lm_share(model: Model) -> LMShare:
    """``LMShare(model)``."""
    return LMShare(model)


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
    on each position's device — on each rank's, its model slabs, where
    "model" has more than one device — made on first use and kept for the
    object's life, as ``Model.compute_cast`` keeps one a call."""

    def __init__(self, model: Model, mesh, rules: dict, params: dict):
        self.model = model
        self.mesh = mesh
        self.rules = rules
        self.params = params
        self.where, self.devices = _batch_positions(mesh, rules)
        self.m = _model_ranks(mesh, rules)
        self._cuts = {n: _model_cut(st) for n, st in params.items()}
        self._names = param_tree(model, {n: n for n in params})
        self._copies = {}
        self._lock = threading.Lock()

    def compute(self, i: int, count: int = 1, r: Optional[int] = None,
                group: Optional[Group] = None):
        """The compute copy on position ``i``'s device (of ``count``
        positions), made there; with ``r``, rank r's (its model slabs, on
        ``group``'s device r) and its ``split`` table. On a meta mesh,
        where every position's device reads "meta", one a position; within
        a dry run's view (``distributed.mesh.view``) the positions it does
        not hold, run only for an MoE exchange, share the held one's."""
        device = self.devices[i] if r is None else group.devices[r]
        key = device
        if device.type == "meta":
            held = held_positions(count, self.mesh, self.rules)
            key = i = held[0] if held and i not in held else i
        if r is not None:
            key = (key, r)
        with self._lock:
            if key not in self._copies:
                if r is None:
                    at = tuple(self.where[i].get(a, 0)
                               for a in self.mesh.axis_names)
                    with torch.no_grad(), placed(at):
                        self._copies[key] = self.model.compute_params(
                            {n: st.gather(device)
                             for n, st in self.params.items()})
                else:
                    with torch.no_grad(), placed(group.coords[r]):
                        tree = self.model.compute_params(
                            {n: st.gather(device, {"model": r})
                             for n, st in self.params.items()})
                    self._copies[key] = tree, split_table(
                        self._names, tree, self._cuts)
            return self._copies[key]

    def count(self, batch: int) -> int:
        """Positions the batch is cut over: as ``cache_shardings``, a batch
        of one (or one that does not divide) runs once."""
        return _count(self.where, batch) if batch > 1 else 1

    def _run(self, fn, count: int, local_tokens: int) -> list:
        """``fn(i, r, device, compute copy)`` of every data position's
        ranks (r None where M = 1), as ``[[result of each rank] of each
        position]``."""
        lockstep = _lockstep(self.model, local_tokens, count)
        if self.m == 1:
            return run_ranks(lambda i, r, _: fn(
                i, None, self.devices[i], self.compute(i, count)), count,
                None, lockstep, self.mesh, self.rules)
        where = self.where[:count] if count > 1 else [{}]
        groups = _groups(self.mesh, where, self.m)

        def setup(i, r, rank):
            tree, rank.split = self.compute(i, count, r, groups[i])
            return groups[i].devices[r], tree
        return run_ranks(lambda i, r, arg: fn(i, r, *arg), count, groups,
                         lockstep, self.mesh, self.rules, setup)

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        b, s = batch["tokens"].shape[:2]
        count = self.count(b)

        # the whole cache's shapes (a rank holds a part: its kv heads, its
        # channels)
        whole = _cache_shapes(self.model, b, max_len)

        def one(i, r, dev, tree):
            out = self.model.prefill(_rows(batch, i, count, dev), max_len,
                                     params=tree)
            if r is not None:
                _note_state_gathers(out[0], whole, self.m)
            return out

        outs = self._run(one, count, (b // count) * s)
        ranks = list(range(len(outs[0])))
        caches = [[c for c, _ in row] for row in outs]
        cfg = self.model.cfg
        # the whole cache's shapes, its step and dtypes the prefill's
        shape = shd._unflatten(caches[0][0], iter(
            [t if not isinstance(t, torch.Tensor) else torch.empty(
                w.shape, dtype=t.dtype, device="meta")
             for t, w in zip(shd.tree_leaves(caches[0][0]),
                             shd.tree_leaves(whole))]))
        layout = shd.cache_shardings(shape, cfg, self.mesh, self.rules, b)
        per_leaf = list(zip(*[shd.tree_leaves(c) for row in caches
                              for c in row]))
        out = []
        for parts, lay, meta in zip(per_leaf, shd.tree_leaves(layout),
                                    shd.tree_leaves(shape)):
            if not isinstance(parts[0], torch.Tensor):
                out.append(parts[0])
                continue
            if count == 1 and self.m == 1:
                out.append(distribute(parts[0], lay))
                continue
            st = sharded_empty(meta.shape, lay, meta.dtype)
            for k, part in enumerate(parts):
                i, r = divmod(k, len(ranks))
                where = self.where[i] if count > 1 else {}
                if self.m == 1:
                    st.write(part, (i * part.shape[0],)
                             + (0,) * (part.ndim - 1))
                else:       # within a view, the view's slab alone
                    _write_rank(st, part, where, r)
            out.append(st)
        it = iter(out)
        cache = shd.tree_map(lambda _: next(it), shape)
        logits = torch.cat([row[0][1].to(self.devices[0]) for row in outs])
        return cache, logits

    @torch.no_grad()
    def decode(self, cache: dict, tokens: torch.Tensor):
        b = tokens.shape[0]
        count = self.count(b)
        pos = int(cache["step"])

        def one(i, r, dev, tree):
            where = self.where[i] if count > 1 else {}
            local = local_cache(cache, where, dev, r)
            logits, new = self.model.decode_step(
                local, _rows({"t": tokens}, i, count, dev)["t"],
                params=tree)
            write_back(cache, new, where, pos, r)
            if r is not None:
                _note_state_gathers(new, cache, self.m)
            return logits, new["step"]

        outs = self._run(one, count, b // count)
        logits = torch.cat([row[0][0].to(self.devices[0]) for row in outs])
        return logits, dict(cache, step=outs[0][0][1])


def _write_rank(st: ShardedTensor, value: torch.Tensor, where: dict,
                r: Optional[int], start=None):
    """Write ``value`` — rank ``r``'s part of the block of ``st`` at the
    data position ``where`` (its model slab, or that block whole over
    "model", which is cut to the slab), placed at offsets ``start``
    within the block — into the slabs of model index ``r`` alone (every
    slab holding the block where ``r`` is None). A block whole over
    "model" of which ``value`` is rank r's slice along one dim (a
    recurrent state's channels, ``_state_dim``) is written at that
    slice into every copy, as the reference keeps the state whole over
    "model": the ranks' slices make each copy whole (an all-gather,
    ``_note_state_gathers``)."""
    at = None
    start = start or [0] * len(st.shape)
    if r is not None:
        d = _model_cut(st)
        part = _state_dim(st, value, where) if d is None else None
        if d is not None:
            base, block = st._block(where), st._block({**where, "model": r})
            n = block[d].stop - block[d].start
            if value.shape[d] != n:
                value = value.narrow(d, block[d].start - base[d].start, n)
        if part is not None:
            start = list(start)
            start[part] += r * value.shape[part]
        else:
            where = {**where, "model": r}
            at = {"model": r}
    block = st._block(where)
    st.write(value, [b.start + o for b, o in zip(block, start)], at)


def _cache_shapes(model: Model, batch: int, max_len: int) -> dict:
    """The whole decode cache laid out on meta (``Model.init_cache``),
    outside any dispatch mode: a dry run's counter does not count it."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return model.init_cache(batch, max_len, device="meta")


def _note_state_gathers(cache: dict, whole: dict, m: int):
    """Record, on the running rank, the all-gather that makes each
    recurrent state of ``cache`` that is the rank's channel slice of
    ``whole``'s (a cache of the whole channels) whole over "model" in
    every copy."""
    for part, full in zip(cache["layers"], whole["layers"]):
        if isinstance(part, tuple):
            for t, w, d in zip(part, full, rec.STATE_CHANNEL_DIMS):
                if t.shape[d] != w.shape[d]:
                    note_collective("all-gather", t.numel()
                                    * t.element_size() * m, m)


def _state_dim(st: ShardedTensor, value: torch.Tensor,
               where: dict) -> Optional[int]:
    """The dim along which ``value`` is a rank's slice of ``st``'s block
    at ``where`` (None: it is the block whole)."""
    block = st._block(where)
    dims = [d for d, (b, n) in enumerate(zip(block, value.shape))
            if b.stop - b.start != n]
    return dims[0] if dims else None


def _seq_cut(entry) -> bool:
    """Whether a cache entry is an attention cache cut along its sequence
    (``cache_shardings`` cuts it so only where the batch is not cut)."""
    k = entry.get("k") if isinstance(entry, dict) else None
    return (isinstance(k, ShardedTensor) and len(k.spec) > 1
            and k.spec[1] is not None)


def _rank_block(st: ShardedTensor, where: dict, r: Optional[int]) -> dict:
    """Where rank ``r`` reads ``st``: its model slab where ``st``'s kv
    heads are cut over "model" (its own heads), else the block whole over
    "model" (its slabs gathered)."""
    if r is None or _model_cut(st) != 2:
        return where
    return {**where, "model": r}


def _kv_parts(entry: dict, dev, r: Optional[int] = None) -> list:
    """An attention cache entry cut along its sequence as ``KVPart``s on
    ``dev``, one a slab of the sequence in order (the slab itself where it
    is one slab on ``dev``); a ring's slot positions gathered whole and
    cut to the parts' bounds. Under rank ``r``, its part of each
    (``_rank_block``)."""
    ck, cv = entry["k"], entry["v"]
    e = ck.spec[1]
    where = axis_positions(ck.mesh, (e,) if isinstance(e, str) else e)
    ring = entry.get("pos")
    ring = None if ring is None else ring.gather(dev)
    n, s = len(where), ck.shape[1]
    parts = []
    for j, w in enumerate(where):
        lo, hi = j * s // n, (j + 1) * s // n
        w = _rank_block(ck, w, r)
        parts.append(attn.KVPart(ck.gather(dev, w), cv.gather(dev, w), lo,
                                 None if ring is None else ring[:, lo:hi]))
    return parts


def _state_part(st: ShardedTensor, where: dict, dev, r: Optional[int],
                dim: int) -> torch.Tensor:
    """Rank ``r``'s view of a recurrent state stored whole over "model":
    its channel slice along ``dim`` of its own copy, where the channels
    divide the ranks (as its layer's weights are then cut, and it
    computes those channels alone); the block whole otherwise."""
    if r is None:
        return st.gather(dev, where)
    m = st.mesh.shape["model"]
    t = st.gather(dev, where, at={"model": r})
    n = t.shape[dim]
    return t.narrow(dim, r * n // m, n // m) if n % m == 0 else t


def local_cache(cache: dict, where: dict, dev, r: Optional[int] = None
                ) -> dict:
    """The model's view of a sharded decode cache at the data position
    ``where`` (``{}``: the whole batch): every ``ShardedTensor`` gathered
    to that position's block on ``dev`` — rank ``r``'s part of it: its
    slab of a KV cache (self- or cross-attention's) whose kv heads are cut
    over "model" (``_rank_block``), its channel slice of a recurrent
    state (``_state_part``) — an attention cache cut along its sequence
    as ``{"parts": [KVPart, ...]}``."""
    def view(entry, rank):
        if _seq_cut(entry):
            return {"parts": _kv_parts(entry, dev, rank)}
        if isinstance(entry, tuple):        # a recurrent state
            return tuple(_state_part(t, where, dev, rank, d)
                         for t, d in zip(entry, rec.STATE_CHANNEL_DIMS))
        return shd.tree_map(lambda t: t.gather(dev, _rank_block(
            t, where, rank)) if isinstance(t, ShardedTensor) else t, entry)

    out = dict(cache, layers=[view(e, r) for e in cache["layers"]])
    if "cross" in cache:
        out["cross"] = [view(e, r) for e in cache["cross"]]
    return out


def write_back(cache: dict, new: dict, where: dict, pos: int,
               r: Optional[int] = None):
    """Write a decode step at ``pos`` on ``local_cache``'s view into the
    slabs of ``cache``: a sequence-cut attention cache's new slot, every
    other entry's block at ``where`` (the cross caches are never
    written); under rank ``r`` into its own slabs alone, and its channel
    slice of a recurrent state into every copy (``_write_rank``)."""
    for st, t in zip(cache["layers"], new["layers"]):
        if not _seq_cut(st):
            for a, b in zip(shd.tree_leaves(st), shd.tree_leaves(t)):
                if isinstance(a, ShardedTensor):
                    if r is None:
                        a.write_block(b, where)
                    else:
                        _write_rank(a, b, where, r)
            continue
        ring = "pos" in st
        slot = attn.decode_slot(pos, st["k"].shape[1], ring)
        pt = next(p for p in t["parts"]
                  if p.lo <= slot < p.lo + p.k.shape[1])
        i = slot - pt.lo
        if r is None:
            st["k"].write(pt.k[:, i:i + 1], (0, slot, 0, 0))
            st["v"].write(pt.v[:, i:i + 1], (0, slot, 0, 0))
            if ring:
                st["pos"].write(pt.pos[:, i:i + 1], (0, slot))
            continue
        _write_rank(st["k"], pt.k[:, i:i + 1], {}, r, (0, slot, 0, 0))
        _write_rank(st["v"], pt.v[:, i:i + 1], {}, r, (0, slot, 0, 0))
        if ring:
            _write_rank(st["pos"], pt.pos[:, i:i + 1], {}, r, (0, slot))
