"""Logical-axis sharding constraints for model code, and the ranks of a
data position that split its compute over "model".

Model code annotates activations with *logical* axis names
(``shard(x, "batch", "seq", None)``). A launch-layer context maps
logical names to mesh axes; outside a rank (below) the calls are the
identity, so unit tests and single-card runs are unaffected.

How the port runs a mesh (``launch/steps.py``): the parameters, the
optimizer's moments and the decode caches are stored in the reference's
layout (``launch/sharding.py``, ``distributed.mesh.ShardedTensor``).
Each data position — one index along the batch axes — runs the model on
its part of the batch, as M *ranks*, one a device of its "model" row (M
= ``axis_size("heads")``), each in a thread of its own under a ``Rank``.
A rank holds its model slab of every weight (its FSDP dims gathered over
"data": ``gather_for_compute``'s ZeRO-3 gather has happened, exactly, by
placing the slabs) and computes on its own part, as the reference's
``src/repro/models/sharding.py`` rules split it under GSPMD:

- attention, self- and cross-: its heads of ``wq`` / ``wk`` / ``wv`` and
  the matching rows of ``wo`` (``models/attention.py``);
- the dense MLP: its columns of ``wi_gate`` / ``wi_up``, rows of ``wo``;
- MoE (``models/moe.py``): where the experts divide M (expert parallel)
  its E / M experts of ``wi_gate`` / ``wi_up`` / ``wo``, their outputs
  all-gathered before the combine; otherwise its ``ff`` columns of every
  expert's ``wi_gate`` / ``wi_up`` and rows of ``wo``, the partial
  outputs all-reduced in float32; the router whole;
- Mamba and RG-LRU (``models/recurrent.py``): its ``d_inner / M`` (``W /
  M``) channels — the conv, the scan and its decode state on them alone;
  Mamba's ``in_proj`` columns of those channels taken from the ranks that
  store them (``paired_blocks``, an all-to-all), ``x_proj`` and
  ``out_proj`` row-parallel; RG-LRU's ``xc`` all-gathered for its
  ``wa`` / ``wx`` columns, ``out_proj`` row-parallel;
- the embedding and the loss: its rows of the table (vocab-parallel);
- the residual stream between layers: its slice of the sequence.

Between them the layout changes are collectives over the rank's group
(``distributed.mesh.Group``): ``unshard`` (sequence-sharded -> whole:
all-gather) before attention and the MLP, ``reduce_to`` (row-parallel
partial sums -> sequence-sharded: reduce-scatter) after their last
products, ``shard`` (whole -> the rank's part: free) where a layer ran
whole. A dimension that does not divide M stays whole, as the reference
gathers it: the sequence then is whole on every rank (each computing it
alike, and the loss counting its share of the tokens, ``own``), and
partial sums are all-reduced. ``gather_for_compute(w, *keep)`` keeps a
weight's model slab along its ``keep`` dims and all-gathers it
otherwise (a weight used whole), recorded as a collective.

Inside ``whole()`` a rank computes as one device does, on whole inputs
and whole weights (``whole_params``; ``whole_layer``): a layer whose
split dimension does not divide M runs so — attention whose heads do not
divide it, an MLP or MoE whose ``ff`` does not, a recurrent mixer whose
channels do not — as the reference gathers such a weight whole, and the
rank keeps its slice of the output.

Where "model" has one device, or the loss is not an LM's
(``launch.steps.LMShare``: the FFTConvMixer's, split over the batch
alone), a position runs as one rank on whole weights, and every layout
change above is the identity.

The group is **one autograd graph**: each collective is one
``autograd.Function`` over all the group's tensors, applied by rank 0;
the position's ranks' losses are summed and its backward is one
``backward()``, the same on the CPU as on the card, where autograd
runs every node on the card's one engine thread and a collective whose
backward waited for its peers would deadlock. A rematerialised layer
group's recomputation does not exchange: within ``remat_scope`` each
collective's result is kept in the rank's ``memo`` at the forward and
taken from it at the recomputation (as ``Position.memo`` keeps MoE's
routing exchange).

Two things cross data positions inside the compute, and ``Position``
carries them: MoE routing groups, which are groups of the flattened
*global* batch (a group spanning positions is routed whole: the
positions run in lockstep threads and all-gather their top-k choices
through ``Exchange``, one exchange a model index), and the loss's and
aux loss's normalisation (each position's loss is its share of the
global mean, so the sum over positions is the global loss and the sum
of their gradients the global gradient).

Default production rules:
  batch   -> ("pod", "data")     data parallel
  seq     -> "model"             sequence parallelism of the residual stream
  heads   -> "model"             tensor parallel attention
  ff      -> "model"             tensor parallel MLP
  vocab   -> "model"             vocab-parallel embedding/loss
  experts -> "model"             expert parallel (when E % axis == 0)
  kv_seq  -> "data"              sequence-parallel KV cache (long decode)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Optional

import torch

from repro_torch.distributed.mesh import (Group, axis_positions,
                                          current_view, group_all_gather,
                                          group_all_reduce, group_exchange,
                                          group_reduce_scatter,
                                          note_collective)

_state = threading.local()


def _active():
    return getattr(_state, "ctx", None)


def _mesh_size(mesh) -> int:
    """Devices in ``mesh``: a ``distributed.mesh.Mesh``, or anything with
    a ``shape`` mapping of axis name to size."""
    return int(math.prod(mesh.shape.values()))


def _axes(axis) -> tuple:
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: dict):
    """Activate the logical->mesh axis mapping for model sharding
    constraints. ``mesh`` has a ``shape`` mapping (axis name -> size).
    On a mesh of more than one device every mesh axis the rules name must
    be the mesh's (``launch.mesh.activation_rules(mesh)`` gives such
    rules): a rule naming an absent axis raises ``ValueError``."""
    if _mesh_size(mesh) > 1:
        missing = sorted({a for v in rules.values() for a in _axes(v)}
                         - set(mesh.shape))
        if missing:
            raise ValueError(
                f"rules name mesh axes {missing} that the mesh "
                f"{dict(mesh.shape)} lacks; take "
                "launch.mesh.activation_rules(mesh)")
    prev = _active()
    _state.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx = prev


def current_rules() -> Optional[tuple]:
    return _active()


def resolve_spec(rules: dict, *logical) -> tuple:
    """The mesh axes behind each logical name (None = replicated dim)."""
    return tuple(rules.get(name) if name else None for name in logical)


def axis_size(logical: str) -> int:
    """Mesh size behind a logical axis in the active context (1 if none)."""
    ctx = _active()
    if ctx is None:
        return 1
    mesh, rules = ctx
    return int(math.prod(mesh.shape[a] for a in _axes(rules.get(logical))))


def shard(x, *logical):
    """Constrain a value whole on every rank to its layout by logical axis
    names: each rank keeps its part of every dimension whose name maps to
    the rank group's mesh axis and divides it (no bytes move). The
    identity outside a rank, and within ``whole()``."""
    rank = _tp()
    if rank is None:
        return x
    for dim, name in enumerate(logical):
        if _on_group(name) and x.shape[dim] % rank.count == 0:
            n = x.shape[dim] // rank.count
            x = x.narrow(dim, rank.index * n, n)
    return x


def unshard(x, *logical):
    """A rank's part of a value, laid out by ``logical`` as ``shard`` and
    ``reduce_to`` leave it, made whole on every rank: an all-gather along
    each dimension cut over the group (the sequence is cut where the
    rank's ``sequence`` divides the group). Its transpose sums the ranks'
    gradients, 16-bit ones in float32 rounded once
    (``distributed.mesh.Group``)."""
    rank = _tp()
    if rank is None:
        return x
    for dim, name in enumerate(logical):
        if not _on_group(name):
            continue
        if name == "seq":
            if rank.seq is None:
                raise ValueError("unshard along the sequence outside "
                                 "sequence()")
            if rank.seq % rank.count:
                continue            # a sequence that does not divide: whole
        x = rank.collective("all-gather", x, dim)
    return x


def reduce_to(x, *logical):
    """Every rank's partial sums of a value (a row-parallel product's),
    summed and laid out by ``logical``: a reduce-scatter along the first
    dimension cut over the group, an all-reduce where none divides."""
    rank = _tp()
    if rank is None:
        return x
    for dim, name in enumerate(logical):
        if _on_group(name) and x.shape[dim] % rank.count == 0:
            return rank.collective("reduce-scatter", x, dim)
    return rank.collective("all-reduce", x)


def gather_for_compute(x, *keep):
    """ZeRO-3 use-site gather of a weight: its FSDP dims are gathered over
    "data" (exactly, by placing the slabs, before the rank's compute:
    ``launch/steps.py``), and its model slab is kept along the ``keep``
    dims (one logical name or None a dim: the heads of ``wq``, the MLP's
    hidden dim, the vocabulary, and the rows of a row-parallel ``wo``,
    whose partial sums ``reduce_to`` then adds in float32,
    ``models/layers.py``). A weight cut over "model" along another dim is
    all-gathered whole, a collective. The identity outside a rank."""
    rank = _tp()
    if rank is None:
        return x
    dim = rank.split.get(id(x))
    if dim is None:
        return x
    name = keep[dim] if dim < len(keep) else None
    if _on_group(name):
        return x
    return rank.collective("all-gather", x, dim)


def gather_ranks(x, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` on every rank
    (all-gather); ``x`` itself outside a rank."""
    rank = _tp()
    return x if rank is None else rank.collective("all-gather", x, dim)


def sum_ranks(x, dim: Optional[int] = None):
    """Every rank's ``x`` summed on every rank (all-reduce); with ``dim``,
    whose size the ranks divide, each rank keeps its part of the sum
    along ``dim`` (reduce-scatter). ``x`` itself outside a rank."""
    rank = _tp()
    if rank is None:
        return x
    if dim is None:
        return rank.collective("all-reduce", x)
    return rank.collective("reduce-scatter", x, dim)


def model_dim(w) -> Optional[int]:
    """The dim of a rank's weight cut over "model" in storage (None: the
    weight is whole, or no rank splits the compute)."""
    rank = _tp()
    return None if rank is None else rank.split.get(id(w))


def paired_blocks(w, dim: int):
    """A rank's part of a weight whose ``dim`` holds two halves [a | b]
    of n lines each, stored cut over the ranks in slabs of 2n / M lines
    (Mamba's ``in_proj``, (D, 2 d_inner) ``("embed", "ff")``): its lines
    of each half, [a_r | b_r], n / M each. Rank r's slab holds
    lines [2 r n / M, 2 (r + 1) n / M), so its half-lines come from the
    ranks that store them (for M = 2, rank 0's slab is all of ``a``): an
    all-to-all of the weight's blocks, never the weight whole. ``w``
    itself outside a rank."""
    rank = _tp()
    if rank is None:
        return w
    m = rank.count
    c = w.shape[dim] // 2            # n / M: a block; a slab holds two
    plan = [[(k // 2, (k % 2) * c, c) for k in (j, m + j)]
            for j in range(m)]
    return rank.collective("all-to-all", w, dim, plan)


def whole_layer(fn, p, x, *args):
    """``fn(p, x, *args)`` -> (y, ...) as one device computes it, under a
    rank whose layer does not split (its dimension does not divide M): on
    ``x`` gathered whole from the residual stream's layout, ``p``'s
    weights cut over "model" all-gathered whole, inside ``whole()``; ``y``
    cut back to the stream's layout (the reference's ``shard(y, "batch",
    "seq", None)``)."""
    x = unshard(x, "batch", "seq", None)
    pw = whole_params(p)
    with whole():
        y, *rest = fn(pw, x, *args)
    return (shard(y, "batch", "seq", None), *rest)


def whole_params(tree):
    """A parameter subtree with every weight cut over "model" all-gathered
    whole (the weights of a layer or table used whole, ``whole_layer``)."""
    rank = _tp()
    if rank is None:
        return tree
    if isinstance(tree, dict):
        return {k: whole_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [whole_params(v) for v in tree]
    dim = rank.split.get(id(tree))
    return tree if dim is None else rank.collective("all-gather", tree, dim)


def _on_group(name) -> bool:
    """Whether a logical axis maps to the mesh axis the rank groups span."""
    ctx = _active()
    if name is None or ctx is None:
        return False
    return _axes(ctx[1].get(name)) == ("model",)


DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": "model",
    "heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "kv_seq": "data",
    "embed": "data",
}


# ---------------------------------------------------------------------------
# Data positions
# ---------------------------------------------------------------------------

class Exchange:
    """The all-gather of data positions running in lockstep threads: each
    position hands in its tensor and gets every position's, in position
    order. A position that fails aborts the others' waits. ``turns``: a
    lock each position holds while it runs, given up while it waits (the
    positions then take turns between exchanges)."""

    def __init__(self, count: int, turns: Optional[threading.Lock] = None):
        self.count = count
        self._slots = [None] * count
        self._barrier = threading.Barrier(count)
        self._turns = turns

    def all_gather(self, index: int, x) -> list:
        self._slots[index] = x
        self._wait()
        out = list(self._slots)
        self._wait()
        note_collective("all-gather", sum(t.numel() * t.element_size()
                                          for t in out), self.count)
        return out

    def _wait(self):
        """Wait for every position, giving up the turn meanwhile."""
        if self._turns is None:
            self._barrier.wait()
            return
        self._turns.release()
        try:
            self._barrier.wait()
        finally:
            self._turns.acquire()

    def abort(self):
        self._barrier.abort()


@dataclasses.dataclass
class Position:
    """One data position's share of a global batch: ``index`` of
    ``count`` (mesh order of the batch axes), its rows a contiguous
    ``1 / count`` of the global batch. ``exchange`` is set when the
    positions run in lockstep (MoE groups spanning positions); ``memo``
    keeps what a position received in its forward, for the backward's
    recomputation (rematerialised layers), which runs no exchange."""
    index: int
    count: int
    exchange: Optional[Exchange] = None
    memo: dict = dataclasses.field(default_factory=dict)


def current_position() -> Optional[Position]:
    """The data position whose compute is running on this thread (None:
    the whole batch)."""
    return getattr(_state, "position", None)


@contextlib.contextmanager
def data_position(position: Optional[Position]):
    prev = current_position()
    _state.position = position
    try:
        yield position
    finally:
        _state.position = prev


@dataclasses.dataclass
class Rank:
    """One rank of a data position's model group: ``index`` of
    ``group.size`` along "model" (``group`` None: a position's one rank,
    which splits nothing). ``split`` maps each of its compute
    weights (by ``id``) to the dim cut over "model" in storage (a weight
    absent is whole); ``memo`` keeps collective results for a
    rematerialised group's recomputation, keyed by ``scope`` (the group,
    ``remat_scope``) and ``calls`` (the collective's number in it);
    ``seq`` is the whole length of the sequence its residual stream holds
    now (``sequence``); ``whole`` counts the ``whole()`` contexts
    entered."""
    index: int
    group: Optional[Group]
    split: dict = dataclasses.field(default_factory=dict)
    memo: dict = dataclasses.field(default_factory=dict)
    seq: Optional[int] = None
    whole: int = 0
    scope: Optional[tuple] = None
    calls: int = 0

    @property
    def count(self) -> int:
        return 1 if self.group is None else self.group.size

    def collective(self, op: str, x, dim: Optional[int] = None,
                   plan: Optional[list] = None):
        """This rank's part in one collective of its group (``op``
        "all-gather" / "reduce-scatter" along ``dim``, "all-reduce", or
        "all-to-all" of the pieces ``plan`` names along ``dim``,
        ``distributed.mesh.Group.exchange``).
        Within ``remat_scope``: the forward keeps its result, and the
        recomputation in the backward takes it back without exchanging
        (requiring grad as it did)."""
        key = None
        if self.scope is not None:
            key = (self.scope, self.calls)
            self.calls += 1
            got = self.memo.get(key)
            if got is not None:
                value, grad = got
                return value.detach().requires_grad_(grad)
        fns = {"all-gather": lambda xs: group_all_gather(self.group, xs, dim),
               "reduce-scatter": lambda xs: group_reduce_scatter(
                   self.group, xs, dim),
               "all-reduce": lambda xs: group_all_reduce(self.group, xs),
               "all-to-all": lambda xs: group_exchange(self.group, xs, dim,
                                                       plan)}
        out = self.group.meet(self.index, x, fns[op])
        if key is not None:
            self.memo[key] = (out.detach(), out.requires_grad)
        return out


def split_table(names, tree, cuts: dict) -> dict:
    """A rank's ``split``: ``id`` of each weight of the compute copy
    ``tree`` -> its dim cut over "model", from ``names`` (the same tree of
    ``state_dict`` names) and ``cuts`` (name -> dim, None for whole)."""
    out = {}

    def walk(n, t):
        if isinstance(n, dict):
            for k in n:
                walk(n[k], t[k])
        elif isinstance(n, (list, tuple)):
            for a, b in zip(n, t):
                walk(a, b)
        elif cuts.get(n) is not None:
            out[id(t)] = cuts[n]
    walk(names, tree)
    return out


def current_rank() -> Optional[Rank]:
    """The rank whose compute runs on this thread (None: no data
    position's)."""
    return getattr(_state, "rank", None)


def _tp() -> Optional[Rank]:
    """The rank splitting the compute now (None outside a rank, for the
    one rank of a position, and within ``whole()``)."""
    rank = current_rank()
    return (rank if rank is not None and rank.count > 1
            and rank.whole == 0 else None)


def tp_size() -> int:
    """The ranks the compute is split over now (1: none)."""
    rank = _tp()
    return 1 if rank is None else rank.count


def tp_index() -> int:
    rank = _tp()
    return 0 if rank is None else rank.index


@contextlib.contextmanager
def rank_context(rank: Optional[Rank]):
    prev = current_rank()
    _state.rank = rank
    try:
        yield rank
    finally:
        _state.rank = prev


@contextlib.contextmanager
def whole():
    """Compute as one device does: ``shard`` / ``unshard`` / ``reduce_to``
    / ``gather_for_compute`` are the identity inside (the caller passes
    whole inputs and ``whole_params``)."""
    rank = current_rank()
    if rank is None:
        yield
        return
    rank.whole += 1
    try:
        yield
    finally:
        rank.whole -= 1


@contextlib.contextmanager
def sequence(length: int):
    """The residual stream inside holds a sequence of ``length`` (cut
    over the group where it divides)."""
    rank = current_rank()
    if rank is None:
        yield
        return
    prev, rank.seq = rank.seq, length
    try:
        yield
    finally:
        rank.seq = prev


@contextlib.contextmanager
def remat_scope(key):
    """A rematerialised group's collectives, numbered from 0 under
    ``key``: kept at the forward, taken back at the recomputation."""
    rank = current_rank()
    if rank is None:
        yield
        return
    prev = rank.scope, rank.calls
    rank.scope, rank.calls = key, 0
    try:
        yield
    finally:
        rank.scope, rank.calls = prev


def seq_cut(length: int) -> bool:
    """Whether a sequence of ``length`` is cut over the rank group."""
    m = tp_size()
    return m > 1 and length % m == 0


def own(length: int) -> slice:
    """The tokens of a sequence of ``length`` this rank counts in the loss
    (its slice where the sequence is cut; a share of the whole one where
    it is not): the ranks' slices partition the sequence."""
    m, r = tp_size(), tp_index()
    return slice(r * length // m, (r + 1) * length // m)


def carry_context() -> Callable:
    """A context factory that enters, on whichever thread runs it, the
    mesh rules, the data position and the rank active on this thread now. Autograd
    runs a CUDA backward, and with it the recomputation of a
    rematerialised forward, on a thread of its own, where the thread's
    own state would read no mesh and no position."""
    ctx, position, rank = _active(), current_position(), current_rank()

    @contextlib.contextmanager
    def enter():
        prev = _active(), current_position(), current_rank()
        _state.ctx, _state.position, _state.rank = ctx, position, rank
        try:
            yield
        finally:
            _state.ctx, _state.position, _state.rank = prev
    return enter


def run_positions(fn: Callable, count: int, lockstep: bool,
                  mesh=None, rules: Optional[dict] = None) -> list:
    """``[fn(i) for i in range(count)]``, each call under its data
    position (and ``mesh`` / ``rules`` when given): ``run_ranks`` with
    one rank a position."""
    return [out[0] for out in run_ranks(lambda i, r, _: fn(i), count, None,
                                        lockstep, mesh, rules)]


def run_ranks(fn: Callable, count: int, groups: Optional[list],
              lockstep: bool, mesh=None, rules: Optional[dict] = None,
              setup: Optional[Callable] = None,
              finish: Optional[Callable] = None) -> list:
    """``[[fn(i, r, arg) for r in ranks] for i in range(count)]``: data
    position ``i``'s ranks (``groups[i]``, the position's
    ``distributed.mesh.Group``; one rank a position, whose collectives
    are no-ops, where ``groups`` is None), each call under its position,
    its ``Rank`` and ``mesh`` / ``rules``. ``setup(i, r, rank)``, called
    on the caller's thread before its position's ranks start, fills in
    the rank and returns ``arg``; ``finish(i, results)``, called on the
    caller's thread once position i's ranks have run (before the next
    position's start), replaces its ranks' results by what it returns (a
    position's backward runs there, so one position's graph is alive at a
    time).

    A position's ranks run in lockstep threads (one rank: in the caller's
    thread); the positions one after another, or (``lockstep``: MoE
    groups spanning positions) all at once, rank r of every position
    sharing an ``Exchange``. Within a dry run's view only the view's rank
    of the positions it holds runs, and threads take turns between
    exchanges (sixteen threads contending for the GIL op by op run ~5x
    slower); a position it does not hold gets the first held one's
    results. The first failure is raised after every thread has
    stopped."""
    size = 1 if groups is None else groups[0].size
    solo = None if groups is None else groups[0].solo
    mine = [solo] if solo is not None else list(range(size))
    held = held_positions(count, mesh, rules)
    run = list(range(count)) if lockstep or held is None else held
    args, rank_of = {}, {}

    def prepare(i):
        for r in mine:
            rank_of[i, r] = Rank(r, None if groups is None else groups[i])
            args[i, r] = (None if setup is None
                          else setup(i, r, rank_of[i, r]))

    turns = threading.Lock() if current_view() is not None else None
    exchanges = ({r: Exchange(count, turns) for r in range(size)}
                 if lockstep and count > 1 else {})
    out = {}
    errors: list = []
    grad = torch_grad_mode()
    modes = _dispatch_modes()

    def one(i, r):
        ctx = (use_mesh_rules(mesh, rules) if mesh is not None
               else contextlib.nullcontext())
        position = Position(i, count, exchanges.get(r))
        with ctx, data_position(position), rank_context(rank_of[i, r]):
            out[i, r] = fn(i, r, args[i, r])

    def body(i, r):
        try:
            with grad(), modes(), turns or contextlib.nullcontext():
                one(i, r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(((i, r), e))
            if groups is not None:
                groups[i].abort()
            for ex in exchanges.values():
                ex.abort()

    def threads(keys):
        if len(keys) == 1:
            one(*keys[0])
            return
        ts = [threading.Thread(target=body, args=k, daemon=True)
              for k in keys]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errors:
            # the failure itself, not a peer's broken wait
            first = min(errors, key=lambda e: (
                isinstance(e[1], threading.BrokenBarrierError), e[0]))
            raise first[1]

    def done(i):
        if finish is not None:
            got = finish(i, [out.get((i, r)) for r in range(size)])
            for r in mine:
                out[i, r] = got[r]
        for r in mine:          # the position's weights and memo go
            args.pop((i, r), None)
            rank_of.pop((i, r), None)

    if exchanges:
        for i in run:
            prepare(i)
        threads(list(args))
        for i in run:
            done(i)
    else:
        for i in run:
            prepare(i)
            threads([(i, r) for r in mine])
            done(i)
    first = run[0]
    return [[out.get((i, r), out.get((first, r), out[first, mine[0]]))
             for r in range(size)] for i in range(count)]


def held_positions(count: int, mesh, rules) -> Optional[list]:
    """Within ``distributed.mesh.view``: the positions (of ``count``)
    whose device is at the view's coordinates; None outside a view."""
    held = current_view()
    if held is None or mesh is None or count == 1:
        return None
    where = axis_positions(mesh, _axes((rules or {}).get("batch")))
    coords = [tuple(w.get(a, 0) for a in mesh.axis_names) for w in where]
    out = [i for i in range(count) if coords[i] == held]
    if not out:
        raise ValueError(f"the view {held} holds no data position")
    return out


def _dispatch_modes() -> Callable:
    """A context factory entering, in another thread, the dispatch modes
    active on this thread (PyTorch keeps them per thread): a dry run's
    counter sees the lockstep positions' work."""
    from torch.utils._python_dispatch import (
        _get_current_dispatch_mode_stack, _pop_mode, _push_mode)
    stack = _get_current_dispatch_mode_stack()

    @contextlib.contextmanager
    def modes():
        for m in stack:
            _push_mode(m)
        try:
            yield
        finally:
            for _ in stack:
                _pop_mode()
    return modes


def torch_grad_mode() -> Callable:
    """A context factory restoring this thread's grad and inference modes
    in another thread (PyTorch keeps them per thread)."""
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()

    @contextlib.contextmanager
    def mode():
        with torch.inference_mode(inference), torch.set_grad_enabled(grad):
            yield
    return mode
