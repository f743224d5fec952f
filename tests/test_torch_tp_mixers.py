"""MoE, the recurrent mixers and cross-attention split over "model"
(``models/sharding.py``'s ranks), on the CPU at smoke width:

    PYTHONPATH=src:tests python -m pytest -q tests/test_torch_tp_mixers.py

- the all-to-all (``distributed.mesh.group_exchange``) against its plain
  definition at float64, its backward by ``torch.autograd.gradcheck``,
  and Mamba's ``in_proj`` blocks it hands each rank (``paired_blocks``);
- each layer on M ranks of one data position (a (1, M) mesh, its weights
  in ``launch/sharding.py``'s layout) against one device at float32,
  the output, the aux loss, the decode state and every gradient (the
  weights' and the input's) within 1e-5 x max|want|: ``moe_ffn`` expert
  parallel (8 experts on 4) and ``ff``-parallel (6 experts on 4), top-1
  with a shared expert and top-2 at a capacity that drops tokens, both
  dispatches; ``mamba_forward`` / ``mamba_step``, ``rglru_forward`` /
  ``rglru_step`` on 2 and 4 ranks; cross-attention's forward and decode,
  kv heads dividing the ranks and not; each one-device result also
  against the JAX function on the same numpy inputs;
- routing groups spanning data positions, expert- and ``ff``-parallel,
  through the whole model's gradients;
- a (1, 4) meta mesh: each rank's FLOPs of the expert, Mamba and RG-LRU
  products are one device's / 4 (the router excepted), and no rank forms
  a whole expert tensor under expert parallelism or a whole ``in_proj``,
  ``wa``, ``wx`` or ``out_proj``;
- ``generate`` on (1, 4) and (2, 2) gives one device's tokens at
  float32, each rank reading its own channel slice of a recurrent state
  and its own heads of a cross cache;
- the top-1 gate: exactly 1, as the reference's ``t / t`` is, so the
  port's MoE output is the reference's bit for bit (with an activation
  both libraries compute exactly), and the router's gradient is the
  reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as ref_registry
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models import recurrent as ref_rec
from repro_torch.configs import registry
from repro_torch.distributed import mesh as M
from repro_torch.launch import dryrun, serve, specs, steps
from repro_torch.launch import mesh as lm
from repro_torch.launch import sharding as shd
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import recurrent as rec
from repro_torch.models import sharding as msh
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import ParamModule, param_tree
from repro_torch.optim import adamw

from test_torch_models_dense import TOL, rel
from test_torch_sharded_train import GRAD_TOL, make_batch, rel_err
from test_torch_tensor_parallel import Shapes, group, mesh_of
from test_torch_train_dense import GRAD_FLOOR, close

CPU = torch.device("cpu")
META = torch.device("meta")
D = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (restored after it), as the
    sharded tests take."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def host(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# The all-to-all
# ---------------------------------------------------------------------------

def test_exchange_matches_its_definition():
    """Each rank takes the pieces its plan lists, in pieces of uneven
    lengths and order, every line of every rank's tensor once; the
    backward sends each piece's cotangent back (gradcheck); a plan that
    takes a line twice, or leaves one, is refused."""
    m = 3
    gen = torch.Generator().manual_seed(4)
    xs = [torch.randn((2, 6, 3), dtype=torch.float64, generator=gen,
                      requires_grad=True) for _ in range(m)]
    plan = [[(1, 0, 2), (2, 4, 2), (0, 5, 1)], [(0, 2, 3), (2, 0, 4)],
            [(1, 2, 4), (0, 0, 2)]]
    for bad in ([[(1, 0, 2), (2, 4, 2), (0, 4, 2)], *plan[1:]],
                [[(1, 0, 2), (2, 4, 2)], *plan[1:]]):
        with pytest.raises(ValueError, match="not each of"):
            M.group_exchange(group(m), xs, 1, bad)
    got = M.group_exchange(group(m), xs, 1, plan)
    for j in range(m):
        want = torch.cat([xs[s].narrow(1, a, n) for s, a, n in plan[j]], 1)
        assert torch.equal(got[j], want)

    def fn(*xs):
        return tuple(M.group_exchange(group(m), list(xs), 1, plan))
    assert torch.autograd.gradcheck(fn, tuple(xs))


@pytest.mark.parametrize("m", [2, 4])
def test_paired_blocks_are_the_ranks_channels_of_both_halves(m):
    """Mamba's ``in_proj`` (D, 2 d_inner) stored in column slabs of 2
    d_inner / M: rank r gets its d_inner / M columns of ``xin`` and the
    same of ``z``, and the all-to-all is recorded at its bytes."""
    di = 16
    w = torch.arange(4 * 2 * di, dtype=torch.float32).reshape(4, 2 * di)
    slab = 2 * di // m
    c = di // m
    seen = []

    def fn(i, r, _):
        rank = msh.current_rank()
        rank.split = {}
        return msh.paired_blocks(w[:, r * slab:(r + 1) * slab], 1)

    M._LISTENERS.append(lambda *a: seen.append(a))
    try:
        out = msh.run_ranks(fn, 1, [group(m)], False)[0]
    finally:
        M._LISTENERS.pop()
    for r in range(m):
        assert torch.equal(out[r], torch.cat(
            [w[:, r * c:(r + 1) * c], w[:, di + r * c:di + (r + 1) * c]], 1))
    assert seen == [("all-to-all", 4 * 2 * c * 4, m, (0, r))
                    for r in range(m)]


# ---------------------------------------------------------------------------
# One layer on M ranks against one device
# ---------------------------------------------------------------------------

class Holder(ParamModule):
    """A layer under the name the layout rules read (``ffn``, ``mixer``,
    ``cross``), beside its input ``x`` held as a weight whole over
    "model" (a rank's use of it is its slice: its gradient is the sum of
    the ranks')."""

    def __init__(self, name: str, layer: nn.Module, x: torch.Tensor):
        super().__init__(CPU)
        self.name = name
        self.add_module(name, layer)
        self.register_parameter("x", nn.Parameter(x.clone()))


class LayerShare(steps.LMShare):
    """``fn(layer, x, local)`` -> (y, aux, parts) as a data position's share
    of a loss ``sum(y * w) + aux``: ``x`` and ``y`` in the residual
    stream's layout, ``parts`` the tensors to compare (a rank's decode
    state, its kv heads); each rank's ``(y, parts)`` kept in ``outs``."""

    def __init__(self, holder: Holder, fn):
        super().__init__(holder)
        self.fn = fn
        self.outs = {}

    def __call__(self, local, leaves, denom, cuts=None):
        tree = param_tree(self.model, leaves)
        if cuts is not None:
            msh.current_rank().split = msh.split_table(
                param_tree(self.model, {n: n for n in leaves}), tree, cuts)
        x, w = tree["x"], local["w"]
        s = x.shape[1]
        with msh.sequence(s):
            y, aux, parts = self.fn(tree[self.model.name],
                                    msh.shard(x, "batch", "seq", None),
                                    local)
            if msh.seq_cut(s):
                loss = (y * msh.shard(w, "batch", "seq", None)).sum()
            else:
                mine = msh.own(s)
                loss = (y[:, mine] * w[:, mine]).sum()
        self.outs[msh.tp_index()] = (y.detach(), [t.detach() for t in parts])
        return loss + aux if msh.tp_index() == 0 else loss


def on_ranks(holder: Holder, fn, local: dict, m: int, cfg):
    """The layer on one device and on M ranks of a (1, M) mesh: (want,
    got), each (loss, outs, {name: gradient}), the ranks' gradients
    gathered whole from their slabs."""
    holder.zero_grad(set_to_none=True)
    one = LayerShare(holder, fn)
    loss = one(local, dict(holder.named_parameters()), None)
    loss.backward()
    want = (loss.detach(), one.outs,
            {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in holder.named_parameters()})
    mesh = mesh_of((1, m))
    rules = lm.activation_rules(mesh)
    values = {n: p.detach() for n, p in holder.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    split = LayerShare(holder, fn)
    got_loss, grads = steps.sharded_value_and_grad(
        split, params, local, mesh, rules, torch.tensor(1.0))
    got = (got_loss, split.outs, {n: g.gather() for n, g in grads.items()})
    return want, got, params


def check_layer(holder, fn, local, m, cfg, dims=(), seq_cut=True):
    """The split's loss, output, parts and gradients within 1e-5 x
    max|want| of one device's; returns one device's (y, parts)."""
    want, got, params = on_ranks(holder, fn, local, m, cfg)
    assert rel_err(got[0], want[0]) <= GRAD_TOL
    wy, wparts = want[1][0]
    outs = got[1]
    gy = (torch.cat([outs[r][0] for r in range(m)], 1) if seq_cut
          else outs[0][0])
    assert rel_err(gy, wy) <= GRAD_TOL
    for k, d in enumerate(dims):
        part = (torch.cat([outs[r][1][k] for r in range(m)], d)
                if d is not None else outs[0][1][k])
        assert rel_err(part, wparts[k]) <= GRAD_TOL
    bad = {n: rel_err(g, want[2][n]) for n, g in got[2].items()
           if rel_err(g, want[2][n]) > GRAD_TOL}
    assert bad == {}
    return wy, wparts, params


def layout_cfg(arch, moe_cfg=None):
    cfg = registry.smoke(arch, seq=32)
    return dataclasses.replace(cfg, moe=moe_cfg)


# ---- MoE -------------------------------------------------------------------

MOE_CASES = {
    # (top_k, capacity factor, shared expert, group size)
    "top1-shared": (1, 8.0, True, 16),
    "top2-drops": (2, 1.0, False, 32),
}


def moe_pair(experts, kind, dispatch, f=128):
    top_k, cf, shared, sg = MOE_CASES[kind]
    base = "llama4-scout-17b-a16e"
    changes = dict(n_experts=experts, top_k=top_k, capacity_factor=cf,
                   shared_expert=shared, group_size=sg, dispatch=dispatch)
    ref_cfg = dataclasses.replace(ref_registry.smoke(base).moe, **changes)
    cfg = dataclasses.replace(registry.smoke(base).moe, **changes)
    p = ref_moe.init_moe(jax.random.PRNGKey(experts + top_k), D, f,
                         ref_cfg)
    layer = moe.MoE(D, f, cfg, CPU)
    layer.load_state_dict(host(p))
    return p, ref_cfg, layer, cfg


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("kind", list(MOE_CASES))
@pytest.mark.parametrize("route,experts,m,f", [
    ("experts", 8, 4, 128), ("ff", 6, 4, 128), ("ff", 8, 3, 96)],
    ids=["ep", "ff", "ff-d-uneven"])
def test_moe_on_ranks_matches_one_device(route, experts, m, f, kind,
                                         dispatch):
    """8 experts on 4 ranks split the experts, 6 split ``ff`` (128 / 4);
    8 on 3 split ``ff`` (96 / 3) where D = 64 does not divide 3, so the
    experts' partial outputs are all-reduced, not reduce-scattered along
    D (and the sequence, 32, stays whole); 64 tokens in groups of 16
    (top 1) or 32 (top 2, whose capacity factor 1 drops tokens)."""
    p, ref_cfg, layer, cfg = moe_pair(experts, kind, dispatch, f)
    rng = np.random.default_rng(experts)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    w = rng.standard_normal((2, 32, D)).astype(np.float32)
    holder = Holder("ffn", layer, torch.from_numpy(x))

    def fn(lp, xs, local):
        y, aux = moe.moe_ffn(lp, xs, cfg)
        return y, aux, []
    y, _, params = check_layer(holder, fn, {"w": torch.from_numpy(w)}, m,
                               layout_cfg("granite-moe-3b-a800m", cfg),
                               seq_cut=32 % m == 0)
    assert steps._model_cut(params["ffn.wi_gate"]) == (
        0 if route == "experts" else 2)
    want, want_aux = ref_moe.moe_ffn(p, jnp.asarray(x), ref_cfg)
    with torch.no_grad():
        _, aux = moe.moe_ffn(layer, torch.from_numpy(x), cfg)
    assert rel(y, want) <= TOL
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    if kind == "top2-drops":
        c = moe._capacity(32, cfg)
        kept = moe.route(torch.softmax(torch.from_numpy(x).reshape(
            2, 32, D) @ layer.router.detach(), -1), cfg, c)[3]
        assert float(sum(kept).sum()) < 2 * 32 * 2       # tokens dropped


# ---- the recurrent mixers --------------------------------------------------

def mamba_pair(d=D):
    ref_cfg = ref_registry.smoke("falcon-mamba-7b").ssm
    p = ref_rec.init_mamba(jax.random.PRNGKey(3), d, ref_cfg)
    cfg = registry.smoke("falcon-mamba-7b").ssm
    layer = rec.Mamba(d, cfg, CPU)
    layer.load_state_dict(host(p))
    return p, ref_cfg, layer, cfg


def rglru_pair(d=D):
    ref_cfg = ref_registry.smoke("recurrentgemma-9b").rglru
    p = ref_rec.init_rglru(jax.random.PRNGKey(4), d, ref_cfg)
    cfg = registry.smoke("recurrentgemma-9b").rglru
    layer = rec.RGLRU(d, cfg, CPU)
    layer.load_state_dict(host(p))
    return p, ref_cfg, layer, cfg


def channels_of(state, m):
    """A rank's channel slice of a decode state (h, conv_buf), as
    ``launch.steps.local_cache`` hands it."""
    r, n = msh.tp_index(), msh.tp_size()
    return tuple(t.narrow(d, r * t.shape[d] // n, t.shape[d] // n)
                 for t, d in zip(state, rec.STATE_CHANNEL_DIMS))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrent_forward_on_ranks_matches_one_device(kind, m):
    """The prefill (sequence 32: a slice a rank in the stream) and its
    last state, each rank's state its channel slice."""
    p, ref_cfg, layer, cfg = (mamba_pair if kind == "mamba"
                              else rglru_pair)()
    fwd, ref_fwd = ((rec.mamba_forward, ref_rec.mamba_forward)
                    if kind == "mamba" else
                    (rec.rglru_forward, ref_rec.rglru_forward))
    rng = np.random.default_rng(m)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    w = rng.standard_normal((2, 32, D)).astype(np.float32)
    holder = Holder("mixer", layer, torch.from_numpy(x))

    def fn(lp, xs, local):
        y, state = fwd(lp, xs, cfg)
        return y, torch.zeros(()), list(state)
    y, state, _ = check_layer(holder, fn, {"w": torch.from_numpy(w)}, m,
                              layout_cfg("falcon-mamba-7b"),
                              rec.STATE_CHANNEL_DIMS)
    want, want_state = jax.jit(lambda p, x: ref_fwd(p, x, ref_cfg))(
        p, jnp.asarray(x))
    assert rel(y, want) <= TOL
    for g, ws in zip(state, want_state):
        assert rel(g, ws) <= TOL


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrent_step_on_ranks_matches_one_device(kind, m):
    """One decode step from a state each rank holds its channel slice
    of; the new state likewise."""
    p, ref_cfg, layer, cfg = (mamba_pair if kind == "mamba"
                              else rglru_pair)()
    step, ref_step = ((rec.mamba_step, ref_rec.mamba_step)
                      if kind == "mamba" else
                      (rec.rglru_step, ref_rec.rglru_step))
    init = (rec.init_mamba_state(2, D, cfg) if kind == "mamba"
            else rec.init_rglru_state(2, D, cfg))
    rng = np.random.default_rng(10 + m)
    state = [rng.standard_normal(t.shape).astype(np.float32) for t in init]
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    w = rng.standard_normal((2, 1, D)).astype(np.float32)
    holder = Holder("mixer", layer, torch.from_numpy(x))
    local = {"w": torch.from_numpy(w), "h": torch.from_numpy(state[0]),
             "buf": torch.from_numpy(state[1])}

    def fn(lp, xs, local):
        st = (local["h"], local["buf"])
        if msh.tp_size() > 1:
            st = channels_of(st, msh.tp_size())
        y, new = step(lp, xs, cfg, st)
        return y, torch.zeros(()), list(new)
    y, new, _ = check_layer(holder, fn, local, m,
                            layout_cfg("falcon-mamba-7b"),
                            rec.STATE_CHANNEL_DIMS, seq_cut=False)
    want, want_new = jax.jit(lambda p, x, s: ref_step(p, x, ref_cfg, s))(
        p, jnp.asarray(x), tuple(jnp.asarray(s) for s in state))
    assert rel(y, want) <= TOL
    for g, ws in zip(new, want_new):
        assert rel(g, ws) <= TOL


# ---- cross-attention -------------------------------------------------------

def cross_pair(n_kv):
    p = ref_attn.init_attention(jax.random.PRNGKey(n_kv), D, 4, n_kv, 16)
    layer = attn.Attention(D, 4, n_kv, 16, CPU)
    layer.load_state_dict(host(p))
    kw = dict(n_heads=4, n_kv=n_kv, head_dim=16, causal=False,
              use_rope=False)
    return p, ref_attn.AttnSpec(**kw), layer, attn.AttnSpec(**kw)


@pytest.mark.parametrize("n_kv,m", [(4, 2), (4, 4), (1, 4)],
                         ids=["kv4-on-2", "kv4-on-4", "kv1-on-4"])
def test_cross_attention_on_ranks_matches_one_device(n_kv, m):
    """whisper's cross-attention (4 heads of 16) over 24 encoder frames:
    the forward (queries from the stream, keys and values from the
    encoder output whole) and a decode step against the cache it made;
    with 4 kv heads each rank projects and reads its own, with 1 the kv
    head is whole on every rank (its head_dim cut in storage)."""
    p, ref_spec, layer, spec = cross_pair(n_kv)
    rng = np.random.default_rng(n_kv + m)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    enc = rng.standard_normal((2, 24, D)).astype(np.float32)
    w = rng.standard_normal((2, 32, D)).astype(np.float32)
    pos = torch.arange(32, dtype=torch.int32)[None].expand(2, 32)
    kpos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    holder = Holder("cross", layer, torch.from_numpy(x))
    split_kv = n_kv % m == 0

    def fn(lp, xs, local):
        y, (k, v) = attn.attn_forward(lp, spec, xs, pos, k_pos=kpos,
                                      xkv=local["enc"])
        return y, torch.zeros(()), [k, v]
    local = {"w": torch.from_numpy(w), "enc": torch.from_numpy(enc)}
    kv_dim = 2 if split_kv else None
    y, (k, v), _ = check_layer(holder, fn, local, m,
                               layout_cfg("whisper-tiny"), (kv_dim, kv_dim))
    want, (wk, wv) = ref_attn.attn_forward(
        p, ref_spec, jnp.asarray(x), jnp.asarray(pos.numpy()),
        k_pos=jnp.asarray(kpos.numpy()), xkv=jnp.asarray(enc))
    assert rel(y, want) <= TOL and rel(k, wk) <= TOL and rel(v, wv) <= TOL

    x1 = rng.standard_normal((2, 1, D)).astype(np.float32)
    w1 = rng.standard_normal((2, 1, D)).astype(np.float32)
    holder = Holder("cross", layer, torch.from_numpy(x1))

    def step(lp, xs, local):
        cache = {"k": local["k"], "v": local["v"]}
        if msh.tp_size() > 1 and split_kv:
            n = n_kv // msh.tp_size()
            cache = {t: c.narrow(2, msh.tp_index() * n, n)
                     for t, c in cache.items()}
        return attn.cross_decode(lp, spec, xs, cache), torch.zeros(()), []
    y1, _, _ = check_layer(holder, step, {"w": torch.from_numpy(w1),
                                          "k": k, "v": v}, m,
                           layout_cfg("whisper-tiny"), seq_cut=False)
    want1 = ref_attn.cross_decode(p, ref_spec, jnp.asarray(x1),
                                  {"k": jnp.asarray(k.numpy()),
                                   "v": jnp.asarray(v.numpy())})
    assert rel(y1, want1) <= TOL


# ---------------------------------------------------------------------------
# Routing groups spanning data positions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def spanning_single(experts, dispatch, remat):
    cfg = registry.smoke("granite-moe-3b-a800m", seq=32)
    cfg = dataclasses.replace(cfg, remat=remat, moe=dataclasses.replace(
        cfg.moe, n_experts=experts, group_size=96, capacity_factor=1.0,
        dispatch=dispatch))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 8, 32, 5)
    loss = model.loss(batch)
    loss.backward()
    return cfg, model, batch, loss.detach()


@pytest.mark.parametrize("experts,shape,dispatch,remat", [
    pytest.param(8, (4, 2), "gather", False, id="ep-gather"),
    pytest.param(8, (4, 2), "gather", True, id="ep-gather-remat"),
    pytest.param(6, (2, 4), "einsum", False, id="ff-einsum"),
    pytest.param(6, (2, 4), "gather", True, id="ff-gather-remat")])
def test_spanning_groups_on_ranks_match_one_device(experts, shape,
                                                   dispatch, remat):
    """Groups of 96 tokens over positions of 64 (4 x 2) or 128 (2 x 4):
    each model index's ranks exchange their positions' choices; with
    remat the recomputation reuses the forward's exchange and
    collectives."""
    cfg, model, batch, loss = spanning_single(experts, dispatch, remat)
    mesh = mesh_of(shape)
    rules = lm.activation_rules(mesh)
    assert moe.spans_positions(cfg.moe, 8 * 32 // shape[0],
                               msh.Position(0, shape[0]))
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    assert steps._model_cut(params["layers.0.ffn.wi_gate"]) == (
        0 if experts == 8 else 2)
    got, grads = steps.lm_value_and_grad(Model(cfg, device="meta"), params,
                                         batch, mesh, rules)
    assert rel_err(got, loss) <= GRAD_TOL
    bad = {n: rel_err(grads[n].gather(), p.grad)
           for n, p in model.named_parameters()
           if rel_err(grads[n].gather(), p.grad) > GRAD_TOL}
    assert bad == {}


# ---------------------------------------------------------------------------
# The layout on a (1, 4) meta mesh
# ---------------------------------------------------------------------------

def rank_flops(holder: Holder, fn, local: dict, m: int, cfg):
    """The forward ``fn`` on one device and on each of M ranks, on meta:
    (one device's FLOPs, each rank's FLOPs, the shapes each rank's ops
    made)."""
    values = {n: p.detach() for n, p in holder.named_parameters()}
    share = LayerShare(holder, fn)

    def count(run):
        with FlopCounterMode(display=False) as fc, Shapes() as seen:
            run()
        return fc.get_total_flops(), seen.shapes

    with torch.no_grad():
        one, _ = count(lambda: share(local, values, None))
        mesh = lm.make_host_mesh(m, [META] * m)
        rules = lm.activation_rules(mesh)
        params = steps.shard_params(values, shd.param_shardings(
            values, cfg, mesh, rules))
        cuts = {n: steps._model_cut(st) for n, st in params.items()}
        groups = steps._groups(mesh, [{"data": 0}], m)

        def setup(i, r, rank):
            return {n: st.gather(META, {"model": r})
                    for n, st in params.items()}
        outs = msh.run_ranks(lambda i, r, leaves: count(
            lambda: share(local, leaves, None, cuts)), 1, groups, False,
            mesh, rules, setup)[0]
    return one, [f for f, _ in outs], [s for _, s in outs]


def meta_holder(name, layer, shape):
    layer = layer.to(META)
    return Holder(name, layer, torch.empty(shape, device=META))


@pytest.mark.parametrize("route,experts", [("experts", 8), ("ff", 6)],
                         ids=["ep", "ff"])
def test_each_rank_runs_a_quarter_of_the_expert_products(route, experts):
    """moe_ffn's forward (gather dispatch: no FLOPs in the dispatch or the
    combine) with a shared expert: the router is whole on every rank, the
    expert MLPs and the shared expert a quarter each; expert parallel, no
    rank makes a whole (E, D, F) or (E, F, D) tensor."""
    _, _, layer, cfg = moe_pair(experts, "top1-shared", "gather")
    b, s, f = 2, 32, 128
    holder = meta_holder("ffn", layer, (b, s, D))
    local = {"w": torch.empty((b, s, D), device=META)}

    def fn(lp, xs, local):
        y, aux = moe.moe_ffn(lp, xs, cfg)
        return y, aux, []
    one, ranks, shapes = rank_flops(holder, fn, local, 4,
                                    layout_cfg("granite-moe-3b-a800m", cfg))
    router = 2 * b * s * D * experts
    assert one > router
    assert ranks == [(one - router) // 4 + router] * 4
    if route == "experts":
        for seen in shapes:
            assert not {(experts, D, f), (experts, f, D)} & seen


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_each_rank_runs_a_quarter_of_the_mixer_products(kind):
    """Mamba's in_proj, x_proj, dt_proj, readout and out_proj, RG-LRU's
    gate, input, recurrence-gate and output products: a quarter each a
    rank, none of ``in_proj``, ``wa``, ``wx`` or ``out_proj`` whole."""
    _, _, layer, cfg = (mamba_pair if kind == "mamba" else rglru_pair)()
    whole = {tuple(t.shape) for n, t in layer.named_parameters()
             if n in ("in_proj", "wa", "wx", "out_proj")}
    b, s = 2, 48                # b * s rows: no weight's shape
    holder = meta_holder("mixer", layer, (b, s, D))
    local = {"w": torch.empty((b, s, D), device=META)}
    fwd = rec.mamba_forward if kind == "mamba" else rec.rglru_forward

    def fn(lp, xs, local):
        y, _ = fwd(lp, xs, cfg)
        return y, torch.zeros((), device=META), []
    one, ranks, shapes = rank_flops(holder, fn, local, 4,
                                    layout_cfg("falcon-mamba-7b"))
    assert one > 0 and ranks == [one // 4] * 4 and one % 4 == 0
    for seen in shapes:
        assert not whole & seen


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b",
                                  "llama4-scout-17b-a16e"])
def test_a_split_train_step_forms_no_whole_mixer_weight(arch):
    """A whole train step (forward, backward and the gradients' reduction)
    on a (1, 4) meta mesh: no rank makes a whole ``in_proj``, ``wa`` /
    ``wx`` / ``out_proj`` or expert tensor; the mixers' steps make each
    rank's FLOPs one device's / 4. The smoke configs take widths that no
    activation or other slab shares with those weights: a vocabulary of
    520 (its slab is not (128, 64), falcon's ``out_proj``), an RG-LRU
    width of 96 and llama4's ``ff`` 96."""
    cfg = registry.smoke(arch, seq=64)
    cfg = dataclasses.replace(cfg, vocab_size=520)
    if cfg.rglru is not None:
        cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, lru_width=96))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, d_ff=96)
    model = Model(cfg, device=META)
    whole = {tuple(p.shape) for n, p in model.named_parameters()
             if n.endswith(("mixer.in_proj", "mixer.wa", "mixer.wx",
                            "mixer.out_proj", "ffn.wi_gate", "ffn.wi_up"))
             or (n.endswith("ffn.wo") and p.ndim == 3)}
    assert whole
    shape = registry.ShapeSpec("train", 64, 8, "train")
    mesh = lm.make_host_mesh(4, [META] * 4)
    rules = lm.activation_rules(mesh)
    fn, args, _, slabs = dryrun._cell(cfg, shape, mesh, rules)
    counter = Shapes(mesh, rules)
    counter.place((args, slabs))
    with counter:
        fn(*args)
    assert not whole & counter.shapes
    if cfg.moe is None:
        batch = specs.batch_specs(cfg, shape, with_labels=True)
        params = dict(model.named_parameters())
        one, _, _ = dryrun.count_step(steps.build_train_step(model),
                                      (adamw.init(params), batch))
        want = one.devices[()].flops
        assert [counter.devices[(0, r)].flops * 4 for r in range(4)] == \
            [want] * 4


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

MIXER_ARCHS = ["recurrentgemma-9b", "falcon-mamba-7b",
               "llama4-scout-17b-a16e", "granite-moe-3b-a800m",
               "whisper-tiny"]


@functools.lru_cache(maxsize=None)
def served(arch):
    cfg = registry.smoke(arch, seq=64)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    return model, prompts, serve.generate(model, prompts, 6, 32)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_split_generate_gives_single_device_tokens(arch, shape):
    model, prompts, want = served(arch)
    got = serve.generate(model, prompts, 6, 32, mesh=mesh_of(shape))
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "falcon-mamba-7b",
                                  "whisper-tiny"])
def test_each_rank_reads_its_own_channels_and_heads(arch):
    """After a (1, 4) prefill a recurrent state is stored whole over
    "model" in every copy, and a rank's view of it is its channel slice
    of its own copy; whisper's 4 cross kv heads divide 4, so its view of
    a cross cache is its slab, one head. A decode step writes each
    rank's slice into every copy: the copies stay equal."""
    model, prompts, _ = served(arch)
    cfg = model.cfg
    mesh = mesh_of((1, 4))
    rules = lm.activation_rules(mesh)
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    batch = {"tokens": prompts}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((4, cfg.encoder.n_frames, D))
    cache, _ = steps.build_prefill(model, 32, mesh, rules, params)(batch)
    decode = steps.build_decode(model, mesh, rules, params)
    _, cache = decode(cache, prompts[:, :1])
    kinds = list(cfg.layer_kinds)
    for i, kind in enumerate(kinds):
        if kind not in ("mamba", "rglru"):
            continue
        for st, d in zip(cache["layers"][i], rec.STATE_CHANNEL_DIMS):
            assert tuple(st.spec)[d] is None
            copies = [st.slabs[0, r] for r in range(4)]
            assert all(torch.equal(c, copies[0]) for c in copies)
            for r in range(4):
                view = steps.local_cache(cache, {}, CPU, r)["layers"][i]
                part = view[rec.STATE_CHANNEL_DIMS.index(d)]
                n = st.shape[d] // 4
                assert part.shape[d] == n
                assert part.data_ptr() == copies[r].narrow(
                    d, r * n, n).data_ptr()
    if cfg.is_encoder_decoder:
        k = cache["cross"][0]["k"]
        assert tuple(k.spec)[2] == "model"
        for r in range(4):
            view = steps.local_cache(cache, {}, CPU, r)["cross"][0]["k"]
            assert view.shape[2] == cfg.n_kv_heads // 4
            assert view.data_ptr() == k.slabs[0, r].data_ptr()


# ---------------------------------------------------------------------------
# The top-1 gate
# ---------------------------------------------------------------------------

def test_top1_gate_is_the_references_bit_for_bit():
    """llama4's smoke MoE (8 experts, top 1, shared expert) at float32:
    the port takes the top-1 gate as exactly 1, the reference forms ``t /
    t``, which is exactly 1 for the positive top-1 probability. With
    ``relu`` (which both libraries compute exactly; their ``silu``'s
    ``exp`` differs by an ulp) the outputs are bit for bit; the main
    loss's gradient to the router is zero in exact arithmetic, and the
    router's gradient (the aux loss's, plus rounding residue on the
    reference's side) is the reference's within the training tests'
    bar."""
    arch = "llama4-scout-17b-a16e"
    ref_cfg = ref_registry.smoke(arch).moe
    cfg = registry.smoke(arch).moe
    assert cfg.top_k == 1 and cfg.shared_expert
    p = ref_moe.init_moe(jax.random.PRNGKey(5), D, 128, ref_cfg)
    layer = moe.MoE(D, 128, cfg, CPU)
    layer.load_state_dict(host(p))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    w = rng.standard_normal((2, 32, D)).astype(np.float32)
    topv = torch.rand((4, 8, 1)) + 0.1
    assert torch.equal(moe._gates(topv), topv / topv.sum(-1, keepdim=True))
    for act in ("relu", "silu"):
        want, _ = jax.jit(lambda p, x: ref_moe.moe_ffn(p, x, ref_cfg, act))(
            p, jnp.asarray(x))
        with torch.no_grad():
            got, _ = moe.moe_ffn(layer, torch.from_numpy(x), cfg, act)
        if act == "relu":
            assert np.array_equal(got.numpy(), np.asarray(want))
        assert rel(got, want) <= TOL

    def ref_loss(p):
        y, aux = ref_moe.moe_ffn(p, jnp.asarray(x), ref_cfg)
        return (y * jnp.asarray(w)).sum() + aux
    want = jax.jit(jax.grad(ref_loss))(p)
    y, aux = moe.moe_ffn(layer, torch.from_numpy(x), cfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    grads = {n: t.grad for n, t in layer.named_parameters()}
    want = host(want)
    top = max(float(v.abs().max()) for v in want.values())
    for n, g in grads.items():
        assert close(g, want[n], TOL, GRAD_FLOOR * top), n


# ---------------------------------------------------------------------------
# The card's bf16 bar: one device summing as the ranks sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,m,vocab", [
    ("falcon-mamba-7b", 4, 512), ("recurrentgemma-9b", 4, 512),
    ("granite-moe-3b-a800m", 16, 520)])
def test_split_association_is_the_split_step(arch, m, vocab):
    """``chip_smoke.split_association`` (phase 25's reference for the
    split's bf16 update): one device computing rank by rank, at bf16 with
    remat, gives the split's every gradient bit for bit but the norms'
    scales (float32 gradients summed over the rows of each rank's slice,
    then over the ranks), within 1e-6 x max|want| there, and its loss
    within 1e-6 (the float32 sum of the tokens' NLL in another order). granite
    at a vocabulary of 520: its table whole on every rank, as the full
    config's 49155 on 16."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    cfg = dataclasses.replace(registry.smoke(arch, seq=64), remat=True,
                              dtype="bfloat16", vocab_size=vocab)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(46))
    batch = make_batch(cfg, 4, 64, 46)
    with chip_smoke.patched(chip_smoke.split_association(torch, m, cfg)):
        loss = model.loss(batch)
        loss.backward()
    mesh = mesh_of((1, m))
    rules = lm.activation_rules(mesh)
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    got, grads = steps.lm_value_and_grad(Model(cfg, device="meta"), params,
                                         batch, mesh, rules)
    assert rel_err(got, loss.detach()) <= 1e-6
    for n, p in model.named_parameters():
        g = grads[n].gather()
        if n.endswith("scale"):
            assert rel_err(g, p.grad) <= 1e-6, n
        else:
            assert torch.equal(g, p.grad), n
