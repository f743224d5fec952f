"""Tensor-parallel compute over "model" (``models/sharding.py``'s ranks,
``distributed.mesh``'s group collectives, ``launch/steps.py``), on the
CPU at smoke width:

    PYTHONPATH=src:tests python -m pytest -q tests/test_torch_tensor_parallel.py

- each group collective against its plain definition at float64, its
  backward by ``torch.autograd.gradcheck``, and through ranks meeting in
  lockstep threads; a group's sums of bf16 tensors formed in float32
  and rounded once;
- every architecture's loss and gradients on (1, 4) and (4, 2) meshes
  against one device within 1e-5 x max|want| at float32, per-period remat
  off and on, and on an uneven (1, 3) mesh, on which the smoke config's 4
  heads, ``ff`` 128, vocabulary 512 and sequence 32 do not divide;
- the layout: on a (1, 4) meta mesh each device's FLOPs of matrix
  products are one device's / 4 exactly, and no rank makes a whole ``wq``
  or a whole (B, c, V) logits chunk; a (4, 2) step's collective bytes as
  the reference's layout rules give them;
- serving: ``generate`` on (1, 4) and (2, 2) gives one device's tokens at
  float32, each rank reading its own slab of the KV caches.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.distributed import mesh as M
from repro_torch.launch import dryrun, serve, specs, steps
from repro_torch.launch import mesh as lm
from repro_torch.launch import roofline as rf
from repro_torch.launch import sharding as shd
from repro_torch.launch.counting import MetaCounter
from repro_torch.models import Model
from repro_torch.models import sharding as msh
from repro_torch.optim import adamw

from test_torch_sharded_train import GRAD_TOL, make_batch, rel_err

CPU = torch.device("cpu")
META = torch.device("meta")
ARCHS = list(registry.ARCHS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (restored after it), as the
    sharded tests take: its many small ops run faster so under the
    suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def group(m, devices=None, solo=None):
    devices = devices or [CPU] * m
    return M.Group(devices, [(0, r) for r in range(m)], solo)


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

def plain(op, xs, dim):
    """The collectives' definitions on whole tensors."""
    m = len(xs)
    if op == "all-gather":
        return [torch.cat(xs, dim)] * m
    total = sum(xs)
    if op == "all-reduce":
        return [total] * m
    n = total.shape[dim]
    return [total.narrow(dim, j * n // m, (j + 1) * n // m - j * n // m)
            for j in range(m)]


FNS = {"all-gather": lambda g, xs, d: M.group_all_gather(g, xs, d),
       "reduce-scatter": lambda g, xs, d: M.group_reduce_scatter(g, xs, d),
       "all-reduce": lambda g, xs, d: M.group_all_reduce(g, xs)}


@pytest.mark.parametrize("op", list(FNS))
@pytest.mark.parametrize("m,dim", [(2, 0), (4, 1), (3, 1)])
def test_collective_matches_its_definition(op, m, dim):
    gen = torch.Generator().manual_seed(m + dim)
    shape = (2, 12, 2)
    xs = [torch.randn(shape, dtype=torch.float64, generator=gen,
                      requires_grad=True) for _ in range(m)]
    got = FNS[op](group(m), xs, dim)
    for a, b in zip(got, plain(op, xs, dim)):
        assert torch.equal(a, b)

    def fn(*xs):
        return tuple(FNS[op](group(m), list(xs), dim))
    assert torch.autograd.gradcheck(fn, tuple(xs))


def test_group_copy_backward_is_the_all_reduce():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((5, 4), dtype=torch.float64, generator=gen,
                    requires_grad=True)
    copies = M.group_copy(group(3), x)
    assert all(torch.equal(c, x) for c in copies)
    assert torch.autograd.gradcheck(
        lambda x: tuple(M.group_copy(group(3), x)), (x,))
    ws = [torch.randn((5, 4), dtype=torch.float64, generator=gen)
          for _ in range(3)]
    sum((c * w).sum() for c, w in zip(copies, ws)).backward()
    assert torch.allclose(x.grad, sum(ws), rtol=0, atol=1e-15)


def test_group_sums_of_bf16_round_once():
    """A group's sums of bf16 tensors (reduce-scatter, all-reduce, and the
    all-gather's transpose) are the float32 sums in rank order, rounded
    once to bf16."""
    m = 4
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn((2, 8, 16), generator=gen).bfloat16()
          for _ in range(m)]
    want = sum(x.float() for x in xs).bfloat16()
    assert not torch.equal(want, xs[0] + xs[1] + xs[2] + xs[3])
    got = M.group_reduce_scatter(group(m), xs, 1)
    assert all(torch.equal(got[r], want[:, 2 * r:2 * r + 2])
               for r in range(m))
    assert all(torch.equal(t, want)
               for t in M.group_all_reduce(group(m), xs))
    leaves = [x.clone().requires_grad_() for x in xs]
    outs = M.group_all_gather(group(m), leaves, 1)
    gs = [torch.randn((2, 32, 16), generator=gen).bfloat16()
          for _ in range(m)]
    torch.autograd.backward(outs, gs)
    total = sum(g.float() for g in gs).bfloat16()
    assert all(torch.equal(leaves[r].grad, total[:, 8 * r:8 * r + 8])
               for r in range(m))


def test_ranks_meet_in_lockstep_threads():
    """Each rank's ``collective`` through ``run_ranks``' threads: the
    results are the definitions', and one ``backward()`` of the ranks'
    summed outputs gives every rank's input the transposes' gradients."""
    m = 4
    gen = torch.Generator().manual_seed(2)
    xs = [torch.randn((8, 5), dtype=torch.float64, generator=gen,
                      requires_grad=True) for _ in range(m)]
    ws = [torch.randn((8, 20), dtype=torch.float64, generator=gen)
          for _ in range(m)]
    groups = [group(m)]

    def fn(i, r, _):
        rank = msh.current_rank()
        assert rank.index == r and msh.tp_size() == m
        gathered = rank.collective("all-gather", xs[r], 1)   # (8, 20)
        summed = rank.collective("all-reduce", gathered * ws[r])
        return rank.collective("reduce-scatter", summed, 0), gathered

    out = msh.run_ranks(fn, 1, groups, False)[0]
    whole = torch.cat(xs, 1)
    total = sum(whole * w for w in ws)
    for r, (part, gathered) in enumerate(out):
        assert torch.equal(gathered, whole)
        assert torch.allclose(part, m * total[2 * r:2 * r + 2], rtol=1e-14)
    sum(p.sum() for p, _ in out).backward()
    want = torch.autograd.grad(sum(m * total).sum(), xs)
    for x, w in zip(xs, want):
        assert torch.allclose(x.grad, w, rtol=1e-12)


def test_a_dry_run_view_runs_one_rank_of_its_shape():
    """Within a view a rank has no peers: its collective makes the shape
    the group would and records the bytes, on meta."""
    x = torch.empty((2, 16, 8), device=META)
    g = group(4, [META] * 4, solo=0)
    seen = []
    M._LISTENERS.append(lambda *a: seen.append(a))
    try:
        out = M.group_all_gather(g, [x, None, None, None], 1)
        rs = M.group_reduce_scatter(g, [x, None, None, None], 1)
    finally:
        M._LISTENERS.pop()
    assert out[0].shape == (2, 64, 8) and out[1:] == [None] * 3
    assert rs[0].shape == (2, 4, 8)
    assert seen == [("all-gather", 2 * 64 * 8 * 4, 4, (0, 0)),
                    ("reduce-scatter", 2 * 4 * 8 * 4, 4, (0, 0))]


# ---------------------------------------------------------------------------
# Every architecture's gradients against one device
# ---------------------------------------------------------------------------

def mesh_of(shape):
    return lm.make_host_mesh(shape[1], [CPU] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def single(arch, remat, seq=32):
    cfg = dataclasses.replace(registry.smoke(arch, seq=seq), remat=remat)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 8, seq, 5)
    loss = model.loss(batch)
    loss.backward()
    return cfg, model, batch, loss.detach()


def check_split(arch, shape, remat):
    cfg, model, batch, loss = single(arch, remat)
    mesh = mesh_of(shape)
    rules = lm.activation_rules(mesh)
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    got, grads = steps.lm_value_and_grad(Model(cfg, device="meta"), params,
                                         batch, mesh, rules)
    assert rel_err(got, loss) <= GRAD_TOL
    bad = {n: rel_err(grads[n].gather(), p.grad)
           for n, p in model.named_parameters()
           if rel_err(grads[n].gather(), p.grad) > GRAD_TOL}
    assert bad == {}


@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
@pytest.mark.parametrize("shape", [(1, 4), (4, 2)], ids=["1x4", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_split_grads_match_single_device(arch, shape, remat):
    check_split(arch, shape, remat)


@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_uneven_mesh_grads_match_single_device(arch, remat):
    """(1, 3): heads 4, ``ff`` 128, vocabulary 512 and sequence 32 do not
    divide 3, so each rank computes whole on whole weights and the loss
    counts its share of the tokens."""
    cfg = registry.smoke(arch, seq=32)
    assert all(n % 3 for n in (cfg.n_heads, cfg.vocab_size, 32))
    assert cfg.d_ff % 3 or cfg.d_ff == 0
    check_split(arch, (1, 3), remat)


# ---------------------------------------------------------------------------
# The layout: FLOPs and what a rank makes
# ---------------------------------------------------------------------------

class Shapes(MetaCounter):
    """A ``MetaCounter`` that also keeps the shape of every op's result."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_each_rank_does_a_quarter_of_the_matrix_products():
    cfg = registry.smoke("stablelm-1.6b", seq=64)
    b, s = 8, 64
    assert (cfg.n_heads, cfg.d_ff, cfg.vocab_size) == (4, 128, 512)
    shape = registry.ShapeSpec("train", s, b, "train")
    model = Model(cfg, device=META)
    batch = specs.batch_specs(cfg, shape, with_labels=True)
    params = dict(model.named_parameters())
    one, _, _ = dryrun.count_step(steps.build_train_step(model),
                                  (adamw.init(params), batch))
    mesh = lm.make_host_mesh(4, [META] * 4)
    rules = lm.activation_rules(mesh)
    fn, args, _, slabs = dryrun._cell(cfg, shape, mesh, rules)
    counter = Shapes(mesh, rules)
    counter.place((args, slabs))
    with counter:
        fn(*args)
    want = one.devices[()].flops
    assert want > 0
    assert [counter.devices[(0, r)].flops * 4 for r in range(4)] == \
        [want] * 4
    d, hq = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim
    chunk = min(cfg.loss_chunk, s)
    assert (d, hq) not in counter.shapes and (hq, d) not in counter.shapes
    assert (b, chunk, cfg.vocab_size) not in counter.shapes
    assert (b, chunk, cfg.vocab_size // 4) in counter.shapes


def test_split_collective_bytes_follow_the_layout_rules():
    """A (4, 2) train step's collectives on the first device, from the
    reference's rules (``models/sharding.py``: ``seq``, ``heads``, ``ff``
    and ``vocab`` over "model", the batch over "data") and the parameter
    layout, f32 throughout:

    - weights: each device all-gathers over "data" the part of a weight it
      computes with — its model slab of a weight cut over "model", the
      weight whole otherwise; its gradient's reduction into the slabs is a
      reduce-scatter where the slab is cut over "data", else an
      all-reduce; a weight whole over "model" is used by both ranks, whose
      gradients are all-reduced over the pair;
    - the residual stream (B, S / M, D) between layers: the embedding's
      partial lookups and each row-parallel output (attention's and the
      MLP's ``wo``, two a layer) reduce-scattered into it, each layer's
      two normed inputs and the final hidden state all-gathered whole
      from it; the backward runs the transpose of each;
    - the vocab-parallel loss, one chunk of c tokens: the ranks' (B, c)
      log-sum-exps all-gathered and the label logits all-reduced, and in
      the backward their transposes."""
    cfg = registry.smoke("stablelm-1.6b")
    mesh = lm.make_host_mesh(2, [META] * 8)
    rules = lm.activation_rules(mesh)
    assert all(rules[a] == "model" for a in ("seq", "heads", "ff", "vocab"))
    m = mesh.shape["model"]
    shape = registry.ShapeSpec("train", 64, 8, "train")
    fn, args, _, params = dryrun._cell(cfg, shape, mesh, rules)
    counter, _, _ = dryrun.count_step(fn, args, mesh, rules, params)
    want = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for st in params.values():
        axes = {a for e in st.spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        n = math.prod(st.shape) // (m if "model" in axes else 1)
        if "data" in axes:
            want["all-gather"] += 4 * n
        if "model" not in axes:
            want["all-reduce"] += 4 * n
        slab = 4 * math.prod(st.sharding.shard_shape(st.shape))
        want["reduce-scatter" if "data" in axes else "all-reduce"] += slab
    b, s, d = 8 // mesh.shape["data"], 64, cfg.d_model
    c = min(cfg.loss_chunk, s)
    stream = 1 + 2 * cfg.n_layers        # reduce-scatters into the stream
    out = 2 * cfg.n_layers + 1           # all-gathers out of it
    whole, part = 4 * b * s * d, 4 * b * s * d // m
    want["all-gather"] += (out + stream) * whole + (s // c) * 4 * m * b * c
    want["reduce-scatter"] += (out + stream) * part + (s // c) * 4 * b * c
    want["all-reduce"] += 2 * (s // c) * 4 * b * c
    stats = rf.collective_stats(counter.devices[counter.home].collectives)
    assert stats.bytes_by_op == want


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-12b"])
def test_split_generate_gives_single_device_tokens(arch, shape):
    cfg = registry.smoke(arch, seq=64)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    want = serve.generate(model, prompts, 6, 32)
    got = serve.generate(model, prompts, 6, 32, mesh=mesh_of(shape))
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-12b"])
def test_each_rank_reads_its_own_kv_slab(arch):
    """stablelm's 4 kv heads divide (1, 4): a rank's view of a KV cache is
    its slab itself, one kv head; gemma3's 2 do not, and its cache is cut
    along head_dim, read whole over "model"."""
    cfg = registry.smoke(arch, seq=64)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    mesh = mesh_of((1, 4))
    rules = lm.activation_rules(mesh)
    values = {n: p.detach() for n, p in model.named_parameters()}
    params = steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules))
    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    cache, _ = steps.build_prefill(model, 32, mesh, rules, params)(
        {"tokens": prompts})
    k = cache["layers"][-1]["k"]
    split = cfg.n_kv_heads % 4 == 0
    assert tuple(k.spec)[2:] == (("model", None) if split
                                 else (None, "model"))
    for r in range(4):
        view = steps.local_cache(cache, {}, CPU, r)["layers"][-1]["k"]
        if split:
            assert view.shape[2] == cfg.n_kv_heads // 4
            assert view.data_ptr() == k.slabs[0, r].data_ptr()
        else:
            assert tuple(view.shape) == tuple(k.shape)
    assert np.all([s.shape == M.shard_shape(k.shape, k.sharding)
                   for _, s in k.items()])
