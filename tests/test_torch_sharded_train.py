"""The sharded train step (``launch/steps.py`` over a mesh of CPU slabs)
against the live reference's single-device step and the port's own
single-device step:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_train.py

- minitron-4b smoke, seq 64, batch 8 (the reference's own sharded test,
  ``tests/test_distributed.py``), one step from non-zero AdamW moments on
  (4, 2) and (2, 2, 2) ("pod", "data", "model") against the reference's
  jitted single-device step: the loss and every parameter within 5e-3,
  the reference's bars, and the update p - p0 within 1e-2 x the
  reference's largest;
- at f32, every architecture's loss and gathered gradients within
  1e-5 x max|want| of the port's single-device ``Model.loss``; a case
  with uneven ``loss_mask`` rows; MoE routing groups that span data
  positions (granite, both dispatches, a capacity that drops);
- the layouts: every slab holds exactly ``shard_shape``'s elements, for
  the parameters and both moments;
- ``launch/train.py`` over the mesh: a run that fails at step 3 and
  restarts from its checkpoints ends ``torch.equal`` to an uninterrupted
  one; a single-device checkpoint restores into the sharded run and back.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.distributed import FailureInjector, SimulatedFailure
from repro_torch.distributed import mesh as M
from repro_torch.launch import mesh as lm
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import Model
from repro_torch.models import sharding as shd_models
from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference)
from repro_torch.optim import AdamWConfig

from test_torch_train_dense import OPT, STEP0, ref_opt_state

CPU = torch.device("cpu")
REF_TOL = 5e-3      # the reference's own sharded-vs-single bars
GRAD_TOL = 1e-5     # x max|want|: the port sharded vs single at f32
UPDATE_TOL = 1e-2   # x max|Δwant|: a step's update, sharded vs reference
ARCHS = list(registry.ARCHS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module (restored after it): its many
    small ops run ~2x faster so, and ~10x under the suite's parallel
    workers, where the threads of every worker contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(name):
    if name == "4x2":
        return lm.make_host_mesh(2, [CPU] * 8)
    devs = np.empty((2, 2, 2), dtype=object)
    devs[...] = CPU
    return M.Mesh(devs, ("pod", "data", "model"))


def make_batch(cfg, b, s, seed, uneven=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    batch = {k: torch.from_numpy(v.astype(np.int32)) for k, v in
             batch.items()}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    if uneven:
        # row r keeps its first 4 + 7 r tokens: the data positions' means
        # differ, so only sums over counts reduce to the global mean
        keep = torch.arange(s)[None, :] < (4 + 7 * torch.arange(b))[:, None]
        batch["loss_mask"] = keep.to(torch.float32)
    return batch


def sharded(values, cfg, mesh):
    rules = lm.activation_rules(mesh)
    return steps.shard_params(values, shd.param_shardings(
        values, cfg, mesh, rules)), rules


def rel_err(got, want):
    got = got.to(torch.float64)
    want = want.to(torch.float64)
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


# ---------------------------------------------------------------------------
# Against the live reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_step():
    """minitron-4b smoke (seq 64), batch 8: the reference's weights, a
    non-zero AdamW state, the batch, and its jitted single-device step."""
    cfg = ref_registry.smoke("minitron-4b", seq=64)
    model = RefModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    state = ref_opt_state(params)
    batch = {k: v.numpy() for k, v in make_batch(
        registry.smoke("minitron-4b", seq=64), 8, 64, 3).items()}
    step = ref_steps.build_train_step(model, RefAdamWConfig(**OPT))
    new_p, _, stats = jax.jit(step)(
        params, jax.tree.map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    host = functools.partial(jax.tree.map, np.asarray)
    return dict(params=host(params), state=state, batch=batch,
                new_params=host(new_p), loss=float(stats["loss"]))


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2x2"])
def test_sharded_step_matches_reference(mesh_name):
    ref = reference_step()
    cfg = registry.smoke("minitron-4b", seq=64)
    mesh = mesh_of(mesh_name)
    params, rules = sharded(params_from_reference(ref["params"]), cfg, mesh)
    state = opt_state_from_reference(ref["state"])
    opt = {k: {n: M.distribute(t, params[n].sharding)
               for n, t in state[k].items()} for k in ("mu", "nu")}
    opt["step"] = state["step"]
    step = steps.build_train_step(Model(cfg, device="meta"),
                                  AdamWConfig(**OPT), mesh=mesh, rules=rules,
                                  params=params)
    opt, stats = step(opt, {k: torch.from_numpy(v)
                            for k, v in ref["batch"].items()})
    assert int(opt["step"]) == STEP0 + 1
    assert abs(float(stats["loss"]) - ref["loss"]) < REF_TOL
    want = params_from_reference(ref["new_params"])
    worst = max(float((params[n].gather() - w).abs().max())
                for n, w in want.items())
    assert worst < REF_TOL, worst
    # the update itself (~3e-5 a weight, far under REF_TOL): the sharded
    # step's p - p0 against the reference's, max|Δgot - Δwant| = max|got -
    # want| within UPDATE_TOL x max|Δwant|
    p0 = params_from_reference(ref["params"])
    moved = max(float((w - p0[n]).abs().max()) for n, w in want.items())
    assert worst <= UPDATE_TOL * moved, (worst, moved)
    # every slab holds exactly its shard, for the weights and moments
    for n, st in params.items():
        sub = M.shard_shape(st.shape, st.sharding)
        for tree in (params, opt["mu"], opt["nu"]):
            assert all(s.shape == sub for _, s in tree[n].items())


# ---------------------------------------------------------------------------
# Against the port's single-device step, at f32
# ---------------------------------------------------------------------------

def check_grads(cfg, mesh_name="4x2", b=8, s=32, uneven=False):
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, b, s, 5, uneven)
    loss = model.loss(batch)
    loss.backward()
    mesh = mesh_of(mesh_name)
    params, rules = sharded(
        {n: p.detach() for n, p in model.named_parameters()}, cfg, mesh)
    got_loss, grads = steps.lm_value_and_grad(
        Model(cfg, device="meta"), params, batch, mesh, rules)
    assert rel_err(got_loss, loss.detach()) <= GRAD_TOL
    bad = {n: rel_err(grads[n].gather(), p.grad)
           for n, p in model.named_parameters()
           if rel_err(grads[n].gather(), p.grad) > GRAD_TOL}
    assert bad == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_match_single_device(arch):
    check_grads(registry.smoke(arch, seq=32))


def test_sharded_grads_uneven_mask_rows():
    check_grads(registry.smoke("minitron-4b", seq=32), uneven=True)


def spanning_granite(dispatch="gather", remat=False):
    cfg = registry.smoke("granite-moe-3b-a800m", seq=32)
    return dataclasses.replace(cfg, remat=remat, moe=dataclasses.replace(
        cfg.moe, group_size=96, capacity_factor=1.0, dispatch=dispatch))


@pytest.mark.parametrize("dispatch,remat", [
    pytest.param("gather", False, id="gather"),
    pytest.param("einsum", False, id="einsum"),
    pytest.param("gather", True, id="gather-remat")])
def test_sharded_grads_moe_group_spans_positions(dispatch, remat):
    """granite with groups of 96 tokens over positions of 64 (batch 8 x
    seq 32 on 4 positions): groups span positions, the global batch pads
    its last group, and a capacity factor of 1 drops tokens; with remat
    the recomputation reuses the forward's exchange."""
    check_grads(spanning_granite(dispatch, remat))


def test_remat_recomputation_off_the_forward_thread():
    """A CUDA backward runs on autograd's own thread, and with it the
    recomputation of a rematerialised layer: it must see the forward's
    mesh rules and data position, not that thread's (none). Each
    position's forward runs in lockstep under its position; its backward
    then runs from a fresh thread outside them, and its gradients equal
    those of a backward run inside its position."""
    cfg = spanning_granite(remat=True)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    values = {n: p.detach() for n, p in model.named_parameters()}
    batch = make_batch(cfg, 8, 32, 5)
    mesh = mesh_of("4x2")
    rules = lm.activation_rules(mesh)
    denom = steps.lm_denom(batch)

    def grads(later):
        def one(i):
            leaves = {n: t.clone().requires_grad_() for n, t in
                      values.items()}
            loss = model.loss(steps._rows(batch, i, 4, CPU),
                              params=model.compute_params(leaves),
                              denom=denom)
            if not later:
                loss.backward()
            return loss, leaves

        outs = shd_models.run_positions(one, 4, True, mesh, rules)
        if later:
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                for loss, _ in outs:
                    pool.submit(loss.backward).result()
        return [{n: t.grad for n, t in leaves.items()} for _, leaves in outs]

    for got, want in zip(grads(True), grads(False)):
        assert all(torch.equal(got[n], want[n]) for n in want)


@pytest.mark.parametrize("arch", ["minitron-4b", "granite-moe-3b-a800m"])
def test_sharded_grads_pod_data_model(arch):
    check_grads(registry.smoke(arch, seq=32), mesh_name="2x2x2")


# ---------------------------------------------------------------------------
# launch/train.py over the mesh
# ---------------------------------------------------------------------------

RUN = dict(arch="minitron-4b", smoke=True, batch=8, seq=32)


def sharded_run(mesh):
    model, cfg, step, data = T.build(**RUN, device="cpu", mesh=mesh)
    return T.init_state(model, params=step.params), step, data


def test_sharded_restart_equals_uninterrupted(tmp_path):
    mesh = mesh_of("4x2")
    run, step, data = sharded_run(mesh)
    run, losses, _ = T.train_loop(run, step, data, 5, log_every=0)
    ck = CheckpointManager(str(tmp_path))
    run2, step2, data2 = sharded_run(mesh)
    with pytest.raises(SimulatedFailure):
        T.train_loop(run2, step2, data2, 5, ckpt=ck, ckpt_every=2,
                     injector=FailureInjector(at_steps=(3,)), log_every=0,
                     async_ckpt=False)
    run2 = T.restore(ck, run2)
    assert run2.step == 2
    run2, losses2, _ = T.train_loop(run2, step2, data2, 5, log_every=0)
    assert losses2 == losses[2:]
    for k in ("params",):
        for n, st in run.params.items():
            assert torch.equal(st.gather(), run2.params[n].gather()), n
    for k in ("mu", "nu"):
        for n, st in run.opt_state[k].items():
            assert torch.equal(st.gather(), run2.opt_state[k][n].gather())
    assert int(run.opt_state["step"]) == int(run2.opt_state["step"]) == 5


def test_single_device_checkpoint_restores_into_sharded_run(tmp_path):
    model, _, step, data = T.build(**RUN, device="cpu")
    run = T.init_state(model)
    run, _, _ = T.train_loop(run, step, data, 2, log_every=0)
    CheckpointManager(str(tmp_path / "one")).save(2, T.checkpoint_tree(run))
    srun, sstep, sdata = sharded_run(mesh_of("4x2"))
    srun = T.restore(CheckpointManager(str(tmp_path / "one")), srun)
    for n, p in run.params.items():
        assert torch.equal(p.detach(), srun.params[n].gather())
        assert torch.equal(run.opt_state["mu"][n],
                           srun.opt_state["mu"][n].gather())
    # and back: the sharded run's checkpoint into a single-device run
    srun, _, _ = T.train_loop(srun, sstep, sdata, 3, log_every=0)
    CheckpointManager(str(tmp_path / "sh")).save(3, T.checkpoint_tree(srun))
    back = T.restore(CheckpointManager(str(tmp_path / "sh")), run)
    assert back.step == 3
    for n, p in back.params.items():
        assert torch.equal(p.detach(), srun.params[n].gather())


def test_train_main_over_a_mesh(capsys):
    run, losses = T.main(["--smoke", "--device", "cpu", "--mesh", "2x2",
                          "--steps", "2", "--batch", "4", "--seq", "32"])
    assert run.step == 2 and all(np.isfinite(losses))
    assert "mesh={'data': 2, 'model': 2}" in capsys.readouterr().out
