"""The port's LM training path against the live JAX reference, on the
CPU: the dense architectures (the others are in
tests/test_torch_train_mixers.py, test_torch_train_local.py and
test_torch_train_moe.py, which use this file's helpers):

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_dense.py

Each architecture at ``registry.smoke(arch, seq=64)``, float32, with
``remat=True`` on both sides and the reference's ``Model.init(PRNGKey(0))``
parameters carried across by ``models.convert.params_from_reference``;
the labels are drawn apart from the tokens (labels equal to the tokens
drive a tied model's loss to ~0 and its gradients with it). Every
parameter's ``.grad`` from ``Model.loss(...).backward()`` within 1e-4 x
max|want| of ``jax.grad`` of the reference's loss (plus a float32 floor
of 1e-6 x the whole tree's largest, ``GRAD_FLOOR``); one
``steps.build_train_step`` step from the same AdamW state (non-zero
moments, carried by ``opt_state_from_reference``) against the
reference's: the loss, the gradient norm, every new weight and moment
within the same bar.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as ref_steps
from repro.models import Model as RefModel
from repro.optim import AdamWConfig as RefAdamWConfig
from repro_torch.launch import steps
from repro_torch.models import Model
from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference)
from repro_torch.optim import AdamWConfig

from test_torch_models_dense import (
    TOL, make_batch, on_torch, smoke_cfgs)

ARCHS = ["stablelm-1.6b", "minitron-4b", "yi-34b", "qwen2-vl-72b"]
OPT = dict(warmup_steps=10, decay_steps=100)
STEP0 = 4           # the AdamW state's steps taken


def ref_opt_state(params):
    """Non-zero moments (numpy, in the tree's leaf order) and STEP0, with
    nu >= mu^2 as AdamW's own moments keep it (a moment pair with
    |mu| >> sqrt(nu) makes the update ill-conditioned: a rounding of g
    then moves a weight by lr x |mu| / sqrt(nu))."""
    rng = np.random.default_rng(11)
    mu = jax.tree.map(lambda p: 1e-3 * rng.standard_normal(p.shape).astype(
        np.float32), params)
    nu = jax.tree.map(lambda m: m * m + 1e-6 * np.square(
        rng.standard_normal(m.shape)).astype(np.float32), mu)
    return {"mu": mu, "nu": nu, "step": np.int32(STEP0)}


def train_cfgs(arch, moe=(), **changes):
    """The reference's and the port's smoke config of ``arch`` with
    ``remat=True``; ``moe``: (field, value) pairs for each package's own
    MoE config."""
    ref_cfg, cfg = smoke_cfgs(arch, remat=True, **changes)
    if moe:
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **dict(moe)))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **dict(moe)))
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def reference(arch, accum=1, with_step=True, **changes):
    """The reference's gradients and one train step on one smoke
    architecture, in one jitted call: its parameters, the batch, the
    loss and gradients of ``Model.loss``, and (``with_step``)
    ``build_train_step``'s new parameters, state and stats (all numpy)."""
    cfg, _ = train_cfgs(arch, **changes)
    model = RefModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    batch = make_batch(cfg, len(arch))
    state = ref_opt_state(params)
    train_step = ref_steps.build_train_step(
        model, RefAdamWConfig(**OPT), accum)

    def f(p, st, b):
        loss, grads = jax.value_and_grad(model.loss)(p, b)
        return loss, grads, train_step(p, st, b) if with_step else None

    loss, grads, step = jax.jit(f)(
        params, jax.tree.map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    host = functools.partial(jax.tree.map, np.asarray)
    out = dict(params=host(params), batch=batch, state=state,
               loss=float(loss), grads=host(grads))
    if with_step:
        out.update(zip(("new_params", "new_state", "stats"), host(step)))
    return out


def port(arch, ref, **changes):
    _, cfg = train_cfgs(arch, **changes)
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(ref["params"]))
    return model


def close(got, want, tol, floor=0.0):
    """max|got - want| <= tol x max|want| + floor."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) <= (
        tol * float(np.abs(want).max()) + floor)


# The gradients' float32 floor, x the largest |want| of the whole tree: a
# gradient that is analytically zero on some path is rounding noise on
# both sides there. llama4's top-1 gate topv / sum(topv) is identically 1,
# so its router gets the main loss's gradient as pure noise (2.8e-8, where
# the aux loss gives it 1.8e-4 and the tree's largest is 0.82: 1.5e-4 x
# its own max, 3.4e-8 x the tree's; measured).
GRAD_FLOOR = 1e-6


def check_grads(arch, tol=TOL, with_step=True, **changes):
    ref = reference(arch, 1, with_step, **changes)   # one cache key
    model = port(arch, ref, **changes)
    loss = model.loss(on_torch(ref["batch"]))
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert loss.requires_grad
    loss.backward()
    assert close(loss.detach(), ref["loss"], tol)
    want = params_from_reference(ref["grads"])
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not close(p.grad, want[n], tol, floor)]
    assert bad == []


def check_train_step(arch, accum=1, tol=TOL, **changes):
    ref = reference(arch, accum, True, **changes)
    model = port(arch, ref, **changes)
    train_step = steps.build_train_step(model, AdamWConfig(**OPT), accum)
    state, stats = train_step(opt_state_from_reference(ref["state"]),
                              on_torch(ref["batch"]))
    assert int(state["step"]) == STEP0 + 1
    for k in ("loss", "grad_norm"):
        assert close(stats[k], ref["stats"][k], tol)
    assert close(stats["lr"], ref["stats"]["lr"], 1e-7)
    want_p = params_from_reference(ref["new_params"])
    want_s = opt_state_from_reference(ref["new_state"])
    bad = [n for n, p in model.named_parameters()
           if not (close(p.detach(), want_p[n], tol)
                   and close(state["mu"][n], want_s["mu"][n], tol)
                   and close(state["nu"][n], want_s["nu"][n], tol))]
    assert bad == []


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


def test_query_chunk_grads_match_reference():
    """Attention over query chunks (24 of 64 positions a chunk, with a
    remainder): the gradients through the concatenated chunks."""
    check_grads("stablelm-1.6b", with_step=False, attn_q_chunk=24)


def test_loss_chunk_remainder_grads_match_reference():
    """loss_chunk 24 of 64 positions: two full chunks, then the remainder
    of 16, each rematerialised."""
    check_grads("minitron-4b", with_step=False, loss_chunk=24)


# bf16 compute: the gradients round to bf16 at every matmul on both
# sides, in different orders of accumulation (XLA's and torch's CPU
# kernels), compounding over the layers and the backward; measured
# 1.35e-2 x max|want| (layers.1.mixer.wq) on this config, under the
# forward's bar (tests/test_torch_models_local.py)
BF16_TOL = 2e-2


def test_bf16_stablelm_grads_match_reference():
    check_grads("stablelm-1.6b", tol=BF16_TOL, with_step=False,
                dtype="bfloat16")
