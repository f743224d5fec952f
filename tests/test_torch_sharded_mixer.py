"""The FFTConvMixer's sharded AdamW step on a (4, 2) mesh of CPU slabs,
through the spectral op's plain version (its kernel runs only on the
card: ``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 24), against
its single-device step:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_mixer.py

Each data position runs the mixer on its rows (one spectral op call a
position); the loss, the gradients and the step's new weights and moments
are within 1e-5 x max|want| of the single-device ones.
"""
import torch

from repro_torch.distributed import mesh as M
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lm
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import fftconv
from repro_torch.optim import AdamWConfig, adamw

CPU = torch.device("cpu")
TOL = 1e-5
D, B, S = 16, 4, 64


def share(local, leaves, denom):
    """A position's share of mean((mixer(x) - y)^2) over the global batch."""
    y = fftconv.fftconv_forward(leaves, local["x"])
    return ((y - local["y"]) ** 2).sum() / denom


def rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def test_sharded_mixer_step_matches_single_device(monkeypatch):
    gen = torch.Generator().manual_seed(24)
    mixer = fftconv.init_fftconv(gen, D, S)
    data = {"x": torch.randn((B, S, D), generator=gen),
            "y": 0.1 * torch.randn((B, S, D), generator=gen)}
    values = {n: p.detach().clone() for n, p in mixer.named_parameters()}
    mesh = lm.make_host_mesh(2, [CPU] * 8)
    rules = lm.activation_rules(mesh)
    params = steps.shard_params(values, shd.param_shardings(
        values, None, mesh, rules))
    assert tuple(params["in_proj"].spec) == ("data", "model")

    calls = []
    op = ops.spectral_op
    monkeypatch.setattr(ops, "spectral_op",
                        lambda *a, **k: calls.append(1) or op(*a, **k))
    denom = torch.tensor(float(B * S * D))
    loss, grads = steps.sharded_value_and_grad(share, params, data, mesh,
                                               rules, denom)
    assert len(calls) == 4              # one a data position
    want_loss = torch.mean((mixer(data["x"]) - data["y"]) ** 2)
    want = torch.autograd.grad(want_loss, list(mixer.parameters()))
    assert rel_err(loss, want_loss.detach()) <= TOL
    for (n, _), w in zip(mixer.named_parameters(), want):
        assert rel_err(grads[n].gather(), w) <= TOL, n

    # one AdamW step from non-zero moments, both ways
    gen = torch.Generator().manual_seed(7)
    mu = {n: 1e-3 * torch.randn(v.shape, generator=gen)
          for n, v in values.items()}
    nu = {n: m * m + 1e-6 for n, m in mu.items()}
    opt = AdamWConfig(warmup_steps=0)
    single = adamw.make_train_step(
        lambda b: torch.mean((mixer(b["x"]) - b["y"]) ** 2),
        dict(mixer.named_parameters()), opt)
    state, stats = single({"mu": {n: t.clone() for n, t in mu.items()},
                           "nu": {n: t.clone() for n, t in nu.items()},
                           "step": torch.tensor(3, dtype=torch.int32)}, data)
    sstate = {"mu": {n: M.distribute(t, params[n].sharding)
                     for n, t in mu.items()},
              "nu": {n: M.distribute(t, params[n].sharding)
                     for n, t in nu.items()},
              "step": torch.tensor(3, dtype=torch.int32)}
    step = steps.make_sharded_train_step(
        share, params, opt, mesh, rules,
        denom_fn=lambda b: torch.tensor(float(b["x"].numel())))
    sstate, sstats = step(sstate, data)
    assert rel_err(sstats["grad_norm"], stats["grad_norm"]) <= TOL
    for n, p in mixer.named_parameters():
        assert rel_err(params[n].gather(), p.detach()) <= TOL, n
        assert rel_err(sstate["mu"][n].gather(), state["mu"][n]) <= TOL
        assert rel_err(sstate["nu"][n].gather(), state["nu"][n]) <= TOL
