"""The port's training loop and the training-path invariants that need
no reference run, on the CPU:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_loop.py

- at bf16 every parameter of every architecture's smoke config gets a
  finite gradient from ``Model.loss`` (the compute copy stays on the
  autograd graph);
- rematerialisation on and off gives ``torch.equal`` gradients, for the
  layers (a group a pattern period, or a layer, as the reference's
  ``jax.checkpoint``) and for the loss's chunks, and the recomputation
  does happen;
- ``launch/train.py`` (tests/test_fault.py restated): a run that fails at
  step 5 and restarts from its checkpoints ends bit for bit where an
  uninterrupted run ends; the injector, the watchdog, the preemption
  checkpoint; ``main`` on the CPU; no fallback to the CPU without a card.
"""
import dataclasses

import pytest
import torch

import repro_torch.models.layers as layers_mod
import repro_torch.models.model as model_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.distributed import (
    FailureInjector,
    PreemptionHandler,
    SimulatedFailure,
    StragglerWatchdog,
    run_with_restarts,
)
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import Model
from repro_torch.models.layers import lm_loss_chunked
from repro_torch.optim import AdamWConfig

B, S = 2, 32


def smoke_model(arch, seed=0, **changes):
    cfg = dataclasses.replace(registry.smoke(arch, seq=S), **changes)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return Model(cfg, device="cpu").init(gen)


def batch_for(cfg, seed=1):
    """Tokens and labels drawn apart (labels equal to the tokens let a
    tied model's loss and gradients fall to ~0)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn((B, 4, cfg.d_model),
                                            generator=gen)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((B, cfg.encoder.n_frames, cfg.d_model),
                                      generator=gen)
    return batch


def grads_of(model, batch):
    model.zero_grad(set_to_none=True)
    model.loss(batch).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_every_parameter_gets_a_gradient_at_bf16(arch):
    """The compute copy at bf16: before the repair only the float32
    leaves (the norm scales: 5 of stablelm's 20) got a gradient."""
    model = smoke_model(arch, dtype="bfloat16")
    grads = grads_of(model, batch_for(model.cfg))
    missing = [n for n, g in grads.items() if g is None]
    assert missing == []
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.values())
    zero = [n for n, g in grads.items() if g.dim() >= 2 and
            float(g.abs().max()) == 0]
    assert zero == []                        # every weight matrix reached


def count_layer_calls(monkeypatch):
    calls = []
    real = model_mod.layer_forward

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(model_mod, "layer_forward", spy)
    return calls


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_remat_gives_equal_gradients(arch, monkeypatch):
    """remat=True recomputes every period (or layer) but the remainder in
    backward, and the gradients are the same bits as remat=False."""
    calls = count_layer_calls(monkeypatch)
    out = {}
    for remat in (False, True):
        model = smoke_model(arch, remat=remat)
        del calls[:]
        out[remat] = grads_of(model, batch_for(model.cfg))
        n_body = model.cfg.n_periods * len(model.cfg.pattern)
        n_rem = len(model.cfg.remainder_kinds)
        assert len(calls) == (2 * n_body if remat else n_body) + n_rem
    for n, g in out[False].items():
        assert torch.equal(g, out[True][n]), n


def test_layer_groups_follow_the_reference():
    """Scanned periods (scan_layers, more than one period) are one group
    each; otherwise one layer a group; the remainder never rematerialised
    (src/repro/models/model.py's scan body, per-layer checkpoint, rem)."""
    model = smoke_model("recurrentgemma-9b", remat=True)
    cfg = model.cfg
    groups = model._layer_groups(list(model.layers))
    period = len(cfg.pattern)
    assert [len(g) for g, _ in groups] == [period] * cfg.n_periods + [1] * \
        len(cfg.remainder_kinds)
    assert [body for _, body in groups] == [True] * cfg.n_periods + \
        [False] * len(cfg.remainder_kinds)
    assert [k for g, _ in groups for _, k in g] == list(cfg.layer_kinds)
    flat = dataclasses.replace(cfg, scan_layers=False)
    model.cfg = flat
    groups = model._layer_groups(list(model.layers))
    assert [len(g) for g, _ in groups] == [1] * cfg.n_layers
    assert sum(body for _, body in groups) == cfg.n_periods * period


@pytest.mark.parametrize("scan_layers", [True, False])
def test_remat_without_scan_is_per_layer(scan_layers, monkeypatch):
    calls = count_layer_calls(monkeypatch)
    out = {}
    for remat in (False, True):
        model = smoke_model("stablelm-1.6b", remat=remat,
                            scan_layers=scan_layers)
        del calls[:]
        out[remat] = grads_of(model, batch_for(model.cfg))
        assert len(calls) == (2 if remat else 1) * model.cfg.n_layers
    for n, g in out[False].items():
        assert torch.equal(g, out[True][n]), n


@pytest.mark.parametrize("chunk", [8, 12, 32])
def test_loss_chunk_remat_gives_equal_gradients(chunk, monkeypatch):
    """Chunks of 8 (4 full), 12 (2 full + a remainder of 8), 32 (one):
    each chunk's logits recomputed in backward, the same gradients as
    with the checkpoint replaced by a plain call."""
    gen = torch.Generator()
    gen.manual_seed(3)
    x = torch.randn((B, S, 16), generator=gen)
    table = torch.randn((64, 16), generator=gen)
    labels = torch.randint(0, 64, (B, S), generator=gen)
    mask = (torch.rand((B, S), generator=gen) > 0.2).float()
    calls = []
    real = layers_mod.matmul_f32
    monkeypatch.setattr(layers_mod, "matmul_f32",
                        lambda a, b: calls.append(1) or real(a, b))
    real_ckpt = layers_mod.checkpoint
    out = {}
    for remat in (False, True):
        monkeypatch.setattr(layers_mod, "checkpoint", real_ckpt if remat
                            else lambda fn, *args, **kw: fn(*args))
        xs, ts = x.clone().requires_grad_(), table.clone().requires_grad_()
        del calls[:]
        loss = lm_loss_chunked(xs, ts, labels, mask, chunk, z_loss=1e-3)
        loss.backward()
        n_chunks = -(-S // chunk)
        assert len(calls) == (2 if remat else 1) * n_chunks
        out[remat] = (loss.detach(), xs.grad, ts.grad)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_loss_is_forward_only_under_no_grad(monkeypatch):
    """No recomputation without gradients (serving, eval)."""
    calls = count_layer_calls(monkeypatch)
    model = smoke_model("stablelm-1.6b", remat=True)
    with torch.no_grad():
        loss = model.loss(batch_for(model.cfg))
    assert loss.dim() == 0 and not loss.requires_grad
    assert len(calls) == model.cfg.n_layers


# ---------------------------------------------------------------------------
# launch/train.py (tests/test_fault.py restated)
# ---------------------------------------------------------------------------

def setup(batch=4, seq=32, accum=1):
    model, cfg, train_step, data = T.build("stablelm-1.6b", smoke=True,
                                           batch=batch, seq=seq,
                                           device="cpu", accum=accum)
    return model, train_step, data, T.init_state(model)


def snapshot(run):
    return {n: p.detach().clone() for n, p in run.params.items()}


def test_restart_reproduces_uninterrupted_run(tmp_path):
    model, train_step, data, run0 = setup()
    n = 8
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, T.checkpoint_tree(run0))

    def restore():
        return T.restore(mgr, run0, step=None)

    # uninterrupted: from the step-0 checkpoint to step 8
    ref, losses, _ = T.train_loop(T.restore(mgr, run0, 0), train_step, data,
                                  n, log_every=0)
    assert ref.step == n and len(losses) == n
    want = snapshot(ref)
    want_opt = {k: {m: t.clone() for m, t in ref.opt_state[k].items()}
                for k in ("mu", "nu")}
    mgr.wait()

    # failure-injected: checkpoint every 2 steps, die at step 5, restart
    # from step 4 (the live tensors reached step 5: the restore must
    # write every one of them back)
    injector = FailureInjector(at_steps=(5,))
    T.restore(mgr, run0, 0)
    seen = []

    def train(state):
        seen.append(state.step)
        out, _, _ = T.train_loop(state, train_step, data, n, ckpt=mgr,
                                 ckpt_every=2, injector=injector,
                                 log_every=0, async_ckpt=False)
        return out

    final, restarts = run_with_restarts(train, restore)
    assert restarts == 1 and seen == [0, 4] and final.step == n
    assert int(final.opt_state["step"]) == n
    for name, p in final.params.items():
        assert torch.equal(p.detach(), want[name]), name
    for k in ("mu", "nu"):
        for name, t in final.opt_state[k].items():
            assert torch.equal(t, want_opt[k][name]), (k, name)


def test_failure_records_the_step_reached(tmp_path):
    _, train_step, data, run = setup()
    with pytest.raises(SimulatedFailure):
        T.train_loop(run, train_step, data, 6,
                     injector=FailureInjector(at_steps=(3,)), log_every=0)
    assert run.step == 3 and int(run.opt_state["step"]) == 3


def test_injector_fires_once():
    inj = FailureInjector(at_steps=(3,))
    inj.check(2)
    with pytest.raises(SimulatedFailure):
        inj.check(3)
    inj.check(3)  # second pass: already fired


def test_watchdog_flags_straggler():
    wd = StragglerWatchdog(factor=3.0)
    for i in range(8):
        wd.record(i, 0.1)
    assert wd.record(8, 1.0) is True
    assert wd.flagged and wd.flagged[0][0] == 8


def test_preemption_checkpoint(tmp_path):
    model, train_step, data, run = setup()
    mgr = CheckpointManager(str(tmp_path))
    pre = PreemptionHandler(install=False)
    pre.trigger()
    run, losses, _ = T.train_loop(run, train_step, data, 10, ckpt=mgr,
                                  ckpt_every=100, preempt=pre, log_every=0)
    # stopped after one step and wrote a final checkpoint of that step
    assert run.step == 1 and len(losses) == 1
    assert mgr.latest_step() == 1
    tree, step = mgr.restore(T.checkpoint_tree(run))
    assert step == 1 and int(tree["opt"]["step"]) == 1
    for name, p in run.params.items():
        assert torch.equal(tree["params"][name], p.detach())


def test_loss_falls_on_the_token_stream():
    """The stream is learnable: 40 steps at lr 3e-3 bring the mean of the
    last 5 losses under the mean of the first 5."""
    model, cfg, _, data = T.build("stablelm-1.6b", smoke=True, batch=8,
                                  seq=32, device="cpu")
    step = steps.build_train_step(model, AdamWConfig(
        lr_peak=3e-3, warmup_steps=5, decay_steps=100))
    run = T.init_state(model)
    _, losses, _ = T.train_loop(run, step, data, 40, log_every=0)
    assert all(l == l for l in losses)              # finite, not NaN
    assert sum(losses[-5:]) < sum(losses[:5])


def test_accumulation_through_build(tmp_path):
    _, train_step, data, run = setup(accum=2)
    run, losses, _ = T.train_loop(run, train_step, data, 2, log_every=0)
    assert run.step == 2 and len(losses) == 2


def test_main_trains_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    run, losses = T.main(["--smoke", "--steps", "3", "--device", "cpu",
                          "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
                          "--ckpt-every", "2"])
    assert run.step == 3 and len(losses) == 3
    assert CheckpointManager(ckpt).all_steps() == [2]
    run, losses = T.main(["--smoke", "--steps", "4", "--device", "cpu",
                          "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
                          "--resume"])
    assert run.step == 4 and len(losses) == 2
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "done: step=4" in out


def test_no_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build("stablelm-1.6b", smoke=True, batch=2, seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--smoke", "--steps", "1"])
    assert T.parse_args([]).smoke is False        # the reference's default
    assert T.parse_args(["--no-smoke"]).smoke is False
