"""Training: config -> model on one device -> fault-tolerant loop
(the port's counterpart of ``repro.launch.train``).

Integrates every substrate: the deterministic data stream (exact resume),
AdamW, the checkpoint manager (async, keep-k, atomic), the preemption
handler, the straggler watchdog and failure injection for tests. The
parameters live in the ``Model`` and the train step updates them and the
optimizer's moments in place; a restore writes every one of them back.

On one device: the reference's mesh, activation rules and parameter
shardings (``launch/mesh.py``, ``launch/sharding.py``) wait for the
multi-device launch slice.

Usage (the CUDA card unless ``--device`` names another):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import DataConfig, TokenStream
from repro_torch.distributed import (
    FailureInjector,
    PreemptionHandler,
    SimulatedFailure,
    StragglerWatchdog,
)
from repro_torch.launch import steps as steps_mod
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw


@dataclasses.dataclass
class TrainRun:
    """Everything a (re)start needs: the live parameters (``{name:
    Parameter}``, the model's own), the optimizer state and the steps
    taken."""
    params: dict
    opt_state: dict
    step: int


def build(arch: str, smoke: bool, batch: int, seq: int, device=None,
          opt_cfg: Optional[AdamWConfig] = None, accum: int = 1):
    """The model of ``arch`` (its weights allocated, not drawn), its train
    step and the token stream, on ``device`` (None: the CUDA card, raising
    without one). The reference's ``mesh`` argument, activation rules and
    parameter shardings are left out until the multi-device launch slice.
    Returns (model, cfg, train_step, data)."""
    cfg = registry.smoke(arch, seq=seq) if smoke else registry.get(arch)
    model = Model(cfg, device=device)
    opt_cfg = opt_cfg or AdamWConfig(warmup_steps=10, decay_steps=1000)
    train_step = steps_mod.build_train_step(model, opt_cfg, accum)
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch), device=model.device)
    return model, cfg, train_step, data


def init_state(model: Model, seed: int = 0) -> TrainRun:
    """Draw the weights from ``seed`` on the model's device; zero AdamW
    state."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    model.init(gen)
    params = dict(model.named_parameters())
    return TrainRun(params, adamw.init(params), 0)


def checkpoint_tree(run: TrainRun) -> dict:
    return {"params": run.params, "opt": run.opt_state}


def restore(ckpt: CheckpointManager, run: TrainRun,
            step: Optional[int] = None) -> TrainRun:
    """Write checkpoint ``step`` (the latest when None) into ``run``'s
    live tensors — every parameter, ``mu``, ``nu`` and the optimizer's
    step — and set ``run.step``. A failed run has updated them in place;
    a stale optimizer step would shift the lr schedule. The checkpoint is
    read to host memory first, so the card never holds two copies."""
    tree, step = ckpt.restore(checkpoint_tree(run), step, device="cpu")
    with torch.no_grad():
        for name, p in run.params.items():
            p.copy_(tree["params"][name])
        for k in ("mu", "nu"):
            for name, t in run.opt_state[k].items():
                t.copy_(tree["opt"][k][name])
        run.opt_state["step"] = tree["opt"]["step"].to(
            run.opt_state["step"].device)
    run.step = step
    return run


def train_loop(run: TrainRun, train_step: Callable, data: TokenStream,
               n_steps: int, ckpt: Optional[CheckpointManager] = None,
               ckpt_every: int = 50,
               injector: Optional[FailureInjector] = None,
               preempt: Optional[PreemptionHandler] = None,
               log_every: int = 10, async_ckpt: bool = True):
    """Returns (run, losses, watchdog). Raises SimulatedFailure through to
    the restart policy (distributed.run_with_restarts), with ``run.step``
    the steps reached."""
    watchdog = StragglerWatchdog()
    losses = []
    opt_state = run.opt_state
    step = run.step
    try:
        while step < n_steps:
            t0 = time.time()
            if injector is not None:
                injector.check(step)
            batch = data.batch(step)
            opt_state, stats = train_step(opt_state, batch)
            loss = float(stats["loss"])
            losses.append(loss)
            step += 1
            dt = time.time() - t0
            if watchdog.record(step, dt):
                print(f"[watchdog] step {step} straggled: {dt:.2f}s")
            if log_every and step % log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"gnorm={float(stats['grad_norm']):.3f} "
                      f"lr={float(stats['lr']):.2e} ({dt:.2f}s)", flush=True)
            if ckpt is not None and step % ckpt_every == 0:
                ckpt.save(step, {"params": run.params, "opt": opt_state},
                          blocking=not async_ckpt)
            if preempt is not None and preempt.should_stop:
                if ckpt is not None:
                    ckpt.save(step, {"params": run.params, "opt": opt_state},
                              blocking=True)
                break
    except SimulatedFailure:
        run.opt_state, run.step = opt_state, step
        raise
    if ckpt is not None:
        ckpt.wait()
    run.opt_state, run.step = opt_state, step
    return run, losses, watchdog


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when not given")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns (run, losses)."""
    args = parse_args(argv)
    model, cfg, train_step, data = build(
        args.arch, args.smoke, args.batch, args.seq, device=args.device,
        accum=args.accum)
    print(f"arch={cfg.name} params~{cfg.param_count():,} "
          f"device={model.device}")
    run = init_state(model)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        run = restore(ckpt, run)
        print(f"resumed from step {run.step}")
    preempt = PreemptionHandler()
    run, losses, wd = train_loop(run, train_step, data, args.steps, ckpt,
                                 args.ckpt_every, preempt=preempt)
    first_last = (f"[{losses[0]:.3f}, {losses[-1]:.3f}]" if losses
                  else "[]")
    print(f"done: step={run.step} loss[first,last]={first_last} "
          f"stragglers={len(wd.flagged)}")
    return run, losses


if __name__ == "__main__":
    main()
