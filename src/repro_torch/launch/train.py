"""Training: config -> model on one device or a mesh -> fault-tolerant
loop (the port's counterpart of ``repro.launch.train``).

Integrates every substrate: the deterministic data stream (exact resume),
AdamW, the checkpoint manager (async, keep-k, atomic), the preemption
handler, the straggler watchdog and failure injection for tests. The
parameters live in the ``Model`` and the train step updates them and the
optimizer's moments in place; a restore writes every one of them back.

Over a mesh (``build(..., mesh=...)``): the parameters and AdamW's
moments are ``ShardedTensor``s laid out by ``launch/sharding.py``'s
``param_shardings`` under ``launch/mesh.py``'s ``activation_rules``, and
the step is ``launch/steps.py``'s sharded one. Checkpoints hold the
gathered, layout-free leaves, as the reference's do: a single-device
checkpoint restores into a sharded run and back.

Usage (the CUDA card unless ``--device`` names another):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --mesh 4x2     # a (data, model) mesh of 8 slabs of that device
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
from repro_torch.distributed.mesh import ShardedTensor, sharded_empty
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import activation_rules, make_host_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw


@dataclasses.dataclass
class TrainRun:
    """Everything a (re)start needs: the live parameters (``{name:
    Parameter}``, the model's own; over a mesh ``{name:
    ShardedTensor}``), the optimizer state and the steps taken."""
    params: dict
    opt_state: dict
    step: int


def build(arch: str, smoke: bool, batch: int, seq: int, device=None,
          opt_cfg: Optional[AdamWConfig] = None, accum: int = 1,
          mesh=None):
    """The model of ``arch`` (its weights allocated, not drawn), its train
    step and the token stream, on ``device`` (None: the CUDA card, raising
    without one). Returns (model, cfg, train_step, data).

    Over ``mesh``: ``model`` is the structure alone (on ``"meta"``), the
    weights are allocated slab by slab in ``param_shardings``' layout
    (``activation_rules(mesh)``) and the train step is the sharded one;
    its ``params`` attribute holds the weights (``{name:
    ShardedTensor}``). The stream's batches come to the mesh's first
    device."""
    cfg = registry.smoke(arch, seq=seq) if smoke else registry.get(arch)
    opt_cfg = opt_cfg or AdamWConfig(warmup_steps=10, decay_steps=1000)
    if mesh is None:
        model = Model(cfg, device=device)
        train_step = steps_mod.build_train_step(model, opt_cfg, accum)
        first = model.device
    else:
        model = Model(cfg, device="meta")
        rules = activation_rules(mesh)
        shapes = dict(model.named_parameters())
        shardings = shd.param_shardings(shapes, cfg, mesh, rules)
        params = {n: sharded_empty(t.shape, shardings[n])
                  for n, t in shapes.items()}
        train_step = steps_mod.build_train_step(
            model, opt_cfg, accum, mesh=mesh, rules=rules, params=params)
        train_step.params = params
        first = mesh.devices.flat[0]
    data = TokenStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch), device=first)
    return model, cfg, train_step, data


def init_state(model: Model, seed: int = 0,
               params: Optional[dict] = None) -> TrainRun:
    """Draw the weights from ``seed`` on the model's device; zero AdamW
    state. ``params`` (``{name: ShardedTensor}``, a sharded build's
    ``train_step.params``): draw the same weights as a whole model on the
    mesh's first device, write each into its slabs, then free the model;
    zero moments in the same layouts."""
    if params is None:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        model.init(gen)
        params = dict(model.named_parameters())
        return TrainRun(params, adamw.init(params), 0)
    first = next(iter(params.values())).slabs.flat[0].device
    full = Model(model.cfg, device=first)
    gen = torch.Generator(device=first)
    gen.manual_seed(seed)
    full.init(gen)
    with torch.no_grad():
        for name, p in full.named_parameters():
            params[name].write(p)
    del full
    return TrainRun(params, steps_mod.init_sharded_opt(params), 0)


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

    def put(live, value):
        if isinstance(live, ShardedTensor):
            live.write(value)
        else:
            live.copy_(value)

    with torch.no_grad():
        for name, p in run.params.items():
            put(p, tree["params"][name])
        for k in ("mu", "nu"):
            for name, t in run.opt_state[k].items():
                put(t, tree["opt"][k][name])
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
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: train over a mesh of that many slabs "
                    "of the device")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns (run, losses)."""
    args = parse_args(argv)
    mesh = None
    if args.mesh:
        data_n, model_n = (int(v) for v in args.mesh.split("x"))
        dev = args.device if args.device is not None else (
            make_host_mesh().devices.flat[0])
        mesh = make_host_mesh(model_n, [dev] * (data_n * model_n))
    model, cfg, train_step, data = build(
        args.arch, args.smoke, args.batch, args.seq, device=args.device,
        accum=args.accum, mesh=mesh)
    where = f"mesh={mesh.shape}" if mesh is not None else \
        f"device={model.device}"
    print(f"arch={cfg.name} params~{cfg.param_count():,} {where}")
    run = init_state(model, params=getattr(train_step, "params", None))
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
