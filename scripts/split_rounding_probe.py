#!/usr/bin/env python3
"""How a bf16 step's rounding moves when its sums are split over ranks,
and where a split step's time goes, on the card (stablelm-1.6b at full
width, bf16):

    python3 scripts/split_rounding_probe.py [--layers 6]

Prints one JSON line each:

- ``gemm``: whether a bf16 product's column and row slices equal the
  slices of the whole product bit for bit, and the share of elements of
  a product summed as two float32 halves of its contraction (as a row-
  parallel product's two ranks sum it) that round to the whole
  product's bf16;
- ``drift``: ``--layers`` layers, batch 8, seq 128: each layer's output
  on one device against the same layer split over (1, 2) and (1, 4)
  ranks, and over (1, 2) with the row-parallel partial sums rounded to
  bf16 before their reduction (``chip_smoke.partial_sums_in_bf16``):
  share of elements unequal, max |difference| / max |want|;
- ``profile``: one AdamW step at full depth on one device and split over
  (4, 2) ranks under ``torch.profiler``: the step's host time, the CUDA
  kernels it launched, the time the card ran them (the union of their
  intervals) and the card's idle share of the step.

Needs one CUDA card; exits 2 without one.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def gemm_slices(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for m, k, n in ((1024, 2048, 2048), (1024, 2048, 5632),
                    (256, 2048, 2048)):
        x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        w = torch.randn(k, n, device=dev, generator=gen).bfloat16()
        whole = x @ w
        o = torch.randn(m, n, device=dev, generator=gen).bfloat16()
        wo = torch.randn(n, k, device=dev, generator=gen).bfloat16()
        h = n // 2
        halves = (torch.mm(o[:, :h], wo[:h], out_dtype=torch.float32)
                  + torch.mm(o[:, h:], wo[h:], out_dtype=torch.float32))
        chip_smoke.emit(
            "gemm", shape=[m, k, n],
            columns_equal=bool(torch.equal(whole[:, :n // 4],
                                           x @ w[:, :n // 4])),
            rows_equal=bool(torch.equal(whole[:m // 4], x[:m // 4] @ w)),
            halves_round_equal_share=float(
                (halves.bfloat16() == o @ wo).float().mean()))


def drift(torch, dev, layers):
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.models import model as model_mod
    from repro_torch.models.sharding import current_rank
    cfg = dataclasses.replace(registry.get(chip_smoke.SHARD_ARCH),
                              n_layers=layers, remat=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    batch = TokenStream(DataConfig(cfg.vocab_size, 128, 8, seed=24),
                        dev).batch(0)
    seen = {}
    layer_forward = model_mod.layer_forward

    def recorded(*args, **kw):
        out = layer_forward(*args, **kw)
        rank = current_rank()
        seen.setdefault(None if rank is None else rank.index,
                        []).append(out[0].detach().clone())
        return out

    model_mod.layer_forward = recorded
    try:
        with torch.no_grad():
            model.loss(batch)
        want = seen.pop(None)
        for shape, patches in (((1, 2), []), ((1, 4), []), (
                (1, 2), chip_smoke.partial_sums_in_bf16(torch))):
            seen.clear()
            mesh = chip_smoke.slab_mesh(torch, dev, shape)
            params, rules = chip_smoke.shard_values(
                {n: p.detach() for n, p in model.named_parameters()}, cfg,
                mesh)
            with chip_smoke.patched(patches):
                steps.lm_value_and_grad(Model(cfg, device="meta"), params,
                                        batch, mesh, rules)
            rows = []
            for i, w in enumerate(want):
                got = torch.cat([seen[r][i] for r in range(shape[1])], 1)
                rows.append([float((got != w).float().mean()),
                             chip_smoke.rel_to(got.float(), w.float())])
            chip_smoke.emit("drift", mesh=shape, layers=layers,
                            partial_sums_bf16=bool(patches),
                            unequal_share_and_rel_err=rows)
    finally:
        model_mod.layer_forward = layer_forward


def profile(torch, dev):
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as traced
    cfg = registry.get(chip_smoke.SHARD_ARCH)
    batch = TokenStream(DataConfig(cfg.vocab_size, 128, 8, seed=24),
                        dev).batch(0)
    opt = AdamWConfig(warmup_steps=10, decay_steps=1000)
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    model = Model(cfg, device=dev).init(gen)
    values = {n: p.detach().clone() for n, p in model.named_parameters()}
    one = steps.build_train_step(model, opt)
    state = {"mu": {n: torch.zeros_like(t) for n, t in values.items()},
             "nu": {n: torch.zeros_like(t) for n, t in values.items()},
             "step": torch.tensor(0, dtype=torch.int32, device=dev)}
    mesh = chip_smoke.slab_mesh(torch, dev, (4, 2))
    params, rules = chip_smoke.shard_values(values, cfg, mesh)
    del values
    split = steps.build_train_step(Model(cfg, device="meta"), opt,
                                   mesh=mesh, rules=rules, params=params)
    opt_state = {k: {n: M.sharded_zeros(st.shape, st.sharding)
                     for n, st in params.items()} for k in ("mu", "nu")}
    opt_state["step"] = torch.tensor(0, dtype=torch.int32, device=dev)
    for name, step, st in (("one_device", one, state),
                           ("split_4x2", split, opt_state)):
        step(st, batch)                      # warm
        torch.cuda.synchronize()
        with traced(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(st, batch)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kernels)
        busy, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        busy_ms = busy / 1e3
        chip_smoke.emit("profile", step=name, arch=cfg.name,
                        dtype=cfg.dtype, batch=8, seq=128,
                        host_ms=host_ms, kernels=len(kernels),
                        device_busy_ms=busy_ms if kernels else None,
                        idle_share=(1 - busy_ms / host_ms) if kernels
                        else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("split_rounding_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gemm_slices(torch, dev)
    drift(torch, dev, args.layers)
    profile(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
