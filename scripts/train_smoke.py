#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 23 alone on the card: the LM stack's
training path (stablelm-1.6b trained at full width and depth, the card
against the CPU, restart == uninterrupted in a child process, one train
step of every other architecture, the FFTConvMixer's AdamW step).

    python3 scripts/train_smoke.py [--parts full,cpu,restart,sweep,mixer]
    python3 scripts/train_smoke.py --parts profile

``profile`` (not among the defaults) traces 3 steps of stablelm-1.6b at
full width and depth (batch 8, seq 128, after 3 warm-up steps) with
``torch.profiler`` and prints the device's busy time a step against the
step's wall time (CUDA events; the profiler's own cost included) and
the kernels that take the most device time.

Builds only ``csrc/spectral.cu`` when the mixer part runs and the library
is stale (the one kernel the phase launches), prints the card's name and
power limit, each part's lines (a part that fails prints its traceback
and the others still run) and a ``kernels`` line of the mixer's record;
exits 0 when every check passed.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

PARTS = ("full", "cpu", "restart", "sweep", "mixer")
PROFILE_STEPS = 3


def device_ms(evt):
    """An event's own device time in ms (the attribute's name moved
    between torch versions)."""
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def profile(torch, smi_line, dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace
    from repro_torch.launch import train as T
    b, s = chip_smoke.TRAIN["batch"], chip_smoke.TRAIN["seq"]
    model, cfg, step_fn, data = T.build(chip_smoke.TRAIN_ARCH, False, b, s,
                                        device=dev)
    run = T.init_state(model)
    state = run.opt_state
    for i in range(3):
        state, stats = step_fn(state, data.batch(i))
        float(stats["loss"])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(3, 3 + PROFILE_STEPS):
            state, stats = step_fn(state, data.batch(i))
            float(stats["loss"])
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / PROFILE_STEPS
    # the device's own rows (kernels, copies): an operator's row carries
    # its kernels' time too, and counting both would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_ms(e) > 0]
    busy = sum(device_ms(e) for e in events) / PROFILE_STEPS
    top = sorted(events, key=device_ms, reverse=True)[:15]
    chip_smoke.emit(
        "train_profile", nvidia_smi=smi_line, arch=cfg.name, batch=b, seq=s,
        steps=PROFILE_STEPS, step_wall_ms=wall, device_busy_ms=busy,
        idle_share=1 - busy / wall,
        top=[{"name": e.key[:120], "ms_per_step": device_ms(e)
              / PROFILE_STEPS, "calls_per_step": e.count / PROFILE_STEPS}
             for e in top])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    chip_smoke.emit("device", nvidia_smi=smi_line, torch=torch.__version__,
                    cuda=torch.version.cuda)
    parts = args.parts.split(",")
    if "mixer" in parts:
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all(names=("spectral",))
        chip_smoke.emit("build", seconds=time.perf_counter() - t0,
                        source_seconds=_build.BUILD_SECONDS)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    runs = {"full": lambda: chip_smoke.train_full(torch, smi_line, dev),
            "cpu": lambda: chip_smoke.train_vs_cpu(torch, smi_line, dev),
            "restart": lambda: chip_smoke.train_restart(
                torch, smi_line, chip_smoke.start_restart(torch)),
            "sweep": lambda: chip_smoke.train_sweep(torch, smi_line, dev),
            "mixer": lambda: chip_smoke.mixer_train(torch, smi_line, dev),
            "profile": lambda: profile(torch, smi_line, dev)}
    records, failed = [], []
    for part in parts:
        t0 = time.perf_counter()
        try:
            out = runs[part]()
        except Exception:          # report it, run the other parts
            traceback.print_exc()
            failed.append(part)
            out = None
        chip_smoke.emit("part", name=part, ok=part not in failed,
                        seconds=time.perf_counter() - t0)
        records += out or []
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": records, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
