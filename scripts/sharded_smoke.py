#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 24 alone on the card: the LM stack over a
mesh of slabs of the one card (stablelm-1.6b's sharded train step at full
width and depth against one device, two layers at f32 on (4, 2) and
(2, 2, 2), gemma3-12b's sequence-parallel decode and stablelm's
``generate`` under (4, 1), the FFTConvMixer's sharded AdamW step).

    python3 scripts/sharded_smoke.py [--parts full,f32,serve,mixer]

Builds only ``csrc/spectral.cu`` when the mixer part runs (the one kernel
the phase launches), prints the card's name and power limit, each part's
lines (a part that fails prints its traceback and the others still run)
and a ``kernels`` line of the mixer's record; exits 0 when every check
passed.
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

PARTS = ("full", "f32", "serve", "mixer")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sharded_smoke: no CUDA device", file=sys.stderr)
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
    runs = {"full": lambda: chip_smoke.sharded_full(torch, smi_line, dev),
            "f32": lambda: chip_smoke.sharded_f32(torch, smi_line, dev),
            "serve": lambda: chip_smoke.sharded_serve(torch, smi_line, dev),
            "mixer": lambda: chip_smoke.sharded_mixer(torch, smi_line, dev)}
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
