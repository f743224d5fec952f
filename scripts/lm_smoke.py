#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 22 alone on the card: ``core.fusion``, the
FFTConvMixer at stablelm-1.6b's width and the LM serving path
(stablelm-1.6b at full depth, every other architecture one period deep).

    python3 scripts/lm_smoke.py [--parts fusion,mixer,serve,sweep]

Builds only ``csrc/spectral.cu`` when it is stale (the one kernel the
phase runs), prints the card's name and power limit, each part's lines
(a part that fails prints its traceback and the others still run) and a
``kernels`` line of the mixer's records; exits 0 when every check passed.
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

PARTS = ("fusion", "mixer", "serve", "sweep")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    chip_smoke.emit("device", nvidia_smi=smi_line, torch=torch.__version__,
                    cuda=torch.version.cuda)
    t0 = time.perf_counter()
    _build.build_all(names=("spectral",))
    chip_smoke.emit("build", seconds=time.perf_counter() - t0,
                    source_seconds=_build.BUILD_SECONDS)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    runs = {"fusion": lambda: chip_smoke.fusion_phase(torch, smi_line, dev),
            "mixer": lambda: chip_smoke.mixer_phase(torch, smi_line, dev),
            "serve": lambda: chip_smoke.serve_phase(torch, smi_line, dev),
            "sweep": lambda: chip_smoke.arch_sweep(torch, smi_line, dev)}
    records, failed = [], []
    for part in args.parts.split(","):
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
