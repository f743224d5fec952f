#!/usr/bin/env python3
"""``chip_smoke.py``'s residency cut (phase 20.0) and phase 21 alone on the
card: ``mega_resident`` past one block (the sweep of its shapes and forms
on both routes, then the timed batches).

    python3 scripts/resident_long_smoke.py [--no-times]

Builds the kernels that are stale (``-Xptxas -v``; a forced build is
``chip_smoke.py``'s), prints the card's name and power limit, the ptxas
report of the libraries it built, the phases' lines and a ``kernels`` line
of phase 21's records (none with ``--no-times``, which skips 21.2); exits
0 when every check passed.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("resident_long_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    ptxas = {}
    for log in logs.values():
        ptxas.update(chip_smoke.ptxas_report(log))
    chip_smoke.emit("build", seconds=time.perf_counter() - t0,
                    source_seconds=_build.BUILD_SECONDS, ptxas=ptxas)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune_cache.json")
        t0 = time.perf_counter()
        chip_smoke.long_form_cut(torch)
        if "--no-times" in sys.argv[1:]:
            dev = torch.device("cuda", 0)
            for i, fft_impl in enumerate(ops.FFT_IMPLS):
                chip_smoke.resident_long_sweep(
                    torch, ops, chip_smoke.seeded_randn(torch, dev, 210 + i),
                    fft_impl)
        else:
            records = chip_smoke.resident_long_phase(torch, smi_line)
        chip_smoke.emit("phase_seconds", number=21,
                        seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
