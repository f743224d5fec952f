#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 20 alone on the card: every precision past
one block (the forms' kernel sweeps, the 8192 x 16384 scene at bs16 and
bf16, a default-tier service request, the SNR gate and ``search_kernel``
at 8192, the forms' times).

    python3 scripts/long_forms_smoke.py

Builds the kernels that are stale (``-Xptxas -v``; a forced build is
``chip_smoke.py``'s), prints the card's name and power limit, the ptxas
report of the libraries it built, phase 20's lines and a ``kernels`` line
of its records; exits 0 when every check passed.
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
        print("long_forms_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
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
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune_cache.json")
        t0 = time.perf_counter()
        records = chip_smoke.long_forms_phase(torch, smi_line,
                                              chip_smoke.replay_plain)
        chip_smoke.emit("phase_seconds", number=20,
                        seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
