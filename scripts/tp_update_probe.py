#!/usr/bin/env python3
"""How far a split bf16 AdamW step's update moves from one device's, with
depth: ``chip_smoke.tp_mixers_update`` (the update against one device
summing every split contraction as the ranks sum it, against one device's
plain step, and the control with partial sums rounded to bf16 before
their reduction, each over the largest move) for granite-moe-3b on (1,
16) and falcon-mamba-7b / recurrentgemma-9b on (1, 4) at full width,
1, 2, 4 ... pattern periods deep. A check that fails is printed, not
raised.

    python3 scripts/tp_update_probe.py [--periods 1,2,4] [--archs A,B]

Prints the card's name and power limit, then one ``tp_mixers_update``
line a case (``chip_smoke.py``'s own), on slabs of the one card.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

MESH = {"granite-moe-3b-a800m": (1, 16), "falcon-mamba-7b": (1, 4),
        "recurrentgemma-9b": (1, 4)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--periods", default="1,2,4")
    ap.add_argument("--archs", default=",".join(MESH))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tp_update_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    chip_smoke.check = lambda ok, msg: ok or print("check:", msg, flush=True)
    for arch in args.archs.split(","):
        for n in map(int, args.periods.split(",")):
            cfg = chip_smoke.period_cfg(arch)
            cfg = dataclasses.replace(cfg, n_layers=n * len(cfg.pattern))
            try:
                chip_smoke.tp_mixers_update(torch, dev, cfg, MESH[arch], 4,
                                            128, 46)
            except Exception:          # report it, run the other cases
                traceback.print_exc()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
