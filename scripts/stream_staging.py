#!/usr/bin/env python3
"""``Pipeline.run_streamed``'s host time at the paper's 4096^2 scene, for
several checkouts of the port in turns, on the card.

    python3 scripts/stream_staging.py TREE [TREE ...] [--reps 5] [--strips 4]

Each TREE is the root of a checkout (its ``src/`` holds ``repro_torch``)
whose kernels are built. The trees run in the order given and then in the
reverse order (A B B A), each turn in a subprocess of its own that
simulates the scene on the card, checks ``run_streamed`` bit-equal to
``run`` and times ``reps`` calls of each between two device
synchronisations on the host clock (fused3, matmul route). Prints the
card's name and power limit, one JSON line a turn, then one line with
each tree's medians.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def worker(tree: str, reps: int, strips: int) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch
    from repro_torch.core.sar import (build_pipeline, paper_scene,
                                      paper_targets, simulate)

    cfg = paper_scene()
    raw = simulate(cfg, paper_targets(cfg))
    host = raw.cpu().numpy()
    pipe = build_pipeline(cfg, "fused3")
    if not np.array_equal(pipe.run_streamed(host, strips=strips),
                          pipe.run(raw).cpu().numpy()):
        raise RuntimeError(f"{tree}: run_streamed != run")

    def ms(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    return {"tree": tree, "strips": strips,
            "streamed_ms": ms(lambda: pipe.run_streamed(host, strips=strips)),
            "run_from_host_ms": ms(lambda: pipe.run(host).cpu().numpy())}


def median(values):
    values = sorted(values)
    return values[len(values) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--strips", type=int, default=4)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.trees[0], args.reps, args.strips)),
              flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    trees = [os.path.abspath(t) for t in args.trees]
    runs = {t: {"streamed_ms": [], "run_from_host_ms": []} for t in trees}
    for tree in trees + trees[::-1]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--reps", str(args.reps), "--strips", str(args.strips), tree],
            capture_output=True, text=True, check=True)
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"phase": "stream_turn", "nvidia_smi": smi_line,
                          **turn}), flush=True)
        for k in runs[tree]:
            runs[tree][k] += turn[k]
    print(json.dumps({"phase": "stream_staging", "nvidia_smi": smi_line,
                      "median_ms": {t: {k: median(v) for k, v in r.items()}
                                    for t, r in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
