"""Print the dry run's records as a markdown table (PERF.md, ROADMAP.md).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out DIR
    PYTHONPATH=src python3 scripts/dryrun_table.py DIR --total-memory 85017493504

One row a cell, in ``registry.cells()`` order and then the SAR scene, its
single-pod and multi-pod records side by side (s / m): the busiest
device's peak GiB (starred where it exceeds ``--total-memory`` bytes, a
card's ``torch.cuda.get_device_properties(0).total_memory``), the
roofline's three terms in ms and its bottleneck, and the compute term a
device would have if each data position's work were split over the
"model" axis (16 on both meshes), as the reference's tensor-parallel
layout splits it.
"""
import argparse
import json
import os

from repro_torch.configs import registry

MODEL_AXIS = 16        # "model" of both production meshes
_BOUND = {"compute": "C", "memory": "M", "collective": "L"}


def load(directory: str, arch: str, shape: str, tag: str):
    path = os.path.join(directory, f"{arch}__{shape}__{tag}.json"
                        .replace("/", "_"))
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def fmt(v: float) -> str:
    return f"{v:.4g}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--total-memory", type=int, required=True)
    args = ap.parse_args()
    cells = [(a, s) for a, s, skip in registry.cells() if skip is None]
    cells.append(("sar-rda-4k", "n/a"))
    print("| Cell | Peak GiB s / m | Compute ms s / m | Memory ms s / m | "
          "Collective ms s / m | Bound | Compute ms split over \"model\" "
          "s / m |")
    print("|---|---:|---:|---:|---:|---|---:|")
    over, n, seconds = 0, 0, 0.0
    for arch, shape in cells:
        recs = [load(args.directory, arch, shape, t)
                for t in ("single", "multi")]
        if None in recs:
            print(f"| {arch} {shape} | missing |")
            continue
        cols = {k: [] for k in ("peak", "c", "m", "l", "b", "split")}
        for rec in recs:
            r = rec["roofline"]
            peak = rec["memory"]["peak_bytes_per_device"]
            star = "*" if peak > args.total_memory else ""
            over += bool(star)
            n += 1
            seconds += rec["t_lower_s"]
            cols["peak"].append(f"{peak / 2 ** 30:.2f}{star}")
            cols["c"].append(fmt(r["t_compute_s"] * 1e3))
            cols["m"].append(fmt(r["t_memory_s"] * 1e3))
            cols["l"].append(fmt(r["t_collective_s"] * 1e3))
            cols["b"].append(_BOUND[r["bottleneck"]])
            cols["split"].append(fmt(r["t_compute_s"] * 1e3 / MODEL_AXIS))
        print(f"| {arch} {shape} | " + " | ".join(
            " / ".join(cols[k]) for k in cols) + " |")
    print(f"\n{n} records, {over} over {args.total_memory} B (*); "
          f"C compute, M memory, L collective; traces {seconds:.1f} s")


if __name__ == "__main__":
    main()
