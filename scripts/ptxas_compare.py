#!/usr/bin/env python3
"""ptxas registers and spills of every kernel instantiation in two
checkouts of the port, compiled side by side on the machine with ``nvcc``.

    python3 scripts/ptxas_compare.py OTHER_TREE [SOURCE ...]

Compiles this checkout's ``kernels/csrc`` sources and OTHER_TREE's (the
root of another checkout, e.g. a ``git archive`` of the parent commit) —
every source, or the ones named (``spectral``, ``mega_long``, ...) — with
each tree's own ``kernels/_build.py`` flags and ``-Xptxas -v``, all
``nvcc`` processes at once, into a temporary directory, and reads the
reports with ``chip_smoke.ptxas_report``. Prints one JSON line: each
tree's compile seconds a source, the instantiations (and out-of-line
functions) both trees build with their registers and spill bytes, the
ones whose numbers differ, and the ones one tree alone builds. Exits 3
when a common one differs.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD = (
    "import json, os, subprocess, sys, time\n"
    "sys.path.insert(0, {src!r})\n"
    "from repro_torch.kernels import _build\n"
    "want = {names!r}\n"
    "srcs = {{k: v for k, v in _build.sources().items()\n"
    "        if not want or k in want}}\n"
    "t0 = time.perf_counter()\n"
    "procs = {{k: subprocess.Popen(\n"
    "    [_build.nvcc_path(), '-Xptxas', '-v', *_build.ARCH_FLAGS,\n"
    "     *_build.NVCC_FLAGS, '-o', os.path.join({out!r}, k + '.so'), v],\n"
    "    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)\n"
    "    for k, v in srcs.items()}}\n"
    "logs, secs = {{}}, {{}}\n"
    "for k, p in procs.items():\n"
    "    logs[k] = p.communicate()[0]\n"
    "    secs[k] = time.perf_counter() - t0\n"
    "    if p.returncode:\n"
    "        sys.exit(logs[k])\n"
    "print(json.dumps(dict(seconds=secs, logs=logs)))\n")


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    names = sys.argv[2:]
    trees = {"this": HERE, "other": os.path.abspath(sys.argv[1])}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for k, t in trees.items():
            out = os.path.join(tmp, k)
            os.makedirs(out)
            procs[k] = subprocess.Popen(
                [sys.executable, "-c", _BUILD.format(
                    src=os.path.join(t, "src"), names=names, out=out)],
                stdout=subprocess.PIPE, text=True)
        built = {}
        for k, p in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                print(f"ptxas_compare: {k} tree's build failed",
                      file=sys.stderr)
                return 1
            built[k] = json.loads(out.strip().splitlines()[-1])
    sys.path.insert(0, HERE)
    import chip_smoke
    reports = {}
    for k, b in built.items():
        rep = {}
        for log in b["logs"].values():
            rep.update(chip_smoke.ptxas_report(log))
        reports[k] = rep
    common = sorted(set(reports["this"]) & set(reports["other"]))
    differ = {n: {"this": reports["this"][n], "other": reports["other"][n]}
              for n in common if reports["this"][n] != reports["other"][n]}
    print(json.dumps(dict(
        sources=names or "all",
        build_seconds={k: b["seconds"] for k, b in built.items()},
        common={n: reports["this"][n] for n in common},
        differ=differ,
        only_this={n: reports["this"][n]
                   for n in sorted(set(reports["this"]) - set(common))},
        only_other=sorted(set(reports["other"]) - set(common)))))
    return 3 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
