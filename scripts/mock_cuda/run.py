#!/usr/bin/env python3
"""The CUDA kernels' device code on the CPU, for rehearsals without a card.

    python3 scripts/mock_cuda/run.py build TREE OUT NAME...
    python3 scripts/mock_cuda/run.py compare TREE_A LIBS_A TREE_B LIBS_B \\
        CASES
    python3 scripts/mock_cuda/run.py check TREE LIBS CASES TOL RING_CASES

``build`` compiles ``TREE``'s ``src/repro_torch/kernels/csrc/NAME.cu`` with
g++ against this directory's mock of the CUDA runtime (one std::thread a
CUDA thread, std::barrier for ``__syncthreads``, the grid run block after
block with the occupancy query saying one block on one SM, so a grid
barrier is a block barrier; ``mma.sync`` through per-warp slots, exact
products summed in double and rounded once a fragment element; shared
memory NaN-filled) into ``OUT/libNAME.so``, after rewriting what g++ does
not take (``extern __shared__``, ``<<<...>>>`` launches, the cooperative
launch's cast, the named barrier's ``asm``).

``check`` runs ``CASES`` on ``TREE``'s mock libraries three times: with
the long passes' asynchronous ring (``ops.LONG_RING``) and cp.async made
as issued, with it and cp.async made as the wait retires it
(``MOCK_CP_ASYNC=lazy``), and without the ring; it prints each case's
copies and error against the plain version, and returns 1 unless the
three agree bit for bit, every error is within ``TOL`` (relative to the
largest magnitude of the plain version's output) and the ring's runs
made copies where ``RING_CASES`` (the indices of the cases whose tiles
take it) says and none elsewhere.

``compare`` runs the spectral long ops of ``CASES`` — a Python list of
``(n, axis, mode, fwd, inv, fft_impl, precision, karatsuba, split[,
lines])`` — through each tree's own ``kernels/ops.py`` on CPU tensors with
that tree's mock libraries (``ops._launch_cuda``, the same records and
launchers as on the card), one subprocess a tree, and prints whether the
two trees' outputs are equal bit for bit and each one's error against
the plain version. Two trees whose device code runs the same arithmetic
agree bit for bit here whatever the mock's rounding, so a mismatch is an
indexing or ordering fault; glibc's ``sincosf`` is not the card's, so the
Stockham route equals its plain version only where no outer phase runs.
Keep the shapes small (lines of 3 to 8): 512 threads a block each run as
an OS thread.
"""
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def build(tree, out, names):
    src = os.path.join(tree, "src", "repro_torch", "kernels", "csrc")
    work = os.path.join(out, "src")
    os.makedirs(work, exist_ok=True)
    for f in os.listdir(src):
        t = open(os.path.join(src, f)).read()
        t = t.replace("extern __shared__ float2 s[];",
                      "float2* s = mock_smem<float2>();")
        t = re.sub(r'asm volatile\("bar\.sync %0, %1;" ::"r"\(id\), '
                   r'"r"\(count\) : "memory"\);',
                   "mock_bar_sync(id, count);", t)
        t = t.replace("(const void*)", "")
        t = re.sub(r"([A-Za-z_][\w:]*(?:<[^;{}()]*?>)?)\s*<<<\s*([^,]+),"
                   r"\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\s*\(([^;]*)\);",
                   r"mock_launch(\1, dim3(\2), dim3(\3), \4, \6);", t,
                   flags=re.S)
        with open(os.path.join(work, f), "w") as fh:
            fh.write(t)
    for f in ("tf32_mma.cuh", "mma16.cuh", "async_copy.cuh"):
        shutil.copy(os.path.join(HERE, f), os.path.join(work, f))
    procs = [(name, subprocess.Popen(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
         "-shared", "-pthread", "-w", "-I", HERE, "-x", "c++", "-o",
         os.path.join(out, f"lib{name}.so"),
         os.path.join(work, name + ".cu")],
        stderr=subprocess.PIPE, text=True)) for name in names]
    rc = 0
    for name, p in procs:
        err = p.communicate()[1]
        print(name, p.returncode, flush=True)
        if p.returncode:
            print(err[-6000:])
            rc = 1
    return rc


def run_cases(tree, libdir, out, cases, ring=None):
    """Each case's (kernel output or the error, plain version, cp.async
    copies the case made) into out; ``ring``: ``ops.LONG_RING`` (None:
    the tree's own)."""
    import contextlib
    import ctypes
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from repro_torch.kernels import _build, ops
    if ring is not None:
        ops.LONG_RING = ring

    class _Stream:
        cuda_stream = 0
    torch.cuda.current_stream = lambda dev=None: _Stream()
    torch.cuda.device = lambda dev: contextlib.nullcontext()
    libs = {}

    def load(name):
        if name not in libs:
            libs[name] = ctypes.CDLL(os.path.join(libdir, f"lib{name}.so"))
        return libs[name]
    _build.load = load
    gen = torch.Generator().manual_seed(0)
    res = []
    for case in cases:
        n, axis, mode, fwd, inv, impl, prec, kara, split = case[:9]
        lines, batch = (case[9] if len(case) > 9 else 3), 2
        scene = (lines, n) if axis == 1 else (n, lines)
        xr = torch.randn(batch, *scene, generator=gen)
        xi = torch.randn(batch, *scene, generator=gen)
        xr[0, 0] *= 1e-3
        fk = {}
        if mode in ("shared", "shared_outer"):
            fk.update(hr=torch.randn(n, generator=gen),
                      hi=torch.randn(n, generator=gen))
        if mode == "full":
            fk.update(hr=torch.randn(*scene, generator=gen),
                      hi=torch.randn(*scene, generator=gen))
        if mode in ("outer", "shared_outer"):
            fk.update(u=0.1 * torch.randn(lines, 2, generator=gen),
                      v=torch.randn(n, 2, generator=gen))
        kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode,
                  fft_impl=impl, precision=prec, karatsuba=kara, n1=None,
                  n2=None, n3=None)
        if split:
            kw.update(n1=split[0], n2=split[1], n3=split[2])
        prep = ops._prepare(xr, xi, fk.get("hr"), fk.get("hi"), fk.get("u"),
                            fk.get("v"), block=1, **kw)
        copies = copy_count(libs)
        try:
            y = ops._launch_cuda(prep[0], prep[1], prep[2], prep[3])
        except Exception as e:   # the launcher's refusal, kept for the report
            y = repr(e)
        res.append((y, ops.spectral_op_plain(xr, xi, **fk, **kw),
                    copy_count(libs) - copies))
    torch.save(res, out)


def copy_count(libs):
    """cp.async copies the loaded mock libraries have issued."""
    n = 0
    for lib in libs.values():
        fn = getattr(lib, "mock_cp_async_count", None)
        if fn is not None:
            fn.restype = __import__("ctypes").c_longlong
            n += fn()
    return n


def check(tree, libdir, cases, tol, ring_cases):
    import torch
    runs = (("ring", "1", "eager"), ("ring, lazy copies", "1", "lazy"),
            ("no ring", "0", "eager"))
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"{i}.pt") for i in range(len(runs))]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "_run",
             tree, libdir, o, cases, ring],
            env=dict(os.environ, MOCK_CP_ASYNC=mode))
            for (_, ring, mode), o in zip(runs, outs)]
        rcs = [p.wait() for p in procs]
        if any(rcs):
            print("a run failed:", rcs)
            return 1
        res = [torch.load(o, weights_only=False) for o in outs]
    bad = 0
    ring_cases = set(eval(ring_cases))
    for i, c in enumerate(eval(cases)):
        ys = [r[i][0] for r in res]
        want = res[0][i][1]
        copies = [r[i][2] for r in res]
        if any(isinstance(y, str) for y in ys):
            print(c, "refused:", [y for y in ys if isinstance(y, str)])
            bad += 1
            continue
        eq = all(torch.equal(a, b) for y in ys[1:] for a, b in zip(ys[0], y))
        scale = max(float(w.abs().max()) for w in want)
        err = max(float((x - w).abs().max()) for x, w in zip(ys[0], want))
        rel = err / scale
        used = (copies[0] > 0, copies[1] > 0, copies[2] > 0)
        ok = eq and rel <= float(tol) and \
            used == ((i in ring_cases,) * 2 + (False,))
        print(c, f"equal {eq}, vs plain {rel:.2e}, copies {copies}",
              "" if ok else "FAIL", flush=True)
        bad += not ok
    print("failing cases:", bad)
    return int(bad > 0)


def compare(tree_a, libs_a, tree_b, libs_b, cases):
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"{i}.pt") for i in range(2)]
        procs = [subprocess.Popen([sys.executable, __file__, "_run", t, lib,
                                   o, cases])
                 for t, lib, o in ((tree_a, libs_a, outs[0]),
                                   (tree_b, libs_b, outs[1]))]
        for p in procs:
            p.wait()
        a, b = (torch.load(o, weights_only=False) for o in outs)
    bad = 0
    for c, (ya, want, *_), (yb, *_) in zip(eval(cases), a, b):
        if isinstance(ya, str) or isinstance(yb, str):
            print(c, "refused:", ya if isinstance(ya, str) else "",
                  yb if isinstance(yb, str) else "")
            bad += 1
            continue
        eq = all(torch.equal(x, y) for x, y in zip(ya, yb))
        scale = max(float(w.abs().max()) for w in want)
        err = max(float((x - w).abs().max()) for x, w in zip(ya, want))
        print(c, f"A == B {eq}, A vs plain {err / scale:.2e}", flush=True)
        bad += not eq
    print("differing cases:", bad)
    return int(bad > 0)


def main(argv):
    if argv[:1] == ["build"]:
        return build(argv[1], argv[2], argv[3:])
    if argv[:1] == ["_run"]:
        ring = None if len(argv) < 6 else argv[5] == "1"
        run_cases(argv[1], argv[2], argv[3], eval(argv[4]), ring)
        return 0
    if argv[:1] == ["compare"]:
        return compare(*argv[1:6])
    if argv[:1] == ["check"]:
        return check(*argv[1:6])
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
