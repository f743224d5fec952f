#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and ``nvcc``; exits non-zero, with
no result line, when there is no card or the port is missing. Phases,
each printing one JSON line (any failed check raises and exits non-zero):

1. device  — the card's name and power limit (the raw nvidia-smi line is
             printed on a line of its own), torch / CUDA versions; TF32 is
             switched off for matmul and cuDNN.
2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``,
             forced, so a second run in the same checkout reports ptxas's
             registers and spills per instantiation too (and per
             out-of-line Stockham op, 'kernel/stockham_n<layout,N,...>');
             ``cuobjdump -sass`` must show HMMA TF32 instructions in the
             matmul instantiations of ``spectral_kernel``,
             ``mega_resident`` and ``mega_staged`` (the tensor-core
             stage).
3. kernel  — the CUDA spectral kernel against its plain PyTorch version on
             the card: every filter mode x axis x fwd/inv combination at
             N in {128, 4096}, B in {1, 2}, 37 lines (ragged against every
             tile), tolerance 2e-4 x max|want|; each N = 4096 case also
             against a complex128 ``torch.fft`` oracle at 1e-5 x max|want|
             (the outer phase rounded as the kernels round it).
4. main    — the main path at the paper's size: ``simulate`` a 4096^2
             scene, ``build_pipeline(cfg, "fused3").run(raw)`` with the
             launch counts reset just before and read just after (exactly
             3 spectral launches and no other), all five targets within 8 px of ``metrics.expected_pixel``
             (argmax over a +-64 px window), the same compiled plan replayed
             through the plain version on the card (same peaks, |dSNR| <=
             0.1 dB), the image within 1e-5 x max|want| of the plan in
             complex128, each launch's inputs through kernel and plain
             version;
             then ``fused_tfree`` (exactly 4 launches); then a 128^2 scene
             on the card against the plain version on the CPU.
5. times   — CUDA events, 2 warm-ups, median of 7: each fused3 launch
             (every kernel, plain and library time is queued behind a
             spin on the card, so the host's time before the launch is
             not in it) and the whole run (with the host's time),
             beside the launch's bound (bytes over 3.35 TB/s
             vs nominal 5 N log2 N FLOP over 67 TFLOP/s, H100 SXM spec
             sheet), ``mma_floor_ms`` (the stages' 3 TF32 passes of
             8 N (n1 + n2) flop a line and transform over 495 TFLOP/s),
             the plain version, ``library_ms`` (torch.fft -> multiply ->
             torch.fft, timed only as a yardstick) and ``vs_library``
             (kernel ms over library ms; on every time_launch and
             time_kernel line).
6. mega_kernel — each CUDA megakernel (``csrc/mega.cu``) against
             ``fft4step.mega_plain`` on the card, 2e-4 x max|want|: fused1's
             3-segment chain with every filter mode on both axes, one- and
             two-segment chains and a same-axis boundary, on 64x128,
             128x64, 128^2 (both kernels, held ``torch.equal`` to each
             other), 256^2 and 4096^2 (staged), B in {1, 2}; each 4096^2
             case also against the chain in complex128 at 1e-5. The
             shared-memory opt-in the residency cut assumes is read from
             the card.
7. main fused1 — ``build_pipeline(cfg, "fused1").run(raw)`` at 4096^2
             (staged by the cut): exactly one ``mega_staged`` launch and no
             spectral launch, all five targets within 8 px, ``torch.equal``
             to the card's fused3 image, the plan replayed through
             ``mega_spectral_op_plain`` on the card (same peaks, |dSNR| <=
             0.1 dB); then 128^2 (resident by the cut): one
             ``mega_resident`` launch, ``torch.equal`` to fused3 and to
             ``residency="staged"``, within 2e-4 of the CPU plain version.
8. time fused1 — fused3 and fused1 runs in turns (fused3, fused1, fused1,
             fused3); the staged kernel alone at 4096^2 and the resident
             kernel alone on 132 scenes of 128^2 (one per SM, beside fused3
             and fused1 runs of that batch), each beside its bound, its
             plain version and ``library_ms``.
9. transpose_kernel — the CUDA tiled transpose (``csrc/transpose.cu``)
             against ``transpose_plain`` with ``torch.equal``: float32 and
             complex64, 2-D and B = 2, square, non-square and ragged shapes
             up to 4096^2.
10. stockham_kernel — phase 3's grid with ``fft_impl="stockham"`` at N in
             {16, 128, 256, 1024, 4096} (the Stockham route of the
             spectral kernel), then phase 6's chains through both
             megakernels on the Stockham route, each ``torch.equal`` to
             its plain version (and resident to staged); each N = 4096
             case and each 4096^2 chain also against the complex128
             oracle at 1e-5, as on the matmul route.
11. main fused — ``build_pipeline(cfg, "fused").run(raw)`` at 4096^2 with
             the counts reset just before and read just after (exactly 3
             spectral, 4 transpose, 0 mega launches), all five targets
             within 8 px, the same peaks and |dSNR| <= 0.1 dB against the
             card's ``unfused`` image and against the steps replayed
             through the plain versions; each turn's input through the
             kernel and ``transpose_plain``.
12. main stockham — ``fused3`` with ``fft_impl="stockham"`` at 4096^2
             (exactly 3 spectral launches, five targets within 8 px, the
             same peaks and |dSNR| <= 0.1 dB against the matmul fused3
             image and the plain replay, the image within 1e-5 of the plan
             in complex128); ``fused1`` on the Stockham route
             at 4096^2 (one ``mega_staged`` launch) and 128^2 (one
             ``mega_resident`` launch, and ``residency="staged"``), each
             ``torch.equal`` to the Stockham fused3 image of its size.
13. time baselines — each transpose launch of the fused run at 4096^2
             complex64 beside its bound, ``transpose_plain`` and
             ``library_ms`` (``x.transpose(-1, -2).contiguous()``); the
             fused run with its spectral launches and its sinc RCMC step
             timed alone; each Stockham fused3 launch beside the matmul
             launch of the same segment; both megakernels on the Stockham
             route; fused3 runs on the two routes in turns (matmul,
             stockham, stockham, matmul).
14. csa / omega-K — the paper's scene through ``csa`` (the torch backend's
             7 ops, no kernel launch, the baseline), then on each FFT
             route ``csa_fused`` and ``omegak`` (exactly 3 spectral
             launches, FULL screens read from device memory; five targets
             within 8 px, the plain replay's peaks and |dSNR| <= 0.1 dB,
             ``csa_fused`` within 0.1 dB of ``csa``; each launch against
             its plain version) and ``csa_fused1`` / ``omegak_fused1``
             (exactly one ``mega_staged``, ``torch.equal`` to the three
             launches); each launch and megakernel timed beside its bound
             and ``library_ms`` (the variant through torch.fft and torch
             multiplies by the same screens), the two variants' runs in
             turns; then 132 scenes of 128^2 through ``mega_resident``,
             ``torch.equal`` to the three launches, timed the same way.
15. precisions — the Stockham route at bf16, f16 and bs16: the spectral
             kernel's grid at N in {16 ... 4096} with odd lines subnormal
             and both megakernels' chains (a unit-scale scene beside a
             subnormal one), bs16 ``torch.equal`` to its plain version and
             different from f32 where values are subnormal, bf16 and f16
             equal to f32; then ``fused3``, ``fused1``, ``csa_fused``,
             ``csa_fused1``, ``omegak`` and ``omegak_fused1`` at 4096^2 and
             ``fused1`` at 128^2 at each precision (launch counts,
             ``torch.equal`` to the plain replay, within 0.1 dB of the f32
             image, whether it equals f32 bit for bit), each bs16 launch
             timed.

The line before the last lists each kernel — on the main path and on each
path of phases 14 and 15, with the precisions it runs on each route; the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM spec sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM spec sheet, FP32 outside tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM spec sheet, dense TF32 tensor cores
TF32_PASSES = 3                # the matmul route's 3xTF32 split
TOL = 2e-4                     # x max|want| (tests/test_kernels.py)
ORACLE_TOL = 1e-5              # x max|want|, either route vs complex128
GATE_DB = 0.1
SEARCH = 64                    # window of the peak-position check


# the matmul-route instantiations, which must run on the tensor cores
MMA_KERNELS = ("spectral_kernel<matmul>", "mega_resident<matmul>",
               "mega_staged<matmul>")
_KERNEL_NAMES = ("spectral_kernel", "mega_resident",
                 "mega_staged", "transpose_kernel")
_ROUTES = {"ILb0E": "matmul", "ILb1E": "stockham"}


def instantiation(mangled):
    """A readable name of a mangled kernel, e.g. 'mega_staged<matmul>'
    (the template flag kStockham of spectral.cu and mega.cu; a megakernel
    specialised on its N, 'mega_staged<stockham,4096>'; the bs16 codec's
    instantiations end in ',bs16'), or of one out-of-line Stockham op, e.g.
    'stockham_n<cols,4096,io,32>' (layout, N, device-memory tile or
    in-place slab, points a thread, ',bs16' with the codec)."""
    m = re.search(r"stockham_nILb([01])ELi(\d+)ELb([01])ELi(\d+)ELb([01])E",
                  mangled)
    if m:
        return (f"stockham_n<{'cols' if m.group(1) == '1' else 'rows'},"
                f"{m.group(2)},{'io' if m.group(3) == '1' else 'slab'},"
                f"{m.group(4)}{',bs16' if m.group(5) == '1' else ''}>")
    for name in _KERNEL_NAMES:
        i = mangled.find(name)
        if i < 0:
            continue
        rest = mangled[i + len(name):]
        for key, route in _ROUTES.items():
            if rest.startswith(key):   # a megakernel's N, where specialised
                m = re.match(r"ILb[01]E(?:Li(\d+)E)?Lb([01])E", rest)
                n = f",{m.group(1)}" if m and m.group(1) not in (None, "0") \
                    else ""
                bs = ",bs16" if m and m.group(2) == "1" else ""
                return f"{name}<{route}{n}{bs}>"
        if rest.startswith("I"):
            return f"{name}<{rest[1:rest.find('E')]}>"
        return name
    return mangled


def ptxas_report(log):
    """{instantiation: registers, spill stores and loads} from one source's
    ``-Xptxas -v`` output; an out-of-line Stockham op (``stockham_n``, a
    call of its kernel, compiled for each kernel's register budget) gets
    its own spill record under 'kernel/op' (its registers count in its
    kernel's)."""
    out = {}
    cur = props = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            out[instantiation(cur)] = {}
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        if cur is None:
            continue
        rec = out[instantiation(cur)]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and props == cur:
            rec.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        elif m and props and "stockham_n" in props:
            out[f"{instantiation(cur)}/{instantiation(props)}"] = dict(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rec["registers"] = int(m.group(1))
    return out


def sass_hmma_tf32(lib):
    """{instantiation: HMMA ... TF32 instructions} in the SASS of one built
    library (``cuobjdump -sass``, beside nvcc)."""
    from repro_torch.kernels import _build
    exe = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    cur = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = instantiation(m.group(1))
            counts.setdefault(cur, 0)
        elif cur is not None and "HMMA" in ln and "TF32" in ln:
            counts[cur] += 1
    return counts


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, want):
    """max|got - want| over max|want|, for split (re, im) pairs."""
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err, err / max(scale, 1e-30)


def phase_f32(torch, u, v):
    """The rank-K outer phase sum_q u[l, q] v[k, q] as the kernels round
    it (``ph = fmaf(u_q, v_q, ph)`` in float32, q in order), as float64
    (lines, n): the float64 product of two float32 values is exact, so
    each step rounds once to float32 (up to a rare double-rounding tie)."""
    u = u.reshape(u.shape[0], -1).double()
    v = v.reshape(v.shape[0], -1).double()
    ph = torch.zeros(u.shape[0], v.shape[0], dtype=torch.float64,
                     device=u.device)
    for q in range(u.shape[1]):
        ph = (u[:, q, None] * v[None, :, q] + ph).float().double()
    return ph


def oracle_op(torch, x, axis, fwd, inv, mode, hr=None, hi=None, u=None,
              v=None):
    """One per-axis op [FFT] -> filter -> [IFFT] in complex128 through
    torch.fft, on a complex (..., lines, n) rows / (..., n, lines) cols
    tensor, with the filter payloads of ``ops.spectral_op``; the outer
    phase rounded as the kernels round it (``phase_f32``), so what is
    held is the FFT arithmetic."""
    dim = -1 if axis == 1 else -2
    x = x.to(torch.complex128)
    if fwd:
        x = torch.fft.fft(x, dim=dim)
    if mode in ("shared", "full", "shared_outer"):
        h = torch.complex(hr.double(), hi.double())
        if mode != "full":
            h = h[None, :] if axis == 1 else h[:, None]
        x = x * h
    if mode in ("outer", "shared_outer"):
        ph = phase_f32(torch, u, v)
        if axis == 0:
            ph = ph.T
        x = x * torch.polar(torch.ones_like(ph), ph)
    if inv:
        x = torch.fft.ifft(x, dim=dim)
    return x


def image_oracle(torch, pipe, raw):
    """A compiled pipeline of spectral steps, in complex128 through
    ``oracle_op`` with each step's own payloads."""
    want = raw
    for s in pipe.steps:
        kk = s.kernel_kw
        want = oracle_op(torch, want, kk["axis"], kk["fwd"], kk["inv"],
                         kk["filter_mode"], **s.filter_kw)
    return want


def oracle_err(torch, got, want):
    """max|got - want| / max|want| of a split float32 result against a
    complex128 oracle."""
    g = torch.complex(got[0].double(), got[1].double())
    return float((g - want).abs().max() / want.abs().max())


def cuda_median_ms(fn, warm=2, reps=7, queued=False):
    """Median of ``reps`` CUDA-event timings of ``fn``. ``queued``: each
    timing waits behind a spin on the card, so the events bracket the
    card's work and not the host's Python time before each launch — the
    kernel times; a whole pipeline run is timed with the host in it."""
    from repro_torch.kernels.probe import median_ms
    return median_ms(fn, warm=warm, reps=reps, queued=queued)


TRANSPOSE_SHAPES = ((64, 64), (128, 256), (96, 32), (37, 4096), (4096, 4096))
MEGA_MODES = ("none", "shared", "full", "outer", "shared_outer")
MEGA_SHAPES = ((64, 128), (128, 64), (128, 128), (256, 256), (4096, 4096))
MEGA_BATCH = 132               # resident timing: one 128^2 scene per SM
STOCKHAM_SIZES = (16, 128, 256, 1024, 4096)   # phase 10's spectral sweep


def mega_chains():
    """fused1's 3-segment shape with each filter mode on both axes, one-
    and two-segment chains, and a same-axis boundary."""
    chains = [((0, True, False, "none"), (1, True, True, m),
               (0, False, True, m)) for m in MEGA_MODES]
    chains.append(((0, True, True, "shared_outer"),))
    chains.append(((1, True, True, "shared"), (0, False, True, "full")))
    chains.append(((1, True, False, "shared"), (1, False, True, "outer"),
                   (0, True, True, "none")))
    return chains


def reset_launch_counts():
    """Every kernel's launch count to 0 (just before a main-path run)."""
    from repro_torch.kernels import ops, transpose
    ops.SPECTRAL_LAUNCHES = 0
    ops.MEGA_LAUNCHES.update(mega_resident=0, mega_staged=0)
    transpose.TRANSPOSE_LAUNCHES = 0


def launch_counts(**want):
    """The launch counts since the last reset: every kernel, 0 unless
    named in ``want`` (the expected counts, for ``==``)."""
    from repro_torch.kernels import ops, transpose
    got = {"spectral": ops.SPECTRAL_LAUNCHES,
           "transpose": transpose.TRANSPOSE_LAUNCHES, **ops.MEGA_LAUNCHES}
    return got, {**{k: 0 for k in got}, **want}


def seeded_randn(torch, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return rand


def spectral_sweep(torch, ops, rand, fft_impl, sizes=(128, 4096),
                   exact=False):
    """The spectral kernel against its plain version on the card: every
    filter mode x axis x fwd/inv at N in ``sizes``, B in {1, 2}, 37
    lines, within ``TOL`` or, ``exact``, ``torch.equal``; on either route
    each N = 4096 case also against the complex128 oracle
    (``ORACLE_TOL``). Returns (cases, max rel err, oracle cases, max oracle
    err)."""
    from repro_torch.kernels.fft4step import FILTER_MODES
    lines, rank = 37, 2
    worst = worst_oracle = 0.0
    cases = oracle_cases = 0
    for n in sizes:
        for batch in (1, 2):
            for axis in (0, 1):
                scene = (lines, n) if axis == 1 else (n, lines)
                xr, xi = rand(batch, *scene), rand(batch, *scene)
                for mode in FILTER_MODES:
                    filt = {}
                    if mode in ("shared", "shared_outer"):
                        filt.update(hr=rand(n), hi=rand(n))
                    if mode == "full":
                        filt.update(hr=rand(*scene), hi=rand(*scene))
                    if mode in ("outer", "shared_outer"):
                        filt.update(u=rand(lines, rank), v=rand(n, rank))
                    for fwd, inv in ((True, False), (False, True),
                                     (True, True), (False, False)):
                        if mode == "none" and not (fwd or inv):
                            continue
                        kw = dict(axis=axis, fwd=fwd, inv=inv,
                                  filter_mode=mode, block=1,
                                  fft_impl=fft_impl)
                        got = ops.spectral_op(xr, xi, **filt, **kw)
                        want = ops.spectral_op_plain(xr, xi, **filt, **kw)
                        torch.cuda.synchronize()
                        _, rel = rel_err(got, want)
                        check(rel <= TOL, f"kernel vs plain {kw} n={n} "
                              f"B={batch}: rel err {rel:.3e}")
                        check(not exact or all(
                            torch.equal(g, w) for g, w in zip(got, want)),
                              f"kernel != plain {kw} n={n} B={batch}: "
                              f"rel err {rel:.3e}")
                        worst = max(worst, rel)
                        cases += 1
                        if n == 4096:
                            o = oracle_err(torch, got, oracle_op(
                                torch, torch.complex(xr, xi), axis, fwd,
                                inv, mode, **filt))
                            check(o <= ORACLE_TOL, f"kernel vs complex128 "
                                  f"{kw} n={n} B={batch}: {o:.3e}")
                            worst_oracle = max(worst_oracle, o)
                            oracle_cases += 1
    return cases, worst, oracle_cases, worst_oracle


def mega_sweep(torch, ops, rand, fft_impl, exact=False):
    """Both megakernels against ``mega_plain`` on the card over
    ``mega_chains()`` x ``MEGA_SHAPES`` x B in {1, 2} (within ``TOL`` or,
    ``exact``, ``torch.equal``), resident held
    ``torch.equal`` to staged; on either route each 4096^2 case also
    against the complex128 oracle chain (``ORACLE_TOL``). Returns (cases,
    max rel err, equal pairs, oracle cases, max oracle err) with the first
    two per kernel."""
    worst = {"mega_resident": 0.0, "mega_staged": 0.0}
    cases = {"mega_resident": 0, "mega_staged": 0}
    equal_pairs = oracle_cases = 0
    worst_oracle = 0.0
    for na, nr in MEGA_SHAPES:
        for batch in (1, 2):
            x = (rand(batch, na, nr), rand(batch, na, nr))
            for segments in mega_chains():
                args = []
                for axis, _fwd, _inv, mode in segments:
                    n, lines = (nr, na) if axis == 1 else (na, nr)
                    if mode in ("shared", "shared_outer"):
                        args += [rand(n), rand(n)]
                    if mode == "full":
                        args += [rand(na, nr), rand(na, nr)]
                    if mode in ("outer", "shared_outer"):
                        args += [rand(lines, 2), rand(n, 2)]
                want = ops.mega_spectral_op_plain(*x, *args,
                                                  segments=segments,
                                                  fft_impl=fft_impl)
                outs = []
                for residency, kernel in (("vmem", "mega_resident"),
                                          ("staged", "mega_staged")):
                    if residency == "vmem" and \
                            ops.mega_residency(na, nr) != "vmem":
                        continue
                    got = ops.mega_spectral_op(*x, *args, segments=segments,
                                               residency=residency,
                                               fft_impl=fft_impl)
                    torch.cuda.synchronize()
                    _, rel = rel_err(got, want)
                    check(rel <= TOL, f"{kernel} ({fft_impl}) vs plain "
                          f"{segments} {na}x{nr} B={batch}: rel err "
                          f"{rel:.3e}")
                    check(not exact or all(
                        torch.equal(g, w) for g, w in zip(got, want)),
                          f"{kernel} ({fft_impl}) != plain {segments} "
                          f"{na}x{nr} B={batch}: rel err {rel:.3e}")
                    worst[kernel] = max(worst[kernel], rel)
                    cases[kernel] += 1
                    outs.append(got)
                    if na == nr == 4096:
                        o = oracle_err(torch, got, oracle_chain(
                            torch, torch.complex(*x), segments, args))
                        check(o <= ORACLE_TOL, f"{kernel} vs complex128 "
                              f"{segments} {na}x{nr} B={batch}: {o:.3e}")
                        worst_oracle = max(worst_oracle, o)
                        oracle_cases += 1
                if len(outs) == 2:
                    check(all(torch.equal(a, b) for a, b in zip(*outs)),
                          f"resident != staged ({fft_impl}) {segments} "
                          f"{na}x{nr}")
                    equal_pairs += 1
            del x, args, want, outs
    return cases, worst, equal_pairs, oracle_cases, worst_oracle


def oracle_chain(torch, x, segments, args):
    """A megakernel chain in complex128 (``oracle_op`` per segment, the
    filter payloads in scene coordinates, in segment order)."""
    it = iter(args)
    for axis, fwd, inv, mode in segments:
        filt = {}
        if mode in ("shared", "full", "shared_outer"):
            filt.update(hr=next(it), hi=next(it))
        if mode in ("outer", "shared_outer"):
            filt.update(u=next(it), v=next(it))
        x = oracle_op(torch, x, axis, fwd, inv, mode, **filt)
    return x


def mma_floor(n, n1, n2, lines, transforms):
    """(tensor-core flops, ms) of the matmul route's stages: 8 N (n1 + n2)
    real flops a line and transform, issued as ``TF32_PASSES`` TF32
    passes, over the dense TF32 rate."""
    flops = TF32_PASSES * 8.0 * n * (n1 + n2) * lines * transforms
    return flops, flops / TF32_FLOP_PER_S * 1e3


def time_mega_kernel(torch, smi_line, name, step, x, segments_cfg,
                     variant="fused1"):
    """One megakernel alone on the main path's split input, beside its
    bound, its plain version, ``variant``'s chain through torch.fft and
    torch multiplies by the same payloads (``library_ms``) and, on the
    matmul route, the tensor-core floor of its stages."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft4step import (MegaSpec, SegmentSpec,
                                              _mega_flops)
    xr, xi = planlib.split(x)
    args = [t for a in step.seg_filter_args for t in a]
    kk = step.kernel_kw
    batch, na, nr = xr.shape if xr.ndim == 3 else (1, *xr.shape)
    spec = MegaSpec(na, nr, tuple(SegmentSpec(*s) for s in kk["segments"]))
    nbytes = 16 * xr.numel() + sum(4 * t.numel() for t in args)
    flops = _mega_flops(spec) * batch
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    oracle = build_pipeline(segments_cfg, variant, backend="torch")
    rec = dict(
        kernel=name, variant=variant, fft_impl=kk["fft_impl"],
        precision=kk["precision"], scene=[na, nr], batch=batch,
        ms=cuda_median_ms(lambda: ops.mega_spectral_op(xr, xi, *args, **kk),
                          queued=True),
        plain_ms=cuda_median_ms(lambda: ops.mega_spectral_op_plain(
            xr, xi, *args, **kk), queued=True),
        library_ms=cuda_median_ms(lambda: oracle.run(x), queued=True),
        bytes=nbytes, flops_nominal=flops,
        bound_ms=max(t_mem, t_ops),
        bound_by="bytes" if t_mem >= t_ops else "operations",
        per_phase_floor_ms=len(kk["segments"]) * 16 * xr.numel()
        / HBM_BYTES_PER_S * 1e3)
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    if kk["fft_impl"] == "matmul":
        mma = [mma_floor(sspec.n, *sspec.factors(),
                         batch * (na if seg.axis == 1 else nr),
                         int(seg.fwd) + int(seg.inv))
               for seg in spec.segments for sspec in [spec.seg_spec(seg)]]
        rec.update(mma_flops=sum(f for f, _ in mma),
                   mma_floor_ms=sum(t for _, t in mma))
    emit("time_kernel", nvidia_smi=smi_line, **rec)
    return rec


def time_spectral_launch(smi_line, step, xr, xi, x, variant="fused3"):
    """One spectral-kernel launch of ``variant``'s compiled plan on its own
    inputs,
    beside its bound (bytes over 3.35 TB/s vs nominal 5 N log2 N FLOP over
    67 TFLOP/s), its plain version and ``library_ms`` (torch.fft ->
    multiply -> torch.fft, timed only as a yardstick)."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import ops
    from repro_torch.kernels.fft4step import SpectralSpec, flops_nominal
    kk, fk = step.kernel_kw, step.filter_kw
    if kk["axis"] == 1:
        nlines, n = xr.shape[-2:]
    else:
        n, nlines = xr.shape[-2:]
    spec = SpectralSpec(n=n, fwd=kk["fwd"], filter_mode=kk["filter_mode"],
                        inv=kk["inv"], axis=kk["axis"],
                        fft_impl=kk["fft_impl"], precision=kk["precision"])
    nbytes = 4 * xr.numel() * 4 + sum(4 * t.numel() for t in fk.values())
    flops = flops_nominal(spec, nlines)
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    rec = dict(
        launch=step.name, variant=variant, fft_impl=kk["fft_impl"],
        precision=kk["precision"], axis=kk["axis"],
        mode=kk["filter_mode"], fwd=kk["fwd"], inv=kk["inv"],
        ms=cuda_median_ms(lambda: ops.spectral_op(xr, xi, **fk, **kk),
                          queued=True),
        plain_ms=cuda_median_ms(
            lambda: ops.spectral_op_plain(xr, xi, **fk, **kk), queued=True),
        library_ms=cuda_median_ms(lambda: planlib._torch_apply(
            x, kk["fwd"], kk["inv"], kk["filter_mode"], fk, kk["axis"]),
            queued=True),
        bytes=nbytes, flops_nominal=flops, bound_ms=max(t_mem, t_ops),
        bound_by="bytes" if t_mem >= t_ops else "operations")
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    if kk["fft_impl"] == "matmul":
        mma, mma_ms = mma_floor(n, *spec.factors(), nlines,
                                int(kk["fwd"]) + int(kk["inv"]))
        rec.update(mma_flops=mma, mma_floor_ms=mma_ms)
    emit("time_launch", nvidia_smi=smi_line, **rec)
    return rec


def step_inputs(pipe, x):
    """Run ``pipe``'s steps one by one: [(step, its input)], the output."""
    out = []
    for s in pipe.steps:
        out.append((s, x))
        x = s.fn(x)
    return out, x


def mega_phases(torch, dev, smi_line, cfg, raw, fused3_img, score, small,
                small_raw, fused3_pipe):
    """Phases 6-8 (the megakernels); returns their ``kernels`` records."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline, metrics, paper_targets
    from repro_torch.kernels import ops

    def split_err(a, b):
        return rel_err((a.real, a.imag), (b.real, b.imag))

    # ---- 6. each megakernel vs its plain version on the card --------------
    lib = ops._bind_mega()
    optin = lib.mega_smem_optin(dev.index or 0)
    check(optin == ops.SMEM_OPTIN_BYTES,
          f"shared-memory opt-in {optin} B, the cut assumes "
          f"{ops.SMEM_OPTIN_BYTES} B")
    rand = seeded_randn(torch, dev, 1)
    cases, worst, equal_pairs, o_cases, o_worst = mega_sweep(
        torch, ops, rand, "matmul")
    staged_smem = (ops.RESIDENT_MAX_POINTS * 8
                   + ops.dft_smem_bytes(64, 64))   # 4096^2, matmul
    emit("mega_kernel", cases=cases, max_rel_err=worst, tol=TOL,
         oracle_cases=o_cases, max_oracle_err=o_worst, oracle_tol=ORACLE_TOL,
         resident_equals_staged_cases=equal_pairs, smem_optin_bytes=optin,
         staged_smem_bytes=staged_smem,
         staged_blocks_per_sm=lib.mega_staged_blocks_per_sm(staged_smem, 0),
         sms=torch.cuda.get_device_properties(dev).multi_processor_count)

    # ---- 7. the main path through fused1 -----------------------------------
    pipe = build_pipeline(cfg, "fused1")
    check([s.kind for s in pipe.steps] == ["mega"] and pipe.dispatches == 1,
          "fused1 compiles to one mega step")
    step = pipe.steps[0]
    check(step.kernel_kw["residency"] == "staged", "4096^2 is staged")
    reset_launch_counts()
    img = pipe.run(raw)
    torch.cuda.synchronize()
    got_counts, want = launch_counts(mega_staged=1)
    check(got_counts == want, f"fused1 4096^2 launches {got_counts}")
    check(bool(torch.isfinite(img).all()), "fused1: non-finite image")
    rep_k = score(img)
    check(torch.equal(img, fused3_img), "fused1 != fused3 at 4096^2")
    seg_args = [t for a in step.seg_filter_args for t in a]
    xr, xi = planlib.split(raw)
    img_p = planlib.unsplit(*ops.mega_spectral_op_plain(
        xr, xi, *seg_args, **step.kernel_kw))
    torch.cuda.synchronize()
    dsnr = check_focus("fused1 vs plain", rep_k, score(img_p))
    staged_err, staged_rel = split_err(img, img_p)
    check(staged_rel <= TOL, f"fused1 vs plain: rel err {staged_rel:.3e}")
    emit("main", variant="fused1", scene=[cfg.na, cfg.nr],
         residency="staged", launches=got_counts, targets=rep_k,
         equal_to_fused3=True, snr_delta_db_vs_plain=dsnr,
         max_abs_err_vs_plain=staged_err, rel_err_vs_plain=staged_rel)
    del img, img_p, fused3_img

    small_f3 = build_pipeline(small, "fused3").run(small_raw)
    pipe_s = build_pipeline(small, "fused1")
    step_s = pipe_s.steps[0]
    check(step_s.kernel_kw["residency"] == "vmem", "128^2 is resident")
    reset_launch_counts()
    img_s = pipe_s.run(small_raw)
    torch.cuda.synchronize()
    small_counts, want = launch_counts(mega_resident=1)
    check(small_counts == want, f"fused1 128^2 launches {small_counts}")
    check(torch.equal(img_s, small_f3), "fused1 != fused3 at 128^2")
    staged_s = build_pipeline(small, "fused1", residency="staged").run(
        small_raw)
    check(torch.equal(img_s, staged_s), "resident != staged at 128^2")
    on_cpu = build_pipeline(small, "fused1", device="cpu").run(
        small_raw.cpu())
    _, cpu_rel = split_err(img_s.cpu(), on_cpu)
    check(cpu_rel <= TOL, f"128^2 fused1 card vs CPU: {cpu_rel:.3e}")
    sr, si = planlib.split(small_raw)
    seg_args_s = [t for a in step_s.seg_filter_args for t in a]
    img_sp = planlib.unsplit(*ops.mega_spectral_op_plain(
        sr, si, *seg_args_s, **step_s.kernel_kw))
    resident_err, _ = split_err(img_s, img_sp)
    peaks = [(r.row, r.col) for r in metrics.analyze_scene(
        img_s.cpu().numpy(), small, paper_targets(small))]
    emit("main", variant="fused1", scene=[small.na, small.nr],
         residency="vmem", launches=small_counts, equal_to_fused3=True,
         equal_to_staged=True, rel_err_vs_cpu=cpu_rel,
         max_abs_err_vs_plain=resident_err, peaks=peaks)

    # ---- 8. times -----------------------------------------------------------
    runs = {"fused3": [], "fused1": []}
    for variant in ("fused3", "fused1", "fused1", "fused3"):
        p = fused3_pipe if variant == "fused3" else pipe
        runs[variant].append(cuda_median_ms(lambda: p.run(raw)))
    emit("time_run", variant="fused1_vs_fused3", scene=[cfg.na, cfg.nr],
         order=["fused3", "fused1", "fused1", "fused3"],
         fused3_ms=runs["fused3"], fused1_ms=runs["fused1"],
         nvidia_smi=smi_line)

    t_staged = time_mega_kernel(torch, smi_line, "mega_staged", step, raw,
                                cfg)
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    reset_launch_counts()
    got = pipe_s.run(batch_raw)
    torch.cuda.synchronize()
    batch_counts, want_counts = launch_counts(mega_resident=1)
    check(batch_counts == want_counts, f"batch launches {batch_counts}")
    want = planlib.unsplit(*ops.mega_spectral_op_plain(
        *planlib.split(batch_raw), *seg_args_s, **step_s.kernel_kw))
    _, batch_rel = split_err(got, want)
    check(batch_rel <= TOL, f"resident batch vs plain: {batch_rel:.3e}")
    t_resident = time_mega_kernel(torch, smi_line, "mega_resident", step_s,
                                  batch_raw, small)
    small3 = build_pipeline(small, "fused3")
    batch_runs = {"fused3": [], "fused1": []}
    for variant in ("fused3", "fused1", "fused1", "fused3"):
        p = small3 if variant == "fused3" else pipe_s
        batch_runs[variant].append(cuda_median_ms(lambda: p.run(batch_raw)))
    emit("time_run", variant="fused1_vs_fused3", scene=[small.na, small.nr],
         batch=MEGA_BATCH, order=["fused3", "fused1", "fused1", "fused3"],
         fused3_ms=batch_runs["fused3"], fused1_ms=batch_runs["fused1"],
         rel_err_vs_plain=batch_rel, nvidia_smi=smi_line)

    def record(name, line, launches, err, t):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mega.cu",
                "replaces": f"src/repro/kernels/fft4step.py:{line}",
                "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    return [record("mega_resident", 931, small_counts["mega_resident"],
                   resident_err, t_resident),
            record("mega_staged", 1002, got_counts["mega_staged"],
                   staged_err, t_staged)]


def check_focus(name, rep, want=None, gate=GATE_DB):
    """All five targets within 8 px of their expected pixels at SNR > 30
    dB; with ``want`` (another image's score) the same peaks and |dSNR|
    <= ``gate``. Returns the |dSNR| list (empty without ``want``)."""
    for r in rep:
        off = r["wide_peak_offset"]
        check(max(abs(off[0]), abs(off[1])) <= 8,
              f"{name}: target peak {off} px from expected")
        check(r["snr_db"] > 30.0, f"{name}: SNR {r['snr_db']}")
    if want is None:
        return []
    check([r["peak"] for r in rep] == [r["peak"] for r in want],
          f"{name}: peaks differ")
    dsnr = [abs(a["snr_db"] - b["snr_db"]) for a, b in zip(rep, want)]
    check(max(dsnr) <= gate, f"{name}: dSNR {dsnr}")
    return dsnr


def l2_rel(torch, a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def baseline_phases(torch, dev, smi_line, cfg, raw, score, replay_plain,
                    small, small_raw, fused3_pipe, main_inputs, matmul_img):
    """Phases 9-13 (the paper's baselines: the tiled transpose and the
    8-launch ``fused`` RDA, the Stockham route of the spectral kernel and
    both megakernels); returns their ``kernels`` records."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops, transpose

    # ---- 9. the transpose kernel vs its plain version ---------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = 0
    for dtype in (torch.float32, torch.complex64):
        for shape in TRANSPOSE_SHAPES:
            for lead in ((), (2,)):
                x = torch.randn((*lead, *shape), generator=gen, device=dev,
                                dtype=dtype)
                got = transpose.transpose(x)
                torch.cuda.synchronize()
                check(torch.equal(got, transpose.transpose_plain(x)),
                      f"transpose {dtype} {(*lead, *shape)} != plain")
                cases += 1
    del x, got
    emit("transpose_kernel", cases=cases, shapes=TRANSPOSE_SHAPES,
         batches=[1, 2], dtypes=["float32", "complex64"], equal=True)

    # ---- 10. the Stockham route vs the plain versions ----------------------
    # bit for bit: pairing passes changes which thread computes a point,
    # never how; N = 16, 256, 4096 turn around in registers, 1024 has two
    # pairs and a lone pass, 128 a radix-4/radix-2 pair
    # and, as the matmul route, each N = 4096 case against the complex128
    # oracle, whose outer phase is rounded as the kernels round it
    s_cases, s_worst, so_cases, so_worst = spectral_sweep(
        torch, ops, seeded_randn(torch, dev, 3), "stockham",
        sizes=STOCKHAM_SIZES, exact=True)
    m_cases, m_worst, pairs, mo_cases, mo_worst = mega_sweep(
        torch, ops, seeded_randn(torch, dev, 4), "stockham", exact=True)
    emit("stockham_kernel", spectral_cases=s_cases, sizes=STOCKHAM_SIZES,
         spectral_max_rel_err=s_worst, mega_cases=m_cases,
         mega_max_rel_err=m_worst, resident_equals_staged_cases=pairs,
         equal_to_plain=True, spectral_oracle_cases=so_cases,
         spectral_max_oracle_err=so_worst, mega_oracle_cases=mo_cases,
         mega_max_oracle_err=mo_worst, oracle_tol=ORACLE_TOL)

    # ---- 11. the main path through fused -----------------------------------
    pipe = build_pipeline(cfg, "fused")
    check(pipe.dispatches == 8 and [s.kind for s in pipe.steps].count(
        "transpose") == 4, "fused compiles to 8 steps, 4 of them turns")
    reset_launch_counts()
    img = pipe.run(raw)
    torch.cuda.synchronize()
    fused_counts, want = launch_counts(spectral=3, transpose=4)
    check(fused_counts == want, f"fused launches {fused_counts}")
    check(bool(torch.isfinite(img).all()), "fused: non-finite image")
    rep_k = score(img)
    check_focus("fused", rep_k)
    img_u = build_pipeline(cfg, "unfused").run(raw)
    dsnr_u = check_focus("fused vs unfused", rep_k, score(img_u))
    l2_u = l2_rel(torch, img, img_u)
    del img_u
    img_p = replay_plain(pipe, raw)
    torch.cuda.synchronize()
    dsnr_p = check_focus("fused vs plain", rep_k, score(img_p))
    l2_p = l2_rel(torch, img, img_p)
    del img_p
    inputs, out = step_inputs(pipe, raw)
    check(torch.equal(out, img), "fused: a second run differs")
    for s, x in inputs:
        if s.kind == "transpose":
            check(torch.equal(transpose.transpose(x),
                              transpose.transpose_plain(x)),
                  f"fused turn {s.name}: kernel != plain")
    emit("main", variant="fused", scene=[cfg.na, cfg.nr],
         launches=fused_counts, targets=rep_k,
         snr_delta_db_vs_unfused=dsnr_u, l2_rel_vs_unfused=l2_u,
         snr_delta_db_vs_plain=dsnr_p, l2_rel_vs_plain=l2_p,
         turns_equal_to_plain=True)
    del img, out

    # ---- 12. the main path on the Stockham route ---------------------------
    st3 = build_pipeline(cfg, "fused3", fft_impl="stockham")
    reset_launch_counts()
    img3 = st3.run(raw)
    torch.cuda.synchronize()
    st_counts, want = launch_counts(spectral=3)
    check(st_counts == want, f"stockham fused3 launches {st_counts}")
    check(bool(torch.isfinite(img3).all()), "stockham fused3: non-finite")
    rep3 = score(img3)
    dsnr_m = check_focus("stockham fused3 vs matmul", rep3, score(matmul_img))
    l2_m = l2_rel(torch, img3, matmul_img)
    img_p = replay_plain(st3, raw)
    torch.cuda.synchronize()
    dsnr_p = check_focus("stockham fused3 vs plain", rep3, score(img_p))
    del img_p, matmul_img
    st_oracle = oracle_err(torch, (img3.real, img3.imag),
                           image_oracle(torch, st3, raw))
    check(st_oracle <= ORACLE_TOL,
          f"stockham fused3 4096^2 vs complex128: {st_oracle:.3e}")
    st_inputs = {}
    st_err = 0.0
    for s, x in step_inputs(st3, raw)[0]:
        xr, xi = planlib.split(x)
        st_inputs[s.name] = (s, xr, xi, x)
        got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
        want_p = ops.spectral_op_plain(xr, xi, **s.filter_kw, **s.kernel_kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want_p)
        check(rel <= TOL, f"stockham launch {s.name}: rel err {rel:.3e}")
        st_err = max(st_err, err)
    del got, want_p
    emit("main", variant="fused3", fft_impl="stockham",
         scene=[cfg.na, cfg.nr], launches=st_counts, targets=rep3,
         snr_delta_db_vs_matmul=dsnr_m, l2_rel_vs_matmul=l2_m,
         snr_delta_db_vs_plain=dsnr_p, max_abs_err_launches=st_err,
         oracle_rel_err=st_oracle, oracle_tol=ORACLE_TOL)

    st1 = build_pipeline(cfg, "fused1", fft_impl="stockham")
    check(st1.steps[0].kernel_kw["residency"] == "staged", "4096^2 staged")
    reset_launch_counts()
    img1 = st1.run(raw)
    torch.cuda.synchronize()
    st1_counts, want = launch_counts(mega_staged=1)
    check(st1_counts == want, f"stockham fused1 launches {st1_counts}")
    check(torch.equal(img1, img3), "stockham fused1 != stockham fused3")
    del img1, img3
    small3 = build_pipeline(small, "fused3", fft_impl="stockham").run(
        small_raw)
    st1s = build_pipeline(small, "fused1", fft_impl="stockham")
    check(st1s.steps[0].kernel_kw["residency"] == "vmem", "128^2 resident")
    reset_launch_counts()
    img1s = st1s.run(small_raw)
    torch.cuda.synchronize()
    st1s_counts, want = launch_counts(mega_resident=1)
    check(st1s_counts == want, f"stockham fused1 128^2 {st1s_counts}")
    check(torch.equal(img1s, small3), "stockham fused1 != fused3 at 128^2")
    staged_s = build_pipeline(small, "fused1", fft_impl="stockham",
                              residency="staged").run(small_raw)
    check(torch.equal(staged_s, small3), "stockham staged != fused3 128^2")
    emit("main", variant="fused1", fft_impl="stockham",
         launches_4096=st1_counts, launches_128=st1s_counts,
         equal_to_stockham_fused3=[True, True],
         staged_equal_to_stockham_fused3_128=True)

    # ---- 13. times ---------------------------------------------------------
    turns = []
    for s, x in inputs:
        if s.kind != "transpose":
            continue
        nbytes = 2 * x.numel() * x.element_size()
        rec = dict(
            step=s.name, shape=list(x.shape), dtype=str(x.dtype),
            ms=cuda_median_ms(lambda: transpose.transpose(x), queued=True),
            plain_ms=cuda_median_ms(lambda: transpose.transpose_plain(x),
                                    queued=True),
            library_ms=cuda_median_ms(
                lambda: x.transpose(-1, -2).contiguous(), queued=True),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
        emit("time_transpose", nvidia_smi=smi_line, **rec)
        turns.append(rec)
    spec_t = []
    for s, x in inputs:
        if s.kind == "spectral":
            xr, xi = planlib.split(x)
            spec_t.append(time_spectral_launch(smi_line, s, xr, xi, x,
                                               variant="fused"))
    sinc_step, sinc_x = next((s, x) for s, x in inputs
                             if s.kind == "sinc_rcmc")
    sinc_ms = cuda_median_ms(lambda: sinc_step.fn(sinc_x))
    fused_ms = cuda_median_ms(lambda: pipe.run(raw))
    steps_ms = (sum(r["ms"] for r in spec_t) + sum(r["ms"] for r in turns)
                + sinc_ms)
    emit("time_run", variant="fused", scene=[cfg.na, cfg.nr], ms=fused_ms,
         spectral_ms=[r["ms"] for r in spec_t],
         transpose_ms=[r["ms"] for r in turns], sinc_rcmc_ms=sinc_ms,
         split_unsplit_ms=fused_ms - steps_ms, nvidia_smi=smi_line)
    del inputs

    st_t = []
    for name, (s, xr, xi, x) in st_inputs.items():
        ms_, xr_m, xi_m, _ = main_inputs[name]
        mm = [cuda_median_ms(lambda: ops.spectral_op(
            xr_m, xi_m, **ms_.filter_kw, **ms_.kernel_kw), queued=True)]
        rec = time_spectral_launch(smi_line, s, xr, xi, x)
        mm.append(cuda_median_ms(lambda: ops.spectral_op(
            xr_m, xi_m, **ms_.filter_kw, **ms_.kernel_kw), queued=True))
        emit("time_route", launch=name, order=["matmul", "stockham",
                                               "matmul"],
             matmul_ms=mm, stockham_ms=rec["ms"], nvidia_smi=smi_line)
        st_t.append(rec)
    t_st_staged = time_mega_kernel(torch, smi_line, "mega_staged",
                                   st1.steps[0], raw, cfg)
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    reset_launch_counts()
    got = st1s.run(batch_raw)
    torch.cuda.synchronize()
    batch_counts, want = launch_counts(mega_resident=1)
    check(batch_counts == want, f"stockham batch launches {batch_counts}")
    step_s = st1s.steps[0]
    want_b = planlib.unsplit(*ops.mega_spectral_op_plain(
        *planlib.split(batch_raw),
        *[t for a in step_s.seg_filter_args for t in a], **step_s.kernel_kw))
    _, batch_rel = rel_err((got.real, got.imag), (want_b.real, want_b.imag))
    check(batch_rel <= TOL, f"stockham resident batch: {batch_rel:.3e}")
    del got, want_b
    t_st_resident = time_mega_kernel(torch, smi_line, "mega_resident",
                                     step_s, batch_raw, small)
    runs = {"matmul": [], "stockham": []}
    for route in ("matmul", "stockham", "stockham", "matmul"):
        p = fused3_pipe if route == "matmul" else st3
        runs[route].append(cuda_median_ms(lambda: p.run(raw)))
    emit("time_run", variant="fused3_matmul_vs_stockham",
         scene=[cfg.na, cfg.nr],
         order=["matmul", "stockham", "stockham", "matmul"],
         matmul_ms=runs["matmul"], stockham_ms=runs["stockham"],
         nvidia_smi=smi_line)

    def total(recs, key):
        return sum(r[key] for r in recs)

    return [
        {"name": "transpose", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/transpose.cu",
         "replaces": "src/repro/kernels/transpose.py:26",
         "also_replaces": "src/repro/kernels/transpose.py:30",
         "launches": fused_counts["transpose"], "max_abs_err": 0.0,
         "ms": total(turns, "ms"), "plain_ms": total(turns, "plain_ms"),
         "bound_ms": total(turns, "bound_ms"), "bound_by": "bytes",
         "library_ms": total(turns, "library_ms")},
        {"name": "stockham", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spectral.cu",
         "device_code": "src/repro_torch/kernels/csrc/spectral_common.cuh",
         "replaces": "src/repro/kernels/fft4step.py:422",
         "launches": st_counts["spectral"], "max_abs_err": st_err,
         "ms": total(st_t, "ms"), "plain_ms": total(st_t, "plain_ms"),
         "bound_ms": total(st_t, "bound_ms"),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in st_t)
         else "operations",
         "library_ms": total(st_t, "library_ms"),
         "mega_staged_ms": t_st_staged["ms"],
         "mega_staged_launches": st1_counts["mega_staged"],
         "mega_resident_ms": t_st_resident["ms"],
         "mega_resident_launches": st1s_counts["mega_resident"]},
    ]


# CSA and omega-K: each three-launch variant and its one-launch twin
FAMILIES = {"csa_fused": "csa_fused1", "omegak": "omegak_fused1"}
PRECISION_VARIANTS = ("fused3", "fused1", "csa_fused", "csa_fused1", "omegak",
                      "omegak_fused1")
NARROW = ("bf16", "f16", "bs16")      # the Stockham route's other precisions
BS16_CHAINS = (((0, True, False, "full"), (1, True, True, "full"),
                (0, False, True, "full")),
               ((1, False, False, "full"), (0, True, True, "shared"),
                (1, False, False, "outer")))


def replay_mega_plain(step, x):
    """One mega step through ``mega_spectral_op_plain`` on x's device."""
    from repro_torch.core import plan as planlib
    from repro_torch.kernels import ops
    return planlib.unsplit(*ops.mega_spectral_op_plain(
        *planlib.split(x), *[t for a in step.seg_filter_args for t in a],
        **step.kernel_kw))


def family_phases(torch, smi_line, cfg, raw, score, replay_plain, small,
                  small_raw):
    """Phase 14: CSA and omega-K on the paper's scene on both FFT routes,
    and on 132 scenes of 128^2 through ``mega_resident``. Returns the
    ``kernels`` records, the Stockham images (for phase 15) and the
    seconds the screens took to build."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops

    # the screens (three float64 4096^2 screens for CSA, one for omega-K),
    # built on the host once per (cfg, plan) and kept on the card by the
    # compiler's caches: before any timed window
    t0 = time.perf_counter()
    base = build_pipeline(cfg, "csa")        # torch backend: the baseline
    pipes = {(v, r): build_pipeline(cfg, v, fft_impl=r)
             for r in ("matmul", "stockham")
             for three, one in FAMILIES.items() for v in (three, one)}
    torch.cuda.synchronize()
    screens_s = time.perf_counter() - t0
    check(base.dispatches == 7 and all(
        p.dispatches == (1 if v.endswith("fused1") else 3)
        for (v, _), p in pipes.items()), "CSA / omega-K dispatches")
    reset_launch_counts()
    img_base = base.run(raw)
    torch.cuda.synchronize()
    base_counts, want = launch_counts()
    check(base_counts == want, f"csa (torch backend) launches {base_counts}")
    rep_base = score(img_base)
    emit("main", variant="csa", backend="torch", scene=[cfg.na, cfg.nr],
         launches=base_counts, targets=rep_base, screens_seconds=screens_s)
    check_focus("csa", rep_base)
    del img_base

    images = {}
    records = []
    for fft_impl in ("matmul", "stockham"):
        for three, one in FAMILIES.items():
            p3, p1 = pipes[(three, fft_impl)], pipes[(one, fft_impl)]
            reset_launch_counts()
            img3 = p3.run(raw)
            torch.cuda.synchronize()
            counts3, want = launch_counts(spectral=3)
            check(counts3 == want, f"{three} ({fft_impl}) launches {counts3}")
            check(bool(torch.isfinite(img3).all()), f"{three}: non-finite")
            rep3 = score(img3)
            emit("main", variant=three, fft_impl=fft_impl,
                 scene=[cfg.na, cfg.nr], launches=counts3, targets=rep3)
            img_p = replay_plain(p3, raw)
            torch.cuda.synchronize()
            dsnr_p = check_focus(f"{three} ({fft_impl}) vs plain", rep3,
                                 score(img_p))
            del img_p
            dsnr_b = (check_focus(f"{three} ({fft_impl}) vs csa", rep3,
                                  rep_base)
                      if three == "csa_fused" else None)
            # where every transform of the chain has 4096 points, the
            # Stockham route's mega_staged takes its specialisation
            # (csrc/mega.cu: transform_n == 4096)
            step1 = p1.steps[0]
            check(step1.kernel_kw["residency"] == "staged", f"{one}: staged")
            reset_launch_counts()
            img1 = p1.run(raw)
            torch.cuda.synchronize()
            counts1, want = launch_counts(mega_staged=1)
            check(counts1 == want, f"{one} ({fft_impl}) launches {counts1}")
            check(torch.equal(img1, img3), f"{one} != {three} ({fft_impl})")
            img1_p = replay_mega_plain(step1, raw)
            err1, rel1 = rel_err((img1.real, img1.imag),
                                 (img1_p.real, img1_p.imag))
            check(rel1 <= TOL, f"{one} ({fft_impl}) vs plain: {rel1:.3e}")
            del img1_p
            launch_err = 0.0
            timed = []
            for s, x in step_inputs(p3, raw)[0]:
                xr, xi = planlib.split(x)
                got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
                want_p = ops.spectral_op_plain(xr, xi, **s.filter_kw,
                                               **s.kernel_kw)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want_p)
                check(rel <= TOL and (fft_impl == "matmul" or all(
                    torch.equal(g, w) for g, w in zip(got, want_p))),
                      f"{three} launch {s.name} ({fft_impl}): {rel:.3e}")
                launch_err = max(launch_err, err)
                del got, want_p
                timed.append(time_spectral_launch(smi_line, s, xr, xi, x,
                                                  variant=three))
            t1 = time_mega_kernel(torch, smi_line, "mega_staged", step1, raw,
                                  cfg, variant=one)
            runs = {three: [], one: []}
            for v in (three, one, one, three):
                p = p3 if v == three else p1
                runs[v].append(cuda_median_ms(lambda: p.run(raw)))
            emit("main", variant=one, fft_impl=fft_impl,
                 scene=[cfg.na, cfg.nr], launches=counts1,
                 specialised_4096=cfg.na == cfg.nr == 4096,
                 equal_to_three_launches=True, targets=rep3,
                 snr_delta_db_vs_plain=dsnr_p, snr_delta_db_vs_csa=dsnr_b,
                 max_abs_err_launches=launch_err, rel_err_fused1_vs_plain=rel1)
            emit("time_run", variant=f"{three}_vs_{one}", fft_impl=fft_impl,
                 scene=[cfg.na, cfg.nr], order=[three, one, one, three],
                 **{f"{three}_ms": runs[three], f"{one}_ms": runs[one]},
                 launch_ms_sum=sum(r["ms"] for r in timed),
                 launch_library_ms_sum=sum(r["library_ms"] for r in timed),
                 nvidia_smi=smi_line)
            if fft_impl == "stockham":
                images[three] = img3
            del img1
            records.append(kernel_record(
                "spectral", three, fft_impl, counts3["spectral"], launch_err,
                timed))
            records.append(kernel_record(
                "mega_staged", one, fft_impl, counts1["mega_staged"], err1,
                [t1]))

    # one scene of 128^2 per SM through mega_resident, beside its twin
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    for fft_impl in ("matmul", "stockham"):
        for three, one in FAMILIES.items():
            img3 = build_pipeline(small, three, fft_impl=fft_impl).run(
                batch_raw)
            p1 = build_pipeline(small, one, fft_impl=fft_impl)
            check(p1.steps[0].kernel_kw["residency"] == "vmem", "resident")
            reset_launch_counts()
            img1 = p1.run(batch_raw)
            torch.cuda.synchronize()
            counts, want = launch_counts(mega_resident=1)
            check(counts == want, f"{one} 132 x 128^2 launches {counts}")
            check(torch.equal(img1, img3),
                  f"{one} != {three} on 132 x 128^2 ({fft_impl})")
            want_p = replay_mega_plain(p1.steps[0], batch_raw)
            err, rel = rel_err((img1.real, img1.imag),
                               (want_p.real, want_p.imag))
            check(rel <= TOL, f"{one} 132 x 128^2 vs plain: {rel:.3e}")
            t = time_mega_kernel(torch, smi_line, "mega_resident",
                                 p1.steps[0], batch_raw, small, variant=one)
            emit("main", variant=one, fft_impl=fft_impl,
                 scene=[small.na, small.nr], batch=MEGA_BATCH,
                 launches=counts, equal_to_three_launches=True,
                 rel_err_vs_plain=rel)
            records.append(kernel_record("mega_resident", one, fft_impl,
                                         counts["mega_resident"], err, [t]))
            del img1, img3, want_p
    return records, images, screens_s


def kernel_precisions(name):
    """What a ``kernels`` entry's kernel runs: precisions by FFT route
    (``ops.KERNEL_PRECISIONS``; the ``stockham`` entry is that route of
    the spectral kernel), or the transpose's element types."""
    from repro_torch.kernels import ops
    if name == "transpose":
        return {"elements": ["float32", "complex64"]}
    routes = ("stockham",) if name == "stockham" else ops.FFT_IMPLS
    return {r: list(ops.KERNEL_PRECISIONS[r]) for r in routes}


def kernel_record(name, variant, fft_impl, launches, err, timed):
    """One ``kernels`` entry for a kernel on a path of phase 14 or 15: the
    sums over the path's launches of that kernel."""
    source = "spectral.cu" if name == "spectral" else "mega.cu"
    line = {"spectral": 598, "mega_resident": 931, "mega_staged": 1002}[name]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/fft4step.py:{line}",
            "path": variant, "fft_impl": fft_impl,
            "precision": timed[0]["precision"],
            "launches": launches, "max_abs_err": err,
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in timed) else "operations",
            "library_ms": sum(r["library_ms"] for r in timed)}


def subnormal_lines(torch, x, axis):
    """Odd lines times 1e-40 (subnormal floats), beside unit-scale lines:
    where the bs16 codec changes a result on the Stockham route."""
    scale = torch.ones(x[0].shape[-2 if axis == 1 else -1],
                       device=x[0].device)
    scale[1::2] = 1e-40
    view = (-1, 1) if axis == 1 else (1, -1)
    return [t * scale.view(view) for t in x]


def precision_sweeps(torch, ops, dev):
    """Phase 15a: the Stockham route at bf16, f16 and bs16 against the
    plain versions: the spectral kernel at ``STOCKHAM_SIZES`` (every filter
    mode x axis x fwd/inv, B = 2, 37 lines, odd lines subnormal) and both
    megakernels over ``mega_chains()`` and ``BS16_CHAINS`` on the shapes up
    to 256^2 (a unit-scale scene beside a subnormal one). bs16 equals its
    plain version bit for bit and differs from f32 where values are
    subnormal alone (a round trip with nothing between, fwd+inv unfiltered,
    may land on the input's subnormal grid either way, so it is counted
    apart); bf16 and f16 equal f32."""
    from repro_torch.kernels.fft4step import FILTER_MODES
    rand = seeded_randn(torch, dev, 5)
    lines, rank = 37, 2
    cases = differ = trips = trips_differ = 0
    for n in STOCKHAM_SIZES:
        for axis in (0, 1):
            scene = (lines, n) if axis == 1 else (n, lines)
            x = subnormal_lines(torch, (rand(2, *scene), rand(2, *scene)),
                                axis)
            normal = (slice(None), slice(0, None, 2)) if axis == 1 else \
                (slice(None), slice(None), slice(0, None, 2))
            for mode in FILTER_MODES:
                filt = {}
                if mode in ("shared", "shared_outer"):
                    filt.update(hr=rand(n), hi=rand(n))
                if mode == "full":
                    filt.update(hr=rand(*scene), hi=rand(*scene))
                if mode in ("outer", "shared_outer"):
                    filt.update(u=rand(lines, rank), v=rand(n, rank))
                for fwd, inv in ((True, False), (False, True), (True, True),
                                 (False, False)):
                    if mode == "none" and not (fwd or inv):
                        continue
                    kw = dict(axis=axis, fwd=fwd, inv=inv, filter_mode=mode,
                              block=1, fft_impl="stockham")
                    f32 = ops.spectral_op(*x, **filt, **kw)
                    got = ops.spectral_op(*x, **filt, precision="bs16", **kw)
                    want = ops.spectral_op_plain(*x, **filt,
                                                 precision="bs16", **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"bs16 kernel != plain {kw} n={n}")
                    check(all(torch.equal(g[normal], w[normal])
                              for g, w in zip(got, f32)),
                          f"bs16 != f32 on unit-scale lines {kw} n={n}")
                    changed = not all(torch.equal(g, w)
                                      for g, w in zip(got, f32))
                    if mode == "none" and fwd and inv:
                        trips += 1
                        trips_differ += changed
                    else:
                        differ += changed
                    for precision in ("bf16", "f16"):
                        narrow = ops.spectral_op(*x, **filt,
                                                 precision=precision, **kw)
                        check(all(torch.equal(g, w)
                                  for g, w in zip(narrow, f32)),
                              f"{precision} != f32 {kw} n={n}")
                    cases += 1
    check(differ == cases - trips, f"bs16 equals f32 on subnormal lines in "
          f"{cases - trips - differ} of {cases - trips} cases")
    m_cases = m_pairs = 0
    for na, nr in MEGA_SHAPES[:-1]:
        for segments in mega_chains() + list(BS16_CHAINS):
            x = [rand(2, na, nr), rand(2, na, nr)]
            for t in x:
                t[1] *= 1e-40
            args = []
            for axis, _fwd, _inv, mode in segments:
                n, nl = (nr, na) if axis == 1 else (na, nr)
                if mode in ("shared", "shared_outer"):
                    args += [rand(n), rand(n)]
                if mode == "full":
                    args += [rand(na, nr), rand(na, nr)]
                if mode in ("outer", "shared_outer"):
                    args += [rand(nl, 2), rand(n, 2)]
            kw = dict(segments=segments, fft_impl="stockham")
            want = ops.mega_spectral_op_plain(*x, *args, precision="bs16",
                                              **kw)
            outs = []
            for residency in ("vmem", "staged"):
                if residency == "vmem" and \
                        ops.mega_residency(na, nr) != "vmem":
                    continue
                got = ops.mega_spectral_op(*x, *args, residency=residency,
                                           precision="bs16", **kw)
                f32 = ops.mega_spectral_op(*x, *args, residency=residency,
                                           **kw)
                torch.cuda.synchronize()
                where = f"{residency} {segments} {na}x{nr}"
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"bs16 megakernel != plain {where}")
                check(all(torch.equal(g[0], w[0]) for g, w in zip(got, f32))
                      and not all(torch.equal(g[1], w[1])
                                  for g, w in zip(got, f32)),
                      f"bs16 vs f32 megakernel {where}")
                for precision in ("bf16", "f16"):
                    narrow = ops.mega_spectral_op(
                        *x, *args, residency=residency, precision=precision,
                        **kw)
                    check(all(torch.equal(g, w)
                              for g, w in zip(narrow, f32)),
                          f"{precision} megakernel != f32 {where}")
                outs.append(got)
                m_cases += 1
            if len(outs) == 2:
                check(all(torch.equal(a, b) for a, b in zip(*outs)),
                      f"bs16 resident != staged {segments} {na}x{nr}")
                m_pairs += 1
    emit("precision_kernel", fft_impl="stockham", precisions=list(NARROW),
         spectral_cases=cases, bs16_differs_from_f32_cases=differ,
         round_trips=trips, round_trips_differing=trips_differ,
         sizes=STOCKHAM_SIZES, mega_cases=m_cases,
         resident_equals_staged_cases=m_pairs, equal_to_plain=True)


def precision_phases(torch, smi_line, cfg, raw, score, replay_plain, small,
                     small_raw, f32_images):
    """Phase 15b: every main-path variant on the Stockham route at bf16,
    f16 and bs16 on the paper's scene (and fused1 / fused3 on 128^2):
    launch counts, ``torch.equal`` to the plain version on the card,
    within 0.1 dB of the f32 image; each bs16 launch timed. Returns the
    ``kernels`` records of the bs16 paths."""
    from repro_torch.core.sar import build_pipeline
    from repro_torch.core import plan as planlib
    records = []
    for variant in PRECISION_VARIANTS:
        one = variant.endswith("fused1")
        f32_img = f32_images[variant]
        rep_f32 = score(f32_img)
        for precision in NARROW:
            pipe = build_pipeline(cfg, variant, fft_impl="stockham",
                                  precision=precision)
            reset_launch_counts()
            img = pipe.run(raw)
            torch.cuda.synchronize()
            counts, want = (launch_counts(mega_staged=1) if one
                            else launch_counts(spectral=3))
            check(counts == want, f"{variant} {precision} launches {counts}")
            check(bool(torch.isfinite(img).all()),
                  f"{variant} {precision}: non-finite")
            plain = (replay_mega_plain(pipe.steps[0], raw) if one
                     else replay_plain(pipe, raw))
            torch.cuda.synchronize()
            check(torch.equal(img, plain), f"{variant} {precision} != plain")
            rep = score(img)
            dsnr = check_focus(f"{variant} {precision} vs f32", rep, rep_f32)
            emit("main", variant=variant, fft_impl="stockham",
                 precision=precision, scene=[cfg.na, cfg.nr],
                 launches=counts, equal_to_plain=True,
                 equal_to_f32=torch.equal(img, f32_img),
                 snr_delta_db_vs_f32=dsnr)
            if precision == "bs16":
                if one:
                    timed = [time_mega_kernel(
                        torch, smi_line, "mega_staged", pipe.steps[0], raw,
                        cfg, variant=variant)]
                else:
                    timed = []
                    for s, x in step_inputs(pipe, raw)[0]:
                        xr, xi = planlib.split(x)
                        timed.append(time_spectral_launch(
                            smi_line, s, xr, xi, x, variant=variant))
                records.append(kernel_record(
                    "mega_staged" if one else "spectral", variant,
                    "stockham", counts["mega_staged" if one else "spectral"],
                    0.0, timed))
            del img, plain
    # the resident megakernel at bs16 on one 128^2 scene per SM, beside the
    # same kernel at f32 in this call
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    for variant in ("fused1", "csa_fused1", "omegak_fused1"):
        timed = {}
        for precision in ("f32", "bs16", "bs16", "f32"):
            pipe = build_pipeline(small, variant, fft_impl="stockham",
                                  precision=precision)
            reset_launch_counts()
            img = pipe.run(batch_raw)
            torch.cuda.synchronize()
            counts, want = launch_counts(mega_resident=1)
            check(counts == want, f"{variant} 132 x 128^2 {precision}")
            check(torch.equal(img, replay_mega_plain(pipe.steps[0],
                                                     batch_raw)),
                  f"{variant} 132 x 128^2 {precision} != plain")
            timed.setdefault(precision, []).append(time_mega_kernel(
                torch, smi_line, "mega_resident", pipe.steps[0], batch_raw,
                small, variant=variant))
        records.append(kernel_record("mega_resident", variant, "stockham",
                                     counts["mega_resident"], 0.0,
                                     timed["bs16"][:1]))
        emit("time_run", variant=f"{variant}_f32_vs_bs16",
             scene=[small.na, small.nr], batch=MEGA_BATCH,
             order=["f32", "bs16", "bs16", "f32"],
             f32_ms=[t["ms"] for t in timed["f32"]],
             bs16_ms=[t["ms"] for t in timed["bs16"]], nvidia_smi=smi_line)
    small_f32 = build_pipeline(small, "fused3", fft_impl="stockham").run(
        small_raw)
    for precision in NARROW:
        kw = dict(fft_impl="stockham", precision=precision)
        f3 = build_pipeline(small, "fused3", **kw).run(small_raw)
        pipe = build_pipeline(small, "fused1", **kw)
        reset_launch_counts()
        img = pipe.run(small_raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(mega_resident=1)
        check(counts == want, f"fused1 128^2 {precision} launches {counts}")
        check(torch.equal(img, f3), f"fused1 != fused3 128^2 {precision}")
        check(torch.equal(img, replay_mega_plain(pipe.steps[0], small_raw)),
              f"fused1 128^2 {precision} != plain")
        emit("main", variant="fused1", fft_impl="stockham",
             precision=precision, scene=[small.na, small.nr],
             launches=counts, equal_to_fused3=True, equal_to_plain=True,
             equal_to_f32=torch.equal(img, small_f32))
    return records


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import (build_pipeline, metrics, paper_scene,
                                      paper_targets, simulate)
    from repro_torch.core.sar.geometry import test_scene as small_scene
    from repro_torch.kernels import _build, ops, transpose

    # ---- 1. device ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi_line, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # ---- 2. build ----------------------------------------------------------
    # forced: every source compiles again, so the ptxas report is there on
    # a second run in the same checkout too
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True, force=True)
    build_s = time.perf_counter() - t0
    check(set(logs) >= {"spectral", "mega", "transpose"},
          f"built {sorted(logs)}")
    ptxas = {}
    hmma = {}
    for name, log in logs.items():
        ptxas.update(ptxas_report(log))
        hmma.update(sass_hmma_tf32(_build.lib_path(name)))
    for kernel in MMA_KERNELS:
        check(hmma.get(kernel, 0) > 0, f"{kernel}: no HMMA TF32 in its SASS")
    emit("build", seconds=build_s, sources=sorted(_build.sources()),
         ptxas=ptxas, hmma_tf32=hmma)

    # ---- 3. kernel vs plain version on the card ----------------------------
    cases, worst, o_cases, o_worst = spectral_sweep(
        torch, ops, seeded_randn(torch, dev, 0), "matmul")
    emit("kernel", cases=cases, max_rel_err=worst, tol=TOL,
         oracle_cases=o_cases, max_oracle_err=o_worst, oracle_tol=ORACLE_TOL)

    # ---- 4. the main path at the paper's size ------------------------------
    cfg = paper_scene()
    targets = paper_targets(cfg)
    raw = simulate(cfg, targets)
    torch.cuda.synchronize()
    check(raw.shape == (cfg.na, cfg.nr) and raw.device.type == "cuda",
          "simulated scene shape/device")

    def replay_plain(pipe, x):
        """The compiled steps through the plain versions, on the card: a
        spectral step through ``spectral_op_plain``, a transpose through
        ``transpose_plain``, the sinc RCMC (plain PyTorch already) through
        its own ``fn``."""
        for s in pipe.steps:
            if s.kind == "spectral":
                xr, xi = planlib.split(x)
                x = planlib.unsplit(*ops.spectral_op_plain(
                    xr, xi, **s.filter_kw, **s.kernel_kw))
            elif s.kind == "transpose":
                x = transpose.transpose_plain(x)
            else:
                x = s.fn(x)
        return x

    def score(img):
        mag = img.abs().cpu().numpy()
        reps = metrics.analyze_scene(img.cpu().numpy(), cfg, targets)
        out = []
        for t, rep in zip(targets, reps):
            er, ec = metrics.expected_pixel(cfg, t)
            rows = [(er + d) % cfg.na for d in range(-SEARCH, SEARCH + 1)]
            cols = [(ec + d) % cfg.nr for d in range(-SEARCH, SEARCH + 1)]
            win = mag[rows][:, cols]
            i, j = divmod(int(win.argmax()), win.shape[1])
            out.append(dict(expected=[er, ec], peak=[rep.row, rep.col],
                            wide_peak_offset=[i - SEARCH, j - SEARCH],
                            snr_db=rep.snr_db))
        return out

    main_inputs = {}
    results = {}
    images = {}
    for variant, want_launches in (("fused3", 3), ("fused_tfree", 4)):
        pipe = build_pipeline(cfg, variant)
        check(pipe.dispatches == want_launches, f"{variant} dispatches")
        reset_launch_counts()
        img = pipe.run(raw)
        torch.cuda.synchronize()
        got_counts, want = launch_counts(spectral=want_launches)
        check(got_counts == want, f"{variant}: launches {got_counts}")
        launches = got_counts["spectral"]
        check(bool(torch.isfinite(img).all()), f"{variant}: non-finite image")
        rep_k = score(img)
        img_p = replay_plain(pipe, raw)
        torch.cuda.synchronize()
        dsnr = check_focus(f"{variant} vs plain", rep_k, score(img_p))
        l2 = l2_rel(torch, img, img_p)
        results[variant] = dict(launches=launches, targets=rep_k,
                                snr_delta_db_vs_plain=dsnr,
                                l2_rel_vs_plain=l2)
        images[variant] = img
        emit("main", variant=variant, scene=[cfg.na, cfg.nr], **results[
            variant])
        if variant == "fused3":
            # each launch's own inputs, for phase 5 and the kernel line
            x = raw
            for s in pipe.steps:
                xr, xi = planlib.split(x)
                main_inputs[s.name] = (s, xr, xi, x)
                yr, yi = ops.spectral_op(xr, xi, **s.filter_kw,
                                         **s.kernel_kw)
                x = planlib.unsplit(yr, yi)
            fused3_pipe = pipe
    del img, img_p, images["fused_tfree"]

    # the 4096^2 image against the same plan in complex128 (fused1 is held
    # torch.equal to this image in phase 7)
    want = image_oracle(torch, fused3_pipe, raw)
    img3 = images["fused3"]
    main_oracle = oracle_err(torch, (img3.real, img3.imag), want)
    check(main_oracle <= ORACLE_TOL,
          f"fused3 4096^2 vs complex128: {main_oracle:.3e}")
    emit("main_oracle", variant="fused3", scene=[cfg.na, cfg.nr],
         rel_err=main_oracle, tol=ORACLE_TOL)
    del want, img3

    main_err = 0.0
    for name, (s, xr, xi, _x) in main_inputs.items():
        got = ops.spectral_op(xr, xi, **s.filter_kw, **s.kernel_kw)
        want = ops.spectral_op_plain(xr, xi, **s.filter_kw, **s.kernel_kw)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        check(rel <= TOL, f"main-path launch {name}: rel err {rel:.3e}")
        main_err = max(main_err, err)
    emit("main_launches", max_abs_err=main_err, tol=TOL)

    small = small_scene(128)
    small_raw = simulate(small, paper_targets(small))
    on_card = build_pipeline(small, "fused3").run(small_raw).cpu()
    on_cpu = build_pipeline(small, "fused3", device="cpu").run(
        small_raw.cpu())
    _, small_rel = rel_err((on_card.real, on_card.imag),
                           (on_cpu.real, on_cpu.imag))
    small_peaks = [
        [(r.row, r.col) for r in metrics.analyze_scene(
            im.numpy(), small, paper_targets(small))]
        for im in (on_card, on_cpu)]
    check(small_rel <= TOL and small_peaks[0] == small_peaks[1],
          f"128^2 fused3 card vs CPU: rel err {small_rel:.3e}")
    emit("small_reference", scene=[128, 128], rel_err_vs_cpu=small_rel,
         peaks=small_peaks[0])

    # ---- 5. times ----------------------------------------------------------
    launches_t = [time_spectral_launch(smi_line, s, xr, xi, x)
                  for s, xr, xi, x in main_inputs.values()]
    run_ms = cuda_median_ms(lambda: fused3_pipe.run(raw))
    total = {k: sum(r[k] for r in launches_t)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "mma_floor_ms")}
    emit("time_run", variant="fused3", ms=run_ms, nvidia_smi=smi_line,
         launch_ms_sum=total["ms"], launch_sums=total,
         launch_vs_library=total["ms"] / total["library_ms"])
    t_mem = sum(r["bytes"] for r in launches_t) / HBM_BYTES_PER_S * 1e3
    kernels = [{
        "name": "spectral",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spectral.cu",
        "replaces": "src/repro/kernels/fft4step.py:598",
        "launches": results["fused3"]["launches"],
        "max_abs_err": main_err,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if t_mem >= total["bound_ms"] - 1e-12
        else "operations",
        "library_ms": total["library_ms"],
        "oracle_rel_err": main_oracle,
    }]
    kernels += mega_phases(torch, dev, smi_line, cfg, raw, images["fused3"],
                           score, small, small_raw, fused3_pipe)
    kernels += baseline_phases(torch, dev, smi_line, cfg, raw, score,
                               replay_plain, small, small_raw, fused3_pipe,
                               main_inputs, images.pop("fused3"))

    # ---- 14. CSA and omega-K ------------------------------------------------
    records, f32_images, _ = family_phases(
        torch, smi_line, cfg, raw, score, replay_plain, small, small_raw)
    kernels += records

    # ---- 15. bf16 / f16 / bs16 on the Stockham route ------------------------
    precision_sweeps(torch, ops, dev)
    f32_images["fused3"] = build_pipeline(cfg, "fused3",
                                          fft_impl="stockham").run(raw)
    f32_images["fused1"] = f32_images["fused3"]
    f32_images["csa_fused1"] = f32_images["csa_fused"]
    f32_images["omegak_fused1"] = f32_images["omegak"]
    kernels += precision_phases(torch, smi_line, cfg, raw, score,
                                replay_plain, small, small_raw, f32_images)
    for k in kernels:
        k["precisions"] = kernel_precisions(k["name"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
