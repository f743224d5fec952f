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
             out-of-line Stockham op, 'kernel/stockham_n<layout,N,...>')
             and each source's seconds (all compile at once; the matmul
             route's operand forms of the megakernels build from
             ``mega.cu`` into a library of their own, ``mega_forms.cu``);
             ``cuobjdump -sass`` must show HMMA TF32 instructions in the
             matmul instantiations of ``spectral_kernel``,
             ``mega_resident`` and ``mega_staged`` (the tensor-core
             stage), and HMMA BF16 / F16 in the bf16 / f16 / bs16 ones.
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

16. tuning — the matmul route's operand forms and the tuner that drives
             them: (1) f32 with Karatsuba, bf16, f16, bs16 and bs16 with
             Karatsuba through phase 3's grid (both splits at N = 4096,
             odd lines subnormal for bs16) and phase 6's chains (f16's up
             to 256^2: a random 4096^2 chain overflows f16 in the plain
             version too), each within ``FORM_TOL`` of its plain version,
             resident == staged, f32 with Karatsuba within 1e-5 of
             complex128 at N = 4096; (2) fused3 and fused1 at 4096^2 and
             fused1 at 128^2 at bf16, f16, bs16 and with Karatsuba (launch
             counts, five targets within 8 px and |dSNR| <= 0.1 dB against
             the f32 image and the plain replay where the image is finite,
             fused1 == fused3 and resident == staged bit for bit); (3)
             ``search_kernel`` at N = 4096 over f32 / bf16 / bs16 behind
             the SNR gate, its cache in a temporary directory, strictly
             fewer candidates timed than the space holds, the winner
             persisted and compiled by ``build_pipeline``'s default
             ``tune="cached"`` into every fused3 launch; ``search_schedule``
             for fused1 at 4096^2 and 128^2, fused1 through each winner
             ``torch.equal`` to the same knobs given by hand, and a
             schedule whose azimuth and range segments split differently
             reaching ``mega_staged``; (4) each fused3 launch and both
             megakernels at bf16, bs16 and f32 with Karatsuba beside f32,
             in turns, with bounds, ``mma_floor_ms``, plain and library
             times.

17. service — the port's streaming executor and focusing service: (1)
             ``run_streamed(raw, strips=4)`` at 4096^2 for fused3 on both
             routes, ``csa_fused`` and ``unfused``, each bit-equal to
             ``run`` in 3 x 4 spectral launches (``unfused``: the torch
             backend, none), timed on the host clock against ``run`` from
             the card and from the host; ``fused`` and ``fused1`` refused;
             (2) ``FocusService(ServiceConfig())`` on the card, warmed,
             its bs16 gate measured: 16 default-tier 128^2 requests in one
             burst (only ``mega_resident`` launches, one a batch, each
             reply bit-equal to fused1 at the tier the gate admitted), then
             4096^2 f32 requests (3 spectral launches, five targets within
             8 px, bit-equal to fused3), then the same scene over
             ``device_budget_bytes`` on the stream lane (3 x 4 launches,
             bit-equal to in memory); per-request latency p50 / p99 beside
             ``Pipeline.run`` alone; no request off tier 0; (3) the seeded
             chaos replay (dispatch error, NaN output, lane hang) at 128^2:
             0 lost requests; (4) the service paths' launches timed
             beside their plain versions and bounds.

The line before the last lists each kernel — on the main path and on each
path of phases 14 to 17, with the precisions and Karatsuba flags it runs
on each route; the last line is
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
BF16_FLOP_PER_S = 989e12       # H100 SXM spec sheet, dense BF16 / FP16
TF32_PASSES = 3                # the matmul route's 3xTF32 split
TOL = 2e-4                     # x max|want| (tests/test_kernels.py)
# The matmul route's operand forms against their plain versions
# (tests/test_torch_cuda.py states the same): f32 keeps TOL; bf16 / f16 /
# bs16 differ only in the order of f32 accumulation and where a reordered
# sum rounds to the other 16-bit neighbour at a later stage (a megakernel
# chains three segments of such roundings).
FORM_TOL = {"f32": TOL, "bf16": 1e-2, "f16": 2e-3, "bs16": 2e-3}
ORACLE_TOL = 1e-5              # x max|want|, either route vs complex128
GATE_DB = 0.1
SEARCH = 64                    # window of the peak-position check


# the matmul-route f32 instantiations, which must run on the tensor cores
MMA_KERNELS = ("spectral_kernel<matmul>", "mega_resident<matmul>",
               "mega_staged<matmul>")
_KERNEL_NAMES = ("spectral_kernel", "mega_resident",
                 "mega_staged", "transpose_kernel")


_OPERAND_NAMES = {1: "bf16", 2: "f16"}


def instantiation(mangled):
    """A readable name of a mangled kernel, e.g. 'mega_staged<matmul>'
    (the template flag kStockham of spectral.cu and mega.cu; a megakernel
    specialised on its N, 'mega_staged<stockham,4096>'; the bs16 codec's
    instantiations end in ',bs16'; the matmul route's other operand forms
    name theirs, ',bf16' / ',f16', and Karatsuba, ',kara' in every
    transform or ',kara/seg' chosen per segment), or of one out-of-line
    Stockham op, e.g. 'stockham_n<cols,4096,io,32>' (layout, N,
    device-memory tile or in-place slab, points a thread, ',bs16' with the
    codec)."""
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
        m = re.match(r"I((?:L[bi]\d+E)+)E", rest)
        if m is None:   # the transpose's element type, or no template
            return (f"{name}<{rest[1:rest.find('E')]}>"
                    if rest.startswith("I") else name)
        args = [int(v) for v in re.findall(r"L[bi](\d+)E", m.group(1))]
        if name == "spectral_kernel":   # <kStockham, kBs, kOp, kKara>
            stockham, bs, op, kara = args
            n = 0
        else:                            # <kStockham, kN, kBs, kOp, kKara>
            stockham, n, bs, op, kara = args
        tags = ["stockham" if stockham else "matmul"]
        if n:
            tags.append(str(n))
        if bs:
            tags.append("bs16")
        elif op:
            tags.append(_OPERAND_NAMES[op])
        if kara:
            tags.append("kara" if kara == 1 else "kara/seg")
        return f"{name}<{','.join(tags)}>"
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


def sass_hmma(lib):
    """{instantiation: {operand type: HMMA instructions}} in the SASS of one
    built library (``cuobjdump -sass``, beside nvcc): 'tf32'
    (HMMA.1684.F32.TF32), 'bf16' (HMMA.16816.F32.BF16) and 'f16'
    (HMMA.16816.F32)."""
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
            counts.setdefault(cur, {"tf32": 0, "bf16": 0, "f16": 0})
        elif cur is not None and "HMMA" in ln:
            kind = "tf32" if "TF32" in ln else "bf16" if "BF16" in ln \
                else "f16"
            counts[cur][kind] += 1
    return counts


def hmma_wanted(name):
    """The HMMA operand type a matmul-route instantiation must run on (its
    stages' form), or None for a kernel without tensor-core stages."""
    if not name.startswith(("spectral_kernel<matmul", "mega_resident<matmul",
                            "mega_staged<matmul")):
        return None
    if ",bf16" in name:
        return "bf16"
    if ",f16" in name or ",bs16" in name:
        return "f16"
    return "tf32"


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


def filter_payload(rand, mode, n, scene, lines, rank=2):
    """The filter keywords of ``ops.spectral_op`` for one sweep case."""
    filt = {}
    if mode in ("shared", "shared_outer"):
        filt.update(hr=rand(n), hi=rand(n))
    if mode == "full":
        filt.update(hr=rand(*scene), hi=rand(*scene))
    if mode in ("outer", "shared_outer"):
        filt.update(u=rand(lines, rank), v=rand(n, rank))
    return filt


def spectral_sweep(torch, ops, rand, fft_impl, sizes=(128, 4096),
                   exact=False, precision="f32", karatsuba=False, tol=TOL,
                   splits=((None, None),), subnormal=False):
    """The spectral kernel against its plain version on the card: every
    filter mode x axis x fwd/inv at N in ``sizes`` (at N = 4096 each split
    of ``splits``, (None, None) the default), B in {1, 2}, 37 lines,
    within ``tol`` or, ``exact``, ``torch.equal``; ``subnormal``: odd lines
    scaled into the subnormal floats, and held to ``tol`` of their own
    largest value too (the bs16 codec's lines). At f32, on either route,
    each N = 4096 case also against the complex128 oracle
    (``ORACLE_TOL``). Returns {cases, max_rel_err, subnormal_max_rel_err,
    oracle_cases, max_oracle_err}."""
    from repro_torch.kernels.fft4step import FILTER_MODES
    lines = 37
    out = dict(cases=0, max_rel_err=0.0, subnormal_max_rel_err=0.0,
               oracle_cases=0, max_oracle_err=0.0)
    for n in sizes:
        for n1, n2 in (splits if n == 4096 else ((None, None),)):
            for batch in (1, 2):
                for axis in (0, 1):
                    scene = (lines, n) if axis == 1 else (n, lines)
                    xr, xi = rand(batch, *scene), rand(batch, *scene)
                    if subnormal:
                        xr, xi = subnormal_lines(torch, (xr, xi), axis)
                    odd = ((slice(None), slice(1, None, 2)) if axis == 1
                           else (slice(None), slice(None), slice(1, None, 2)))
                    for mode in FILTER_MODES:
                        filt = filter_payload(rand, mode, n, scene, lines)
                        for fwd, inv in ((True, False), (False, True),
                                         (True, True), (False, False)):
                            if mode == "none" and not (fwd or inv):
                                continue
                            kw = dict(axis=axis, fwd=fwd, inv=inv,
                                      filter_mode=mode, block=1,
                                      fft_impl=fft_impl, precision=precision,
                                      karatsuba=karatsuba, n1=n1, n2=n2)
                            got = ops.spectral_op(xr, xi, **filt, **kw)
                            want = ops.spectral_op_plain(xr, xi, **filt, **kw)
                            torch.cuda.synchronize()
                            _, rel = rel_err(got, want)
                            where = f"{kw} n={n} B={batch}"
                            check(rel <= tol, f"kernel vs plain {where}: "
                                  f"rel err {rel:.3e}")
                            check(not exact or all(
                                torch.equal(g, w) for g, w in zip(got, want)),
                                  f"kernel != plain {where}: rel err "
                                  f"{rel:.3e}")
                            out["max_rel_err"] = max(out["max_rel_err"], rel)
                            if subnormal:
                                _, sub = rel_err([g[odd] for g in got],
                                                 [w[odd] for w in want])
                                check(sub <= tol, f"subnormal lines {where}: "
                                      f"rel err {sub:.3e}")
                                out["subnormal_max_rel_err"] = max(
                                    out["subnormal_max_rel_err"], sub)
                            out["cases"] += 1
                            if n == 4096 and precision == "f32":
                                o = oracle_err(torch, got, oracle_op(
                                    torch, torch.complex(xr, xi), axis, fwd,
                                    inv, mode, **filt))
                                check(o <= ORACLE_TOL, f"kernel vs complex128 "
                                      f"{where}: {o:.3e}")
                                out["max_oracle_err"] = max(
                                    out["max_oracle_err"], o)
                                out["oracle_cases"] += 1
    return out


def mega_sweep(torch, ops, rand, fft_impl, exact=False, precision="f32",
               karatsuba=False, tol=TOL, shapes=MEGA_SHAPES,
               subnormal=False):
    """Both megakernels against ``mega_plain`` on the card over
    ``mega_chains()`` x ``shapes`` x B in {1, 2} (within ``tol`` or,
    ``exact``, ``torch.equal``), resident held ``torch.equal`` to staged;
    ``subnormal``: the batch's second scene scaled into the subnormal
    floats and held to ``tol`` of its own largest value (B = 2). At f32,
    on either route, each 4096^2 case also against the complex128 oracle
    chain (``ORACLE_TOL``). Returns {cases, max_rel_err (per kernel),
    subnormal_max_rel_err, resident_equals_staged_cases, oracle_cases,
    max_oracle_err}."""
    out = dict(cases={"mega_resident": 0, "mega_staged": 0},
               max_rel_err={"mega_resident": 0.0, "mega_staged": 0.0},
               subnormal_max_rel_err=0.0, resident_equals_staged_cases=0,
               oracle_cases=0, max_oracle_err=0.0)
    kw = dict(fft_impl=fft_impl, precision=precision, karatsuba=karatsuba)
    for na, nr in shapes:
        for batch in (1, 2):
            x = (rand(batch, na, nr), rand(batch, na, nr))
            if subnormal and batch == 2:
                for t in x:
                    t[1] *= 1e-40
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
                                                  segments=segments, **kw)
                outs = []
                for residency, kernel in (("vmem", "mega_resident"),
                                          ("staged", "mega_staged")):
                    if residency == "vmem" and \
                            ops.mega_residency(na, nr) != "vmem":
                        continue
                    got = ops.mega_spectral_op(*x, *args, segments=segments,
                                               residency=residency, **kw)
                    torch.cuda.synchronize()
                    _, rel = rel_err(got, want)
                    where = (f"{kernel} {kw} {segments} {na}x{nr} "
                             f"B={batch}")
                    check(rel <= tol, f"{where} vs plain: rel err {rel:.3e}")
                    check(not exact or all(
                        torch.equal(g, w) for g, w in zip(got, want)),
                          f"{where} != plain: rel err {rel:.3e}")
                    out["max_rel_err"][kernel] = max(
                        out["max_rel_err"][kernel], rel)
                    out["cases"][kernel] += 1
                    if subnormal and batch == 2:
                        _, sub = rel_err([g[1] for g in got],
                                         [w[1] for w in want])
                        check(sub <= tol, f"{where} subnormal scene: "
                              f"{sub:.3e}")
                        out["subnormal_max_rel_err"] = max(
                            out["subnormal_max_rel_err"], sub)
                    outs.append(got)
                    if na == nr == 4096 and precision == "f32":
                        o = oracle_err(torch, got, oracle_chain(
                            torch, torch.complex(*x), segments, args))
                        check(o <= ORACLE_TOL, f"{where} vs complex128: "
                              f"{o:.3e}")
                        out["max_oracle_err"] = max(out["max_oracle_err"], o)
                        out["oracle_cases"] += 1
                if len(outs) == 2:
                    check(all(torch.equal(a, b) for a, b in zip(*outs)),
                          f"resident != staged {kw} {segments} {na}x{nr}")
                    out["resident_equals_staged_cases"] += 1
            del x, args, want, outs
    return out


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


def mma_floor(n, n1, n2, lines, transforms, precision="f32",
              karatsuba=False):
    """(tensor-core flops, ms) of the matmul route's stages: 8 N (n1 + n2)
    real flops a line and transform (6 N (n1 + n2) with Karatsuba's three
    products), issued as ``TF32_PASSES`` TF32 passes over the dense TF32
    rate at f32, as one pass over the dense BF16 / FP16 rate at bf16, f16
    and bs16."""
    flops = (6.0 if karatsuba else 8.0) * n * (n1 + n2) * lines * transforms
    if precision == "f32":
        flops *= TF32_PASSES
        return flops, flops / TF32_FLOP_PER_S * 1e3
    return flops, flops / BF16_FLOP_PER_S * 1e3


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
    spec = MegaSpec(na, nr, tuple(
        SegmentSpec(*s[:4], **dict(zip(("n1", "n2", "n3", "karatsuba"),
                                       s[4:])))
        for s in kk["segments"]), karatsuba=kk.get("karatsuba", False),
        n1=kk.get("n1"), n2=kk.get("n2"))
    nbytes = 16 * xr.numel() + sum(4 * t.numel() for t in args)
    flops = _mega_flops(spec) * batch
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    oracle = build_pipeline(segments_cfg, variant, backend="torch")
    rec = dict(
        kernel=name, variant=variant, fft_impl=kk["fft_impl"],
        precision=kk["precision"],
        karatsuba=[spec.seg_spec(g).karatsuba for g in spec.segments],
        segments=kk["segments"], scene=[na, nr], batch=batch,
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
                         int(seg.fwd) + int(seg.inv), kk["precision"],
                         sspec.karatsuba)
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
                        fft_impl=kk["fft_impl"], precision=kk["precision"],
                        n1=kk.get("n1"), n2=kk.get("n2"),
                        karatsuba=kk.get("karatsuba", False))
    nbytes = 4 * xr.numel() * 4 + sum(4 * t.numel() for t in fk.values())
    flops = flops_nominal(spec, nlines)
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    rec = dict(
        launch=step.name, variant=variant, fft_impl=kk["fft_impl"],
        precision=kk["precision"], karatsuba=spec.karatsuba,
        split=list(spec.factors()), axis=kk["axis"],
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
                                int(kk["fwd"]) + int(kk["inv"]),
                                kk["precision"], spec.karatsuba)
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
    ms = mega_sweep(torch, ops, rand, "matmul")
    staged_smem = (ops.RESIDENT_MAX_POINTS * 8
                   + ops.dft_smem_bytes(64, 64))   # 4096^2, matmul
    emit("mega_kernel", cases=ms["cases"], max_rel_err=ms["max_rel_err"],
         tol=TOL, oracle_cases=ms["oracle_cases"],
         max_oracle_err=ms["max_oracle_err"], oracle_tol=ORACLE_TOL,
         resident_equals_staged_cases=ms["resident_equals_staged_cases"],
         smem_optin_bytes=optin,
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
    sw = spectral_sweep(torch, ops, seeded_randn(torch, dev, 3), "stockham",
                        sizes=STOCKHAM_SIZES, exact=True)
    ms = mega_sweep(torch, ops, seeded_randn(torch, dev, 4), "stockham",
                    exact=True)
    emit("stockham_kernel", spectral_cases=sw["cases"], sizes=STOCKHAM_SIZES,
         spectral_max_rel_err=sw["max_rel_err"], mega_cases=ms["cases"],
         mega_max_rel_err=ms["max_rel_err"],
         resident_equals_staged_cases=ms["resident_equals_staged_cases"],
         equal_to_plain=True, spectral_oracle_cases=sw["oracle_cases"],
         spectral_max_oracle_err=sw["max_oracle_err"],
         mega_oracle_cases=ms["oracle_cases"],
         mega_max_oracle_err=ms["max_oracle_err"], oracle_tol=ORACLE_TOL)

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


def kernel_karatsuba(name):
    """The Karatsuba flags a ``kernels`` entry's kernel runs by FFT route:
    both on the matmul route's stages, none to take on the Stockham
    route (no complex contraction there)."""
    if name == "transpose":
        return {}
    if name == "stockham":
        return {"stockham": [False]}
    return {"matmul": [False, True], "stockham": [False]}


def kernel_record(name, variant, fft_impl, launches, err, timed,
                  source=None):
    """One ``kernels`` entry for a kernel on a path of phase 14, 15 or 16:
    the sums over the path's launches of that kernel (``source``: the
    file in csrc/ its library builds from, when not the kernel's own)."""
    source = source or ("spectral.cu" if name == "spectral" else "mega.cu")
    line = {"spectral": 598, "mega_resident": 931, "mega_staged": 1002}[name]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/fft4step.py:{line}",
            "path": variant, "fft_impl": fft_impl,
            "precision": timed[0]["precision"],
            "karatsuba": any(any(r["karatsuba"]) if isinstance(
                r.get("karatsuba"), list) else r.get("karatsuba", False)
                for r in timed),
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


# Phase 16: the matmul route's operand forms (precision, karatsuba)
FORMS16 = (("f32", True), ("bf16", False), ("f16", False), ("bs16", False),
           ("bs16", True))
# the forms timed beside f32, in turns
TIMED_FORMS = (("f32", False), ("bf16", False), ("bs16", False),
               ("f32", True))
FUSED1_SEGMENTS = (dict(axis=0, fwd=True),
                   dict(axis=1, fwd=True, inv=True, filtered=True),
                   dict(axis=0, inv=True, filtered=True))


def bit_equal(torch, a, b):
    """Equal bit for bit, NaN payloads included (an f16 image overflows)."""
    return torch.equal(torch.view_as_real(a).view(torch.int32),
                       torch.view_as_real(b).view(torch.int32))


def form_kw(precision, karatsuba):
    """Compile keywords of one operand form: the precision, and Karatsuba
    in every segment through a Schedule (each fused3 launch and each
    in-kernel segment of fused1 take one segment of it), tuning off."""
    from repro_torch import tuning
    sched = tuning.Schedule(
        segments=(tuning.SegmentConfig(karatsuba=True),) * 3) \
        if karatsuba else None
    return dict(precision=precision, schedule=sched, tune="off")


def form_sweeps(torch, ops, dev):
    """Phase 16.1: each operand form of the matmul route against the plain
    versions on the card: the spectral kernel's grid of phase 3 (both
    splits at N = 4096, odd lines subnormal for bs16), phase 6's chains
    through both megakernels (resident == staged); f32 with Karatsuba
    against complex128 at N = 4096 too."""
    for i, (precision, kara) in enumerate(FORMS16):
        t0 = time.perf_counter()
        kw = dict(precision=precision, karatsuba=kara,
                  tol=FORM_TOL[precision], subnormal=precision == "bs16")
        # f16 (no codec) overflows its range on a random 4096^2 chain, in
        # the plain version as in the kernels: its chains stop at 256^2
        shapes = MEGA_SHAPES[:-1] if precision == "f16" else MEGA_SHAPES
        sw = spectral_sweep(torch, ops, seeded_randn(torch, dev, 20 + i),
                            "matmul", splits=((None, None), (128, 32)), **kw)
        ms = mega_sweep(torch, ops, seeded_randn(torch, dev, 30 + i),
                        "matmul", shapes=shapes, **kw)
        emit("form_kernel", precision=precision, karatsuba=kara,
             tol=FORM_TOL[precision], oracle_tol=ORACLE_TOL, spectral=sw,
             mega=ms, mega_shapes=shapes, seconds=time.perf_counter() - t0)


def form_images(torch, smi_line, cfg, raw, score, replay_plain, small,
                small_raw):
    """Phase 16.2: fused3 and fused1 at 4096^2 and fused1 at 128^2 at each
    operand form: launch counts, the focus gate against the f32 image and
    the plain replay, fused1 bit for bit equal to fused3, resident to
    staged. At 4096^2 f16 and bs16 overflow f16's range (the range
    launch's inverse sums a compressed line past 65504 before its 1/N,
    behind bs16's per-line exponents too): there the plain replay must be
    non-finite as well, and the counts of non-finite points are printed.
    Returns the
    ``kernels`` records of each form's paths (launch counts and errors
    from these runs, times from phase 16.4)."""
    from repro_torch.core.sar import build_pipeline
    f32_img = build_pipeline(cfg, "fused3").run(raw)
    rep_f32 = score(f32_img)
    del f32_img
    out = {}
    for precision, kara in FORMS16[1:] + (("f32", True),):
        if (precision, kara) in out:
            continue
        kw = form_kw(precision, kara)
        p3 = build_pipeline(cfg, "fused3", **kw)
        reset_launch_counts()
        img3 = p3.run(raw)
        torch.cuda.synchronize()
        c3, want = launch_counts(spectral=3)
        check(c3 == want, f"fused3 {precision} kara={kara}: {c3}")
        p1 = build_pipeline(cfg, "fused1", **kw)
        reset_launch_counts()
        img1 = p1.run(raw)
        torch.cuda.synchronize()
        c1, want = launch_counts(mega_staged=1)
        check(c1 == want, f"fused1 {precision} kara={kara}: {c1}")
        check(bit_equal(torch, img1, img3),
              f"fused1 != fused3 at {precision} kara={kara}")
        plain = replay_plain(p3, raw)
        torch.cuda.synchronize()
        # the kernels' image has the plain replay's non-finite points, no
        # others, and is within FORM_TOL of it on the rest
        fin = torch.isfinite(plain)
        check(torch.equal(torch.isfinite(img3), fin),
              f"fused3 {precision} kara={kara}: non-finite points differ "
              f"from the plain replay's")
        err = rel = 0.0              # f16 at 4096^2: no finite point
        if bool(fin.any()):
            got, want = img3[fin], plain[fin]
            err, rel = rel_err((got.real, got.imag), (want.real, want.imag))
            del got, want
        check(rel <= FORM_TOL[precision],
              f"fused3 {precision} kara={kara} vs plain on its finite "
              f"points: {rel:.3e}")
        finite = bool(fin.all())
        rec = dict(variant="fused3+fused1", precision=precision,
                   karatsuba=kara, scene=[cfg.na, cfg.nr],
                   launches=[c3, c1], fused1_equals_fused3=True,
                   finite=finite, max_abs_err_vs_plain=err,
                   rel_err_vs_plain=rel, tol=FORM_TOL[precision])
        if finite:
            rep = score(img3)
            rec.update(
                targets=rep,
                snr_delta_db_vs_f32=check_focus(
                    f"fused3 {precision} vs f32", rep, rep_f32),
                snr_delta_db_vs_plain=check_focus(
                    f"fused3 {precision} vs plain", rep, score(plain)))
        else:
            # f16's range: a compressed range line's partial sums pass
            # 65504 (PERF.md §6)
            check(precision in ("f16", "bs16"),
                  f"fused3 {precision} kara={kara}: non-finite image")
            rec.update(nonfinite_points=int((~fin).sum()))
        del img1, img3, plain, fin
        # 128^2: mega_resident, and staged
        f3s = build_pipeline(small, "fused3", **kw).run(small_raw)
        p1s = build_pipeline(small, "fused1", **kw)
        reset_launch_counts()
        img1s = p1s.run(small_raw)
        torch.cuda.synchronize()
        cs, want = launch_counts(mega_resident=1)
        check(cs == want, f"fused1 128^2 {precision} kara={kara}: {cs}")
        check(bit_equal(torch, img1s, f3s),
              f"fused1 != fused3 at 128^2, {precision} kara={kara}")
        staged = build_pipeline(small, "fused1", residency="staged",
                                **kw).run(small_raw)
        check(bit_equal(torch, staged, img1s),
              f"resident != staged at 128^2, {precision} kara={kara}")
        rec.update(launches_128=cs, resident_equals_staged_128=True)
        emit("form_image", **rec)
        out[(precision, kara)] = rec
    return out


def tuning_path(torch, smi_line, cfg, raw, score, replay_plain, small,
                small_raw):
    """Phase 16.3: the tuning path at full width, its cache in a temporary
    directory: ``search_kernel`` at N = 4096 (f32, bf16, bs16 behind the
    SNR gate), the winner persisted and read back by ``build_pipeline``'s
    default ``tune="cached"`` into every fused3 launch of the paper's
    scene; ``search_schedule`` for fused1 at 4096^2 (staged) and 128^2
    (both lanes), fused1 compiled through each winner, bit for bit equal
    to ``mega_spectral_op`` with the same knobs given by hand; a schedule
    whose azimuth and range segments split differently reaching
    ``mega_staged`` as those segment records."""
    import tempfile
    from repro_torch import tuning
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    outer_cache = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune_cache.json")
        tuning.clear_memory_cache()
        planlib.clear_pipeline_cache()
        # -- search_kernel ---------------------------------------------------
        gates, timed = {}, []

        def log(what, t, r):
            if isinstance(what, str):       # gate_<precision>, dB, admitted
                gates[what[5:]] = dict(
                    snr_delta_db=t if t != float("inf") else None,
                    image_finite=t != float("inf"), admitted=r)
            else:
                timed.append(dict(config=what.to_dict(), seconds=t,
                                  rung=r))

        t0 = time.perf_counter()
        key = tuning.TuneKey.kernel(cfg.nr, lines=16)
        res = tuning.search_kernel(key, precisions=("f32", "bf16", "bs16"),
                                   log=log)
        search_s = time.perf_counter() - t0
        check(res.measured < res.space,
              f"search timed {res.measured} of {res.space}")
        # a candidate the cost model admits and the kernel refuses is a
        # bug in the cut, not noise: measured_search records it as None
        check(all(t is not None for _, t in res.trace),
              f"search_kernel candidates raised at launch: "
              f"{[c.to_dict() for c, t in res.trace if t is None]}")
        check(tuning.cached_config(cfg.nr) == res.config,
              "the search's winner did not persist")
        win = res.config
        emit("tuning_search", key=key.encode(), space=res.space,
             measured=res.measured, gates=gates, times=timed,
             winner=win.to_dict(), winner_seconds=res.seconds,
             predicted_rank=res.predicted_rank, seconds=search_s,
             nvidia_smi=smi_line)

        # -- fused3 through the cache ---------------------------------------
        pipe = build_pipeline(cfg, "fused3")
        for s in pipe.steps:
            kk = s.kernel_kw
            got = (kk["n1"], kk["n2"], kk["karatsuba"], kk["precision"])
            check(got == (win.n1, win.n2, bool(win.karatsuba),
                          win.precision or "f32"),
                  f"fused3 launch {s.name} took {got}, not the winner")
            n = cfg.nr if kk["axis"] == 1 else cfg.na
            line = (1, 1, n) if kk["axis"] == 1 else (1, n, 1)
            spec = ops._prepare(
                torch.empty(line), torch.empty(line), None, None, None,
                None, axis=kk["axis"], fwd=kk["fwd"], inv=kk["inv"],
                filter_mode="none", block=1, fft_impl=kk["fft_impl"],
                karatsuba=kk["karatsuba"], precision=kk["precision"],
                n1=kk["n1"], n2=kk["n2"], n3=kk["n3"])[0]
            check((spec.factors(), spec.karatsuba, spec.precision) ==
                  ((win.n1, win.n2), bool(win.karatsuba),
                   win.precision or "f32"), f"{s.name}: spec {spec}")
        reset_launch_counts()
        img = pipe.run(raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(spectral=3)
        check(counts == want, f"tuned fused3 launches {counts}")
        rep = score(img)
        dsnr = check_focus("tuned fused3 vs plain", rep,
                           score(replay_plain(pipe, raw)))
        emit("tuned_main", variant="fused3", scene=[cfg.na, cfg.nr],
             launches=counts, winner=win.to_dict(), targets=rep,
             snr_delta_db_vs_plain=dsnr)
        del img

        # -- search_schedule and fused1 through its winners ---------------
        scheds = {}
        for scene, sraw, lanes in ((cfg, raw, ("staged",)),
                                   (small, small_raw, ("vmem", "staged"))):
            problem = tuning.ScheduleProblem.mega_2d(
                scene.na, scene.nr,
                tuple(tuning.SegmentShape(**d) for d in FUSED1_SEGMENTS))
            skey = tuning.TuneKey.pipeline("fused1", scene.na, scene.nr)
            t0 = time.perf_counter()
            # search_schedule has no SNR gate (as the reference's): the
            # precisions whose 4096^2 images are finite
            sres = tuning.search_schedule(
                problem, skey, k=8, precisions=("f32", "bf16"))
            check({s.residency for s, _ in sres.trace} <= set(lanes),
                  f"{scene.na}^2: a lane the kernels refuse was measured")
            check(all(t is not None for _, t in sres.trace),
                  f"{scene.na}^2: a frontier schedule raised at launch")
            best = sres.schedule
            p1 = build_pipeline(scene, "fused1", schedule=best)
            step = p1.steps[0]
            check(step.kernel_kw["residency"] == best.residency,
                  "fused1 compiled a residency its schedule did not pick")
            reset_launch_counts()
            img = p1.run(sraw)
            torch.cuda.synchronize()
            kernel = ("mega_resident" if best.residency == "vmem"
                      else "mega_staged")
            counts, want = launch_counts(**{kernel: 1})
            check(counts == want, f"scheduled fused1 launches {counts}")
            by_hand = tuple(
                (d["axis"], d.get("fwd", False), d.get("inv", False), mode,
                 sc.n1, sc.n2, sc.n3, sc.karatsuba)
                for d, mode, sc in zip(
                    FUSED1_SEGMENTS, [r[3] for r in step.kernel_kw[
                        "segments"]], best.segments))
            xr, xi = planlib.split(sraw)
            explicit = planlib.unsplit(*ops.mega_spectral_op(
                xr, xi, *[t for a in step.seg_filter_args for t in a],
                segments=by_hand, residency=best.residency,
                precision=best.precision or "f32"))
            check(bit_equal(torch, img, explicit),
                  f"fused1 through the schedule != by hand at "
                  f"{scene.na}^2")
            emit("tuning_schedule", scene=[scene.na, scene.nr],
                 frontier=sres.space, measured=sres.measured,
                 winner=best.to_dict(), winner_seconds=sres.seconds,
                 predicted_rank=sres.predicted_rank, launches=counts,
                 equal_to_explicit=True,
                 seconds=time.perf_counter() - t0)
            scheds[scene.na] = best
            del img, explicit

        # -- different splits for the azimuth and range segments -----------
        # at 4096^2: (64, 64) with Karatsuba on azimuth, (128, 32) on range
        az = (*tuning.factorizations(cfg.na)[0], None, True)
        rg = (*tuning.factorizations(cfg.nr)[1], None, False)
        mixed = tuning.Schedule(
            segments=tuple(tuning.SegmentConfig(*r) for r in (az, rg, az)),
            residency="staged")
        # tune="off": f32, not the cached winner's precision
        p1 = build_pipeline(cfg, "fused1", schedule=mixed, tune="off")
        recs = [r[4:] for r in p1.steps[0].kernel_kw["segments"]]
        check(recs == [az, rg, az], f"segment records {recs}")
        reset_launch_counts()
        img = p1.run(raw)
        torch.cuda.synchronize()
        counts, want = launch_counts(mega_staged=1)
        check(counts == want, f"mixed-split fused1 launches {counts}")
        plain = replay_mega_plain(p1.steps[0], raw)
        _, rel = rel_err((img.real, img.imag), (plain.real, plain.imag))
        check(rel <= TOL, f"mixed-split fused1 vs plain: {rel:.3e}")
        default = build_pipeline(cfg, "fused1", tune="off").run(raw)
        check(not torch.equal(img, default),
              "the mixed splits did not reach the kernel")
        emit("tuning_mixed_splits", scene=[cfg.na, cfg.nr],
             segment_records=recs, launches=counts, rel_err_vs_plain=rel,
             differs_from_default_splits=True)
        del img, plain, default
        os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE")
        if outer_cache is not None:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = outer_cache
        tuning.clear_memory_cache()
        planlib.clear_pipeline_cache()
    return search_s


def form_times(torch, smi_line, cfg, raw, small, small_raw, images):
    """Phase 16.4: each fused3 launch and both megakernels at bf16, bs16
    and f32 with Karatsuba, beside f32, in turns (f32, forms..., forms
    reversed, f32): the first pass times kernel, plain version and
    library, the second the kernel again. Returns the ``kernels`` records
    of the timed forms."""
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    batch_raw = small_raw.expand(MEGA_BATCH, *small_raw.shape).contiguous()
    paths = {}
    for form in TIMED_FORMS:
        kw = form_kw(*form)
        p3 = build_pipeline(cfg, "fused3", **kw)
        paths[form] = dict(
            launches=[(s, *planlib.split(x), x)
                      for s, x in step_inputs(p3, raw)[0]],
            staged=build_pipeline(cfg, "fused1", **kw).steps[0],
            resident=build_pipeline(small, "fused1", **kw).steps[0])
    first = {}
    for form in TIMED_FORMS:
        p = paths[form]
        variant = "fused3" if form == ("f32", False) else \
            f"fused3_{form[0]}{'_kara' if form[1] else ''}"
        first[form] = dict(
            launches=[time_spectral_launch(smi_line, s, xr, xi, x,
                                           variant=variant)
                      for s, xr, xi, x in p["launches"]],
            staged=time_mega_kernel(torch, smi_line, "mega_staged",
                                    p["staged"], raw, cfg),
            resident=time_mega_kernel(torch, smi_line, "mega_resident",
                                      p["resident"], batch_raw, small))
    second = {}
    scenes = {"staged": planlib.split(raw),
              "resident": planlib.split(batch_raw)}

    def mega_ms(step, x):
        args = [t for a in step.seg_filter_args for t in a]
        return cuda_median_ms(lambda: ops.mega_spectral_op(
            *x, *args, **step.kernel_kw), queued=True)

    for form in reversed(TIMED_FORMS):
        p = paths[form]
        second[form] = dict(
            launches=[cuda_median_ms(lambda: ops.spectral_op(
                xr, xi, **s.filter_kw, **s.kernel_kw), queued=True)
                for s, xr, xi, x in p["launches"]],
            **{k: mega_ms(p[k], x) for k, x in scenes.items()})
    order = [list(f) for f in TIMED_FORMS + tuple(reversed(TIMED_FORMS))]
    for form in TIMED_FORMS:
        f1, f2 = first[form], second[form]
        emit("time_forms", precision=form[0], karatsuba=form[1],
             order=order, fused3_launch_ms=[
                 [r["ms"], t] for r, t in zip(f1["launches"],
                                              f2["launches"])],
             fused3_sum_ms=[sum(r["ms"] for r in f1["launches"]),
                            sum(f2["launches"])],
             fused3_mma_floor_ms=sum(r["mma_floor_ms"]
                                     for r in f1["launches"]),
             fused3_bound_ms=sum(r["bound_ms"] for r in f1["launches"]),
             fused3_plain_ms=sum(r["plain_ms"] for r in f1["launches"]),
             fused3_library_ms=sum(r["library_ms"]
                                   for r in f1["launches"]),
             mega_staged_ms=[f1["staged"]["ms"], f2["staged"]],
             mega_staged_mma_floor_ms=f1["staged"]["mma_floor_ms"],
             mega_resident_ms=[f1["resident"]["ms"], f2["resident"]],
             mega_resident_mma_floor_ms=f1["resident"]["mma_floor_ms"],
             nvidia_smi=smi_line)
    records = []
    for form in TIMED_FORMS[1:]:
        img = images.get(form, {})
        counts3, counts1 = img.get("launches", [{}, {}])
        err = img.get("max_abs_err_vs_plain", 0.0)
        variant = f"{form[0]}{'+karatsuba' if form[1] else ''}"
        records.append(kernel_record(
            "spectral", f"fused3 {variant}", "matmul",
            counts3.get("spectral", 0), err, first[form]["launches"]))
        records.append(kernel_record(
            "mega_staged", f"fused1 {variant}", "matmul",
            counts1.get("mega_staged", 0), err, [first[form]["staged"]],
            source="mega_forms.cu"))
        records.append(kernel_record(
            "mega_resident", f"fused1 128^2 {variant}", "matmul",
            img.get("launches_128", {}).get("mega_resident", 0), err,
            [first[form]["resident"]], source="mega_forms.cu"))
    return records


STREAM_STRIPS = 4              # phase 17's strips a streamed launch
STREAM_VARIANTS = (("fused3", "matmul"), ("fused3", "stockham"),
                   ("csa_fused", "matmul"), ("unfused", None))
BURST = 16                     # phase 17's 128^2 default-tier requests


def host_ms(torch, fn, reps=5):
    """Median host-clock ms of ``fn`` with a device synchronisation after
    it (a request or a streamed run: the host's time is the point)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def percentiles(values):
    """p50 / p99 of request latencies, nearest rank (the service's own
    ``metrics.percentile``)."""
    from repro_torch.service.metrics import percentile
    return {"p50_ms": percentile(values, 50),
            "p99_ms": percentile(values, 99), "n": len(values)}


def strip_launches(torch, pipe, raw_host, strips):
    """The spectral launches ``run_streamed`` makes, each with its own
    strip of the host scene on the card and its sliced filter payloads
    (for timing each beside its plain version and bound)."""
    import types
    from repro_torch.core import plan as planlib
    out = []
    x = torch.from_numpy(raw_host)
    for s in pipe.steps:
        n = x.shape[s.stream_axis]
        sizes = [n // strips + (1 if i < n % strips else 0)
                 for i in range(strips)]
        lo = 0
        for size in sizes:
            sl = planlib._strip(s.stream_axis, lo, lo + size)
            xs = x[sl].contiguous().cuda()
            fk = planlib._slice_filter_kwargs(
                s.filter_kw, s.filter_mode, s.phys_axis, lo, lo + size)
            out.append((types.SimpleNamespace(
                name=f"{s.name}[{lo}:{lo + size}]", kernel_kw=s.kernel_kw,
                filter_kw=fk), *planlib.split(xs), xs))
            lo += size
        x = s.fn(x.cuda()).cpu()
    return out


def service_breakdown(torch, backend, key, batch_host, strips=None):
    """Host-clock ms (median of 3, each ending in a synchronisation) of
    the steps a request's batch takes through ``backend`` outside the
    event loop: stacking, the copy up through pinned memory, the run, the
    copy back, the output sentinel; for a streamed key, ``run_streamed``
    alone and the backend's ``execute_streamed``."""
    import numpy as np
    from repro_torch.service.resilience import HealthSentinel
    sentinel = HealthSentinel()
    if strips is not None:
        pipe = backend._pipeline(key, variant=key.variant)
        img = pipe.run_streamed(batch_host[0], strips=strips)
        return dict(
            run_streamed_ms=host_ms(torch, lambda: pipe.run_streamed(
                batch_host[0], strips=strips), reps=3),
            execute_streamed_ms=host_ms(torch, lambda: backend.
                                        execute_streamed(key, batch_host[0],
                                                         strips), reps=3),
            sentinel_ms=host_ms(torch, lambda: sentinel.check(
                batch_host[0], img), reps=3))
    fn = backend._fn(key)
    padded = backend._to_device(batch_host)
    out = fn(padded)
    imgs = backend._to_host(out)
    return dict(
        stack_ms=host_ms(torch, lambda: np.stack(list(batch_host)), reps=3),
        to_device_ms=host_ms(torch, lambda: backend._to_device(batch_host),
                             reps=3),
        run_ms=host_ms(torch, lambda: fn(padded), reps=3),
        to_host_ms=host_ms(torch, lambda: backend._to_host(out), reps=3),
        sentinel_ms=host_ms(torch, lambda: [
            sentinel.check(r, i) for r, i in zip(batch_host, imgs)], reps=3),
        execute_ms=host_ms(torch, lambda: backend.execute(key, batch_host),
                           reps=3))


def service_phase(torch, smi_line, cfg, raw, score, small, small_raw):
    """Phase 17: the focusing service (``repro_torch.service``) on the
    card; returns its ``kernels`` records (path ``service:*``)."""
    import asyncio

    import numpy as np
    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import build_pipeline
    from repro_torch.kernels import ops
    from repro_torch.service import (BatchKey, ChaosBackend, FaultInjector,
                                     FocusService, LocalBackend,
                                     OutputCorrupted, ServiceConfig,
                                     SimulatedFailure, seeded_schedule)
    from repro_torch.service.resilience import LaneStalled
    raw_host = raw.cpu().numpy()
    small_host = small_raw.cpu().numpy()

    # -- 17.1 streamed pipelines at 4096^2 -----------------------------------
    streamed = {}
    for variant, fft_impl in STREAM_VARIANTS:
        kw = {} if fft_impl is None else {"fft_impl": fft_impl}
        pipe = build_pipeline(cfg, variant, **kw)
        want = pipe.run(raw).cpu().numpy()
        reset_launch_counts()
        got = pipe.run_streamed(raw_host, strips=STREAM_STRIPS)
        torch.cuda.synchronize()
        spectral = 3 * STREAM_STRIPS if variant != "unfused" else 0
        counts, want_counts = launch_counts(spectral=spectral)
        check(counts == want_counts,
              f"streamed {variant}/{fft_impl}: launches {counts}")
        check(np.array_equal(got, want),
              f"streamed {variant}/{fft_impl} != run at 4096^2")
        rec = dict(
            variant=variant, fft_impl=fft_impl, strips=STREAM_STRIPS,
            launches=counts, equal_to_run=True,
            streamed_ms=host_ms(torch, lambda: pipe.run_streamed(
                raw_host, strips=STREAM_STRIPS), reps=3),
            in_memory_ms=host_ms(torch, lambda: pipe.run(raw), reps=3),
            in_memory_from_host_ms=host_ms(
                torch, lambda: pipe.run(raw_host).cpu().numpy(), reps=3))
        streamed[(variant, fft_impl)] = rec
        emit("streamed", scene=[cfg.na, cfg.nr], nvidia_smi=smi_line, **rec)
        del want, got
    for variant in ("fused", "fused1"):
        try:
            build_pipeline(cfg, variant).run_streamed(raw_host)
        except ValueError:
            continue
        raise RuntimeError(f"check failed: run_streamed took {variant}")

    # -- 17.2 the service: burst, 4096^2 in memory, 4096^2 streamed ----------
    scenes = [small_host * np.float32(1 + 0.1 * i) for i in range(BURST)]

    async def timed(svc, x, c, **kw):
        t0 = time.perf_counter()
        img = await svc.focus(x, c, **kw)
        return img, (time.perf_counter() - t0) * 1e3

    async def main_service():
        svc = FocusService(ServiceConfig(), device=None)
        await svc.start(warm=[(small, "fused3", None),
                              (small, "fused3", "bs16"),
                              (cfg, "fused3", "f32")])
        await svc._ensure_gate_measured("bs16")
        reset_launch_counts()
        burst = await asyncio.gather(*[timed(svc, x, small)
                                       for x in scenes])
        torch.cuda.synchronize()
        burst_counts = launch_counts()[0]
        burst_snap = svc.metrics.snapshot()
        reset_launch_counts()
        big = [await timed(svc, raw_host, cfg, precision="f32")]
        torch.cuda.synchronize()
        big_counts = launch_counts()[0]
        for _ in range(4):
            big.append(await timed(svc, raw_host, cfg, precision="f32"))
        # a cooperative mega_staged launch (a request naming fused1 at
        # 4096^2) on one lane beside resident bursts on the other
        hist = dict(svc.metrics.snapshot()["batch_size_hist"])
        reset_launch_counts()
        mixed = await asyncio.gather(
            timed(svc, raw_host, cfg, variant="fused1", precision="f32"),
            *[timed(svc, x, small) for x in scenes[:8]])
        torch.cuda.synchronize()
        mixed_counts = launch_counts()[0]
        mixed_snap = svc.metrics.snapshot()
        mixed_batches = sum(mixed_snap["batch_size_hist"].values()) \
            - sum(hist.values()) - 1
        await svc.stop()
        return (svc, burst, burst_counts, burst_snap, big, big_counts,
                mixed, mixed_counts, mixed_batches, mixed_snap)

    t0 = time.perf_counter()
    (svc, burst, burst_counts, burst_snap, big, big_counts, mixed,
     mixed_counts, mixed_batches, mixed_snap) = asyncio.run(main_service())
    service_s = time.perf_counter() - t0
    deviation = svc._gate_cache["bs16"]
    tier = "bs16" if deviation <= GATE_DB else "f32"
    check(burst_snap["tier_fallbacks"] == (0 if tier == "bs16" else BURST),
          f"served tier: {burst_snap['tier_fallbacks']} fallbacks, gate "
          f"{deviation} dB")
    check(not svc.backend.fallbacks,
          f"off tier 0: {dict(svc.backend.fallbacks)}")
    batches = sum(burst_snap["batch_size_hist"].values())
    _, want_counts = launch_counts(mega_resident=batches)
    check(burst_counts == want_counts,
          f"burst launches {burst_counts} for {batches} batches")
    pipe1 = build_pipeline(small, "fused1", precision=tier)
    for x, (img, _) in zip(scenes, burst):
        check(np.array_equal(img, pipe1.run(x).cpu().numpy()),
              f"burst reply != fused1 at {tier}")
    _, want_counts = launch_counts(spectral=3)
    check(big_counts == want_counts, f"4096^2 launches {big_counts}")
    pipe3 = build_pipeline(cfg, "fused3")
    img3 = pipe3.run(raw)
    big_img = big[0][0]
    check(np.array_equal(big_img, img3.cpu().numpy()),
          "4096^2 served image != fused3")
    rep = score(torch.from_numpy(big_img))
    check_focus("service 4096^2", rep)
    _, want_counts = launch_counts(mega_staged=1,
                                   mega_resident=mixed_batches)
    check(mixed_counts == want_counts,
          f"mixed lanes: launches {mixed_counts}, {mixed_batches} bursts")
    check(np.array_equal(mixed[0][0], big_img),
          "4096^2 fused1 request != fused3 request")
    for x, (img, _) in zip(scenes[:8], mixed[1:]):
        check(np.array_equal(img, pipe1.run(x).cpu().numpy()),
              "mixed-lane burst reply != fused1")
    emit("service_concurrent", lanes=mixed_snap["lane_batches"],
         launches=mixed_counts, staged_equal_to_fused3=True,
         staged_latency_ms=mixed[0][1],
         burst_latency=percentiles([t for _, t in mixed[1:]]),
         nvidia_smi=smi_line)
    batch4 = torch.from_numpy(np.stack(scenes[:4])).cuda()
    emit("service", scene=[small.na, small.nr], requests=BURST,
         served_tier=tier, gate_snr_deviation_db=deviation,
         gate_db=GATE_DB, batch_size_hist=burst_snap["batch_size_hist"],
         lane_batches=burst_snap["lane_batches"], launches=burst_counts,
         equal_to_fused1=True, latency=percentiles([t for _, t in burst]),
         run_alone_batch4_ms=cuda_median_ms(lambda: pipe1.run(batch4)),
         run_alone_one_ms=cuda_median_ms(
             lambda: pipe1.run(small_raw)), nvidia_smi=smi_line)
    emit("service", scene=[cfg.na, cfg.nr], precision="f32",
         launches=big_counts, equal_to_fused3=True, targets=rep,
         latency=percentiles([t for _, t in big]),
         run_alone_ms=cuda_median_ms(lambda: pipe3.run(raw)),
         run_from_host_ms=host_ms(
             torch, lambda: pipe3.run(raw_host).cpu().numpy(), reps=3),
         service_seconds=service_s, nvidia_smi=smi_line)

    async def stream_service():
        svc2 = FocusService(ServiceConfig(
            device_budget_bytes=raw_host.nbytes - 1,
            stream_strips=STREAM_STRIPS), backend=svc.backend)
        await svc2.start()
        reset_launch_counts()
        out = [await timed(svc2, raw_host, cfg, precision="f32")]
        torch.cuda.synchronize()
        counts = launch_counts()[0]
        for _ in range(2):
            out.append(await timed(svc2, raw_host, cfg, precision="f32"))
        await svc2.stop()
        return out, counts, svc2.metrics.snapshot()

    stream_out, stream_counts, stream_snap = asyncio.run(stream_service())
    _, want_counts = launch_counts(spectral=3 * STREAM_STRIPS)
    check(stream_counts == want_counts,
          f"streamed request launches {stream_counts}")
    check(stream_snap["lane_batches"] == {"stream": 3}
          and stream_snap["streamed"] == 3,
          f"stream lane: {stream_snap['lane_batches']}")
    check(np.array_equal(stream_out[0][0], big_img),
          "streamed request != in-memory request")
    check(not svc.backend.fallbacks,
          f"off tier 0: {dict(svc.backend.fallbacks)}")
    emit("service_stream", scene=[cfg.na, cfg.nr], precision="f32",
         strips=STREAM_STRIPS, launches=stream_counts,
         equal_to_in_memory=True,
         latency=percentiles([t for _, t in stream_out]),
         in_memory_latency=percentiles([t for _, t in big]),
         nvidia_smi=smi_line)
    del big, stream_out, big_img
    for name, scene_cfg, prec, batch_host, strips in (
            ("burst", small, tier, np.stack(scenes[:4]), None),
            ("in_memory", cfg, "f32", raw_host[None], None),
            ("stream", cfg, "f32", raw_host[None], STREAM_STRIPS)):
        key = BatchKey(scene_cfg, "fused3", prec, strips is not None)
        emit("service_breakdown", request=name,
             scene=[scene_cfg.na, scene_cfg.nr], precision=prec,
             batch=len(batch_host), nvidia_smi=smi_line,
             **service_breakdown(torch, svc.backend, key, batch_host,
                                 strips))

    # -- 17.3 the seeded chaos replay ----------------------------------------
    ref = build_pipeline(small, "fused1").run(small_raw).cpu().numpy()
    injector = FaultInjector(
        seeded_schedule(20260808, 7,
                        ("dispatch_error", "nan_output", "lane_hang")),
        hang_timeout_s=60.0)
    inner = LocalBackend(sweep=((None, None),))
    chaos = ChaosBackend(inner, injector)

    async def replay():
        svc3 = FocusService(ServiceConfig(
            max_batch=2, max_delay_ms=20.0, precision=None, lanes=2,
            inflight_cap=1, max_retries=2, retry_backoff_ms=5.0,
            stall_factor=3.0, stall_floor_s=1.5), backend=chaos)
        await svc3.start(warm=[(small, "fused3", None)])
        outs = await asyncio.gather(
            *[svc3.focus(small_host, small) for _ in range(14)],
            return_exceptions=True)
        await svc3.stop()
        return outs, svc3.metrics.snapshot()

    try:
        outs, chaos_snap = asyncio.run(replay())
    finally:
        injector.release_hangs()
    lost = sum(1 for o in outs
               if not (isinstance(o, np.ndarray) and np.array_equal(o, ref))
               and not isinstance(o, (SimulatedFailure, OutputCorrupted,
                                      LaneStalled)))
    check(lost == 0, f"chaos replay lost {lost} requests")
    check(len(injector.seams_fired()) == 3,
          f"seams fired {injector.seams_fired()}")
    check(not inner.fallbacks, f"chaos off tier 0: {dict(inner.fallbacks)}")
    emit("service_chaos", scene=[small.na, small.nr], requests=14, lost=0,
         seams=injector.seams_fired(), completed=chaos_snap["completed"],
         failed=chaos_snap["failed"], retries=chaos_snap["retries"],
         lane_stalls=chaos_snap["lane_stalls"],
         bisections=chaos_snap["bisections"])

    # -- the service paths' kernels, each beside its plain version -----------
    key = BatchKey(small, "fused3", tier, False)
    step = svc.backend._pipeline(key).steps[0]
    check(step.kind == "mega" and step.kernel_kw["residency"] == "vmem",
          "the 128^2 service route is one resident mega step")
    xr, xi = planlib.split(batch4)
    args = [t for a in step.seg_filter_args for t in a]
    got = ops.mega_spectral_op(xr, xi, *args, **step.kernel_kw)
    want = ops.mega_spectral_op_plain(xr, xi, *args, **step.kernel_kw)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    check(rel <= FORM_TOL[tier], f"service mega_resident: {rel:.3e}")
    t_res = time_mega_kernel(torch, smi_line, "mega_resident", step, batch4,
                             small)
    records = [kernel_record("mega_resident", "service:fused1", "matmul",
                             burst_counts["mega_resident"], err, [t_res])]
    for path, pipe, counts, inputs in (
            ("service:fused3", pipe3, big_counts,
             [(s, *planlib.split(x), x)
              for s, x in step_inputs(pipe3, raw)[0]]),
            ("service:stream", pipe3, stream_counts,
             strip_launches(torch, pipe3, raw_host, STREAM_STRIPS))):
        err = 0.0
        for s, sxr, sxi, _ in inputs:
            got = ops.spectral_op(sxr, sxi, **s.filter_kw, **s.kernel_kw)
            want = ops.spectral_op_plain(sxr, sxi, **s.filter_kw,
                                         **s.kernel_kw)
            torch.cuda.synchronize()
            e, rel = rel_err(got, want)
            check(rel <= TOL, f"{path} launch {s.name}: {rel:.3e}")
            err = max(err, e)
        timed_launches = [time_spectral_launch(smi_line, s, sxr, sxi, x)
                          for s, sxr, sxi, x in inputs]
        records.append(kernel_record("spectral", path, "matmul",
                                     counts["spectral"], err,
                                     timed_launches))
    return records


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # tune="cached" is the compile default: every compile reads an empty
    # tuning cache of this run's own (phase 16 searches in another), so
    # what the user's cache holds never reaches a check
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, "autotune_cache.json")
        return run(torch)


def run(torch) -> int:
    """Phases 1-17 on the card (``main`` has found it)."""
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
    check(set(logs) >= {"spectral", "mega", "mega_forms", "transpose"},
          f"built {sorted(logs)}")
    ptxas = {}
    hmma = {}
    for name, log in logs.items():
        ptxas.update(ptxas_report(log))
        hmma.update(sass_hmma(_build.lib_path(name)))
    for kernel in MMA_KERNELS:
        check(hmma.get(kernel, {}).get("tf32", 0) > 0,
              f"{kernel}: no HMMA TF32 in its SASS")
    # the operand forms (bf16 / f16 / bs16 / Karatsuba) on the matmul route
    forms = sorted(k for k in hmma if hmma_wanted(k) and k not in MMA_KERNELS)
    for kernel in forms:
        check(hmma[kernel][hmma_wanted(kernel)] > 0,
              f"{kernel}: no HMMA {hmma_wanted(kernel)} in its SASS")
    emit("build", seconds=build_s, source_seconds=_build.BUILD_SECONDS,
         sources=sorted(_build.sources()), ptxas=ptxas, hmma=hmma,
         operand_form_instantiations=len(forms), operand_forms=forms)

    # ---- 3. kernel vs plain version on the card ----------------------------
    sw = spectral_sweep(torch, ops, seeded_randn(torch, dev, 0), "matmul")
    emit("kernel", cases=sw["cases"], max_rel_err=sw["max_rel_err"], tol=TOL,
         oracle_cases=sw["oracle_cases"],
         max_oracle_err=sw["max_oracle_err"], oracle_tol=ORACLE_TOL)

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
    del f32_images

    # ---- 16. tuning: the matmul route's operand forms and the tuner --------
    form_sweeps(torch, ops, dev)
    images = form_images(torch, smi_line, cfg, raw, score, replay_plain,
                         small, small_raw)
    tuning_path(torch, smi_line, cfg, raw, score, replay_plain, small,
                small_raw)
    kernels += form_times(torch, smi_line, cfg, raw, small, small_raw,
                          images)

    # ---- 17. the focusing service -------------------------------------------
    kernels += service_phase(torch, smi_line, cfg, raw, score, small,
                             small_raw)
    for k in kernels:
        k["precisions"] = kernel_precisions(k["name"])
        k["karatsuba_by_route"] = kernel_karatsuba(k["name"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
