#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and ``nvcc``; exits non-zero, with
no result line, when there is no card or the port is missing. Phases,
each printing one JSON line (any failed check raises and exits non-zero):

1. device  — the card's name and power limit (the raw nvidia-smi line is
             printed on a line of its own), torch / CUDA versions; TF32 is
             switched off for matmul and cuDNN.
2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``.
3. kernel  — the CUDA spectral kernel against its plain PyTorch version on
             the card: every filter mode x axis x fwd/inv combination at
             N in {128, 4096}, B in {1, 2}, 37 lines (ragged against every
             tile), tolerance 2e-4 x max|want|.
4. main    — the main path at the paper's size: ``simulate`` a 4096^2
             scene, ``build_pipeline(cfg, "fused3").run(raw)`` with the
             launch count reset just before and read just after (exactly
             3), all five targets within 8 px of ``metrics.expected_pixel``
             (argmax over a +-64 px window), the same compiled plan replayed
             through the plain version on the card (same peaks, |dSNR| <=
             0.1 dB), each launch's inputs through kernel and plain version;
             then ``fused_tfree`` (exactly 4 launches); then a 128^2 scene
             on the card against the plain version on the CPU.
5. times   — CUDA events, 2 warm-ups, median of 7: each fused3 launch and
             the whole run, beside the launch's bound (bytes over 3.35 TB/s
             vs nominal 5 N log2 N FLOP over 67 TFLOP/s, H100 SXM spec
             sheet), the plain version and ``library_ms`` (torch.fft ->
             multiply -> torch.fft, timed only as a yardstick).

The line before the last lists each kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM spec sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM spec sheet, FP32 outside tensor cores
TOL = 2e-4                     # x max|want| (tests/test_kernels.py)
GATE_DB = 0.1
SEARCH = 64                    # window of the peak-position check


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


def cuda_median_ms(fn, warm=2, reps=7):
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.core import plan as planlib
    from repro_torch.core.sar import (build_pipeline, metrics, paper_scene,
                                      paper_targets, simulate)
    from repro_torch.core.sar.geometry import test_scene as small_scene
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fft4step import (FILTER_MODES, SpectralSpec,
                                              flops_nominal)

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
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("build", seconds=build_s, sources=sorted(_build.sources()),
         ptxas=ptxas)

    # ---- 3. kernel vs plain version on the card ----------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    lines, rank = 37, 2
    worst = 0.0
    cases = 0
    for n in (128, 4096):
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
                                  filter_mode=mode, block=1)
                        got = ops.spectral_op(xr, xi, **filt, **kw)
                        want = ops.spectral_op_plain(xr, xi, **filt, **kw)
                        torch.cuda.synchronize()
                        _, rel = rel_err(got, want)
                        check(rel <= TOL, f"kernel vs plain {kw} n={n} "
                              f"B={batch}: rel err {rel:.3e}")
                        worst = max(worst, rel)
                        cases += 1
    emit("kernel", cases=cases, max_rel_err=worst, tol=TOL)

    # ---- 4. the main path at the paper's size ------------------------------
    cfg = paper_scene()
    targets = paper_targets(cfg)
    raw = simulate(cfg, targets)
    torch.cuda.synchronize()
    check(raw.shape == (cfg.na, cfg.nr) and raw.device.type == "cuda",
          "simulated scene shape/device")

    def replay_plain(pipe, x):
        """The compiled steps through the plain version, on the card."""
        for s in pipe.steps:
            xr, xi = planlib.split(x)
            yr, yi = ops.spectral_op_plain(xr, xi, **s.filter_kw,
                                           **s.kernel_kw)
            x = planlib.unsplit(yr, yi)
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
    for variant, want_launches in (("fused3", 3), ("fused_tfree", 4)):
        pipe = build_pipeline(cfg, variant)
        check(pipe.dispatches == want_launches, f"{variant} dispatches")
        ops.SPECTRAL_LAUNCHES = 0
        img = pipe.run(raw)
        torch.cuda.synchronize()
        launches = ops.SPECTRAL_LAUNCHES
        check(launches == want_launches,
              f"{variant}: {launches} kernel launches, want {want_launches}")
        check(bool(torch.isfinite(img).all()), f"{variant}: non-finite image")
        rep_k = score(img)
        for r in rep_k:
            off = r["wide_peak_offset"]
            check(max(abs(off[0]), abs(off[1])) <= 8,
                  f"{variant}: target peak {off} px from expected")
            check(r["snr_db"] > 30.0, f"{variant}: SNR {r['snr_db']}")
        img_p = replay_plain(pipe, raw)
        torch.cuda.synchronize()
        rep_p = score(img_p)
        dsnr = [abs(a["snr_db"] - b["snr_db"]) for a, b in zip(rep_k, rep_p)]
        check([r["peak"] for r in rep_k] == [r["peak"] for r in rep_p],
              f"{variant}: kernel and plain peaks differ")
        check(max(dsnr) <= GATE_DB, f"{variant}: dSNR {dsnr}")
        l2 = float(torch.linalg.vector_norm(img - img_p)
                   / torch.linalg.vector_norm(img_p))
        results[variant] = dict(launches=launches, targets=rep_k,
                                snr_delta_db_vs_plain=dsnr,
                                l2_rel_vs_plain=l2)
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
    del img, img_p

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
    launches_t = []
    for name, (s, xr, xi, x) in main_inputs.items():
        kk, fk = s.kernel_kw, s.filter_kw
        n = cfg.nr if kk["axis"] == 1 else cfg.na
        nlines = cfg.na if kk["axis"] == 1 else cfg.nr
        spec = SpectralSpec(n=n, fwd=kk["fwd"], filter_mode=kk["filter_mode"],
                            inv=kk["inv"], axis=kk["axis"])
        nbytes = 4 * xr.numel() * 4 + sum(4 * t.numel() for t in fk.values())
        flops = flops_nominal(spec, nlines)
        n1, n2 = spec.factors()
        ffma = 8.0 * n * (n1 + n2) * nlines * (int(kk["fwd"]) + int(kk["inv"]))
        t_mem = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        rec = dict(
            launch=name, axis=kk["axis"], mode=kk["filter_mode"],
            fwd=kk["fwd"], inv=kk["inv"],
            ms=cuda_median_ms(lambda: ops.spectral_op(xr, xi, **fk, **kk)),
            plain_ms=cuda_median_ms(
                lambda: ops.spectral_op_plain(xr, xi, **fk, **kk)),
            library_ms=cuda_median_ms(lambda: planlib._torch_apply(
                x, kk["fwd"], kk["inv"], kk["filter_mode"], fk,
                kk["axis"])),
            bytes=nbytes, flops_nominal=flops,
            bound_ms=max(t_mem, t_ops),
            bound_by="bytes" if t_mem >= t_ops else "operations",
            ffma_flops=ffma, ffma_floor_ms=ffma / FP32_FLOP_PER_S * 1e3)
        launches_t.append(rec)
        emit("time_launch", nvidia_smi=smi_line, **rec)
    run_ms = cuda_median_ms(lambda: fused3_pipe.run(raw))
    emit("time_run", variant="fused3", ms=run_ms, nvidia_smi=smi_line,
         launch_ms_sum=sum(r["ms"] for r in launches_t))

    total = {k: sum(r[k] for r in launches_t)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    t_mem = sum(r["bytes"] for r in launches_t) / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
