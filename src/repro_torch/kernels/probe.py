"""What bounds the spectral kernels on the card (opt-in).

    PYTHONPATH=src python -m repro_torch.kernels.probe [--parts mma,spectral,mega]

Needs one CUDA card (Hopper, sm_90a) and ``nvcc``. Prints the card's
``nvidia-smi`` name and power limit on a line of its own, then one JSON
line:

- ``mma_sync_tf32_tflops``: the rate ``mma.sync.m16n8k8`` TF32 reaches
  alone (a probe kernel built here: 16 independent accumulators a warp,
  4 blocks of 256 threads an SM), and its share of the spec sheet's
  495 TFLOP/s dense TF32;
- ``spectral_4096_ms``: the spectral kernel on a random 4096^2 scene,
  CUDA events, 2 warm-ups, median of 7, rows and cols: ``filter_only``
  (no transform: the tile's device-memory I/O and one multiply; a launch
  without a transform takes the matmul instantiation, and both
  instantiations share the I/O code, so it is one number for both
  routes), then ``fwd`` and ``fwd_inv`` on each route;
- ``mega_stockham_ms``: both megakernels on the Stockham route, fused1's
  chain shape (cols fwd; rows fwd+inv, ``shared_outer``; cols inv,
  ``outer``) on random scenes, each call queued behind a spin on the
  card so that the host's time is not counted: ``mega_staged`` at
  4096^2 (the main path's N) and 2048^2, ``mega_resident`` on 132 scenes
  (one an SM) of 128^2 and of 64^2, and ``fused3_1x4096``, the same chain
  as three spectral-kernel launches at 4096^2 (the same tile ops, with
  the spectral kernel's registers and spills).

``--parts`` picks which of the three run (all by default).
"""
import ctypes
import json
import os
import statistics
import subprocess

TF32_FLOP_PER_S = 495e12       # H100 SXM spec sheet, dense TF32 tensor cores

MMA_PROBE_CU = r"""
// mma.sync.m16n8k8 TF32 issued back to back, 16 independent accumulators a
// warp (the operands' values do not change the rate).
#include <stdint.h>
#include <cuda_runtime.h>
__global__ void mma_probe(float* out, int iters) {
  float acc[16][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = threadIdx.x * 3u, b0 = threadIdx.x ^ 5u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]),
                     "+f"(acc[t][3])
                   : "r"(a0), "r"(a1), "r"(7u), "r"(9u), "r"(b0), "r"(11u));
  }
  float s = 0.0f;
  for (int t = 0; t < 16; ++t) s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  if (s == 1.2345f) out[0] = s;
}
extern "C" int mma_probe_launch(float* out, int blocks, int threads, int iters) {
  mma_probe<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


# GPU cycles of the spin a queued timing puts ahead of its first event
# (~5 ms at the H100's ~2 GHz): longer than the host takes to issue the
# timed calls, so that they run back to back on the card
QUEUE_SPIN_CYCLES = 10_000_000


def median_ms(fn, warm=2, reps=7, queued=False):
    """Median of ``reps`` timings of ``fn`` with CUDA events. ``queued``:
    each timing waits behind a spin kernel, so the events bracket the
    card's work alone and not the host's Python time before each launch
    (which is a large and variable share of a 0.2 ms megakernel call)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def mma_sync_tflops(torch, dev):
    """TF32 TFLOP/s of the probe kernel, built into the build directory."""
    from repro_torch.kernels import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "mma_probe.cu")
    lib_path = os.path.join(_build.BUILD_DIR, "libmma_probe.so")
    with open(src, "w") as f:
        f.write(MMA_PROBE_CU)
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    lib.mma_probe_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    out = torch.zeros(1, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = 4 * sms, 256, 2048

    def launch():
        if lib.mma_probe_launch(out.data_ptr(), blocks, threads, iters):
            raise RuntimeError("mma probe launch failed")
    ms = median_ms(launch)
    # 16 mma a warp and iteration, 16 x 8 x 8 multiply-adds each
    return blocks * threads // 32 * iters * 16 * 2048 / ms / 1e9


def spectral_parts(torch, dev, n=4096):
    """The spectral kernel's time on a random n x n scene by what runs."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = [torch.randn(n, n, generator=gen, device=dev) for _ in range(2)]
    h = {k: torch.randn(n, generator=gen, device=dev) for k in ("hr", "hi")}
    runs = [("filter_only", None, dict(fwd=False, inv=False,
                                       filter_mode="shared", **h))]
    runs += [(name, impl, kw) for impl in ("matmul", "stockham")
             for name, kw in (("fwd", dict(fwd=True, inv=False)),
                              ("fwd_inv", dict(fwd=True, inv=True)))]
    parts = {}
    for name, impl, kw in runs:
        for axis in (1, 0):
            key = "_".join(p for p in (impl, "rows" if axis else "cols",
                                       name) if p)
            parts[key] = median_ms(lambda: ops.spectral_op(
                *x, axis=axis, fft_impl=impl or "matmul", block=1, **kw))
    return parts


# fused1's chain: (axis, fwd, inv, filter mode) a segment
FUSED1_CHAIN = ((0, True, False, "none"), (1, True, True, "shared_outer"),
                (0, False, True, "outer"))
MEGA_CASES = (("staged", 1, 4096), ("staged", 1, 2048),
              ("resident", 132, 128), ("resident", 132, 64))
_RESIDENCY = {"staged": "staged", "resident": "vmem"}


def mega_parts(torch, dev):
    """Both megakernels on the Stockham route by scene (``MEGA_CASES``)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    parts = {}
    for residency, batch, n in MEGA_CASES:
        x = (rand(batch, n, n), rand(batch, n, n))
        args = []
        for axis, _fwd, _inv, mode in FUSED1_CHAIN:
            if mode in ("shared", "shared_outer"):
                args += [rand(n), rand(n)]
            if mode in ("outer", "shared_outer"):
                args += [rand(n, 2), rand(n, 2)]
        parts[f"{residency}_{batch}x{n}"] = median_ms(
            lambda: ops.mega_spectral_op(*x, *args, segments=FUSED1_CHAIN,
                                         residency=_RESIDENCY[residency],
                                         fft_impl="stockham"), queued=True)
        if (residency, n) == ("staged", 4096):
            parts["fused3_1x4096"] = median_ms(
                lambda: fused3(ops, x, args), queued=True)
        del x, args
    return parts


def fused3(ops, x, args):
    """``FUSED1_CHAIN`` as one spectral-kernel launch a segment."""
    it = iter(args)
    for axis, fwd, inv, mode in FUSED1_CHAIN:
        filt = {}
        if mode in ("shared", "shared_outer"):
            filt.update(hr=next(it), hi=next(it))
        if mode in ("outer", "shared_outer"):
            filt.update(u=next(it), v=next(it))
        x = ops.spectral_op(*x, **filt, axis=axis, fwd=fwd, inv=inv,
                            filter_mode=mode, fft_impl="stockham", block=1)
    return x


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="mma,spectral,mega")
    parts = set(ap.parse_args(argv).parts.split(","))
    if not torch.cuda.is_available():
        print("probe: no CUDA device")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    dev = torch.device("cuda", 0)
    rec = {"phase": "probe", "nvidia_smi": smi_line}
    if "mma" in parts:
        tflops = mma_sync_tflops(torch, dev)
        rec.update(mma_sync_tf32_tflops=tflops,
                   mma_sync_share_of_dense_tf32=tflops * 1e12
                   / TF32_FLOP_PER_S)
    if "spectral" in parts:
        rec["spectral_4096_ms"] = spectral_parts(torch, dev)
    if "mega" in parts:
        rec["mega_stockham_ms"] = mega_parts(torch, dev)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
