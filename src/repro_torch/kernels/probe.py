"""What bounds the spectral kernel's matmul route on the card (opt-in).

    PYTHONPATH=src python -m repro_torch.kernels.probe

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
  routes), then ``fwd`` and ``fwd_inv`` on each route.
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


def median_ms(fn, warm=2, reps=7):
    """Median of ``reps`` timings of ``fn`` with CUDA events."""
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


def main() -> int:
    import torch
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
    tflops = mma_sync_tflops(torch, dev)
    print(json.dumps({
        "phase": "probe", "nvidia_smi": smi_line,
        "mma_sync_tf32_tflops": tflops,
        "mma_sync_share_of_dense_tf32": tflops * 1e12 / TF32_FLOP_PER_S,
        "spectral_4096_ms": spectral_parts(torch, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
