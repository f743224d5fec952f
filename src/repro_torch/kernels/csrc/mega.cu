// The single-launch 2-D megakernel for Hopper (sm_90a): a chain of per-axis
// segments `fft? mul* ifft?` over a (B, na, nr) scene batch, with the
// corner turns between segments inside ONE launch. Two kernels, one C entry
// point each.
//
// mega_resident replaces the Pallas TPU kernel
//   src/repro/kernels/fft4step.py:931 `_mega_kernel_resident`
//   (pallas_call at fft4step.py:1246, residency="vmem").
// mega_staged replaces
//   src/repro/kernels/fft4step.py:1002 `_mega_kernel_staged`
//   (pallas_call at fft4step.py:1288, residency="staged"),
// both wrapped by src/repro/kernels/ops.py:161 `mega_spectral_op`; at
// every precision (f32, bf16, f16, bs16), Karatsuba per segment on the
// matmul route, N <= 4096 on each transformed axis, all
// five filter modes on either axis (rank-K outer), fwd-only / inv-only /
// fwd+inv / filter-only segments, at most kMaxSegments segments. Each FFT
// runs on one of two routes: fft_impl="matmul" (the four-step stages, N a
// two-factor split) or fft_impl="stockham" (the radix-4/radix-2 Stockham
// passes, which the reference reaches through _run_segment -> _run_fft ->
// _fft_stockham, src/repro/kernels/fft4step.py:422; N any power of two
// from 2 to 4096), both from spectral_common.cuh.
//
// Each kernel is instantiated once per FFT route (template flag
// kStockham); one fft_impl covers all segments of a call, and the host
// checks that every transforming segment is on the instantiation's route.
//
// mega_resident — one CTA holds one scene's whole split slab in shared
// memory: na * nr * 8 bytes, at most the 232,448 B a Hopper block may opt
// in to and 16384 points, i.e. up to 128 x 128 (128 KiB). Grid = batch.
// Each segment runs in place on the slab through the strided stages of
// spectral_common.cuh: a row segment contracts along the slab's rows, a
// column segment along its columns, so the corner turn is purely logical,
// as on the TPU. A segment starts and ends in natural order (an
// inverse-only segment first permutes into the transposed order, a
// forward-only one back out of it, both staged through registers between
// two barriers, in rounds of whole lines), so the next segment's per-line
// filter index is the natural one. The matmul route runs the tensor-core
// stage at up to 512 threads (the same fragment arithmetic as spectral.cu,
// in as many rounds of lines as the slab needs) and reads F1 and F2 from
// device memory (L1) in place, so the slab keeps the shared memory; the
// Stockham route holds the slab as 16 points a thread in registers (32 at
// 512 threads; the 128^2 slab of the main path 16 at 1024 threads in a
// specialisation with its ops inlined), one exchange through the
// (swizzled) slab a pair of passes, a fwd+inv segment turned around in
// registers where N allows it, the inverse's 1/N on its last write
// (stockham_op). DFT
// constants, the Stockham twiddle table, u, v, shared vectors and FULL
// filters are read from global memory in place. Nothing of the scene goes
// to device memory between segments.
//   What bounds it: per scene it moves 16 B a point once (0.010 ms for
// 132 scenes of 128^2 at 3.35 TB/s); its stages, their shared-memory
// loads and barriers are what it spends its time on, with one CTA per SM.
//
// mega_staged — a persistent cooperative kernel for scenes that do not
// fit one block. Launched with cudaLaunchCooperativeKernel on at most the
// co-resident block count (occupancy x SMs, queried after the dynamic
// shared-memory attribute is set). One phase per segment: each block walks
// the (scene, tile) pairs of the phase, a tile being whole lines of 16384
// points (4 rows or 4 columns at N = 4096, 128 KiB: what 512 threads
// stage in two rounds of the tensor-core stage, or hold as 32 points a
// thread on the Stockham route; its rows and other lengths take 8192
// points, 16 a thread), and runs the per-axis op of spectral.cu on it
// (tile_op: load, stages, filter, stages, store). The Stockham route runs
// 512 threads too (128 registers), specialised with its ops inlined when
// every transform has N = 4096. On the matmul route F1 and F2 are
// copied into shared memory past the tile once per phase (34 KiB at
// N = 4096, one matrix, so a block takes 162 KiB), and the block runs 512
// threads at up to 128 registers (__launch_bounds__(512, 1)). Phases are
// separated by a grid-wide barrier
// (cooperative_groups::this_grid().sync()). The corner-turned intermediate
// lives in device memory, and the OUTPUT buffer serves as that scratch:
// each block reads its whole tile into shared memory before it writes the
// tile back, and the tiles of one phase are disjoint, so phase p may read
// and write the same buffer. The buffer is read through __ldcg (L2), never
// a read-only path: other blocks wrote it before the barrier. No cp.async
// or TMA prefetch of the next tile (buffer_depth is validated only): a
// second 128 KiB tile does not fit beside the tile and the F matrix.
//   What bounds it at 4096^2: the whole fused1 call must read the raw scene
// and write the image once, 268 MB, 0.080 ms at 3.35 TB/s; staged through
// device memory it moves the scene once per phase, 3 x 268 MB, 0.24 ms.
// fused1's four transforms take ~0.42 ms of 3xTF32 tensor-core work at
// 495 TFLOP/s; with one block per SM that cannot overlap a tile's load,
// stages and store, the phases' I/O and the stages add up rather than
// overlap. On the Stockham route (~0.06 ms of nominal flops) the three
// device-memory round trips: each tile's first pair of passes loads it
// straight into registers and its last pair stores it, one exchange
// through shared memory a pair between them; rows synchronise per line
// (2 lines of 256 threads at N = 4096), columns per block.
//
// The matmul route's operand forms (bf16, f16, bs16, Karatsuba; the
// stages of spectral_common.cuh) are template parameters of both kernels
// (kOp, kKara), one instantiation each, so the f32 form's code is the same
// as without them; Karatsuba is chosen per segment (the table's kara
// field), both stage forms compiled into the kernel that takes it
// (kKara = 2).
//
// bs16 (on the Stockham route bf16 and f16 are its f32 passes): every segment
// runs the codec of one spectral.cu launch — each line's exponent taken on
// the segment's load, the line scaled by 2^-e there and by 2^e at its store
// — which is, point for point, fft4step.mega_plain's carrying the exponents
// to the next segment boundary and applying them once at the end (a staged
// tile holds whole lines, a resident slab every line, so each reduction
// stays inside one block). mega_staged codes in registers, as spectral.cu
// does; mega_resident codes the slab in shared memory before and after the
// segment (an exponent a line past the slab), and so does the matmul
// route's tile_op its tile. The codec is a template flag
// of both kernels (kBs): the f32 instantiations carry none of its code.
//
// Both kernels run, for each point, exactly the operations of spectral.cu's
// launches (spectral_common.cuh, -fmad=false), so at f32 they equal the
// three-launch fused3 chain and each other bit for bit.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// -shared -Xcompiler -fPIC; bound through ctypes by
// src/repro_torch/kernels/_build.py and src/repro_torch/kernels/ops.py.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "spectral_common.cuh"

namespace cg = cooperative_groups;

// This source builds the Stockham route and the matmul route's f32 form;
// mega_forms.cu includes it with MEGA_OPERAND_FORMS set, to build the
// matmul route's other operand forms (bf16, f16, bs16, Karatsuba) into a
// library of their own, so that the two compile side by side. Each
// library refuses the calls the other takes.
#ifndef MEGA_OPERAND_FORMS
#define MEGA_OPERAND_FORMS 0
#endif

namespace {

using namespace spectral;

constexpr int kMaxSegments = 8;
constexpr int kSegFields = 27;   // int64 fields per segment in the table

struct Segment {
  Dft d;
  Filter f;
  int axis, fwd, inv;
  int tile;           // mega_staged: lines per tile
  int kara;           // the matmul route: Karatsuba in this segment
};

// mega_resident's thread bound: the 128^2 Stockham specialisation holds
// its slab as 16 points a thread of 1024 (inlined, 64 registers: 0.57x
// the time of the 512 x 32 slab ops out of line, PERF.md); otherwise 512.
constexpr int resident_threads(bool stockham, int n) {
  return stockham && n == 128 ? 2 * kStockhamThreads
         : stockham           ? kStockhamThreads
                              : kMmaThreads;
}

struct MegaArgs {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  int batch, na, nr, nseg;
  int bs;             // the bs16 codec in every segment (the route's choice)
  int op;             // the matmul route's operand form (Operand)
  Segment seg[kMaxSegments];
};

// One segment in place on the resident slab (lines in natural order on
// entry and on exit). The Stockham route keeps the slab swizzled (swz) and
// runs stockham_op in place, its inverse's 1/N and conjugate on the last
// step's write; a filter-only segment is one pass over the slab. kN > 0:
// every transform of the kernel has N = kN (stockham_op inlines it). kBs
// (Stockham route): the slab's lines coded before the segment and decoded
// after it, their exponents in ex — on the matmul route too, whose stages
// run the operand form (kOp; kKara as transform_k's, the segment's own
// g.kara where kKara == 2).
template <bool kLineFast, bool kStockham, int kN, bool kBs, int kOp,
          int kKara>
__device__ __forceinline__ void resident_segment(const Lines& L,
                                                 const Segment& g, int* ex) {
  const Dft& d = g.d;
  const bool fwd = g.fwd, inv = g.inv;
  if constexpr (kStockham) {
    if constexpr (kBs) lines_encode<kLineFast, true>(L, ex);
    if (fwd || inv) {
      // 32 points a thread where 16 do not cover the slab (one round of
      // 512 threads for 128^2); else 16, in rounds of the lines the block
      // holds at once where even that does not cover it (N < 32)
      const float scale = inverse_scale(inv, d.n);
      const int points = stockham_per_thread(L.lines * d.n, d.n, blockDim.x);
      const int units = d.n / points;
      const int round = units > 0 ? (int)blockDim.x / units
                                  : (int)blockDim.x * points / d.n;
      for (int line0 = 0; line0 < L.lines; line0 += round) {
        stockham_op<kLineFast, false, kN>(L, Io{}, d.stw, fwd, inv, g.f, 0,
                                          L.lines, scale,
                                          inv ? -scale : 1.0f,
                                          LineSync{0, 0}, line0, points);
      }
    } else {
      filter_pass<kLineFast, true>(L, g.f, 0, L.lines, false, 1, 1);
    }
    if constexpr (kBs) lines_decode<kLineFast, true>(L, ex);
    return;
  }
  const Mats m = mats_in_place(d);
  if constexpr (kBs) lines_encode<kLineFast, false>(L, ex);
  if (!fwd && inv) {
    reorder<kLineFast>(L, kToTransposed, d.n1, d.n2, 1.0f, 1.0f);
  }
  if (fwd) transform_k<kLineFast, kOp, kKara>(L, d, m, false, g.kara);
  if (g.f.mode != kNone) {
    filter_pass<kLineFast>(L, g.f, 0, L.lines, fwd || inv, d.n1, d.n2);
  }
  if (inv) {
    transform_k<kLineFast, kOp, kKara>(L, d, m, true, g.kara);
    const float scale = inverse_scale(true, d.n);
    reorder<kLineFast>(L, kKeep, d.n1, d.n2, scale, -scale);
  } else if (fwd) {
    reorder<kLineFast>(L, kToNatural, d.n1, d.n2, 1.0f, 1.0f);
  }
  // the inverse's 1/N came with its reorder: 2^e after it, as the plain
  // version orders them
  if constexpr (kBs) lines_decode<kLineFast, false>(L, ex);
}

// grid = batch; one scene per CTA, its (na, nr) slab at s[a * nr + r]
// (s[swz(a * nr + r)] on the Stockham route), the codec's exponents past it.
// Naming one block per SM gives ptxas the whole register file of the
// thread bound (64 registers at 1024 threads, 128 at 512); under the
// thread bound alone it held the kernel to 32 (8.5 KB of spills). A 128^2
// slab takes one SM's shared memory anyway. kN: as resident_segment's
// (the Stockham route's 128^2 slabs, the main path's, take kN = 128);
// kOp, kKara: the matmul route's operand form (resident_segment's).
template <bool kStockham, int kN, bool kBs, int kOp = kTf32x3, int kKara = 0>
__global__ void __launch_bounds__(resident_threads(kStockham, kN), 1)
mega_resident(const __grid_constant__ MegaArgs a) {
  extern __shared__ float2 s[];
  const int na = a.na, nr = a.nr;
  const int total = na * nr;
  const long long scene = (long long)blockIdx.x * total;
  int* ex = reinterpret_cast<int*>(s + (kStockham ? stockham_points(total)
                                                  : total));
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    s[kStockham ? swz(i) : i] = make_float2(a.xr[scene + i], a.xi[scene + i]);
  }
  __syncthreads();
  for (int k = 0; k < a.nseg; ++k) {
    const Segment& g = a.seg[k];
    if (g.axis == 1) {   // rows
      resident_segment<false, kStockham, kN, kBs, kOp, kKara>(
          Lines{s, na, nr, nr, 1}, g, ex);
    } else {             // columns
      resident_segment<true, kStockham, kN, kBs, kOp, kKara>(
          Lines{s, nr, na, 1, nr}, g, ex);
    }
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const float2 v = s[kStockham ? swz(i) : i];
    a.yr[scene + i] = v.x;
    a.yi[scene + i] = v.y;
  }
}

// Persistent: each block walks the (scene, tile) pairs of every phase.
// grid.sync() compiles to a call, and with the thread bound alone ptxas
// then holds the whole kernel to 32 registers (3.9 KB of spills); naming
// the one block per SM it runs at gives it the whole register file of the
// thread bound. The matmul route copies the phase's F1 and F2 into shared
// memory past the tile once per phase: the last phase's final barrier and
// grid.sync() order the copy after every read of the previous one, and
// the first tile's load barrier before every read of this one. kN > 0:
// every transform has N = kN and its Stockham ops are inlined (the main
// path's 4096^2 scene takes kN = 4096: out of line they spilled 1-3 KB
// each under this kernel's register budget). kOp, kKara: the matmul
// route's operand form (tile_op's), each segment's Karatsuba its own.
template <bool kStockham, int kN, bool kBs, int kOp = kTf32x3, int kKara = 0>
__global__ void __launch_bounds__(kStockham ? kStockhamThreads : kMmaThreads,
                                  1)
mega_staged(const __grid_constant__ MegaArgs a) {
  extern __shared__ float2 s[];
  cg::grid_group grid = cg::this_grid();
  const long long scene_points = (long long)a.na * a.nr;
  for (int k = 0; k < a.nseg; ++k) {
    const Segment& g = a.seg[k];
    const int lines = g.axis == 1 ? a.na : a.nr;
    const int C = g.tile;
    const int tiles = (lines + C - 1) / C;
    Mats m{};
    if constexpr (!kStockham) {
      if (g.fwd || g.inv) {
        m = mats_to_shared(reinterpret_cast<float*>(s + C * g.d.n), g.d);
      }
    }
    // phase 0 reads the input; later phases the intermediate in the output
    const float* xr = k == 0 ? a.xr : a.yr;
    const float* xi = k == 0 ? a.xi : a.yi;
    for (int t = blockIdx.x; t < a.batch * tiles; t += gridDim.x) {
      const int b = t / tiles;
      tile_op<kStockham, kN, kBs, kOp, kKara>(
          s, xr, xi, a.yr, a.yi, b * scene_points, lines, (t - b * tiles) * C,
          C, g.axis, g.fwd, g.inv, g.d, m, g.f, g.kara);
      __syncthreads();   // the next tile's load overwrites s
    }
    if (k + 1 < a.nseg) grid.sync();
  }
}

template <typename T>
const T* as_ptr(long long v) {
  return reinterpret_cast<const T*>(static_cast<uintptr_t>(v));
}

// Fill MegaArgs from the host's segment table (kSegFields int64 a segment:
// axis, fwd, inv, mode, rank, n, n1, n2, tile, f1r, f1i, f2r, f2i, twr,
// twi, hr, hi, h_line, h_k, u, v, u_line, u_k, v_n, v_k, stw, kara). A
// non-null stw (the Stockham twiddle table) puts the segment on the
// Stockham route; kara (the matmul route) its stages on Karatsuba.
cudaError_t unpack(MegaArgs& a, const float* xr, const float* xi, float* yr,
                   float* yi, int batch, int na, int nr, int nseg, int bs,
                   int op, const long long* table) {
  if (nseg < 1 || nseg > kMaxSegments || batch < 1 || na < 1 || nr < 1 ||
      op < kTf32x3 || op > kF16 || (bs && op != kF16)) {
    return cudaErrorInvalidValue;
  }
  a.xr = xr; a.xi = xi; a.yr = yr; a.yi = yi;
  a.batch = batch; a.na = na; a.nr = nr; a.nseg = nseg; a.bs = bs;
  a.op = op;
  for (int k = 0; k < nseg; ++k) {
    const long long* r = table + (long long)k * kSegFields;
    Segment& g = a.seg[k];
    g.axis = (int)r[0]; g.fwd = (int)r[1]; g.inv = (int)r[2];
    g.f.mode = (int)r[3]; g.f.rank = (int)r[4];
    g.d.n = (int)r[5]; g.d.n1 = (int)r[6]; g.d.n2 = (int)r[7];
    g.tile = (int)r[8];
    g.d.f1r = as_ptr<float>(r[9]);  g.d.f1i = as_ptr<float>(r[10]);
    g.d.f2r = as_ptr<float>(r[11]); g.d.f2i = as_ptr<float>(r[12]);
    g.d.twr = as_ptr<float>(r[13]); g.d.twi = as_ptr<float>(r[14]);
    g.f.hr = as_ptr<float>(r[15]);  g.f.hi = as_ptr<float>(r[16]);
    g.f.h_line = r[17]; g.f.h_k = r[18];
    g.f.u = as_ptr<float>(r[19]);   g.f.v = as_ptr<float>(r[20]);
    g.f.u_line = r[21]; g.f.u_k = r[22]; g.f.v_n = r[23]; g.f.v_k = r[24];
    g.d.stw = as_ptr<float2>(r[25]);
    g.kara = (int)r[26];
    if (g.axis != 0 && g.axis != 1) return cudaErrorInvalidValue;
    if (g.kara && (g.d.stw != nullptr || !(g.fwd || g.inv))) {
      g.kara = 0;     // no stage runs Karatsuba there
    }
    if (g.d.n != (g.axis == 1 ? nr : na)) return cudaErrorInvalidValue;
    const int n = g.d.n;
    if ((g.fwd || g.inv) &&
        (g.d.stw != nullptr ? n < 2 || (n & (n - 1)) != 0
                            : g.d.n1 * g.d.n2 != n)) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

// The route of a call: Stockham iff a transforming segment carries the
// twiddle table. Every transforming segment must agree (-1 otherwise). A
// chain of filter-only segments runs the matmul instantiation, or, with the
// bs16 codec, the Stockham one (a filter-only segment's codec is the same
// on both routes).
int route(const MegaArgs& a) {
  int r = 0, seen = 0;
  for (int k = 0; k < a.nseg; ++k) {
    const Segment& g = a.seg[k];
    if (!(g.fwd || g.inv)) continue;
    const int sk = g.d.stw != nullptr;
    if (seen && sk != r) return -1;
    r = sk;
    seen = 1;
  }
  return seen ? r : (a.bs != 0);
}

// Whether a transforming segment runs Karatsuba (the matmul route).
bool any_kara(const MegaArgs& a) {
  for (int k = 0; k < a.nseg; ++k) {
    if (a.seg[k].kara) return true;
  }
  return false;
}

// The N of every transforming segment when they agree, else 0.
int transform_n(const MegaArgs& a) {
  int n = 0;
  for (int k = 0; k < a.nseg; ++k) {
    const Segment& g = a.seg[k];
    if (!(g.fwd || g.inv)) continue;
    if (n != 0 && g.d.n != n) return 0;
    n = g.d.n;
  }
  return n;
}

// Shared memory of a mega_staged phase: its tile (whole runs of 16 points
// on the Stockham route, for swz), and on the matmul route F1 and F2 past
// it; with bs the codec's words: on the Stockham route past the tile, two
// a thread for a transform, or one a line (codec_words); on the matmul
// route an exponent a line past F1 and F2 (tile_op).
size_t staged_smem(const Segment& g, bool stockham, bool bs) {
  const int points = g.tile * g.d.n;
  size_t bytes =
      (size_t)(stockham ? stockham_points(points) : points) * sizeof(float2);
  if (!stockham && (g.fwd || g.inv || bs)) {
    bytes += dft_smem_floats(g.d.n1, g.d.n2) * sizeof(float);
  }
  if (bs) {
    bytes += (stockham ? codec_words(g.tile, kStockhamThreads) : g.tile) *
             sizeof(int);
  }
  return bytes;
}

// f(op, bs, kara) with the matmul route's operand form as compile-time
// constants (std::integral_constant): bs16 is f16 behind the codec, and
// kara puts each segment's Karatsuba in (kKara = 2). This library's forms
// alone (MEGA_OPERAND_FORMS): f32 without Karatsuba, or every other.
template <class F>
cudaError_t with_form(int op, bool bs, bool kara, F&& f) {
  using Yes = std::true_type;
  using No = std::false_type;
  using Tf32 = std::integral_constant<int, kTf32x3>;
  using Bf16 = std::integral_constant<int, kBf16>;
  using F16 = std::integral_constant<int, kF16>;
  const bool form = op != kTf32x3 || bs || kara;   // not the f32 form
  if (form != (MEGA_OPERAND_FORMS != 0)) {
    return cudaErrorInvalidValue;   // the other library's call
  }
#if !MEGA_OPERAND_FORMS
  return f(Tf32{}, No{}, No{});
#else
  if (bs) {
    if (op != kF16) return cudaErrorInvalidValue;
    return kara ? f(F16{}, Yes{}, Yes{}) : f(F16{}, Yes{}, No{});
  }
  switch (op) {
    case kTf32x3:
      return f(Tf32{}, No{}, Yes{});
    case kBf16:
      return kara ? f(Bf16{}, No{}, Yes{}) : f(Bf16{}, No{}, No{});
    case kF16:
      return kara ? f(F16{}, No{}, Yes{}) : f(F16{}, No{}, No{});
    default:
      return cudaErrorInvalidValue;
  }
#endif
}

template <bool kStockham, int kN, bool kBs = false, int kOp = kTf32x3,
          int kKara = 0>
cudaError_t launch_resident(const MegaArgs& a, int threads, size_t smem,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_resident<kStockham, kN, kBs, kOp, kKara>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mega_resident<kStockham, kN, kBs, kOp, kKara>
      <<<a.batch, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Blocks of mega_staged<kStockham, kN> one SM holds with `smem` bytes of
// dynamic shared memory (after setting the attribute), or the error.
template <bool kStockham, int kN, bool kBs = false, int kOp = kTf32x3,
          int kKara = 0>
cudaError_t staged_per_sm(size_t smem, int& per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_staged<kStockham, kN, kBs, kOp, kKara>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_staged<kStockham, kN, kBs, kOp, kKara>,
      kStockham ? kStockhamThreads : kMmaThreads, smem);
}

template <bool kStockham, int kN, bool kBs = false, int kOp = kTf32x3,
          int kKara = 0>
cudaError_t launch_staged(MegaArgs& a, long long work, size_t smem,
                          cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((err = staged_per_sm<kStockham, kN, kBs, kOp, kKara>(smem, per_sm)) !=
      cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)std::min((long long)per_sm * sms, work);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)mega_staged<kStockham, kN,
                                                            kBs, kOp, kKara>,
                                    dim3(grid),
                                    dim3(kStockham ? kStockhamThreads
                                                   : kMmaThreads),
                                    params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return the launch's error code
// (cudaGetLastError() after it; 0 on success). The caller has checked
// shapes, types, devices and contiguity.

// block_scaled: the bs16 codec in every segment. op: the matmul route's
// operand form (0 f32 as 3xTF32, 1 bf16, 2 f16; 2 with block_scaled for
// bs16), which the Stockham route ignores (its bf16 and f16 are its f32
// passes); each segment's Karatsuba is its table record's.

int mega_resident_launch(const float* xr, const float* xi, float* yr,
                         float* yi, int batch, int na, int nr, int nseg,
                         int block_scaled, int op, const long long* table,
                         void* stream) {
  MegaArgs a;
  cudaError_t err = unpack(a, xr, xi, yr, yi, batch, na, nr, nseg,
                           block_scaled, op, table);
  if (err != cudaSuccess) return (int)err;
  const int r = route(a);
  if (r < 0) return (int)cudaErrorInvalidValue;
  const int total = na * nr;
  const int need = ((total + kPerThread - 1) / kPerThread + 31) / 32 * 32;
  // Stockham: up to 512 threads, 16 points a thread, rounds of lines;
  // matmul: 256..512 threads, the stages and reorder loop over rounds of
  // lines
  const bool n128 = r && transform_n(a) == 128;
  const int threads =
      r ? std::min(resident_threads(true, n128 ? 128 : 0), need)
        : std::min(kMmaThreads, std::max(256, need));
  if (r) {   // every segment's line fits the threads of a round
    for (int k = 0; k < nseg; ++k) {
      const int n = a.seg[k].d.n;
      if (n / stockham_per_thread(total, n, threads) > threads) {
        return (int)cudaErrorInvalidConfiguration;
      }
    }
  }
  for (int k = 0; k < nseg; ++k) {
    const Segment& g = a.seg[k];
    if (!r && (g.fwd || g.inv) &&
        !(mma_fits(threads, g.d.n1, g.d.n2) &&
          mma_fits(threads, g.d.n2, g.d.n1))) {
      return (int)cudaErrorInvalidConfiguration;
    }
  }
  const size_t smem =
      (size_t)(r ? stockham_points(total) : total) * sizeof(float2) +
      (block_scaled ? (size_t)std::max(na, nr) * sizeof(int) : 0);
  const cudaStream_t st = (cudaStream_t)stream;
  if (!r) {
    return (int)with_form(a.op, block_scaled, any_kara(a),
                          [&](auto op, auto bs, auto kara) {
      return launch_resident<false, 0, decltype(bs)::value,
                             decltype(op)::value,
                             decltype(kara)::value ? 2 : 0>(a, threads, smem,
                                                            st);
    });
  }
#if MEGA_OPERAND_FORMS
  return (int)cudaErrorInvalidValue;    // the Stockham route: mega.cu's
#else
  if (block_scaled) {
    return (int)(n128 ? launch_resident<true, 128, true>(a, threads, smem, st)
                      : launch_resident<true, 0, true>(a, threads, smem, st));
  }
  return (int)(n128 ? launch_resident<true, 128>(a, threads, smem, st)
                   : launch_resident<true, 0>(a, threads, smem, st));
#endif
}

int mega_staged_launch(const float* xr, const float* xi, float* yr,
                       float* yi, int batch, int na, int nr, int nseg,
                       int buffer_depth, int block_scaled, int op,
                       const long long* table, void* stream) {
  if (buffer_depth < 1) return (int)cudaErrorInvalidValue;
  MegaArgs a;
  cudaError_t err = unpack(a, xr, xi, yr, yi, batch, na, nr, nseg,
                           block_scaled, op, table);
  if (err != cudaSuccess) return (int)err;
  const int r = route(a);
  if (r < 0) return (int)cudaErrorInvalidValue;
  const int threads = r ? kStockhamThreads : kMmaThreads;
  size_t smem = 0;
  long long work = 0;
  for (int k = 0; k < nseg; ++k) {
    const Segment& g = a.seg[k];
    const int lines = g.axis == 1 ? na : nr;
    const int per = stockham_per_thread(g.tile * g.d.n, g.d.n);
    if (g.tile < 1 || (r ? g.tile * g.d.n > kStockhamThreads * per ||
                               !stockham_tile_built(g.axis, g.d.n, per)
                         : (g.fwd || g.inv) &&
                               !(mma_fits(threads, g.d.n1, g.d.n2) &&
                                 mma_fits(threads, g.d.n2, g.d.n1)))) {
      return (int)cudaErrorInvalidConfiguration;
    }
    smem = std::max(smem, staged_smem(g, r, block_scaled));
    work = std::max(work,
                    (long long)batch * ((lines + g.tile - 1) / g.tile));
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (!r) {
    return (int)with_form(a.op, block_scaled, any_kara(a),
                          [&](auto op, auto bs, auto kara) {
      return launch_staged<false, 0, decltype(bs)::value,
                           decltype(op)::value,
                           decltype(kara)::value ? 2 : 0>(a, work, smem, st);
    });
  }
#if MEGA_OPERAND_FORMS
  return (int)cudaErrorInvalidValue;    // the Stockham route: mega.cu's
#else
  const bool n4096 = transform_n(a) == 4096;
  if (block_scaled) {
    return (int)(n4096 ? launch_staged<true, 4096, true>(a, work, smem, st)
                       : launch_staged<true, 0, true>(a, work, smem, st));
  }
  return (int)(n4096 ? launch_staged<true, 4096>(a, work, smem, st)
                     : launch_staged<true, 0>(a, work, smem, st));
#endif
}

#if !MEGA_OPERAND_FORMS
// Blocks of mega_staged on the given route (stockham != 0) one SM holds
// with `smem` bytes of dynamic shared memory (-1 on error): its persistent
// grid is this times the SM count.
int mega_staged_blocks_per_sm(long long smem, int stockham) {
  int per_sm = 0;
  const cudaError_t err =
      stockham ? staged_per_sm<true, 0>((size_t)smem, per_sm)
               : staged_per_sm<false, 0>((size_t)smem, per_sm);
  return err == cudaSuccess ? per_sm : -1;
}
#endif

// cudaDevAttrMaxSharedMemoryPerBlockOptin of device `dev` (-1 on error).
int mega_smem_optin(int dev) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return v;
}

const char* mega_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
