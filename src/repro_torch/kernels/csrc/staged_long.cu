// mega_staged of mega.cu for chains with a segment past one block (a line
// over 4096 points, or a three-factor split) at f32 on both FFT routes (and
// the Stockham route's bf16 and f16, its f32 passes): long_lines.cuh's
// passes as phases of their own. A library of its own beside mega_long.cu
// (mega_resident's), so that the two compile side by side and the long
// passes' out-of-line Stockham ops are this module's alone: in one module
// with mega_resident, whose slab passes call the same stockham_n, ptxas
// gave the passes' long_op 2,256-2,796 B of spill stores against
// spectral.cu's 168-568 and the long segments ran 1.3-2x slower than
// spectral_long (PERF.md). The same C entry points as mega.cu's;
// each library refuses the calls the others take, and
// src/repro_torch/kernels/ops.py picks the library by the call's kernel,
// form and segments.
#define MEGA_LONG_LINES 1
#define MEGA_KERNELS 2
#include "mega.cu"
