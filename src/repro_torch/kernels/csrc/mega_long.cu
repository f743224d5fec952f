// mega_resident for chains with a segment past one block (a line over
// 4096 points, or a three-factor split; csrc/long_lines.cuh's passes on
// the slab; also batch_block > 1 scenes a block), at f32 on both FFT
// routes (and the Stockham route's bf16 and f16, its f32 passes; the other
// forms build from mega_long_forms.cu; mega_staged for such chains from
// staged_long.cu) — built from mega.cu into a library of its own
// (MEGA_LONG_LINES), so that it compiles beside mega.cu's and
// mega_forms.cu's instantiations instead of after them, and so that theirs
// keep their code. The same C entry points as mega.cu's; each library
// refuses the calls the others take, and src/repro_torch/kernels/ops.py
// picks the library by the call's form and segments.
#define MEGA_LONG_LINES 1
#define MEGA_KERNELS 1
#include "mega.cu"
