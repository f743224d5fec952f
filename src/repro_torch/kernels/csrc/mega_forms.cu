// The matmul route's other operand forms of both megakernels — bf16 and
// f16 on mma.sync.m16n8k16, bs16 (f16 behind the per-line exponent codec)
// and Karatsuba per segment — built from mega.cu into a library of their
// own (MEGA_OPERAND_FORMS), so that they compile beside mega.cu's f32 and
// Stockham instantiations instead of after them. The same C entry points
// as mega.cu's; each library refuses the calls the other takes, and
// src/repro_torch/kernels/ops.py picks the library by the call's form.
#define MEGA_OPERAND_FORMS 1
#include "mega.cu"
