// spectral.cu's spectral_long at the forms other than f32: lines past one
// block (or a three-factor split) at bf16, f16 and bs16 with or without
// Karatsuba on the matmul route (and f32 with Karatsuba), and bs16 on the
// Stockham route (csrc/long_lines.cuh), built into a library of its own
// (SPECTRAL_LONG_FORMS) so that it compiles beside spectral.cu, whose
// instantiations keep their code. The same C entry point
// spectral_long_launch; each library refuses the calls the other takes,
// and src/repro_torch/kernels/ops.py picks the library by the call's form.
#define SPECTRAL_LONG_FORMS 1
#include "spectral.cu"
