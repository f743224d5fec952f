// mega_staged at the matmul route's other operand forms (bf16, f16, bs16,
// Karatsuba; mega_forms.cu's, whose library holds mega_resident's), built
// into a library of its own so that the two compile side by side. The
// same C entry points as mega.cu's; each library refuses the calls the
// others take, and src/repro_torch/kernels/ops.py picks the library by
// the call's kernel, form and segments.
#define MEGA_OPERAND_FORMS 1
#define MEGA_KERNELS 2
#include "mega.cu"
