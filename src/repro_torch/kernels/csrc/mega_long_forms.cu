// mega_resident for chains with a segment past one block (a line over
// 4096 points, or a three-factor split; also with batch_block > 1 scenes a
// block) at the forms other than f32 (mega_staged's:
// staged_long_forms.cu):
// csrc/long_lines.cuh's passes at bf16, f16 and bs16 with
// Karatsuba per segment on the matmul route (and f32 with Karatsuba), and
// bs16 on the Stockham route — built from mega.cu into a library of its own
// (MEGA_LONG_LINES with MEGA_OPERAND_FORMS), so that it compiles beside
// mega.cu's, mega_forms.cu's and mega_long.cu's instantiations, and theirs
// keep their code. The same C entry points as mega.cu's; each library
// refuses the calls the others take, and src/repro_torch/kernels/ops.py
// picks the library by the call's form and segments.
#define MEGA_LONG_LINES 1
#define MEGA_OPERAND_FORMS 1
#include "mega.cu"
