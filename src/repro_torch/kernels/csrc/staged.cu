// mega_staged of mega.cu (the Stockham route and the matmul route's f32
// form, lines of one block), built into a library of its own so that it
// compiles beside mega.cu's mega_resident instead of after it (the file's
// name holds no kernel's name: the anonymous namespace of its mangled
// names carries it). The same C entry points as mega.cu's; each library
// refuses the calls the others take, and src/repro_torch/kernels/ops.py
// picks the library by the call's kernel, form and segments.
#define MEGA_KERNELS 2
#include "mega.cu"
