// mega_resident's Stockham route at bs16 on lines of one block (and a
// chain of filter-only segments behind the bs16 codec), built from mega.cu
// into a library of its own so that it compiles beside mega.cu's other
// mega_resident instantiations. The same C entry points as mega.cu's;
// each library refuses the calls the others take, and
// src/repro_torch/kernels/ops.py picks the library by the call's kernel,
// form and segments.
#define MEGA_KERNELS 4
#include "mega.cu"
