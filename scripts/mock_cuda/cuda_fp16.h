#pragma once
#include "cuda_runtime.h"
struct __half2 { _Float16 x, y; };
inline __half2 __floats2half2_rn(float a, float b) { return {(_Float16)a, (_Float16)b}; }
