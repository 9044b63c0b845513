// Stands in for the CUDA runtime header when a host compiler builds a
// kernel source for the CPU tests (tests/test_torch_eval_pack.py): the
// qualifiers vanish, the built-ins the kernels use become plain functions,
// and blockIdx/threadIdx are variables the source's host loop sets.
#pragma once

#include <algorithm>
#include <cstring>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
    return float4{x, y, z, w};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) {
    int i;
    std::memcpy(&i, &f, sizeof i);
    return i;
}
using std::max;
using std::min;

struct Index3 { unsigned x, y, z; };
static Index3 blockIdx, threadIdx;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
