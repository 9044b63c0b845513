// Stands in for the CUDA runtime header when a host compiler builds a
// kernel source for the CPU tests (tests/test_torch_eval_pack.py,
// tests/test_torch_win_decode.py, tests/test_torch_seed.py,
// tests/test_torch_screen_dp.py): the qualifiers
// vanish and the built-ins the kernels use become plain functions.
//
// eval_pack.cu's and screen_dp.cu's host builds play the 32 lanes of a
// warp in one thread, one
// phase after another (its lane loops): the warp reductions below return
// what the lane loop has already reduced over the warp, __syncwarp has
// nothing to wait for, and the asynchronous copies are plain copies made at
// once.  The copies check the alignment the card's cp.async demands of both
// addresses and record a misaligned one in host_fault, which the source's
// host launch returns (as the card would report a misaligned address);
// win_decode.cu's host build plays a block's threads in one thread, phase
// by phase, so __syncthreads has nothing to wait for either; its 16-byte
// stores go through the same check.  seed.cu's host build plays a block's
// threads phase by phase too: its atomics are plain read-modify-writes, one
// thread at a time; its look-back and slot counts have host forms in the
// source, and its cp.async copies and __brev are plain ones.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct float4 { float x, y, z, w; };
// 16-byte aligned as on the card: a 16-byte store copies from one
struct alignas(16) int4 { int x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
    return float4{x, y, z, w};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) {
    int i;
    std::memcpy(&i, &f, sizeof i);
    return i;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline unsigned __brev(unsigned x) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
    return r;
}
inline int __clz(int x) {
    return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
}
using std::max;
using std::min;
// the DPX add-max of screen_dp.cu's cell: max(a + b, c) (and 0)
inline int __viaddmax_s32(int a, int b, int c) { return std::max(a + b, c); }
inline int __viaddmax_s32_relu(int a, int b, int c) {
    return std::max(std::max(a + b, c), 0);
}
// byte i of the result is byte (s >> 4 i) & 7 of y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const unsigned long long v = (unsigned long long)y << 32 | x;
    unsigned r = 0;
    for (int i = 0; i < 4; ++i)
        r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
    return r;
}

typedef void* cudaStream_t;
enum cudaError_t {
    cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
    cudaErrorMisalignedAddress = 716, cudaErrorLaunchFailure = 719
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
    return cudaSuccess;
}

// warp collectives over a warp the host has already walked lane by lane
inline int __reduce_max_sync(unsigned, int v) { return v; }
inline unsigned __reduce_or_sync(unsigned, unsigned v) { return v; }
inline void __syncwarp() {}
inline void __syncthreads() {}

// atomics of a block whose threads the host plays one after another
inline int atomicAdd(int* p, int v) { const int old = *p; *p = old + v; return old; }
inline int atomicOr(int* p, int v) { const int old = *p; *p = old | v; return old; }
inline int atomicAnd(int* p, int v) { const int old = *p; *p = old & v; return old; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    const unsigned old = *p; *p = old + v; return old;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
    const unsigned old = *p; *p = old | v; return old;
}

// cp.async of 4 and 16 bytes, commit and wait
static int host_fault;
inline void host_copy(int* dst, const int* src, int bytes) {
    if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
        % bytes)
        host_fault = cudaErrorMisalignedAddress;
    std::memcpy(dst, src, bytes);
}
inline void async_copy_word(int* dst, const int* src) {
    host_copy(dst, src, 4);
}
inline void async_copy_16(int* dst, const int* src) {
    host_copy(dst, src, 16);
}
inline void async_commit() {}
template <int N> inline void async_wait() {}
