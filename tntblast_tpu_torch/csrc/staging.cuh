// What the kernels share for moving rows between device memory and a
// warp's staging buffer in shared memory: the (row, column) walk over a
// contiguous span of rows, and the opt-in to more than 48 KB of dynamic
// shared memory.  screen_dp.cu stores its M rows through a staging buffer
// (dp_core.cuh includes this header), eval_pack.cu loads them through one.
// Nothing here needs more of the CUDA runtime than the host build of
// eval_pack.cu finds in tests/cuda_host_shim.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Walks a contiguous span of rows of `width` words as (row, column) without
// a division a step: element e = row * width + col, advanced by `step`.
struct SpanIndex {
    int row, col;
    __device__ __forceinline__ SpanIndex(int e, int width)
        : row(e / width), col(e % width) {}
    __device__ __forceinline__ void advance(int step, int width) {
        col += step;
        while (col >= width) { col -= width; ++row; }
    }
};

// Shared memory above 48 KB has to be opted into, and the attribute is per
// device: a mesh launches on cards other than the first.  `opted` holds, for
// every card, the bytes one kernel was last allowed there.
#define MAX_DEVICES 64

template <class K>
static cudaError_t allow_shared_memory(K kernel, int (&opted)[MAX_DEVICES],
                                       int bytes)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (bytes <= opted[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) opted[dev] = bytes;
    return err;
}
