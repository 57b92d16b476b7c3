// Row-local scatter-max: out[r, x] = max{val[r, m] : idx[r, m] == x, mask},
// 0 when nothing hits.
//
// Replaces corrosion_tpu/ops/onehot.py `_rowmax_kernel` (via `rowmax` /
// `_rowmax_pallas`). The TPU kernel builds an [8, M, W] one-hot compare
// block per sub-tile — O(R*M*W) work — because TPU scatters serialise.
// Hopper has fast shared-memory atomics, so this kernel does the direct
// O(R*M) scatter instead: one block per row, a [W] u32 accumulator in
// shared memory, one atomicMax per live in-range message.
//
// Bound on the H100: bytes. At wan_100k's CRDT merge (R=100,000, M=144,
// W=256) it reads idx+val as int64 and the mask as bytes (245 MB) and
// writes the int64 row plane (205 MB): 450 MB at 3.35 TB/s is 0.13 ms.
// The int64 storage is the port's u32 carrier; 32-bit planes would halve
// the bytes (ROADMAP). Arithmetic is a few integer ops per element, far
// below the byte bound.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;

__global__ void rowmax_kernel(const int64_t* __restrict__ idx,
                              const int64_t* __restrict__ val,
                              const bool* __restrict__ mask,
                              int64_t* __restrict__ out, int64_t m,
                              int width) {
  extern __shared__ unsigned int acc[];
  const int64_t r = blockIdx.x;
  for (int x = threadIdx.x; x < width; x += blockDim.x) acc[x] = 0u;
  __syncthreads();
  const int64_t base = r * m;
  for (int64_t j = threadIdx.x; j < m; j += blockDim.x) {
    if (mask != nullptr && !mask[base + j]) continue;
    const int64_t x = idx[base + j];
    if (x >= 0 && x < width) {
      atomicMax(&acc[x], static_cast<unsigned int>(val[base + j]));
    }
  }
  __syncthreads();
  int64_t* row = out + r * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    row[x] = static_cast<int64_t>(acc[x]);
  }
}

}  // namespace

int corro::rowmax(const int64_t* idx, const int64_t* val, const bool* mask,
                  int64_t* out, int64_t rows, int64_t m, int64_t width,
                  void* stream) {
  const size_t smem = static_cast<size_t>(width) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rowmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rowmax_kernel<<<static_cast<unsigned int>(rows), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      idx, val, mask, out, m, static_cast<int>(width));
  return static_cast<int>(cudaGetLastError());
}
