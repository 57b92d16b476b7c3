// Row-local scatter-add mod 2^32:
//   out[r, x] = sum{val[r, m] : idx[r, m] == x, mask[r, m]}  (mod 2^32)
// masked and out-of-range entries add nothing; 0 where nothing hits.
//
// Replaces corrosion_tpu/ops/onehot.py `_rowsum_kernel` (via `rowsum`).
// The TPU kernel builds an [8, M, W] one-hot compare block per sub-tile and
// sums over M (O(R*M*W)), because TPU scatters serialise. Hopper has fast
// shared-memory atomics, so this kernel does the direct O(R*M) scatter:
// one block per row, a [W] u32 accumulator in shared memory, one
// atomicAdd per live in-range entry. u32 addition wraps exactly like the
// reference's mod-2^32 sum, whatever order the atomics land in.
//
// Bound on the H100: bytes. At merge_10k's legacy window assembly
// (R=10,000, M=144 -> W=10,000) it reads idx and val as int64 (23 MB) and
// writes the int64 row plane (800 MB): ~0.83 GB at 3.35 TB/s is ~0.25 ms.
// The output write dominates, so the row is written with consecutive
// threads on consecutive words. The accumulator takes 4*W bytes of shared
// memory (40 KB at W=10,000); above 48 KB the launch opts in to more.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void rowsum_kernel(const int64_t* __restrict__ idx,
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
      atomicAdd(&acc[x], static_cast<unsigned int>(val[base + j]));
    }
  }
  __syncthreads();
  int64_t* row = out + r * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    row[x] = static_cast<int64_t>(acc[x]);
  }
}

}  // namespace

int corro::rowsum(const int64_t* idx, const int64_t* val, const bool* mask,
                  int64_t* out, int64_t rows, int64_t m, int64_t width,
                  void* stream) {
  const size_t smem = static_cast<size_t>(width) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rowsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rowsum_kernel<<<static_cast<unsigned int>(rows), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      idx, val, mask, out, m, static_cast<int>(width));
  return static_cast<int>(cudaGetLastError());
}
