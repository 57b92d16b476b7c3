// Fused delivery reductions of the broadcast fast path:
//   adv[r, x]   = max{d[r, m] : idx[r, m] == x, applied[r, m]}      (0 if none)
//   seen'[r, x] = max(seen[r, x], max{v[r, m] : idx[r, m] == x, valid[r, m]})
//
// Replaces corrosion_tpu/ops/onehot.py `_delivery_reduce_kernel` (via
// `delivery_reduce`). The TPU kernel reuses one [8, M, W] one-hot compare
// block for both reductions (O(R*M*W)); Hopper does the direct O(R*M)
// scatter: one block per row, two [W] u32 accumulators in shared memory
// (the `seen` row is loaded into the second first), one atomicMax per live
// in-range message for each.
//
// Bound on the H100: bytes. At wan_100k (R=100,000, M=144, W=512) it
// reads idx, d, v as int64 and the two masks as bytes (374 MB), reads the
// int64 seen plane (410 MB) and writes two int64 planes (819 MB): 1.6 GB
// at 3.35 TB/s is 0.48 ms. 32-bit planes would halve the plane traffic
// (ROADMAP). At merge_10k's legacy delivery (R=10,000, W=10,000) the
// reductions need 80 KB of shared memory a block, so only two blocks fit
// an SM; the block then grows with the row (one thread per 8 columns, up
// to 1,024) so those two blocks still keep enough loads in flight to
// stream the 2.4 GB of seen/out planes (bound 0.73 ms).
#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 1024;

__global__ void delivery_reduce_kernel(
    const int64_t* __restrict__ idx, const int64_t* __restrict__ d,
    const int64_t* __restrict__ v, const bool* __restrict__ applied,
    const bool* __restrict__ valid, const int64_t* __restrict__ seen,
    int64_t* __restrict__ adv_out, int64_t* __restrict__ seen_out, int64_t m,
    int width) {
  extern __shared__ unsigned int smem[];
  unsigned int* adv = smem;
  unsigned int* sn = smem + width;
  const int64_t r = blockIdx.x;
  const int64_t* seen_row = seen + r * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    adv[x] = 0u;
    sn[x] = static_cast<unsigned int>(seen_row[x]);
  }
  __syncthreads();
  const int64_t base = r * m;
  for (int64_t j = threadIdx.x; j < m; j += blockDim.x) {
    const int64_t x = idx[base + j];
    if (x < 0 || x >= width) continue;
    if (applied[base + j]) {
      atomicMax(&adv[x], static_cast<unsigned int>(d[base + j]));
    }
    if (valid[base + j]) {
      atomicMax(&sn[x], static_cast<unsigned int>(v[base + j]));
    }
  }
  __syncthreads();
  int64_t* adv_row = adv_out + r * width;
  int64_t* seen_out_row = seen_out + r * width;
  for (int x = threadIdx.x; x < width; x += blockDim.x) {
    adv_row[x] = static_cast<int64_t>(adv[x]);
    seen_out_row[x] = static_cast<int64_t>(sn[x]);
  }
}

}  // namespace

int corro::delivery_reduce(const int64_t* idx, const int64_t* d, const int64_t* v,
                           const bool* applied, const bool* valid,
                           const int64_t* seen, int64_t* adv_out,
                           int64_t* seen_out, int64_t rows, int64_t m,
                           int64_t width, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(width) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        delivery_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = kMinThreads;
  while (threads < kMaxThreads && threads * 8 < width) threads *= 2;
  delivery_reduce_kernel<<<static_cast<unsigned int>(rows), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      idx, d, v, applied, valid, seen, adv_out, seen_out, m,
      static_cast<int>(width));
  return static_cast<int>(cudaGetLastError());
}
