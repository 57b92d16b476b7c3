// Out-of-order window admission of the broadcast fast path. Per message
// (r, m) with writer column x = idx[r, m]:
//   d_rel    = d - adv_m                       (u32, wraps when d <= adv_m)
//   in_win   = valid & d > adv_m & d_rel <= wk
//   prev     = bit (d - 1) of the OLD window words oo[:, r, x] is set
//   new_poss = in_win & !prev
// and the new possession words get 1 << (d_rel - 1 - 32 b) ADDED into
// word b of column x. Each (r, x, bit) is contributed at most once, so the
// mod-2^32 sum is the bitwise OR — and adding matches the reference's
// rowsum composition bit for bit (onehot.py window_delivery).
//
// Replaces corrosion_tpu/ops/onehot.py `_window_delivery_kernel` (via
// `window_delivery`). The TPU kernel shares one [8, M, W] one-hot block
// between the per-word gathers and the per-word sums (O(R*M*W)); here one
// block per row reads oo[b, r, x] directly per message and does one
// shared-memory atomicAdd per admitted bit into [B][W] u32 accumulators:
// O(R*M) work.
//
// Bound on the H100: bytes. At wan_100k (B=1, R=100,000, M=144, W=512) it
// reads idx, d, adv_m as int64 and valid as bytes (360 MB) plus the old
// window words it gathers (at most 115 MB), and writes the int64 word
// plane (410 MB) and the bool mask (14 MB): ~0.9 GB at 3.35 TB/s is
// ~0.27 ms. 32-bit planes would halve the plane traffic (ROADMAP).
#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 128;

__global__ void window_delivery_kernel(
    const int64_t* __restrict__ oo, const int64_t* __restrict__ idx,
    const int64_t* __restrict__ d, const int64_t* __restrict__ adv_m,
    const bool* __restrict__ valid, bool* __restrict__ poss_out,
    int64_t* __restrict__ words_out, int b_words, int64_t rows, int64_t m,
    int width, unsigned int wk) {
  extern __shared__ unsigned int acc[];  // [b_words][width]
  const int64_t r = blockIdx.x;
  const int total = b_words * width;
  for (int i = threadIdx.x; i < total; i += blockDim.x) acc[i] = 0u;
  __syncthreads();
  const int64_t base = r * m;
  const int64_t plane = rows * static_cast<int64_t>(width);
  for (int64_t j = threadIdx.x; j < m; j += blockDim.x) {
    const int64_t x = idx[base + j];
    const bool in_range = x >= 0 && x < width;
    const unsigned int dm = static_cast<unsigned int>(d[base + j]);
    const unsigned int am = static_cast<unsigned int>(adv_m[base + j]);
    const unsigned int d_rel = dm - am;
    const bool in_win = valid[base + j] && dm > am && d_rel <= wk;
    bool prev = false;
    if (in_win) {
      const unsigned int bit_old = dm - 1u;
      for (int b = 0; b < b_words; ++b) {
        const unsigned int lo = 32u * b;
        if (bit_old < lo || bit_old >= lo + 32u) continue;
        const unsigned int word =
            in_range ? static_cast<unsigned int>(
                           oo[b * plane + r * width + x])
                     : 0u;
        prev = prev || ((word >> (bit_old - lo)) & 1u);
      }
    }
    const bool new_poss = in_win && !prev;
    poss_out[base + j] = new_poss;
    if (new_poss && in_range) {
      const unsigned int bit_new = d_rel - 1u;
      for (int b = 0; b < b_words; ++b) {
        const unsigned int lo = 32u * b;
        if (bit_new < lo || bit_new >= lo + 32u) continue;
        atomicAdd(&acc[b * width + x], 1u << (bit_new - lo));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int b = i / width;
    const int x = i - b * width;
    words_out[b * plane + r * width + x] = static_cast<int64_t>(acc[i]);
  }
}

}  // namespace

int corro::window_delivery(const int64_t* oo, const int64_t* idx, const int64_t* d,
                           const int64_t* adv_m, const bool* valid,
                           bool* poss_out, int64_t* words_out, int64_t b_words,
                           int64_t rows, int64_t m, int64_t width, int64_t wk,
                           void* stream) {
  const size_t smem =
      static_cast<size_t>(b_words) * width * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_delivery_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  window_delivery_kernel<<<static_cast<unsigned int>(rows), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      oo, idx, d, adv_m, valid, poss_out, words_out,
      static_cast<int>(b_words), rows, m, static_cast<int>(width),
      static_cast<unsigned int>(wk));
  return static_cast<int>(cudaGetLastError());
}
