// Gather from one shared 1-D table: out[i] = table[clip(idx[i], 0, W - 1)].
//
// Replaces corrosion_tpu/ops/onehot.py `_table_gather_kernel` (via
// `table_gather_u32`). The TPU kernel compares every index against every
// 128-lane block of the table and max-accumulates ([8, C, 128] blocks,
// O(n * W) work) because TPU gathers serialise. Hopper gathers natively,
// so this is a plain indexed load, O(n). Both ends clip, as the Pallas and
// native backends do.
//
// Bound on the H100: bytes. The indices are read and the outputs written
// as int64, once each; the table is small beside them. At anywrite_sparse's
// sync grant enumeration (16,667 x 512 indices) that is 137 MB, 0.041 ms
// at 3.35 TB/s; at `rotate`'s queue mask (100,000 x 64) 102 MB, 0.031 ms.
// So the design spends nothing but those two streams, and on the card it
// runs at the rate of a plain copy of the same bytes (`clone_ms` beside it
// in chip_smoke.py phase 3):
//
// - a plain grid, each thread two pairs of consecutive outputs: `idx` is
//   loaded and `out` stored 16 bytes at a time, a warp's accesses
//   contiguous. `out` is a fresh allocation, so its pairs are aligned (the
//   launcher refuses any other); a scalar tail covers an odd length, and
//   an `idx` view whose pairs are not 16-byte aligned (an odd storage
//   offset) loads scalars;
// - `out` is written with evict-first stores and `idx` read with
//   evict-first loads (`__stcs`, `__ldcs`): the stores timed faster on the
//   card than plain ones; the load path (`__ldg`, `__ldcs`,
//   `L1::no_allocate`) and one, two or four pairs a thread timed alike;
// - the table is read through the read-only path (`__ldg`): at W = 2,048
//   its 16 KB stay in each SM's L1, and a wider table (W = 100,000) is
//   served from L2. Staging it in shared memory, as int64 or as u32 words,
//   timed slower: every block pays the copy and a barrier before its first
//   index.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 2;  // pairs of outputs a thread
constexpr int64_t kBlockPairs = static_cast<int64_t>(kPairs) * kThreads;

__device__ __forceinline__ int64_t pick(const int64_t* __restrict__ table, int64_t x,
                                        int64_t width) {
  x = x < 0 ? 0 : (x >= width ? width - 1 : x);
  return __ldg(reinterpret_cast<const long long*>(table) + x);
}

__device__ __forceinline__ int64_t load_idx(const int64_t* p) {
  return __ldcs(reinterpret_cast<const long long*>(p));
}

// Outputs [0, n) in pairs into a 16-byte aligned `out`, the last of an odd
// n alone. kIdxVec: idx's pairs are 16-byte aligned too.
template <bool kIdxVec>
__global__ void __launch_bounds__(kThreads)
    table_gather_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ idx,
                        int64_t* __restrict__ out, int64_t n, int64_t width) {
  const int64_t npairs = n >> 1;
  if ((n & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    out[n - 1] = pick(table, load_idx(idx + n - 1), width);
  }
  longlong2* op = reinterpret_cast<longlong2*>(out);
  const int64_t p0 = blockIdx.x * kBlockPairs + threadIdx.x;
  // Every index load of the thread is in flight before the first table read.
  longlong2 x[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int64_t p = p0 + k * kThreads;
    if (p >= npairs) break;
    if (kIdxVec) {
      x[k] = __ldcs(reinterpret_cast<const longlong2*>(idx) + p);
    } else {
      x[k] = make_longlong2(load_idx(idx + 2 * p), load_idx(idx + 2 * p + 1));
    }
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int64_t p = p0 + k * kThreads;
    if (p >= npairs) break;
    __stcs(op + p, make_longlong2(pick(table, x[k].x, width), pick(table, x[k].y, width)));
  }
}

}  // namespace

int corro::table_gather(const int64_t* table, const int64_t* idx, int64_t* out, int64_t n,
                        int64_t width, void* stream) {
  if (n <= 0 || width <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t npairs = n >> 1;
  const int64_t blocks = npairs > 0 ? (npairs + kBlockPairs - 1) / kBlockPairs : 1;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool idx_vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (idx_vec) {
    table_gather_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        table, idx, out, n, width);
  } else {
    table_gather_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        table, idx, out, n, width);
  }
  return static_cast<int>(cudaGetLastError());
}
