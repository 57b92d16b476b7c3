// Row-local gather: out[r, m] = table[r, idx[r, m]], 0 when idx is out of
// range (negative or >= W) — the reference's "native" semantics
// (corrosion_tpu/ops/onehot.py rowgather, take_along_axis mode="fill").
//
// Replaces corrosion_tpu/ops/onehot.py `_rowgather_kernel` (via
// `rowgather` / `_rowgather_pallas`). The TPU kernel compares every
// message against every column ([8, M, W] one-hot block, O(R*M*W))
// because TPU dynamic gathers serialise; Hopper gathers natively, so this
// is one thread per output element, O(R*M).
//
// Bound on the H100: bytes. At the delivery base gather (R=100,000,
// M=144, W=512) it reads idx (115 MB) and writes out (115 MB) as int64,
// plus the table entries it touches (at most the 410 MB table, but only
// the gathered words are needed: 115 MB): ~0.35 GB at 3.35 TB/s is
// ~0.1 ms. Consecutive threads read consecutive idx/out words, so those
// accesses coalesce; table reads are scattered within one row (4 KB),
// which the L1/L2 absorb. `idx_row_stride` 0 lets visibility broadcast one
// column list over all rows without materialising an [N, S] index plane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void rowgather_kernel(const int64_t* __restrict__ table,
                                 const int64_t* __restrict__ idx,
                                 int64_t* __restrict__ out, int64_t rows,
                                 int64_t m, int64_t width,
                                 int64_t idx_row_stride) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= rows * m) return;
  const int64_t r = i / m;
  const int64_t j = i - r * m;
  const int64_t x = idx[r * idx_row_stride + j];
  out[i] = (x >= 0 && x < width) ? table[r * width + x] : 0;
}

}  // namespace

extern "C" int corro_rowgather(const int64_t* table, const int64_t* idx,
                               int64_t* out, int64_t rows, int64_t m,
                               int64_t width, int64_t idx_row_stride,
                               void* stream) {
  const int64_t blocks = (rows * m + kThreads - 1) / kThreads;
  rowgather_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      table, idx, out, rows, m, width, idx_row_stride);
  return static_cast<int>(cudaGetLastError());
}
