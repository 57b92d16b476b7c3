// Row-local gathers, two out-of-range semantics from one body:
//   rowgather:      out[r, m] = table[r, idx[r, m]], 0 when idx < 0 or >= W
//                   (corrosion_tpu/ops/onehot.py rowgather, "native"
//                   take_along_axis mode="fill");
//   rowgather_wide: out[r, m] = table[r, clip(idx[r, m], 0, W - 1)]
//                   (onehot.py rowgather_wide, take_along_axis on the
//                   clipped index): an out-of-range index reads the nearest
//                   edge column, never 0.
//
// Replaces corrosion_tpu/ops/onehot.py `_rowgather_kernel` (via
// `rowgather` / `_rowgather_pallas`) and `_rowgather_wide_kernel` (via
// `rowgather_wide`). The TPU kernels compare every message against every
// column ([8, M, W] or [8, M, 128] one-hot blocks, O(R*M*W)) because TPU
// dynamic gathers serialise; Hopper gathers natively, so both are one
// thread per output element, O(R*M), instantiated from one template with
// `kClip` choosing the semantics.
//
// Bound on the H100: bytes. Each call reads idx and writes out as int64
// and needs only the table words it addresses. At wan_100k's delivery
// base gather (R=100,000, M=144, W=512) that is ~0.35 GB, ~0.1 ms at
// 3.35 TB/s; at merge_10k's legacy base gather (R=10,000, M=144,
// W=10,000) ~35 MB, ~0.01 ms, where the launch and the scattered table
// reads (one 32-byte sector per 8-byte word, rows 80 KB wide) set the
// time instead. Consecutive threads read consecutive idx/out words, so
// those coalesce. `idx_row_stride` 0 lets visibility broadcast one column
// list over all rows without materialising an [N, S] index plane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kClip>
__global__ void rowgather_kernel(const int64_t* __restrict__ table,
                                 const int64_t* __restrict__ idx,
                                 int64_t* __restrict__ out, int64_t rows,
                                 int64_t m, int64_t width,
                                 int64_t idx_row_stride) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= rows * m) return;
  const int64_t r = i / m;
  const int64_t x = idx[r * idx_row_stride + (i - r * m)];
  if (kClip) {
    out[i] = table[r * width + (x < 0 ? 0 : (x >= width ? width - 1 : x))];
  } else {
    out[i] = (x >= 0 && x < width) ? table[r * width + x] : 0;
  }
}

template <bool kClip>
int launch(const int64_t* table, const int64_t* idx, int64_t* out,
           int64_t rows, int64_t m, int64_t width, int64_t idx_row_stride,
           void* stream) {
  const int64_t blocks = (rows * m + kThreads - 1) / kThreads;
  rowgather_kernel<kClip><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table, idx, out, rows, m, width, idx_row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int corro_rowgather(const int64_t* table, const int64_t* idx,
                               int64_t* out, int64_t rows, int64_t m,
                               int64_t width, int64_t idx_row_stride,
                               void* stream) {
  return launch<false>(table, idx, out, rows, m, width, idx_row_stride, stream);
}

extern "C" int corro_rowgather_wide(const int64_t* table, const int64_t* idx,
                                    int64_t* out, int64_t rows, int64_t m,
                                    int64_t width, void* stream) {
  return launch<true>(table, idx, out, rows, m, width, m, stream);
}
