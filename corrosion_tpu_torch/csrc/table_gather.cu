// Gather from one shared 1-D table: out[i] = table[clip(idx[i], 0, W - 1)].
//
// Replaces corrosion_tpu/ops/onehot.py `_table_gather_kernel` (via
// `table_gather_u32`). The TPU kernel compares every index against every
// 128-lane block of the table and max-accumulates ([8, C, 128] blocks,
// O(n * W) work) because TPU gathers serialise. Hopper gathers natively,
// so this is a plain indexed load, O(n): each thread takes indices
// grid-stride, four at a time, over a grid sized to what fits the card at
// once. Both ends clip, as the Pallas and native backends do.
//
// The table is shared by every index, so each block stages it in shared
// memory once (while W * 8 bytes fit a block: W = 2,048 is 16 KB, wider
// than 48 KB by opt-in) and then reads it from there; a wider table is
// read from global memory through the read-only cache (`__ldg`).
//
// Bound on the H100: bytes. The indices are read and the outputs written
// as int64, once each; the table is small beside them. At anywrite_sparse's
// sync grant enumeration (16,667 x 512 indices) that is 137 MB, 0.041 ms
// at 3.35 TB/s; at `rotate`'s queue mask (100,000 x 64) 102 MB, 0.031 ms.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 232448;  // 227 KB, Hopper's per-block maximum

template <bool kStaged>
__global__ void table_gather_kernel(const int64_t* __restrict__ table,
                                    const int64_t* __restrict__ idx,
                                    int64_t* __restrict__ out, int64_t n,
                                    int64_t width) {
  extern __shared__ int64_t stab[];
  if (kStaged) {
    for (int64_t j = threadIdx.x; j < width; j += blockDim.x) stab[j] = table[j];
    __syncthreads();
  }
  // kUnroll independent indices per thread per step: their loads are all
  // in flight before the first table read, which a one-at-a-time loop
  // would serialise behind each load's latency.
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i0 = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i0 < n; i0 += kUnroll * stride) {
    int64_t x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      x[u] = i < n ? idx[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i >= n) break;
      const int64_t c = x[u] < 0 ? 0 : (x[u] >= width ? width - 1 : x[u]);
      out[i] = kStaged
                   ? stab[c]
                   : static_cast<int64_t>(
                         __ldg(reinterpret_cast<const long long*>(table) + c));
    }
  }
}

template <bool kStaged>
int launch(const int64_t* table, const int64_t* idx, int64_t* out, int64_t n,
           int64_t width, void* stream) {
  const size_t smem = kStaged ? static_cast<size_t>(width) * sizeof(int64_t) : 0;
  // As many blocks as are resident at once (each stages the table once),
  // never more than the indices need. The resident count, and the
  // shared-memory opt-in it depends on, are driver queries: made once per
  // device and table size, not at every launch.
  struct Grid {
    int device = -1;
    size_t smem = 0;
    int64_t resident = 0;
  };
  thread_local Grid grid;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid.device != device || grid.smem != smem) {
    if (smem > kSmemDefault) {
      e = cudaFuncSetAttribute(table_gather_kernel<kStaged>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, table_gather_kernel<kStaged>, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    grid = {device, smem, static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1)};
  }
  const int64_t needed = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int64_t blocks = grid.resident < needed ? grid.resident : needed;
  table_gather_kernel<kStaged>
      <<<static_cast<unsigned int>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(table, idx, out, n, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int corro_table_gather(const int64_t* table, const int64_t* idx,
                                  int64_t* out, int64_t n, int64_t width,
                                  void* stream) {
  if (n <= 0 || width <= 0) return 0;
  if (static_cast<size_t>(width) * sizeof(int64_t) <= kSmemLimit) {
    return launch<true>(table, idx, out, n, width, stream);
  }
  return launch<false>(table, idx, out, n, width, stream);
}
