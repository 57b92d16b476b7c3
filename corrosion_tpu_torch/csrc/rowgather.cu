// Row-local gathers, two out-of-range semantics from one template:
//   rowgather:      out[r, j] = table[r, idx[r, j]], 0 when idx < 0 or >= W
//                   (corrosion_tpu/ops/onehot.py rowgather, "native"
//                   take_along_axis mode="fill");
//   rowgather_wide: out[r, j] = table[r, clip(idx[r, j], 0, W - 1)]
//                   (onehot.py rowgather_wide, take_along_axis on the
//                   clipped index): an out-of-range index reads the nearest
//                   edge column, never 0.
//
// Replaces corrosion_tpu/ops/onehot.py `_rowgather_kernel` (via
// `rowgather` / `_rowgather_pallas`) and `_rowgather_wide_kernel` (via
// `rowgather_wide`). The TPU kernels compare every message against every
// column ([8, M, W] or [8, M, 128] one-hot blocks, O(R*M*W)) because TPU
// dynamic gathers serialise; Hopper gathers natively, O(R*M).
//
// Bound on the H100: bytes. A call reads idx and writes out as int64 and
// needs only the table words it addresses, but the memory system moves
// whole sectors: M random columns of a W-word row cost about
// 1 - (1 - 4/W)^M of the row's 32-byte sectors (more in 64-byte chunks),
// however the row is read. At the main paths' shapes the form the rule
// picks runs above that word-count bound (PERF.md §6 has each ratio): the
// gap is sectors, which no form removes; what a form can win is the idx/out
// traffic and the launch shape. On the card, neither the load path
// (`ld.global.nc` or not), a 64-bit division an element, more gathers in
// flight a thread (2, 4 and 8 timed alike), nor staging rows in shared
// memory moved the time (tiles of table rows streamed in by the TMA bulk
// copy lost at every main-path shape, by 4% to 5.4x). The element mapping
// did move it, one way on dense rows and the other on sparse ones, so the
// wrapper (ops/onehot.py `gather_form`) picks:
//
// - scalar: one output a thread over the flat [R, M] plane, idx and out
//   as 8-byte words (the broadcast column list re-read from L1). As fast
//   or faster where rows are wide or sparsely addressed (M < W/2) and
//   with a broadcast index: merge_10k's 80 KB rows, visibility.
// - pairs: tiles of whole rows, two outputs a thread, idx loaded and out
//   stored as 16-byte pairs where aligned, 32-bit offsets inside a tile.
//   Fastest where the call addresses rows densely (M >= W/2: the CRDT
//   winner checks, wan_100k's grants), where idx and out are most of the
//   bytes.
//
// `idx_row_stride` 0 broadcasts one column list over every row
// (visibility).
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.h"

namespace {

enum Form { kScalar = 0, kPairs = 1 };  // ops/onehot.py GATHER_FORMS

constexpr int kThreads = 256;
constexpr int kTileElems = 2 * kThreads;  // pairs form: outputs a tile

struct Args {
  const int64_t* table;
  const int64_t* idx;
  int64_t* out;
  int64_t total;  // rows * m
  int rows, m, width;
  int tile_rows;
  int broadcast;  // idx is one column list of m entries (row stride 0)
  int idx_vec;    // idx's pairs are 16-byte aligned
};

template <bool kClip>
__device__ __forceinline__ int64_t pick(const int64_t* row, int64_t x, int width) {
  if (kClip) {
    x = x < 0 ? 0 : (x >= width ? width - 1 : x);
  } else if (x < 0 || x >= width) {
    return 0;
  }
  return __ldg(row + x);
}

// Pairs form: the outputs of rows [r0, r0 + nrows).
template <bool kClip>
__device__ __forceinline__ void gather_tile(const Args& a, int r0, int nrows) {
  const int64_t e0 = static_cast<int64_t>(r0) * a.m;
  const int64_t* src = a.table + static_cast<int64_t>(r0) * a.width;
  int64_t* out = a.out + e0;
  // The tile's outputs are one flat run of n entries, and so are its
  // indices unless one column list serves every row (broadcast).
  const int64_t* idx = a.broadcast ? a.idx : a.idx + e0;
  const int n = nrows * a.m;
  // out is 16-byte aligned, so pairs start at an even flat element: a tile
  // that starts odd has a scalar head, one that ends odd a scalar tail.
  const int head = static_cast<int>(e0 & 1);
  const int npairs = (n - head) >> 1;
  const int tail = (n - head) & 1;
  auto one = [&](int l) {
    const int i = l / a.m;
    const int64_t x = __ldg(idx + (a.broadcast ? l - i * a.m : l));
    out[l] = pick<kClip>(src + static_cast<size_t>(i) * a.width, x, a.width);
  };
  if (head && threadIdx.x == 0) one(0);
  if (tail && threadIdx.x == kThreads - 1) one(n - 1);
  for (int p = threadIdx.x; p < npairs; p += kThreads) {
    const int l = head + 2 * p;
    const int i = l / a.m;
    const int c = l - i * a.m;
    int64_t x0, x1;
    if (a.broadcast) {  // the column list stays in L1 across the tile's rows
      x0 = __ldg(idx + c);
      x1 = __ldg(idx + (c + 1 == a.m ? 0 : c + 1));
    } else if (a.idx_vec) {
      const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(idx + l));
      x0 = w.x;
      x1 = w.y;
    } else {
      x0 = __ldg(idx + l);
      x1 = __ldg(idx + l + 1);
    }
    const int64_t* row = src + static_cast<size_t>(i) * a.width;
    // The pair's second element opens the next row after the last column.
    const int64_t v0 = pick<kClip>(row, x0, a.width);
    const int64_t v1 = pick<kClip>(c + 1 == a.m ? row + a.width : row, x1, a.width);
    *reinterpret_cast<longlong2*>(out + l) = make_longlong2(v0, v1);
  }
}

template <bool kClip, int kForm>
__global__ void __launch_bounds__(kThreads) rowgather_kernel(Args a) {
  if constexpr (kForm == kScalar) {
    const int64_t e = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
    if (e >= a.total) return;
    const int64_t r = e / a.m;
    const int64_t x = __ldg(a.idx + (a.broadcast ? e - r * a.m : e));
    a.out[e] = pick<kClip>(a.table + r * a.width, x, a.width);
  } else {
    const int r0 = blockIdx.x * a.tile_rows;
    gather_tile<kClip>(a, r0, min(a.tile_rows, a.rows - r0));
  }
}

template <bool kClip>
int launch(const int64_t* table, const int64_t* idx, int64_t* out, int64_t rows, int64_t m,
           int64_t width, int64_t idx_row_stride, int64_t form, cudaStream_t stream) {
  constexpr int64_t kMax = INT32_MAX;
  if (rows <= 0 || m <= 0 || width <= 0 || rows > kMax || m > kMax || width > kMax ||
      (idx_row_stride != 0 && idx_row_stride != m) || (form != kScalar && form != kPairs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.table = table;
  a.idx = idx;
  a.out = out;
  a.rows = static_cast<int>(rows);
  a.m = static_cast<int>(m);
  a.width = static_cast<int>(width);
  a.broadcast = idx_row_stride == 0;
  a.idx_vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  a.total = rows * m;
  if (form == kScalar) {
    rowgather_kernel<kClip, kScalar>
        <<<static_cast<unsigned>((a.total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // A tile's flat offsets stay 32-bit.
  const int64_t tile_rows = std::min<int64_t>(
      {std::max<int64_t>(1, kTileElems / m), rows, std::max<int64_t>(1, kMax / m)});
  a.tile_rows = static_cast<int>(tile_rows);
  const int64_t n_tiles = (rows + tile_rows - 1) / tile_rows;
  rowgather_kernel<kClip, kPairs><<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// clip: rowgather_wide's semantics; form: a Form.
int corro::rowgather(const int64_t* table, const int64_t* idx, int64_t* out, int64_t rows,
                     int64_t m, int64_t width, int64_t idx_row_stride, bool clip, int form,
                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return clip ? launch<true>(table, idx, out, rows, m, width, idx_row_stride, form, s)
              : launch<false>(table, idx, out, rows, m, width, idx_row_stride, form, s);
}
