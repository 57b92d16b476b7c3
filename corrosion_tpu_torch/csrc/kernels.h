// The launchers of the hand-written kernels, one per .cu file, called by the
// PyTorch operators of ops.cpp. Each enqueues its kernel on `stream` (a
// cudaStream_t) and returns the CUDA error of the launch (0: launched). No
// CUDA header is needed here, so ops.cpp compiles with the host compiler.
// Values are u32 carried in int64, indices int64 (ops/onehot.py).
#pragma once

#include <cstdint>

namespace corro {

int rowmax(const int64_t* idx, const int64_t* val, const bool* mask, int64_t* out,
           int64_t rows, int64_t m, int64_t width, void* stream);

int rowsum(const int64_t* idx, const int64_t* val, const bool* mask, int64_t* out,
           int64_t rows, int64_t m, int64_t width, void* stream);

// clip: rowgather_wide's semantics; form: 0 scalar, 1 pairs
// (ops/onehot.py GATHER_FORMS).
int rowgather(const int64_t* table, const int64_t* idx, int64_t* out, int64_t rows,
              int64_t m, int64_t width, int64_t idx_row_stride, bool clip, int form,
              void* stream);

int table_gather(const int64_t* table, const int64_t* idx, int64_t* out, int64_t n,
                 int64_t width, void* stream);

int delivery_reduce(const int64_t* idx, const int64_t* d, const int64_t* v,
                    const bool* applied, const bool* valid, const int64_t* seen,
                    int64_t* adv_out, int64_t* seen_out, int64_t rows, int64_t m,
                    int64_t width, void* stream);

int window_delivery(const int64_t* oo, const int64_t* idx, const int64_t* d,
                    const int64_t* adv_m, const bool* valid, bool* poss_out,
                    int64_t* words_out, int64_t b_words, int64_t rows, int64_t m,
                    int64_t width, int64_t wk, void* stream);

}  // namespace corro
