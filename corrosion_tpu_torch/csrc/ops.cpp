// The PyTorch operators over the hand-written kernels (torch.ops.corro.*):
// one schema each, implemented for CUDA tensors only. The Python wrappers
// of ops/onehot.py send CPU tensors to their plain versions and everything
// else here, so the checks they made before a launch live here, with the
// same messages: TypeError for a wrong dtype, ValueError for a wrong shape,
// layout or device and for rows past the shared-memory or 2^31 limits. A
// launch the card refuses raises RuntimeError. Outputs are allocated here
// and each kernel runs on PyTorch's current stream of the inputs' device.
//
// Only narrow headers: no Python, no pybind and no CUDA header (the stream
// comes through c10's device-generic interface), so this file compiles
// with the host compiler in seconds and is linked with csrc/*.cu into one
// library (cuda_build.py).
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <initializer_list>
#include <optional>
#include <string>
#include <tuple>

#include "kernels.h"

namespace {

using at::Tensor;

// Shared memory one block may use on Hopper (227 KB of the SM's 256 KB,
// above 48 KB only by opt-in). The row kernels keep their [W] accumulators
// there, so wider rows are refused before any launch.
constexpr int64_t kSmemLimit = 232448;
constexpr int64_t kI32 = int64_t{1} << 31;

std::string dtype_name(c10::ScalarType t) {  // as Python prints a dtype
  switch (t) {
    case c10::kLong: return "torch.int64";
    case c10::kInt: return "torch.int32";
    case c10::kShort: return "torch.int16";
    case c10::kChar: return "torch.int8";
    case c10::kByte: return "torch.uint8";
    case c10::kBool: return "torch.bool";
    case c10::kFloat: return "torch.float32";
    case c10::kDouble: return "torch.float64";
    default: return std::string("torch.") + c10::toString(t);
  }
}

std::string shape_name(c10::IntArrayRef s) {  // as Python prints a tuple
  std::string out = "(";
  for (size_t i = 0; i < s.size(); ++i) out += (i ? ", " : "") + std::to_string(s[i]);
  return out + (s.size() == 1 ? ",)" : ")");
}

// Every tensor (nullptr: an absent optional) on the first one's device.
void same_device(std::initializer_list<const Tensor*> ts) {
  const c10::Device dev = (*ts.begin())->device();
  bool same = true;
  for (const Tensor* t : ts) same = same && (t == nullptr || t->device() == dev);
  if (same) return;
  std::string names;
  for (const Tensor* t : ts) {
    if (t != nullptr) names += (names.empty() ? "'" : ", '") + t->device().str() + "'";
  }
  TORCH_CHECK_VALUE(false, "tensors span devices [", names, "]");
}

void check(const Tensor& t, const char* name, c10::ScalarType dtype) {
  TORCH_CHECK_TYPE(t.scalar_type() == dtype, name, ": expected ", dtype_name(dtype), ", got ",
                   dtype_name(t.scalar_type()));
  TORCH_CHECK_VALUE(t.is_contiguous(), name, ": must be contiguous");
}

void check(const Tensor& t, const char* name, c10::ScalarType dtype, c10::IntArrayRef shape) {
  TORCH_CHECK_TYPE(t.scalar_type() == dtype, name, ": expected ", dtype_name(dtype), ", got ",
                   dtype_name(t.scalar_type()));
  TORCH_CHECK_VALUE(t.sizes() == shape, name, ": expected shape ", shape_name(shape), ", got ",
                    shape_name(t.sizes()));
  TORCH_CHECK_VALUE(t.is_contiguous(), name, ": must be contiguous");
}

void check_dims(const Tensor& t, const char* name, int64_t dims) {
  TORCH_CHECK_VALUE(t.dim() == dims, name, ": expected a ", dims, "-D tensor, got shape ",
                    shape_name(t.sizes()));
}

void check_smem(const char* name, int64_t bytes) {
  TORCH_CHECK_VALUE(bytes <= kSmemLimit, name, ": row accumulators need ", bytes,
                    " bytes of shared memory, above the ", kSmemLimit,
                    "-byte limit of one block");
}

void check_i32(const char* name, int64_t rows, int64_t m, int64_t width) {
  TORCH_CHECK_VALUE(rows < kI32 && m < kI32 && width < kI32, name,
                    ": rows, columns and width must each be below 2^31");
}

// PyTorch's current stream on `t`'s device, as a cudaStream_t.
void* stream(const Tensor& t) {
  return c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
      ->getStream(t.device())
      .native_handle();
}

void launched(const char* name, int err) {
  TORCH_CHECK(err == 0, "CUDA kernel ", name, " failed to launch: error ", err);
}

// rowmax and rowsum: int64[R, width] from idx/val [R, M] and a bool mask.
Tensor row_scatter(const char* name, decltype(&corro::rowmax) kernel, const Tensor& idx,
                   const Tensor& val, const std::optional<Tensor>& mask, int64_t width) {
  same_device({&idx, &val, mask ? &*mask : nullptr});
  check(idx, "idx", c10::kLong);
  check_dims(idx, "idx", 2);
  check(val, "val", c10::kLong, idx.sizes());
  if (mask) check(*mask, "mask", c10::kBool, idx.sizes());
  check_smem(name, 4 * width);
  const int64_t rows = idx.size(0), m = idx.size(1);
  check_i32(name, rows, m, width);
  const c10::DeviceGuard guard(idx.device());
  Tensor out = at::empty({rows, width}, idx.options());
  if (rows == 0 || m == 0 || width == 0) return out.zero_();
  launched(name, kernel(idx.data_ptr<int64_t>(), val.data_ptr<int64_t>(),
                        mask ? mask->data_ptr<bool>() : nullptr, out.data_ptr<int64_t>(), rows,
                        m, width, stream(idx)));
  return out;
}

Tensor rowmax(const Tensor& idx, const Tensor& val, const std::optional<Tensor>& mask,
              int64_t width) {
  return row_scatter("rowmax", &corro::rowmax, idx, val, mask, width);
}

Tensor rowsum(const Tensor& idx, const Tensor& val, const std::optional<Tensor>& mask,
              int64_t width) {
  return row_scatter("rowsum", &corro::rowsum, idx, val, mask, width);
}

// rowgather (clip false) and rowgather_wide (clip true): int64[R, M] from
// table [R, W] and idx [R, M]; rowgather's idx may broadcast one row (row
// stride 0 or a [1, M] index). form: 0 scalar, 1 pairs (csrc/rowgather.cu
// `Form`), as the wrapper's rule (ops/onehot.py gather_form) picks it.
Tensor rowgather(const Tensor& table, const Tensor& idx, bool clip, int64_t form) {
  const char* name = clip ? "rowgather_wide" : "rowgather";
  same_device({&table, &idx});
  check(table, "table", c10::kLong);
  check_dims(table, "table", 2);
  const int64_t rows = table.size(0), width = table.size(1);
  TORCH_CHECK_TYPE(idx.scalar_type() == c10::kLong, "idx: expected torch.int64, got ",
                   dtype_name(idx.scalar_type()));
  check_dims(idx, "idx", 2);
  const int64_t m = idx.size(1);
  if (clip) {
    check(idx, "idx", c10::kLong, {rows, m});
  } else {
    TORCH_CHECK_VALUE(
        (idx.size(0) == 1 || idx.size(0) == rows) && idx.stride(1) == 1 &&
            (idx.stride(0) == 0 || idx.stride(0) == m),
        "idx: needs unit column stride and row stride 0 or M");
  }
  TORCH_CHECK_VALUE(form == 0 || form == 1, name,
                    ": form must be one of ('scalar', 'pairs'), got ", form);
  check_i32(name, rows, m, width);
  const bool broadcast = idx.size(0) == 1 || idx.stride(0) == 0;
  const c10::DeviceGuard guard(table.device());
  Tensor out = at::empty({rows, m}, table.options());
  if (rows == 0 || m == 0 || width == 0) return out.zero_();
  launched(name, corro::rowgather(table.data_ptr<int64_t>(), idx.data_ptr<int64_t>(),
                                  out.data_ptr<int64_t>(), rows, m, width, broadcast ? 0 : m,
                                  clip, static_cast<int>(form), stream(table)));
  return out;
}

// out[...] = table[clip(idx[...], 0, W - 1)], int64 of idx's shape.
Tensor table_gather(const Tensor& table, const Tensor& idx) {
  same_device({&table, &idx});
  check(table, "table", c10::kLong);
  check_dims(table, "table", 1);
  check(idx, "idx", c10::kLong);
  const c10::DeviceGuard guard(idx.device());
  Tensor out = at::empty(idx.sizes(), idx.options());
  if (idx.numel() == 0 || table.numel() == 0) return out.zero_();
  launched("table_gather",
           corro::table_gather(table.data_ptr<int64_t>(), idx.data_ptr<int64_t>(),
                               out.data_ptr<int64_t>(), idx.numel(), table.numel(), stream(idx)));
  return out;
}

// (rowmax(idx, d, applied), max(seen, rowmax(idx, v, valid))), both new.
std::tuple<Tensor, Tensor> delivery_reduce(const Tensor& idx, const Tensor& d, const Tensor& v,
                                           const Tensor& applied, const Tensor& valid,
                                           const Tensor& seen, int64_t width) {
  same_device({&idx, &d, &v, &applied, &valid, &seen});
  check(idx, "idx", c10::kLong);
  check_dims(idx, "idx", 2);
  check(d, "d", c10::kLong, idx.sizes());
  check(v, "v", c10::kLong, idx.sizes());
  check(applied, "applied", c10::kBool, idx.sizes());
  check(valid, "valid", c10::kBool, idx.sizes());
  const int64_t rows = idx.size(0), m = idx.size(1);
  check(seen, "seen", c10::kLong, {rows, width});
  check_smem("delivery_reduce", 8 * width);
  check_i32("delivery_reduce", rows, m, width);
  const c10::DeviceGuard guard(idx.device());
  Tensor adv = at::empty({rows, width}, idx.options());
  Tensor seen2 = at::empty({rows, width}, idx.options());
  if (rows == 0 || m == 0 || width == 0) return {adv.zero_(), seen2.copy_(seen)};
  launched("delivery_reduce",
           corro::delivery_reduce(idx.data_ptr<int64_t>(), d.data_ptr<int64_t>(),
                                  v.data_ptr<int64_t>(), applied.data_ptr<bool>(),
                                  valid.data_ptr<bool>(), seen.data_ptr<int64_t>(),
                                  adv.data_ptr<int64_t>(), seen2.data_ptr<int64_t>(), rows, m,
                                  width, stream(idx)));
  return {adv, seen2};
}

// (new_poss bool[R, M], new_bits int64[B, R, W]) of the out-of-order window.
std::tuple<Tensor, Tensor> window_delivery(const Tensor& oo, const Tensor& idx, const Tensor& d,
                                           const Tensor& adv_m, const Tensor& valid, int64_t wk,
                                           int64_t width) {
  same_device({&oo, &idx, &d, &adv_m, &valid});
  check(idx, "idx", c10::kLong);
  check_dims(idx, "idx", 2);
  const int64_t rows = idx.size(0), m = idx.size(1);
  const int64_t b_words = oo.dim() > 0 ? oo.size(0) : 0;
  check(oo, "oo", c10::kLong, {b_words, rows, width});
  check(d, "d", c10::kLong, idx.sizes());
  check(adv_m, "adv_m", c10::kLong, idx.sizes());
  check(valid, "valid", c10::kBool, idx.sizes());
  check_smem("window_delivery", 4 * b_words * width);
  check_i32("window_delivery", rows, m, width);
  const c10::DeviceGuard guard(idx.device());
  Tensor poss = at::empty({rows, m}, valid.options());
  Tensor words = at::empty({b_words, rows, width}, idx.options());
  if (rows == 0 || m == 0 || width == 0) return {poss.zero_(), words.zero_()};
  launched("window_delivery",
           corro::window_delivery(oo.data_ptr<int64_t>(), idx.data_ptr<int64_t>(),
                                  d.data_ptr<int64_t>(), adv_m.data_ptr<int64_t>(),
                                  valid.data_ptr<bool>(), poss.data_ptr<bool>(),
                                  words.data_ptr<int64_t>(), b_words, rows, m, width, wk,
                                  stream(idx)));
  return {poss, words};
}

}  // namespace

TORCH_LIBRARY(corro, m) {
  m.def("rowmax(Tensor idx, Tensor val, Tensor? mask, int width) -> Tensor");
  m.def("rowsum(Tensor idx, Tensor val, Tensor? mask, int width) -> Tensor");
  m.def("rowgather(Tensor table, Tensor idx, bool clip, int form) -> Tensor");
  m.def("table_gather(Tensor table, Tensor idx) -> Tensor");
  m.def(
      "delivery_reduce(Tensor idx, Tensor d, Tensor v, Tensor applied, Tensor valid, "
      "Tensor seen, int width) -> (Tensor, Tensor)");
  m.def(
      "window_delivery(Tensor oo, Tensor idx, Tensor d, Tensor adv_m, Tensor valid, int wk, "
      "int width) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(corro, CUDA, m) {
  m.impl("rowmax", &rowmax);
  m.impl("rowsum", &rowsum);
  m.impl("rowgather", &rowgather);
  m.impl("table_gather", &table_gather);
  m.impl("delivery_reduce", &delivery_reduce);
  m.impl("window_delivery", &window_delivery);
}
