// Host side of the fused embedding-bag kernels (csrc/embedding_bag.cu):
// the argument checks, the output allocation and the launch, for all of a
// step's tables in one call from Python.
//
// The kernels' own work at the DLRM path's shape is a few microseconds of
// device time, so a call costs what its host path costs.  Read from
// Python, each of the 26 tensors' dtype, device, shape, contiguity and
// pointer is an attribute call, and together they cost more than one
// library call on one tensor; here each is a field read of the
// at::Tensor, and the list crosses once.
// The CUDA source keeps its plain C launchers (built by nvcc without
// PyTorch's headers); this file, built by the host compiler against
// PyTorch's headers, calls them through the addresses `bind` is given.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <torch/csrc/utils/pybind.h>

#include <cstdint>
#include <string>
#include <vector>

namespace {

constexpr int64_t kMaxTables = 64;  // kMaxTables of embedding_bag.cu

using ForwardLaunch = int (*)(const long long* ptrs, const long long* rows,
                              int n_tables, const void* idx, void* out,
                              int batch, int hot, int d, int bf16,
                              void* stream);
using BackwardLaunch = int (*)(const void* grad_out, long long gs_bag,
                               long long gs_table, const void* idx,
                               const long long* ptrs, const long long* rows,
                               int n_tables, int batch, int hot, int d,
                               void* stream);
ForwardLaunch g_forward = nullptr;
BackwardLaunch g_backward = nullptr;

void require(bool ok, const char* what) {
  if (!ok) throw pybind11::value_error(what);
}

void check_launch(int rc, const char* name) {
  if (rc != 0) {
    throw std::runtime_error(std::string(name) +
                             ": kernel launch failed with CUDA error code " +
                             std::to_string(rc));
  }
}

// (B, T, hot) int32 ids, contiguous, on `device`
void check_sparse(const at::Tensor& sparse, const c10::Device& device,
                  int64_t n_tables) {
  require(sparse.scalar_type() == at::kInt && sparse.dim() == 3 &&
              sparse.is_contiguous() && sparse.device() == device,
          "sparse must be a contiguous int32 (B, T, hot) tensor on the "
          "tables' device");
  require(sparse.size(1) == n_tables,
          "sparse's second dim must equal the number of tables");
}

// T tables (N_t, d), f32 or bf16, one dtype, d and device, contiguous,
// rows in 16-byte chunks, 16-byte aligned -> (B, T, d) in their dtype
at::Tensor forward(const std::vector<at::Tensor>& tables,
                   const at::Tensor& sparse, int64_t stream) {
  const int64_t n = static_cast<int64_t>(tables.size());
  require(n >= 1 && n <= kMaxTables, "embedding_bags takes 1 to 64 tables");
  const at::Tensor& first = tables[0];
  const auto dtype = first.scalar_type();
  const c10::Device device = first.device();
  require(first.is_cuda() && (dtype == at::kFloat || dtype == at::kBFloat16) &&
              first.dim() == 2,
          "tables must be contiguous (N_t, d) float32 or bfloat16 CUDA "
          "tensors of one dtype, one d and one device");
  const int64_t d = first.size(1);
  require(d * first.element_size() % 16 == 0,
          "table rows must be whole 16-byte chunks, 16-byte aligned");
  long long ptrs[kMaxTables];
  long long rows[kMaxTables];
  for (int64_t i = 0; i < n; ++i) {
    const at::Tensor& t = tables[i];
    require(t.scalar_type() == dtype && t.device() == device &&
                t.dim() == 2 && t.size(1) == d && t.is_contiguous(),
            "tables must be contiguous (N_t, d) float32 or bfloat16 CUDA "
            "tensors of one dtype, one d and one device");
    ptrs[i] = reinterpret_cast<long long>(t.data_ptr());
    rows[i] = t.size(0);
    require(ptrs[i] % 16 == 0,
            "table rows must be whole 16-byte chunks, 16-byte aligned");
  }
  check_sparse(sparse, device, n);
  const int64_t batch = sparse.size(0);
  at::Tensor out = at::empty({batch, n, d}, first.options());
  check_launch(g_forward(ptrs, rows, static_cast<int>(n), sparse.data_ptr(),
                         out.data_ptr(), static_cast<int>(batch),
                         static_cast<int>(sparse.size(2)),
                         static_cast<int>(d), dtype == at::kBFloat16,
                         reinterpret_cast<void*>(stream)),
               "embedding_bag");
  return out;
}

// grad_out (B, T, d) f32 read through its (bag, table) strides, rows
// contiguous and 16-byte aligned -> T dense (rows[t], d) f32 gradients,
// views of one zeroed allocation
std::vector<at::Tensor> backward(const at::Tensor& grad_out,
                                 const at::Tensor& sparse,
                                 const std::vector<int64_t>& rows,
                                 int64_t stream) {
  const int64_t n = static_cast<int64_t>(rows.size());
  require(n >= 1 && n <= kMaxTables, "embedding_bags takes 1 to 64 tables");
  require(grad_out.is_cuda() && grad_out.scalar_type() == at::kFloat &&
              grad_out.dim() == 3 && grad_out.size(1) == n,
          "grad_out must be a float32 (B, T, d) CUDA tensor");
  const int64_t batch = grad_out.size(0);
  const int64_t d = grad_out.size(2);
  require(d % 4 == 0 && grad_out.stride(2) == 1 &&
              reinterpret_cast<uintptr_t>(grad_out.data_ptr()) % 16 == 0 &&
              grad_out.stride(0) % 4 == 0 && grad_out.stride(1) % 4 == 0,
          "grad_out rows must be whole float4 chunks, contiguous and "
          "16-byte aligned");
  check_sparse(sparse, grad_out.device(), n);
  require(sparse.size(0) == batch, "sparse and grad_out disagree on B");
  int64_t total = 0;
  long long ptrs[kMaxTables];
  long long counts[kMaxTables];
  for (int64_t i = 0; i < n; ++i) {
    require(rows[i] >= 0, "row counts must be >= 0");
    counts[i] = rows[i];
    total += rows[i];
  }
  at::Tensor flat = at::zeros({total, d}, grad_out.options());
  const long long base = reinterpret_cast<long long>(flat.data_ptr());
  for (int64_t i = 0, start = 0; i < n; start += rows[i], ++i) {
    ptrs[i] = base + start * d * 4;
  }
  check_launch(g_backward(grad_out.data_ptr(), grad_out.stride(0),
                          grad_out.stride(1), sparse.data_ptr(), ptrs,
                          counts, static_cast<int>(n),
                          static_cast<int>(batch),
                          static_cast<int>(sparse.size(2)),
                          static_cast<int>(d),
                          reinterpret_cast<void*>(stream)),
               "embedding_bag_backward");
  return flat.split_with_sizes(rows);
}

}  // namespace

PYBIND11_MODULE(embedding_bag_host, m) {
  m.def("bind", [](int64_t fwd, int64_t bwd) {
    g_forward = reinterpret_cast<ForwardLaunch>(fwd);
    g_backward = reinterpret_cast<BackwardLaunch>(bwd);
  });
  m.def("forward", &forward);
  m.def("backward", &backward);
}
