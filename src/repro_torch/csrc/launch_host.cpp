// Host side of the kernels whose host path is their cost: the fused
// embedding bags (csrc/embedding_bag.cu) and the CPR tracker kernels
// (csrc/tracker_select.cu, csrc/ssu_dedupe.cu).  Each call's argument
// checks, output and scratch allocation and launch run here, in one call
// from Python.
//
// The kernels' own work at the DLRM path's shapes is a few (embedding
// bags, ssu_dedupe_evict) to tens (tracker_select) of microseconds of
// device time, so a call costs what its host path costs.  Read from
// Python, each tensor's dtype, device, shape, contiguity and pointer is
// an attribute call (26 tensors for the embedding bags), and together they
// cost more than one library call on one tensor; here each is a field
// read of the at::Tensor, and a list crosses once.
// The CUDA sources keep their plain C launchers (built by nvcc without
// PyTorch's headers); this file, built by the host compiler against
// PyTorch's headers, calls them through the addresses `bind` is given.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <torch/csrc/utils/pybind.h>

#include <algorithm>
#include <cstdint>
#include <string>
#include <tuple>
#include <vector>

namespace {

using ForwardLaunch = int (*)(const long long* ptrs, const long long* rows,
                              int n_tables, const void* idx, void* out,
                              int batch, int hot, int d, int bf16, int vec,
                              void* stream);
using BackwardLaunch = int (*)(const void* grad_out, long long gs_bag,
                               long long gs_table, long long gs_elem,
                               const void* idx, const long long* ptrs,
                               const long long* rows, int n_tables,
                               int batch, int hot, int d, int vec,
                               void* stream);
using SelectScratch = long long (*)(long long n_rows, int seg, int k);
using SelectLaunch = int (*)(const void* counts, const void* pending,
                             long long n_pending, void* new_counts, void* ids,
                             void* scratch, long long n_rows, int seg, int k,
                             void* stream);
using ScratchWords = long long (*)(int nc);
using SsuLaunch = int (*)(const void* buf, const void* cand,
                          const void* scores, void* out, void* scratch,
                          int rn, int nc, void* stream);
ForwardLaunch g_forward = nullptr;
BackwardLaunch g_backward = nullptr;
SelectScratch g_select_scratch = nullptr;
SelectLaunch g_select = nullptr;
ScratchWords g_scratch_words = nullptr;
SsuLaunch g_ssu = nullptr;

void require(bool ok, const std::string& what) {
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// T tables (N_t, d), f32 or bf16, one dtype, d and device, contiguous ->
// (B, T, d) in their dtype.  Rows in whole 16-byte chunks, 16-byte
// aligned, take the vector path; any others the element path.
at::Tensor forward(const std::vector<at::Tensor>& tables,
                   const at::Tensor& sparse, int64_t stream) {
  const int64_t n = static_cast<int64_t>(tables.size());
  require(n >= 1, "embedding_bags takes at least one table");
  const at::Tensor& first = tables[0];
  const auto dtype = first.scalar_type();
  const c10::Device device = first.device();
  require(first.is_cuda() && (dtype == at::kFloat || dtype == at::kBFloat16) &&
              first.dim() == 2,
          "tables must be contiguous (N_t, d) float32 or bfloat16 CUDA "
          "tensors of one dtype, one d and one device");
  const int64_t d = first.size(1);
  bool vec = d * first.element_size() % 16 == 0;
  std::vector<long long> ptrs(n), rows(n);
  for (int64_t i = 0; i < n; ++i) {
    const at::Tensor& t = tables[i];
    require(t.scalar_type() == dtype && t.device() == device &&
                t.dim() == 2 && t.size(1) == d && t.is_contiguous(),
            "tables must be contiguous (N_t, d) float32 or bfloat16 CUDA "
            "tensors of one dtype, one d and one device");
    ptrs[i] = reinterpret_cast<long long>(t.data_ptr());
    rows[i] = t.size(0);
    vec = vec && aligned16(t.data_ptr());
  }
  check_sparse(sparse, device, n);
  const int64_t batch = sparse.size(0);
  at::Tensor out = at::empty({batch, n, d}, first.options());
  check_launch(g_forward(ptrs.data(), rows.data(), static_cast<int>(n),
                         sparse.data_ptr(), out.data_ptr(),
                         static_cast<int>(batch),
                         static_cast<int>(sparse.size(2)),
                         static_cast<int>(d), dtype == at::kBFloat16, vec,
                         reinterpret_cast<void*>(stream)),
               "embedding_bag");
  return out;
}

// grad_out (B, T, d) f32 read in place through its strides -> T dense
// (rows[t], d) f32 gradients, views of one zeroed allocation.  Rows that
// are whole float4 runs, contiguous and 16-byte aligned, take the vector
// path; any others the element path.
std::vector<at::Tensor> backward(const at::Tensor& grad_out,
                                 const at::Tensor& sparse,
                                 const std::vector<int64_t>& rows,
                                 int64_t stream) {
  const int64_t n = static_cast<int64_t>(rows.size());
  require(n >= 1, "embedding_bags takes at least one table");
  require(grad_out.is_cuda() && grad_out.scalar_type() == at::kFloat &&
              grad_out.dim() == 3 && grad_out.size(1) == n,
          "grad_out must be a float32 (B, T, d) CUDA tensor");
  const int64_t batch = grad_out.size(0);
  const int64_t d = grad_out.size(2);
  const bool vec = d % 4 == 0 && grad_out.stride(2) == 1 &&
                   aligned16(grad_out.data_ptr()) &&
                   grad_out.stride(0) % 4 == 0 && grad_out.stride(1) % 4 == 0;
  check_sparse(sparse, grad_out.device(), n);
  require(sparse.size(0) == batch, "sparse and grad_out disagree on B");
  int64_t total = 0;
  std::vector<long long> ptrs(n), counts(n);
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
                          grad_out.stride(1), grad_out.stride(2),
                          sparse.data_ptr(), ptrs.data(), counts.data(),
                          static_cast<int>(n), static_cast<int>(batch),
                          static_cast<int>(sparse.size(2)),
                          static_cast<int>(d), vec,
                          reinterpret_cast<void*>(stream)),
               "embedding_bag_backward");
  return flat.split_with_sizes(rows);
}

bool flat_on(const at::Tensor& t, const c10::Device& device) {
  return t.dim() == 1 && t.is_contiguous() && t.device() == device;
}

// counts (N,) int32 on a CUDA device (the caller checked), pending (n,)
// int32 ids (may be empty) -> (row_ids (n_seg*k,) int32, new_counts (N,)
// int32)
std::tuple<at::Tensor, at::Tensor> tracker_select(const at::Tensor& counts,
                                                  const at::Tensor& pending,
                                                  int64_t k, int64_t seg_size,
                                                  int64_t stream) {
  require(counts.scalar_type() == at::kInt &&
              pending.scalar_type() == at::kInt,
          "counts and indices must be int32");
  require(counts.dim() == 1 && counts.is_contiguous(),
          "counts must be a contiguous (N,) tensor");
  require(pending.dim() == 1 && pending.is_contiguous(),
          "indices must be a contiguous 1-D tensor");
  require(pending.device() == counts.device(),
          "indices must lie on the counts' device");
  const int64_t n = counts.size(0);
  const int64_t seg = std::min<int64_t>(seg_size, std::max<int64_t>(n, 1));
  const int64_t n_seg = (n + seg - 1) / seg;
  k = std::min(k, seg);
  require(k >= 1, "k must be >= 1, got " + std::to_string(k));
  require(seg < (int64_t{1} << 31), "seg_size must fit in int32");
  at::Tensor ids = at::empty({n_seg * k}, counts.options());
  at::Tensor new_counts = at::empty({n}, counts.options());
  if (n == 0) return {ids, new_counts};
  const int s = static_cast<int>(seg), kk = static_cast<int>(k);
  const long long words = g_select_scratch(n, s, kk);
  at::Tensor scratch;                     // the wide path's sort area
  if (words) scratch = at::empty({words}, counts.options().dtype(at::kLong));
  check_launch(g_select(counts.data_ptr(), pending.data_ptr(),
                        pending.numel(), new_counts.data_ptr(),
                        ids.data_ptr(), words ? scratch.data_ptr() : nullptr,
                        n, s, kk, reinterpret_cast<void*>(stream)),
               "tracker_select");
  return {ids, new_counts};
}

// buf (rn,) int32 sorted, EMPTY-padded, on a CUDA device (the caller
// checked); cand (nc,) int32 in any order; scores (rn + nc,) float32 ->
// new (rn,) sorted int32 buffer
at::Tensor ssu_dedupe_evict(const at::Tensor& buf, const at::Tensor& cand,
                            const at::Tensor& scores, int64_t stream) {
  require(buf.scalar_type() == at::kInt && cand.scalar_type() == at::kInt,
          "buf and cand must be int32");
  require(scores.scalar_type() == at::kFloat, "scores must be float32");
  const c10::Device device = buf.device();
  require(flat_on(buf, device) && flat_on(cand, device) &&
              flat_on(scores, device),
          "buf, cand and scores must be contiguous 1-D tensors on one device");
  const int64_t rn = buf.size(0), nc = cand.size(0);
  require(rn >= 1, "the reservoir must have at least one slot");
  require(scores.size(0) == rn + nc, "scores must have rn + nc entries");
  require(rn + nc < (int64_t{1} << 31),
          "reservoir too large for int32 positions");
  const int r = static_cast<int>(rn), c = static_cast<int>(nc);
  at::Tensor scratch = at::empty({g_scratch_words(c)}, buf.options());
  at::Tensor out = at::empty({rn}, buf.options());
  check_launch(g_ssu(buf.data_ptr(), cand.data_ptr(), scores.data_ptr(),
                     out.data_ptr(), scratch.data_ptr(), r, c,
                     reinterpret_cast<void*>(stream)),
               "ssu_dedupe_evict");
  return out;
}

}  // namespace

PYBIND11_MODULE(launch_host, m) {
  m.def("bind", [](int64_t fwd, int64_t bwd, int64_t select_scratch,
                   int64_t select, int64_t scratch_words, int64_t ssu) {
    g_forward = reinterpret_cast<ForwardLaunch>(fwd);
    g_backward = reinterpret_cast<BackwardLaunch>(bwd);
    g_select_scratch = reinterpret_cast<SelectScratch>(select_scratch);
    g_select = reinterpret_cast<SelectLaunch>(select);
    g_scratch_words = reinterpret_cast<ScratchWords>(scratch_words);
    g_ssu = reinterpret_cast<SsuLaunch>(ssu);
  });
  m.def("embedding_bags_forward", &forward);
  m.def("embedding_bags_backward", &backward);
  m.def("tracker_select", &tracker_select);
  m.def("ssu_dedupe_evict", &ssu_dedupe_evict);
}
