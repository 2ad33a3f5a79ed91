// K8 as a registered op inside a Python-free libtorch process.
//
// An AOTInductor package of a frozen int8 program calls
// paddle_tpu_torch::fused_dequant_matmul (and the int8 conv's
// quantize_activation and int8_rescale) through libtorch's dispatcher
// (the package's proxy executor). In Python the ops are registered by
// ops/kernels/quantized_matmul.py; a binary that runs the package without
// Python (pt_aoti_run) links this file, which registers the same schemas
// (kSchema, kQuantizeSchema and kRescaleSchema are that file's OP_SCHEMA,
// QUANTIZE_SCHEMA and RESCALE_SCHEMA, character for character) with the
// same arithmetic: the quantize (codes = clamp(round(x / s * qmax))) and
// the rescale ((float(acc) * float32(x_scale / qmax)) * (w_scale / qmax))
// on every device, and for K8:
//
//  * a CPU kernel: the plain version, dequant_matmul_reference's
//    arithmetic op for op (the quantize, an exact int32 accumulate
//    through a float64 matmul, the rescale);
//  * a CUDA kernel (built with PTT_WITH_CUDA): the launch of the Python
//    wrapper's _launch, through ptt_quantized_matmul of the kernel
//    library that ops/kernels/_build.py builds, loaded with dlopen on
//    first use from PTT_KERNEL_LIB (its path, fixed when the binary is
//    built), with a zeroed int32 workspace per (device, stream) and mode
//    that each launch leaves zero, sized by the library's own plan
//    (ptt_quantized_matmul_plan: the tile, split-K and workspace rule
//    lives there alone).
//
// ptt_aoti_k8_launches() counts the CUDA launches.
#include <dlfcn.h>

#include <ATen/ATen.h>
#include <c10/core/Stream.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <map>
#include <mutex>
#include <optional>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

namespace {

const char* kSchema =
    "fused_dequant_matmul(Tensor x, Tensor w_q, Tensor w_scale, float? x_scale=None, int bits=8) "
    "-> Tensor";
const char* kQuantizeSchema = "quantize_activation(Tensor x, float x_scale, int bits=8) -> Tensor";
const char* kRescaleSchema =
    "int8_rescale(Tensor acc, Tensor w_scale, float x_scale, int bits=8) -> Tensor";

std::atomic<long long> g_launches{0};

double qmax(int64_t bits) { return std::pow(2.0, static_cast<double>(bits - 1)) - 1.0; }

at::Tensor f32(double value, const at::Tensor& like) {
  return at::full({}, value, like.options().dtype(at::kFloat));
}

at::Tensor quantize(const at::Tensor& x, double x_scale, int64_t bits) {
  const double qm = qmax(bits);
  at::Tensor q = at::round(x / f32(std::max(x_scale, 1e-8), x) * qm);
  return at::clamp(q, -qm, qm).to(at::kChar);
}

at::Tensor rescale(const at::Tensor& acc, const at::Tensor& w_scale, double x_scale,
                   int64_t bits) {
  const double qm = qmax(bits);
  std::vector<int64_t> shape(acc.dim(), 1);
  shape[1] = -1;
  return (acc.to(at::kFloat) * f32(x_scale / qm, acc)) *
         (w_scale.reshape(shape).to(at::kFloat) / f32(qm, acc));
}

at::Tensor plain(const at::Tensor& x, const at::Tensor& w_q, const at::Tensor& w_scale,
                 std::optional<double> x_scale, int64_t bits) {
  const double qm = qmax(bits);
  if (!x_scale.has_value())
    return at::matmul(x, w_q.to(at::kFloat)) *
           (w_scale.reshape({1, -1}).to(at::kFloat) / f32(qm, x));
  at::Tensor acc = at::matmul(quantize(x, *x_scale, bits).to(at::kDouble), w_q.to(at::kDouble));
  return rescale(acc.to(at::kInt), w_scale, *x_scale, bits);
}

#ifdef PTT_WITH_CUDA
using LaunchFn = int (*)(const void*, const void*, const void*, void*, void*, void*, long long,
                         int, int, int, int, float, float, float, void*);
using PlanFn = int (*)(int, int, int, int, int*, long long*);

void* kernel_symbol(const char* name) {
  static void* lib = [] {
    void* handle = dlopen(PTT_KERNEL_LIB, RTLD_NOW | RTLD_LOCAL);
    TORCH_CHECK(handle != nullptr, "cannot load the kernel library ", PTT_KERNEL_LIB, ": ",
                dlerror(), " (build it with paddle_tpu_torch.ops.kernels._build.load_library())");
    return handle;
  }();
  void* sym = dlsym(lib, name);
  TORCH_CHECK(sym != nullptr, name, " not in ", PTT_KERNEL_LIB);
  return sym;
}

// zeroed int32 split-K workspaces, one per (device, stream) and mode,
// grown (a new zeroed tensor) only when outgrown
std::mutex g_mu;
std::map<std::tuple<int, void*, bool>, at::Tensor> g_workspaces;

at::Tensor workspace(long long words, const at::Tensor& x, void* stream, bool int8_mode) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto key = std::make_tuple(static_cast<int>(x.get_device()), stream, int8_mode);
  auto it = g_workspaces.find(key);
  if (it == g_workspaces.end() || it->second.numel() < words)
    it = g_workspaces.insert_or_assign(key, at::zeros({words}, x.options().dtype(at::kInt))).first;
  return it->second;
}

at::Tensor on_cuda(const at::Tensor& x, const at::Tensor& w_q, const at::Tensor& w_scale,
                   std::optional<double> x_scale, int64_t bits) {
  TORCH_CHECK(bits >= 2 && bits <= 8, "bits must be in [2, 8], got ", bits);
  TORCH_CHECK(x.dtype() == at::kFloat && x.dim() == 2 && x.is_contiguous(),
              "x must be a contiguous 2-dim float32 tensor");
  TORCH_CHECK(w_q.dtype() == at::kChar && w_q.dim() == 2 && w_q.is_contiguous() &&
                  w_q.device() == x.device(),
              "w_q must be a contiguous 2-dim int8 tensor on x's device");
  TORCH_CHECK(w_scale.dtype() == at::kFloat && w_scale.is_contiguous() &&
                  w_scale.device() == x.device(),
              "w_scale must be a contiguous float32 tensor on x's device");
  const int m = static_cast<int>(x.size(0)), k = static_cast<int>(x.size(1));
  const int n = static_cast<int>(w_q.size(1));
  TORCH_CHECK(w_q.size(0) == k && w_scale.numel() == n, "shapes do not match");
  at::Tensor out = at::empty({m, n}, x.options());
  if (m == 0 || n == 0) return out;
  const double qm = qmax(bits);
  const bool int8_mode = x_scale.has_value();
  const double s = int8_mode ? std::max(*x_scale, 1e-8) : 1.0;
  const double xs_over_qm = int8_mode ? *x_scale / qm : 0.0;
  c10::Stream st = c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)->getStream(x.device());
  void* stream = st.native_handle();
  // the split-K workspace the kernel library's plan asks for
  static const PlanFn plan_fn =
      reinterpret_cast<PlanFn>(kernel_symbol("ptt_quantized_matmul_plan"));
  static const LaunchFn launch_fn =
      reinterpret_cast<LaunchFn>(kernel_symbol("ptt_quantized_matmul"));
  int plan[3];
  long long words = 0;
  TORCH_CHECK(plan_fn(m, k, n, int8_mode ? 1 : 0, plan, &words) == 0,
              "K8 has no plan for M=", m, " K=", k, " N=", n);
  at::Tensor work;
  if (words > 0) work = workspace(words, x, stream, int8_mode);
  const int err = launch_fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                            nullptr, words > 0 ? work.data_ptr() : nullptr,
                            words > 0 ? work.numel() : 0, m, k, n, int8_mode ? 1 : 0,
                            static_cast<float>(s), static_cast<float>(qm),
                            static_cast<float>(xs_over_qm), stream);
  TORCH_CHECK(err == 0, "quantized_matmul kernel launch failed: cudaError_t ", err);
  g_launches.fetch_add(1);
  return out;
}
#endif

}  // namespace

extern "C" long long ptt_aoti_k8_launches() { return g_launches.load(); }

TORCH_LIBRARY(paddle_tpu_torch, m) {
  m.def(kSchema);
  m.def(kQuantizeSchema);
  m.def(kRescaleSchema);
  m.impl("quantize_activation", c10::DispatchKey::CompositeExplicitAutograd,
         TORCH_FN(quantize));
  m.impl("int8_rescale", c10::DispatchKey::CompositeExplicitAutograd, TORCH_FN(rescale));
  m.impl("fused_dequant_matmul", c10::DispatchKey::CPU, TORCH_FN(plain));
#ifdef PTT_WITH_CUDA
  m.impl("fused_dequant_matmul", c10::DispatchKey::CUDA, TORCH_FN(on_cuda));
#endif
}
