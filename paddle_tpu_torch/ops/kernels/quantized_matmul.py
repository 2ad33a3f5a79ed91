"""Fused dequant matmul: kernel K8.

Counterpart of `paddle_tpu/ops/pallas/quantized_matmul.py`: x [M, K]
float32 @ w_q [K, N] int8 with per-output-channel scales w_scale [N]
(w ~= w_q * w_scale / qmax, qmax = 2^(bits-1) - 1). Two modes:

* int8-activation (`x_scale` given; the frozen `quantized_mul`): x is
  quantized at the static scale, codes = clip(round(x / s * qmax)) with
  s = float32(max(x_scale, 1e-8)), divided then multiplied, rounded half
  to even; an exact int32 accumulate of codes x w_q; then
  out = (float(acc) * float32(x_scale / qmax)) * (w_scale / qmax), with
  x_scale / qmax divided in double on the host and rounded to float32
  once (the JAX fold order).
* weight-only (`x_scale=None`): x @ float(w_q) accumulated in float32,
  times w_scale / qmax.

The kernel is CUDA C++ for Hopper (`paddle_tpu_torch/csrc/
quantized_matmul.cu`, built by `_build.py` on first use): int8 mode on
the s8 tensor cores (mma.sync) with split-K at small M, weight-only mode
on the bf16 tensor cores (wgmma; x in three bf16 pieces, which carry
float32's bits, against the codes, exact in bf16) with a deterministic
split-K (partials summed in split order by the last block). Beside it
stands its plain PyTorch version, `dequant_matmul_reference`, the same
arithmetic as the JAX package's `dequant_matmul_reference`: it computes
the int32 accumulator as a float64 matmul of the codes (exact for
K < 2^53 / 127^2; CUDA has no integer GEMM in `torch.matmul`).

K8 is a registered PyTorch op, `paddle_tpu_torch::fused_dequant_matmul`
(schema `OP_SCHEMA`, the one copy of it in Python; the C++ that runs an
AOTInductor package without Python, `native/src/aoti_ops.cc`, registers
the same string): its CPU implementation is the plain version, its CUDA
implementation the launch, and its fake implementation gives the
[M, N] float32 output from shapes alone, so `torch.export` traces a
program through it and the exported graph names the kernel (as the JAX
package's StableHLO names its Pallas custom call). The op takes the
plain version only for tensors that lie on the CPU (or on the meta
device, where shape inference evaluates ops without data). On a CUDA
tensor it launches the kernel or raises: a failed build or a refused
launch is an error, never a fallback.

The int8 activation quantization and rescale that the frozen int8 conv
shares with K8's plain version are registered ops too
(`quantize_activation`, `int8_rescale`; `QUANTIZE_SCHEMA`,
`RESCALE_SCHEMA`), plain PyTorch on every device: AOTInductor replaces a
division by a constant with a multiply by its reciprocal on the GPU,
which moves activation codes across a rounding edge, so a compiled
package keeps these ops' IEEE divisions by calling them. `launch_counts`
counts kernel launches (registered with `observability.profile`); each
launch reports its 2 M K N operations to the profile.

Scalars enter divisions as float32 tensors on the operand's device:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which is not the IEEE quotient the JAX package (and the kernel) compute.
"""
import ctypes

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import profile as _profile

__all__ = ["qmax", "dequant_matmul_reference", "fused_dequant_matmul",
           "launch_counts", "reset_launch_counts", "k8_plan",
           "OP_NAMESPACE", "OP_SCHEMA", "QUANTIZE_SCHEMA", "RESCALE_SCHEMA",
           "op"]

#: the registered ops: torch.ops.paddle_tpu_torch.<name>
OP_NAMESPACE = "paddle_tpu_torch"
OP_SCHEMA = ("fused_dequant_matmul(Tensor x, Tensor w_q, Tensor w_scale, "
             "float? x_scale=None, int bits=8) -> Tensor")
QUANTIZE_SCHEMA = ("quantize_activation(Tensor x, float x_scale, "
                   "int bits=8) -> Tensor")
RESCALE_SCHEMA = ("int8_rescale(Tensor acc, Tensor w_scale, float x_scale, "
                  "int bits=8) -> Tensor")

#: kernel launches: every launched call counts under "quantized_matmul";
#: weight-only calls (their own kernel) also under
#: "quantized_matmul_weight_only"
launch_counts = _profile.register_launch_counts(
    {"quantized_matmul": 0, "quantized_matmul_weight_only": 0})

#: split-K workspaces, one per (device, stream) and mode: int32 zeros,
#: zeroed once here; each launch leaves what must be zero zero again. A
#: captured graph holds the pointer of the workspace it was captured
#: with (an int8 Predictor's graph per batch size), so one that is
#: outgrown stays alive in _retired_workspaces, and growing one while a
#: capture runs raises (the capture's warm-up run sizes it first)
_workspaces = {}
_wo_workspaces = {}
_retired_workspaces = []


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def qmax(bits):
    return float(2 ** (bits - 1) - 1)


def _f32(value, device):
    """A 0-dim float32 tensor on `device` holding float32(value), made by
    a fill on the device (no host-to-device copy)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def quantize_activation(x, x_scale, bits=8):
    """int8 codes of x at a static abs-max scale, in the JAX order:
    clip(round(x / s * qmax), -qmax, qmax), s = float32(max(x_scale,
    1e-8)), round half to even (the registered op)."""
    return torch.ops.paddle_tpu_torch.quantize_activation(
        x, float(x_scale), int(bits))


def int8_rescale(acc, x_scale, w_scale, bits=8):
    """(float32(acc) * float32(x_scale / qmax)) * (w_scale / qmax), the
    per-channel scales along acc's dim 1 (the registered op)."""
    return torch.ops.paddle_tpu_torch.int8_rescale(
        acc, w_scale, float(x_scale), int(bits))


def _quantize_plain(x, x_scale, bits=8):
    qm = qmax(bits)
    s = _f32(max(float(x_scale), 1e-8), x.device)
    q = torch.round(x / s * qm)
    return torch.clamp(q, -qm, qm).to(torch.int8)


def _rescale_plain(acc, w_scale, x_scale, bits=8):
    qm = qmax(bits)
    dev = acc.device
    shape = [1] * acc.dim()
    shape[1] = -1
    return ((acc.to(torch.float32) * _f32(float(x_scale) / qm, dev))
            * (w_scale.reshape(shape).to(torch.float32) / _f32(qm, dev)))


def dequant_matmul_reference(x, w_q, w_scale, x_scale=None, bits=8,
                             return_acc=False):
    """The plain version of K8. x [M, K] float32; w_q [K, N] int8;
    w_scale [N] float32. With `return_acc` (int8-activation mode only)
    also returns the int32 accumulator [M, N]."""
    qm = qmax(bits)
    if x_scale is None:
        enforce(not return_acc, "return_acc needs x_scale (int8 mode)")
        return (torch.matmul(x, w_q.to(torch.float32))
                * (w_scale.reshape(1, -1).to(torch.float32)
                   / _f32(qm, x.device)))
    xq = quantize_activation(x, x_scale, bits)
    acc = torch.matmul(xq.to(torch.float64),
                       w_q.to(torch.float64)).to(torch.int32)
    out = int8_rescale(acc, x_scale, w_scale, bits)
    return (out, acc) if return_acc else out


def k8_plan(m, k, n, int8_mode=True):
    """K8's launch plan at (M, K, N) in int8 or weight-only mode, asked of
    the kernel library (`ptt_quantized_matmul_plan`,
    csrc/quantized_matmul_plan.cu: the one copy of the tile, split-K and
    workspace rule, which the launch itself follows): {"tile": (rows,
    columns), "splits": k ranges per output tile, "words": int32 words
    of the split-K workspace, 0 without a split}."""
    from paddle_tpu_torch.ops.kernels import _build
    tile_splits = (ctypes.c_int * 3)()
    words = ctypes.c_longlong()
    err = _build.load_library().ptt_quantized_matmul_plan(
        int(m), int(k), int(n), int(bool(int8_mode)), tile_splits,
        ctypes.byref(words))
    enforce(err == 0, "K8 has no plan for M=%s K=%s N=%s", m, k, n)
    return {"tile": (tile_splits[0], tile_splits[1]),
            "splits": tile_splits[2], "words": words.value}


def _check(name, t, dtype, ndim, device):
    enforce(t.device == device, "%s must lie on %s, got %s", name, device,
            t.device)
    enforce(t.dtype == dtype, "%s must be %s, got %s", name, dtype, t.dtype)
    enforce(t.dim() == ndim and t.is_contiguous(),
            "%s must be a contiguous %d-dim tensor, got shape %s strides %s",
            name, ndim, tuple(t.shape), t.stride())


def fused_dequant_matmul(x, w_q, w_scale, x_scale=None, bits=8,
                         return_acc=False):
    """K8: x [M, K] float32 @ w_q [K, N] int8 with per-channel scales
    w_scale [N] float32, int8-activation mode when `x_scale` is given,
    weight-only otherwise. Any M, K, N. Returns [M, N] float32 (and the
    int32 accumulator with `return_acc`, int8 mode only, which the op's
    schema does not carry: that call runs outside the dispatcher)."""
    if not return_acc:
        return op()(x, w_q, w_scale, None if x_scale is None
                    else float(x_scale), int(bits))
    if x.device.type in ("cpu", "meta"):
        return dequant_matmul_reference(x, w_q, w_scale, x_scale=x_scale,
                                        bits=bits, return_acc=True)
    return _checked_launch(x, w_q, w_scale, x_scale, bits, True)


def _checked_launch(x, w_q, w_scale, x_scale, bits, return_acc):
    enforce(x.is_cuda, "fused_dequant_matmul: unsupported device %s",
            x.device)
    enforce(2 <= bits <= 8, "bits must be in [2, 8], got %s", bits)
    enforce(not return_acc or x_scale is not None,
            "return_acc needs x_scale (int8 mode)")
    _check("x", x, torch.float32, 2, x.device)
    _check("w_q", w_q, torch.int8, 2, x.device)
    _check("w_scale", w_scale.reshape(-1), torch.float32, 1, x.device)
    m, k = x.shape
    n = w_q.shape[1]
    enforce(w_q.shape[0] == k and w_scale.numel() == n,
            "shapes do not match: x %s, w_q %s, w_scale %s", tuple(x.shape),
            tuple(w_q.shape), tuple(w_scale.shape))
    return _launch(x, w_q, w_scale, x_scale, bits, return_acc)


# ---------------------------------------------------------------------------
# the registered ops
# ---------------------------------------------------------------------------

def _op_cpu(x, w_q, w_scale, x_scale=None, bits=8):
    return dequant_matmul_reference(x, w_q, w_scale, x_scale=x_scale,
                                    bits=bits)


def _op_cuda(x, w_q, w_scale, x_scale=None, bits=8):
    return _checked_launch(x, w_q, w_scale, x_scale, bits, False)


def _op_fake(x, w_q, w_scale, x_scale=None, bits=8):
    return x.new_empty((x.shape[0], w_q.shape[1]), dtype=torch.float32)


def _register():
    """Define the ops once a process (the Library must stay alive for its
    registrations to stay)."""
    if hasattr(getattr(torch.ops, OP_NAMESPACE), "fused_dequant_matmul"):
        return None
    lib = torch.library.Library(OP_NAMESPACE, "FRAGMENT")
    fakes = {"fused_dequant_matmul": _op_fake,
             "quantize_activation": lambda x, x_scale, bits=8:
                 torch.empty_like(x, dtype=torch.int8),
             "int8_rescale": lambda acc, w_scale, x_scale, bits=8:
                 torch.empty_like(acc, dtype=torch.float32)}
    for schema in (OP_SCHEMA, QUANTIZE_SCHEMA, RESCALE_SCHEMA):
        lib.define(schema)
    lib.impl("fused_dequant_matmul", _op_cpu, "CPU")
    lib.impl("fused_dequant_matmul", _op_cuda, "CUDA")
    lib.impl("quantize_activation", _quantize_plain,
             "CompositeExplicitAutograd")
    lib.impl("int8_rescale", _rescale_plain, "CompositeExplicitAutograd")
    for name, fake in fakes.items():
        torch.library.register_fake(f"{OP_NAMESPACE}::{name}", fake,
                                    lib=lib)
    return lib


_LIB = _register()


def op():
    """The op's overload packet, torch.ops.paddle_tpu_torch.
    fused_dequant_matmul."""
    return torch.ops.paddle_tpu_torch.fused_dequant_matmul


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch(x, w_q, w_scale, x_scale, bits, return_acc):
    """One K8 launch on checked operands; counts it."""
    from paddle_tpu_torch.ops.kernels import _build
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    acc = (torch.empty((m, n), dtype=torch.int32, device=x.device)
           if return_acc else None)
    if m == 0 or n == 0:
        return (out, acc) if return_acc else out
    qm = qmax(bits)
    int8_mode = x_scale is not None
    s = max(float(x_scale), 1e-8) if int8_mode else 1.0
    xs_over_qm = float(x_scale) / qm if int8_mode else 0.0
    cache = _workspaces if int8_mode else _wo_workspaces
    words = k8_plan(m, k, n, int8_mode)["words"]
    work = _workspace(words, x.device, cache) if words else None
    lib = _build.load_library()
    err = lib.ptt_quantized_matmul(
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        acc.data_ptr() if acc is not None else None,
        work.data_ptr() if work is not None else None,
        work.numel() if work is not None else 0,
        m, k, n, int(int8_mode), s, qm, xs_over_qm, _stream(x.device))
    if err != 0:
        dropped = cache.pop((x.device, _stream(x.device)), None)
        if dropped is not None:
            _retired_workspaces.append(dropped)
        raise RuntimeError(
            f"quantized_matmul kernel launch failed: cudaError_t {err}")
    launch_counts["quantized_matmul"] += 1
    if not int8_mode:
        launch_counts["quantized_matmul_weight_only"] += 1
    _profile.note_kernel_flops(2.0 * m * k * n)
    return (out, acc) if return_acc else out


def _workspace(size, device, cache):
    """At least `size` zeroed int32 of the split-K workspace of `device`'s
    current stream in `cache` (kernels on one stream run in order, so
    they can share it); allocated, and zeroed, only when it has to
    grow."""
    key = (device, _stream(device))
    work = cache.get(key)
    if work is None or work.numel() < size:
        enforce(device.type != "cuda"
                or not torch.cuda.is_current_stream_capturing(),
                "K8's split-K workspace would grow from %s to %s int32 "
                "while a CUDA graph is being captured; run the call once "
                "on the capture stream first", 0 if work is None
                else work.numel(), size)
        if work is not None:
            _retired_workspaces.append(work)
        work = cache[key] = torch.zeros(size, dtype=torch.int32,
                                        device=device)
    return work
