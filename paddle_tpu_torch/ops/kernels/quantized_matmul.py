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

The wrapper takes the plain version only for tensors that lie on the
CPU (or on the meta device, where shape inference evaluates ops without
data). On a CUDA tensor it launches the kernel or raises: a failed build
or a refused launch is an error, never a fallback. `launch_counts`
counts kernel launches (registered with `observability.profile`); each
launch reports its 2 M K N operations to the profile.

Scalars enter divisions as float32 tensors on the operand's device:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which is not the IEEE quotient the JAX package (and the kernel) compute.
"""
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import profile as _profile

__all__ = ["qmax", "dequant_matmul_reference", "fused_dequant_matmul",
           "launch_counts", "reset_launch_counts", "k8_tile",
           "k8_split_count", "k8_wo_tile", "k8_wo_split_count"]

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

#: streaming multiprocessors of an H100 SXM: split-K aims to fill them
_SMS = 132
#: k values per pipeline stage of the int8 kernel
_K_TILE = 64
_MAX_SPLITS = 16
#: arrival counters at the head of the weight-only workspace (kWoCounters
#: in csrc/quantized_matmul.cu)
_WO_COUNTERS = 256


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
    1e-8)), round half to even."""
    qm = qmax(bits)
    s = _f32(max(float(x_scale), 1e-8), x.device)
    q = torch.round(x / s * qm)
    return torch.clamp(q, -qm, qm).to(torch.int8)


def int8_rescale(acc, x_scale, w_scale, bits=8):
    """(float32(acc) * float32(x_scale / qmax)) * (w_scale / qmax)."""
    qm = qmax(bits)
    dev = acc.device
    return ((acc.to(torch.float32) * _f32(float(x_scale) / qm, dev))
            * (w_scale.reshape(1, -1).to(torch.float32) / _f32(qm, dev)))


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


def k8_tile(m):
    """(rows, columns) of the int8 kernel's output tile at M = m: 32 x 64
    up to M = 32 (the main path's batches 1, 8, 32), else 64 x 256 (the
    wide tile quantizes each row of x for fewer column tiles)."""
    return (32, 64) if m <= 32 else (64, 256)


def k8_split_count(m, k, n):
    """k ranges per output tile of the int8 kernel (split-K): none when
    the output tiles alone fill the 132 SMs, else as many as put one
    block on each SM (8 at the ResNet-50 fc), at most _MAX_SPLITS and
    never under two k tiles of 64 each."""
    bm, bn = k8_tile(m)
    tiles = -(-m // bm) * -(-n // bn)
    return _splits(tiles, k)


def _splits(tiles, k):
    if tiles >= _SMS:
        return 1
    k_tiles = -(-k // _K_TILE)
    return int(max(1, min(_SMS // tiles, _MAX_SPLITS, k_tiles // 2)))


def k8_wo_tile(m, n):
    """(rows of x, weight columns) of the weight-only kernel's output tile
    at M = m, N = n: the least of 8, 16, 32, 64 rows that holds m, by 64
    columns (one warpgroup: the columns fill wgmma's 64-row side); above
    64 rows, 128 x 128 (two warpgroups) where those tiles fill the card,
    else 32 x 64 (more tiles in flight; on the card it beat 64 x 64 at
    every such shape timed)."""
    for bm in (8, 16, 32, 64):
        if m <= bm:
            return bm, 64
    if -(-m // 128) * -(-n // 128) >= _SMS:
        return 128, 128
    return 32, 64


def k8_wo_split_count(m, k, n):
    """k ranges per output tile of the weight-only kernel, by
    k8_split_count's rule over its own tiles (8 at the ResNet-50 fc)."""
    bm, bn = k8_wo_tile(m, n)
    return _splits(-(-m // bm) * -(-n // bn), k)


def _wo_workspace_words(m, k, n):
    """int32 words of the weight-only split-K workspace: _WO_COUNTERS
    arrival counters (a split call has fewer tiles than _SMS, so calls of
    every shape share them where they stay zero), then splits x tiles x
    threads x bm / 2 float32 partial sums."""
    bm, bn = k8_wo_tile(m, n)
    tiles = -(-m // bm) * -(-n // bn)
    threads = 2 * bn
    return (_WO_COUNTERS
            + k8_wo_split_count(m, k, n) * tiles * threads * bm // 2)


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
    int32 accumulator with `return_acc`, int8 mode only)."""
    if x.device.type in ("cpu", "meta"):
        return dequant_matmul_reference(x, w_q, w_scale, x_scale=x_scale,
                                        bits=bits, return_acc=return_acc)
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
    work, cache = None, _workspaces
    if int8_mode:
        splits = k8_split_count(m, k, n)
        if splits > 1:   # int32 sums [M, N], then one arrival counter a tile
            bm, bn = k8_tile(m)
            work = _workspace(m * n + -(-m // bm) * -(-n // bn), x.device,
                              cache)
    else:
        splits = k8_wo_split_count(m, k, n)
        cache = _wo_workspaces
        if splits > 1:   # arrival counters, then the splits' partial tiles
            work = _workspace(_wo_workspace_words(m, k, n), x.device, cache)
    lib = _build.load_library()
    err = lib.ptt_quantized_matmul(
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        acc.data_ptr() if acc is not None else None,
        work.data_ptr() if work is not None else None,
        m, k, n, int(int8_mode), splits, s, qm, xs_over_qm,
        _stream(x.device))
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
