"""Flash attention, forward and backward: kernels K1-K4 of the port.

Counterpart of the training half of
`paddle_tpu/ops/pallas/flash_attention.py` (`flash_attention`,
`flash_attention_lse`). On a CUDA tensor each public function is a
`torch.autograd.Function` over CUDA C++ kernels for Hopper (built by
`_build.py` on first use), chosen by dtype:

- bfloat16: two tensor-core (wgmma) kernels of
  `paddle_tpu_torch/csrc/flash_attention_tc.cu`, `flash_fwd` (K1 and the
  single-tile K4f) and `flash_bwd` (K2, K3 and the single-tile K4b: dQ,
  dK, dV and dbias in one launch, dQ summed into a float32 workspace);
- float32: the same two roles on the bf16 tensor cores with every f32
  operand in three bf16 pieces and six piece products per f32 product,
  so f32's digits are kept where TF32 would keep ~3: the forward
  `flash_fwd_f32` (`csrc/flash_fwd_f32_tc.cu`) and the backward
  `flash_bwd_f32` (`csrc/flash_bwd_f32_tc.cu`: dQ, dK, dV and dbias in
  one launch, p recomputed from the forward's lse, dQ summed into a
  zeroed float32 workspace that is the output itself).

The kernels stream tiles whatever T is, so the Pallas single-tile fast
path has no separate kernel here.

Beside them stand their plain PyTorch versions: `keep_mask_reference`,
the dropout hash bit for bit, and `attention_reference`, the same
arithmetic as the JAX package's `attention_reference`. A wrapper takes
the plain version only because the tensors it was given lie on the CPU;
on a CUDA tensor it launches the kernels of its dtype or raises (a failed
build, a refused launch, an unsupported head dim or dtype, a bfloat16
view whose rows are not 16-byte aligned; a float32 view of any stride
is taken); no call reaches a CUDA-core kernel.
`launch_counts` counts launches per kernel (registered with
`observability.profile`, so a captured graph adds its launches on every
replay); each launch reports its operations to the profile.

Differences from the JAX signature: the `dropout_rng` key becomes an
integer `dropout_seed` in [0, 2**23) (the value the JAX wrapper draws
with `jax.random.randint`, which torch cannot reproduce), and
`block_q`/`block_k` are accepted for parity but do not change the
result. `PT_FLASH_BLOCK` has no counterpart.
"""
import ctypes
import math

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import profile as _profile

__all__ = [
    "NEG_INF", "SEED_LIMIT", "flash_attention", "flash_attention_lse",
    "keep_mask_reference", "attention_reference", "launch_counts",
    "reset_launch_counts",
]

#: masked-logit value of the JAX package (causal mask)
NEG_INF = -1e30
#: dropout seeds are integers in [0, SEED_LIMIT), exact in float32
SEED_LIMIT = 1 << 23
#: head dims the kernels are instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
#: the kernel of each dtype: (forward, backward kernels)
KERNELS = {torch.bfloat16: ("flash_fwd", ("flash_bwd",)),
           torch.float32: ("flash_fwd_f32", ("flash_bwd_f32",))}

# murmur3 fmix32 constants and the golden-ratio stream separator
_M1, _M2, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
_U32 = 0xFFFFFFFF

#: kernel launches per kernel (bumped once per launched call)
launch_counts = _profile.register_launch_counts(
    {name: 0 for fwd, bwd in KERNELS.values() for name in (fwd, *bwd)})


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _mul32(x, c):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant,
    from 16-bit halves so no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def keep_threshold(p):
    """floor(p * 2**32), clamped to 2**32 - 1 (the keep test is x >= it)."""
    return min(int(p * 2.0 ** 32), _U32)


def keep_mask_reference(seed, bh, tq, tk, p, device=None):
    """The kernels' dropout mask: float32 [..., tq, tk] holding 1/(1-p)
    where kept and 0 where dropped, for the integer `seed` and the
    (batch * num_heads + head) index `bh` (an int or an integer tensor
    of any shape, which leads the result). Bit for bit the JAX
    package's `_np_keep_mask`; computed in int64 masked to 32 bits."""
    bh = torch.as_tensor(bh, dtype=torch.int64, device=device)
    rows = torch.arange(tq, dtype=torch.int64, device=bh.device)[:, None]
    cols = torch.arange(tk, dtype=torch.int64, device=bh.device)[None, :]
    stream = _fmix32((int(seed) + _mul32(bh & _U32, _GOLD)) & _U32)
    ctr = ((rows << 16) ^ cols) & _U32
    x = _fmix32((ctr + stream[..., None, None]) & _U32)
    keep = x >= keep_threshold(p)
    return keep.to(torch.float32) / np.float32(1.0 - p)


def batch_keep_masks(seed, b, n, tq, tk, p, device=None):
    """[B, N, tq, tk] keep masks of every (batch, head), as the kernels
    draw them (bh = b * N + n)."""
    bh = torch.arange(b * n, dtype=torch.int64, device=device).reshape(b, n)
    return keep_mask_reference(seed, bh, tq, tk, p, device=device)


def _bias(mask, b, tk):
    return None if mask is None else mask.to(torch.float32).reshape(b, 1, 1, tk)


def attention_reference(q, k, v, mask=None, causal=False, sm_scale=None,
                        keep_masks=None, return_lse=False):
    """Einsum attention with the JAX package's `attention_reference`
    arithmetic: f32 logits (+ the additive key mask [B, Tk] or
    [B, 1, 1, Tk], causal at NEG_INF), f32 softmax, times `keep_masks`
    [B, N, Tq, Tk] if given, probabilities cast to q's dtype, f32
    product cast to q's dtype. q [B, Tq, N, D], k/v [B, Tk, N, D].
    With `return_lse` also the f32 log-sum-exp of the logits as
    [B, Tq, N, 1]."""
    b, tq, n, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) * sm_scale
    if mask is not None:
        logits = logits + _bias(mask, b, tk)
    if causal:
        keep = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if keep_masks is not None:
        probs = probs * keep_masks
    probs = probs.to(q.dtype)
    out = torch.einsum("bnts,bsnd->btnd", probs.float(), v.float()).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1)                  # [B, N, Tq]
    return out, lse.permute(0, 2, 1)[..., None]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _aligned(t):
    """Rows the tensor-core kernels can copy in 16-byte pieces: a 16-byte
    aligned start and (batch, time, head) strides of whole 8-element
    pieces."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _check(q, k, v, mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        enforce(t.dtype in KERNELS, "%s must be float32 or bfloat16, got %s",
                name, t.dtype)
        enforce(t.dim() == 4, "%s must be [B, T, N, D], got shape %s", name,
                tuple(t.shape))
        enforce(t.stride(-1) == 1, "%s must be contiguous in its last dim "
                "(strides %s)", name, t.stride())
        enforce(t.dtype != torch.bfloat16 or _aligned(t), "%s: bfloat16 rows "
                "must start 16-byte aligned, strides in multiples of 8 "
                "elements (strides %s)", name, t.stride())
    b, tq, n, d = q.shape
    tk = k.shape[1]
    enforce(q.dtype == k.dtype == v.dtype, "q, k, v dtypes differ: %s %s %s",
            q.dtype, k.dtype, v.dtype)
    enforce(tuple(k.shape) == (b, tk, n, d) and v.shape == k.shape,
            "k %s / v %s do not match q %s", tuple(k.shape), tuple(v.shape),
            tuple(q.shape))
    enforce(d in KERNEL_HEAD_DIMS, "head dim %d not in %s", d,
            KERNEL_HEAD_DIMS)
    enforce(0 < tq < 65536 and 0 < tk < 65536,
            "sequence lengths must lie in [1, 65536), got %d / %d", tq, tk)
    enforce(b * n <= 65535, "B * N = %d exceeds 65535", b * n)
    for name, t in (("q", q), ("k", k), ("v", v)):
        enforce(t.is_cuda, "%s must be a CUDA tensor, got device %s", name,
                t.device)
    enforce(q.device == k.device == v.device, "q, k, v must share a device")
    if mask is not None:
        enforce(mask.device == q.device, "mask must lie on %s", q.device)
        enforce(mask.numel() == b * tk and mask.shape[-1] == tk,
                "mask of shape %s does not broadcast from [B, Tk] = [%d, %d]",
                tuple(mask.shape), b, tk)


def _strides(*tensors):
    """21 int64 strides, (batch, time, head) per slot: q, k, v, dout,
    o/dq, dk, dv (None leaves a slot 0)."""
    vals = []
    for t in tensors:
        vals.extend((t.stride(0), t.stride(1), t.stride(2)) if t is not None
                    else (0, 0, 0))
    vals.extend([0] * (21 - len(vals)))
    return (ctypes.c_longlong * 21)(*vals)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _tail(q, cfg):
    causal, sm_scale, dropout, seed = cfg
    thresh = keep_threshold(dropout) if dropout > 0.0 else 0
    keep_scale = float(np.float32(1.0 / (1.0 - dropout)))
    return (float(sm_scale), int(causal), int(dropout > 0.0), int(seed or 0),
            thresh, keep_scale, _stream(q.device))


def _shape_args(q, k):
    b, tq, n, d = q.shape
    return (b, n, tq, k.shape[1], d)


def _attention_flops(q, k, cfg):
    """Forward operations of one attention (QK^T and PV), halved for
    causal: the count PERF.md's bounds use."""
    b, tq, n, d = q.shape
    f = 4.0 * b * n * tq * k.shape[1] * d
    return f / 2 if cfg[0] else f


def _launch(name, flops, *args):
    from paddle_tpu_torch.ops.kernels import _build
    _raise_on(getattr(_build.load_library(), "ptt_" + name)(*args), name)
    launch_counts[name] += 1
    _profile.note_kernel_flops(flops)


def _launch_fwd(q, k, v, bias, cfg):
    """The forward kernel of q's dtype: (o, lse [B, N, Tq] f32)."""
    b, tq, n, d = q.shape
    out = torch.empty((b, tq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, tq), dtype=torch.float32, device=q.device)
    _launch(KERNELS[q.dtype][0], _attention_flops(q, k, cfg),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            out.data_ptr(), lse.data_ptr(), *_shape_args(q, k),
            _strides(q, k, v, None, out), *_tail(q, cfg))
    return out, lse


def bwd_delta(out, dout, dlse=None):
    """delta [B, N, Tq] f32 = rowsum(dO * O) - dlse, as _bwd/_bwd1
    compute it before their kernels (the lse cotangent folds in here)."""
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _launch_bwd_tc(q, k, v, bias, dout, lse, delta, cfg, want_dbias):
    """The tensor-core backward of q's dtype: dQ, dK, dV and dbias from
    one launch. dQ is summed with atomics into a zeroed float32 workspace
    [B, Tq, N, D]: for float32 that workspace is dQ, for bfloat16 it is
    cast to q's dtype here. dbias [B, Tk] f32 (zeroed) only if
    `want_dbias`."""
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dbias = (torch.zeros((q.shape[0], k.shape[1]), dtype=torch.float32,
                         device=q.device) if want_dbias else None)
    # the backward's five products against the forward's two (dQ, dK, dV
    # and the recomputed S and dP): twice the forward's operations
    _launch(KERNELS[q.dtype][1][0], 2 * _attention_flops(q, k, cfg),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias),
            *_shape_args(q, k), _strides(q, k, v, dout, dq_acc, dk, dv),
            *_tail(q, cfg))
    return dq_acc.to(q.dtype), dk, dv, dbias


def _launch_bwd(q, k, v, bias, out, lse, dout, dlse, cfg, want_dbias):
    """The backward kernel of q's dtype: (dq, dk, dv, dbias or None)."""
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1 or not _aligned(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    delta = bwd_delta(out, dout, dlse)
    return _launch_bwd_tc(q, k, v, bias, dout, lse, delta, cfg, want_dbias)


class _FlashFn(torch.autograd.Function):
    """out, lse = kernels(q, k, v, mask); the backward launches the
    backward kernel of q's dtype. lse is returned as [B, Tq, N, 1]."""

    @staticmethod
    def forward(ctx, q, k, v, mask, cfg, mask_grad):
        b, _, n, _ = q.shape
        tk = k.shape[1]
        bias = (None if mask is None
                else mask.detach().to(torch.float32).reshape(b, tk).contiguous())
        out, lse = _launch_fwd(q, k, v, bias, cfg)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.cfg = cfg
        ctx.mask_meta = None if mask is None else (mask.shape, mask.dtype)
        ctx.mask_grad = bool(mask_grad) and mask is not None
        ctx.set_materialize_grads(False)
        return out, lse.permute(0, 2, 1)[..., None]

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        if dlse is not None:
            dlse = dlse[..., 0].permute(0, 2, 1)           # [B, N, Tq]
        dq, dk, dv, dbias = _launch_bwd(q, k, v, bias, out, lse, dout, dlse,
                                        ctx.cfg, ctx.mask_grad)
        dmask = None
        if ctx.mask_meta is not None and ctx.needs_input_grad[3]:
            shape, dtype = ctx.mask_meta
            dmask = (dbias.reshape(shape).to(dtype) if dbias is not None
                     else torch.zeros(shape, dtype=dtype, device=q.device))
        return dq, dk, dv, dmask, None, None


def _plain(q, k, v, mask, cfg, mask_grad, want_lse):
    causal, sm_scale, dropout, seed = cfg
    keep = None
    if dropout > 0.0:
        b, tq, n, _ = q.shape
        keep = batch_keep_masks(seed, b, n, tq, k.shape[1], dropout,
                                device=q.device)
    if mask is not None and not mask_grad:
        mask = mask.detach()
    return attention_reference(q, k, v, mask, causal, sm_scale, keep,
                               return_lse=want_lse)


def _resolve(q, sm_scale, causal, dropout_rate, dropout_seed):
    dropout_rate = float(dropout_rate)
    if dropout_rate >= 1.0 or dropout_rate < 0.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    seed = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        seed = int(dropout_seed)
        if not 0 <= seed < SEED_LIMIT:
            raise ValueError(f"dropout_seed must lie in [0, 2**23), got {seed}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return (bool(causal), float(sm_scale), dropout_rate, seed)


def flash_attention(q, k, v, mask=None, causal=False, sm_scale=None,
                    block_q=None, block_k=None, dropout_rate=0.0,
                    dropout_seed=None, mask_grad=False):
    """Streaming attention with optional in-kernel dropout.

    q [B, Tq, N, D], k/v [B, Tk, N, D] (views with any batch/time/head
    strides, e.g. of a fused QKV projection); mask: additive key bias
    [B, Tk] or [B, 1, 1, Tk]; dropout_seed: integer in [0, 2**23),
    required when dropout_rate > 0; mask_grad: differentiate the mask
    (dbias summed over heads and queries). Returns [B, Tq, N, D] in q's
    dtype."""
    cfg = _resolve(q, sm_scale, causal, dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        return _plain(q, k, v, mask, cfg, mask_grad, False)
    _check(q, k, v, mask)
    return _FlashFn.apply(q, k, v, mask, cfg, mask_grad)[0]


def flash_attention_lse(q, k, v, mask=None, causal=False, sm_scale=None,
                        block_q=None, block_k=None):
    """flash_attention that also returns the per-row log-sum-exp
    [B, Tq, N, 1] f32; gradients flow through both outputs (the lse
    cotangent folds into delta). No dropout, as in the JAX package."""
    cfg = _resolve(q, sm_scale, causal, 0.0, None)
    if q.device.type == "cpu":
        return _plain(q, k, v, mask, cfg, False, True)
    _check(q, k, v, mask)
    return _FlashFn.apply(q, k, v, mask, cfg, False)
