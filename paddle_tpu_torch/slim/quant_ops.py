"""Quantization operators.

Counterpart of paddle_tpu/slim/quant_ops.py: the reference's fake
quant-dequant ops (operators/fake_quantize_op.cc) that the slim passes
insert, and the int8 execution ops the freeze pass rewrites to.

* Fake quant-dequant trains through a clipped straight-through
  estimator built from `detach()` (the JAX package's stop_gradient).
* `quantized_mul` quantizes its activation at the static attr x_scale and
  runs kernel K8 (ops/kernels/quantized_matmul.py) on a CUDA tensor, its
  plain version on a CPU tensor.
* `quantized_conv2d` computes the exact int32 accumulator of the codes
  as the JAX package does with `lax.conv(..., preferred_element_type=
  int32)`: F.unfold of the float64 codes, then a float64 GEMM per group
  (exact: every partial sum is an integer below 2^53 for
  K < 2^53 / 127^2), converted to int32. It is a library computation,
  not a kernel of the port; float32 or TF32 would not be exact
  (ResNet-50's 3x3 layers reach K = 4608, and 4608 * 127^2 > 2^24).

Scale convention (the reference's): scale = abs max of the tensor;
q = round(x / scale * (2^(bits-1) - 1)), clipped to +-(2^(bits-1) - 1).
"""
import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.kernels import quantized_matmul as _k8

__all__ = ["quantize_weight", "quantized_conv2d_acc"]

_qmax = _k8.qmax


def _qdq(x, scale, bits):
    """quantize-dequantize at the given abs-max scale."""
    qm = _qmax(bits)
    s = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x / s * qm), -qm, qm)
    return q * s / qm


def _ste(x, scale, bits):
    """clipped straight-through estimator: forward = qdq(x), backward =
    identity inside [-scale, scale], zero outside."""
    s = torch.clamp_min(scale, 1e-8)
    clipped = torch.maximum(torch.minimum(x, s), -s)
    return clipped + (_qdq(x, scale, bits) - clipped).detach()


@register_op("fake_quantize_dequantize_abs_max", inputs=["X"],
             outputs=["Out", "OutScale"])
def _fake_qdq_abs_max(ctx, x):
    """Per-tensor abs-max fake quant, the scale recomputed from the
    tensor."""
    bits = ctx.attr("bit_length", 8)
    scale = x.abs().amax().detach()
    return _ste(x, scale, bits), scale.reshape(1)


@register_op("fake_channel_wise_quantize_dequantize_abs_max", inputs=["X"],
             outputs=["Out", "OutScale"])
def _fake_qdq_channel(ctx, x):
    """Per-output-channel abs-max fake quant along attr quant_axis."""
    bits = ctx.attr("bit_length", 8)
    axis = ctx.attr("quant_axis", 0)
    red = tuple(i for i in range(x.dim()) if i != axis)
    # a 1-D x keeps one scale per element: amax over dim=() would reduce
    # over every dim
    scale = (x.abs().amax(dim=red, keepdim=True) if red
             else x.abs()).detach()
    return _ste(x, scale, bits), scale.reshape(-1)


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             inputs=["X", "InScale"], outputs=["Out", "OutScale"])
def _fake_qdq_moving_avg(ctx, x, in_scale):
    """Activation fake quant with a moving-average abs-max scale state:
    updated in training (OutScale rebinds the persistable), used as it is
    at inference."""
    bits = ctx.attr("bit_length", 8)
    rate = ctx.attr("moving_rate", 0.9)
    scale = in_scale.reshape(())
    if ctx.training and not ctx.attr("is_test", False):
        cur = x.abs().amax().detach()
        # first-step bootstrap: the stored scale starts at 0
        scale = torch.where(scale <= 0.0, cur,
                            rate * scale + (1 - rate) * cur)
    return _ste(x, scale, bits), scale.reshape(1)


# ---- frozen int8 execution (the freeze pass rewrites to these) ----------

@register_op("quantized_mul", inputs=["X", "Y", "YScale"], outputs=["Out"])
def _quantized_mul(ctx, x, w_int8, w_scale):
    """int8 GEMM: x flattened to 2D at x_num_col_dims (-1: all leading
    dims), quantized at attr x_scale, times int8 weights with per-channel
    scales; K8 on the card."""
    bits = ctx.attr("bit_length", 8)
    x_scale = ctx.attr("x_scale", 1.0)
    xd = ctx.attr("x_num_col_dims", 1)
    if xd == -1:  # matmul mode: contract the last dim only
        xd = x.dim() - 1
    xs = tuple(x.shape)
    lead = 1
    for d in xs[:xd]:
        lead *= int(d)
    x2 = x.reshape(lead, -1).contiguous()
    out = torch.ops.paddle_tpu_torch.fused_dequant_matmul(
        x2, w_int8.contiguous(), w_scale.reshape(-1).contiguous(),
        float(x_scale), int(bits))
    return out.reshape(xs[:xd] + (int(w_int8.shape[1]),))


def quantized_conv2d_acc(xq, w_int8, strides, pads, dilations, groups):
    """The exact int32 accumulator of an int8 conv (NCHW codes, OIHW int8
    filter): F.unfold of the float64 codes and a float64 GEMM per group,
    converted to int32."""
    n, c, h, w = xq.shape
    o, cg, kh, kw = w_int8.shape
    oh = (h + 2 * pads[0] - dilations[0] * (kh - 1) - 1) // strides[0] + 1
    ow = (w + 2 * pads[1] - dilations[1] * (kw - 1) - 1) // strides[1] + 1
    cols = F.unfold(xq.to(torch.float64), (kh, kw), dilation=dilations,
                    padding=pads, stride=strides)      # [N, C*kh*kw, L]
    og = o // groups
    wf = w_int8.to(torch.float64).reshape(groups, og, cg * kh * kw)
    cols = cols.reshape(n, groups, cg * kh * kw, oh * ow)
    acc = torch.matmul(wf.unsqueeze(0), cols)          # [N, G, og, L]
    return acc.reshape(n, o, oh, ow).to(torch.int32)


@register_op("quantized_conv2d", inputs=["Input", "Filter", "FilterScale",
                                         "Bias?"],
             outputs=["Output"])
def _quantized_conv2d(ctx, x, w_int8, w_scale, bias):
    """int8 conv (NCHW/OIHW): activation quantized at attr x_scale,
    per-output-channel weight scales, exact int32 accumulation, the JAX
    rescale order, then the bias."""
    bits = ctx.attr("bit_length", 8)
    x_scale = ctx.attr("x_scale", 1.0)
    xq = _k8.quantize_activation(x, x_scale, bits)
    acc = quantized_conv2d_acc(
        xq, w_int8, tuple(ctx.attr("strides", [1, 1])),
        tuple(ctx.attr("paddings", [0, 0])),
        tuple(ctx.attr("dilations", [1, 1])), ctx.attr("groups", 1))
    out = _k8.int8_rescale(acc, x_scale, w_scale.reshape(-1), bits)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def quantize_weight(w, bits=8, channel_axis=None):
    """Host-side weight quantization for the freeze pass. Returns
    (int8 array, float32 scale array)."""
    qm = _qmax(bits)
    w = np.asarray(w, np.float32)
    if channel_axis is None:
        scale = np.maximum(np.max(np.abs(w)), 1e-8)
        q = np.clip(np.round(w / scale * qm), -qm, qm).astype(np.int8)
        return q, np.asarray([scale], np.float32)
    red = tuple(i for i in range(w.ndim) if i != channel_axis)
    scale = np.maximum(np.max(np.abs(w), axis=red, keepdims=True), 1e-8)
    q = np.clip(np.round(w / scale * qm), -qm, qm).astype(np.int8)
    return q, scale.reshape(-1).astype(np.float32)
