"""Neural-net ops: conv, pool, batch norm, softmax cross-entropy,
square error.

Counterpart of paddle_tpu/ops/nn.py for what the static serving slice
runs. NCHW activations and OIHW filters, as in the JAX package.
`conv2d` goes to `F.conv2d` (cuDNN on the card; a float32 conv there
runs in TF32 unless the caller turns `torch.backends.cudnn.allow_tf32`
off — the port sets no global flag). Pooling pads explicitly so that
`ceil_mode` and `exclusive` follow the JAX package's arithmetic rather
than PyTorch's own ceil rule.
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op

#: conv2d's `fuse_activation` attr (inference/optimize.py fuse_conv_act)
CONV_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": lambda t: torch.clamp(t, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


@register_op("conv2d", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"])
def _conv2d(ctx, x, w, bias):
    """conv_op.cc: NCHW input, OIHW filter, groups and dilation; then the
    bias and the fused activation, each as its own pass (the JAX order)."""
    out = F.conv2d(x, w, stride=_pair(ctx.attr("strides", [1, 1])),
                   padding=_pair(ctx.attr("paddings", [0, 0])),
                   dilation=_pair(ctx.attr("dilations", [1, 1])),
                   groups=ctx.attr("groups", 1))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    fact = ctx.attr("fuse_activation", "")
    if fact:
        out = CONV_ACTIVATIONS[fact](out)
    return out


def _ceil_extra(dim, k, s, p):
    """pool_op.cc ceil_mode: extra high-side padding so the last partial
    window is kept."""
    out = -(-(dim + 2 * p - k) // s) + 1
    return max((out - 1) * s + k - (dim + 2 * p), 0)


@register_op("pool2d", inputs=["X"], outputs=["Out"])
def _pool2d(ctx, x):
    """pool_op.cc: max / avg pooling, global_pooling, adaptive (divisible
    sizes), ceil_mode, and the exclusive average (padding not counted)."""
    ptype = ctx.attr("pooling_type", "max")
    ksize = _pair(ctx.attr("ksize", [2, 2]))
    strides = _pair(ctx.attr("strides", ksize))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    h, w = int(x.shape[2]), int(x.shape[3])
    if ctx.attr("global_pooling", False):
        ksize, strides, pads = (h, w), (1, 1), (0, 0)
    if ctx.attr("adaptive", False):
        oh, ow = ksize
        enforce(h % oh == 0 and w % ow == 0,
                "adaptive pool needs divisible sizes (got %s -> %s)",
                (h, w), (oh, ow))
        ksize = (h // oh, w // ow)
        strides, pads = ksize, (0, 0)
    extra = (0, 0)
    if ctx.attr("ceil_mode", False):
        extra = (_ceil_extra(h, ksize[0], strides[0], pads[0]),
                 _ceil_extra(w, ksize[1], strides[1], pads[1]))
    padding = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    padded = any(padding)
    if ptype == "max":
        if padded:
            x = F.pad(x, padding, value=float("-inf"))
        return F.max_pool2d(x, ksize, strides)
    xp = F.pad(x, padding) if padded else x
    s = F.avg_pool2d(xp, ksize, strides, divisor_override=1)   # window sums
    if ctx.attr("exclusive", True) and padded:
        ones = F.pad(torch.ones_like(x), padding)
        cnt = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        return s / cnt
    return s / (ksize[0] * ksize[1])


@register_op("batch_norm",
             inputs=["X", "Scale", "Bias", "Mean", "Variance"],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"])
def _batch_norm(ctx, x, scale, bias, mean, var):
    """batch_norm_op.cc. Training normalizes with the batch statistics and
    returns the updated running mean/variance (MeanOut/VarianceOut name
    the inputs); inference (is_test, use_global_stats, or not training)
    normalizes with the running statistics. Arithmetic in float32 (in
    float64 for a float64 x)."""
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    use_global = (ctx.attr("is_test", False)
                  or ctx.attr("use_global_stats", False) or not ctx.training)
    axes = tuple(i for i in range(x.dim()) if i != 1)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    xf = at_least_f32(x)
    if use_global:
        m, v = mean, var
        new_mean, new_var = mean, var
    else:
        m = xf.mean(dim=axes)
        v = xf.var(dim=axes, unbiased=False)
        new_mean = momentum * mean + (1 - momentum) * m.to(mean.dtype)
        new_var = momentum * var + (1 - momentum) * v.to(var.dtype)
    inv = torch.rsqrt(at_least_f32(v) + eps)
    y = (xf - m.reshape(bshape)) * inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return y.to(x.dtype), new_mean, new_var, at_least_f32(m), inv


@register_op("softmax_with_cross_entropy", inputs=["Logits", "Label"],
             outputs=["Softmax", "Loss"])
def _softmax_with_cross_entropy(ctx, logits, label):
    """softmax_with_cross_entropy_op.cc: log-softmax, then the picked
    log-probability (hard labels, ignore_index) or the soft-label sum."""
    axis = ctx.attr("axis", -1)
    axis = axis if axis >= 0 else logits.dim() + axis
    logp = torch.log_softmax(logits, dim=axis)
    sm = torch.exp(logp)
    if ctx.attr("soft_label", False):
        return sm, -(label * logp).sum(dim=axis, keepdim=True)
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.to(torch.int64)
    ignore = ctx.attr("ignore_index", -100)
    keep = lbl != ignore
    idx = torch.where(keep, lbl, torch.zeros_like(lbl)).unsqueeze(axis)
    picked = torch.gather(logp, axis, idx)
    loss = torch.where(keep.unsqueeze(axis), -picked,
                       torch.zeros_like(picked))
    return sm, loss


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def _square_error_cost(ctx, x, y):
    return torch.square(x - y)
