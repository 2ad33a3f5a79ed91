"""Math ops: elementwise, activations, reductions, matmul.

Counterpart of paddle_tpu/ops/math.py for what the static serving slice
runs: `relu`, `elementwise_add` (Fluid's mid-axis broadcast) and the
rest of the elementwise family the Variable operators reach, `scale`,
`mul`, `reduce_mean`, `mean`, `softmax`, `top_k`, and `reciprocal` /
`pow` (the Variable operators' scalar forms). f32
matmuls run in f32 (the port sets no global TF32 flag).
"""
import torch

from paddle_tpu_torch.core.registry import register_op


def _broadcast_y(x, y, axis):
    """Fluid's mid-axis broadcast (elementwise_op_function.h:77): y's
    shape aligns to x starting at `axis`; -1 means numpy-style trailing
    alignment."""
    if axis is None or axis == -1 or y.dim() == 0 or x.dim() == y.dim():
        return y
    pad = x.dim() - axis - y.dim()
    return y.reshape(tuple(y.shape) + (1,) * pad)


def _register_binary(name, fn):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"])
    def _impl(ctx, x, y, _fn=fn):
        return _fn(x, _broadcast_y(x, y, ctx.attr("axis", -1)))


_register_binary("elementwise_add", torch.add)
_register_binary("elementwise_sub", torch.sub)
_register_binary("elementwise_mul", torch.mul)
_register_binary("elementwise_div", torch.div)
_register_binary("elementwise_pow", torch.pow)


@register_op("scale", inputs=["X"], outputs=["Out"])
def _scale(ctx, x):
    """scale_op.cc: scale * x + bias, or scale * (x + bias)."""
    scale = ctx.attr("scale", 1.0)
    bias = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return x * scale + bias
    return (x + bias) * scale


def _prod(t):
    p = 1
    for d in t:
        p *= int(d)
    return p


@register_op("mul", inputs=["X", "Y"], outputs=["Out"])
def _mul(ctx, x, y):
    """mul_op.cc: flatten x to 2D at x_num_col_dims and y at
    y_num_col_dims, then one GEMM — the primitive under fluid.layers.fc."""
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(_prod(xs[:xd]), _prod(xs[xd:]))
    y2 = y.reshape(_prod(ys[:yd]), _prod(ys[yd:]))
    return torch.matmul(x2, y2).reshape(xs[:xd] + ys[yd:])


@register_op("relu", inputs=["X"], outputs=["Out"])
def _relu(ctx, x):
    return torch.relu(x)


@register_op("reciprocal", inputs=["X"], outputs=["Out"])
def _reciprocal(ctx, x):
    return torch.reciprocal(x)


@register_op("pow", inputs=["X"], outputs=["Out"])
def _pow(ctx, x):
    return torch.pow(x, ctx.attr("factor", 1.0))


def _register_reduce(name, fn):
    @register_op(name, inputs=["X"], outputs=["Out"])
    def _impl(ctx, x, _fn=fn):
        dim = ctx.attr("dim", None)
        keep = ctx.attr("keep_dim", False)
        if ctx.attr("reduce_all", False) or dim is None:
            dim = tuple(range(x.dim()))
        else:
            dim = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        return _fn(x, dim=dim, keepdim=keep)


_register_reduce("reduce_mean", torch.mean)


@register_op("mean", inputs=["X"], outputs=["Out"])
def _mean(ctx, x):
    """mean_op.cc: full reduction to a scalar."""
    return torch.mean(x)


@register_op("softmax", inputs=["X"], outputs=["Out"])
def _softmax(ctx, x):
    return torch.softmax(x, dim=ctx.attr("axis", -1))


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"])
def _top_k(ctx, x):
    """top_k_op.cc: the k largest along the last dim, sorted, with int64
    indices."""
    vals, idx = torch.topk(x, ctx.attr("k", 1), dim=-1)
    return vals, idx
