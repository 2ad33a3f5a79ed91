"""Math ops: elementwise, activations, reductions, compare and logic,
matmul, cast, sorting.

Counterpart of paddle_tpu/ops/math.py (the reference's
operators/elementwise/, activation_op, reduce_ops/, compare_op,
logical_op, matmul_op, mul_op, cast_op, cumsum_op, arg_max/arg_min,
argsort, top_k), every op type of it under the JAX package's type and
slot names. The binary elementwise and compare ops align Y to X with
Fluid's mid-axis broadcast for every `axis`. `mod` and `floordiv`
follow the sign of the divisor, as jnp.mod and jnp.floor_divide do;
`round` rounds half to even, as jnp.round does; `argsort` is a stable
sort (descending: the ascending order reversed, as in the JAX package).
Index outputs are int64. f32 matmuls run in f32 (the port sets no
global TF32 flag).
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import device_dtype
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
_register_binary("elementwise_min", torch.minimum)
_register_binary("elementwise_max", torch.maximum)
_register_binary("elementwise_mod", torch.remainder)
_register_binary("elementwise_pow", torch.pow)
_register_binary("elementwise_floordiv", torch.floor_divide)


@register_op("scale", inputs=["X"], outputs=["Out"])
def _scale(ctx, x):
    """scale_op.cc: scale * x + bias, or scale * (x + bias)."""
    scale = ctx.attr("scale", 1.0)
    bias = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return x * scale + bias
    return (x + bias) * scale


@register_op("sum", inputs=["X[]"], outputs=["Out"])
def _sum(ctx, xs):
    """sum_op.cc (add_n): elementwise sum of N tensors, left to right."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def _prod(t):
    p = 1
    for d in t:
        p *= int(d)
    return p


@register_op("matmul", inputs=["X", "Y"], outputs=["Out"])
def _matmul(ctx, x, y):
    """matmul_op.cc: transpose_X / transpose_Y, then alpha; batch dims
    broadcast."""
    if ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    return out if alpha == 1.0 else out * alpha


@register_op("matmul_v2", inputs=["X", "Y"], outputs=["Out"])
def _matmul_v2(ctx, x, y):
    if ctx.attr("trans_x", False):
        x = x.transpose(-1, -2)
    if ctx.attr("trans_y", False):
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


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


# --- activations (activation_op.cc) ---

def _register_unary(name, fn):
    @register_op(name, inputs=["X"], outputs=["Out"])
    def _impl(ctx, x, _fn=fn):
        return _fn(x)


def clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi), so a value on a bound takes
    half the gradient, as under JAX (torch.clamp passes all of it)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def abs_(x):
    """jnp.abs, whose derivative at 0 is 1 (torch.abs's is 0)."""
    return torch.where(x >= 0, x, -x)


def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) = logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


_register_unary("relu", lambda x: torch.maximum(x, x.new_zeros(())))
_register_unary("sigmoid", torch.sigmoid)
_register_unary("tanh", torch.tanh)
_register_unary("exp", torch.exp)
_register_unary("log", torch.log)
_register_unary("sqrt", torch.sqrt)
_register_unary("rsqrt", torch.rsqrt)
_register_unary("square", torch.square)
_register_unary("abs", abs_)
_register_unary("ceil", torch.ceil)
_register_unary("floor", torch.floor)
_register_unary("round", torch.round)
_register_unary("reciprocal", torch.reciprocal)
_register_unary("softsign", lambda x: x / (1 + torch.abs(x)))
_register_unary("sin", torch.sin)
_register_unary("cos", torch.cos)
_register_unary("erf", torch.erf)
_register_unary("softplus", _softplus)
_register_unary("sign", torch.sign)


@register_op("gelu", inputs=["X"], outputs=["Out"])
def _gelu(ctx, x):
    return F.gelu(x, approximate="tanh" if ctx.attr("approximate", False)
                  else "none")


@register_op("leaky_relu", inputs=["X"], outputs=["Out"])
def _leaky_relu(ctx, x):
    """jax.nn.leaky_relu: x where x >= 0, else alpha x."""
    return torch.where(x >= 0, x, ctx.attr("alpha", 0.02) * x)


@register_op("elu", inputs=["X"], outputs=["Out"])
def _elu(ctx, x):
    """jax.nn.elu: x where x > 0, else alpha (exp(x) - 1)."""
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, ctx.attr("alpha", 1.0) * torch.expm1(safe))


@register_op("relu6", inputs=["X"], outputs=["Out"])
def _relu6(ctx, x):
    return clip(x, 0.0, ctx.attr("threshold", 6.0))


@register_op("swish", inputs=["X"], outputs=["Out"])
def _swish(ctx, x):
    return x * torch.sigmoid(ctx.attr("beta", 1.0) * x)


@register_op("hard_sigmoid", inputs=["X"], outputs=["Out"])
def _hard_sigmoid(ctx, x):
    return clip(ctx.attr("slope", 0.2) * x + ctx.attr("offset", 0.5),
                0.0, 1.0)


@register_op("hard_swish", inputs=["X"], outputs=["Out"])
def _hard_swish(ctx, x):
    t, s, o = (ctx.attr("threshold", 6.0), ctx.attr("scale", 6.0),
               ctx.attr("offset", 3.0))
    return x * clip(x + o, 0.0, t) / s


@register_op("pow", inputs=["X"], outputs=["Out"])
def _pow(ctx, x):
    return torch.pow(x, ctx.attr("factor", 1.0))


@register_op("clip", inputs=["X"], outputs=["Out"])
def _clip(ctx, x):
    return clip(x, ctx.attr("min"), ctx.attr("max"))


@register_op("logsigmoid", inputs=["X"], outputs=["Out"])
def _logsigmoid(ctx, x):
    return F.logsigmoid(x)


# --- reductions (operators/reduce_ops/) ---

def _reduce_dims(ctx, x):
    dim = ctx.attr("dim", None)
    if ctx.attr("reduce_all", False) or dim is None:
        return tuple(range(x.dim()))
    return tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)


def _prod_over(x, dim, keepdim):
    """torch.prod reduces one dim a call: the highest first."""
    for d in sorted({_d % max(x.dim(), 1) for _d in dim}, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _register_reduce(name, fn):
    @register_op(name, inputs=["X"], outputs=["Out"])
    def _impl(ctx, x, _fn=fn):
        return _fn(x, _reduce_dims(ctx, x), ctx.attr("keep_dim", False))


_register_reduce("reduce_sum", lambda x, d, k: torch.sum(x, dim=d,
                                                          keepdim=k))
_register_reduce("reduce_mean", lambda x, d, k: torch.mean(x, dim=d,
                                                           keepdim=k))
_register_reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d,
                                                          keepdim=k))
_register_reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d,
                                                          keepdim=k))
_register_reduce("reduce_prod", _prod_over)
_register_reduce("reduce_all", lambda x, d, k: torch.all(x.bool(), dim=d,
                                                         keepdim=k))
_register_reduce("reduce_any", lambda x, d, k: torch.any(x.bool(), dim=d,
                                                         keepdim=k))


@register_op("mean", inputs=["X"], outputs=["Out"])
def _mean(ctx, x):
    """mean_op.cc: full reduction to a scalar."""
    return torch.mean(x)


@register_op("squared_l2_norm", inputs=["X"], outputs=["Out"])
def _squared_l2_norm(ctx, x):
    return torch.sum(torch.square(x)).reshape((1,))


@register_op("frobenius_norm", inputs=["X"], outputs=["Out"])
def _frobenius_norm(ctx, x):
    return torch.sqrt(torch.sum(torch.square(x)))


# --- comparisons & logic (compare_op.cc, logical_op.cc) ---

def _register_compare(name, fn):
    @register_op(name, inputs=["X", "Y"], outputs=["Out"])
    def _impl(ctx, x, y, _fn=fn):
        return _fn(x, _broadcast_y(x, y, ctx.attr("axis", -1)))


_register_compare("equal", torch.eq)
_register_compare("not_equal", torch.ne)
_register_compare("less_than", torch.lt)
_register_compare("less_equal", torch.le)
_register_compare("greater_than", torch.gt)
_register_compare("greater_equal", torch.ge)
_register_compare("logical_and", torch.logical_and)
_register_compare("logical_or", torch.logical_or)
_register_compare("logical_xor", torch.logical_xor)


@register_op("logical_not", inputs=["X"], outputs=["Out"])
def _logical_not(ctx, x):
    return torch.logical_not(x)


@register_op("isfinite", inputs=["X"], outputs=["Out"])
def _isfinite(ctx, x):
    """isfinite_op.cc — the FLAGS_check_nan_inf building block."""
    return torch.all(torch.isfinite(x)).reshape((1,))


# --- misc math ---

@register_op("cast", inputs=["X"], outputs=["Out"])
def _cast(ctx, x):
    return x.to(device_dtype(ctx.attr("out_dtype")))


@register_op("cumsum", inputs=["X"], outputs=["Out"])
def _cumsum(ctx, x):
    ax = ctx.attr("axis", -1)
    if ctx.attr("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (ax,)), dim=ax), (ax,))
    else:
        out = torch.cumsum(x, dim=ax)
    if ctx.attr("exclusive", False):
        out = out - x
    return out


@register_op("log_softmax", inputs=["X"], outputs=["Out"])
def _log_softmax(ctx, x):
    return torch.log_softmax(x, dim=ctx.attr("axis", -1))


@register_op("softmax", inputs=["X"], outputs=["Out"])
def _softmax(ctx, x):
    return torch.softmax(x, dim=ctx.attr("axis", -1))


@register_op("maximum_with_index", inputs=["X"], outputs=["Out", "Index"])
def _maximum_with_index(ctx, x):
    ax = ctx.attr("axis", -1)
    return torch.amax(x, dim=ax), torch.argmax(x, dim=ax)


@register_op("arg_max", inputs=["X"], outputs=["Out"])
def _arg_max(ctx, x):
    return torch.argmax(x, dim=ctx.attr("axis", -1))


@register_op("arg_min", inputs=["X"], outputs=["Out"])
def _arg_min(ctx, x):
    return torch.argmin(x, dim=ctx.attr("axis", -1))


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"])
def _top_k(ctx, x):
    """top_k_op.cc: the k largest along the last dim, sorted, with int64
    indices; equal values in ascending index order (`top_k_lowest_index`)."""
    return top_k_lowest_index(x, ctx.attr("k", 1))


def top_k_lowest_index(x, k):
    """(values, indices) of the k largest entries along x's last dim,
    equal values in ascending index order, as `lax.top_k` orders them: a
    stable descending sort (`torch.topk` promises no order among equal
    values on CUDA)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("argsort", inputs=["X"], outputs=["Out", "Indices"])
def _argsort(ctx, x):
    """argsort_op.cc: full sort along axis, ascending by default."""
    axis = ctx.attr("axis", -1)
    vals, idx = torch.sort(x, dim=axis, stable=True)
    if ctx.attr("descending", False):
        idx = torch.flip(idx, (axis,))
        vals = torch.flip(vals, (axis,))
    return vals, idx
