"""Functional NN ops for the eager layers and the models.

Counterpart of paddle_tpu/nn/functional.py: `activation`, `add_bias`,
`conv2d`, `conv2d_transpose`, `pool2d`, `batch_norm`, `layer_norm`,
`group_norm`, `softmax_cross_entropy` and `dropout`, with the JAX
package's layouts and arithmetic. Where PyTorch's defaults differ:

* `conv2d(data_format="NHWC")` takes [N, H, W, C] activations and HWIO
  filters. They reach the convolution as channels-last views of NCHW /
  OIHW tensors, so no transposed copy of the activations is made.
* `conv2d_transpose` takes the IOHW filter, with the gradient-of-conv
  output size (H-1)*stride - 2*pad + (k-1)*dilation + 1.
* `pool2d` pads explicitly: max with -inf, average with zeros and a
  divisor of the full window, padding included (any padding, where
  PyTorch's pools take at most half the window).
* `batch_norm` takes its statistics in f32 (float64 stays float64) with
  the biased batch variance and returns the running statistics
  `momentum * running + (1 - momentum) * batch` for the caller to keep;
  `torch.nn.functional.batch_norm` would update them in place, with the
  unbiased variance and the opposite sense of momentum.
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.core.enforce import enforce

__all__ = ["add_bias", "activation", "relu", "conv2d", "conv2d_transpose",
           "pool2d", "batch_norm", "layer_norm", "group_norm",
           "softmax_cross_entropy", "dropout"]


def add_bias(y, b):
    """y + b in y's dtype (an f32 master bias is cast to the activation
    dtype). The JAX package routes this bias's gradient through a
    ones-vector matmul: a workaround for how XLA fuses column
    reductions on the TPU. Autograd's sum is the same value."""
    return y + b.to(y.dtype)


def _relu(v):
    # jnp.maximum's derivative: 1/2 where v is exactly 0 (a batch norm
    # over a channel that is constant in the batch gives such zeros);
    # torch.relu's is 0 there
    return torch.maximum(v, v.new_zeros(()))


_ACTIVATIONS = {
    "relu": _relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "softmax": lambda v: torch.softmax(v, dim=-1),
    "leaky_relu": lambda v: F.leaky_relu(v, 0.01),
    "relu6": lambda v: torch.minimum(_relu(v), v.new_full((), 6)),
    "swish": F.silu,
}


def relu(x):
    """max(x, 0) with the JAX package's derivative (1/2 at exactly 0)."""
    return _relu(x)


def activation(x, act):
    if act is None:
        return x
    enforce(act in _ACTIVATIONS, "unknown activation %r", act)
    return _ACTIVATIONS[act](x)


def _nchw(x, data_format):
    """An NCHW view of x: NHWC activations become a channels-last view."""
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d(x, w, bias=None, stride=(1, 1), padding=(0, 0), dilation=(1, 1),
           groups=1, data_format="NCHW"):
    """2-D convolution with symmetric padding. NCHW: x [N, C, H, W], w
    OIHW; NHWC: x [N, H, W, C], w HWIO. The filter is cast to x's dtype
    and the bias added in the result's dtype."""
    if data_format == "NHWC":
        w = w.permute(3, 2, 0, 1)                  # HWIO -> OIHW view
    y = F.conv2d(_nchw(x, data_format), w.to(x.dtype), None, tuple(stride),
                 tuple(padding), tuple(dilation), groups)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1)
    return _from_nchw(y, data_format)


def conv2d_transpose(x, w, bias=None, stride=(1, 1), padding=(0, 0),
                     dilation=(1, 1)):
    """The gradient of a convolution (fluid conv_transpose_op.cc), NCHW,
    filter IOHW: output size (H-1)*stride - 2*pad + (k-1)*dilation + 1."""
    y = F.conv_transpose2d(x, w.to(x.dtype), None, tuple(stride),
                           tuple(padding), 0, 1, tuple(dilation))
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1)
    return y


def pool2d(x, ksize, pool_type="max", stride=None, padding=(0, 0),
           global_pooling=False, data_format="NCHW"):
    """Max or average pooling over the layout's spatial axes. Max pads
    with -inf; average pads with zeros and divides by the full window,
    padding included. `global_pooling` takes the whole spatial extent."""
    xc = _nchw(x, data_format)
    if global_pooling:
        ksize, stride, padding = tuple(xc.shape[2:]), (1, 1), (0, 0)
    ksize = tuple(ksize)
    stride = tuple(stride or ksize)
    ph, pw = padding
    enforce(pool_type in ("max", "avg"), "pool_type must be 'max' or 'avg', "
            "got %r", pool_type)
    if ph or pw:
        fill = float("-inf") if pool_type == "max" else 0.0
        xc = F.pad(xc, (pw, pw, ph, ph), value=fill)
    if pool_type == "max":
        y = F.max_pool2d(xc, ksize, stride)
    else:
        y = F.avg_pool2d(xc, ksize, stride)
    return _from_nchw(y, data_format)


def batch_norm(x, scale, bias, mean, var, momentum=0.9, epsilon=1e-5,
               training=True, data_format="NCHW"):
    """-> (y, new_mean, new_var). Training normalises with the batch
    statistics (f32, biased variance) and returns the running statistics
    moved by `momentum`; evaluation uses `mean` / `var` and returns them
    as they are. y is in x's dtype."""
    ch = x.dim() - 1 if data_format == "NHWC" else 1
    dims = tuple(i for i in range(x.dim()) if i != ch)
    bshape = tuple(-1 if i == ch else 1 for i in range(x.dim()))
    xf = at_least_f32(x)
    if training:
        m = xf.mean(dim=dims)
        v = ((xf - m.reshape(bshape)) ** 2).mean(dim=dims)
        with torch.no_grad():
            new_mean = momentum * mean + (1 - momentum) * m.detach()
            new_var = momentum * var + (1 - momentum) * v.detach()
    else:
        m, v = mean, var
        new_mean, new_var = mean, var
    y = (xf - m.reshape(bshape)) * torch.rsqrt(
        at_least_f32(v).reshape(bshape) + epsilon)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return y.to(x.dtype), new_mean, new_var


class _LayerNormAffine(torch.autograd.Function):
    """LayerNorm over the last axis with f32 statistics (float64 stays
    float64) and a two-pass variance; the output and the saved x-hat are
    in x's dtype. The backward is the JAX package's hand-written VJP
    (`_ln_affine_bwd`): dx from f32 row means, dgamma/dbeta as column
    sums of dy*x-hat and dy with an f32 accumulator."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        xf = at_least_f32(x)
        xc = xf - xf.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + epsilon)
        xhat = xc * rstd
        y = xhat * at_least_f32(weight) + at_least_f32(bias)
        ctx.save_for_backward(xhat.to(x.dtype), rstd, weight, bias)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, rstd, weight, bias = ctx.saved_tensors
        n = dy.shape[-1]
        dyf = at_least_f32(dy)
        xhf = at_least_f32(xhat)
        dxhat = dyf * at_least_f32(weight)
        mean_dxhat = dxhat.mean(dim=-1, keepdim=True)
        mean_dxhat_xhat = (dxhat * xhf).mean(dim=-1, keepdim=True)
        dx = (rstd * (dxhat - mean_dxhat - xhf * mean_dxhat_xhat)).to(
            xhat.dtype)
        dy2 = dy.reshape(-1, n)
        z = dy2 * xhat.reshape(-1, n)          # in dy's dtype, as in JAX
        dgamma = at_least_f32(z).sum(dim=0)
        dbeta = at_least_f32(dy2).sum(dim=0)
        return dx, dgamma.to(weight.dtype), dbeta.to(bias.dtype), None


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `weight.ndim` axes (1 without a
    weight), statistics in f32, result in x's dtype."""
    if (weight is not None and bias is not None and weight.dim() == 1
            and x.dim() >= 2):
        return _LayerNormAffine.apply(x, weight, bias, float(epsilon))
    norm_ndim = weight.dim() if weight is not None else 1
    dims = tuple(range(x.dim() - norm_ndim, x.dim()))
    xf = at_least_f32(x)
    m = xf.mean(dim=dims, keepdim=True)
    v = ((xf - m) ** 2).mean(dim=dims, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + epsilon)
    if weight is not None:
        y = y * at_least_f32(weight)
    if bias is not None:
        y = y + at_least_f32(bias)
    return y.to(x.dtype)


def group_norm(x, groups, weight=None, bias=None, epsilon=1e-5):
    """Normalise each of `groups` channel groups of [N, C, ...] over its
    channels and positions, statistics in f32; result in x's dtype."""
    n, c = x.shape[0], x.shape[1]
    xg = at_least_f32(x.reshape(n, groups, c // groups, *x.shape[2:]))
    dims = tuple(range(2, xg.dim()))
    m = xg.mean(dim=dims, keepdim=True)
    v = ((xg - m) ** 2).mean(dim=dims, keepdim=True)
    y = ((xg - m) * torch.rsqrt(v + epsilon)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y.to(x.dtype)


def softmax_cross_entropy(logits, labels, axis=-1):
    """-log softmax(logits)[label] in f32 for int labels, with the class
    axis kept at size 1 as the JAX package returns it (a trailing label
    axis of size 1 is accepted)."""
    logp = torch.log_softmax(at_least_f32(logits), dim=axis)
    lbl = labels
    if lbl.dim() == logits.dim() and lbl.shape[-1] == 1:
        lbl = lbl.reshape(lbl.shape[:-1])
    picked = torch.gather(logp, axis, lbl.long().unsqueeze(axis))
    return -picked


def dropout(x, p, generator, training=True):
    """Inverted dropout: keep with probability 1-p, scale kept values by
    1/(1-p), in x's dtype. `generator` is a `torch.Generator` on x's
    device; its draws differ from `jax.random`'s, so tests hold the
    keep rate, not the mask."""
    if not training or p == 0.0:
        return x
    enforce(generator is not None, "dropout with p > 0 needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)).to(x.dtype)
