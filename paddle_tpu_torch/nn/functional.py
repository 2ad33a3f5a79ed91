"""Functional NN ops for the eager layers and the models.

Counterpart of paddle_tpu/nn/functional.py for what the BERT slice needs:
`activation`, `add_bias`, `layer_norm`, `softmax_cross_entropy` and
`dropout`. Convolution, pooling, batch norm and group norm wait for the
model zoo.
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["add_bias", "activation", "layer_norm", "softmax_cross_entropy",
           "dropout"]


def add_bias(y, b):
    """y + b in y's dtype (an f32 master bias is cast to the activation
    dtype). The JAX package routes this bias's gradient through a
    ones-vector matmul: a workaround for how XLA fuses column
    reductions on the TPU. Autograd's sum is the same value."""
    return y + b.to(y.dtype)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "softmax": lambda v: torch.softmax(v, dim=-1),
    "leaky_relu": lambda v: F.leaky_relu(v, 0.01),
    "relu6": lambda v: torch.clamp(v, 0, 6),
    "swish": F.silu,
}


def activation(x, act):
    if act is None:
        return x
    enforce(act in _ACTIVATIONS, "unknown activation %r", act)
    return _ACTIVATIONS[act](x)


class _LayerNormAffine(torch.autograd.Function):
    """LayerNorm over the last axis with f32 statistics and a two-pass
    variance; the output and the saved x-hat are in x's dtype. The
    backward is the JAX package's hand-written VJP (`_ln_affine_bwd`):
    dx from f32 row means, dgamma/dbeta as column sums of dy*x-hat and
    dy with an f32 accumulator."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        xf = x.float()
        xc = xf - xf.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + epsilon)
        xhat = xc * rstd
        y = xhat * weight.float() + bias.float()
        ctx.save_for_backward(xhat.to(x.dtype), rstd, weight, bias)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, rstd, weight, bias = ctx.saved_tensors
        n = dy.shape[-1]
        dyf = dy.float()
        xhf = xhat.float()
        dxhat = dyf * weight.float()
        mean_dxhat = dxhat.mean(dim=-1, keepdim=True)
        mean_dxhat_xhat = (dxhat * xhf).mean(dim=-1, keepdim=True)
        dx = (rstd * (dxhat - mean_dxhat - xhf * mean_dxhat_xhat)).to(
            xhat.dtype)
        dy2 = dy.reshape(-1, n)
        z = dy2 * xhat.reshape(-1, n)          # in dy's dtype, as in JAX
        dgamma = z.float().sum(dim=0)
        dbeta = dy2.float().sum(dim=0)
        return dx, dgamma.to(weight.dtype), dbeta.to(bias.dtype), None


def layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing `weight.ndim` axes (1 without a
    weight), statistics in f32, result in x's dtype."""
    if (weight is not None and bias is not None and weight.dim() == 1
            and x.dim() >= 2):
        return _LayerNormAffine.apply(x, weight, bias, float(epsilon))
    norm_ndim = weight.dim() if weight is not None else 1
    dims = tuple(range(x.dim() - norm_ndim, x.dim()))
    xf = x.float()
    m = xf.mean(dim=dims, keepdim=True)
    v = ((xf - m) ** 2).mean(dim=dims, keepdim=True)
    y = (xf - m) * torch.rsqrt(v + epsilon)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def softmax_cross_entropy(logits, labels, axis=-1):
    """-log softmax(logits)[label] in f32 for int labels, with the class
    axis kept at size 1 as the JAX package returns it (a trailing label
    axis of size 1 is accepted)."""
    logp = torch.log_softmax(logits.float(), dim=axis)
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
