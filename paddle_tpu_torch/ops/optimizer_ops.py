"""Optimizer update ops.

Counterpart of paddle_tpu/ops/optimizer_ops.py for what static training
runs so far: `sgd`, `momentum` (with Nesterov) and `adam`, under the JAX
package's type and slot names. Each op returns new tensors: `ParamOut`
names `Param` and the accumulators' outputs name their inputs, so the
step rebinds them in its environment and writes nothing in place. The
arithmetic runs in float32 for every parameter dtype, in the JAX
package's order (float64 stays float64: `dtypes.at_least_f32`).
"""
import torch

from paddle_tpu_torch.core.dtypes import at_least_f32 as _f32
from paddle_tpu_torch.core.registry import register_op


def _lr(lr):
    return _f32(lr.reshape(()))


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"])
def _sgd(ctx, p, g, lr):
    return (_f32(p) - _lr(lr) * _f32(g)).to(p.dtype)


@register_op("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"])
def _momentum(ctx, p, g, v, lr):
    """momentum_op.cc: v' = mu v + g; p' = p - lr v' (Nesterov:
    p - lr (g + mu v'))."""
    mu = ctx.attr("mu", 0.9)
    g = _f32(g)
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = _f32(p) - _lr(lr) * (g + mu * v_new)
    else:
        p_new = _f32(p) - _lr(lr) * v_new
    return p_new.to(p.dtype), v_new


@register_op("adam",
             inputs=["Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
                     "Beta2Pow", "LearningRate"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"])
def _adam(ctx, p, g, m1, m2, b1p, b2p, lr):
    """adam_op.cc, bias-corrected through the beta powers, dense."""
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    gf = _f32(g)
    m1n = b1 * m1 + (1 - b1) * gf
    m2n = b2 * m2 + (1 - b2) * gf * gf
    lr_t = _lr(lr) * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    pn = _f32(p) - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return (pn.to(p.dtype), m1n, m2n, (b1p * b1).to(b1p.dtype),
            (b2p * b2).to(b2p.dtype))
