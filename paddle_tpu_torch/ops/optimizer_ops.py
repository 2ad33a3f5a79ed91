"""Optimizer update ops.

Counterpart of paddle_tpu/ops/optimizer_ops.py (the reference's
operators/optimizers/): `sgd`, `momentum` (with Nesterov),
`lars_momentum`, `adam`, `adamax`, `adagrad`, `decayed_adagrad`,
`adadelta`, `rmsprop` (centered too), `ftrl`, `lamb`, `dpsgd` and
`proximal_gd`, under the JAX package's type and slot names. Each op returns new tensors: `ParamOut`
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


@register_op("lars_momentum",
             inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"])
def _lars_momentum(ctx, p, g, v, lr):
    """lars_momentum_op.cc: layer-wise adaptive rate scaling."""
    mu = ctx.attr("mu", 0.9)
    coeff = ctx.attr("lars_coeff", 0.001)
    wd = ctx.attr("lars_weight_decay", 0.0005)
    eps = ctx.attr("epsilon", 0.0)
    pf, gf = _f32(p), _f32(g)
    pn = torch.sqrt(torch.sum(pf * pf))
    gn = torch.sqrt(torch.sum(gf * gf))
    local_lr = torch.where(pn > 0, _lr(lr) * coeff * pn / (gn + wd * pn + eps),
                           _lr(lr))
    v_new = mu * v + local_lr * (gf + wd * pf)
    return (pf - v_new).to(p.dtype), v_new


@register_op("adamax",
             inputs=["Param", "Grad", "Moment", "InfNorm", "Beta1Pow",
                     "LearningRate"],
             outputs=["ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"])
def _adamax(ctx, p, g, m, u, b1p, lr):
    """adamax_op.cc; beta1^t advances with each step."""
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    gf = _f32(g)
    mn = b1 * m + (1 - b1) * gf
    un = torch.maximum(b2 * u, torch.abs(gf))
    lr_t = _lr(lr) / (1 - b1p.reshape(()))
    pn = _f32(p) - lr_t * mn / (un + eps)
    return pn.to(p.dtype), mn, un, (b1p * b1).to(b1p.dtype)


@register_op("adagrad", inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"])
def _adagrad(ctx, p, g, m, lr):
    eps = ctx.attr("epsilon", 1e-6)
    gf = _f32(g)
    mn = m + gf * gf
    pn = _f32(p) - _lr(lr) * gf / (torch.sqrt(mn) + eps)
    return pn.to(p.dtype), mn


@register_op("decayed_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"])
def _decayed_adagrad(ctx, p, g, m, lr):
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    gf = _f32(g)
    mn = decay * m + (1 - decay) * gf * gf
    pn = _f32(p) - _lr(lr) * gf / (torch.sqrt(mn) + eps)
    return pn.to(p.dtype), mn


@register_op("adadelta",
             inputs=["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
             outputs=["ParamOut", "AvgSquaredGradOut",
                      "AvgSquaredUpdateOut"])
def _adadelta(ctx, p, g, ag, au):
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    gf = _f32(g)
    ag_n = rho * ag + (1 - rho) * gf * gf
    upd = -torch.sqrt((au + eps) / (ag_n + eps)) * gf
    au_n = rho * au + (1 - rho) * upd * upd
    return (_f32(p) + upd).to(p.dtype), ag_n, au_n


@register_op("rmsprop",
             inputs=["Param", "Grad", "MeanSquare", "MeanGrad", "Moment",
                     "LearningRate"],
             outputs=["ParamOut", "MeanSquareOut", "MeanGradOut",
                      "MomentOut"])
def _rmsprop(ctx, p, g, ms, mg, mom, lr):
    """rmsprop_op.cc; `centered` subtracts the squared mean gradient."""
    rho = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    mu = ctx.attr("momentum", 0.0)
    gf = _f32(g)
    ms_n = rho * ms + (1 - rho) * gf * gf
    if ctx.attr("centered", False):
        mg_n = rho * mg + (1 - rho) * gf
        denom = ms_n - mg_n * mg_n + eps
    else:
        mg_n = mg
        denom = ms_n + eps
    mom_n = mu * mom + _lr(lr) * gf * torch.rsqrt(denom)
    return (_f32(p) - mom_n).to(p.dtype), ms_n, mg_n, mom_n


@register_op("ftrl",
             inputs=["Param", "Grad", "SquaredAccumulator",
                     "LinearAccumulator", "LearningRate"],
             outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"])
def _ftrl(ctx, p, g, sq, lin, lr):
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    power = ctx.attr("lr_power", -0.5)
    gf, pf = _f32(g), _f32(p)
    new_sq = sq + gf * gf
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / _lr(lr)
    new_lin = lin + gf - sigma * pf
    x = l1 * torch.sign(new_lin) - new_lin
    y = torch.pow(new_sq, -power) / _lr(lr) + 2 * l2
    pn = torch.where(torch.abs(new_lin) > l1, x / y, torch.zeros_like(pf))
    return pn.to(p.dtype), new_sq, new_lin


@register_op("lamb",
             inputs=["Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
                     "Beta2Pow", "LearningRate"],
             outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                      "Beta2PowOut"])
def _lamb(ctx, p, g, m1, m2, b1p, b2p, lr):
    """lamb_op.cc: layer-adaptive Adam for large-batch training."""
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-6)
    wd = ctx.attr("weight_decay", 0.01)
    gf, pf = _f32(g), _f32(p)
    m1n = b1 * m1 + (1 - b1) * gf
    m2n = b2 * m2 + (1 - b2) * gf * gf
    m1h = m1n / (1 - b1p.reshape(()))
    m2h = m2n / (1 - b2p.reshape(()))
    r = m1h / (torch.sqrt(m2h) + eps) + wd * pf
    pn_norm = torch.sqrt(torch.sum(pf * pf))
    rn_norm = torch.sqrt(torch.sum(r * r))
    trust = torch.where((pn_norm > 0) & (rn_norm > 0), pn_norm / rn_norm,
                        torch.ones_like(pn_norm))
    pn = pf - _lr(lr) * trust * r
    return (pn.to(p.dtype), m1n, m2n, (b1p * b1).to(b1p.dtype),
            (b2p * b2).to(b2p.dtype))


@register_op("dpsgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"])
def _dpsgd(ctx, p, g, lr):
    """dpsgd_op.cc: differentially private SGD (clip + gaussian noise
    from the op's generator)."""
    clip = ctx.attr("clip", 10.0)
    batch_size = ctx.attr("batch_size", 16.0)
    sigma = ctx.attr("sigma", 1.0)
    gf = _f32(g)
    gnorm = torch.sqrt(torch.sum(gf * gf))
    gf = gf * torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    noise = sigma * clip * torch.randn(tuple(gf.shape), generator=ctx.rng(),
                                       dtype=gf.dtype, device=gf.device)
    return (_f32(p) - _lr(lr) * (gf + noise) / batch_size).to(p.dtype)


@register_op("proximal_gd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"])
def _proximal_gd(ctx, p, g, lr):
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    prox = _f32(p) - _lr(lr) * _f32(g)
    pn = (torch.sign(prox) * torch.clamp(torch.abs(prox) - _lr(lr) * l1,
                                         min=0.0) / (1.0 + _lr(lr) * l2))
    return pn.to(p.dtype)
