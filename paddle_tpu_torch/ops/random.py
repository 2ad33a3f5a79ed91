"""Random / initializer ops.

Counterpart of paddle_tpu/ops/random.py: `gaussian_random`,
`uniform_random`, `truncated_gaussian_random` (mean + std N(0, 1)
truncated to [-2, 2], as jax.random.truncated_normal(-2, 2)), `randint`,
`shuffle_batch`, `sampling_id` and `multinomial`. Each op draws from its own `torch.Generator`: seeded from the op's `seed` attr
when it is non-zero (the reference's per-op seed), else from the run's
seed and the op index (`OpContext.rng`), so a startup program initializes
reproducibly from `program.random_seed`. The numbers differ from the JAX
package's (`jax.random` is not `torch.Generator`).
"""
import math

import torch

from paddle_tpu_torch.core.dtypes import device_dtype
from paddle_tpu_torch.core.registry import register_op


def _op_generator(ctx):
    seed = ctx.attr("seed", 0)
    if seed:
        return torch.Generator(device=ctx.device).manual_seed(int(seed))
    return ctx.rng()


@register_op("gaussian_random", inputs=[], outputs=["Out"])
def _gaussian_random(ctx):
    dtype = device_dtype(ctx.attr("dtype", "float32"))
    noise = torch.randn(tuple(ctx.attr("shape")), generator=_op_generator(ctx),
                        dtype=torch.float32, device=ctx.device)
    return (ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * noise).to(dtype)


@register_op("uniform_random", inputs=[], outputs=["Out"])
def _uniform_random(ctx):
    dtype = device_dtype(ctx.attr("dtype", "float32"))
    out = torch.empty(tuple(ctx.attr("shape")), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                 generator=_op_generator(ctx))
    return out.to(dtype)


@register_op("truncated_gaussian_random", inputs=[], outputs=["Out"])
def _truncated_gaussian_random(ctx):
    """Inverse-CDF sampling of N(0, 1) on [-2, 2], then mean + std x."""
    dtype = device_dtype(ctx.attr("dtype", "float32"))
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = torch.empty(tuple(ctx.attr("shape")), dtype=torch.float32,
                    device=ctx.device)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=_op_generator(ctx))
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -2.0, 2.0)
    return (ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * z).to(dtype)


@register_op("randint", inputs=[], outputs=["Out"])
def _randint(ctx):
    return torch.randint(ctx.attr("low", 0), ctx.attr("high"),
                         tuple(ctx.attr("shape")),
                         generator=_op_generator(ctx),
                         dtype=device_dtype(ctx.attr("dtype", "int64")),
                         device=ctx.device)


@register_op("shuffle_batch", inputs=["X"], outputs=["Out"])
def _shuffle_batch(ctx, x):
    perm = torch.randperm(int(x.shape[0]), generator=_op_generator(ctx),
                          device=x.device)
    return x[perm]


def _categorical(ctx, x, n):
    """n draws per row of the probability rows of x (the last dim), with
    replacement: [..., n] int64."""
    probs = x.reshape(-1, int(x.shape[-1])).float() + 1e-20
    s = torch.multinomial(probs, n, replacement=True,
                          generator=_op_generator(ctx))
    return s.reshape(tuple(x.shape[:-1]) + (n,))


@register_op("sampling_id", inputs=["X"], outputs=["Out"])
def _sampling_id(ctx, x):
    """sampling_id_op.cc: one category per row of a probability
    matrix."""
    return _categorical(ctx, x, 1).squeeze(-1)


@register_op("multinomial", inputs=["X"], outputs=["Out"])
def _multinomial(ctx, x):
    return _categorical(ctx, x, ctx.attr("num_samples", 1))
