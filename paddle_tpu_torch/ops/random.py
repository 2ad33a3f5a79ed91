"""Random / initializer ops.

Counterpart of paddle_tpu/ops/random.py for the startup programs of the
static serving slice: `gaussian_random` and `uniform_random`. Each op
draws from its own `torch.Generator`: seeded from the op's `seed` attr
when it is non-zero (the reference's per-op seed), else from the run's
seed and the op index (`OpContext.rng`), so a startup program initializes
reproducibly from `program.random_seed`. The numbers differ from the JAX
package's (`jax.random` is not `torch.Generator`).
"""
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
