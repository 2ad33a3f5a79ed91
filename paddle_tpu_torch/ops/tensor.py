"""Tensor-creation ops.

Counterpart of paddle_tpu/ops/tensor.py for what the static serving
slice runs: `fill_constant` (startup programs, Constant initializers).
The rest of the tensor family is a later slice.
"""
import torch

from paddle_tpu_torch.core.dtypes import device_dtype
from paddle_tpu_torch.core.registry import register_op


@register_op("fill_constant", inputs=[], outputs=["Out"])
def _fill_constant(ctx):
    return torch.full(tuple(ctx.attr("shape")), ctx.attr("value", 0.0),
                      dtype=device_dtype(ctx.attr("dtype", "float32")),
                      device=ctx.device)
