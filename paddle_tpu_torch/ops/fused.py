"""Fused ops.

Counterpart of paddle_tpu/ops/fused.py for `fc` (fc_op.cc), the op that
inference/optimize.py's fuse_fc makes of mul + elementwise_add [+ act].
The rest of the fused family is a later slice.
"""
import torch

from paddle_tpu_torch.core.registry import register_op

_FC_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda t: torch.softmax(t, dim=-1),
}


@register_op("fc", inputs=["Input", "W", "Bias?"], outputs=["Out"])
def _fc(ctx, x, w, bias):
    """x flattened to 2D at in_num_col_dims, one GEMM, then the bias and
    the activation, each as its own pass (the JAX order)."""
    nd = ctx.attr("in_num_col_dims", 1)
    xs = tuple(x.shape)
    m = 1
    for d in xs[:nd]:
        m *= int(d)
    out = torch.matmul(x.reshape(m, -1), w)
    if bias is not None:
        out = out + bias.reshape(-1)
    act = ctx.attr("activation", "")
    if act:
        out = _FC_ACTIVATIONS[act](out)
    return out.reshape(xs[:nd] + (int(w.shape[1]),))
