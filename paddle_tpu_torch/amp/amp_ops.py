"""Loss-scaling operators.

Counterpart of paddle_tpu/amp/amp_ops.py (the reference composes them
from primitive ops, fp16_utils.py:279 update_loss_scaling and
decorator.py:134-167): two IR ops whose math is `amp/schedule.py`, shared
with the eager GradScaler. Both are selects on device tensors, so a
mixed-precision step reads nothing on the host.
"""
from paddle_tpu_torch.amp import schedule
from paddle_tpu_torch.core.registry import register_op


@register_op("check_finite_and_unscale", inputs=["X[]", "Scale"],
             outputs=["Out[]", "FoundInfinite"])
def _check_finite_and_unscale(ctx, xs, scale):
    """Every grad divided by the loss scale; FoundInfinite [1] is true if
    any grad holds a nan or inf, and then every grad comes back zeroed so
    the following update is harmless."""
    outs, found_inf = schedule.unscale_and_check(xs, scale)
    return outs, found_inf.reshape(1)


@register_op("update_loss_scaling",
             inputs=["FoundInfinite", "PrevLossScaling", "InGoodSteps",
                     "InBadSteps"],
             outputs=["LossScaling", "OutGoodSteps", "OutBadSteps"])
def _update_loss_scaling(ctx, found_inf, scale, good, bad):
    s, good, bad = schedule.update_scale(
        scale, good, bad, found_inf,
        ctx.attr("incr_every_n_steps", 1000),
        ctx.attr("decr_every_n_nan_or_inf", 2),
        ctx.attr("incr_ratio", 2.0), ctx.attr("decr_ratio", 0.5))
    return s.reshape(1), good, bad
