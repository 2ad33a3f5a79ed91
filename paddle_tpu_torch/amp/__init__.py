"""Automatic mixed precision.

Counterpart of paddle_tpu/amp: the op lists, the loss-scaling core
shared by both paths, the static program rewrite (`decorate`,
`rewrite_program`, with the `check_finite_and_unscale` and
`update_loss_scaling` ops) and the eager helpers (`auto_cast`,
`GradScaler`). bfloat16 is the default low-precision dtype.
"""
from paddle_tpu_torch.amp.decorator import (  # noqa: F401
    OptimizerWithMixedPrecision, decorate, rewrite_program,
)
from paddle_tpu_torch.amp.eager import (  # noqa: F401
    GradScaler, auto_cast, bf16_compute_params, cast_compute,
    get_compute_dtype,
)
from paddle_tpu_torch.amp.fp16_lists import (  # noqa: F401
    AutoMixedPrecisionLists,
)

__all__ = ["decorate", "OptimizerWithMixedPrecision",
           "AutoMixedPrecisionLists", "rewrite_program", "GradScaler",
           "auto_cast", "cast_compute", "get_compute_dtype",
           "bf16_compute_params"]
