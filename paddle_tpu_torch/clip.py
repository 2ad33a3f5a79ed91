"""fluid.clip module path — re-export of utils/clip.py plus
ErrorClipByValue (the reference's clip.py:48)."""
import torch

from paddle_tpu_torch.utils.clip import (  # noqa: F401
    GradientClipByGlobalNorm, GradientClipByNorm, GradientClipByValue,
    get_gradient_clip, set_gradient_clip)


class ErrorClipByValue:
    """Clip a gradient tensor to [min, max] (clip.py ErrorClipByValue):
    `apply(grad)` in a custom training loop."""

    def __init__(self, max, min=None):  # noqa: A002 (fluid signature)
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, grad):
        return torch.clamp(grad, self.min, self.max)
