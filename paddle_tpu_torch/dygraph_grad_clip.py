"""fluid.dygraph_grad_clip (dygraph_grad_clip.py:46-191): the eager
clip classes.

Counterpart of paddle_tpu/dygraph_grad_clip.py: clip(params_grads) ->
the clipped [(param, grad)] list, a None grad passed through.
"""
import torch

__all__ = ["GradClipByValue", "GradClipByNorm", "GradClipByGlobalNorm"]


class GradClipBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class GradClipByValue(GradClipBase):
    """Elementwise clip to [min, max] (one value v: [-|v|, |v|])."""

    def __init__(self, min_value, max_value=None):
        if max_value is None:
            min_value, max_value = -abs(min_value), abs(min_value)
        self.min_value, self.max_value = float(min_value), float(max_value)

    def _clip(self, params_grads):
        return [(p, None if g is None else
                 torch.clamp(g, self.min_value, self.max_value))
                for p, g in params_grads]


class GradClipByNorm(GradClipBase):
    """Each grad scaled to L2 norm at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, None))
                continue
            norm = torch.sqrt(torch.sum(g * g))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, g * scale))
        return out


class GradClipByGlobalNorm(GradClipBase):
    """Every grad scaled by one factor so that their global L2 norm is
    at most max_global_norm."""

    def __init__(self, max_global_norm):
        self.max_global_norm = float(max_global_norm)

    def _clip(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        global_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(
            self.max_global_norm / torch.clamp(global_norm, min=1e-12),
            max=1.0)
        return [(p, None if g is None else g * scale)
                for p, g in params_grads]
