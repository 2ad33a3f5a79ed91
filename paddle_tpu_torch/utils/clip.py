"""Gradient clipping.

Counterpart of paddle_tpu/utils/clip.py (the reference's clip.py:
GradientClipByValue :214, GradientClipByNorm, GradientClipByGlobalNorm,
set_gradient_clip). The optimizer appends a clip's ops between the
`autodiff` op (and the regularizers) and the update ops; each op
rebinds the gradient under its own name.
"""
from paddle_tpu_torch.core.ir import OpRole

__all__ = ["BaseGradientClip", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "get_gradient_clip"]

#: clip's upper bound that never binds: factor = clip_norm / max(norm, c)
_NO_MAX = 3.4e38


class BaseGradientClip:
    def append_clip_ops(self, block, params_grads):
        """params_grads: list of (param_name, grad_name). Returns it."""
        raise NotImplementedError


class GradientClipByValue(BaseGradientClip):
    def __init__(self, max, min=None):  # noqa: A002 (fluid signature)
        self.max = max
        self.min = -max if min is None else min

    def append_clip_ops(self, block, params_grads):
        for _, g in params_grads:
            block.append_op("clip", {"X": [g]}, {"Out": [g]},
                            {"min": self.min, "max": self.max},
                            role=OpRole.BACKWARD)
        return params_grads


class GradientClipByNorm(BaseGradientClip):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def append_clip_ops(self, block, params_grads):
        for _, g in params_grads:
            norm = block.create_var(dtype="float32").name
            block.append_op("frobenius_norm", {"X": [g]}, {"Out": [norm]},
                            role=OpRole.BACKWARD)
            mx = block.create_var(dtype="float32").name
            block.append_op("clip", {"X": [norm]}, {"Out": [mx]},
                            {"min": self.clip_norm, "max": _NO_MAX},
                            role=OpRole.BACKWARD)
            cn = block.create_var(dtype="float32").name
            block.append_op("fill_constant", {}, {"Out": [cn]},
                            {"shape": [], "value": self.clip_norm,
                             "dtype": "float32"}, role=OpRole.BACKWARD)
            factor = block.create_var(dtype="float32").name
            block.append_op("elementwise_div", {"X": [cn], "Y": [mx]},
                            {"Out": [factor]}, role=OpRole.BACKWARD)
            block.append_op("elementwise_mul", {"X": [g], "Y": [factor]},
                            {"Out": [g]}, {"axis": -1}, role=OpRole.BACKWARD)
        return params_grads


class GradientClipByGlobalNorm(BaseGradientClip):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def append_clip_ops(self, block, params_grads):
        sq_names = []
        for _, g in params_grads:
            sq = block.create_var(dtype="float32").name
            block.append_op("squared_l2_norm", {"X": [g]}, {"Out": [sq]},
                            role=OpRole.BACKWARD)
            sq_names.append(sq)
        total = block.create_var(dtype="float32").name
        block.append_op("sum", {"X": sq_names}, {"Out": [total]},
                        role=OpRole.BACKWARD)
        gnorm = block.create_var(dtype="float32").name
        block.append_op("sqrt", {"X": [total]}, {"Out": [gnorm]},
                        role=OpRole.BACKWARD)
        mx = block.create_var(dtype="float32").name
        block.append_op("clip", {"X": [gnorm]}, {"Out": [mx]},
                        {"min": self.clip_norm, "max": _NO_MAX},
                        role=OpRole.BACKWARD)
        factor = block.create_var(dtype="float32").name
        cn = block.create_var(dtype="float32").name
        block.append_op("fill_constant", {}, {"Out": [cn]},
                        {"shape": [1], "value": self.clip_norm,
                         "dtype": "float32"}, role=OpRole.BACKWARD)
        block.append_op("elementwise_div", {"X": [cn], "Y": [mx]},
                        {"Out": [factor]}, role=OpRole.BACKWARD)
        for _, g in params_grads:
            block.append_op("elementwise_mul", {"X": [g], "Y": [factor]},
                            {"Out": [g]}, {"axis": -1}, role=OpRole.BACKWARD)
        return params_grads


_gradient_clip = None


def set_gradient_clip(clip):
    """The clip every later `minimize` applies when its optimizer has
    none (fluid.clip.set_gradient_clip)."""
    global _gradient_clip
    _gradient_clip = clip


def get_gradient_clip():
    return _gradient_clip
