"""Weight-decay regularizers.

Counterpart of paddle_tpu/utils/regularizer.py (the reference's
regularizer.py: L1DecayRegularizer, L2DecayRegularizer). The optimizer
calls `append_ops` for each (param, grad) pair before the update ops:
grad = grad + coeff * param (L2) or + coeff * sign(param) (L1), as a
`scale` and a `sum` op (with a `sign` op first for L1).
"""
from paddle_tpu_torch.core.ir import OpRole

__all__ = ["Regularizer", "L1Decay", "L2Decay", "L1DecayRegularizer",
           "L2DecayRegularizer"]


class Regularizer:
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_ops(self, block, param_name, grad_name):
        raise NotImplementedError


class L2Decay(Regularizer):
    def append_ops(self, block, param_name, grad_name):
        tmp = block.create_var(dtype=block.var(grad_name).dtype).name
        block.append_op("scale", {"X": [param_name]}, {"Out": [tmp]},
                        {"scale": self.coeff}, role=OpRole.BACKWARD)
        block.append_op("sum", {"X": [grad_name, tmp]}, {"Out": [grad_name]},
                        role=OpRole.BACKWARD)


class L1Decay(Regularizer):
    def append_ops(self, block, param_name, grad_name):
        dtype = block.var(grad_name).dtype
        sgn = block.create_var(dtype=dtype).name
        tmp = block.create_var(dtype=dtype).name
        block.append_op("sign", {"X": [param_name]}, {"Out": [sgn]},
                        role=OpRole.BACKWARD)
        block.append_op("scale", {"X": [sgn]}, {"Out": [tmp]},
                        {"scale": self.coeff}, role=OpRole.BACKWARD)
        block.append_op("sum", {"X": [grad_name, tmp]}, {"Out": [grad_name]},
                        role=OpRole.BACKWARD)


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
