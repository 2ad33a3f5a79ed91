"""Parameter initializers.

Counterpart of paddle_tpu/utils/initializer.py for what the eager layers
use: `Constant` (LayerNorm scales) and `Normal`. The JAX package's
initializer is a spec that emits one startup-program op; here `init`
fills a tensor in place from an explicit `torch.Generator`.
"""
import torch

__all__ = ["Initializer", "Constant", "Normal"]


class Initializer:
    def init(self, tensor, generator=None):
        """Fill `tensor` in place; returns it."""
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def init(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def init(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.normal_(self.loc, self.scale, generator=generator)
