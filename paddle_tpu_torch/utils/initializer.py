"""Parameter initializers.

Counterpart of paddle_tpu/utils/initializer.py (the reference's
initializer.py: Constant, Uniform, Normal, Xavier, MSRA). An initializer
has two uses:

* `op_spec(shape, dtype)` → (op type, attrs) of the one op it appends to
  a startup program — the static path, the same spec as the JAX package
  emits, so both packages build the same startup programs;
* `init(tensor, generator)` fills a tensor in place from an explicit
  `torch.Generator` — the eager layers.
"""
import math

import torch

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "Xavier", "MSRA",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer", "MSRAInitializer"]


class Initializer:
    def op_spec(self, shape, dtype):
        """Return (op_type, attrs) for the startup-program op."""
        raise NotImplementedError

    def init(self, tensor, generator=None):
        """Fill `tensor` in place; returns it."""
        raise NotImplementedError

    def _fan(self, shape):
        if len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        # conv OIHW: receptive field times in/out channels
        rf = 1
        for d in shape[2:]:
            rf *= d
        return shape[1] * rf, shape[0] * rf


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def op_spec(self, shape, dtype):
        return "fill_constant", {"shape": list(shape), "value": self.value}

    def init(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def op_spec(self, shape, dtype):
        return "uniform_random", {"shape": list(shape), "min": self.low,
                                  "max": self.high, "seed": self.seed}


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def op_spec(self, shape, dtype):
        return "gaussian_random", {"shape": list(shape), "mean": self.loc,
                                   "std": self.scale, "seed": self.seed}

    def init(self, tensor, generator=None):
        with torch.no_grad():
            return tensor.normal_(self.loc, self.scale, generator=generator)


class Xavier(Initializer):
    """Glorot init (initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def op_spec(self, shape, dtype):
        fi, fo = self._fan(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return "uniform_random", {"shape": list(shape), "min": -limit,
                                      "max": limit, "seed": self.seed}
        std = math.sqrt(2.0 / (fi + fo))
        return "gaussian_random", {"shape": list(shape), "mean": 0.0,
                                   "std": std, "seed": self.seed}


class MSRA(Initializer):
    """He init (initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def op_spec(self, shape, dtype):
        fi, _ = self._fan(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return "uniform_random", {"shape": list(shape), "min": -limit,
                                      "max": limit, "seed": self.seed}
        std = math.sqrt(2.0 / fi)
        return "gaussian_random", {"shape": list(shape), "mean": 0.0,
                                   "std": std, "seed": self.seed}


# default aliases matching fluid
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
MSRAInitializer = MSRA
