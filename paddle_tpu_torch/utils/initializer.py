"""Parameter initializers.

Counterpart of paddle_tpu/utils/initializer.py (the reference's
initializer.py: Constant, Uniform, Normal, TruncatedNormal, Xavier, MSRA,
Bilinear, NumpyArrayInitializer). An initializer has two uses:

* `op_spec(shape, dtype)` → (op type, attrs) of the one op it appends to
  a startup program — the static path, the same spec as the JAX package
  emits, so both packages build the same startup programs;
* `init(tensor, generator)` fills a tensor in place as that op would,
  from an explicit `torch.Generator` — the eager layers.

Bilinear and NumpyArrayInitializer emit `assign_value` with the values
in the attrs, computed on the host in numpy, as in the JAX package.
"""
import math

import numpy as np
import torch

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "Xavier", "MSRA", "NumpyArrayInitializer", "Bilinear",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer", "MSRAInitializer"]


class Initializer:
    def op_spec(self, shape, dtype):
        """Return (op_type, attrs) for the startup-program op."""
        raise NotImplementedError

    def init(self, tensor, generator=None):
        """Fill `tensor` in place as the startup op of `op_spec` would,
        drawing from `generator`; returns it."""
        op, attrs = self.op_spec(tuple(tensor.shape), tensor.dtype)
        with torch.no_grad():
            if op == "fill_constant":
                return tensor.fill_(attrs["value"])
            if op == "uniform_random":
                return tensor.uniform_(attrs["min"], attrs["max"],
                                       generator=generator)
            if op == "gaussian_random":
                return tensor.normal_(attrs["mean"], attrs["std"],
                                      generator=generator)
            if op == "truncated_gaussian_random":
                mean, std = attrs["mean"], attrs["std"]
                return torch.nn.init.trunc_normal_(
                    tensor, mean, std, mean - 2 * std, mean + 2 * std,
                    generator=generator)
            if op == "assign_value":
                return tensor.copy_(torch.tensor(
                    attrs["values"], dtype=tensor.dtype).reshape(
                        tensor.shape))
        raise ValueError(f"unknown initializer op {op}")

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


class TruncatedNormal(Initializer):
    """N(loc, scale) truncated to loc +- 2 scale."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def op_spec(self, shape, dtype):
        return "truncated_gaussian_random", {
            "shape": list(shape), "mean": self.loc, "std": self.scale,
            "seed": self.seed}


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


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def op_spec(self, shape, dtype):
        return "assign_value", {"shape": list(self.value.shape),
                                "values": self.value.reshape(-1).tolist()}


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a conv_transpose filter
    [C_in, C_out, kh, kw] (initializer.py BilinearInitializer)."""

    def op_spec(self, shape, dtype):
        _, _, kh, kw = shape
        f = math.ceil(kw / 2.0)
        cc = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, dtype=np.float32)
        for i in range(kh):
            for j in range(kw):
                w[:, :, i, j] = (1 - abs(i / f - cc)) * (1 - abs(j / f - cc))
        return "assign_value", {"shape": list(shape),
                                "values": w.reshape(-1).tolist()}


# default aliases matching fluid
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
MSRAInitializer = MSRA
