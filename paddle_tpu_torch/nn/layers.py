"""Eager layers.

Counterpart of paddle_tpu/nn/layers.py for the layers the BERT slice
needs: `Layer`, `Linear`, `LayerNorm`, `Embedding`, `LayerList` and
`Dropout`, with the arguments BERT uses (`param_attr`, `bias_attr` and
`padding_idx` wait for the model zoo). A `Layer` is an `nn.Module` whose parameters carry the JAX
package's flat names: `LayerList` children are `i0`, `i1`, ..., so
`trainable_dict()` and `state_dict()` give names such as
`layers.i0.attn.qkv.weight`, and a JAX model's parameters load by name.
Weights keep the `[in, out]` layout (`y = x @ w`), so no name maps to a
transposed tensor.

Parameters are drawn on the CPU from the module-level generator that
`seed(s)` resets (the counterpart of the JAX package's global key) and
then moved to the layer's device, so one seed gives the same weights on
every device. The draws are torch's, not `jax.random`'s: tests move the
JAX weights over instead.
"""
import math

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.utils.initializer import Constant

__all__ = ["seed", "Layer", "Linear", "LayerNorm", "Embedding",
           "LayerList", "Dropout"]

_global_gen = [None]


def seed(s):
    """Reset the generator that draws every new layer's parameters."""
    _global_gen[0] = torch.Generator().manual_seed(int(s))


def _generator():
    if _global_gen[0] is None:
        seed(0)
    return _global_gen[0]


class Layer(nn.Module):
    """Base layer: `create_parameter`, JAX-named `trainable_dict()` /
    `load_trainable()`, and `train()`/`eval()` over every sublayer (the
    `training` flag is what dropout reads, as in the JAX package)."""

    def __init__(self, dtype="float32", device=None):
        super().__init__()
        self._dtype = _dt.normalize_dtype(dtype)
        self._device = device       # resolved when a parameter is made

    def create_parameter(self, name, shape, initializer=None, is_bias=False,
                         dtype=None):
        """Register parameter `name`. Defaults as in the JAX package:
        zeros for a bias, else uniform(-l, l) with
        l = sqrt(6 / (fan_in + shape[-1]))."""
        dtype = _dt.normalize_dtype(dtype) if dtype else self._dtype
        shape = tuple(int(s) for s in shape)
        val = torch.empty(shape, dtype=torch.float32)
        if initializer is not None:
            initializer.init(val, _generator())
        elif is_bias:
            val.zero_()
        else:
            fan_in = shape[0] if len(shape) >= 1 else 1
            if len(shape) > 2:
                fan_in = int(np.prod(shape[1:]))
            limit = math.sqrt(6.0 / max(fan_in + shape[-1], 1))
            val.uniform_(-limit, limit, generator=_generator())
        param = nn.Parameter(val.to(device=resolve_device(self._device),
                                    dtype=dtype))
        self.register_parameter(name, param)
        return param

    def trainable_dict(self):
        """{flat name: parameter}, in the JAX package's order (a layer's
        own parameters, then each sublayer's)."""
        return dict(self.named_parameters())

    def load_trainable(self, flat):
        """Assign tensors by flat name: each becomes the parameter (as
        the JAX package assigns arrays), keeping its dtype and device."""
        for name, value in flat.items():
            *path, leaf = name.split(".")
            layer = self.get_submodule(".".join(path)) if path else self
            if leaf not in layer._parameters:
                raise KeyError(f"no parameter named {name!r}")
            if not isinstance(value, nn.Parameter):
                value = nn.Parameter(value.detach())
            layer._parameters[leaf] = value

    def sublayers(self, include_self=False):
        out = [self] if include_self else []
        for sub in self.children():
            if isinstance(sub, Layer):
                out.extend(sub.sublayers(include_self=True))
        return out


class Linear(Layer):
    """y = act(x @ w + b): w is [in, out]; bf16/f16 inputs accumulate in
    f32 and the result is cast back to x's dtype."""

    def __init__(self, input_dim, output_dim, act=None, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (input_dim, output_dim))
        self.create_parameter("bias", (output_dim,), is_bias=True)
        self.act = act

    def forward(self, x):
        w = self.weight
        common = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(common), w.to(common)).to(x.dtype)
        return F.activation(F.add_bias(y, self.bias), self.act)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.create_parameter("weight", tuple(normalized_shape),
                              Constant(1.0))
        self.create_parameter("bias", tuple(normalized_shape), is_bias=True)
        self.epsilon = epsilon

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.epsilon)


class Embedding(Layer):
    def __init__(self, size, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", tuple(size))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        return F.dropout(x, self.p, generator, self.training)


class LayerList(Layer):
    """Children registered as `i0`, `i1`, ... (the JAX package's names)."""

    def __init__(self, layers=None):
        super().__init__()
        self._list = []
        for layer in (layers or []):
            self.append(layer)

    def append(self, layer):
        self.add_module(f"i{len(self._list)}", layer)
        self._list.append(layer)

    def __iter__(self):
        return iter(self._list)

    def __len__(self):
        return len(self._list)

    def __getitem__(self, i):
        return self._list[i]
