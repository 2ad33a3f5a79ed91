"""Eager layers.

Counterpart of paddle_tpu/nn/layers.py: `Layer`, `Linear`, `Conv2D`,
`Conv2DTranspose`, `Pool2D`, `BatchNorm`, `LayerNorm`, `GroupNorm`,
`Embedding`, `Dropout`, `Sequential`, `LayerList` and `to_variable`. A
`Layer` is an `nn.Module` whose parameters and buffers carry the JAX
package's flat names: `LayerList` children are `i0`, `i1`, ...,
`Sequential` children `l0`, `l1`, ..., batch norm's running statistics
the buffers `mean` and `var`, so `trainable_dict()` and `state_dict()`
give names such as `layers.i0.attn.qkv.weight` or `stem_bn.mean`, and a
JAX model's parameters and buffers load by name (`weights.
layer_state_from_jax`). Weights keep the JAX layouts: Linear `[in,
out]` (`y = x @ w`), Conv2D OIHW (HWIO with `data_format="NHWC"`),
Conv2DTranspose IOHW, so no name maps to a transposed tensor.

Parameters are drawn on the CPU from the module-level generator that
`seed(s)` resets (the counterpart of the JAX package's global key) and
then moved to the layer's device (`device=None` means CUDA and raises
without a GPU), so one seed gives the same weights on every device.
The draws are torch's, not `jax.random`'s: tests move the JAX weights
over instead.

`train()` / `eval()` switch every sublayer, as the JAX `Layer` does:
dropout and batch norm read `training`. A batch norm in training mode
keeps its moved running statistics after every forward; the JAX layer
keeps them only from an eager call (under `jax.grad` or `jit` its
forward returns them to nobody).
"""
import math

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.utils.initializer import Constant, Normal

__all__ = ["seed", "to_variable", "Layer", "Linear", "Conv2D",
           "Conv2DTranspose", "Pool2D", "BatchNorm", "LayerNorm",
           "GroupNorm", "Embedding", "Dropout", "Sequential", "LayerList"]

_global_gen = [None]


def seed(s):
    """Reset the generator that draws every new layer's parameters."""
    _global_gen[0] = torch.Generator().manual_seed(int(s))


def _generator():
    if _global_gen[0] is None:
        seed(0)
    return _global_gen[0]


def to_variable(x, dtype=None, device=None):
    """dygraph.to_variable: an array (numpy, list, tensor) -> a tensor on
    `device` (None: CUDA), cast to `dtype` if given."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    return t.to(device=resolve_device(device),
                dtype=_dt.normalize_dtype(dtype) if dtype else None)


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

    def register_buffer(self, name, value, persistent=True):
        """Register a buffer (moved to the layer's device); returns it,
        as the JAX package's `register_buffer` does."""
        value = value.to(resolve_device(self._device))
        super().register_buffer(name, value, persistent)
        return value

    def set_state_dict(self, state, prefix=""):
        """Copy every parameter and buffer found in `state` ({flat name:
        array or tensor}) into the layer, in place, keeping each one's
        dtype and device; names not in `state` stay as they are."""
        own = dict(self.named_parameters())
        own.update(self.named_buffers())
        with torch.no_grad():
            for name, t in own.items():
                value = state.get(prefix + name)
                if value is None:
                    continue
                if not isinstance(value, torch.Tensor):
                    value = torch.from_numpy(np.asarray(value))
                t.copy_(value)

    load_dict = set_state_dict

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

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (input_dim, output_dim),
                              _attr_init(param_attr))
        if bias_attr is not False:
            self.create_parameter("bias", (output_dim,), is_bias=True)
        else:
            self.bias = None
        self.act = act

    def forward(self, x):
        w = self.weight
        common = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(common), w.to(common)).to(x.dtype)
        if self.bias is not None:
            y = F.add_bias(y, self.bias)
        return F.activation(y, self.act)


class Conv2D(Layer):
    """Conv2D with the JAX layouts: filter OIHW, or HWIO with
    `data_format="NHWC"`; default filter init N(0, sqrt(2 / (fh fw C)))."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32",
                 data_format="NCHW", device=None):
        super().__init__(dtype=dtype, device=device)
        fh, fw = _pair(filter_size)
        std = (2.0 / (fh * fw * num_channels)) ** 0.5
        wshape = ((fh, fw, num_channels // groups, num_filters)
                  if data_format == "NHWC"
                  else (num_filters, num_channels // groups, fh, fw))
        self.create_parameter("weight", wshape,
                              _attr_init(param_attr) or Normal(0.0, std))
        if bias_attr is not False:
            self.create_parameter("bias", (num_filters,), is_bias=True)
        else:
            self.bias = None
        self.stride, self.padding, self.dilation, self.groups = \
            _pair(stride), _pair(padding), _pair(dilation), groups
        self.act = act
        self.data_format = data_format

    def forward(self, x):
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                     self.dilation, self.groups, self.data_format)
        return F.activation(y, self.act)


class Conv2DTranspose(Layer):
    """Transposed convolution, filter IOHW [C_in, C_out, fh, fw]."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, act=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        fh, fw = _pair(filter_size)
        self.create_parameter("weight", (num_channels, num_filters, fh, fw))
        self.create_parameter("bias", (num_filters,), is_bias=True)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.act = act

    def forward(self, x):
        y = F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                               self.padding)
        return F.activation(y, self.act)


class Pool2D(Layer):
    def __init__(self, pool_size=2, pool_type="max", pool_stride=None,
                 pool_padding=0, global_pooling=False, data_format="NCHW"):
        super().__init__()
        self.pool_size = _pair(pool_size)
        self.pool_type = pool_type
        self.pool_stride = _pair(pool_stride or pool_size)
        self.pool_padding = _pair(pool_padding)
        self.global_pooling = global_pooling
        self.data_format = data_format

    def forward(self, x):
        return F.pool2d(x, self.pool_size, self.pool_type, self.pool_stride,
                        self.pool_padding, self.global_pooling,
                        self.data_format)


class BatchNorm(Layer):
    """Batch norm with parameters `scale`, `bias` and float32 running
    statistics as the buffers `mean` (zeros) and `var` (ones)."""

    def __init__(self, num_channels, momentum=0.9, epsilon=1e-5, act=None,
                 dtype="float32", data_format="NCHW", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("scale", (num_channels,), Constant(1.0))
        self.create_parameter("bias", (num_channels,), is_bias=True)
        self.register_buffer("mean", torch.zeros(num_channels))
        self.register_buffer("var", torch.ones(num_channels))
        self.momentum, self.epsilon = momentum, epsilon
        self.act = act
        self.data_format = data_format

    def forward(self, x):
        y, new_mean, new_var = F.batch_norm(
            x, self.scale, self.bias, self.mean, self.var, self.momentum,
            self.epsilon, self.training, self.data_format)
        if self.training:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.var.copy_(new_var)
        return F.activation(y, self.act)


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


class GroupNorm(Layer):
    def __init__(self, channels, groups, epsilon=1e-5, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (channels,), Constant(1.0))
        self.create_parameter("bias", (channels,), is_bias=True)
        self.groups, self.epsilon = groups, epsilon

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias,
                            self.epsilon)


class Embedding(Layer):
    """Rows of `weight` [V, D] by id; ids equal to `padding_idx` give
    zero rows (and no gradient), as the JAX layer's `where`."""

    def __init__(self, size, padding_idx=None, param_attr=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", tuple(size), _attr_init(param_attr))
        self.padding_idx = padding_idx

    def forward(self, ids):
        ids = ids.long()
        out = torch.nn.functional.embedding(ids, self.weight)
        if self.padding_idx is not None:
            out = torch.where((ids == self.padding_idx)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        return F.dropout(x, self.p, generator, self.training)


class Sequential(Layer):
    """Layers applied in order, registered as `l0`, `l1`, ..."""

    def __init__(self, *layers):
        super().__init__()
        self._seq = []
        for i, layer in enumerate(layers):
            self.add_module(f"l{i}", layer)
            self._seq.append(layer)

    def forward(self, x):
        for layer in self._seq:
            x = layer(x)
        return x


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


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _attr_init(param_attr):
    """The initializer a ParamAttr carries, or None."""
    return getattr(param_attr, "initializer", None) if param_attr else None
