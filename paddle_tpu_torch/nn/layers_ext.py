"""Eager layers completing the fluid.dygraph.nn class surface: FC,
Conv3D, Conv3DTranspose, BilinearTensorProduct, PRelu, GRUUnit, NCE,
RowConv, SequenceConv, SpectralNorm, TreeConv.

Counterpart of paddle_tpu/nn/layers_ext.py, with its parameter and
buffer names and layouts. Where the JAX layer runs a registered op
(`_run_op`), so does this one, through the port's registry: one numeric
code path for the static and the eager API, as the reference's dygraph
layers call the static ops' kernels.

Randomness: NCE draws fresh negatives every call from an op generator
seeded by the module-level layer generator (`layers.seed`), as the JAX
layer folds its seed into the next eager key; the draws are torch's.
SpectralNorm's u / v start as standard normals from that generator (the
JAX layer draws them from `PRNGKey(0)` / `PRNGKey(1)`, which torch
cannot reproduce): `weights.layer_state_from_jax` carries them across
as buffers.
"""
import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Layer, _generator
from paddle_tpu_torch.utils.initializer import Constant

__all__ = ["FC", "Conv3D", "Conv3DTranspose", "BilinearTensorProduct",
           "PRelu", "GRUUnit", "NCE", "RowConv", "SequenceConv",
           "SpectralNorm", "TreeConv"]


def _triple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * 3


def _run_op(name, attrs, *args, seed=None):
    """A registered op's function on the device of its first tensor."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ctx = registry.OpContext(dict(attrs), seed, True, 0, dev)
    return registry.get_op(name).fn(ctx, *args)


def _bias(layer, bias_attr, size):
    if bias_attr is not False:
        layer.create_parameter("bias", (size,), is_bias=True)
    else:
        layer.bias = None


class FC(Layer):
    """dygraph/nn.py FC: flattens the dims after `num_flatten_dims`, then
    x @ W + b."""

    def __init__(self, input_dim, size, num_flatten_dims=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (input_dim, size))
        _bias(self, bias_attr, size)
        self.num_flatten_dims = num_flatten_dims
        self.act = act

    def forward(self, x):
        flat = x.reshape(*x.shape[:self.num_flatten_dims], -1)
        y = flat @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return F.activation(y, self.act)


class Conv3D(Layer):
    """NCDHW convolution, filter OIDHW."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.ksize = _triple(filter_size)
        self.stride, self.padding, self.dilation = (
            _triple(stride), _triple(padding), _triple(dilation))
        self.groups = groups
        self.create_parameter(
            "weight", (num_filters, num_channels // groups) + self.ksize)
        _bias(self, bias_attr, num_filters)
        self.act = act

    def forward(self, x):
        y = torch.nn.functional.conv3d(
            x, self.weight.to(x.dtype), None, self.stride, self.padding,
            self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1, 1)
        return F.activation(y, self.act)


class Conv3DTranspose(Layer):
    """NCDHW transposed convolution, filter [C_in, C_out / groups, kd,
    kh, kw] (PyTorch's own layout), output size (D-1)*stride - 2*pad +
    (k-1)*dilation + 1."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.ksize = _triple(filter_size)
        self.stride, self.padding, self.dilation = (
            _triple(stride), _triple(padding), _triple(dilation))
        self.groups = groups
        self.create_parameter(
            "weight", (num_channels, num_filters // groups) + self.ksize)
        _bias(self, bias_attr, num_filters)
        self.act = act

    def forward(self, x):
        y = torch.nn.functional.conv_transpose3d(
            x, self.weight.to(x.dtype), None, self.stride, self.padding, 0,
            self.groups, self.dilation)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1, 1)
        return F.activation(y, self.act)


class BilinearTensorProduct(Layer):
    """out_k = x^T W_k y + b_k (dygraph/nn.py BilinearTensorProduct)."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (output_dim, input1_dim, input2_dim))
        _bias(self, bias_attr, output_dim)
        self.act = act

    def forward(self, x, y):
        out = torch.einsum("bi,kij,bj->bk", x, self.weight, y)
        if self.bias is not None:
            out = out + self.bias
        return F.activation(out, self.act)


class PRelu(Layer):
    """mode: 'all' (one alpha), 'channel' (per channel), 'element'."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        shape = {"all": (1,), "channel": (channel,)}.get(
            mode, tuple(input_shape or ()))
        self.mode = mode
        self.create_parameter("alpha", shape, Constant(0.25))

    def forward(self, x):
        return _run_op("prelu", {"mode": self.mode}, x, self.alpha)


class GRUUnit(Layer):
    """One GRU step over the registered gru_unit op, the reference's gate
    layout {u, r, c~}; `size` is 3 x the hidden width. Returns (hidden,
    reset_hidden_prev, gate)."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        d = size // 3
        self.d = d
        self.create_parameter("weight", (d, d * 3))
        _bias(self, bias_attr, d * 3)
        self.attrs = {"activation": activation,
                      "gate_activation": gate_activation,
                      "origin_mode": origin_mode}

    def forward(self, input, hidden):
        return _run_op("gru_unit", self.attrs, input, hidden, self.weight,
                       self.bias)


class NCE(Layer):
    """Noise-contrastive estimation over the registered nce op; fresh
    negatives every call."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (num_total_classes, dim))
        _bias(self, bias_attr, num_total_classes)
        self.attrs = {"num_total_classes": num_total_classes,
                      "num_neg_samples": num_neg_samples,
                      "sampler": sampler, "seed": seed}

    def forward(self, input, label, sample_weight=None):
        draw = int(torch.randint(0, 2 ** 62, (1,), generator=_generator()))
        cost, _, _ = _run_op("nce", self.attrs, input, label, self.weight,
                             self.bias, sample_weight,
                             seed=draw ^ int(self.attrs["seed"]))
        return cost


class RowConv(Layer):
    """Lookahead convolution: weight [future_context_size + 1, D]."""

    def __init__(self, input_dim, future_context_size, param_attr=None,
                 act=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (future_context_size + 1, input_dim))
        self.act = act

    def forward(self, x):
        return F.activation(_run_op("row_conv", {}, x, self.weight),
                            self.act)


class SequenceConv(Layer):
    """Context-window convolution over dense [B, T, D] (+ lengths)."""

    def __init__(self, input_dim, num_filters, filter_size=3,
                 filter_stride=1, padding=None, bias_attr=None,
                 param_attr=None, act=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.filter_size = filter_size
        self.create_parameter("weight", (filter_size * input_dim,
                                         num_filters))
        _bias(self, bias_attr, num_filters)
        self.act = act

    def forward(self, x, lengths=None):
        out = _run_op("sequence_conv", {"context_length": self.filter_size},
                      x, self.weight, self.bias, lengths)
        return F.activation(out, self.act)


class SpectralNorm(Layer):
    """weight / sigma_max by power iteration; u [h] and v [w] are
    float32 buffers (h = weight_shape[dim], w the product of the rest)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.register_buffer("u", torch.randn((h,), generator=_generator()))
        self.register_buffer("v", torch.randn((w,), generator=_generator()))
        self.attrs = {"dim": dim, "power_iters": power_iters, "eps": eps}

    def forward(self, weight):
        return _run_op("spectral_norm", self.attrs, weight, self.u, self.v)


class TreeConv(Layer):
    """TBCNN tree convolution: weight [feature_size, 3, output_size,
    num_filters], bias [num_filters]."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.create_parameter("weight", (feature_size, 3, output_size,
                                         num_filters))
        _bias(self, bias_attr, num_filters)
        self.max_depth = max_depth
        self.act = act

    def forward(self, nodes_vector, edge_set):
        out = _run_op("tree_conv", {"max_depth": self.max_depth},
                      nodes_vector, edge_set, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return F.activation(out, self.act)
