"""Core NN layers of the static-graph API.

Counterpart of paddle_tpu/static/nn.py (the reference's layers/nn.py)
for the layers the ResNet and LeNet builders call: `data`, `fc`,
`conv2d`, `pool2d`, `batch_norm`. A layer appends OpDescs; the compute is
the registered op (paddle_tpu_torch/ops/).
"""
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import default_main_program, unique_name
from paddle_tpu_torch.static.helper import LayerHelper
from paddle_tpu_torch.utils.initializer import Constant, Normal
from paddle_tpu_torch.utils.param_attr import ParamAttr

__all__ = ["data", "fc", "conv2d", "pool2d", "batch_norm"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True):
    """fluid.layers.data: declare a feed variable. With append_batch_size
    a -1 batch dim is prepended."""
    block = default_main_program().global_block()
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + list(shape)
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            is_data=True, lod_level=lod_level,
                            stop_gradient=True)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """fluid.layers.fc (nn.py:39): y = act(x·W + b), x flattened to 2D at
    num_flatten_dims; appended as mul (+ elementwise_add) (+ act)."""
    helper = LayerHelper("fc")
    fan_in = 1
    for d in input.shape[num_flatten_dims:]:
        fan_in *= d
    w = helper.create_parameter(param_attr, [fan_in, size], input.dtype)
    out = helper.create_tmp(dtype=input.dtype)
    helper.append_op("mul", {"X": input, "Y": w}, {"Out": out},
                     {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    b = helper.create_parameter(bias_attr, [size], input.dtype, is_bias=True)
    if b is not None:
        out2 = helper.create_tmp(dtype=input.dtype)
        helper.append_op("elementwise_add", {"X": out, "Y": b}, {"Out": out2},
                         {"axis": num_flatten_dims})
        out = out2
    return _apply_act(helper, out, act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           use_cudnn=True):
    """fluid.layers.conv2d, NCHW input, OIHW filter."""
    helper = LayerHelper("conv2d")
    c_in = input.shape[1]
    fh, fw = _pair(filter_size)
    enforce(c_in % groups == 0, "channels %s not divisible by groups %s",
            c_in, groups)
    std = (2.0 / (fh * fw * c_in)) ** 0.5
    w = helper.create_parameter(param_attr,
                                [num_filters, c_in // groups, fh, fw],
                                input.dtype, default_initializer=Normal(0.0, std))
    out = helper.create_tmp(dtype=input.dtype)
    inputs = {"Input": input, "Filter": w}
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        inputs["Bias"] = b
    helper.append_op("conv2d", inputs, {"Output": out},
                     {"strides": list(_pair(stride)),
                      "paddings": list(_pair(padding)),
                      "dilations": list(_pair(dilation)), "groups": groups})
    return _apply_act(helper, out, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, adaptive=False, name=None, use_cudnn=True):
    helper = LayerHelper("pool2d")
    out = helper.create_tmp(dtype=input.dtype)
    helper.append_op("pool2d", {"X": input}, {"Out": out},
                     {"pooling_type": pool_type,
                      "ksize": list(_pair(pool_size)),
                      "strides": list(_pair(pool_stride or pool_size)),
                      "paddings": list(_pair(pool_padding)),
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode,
                      "exclusive": exclusive, "adaptive": adaptive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False, name=None):
    """fluid.layers.batch_norm: scale/bias parameters plus running
    mean/variance persistables (batch_norm_op.cc contract)."""
    helper = LayerHelper("batch_norm")
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], "float32",
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], "float32", is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name or unique_name("bn_mean"),
                  initializer=Constant(0.0), trainable=False), [c], "float32")
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name or unique_name("bn_var"),
                  initializer=Constant(1.0), trainable=False), [c], "float32")
    mean.stop_gradient = True
    var.stop_gradient = True
    out = helper.create_tmp(dtype=input.dtype)
    saved_m = helper.create_tmp(dtype="float32", stop_gradient=True)
    saved_v = helper.create_tmp(dtype="float32", stop_gradient=True)
    helper.append_op("batch_norm",
                     {"X": input, "Scale": scale, "Bias": bias,
                      "Mean": mean, "Variance": var},
                     {"Y": out, "MeanOut": mean, "VarianceOut": var,
                      "SavedMean": saved_m, "SavedVariance": saved_v},
                     {"momentum": momentum, "epsilon": epsilon,
                      "is_test": is_test,
                      "use_global_stats": use_global_stats})
    return _apply_act(helper, out, act)


def _apply_act(helper, out, act):
    if act is None:
        return out
    out2 = helper.create_tmp(dtype=out.dtype)
    helper.append_op(act, {"X": out}, {"Out": out2}, {})
    return out2


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)
