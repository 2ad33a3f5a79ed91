"""Single-op layer functions of the static-graph API.

Counterpart of paddle_tpu/static/common.py (the reference's layers/ops.py
and math_op_patch.py) for what the ResNet and LeNet builders and the
Variable operators call: activations, softmax, the elementwise family,
mul, mean, reduce_mean, scale, the losses and metrics of those models
and fit_a_line's `square_error_cost`, top_k and fill_constant.
"""
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.ir import Variable
from paddle_tpu_torch.static.helper import LayerHelper

__all__ = ["relu", "reciprocal", "softmax", "pow", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_pow", "mul", "mean", "reduce_mean", "scale",
           "softmax_with_cross_entropy", "square_error_cost", "accuracy",
           "topk",
           "fill_constant"]


def _simple(op_type, inputs, attrs=None, n_out=1, dtype=None, out_slots=None):
    return LayerHelper(op_type).append_simple(inputs, attrs, n_out=n_out,
                                              dtype=dtype, out_slots=out_slots)


def relu(x, name=None):
    return _simple("relu", {"X": x})


def reciprocal(x, name=None):
    return _simple("reciprocal", {"X": x})


def softmax(x, axis=-1, use_cudnn=False, name=None):
    return _simple("softmax", {"X": x}, {"axis": axis})


def pow(x, factor=1.0, name=None):  # noqa: A001 - fluid name
    return _simple("pow", {"X": x}, {"factor": factor})


# --- elementwise binary + Variable operator sugar ---

def _elementwise(op_type, x, y, axis=-1, act=None):
    out = _simple(op_type, {"X": x, "Y": y}, {"axis": axis})
    if act:
        out = _simple(act, {"X": out})
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act)


def _elementwise_binary(x, other, op_type, reverse=False):
    """Variable operator sugar: a scalar operand lowers to `scale` /
    `pow` / `reciprocal`, a Variable operand to the elementwise op
    (math_op_patch.py parity)."""
    if isinstance(other, Variable):
        a, b = (other, x) if reverse else (x, other)
        return _elementwise(op_type, a, b)
    c = float(other)
    if op_type == "elementwise_add":
        return _simple("scale", {"X": x}, {"scale": 1.0, "bias": c})
    if op_type == "elementwise_sub":
        if reverse:  # c - x
            return _simple("scale", {"X": x}, {"scale": -1.0, "bias": c})
        return _simple("scale", {"X": x}, {"scale": 1.0, "bias": -c})
    if op_type == "elementwise_mul":
        return _simple("scale", {"X": x}, {"scale": c, "bias": 0.0})
    if op_type == "elementwise_div":
        if reverse:  # c / x
            inv = _simple("reciprocal", {"X": x})
            return _simple("scale", {"X": inv}, {"scale": c, "bias": 0.0})
        return _simple("scale", {"X": x}, {"scale": 1.0 / c, "bias": 0.0})
    if op_type == "elementwise_pow":
        return _simple("pow", {"X": x}, {"factor": c})
    raise TypeError(f"unsupported scalar op {op_type}")


# --- matmul & reductions ---

def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _simple("mul", {"X": x, "Y": y},
                   {"x_num_col_dims": x_num_col_dims,
                    "y_num_col_dims": y_num_col_dims})


def mean(x, name=None):
    return _simple("mean", {"X": x})


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _simple("reduce_mean", {"X": input},
                   {"dim": dim, "keep_dim": keep_dim,
                    "reduce_all": dim is None})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = _simple("scale", {"X": x}, {"scale": scale, "bias": bias,
                                      "bias_after_scale": bias_after_scale})
    if act:
        out = _simple(act, {"X": out})
    return out


# --- losses and metrics ---

def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False,
                               name=None):
    sm, loss = _simple("softmax_with_cross_entropy",
                       {"Logits": logits, "Label": label},
                       {"soft_label": soft_label, "axis": axis,
                        "ignore_index": ignore_index},
                       n_out=2, out_slots=["Softmax", "Loss"])
    return (loss, sm) if return_softmax else loss


def square_error_cost(input, label, name=None):
    return _simple("square_error_cost", {"X": input, "Y": label})


def accuracy(input, label, k=1, name=None, **kw):
    """layers.accuracy: top-k accuracy of a softmax output against int
    labels."""
    topk_out, topk_idx = topk(input, k)
    acc, _, _ = _simple("accuracy",
                        {"Out": topk_out, "Indices": topk_idx, "Label": label},
                        n_out=3, dtype="float32",
                        out_slots=["Accuracy", "Correct", "Total"])
    return acc


def topk(input, k=1, name=None):
    vals, idx = _simple("top_k", {"X": input}, {"k": k}, n_out=2,
                        out_slots=["Out", "Indices"])
    idx.desc.dtype = _dt.int64
    return vals, idx


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant")
    out = out or helper.create_tmp(dtype=dtype, stop_gradient=True)
    helper.append_op("fill_constant", {}, {"Out": out},
                     {"shape": list(shape), "value": value,
                      "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))})
    return out
