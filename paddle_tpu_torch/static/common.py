"""Single-op layer functions of the static-graph API.

Counterpart of paddle_tpu/static/common.py (the reference's layers/ops.py,
layers/tensor.py and math_op_patch.py): thin wrappers over
`LayerHelper.append_simple`, every builder of the JAX package's module.
The sequence builders (`sequence_mask`, `sequence_conv`,
`sequence_pool`) take the dense [B, T, ...] + lengths form. A builder appends
the same op types, slot names and attrs as its JAX twin, so a program
built in either package is the same program.
"""
import builtins

import numpy as np

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import Variable
from paddle_tpu_torch.static.helper import LayerHelper


__all__ = ["relu", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt",
           "square", "abs", "ceil", "floor", "round", "reciprocal",
           "softsign", "softplus", "sin", "cos", "erf", "sign", "logsigmoid",
           "gelu", "leaky_relu", "elu", "relu6", "swish", "hard_sigmoid",
           "hard_swish", "softmax", "log_softmax", "pow", "clip",
           "label_smooth", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_min",
           "elementwise_max", "elementwise_mod", "elementwise_pow",
           "getitem", "matmul", "mul", "mean", "reduce_sum", "reduce_mean",
           "reduce_max", "reduce_min", "reduce_prod", "reduce_all",
           "reduce_any", "scale", "sums", "sum", "equal", "not_equal",
           "less_than", "less_equal", "greater_than", "greater_equal",
           "logical_and", "logical_or", "logical_xor", "logical_not",
           "isfinite", "cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "square_error_cost",
           "smooth_l1", "huber_loss", "kldiv_loss", "mse_loss", "accuracy",
           "auc", "topk", "reshape", "transpose", "concat", "split", "stack",
           "unstack", "squeeze", "unsqueeze", "slice", "strided_slice",
           "gather", "gather_nd", "scatter", "expand", "expand_as", "pad",
           "pad2d", "flatten", "cast", "fill_constant",
           "fill_constant_batch_size_like", "assign", "shape", "one_hot",
           "argmax", "argmin", "argsort", "where", "cumsum", "range",
           "linspace", "zeros", "ones", "zeros_like", "ones_like",
           "increment", "eye", "diag", "uniform_random", "gaussian_random",
           "sequence_mask", "sequence_conv", "sequence_pool"]


def _simple(op_type, inputs, attrs=None, n_out=1, dtype=None, out_slots=None):
    return LayerHelper(op_type).append_simple(inputs, attrs, n_out=n_out,
                                              dtype=dtype, out_slots=out_slots)


# --- activations / unary ---
def _make_unary(op_type):
    def fn(x, name=None):
        return _simple(op_type, {"X": x})
    fn.__name__ = op_type
    return fn


relu = _make_unary("relu")
sigmoid = _make_unary("sigmoid")
tanh = _make_unary("tanh")
exp = _make_unary("exp")
log = _make_unary("log")
sqrt = _make_unary("sqrt")
rsqrt = _make_unary("rsqrt")
square = _make_unary("square")
abs = _make_unary("abs")  # noqa: A001 - fluid name
ceil = _make_unary("ceil")
floor = _make_unary("floor")
round = _make_unary("round")  # noqa: A001
reciprocal = _make_unary("reciprocal")
softsign = _make_unary("softsign")
softplus = _make_unary("softplus")
sin = _make_unary("sin")
cos = _make_unary("cos")
erf = _make_unary("erf")
sign = _make_unary("sign")
logsigmoid = _make_unary("logsigmoid")


def gelu(x, approximate=False, name=None):
    return _simple("gelu", {"X": x}, {"approximate": approximate})


def leaky_relu(x, alpha=0.02, name=None):
    return _simple("leaky_relu", {"X": x}, {"alpha": alpha})


def elu(x, alpha=1.0, name=None):
    return _simple("elu", {"X": x}, {"alpha": alpha})


def relu6(x, threshold=6.0, name=None):
    return _simple("relu6", {"X": x}, {"threshold": threshold})


def swish(x, beta=1.0, name=None):
    return _simple("swish", {"X": x}, {"beta": beta})


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _simple("hard_sigmoid", {"X": x}, {"slope": slope, "offset": offset})


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _simple("hard_swish", {"X": x},
                   {"threshold": threshold, "scale": scale, "offset": offset})


def softmax(x, axis=-1, use_cudnn=False, name=None):
    return _simple("softmax", {"X": x}, {"axis": axis})


def log_softmax(x, axis=-1, name=None):
    return _simple("log_softmax", {"X": x}, {"axis": axis})


def pow(x, factor=1.0, name=None):  # noqa: A001
    return _simple("pow", {"X": x}, {"factor": factor})


def clip(x, min, max, name=None):  # noqa: A002
    return _simple("clip", {"X": x}, {"min": min, "max": max})


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    ins = {"X": label}
    if prior_dist is not None:
        ins["PriorDist"] = prior_dist
    return _simple("label_smooth", ins, {"epsilon": epsilon})


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


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act)


def _elementwise_binary(x, other, op_type, reverse=False):
    """Variable operator sugar: scalar operands lower to `scale`/`pow`
    (cheaper than materializing constants); Variable operands to
    elementwise ops. (fluid layers/math_op_patch.py parity.)"""
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


def getitem(x, idx):
    """x[...] subscript sugar → getitem op."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    spec = []
    for it in idx:
        # the fluid-parity layer `slice` below shadows the builtin here
        if isinstance(it, builtins.slice):
            spec.append(("slice", it.start, it.stop, it.step))
        elif it is Ellipsis:
            spec.append(("ellipsis",))
        elif it is None:
            spec.append(("none",))
        else:
            spec.append(("int", int(it)))
    return _simple("getitem", {"X": x}, {"slices": spec})


# --- matmul & reductions ---

def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return _simple("matmul", {"X": x, "Y": y},
                   {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                    "alpha": alpha})


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _simple("mul", {"X": x, "Y": y},
                   {"x_num_col_dims": x_num_col_dims,
                    "y_num_col_dims": y_num_col_dims})


def mean(x, name=None):
    return _simple("mean", {"X": x})


def _make_reduce(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        return _simple(op_type, {"X": input},
                       {"dim": dim, "keep_dim": keep_dim,
                        "reduce_all": dim is None})
    fn.__name__ = op_type
    return fn


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")
reduce_max = _make_reduce("reduce_max")
reduce_min = _make_reduce("reduce_min")
reduce_prod = _make_reduce("reduce_prod")
reduce_all = _make_reduce("reduce_all")
reduce_any = _make_reduce("reduce_any")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = _simple("scale", {"X": x}, {"scale": scale, "bias": bias,
                                      "bias_after_scale": bias_after_scale})
    if act:
        out = _simple(act, {"X": out})
    return out


def sums(input, name=None):
    return _simple("sum", {"X": list(input)})


def sum(x, name=None):  # noqa: A001
    return sums(x) if isinstance(x, (list, tuple)) else reduce_sum(x)


# --- comparisons ---

def _make_compare(op_type):
    def fn(x, y, name=None, cond=None):
        return _simple(op_type, {"X": x, "Y": y}, dtype="bool")
    fn.__name__ = op_type
    return fn


equal = _make_compare("equal")
not_equal = _make_compare("not_equal")
less_than = _make_compare("less_than")
less_equal = _make_compare("less_equal")
greater_than = _make_compare("greater_than")
greater_equal = _make_compare("greater_equal")
logical_and = _make_compare("logical_and")
logical_or = _make_compare("logical_or")
logical_xor = _make_compare("logical_xor")


def logical_not(x, name=None):
    return _simple("logical_not", {"X": x}, dtype="bool")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths [B] → mask [B, maxlen] (maxlen must be static)."""
    return _simple("sequence_mask", {"X": x},
                   {"maxlen": maxlen, "out_dtype": _dt.dtype_name(dtype)},
                   dtype=dtype, out_slots=["Y"])


def isfinite(x, name=None):
    return _simple("isfinite", {"X": x}, dtype="bool")


# --- losses ---

def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    return _simple("cross_entropy", {"X": input, "Label": label},
                   {"soft_label": soft_label, "ignore_index": ignore_index},
                   out_slots=["Y"])


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False,
                               name=None):
    sm, loss = _simple("softmax_with_cross_entropy",
                       {"Logits": logits, "Label": label},
                       {"soft_label": soft_label, "axis": axis,
                        "ignore_index": ignore_index},
                       n_out=2, out_slots=["Softmax", "Loss"])
    return (loss, sm) if return_softmax else loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    return _simple("sigmoid_cross_entropy_with_logits",
                   {"X": x, "Label": label},
                   {"ignore_index": ignore_index, "normalize": normalize})


def square_error_cost(input, label, name=None):
    return _simple("square_error_cost", {"X": input, "Y": label})


def smooth_l1(x, y, sigma=1.0, name=None):
    _, out = _simple("smooth_l1_loss", {"X": x, "Y": y}, {"sigma": sigma},
                     n_out=2, out_slots=["Diff", "Out"])
    return out


def huber_loss(input, label, delta=1.0, name=None):
    _, out = _simple("huber_loss", {"X": input, "Y": label}, {"delta": delta},
                     n_out=2, out_slots=["Residual", "Out"])
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    return _simple("kldiv_loss", {"X": x, "Target": target},
                   {"reduction": reduction}, out_slots=["Loss"])


def mse_loss(input, label, name=None):
    return _simple("mse_loss", {"X": input, "Y": label})


# --- metrics ---

def accuracy(input, label, k=1, name=None, **kw):
    """layers.accuracy: top-k accuracy of softmax output vs int label."""
    topk_out, topk_idx = topk(input, k)
    acc, _, _ = _simple("accuracy",
                        {"Out": topk_out, "Indices": topk_idx, "Label": label},
                        n_out=3, dtype="float32",
                        out_slots=["Accuracy", "Correct", "Total"])
    return acc


def auc(input, label, num_thresholds=4095, topk=1, slide_steps=1, name=None):
    """layers.auc: streaming AUC with persistable histogram state."""
    from paddle_tpu_torch.utils.initializer import Constant
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    helper = LayerHelper("auc")
    pos = helper.create_parameter(
        ParamAttr(name=None, initializer=Constant(0.0), trainable=False),
        [num_thresholds + 1], "float32")
    neg = helper.create_parameter(
        ParamAttr(name=None, initializer=Constant(0.0), trainable=False),
        [num_thresholds + 1], "float32")
    pos.stop_gradient = True
    neg.stop_gradient = True
    out = helper.create_tmp(dtype="float32", stop_gradient=True)
    helper.append_op("auc",
                     {"Predict": input, "Label": label, "StatPos": pos,
                      "StatNeg": neg},
                     {"AUC": out, "StatPosOut": pos, "StatNegOut": neg}, {})
    return out, [pos, neg]


def topk(input, k=1, name=None):
    vals, idx = _simple("top_k", {"X": input}, {"k": k}, n_out=2,
                        out_slots=["Out", "Indices"])
    idx.desc.dtype = _dt.int64
    return vals, idx


# --- tensor manipulation ---

def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    out = _simple("reshape", {"X": x}, {"shape": list(shape)})
    if act:
        out = _simple(act, {"X": out})
    return out


def transpose(x, perm, name=None):
    return _simple("transpose", {"X": x}, {"axis": list(perm)})


def concat(input, axis=0, name=None):
    return _simple("concat", {"X": list(input)}, {"axis": axis})


def split(input, num_or_sections, dim=-1, name=None):
    nd = len(input.shape)
    dim = dim if dim >= 0 else dim + nd
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    helper = LayerHelper("split")
    outs = [helper.create_tmp(dtype=input.dtype)
            for _ in builtins.range(n)]
    helper.append_op("split", {"X": input}, {"Out": [o.name for o in outs]},
                     attrs)
    return outs


def stack(x, axis=0, name=None):
    return _simple("stack", {"X": list(x)}, {"axis": axis})


def unstack(x, axis=0, num=None, name=None):
    n = num or x.shape[axis]
    helper = LayerHelper("unstack")
    outs = [helper.create_tmp(dtype=x.dtype)
            for _ in builtins.range(n)]
    helper.append_op("unstack", {"X": x}, {"Out": [o.name for o in outs]},
                     {"axis": axis})
    return outs


def squeeze(input, axes=None, name=None):
    return _simple("squeeze", {"X": input}, {"axes": axes})


def unsqueeze(input, axes, name=None):
    return _simple("unsqueeze", {"X": input}, {"axes": list(axes)})


def slice(input, axes, starts, ends, name=None):  # noqa: A001
    return _simple("slice", {"X": input},
                   {"axes": list(axes), "starts": list(starts),
                    "ends": list(ends)})


def strided_slice(input, axes, starts, ends, strides, name=None):
    return _simple("strided_slice", {"X": input},
                   {"axes": list(axes), "starts": list(starts),
                    "ends": list(ends), "strides": list(strides)})


def gather(input, index, name=None):
    return _simple("gather", {"X": input, "Index": index})


def gather_nd(input, index, name=None):
    return _simple("gather_nd", {"X": input, "Index": index})


def scatter(input, index, updates, overwrite=True, name=None):
    return _simple("scatter", {"X": input, "Ids": index, "Updates": updates},
                   {"overwrite": overwrite})


def expand(x, expand_times, name=None):
    return _simple("expand", {"X": x}, {"expand_times": list(expand_times)})


def expand_as(x, target_tensor, name=None):
    return _simple("expand_as", {"X": x, "Y": target_tensor})


def pad(x, paddings, pad_value=0.0, name=None):
    return _simple("pad", {"X": x}, {"paddings": list(paddings),
                                     "pad_value": pad_value})


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _simple("pad2d", {"X": input},
                   {"paddings": list(paddings), "mode": mode,
                    "pad_value": pad_value})


def flatten(x, axis=1, name=None):
    return _simple("flatten", {"X": x}, {"axis": axis})


def cast(x, dtype):
    return _simple("cast", {"X": x}, {"out_dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))},
                   dtype=dtype)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant")
    out = out or helper.create_tmp(dtype=dtype, stop_gradient=True)
    helper.append_op("fill_constant", {}, {"Out": out},
                     {"shape": list(shape), "value": value,
                      "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    return _simple("fill_constant_batch_size_like", {"Input": input},
                   {"shape": list(shape), "value": value,
                    "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype)),
                    "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx}, dtype=dtype)


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        output = output or helper.create_tmp(dtype=input.dtype)
        helper.append_op("assign", {"X": input}, {"Out": output})
    else:
        arr = np.asarray(input)
        output = output or helper.create_tmp(dtype=arr.dtype)
        helper.append_op("assign_value", {}, {"Out": output},
                         {"shape": list(arr.shape),
                          "values": arr.reshape(-1).tolist(),
                          "dtype": _dt.dtype_name(arr.dtype)})
    return output


def shape(input):
    return _simple("shape", {"Input": input}, dtype="int32")


def one_hot(input, depth, allow_out_of_range=False):
    return _simple("one_hot", {"X": input}, {"depth": depth}, dtype="float32")


def argmax(x, axis=-1, name=None):
    return _simple("arg_max", {"X": x}, {"axis": axis}, dtype="int64")


def argmin(x, axis=-1, name=None):
    return _simple("arg_min", {"X": x}, {"axis": axis}, dtype="int64")


def argsort(input, axis=-1, descending=False, name=None):
    vals, idx = _simple("argsort", {"X": input},
                        {"axis": axis, "descending": descending},
                        n_out=2, out_slots=["Out", "Indices"])
    idx.desc.dtype = _dt.int64
    return vals, idx


def where(condition, x=None, y=None, name=None):
    """Two forms like fluid: where(cond, x, y) selects elementwise;
    where(cond) returns indices of true elements. XLA needs static shapes,
    so the index form returns a FIXED-size [cond.size, ndim] int64 array
    padded with -1 rows (the reference returns a variable-length tensor)."""
    if x is None and y is None:
        return _simple("where_index", {"Condition": condition}, dtype="int64")
    enforce(x is not None and y is not None,
            "where() needs both x and y (or neither)")
    return _simple("where", {"Condition": condition, "X": x, "Y": y},
                   dtype=x.dtype)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    return _simple("cumsum", {"X": x}, {"axis": axis, "exclusive": exclusive,
                                        "reverse": reverse})


def range(start, end, step, dtype, name=None):  # noqa: A001
    return _simple("range", {}, {"start": start, "end": end, "step": step,
                                 "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))},
                   dtype=dtype)


def linspace(start, stop, num, dtype="float32", name=None):
    return _simple("linspace", {}, {"start": start, "stop": stop, "num": num,
                                    "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))},
                   dtype=dtype)


def zeros(shape, dtype="float32", force_cpu=False, name=None):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False, name=None):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None, name=None):
    return _simple("zeros_like", {"X": x})


def ones_like(x, out=None, name=None):
    return _simple("ones_like", {"X": x})


def increment(x, value=1.0, in_place=True, name=None):
    helper = LayerHelper("increment")
    if in_place:
        helper.append_op("increment", {"X": x}, {"Out": x}, {"step": value})
        return x
    return _simple("increment", {"X": x}, {"step": value})


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    return _simple("eye", {}, {"num_rows": num_rows,
                               "num_columns": num_columns or num_rows,
                               "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))},
                   dtype=dtype)


def diag(diagonal, name=None):
    return _simple("diag", {"Diagonal": diagonal})


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,  # noqa: A002
                   name=None):
    return _simple("uniform_random", {},
                   {"shape": list(shape), "min": min, "max": max, "seed": seed,
                    "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))},
                   dtype=dtype)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return _simple("gaussian_random", {},
                   {"shape": list(shape), "mean": mean, "std": std,
                    "seed": seed,
                    "dtype": _dt.dtype_name(_dt.normalize_dtype(dtype))},
                   dtype=dtype)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, lengths=None, param_attr=None,
                  bias_attr=None, act=None, name=None):
    """sequence_conv over dense [B, T, D] (+ lengths): a context window of
    filter_size around each step, one [filter_size * D, num_filters]
    filter."""
    helper = LayerHelper("sequence_conv")
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [filter_size * d, num_filters],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    inputs = {"X": input, "Filter": w}
    if b is not None:
        inputs["Bias"] = b
    if lengths is not None:
        inputs["Length"] = lengths
    out = helper.create_tmp(dtype=input.dtype)
    helper.append_op("sequence_conv", inputs, {"Out": out},
                     {"context_length": filter_size})
    if act:
        out = _simple(act, {"X": out})
    return out


def sequence_pool(input, pool_type="max", lengths=None, is_test=False,
                  name=None, _warn_missing_lengths=True):
    """sequence_pool over dense [B, T, ...] + lengths. Without lengths
    every row is full length T (a static T is then required), with a
    warning: the reference's LoD input is mandatory."""
    helper = LayerHelper("sequence_pool")
    if lengths is None:
        import warnings
        if _warn_missing_lengths:
            warnings.warn(
                "sequence_pool called without lengths=: treating every "
                "row as full length T (the reference's LoD input is "
                "mandatory; pass lengths= for ragged batches)",
                stacklevel=2)
        b, t = input.shape[0], input.shape[1]
        enforce(b is not None and b > 0 and t is not None and t > 0,
                "sequence_pool without lengths= needs static batch AND "
                "time dims (pass lengths otherwise)")
        lengths = fill_constant([b], "int64", t)
    out, _ = helper.append_simple(
        {"X": input, "Length": lengths}, {"pooltype": pool_type.upper()},
        n_out=2, out_slots=["Out", "MaxIndex"], op_type="sequence_pool")
    return out
