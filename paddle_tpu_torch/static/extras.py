"""The long-tail fluid.layers surface.

Counterpart of paddle_tpu/static/extras.py: thin builders over
ops/misc.py, ops/text.py, ops/ctr.py, ops/fused.py, ops/sequence.py,
ops/vision.py and the conv / norm / rnn ops, each with fluid's signature
(layers/nn.py, contrib/layers/nn.py, contrib/layers/rnn_impl.py) and the
LoD arguments as dense tensors plus optional lengths (a missing `lengths`
means every row is full length). A builder appends the same op types,
slot names and attrs as its JAX twin, so a program built in either
package is the same program.

As in the JAX package, `im2sequence` takes `padding` and does not pass
it on: the op pads nothing ("VALID"), where Fluid's pads (ROADMAP
Queue 3). `py_func` and `Print` register a host-callback op when the
program is built; the Executor runs it eagerly, so `py_func` reads its
inputs on the host (a device synchronisation on the card) and `Print`
prints the tensor. `BasicGRUUnit` and `BasicLSTMUnit` are eager cells
(nn.Layer) whose weights are made on first call, on `device` (None
means CUDA). `switch_moe` comes with the parallelism slice (ROADMAP
Queue 1 item 15).
"""
import numpy as np
import torch

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import (default_main_program,
                                      default_startup_program, unique_name)
from paddle_tpu_torch.core.registry import has_op, register_op
from paddle_tpu_torch.static.common import _simple, concat, elementwise_add, \
    fill_constant, getitem, sequence_pool
from paddle_tpu_torch.static.helper import LayerHelper
from paddle_tpu_torch.utils.initializer import Constant
from paddle_tpu_torch.utils.param_attr import ParamAttr

__all__ = [
    "brelu", "soft_relu", "selu", "stanh", "maxout", "lrn", "conv3d",
    "pool3d", "row_conv", "affine_channel", "instance_norm", "grid_sampler",
    "im2sequence", "pixel_shuffle", "temporal_shift", "image_resize",
    "resize_bilinear", "resize_nearest", "clip_by_norm", "l2_normalize",
    "cos_sim", "log_loss", "rank_loss", "margin_rank_loss", "bpr_loss",
    "dice_loss", "npair_loss", "teacher_student_sigmoid_loss", "fsp_matrix",
    "multiplex", "scatter_nd_add", "scatter_nd", "shard_index",
    "space_to_depth", "shuffle_channel", "unfold", "crop_tensor", "crop",
    "pad_constant_like", "reverse", "add_position_encoding",
    "bilinear_tensor_product", "gather_tree",
    "gaussian_random_batch_size_like", "uniform_random_batch_size_like",
    "mean_iou", "edit_distance", "ctc_greedy_decoder", "has_inf", "has_nan",
    "is_empty", "size", "rank", "sequence_softmax", "sequence_reverse",
    "sequence_concat", "sequence_expand", "sequence_expand_as",
    "sequence_pad", "sequence_unpad", "sequence_slice",
    "sequence_first_step", "sequence_last_step", "sequence_enumerate",
    "sequence_scatter", "sequence_reshape", "create_tensor",
    "create_global_var", "create_parameter", "autoincreased_step_counter",
    "py_func", "Print", "elementwise_floordiv", "sampling_id",
    "conv3d_transpose", "lstm", "image_resize_short", "hash", "random_crop",
    "array_length", "tensor_array_to_tensor", "affine_grid",
    "spectral_norm", "center_loss", "data_norm", "similarity_focus",
    "filter_by_instag", "chunk_eval", "psroi_pool", "prroi_pool",
    "deformable_conv", "deformable_roi_pooling", "var_conv_2d",
    "match_matrix_tensor", "tree_conv", "sequence_topk_avg_pooling",
    "fused_embedding_seq_pool", "fused_elemwise_activation",
    "search_pyramid_hash", "multiclass_nms2", "basic_gru", "basic_lstm",
    "BasicGRUUnit", "BasicLSTMUnit"]


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _act(out, act):
    return _simple(act, {"X": out}) if act else out


# --------------------------------------------------------- activations
def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _simple("brelu", {"X": x}, {"t_min": t_min, "t_max": t_max})


def soft_relu(x, threshold=40.0, name=None):
    return _simple("soft_relu", {"X": x}, {"threshold": threshold})


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _simple("selu", {"X": x}, attrs)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _simple("stanh", {"X": x},
                   {"scale_a": scale_a, "scale_b": scale_b})


def maxout(x, groups, name=None, axis=1):
    return _simple("maxout", {"X": x}, {"groups": groups})


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    return _simple("lrn", {"X": input},
                   {"n": n, "k": k, "alpha": alpha, "beta": beta})


# ---------------------------------------------------------- conv / vision
def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d")
    fd, fh, fw = _triple(filter_size)
    w = helper.create_parameter(
        param_attr, [num_filters, input.shape[1] // groups, fd, fh, fw],
        input.dtype)
    out = helper.create_tmp(dtype=input.dtype)
    ins = {"Input": input, "Filter": w}
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        ins["Bias"] = b
    helper.append_op("conv3d", ins, {"Output": out},
                     {"strides": _triple(stride), "paddings": _triple(padding),
                      "dilations": _triple(dilation), "groups": groups})
    return _act(out, act)


def pool3d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, exclusive=True, name=None):
    return _simple("pool3d", {"X": input},
                   {"ksize": _triple(pool_size), "pooling_type": pool_type,
                    "strides": _triple(pool_stride or pool_size),
                    "paddings": _triple(pool_padding),
                    "global_pooling": global_pooling,
                    "exclusive": exclusive})


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv")
    w = helper.create_parameter(param_attr, [future_context_size + 1,
                                             input.shape[-1]], input.dtype)
    out = helper.create_tmp(dtype=input.dtype)
    helper.append_op("row_conv", {"X": input, "Filter": w}, {"Out": out}, {})
    return _act(out, act)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    return _act(_simple("affine_channel", {"X": x, "Scale": scale,
                                           "Bias": bias}), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm")
    c = input.shape[1]
    scale = helper.create_parameter(param_attr, [c], input.dtype)
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
    out, _, _ = helper.append_simple(
        {"X": input, "Scale": scale, "Bias": bias}, {"epsilon": epsilon},
        n_out=3, out_slots=["Y", "SavedMean", "SavedVariance"],
        op_type="instance_norm")
    return out


def grid_sampler(x, grid, name=None):
    return _simple("grid_sampler", {"X": x, "Grid": grid},
                   out_slots=["Output"])


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """layers/nn.py im2sequence: [N*oh*ow, C*kh*kw] patches. `padding`
    is taken and not passed on, as in the JAX package: the op pads
    nothing (ROADMAP Queue 3)."""
    return _simple("im2sequence", {"X": input},
                   {"kernels": _pair(filter_size), "strides": _pair(stride)})


def pixel_shuffle(x, upscale_factor):
    return _simple("pixel_shuffle", {"X": x},
                   {"upscale_factor": upscale_factor})


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _simple("temporal_shift", {"X": x},
                   {"seg_num": seg_num, "shift_ratio": shift_ratio})


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=False, align_mode=1,
                 data_format="NCHW"):
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    modes = {"BILINEAR": "bilinear", "NEAREST": "nearest"}
    enforce(resample.upper() in modes,
            "image_resize supports BILINEAR/NEAREST, got %r", resample)
    return _simple("interpolate", {"X": input},
                   {"out_h": out_shape[0], "out_w": out_shape[1],
                    "interp_method": modes[resample.upper()]})


def resize_bilinear(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def resize_nearest(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, name, "NEAREST")


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    h, w = input.shape[2], input.shape[3]
    scale = out_short_len / min(h, w)
    return image_resize(input, [int(round(h * scale)),
                                int(round(w * scale))], resample=resample)


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d_transpose")
    fd, fh, fw = _triple(filter_size)
    w = helper.create_parameter(param_attr, [input.shape[1], num_filters, fd,
                                             fh, fw], input.dtype)
    out = helper.create_tmp(dtype=input.dtype)
    ins = {"Input": input, "Filter": w}
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        ins["Bias"] = b
    helper.append_op("conv3d_transpose", ins, {"Output": out},
                     {"strides": _triple(stride),
                      "paddings": _triple(padding)})
    return _act(out, act)


# ------------------------------------------------------------- norms/sim
def clip_by_norm(x, max_norm, name=None):
    return _simple("clip_by_norm", {"X": x}, {"max_norm": max_norm})


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    return _simple("l2_normalize", {"X": x},
                   {"axis": axis, "epsilon": epsilon})


def cos_sim(X, Y):
    return _simple("cos_sim", {"X": X, "Y": Y})


# ----------------------------------------------------------------- losses
def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple("log_loss", {"Predicted": input, "Labels": label},
                   {"epsilon": epsilon}, out_slots=["Loss"])


def rank_loss(label, left, right, name=None):
    return _simple("rank_loss", {"Label": label, "Left": left,
                                 "Right": right})


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    out, _ = _simple("margin_rank_loss",
                     {"Label": label, "X1": left, "X2": right},
                     {"margin": margin}, n_out=2,
                     out_slots=["Out", "Activated"])
    return out


def bpr_loss(input, label, name=None):
    return _simple("bpr_loss", {"X": input, "Label": label},
                   out_slots=["Loss"])


def dice_loss(input, label, epsilon=1e-5):
    return _simple("dice_loss", {"X": input, "Label": label},
                   {"epsilon": epsilon})


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return _simple("npair_loss", {"Anchor": anchor, "Positive": positive,
                                  "Labels": labels}, {"l2_reg": l2_reg})


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _simple("teacher_student_sigmoid_loss",
                   {"X": input, "Label": label},
                   {"soft_max_up_bound": soft_max_up_bound,
                    "soft_max_lower_bound": soft_max_lower_bound},
                   out_slots=["Y"])


def fsp_matrix(x, y):
    return _simple("fsp", {"X": x, "Y": y})


# ----------------------------------------------------------------- tensor
def multiplex(inputs, index):
    return _simple("multiplex", {"X": list(inputs), "Ids": index})


def scatter_nd_add(ref, index, updates, name=None):
    return _simple("scatter_nd_add",
                   {"X": ref, "Index": index, "Updates": updates})


def scatter_nd(index, updates, shape, name=None):
    return _simple("scatter_nd", {"Index": index, "Updates": updates},
                   {"shape": list(shape)})


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _simple("shard_index", {"X": input},
                   {"index_num": index_num, "nshards": nshards,
                    "shard_id": shard_id, "ignore_value": ignore_value})


def space_to_depth(x, blocksize, name=None):
    return _simple("space_to_depth", {"X": x}, {"blocksize": blocksize})


def shuffle_channel(x, group, name=None):
    return _simple("shuffle_channel", {"X": x}, {"group": group})


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _simple("unfold", {"X": x},
                   {"kernel_sizes": _pair(kernel_sizes),
                    "strides": _pair(strides), "paddings": _pair(paddings),
                    "dilations": _pair(dilations)}, out_slots=["Y"])


def crop_tensor(x, shape=None, offsets=None, name=None):
    return _simple("crop_tensor", {"X": x},
                   {"shape": list(shape),
                    "offsets": list(offsets or [0] * len(x.shape))})


crop = crop_tensor


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple("pad_constant_like", {"X": x, "Y": y},
                   {"pad_value": pad_value})


def reverse(x, axis):
    return _simple("reverse", {"X": x},
                   {"axis": axis if isinstance(axis, (list, tuple))
                    else [axis]})


def add_position_encoding(input, alpha, beta, name=None):
    return _simple("add_position_encoding", {"X": input},
                   {"alpha": alpha, "beta": beta})


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product")
    w = helper.create_parameter(param_attr,
                                [size, x.shape[-1], y.shape[-1]], x.dtype)
    ins = {"X": x, "Y": y, "Weight": w}
    b = helper.create_parameter(bias_attr, [size], x.dtype, is_bias=True)
    if b is not None:
        ins["Bias"] = b
    out = helper.create_tmp(dtype=x.dtype)
    helper.append_op("bilinear_tensor_product", ins, {"Out": out}, {})
    return _act(out, act)


def gather_tree(ids, parents):
    return _simple("gather_tree", {"Ids": ids, "Parents": parents},
                   dtype="int32")


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _simple("gaussian_random_batch_size_like", {"Input": input},
                   {"shape": list(shape), "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx, "mean": mean,
                    "std": std}, dtype=dtype)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):  # noqa: A002
    return _simple("uniform_random_batch_size_like", {"Input": input},
                   {"shape": list(shape), "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx, "min": min,
                    "max": max}, dtype=dtype)


def random_crop(x, shape, seed=None):
    return _simple("random_crop", {"X": x}, {"shape": list(shape)})


def hash(input, hash_size, num_hash=1, name=None):  # noqa: A001
    return _simple("hash", {"X": input},
                   {"mod_by": hash_size, "num_hash": num_hash},
                   dtype="int32")


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _simple("elementwise_floordiv", {"X": x, "Y": y}, {"axis": axis})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):  # noqa: A002
    return _simple("sampling_id", {"X": x}, dtype=dtype)


# ------------------------------------------------------ metrics/decoding
def mean_iou(input, label, num_classes):
    return _simple("mean_iou", {"Predictions": input, "Labels": label},
                   {"num_classes": num_classes}, n_out=3,
                   out_slots=["OutMeanIou", "OutWrong", "OutCorrect"])


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    ins = {"Hyps": input, "Refs": label}
    if input_length is not None:
        ins["HypsLength"] = input_length
    if label_length is not None:
        ins["RefsLength"] = label_length
    return _simple("edit_distance", ins, {"normalized": normalized},
                   n_out=2, out_slots=["Out", "SequenceNum"])


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=-1,
                       name=None):
    ins = {"Input": input}
    if input_length is not None:
        ins["Length"] = input_length
    return _simple("ctc_greedy_decoder", ins, {"blank": blank},
                   n_out=2, out_slots=["Out", "OutLength"])


def has_inf(x):
    return _simple("has_inf", {"X": x}, dtype="bool")


def has_nan(x):
    return _simple("has_nan", {"X": x}, dtype="bool")


def is_empty(x, name=None):
    return _simple("is_empty", {"X": x}, dtype="bool")


def size(input):  # noqa: A001 - fluid name
    return _simple("size", {"Input": input}, dtype="int32")


def rank(input):
    return fill_constant([1], "int32", len(input.shape))


def _full_lengths(x, t):
    return fill_constant([x.shape[0]], "int64", t)


def sequence_softmax(input, lengths=None, use_cudnn=False, name=None):
    if lengths is None:
        lengths = _full_lengths(input, input.shape[1])
    return _simple("sequence_softmax", {"X": input, "Length": lengths})


def sequence_reverse(x, lengths=None, name=None):
    if lengths is None:
        lengths = _full_lengths(x, x.shape[1])
    return _simple("sequence_reverse", {"X": x, "Length": lengths},
                   out_slots=["Y"])


def sequence_concat(input, name=None):
    return _simple("sequence_concat", {"X": list(input)})


def sequence_expand(x, y, ref_level=-1, lengths=None, name=None):
    if lengths is None:
        lengths = _full_lengths(x, y.shape[1])
    return _simple("sequence_expand",
                   {"X": x, "Y": y, "RefLength": lengths})


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_pad(x, pad_value=None, maxlen=None, lengths=None, name=None):
    if lengths is None:
        lengths = _full_lengths(x, x.shape[1])
    out, ln = _simple("sequence_pad", {"X": x, "Length": lengths},
                      {"pad_value": 0.0 if pad_value is None
                       else float(pad_value)},
                      n_out=2, out_slots=["Out", "SeqLength"])
    return out, ln


def sequence_unpad(x, length, name=None):
    return _simple("sequence_unpad", {"X": x, "Length": length})


def sequence_slice(input, offset, length, name=None):
    return _simple("sequence_slice",
                   {"X": input, "Offset": offset, "Length": length})


def sequence_first_step(input, lengths=None):
    return sequence_pool(input, "first", lengths=lengths)


def sequence_last_step(input, lengths=None):
    return sequence_pool(input, "last", lengths=lengths)


def sequence_enumerate(input, win_size, pad_value=0, lengths=None, name=None):
    ins = {"X": input}
    if lengths is not None:
        ins["Length"] = lengths
    return _simple("sequence_enumerate", ins,
                   {"win_size": win_size, "pad_value": pad_value})


def sequence_scatter(input, index, updates, lengths=None, name=None):
    ins = {"X": input, "Ids": index, "Updates": updates}
    if lengths is not None:
        ins["Length"] = lengths
    return _simple("sequence_scatter", ins)


def sequence_reshape(input, new_dim):
    return _simple("sequence_reshape", {"X": input}, {"new_dim": new_dim})


# ------------------------------------------------------ framework utils
def create_tensor(dtype, name=None, persistable=False):
    return default_main_program().global_block().create_var(
        name=name or unique_name("tensor"), dtype=dtype,
        persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A var of the main program that the startup program fills with
    `value`."""
    name = name or unique_name("global_var")
    v = default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, persistable=persistable)
    sb = default_startup_program().global_block()
    if not sb.has_var(name):
        sb.create_var(name=name, shape=shape, dtype=dtype,
                      persistable=persistable)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": list(shape), "value": value, "dtype": dtype})
    return v


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter")
    return helper.create_parameter(attr or ParamAttr(name=name), list(shape),
                                   dtype, is_bias, default_initializer)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable step counter (layers/nn.py): each run of the
    program adds `step`, the first run reads `begin`."""
    from paddle_tpu_torch.static.common import assign, increment
    v = create_global_var([1], float(begin - step), "float32",
                          persistable=True,
                          name=counter_name or "step_counter")
    assign(increment(v, value=step), v)
    return v


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """layers/nn.py py_func: `func` runs on the host, on the inputs as
    numpy arrays, its results shaped as `out` (a host read of the inputs
    and a copy of the results to the executor's device)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    tag = f"py_func_{id(func)}"
    if not has_op(tag):
        specs = [(tuple(o.shape), _dt.normalize_dtype(o.dtype))
                 for o in outs]

        @register_op(tag, inputs=["X[]"], outputs=["Out[]"])
        def _impl(ctx, vals):
            if ctx.device.type == "meta":
                return ([torch.empty(s, dtype=d, device="meta")
                         for s, d in specs],)
            res = func(*[v.detach().cpu().numpy() for v in vals])
            res = [res] if len(specs) == 1 else list(res)
            return ([torch.as_tensor(np.asarray(r)).to(ctx.device, d)
                     for r, (_, d) in zip(res, specs)],)

    LayerHelper(tag).append_op(tag, {"X": list(xs)},
                               {"Out": [o.name for o in outs]}, {})
    return out


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """fluid.layers.Print: the op prints its message and the tensor when
    the Executor runs it, and passes the tensor on."""
    if not has_op("print"):
        @register_op("print", inputs=["X"], outputs=["Out"])
        def _impl(ctx, x):
            if ctx.device.type != "meta":
                print((ctx.attr("message") or "") + " " + str(x))
            return x

    return _simple("print", {"X": input}, {"message": message or ""})


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """fluid.layers.lstm (cudnn_lstm_op.cu): a stacked LSTM on [B, T, D];
    returns (rnn_out, last_h, last_c). Each layer and direction is an fc
    input projection and a dynamic_lstm (no flat cuDNN weight), dropout
    between layers when training, as in the JAX package."""
    from paddle_tpu_torch.static import nn as _nn
    from paddle_tpu_torch.static.rnn import dynamic_lstm
    ndir = 2 if is_bidirec else 1

    def _init_state(init, layer, direction):
        """fluid's init_h / init_c [num_layers * ndir, B, H]; a [B, H]
        tensor seeds layer 0's forward direction only."""
        if init is None:
            return None
        if len(init.shape) == 2:
            return init if (layer == 0 and direction == 0) else None
        return getitem(init, layer * ndir + direction)

    h = input
    outs_f = outs_b = None
    for layer in range(num_layers):
        if layer > 0 and dropout_prob > 0.0 and not is_test:
            h = _nn.dropout(h, dropout_prob)
        proj_f = _nn.fc(h, 4 * hidden_size, num_flatten_dims=2)
        fwd, c_f = dynamic_lstm(proj_f, 4 * hidden_size, use_peepholes=False,
                                h_0=_init_state(init_h, layer, 0),
                                c_0=_init_state(init_c, layer, 0))
        outs_f = (fwd, c_f)
        if is_bidirec:
            proj_b = _nn.fc(h, 4 * hidden_size, num_flatten_dims=2)
            bwd, c_b = dynamic_lstm(proj_b, 4 * hidden_size,
                                    use_peepholes=False, is_reverse=True,
                                    h_0=_init_state(init_h, layer, 1),
                                    c_0=_init_state(init_c, layer, 1))
            h = concat([fwd, bwd], axis=2)
            outs_b = (bwd, c_b)
        else:
            h = fwd

    def _last(seq):                    # the forward direction's end
        return sequence_pool(seq, "last", _warn_missing_lengths=False)

    def _first(seq):                   # the reverse one ends at t = 0
        return sequence_pool(seq, "first", _warn_missing_lengths=False)

    if is_bidirec:
        last_h = concat([_last(outs_f[0]), _first(outs_b[0])], axis=1)
        last_c = concat([_last(outs_f[1]), _first(outs_b[1])], axis=1)
    else:
        last_h, last_c = _last(outs_f[0]), _last(outs_f[1])
    return h, last_h, last_c


def array_length(array):
    return fill_constant([1], "int64", array.shape[0])


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """A dense tensor array is already a [T, ...] tensor: stacking is the
    identity, concatenating folds T into `axis`."""
    if use_stack:
        return input, array_length(input)
    parts = [_simple("getitem", {"X": input}, {"slices": [["int", i]]})
             for i in range(input.shape[0])]
    return (concat(parts, axis=axis - 1 if axis > 0 else axis),
            array_length(input))


# ------------------------------------------------------------ vision ops
def affine_grid(theta, out_shape, name=None):
    """layers/nn.py:11687. out_shape: a list [N, C, H, W] or an integer
    Variable holding it (a build-time constant)."""
    ins = {"Theta": theta}
    attrs = {}
    if isinstance(out_shape, (list, tuple)):
        attrs["output_shape"] = [int(v) for v in out_shape]
    else:
        ins["OutputShape"] = out_shape
    return _simple("affine_grid", ins, attrs)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    """layers/nn.py:16300; rois [R, 5] with a leading batch index."""
    return _simple("psroi_pool", {"X": input, "ROIs": rois},
                   {"output_channels": output_channels,
                    "spatial_scale": spatial_scale,
                    "pooled_height": pooled_height,
                    "pooled_width": pooled_width})


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, name=None):
    """layers/nn.py:16366; rois [R, 5] with a leading batch index."""
    return _simple("prroi_pool", {"X": input, "ROIs": rois},
                   {"spatial_scale": spatial_scale,
                    "pooled_height": pooled_height,
                    "pooled_width": pooled_width})


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=None, param_attr=None,
                    bias_attr=None, modulated=True, name=None):
    """layers/nn.py:16931 (v2 when modulated, v1 otherwise)."""
    helper = LayerHelper("deformable_conv")
    c_in = input.shape[1]
    fh, fw = _pair(filter_size)
    w = helper.create_parameter(param_attr,
                                [num_filters, c_in // (groups or 1), fh, fw],
                                input.dtype)
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups or 1,
             "deformable_groups": deformable_groups or 1}
    if modulated:
        out = _simple("deformable_conv",
                      {"Input": input, "Offset": offset, "Mask": mask,
                       "Filter": w}, attrs, out_slots=["Output"])
    else:
        out = _simple("deformable_conv_v1",
                      {"Input": input, "Offset": offset, "Filter": w},
                      attrs, out_slots=["Output"])
    b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                is_bias=True)
    if b is not None:
        out = elementwise_add(out, b, axis=1)
    return out


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    """layers/nn.py:17272. position_sensitive groups the input channels
    (output_dim = C / (gh gw)); otherwise group_size is (1, 1) and
    output_dim = C."""
    gh, gw = group_size if isinstance(group_size, (list, tuple)) else (
        group_size, group_size)
    c = input.shape[1]
    output_dim = c // (gh * gw) if position_sensitive else c
    if not position_sensitive:
        gh = gw = 1
    part = list(part_size) if part_size else [pooled_height, pooled_width]
    out, _ = _simple(
        "deformable_psroi_pooling",
        {"Input": input, "ROIs": rois, "Trans": trans},
        {"no_trans": no_trans, "spatial_scale": spatial_scale,
         "output_dim": output_dim, "group_size": [gh, gw],
         "pooled_size": [pooled_height, pooled_width], "part_size": part,
         "sample_per_part": sample_per_part, "trans_std": trans_std},
        n_out=2, out_slots=["Output", "TopCount"])
    return out


# ------------------------------------------------- CTR / contrib surface
def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """layers/nn.py:4792: the power-iteration buffers U and V are
    parameters the op reads and no gradient updates."""
    helper = LayerHelper("spectral_norm")
    perm_w = 1
    for i, s in enumerate(weight.shape):
        if i != dim:
            perm_w *= s
    u = helper.create_parameter(None, [weight.shape[dim]], weight.dtype)
    v = helper.create_parameter(None, [perm_w], weight.dtype)
    u.stop_gradient = True
    v.stop_gradient = True
    return _simple("spectral_norm", {"Weight": weight, "U": u, "V": v},
                   {"dim": dim, "power_iters": power_iters, "eps": eps})


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """layers/nn.py:402: the per-sample loss; the centers parameter is
    refreshed through the op's CentersOut output (which names it)."""
    helper = LayerHelper("center_loss")
    centers = helper.create_parameter(param_attr, [num_classes,
                                                   input.shape[1]],
                                      input.dtype)
    centers.stop_gradient = True
    rate = fill_constant([1], input.dtype, float(alpha))
    diff = helper.create_tmp(dtype=input.dtype, stop_gradient=True)
    loss = helper.create_tmp(dtype=input.dtype)
    helper.append_op("center_loss",
                     {"X": input, "Label": label, "Centers": centers,
                      "CenterUpdateRate": rate},
                     {"SampleCenterDiff": diff, "Loss": loss,
                      "CentersOut": centers},
                     {"need_update": bool(update_center)})
    return loss


def data_norm(input, act=None, epsilon=1e-4, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """layers/nn.py:4445: normalization by learned batch statistics
    (initially size 1e4, sum 0, square sum 1e4)."""
    helper = LayerHelper("data_norm")
    c = input.shape[-1] if data_layout == "NHWC" else input.shape[1]
    pa = param_attr if isinstance(param_attr, dict) else {}

    def stat(key, default):
        return helper.create_parameter(
            ParamAttr(initializer=Constant(float(pa.get(key, default)))),
            [c], input.dtype)

    y, _, _ = _simple(
        "data_norm",
        {"X": input, "BatchSize": stat("batch_size", 1e4),
         "BatchSum": stat("batch_sum", 0.0),
         "BatchSquareSum": stat("batch_square", 1e4)},
        {"epsilon": epsilon}, n_out=3, out_slots=["Y", "Means", "Scales"])
    return _act(y, act)


def similarity_focus(input, axis, indexes, name=None):
    return _simple("similarity_focus", {"X": input},
                   {"axis": axis, "indexes": list(indexes)})


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True):
    out, loss_weight, _ = _simple(
        "filter_by_instag",
        {"Ins": ins, "Ins_tag": ins_tag, "Filter_tag": filter_tag},
        {"is_lod": is_lod}, n_out=3,
        out_slots=["Out", "LossWeight", "IndexMap"])
    return out, loss_weight


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """layers/nn.py:2051: (precision, recall, f1, #infer, #label,
    #correct)."""
    ins = {"Inference": input, "Label": label}
    if seq_length is not None:
        ins["SeqLength"] = seq_length
    return _simple(
        "chunk_eval", ins,
        {"chunk_scheme": chunk_scheme, "num_chunk_types": num_chunk_types,
         "excluded_chunk_types": list(excluded_chunk_types or [])},
        n_out=6,
        out_slots=["Precision", "Recall", "F1-Score", "NumInferChunks",
                   "NumLabelChunks", "NumCorrectChunks"])


def var_conv_2d(input, row, col, input_channel, output_channel, filter_size,
                stride=1, param_attr=None, act=None, dtype="float32",
                name=None):
    """contrib/layers/nn.py:103: input [B, C, Hmax, Wmax] with each
    sample's valid rows and columns (the 2-level LoD as two vectors)."""
    helper = LayerHelper("var_conv_2d")
    fh, fw = _pair(filter_size)
    sh, sw = _pair(stride)
    w = helper.create_parameter(
        param_attr, [output_channel, input_channel * fh * fw], dtype)
    out = _simple("var_conv_2d",
                  {"X": input, "W": w, "ROW": row, "COLUMN": col},
                  {"InputChannel": input_channel,
                   "OutputChannel": output_channel,
                   "KernelH": fh, "KernelW": fw, "StrideH": sh,
                   "StrideW": sw})
    return _act(out, act)


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None, x_lengths=None,
                        y_lengths=None):
    """contrib/layers/nn.py:219: x and y [B, L, D] (+ lengths)."""
    helper = LayerHelper("match_matrix_tensor")
    d = x.shape[-1]
    w = helper.create_parameter(param_attr, [d, channel_num, d], dtype)
    ins = {"X": x, "Y": y, "W": w}
    if x_lengths is not None:
        ins["LengthsX"] = x_lengths
    if y_lengths is not None:
        ins["LengthsY"] = y_lengths
    out, tmp = _simple("match_matrix_tensor", ins, {"dim_t": channel_num},
                       n_out=2, out_slots=["Out", "Tmp"])
    return _act(out, act), tmp


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """contrib/layers/nn.py:370 (TBCNN)."""
    helper = LayerHelper("tree_conv")
    w = helper.create_parameter(param_attr, [nodes_vector.shape[-1], 3,
                                             output_size, num_filters],
                                nodes_vector.dtype)
    out = _simple("tree_conv",
                  {"NodesVector": nodes_vector, "EdgeSet": edge_set,
                   "Filter": w}, {"max_depth": max_depth})
    b = helper.create_parameter(bias_attr, [num_filters],
                                nodes_vector.dtype, is_bias=True)
    if b is not None:
        out = elementwise_add(out, b, axis=-1)
    return _act(out, act)


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):
    """contrib/layers/nn.py:302: input [B, C, Rmax, Cmax] with row and
    column lengths."""
    out, _ = _simple("sequence_topk_avg_pooling",
                     {"X": input, "ROW": row, "COLUMN": col},
                     {"topks": list(topks), "channel_num": channel_num},
                     n_out=2, out_slots=["Out", "pos"])
    return out


def fused_embedding_seq_pool(input, size, is_sparse=False, padding_idx=None,
                             combiner="sum", param_attr=None,
                             dtype="float32", lengths=None):
    """contrib/layers/nn.py:435: ids [B, T] (+ lengths)."""
    helper = LayerHelper("fused_embedding_seq_pool")
    w = helper.create_parameter(param_attr, list(size), dtype)
    ins = {"Ids": input, "W": w}
    if lengths is not None:
        ins["Lengths"] = lengths
    attrs = {"combiner": combiner}
    if padding_idx is not None:
        attrs["padding_idx"] = (padding_idx if padding_idx >= 0
                                else size[0] + padding_idx)
    return _simple("fused_embedding_seq_pool", ins, attrs, dtype=dtype)


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """contrib/layers/nn.py:39."""
    out, inter = _simple("fused_elemwise_activation", {"X": x, "Y": y},
                         {"functor_list": list(functor_list), "axis": axis,
                          "scale": scale}, n_out=2,
                         out_slots=["Out", "IntermediateOut"])
    return (out, inter) if save_intermediate_out else out


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer, rand_len,
                        drop_out_percent, is_training, use_filter,
                        white_list_len, black_list_len, seed,
                        lr=1.0, param_attr=None, param_attr_wl=None,
                        param_attr_bl=None, name=None,
                        distribute_update_vars=None, dtype="float32",
                        lengths=None):
    """contrib/layers/nn.py:631: ids [B, T] (+ lengths); W is
    [space_len, rand_len] (the reference's flat pool)."""
    helper = LayerHelper("pyramid_hash")
    w = helper.create_parameter(param_attr, [space_len, rand_len], dtype)
    ins = {"X": input, "W": w}
    if use_filter and white_list_len:
        ins["WhiteList"] = helper.create_parameter(
            param_attr_wl, [white_list_len], "int64")
    if use_filter and black_list_len:
        ins["BlackList"] = helper.create_parameter(
            param_attr_bl, [black_list_len], "int64")
    if lengths is not None:
        ins["Lengths"] = lengths
    out, _, _ = _simple(
        "pyramid_hash", ins,
        {"num_emb": num_emb, "space_len": space_len,
         "pyramid_layer": pyramid_layer, "rand_len": rand_len,
         "drop_out_percent": drop_out_percent, "is_training": is_training,
         "use_filter": use_filter, "seed": seed},
        n_out=3, out_slots=["Out", "DropPos", "X_Temp_Out"])
    return out


def multiclass_nms2(bboxes, scores, score_threshold=0.05, nms_top_k=64,
                    keep_top_k=100, nms_threshold=0.3, normalized=True,
                    nms_eta=1.0, background_label=0, return_index=False,
                    name=None):
    """contrib/layers/nn.py:501: multiclass_nms that can also return the
    kept rows' index. Out is [N, keep_top_k, 6] padded with class -1, so
    the index is each row's rank, as [N keep_top_k, 1]."""
    from paddle_tpu_torch.static.common import reshape
    from paddle_tpu_torch.static.detection import multiclass_nms
    out = multiclass_nms(bboxes, scores, score_threshold=score_threshold,
                         nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                         nms_threshold=nms_threshold, normalized=normalized,
                         nms_eta=nms_eta, background_label=background_label)
    if not return_index:
        return out
    n, k = out.shape[0], out.shape[1]
    enforce(n > 0, "multiclass_nms2 return_index needs a static batch "
            "dim (got %s); declare bboxes with append_batch_size=False", n)
    rng = _simple("range", {}, {"start": 0, "end": n * k, "step": 1},
                  dtype="int64")
    return out, reshape(rng, [n * k, 1])


# --------------------------------------------- contrib rnn_impl surface
def _last_step(seq, lengths):
    """[B, T, D] -> [B, D]: the row at lengths - 1 (or the last step)."""
    if lengths is not None:
        return sequence_pool(seq, pool_type="last", lengths=lengths)
    return _simple("getitem", {"X": seq},
                   {"slices": [["slice", None, None, None],
                               ["int", seq.shape[1] - 1]]})


def _first_step(seq):
    """[B, T, D] -> [B, D] at t = 0: the reverse direction's final
    state."""
    return _simple("getitem", {"X": seq},
                   {"slices": [["slice", None, None, None], ["int", 0]]})


def _stacked_state(init, layer, direction, ndir):
    """rnn_impl's init_hidden / init_cell rows [num_layers ndir, B, H]."""
    if init is None:
        return None
    if len(init.shape) == 2:
        return init if (layer == 0 and direction == 0) else None
    return getitem(init, layer * ndir + direction)


def _batch_major(x, batch_first):
    return x if batch_first else _simple("transpose", {"X": x},
                                         {"perm": [1, 0, 2]})


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """contrib/layers/rnn_impl.py basic_gru: a stacked (optionally
    bidirectional) GRU over [B, T, D] (+ lengths), each layer and
    direction an fc projection into the gru op. Returns (rnn_out
    [B, T, H dirs], last_hidden [L dirs, B, H])."""
    from paddle_tpu_torch.static import nn as _nn
    from paddle_tpu_torch.static.rnn import dynamic_gru
    ndir = 2 if bidirectional else 1
    lasts = []
    h = _batch_major(input, batch_first)
    for layer in range(num_layers):
        if layer > 0 and dropout_prob:
            h = _nn.dropout(h, dropout_prob)
        outs = []
        for d in range(ndir):
            proj = _nn.fc(h, size=3 * hidden_size, num_flatten_dims=2,
                          bias_attr=False)
            o = dynamic_gru(proj, hidden_size, lengths=sequence_length,
                            is_reverse=(d == 1),
                            h_0=_stacked_state(init_hidden, layer, d, ndir))
            outs.append(o)
            lasts.append(_first_step(o) if d == 1
                         else _last_step(o, sequence_length))
        h = outs[0] if ndir == 1 else concat(outs, axis=-1)
    last_hidden = _simple("stack", {"X": lasts}, {"axis": 0})
    return _batch_major(h, batch_first), last_hidden


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """contrib/layers/rnn_impl.py basic_lstm: (rnn_out, last_hidden
    [L dirs, B, H], last_cell [L dirs, B, H])."""
    from paddle_tpu_torch.static import nn as _nn
    from paddle_tpu_torch.static.rnn import dynamic_lstm
    ndir = 2 if bidirectional else 1
    lasth, lastc = [], []
    h = _batch_major(input, batch_first)
    for layer in range(num_layers):
        if layer > 0 and dropout_prob:
            h = _nn.dropout(h, dropout_prob)
        outs = []
        for d in range(ndir):
            proj = _nn.fc(h, size=4 * hidden_size, num_flatten_dims=2,
                          bias_attr=False)
            o, c = dynamic_lstm(
                proj, 4 * hidden_size, lengths=sequence_length,
                is_reverse=(d == 1), use_peepholes=False,
                h_0=_stacked_state(init_hidden, layer, d, ndir),
                c_0=_stacked_state(init_cell, layer, d, ndir))
            outs.append(o)
            for seq, acc in ((o, lasth), (c, lastc)):
                acc.append(_first_step(seq) if d == 1
                           else _last_step(seq, sequence_length))
        h = outs[0] if ndir == 1 else concat(outs, axis=-1)
    last_hidden = _simple("stack", {"X": lasth}, {"axis": 0})
    last_cell = _simple("stack", {"X": lastc}, {"axis": 0})
    return _batch_major(h, batch_first), last_hidden, last_cell


def _unit(make, dtype, device):
    """An eager nn.Layer cell whose weights `make(layer, in_dim)` creates
    on the first call."""
    from paddle_tpu_torch import nn

    class _Cell(nn.Layer):
        def __init__(self):
            super().__init__(dtype=dtype, device=device)
            self.ready = False

        def ensure(self, in_dim):
            if not self.ready:
                make(self, in_dim)
                self.ready = True

    return _Cell()


class BasicGRUUnit:
    """contrib rnn_impl BasicGRUUnit: one eager step over raw
    [B, input_size] features: gates = sigmoid([x, h] W_g + b_g) (r, u),
    candidate = tanh([x, r h] W_c + b_c), h' = u h + (1 - u) candidate
    (rnn_impl.py:59-107). Parameters gate_w, gate_b, cand_w, cand_b."""

    def __init__(self, name_scope=None, hidden_size=None,
                 param_attr=None, bias_attr=None, gate_activation=None,
                 activation=None, dtype="float32", device=None):
        hs = hidden_size

        def make(cell, in_dim):
            cell.create_parameter("gate_w", (in_dim + hs, 2 * hs))
            cell.create_parameter("gate_b", (2 * hs,), is_bias=True)
            cell.create_parameter("cand_w", (in_dim + hs, hs))
            cell.create_parameter("cand_b", (hs,), is_bias=True)

        self._cell = _unit(make, dtype, device)

    def __call__(self, input, pre_hidden):
        c = self._cell
        c.ensure(input.shape[-1])
        g = torch.sigmoid(torch.cat([input, pre_hidden], -1) @ c.gate_w
                          + c.gate_b)
        r, u = torch.chunk(g, 2, dim=-1)
        cand = torch.tanh(torch.cat([input, r * pre_hidden], -1) @ c.cand_w
                          + c.cand_b)
        return u * pre_hidden + (1 - u) * cand


class BasicLSTMUnit:
    """contrib rnn_impl BasicLSTMUnit: one eager step; gates [i, j, f, o]
    = [x, h] W + b, forget_bias added before the sigmoid. Parameters
    weight and bias."""

    def __init__(self, name_scope=None, hidden_size=None,
                 param_attr=None, bias_attr=None, gate_activation=None,
                 activation=None, forget_bias=1.0, dtype="float32",
                 device=None):
        hs = hidden_size
        self._forget_bias = forget_bias

        def make(cell, in_dim):
            cell.create_parameter("weight", (in_dim + hs, 4 * hs))
            cell.create_parameter("bias", (4 * hs,), is_bias=True)

        self._cell = _unit(make, dtype, device)

    def __call__(self, input, pre_hidden, pre_cell):
        c = self._cell
        c.ensure(input.shape[-1])
        gates = torch.cat([input, pre_hidden], -1) @ c.weight + c.bias
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        new_c = (pre_cell * torch.sigmoid(f + self._forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
        return torch.tanh(new_c) * torch.sigmoid(o), new_c
