"""The long-tail fluid.layers surface.

Counterpart of paddle_tpu/static/extras.py. So far its sequence
builders, `sequence_softmax` through `sequence_last_step` (thin builders
over ops/sequence.py, with fluid's signatures and the LoD arguments as
dense tensors plus optional lengths; a missing `lengths` means every row
is full length), and its builders of the vision ops (ops/vision.py):
`affine_grid`, `psroi_pool`, `prroi_pool`, `deformable_conv` (both op
types) and `deformable_roi_pooling`. The rest of the module comes with
its op families (ROADMAP Queue 1 item 7).
"""
from paddle_tpu_torch.static.common import _simple, elementwise_add, \
    fill_constant, sequence_pool
from paddle_tpu_torch.static.helper import LayerHelper

__all__ = ["sequence_softmax", "sequence_reverse", "sequence_concat",
           "sequence_expand", "sequence_expand_as", "sequence_pad",
           "sequence_unpad", "sequence_slice", "sequence_first_step",
           "sequence_last_step", "affine_grid", "psroi_pool", "prroi_pool",
           "deformable_conv", "deformable_roi_pooling"]


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

    def _t(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    fh, fw = _t(filter_size)
    w = helper.create_parameter(param_attr,
                                [num_filters, c_in // (groups or 1), fh, fw],
                                input.dtype)
    attrs = {"strides": _t(stride), "paddings": _t(padding),
             "dilations": _t(dilation), "groups": groups or 1,
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
