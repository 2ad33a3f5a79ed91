"""The long-tail fluid.layers surface.

Counterpart of paddle_tpu/static/extras.py. For now only its sequence
builders, `sequence_softmax` through `sequence_last_step`: thin builders
over ops/sequence.py, with fluid's signatures and the LoD arguments as
dense tensors plus optional lengths (a missing `lengths` means every row
is full length). The rest of the module comes with its op families
(ROADMAP Queue 1 item 7).
"""
from paddle_tpu_torch.static.common import _simple, fill_constant, \
    sequence_pool

__all__ = ["sequence_softmax", "sequence_reverse", "sequence_concat",
           "sequence_expand", "sequence_expand_as", "sequence_pad",
           "sequence_unpad", "sequence_slice", "sequence_first_step",
           "sequence_last_step"]


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
