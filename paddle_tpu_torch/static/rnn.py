"""Recurrent layers, tensor arrays and beam-search steps for the
static-graph API.

Counterpart of paddle_tpu/static/rnn.py (fluid.layers.dynamic_lstm,
dynamic_lstmp, dynamic_gru, gru_unit, lstm_unit, create_array,
array_write, array_read, beam_search, beam_search_decode): the same op
types, slots, attrs and parameter shapes, so a program built here is the
JAX package's program. Sequences are dense [B, T, ·] with an explicit
`lengths` [B] vector (ops/sequence.py).
"""
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.static.helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
           "lstm_unit", "create_array", "array_write", "array_read",
           "beam_search", "beam_search_decode"]


def dynamic_lstm(input, size, lengths=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None, use_peepholes=True,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """LSTM over a pre-projected [B, T, 4*hidden] input; returns
    (hidden [B,T,D], cell [B,T,D]). Weight layout {W_c, W_i, W_f, W_o}
    (lstm_kernel.h value_in first); peephole weights live in the bias tail
    ([1, 7D]) exactly like the reference."""
    enforce(size % 4 == 0, "dynamic_lstm size must be 4*hidden, got %s", size)
    d = size // 4
    helper = LayerHelper("dynamic_lstm")
    w = helper.create_parameter(param_attr, [d, 4 * d], dtype)
    b = helper.create_parameter(bias_attr, [1, 7 * d if use_peepholes else 4 * d],
                                dtype, is_bias=True)
    hidden = helper.create_tmp(dtype=dtype)
    cell = helper.create_tmp(dtype=dtype)
    ins = {"Input": input, "Weight": w, "Bias": b}
    if h_0 is not None:
        ins["H0"] = h_0
    if c_0 is not None:
        ins["C0"] = c_0
    if lengths is not None:
        ins["Length"] = lengths
    helper.append_op("lstm", ins, {"Hidden": hidden, "Cell": cell},
                     {"use_peepholes": use_peepholes,
                      "is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, lengths=None, param_attr=None,
                  bias_attr=None, use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, h_0=None, c_0=None,
                  cell_clip=None, proj_clip=None):
    """Projected LSTM: recurrence on the projected state (Weight [P, 4D],
    ProjWeight [D, P]); returns (projection [B,T,P], cell [B,T,D])."""
    enforce(size % 4 == 0, "dynamic_lstmp size must be 4*hidden, got %s", size)
    d = size // 4
    helper = LayerHelper("dynamic_lstmp")
    w = helper.create_parameter(param_attr, [proj_size, 4 * d], dtype)
    proj_w = helper.create_parameter(None, [d, proj_size], dtype)
    b = helper.create_parameter(bias_attr, [1, 7 * d if use_peepholes else 4 * d],
                                dtype, is_bias=True)
    proj = helper.create_tmp(dtype=dtype)
    cell = helper.create_tmp(dtype=dtype)
    ins = {"Input": input, "Weight": w, "ProjWeight": proj_w, "Bias": b}
    if h_0 is not None:
        ins["H0"] = h_0
    if c_0 is not None:
        ins["C0"] = c_0
    if lengths is not None:
        ins["Length"] = lengths
    helper.append_op("lstmp", ins, {"Projection": proj, "Cell": cell},
                     {"use_peepholes": use_peepholes,
                      "is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation,
                      "proj_activation": proj_activation,
                      "cell_clip": cell_clip, "proj_clip": proj_clip})
    return proj, cell


def dynamic_gru(input, size, lengths=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False):
    """GRU over a pre-projected [B, T, 3*size] input; returns hidden
    [B, T, size]. Weight [D, 3D] = update/reset block ++ candidate block."""
    helper = LayerHelper("dynamic_gru")
    dtype = input.dtype
    w = helper.create_parameter(param_attr, [size, 3 * size], dtype)
    b = helper.create_parameter(bias_attr, [1, 3 * size], dtype, is_bias=True)
    hidden = helper.create_tmp(dtype=dtype)
    ins = {"Input": input, "Weight": w}
    if b is not None:
        ins["Bias"] = b
    if h_0 is not None:
        ins["H0"] = h_0
    if lengths is not None:
        ins["Length"] = lengths
    helper.append_op("gru", ins, {"Hidden": hidden},
                     {"is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "candidate_activation": candidate_activation,
                      "origin_mode": origin_mode})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step (input [B, 3D] pre-projected, hidden [B, D]); returns
    (hidden, reset_hidden_prev, gate) like the reference (nn.py:1382)."""
    enforce(size % 3 == 0, "gru_unit size must be 3*hidden, got %s", size)
    d = size // 3
    helper = LayerHelper("gru_unit")
    dtype = input.dtype
    w = helper.create_parameter(param_attr, [d, 3 * d], dtype)
    b = helper.create_parameter(bias_attr, [1, 3 * d], dtype, is_bias=True)
    h = helper.create_tmp(dtype=dtype)
    reset_h = helper.create_tmp(dtype=dtype)
    gate = helper.create_tmp(dtype=dtype)
    ins = {"Input": input, "HiddenPrev": hidden, "Weight": w}
    if b is not None:
        ins["Bias"] = b
    helper.append_op("gru_unit", ins,
                     {"Hidden": h, "ResetHiddenPrev": reset_h, "Gate": gate},
                     {"activation": activation,
                      "gate_activation": gate_activation,
                      "origin_mode": origin_mode})
    return h, reset_h, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step (nn.py:6087): fc over concat(x_t, h_prev) then the
    lstm_unit op (gate layout {i, f, o, g}); returns (hidden, cell)."""
    from paddle_tpu_torch.static import common, nn as static_nn
    d = cell_t_prev.shape[-1]
    cat = common.concat([x_t, hidden_t_prev], axis=1)
    fc_out = static_nn.fc(cat, 4 * d, param_attr=param_attr,
                          bias_attr=bias_attr)
    helper = LayerHelper("lstm_unit")
    c = helper.create_tmp(dtype=x_t.dtype)
    h = helper.create_tmp(dtype=x_t.dtype)
    helper.append_op("lstm_unit", {"X": fc_out, "C_prev": cell_t_prev},
                     {"C": c, "H": h}, {"forget_bias": forget_bias})
    return h, c


def create_array(t, shape, dtype="float32", value=0.0):
    """LoDTensorArray analogue: a preallocated [T, ...] buffer consumed by
    array_write / array_read (ops/control_flow.py's tensor_array ops; the
    reference's array grows, this one has a static length)."""
    from paddle_tpu_torch.static import common
    return common.fill_constant([t] + list(shape), dtype, value)


def array_write(x, i, array):
    """fluid.layers.array_write: functional write → new array var; inside
    a While body, follow with assign(new, output=array) to carry it."""
    helper = LayerHelper("array_write")
    out = helper.create_tmp(dtype=array.dtype)
    helper.append_op("tensor_array_write",
                     {"Array": array, "X": x, "I": i}, {"Out": out}, {})
    return out


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp(dtype=array.dtype)
    helper.append_op("tensor_array_read", {"Array": array, "I": i},
                     {"Out": out}, {})
    return out


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One beam-search step (layers/nn.py:5864, beam_search_op.cc) on fixed
    [B, K] beams: `scores` is the decoder's raw [B, K, V] logits (the op
    log-softmaxes and accumulates internally — the static-shape form of the
    reference's topk+log+add idiom). Returns (selected_ids [B,K],
    selected_scores [B,K], parent_idx [B,K])."""
    helper = LayerHelper("beam_search")
    sel_ids = helper.create_tmp(dtype="int32", stop_gradient=True)
    sel_scores = helper.create_tmp(dtype="float32", stop_gradient=True)
    parent = helper.create_tmp(dtype="int32", stop_gradient=True)
    helper.append_op("beam_search",
                     {"PreIds": pre_ids, "PreScores": pre_scores,
                      "Scores": scores},
                     {"SelectedIds": sel_ids, "SelectedScores": sel_scores,
                      "ParentIdx": parent},
                     {"beam_size": beam_size, "end_id": end_id})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, parents, final_scores, beam_size=None,
                       end_id=0, length_penalty=0.0, name=None):
    """Backtrace stacked per-step selections ([T, B, K] ids/parents
    buffers) into full hypotheses (beam_search_decode_op.cc). Returns
    (sentence_ids [B, K, T], sentence_scores [B, K]).

    `length_penalty` (GNMT alpha, default 0.0 = off) normalizes the
    returned scores by ((5+len)/6)^alpha so hypotheses of different
    lengths compare fairly."""
    helper = LayerHelper("beam_search_decode")
    sent = helper.create_tmp(dtype="int32", stop_gradient=True)
    sc = helper.create_tmp(dtype="float32", stop_gradient=True)
    helper.append_op("beam_search_decode",
                     {"Ids": ids, "Parents": parents,
                      "FinalScores": final_scores},
                     {"SentenceIds": sent, "SentenceScores": sc},
                     {"end_id": end_id,
                      "length_penalty": float(length_penalty)})
    return sent, sc
