"""The cell-based RNN API (fluid layers/rnn.py): RNNCell, GRUCell,
LSTMCell, rnn(), Decoder, BeamSearchDecoder, dynamic_decode.

Counterpart of paddle_tpu/static/rnn_api.py. `rnn` and `dynamic_decode`
unroll over the static time dimension of the dense [B, T, ...] form:
every step's ops land in the Program (the reference drives the cells
through a While loop over LoD steps), a finished mask carries the
reference's early stop (states freeze once finished), and each cell's
weights are created once and shared by every step.
"""
import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.static import rnn as _rnn
from paddle_tpu_torch.static.common import (_simple, cast, concat,
                                            elementwise_add, elementwise_mul,
                                            fill_constant, getitem, reshape,
                                            stack)

__all__ = ["RNNCell", "GRUCell", "LSTMCell", "rnn", "Decoder",
           "BeamSearchDecoder", "dynamic_decode"]


class RNNCell:
    """Base: subclasses implement call(inputs, states) -> (out, states);
    get_initial_states builds zero states shaped from a batch ref.
    Parameters are created ONCE per cell instance and shared across
    every unrolled step (the reference cells are Layers holding their
    weights) — `_shared_param` memoizes by key."""

    def call(self, inputs, states):
        raise NotImplementedError

    def __call__(self, inputs, states):
        return self.call(inputs, states)

    def _shared_param(self, key, shape, dtype="float32", is_bias=False):
        cache = self.__dict__.setdefault("_params", {})
        if key not in cache:
            from paddle_tpu_torch.static.helper import LayerHelper
            cache[key] = LayerHelper(
                type(self).__name__).create_parameter(
                None, list(shape), dtype, is_bias=is_bias)
        return cache[key]

    def _shared_fc(self, key, x, size, bias=True):
        """x @ W (+ b) with the cell's tied weights."""
        from paddle_tpu_torch.static.common import matmul
        w = self._shared_param(key + "_w", (x.shape[-1], size))
        y = matmul(x, w)
        if bias:
            b = self._shared_param(key + "_b", (size,), is_bias=True)
            y = elementwise_add(y, b)
        return y

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        b = batch_ref.shape[batch_dim_idx]
        shape = shape or [self.hidden_size]
        return fill_constant([b] + list(shape), dtype, init_value)


class GRUCell(RNNCell):
    """layers/rnn.py GRUCell: tied fc input projection + gru_unit step
    (one weight set shared across all unrolled steps)."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype="float32",
                 name="GRUCell"):
        self.hidden_size = hidden_size

    def call(self, inputs, states):
        proj = self._shared_fc("proj", inputs, 3 * self.hidden_size,
                               bias=False)
        w = self._shared_param("gru_w", (self.hidden_size,
                                         3 * self.hidden_size))
        b = self._shared_param("gru_b", (3 * self.hidden_size,),
                               is_bias=True)
        new_hidden = _simple(
            "gru_unit", {"Input": proj, "HiddenPrev": states,
                         "Weight": w, "Bias": b}, {}, n_out=3,
            out_slots=["Hidden", "ResetHiddenPrev", "Gate"])[0]
        return new_hidden, new_hidden


class LSTMCell(RNNCell):
    """layers/rnn.py LSTMCell: states = [hidden, cell]; tied weights."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype="float32", name="LSTMCell"):
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias

    def call(self, inputs, states):
        h, c = states
        xh = concat([inputs, h], axis=-1)
        gates = self._shared_fc("gates", xh, 4 * self.hidden_size)
        new_h, new_c = _rnn.lstm_unit(gates, h, c,
                                      forget_bias=self.forget_bias)
        return new_h, [new_h, new_c]

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        z = super().get_initial_states(batch_ref, shape, dtype,
                                       init_value, batch_dim_idx)
        z2 = super().get_initial_states(batch_ref, shape, dtype,
                                        init_value, batch_dim_idx)
        return [z, z2]


def _map_state(states, fn):
    if isinstance(states, (list, tuple)):
        return [ _map_state(s, fn) for s in states ]
    return fn(states)


def _zip_state(a, b, fn):
    if isinstance(a, (list, tuple)):
        return [_zip_state(x, y, fn) for x, y in zip(a, b)]
    return fn(a, b)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """layers/rnn.py rnn(): run `cell` over the time axis. Returns
    (outputs [B, T, H] (or time-major), final_states). Steps beyond a
    row's sequence_length leave its state frozen and zero its output
    (the reference's masked update)."""
    if time_major:
        inputs = _simple("transpose", {"X": inputs}, {"perm": [1, 0, 2]})
    t = inputs.shape[1]
    states = initial_states if initial_states is not None else \
        cell.get_initial_states(inputs)
    step_mask = None
    if sequence_length is not None:
        step_mask = _simple("sequence_mask", {"X": sequence_length},
                            {"maxlen": t, "out_dtype": "float32"},
                            out_slots=["Y"])
    outs = []
    order = range(t - 1, -1, -1) if is_reverse else range(t)
    for i in order:
        x_t = getitem(inputs, (slice(None), i))
        out, new_states = cell.call(x_t, states)
        if step_mask is not None:
            m = getitem(step_mask, (slice(None), i))
            m = reshape(m, [-1, 1])

            def _mix(new, old):
                return elementwise_add(elementwise_mul(new, m, axis=0),
                                       elementwise_mul(
                                           old, _simple(
                                               "scale", {"X": m},
                                               {"scale": -1.0,
                                                "bias": 1.0}), axis=0))

            states = _zip_state(new_states, states, _mix)
            out = elementwise_mul(out, m, axis=0)
        else:
            states = new_states
        outs.append(out)
    if is_reverse:
        outs = outs[::-1]
    outputs = stack(outs, axis=1)
    if time_major:
        outputs = _simple("transpose", {"X": outputs}, {"perm": [1, 0, 2]})
    return outputs, states


class Decoder:
    """layers/rnn.py Decoder interface."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """layers/rnn.py BeamSearchDecoder over a cell + embedding/output
    functions. Static-shape beams [B, K]; finished beams freeze with
    EOS forced at probability one (the reference's masked update)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _tile_beam(x, k):
    """[B, ...] → [B*K, ...] (beam replication, rnn.py
    BeamSearchDecoder.tile_beam_merge_with_batch)."""
    b = x.shape[0]
    rest = list(x.shape[1:])
    e = _simple("unsqueeze", {"X": x}, {"axes": [1]})
    e = _simple("expand", {"X": e},
                {"expand_times": [1, k] + [1] * len(rest)})
    return reshape(e, [b * k] + rest)


def dynamic_decode(decoder, inits=None, max_step_num=None, **kwargs):
    """layers/rnn.py dynamic_decode for BeamSearchDecoder: UNROLLED
    beam search for max_step_num steps over the static graph. Returns
    (token ids [B, K, T], per-beam scores [B, K]). Finished beams
    freeze: they advance only via end_token with zero added score."""
    enforce(isinstance(decoder, BeamSearchDecoder),
            "dynamic_decode drives a BeamSearchDecoder")
    enforce(max_step_num is not None,
            "max_step_num is required (static unroll length)")
    from paddle_tpu_torch.static.common import (elementwise_min, equal,
                                                gather, log, one_hot, softmax,
                                                topk)
    cell = decoder.cell
    k = decoder.beam_size
    enforce(inits is not None, "pass inits (cell states, batch-major)")
    states = _map_state(inits, lambda s: _tile_beam(s, k))
    some = states[0] if isinstance(states, (list, tuple)) else states
    while isinstance(some, (list, tuple)):
        some = some[0]
    bk = some.shape[0]
    b = bk // k

    tokens = fill_constant([bk, 1], "int64", decoder.start_token)
    # beam 0 active, others -inf so step 1 expands a single beam per row
    neg = -1e9
    init_scores = np.zeros((b, k), np.float32)
    init_scores[:, 1:] = neg
    scores = _simple("assign_value", {},
                     {"values": init_scores.ravel().tolist(),
                      "shape": [b, k], "dtype": "float32"})
    finished = fill_constant([b, k], "float32", 0.0)
    steps = []
    parents_hist = []
    for _step in range(max_step_num):
        emb = (decoder.embedding_fn(tokens) if decoder.embedding_fn
               else tokens)
        emb = reshape(emb, [bk, -1])
        out, new_states = cell.call(emb, states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        v = logits.shape[-1]
        logp = log(softmax(logits, axis=-1))             # [B*K, V]
        logp = reshape(logp, [b, k, v])
        # finished beams: only end_token, with 0 added score
        eos_row = one_hot(
            fill_constant([b, k], "int64", decoder.end_token), v)
        fin3 = reshape(finished, [b, k, 1])
        masked = elementwise_add(
            elementwise_mul(logp, _simple("scale", {"X": fin3},
                                          {"scale": -1.0, "bias": 1.0})),
            elementwise_mul(_simple("scale", {"X": eos_row},
                                    {"scale": -neg, "bias": neg}), fin3))
        total = elementwise_add(masked, reshape(scores, [b, k, 1]))
        flat = reshape(total, [b, k * v])
        top_s, top_i = topk(flat, k=k)                   # [B, K]
        parent = cast(_simple("elementwise_floordiv",
                              {"X": top_i,
                               "Y": fill_constant([b, k], "int64", v)}),
                      "int64")
        tok = _simple("elementwise_mod",
                      {"X": top_i,
                       "Y": fill_constant([b, k], "int64", v)})
        # gather states by parent beam (flattened [B*K] index)
        offs = _simple("assign_value", {},
                       {"values": [float(i * k) for i in range(b)],
                        "shape": [b, 1], "dtype": "float32"})
        flat_parent = cast(
            elementwise_add(cast(parent, "float32"), offs), "int64")
        flat_parent = reshape(flat_parent, [bk])
        states = _map_state(new_states,
                            lambda s: gather(s, flat_parent))
        was_fin = gather(reshape(finished, [bk]), flat_parent)
        scores = top_s
        tokens = reshape(tok, [bk, 1])
        now_eos = cast(equal(tok, fill_constant(
            [b, k], "int64", decoder.end_token)), "float32")
        finished = elementwise_min(
            elementwise_add(reshape(was_fin, [b, k]), now_eos),
            fill_constant([b, k], "float32", 1.0))
        steps.append(reshape(tok, [b, k]))
        parents_hist.append(reshape(parent, [b, k]))
    # follow ancestry back (beam_search_decode semantics) — host-free
    # backtrace via gathers, newest to oldest
    seqs = [steps[-1]]
    cur_parent = parents_hist[-1]
    for i in range(max_step_num - 2, -1, -1):
        offs = _simple("assign_value", {},
                       {"values": [float(j * k) for j in range(b)],
                        "shape": [b, 1], "dtype": "float32"})
        fp = cast(elementwise_add(cast(cur_parent, "float32"), offs),
                  "int64")
        fp = reshape(fp, [bk])
        seqs.append(reshape(gather(reshape(steps[i], [bk]), fp), [b, k]))
        cur_parent = reshape(
            gather(reshape(parents_hist[i], [bk]), fp), [b, k])
    seqs = seqs[::-1]
    ids = stack(seqs, axis=2)                            # [B, K, T]
    return ids, scores
