"""Recurrent ops: LSTM, LSTMP, GRU and their single-step units.

Counterpart of paddle_tpu/ops/rnn.py, with Fluid's layouts kept exactly:
`lstm` / `lstmp` gates {c̃, i, f, o} with the peephole weights in the
bias tail ([1, 7D]; from c_prev on i and f, from c_new on o),
`cell_clip` and `proj_clip`; `gru` gates {u, r, c̃}, Weight = [W_u W_r]
++ W_c, `origin_mode` choosing h = u·h_prev + (1-u)·c̃ over
h = (1-u)·h_prev + u·c̃; `lstm_unit` gates {i, f, o, g} with
`forget_bias`. Sequences are dense [B, T, ·] with lengths [B]: at t ≥ a
row's length the carry is frozen and the output is zero, so a final
state is the state at the row's true length; `is_reverse` reverses each
row's valid prefix (not the padded row).

The time loop is a Python loop over T, one step's ops after another,
differentiable through autograd. It is not cuDNN's RNN: Fluid's gate
layouts and activations (the book's SRL runs a relu candidate and a
sigmoid cell activation) are not cuDNN's. On meta tensors (shape
inference) one step runs and its outputs stand for every step.
"""
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.sequence import reverse_valid

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _act(name):
    enforce(name in _ACTS, "unsupported rnn activation %r", name)
    return _ACTS[name]


def _reverse(x, length):
    return reverse_valid(x, length) if length is not None else x.flip(1)


def time_loop(step, carry, x, length):
    """Run step(carry, x_t, m_t) -> (carry, outs_t) over the time axis
    of x [B, T, ...]; m_t is the [B, 1] float mask of the rows still
    inside their length. Returns (carry, [each out stacked on axis 1])."""
    b, t = x.shape[0], x.shape[1]
    if length is None:
        mask = torch.ones((t, b, 1), dtype=x.dtype, device=x.device)
    else:
        mask = (torch.arange(t, device=x.device)[:, None]
                < length.reshape(-1).to(torch.int64)[None, :]
                ).to(x.dtype)[..., None]
    steps = 1 if x.is_meta else t
    outs = []
    for i in range(steps):
        carry, o = step(carry, x[:, i], mask[i])
        outs.append(o)
    if x.is_meta:
        return carry, [o[:, None].expand((o.shape[0], t) + tuple(o.shape[1:]))
                       for o in outs[0]]
    return carry, [torch.stack(col, dim=1) for col in zip(*outs)]


def _lstm(x, w, bias, h0, c0, length, attrs, proj_weight=None):
    """The LSTM / LSTMP recurrence over pre-projected x [B, T, 4D]."""
    b, t, four_d = x.shape
    d = four_d // 4
    act_gate = _act(attrs.get("gate_activation", "sigmoid"))
    act_cell = _act(attrs.get("cell_activation", "tanh"))
    act_cand = _act(attrs.get("candidate_activation", "tanh"))
    use_peep = attrs.get("use_peepholes", True)
    cell_clip = attrs.get("cell_clip", None)
    is_reverse = attrs.get("is_reverse", False)
    if is_reverse:
        x = _reverse(x, length)
    bias = bias.reshape(-1)
    enforce(bias.shape[0] == (7 * d if use_peep else 4 * d),
            "lstm bias must be [%d] (use_peepholes=%s), got %s",
            7 * d if use_peep else 4 * d, use_peep, tuple(bias.shape))
    b4 = bias[:4 * d]
    if use_peep:
        check_i, check_f, check_o = (bias[4 * d:5 * d], bias[5 * d:6 * d],
                                     bias[6 * d:7 * d])
    proj = proj_weight is not None
    p = proj_weight.shape[1] if proj else d
    act_proj = _act(attrs.get("proj_activation", "tanh")) if proj else None
    proj_clip = attrs.get("proj_clip", None)
    h_init = (torch.zeros((b, p), dtype=x.dtype, device=x.device)
              if h0 is None else h0.to(x.dtype))
    c_init = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
              if c0 is None else c0.to(x.dtype))

    def step(carry, x_t, m):
        h_prev, c_prev = carry
        gates = x_t + h_prev @ w + b4           # layout {c̃, i, f, o}
        g_c = act_cand(gates[:, :d])
        gi, gf, go = gates[:, d:2 * d], gates[:, 2 * d:3 * d], gates[:, 3 * d:]
        if use_peep:
            gi, gf = gi + c_prev * check_i, gf + c_prev * check_f
        c_new = g_c * act_gate(gi) + c_prev * act_gate(gf)
        if cell_clip:
            c_new = torch.clamp(c_new, -cell_clip, cell_clip)
        if use_peep:
            go = go + c_new * check_o
        h_new = act_gate(go) * act_cell(c_new)
        if proj:
            h_new = act_proj(h_new @ proj_weight)
            if proj_clip:
                h_new = torch.clamp(h_new, -proj_clip, proj_clip)
        h_new = h_new * m + h_prev * (1 - m)
        c_new = c_new * m + c_prev * (1 - m)
        return (h_new, c_new), (h_new * m, c_new * m)

    _, (hidden, cell) = time_loop(step, (h_init, c_init), x, length)
    if is_reverse:
        hidden, cell = _reverse(hidden, length), _reverse(cell, length)
    return hidden, cell


@register_op("lstm", inputs=["Input", "Weight", "Bias", "H0?", "C0?",
                             "Length?"],
             outputs=["Hidden", "Cell"])
def _lstm_op(ctx, x, w, bias, h0, c0, length):
    """dynamic_lstm (lstm_op.cc): Input the pre-projected [B, T, 4D],
    Weight [D, 4D] {W_c, W_i, W_f, W_o}, Bias [1, 4D] or [1, 7D] with the
    peephole weights appended."""
    return _lstm(x, w, bias, h0, c0, length, ctx.attrs)


@register_op("lstmp", inputs=["Input", "Weight", "ProjWeight", "Bias", "H0?",
                              "C0?", "Length?"],
             outputs=["Projection", "Cell"])
def _lstmp_op(ctx, x, w, proj_w, bias, h0, c0, length):
    """dynamic_lstmp (lstmp_op.cc): the recurrence runs on the projected
    state (Weight [P, 4D], ProjWeight [D, P])."""
    return _lstm(x, w, bias, h0, c0, length, ctx.attrs, proj_weight=proj_w)


def _gru_step(x_t, h_prev, w, b3, d, act_gate, act_cand, origin):
    """One GRU step: (h, reset-scaled h_prev, u, r, c̃)."""
    ur = x_t[:, :2 * d] + h_prev @ w[:, :2 * d]
    if b3 is not None:
        ur = ur + b3[:2 * d]
    ur = act_gate(ur)
    u, r = ur[:, :d], ur[:, d:]
    reset_h = r * h_prev
    c = x_t[:, 2 * d:] + reset_h @ w[:, 2 * d:]
    if b3 is not None:
        c = c + b3[2 * d:]
    c = act_cand(c)
    h = u * h_prev + (1 - u) * c if origin else (1 - u) * h_prev + u * c
    return h, reset_h, u, r, c


@register_op("gru", inputs=["Input", "Weight", "Bias?", "H0?", "Length?"],
             outputs=["Hidden"])
def _gru(ctx, x, w, bias, h0, length):
    """dynamic_gru (gru_op.cc): Input [B, T, 3D] pre-projected, layout
    {u, r, c̃}; Weight [D, 3D]."""
    b, t, three_d = x.shape
    d = three_d // 3
    act_gate = _act(ctx.attr("gate_activation", "sigmoid"))
    act_cand = _act(ctx.attr("candidate_activation", "tanh"))
    origin = ctx.attr("origin_mode", False)
    is_reverse = ctx.attr("is_reverse", False)
    if is_reverse:
        x = _reverse(x, length)
    b3 = bias.reshape(-1) if bias is not None else None
    h_init = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
              if h0 is None else h0.to(x.dtype))

    def step(h_prev, x_t, m):
        h_new = _gru_step(x_t, h_prev, w, b3, d, act_gate, act_cand,
                          origin)[0]
        h_new = h_new * m + h_prev * (1 - m)
        return h_new, (h_new * m,)

    _, (hidden,) = time_loop(step, h_init, x, length)
    return _reverse(hidden, length) if is_reverse else hidden


@register_op("gru_unit", inputs=["Input", "HiddenPrev", "Weight", "Bias?"],
             outputs=["Hidden", "ResetHiddenPrev", "Gate"])
def _gru_unit(ctx, x, h_prev, w, bias):
    """gru_unit_op.cc: one GRU step; also the reset-scaled previous
    hidden and the gates [u, r, c̃]."""
    d = h_prev.shape[-1]
    h, reset_h, u, r, c = _gru_step(
        x, h_prev, w, bias.reshape(-1) if bias is not None else None, d,
        _act(ctx.attr("gate_activation", "sigmoid")),
        _act(ctx.attr("activation", "tanh")), ctx.attr("origin_mode", False))
    return h, reset_h, torch.cat([u, r, c], dim=1)


@register_op("lstm_unit", inputs=["X", "C_prev"], outputs=["C", "H"])
def _lstm_unit(ctx, x, c_prev):
    """lstm_unit_op.h:62-70: one LSTM step on the pre-projected gates
    [B, 4D], layout {i, f, o, g}, with the forget-gate bias."""
    d = c_prev.shape[-1]
    fb = ctx.attr("forget_bias", 0.0)
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + fb)
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    g = torch.tanh(x[:, 3 * d:])
    c = f * c_prev + i * g
    return c, o * torch.tanh(c)
