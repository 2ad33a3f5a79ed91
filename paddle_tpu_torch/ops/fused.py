"""Fused ops.

Counterpart of paddle_tpu/ops/fused.py: `fc` (fc_op.cc, the op that
inference/optimize.py's fuse_fc makes of mul + elementwise_add [+ act])
and the operators/fused/ family the reference's inference passes and
transpilers emit: fused_elemwise_activation, fused_embedding_seq_pool,
fused_embedding_fc_lstm, fused_fc_elementwise_layernorm, attention_lstm
and the fusion_* ops (gru, lstm, repeated_fc_relu, seqconv_eltadd_relu,
seqpool_concat, seqpool_cvm_concat, squared_mat_sub,
transpose_flatten_concat). As in the JAX package, each composes the
registered base ops (gru, lstm, sequence_conv, cvm) or their torch
arithmetic: the ops exist so a program that names them runs, not as
hand-fused kernels. `switch_moe` is parallel/moe.py's layer under an op:
with its expert parameters declared sharded over `ep`, a CompiledProgram
gathers them before the op runs.
"""
import numpy as np
import torch

from paddle_tpu_torch.core import registry as _registry
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op

_FC_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda t: torch.softmax(t, dim=-1),
}


@register_op("fc", inputs=["Input", "W", "Bias?"], outputs=["Out"])
def _fc(ctx, x, w, bias):
    """x flattened to 2D at in_num_col_dims, one GEMM, then the bias and
    the activation, each as its own pass (the JAX order)."""
    nd = ctx.attr("in_num_col_dims", 1)
    xs = tuple(x.shape)
    m = 1
    for d in xs[:nd]:
        m *= int(d)
    out = torch.matmul(x.reshape(m, -1), w)
    if bias is not None:
        out = out + bias.reshape(-1)
    act = ctx.attr("activation", "")
    if act:
        out = _FC_ACTIVATIONS[act](out)
    return out.reshape(xs[:nd] + (int(w.shape[1]),))


_BINARY = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
           "elementwise_mul": torch.mul}


def _unary(name, ctx):
    if name == "scale":
        s = ctx.attr("scale", 1.0)
        return lambda v: v * s
    return {"relu": torch.relu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh}[name]


def _bcast(x, y, axis):
    """The reference's sub-sequence broadcast: y's dims aligned from
    `axis` (default rank(x) - rank(y))."""
    if x.dim() == y.dim():
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return y.reshape(shape)


def _call(ctx, op, attrs, *args):
    """A registered op's function with other attrs, in the caller's
    context (its run seed, mode, op index and device)."""
    sub = _registry.OpContext(attrs, ctx._seed, ctx.training, ctx.op_index,
                              ctx.device, rngs=ctx._rngs)
    return _registry.get_op(op).fn(sub, *args)


@register_op("fused_elemwise_activation", inputs=["X", "Y"],
             outputs=["Out", "IntermediateOut"])
def _fused_elemwise_activation(ctx, x, y):
    """fused/fused_elemwise_activation_op.cc: Z = Unary(Binary(X, Y))
    when the second functor is the binary one, else
    Z = Binary(X, Unary(Y)); IntermediateOut is the inner result."""
    fl = ctx.attr("functor_list")
    enforce(fl is not None and len(fl) == 2,
            "fused_elemwise_activation needs functor_list of 2")
    axis = ctx.attr("axis", -1)
    if fl[1] in _BINARY:
        inner = _BINARY[fl[1]](x, _bcast(x, y, axis))
        return _unary(fl[0], ctx)(inner), inner
    enforce(fl[0] in _BINARY, "unsupported functor_list %s" % (fl,))
    inner = _unary(fl[1], ctx)(y)
    return _BINARY[fl[0]](x, _bcast(x, inner, axis)), inner


def _lookup(ids, w):
    b, t = ids.shape[0], ids.shape[1]
    return w[torch.clamp(ids.reshape(b, t).long(), 0, w.shape[0] - 1)]


@register_op("fused_embedding_seq_pool",
             inputs=["Ids", "W", "Lengths?"], outputs=["Out"])
def _fused_embedding_seq_pool(ctx, ids, w, lengths):
    """fused/fused_embedding_seq_pool_op.h: ids [B, T] (the LoD rows as
    a padded batch + lengths) -> [B, D] sum-pooled embeddings; padding_idx
    rows count zero."""
    enforce(ctx.attr("combiner", "sum") == "sum",
            "fused_embedding_seq_pool supports combiner='sum' only "
            "(fused_embedding_seq_pool_op.cc)")
    padding_idx = ctx.attr("padding_idx", None)
    b, t = ids.shape[0], ids.shape[1]
    flat = ids.reshape(b, t)
    valid = torch.ones((b, t), dtype=torch.bool, device=ids.device)
    if padding_idx is not None and padding_idx >= 0:
        valid = valid & (flat != padding_idx)
    if lengths is not None:
        valid = valid & (lengths.reshape(-1)[:, None]
                         > torch.arange(t, device=ids.device)[None, :])
    emb = _lookup(ids, w)
    return torch.sum(emb * valid[..., None].to(emb.dtype), dim=1)


def _lstm_attrs(ctx):
    return {"is_reverse": ctx.attr("is_reverse", False),
            "use_peepholes": ctx.attr("use_peepholes", False),
            "gate_activation": ctx.attr("gate_activation", "sigmoid"),
            "cell_activation": ctx.attr("cell_activation", "tanh"),
            "candidate_activation": ctx.attr("candidate_activation",
                                             "tanh")}


@register_op("fusion_gru",
             inputs=["X", "H0?", "WeightX", "WeightH", "Bias?"],
             outputs=["Hidden"])
def _fusion_gru(ctx, x, h0, wx, wh, bias):
    """fused/fusion_gru_op.cc: x Wx, then the gru op."""
    return _call(ctx, "gru",
                 {"is_reverse": ctx.attr("is_reverse", False),
                  "origin_mode": ctx.attr("origin_mode", False),
                  "gate_activation": ctx.attr("gate_activation", "sigmoid"),
                  # fusion_gru_op.cc's "activation" is the base op's
                  # candidate_activation
                  "candidate_activation": ctx.attr("activation", "tanh")},
                 torch.einsum("btd,dk->btk", x, wx), wh, bias, h0, None)


@register_op("fusion_lstm",
             inputs=["X", "WeightX", "WeightH", "Bias", "H0?", "C0?"],
             outputs=["Hidden", "Cell"])
def _fusion_lstm(ctx, x, wx, wh, bias, h0, c0):
    """fused/fusion_lstm_op.cc: x Wx, then the lstm op (no peepholes)."""
    return _call(ctx, "lstm", _lstm_attrs(ctx),
                 torch.einsum("btd,dk->btk", x, wx), wh, bias, h0, c0, None)


@register_op("fusion_seqconv_eltadd_relu",
             inputs=["X", "Filter", "Bias", "Length?"],
             outputs=["Out"])
def _fusion_seqconv_eltadd_relu(ctx, x, w, bias, length):
    """fused/fusion_seqconv_eltadd_relu_op.cc: sequence_conv + bias +
    relu."""
    attrs = {"context_length": ctx.attr("contextLength", 3)}
    if ctx.attr("contextStart") is not None:
        attrs["context_start"] = ctx.attr("contextStart")
    out = _call(ctx, "sequence_conv", attrs, x, w, bias, length)
    return torch.maximum(out, torch.zeros((), dtype=out.dtype,
                                          device=out.device))


@register_op("fusion_repeated_fc_relu",
             inputs=["X", "W[]", "Bias[]"], outputs=["Out"])
def _fusion_repeated_fc_relu(ctx, x, ws, biases):
    """fused/fusion_repeated_fc_relu_op.cc: (x W + b, relu) chained."""
    h = x
    for w, b in zip(ws, biases):
        h = h @ w + b.reshape(-1)
        h = torch.maximum(h, torch.zeros((), dtype=h.dtype, device=h.device))
    return h


@register_op("fusion_squared_mat_sub", inputs=["X", "Y"],
             outputs=["SquaredX", "SquaredY", "SquaredXY", "Out"])
def _fusion_squared_mat_sub(ctx, x, y):
    """fused/fusion_squared_mat_sub_op.cc: Out = scalar ((x y)^2 -
    x^2 y^2), the factorization machine's second-order term."""
    xy = x @ y
    x2, y2 = x * x, y * y
    return x2, y2, xy * xy, ctx.attr("scalar", 1.0) * (xy * xy - x2 @ y2)


@register_op("fusion_seqpool_concat", inputs=["X[]"], outputs=["Out"])
def _fusion_seqpool_concat(ctx, xs):
    """fused/fusion_seqpool_concat_op.cc: each [B, T, D] input pooled over
    time (SUM, AVERAGE or SQRT), concatenated on the features."""
    ptype = ctx.attr("pooltype", "SUM").upper()
    enforce(ptype in ("SUM", "AVERAGE", "SQRT"),
            "fusion_seqpool_concat supports SUM/AVERAGE/SQRT "
            "(fusion_seqpool_concat_op.cc), got %s", ptype)
    pooled = []
    for x in xs:
        if ptype == "SUM":
            pooled.append(torch.sum(x, dim=1))
        elif ptype == "AVERAGE":
            pooled.append(torch.mean(x, dim=1))
        else:
            # the JAX package's float32 sqrt of the length
            pooled.append(torch.sum(x, dim=1)
                          / float(np.sqrt(np.float32(x.shape[1]))))
    return torch.cat(pooled, dim=1)


@register_op("fusion_seqpool_cvm_concat", inputs=["X[]", "CVM"],
             outputs=["Out"])
def _fusion_seqpool_cvm_concat(ctx, xs, cvm):
    """fused/fusion_seqpool_cvm_concat_op.cc: sum-pool, cvm, concat."""
    enforce(ctx.attr("pooltype", "SUM").upper() == "SUM",
            "fusion_seqpool_cvm_concat supports SUM "
            "(fusion_seqpool_cvm_concat_op.cc), got %s",
            ctx.attr("pooltype", "SUM"))
    attrs = {"use_cvm": ctx.attr("use_cvm", True)}
    return torch.cat([_call(ctx, "cvm", attrs, torch.sum(x, dim=1), cvm)
                      for x in xs], dim=1)


@register_op("fusion_transpose_flatten_concat", inputs=["X[]"],
             outputs=["Out"])
def _fusion_transpose_flatten_concat(ctx, xs):
    """fused/fusion_transpose_flatten_concat_op.cc."""
    perm = ctx.attr("trans_axis", [0, 2, 3, 1])
    axis = ctx.attr("flatten_axis", 1)
    outs = []
    for x in xs:
        t = x.permute(perm)
        lead = int(np.prod(t.shape[:axis])) if axis > 0 else 1
        outs.append(t.reshape(lead, -1))
    return torch.cat(outs, dim=ctx.attr("concat_axis", 1))


@register_op("fused_fc_elementwise_layernorm",
             inputs=["X", "W", "Bias0?", "Y", "Scale?", "Bias1?"],
             outputs=["Out"])
def _fused_fc_elementwise_layernorm(ctx, x, w, b0, y, scale, b1):
    """fused/fused_fc_elementwise_layernorm_op.cc: layer_norm(x W (+ b0)
    + y) with an optional affine."""
    h = x @ w
    if b0 is not None:
        h = h + b0.reshape(-1)
    h = h + y
    m = torch.mean(h, dim=-1, keepdim=True)
    v = torch.mean(torch.square(h - m), dim=-1, keepdim=True)
    out = (h - m) * torch.rsqrt(v + ctx.attr("epsilon", 1e-5))
    if scale is not None:
        out = out * scale.reshape(-1)
    if b1 is not None:
        out = out + b1.reshape(-1)
    return out


@register_op("fused_embedding_fc_lstm",
             inputs=["Ids", "Embeddings", "WeightH", "Bias", "H0?", "C0?"],
             outputs=["Hidden", "Cell"])
def _fused_embedding_fc_lstm(ctx, ids, emb, wh, bias, h0, c0):
    """fused/fused_embedding_fc_lstm_op.cc: the embedding rows are the
    pre-projected 4D gate inputs (the embedding fused with the FC)."""
    return _call(ctx, "lstm", _lstm_attrs(ctx), _lookup(ids, emb), wh, bias,
                 h0, c0, None)


@register_op("attention_lstm",
             inputs=["X", "C0", "H0?", "AttentionWeight",
                     "AttentionBias?", "AttentionScalar?",
                     "AttentionScalarBias?", "LSTMWeight", "LSTMBias"],
             outputs=["Hidden", "Cell"])
def _attention_lstm(ctx, x, c0, h0, att_w, att_b, att_s, att_sb,
                    lstm_w, lstm_b):
    """fused/attention_lstm_op.cc: at each step, attention over the whole
    input conditioned on the cell state makes the LSTM's input; the
    x-side score projection is hoisted out of the T-step loop. Gate
    layout [f, i, o, c~] (attention_lstm_op.cc:308-330)."""
    t, d = x.shape[1], x.shape[2]
    h = h0 if h0 is not None else torch.zeros_like(c0)
    c = c0
    ex = torch.einsum("btd,du->btu", x, att_w[:d])           # [B, T, U]
    cw = att_w[d:]                                          # [dh, U]
    hs, cs = [], []
    for _ in range(t):
        e = ex + (c @ cw)[:, None, :]
        if att_b is not None:
            e = e + att_b.reshape(-1)
        e = torch.tanh(e)
        if att_s is not None:
            e = e * att_s.reshape(-1)
            if att_sb is not None:
                e = e + att_sb.reshape(-1)
        a = torch.softmax(e[..., 0], dim=1)                  # [B, T]
        ctxv = torch.einsum("bt,btd->bd", a, x)
        gates = torch.cat([ctxv, h], -1) @ lstm_w + lstm_b.reshape(-1)
        f, i, o, cc = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


@register_op("switch_moe", inputs=["X", "GateW", "WIn", "WOut"],
             outputs=["Out", "AuxLoss"])
def _switch_moe_op(ctx, x, gw, wi, wo):
    """Switch-MoE layer op (parallel/moe.py over [..., D] tokens)."""
    from paddle_tpu_torch.parallel.moe import switch_moe as _moe
    d = x.shape[-1]
    y, aux = _moe(x.reshape(-1, d), gw, wi, wo,
                  capacity_factor=ctx.attr("capacity_factor", 1.25))
    return y.reshape(x.shape), aux
