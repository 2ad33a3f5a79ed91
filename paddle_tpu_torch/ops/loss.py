"""Structured and sampled losses: linear-chain CRF and Viterbi, CTC,
NCE, hierarchical sigmoid, sampled softmax, and the margin-style losses.

Counterpart of paddle_tpu/ops/loss.py, with its slots, attrs and
formulas (see there for the reference kernels each follows). Sequences
are dense [B, T, ·] with lengths [B]. The recursions (the CRF's forward
algorithm and Viterbi, CTC's alpha recursion) are Python loops over T
in log space, differentiated by autograd; the JAX package runs them as
`lax.scan`. They compute in float32 whatever the input dtype, as the JAX
package does, except that float64 stays float64 (`dtypes.at_least_f32`'s
rule), so a float64 run is a float64 computation end to end. On meta
tensors the recursions are skipped: only the output shapes are made.

`nce` and `sampled_softmax_with_cross_entropy` draw their negatives from
the op's generator (`OpContext.rng`), so their samples differ from the
JAX package's; with custom negatives the two agree.
"""
import math

import torch

from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op

_NEG = -1e30


def _lengths_or_full(length, b, t, device):
    if length is None:
        return torch.full((b,), t, dtype=torch.int64, device=device)
    return length.reshape(-1).to(torch.int64)


def _steps_valid(t, L, device):
    """[T-1, B]: step k (position k + 1) lies inside row b's length."""
    return torch.arange(1, t, device=device)[:, None] < L[None, :]


# --------------------------------------------------------------------- CRF

@register_op("linear_chain_crf",
             inputs=["Emission", "Transition", "Label", "Length?"],
             outputs=["LogLikelihood", "Alpha"])
def _linear_chain_crf(ctx, emission, transition, label, length):
    """Negative log-likelihood of a linear-chain CRF (linear_chain_crf_op.h
    ForwardOneSequence): Emission [B, T, D], Transition [D+2, D] (row 0
    start weights, row 1 end weights, rows 2.. the tag transitions),
    Label [B, T] (or [B, T, 1]). LogLikelihood [B, 1] = logZ - gold
    score; Alpha [B, T, D] the forward variables."""
    b, t, d = emission.shape
    if emission.is_meta:
        return emission.new_empty((b, 1)), emission.new_empty((b, t, d))
    if label.dim() == 3:
        label = label.reshape(label.shape[:2])
    label = label.to(torch.int64)
    dev = emission.device
    L = _lengths_or_full(length, b, t, dev)
    dt = at_least_f32_dtype(emission, transition)
    x = emission.to(dt)
    w = transition.to(dt)
    w_start, w_end, trans = w[0], w[1], w[2:]
    valid = _steps_valid(t, L, dev)

    alpha = w_start[None, :] + x[:, 0]
    alphas = [alpha]
    for k in range(t - 1):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + x[:, k + 1]
        alpha = torch.where(valid[k][:, None], nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + w_end[None, :], dim=1)

    rows = torch.arange(b, device=dev)
    first = label[:, 0]
    last = torch.take_along_dim(label, torch.clamp(L - 1, min=0)[:, None],
                                dim=1)[:, 0]
    gold = w_start[first] + x[rows, 0, first] + w_end[last]
    if t > 1:
        emit = torch.take_along_dim(x, label[..., None], dim=2)[..., 0]
        step = emit[:, 1:] + trans[label[:, :-1], label[:, 1:]]   # [B, T-1]
        gold = gold + torch.where(valid.T, step,
                                  torch.zeros_like(step)).sum(dim=1)
    ll = (log_z - gold)[:, None]
    return (ll.to(emission.dtype),
            torch.stack(alphas, dim=1).to(emission.dtype))


@register_op("crf_decoding",
             inputs=["Emission", "Transition", "Label?", "Length?"],
             outputs=["ViterbiPath"])
def _crf_decoding(ctx, emission, transition, label, length):
    """Viterbi decode (crf_decoding_op.h) → [B, T] int32, 0 past each
    row's length; with Label, per-position flags of path == label. Ties
    go to the lower tag (the first maximum, as jnp.argmax)."""
    b, t, d = emission.shape
    if emission.is_meta:
        return torch.empty((b, t), dtype=torch.int32, device="meta")
    dev = emission.device
    L = _lengths_or_full(length, b, t, dev)
    dt = at_least_f32_dtype(emission, transition)
    x = emission.to(dt)
    w = transition.to(dt)
    w_start, w_end, trans = w[0], w[1], w[2:]
    valid = _steps_valid(t, L, dev)
    stay = torch.arange(d, device=dev)[None, :].expand(b, d)

    alpha = w_start[None, :] + x[:, 0]
    ptrs = []
    for k in range(t - 1):
        scores = alpha[:, :, None] + trans[None]          # [B, from, to]
        best = torch.amax(scores, dim=1) + x[:, k + 1]
        ptr = torch.argmax(scores, dim=1)
        v = valid[k][:, None]
        alpha = torch.where(v, best, alpha)
        ptrs.append(torch.where(v, ptr, stay))
    tag = torch.argmax(alpha + w_end[None, :], dim=1)
    path = [tag]
    for ptr in reversed(ptrs):
        tag = torch.gather(ptr, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    mask = torch.arange(t, device=dev)[None, :] < L[:, None]
    path = torch.where(mask, path, torch.zeros_like(path))
    if label is not None:
        if label.dim() == 3:
            label = label.reshape(label.shape[:2])
        return (mask & (path == label.to(torch.int64))).to(torch.int32)
    return path.to(torch.int32)


# --------------------------------------------------------------------- CTC

@register_op("warpctc",
             inputs=["Logits", "Label", "LogitsLength?", "LabelLength?"],
             outputs=["Loss"])
def _warpctc(ctx, logits, label, logits_length, label_length):
    """CTC loss on dense [B, T, C] raw logits and [B, Lmax] labels: the
    alpha recursion (Graves 2006 eq. 6-7) over the extended label
    sequence [blank, l1, blank, ..., blank] in log space."""
    b, t, c = logits.shape
    if logits.is_meta:
        return logits.new_empty((b, 1))
    blank = ctx.attr("blank", 0)
    norm_by_times = ctx.attr("norm_by_times", False)
    dev = logits.device
    lmax = label.shape[1]
    label = label.to(torch.int64)
    T_len = _lengths_or_full(logits_length, b, t, dev)
    L_len = _lengths_or_full(label_length, b, lmax, dev)
    dt = at_least_f32_dtype(logits)
    logp = torch.log_softmax(logits.to(dt), dim=-1)

    s_max = 2 * lmax + 1
    s_idx = torch.arange(s_max, device=dev)
    lbl = label[:, torch.clamp(s_idx // 2, max=lmax - 1)]
    ext = torch.where(s_idx % 2 == 0, torch.full_like(lbl, blank), lbl)
    s_valid = s_idx[None, :] < (2 * L_len + 1)[:, None]
    ext_m2 = torch.cat([torch.full((b, 2), -1, dtype=ext.dtype, device=dev),
                        ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)

    def neg(n):
        return torch.full((b, n), _NEG, dtype=dt, device=dev)

    e0 = torch.gather(logp[:, 0], 1, ext)
    a0 = torch.cat([e0[:, :1],
                    torch.where(L_len[:, None] > 0, e0[:, 1:2], neg(1)),
                    neg(s_max - 2)], dim=1)
    alpha = torch.where(s_valid, a0, neg(s_max))
    for k in range(1, t):
        shift1 = torch.cat([neg(1), alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip,
                             torch.cat([neg(2), alpha[:, :-2]], dim=1),
                             neg(s_max))
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        nxt = merged + torch.gather(logp[:, k], 1, ext)
        nxt = torch.where(s_valid, nxt, neg(s_max))
        alpha = torch.where((k < T_len)[:, None], nxt, alpha)

    end1 = torch.gather(alpha, 1, (2 * L_len)[:, None])[:, 0]
    end2 = torch.gather(alpha, 1, torch.clamp(2 * L_len - 1, min=0)[:, None])
    end2 = torch.where(L_len > 0, end2[:, 0], neg(1)[:, 0])
    loss = -torch.logaddexp(end1, end2)
    if norm_by_times:
        loss = loss / torch.clamp(T_len.to(dt), min=1.0)
    return loss[:, None].to(logits.dtype)


# --------------------------------------------------------------------- NCE

@register_op("nce",
             inputs=["Input", "Label", "Weight", "Bias?", "SampleWeight?"],
             outputs=["Cost", "SampleLogits", "SampleLabels"])
def _nce(ctx, x, label, weight, bias, sample_weight):
    """Noise-contrastive estimation (nce_op.h:258-267): o = sigmoid(logit),
    b = P(class)·num_neg; cost -log(o/(o+b)) for the true classes and
    -log(b/(o+b)) for the negatives (attr custom_neg_classes, or a
    uniform / log_uniform draw from the op's generator)."""
    num_total = ctx.attr("num_total_classes")
    num_neg = ctx.attr("num_neg_samples", 10)
    sampler = ctx.attr("sampler", "uniform")
    custom = ctx.attr("custom_neg_classes", None)
    b = x.shape[0]
    dev = x.device
    label = label.reshape(b, -1).to(torch.int64)
    num_true = label.shape[1]
    if custom:
        negs = torch.tensor(custom, dtype=torch.int64, device=dev)[
            None, :].expand(b, len(custom))
        num_neg = len(custom)
    elif sampler == "log_uniform":
        u = torch.rand((b, num_neg), generator=ctx.rng(), device=dev)
        negs = (torch.exp(u * math.log(num_total + 1.0)) - 1.0).to(
            torch.int64).clamp(0, num_total - 1)
    else:
        negs = torch.randint(0, num_total, (b, num_neg),
                             generator=ctx.rng(), device=dev)
    samples = torch.cat([label, negs], dim=1)          # [B, num_true+neg]
    dt = at_least_f32_dtype(x, weight)
    logits = torch.einsum("bsd,bd->bs", weight[samples].to(dt), x.to(dt))
    if bias is not None:
        logits = logits + bias.reshape(-1)[samples]
    o = torch.sigmoid(logits)
    if sampler == "log_uniform":
        sc = samples.to(dt)
        prob = (torch.log(sc + 2.0) - torch.log(sc + 1.0)) / math.log(
            num_total + 1.0)
    else:
        prob = torch.full(samples.shape, 1.0 / num_total, dtype=dt,
                          device=dev)
    bq = prob * num_neg
    is_true = torch.arange(samples.shape[1], device=dev)[None, :] < num_true
    cost = torch.where(is_true, -torch.log(o / (o + bq)),
                       -torch.log(bq / (o + bq)))
    total = cost.sum(dim=1, keepdim=True)
    if sample_weight is not None:
        total = total * sample_weight.reshape(b, 1)
    return (total.to(x.dtype), logits.to(x.dtype),
            samples.to(torch.int32))


# ---------------------------------------------------------------- hsigmoid

@register_op("hsigmoid",
             inputs=["X", "Label", "W", "Bias?", "PathTable?", "PathCode?"],
             outputs=["Out", "PreOut"])
def _hsigmoid(ctx, x, label, w, bias, path_table, path_code):
    """Hierarchical sigmoid over SimpleCode's complete binary tree
    (matrix_bit_code.h:116-118: c = label + num_classes, node
    (c >> (bit+1)) - 1, bit c & (1 << bit), floor(log2 c) bits), or a
    custom tree (PathTable / PathCode, -1 padded). Keeps the reference's
    softplus(0) terms of the padded PreOut columns."""
    num_classes = ctx.attr("num_classes")
    b = x.shape[0]
    dev = x.device
    dt = at_least_f32_dtype(x, w)
    label = label.reshape(b).to(torch.int64)
    if path_table is not None:
        enforce(path_code is not None, "custom hsigmoid needs PathCode")
        idx = path_table.to(torch.int64)
        bits = path_code.to(dt)
        valid = idx >= 0
        idx = torch.clamp(idx, min=0)
    else:
        c = label + num_classes
        max_len = max(int(num_classes - 1).bit_length(), 1)
        j = torch.arange(max_len, device=dev)[None, :]
        length = torch.floor(torch.log2(c.to(torch.float32))).to(torch.int64)
        valid = j < length[:, None]
        idx = (c[:, None] >> (j + 1)) - 1
        idx = torch.where(valid, idx, torch.zeros_like(idx))
        bits = ((c[:, None] >> j) & 1).to(dt)
    pre = torch.einsum("bld,bd->bl", w[idx].to(dt), x.to(dt))
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    pre = torch.clamp(pre, -40.0, 40.0)
    zero = torch.zeros_like(pre)
    pre = torch.where(valid, pre, zero)
    out = (torch.logaddexp(pre, zero).sum(dim=1)
           - (torch.where(valid, bits, zero) * pre).sum(dim=1))
    return out[:, None].to(x.dtype), pre.to(x.dtype)


# ------------------------------------------------------- margin-style losses

@register_op("hinge_loss", inputs=["Logits", "Labels"], outputs=["Loss"])
def _hinge_loss(ctx, logits, labels):
    """hinge_loss_op.h: max(0, 1 - logits * (2*labels - 1))."""
    y = 1.0 - logits * (2.0 * labels - 1.0)
    return torch.maximum(torch.zeros_like(y), y)


@register_op("modified_huber_loss", inputs=["X", "Y"],
             outputs=["IntermediateVal", "Out"])
def _modified_huber_loss(ctx, x, y):
    """modified_huber_loss_op.h: z = x(2y-1); -4z if z < -1, (1-z)^2 if
    z < 1, else 0."""
    z = x * (2.0 * y - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, torch.square(1.0 - z),
                                   torch.zeros_like(z)))
    return z, loss


@register_op("squared_l2_distance", inputs=["X", "Y"],
             outputs=["sub_result", "Out"])
def _squared_l2_distance(ctx, x, y):
    """squared_l2_distance_op.h: row-wise ||x - y||^2, a one-row Y
    broadcast over the batch."""
    b = x.shape[0]
    xf = x.reshape(b, -1)
    sub = (xf - y.reshape(y.shape[0], -1)).expand(xf.shape)
    return sub, torch.square(sub).sum(dim=1, keepdim=True)


@register_op("center_loss",
             inputs=["X", "Label", "Centers", "CenterUpdateRate"],
             outputs=["SampleCenterDiff", "Loss", "CentersOut"])
def _center_loss(ctx, x, label, centers, alpha):
    """center_loss_op.h: diff = x - centers[label], loss 0.5||diff||^2;
    the centers move toward their class mean by alpha * sum(diff_c) /
    (1 + count_c). The centers get no gradient through the loss (the
    gather is detached), only through CentersOut."""
    num_classes = centers.shape[0]
    label = label.reshape(-1).to(torch.int64)
    diff = x - centers[label].detach()
    loss = 0.5 * torch.square(diff).sum(dim=1, keepdim=True)
    if ctx.attr("need_update", True):
        d = diff.detach()
        acc = torch.zeros((num_classes,) + tuple(d.shape[1:]), dtype=d.dtype,
                          device=d.device).index_add(0, label, d)
        count = torch.zeros(num_classes, dtype=x.dtype,
                            device=x.device).index_add(
            0, label, torch.ones_like(label, dtype=x.dtype))
        centers_out = centers + alpha.reshape(()) * acc / (1.0 + count[:, None])
    else:
        centers_out = centers
    return diff, loss, centers_out


@register_op("sampled_softmax_with_cross_entropy",
             inputs=["Logits", "Label", "CustomizedSamples?",
                     "CustomizedProbabilities?"],
             outputs=["Loss", "Samples"])
def _sampled_softmax_with_cross_entropy(ctx, logits, label, cust_s, cust_p):
    """sample_logits_op.h + softmax cross-entropy over the true classes
    and num_samples log-uniform negatives (P(c) = log((c+2)/(c+1)) /
    log(C+1), math/sample_prob.h), true classes first; log Q subtracted,
    accidental hits masked with -1e20."""
    num_samples = ctx.attr("num_samples")
    remove_hits = ctx.attr("remove_accidental_hits", True)
    b, c = logits.shape
    dev = logits.device
    dt = at_least_f32_dtype(logits)
    label = label.reshape(b, -1).to(torch.int64)
    num_true = label.shape[1]
    if cust_s is not None:
        samples = cust_s.reshape(b, -1).to(torch.int64)
        num_samples = samples.shape[1] - num_true
        neg = samples[:, num_true:]
        probs = (cust_p.reshape(b, -1).to(dt) if cust_p is not None
                 else torch.full((b, num_true + num_samples), 1.0 / c,
                                 dtype=dt, device=dev))
    else:
        if ctx.has_rng():
            u = torch.rand((b, num_samples), generator=ctx.rng(), device=dev)
        else:   # meta: shape inference
            u = torch.zeros((b, num_samples), device=dev)
        neg = (torch.exp(u * math.log(c + 1.0)) - 1.0).to(
            torch.int64).clamp(0, c - 1)
        allc = torch.cat([label, neg], dim=1)
        probs = (torch.log((allc + 2.0) / (allc + 1.0))
                 / math.log(c + 1.0)).to(dt)
    samples = torch.cat([label, neg], dim=1)
    g = torch.gather(logits.to(dt), 1, samples) - torch.log(
        torch.clamp(probs, min=1e-20))
    if remove_hits:
        hit = (neg[:, :, None] == label[:, None, :]).any(dim=2)
        g = g + torch.cat([torch.zeros((b, num_true), dtype=dt, device=dev),
                           torch.where(hit, -1e20, 0.0).to(dt)], dim=1)
    logp = torch.log_softmax(g, dim=1)
    loss = -logp[:, :num_true].mean(dim=1, keepdim=True)
    return loss.to(logits.dtype), samples.to(torch.int32)
