"""The long-tail layer ops of the fluid.layers surface.

Counterpart of paddle_tpu/ops/misc.py: all 50 of its op types, under the
JAX package's type and slot names, each after the reference kernel its
docstring names: the activations (brelu, soft_relu, selu, stanh, maxout,
lrn, the shrinks), norms and similarity (clip_by_norm, l2_normalize,
cos_sim), the losses (log_loss, rank_loss, margin_rank_loss, bpr_loss,
dice_loss, npair_loss, teacher_student_sigmoid_loss, fsp), the tensor
ops (multiplex, scatter_nd(_add), shard_index, space_to_depth,
shuffle_channel, unfold, crop_tensor, pad_constant_like, reverse,
add_position_encoding, bilinear_tensor_product, gather_tree,
conv3d_transpose, the sequence extras), the random ops
(*_batch_size_like, random_crop), and the metrics and decoders
(mean_iou, edit_distance, ctc_greedy_decoder, has_inf / has_nan,
is_empty, size, hash, unique(_with_counts)).

Where the JAX package runs a `lax.scan`, the port loops over the static
length and keeps each step batched: `gather_tree` walks T steps over
[B, K]; `edit_distance` computes one DP row for the whole batch a step,
its left-neighbour recurrence v[j] = min(base[j], v[j-1] + 1) as
j + cummin(base[k] - k), so a [B, Lh, Lr] problem is Lh steps of a few
launches, never B·Lh·Lr. Neither reads a value on the host, and neither
does `ctc_greedy_decoder` (a stable sort packs the kept tokens to the
left); `random_crop` picks its window with `index_select` on the drawn
offsets, so it does not read them either.

`hash` works in uint32 arithmetic carried in int64 and masked with
0xFFFFFFFF (torch lacks uint32 multiply and shift on some backends); a
32 x 32-bit product is split at 16 bits so no int64 overflows, and the
buckets equal the JAX package's bit for bit.

The random ops draw from the op's `torch.Generator` (ops/random.py's
rule): the numbers differ from the JAX package's `jax.random` draws, so
their contract is tested, not their bits (ROADMAP Queue 3).
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.nn import stable_sigmoid_ce
from paddle_tpu_torch.ops.random import _op_generator

_MASK32 = 0xFFFFFFFF


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _relu0(x):
    """max(x, 0) with jnp.maximum's derivative (1/2 at a tie)."""
    return torch.maximum(x, _zero(x))


# ---------------------------------------------------------- activations
@register_op("brelu", inputs=["X"], outputs=["Out"])
def _brelu(ctx, x):
    return torch.clamp(x, ctx.attr("t_min", 0.0), ctx.attr("t_max", 24.0))


@register_op("soft_relu", inputs=["X"], outputs=["Out"])
def _soft_relu(ctx, x):
    t = ctx.attr("threshold", 40.0)
    return torch.log1p(torch.exp(torch.clamp(x, -t, t)))


@register_op("selu", inputs=["X"], outputs=["Out"])
def _selu(ctx, x):
    scale = ctx.attr("scale", 1.0507009873554805)
    alpha = ctx.attr("alpha", 1.6732632423543772)
    return scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


@register_op("stanh", inputs=["X"], outputs=["Out"])
def _stanh(ctx, x):
    return ctx.attr("scale_b", 1.7159) * torch.tanh(
        ctx.attr("scale_a", 0.67) * x)


@register_op("maxout", inputs=["X"], outputs=["Out"])
def _maxout(ctx, x):
    g = ctx.attr("groups")
    n, c = x.shape[0], x.shape[1]
    return torch.amax(x.reshape((n, c // g, g) + tuple(x.shape[2:])), dim=2)


@register_op("lrn", inputs=["X"], outputs=["Out"])
def _lrn(ctx, x):
    """lrn_op.cc: cross-channel local response normalization (NCHW)."""
    n_ = ctx.attr("n", 5)
    k = ctx.attr("k", 1.0)
    alpha = ctx.attr("alpha", 1e-4)
    beta = ctx.attr("beta", 0.75)
    half = n_ // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = pad[:, 0:c]
    for i in range(1, n_):
        acc = acc + pad[:, i:i + c]
    return x / torch.pow(k + alpha * acc, beta)


@register_op("hard_shrink", inputs=["X"], outputs=["Out"])
def _hard_shrink(ctx, x):
    """activation_op.cc HardShrink: x where |x| > threshold, else 0."""
    return torch.where(torch.abs(x) > ctx.attr("threshold", 0.5), x, _zero(x))


@register_op("softshrink", inputs=["X"], outputs=["Out"])
def _softshrink(ctx, x):
    """activation_op.cc SoftShrink: sign(x) max(|x| - lambda, 0)."""
    return torch.sign(x) * _relu0(torch.abs(x) - ctx.attr("lambda", 0.5))


@register_op("thresholded_relu", inputs=["X"], outputs=["Out"])
def _thresholded_relu(ctx, x):
    return torch.where(x > ctx.attr("threshold", 1.0), x, _zero(x))


# ---------------------------------------------------------- norms / sim
@register_op("clip_by_norm", inputs=["X"], outputs=["Out"])
def _clip_by_norm(ctx, x):
    m = torch.full((), ctx.attr("max_norm"), dtype=x.dtype, device=x.device)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return x * (m / torch.maximum(norm, m))


@register_op("l2_normalize", inputs=["X"], outputs=["Out"])
def _l2_normalize(ctx, x):
    ss = torch.sum(torch.square(x), dim=ctx.attr("axis", -1), keepdim=True)
    eps = torch.full((), ctx.attr("epsilon", 1e-12), dtype=x.dtype,
                     device=x.device)
    return x / torch.sqrt(torch.maximum(ss, eps))


@register_op("cos_sim", inputs=["X", "Y"], outputs=["Out"])
def _cos_sim(ctx, x, y):
    """cos_sim_op.cc: row-wise cosine; Y broadcasts along the batch."""
    y = torch.broadcast_to(y, x.shape)
    num = torch.sum(x * y, dim=-1, keepdim=True)
    den = (torch.sqrt(torch.sum(x * x, -1, keepdim=True))
           * torch.sqrt(torch.sum(y * y, -1, keepdim=True)))
    return num / torch.clamp(den, min=1e-12)


# ---------------------------------------------------------------- losses
@register_op("log_loss", inputs=["Predicted", "Labels"], outputs=["Loss"])
def _log_loss(ctx, p, label):
    eps = ctx.attr("epsilon", 1e-4)
    return -label * torch.log(p + eps) - (1 - label) * torch.log(1 - p + eps)


@register_op("rank_loss", inputs=["Label", "Left", "Right"], outputs=["Out"])
def _rank_loss(ctx, label, left, right):
    """rank_loss_op.h:40: log(1 + exp(o)) - label o."""
    o = left - right
    return torch.log1p(torch.exp(o)) - label * o


@register_op("margin_rank_loss", inputs=["Label", "X1", "X2"],
             outputs=["Out", "Activated"])
def _margin_rank_loss(ctx, label, x1, x2):
    raw = ctx.attr("margin", 0.1) - label * (x1 - x2)
    return _relu0(raw), (raw > 0).to(x1.dtype)


@register_op("bpr_loss", inputs=["X", "Label"], outputs=["Loss"])
def _bpr_loss(ctx, x, label):
    """bpr_loss_op: mean over j != label of -log sigmoid(x_label - x_j)."""
    d = x.shape[1]
    lbl = label.reshape(-1).long()
    pos = torch.gather(x, 1, lbl[:, None])
    ll = torch.log(torch.sigmoid(pos - x) + 1e-12)
    mask = (torch.arange(d, device=x.device)[None, :] != lbl[:, None])
    return -torch.sum(ll * mask.to(x.dtype), dim=1, keepdim=True) / (d - 1)


@register_op("dice_loss", inputs=["X", "Label"], outputs=["Out"])
def _dice_loss(ctx, x, label):
    axes = tuple(range(1, x.dim()))
    inter = torch.sum(x * label, dim=axes)
    den = torch.sum(x, dim=axes) + torch.sum(label, dim=axes)
    return torch.mean(1.0 - 2.0 * inter / (den + ctx.attr("epsilon", 1e-5)))


@register_op("npair_loss", inputs=["Anchor", "Positive", "Labels"],
             outputs=["Out"])
def _npair_loss(ctx, anchor, positive, labels):
    """npair_loss (layers/nn.py): cross-entropy over anchor . positive^T
    with same-label targets, plus an L2 term on the embeddings."""
    reg = ctx.attr("l2_reg", 0.002)
    lbl = labels.reshape(-1)
    sim = anchor @ positive.T                               # [N, N]
    tgt = (lbl[:, None] == lbl[None, :]).to(sim.dtype)
    tgt = tgt / torch.sum(tgt, dim=1, keepdim=True)
    ce = -torch.mean(torch.sum(tgt * torch.log_softmax(sim, dim=1), dim=1))
    l2 = torch.mean(torch.sum(anchor * anchor, 1)
                    + torch.sum(positive * positive, 1)) * reg * 0.25
    return ce + l2


@register_op("teacher_student_sigmoid_loss", inputs=["X", "Label"],
             outputs=["Y"])
def _ts_sigmoid_loss(ctx, x, label):
    """teacher_student_sigmoid_loss_op.h's label encoding: -2 = click 0
    with no teacher, -1 = click 1 with no teacher, [0, 1) = click 0 and
    teacher score z', [1, 2] = click 1 and teacher score z' - 1; the
    hard-click sigmoid CE plus, with a teacher, the soft one against z'."""
    neg, pos = stable_sigmoid_ce(x, 0.0), stable_sigmoid_ce(x, 1.0)
    teacher_neg = neg + stable_sigmoid_ce(x, label)
    teacher_pos = pos + stable_sigmoid_ce(x, label - 1.0)
    return torch.where(label < -1.0, neg, torch.where(
        label < 0.0, pos, torch.where(label < 1.0, teacher_neg,
                                      teacher_pos)))


@register_op("fsp", inputs=["X", "Y"], outputs=["Out"])
def _fsp(ctx, x, y):
    """fsp_op.cc (distillation): x [N, C1, H, W], y [N, C2, H, W] ->
    [N, C1, C2] = x . y^T / (H W)."""
    n, c1, h, w = x.shape
    xf = x.reshape(n, c1, h * w)
    yf = y.reshape(n, y.shape[1], h * w)
    return torch.einsum("nch,ndh->ncd", xf, yf) / (h * w)


# ---------------------------------------------------------------- tensor
@register_op("multiplex", inputs=["X[]", "Ids"], outputs=["Out"])
def _multiplex(ctx, xs, ids):
    """multiplex_op: out[n] = X[ids[n]][n]."""
    stacked = torch.stack(xs)                              # [K, N, ...]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[ids.reshape(-1).long(), rows]


def _nd_index(index):
    return tuple(index.long().unbind(-1))


@register_op("scatter_nd_add", inputs=["X", "Index", "Updates"],
             outputs=["Out"])
def _scatter_nd_add(ctx, x, index, updates):
    return x.index_put(_nd_index(index), updates, accumulate=True)


@register_op("scatter_nd", inputs=["Index", "Updates"], outputs=["Out"])
def _scatter_nd(ctx, index, updates):
    zeros = torch.zeros(tuple(ctx.attr("shape")), dtype=updates.dtype,
                        device=updates.device)
    return zeros.index_put(_nd_index(index), updates, accumulate=True)


@register_op("shard_index", inputs=["X"], outputs=["Out"])
def _shard_index(ctx, x):
    nshards = ctx.attr("nshards")
    shard_size = (ctx.attr("index_num") + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == \
        ctx.attr("shard_id")
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full_like(x, ctx.attr("ignore_value", -1)))


@register_op("space_to_depth", inputs=["X"], outputs=["Out"])
def _space_to_depth(ctx, x):
    b = ctx.attr("blocksize")
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


@register_op("shuffle_channel", inputs=["X"], outputs=["Out"])
def _shuffle_channel(ctx, x):
    g = ctx.attr("group")
    n, c, h, w = x.shape
    return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)


@register_op("unfold", inputs=["X"], outputs=["Y"])
def _unfold(ctx, x):
    """unfold_op (im2col): NCHW -> [N, C kh kw, L], each column's
    features in (C, kh, kw) order."""
    kh, kw = ctx.attr("kernel_sizes")
    p = ctx.attr("paddings", [0, 0])
    p = [p, p] if isinstance(p, int) else list(p)
    if len(p) == 1:
        p = [p[0]] * 4
    elif len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    # fluid's 4-list is [top, left, bottom, right]
    x = F.pad(x, (p[1], p[3], p[0], p[2]))
    return F.unfold(x, (kh, kw), dilation=tuple(ctx.attr("dilations",
                                                         [1, 1])),
                    stride=tuple(ctx.attr("strides", [1, 1])))


@register_op("crop_tensor", inputs=["X"], outputs=["Out"])
def _crop_tensor(ctx, x):
    offsets = ctx.attr("offsets", [0] * x.dim())
    idx = tuple(slice(o, o + s) for o, s in zip(offsets, ctx.attr("shape")))
    return x[idx]


@register_op("pad_constant_like", inputs=["X", "Y"], outputs=["Out"])
def _pad_constant_like(ctx, x, y):
    """pad_constant_like_op: pad Y up to X's shape with pad_value."""
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(xs) - int(ys)]
    return F.pad(y, pads, value=ctx.attr("pad_value", 0.0))


@register_op("reverse", inputs=["X"], outputs=["Out"])
def _reverse(ctx, x):
    return torch.flip(x, dims=tuple(ctx.attr("axis")))


@register_op("add_position_encoding", inputs=["X"], outputs=["Out"])
def _add_position_encoding(ctx, x):
    """add_position_encoding_op.h:63-75: a half-split sinusoid with
    denominator 10000^(k / (half - 1)), made in float32 (float64 for a
    float64 input: `at_least_f32`'s rule, where the JAX package, x64
    off, has only float32)."""
    b, t, c = x.shape
    half = c // 2
    dt = at_least_f32_dtype(x)
    pos = torch.arange(t, dtype=dt, device=x.device)[:, None]
    k = torch.arange(half, dtype=dt, device=x.device)[None, :]
    val = pos / torch.pow(10000.0, k / max(half - 1, 1))     # [T, half]
    pe = torch.cat([torch.sin(val), torch.cos(val)], dim=1)
    return x * ctx.attr("alpha", 1.0) + pe[None].to(x.dtype) * \
        ctx.attr("beta", 1.0)


@register_op("bilinear_tensor_product", inputs=["X", "Y", "Weight", "Bias?"],
             outputs=["Out"])
def _bilinear_tensor_product(ctx, x, y, w, bias):
    """bilinear_tensor_product_op: out_k = x W_k y^T + b; W [K, M, N]."""
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return out


@register_op("gather_tree", inputs=["Ids", "Parents"], outputs=["Out"])
def _gather_tree(ctx, ids, parents):
    """gather_tree_op: walk the beam parents from the last step back —
    ids / parents [T, B, K] -> whole sequences [T, B, K] (int32)."""
    t, b, k = ids.shape
    if ids.is_meta:
        return torch.empty((t, b, k), dtype=torch.int32, device="meta")
    beam = torch.arange(k, device=ids.device).expand(b, k)
    toks = [None] * t
    for step in range(t - 1, -1, -1):
        toks[step] = torch.gather(ids[step].long(), 1, beam)
        beam = torch.gather(parents[step].long(), 1, beam)
    return torch.stack(toks).to(torch.int32)


@register_op("conv3d_transpose", inputs=["Input", "Filter", "Bias?"],
             outputs=["Output"])
def _conv3d_transpose(ctx, x, w, bias):
    """conv3d_transpose_op: NCDHW, IODHW filter, fluid's output size
    (D - 1) s - 2 p + k (the conv3d gradient)."""
    def _t(v):
        return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)
    return F.conv_transpose3d(x, w, bias, stride=_t(ctx.attr("strides",
                                                             [1, 1, 1])),
                              padding=_t(ctx.attr("paddings", [0, 0, 0])))


# ---------------------------------------------------------------- random
def _batch_size_like_shape(ctx, ref):
    shape = [int(s) for s in ctx.attr("shape")]
    shape[ctx.attr("output_dim_idx", 0)] = int(
        ref.shape[ctx.attr("input_dim_idx", 0)])
    return tuple(shape)


@register_op("gaussian_random_batch_size_like", inputs=["Input"],
             outputs=["Out"])
def _gaussian_random_bsl(ctx, ref):
    noise = torch.randn(_batch_size_like_shape(ctx, ref),
                        generator=_op_generator(ctx), dtype=torch.float32,
                        device=ctx.device)
    return ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * noise


@register_op("uniform_random_batch_size_like", inputs=["Input"],
             outputs=["Out"])
def _uniform_random_bsl(ctx, ref):
    out = torch.empty(_batch_size_like_shape(ctx, ref), dtype=torch.float32,
                      device=ctx.device)
    return out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                        generator=_op_generator(ctx))


@register_op("random_crop", inputs=["X"], outputs=["Out"])
def _random_crop(ctx, x):
    """random_crop_op: the trailing dims cropped to `shape` at offsets
    drawn from the op's generator, one a dim; the window is taken with
    index_select on the drawn offsets (no host read)."""
    shape = ctx.attr("shape")
    lead = x.dim() - len(shape)
    gen = _op_generator(ctx)
    out = x
    for i, s in enumerate(shape):
        dim = lead + i
        start = torch.randint(0, int(x.shape[dim]) - s + 1, (1,),
                              generator=gen, device=ctx.device)
        out = out.index_select(dim, start + torch.arange(
            s, device=ctx.device))
    return out


# --------------------------------------------------- metrics / decoding
@register_op("mean_iou", inputs=["Predictions", "Labels"],
             outputs=["OutMeanIou", "OutWrong", "OutCorrect"])
def _mean_iou(ctx, pred, label):
    c = ctx.attr("num_classes")
    p_oh = F.one_hot(pred.reshape(-1).long(), c)
    l_oh = F.one_hot(label.reshape(-1).long(), c)
    inter = torch.sum(p_oh * l_oh, dim=0)                   # exact, int64
    union = torch.sum(p_oh, 0) + torch.sum(l_oh, 0) - inter
    valid = union > 0
    iou = torch.where(valid, inter.float() / torch.clamp(union, min=1),
                      torch.zeros((), device=inter.device))
    # the float32 IoUs summed in float64, so no summation order shows
    mean = (torch.sum(iou.double()) / torch.clamp(torch.sum(valid),
                                                  min=1)).float()
    wrong = torch.sum(p_oh * (1 - l_oh), dim=0).to(torch.int32)
    return mean, wrong, inter.to(torch.int32)


def _lengths(length, b, full, device):
    if length is None:
        return torch.full((b,), full, dtype=torch.int64, device=device)
    return length.reshape(-1).long()


@register_op("edit_distance", inputs=["Hyps", "Refs", "HypsLength?",
                                      "RefsLength?"],
             outputs=["Out", "SequenceNum"])
def _edit_distance(ctx, hyps, refs, hyp_len, ref_len):
    """edit_distance_op.cc: the Levenshtein distance of each pair of
    dense [B, L] id rows with lengths, in float32; `normalized` divides
    by the reference length (at least 1).

    One DP row over the whole batch a step: base[j] = min(up + 1,
    diag + cost), and the left-neighbour recurrence
    v[j] = min(base[j], v[j-1] + 1), v[0] = i, is j + cummin(base[k] - k).
    As in the reference, cells past a row's reference length hold 1e9
    and a row stops changing after its hypothesis length."""
    b, lh = hyps.shape
    lr = refs.shape[1]
    dev = hyps.device
    seq_num = torch.full((1,), b, dtype=torch.int32, device=dev)
    if hyps.is_meta:
        return torch.empty((b, 1), dtype=torch.float32, device=dev), seq_num
    hl = _lengths(hyp_len, b, lh, dev)
    rl = _lengths(ref_len, b, lr, dev)
    j = torch.arange(lr + 1, device=dev)
    jf = j.to(torch.float32)
    past = j[None, :] > rl[:, None]                         # [B, Lr+1]
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)
    row = torch.where(past, big, jf.expand(b, lr + 1))
    h = hyps.long()
    r = refs.long()
    for i in range(1, lh + 1):
        cost = (h[:, i - 1:i] != r).to(torch.float32)       # [B, Lr]
        base = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost)
        first = torch.full((b, 1), float(i), dtype=torch.float32,
                           device=dev)
        base = torch.cat([first, base], dim=1) - jf
        new = torch.cummin(base, dim=1).values + jf
        new = torch.where(past, big, new)
        row = torch.where((i <= hl)[:, None], new, row)
    # a reference length past the refs' width reads the last cell, as
    # the JAX op's clamped index does
    d = torch.gather(row, 1, torch.clamp(rl, 0, lr)[:, None])
    if ctx.attr("normalized", True):
        d = d / torch.clamp(rl.to(torch.float32), min=1.0)[:, None]
    return d, seq_num


@register_op("ctc_greedy_decoder", inputs=["Input", "Length?"],
             outputs=["Out", "OutLength"])
def _ctc_greedy_decoder(ctx, probs, length):
    """ctc_align_op: the argmax path (lowest index on ties), repeats
    collapsed (against the raw argmax, so a repeat split by a blank
    counts twice), blanks dropped, steps past the length dropped; the
    kept tokens packed to the left by a stable sort into a static
    [B, T] int32 padded with -1, and OutLength [B] int32."""
    b, t, _ = probs.shape
    dev = probs.device
    if probs.is_meta:
        return (torch.empty((b, t), dtype=torch.int32, device=dev),
                torch.empty((b,), dtype=torch.int32, device=dev))
    ids = torch.argmax(probs, dim=-1)                       # [B, T]
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype, device=dev),
                      ids[:, :-1]], dim=1)
    pos = torch.arange(t, device=dev)
    tmask = pos[None, :] < _lengths(length, b, t, dev)[:, None]
    keep = (ids != ctx.attr("blank", 0)) & (ids != prev) & tmask
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    count = keep.sum(dim=1)
    packed = torch.where(pos[None, :] < count[:, None],
                         torch.gather(ids, 1, order),
                         torch.full_like(ids, -1))
    return packed.to(torch.int32), count.to(torch.int32)


@register_op("has_inf", inputs=["X"], outputs=["Out"])
def _has_inf(ctx, x):
    return torch.any(torch.isinf(x)).reshape(1)


@register_op("has_nan", inputs=["X"], outputs=["Out"])
def _has_nan(ctx, x):
    return torch.any(torch.isnan(x)).reshape(1)


@register_op("is_empty", inputs=["X"], outputs=["Out"])
def _is_empty(ctx, x):
    return torch.full((1,), x.numel() == 0, dtype=torch.bool,
                      device=x.device)


@register_op("size", inputs=["Input"], outputs=["Out"])
def _size(ctx, x):
    return torch.full((), x.numel(), dtype=torch.int32, device=x.device)


# -------------------------------------------------------- sequence extras
@register_op("sequence_enumerate", inputs=["X", "Length?"], outputs=["Out"])
def _sequence_enumerate(ctx, x, length):
    """sequence_enumerate_op: sliding win_size windows of ids, pad_value
    past each row's length."""
    win = ctx.attr("win_size")
    pad = ctx.attr("pad_value", 0)
    b, t = x.shape
    lengths = _lengths(length, b, t, x.device)
    pos = torch.arange(t, device=x.device)[None, :]
    padv = torch.full((), pad, dtype=x.dtype, device=x.device)
    cols = []
    for k in range(win):
        shifted = F.pad(x[:, k:], (0, k), value=pad)
        cols.append(torch.where(pos + k < lengths[:, None], shifted, padv))
    return torch.stack(cols, dim=-1)                        # [B, T, win]


@register_op("sequence_scatter", inputs=["X", "Ids", "Updates", "Length?"],
             outputs=["Out"])
def _sequence_scatter(ctx, x, ids, updates, length):
    """sequence_scatter_op on dense rows: x[b, ids[b, j]] += updates[b, j]
    for j < length[b]."""
    b, m = ids.shape
    mask = (torch.arange(m, device=x.device)[None, :]
            < _lengths(length, b, m, x.device)[:, None])
    rows = torch.arange(b, device=x.device)[:, None].expand(b, m)
    return x.index_put((rows.reshape(-1), ids.long().reshape(-1)),
                       (updates * mask.to(updates.dtype)).reshape(-1),
                       accumulate=True)


@register_op("sequence_reshape", inputs=["X"], outputs=["Out"])
def _sequence_reshape(ctx, x):
    """sequence_reshape_op: the time x feature product redistributed to
    a new feature width."""
    return x.reshape(x.shape[0], -1, ctx.attr("new_dim"))


# ------------------------------------------------------------------ hash
def _mul32(a, c):
    """(a * c) mod 2^32 for a in [0, 2^32) int64 and a constant c in
    [0, 2^32), split at 16 bits so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


@register_op("hash", inputs=["X"], outputs=["Out"])
def _hash(ctx, x):
    """hash_op: int ids into num_hash buckets of mod_by; the JAX
    package's Knuth multiplicative mix (for the reference's xxhash), in
    uint32 arithmetic carried in int64: [N, num_hash, K] int32."""
    mod_by = ctx.attr("mod_by")
    ids = x.reshape(x.shape[0], -1).long() & _MASK32
    outs = []
    for i in range(ctx.attr("num_hash", 1)):
        mixed = _mul32((ids + ((i * 0x9E3779B9) & _MASK32)) & _MASK32,
                       2654435761)
        mixed = mixed ^ (mixed >> 16)
        outs.append(torch.remainder(mixed, mod_by).to(torch.int32))
    return torch.stack(outs, dim=1)


# ----------------------------------------------------------------- unique
@register_op("unique_with_counts", inputs=["X"],
             outputs=["Out", "Index", "Count"])
def _unique_with_counts(ctx, x):
    """unique_with_counts_op.cc under the static-shape contract: Out is
    the sorted unique values padded to len(X) with X's first value;
    Index maps each element to its slot in Out; Count is 0 on the
    padding. Index and Count are int64, the port's index dtype (the
    JAX package's with x64 on). `torch.unique` synchronises with the
    host on CUDA (its output length is data-dependent) before the
    padding restores the static shape."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    if x.is_meta:
        return (torch.empty((n,), dtype=x.dtype, device="meta"),
                torch.empty(tuple(x.shape), dtype=torch.int64,
                            device="meta"),
                torch.empty((n,), dtype=torch.int64, device="meta"))
    uniq, idx, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True)
    k = uniq.shape[0]
    enforce(k <= n, "unique found %d values in %d", k, n)
    out = torch.cat([uniq, flat[:1].expand(n - k)])
    counts = torch.cat([counts, counts.new_zeros(n - k)])
    return out, idx.reshape(x.shape).long(), counts.long()


@register_op("unique", inputs=["X"], outputs=["Out", "Index"])
def _unique(ctx, x):
    """unique_op.cc: unique_with_counts without Count."""
    out, idx, _ = _unique_with_counts(ctx, x)
    return out, idx
