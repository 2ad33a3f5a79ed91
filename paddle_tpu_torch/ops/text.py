"""Text and structured-input ops.

Counterpart of paddle_tpu/ops/text.py, all seven of its op types:

* conv_shift — operators/conv_shift_op.cc (the Neural Turing Machine's
  circular convolution): Out[i][k] = sum_j X[i][(k + j - M/2) mod N]
  Y[i][j].
* similarity_focus — operators/similarity_focus_op.cc: per (batch,
  index) slice, greedy maxima with distinct rows and columns (min(D1,
  D2) picks), the masks OR-ed over the indexes and broadcast to the
  input's shape. The picks loop over the static count, each batched
  over every slice.
* chunk_eval — operators/chunk_eval_op.h: IOB / IOE / IOBES / plain
  chunks from position-wise ChunkBegin / ChunkEnd flags; each chunk's
  end is the next end boundary, a reverse cummin here where the JAX
  package runs a reverse scan; precision, recall, F1 and the counts.
* match_matrix_tensor — operators/match_matrix_tensor_op.cc:
  Out[b, t, i, j] = x_i^T W_t y_j on the length-masked [B, L, D] batch;
  Tmp is X W.
* var_conv_2d — operators/var_conv_2d_op.cc: one batched conv over the
  masked [B, C, Hmax, Wmax] maps, each sample's valid output region
  kept.
* tree_conv — operators/tree_conv_op.h + math/tree2col.cc (TBCNN, arXiv
  1409.5718), which the eager `TreeConv` layer runs: per-root patches of
  the nodes within max_depth, continuous-binary-tree weights eta_l /
  eta_r / eta_t combined with the [F, 3, out, filters] filter. Patch
  membership is reachability by repeated boolean matmuls over the child
  adjacency (a batch dimension here where the JAX package vmaps).
* pyramid_hash — pyramid_hash_op.cc: each n-gram of 2..pyramid_layer
  ids hashed (the JAX package's murmur3-finalizer mix, in uint32
  arithmetic carried in int64 and masked, so the buckets equal the JAX
  package's bit for bit) to rows of W. Training-time dropout draws from
  the op's `torch.Generator` (ROADMAP Queue 3).
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.misc import _MASK32, _mul32
from paddle_tpu_torch.ops.random import _op_generator


# ------------------------------------------------------------ conv_shift
@register_op("conv_shift", inputs=["X", "Y"], outputs=["Out"])
def _conv_shift(ctx, x, y):
    n = x.shape[1]
    m = y.shape[1]
    k = torch.arange(n, device=x.device)[:, None]
    j = torch.arange(m, device=x.device)[None, :]
    idx = torch.remainder(k + j - m // 2, n)                 # [N, M]
    return torch.einsum("bnm,bm->bn", x[:, idx], y)


# ------------------------------------------------------ similarity_focus
@register_op("similarity_focus", inputs=["X"], outputs=["Out"])
def _similarity_focus(ctx, x):
    axis = ctx.attr("axis")
    indexes = list(ctx.attr("indexes"))
    enforce(x.dim() == 4, "similarity_focus expects a 4-D input")
    enforce(axis in (1, 2, 3), "similarity_focus axis must be 1, 2 or 3")
    perm = (0, axis) + tuple(d for d in (1, 2, 3) if d != axis)
    xt = x.permute(perm)
    d1, d2 = xt.shape[2], xt.shape[3]
    sl = xt[:, indexes]                                      # [B, I, D1, D2]
    b, i = sl.shape[0], sl.shape[1]
    flat = sl.reshape(b * i, d1 * d2)
    rows = torch.zeros((b * i, d1), dtype=torch.bool, device=x.device)
    cols = torch.zeros((b * i, d2), dtype=torch.bool, device=x.device)
    mask = torch.zeros((b * i, d1 * d2), dtype=x.dtype, device=x.device)
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    one = torch.ones((b * i, 1), dtype=x.dtype, device=x.device)
    true = torch.ones((b * i, 1), dtype=torch.bool, device=x.device)
    for _ in range(min(d1, d2)):
        avail = (~rows[:, :, None]) & (~cols[:, None, :])
        pick = torch.argmax(torch.where(avail.reshape(b * i, -1), flat, neg),
                            dim=1, keepdim=True)
        rows = rows.scatter(1, torch.div(pick, d2, rounding_mode="floor"),
                            true)
        cols = cols.scatter(1, torch.remainder(pick, d2), true)
        mask = mask.scatter(1, pick, one)
    mask = torch.amax(mask.reshape(b, i, d1, d2), dim=1, keepdim=True)
    mask = mask.expand(tuple(xt.shape))
    return mask.permute([perm.index(d) for d in range(4)])


# ------------------------------------------------------------ chunk_eval
_SCHEMES = {
    # (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, 0),
}


def _chunk_flags(labels, lengths, scheme, num_chunk_types):
    """Per-position chunk-begin flags, end-boundary flags and types,
    ChunkBegin / ChunkEnd of chunk_eval_op.h:84-106."""
    ntag, tb, ti, te, ts = _SCHEMES[scheme]
    other = num_chunk_types
    pos = torch.arange(labels.shape[1], device=labels.device)[None, :]
    in_len = lengths[:, None] > pos
    t = torch.where(in_len, labels, torch.full_like(labels, other * ntag))
    tag = torch.remainder(t, ntag)
    typ = torch.div(t, ntag, rounding_mode="floor")
    ptag = torch.cat([torch.full_like(tag[:, :1], -1), tag[:, :-1]], 1)
    ptyp = torch.cat([torch.full_like(typ[:, :1], other), typ[:, :-1]], 1)
    p_other, c_other, changed = ptyp == other, typ == other, typ != ptyp
    p_closes = (ptag == te) | (ptag == ts)
    begin = torch.where(p_other, ~c_other, ~c_other & (
        changed | (tag == tb) | (((tag == ti) | (tag == te)) & p_closes)
        | (tag == ts)))
    c_opens = (tag == tb) | (tag == ts)
    end = ~p_other & (c_other | changed | (((ptag == tb) | (ptag == ti))
                                            & c_opens)
                      | (ptag == te) | (ptag == ts))
    return begin & in_len, end, typ


def _next_end(endb):
    """next_end[i]: the smallest j >= i with an end boundary after j
    (at j + 1, or the row's end) — a reverse cummin."""
    t = endb.shape[1]
    closes = torch.cat([endb[:, 1:], torch.ones_like(endb[:, :1])], 1)
    j = torch.arange(t, device=endb.device)[None, :].expand_as(closes)
    vals = torch.where(closes, j, torch.full_like(j, t - 1))
    return torch.flip(torch.cummin(torch.flip(vals, [1]), 1).values, [1])


@register_op("chunk_eval",
             inputs=["Inference", "Label", "SeqLength?"],
             outputs=["Precision", "Recall", "F1-Score", "NumInferChunks",
                      "NumLabelChunks", "NumCorrectChunks"])
def _chunk_eval(ctx, inference, label, seq_length):
    scheme = ctx.attr("chunk_scheme", "IOB")
    nct = ctx.attr("num_chunk_types")
    excluded = ctx.attr("excluded_chunk_types", []) or []
    b, t = inference.shape[0], inference.shape[1]
    inf = inference.reshape(b, t).long()
    lab = label.reshape(b, t).long()
    lengths = (torch.full((b,), t, dtype=torch.int64, device=inf.device)
               if seq_length is None else seq_length.reshape(-1).long())
    ib, ie, it = _chunk_flags(inf, lengths, scheme, nct)
    lb, le, lt = _chunk_flags(lab, lengths, scheme, nct)

    def kept(flags, typ):
        for ex in excluded:
            flags = flags & (typ != ex)
        return flags

    match = kept(ib & lb & (it == lt) & (_next_end(ie) == _next_end(le)),
                 it)
    num_inf = kept(ib, it).sum()
    num_lab = kept(lb, lt).sum()
    num_cor = match.sum()
    zero = torch.zeros((), dtype=torch.float32, device=inf.device)
    prec = torch.where(num_inf > 0, num_cor / num_inf, zero)
    rec = torch.where(num_lab > 0, num_cor / num_lab, zero)
    f1 = torch.where(num_cor > 0, 2 * prec * rec / (prec + rec), zero)
    return tuple(v.reshape(1).to(dt) for v, dt in (
        (prec, torch.float32), (rec, torch.float32), (f1, torch.float32),
        (num_inf, torch.int32), (num_lab, torch.int32),
        (num_cor, torch.int32)))


# ------------------------------------------------- match_matrix_tensor
@register_op("match_matrix_tensor",
             inputs=["X", "Y", "W", "LengthsX?", "LengthsY?"],
             outputs=["Out", "Tmp"])
def _match_matrix_tensor(ctx, x, y, w, lx, ly):
    enforce(w.shape[1] == ctx.attr("dim_t", w.shape[1]),
            "match_matrix W dim_t mismatch")
    tmp = torch.einsum("bid,dte->bite", x, w)                 # X . W
    out = torch.einsum("bite,bje->btij", tmp, y)
    if lx is not None:
        mx = lx.reshape(-1)[:, None] > torch.arange(x.shape[1],
                                                    device=x.device)[None]
        out = out * mx[:, None, :, None].to(out.dtype)
    if ly is not None:
        my = ly.reshape(-1)[:, None] > torch.arange(y.shape[1],
                                                    device=y.device)[None]
        out = out * my[:, None, None, :].to(out.dtype)
    return out, tmp


# ------------------------------------------------------------ var_conv_2d
@register_op("var_conv_2d", inputs=["X", "W", "ROW", "COLUMN"],
             outputs=["Out"])
def _var_conv_2d(ctx, x, w, row, col):
    """x [B, C, Hmax, Wmax]; row / col each sample's valid height and
    width (the reference's 2-level LoD)."""
    cin = ctx.attr("InputChannel", x.shape[1])
    cout = ctx.attr("OutputChannel", w.shape[0])
    kh, kw = ctx.attr("KernelH", 3), ctx.attr("KernelW", 3)
    sh, sw = ctx.attr("StrideH", 1), ctx.attr("StrideW", 1)
    b, c, h, wd = x.shape
    enforce(c == cin, "var_conv_2d InputChannel mismatch")
    row = row.reshape(-1)
    col = col.reshape(-1)
    hh = torch.arange(h, device=x.device)[None, :]
    ww = torch.arange(wd, device=x.device)[None, :]
    xm = (x * (hh < row[:, None]).to(x.dtype)[:, None, :, None]
          * (ww < col[:, None]).to(x.dtype)[:, None, None, :])
    xm = F.pad(xm, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2))
    out = F.conv2d(xm, w.reshape(cout, cin, kh, kw), stride=(sh, sw))
    oh, ow = out.shape[2], out.shape[3]
    zero = torch.zeros_like(row)
    orow = torch.where(row > 0, torch.div(row - 1, sh, rounding_mode="floor")
                       + 1, zero)
    ocol = torch.where(col > 0, torch.div(col - 1, sw, rounding_mode="floor")
                       + 1, zero)
    om = ((torch.arange(oh, device=x.device)[None, :] < orow[:, None])
          [:, None, :, None]
          & (torch.arange(ow, device=x.device)[None, :] < ocol[:, None])
          [:, None, None, :])
    return out * om.to(out.dtype)


@register_op("tree_conv", inputs=["NodesVector", "EdgeSet", "Filter"],
             outputs=["Out"])
def _tree_conv(ctx, nodes, edges, filt):
    """nodes: [B, N, F]; edges: [B, E, 2] (1-indexed (parent, child),
    all-zero rows pad); filt: [F, 3, out_size, num_filters]; node slot 0
    of `nodes` is node id 1. Out: [B, N, out_size, num_filters]."""
    k = float(ctx.attr("max_depth", 2))
    b, n, f = nodes.shape
    fdim, three, _, _ = filt.shape
    enforce(three == 3 and fdim == f, "tree_conv Filter must be [F,3,o,m]")
    dt = at_least_f32_dtype(nodes, filt)
    dev = nodes.device
    nodes_f = nodes.to(dt)
    par = edges[..., 0].long()
    chd = edges[..., 1].long()
    valid = (par > 0) & (chd > 0)                               # [B, E]
    e = par.shape[1]
    # child adjacency over node ids 1..N -> 0-based
    flat = torch.where(valid, (par - 1) * n + (chd - 1),
                       torch.zeros_like(par))
    adj = torch.zeros((b, n * n), dtype=dt, device=dev).scatter_add_(
        1, flat, valid.to(dt)).reshape(b, n, n)
    # sibling index (1-based, edge order) and parent fanout per child
    same_p = ((par[:, :, None] == par[:, None, :]) & valid[:, :, None]
              & valid[:, None, :])                              # [B, E, E]
    earlier = torch.tril(torch.ones((e, e), dtype=torch.bool, device=dev),
                         diagonal=-1)
    sib_index = (same_p & earlier).sum(dim=2) + 1
    fanout = same_p.sum(dim=2)
    child = torch.where(valid, chd - 1, torch.zeros_like(chd))

    def scatter_max(vals):
        return torch.zeros((b, n), dtype=dt, device=dev).scatter_reduce(
            1, child, torch.where(valid, vals.to(dt), torch.zeros((), dtype=dt,
                                                                  device=dev)),
            reduce="amax", include_self=True)

    idx_v, pcl_v = scatter_max(sib_index), scatter_max(fanout)
    # depth(u, v): reach at power d (a tree: unique); depth 0 = self
    out = 0
    reach = torch.eye(n, dtype=dt, device=dev).expand(b, n, n)
    wl, wr, wt = filt[:, 0].to(dt), filt[:, 1].to(dt), filt[:, 2].to(dt)
    for d in range(int(k)):
        if d > 0:
            reach = (reach @ adj > 0).to(dt)
        eta_t = (k - d) / k
        if d == 0:
            temp = torch.full((b, n), 0.5, dtype=dt, device=dev)
        else:
            temp = torch.where(pcl_v == 1.0, torch.full_like(pcl_v, 0.5),
                               (idx_v - 1.0) / torch.clamp(pcl_v - 1.0,
                                                           min=1.0))
        eta_l = (1.0 - eta_t) * temp                             # [B, n]
        eta_r = (1.0 - eta_t) * (1.0 - eta_l)
        mix = (torch.einsum("bvf,fom->bvom", nodes_f * eta_l[..., None], wl)
               + torch.einsum("bvf,fom->bvom", nodes_f * eta_r[..., None], wr)
               + torch.einsum("bvf,fom->bvom", nodes_f * eta_t, wt))
        out = out + torch.einsum("buv,bvom->buom", reach, mix)
    return out.to(nodes.dtype)


# ------------------------------------------------------------ pyramid_hash
def _fmix32(x):
    """The murmur3 finalizer (the JAX package's stand-in for the
    reference's XXH32, pyramid_hash_op.cc:165), on uint32 values held in
    int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _ngram_hash(ids, length, seed):
    """One uint32 hash of the `length` ids from every position on (an
    order-sensitive iterative mix); ids are uint32 values in int64."""
    h = torch.full_like(ids, seed & _MASK32)
    for k in range(length):
        tok = torch.roll(ids, -k, dims=-1)
        mix = (tok + 0x9E3779B9 + ((h << 6) & _MASK32) + (h >> 2)) & _MASK32
        h = _fmix32(h ^ mix)
    return h


@register_op("pyramid_hash",
             inputs=["X", "W", "WhiteList?", "BlackList?", "Lengths?"],
             outputs=["Out", "DropPos", "X_Temp_Out"])
def _pyramid_hash(ctx, x, w, white, black, lengths):
    """pyramid_hash_op.cc (Baidu search CTR), the JAX package's dense
    contract: x [B, T] ids + lengths; Out [B, T (L - 1), num_emb] with
    L = pyramid_layer, row (t, l) the embedding of the (l + 2)-gram from
    t (zeros where it overruns the length or is filtered or dropped),
    each rand_len block j of it row hash_j(n-gram) % space_len of W
    [space_len, rand_len]; DropPos [B, T (L - 1)] the keep mask (int32);
    X_Temp_Out the ids in W's dtype. White and black lists are exact id
    sets on the seed-0 hash."""
    num_emb = ctx.attr("num_emb")
    rand_len = ctx.attr("rand_len")
    space_len = ctx.attr("space_len")
    drop_p = ctx.attr("drop_out_percent", 0.0)
    training = bool(ctx.attr("is_training", 0))
    enforce(num_emb % rand_len == 0, "num_emb %% rand_len != 0")
    b, t = x.shape[0], x.shape[1]
    ids = x.reshape(b, t).long() & _MASK32
    ln = (torch.full((b,), t, dtype=torch.int64, device=x.device)
          if lengths is None else lengths.reshape(-1).long())
    pos = torch.arange(t, device=x.device)[None, :]
    gen = (_op_generator(ctx) if training and drop_p > 0.0 and ctx.has_rng()
           else None)
    outs, keeps = [], []
    for layer in range(1, ctx.attr("pyramid_layer", 2)):
        glen = layer + 1
        keep = (pos + glen) <= ln[:, None]                  # [B, T]
        h0 = _ngram_hash(ids, glen, 0)
        if white is not None:
            keep = keep & (h0[..., None] == (white.reshape(-1).long()
                                             & _MASK32)).any(-1)
        if black is not None:
            keep = keep & ~(h0[..., None] == (black.reshape(-1).long()
                                              & _MASK32)).any(-1)
        if gen is not None:
            u = torch.rand((b, t), generator=gen, device=x.device)
            keep = keep & (u >= drop_p)
        rows = [w[torch.remainder(_ngram_hash(ids, glen, j * rand_len),
                                  space_len)]
                for j in range(num_emb // rand_len)]
        emb = torch.cat(rows, dim=-1)                       # [B, T, num_emb]
        outs.append(emb * keep[..., None].to(emb.dtype))
        keeps.append(keep)
    return (torch.cat(outs, dim=1), torch.cat(keeps, dim=1).to(torch.int32),
            ids.to(w.dtype))
