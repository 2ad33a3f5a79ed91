"""Sequence ops on the dense + lengths form.

Counterpart of paddle_tpu/ops/sequence.py: every op type of it, with its
slot names. A ragged batch is a dense [B, T, ...] tensor and a [B]
length vector, as in the JAX package (the reference's LoD offsets have
no static-shape form there); every op masks with the lengths, so a
result equals the unpadded one. Output dtypes are the JAX package's
under x64 (an argmax is int64, `sequence_erase`'s lengths int32), so the
IR records the same dtypes in both packages.
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32, normalize_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op

__all__ = ["validity_mask", "position_ids"]


def _mask(x, length, t_axis=1):
    """[B, T, 1, ...] bool: position < the row's length."""
    t = x.shape[t_axis]
    shape = [1] * x.dim()
    shape[t_axis] = t
    ar = torch.arange(t, device=x.device).reshape(shape)
    return ar < length.reshape([-1] + [1] * (x.dim() - 1))


def _trailing(idx, x):
    """idx [B, T] reshaped to broadcast over x's trailing dims."""
    return idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))


def validity_mask(lengths, max_len, dtype=torch.bool):
    """[B] lengths → [B, max_len] mask of each row's valid prefix."""
    lengths = torch.as_tensor(lengths)
    ar = torch.arange(max_len, device=lengths.device)
    return (ar[None, :] < lengths.to(torch.int64)[:, None]).to(dtype)


def position_ids(lengths, max_len):
    """[B] lengths → [B, max_len] int32 positions, zeroed past each row's
    valid prefix (an embedding lookup there stays in range)."""
    lengths = torch.as_tensor(lengths).to(torch.int32)
    pos = torch.arange(max_len, dtype=torch.int32,
                       device=lengths.device)[None, :].expand(
        lengths.shape[0], max_len)
    return torch.where(pos < lengths[:, None], pos, torch.zeros_like(pos))


@register_op("sequence_mask", inputs=["X"], outputs=["Y"])
def _sequence_mask(ctx, x):
    """sequence_mask_op.cc: lengths [B] → mask [B, maxlen]. maxlen must
    be given (the reference's data-dependent default has no static
    shape, the JAX package's rule)."""
    maxlen = ctx.attr("maxlen", -1)
    enforce(maxlen is not None and maxlen > 0,
            "sequence_mask requires a static positive maxlen attr (got %s)",
            maxlen)
    dtype = normalize_dtype(ctx.attr("out_dtype", "int64"))
    ar = torch.arange(maxlen, device=x.device)
    return (ar[None, :] < x.reshape(-1, 1)).to(dtype)


@register_op("sequence_pool", inputs=["X", "Length"],
             outputs=["Out", "MaxIndex"])
def _sequence_pool(ctx, x, length):
    """sequence_pool_op.cc: pool over time within each row's length;
    pooltype SUM, AVERAGE, SQRT, MAX, LAST or FIRST."""
    ptype = ctx.attr("pooltype", "SUM").upper()
    mb = _mask(x, length)
    m = mb.to(x.dtype)
    lf = torch.clamp(length.to(x.dtype), min=1).reshape(
        (-1,) + (1,) * (x.dim() - 2))
    if ptype == "SUM":
        out = (x * m).sum(1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(1) / lf
    elif ptype == "SQRT":
        out = (x * m).sum(1) / torch.sqrt(lf)
    elif ptype == "MAX":
        neg = (torch.finfo(x.dtype).min if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        out = torch.amax(torch.where(mb, x, torch.full_like(x, neg)), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp(length.to(torch.int64) - 1, min=0)
        out = torch.take_along_dim(
            x, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)), dim=1)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    if x.is_floating_point():
        idx = torch.argmax(torch.where(mb, x, torch.full_like(
            x, float("-inf"))), dim=1)
    else:
        idx = torch.zeros_like(length)
    return out, idx


@register_op("sequence_softmax", inputs=["X", "Length"], outputs=["Out"])
def _sequence_softmax(ctx, x, length):
    """Softmax over each row's valid prefix, zero past it (in float32, or
    float64 for float64 input)."""
    m = _mask(x, length)
    xf = at_least_f32(x)
    neg = torch.finfo(torch.float32).min
    sm = torch.softmax(torch.where(m, xf, torch.full_like(xf, neg)), dim=1)
    return sm.to(x.dtype) * m.to(x.dtype)


@register_op("sequence_reverse", inputs=["X", "Length"], outputs=["Y"])
def _sequence_reverse(ctx, x, length):
    """sequence_reverse_op: reverse each row's valid prefix in place."""
    return reverse_valid(x, length)


def reverse_valid(x, length):
    """Each row's valid prefix reversed, the padding where it was."""
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    L = length.reshape(-1, 1).to(torch.int64)
    rev = torch.where(idx < L, L - 1 - idx, idx)
    return torch.take_along_dim(x, _trailing(rev, x), dim=1)


@register_op("sequence_expand", inputs=["X", "Y", "RefLength"],
             outputs=["Out"])
def _sequence_expand(ctx, x, y, ref_length):
    """sequence_expand_op in the dense case: x's rows broadcast over y's
    time dimension."""
    if x.dim() == y.dim():
        return x.expand(y.shape)
    return x[:, None].expand((x.shape[0], y.shape[1]) + tuple(x.shape[1:]))


@register_op("sequence_concat", inputs=["X[]"], outputs=["Out"])
def _sequence_concat(ctx, xs):
    return torch.cat(xs, dim=1)


@register_op("sequence_pad", inputs=["X", "Length"],
             outputs=["Out", "SeqLength"])
def _sequence_pad(ctx, x, length):
    """Dense + lengths in and out: the tail set to pad_value."""
    m = _mask(x, length).to(x.dtype)
    pad_value = ctx.attr("pad_value", 0.0)
    return x * m + pad_value * (1 - m), length


@register_op("sequence_unpad", inputs=["X", "Length"], outputs=["Out"])
def _sequence_unpad(ctx, x, length):
    return x * _mask(x, length).to(x.dtype)


@register_op("sequence_slice", inputs=["X", "Offset", "Length"],
             outputs=["Out"])
def _sequence_slice(ctx, x, offset, length):
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    off = offset.reshape(-1, 1).to(torch.int64)
    L = length.reshape(-1, 1).to(torch.int64)
    gather_idx = torch.clamp(off + idx, 0, t - 1)
    vals = torch.take_along_dim(x, _trailing(gather_idx, x), dim=1)
    return vals * _trailing(idx < L, x).to(x.dtype)


@register_op("im2sequence", inputs=["X"], outputs=["Out"])
def _im2sequence(ctx, x):
    """im2sequence_op.cc: NCHW → [N*oh*ow, C*kh*kw] patches, each patch's
    features in (C, kh, kw) order."""
    kh, kw = ctx.attr("kernels", [1, 1])
    sh, sw = ctx.attr("strides", [1, 1])
    n, c, h, w = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    cols = F.unfold(x, (kh, kw), stride=(sh, sw))    # [N, C*kh*kw, oh*ow]
    return cols.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)


@register_op("sequence_conv", inputs=["X", "Filter", "Bias?", "Length?"],
             outputs=["Out"])
def _sequence_conv(ctx, x, w, bias, length):
    """sequence_conv_op.cc on dense [B, T, D]: the context window
    concat(x[t+start], ..., x[t+start+window-1]) @ W, zero outside the
    sequence (and past its length), one matmul."""
    window = ctx.attr("context_length", 3)
    start = ctx.attr("context_start", -((window - 1) // 2))
    t = x.shape[1]
    if length is not None:
        x = x * _mask(x, length).to(x.dtype)
    cols = []
    pos = torch.arange(t, device=x.device)
    for k in range(window):
        off = start + k
        shifted = torch.roll(x, -off, dims=1)
        valid = ((pos + off >= 0) & (pos + off < t)).to(x.dtype)
        cols.append(shifted * valid[None, :, None])
    out = torch.matmul(torch.cat(cols, dim=-1), w)
    if bias is not None:
        out = out + bias
    return out


@register_op("sequence_topk_avg_pooling",
             inputs=["X", "ROW", "COLUMN"], outputs=["Out", "pos"])
def _sequence_topk_avg_pooling(ctx, x, row, col):
    """sequence_topk_avg_pooling_op.h: per (sample, channel, row), the
    average of the top-k column values with a fixed denominator k (fewer
    than k columns still divide by k). x [B, C, Rmax, Cmax] with per-
    sample row / column lengths; Out [B, Rmax, C * len(topks)] (channel
    major, k inner); pos is a placeholder, as in the JAX package."""
    topks = ctx.attr("topks")
    cnum = ctx.attr("channel_num")
    enforce(topks, "sequence_topk_avg_pooling needs topks")
    enforce(x.shape[1] == cnum, "channel_num mismatch: %s vs %s",
            x.shape[1], cnum)
    b, c, rmax, cmax = x.shape
    max_k = int(max(topks))
    dev = x.device
    row = row.reshape(-1)
    col = col.reshape(-1)
    colmask = col[:, None] > torch.arange(cmax, device=dev)[None, :]
    masked = torch.where(colmask[:, None, None, :], x,
                         torch.full_like(x, float("-inf")))
    top = torch.sort(masked, dim=-1, descending=True).values[
        ..., :min(max_k, cmax)]
    if max_k > cmax:
        top = F.pad(top, (0, max_k - cmax))
    avail = col[:, None] > torch.arange(max_k, device=dev)[None, :]
    top = torch.where(avail[:, None, None, :], top, torch.zeros_like(top))
    csum = torch.cumsum(top, dim=-1)
    outs = []
    for k in topks:
        kk = torch.clamp(torch.clamp(col, min=1), max=int(k)).to(torch.int64)
        take = torch.take_along_dim(
            csum, (kk - 1).reshape(b, 1, 1, 1), dim=-1)[..., 0]
        take = torch.where((col > 0)[:, None, None], take,
                           torch.zeros_like(take))
        outs.append(take / float(k))
    out = torch.stack(outs, dim=-1)                          # [B,C,R,K]
    rowmask = row[:, None] > torch.arange(rmax, device=dev)[None, :]
    out = out * rowmask[:, None, :, None].to(out.dtype)
    out = out.permute(0, 2, 1, 3).reshape(b, rmax, c * len(topks))
    return out, torch.zeros((b, 1), dtype=torch.int32, device=dev)


@register_op("sequence_erase", inputs=["X", "Lengths?"],
             outputs=["Out", "OutLengths"])
def _sequence_erase(ctx, x, lengths):
    """sequence_erase_op.h: drop every token of attr `tokens`, each row
    compacted to the left and zero-padded; OutLengths the new counts."""
    tokens = ctx.attr("tokens", [])
    b, t = x.shape[0], x.shape[1]
    dev = x.device
    lens = (torch.full((b,), t, device=dev) if lengths is None
            else lengths.reshape(-1))
    keep = torch.arange(t, device=dev)[None, :] < lens[:, None]
    for tok in tokens:
        keep = keep & (x != tok)
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep, dest, torch.full_like(dest, t))
    out = torch.zeros((b, t + 1), dtype=x.dtype, device=dev).scatter(
        1, dest, torch.where(keep, x, torch.zeros_like(x)))
    return out[:, :t], keep.sum(dim=1).to(torch.int32)
