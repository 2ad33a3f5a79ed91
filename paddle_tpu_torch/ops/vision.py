"""Vision ops beyond the detection family: sampling grids, spectral
normalization, index pooling, pyramid pooling, position-sensitive and
precise ROI pooling, and the deformable-convolution family.

Counterpart of paddle_tpu/ops/vision.py (the reference kernels each op
mirrors):
* affine_grid — affine_grid_op.h GetIdxMap: grid rows (x, y, 1) over
  linspace(-1, 1, size); output = grid @ theta^T.
* spectral_norm — spectral_norm_op.h CalcMatrixSigmaAndNormWeight:
  power iteration on the [h, w] view of the `dim`-fronted Weight,
  sigma = u^T W v, Out = W / sigma, U and V constants for the gradient.
* max_pool2d_with_index — pool_with_index_op.cc: Mask holds the argmax
  position flattened over the input's H*W plane.
* unpool — unpool_op.cc: each value scattered to its recorded index.
* spp — spp_op.h: level l has 2^l bins, kernel ceil(dim / bins),
  padding (kernel bins - dim + 1) / 2, max or exclusive-average pooling.
* psroi_pool — psroi_pool_op.h: rounded ROI, bins [floor, ceil), input
  channel (c ph + i) pw + j, averaged over the bin.
* prroi_pool — prroi_pool_op.h: the exact integral of the bilinear
  interpolant over each bin, in separable form (1-D triangle-kernel
  integrals per axis).
* deformable_conv / deformable_conv_v1 — deformable_conv_op.h: offsets
  (dh, dw) per kernel point per deformable group, bilinear sampling with
  zeros outside (the strict > -1 / < size bound); v2 multiplies the
  modulation mask.
* deformable_psroi_pooling — deformable_psroi_pooling_op.h: ROI shifted
  by -0.5, per-part offsets scaled by trans_std, sample_per_part²
  samples per bin averaged over the in-bounds count; TopCount.

Every op is dense tensor code over all ROIs (or images) at once — one
gather per bilinear corner, contractions by einsum — with gradients from
autograd.
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.detection import const
from paddle_tpu_torch.ops.detection_train import linspace


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) > 1 else v * 2))
    return (int(v), int(v))


@register_op("affine_grid", inputs=["Theta", "OutputShape?"],
             outputs=["Output"])
def _affine_grid(ctx, theta, output_shape):
    shape = ctx.attr("output_shape", None)
    if shape is None:
        enforce(output_shape is not None,
                "affine_grid needs output_shape attr or OutputShape input")
        enforce(output_shape.device.type != "meta",
                "affine_grid OutputShape must be a build-time constant "
                "(the grid's H/W are static shapes) — pass out_shape as a "
                "Python list instead of a graph Variable")
        shape = [int(v) for v in output_shape.tolist()]
    h, w = int(shape[2]), int(shape[3])
    one = torch.ones((), dtype=theta.dtype, device=theta.device)
    ys = linspace(-one, one, h)
    xs = linspace(-one, one, w)
    base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                        torch.ones((h, w), dtype=theta.dtype,
                                   device=theta.device)], -1)   # [H, W, 3]
    return torch.einsum("hwk,nck->nhwc", base, theta)


@register_op("spectral_norm", inputs=["Weight", "U", "V"], outputs=["Out"])
def _spectral_norm(ctx, weight, u, v):
    dim = ctx.attr("dim", 0)
    power_iters = ctx.attr("power_iters", 1)
    eps = ctx.attr("eps", 1e-12)
    perm = [dim] + [i for i in range(weight.dim()) if i != dim]
    wmat = weight.permute(perm)
    shape = wmat.shape
    wmat = wmat.reshape(shape[0], -1)
    u = u.reshape(-1).to(wmat.dtype)
    v = v.reshape(-1).to(wmat.dtype)
    for _ in range(power_iters):
        v = wmat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wmat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    u, v = u.detach(), v.detach()
    sigma = u @ (wmat @ v)
    out = (wmat / sigma).reshape(shape)
    inv = [perm.index(i) for i in range(weight.dim())]
    return out.permute(inv)


# ------------------------------------------------- max pool with index
def _window_starts(dim, out, k, stride, pad, adaptive):
    """Per-output-row (starts, ends, window size); adaptive windows are
    padded to the largest one with an invalid tail."""
    if adaptive:
        starts = [(i * dim) // out for i in range(out)]
        ends = [-(-((i + 1) * dim) // out) for i in range(out)]
        return starts, ends, max(e - s for s, e in zip(starts, ends))
    starts = [i * stride - pad for i in range(out)]
    return starts, [s + k for s in starts], k


def _positions(starts, ends, k, size, device):
    """[out, k] input positions of each window (-1 past its end), their
    validity and their clamped value."""
    rows = const([[s + i if s + i < e else -1 for i in range(k)]
                  for s, e in zip(starts, ends)], torch.int64, device)
    return (rows >= 0) & (rows < size), rows.clamp(0, size - 1)


@register_op("max_pool2d_with_index", inputs=["X"], outputs=["Out", "Mask"])
def _max_pool2d_with_index(ctx, x):
    ksize = _pair(ctx.attr("ksize", [2, 2]))
    adaptive = ctx.attr("adaptive", False)
    if ctx.attr("global_pooling", False):
        ksize, adaptive = (x.shape[2], x.shape[3]), False
    strides = _pair(ctx.attr("strides", ksize))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    n, c, h, w = x.shape
    if adaptive:
        oh, ow = ksize
    else:
        oh = (h - ksize[0] + 2 * pads[0]) // strides[0] + 1
        ow = (w - ksize[1] + 2 * pads[1]) // strides[1] + 1
    hs, he, kh = _window_starts(h, oh, ksize[0], strides[0], pads[0],
                                adaptive)
    ws, we, kw = _window_starts(w, ow, ksize[1], strides[1], pads[1],
                                adaptive)
    rvalid, rc = _positions(hs, he, kh, h, x.device)           # [oh, kh]
    cvalid, cc = _positions(ws, we, kw, w, x.device)           # [ow, kw]
    win = x[:, :, rc[:, None, :, None], cc[None, :, None, :]]  # [n,c,oh,ow,kh,kw]
    valid = rvalid[:, None, :, None] & cvalid[None, :, None, :]
    win = torch.where(valid, win, torch.full((), float("-inf"),
                                             dtype=x.dtype, device=x.device))
    flat = win.reshape(n, c, oh, ow, kh * kw)
    arg = torch.argmax(flat, dim=-1, keepdim=True)
    out = flat.gather(-1, arg)[..., 0]
    gidx = (rc[:, None, :, None] * w + cc[None, :, None, :]).reshape(
        oh, ow, kh * kw)
    mask = gidx.expand(n, c, oh, ow, kh * kw).gather(-1, arg)[..., 0]
    return out, mask.to(torch.int32)


@register_op("unpool", inputs=["X", "Indices"], outputs=["Out"])
def _unpool(ctx, x, indices):
    ksize = _pair(ctx.attr("ksize", [2, 2]))
    strides = _pair(ctx.attr("strides", ksize))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    n, c, h, w = x.shape
    oh = (h - 1) * strides[0] - 2 * pads[0] + ksize[0]
    ow = (w - 1) * strides[1] - 2 * pads[1] + ksize[1]
    out = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape(n, c, oh, ow)


# --------------------------------------------------- spatial pyramid pool
@register_op("spp", inputs=["X"], outputs=["Out"])
def _spp(ctx, x):
    levels = ctx.attr("pyramid_height", 1)
    ptype = ctx.attr("pooling_type", "max")
    n, c, h, w = x.shape
    outs = []
    for level in range(levels):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pad = (pw, pw, ph, ph)
        if ptype == "max":
            pooled = F.max_pool2d(F.pad(x, pad, value=float("-inf")),
                                  (kh, kw), (kh, kw))
        else:
            s = F.avg_pool2d(F.pad(x, pad), (kh, kw), (kh, kw),
                             divisor_override=1)
            cnt = F.avg_pool2d(F.pad(torch.ones_like(x), pad), (kh, kw),
                               (kh, kw), divisor_override=1)
            pooled = s / cnt
        outs.append(pooled[:, :, :bins, :bins].reshape(n, -1))
    return torch.cat(outs, 1)


# ------------------------------------------------------------ ROI pooling
@register_op("psroi_pool", inputs=["X", "ROIs", "RoisNum?"], outputs=["Out"])
def _psroi_pool(ctx, x, rois, rois_num):
    """rois [R, 5] = (batch index, x1, y1, x2, y2) → [R, oc, ph, pw]."""
    ph = ctx.attr("pooled_height", 1)
    pw = ctx.attr("pooled_width", 1)
    oc = ctx.attr("output_channels")
    scale = ctx.attr("spatial_scale", 1.0)
    _, cin, h, w = x.shape
    enforce(cin == oc * ph * pw,
            "psroi_pool input channels %d != output_channels*ph*pw %d",
            cin, oc * ph * pw)
    dt, dev = x.dtype, x.device
    r = rois.shape[0]
    x1 = torch.round(rois[:, 1:2]) * scale
    y1 = torch.round(rois[:, 2:3]) * scale
    x2 = (torch.round(rois[:, 3:4]) + 1.0) * scale
    y2 = (torch.round(rois[:, 4:5]) + 1.0) * scale
    bh = torch.clamp(y2 - y1, min=0.1) / ph
    bw = torch.clamp(x2 - x1, min=0.1) / pw
    pi = torch.arange(ph, dtype=dt, device=dev)[None]
    pj = torch.arange(pw, dtype=dt, device=dev)[None]
    hstart = torch.floor(pi * bh + y1).clamp(0, h)              # [R, ph]
    hend = torch.ceil((pi + 1) * bh + y1).clamp(0, h)
    wstart = torch.floor(pj * bw + x1).clamp(0, w)              # [R, pw]
    wend = torch.ceil((pj + 1) * bw + x1).clamp(0, w)
    hh = torch.arange(h, dtype=dt, device=dev)
    ww = torch.arange(w, dtype=dt, device=dev)
    hmask = ((hh >= hstart[..., None]) & (hh < hend[..., None])).to(dt)
    wmask = ((ww >= wstart[..., None]) & (ww < wend[..., None])).to(dt)
    feat = x[rois[:, 0].long()].reshape(r, oc, ph, pw, h, w)
    s = torch.einsum("rcijhw,rih,rjw->rcij", feat, hmask, wmask)
    area = (hmask.sum(-1)[:, :, None] * wmask.sum(-1)[:, None, :])[:, None]
    return torch.where(area > 0, s / torch.clamp(area, min=1.0),
                       torch.zeros((), dtype=dt, device=dev))


def _triangle_integral(lo, hi, centers):
    """The integral over [lo, hi] of max(0, 1 - |t - c|) for each integer
    center c: pixel c's weight in the integral of the bilinear
    interpolant (the separable PrRoI form)."""
    def anti(t, c):
        u = t - c
        return torch.where(u <= 0, u + 0.5 * u * u + 0.5,
                           u - 0.5 * u * u + 0.5)
    a = torch.minimum(torch.maximum(lo, centers - 1.0), centers + 1.0)
    b = torch.minimum(torch.maximum(hi, centers - 1.0), centers + 1.0)
    return anti(b, centers) - anti(a, centers)


@register_op("prroi_pool", inputs=["X", "ROIs", "BatchRoINums?"],
             outputs=["Out"])
def _prroi_pool(ctx, x, rois, rois_num):
    ph = ctx.attr("pooled_height", 1)
    pw = ctx.attr("pooled_width", 1)
    scale = ctx.attr("spatial_scale", 1.0)
    _, _, h, w = x.shape
    f, dev = at_least_f32_dtype(x), x.device
    rf = rois.to(f)
    x1, y1 = rf[:, 1:2] * scale, rf[:, 2:3] * scale
    x2, y2 = rf[:, 3:4] * scale, rf[:, 4:5] * scale
    bw = torch.clamp(x2 - x1, min=0.0) / pw
    bh = torch.clamp(y2 - y1, min=0.0) / ph
    pi = torch.arange(ph, dtype=f, device=dev)[None]
    pj = torch.arange(pw, dtype=f, device=dev)[None]
    h0, h1 = y1 + pi * bh, y1 + (pi + 1) * bh                   # [R, ph]
    w0, w1 = x1 + pj * bw, x1 + (pj + 1) * bw                   # [R, pw]
    hh = torch.arange(h, dtype=f, device=dev)
    ww = torch.arange(w, dtype=f, device=dev)
    wy = _triangle_integral(h0[..., None], h1[..., None], hh)   # [R, ph, h]
    wx = _triangle_integral(w0[..., None], w1[..., None], ww)   # [R, pw, w]
    area = torch.clamp(bh * bw, min=0.0)[:, :, None, None]      # [R,1,1,1]
    s = torch.einsum("rchw,rih,rjw->rcij", x[rois[:, 0].long()].to(f), wy,
                     wx)
    out = torch.where(area > 0, s / torch.clamp(area, min=1e-12),
                      torch.zeros((), dtype=f, device=dev))
    return out.to(x.dtype)


# ---------------------------------------------------- deformable family
def _deformable_conv(ctx, x, offset, mask, weight):
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    dils = _pair(ctx.attr("dilations", [1, 1]))
    groups = ctx.attr("groups", 1)
    dg = ctx.attr("deformable_groups", 1)
    n, c, h, w = x.shape
    oc, cg, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * pads[0] - (dils[0] * (kh - 1) + 1)) // strides[0] + 1
    wo = (w + 2 * pads[1] - (dils[1] * (kw - 1) + 1)) // strides[1] + 1
    f, dev = at_least_f32_dtype(x), x.device
    off = offset.reshape(n, dg, k, 2, ho, wo).to(f)
    base_h = (torch.arange(ho, device=dev) * strides[0] - pads[0]).to(f)
    base_w = (torch.arange(wo, device=dev) * strides[1] - pads[1]).to(f)
    kidx = torch.arange(k, device=dev)
    ki = (kidx // kw).to(f) * dils[0]
    kj = (kidx % kw).to(f) * dils[1]
    ys = (base_h[None, None, None, :, None] + ki[None, None, :, None, None]
          + off[:, :, :, 0])                                    # [n,dg,k,ho,wo]
    xs = (base_w[None, None, None, None, :] + kj[None, None, :, None, None]
          + off[:, :, :, 1])
    xg = x.reshape(n, dg, c // dg, h, w).to(f)
    bi = torch.arange(n, device=dev)[:, None, None, None, None]
    gi = torch.arange(dg, device=dev)[None, :, None, None, None]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy, dx = ys - y0, xs - x0
    zero = torch.zeros((), dtype=f, device=dev)
    sample = 0.0
    for oy, wy in ((0, 1.0 - dy), (1, dy)):
        for ox, wx in ((0, 1.0 - dx), (1, dx)):
            yy = y0 + oy
            xx = x0 + ox
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yi = yy.clamp(0, h - 1).long()
            xi = xx.clamp(0, w - 1).long()
            g = xg[bi, gi, :, yi, xi]                       # [n,dg,k,ho,wo,cg']
            sample = sample + (torch.where(ok[..., None], g, zero)
                               * wy[..., None] * wx[..., None])
    inb = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    sample = torch.where(inb[..., None], sample, zero)
    if mask is not None:
        sample = sample * mask.reshape(n, dg, k, ho, wo, 1).to(f)
    cols = sample.permute(0, 1, 5, 2, 3, 4).reshape(
        n, groups, (c // groups) * k, ho * wo)
    wmat = weight.reshape(groups, oc // groups, cg * k).to(f)
    out = torch.einsum("gok,ngkp->ngop", wmat, cols)
    return out.reshape(n, oc, ho, wo).to(x.dtype)


@register_op("deformable_conv", inputs=["Input", "Offset", "Mask", "Filter"],
             outputs=["Output"])
def _deformable_conv_v2(ctx, x, offset, mask, weight):
    return _deformable_conv(ctx, x, offset, mask, weight)


@register_op("deformable_conv_v1", inputs=["Input", "Offset", "Filter"],
             outputs=["Output"])
def _deformable_conv_v1(ctx, x, offset, weight):
    return _deformable_conv(ctx, x, offset, None, weight)


@register_op("deformable_psroi_pooling",
             inputs=["Input", "ROIs", "Trans?"],
             outputs=["Output", "TopCount"])
def _deformable_psroi_pooling(ctx, x, rois, trans):
    no_trans = ctx.attr("no_trans", False) or trans is None
    scale = ctx.attr("spatial_scale", 1.0)
    out_dim = ctx.attr("output_dim")
    gh, gw = _pair(ctx.attr("group_size", [1, 1]))
    ph, pw = _pair(ctx.attr("pooled_size",
                            [ctx.attr("pooled_height", 1),
                             ctx.attr("pooled_width", 1)]))
    part_h, part_w = _pair(ctx.attr("part_size", [ph, pw]))
    spp_ = ctx.attr("sample_per_part", 1)
    trans_std = ctx.attr("trans_std", 0.0)
    _, c, h, w = x.shape
    r = rois.shape[0]
    f, dev = at_least_f32_dtype(x), x.device
    num_classes = 1 if no_trans else trans.shape[1] // 2
    ch_each = out_dim if no_trans else out_dim // num_classes
    pi = torch.arange(ph, dtype=f, device=dev)
    pj = torch.arange(pw, dtype=f, device=dev)
    part_hi = torch.floor(pi / ph * part_h).long()             # [ph]
    part_wi = torch.floor(pj / pw * part_w).long()             # [pw]
    ghi = torch.floor(pi * gh / ph).clamp(0, gh - 1).long()
    gwi = torch.floor(pj * gw / pw).clamp(0, gw - 1).long()
    ctop = torch.arange(out_dim, device=dev)
    cls = ctop // ch_each                                      # [od]
    # input channel per (ctop, bin): (ctop gh + ghi) gw + gwi
    cidx = ((ctop[:, None, None] * gh + ghi[None, :, None]) * gw
            + gwi[None, None, :])                              # [od, ph, pw]
    rf = rois.to(f)
    x1 = (torch.round(rf[:, 1]) * scale - 0.5).view(r, 1, 1, 1)
    y1 = (torch.round(rf[:, 2]) * scale - 0.5).view(r, 1, 1, 1)
    x2 = ((torch.round(rf[:, 3]) + 1.0) * scale - 0.5).view(r, 1, 1, 1)
    y2 = ((torch.round(rf[:, 4]) + 1.0) * scale - 0.5).view(r, 1, 1, 1)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bh, bw = rh / ph, rw / pw
    sh, sw = bh / spp_, bw / spp_
    if no_trans:
        tx = ty = torch.zeros((r, out_dim, ph, pw), dtype=f, device=dev)
    else:
        t = trans.reshape(r, num_classes, 2, part_h, part_w).to(f)
        ri = torch.arange(r, device=dev)[:, None, None, None]
        at = (ri, cls[None, :, None, None], slice(None),
              part_hi[None, None, :, None], part_wi[None, None, None, :])
        tyx = t[at] * trans_std                           # [R, od, ph, pw, 2]
        ty, tx = tyx[..., 0], tyx[..., 1]
    wstart = (pj[None, None, None, :] * bw + x1) + tx * rw     # [R,od,ph,pw]
    hstart = (pi[None, None, :, None] * bh + y1) + ty * rh
    si = torch.arange(spp_, dtype=f, device=dev)
    ys = hstart[..., None, None] + si[:, None] * sh[..., None, None]
    xs = wstart[..., None, None] + si[None, :] * sw[..., None, None]
    ys = ys.expand(*hstart.shape, spp_, spp_)
    xs = xs.expand(*wstart.shape, spp_, spp_)
    ok = (xs >= -0.5) & (xs <= w - 0.5) & (ys >= -0.5) & (ys <= h - 0.5)
    yc = ys.clamp(0.0, h - 1.0)
    xc = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    dy, dx = yc - y0, xc - x0
    feat = x.to(f)
    bi = rois[:, 0].long().view(r, 1, 1, 1, 1, 1)
    cb = cidx[None, :, :, :, None, None]
    vals = 0.0
    for oy, wy_ in ((0, 1.0 - dy), (1, dy)):
        for ox, wx_ in ((0, 1.0 - dx), (1, dx)):
            yy = (y0 + oy).clamp(0, h - 1).long()
            xx = (x0 + ox).clamp(0, w - 1).long()
            vals = vals + feat[bi, cb, yy, xx] * wy_ * wx_
    zero = torch.zeros((), dtype=f, device=dev)
    vals = torch.where(ok, vals, zero)
    cnt = ok.to(f).sum((-1, -2))
    s = vals.sum((-1, -2))
    out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), zero)
    return out.to(x.dtype), cnt.to(x.dtype)
