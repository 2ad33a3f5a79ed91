"""Detection training and evaluation ops: clipping, focal loss, target
assignment, per-class decoding, FPN routing, the perspective ROI
transform, EAST geometry decoding, the mAP metric and the RPN /
RetinaNet / proposal-label / mask-label assigners.

Counterpart of paddle_tpu/ops/detection_train.py (the reference's
operators/detection/ kernels named in each docstring), with its
static shapes: samplers return fixed-size outputs padded with index -1
or label -1, `distribute_fpn_proposals` one [R, 5] slot table per level
with a validity column, `detection_map` one dense evaluation of the
padded [N, M, 6] detections.

Sampling (`rpn_target_assign`, `generate_proposal_labels`): a pick of
up to k eligible positions is the top k of uniform keys masked to
eligibility, ties to the lower index. With `use_random` the keys come
from the op's generator (the run's seed and the op's index), which
cannot reproduce the JAX package's threefry bits; without it, or with
no run seed, the keys are the JAX package's fixed draws from
`PRNGKey(0)` (`jax_key0_uniform`, threefry-2x32 in numpy), so the
result equals the JAX op's.
"""
import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.registry import constant, register_op
from paddle_tpu_torch.ops.detection import const, float_dtype, iou
from paddle_tpu_torch.ops.math import top_k_lowest_index


@register_op("box_clip", inputs=["Input", "ImInfo"], outputs=["Output"])
def _box_clip(ctx, boxes, im_info):
    """box_clip_op.h: boxes [B, R, 4] clipped to [0, w-1] x [0, h-1] of
    im_info [B, 3] = (h, w, scale) in the original image's scale."""
    h = im_info[:, 0] / im_info[:, 2]
    w = im_info[:, 1] / im_info[:, 2]
    hm = (h - 1.0)[:, None]
    wm = (w - 1.0)[:, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    return torch.stack([clip(boxes[..., 0], wm), clip(boxes[..., 1], hm),
                        clip(boxes[..., 2], wm), clip(boxes[..., 3], hm)], -1)


@register_op("sigmoid_focal_loss", inputs=["X", "Label", "FgNum"],
             outputs=["Out"])
def _sigmoid_focal_loss(ctx, x, label, fg_num):
    """sigmoid_focal_loss_op.h: per (sample, class) loss, targets in
    1..C, label -1 ignored, normalized by FgNum."""
    gamma = ctx.attr("gamma", 2.0)
    alpha = ctx.attr("alpha", 0.25)
    _, c = x.shape
    f = at_least_f32_dtype(x)
    g = label.reshape(-1, 1).long()
    d = torch.arange(c, device=x.device)[None, :]
    c_pos = (g == d + 1).to(f)
    c_neg = ((g != -1) & (g != d + 1)).to(f)
    fg = torch.clamp(fg_num.reshape(()).to(f), min=1.0)
    xf = x.to(f)
    p = torch.sigmoid(xf)
    term_pos = torch.pow(1.0 - p, gamma) * torch.log(torch.clamp(p,
                                                                 min=1e-37))
    # stable log(1 - p) = -x (x >= 0) - log(1 + exp(x - 2 x (x >= 0)))
    pos = (xf >= 0).to(f)
    term_neg = torch.pow(p, gamma) * (
        -xf * pos - torch.log1p(torch.exp(xf - 2.0 * xf * pos)))
    out = (-c_pos * term_pos * (alpha / fg)
           - c_neg * term_neg * ((1.0 - alpha) / fg))
    return out.to(x.dtype)


@register_op("target_assign",
             inputs=["X", "MatchIndices", "NegIndices?"],
             outputs=["Out", "OutWeight"])
def _target_assign(ctx, x, match, neg):
    """target_assign_op.cc: x [B, M, K] per-image gt rows; match [B, P]
    the gt row of each prior or -1; neg [B, P] a 0/1 negative mask."""
    mismatch = torch.full((), ctx.attr("mismatch_value", 0), dtype=x.dtype,
                          device=x.device)
    k = x.shape[-1]
    idx = match.long().clamp(0, x.shape[1] - 1)
    gathered = x.gather(1, idx[..., None].expand(*idx.shape, k))
    hit = (match >= 0)[..., None]
    out = torch.where(hit, gathered, mismatch)
    wt = hit.to(torch.float32)
    if neg is not None:
        negm = (neg > 0)[..., None]
        out = torch.where(~hit & negm, mismatch, out)
        wt = torch.maximum(wt, negm.to(torch.float32))
    return out, wt


@register_op("box_decoder_and_assign",
             inputs=["PriorBox", "PriorBoxVar", "TargetBox", "BoxScore"],
             outputs=["DecodeBox", "OutputAssignBox"])
def _box_decoder_and_assign(ctx, prior, prior_var, target, score):
    """box_decoder_and_assign_op.cc: prior [M, 4], prior_var [M, 4],
    target [M, 4 C] per-class deltas, score [M, C]; each prior gets the
    box of its best non-background class. box_clip caps the exp."""
    clip = ctx.attr("box_clip", 4.135166556742356)
    m = prior.shape[0]
    c = score.shape[1]
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    px = prior[:, 0] + pw * 0.5
    py = prior[:, 1] + ph * 0.5
    t = target.reshape(m, c, 4)
    v = prior_var
    tx, ty = t[..., 0] * v[:, None, 0], t[..., 1] * v[:, None, 1]
    tw = torch.clamp(t[..., 2] * v[:, None, 2], max=clip)
    th = torch.clamp(t[..., 3] * v[:, None, 3], max=clip)
    ox = tx * pw[:, None] + px[:, None]
    oy = ty * ph[:, None] + py[:, None]
    ow = torch.exp(tw) * pw[:, None]
    oh = torch.exp(th) * ph[:, None]
    decode = torch.stack([ox - ow * 0.5, oy - oh * 0.5,
                          ox + ow * 0.5 - 1.0, oy + oh * 0.5 - 1.0], -1)
    best = torch.argmax(score[:, 1:], dim=1) + 1
    assign = decode.gather(1, best[:, None, None].expand(m, 1, 4))[:, 0]
    return decode.reshape(m, c * 4), assign


@register_op("distribute_fpn_proposals", inputs=["FpnRois", "RoisNum?"],
             outputs=["MultiFpnRois[]", "RestoreIndex"])
def _distribute_fpn_proposals(ctx, rois, rois_num):
    """distribute_fpn_proposals_op.h: level = floor(log2(sqrt(area) /
    refer_scale + 1e-6) + refer_level) clamped to [min, max]. Each
    level's output is [R, 5] = (valid, x1, y1, x2, y2), invalid rows
    zero; RestoreIndex [R, 1] is each roi's row in the level-major
    concatenation of valid rows."""
    min_level = ctx.attr("min_level", 2)
    max_level = ctx.attr("max_level", 5)
    refer_level = ctx.attr("refer_level", 4)
    refer_scale = ctx.attr("refer_scale", 224)
    w = torch.clamp(rois[:, 2] - rois[:, 0] + 1.0, min=0.0)
    h = torch.clamp(rois[:, 3] - rois[:, 1] + 1.0, min=0.0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6) + refer_level)
    lvl = lvl.clamp(min_level, max_level).to(torch.int32)
    outs, restore = [], torch.zeros(rois.shape[0], dtype=torch.int32,
                                    device=rois.device)
    base = torch.zeros((), dtype=torch.int32, device=rois.device)
    for level in range(min_level, max_level + 1):
        m = lvl == level
        outs.append(torch.cat([m[:, None].to(rois.dtype), rois * m[:, None]],
                              1))
        pos = torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32) - 1
        restore = torch.where(m, base + pos, restore)
        base = base + m.sum(dtype=torch.int32)
    return outs, restore[:, None]


@register_op("collect_fpn_proposals",
             inputs=["MultiLevelRois[]", "MultiLevelScores[]"],
             outputs=["FpnRois"])
def _collect_fpn_proposals(ctx, rois_list, scores_list):
    """collect_fpn_proposals_op.h: concatenate the levels' (rois [Ri, 4],
    scores [Ri, 1]) and keep the global post_nms_topN by score."""
    topn = ctx.attr("post_nms_topN", 100)
    rois = torch.cat(list(rois_list), 0)
    scores = torch.cat([s.reshape(-1) for s in scores_list], 0)
    k = min(topn, scores.shape[0])
    _, top_i = top_k_lowest_index(scores, k)
    out = rois[top_i]
    if k < topn:
        out = F.pad(out, (0, 0, 0, topn - k))
    return out


@register_op("polygon_box_transform", inputs=["Input"], outputs=["Output"])
def _polygon_box_transform(ctx, x):
    """polygon_box_transform_op.cc (EAST geometry): even channels
    4 w_idx - v, odd channels 4 h_idx - v."""
    _, c, h, w = x.shape
    wi = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    hi = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    even = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return torch.where(even, 4.0 * wi - x, 4.0 * hi - x)


@register_op("roi_perspective_transform",
             inputs=["X", "ROIs"], outputs=["Out", "Mask", "TransformMatrix",
                                            "Out2InIdx", "Out2InWeights"])
def _roi_perspective_transform(ctx, x, rois):
    """roi_perspective_transform_op.cc: rois [R, 9] = (batch index, x1..x4,
    y1..y4 quad corners, clockwise); each quad warped to [H, W] by the
    homography mapping the output rectangle's corners onto it, bilinear
    sampling with zeros outside."""
    oh = ctx.attr("transformed_height")
    ow = ctx.attr("transformed_width")
    scale = ctx.attr("spatial_scale", 1.0)
    _, c, h, w = x.shape
    r = rois.shape[0]
    f = at_least_f32_dtype(rois)
    dev = x.device
    quad = rois[:, 1:].to(f)
    dx = quad[:, 0:4] * scale                                  # [R, 4]
    dy = quad[:, 4:8] * scale
    sx = const([0.0, ow - 1.0, ow - 1.0, 0.0], f, dev)[None].expand(r, 4)
    sy = const([0.0, 0.0, oh - 1.0, oh - 1.0], f, dev)[None].expand(r, 4)
    one, zero = torch.ones_like(sx), torch.zeros_like(sx)
    # the 8-dof system, two rows per corner (get_transform_matrix)
    row_x = torch.stack([sx, sy, one, zero, zero, zero, -dx * sx, -dx * sy],
                        -1)
    row_y = torch.stack([zero, zero, zero, sx, sy, one, -dy * sx, -dy * sy],
                        -1)
    a = torch.stack([row_x, row_y], 2).reshape(r, 8, 8)
    bvec = torch.stack([dx, dy], 2).reshape(r, 8)
    sol = torch.linalg.solve(a, bvec)
    tm = torch.cat([sol, torch.ones((r, 1), dtype=f, device=dev)],
                   1).reshape(r, 3, 3)
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=f, device=dev),
                            torch.arange(ow, dtype=f, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
    pts = tm @ grid                                           # [R, 3, oh*ow]
    eps = torch.full((), 1e-7, dtype=f, device=dev)
    den = torch.where(torch.abs(pts[:, 2]) < 1e-7, eps, pts[:, 2])
    px = pts[:, 0] / den
    py = pts[:, 1] / den
    inb = (px > -0.5) & (px < w - 0.5) & (py > -0.5) & (py < h - 0.5)
    pxc = px.clamp(0.0, w - 1.0)
    pyc = py.clamp(0.0, h - 1.0)
    x0 = torch.floor(pxc)
    y0 = torch.floor(pyc)
    fx = pxc - x0
    fy = pyc - y0
    bi = rois[:, 0].long()[:, None]
    xf = x.to(f)
    val = 0.0
    for ox_, wx_ in ((0, 1 - fx), (1, fx)):
        for oy_, wy_ in ((0, 1 - fy), (1, fy)):
            xi = (x0 + ox_).clamp(0, w - 1).long()
            yi = (y0 + oy_).clamp(0, h - 1).long()
            val = val + xf[bi, :, yi, xi] * (wx_ * wy_)[..., None]
    val = torch.where(inb[..., None], val, torch.zeros((), dtype=f,
                                                       device=dev))
    return (val.permute(0, 2, 1).reshape(r, c, oh, ow).to(x.dtype),
            inb.reshape(r, 1, oh, ow).to(torch.int32), tm.reshape(r, 9),
            torch.zeros((r, 1), dtype=torch.int32, device=dev),
            torch.zeros((r, 1), dtype=torch.float32, device=dev))


@register_op("detection_map",
             inputs=["DetectRes", "Label", "HasState?", "PosCount?",
                     "TruePos?", "FalsePos?"],
             outputs=["MAP", "AccumPosCount", "AccumTruePos",
                      "AccumFalsePos"])
def _detection_map(ctx, det, label, has_state, pos_count, tp, fp):
    """detection_map_op.h in one dense call: det [B, M, 6] = (class,
    score, x1, y1, x2, y2), class -1 pads (multiclass_nms's output);
    label [B, G, 6] = (label, is_difficult, box) or [B, G, 5] = (label,
    box), class -1 pads. A detection is a true positive when it is the
    highest-scoring detection over the threshold with some gt of its
    class (the JAX package's form of the sequential claim); 11-point or
    integral AP per class, their mean over the classes with a gt. The
    Accum outputs are zero placeholders (no streaming state)."""
    overlap_t = ctx.attr("overlap_threshold", 0.5)
    ap_type = ctx.attr("ap_type", "integral")
    class_num = ctx.attr("class_num")
    background = ctx.attr("background_label", 0)
    evaluate_difficult = ctx.attr("evaluate_difficult", True)
    b, _, _ = det.shape
    g = label.shape[1]
    f = at_least_f32_dtype(det)
    dev = det.device
    det_cls = det[..., 0].to(torch.int32)
    det_score = det[..., 1].to(f)
    det_box = det[..., 2:6].to(f)
    gt_cls = label[..., 0].to(torch.int32)
    if label.shape[-1] > 5:
        gt_diff = label[..., 1] > 0
        gt_box = label[..., 2:6].to(f)
    else:
        gt_diff = torch.zeros((b, g), dtype=torch.bool, device=dev)
        gt_box = label[..., 1:5].to(f)
    gt_valid = gt_cls >= 0
    if not evaluate_difficult:
        gt_valid = gt_valid & ~gt_diff
    ov = iou(det_box, gt_box)                                   # [B, M, G]
    ninf = torch.full((), float("-inf"), dtype=f, device=dev)
    zero = torch.zeros((), dtype=f, device=dev)
    aps = []
    for cls in range(class_num):
        if cls == background:
            continue
        dmask = det_cls == cls                                  # [B, M]
        gmask = gt_valid & (gt_cls == cls)                      # [B, G]
        npos = gmask.sum()
        cand = ov * dmask[:, :, None] * gmask[:, None, :]
        over = cand > overlap_t
        score_rank = det_score[:, :, None]
        best = torch.where(over, score_rank, ninf).amax(1, keepdim=True)
        tp_m = (over & (score_rank >= best)).any(2) & dmask
        scores = torch.where(dmask, det_score, ninf).reshape(-1)
        order = torch.sort(-scores, stable=True).indices
        s_sorted = scores[order]
        t_sorted = tp_m.reshape(-1)[order].to(f)
        valid = s_sorted > float("-inf")
        ctp = torch.cumsum(t_sorted * valid, 0)
        cfp = torch.cumsum((1.0 - t_sorted) * valid, 0)
        recall = ctp / torch.clamp(npos, min=1)
        precision = ctp / torch.clamp(ctp + cfp, min=1e-10)
        if ap_type == "11point":
            ap = torch.stack([torch.where((recall >= r_ / 10.0) & valid,
                                          precision, zero).max()
                              for r_ in range(11)]).mean()
        else:
            dr = torch.diff(torch.cat([torch.zeros(1, dtype=f, device=dev),
                                       recall]))
            ap = (precision * dr * valid).sum()
        aps.append(torch.where(npos > 0, ap,
                               torch.full((), float("nan"), dtype=f,
                                          device=dev)))
    aps = torch.stack(aps)
    have = torch.isfinite(aps)
    mean_ap = torch.where(have, aps, zero).sum() / torch.clamp(
        have.to(f).sum(), min=1.0)
    zeros = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    return mean_ap.reshape(1).to(torch.float32), zeros, zeros, zeros


def _box2delta(anchors, gt, weights=(1.0, 1.0, 1.0, 1.0)):
    """bbox_util's encode (rpn_target_assign_op.cc BoxToDelta)."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + aw * 0.5
    ay = anchors[:, 1] + ah * 0.5
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gx = gt[:, 0] + gw * 0.5
    gy = gt[:, 1] + gh * 0.5
    wx, wy, ww, wh = weights
    return torch.stack([(gx - ax) / aw / wx, (gy - ay) / ah / wy,
                        torch.log(gw / aw) / ww, torch.log(gh / ah) / wh], 1)


# --- the JAX package's fixed sampling keys: threefry-2x32 in numpy ---

def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), as jax.random's."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(np.uint32(k0) ^ np.uint32(k1) ^ np.uint32(0x1BD11BDA)))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _threefry_block(key, n):
    return _threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                         np.arange(n, dtype=np.uint32))


_KEY0_CACHE = {}


def jax_key0_uniform(which, n):
    """`jax.random.uniform(jax.random.split(PRNGKey(0))[which], (n,))`
    (float32, the partitionable threefry the JAX package runs): the JAX
    ops' keys when they draw without a run key."""
    out = _KEY0_CACHE.get((which, n))
    if out is None:
        b1, b2 = _threefry_block((0, 0), 2)
        bits = np.bitwise_xor(*_threefry_block((b1[which], b2[which]), n))
        out = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
            np.float32) - np.float32(1.0)
        _KEY0_CACHE[(which, n)] = out
    return out


def _sample_keys(ctx, use_random, n, device):
    """The two uniform key vectors [n] of a sampling op (float32)."""
    if use_random and ctx.has_rng():
        gen = ctx.rng()
        return [torch.rand(n, generator=gen, device=device)
                for _ in range(2)]
    return [constant(jax_key0_uniform(i, n), torch.float32, device)
            for i in range(2)]


def _rand_topk(mask, k, u):
    """Up to k True positions of mask [n], the k largest of the keys u
    masked to eligibility: (idx [k], valid [k]), padded when fewer than
    k candidates exist or the pool is smaller than k."""
    n = mask.shape[0]
    scores = torch.where(mask, u, torch.full((), -1.0, dtype=u.dtype,
                                             device=u.device))
    top, idx = top_k_lowest_index(scores, min(k, n))
    if n < k:
        top = F.pad(top, (0, k - n), value=-1.0)
        idx = F.pad(idx, (0, k - n))
    return idx, top >= 0.0


def _fill_batch(fg_idx, fg_ok, bg_idx, bg_avail, batch, fg_max):
    """The sampled slots: the foregrounds first, then backgrounds for
    the rest of the batch (scarce foregrounds mean more background, as
    the reference samples a full batch). → (take_fg, take_bg, fg index
    per slot, bg index per slot)."""
    n_fg = fg_ok.sum()
    slot = torch.arange(batch, device=fg_idx.device)
    fg_idx_pad = F.pad(fg_idx, (0, batch - fg_max))
    fg_ok_pad = F.pad(fg_ok, (0, batch - fg_max))
    j = (slot - n_fg).clamp(0, batch - 1)
    take_fg = (slot < n_fg) & fg_ok_pad
    take_bg = (slot >= n_fg) & bg_avail[j]
    return take_fg, take_bg, fg_idx_pad, bg_idx[j]


def _valid_boxes(boxes):
    return ((boxes[:, 2] - boxes[:, 0]) > 0) & ((boxes[:, 3] - boxes[:, 1])
                                                > 0)


@register_op("rpn_target_assign",
             inputs=["Anchor", "GtBoxes", "IsCrowd?", "ImInfo"],
             outputs=["LocationIndex", "ScoreIndex", "TargetBBox",
                      "TargetLabel", "BBoxInsideWeight"])
def _rpn_target_assign(ctx, anchors, gt_boxes, is_crowd, im_info):
    """rpn_target_assign_op.cc, one image: anchors [A, 4], gt_boxes
    [G, 4] zero-padded. LocationIndex [fg_max] and ScoreIndex [batch]
    are fixed-size with -1 padding; the sampled foregrounds take the
    first slots, backgrounds the rest."""
    batch = ctx.attr("rpn_batch_size_per_im", 256)
    straddle = ctx.attr("rpn_straddle_thresh", 0.0)
    fg_frac = ctx.attr("rpn_fg_fraction", 0.5)
    pos_t = ctx.attr("rpn_positive_overlap", 0.7)
    neg_t = ctx.attr("rpn_negative_overlap", 0.3)
    use_random = ctx.attr("use_random", True)
    a = anchors.shape[0]
    dev = anchors.device
    fg_max = int(batch * fg_frac)
    gt_valid = _valid_boxes(gt_boxes)
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd.reshape(-1) == 0)
    h = im_info.reshape(-1)[0]
    w = im_info.reshape(-1)[1]
    if straddle >= 0:
        inside = ((anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle)
                  & (anchors[:, 2] < w + straddle)
                  & (anchors[:, 3] < h + straddle))
    else:
        inside = torch.ones(a, dtype=torch.bool, device=dev)
    ov = iou(anchors, gt_boxes) * gt_valid[None, :]
    amax, aarg = torch.max(ov, dim=1)
    # each gt's best anchor (among the inside ones) is positive too
    ov_in = torch.where(inside[:, None], ov, torch.full((), -1.0,
                                                        dtype=ov.dtype,
                                                        device=dev))
    gbest = ov_in.amax(0)
    is_gbest = ((ov_in == gbest[None]) & (gbest[None] > 0)
                & gt_valid[None]).any(1)
    fg_mask = inside & (is_gbest | (amax >= pos_t))
    bg_mask = inside & ~fg_mask & (amax < neg_t)
    u1, u2 = _sample_keys(ctx, use_random, a, dev)
    fg_idx, fg_ok = _rand_topk(fg_mask, fg_max, u1)
    bg_idx, bg_avail = _rand_topk(bg_mask, batch, u2)
    take_fg, take_bg, fg_idx_pad, bg_j = _fill_batch(fg_idx, fg_ok, bg_idx,
                                                     bg_avail, batch, fg_max)
    score_index = torch.where(take_fg, fg_idx_pad,
                              torch.where(take_bg, bg_j, -1))
    tgt_label = torch.where(take_fg, 1, torch.where(take_bg, 0, -1)).to(
        torch.int32)
    loc_index = torch.where(fg_ok, fg_idx, -1)
    safe = fg_idx.clamp(0, a - 1)
    deltas = _box2delta(anchors[safe], gt_boxes[aarg[safe]]) * fg_ok[:, None]
    inside_w = fg_ok[:, None].to(torch.float32).expand(fg_max, 4)
    return (loc_index, score_index, deltas.to(torch.float32),
            tgt_label[:, None], inside_w)


@register_op("retinanet_target_assign",
             inputs=["Anchor", "GtBoxes", "GtLabels", "IsCrowd?", "ImInfo"],
             outputs=["LocationIndex", "ScoreIndex", "TargetBBox",
                      "TargetLabel", "BBoxInsideWeight",
                      "ForegroundNumber"])
def _retinanet_target_assign(ctx, anchors, gt_boxes, gt_labels, is_crowd,
                             im_info):
    """rpn_target_assign_op.cc:588, the RetinaNet variant: no sampling,
    every anchor not ignored contributes; foreground label the gt class
    (1..C), background 0. Outputs sized [A]."""
    pos_t = ctx.attr("positive_overlap", 0.5)
    neg_t = ctx.attr("negative_overlap", 0.4)
    a = anchors.shape[0]
    gt_valid = _valid_boxes(gt_boxes)
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd.reshape(-1) == 0)
    ov = iou(anchors, gt_boxes) * gt_valid[None, :]
    amax, aarg = torch.max(ov, dim=1)
    gbest = ov.amax(0)
    is_gbest = ((ov == gbest[None]) & (gbest[None] > 0)
                & gt_valid[None]).any(1)
    fg = is_gbest | (amax >= pos_t)
    bg = ~fg & (amax < neg_t)
    idx = torch.arange(a, device=anchors.device)
    labels = gt_labels.reshape(-1).to(torch.int32)
    tgt_label = torch.where(fg, labels[aarg],
                            torch.where(bg, 0, -1).to(torch.int32))
    deltas = _box2delta(anchors, gt_boxes[aarg]) * fg[:, None]
    return (torch.where(fg, idx, -1), torch.where(fg | bg, idx, -1),
            deltas.to(torch.float32), tgt_label[:, None],
            fg[:, None].to(torch.float32).expand(a, 4),
            fg.sum(dtype=torch.int32).reshape(1, 1))


@register_op("generate_proposal_labels",
             inputs=["RpnRois", "GtClasses", "IsCrowd?", "GtBoxes",
                     "ImInfo"],
             outputs=["Rois", "LabelsInt32", "BboxTargets",
                      "BboxInsideWeights", "BboxOutsideWeights"])
def _generate_proposal_labels(ctx, rois, gt_classes, is_crowd, gt_boxes,
                              im_info):
    """generate_proposal_labels_op.cc, one image: sample
    batch_size_per_im rois from the proposals and the gt boxes
    (foreground by fg_thresh and fg_fraction, background between
    bg_thresh_lo and bg_thresh_hi), with class labels and per-class box
    targets [batch, 4 class_nums]; unsampled slots have label -1 and
    zero weights."""
    batch = ctx.attr("batch_size_per_im", 256)
    fg_frac = ctx.attr("fg_fraction", 0.25)
    fg_t = ctx.attr("fg_thresh", 0.5)
    bg_hi = ctx.attr("bg_thresh_hi", 0.5)
    bg_lo = ctx.attr("bg_thresh_lo", 0.0)
    class_nums = ctx.attr("class_nums", 81)
    use_random = ctx.attr("use_random", True)
    bbox_w = ctx.attr("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])
    fg_max = int(batch * fg_frac)
    dev = rois.device
    allr = torch.cat([rois, gt_boxes], 0)
    n = allr.shape[0]
    # zero-padded proposal and gt rows are not candidates
    roi_valid = _valid_boxes(allr)
    gt_valid = _valid_boxes(gt_boxes)
    if is_crowd is not None:
        gt_valid = gt_valid & (is_crowd.reshape(-1) == 0)
    ov = iou(allr, gt_boxes) * gt_valid[None, :]
    rmax, rarg = torch.max(ov, dim=1)
    fg_mask = roi_valid & (rmax >= fg_t)
    bg_mask = roi_valid & (rmax < bg_hi) & (rmax >= bg_lo)
    u1, u2 = _sample_keys(ctx, use_random, n, dev)
    fg_idx, fg_ok = _rand_topk(fg_mask, fg_max, u1)
    bg_idx, bg_avail = _rand_topk(bg_mask, batch, u2)
    take_fg, take_bg, fg_idx_pad, bg_j = _fill_batch(fg_idx, fg_ok, bg_idx,
                                                     bg_avail, batch, fg_max)
    sel = torch.where(take_fg, fg_idx_pad, torch.where(take_bg, bg_j, 0))
    sel_ok = take_fg | take_bg
    out_rois = allr[sel] * sel_ok[:, None]
    gcls = gt_classes.reshape(-1).to(torch.int32)
    labels = torch.where(take_fg, gcls[rarg[sel]],
                         torch.where(sel_ok, 0, -1).to(torch.int32))
    deltas = (_box2delta(allr[sel], gt_boxes[rarg[sel]], tuple(bbox_w))
              * take_fg[:, None]).to(torch.float32)
    # per-class layout: the deltas in the label's 4-column block
    # (bbox_util.py expand_bbox_targets)
    in_block = (torch.arange(class_nums, device=dev)[None]
                == labels.long().clamp(0, class_nums - 1)[:, None])
    in_block = in_block[..., None]                             # [batch, C, 1]
    fgw = take_fg[:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tgt = torch.where(in_block, (deltas * take_fg[:, None])[:, None, :], zero)
    inside = torch.where(in_block, fgw.to(torch.float32).expand(batch, 1, 4),
                         zero)
    return (out_rois.to(torch.float32), labels[:, None],
            tgt.reshape(batch, class_nums * 4),
            inside.reshape(batch, class_nums * 4),
            inside.reshape(batch, class_nums * 4))


def linspace(start, stop, num):
    """jnp.linspace along a new last dim (start + i (stop - start) /
    (num - 1), the last point exactly stop), for tensors start / stop."""
    if num == 1:
        return start[..., None]
    i = torch.arange(num, dtype=start.dtype, device=start.device)
    out = start[..., None] + i * ((stop - start) / (num - 1))[..., None]
    return torch.cat([out[..., :-1], stop[..., None]], -1)


@register_op("generate_mask_labels",
             inputs=["ImInfo", "GtClasses", "IsCrowd?", "GtSegms",
                     "Rois", "LabelsInt32"],
             outputs=["MaskRois", "RoiHasMaskInt32", "MaskInt32"])
def _generate_mask_labels(ctx, im_info, gt_classes, is_crowd, gt_segms,
                          rois, labels):
    """generate_mask_labels_op.cc with bitmap GtSegms [G, Hs, Ws] (what
    utils/mask_util.py rasterizes from COCO polygons): each foreground
    roi (label > 0) takes the best-IoU gt's mask cropped to the roi at
    resolution², in its label's block of [R, num_classes res²]."""
    num_classes = ctx.attr("num_classes")
    res = ctx.attr("resolution", 14)
    r = rois.shape[0]
    _, hs, ws = gt_segms.shape
    dev = rois.device
    labels = labels.reshape(-1).to(torch.int32)
    fg = labels > 0
    seg = gt_segms.to(float_dtype(rois))
    ys = torch.arange(hs, dtype=seg.dtype, device=dev)
    xs = torch.arange(ws, dtype=seg.dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=seg.dtype, device=dev)
    any_x = seg.amax(1)                                        # [G, Ws]
    any_y = seg.amax(2)                                        # [G, Hs]
    x1 = torch.where(any_x > 0, xs[None], inf).amin(1)
    x2 = torch.where(any_x > 0, xs[None], -inf).amax(1)
    y1 = torch.where(any_y > 0, ys[None], inf).amin(1)
    y2 = torch.where(any_y > 0, ys[None], -inf).amax(1)
    gt_box = torch.stack([x1, y1, x2, y2], 1)
    valid_gt = torch.isfinite(x1)
    ov = iou(rois, gt_box) * valid_gt[None, :]
    best = torch.argmax(ov, dim=1)
    # res x res points over the roi box, nearest below (the JAX
    # package's crop-and-resize of the bitmap)
    gx = linspace(rois[:, 0], rois[:, 2], res)[:, None, :]     # [R, 1, res]
    gy = linspace(rois[:, 1], rois[:, 3], res)[:, :, None]     # [R, res, 1]
    x0 = torch.floor(gx).clamp(0, ws - 1).long()
    y0 = torch.floor(gy).clamp(0, hs - 1).long()
    masks = seg[best[:, None, None], y0, x0]                   # [R, res, res]
    masks = (masks >= 0.5).to(torch.int32) * fg[:, None, None]
    cls = labels.long().clamp(0, num_classes - 1)
    in_block = (torch.arange(num_classes, device=dev)[None] == cls[:, None])
    out = torch.where(in_block[..., None] & fg[:, None, None],
                      masks.reshape(r, 1, res * res), -1).to(torch.int32)
    return (rois * fg[:, None], fg[:, None].to(torch.int32),
            out.reshape(r, num_classes * res * res))
