"""Detection ops.

Counterpart of paddle_tpu/ops/detection.py (the reference's
operators/detection/: iou_similarity, box_coder, prior_box, yolo_box,
multiclass_nms, roi_align, anchor_generator, bipartite_match, roi_pool,
density_prior_box, generate_proposals, ssd_loss, yolov3_loss), with its
static-shape contracts: NMS returns a fixed [N, keep_top_k, 6] of
(class, score, box) padded with class -1, proposals a fixed
[N, post_nms_topN, 4] with zero-score padding.

Every op is batched over images (and over classes for NMS): the
sequential steps of the reference — greedy NMS, bipartite matching —
are a Python loop over the sequential index only, each step one masked
update of the whole batch, with no host read. Selections order equal
values by index, as `lax.top_k` and the stable `jnp.argsort` do
(`top_k_lowest_index`, stable sorts); a scatter with repeated indices
keeps its last update, as XLA's does on the CPU (`scatter_last`).
`yolov3_loss` computes in float32 or wider, its loop over ground-truth
boxes batched: the objectness target of a cell that two boxes hit keeps
the later box's score, the reference's sequential overwrite.
"""
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import at_least_f32_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.math import top_k_lowest_index
from paddle_tpu_torch.ops.nn import stable_sigmoid_ce


def _box_area(b, off=0.0):
    return (torch.clamp(b[..., 2] - b[..., 0] + off, min=0)
            * torch.clamp(b[..., 3] - b[..., 1] + off, min=0))


def iou(a, b, normalized=True):
    """a: [..., M, 4], b: [..., N, 4] → [..., M, N] (xyxy). normalized=False
    uses the +1 pixel convention."""
    off = 0.0 if normalized else 1.0
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = (_box_area(a, off)[..., :, None] + _box_area(b, off)[..., None, :]
             - inter)
    return inter / torch.clamp(union, min=1e-10)


def float_dtype(t):
    """t's dtype if floating, else float32 (the JAX package's default)."""
    return t.dtype if t.is_floating_point() else torch.float32


def const(values, dtype, device):
    """A small constant on `device` without a synchronising copy."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def scatter_last(dst, idx, vals):
    """`dst.at[..., idx].set(vals)` along the last dim, batched over the
    leading dims: where indices repeat, the update that comes last wins
    (XLA's order on the CPU). dst [..., P], idx / vals [..., G]."""
    order = torch.arange(idx.shape[-1], device=idx.device).expand(idx.shape)
    winner = torch.full(dst.shape, -1, dtype=torch.int64, device=dst.device)
    winner = winner.scatter_reduce(-1, idx, order, "amax")
    got = vals.gather(-1, winner.clamp(min=0))
    return torch.where(winner >= 0, got, dst)


def nms_keep(scores, overlap, thresh):
    """Greedy NMS over score-sorted candidates: scores [..., K] (sorted
    descending), overlap [..., K, K]. A candidate is zeroed when an
    earlier one still alive overlaps it above `thresh`; one step of the
    loop per candidate, each over the whole batch."""
    k = scores.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=scores.device).triu(1)
    over = (overlap > thresh) & later
    keep = scores
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    for i in range(k):
        keep = torch.where(over[..., i, :] & (keep[..., i:i + 1] > 0), zero,
                           keep)
    return keep


@register_op("iou_similarity", inputs=["X", "Y"], outputs=["Out"])
def _iou_similarity(ctx, x, y):
    return iou(x, y)


@register_op("box_coder", inputs=["PriorBox", "PriorBoxVar?", "TargetBox"],
             outputs=["OutputBox"])
def _box_coder(ctx, prior, prior_var, target):
    """box_coder_op.cc: encode/decode center-size offsets;
    box_normalized=False uses the pixel (+1 width, -1 output) convention."""
    code_type = ctx.attr("code_type", "encode_center_size")
    norm = ctx.attr("box_normalized", True)
    axis = ctx.attr("axis", 0)
    one = 0.0 if norm else 1.0
    pw = prior[..., 2] - prior[..., 0] + one
    ph = prior[..., 3] - prior[..., 1] + one
    pcx = prior[..., 0] + 0.5 * pw
    pcy = prior[..., 1] + 0.5 * ph
    expand_axis1 = prior.dim() == 2 and target.dim() == 3 and axis == 1
    if expand_axis1:
        # PriorBox rows align with target dim 0 (box_coder_op.cc axis)
        pw, ph = pw[:, None], ph[:, None]
        pcx, pcy = pcx[:, None], pcy[:, None]
    if prior_var is None:
        var = torch.ones(4, dtype=prior.dtype, device=prior.device)
    else:
        var = prior_var
        if var.dim() == 2 and expand_axis1:
            var = var[:, None, :]
    if code_type.startswith("encode"):
        tw = target[..., 2] - target[..., 0] + one
        th = target[..., 3] - target[..., 1] + one
        tcx = target[..., 0] + 0.5 * tw
        tcy = target[..., 1] + 0.5 * th
        return torch.stack([
            (tcx - pcx) / pw / var[..., 0],
            (tcy - pcy) / ph / var[..., 1],
            torch.log(torch.clamp(tw / pw, min=1e-10)) / var[..., 2],
            torch.log(torch.clamp(th / ph, min=1e-10)) / var[..., 3]], -1)
    dcx = target[..., 0] * var[..., 0] * pw + pcx
    dcy = target[..., 1] * var[..., 1] * ph + pcy
    dw = torch.exp(target[..., 2] * var[..., 2]) * pw
    dh = torch.exp(target[..., 3] * var[..., 3]) * ph
    return torch.stack([dcx - dw / 2, dcy - dh / 2,
                        dcx + dw / 2 - one, dcy + dh / 2 - one], -1)


def _centers(n, offset, step, dtype, device):
    return (torch.arange(n, dtype=dtype, device=device) + offset) * step


@register_op("prior_box", inputs=["Input", "Image"],
             outputs=["Boxes", "Variances"])
def _prior_box(ctx, feat, image):
    """prior_box_op.cc: SSD anchors → [fh, fw, nprior, 4] and variances."""
    min_sizes = ctx.attr("min_sizes")
    max_sizes = ctx.attr("max_sizes", [])
    ars = list(ctx.attr("aspect_ratios", [1.0]))
    flip = ctx.attr("flip", True)
    variances = ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])
    offset = ctx.attr("offset", 0.5)
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_h = ctx.attr("step_h", 0.0) or ih / fh
    step_w = ctx.attr("step_w", 0.0) or iw / fw
    dt, dev = float_dtype(feat), feat.device
    ratios = []
    for ar in ars:
        ratios.append(ar)
        if flip and ar != 1.0:
            ratios.append(1.0 / ar)
    cy, cx = torch.meshgrid(_centers(fh, offset, step_h, dt, dev),
                            _centers(fw, offset, step_w, dt, dev),
                            indexing="ij")
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        sizes = [(ms, ms)]
        for ar in ratios:
            if ar == 1.0:
                continue
            sizes.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
        if ms_i < len(max_sizes):
            mx = max_sizes[ms_i]
            sizes.insert(1, ((ms * mx) ** 0.5, (ms * mx) ** 0.5))
        for bw, bh in sizes:
            boxes.append(torch.stack([(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                                      (cx + bw / 2) / iw, (cy + bh / 2) / ih],
                                     -1))
    out = torch.stack(boxes, 2)
    if ctx.attr("clip", True):
        out = out.clamp(0.0, 1.0)
    return out, const(variances, dt, dev).expand(out.shape)


@register_op("yolo_box", inputs=["X", "ImgSize"], outputs=["Boxes", "Scores"])
def _yolo_box(ctx, x, img_size):
    """yolo_box_op.cc: decode a YOLOv3 head into [N, A*H*W, 4] boxes and
    [N, A*H*W, C] scores, zeroed where the objectness is at or below
    conf_thresh."""
    anchors = ctx.attr("anchors")
    class_num = ctx.attr("class_num")
    conf_thresh = ctx.attr("conf_thresh", 0.01)
    downsample = ctx.attr("downsample_ratio", 32)
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    bx = (torch.sigmoid(x[:, :, 0]) + gx) / w
    by = (torch.sigmoid(x[:, :, 1]) + gy) / h
    aw = const(anchors[0::2], x.dtype, x.device).reshape(1, na, 1, 1)
    ah = const(anchors[1::2], x.dtype, x.device).reshape(1, na, 1, 1)
    input_size = downsample * h
    bw = torch.exp(x[:, :, 2]) * aw / input_size
    bh = torch.exp(x[:, :, 3]) * ah / input_size
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] > conf_thresh, probs,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    imh = img_size[:, 0].reshape(n, 1, 1, 1).to(x.dtype)
    imw = img_size[:, 1].reshape(n, 1, 1, 1).to(x.dtype)
    boxes = torch.stack([(bx - bw / 2) * imw, (by - bh / 2) * imh,
                         (bx + bw / 2) * imw, (by + bh / 2) * imh], -1)
    return (boxes.reshape(n, na * h * w, 4),
            probs.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, class_num))


@register_op("multiclass_nms", inputs=["BBoxes", "Scores"], outputs=["Out"])
def _multiclass_nms(ctx, bboxes, scores):
    """multiclass_nms_op.cc with static shapes: greedy NMS per (image,
    class), all of them at once; → [N, keep_top_k, 6] = (class, score,
    box), padded with class -1. bboxes [N, M, 4] (shared) or [N, M, C, 4];
    scores [N, C, M]."""
    score_thresh = ctx.attr("score_threshold", 0.05)
    nms_thresh = ctx.attr("nms_threshold", 0.3)
    nms_top_k = ctx.attr("nms_top_k", 64)
    keep_top_k = ctx.attr("keep_top_k", 100)
    background = ctx.attr("background_label", 0)
    normalized = ctx.attr("normalized", True)
    n, num_cls, num_boxes = scores.shape
    nms_top_k = min(nms_top_k, num_boxes)
    dev = scores.device
    classes = [c for c in range(num_cls) if c != background]
    sc = scores if len(classes) == num_cls else \
        scores[:, const(classes, torch.int64, dev)]
    s = torch.where(sc > score_thresh, sc, torch.zeros((), dtype=sc.dtype,
                                                      device=dev))
    top_s, top_i = top_k_lowest_index(s, nms_top_k)         # [N, C', K]
    rows = torch.arange(n, device=dev)[:, None, None]
    if bboxes.dim() == 3:
        top_b = bboxes[rows, top_i]                          # [N, C', K, 4]
    else:
        cls_idx = const(classes, torch.int64, dev)[None, :, None]
        top_b = bboxes[rows, top_i, cls_idx]
    kept = nms_keep(top_s, iou(top_b, top_b, normalized), nms_thresh)
    cl = const(classes, kept.dtype, dev)[:, None].expand(
        len(classes), nms_top_k).reshape(-1)
    s = kept.reshape(n, -1)
    b = top_b.reshape(n, -1, 4)
    k = min(keep_top_k, s.shape[1])
    ts, ti = top_k_lowest_index(s, k)
    cls_col = torch.where(ts > 0, cl[ti], torch.full((), -1.0, dtype=ts.dtype,
                                                    device=dev))
    out = torch.cat([cls_col[..., None], ts[..., None],
                     b.gather(1, ti[..., None].expand(n, k, 4)).to(ts.dtype)],
                    -1)
    if k < keep_top_k:
        out = F.pad(out, (0, 0, 0, keep_top_k - k), value=-1.0)
    return out


@register_op("roi_align", inputs=["X", "ROIs", "RoisNum?"], outputs=["Out"])
def _roi_align(ctx, x, rois, rois_num):
    """roi_align_op.cc: bilinear ROI pooling, rois [R, 5] = (batch index,
    x1, y1, x2, y2); a fixed sampling grid (4 x 4 when sampling_ratio is
    not positive, the JAX package's static form of the adaptive grid)."""
    ph = ctx.attr("pooled_height", 1)
    pw = ctx.attr("pooled_width", 1)
    scale = ctx.attr("spatial_scale", 1.0)
    ratio = ctx.attr("sampling_ratio", -1)
    sr = max(ratio if ratio > 0 else 4, 1)
    n, c, h, w = x.shape
    dt, dev = rois.dtype, rois.device
    bi = rois[:, 0].long()[:, None, None, None, None]
    x1, y1 = rois[:, 1] * scale, rois[:, 2] * scale
    x2, y2 = rois[:, 3] * scale, rois[:, 4] * scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / pw
    bin_h = torch.clamp(y2 - y1, min=1.0) / ph
    py = torch.arange(ph, dtype=dt, device=dev).view(1, ph, 1, 1, 1)
    px = torch.arange(pw, dtype=dt, device=dev).view(1, 1, pw, 1, 1)
    sub = (torch.arange(sr, dtype=dt, device=dev) + 0.5) / sr
    yy = y1.view(-1, 1, 1, 1, 1) + (py + sub.view(1, 1, 1, sr, 1)) \
        * bin_h.view(-1, 1, 1, 1, 1)                       # [R, ph, 1, sr, 1]
    xx = x1.view(-1, 1, 1, 1, 1) + (px + sub.view(1, 1, 1, 1, sr)) \
        * bin_w.view(-1, 1, 1, 1, 1)                       # [R, 1, pw, 1, sr]
    y0 = torch.floor(yy).long().clamp(0, h - 1)
    x0 = torch.floor(xx).long().clamp(0, w - 1)
    y1i = (y0 + 1).clamp(0, h - 1)
    x1i = (x0 + 1).clamp(0, w - 1)
    wy = (yy.clamp(0, h - 1) - y0.to(dt)).unsqueeze(-1)
    wx = (xx.clamp(0, w - 1) - x0.to(dt)).unsqueeze(-1)
    v = (x[bi, :, y0, x0] * (1 - wy) * (1 - wx)
         + x[bi, :, y1i, x0] * wy * (1 - wx)
         + x[bi, :, y0, x1i] * (1 - wy) * wx
         + x[bi, :, y1i, x1i] * wy * wx)               # [R, ph, pw, sr, sr, C]
    return v.mean(dim=(3, 4)).permute(0, 3, 1, 2)


@register_op("anchor_generator", inputs=["Input"],
             outputs=["Anchors", "Variances"])
def _anchor_generator(ctx, feat):
    sizes = ctx.attr("anchor_sizes")
    ars = ctx.attr("aspect_ratios")
    variances = ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])
    stride = ctx.attr("stride", [16.0, 16.0])
    offset = ctx.attr("offset", 0.5)
    fh, fw = feat.shape[2], feat.shape[3]
    dt, dev = float_dtype(feat), feat.device
    cy, cx = torch.meshgrid(_centers(fh, offset, stride[1], dt, dev),
                            _centers(fw, offset, stride[0], dt, dev),
                            indexing="ij")
    anchors = []
    for ar in ars:
        for s in sizes:
            aw = s * (ar ** 0.5)
            ah = s / (ar ** 0.5)
            anchors.append(torch.stack([cx - aw / 2, cy - ah / 2,
                                        cx + aw / 2, cy + ah / 2], -1))
    out = torch.stack(anchors, 2)
    return out, const(variances, dt, dev).expand(out.shape)


@register_op("bipartite_match", inputs=["DistMat"],
             outputs=["ColToRowMatchIndices", "ColToRowMatchDist"])
def _bipartite_match(ctx, dist):
    """bipartite_match_op.cc: greedy max matching — repeatedly take the
    largest entry whose row and column are both free (the first in
    row-major order among equals), requiring dist > 0, every image of
    the batch one step at a time; then the per_prediction top-up above
    dist_threshold. dist: [B, R, C] or [R, C]."""
    match_type = ctx.attr("match_type", "bipartite")
    thresh = ctx.attr("dist_threshold", 0.5)
    batched = dist.dim() == 3
    d = dist if batched else dist[None]
    b, r, c = d.shape
    dev = d.device
    m_idx = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    m_dist = torch.zeros((b, c), dtype=d.dtype, device=dev)
    free_r = torch.ones((b, r), dtype=torch.bool, device=dev)
    free_c = torch.ones((b, c), dtype=torch.bool, device=dev)
    rows = torch.arange(r, device=dev)[None]
    cols = torch.arange(c, device=dev)[None]
    neg = torch.full((), -1.0, dtype=d.dtype, device=dev)
    for _ in range(min(r, c)):
        masked = torch.where(free_r[:, :, None] & free_c[:, None, :], d,
                             neg).reshape(b, -1)
        flat = torch.argmax(masked, dim=1)
        best = masked.gather(1, flat[:, None])
        take = best > 0
        i, j = (flat // c)[:, None], (flat % c)[:, None]
        at_j = (cols == j) & take
        m_idx = torch.where(at_j, i.to(torch.int32), m_idx)
        m_dist = torch.where(at_j, best, m_dist)
        free_r = free_r & ~((rows == i) & take)
        free_c = free_c & ~at_j
    if match_type == "per_prediction":
        best_d, best_r = torch.max(d, dim=1)
        top_up = (m_idx == -1) & (best_d > thresh)
        m_idx = torch.where(top_up, best_r.to(torch.int32), m_idx)
        m_dist = torch.where(top_up, best_d, m_dist)
    if not batched:
        return m_idx[0], m_dist[0]
    return m_idx, m_dist


@register_op("roi_pool", inputs=["X", "ROIs", "RoisNum?"],
             outputs=["Out", "Argmax"])
def _roi_pool(ctx, x, rois, rois_num):
    """roi_pool_op.cc: quantized max pooling over ROI bins (Fast R-CNN),
    rois [R, 5] = (batch index, x1, y1, x2, y2); Argmax is the flat H*W
    position of each bin's maximum, -1 for an empty bin."""
    ph = ctx.attr("pooled_height", 1)
    pw = ctx.attr("pooled_width", 1)
    scale = ctx.attr("spatial_scale", 1.0)
    n, ch, h, w = x.shape
    dev = x.device
    q = torch.round(rois[:, 1:] * scale).long()
    x1, y1, x2, y2 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    py = torch.arange(ph, device=dev)[None]
    px = torch.arange(pw, device=dev)[None]
    hstart = (y1 + (py * rh) // ph).clamp(0, h)                # [R, ph]
    hend = (y1 + -(-((py + 1) * rh) // ph)).clamp(0, h)
    wstart = (x1 + (px * rw) // pw).clamp(0, w)
    wend = (x1 + -(-((px + 1) * rw) // pw)).clamp(0, w)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    ymask = (ys >= hstart[..., None]) & (ys < hend[..., None])  # [R, ph, H]
    xmask = (xs >= wstart[..., None]) & (xs < wend[..., None])  # [R, pw, W]
    m = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]  # [R,ph,pw,H,W]
    img = x[rois[:, 0].long()]                                # [R, C, H, W]
    vals = torch.where(m[:, None], img[:, :, None, None],
                       torch.full((), float("-inf"), dtype=x.dtype,
                                  device=dev))
    flat = vals.reshape(*vals.shape[:4], -1)
    out, amax = torch.max(flat, dim=-1)
    empty = ~m.reshape(*m.shape[:3], -1).any(-1)[:, None]
    out = torch.where(empty, torch.zeros((), dtype=x.dtype, device=dev), out)
    return out, torch.where(empty, -1, amax).to(torch.int32)


@register_op("density_prior_box", inputs=["Input", "Image"],
             outputs=["Boxes", "Variances"])
def _density_prior_box(ctx, feat, image):
    """density_prior_box_op.h: per cell, for each (fixed_size, density),
    density^2 shifted centers, each with every fixed_ratio; the shifts
    from the average step, coordinates clamped to [0, 1] always."""
    fixed_sizes = ctx.attr("fixed_sizes")
    fixed_ratios = ctx.attr("fixed_ratios")
    densities = ctx.attr("densities")
    variances = ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])
    offset = ctx.attr("offset", 0.5)
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_h = ctx.attr("step_h", 0.0) or ih / fh
    step_w = ctx.attr("step_w", 0.0) or iw / fw
    step_average = int((step_w + step_h) * 0.5)
    dt, dev = float_dtype(feat), feat.device
    cy, cx = torch.meshgrid(_centers(fh, offset, step_h, dt, dev),
                            _centers(fw, offset, step_w, dt, dev),
                            indexing="ij")
    boxes = []
    for size, density in zip(fixed_sizes, densities):
        shift = int(step_average / density)
        for r in fixed_ratios:
            bw = size * (r ** 0.5)
            bh = size / (r ** 0.5)
            for di in range(density):
                for dj in range(density):
                    ccx = cx - step_average / 2.0 + shift / 2.0 + dj * shift
                    ccy = cy - step_average / 2.0 + shift / 2.0 + di * shift
                    boxes.append(torch.stack(
                        [(ccx - bw / 2.0) / iw, (ccy - bh / 2.0) / ih,
                         (ccx + bw / 2.0) / iw, (ccy + bh / 2.0) / ih], -1))
    out = torch.stack(boxes, 2).clamp(0.0, 1.0)
    return out, const(variances, dt, dev).expand(out.shape)


@register_op("generate_proposals",
             inputs=["Scores", "BboxDeltas", "ImInfo", "Anchors",
                     "Variances"],
             outputs=["RpnRois", "RpnRoiProbs"])
def _generate_proposals(ctx, scores, deltas, im_info, anchors, variances):
    """generate_proposals_op.cc (RPN): the pre_nms_topN best anchors,
    decoded, clipped to the image, tiny boxes' scores zeroed, NMS (the
    +1 pixel convention), the post_nms_topN best kept: → rois
    [N, post_nms_topN, 4], probs [N, post_nms_topN, 1], zero-padded."""
    pre_n = ctx.attr("pre_nms_topN", 6000)
    post_n = ctx.attr("post_nms_topN", 1000)
    nms_thresh = ctx.attr("nms_thresh", 0.5)
    min_size = max(ctx.attr("min_size", 0.1), 1.0)
    n, a, fh, fw = scores.shape
    a4 = anchors.reshape(-1, 4)
    var4 = variances.reshape(-1, 4)
    pre_n = min(pre_n, a4.shape[0])
    s = scores.permute(0, 2, 3, 1).reshape(n, -1)               # [N, H*W*A]
    d = deltas.reshape(n, -1, 4, fh, fw).permute(0, 3, 4, 1, 2).reshape(
        n, -1, 4)
    top_s, top_i = top_k_lowest_index(s, pre_n)
    anc = a4[top_i]                                             # [N, K, 4]
    dv = d.gather(1, top_i[..., None].expand(n, pre_n, 4)) * var4[top_i]
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + aw / 2
    acy = anc[..., 1] + ah / 2
    cx = dv[..., 0] * aw + acx
    cy = dv[..., 1] * ah + acy
    bw = torch.exp(torch.clamp(dv[..., 2], max=10.0)) * aw
    bh = torch.exp(torch.clamp(dv[..., 3], max=10.0)) * ah
    zero = torch.zeros((), dtype=cx.dtype, device=cx.device)
    wmax = (im_info[:, 1] - 1)[:, None]
    hmax = (im_info[:, 0] - 1)[:, None]
    boxes = torch.stack([
        torch.minimum(torch.maximum(cx - bw / 2, zero), wmax),
        torch.minimum(torch.maximum(cy - bh / 2, zero), hmax),
        torch.minimum(torch.maximum(cx + bw / 2 - 1, zero), wmax),
        torch.minimum(torch.maximum(cy + bh / 2 - 1, zero), hmax)], -1)
    # FilterBoxes (generate_proposals_op.cc:160-177): the +1 applies in
    # the original image's scale
    im_scale = im_info[:, 2:3]
    ws = (boxes[..., 2] - boxes[..., 0]) / im_scale + 1
    hs = (boxes[..., 3] - boxes[..., 1]) / im_scale + 1
    s_kept = torch.where((ws >= min_size) & (hs >= min_size), top_s,
                         torch.zeros((), dtype=top_s.dtype,
                                     device=top_s.device))
    kept = nms_keep(s_kept, iou(boxes, boxes, normalized=False), nms_thresh)
    fs, fi = top_k_lowest_index(kept, min(post_n, pre_n))
    out_boxes = boxes.gather(1, fi[..., None].expand(*fi.shape, 4))
    if post_n > pre_n:
        out_boxes = F.pad(out_boxes, (0, 0, 0, post_n - pre_n))
        fs = F.pad(fs, (0, post_n - pre_n))
    return out_boxes, fs[..., None]


@register_op("ssd_loss",
             inputs=["Location", "Confidence", "GtBox", "GtLabel", "PriorBox",
                     "PriorBoxVar?", "GtCount?"],
             outputs=["Loss"])
def _ssd_loss(ctx, loc, conf, gt_box, gt_label, prior, prior_var, gt_count):
    """layers/detection.py ssd_loss as one op: per image, match priors to
    ground truth (each gt's best prior, and per_prediction every prior
    above overlap_threshold), encode regression targets, mine hard
    negatives at neg_pos_ratio by background loss, and return the
    normalized weighted sum [N, 1]. gt_box [N, G, 4] with gt_count [N]
    in place of the LoD input."""
    neg_ratio = ctx.attr("neg_pos_ratio", 3.0)
    overlap = ctx.attr("overlap_threshold", 0.5)
    neg_overlap = ctx.attr("neg_overlap", 0.5)
    loc_w = ctx.attr("loc_loss_weight", 1.0)
    conf_w = ctx.attr("conf_loss_weight", 1.0)
    background = ctx.attr("background_label", 0)
    normalize = ctx.attr("normalize", True)
    match_type = ctx.attr("match_type", "per_prediction")
    mining = ctx.attr("mining_type", "max_negative")
    enforce(mining == "max_negative",
            "ssd_loss supports mining_type='max_negative' (the reference's "
            "hard_example mining needs dynamic sample_size selection)")
    n, p, _ = conf.shape
    g = gt_box.shape[1]
    dev = conf.device
    garange = torch.arange(g, device=dev)
    counts = (gt_count.reshape(-1).long() if gt_count is not None
              else torch.full((n,), g, dtype=torch.int64, device=dev))
    gmask = garange[None] < counts[:, None]                     # [N, G]
    ov = iou(prior.expand(n, p, 4), gt_box) * gmask[:, None, :]  # [N, P, G]
    best_d, best_g = torch.max(ov, dim=2)
    matched = (best_d > overlap) if match_type == "per_prediction" else \
        torch.zeros((n, p), dtype=torch.bool, device=dev)
    best_p = torch.argmax(ov, dim=1)                            # [N, G]
    matched = scatter_last(matched, best_p, torch.where(
        gmask, True, matched.gather(1, best_p)))
    best_g = scatter_last(best_g, best_p, torch.where(
        gmask, garange[None].expand(n, g), best_g.gather(1, best_p)))
    tgt_box = gt_box.gather(1, best_g[..., None].expand(n, p, 4))
    tgt_lbl = torch.where(matched,
                          gt_label.reshape(n, -1).long().gather(1, best_g),
                          background)
    var = prior_var if prior_var is not None else \
        const([0.1, 0.1, 0.2, 0.2], loc.dtype, dev)
    if var.dim() == 1:
        var = var[None].expand(p, 4)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    tw = torch.clamp(tgt_box[..., 2] - tgt_box[..., 0], min=1e-6)
    th = torch.clamp(tgt_box[..., 3] - tgt_box[..., 1], min=1e-6)
    tcx = tgt_box[..., 0] + 0.5 * tw
    tcy = tgt_box[..., 1] + 0.5 * th
    enc = torch.stack([(tcx - pcx) / pw / var[:, 0],
                       (tcy - pcy) / ph / var[:, 1],
                       torch.log(tw / pw) / var[:, 2],
                       torch.log(th / ph) / var[:, 3]], -1)
    ad = torch.abs(loc - enc)
    loc_l = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(-1)
    loc_loss = (loc_l * matched).sum(1)
    logp = torch.log_softmax(conf, dim=-1)
    conf_l = -logp.gather(-1, tgt_lbl[..., None])[..., 0]
    bg_l = -logp[..., background]
    num_pos = matched.sum(1, dtype=torch.int32)
    num_neg = torch.minimum((neg_ratio * num_pos).to(torch.int32),
                            p - num_pos)
    # negatives only from priors whose best overlap is under neg_overlap
    neg_ok = ~matched & (best_d < neg_overlap)
    neg_scores = torch.where(neg_ok, bg_l, torch.full(
        (), float("-inf"), dtype=bg_l.dtype, device=dev))
    order = torch.sort(-neg_scores, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(p, device=dev).expand(n, p))
    neg_sel = neg_ok & (rank < num_neg[:, None])
    conf_loss = (conf_l * matched).sum(1) + (bg_l * neg_sel).sum(1)
    norm = torch.clamp(num_pos.to(loc.dtype), min=1.0) if normalize else 1.0
    return ((conf_w * conf_loss + loc_w * loc_loss) / norm)[:, None]


def _iou_cwh(b1, b2):
    """Center-format (cx, cy, w, h) IoU over the last dim."""
    ox = (torch.minimum(b1[..., 0] + b1[..., 2] / 2,
                        b2[..., 0] + b2[..., 2] / 2)
          - torch.maximum(b1[..., 0] - b1[..., 2] / 2,
                          b2[..., 0] - b2[..., 2] / 2))
    oy = (torch.minimum(b1[..., 1] + b1[..., 3] / 2,
                        b2[..., 1] + b2[..., 3] / 2)
          - torch.maximum(b1[..., 1] - b1[..., 3] / 2,
                          b2[..., 1] - b2[..., 3] / 2))
    inter = torch.where((ox < 0) | (oy < 0),
                        torch.zeros((), dtype=ox.dtype, device=ox.device),
                        ox * oy)
    union = b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter
    return inter / torch.clamp(union, min=1e-10)


@register_op("yolov3_loss",
             inputs=["X", "GTBox", "GTLabel", "GTScore?"],
             outputs=["Loss", "ObjectnessMask", "GTMatchMask"])
def _yolov3_loss(ctx, x, gt_box, gt_label, gt_score):
    """yolov3_loss_op.h: per-image YOLOv3 loss — sigmoid-CE x/y and L1
    w/h at each gt's best-anchor cell (scale (2 - w h) score), sigmoid-CE
    per class with optional label smoothing, objectness CE with the cells
    whose best prediction-gt IoU exceeds ignore_thresh left out. gt boxes
    are normalized (cx, cy, w, h); a zero-area row is padding."""
    anchors = list(ctx.attr("anchors"))
    anchor_mask = list(ctx.attr("anchor_mask"))
    class_num = ctx.attr("class_num")
    ignore_thresh = ctx.attr("ignore_thresh", 0.7)
    downsample = ctx.attr("downsample_ratio", 32)
    use_smooth = ctx.attr("use_label_smooth", True)
    n, _, h, w = x.shape
    m = len(anchor_mask)
    an_num = len(anchors) // 2
    b = gt_box.shape[1]
    input_size = downsample * h
    f = at_least_f32_dtype(x)
    dev = x.device
    xr = x.reshape(n, m, 5 + class_num, h, w).to(f)
    gt_box = gt_box.to(f)
    score = (gt_score.to(f) if gt_score is not None
             else torch.ones((n, b), dtype=f, device=dev))
    gt_valid = (gt_box[..., 2] * gt_box[..., 3]) > 1e-6          # [N, B]
    if use_smooth:
        sm = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - sm, sm
    else:
        label_pos, label_neg = 1.0, 0.0
    zero = torch.zeros((), dtype=f, device=dev)
    anchors_t = const(anchors, f, dev)

    # the ignore mask: cells whose predicted box overlaps a gt above
    # ignore_thresh (no gradient flows through it)
    with torch.no_grad():
        xd = xr.detach()
        gx = torch.arange(w, dtype=f, device=dev)[None, None, None, :]
        gy = torch.arange(h, dtype=f, device=dev)[None, None, :, None]
        aw = const([anchors[2 * i] for i in anchor_mask], f, dev)
        ah = const([anchors[2 * i + 1] for i in anchor_mask], f, dev)
        pred = torch.stack([
            (gx + torch.sigmoid(xd[:, :, 0])) / w,
            (gy + torch.sigmoid(xd[:, :, 1])) / h,
            torch.exp(xd[:, :, 2]) * aw[None, :, None, None] / input_size,
            torch.exp(xd[:, :, 3]) * ah[None, :, None, None] / input_size],
            -1)                                                   # [N,M,H,W,4]
        ious = _iou_cwh(pred[:, :, :, :, None, :],
                        gt_box[:, None, None, None, :, :])        # [N,M,H,W,B]
        ious = torch.where(gt_valid[:, None, None, None, :], ious, zero)
        obj_mask = torch.where(ious.amax(-1) > ignore_thresh,
                               torch.full((), -1.0, dtype=f, device=dev), zero)

    # every gt at once: its best anchor by shape over all anchors
    an_wh = anchors_t.reshape(an_num, 2) / input_size
    shape_iou = _iou_cwh(
        torch.cat([torch.zeros((n, b, 2), dtype=f, device=dev),
                   gt_box[..., 2:]], -1)[:, :, None, :],
        torch.cat([torch.zeros((an_num, 2), dtype=f, device=dev), an_wh],
                  1)[None, None])                                 # [N, B, A]
    best_n = torch.argmax(shape_iou, dim=-1)                      # [N, B]
    mask_idx = torch.full((n, b), -1, dtype=torch.int64, device=dev)
    for mi, a in enumerate(anchor_mask):
        mask_idx = torch.where(best_n == a, mi, mask_idx)
    pos = gt_valid & (mask_idx >= 0)
    match_mask = torch.where(gt_valid, mask_idx, -1).to(torch.int32)
    gi = (gt_box[..., 0] * w).to(torch.int32).long().clamp(0, w - 1)
    gj = (gt_box[..., 1] * h).to(torch.int32).long().clamp(0, h - 1)
    mi_safe = mask_idx.clamp(min=0)
    rows = torch.arange(n, device=dev)[:, None]
    entry = xr[rows, mi_safe, :, gj, gi]                          # [N, B, 5+C]
    tx = gt_box[..., 0] * w - gi
    ty = gt_box[..., 1] * h - gj
    a_w = anchors_t[2 * best_n]
    a_h = anchors_t[2 * best_n + 1]
    tw = torch.log(torch.clamp(gt_box[..., 2] * input_size / a_w, min=1e-9))
    th = torch.log(torch.clamp(gt_box[..., 3] * input_size / a_h, min=1e-9))
    scale = (2.0 - gt_box[..., 2] * gt_box[..., 3]) * score
    loc = ((stable_sigmoid_ce(entry[..., 0], tx)
            + stable_sigmoid_ce(entry[..., 1], ty)) * scale
           + (torch.abs(tw - entry[..., 2]) + torch.abs(th - entry[..., 3]))
           * scale)
    lbl = gt_label.long()
    cls_t = torch.where(torch.arange(class_num, device=dev) == lbl[..., None],
                        label_pos, label_neg).to(f)
    cls = stable_sigmoid_ce(entry[..., 5:], cls_t).sum(-1) * score
    loss = torch.where(pos, loc + cls, zero).sum(1)
    # the positive objectness targets; a cell two gts hit keeps the
    # later gt's score
    cells = m * h * w
    cell = torch.where(pos, (mi_safe * h + gj) * w + gi, cells)
    obj_mask = scatter_last(F.pad(obj_mask.reshape(n, cells), (0, 1)), cell,
                            score)[:, :cells].reshape(n, m, h, w)
    obj_logit = xr[:, :, 4]
    obj_l = torch.where(
        obj_mask > 1e-5, stable_sigmoid_ce(obj_logit, 1.0) * obj_mask,
        torch.where(obj_mask > -0.5, stable_sigmoid_ce(obj_logit, 0.0), zero))
    loss = loss + obj_l.sum((1, 2, 3))
    return loss.to(x.dtype), obj_mask.to(x.dtype), match_mask
