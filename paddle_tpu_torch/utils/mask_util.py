"""Polygon → bitmap mask utilities (host-side NumPy).

Copy of paddle_tpu/utils/mask_util.py (it imports only numpy), the
reference's operators/detection/mask_util.cc: Poly2Mask (even-odd
scanline rasterization of a polygon into an h×w bitmap), Poly2Boxes
(tight bbox per multi-polygon), Polys2MaskWrtBox (rasterize relative to
a box at M×M resolution). They are the host-side data-layer step that
turns COCO-style polygon annotations into the bitmap GtSegms tensor the
generate_mask_labels op consumes (ops/detection_train.py)."""
import numpy as np


def poly2mask(xy, h, w):
    """Rasterize one polygon (flat [x0, y0, x1, y1, ...]) into an
    h×w uint8 mask via even-odd scanline filling (pixel centers)."""
    pts = np.asarray(xy, np.float64).reshape(-1, 2)
    n = len(pts)
    mask = np.zeros((h, w), np.uint8)
    if n < 3:
        return mask
    ys = np.arange(h) + 0.5                       # pixel centers
    a = pts                                       # edge starts [n, 2]
    b = np.roll(pts, -1, axis=0)                  # edge ends
    # vectorized edge crossings: edge i crosses scanline y iff exactly
    # one endpoint is below it (half-open rule)
    y1 = a[:, 1][None, :]                         # [1, n]
    y2 = b[:, 1][None, :]
    yy = ys[:, None]                              # [h, 1]
    crosses = (y1 <= yy) != (y2 <= yy)            # [h, n]
    denom = np.where(y2 - y1 == 0, 1.0, y2 - y1)
    xint = (a[:, 0][None, :]
            + (yy - y1) * (b[:, 0] - a[:, 0])[None, :] / denom)  # [h, n]
    xint = np.where(crosses, xint, np.inf)
    xint.sort(axis=1)                             # crossings first
    counts = crosses.sum(axis=1)
    for yi in range(h):
        xs = xint[yi, :counts[yi]]
        for j in range(0, len(xs) - 1, 2):
            lo = int(np.ceil(xs[j] - 0.5))
            hi = int(np.floor(xs[j + 1] - 0.5))
            if hi >= lo:
                mask[yi, max(lo, 0):min(hi + 1, w)] = 1
    return mask


def polys_to_mask(polygons, h, w):
    """Union of several polygons (a COCO 'segmentation' list) into one
    h×w bitmap (mask_util.cc Poly2Mask over each part, OR-combined)."""
    out = np.zeros((h, w), np.uint8)
    for poly in polygons:
        out |= poly2mask(poly, h, w)
    return out


def poly2boxes(polys):
    """[[poly, ...], ...] → [N, 4] tight (x1, y1, x2, y2) per instance
    (mask_util.cc Poly2Boxes)."""
    boxes = np.zeros((len(polys), 4), np.float32)
    for i, parts in enumerate(polys):
        if not parts:           # filtered-out instance → zero box
            continue
        all_pts = np.concatenate(
            [np.asarray(p, np.float32).reshape(-1, 2) for p in parts])
        boxes[i] = [all_pts[:, 0].min(), all_pts[:, 1].min(),
                    all_pts[:, 0].max(), all_pts[:, 1].max()]
    return boxes


def polys_to_mask_wrt_box(polygons, box, m):
    """Rasterize an instance's polygons in the frame of `box`
    (x1, y1, x2, y2) at m×m resolution (mask_util.cc
    Polys2MaskWrtBox)."""
    x1, y1, x2, y2 = [float(v) for v in box]
    w = max(x2 - x1, 1.0)
    h = max(y2 - y1, 1.0)
    scaled = []
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2).copy()
        pts[:, 0] = (pts[:, 0] - x1) * m / w
        pts[:, 1] = (pts[:, 1] - y1) * m / h
        scaled.append(pts.ravel())
    return polys_to_mask(scaled, m, m)


def gt_segms_from_polys(polys, h, w):
    """COCO-style [[poly, ...] per instance] → the [G, h, w] bitmap
    tensor generate_mask_labels consumes."""
    return np.stack([polys_to_mask(parts, h, w) for parts in polys]) \
        if polys else np.zeros((0, h, w), np.uint8)
