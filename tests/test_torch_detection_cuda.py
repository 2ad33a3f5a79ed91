"""The detection and vision ops, and a tiny YOLOv3, on the card against
the CPU.

* Every op type of ops/detection.py, ops/detection_train.py and
  ops/vision.py on inputs of the corpus's kinds and shapes
  (tests/test_ops_detection{,2,3}.py, tests/test_ops_vision.py; those
  files import the JAX package, so the inputs are made here): float64
  on the card and on the CPU, every continuous output and the float
  inputs' gradients of sum(out x cotangent) within 1e-9 of their max,
  the discrete outputs (integer outputs, NMS classes and row order, the
  objectness mask) equal.
* YoloConfig.tiny() at 2 x 64^2 in float64 from the same weights: one
  training step's loss (rtol 1e-12) and gradients (1e-9 of each
  tensor's max, floor 1e-6 of the largest), and `predict` in eval mode
  (classes and rows equal, values within 1e-9 of the max).

Marked `cuda`: it skips without a GPU. It imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_detection_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.registry import OpContext, get_op

pytestmark = pytest.mark.cuda

TOL = 1e-9
R = np.random.RandomState(15)


def _f(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, size=shape)


def _boxes(n, lo=0.0, hi=8.0):
    xy = R.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + R.uniform(1, 4, (n, 2))], 1)


def _off(*shape):
    mag = R.uniform(0.15, 0.45, size=shape)
    return np.where(R.rand(*shape) < 0.5, -mag, mag)


def _anchors16():
    return np.array([[x * 8, y * 8, x * 8 + 15, y * 8 + 15]
                     for y in range(4) for x in range(4)], np.float64)


def _proposal_anchors():
    """[4, 4, 3, 4]: three square anchors (6, 10, 14) at each of a 4 x 4
    grid of stride 8."""
    a = np.zeros((4, 4, 3, 4))
    for i in range(4):
        for j in range(4):
            for k in range(3):
                cx, cy, half = j * 8 + 4, i * 8 + 4, 3 + 2 * k
                a[i, j, k] = [cx - half, cy - half, cx + half, cy + half]
    return a


_GT2 = np.array([[6, 6, 24, 24], [0, 0, 0, 0]], np.float64)
_ROIS = np.array([[0, 1, 1, 4, 4], [1, 0, 2, 3, 5]], np.float64)
_IM = np.array([[32, 32, 1.0]])
_YOLO_GT = np.concatenate([R.uniform(0.2, 0.8, (2, 3, 2)),
                           R.uniform(0.05, 0.25, (2, 3, 2))], 2)
_YOLO_GT[1, 2] = 0
_NMS_BOXES = np.concatenate([R.uniform(0, 0.5, (2, 12, 3, 2)),
                             R.uniform(0.5, 1.0, (2, 12, 3, 2))], 3)
_SEGS = np.zeros((2, 32, 32))
_SEGS[0, 6:25, 6:25] = 1

#: name: (op, {slot: numpy}, attrs, float slots whose gradient is
#: checked, {output index: column (None: all) of a discrete float output})
CASES = {
    "iou_similarity": ("iou_similarity", {"X": _boxes(4), "Y": _boxes(5)},
                       {}, [], {}),
    "box_coder_encode": ("box_coder", {
        "PriorBox": _boxes(6), "PriorBoxVar": R.uniform(0.1, 0.3, (6, 4)),
        "TargetBox": _boxes(6)}, {"code_type": "encode_center_size"},
        ["TargetBox"], {}),
    "box_coder_decode": ("box_coder", {
        "PriorBox": _boxes(6), "TargetBox": R.uniform(-0.5, 0.5, (6, 4))},
        {"code_type": "decode_center_size", "box_normalized": False},
        ["TargetBox"], {}),
    "prior_box": ("prior_box", {"Input": _f(1, 8, 2, 2),
                                "Image": _f(1, 3, 16, 16)},
                  {"min_sizes": [4.0], "max_sizes": [8.0],
                   "aspect_ratios": [2.0], "clip": True}, [], {}),
    "density_prior_box": ("density_prior_box", {"Input": _f(1, 4, 2, 2),
                                                "Image": _f(1, 3, 16, 16)},
                          {"fixed_sizes": [4.0], "fixed_ratios": [1.0],
                           "densities": [2]}, [], {}),
    "anchor_generator": ("anchor_generator", {"Input": _f(1, 8, 2, 3)},
                         {"anchor_sizes": [32.0, 64.0],
                          "aspect_ratios": [0.5, 1.0]}, [], {}),
    "yolo_box": ("yolo_box", {"X": _f(2, 14, 3, 3),
                              "ImgSize": np.array([[32, 32], [48, 40]],
                                                  np.int32)},
                 {"anchors": [10, 13, 16, 30], "class_num": 2,
                  "conf_thresh": 0.3, "downsample_ratio": 16}, ["X"], {}),
    "multiclass_nms": ("multiclass_nms", {
        "BBoxes": _NMS_BOXES, "Scores": np.round(R.uniform(0, 1, (2, 3, 12)),
                                                 1)},
        {"score_threshold": 0.25, "nms_threshold": 0.4, "nms_top_k": 8,
         "keep_top_k": 20, "background_label": 0}, [], {0: 0}),
    "roi_align": ("roi_align", {"X": _f(2, 2, 6, 6), "ROIs": _ROIS},
                  {"pooled_height": 2, "pooled_width": 2,
                   "sampling_ratio": 2}, ["X"], {}),
    "roi_pool": ("roi_pool", {"X": _f(1, 2, 6, 6),
                              "ROIs": np.array([[0, 0, 0, 3, 3],
                                                [0, 2, 2, 5, 5.]])},
                 {"pooled_height": 2, "pooled_width": 2}, ["X"], {}),
    "bipartite_match": ("bipartite_match",
                        {"DistMat": np.round(R.uniform(0, 1, (2, 4, 5)), 1)},
                        {"match_type": "per_prediction",
                         "dist_threshold": 0.4}, [], {}),
    "generate_proposals": ("generate_proposals", {
        "Scores": R.uniform(0, 1, (2, 3, 4, 4)),
        "BboxDeltas": 0.1 * R.randn(2, 12, 4, 4),
        "ImInfo": np.array([[32, 32, 1.0], [28, 30, 1.5]]),
        "Anchors": _proposal_anchors(),
        "Variances": np.full((4, 4, 3, 4), 0.1)},
        {"pre_nms_topN": 24, "post_nms_topN": 8, "nms_thresh": 0.6,
         "min_size": 2.0}, [], {1: None}),
    "ssd_loss": ("ssd_loss", {
        "Location": 0.1 * R.randn(2, 6, 4), "Confidence": _f(2, 6, 3),
        "GtBox": np.concatenate([R.uniform(0, 0.5, (2, 3, 2)),
                                 R.uniform(0.55, 1, (2, 3, 2))], 2),
        "GtLabel": R.randint(1, 3, (2, 3, 1)),
        "PriorBox": np.concatenate([R.uniform(0, 0.5, (6, 2)),
                                    R.uniform(0.55, 1, (6, 2))], 1),
        "GtCount": np.array([3, 1], np.int32)}, {},
        ["Location", "Confidence"], {}),
    "yolov3_loss": ("yolov3_loss", {
        "X": 0.5 * R.randn(2, 16, 4, 4), "GTBox": _YOLO_GT,
        "GTLabel": R.randint(0, 3, (2, 3)).astype(np.int32),
        "GTScore": R.uniform(0.5, 1, (2, 3))},
        {"anchors": [10, 14, 23, 27, 37, 58], "anchor_mask": [0, 1],
         "class_num": 3, "ignore_thresh": 0.7, "downsample_ratio": 32},
        ["X"], {1: None}),
    "box_clip": ("box_clip", {"Input": _f(2, 4, 4, lo=-10, hi=60),
                              "ImInfo": np.array([[40, 30, 1.0],
                                                  [60, 80, 2.0]])},
                 {}, ["Input"], {}),
    "sigmoid_focal_loss": ("sigmoid_focal_loss", {
        "X": _f(5, 3), "Label": np.array([[1], [3], [-1], [2], [0]]),
        "FgNum": np.array([2], np.int32)}, {"gamma": 2.0, "alpha": 0.25},
        ["X"], {}),
    "polygon_box_transform": ("polygon_box_transform",
                              {"Input": _f(2, 4, 3, 5)}, {}, ["Input"], {}),
    "target_assign": ("target_assign", {
        "X": _f(2, 3, 4), "MatchIndices": np.array([[0, -1, 2, 1],
                                                    [1, 0, -1, -1]],
                                                   np.int32),
        "NegIndices": np.array([[0, 1, 0, 0], [0, 0, 1, 0]], np.int32)},
        {"mismatch_value": 0}, ["X"], {}),
    "box_decoder_and_assign": ("box_decoder_and_assign", {
        "PriorBox": np.array([[0, 0, 10, 10], [5, 5, 30, 20.]]),
        "PriorBoxVar": np.full((2, 4), 0.1), "TargetBox": _f(2, 12),
        "BoxScore": _f(2, 3, lo=0, hi=1)}, {}, ["TargetBox"], {}),
    "distribute_fpn_proposals": ("distribute_fpn_proposals", {
        "FpnRois": np.array([[0, 0, 10, 10], [0, 0, 100, 100],
                             [0, 0, 300, 300], [0, 0, 60, 60.]])},
        {"min_level": 2, "max_level": 5, "refer_level": 4,
         "refer_scale": 224}, [], {}),
    "collect_fpn_proposals": ("collect_fpn_proposals", {
        "MultiLevelRois": [_f(3, 4), _f(4, 4)],
        "MultiLevelScores": [R.rand(3, 1), R.rand(4, 1)]},
        {"post_nms_topN": 9}, [], {}),
    "roi_perspective_transform": ("roi_perspective_transform", {
        "X": _f(2, 2, 8, 8),
        "ROIs": np.array([[0, 1, 5, 6, 1, 1, 1, 5, 6],
                          [1, 0.5, 4.5, 5, 0, 0.5, 1, 4, 4.5]])},
        {"transformed_height": 3, "transformed_width": 4}, ["X"], {}),
    "detection_map": ("detection_map", {
        "DetectRes": np.array([[[0, 0.9, 0, 0, 10, 10],
                                [1, 0.8, 20, 20, 30, 30],
                                [0, 0.7, 50, 50, 60, 60],
                                [-1, 0, 0, 0, 0, 0]]]),
        "Label": np.array([[[0, 0, 1, 1, 9, 9], [1, 0, 21, 21, 29, 29],
                            [-1, 0, 0, 0, 0, 0]]])},
        {"class_num": 2, "overlap_threshold": 0.5}, [], {}),
    "rpn_target_assign": ("rpn_target_assign", {
        "Anchor": _anchors16(), "GtBoxes": _GT2, "ImInfo": _IM},
        {"rpn_batch_size_per_im": 8, "rpn_positive_overlap": 0.5,
         "rpn_negative_overlap": 0.2, "rpn_straddle_thresh": -1.0,
         "use_random": False}, [], {}),
    "retinanet_target_assign": ("retinanet_target_assign", {
        "Anchor": _anchors16(), "GtBoxes": _GT2,
        "GtLabels": np.array([[2], [0]]), "ImInfo": _IM}, {}, [], {}),
    "generate_proposal_labels": ("generate_proposal_labels", {
        "RpnRois": _anchors16(), "GtClasses": np.array([[2], [0]]),
        "GtBoxes": _GT2, "ImInfo": _IM},
        {"batch_size_per_im": 8, "fg_fraction": 0.5, "class_nums": 4,
         "use_random": False}, [], {1: None}),
    "generate_mask_labels": ("generate_mask_labels", {
        "ImInfo": _IM, "GtClasses": np.array([[2], [0]]), "GtSegms": _SEGS,
        "Rois": np.array([[5, 5, 23, 23], [0, 0, 7, 7], [26, 26, 31, 31.]]),
        "LabelsInt32": np.array([[2], [0], [0]], np.int32)},
        {"num_classes": 3, "resolution": 4}, [], {}),
    "affine_grid": ("affine_grid", {"Theta": _f(2, 2, 3)},
                    {"output_shape": [2, 1, 3, 4]}, ["Theta"], {}),
    "max_pool2d_with_index": ("max_pool2d_with_index",
                              {"X": _f(2, 2, 4, 4, lo=-2, hi=2)},
                              {"ksize": [2, 2], "strides": [2, 2]}, ["X"],
                              {}),
    "unpool": ("unpool", {"X": _f(1, 1, 2, 2),
                          "Indices": np.array([[[[0, 5], [10, 15]]]],
                                              np.int32)},
               {"ksize": [2, 2], "strides": [2, 2]}, ["X"], {}),
    "spp_max": ("spp", {"X": _f(2, 2, 5, 5)}, {"pyramid_height": 2,
                                               "pooling_type": "max"},
                ["X"], {}),
    "spp_avg": ("spp", {"X": _f(2, 2, 5, 5)}, {"pyramid_height": 2,
                                               "pooling_type": "avg"},
                ["X"], {}),
    "psroi_pool": ("psroi_pool", {"X": _f(2, 8, 6, 6), "ROIs": _ROIS},
                   {"pooled_height": 2, "pooled_width": 2,
                    "output_channels": 2, "spatial_scale": 0.5}, ["X"], {}),
    "prroi_pool": ("prroi_pool", {
        "X": _f(2, 2, 6, 6), "ROIs": np.array([[0, 1.3, 0.8, 4.2, 5.1],
                                               [1, 0.4, 1.7, 3.9, 4.4]])},
        {"pooled_height": 2, "pooled_width": 2}, ["X", "ROIs"], {}),
    "deformable_conv_v1": ("deformable_conv_v1", {
        "Input": _f(1, 2, 5, 5), "Offset": _off(1, 18, 3, 3),
        "Filter": _f(3, 2, 3, 3)}, {}, ["Input", "Offset", "Filter"], {}),
    "deformable_conv": ("deformable_conv", {
        "Input": _f(1, 4, 5, 5), "Offset": _off(1, 36, 5, 5),
        "Mask": _f(1, 18, 5, 5, lo=0.2, hi=1.0), "Filter": _f(4, 2, 3, 3)},
        {"paddings": [1, 1], "groups": 2, "deformable_groups": 2},
        ["Input", "Mask", "Filter"], {}),
    "deformable_psroi_pooling": ("deformable_psroi_pooling", {
        "Input": _f(2, 4, 6, 6), "ROIs": _ROIS, "Trans": 0.5 * _f(2, 2, 2,
                                                                 2)},
        {"spatial_scale": 1.0, "output_dim": 1, "group_size": [2, 2],
         "pooled_size": [2, 2], "part_size": [2, 2], "sample_per_part": 3,
         "trans_std": 0.1}, ["Input", "Trans"], {}),
    "deformable_psroi_no_trans": ("deformable_psroi_pooling", {
        "Input": _f(2, 4, 6, 6), "ROIs": _ROIS},
        {"no_trans": True, "output_dim": 4, "pooled_size": [2, 2],
         "part_size": [2, 2], "sample_per_part": 2}, ["Input"], {}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card against the CPU")


def _tensor(a, device):
    t = torch.from_numpy(np.array(a, copy=True))
    return (t.double() if t.is_floating_point() else t).to(device)


def _run(name, device):
    op, inputs, attrs, grads, _ = CASES[name]
    impl = get_op(op)
    args, leaves = [], []
    for slot in impl.in_slots:
        v = inputs.get(slot.name)
        if v is None:
            args.append([] if slot.variadic else None)
        elif slot.variadic:
            args.append([_tensor(a, device) for a in v])
        else:
            t = _tensor(v, device)
            if slot.name in grads:
                t.requires_grad_()
                leaves.append(t)
            args.append(t)
    with torch.enable_grad():
        outs = impl.fn(OpContext(dict(attrs), 0, True, 0, device), *args)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        flat = [o for out in outs
                for o in (out if isinstance(out, list) else [out])]
        if leaves:
            cot = torch.from_numpy(np.random.RandomState(1).uniform(
                0.5, 1.5, tuple(flat[0].shape))).to(device)
            flat += list(torch.autograd.grad((flat[0] * cot).sum(), leaves))
    return [o.detach().cpu() for o in flat]


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_on_the_card_matches_the_cpu(cuda, name):
    exact = CASES[name][4]
    got, want = _run(name, "cuda"), _run(name, "cpu")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, i)
        if not w.is_floating_point():
            assert torch.equal(g, w), (name, i)
            continue
        if i in exact:
            col = exact[i]
            assert torch.equal(g if col is None else g[..., col],
                               w if col is None else w[..., col]), (name, i)
        scale = max(float(w.abs().max()), 1e-300)
        assert float((g - w).abs().max()) <= TOL * scale, (name, i)


def test_every_detection_and_vision_op_has_a_case():
    import importlib

    from paddle_tpu_torch.core import registry
    registry.registered_ops()
    mods = {importlib.import_module(f"paddle_tpu_torch.ops.{m}")
            for m in ("detection", "detection_train", "vision")}
    ops = {op for op in registry.registered_ops()
           if importlib.import_module(get_op(op).fn.__module__) in mods}
    assert {c[0] for c in CASES.values()} == ops - {"spectral_norm"}


def _tiny_yolo(device, state=None):
    from paddle_tpu_torch.models.yolov3 import YOLOv3, YoloConfig
    nn.seed(0)
    m = YOLOv3(YoloConfig.tiny(), device=device).double()
    if state is not None:
        m.load_state_dict(state)
    return m


def test_tiny_yolov3_step_and_predict_on_the_card(cuda):
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, 64, 64)
    gt = np.zeros((2, 5, 4))
    gt[:, :3, :2] = rng.uniform(0.2, 0.8, (2, 3, 2))
    gt[:, :3, 2:] = rng.uniform(0.05, 0.5, (2, 3, 2))
    label = rng.randint(0, 4, (2, 5)).astype(np.int32)
    state = _tiny_yolo("cpu").state_dict()
    res = {}
    for dev in ("cuda", "cpu"):
        m = _tiny_yolo(dev, state)
        loss = m.loss(*(_tensor(a, dev) for a in (x, gt, label)))
        loss.backward()
        grads = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
        m.eval()
        with torch.no_grad():
            pred = m.predict(_tensor(x, dev),
                             torch.full((2, 2), 64, dtype=torch.int32,
                                        device=dev)).cpu()
        res[dev] = (float(loss.detach()), grads, pred)
    (lc, gc, pc), (lh, gh, ph) = res["cuda"], res["cpu"]
    assert abs(lc - lh) <= 1e-12 * abs(lh)
    top = max(float(g.abs().max()) for g in gh.values())
    for k, want in gh.items():
        scale = max(float(want.abs().max()), 1e-6 * top)
        assert float((gc[k] - want).abs().max()) <= TOL * scale, k
    assert pc.shape == (2, 100, 6) and bool((ph[..., 0] >= 0).any())
    assert torch.equal(pc[..., 0], ph[..., 0])
    assert float((pc - ph).abs().max()) <= TOL * float(ph.abs().max())
