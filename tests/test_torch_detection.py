"""The detection slice in the port against the JAX package, on the CPU.

* The hand-written op tests of tests/test_ops_detection{,2,3}.py (NMS,
  bipartite matching, roi_pool, density_prior_box, the proposals, the
  FPN routing, target assignment, detection_map, ssd_loss,
  yolov3_loss) rebuilt as cases on the same kind of inputs (and
  test_ops_detection.py's own assertions on the port's outputs) and run by
  `test_torch_ops_corpus.check_case`: the port's op against the numpy
  oracle where the JAX test has one and against the JAX op on the same
  inputs (the case's tolerance, 1e-5 unless stated), gradients against
  `jax.vjp` (rtol 1e-4, floor 1e-6 of the largest). Cases with exact
  ties (masked NMS scores, equal match distances) check the tie order.
* The sampling ops: with `use_random=False` equal to the JAX op (both
  draw the JAX package's fixed PRNGKey(0) keys); with `use_random=True`
  (the port's own generator) the contract: the counts, the eligibility
  of every pick, foregrounds first, and picks uniform over the eligible
  positions (each position's count over 400 seeds within 5 sigma of
  its binomial mean).
* Static programs built by both packages' builders, run by both
  Executors on the same feeds: the detection layers, the Faster R-CNN
  target pipeline (use_random=False), RetinaNet and mask labels, the
  SSD post-process, and the SSD training program of
  tests/test_detection_e2e.py (B=2, 64^2, multi_box_head -> ssd_loss,
  Adam 8e-3): 3 steps, each from the JAX run's state, loss within rtol
  1e-5 and every gradient within 1e-4 of its max (floor 1e-6 of the
  largest).
* An SSD inference program with detection_output saved by one
  package's save_inference_model and served by the other's Predictor:
  classes and rows equal, values within 1e-5 of the max.
* DetectionMAP (utils.metrics and evaluator) against the JAX classes,
  and the mask_util copy against the JAX module.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import test_ops_detection2 as jdet2
from op_test import OpCase
from paddle_tpu import evaluator as jevaluator
from paddle_tpu.core import ir as jir
from paddle_tpu.utils import mask_util as jmask
from paddle_tpu.utils import metrics as jmetrics
from paddle_tpu_torch import evaluator as tevaluator
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.ops import detection_train as tdt
from paddle_tpu_torch.utils import mask_util as tmask
from paddle_tpu_torch.utils import metrics as tmetrics
from paddle_tpu_torch.weights import scope_from_jax
from test_torch_ops_corpus import check_case

SIDES = {"jax": (jir, pt.static, pt.optimizer),
         "port": (tir, tstatic, topt)}
R = np.random.RandomState(151)


def _f(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, size=shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


# ---------------------------------------------------------- op cases
def _anchors16():
    return np.array([[x * 8, y * 8, x * 8 + 15, y * 8 + 15]
                     for y in range(4) for x in range(4)], np.float32)


def _proposal_inputs():
    h = w = 4
    a = 3
    anchors = np.zeros((h, w, a, 4), np.float32)
    for i in range(h):
        for j in range(w):
            for k in range(a):
                cx, cy, sz = j * 8 + 4, i * 8 + 4, 6 + 4 * k
                anchors[i, j, k] = [cx - sz / 2, cy - sz / 2,
                                    cx + sz / 2, cy + sz / 2]
    return {"Scores": R.uniform(0, 1, (2, a, h, w)).astype(np.float32),
            "BboxDeltas": (0.1 * R.randn(2, 4 * a, h, w)).astype(np.float32),
            "ImInfo": np.array([[32, 32, 1.0], [28, 30, 1.5]], np.float32),
            "Anchors": anchors,
            "Variances": np.full((h, w, a, 4), 0.1, np.float32)}


def _ssd_inputs(n=2, p=6, c=3, g=3):
    priors = np.concatenate([R.uniform(0, 0.5, (p, 2)),
                             R.uniform(0.55, 1.0, (p, 2))], 1)
    gt = np.concatenate([R.uniform(0, 0.5, (n, g, 2)),
                         R.uniform(0.55, 1.0, (n, g, 2))], 2)
    gt[:, :2] = priors[None, :2] + 0.01      # clear matches
    return {"Location": (0.1 * R.randn(n, p, 4)).astype(np.float32),
            "Confidence": _f(n, p, c),
            "GtBox": gt.astype(np.float32),
            "GtLabel": R.randint(1, c, (n, g, 1)).astype(np.int64),
            "PriorBox": priors.astype(np.float32),
            "GtCount": np.array([3, 1], np.int32)}


def _yolo_case():
    rng = np.random.RandomState(3)
    c, m, h, w, b, n = 3, 2, 4, 4, 3, 2
    anchors, mask = [10, 14, 23, 27, 37, 58], [0, 1]
    x = (0.5 * rng.randn(n, m * (5 + c), h, w)).astype(np.float32)
    gt = rng.uniform(0.2, 0.8, (n, b, 4)).astype(np.float32)
    gt[:, :, 2:] *= 0.3
    gt[1, 2] = 0                        # a padding row
    gt[0, 1, :2] = gt[0, 0, :2]         # two gts in one cell
    lbl = rng.randint(0, c, (n, b)).astype(np.int32)
    sc = rng.uniform(0.5, 1.0, (n, b)).astype(np.float32)
    expected = jdet2._yolo_loss_np(x, gt, lbl, sc, anchors, mask, c, 0.7,
                                   32, True)
    return OpCase(
        "yolov3_loss", {"X": x, "GTBox": gt, "GTLabel": lbl, "GTScore": sc},
        attrs={"anchors": anchors, "anchor_mask": mask, "class_num": c,
               "ignore_thresh": 0.7, "downsample_ratio": 32,
               "use_label_smooth": True},
        oracle=lambda X, GTBox, GTLabel, GTScore, attrs:
            (expected.astype(np.float32), None, None),
        grad_inputs=["X"], grad_outputs=["Loss"], atol=1e-4, rtol=1e-4,
        name="yolov3_loss_vs_numpy")


def _nms_ties():
    """Per-class boxes, many equal scores (zeros after the threshold and
    exact repeats), background 0."""
    boxes = np.concatenate([R.uniform(0, 0.5, (2, 12, 3, 2)),
                            R.uniform(0.5, 1.0, (2, 12, 3, 2))], 3)
    scores = np.round(R.uniform(0, 1, (2, 3, 12)), 1)
    return OpCase("multiclass_nms", {"BBoxes": boxes.astype(np.float32),
                                     "Scores": scores.astype(np.float32)},
                  attrs={"score_threshold": 0.25, "nms_threshold": 0.4,
                         "nms_top_k": 8, "keep_top_k": 20,
                         "background_label": 0},
                  check_grad=False, name="multiclass_nms_ties")


def _det_map_inputs():
    det = np.array([[[0, 0.9, 0, 0, 10, 10], [1, 0.8, 20, 20, 30, 30],
                     [0, 0.7, 50, 50, 60, 60], [1, 0.8, 19, 19, 31, 31],
                     [-1, 0, 0, 0, 0, 0]],
                    [[1, 0.6, 5, 5, 15, 15], [2, 0.95, 0, 0, 8, 8],
                     [2, 0.3, 40, 40, 50, 50], [-1, 0, 0, 0, 0, 0],
                     [-1, 0, 0, 0, 0, 0]]], np.float32)
    gt = np.array([[[0, 0, 1, 1, 9, 9], [1, 1, 21, 21, 29, 29],
                    [-1, 0, 0, 0, 0, 0]],
                   [[1, 0, 4, 4, 16, 16], [2, 0, 0, 0, 9, 9],
                    [2, 1, 41, 41, 49, 49]]], np.float32)
    return det, gt


def _rpn_attrs(use_random):
    return {"rpn_batch_size_per_im": 8, "rpn_positive_overlap": 0.5,
            "rpn_negative_overlap": 0.2, "rpn_straddle_thresh": -1.0,
            "use_random": use_random}


def _gpl_attrs(use_random):
    return {"batch_size_per_im": 8, "fg_fraction": 0.5, "fg_thresh": 0.5,
            "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 4,
            "use_random": use_random}


_GT2 = np.array([[6, 6, 24, 24], [0, 0, 0, 0]], np.float32)
_QUADS = np.array([[0, 1, 5, 6, 1, 1, 1, 5, 6],
                   [1, 0.5, 4.5, 5, 0, 0.5, 1, 4, 4.5]], np.float32)

CASES = [
    OpCase("bipartite_match", {"DistMat": R.uniform(0, 1, (4, 6))
                               .astype(np.float32)},
           oracle=lambda DistMat, attrs: jdet2._bipartite_np(DistMat),
           check_grad=False, name="bipartite_match_vs_numpy"),
    OpCase("bipartite_match", {"DistMat": R.uniform(0, 1, (3, 7))
                               .astype(np.float32)},
           attrs={"match_type": "per_prediction", "dist_threshold": 0.4},
           oracle=lambda DistMat, attrs:
               jdet2._bipartite_np(DistMat, "per_prediction", 0.4),
           check_grad=False, name="bipartite_match_per_prediction"),
    OpCase("bipartite_match",
           {"DistMat": np.round(R.uniform(0, 1, (2, 4, 5)), 1)
            .astype(np.float32)},
           check_grad=False, name="bipartite_match_batched_ties"),
    OpCase("roi_pool", {"X": _f(1, 2, 6, 6),
                        "ROIs": np.array([[0, 0, 0, 3, 3], [0, 2, 2, 5, 5]],
                                         np.float32)},
           attrs={"pooled_height": 2, "pooled_width": 2,
                  "spatial_scale": 1.0},
           oracle=lambda X, ROIs, attrs:
               (jdet2._roi_pool_np(X, ROIs, 2, 2, 1.0), None),
           check_grad=False, name="roi_pool_vs_numpy"),
    OpCase("density_prior_box", {"Input": _f(1, 4, 2, 2),
                                 "Image": _f(1, 3, 16, 16)},
           attrs={"fixed_sizes": [4.0], "fixed_ratios": [1.0],
                  "densities": [2], "clip": False},
           check_grad=False, name="density_prior_box"),
    OpCase("generate_proposals", _proposal_inputs(),
           attrs={"pre_nms_topN": 24, "post_nms_topN": 8,
                  "nms_thresh": 0.6, "min_size": 2.0},
           check_grad=False, name="generate_proposals"),
    OpCase("ssd_loss", _ssd_inputs(), grad_inputs=["Location",
                                                   "Confidence"],
           name="ssd_loss_padded_gts"),
    _yolo_case(),
    _nms_ties(),
    OpCase("target_assign", {"X": _f(1, 3, 2),
                             "MatchIndices": np.array([[1, -1, -1]],
                                                      np.int32),
                             "NegIndices": np.array([[0, 1, 0]], np.int32)},
           attrs={"mismatch_value": 9}, check_grad=False,
           name="target_assign_semantics"),
    OpCase("distribute_fpn_proposals",
           {"FpnRois": np.array([[0, 0, 10, 10], [0, 0, 100, 100],
                                 [0, 0, 300, 300], [0, 0, 60, 60]],
                                np.float32)},
           attrs={"min_level": 2, "max_level": 5, "refer_level": 4,
                  "refer_scale": 224},
           variadic_out={"MultiFpnRois": 4}, check_grad=False,
           name="distribute_fpn_proposals"),
    OpCase("collect_fpn_proposals",
           {"MultiLevelRois": [_f(3, 4), _f(4, 4)],
            "MultiLevelScores": [np.array([[0.5], [0.1], [0.9]], np.float32),
                                 np.array([[0.5], [0.7], [0.2], [0.1]],
                                          np.float32)]},
           attrs={"post_nms_topN": 9}, check_grad=False,
           name="collect_fpn_proposals"),
    OpCase("box_decoder_and_assign",
           {"PriorBox": np.array([[0, 0, 10, 10], [5, 5, 30, 20]],
                                 np.float32),
            "PriorBoxVar": np.full((2, 4), 0.1, np.float32),
            "TargetBox": _f(2, 12), "BoxScore": _f(2, 3, lo=0, hi=1)},
           attrs={"box_clip": 4.135}, grad_inputs=["TargetBox"],
           name="box_decoder_and_assign"),
    OpCase("roi_perspective_transform",
           {"X": _f(2, 2, 8, 8), "ROIs": _QUADS},
           attrs={"transformed_height": 3, "transformed_width": 4,
                  "spatial_scale": 1.0},
           out_slots=["Out", "Mask", "TransformMatrix"], atol=1e-4,
           rtol=1e-4, grad_inputs=["X"], grad_outputs=["Out"],
           name="roi_perspective_transform"),
    OpCase("detection_map", dict(zip(("DetectRes", "Label"),
                                     _det_map_inputs())),
           attrs={"class_num": 3, "overlap_threshold": 0.5},
           check_grad=False, name="detection_map_integral"),
    OpCase("detection_map", dict(zip(("DetectRes", "Label"),
                                     _det_map_inputs())),
           attrs={"class_num": 3, "overlap_threshold": 0.5,
                  "ap_type": "11point", "evaluate_difficult": False},
           check_grad=False, name="detection_map_11point"),
    OpCase("rpn_target_assign",
           {"Anchor": _anchors16(), "GtBoxes": _GT2,
            "ImInfo": np.array([[32, 32, 1]], np.float32)},
           attrs=_rpn_attrs(False), check_grad=False,
           name="rpn_target_assign_fixed_keys"),
    OpCase("retinanet_target_assign",
           {"Anchor": _anchors16(), "GtBoxes": _GT2,
            "GtLabels": np.array([[2], [0]], np.int64),
            "ImInfo": np.array([[32, 32, 1]], np.float32)},
           check_grad=False, name="retinanet_target_assign"),
    OpCase("generate_proposal_labels",
           {"RpnRois": _anchors16(), "GtClasses": np.array([[2], [0]],
                                                           np.int64),
            "GtBoxes": _GT2, "ImInfo": np.array([[32, 32, 1]], np.float32)},
           attrs=_gpl_attrs(False), check_grad=False,
           name="generate_proposal_labels_fixed_keys"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_op_against_jax(case):
    check_case(case)


def test_ssd_loss_behaviour():
    """tests/test_ops_detection2.py::test_ssd_loss_behaviour's cases:
    perfect predictions near zero, corrupt ones higher, gradients."""
    p_boxes = np.array([[0.0, 0.0, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
                        [0.1, 0.6, 0.4, 0.9]], np.float32)
    gt = np.array([[[0.0, 0.0, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]],
                  np.float32)
    gt_label = np.array([[[1], [2]]], np.int64)
    conf = np.full((1, 3, 3), -8.0, np.float32)
    conf[0, 0, 1] = conf[0, 1, 2] = conf[0, 2, 0] = 8.0
    ins = {"Location": np.zeros((1, 3, 4), np.float32), "GtBox": gt,
           "GtLabel": gt_label, "PriorBox": p_boxes}
    impl = tregistry.get_op("ssd_loss")
    losses = []
    for c in (conf, -conf):
        ctx = tregistry.OpContext({}, None, True, 0, "cpu")
        losses.append(float(impl.fn(ctx, *[
            torch.from_numpy(v) if v is not None else None for v in (
                ins["Location"], c, gt, gt_label, p_boxes, None, None)])))
        check_case(OpCase("ssd_loss", dict(ins, Confidence=c),
                          check_grad=False))
    assert losses[0] < 0.1 and losses[1] > losses[0] + 1.0
    check_case(OpCase(
        "ssd_loss", dict(ins, Location=(0.1 * R.randn(1, 3, 4)).astype(
            np.float32), Confidence=_f(1, 3, 3)),
        grad_inputs=["Location", "Confidence"], grad_outputs=["Loss"]))


def _port_outputs(case):
    impl = tregistry.get_op(case.op)
    ctx = tregistry.OpContext(dict(case.attrs), 0, True, 0, "cpu")
    args = [None if s.name not in case.inputs else torch.from_numpy(
        np.asarray(case.inputs[s.name])) for s in impl.in_slots]
    out = impl.fn(ctx, *args)
    return [o.numpy() for o in (out if isinstance(out, (tuple, list))
                                else [out])]


def test_handwritten_detection_checks():
    """tests/test_ops_detection.py's hand-written assertions on the
    port's outputs: the NMS scenario's rows, prior_box's shape and
    range, yolo_box's shapes, roi_align over a constant region, the
    first anchor."""
    import test_ops_detection as jdet
    cases = {c.op: c for c in jdet.CASES}
    (out,) = _port_outputs(cases["multiclass_nms"])
    np.testing.assert_allclose(out[0, 0], [0, 0.9, 0, 0, 4, 4], atol=1e-5)
    np.testing.assert_allclose(out[0, 1], [0, 0.7, 10, 10, 14, 14],
                               atol=1e-5)
    assert out[0, 2, 1] == 0.0 and out[0, 2, 0] == -1.0
    boxes, var = _port_outputs(cases["prior_box"])
    assert boxes.shape == (2, 2, 1, 4)
    assert (boxes >= 0).all() and (boxes <= 1).all()
    np.testing.assert_allclose(var[0, 0, 0], [0.1, 0.1, 0.2, 0.2])
    boxes, scores = _port_outputs(cases["yolo_box"])
    assert boxes.shape == (1, 8, 4) and scores.shape == (1, 8, 2)
    (pooled,) = _port_outputs(OpCase(
        "roi_align", {"X": np.full((1, 1, 4, 4), 3.0, np.float32),
                      "ROIs": np.array([[0, 0.0, 0.0, 4.0, 4.0]],
                                       np.float32)},
        attrs={"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0,
               "sampling_ratio": 2}))
    np.testing.assert_allclose(pooled, np.full((1, 1, 2, 2), 3.0),
                               atol=1e-5)
    anchors, _ = _port_outputs(cases["anchor_generator"])
    assert anchors.shape == (2, 3, 2, 4)
    np.testing.assert_allclose(anchors[0, 0, 0], [-8, -8, 24, 24],
                               atol=1e-4)


# ------------------------------------------------------------ sampling
def _iou_np(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter,
                              1e-10)


def _port_op(name, inputs, attrs, seed):
    impl = tregistry.get_op(name)
    ctx = tregistry.OpContext(attrs, seed, True, 0, "cpu")
    args = [None if s.name not in inputs else torch.from_numpy(
        inputs[s.name]) for s in impl.in_slots]
    return [o.numpy() for o in impl.fn(ctx, *args)]


def _uniform_within(counts, trials, k_per_trial, n_eligible, sigmas=5.0):
    p = k_per_trial / n_eligible
    mean, sd = trials * p, np.sqrt(trials * p * (1 - p))
    assert np.all(np.abs(counts - mean) <= sigmas * sd + 1e-9), (
        counts, mean, sd)


def test_rpn_target_assign_random_contract():
    anchors = _anchors16()
    ins = {"Anchor": anchors, "GtBoxes": _GT2,
           "ImInfo": np.array([[32, 32, 1]], np.float32)}
    ov = _iou_np(anchors, _GT2[:1])[:, 0]
    fg = (ov >= 0.5) | (ov == ov.max())
    bg = ~fg & (ov < 0.2)
    batch, fg_max = 8, 4
    n_fg = min(fg.sum(), fg_max)
    n_bg = min(bg.sum(), batch - n_fg)
    counts = np.zeros(len(anchors))
    trials = 400
    for seed in range(trials):
        loc, score, _, label, _ = _port_op("rpn_target_assign", ins,
                                           _rpn_attrs(True), seed)
        label = label.ravel()
        assert (loc >= 0).sum() == n_fg and fg[loc[loc >= 0]].all()
        assert (label == 1).sum() == n_fg and (label == 0).sum() == n_bg
        assert (label[:n_fg] == 1).all()            # foregrounds first
        picked = score[label == 0]
        assert bg[picked].all() and len(set(picked)) == n_bg
        counts[picked] += 1
    _uniform_within(counts[bg], trials, n_bg, bg.sum())
    assert counts[~bg].sum() == 0


def test_generate_proposal_labels_random_contract():
    rois = _anchors16()
    ins = {"RpnRois": rois, "GtClasses": np.array([[2], [0]], np.int64),
           "GtBoxes": _GT2, "ImInfo": np.array([[32, 32, 1]], np.float32)}
    allr = np.concatenate([rois, _GT2])
    valid = ((allr[:, 2] - allr[:, 0]) > 0) & ((allr[:, 3] - allr[:, 1])
                                               > 0)
    ov = _iou_np(allr, _GT2[:1])[:, 0]
    fg = valid & (ov >= 0.5)
    bg = valid & (ov < 0.5)
    n_fg = min(fg.sum(), 4)
    n_bg = min(bg.sum(), 8 - n_fg)
    hits = np.zeros(len(allr))
    trials = 400
    for seed in range(trials):
        out_rois, labels, tgt, inside, _ = _port_op(
            "generate_proposal_labels", ins, _gpl_attrs(True), seed)
        labels = labels.ravel()
        assert (labels == 2).sum() == n_fg and (labels == 0).sum() == n_bg
        assert (labels[:n_fg] == 2).all()
        assert inside.reshape(8, 4, 4)[:n_fg, 2].sum() == 4 * n_fg
        for r in out_rois[labels == 0]:
            i = np.flatnonzero((allr == r).all(1))
            assert bg[i].any()
            hits[i[0]] += 1
    _uniform_within(hits[bg], trials, n_bg, bg.sum())


def test_fixed_keys_are_jax_key0_draws():
    import jax
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    for which, key in enumerate((k1, k2)):
        for n in (5, 18, 300):
            np.testing.assert_array_equal(
                tdt.jax_key0_uniform(which, n),
                np.asarray(jax.random.uniform(key, (n,))))


# ------------------------------------------------------ static programs
def _build(side, fn):
    ir, static, opt = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        fetch = fn(static, opt)
    return main, startup, fetch


def _run_both(fn, feed, train=False):
    """Build with both packages, run the JAX startup, carry its
    persistables into the port, run both mains; -> (JAX outs, port
    outs, JAX main, port main)."""
    jmain, jstart, jfetch = _build("jax", fn)
    tmain, tstart, tfetch = _build("port", fn)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    exe = pt.Executor()
    exe.run(jstart)
    scope = pt.global_scope()
    state = {v.name: scope.find_np(v.name) for v in jmain.list_vars()
             if v.persistable and scope.has(v.name)}
    tscope = scope_from_jax(state, Scope(), "cpu")
    tout = TExecutor("cpu").run(tmain, feed=feed, fetch_list=tfetch,
                                scope=tscope)
    jout = exe.run(jmain, feed=feed, fetch_list=jfetch)
    return [np.asarray(o) for o in jout], [np.asarray(o) for o in tout]


def _assert_same(jout, tout, tol=1e-5):
    for j, t in zip(jout, tout):
        assert j.shape == t.shape
        np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64),
                                   rtol=tol, atol=tol * max(
                                       np.abs(j).max(), 1e-30))


def test_static_detection_layers():
    def fn(static, _):
        x = static.data("feat", [1, 8, 2, 2], append_batch_size=False)
        img = static.data("img", [1, 3, 16, 16], append_batch_size=False)
        boxes, _ = static.detection.prior_box(x, img, min_sizes=[4.0])
        dboxes, _ = static.detection.density_prior_box(
            x, img, densities=[2], fixed_sizes=[4.0], fixed_ratios=[1.0])
        anchors, _ = static.anchor_generator(x, [8.0, 16.0], [0.5, 1.0])
        a = static.data("ba", [3, 4], append_batch_size=False)
        b = static.data("bb", [2, 4], append_batch_size=False)
        iou = static.detection.iou_similarity(a, b)
        mi, md = static.detection.bipartite_match(iou)
        enc = static.box_coder(a, None, static.scale(a, 1.5),
                               box_normalized=False)
        return [boxes, dboxes, anchors, iou, mi, md, enc]

    av = np.array([[0, 0, 2, 2], [3, 3, 5, 5], [0, 3, 2, 5]], np.float32)
    bv = np.array([[0, 0, 2, 2], [3, 3, 5, 5]], np.float32)
    jout, tout = _run_both(fn, {"feat": _f(1, 8, 2, 2),
                                "img": _f(1, 3, 16, 16), "ba": av, "bb": bv})
    _assert_same(jout, tout)
    assert tout[0].shape == (2, 2, 1, 4) and tout[1].shape == (2, 2, 4, 4)
    np.testing.assert_array_equal(tout[4], [0, 1])


def test_rpn_and_proposal_label_pipeline():
    def fn(static, _):
        anchor = static.data("anchor", [16, 4], append_batch_size=False)
        gtb = static.data("gtb", [2, 4], append_batch_size=False)
        gcls = static.data("gcls", [2, 1], "int64", append_batch_size=False)
        iminfo = static.data("iminfo", [1, 3], append_batch_size=False)
        bp = static.data("bp", [16, 4], append_batch_size=False)
        cl = static.data("cl", [16, 1], append_batch_size=False)
        score, loc, lab, tbox, _ = static.rpn_target_assign(
            bp, cl, anchor, None, gtb, None, iminfo,
            rpn_batch_size_per_im=8, rpn_positive_overlap=0.5,
            rpn_negative_overlap=0.2, rpn_straddle_thresh=-1.0,
            use_random=False)
        rois, labels, btgt, binw, _ = static.generate_proposal_labels(
            anchor, gcls, None, gtb, iminfo, batch_size_per_im=8,
            fg_fraction=0.5, fg_thresh=0.5, bg_thresh_hi=0.5,
            bg_thresh_lo=0.0, class_nums=4, use_random=False)
        return [score, loc, lab, tbox, rois, labels, btgt, binw]

    jout, tout = _run_both(fn, {
        "anchor": _anchors16(), "gtb": _GT2,
        "gcls": np.array([[2], [0]], np.int64),
        "iminfo": np.array([[32, 32, 1]], np.float32),
        "bp": R.randn(16, 4).astype(np.float32),
        "cl": R.randn(16, 1).astype(np.float32)})
    _assert_same(jout, tout)
    lab = tout[2].ravel()
    assert (lab == 1).sum() >= 1 and (lab == 0).sum() >= 1
    assert (tout[5].ravel() == 2).sum() >= 1


def test_retinanet_and_mask_labels():
    def fn(static, _):
        anchor = static.data("r_anchor", [16, 4], append_batch_size=False)
        gtb = static.data("r_gtb", [2, 4], append_batch_size=False)
        glab = static.data("r_glab", [2, 1], "int64",
                           append_batch_size=False)
        iminfo = static.data("r_iminfo", [1, 3], append_batch_size=False)
        bp = static.data("r_bp", [16, 4], append_batch_size=False)
        cl = static.data("r_cl", [16, 3], append_batch_size=False)
        outs = static.retinanet_target_assign(
            bp, cl, anchor, None, gtb, glab, None, iminfo, num_classes=3,
            positive_overlap=0.5, negative_overlap=0.4)
        segs = static.data("r_segs", [2, 32, 32], append_batch_size=False)
        rois = static.data("r_rois", [3, 4], append_batch_size=False)
        li = static.data("r_li", [3, 1], "int32", append_batch_size=False)
        masks = static.generate_mask_labels(iminfo, glab, None, segs, rois,
                                            li, num_classes=3, resolution=4)
        return list(outs) + list(masks)

    segs = jmask.gt_segms_from_polys(
        [[[6, 6, 25, 6, 25, 25, 6, 25]], [[0, 0, 2, 0, 2, 2]]], 32, 32)
    jout, tout = _run_both(fn, {
        "r_anchor": _anchors16(), "r_gtb": _GT2,
        "r_glab": np.array([[2], [0]], np.int64),
        "r_iminfo": np.array([[32, 32, 1]], np.float32),
        "r_bp": R.randn(16, 4).astype(np.float32),
        "r_cl": R.randn(16, 3).astype(np.float32),
        "r_segs": segs.astype(np.float32),
        "r_rois": np.array([[5, 5, 23, 23], [0, 0, 7, 7], [26, 26, 31, 31]],
                           np.float32),
        "r_li": np.array([[2], [0], [0]], np.int32)})
    _assert_same(jout, tout)
    lab = tout[2].ravel()
    assert int(tout[5].ravel()[0]) == (lab == 2).sum()
    assert tout[8].reshape(3, 3, 16)[0, 2].sum() > 0


def test_detection_output_and_retinanet_output():
    def fn(static, _):
        prior = static.data("pb", [4, 4], append_batch_size=False)
        pvar = static.data("pv", [4, 4], append_batch_size=False)
        loc = static.data("loc", [1, 4, 4], append_batch_size=False)
        sc = static.data("sc", [1, 4, 3], append_batch_size=False)
        out = static.detection_output(loc, sc, prior, pvar, keep_top_k=4,
                                      score_threshold=0.4,
                                      nms_threshold=0.4)
        iminfo = static.data("ii", [1, 3], append_batch_size=False)
        ret = static.retinanet_detection_output(
            [loc], [sc], [static.scale(prior, 40.0)], iminfo,
            keep_top_k=6, score_threshold=0.04)
        return [out, ret]

    scores = np.full((1, 4, 3), 0.05, np.float32)
    scores[0, 1, 2] = 0.95
    prior = np.array([[0.0, 0.0, 0.2, 0.2], [0.3, 0.3, 0.6, 0.6],
                      [0.1, 0.5, 0.4, 0.9], [0.6, 0.1, 0.9, 0.4]],
                     np.float32)
    jout, tout = _run_both(fn, {
        "pb": prior, "pv": np.full((4, 4), 0.1, np.float32),
        "loc": (0.1 * R.randn(1, 4, 4)).astype(np.float32), "sc": scores,
        "ii": np.array([[40, 40, 1]], np.float32)})
    _assert_same(jout, tout)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t[..., 0], j[..., 0])
    kept = tout[0][0][tout[0][0, :, 0] >= 0]
    assert len(kept) == 1 and kept[0, 0] == 2


def _ssd_program(static, opt, train=True):
    b = 2
    img = static.data("s_img", [b, 3, 64, 64], append_batch_size=False)
    gtb = static.data("s_gtb", [b, 2, 4], append_batch_size=False)
    gtl = static.data("s_gtl", [b, 2, 1], "int64", append_batch_size=False)
    f1 = static.conv2d(img, num_filters=8, filter_size=3, padding=1,
                       stride=8, act="relu")
    f2 = static.conv2d(f1, num_filters=8, filter_size=3, padding=1,
                       stride=2, act="relu")
    f3 = static.conv2d(f2, num_filters=8, filter_size=3, padding=1,
                       stride=2, act="relu")
    locs, confs, box, var = static.multi_box_head(
        [f1, f2, f3], img, base_size=64, num_classes=3,
        aspect_ratios=[[2.0], [2.0], [2.0]], min_ratio=20, max_ratio=90,
        offset=0.5, flip=True)
    if not train:
        return static.detection_output(locs, confs, box, var, keep_top_k=5,
                                       score_threshold=0.01)
    loss = static.reduce_mean(static.ssd_loss(locs, confs, gtb, gtl, box,
                                              var))
    opt.Adam(learning_rate=8e-3).minimize(loss)
    return loss


def _ssd_feed(rs, b=2):
    """tests/test_detection_e2e.py's batch: one bright box an image."""
    x = rs.randn(b, 3, 64, 64).astype(np.float32) * 0.05
    box = np.zeros((b, 2, 4), np.float32)
    lbl = np.zeros((b, 2, 1), np.int64)
    for i in range(b):
        cls = 1 + rs.randint(0, 2)
        box[i, 0] = [0.25, 0.25, 0.55, 0.55]
        lbl[i, 0] = cls
        x[i, cls % 3, 16:36, 16:36] += 1.0
    return {"s_img": x, "s_gtb": box, "s_gtl": lbl}


def test_ssd_program_trains_like_jax():
    jmain, jstart, jloss = _build("jax", _ssd_program)
    tmain, _, tloss = _build("port", _ssd_program)
    # the same program op for op, every var of the same shape (the JAX
    # package infers the prior boxes under x64, so its VarDescs declare
    # float64 where both packages run float32)
    jd, td = jmain.to_dict(), tmain.to_dict()
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    assert {k: v["shape"] for k, v in td["blocks"][0]["vars"].items()} == \
        {k: v["shape"] for k, v in jd["blocks"][0]["vars"].items()}
    params = [v.name for v in tmain.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    exe = pt.Executor()
    exe.run(jstart)
    texe = TExecutor("cpu")
    scope = pt.global_scope()
    rs = np.random.RandomState(21)
    for _ in range(3):
        feed = _ssd_feed(rs)
        state = {v.name: scope.find_np(v.name) for v in jmain.list_vars()
                 if v.persistable and scope.has(v.name)}
        tout = texe.run(tmain, feed=feed, fetch_list=[tloss] + grads,
                        scope=scope_from_jax(state, Scope(), "cpu"))
        jout = exe.run(jmain, feed=feed, fetch_list=[jloss] + grads)
        np.testing.assert_allclose(float(tout[0]), float(jout[0]),
                                   rtol=1e-5)
        top = max(float(np.abs(g).max()) for g in jout[1:])
        for name, t, j in zip(params, tout[1:], jout[1:]):
            scale = max(float(np.abs(j).max()), 1e-6 * top)
            assert np.abs(np.asarray(t) - j).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_ssd_inference_model_crosses_packages(saver, tmp_path):
    d = str(tmp_path / "ssd")
    main, startup, out = _build(saver, lambda s, o: _ssd_program(s, o,
                                                                 False))
    feed = {"s_img": _ssd_feed(np.random.RandomState(5))["s_img"]}
    if saver == "jax":
        exe = pt.Executor()
        exe.run(startup)
        pt.static.io.save_inference_model(d, ["s_img"], [out], exe,
                                          main_program=main)
    else:
        exe = TExecutor("cpu")
        exe.run(startup)
        tstatic.io.save_inference_model(d, ["s_img"], [out], exe,
                                        main_program=main)
    cfg = tinf.Config(d)
    cfg.disable_gpu()
    (got,) = tinf.create_predictor(cfg).run(feed)
    (want,) = pt.inference.create_predictor(pt.inference.Config(d)).run(feed)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 5, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert (want[..., 0] >= 0).any()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -------------------------------------------------- metrics, mask_util
def test_detection_map_metric_and_evaluator():
    det, gt = _det_map_inputs()
    for version in ("integral", "11point"):
        want = jmetrics.DetectionMAP(class_num=3, ap_version=version)
        got = tmetrics.DetectionMAP(class_num=3, ap_version=version,
                                    device="cpu")
        jev = jevaluator.DetectionMAP(class_num=3, ap_version=version)
        tev = tevaluator.DetectionMAP(class_num=3, ap_version=version,
                                      device="cpu")
        for i in range(2):      # two batches, the second one row shorter
            for m in (want, got, jev, tev):
                m.update(det[i:i + 1, :5 - i], gt[i:i + 1])
        assert got.eval() == pytest.approx(want.eval(), rel=1e-6)
        assert tev.eval() == pytest.approx(jev.eval(), rel=1e-6)
        assert 0.0 < got.eval() <= 1.0


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    preds = rng.rand(64, 2).astype(np.float32)
    labels = rng.randint(0, 2, 64)
    for cls in ("Accuracy", "Precision", "Recall", "Auc", "EditDistance",
                "ChunkEvaluator"):
        j, t = getattr(jmetrics, cls)(), getattr(tmetrics, cls)()
        for m in (j, t):
            if cls == "Accuracy":
                m.update(0.75, 4)
            elif cls in ("Precision", "Recall"):
                m.update(preds[:, 1], labels)
            elif cls == "Auc":
                m.update(preds, labels)
            elif cls == "EditDistance":
                m.update(np.array([0, 2, 1]), 3)
            else:
                m.update(5, 6, 4)
        assert t.eval() == j.eval(), cls
    comp = tmetrics.CompositeMetric()
    comp.add_metric(tmetrics.Precision())
    comp.add_metric(tmetrics.Recall())
    comp.update(preds[:, 1], labels)
    assert len(comp.eval()) == 2


def test_mask_util_matches_jax():
    sq = [2, 2, 6, 2, 6, 6, 2, 6]
    polys = [[sq], [[0, 0, 3, 0, 3, 3]], []]
    for fn, args in ((lambda m: m.poly2mask(sq, 8, 8), ()),
                     (lambda m: m.polys_to_mask([[0, 0, 2, 0, 2, 2, 0, 2],
                                                 [5, 5, 8, 5, 8, 8, 5, 8]],
                                                8, 8), ()),
                     (lambda m: m.poly2boxes(polys), ()),
                     (lambda m: m.polys_to_mask_wrt_box([sq], [2, 2, 6, 6],
                                                        4), ()),
                     (lambda m: m.gt_segms_from_polys([[sq]], 8, 8), ())):
        np.testing.assert_array_equal(fn(tmask), fn(jmask))
    exp = np.zeros((8, 8), np.uint8)
    exp[2:6, 2:6] = 1
    np.testing.assert_array_equal(tmask.poly2mask(sq, 8, 8), exp)
