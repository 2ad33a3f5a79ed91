"""Detection layers for the static-graph API.

Counterpart of paddle_tpu/static/detection.py (the reference's
python/paddle/fluid/layers/detection.py): thin builders over the
detection ops (ops/detection.py, ops/detection_train.py), every shape
static, the LoD outputs fixed-size padded tensors (see the op
docstrings). The builders emit the JAX package's programs op for op.
"""
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.static.common import (_simple, concat, gather,
                                             reshape, transpose)
from paddle_tpu_torch.static.helper import LayerHelper
from paddle_tpu_torch.static.nn import conv2d

__all__ = ["iou_similarity", "box_coder", "prior_box", "density_prior_box",
           "anchor_generator", "yolo_box", "multiclass_nms", "roi_align",
           "roi_pool", "bipartite_match", "generate_proposals", "ssd_loss",
           "yolov3_loss", "box_clip", "sigmoid_focal_loss", "target_assign",
           "box_decoder_and_assign", "polygon_box_transform",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "roi_perspective_transform", "detection_map",
           "rpn_target_assign", "retinanet_target_assign",
           "generate_proposal_labels", "generate_mask_labels",
           "detection_output", "multi_box_head",
           "retinanet_detection_output"]


# ops whose outputs training backprops through: losses and the ROI
# feature extractors (everything else — matchers, NMS, samplers — is
# genuinely non-differentiable selection and stays stop_gradient)
_GRAD_OPS = {"roi_align", "roi_pool", "ssd_loss", "yolov3_loss",
             "box_coder", "polygon_box_transform", "psroi_pool",
             "prroi_pool"}


def _det(op, ins, n_out=1, out_slots=None, attrs=None, dtypes=None):
    helper = LayerHelper(op)
    dtypes = dtypes or ["float32"] * n_out
    sg = op not in _GRAD_OPS
    outs = [helper.create_tmp(dtype=d, stop_gradient=sg) for d in dtypes]
    slots = out_slots or ["Out"]
    helper.append_op(op, ins, dict(zip(slots, outs)), attrs or {})
    return outs[0] if n_out == 1 else tuple(outs)


def iou_similarity(x, y, name=None):
    return _det("iou_similarity", {"X": x, "Y": y})


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    ins = {"PriorBox": prior_box, "TargetBox": target_box}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = prior_box_var
    return _det("box_coder", ins, out_slots=["OutputBox"],
                attrs={"code_type": code_type,
                       "box_normalized": box_normalized,
                       "axis": axis})


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    return _det("prior_box", {"Input": input, "Image": image}, n_out=2,
                out_slots=["Boxes", "Variances"],
                attrs={"min_sizes": list(min_sizes),
                       "max_sizes": list(max_sizes or []),
                       "aspect_ratios": list(aspect_ratios),
                       "variances": list(variance), "flip": flip,
                       "clip": clip, "step_w": steps[0], "step_h": steps[1],
                       "offset": offset})


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    boxes, var = _det(
        "density_prior_box", {"Input": input, "Image": image}, n_out=2,
        out_slots=["Boxes", "Variances"],
        attrs={"densities": list(densities),
               "fixed_sizes": list(fixed_sizes),
               "fixed_ratios": list(fixed_ratios),
               "variances": list(variance), "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    if flatten_to_2d:
        boxes = reshape(boxes, [-1, 4])
        var = reshape(var, [-1, 4])
    return boxes, var


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    return _det("anchor_generator", {"Input": input}, n_out=2,
                out_slots=["Anchors", "Variances"],
                attrs={"anchor_sizes": list(anchor_sizes),
                       "aspect_ratios": list(aspect_ratios),
                       "variances": list(variance),
                       "stride": list(stride), "offset": offset})


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    return _det("yolo_box", {"X": x, "ImgSize": img_size}, n_out=2,
                out_slots=["Boxes", "Scores"],
                attrs={"anchors": list(anchors), "class_num": class_num,
                       "conf_thresh": conf_thresh,
                       "downsample_ratio": downsample_ratio})


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    return _det("multiclass_nms", {"BBoxes": bboxes, "Scores": scores},
                attrs={"score_threshold": score_threshold,
                       "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                       "nms_threshold": nms_threshold,
                       "background_label": background_label,
                       "normalized": normalized})


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None,
              rois_num=None):
    ins = {"X": input, "ROIs": rois}
    if rois_num is not None:
        ins["RoisNum"] = rois_num
    return _det("roi_align", ins,
                attrs={"pooled_height": pooled_height,
                       "pooled_width": pooled_width,
                       "spatial_scale": spatial_scale,
                       "sampling_ratio": sampling_ratio})


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_num=None, name=None):
    ins = {"X": input, "ROIs": rois}
    if rois_num is not None:
        ins["RoisNum"] = rois_num
    out, _ = _det("roi_pool", ins, n_out=2, out_slots=["Out", "Argmax"],
                  attrs={"pooled_height": pooled_height,
                         "pooled_width": pooled_width,
                         "spatial_scale": spatial_scale},
                  dtypes=["float32", "int32"])
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    return _det("bipartite_match", {"DistMat": dist_matrix}, n_out=2,
                out_slots=["ColToRowMatchIndices", "ColToRowMatchDist"],
                attrs={"match_type": match_type,
                       "dist_threshold": dist_threshold},
                dtypes=["int32", "float32"])


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    return _det("generate_proposals",
                {"Scores": scores, "BboxDeltas": bbox_deltas,
                 "ImInfo": im_info, "Anchors": anchors,
                 "Variances": variances}, n_out=2,
                out_slots=["RpnRois", "RpnRoiProbs"],
                attrs={"pre_nms_topN": pre_nms_top_n,
                       "post_nms_topN": post_nms_top_n,
                       "nms_thresh": nms_thresh, "min_size": min_size})


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             gt_count=None, name=None):
    ins = {"Location": location, "Confidence": confidence, "GtBox": gt_box,
           "GtLabel": gt_label, "PriorBox": prior_box}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = prior_box_var
    if gt_count is not None:
        ins["GtCount"] = gt_count
    return _det("ssd_loss", ins, out_slots=["Loss"],
                attrs={"background_label": background_label,
                       "overlap_threshold": overlap_threshold,
                       "neg_pos_ratio": neg_pos_ratio, "neg_overlap": neg_overlap,
                       "loc_loss_weight": loc_loss_weight,
                       "conf_loss_weight": conf_loss_weight,
                       "match_type": match_type, "mining_type": mining_type,
                       "normalize": normalize})


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    ins = {"X": x, "GTBox": gt_box, "GTLabel": gt_label}
    if gt_score is not None:
        ins["GTScore"] = gt_score
    out, _, _ = _det("yolov3_loss", ins, n_out=3,
                     out_slots=["Loss", "ObjectnessMask", "GTMatchMask"],
                     attrs={"anchors": list(anchors),
                            "anchor_mask": list(anchor_mask),
                            "class_num": class_num,
                            "ignore_thresh": ignore_thresh,
                            "downsample_ratio": downsample_ratio,
                            "use_label_smooth": use_label_smooth},
                     dtypes=["float32", "float32", "int32"])
    return out


# ------------------------------------------------------------------
# the rest of the fluid.layers detection surface
def _det_grad(op, ins, n_out=1, out_slots=None, attrs=None):
    """Like _det but gradient-carrying (losses/decodes users backprop)."""
    helper = LayerHelper(op)
    outs = [helper.create_tmp(dtype="float32") for _ in range(n_out)]
    helper.append_op(op, ins, dict(zip(out_slots or ["Out"], outs)),
                     attrs or {})
    return outs[0] if n_out == 1 else tuple(outs)


def box_clip(input, im_info, name=None):
    return _det_grad("box_clip", {"Input": input, "ImInfo": im_info},
                     out_slots=["Output"])


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    return _det_grad("sigmoid_focal_loss",
                     {"X": x, "Label": label, "FgNum": fg_num},
                     attrs={"gamma": gamma, "alpha": alpha})


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    ins = {"X": input, "MatchIndices": matched_indices}
    if negative_indices is not None:
        ins["NegIndices"] = negative_indices
    return _det("target_assign", ins, n_out=2,
                out_slots=["Out", "OutWeight"],
                attrs={"mismatch_value": mismatch_value or 0})


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    return _det_grad("box_decoder_and_assign",
                     {"PriorBox": prior_box, "PriorBoxVar": prior_box_var,
                      "TargetBox": target_box, "BoxScore": box_score},
                     n_out=2, out_slots=["DecodeBox", "OutputAssignBox"],
                     attrs={"box_clip": box_clip})


def polygon_box_transform(input, name=None):
    return _det("polygon_box_transform", {"Input": input},
                out_slots=["Output"])


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals")
    n = max_level - min_level + 1
    outs = [helper.create_tmp(dtype="float32", stop_gradient=True)
            for _ in range(n)]
    restore = helper.create_tmp(dtype="int32", stop_gradient=True)
    helper.append_op("distribute_fpn_proposals", {"FpnRois": fpn_rois},
                     {"MultiFpnRois": outs, "RestoreIndex": [restore]},
                     {"min_level": min_level, "max_level": max_level,
                      "refer_level": refer_level,
                      "refer_scale": refer_scale})
    return outs, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    return _det("collect_fpn_proposals",
                {"MultiLevelRois": list(multi_rois),
                 "MultiLevelScores": list(multi_scores)},
                out_slots=["FpnRois"],
                attrs={"post_nms_topN": post_nms_top_n})


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    return _det("roi_perspective_transform", {"X": input, "ROIs": rois},
                n_out=5,
                out_slots=["Out", "Mask", "TransformMatrix", "Out2InIdx",
                           "Out2InWeights"],
                dtypes=["float32", "int32", "float32", "int32",
                        "float32"],
                attrs={"transformed_height": transformed_height,
                       "transformed_width": transformed_width,
                       "spatial_scale": spatial_scale})[0:2]


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None,
                  out_states=None, ap_version="integral"):
    enforce(input_states is None and out_states is None,
            "detection_map computes single-call mAP (the reference's "
            "streaming accumulators are not supported) — aggregate "
            "detections into one batch instead")
    ins = {"DetectRes": detect_res, "Label": label}
    return _det("detection_map", ins, n_out=4,
                out_slots=["MAP", "AccumPosCount", "AccumTruePos",
                           "AccumFalsePos"],
                attrs={"class_num": class_num,
                       "background_label": background_label,
                       "overlap_threshold": overlap_threshold,
                       "evaluate_difficult": evaluate_difficult,
                       "ap_type": ap_version})[0]


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """Returns (pred_scores, pred_loc, target_label, target_bbox,
    bbox_inside_weight) — predictions gathered at the sampled indices
    (detection.py:304). Single-image contract: gt_boxes [G, 4],
    bbox_pred [A, 4], cls_logits [A, 1]; padded slots (index -1) carry
    label -1 / zero weights — mask downstream losses on label >= 0."""
    ins = {"Anchor": anchor_box, "GtBoxes": gt_boxes, "ImInfo": im_info}
    if is_crowd is not None:
        ins["IsCrowd"] = is_crowd
    loc_idx, score_idx, tgt_bbox, tgt_label, biw = _det(
        "rpn_target_assign", ins, n_out=5,
        out_slots=["LocationIndex", "ScoreIndex", "TargetBBox",
                   "TargetLabel", "BBoxInsideWeight"],
        dtypes=["int32", "int32", "float32", "int32", "float32"],
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "use_random": use_random})
    loc_safe = _simple("relu", {"X": loc_idx})
    score_safe = _simple("relu", {"X": score_idx})
    pred_loc = gather(bbox_pred, loc_safe)
    pred_score = gather(cls_logits, score_safe)
    return pred_score, pred_loc, tgt_label, tgt_bbox, biw


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    ins = {"Anchor": anchor_box, "GtBoxes": gt_boxes,
           "GtLabels": gt_labels, "ImInfo": im_info}
    if is_crowd is not None:
        ins["IsCrowd"] = is_crowd
    loc_idx, score_idx, tgt_bbox, tgt_label, biw, fg_num = _det(
        "retinanet_target_assign", ins, n_out=6,
        out_slots=["LocationIndex", "ScoreIndex", "TargetBBox",
                   "TargetLabel", "BBoxInsideWeight",
                   "ForegroundNumber"],
        dtypes=["int32", "int32", "float32", "int32", "float32",
                "int32"],
        attrs={"positive_overlap": positive_overlap,
               "negative_overlap": negative_overlap})
    pred_loc = gather(bbox_pred, _simple("relu", {"X": loc_idx}))
    pred_score = gather(cls_logits, _simple("relu", {"X": score_idx}))
    return (pred_score, pred_loc, tgt_label, tgt_bbox, biw, fg_num)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False):
    ins = {"RpnRois": rpn_rois, "GtClasses": gt_classes,
           "GtBoxes": gt_boxes, "ImInfo": im_info}
    if is_crowd is not None:
        ins["IsCrowd"] = is_crowd
    return _det(
        "generate_proposal_labels", ins, n_out=5,
        out_slots=["Rois", "LabelsInt32", "BboxTargets",
                   "BboxInsideWeights", "BboxOutsideWeights"],
        dtypes=["float32", "int32", "float32", "float32", "float32"],
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums or 81, "use_random": use_random})


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    ins = {"ImInfo": im_info, "GtClasses": gt_classes,
           "GtSegms": gt_segms, "Rois": rois,
           "LabelsInt32": labels_int32}
    if is_crowd is not None:
        ins["IsCrowd"] = is_crowd
    return _det("generate_mask_labels", ins, n_out=3,
                out_slots=["MaskRois", "RoiHasMaskInt32", "MaskInt32"],
                dtypes=["float32", "int32", "int32"],
                attrs={"num_classes": num_classes,
                       "resolution": resolution})


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """detection.py detection_output (SSD post-process): decode loc
    against priors, then multiclass NMS. loc: [N, M, 4];
    scores: [N, M, C]; output [N, keep_top_k, 6] padded (class -1)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    sc = transpose(scores, perm=[0, 2, 1])          # [N, C, M]
    return multiclass_nms(decoded, sc, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          normalized=True,
                          background_label=background_label)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """detection.py multi_box_head (SSD): per-feature-map conv heads for
    loc (4·P channels) and conf (C·P), plus concatenated prior boxes."""
    if min_sizes is None:
        # reference ratio schedule (detection.py:2082)
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (num_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, x in enumerate(inputs):
        ms = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                            (list, tuple)) \
            else [aspect_ratios[i]]
        if steps:
            st = [steps[i], steps[i]]
        elif step_w or step_h:
            st = [(step_w[i] if step_w else 0.0),
                  (step_h[i] if step_h else 0.0)]
        else:
            st = (0.0, 0.0)
        box, var = prior_box(x, image, [ms] if not isinstance(
            ms, (list, tuple)) else ms,
            [mx] if mx and not isinstance(mx, (list, tuple)) else mx,
            ar, variance, flip, clip, steps=st, offset=offset)
        num_priors_per_loc = box.shape[2] if len(box.shape) == 4 else \
            box.shape[0] // (x.shape[2] * x.shape[3])
        nb = num_priors_per_loc
        loc = conv2d(x, num_filters=nb * 4, filter_size=kernel_size,
                     padding=pad, stride=stride)
        conf = conv2d(x, num_filters=nb * num_classes,
                      filter_size=kernel_size, padding=pad, stride=stride)
        n = x.shape[0]
        locs.append(reshape(transpose(loc, perm=[0, 2, 3, 1]),
                            [n, -1, 4]))
        confs.append(reshape(transpose(conf, perm=[0, 2, 3, 1]),
                             [n, -1, num_classes]))
        boxes_all.append(reshape(box, [-1, 4]))
        vars_all.append(reshape(var, [-1, 4]))
    mbox_locs = concat(locs, axis=1)
    mbox_confs = concat(confs, axis=1)
    box = concat(boxes_all, axis=0)
    var = concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, box, var


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """detection.py retinanet_detection_output: decode per-FPN-level
    deltas against anchors, concat levels, multiclass-NMS. bboxes[i]:
    [N, Ai, 4] deltas; scores[i]: [N, Ai, C] (sigmoid); anchors[i]:
    [Ai, 4]."""
    decoded = []
    allscores = []
    for delta, sc, anc in zip(bboxes, scores, anchors):
        decoded.append(box_coder(anc, None, delta,
                                 code_type="decode_center_size",
                                 box_normalized=False))
        allscores.append(sc)
    boxes = concat(decoded, axis=1)                  # [N, A, 4]
    boxes = box_clip(boxes, im_info)
    sc = transpose(concat(allscores, axis=1), perm=[0, 2, 1])
    return multiclass_nms(boxes, sc, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, normalized=False,
                          background_label=-1)
