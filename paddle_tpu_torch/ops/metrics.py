"""Metric ops.

Counterpart of paddle_tpu/ops/metrics.py (the reference's
operators/metrics/): `accuracy`, `auc` and `precision_recall`. The
streaming state (AUC histograms, per-class counts) lives in persistable
vars that the ops rebind, like optimizer state.
"""
import torch

from paddle_tpu_torch.core.registry import register_op


@register_op("accuracy", inputs=["Out", "Indices", "Label"],
             outputs=["Accuracy", "Correct", "Total"])
def _accuracy(ctx, out, indices, label):
    """Top-k accuracy from the top_k op's (values, indices)."""
    lbl = label.reshape(-1, 1).to(indices.dtype)
    correct = (indices == lbl).any(dim=1).float().sum()
    total = torch.full((), float(label.shape[0]), dtype=torch.float32,
                       device=indices.device)
    return (correct / total).reshape(()), correct, total


@register_op("auc", inputs=["Predict", "Label", "StatPos", "StatNeg"],
             outputs=["AUC", "StatPosOut", "StatNegOut"])
def _auc(ctx, predict, label, stat_pos, stat_neg):
    """auc_op.cc: streaming AUC over score histograms of num_thresholds
    bins; stat_pos / stat_neg are persistable [num_thresholds + 1]
    counters. The integration runs in float64, as jnp's float64 zeros
    make it in the JAX package's declared (x64) program."""
    num_t = int(stat_pos.shape[0]) - 1
    score = (predict[:, 1] if predict.dim() == 2 and predict.shape[1] == 2
             else predict.reshape(-1))
    lbl = label.reshape(-1).float()
    bins = torch.clamp((score * num_t).long(), 0, num_t)
    pos = stat_pos + torch.zeros_like(stat_pos).index_add(0, bins, lbl)
    neg = stat_neg + torch.zeros_like(stat_neg).index_add(0, bins, 1.0 - lbl)
    # integrate: walk the thresholds high to low, TP / FP trapezoids
    tp = torch.cumsum(torch.flip(pos, (0,)), 0)
    fp = torch.cumsum(torch.flip(neg, (0,)), 0)
    zero = torch.zeros(1, dtype=torch.float64, device=tp.device)
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = ((fp - fp_prev) * (tp + tp_prev) / 2.0).sum()
    auc = torch.where((tp[-1] > 0) & (fp[-1] > 0),
                      area / torch.clamp(tp[-1] * fp[-1], min=1e-12),
                      torch.zeros_like(area))
    return auc, pos, neg


def _prf(s):
    """Macro precision, recall and F1 of [C, 4] (TP, FP, TN, FN) counts,
    twice (the macro and micro slots of the API's shape)."""
    tp, fp, fn = s[:, 0], s[:, 1], s[:, 3]
    zero = torch.zeros_like(tp)
    prec = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1e-12),
                       zero)
    rec = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1e-12),
                      zero)
    f1 = torch.where(prec + rec > 0,
                     2 * prec * rec / torch.clamp(prec + rec, min=1e-12),
                     zero)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    return torch.cat([macro, macro])


@register_op("precision_recall",
             inputs=["MaxProbs", "Indices", "Labels", "StatesInfo"],
             outputs=["BatchMetrics", "AccumMetrics", "AccumStatesInfo"])
def _precision_recall(ctx, max_probs, indices, labels, states):
    """precision_recall_op.cc: per-class TP / FP / TN / FN counts;
    states [C, 4]."""
    classes = torch.arange(int(states.shape[0]), device=states.device)
    pred = (indices.reshape(-1, 1).long() == classes).float()
    lbl = (labels.reshape(-1, 1).long() == classes).float()
    tp = (pred * lbl).sum(dim=0)
    fp = (pred * (1 - lbl)).sum(dim=0)
    fn = ((1 - pred) * lbl).sum(dim=0)
    tn = ((1 - pred) * (1 - lbl)).sum(dim=0)
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    accum = states + batch
    return _prf(batch), _prf(accum), accum
