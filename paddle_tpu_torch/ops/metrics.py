"""Metric ops.

Counterpart of paddle_tpu/ops/metrics.py for `accuracy` (accuracy_op.cc),
the metric of the ResNet and LeNet training programs.
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
