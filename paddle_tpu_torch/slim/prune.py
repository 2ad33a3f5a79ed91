"""Pruning.

Counterpart of paddle_tpu/slim/prune.py (the reference's
contrib/slim/prune/): magnitude pruning with per-parameter ratios,
sensitivity analysis (prune one parameter at a time, measure a metric)
and mask application. Parameters are read from and written to the port's
Scope as numpy (`find_np` / `set`); structured channel pruning zeros
whole output channels and keeps every shape, as the reference does.
"""
import numpy as np

from paddle_tpu_torch.core.enforce import enforce


def _mask_unstructured(w, ratio):
    flat = np.abs(w).ravel()
    k = int(len(flat) * ratio)
    if k == 0:
        return np.ones_like(w, bool)
    thresh = np.partition(flat, k - 1)[k - 1]
    return np.abs(w) > thresh


def _mask_channel(w, ratio, axis):
    red = tuple(i for i in range(w.ndim) if i != axis)
    norms = np.sqrt((w.astype(np.float64) ** 2).sum(axis=red))
    k = int(len(norms) * ratio)
    mask = np.ones(w.shape, bool)
    if k == 0:
        return mask
    drop = np.argsort(norms)[:k]
    sl = [slice(None)] * w.ndim
    sl[axis] = drop
    mask[tuple(sl)] = False
    return mask


class Pruner:
    """Magnitude pruner over scope-resident parameters.

    criterion: "l1_norm" (unstructured) | "channel" (structured, zeroing
    output channels along `channel_axis`).
    """

    def __init__(self, criterion="l1_norm", channel_axis=0):
        self.criterion = criterion
        self.channel_axis = channel_axis

    def prune(self, scope, ratios):
        """ratios: {param name: fraction to remove}. Returns
        {name: mask}; parameters are masked in place in the scope."""
        masks = {}
        for name, ratio in ratios.items():
            w = scope.find_np(name)
            enforce(w is not None, "prune: %s not found in scope", name)
            enforce(0.0 <= ratio < 1.0, "prune ratio must be in [0,1)")
            if self.criterion == "channel":
                mask = _mask_channel(w, ratio, self.channel_axis)
            else:
                mask = _mask_unstructured(w, ratio)
            scope.set(name, (w * mask).astype(w.dtype))
            masks[name] = mask
        return masks

    def apply_masks(self, scope, masks):
        """Re-apply masks (after an optimizer step un-zeros entries —
        the QAT-style prune-train loop)."""
        for name, mask in masks.items():
            w = scope.find_np(name)
            if w is not None:
                scope.set(name, (w * mask).astype(w.dtype))


def sensitivity(program, executor, scope, param_names, eval_fn,
                ratios=(0.1, 0.3, 0.5, 0.7)):
    """contrib/slim sensitivity analysis: prune ONE parameter at a time at
    each ratio, call eval_fn() (user metric over the program), restore, and
    report {param: {ratio: metric}}."""
    pruner = Pruner()
    result = {}
    for name in param_names:
        orig = scope.find_np(name).copy()
        per = {}
        for r in ratios:
            pruner.prune(scope, {name: r})
            per[float(r)] = float(eval_fn())
            scope.set(name, orig.copy())
        result[name] = per
    return result


def sparsity(scope, param_names):
    """Fraction of zero entries over the given params."""
    zeros = total = 0
    for n in param_names:
        w = scope.find_np(n)
        if w is None:
            continue
        zeros += int((w == 0).sum())
        total += w.size
    return zeros / max(total, 1)
