"""Python-side streaming metrics.

Counterpart of paddle_tpu/utils/metrics.py: the fluid.metrics classes
(Accuracy, Precision, Recall, Auc, CompositeMetric, EditDistance,
ChunkEvaluator, DetectionMAP), which accumulate numpy results fetched
from the executor across batches, and the serving path's `Counter` and
`LatencyStat`, which mirror into the unified registry
(observability/metrics.py) under the reference's series names.
"""
import re

import numpy as np

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.observability import metrics as _obs

__all__ = ["MetricBase", "Accuracy", "Precision", "Recall", "Auc",
           "CompositeMetric", "EditDistance", "ChunkEvaluator",
           "Counter", "LatencyStat", "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        return self.value / max(self.weight, 1e-12)


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).reshape(-1)
        labels = np.asarray(labels).astype(int).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(MetricBase):
    def __init__(self, name=None, num_thresholds=4095):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self.stat_pos = np.zeros(self.num_thresholds + 1)
        self.stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        score = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 else preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        bins = np.clip((score * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        np.add.at(self.stat_pos, bins, labels)
        np.add.at(self.stat_neg, bins, 1 - labels)

    def eval(self):
        tp = np.cumsum(self.stat_pos[::-1])
        fp = np.cumsum(self.stat_neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p == 0 or tot_n == 0:
            return 0.0
        tp_prev = np.concatenate([[0], tp[:-1]])
        fp_prev = np.concatenate([[0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (tot_p * tot_n))


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class EditDistance(MetricBase):
    """fluid/metrics.py EditDistance: mean distance + instance error
    rate, fed from the edit_distance op outputs."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num=None):
        d = np.asarray(distances, np.float64).reshape(-1)
        n = int(seq_num) if seq_num is not None else d.size
        self.total_distance += float(d.sum())
        self.seq_num += n
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data in EditDistance")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class ChunkEvaluator(MetricBase):
    """fluid/metrics.py ChunkEvaluator: accumulate the three counters
    emitted by the chunk_eval op and report (precision, recall, f1)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).ravel()[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).ravel()[0])
        self.num_correct_chunks += int(
            np.asarray(num_correct_chunks).ravel()[0])

    def eval(self):
        prec = (self.num_correct_chunks / self.num_infer_chunks
                if self.num_infer_chunks else 0.0)
        rec = (self.num_correct_chunks / self.num_label_chunks
               if self.num_label_chunks else 0.0)
        f1 = (2 * prec * rec / (prec + rec)
              if self.num_correct_chunks else 0.0)
        return prec, rec, f1


def _export_name(name, suffix=""):
    """Sanitize an instance name into a Prometheus series name."""
    base = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    return f"pt_{base}{suffix}"


class Counter(MetricBase):
    """Named monotonic event counters (thread-safe) with a fixed field
    set, so a typo'd increment is an error, not a silently new series.

    Every increment is mirrored into the unified registry as
    ``pt_<name>_total{field=...}``. ``reset()`` clears only the
    instance-local view. ``export=False`` opts a throwaway instance
    out."""

    def __init__(self, name=None, fields=(), export=True):
        super().__init__(name)
        self._fields = tuple(fields)
        self._mu = make_lock("utils.metrics")
        self._export = None
        if export:
            self._export = _obs.registry().counter(
                _export_name(self._name, "_total"),
                f"{self._name} event counts", labels=("field",))
        self.reset()

    def reset(self):
        self._counts = {f: 0 for f in self._fields}

    def update(self, field, n=1):
        with self._mu:
            if field not in self._counts:
                raise KeyError(
                    f"{self._name}: unknown counter field {field!r} "
                    f"(have {sorted(self._counts)})")
            self._counts[field] += int(n)
        if self._export is not None:
            self._export.labels(field=field).inc(int(n))

    inc = update

    def eval(self):
        with self._mu:
            return dict(self._counts)


class LatencyStat(MetricBase):
    """Streaming latency statistic: exact count/mean/max, percentiles
    from a fixed-size log-bucketed histogram (O(1) per update, ≤5%
    quantile error). Mirrored into the registry as ``pt_<name>``."""

    def __init__(self, name=None, export=True):
        super().__init__(name)
        self._export = None
        if export:
            self._export = _obs.registry().histogram(
                _export_name(self._name),
                f"{self._name} distribution")
        self.reset()

    def reset(self):
        self._hist = _obs.Histogram()

    @property
    def count(self):
        return self._hist.count

    @property
    def total(self):
        return self._hist.sum

    @property
    def max(self):
        return self._hist.max if self._hist.count else 0.0

    def update(self, value):
        v = float(value)
        self._hist.record(v)
        if self._export is not None:
            self._export.record(v)

    def percentile(self, q):
        """Approximate percentile (q in [0, 100])."""
        if self._hist.count == 0:
            return 0.0
        return self._hist.quantile(q / 100.0)

    def eval(self):
        if self._hist.count == 0:
            return {"count": 0, "mean": 0.0, "max": 0.0,
                    "p50": 0.0, "p99": 0.0}
        snap = self._hist.snapshot()
        return {"count": snap["count"], "mean": snap["mean"],
                "max": snap["max"], "p50": snap["p50"],
                "p99": snap["p99"]}


class DetectionMAP(MetricBase):
    """fluid/metrics.py DetectionMAP over the static-shape detection_map
    op: collect padded (det [B, M, 6], label [B, G, >=5]) batches on the
    host and evaluate one dense mAP at eval(), through the op on
    `device` (None: CUDA)."""

    def __init__(self, name=None, class_num=None,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral", background_label=0, device=None):
        super().__init__(name)
        self.class_num = class_num
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.background_label = background_label
        self.device = device
        self.reset()

    def reset(self):
        self._dets = []
        self._labels = []

    def update(self, detect_res, label):
        self._dets.append(np.asarray(detect_res, np.float32))
        self._labels.append(np.asarray(label, np.float32))

    def eval(self):
        if not self._dets:
            raise ValueError("no data in DetectionMAP")
        import torch

        from paddle_tpu_torch.core import registry
        from paddle_tpu_torch.core.places import resolve_device
        dev = resolve_device(self.device)
        m = max(d.shape[1] for d in self._dets)
        g = max(l.shape[1] for l in self._labels)

        def padto(a, n):
            if a.shape[1] == n:
                return a
            pad = np.full((a.shape[0], n - a.shape[1], a.shape[2]), -1.0,
                          np.float32)
            pad[..., 1:] = 0.0
            return np.concatenate([a, pad], axis=1)

        det = np.concatenate([padto(d, m) for d in self._dets])
        lab = np.concatenate([padto(l, g) for l in self._labels])
        ctx = registry.OpContext(
            {"class_num": self.class_num,
             "background_label": self.background_label,
             "overlap_threshold": self.overlap_threshold,
             "evaluate_difficult": self.evaluate_difficult,
             "ap_type": self.ap_version}, None, False, 0, dev)
        out = registry.get_op("detection_map").fn(
            ctx, torch.from_numpy(det).to(dev), torch.from_numpy(lab).to(dev),
            None, None, None, None)
        return float(out[0].cpu()[0])
