"""Streaming metrics used by the serving path.

Counterpart of `Counter` and `LatencyStat` in
paddle_tpu/utils/metrics.py (the fluid-metrics classes there wait for a
later slice). Both mirror into the unified registry
(observability/metrics.py) under the same series names as the reference.
"""
import re

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.observability import metrics as _obs

__all__ = ["MetricBase", "Counter", "LatencyStat"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


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
