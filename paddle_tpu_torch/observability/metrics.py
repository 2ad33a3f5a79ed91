"""Unified metrics registry: counters, gauges, log-bucketed histograms.

The first port kept numbers in three disconnected places: an unlocked
module dict in utils/profiler (`_counters`), per-subsystem `stats()`
dicts, and `utils.metrics.LatencyStat` reservoirs whose every
`percentile()` call sorted the sample list. This module is the one
substrate they all re-point at:

* **Counter** — monotonic float/int accumulator, labelled
  (`labels(tenant="a", outcome="admitted")` → child). Thread-safe.
* **Gauge** — last-written value, labelled. Used for mirrored profiler
  counter series and schedule/bubble accounting.
* **Histogram** — *fixed-size log-bucketed* distribution: bucket
  boundaries grow geometrically (`growth = 2**(1/8)` by default, ~9% per
  bucket), so `record()` is O(1) (one log2 + one array increment),
  `snapshot()`/`quantile()` are O(#buckets) — independent of sample
  count — and the worst-case quantile error is half a bucket width
  (≤ ~4.4% relative at the default growth; the regression test pins
  ≤5% vs exact on a reference distribution). `merge()` adds two
  histograms bucket-wise (same geometry required); `record_many()` is
  the vectorized bulk path (numpy bincount).

Exposition: `MetricsRegistry.prometheus_text()` renders the Prometheus
text format (counters `*_total`, gauges, histograms as cumulative
`_bucket{le=...}` + `_sum`/`_count`) — served by the gateway's
`GET /metrics` route. Naming convention (docs/observability.md): every
series is `pt_<subsystem>_<noun>[_total|_seconds]`, labels are low-
cardinality identifiers only (tenant, verb, bucket, outcome — never
request ids).

A process-wide default registry (`registry()`) backs the shims; tests
construct private `MetricsRegistry()` instances for golden comparisons.
"""
import math
import re
import threading

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v):
    return str(v).replace("\\", r"\\").replace("\n", r"\n") \
        .replace('"', r'\"')


class Counter:
    """Monotonic accumulator (one labelset child of a counter family)."""

    __slots__ = ("_mu", "_value")

    def __init__(self):
        self._mu = threading.Lock()  # lock-ok: detector self-deadlock
        self._value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._mu:
            self._value += n

    @property
    def value(self):
        with self._mu:
            return self._value


class Gauge:
    """Last-written value (one labelset child of a gauge family)."""

    __slots__ = ("_mu", "_value")

    def __init__(self):
        self._mu = threading.Lock()  # lock-ok: detector self-deadlock
        self._value = 0.0

    def set(self, v):
        with self._mu:
            self._value = float(v)

    def inc(self, n=1):
        with self._mu:
            self._value += n

    @property
    def value(self):
        with self._mu:
            return self._value


class Histogram:
    """Fixed-size log-bucketed histogram.

    Buckets: [0, lo] (underflow), then `nbuckets` geometric buckets
    (lo, lo*g], (lo*g, lo*g^2], ... , plus an overflow bucket. Exact
    count/sum/min/max ride alongside so mean and extremes are not
    bucket-quantized.
    """

    __slots__ = ("lo", "growth", "nbuckets", "_log_g", "_counts",
                 "count", "sum", "min", "max", "_mu")

    #: default geometry: 1µs .. >10⁴s in 8-buckets-per-octave steps
    DEFAULT_LO = 1e-6
    DEFAULT_HI = 1e4
    BUCKETS_PER_OCTAVE = 8

    def __init__(self, lo=DEFAULT_LO, hi=DEFAULT_HI,
                 buckets_per_octave=BUCKETS_PER_OCTAVE):
        if not (lo > 0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        self.lo = float(lo)
        self.growth = 2.0 ** (1.0 / buckets_per_octave)
        self._log_g = math.log2(self.growth)
        self.nbuckets = int(math.ceil(
            math.log2(hi / lo) / self._log_g))
        # counts[0] underflow (<= lo), counts[1..n] geometric,
        # counts[n+1] overflow
        self._counts = np.zeros(self.nbuckets + 2, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._mu = threading.Lock()  # lock-ok: detector self-deadlock

    def _index(self, v):
        if v <= self.lo:
            return 0
        i = int(math.log2(v / self.lo) / self._log_g) + 1
        return min(i, self.nbuckets + 1)

    def record(self, v):
        v = float(v)
        i = self._index(v)
        with self._mu:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    # LatencyStat-shim compatibility alias
    update = record

    def record_many(self, values):
        """Vectorized bulk record (tests/bench): one bincount pass."""
        a = np.asarray(values, np.float64).ravel()
        if a.size == 0:
            return
        idx = np.ones(a.shape, np.int64)
        over = a > self.lo
        idx[~over] = 0
        if over.any():
            idx[over] = np.minimum(
                (np.log2(a[over] / self.lo) / self._log_g).astype(
                    np.int64) + 1,
                self.nbuckets + 1)
        binned = np.bincount(idx, minlength=self._counts.size)
        with self._mu:
            self._counts += binned
            self.count += int(a.size)
            self.sum += float(a.sum())
            self.min = min(self.min, float(a.min()))
            self.max = max(self.max, float(a.max()))

    def merge(self, other):
        """Add `other`'s distribution into this one (same geometry)."""
        if (other.lo != self.lo or other.nbuckets != self.nbuckets
                or other.growth != self.growth):
            raise ValueError("cannot merge histograms with different "
                             "bucket geometry")
        with other._mu:
            counts = other._counts.copy()
            cnt, tot = other.count, other.sum
            mn, mx = other.min, other.max
        with self._mu:
            self._counts += counts
            self.count += cnt
            self.sum += tot
            self.min = min(self.min, mn)
            self.max = max(self.max, mx)
        return self

    def _upper(self, i):
        """Upper bound of bucket i (0 = underflow → lo)."""
        return self.lo * (self.growth ** i)

    def quantile(self, q):
        """Approximate quantile (q in [0,1]): geometric midpoint of the
        bucket holding the q-th sample, clamped to the exact [min, max].
        O(#buckets); never sorts samples."""
        with self._mu:
            n = self.count
            if n == 0:
                return 0.0
            counts = self._counts.copy()
            mn, mx = self.min, self.max
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c:
                if i == 0:
                    est = self.lo
                elif i == self.nbuckets + 1:
                    est = mx
                else:
                    est = math.sqrt(self._upper(i - 1) * self._upper(i))
                return min(max(est, mn), mx)
        return mx

    def snapshot(self):
        """O(#buckets) summary: count/sum/mean/min/max + p50/p90/p99."""
        with self._mu:
            n = self.count
        if n == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        with self._mu:
            tot, mn, mx = self.sum, self.min, self.max
        return {"count": n, "sum": tot, "mean": tot / n, "min": mn,
                "max": mx, "p50": self.quantile(0.50),
                "p90": self.quantile(0.90), "p99": self.quantile(0.99)}

    def raw_counts(self):
        """Consistent (counts copy, count, sum) under one lock — the
        substrate for *windowed* views: two raw_counts() snapshots of
        the same histogram subtract bucket-wise into the distribution
        of everything recorded between them (slo.WindowedView)."""
        with self._mu:
            return self._counts.copy(), self.count, self.sum

    def quantile_of_counts(self, counts, q):
        """Approximate quantile of an ARBITRARY counts array laid out in
        this histogram's geometry (e.g. a bucket-wise delta between two
        raw_counts() snapshots). Same midpoint estimator as quantile(),
        but without the exact min/max clamp — a windowed delta has no
        per-window extremes to clamp to."""
        n = int(counts.sum())
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c:
                if i == 0:
                    return self.lo
                if i == self.nbuckets + 1:
                    return self._upper(self.nbuckets)
                return math.sqrt(self._upper(i - 1) * self._upper(i))
        return self._upper(self.nbuckets)

    def nonzero_buckets(self):
        """[(upper_bound, cumulative_count)] over non-empty buckets —
        the Prometheus `_bucket{le=...}` series."""
        with self._mu:
            counts = self._counts.copy()
        out, cum = [], 0
        for i, c in enumerate(counts):
            cum += int(c)
            if c:
                upper = (self.lo if i == 0 else
                         math.inf if i == self.nbuckets + 1 else
                         self._upper(i))
                out.append((upper, cum))
        return out


class _Family:
    """One named metric family: lazily-created children per labelset."""

    def __init__(self, name, help_, kind, labelnames, child_factory):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r}")
        self.name = name
        self.help = help_
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._factory = child_factory
        self._children = {}
        self._mu = threading.Lock()  # lock-ok: detector self-deadlock

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._mu:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._factory()
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; use "
                f".labels(...)")
        return self.labels()

    # label-less convenience: the family forwards to its single child
    def inc(self, n=1):
        self._default_child().inc(n)

    def set(self, v):
        self._default_child().set(v)

    def record(self, v):
        self._default_child().record(v)

    def children(self):
        with self._mu:
            return dict(self._children)


class MetricsRegistry:
    """Thread-safe name → family registry with Prometheus exposition.

    Re-registering an existing name returns the SAME family (kind and
    labelnames must match — a drifting redefinition is a bug, not a new
    series), so independent subsystems share process-wide totals."""

    def __init__(self):
        # Every lock in this module is a raw stdlib lock, never a
        # TrackedLock: the concurrency detector's wait/hold histograms
        # live in THIS registry, so recording any metrics-internal
        # lock's acquisition re-enters the registry/family/child it is
        # currently holding (TrackedLock._hists -> _get_or_make /
        # .labels() / .record()) and self-deadlocks — e.g. exposition
        # iterating the pt_lock_wait_seconds family takes that family's
        # lock, whose bookkeeping needs a child of the same family.
        # The meter can't meter itself.
        self._mu = threading.Lock()  # lock-ok: detector self-deadlock
        self._families = {}

    def _get_or_make(self, name, help_, kind, labels, factory):
        with self._mu:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(labels)} but exists as {fam.kind}"
                        f"{fam.labelnames}")
                return fam
            fam = _Family(name, help_, kind, labels, factory)
            self._families[name] = fam
            return fam

    def counter(self, name, help_="", labels=()):
        return self._get_or_make(name, help_, "counter", labels, Counter)

    def gauge(self, name, help_="", labels=()):
        return self._get_or_make(name, help_, "gauge", labels, Gauge)

    def histogram(self, name, help_="", labels=(), lo=Histogram.DEFAULT_LO,
                  hi=Histogram.DEFAULT_HI,
                  buckets_per_octave=Histogram.BUCKETS_PER_OCTAVE):
        return self._get_or_make(
            name, help_, "histogram", labels,
            lambda: Histogram(lo=lo, hi=hi,
                              buckets_per_octave=buckets_per_octave))

    def families(self):
        with self._mu:
            return dict(self._families)

    def reset(self):
        with self._mu:
            self._families.clear()

    # -- exposition ----------------------------------------------------
    def prometheus_text(self):
        """The Prometheus text exposition format (0.0.4): stable (name-
        and labelset-sorted) so goldens can compare exactly."""
        lines = []
        for name in sorted(self.families()):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            children = sorted(fam.children().items())
            for key, child in children:
                labels = ",".join(
                    f'{ln}="{_escape_label(lv)}"'
                    for ln, lv in zip(fam.labelnames, key))
                if fam.kind in ("counter", "gauge"):
                    lines.append(
                        f"{name}{{{labels}}} {_fmt(child.value)}"
                        if labels else f"{name} {_fmt(child.value)}")
                else:
                    base = labels + "," if labels else ""
                    for upper, cum in child.nonzero_buckets():
                        if upper == math.inf:
                            continue      # the explicit +Inf line below
                        lines.append(
                            f'{name}_bucket{{{base}le="{_fmt(upper)}"}} '
                            f'{cum}')
                    lines.append(
                        f'{name}_bucket{{{base}le="+Inf"}} {child.count}')
                    suffix = f"{{{labels}}}" if labels else ""
                    lines.append(f"{name}_sum{suffix} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{suffix} {child.count}")
        return "\n".join(lines) + "\n"


def _fmt(v):
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


_default = MetricsRegistry()


def registry():
    """The process-wide default registry every shimmed counter site and
    the gateway's /metrics route share."""
    return _default
