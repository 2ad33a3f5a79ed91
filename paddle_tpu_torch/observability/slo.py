"""SLO engine: windowed metric views + multi-window burn-rate alerting.

Counterpart of paddle_tpu/observability/slo.py. The metrics registry
(observability/metrics.py) holds cumulative series; this module is the
decision plane on top:

* **WindowedView** — a bounded ring of timestamped registry snapshots.
  `tick()` captures counter values and histogram bucket arrays (one
  `raw_counts()` per child — far off any hot path); `rate()`/`delta()`
  /`quantile()` then answer over-a-window questions by subtracting the
  newest snapshot at-or-before the window start from the live value.
  The O(1) record path of the registry is untouched.

* **SloSpec** — one declarative objective. Three kinds:

  - ``availability``: good/total event ratio from counter selectors
    (e.g. `pt_serving_requests_total{outcome="completed"}` over the
    terminal outcomes);
  - ``latency``: the fraction of a histogram's window samples over a
    threshold (wire latency, TTFT) against a target fraction;
  - ``freshness``: a liveness objective for generation streams — BAD
    when the `active` gauge says work is in flight but the `progress`
    counter did not move across the window (a wedged decode loop).

* **burn-rate rules** — the SRE-workbook multi-window multi-burn-rate
  construction, scaled from calendar time to seconds: a rule fires only
  when the burn rate (window error ratio ÷ error budget) exceeds its
  threshold over BOTH a long and a short window. Alerts are
  **edge-triggered**: one ``fire`` on the rising edge, one ``resolve``
  on the falling edge, into a bounded alert log, the
  `pt_slo_alerts_total{slo,severity,event}` counter, a FlightRecorder
  note (observability/recorder.py) and any registered `on_alert`
  callbacks.

* **SloEngine** — owns the view + specs, evaluates every
  `PT_FLAGS_slo_eval_interval_s` on a daemon thread (0 disables; the
  gateway's `GET /slo` also evaluates on demand), and publishes
  `pt_slo_burn_rate{slo,window}` and
  `pt_slo_error_budget_remaining{slo}` gauges.

Everything is clock-injectable: the tests drive fire/hold/clear
transitions with a fake clock and hand-rolled counter increments,
threadlessly.
"""
import collections
import logging
import math
import threading
import time

import numpy as np

from paddle_tpu_torch.analysis.concurrency import guarded_by, make_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import metrics as obs_metrics

logger = logging.getLogger("paddle_tpu_torch.observability.slo")

__all__ = ["Selector", "WindowedView", "BurnRule", "SloSpec",
           "SloEngine", "default_serving_specs"]


class Selector:
    """One metric selection: a family name + label constraints.

    `labels` maps label name → required value, a tuple/list of accepted
    values, or None (wildcard). Children whose labelset matches are
    SUMMED (counters: value-wise; histograms: bucket-wise — same
    geometry is guaranteed within a family).
    """

    def __init__(self, name, labels=None):
        self.name = name
        self.labels = dict(labels or {})

    def matches(self, labelnames, key):
        got = dict(zip(labelnames, key))
        for ln, want in self.labels.items():
            if want is None:
                continue
            accept = want if isinstance(want, (tuple, list, set)) \
                else (want,)
            if got.get(ln) not in {str(v) for v in accept}:
                return False
        return True

    def to_dict(self):
        return {"name": self.name,
                "labels": {k: (list(v) if isinstance(v, (tuple, list,
                                                        set)) else v)
                           for k, v in self.labels.items()}}

    def __repr__(self):
        sel = ",".join(f"{k}={v}" for k, v in self.labels.items())
        return f"{self.name}{{{sel}}}" if sel else self.name


def _as_selector(sel):
    if isinstance(sel, Selector):
        return sel
    if isinstance(sel, str):
        return Selector(sel)
    name, labels = sel
    return Selector(name, labels)


class _HistState:
    """One histogram child's snapshot: bucket counts + count + sum."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self, counts, count, sum_):
        self.counts = counts
        self.count = count
        self.sum = sum_


class WindowedView:
    """Bounded ring of registry snapshots → rate/quantile over windows.

    `tick(now)` appends one snapshot; snapshots older than `horizon_s`
    (and beyond `max_snapshots`) fall off. Queries subtract the newest
    snapshot at or before `now - window_s` from the LIVE registry
    value, so a query between ticks still sees up-to-the-call deltas;
    the `actual window` (now - snapshot time) is what rates divide by,
    so a partially-filled ring degrades to since-oldest-snapshot rates
    instead of lying about the denominator.
    """

    def __init__(self, registry=None, horizon_s=300.0, max_snapshots=512,
                 clock=time.monotonic):
        enforce(horizon_s > 0, "horizon_s must be > 0")
        self._registry = registry or obs_metrics.registry()
        self.horizon_s = float(horizon_s)
        self._ring = collections.deque(  # guarded_by(_mu)
            maxlen=int(max_snapshots))
        self._clock = clock
        self._mu = make_lock("slo.window")
        guarded_by(self, "_ring", "slo.window")

    # -- capture -------------------------------------------------------
    def _capture(self):
        """{family name: (labelnames, {labelkey: value|_HistState})}."""
        snap = {}
        for name, fam in self._registry.families().items():
            if fam.kind == "gauge":
                continue              # gauges are instant reads
            children = {}
            for key, child in fam.children().items():
                if fam.kind == "counter":
                    children[key] = child.value
                else:
                    counts, count, tot = child.raw_counts()
                    children[key] = _HistState(counts, count, tot)
            snap[name] = (fam.labelnames, children)
        return snap

    def tick(self, now=None):
        """Capture one snapshot (the engine's eval loop calls this)."""
        now = self._clock() if now is None else now
        snap = self._capture()
        with self._mu:
            self._ring.append((now, snap))
            while self._ring and now - self._ring[0][0] > self.horizon_s:
                self._ring.popleft()
        return now

    def _baseline(self, window_s, now):
        """Newest snapshot at or before now - window_s (falls back to
        the oldest retained). Returns (t, snap) or (None, None)."""
        target = now - window_s
        with self._mu:
            best = None
            for t, snap in self._ring:
                if t <= target:
                    best = (t, snap)
                else:
                    break
            if best is None and self._ring:
                best = self._ring[0]
        return best if best is not None else (None, None)

    @property
    def snapshots(self):
        with self._mu:
            return len(self._ring)

    # -- queries -------------------------------------------------------
    def _family(self, name):
        return self._registry.families().get(name)

    def _sum_live_counter(self, sel):
        fam = self._family(sel.name)
        if fam is None or fam.kind != "counter":
            return 0.0
        return sum(child.value
                   for key, child in fam.children().items()
                   if sel.matches(fam.labelnames, key))

    def _sum_base_counter(self, sel, snap):
        if snap is None or sel.name not in snap:
            return 0.0
        labelnames, children = snap[sel.name]
        return sum(v for key, v in children.items()
                   if sel.matches(labelnames, key))

    def delta(self, selector, window_s, now=None):
        """Counter increase over the window: live value minus the
        baseline snapshot (0.0 with no ring or no such family).
        Returns (delta, actual_window_s)."""
        sel = _as_selector(selector)
        now = self._clock() if now is None else now
        t0, snap = self._baseline(window_s, now)
        live = self._sum_live_counter(sel)
        if t0 is None:
            return 0.0, 0.0
        base = self._sum_base_counter(sel, snap)
        return max(live - base, 0.0), max(now - t0, 0.0)

    def rate(self, selector, window_s, now=None):
        """Per-second rate of a counter over the window."""
        d, dt = self.delta(selector, window_s, now=now)
        return d / dt if dt > 0 else 0.0

    def gauge_value(self, selector):
        """Instant sum of a gauge family's matching children."""
        sel = _as_selector(selector)
        fam = self._family(sel.name)
        if fam is None or fam.kind != "gauge":
            return 0.0
        return sum(child.value
                   for key, child in fam.children().items()
                   if sel.matches(fam.labelnames, key))

    def window_histogram(self, selector, window_s, now=None):
        """Bucket-wise delta of a histogram family over the window:
        (counts array, count, sum, reference child) — the reference
        child carries the geometry (`quantile_of_counts`). None when
        the family does not exist or has no children."""
        sel = _as_selector(selector)
        now = self._clock() if now is None else now
        fam = self._family(sel.name)
        if fam is None or fam.kind != "histogram":
            return None
        ref = None
        live_counts, live_count, live_sum = None, 0, 0.0
        for key, child in fam.children().items():
            if not sel.matches(fam.labelnames, key):
                continue
            counts, count, tot = child.raw_counts()
            if ref is None:
                ref = child
                live_counts = counts.astype(np.int64)
            else:
                live_counts = live_counts + counts
            live_count += count
            live_sum += tot
        if ref is None:
            return None
        t0, snap = self._baseline(window_s, now)
        if t0 is not None and sel.name in snap:
            labelnames, children = snap[sel.name]
            for key, st in children.items():
                if sel.matches(labelnames, key):
                    live_counts = live_counts - st.counts
                    live_count -= st.count
                    live_sum -= st.sum
        live_counts = np.maximum(live_counts, 0)
        return live_counts, max(live_count, 0), max(live_sum, 0.0), ref

    def quantile(self, selector, q, window_s, now=None):
        """Approximate quantile of a histogram's WINDOW samples (the
        over-the-last-N-seconds p99 the cumulative histogram cannot
        answer). 0.0 when the window saw no samples."""
        wh = self.window_histogram(selector, window_s, now=now)
        if wh is None:
            return 0.0
        counts, count, _, ref = wh
        if count == 0:
            return 0.0
        return ref.quantile_of_counts(counts, q)

    def fraction_over(self, selector, threshold, window_s, now=None):
        """Fraction of the window's histogram samples whose bucket
        midpoint exceeds `threshold` (the latency-SLO error ratio;
        quantized to the ≤~9% log-bucket width). Returns
        (fraction, window_count)."""
        wh = self.window_histogram(selector, window_s, now=now)
        if wh is None:
            return 0.0, 0
        counts, count, _, ref = wh
        if count == 0:
            return 0.0, 0
        over = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if i == 0:
                mid = ref.lo
            elif i == ref.nbuckets + 1:
                mid = ref._upper(ref.nbuckets) * ref.growth
            else:
                mid = math.sqrt(ref._upper(i - 1) * ref._upper(i))
            if mid > threshold:
                over += int(c)
        return over / count, int(count)


class BurnRule:
    """One multi-window burn-rate alert rule (SRE-workbook shape).

    Fires when burn_rate >= `burn` over BOTH `long_s` (a real problem,
    not a blip) and `short_s` (still happening — the short window is
    what lets a resolved incident CLEAR fast). `severity` is a label,
    conventionally ``page`` (fast burn) or ``ticket`` (slow burn).
    """

    def __init__(self, long_s, short_s, burn, severity="page"):
        enforce(long_s > short_s > 0,
                "need long_s > short_s > 0, got %s/%s", long_s, short_s)
        enforce(burn > 0, "burn threshold must be > 0")
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.burn = float(burn)
        self.severity = str(severity)

    @property
    def key(self):
        return f"{self.severity}:{self.long_s:g}s/{self.short_s:g}s"

    def to_dict(self):
        return {"long_s": self.long_s, "short_s": self.short_s,
                "burn": self.burn, "severity": self.severity}


#: default window pairs, scaled from the workbook's 1h/5m + 6h/30m to
#: seconds (a serving storm under test runs for seconds, not hours) —
#: overridable per spec.
DEFAULT_RULES = (
    BurnRule(long_s=10.0, short_s=2.0, burn=8.0, severity="page"),
    BurnRule(long_s=60.0, short_s=15.0, burn=2.0, severity="ticket"),
)


class SloSpec:
    """One declarative objective.

    kind="availability": `good`/`total` counter selectors; the window
      error ratio is 1 - good/total (0 when the window saw no traffic —
      an idle service is not failing its SLO).
    kind="latency": `histogram` selector + `threshold_s`; the error
      ratio is the fraction of window samples over the threshold. The
      `objective` is the target fraction UNDER it (e.g. 0.99 → budget
      = 1% of requests may exceed the threshold).
    kind="freshness": `progress` counter selector + `active` gauge
      selector; error ratio 1.0 when active > 0 but progress did not
      move over the window, else 0.0 (generation-stream liveness).
    """

    KINDS = ("availability", "latency", "freshness")

    def __init__(self, name, kind, objective, good=None, total=None,
                 histogram=None, threshold_s=None, progress=None,
                 active=None, rules=None, budget_window_s=120.0,
                 min_events=1):
        enforce(kind in self.KINDS, "unknown SLO kind %r", kind)
        enforce(0.0 < objective < 1.0,
                "objective must be in (0, 1), got %s", objective)
        self.name = str(name)
        self.kind = kind
        self.objective = float(objective)
        self.good = _as_selector(good) if good is not None else None
        self.total = _as_selector(total) if total is not None else None
        self.histogram = (_as_selector(histogram)
                          if histogram is not None else None)
        self.threshold_s = threshold_s
        self.progress = (_as_selector(progress)
                         if progress is not None else None)
        self.active = _as_selector(active) if active is not None else None
        self.rules = tuple(rules) if rules is not None else DEFAULT_RULES
        self.budget_window_s = float(budget_window_s)
        #: windows with fewer good+bad events than this report error
        #: ratio 0 (a 1-request window failing is noise, not a burn)
        self.min_events = int(min_events)
        if kind == "availability":
            enforce(self.good is not None and self.total is not None,
                    "availability SLO %r needs good= and total=", name)
        elif kind == "latency":
            enforce(self.histogram is not None
                    and threshold_s is not None,
                    "latency SLO %r needs histogram= and threshold_s=",
                    name)
        else:
            enforce(self.progress is not None and self.active is not None,
                    "freshness SLO %r needs progress= and active=", name)

    @property
    def budget(self):
        """The error budget: the tolerated error ratio."""
        return 1.0 - self.objective

    def error_ratio(self, view, window_s, now=None):
        """The window's error ratio in [0, 1]."""
        if self.kind == "availability":
            good, _ = view.delta(self.good, window_s, now=now)
            total, _ = view.delta(self.total, window_s, now=now)
            if total < self.min_events:
                return 0.0
            return min(max(1.0 - good / total, 0.0), 1.0)
        if self.kind == "latency":
            frac, count = view.fraction_over(
                self.histogram, self.threshold_s, window_s, now=now)
            if count < self.min_events:
                return 0.0
            return frac
        # freshness
        active = view.gauge_value(self.active)
        if active <= 0:
            return 0.0
        progress, dt = view.delta(self.progress, window_s, now=now)
        if dt <= 0:
            return 0.0               # no baseline yet: never alert blind
        return 1.0 if progress <= 0 else 0.0

    def burn_rate(self, view, window_s, now=None):
        """error ratio ÷ error budget: 1.0 burns the budget exactly at
        the objective's tolerated pace."""
        return self.error_ratio(view, window_s, now=now) / self.budget

    def to_dict(self):
        doc = {"name": self.name, "kind": self.kind,
               "objective": self.objective, "budget": self.budget,
               "budget_window_s": self.budget_window_s,
               "rules": [r.to_dict() for r in self.rules]}
        if self.kind == "availability":
            doc["good"] = self.good.to_dict()
            doc["total"] = self.total.to_dict()
        elif self.kind == "latency":
            doc["histogram"] = self.histogram.to_dict()
            doc["threshold_s"] = self.threshold_s
        else:
            doc["progress"] = self.progress.to_dict()
            doc["active"] = self.active.to_dict()
        return doc


class _AlertState:
    """Edge-trigger FSM for one (spec, rule) pair."""

    __slots__ = ("firing", "fired_at", "fire_count")

    def __init__(self):
        self.firing = False
        self.fired_at = None
        self.fire_count = 0


class SloEngine:
    """Evaluate specs against a windowed view; emit edge-triggered
    alerts, gauges, and callbacks.

    >>> eng = SloEngine(default_serving_specs())
    >>> eng.on_alert(lambda evt: ...)        # the autoscaler's hook
    >>> eng.start()                          # background eval loop
    ...
    >>> eng.snapshot()                       # the GET /slo document
    """

    def __init__(self, specs=(), registry=None, view=None,
                 clock=time.monotonic, alert_log_capacity=256,
                 eval_interval_s=None, recorder=None):
        self._registry = registry or obs_metrics.registry()
        self._clock = clock
        self.view = view or WindowedView(self._registry, clock=clock)
        self._specs = []
        self._states = {}             # (spec name, rule key) -> state
        self._mu = make_lock("slo.engine")
        self._alert_log = collections.deque(
            maxlen=int(alert_log_capacity))
        self._callbacks = []
        self._recorder = recorder
        self._thread = None
        self._stop = threading.Event()
        self._evals = 0
        self._last_eval = None
        if eval_interval_s is None:
            eval_interval_s = _flags.get_flag("slo_eval_interval_s")
        self.eval_interval_s = float(eval_interval_s)
        reg = self._registry
        self._g_burn = reg.gauge(
            "pt_slo_burn_rate",
            "error-budget burn rate per SLO and window",
            labels=("slo", "window"))
        self._g_budget = reg.gauge(
            "pt_slo_error_budget_remaining",
            "fraction of the error budget left over the budget window",
            labels=("slo",))
        self._c_alerts = reg.counter(
            "pt_slo_alerts_total",
            "edge-triggered SLO alert events",
            labels=("slo", "severity", "event"))
        for s in specs:
            self.add_spec(s)

    # -- configuration -------------------------------------------------
    def add_spec(self, spec):
        enforce(isinstance(spec, SloSpec),
                "add_spec needs an SloSpec, got %r", spec)
        with self._mu:
            enforce(all(s.name != spec.name for s in self._specs),
                    "duplicate SLO name %r", spec.name)
            self._specs.append(spec)
            for rule in spec.rules:
                self._states[(spec.name, rule.key)] = _AlertState()
        return spec

    @property
    def specs(self):
        with self._mu:
            return list(self._specs)

    def on_alert(self, callback):
        """Register a callback(event dict) for every fire/resolve edge
        (the future autoscaler's signal). Exceptions are swallowed —
        a broken consumer must not stop evaluation."""
        self._callbacks.append(callback)
        return callback

    def _recorder_note(self, message, **fields):
        rec = self._recorder
        if rec is None:
            from paddle_tpu_torch.observability import recorder as _rec
            rec = _rec.flight_recorder()
        try:
            rec.note(message, **fields)
        except Exception:              # pragma: no cover - guard rail
            pass

    # -- evaluation ----------------------------------------------------
    def _emit(self, event):
        self._alert_log.append(event)
        self._c_alerts.labels(slo=event["slo"],
                              severity=event["severity"],
                              event=event["event"]).inc()
        self._recorder_note(
            f"slo {event['event']}: {event['slo']} "
            f"[{event['severity']}] burn={event['burn_long']:.2f}",
            **{k: v for k, v in event.items() if k != "event"})
        (logger.warning if event["event"] == "fire" else logger.info)(
            "SLO %s %s (%s, burn long=%.2f short=%.2f threshold=%.2f)",
            event["slo"], event["event"], event["severity"],
            event["burn_long"], event["burn_short"], event["threshold"])
        for cb in list(self._callbacks):
            try:
                cb(dict(event))
            except Exception:          # pragma: no cover - guard rail
                logger.exception("slo on_alert callback failed")

    def evaluate(self, now=None):
        """One evaluation pass: tick the view, compute burn rates per
        spec×rule, run the edge-trigger FSMs, publish gauges. Returns
        the per-spec evaluation dict (also cached for snapshot())."""
        now = self._clock() if now is None else now
        self.view.tick(now)
        results = {}
        for spec in self.specs:
            sdoc = {"objective": spec.objective, "kind": spec.kind,
                    "windows": {}, "alerts": []}
            budget_err = spec.error_ratio(spec_view(self, spec),
                                          spec.budget_window_s, now=now)
            consumed = budget_err / spec.budget
            remaining = max(1.0 - consumed, 0.0)
            sdoc["error_budget_remaining"] = remaining
            sdoc["budget_window_error_ratio"] = budget_err
            self._g_budget.labels(slo=spec.name).set(remaining)
            for rule in spec.rules:
                b_long = spec.burn_rate(self.view, rule.long_s, now=now)
                b_short = spec.burn_rate(self.view, rule.short_s,
                                         now=now)
                self._g_burn.labels(
                    slo=spec.name,
                    window=f"{rule.long_s:g}s").set(b_long)
                self._g_burn.labels(
                    slo=spec.name,
                    window=f"{rule.short_s:g}s").set(b_short)
                sdoc["windows"][rule.key] = {
                    "burn_long": b_long, "burn_short": b_short,
                    "threshold": rule.burn}
                cond = b_long >= rule.burn and b_short >= rule.burn
                st = self._states[(spec.name, rule.key)]
                if cond and not st.firing:
                    st.firing = True
                    st.fired_at = now
                    st.fire_count += 1
                    self._emit({"event": "fire", "slo": spec.name,
                                "severity": rule.severity,
                                "rule": rule.key, "t": now,
                                "burn_long": b_long,
                                "burn_short": b_short,
                                "threshold": rule.burn})
                elif st.firing and not cond:
                    st.firing = False
                    self._emit({"event": "resolve", "slo": spec.name,
                                "severity": rule.severity,
                                "rule": rule.key, "t": now,
                                "fired_at": st.fired_at,
                                "burn_long": b_long,
                                "burn_short": b_short,
                                "threshold": rule.burn})
                if st.firing:
                    sdoc["alerts"].append(
                        {"severity": rule.severity, "rule": rule.key,
                         "fired_at": st.fired_at})
            results[spec.name] = sdoc
        with self._mu:
            self._evals += 1
            self._last_eval = now
            self._last_results = results
        return results

    def firing(self):
        """[{slo, severity, rule, fired_at}] currently-firing alerts."""
        with self._mu:
            out = []
            for (slo, rkey), st in self._states.items():
                if st.firing:
                    rule = next(r for s in self._specs
                                if s.name == slo
                                for r in s.rules if r.key == rkey)
                    out.append({"slo": slo, "severity": rule.severity,
                                "rule": rkey, "fired_at": st.fired_at})
            return out

    def alert_log(self, limit=None):
        with self._mu:
            events = list(self._alert_log)
        return events[-limit:] if limit else events

    def snapshot(self, evaluate=True):
        """The GET /slo document: spec configs, latest burn rates,
        currently-firing alerts, the bounded alert log."""
        if evaluate:
            self.evaluate()
        with self._mu:
            results = dict(getattr(self, "_last_results", {}))
            evals, last = self._evals, self._last_eval
        return {
            "specs": [s.to_dict() for s in self.specs],
            "evaluations": {"count": evals, "last_at": last,
                            "interval_s": self.eval_interval_s,
                            "view_snapshots": self.view.snapshots},
            "slos": results,
            "firing": self.firing(),
            "alert_log": self.alert_log(limit=64),
        }

    # -- background driver ---------------------------------------------
    def start(self, interval_s=None):
        """Arm the background eval loop (no-op at interval 0, or if
        already running). Returns self."""
        interval = (self.eval_interval_s if interval_s is None
                    else float(interval_s))
        if interval <= 0 or self._thread is not None:
            return self
        self.eval_interval_s = interval
        self._stop.clear()

        def loop():
            # evaluate immediately, then on the interval: starting the
            # engine yields a datapoint NOW, not one period later (and
            # short-lived arming windows still produce evaluations)
            while True:
                try:
                    self.evaluate()
                except Exception:      # pragma: no cover - guard rail
                    logger.exception("slo evaluation failed")
                if self._stop.wait(self.eval_interval_s):
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pt-slo-eval")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def spec_view(engine, spec):
    """The view a spec evaluates against (one shared view today; the
    indirection keeps per-spec views possible without an API break)."""
    del spec
    return engine.view


def default_serving_specs(availability_objective=None,
                          wire_threshold_s=None,
                          latency_objective=None,
                          freshness_window_s=None):
    """The gateway's shipped objectives (PT_FLAGS_slo_* defaults):

    * ``serving-availability`` — completed / terminal outcomes of
      `pt_serving_requests_total` (shed + cancelled requests are
      admission policy, not serving failures — they are excluded from
      the denominator; admission behaviour is a health-score signal);
    * ``wire-latency`` — fraction of `pt_gateway_wire_latency_s`
      window samples under the threshold;
    * ``generation-freshness`` — `pt_generation_total{field=tokens}`
      must advance whenever `pt_generation_slots_live` > 0.
    """
    if availability_objective is None:
        availability_objective = _flags.get_flag(
            "slo_availability_objective")
    if wire_threshold_s is None:
        wire_threshold_s = _flags.get_flag("slo_wire_p99_threshold_s")
    if latency_objective is None:
        latency_objective = _flags.get_flag("slo_latency_objective")
    terminal = ("completed", "failed", "timed_out")
    specs = [
        SloSpec("serving-availability", "availability",
                availability_objective,
                good=("pt_serving_requests_total",
                      {"outcome": "completed"}),
                total=("pt_serving_requests_total",
                       {"outcome": terminal}),
                min_events=4),
        SloSpec("wire-latency", "latency", latency_objective,
                histogram="pt_gateway_wire_latency_s",
                threshold_s=wire_threshold_s, min_events=4),
        SloSpec("generation-freshness", "freshness", 0.99,
                progress=("pt_generation_total", {"field": "tokens"}),
                active="pt_generation_slots_live",
                rules=(BurnRule(long_s=freshness_window_s or 10.0,
                                short_s=2.0, burn=1.0,
                                severity="page"),)),
    ]
    return specs
