"""Profiler — compat shim over `paddle_tpu_torch.observability`.

Counterpart of paddle_tpu/utils/profiler.py (the reference's
platform/profiler.h:81 RecordEvent and fluid/profiler.py's
start/stop_profiler :129-171, profiler context :228). On the card the
device timeline comes from `torch.profiler` (CUPTI); a `RecordEvent`
opens a span with `annotate=True`, which is a
`torch.profiler.record_function` range (and an NVTX range), so host
ranges nest into the same trace as the kernels they launch.

* `RecordEvent(name)` — a span plus one (name, start, end) row in a
  bounded host event ring (`_MAX_EVENTS`, FIFO eviction).
* `log_counters(name, values)` / `counters()` — scalar counter series,
  mirrored into the registry (`pt_profiler_counter{series,field}`) and
  the flight recorder.
* `start_profiler()` / `stop_profiler()` / `profiler()` — one
  `torch.profiler.profile` over CPU and (when present) CUDA activity;
  stopping writes its Chrome trace under `profile_path`.
* `summary()`, `print_summary()` — host events aggregated by name.
* `export_chrome_trace(path)` — the tracer's spans (RecordEvent ranges
  among them) and the profile's captures and executable runs on one
  timeline.
"""
import collections
import contextlib
import os
import tempfile
import time

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import recorder as _obs_recorder
from paddle_tpu_torch.observability import trace as _obs_trace

__all__ = ["RecordEvent", "start_profiler", "stop_profiler", "profiler",
           "host_events", "log_counters", "counters", "reset_profiler",
           "summary", "print_summary", "export_chrome_trace"]

#: host event log bound: a ring, not a leak
_MAX_EVENTS = 65536

_mu = make_lock("profiler.shim")
_events = collections.deque(maxlen=_MAX_EVENTS)  # (name, start, end)
_counters = {}  # series -> dict of scalar counters
_session = []   # the running torch.profiler.profile, if any


def _counter_gauge():
    return _obs_metrics.registry().gauge(
        "pt_profiler_counter",
        "log_counters series mirrored from utils.profiler",
        labels=("series", "field"))


class RecordEvent:
    """platform/profiler.h:81 analogue; a context manager. The range is a
    child span of the current trace, annotated into torch.profiler's
    timeline."""

    def __init__(self, name):
        self.name = name
        self._span = None
        self.start = None

    def __enter__(self):
        self.start = time.perf_counter()
        self._span = _obs_trace.start_span(self.name, annotate=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._span is not None:
            self._span.finish(error=exc)
            self._span = None
        with _mu:
            _events.append((self.name, self.start, time.perf_counter()))


def _default_dir():
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile")


def start_profiler(log_dir=None):
    """EnableProfiler analogue (profiler.h:166): start one
    torch.profiler session (CPU, and CUDA when a card is present)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with _mu:
        if _session:
            raise RuntimeError("the profiler is already running")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _session.append((prof, log_dir or _default_dir()))


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop the session and write its Chrome trace
    (`<profile_path>/torch_trace.json`); returns the path, or None when
    no session ran."""
    with _mu:
        if not _session:
            return None
        prof, log_dir = _session.pop()
    prof.__exit__(None, None, None)
    out_dir = profile_path or log_dir
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "torch_trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    """fluid.profiler.profiler context parity (profiler.py:228)."""
    start_profiler(profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def host_events():
    with _mu:
        return list(_events)


def log_counters(name, values):
    """Merge a dict of scalar counters into series `name`, mirror each
    field into the registry and record the delta in the flight
    recorder."""
    values = dict(values)
    with _mu:
        _counters.setdefault(name, {}).update(values)
    gauge = _counter_gauge()
    for field, v in values.items():
        try:
            gauge.labels(series=name, field=field).set(float(v))
        except (TypeError, ValueError):
            pass          # non-numeric payloads stay local-only
    _obs_recorder.flight_recorder().record_counters(name, values)


def counters(name=None):
    with _mu:
        if name is not None:
            return dict(_counters.get(name, {}))
        return {k: dict(v) for k, v in _counters.items()}


def reset_profiler():
    with _mu:
        _events.clear()
        _counters.clear()


def summary():
    """Host events aggregated by name, the largest total first."""
    agg = {}
    for name, s, e in host_events():
        tot, cnt = agg.get(name, (0.0, 0))
        agg[name] = (tot + (e - s), cnt + 1)
    return {k: {"total_s": t, "calls": c, "avg_s": t / c}
            for k, (t, c) in sorted(agg.items(), key=lambda kv: -kv[1][0])}


def print_summary(sorted_key="total"):
    """The reference's printed profile report: one row per event."""
    rows = summary()
    key = {"total": "total_s", "calls": "calls", "ave": "avg_s",
           "avg": "avg_s"}.get(sorted_key, "total_s")
    order = sorted(rows.items(), key=lambda kv: -kv[1][key])
    print(f"{'Event':<40} {'Calls':>8} {'Total(s)':>12} {'Avg(s)':>12}")
    for name, r in order:
        print(f"{name:<40} {r['calls']:>8} {r['total_s']:>12.6f} "
              f"{r['avg_s']:>12.6f}")
    return rows


def export_chrome_trace(path):
    """Write the host timeline (spans, RecordEvent ranges, captures and
    executable runs) as Chrome trace-event JSON; the device timeline is
    stop_profiler()'s trace."""
    from paddle_tpu_torch.observability import profile as _obs_profile
    return _obs_trace.export_chrome_trace(
        path, extra_events=_obs_profile.chrome_events())
