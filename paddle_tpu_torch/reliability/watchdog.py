"""Hung-step watchdog: progress deadline + stack/counter dump.

Counterpart of paddle_tpu/reliability/watchdog.py:

* `beat()` marks progress on a **monotonic** clock; `check()` (or the
  background thread) compares `now - last_beat` against the deadline;
* a stall produces a diagnosis first — per-thread stack dump
  (`sys._current_frames`), `utils.profiler.counters()`, and a flight-
  recorder dump flushed to disk (`observability.recorder`, the still
  open spans among its events) whose path the StallReport carries —
  then acts: ``mode="abort"`` hard-kills the process through
  `os._exit` (training: a restart under the supervisor beats a wedged
  worker), ``mode="event"`` records the stall and lets cooperative
  callers fail the step (serving), ``mode="callback"`` hands the report
  to `on_stall`;
* per-step timings feed straggler detection: `step_stats()` reports
  p50/p90/max and flags steps slower than `straggler_factor x p50`.

The FSM (IDLE -> ARMED -> STALLED, beat resets the deadline) takes an
injectable clock, so its transitions are testable without threads or
real waiting; the thread only drives `check()` in production.
"""
import os
import sys
import threading
import time
import traceback

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.utils import profiler

__all__ = ["HungStepError", "Watchdog", "StallReport"]


class HungStepError(RuntimeError):
    """Raised by cooperative callers when the watchdog declared a stall
    (serving path: fail the step instead of wedging the caller)."""

    def __init__(self, report):
        super().__init__(
            f"no progress beat within {report.deadline:.3f}s "
            f"(last activity: {report.tag!r})")
        self.report = report


class StallReport:
    """What the watchdog knows at the moment it declares a stall."""

    def __init__(self, deadline, tag, silent_for, stacks, counters,
                 step_stats, flight_dump=None):
        self.deadline = deadline
        self.tag = tag
        self.silent_for = silent_for
        self.stacks = stacks          # {thread_name: [frame lines]}
        self.counters = counters      # profiler.counters() snapshot
        self.step_stats = step_stats
        self.flight_dump = flight_dump  # path of the flight-recorder dump

    def format(self):
        lines = [
            "=" * 64,
            f"WATCHDOG: no progress for {self.silent_for:.3f}s "
            f"(deadline {self.deadline:.3f}s, last beat tag "
            f"{self.tag!r})",
            "-" * 64,
        ]
        for name, frames in self.stacks.items():
            lines.append(f"-- thread {name}:")
            lines.extend("   " + ln for ln in frames)
        if self.counters:
            lines.append("-- profiler counters:")
            for cname, vals in sorted(self.counters.items()):
                lines.append(f"   {cname}: {vals}")
        if self.step_stats:
            lines.append(f"-- step timings: {self.step_stats}")
        if self.flight_dump:
            lines.append(f"-- flight recorder dump: {self.flight_dump}")
        lines.append("=" * 64)
        return "\n".join(lines)


def _dump_flight(report):
    """Flush the flight recorder next to the stall diagnosis (best
    effort — a broken disk must not mask the stall itself). The dump
    carries recent spans/counter deltas AND the still-open spans, so the
    operation that hung is visible by name, not just by stack."""
    try:
        from paddle_tpu_torch.observability import recorder as _rec
        return _rec.flight_recorder().dump(
            reason="watchdog_stall",
            extra={"tag": report.tag,
                   "silent_for_s": round(report.silent_for, 3),
                   "deadline_s": report.deadline})
    except Exception:                  # pragma: no cover - guard rail
        return None


def _thread_stacks():
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, '?')} (ident {ident})"
        out[label] = [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
    return out


class Watchdog:
    """Progress watchdog armed around training steps / PS verbs.

    >>> wd = Watchdog(deadline=30.0, mode="abort").start()
    >>> for step in range(n):
    ...     with wd.watch(f"step-{step}"):
    ...         run_step()
    >>> wd.stop()

    `watch()` beats on entry and exit and records the step duration for
    straggler stats. The FSM alone (``arm``/``beat``/``check``) is
    usable without the thread — that is what the fake-clock tests and
    cooperative serving callers drive.
    """

    def __init__(self, deadline, mode="abort", on_stall=None,
                 interval=None, clock=time.monotonic,
                 straggler_factor=3.0, stream=None, abort_code=134):
        enforce(deadline > 0, "watchdog deadline must be > 0 seconds")
        enforce(mode in ("abort", "event", "callback"),
                "watchdog mode must be abort|event|callback")
        if mode == "callback":
            enforce(on_stall is not None, "mode='callback' needs on_stall")
        self.deadline = float(deadline)
        self.mode = mode
        self.on_stall = on_stall
        self.interval = float(interval) if interval else \
            max(0.05, self.deadline / 4.0)
        self.clock = clock
        self.straggler_factor = float(straggler_factor)
        self.stream = stream          # defaults to sys.stderr at dump time
        self.abort_code = int(abort_code)
        self._armed = False
        self._last_beat = None
        self._tag = None
        self._mu = make_lock("watchdog.state")
        self._stop = threading.Event()
        self._thread = None
        self._durations = []
        self.stalled = None           # StallReport once a stall fired

    # -- FSM (fake-clock testable; no thread required) ------------------
    def arm(self, tag=None):
        with self._mu:
            self._armed = True
            self._last_beat = self.clock()
            self._tag = tag

    def beat(self, tag=None):
        """Progress happened: reset the deadline."""
        with self._mu:
            self._last_beat = self.clock()
            if tag is not None:
                self._tag = tag

    def disarm(self):
        with self._mu:
            self._armed = False

    def check(self):
        """One FSM tick: returns None (idle/on-time) or the StallReport
        when the deadline has passed without a beat. Firing is
        edge-triggered — a declared stall disarms the watchdog."""
        with self._mu:
            if not self._armed or self._last_beat is None:
                return None
            silent = self.clock() - self._last_beat
            if silent <= self.deadline:
                return None
            self._armed = False       # edge-trigger
            tag = self._tag
        report = StallReport(self.deadline, tag, silent,
                             _thread_stacks(), profiler.counters(),
                             self.step_stats())
        report.flight_dump = _dump_flight(report)
        self.stalled = report
        self._handle(report)
        return report

    def _handle(self, report):
        stream = self.stream or sys.stderr
        try:
            stream.write(report.format() + "\n")
            stream.flush()
        except Exception:
            pass
        profiler.log_counters("watchdog", {
            "stalls": 1, "silent_for_s": round(report.silent_for, 3)})
        # monotonic stall counter: the health scorer's windowed stall
        # signal and the /metrics series alerting keys on
        try:
            from paddle_tpu_torch.observability import metrics as _metrics
            _metrics.registry().counter(
                "pt_watchdog_stalls_total",
                "watchdog stall declarations").inc()
        except Exception:              # pragma: no cover - guard rail
            pass
        if self.mode == "callback":
            self.on_stall(report)
        elif self.mode == "abort":
            # dump landed above; die hard (no atexit, no finally — a
            # wedged thread may hold any lock, the card's stream among
            # them). The supervisor's restart beats a wedged trainer.
            # 134 = SIGABRT-style code.
            os._exit(self.abort_code)
        # mode == "event": self.stalled is the record; cooperative
        # callers raise HungStepError(self.stalled) when they see it

    # -- step timing / stragglers ---------------------------------------
    def watch(self, tag=None):
        """Context manager around one step: beats on entry + exit and
        records the duration for straggler stats."""
        return _WatchScope(self, tag)

    def record_duration(self, seconds):
        with self._mu:
            self._durations.append(float(seconds))

    def step_stats(self):
        """p50/p90/max over recorded step durations plus the indices of
        straggler steps (> straggler_factor x p50)."""
        with self._mu:
            durs = list(self._durations)
        if not durs:
            return {}
        s = sorted(durs)

        def pct(p):
            return s[min(len(s) - 1, int(p * (len(s) - 1)))]

        p50 = pct(0.5)
        stragglers = [i for i, d in enumerate(durs)
                      if p50 > 0 and d > self.straggler_factor * p50]
        return {"steps": len(durs), "p50_s": p50, "p90_s": pct(0.9),
                "max_s": s[-1], "stragglers": stragglers}

    def raise_if_stalled(self):
        """Cooperative failure for the serving path (mode='event')."""
        if self.stalled is not None:
            raise HungStepError(self.stalled)

    # -- background driver ----------------------------------------------
    def start(self):
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self.check()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pt-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self.disarm()
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def __enter__(self):
        self.start()
        self.arm()
        return self

    def __exit__(self, *exc):
        self.stop()


class _WatchScope:
    def __init__(self, wd, tag):
        self.wd = wd
        self.tag = tag

    def __enter__(self):
        self.wd.arm(self.tag)
        self._t0 = self.wd.clock()
        return self

    def __exit__(self, *exc):
        self.wd.record_duration(self.wd.clock() - self._t0)
        self.wd.beat(self.tag)
        return False
