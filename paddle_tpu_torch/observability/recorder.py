"""Crash-dump flight recorder: a bounded ring of recent observability
events, flushable to disk at the moment something dies.

A copy of paddle_tpu/observability/recorder.py (`FlightRecorder` :43),
with the port's imports: counter deltas (`utils.profiler.log_counters`),
compile records (`observability.profile`'s ledger) and notes land in a
fixed-capacity ring (FIFO eviction, the evicted count kept); recent
finished spans come from the tracer's own bounded buffer at read time
and merge into snapshots by timestamp. `dump(path)` flushes the ring and
the tracer's still-open spans as one JSON document.

Dump destination (`default_dump_path`): the exact path in
``PT_FLIGHT_DUMP`` if set, else a fresh file under ``PT_FLIGHT_DIR`` (or
the system tempdir).
"""
import collections
import itertools
import json

from paddle_tpu_torch.analysis.concurrency import guarded_by, make_lock
import os
import tempfile
import time

__all__ = ["FlightRecorder", "flight_recorder", "default_dump_path"]

_clock = time.perf_counter


class FlightRecorder:
    """Bounded ring buffer of recent spans / counter deltas / notes.

    Producers stay O(1): one short lock around the deque append + seq
    draw. The lock exists for the CONSUMERS — `list(self._ring)` during
    a concurrent append dies with "deque mutated during iteration", and
    `clear()` swapping the seq counter under a racing producer could
    hand out stale sequence numbers — exactly the dump()-under-load
    crash the armed concurrency detector flagged. `evicted` derives
    from the newest seq vs the ring length instead of a second guarded
    counter."""

    def __init__(self, capacity=4096):
        self.capacity = int(capacity)
        self._mu = make_lock("recorder.ring")
        self._ring = collections.deque(maxlen=self.capacity)  # guarded_by(_mu)
        self._count = itertools.count(1)
        guarded_by(self, "_ring", "recorder.ring")

    # -- producers ------------------------------------------------------
    def record(self, kind, **fields):
        """Append one event. O(1); FIFO eviction when full."""
        evt = {"kind": kind, "t": _clock()}
        evt.update(fields)
        with self._mu:
            evt["seq"] = next(self._count)
            self._ring.append((evt["seq"], evt))
        return evt

    def record_span(self, span):
        """Ring one span explicitly (the tracer's finished buffer is
        merged into snapshots automatically; this is for pinning a
        specific span into the ring, e.g. from tests). The object is
        ringed as-is and serialized lazily at snapshot() time."""
        with self._mu:
            self._ring.append((next(self._count), span))

    def record_counters(self, series, values):
        """One counter-delta event (profiler.log_counters rides this)."""
        self.record("counters", series=series, values=dict(values))

    def note(self, message, **fields):
        """Free-form annotation ("swap committed", "SIGTERM")."""
        self.record("note", message=str(message), **fields)

    # -- consumers ------------------------------------------------------
    def snapshot(self, include_spans=True):
        """Events oldest → newest, serialized to plain dicts. Ring
        events (counter deltas, notes) merge with the tracer's recent
        finished spans by timestamp — span serialization happens here,
        off the hot path."""
        with self._mu:
            entries = list(self._ring)
        from paddle_tpu_torch.observability.trace import (
            _thread_names, get_tracer,
        )
        names = _thread_names()

        def span_evt(sp, seq=None):
            evt = sp.to_dict(thread_names=names)
            evt["kind"] = "span"
            evt["t"] = sp.end
            evt["seq"] = seq
            return evt

        out = []
        for seq, item in entries:
            out.append(dict(item) if isinstance(item, dict)
                       else span_evt(item, seq))
        if include_spans:
            out.extend(span_evt(sp) for sp in
                       get_tracer().recent_spans(limit=self.capacity))
        out.sort(key=lambda e: e.get("t") or 0.0)
        return out

    @property
    def evicted(self):
        """Events lost to FIFO eviction (newest seq minus retained)."""
        with self._mu:
            entries = list(self._ring)
        if not entries:
            return 0
        return max(entries[-1][0] - len(entries), 0)

    def clear(self):
        with self._mu:
            self._ring.clear()
            self._count = itertools.count(1)

    def dump(self, path=None, reason="manual", extra=None):
        """Flush the ring + the tracer's open spans to `path` (resolved
        via default_dump_path when None) as one JSON document. Returns
        the path written. Atomic (tmp + rename) so a crash mid-dump
        never leaves a torn file where a post-mortem expects JSON."""
        from paddle_tpu_torch.observability import trace as _trace
        if path is None:
            path = default_dump_path(reason)
        doc = {
            "artifact": "pt_flight_recorder",
            "reason": reason,
            "pid": os.getpid(),
            "wall_time": time.time(),  # wallclock-ok: a wall stamp
            "monotonic": _clock(),
            "capacity": self.capacity,
            "evicted": self.evicted,
            "events": self.snapshot(),
            "active_spans": _trace.get_tracer().active_spans(),
        }
        if extra:
            doc["extra"] = extra
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def default_dump_path(reason="dump"):
    """Where a crash dump goes: PT_FLIGHT_DUMP (exact file — the elastic
    supervisor sets one per worker incarnation) > PT_FLIGHT_DIR > the
    system tempdir."""
    exact = os.environ.get("PT_FLIGHT_DUMP")
    if exact:
        return exact
    base = os.environ.get("PT_FLIGHT_DIR") or tempfile.gettempdir()
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(
        base, f"pt-flight-{reason}-{os.getpid()}-{stamp}.json")


_default = FlightRecorder()


def flight_recorder():
    """The process-wide recorder the tracer and profiler shims feed."""
    return _default
