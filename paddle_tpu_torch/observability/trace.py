"""Request-scoped tracing: spans with parent contexts.

Counterpart of the span core of paddle_tpu/observability/trace.py, as
the generation server uses it: `serving.generate` per request and
`serving.decode_step` per tick, each parented under the request's trace
context (a Span or SpanContext carried on the request; None roots a new
trace). A span keeps its parent as an object reference and materializes
its 64-bit ids lazily; finishing it records it into the tracer's bounded
buffer. The reference's context-variable scopes, wire serialization,
device annotation and Chrome-trace export wait for the port's
observability slice.
"""
import collections
import os
import random
import threading
import time

from paddle_tpu_torch.analysis.concurrency import make_lock

__all__ = ["Span", "SpanContext", "Tracer", "get_tracer", "start_span",
           "set_enabled"]

_clock = time.perf_counter
_tls = threading.local()


def _new_id():
    """64-bit random id from a per-thread PRNG seeded from os.urandom."""
    gr = getattr(_tls, "gr", None)
    if gr is None:
        gr = _tls.gr = random.Random(
            int.from_bytes(os.urandom(16), "little")).getrandbits
    return gr(64)


class SpanContext:
    """The (trace_id, span_id) pair a child span parents under."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}/{self.span_id})"


_id_mu = make_lock("trace.ids")


class Span:
    """One timed range in a trace tree. Not reusable; finish() once."""

    __slots__ = ("name", "start", "end", "attrs", "parent", "_span_id",
                 "_trace_id", "_tracer")

    def __init__(self, tracer, name, parent, attrs=None):
        self._tracer = tracer
        self.name = name
        self.parent = parent          # Span | SpanContext | None
        self._span_id = None
        self._trace_id = None
        self.attrs = attrs if attrs is not None else {}
        self.start = _clock()
        self.end = None

    @property
    def span_id(self):
        sid = self._span_id
        if sid is None:
            with _id_mu:
                if self._span_id is None:
                    self._span_id = _new_id()
                sid = self._span_id
        return sid

    @property
    def trace_id(self):
        tid = self._trace_id
        if tid is None:
            p = self.parent
            # root: the trace is named by its root span's id
            tid = self.span_id if p is None else p.trace_id
            self._trace_id = tid
        return tid

    @property
    def parent_id(self):
        p = self.parent
        return None if p is None else p.span_id

    def set_attribute(self, key, value):
        self.attrs[key] = value
        return self

    def finish(self, error=None):
        """End the span (idempotent). `error` lands in attrs["error"]."""
        if self.end is not None:
            return self
        if error is not None:
            self.attrs["error"] = str(error)[:200]
        self.end = _clock()
        self._tracer._finished.append(self)
        return self

    @property
    def duration_s(self):
        return None if self.end is None else self.end - self.start


class _NoopSpan:
    """Returned while tracing is disabled; a noop parent suppresses its
    whole subtree."""

    __slots__ = ()
    name = "noop"
    trace_id = span_id = parent_id = parent = None
    start = end = None

    def set_attribute(self, key, value):
        return self

    def finish(self, error=None):
        return self


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span factory + bounded retention of finished spans."""

    def __init__(self, max_spans=65536):
        self._finished = collections.deque(maxlen=int(max_spans))
        self.enabled = True

    def start_span(self, name, parent=None, attrs=None):
        """Begin a span under `parent` (a Span or SpanContext; None roots
        a new trace). The caller owns finish()."""
        if not self.enabled or isinstance(parent, _NoopSpan):
            return _NOOP_SPAN
        if parent is not None and not isinstance(parent,
                                                 (Span, SpanContext)):
            raise TypeError(f"cannot parent a span under {parent!r}")
        return Span(self, name, parent, attrs)

    def finished_spans(self):
        """Finished spans, oldest first."""
        return list(self._finished)

    def reset(self):
        self._finished.clear()


_default = Tracer()


def get_tracer():
    return _default


def start_span(name, parent=None, attrs=None):
    return _default.start_span(name, parent=parent, attrs=attrs)


def set_enabled(enabled):
    _default.enabled = bool(enabled)
