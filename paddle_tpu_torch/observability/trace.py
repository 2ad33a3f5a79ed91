"""Request-scoped tracing: spans with parent contexts.

Counterpart of paddle_tpu/observability/trace.py:

* **Span** — a name, `time.perf_counter` start and end, scalar
  attributes, and its parent kept as an object reference (another Span,
  or a SpanContext received over a wire); the 64-bit ids materialize
  lazily, at serialization only. Finishing a span records it into the
  tracer's bounded buffer, which the flight recorder
  (observability/recorder.py) reads at dump time.
* **Scopes** — the current span lives in a `contextvars` ContextVar, so
  nested `span(...)` blocks parent correctly per thread and task.
  `start_span(parent=None)` parents under the current span, or roots a
  new trace outside any scope. A worker thread that serves another
  thread's request carries the parent explicitly (`parent=`) or
  re-enters it with `attach(ctx)`.
* **Wire** — `context_to_dict` / `context_from_dict` turn a context into
  the 16-hex JSON pair the reference's wire headers carry.
* **Device annotation** — `span(..., annotate=True)` also opens a
  `torch.profiler.record_function` range (and an NVTX range on a CUDA
  build), so the host range nests into torch.profiler's device trace as
  `jax.profiler.TraceAnnotation` nests into the XPlane trace.
* **Export** — `export_chrome_trace(path, extra_events=)` writes
  Perfetto-loadable Chrome trace-event JSON; `observability.profile`'s
  `chrome_events()` adds captures and executable runs on the same
  perf_counter timebase.

`finished_spans()` returns the Span objects themselves (the port's
serving tests read their parents); `finished_span_dicts()` gives the
JAX package's dict form.
"""
import collections
import contextlib
import contextvars
import json
import os
import random
import threading
import time

from paddle_tpu_torch.analysis.concurrency import make_lock

__all__ = [
    "Span", "SpanContext", "Tracer", "get_tracer", "span", "start_span",
    "attach", "current_context", "context_to_dict", "context_from_dict",
    "set_enabled", "is_enabled", "export_chrome_trace", "reset_tracer",
    "format_id", "noop_span",
]

_clock = time.perf_counter
_tls = threading.local()


def _new_id():
    """64-bit random id from a per-thread PRNG seeded from os.urandom."""
    gr = getattr(_tls, "gr", None)
    if gr is None:
        gr = _tls.gr = random.Random(
            int.from_bytes(os.urandom(16), "little")).getrandbits
    return gr(64)


def _fmt_id(i):
    """id -> wire/export form (ints format to 16 hex digits; wire-received
    string ids pass through)."""
    return f"{i:016x}" if isinstance(i, int) else i


def _parse_id(v):
    """Wire form -> internal id (hex strings parse to int; None or
    garbage -> None)."""
    if isinstance(v, int):
        return v
    if isinstance(v, str) and v:
        try:
            return int(v, 16)
        except ValueError:
            return None
    return None


class SpanContext:
    """The (trace_id, span_id) pair a child span parents under."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}/{self.span_id})"


_id_mu = make_lock("trace.ids")


class _Annotation:
    """A torch.profiler range (record_function) and, where CUDA is
    built in, an NVTX range around one span."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name):
        import torch
        self._rf = torch.profiler.record_function(name)
        self._rf.__enter__()
        self._nvtx = False
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            self._nvtx = True

    def close(self):
        if self._nvtx:
            import torch
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(None, None, None)


class Span:
    """One timed range in a trace tree. Not reusable; finish() once."""

    __slots__ = ("name", "start", "end", "attrs", "thread_ident", "parent",
                 "_span_id", "_trace_id", "_tracer", "_ann", "_amap")

    def __init__(self, tracer, name, parent, attrs=None):
        self._tracer = tracer
        self.name = name
        self.parent = parent          # Span | SpanContext | None
        self._span_id = None
        self._trace_id = None
        self.attrs = attrs if attrs is not None else {}
        self.thread_ident = threading.get_ident()
        self.start = _clock()
        self.end = None
        self._ann = None
        self._amap = None

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

    def context(self):
        """The handle a child parents under: the span itself."""
        return self

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
        if self._ann is not None:
            self._ann.close()
            self._ann = None
        self._tracer._record_finished(self)
        return self

    @property
    def duration_s(self):
        return None if self.end is None else self.end - self.start

    def to_dict(self, thread_names=None):
        names = (thread_names if thread_names is not None
                 else _thread_names())
        return {
            "name": self.name,
            "trace_id": _fmt_id(self.trace_id),
            "span_id": _fmt_id(self.span_id),
            "parent_id": (None if self.parent_id is None
                          else _fmt_id(self.parent_id)),
            "start": self.start,
            "end": self.end,
            "thread": names.get(self.thread_ident, str(self.thread_ident)),
            "attrs": dict(self.attrs),
        }


def _thread_names():
    """ident -> name for live threads (dead threads keep the ident)."""
    return {t.ident: t.name for t in threading.enumerate()}


class _NoopSpan:
    """Returned while tracing is disabled; a noop parent suppresses its
    whole subtree."""

    __slots__ = ()
    name = "noop"
    trace_id = span_id = parent_id = parent = None
    start = end = None
    attrs = {}

    def context(self):
        return self

    def set_attribute(self, key, value):
        return self

    def finish(self, error=None):
        return self

    def to_dict(self, thread_names=None):
        return {}


_NOOP_SPAN = _NoopSpan()

_current = contextvars.ContextVar("pt_trace_ctx", default=None)


class Tracer:
    """Span factory + bounded retention of finished and active spans.
    Active spans sit in per-thread dicts (each mutated only by its own
    thread) registered once under the lock."""

    def __init__(self, max_spans=65536):
        self._mu = make_lock("trace.tracer")
        self._finished = collections.deque(maxlen=int(max_spans))
        self._actives = []            # [(thread ident, per-thread dict)]
        self._tls = threading.local()
        self.enabled = True

    def _active_map(self):
        m = getattr(self._tls, "active", None)
        if m is None:
            m = self._tls.active = {}
            with self._mu:
                live = {t.ident for t in threading.enumerate()}
                self._actives = [(i, d) for i, d in self._actives
                                 if i in live]
                self._actives.append((threading.get_ident(), m))
        return m

    def start_span(self, name, parent=None, attrs=None, annotate=False):
        """Begin a span under `parent` (a Span, SpanContext or wire dict;
        None parents under the calling context's current span, or roots
        a new trace). The caller owns finish()."""
        if not self.enabled or isinstance(parent, _NoopSpan):
            return _NOOP_SPAN
        if parent is None:
            ctx = _current.get()
        else:
            ctx = _coerce_context(parent)
            if ctx is None:
                ctx = _current.get()
        sp = Span(self, name, ctx, attrs)
        if annotate:
            sp._ann = _Annotation(name)
        m = self._active_map()
        sp._amap = m
        m[id(sp)] = sp
        return sp

    def _record_finished(self, sp):
        if sp._amap is not None:
            sp._amap.pop(id(sp), None)
            sp._amap = None
        self._finished.append(sp)

    def span(self, name, parent=None, attrs=None, annotate=False):
        """Context manager: starts a span, makes it the current context
        for the body, finishes it on exit (the exception type as its
        error attribute)."""
        return _SpanScope(self, name, parent, attrs, annotate)

    @contextlib.contextmanager
    def attach(self, ctx):
        """Re-enter a propagated context (a worker thread attaches the
        request's context before creating child spans)."""
        ctx = _coerce_context(ctx)
        if ctx is None:
            yield
            return
        token = _current.set(ctx)
        try:
            yield
        finally:
            _current.reset(token)

    def finished_spans(self):
        """Finished Span objects, oldest first."""
        return list(self._finished)

    def recent_spans(self, limit=None):
        spans = list(self._finished)
        if limit is not None and len(spans) > limit:
            spans = spans[-limit:]
        return spans

    def finished_span_dicts(self, trace_id=None):
        spans = list(self._finished)
        if trace_id is not None:
            tid = _parse_id(trace_id)
            spans = [s for s in spans if s.trace_id == tid]
        names = _thread_names()
        return [s.to_dict(thread_names=names) for s in spans]

    def active_spans(self):
        """Open (unfinished) spans as dicts."""
        with self._mu:
            maps = list(self._actives)
        names = _thread_names()
        return [sp.to_dict(thread_names=names)
                for _ident, m in maps for sp in list(m.values())]

    def reset(self):
        self._finished.clear()
        with self._mu:
            for _ident, m in self._actives:
                m.clear()

    def export_chrome_trace(self, path, extra_events=()):
        """Write finished spans (plus `extra_events`, pre-shaped trace
        events) as Chrome trace-event JSON: one "X" event per span,
        parent and trace ids in args."""
        events = list(extra_events)
        pid = os.getpid()
        tids = {}
        for s in self.finished_span_dicts():
            tid = tids.setdefault(s["thread"], len(tids))
            args = {"trace_id": s["trace_id"], "span_id": s["span_id"]}
            if s["parent_id"]:
                args["parent_id"] = s["parent_id"]
            args.update(s["attrs"])
            events.append({
                "name": s["name"], "ph": "X", "pid": pid, "tid": tid,
                "ts": s["start"] * 1e6,
                "dur": ((s["end"] or s["start"]) - s["start"]) * 1e6,
                "cat": s["name"].split(".", 1)[0].split("/", 1)[0],
                "args": args,
            })
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"producer": "paddle_tpu_torch.observability",
                             "pid": pid}}
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path


class _SpanScope:
    """`with tracer.span(...) as sp:` — the span is the current context
    for the body and finishes on exit."""

    __slots__ = ("_tracer", "_name", "_parent", "_attrs", "_annotate",
                 "_span", "_token")

    def __init__(self, tracer, name, parent, attrs, annotate):
        self._tracer = tracer
        self._name = name
        self._parent = parent
        self._attrs = attrs
        self._annotate = annotate
        self._span = None
        self._token = None

    def __enter__(self):
        sp = self._tracer.start_span(self._name, parent=self._parent,
                                     attrs=self._attrs,
                                     annotate=self._annotate)
        self._span = sp
        if sp is not _NOOP_SPAN:
            self._token = _current.set(sp)
        return sp

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self._span.finish(error=None if exc_type is None
                          else f"{exc_type.__name__}: {exc}")
        return False


def _coerce_context(parent):
    if parent is None or isinstance(parent, (Span, SpanContext)):
        return parent
    if isinstance(parent, _NoopSpan):
        return None
    if isinstance(parent, dict):
        return context_from_dict(parent)
    raise TypeError(f"cannot parent a span under {parent!r}")


def context_to_dict(ctx):
    """SpanContext -> JSON-able dict (16-hex ids); None passes through."""
    if ctx is None:
        return None
    return {"trace_id": _fmt_id(ctx.trace_id),
            "span_id": _fmt_id(ctx.span_id)}


def context_from_dict(doc):
    """Wire dict -> SpanContext; garbage gives None, so a malformed trace
    field never fails a request."""
    if not isinstance(doc, dict):
        return None
    tid = _parse_id(doc.get("trace_id"))
    sid = _parse_id(doc.get("span_id"))
    if tid is None or sid is None:
        return None
    return SpanContext(tid, sid)


def _build_default():
    t = Tracer()
    t.enabled = os.environ.get("PT_TRACE_DISABLED", "0").lower() \
        not in ("1", "true", "yes")
    return t


_default = _build_default()


def get_tracer():
    return _default


def span(name, parent=None, attrs=None, annotate=False):
    return _default.span(name, parent=parent, attrs=attrs,
                         annotate=annotate)


def start_span(name, parent=None, attrs=None, annotate=False):
    return _default.start_span(name, parent=parent, attrs=attrs,
                               annotate=annotate)


def attach(ctx):
    return _default.attach(ctx)


def current_context():
    """The calling context's current span (None outside spans or while
    disabled)."""
    if not _default.enabled:
        return None
    return _current.get()


def set_enabled(enabled):
    _default.enabled = bool(enabled)


def is_enabled():
    return _default.enabled


def export_chrome_trace(path, extra_events=()):
    return _default.export_chrome_trace(path, extra_events=extra_events)


def format_id(i):
    return _fmt_id(i)


def noop_span():
    """The suppression sentinel: a span whose descendants are all noops
    (the gateway hands it to requests its head sampling leaves out)."""
    return _NOOP_SPAN


def reset_tracer():
    """Drop retained spans (tests); the enabled flag is preserved."""
    _default.reset()
