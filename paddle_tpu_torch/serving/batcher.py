"""Request queue + dynamic batcher.

Counterpart of paddle_tpu/serving/batcher.py. The reference serves
traffic by pinning one AnalysisPredictor clone per thread and leaves
batching to the caller. On the card a Predictor's Executor captures one
CUDA graph per feed signature (core/executor.py), and a replay of a
graph costs the same host time whatever its rows, so the server
coalesces concurrent single requests into padded, *bucketed* batches:

* bucket sizes are a fixed ladder (powers of two by default), so every
  batch lands on one of len(buckets) feed-shape signatures and the
  Executor holds exactly one captured entry per bucket — a bucket is
  captured once, ever (in `InferenceServer.warmup`, before traffic);
* a max-wait deadline bounds the latency cost of coalescing: the oldest
  queued request never waits more than `max_wait` for stragglers;
* the queue is bounded: when it is full, `put` raises QueueFullError
  instead of buffering without limit (shed load, don't OOM);
* per-request deadlines are enforced at batch-formation time — an
  expired request is completed with RequestTimeout and never occupies
  device time.

All timing goes through an injectable `clock` so tests drive the policy
with a fake clock, deterministically and threadless (see `poll`). The
error classes are shared with the generation server
(serving/generation.py).
"""
import collections
import heapq
import itertools
import threading
import time

import numpy as np

from paddle_tpu_torch.analysis.concurrency import (guarded_by, make_condition,
                                                   make_lock)
from paddle_tpu_torch.core.enforce import enforce


__all__ = ["ServingError", "QueueFullError", "Preempted",
           "RequestTimeout", "ServerClosed", "default_buckets", "Request",
           "Batch", "DynamicBatcher"]


class ServingError(Exception):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Backpressure rejection: the bounded request queue is full."""


class Preempted(QueueFullError):
    """The request was evicted from the queue to admit higher-priority
    traffic (gateway admission control) — a load-shed, so it subclasses
    QueueFullError and callers' shed/backoff handling applies."""


class RequestTimeout(ServingError):
    """The request's deadline passed before a result was produced."""


class ServerClosed(ServingError):
    """The server is shut down (or shutting down) and not accepting."""


def default_buckets(max_batch_size):
    """Power-of-two bucket ladder up to (and including) max_batch_size:
    8 -> [1, 2, 4, 8]; 12 -> [1, 2, 4, 8, 12]."""
    enforce(max_batch_size >= 1, "max_batch_size must be >= 1, got %s",
            max_batch_size)
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(int(max_batch_size))
    return sorted(set(out))


class Request:
    """One in-flight inference request: a feed dict of arrays sharing a
    leading batch axis, plus a future the caller waits on. `on_done`
    (set by the server) fires exactly once with the terminal error (or
    None on success) — that is where metrics accounting lives, so
    batcher-side expiry and shutdown rejection are counted too.

    Tracing: `trace_ctx` is the caller's SpanContext, carried explicitly
    because the batch executes on a worker thread that never saw the
    caller's contextvars. The pool opens a `serving.queue` span at
    submit (stored in `queue_span`) and closes it when the request
    leaves the queue — batch formation, expiry, shed or shutdown all
    end it exactly once (`end_queue_span` is idempotent and also runs
    from `_complete`, so no terminal path leaks an open span)."""

    def __init__(self, feed, enqueued_at, deadline=None, on_done=None,
                 priority=0, tenant=None, trace_ctx=None):
        self.feed = {n: np.asarray(a) for n, a in feed.items()}
        # gateway admission metadata: priority orders load-shedding
        # (preempt_lower evicts strictly-lower priorities under a full
        # queue); tenant is carried for accounting only
        self.priority = int(priority)
        self.tenant = tenant
        enforce(self.feed, "empty feed")
        rows = {a.shape[0] if a.ndim else None
                for a in self.feed.values()}
        enforce(len(rows) == 1 and None not in rows,
                "request feed arrays must share a leading batch axis, "
                "got shapes %s",
                {n: a.shape for n, a in self.feed.items()})
        self.rows = int(rows.pop())
        enforce(self.rows >= 1, "request has zero rows")
        self.enqueued_at = enqueued_at
        self.deadline = deadline
        self.on_done = on_done
        # fault-tolerance bookkeeping (serving/pool.py retry path):
        # attempts counts executions so retry is bounded; ready_at is
        # the backoff gate — the batcher will not take the request into
        # a batch before it (fresh requests are ready immediately)
        self.attempts = 0
        self.ready_at = enqueued_at
        self.trace_ctx = trace_ctx
        self.queue_span = None
        self._event = threading.Event()
        self._lock = make_lock("serving.request")
        self._result = None
        self._error = None
        self._completed = False

    def end_queue_span(self, error=None):
        """Close the queue-wait span exactly once (no-op if never
        opened or already closed)."""
        sp = self.queue_span
        if sp is not None:
            self.queue_span = None
            sp.finish(error=error)

    def _complete(self, result, error):
        with self._lock:
            if self._completed:
                return False
            self._completed = True
            self._result, self._error = result, error
        # a request completed while still queued (expiry/shed/shutdown)
        # closes its queue span here, with the terminal error attached
        self.end_queue_span(error=error)
        if self.on_done is not None:
            self.on_done(self, error)
        self._event.set()
        return True

    def set_result(self, result):
        return self._complete(result, None)

    def set_error(self, error):
        return self._complete(None, error)

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block for the per-request fetch list (output padding already
        removed). Raises RequestTimeout if no result lands in `timeout`
        seconds, or the server-side error if the request failed."""
        if not self._event.wait(timeout):
            raise RequestTimeout(
                f"no result within {timeout}s (request still queued or "
                f"executing)")
        if self._error is not None:
            raise self._error
        return self._result


class Batch:
    """A formed batch: FIFO requests totalling `rows` rows, padded up to
    `bucket` rows for execution."""

    def __init__(self, requests, bucket):
        self.requests = list(requests)
        self.bucket = int(bucket)
        self.rows = sum(r.rows for r in self.requests)
        enforce(0 < self.rows <= self.bucket,
                "batch rows %d outside bucket %d", self.rows, self.bucket)

    @property
    def occupancy(self):
        return self.rows / self.bucket

    def build_feed(self):
        """Concatenate per-feed arrays along axis 0 and pad to the bucket
        size by repeating the final row — replicated real rows keep every
        padded value in-distribution (zero padding can hit log(0)/division
        guards in real nets); padded outputs are sliced off in scatter."""
        feed = {}
        pad = self.bucket - self.rows
        for n in self.requests[0].feed:
            arr = np.concatenate([r.feed[n] for r in self.requests], axis=0)
            if pad:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
            feed[n] = arr
        return feed

    def scatter(self, outs):
        """Slice batch outputs back per request and complete each future.
        Every fetch must be batched along axis 0 (leading dim == bucket);
        a model whose fetch reduces over the batch cannot be served
        batched."""
        arrs = [np.asarray(o) for o in outs]
        for a in arrs:
            enforce(a.ndim >= 1 and a.shape[0] == self.bucket,
                    "fetch with shape %s is not batched along axis 0 "
                    "(expected leading dim %d) — this fetch list cannot "
                    "be dynamically batched", a.shape, self.bucket)
        off = 0
        for r in self.requests:
            r.set_result([a[off:off + r.rows] for a in arrs])
            off += r.rows

    def fail(self, error):
        for r in self.requests:
            r.set_error(error)


class DynamicBatcher:
    """Bounded FIFO request queue + batch-formation policy.

    Producers call `put`; worker threads block in `get_batch`. The policy
    itself is synchronous and clock-parameterised: `poll(now)` forms (or
    declines to form) a batch with no threads involved, which is what the
    deterministic tests drive.
    """

    def __init__(self, buckets, max_wait=0.002, max_queue=128,
                 clock=time.monotonic):
        self.buckets = sorted(set(int(b) for b in buckets))
        enforce(self.buckets and self.buckets[0] >= 1,
                "buckets must be positive ints, got %s", buckets)
        self.max_rows = self.buckets[-1]
        self.max_wait = float(max_wait)
        self.max_queue = int(max_queue)
        self._clock = clock
        self._cond = make_condition("serving.batcher")
        self._pending = collections.deque()  # guarded_by(_cond)
        self._pending_rows = 0               # guarded_by(_cond)
        # retry-backoff parking lot: requeued requests whose ready_at is
        # still in the future sit in a (ready_at, seq) min-heap instead
        # of the deque, so batch formation never scans ineligible
        # entries — eligibility is a heap-top pop, O(log n) per
        # promotion instead of O(n) per poll under load
        self._parked = []                    # guarded_by(_cond)
        self._park_seq = itertools.count()
        self._closed = False
        self._draining = False
        guarded_by(self, "_pending", "serving.batcher")

    # -- producer side -------------------------------------------------
    def put(self, request):
        """Enqueue or reject. Raises ServerClosed after close(),
        QueueFullError when the bounded queue is at capacity."""
        enforce(request.rows <= self.max_rows,
                "request rows %d exceed the largest bucket %d — split the "
                "request or enlarge the bucket ladder",
                request.rows, self.max_rows)
        with self._cond:
            if self._closed:
                raise ServerClosed("server is shut down")
            if len(self._pending) >= self.max_queue:
                raise QueueFullError(
                    f"request queue full ({self.max_queue} pending) — "
                    f"load shed, retry with backoff")
            self._pending.append(request)
            self._pending_rows += request.rows
            self._cond.notify()

    def requeue(self, requests):
        """Put already-accepted requests back at the FRONT of the queue
        (retry path, serving/pool.py): bypasses the max_queue bound —
        these requests were admitted once and must not be load-shed by
        their own retry — and is honoured while draining so a failed
        batch still completes during graceful shutdown. After a
        non-drain shutdown the retry is pointless: the requests are
        rejected like the rest of the queue was.

        A request whose backoff gate (`ready_at`) is still in the
        future parks in the eligibility heap and rejoins the queue
        FRONT when the gate opens (`_promote`); one that is already
        eligible goes straight to the front."""
        requests = list(requests)
        rejected = []
        with self._cond:
            if self._closed and not self._draining:
                rejected = requests
            else:
                now = self._clock()
                for r in reversed(requests):
                    if r.ready_at > now:
                        heapq.heappush(
                            self._parked,
                            (r.ready_at, next(self._park_seq), r))
                    else:
                        self._pending.appendleft(r)
                        self._pending_rows += r.rows
                self._cond.notify_all()
        for r in rejected:
            r.set_error(ServerClosed("server shut down before retry"))

    def _promote(self, now):  # holds(_cond)
        """Move every parked request whose backoff gate has opened to
        the queue FRONT (earliest-ready frontmost — they were admitted
        before anything still queued). Lock held by the caller."""
        if not self._parked or self._parked[0][0] > now:
            return
        matured = []
        while self._parked and self._parked[0][0] <= now:
            matured.append(heapq.heappop(self._parked)[2])
        self._pending.extendleft(reversed(matured))
        self._pending_rows += sum(r.rows for r in matured)

    def preempt_lower(self, priority):
        """Evict the NEWEST pending request with priority strictly below
        `priority` to make room under a full queue (gateway priority
        preemption). Newest-first keeps the eviction cheapest in sunk
        queue time; FIFO order among survivors is untouched. Returns the
        evicted request (already completed with `Preempted`) or None."""
        victim = None
        with self._cond:
            for r in reversed(self._pending):
                if r.priority < priority:
                    victim = r
                    break
            if victim is not None:
                self._pending.remove(victim)
                self._pending_rows -= victim.rows
            elif self._parked:
                # no queued victim: a parked (backoff-gated) retry is
                # still sunk queue time — evict the newest-parked one
                for e in sorted(self._parked, key=lambda e: -e[1]):
                    if e[2].priority < priority:
                        victim = e[2]
                        self._parked.remove(e)
                        heapq.heapify(self._parked)
                        break
        if victim is not None:
            victim.set_error(Preempted(
                f"evicted from the queue by priority-{priority} traffic "
                f"(own priority {victim.priority})"))
        return victim

    def bucket_for(self, rows):
        """Smallest bucket that fits `rows`."""
        for b in self.buckets:
            if b >= rows:
                return b
        raise AssertionError(f"rows {rows} > max bucket {self.max_rows}")

    @property
    def depth(self):
        with self._cond:
            return len(self._pending) + len(self._parked)

    # -- batch formation (policy core, lock held) ----------------------
    def _form(self, now):  # holds(_cond)
        """Returns (batch_or_None, expired_requests). Flush when the
        pending rows fill the largest bucket, the oldest request has
        waited max_wait, or we are draining at shutdown.

        Backoff-gated retries live in the `_parked` heap until their
        ready_at (`_promote`), so everything in `_pending` is eligible
        by construction — formation never rescans ineligible entries."""
        self._promote(now)
        expired = []
        if self._pending:
            kept = collections.deque()
            for r in self._pending:
                if r.deadline is not None and now >= r.deadline:
                    expired.append(r)
                else:
                    kept.append(r)
            if expired:
                # in place: rebinding would shed the guarded proxy
                self._pending.clear()
                self._pending.extend(kept)
                self._pending_rows = sum(r.rows for r in kept)
        if self._parked:
            # a parked retry can expire before its gate opens
            dead = [e for e in self._parked
                    if e[2].deadline is not None and now >= e[2].deadline]
            if dead:
                expired.extend(e[2] for e in dead)
                self._parked[:] = [e for e in self._parked
                                   if e not in dead]
                heapq.heapify(self._parked)
        if not self._pending:
            return None, expired
        full = self._pending_rows >= self.max_rows
        waited = now - self._pending[0].ready_at >= self.max_wait
        if not (full or waited or (self._closed and self._draining)):
            return None, expired
        take, rows, kept = [], 0, collections.deque()
        taking = True
        for r in self._pending:
            if taking and rows + r.rows <= self.max_rows:
                take.append(r)
                rows += r.rows
            else:
                # FIFO: never pull a request PAST one that didn't fit
                kept.append(r)
                taking = False
        self._pending.clear()
        self._pending.extend(kept)
        self._pending_rows -= rows
        return Batch(take, self.bucket_for(rows)), expired

    def poll(self, now=None):
        """Non-blocking batch formation (deterministic test/driver entry
        point): expire overdue requests, return a Batch or None."""
        now = self._clock() if now is None else now
        with self._cond:
            batch, expired = self._form(now)
        for r in expired:
            r.set_error(RequestTimeout(
                f"request expired in queue after deadline "
                f"({r.deadline - r.enqueued_at:.3f}s budget)"))
        return batch

    def _wait_timeout(self, now):  # holds(_cond)
        """Next instant the policy could change state on its own: a
        max-wait flush, the earliest parked backoff gate opening (heap
        top — O(1)), or the nearest deadline."""
        if not self._pending and not self._parked:
            return None
        cands = []
        for r in self._pending:
            cands.append(r.ready_at + self.max_wait - now)
            if r.deadline is not None:
                cands.append(r.deadline - now)
        if self._parked:
            cands.append(self._parked[0][0] - now)
            cands.extend(e[2].deadline - now for e in self._parked
                         if e[2].deadline is not None)
        return max(min(cands), 0.0)

    # -- consumer side -------------------------------------------------
    def get_batch(self):
        """Block until a batch is ready; None means shut down and fully
        drained (the worker should exit)."""
        while True:
            with self._cond:
                now = self._clock()
                batch, expired = self._form(now)
                if batch is None and not expired:
                    if self._closed and not self._pending \
                            and not self._parked:
                        return None
                    self._cond.wait(self._wait_timeout(now))
                    continue
            for r in expired:
                r.set_error(RequestTimeout(
                    "request expired in queue before execution"))
            if batch is not None:
                return batch

    # -- shutdown ------------------------------------------------------
    def close(self, drain=True):
        """Stop accepting. drain=True: queued requests still execute
        (workers see them via the draining flush rule, then get None).
        drain=False: queued requests are rejected with ServerClosed."""
        with self._cond:
            if self._closed:
                self._draining = self._draining and drain
            else:
                self._closed = True
                self._draining = drain
            rejected = []
            if not drain and (self._pending or self._parked):
                rejected = list(self._pending) + \
                    [e[2] for e in self._parked]
                self._pending.clear()
                del self._parked[:]
                self._pending_rows = 0
            self._cond.notify_all()
        for r in rejected:
            r.set_error(ServerClosed("server shut down before execution"))
