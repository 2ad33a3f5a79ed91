"""Replica worker pool + in-process inference server.

Counterpart of paddle_tpu/serving/pool.py. `InferenceServer` glues the
dynamic batcher to a pool of predictor replicas made with
`Predictor.clone()` (inference/__init__.py): clones share the loaded
weights and the Executor (its captured graphs) but own private I/O
handles, so one worker thread per replica takes batches concurrently —
the reference's one-AnalysisPredictor-clone-per-serving-thread pattern,
with the batching the reference left to callers done here.

On the card every bucket of the ladder is one feed signature of the
Executor, so one captured entry (observability/profile.py's LedgerJit).
`warmup()` captures the whole ladder before traffic, restoring it first
from the compile cache's manifest when PT_FLAGS_compile_cache_dir is
set (the entries are captured again in this process: a CUDA graph does
not outlive it) and rewriting the manifest after. The replicas share
each entry's graph and its static buffers: the Executor's pool lock
serialises one entry's feed copy, replay and fetch copy, so two workers
never mix their rows, and the card's one stream serialises the device
work anyway.

At startup the analysis pipeline runs over the Program (`lint_graph`:
ERROR findings abort), the planner registers each bucket's
capture-peak estimate for the ledger cross-check (GET /profile
"plan_check") and, with a budget, the fit gate refuses a model whose
largest bucket's estimate exceeds it.

Fault tolerance: each replica carries a `ReplicaHealth` record with a
consecutive-failure circuit breaker — trip it and the replica is
QUARANTINED (its worker stops taking batches) until a cooldown expires,
then re-admitted through a single half-open PROBE batch. A failed batch
is requeued at the queue front with exponential backoff (bounded
attempts, each request's remaining deadline respected) so a healthy
replica picks it up. The `inject_point("serving.run_batch")` choke point
lets seeded fault plans drive all of this deterministically.

Anything with `get_input_names() / clone() / run(feed=...)` serves: the
port's `Predictor` or a test fake.
"""
import ast
import logging
import threading
import time

import numpy as np

from paddle_tpu_torch.analysis.concurrency import guarded_by, make_lock
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import profile as obs_profile
from paddle_tpu_torch.observability import trace as obs_trace
from paddle_tpu_torch.reliability.faults import inject_point
from paddle_tpu_torch.serving.batcher import (
    DynamicBatcher, Request, default_buckets,
)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.utils.profiler import RecordEvent

__all__ = ["ReplicaHealth", "InferenceServer", "create_server"]

logger = logging.getLogger("paddle_tpu_torch.serving")


class ReplicaHealth:
    """Per-replica health record + consecutive-failure circuit breaker.

    States: HEALTHY (serving) -> `threshold` consecutive failures ->
    QUARANTINED (worker takes no batches for `cooldown` seconds) ->
    PROBING (one half-open batch) -> HEALTHY on success / QUARANTINED
    again on failure. Transitions are reported through `on_transition`
    ("quarantine" | "probe" | "readmit") so the pool's aggregate
    counters stay in one place. Thread-safe; clock-injectable so the
    state machine unit-tests without threads or sleeps.
    """

    HEALTHY = "healthy"
    QUARANTINED = "quarantined"
    PROBING = "probing"

    def __init__(self, index, threshold=3, cooldown=1.0,
                 clock=time.monotonic, on_transition=None):
        enforce(threshold >= 1, "breaker threshold must be >= 1")
        self.index = index
        self.threshold = threshold
        self.cooldown = cooldown
        self._clock = clock
        self._on_transition = on_transition
        self._mu = make_lock("serving.replica_health")
        self.state = self.HEALTHY        # guarded_by(_mu)
        self.consecutive_failures = 0    # guarded_by(_mu)
        self.total_failures = 0          # guarded_by(_mu)
        self.batches_ok = 0              # guarded_by(_mu)
        self.quarantines = 0             # guarded_by(_mu)
        self.probes = 0                  # guarded_by(_mu)
        self.last_error = None           # guarded_by(_mu)
        self._opened_at = None           # guarded_by(_mu)

    def _emit(self, kind):
        if self._on_transition is not None:
            self._on_transition(self, kind)

    def admission_delay(self, now=None):
        """Seconds the worker must still hold off before taking a batch
        (0.0 = admitted). Crossing the cooldown boundary flips the
        breaker to half-open: the NEXT batch is the probe."""
        now = self._clock() if now is None else now
        emit_probe = False
        with self._mu:
            if self.state == self.QUARANTINED:
                remaining = self._opened_at + self.cooldown - now
                if remaining > 0:
                    return remaining
                self.state = self.PROBING
                self.probes += 1
                emit_probe = True
        if emit_probe:
            self._emit("probe")
        return 0.0

    def record_success(self):
        with self._mu:
            was = self.state
            self.state = self.HEALTHY
            self.consecutive_failures = 0
            self.batches_ok += 1
        if was == self.PROBING:
            self._emit("readmit")

    def record_failure(self, error, now=None):
        now = self._clock() if now is None else now
        with self._mu:
            self.consecutive_failures += 1
            self.total_failures += 1
            self.last_error = f"{type(error).__name__}: {error}"[:200]
            trip = (self.state == self.PROBING
                    or self.consecutive_failures >= self.threshold)
            if trip:
                self.state = self.QUARANTINED
                self._opened_at = now
                self.quarantines += 1
        if trip:
            self._emit("quarantine")

    def to_dict(self):
        with self._mu:
            return {
                "index": self.index,
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "total_failures": self.total_failures,
                "batches_ok": self.batches_ok,
                "quarantines": self.quarantines,
                "probes": self.probes,
                "last_error": self.last_error,
            }


class InferenceServer:
    """In-process dynamic-batching server over a predictor.

    Usage::

        pred = create_predictor(Config(model_dir))
        with serving.InferenceServer(pred, num_replicas=2,
                                     max_batch_size=8) as srv:
            out = srv.infer({"x": x})          # blocking
            req = srv.submit({"x": x})         # future-style
            ...
            print(srv.stats())
    """

    def __init__(self, predictor, num_replicas=1, buckets=None,
                 max_batch_size=8, max_wait_ms=2.0, max_queue=128,
                 default_timeout_ms=None, clock=time.monotonic,
                 max_retries=2, retry_backoff_ms=20.0,
                 breaker_threshold=3, breaker_cooldown_ms=1000.0,
                 guard_non_finite=False, hbm_budget_bytes=None):
        enforce(num_replicas >= 1, "num_replicas must be >= 1")
        enforce(max_retries >= 0, "max_retries must be >= 0")
        self._clock = clock
        self._buckets = sorted(set(buckets)) if buckets else \
            default_buckets(max_batch_size)
        # capture accounting is ledger-scoped per server: cold-bucket
        # dispatches and warmup captures are CompileLedger entries
        # (kind="bucket"), and the Executor's own capture of a bucket is
        # attributed here too (component="serving", key="bucket<N>") —
        # stats()["compiles"] is a ledger view
        self.ledger_scope = f"serving@{id(self):x}"
        self._metrics = ServingMetrics(clock=clock,
                                       ledger_scope=self.ledger_scope)
        self._batcher = DynamicBatcher(
            self._buckets, max_wait=max_wait_ms / 1e3,
            max_queue=max_queue, clock=clock)
        self._default_timeout = (None if default_timeout_ms is None
                                 else default_timeout_ms / 1e3)
        self._max_retries = max_retries
        self._retry_backoff = retry_backoff_ms / 1e3
        self._guard_non_finite = guard_non_finite
        self._base = predictor
        self._feed_names = set(predictor.get_input_names())
        self._startup_diagnostics = self._verify_predictor(predictor)
        # static resource plan: per-bucket peak estimates registered
        # for the ledger cross-check (GET /profile "plan_check"), and
        # the fit gate — a model whose largest-bucket estimate
        # exceeds the budget aborts startup BEFORE any replica exists
        # (same choke point as the verify gate above)
        self._hbm_budget_bytes = hbm_budget_bytes
        self._bucket_plans = self._plan_predictor(predictor)
        self._replicas = [predictor] + [predictor.clone()
                                        for _ in range(num_replicas - 1)]
        self._health = [
            ReplicaHealth(i, threshold=breaker_threshold,
                          cooldown=breaker_cooldown_ms / 1e3,
                          clock=clock,
                          on_transition=self._on_health_transition)
            for i in range(num_replicas)]
        self._closing = threading.Event()
        self._shutdown_report = None
        self._warm_start_report = None
        # bucket warm-set + lock: the FIRST dispatch of each bucket size
        # runs serialized so a cold bucket is captured exactly once even
        # when several replicas race to it; warm buckets never take the
        # lock (the Executor cache itself is the fast path).
        self._seen_buckets = set()  # guarded_by(_first_dispatch_lock)
        self._first_dispatch_lock = make_lock("serving.first_dispatch")
        # writes-only runtime guard: the dispatch hot path reads the
        # warm-set lock-free by design (double-checked under the lock)
        guarded_by(self, "_seen_buckets", "serving.first_dispatch",
                   mode="w")
        self._threads = [
            threading.Thread(target=self._worker, args=(i, rep),
                             name=f"pt-serving-{i}", daemon=True)
            for i, rep in enumerate(self._replicas)]
        for t in self._threads:
            t.start()

    @staticmethod
    def _verify_predictor(predictor):
        """Startup choke point: run the full analysis pipeline (verifier
        + lints) over the predictor's Program before any worker serves
        a request. ERROR findings abort startup (a malformed graph must
        not reach traffic); recapture/state/host-op hazards are logged.
        Predictors without a Program (test fakes) are skipped."""
        program = getattr(predictor, "_program", None)
        if program is None:
            return []
        from paddle_tpu_torch.analysis import (
            AnalysisError, Severity, lint_graph, render_diagnostics,
        )
        diags = lint_graph(program)
        errors = [d for d in diags if d.severity == Severity.ERROR]
        if errors:
            raise AnalysisError(errors, Severity.ERROR,
                                label="InferenceServer startup")
        warnings = [d for d in diags if d.severity == Severity.WARNING]
        if warnings:
            logger.warning("serving program hazards:\n%s",
                           render_diagnostics(warnings))
        return diags

    def _plan_predictor(self, predictor):
        """Static resource planning at startup: estimate each bucket's
        peak from the Program graph alone, register its capture-peak
        estimate for the CompileLedger cross-check (against the peak
        the bucket's capture measures), and enforce the fit gate —
        `hbm_budget_bytes` (ctor kwarg, else PT_FLAGS_plan_hbm_bytes)
        caps the LARGEST bucket's step-peak estimate; over budget is a
        model-does-not-fit ERROR naming the estimate, the budget and the
        high-water-mark op. Predictors without a Program are skipped."""
        program = getattr(predictor, "_program", None)
        if program is None:
            return {}
        from paddle_tpu_torch.analysis import AnalysisError, Severity, planner
        from paddle_tpu_torch.core import flags as _flags
        budget = self._hbm_budget_bytes
        if budget is None:
            budget = float(_flags.get_flag("plan_hbm_bytes")) or None
        plans = {}
        for b in self._buckets:
            est = planner.estimate_peak_memory(program, batch_size=b)
            plans[b] = est
            planner.register_static_estimate(
                scope=self.ledger_scope, key=f"bucket{b}",
                estimate_bytes=est.capture_peak_bytes(),
                component="serving",
                detail={"bucket": b, "high_water": est.high_water()})
        if budget:
            worst = max(self._buckets)
            plan = planner.plan_program(program, batch_size=worst,
                                        hbm_budget_bytes=budget)
            fit = plan.fit_diagnostic()
            if fit is not None:
                raise AnalysisError([fit], Severity.ERROR,
                                    label="InferenceServer fit gate")
        return plans

    def _on_health_transition(self, health, kind):
        counter = {"quarantine": "quarantines", "probe": "probes",
                   "readmit": "readmissions"}[kind]
        self._metrics.reliability.inc(counter)
        (logger.warning if kind == "quarantine" else logger.info)(
            "replica %d %s (%s)", health.index, kind,
            health.last_error or "ok")

    # -- client surface ------------------------------------------------
    def submit(self, feed, timeout_ms=None, priority=0, tenant=None,
               trace_ctx=None):
        """Enqueue one request (feed: {input name: array with leading
        batch axis}); returns a future-style Request. Raises
        QueueFullError under backpressure, ServerClosed after shutdown.
        `priority`/`tenant` are gateway admission metadata: priority
        governs preemption under a full queue (`try_preempt`), tenant
        rides along for accounting.

        `trace_ctx` (SpanContext / wire dict / None→caller's current
        span) parents this request's `serving.queue` + `serving.execute`
        spans, connecting the worker-thread execution to the submitting
        request's trace."""
        enforce(set(feed) == self._feed_names,
                "feed names %s != model inputs %s",
                sorted(feed), sorted(self._feed_names))
        t = timeout_ms / 1e3 if timeout_ms is not None else \
            self._default_timeout
        now = self._clock()
        req = Request(feed, enqueued_at=now,
                      deadline=None if t is None else now + t,
                      on_done=self._metrics.record_done,
                      priority=priority, tenant=tenant,
                      trace_ctx=trace_ctx)
        qs = obs_trace.start_span(
            "serving.queue", parent=trace_ctx,
            attrs={"rows": req.rows, "priority": req.priority})
        req.queue_span = qs
        # the execute span must be the queue span's SIBLING (both
        # children of the request root); reuse the queue span's parent
        # ref — or, for an unparented in-process submit, parent
        # execution under the queue span so the trace still connects
        req.trace_ctx = qs.parent if qs.parent is not None else qs
        self._metrics.record_submit()
        try:
            self._batcher.put(req)
        except Exception as e:
            req.end_queue_span(error=e)
            self._metrics.record_reject()
            raise
        return req

    def infer(self, feed, timeout_ms=None):
        """Blocking single request: returns the per-request fetch list
        (padding removed), in get_output_names order."""
        req = self.submit(feed, timeout_ms=timeout_ms)
        budget = None
        if req.deadline is not None:
            # small grace over the server-side deadline so the
            # authoritative timeout (with its queue-state message)
            # surfaces instead of a racy client-side one
            budget = max(req.deadline - self._clock(), 0.0) + 0.5
        return req.result(timeout=budget)

    @property
    def queue_depth(self):
        """Live request-queue depth (admission pressure signal)."""
        return self._batcher.depth

    @property
    def queue_capacity(self):
        """The bounded queue's max_queue (admission watermark base)."""
        return self._batcher.max_queue

    def try_preempt(self, priority):
        """Evict one queued request with priority strictly below
        `priority` (it completes with `Preempted`) so a higher-priority
        submit can take its slot. Returns True if a victim was evicted."""
        return self._batcher.preempt_lower(priority) is not None

    def warm_manifest_name(self):
        """Stable cross-process identity of this server's signature
        ladder — the persistent compile cache's warm-start manifest
        name: Program content hash + bucket ladder. None for predictors
        without a Program (test fakes): they have no Executor entries
        to restore."""
        program = getattr(self._base, "_program", None)
        if program is None:
            return None
        from paddle_tpu_torch.core.compile_cache import program_cache_token
        ladder = "_".join(str(b) for b in self._buckets)
        return f"serving-{program_cache_token(program)[:16]}-b{ladder}"

    def warmup(self, example_feed):
        """Capture every bucket from one example feed (rows tiled to each
        bucket size) on the base replica, outside the request path —
        after this, steady-state traffic never waits on a capture.

        With the persistent compile cache armed
        (PT_FLAGS_compile_cache_dir), the ladder's warm-start manifest
        is restored FIRST — each entry it lists captured from its
        recorded signature (zeros of the recorded feed shapes), its
        ledger record a cache "hit", so the per-bucket runs below are
        replays, not captures — and (re)written afterwards, so the NEXT
        process restores whatever this one captured.
        `stats()["warm_start"]` carries the restore report."""
        from paddle_tpu_torch.core import compile_cache as _cc
        ex = {n: np.asarray(a) for n, a in example_feed.items()}
        enforce(set(ex) == self._feed_names,
                "warmup feed names %s != model inputs %s",
                sorted(ex), sorted(self._feed_names))
        pcache = _cc.compile_cache()
        manifest = self.warm_manifest_name() if pcache is not None \
            else None
        if manifest is not None:
            self._warm_start_report = pcache.warm_start(
                manifest, [_LadderWarmer(self)])
        ledger = obs_profile.compile_ledger()
        with self._first_dispatch_lock:
            todo = [b for b in self._buckets if b not in self._seen_buckets]
            for b in todo:
                feed = {n: np.repeat(a, b, axis=0)[:b] if a.shape[0] < b
                        else a[:b] for n, a in ex.items()}
                t0 = self._clock()
                compiles_before = len(ledger.compile_events(
                    scope=self.ledger_scope))
                with RecordEvent(f"serving/warmup_bucket_{b}"), \
                        obs_profile.attribution(
                            "serving", key=f"bucket{b}",
                            scope=self.ledger_scope, phase="warmup"):
                    self._base.run(feed=feed)
                # a bucket the manifest restored is recorded as a hit,
                # keeping the warm-process invariant: compile_events()
                # stays empty
                warm = (len(ledger.compile_events(
                    scope=self.ledger_scope)) == compiles_before
                    and manifest is not None)
                ledger.record(
                    component="serving", key=f"bucket{b}",
                    kind="bucket", scope=self.ledger_scope,
                    compile_s=self._clock() - t0,
                    signature=obs_profile.signature_of((feed,),
                                                       ("feed",)),
                    site=f"{self.ledger_scope}/bucket{b}",
                    tags={"phase": "warmup"},
                    cache={"event": "hit"} if warm else None)
                self._seen_buckets.add(b)
        if manifest is not None:
            pcache.write_manifest(manifest, scope=self.ledger_scope)
        return todo

    def stats(self):
        """Metrics snapshot + live queue/pool/compile-cache/health
        state."""
        snap = self._metrics.snapshot()
        snap["queue_depth"] = self._batcher.depth
        snap["num_replicas"] = len(self._replicas)
        snap["buckets"] = list(self._buckets)
        # the startup resource plan: per-bucket static peak estimates
        # (None for engines without a Program IR)
        snap["plan"] = {
            f"bucket{b}": est.step_peak_bytes()
            for b, est in sorted(self._bucket_plans.items())
        } or None
        with self._first_dispatch_lock:
            # a worker warming a cold bucket mutates the set; an
            # unlocked sorted() here dies with "set changed size
            # during iteration" mid-storm
            snap["warm_buckets"] = sorted(self._seen_buckets)
        exe = getattr(self._base, "_exe", None)
        snap["executable_cache_entries"] = (
            None if exe is None else len(exe._cache))
        snap["startup_findings"] = [d.to_dict()
                                    for d in self._startup_diagnostics]
        # persistent-cache ladder restore report (None until a cache-
        # armed warmup() ran — docs/serving.md cold start)
        snap["warm_start"] = (None if self._warm_start_report is None
                              else dict(self._warm_start_report))
        snap["replicas"] = [h.to_dict() for h in self._health]
        snap["healthy_replicas"] = sum(
            1 for h in self._health if h.state == ReplicaHealth.HEALTHY)
        # always present so supervisors can poll one key: None until
        # shutdown() ran, then its {drained, undrained_requests,
        # stuck_workers} report (the gateway's final drain response
        # aggregates the same reports per model/version)
        snap["shutdown"] = (None if self._shutdown_report is None
                            else dict(self._shutdown_report))
        return snap

    # -- lifecycle -----------------------------------------------------
    def shutdown(self, drain=True, timeout=None):
        """Stop accepting requests. drain=True executes everything
        already queued before workers exit; drain=False rejects queued
        requests with ServerClosed (the in-flight batch still finishes).

        `timeout` bounds the WHOLE shutdown, not each join: a worker
        wedged mid-batch cannot stall it past the deadline. Returns a
        report — {"drained", "undrained_requests", "stuck_workers"} —
        also surfaced in stats()["shutdown"]."""
        self._closing.set()   # quarantined workers skip their cooldown
        self._batcher.close(drain=drain)
        deadline = None if timeout is None else self._clock() + timeout
        stuck = []
        for t in self._threads:
            if deadline is None:
                t.join()
            else:
                t.join(max(deadline - self._clock(), 0.0))
            if t.is_alive():
                stuck.append(t.name)
        undrained = self._batcher.depth
        report = {"drained": not stuck and undrained == 0,
                  "undrained_requests": undrained,
                  "stuck_workers": stuck}
        self._shutdown_report = report
        if self._bucket_plans:
            # retire this server's plan-vs-measured cross-check legs
            from paddle_tpu_torch.analysis import planner
            planner.clear_static_estimates(scope=self.ledger_scope)
        if not report["drained"]:
            logger.warning("shutdown incomplete: %s", report)
        return report

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)

    # -- worker side ---------------------------------------------------
    def _worker(self, index, replica):
        health = self._health[index]
        while True:
            delay = health.admission_delay(self._clock())
            if delay > 0 and not self._closing.is_set():
                # quarantined: hold off (woken early by shutdown). Short
                # slices keep the re-admission latency bounded even if
                # the cooldown was long.
                self._closing.wait(min(delay, 0.05))
                continue
            batch = self._batcher.get_batch()
            if batch is None:
                return
            self._run_batch(replica, batch, health)

    def _run_batch(self, replica, batch, health):
        t0 = self._clock()
        compile_miss = False
        # each request's queue wait ends here; its execute span covers
        # this batch run, carrying the batch-assembly evidence (bucket,
        # padding waste, replica, retry attempt) as attributes
        exec_spans = []
        for r in batch.requests:
            r.end_queue_span()
            exec_spans.append(obs_trace.start_span(
                "serving.execute", parent=r.trace_ctx,
                attrs={"bucket": batch.bucket, "rows": r.rows,
                       "batch_rows": batch.rows,
                       "padded_rows": batch.bucket - batch.rows,
                       "occupancy": round(batch.occupancy, 4),
                       "replica": health.index,
                       "attempt": r.attempts}))
        try:
            with RecordEvent("serving/batch_run"), \
                    obs_profile.attribution(
                        "serving", key=f"bucket{batch.bucket}",
                        scope=self.ledger_scope, phase="dispatch"):
                feed = batch.build_feed()
                if batch.bucket not in self._seen_buckets:  # unlocked-ok: double-checked below
                    # cold bucket: serialize so ONE worker pays the
                    # capture; racers re-check under the lock and find
                    # the bucket warm
                    with self._first_dispatch_lock:
                        compile_miss = batch.bucket not in self._seen_buckets
                        outs = replica.run(feed=feed)
                        self._seen_buckets.add(batch.bucket)
                        if compile_miss:
                            # the ledger is the single capture record:
                            # a cold-bucket dispatch is a kind="bucket"
                            # entry (the Executor's own graph record
                            # nests under the same serving attribution)
                            obs_profile.compile_ledger().record(
                                component="serving",
                                key=f"bucket{batch.bucket}",
                                kind="bucket", scope=self.ledger_scope,
                                compile_s=self._clock() - t0,
                                signature=obs_profile.signature_of(
                                    (feed,), ("feed",)),
                                site=f"{self.ledger_scope}/"
                                     f"bucket{batch.bucket}",
                                tags={"phase": "dispatch"})
                else:
                    outs = replica.run(feed=feed)
                # chaos choke point: seeded plans kill/delay/hang/poison
                # this replica's batches (docs/reliability.md)
                outs = inject_point("serving.run_batch",
                                    tag=f"r{health.index}", value=outs)
                if self._guard_non_finite:
                    _check_finite(outs)
        except Exception as e:           # isolate, retry, don't kill worker
            for sp in exec_spans:
                sp.finish(error=e)
            self._metrics.record_batch(batch.bucket, batch.rows,
                                       self._clock() - t0,
                                       compile_miss=compile_miss)
            self._metrics.reliability.inc("batch_failures")
            health.record_failure(e)
            self._retry_or_fail(batch, e)
            return
        for sp in exec_spans:
            sp.finish()
        health.record_success()
        exec_s = self._clock() - t0
        # runtime attribution: per-bucket wall time into the
        # pt_executable_* series
        obs_profile.observe_run("serving", f"bucket{batch.bucket}",
                                exec_s)
        self._metrics.record_batch(batch.bucket, batch.rows, exec_s,
                                   compile_miss=compile_miss)
        try:
            batch.scatter(outs)
        except Exception as e:
            # e.g. an unbatchable fetch: a deterministic model-contract
            # error, not a replica fault — retrying elsewhere would fail
            # identically. set_result is first-write-wins, so a partial
            # scatter only errors the remainder; the worker survives.
            batch.fail(e)

    def _retry_or_fail(self, batch, error):
        """Bounded retry with exponential backoff: requeue the failed
        batch's requests at the queue front (a healthy replica picks
        them up) unless attempts are exhausted or the backoff would
        outlive the request's deadline."""
        now = self._clock()
        retry, fail = [], []
        for r in batch.requests:
            r.attempts += 1
            delay = self._retry_backoff * (2 ** (r.attempts - 1))
            if r.attempts > self._max_retries:
                fail.append(r)
            elif r.deadline is not None and now + delay >= r.deadline:
                self._metrics.reliability.inc("retries_abandoned")
                fail.append(r)
            else:
                r.ready_at = now + delay
                retry.append(r)
        for r in fail:
            r.set_error(error)
        if retry:
            self._metrics.reliability.inc("retried_requests", len(retry))
            self._batcher.requeue(retry)


def _check_finite(outs):
    """guard_non_finite=True: treat NaN/Inf fetch values as an engine
    fault (silent-corruption detection — an injected `nan` poison or a
    wedged card) so the batch takes the retry path."""
    for o in outs:
        a = np.asarray(o)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            raise FloatingPointError(
                "non-finite values in fetch output (corrupt replica?)")


class _LadderWarmer:
    """The `CompileCache.warm_start` wrapper of a server's bucket ladder:
    its cache token is the base predictor's Executor entries' token, and
    `warm` captures one manifest entry by running the base predictor on
    zeros of the recorded feed shapes inside `warm_capture`, so the
    Executor's record carries the cache "hit"."""

    component = "executor"

    def __init__(self, server):
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.lowering import referenced_state
        pred = server._base
        self._server = server
        self.scope = server.ledger_scope
        self.cache_token = Executor._cache_token(
            pred._program, pred.get_output_names(),
            referenced_state(pred._program, pred._scope), False)

    def warm(self, meta, load_s=0.0):
        feed = {}
        for label, shape, dtype in meta["signature"]:
            if label.startswith("feed["):
                name = ast.literal_eval(label[len("feed["):-1])
                feed[name] = np.zeros(tuple(shape), np.dtype(dtype))
        enforce(set(feed) == self._server._feed_names,
                "manifest entry feeds %s != model inputs %s",
                sorted(feed), sorted(self._server._feed_names))
        bucket = int(next(iter(feed.values())).shape[0])
        ledger = obs_profile.compile_ledger()
        before = ledger.count(scope=self.scope, kind="graph")
        with obs_profile.warm_capture({"event": "hit", "tier": "signature",
                                       "load_s": load_s}), \
                obs_profile.attribution("serving", key=f"bucket{bucket}",
                                        scope=self.scope, phase="warmup"):
            self._server._base.run(feed=feed)
        return ledger.count(scope=self.scope, kind="graph") > before


def create_server(predictor, **kwargs):
    """Convenience constructor mirroring inference.create_predictor."""
    return InferenceServer(predictor, **kwargs)
