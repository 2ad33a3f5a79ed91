"""Serving observability.

Counterpart of paddle_tpu/serving/metrics.py: per-request and per-batch
accounting for the serving subsystem — queue depth, batch occupancy,
p50/p99 request latency, throughput, and the bucket-capture counters
that prove the bucketing contract (one captured Executor entry per
bucket size, ever). The capture counters are views over
`observability.profile.compile_ledger()`, the process-wide record of
every capture. The pool wraps every batch execution in a
utils/profiler.RecordEvent range; this module keeps the aggregate
counters a `stats()` snapshot can serve cheaply.

The distributions are fixed-size log-bucket histograms (LatencyStat's
backend: O(1) update, O(buckets) snapshot), and every event is mirrored
into the unified registry (`observability.metrics.registry()`), giving
the gateway's /metrics Prometheus series without a second accounting
path: `pt_serving_requests_total{outcome=}` and per-bucket
`pt_serving_batches_total` / `pt_serving_batch_rows_total` /
`pt_serving_padded_rows_total{bucket=}`.

Thread-safe; all timing via an injectable clock (fake-clock tests).
"""
import time

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.utils.metrics import Counter, LatencyStat


class ServingMetrics:
    def __init__(self, clock=time.monotonic, ledger_scope=None):
        self._clock = clock
        self._lock = make_lock("serving.latency")
        self._t0 = clock()
        # capture accounting scope: bucket_compile_misses and
        # warmup_compiles are VIEWS over the CompileLedger filtered to
        # this server's scope — the pool records kind="bucket" entries
        # tagged phase=dispatch|warmup there
        self._ledger_scope = ledger_scope
        # request lifecycle counters
        self.submitted = 0
        self.completed = 0
        self.rejected = 0        # backpressure (QueueFullError)
        self.timed_out = 0       # deadline expiry (RequestTimeout)
        self.cancelled = 0       # shutdown rejection (ServerClosed)
        self.failed = 0          # execution error
        # batch counters
        self.batches = 0
        self.rows_served = 0
        self.padded_rows = 0
        self.per_bucket = {}            # bucket -> batch count
        # fault-tolerance counters: how often batches failed, requests were retried/abandoned, and
        # replicas were quarantined / probed / re-admitted
        self.reliability = Counter(
            "serving_reliability",
            ("batch_failures", "retried_requests", "retries_abandoned",
             "quarantines", "probes", "readmissions"))
        # distributions (fixed-size log-bucket histograms)
        self._request_latency = LatencyStat("request_latency_s")
        self._batch_exec = LatencyStat("batch_exec_s")
        self._occupancy = LatencyStat("batch_occupancy")
        # unified-registry mirrors (process-wide Prometheus series)
        reg = obs_metrics.registry()
        self._obs_requests = reg.counter(
            "pt_serving_requests_total",
            "terminal request outcomes", labels=("outcome",))
        self._obs_batches = reg.counter(
            "pt_serving_batches_total",
            "batches executed per bucket size", labels=("bucket",))
        self._obs_rows = reg.counter(
            "pt_serving_batch_rows_total",
            "real rows served per bucket size", labels=("bucket",))
        self._obs_padded = reg.counter(
            "pt_serving_padded_rows_total",
            "padding rows wasted per bucket size", labels=("bucket",))

    # -- request lifecycle --------------------------------------------
    def record_submit(self):
        with self._lock:
            self.submitted += 1
        self._obs_requests.labels(outcome="submitted").inc()

    def record_reject(self):
        with self._lock:
            self.rejected += 1
        self._obs_requests.labels(outcome="rejected").inc()

    def record_done(self, request, error):
        """Terminal accounting for one request — wired as Request.on_done
        so expiry inside the batcher and shutdown rejection are counted
        exactly like worker-side completion."""
        from paddle_tpu_torch.serving.batcher import (
            QueueFullError, RequestTimeout, ServerClosed,
        )
        now = self._clock()
        with self._lock:
            if error is None:
                outcome = "completed"
                self.completed += 1
                self._request_latency.update(now - request.enqueued_at)
            elif isinstance(error, RequestTimeout):
                outcome = "timed_out"
                self.timed_out += 1
            elif isinstance(error, ServerClosed):
                outcome = "cancelled"
                self.cancelled += 1
            elif isinstance(error, QueueFullError):
                # an ADMITTED request shed later (priority preemption):
                # load-shed accounting, same bucket as submit rejection
                outcome = "rejected"
                self.rejected += 1
            else:
                outcome = "failed"
                self.failed += 1
        self._obs_requests.labels(outcome=outcome).inc()

    # -- batches -------------------------------------------------------
    def record_batch(self, bucket, rows, exec_s, compile_miss=False):
        # compile_miss rides along for log/debug call sites; the COUNT
        # comes from the ledger (see _compile_view), not a second
        # accumulator that could drift from it
        del compile_miss
        with self._lock:
            self.batches += 1
            self.rows_served += rows
            self.padded_rows += bucket - rows
            self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + 1
            self._batch_exec.update(exec_s)
            self._occupancy.update(rows / bucket)
        self._obs_batches.labels(bucket=bucket).inc()
        self._obs_rows.labels(bucket=bucket).inc(rows)
        self._obs_padded.labels(bucket=bucket).inc(bucket - rows)

    def _compile_view(self, phase):
        if self._ledger_scope is None:
            return 0
        from paddle_tpu_torch.observability import profile as obs_profile
        return obs_profile.compile_ledger().count(
            kind="bucket", scope=self._ledger_scope,
            tag=("phase", phase))

    @property
    def bucket_compile_misses(self):
        """First-ever dispatch of each bucket (ledger view)."""
        return self._compile_view("dispatch")

    @property
    def warmup_compiles(self):
        """Buckets pre-compiled via warmup() (ledger view)."""
        return self._compile_view("warmup")

    # -- export --------------------------------------------------------
    def snapshot(self):
        with self._lock:
            elapsed = max(self._clock() - self._t0, 1e-9)
            lat = self._request_latency.eval()
            ex = self._batch_exec.eval()
            occ = self._occupancy.eval()
            padded_den = max(self.rows_served + self.padded_rows, 1)
            return {
                "uptime_s": elapsed,
                "requests": {
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "rejected": self.rejected,
                    "timed_out": self.timed_out,
                    "cancelled": self.cancelled,
                    "failed": self.failed,
                },
                "throughput_rps": self.completed / elapsed,
                "rows_per_sec": self.rows_served / elapsed,
                "latency_ms": {
                    "count": lat["count"],
                    "mean": lat["mean"] * 1e3,
                    "p50": lat["p50"] * 1e3,
                    "p99": lat["p99"] * 1e3,
                    "max": lat["max"] * 1e3,
                },
                "batches": {
                    "count": self.batches,
                    "rows_served": self.rows_served,
                    "padded_rows": self.padded_rows,
                    "padded_row_fraction": self.padded_rows / padded_den,
                    "mean_occupancy": occ["mean"],
                    "per_bucket": dict(self.per_bucket),
                    "exec_ms_p50": ex["p50"] * 1e3,
                    "exec_ms_p99": ex["p99"] * 1e3,
                },
                "compiles": {
                    "bucket_misses": self.bucket_compile_misses,
                    "warmup": self.warmup_compiles,
                },
                "reliability": self.reliability.eval(),
            }
