"""Per-tenant admission control for the serving gateway.

Counterpart of paddle_tpu/serving/admission.py. `serving.batcher`
already sheds load at the process boundary: a full bounded queue raises
QueueFullError. That protects the server but is blind to WHO is sending
— one chatty tenant can starve everyone — and it rejects only at the
moment of enqueue, after the request crossed the wire. This module
layers wire-side policy on top:

* **token-bucket quotas** — each tenant owns a bucket (`rate` rows/sec
  refill, `burst` capacity); an empty bucket rejects with 429 and an
  exact Retry-After (the refill time for the requested rows);
* **priority classes** — under queue pressure (depth past a watermark)
  only requests at or above the pressure threshold are admitted; an
  admitted high-priority request may additionally preempt a queued
  lower-priority one (`InferenceServer.try_preempt`) when the queue is
  outright full;
* **deadline-aware shedding** — an EWMA of observed request latency
  prices the queue ahead; a request whose deadline cannot plausibly be
  met is rejected NOW with 503 + Retry-After instead of timing out
  server-side after occupying queue space;
* **bounded in-flight accounting** — global and per-tenant caps on
  admitted-but-not-completed requests.

Everything is clock-injectable and lock-protected; the policy is
synchronous (admit/release/observe), so the tests drive refill,
preemption and shedding with a fake clock, threadlessly.
"""
import time

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import metrics as obs_metrics

__all__ = ["TokenBucket", "TenantQuota", "Admission",
           "AdmissionController"]


class TokenBucket:
    """Classic token bucket: `rate` tokens/sec refill up to `burst`.

    `try_take(n, now)` either takes the tokens and returns 0.0, or
    leaves the bucket untouched and returns the seconds until `n`
    tokens will be available (the exact Retry-After).
    """

    def __init__(self, rate, burst, clock=time.monotonic):
        enforce(rate > 0, "token rate must be > 0, got %s", rate)
        enforce(burst >= 1, "burst must be >= 1, got %s", burst)
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._level = float(burst)
        self._at = clock()
        self._mu = make_lock("serving.admission.tokens")

    def _refill(self, now):
        if now > self._at:
            self._level = min(self.burst,
                              self._level + (now - self._at) * self.rate)
        self._at = max(self._at, now)

    def try_take(self, n=1, now=None):
        now = self._clock() if now is None else now
        with self._mu:
            self._refill(now)
            if n <= self._level:
                self._level -= n
                return 0.0
            return (n - self._level) / self.rate

    def give_back(self, n, now=None):
        """Return `n` unused tokens (a later admission gate rejected the
        request, so the tenant must not be charged for shed work)."""
        now = self._clock() if now is None else now
        with self._mu:
            self._refill(now)
            self._level = min(self.burst, self._level + n)

    def level(self, now=None):
        now = self._clock() if now is None else now
        with self._mu:
            self._refill(now)
            return self._level


class TenantQuota:
    """Per-tenant policy: quota (rows/sec + burst), priority class, and
    an in-flight cap. `rate=None` means unmetered (no bucket)."""

    def __init__(self, rate=None, burst=None, priority=0,
                 max_in_flight=None):
        self.rate = rate
        self.burst = burst if burst is not None else \
            (max(2.0 * rate, 1.0) if rate else None)
        self.priority = int(priority)
        self.max_in_flight = max_in_flight


class Admission:
    """One admission decision. Truthy iff admitted; a rejection carries
    the HTTP-shaped status (429 quota / 503 overload), the reason tag
    and a Retry-After hint in seconds."""

    __slots__ = ("ok", "status", "reason", "retry_after_s", "priority")

    def __init__(self, ok, status=200, reason="", retry_after_s=None,
                 priority=0):
        self.ok = ok
        self.status = status
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.priority = priority

    def __bool__(self):
        return self.ok

    def to_dict(self):
        return {"ok": self.ok, "status": self.status,
                "reason": self.reason,
                "retry_after_s": self.retry_after_s}


class AdmissionController:
    """Gateway-side admission policy over all tenants.

    `admit()` is consulted once per wire request BEFORE the request is
    materialised into the server queue; `release()` returns the
    in-flight slot at completion; `observe()` feeds completed-request
    latency into the deadline-shedding estimator.
    """

    #: queue-depth fraction past which sub-`pressure_priority` traffic
    #: is shed (priority classes only bite under pressure).
    DEFAULT_WATERMARK = 0.75

    def __init__(self, tenants=None, default_quota=None,
                 max_in_flight=None, queue_capacity=None,
                 pressure_watermark=DEFAULT_WATERMARK,
                 pressure_priority=1, ewma_alpha=0.2,
                 clock=time.monotonic):
        self._clock = clock
        self._mu = make_lock("serving.admission.breaker")
        self._quotas = {}
        self._buckets = {}
        self._default_quota = default_quota or TenantQuota()
        self.max_in_flight = max_in_flight
        self.queue_capacity = queue_capacity
        self.pressure_watermark = float(pressure_watermark)
        self.pressure_priority = int(pressure_priority)
        self._ewma_alpha = float(ewma_alpha)
        self._ewma_latency_s = None
        self._in_flight = {}          # tenant -> count
        self._total_in_flight = 0
        self._counters = {}           # tenant -> {admitted, rejected_*}
        # unified-registry mirror: the per-tenant admission series the
        # gateway's GET /metrics exposes
        self._obs = obs_metrics.registry().counter(
            "pt_gateway_admission_total",
            "admission decisions per tenant and outcome",
            labels=("tenant", "outcome"))
        for name, quota in (tenants or {}).items():
            self.configure(name, quota)

    def _count(self, counters, tenant, outcome):
        counters[outcome] += 1
        self._obs.labels(tenant=tenant or "default",
                         outcome=outcome).inc()

    # -- configuration -------------------------------------------------
    def configure(self, tenant, quota):
        """Install (or replace) one tenant's policy. Replacing resets
        the tenant's bucket to a full burst."""
        enforce(isinstance(quota, TenantQuota),
                "quota must be a TenantQuota, got %r", quota)
        with self._mu:
            self._quotas[tenant] = quota
            if quota.rate:
                self._buckets[tenant] = TokenBucket(
                    quota.rate, quota.burst, clock=self._clock)
            else:
                self._buckets.pop(tenant, None)

    def quota_for(self, tenant):
        return self._quotas.get(tenant, self._default_quota)

    # -- estimator -----------------------------------------------------
    def observe(self, latency_s):
        """Feed one completed request's wall latency into the EWMA the
        deadline shedder prices queue positions with."""
        with self._mu:
            if self._ewma_latency_s is None:
                self._ewma_latency_s = float(latency_s)
            else:
                a = self._ewma_alpha
                self._ewma_latency_s += a * (latency_s
                                             - self._ewma_latency_s)

    def estimated_completion_s(self, queue_depth):
        """Heuristic time for a NEW request to complete given the
        current queue depth: one EWMA service time per queued request
        ahead of it plus its own. Conservative on purpose — shedding a
        doomed request early is cheap, admitting it is not. Returns 0.0
        until a first latency sample exists (never shed blind)."""
        with self._mu:
            if self._ewma_latency_s is None:
                return 0.0
            return self._ewma_latency_s * (1 + max(int(queue_depth), 0))

    # -- decision ------------------------------------------------------
    def admit(self, tenant, rows=1, priority=None, deadline_s=None,
              queue_depth=0, now=None):
        """One admission decision for `rows` rows from `tenant`.

        `deadline_s` is the request's absolute deadline on this
        controller's clock (None = no deadline). `queue_depth` is the
        target server's current queue depth — the pressure and deadline
        signals. Admission takes an in-flight slot; the caller MUST pair
        every ok decision with `release(tenant)`.
        """
        now = self._clock() if now is None else now
        quota = self.quota_for(tenant)
        prio = quota.priority if priority is None else int(priority)
        counters = self._tenant_counters(tenant)

        # 1. bounded in-flight accounting (global, then per-tenant).
        # The retry hint is computed BEFORE taking the lock (_retry_hint
        # locks too, and threading.Lock is not reentrant).
        hint = self._retry_hint()
        with self._mu:
            if (self.max_in_flight is not None
                    and self._total_in_flight >= self.max_in_flight):
                self._count(counters, tenant, "rejected_in_flight")
                return Admission(False, 503, "gateway in-flight limit",
                                 retry_after_s=hint, priority=prio)
            if (quota.max_in_flight is not None
                    and self._in_flight.get(tenant, 0)
                    >= quota.max_in_flight):
                self._count(counters, tenant, "rejected_in_flight")
                return Admission(False, 503,
                                 f"tenant {tenant!r} in-flight limit",
                                 retry_after_s=hint, priority=prio)

        # 2. token-bucket quota
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            wait = bucket.try_take(rows, now=now)
            if wait > 0:
                self._count(counters, tenant, "rejected_quota")
                return Admission(False, 429,
                                 f"tenant {tenant!r} over quota",
                                 retry_after_s=wait, priority=prio)

        # 3. deadline-aware shedding: reject early, don't time out late
        if deadline_s is not None:
            est = self.estimated_completion_s(queue_depth)
            if est > 0 and now + est >= deadline_s:
                self._give_back(bucket, rows, now)
                self._count(counters, tenant, "rejected_deadline")
                return Admission(False, 503,
                                 "deadline unmeetable at current load",
                                 retry_after_s=est, priority=prio)

        # 4. priority shedding under queue pressure
        if (self.queue_capacity
                and queue_depth >= self.pressure_watermark
                * self.queue_capacity
                and prio < self.pressure_priority):
            self._give_back(bucket, rows, now)
            self._count(counters, tenant, "rejected_priority")
            return Admission(False, 503,
                             f"queue pressure sheds priority < "
                             f"{self.pressure_priority}",
                             retry_after_s=self._retry_hint(),
                             priority=prio)

        with self._mu:
            self._in_flight[tenant] = self._in_flight.get(tenant, 0) + 1
            self._total_in_flight += 1
        self._count(counters, tenant, "admitted")
        return Admission(True, 200, "admitted", priority=prio)

    @staticmethod
    def _give_back(bucket, rows, now):
        if bucket is not None:
            bucket.give_back(rows, now=now)

    def _retry_hint(self):
        with self._mu:
            return max(self._ewma_latency_s or 0.05, 0.05)

    def release(self, tenant):
        with self._mu:
            n = self._in_flight.get(tenant, 0)
            if n > 0:
                self._in_flight[tenant] = n - 1
                self._total_in_flight -= 1

    def _tenant_counters(self, tenant):
        with self._mu:
            return self._counters.setdefault(tenant, {
                "admitted": 0, "rejected_quota": 0,
                "rejected_deadline": 0, "rejected_priority": 0,
                "rejected_in_flight": 0})

    # -- export --------------------------------------------------------
    def stats(self):
        with self._mu:
            return {
                "total_in_flight": self._total_in_flight,
                "max_in_flight": self.max_in_flight,
                "ewma_latency_ms": (None if self._ewma_latency_s is None
                                    else self._ewma_latency_s * 1e3),
                "tenants": {
                    t: dict(c, in_flight=self._in_flight.get(t, 0),
                            priority=self.quota_for(t).priority,
                            tokens=(self._buckets[t].level()
                                    if t in self._buckets else None))
                    for t, c in self._counters.items()},
            }
