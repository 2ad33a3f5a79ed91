"""RetryPolicy — bounded, deadline-aware, deterministically-jittered retry.

Parity: the reference's distributed transport carries a retry policy on
every RPC (operators/distributed/rpc_client.h:34 `retry` knobs +
FLAGS_rpc_retry_times / rpc_deadline); our PS client raised on the first
failed verb instead (the missing-resilience gap ps/__init__.py used to
name in a comment). This module is that policy as a standalone,
fake-clock-testable object:

* capped exponential backoff: ``base * multiplier^(attempt-1)``, capped
  at ``max_delay``;
* **seeded** jitter: the per-attempt delay is shrunk by up to ``jitter``
  fraction using a CRC32 hash of ``(seed, key, attempt)`` — no RNG
  state, so a chaos run's retry timing replays bit-for-bit (same trick
  as reliability.faults' seeded Bernoulli);
* bounded attempts AND a per-call wall-clock deadline: whichever budget
  exhausts first terminates the retry loop;
* injectable ``clock``/``sleep`` so the backoff schedule is unit-tested
  without real waiting.

The PS client (paddle_tpu_torch.ps) wraps every verb in a policy with a
verb-level retry-safety classification; the supervisor and watchdog use
the same backoff math for restart pacing. See docs/reliability.md
"Distributed failure handling".
"""
import time
import zlib

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["RetryError", "RetryPolicy"]


class RetryError(RuntimeError):
    """Retry budget exhausted. Carries the terminal cause plus the
    attempt/elapsed accounting so callers (and the watchdog dump) can
    tell a dead server from a misconfigured deadline."""

    def __init__(self, key, attempts, elapsed, cause, reason):
        super().__init__(
            f"retry budget exhausted for {key!r} after {attempts} "
            f"attempt(s) in {elapsed:.3f}s ({reason}): {cause}")
        self.key = key
        self.attempts = attempts
        self.elapsed = elapsed
        self.cause = cause
        self.reason = reason


class RetryPolicy:
    """Deadline + capped-exponential-backoff retry with seeded jitter.

    >>> pol = RetryPolicy(max_attempts=4, base_delay=0.05, seed=7)
    >>> pol.run(flaky_fn, key="pull_sparse")

    `run` re-invokes ``fn`` until it returns, raises a non-retryable
    error (per ``retryable``), or a budget (attempts or deadline) is
    exhausted — then raises RetryError wrapping the last cause.
    """

    def __init__(self, max_attempts=5, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.2, seed=0, deadline=30.0,
                 clock=time.monotonic, sleep=time.sleep):
        enforce(max_attempts >= 1, "max_attempts must be >= 1")
        enforce(base_delay >= 0 and max_delay >= 0, "delays must be >= 0")
        enforce(0.0 <= jitter <= 1.0, "jitter is a fraction in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.deadline = None if deadline is None else float(deadline)
        self.clock = clock
        self.sleep = sleep

    def delay(self, attempt, key=""):
        """Backoff before retry number `attempt` (1-based: the delay
        after the attempt-th failure). Deterministic for a given
        (seed, key, attempt)."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            h = zlib.crc32(f"{self.seed}:{key}:{attempt}".encode()) / 2 ** 32
            d *= 1.0 - self.jitter * h
        return d

    def schedule(self, key=""):
        """The full backoff schedule [delay after attempt 1, ...] —
        what a fake-clock test asserts against."""
        return [self.delay(a, key) for a in range(1, self.max_attempts)]

    def run(self, fn, key="", retryable=None, on_retry=None):
        """Call `fn()` under this policy.

        retryable(exc) -> bool gates which failures are retried (default:
        any Exception). on_retry(attempt, delay, exc) observes each retry
        — the PS client reconnects + counts there.
        """
        start = self.clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if retryable is not None and not retryable(e):
                    raise
                if attempt >= self.max_attempts:
                    raise RetryError(key, attempt, self.clock() - start,
                                     e, "attempts") from e
                d = self.delay(attempt, key)
                if (self.deadline is not None
                        and self.clock() - start + d > self.deadline):
                    raise RetryError(key, attempt, self.clock() - start,
                                     e, "deadline") from e
                if on_retry is not None:
                    on_retry(attempt, d, e)
                if d > 0:
                    self.sleep(d)
