"""Seeded cooperative interleaving fuzzer.

Counterpart of paddle_tpu/analysis/interleave.py. It drives a set of
logical threads through adversarial schedules by preempting at
TrackedLock boundaries (:func:`concurrency.set_preempt_hook`). Only one
logical thread runs at a time: each runs on a real ``threading.Thread``
but waits on its own go-event until the scheduler picks it, and hands
control back whenever it crosses a lock boundary (before-acquire /
blocked / acquired / released). The scheduler's choices come from
``random.Random(seed)``, so a schedule that exposes a race replays
exactly from its seed, the same schedule in both packages.

Scenario rules (what keeps schedules deterministic):

* drive synchronous APIs (the batcher's ``put`` / ``poll`` /
  ``requeue``, the registry's deploy and route, WindowedView record and
  query), not blocking waits: ``Condition.wait`` blocks on a private
  waiter lock the scheduler cannot see, and a scenario thread that
  blocks there stalls the schedule and trips the yield timeout;
* do not branch on wall-clock time inside scenario threads.

Typical use::

    result = run_interleaved([("a", fn_a), ("b", fn_b)], seed=7)
    bad = find_failing_seed(make_scenario, seeds=range(200))
    # make_scenario() -> (threads, check); check() raises on violation

The checker must be armed (the locks must be TrackedLocks): plain
stdlib locks have no boundaries to preempt at, so the fuzzer degrades
to sequential execution and finds nothing.
"""
import random
import threading

from paddle_tpu_torch.analysis import concurrency as _cc

__all__ = ["run_interleaved", "find_failing_seed", "ScheduleResult",
           "InterleaveError"]

#: seconds a scheduled thread may run without yielding or finishing
#: before the run is declared stalled (a blocking wait in the scenario)
YIELD_TIMEOUT_S = 10.0


class InterleaveError(RuntimeError):
    """A scenario thread stalled (blocking wait) or the schedule
    livelocked (every runnable thread spinning on a held lock)."""


class ScheduleResult:
    """One fuzzed run: the seed, the event trace (thread, event, lock),
    per-thread exceptions, and step count. `ok` is False when any
    scenario thread raised."""

    __slots__ = ("seed", "steps", "trace", "exceptions")

    def __init__(self, seed, steps, trace, exceptions):
        self.seed = seed
        self.steps = steps
        self.trace = trace
        self.exceptions = exceptions

    @property
    def ok(self):
        return not self.exceptions

    def __repr__(self):
        return (f"ScheduleResult(seed={self.seed}, steps={self.steps}, "
                f"ok={self.ok})")


class _Logical:
    __slots__ = ("name", "fn", "go", "thread", "done", "exc",
                 "last_event")

    def __init__(self, name, fn):
        self.name = name
        self.fn = fn
        self.go = threading.Event()
        self.thread = None
        self.done = False
        self.exc = None
        self.last_event = None


class _Scheduler:
    def __init__(self, threads, seed, max_steps):
        self.rng = random.Random(seed)
        self.seed = seed
        self.max_steps = max_steps
        self.logical = [_Logical(n, f) for n, f in threads]
        self.by_ident = {}
        self.control = threading.Event()
        self.trace = []
        self.steps = 0
        self._progress_stall = 0

    # -- worker side ---------------------------------------------------
    def _worker(self, lt):
        lt.go.wait()
        lt.go.clear()
        try:
            lt.fn()
        except BaseException as e:  # noqa: BLE001 — reported, not eaten
            lt.exc = e
        finally:
            lt.done = True
            self.control.set()

    def _hook(self, event, lock_name):
        lt = self.by_ident.get(threading.get_ident())
        if lt is None or lt.done:
            return                  # not a scenario thread
        lt.last_event = event
        self.trace.append((lt.name, event, lock_name))
        # hand control back, wait to be rescheduled
        self.control.set()
        lt.go.wait()
        lt.go.clear()

    # -- scheduler side ------------------------------------------------
    def run(self):
        prev = _cc._preempt_hook
        _cc.set_preempt_hook(self._hook)
        try:
            for lt in self.logical:
                lt.thread = threading.Thread(
                    target=self._worker, args=(lt,),
                    name=f"pt-interleave-{lt.name}", daemon=True)
                lt.thread.start()
                self.by_ident[lt.thread.ident] = lt
            while True:
                runnable = [lt for lt in self.logical if not lt.done]
                if not runnable:
                    break
                self.steps += 1
                if self.steps > self.max_steps:
                    raise InterleaveError(
                        f"seed {self.seed}: exceeded {self.max_steps} "
                        f"scheduling steps — livelock (every runnable "
                        f"thread blocked on a held lock?); trace tail: "
                        f"{self.trace[-8:]}")
                lt = self.rng.choice(runnable)
                self.control.clear()
                lt.go.set()
                if not self.control.wait(YIELD_TIMEOUT_S):
                    raise InterleaveError(
                        f"seed {self.seed}: thread {lt.name!r} ran "
                        f"{YIELD_TIMEOUT_S}s without yielding — a "
                        f"blocking wait in the scenario (use poll-based "
                        f"APIs; see module docstring)")
        finally:
            _cc.set_preempt_hook(prev)
            # release any thread still parked on its go-event so the
            # daemon threads can exit (their hook is now a no-op)
            for lt in self.logical:
                lt.go.set()
            for lt in self.logical:
                if lt.thread is not None:
                    lt.thread.join(timeout=YIELD_TIMEOUT_S)
        exceptions = {lt.name: lt.exc for lt in self.logical
                      if lt.exc is not None}
        return ScheduleResult(self.seed, self.steps, list(self.trace),
                              exceptions)


def run_interleaved(threads, seed, max_steps=100000):
    """Run ``threads`` (list of ``(name, callable)``) under one seeded
    adversarial schedule. Returns a :class:`ScheduleResult`; the same
    seed over the same scenario replays the same trace."""
    if not threads:
        return ScheduleResult(seed, 0, [], {})
    return _Scheduler(list(threads), seed, max_steps).run()


def find_failing_seed(make_scenario, seeds, max_steps=100000):
    """Fuzz: for each seed build a FRESH scenario and run it.

    ``make_scenario()`` returns ``(threads, check)`` where ``check()``
    raises (e.g. AssertionError) when the post-run state violates an
    invariant. Returns ``(seed, result, error)`` for the first failure
    — a scenario-thread exception or a check failure — or ``None`` if
    every seed survives."""
    for seed in seeds:
        threads, check = make_scenario()
        result = run_interleaved(threads, seed, max_steps=max_steps)
        if not result.ok:
            return seed, result, next(iter(result.exceptions.values()))
        try:
            check()
        except Exception as e:  # noqa: BLE001 — the invariant verdict
            return seed, result, e
    return None
