"""Concurrency checking, the runtime arm.

Counterpart of paddle_tpu/analysis/concurrency.py. The port's threaded
surface is Python (the gateway's accept and connection threads, the
replica pool's workers, the continuous-batching loop, the SLO daemon,
the fleet's router and heartbeats, the PS client's threads), which no
thread sanitizer sees. This module is its detector:

* ``make_lock(name)`` / ``make_rlock(name)`` / ``make_condition(name)``:
  the one way product code constructs locks (analysis/astlint.py flags a
  raw ``threading.Lock()`` elsewhere). A plain stdlib lock normally;
  under ``PT_FLAGS_concurrency_check`` a :class:`TrackedLock` that feeds
  the process-wide :class:`LockRegistry`.
* :class:`LockRegistry`: the lock-order digraph over lock names with
  cycle detection. An edge that closes a cycle gives a
  ``lock-order-cycle`` Diagnostic naming both acquisition stacks, rings
  it into the flight recorder, and records wait/hold histograms
  (``pt_lock_wait_seconds`` / ``pt_lock_hold_seconds``) and per-lock
  contention for ``GET /profile``'s "concurrency" section.
* :func:`guarded_by`: an annotated structure (the batcher queue, the
  registry's route table, the SLO ring, the flight-recorder ring) is
  wrapped in a proxy that checks every access against the current
  thread's held locks and reports ``guarded-by-violation``.

This is a leaf module: stdlib, core.flags and the Diagnostic model at
import time; observability is imported lazily inside functions, so
observability, serving and ps can all import it. The static arm is
analysis/astlint.py; the interleaving fuzzer (analysis/interleave.py)
drives TrackedLock boundaries through seeded schedules via
:func:`set_preempt_hook`.
"""
import atexit
import json
import os
import sys
import threading
import time
import weakref

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.analysis.diagnostic import Diagnostic, Severity

__all__ = [
    "make_lock", "make_rlock", "make_condition", "TrackedLock",
    "TrackedRLock", "LockRegistry", "lock_registry", "guarded_by",
    "guard_value", "held_lock_names", "checking_enabled", "set_enabled",
    "findings", "finding_records", "clear_findings", "profile_section",
    "set_preempt_hook", "reset_for_tests",
]

#: mutating method names a ``mode="w"`` proxy checks (reads pass —
#: for structures that deliberately allow lock-free reads).
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse", "rotate",
})

_STACK_LIMIT = 10

# runtime kill-switch consulted PER OPERATION by TrackedLock — lets the
# bench A/B a single armed process (set_enabled(False) makes tracked
# locks thin pass-throughs without swapping lock objects under traffic).
_runtime_on = True

# fuzzer preemption hook (analysis/interleave.py): called at TrackedLock
# boundaries as hook(event, lock_name) with event in
# {"before_acquire", "blocked", "acquired", "released"}.
_preempt_hook = None


def checking_enabled():
    """Construction-time switch: is the detector armed? (flag)."""
    return bool(_flags.get_flag("concurrency_check"))


def set_enabled(on):
    """Runtime kill-switch for ALREADY-CONSTRUCTED TrackedLocks (the
    alternating-block bench toggles this between measurement blocks;
    a true detector-off process never constructs TrackedLocks at all)."""
    global _runtime_on
    _runtime_on = bool(on)


def set_preempt_hook(fn):
    """Install (or clear, with None) the fuzzer's scheduling hook."""
    global _preempt_hook
    _preempt_hook = fn


def _fast_stack(skip=2, limit=_STACK_LIMIT):
    """Cheap acquisition stack: frame-pointer walk, no source I/O —
    ~µs, so it is affordable on every armed acquire."""
    try:
        f = sys._getframe(skip)
    except ValueError:          # host-ok: shallow stack
        return ()
    out = []
    while f is not None and len(out) < limit:
        co = f.f_code
        out.append("%s:%d in %s" % (co.co_filename, f.f_lineno,
                                    co.co_name))
        f = f.f_back
    return tuple(out)


class _Tls(threading.local):
    def __init__(self):
        # entries: [name, lock_id, site_stack, t_acquired, sampled,
        #           wait_s]
        self.held = []
        # re-entrancy guard: True while the detector itself is doing
        # bookkeeping (histogram records acquire tracked metrics locks —
        # the detector must not observe itself or it recurses)
        self.busy = False


_tls = _Tls()


def held_lock_names():
    """Names of tracked locks the CURRENT thread holds (what guarded_by
    proxies check against)."""
    return {e[0] for e in _tls.held}


# ---------------------------------------------------------------------
# LockRegistry — edges, cycles, contention
# ---------------------------------------------------------------------
class LockRegistry:
    """Process-wide lock-order graph + contention attribution.

    Edges are keyed on lock NAMES (``serving.batcher`` →
    ``recorder.ring``), not instances, so a per-request lock still
    aggregates into one node. Each edge stores the first-observed pair
    of stacks (where the held lock was acquired, where the second
    acquire happened). Adding an edge that makes the target reach back
    to the source closes a cycle → ``lock-order-cycle`` finding naming
    both directions' stacks.
    """

    def __init__(self):
        self._mu = threading.Lock()  # lock-ok: the detector's own state
        # (held_name, acquired_name) -> {held_stack, acquire_stack, count}
        self._edges = {}
        self._adj = {}               # name -> set of successor names
        self._locks = {}             # name -> [weakref(TrackedLock), ...]
        self._findings = []          # finding records (dicts)
        self._seen_cycles = set()    # frozenset(edge pairs) dedupe
        self._seen_violations = set()

    # -- acquisition bookkeeping --------------------------------------
    def register(self, lock):
        """Track a lock instance for contention aggregation (per-lock
        counters live ON the instance — updated while the lock is held,
        so GIL-serialized — and are only summed here on demand)."""
        with self._mu:
            self._locks.setdefault(lock._name, []).append(
                weakref.ref(lock))

    def note_edges(self, held, name):
        """Record held→acquired lock-order edges. Called only when the
        acquiring thread already holds at least one other tracked lock
        (the uncontended single-lock fast path never enters here). The
        exact acquire stack is captured ONLY when an edge is first
        observed — edge counts are hot, stack walks are not."""
        new_findings = []
        with self._mu:
            for entry in held:
                h_name = entry[0]
                if h_name == name:
                    continue          # reentrant same-name: not an edge
                key = (h_name, name)
                edge = self._edges.get(key)
                if edge is None:
                    self._edges[key] = {
                        "held_stack": list(entry[2]),
                        "acquire_stack": list(_fast_stack(skip=4)),
                        "count": 1,
                    }
                    self._adj.setdefault(h_name, set()).add(name)
                    cyc = self._cycle_from(name, h_name)
                    if cyc is not None:
                        rec = self._make_cycle_finding(key, cyc)
                        if rec is not None:
                            new_findings.append(rec)
                else:
                    edge["count"] += 1
        for rec in new_findings:
            _emit(rec)

    # -- cycle detection ----------------------------------------------
    def _cycle_from(self, start, target):
        """DFS: path start → … → target in the name digraph (the new
        edge target→start just closed it). Returns the node path or
        None. Called with self._mu held."""  # holds(_mu)
        stack, seen = [(start, [start])], {start}
        while stack:
            node, path = stack.pop()
            if node == target:
                return path
            for nxt in self._adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _make_cycle_finding(self, new_edge, path):
        """Build the lock-order finding for new_edge (h→a) + the return
        path a→…→h. Called with self._mu held."""  # holds(_mu)
        h_name, a_name = new_edge
        cycle_edges = [new_edge] + [(path[i], path[i + 1])
                                    for i in range(len(path) - 1)]
        sig = frozenset(cycle_edges)
        if sig in self._seen_cycles:
            return None
        self._seen_cycles.add(sig)
        fwd = self._edges[new_edge]
        # the opposing direction: first edge of the return path
        back_key = cycle_edges[1] if len(cycle_edges) > 1 else new_edge
        back = self._edges.get(back_key, fwd)
        order = " -> ".join([h_name, a_name] + path[1:])
        diag = Diagnostic(
            code="lock-order-cycle", severity=Severity.ERROR,
            message=f"potential deadlock: lock-order cycle {order}",
            var=a_name, pass_name="concurrency",
            hint=(f"one thread holds {h_name!r} then takes {a_name!r}; "
                  f"another path takes them in the reverse order — fix "
                  f"by ranking the locks and always acquiring in rank "
                  f"order"))
        rec = {
            "diagnostic": diag,
            "stacks": {
                f"{h_name} -> {a_name}": {
                    "held_acquired_at": fwd["held_stack"],
                    "then_acquired_at": fwd["acquire_stack"],
                },
                f"{back_key[0]} -> {back_key[1]}": {
                    "held_acquired_at": back["held_stack"],
                    "then_acquired_at": back["acquire_stack"],
                },
            },
        }
        self._findings.append(rec)
        return rec

    # -- guarded-by violations ----------------------------------------
    def note_violation(self, label, lock_name, op, stack):
        with self._mu:
            site = stack[0] if stack else "?"
            sig = (label, lock_name, op, site)
            if sig in self._seen_violations:
                return None
            self._seen_violations.add(sig)
            diag = Diagnostic(
                code="guarded-by-violation", severity=Severity.ERROR,
                message=(f"{label} {op} without holding "
                         f"{lock_name!r} (thread "
                         f"{threading.current_thread().name})"),
                var=label, pass_name="concurrency",
                hint=f"wrap the access in `with {lock_name}:` "
                     f"(or annotate the field mode='w' if lock-free "
                     f"reads are intended)")
            rec = {"diagnostic": diag,
                   "stacks": {"access": list(stack)}}
            self._findings.append(rec)
        _emit(rec)
        return rec

    # -- reporting ----------------------------------------------------
    def findings(self):
        with self._mu:
            return [r["diagnostic"] for r in self._findings]

    def finding_records(self):
        with self._mu:
            return [{"diagnostic": r["diagnostic"].to_dict(),
                     "stacks": r["stacks"]} for r in self._findings]

    def clear_findings(self):
        with self._mu:
            self._findings.clear()
            self._seen_cycles.clear()
            self._seen_violations.clear()

    def edges(self):
        with self._mu:
            return {f"{k[0]} -> {k[1]}": dict(v)
                    for k, v in self._edges.items()}

    def contention(self):
        """Per-lock wait-vs-hold attribution (the GET /profile table).

        Aggregated on demand from per-instance counters (same-named
        locks sum into one row). Counter reads are plain attribute
        loads — GIL-atomic — so no per-acquire registry round trip is
        paid to keep this table current. Hold timing is sampled
        (1-in-16 uncontended + every contended acquisition);
        ``hold_total_s`` extrapolates the sampled sum to all
        acquisitions, ``avg_hold_s``/``max_hold_s`` come straight from
        the timed ones."""
        with self._mu:
            by_name = {n: list(refs) for n, refs in self._locks.items()}
        out = {}
        for name in sorted(by_name):
            acq = cont = hn = 0
            wt = ht = wm = hm = 0.0
            live = []
            for ref in by_name[name]:
                lk = ref()
                if lk is None:
                    continue
                live.append(ref)
                acq += lk._acq_n
                cont += lk._cont_n
                hn += lk._hold_n
                wt += lk._wait_total
                ht += lk._hold_total
                wm = max(wm, lk._wait_max)
                hm = max(hm, lk._hold_max)
            if not live:
                with self._mu:      # compact away dead instances
                    if not any(r() for r in self._locks.get(name, ())):
                        self._locks.pop(name, None)
                continue
            if acq == 0:
                continue            # constructed but never acquired
            avg_hold = ht / hn if hn else 0.0
            out[name] = {
                "acquisitions": acq, "contended": cont,
                "wait_total_s": wt, "hold_total_s": avg_hold * acq,
                "max_wait_s": wm, "max_hold_s": hm,
                "avg_wait_s": wt / acq, "avg_hold_s": avg_hold,
            }
        return out

    def reset(self):
        with self._mu:
            self._edges.clear()
            self._adj.clear()
            self._findings.clear()
            self._seen_cycles.clear()
            self._seen_violations.clear()
            refs = [r for lst in self._locks.values() for r in lst]
        # zero live instances' counters but KEEP registrations — a
        # module-level lock acquired after a reset must still show up.
        for ref in refs:
            lk = ref()
            if lk is not None:
                lk._zero_stats()


_registry = LockRegistry()


def lock_registry():
    return _registry


def findings():
    return _registry.findings()


def finding_records():
    return _registry.finding_records()


def clear_findings():
    return _registry.clear_findings()


def _emit(rec):
    """Ring a finding into the FlightRecorder (lazy import; never let
    the detector take the product down)."""
    try:
        from paddle_tpu_torch.observability.recorder import flight_recorder
        d = rec["diagnostic"]
        flight_recorder().record("concurrency_finding", code=d.code,
                                 severity=d.severity, message=d.message)
    except Exception:
        pass


# ---------------------------------------------------------------------
# TrackedLock / TrackedRLock
# ---------------------------------------------------------------------
class TrackedLock:
    """A ``threading.Lock`` that reports to the LockRegistry.

    Duck-types the stdlib lock closely enough that
    ``threading.Condition(TrackedLock(...))`` works (Condition probes
    ownership via ``acquire(False)`` — when this thread holds the lock
    the probe fails, so no spurious edge is recorded). Under the fuzzer
    hook, a blocking acquire becomes a try-acquire loop that yields at
    every failed attempt, which is what lets the scheduler drive
    adversarial interleavings."""

    __slots__ = ("_name", "_lock", "_wait_hist", "_hold_hist", "_site",
                 "_acq_n", "_cont_n", "_wait_total", "_wait_max",
                 "_hold_n", "_hold_total", "_hold_max", "__weakref__")

    _factory = staticmethod(threading.Lock)  # lock-ok: wrapped product

    #: sample 1-in-16 uncontended acquisitions for TIMING (hold clock
    #: reads + wait/hold histogram records); every contended one is
    #: timed, and the 1st always is so the metric families exist after
    #: a single acquire. Edge/held-set bookkeeping — the correctness
    #: core — is NEVER sampled.
    _SAMPLE_MASK = 0xF

    def __init__(self, name):
        self._name = name
        self._lock = self._factory()
        self._wait_hist = None
        self._hold_hist = None
        # first-observed acquisition site (captured once, lazily)
        self._site = None
        # contention counters: mutated only while THIS lock is held, so
        # GIL-atomic += is race-free; LockRegistry.contention() sums
        # them on demand instead of the hot path paying a registry
        # round trip per acquire. Hold timing is sampled — _hold_n
        # counts the timed acquisitions backing _hold_total.
        self._acq_n = 0
        self._cont_n = 0
        self._wait_total = 0.0
        self._wait_max = 0.0
        self._hold_n = 0
        self._hold_total = 0.0
        self._hold_max = 0.0
        _registry.register(self)

    def _zero_stats(self):
        self._acq_n = 0
        self._cont_n = 0
        self._wait_total = 0.0
        self._wait_max = 0.0
        self._hold_n = 0
        self._hold_total = 0.0
        self._hold_max = 0.0

    @property
    def name(self):
        return self._name

    def _hists(self):
        if self._wait_hist is None:
            from paddle_tpu_torch.observability.metrics import registry
            reg = registry()
            self._wait_hist = reg.histogram(
                "pt_lock_wait_seconds",
                "time spent waiting to acquire a named lock "
                "(concurrency_check)", labels=("lock",),
            ).labels(lock=self._name)
            self._hold_hist = reg.histogram(
                "pt_lock_hold_seconds",
                "time a named lock was held per acquisition "
                "(concurrency_check)", labels=("lock",),
            ).labels(lock=self._name)
        return self._wait_hist, self._hold_hist

    def acquire(self, blocking=True, timeout=-1):
        if not _runtime_on or _tls.busy:
            return self._lock.acquire(blocking, timeout)  # lock-ok: wrapped
        hook = _preempt_hook
        if hook is not None and blocking and timeout < 0:
            contended = False
            t0 = time.perf_counter()
            hook("before_acquire", self._name)
            while not self._lock.acquire(False):  # lock-ok: wrapped
                contended = True
                hook("blocked", self._name)
            wait_s = (time.perf_counter() - t0) if contended else 0.0
            self._on_acquired(wait_s, contended)
            hook("acquired", self._name)
            return True
        # uncontended fast path: no clock read for the wait interval
        if self._lock.acquire(False):  # lock-ok: wrapped
            self._on_acquired(0.0, False)
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        if not self._lock.acquire(True, timeout):  # lock-ok: wrapped
            return False
        self._on_acquired(time.perf_counter() - t0, True)
        return True

    def _on_acquired(self, wait_s, contended):
        site = self._site
        if site is None:
            _tls.busy = True
            try:
                site = self._site = _fast_stack(skip=3)
            finally:
                _tls.busy = False
        held = _tls.held
        if held:
            # another tracked lock is already held — this is the only
            # path that touches the global registry (edge bookkeeping)
            _tls.busy = True
            try:
                _registry.note_edges(held, self._name)
            finally:
                _tls.busy = False
        n = self._acq_n = self._acq_n + 1
        if contended:
            self._cont_n += 1
            self._wait_total += wait_s
            if wait_s > self._wait_max:
                self._wait_max = wait_s
            sampled = True
        else:
            sampled = (n & self._SAMPLE_MASK) == 1
        # timing (clock reads + histogram records) happens only on
        # sampled cycles; histogram recording is further DEFERRED to
        # release — after the underlying lock is dropped — so the
        # detector never lengthens the product's critical section
        # (longer holds under load amplify queueing far beyond the
        # bookkeeping cost itself)
        if sampled:
            held.append([self._name, id(self), site,
                         time.perf_counter(), True, wait_s])
        else:
            held.append([self._name, id(self), site, 0.0, False, 0.0])

    def release(self):
        # pop the matching held entry if present (it may be absent when
        # the acquire happened while the kill-switch was off)
        held = _tls.held
        me = id(self)
        entry = None
        if held and held[-1][1] == me:     # LIFO common case
            entry = held.pop()
        else:
            for i in range(len(held) - 1, -1, -1):
                if held[i][1] == me:
                    entry = held.pop(i)
                    break
        hold_s = 0.0
        record = False
        if (entry is not None and entry[4] and _runtime_on
                and not _tls.busy):
            # still holding the lock here → GIL-serialized updates
            hold_s = time.perf_counter() - entry[3]
            self._hold_n += 1
            self._hold_total += hold_s
            if hold_s > self._hold_max:
                self._hold_max = hold_s
            record = True
        self._lock.release()
        if record:
            # sampled/contended acquisition: record wait+hold pair now,
            # outside the critical section
            _tls.busy = True
            try:
                try:
                    wait_h, hold_h = self._hists()
                    wait_h.record(entry[5])
                    hold_h.record(hold_s)
                except Exception:
                    pass
            finally:
                _tls.busy = False
        hook = _preempt_hook
        if hook is not None and _runtime_on:
            hook("released", self._name)

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()  # lock-ok: wrapped
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<TrackedLock {self._name!r}>"


class TrackedRLock(TrackedLock):
    """Reentrant variant: only the outermost acquire/release records
    (inner levels are invisible to lock ordering — the thread already
    owns the lock, so no new edge and no new hold interval)."""

    __slots__ = ("_depth_tls",)

    _factory = staticmethod(threading.RLock)  # lock-ok: wrapped product

    def __init__(self, name):
        super().__init__(name)
        self._depth_tls = threading.local()

    def _depth(self):
        return getattr(self._depth_tls, "d", 0)

    def acquire(self, blocking=True, timeout=-1):
        if not _runtime_on:
            got = self._lock.acquire(blocking, timeout)  # lock-ok: wrapped
            if got:
                self._depth_tls.d = self._depth() + 1
            return got
        if self._depth():
            got = self._lock.acquire(blocking, timeout)  # lock-ok: wrapped
            if got:
                self._depth_tls.d = self._depth() + 1
            return got
        got = super().acquire(blocking, timeout)  # lock-ok: wrapped
        if got:
            self._depth_tls.d = 1
        return got

    def release(self):
        d = self._depth()
        if d > 1:
            self._depth_tls.d = d - 1
            self._lock.release()
            return
        self._depth_tls.d = 0
        super().release()

    def locked(self):
        # RLock has no .locked() before 3.12; probe-based fallback
        if self._depth():
            return True
        if self._lock.acquire(False):  # lock-ok: ownership probe
            self._lock.release()
            return False
        return True

    # Condition protocol: the stdlib fallback probes ownership with
    # acquire(False), which SUCCEEDS on a reentrant lock the thread
    # already owns (wrong answer) — so provide the real protocol.
    def _is_owned(self):
        return self._depth() > 0

    def _release_save(self):
        d = self._depth()
        for _ in range(d):
            self.release()
        return d

    def _acquire_restore(self, d):
        for _ in range(d):
            self.acquire()  # lock-ok: wrapped


def make_lock(name):
    """The one lock constructor for product code. Plain
    ``threading.Lock`` normally; TrackedLock when the detector is armed
    (PT_FLAGS_concurrency_check) — so detector-off overhead is
    structurally zero."""
    if checking_enabled():
        return TrackedLock(name)
    return threading.Lock()  # lock-ok: factory product


def make_rlock(name):
    if checking_enabled():
        return TrackedRLock(name)
    return threading.RLock()  # lock-ok: factory product


def make_condition(name, lock=None):
    """Condition over a named lock (Condition duck-types onto
    TrackedLock via acquire/release + the acquire(False) ownership
    probe). cond.wait()'s release/reacquire flows through the tracked
    acquire/release, keeping the held-set correct across waits."""
    if lock is None:
        lock = make_rlock(name)
    return threading.Condition(lock)  # lock-ok: factory product


# ---------------------------------------------------------------------
# guarded_by — runtime shared-state access checking
# ---------------------------------------------------------------------
class _GuardedProxy:
    """Forwarding wrapper that checks the holding thread's lock set on
    every access. Dunders are forwarded explicitly (Python looks them
    up on the type, not the instance); everything else flows through
    __getattr__. ``mode='w'`` checks only mutating operations (for
    structures that deliberately allow lock-free reads)."""

    __slots__ = ("_cc_obj", "_cc_label", "_cc_lock", "_cc_writes_only")

    def __init__(self, obj, label, lock_name, mode):
        object.__setattr__(self, "_cc_obj", obj)
        object.__setattr__(self, "_cc_label", label)
        object.__setattr__(self, "_cc_lock", lock_name)
        object.__setattr__(self, "_cc_writes_only", mode == "w")

    def _cc_held(self):
        """True when no check is due (detector quiet / bookkeeping in
        flight) or this thread holds the guard lock. Hot — runs on
        EVERY proxied access, so it scans the thread's small held list
        directly instead of materializing a set."""
        if not _runtime_on or _tls.busy:
            return True
        name = self._cc_lock
        for e in _tls.held:
            if e[0] == name:
                return True
        return False

    def _cc_violate(self, op):
        # skip=3: _fast_stack / _cc_violate / the dunder → start the
        # reported stack at the product call site
        _registry.note_violation(self._cc_label, self._cc_lock, op,
                                 _fast_stack(skip=3))

    # reads
    def __len__(self):
        if not (self._cc_writes_only or self._cc_held()):
            self._cc_violate("len()")
        return len(self._cc_obj)

    def __iter__(self):
        if not (self._cc_writes_only or self._cc_held()):
            self._cc_violate("iteration")
        return iter(self._cc_obj)

    def __contains__(self, item):
        if not (self._cc_writes_only or self._cc_held()):
            self._cc_violate("membership test")
        return item in self._cc_obj

    def __getitem__(self, key):
        # key formatting deferred to the violation path — this read is
        # inside heap/scan loops on the armed request path
        if not (self._cc_writes_only or self._cc_held()):
            self._cc_violate("read [%r]" % (key,))
        return self._cc_obj[key]

    def __bool__(self):
        if not (self._cc_writes_only or self._cc_held()):
            self._cc_violate("truth test")
        return bool(self._cc_obj)

    def __eq__(self, other):
        return self._cc_obj == other

    def __ne__(self, other):
        return self._cc_obj != other

    def __hash__(self):
        return id(self)

    # writes
    def __setitem__(self, key, value):
        if not self._cc_held():
            self._cc_violate("write [%r]" % (key,))
        self._cc_obj[key] = value

    def __delitem__(self, key):
        if not self._cc_held():
            self._cc_violate("delete [%r]" % (key,))
        del self._cc_obj[key]

    # method forwarding (append/popleft/add/…)
    def __getattr__(self, attr):
        if not ((self._cc_writes_only and attr not in _MUTATORS)
                or self._cc_held()):
            self._cc_violate(attr)
        return getattr(self._cc_obj, attr)

    def __repr__(self):
        return "<guarded_by(%s) %r>" % (self._cc_lock,
                                        repr(self._cc_obj))


def guard_value(value, label, lock_name, mode="rw"):
    """Wrap `value` in an access-checking proxy when the detector is
    armed; return it untouched otherwise (zero overhead off)."""
    if not checking_enabled():
        return value
    return _GuardedProxy(value, label, lock_name, mode)


def guarded_by(obj, field, lock_name, mode="rw"):
    """Annotate ``obj.<field>`` as guarded by the named lock: rebinds
    the attribute to a checking proxy when armed. Call right after the
    field is initialised; the static arm (astlint) independently
    enforces the matching ``# guarded_by(<lock>)`` source comment."""
    value = getattr(obj, field)
    wrapped = guard_value(
        value, "%s.%s" % (type(obj).__name__, field), lock_name, mode)
    if wrapped is not value:
        setattr(obj, field, wrapped)
    return wrapped


def unwrap(value):
    """The plain object behind a guarded proxy (identity otherwise)."""
    if isinstance(value, _GuardedProxy):
        return value._cc_obj
    return value


# ---------------------------------------------------------------------
# reporting surfaces
# ---------------------------------------------------------------------
def profile_section():
    """The GET /profile "concurrency" document: per-lock wait-vs-hold
    attribution + lock-order edges + findings. None when the detector
    is off (the section is omitted)."""
    if not checking_enabled():
        return None
    return {
        "enabled": True,
        "locks": _registry.contention(),
        "edges": {k: v["count"] for k, v in _registry.edges().items()},
        "findings": [r["diagnostic"]
                     for r in _registry.finding_records()],
    }


def write_report(path):
    """The JSON report: findings with both stacks and the contention
    table (also written at exit to $PT_CONCURRENCY_REPORT)."""
    doc = {
        "enabled": checking_enabled(),
        "findings": _registry.finding_records(),
        "locks": _registry.contention(),
        "edges": _registry.edges(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, default=str)
    os.replace(tmp, path)
    return doc


def _atexit_report():
    path = os.environ.get("PT_CONCURRENCY_REPORT")
    if path:
        try:
            write_report(path)
        except Exception:
            pass


atexit.register(_atexit_report)


def reset_for_tests():
    """Drop all registry state + hooks (test isolation)."""
    global _preempt_hook, _runtime_on
    _preempt_hook = None
    _runtime_on = True
    _registry.reset()
    _tls.held.clear()
