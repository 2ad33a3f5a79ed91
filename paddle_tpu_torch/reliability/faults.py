"""Deterministic fault injection.

Counterpart of paddle_tpu/reliability/faults.py: the serving pool's
`serving.run_batch`, the gateway's `gateway.*` sites (serving/gateway.py,
serving/registry.py) and its stream writes, the wire client's
`fleet.journal_replay`, the `generation.*` sites of the generation
server (serving/generation.py) and of the paged engine's spill tier and
state documents (ops/generation.py), the Predictor's `predictor.run`,
the params files' `io.*` sites (inference/, static/io.py), the compile
cache's `compile_cache.*` (core/compile_cache.py), the checkpoints'
`checkpoint.*` and the train loop's `train.step` (reliability/), and
the fleet's `fleet.*` (fleet/), and the parameter-server client's
`ps.transport` / `ps.transport.after` (ps/). Named `inject_point()`
calls sit on the
live paths, inert until a `FaultPlan` is armed — in code
(`set_fault_plan` / the `fault_plan` context manager) or from
PT_FLAGS_fault_plan on the first `get_fault_plan()`, which is how a
spawned backend or a supervised worker gets its chaos plan; then each
hit consults the plan and may raise, delay, hang, NaN-poison or crash,
deterministically, so a chaos run replays bit-for-bit.

Plan grammar::

    plan   := rule (';' rule)*
    rule   := site ['@' hits] ':' action
    site   := fnmatch pattern over "name" or "name:tag"
    hits   := N | N..M | N.. | '*'        1-based per-rule hit index
            | 'p' FLOAT '/' SEED          seeded Bernoulli per hit
    action := raise | raise(msg) | delay(seconds) | hang | hang(seconds)
            | nan | crash | crash(code)

Hit counting is per (rule, exact site key).
"""
import fnmatch
import threading

from paddle_tpu_torch.analysis.concurrency import make_lock
import time
import zlib

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "FaultError", "FaultPlanError", "FaultPlan", "KNOWN_SITES",
    "inject_point", "set_fault_plan", "get_fault_plan", "fault_plan",
    "reset_to_flags",
]

#: Every registered choke point of the port (the test suite checks that
#: each has a call site).
KNOWN_SITES = (
    "serving.run_batch",     # serving/pool.py        per-replica batch
                             #   (tag: r<replica>): a raise fails the
                             #   batch, which retries on a healthy
                             #   replica; `nan` poisons its outputs
    "gateway.accept",        # serving/gateway.py       per accepted
                             #   connection, BEFORE its handler thread:
                             #   a raise drops that connection (the
                             #   acceptor must survive the storm)
    "gateway.read",          # serving/gateway.py       after each
                             #   inbound wire frame: a raise models a
                             #   torn/poisoned read — the connection
                             #   dies, the gateway does not
    "gateway.write",         # serving/gateway.py       before each
                             #   response write (tags: wire|http): a
                             #   raise models a client that stopped
                             #   reading
    "gateway.swap",          # serving/registry.py      model-version
                             #   cutover stage boundaries (tags: load|
                             #   verify|prewarm|commit|drain) — kill a
                             #   swap at any stage; pre-commit kills
                             #   must roll back, post-commit kills must
                             #   leave the new version serving
    "generation.stream_write",  # serving/gateway.py    before each
                             #   streamed token frame (tags: wire|http):
                             #   a raise is a client gone mid-stream —
                             #   its decode slot frees on the next tick
    "fleet.journal_replay",  # serving/wire.py          a resumed
                             #   stream's re-dispatch: a raise dies
                             #   before the wire, the journal survives
    "generation.prefill",    # serving/generation.py    per slot
                             #   admission (tag: s<slot>): a raise fails
                             #   THAT request; the slot and every
                             #   running request survive
    "generation.decode_step",  # serving/generation.py  per decode tick:
                             #   a raise skips the tick with the cache
                             #   carry untouched, so the retried step is
                             #   exact (delay/hang model a slow device)
    "generation.block_alloc",  # serving/generation.py  per paged
                             #   admission (tag: s<slot>), BEFORE any
                             #   block is taken: a raise fails THAT
                             #   request with the pool accounting
                             #   untouched (exhaustion is NOT a fault —
                             #   it parks)
    "generation.draft_step",  # serving/generation.py   per speculative
                             #   tick, around the host-side draft: a
                             #   raise degrades the tick to plain
                             #   chunk=1 decoding — output parity MUST
                             #   hold, only tokens/tick drops
    "generation.verify_step",  # serving/generation.py  per speculative
                             #   tick, before the chunk verify: a raise
                             #   skips the tick with committed lengths
                             #   untouched, so the retried tick is
                             #   exact
    "generation.state_export",  # ops/generation.py     before a
                             #   DecodeState export (tag: slot): a raise
                             #   is a snapshot that failed — the live
                             #   slot is unaffected (export only reads)
    "generation.state_import",  # ops/generation.py     before a
                             #   DecodeState import: a raise (or a CRC
                             #   mismatch) leaves pool and spill
                             #   untouched — import is all-or-nothing
    "generation.spill_write",   # ops/generation.py     before a CACHED
                             #   block demotes to the host spill store
                             #   (tag: chain hash): a raise drops the
                             #   payload — the next admit re-prefills
    "generation.spill_read",    # ops/generation.py     on a spill-hit
                             #   promote (tag: chain hash): a raise is a
                             #   lost payload — admit falls back to
                             #   prefill, never a corrupt slot
    "predictor.run",         # inference/__init__.py   per Predictor.run,
                             #   after the outputs are computed: a raise
                             #   fails that request, `nan` poisons its
                             #   outputs; the predictor stays usable
    "io.save_persistables",  # static/io.py  between a params file's write
                             #   and its rename: a raise leaves the
                             #   previous file intact (atomic publish)
    "io.load_persistables",  # static/io.py  before a params file is read
    "checkpoint.write",      # reliability/checkpoint.py  after the
                             #   snapshot and its manifest are on disk,
                             #   BEFORE the publish: a raise leaves only
                             #   the inert .tmp
    "checkpoint.read",       # reliability/checkpoint.py  pre-restore
    "ps.transport",          # ps/__init__.py  client RPC edge, BEFORE
                             #   the wire (tag: verb): a raise is a
                             #   connect refused / a request never sent,
                             #   always retry-safe
    "ps.transport.after",    # ps/__init__.py  push verbs, AFTER the
                             #   server applied: a raise is the reply
                             #   lost mid-verb, which the seq-stamped
                             #   at-most-once push exists for
    "train.step",            # reliability/training.py  per completed
                             #   step (tag: steps done): `crash` at hit N
                             #   is the supervised-restart drill
    "compile_cache.read",    # core/compile_cache.py  per entry read
                             #   (tag: key-hash prefix): a raise is a
                             #   torn cache volume — a clean miss and a
                             #   capture, never a crash or a wrong hit
    "compile_cache.write",   # core/compile_cache.py  per entry publish:
                             #   a raise is a full disk — a clean reject,
                             #   the temporary file removed
    "fleet.dial",            # fleet/router.py  before each backend
                             #   connect (tag: backend): the router
                             #   re-routes, the client never sees it
    "fleet.forward",         # fleet/router.py  before each relay send
                             #   (tag: backend): idempotent requests
                             #   replay on another backend, streams fail
                             #   over through the journal
    "fleet.heartbeat",       # fleet/router.py  per received beat (tag:
                             #   backend): a beat lost in the network —
                             #   dropped silently; enough of them walk
                             #   the liveness FSM to SUSPECT -> LOST
    "fleet.spawn",           # fleet/backend.py  FleetManager.spawn,
                             #   after the placement vet, before the
                             #   process exists: the autoscaler absorbs
                             #   it (counter + timeline)
    "fleet.stream_resume",   # fleet/router.py  before a dead stream
                             #   re-dispatches to a peer (tag: peer): the
                             #   journal survives, the next peer resumes
    "fleet.takeover",        # fleet/router.py  inside promote(), before
                             #   the standby takes the active role: a
                             #   raise aborts THIS attempt, the monitor
                             #   retries
    "fleet.adopt",           # fleet/discovery.py  per backend re-adopted
                             #   from a snapshot: a raise skips THAT
                             #   backend — it rejoins on its next beat
    "fleet.snapshot_write",  # fleet/discovery.py  directory snapshot,
                             #   doc on disk, manifest not yet published:
                             #   the previous snapshot stays the newest
                             #   valid one
    "fleet.snapshot_read",   # fleet/discovery.py  per validated snapshot
                             #   read: the walk falls back to the next
                             #   older snapshot
)

_DEFAULT_HANG_S = 30.0
_DEFAULT_CRASH_CODE = 17


class FaultError(RuntimeError):
    """An injected fault fired (carries the site key that raised it)."""

    def __init__(self, site, message=None):
        super().__init__(message or f"injected fault at {site}")
        self.site = site


class FaultPlanError(ValueError):
    """The fault-plan spec string does not parse."""


class _Rule:
    __slots__ = ("pattern", "lo", "hi", "prob", "seed", "action", "arg",
                 "spec")

    def __init__(self, pattern, lo, hi, prob, seed, action, arg, spec):
        self.pattern = pattern
        self.lo, self.hi = lo, hi          # 1-based inclusive hit range
        self.prob, self.seed = prob, seed  # seeded-Bernoulli alternative
        self.action, self.arg = action, arg
        self.spec = spec

    def matches(self, name, key):
        return (fnmatch.fnmatchcase(name, self.pattern)
                or fnmatch.fnmatchcase(key, self.pattern))

    def fires(self, key, hit):
        """Deterministic decision for the `hit`-th (1-based) match of
        this rule at `key`."""
        if self.prob is not None:
            h = zlib.crc32(f"{self.seed}:{key}:{hit}".encode()) / 2 ** 32
            return h < self.prob
        return self.lo <= hit and (self.hi is None or hit <= self.hi)


def _parse_hits(text, spec):
    if text == "*":
        return 1, None, None, None
    if text.startswith("p"):
        body = text[1:]
        if "/" not in body:
            raise FaultPlanError(
                f"bad hits {text!r} in {spec!r}: seeded form is pP/SEED")
        p, seed = body.split("/", 1)
        try:
            return None, None, float(p), int(seed)
        except ValueError:
            raise FaultPlanError(f"bad probability/seed in {spec!r}")
    if ".." in text:
        lo, hi = text.split("..", 1)
        try:
            return int(lo), (int(hi) if hi else None), None, None
        except ValueError:
            raise FaultPlanError(f"bad hit range {text!r} in {spec!r}")
    try:
        n = int(text)
        return n, n, None, None
    except ValueError:
        raise FaultPlanError(f"bad hit count {text!r} in {spec!r}")


def _parse_action(text, spec):
    text = text.strip()
    name, arg = text, None
    if "(" in text:
        if not text.endswith(")"):
            raise FaultPlanError(f"unclosed action arg in {spec!r}")
        name, arg = text[:text.index("(")], text[text.index("(") + 1:-1]
    if name not in ("raise", "delay", "hang", "nan", "crash"):
        raise FaultPlanError(
            f"unknown action {name!r} in {spec!r} "
            f"(raise|delay|hang|nan|crash)")
    if name == "delay":
        try:
            arg = float(arg)
        except (TypeError, ValueError):
            raise FaultPlanError(f"delay needs seconds: {spec!r}")
    elif name == "hang":
        arg = float(arg) if arg else _DEFAULT_HANG_S
    elif name == "crash":
        try:
            arg = int(arg) if arg else _DEFAULT_CRASH_CODE
        except ValueError:
            raise FaultPlanError(f"crash needs an int exit code: {spec!r}")
    return name, arg


class FaultPlan:
    """A parsed, seeded set of fault rules with per-rule hit counters.

    Thread-safe: serving workers hit the same plan concurrently. The
    counters make ranged rules deterministic; `stats()` exposes them so
    a chaos test can assert a plan actually fired.
    """

    def __init__(self, spec=""):
        self.spec = spec or ""
        self.rules = []
        self._lock = make_lock("faults.plan")
        self._hits = {}        # (rule_idx, key) -> count
        self._site_hits = {}   # key -> count (fired or not)
        self._fired = {}       # key -> count
        self._release = threading.Event()
        for part in filter(None,
                           (p.strip() for p in self.spec.split(";"))):
            if ":" not in part:
                raise FaultPlanError(
                    f"rule {part!r} has no action (site[@hits]:action)")
            # the action is the text after the LAST ':' — site patterns
            # may themselves contain ':' (name:tag keys)
            head, action_text = part.rsplit(":", 1)
            if "@" in head:
                site, hits_text = head.rsplit("@", 1)
                lo, hi, prob, seed = _parse_hits(hits_text.strip(), part)
            else:
                site, (lo, hi, prob, seed) = head, (1, None, None, None)
            action, arg = _parse_action(action_text, part)
            enforce(site.strip(), "empty site pattern in %r", part)
            self.rules.append(_Rule(site.strip(), lo, hi, prob, seed,
                                    action, arg, part))

    def release(self):
        """Open every pending (and future) `hang` at once."""
        self._release.set()

    def stats(self):
        with self._lock:
            return {"spec": self.spec,
                    "hits": dict(self._site_hits),
                    "fired": dict(self._fired)}

    # -- firing --------------------------------------------------------
    def actions_for(self, name, tag):
        key = name if tag is None else f"{name}:{tag}"
        out = []
        with self._lock:
            self._site_hits[key] = self._site_hits.get(key, 0) + 1
            for i, rule in enumerate(self.rules):
                if not rule.matches(name, key):
                    continue
                hk = (i, key)
                self._hits[hk] = hit = self._hits.get(hk, 0) + 1
                if rule.fires(key, hit):
                    self._fired[key] = self._fired.get(key, 0) + 1
                    out.append(rule)
        return key, out

    def apply(self, rule, key, value):
        if rule.action == "delay":
            time.sleep(rule.arg)
        elif rule.action == "hang":
            self._release.wait(rule.arg)
        elif rule.action == "nan":
            value = _nan_poison(value)
        elif rule.action == "crash":
            # hard worker death (no atexit, no finally blocks) — the
            # SIGKILL-class failure an elastic supervisor must absorb
            import os
            import sys
            sys.stderr.write(f"injected crash({rule.arg}) at {key}\n")
            sys.stderr.flush()
            os._exit(rule.arg)
        elif rule.action == "raise":
            raise FaultError(key, rule.arg and
                             f"injected fault at {key}: {rule.arg}")
        return value


def _nan_poison(value):
    """NaN every float leaf of `value` (dict/list/tuple of arrays) —
    the bit-corruption analogue: shapes survive, numerics do not."""
    import numpy as np
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _nan_poison(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_nan_poison(v) for v in value)
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        return np.full_like(arr, np.nan)
    return value


# --- process-global active plan --------------------------------------
_UNSET = object()
_active = _UNSET
_active_lock = make_lock("faults.active")


def set_fault_plan(plan):
    """Arm a plan (FaultPlan, spec string, or None to disarm). Returns
    the armed FaultPlan (or None)."""
    global _active
    if isinstance(plan, str):
        plan = FaultPlan(plan) if plan else None
    with _active_lock:
        _active = plan
    return plan


def reset_to_flags():
    """Forget the armed plan: the next `get_fault_plan()` re-reads
    PT_FLAGS_fault_plan."""
    global _active
    with _active_lock:
        _active = _UNSET


def get_fault_plan():
    """The armed plan (or None), armed from PT_FLAGS_fault_plan on first
    use, so a child process gets its chaos plan through its environment
    alone."""
    global _active
    if _active is _UNSET:
        with _active_lock:
            if _active is _UNSET:
                spec = _flags.get_flag("fault_plan")
                _active = FaultPlan(spec) if spec else None
    return _active


class fault_plan:
    """Context manager: arm `spec` inside the block, restore after.

    >>> with fault_plan("checkpoint.write@1:raise") as plan:
    ...     ...
    >>> plan.stats()["fired"]
    """

    def __init__(self, spec):
        self.plan = FaultPlan(spec) if isinstance(spec, str) else spec

    def __enter__(self):
        self._prev = get_fault_plan()
        set_fault_plan(self.plan)
        return self.plan

    def __exit__(self, *exc):
        self.plan.release()      # never leave a hang armed
        set_fault_plan(self._prev)


def inject_point(name, tag=None, value=None):
    """A named choke point. Inert (returns `value`) unless a plan is
    armed and a rule fires for this hit; then the rule's action runs:
    `raise` throws FaultError, `delay`/`hang` stall, `nan` returns a
    NaN-poisoned copy of `value`. Register new names in KNOWN_SITES."""
    plan = get_fault_plan()
    if plan is None:
        return value
    key, rules = plan.actions_for(name, tag)
    for rule in rules:
        value = plan.apply(rule, key, value)
    return value
