"""Deterministic fault injection.

Counterpart of paddle_tpu/reliability/faults.py for the choke points the
port has so far: the generation server's `generation.*` sites. Named
`inject_point()` calls sit on the live serving path, inert until a
`FaultPlan` is armed (`set_fault_plan` / the `fault_plan` context
manager); then each hit consults the plan and may raise, delay, hang or
NaN-poison, deterministically, so a chaos run replays bit-for-bit. The
reference also arms a plan from PT_FLAGS_fault_plan; the port arms plans
in code only.

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

from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "FaultError", "FaultPlanError", "FaultPlan", "KNOWN_SITES",
    "inject_point", "set_fault_plan", "get_fault_plan", "fault_plan",
]

#: Every registered choke point of the port (the test suite checks that
#: each has a call site).
KNOWN_SITES = (
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
_active = None
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


def get_fault_plan():
    """The armed plan, or None."""
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
