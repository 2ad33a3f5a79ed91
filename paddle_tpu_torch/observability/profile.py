"""Executables: what replaces `jax.jit` in the port, its compile ledger,
runtime attribution and memory ledger.

Counterpart of paddle_tpu/observability/profile.py. The JAX package
compiles every engine rung, train step and Executor entry once per
signature (`ProfiledJit` :715, `LedgerJit` :858) and records each
compile in the `CompileLedger` (:301). On the card the port's
counterpart of a compiled executable is one captured CUDA graph per
signature: the rung keeps its kernels and its order of operations and
is launched once.

* **`profiled_graph(fn, component, name, ...)`** (alias `profiled_jit`):
  on a CUDA device the first call of a signature (`dispatch_key` of the
  arguments plus the static kwargs) runs `fn` once eagerly on the
  wrapper's side stream (that run is the call: it builds the kernels,
  warms the allocator and gives the call's result), captures `fn` into a
  `torch.cuda.CUDAGraph` over static input buffers and a memory pool the
  wrapper owns, and records one `CompileRecord` (kind "graph",
  `compile_s` the warm-up and capture wall time). A warm call copies its
  tensor arguments into the static buffers, replays the graph and
  records its wall time through `observe_run`. Arguments named in
  `bound` (an engine's KV pools, a train step's parameters) are not
  copied: the graph holds them, and a replay with other tensors raises.
  Outputs are the graph's static tensors, valid until the next call of
  the same wrapper. On the CPU, which a caller must ask for, `fn` runs
  eagerly and the first sight of each signature is recorded with kind
  "eager", so the ledger can be held against the JAX one.
* There is no fallback: a capture that fails raises `CaptureError`
  naming the rung, after the eager warm-up ran. `disable_capture()` (the
  counterpart of `jax.disable_jit()`) is the one way to run eagerly on
  the card; the tests and chip_smoke's eager controls use it.
  `PT_FLAGS_profile_compile_ledger=0` turns the ledger off, never the
  capture.
* **Launch counts.** A kernel wrapper bumps its `launch_counts` in
  Python, which a replay does not run. Each graph keeps the launches its
  capture saw (and takes them back from the counters, as the captured
  kernels did not run then) and adds them on every replay.
* **Static cost.** `flops` is `torch.utils.flop_counter.FlopCounterMode`
  over the warm-up run plus what the hand-written kernels report for
  their own launches (`note_kernel_flops`; the flop counter does not see
  ctypes calls). Bytes are unknown (None), as the JAX package degrades.
* **Memory.** `peak_bytes` is the `max_memory_allocated` growth over the
  capture (the peak statistics are reset just before it), `pool_bytes`
  the bytes the wrapper's graph pool holds after it (its graphs share
  one pool); None on the CPU.
* **`LedgerJit`**: the Executor's entries (`executor/...` sites). On the
  card each segment of a program's capture plan (core/lowering.py) is
  one graph per input signature, bound to the scope's state tensors,
  which a training run updates in place; one "graph" record per run
  that captured. On the CPU the step runs eagerly, recorded as "eager".
  `ledger_jit(fn, site=)`, the JAX package's name, is
  `profiled_graph(fn, "executor", site)`.
* **The capture gate.** A capture in the default (global) capture mode
  fails when any other thread of the process makes a CUDA call that is
  not capture-safe (a synchronizing copy, an allocation from the
  driver). `capture_gate()` is the process's reader-writer gate:
  Executor runs (their feed copies, replays and fetch copies) and a
  GenerationServer's ticks hold it shared, a capture holds it
  exclusively (a thread that holds it shared gives its hold up while it
  captures). So a model version being prewarmed while another serves
  captures between two of the other's replays, never during one; the
  gate's `stats()` keeps how long captures held it and how long shared
  holders waited (the pause a hot swap costs traffic).
* **MemoryLedger** samples `torch.cuda.memory_stats` (an injectable
  reader for tests), keeps the peak watermark, per-tag deltas and a
  monotonic-growth leak detector.

Exposition: `profile_snapshot()` (ledger, executable stats, memory,
compile-cache stats, peak flops, the capture gate and the planner's
"plan_check" cross-check of its estimates against the captures' peaks,
and the lock checker's "concurrency" section when
PT_FLAGS_concurrency_check armed it) and `chrome_events()` (captures and
executable runs on the tracer's perf_counter timebase).
"""
import collections
import contextlib
import contextvars
import gc
import math
import os
import threading
import time
import weakref

import numpy as np
from torch import Generator as _Generator
from torch import Tensor as _Tensor

from paddle_tpu_torch.analysis.concurrency import (make_condition, make_lock,
                                                   make_rlock)
from paddle_tpu_torch.core import flags as _flags

__all__ = [
    "CompileRecord", "CompileLedger", "compile_ledger",
    "MemoryLedger", "memory_ledger",
    "attribution", "current_attribution",
    "ProfiledGraph", "profiled_graph", "profiled_jit", "LedgerJit",
    "ExecutorPool", "CaptureGate", "capture_gate", "warm_capture",
    "ledger_jit", "CaptureError", "disable_capture", "capture_disabled",
    "observe_run", "executable_stats", "signature_of", "dispatch_key",
    "diff_signatures", "peak_flops", "note_kernel_flops",
    "register_launch_counts", "profile_snapshot", "chrome_events",
    "reset_profile",
]

_clock = time.perf_counter


def enabled():
    return bool(_flags.get_flag("profile_compile_ledger"))


# ---------------------------------------------------------------------------
# signatures + forensics
# ---------------------------------------------------------------------------

def _dtype_name(dtype):
    """numpy's name of a dtype ("float32", "int32", "bool"), for torch
    and numpy dtypes alike, so labels read as the JAX package's."""
    s = str(dtype)
    return s[6:] if s.startswith("torch.") else s


def _leaf_sig(leaf):
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return ((), type(leaf).__name__)
    return (tuple(int(d) for d in shape), _dtype_name(dtype))


def _flatten(tree, path):
    """(path, leaf) pairs in the JAX package's order and key notation:
    dicts by sorted key ("['x']"), sequences by index ("[0]"), named
    tuples by field (".cache_k"); None holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def _leaves(tree):
    return [leaf for _, leaf in _flatten(tree, "")]


def signature_of(args, arg_names=None):
    """Stable (label, shape, dtype) triples of a call's arguments.
    `arg_names` labels the top-level positional arguments, deeper
    structure keeps its key path ("feed['x']")."""
    out = []
    for i, arg in enumerate(args):
        head = (arg_names[i] if arg_names is not None
                and i < len(arg_names) else f"[{i}]")
        for label, leaf in _flatten(arg, head):
            shape, dtype = _leaf_sig(leaf)
            out.append((label, shape, dtype))
    return tuple(out)


def dispatch_key(args):
    """The hot-path cache key: shapes and dtypes of the leaves only."""
    return tuple(_leaf_sig(leaf) for leaf in _leaves(tuple(args)))


def diff_signatures(prev, new):
    """Name exactly what changed between two argument signatures:
    per-argument shape/dtype deltas plus added/removed arguments.
    Returns None when identical."""
    if prev == new:
        return None
    prev_by = {label: (shape, dtype) for label, shape, dtype in prev}
    new_by = {label: (shape, dtype) for label, shape, dtype in new}
    changed = []
    for label, (shape, dtype) in new_by.items():
        if label in prev_by and prev_by[label] != (shape, dtype):
            pshape, pdtype = prev_by[label]
            changed.append({"arg": label,
                            "prev_shape": list(pshape),
                            "new_shape": list(shape),
                            "prev_dtype": pdtype, "new_dtype": dtype})
    added = sorted(set(new_by) - set(prev_by))
    removed = sorted(set(prev_by) - set(new_by))
    parts = [f"{c['arg']}: {tuple(c['prev_shape'])}/{c['prev_dtype']}"
             f" -> {tuple(c['new_shape'])}/{c['new_dtype']}"
             for c in changed]
    if added:
        parts.append(f"added {added}")
    if removed:
        parts.append(f"removed {removed}")
    return {"changed": changed, "added": added, "removed": removed,
            "text": "; ".join(parts) or "argument structure changed"}


# ---------------------------------------------------------------------------
# attribution context
# ---------------------------------------------------------------------------

class _Attribution:
    __slots__ = ("component", "key", "scope", "tags")

    def __init__(self, component, key, scope, tags):
        self.component = component
        self.key = key
        self.scope = scope
        self.tags = tags


_attr_var = contextvars.ContextVar("pt_profile_attr", default=None)


@contextlib.contextmanager
def attribution(component, key=None, scope=None, **tags):
    """Attribute records made inside the block (however deep: the
    Executor's entries read this at their first call) to a logical
    owner. `scope` partitions ledger queries per instance."""
    if not enabled():
        yield
        return
    token = _attr_var.set(_Attribution(component, key, scope, tags))
    try:
        yield
    finally:
        _attr_var.reset(token)


def current_attribution():
    return _attr_var.get()


# ---------------------------------------------------------------------------
# the compile ledger
# ---------------------------------------------------------------------------

class CompileRecord:
    """One capture (kind "graph") or first eager run of a signature (kind
    "eager"). `cache` carries the compile cache's outcome: a "hit" record
    is a capture that `warm_start` made from a manifest before traffic
    (excluded from `compile_events()`); "store"/"reject" ride on a
    capture that traffic or warmup met first. `launches` holds the kernel
    launches a captured graph adds on every replay."""

    __slots__ = ("seq", "component", "key", "scope", "site", "kind",
                 "signature", "static_args", "compile_s", "start",
                 "wall_time", "cost", "memory", "recompile_of",
                 "forensics", "tags", "cache", "launches")

    def __init__(self, seq, component, key, scope, site, kind, signature,
                 static_args, compile_s, start, cost, memory, recompile_of,
                 forensics, tags, cache=None, launches=None):
        self.seq = seq
        self.component = component
        self.key = key
        self.scope = scope
        self.site = site
        self.kind = kind
        self.signature = signature
        self.static_args = static_args
        self.compile_s = compile_s
        self.start = start
        self.wall_time = time.time()  # wallclock-ok: a wall stamp
        self.cost = cost
        self.memory = memory
        self.recompile_of = recompile_of
        self.forensics = forensics
        self.tags = tags
        self.cache = cache
        self.launches = launches

    @property
    def flops(self):
        return float(self.cost.get("flops", 0.0)) if self.cost else 0.0

    @property
    def bytes_accessed(self):
        return (float(self.cost.get("bytes accessed") or 0.0)
                if self.cost else 0.0)

    @property
    def cache_hit(self):
        return bool(self.cache) and self.cache.get("event") == "hit"

    def to_dict(self):
        return {
            "seq": self.seq, "component": self.component, "key": self.key,
            "scope": self.scope, "site": self.site, "kind": self.kind,
            "signature": [{"arg": label, "shape": list(shape),
                           "dtype": dtype}
                          for label, shape, dtype in self.signature],
            "static_args": [list(map(str, kv)) for kv in self.static_args],
            "compile_s": self.compile_s, "wall_time": self.wall_time,
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "memory": dict(self.memory) if self.memory else None,
            "recompile_of": self.recompile_of, "forensics": self.forensics,
            "tags": dict(self.tags),
            "cache": dict(self.cache) if self.cache else None,
            "launches": dict(self.launches) if self.launches else None,
        }


class CompileLedger:
    """Process-wide, thread-safe record of every capture and first eager
    run. Counters such as an engine's `compile_count()` and
    pt_generation_compiles_total are views over it."""

    def __init__(self, registry=None):
        self._mu = make_lock("profile.ledger")
        self._entries = []
        self._last_at_site = {}      # site -> (seq, signature)
        self._hooks = []
        self._seq = 0
        self._registry = registry

    def on_record(self, hook):
        """Register a hook called (outside the lock) with each record."""
        with self._mu:
            self._hooks.append(hook)
        return hook

    def record(self, component=None, key=None, kind="graph", signature=(),
               static_args=(), compile_s=0.0, site=None, scope=None,
               tags=None, start=None, cache=None, cost=None, memory=None,
               launches=None):
        """Append one record. Attribution-context values fill any of
        component/key/scope left None. A second record at the same `site`
        carries forensics: the diff against the site's previous
        signature."""
        attr = current_attribution()
        if attr is not None:
            component = component or attr.component
            key = key if key is not None else attr.key
            scope = scope if scope is not None else attr.scope
            merged = dict(attr.tags)
            merged.update(tags or {})
            tags = merged
        component = component or "executor"
        key = key or kind
        tags = dict(tags or {})
        cost = cost or {}
        is_hit = bool(cache) and cache.get("event") == "hit"
        signature = tuple(signature)
        with self._mu:
            self._seq += 1
            recompile_of, forensics = None, None
            if site is not None:
                prev = self._last_at_site.get(site)
                if prev is not None:
                    recompile_of = prev[0]
                    forensics = diff_signatures(prev[1], signature)
                self._last_at_site[site] = (self._seq, signature)
            rec = CompileRecord(
                self._seq, component, key, scope, site, kind, signature,
                tuple(static_args), float(compile_s),
                (_clock() - float(compile_s)) if start is None else start,
                cost, memory, recompile_of, forensics, tags,
                cache=dict(cache) if cache else None,
                launches=dict(launches) if launches else None)
            self._entries.append(rec)
            hooks = list(self._hooks)
        if not is_hit:
            from paddle_tpu_torch.observability import metrics
            events, seconds = metrics.compile_series(
                component, self._registry)
            events.inc()
            seconds.inc(float(compile_s))
        from paddle_tpu_torch.observability import recorder
        recorder.flight_recorder().record(
            "compile", component=component, key=key, compile_kind=kind,
            compile_s=float(compile_s), recompile_of=recompile_of,
            cache=None if not cache else cache.get("event"),
            forensics=None if forensics is None else forensics["text"])
        for hook in hooks:
            hook(rec)
        return rec

    def entries(self, component=None, scope=None, kind=None, key=None,
                tag=None):
        """Filtered ledger entries (tag = (name, value))."""
        with self._mu:
            out = list(self._entries)
        if component is not None:
            out = [e for e in out if e.component == component]
        if scope is not None:
            out = [e for e in out if e.scope == scope]
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        if key is not None:
            out = [e for e in out if e.key == key]
        if tag is not None:
            name, value = tag
            out = [e for e in out if e.tags.get(name) == value]
        return out

    def count(self, **filters):
        return len(self.entries(**filters))

    def recompiles(self, **filters):
        """Entries that re-compiled an already-seen site."""
        return [e for e in self.entries(**filters)
                if e.recompile_of is not None]

    def compile_events(self, **filters):
        """Entries that paid a capture (or a first eager run) on their own
        path: warm-start hits excluded."""
        return [e for e in self.entries(**filters) if not e.cache_hit]

    def cache_entries(self, event=None, **filters):
        out = [e for e in self.entries(**filters) if e.cache]
        if event is not None:
            out = [e for e in out if e.cache.get("event") == event]
        return out

    def total_compile_s(self, **filters):
        return sum(e.compile_s for e in self.entries(**filters))

    def snapshot(self, limit=None):
        entries = self.entries()
        by_component = {}
        cache = {"hit": 0, "store": 0, "reject": 0}
        for e in entries:
            agg = by_component.setdefault(
                e.component, {"events": 0, "compile_s": 0.0,
                              "recompiles": 0})
            agg["events"] += 1
            agg["compile_s"] += e.compile_s
            agg["recompiles"] += e.recompile_of is not None
            if e.cache:
                ev = e.cache.get("event")
                cache[ev] = cache.get(ev, 0) + 1
        consulted = cache["hit"] + cache["store"] + cache["reject"]
        shown = (entries[-limit:] if limit is not None
                 and len(entries) > limit else entries)
        return {
            "events": len(entries),
            "compiles_paid": len(self.compile_events()),
            "recompiles": len(self.recompiles()),
            "compile_s_total": self.total_compile_s(),
            "by_component": by_component,
            "cache": dict(cache, hit_rate=(cache["hit"] / consulted
                                           if consulted else None)),
            "entries": [e.to_dict() for e in shown],
        }

    def reset(self):
        with self._mu:
            self._entries.clear()
            self._last_at_site.clear()
            self._seq = 0


_ledger = CompileLedger()


def compile_ledger():
    """The process-wide ledger every capture site records into."""
    return _ledger


# ---------------------------------------------------------------------------
# runtime attribution (executable stats + run ring)
# ---------------------------------------------------------------------------

class _ExecStats:
    __slots__ = ("calls", "total_s", "min_s", "max_s", "last_s", "counter",
                 "hist")

    def __init__(self, component, key):
        from paddle_tpu_torch.observability import metrics
        self.calls = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0
        self.last_s = 0.0
        # registry children resolved once per executable
        self.counter, self.hist = metrics.run_series(component, key)


_run_mu = make_lock("profile.run")
_run_stats = {}                       # (component, key) -> _ExecStats
_run_ring = collections.deque(maxlen=4096)   # (component, key, start, dur)
_observe_tick = [0]


def observe_run(component, key, seconds, start=None):
    """Record one executable run: wall seconds into the per-executable
    accumulator, the registry series, the bounded run ring, and every
    PT_FLAGS_profile_memory_sample_every runs a memory-ledger sample.
    A replay's wall time is the host's: the graph's launch, not its run
    on the device."""
    if not enabled():
        return
    seconds = float(seconds)
    with _run_mu:
        st = _run_stats.get((component, key))
        if st is None:
            st = _run_stats[(component, key)] = _ExecStats(component, key)
        st.calls += 1
        st.total_s += seconds
        st.last_s = seconds
        st.min_s = min(st.min_s, seconds)
        st.max_s = max(st.max_s, seconds)
        _observe_tick[0] += 1
        tick = _observe_tick[0]
    _run_ring.append((component, key,
                      _clock() - seconds if start is None else start,
                      seconds))
    st.counter.inc()
    st.hist.record(seconds)
    every = _flags.get_flag("profile_memory_sample_every")
    if every and every > 0 and tick % every == 0:
        memory_ledger().sample(tag=component)


#: dense peak FLOP/s of a card by name prefix (NVIDIA data sheets, SXM
#: parts, no sparsity): bf16 on the tensor cores and f32 on the CUDA
#: cores
GPU_PEAK_FLOPS = (
    ("NVIDIA H100", {"bfloat16": 989e12, "float32": 67e12}),
    ("NVIDIA H200", {"bfloat16": 989e12, "float32": 67e12}),
    ("NVIDIA A100", {"bfloat16": 312e12, "float32": 19.5e12}),
)

_peak_cache = {}
_peak_mu = make_lock("profile.peak")


def peak_flops(dtype="bfloat16"):
    """Roofline peak FLOP/s for the MFU derivation:
    PT_FLAGS_profile_peak_flops > the card's entry in GPU_PEAK_FLOPS
    (`dtype` "bfloat16" or "float32") > a one-time float32 matmul
    calibration on the CPU. Cached per process."""
    override = _flags.get_flag("profile_peak_flops")
    if override and override > 0:
        return float(override)
    with _peak_mu:
        if dtype not in _peak_cache:
            _peak_cache[dtype] = _resolve_peak_flops(dtype)
        return _peak_cache[dtype]


def _resolve_peak_flops(dtype):
    import torch
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        for prefix, peaks in GPU_PEAK_FLOPS:
            if name.startswith(prefix):
                return peaks[dtype]
    # the CPU (or an unknown card): the achieved rate of a dense f32 GEMM
    n = 384
    a = torch.ones((n, n), dtype=torch.float32)
    a @ a
    best = math.inf
    for _ in range(3):
        t0 = _clock()
        a @ a
        best = min(best, _clock() - t0)
    return (2.0 * n ** 3) / max(best, 1e-9)


def executable_stats():
    """Measured runtime joined with the ledger's static costs: per
    (component/key) executable the calls, mean wall, achieved FLOP/s and
    bytes/s, and MFU against `peak_flops()`. An executable without a cost
    entry reports None utilization."""
    with _run_mu:
        stats = {k: (s.calls, s.total_s, s.min_s, s.max_s, s.last_s)
                 for k, s in _run_stats.items()}
    costs = {}
    for e in compile_ledger().entries():
        if e.cost or e.memory:
            costs[(e.component, e.key)] = e
    peak = peak_flops() if stats else None
    out = {}
    for (component, key), (calls, total_s, mn, mx, last) in \
            sorted(stats.items()):
        mean_s = total_s / calls if calls else 0.0
        entry = costs.get((component, key))
        flops = entry.flops if entry is not None else 0.0
        nbytes = entry.bytes_accessed if entry is not None else 0.0
        achieved = flops / mean_s if (flops and mean_s > 0) else None
        out[f"{component}/{key}"] = {
            "component": component, "key": key, "calls": calls,
            "total_s": total_s, "mean_s": mean_s,
            "min_s": None if mn is math.inf else mn,
            "max_s": mx, "last_s": last,
            "flops": flops or None, "bytes_accessed": nbytes or None,
            "achieved_flops_per_s": achieved,
            "achieved_bytes_per_s":
                nbytes / mean_s if (nbytes and mean_s > 0) else None,
            "mfu": (achieved / peak
                    if (achieved is not None and peak) else None),
            "compile_s": entry.compile_s if entry is not None else None,
            "peak_memory_bytes": (entry.memory or {}).get("peak_bytes")
            if entry is not None else None,
        }
    return out


# ---------------------------------------------------------------------------
# what the kernel wrappers report: launches and flops
# ---------------------------------------------------------------------------

_launch_registries = []


def register_launch_counts(counts):
    """A kernel module's `launch_counts` dict, which captures snapshot and
    replays add to."""
    if not any(c is counts for c in _launch_registries):
        _launch_registries.append(counts)
    return counts


def _launch_snapshot():
    return [dict(c) for c in _launch_registries]


def _launch_delta(before, after):
    """[(counts dict, {name: launches})] between two snapshots (a
    registry added in between counts from zero)."""
    out = []
    for i, counts in enumerate(_launch_registries):
        prev = before[i] if i < len(before) else {}
        d = {k: v - prev.get(k, 0) for k, v in after[i].items()
             if v != prev.get(k, 0)}
        if d:
            out.append((counts, d))
    return out


def _add_launches(delta, sign=1):
    for counts, d in delta:
        for k, v in d.items():
            counts[k] += sign * v


_cost_mu = make_lock("profile.cost")
_cost_scopes = []


def note_kernel_flops(flops):
    """Called by a hand-written kernel's wrapper at each launch: its
    operation count, which FlopCounterMode cannot see. Adds to every open
    cost scope (a warm-up run being measured); free otherwise."""
    if _cost_scopes:
        with _cost_mu:
            for scope in _cost_scopes:
                scope.kernel_flops += float(flops)


class _CostScope:
    """FlopCounterMode over a run plus the kernels' own reports."""

    def __init__(self):
        self.kernel_flops = 0.0
        self._fc = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._fc = FlopCounterMode(display=False)
        self._fc.__enter__()
        with _cost_mu:
            _cost_scopes.append(self)
        return self

    def __exit__(self, *exc):
        with _cost_mu:
            _cost_scopes.remove(self)
        self._fc.__exit__(*exc)
        return False

    def cost(self):
        return {"flops": float(self._fc.get_total_flops())
                + self.kernel_flops, "bytes accessed": None}


# ---------------------------------------------------------------------------
# the capture wrapper
# ---------------------------------------------------------------------------

class CaptureError(RuntimeError):
    """A capture failed. The message names the rung; the call never runs
    eagerly in its place."""


_eager_mu = make_lock("profile.eager")
_eager_depth = [0]


@contextlib.contextmanager
def disable_capture():
    """Run every profiled_graph eagerly while the block is open, on any
    thread (the counterpart of `jax.disable_jit()`): the one way to run a
    rung eagerly on the card. First sights are recorded with kind
    "eager"."""
    with _eager_mu:
        _eager_depth[0] += 1
    try:
        yield
    finally:
        with _eager_mu:
            _eager_depth[0] -= 1


def capture_disabled():
    return _eager_depth[0] > 0


def _captures_on(device):
    """Whether a wrapper on `device` captures: on CUDA, outside
    disable_capture()."""
    return device.type == "cuda" and not capture_disabled()


_capture_streams = {}


def _capture_stream(device):
    """The side stream every wrapper warms up and captures on, one per
    device: the kernels' per-stream workspaces are sized by the warm-up
    before the capture that bakes them in."""
    import torch
    s = _capture_streams.get(device)
    if s is None:
        s = _capture_streams[device] = torch.cuda.Stream(device)
    return s


def _record_stream(tree, stream):
    """Mark the CUDA tensors of `tree`, made on the capture stream, as used
    on `stream` (the caller's), for the caching allocator."""
    for leaf in _leaves(tree):
        if getattr(leaf, "is_cuda", False):
            leaf.record_stream(stream)


def _cache_for(token):
    if token is None:
        return None
    from paddle_tpu_torch.core import compile_cache as cc
    return cc.compile_cache()


class CaptureGate:
    """Reader-writer gate between captures and every other use of the
    card by the process's threads (see the module docstring). `shared()`
    nests on a thread; `exclusive()` inside a shared hold of the same
    thread gives that hold up until the capture ends (two threads
    capturing from shared holds take turns). A waiting capture stops new
    shared holders (a re-entrant one passes). `stats()`: captures, the
    seconds they held the gate (total and longest) and waited for it,
    and the waits of shared holders (count, total and longest)."""

    def __init__(self):
        self._cond = make_condition("profile.capture_gate",
                                    make_lock("profile.capture_gate"))
        self._readers = 0
        self._writer = None
        self._writers_waiting = 0
        self._tls = threading.local()
        self._stats = {"captures": 0, "held_s": 0.0, "max_held_s": 0.0,
                       "capture_wait_s": 0.0, "shared_waits": 0,
                       "shared_wait_s": 0.0, "max_shared_wait_s": 0.0}

    @contextlib.contextmanager
    def shared(self):
        tl = self._tls
        depth = getattr(tl, "depth", 0)
        count = depth == 0 and self._writer != threading.get_ident()
        if count:
            with self._cond:
                if self._writer is not None or self._writers_waiting:
                    t0 = _clock()
                    while self._writer is not None or self._writers_waiting:
                        self._cond.wait()
                    waited = _clock() - t0
                    st = self._stats
                    st["shared_waits"] += 1
                    st["shared_wait_s"] += waited
                    st["max_shared_wait_s"] = max(st["max_shared_wait_s"],
                                                  waited)
                self._readers += 1
            tl.counted = True
        tl.depth = depth + 1
        try:
            yield
        finally:
            tl.depth = depth
            if count:
                with self._cond:
                    self._readers -= 1
                    tl.counted = False
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        if self._writer == me:
            yield
            return
        tl = self._tls
        had = getattr(tl, "counted", False)
        t0 = _clock()
        with self._cond:
            if had:
                self._readers -= 1
                tl.counted = False
                self._cond.notify_all()
            self._writers_waiting += 1
            while self._writer is not None or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = me
        t1 = _clock()
        try:
            yield
        finally:
            held = _clock() - t1
            with self._cond:
                self._writer = None
                if had:
                    self._readers += 1
                    tl.counted = True
                st = self._stats
                st["captures"] += 1
                st["held_s"] += held
                st["max_held_s"] = max(st["max_held_s"], held)
                st["capture_wait_s"] += t1 - t0
                self._cond.notify_all()

    def stats(self):
        with self._cond:
            return dict(self._stats)

    def reset_stats(self):
        with self._cond:
            for k in self._stats:
                self._stats[k] = 0 if k in ("captures", "shared_waits") \
                    else 0.0


_gate = CaptureGate()


def capture_gate():
    """The process's capture gate (see CaptureGate)."""
    return _gate


#: the cache outcome a warm-start capture records (see warm_capture)
_warm_var = contextvars.ContextVar("pt_profile_warm", default=None)


@contextlib.contextmanager
def warm_capture(cache):
    """Executor entries captured inside the block record `cache` (a
    warm-start "hit") as their compile-cache outcome instead of a miss
    and a store: how a server restores its bucket ladder from a
    manifest (serving/pool.py)."""
    token = _warm_var.set(dict(cache))
    try:
        yield
    finally:
        _warm_var.reset(token)


#: what `_capture_graph` made
_Capture = collections.namedtuple(
    "_Capture", "out graph outputs launched cost warm_s peak_bytes constants")


def _capture_graph(fn, dev, pool, prepare, failed):
    """Warm up and capture `fn()` on the device's capture stream: run it
    once eagerly (the warm-up: its outputs are the call's result, and it
    sizes the kernels' per-stream workspaces), call `prepare(graph)`
    (which registers the generators the graph draws from), then capture
    a second run into a CUDA graph in memory pool `pool`, holding the
    capture gate exclusively from `prepare` to the capture's end. Host
    values
    the runs copy to the device (registry.constant) are kept in
    `.constants`, which must live as long as the graph. A garbage
    collection is held off during the capture (one could free another
    graph, which a capture does not permit), and the launch counts of
    the captured run, which ran nothing, are taken back. An error of the
    capture raises CaptureError with the message `failed(error)`; an
    error of the warm-up is the call's own and propagates as it is."""
    import torch

    from paddle_tpu_torch.core.registry import constants_kept
    stream = _capture_stream(dev)
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    constants = {}
    with constants_kept(constants):
        t0 = _clock()
        with torch.cuda.stream(stream):
            with _CostScope() as cost:
                out = fn()
        stream.synchronize()
        warm_s = _clock() - t0
        with _gate.exclusive():
            prepare(graph)
            m0 = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            counts = _launch_snapshot()
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    outputs = fn()
            except Exception as e:
                raise CaptureError(f"{failed(e)}: {type(e).__name__}: "
                                   f"{e}") from e
            finally:
                if gc_was_on:
                    gc.enable()
                launched = _launch_delta(counts, _launch_snapshot())
                _add_launches(launched, -1)
            peak = int(torch.cuda.max_memory_allocated(dev) - m0)
    cur.wait_stream(stream)
    _record_stream(out, cur)
    return _Capture(out=out, graph=graph, outputs=outputs,
                    launched=launched, cost=cost.cost(), warm_s=warm_s,
                    peak_bytes=peak, constants=constants)


class _Graph:
    __slots__ = ("graph", "key", "copies", "bound_ptrs", "outputs",
                 "launches", "constants")

    def __init__(self, key, copies, bound_ptrs, cap):
        self.graph = cap.graph
        self.key = key
        self.copies = copies          # [(arg index, static tensor)]
        self.bound_ptrs = bound_ptrs  # [(arg index, (data_ptr, ...))]
        self.outputs = cap.outputs
        self.launches = cap.launched
        self.constants = cap.constants


def _pool_bytes(pool):
    """Bytes the caching allocator holds in a graph memory pool: the
    segments of `torch.cuda.memory_snapshot()` that belong to it (the
    wrapper's graphs share it, so this is the wrapper's total)."""
    import torch
    want = tuple(pool) if pool is not None else None
    return int(sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id") or ()) == want))


#: _capture's answer when another thread captured the signature first
_CAPTURED_ELSEWHERE = object()


def _ptrs(tree):
    return tuple(leaf.data_ptr() for leaf in _leaves(tree))


class ProfiledGraph:
    """One captured CUDA graph per signature (see the module docstring).

    `arg_names` labels the positional arguments; `bound` is a callable
    returning {arg name: current value} of the arguments the graphs hold
    by identity (their values are trees of tensors); a `torch.Generator`
    argument is registered with the graph, so each replay draws fresh
    numbers from it as an eager call would (the counterpart of a JAX key
    passed as an argument), and is held by identity too; every other
    argument is a tensor (or numpy array, or None) copied into a static
    buffer on each call. A Python value passed positionally would be
    baked into a graph, so it raises: pass it as a static kwarg
    (`static_argnames`), which keys the graph and reaches `fn` on every
    capture. `device` is where the graphs run (None: CUDA)."""

    def __init__(self, fn, component, name, static_argnames=(), scope=None,
                 on_compile=None, arg_names=None, cache_token=None,
                 bound=None, device=None):
        from paddle_tpu_torch.core.places import resolve_device
        self._fn = fn
        self.component = component
        self.name = name
        self.static_argnames = tuple(static_argnames)
        self.scope = scope
        self._on_compile = on_compile
        self._arg_names = tuple(arg_names) if arg_names else None
        self._bound = bound
        self.cache_token = cache_token
        self.device = resolve_device(device)
        self._graphs = {}             # (dispatch key, statics) -> _Graph
        self._seen_eager = {}         # (dispatch key, statics) -> key
        self._pool = None
        self._mu = make_lock("profile.graph_cache")

    def _key_for(self, static_kw):
        if not static_kw:
            return self.name
        statics = ",".join(f"{k}={static_kw[k]}" for k in sorted(static_kw))
        return f"{self.name}[{statics}]"

    def _bound_names(self):
        return set(self._bound()) if self._bound is not None else set()

    def _arg_name(self, i):
        return (self._arg_names[i] if self._arg_names is not None
                and i < len(self._arg_names) else f"[{i}]")

    def __call__(self, *args, **static_kw):
        bad = set(static_kw) - set(self.static_argnames)
        if bad:
            raise TypeError(f"{self.component}/{self.name}: unknown static "
                            f"arguments {sorted(bad)}")
        sig_key = (dispatch_key(args), tuple(sorted(static_kw.items())))
        if not _captures_on(self.device):
            return self._eager(sig_key, args, static_kw)
        entry = self._graphs.get(sig_key)
        if entry is None:
            out = self._capture(sig_key, args, static_kw)
            if out is not _CAPTURED_ELSEWHERE:
                return out
            entry = self._graphs[sig_key]
        t0 = _clock()
        for i, ptrs in entry.bound_ptrs:
            if (ptrs is not args[i] if isinstance(ptrs, _Generator)
                    else _ptrs(args[i]) != ptrs):
                raise CaptureError(
                    f"{self.component}/{entry.key}: argument "
                    f"{self._arg_name(i)!r} is not the state this graph "
                    f"was captured on (an engine's rungs are bound to its "
                    f"own pools: use engine.init_state())")
        for i, static in entry.copies:
            static.copy_(_as_tensor(args[i]), non_blocking=True)
        entry.graph.replay()
        _add_launches(entry.launches)
        observe_run(self.component, entry.key, _clock() - t0)
        return entry.outputs

    # -- the eager path (the CPU, or disable_capture() on the card) ------
    def _eager(self, sig_key, args, static_kw):
        dev = self.device
        bound = self._bound_names()
        call = [a if self._arg_name(i) in bound or a is None
                or isinstance(a, _Generator) else _as_tensor(a).to(dev)
                for i, a in enumerate(args)]
        key = self._seen_eager.get(sig_key)
        if key is not None or not enabled():
            t0 = _clock()
            out = self._fn(*call, **static_kw)
            if key is not None:
                observe_run(self.component, key, _clock() - t0)
            return out
        key = self._key_for(static_kw)
        t0 = _clock()
        with _CostScope() as cost:
            out = self._fn(*call, **static_kw)
        run_s = _clock() - t0
        with self._mu:
            self._seen_eager[sig_key] = key
        rec = compile_ledger().record(
            component=self.component, key=key, kind="eager",
            signature=signature_of(args, self._arg_names),
            static_args=sig_key[1], compile_s=0.0,
            site=f"{self.component}/{self.name}", scope=self.scope,
            cost=cost.cost())
        if self._on_compile is not None:
            self._on_compile(rec)
        observe_run(self.component, key, run_s)
        return out

    # -- capture --------------------------------------------------------
    def _capture(self, sig_key, args, static_kw, cache=None):
        """Warm up, capture and record the signature; returns the warm-up
        run's outputs (the call's result). `cache` is the warm-start
        outcome when warm_start() captures from a manifest."""
        import torch
        with self._mu:
            if sig_key in self._graphs:
                return _CAPTURED_ELSEWHERE
            dev = self.device
            key = self._key_for(static_kw)
            statics = sig_key[1]
            sig = signature_of(args, self._arg_names)
            bound = self._bound_names()
            static_in, copies, bound_ptrs = [], [], []
            for i, a in enumerate(args):
                if self._arg_name(i) in bound:
                    static_in.append(a)
                    bound_ptrs.append((i, _ptrs(a)))
                elif isinstance(a, _Generator):
                    static_in.append(a)
                    bound_ptrs.append((i, a))
                elif a is None:
                    static_in.append(None)
                else:
                    t = _as_tensor(a, f"{self.component}/{key}",
                                   self._arg_name(i))
                    buf = torch.empty(t.shape, dtype=t.dtype, device=dev)
                    buf.copy_(t)
                    static_in.append(buf)
                    copies.append((i, buf))
            pcache = _cache_for(self.cache_token) if enabled() else None
            key_hash = None
            if pcache is not None and cache is None:
                key_hash = pcache.key_for(self.cache_token, sig_key[0],
                                          statics)
                pcache.note_event("miss", key_hash, self.component, key,
                                  self.scope, reason="not_warm")
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            gens = [a for _, a in bound_ptrs if isinstance(a, _Generator)]

            def prepare(graph):
                for gen in gens:
                    graph.register_generator_state(gen)

            t0 = _clock()
            cap = _capture_graph(
                lambda: self._fn(*static_in, **static_kw), dev, self._pool,
                prepare, lambda e: (
                    f"capture of {self.component}/{key} (signature "
                    f"{[f'{lb}{tuple(s)}/{d}' for lb, s, d in sig]}) "
                    f"failed"))
            capture_s = _clock() - t0
            memory = {"peak_bytes": cap.peak_bytes,
                      "pool_bytes": _pool_bytes(self._pool),
                      "warmup_s": cap.warm_s}
            launches = {k: v for _, d in cap.launched for k, v in d.items()}
            cache_field = cache
            if key_hash is not None:
                event, reason = pcache.store(
                    key_hash, self.cache_token, sig, statics, len(args),
                    capture_s, component=self.component, key=key,
                    scope=self.scope, cost=cap.cost, memory=memory)
                cache_field = {"event": event, "tier": "signature"}
                if reason:
                    cache_field["reason"] = reason
            rec = None
            if enabled():
                rec = compile_ledger().record(
                    component=self.component, key=key, kind="graph",
                    signature=sig, static_args=statics,
                    compile_s=capture_s,
                    site=f"{self.component}/{self.name}", scope=self.scope,
                    cache=cache_field, cost=cap.cost, memory=memory,
                    launches=launches)
            self._graphs[sig_key] = _Graph(key, copies, bound_ptrs, cap)
        if rec is not None and cache is None and self._on_compile:
            self._on_compile(rec)
        observe_run(self.component, key, cap.warm_s)
        return cap.out

    def warm(self, meta, load_s=0.0):
        """Capture the signature a compile-cache entry describes, before
        traffic (`CompileCache.warm_start`): bound arguments from
        `bound()`, every other tensor zeros of the recorded shape and
        dtype. The warm-up runs the rung once on those inputs, so an
        engine resets its state afterwards. Returns True when it
        captured."""
        import torch
        bound = self._bound() if self._bound is not None else {}
        shapes = {label: (shape, dtype)
                  for label, shape, dtype in meta["signature"]}
        args = []
        for i in range(int(meta["n_args"])):
            name = self._arg_name(i)
            if name in bound:
                args.append(bound[name])
            elif name in shapes:
                shape, dtype = shapes[name]
                args.append(torch.zeros(tuple(shape),
                                        dtype=getattr(torch, dtype)))
            else:
                args.append(None)
        static_kw = dict(meta.get("static_kw") or {})
        sig_key = (dispatch_key(args), tuple(sorted(static_kw.items())))
        if sig_key in self._graphs or not _captures_on(self.device):
            return False
        out = self._capture(sig_key, args, static_kw,
                            cache={"event": "hit", "tier": "signature",
                                   "load_s": load_s})
        return out is not _CAPTURED_ELSEWHERE

    def compile_count(self):
        """Signatures captured (or, eagerly, first seen) by this wrapper."""
        with self._mu:
            return len(self._graphs) + len(self._seen_eager)


def _as_tensor(a, where=None, name=None):
    import torch
    if isinstance(a, torch.Tensor):
        return a
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    raise CaptureError(
        f"{where or 'profiled_graph'}: argument {name!r} is a "
        f"{type(a).__name__}; a graph would bake it in: pass a tensor, or "
        f"a static argument")


def profiled_graph(fn, component, name, **kwargs):
    """One captured CUDA graph per signature + ledger + runtime
    attribution (see ProfiledGraph): the port's `jax.jit`."""
    return ProfiledGraph(fn, component, name, **kwargs)


#: the JAX package's name for the same wrapper
profiled_jit = profiled_graph


#: the Executor's arguments, as the JAX Executor names them
_EXECUTOR_ARGS = ("state", "feed", "rng")


class ExecutorPool:
    """An Executor's graph memory pool, shared by every graph of its
    entries, and the lock that serialises their captures and replays
    (Predictor clones share the Executor, and a graph's buffers must not
    take two calls' inputs at once)."""

    def __init__(self):
        self.mu = make_rlock("profile.executor_pool")
        self._handle = None

    def handle(self):
        import torch
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _storage(t):
    return t.untyped_storage().data_ptr()


def _write_into(out, dests):
    """Write each `out[name]` whose name `dests` lists into that tensor in
    place and return the outputs with those names bound to it. A value
    that shares memory with a destination is cloned first, so no write
    changes another output (a fetch of `assign(w)` keeps the old w)."""
    ptrs = {_storage(d) for d in dests.values()}
    out = {n: (v.clone() if isinstance(v, _Tensor) and _storage(v) in ptrs
               and v is not dests.get(n) else v)
           for n, v in out.items()}
    for n, d in dests.items():
        if n in out and out[n] is not d:
            d.copy_(out[n])
            out[n] = d
    return out


def _failed_op(exc):
    """The OpRunError carrying an op index in an exception's chain."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if getattr(exc, "op_index", None) is not None:
            return exc
        exc = exc.__cause__ or exc.__context__
    return None


class _SegmentGraph:
    __slots__ = ("graph", "copies", "outputs", "launches", "gens",
                 "constants")

    def __init__(self, copies, gens, cap):
        self.graph = cap.graph
        self.copies = copies          # [(name, static input buffer)]
        self.outputs = cap.outputs    # {name: static output}
        self.launches = cap.launched
        self.gens = gens              # [(generator, op index, fixed)]
        self.constants = cap.constants


class _BoundRun:
    """One Executor entry's graphs over one scope: the state tensors they
    hold (`bound`), one graph per (segment, input signature), and what
    the current run captured. The capturing runner core/lowering.py's
    `run_block` calls (`segment`). It holds no reference back to its
    entry or its scope, so a dropped Executor or scope frees its graphs
    at once, never in a garbage collection that could fall inside
    another capture."""

    def __init__(self, site, device, pool, rngs):
        self.site = site
        self.device = device
        self.pool = pool
        self.rngs = rngs
        self.bound = {}
        self.graphs = {}
        self._owned = set()
        self.reset_run()

    def reset_run(self):
        self.new_graphs = []
        self.flops = 0.0
        self.peak_bytes = 0

    def own(self, tree):
        for leaf in _leaves(tree):
            if isinstance(leaf, _Tensor):
                self._owned.add(_storage(leaf))

    def fresh(self, v):
        """`v`, or a copy of it where it lies in memory the graphs keep
        (bound state, static buffers and outputs)."""
        if isinstance(v, _Tensor) and _storage(v) in self._owned:
            return v.clone()
        return v

    def segment(self, key, fn, vals, seed, carry=(), write_back=False):
        """Run one graph segment: `fn(vals) -> {name: value}` is its ops
        run eagerly. A known signature replays its graph; a new one runs
        `fn` once eagerly (the call's result) and captures it."""
        from paddle_tpu_torch.core.registry import RunGenerators
        bound = self.bound
        sig = []
        for n, v in vals.items():
            if not isinstance(v, _Tensor):
                raise CaptureError(
                    f"capture of {self.site}: {n!r} is a "
                    f"{type(v).__name__}, not a tensor")
            sig.append((n, v.shape, v.dtype, v is bound.get(n)))
        gkey = (key, tuple(sig))
        g = self.graphs.get(gkey)
        if g is None:
            return self._capture(gkey, fn, vals, seed, carry, write_back)
        for n, buf in g.copies:
            v = vals[n]
            if v is not buf:
                buf.copy_(v)
        RunGenerators.reseed(g.gens, seed)
        g.graph.replay()
        _add_launches(g.launches)
        return g.outputs

    def _capture(self, gkey, fn, vals, seed, carry, write_back):
        import torch

        from paddle_tpu_torch.core.registry import RunGenerators
        dev = self.device
        statics, copies = {}, []
        for n, v in vals.items():
            if v is self.bound.get(n):
                statics[n] = v
            else:
                buf = torch.empty(v.shape, dtype=v.dtype, device=dev)
                buf.copy_(v)
                statics[n] = buf
                copies.append((n, buf))
        self.own([b for _, b in copies])
        carried = {n: statics[n] for n, _ in copies if n in carry}

        def body():
            out = fn(statics)
            dests = dict((n, b) for n, b in carried.items() if n in out)
            if write_back:
                dests.update((n, self.bound[n]) for n in out
                             if n in self.bound)
            return _write_into(out, dests)

        rngs = self.rngs
        used = rngs.begin()

        def prepare(graph):
            # the warm-up's draws name the generators the graph draws from
            for gen, _, _ in used:
                graph.register_generator_state(gen)
            RunGenerators.reseed(used, seed)
            rngs.begin()
            rngs.capturing = True

        def failed(e):
            op = _failed_op(e)
            where = (f"block {op.block_idx}, op {op.op_index} "
                     f"({op.op_type!r})" if op is not None else
                     f"block {gkey[0][0]}, the segment from op {gkey[0][1]}")
            return f"capture of {self.site} failed in {where}"

        try:
            cap = _capture_graph(body, dev, self.pool.handle(), prepare,
                                 failed)
        finally:
            rngs.capturing = False
        self.flops += cap.cost["flops"]
        self.peak_bytes = max(self.peak_bytes, cap.peak_bytes)
        self.own(cap.outputs)
        g = _SegmentGraph(copies, list(used), cap)
        self.graphs[gkey] = g
        self.new_graphs.append(g)
        return cap.out


class LedgerJit:
    """One Executor entry: a program's step function (core.lowering's
    StepFn) for one (program version, feed signature, fetches, state
    names, mode), under the JAX Executor's site name
    `executor/{id:x}v{version}/{fetches}/{train|infer}` (`LedgerJit`
    :858 there).

    On the card each graph segment of the step's capture plan is captured
    into a CUDA graph on first use (per scope and input signature) and
    replayed after; host ops run eagerly, and a `while` body or a taken
    branch is a graph of its own. The first run is the eager warm-up and
    is the call, as for `ProfiledGraph`. The graphs hold the scope's state
    tensors (`Scope.bind`): a training run writes the new state into them
    in place (the JAX Executor's donation), an inference run writes none;
    a value set in the scope between runs is copied in first
    (`Scope.refresh`), and a changed shape or dtype is a new signature.
    Draws come from persistent generators re-seeded before each replay
    (registry.RunGenerators). Fetches, and state the program creates,
    are copied out of the graphs' memory before `__call__` returns. A run
    that captured records one CompileRecord of kind "graph": its wall
    time, graphs, flops (the warm-ups', kernels' reports included), peak
    and pool bytes and the launches its replays add. A capture that fails
    raises CaptureError naming the block, op index and type; only
    `disable_capture()` runs eagerly on the card.

    On the CPU the step runs eagerly and its first call is recorded with
    kind "eager". `pool` is the Executor's ExecutorPool: its lock is held
    from the feeds' copy into a graph's static buffers until the fetches
    are copied out of its outputs, so Predictor clones on several
    threads never mix their rows, and inside it the capture gate is held
    shared. A capture made inside `warm_capture` records its cache
    outcome; otherwise, with the compile cache armed, a capture is a
    miss and a store under the attribution's scope."""

    def __init__(self, step, site, cache_token=None, device=None, pool=None):
        from paddle_tpu_torch.core.places import resolve_device
        from paddle_tpu_torch.core.registry import RunGenerators
        self._step = step
        self.site = site
        self.cache_token = cache_token
        self.device = resolve_device(device)
        self.pool = pool or ExecutorPool()
        self.rngs = RunGenerators(self.device)
        self._mu = make_rlock("profile.ledger_jit")
        self._seen = False
        self._runs = weakref.WeakKeyDictionary()    # scope -> _BoundRun

    def __call__(self, scope, state_names, feed, seed):
        """Run the step over `scope`'s state: returns the fetches and
        updates the scope."""
        if not _captures_on(self.device):
            with self._mu, _gate.shared():
                self.rngs.begin()
                return self._eager(scope, state_names, feed, seed)
        with self.pool.mu, _gate.shared():
            self.rngs.begin()
            return self._captured(scope, state_names, feed, seed)

    def _eager(self, scope, state_names, feed, seed):
        import torch
        state = {n: scope.tensor_on(n, self.device) for n in state_names}
        first = not self._seen
        self._seen = True
        t0 = _clock()
        with torch.no_grad():     # the autodiff segment turns grad on
            fetches, new_state = self._step(state, feed, seed,
                                            rngs=self.rngs)
        for n, v in new_state.items():
            scope.set(n, v)
        if first and enabled():
            compile_ledger().record(
                kind="eager",
                signature=signature_of((state, feed, seed), _EXECUTOR_ARGS),
                compile_s=0.0, site=self.site, start=t0,
                tags={"segments": len(self._step.plan)})
        return fetches

    def _bind(self, scope, state_names):
        """This scope's _BoundRun with every state name bound and
        refreshed."""
        run = self._runs.get(scope)
        if run is None:
            run = self._runs[scope] = _BoundRun(
                self.site, self.device, self.pool, self.rngs)
        for n in state_names:
            b = run.bound.get(n)
            if b is None:
                run.bound[n] = b = scope.bind(n, self.device)
                run.own(b)
                continue
            v = scope.get(n)
            if v is b:
                continue
            if (tuple(v.shape) != tuple(b.shape)
                    or _dtype_name(v.dtype) != _dtype_name(b.dtype)):
                # a new state signature: bind and capture anew
                del self._runs[scope]
                return self._bind(scope, state_names)
            scope.refresh(n, b)
        return run

    def _captured(self, scope, state_names, feed, seed):
        import torch
        run = self._bind(scope, state_names)
        state = {n: run.bound[n] for n in state_names}
        run.reset_run()
        t0 = _clock()
        with torch.no_grad():
            fetches, new_state = self._step(state, feed, seed,
                                             rngs=self.rngs, session=run)
        training = self._step.training
        for n, v in new_state.items():
            b = run.bound.get(n)
            if v is b:
                continue
            if b is not None and training and v.shape == b.shape \
                    and v.dtype == b.dtype:
                b.copy_(v)        # written by a host segment
            else:
                scope.set(n, run.fresh(v))
        fetches = [run.fresh(v) for v in fetches]
        if run.new_graphs:
            self._record(run, state, feed, seed, _clock() - t0)
        return fetches

    def _record(self, run, state, feed, seed, seconds):
        sig = signature_of((state, feed, seed), _EXECUTOR_ARGS)
        launches = {}
        for g in run.new_graphs:
            for _, d in g.launches:
                for k, v in d.items():
                    launches[k] = launches.get(k, 0) + v
        memory = {"peak_bytes": run.peak_bytes,
                  "pool_bytes": _pool_bytes(self.pool.handle()),
                  "graphs": len(run.graphs)}
        cost = {"flops": run.flops, "bytes accessed": None}
        cache = _warm_var.get()
        pcache = _cache_for(self.cache_token) if enabled() else None
        if pcache is not None and cache is None:
            attr = current_attribution()
            scope = None if attr is None else attr.scope
            key_hash = pcache.key_for(self.cache_token,
                                      dispatch_key((state, feed)))
            pcache.note_event("miss", key_hash, "executor", self.site,
                              scope=scope, reason="not_warm")
            event, reason = pcache.store(
                key_hash, self.cache_token, sig, (), len(sig), seconds,
                component="executor", key=self.site, scope=scope,
                cost=cost, memory=memory)
            cache = {"event": event, "tier": "signature"}
            if reason:
                cache["reason"] = reason
        if enabled():
            plan = self._step.plan
            compile_ledger().record(
                kind="graph", signature=sig, compile_s=seconds,
                site=self.site, cost=cost, memory=memory,
                launches=launches, cache=cache,
                tags={"segments": len(plan),
                      "captured": len(run.new_graphs),
                      "host_ops": [f"op {s.start}: {s.reason}"
                                   for s in plan if s.kind != "graph"]})


def ledger_jit(fn, site, arg_names=None, device=None):
    """The JAX package's public name for wrapping a one-signature callable
    for the ledger, kept for API parity: `profiled_graph(fn, "executor",
    site)` (identity when the ledger is off). The Executor's entries are
    LedgerJit objects."""
    if not enabled():
        return fn
    return profiled_graph(fn, "executor", site, arg_names=arg_names,
                          device=device)


# ---------------------------------------------------------------------------
# memory ledger
# ---------------------------------------------------------------------------

def _read_live_default():
    """The caching allocator's census of device 0: live allocations and
    their bytes, bytes reserved and the peak (zeros without a card)."""
    import torch
    if not torch.cuda.is_available():
        return {"buffers": 0, "bytes": 0}
    st = torch.cuda.memory_stats()
    return {"buffers": int(st.get("active.all.current", 0)),
            "bytes": int(st.get("allocated_bytes.all.current", 0)),
            "device_bytes_in_use": int(st.get("reserved_bytes.all.current",
                                              0)),
            "device_peak_bytes": int(st.get("allocated_bytes.all.peak", 0))}


class MemoryLedger:
    """Bounded history of allocator samples with a peak watermark,
    per-tag deltas and a monotonic-growth leak detector. `read_live` is
    injectable so the detector is tested without a card."""

    def __init__(self, capacity=1024, read_live=None, clock=_clock):
        self.capacity = int(capacity)
        self._read_live = read_live or _read_live_default
        self._clock = clock
        self._mu = make_lock("profile.memory")
        self._samples = collections.deque(maxlen=self.capacity)
        self._peak_bytes = 0
        self._peak_buffers = 0
        self._last_by_tag = {}

    def sample(self, tag=None):
        """Take one sample: {"t", "tag", "buffers", "bytes",
        "delta_bytes" (against the previous sample of the tag), ...}."""
        live = dict(self._read_live())
        sample = {"t": self._clock(), "tag": tag}
        sample.update(live)
        with self._mu:
            prev = self._last_by_tag.get(tag)
            sample["delta_bytes"] = (None if prev is None
                                     else sample["bytes"] - prev["bytes"])
            self._last_by_tag[tag] = sample
            self._samples.append(sample)
            self._peak_bytes = max(self._peak_bytes, sample["bytes"])
            self._peak_buffers = max(self._peak_buffers, sample["buffers"])
        from paddle_tpu_torch.observability import metrics
        reg = metrics.registry()
        reg.gauge("pt_memory_live_buffers",
                  "live device buffers at last sample").set(
            sample["buffers"])
        reg.gauge("pt_memory_live_bytes",
                  "live device bytes at last sample").set(sample["bytes"])
        reg.gauge("pt_memory_peak_bytes",
                  "peak live device bytes observed").set(self._peak_bytes)
        return sample

    def samples(self, tag=None, limit=None):
        with self._mu:
            out = list(self._samples)
        if tag is not None:
            out = [s for s in out if s["tag"] == tag]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def watermark(self):
        with self._mu:
            return {"peak_bytes": self._peak_bytes,
                    "peak_buffers": self._peak_buffers,
                    "samples": len(self._samples)}

    def leak_report(self, tag=None, window=8, tolerance_bytes=0):
        """suspected=True when the last `window` samples never shrink, at
        least one grows, and the growth exceeds `tolerance_bytes`."""
        hist = self.samples(tag=tag)
        if len(hist) < max(int(window), 2):
            return {"suspected": False, "reason": "insufficient samples",
                    "samples": len(hist)}
        hist = hist[-int(window):]
        sizes = [s["bytes"] for s in hist]
        monotonic = all(b >= a for a, b in zip(sizes, sizes[1:]))
        growth = sizes[-1] - sizes[0]
        return {"suspected": bool(monotonic and growth > tolerance_bytes),
                "monotonic": monotonic, "growth_bytes": int(growth),
                "window": len(hist), "first_bytes": int(sizes[0]),
                "last_bytes": int(sizes[-1])}

    def snapshot(self):
        last = self.samples(limit=1)
        return {"watermark": self.watermark(),
                "last_sample": last[0] if last else None,
                "leak": self.leak_report()}

    def reset(self):
        with self._mu:
            self._samples.clear()
            self._last_by_tag.clear()
            self._peak_bytes = 0
            self._peak_buffers = 0


_memory = MemoryLedger()


def memory_ledger():
    return _memory


# ---------------------------------------------------------------------------
# exposition + merged timeline
# ---------------------------------------------------------------------------

def profile_snapshot(ledger_limit=256):
    """Ledger (cache trail included), per-executable utilization, memory
    watermarks, compile-cache state, the planner's cross-check and the
    lock checker's section, as plain JSON types."""
    from paddle_tpu_torch.analysis import concurrency as _conc
    from paddle_tpu_torch.core import compile_cache as cc
    pcache = cc.compile_cache()
    return {
        "ledger": compile_ledger().snapshot(limit=ledger_limit),
        "executables": executable_stats(),
        "memory": memory_ledger().snapshot(),
        "compile_cache": None if pcache is None else pcache.stats(),
        "peak_flops": (_peak_cache.get("bfloat16")
                       or _flags.get_flag("profile_peak_flops") or None),
        "capture_gate": _gate.stats(),
        # the planner's estimates against the captures' peaks; None until
        # a server registers estimates (analysis/planner.py)
        "plan_check": _planner_section(),
        # None unless PT_FLAGS_concurrency_check armed the tracked locks
        "concurrency": _conc.profile_section(),
    }


def _planner_section():
    from paddle_tpu_torch.analysis import planner
    return planner.cross_check_section()


def chrome_events():
    """Ledger records and recent executable runs as Chrome trace events
    on the tracer's perf_counter timebase (`extra_events` of
    trace.export_chrome_trace)."""
    pid = os.getpid()
    events = []
    for e in compile_ledger().entries():
        args = {"component": e.component, "key": e.key, "kind": e.kind,
                "seq": e.seq}
        if e.flops:
            args["flops"] = e.flops
        if e.recompile_of is not None:
            args["recompile_of"] = e.recompile_of
        if e.forensics is not None:
            args["forensics"] = e.forensics["text"]
        events.append({"name": f"compile {e.component}/{e.key}", "ph": "X",
                       "pid": pid, "tid": 9000, "ts": e.start * 1e6,
                       "dur": max(e.compile_s, 0.0) * 1e6,
                       "cat": "compile", "args": args})
    for component, key, start, dur in list(_run_ring):
        events.append({"name": f"run {component}/{key}", "ph": "X",
                       "pid": pid, "tid": 9001, "ts": start * 1e6,
                       "dur": max(dur, 0.0) * 1e6, "cat": "executable",
                       "args": {"component": component, "key": key}})
    return events


def reset_profile():
    """Tests: drop ledger entries, runtime stats, the run ring and memory
    samples (on_record hooks survive)."""
    compile_ledger().reset()
    memory_ledger().reset()
    with _run_mu:
        _run_stats.clear()
    _run_ring.clear()
