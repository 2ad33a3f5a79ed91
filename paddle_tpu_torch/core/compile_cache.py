"""Persistent signature cache: a warm start for the port's captured
graphs.

Counterpart of paddle_tpu/core/compile_cache.py (`CompileCache` :239),
redesigned around what torch can keep. The JAX package serializes the
compiled XLA executable itself; a CUDA graph cannot be serialized, and
its capture needs live buffers. So an entry here records a signature,
not an executable: the wrapper's cache token, the argument signature,
the static arguments, the capture time and the static cost. What a warm
process gains is that the whole rung ladder is captured before traffic
arrives, from the manifest an earlier process wrote.

Layout (one directory, shared by every process on the host)::

    <PT_FLAGS_compile_cache_dir>/
      entries/<key_hash>.json   header line {"format", "size", "crc32"},
                                then the entry's JSON (size bytes)
      manifests/<name>.json     warm-start signature ladders
      PATHOLOGY.json            flagged slow captures

Entries are written to `<path>.tmp-<pid>` and published with one
`os.replace`. **Cache key** = SHA-256 over (the wrapper's token, the
dispatch key, the static arguments, the device stamp). The **device
stamp** is the GPU's name and compute capability, the driver, torch and
CUDA versions, and the hash of the kernel library `ops/kernels/_build.py`
builds; an entry made under another stamp is a clean miss.

**Events** (`pt_compile_cache_total{event,reason}` and the in-memory
rows manifests are collected from): `warm_start(name, wrappers)` captures
every signature its manifest lists, before traffic: each is a "hit" (its
ledger record carries cache event "hit" and is not counted by
`compile_events()`). A signature met first by traffic or warmup is a
"miss" (reason "not_warm"), then a "store" (or a "reject" with its
reason). A truncated entry, a bad CRC, another format or another stamp
is a miss with the reason named, never an exception. Kept from the JAX
module: the pathology ledger for slow captures
(PT_FLAGS_compile_cache_slow_compile_s), keep-last-N `gc`
(PT_FLAGS_compile_cache_keep), `stats()` and `program_cache_token`,
the content identity of an Executor entry's program. Not kept:
`LoadedArtifact` and `preload_component` (no executable to load), and
the jax compilation-cache plumbing (no compiler cache beneath a graph).
A graph is captured in every process, an Executor entry's too: the
cache records its signature (hit, miss and store events), never the
graph.
"""
import hashlib
import json
import logging
import os
import time
import zlib

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.reliability.faults import FaultError, inject_point

logger = logging.getLogger("paddle_tpu_torch.compile_cache")

__all__ = ["CompileCache", "compile_cache", "device_stamp",
           "program_cache_token", "reset_compile_cache"]

ENTRY_FORMAT = 1
_STAMP_FIELDS = ("platform", "device_kind", "capability", "driver")
_VERSION_FIELDS = ("torch", "cuda", "kernels")


def _driver_version():
    """The CUDA driver's version (cuDriverGetVersion), or "unknown"."""
    import ctypes
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return str(v.value)
    except OSError:
        pass
    return "unknown"


def device_stamp():
    """The identity an entry is only ever replayed on: the card's name,
    compute capability and driver, the torch and CUDA versions, and the
    kernel library's source hash."""
    import torch

    from paddle_tpu_torch.ops.kernels import _build
    kernels = os.path.basename(_build.library_path())
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "capability": f"{major}.{minor}",
                "driver": _driver_version(), "torch": torch.__version__,
                "cuda": torch.version.cuda, "kernels": kernels}
    return {"platform": "cpu", "device_kind": "cpu", "capability": None,
            "driver": None, "torch": torch.__version__, "cuda": None,
            "kernels": kernels}


def program_cache_token(program):
    """Stable cross-process identity of a Program's content (not its
    id()): SHA-256 of its sorted-key `to_dict()` JSON, memoised per
    program version (the JAX package's token, compile_cache.py:134)."""
    cached = getattr(program, "_cache_token_memo", None)
    if cached is not None and cached[0] == program._version:
        return cached[1]
    text = json.dumps(program.to_dict(), sort_keys=True, default=str)
    h = hashlib.sha256(text.encode()).hexdigest()
    program._cache_token_memo = (program._version, h)
    return h


def _canonical(doc):
    return json.dumps(doc, sort_keys=True, default=str).encode()


class CompileCache:
    """On-disk signature entries + warm-start manifests. Thread-safe;
    processes may share one directory (atomic publish, last writer
    wins)."""

    def __init__(self, directory, keep=None):
        self.directory = os.path.abspath(directory)
        self.entries_dir = os.path.join(self.directory, "entries")
        self.manifests_dir = os.path.join(self.directory, "manifests")
        os.makedirs(self.entries_dir, exist_ok=True)
        os.makedirs(self.manifests_dir, exist_ok=True)
        self._keep = keep
        self._mu = make_lock("compile_cache.state")
        self._loaded = {}            # key_hash -> validated entry
        self._events = []
        self._stamp = None
        self._counter = None

    # -- identity -------------------------------------------------------
    def stamp(self):
        if self._stamp is None:
            self._stamp = device_stamp()
        return self._stamp

    def key_for(self, token, sig_key, static_args=()):
        """The cache key: token + dispatch key + static args + stamp."""
        text = json.dumps({"token": token, "sig": repr(sig_key),
                           "static": repr(tuple(static_args)),
                           "stamp": self.stamp()}, sort_keys=True)
        return hashlib.sha256(text.encode()).hexdigest()

    # -- events + metrics ----------------------------------------------
    def _count(self, event, reason=""):
        if self._counter is None:
            from paddle_tpu_torch.observability import metrics
            self._counter = metrics.registry().counter(
                "pt_compile_cache_total",
                "persistent compile-cache events "
                "(hit/miss/store/reject/flagged)",
                labels=("event", "reason"))
        self._counter.labels(event=event, reason=reason or "").inc()

    def note_event(self, event, key_hash, component=None, key=None,
                   scope=None, reason="", tier="signature", seconds=0.0):
        self._count(event, reason)
        with self._mu:
            self._events.append({
                "event": event, "key_hash": key_hash,
                "component": component, "key": key, "scope": scope,
                "reason": reason, "tier": tier, "seconds": seconds,
                "at": time.time()})  # wallclock-ok: stamp
            if len(self._events) > 4096:
                del self._events[:2048]

    def events(self, scope=None, event=None):
        with self._mu:
            out = list(self._events)
        if scope is not None:
            out = [e for e in out if e["scope"] == scope]
        if event is not None:
            out = [e for e in out if e["event"] == event]
        return out

    # -- entries --------------------------------------------------------
    def _entry_path(self, key_hash):
        return os.path.join(self.entries_dir, f"{key_hash}.json")

    def lookup(self, key_hash):
        """(entry, load_s, reason): the validated entry (memory first,
        then disk) or (None, 0.0, why not). Never raises."""
        with self._mu:
            meta = self._loaded.get(key_hash)
        if meta is not None:
            return meta, 0.0, "memory"
        t0 = time.perf_counter()
        meta, reason = self._load_entry(key_hash)
        if meta is None:
            return None, 0.0, reason
        with self._mu:
            self._loaded[key_hash] = meta
        return meta, time.perf_counter() - t0, "disk"

    def _load_entry(self, key_hash):
        """(entry | None, miss reason)."""
        path = self._entry_path(key_hash)
        try:
            # chaos choke point: a raise models a torn / unreadable cache
            # volume — the lookup degrades to a clean miss
            inject_point("compile_cache.read", tag=key_hash[:8])
            with open(path, "rb") as f:
                head = f.readline()
                body = f.read()
        except FileNotFoundError:
            return None, "absent"
        except (OSError, FaultError) as e:
            return None, f"io_error:{type(e).__name__}"
        try:
            header = json.loads(head)
        except ValueError:
            return None, "truncated:header"
        if header.get("format") != ENTRY_FORMAT:
            return None, "format_mismatch"
        if len(body) != header.get("size"):
            return None, "truncated:entry"
        if zlib.crc32(body) != header.get("crc32"):
            return None, "crc_mismatch:entry"
        meta = json.loads(body)
        mismatch = self._stamp_mismatch(meta.get("stamp") or {})
        if mismatch:
            return None, mismatch
        if meta.get("key_hash") != key_hash:
            return None, "key_mismatch"
        return meta, None

    def _stamp_mismatch(self, saved):
        """Name which stamp field diverged."""
        now = self.stamp()
        for field in _STAMP_FIELDS:
            if saved.get(field) != now[field]:
                return f"device_stamp:{field}"
        for field in _VERSION_FIELDS:
            if saved.get(field) != now[field]:
                return f"version:{field}"
        return None

    def store(self, key_hash, token, signature, static_args, n_args,
              compile_s, component=None, key=None, scope=None, cost=None,
              memory=None):
        """Persist one captured signature. Returns (event, reason): event
        "store", or "reject" with the reason (an IO error) — never an
        exception."""
        if compile_s >= _flags.get_flag("compile_cache_slow_compile_s"):
            self._flag_pathology(key_hash, component=component, key=key,
                                 compile_s=compile_s,
                                 signature=[list(map(str, s))
                                            for s in signature])
        meta = {"format": ENTRY_FORMAT, "key_hash": key_hash,
                "token": token, "component": component, "key": key,
                "stamp": self.stamp(), "created_at": time.time(),  # wallclock-ok
                "compile_s": float(compile_s),
                "signature": [[label, list(shape), dtype]
                              for label, shape, dtype in signature],
                "static_args": [[k, str(v)] for k, v in static_args],
                "static_kw": dict(static_args), "n_args": int(n_args),
                "cost": cost, "memory": memory}
        body = _canonical(meta)
        header = json.dumps({"format": ENTRY_FORMAT, "size": len(body),
                             "crc32": zlib.crc32(body)}).encode()
        path = self._entry_path(key_hash)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            # chaos choke point: a raise models a full disk / torn write —
            # a clean reject, the temporary file removed
            inject_point("compile_cache.write", tag=key_hash[:8])
            with open(tmp, "wb") as f:
                f.write(header + b"\n" + body)
            os.replace(tmp, path)
        except (OSError, FaultError) as e:
            if os.path.exists(tmp):
                os.remove(tmp)
            event, reason = "reject", f"io_error:{type(e).__name__}"
        else:
            with self._mu:
                self._loaded[key_hash] = json.loads(body)
            event, reason = "store", None
            self.gc()
        self.note_event(event, key_hash, component, key, scope,
                        reason=reason or "")
        return event, reason

    # -- warm-start manifests ------------------------------------------
    def _manifest_path(self, name):
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in str(name))
        return os.path.join(self.manifests_dir, f"{safe}.json")

    def write_manifest(self, name, scope=None, entries=None):
        """Record a component's signature ladder: every key this scope hit
        or stored in this process (or an explicit entry list). Atomic;
        returns the entry count."""
        if entries is None:
            seen = {}
            for e in self.events(scope=scope):
                if e["event"] in ("hit", "store"):
                    seen[e["key_hash"]] = {"key_hash": e["key_hash"],
                                           "component": e["component"],
                                           "key": e["key"]}
            entries = list(seen.values())
        doc = {"name": str(name), "written_at": time.time(),  # wallclock-ok
               "stamp": self.stamp(), "entries": entries}
        path = self._manifest_path(name)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("compile cache manifest %s not written: %s",
                           name, e)
            return 0
        return len(entries)

    def load_manifest(self, name):
        try:
            with open(self._manifest_path(name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def warm_start(self, name, wrappers):
        """Capture every signature manifest `name` lists, before traffic,
        on the `wrappers` (ProfiledGraph objects) whose cache token the
        entry names. A listed entry that is missing or invalid is a miss
        with its reason. Returns {"manifest", "found", "requested",
        "loaded", "captured", "seconds"}."""
        t0 = time.perf_counter()
        doc = self.load_manifest(name)
        if not doc:
            return {"manifest": str(name), "found": False, "requested": 0,
                    "loaded": 0, "captured": 0, "seconds": 0.0}
        by_token = {w.cache_token: w for w in wrappers}
        entries = doc.get("entries") or []
        loaded = captured = 0
        for ent in entries:
            kh = ent.get("key_hash")
            meta, load_s, reason = self.lookup(kh)
            wrapper = None if meta is None else by_token.get(meta["token"])
            if wrapper is None:
                reason = reason if meta is None else "no_wrapper"
                self.note_event("miss", kh, ent.get("component"),
                                ent.get("key"), reason=reason)
                if self._is_flagged(kh):
                    self.note_event("flagged", kh, ent.get("component"),
                                    ent.get("key"), reason=reason)
                continue
            loaded += 1
            self.note_event("hit", kh, wrapper.component, meta["key"],
                            wrapper.scope, seconds=load_s)
            captured += bool(wrapper.warm(meta, load_s))
        return {"manifest": str(name), "found": True,
                "requested": len(entries), "loaded": loaded,
                "captured": captured,
                "seconds": time.perf_counter() - t0}

    # -- pathology ledger ----------------------------------------------
    def _pathology_path(self):
        return os.path.join(self.directory, "PATHOLOGY.json")

    def _read_pathology(self):
        try:
            with open(self._pathology_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _flag_pathology(self, key_hash, **info):
        """Advisory record of a slow capture (last writer wins)."""
        doc = self._read_pathology()
        info["flagged_at"] = time.time()  # wallclock-ok: a wall stamp
        doc[key_hash] = info
        tmp = f"{self._pathology_path()}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, self._pathology_path())
        except OSError:
            return
        self._count("flagged", "slow_capture")
        logger.warning("compile cache: flagged slow capture %s (%.1f s, "
                       "component=%s key=%s)", key_hash[:12],
                       info.get("compile_s"), info.get("component"),
                       info.get("key"))

    def _is_flagged(self, key_hash):
        return key_hash in self._read_pathology()

    def pathologies(self):
        return self._read_pathology()

    # -- retention + stats ---------------------------------------------
    def gc(self):
        """Keep the newest `keep` entries by publish time; drop the rest
        and stale tmp files. Returns the number dropped."""
        keep = (self._keep if self._keep is not None
                else _flags.get_flag("compile_cache_keep"))
        if not keep:
            return 0
        entries, dropped = [], 0
        for name in os.listdir(self.entries_dir):
            p = os.path.join(self.entries_dir, name)
            try:
                mtime = os.path.getmtime(p)
            except OSError:
                continue
            if ".tmp-" in name:
                if time.time() - mtime > 300:  # wallclock-ok: vs file mtime
                    os.remove(p)
                continue
            entries.append((mtime, name))
        entries.sort(reverse=True)
        for _, name in entries[int(keep):]:
            os.remove(os.path.join(self.entries_dir, name))
            with self._mu:
                self._loaded.pop(name[:-len(".json")], None)
            dropped += 1
        return dropped

    def entries_on_disk(self):
        return sorted(n[:-len(".json")] for n in os.listdir(self.entries_dir)
                      if n.endswith(".json") and ".tmp-" not in n)

    def stats(self):
        names = self.entries_on_disk()
        size = sum(os.path.getsize(self._entry_path(n)) for n in names
                   if os.path.exists(self._entry_path(n)))
        by_event = {}
        for e in self.events():
            by_event[e["event"]] = by_event.get(e["event"], 0) + 1
        manifests = sorted(m[:-5] for m in os.listdir(self.manifests_dir)
                           if m.endswith(".json"))
        return {"directory": self.directory, "entries": len(names),
                "bytes": size, "loaded": len(self._loaded),
                "events": by_event, "manifests": manifests,
                "flagged_pathologies": len(self._read_pathology()),
                "stamp": self.stamp()}


_caches = {}
_caches_mu = make_lock("compile_cache.registry")


def compile_cache():
    """The process cache for PT_FLAGS_compile_cache_dir, or None when the
    flag is empty (the wrappers then skip all cache work). One
    CompileCache per directory."""
    directory = _flags.get_flag("compile_cache_dir")
    if not directory:
        return None
    directory = os.path.abspath(directory)
    with _caches_mu:
        cache = _caches.get(directory)
        if cache is None:
            cache = _caches[directory] = CompileCache(directory)
    return cache


def reset_compile_cache():
    """Tests: drop cached instances (the next compile_cache() call re-reads
    the flag)."""
    with _caches_mu:
        _caches.clear()
