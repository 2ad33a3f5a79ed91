"""Fleet service discovery: the registry of live backend processes.

Counterpart of paddle_tpu/fleet/discovery.py. The directory is the
routing tier's single source of truth for *which backends exist and
whether they are dialable*. Backends announce themselves, then beat
periodically with a load doc; a sweep pass walks the liveness FSM

    JOINING --announce/beat--> LIVE
    LIVE    --silent > fleet_suspect_after_s--> SUSPECT   (deprioritized)
    SUSPECT --beat--> LIVE                                (recovered)
    SUSPECT --silent > fleet_lost_after_s--> LOST         (evicted)

LOST is terminal for that *generation* of the backend (a zombie beating
after eviction is rejected), but a backend may re-announce and rejoin as
a fresh generation. Everything takes an injectable clock, so the FSM
edges are fake-clock testable.

Durability: the directory can attach a `DirectoryStore` — membership
changes snapshot to disk under the `reliability/checkpoint` CRC-manifest
discipline (write-tmp -> CRC -> one rename), in the JAX package's
`fleet-snapshot-v1` format, so a snapshot written by either package
loads in the other. A restarted or promoted router re-adopts live
backends from the latest valid snapshot via `adopt()`; adopted records
get a fresh beat window, and a backend that never re-beats is reaped by
the normal sweep.
"""
import binascii
import json
import os
import shutil
import threading
import time

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.reliability.faults import inject_point

__all__ = ["JOINING", "LIVE", "SUSPECT", "LOST", "SELECTABLE",
           "BackendRecord", "DirectoryStore", "FleetDirectory"]

JOINING = "JOINING"
LIVE = "LIVE"
SUSPECT = "SUSPECT"
LOST = "LOST"

# states the router may still dial (SUSPECT is penalized, not excluded:
# a slow backend beats a failed request, but a healthy one beats both)
SELECTABLE = (LIVE, SUSPECT)


class BackendRecord:
    """One backend's directory entry. Mutated only under the directory
    lock; `snapshot()` hands out plain dicts."""

    __slots__ = ("name", "address", "meta", "state", "generation",
                 "joined_at", "last_beat", "load", "beats", "recoveries",
                 "consecutive_failures", "evicted_at", "evict_reason",
                 "verdict")

    def __init__(self, name, address, meta, now, generation):
        self.name = name
        self.address = tuple(address)
        self.meta = dict(meta or {})
        self.state = JOINING
        self.generation = generation
        self.joined_at = now
        self.last_beat = now
        self.load = {}
        self.verdict = None           # /healthz verdict from the poller
        self.beats = 0
        self.recoveries = 0
        self.consecutive_failures = 0
        self.evicted_at = None
        self.evict_reason = None

    def snapshot(self):
        return {
            "name": self.name,
            "address": list(self.address),
            "state": self.state,
            "generation": self.generation,
            "joined_at": self.joined_at,
            "last_beat": self.last_beat,
            "load": dict(self.load),
            "verdict": self.verdict,
            "beats": self.beats,
            "recoveries": self.recoveries,
            "meta": dict(self.meta),
            "evict_reason": self.evict_reason,
        }


class DirectoryStore:
    """Crash-safe persistence for the fleet control plane, one JSON doc
    per snapshot under the `reliability/checkpoint.py` discipline:
    write into `fleet-<seq>.tmp/`, stamp every file's CRC32 + size into
    MANIFEST.json (written LAST — a manifest's presence asserts the
    payload beneath it is complete), then one atomic `os.replace`. A
    torn write leaves either a `.tmp` (ignored) or a snapshot whose
    CRCs don't match (skipped); `load_latest()` walks newest-first and
    returns the newest snapshot that validates.

    The doc carries directory membership, the fleet epoch, and
    registered extras (autoscaler cooldown/floor/ceiling) — everything
    a promoted or restarted router needs to avoid double-spawning into
    a cold storm.
    """

    DOC_NAME = "fleet.json"
    FORMAT = "fleet-snapshot-v1"

    def __init__(self, root, keep=3):
        self.root = str(root)
        self.keep = int(keep)
        os.makedirs(self.root, exist_ok=True)
        self._mu = make_lock("fleet.store")

    # -- write ---------------------------------------------------------
    def save(self, doc):
        """Persist one snapshot doc; returns the sequence number."""
        with self._mu:
            seq = self._next_seq()
            final = os.path.join(self.root, "fleet-%06d" % seq)
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            blob = json.dumps(doc, sort_keys=True).encode("utf-8")
            path = os.path.join(tmp, self.DOC_NAME)
            with open(path, "wb") as f:
                f.write(blob)
            manifest = {
                "seq": seq,
                "format": self.FORMAT,
                "files": {self.DOC_NAME: {
                    "crc32": binascii.crc32(blob) & 0xFFFFFFFF,
                    "size": len(blob)}},
            }
            # chaos: a router crash mid-snapshot must leave the previous
            # snapshot untouched and loadable
            inject_point("fleet.snapshot_write", tag=str(seq))
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, final)
            self._gc()
            return seq

    # -- read ----------------------------------------------------------
    def load_latest(self):
        """Return (doc, seq) for the newest valid snapshot, or
        (None, None) when nothing on disk validates."""
        for seq in sorted(self._seqs(), reverse=True):
            doc = self._load_one(seq)
            if doc is not None:
                return doc, seq
        return None, None

    def _load_one(self, seq):
        d = os.path.join(self.root, "fleet-%06d" % seq)
        try:
            with open(os.path.join(d, "MANIFEST.json")) as f:
                manifest = json.load(f)
            want = manifest.get("files", {}).get(self.DOC_NAME)
            if not want:
                return None
            path = os.path.join(d, self.DOC_NAME)
            with open(path, "rb") as f:
                blob = f.read()
            if (len(blob) != int(want["size"])
                    or (binascii.crc32(blob) & 0xFFFFFFFF)
                    != int(want["crc32"])):
                return None
            # chaos: a corrupt-read fault means this snapshot is dead —
            # the walk falls back to the next-older one
            try:
                inject_point("fleet.snapshot_read", tag=str(seq))
            except RuntimeError:
                return None
            return json.loads(blob.decode("utf-8"))
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _seqs(self):
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            if n.startswith("fleet-") and not n.endswith(".tmp"):
                try:
                    out.append(int(n.split("-", 1)[1]))
                except ValueError:
                    continue
        return out

    def _next_seq(self):
        seqs = self._seqs()
        return (max(seqs) + 1) if seqs else 1

    def _gc(self):
        seqs = sorted(self._seqs(), reverse=True)
        for seq in seqs[self.keep:]:
            shutil.rmtree(
                os.path.join(self.root, "fleet-%06d" % seq),
                ignore_errors=True)


class FleetDirectory:
    """Thread-safe registry of backends keyed by name.

    >>> d = FleetDirectory(clock=fake)
    >>> d.announce("b0", ("127.0.0.1", 4001))
    >>> d.beat("b0", load={"queue_depth": 3})
    True
    >>> d.sweep()                    # walk the FSM against the clock
    []
    >>> [r["name"] for r in d.selectable()]
    ['b0']

    `on_evict(cb)` callbacks fire (outside the lock) with the evicted
    record's snapshot — the router uses this to undial, the manager to
    reap the child process.
    """

    def __init__(self, suspect_after_s=None, lost_after_s=None,
                 clock=None, store=None):
        self._clock = clock or time.monotonic
        self.suspect_after_s = float(
            suspect_after_s if suspect_after_s is not None
            else _flags.get_flag("fleet_suspect_after_s"))
        self.lost_after_s = float(
            lost_after_s if lost_after_s is not None
            else _flags.get_flag("fleet_lost_after_s"))
        self._mu = make_lock("fleet.directory")
        self._backends = {}           # name -> BackendRecord
        self._tombstones = {}         # name -> last evicted snapshot
        self._generation = 0
        self._on_evict = []
        self._on_join = []
        self._events = []             # bounded transition log
        self._sweeper = None
        self._sweeper_stop = threading.Event()
        self._store = store           # DirectoryStore or None
        self._extras = {}             # key -> provider fn for snapshots
        self.snapshot_errors = 0

    # -- callbacks -----------------------------------------------------
    def on_evict(self, cb):
        self._on_evict.append(cb)
        return cb

    def on_join(self, cb):
        self._on_join.append(cb)
        return cb

    # -- durability ----------------------------------------------------
    @property
    def store(self):
        return self._store

    def attach_store(self, store):
        """Attach a DirectoryStore; membership changes snapshot to it."""
        self._store = store
        return store

    def extra_state(self, key, provider):
        """Register a provider whose doc rides in every snapshot (the
        router contributes its epoch, the autoscaler its cooldown)."""
        self._extras[str(key)] = provider

    def save_snapshot(self):
        """Persist the control plane to the attached store; returns the
        sequence number or None (no store / write fault — a failed
        snapshot never takes the live directory down, it just costs
        durability until the next membership change retries)."""
        if self._store is None:
            return None
        with self._mu:
            doc = {
                "format": DirectoryStore.FORMAT,
                "generation_counter": self._generation,
                "backends": [
                    {"name": r.name, "address": list(r.address),
                     "meta": dict(r.meta), "generation": r.generation,
                     "state": r.state, "load": dict(r.load)}
                    for r in self._backends.values()
                    if r.state in SELECTABLE],
            }
        extras = {}
        for key, provider in list(self._extras.items()):
            try:
                extras[key] = provider()
            except Exception:  # noqa: BLE001 - a broken provider must
                self.snapshot_errors += 1   # not block the snapshot
        doc["extras"] = extras
        try:
            return self._store.save(doc)
        except (OSError, ValueError, RuntimeError):
            self.snapshot_errors += 1
            with self._mu:
                self._log("snapshot-error", "-", "-", self._clock())
            return None

    def adopt(self, doc=None):
        """Re-adopt live backends from a snapshot doc (or the newest
        valid one in the attached store). Each adopted record keeps its
        persisted generation but gets a fresh beat window — its next
        re-announce beat confirms it, the sweep reaps it past
        `lost_after_s` if it never comes back. Names already present
        (adoption-from-beats won the race) are left alone. Returns
        (adopted_names, extras_dict)."""
        if doc is None:
            if self._store is None:
                return [], {}
            doc, _seq = self._store.load_latest()
            if doc is None:
                return [], {}
        now = self._clock()
        adopted = []
        joined = []
        with self._mu:
            self._generation = max(
                self._generation, int(doc.get("generation_counter", 0)))
            for ent in doc.get("backends", ()):
                name = ent.get("name")
                if not name or name in self._backends:
                    continue
                try:
                    # chaos: one backend's adoption faulting must not
                    # poison the rest — it rejoins on its next beat
                    inject_point("fleet.adopt", tag=name)
                except RuntimeError:
                    self._log("adopt-fault", name, "-", now)
                    continue
                rec = BackendRecord(
                    name, tuple(ent.get("address") or ()),
                    ent.get("meta"), now,
                    int(ent.get("generation", 0)))
                rec.state = LIVE      # grace window until its next beat
                rec.load = dict(ent.get("load") or {})
                self._backends[name] = rec
                self._tombstones.pop(name, None)
                self._log("adopt", name, LIVE, now)
                adopted.append(name)
                joined.append(rec.snapshot())
        for snap in joined:
            for cb in list(self._on_join):
                cb(snap)
        if adopted:
            self.save_snapshot()
        return adopted, dict(doc.get("extras") or {})

    # -- membership ----------------------------------------------------
    def announce(self, name, address, meta=None, load=None):
        """Register (or re-register) a backend. Re-announcing an
        evicted name rejoins it as a fresh generation. A re-announce
        triggered by a 410 carries the backend's current `load` so the
        promoted router routes on real queue depths immediately."""
        now = self._clock()
        with self._mu:
            self._generation += 1
            rec = BackendRecord(name, address, meta, now,
                                self._generation)
            rec.state = LIVE          # an announce is the first beat
            rec.beats = 1
            if load is not None:
                rec.load = dict(load)
            self._backends[name] = rec
            self._tombstones.pop(name, None)
            self._log("join", name, LIVE, now)
            snap = rec.snapshot()
        for cb in list(self._on_join):
            cb(snap)
        self.save_snapshot()
        return snap

    def beat(self, name, load=None):
        """Record a heartbeat. Returns False for unknown/evicted names
        (the zombie-rejection edge: the beater should re-announce)."""
        now = self._clock()
        with self._mu:
            rec = self._backends.get(name)
            if rec is None:
                return False
            rec.last_beat = now
            rec.beats += 1
            rec.consecutive_failures = 0
            if load is not None:
                rec.load = dict(load)
            if rec.state == SUSPECT:
                rec.state = LIVE
                rec.recoveries += 1
                self._log("recover", name, LIVE, now)
            elif rec.state == JOINING:
                rec.state = LIVE
                self._log("live", name, LIVE, now)
            return True

    def observe(self, name, verdict=None, load=None):
        """Poller feedback: /healthz verdict and /stats-derived load.
        Does NOT count as a heartbeat (liveness is the backend's own
        push; a router-side poll succeeding proves reachability, which
        `beat` also implies, but the FSM stays single-sourced)."""
        with self._mu:
            rec = self._backends.get(name)
            if rec is None:
                return False
            if verdict is not None:
                rec.verdict = verdict
            if load is not None:
                rec.load.update(load)
            return True

    def report_failure(self, name, threshold=2):
        """Router feedback: a dial/forward to this backend failed.
        `threshold` consecutive failures force SUSPECT immediately —
        the router stops preferring a torn backend *before* the
        heartbeat timeout notices."""
        now = self._clock()
        with self._mu:
            rec = self._backends.get(name)
            if rec is None:
                return
            rec.consecutive_failures += 1
            if (rec.consecutive_failures >= threshold
                    and rec.state == LIVE):
                rec.state = SUSPECT
                self._log("suspect", name, SUSPECT, now,
                          reason="forward-failures")

    def evict(self, name, reason="evicted"):
        """Explicit eviction (retire, kill, lost). Fires on_evict."""
        now = self._clock()
        with self._mu:
            rec = self._backends.pop(name, None)
            if rec is None:
                return None
            rec.state = LOST
            rec.evicted_at = now
            rec.evict_reason = reason
            snap = rec.snapshot()
            self._tombstones[name] = snap
            self._log("evict", name, LOST, now, reason=reason)
        for cb in list(self._on_evict):
            cb(snap)
        self.save_snapshot()
        return snap

    # -- the FSM sweep -------------------------------------------------
    def sweep(self, now=None):
        """Walk every record against the clock; returns the list of
        transition events this pass produced. Called by the background
        sweeper thread in production and directly (with a fake clock)
        in tests."""
        if now is None:
            now = self._clock()
        transitions = []
        evicted = []
        with self._mu:
            for rec in list(self._backends.values()):
                silent = now - rec.last_beat
                if (rec.state in (LIVE, JOINING)
                        and silent > self.suspect_after_s):
                    rec.state = SUSPECT
                    ev = self._log("suspect", rec.name, SUSPECT, now,
                                   reason="missed-heartbeats")
                    transitions.append(ev)
                if (rec.state == SUSPECT
                        and silent > self.lost_after_s):
                    rec.state = LOST
                    rec.evicted_at = now
                    rec.evict_reason = "missed-heartbeats"
                    snap = rec.snapshot()
                    del self._backends[rec.name]
                    self._tombstones[rec.name] = snap
                    ev = self._log("evict", rec.name, LOST, now,
                                   reason="missed-heartbeats")
                    transitions.append(ev)
                    evicted.append(snap)
        for snap in evicted:
            for cb in list(self._on_evict):
                cb(snap)
        if evicted:
            self.save_snapshot()
        return transitions

    def start_sweeper(self, interval_s=0.25):
        """Background FSM driver (the watchdog idiom); idempotent."""
        if self._sweeper is not None:
            return
        self._sweeper_stop.clear()

        def _run():
            while not self._sweeper_stop.wait(interval_s):
                self.sweep()

        self._sweeper = threading.Thread(
            target=_run, name="fleet-directory-sweeper", daemon=True)
        self._sweeper.start()

    def stop_sweeper(self):
        if self._sweeper is None:
            return
        self._sweeper_stop.set()
        self._sweeper.join(timeout=5.0)
        self._sweeper = None

    # -- views ---------------------------------------------------------
    def get(self, name):
        with self._mu:
            rec = self._backends.get(name)
            return rec.snapshot() if rec is not None else None

    def selectable(self):
        """Records the router may dial, LIVE first then SUSPECT."""
        with self._mu:
            recs = [r.snapshot() for r in self._backends.values()
                    if r.state in SELECTABLE]
        recs.sort(key=lambda r: (r["state"] != LIVE, r["name"]))
        return recs

    def size(self):
        with self._mu:
            return len(self._backends)

    def names(self):
        with self._mu:
            return sorted(self._backends)

    def snapshot(self):
        with self._mu:
            return {
                "backends": {n: r.snapshot()
                             for n, r in self._backends.items()},
                "tombstones": dict(self._tombstones),
                "suspect_after_s": self.suspect_after_s,
                "lost_after_s": self.lost_after_s,
                "events": list(self._events[-64:]),
            }

    # -- internals -----------------------------------------------------
    def _log(self, kind, name, state, now, reason=None):
        ev = {"event": kind, "backend": name, "state": state, "t": now}
        if reason:
            ev["reason"] = reason
        self._events.append(ev)
        if len(self._events) > 512:
            del self._events[:256]
        return ev
