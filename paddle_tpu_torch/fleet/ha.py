"""Router HA: the standby that makes the fleet's front tier zero-SPOF.

Counterpart of paddle_tpu/fleet/ha.py. The takeover FSM, built from
parts the fleet already trusts:

* the ACTIVE's liveness is tracked by a private one-record
  `FleetDirectory` — the standby beats it (a `fleet.peer` RPC doubles as
  the HA pair's heartbeat AND teaches the standby the fleet epoch) and
  the SAME suspect/lost FSM that evicts backends declares the active
  LOST;
* promotion is `FleetRouter.promote()`: a fresh epoch strictly above
  everything seen (replies, beats, the durable snapshot), adoption of
  the snapshot's backends, and a snapshot of the new epoch — so the
  zombie ex-active fences itself on the next backend beat it hears;
* double-standby election is deterministic by integer `rank`: rank r
  defers `r x election_delay_s` after LOST, and yields to any live
  lower-ranked peer (probed over the same `fleet.peer` RPC).

`RouterProcess` + `main()` give a SIGKILL-able router child
(``python -m paddle_tpu_torch.fleet.ha --spec ...`` -> ``ROUTER-READY``
handshake line, mirroring the backend child protocol). The router child
never touches the card. A spec with ``"standby": true`` and
``"active": [host, port]`` runs a standby with its `StandbyMonitor`.

Everything takes an injectable clock and probe, so the whole matrix is
fake-clock testable.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.fleet.discovery import DirectoryStore, FleetDirectory
from paddle_tpu_torch.serving import wire

__all__ = ["StandbyMonitor", "RouterProcess", "peer_rpc", "main",
           "ROUTER_READY_MARK", "ROUTER_PROMOTED_MARK"]

ROUTER_READY_MARK = "ROUTER-READY "
ROUTER_PROMOTED_MARK = "ROUTER-PROMOTED "

#: the active's name inside the monitor's private directory
_ACTIVE = "active-router"


def peer_rpc(address, header, timeout_s=2.0):
    """One `fleet.peer` round trip (dial → MAGIC → frame → reply).
    Raises WireError/OSError on any transport failure — exactly the
    signal the liveness FSM wants."""
    with socket.create_connection(tuple(address),
                                  timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        wire.send_all(s, wire.MAGIC)
        wire.send_frame(s, wire.encode_payload(header, []))
        payload = wire.recv_frame(s)
        if payload is None:
            raise wire.WireError("peer closed the HA channel")
        resp, _ = wire.decode_payload(payload)
        return resp


class StandbyMonitor:
    """Heartbeat the active router; promote this standby on LOST.

    `router` is a standby-mode FleetRouter (it keeps answering
    membership so its directory stays warm). `probe(address)` is one
    liveness check returning the peer's reply doc — the default dials
    a `fleet.peer` RPC; tests inject a fake. `peers` lists the OTHER
    standbys as (name, address, rank); a standby only promotes when
    every lower-ranked peer is dead too.
    """

    def __init__(self, router, active_address, clock=time.monotonic,
                 beat_interval_s=None, suspect_after_s=None,
                 lost_after_s=None, rank=0, peers=(),
                 election_delay_s=0.5, probe=None, autoscaler=None):
        self.router = router
        self.active_address = tuple(active_address)
        self._clock = clock
        self.beat_interval_s = float(
            beat_interval_s if beat_interval_s is not None
            else _flags.get_flag("fleet_heartbeat_interval_s"))
        self.rank = int(rank)
        self.peers = [(str(n), tuple(a), int(r)) for n, a, r in peers]
        self.election_delay_s = float(election_delay_s)
        self._probe = probe or self._default_probe
        self.autoscaler = autoscaler
        # the HA pair's liveness FSM: the same directory machinery
        # that evicts backends, tracking exactly one record
        self._mon = FleetDirectory(
            suspect_after_s=suspect_after_s,
            lost_after_s=lost_after_s, clock=clock)
        self._mon.announce(_ACTIVE, self.active_address,
                           meta={"role": "router"})
        self._lost_at = None
        self.promoted = False
        self.promoted_at = None       # clock() stamp of the takeover
        self.takeover_epoch = None
        self.counters = {"beats": 0, "probe_failures": 0,
                         "deferrals": 0, "retargets": 0,
                         "promote_faults": 0}
        self._mu = make_lock("fleet.ha.monitor")
        self._thread = None
        self._stop = threading.Event()

    # -- probing -------------------------------------------------------
    def _default_probe(self, address):
        return peer_rpc(address, {
            "op": "fleet.peer", "name": self.router.name,
            "address": list(self.router.address),
            "rank": self.rank, "epoch": self.router.epoch})

    # -- one FSM pass (fake-clock drivable) ----------------------------
    def observe(self, now=None):
        """One heartbeat + sweep + (maybe) election pass. Returns one
        of "promoted", "active-live", "active-suspect", "waiting",
        "deferred", "retargeted", "promote-fault", "done"."""
        if self.promoted:
            return "done"
        if now is None:
            now = self._clock()
        try:
            resp = self._probe(self.active_address)
        except (wire.WireError, OSError):
            resp = None
            self.counters["probe_failures"] += 1
        if resp is not None:
            ep = resp.get("epoch")
            if ep is not None and int(ep) > self.router._epoch_seen:
                self.router._epoch_seen = int(ep)
            self.counters["beats"] += 1
            if not self._mon.beat(_ACTIVE):
                # the active came BACK after we declared it lost but
                # before we promoted: rejoin it, cancel the election
                self._mon.announce(_ACTIVE, self.active_address,
                                   meta={"role": "router"})
                self._lost_at = None
        self._mon.sweep(now)
        rec = self._mon.get(_ACTIVE)
        if rec is not None:
            if rec["state"] != "SUSPECT":
                self._lost_at = None
                return "active-live"
            return "active-suspect"
        # the active is LOST — election time
        if self._lost_at is None:
            self._lost_at = now
        if now - self._lost_at < self.rank * self.election_delay_s:
            return "waiting"   # a lower rank gets first claim
        for name, addr, rank in sorted(self.peers,
                                       key=lambda p: p[2]):
            if rank >= self.rank:
                continue
            try:
                resp = self._probe(addr)
            except (wire.WireError, OSError):
                continue
            if resp.get("role") == "active":
                # the election already resolved: follow the winner
                self.retarget(addr)
                return "retargeted"
            self.counters["deferrals"] += 1
            return "deferred"     # a live lower-ranked standby owns it
        return self._promote(now)

    def retarget(self, new_active_address):
        """Track a different active (a peer won the election)."""
        self.counters["retargets"] += 1
        self.active_address = tuple(new_active_address)
        self._mon.evict(_ACTIVE, reason="retargeted")
        self._mon.announce(_ACTIVE, self.active_address,
                           meta={"role": "router"})
        self._lost_at = None

    def _promote(self, now):
        try:
            epoch, adopted, extras = self.router.promote()
        except RuntimeError:
            # fleet.takeover fault: THIS attempt aborted; retry on the
            # next pass — the fleet stays standby-served (503 +
            # retry_after) meanwhile, never half-promoted
            self.counters["promote_faults"] += 1
            return "promote-fault"
        if self.autoscaler is not None:
            self.autoscaler.restore_state(
                extras.get("autoscaler"), now=self._clock())
        with self._mu:
            self.promoted = True
            self.promoted_at = now
            self.takeover_epoch = epoch
        return "promoted"

    # -- background driver ---------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.beat_interval_s):
                if self.observe() in ("promoted", "done"):
                    return

        self._thread = threading.Thread(
            target=_run, name=f"fleet-ha-{self.router.name}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def stats(self):
        with self._mu:
            return {"rank": self.rank, "promoted": self.promoted,
                    "promoted_at": self.promoted_at,
                    "takeover_epoch": self.takeover_epoch,
                    "active_address": list(self.active_address),
                    "counters": dict(self.counters)}


# ---------------------------------------------------------------------
# child entry point + parent-side handle (the chaos drills' SIGKILL
# target)
# ---------------------------------------------------------------------

def main(argv=None):
    """Router child entry: bring up a FleetRouter (with a durable
    DirectoryStore when `snapshot_dir` is given), print the ROUTER-READY
    handshake line, serve until SIGTERM. With ``"standby": true`` the
    router starts standby and a StandbyMonitor beats ``"active"``
    (``monitor_suspect_after_s``, ``monitor_lost_after_s``,
    ``beat_interval_s``, ``rank``); on promotion the child prints a
    ROUTER-PROMOTED line (epoch, adopted backends, wall time)."""
    import argparse
    from paddle_tpu_torch.fleet.router import FleetRouter
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.fleet.ha")
    p.add_argument("--spec", required=True,
                   help="router spec as inline JSON or a file path")
    args = p.parse_args(argv)
    raw = args.spec
    if os.path.exists(raw):
        with open(raw) as f:
            raw = f.read()
    spec = json.loads(raw)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    store = None
    directory = FleetDirectory(
        suspect_after_s=spec.get("suspect_after_s"),
        lost_after_s=spec.get("lost_after_s"))
    if spec.get("snapshot_dir"):
        store = DirectoryStore(spec["snapshot_dir"])
        directory.attach_store(store)
    router = FleetRouter(
        directory,
        host=spec.get("host", "127.0.0.1"),
        port=int(spec.get("port", 0)),
        poll_interval_s=spec.get("poll_interval_s"),
        epoch=int(spec.get("epoch", 1)),
        standby=bool(spec.get("standby", False)),
        name=spec.get("name", "router-child"))
    if (store is not None and spec.get("adopt", True)
            and not router.standby):
        # a RESTARTED active re-adopts its previous membership (and
        # keeps epoch monotonic) instead of starting blind
        doc, _seq = store.load_latest()
        if doc is not None:
            prev = int((doc.get("extras") or {})
                       .get("router", {}).get("epoch", 0))
            if prev >= router.epoch:
                router.epoch = prev + 1
                router._epoch_seen = router.epoch
            directory.adopt(doc)
    host, port = router.start()
    monitor = None
    if router.standby:
        monitor = StandbyMonitor(
            router, tuple(spec["active"]),
            beat_interval_s=spec.get("beat_interval_s"),
            suspect_after_s=spec.get("monitor_suspect_after_s"),
            lost_after_s=spec.get("monitor_lost_after_s"),
            rank=int(spec.get("rank", 0))).start()
    print(ROUTER_READY_MARK + json.dumps({
        "name": router.name, "host": host, "port": port,
        "pid": os.getpid(), "epoch": router.epoch,
        "role": router.role(), "jax_loaded": "jax" in sys.modules,
    }), flush=True)

    announced = False
    while not stop.is_set():
        stop.wait(0.05 if monitor is not None else 0.2)
        if monitor is not None and monitor.promoted and not announced:
            announced = True
            print(ROUTER_PROMOTED_MARK + json.dumps({
                "name": router.name, "epoch": router.epoch,
                "t_wall": time.time(),  # wallclock-ok: a wall stamp
                "adopted": router.stats()["counters"]["adopted"],
                "monitor": monitor.stats()}), flush=True)
    if monitor is not None:
        monitor.stop()
    router.shutdown(timeout_s=5.0)
    return 0


class RouterProcess:
    """Spawn and supervise one router child process (the
    BackendProcess protocol, ROUTER-READY flavored); `kill()` is the
    SIGKILL the chaos drills use."""

    def __init__(self, spec, env=None):
        self.spec = dict(spec)
        self.name = self.spec.get("name", "router-child")
        self._env = env
        self.proc = None
        self.address = None
        self.ready_doc = None
        self.promoted_doc = None
        self._ready = threading.Event()
        self._promoted = threading.Event()
        self._reader = None
        self._lines = []

    def start(self):
        env = dict(os.environ if self._env is None else self._env)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.fleet.ha",
             "--spec", json.dumps(self.spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        self._reader = threading.Thread(  # thread-ok: daemon exits at child stdout EOF (terminate/kill close it)
            target=self._read_stdout,
            name=f"fleet-router-stdout-{self.name}", daemon=True)
        self._reader.start()
        return self

    def _read_stdout(self):
        try:
            for line in self.proc.stdout:
                line = line.rstrip("\n")
                self._lines.append(line)
                if len(self._lines) > 2000:
                    del self._lines[:1000]
                if line.startswith(ROUTER_READY_MARK):
                    self.ready_doc = json.loads(
                        line[len(ROUTER_READY_MARK):])
                    self.address = (self.ready_doc["host"],
                                    self.ready_doc["port"])
                    self._ready.set()
                elif line.startswith(ROUTER_PROMOTED_MARK):
                    self.promoted_doc = json.loads(
                        line[len(ROUTER_PROMOTED_MARK):])
                    self._promoted.set()
        except (ValueError, OSError):
            pass
        finally:
            self._ready.set()        # unblock waiters on a dead child
            self._promoted.set()

    def wait_ready(self, timeout_s=60.0):
        if not self._ready.wait(timeout_s) or self.address is None:
            self.kill()
            if self._reader is not None:
                self._reader.join(timeout=5.0)
            tail = "\n".join(self._lines[-20:])
            raise RuntimeError(
                f"router {self.name} never became ready "
                f"(timeout {timeout_s}s):\n{tail}")
        return self.address

    def wait_promoted(self, timeout_s=30.0):
        """A standby child's ROUTER-PROMOTED doc (None on timeout or a
        dead child)."""
        self._promoted.wait(timeout_s)
        return self.promoted_doc

    @property
    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    @property
    def pid(self):
        return self.proc.pid if self.proc is not None else None

    def kill(self):
        """Chaos: SIGKILL, no drain."""
        if self.proc is not None and self.alive:
            try:
                self.proc.kill()
            except OSError:
                pass

    def terminate(self, timeout_s=10.0):
        if self.proc is None:
            return
        if self.alive:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.kill()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass

    def tail(self, n=20):
        return "\n".join(self._lines[-n:])


if __name__ == "__main__":
    sys.exit(main())
