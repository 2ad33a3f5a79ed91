"""Fleet autoscaler: SLO burn alerts in, spawn/retire decisions out.

Counterpart of paddle_tpu/fleet/autoscaler.py. `SloEngine.on_alert`
(observability/slo.py) fires edge-triggered burn-rate events; this
module turns a **page-severity fire** into a backend spawn and a
**sustained quiet window** into a graceful retire.

Scale-up path:

    alert fired -> debounce (cooldown) -> placement vet (the planner's
      static memory fit gate over the saved Program, nothing run) ->
      FleetManager.spawn() (the child warm-starts through the shared
      compile cache) -> FLEET-READY -> directory.announce -> the router
      dials it -> first request served

Scale-down: after `quiet_after_s` with no firing alert the newest backend
is retired with a drain — evicted from the directory FIRST (the router
stops routing to it), then SIGTERM. A spawn that fails (a vet rejection,
a `fleet.spawn` fault, a child that never gets ready) is absorbed: a
counter and a timeline event, never an exception out of the alert hook.

Every decision lands in `timeline`. The FSM is fake-clock testable:
construct with a fake `clock`, call `on_alert()` / `tick()` directly,
pass `spawn_async=False` so spawns happen inline. `export_state` /
`restore_state` carry the floor, ceiling and remaining cooldown across a
router takeover (the doc rides the directory snapshot).
"""
import threading
import time

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core import flags as _flags

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Drive a FleetManager off an SloEngine's alert stream.

    >>> scaler = FleetAutoscaler(manager, slo_engine=router.slo)
    >>> scaler.start()            # background tick loop (quiet window)
    ...
    >>> scaler.stop()
    """

    def __init__(self, manager, slo_engine=None, min_backends=None,
                 max_backends=None, cooldown_s=None, quiet_after_s=None,
                 clock=time.monotonic, spawn_async=True,
                 severities=("page",)):
        self.manager = manager
        self.slo = slo_engine
        self.min_backends = int(
            min_backends if min_backends is not None
            else _flags.get_flag("fleet_min_backends"))
        self.max_backends = int(
            max_backends if max_backends is not None
            else _flags.get_flag("fleet_max_backends"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else _flags.get_flag("fleet_scale_cooldown_s"))
        self.quiet_after_s = float(
            quiet_after_s if quiet_after_s is not None
            else _flags.get_flag("fleet_quiet_after_s"))
        self._clock = clock
        self._spawn_async = spawn_async
        self._severities = tuple(severities)
        self._mu = make_lock("fleet.autoscaler")
        self._last_action = None      # last spawn/retire clock stamp
        self._last_firing = None      # last time any alert was firing
        self._firing = set()          # (slo, rule) currently firing
        self._spawning = False
        self.timeline = []
        self.counters = {"spawns": 0, "retires": 0, "debounced": 0,
                         "at_ceiling": 0, "at_floor": 0,
                         "vet_rejected": 0, "spawn_errors": 0}
        self._thread = None
        self._stop = threading.Event()
        if slo_engine is not None:
            slo_engine.on_alert(self.on_alert)

    # -- the SloEngine hook --------------------------------------------
    def on_alert(self, evt):
        """Edge-triggered alert callback (runs on the SLO eval thread —
        spawns are pushed to a worker thread unless spawn_async=False
        so a multi-second spawn never blocks evaluation)."""
        key = (evt.get("slo"), evt.get("rule"))
        now = evt.get("t", self._clock())
        with self._mu:
            if evt.get("event") == "fire":
                self._firing.add(key)
                self._last_firing = now
            else:
                self._firing.discard(key)
        self._event("alert", slo=evt.get("slo"), rule=evt.get("rule"),
                    kind=evt.get("event"), severity=evt.get("severity"),
                    t=now)
        if (evt.get("event") == "fire"
                and evt.get("severity") in self._severities):
            self.maybe_scale_up(now=now)

    # -- scale up ------------------------------------------------------
    def maybe_scale_up(self, now=None):
        """Spawn one backend unless debounced / at ceiling / already
        spawning. Returns True when a spawn was started."""
        if now is None:
            now = self._clock()
        size = self.manager.size()
        with self._mu:
            if self._spawning:
                self.counters["debounced"] += 1
                verdict = None
            elif (self._last_action is not None
                    and now - self._last_action < self.cooldown_s):
                self.counters["debounced"] += 1
                verdict = "debounced"
            elif size >= self.max_backends:
                self.counters["at_ceiling"] += 1
                verdict = "at_ceiling"
            else:
                self._spawning = True
                self._last_action = now
                verdict = "spawn"
        if verdict is None:
            return False
        if verdict != "spawn":
            self._event(verdict, t=now, size=size)
            return False
        self._event("scale_up_decided", t=now)
        if self._spawn_async:
            threading.Thread(
                target=self._spawn_one,  # thread-ok: one-shot, bounded by fleet_spawn_timeout_s; finally clears _spawning
                name="fleet-autoscaler-spawn", daemon=True).start()
        else:
            self._spawn_one()
        return True

    def _spawn_one(self):
        try:
            handle = self.manager.spawn(wait=True)
            with self._mu:
                self.counters["spawns"] += 1
            self._event(
                "scaled_up", backend=handle.name,
                spawn_s=(handle.ready_doc or {}).get("t_ready_s"),
                compiles_paid=(handle.ready_doc or {}).get(
                    "compiles_paid"))
        except RuntimeError as e:
            with self._mu:
                if "vet rejected" in str(e):
                    self.counters["vet_rejected"] += 1
                else:
                    self.counters["spawn_errors"] += 1
            self._event("scale_up_failed", error=str(e))
        finally:
            with self._mu:
                self._spawning = False
                self._last_action = self._clock()

    # -- scale down (the quiet window) ---------------------------------
    def tick(self, now=None):
        """One scale-down evaluation: with no alert firing for
        `quiet_after_s` and the fleet above its floor, retire ONE
        backend with a graceful drain. Driven by the background loop
        in production, called directly (fake clock) in tests."""
        if now is None:
            now = self._clock()
        with self._mu:
            if self._firing:
                self._last_firing = now
                return None
            if self._spawning:
                return None
            quiet_since = self._last_firing
            if quiet_since is None:
                quiet_since = self._quiet_epoch(now)
            if now - quiet_since < self.quiet_after_s:
                return None
            if self.manager.size() <= self.min_backends:
                self.counters["at_floor"] += 1
                return None
            if (self._last_action is not None
                    and now - self._last_action < self.cooldown_s):
                return None
            self._last_action = now
        victim = self._pick_victim()
        if victim is None:
            return None
        self._event("retire_decided", backend=victim, t=now)
        doc = self.manager.retire(victim, drain=True)
        with self._mu:
            self.counters["retires"] += 1
            # the quiet window restarts: one retire per window
            self._last_firing = now
        self._event("scaled_down", backend=victim,
                    drained=(doc or {}).get("report") is not None)
        return victim

    def _quiet_epoch(self, now):
        # never saw an alert: quiet since the scaler's first tick
        if not hasattr(self, "_first_tick"):
            self._first_tick = now
        return self._first_tick

    def _pick_victim(self):
        """Retire the newest spawned backend (LIFO keeps the original
        capacity plan intact and the retired one is the most likely to
        have an empty session-affinity keyspace)."""
        names = self.manager.names()
        if not names:
            return None
        handles = [(self.manager.handle(n).spawned_at or 0, n)
                   for n in names]
        handles.sort()
        return handles[-1][1]

    # -- background driver ---------------------------------------------
    def start(self, interval_s=1.0):
        if self._thread is not None:
            return
        self._stop.clear()

        def _run():
            while not self._stop.wait(interval_s):
                self.tick()

        self._thread = threading.Thread(
            target=_run, name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- crash-safe state (rides the directory snapshot) --------------
    def export_state(self, now=None):
        """The doc a directory snapshot persists. Monotonic stamps do
        NOT survive a process restart, so the cooldown is exported as
        its REMAINING window, rebased against the restorer's clock —
        a rebooted/promoted control plane inherits the debounce
        instead of double-spawning into a cold storm."""
        if now is None:
            now = self._clock()
        with self._mu:
            remaining = 0.0
            if self._last_action is not None:
                remaining = max(
                    0.0, self.cooldown_s - (now - self._last_action))
            return {"cooldown_remaining_s": remaining,
                    "min_backends": self.min_backends,
                    "max_backends": self.max_backends,
                    "cooldown_s": self.cooldown_s,
                    "quiet_after_s": self.quiet_after_s,
                    "counters": dict(self.counters)}

    def restore_state(self, doc, now=None):
        """Adopt a persisted scaler doc (promotion / restart): the
        floor/ceiling and the remaining cooldown window carry over;
        counters and timeline stay local to this incarnation."""
        if not doc:
            return self
        if now is None:
            now = self._clock()
        with self._mu:
            if "min_backends" in doc:
                self.min_backends = int(doc["min_backends"])
            if "max_backends" in doc:
                self.max_backends = int(doc["max_backends"])
            remaining = float(doc.get("cooldown_remaining_s") or 0.0)
            if remaining > 0.0:
                remaining = min(remaining, self.cooldown_s)
                self._last_action = now - (self.cooldown_s - remaining)
        self._event("state_restored", t=now,
                    cooldown_remaining_s=remaining)
        return self

    # -- views ---------------------------------------------------------
    def firing(self):
        with self._mu:
            return sorted(self._firing)

    def stats(self):
        with self._mu:
            return {"counters": dict(self.counters),
                    "firing": sorted(self._firing),
                    "size": self.manager.size(),
                    "min_backends": self.min_backends,
                    "max_backends": self.max_backends,
                    "cooldown_s": self.cooldown_s,
                    "quiet_after_s": self.quiet_after_s}

    def _event(self, etype, **extra):
        ev = {"event": etype}
        ev.setdefault("t", extra.pop("t", self._clock()))
        ev.update(extra)
        with self._mu:
            self.timeline.append(ev)
        return ev
