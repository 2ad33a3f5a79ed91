"""Health scoring: one 0–1 score + verdict per replica / model / engine.

Counterpart of paddle_tpu/observability/health.py. The stack knows when
it is unhealthy — the pool's per-replica circuit breakers
(`serving/pool.py` ReplicaHealth), queue depth against capacity,
admission shed rates, watchdog stalls, captures under live traffic —
but that truth is scattered across `stats()` dicts and the metrics
registry. This module composes it into one machine-readable verdict,
the document the gateway's ``GET /healthz`` serves (HTTP 503 when
unhealthy).

Score composition — multiplicative factors, each in [0, 1], each
reported alongside the product so a degraded verdict names its cause:

* **replicas** — mean per-replica score (healthy 1.0, probing 0.5,
  quarantined 0.0). Zero healthy replicas forces the model verdict to
  ``unhealthy``.
* **queue** — 1 − depth/capacity, floored at 0.
* **shedding** — 1 − (rejected admissions / total admissions) over the
  window (gateway-wide).
* **stalls** — 0.5 per watchdog stall observed in the window
  (`pt_watchdog_stalls_total`), floored at 0.
* **compiles** — 0.8 when capture events (`pt_compile_events_total`)
  or compile-cache `hit_failed` events moved in the window: a serving
  process past warmup should never capture, and an un-prewarmed deploy
  capturing cold buckets under live traffic reads `degraded`.

Verdicts: score ≥ `healthy_at` (PT_FLAGS_slo_healthy_score, 0.8) →
``healthy``; ≥ `degraded_at` (PT_FLAGS_slo_degraded_score, 0.4) →
``degraded``; else ``unhealthy``. The top-level status is the worst of
the per-model/per-engine verdicts. Scores are published as
`pt_health_score{target}` gauges.
"""
import time

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability.slo import Selector, WindowedView

__all__ = ["HealthScorer", "replica_score", "verdict_of", "VERDICTS",
           "router_pair_factor"]

VERDICTS = ("healthy", "degraded", "unhealthy")

#: per-replica breaker-state scores
_REPLICA_SCORE = {"healthy": 1.0, "probing": 0.5, "quarantined": 0.0}


def replica_score(state):
    return _REPLICA_SCORE.get(state, 0.0)


def verdict_of(score, healthy_at, degraded_at):
    if score >= healthy_at:
        return "healthy"
    if score >= degraded_at:
        return "degraded"
    return "unhealthy"


_WORST = {v: i for i, v in enumerate(VERDICTS)}


def router_pair_factor(peer_ages_s, fresh_s=5.0):
    """The HA-pair factor of a fleet router's /healthz: an active router
    whose standby beat within `fresh_s` is "paired" (1.0); one with no
    fresh peer is "unpaired" (0.5 — serving today, one process death
    from losing the front tier)."""
    if any(a <= float(fresh_s) for a in peer_ages_s):
        return 1.0, "paired"
    return 0.5, "unpaired"


def _worse(a, b):
    return a if _WORST[a] >= _WORST[b] else b


class HealthScorer:
    """Compose pool/admission/watchdog/ledger truth into verdicts.

    `gateway` is a ServingGateway (its registry + generator map are the
    model sources); tests may instead pass `servers` (name →
    stats-dict-provider) and drive everything with a fake clock. The
    windowed signals (shed rate, stalls, compile anomalies) ride the
    shared `view` — pass the SloEngine's so one snapshot ring serves
    both consumers.
    """

    def __init__(self, gateway=None, servers=None, generators=None,
                 view=None, registry=None, clock=time.monotonic,
                 window_s=30.0, healthy_at=None, degraded_at=None):
        self._gateway = gateway
        self._servers = servers
        self._generators = generators
        self._registry = registry or obs_metrics.registry()
        self.view = view or WindowedView(self._registry, clock=clock)
        self._clock = clock
        self.window_s = float(window_s)
        self.healthy_at = float(
            _flags.get_flag("slo_healthy_score")
            if healthy_at is None else healthy_at)
        self.degraded_at = float(
            _flags.get_flag("slo_degraded_score")
            if degraded_at is None else degraded_at)
        self._g_score = self._registry.gauge(
            "pt_health_score", "composed health score per target",
            labels=("target",))

    # -- sources -------------------------------------------------------
    def _server_stats(self):
        """{model name: InferenceServer.stats() dict} for live models."""
        if self._servers is not None:
            return {n: (s() if callable(s) else s)
                    for n, s in self._servers.items()}
        out = {}
        gw = self._gateway
        if gw is None:
            return out
        from paddle_tpu_torch.serving.batcher import ServingError
        from paddle_tpu_torch.serving.registry import UnknownModelError
        for name, info in gw.registry.models().items():
            if info["active"] is None:
                continue
            try:
                rec = gw.registry.resolve(name)
                out[name] = {"stats": rec.server.stats(),
                             "queue_depth": rec.server.queue_depth,
                             "queue_capacity": rec.server.queue_capacity}
            except (UnknownModelError, ServingError):
                continue
        return out

    def _generator_stats(self):
        if self._generators is not None:
            return {n: (s() if callable(s) else s)
                    for n, s in self._generators.items()}
        gw = self._gateway
        if gw is None:
            return {}
        with gw._gen_mu:
            gens = dict(gw._generators)
        return {n: g.stats() for n, g in gens.items()}

    # -- windowed gateway-level factors --------------------------------
    def _shed_factor(self, now):
        sel_total = Selector("pt_gateway_admission_total")
        sel_admitted = Selector("pt_gateway_admission_total",
                                {"outcome": "admitted"})
        total, _ = self.view.delta(sel_total, self.window_s, now=now)
        if total <= 0:
            return 1.0, 0.0
        admitted, _ = self.view.delta(sel_admitted, self.window_s,
                                      now=now)
        shed = max(1.0 - admitted / total, 0.0)
        return max(1.0 - shed, 0.0), shed

    def _stall_factor(self, now):
        stalls, _ = self.view.delta("pt_watchdog_stalls_total",
                                    self.window_s, now=now)
        return max(1.0 - 0.5 * stalls, 0.0), int(stalls)

    def _compile_factor(self, now):
        compiles, _ = self.view.delta("pt_compile_events_total",
                                      self.window_s, now=now)
        hit_failed, _ = self.view.delta(
            ("pt_compile_cache_total", {"event": "hit_failed"}),
            self.window_s, now=now)
        anomalies = compiles + hit_failed
        return (0.8 if anomalies > 0 else 1.0), int(anomalies)

    # -- scoring -------------------------------------------------------
    def _score_model(self, name, entry, gateway_factors):
        stats = entry["stats"]
        replicas = [
            dict(r, score=replica_score(r["state"]))
            for r in stats.get("replicas", ())]
        rep_factor = (sum(r["score"] for r in replicas) / len(replicas)
                      if replicas else 1.0)
        healthy_replicas = stats.get(
            "healthy_replicas",
            sum(1 for r in replicas if r["state"] == "healthy"))
        cap = entry.get("queue_capacity") or 0
        depth = entry.get("queue_depth") or stats.get("queue_depth", 0)
        queue_factor = (max(1.0 - depth / cap, 0.0) if cap else 1.0)
        factors = {"replicas": rep_factor, "queue": queue_factor}
        factors.update(gateway_factors)
        score = 1.0
        for f in factors.values():
            score *= f
        verdict = verdict_of(score, self.healthy_at, self.degraded_at)
        if replicas and healthy_replicas == 0:
            verdict, score = "unhealthy", 0.0
        self._g_score.labels(target=f"model:{name}").set(score)
        return {"verdict": verdict, "score": round(score, 4),
                "factors": {k: round(v, 4) for k, v in factors.items()},
                "healthy_replicas": healthy_replicas,
                "queue_depth": depth, "queue_capacity": cap or None,
                "replicas": [{"index": r["index"], "state": r["state"],
                              "score": r["score"],
                              "consecutive_failures":
                                  r.get("consecutive_failures", 0)}
                             for r in replicas]}

    def _score_generator(self, name, stats, gateway_factors, now):
        depth = stats.get("queue_depth", 0)
        cap = stats.get("max_queue") or 0
        queue_factor = max(1.0 - depth / cap, 0.0) if cap else 1.0
        live = stats.get("live_slots", 0)
        progress, dt = self.view.delta(
            ("pt_generation_total", {"field": "tokens"}),
            self.window_s, now=now)
        fresh_factor = 1.0
        stalled = bool(live > 0 and dt > 0 and progress <= 0)
        if stalled:
            fresh_factor = 0.0        # live slots, zero tokens: wedged
        factors = {"queue": queue_factor, "freshness": fresh_factor}
        ladder = stats.get("ladder") or {}
        rung = int(ladder.get("rung", 0) or 0)
        if ladder:
            # degradation ladder (paged batchers): each rung above
            # normal sheds 15% of the score, floored well above the
            # degraded threshold's cliff — a parked backend is sick,
            # not dead
            factors["ladder"] = max(1.0 - 0.15 * rung, 0.2)
        factors.update(gateway_factors)
        score = 1.0
        for f in factors.values():
            score *= f
        verdict = verdict_of(score, self.healthy_at, self.degraded_at)
        self._g_score.labels(target=f"generator:{name}").set(score)
        return {"verdict": verdict, "score": round(score, 4),
                "factors": {k: round(v, 4) for k, v in factors.items()},
                "live_slots": live, "queue_depth": depth,
                "stalled": stalled, "ladder_rung": rung}

    def report(self, now=None):
        """The structured health document (GET /healthz body)."""
        now = self._clock() if now is None else now
        if self.view.snapshots == 0:
            self.view.tick(now)       # standalone scorer: self-feed
        shed_factor, shed_rate = self._shed_factor(now)
        stall_factor, stalls = self._stall_factor(now)
        compile_factor, anomalies = self._compile_factor(now)
        gateway_factors = {"shedding": shed_factor,
                           "stalls": stall_factor,
                           "compiles": compile_factor}
        models = {n: self._score_model(n, e, gateway_factors)
                  for n, e in self._server_stats().items()}
        generators = {
            n: self._score_generator(n, s, gateway_factors, now)
            for n, s in self._generator_stats().items()}
        status = "healthy"
        for doc in list(models.values()) + list(generators.values()):
            status = _worse(status, doc["verdict"])
        draining = bool(self._gateway is not None
                        and self._gateway._closing.is_set())
        if draining:
            status = "unhealthy"
        scores = ([d["score"] for d in models.values()]
                  + [d["score"] for d in generators.values()])
        overall = min(scores) if scores else 1.0
        self._g_score.labels(target="process").set(
            0.0 if draining else overall)
        return {
            "ok": status != "unhealthy",
            "status": status,
            "score": 0.0 if draining else round(overall, 4),
            "draining": draining,
            "window_s": self.window_s,
            "thresholds": {"healthy_at": self.healthy_at,
                           "degraded_at": self.degraded_at},
            "gateway": {"shed_rate": round(shed_rate, 4),
                        "watchdog_stalls": stalls,
                        "compile_anomalies": anomalies},
            "models": models,
            "generators": generators,
        }
