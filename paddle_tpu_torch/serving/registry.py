"""Multi-model registry with atomic version cutover.

Counterpart of paddle_tpu/serving/registry.py: name → version → a live
`InferenceServer` over that version's predictor. The gateway routes
every request through `resolve()`, which returns the ACTIVE version's
server — a single dict read under a lock, so cutover is one pointer
swap, never a partially-updated route table.

Deploying a new version is a guarded state machine::

    load ──▶ verify ──▶ prewarm ──▶ commit(atomic) ──▶ drain old
              │            │           │
              └────────────┴───────────┴──▶ ROLLBACK: shut the new
                   server down, keep the old version active, raise
                   SwapError — a failed swap never takes traffic.

* **verify** happens inside `InferenceServer.__init__` (the verifier,
  the lints and the planner's fit gate over the new Program) and in the
  optional quality gate (`analysis.numerics.quant_parity_check` against
  a float reference); ERROR findings abort before the version exists
  anywhere a router could see.
* **prewarm** captures the full bucket ladder via `warmup()` so the
  first post-swap request never pays a capture. On the card a capture
  holds the process's capture gate (observability/profile.py) while the
  old version's replays wait: `entry["prewarm_s"]` is that pause.
* **commit** swaps the active-version pointer under the registry lock.
  Requests already submitted to the OLD server finish there.
* **drain** retires the old server through `shutdown(drain=True,
  timeout=...)` and records the drain report in the version record and
  swap history.

Every stage boundary is a `gateway.swap` chaos choke point (tag = the
stage name), so a seeded fault plan can kill a swap at any stage and
the rollback contract is tested deterministically.
"""
import logging
import time

from paddle_tpu_torch.analysis.concurrency import guarded_by, make_lock
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.reliability.faults import inject_point
from paddle_tpu_torch.serving.batcher import ServingError
from paddle_tpu_torch.serving.pool import InferenceServer

logger = logging.getLogger("paddle_tpu_torch.serving.gateway")

__all__ = ["ModelRegistry", "SwapError", "UnknownModelError"]


class UnknownModelError(ServingError):
    """No such model name / version in the registry (wire 404)."""


class SwapError(ServingError):
    """A version cutover failed and was rolled back; the previously
    active version is still serving. `.stage` names where it died."""

    def __init__(self, message, stage):
        super().__init__(message)
        self.stage = stage


class _VersionRecord:
    __slots__ = ("name", "version", "server", "state", "deployed_at",
                 "drain_report", "prewarmed_buckets", "tier")

    def __init__(self, name, version, server, deployed_at, tier=None):
        self.name = name
        self.version = str(version)
        self.server = server
        self.state = "loading"      # loading|active|retired|failed
        self.deployed_at = deployed_at
        self.drain_report = None
        self.prewarmed_buckets = None
        self.tier = tier            # e.g. "fp32" | "int8" (quantized)

    def to_dict(self):
        return {"version": self.version, "state": self.state,
                "deployed_at": self.deployed_at,
                "prewarmed_buckets": self.prewarmed_buckets,
                "drain_report": self.drain_report,
                "tier": self.tier}


class ModelRegistry:
    """name → version → server, with one-pointer-swap cutover.

    `server_kwargs` are the default InferenceServer knobs every deploy
    inherits (replicas, bucket ladder, queue bound...); a per-deploy
    override dict merges over them.
    """

    def __init__(self, server_factory=InferenceServer,
                 drain_timeout_s=30.0, clock=time.monotonic,
                 **server_kwargs):
        self._factory = server_factory
        self._drain_timeout = drain_timeout_s
        self._clock = clock
        self._server_kwargs = dict(server_kwargs)
        self._mu = make_lock("serving.registry.route")  # guards the route table
        self._swap_mu = make_lock("serving.registry.swap")  # one cutover at a time
        self._models = {}   # guarded_by(_mu) name -> {version: record}
        self._active = {}   # guarded_by(_mu) name -> version
        guarded_by(self, "_models", "serving.registry.route")
        guarded_by(self, "_active", "serving.registry.route")
        self._history = []                # swap/deploy audit log

    # -- routing (hot path) --------------------------------------------
    def resolve(self, name, version=None):
        """The server to route a request to: the ACTIVE version (or an
        explicitly pinned live version). One lock, two dict reads."""
        with self._mu:
            versions = self._models.get(name)
            if not versions:
                raise UnknownModelError(f"unknown model {name!r} "
                                        f"(have {sorted(self._models)})")
            v = self._active.get(name) if version is None else str(version)
            rec = versions.get(v) if v is not None else None
            if rec is None or rec.state not in ("active", "retiring"):
                raise UnknownModelError(
                    f"model {name!r} has no live version "
                    f"{v!r} (active={self._active.get(name)!r})")
            return rec

    def active_version(self, name):
        with self._mu:
            return self._active.get(name)

    def models(self):
        with self._mu:
            return {n: {"active": self._active.get(n),
                        "versions": {v: r.to_dict()
                                     for v, r in vs.items()}}
                    for n, vs in self._models.items()}

    @staticmethod
    def _run_quality_gate(predictor, gate):
        """Parity-vs-fp32-oracle check for quantized deploys. Raises
        AnalysisError carrying the quant-quality-regression ERROR when
        the candidate's outputs diverge beyond the threshold; returns
        the measured relative error otherwise."""
        from paddle_tpu_torch.analysis.diagnostic import Severity
        from paddle_tpu_torch.analysis.framework import AnalysisError
        from paddle_tpu_torch.analysis.numerics import quant_parity_check
        feed = gate.get("feed")
        enforce(feed is not None, "quality_gate needs a 'feed'")
        reference = gate.get("reference")
        enforce(reference is not None,
                "quality_gate needs a 'reference' (fp32 oracle outputs "
                "or a predictor-like with .run)")
        if hasattr(reference, "run"):
            reference = reference.run(feed=dict(feed))
        outputs = predictor.run(feed=dict(feed))
        rel, diag = quant_parity_check(
            outputs, reference,
            threshold=float(gate.get("threshold", 0.05)))
        if diag is not None:
            raise AnalysisError([diag], Severity.ERROR,
                                label="quality_gate")
        return rel

    # -- cutover -------------------------------------------------------
    def deploy(self, name, version, predictor, prewarm_feed=None,
               server_kwargs=None, drain_timeout_s=None,
               hbm_budget_bytes=None, quality_gate=None, tier=None):
        """Deploy `predictor` as `name`:`version` and atomically make it
        the active version. Returns the swap audit record. On any
        failure before commit the new server is torn down, the old
        version keeps serving, and SwapError is raised.

        `hbm_budget_bytes` arms the static fit gate: the planner's
        peak-memory estimate for the largest bucket must fit, or the
        deploy dies at stage "verify" with a model-does-not-fit
        Diagnostic (analysis/planner.py) and the previous version keeps
        serving — "will this model fit?" is answered before any capture
        or route-table change.

        `tier` labels the deployed precision ("fp32", "int8", ...) in
        the version record and the swap audit entry — the registry's
        model listing is how operators see which precision serves.

        `quality_gate` arms the quantization parity gate at the same
        stage-"verify" choke point: {"feed": {...}, "reference":
        [arrays] | predictor-like with .run, "threshold": 0.05}. The
        candidate runs the gate feed, `analysis.numerics.
        quant_parity_check` compares against the fp32 oracle, and a
        mean relative error beyond the threshold raises the ERROR
        `quant-quality-regression` Diagnostic — pre-commit, so the
        rollback contract above holds and the quality-regressing
        quantized model never takes traffic."""
        version = str(version)
        kwargs = dict(self._server_kwargs)
        kwargs.update(server_kwargs or {})
        if hbm_budget_bytes is not None:
            kwargs["hbm_budget_bytes"] = hbm_budget_bytes
        with self._swap_mu:
            with self._mu:
                exists = (name in self._models
                          and version in self._models[name])
            enforce(not exists, "model %s version %s already deployed",
                    name, version)
            entry = {"model": name, "version": version, "ok": False,
                     "stage": "load", "started_at": self._clock()}
            if tier is not None:
                entry["tier"] = str(tier)
            new = None
            try:
                inject_point("gateway.swap", tag="load")
                # verify: InferenceServer startup runs the analysis
                # pipeline over the Program; ERROR findings raise here,
                # before the version is visible anywhere
                entry["stage"] = "verify"
                new = self._factory(predictor, **kwargs)
                if quality_gate is not None:
                    entry["quality_rel_err"] = self._run_quality_gate(
                        predictor, quality_gate)
                inject_point("gateway.swap", tag="verify")
                entry["stage"] = "prewarm"
                rec = _VersionRecord(name, version, new, self._clock(),
                                     tier=tier)
                if prewarm_feed is not None:
                    t0 = self._clock()
                    rec.prewarmed_buckets = new.warmup(prewarm_feed)
                    # prewarm is the cutover's dominant cost: every
                    # bucket is captured here (from the compile cache's
                    # manifest when one is armed), and on the card the
                    # old version's replays wait at the capture gate
                    entry["prewarm_s"] = self._clock() - t0
                    ws = new.stats().get("warm_start")
                    if ws is not None:
                        entry["warm_start"] = dict(ws)
                inject_point("gateway.swap", tag="prewarm")
                entry["stage"] = "commit"
                inject_point("gateway.swap", tag="commit")
            except Exception as e:
                if new is not None:
                    # the aborted server never took traffic: nothing to
                    # drain, tear it down hard
                    new.shutdown(drain=False, timeout=self._drain_timeout)
                entry["error"] = f"{type(e).__name__}: {e}"
                entry["rolled_back"] = True
                self._history.append(entry)
                logger.warning("swap %s:%s rolled back at %s: %s",
                               name, version, entry["stage"], e)
                raise SwapError(
                    f"deploy {name}:{version} failed at stage "
                    f"{entry['stage']!r} ({e}); previous version "
                    f"{self.active_version(name)!r} still active",
                    entry["stage"]) from e

            # -- the atomic cutover: one pointer swap under the lock --
            with self._mu:
                old_version = self._active.get(name)
                old = (self._models[name].get(old_version)
                       if name in self._models else None)
                rec.state = "active"
                self._models.setdefault(name, {})[version] = rec
                self._active[name] = version
                if old is not None:
                    old.state = "retiring"
            entry["replaced"] = old_version
            entry["ok"] = True

            # -- drain the retired version (post-commit: a failure here
            # cannot un-commit the swap, only leave a report) --
            if old is not None:
                entry["stage"] = "drain"
                try:
                    inject_point("gateway.swap", tag="drain")
                    old.drain_report = old.server.shutdown(
                        drain=True,
                        timeout=(self._drain_timeout
                                 if drain_timeout_s is None
                                 else drain_timeout_s))
                    entry["drain_report"] = dict(old.drain_report)
                except Exception as e:
                    entry["drain_error"] = f"{type(e).__name__}: {e}"
                    logger.warning("drain of %s:%s failed after a "
                                   "committed swap: %s",
                                   name, old_version, e)
                old.state = "retired"
            entry["stage"] = "done"
            entry["finished_at"] = self._clock()
            self._history.append(entry)
            logger.info("model %s cut over %r -> %r", name,
                        old_version, version)
            return entry

    # -- lifecycle -----------------------------------------------------
    def drain_all(self, timeout_s=None):
        """Shut every live server down (drain=True) and return
        {model: {version: drain report}} — the gateway's final drain
        response rides on this, surfacing every server's
        {undrained_requests, stuck_workers} to the supervisor."""
        timeout = self._drain_timeout if timeout_s is None else timeout_s
        reports = {}
        with self._mu:
            live = [(n, r) for n, vs in self._models.items()
                    for r in vs.values()
                    if r.state in ("active", "retiring")]
        for name, rec in live:
            rec.drain_report = rec.server.shutdown(drain=True,
                                                   timeout=timeout)
            rec.state = "retired"
            reports.setdefault(name, {})[rec.version] = dict(
                rec.drain_report)
        return reports

    def stats(self):
        return {"models": self.models(),
                "swap_history": [dict(e) for e in self._history]}
