"""The port's SLO engine and health scorer against the JAX package's.

Each scenario runs once through `paddle_tpu.observability.{slo,health}`
and once through `paddle_tpu_torch.observability.{slo,health}`, each over
a fresh metrics registry of its own package, driven by the same counter
and histogram events on a fake clock. The results must be equal: the
windowed rates, deltas and quantiles, every burn-rate evaluation, every
fire and resolve edge, the error budget, and every health report
(verdicts, scores, factors). Then the gateway's /slo and /healthz routes
run on the port: 200 while healthy, 503 with every replica quarantined
and while draining, and the alert callback hook.
"""
import json

import numpy as np
import pytest

from paddle_tpu.observability import health as jhealth
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import slo as jslo
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.observability import health as thealth
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import slo as tslo

SIDES = {"jax": (jslo, jhealth, jmetrics), "port": (tslo, thealth, tmetrics)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _both(scenario, *args):
    """Run `scenario(side modules, ...)` on both packages; equal results
    are the contract."""
    want = scenario(*SIDES["jax"], *args)
    got = scenario(*SIDES["port"], *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# WindowedView
# ---------------------------------------------------------------------------

def _view_scenario(slo, health, metrics):
    reg = metrics.MetricsRegistry()
    clk = FakeClock()
    view = slo.WindowedView(reg, clock=clk)
    out = []
    c = reg.counter("pt_x_total")
    c.inc(1000)                               # before the first tick
    req = reg.counter("pt_req_total", labels=("outcome",))
    h = reg.histogram("pt_lat_s")
    for _ in range(100):
        h.record(0.001)
    view.tick()
    rng = np.random.RandomState(0)
    for step in range(30):
        clk.advance(1.0)
        c.inc(5)
        req.labels(outcome="completed").inc(int(rng.randint(0, 9)))
        req.labels(outcome="failed").inc(int(rng.randint(0, 3)))
        req.labels(outcome="rejected").inc(int(rng.randint(0, 20)))
        for v in rng.lognormal(-3, 1.0, size=20):
            h.record(float(v))
        view.tick()
        sel = slo.Selector("pt_req_total",
                           {"outcome": ("completed", "failed")})
        out.append((view.rate("pt_x_total", 4.0),
                    view.delta("pt_x_total", 60.0),
                    view.delta(sel, 10.0), view.delta("pt_req_total", 5.0),
                    round(view.quantile("pt_lat_s", 0.5, 5.0), 12),
                    view.fraction_over("pt_lat_s", 0.1, 10.0),
                    view.rate("pt_nope_total", 5.0)))
    view.horizon_s = 10.0
    for _ in range(20):
        clk.advance(1.0)
        view.tick()
    out.append(view.snapshots)
    return out


def test_windowed_view_matches_jax():
    got = _view_scenario(*SIDES["port"])
    assert got == _view_scenario(*SIDES["jax"])
    assert got[0][0] == pytest.approx(5.0) and got[-1] <= 11


# ---------------------------------------------------------------------------
# burn-rate engine
# ---------------------------------------------------------------------------

def _burn_scenario(slo, health, metrics, seed):
    """Availability (page + ticket rules), latency and freshness specs
    over one seeded traffic pattern with outages; every evaluation and
    every alert edge."""
    reg = metrics.MetricsRegistry()
    clk = FakeClock()
    view = slo.WindowedView(reg, clock=clk)
    c = reg.counter("pt_req_total", labels=("outcome",))
    lat = reg.histogram("pt_lat_s")
    tokens = reg.counter("pt_gen_total", labels=("field",))
    live = reg.gauge("pt_gen_live")
    fast = slo.BurnRule(long_s=10.0, short_s=2.0, burn=8.0,
                        severity="page")
    slow = slo.BurnRule(long_s=60.0, short_s=15.0, burn=2.0,
                        severity="ticket")
    specs = [
        slo.SloSpec("avail", "availability", 0.99,
                    good=("pt_req_total", {"outcome": "ok"}),
                    total=("pt_req_total", {"outcome": ("ok", "err")}),
                    rules=[fast, slow], min_events=4,
                    budget_window_s=60.0),
        slo.SloSpec("lat", "latency", 0.95, histogram="pt_lat_s",
                    threshold_s=0.1, min_events=4, rules=[fast]),
        slo.SloSpec("fresh", "freshness", 0.99,
                    progress=("pt_gen_total", {"field": "tokens"}),
                    active="pt_gen_live",
                    rules=(slo.BurnRule(long_s=10.0, short_s=2.0, burn=1.0,
                                        severity="page"),)),
    ]
    eng = slo.SloEngine(specs, registry=reg, view=view, clock=clk,
                        eval_interval_s=0)
    events = []
    eng.on_alert(events.append)
    rng = np.random.RandomState(seed)
    evals = []
    for step in range(160):
        clk.advance(1.0)
        outage = 40 <= step < 55 or 100 <= step < 103
        c.labels(outcome="ok").inc(0 if outage else 10)
        c.labels(outcome="err").inc(10 if outage else
                                    int(rng.rand() < 0.05))
        for _ in range(10):
            lat.record(float(rng.lognormal(-4 if step < 120 else -1, 0.5)))
        live.set(2 if 70 <= step < 95 else 0)
        if not 80 <= step < 92:
            tokens.labels(field="tokens").inc(5)
        res = eng.evaluate()
        evals.append({name: (round(r["error_budget_remaining"], 9),
                             {k: (round(w["burn_long"], 9),
                                  round(w["burn_short"], 9), w["threshold"])
                              for k, w in r["windows"].items()})
                      for name, r in res.items()})
    fam = reg.families()["pt_slo_alerts_total"]
    alerts = sorted((k, ch.value) for k, ch in fam.children().items())
    snap = eng.snapshot(evaluate=False)
    json.dumps(snap)
    return (evals, [{k: (round(v, 9) if isinstance(v, float) else v)
                     for k, v in e.items()} for e in events], alerts,
            eng.firing(), [e["event"] for e in eng.alert_log()],
            sorted(snap["slos"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_burn_rates_and_alert_edges_match_jax(seed):
    evals, events, alerts, firing, log, slos = _both(_burn_scenario, seed)
    kinds = {(e["slo"], e["event"]) for e in events}
    assert {("avail", "fire"), ("avail", "resolve"), ("lat", "fire"),
            ("fresh", "fire"), ("fresh", "resolve")} <= kinds
    assert slos == ["avail", "fresh", "lat"]


def _spec_scenario(slo, health, metrics):
    out = [s.to_dict() for s in slo.default_serving_specs()]
    for bad in (lambda: slo.SloSpec("x", "availability", 0.99),
                lambda: slo.SloSpec("x", "latency", 1.5, histogram="h",
                                    threshold_s=1.0),
                lambda: slo.BurnRule(long_s=1.0, short_s=2.0, burn=1.0)):
        with pytest.raises(Exception) as ei:
            bad()
        out.append(type(ei.value).__name__)
    eng = slo.SloEngine(registry=metrics.MetricsRegistry(),
                        eval_interval_s=0)
    eng.add_spec(slo.SloSpec("a", "latency", 0.9, histogram="h",
                             threshold_s=1.0))
    with pytest.raises(Exception):
        eng.add_spec(slo.SloSpec("a", "latency", 0.9, histogram="h",
                                 threshold_s=1.0))
    return out


def test_default_specs_and_validation_match_jax():
    got = _both(_spec_scenario)
    assert [d["name"] for d in got[:3]] == [
        "serving-availability", "wire-latency", "generation-freshness"]


def test_slo_flags_are_read():
    reg = tflags._REGISTRY
    for name in ("slo_eval_interval_s", "slo_availability_objective",
                 "slo_latency_objective", "slo_wire_p99_threshold_s",
                 "slo_healthy_score", "slo_degraded_score",
                 "trace_sample_every"):
        assert reg[name].unread is None, name
    tflags.set_flag("slo_availability_objective", 0.95)
    try:
        spec = tslo.default_serving_specs()[0]
        assert spec.objective == pytest.approx(0.95)
    finally:
        tflags.set_flag("slo_availability_objective", 0.999)


# ---------------------------------------------------------------------------
# health scoring
# ---------------------------------------------------------------------------

def _model_entry(states, depth=0, cap=100):
    return {"stats": {
        "replicas": [{"index": i, "state": s, "consecutive_failures": 0}
                     for i, s in enumerate(states)],
        "healthy_replicas": sum(1 for s in states if s == "healthy")},
        "queue_depth": depth, "queue_capacity": cap}


def _health_scenario(slo, health, metrics):
    reg = metrics.MetricsRegistry()
    clk = FakeClock()
    view = slo.WindowedView(reg, clock=clk)
    box = {"m": _model_entry(["healthy", "healthy"])}
    gen_stats = {"queue_depth": 0, "max_queue": 16, "live_slots": 2}
    hs = health.HealthScorer(servers={"m": lambda: box["m"]},
                             generators={"g": lambda: gen_stats},
                             view=view, registry=reg, clock=clk)
    adm = reg.counter("pt_gateway_admission_total",
                      labels=("tenant", "outcome"))
    tokens = reg.counter("pt_generation_total", labels=("field",))
    reports = []
    view.tick()
    clk.advance(1.0)
    tokens.labels(field="tokens").inc(100)
    reports.append(hs.report())
    for states, depth in ((["healthy", "quarantined"], 0),
                          (["healthy", "probing"], 10),
                          (["quarantined", "quarantined"], 0),
                          (["healthy", "healthy"], 90)):
        box["m"] = _model_entry(states, depth=depth)
        reports.append(hs.report())
    view.tick()
    clk.advance(1.0)
    adm.labels(tenant="t", outcome="admitted").inc(50)
    adm.labels(tenant="t", outcome="rejected_quota").inc(50)
    reg.counter("pt_watchdog_stalls_total").inc()
    reg.counter("pt_compile_events_total", labels=("component",)).labels(
        component="serving").inc(2)
    box["m"] = _model_entry(["healthy", "healthy"])
    reports.append(hs.report())
    view.tick()
    clk.advance(hs.window_s + 1.0)
    reports.append(hs.report())
    fam = reg.families()["pt_health_score"]
    gauges = sorted((k, round(ch.value, 9))
                    for k, ch in fam.children().items())
    verdicts = [health.verdict_of(s, 0.8, 0.4) for s in (0.9, 0.5, 0.1)]
    return reports, gauges, verdicts, [
        health.replica_score(s) for s in ("healthy", "probing", "x")]


def test_health_reports_match_jax():
    reports, gauges, verdicts, scores = _both(_health_scenario)
    seen = [r["models"]["m"]["verdict"] for r in reports]
    assert seen[:5] == ["healthy", "degraded", "degraded", "unhealthy",
                        "unhealthy"]
    assert reports[0]["generators"]["g"]["verdict"] == "healthy"
    assert reports[-1]["generators"]["g"]["stalled"]
    assert reports[5]["gateway"]["shed_rate"] == pytest.approx(0.5)
    assert reports[5]["models"]["m"]["factors"]["compiles"] == 0.8
    assert verdicts == ["healthy", "degraded", "unhealthy"]


# ---------------------------------------------------------------------------
# gateway surfaces on the port
# ---------------------------------------------------------------------------

class Fake:
    def get_input_names(self):
        return ["x"]

    def clone(self):
        return Fake()

    def run(self, feed=None):
        return [np.asarray(feed["x"]) * 2.0]


def test_slo_and_healthz_routes_and_alert_hook():
    from paddle_tpu_torch.reliability.faults import fault_plan
    from paddle_tpu_torch.serving import ServingGateway, wire
    gw = ServingGateway(device="cpu", max_queue=64,
                        breaker_cooldown_ms=60000.0)
    try:
        gw.registry.deploy("m", "v1", Fake(),
                           prewarm_feed={"x": np.ones((1, 2), np.float32)})
        host, port = gw.start()
        c = wire.GatewayClient(host, port)
        for _ in range(8):
            c.infer("m", {"x": np.ones((1, 2), np.float32)})
        c.close()
        st, doc, _ = wire.http_request(host, port, "GET", "/slo")
        assert st == 200 and doc["firing"] == []
        assert doc["slos"]["serving-availability"][
            "error_budget_remaining"] == pytest.approx(1.0)
        st, doc, _ = wire.http_request(host, port, "GET", "/healthz")
        assert st == 200 and doc["status"] == "healthy"
        st, body, _ = wire.http_request(host, port, "GET", "/metrics")
        assert "pt_slo_error_budget_remaining" in body
        assert "pt_health_score" in body
        events = []
        gw.slo.on_alert(events.append)
        gw.slo._emit({"event": "fire", "slo": "x", "severity": "page",
                      "rule": "r", "t": 0.0, "burn_long": 9.0,
                      "burn_short": 9.0, "threshold": 1.0})
        assert events and events[0]["slo"] == "x"
        srv = gw.registry.resolve("m").server
        with fault_plan("serving.run_batch@*:raise(down)"):
            for _ in range(4):
                with pytest.raises(Exception):
                    srv.infer({"x": np.ones((1, 2), np.float32)},
                              timeout_ms=200)
        st, doc, _ = wire.http_request(host, port, "GET", "/healthz")
        assert st == 503 and doc["status"] == "unhealthy"
        assert doc["models"]["m"]["healthy_replicas"] == 0
    finally:
        gw.shutdown()
    doc = gw.health.report()
    assert doc["draining"] and not doc["ok"]
