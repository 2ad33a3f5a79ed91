"""The port's serving gateway against the JAX package's (CPU).

* The PTGW wire and the HTTP surface cross both ways: the JAX
  `GatewayClient` against the port's `ServingGateway` and the port's
  client against the JAX gateway, each serving the same tiny inference
  model saved once; outputs within tests/test_torch_inference.py's
  float32 tolerance (1e-4 / 1e-5). The codec's bytes are the JAX
  package's for the same header and tensors.
* Admission takes the JAX controller's decisions, with the same
  statuses, reasons and Retry-After values, over one seeded sequence of
  admits, releases and latency observations on a fake clock.
* The registry's swap, rollback at every pre-commit stage, fit gate and
  quality gate end in the JAX registry's states and audit entries.
* Streaming generation: four concurrent PTGW streams and one chunked
  HTTP stream of the port's GenerationServer (int8 paged engine) give
  the in-process server's tokens; the JAX client reads the port's
  stream too.
* The JAX package's own gateway cases run on the port: framing,
  admission, preemption, the wire and HTTP routes, quota and deadline
  rejections, slow clients, fault storms, hot swap under load, drain
  reports.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest

from paddle_tpu import inference as jinf
from paddle_tpu.serving import admission as jadm
from paddle_tpu.serving import wire as jwire
from paddle_tpu.serving import ServingGateway as JGateway
from paddle_tpu.serving import GatewayClient as JClient
from paddle_tpu.serving.registry import ModelRegistry as JRegistry
from paddle_tpu.serving.registry import SwapError as JSwapError
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.reliability.faults import fault_plan
from paddle_tpu_torch.serving import (
    AdmissionController, GatewayClient, GatewayError, InferenceServer,
    Preempted, QueueFullError, ServingGateway, TenantQuota, TokenBucket,
)
from paddle_tpu_torch.serving import admission as tadm
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.registry import (
    ModelRegistry, SwapError, UnknownModelError,
)

from test_torch_serving import mlp_dir, _port_predictor  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


class Fake:
    """Row-wise predictor: out = x * scale."""

    def __init__(self, scale=2.0):
        self.scale = scale

    def get_input_names(self):
        return ["x"]

    def clone(self):
        return Fake(self.scale)

    def run(self, feed=None):
        return [np.asarray(feed["x"]) * self.scale]


class GatedFake(Fake):
    def __init__(self, gate, scale=2.0):
        super().__init__(scale)
        self.gate = gate

    def clone(self):
        return GatedFake(self.gate, self.scale)

    def run(self, feed=None):
        assert self.gate.wait(10.0), "test gate never released"
        return super().run(feed=feed)


def _x(rows=1, value=1.0):
    return np.full((rows, 2), value, np.float32)


def _gateway(predictor=None, **kw):
    kw.setdefault("read_timeout_s", 5.0)
    kw.setdefault("write_timeout_s", 5.0)
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("max_queue", 128)
    gw = ServingGateway(device="cpu", **kw)
    if predictor is not None:
        gw.registry.deploy("m", "v1", predictor)
    return gw


# ---------------------------------------------------------------------
# wire framing + codec
# ---------------------------------------------------------------------

def test_frames_roundtrip_eof_hostile_and_torn():
    a, b = socket.socketpair()
    try:
        wire.send_frame(a, b"hello")
        wire.send_frame(a, b"")
        assert wire.recv_frame(b) == b"hello"
        assert wire.recv_frame(b) == b""
        a.close()
        assert wire.recv_frame(b) is None
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall((1 << 30).to_bytes(4, "little"))
        with pytest.raises(wire.WireError, match="bound"):
            wire.recv_frame(b, max_bytes=1 << 20)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall((100).to_bytes(4, "little") + b"short")
        a.close()
        with pytest.raises(wire.WireError, match="closed"):
            wire.recv_frame(b)
    finally:
        b.close()


_TENSORS = [np.arange(6, dtype=np.float32).reshape(2, 3),
            np.array([[1, 2]], dtype=np.int64),
            np.zeros((0, 4), dtype=np.float32),
            np.arange(4, dtype=np.uint8), np.array([True, False]),
            np.linspace(0, 1, 5).astype(np.float64)]


def test_codec_bytes_are_the_jax_codecs():
    header = {"op": "infer", "model": "m", "inputs": list("abcdef"),
              "trace": {"trace_id": "00000000000000ab",
                        "span_id": "00000000000000cd"}}
    payload = wire.encode_payload(header, _TENSORS)
    assert payload == jwire.encode_payload(header, _TENSORS)
    for decode in (wire.decode_payload, jwire.decode_payload):
        out_header, out = decode(payload)
        assert out_header["op"] == "infer"
        for orig, got in zip(_TENSORS, out):
            assert got.dtype == orig.dtype and got.shape == orig.shape
            np.testing.assert_array_equal(got, orig)
    assert wire.peek_header(payload) == jwire.peek_header(payload)
    doc = {"a": 1}
    assert wire.http_chunk(doc) == jwire.http_chunk(doc)
    assert wire.http_response(429, doc, (("Retry-After", "1.000"),)) == \
        jwire.http_response(429, doc, (("Retry-After", "1.000"),))
    assert wire.token_frame(3, 7, 1) == jwire.token_frame(3, 7, 1)
    assert wire.MAGIC == jwire.MAGIC and \
        wire.MAX_FRAME_BYTES == jwire.MAX_FRAME_BYTES


def test_codec_rejects_garbage():
    with pytest.raises(wire.WireError):
        wire.decode_payload(b"\x01")
    good = wire.encode_payload({"op": "x"}, [np.zeros(4, np.float32)])
    with pytest.raises(wire.WireError, match="trailing"):
        wire.decode_payload(good + b"extra")
    with pytest.raises(wire.WireError, match="overrun"):
        wire.decode_payload(good[:-4])


# ---------------------------------------------------------------------
# admission control (fake clock, threadless)
# ---------------------------------------------------------------------

def _admission_trace(mod, seed, n=200):
    """One seeded sequence of admits / releases / observations / clock
    steps through `mod`'s controller; every decision's fields."""
    rng = np.random.RandomState(seed)
    now = [0.0]
    ctl = mod.AdmissionController(
        max_in_flight=6, queue_capacity=10, pressure_watermark=0.5,
        pressure_priority=1, clock=lambda: now[0])
    ctl.configure("metered", mod.TenantQuota(rate=4.0, burst=2))
    ctl.configure("vip", mod.TenantQuota(rate=50.0, burst=8, priority=2,
                                         max_in_flight=3))
    ctl.configure("capped", mod.TenantQuota(max_in_flight=1))
    tenants = ("metered", "vip", "capped", "anon")
    held, out = [], []
    for _ in range(n):
        now[0] += float(rng.exponential(0.01))
        op = rng.rand()
        if op < 0.6:
            t = tenants[rng.randint(4)]
            deadline = now[0] + float(rng.uniform(0.01, 0.5)) \
                if rng.rand() < 0.4 else None
            prio = int(rng.randint(0, 3)) if rng.rand() < 0.3 else None
            d = ctl.admit(t, rows=int(rng.randint(1, 3)), priority=prio,
                          deadline_s=deadline,
                          queue_depth=int(rng.randint(0, 12)))
            out.append((t, d.ok, d.status, d.reason, d.priority,
                        None if d.retry_after_s is None
                        else round(d.retry_after_s, 12)))
            if d:
                held.append(t)
        elif op < 0.85 and held:
            ctl.release(held.pop(int(rng.randint(len(held)))))
        else:
            ctl.observe(float(rng.uniform(0.005, 0.2)))
    st = ctl.stats()
    return out, {t: {k: v for k, v in c.items() if k != "tokens"}
                 for t, c in st["tenants"].items()}, st["total_in_flight"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_takes_the_jax_decisions(seed):
    want = _admission_trace(jadm, seed)
    got = _admission_trace(tadm, seed)
    assert got == want
    statuses = {d[2] for d in got[0]}
    assert {200, 429, 503} <= statuses


def test_token_bucket_refill_fake_clock():
    now = [0.0]
    tb = TokenBucket(rate=10.0, burst=5, clock=lambda: now[0])
    for _ in range(5):
        assert tb.try_take(1) == 0.0
    assert tb.try_take(1) == pytest.approx(0.1)
    now[0] = 0.05
    assert tb.try_take(1) == pytest.approx(0.05)
    now[0] = 0.1
    assert tb.try_take(1) == 0.0
    now[0] = 100.0
    assert tb.level() == pytest.approx(5.0)


def test_admission_quota_deadline_priority_and_in_flight():
    now = [0.0]
    ctl = AdmissionController(clock=lambda: now[0])
    ctl.configure("t", TenantQuota(rate=1.0, burst=2))
    assert ctl.admit("t") and ctl.admit("t")
    d = ctl.admit("t")
    assert not d and d.status == 429
    assert d.retry_after_s == pytest.approx(1.0)
    ctl2 = AdmissionController(clock=lambda: 0.0)
    assert ctl2.admit("t", deadline_s=0.001, queue_depth=100)
    ctl2.observe(0.5)
    d = ctl2.admit("t", deadline_s=0.1, queue_depth=3)
    assert not d and d.status == 503 and "deadline" in d.reason
    assert d.retry_after_s == pytest.approx(2.0)
    ctl3 = AdmissionController(clock=lambda: 0.0, queue_capacity=10,
                               pressure_watermark=0.5, pressure_priority=1)
    ctl3.configure("lo", TenantQuota(rate=100.0, burst=10, priority=0))
    ctl3.configure("hi", TenantQuota(rate=100.0, burst=10, priority=1))
    d = ctl3.admit("lo", rows=4, queue_depth=6)
    assert not d and "priority" in d.reason
    assert ctl3.stats()["tenants"]["lo"]["tokens"] == pytest.approx(10.0)
    assert ctl3.admit("hi", rows=4, queue_depth=6)
    ctl4 = AdmissionController(max_in_flight=2, clock=lambda: 0.0)
    ctl4.configure("t", TenantQuota(max_in_flight=1))
    assert ctl4.admit("t")
    assert not ctl4.admit("t")
    assert ctl4.admit("u")
    assert not ctl4.admit("v")
    ctl4.release("t")
    assert ctl4.admit("v")


def test_priority_preemption_under_full_queue():
    gate = threading.Event()
    srv = InferenceServer(GatedFake(gate), num_replicas=1, buckets=[1],
                          max_wait_ms=0.0, max_queue=2)
    try:
        occupier = srv.submit({"x": _x()})
        deadline = time.monotonic() + 5.0
        while srv.queue_depth > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        lo1 = srv.submit({"x": _x(value=10.0)}, priority=0)
        lo2 = srv.submit({"x": _x(value=20.0)}, priority=0)
        with pytest.raises(QueueFullError):
            srv.submit({"x": _x(value=30.0)}, priority=1)
        assert srv.try_preempt(1)
        hi = srv.submit({"x": _x(value=30.0)}, priority=1)
        with pytest.raises(Preempted):
            lo2.result(timeout=1.0)
        assert not srv.try_preempt(0)
        gate.set()
        for r, v in ((occupier, 1.0), (lo1, 10.0), (hi, 30.0)):
            np.testing.assert_array_equal(r.result(timeout=5.0)[0],
                                          _x(value=v) * 2.0)
        assert srv.stats()["requests"]["rejected"] == 2
        assert srv.stats()["requests"]["failed"] == 0
    finally:
        gate.set()
        srv.shutdown(timeout=5.0)


# ---------------------------------------------------------------------
# the gateway's wire and HTTP surface
# ---------------------------------------------------------------------

def test_gateway_needs_a_device_when_none_is_named():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingGateway()


def test_wire_roundtrip_unknown_model_and_http_routes():
    with _gateway(Fake()) as gw:
        host, port = gw.start()
        with GatewayClient(host, port, tenant="t") as c:
            for v in (1.0, 2.0, 3.0):
                outs, resp = c.infer("m", {"x": _x(rows=2, value=v)})
                np.testing.assert_array_equal(outs[0],
                                              _x(rows=2, value=v) * 2.0)
                assert resp["version"] == "v1" and resp["tenant"] == "t"
            with pytest.raises(GatewayError) as ei:
                c.infer("nope", {"x": _x()})
            assert ei.value.status == 404
            assert c.ping()["status"] == 200
            assert c.stats()["counters"]["wire_frames"] >= 4
        st, doc, _ = wire.http_request(host, port, "GET", "/healthz")
        assert st == 200 and doc["ok"] and doc["status"] == "healthy"
        assert doc["models_active"] == {"m": "v1"}
        st, doc, _ = wire.http_request(host, port, "GET", "/models")
        assert st == 200 and doc["m"]["active"] == "v1"
        st, doc, _ = wire.http_request(
            host, port, "POST", "/v1/models/m:infer",
            {"inputs": {"x": [[1.0, 2.0]]}})
        assert st == 200 and doc["outputs"][0] == [[2.0, 4.0]]
        st, _, _ = wire.http_request(host, port, "POST",
                                     "/v1/models/ghost:infer",
                                     {"inputs": {"x": [[1.0]]}})
        assert st == 404
        st, _, _ = wire.http_request(host, port, "GET", "/no/route")
        assert st == 404
        st, doc, _ = wire.http_request(host, port, "GET", "/slo")
        assert st == 200 and {s["name"] for s in doc["specs"]} == {
            "serving-availability", "wire-latency", "generation-freshness"}
        st, doc, _ = wire.http_request(host, port, "GET", "/profile")
        assert st == 200 and "capture_gate" in doc and "plan_check" in doc
        st, text, _ = wire.http_request(host, port, "GET", "/metrics")
        assert st == 200 and "pt_serving_requests_total" in text
        st, doc, _ = wire.http_request(host, port, "GET", "/stats")
        assert st == 200 and doc["counters"]["http_requests"] >= 6
        json.dumps(doc)


def test_quota_429_deadline_shed_and_slow_client():
    with _gateway(Fake(), read_timeout_s=0.2) as gw:
        gw.admission.configure("metered",
                               TenantQuota(rate=0.001, burst=1))
        host, port = gw.start()
        with GatewayClient(host, port, tenant="metered") as c:
            c.infer("m", {"x": _x()})
            with pytest.raises(GatewayError) as ei:
                c.infer("m", {"x": _x()})
            assert ei.value.status == 429 and ei.value.retry_after_s > 0
        slow = socket.create_connection((host, port), timeout=5.0)
        slow.sendall(wire.MAGIC + b"\x08\x00")
        gw.admission.observe(5.0)
        srv = gw.registry.resolve("m").server
        before = srv.stats()["requests"]["submitted"]
        with GatewayClient(host, port) as c:
            with pytest.raises(GatewayError) as ei:
                c.infer("m", {"x": _x()}, deadline_ms=50)
            assert ei.value.status == 503 and "deadline" in ei.value.message
            outs, _ = c.infer("m", {"x": _x()})
            np.testing.assert_array_equal(outs[0], _x() * 2.0)
        assert srv.stats()["requests"]["submitted"] == before + 1
        slow.settimeout(5.0)
        assert slow.recv(1) == b""
        slow.close()
        deadline = time.monotonic() + 2.0
        while (gw.stats()["counters"]["read_timeouts"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert gw.stats()["counters"]["read_timeouts"] >= 1


def _resilient_infer(host, port, value, attempts=40):
    for _ in range(attempts):
        try:
            with GatewayClient(host, port, timeout_s=5.0) as c:
                outs, _ = c.infer("m", {"x": _x(value=value)})
                return outs[0]
        except GatewayError as e:
            if e.status < 500:
                raise
            time.sleep(e.retry_after_s or 0.01)
        except (wire.WireError, OSError):
            time.sleep(0.005)
    raise AssertionError("request never served under fault storm")


@pytest.mark.parametrize("plan,counters", [
    ("gateway.accept@p0.5/3:raise", ("accept_faults",)),
    ("gateway.read:wire@p0.3/5:raise;gateway.write:wire@p0.2/7:raise",
     ("read_faults", "write_faults"))])
def test_fault_storms_served_through(plan, counters):
    with _gateway(Fake()) as gw:
        host, port = gw.start()
        with fault_plan(plan):
            for i in range(10):
                np.testing.assert_array_equal(
                    _resilient_infer(host, port, float(i)),
                    _x(value=float(i)) * 2.0)
        st = gw.stats()
        assert sum(st["counters"][k] for k in counters) >= 1
        assert not st["closing"]


# ---------------------------------------------------------------------
# registry: swap, rollback, fit gate, quality gate (parity)
# ---------------------------------------------------------------------

def _registry_story(side, model_dir):
    """One story through `side`'s registry: deploy v1, a swap killed at
    each pre-commit stage, a fit-gate refusal, a quality-gate refusal
    and pass, a real swap. Returns the comparable outcome."""
    if side == "jax":
        from paddle_tpu.reliability import fault_plan as plan
        reg, swap_error = JRegistry(max_wait_ms=1.0), JSwapError
        load = lambda: jinf.create_predictor(jinf.Config(model_dir))  # noqa
    else:
        plan, reg, swap_error = fault_plan, ModelRegistry(max_wait_ms=1.0), \
            SwapError
        load = lambda: _port_predictor(model_dir)  # noqa: E731
    out = []
    ex = {"x": np.zeros((1, 8), np.float32)}
    out.append(reg.deploy("m", "v1", load(), prewarm_feed=ex,
                          server_kwargs={"buckets": [1, 2]})["replaced"])
    for stage in ("load", "verify", "prewarm", "commit"):
        with plan(f"gateway.swap:{stage}@1:raise"):
            with pytest.raises(swap_error) as ei:
                reg.deploy("m", f"v-{stage}", load(), prewarm_feed=ex)
        out.append((stage, ei.value.stage, reg.active_version("m")))
    with pytest.raises(swap_error) as ei:
        reg.deploy("m", "v-big", load(), hbm_budget_bytes=1024)
    out.append(("fit", ei.value.stage, "model-does-not-fit" in str(
        ei.value)))
    rng = np.random.RandomState(0)
    gate_feed = {"x": rng.rand(4, 8).astype(np.float32)}
    wrong = [np.full((4, 4), 0.25, np.float32)]
    with pytest.raises(swap_error) as ei:
        reg.deploy("m", "v-bad", load(),
                   quality_gate={"feed": gate_feed, "reference": wrong,
                                 "threshold": 0.01})
    out.append(("quality", ei.value.stage,
                "quant-quality-regression" in str(ei.value)))
    entry = reg.deploy("m", "v2", load(), tier="fp32",
                       quality_gate={"feed": gate_feed, "reference": load(),
                                     "threshold": 0.01})
    out.append((entry["ok"], entry["replaced"], entry["tier"],
                entry["quality_rel_err"] < 1e-5,
                entry["drain_report"]["drained"]))
    models = reg.models()["m"]
    out.append(sorted((v, r["state"]) for v, r in
                      models["versions"].items()))
    out.append([(h["version"], h["ok"], h["stage"],
                 bool(h.get("rolled_back"))) for h in
                reg.stats()["swap_history"]])
    got = reg.resolve("m").server.infer(gate_feed)[0]
    reg.drain_all(timeout_s=5.0)
    return out, got


def test_registry_story_matches_jax(mlp_dir):
    want, jout = _registry_story("jax", mlp_dir)
    got, tout = _registry_story("port", mlp_dir)
    assert got == want
    np.testing.assert_allclose(tout, jout, **TOL)


def test_registry_resolve_duplicate_and_retire():
    reg = ModelRegistry(max_wait_ms=1.0)
    with pytest.raises(UnknownModelError):
        reg.resolve("m")
    reg.deploy("m", "v1", Fake(2.0))
    assert reg.resolve("m", "v1").version == "v1"
    with pytest.raises(UnknownModelError):
        reg.resolve("m", "v9")
    with pytest.raises(EnforceError):
        reg.deploy("m", "v1", Fake())
    entry = reg.deploy("m", "v2", Fake(3.0), prewarm_feed={"x": _x()})
    assert entry["ok"] and entry["drain_report"]["drained"]
    with pytest.raises(UnknownModelError):
        reg.resolve("m", "v1")
    out = reg.resolve("m").server.infer({"x": _x()})
    np.testing.assert_array_equal(out[0], _x() * 3.0)
    reg.drain_all(timeout_s=5.0)


def test_hot_swap_zero_drops_under_concurrent_load():
    gw = _gateway(Fake(2.0), max_queue=512)
    host, port = gw.start()
    stop = threading.Event()
    errors, served = [], [0]
    lock = threading.Lock()

    def client(idx):
        try:
            c = GatewayClient(host, port, timeout_s=10.0)
            v = 0
            while not stop.is_set():
                v += 1
                x = _x(value=float(idx * 1000 + v))
                outs, resp = c.infer("m", {"x": x})
                if not np.array_equal(outs[0], x * 2.0):
                    errors.append(("wrong answer", resp))
                with lock:
                    served[0] += 1
            c.close()
        except Exception as e:
            errors.append((type(e).__name__, str(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.15)
        before = served[0]
        assert before > 0
        with fault_plan("gateway.swap:prewarm@1:raise;"
                        "gateway.swap:commit@*:delay(0.05)"):
            with pytest.raises(SwapError):
                gw.registry.deploy("m", "vbad", Fake(99.0),
                                   prewarm_feed={"x": _x()})
            time.sleep(0.1)
            entry = gw.registry.deploy("m", "v2", Fake(2.0))
        assert entry["ok"] and entry["replaced"] == "v1"
        assert entry["drain_report"]["undrained_requests"] == 0
        time.sleep(0.15)
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
    assert errors == [], errors[:5]
    assert served[0] > before
    with GatewayClient(host, port) as c:
        _, resp = c.infer("m", {"x": _x()})
        assert resp["version"] == "v2"
    report = gw.shutdown(timeout_s=10.0)
    assert report["undrained_requests"] == 0 and report["stuck_workers"] == []


def test_final_drain_reports_undrained_and_stuck():
    gate = threading.Event()
    gate.set()                  # the prewarm passes; then the worker wedges
    gw = _gateway(max_queue=64)
    gw.registry.deploy("m", "v1", GatedFake(gate), prewarm_feed={"x": _x()},
                       server_kwargs={"num_replicas": 1, "max_wait_ms": 0.0,
                                      "buckets": [1]})
    gate.clear()
    gw.start()
    srv = gw.registry.resolve("m").server
    assert srv.stats()["shutdown"] is None
    reqs = [srv.submit({"x": _x()}) for _ in range(3)]
    try:
        report = gw.shutdown(timeout_s=0.3)
        mrep = report["models"]["m"]["v1"]
        assert report["undrained_requests"] == \
            mrep["undrained_requests"] >= 1
        assert report["stuck_workers"] == mrep["stuck_workers"] != []
        assert gw.stats()["final_drain"] == report
        assert srv.stats()["shutdown"]["undrained_requests"] >= 1
        status, doc, _ = gw._do_infer("m", None, {"x": _x()}, "", None,
                                      None)
        assert status == 503
        assert doc["undrained_requests"] == report["undrained_requests"]
    finally:
        gate.set()
        for r in reqs:
            try:
                r.result(timeout=5.0)
            except Exception:
                pass


# ---------------------------------------------------------------------
# the two packages across the wire, both ways
# ---------------------------------------------------------------------

def test_ptgw_and_http_cross_both_ways(mlp_dir):
    rng = np.random.RandomState(3)
    xs = [rng.rand(r, 8).astype(np.float32) for r in (1, 3, 2)]
    port_pred = _port_predictor(mlp_dir)
    want = [port_pred.run(feed={"x": x})[0] for x in xs]
    tgw = ServingGateway(device="cpu", max_wait_ms=1.0, buckets=[1, 2, 4])
    tgw.registry.deploy("m", "v1", _port_predictor(mlp_dir))
    jgw = JGateway(max_wait_ms=1.0, buckets=[1, 2, 4])
    jgw.registry.deploy("m", "v1",
                        jinf.create_predictor(jinf.Config(mlp_dir)))
    try:
        th, tp = tgw.start()
        jh, jp = jgw.start()
        for client_cls, (h, p) in ((JClient, (th, tp)),
                                   (GatewayClient, (jh, jp)),
                                   (GatewayClient, (th, tp))):
            with client_cls(h, p, tenant="x") as c:
                for x, w in zip(xs, want):
                    outs, resp = c.infer("m", {"x": x})
                    np.testing.assert_allclose(outs[0], w, **TOL)
                    assert resp["status"] == 200 and resp["version"] == "v1"
                with pytest.raises(Exception) as ei:
                    c.infer("ghost", {"x": xs[0]})
                assert getattr(ei.value, "status", None) == 404
        for http, (h, p) in ((jwire.http_request, (th, tp)),
                             (wire.http_request, (jh, jp))):
            st, doc, _ = http(h, p, "POST", "/v1/models/m:infer",
                              {"inputs": {"x": xs[1].tolist()}})
            assert st == 200
            np.testing.assert_allclose(np.asarray(doc["outputs"][0]),
                                       want[1], **TOL)
            st, doc, _ = http(h, p, "GET", "/healthz")
            assert st == 200 and doc["status"] == "healthy"
    finally:
        tgw.shutdown(timeout_s=10.0)
        jgw.shutdown(timeout_s=10.0)


# ---------------------------------------------------------------------
# streaming generation over the gateway
# ---------------------------------------------------------------------

def _http_generate(host, port, name, prompt, n):
    with socket.create_connection((host, port), timeout=30) as s:
        body = json.dumps({"inputs": list(map(int, prompt)),
                           "max_new_tokens": n}).encode()
        s.sendall(f"POST /v1/models/{name}:generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(4096)
        head, _, rest = buf.partition(b"\r\n\r\n")
        assert head.split(b"\r\n")[0] == b"HTTP/1.1 200 OK"
        assert b"Transfer-Encoding: chunked" in head

        class _Sock:
            pre = rest

            def recv(self, n):
                if self.pre:
                    out, self.pre = self.pre, b""
                    return out
                return s.recv(n)

        return list(wire.iter_http_chunks(_Sock()))


def test_generation_streams_over_ptgw_and_chunked_http():
    from paddle_tpu_torch.ops import generation as tgen
    from paddle_tpu_torch.serving.generation import GenerationServer
    model = tgen.TinyDecoderLM(tgen.LMConfig(), device="cpu").init_params(5)
    eng = tgen.PagedDecodeEngine(model, batch_size=4, max_len=64,
                                 block_size=8, spec_k=0, kv_dtype="int8",
                                 device="cpu")
    srv = GenerationServer(eng, idle_wait_s=0.001)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 64, size=rng.randint(3, 12)).tolist()
               for _ in range(5)]
    want = [srv.generate(p, 8, timeout=60)["tokens"] for p in prompts]
    gw = _gateway()
    gw.deploy_generator("lm", srv)
    host, port = gw.start()
    got, streamed = [None] * 5, [[] for _ in range(5)]

    def stream(i):
        with GatewayClient(host, port) as c:
            got[i] = c.generate(
                "lm", prompts[i], 8,
                on_token=lambda t, idx: streamed[i].append((idx, t)))

    try:
        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        chunks = _http_generate(host, port, "lm", prompts[4], 8)
        for t in threads:
            t.join(60)
        with JClient(host, port) as c:
            jgot = c.generate("lm", prompts[0], 8)
    finally:
        gw.shutdown(timeout_s=10.0)
    for i in range(4):
        assert got[i]["tokens"] == want[i]
        assert streamed[i] == list(enumerate(want[i]))
        assert got[i]["stop_cause"] == "max_tokens"
    assert [c["token"] for c in chunks[:-1]] == want[4]
    assert chunks[-1]["done"] and chunks[-1]["tokens"] == want[4]
    assert jgot["tokens"] == want[0]
