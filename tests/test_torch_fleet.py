"""The port's fleet (paddle_tpu_torch/fleet/) against the JAX package's,
in process on the CPU with `device_sim` predictors and a tiny paged
generator on int8 KV pools.

* the port's router in front of port backends answers infer and
  generate exactly as the JAX router in front of JAX backends does, and
  the cross wiring too: the port's router in front of JAX backends, the
  JAX router in front of port backends (one PTGW wire);
* a backend connection torn mid-stream fails over exactly once: the
  journal re-dispatches to the peer, the client sees gapless indices and
  the uninterrupted tokens;
* epoch fencing, the `StandbyMonitor` takeover FSM and the
  `FleetAutoscaler`'s decisions, under one fake clock and one script,
  give the JAX package's replies, transitions and timelines;
* the router child (`python -m paddle_tpu_torch.fleet.ha`) runs an
  active and a standby that promotes when the active is killed, and the
  backend child (`python -m paddle_tpu_torch.fleet.backend`) does the
  READY handshake and the SIGTERM drain — neither loads jax; a backend
  child with no "device" and no GPU fails its spawn naming its last
  lines.

Subprocesses wait under explicit timeouts and are killed in a finally.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import fleet as jfleet
from paddle_tpu.fleet.ha import StandbyMonitor as JStandbyMonitor
from paddle_tpu.reliability import faults as jfaults
from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch.fleet.ha import StandbyMonitor as TStandbyMonitor
from paddle_tpu_torch.reliability import faults as tfaults
from paddle_tpu_torch.serving import wire

GEN = {"vocab_size": 64, "d_model": 32, "num_heads": 4, "num_layers": 2,
       "max_len": 32, "slots": 2, "seed": 11, "paged": True,
       "block_size": 4, "spill_blocks": 8, "kv_dtype": "int8"}
PROMPTS = [[3 + i, 7, 11, 2, 5] for i in range(4)]


def _spec(name, routers, device=None, **kw):
    spec = {"name": name, "model": {"kind": "device_sim", "base_ms": 0.5},
            "buckets": [1, 2], "max_batch_size": 2, "in_dim": 4,
            "heartbeat_interval_s": 0.1,
            "routers": [list(r) for r in routers],
            "generator": dict(GEN)}
    if device is not None:
        spec["device"] = device
    spec.update(kw)
    return spec


def _router(fleet, **kw):
    d = fleet.FleetDirectory(suspect_after_s=5.0, lost_after_s=30.0)
    r = fleet.FleetRouter(d, poll_interval_s=60.0, **kw)
    r.start()
    return r


def _wait(cond, what, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def fleets():
    """Two JAX backends beating the JAX router and a port router, two
    port backends beating the port router and a JAX router."""
    routers = {"jj": _router(jfleet), "tj": _router(tfleet),
               "tt": _router(tfleet), "jt": _router(jfleet)}
    backends = []
    try:
        for i in range(2):
            backends.append(jfleet.BackendServer(_spec(
                f"b{i}", [routers["jj"].address, routers["tj"].address])))
            backends.append(tfleet.BackendServer(_spec(
                f"b{i}", [routers["tt"].address, routers["jt"].address],
                device="cpu")))
        # started together: the JAX engines' compiles overlap
        starts = [threading.Thread(target=b.start) for b in backends]
        for t in starts:
            t.start()
        for t in starts:
            t.join(120)
        for r in routers.values():
            _wait(lambda r=r: r.directory.size() == 2, "backends joined")
        yield routers
    finally:
        for b in backends:
            b.stop(drain=False)
        for r in routers.values():
            r.shutdown(timeout_s=2.0)


def _answers(router):
    with wire.GatewayClient(*router.address, timeout_s=60.0) as c:
        infers = [c.infer("m", {"x": np.full((1, 4), float(i),
                                             np.float32)})[0]
                  for i in range(3)]
        streams = []
        for i, p in enumerate(PROMPTS):
            got = []
            end = c.generate("lm", p, 10, session=f"s{i}",
                             on_token=lambda t, j: got.append((int(t), j)))
            assert [t for t, _ in got] == [int(t) for t in end["tokens"]]
            assert [j for _, j in got] == list(range(10))
            streams.append(end["tokens"])
    return infers, streams


def test_port_fleet_answers_as_the_jax_fleet_and_cross_wired(fleets):
    want_inf, want_tok = _answers(fleets["jj"])
    for key in ("tt", "tj", "jt"):
        inf, tok = _answers(fleets[key])
        assert tok == want_tok, key
        for a, b in zip(inf, want_inf):
            np.testing.assert_array_equal(a, b)
    # affinity: each session went to its ring backend, in both packages
    ring = tfleet.HashRing()
    ring.rebuild(["b0", "b1"])
    for key in ("tt", "tj"):
        assert fleets[key].stats()["counters"]["affinity_hits"] >= 4
    assert {ring.lookup(f"s{i}") for i in range(4)} <= {"b0", "b1"}


def test_mid_stream_tear_fails_over_exactly_once():
    router = _router(tfleet)
    backs = [tfleet.BackendServer(_spec(f"b{i}", [router.address],
                                        device="cpu")) for i in range(2)]
    try:
        for b in backs:
            b.start()
        _wait(lambda: router.directory.size() == 2, "backends joined")
        with wire.GatewayClient(*router.address, timeout_s=30.0) as c:
            want = c.generate("lm", PROMPTS[0], 16, session="s")["tokens"]
        tfaults.set_fault_plan("generation.stream_write:delay(0.03)")
        streamed, idxs, torn = [], [], []

        def on_token(tok, i):
            streamed.append(int(tok))
            idxs.append(int(i))
            if len(streamed) == 3 and not torn:
                with router._stream_mu:
                    torn.extend(s for ss in router._stream_socks.values()
                                for s in ss)
                for s in torn:
                    s.close()

        try:
            with wire.GatewayClient(*router.address, timeout_s=30.0) as c:
                end = c.generate("lm", PROMPTS[0], 16, session="s",
                                 on_token=on_token)
        finally:
            tfaults.set_fault_plan(None)
        assert torn and streamed == want and idxs == list(range(16))
        assert end["tokens"] == want and end["resumed"] is True
        cnt = router.stats()["counters"]
        assert (cnt["stream_resumed"], cnt["stream_dup_dropped"],
                cnt["stream_failed"]) == (1, 0, 0)
        (res,) = router.fleet_doc()["stream_resumes"]
        assert res["committed"] >= 3 and len(res["failed"]) == 1
    finally:
        for b in backs:
            b.stop(drain=False)
        router.shutdown(timeout_s=2.0)


def _rpc(addr, header):
    with socket.create_connection(tuple(addr), timeout=5.0) as s:
        wire.send_all(s, wire.MAGIC)
        wire.send_frame(s, wire.encode_payload(header, []))
        resp, _ = wire.decode_payload(wire.recv_frame(s))
    resp.pop("id", None)
    return resp


FENCING = [
    {"op": "fleet.announce", "name": "b0", "address": ["127.0.0.1", 59999]},
    {"op": "fleet.heartbeat", "name": "b0"},
    {"op": "fleet.announce", "name": "b1", "address": ["127.0.0.1", 59998],
     "epoch": 2},
    {"op": "fleet.heartbeat", "name": "zombie"},
    {"op": "fleet.peer", "name": "r-standby", "address": ["127.0.0.1", 1],
     "rank": 1, "epoch": 3},
    {"op": "ping", "id": 1},
    {"op": "fleet.heartbeat", "name": "b0", "epoch": 4},
    {"op": "ping", "id": 2},
    {"op": "fleet.announce", "name": "b2", "address": ["127.0.0.1", 59997]},
]


@pytest.mark.parametrize("standby", [False, True])
def test_epoch_fencing_equals_the_reference(standby):
    out = []
    for fleet in (jfleet, tfleet):
        r = _router(fleet, epoch=3, standby=standby)
        try:
            replies = [_rpc(r.address, h) for h in FENCING]
            out.append((replies, r.role(), r.fenced, r._epoch_seen,
                        r.directory.names(),
                        {k: v for k, v in r.stats()["counters"].items()
                         if k not in ("connections", "wire_frames")}))
        finally:
            r.shutdown(timeout_s=2.0)
    assert out[0] == out[1]
    replies, role = out[1][0], out[1][1]
    assert replies[2]["status"] == 410 and replies[2]["event"] == \
        "stale-epoch"
    assert role == ("standby" if standby else "fenced")


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeHandle:
    def __init__(self, name, spawned_at):
        self.name = name
        self.spawned_at = spawned_at
        self.ready_doc = {"t_ready_s": 1.0, "compiles_paid": 0}


class FakeManager:
    def __init__(self, clock):
        self._clock = clock
        self._handles = {}
        self._seq = 0
        self.retired = []
        self.fail_with = None

    def spawn(self, name=None, wait=True):
        if self.fail_with is not None:
            raise self.fail_with
        self._seq += 1
        name = name or f"b{self._seq}"
        self._handles[name] = FakeHandle(name, self._clock())
        return self._handles[name]

    def retire(self, name, drain=True):
        self._handles.pop(name, None)
        self.retired.append(name)
        return {"report": {"drained": drain}}

    def size(self):
        return len(self._handles)

    def names(self):
        return sorted(self._handles)

    def handle(self, name):
        return self._handles.get(name)


def _alert(clock, severity="page", event="fire"):
    return {"slo": "wire-latency", "rule": f"{severity}:10s/2s",
            "event": event, "severity": severity, "t": clock.t}


def _scaler_timeline(fleet):
    clock = FakeClock()
    mgr = FakeManager(clock)
    mgr.spawn("b0")
    sc = fleet.FleetAutoscaler(mgr, slo_engine=None, clock=clock,
                               spawn_async=False, min_backends=1,
                               max_backends=3, cooldown_s=5.0,
                               quiet_after_s=30.0)
    trace = []
    for dt, action in [(0, "fire"), (1, "fire"), (10, "ticket"),
                       (0, "fire"), (10, "fire"), (0, "resolve"),
                       (0, "ticket-resolve"), (29, "tick"), (2, "tick"), (0, "tick"),
                       (31, "tick"), (10, "fail-vet"), (10, "fail-spawn"),
                       (31, "tick"), (31, "tick"), (0, "export")]:
        clock.t += dt
        if action in ("fire", "resolve"):
            sc.on_alert(_alert(clock, event=action))
        elif action.startswith("ticket"):
            sc.on_alert(_alert(clock, severity="ticket",
                               event="resolve" if "-" in action
                               else "fire"))
        elif action == "tick":
            trace.append(sc.tick())
        elif action.startswith("fail"):
            mgr.fail_with = RuntimeError(
                "placement vet rejected backend: does not fit"
                if action == "fail-vet" else "spawn timed out")
            sc.on_alert(_alert(clock))
            mgr.fail_with = None
        else:
            trace.append(sc.export_state())
    other = fleet.FleetAutoscaler(FakeManager(clock), slo_engine=None,
                                  clock=clock, spawn_async=False,
                                  cooldown_s=5.0)
    other.restore_state(dict(trace[-1], cooldown_remaining_s=3.0))
    other.maybe_scale_up()
    return (sc.timeline, sc.counters, trace, mgr.retired, sc.firing(),
            other.timeline, other.stats())


def test_autoscaler_decisions_equal_the_reference():
    want = _scaler_timeline(jfleet)
    got = _scaler_timeline(tfleet)
    assert got == want
    counters = got[1]
    assert counters["spawns"] >= 2 and counters["retires"] >= 1
    assert counters["vet_rejected"] == 1 and counters["spawn_errors"] == 1


def _takeover_trace(fleet, StandbyMonitor, faults, tmp_path):
    clock = FakeClock(0.0)
    store = fleet.DirectoryStore(str(tmp_path))
    old = fleet.FleetDirectory(suspect_after_s=5.0, lost_after_s=30.0,
                               clock=clock)
    old.attach_store(store)
    old.extra_state("router", lambda: {"epoch": 7, "name": "r-old"})
    old.extra_state("autoscaler", lambda: {
        "cooldown_remaining_s": 4.0, "min_backends": 2,
        "max_backends": 6, "cooldown_s": 5.0})
    old.announce("b0", ("127.0.0.1", 59999), meta={"model": "m"},
                 load={"queue_depth": 2})
    mgr = FakeManager(clock)
    scaler = fleet.FleetAutoscaler(mgr, slo_engine=None, clock=clock,
                                   spawn_async=False, cooldown_s=5.0)
    d = fleet.FleetDirectory(suspect_after_s=5.0, lost_after_s=30.0,
                             clock=clock)
    d.attach_store(store)
    router = fleet.FleetRouter(d, poll_interval_s=0, standby=True,
                               clock=clock, epoch=1, name="r-rank1")
    active = [True]
    peer_role = ["standby"]

    def probe(addr):
        if tuple(addr) == ("10.0.0.1", 9000) and active[0]:
            return {"epoch": 3, "role": "active"}
        if tuple(addr) == ("10.0.0.2", 9001) and peer_role[0]:
            return {"epoch": 3, "role": peer_role[0]}
        raise OSError("peer dead")

    mon = StandbyMonitor(router, ("10.0.0.1", 9000), clock=clock,
                         beat_interval_s=0.5, suspect_after_s=1.0,
                         lost_after_s=2.0, rank=1,
                         peers=[("r-rank0", ("10.0.0.2", 9001), 0)],
                         election_delay_s=1.0, probe=probe,
                         autoscaler=scaler)
    trace = []
    # the active suspected and back, then lost; rank 1 waits its turn,
    # defers to the live rank 0, which dies; the first promotion attempt
    # faults, the next promotes
    script = [(0.0, None), (1.5, "die"), (0.0, "revive"), (0.0, None),
              (1.5, "die"), (1.0, None), (0.5, None), (0.6, None),
              (0.5, "peer-dies"), (0.5, None), (0.5, None)]
    for dt, event in script:
        clock.t += dt
        if event == "die":
            active[0] = False
        elif event == "revive":
            active[0] = True
        elif event == "peer-dies":
            peer_role[0] = None
        if event == "peer-dies":
            with faults.fault_plan("fleet.takeover@1:raise"):
                trace.append(mon.observe())
        else:
            trace.append(mon.observe())
        trace.append((router.role(), router.epoch, router._epoch_seen,
                      dict(mon.counters)))
    scaler.on_alert(_alert(clock))
    return (trace, mon.stats(), router.directory.names(),
            router.directory.get("b0")["load"], scaler.timeline,
            scaler.counters, scaler.min_backends, scaler.max_backends)


def test_takeover_fsm_equals_the_reference(tmp_path):
    want = _takeover_trace(jfleet, JStandbyMonitor, jfaults,
                           tmp_path / "jax")
    got = _takeover_trace(tfleet, TStandbyMonitor, tfaults,
                          tmp_path / "port")
    assert got == want
    outcomes = got[0][::2]
    assert "deferred" in outcomes and "promote-fault" in outcomes
    assert outcomes[-2:] == ["promoted", "done"]
    assert got[1]["takeover_epoch"] == 8          # above the snapshot's 7
    assert got[2] == ["b0"] and got[5]["debounced"] == 1


def test_router_children_promote_the_standby(tmp_path):
    snap = str(tmp_path / "snap")
    socks = [socket.socket() for _ in range(2)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    a_port, s_port = (sk.getsockname()[1] for sk in socks)
    for sk in socks:
        sk.close()
    active = tfleet.RouterProcess({"name": "r-a", "snapshot_dir": snap,
                                   "port": a_port,
                                   "poll_interval_s": 60.0}).start()
    standby = tfleet.RouterProcess({
        "name": "r-s", "snapshot_dir": snap, "standby": True,
        "port": s_port, "active": ["127.0.0.1", a_port],
        "beat_interval_s": 0.05, "monitor_suspect_after_s": 0.2,
        "monitor_lost_after_s": 0.4, "poll_interval_s": 60.0}).start()
    try:
        a_addr = active.wait_ready(120)
        assert active.ready_doc["role"] == "active"
        assert active.ready_doc["jax_loaded"] is False
        s_addr = standby.wait_ready(120)
        assert standby.ready_doc["role"] == "standby"
        assert _rpc(s_addr, {"op": "ping", "id": 1})["status"] == 503
        _wait(lambda: _rpc(a_addr, {"op": "fleet.peer", "name": "probe",
                                    "address": ["127.0.0.1", 1]})[
            "status"] == 200, "the active answering")
        active.kill()
        doc = standby.wait_promoted(30)
        assert doc is not None and doc["epoch"] == 2, standby.tail()
        status, health, _ = wire.http_request(*s_addr, "GET", "/healthz")
        assert health["ha"]["role"] == "active"
    finally:
        for r in (active, standby):
            r.kill()
            r.terminate(timeout_s=10.0)


def test_backend_child_ready_drain_and_no_jax():
    spec = _spec("bp", [], device="cpu")
    spec.pop("routers")
    h = tfleet.BackendProcess(spec).start()
    try:
        addr = h.wait_ready(120)
        assert h.ready_doc["name"] == "bp" and h.ready_doc["pid"] == h.pid
        with wire.GatewayClient(*addr, timeout_s=30.0) as c:
            assert len(c.generate("lm", PROMPTS[0], 4)["tokens"]) == 4
            out = c.infer("m", {"x": np.ones((1, 4), np.float32)})[0]
            np.testing.assert_array_equal(np.asarray(out).reshape(1, 4),
                                          np.full((1, 4), 2.0, np.float32))
        doc = h.terminate(drain=True, timeout_s=60.0)
        assert doc is not None and doc["report"]["undrained_requests"] == 0
        assert doc["jax_loaded"] is False
        assert doc["compiles_paid"] == h.ready_doc["compiles_paid"]
        assert h.proc.returncode == 0
    finally:
        h.kill()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a GPU: the child must refuse to start")
def test_backend_child_without_a_device_fails_its_spawn():
    spec = _spec("nodev", [])
    spec.pop("routers")
    h = tfleet.BackendProcess(spec).start()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            h.wait_ready(120)
    finally:
        h.kill()


def test_placement_vet_equals_the_reference(tmp_path):
    """The planner's fit gate vets a saved fc stack before any process:
    refused at a 1 KiB budget, admitted at 1 GiB, as the JAX manager
    decides; a spec without a program vets trivially."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [16])
        out = static.fc(static.fc(x, 32, act="relu"), 10, act="softmax")
    exe = Executor("cpu")
    exe.run(startup)
    mdir = str(tmp_path / "mlp")
    static.io.save_inference_model(mdir, ["x"], [out], exe,
                                   main_program=main)
    verdicts = []
    for fleet in (jfleet, tfleet):
        mgr = fleet.FleetManager(fleet.FleetDirectory(), lambda n: {})
        verdicts.append([mgr.vet({"model": {"kind": "model_dir",
                                            "dir": mdir},
                                  "buckets": [1, 8],
                                  "hbm_budget_bytes": budget})[0]
                         for budget in (1024, 1 << 30)]
                        + [mgr.vet({"model": {"kind": "device_sim"}})])
    assert verdicts[0] == verdicts[1]
    assert verdicts[1][:2] == [False, True]
    assert verdicts[1][2] == (True, "no-program")
