"""Fleet backend: one process running the full single-host serving
stack, plus the parent-side handles that spawn and reap it.

Counterpart of paddle_tpu/fleet/backend.py. A backend is
`ServingGateway + ModelRegistry + InferenceServer` in its own
interpreter, so N backends get N GILs and their own CUDA context (on
the card, the int8 paged generation path runs K7 in every backend).
Each backend:

* starts **warm** through the persistent compile cache: the parent
  passes `PT_FLAGS_compile_cache_dir` down, so the second and later
  backends capture their ladders from the first one's manifests before
  traffic (the READY doc reports the captures the backend paid on its
  own path, warm-start captures excluded);
* announces itself to the router over the SAME PTGW wire
  (``op=fleet.announce``, then periodic ``op=fleet.heartbeat`` frames
  carrying a live load doc);
* keeps the single-process surface: `/metrics`, `/profile`, `/healthz`,
  `/stats` are served by the embedded gateway, per backend.

Module layout:

* `DeviceSimPredictor` / `DeviceDelayPredictor` — predictors whose
  per-batch latency is a GIL-releasing sleep (the fleet tests' stand-in
  for a device), the second wrapping a real Predictor;
* `BackendServer` — the in-process runtime (gateway + heartbeater),
  used by the spawned child's `main()` and directly by in-process
  tests. Its spec may carry ``device``; without one it means the card
  and raises when there is none;
* `BackendProcess` — parent-side handle: spawn, FLEET-READY handshake,
  SIGTERM graceful drain (the FLEET-DRAIN doc carries the child's
  kernel launch counts, which the parent cannot see), SIGKILL for
  chaos. The child's environment is the parent's: no variable pins its
  device;
* `FleetManager` — spawns/retires/kills backends against a
  `FleetDirectory`, with the planner's static memory fit gate vetting
  placement BEFORE any process (or capture) is paid for.

Run a backend directly:
    python -m paddle_tpu_torch.fleet.backend --spec '<json>'
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.reliability.faults import inject_point
from paddle_tpu_torch.serving import wire

__all__ = ["DeviceSimPredictor", "DeviceDelayPredictor", "build_predictor",
           "BackendServer", "BackendProcess", "FleetManager", "main",
           "READY_MARK", "DRAIN_MARK"]

READY_MARK = "FLEET-READY "
DRAIN_MARK = "FLEET-DRAIN "


# ---------------------------------------------------------------------
# predictors
# ---------------------------------------------------------------------

class DeviceSimPredictor:
    """Echo predictor whose run() costs a fixed device-shaped delay.

    `run(feed)` returns ``[x * 2]`` after sleeping
    ``base_ms + per_row_ms * rows`` — time.sleep releases the GIL, so a
    backend process saturates like a device queue (serial per replica)
    while the host CPU stays free for the router and client tiers. It is
    no throughput claim about any device.
    """

    def __init__(self, base_ms=5.0, per_row_ms=0.0, input_name="x"):
        self.base_ms = float(base_ms)
        self.per_row_ms = float(per_row_ms)
        self._input = input_name

    def get_input_names(self):
        return [self._input]

    def clone(self):
        return DeviceSimPredictor(self.base_ms, self.per_row_ms,
                                  self._input)

    def run(self, feed=None):
        x = np.asarray(feed[self._input])
        rows = int(x.shape[0]) if x.ndim else 1
        delay = (self.base_ms + self.per_row_ms * rows) / 1e3
        if delay > 0:
            time.sleep(delay)
        return [x * 2.0]


class DeviceDelayPredictor:
    """Wrap a real Predictor with a per-batch delay.

    The inner predictor keeps its compile cache / CompileLedger
    behaviour; the sleep makes a single backend saturable on a small
    host."""

    def __init__(self, inner, device_ms=5.0):
        self._inner = inner
        self.device_ms = float(device_ms)
        # surface the program so the pool's warm-start manifest and the
        # planner fit gate see through the wrapper
        self._program = getattr(inner, "_program", None)

    def get_input_names(self):
        return self._inner.get_input_names()

    def clone(self):
        return DeviceDelayPredictor(self._inner.clone(), self.device_ms)

    def run(self, feed=None):
        outs = self._inner.run(feed=feed)
        if self.device_ms > 0:
            time.sleep(self.device_ms / 1e3)
        return outs


def build_predictor(model_spec, device=None):
    """Build a predictor from a JSON-able model spec dict.

    kinds:
      device_sim — {"kind": "device_sim", "base_ms", "per_row_ms"}
      model_dir  — {"kind": "model_dir", "dir": path, "device_ms": 0}
                   (a save_inference_model artifact loaded through
                   `inference.Config(dir, device=device)`, None meaning
                   the card; device_ms > 0 wraps it in
                   DeviceDelayPredictor)
    """
    kind = model_spec.get("kind", "device_sim")
    if kind == "device_sim":
        return DeviceSimPredictor(
            base_ms=model_spec.get("base_ms", 5.0),
            per_row_ms=model_spec.get("per_row_ms", 0.0),
            input_name=model_spec.get("input", "x"))
    if kind == "model_dir":
        from paddle_tpu_torch import inference
        pred = inference.create_predictor(
            inference.Config(model_spec["dir"], device=device))
        device_ms = float(model_spec.get("device_ms", 0.0))
        if device_ms > 0:
            pred = DeviceDelayPredictor(pred, device_ms=device_ms)
        return pred
    raise ValueError(f"unknown fleet model kind {kind!r}")


# ---------------------------------------------------------------------
# the in-process backend runtime
# ---------------------------------------------------------------------

class BackendServer:
    """Gateway + heartbeater: the thing a backend process runs.

    `spec` (all JSON-able):
      name            backend name in the directory
      model           model spec for build_predictor()
      model_name      served model name (default "m")
      buckets         batch ladder (default [1, 2, 4, 8])
      max_batch_size  (default max(buckets))
      num_replicas    (default 1 — one device per backend)
      prewarm         bool: warm the ladder at deploy (default True)
      hbm_budget_bytes  optional fit-gate budget for the deploy
      router          [host, port] to announce/heartbeat to (optional)
      routers         [[host, port], ...] — the HA pair: beats go to
                      EVERY router so a standby's directory is warm
                      before it promotes (supersedes `router`)
      heartbeat_interval_s  (default PT_FLAGS_fleet_heartbeat_interval_s)
      generator       optional TinyDecoderLM generation spec: the
                      LMConfig fields, seed (default 7), slots, paged,
                      block_size, num_blocks, spec_k, spill_blocks,
                      min_degraded_budget, kv_dtype ("f32", "int8",
                      "fp8_e4m3"), name (default "lm")
      device          "cpu" or a CUDA device; absent means the card,
                      and `start()` raises when there is none
    """

    def __init__(self, spec, clock=time.monotonic):
        self.spec = dict(spec)
        self.name = self.spec.get("name", "backend")
        self._clock = clock
        self.gateway = None
        self.generator = None
        self.address = None
        self.warm = {}                # component -> warm-start report
        self.timings = {}             # start-up stage -> seconds
        self._hb_thread = None
        self._hb_stop = threading.Event()
        self._hb_sock = None
        self._hb_mu = make_lock("fleet.backend.heartbeat")
        self.heartbeats_sent = 0
        self.announces_sent = 0
        self.reannounces = 0
        # the highest fleet epoch seen in any router reply; stamped
        # into every beat/announce so a zombie ex-active fences itself
        self.fleet_epoch = 0

    # -- lifecycle -----------------------------------------------------
    def start(self):
        from paddle_tpu_torch.serving import ServingGateway

        spec = self.spec
        t0 = time.perf_counter()
        device = resolve_device(spec.get("device"))
        if device.type == "cuda":
            # the library the parent built: a child only loads it
            from paddle_tpu_torch.ops.kernels import _build
            _build.load_library()
            import torch
            torch.cuda.init()
        self.timings["device_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = build_predictor(spec.get("model", {}), device=device)
        buckets = list(spec.get("buckets", [1, 2, 4, 8]))
        server_kwargs = {
            "num_replicas": int(spec.get("num_replicas", 1)),
            "max_batch_size": int(spec.get("max_batch_size",
                                           max(buckets))),
            "buckets": buckets,
        }
        self.gateway = ServingGateway(
            max_in_flight=spec.get("max_in_flight"),
            max_queue=int(spec.get("max_queue", 256)), device=device,
            read_timeout_s=float(spec.get("read_timeout_s", 30.0)))
        feed = None
        if spec.get("prewarm", True):
            in_dim = int(spec.get("in_dim", 8))
            feed = {pred.get_input_names()[0]:
                    np.ones((1, in_dim), np.float32)}
        self.gateway.registry.deploy(
            spec.get("model_name", "m"), spec.get("version", "v1"),
            pred, prewarm_feed=feed, server_kwargs=server_kwargs,
            hbm_budget_bytes=spec.get("hbm_budget_bytes"))
        self.warm["model"] = self.gateway.registry.resolve(
            spec.get("model_name", "m")).server.stats().get("warm_start")
        self.timings["model_s"] = time.perf_counter() - t0
        gen = spec.get("generator")
        if gen:
            # a generation-capable backend: a TinyDecoderLM engine, so
            # fleet streams (and their KV-slot affinity) are served.
            # "paged": true builds a PagedDecodeEngine (block pool,
            # prefix reuse, spill tier, degradation ladder; kv_dtype
            # "int8" runs K7 on the card) — a resumed stream's prompt
            # plus journal is one prefill there
            from paddle_tpu_torch.ops.generation import (
                DecodeEngine, LMConfig, PagedDecodeEngine,
                TinyDecoderLM,
            )
            from paddle_tpu_torch.serving import GenerationServer
            gen = dict(gen)
            slots = int(gen.pop("slots", 2))
            seed = int(gen.pop("seed", 7))
            gen_name = gen.pop("name", "lm")
            paged = bool(gen.pop("paged", False))
            block_size = int(gen.pop("block_size", 4))
            num_blocks = gen.pop("num_blocks", None)
            spec_k = int(gen.pop("spec_k", 0))
            spill_blocks = gen.pop("spill_blocks", None)
            min_budget = gen.pop("min_degraded_budget", None)
            kv_dtype = gen.pop("kv_dtype", "f32")
            t0 = time.perf_counter()
            model = TinyDecoderLM(LMConfig(**gen),
                                  device=device).init_params(seed)
            self.timings["generator_init_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            max_len = gen.get("max_len", 64)
            if paged:
                engine = PagedDecodeEngine(
                    model, batch_size=slots, max_len=max_len,
                    block_size=block_size, num_blocks=num_blocks,
                    spec_k=spec_k, spill_blocks=spill_blocks,
                    kv_dtype=kv_dtype, device=device)
                self.warm["generator"] = engine.warmup()["warm_start"]
                server = GenerationServer(
                    engine, idle_wait_s=0.001,
                    min_degraded_budget=min_budget)
            else:
                engine = DecodeEngine(model, batch_size=slots,
                                      max_len=max_len, device=device)
                self.warm["generator"] = engine.warmup()["warm_start"]
                server = GenerationServer(engine, idle_wait_s=0.001)
            self.generator = server
            self.timings["generator_warmup_s"] = time.perf_counter() - t0
            self.gateway.deploy_generator(gen_name, server)
        self.address = self.gateway.start()
        routers = spec.get("routers")
        if routers is None:
            router = spec.get("router")
            routers = [router] if router else []
        if routers:
            self._start_heartbeater([tuple(r) for r in routers])
        return self.address

    def stop(self, drain=True, timeout_s=15.0):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        with self._hb_mu:
            if self._hb_sock is not None:
                try:
                    self._hb_sock.close()
                except OSError:
                    pass
                self._hb_sock = None
        report = None
        if self.gateway is not None:
            if drain:
                report = self.gateway.shutdown(timeout_s=timeout_s)
            else:
                report = self.gateway.shutdown(timeout_s=0.0)
        return report

    # -- the load doc the router's least-loaded policy reads -----------
    def load_doc(self):
        gw = self.gateway
        queue_depth = 0
        try:
            st = gw.stats()
            for srv in st.get("servers", {}).values():
                queue_depth += int(srv.get("queue_depth", 0))
            in_flight = int(
                st.get("admission", {}).get("total_in_flight", 0))
        except Exception:
            in_flight = 0
        return {"queue_depth": queue_depth, "in_flight": in_flight,
                "t": self._clock()}

    # -- heartbeater ---------------------------------------------------
    def announce_meta(self):
        """The FULL spec a re-announce carries: everything a router
        that has never seen this backend (a promoted standby) needs to
        route to it correctly, not just pid and model."""
        return {"pid": os.getpid(),
                "model": self.spec.get("model_name", "m"),
                "buckets": list(self.spec.get("buckets", [1, 2, 4, 8])),
                "num_replicas": int(self.spec.get("num_replicas", 1)),
                "generator": bool(self.spec.get("generator")),
                "heartbeat_interval_s": float(self.spec.get(
                    "heartbeat_interval_s",
                    _flags.get_flag("fleet_heartbeat_interval_s")))}

    def _note_epoch(self, resp):
        ep = resp.get("epoch")
        if ep is not None and int(ep) > self.fleet_epoch:
            self.fleet_epoch = int(ep)

    def _stamp(self, header):
        if self.fleet_epoch > 0:
            header["epoch"] = self.fleet_epoch
        return header

    def _start_heartbeater(self, router_addrs):
        interval = float(self.spec.get(
            "heartbeat_interval_s",
            _flags.get_flag("fleet_heartbeat_interval_s")))

        def _dial(addr):
            s = socket.create_connection(addr, timeout=5.0)
            s.settimeout(5.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            wire.send_all(s, wire.MAGIC)
            return s

        def _rpc(sock, header):
            wire.send_frame(sock, wire.encode_payload(header, []))
            payload = wire.recv_frame(sock)
            if payload is None:
                raise wire.WireError("router closed heartbeat channel")
            resp, _ = wire.decode_payload(payload)
            self._note_epoch(resp)
            return resp

        def _announce(sock, rejoin=False):
            resp = _rpc(sock, self._stamp({
                "op": "fleet.announce", "name": self.name,
                "address": list(self.address),
                "meta": self.announce_meta(),
                "load": self.load_doc()}))
            self.announces_sent += 1
            if rejoin:
                self.reannounces += 1
            return resp

        # per-router persistent sockets: one torn/fenced router never
        # blocks beats to its peer
        socks = {addr: None for addr in router_addrs}

        def _beat_one(addr):
            sock = socks[addr]
            try:
                if sock is None:
                    sock = socks[addr] = _dial(addr)
                    with self._hb_mu:
                        self._hb_sock = sock
                    _announce(sock)
                resp = _rpc(sock, self._stamp(
                    {"op": "fleet.heartbeat", "name": self.name,
                     "load": self.load_doc()}))
                if resp.get("status") == 410:
                    # ANY 410 — evicted tombstone, a promoted router
                    # that has never heard of us, a stale-epoch stamp —
                    # means this router cannot route to us until we
                    # rejoin: re-announce with the full spec + current
                    # load NOW, within this same beat (the reply above
                    # already taught us the fleet epoch, so the rejoin
                    # carries it)
                    _announce(sock, rejoin=True)
                else:
                    self.heartbeats_sent += 1
            except (wire.WireError, OSError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                socks[addr] = None

        def _run():
            while not self._hb_stop.is_set():
                for addr in router_addrs:
                    if self._hb_stop.is_set():
                        break
                    _beat_one(addr)
                self._hb_stop.wait(interval)
            for sock in socks.values():
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass

        self._hb_thread = threading.Thread(
            target=_run, name=f"fleet-heartbeat-{self.name}",
            daemon=True)
        self._hb_thread.start()


# ---------------------------------------------------------------------
# child entry point
# ---------------------------------------------------------------------

def _captures_paid():
    """Captures (and first eager runs) this process paid on its own
    path: warm-start captures from a manifest excluded."""
    from paddle_tpu_torch.observability import profile as obs_profile
    return len(obs_profile.compile_ledger().compile_events())


def _kernel_modules():
    from paddle_tpu_torch.ops.kernels import decode_attention
    from paddle_tpu_torch.ops.kernels import flash_attention
    from paddle_tpu_torch.ops.kernels import quantized_matmul
    return decode_attention, flash_attention, quantized_matmul


def _launch_counts():
    """Every hand-written kernel's launch count in this process."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launch_counts)
    return out


def main(argv=None):
    """Spawned-backend entry: bring up BackendServer, print the
    FLEET-READY line (the parent's handshake), drain on SIGTERM and print
    the FLEET-DRAIN line."""
    import argparse
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.fleet.backend")
    p.add_argument("--spec", required=True,
                   help="backend spec as inline JSON or a file path")
    args = p.parse_args(argv)
    raw = args.spec
    if os.path.exists(raw):
        with open(raw) as f:
            raw = f.read()
    spec = json.loads(raw)

    # PT_FLEET_T0 is the spawning process's wall clock, so only the wall
    # clock can measure from it
    t0 = float(os.environ.get("PT_FLEET_T0",
                            time.time()))  # wallclock-ok: see above
    t_main = time.time() - t0  # wallclock-ok: from the parent's stamp
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())

    srv = BackendServer(spec)
    host, port = srv.start()
    # the drain doc's counts are the traffic's: the warm-up's are not
    for mod in _kernel_modules():
        mod.reset_launch_counts()
    print(READY_MARK + json.dumps({
        "name": srv.name, "host": host, "port": port,
        "pid": os.getpid(),
        "t_ready_s": time.time() - t0,  # wallclock-ok: parent's stamp
        "compiles_paid": _captures_paid(),
        "warm_start": srv.warm,
        "timings": dict(srv.timings, interpreter_s=t_main),
    }, default=str), flush=True)

    while not stop.is_set():
        stop.wait(0.2)

    report = srv.stop(drain=True)
    print(DRAIN_MARK + json.dumps({
        "name": srv.name,
        "report": report,
        "heartbeats_sent": srv.heartbeats_sent,
        "compiles_paid": _captures_paid(),
        "launch_counts": _launch_counts(),
        "jax_loaded": "jax" in sys.modules,
    }, default=str), flush=True)
    return 0


# ---------------------------------------------------------------------
# parent-side process handle
# ---------------------------------------------------------------------

class BackendProcess:
    """Spawn and supervise one backend child process.

    The child inherits the environment (so PT_FLAGS_compile_cache_dir
    points every backend at the SAME persistent cache — the warm-start
    path); nothing in it pins the child's device: the spec's "device"
    does, and without one the child runs on the card or fails its
    spawn."""

    def __init__(self, spec, env=None, spawn_clock=time.time):
        self.spec = dict(spec)
        self.name = self.spec.get("name", "backend")
        self._env = env
        self._spawn_clock = spawn_clock
        self.proc = None
        self.address = None
        self.ready_doc = None
        self.drain_doc = None
        self.spawned_at = None
        self._ready = threading.Event()
        self._exited = threading.Event()
        self._reader = None
        self._lines = []

    def start(self):
        env = dict(os.environ if self._env is None else self._env)
        self.spawned_at = self._spawn_clock()
        env["PT_FLEET_T0"] = repr(self.spawned_at)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.fleet.backend",
             "--spec", json.dumps(self.spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
        self._reader = threading.Thread(
            target=self._read_stdout, name=f"fleet-stdout-{self.name}",
            daemon=True)
        self._reader.start()
        return self

    def _read_stdout(self):
        try:
            for line in self.proc.stdout:
                line = line.rstrip("\n")
                self._lines.append(line)
                if len(self._lines) > 2000:
                    del self._lines[:1000]
                if line.startswith(READY_MARK):
                    self.ready_doc = json.loads(line[len(READY_MARK):])
                    self.address = (self.ready_doc["host"],
                                    self.ready_doc["port"])
                    self._ready.set()
                elif line.startswith(DRAIN_MARK):
                    self.drain_doc = json.loads(line[len(DRAIN_MARK):])
        except (ValueError, OSError):
            pass
        finally:
            self._exited.set()
            self._ready.set()       # unblock waiters on a dead child

    def wait_ready(self, timeout_s=None):
        if timeout_s is None:
            timeout_s = _flags.get_flag("fleet_spawn_timeout_s")
        if not self._ready.wait(timeout_s) or self.address is None:
            self.kill()
            if self._reader is not None:
                self._reader.join(timeout=5.0)
            tail = "\n".join(self._lines[-20:])
            raise RuntimeError(
                f"backend {self.name} never became ready "
                f"(timeout {timeout_s}s):\n{tail}")
        return self.address

    @property
    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    @property
    def pid(self):
        return self.proc.pid if self.proc is not None else None

    def terminate(self, drain=True, timeout_s=30.0):
        """Graceful retire: SIGTERM → child drains via
        gateway.shutdown(drain=True) → FLEET-DRAIN doc. SIGKILL only
        if the drain budget expires."""
        if self.proc is None:
            return None
        if self.alive:
            try:
                self.proc.send_signal(
                    signal.SIGTERM if drain else signal.SIGKILL)
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
        self._exited.wait(timeout=5.0)
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        return self.drain_doc

    def kill(self):
        """Chaos: SIGKILL, no drain."""
        if self.proc is not None and self.alive:
            try:
                self.proc.kill()
            except OSError:
                pass

    def tail(self, n=20):
        return "\n".join(self._lines[-n:])


# ---------------------------------------------------------------------
# the fleet manager
# ---------------------------------------------------------------------

class FleetManager:
    """Spawn/retire/kill backends against a FleetDirectory.

    `spec_factory(name) -> spec dict` builds each backend's spec (the
    router address is injected automatically when a router is attached;
    `routers` adds the HA pair's other addresses). Placement is vetted by
    `vet()` — the planner's static memory fit gate — BEFORE any process
    is spawned, so an over-budget model costs a planner pass, not a
    process and its captures. A spec that runs on the card has the
    kernel library built here first, so children only load it."""

    def __init__(self, directory, spec_factory, router=None,
                 spawn_timeout_s=None, clock=time.monotonic,
                 routers=None):
        self.directory = directory
        self.router = router
        # the HA pair: extra (host, port) addresses every spawned
        # backend beats IN ADDITION to `router` (warm standby
        # directories — adoption-from-beats)
        self.routers = list(routers or [])
        self._spec_factory = spec_factory
        self._spawn_timeout_s = spawn_timeout_s
        self._clock = clock
        self._mu = make_lock("fleet.manager")
        self._handles = {}            # name -> BackendProcess
        self._seq = 0
        self.timeline = []            # spawn/retire/kill event log

    # -- placement vet (static, nothing run) ----------------------------
    def vet(self, spec):
        """Static fit check for a spec's model against its memory budget.
        Returns (ok, diagnostic). device_sim models carry no program —
        they vet trivially; model_dir specs load the saved Program
        (json, nothing run) and run the planner's fit gate at the worst
        bucket."""
        model = spec.get("model", {})
        budget = spec.get("hbm_budget_bytes")
        if model.get("kind") != "model_dir" or not budget:
            return True, "no-program"
        try:
            from paddle_tpu_torch.analysis import planner
            from paddle_tpu_torch.core.ir import Program
            with open(os.path.join(model["dir"],
                                   "__model__.json")) as f:
                program = Program.from_dict(json.load(f))
            worst = max(spec.get("buckets", [1]))
            plan = planner.plan_program(program, batch_size=worst,
                                        hbm_budget_bytes=int(budget))
            diag = plan.fit_diagnostic()
            if diag is not None:
                return False, str(diag)
            return True, (f"fits: peak≈"
                          f"{plan.memory.step_peak_bytes()} "
                          f"≤ budget {budget}")
        except FileNotFoundError:
            return True, "no-saved-program"

    # -- lifecycle -----------------------------------------------------
    def spawn(self, name=None, wait=True):
        """Vet placement, spawn a backend process, handshake READY,
        announce it in the directory. Raises on vet failure or spawn
        fault (the fleet.spawn chaos site)."""
        with self._mu:
            self._seq += 1
            name = name or f"b{self._seq}"
        spec = dict(self._spec_factory(name))
        spec["name"] = name
        if self.router is not None and "router" not in spec:
            spec["router"] = list(self.router.address)
        if self.routers and "routers" not in spec:
            addrs = ([spec["router"]] if spec.get("router") else [])
            addrs += [list(a) for a in self.routers]
            spec["routers"] = addrs
        ok, diag = self.vet(spec)
        if not ok:
            self._event("vet_rejected", name, diag=diag)
            raise RuntimeError(
                f"placement vet rejected backend {name}: {diag}")
        self._event("vet_ok", name, diag=diag)
        inject_point("fleet.spawn", tag=name)
        if spec.get("device") != "cpu":
            # build (at most once, here) before any child loads
            from paddle_tpu_torch.ops.kernels import _build
            _build.load_library()
        handle = BackendProcess(spec)
        handle.start()
        with self._mu:
            self._handles[name] = handle
        self._event("spawn_started", name, pid=handle.pid)
        if wait:
            addr = handle.wait_ready(self._spawn_timeout_s)
            self.directory.announce(
                name, addr,
                meta={"pid": handle.pid,
                      "spawn_s": handle.ready_doc.get("t_ready_s"),
                      "compiles_paid":
                          handle.ready_doc.get("compiles_paid")})
            self._event("ready", name,
                        spawn_s=handle.ready_doc.get("t_ready_s"),
                        compiles_paid=handle.ready_doc.get(
                            "compiles_paid"))
        return handle

    def retire(self, name, drain=True, timeout_s=30.0):
        """Graceful scale-down: evict from the directory FIRST (the
        router stops routing new work), then SIGTERM → drain."""
        with self._mu:
            handle = self._handles.pop(name, None)
        if handle is None:
            return None
        self.directory.evict(name, reason="retired")
        self._event("retire_started", name)
        doc = handle.terminate(drain=drain, timeout_s=timeout_s)
        self._event("drained", name,
                    report=(doc or {}).get("report"))
        return doc

    def kill(self, name):
        """Chaos: SIGKILL the child, tell the directory nothing — the
        missed heartbeats drive the SUSPECT→LOST eviction, exactly the
        failure mode the router must survive."""
        with self._mu:
            handle = self._handles.get(name)
        if handle is None:
            return False
        handle.kill()
        self._event("killed", name)
        return True

    def shutdown_all(self, drain=True, timeout_s=30.0):
        for name in list(self._handles):
            self.retire(name, drain=drain, timeout_s=timeout_s)

    # -- views ---------------------------------------------------------
    def size(self):
        with self._mu:
            return len(self._handles)

    def names(self):
        with self._mu:
            return sorted(self._handles)

    def handle(self, name):
        with self._mu:
            return self._handles.get(name)

    def _event(self, kind, name, **extra):
        ev = {"event": kind, "backend": name, "t": self._clock()}
        ev.update(extra)
        with self._mu:
            self.timeline.append(ev)
        return ev


if __name__ == "__main__":
    sys.exit(main())
