"""Network serving gateway: the TCP front end over `InferenceServer`.

Counterpart of paddle_tpu/serving/gateway.py. `ServingGateway` puts a
wire in front of the in-process servers: one listening socket, one
thread per connection, length-prefixed frames bounded at 256 MiB. Two
protocols share the port, sniffed from the first four bytes of each
connection (wire.py): the ``PTGW`` binary framing on the hot path,
HTTP/1.1 + JSON for curl-able debuggability. The bytes are the JAX
package's, so either package's client talks to either gateway.

Layering (each piece is independently testable)::

    conns ─▶ Gateway (deadlines, framing)      wire.py
               ─▶ AdmissionController          admission.py
                    (quota / priority / deadline shed / in-flight)
               ─▶ ModelRegistry.resolve        registry.py
                    (active version; atomic hot-swap)
               ─▶ InferenceServer.submit       pool.py
                    (dynamic batching, replicas, breaker, retry)

Beside the one-shot models, `deploy_generator` attaches a
GenerationServer (serving/generation.py) whose tokens stream as PTGW
206 frames and chunked HTTP. HTTP routes: ``GET /healthz`` (the
HealthScorer's verdict, 503 when unhealthy or draining), ``/slo`` (the
SloEngine's objectives and alerts), ``/stats``, ``/metrics``
(Prometheus text), ``/profile`` (the compile ledger, the capture gate
and the planner's cross-check), ``/models``; ``POST
/v1/models/<name>:infer``, ``:generate``, ``/admin/models/<name>/swap``
and ``/admin/drain``.

Wire-level robustness:

* **per-connection read/write deadlines** — a slow or stalled client
  trips `socket.timeout` and loses ITS connection;
* **early rejection** — admission failures (quota 429, overload /
  deadline-unmeetable / draining 503) turn around at the gateway with a
  Retry-After hint before touching the server queue;
* **zero-drop routing across hot-swap** — the registry swap is a
  pointer flip; a request that races the flip and hits the retiring
  server's closed queue (`ServerClosed`) is re-routed to the new active
  version (bounded retries);
* **head-sampled tracing** — requests carrying a wire trace context
  are always traced, 1 in PT_FLAGS_trace_sample_every of the rest;
* **chaos choke points** — `gateway.accept`, `gateway.read`,
  `gateway.write` (and `gateway.swap` in registry.py).
"""
import json
import logging
import socket
import threading
import time

import numpy as np

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import trace as obs_trace
from paddle_tpu_torch.reliability.faults import FaultError, inject_point
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.admission import AdmissionController
from paddle_tpu_torch.serving.batcher import (
    QueueFullError, RequestTimeout, ServerClosed, ServingError,
)
from paddle_tpu_torch.serving.registry import (
    ModelRegistry, SwapError, UnknownModelError,
)
from paddle_tpu_torch.utils.metrics import Counter, LatencyStat

logger = logging.getLogger("paddle_tpu_torch.serving.gateway")

__all__ = ["ServingGateway"]

#: submit→ServerClosed rerouting attempts across a racing hot-swap.
_REROUTE_ATTEMPTS = 4


class ServingGateway:
    """TCP front end: multi-model, multi-tenant, hot-swappable.

    >>> gw = ServingGateway(max_in_flight=256)     # device=None: the card
    >>> gw.registry.deploy("mlp", "v1", predictor,
    ...                    prewarm_feed={"x": example})
    >>> host, port = gw.start()
    >>> ... clients connect (wire.GatewayClient / HTTP) ...
    >>> report = gw.shutdown()      # final drain report, per model
    """

    def __init__(self, registry=None, admission=None,
                 host="127.0.0.1", port=0,
                 read_timeout_s=30.0, write_timeout_s=10.0,
                 accept_backlog=64, max_frame_bytes=wire.MAX_FRAME_BYTES,
                 max_in_flight=None, clock=time.monotonic,
                 trace_sample_every=None, slo_engine=None,
                 health_scorer=None, device=None,
                 **registry_kwargs):
        # where a model loaded by POST /admin/models/<name>/swap runs:
        # None is the card, and raises without one
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry(**registry_kwargs)
        # the SLO/health decision plane: burn-rate objectives evaluated
        # on a background thread (PT_FLAGS_slo_eval_interval_s; started
        # with the acceptor, never on the request path) served at
        # GET /slo, and a health scorer whose structured verdict
        # GET /healthz serves with an HTTP 503 when any model/engine is
        # unhealthy
        if slo_engine is None:
            from paddle_tpu_torch.observability.slo import (
                SloEngine, default_serving_specs,
            )
            slo_engine = SloEngine(default_serving_specs(), clock=clock)
        self.slo = slo_engine
        if health_scorer is None:
            from paddle_tpu_torch.observability.health import HealthScorer
            health_scorer = HealthScorer(gateway=self,
                                         view=self.slo.view,
                                         clock=clock)
        self.health = health_scorer
        # head sampling: requests carrying a wire trace context are
        # ALWAYS traced (the caller asked);
        # 1-in-N of the rest get a gateway-rooted tree. Tracing every
        # request would tax the wire p50 by the full span-tree cost on
        # a GIL-bound host — sampling keeps steady-state overhead flat
        # while any single request can be traced on demand.
        if trace_sample_every is None:
            from paddle_tpu_torch.core import flags as _flags
            trace_sample_every = _flags.get_flag("trace_sample_every")
        self._trace_every = max(int(trace_sample_every), 1)
        self._trace_tick = 0
        self.admission = admission or AdmissionController(
            max_in_flight=max_in_flight, clock=clock)
        self._host, self._port = host, int(port)
        self._read_timeout = read_timeout_s
        self._write_timeout = write_timeout_s
        self._backlog = accept_backlog
        self._max_frame = max_frame_bytes
        self._clock = clock
        self._listener = None
        self._accept_thread = None
        self._conn_threads = set()
        self._conn_mu = make_lock("serving.gateway.conns")
        self._closing = threading.Event()
        self._final_report = None
        self._counters = Counter("gateway", (
            "connections", "wire_frames", "http_requests",
            "accept_faults", "read_faults", "write_faults",
            "read_timeouts", "write_timeouts", "bad_frames",
            "rerouted_submits", "preemptions",
            "ok", "rejected", "errors",
            "gen_requests", "gen_resumed", "stream_frames",
            "stream_faults"))
        self._wire_latency = LatencyStat("gateway_wire_latency_s")
        # generation servers (serving/generation.py) by model name —
        # the streaming surface beside the registry's one-shot servers
        self._generators = {}
        self._gen_mu = make_lock("serving.gateway.gen")

    # -- lifecycle -----------------------------------------------------
    def start(self):
        """Bind + listen + spawn the acceptor. Returns (host, port) —
        port resolves the ephemeral 0 the tests and bench bind with."""
        enforce(self._listener is None, "gateway already started")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(self._backlog)
        # a finite accept timeout keeps shutdown() bounded without an
        # out-of-band wakeup socket
        s.settimeout(0.1)
        self._listener = s
        self._port = s.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pt-gateway-accept",
            daemon=True)
        self._accept_thread.start()
        self.slo.start()              # no-op at slo_eval_interval_s=0
        logger.info("gateway listening on %s:%d", self._host, self._port)
        return self._host, self._port

    @property
    def address(self):
        return self._host, self._port

    def deploy_generator(self, name, server):
        """Attach a GenerationServer under `name`: served at the wire
        ``op=generate`` and ``POST /v1/models/<name>:generate`` routes
        (per-token streaming), drained with the gateway."""
        with self._gen_mu:
            self._generators[name] = server
        return server

    def _generator(self, name):
        with self._gen_mu:
            return self._generators.get(name)

    def shutdown(self, timeout_s=30.0):
        """Stop accepting, close the listener, bound-join connection
        threads, then drain every model server. Returns the final drain
        report — per model/version {undrained_requests, stuck_workers}
        plus gateway counters — also served by POST /admin/drain and
        kept in stats()["final_drain"]."""
        self._closing.set()
        self.slo.stop()
        deadline = self._clock() + timeout_s
        if self._accept_thread is not None:
            self._accept_thread.join(max(deadline - self._clock(), 0.1))
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conn_mu:
            threads = list(self._conn_threads)
        me = threading.current_thread()
        for t in threads:
            if t is me:
                continue          # /admin/drain runs ON a conn thread
            t.join(max(deadline - self._clock(), 0.0))
        lingering = sum(1 for t in threads
                        if t is not me and t.is_alive())
        reports = self.registry.drain_all(
            timeout_s=max(deadline - self._clock(), 0.1))
        with self._gen_mu:
            gens = dict(self._generators)
        gen_reports = {
            n: g.shutdown(drain=True,
                          timeout=max(deadline - self._clock(), 0.1))
            for n, g in gens.items()}
        report = {
            "models": reports,
            "generators": gen_reports,
            "undrained_requests": sum(
                r.get("undrained_requests", 0)
                for vs in reports.values() for r in vs.values())
            + sum(r.get("undrained_requests", 0)
                  for r in gen_reports.values()),
            "stuck_workers": sorted(
                w for vs in reports.values() for r in vs.values()
                for w in r.get("stuck_workers", ())),
            "lingering_connections": lingering,
            "gateway": self._counters.eval(),
        }
        self._final_report = report
        if report["undrained_requests"] or report["stuck_workers"]:
            logger.warning("gateway drain incomplete: %s", report)
        return report

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._final_report is None:
            self.shutdown()

    # -- accept / connection plumbing ----------------------------------
    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return            # listener closed under us: shutdown
            try:
                # chaos: an injected accept fault models a handshake
                # that dies before service. The CONNECTION is
                # sacrificed, the acceptor survives and keeps listening.
                inject_point("gateway.accept")
            except FaultError:
                self._counters.inc("accept_faults")
                self._close_quietly(conn)
                continue
            self._counters.inc("connections")
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(conn, peer),
                name=f"pt-gateway-conn-{peer[1]}", daemon=True)
            with self._conn_mu:
                self._conn_threads.add(t)
            t.start()

    def _serve_conn(self, conn, peer):
        try:
            conn.settimeout(self._read_timeout)
            try:
                head = wire.recv_exact(conn, 4)
            except (wire.WireError, socket.timeout, OSError):
                return
            if head is None:
                return
            if head == wire.MAGIC:
                self._serve_binary(conn)
            else:
                self._serve_http(conn, head)
        except Exception:
            logger.debug("connection %s died", peer, exc_info=True)
        finally:
            self._close_quietly(conn)
            with self._conn_mu:
                self._conn_threads.discard(threading.current_thread())

    @staticmethod
    def _close_quietly(conn):
        try:
            conn.close()
        except OSError:
            pass

    # -- binary protocol -----------------------------------------------
    def _serve_binary(self, conn):
        """Persistent framed connection: request frame in, response
        frame out, until EOF / deadline / fault."""
        while not self._closing.is_set():
            try:
                conn.settimeout(self._read_timeout)
                payload = wire.recv_frame(conn, self._max_frame)
                # chaos: a read fault is a torn/poisoned inbound frame —
                # indistinguishable from a lying client, so the
                # connection is dropped (the client reconnects; requests
                # not yet admitted were never owed a response)
                inject_point("gateway.read", tag="wire")
            except socket.timeout:
                self._counters.inc("read_timeouts")
                return
            except FaultError:
                self._counters.inc("read_faults")
                return
            except (wire.WireError, OSError):
                self._counters.inc("bad_frames")
                return
            if payload is None:
                return            # orderly EOF
            self._counters.inc("wire_frames")
            t0 = self._clock()
            try:
                header, tensors = wire.decode_payload(payload)
                if header.get("op") == "generate":
                    # streaming op: frames are written inline (206 per
                    # token, 200 terminal); a dead client mid-stream
                    # closes the conn AND frees the decode slot
                    if not self._wire_generate(conn, header, tensors):
                        return
                    self._wire_latency.update(self._clock() - t0)
                    continue
                resp_header, resp_tensors = self._dispatch_wire(
                    header, tensors)
            except wire.WireError as e:
                resp_header, resp_tensors = {"status": 400,
                                             "error": str(e)}, []
            except Exception as e:        # never kill the conn thread
                logger.exception("wire dispatch error")
                resp_header, resp_tensors = {
                    "status": 500, "error": f"{type(e).__name__}: {e}"}, []
            resp_header.setdefault("id", None)
            try:
                conn.settimeout(self._write_timeout)
                # chaos: a write fault / timeout is a client that
                # stopped reading — its connection dies, nobody else's
                inject_point("gateway.write", tag="wire")
                wire.send_frame(conn, wire.encode_payload(
                    resp_header, resp_tensors))
            except socket.timeout:
                self._counters.inc("write_timeouts")
                return
            except FaultError:
                self._counters.inc("write_faults")
                return
            except (wire.WireError, OSError):
                self._counters.inc("bad_frames")
                return
            self._wire_latency.update(self._clock() - t0)

    def _dispatch_wire(self, header, tensors):
        op = header.get("op")
        rid = header.get("id")
        if op == "ping":
            return {"status": 200, "id": rid}, []
        if op == "stats":
            return {"status": 200, "id": rid, "stats": self.stats()}, []
        if op != "infer":
            return {"status": 400, "id": rid,
                    "error": f"unknown op {op!r}"}, []
        names = header.get("inputs") or []
        if len(names) != len(tensors):
            raise wire.WireError(
                f"{len(names)} input names for {len(tensors)} tensors")
        status, doc, outs = self._do_infer(
            model=header.get("model"),
            version=header.get("version"),
            feed=dict(zip(names, tensors)),
            tenant=header.get("tenant", ""),
            priority=header.get("priority"),
            deadline_ms=header.get("deadline_ms"),
            trace_parent=header.get("trace"))
        doc = dict(doc)
        doc["status"] = status
        doc["id"] = rid
        return doc, outs

    # -- HTTP protocol -------------------------------------------------
    def _serve_http(self, conn, head):
        try:
            parsed = wire.read_http_request(conn, prefix=head)
        except (wire.WireError, socket.timeout, OSError):
            self._counters.inc("bad_frames")
            return
        if parsed is None:
            return
        method, path, _headers, body = parsed
        self._counters.inc("http_requests")
        if method == "POST" and path.startswith("/v1/models/") \
                and path.endswith(":generate"):
            # streaming route: writes its own chunked response
            name = path[len("/v1/models/"):-len(":generate")]
            self._http_generate(conn, name, body)
            return
        try:
            status, doc, extra = self._dispatch_http(method, path, body)
        except Exception as e:            # pragma: no cover - guard rail
            logger.exception("http dispatch error")
            status, doc, extra = 500, {
                "error": f"{type(e).__name__}: {e}"}, ()
        try:
            conn.settimeout(self._write_timeout)
            inject_point("gateway.write", tag="http")
            wire.send_all(conn, wire.http_response(status, doc, extra))
        except socket.timeout:
            self._counters.inc("write_timeouts")
        except (FaultError, wire.WireError, OSError):
            self._counters.inc("write_faults")

    def _dispatch_http(self, method, path, body):
        if method == "GET" and path == "/healthz":
            # structured health: the composed score/verdict document
            # (per-model factors + worst-of rollup). Old probes keep
            # working — the body still carries the top-level "ok" and
            # a 200 means healthy-or-degraded; only an UNHEALTHY
            # verdict (or a draining gateway) turns the probe 503.
            doc = self.health.report()
            doc["models_active"] = {n: m["active"] for n, m in
                                    self.registry.models().items()}
            return (200 if doc["ok"] else 503), doc, ()
        if method == "GET" and path == "/slo":
            # the SLO engine's objectives, burn rates, firing alerts
            # and bounded alert log (evaluated on demand so a poll
            # between background ticks still sees fresh windows)
            return 200, self.slo.snapshot(), ()
        if method == "GET" and path == "/stats":
            return 200, self.stats(), ()
        if method == "GET" and path == "/metrics":
            # Prometheus text exposition over the unified registry —
            # gateway counters, per-tenant admission, per-bucket batcher
            # series, wire/request latency histograms, ...
            return 200, wire.RawBody(
                obs_metrics.registry().prometheus_text(),
                content_type="text/plain; version=0.0.4; "
                             "charset=utf-8"), ()
        if method == "GET" and path == "/profile":
            # executable-level profile: the compile ledger (captures,
            # recapture forensics), per-executable run stats, the memory
            # ledger's watermarks, the capture gate, the planner's
            # estimates against the captures' peaks (plan_check) and the
            # lock checker's "concurrency" section when it is armed
            from paddle_tpu_torch.observability import profile as obs_profile
            return 200, obs_profile.profile_snapshot(), ()
        if method == "GET" and path == "/models":
            return 200, self.registry.models(), ()
        if method == "POST" and path == "/admin/drain":
            # drain on a helper so the response can still be written
            # over THIS connection before the acceptor dies
            doc = json.loads(body or b"{}")
            report = self.shutdown(timeout_s=float(
                doc.get("timeout_s", 30.0)))
            return 200, report, ()
        if method == "POST" and path.startswith("/admin/models/"):
            return self._http_swap(path, body)
        if method == "POST" and (path.startswith("/v1/models/")
                                 and path.endswith(":infer")):
            name = path[len("/v1/models/"):-len(":infer")]
            return self._http_infer(name, body)
        return 404, {"error": f"no route {method} {path}"}, ()

    def _http_infer(self, name, body):
        try:
            doc = json.loads(body or b"{}")
            feed = {k: np.asarray(v) for k, v in
                    (doc.get("inputs") or {}).items()}
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad JSON body: {e}"}, ()
        status, resp, outs = self._do_infer(
            model=name, version=doc.get("version"), feed=feed,
            tenant=doc.get("tenant", ""), priority=doc.get("priority"),
            deadline_ms=doc.get("deadline_ms"),
            trace_parent=doc.get("trace"))
        resp = dict(resp)
        if status == 200:
            resp["outputs"] = [o.tolist() for o in outs]
        extra = ()
        if resp.get("retry_after_s") is not None:
            extra = (("Retry-After",
                      f"{max(resp['retry_after_s'], 0.001):.3f}"),)
        return status, resp, extra

    def _http_swap(self, path, body):
        """POST /admin/models/<name>/swap {"version", "model_dir"}:
        load a predictor from disk (on the gateway's `device`: None is
        the card) and run the full cutover."""
        name = path[len("/admin/models/"):]
        if not name.endswith("/swap"):
            return 404, {"error": f"no route POST {path}"}, ()
        name = name[:-len("/swap")]
        try:
            doc = json.loads(body or b"{}")
            version = doc["version"]
            model_dir = doc["model_dir"]
        except (ValueError, KeyError) as e:
            return 400, {"error": f"swap body needs version + "
                                  f"model_dir: {e}"}, ()
        from paddle_tpu_torch.inference import Config, create_predictor
        try:
            predictor = create_predictor(Config(model_dir,
                                                device=self.device))
            prewarm = doc.get("prewarm_feed")
            if prewarm is not None:
                prewarm = {k: np.asarray(v) for k, v in prewarm.items()}
            entry = self.registry.deploy(name, version, predictor,
                                         prewarm_feed=prewarm)
            return 200, entry, ()
        except SwapError as e:
            return 503, {"error": str(e), "stage": e.stage,
                         "rolled_back": True}, ()
        except Exception as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}, ()

    # -- streaming generation ------------------------------------------
    def _request_root(self, trace_parent, model, tenant):
        """gateway.request root span with the same head-sampling rule as
        _do_infer: wire-carried contexts always trace, the rest 1-in-N."""
        if trace_parent is not None:
            return obs_trace.start_span(
                "gateway.request", parent=trace_parent,
                attrs={"model": model or "", "tenant": tenant,
                       "op": "generate"})
        self._trace_tick += 1
        if self._trace_tick % self._trace_every == 0:
            return obs_trace.start_span(
                "gateway.request",
                attrs={"model": model or "", "tenant": tenant,
                       "op": "generate", "sampled": True})
        return obs_trace.noop_span()

    def _submit_generate(self, header, prompt, root):
        """Admission + submit for one generate request. Returns
        (request, None) on success or (None, (status, error_doc)) on an
        early rejection — never raises for policy failures."""
        from paddle_tpu_torch.serving.generation import GenerationRequest  # noqa: F401
        name = header.get("model")
        if not name:
            return None, (400, {"error": "missing model name"})
        gen = self._generator(name)
        if gen is None:
            return None, (404, {"error": f"no generator {name!r}"})
        if self._closing.is_set():
            st, doc, _ = self._draining_reject()
            return None, (st, doc)
        tenant = header.get("tenant", "")
        try:
            max_new = int(header.get("max_new_tokens", 16))
        except (TypeError, ValueError):
            return None, (400, {"error": "bad max_new_tokens"})
        now = self._clock()
        deadline_ms = header.get("deadline_ms")
        deadline_s = None if deadline_ms is None else \
            now + float(deadline_ms) / 1e3
        decision = self.admission.admit(
            tenant, rows=1, priority=header.get("priority"),
            deadline_s=deadline_s,
            queue_depth=gen.batcher.queue_depth, now=now)
        if not decision:
            self._counters.inc("rejected")
            return None, (decision.status, {
                "error": decision.reason, "tenant": tenant,
                "retry_after_s": decision.retry_after_s})
        kwargs = dict(
            max_new_tokens=max_new,
            stop_token=header.get("stop_token"),
            mode=header.get("mode", "greedy"),
            temperature=float(header.get("temperature", 1.0)),
            seed=int(header.get("seed", 0)),
            deadline_ms=deadline_ms, tenant=tenant,
            trace_ctx=root.context(), request_id=header.get("id"))
        resume = header.get("resume_committed")
        try:
            if resume is not None:
                # a stream relocated from a dead peer: committed tokens
                # condition the continuation, only the remaining budget
                # decodes here; resume_offset shifts the frame indices
                req = gen.submit_resumed(
                    np.asarray(prompt, np.int32).reshape(-1),
                    [int(t) for t in resume], **kwargs)
                self._counters.inc("gen_resumed")
            else:
                req = gen.submit(
                    np.asarray(prompt, np.int32).reshape(-1), **kwargs)
            self._counters.inc("gen_requests")
            return req, None
        except QueueFullError:
            self._counters.inc("rejected")
            self.admission.release(tenant)
            return None, (503, {"error": "generation queue full",
                                "tenant": tenant, "retry_after_s": 0.05})
        except ServerClosed:
            self._counters.inc("rejected")
            self.admission.release(tenant)
            st, doc, _ = self._draining_reject()
            return None, (st, doc)
        except Exception as e:
            self._counters.inc("errors")
            self.admission.release(tenant)
            return None, (400, {"error": f"{type(e).__name__}: {e}",
                                "tenant": tenant})

    def _resume_noop(self, header):
        """A resumed stream whose committed tokens already satisfy the
        contract (budget exhausted or stop token emitted) — returns the
        terminal doc to mint from the journal, None otherwise."""
        committed = header.get("resume_committed")
        if committed is None:
            return None
        try:
            committed = [int(t) for t in committed]
            max_new = int(header.get("max_new_tokens", 16))
            stop = header.get("stop_token")
        except (TypeError, ValueError):
            return None
        if committed and stop is not None and committed[-1] == int(stop):
            cause = "stop_token"
        elif len(committed) >= max_new:
            cause = "max_tokens"
        else:
            return None
        return {"model": header.get("model"), "tokens": [],
                "stop_cause": cause, "ttft_ms": None,
                "tenant": header.get("tenant", ""),
                "resumed_noop": True}

    def _wire_generate(self, conn, header, tensors):
        """Binary streaming generate: 206 token frames then the 200 end
        frame, all on the persistent connection. Returns False when the
        connection must close (dead client — whose decode slot is freed
        via request.cancel()). Resumed streams start their frame
        indices at resume_offset, so the router's journal-based
        duplicate filter sees a gapless exactly-once index sequence."""
        rid = header.get("id")
        prompt = tensors[0] if tensors else header.get("prompt", ())
        root = self._request_root(header.get("trace"),
                                  header.get("model"),
                                  header.get("tenant", ""))
        tenant = header.get("tenant", "")
        done_doc = self._resume_noop(header)
        if done_doc is not None:
            # the relocated stream already committed its full contract
            # elsewhere — mint the terminal frame, no decode needed
            root.set_attribute("status", 200)
            root.finish()
            self._counters.inc("ok")
            try:
                conn.settimeout(self._write_timeout)
                wire.send_frame(conn, wire.encode_payload(
                    wire.end_frame(rid, done_doc), []))
            except (wire.WireError, socket.timeout, OSError):
                return False
            return True
        req, reject = self._submit_generate(header, prompt, root)
        if reject is not None:
            status, doc = reject
            root.set_attribute("status", status)
            root.finish()
            doc = dict(doc)
            doc.update({"status": status, "id": rid})
            try:
                conn.settimeout(self._write_timeout)
                wire.send_frame(conn, wire.encode_payload(doc, []))
            except (wire.WireError, socket.timeout, OSError):
                return False
            return True
        keep = True
        try:
            idx = int(getattr(req, "resume_offset", 0) or 0)
            for tok in req.stream(timeout=self._read_timeout):
                try:
                    conn.settimeout(self._write_timeout)
                    # chaos: a stream-write fault is a client that went
                    # away mid-generation — its slot MUST free up for
                    # the next queued request
                    inject_point("generation.stream_write", tag="wire")
                    wire.send_frame(conn, wire.encode_payload(
                        wire.token_frame(rid, tok, idx), []))
                    self._counters.inc("stream_frames")
                except (FaultError, wire.WireError, socket.timeout,
                        OSError):
                    self._counters.inc("stream_faults")
                    req.cancel()
                    keep = False
                    break
                idx += 1
            if keep:
                res = req.result(timeout=self._read_timeout)
                doc = {"model": header.get("model"),
                       "tokens": res["tokens"],
                       "stop_cause": res["stop_cause"],
                       "ttft_ms": None if res["ttft_s"] is None
                       else res["ttft_s"] * 1e3,
                       "tenant": tenant}
                if root.trace_id is not None:
                    doc["trace_id"] = obs_trace.format_id(root.trace_id)
                root.set_attribute("status", 200)
                self._counters.inc("ok")
                try:
                    conn.settimeout(self._write_timeout)
                    inject_point("generation.stream_write", tag="wire")
                    wire.send_frame(conn, wire.encode_payload(
                        wire.end_frame(rid, doc), []))
                except (FaultError, wire.WireError, socket.timeout,
                        OSError):
                    self._counters.inc("stream_faults")
                    keep = False
        except ServingError as e:
            self._counters.inc("errors")
            try:
                conn.settimeout(self._write_timeout)
                wire.send_frame(conn, wire.encode_payload(
                    {"status": 503, "error": str(e), "id": rid}, []))
            except (wire.WireError, socket.timeout, OSError):
                keep = False
        finally:
            if not req.done():
                req.cancel()
            self.admission.release(tenant)
            root.finish()
        return keep

    def _http_generate(self, conn, name, body):
        """POST /v1/models/<name>:generate — chunked HTTP streaming:
        one JSON line per token, a terminal line with the full result."""
        try:
            doc = json.loads(body or b"{}")
            prompt = doc.get("inputs") or ()
        except (ValueError, TypeError) as e:
            self._write_http(conn, 400, {"error": f"bad JSON body: {e}"})
            return
        header = dict(doc)
        header["model"] = name
        root = self._request_root(doc.get("trace"), name,
                                  doc.get("tenant", ""))
        tenant = doc.get("tenant", "")
        req, reject = self._submit_generate(header, prompt, root)
        if reject is not None:
            status, rdoc = reject
            root.set_attribute("status", status)
            root.finish()
            self._write_http(conn, status, rdoc)
            return
        try:
            conn.settimeout(self._write_timeout)
            wire.send_all(conn, wire.http_chunked_head())
            idx = int(getattr(req, "resume_offset", 0) or 0)
            for tok in req.stream(timeout=self._read_timeout):
                try:
                    conn.settimeout(self._write_timeout)
                    inject_point("generation.stream_write", tag="http")
                    wire.send_all(conn, wire.http_chunk(
                        {"token": int(tok), "index": idx}))
                    self._counters.inc("stream_frames")
                except (FaultError, wire.WireError, socket.timeout,
                        OSError):
                    self._counters.inc("stream_faults")
                    req.cancel()
                    return
                idx += 1
            res = req.result(timeout=self._read_timeout)
            tail = {"done": True, "tokens": res["tokens"],
                    "stop_cause": res["stop_cause"],
                    "ttft_ms": None if res["ttft_s"] is None
                    else res["ttft_s"] * 1e3}
            if root.trace_id is not None:
                tail["trace_id"] = obs_trace.format_id(root.trace_id)
            root.set_attribute("status", 200)
            self._counters.inc("ok")
            wire.send_all(conn, wire.http_chunk(tail))
            wire.send_all(conn, wire.http_chunk_end())
        except ServingError as e:
            self._counters.inc("errors")
            try:
                wire.send_all(conn, wire.http_chunk(
                    {"done": True, "error": str(e)}))
                wire.send_all(conn, wire.http_chunk_end())
            except (wire.WireError, socket.timeout, OSError):
                pass
        except (wire.WireError, socket.timeout, OSError):
            self._counters.inc("stream_faults")
            req.cancel()
        finally:
            if not req.done():
                req.cancel()
            self.admission.release(tenant)
            root.finish()

    def _write_http(self, conn, status, doc, extra=()):
        try:
            conn.settimeout(self._write_timeout)
            wire.send_all(conn, wire.http_response(status, doc, extra))
        except (wire.WireError, socket.timeout, OSError):
            self._counters.inc("write_faults")

    # -- the shared infer path -----------------------------------------
    def _do_infer(self, model, version, feed, tenant, priority,
                  deadline_ms, trace_parent=None):
        """Admission → route → submit → await. Returns (status, response
        doc, output arrays). Every rejection is an early, explicit
        status with a Retry-After hint — never a silent drop.

        The whole path runs under a `gateway.request` span parented to
        the wire's trace context (`trace_parent`, the header's "trace"
        field), with an admission child span here and queue/execute
        children in the pool — one connected tree per request under one
        trace_id. The response doc echoes the trace_id back. Spans are
        explicit start/finish with explicit parents (no contextvar
        round-trips): this is the serving hot path, and on a GIL-bound
        host every microsecond here multiplies by the number of
        concurrently-arriving requests in a batch window."""
        if trace_parent is not None:
            root = obs_trace.start_span("gateway.request",
                                        parent=trace_parent,
                                        attrs={"model": model or "",
                                               "tenant": tenant})
        else:
            # unracy-enough tick: sampling is statistical, an off-by-
            # one under a write race only shifts WHICH request roots
            self._trace_tick += 1
            if self._trace_tick % self._trace_every == 0:
                root = obs_trace.start_span(
                    "gateway.request",
                    attrs={"model": model or "", "tenant": tenant,
                           "sampled": True})
            else:
                root = obs_trace.noop_span()
        try:
            status, doc, outs = self._do_infer_traced(
                model, version, feed, tenant, priority, deadline_ms,
                root)
            root.set_attribute("status", status)
            if root.trace_id is not None:
                doc = dict(doc)
                doc["trace_id"] = obs_trace.format_id(root.trace_id)
            return status, doc, outs
        finally:
            root.finish()

    def _do_infer_traced(self, model, version, feed, tenant, priority,
                         deadline_ms, root):
        if self._closing.is_set():
            return self._draining_reject()
        if not model:
            return 400, {"error": "missing model name"}, []
        if not feed:
            return 400, {"error": "empty feed"}, []
        try:
            rows = max(int(np.asarray(a).shape[0]) if
                       np.asarray(a).ndim else 1 for a in feed.values())
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad feed arrays: {e}"}, []

        # route first (cheap dict read) so admission prices the RIGHT
        # server's queue depth
        try:
            rec = self.registry.resolve(model, version)
        except UnknownModelError as e:
            return 404, {"error": str(e)}, []
        srv = rec.server

        now = self._clock()
        deadline_s = None if deadline_ms is None else \
            now + float(deadline_ms) / 1e3
        adm_span = obs_trace.start_span(
            "gateway.admission", parent=root,
            attrs={"tenant": tenant, "rows": rows,
                   "queue_depth": srv.queue_depth})
        decision = self.admission.admit(
            tenant, rows=rows, priority=priority,
            deadline_s=deadline_s, queue_depth=srv.queue_depth,
            now=now)
        adm_span.set_attribute("admitted", bool(decision))
        if not decision:
            adm_span.set_attribute("reason", decision.reason)
        adm_span.finish()
        if not decision:
            self._counters.inc("rejected")
            return decision.status, {
                "error": decision.reason, "tenant": tenant,
                "retry_after_s": decision.retry_after_s}, []

        try:
            req = self._submit_rerouted(model, version, feed,
                                        deadline_ms, decision.priority,
                                        tenant,
                                        trace_ctx=root.context())
            if req is None:
                self._counters.inc("rejected")
                return self._draining_reject()
            budget = None
            if deadline_ms is not None:
                budget = float(deadline_ms) / 1e3 + 0.5
            outs = req.result(timeout=budget)
            latency = self._clock() - now
            self.admission.observe(latency)
            self._counters.inc("ok")
            return 200, {"model": model,
                         "version": self.registry.active_version(model)
                         if version is None else str(version),
                         "latency_ms": latency * 1e3,
                         "tenant": tenant}, [np.asarray(o) for o in outs]
        except QueueFullError:
            self._counters.inc("rejected")
            return 503, {"error": "server queue full", "tenant": tenant,
                         "retry_after_s":
                             self.admission.estimated_completion_s(1)
                             or 0.05}, []
        except RequestTimeout as e:
            self._counters.inc("rejected")
            return 408, {"error": str(e), "tenant": tenant,
                         "retry_after_s": None}, []
        except ServingError as e:
            self._counters.inc("errors")
            return 503, {"error": str(e), "tenant": tenant,
                         "retry_after_s": 0.05}, []
        except Exception as e:
            self._counters.inc("errors")
            return 500, {"error": f"{type(e).__name__}: {e}",
                         "tenant": tenant}, []
        finally:
            self.admission.release(tenant)

    def _submit_rerouted(self, model, version, feed, deadline_ms,
                         priority, tenant, trace_ctx=None):
        """submit() with hot-swap rerouting: ServerClosed from a server
        that is draining means a cutover won the race — re-resolve the
        active version and resubmit (bounded attempts). A full queue
        gives one preemption attempt to priority traffic before the 503
        surfaces. Returns None only when the GATEWAY itself is
        draining."""
        last = None
        for _ in range(_REROUTE_ATTEMPTS):
            try:
                rec = self.registry.resolve(model, version)
            except UnknownModelError:
                if self._closing.is_set():
                    return None
                raise
            try:
                return rec.server.submit(feed, timeout_ms=deadline_ms,
                                         priority=priority,
                                         tenant=tenant,
                                         trace_ctx=trace_ctx)
            except ServerClosed as e:
                if self._closing.is_set():
                    return None
                # the resolved server closed under us: a hot-swap is
                # mid-drain. Loop: resolve() now returns the new active.
                self._counters.inc("rerouted_submits")
                last = e
                continue
            except QueueFullError:
                if priority and rec.server.try_preempt(priority):
                    self._counters.inc("preemptions")
                    return rec.server.submit(feed,
                                             timeout_ms=deadline_ms,
                                             priority=priority,
                                             tenant=tenant,
                                             trace_ctx=trace_ctx)
                raise
        raise last or ServerClosed("server closed across reroutes")

    def _draining_reject(self):
        """503 while the gateway drains, carrying shutdown()'s undrained
        count so supervisors can see what the drain left behind."""
        undrained = None
        if self._final_report is not None:
            undrained = self._final_report.get("undrained_requests")
        return 503, {"error": "gateway draining",
                     "undrained_requests": undrained,
                     "retry_after_s": 1.0}, []

    # -- observability -------------------------------------------------
    def stats(self):
        lat = self._wire_latency.eval()
        doc = {
            "address": list(self.address),
            "closing": self._closing.is_set(),
            "counters": self._counters.eval(),
            "wire_latency_ms": {
                "count": lat["count"], "mean": lat["mean"] * 1e3,
                "p50": lat["p50"] * 1e3, "p99": lat["p99"] * 1e3},
            "admission": self.admission.stats(),
            "registry": self.registry.stats(),
            "slo_firing": self.slo.firing(),
            "servers": {},
        }
        with self._gen_mu:
            gens = dict(self._generators)
        if gens:
            doc["generators"] = {n: g.stats() for n, g in gens.items()}
        for name, info in self.registry.models().items():
            active = info["active"]
            if active is None:
                continue
            try:
                doc["servers"][name] = self.registry.resolve(
                    name).server.stats()
            except (UnknownModelError, ServingError):
                pass
        if self._final_report is not None:
            doc["final_drain"] = self._final_report
        return doc
