"""Fleet router: the front tier in front of N backend processes.

Counterpart of paddle_tpu/fleet/router.py. Speaks the SAME two protocols
as a single backend — PTGW binary frames and HTTP/1.1, sniffed from the
first four bytes on one port (`serving/wire.py` framing) — so existing
`GatewayClient` / curl clients, of either package, point at the router
unchanged. The router never touches the card: it relays bytes, and
importing it or running it as a process creates no CUDA context.

Routing policy
--------------
* **least-loaded**: each request goes to the selectable backend with the
  lowest ``(1 + router in-flight + reported queue_depth) x
  health_penalty``. Queue depth and verdicts arrive pushed in every
  heartbeat's load doc and pulled by a background poller hitting each
  backend's `/healthz` + `/stats`.
* **degraded-before-failed**: a backend whose `/healthz` verdict is
  "degraded"/"unhealthy", or whose liveness state is SUSPECT, is
  penalized multiplicatively — load shifts away BEFORE the failure.
* **session affinity**: `op=generate` requests carrying a ``session``
  key are routed through a consistent-hash ring (blake2b, 64 virtual
  points per backend, the JAX package's ring: a session lands on the
  same backend name in both packages), so a stream lands on the backend
  that holds its KV slot.
* **re-route, don't fail**: a dead backend is undialed; in-flight
  *idempotent* requests (infer/ping/stats) are replayed against the next
  backend, bounded by PT_FLAGS_fleet_reroute_attempts. The raw payload
  is relayed verbatim, so a replay is byte-identical.
* **stream failover**: the router JOURNALS every token frame it relays;
  when the backend dies mid-stream the journal rides a
  `resume_committed` re-dispatch to a peer, whose gateway rebuilds the
  slot from the committed tokens (a prefill of the prompt plus the
  journal) and streams frames from the journal offset. Frames below the
  journal length are dropped and the terminal frame's token list is
  merged with the journal: the client observes one exactly-once
  sequence.
* **HA pair + epoch fencing**: a router runs active or standby. A
  standby processes membership traffic (its directory stays warm) but
  answers forwards with 503 ``standby`` + retry_after until `promote()`.
  Every membership reply carries the router's ``epoch``; backends stamp
  the highest epoch seen into every beat/announce. An ACTIVE router
  seeing a HIGHER epoch has been superseded and fences itself (410 to
  everything, every live connection closed); an announce stamped with a
  LOWER epoch is refused 410. Clients resume torn streams from their
  own journal (`serving/wire.py` GatewayClient) through the same
  `resume_committed` path.

Chaos sites: ``fleet.dial``, ``fleet.forward``, ``fleet.heartbeat``,
``fleet.stream_resume``, ``fleet.takeover``.
"""
import bisect
import collections
import hashlib
import socket
import threading
import time

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.fleet.discovery import FleetDirectory
from paddle_tpu_torch.reliability.faults import FaultError, inject_point
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.utils.metrics import Counter, LatencyStat

__all__ = ["FleetRouter", "NoBackendError", "HashRing", "IDEMPOTENT_OPS"]

#: ops safe to replay against another backend (one response frame, no
#: server-side state created before the response): the reconnect /
#: re-route idempotency classification.
IDEMPOTENT_OPS = ("infer", "ping", "stats")


class NoBackendError(RuntimeError):
    """No selectable backend left for a request."""


class HashRing:
    """Consistent-hash ring: `points` virtual nodes per member so a
    membership change remaps only ~1/N of the keyspace."""

    def __init__(self, points=64):
        self._points = int(points)
        self._ring = []               # sorted (hash, name)

    @staticmethod
    def _hash(key):
        return int.from_bytes(
            hashlib.blake2b(key.encode("utf-8"),
                            digest_size=8).digest(), "big")

    def rebuild(self, names):
        ring = []
        for name in names:
            for i in range(self._points):
                ring.append((self._hash(f"{name}#{i}"), name))
        ring.sort()
        self._ring = ring

    def lookup(self, key, allowed=None):
        """First member at/after hash(key), restricted to `allowed`."""
        ring = self._ring
        if not ring:
            return None
        h = self._hash(key)
        start = bisect.bisect_left(ring, (h, ""))
        n = len(ring)
        for i in range(n):
            _, name = ring[(start + i) % n]
            if allowed is None or name in allowed:
                return name
        return None


class FleetRouter:
    """The fleet's single dial-in address.

    >>> router = FleetRouter()
    >>> host, port = router.start()
    >>> # backends announce themselves (fleet/backend.py heartbeater)
    >>> c = wire.GatewayClient(host, port)    # clients are unchanged
    >>> outs, resp = c.infer("m", {"x": x})
    """

    def __init__(self, directory=None, host="127.0.0.1", port=0,
                 read_timeout_s=30.0, write_timeout_s=10.0,
                 backend_timeout_s=30.0, poll_interval_s=None,
                 reroute_attempts=None, affinity_points=64,
                 clock=time.monotonic, slo_engine=None,
                 max_frame_bytes=wire.MAX_FRAME_BYTES,
                 epoch=1, standby=False, name="router"):
        self.directory = directory or FleetDirectory(clock=clock)
        self.name = str(name)
        self.epoch = int(epoch)
        self._epoch_seen = self.epoch  # highest epoch observed anywhere
        self._standby = bool(standby)
        self._fenced = False
        self._fenced_by = None
        self._host, self._port = host, int(port)
        self._read_timeout = read_timeout_s
        self._write_timeout = write_timeout_s
        self._backend_timeout = backend_timeout_s
        self._max_frame = max_frame_bytes
        self._clock = clock
        self._poll_interval = float(
            poll_interval_s if poll_interval_s is not None
            else _flags.get_flag("fleet_poll_interval_s"))
        self._reroute_attempts = int(
            reroute_attempts if reroute_attempts is not None
            else _flags.get_flag("fleet_reroute_attempts"))
        if slo_engine is None:
            from paddle_tpu_torch.observability.slo import (
                SloEngine, default_serving_specs,
            )
            slo_engine = SloEngine(default_serving_specs(), clock=clock)
        self.slo = slo_engine
        self._counters = Counter("fleet_router", (
            "connections", "wire_frames", "http_requests",
            "routed", "rerouted", "forward_failures", "failed",
            "stream_routed", "stream_rerouted", "stream_failed",
            "stream_resumed", "stream_dup_dropped",
            "affinity_hits", "heartbeats", "dropped_heartbeats",
            "announces", "stale_beats", "polls", "poll_errors",
            "dials", "undialed", "takeovers", "fenced_requests",
            "stale_announces", "standby_rejected", "peer_beats",
            "adopted"))
        # client-perceived forward latency exports to the SAME
        # pt_gateway_wire_latency_s family a gateway uses, so the
        # default wire-latency SLO (and its burn alerts, the
        # autoscaler's trigger) reads router-side latency unchanged
        self._wire_latency = LatencyStat("gateway_wire_latency_s")
        self._ring = HashRing(points=affinity_points)
        self._served = {}             # name -> responses served
        self._in_flight = {}          # name -> router-side in-flight
        self._load_mu = make_lock("fleet.router.load")
        self._stream_socks = {}       # name -> in-stream backend socks
        self._stream_mu = make_lock("fleet.router.streams")
        self._local = threading.local()
        self._listener = None
        self._accept_thread = None
        self._poll_thread = None
        self._conn_threads = set()
        self._client_conns = set()    # live accepted sockets (fencing
        self._conn_mu = make_lock("fleet.router.conns")  # closes them)
        # the newest stream failovers: which stream moved where, and
        # how many committed tokens rode the re-dispatch
        self._resumes = collections.deque(maxlen=64)
        self._peers = {}              # peer router name -> last beat doc
        self._peer_mu = make_lock("fleet.router.peers")
        self._closing = threading.Event()
        self.directory.on_join(lambda rec: self._rebuild_ring())
        self.directory.on_evict(self._on_backend_evicted)
        self.directory.extra_state(
            "router", lambda: {"epoch": self.epoch, "name": self.name})

    # -- lifecycle -----------------------------------------------------
    def start(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(64)
        s.settimeout(0.1)
        self._listener = s
        self._port = s.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pt-fleet-accept",
            daemon=True)
        self._accept_thread.start()
        if self._poll_interval > 0:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="pt-fleet-poller",
                daemon=True)
            self._poll_thread.start()
        self.directory.start_sweeper()
        self.slo.start()
        return self._host, self._port

    @property
    def address(self):
        return self._host, self._port

    def shutdown(self, timeout_s=10.0):
        self._closing.set()
        self.slo.stop()
        self.directory.stop_sweeper()
        deadline = self._clock() + timeout_s
        if self._accept_thread is not None:
            self._accept_thread.join(max(deadline - self._clock(), 0.1))
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._poll_thread is not None:
            self._poll_thread.join(max(deadline - self._clock(), 0.1))
        with self._conn_mu:
            threads = list(self._conn_threads)
        for t in threads:
            t.join(max(deadline - self._clock(), 0.0))
        return self.stats()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- membership plumbing -------------------------------------------
    def _rebuild_ring(self):
        self._ring.rebuild(self.directory.names())

    def _on_backend_evicted(self, snap):
        """Undial: forget the ring points and per-backend accounting.
        Cached sockets live in conn-thread locals; they are pruned at
        the next pick (an evicted name is never selectable again).
        Sockets mid-stream against the LOST backend are closed HERE so
        their relay threads unblock immediately and fail over, instead
        of waiting out the backend read timeout."""
        self._counters.inc("undialed")
        self._rebuild_ring()
        with self._load_mu:
            self._in_flight.pop(snap["name"], None)
        with self._stream_mu:
            socks = self._stream_socks.pop(snap["name"], None) or ()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    # -- accept / sniff (the gateway's discipline, verbatim) -----------
    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._counters.inc("connections")
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(conn, peer),
                name=f"pt-fleet-conn-{peer[1]}", daemon=True)
            with self._conn_mu:
                self._conn_threads.add(t)
            t.start()

    def _serve_conn(self, conn, peer):
        with self._conn_mu:
            self._client_conns.add(conn)
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
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_mu:
                self._client_conns.discard(conn)
                self._conn_threads.discard(threading.current_thread())

    # -- binary protocol ------------------------------------------------
    def _serve_binary(self, conn):
        while not self._closing.is_set():
            try:
                conn.settimeout(self._read_timeout)
                payload = wire.recv_frame(conn, self._max_frame)
            except (socket.timeout, wire.WireError, OSError):
                return
            if payload is None:
                return
            self._counters.inc("wire_frames")
            t0 = self._clock()
            try:
                header = wire.peek_header(payload)
            except wire.WireError as e:
                self._reply(conn, {"status": 400, "error": str(e)})
                continue
            op = header.get("op")
            if op in ("fleet.announce", "fleet.heartbeat",
                      "fleet.peer"):
                if not self._reply(conn, self._handle_membership(
                        op, header, conn=conn)):
                    return
                continue
            if self._fenced:
                # a superseded ex-active refuses every forward: the
                # client's journal resumes the stream on the new epoch
                self._counters.inc("fenced_requests")
                if not self._reply(conn, {
                        "status": 410, "id": header.get("id"),
                        "event": "fenced", "epoch": self._fenced_by,
                        "error": "router fenced (superseded by epoch "
                                 f"{self._fenced_by})"}):
                    return
                continue
            if self._standby:
                # membership keeps the standby's directory warm, but
                # forwards wait for promotion — clients retry
                self._counters.inc("standby_rejected")
                if not self._reply(conn, {
                        "status": 503, "id": header.get("id"),
                        "error": "router standby (not promoted)",
                        "event": "standby", "retry_after_s": 0.2}):
                    return
                continue
            if op == "generate":
                if not self._forward_stream(conn, payload, header):
                    return
                self._wire_latency.update(self._clock() - t0)
                continue
            if op in IDEMPOTENT_OPS:
                resp_payload = self._forward_idempotent(payload, header)
                try:
                    conn.settimeout(self._write_timeout)
                    wire.send_frame(conn, resp_payload)
                except (socket.timeout, wire.WireError, OSError):
                    return
                self._wire_latency.update(self._clock() - t0)
                continue
            if not self._reply(conn, {"status": 400,
                                      "id": header.get("id"),
                                      "error": f"unknown op {op!r}"}):
                return

    def _reply(self, conn, header, tensors=()):
        try:
            conn.settimeout(self._write_timeout)
            wire.send_frame(conn, wire.encode_payload(header, tensors))
            return True
        except (socket.timeout, wire.WireError, OSError):
            return False

    def _handle_membership(self, op, header, conn=None):
        name = header.get("name")
        rid = header.get("id")
        if not name:
            return {"status": 400, "id": rid, "error": "missing name"}
        stamped = header.get("epoch")
        if stamped is not None:
            stamped = int(stamped)
            if stamped > self._epoch_seen:
                self._epoch_seen = stamped
            if stamped > self.epoch and not self._standby:
                # a beat carrying a HIGHER epoch proves a promoted
                # router exists: this active has been superseded —
                # fence NOW, before another frame is forwarded (but
                # keep the delivering conn open so the sender gets
                # its 410 and learns WHY)
                self._fence(stamped, exclude=conn)
        if self._fenced:
            return {"status": 410, "id": rid, "event": "fenced",
                    "epoch": self._fenced_by}
        if op == "fleet.peer":
            # a standby announcing itself to the active (the HA pair's
            # own heartbeat); the reply teaches it the fleet epoch
            with self._peer_mu:
                self._peers[name] = {
                    "address": header.get("address"),
                    "epoch": stamped, "rank": header.get("rank"),
                    "last_seen": self._clock()}
            self._counters.inc("peer_beats")
            return {"status": 200, "id": rid, "event": "peer",
                    "epoch": self.epoch, "role": self.role()}
        if op == "fleet.announce":
            if stamped is not None and stamped < self.epoch:
                # an announce from a STALE epoch: the zombie ex-active
                # (or a backend that hasn't heard the promotion yet)
                # is refused exactly like a zombie backend generation;
                # the reply's epoch lets a live sender catch up and
                # re-announce within one beat
                self._counters.inc("stale_announces")
                return {"status": 410, "id": rid,
                        "event": "stale-epoch", "epoch": self.epoch}
            self.directory.announce(name, tuple(header.get("address")),
                                    header.get("meta"),
                                    load=header.get("load"))
            self._counters.inc("announces")
            return {"status": 200, "id": rid, "event": "joined",
                    "epoch": self.epoch}
        # chaos: a heartbeat lost in the network — the beat is dropped
        # silently (the backend is fine, the DIRECTORY just doesn't
        # hear it), which is exactly how real beats go missing; enough
        # of them walks the FSM to SUSPECT → LOST.
        try:
            inject_point("fleet.heartbeat", tag=name)
        except FaultError:
            self._counters.inc("dropped_heartbeats")
            return {"status": 200, "id": rid, "event": "beat",
                    "epoch": self.epoch}
        if self.directory.beat(name, header.get("load")):
            self._counters.inc("heartbeats")
            return {"status": 200, "id": rid, "event": "beat",
                    "epoch": self.epoch}
        # a beat from an evicted/unknown generation: PS zombie
        # rejection — tell the backend to re-announce
        self._counters.inc("stale_beats")
        return {"status": 410, "id": rid, "event": "evicted",
                "epoch": self.epoch}

    # -- HA: roles, fencing, promotion ---------------------------------
    def role(self):
        if self._fenced:
            return "fenced"
        return "standby" if self._standby else "active"

    @property
    def fenced(self):
        return self._fenced

    @property
    def standby(self):
        return self._standby

    def _fence(self, new_epoch, exclude=None):
        """This router has been superseded (a beat carried a higher
        epoch): refuse everything from here on and close every live
        client connection and in-stream backend socket, so the
        zombie's streams tear NOW and clients fail over to the
        promoted router instead of waiting out read timeouts."""
        if self._fenced:
            return
        self._fenced = True
        self._fenced_by = int(new_epoch)
        with self._conn_mu:
            conns = [c for c in self._client_conns if c is not exclude]
        with self._stream_mu:
            socks = [s for ss in self._stream_socks.values()
                     for s in ss]
            self._stream_socks.clear()
        for s in conns + socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def promote(self, epoch=None):
        """Standby → active takeover. Picks an epoch strictly above
        everything this router has seen (replies, beats, the durable
        snapshot), re-adopts backends from the snapshot (the live ones
        also adopt-from-beats — whichever lands first wins), and
        persists the new epoch so a later restart keeps fencing the
        old one. Returns (epoch, adopted_names, extras) — the caller
        restores autoscaler state from extras. A `fleet.takeover`
        fault aborts THIS attempt; the standby monitor retries."""
        inject_point("fleet.takeover", tag=self.name)
        doc = None
        if self.directory.store is not None:
            doc, _seq = self.directory.store.load_latest()
        snap_epoch = 0
        if doc is not None:
            snap_epoch = int(
                (doc.get("extras") or {}).get("router", {})
                .get("epoch", 0))
        if epoch is None:
            epoch = max(self.epoch, self._epoch_seen, snap_epoch) + 1
        self.epoch = int(epoch)
        self._epoch_seen = max(self._epoch_seen, self.epoch)
        self._standby = False
        adopted, extras = ([], {})
        if doc is not None:
            adopted, extras = self.directory.adopt(doc)
        self._counters.inc("takeovers")
        self._counters.inc("adopted", len(adopted))
        self._rebuild_ring()
        self.directory.save_snapshot()
        return self.epoch, adopted, extras

    # -- backend selection ---------------------------------------------
    _STATE_PENALTY = {"LIVE": 1.0, "SUSPECT": 8.0}
    _VERDICT_PENALTY = {"degraded": 4.0, "unhealthy": 16.0}

    def _pick(self, exclude=(), session=None):
        recs = [r for r in self.directory.selectable()
                if r["name"] not in exclude]
        if not recs:
            raise NoBackendError("no selectable backend")
        if session:
            allowed = {r["name"] for r in recs}
            target = self._ring.lookup(str(session), allowed=allowed)
            if target is not None:
                self._counters.inc("affinity_hits")
                return next(r for r in recs if r["name"] == target)

        def score(rec):
            with self._load_mu:
                inflight = self._in_flight.get(rec["name"], 0)
            load = 1.0 + inflight + float(
                rec["load"].get("queue_depth", 0))
            mult = self._STATE_PENALTY.get(rec["state"], 8.0)
            mult *= self._VERDICT_PENALTY.get(rec["verdict"], 1.0)
            return load * mult

        return min(recs, key=lambda r: (score(r), r["name"]))

    # -- backend connections (cached per conn thread) ------------------
    def _conn_cache(self):
        cache = getattr(self._local, "conns", None)
        if cache is None:
            cache = self._local.conns = {}
        return cache

    def _dial(self, name, address):
        # chaos: fleet.dial models a connect that dies (SYN timeout,
        # RST) — the caller re-routes, it never surfaces upstream
        inject_point("fleet.dial", tag=name)
        s = socket.create_connection(tuple(address),
                                     timeout=self._backend_timeout)
        s.settimeout(self._backend_timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        wire.send_all(s, wire.MAGIC)
        self._counters.inc("dials")
        return s

    def _backend_sock(self, name, address, fresh=False):
        cache = self._conn_cache()
        if fresh:
            self._drop_conn(name)
        # prune conns to names the directory no longer knows (undial)
        known = set(self.directory.names())
        for stale in [n for n in cache if n not in known and n != name]:
            self._drop_conn(stale)
        sock = cache.get(name)
        if sock is None:
            sock = cache[name] = self._dial(name, address)
        return sock

    def _drop_conn(self, name):
        cache = self._conn_cache()
        sock = cache.pop(name, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _track(self, name, delta):
        with self._load_mu:
            cur = self._in_flight.get(name, 0) + delta
            if delta < 0 and cur <= 0:
                # release is symmetric with eviction: a decrement
                # landing after _on_backend_evicted popped the entry
                # must not resurrect it at -1, or a re-announced
                # backend with the same name inherits a permanently
                # skewed (favourable) load estimate in _pick
                self._in_flight.pop(name, None)
            else:
                self._in_flight[name] = cur

    # -- forwarding ----------------------------------------------------
    def _rpc(self, name, address, payload):
        """One request/response against a backend, re-dialing once if
        the CACHED connection turns out dead (stale persistent conns
        are indistinguishable from dead backends until used)."""
        for attempt, fresh in enumerate((False, True)):
            sock = self._backend_sock(name, address, fresh=fresh)
            was_cached = not fresh and attempt == 0
            try:
                # chaos: fleet.forward models the relay dying mid-send
                inject_point("fleet.forward", tag=name)
                self._track(name, +1)
                try:
                    wire.send_frame(sock, payload)
                    resp = wire.recv_frame(sock, self._max_frame)
                finally:
                    self._track(name, -1)
                if resp is None:
                    raise wire.WireError(
                        f"backend {name} closed mid-request")
                return resp
            except (wire.WireError, OSError):
                self._drop_conn(name)
                if not was_cached:
                    raise
                # fall through: retry once on a fresh dial

    def _forward_idempotent(self, payload, header):
        """Relay an idempotent request, re-routing across backends on
        transport failure. Returns the RESPONSE payload bytes (the
        backend's frame relayed verbatim, or a router-minted error)."""
        rid = header.get("id")
        tried = []
        last_err = None
        for _ in range(self._reroute_attempts):
            try:
                rec = self._pick(exclude=tried,
                                 session=header.get("session"))
            except NoBackendError as e:
                last_err = e
                break
            name = rec["name"]
            tried.append(name)
            try:
                resp = self._rpc(name, rec["address"], payload)
            except (FaultError, wire.WireError, OSError) as e:
                last_err = e
                self._counters.inc("forward_failures")
                self.directory.report_failure(name)
                continue
            self._counters.inc("routed")
            if len(tried) > 1:
                self._counters.inc("rerouted")
            with self._load_mu:
                self._served[name] = self._served.get(name, 0) + 1
            return resp
        self._counters.inc("failed")
        return wire.encode_payload(
            {"status": 503, "id": rid,
             "error": f"no backend served the request "
                      f"(tried {tried or 'none'}): {last_err}",
             "retry_after_s": 0.5}, [])

    def _resume_payload(self, payload, committed):
        """Rebuild the generate request carrying the journal: the peer
        gateway routes it through admit_resumed, conditioning the slot
        on the committed tokens (spill/prefix hits make that cheap)
        and streaming frames starting at the journal offset."""
        hdr, tensors = wire.decode_payload(payload)
        hdr.pop("tensors", None)
        hdr["resume_committed"] = [int(t) for t in committed]
        return wire.encode_payload(hdr, tensors)

    def _merge_end_frame(self, resp, prefix):
        """The terminal frame of a resumed stream carries only the
        peer's post-resume tokens; the client's contract is the full
        exactly-once sequence, so splice the journal AS IT STOOD AT
        RESUME DISPATCH back in front (the journal keeps growing while
        the peer streams — using it whole would double-count)."""
        hdr, tensors = wire.decode_payload(resp)
        if hdr.get("status") == 200:
            hdr["tokens"] = [int(t) for t in prefix] + [
                int(t) for t in (hdr.get("tokens") or ())]
            hdr["resumed"] = True
            hdr.pop("tensors", None)
            resp = wire.encode_payload(hdr, tensors)
        return resp

    def _forward_stream(self, client_conn, payload, header):
        """Relay a generation stream with journal-based failover.
        Affinity picks the backend; every token frame relayed to the
        client is journaled (its token value, in index order), so a
        backend dying mid-stream re-dispatches to a peer with
        ``resume_committed`` = the journal — the peer rebuilds the
        slot and streams frames past the journal offset. Frames whose
        index falls below the journal length are dropped, and the
        terminal frame's token list is merged with the journal: the
        client observes an exactly-once sequence. Returns False when
        the CLIENT side died."""
        rid = header.get("id")
        session = (header.get("session") or header.get("tenant")
                   or None)
        tried = []
        last_err = None
        # journal: token values the client holds. A client-dispatched
        # resume (its own journal riding in resume_committed after a
        # ROUTER death) seeds it, so a backend dying mid-resume
        # re-dispatches the FULL prefix, not just the local suffix —
        # and the merged end frame carries the whole sequence.
        committed = [int(t)
                     for t in (header.get("resume_committed") or ())]
        for _ in range(self._reroute_attempts):
            if self._fenced:
                break     # superseded mid-stream: never re-dispatch
            try:
                rec = self._pick(exclude=tried, session=session)
            except NoBackendError as e:
                last_err = e
                break
            name = rec["name"]
            tried.append(name)
            try:
                out = payload
                resume_base = len(committed)
                if committed:
                    # mid-stream failover: re-dispatch with journal
                    inject_point("fleet.stream_resume", tag=name)
                    out = self._resume_payload(payload, committed)
                    self._counters.inc("stream_resumed")
                    self._resumes.append({
                        "id": rid, "backend": name,
                        "failed": tried[:-1], "committed": resume_base,
                        "t": self._clock()})
                sock = self._backend_sock(name, rec["address"])
                inject_point("fleet.forward", tag=name)
                self._track(name, +1)
                with self._stream_mu:
                    self._stream_socks.setdefault(
                        name, set()).add(sock)
                try:
                    wire.send_frame(sock, out)
                    while True:
                        resp = wire.recv_frame(sock, self._max_frame)
                        if resp is None:
                            raise wire.WireError(
                                f"backend {name} closed mid-stream")
                        rhdr = wire.peek_header(resp)
                        status = rhdr.get("status")
                        if status == 206:
                            idx = rhdr.get("index")
                            if (idx is not None
                                    and int(idx) < len(committed)):
                                # a peer replaying past the offset:
                                # the client already holds this token
                                self._counters.inc(
                                    "stream_dup_dropped")
                                continue
                        else:
                            if status == 200 and resume_base:
                                resp = self._merge_end_frame(
                                    resp, committed[:resume_base])
                            # account BEFORE relaying the end frame so
                            # the stream is visible in stats() the
                            # moment the client sees end-of-stream
                            self._counters.inc("stream_routed")
                            if len(tried) > 1:
                                self._counters.inc("stream_rerouted")
                            with self._load_mu:
                                self._served[name] = (
                                    self._served.get(name, 0) + 1)
                        try:
                            client_conn.settimeout(self._write_timeout)
                            wire.send_frame(client_conn, resp)
                        except (socket.timeout, wire.WireError,
                                OSError):
                            return False      # client gone
                        if status != 206:
                            return True
                        committed.append(int(rhdr.get("token")))
                finally:
                    self._track(name, -1)
                    with self._stream_mu:
                        socks = self._stream_socks.get(name)
                        if socks is not None:
                            socks.discard(sock)
                            if not socks:
                                self._stream_socks.pop(name, None)
            except (FaultError, wire.WireError, OSError) as e:
                last_err = e
                self._drop_conn(name)
                self._counters.inc("forward_failures")
                self.directory.report_failure(name)
                continue
        self._counters.inc("stream_failed")
        return self._reply(client_conn, {
            "status": 503, "id": rid,
            "error": f"no backend served the stream "
                     f"(tried {tried or 'none'}): {last_err}",
            "retry_after_s": 0.5})

    # -- HTTP ----------------------------------------------------------
    def _serve_http(self, conn, head):
        self._counters.inc("http_requests")
        try:
            parsed = wire.read_http_request(conn, prefix=head)
        except wire.WireError:
            return
        if parsed is None:
            return
        method, path, headers, body = parsed
        if method == "GET" and path == "/fleet":
            self._send_http(conn, 200, self.fleet_doc())
            return
        if method == "GET" and path == "/stats":
            self._send_http(conn, 200, self.stats())
            return
        if method == "GET" and path == "/healthz":
            n = len(self.directory.selectable())
            doc = {"ok": n > 0 and not self._fenced,
                   "role": "fleet-router",
                   "backends_selectable": n,
                   "status": "healthy" if n and not self._fenced
                   else "unhealthy",
                   "ha": self.ha_doc()}
            ok = doc["ok"] or self._standby
            self._send_http(conn, 200 if ok else 503, doc)
            return
        if method == "GET" and path == "/slo":
            self._send_http(conn, 200, self.slo.snapshot())
            return
        if method == "GET" and path == "/metrics":
            from paddle_tpu_torch.observability import metrics as obs_metrics
            self._send_http(conn, 200, wire.RawBody(
                obs_metrics.registry().prometheus_text(),
                content_type="text/plain; version=0.0.4; "
                             "charset=utf-8"))
            return
        if self._fenced:
            self._counters.inc("fenced_requests")
            self._send_http(conn, 410, {
                "error": "router fenced (superseded by epoch "
                         f"{self._fenced_by})",
                "event": "fenced", "epoch": self._fenced_by})
            return
        if self._standby:
            self._counters.inc("standby_rejected")
            self._send_http(conn, 503, {
                "error": "router standby (not promoted)",
                "event": "standby", "retry_after_s": 0.2})
            return
        # everything else (POST :infer / :generate, GET /models...) is
        # relayed verbatim to a backend: HTTP conns are one-shot
        # (Connection: close), so a byte-level relay is protocol-exact
        self._relay_http(conn, method, path, headers, body)

    def _send_http(self, conn, status, doc):
        try:
            conn.settimeout(self._write_timeout)
            wire.send_all(conn, wire.http_response(status, doc))
        except (socket.timeout, wire.WireError, OSError):
            pass

    def _relay_http(self, client_conn, method, path, headers, body):
        req = (f"{method} {path} HTTP/1.1\r\n"
               f"Host: fleet\r\n"
               f"Content-Length: {len(body)}\r\n"
               f"Connection: close\r\n\r\n"
               ).encode("latin-1") + body
        idempotent = not path.endswith(":generate")
        tried = []
        last_err = None
        attempts = self._reroute_attempts if idempotent else 1
        for _ in range(attempts):
            try:
                rec = self._pick(exclude=tried)
            except NoBackendError as e:
                last_err = e
                break
            name = rec["name"]
            tried.append(name)
            relayed_any = False
            try:
                inject_point("fleet.dial", tag=name)
                inject_point("fleet.forward", tag=name)
                self._track(name, +1)
                try:
                    with socket.create_connection(
                            tuple(rec["address"]),
                            timeout=self._backend_timeout) as bs:
                        bs.settimeout(self._backend_timeout)
                        wire.send_all(bs, req)
                        while True:
                            chunk = bs.recv(1 << 16)
                            if not chunk:
                                break
                            client_conn.settimeout(
                                self._write_timeout)
                            try:
                                wire.send_all(client_conn, chunk)
                            except (wire.WireError, OSError):
                                return          # client gone
                            relayed_any = True
                finally:
                    self._track(name, -1)
                if not relayed_any:
                    raise wire.WireError(
                        f"backend {name} closed without a response")
                self._counters.inc("routed")
                if len(tried) > 1:
                    self._counters.inc("rerouted")
                with self._load_mu:
                    self._served[name] = self._served.get(name, 0) + 1
                return
            except (FaultError, wire.WireError, OSError) as e:
                last_err = e
                self._counters.inc("forward_failures")
                self.directory.report_failure(name)
                if relayed_any:
                    return      # torn mid-response; nothing to mend
                continue
        self._counters.inc("failed")
        self._send_http(client_conn, 503, {
            "error": f"no backend served the request "
                     f"(tried {tried or 'none'}): {last_err}",
            "retry_after_s": 0.5})

    # -- the poller (pull side of the load/health picture) -------------
    def _poll_loop(self):
        while not self._closing.wait(self._poll_interval):
            for rec in self.directory.selectable():
                if self._closing.is_set():
                    return
                host, port = rec["address"]
                try:
                    _, health, _ = wire.http_request(
                        host, port, "GET", "/healthz", timeout=5.0)
                    _, st, _ = wire.http_request(
                        host, port, "GET", "/stats", timeout=5.0)
                    queue_depth = sum(
                        int(s.get("queue_depth", 0))
                        for s in (st or {}).get("servers", {})
                        .values())
                    self.directory.observe(
                        rec["name"],
                        verdict=(health or {}).get("status"),
                        load={"queue_depth": queue_depth})
                    self._counters.inc("polls")
                except (wire.WireError, OSError, ValueError,
                        KeyError, TypeError):
                    # an unpollable backend is suspect exactly like an
                    # unforwardable one
                    self._counters.inc("poll_errors")
                    self.directory.report_failure(rec["name"])

    # -- observability -------------------------------------------------
    def ha_doc(self, fresh_s=5.0):
        """The HA-pair slice of /healthz: role, epoch, fencing, and the
        router-pair factor (an unpaired active is a fleet one process
        death away from losing its front tier — degraded, not down)."""
        from paddle_tpu_torch.observability.health import router_pair_factor
        now = self._clock()
        with self._peer_mu:
            ages = [now - p["last_seen"] for p in self._peers.values()]
            peers = {n: {"epoch": p["epoch"], "rank": p["rank"],
                         "age_s": now - p["last_seen"]}
                     for n, p in self._peers.items()}
        factor, verdict = router_pair_factor(ages, fresh_s=fresh_s)
        return {"name": self.name, "role": self.role(),
                "epoch": self.epoch, "fenced": self._fenced,
                "fenced_by": self._fenced_by,
                "peers": peers, "pair_factor": factor,
                "pair": verdict}

    def fleet_doc(self):
        with self._load_mu:
            in_flight = dict(self._in_flight)
            served = dict(self._served)
        return {"directory": self.directory.snapshot(),
                "in_flight": in_flight,
                "served": served,
                "counters": self._counters.eval(),
                "stream_resumes": list(self._resumes)}

    def served_by(self):
        with self._load_mu:
            return dict(self._served)

    def stats(self):
        lat = self._wire_latency.eval()
        with self._load_mu:
            in_flight = dict(self._in_flight)
        return {
            "address": list(self.address),
            "role": "fleet-router",
            "ha": self.ha_doc(),
            "backends": self.directory.names(),
            "counters": self._counters.eval(),
            "in_flight": in_flight,
            "served": self.served_by(),
            "wire_latency_ms": {
                "count": lat["count"], "mean": lat["mean"] * 1e3,
                "p50": lat["p50"] * 1e3, "p99": lat["p99"] * 1e3},
            "slo_firing": self.slo.firing(),
        }
