"""Gateway wire protocol: framing, tensor codec, and a client.

Counterpart of paddle_tpu/serving/wire.py, byte for byte: a JAX-package
client talks to the port's gateway and the port's client to the JAX
package's gateway. The gateway speaks two protocols on ONE port,
sniffed from the first four bytes of each connection:

* ``PTGW`` magic → the **binary** hot path: length-prefixed framing
  (little-endian u32 payload length, payload bounded at 256 MiB so a
  garbage/hostile length can never become a multi-GiB allocation,
  read/write loops that tolerate short socket transfers). One
  persistent connection carries many request/response frames.
* anything else → **HTTP/1.1 + JSON**: the same infer surface plus
  /healthz, /stats, /models and the admin endpoints, one request per
  connection.

Binary frame layout (all integers little-endian)::

    frame    := u32 payload_len | payload
    payload  := u32 header_len | header_json | tensor_bytes...

The JSON header describes the request/response (model, tenant, priority,
deadline, status, retry_after_ms) and the dtype/shape of every tensor
that follows; tensor bytes are raw C-order arrays concatenated in header
order. A tensor's dtype travels as its numpy name (`dtype.name`:
"float32", "int64", ...), decoded with `np.dtype(name)`, the JAX
codec's rule.

Trace propagation: a client inside an active span stamps its context
into the header's ``trace`` field (``{"trace_id", "span_id"}``) — same
field in the binary header and the HTTP JSON body — so the gateway's
server-side spans join the caller's trace tree; responses echo
``trace_id`` back.
"""
import json
import socket
import struct

import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import trace as obs_trace

#: Connection preamble selecting the binary protocol.
MAGIC = b"PTGW"

#: Frame bound, mirroring ps.cc kMaxPayload (256 MiB).
MAX_FRAME_BYTES = 256 << 20

_U32 = struct.Struct("<I")


class WireError(RuntimeError):
    """Malformed frame / protocol violation on the gateway wire."""


class GatewayError(RuntimeError):
    """A gateway request completed with a non-OK status."""

    def __init__(self, status, message, retry_after_s=None, detail=None):
        super().__init__(f"[{status}] {message}")
        self.status = int(status)
        self.message = message
        self.retry_after_s = retry_after_s
        self.detail = detail or {}


# --- byte-level helpers (WriteAll/ReadAll parity) ---------------------

def send_all(sock, data):
    """ps.cc WriteAll: loop until every byte is on the wire."""
    view = memoryview(data)
    while view:
        n = sock.send(view)
        if n <= 0:
            raise WireError("send returned <= 0 (peer gone)")
        view = view[n:]


def recv_exact(sock, n):
    """ps.cc ReadAll: read exactly `n` bytes or raise. An empty first
    read means orderly EOF and returns None so callers can distinguish
    'connection closed between frames' from 'torn mid-frame'."""
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 16))
        if not chunk:
            if got == 0:
                return None
            raise WireError(f"connection closed mid-read ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock, payload):
    enforce(len(payload) <= MAX_FRAME_BYTES,
            "frame payload %d bytes exceeds the %d-byte bound",
            len(payload), MAX_FRAME_BYTES)
    send_all(sock, _U32.pack(len(payload)) + payload)


def recv_frame(sock, max_bytes=MAX_FRAME_BYTES):
    """One framed payload, or None on orderly EOF before a new frame."""
    hdr = recv_exact(sock, 4)
    if hdr is None:
        return None
    (length,) = _U32.unpack(hdr)
    if length > max_bytes:
        raise WireError(
            f"frame length {length} exceeds the {max_bytes}-byte bound "
            f"(garbage or hostile peer)")
    if length == 0:
        return b""
    payload = recv_exact(sock, length)
    if payload is None:
        raise WireError("connection closed between frame header and body")
    return payload


# --- payload codec ----------------------------------------------------

def encode_payload(header, tensors=()):
    """header (JSON-able dict) + tensors (list of np arrays) → payload
    bytes. The tensor dtype/shape manifest is appended to the header as
    `tensors`; raw C-order bytes follow the header."""
    tensors = [np.ascontiguousarray(t) for t in tensors]
    header = dict(header)
    header["tensors"] = [{"dtype": t.dtype.name, "shape": list(t.shape)}
                         for t in tensors]
    hdr = json.dumps(header).encode("utf-8")
    parts = [_U32.pack(len(hdr)), hdr]
    parts.extend(t.tobytes() for t in tensors)
    return b"".join(parts)


def peek_header(payload):
    """Decode ONLY the JSON header of a payload, leaving tensor bytes
    untouched (a relay inspects op/model/session without materializing
    the tensors it forwards)."""
    if len(payload) < 4:
        raise WireError("payload shorter than its header-length prefix")
    (hlen,) = _U32.unpack(payload[:4])
    if 4 + hlen > len(payload):
        raise WireError("header length overruns the payload")
    try:
        return json.loads(payload[4:4 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise WireError(f"undecodable frame header: {e}")


def decode_payload(payload):
    """payload bytes → (header dict, list of np arrays)."""
    if len(payload) < 4:
        raise WireError("payload shorter than its header-length prefix")
    (hlen,) = _U32.unpack(payload[:4])
    if 4 + hlen > len(payload):
        raise WireError("header length overruns the payload")
    try:
        header = json.loads(payload[4:4 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise WireError(f"undecodable frame header: {e}")
    tensors = []
    off = 4 + hlen
    for spec in header.get("tensors", ()):
        try:
            dtype = np.dtype(spec["dtype"])
            shape = tuple(int(d) for d in spec["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise WireError(f"bad tensor spec {spec!r}: {e}")
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if off + nbytes > len(payload):
            raise WireError("tensor bytes overrun the payload")
        tensors.append(np.frombuffer(
            payload[off:off + nbytes], dtype=dtype).reshape(shape))
        off += nbytes
    if off != len(payload):
        raise WireError(f"{len(payload) - off} trailing bytes after the "
                        f"declared tensors")
    return header, tensors


# --- streaming (generation) ------------------------------------------
#
# Generation responses are MANY frames on the same connection: interim
# ``{"status": 206, "event": "token", "token": t, "index": i}`` frames
# (206 Partial Content — the stream is still open) followed by ONE
# terminal ``{"status": 200, "event": "end", "tokens": [...],
# "stop_cause": ...}`` frame, after which the connection is reusable
# for the next request. The HTTP mirror is chunked transfer encoding
# with one JSON line per chunk (see http_chunk_* helpers).

def token_frame(rid, token, index):
    return {"status": 206, "event": "token", "id": rid,
            "token": int(token), "index": int(index)}


def end_frame(rid, doc):
    out = {"status": 200, "event": "end", "id": rid}
    out.update(doc)
    return out


def http_chunked_head(status=200, content_type="application/json"):
    """Response head opening a chunked-transfer stream."""
    reason = {200: "OK"}.get(status, "Status")
    return (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Transfer-Encoding: chunked\r\n"
            f"Connection: close\r\n\r\n").encode("latin-1")


def http_chunk(doc):
    """One chunk carrying one JSON line."""
    body = (json.dumps(doc) + "\n").encode("utf-8")
    return f"{len(body):x}\r\n".encode("latin-1") + body + b"\r\n"


def http_chunk_end():
    return b"0\r\n\r\n"


def iter_http_chunks(sock, timeout=30.0):
    """Client side: yield each chunk's parsed JSON line from a chunked
    response whose head was already consumed."""
    buf = bytearray()

    def read_line():
        while b"\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                _raise_torn()
            buf.extend(chunk)
        line, _, rest = bytes(buf).partition(b"\r\n")
        del buf[:len(line) + 2]
        return line

    while True:
        size = int(read_line().split(b";")[0], 16)
        if size == 0:
            return
        while len(buf) < size + 2:
            chunk = sock.recv(4096)
            if not chunk:
                _raise_torn()
            buf.extend(chunk)
        body = bytes(buf[:size])
        del buf[:size + 2]
        yield json.loads(body)


# --- minimal HTTP/1.1 helpers ----------------------------------------

_MAX_HTTP_HEAD = 64 << 10


def read_http_request(sock, prefix=b"", max_body=MAX_FRAME_BYTES):
    """Parse one HTTP/1.1 request from `sock` (with `prefix` bytes
    already consumed by protocol sniffing). Returns (method, path,
    headers dict lower-cased, body bytes) or None on EOF."""
    buf = bytearray(prefix)
    while b"\r\n\r\n" not in buf:
        if len(buf) > _MAX_HTTP_HEAD:
            raise WireError("HTTP header section exceeds 64 KiB")
        chunk = sock.recv(4096)
        if not chunk:
            return None if not buf else (_raise_torn())
        buf.extend(chunk)
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, path, _version = lines[0].split(" ", 2)
    except ValueError:
        raise WireError(f"malformed HTTP request line {lines[0]!r}")
    headers = {}
    for line in lines[1:]:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length > max_body:
        raise WireError(f"HTTP body {length} bytes exceeds the bound")
    body = bytearray(rest)
    while len(body) < length:
        chunk = sock.recv(min(length - len(body), 1 << 16))
        if not chunk:
            _raise_torn()
        body.extend(chunk)
    return method, path, headers, bytes(body[:length])


def _raise_torn():
    raise WireError("connection closed mid-HTTP-request")


class RawBody:
    """Non-JSON HTTP response payload (the Prometheus /metrics text)."""

    def __init__(self, text, content_type="text/plain; charset=utf-8"):
        self.text = text
        self.content_type = content_type


def http_response(status, doc, extra_headers=()):
    """Serialize one HTTP/1.1 response (Connection: close): JSON for
    dict payloads, verbatim text for `RawBody` (GET /metrics)."""
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              408: "Request Timeout", 429: "Too Many Requests",
              500: "Internal Server Error",
              503: "Service Unavailable"}.get(status, "Status")
    if isinstance(doc, RawBody):
        body = doc.text.encode("utf-8")
        ctype = doc.content_type
    else:
        body = json.dumps(doc).encode("utf-8")
        ctype = "application/json"
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    head.extend(f"{k}: {v}" for k, v in extra_headers)
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def http_request(host, port, method, path, doc=None, timeout=10.0):
    """Tiny raw-socket HTTP client (tests/bench/ops tooling): returns
    (status int, parsed JSON body, headers dict)."""
    body = b"" if doc is None else json.dumps(doc).encode("utf-8")
    req = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
           f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
           ).encode("latin-1") + body
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        send_all(s, req)
        buf = bytearray()
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf.extend(chunk)
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ", 2)[1])
    headers = {}
    for line in lines[1:]:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    if not rest:
        return status, None, headers
    if "application/json" in headers.get("content-type", ""):
        return status, json.loads(rest), headers
    return status, rest.decode("utf-8"), headers


# --- binary client ----------------------------------------------------

#: Client ops safe to replay after a dropped connection: one request
#: frame → one response frame, no server-side state created before the
#: response exists. ``generate`` is NOT here — a blind replay re-runs
#: decode and double-bills tokens already streamed. Streams are
#: *resumable* instead: the client journals every 206 token frame it
#: receives and, on a torn connection, re-dials the next endpoint and
#: re-dispatches with ``resume_committed`` = its own journal — the far
#: side (a gateway's ``submit_resumed`` path) continues from the
#: journal offset, never re-runs it.
IDEMPOTENT_CLIENT_OPS = ("infer", "ping", "stats")


class _EndpointRejected(Exception):
    """Internal: a 503/410 rejection that should fail over to the next
    endpoint instead of surfacing (multi-endpoint clients only)."""

    def __init__(self, err):
        super().__init__(str(err))
        self.err = err


class GatewayClient:
    """Blocking binary-protocol client over one persistent connection.

    >>> c = GatewayClient(host, port, tenant="search")
    >>> outs = c.infer("mlp", {"x": x})          # list of np arrays
    >>> c.close()

    Raises GatewayError with the server's status/message/Retry-After on
    rejection (quota, overload, unknown model, deadline shed, drain);
    WireError/OSError on transport failure.

    A dropped persistent connection does not poison the client:
    **idempotent** ops (IDEMPOTENT_CLIENT_OPS) re-dial and retry once
    under `reliability/retry.py`'s policy (seeded backoff), so a
    backend restart is invisible to infer callers. ``generate`` is
    *resumable*: the client journals every token frame; a transport
    failure (or, with multiple endpoints, a 503/410) tears the socket
    down, re-dials the next endpoint in ``endpoints`` and re-dispatches
    with ``resume_committed`` = its journal — duplicate frames are
    dropped by journal offset and the end frame is merged, so the
    caller sees one gapless exactly-once stream. ``reconnect=False``
    makes streams raise on the first transport failure; a custom
    ``retry_policy`` tunes the backoff.

    ``endpoints=[(host, port), ...]`` names the HA pair (active first);
    idempotent retries and stream resumes rotate through it.
    """

    def __init__(self, host, port, tenant="", timeout_s=30.0,
                 reconnect=True, retry_policy=None, endpoints=None):
        self.endpoints = ([(h, int(p)) for h, p in endpoints]
                          if endpoints else [(host, int(port))])
        self._ep = 0
        self.host, self.port = self.endpoints[0]
        self.tenant = tenant
        self.timeout_s = timeout_s
        self._reconnect = bool(reconnect)
        if retry_policy is None and reconnect:
            from paddle_tpu_torch.reliability.retry import RetryPolicy
            # one re-dial + replay: enough for a restart/re-route blip
            # without turning a dead gateway into a slow hang
            retry_policy = RetryPolicy(max_attempts=2, base_delay=0.05,
                                       max_delay=0.5,
                                       deadline=timeout_s)
        self._retry = retry_policy
        self.redials = 0
        self.stream_resumes = 0
        self.stream_dups_dropped = 0
        self._sock = None
        try:
            self._dial()
        except OSError:
            # an HA client may be built while the active is already
            # dead — stay lazy and let the first op dial the peer; a
            # single-endpoint client keeps the fail-fast contract
            if len(self.endpoints) == 1:
                raise
            self._advance_endpoint()
        self._next_id = 0

    # -- connection management -----------------------------------------
    def _dial(self):
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout_s)
        s.settimeout(self.timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_all(s, MAGIC)
        self._sock = s
        return s

    def _ensure_sock(self):
        if self._sock is None:
            self.redials += 1
            self._dial()
        return self._sock

    def _advance_endpoint(self):
        """Rotate to the next endpoint in the HA list (no-op with one);
        the NEXT dial lands there."""
        if len(self.endpoints) > 1:
            self._ep = (self._ep + 1) % len(self.endpoints)
            self.host, self.port = self.endpoints[self._ep]

    def _teardown(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, header, tensors, idempotent):
        """One request/response frame pair. Idempotent ops replay on a
        fresh dial under the retry policy — rotating through the
        endpoint list, so a dead/standby/fenced router fails over to
        its peer; anything else fails fast with the socket torn down
        (next call re-dials)."""
        payload = encode_payload(header, tensors)
        multi = len(self.endpoints) > 1

        def once():
            try:
                # the dial is inside the failure path on purpose: a
                # refused connection (dead active) must rotate to the
                # peer exactly like a mid-request tear
                sock = self._ensure_sock()
                send_frame(sock, payload)
                resp_payload = recv_frame(sock)
            except (WireError, OSError):
                self._teardown()
                self._advance_endpoint()
                raise
            if resp_payload is None:
                self._teardown()
                self._advance_endpoint()
                raise WireError(
                    "gateway closed the connection mid-request")
            resp, rtensors = decode_payload(resp_payload)
            status = resp.get("status", 500)
            if (multi and idempotent and self._reconnect
                    and status in (503, 410)):
                # a standby (not yet promoted), a fenced zombie, or an
                # overloaded router: the PEER may serve this right now
                self._teardown()
                self._advance_endpoint()
                raise _EndpointRejected(GatewayError(
                    status, resp.get("error", "gateway error"),
                    retry_after_s=resp.get("retry_after_s"),
                    detail=resp))
            return resp, rtensors

        if not (idempotent and self._reconnect):
            return once()
        from paddle_tpu_torch.reliability.retry import RetryError
        try:
            return self._retry.run(
                once, key=str(header.get("op", "op")),
                retryable=lambda e: isinstance(
                    e, (WireError, OSError, _EndpointRejected)))
        except RetryError as e:
            if isinstance(e.cause, _EndpointRejected):
                raise e.cause.err   # surface the GatewayError contract
            raise e.cause       # keep the WireError/OSError contract

    def infer(self, model, feed, version=None, priority=0,
              deadline_ms=None, tenant=None, trace_ctx=None,
              session=None):
        """One inference round trip. `feed` maps input name → array with
        a leading batch axis. Returns (fetch list with padding removed,
        response header dict — status/model/version/latency_ms).

        The caller's current span context (or an explicit `trace_ctx`)
        rides the header's `trace` field, so the gateway's server-side
        spans parent under the caller's trace. An optional `session`
        key rides the header for fleet-router consistent-hash affinity
        (a plain gateway ignores it)."""
        self._next_id += 1
        names = sorted(feed)
        header = {"op": "infer", "id": self._next_id, "model": model,
                  "inputs": names, "priority": int(priority),
                  "tenant": self.tenant if tenant is None else tenant}
        if isinstance(trace_ctx, dict):
            ctx = trace_ctx
        else:
            ctx = obs_trace.context_to_dict(
                trace_ctx if trace_ctx is not None
                else obs_trace.current_context())
        if ctx is not None:
            header["trace"] = ctx
        if version is not None:
            header["version"] = version
        if deadline_ms is not None:
            header["deadline_ms"] = float(deadline_ms)
        if session is not None:
            header["session"] = str(session)
        resp, tensors = self._roundtrip(
            header, [np.asarray(feed[n]) for n in names],
            idempotent=True)
        if resp.get("status", 500) != 200:
            raise GatewayError(resp.get("status", 500),
                               resp.get("error", "gateway error"),
                               retry_after_s=resp.get("retry_after_s"),
                               detail=resp)
        return tensors, resp

    def ping(self):
        """Liveness round trip (idempotent: reconnects + retries)."""
        self._next_id += 1
        resp, _ = self._roundtrip(
            {"op": "ping", "id": self._next_id}, [], idempotent=True)
        return resp

    def stats(self):
        """Server stats document (idempotent: reconnects + retries)."""
        self._next_id += 1
        resp, _ = self._roundtrip(
            {"op": "stats", "id": self._next_id}, [], idempotent=True)
        if resp.get("status", 500) != 200:
            raise GatewayError(resp.get("status", 500),
                               resp.get("error", "gateway error"),
                               detail=resp)
        return resp.get("stats", {})

    def generate(self, model, prompt, max_new_tokens, stop_token=None,
                 mode="greedy", temperature=1.0, seed=0, priority=0,
                 deadline_ms=None, tenant=None, trace_ctx=None,
                 on_token=None, session=None):
        """Streaming generation round trip: sends one ``op=generate``
        frame, consumes 206 token frames (invoking `on_token(token,
        index)` per token as they arrive) until the terminal end frame,
        which it returns as a dict ({"tokens", "stop_cause", ...}).

        Streams are NOT blindly replayable, but they ARE resumable:
        every 206 token is journaled client-side; when the connection
        tears mid-stream (a gateway died) — or a
        multi-endpoint client hits a 503/410 (standby awaiting
        promotion, fenced zombie) — the client re-dials the next
        endpoint and re-dispatches with ``resume_committed`` = its
        journal. The far side continues from the journal offset
        (`submit_resumed`); frames below the offset are dropped
        (`stream_dups_dropped`) and the end frame is merged with the
        journal prefix, so `on_token` fires exactly once per index and
        the returned token list is gapless and bit-exact (greedy) vs
        an unkilled run. Bounded by `timeout_s` end-to-end.

        With ``reconnect=False`` a transport failure tears the socket
        down and raises (the old callers-own-reconnect contract).
        Raises GatewayError on a non-retryable rejection frame.
        `session` keys fleet-router affinity (the stream's KV slot
        stays on its backend)."""
        import time as _time
        self._next_id += 1
        rid = self._next_id
        header = {"op": "generate", "id": rid, "model": model,
                  "max_new_tokens": int(max_new_tokens),
                  "mode": mode, "temperature": float(temperature),
                  "seed": int(seed), "priority": int(priority),
                  "tenant": self.tenant if tenant is None else tenant}
        if stop_token is not None:
            header["stop_token"] = int(stop_token)
        if deadline_ms is not None:
            header["deadline_ms"] = float(deadline_ms)
        if session is not None:
            header["session"] = str(session)
        if isinstance(trace_ctx, dict):
            ctx = trace_ctx
        else:
            ctx = obs_trace.context_to_dict(
                trace_ctx if trace_ctx is not None
                else obs_trace.current_context())
        if ctx is not None:
            header["trace"] = ctx
        prompt_arr = np.asarray(prompt, np.int32).reshape(-1)
        journal = []      # committed token values, in index order
        multi = len(self.endpoints) > 1
        deadline = (_time.monotonic() + self.timeout_s
                    if self.timeout_s else None)
        failures = 0
        while True:
            base = len(journal)
            hdr = header
            retry_after = None
            try:
                if base:
                    from paddle_tpu_torch.reliability.faults import (
                        inject_point,
                    )
                    # chaos: the replay dying before it is dispatched —
                    # the journal survives, the next endpoint resumes
                    inject_point("fleet.journal_replay", tag=str(rid))
                    hdr = dict(header)
                    hdr["resume_committed"] = [int(t) for t in journal]
                    self.stream_resumes += 1
                sock = self._ensure_sock()
                send_frame(sock, encode_payload(hdr, [prompt_arr]))
                while True:
                    payload = recv_frame(sock)
                    if payload is None:
                        raise WireError(
                            "gateway closed the connection mid-stream")
                    resp, _ = decode_payload(payload)
                    status = resp.get("status", 500)
                    if status == 206:
                        idx = resp.get("index")
                        if (idx is not None
                                and int(idx) < len(journal)):
                            # a peer replaying below the journal
                            # offset: already delivered — drop it
                            self.stream_dups_dropped += 1
                            continue
                        journal.append(int(resp.get("token")))
                        if on_token is not None:
                            on_token(resp.get("token"), idx)
                        continue
                    if status != 200:
                        err = GatewayError(
                            status, resp.get("error", "gateway error"),
                            retry_after_s=resp.get("retry_after_s"),
                            detail=resp)
                        if (self._reconnect and multi
                                and status in (503, 410)):
                            # standby/fenced/busy router: the peer may
                            # serve (or resume) this stream right now
                            raise _EndpointRejected(err)
                        raise err
                    if base and not resp.get("resumed"):
                        # a resumed stream answered by a bare gateway:
                        # its end frame carries only post-resume
                        # tokens — splice the journal AS IT STOOD AT
                        # DISPATCH back in front (a router that seeded
                        # from our journal already merged, and says so
                        # with "resumed": true)
                        resp = dict(resp)
                        resp["tokens"] = (
                            [int(t) for t in journal[:base]]
                            + [int(t)
                               for t in (resp.get("tokens") or ())])
                        resp["resumed"] = True
                    return resp
            except _EndpointRejected as e:
                self._teardown()
                last_err = e.err
                retry_after = e.err.retry_after_s
            except (WireError, OSError) as e:
                self._teardown()
                if not self._reconnect:
                    raise
                last_err = e
            except RuntimeError as e:
                # an injected fleet.journal_replay fault: this dispatch
                # attempt died before the wire — resume on the next
                # endpoint, the journal is untouched
                from paddle_tpu_torch.reliability.faults import FaultError
                if not isinstance(e, FaultError):
                    raise
                self._teardown()
                last_err = e
            failures += 1
            backoff = min(0.05 * (2 ** min(failures - 1, 4)), 0.5)
            if retry_after is not None:
                backoff = max(backoff, min(float(retry_after), 0.5))
            if failures > 64 or (
                    deadline is not None
                    and _time.monotonic() + backoff >= deadline):
                raise last_err
            self._advance_endpoint()
            _time.sleep(backoff)

    def close(self):
        self._teardown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
