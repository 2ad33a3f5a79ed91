"""The sparse parameter server: tables, client, communicators.

Counterpart of paddle_tpu/ps/__init__.py, over the port's own build of
the same C++ (`paddle_tpu_torch.native`, src/ps.cc), so a port `Client`
and a JAX-package `Server` talk over one wire, and back:

* the RPC transport and the listen_and_serv loop (reference
  operators/distributed/rpc_client.h:34, listen_and_serv_op.cc:110):
  `Server`, a C++ TCP server with sharded tables and server-side SGD /
  Adagrad; a sparse row's first pull is `HashUniform(id, j)`;
* FleetWrapper's pull / push (fleet_wrapper.h:76-166): `Client`;
* the async Communicator (communicator.h:178): `AsyncCommunicator`, a
  background thread that merges same-id gradients and pushes them;
* the GeoSgdCommunicator (communicator.h:335): `GeoCommunicator`, dense
  deltas every k steps;
* HeartBeatMonitor (heart_beat_monitor.h:54): `HeartbeatMonitor`, with
  an evictor that releases the survivors of a dead worker's barrier.

Resilience (rpc_client.h's retry policy): every `Client` verb runs under
a `reliability.retry.RetryPolicy` built from the `ps_retry_*` flags,
with a retry-safety class per verb (`RETRY_SAFETY`): reads and
heartbeats retry with a reconnect of broken endpoints, pushes are
sequence-stamped so a retried push is applied once (the server drops
duplicates), barriers retry only a request that provably never went
out, and an endpoint dead past `failover_after` (flag
`ps_failover_after_s`) fails over to its backup. The `ps.transport` /
`ps.transport.after` fault sites sit on every verb; per-verb counters go
to `pt_ps_client_total` on the metrics registry and every verb is a
`ps.<verb>` trace span.

The tables live on the host; a trainer moves the rows it pulls to its
device and the gradients it pushes back (chip_smoke phase 39).
"""
import ctypes
import itertools
import os
import threading
import time

import numpy as np

from paddle_tpu_torch.analysis.concurrency import make_lock, make_rlock
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import trace as obs_trace
from paddle_tpu_torch.reliability.faults import FaultError, inject_point
from paddle_tpu_torch.reliability.retry import RetryPolicy
from paddle_tpu_torch.utils import profiler

__all__ = ["TableConfig", "Server", "Client", "AsyncCommunicator",
           "GeoCommunicator", "HeartbeatMonitor", "RETRY_SAFETY",
           "default_retry_policy", "register_table", "registered_tables",
           "clear_registry", "serve", "connect_workers", "client",
           "shutdown_workers"]

def _verb_counter():
    """Per-verb RPC counter series on the unified registry (the numbers
    the gateway /metrics route and chaos assertions read)."""
    return obs_metrics.registry().counter(
        "pt_ps_client_total", "PS client RPCs per verb and event",
        labels=("verb", "event"))


OPT_SGD, OPT_ADAGRAD = 0, 1
_OPT_NAMES = {"sgd": OPT_SGD, "adagrad": OPT_ADAGRAD}


class TableConfig:
    """One PS table (pslib table config / trainer_desc.proto parity)."""

    def __init__(self, table_id, kind, dim=None, size=None,
                 optimizer="adagrad", lr=0.05, init_range=0.01):
        enforce(kind in ("sparse", "dense"), f"bad table kind {kind}")
        if kind == "sparse":
            enforce(dim is not None, "sparse table needs dim")
        else:
            enforce(size is not None, "dense table needs size")
        self.table_id = int(table_id)
        self.kind = kind
        self.dim = dim
        self.size = size
        self.optimizer = _OPT_NAMES[optimizer]
        self.lr = float(lr)
        self.init_range = float(init_range)


# module-level table registry: layers (embedding(is_distributed=True)) and
# user code register tables; fleet.run_server() serves them.
_registry = {}


def register_table(cfg):
    _registry[cfg.table_id] = cfg
    return cfg


def registered_tables():
    return list(_registry.values())


def clear_registry():
    _registry.clear()


def _lib():
    from paddle_tpu_torch import native
    return native.load()


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


class Server:
    """In-process PS server over the registered tables."""

    def __init__(self, port=0, tables=None, num_workers=1):
        self._l = _lib()
        self._h = self._l.ptps_server_create(int(port))
        for t in (tables if tables is not None else registered_tables()):
            if t.kind == "sparse":
                self._l.ptps_server_add_sparse_table(
                    self._h, t.table_id, t.dim, t.optimizer, t.lr,
                    t.init_range)
            else:
                self._l.ptps_server_add_dense_table(
                    self._h, t.table_id, t.size, t.optimizer, t.lr)
        self._l.ptps_server_set_num_workers(self._h, num_workers)
        self._stopped = False

    def start(self):
        enforce(self._l.ptps_server_start(self._h) == 0,
                "PS server failed to bind/listen")
        return self

    @property
    def port(self):
        return self._l.ptps_server_port(self._h)

    def sparse_rows(self, table_id):
        return int(self._l.ptps_server_sparse_rows(self._h, table_id))

    def lost_workers(self, timeout_sec=120.0):
        buf = np.zeros(1024, np.int32)
        n = self._l.ptps_server_lost_workers(
            self._h, float(timeout_sec),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 1024)
        return buf[:n].tolist()

    def evict_worker(self, worker_id):
        """Remove a dead worker from the barrier group: survivors parked
        in a barrier are released if now complete, and later barriers
        from the evicted id fail loudly (it cannot rejoin silently)."""
        self._l.ptps_server_evict_worker(self._h, int(worker_id))

    def stop(self):
        if not self._stopped:
            self._stopped = True
            self._l.ptps_server_stop(self._h)

    def join(self, poll=0.2):
        """Block until a client sends stop (run_server semantics)."""
        while not self._stopped:
            time.sleep(poll)
            if not self._l.ptps_server_running(self._h):
                self.stop()  # join the C++ threads

    def __del__(self):
        try:
            self.stop()
            self._l.ptps_server_destroy(self._h)
        except Exception:
            pass


#: Retry-safety classification per client verb. "safe": idempotent, retried on any transport failure.
#: "dedup": retried only because pushes are sequence-stamped and the
#: server skips duplicates (at-most-once under ambiguous failures).
#: "send_only": retried only when the request provably never completed
#: (send-side failure); an ambiguous recv-side failure surfaces, since a
#: blind retry could double-enter a barrier generation. "none": never
#: retried.
RETRY_SAFETY = {
    "connect": "safe",
    "pull_sparse": "safe",
    "pull_dense": "safe",
    "init_dense": "safe",
    "heartbeat": "safe",
    "barrier": "send_only",
    "shrink": "send_only",
    "push_sparse": "dedup",
    "push_dense": "dedup",
    "stop_servers": "none",
}

# unique per-process pusher identity for the server-side dedup map: the
# pid and a count, as the JAX package's clients make theirs, with bit 63
# set so that a port client never shares one with a JAX-package client
# of the same process (the server would drop its pushes as retries)
_push_id_counter = itertools.count(1)
_PORT_PUSH_ID_BIT = 1 << 63


def default_retry_policy(**overrides):
    """The flag-configured policy every Client gets unless one is passed
    explicitly (PT_FLAGS_ps_retry_* — rpc_client.h retry-knob parity)."""
    kw = dict(max_attempts=_flags.get_flag("ps_retry_attempts"),
              base_delay=_flags.get_flag("ps_retry_base_s"),
              max_delay=_flags.get_flag("ps_retry_max_s"),
              deadline=_flags.get_flag("ps_retry_deadline_s"))
    kw.update(overrides)
    return RetryPolicy(**kw)


class Client:
    """PS client — FleetWrapper pull/push surface over numpy, with the
    rpc_client.h resilience the first port lacked: every verb runs under
    a RetryPolicy (per-RPC deadline, capped exponential backoff with
    seeded jitter, bounded attempts) with automatic reconnect of broken
    endpoints, sequence-stamped at-most-once pushes, and optional
    endpoint failover (`backup_endpoints`) once a server stays dead past
    `failover_after` seconds. Per-verb retry/failure counters are kept
    in `stats()` and mirrored into utils/profiler counters."""

    def __init__(self, endpoints, backup_endpoints=None, retry_policy=None,
                 failover_after=None):
        if isinstance(endpoints, str):
            endpoints = endpoints.split(",")
        self.endpoints = list(endpoints)
        if isinstance(backup_endpoints, str):
            backup_endpoints = backup_endpoints.split(",")
        self.backup_endpoints = (list(backup_endpoints)
                                 if backup_endpoints else None)
        if self.backup_endpoints is not None:
            enforce(len(self.backup_endpoints) == len(self.endpoints),
                    "backup_endpoints must pair 1:1 with endpoints "
                    "(use None entries for servers without a standby)")
        self.retry_policy = retry_policy or default_retry_policy()
        self.failover_after = (
            _flags.get_flag("ps_failover_after_s")
            if failover_after is None else float(failover_after))
        self._l = _lib()
        self._mu = make_rlock("ps.handle")  # guards handle swap + native calls
        self._push_id = _PORT_PUSH_ID_BIT \
            | ((os.getpid() & 0xFFFFFFFF) << 20) \
            | (next(_push_id_counter) & 0xFFFFF)
        self._seq = 0
        self._seq_mu = make_lock("ps.seq")
        self._h = None
        self._new_handle()
        self._broken_since = {}           # endpoint idx -> first-seen time
        self._counters = {}               # verb -> counter dict
        self._failovers = []              # [(idx, old_ep, new_ep)]
        self._hb_thread = None
        self._hb_stop = threading.Event()
        self._hb_error = None
        self._hb_beats = 0

    # -- handle / connection management --------------------------------
    def _new_handle(self):
        with self._mu:
            if self._h:
                self._l.ptps_client_destroy(self._h)
            self._h = self._l.ptps_client_create(
                "|".join(self.endpoints).encode())
            self._l.ptps_client_set_push_id(self._h, self._push_id)

    def _check(self, rc, what):
        if rc != 0:
            buf = ctypes.create_string_buffer(512)
            self._l.ptps_client_last_error(self._h, buf, 512)
            raise RuntimeError(f"ps.{what}: {buf.value.decode()}")

    def _broken_endpoints_locked(self):
        buf = np.zeros(max(8, len(self.endpoints)), np.int32)
        n = self._l.ptps_client_broken_endpoints(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(buf))
        return buf[:n].tolist()

    def _ensure_connected(self, counters=None):
        """Re-dial any endpoint whose connection dropped (a failed RPC
        invalidates its fd native-side); after `failover_after` seconds
        of an endpoint staying dead, swap in its backup and rebuild the
        handle. Quietly returns on failure — the verb that follows will
        fail with a classified transport error the policy retries."""
        with self._mu:
            broken = self._broken_endpoints_locked()
            if not broken:
                self._broken_since.clear()
                return
            now = self.retry_policy.clock()
            for i in broken:
                self._broken_since.setdefault(i, now)
            self._maybe_failover_locked(broken, now)
            rc = self._l.ptps_client_connect(self._h)
            if rc == 0:
                if counters is not None:
                    counters["reconnects"] += len(broken)
                self._broken_since.clear()

    def _maybe_failover_locked(self, broken, now):
        if not self.backup_endpoints:
            return
        swapped = False
        for i in broken:
            backup = self.backup_endpoints[i]
            if not backup or backup == self.endpoints[i]:
                continue
            if now - self._broken_since.get(i, now) < self.failover_after:
                continue
            self._failovers.append((i, self.endpoints[i], backup))
            self.endpoints[i] = backup
            self._broken_since.pop(i, None)
            swapped = True
        if swapped:
            self._new_handle()
            # reconnects are single fast attempts; backoff is the
            # policy's job (the initial 50x100ms loop covers launch
            # races only)
            self._l.ptps_client_set_connect_attempts(self._h, 1, 0)

    # -- retry engine ---------------------------------------------------
    def _retryable(self, verb, exc):
        safety = RETRY_SAFETY.get(verb, "none")
        if safety == "none":
            return False
        if isinstance(exc, FaultError):
            # pre-verb injected faults never reached the wire; only the
            # post-verb ("ps.transport.after") site models an applied-
            # but-unacknowledged RPC
            ambiguous = str(exc.site).startswith("ps.transport.after")
        else:
            msg = str(exc)
            if "server error status" in msg:
                return False          # the server answered: not transient
            ambiguous = "recv failed" in msg
        if safety in ("safe", "dedup"):
            return True
        return not ambiguous          # send_only

    def _run_verb(self, verb, fn, attrs=None):
        """Run one verb under the retry policy, inside a `ps.<verb>`
        span tagged with the verb's payload identity (`attrs`: table id,
        rows, push seq — the pull/push tags the trace tree keys PS
        round-trips on). The span joins whatever trace is current on
        the calling thread (a training step, a serving request)."""
        c = self._counters.setdefault(
            verb, {"calls": 0, "ok": 0, "retries": 0, "failures": 0,
                   "reconnects": 0})
        c["calls"] += 1
        obs_c = _verb_counter()
        obs_c.labels(verb=verb, event="calls").inc()

        def attempt():
            self._ensure_connected(counters=c)
            return fn()

        sp_attrs = {"verb": verb}
        if attrs:
            sp_attrs.update(attrs)
        with obs_trace.span(f"ps.{verb}", attrs=sp_attrs) as sp:
            def on_retry(attempt_no, delay, exc):
                c["retries"] += 1
                sp.set_attribute("retries", attempt_no)
                obs_c.labels(verb=verb, event="retries").inc()
                profiler.log_counters(f"ps.client.{verb}", dict(c))

            try:
                out = self.retry_policy.run(
                    attempt, key=verb,
                    retryable=lambda e: self._retryable(verb, e),
                    on_retry=on_retry)
                c["ok"] += 1
                obs_c.labels(verb=verb, event="ok").inc()
                return out
            except Exception:
                c["failures"] += 1
                obs_c.labels(verb=verb, event="failures").inc()
                raise
            finally:
                profiler.log_counters(f"ps.client.{verb}", dict(c))

    def _next_seq(self):
        with self._seq_mu:
            self._seq += 1
            return self._seq

    # -- verbs ----------------------------------------------------------
    def connect(self):
        # reliability choke point: the client-side RPC edge — seeded
        # fault plans (site "ps.transport", tags per verb) simulate the
        # unreachable-server / flaky-network failures the RetryPolicy
        # wrapped around every verb here absorbs
        def fn():
            inject_point("ps.transport", tag="connect")
            with self._mu:
                self._check(self._l.ptps_client_connect(self._h), "connect")

        self._run_verb("connect", fn)
        with self._mu:
            self._l.ptps_client_set_connect_attempts(self._h, 1, 0)
        return self

    def pull_sparse(self, table_id, ids, dim):
        ids = np.ascontiguousarray(ids, np.uint64)

        def fn():
            out = np.empty((len(ids), dim), np.float32)
            with self._mu:
                self._check(self._l.ptps_client_pull_sparse(
                    self._h, table_id, _u64ptr(ids), len(ids), dim,
                    _fptr(out)), "pull_sparse")
            return inject_point("ps.transport", tag="pull_sparse",
                                value=out)

        return self._run_verb("pull_sparse", fn,
                              attrs={"table": table_id,
                                     "rows": len(ids), "dim": dim})

    def push_sparse(self, table_id, ids, grads):
        ids = np.ascontiguousarray(ids, np.uint64)
        grads = np.ascontiguousarray(grads, np.float32)
        enforce(grads.shape[0] == len(ids), "ids/grads row mismatch")
        seq = self._next_seq()    # retries resend the SAME seq: the
                                  # server dedups, so an ambiguous
                                  # failure cannot double-apply grads

        def fn():
            inject_point("ps.transport", tag="push_sparse")
            with self._mu:
                self._check(self._l.ptps_client_push_sparse_seq(
                    self._h, table_id, seq, _u64ptr(ids), len(ids),
                    grads.shape[1], _fptr(grads)), "push_sparse")
            inject_point("ps.transport.after", tag="push_sparse")

        self._run_verb("push_sparse", fn,
                       attrs={"table": table_id, "rows": len(ids),
                              "seq": seq})

    def pull_dense(self, table_id, size):
        def fn():
            out = np.empty(size, np.float32)
            with self._mu:
                self._check(self._l.ptps_client_pull_dense(
                    self._h, table_id, _fptr(out), size), "pull_dense")
            return inject_point("ps.transport", tag="pull_dense",
                                value=out)

        return self._run_verb("pull_dense", fn,
                              attrs={"table": table_id, "size": size})

    def push_dense(self, table_id, grads):
        grads = np.ascontiguousarray(grads, np.float32)
        seq = self._next_seq()

        def fn():
            inject_point("ps.transport", tag="push_dense")
            with self._mu:
                self._check(self._l.ptps_client_push_dense_seq(
                    self._h, table_id, seq, _fptr(grads), grads.size),
                    "push_dense")
            inject_point("ps.transport.after", tag="push_dense")

        self._run_verb("push_dense", fn,
                       attrs={"table": table_id,
                              "size": int(grads.size), "seq": seq})

    def init_dense(self, table_id, values):
        values = np.ascontiguousarray(values, np.float32)

        def fn():
            inject_point("ps.transport", tag="init_dense")
            with self._mu:
                self._check(self._l.ptps_client_init_dense(
                    self._h, table_id, _fptr(values), values.size),
                    "init_dense")

        self._run_verb("init_dense", fn,
                       attrs={"table": table_id})

    def barrier(self, worker_id=0):
        def fn():
            inject_point("ps.transport", tag="barrier")
            with self._mu:
                self._check(self._l.ptps_client_barrier(
                    self._h, worker_id), "barrier")

        self._run_verb("barrier", fn, attrs={"worker": worker_id})

    def heartbeat(self, worker_id=0):
        def fn():
            inject_point("ps.transport", tag="heartbeat")
            with self._mu:
                self._check(self._l.ptps_client_heartbeat(
                    self._h, worker_id), "heartbeat")

        self._run_verb("heartbeat", fn, attrs={"worker": worker_id})

    def start_heartbeat(self, worker_id, interval=10.0):
        """Background heartbeat thread (PullDenseWorker/heartbeat parity).

        Each beat runs under the retry policy like any verb; a beat that
        exhausts its budget is TERMINAL for the thread but not silent —
        the failure is recorded where `stats()` (and the watchdog dump)
        can see it, instead of the old `break`-into-nothing."""
        self._hb_stop.clear()
        self._hb_error = None

        def loop():
            while not self._hb_stop.wait(interval):
                try:
                    self.heartbeat(worker_id)
                    self._hb_beats += 1
                except Exception as e:
                    self._hb_error = e
                    break

        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name=f"ps-heartbeat-{worker_id}")
        self._hb_thread.start()

    def stop_heartbeat(self):
        self._hb_stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=2)

    def shrink(self, table_id, min_updates=1):
        def fn():
            inject_point("ps.transport", tag="shrink")
            with self._mu:
                self._check(self._l.ptps_client_shrink(
                    self._h, table_id, int(min_updates)), "shrink")

        self._run_verb("shrink", fn, attrs={"table": table_id})

    def stop_servers(self):
        with self._mu:
            self._l.ptps_client_stop_servers(self._h)

    # -- observability --------------------------------------------------
    def stats(self):
        """Per-verb retry/failure counters + heartbeat-thread health +
        failover history — the numbers the watchdog dump and chaos
        assertions read."""
        return {
            "endpoints": list(self.endpoints),
            "verbs": {v: dict(c) for v, c in self._counters.items()},
            "failovers": [{"index": i, "from": a, "to": b}
                          for i, a, b in self._failovers],
            "heartbeat": {
                "alive": bool(self._hb_thread
                              and self._hb_thread.is_alive()),
                "beats": self._hb_beats,
                "error": (str(self._hb_error)
                          if self._hb_error else None),
            },
        }

    def close(self):
        """Release the native client handle (and its TCP connections)."""
        if self._h:
            self.stop_heartbeat()
            self._l.ptps_client_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AsyncCommunicator:
    """Async grad channel (communicator.h:178 parity): training threads
    enqueue sparse grads; a background thread merges same-id grads within a
    window and pushes them — decoupling step time from network latency, the
    async-SGD contract (grads applied on arrival).

    Inherits the client's RetryPolicy: every push runs under the verb
    wrapper (reconnect + backoff + seq-dedup), so a transient network blip is
    absorbed in the background thread and never surfaces to the training
    thread; only a push that exhausts its whole budget lands in the
    requeue-and-surface path below."""

    def __init__(self, client, merge_interval=0.01, max_pending=10000):
        self.client = client
        self.interval = merge_interval
        self.max_pending = max_pending
        self.error = None           # last push failure (communicator keeps
        self._q = []                # retrying; surfaced on enqueue)
        self.undelivered = 0        # set by stop(): batches left undrained
        self._mu = make_lock("ps.async_comm")
        self._stop = threading.Event()
        self._thread = None
        self._push_client = None    # dedicated connection (see start())

    def push_sparse_async(self, table_id, ids, grads):
        with self._mu:
            if len(self._q) >= self.max_pending:
                raise RuntimeError(
                    f"AsyncCommunicator backlog > {self.max_pending} "
                    f"(last push error: {self.error}) — server unreachable?")
            self._q.append((table_id, np.asarray(ids, np.uint64),
                            np.asarray(grads, np.float32)))

    def _drain(self):
        with self._mu:
            q, self._q = self._q, []
        if not q:
            return
        # merge grads per (table, id) — the communicator's merge-before-
        # send (communicator.h MergedVar semantics). Vectorized: a per-id
        # Python loop here holds the GIL for milliseconds per drain and
        # stalls the training thread — the exact latency the communicator
        # exists to hide (measured 0.7x "overlap" before this fix).
        by_table = {}
        for table_id, ids, grads in q:
            lst = by_table.setdefault(table_id, ([], []))
            lst[0].append(ids)
            lst[1].append(grads)
        cli = self._push_client or self.client
        for table_id, (id_chunks, grad_chunks) in by_table.items():
            all_ids = np.concatenate(id_chunks)
            all_grads = np.concatenate(grad_chunks, axis=0)
            ids, inv = np.unique(all_ids, return_inverse=True)
            grads = np.zeros((len(ids), all_grads.shape[1]), np.float32)
            np.add.at(grads, inv, all_grads)
            try:
                cli.push_sparse(table_id, ids, grads)
                self.error = None
            except RuntimeError as e:
                # transient RPC failure: requeue the merged grads and let
                # the next tick retry (async-SGD tolerates delay, not loss)
                self.error = e
                with self._mu:
                    self._q.append((table_id, ids, grads))

    def start(self):
        # Dedicated TCP connection for pushes: the C++ client serializes
        # RPCs per connection (ps.h mus_), so pushing on the trainer's
        # connection would stall its pulls — defeating the overlap the
        # communicator exists for.
        if self._push_client is not None:  # re-start(): drop the old one
            self._push_client.close()
        try:
            self._push_client = Client(
                self.client.endpoints,
                backup_endpoints=self.client.backup_endpoints,
                retry_policy=self.client.retry_policy,
                failover_after=self.client.failover_after).connect()
        except Exception:
            self._push_client = None   # fall back to the shared connection

        def loop():
            while not self._stop.wait(self.interval):
                self._drain()
            self._drain()  # final flush

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def pending(self):
        with self._mu:
            return len(self._q)

    def stop(self, timeout=5.0):
        """Drain-with-deadline shutdown: flush whatever is still queued
        (including requeued failed pushes) before giving up, then return
        the number of undelivered merged grad batches — 0 is a clean
        drain. The old behaviour silently dropped whatever a fixed 5s
        join left behind; now the caller can tell (and `self.error`
        names the terminal push failure)."""
        deadline = time.monotonic() + timeout
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=max(0.0, deadline - time.monotonic()))
        while time.monotonic() < deadline:
            alive = self._thread is not None and self._thread.is_alive()
            before = self.pending()
            if before == 0 and not alive:
                break
            if alive:
                # the loop's final flush still owns the queue; a wedged
                # push cannot stall us past the deadline
                time.sleep(0.01)
                continue
            self._drain()
            if self.pending() >= before and self.error is not None:
                break   # no progress and the server is unreachable
        undelivered = self.pending()
        self.undelivered = undelivered
        if self._push_client is not None:
            self._push_client.close()
            self._push_client = None
        return undelivered


class GeoCommunicator:
    """Geo-SGD (communicator.h:335 parity): workers train on a local copy
    of a dense table and push the parameter DELTA (scaled by 1/n_workers)
    every `k_steps` steps, then refresh from the server.

    Delta semantics need a plain-SGD dense table: the server applies
    param -= lr * grad, so the delta is encoded as grad = -delta / lr.
    Pass the SAME TableConfig used to build the server; adagrad tables are
    rejected (their rescaled updates would silently shred the deltas)."""

    def __init__(self, client, table_config, k_steps=10, n_workers=1):
        enforce(table_config.kind == "dense",
                "GeoCommunicator works on a dense table")
        enforce(table_config.optimizer == _OPT_NAMES["sgd"],
                "GeoCommunicator requires a TableConfig(optimizer='sgd') "
                "dense table — delta-push is undefined under adagrad")
        self.client = client
        self.table_id = table_config.table_id
        self.size = table_config.size
        self.lr = table_config.lr
        self.k = k_steps
        self.n = n_workers
        self._step = 0
        self.local = client.pull_dense(self.table_id, self.size).copy()
        self._base = self.local.copy()

    def maybe_sync(self):
        self._step += 1
        if self._step % self.k:
            return False
        delta = (self.local - self._base) / self.n
        self.client.push_dense(self.table_id, -delta / self.lr)
        self.local = self.client.pull_dense(self.table_id, self.size).copy()
        self._base = self.local.copy()
        return True


class HeartbeatMonitor:
    """Server-side lost-worker detection (heart_beat_monitor.h:54):
    workers silent longer than `timeout` are reported — and, unlike the
    first port (which only *reported*), consumed: `evict_lost()` /
    `start_evictor()` feed the detections into `Server.evict_worker`,
    shrinking the barrier group so the survivors of a dead trainer are
    released instead of deadlocking on it forever."""

    def __init__(self, server, timeout=120.0):
        self.server = server
        self.timeout = timeout
        self.evicted = []
        self._ev_stop = threading.Event()
        self._ev_thread = None

    def lost_workers(self):
        return self.server.lost_workers(self.timeout)

    def evict_lost(self, on_evict=None):
        """One sweep: evict every currently-lost worker from the barrier
        group (eviction also clears its heartbeat record, so a worker is
        evicted once). Returns the ids evicted by this sweep."""
        lost = self.lost_workers()
        for wid in lost:
            self.server.evict_worker(wid)
            self.evicted.append(wid)
            if on_evict is not None:
                on_evict(wid)
        return lost

    def start_evictor(self, interval=1.0, on_evict=None):
        """Background eviction loop — the heart_beat_monitor.h worker
        thread, finally wired to an effect."""
        self._ev_stop.clear()

        def loop():
            while not self._ev_stop.wait(interval):
                self.evict_lost(on_evict)

        self._ev_thread = threading.Thread(target=loop, daemon=True,
                                           name="ps-hb-evictor")
        self._ev_thread.start()
        return self

    def stop_evictor(self):
        self._ev_stop.set()
        if self._ev_thread:
            self._ev_thread.join(timeout=2)


# ---- fleet lifecycle hooks (distributed.fleet delegates) -----

_active_server = None


def serve(role_maker, tables=None, block=True):
    """Start a PS server for this role and (by default) block until a
    worker sends stop — the listen_and_serv run loop."""
    global _active_server
    eps = (role_maker.get_pserver_endpoints()
           if hasattr(role_maker, "get_pserver_endpoints")
           else role_maker.server_endpoints())
    ep = eps[role_maker.server_index()]
    port = int(ep.rsplit(":", 1)[1])
    srv = Server(port=port, tables=tables,
                 num_workers=role_maker.worker_num()).start()
    _active_server = srv
    if block:
        srv.join()
    return srv


def connect_workers(server_endpoints):
    global _active_client
    cli = Client(server_endpoints).connect()
    _active_client = cli
    return cli


_active_client = None


def client():
    enforce(_active_client is not None,
            "ps.connect_workers was not called (fleet.init_worker)")
    return _active_client


def shutdown_workers(server_endpoints):
    global _active_client
    if _active_client is None:
        _active_client = Client(server_endpoints).connect()
    _active_client.stop_servers()
    _active_client = None
