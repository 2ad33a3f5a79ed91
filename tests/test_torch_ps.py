"""The port's parameter server (paddle_tpu_torch.ps) against the JAX
package's (paddle_tpu.ps), on the CPU over localhost TCP.

* Cross-talk: both packages run the same C++ (each its own build), so a
  port Client talks to a JAX-package Server and a JAX-package Client to a
  port Server; every pairing gives the reference pairing's numbers: the
  first pulls (HashUniform rows), sparse and dense SGD and Adagrad
  pushes, two-server id sharding, a barrier of a port and a JAX worker,
  heartbeats and the eviction that releases a barrier, shrink, Geo
  deltas, and four workers pushing the same rows at once.
* Resilience (tests/test_elastic.py's cases on the port): transient
  faults absorbed and counted, a retried push after a lost reply applied
  once, reconnect after a server restart, failover to a backup, the
  retry-safety classes, the heartbeat thread's terminal failure, the
  AsyncCommunicator's drain on stop, a fault-injected DeepFM PS loop
  bit-equal to the fault-free one.
"""
import contextlib
import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu import ps as jps
from paddle_tpu_torch import ps as tps
from paddle_tpu_torch.reliability import FaultError, fault_plan
from paddle_tpu_torch.reliability.retry import RetryPolicy

PAIRS = {"port-port": (tps, tps), "port_client-jax_server": (jps, tps),
         "jax_client-port_server": (tps, jps)}


def _fast_policy(**kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("base_delay", 0.002)
    kw.setdefault("max_delay", 0.01)
    kw.setdefault("deadline", 10.0)
    return RetryPolicy(**kw)


def _tables(mod):
    return [mod.TableConfig(0, "dense", size=4, optimizer="sgd", lr=1.0),
            mod.TableConfig(1, "sparse", dim=4, optimizer="adagrad", lr=0.1,
                            init_range=0.01),
            mod.TableConfig(2, "sparse", dim=3, optimizer="sgd", lr=0.5),
            mod.TableConfig(3, "dense", size=6, optimizer="sgd", lr=0.1)]


def _client(mod, endpoints, **kw):
    if mod is tps:
        kw.setdefault("retry_policy", _fast_policy())
    return mod.Client(endpoints, **kw).connect()


def _scenario(server_mod, client_mod):
    """Every verb over one or two servers of `server_mod` through clients
    of `client_mod`; returns what was pulled, in order."""
    out = []
    srvs = [server_mod.Server(tables=_tables(server_mod), num_workers=2)
            .start() for _ in range(2)]
    eps = [f"127.0.0.1:{s.port}" for s in srvs]
    try:
        one = _client(client_mod, eps[:1])
        ids = np.array([0, 5, 9, 5, 123456789], np.uint64)
        out.append(one.pull_sparse(1, ids, 4))
        out.append(one.pull_sparse(2, ids, 3))
        one.push_sparse(1, ids, np.linspace(-1, 1, 20, dtype=np.float32
                                            ).reshape(5, 4))
        one.push_sparse(2, ids, np.ones((5, 3), np.float32))
        out.append(one.pull_sparse(1, ids, 4))
        out.append(one.pull_sparse(2, ids, 3))
        one.init_dense(3, np.arange(6, dtype=np.float32))
        one.push_dense(3, np.full(6, 2.0, np.float32))
        out.append(one.pull_dense(3, 6))
        # shrink: rows updated fewer than 2 times leave the table
        rows = srvs[0].sparse_rows(2)
        one.shrink(2, 2)
        out.append(np.array([rows, srvs[0].sparse_rows(2)]))
        # two servers: ids shard by id modulo server
        two = _client(client_mod, eps)
        many = np.arange(40, dtype=np.uint64)
        out.append(two.pull_sparse(2, many, 3))
        out.append(np.array([srvs[1].sparse_rows(2)]))
        # Geo deltas from two workers
        cfg = client_mod.TableConfig(3, "dense", size=6, optimizer="sgd",
                                     lr=0.1)
        geos = [client_mod.GeoCommunicator(c, cfg, k_steps=2, n_workers=2)
                for c in (one, two)]
        for step in range(4):
            for g, c in zip(geos, (1.0, -0.5)):
                g.local = g.local + c * (step + 1)
                g.maybe_sync()
        out.append(one.pull_dense(3, 6))
        one.close()
        two.close()
    finally:
        for s in srvs:
            s.stop()
    return out


@pytest.fixture(scope="module")
def reference():
    return _scenario(jps, jps)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_cross_talk_matches_the_reference_pairing(reference, pair):
    server_mod, client_mod = PAIRS[pair]
    got = _scenario(server_mod, client_mod)
    assert len(got) == len(reference)
    for g, w in zip(got, reference):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_barrier_heartbeat_and_eviction_across_packages(pair):
    server_mod, other = PAIRS[pair]
    srv = server_mod.Server(tables=_tables(server_mod), num_workers=2)
    srv.start()
    try:
        ep = [f"127.0.0.1:{srv.port}"]
        c0, c1 = _client(tps, ep), _client(other, ep)
        done = []
        t = threading.Thread(target=lambda: (c0.barrier(0),
                                             done.append(0)), daemon=True)
        t.start()
        time.sleep(0.2)
        assert not done                      # a group of two: parked
        c1.barrier(1)
        t.join(5)
        assert done == [0]
        c1.heartbeat(1)
        mon = tps.HeartbeatMonitor(srv, timeout=0.0)
        t = threading.Thread(target=lambda: (c0.barrier(0),
                                             done.append(1)), daemon=True)
        t.start()
        time.sleep(0.2)
        assert done == [0]
        assert mon.evict_lost() == [1]       # lost worker 1 is evicted
        t.join(5)
        assert done == [0, 1]                # ...and the survivor runs
        with pytest.raises(Exception, match="status 5"):
            c1.barrier(1)
        assert mon.lost_workers() == [] and mon.evicted == [1]
    finally:
        srv.stop()


def test_four_workers_push_the_same_rows_atomically():
    srv = tps.Server(tables=_tables(tps), num_workers=4).start()
    try:
        ep = [f"127.0.0.1:{srv.port}"]
        ids = np.array([1, 2, 3, 1], np.uint64)
        base = _client(tps, ep).pull_sparse(2, ids, 3)
        clients = [_client(tps if i % 2 else jps, ep) for i in range(4)]

        def work(c):
            for _ in range(25):
                c.push_sparse(2, ids, np.ones((4, 3), np.float32))

        ts = [threading.Thread(target=work, args=(c,)) for c in clients]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        got = _client(tps, ep).pull_sparse(2, ids, 3)
        # id 1 appears twice a push: 4 workers x 25 pushes x (1 or 2) x lr
        want = base - 0.5 * 100 * np.array([2, 1, 1, 2])[:, None]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    finally:
        srv.stop()


def test_port_and_jax_clients_of_one_process_push_under_distinct_ids():
    """Both packages number their clients pid << 20 | a count of their
    own; the port's set bit 63, so the n-th client of each package never
    shares the server's dedup key and neither one's pushes are dropped
    as the other's retries."""
    srv = tps.Server(tables=_tables(tps), num_workers=2).start()
    try:
        ep = [f"127.0.0.1:{srv.port}"]
        ports = [_client(tps, ep) for _ in range(3)]
        jaxs = [_client(jps, ep) for _ in range(3)]
        ids = {c._push_id for c in ports + jaxs}
        assert len(ids) == 6
        assert all(c._push_id >> 63 for c in ports)
        assert not any(c._push_id >> 63 for c in jaxs)
        pid = os.getpid() & 0xFFFFFFFF
        assert all((c._push_id >> 20) & 0xFFFFFFFF == pid
                   for c in ports + jaxs)
    finally:
        srv.stop()


def test_registry_serve_and_shutdown_workers():
    class Role:
        def get_pserver_endpoints(self):
            return [f"127.0.0.1:{port}"]

        def server_index(self):
            return 0

        def worker_num(self):
            return 1

    tps.clear_registry()
    tps.register_table(tps.TableConfig(2, "sparse", dim=3, optimizer="sgd"))
    assert [t.table_id for t in tps.registered_tables()] == [2]
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    srv = tps.serve(Role(), block=False)
    try:
        cli = tps.connect_workers([f"127.0.0.1:{port}"])
        assert tps.client() is cli
        cli.pull_sparse(2, np.array([7], np.uint64), 3)
        assert srv.sparse_rows(2) == 1
        tps.shutdown_workers([f"127.0.0.1:{port}"])
        srv.join(poll=0.05)                  # the server saw the stop
    finally:
        srv.stop()
        tps.clear_registry()
    with pytest.raises(Exception, match="connect_workers"):
        tps.client()


# ------------------------------------------------------------ resilience
def _dense_sparse():
    return [tps.TableConfig(0, "dense", size=4, optimizer="sgd", lr=1.0),
            tps.TableConfig(1, "sparse", dim=4, optimizer="adagrad",
                            lr=0.1, init_range=0.01)]


def test_transient_faults_are_absorbed_and_counted():
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.utils import profiler
    srv = tps.Server(tables=_dense_sparse()).start()
    try:
        cli = _client(tps, [f"127.0.0.1:{srv.port}"])
        with fault_plan("ps.transport:pull_dense@1..2:raise"):
            out = cli.pull_dense(0, 4)
        np.testing.assert_array_equal(out, np.zeros(4, np.float32))
        assert cli.stats()["verbs"]["pull_dense"] == {
            "calls": 1, "ok": 1, "retries": 2, "failures": 0,
            "reconnects": 0}
        assert profiler.counters("ps.client.pull_dense")["retries"] == 2
        text = metrics.registry().prometheus_text()
        assert 'pt_ps_client_total{verb="pull_dense",event="retries"}' \
            in text
    finally:
        srv.stop()


def test_push_retried_after_a_lost_reply_applies_once():
    srv = tps.Server(tables=_dense_sparse()).start()
    srv2 = jps.Server(tables=[jps.TableConfig(1, "sparse", dim=4,
                                              optimizer="adagrad", lr=0.1,
                                              init_range=0.01)]).start()
    try:
        cli = _client(tps, [f"127.0.0.1:{srv.port}"])
        with fault_plan("ps.transport.after:push_dense@1:raise"):
            cli.push_dense(0, np.ones(4, np.float32))
        np.testing.assert_array_equal(cli.pull_dense(0, 4),
                                      np.full(4, -1.0, np.float32))
        ids = np.array([5, 9], np.uint64)
        with fault_plan("ps.transport.after:push_sparse@1:raise"):
            cli.push_sparse(1, ids, np.ones((2, 4), np.float32))
        once = cli.pull_sparse(1, ids, 4)
        ref = jps.Client([f"127.0.0.1:{srv2.port}"]).connect()
        ref.push_sparse(1, ids, np.ones((2, 4), np.float32))
        np.testing.assert_array_equal(once, ref.pull_sparse(1, ids, 4))
    finally:
        srv.stop()
        srv2.stop()


def test_reconnect_after_a_server_restart():
    srv = tps.Server(tables=_dense_sparse()).start()
    port = srv.port
    cli = _client(tps, [f"127.0.0.1:{port}"],
                  retry_policy=_fast_policy(max_attempts=8, deadline=30))
    cli.push_dense(0, np.ones(4, np.float32))
    srv.stop()
    del srv
    srv2 = jps.Server(port=port, tables=[
        jps.TableConfig(0, "dense", size=4, optimizer="sgd", lr=1.0)]).start()
    try:
        np.testing.assert_array_equal(cli.pull_dense(0, 4),
                                      np.zeros(4, np.float32))
        assert sum(v["reconnects"]
                   for v in cli.stats()["verbs"].values()) >= 1
    finally:
        srv2.stop()


def test_failover_to_a_backup_past_the_budget():
    primary = tps.Server(tables=_dense_sparse()).start()
    backup = tps.Server(tables=_dense_sparse()).start()
    cli = _client(tps, [f"127.0.0.1:{primary.port}"],
                  backup_endpoints=[f"127.0.0.1:{backup.port}"],
                  retry_policy=_fast_policy(max_attempts=10, base_delay=0.02,
                                            deadline=30),
                  failover_after=0.05)
    cli.pull_dense(0, 4)
    primary.stop()
    try:
        np.testing.assert_array_equal(cli.pull_dense(0, 4),
                                      np.zeros(4, np.float32))
        fo = cli.stats()["failovers"]
        assert len(fo) == 1 and fo[0]["to"] == f"127.0.0.1:{backup.port}"
        cli.push_dense(0, np.ones(4, np.float32))
        np.testing.assert_array_equal(cli.pull_dense(0, 4),
                                      np.full(4, -1.0, np.float32))
    finally:
        backup.stop()


def test_retry_safety_classes_match_the_reference():
    assert tps.RETRY_SAFETY == jps.RETRY_SAFETY
    srv = tps.Server(tables=_dense_sparse()).start()
    try:
        cli = _client(tps, [f"127.0.0.1:{srv.port}"])
        for verb in ("pull_sparse", "pull_dense", "heartbeat",
                     "push_sparse", "push_dense"):
            assert cli._retryable(verb, RuntimeError(
                f"ps.{verb}: recv failed from 127.0.0.1:1"))
        assert not cli._retryable("barrier", RuntimeError(
            "ps.barrier: recv failed from 127.0.0.1:1"))
        assert cli._retryable("barrier", RuntimeError(
            "ps.barrier: send failed to 127.0.0.1:1"))
        assert not cli._retryable("pull_dense", RuntimeError(
            "ps.pull_dense: server error status 1 from 127.0.0.1:1"))
        assert cli._retryable("barrier", FaultError("ps.transport:barrier"))
        assert cli._retryable("push_dense",
                              FaultError("ps.transport.after:push_dense"))
        assert not cli._retryable("stop_servers",
                                  FaultError("ps.transport:stop"))
    finally:
        srv.stop()


def test_flags_set_the_default_retry_policy():
    from paddle_tpu_torch.core import flags
    prev = flags.get_flag("ps_retry_attempts")
    try:
        flags.set_flag("ps_retry_attempts", 7)
        assert tps.default_retry_policy().max_attempts == 7
    finally:
        flags.set_flag("ps_retry_attempts", prev)


def test_heartbeat_thread_records_its_terminal_failure():
    srv = tps.Server(tables=_dense_sparse()).start()
    try:
        cli = _client(tps, [f"127.0.0.1:{srv.port}"],
                      retry_policy=_fast_policy(max_attempts=2,
                                                deadline=0.5))
        with fault_plan("ps.transport:heartbeat@*:raise"):
            cli.start_heartbeat(worker_id=3, interval=0.02)
            deadline = time.monotonic() + 5
            while (cli.stats()["heartbeat"]["alive"]
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        hb = cli.stats()["heartbeat"]
        assert not hb["alive"] and "heartbeat" in hb["error"]
    finally:
        srv.stop()


def test_async_communicator_drains_on_stop():
    srv = tps.Server(tables=_dense_sparse()).start()
    try:
        cli = _client(tps, [f"127.0.0.1:{srv.port}"])
        ids = np.array([3, 8], np.uint64)
        base = cli.pull_sparse(1, ids, 4).copy()
        comm = tps.AsyncCommunicator(cli, merge_interval=0.5).start()
        for _ in range(4):
            comm.push_sparse_async(1, ids, np.ones((2, 4), np.float32))
        assert comm.stop(timeout=5.0) == 0 and comm.pending() == 0
        assert not np.array_equal(cli.pull_sparse(1, ids, 4), base)
    finally:
        srv.stop()
    # a dead server: stop reports what it could not deliver
    comm = tps.AsyncCommunicator(cli, merge_interval=0.01)
    comm.push_sparse_async(1, ids, np.ones((2, 4), np.float32))
    assert comm.stop(timeout=1.0) == 1
    with pytest.raises(RuntimeError):
        cli.pull_dense(0, 4)


def _deepfm_loop(plan, steps=4):
    """chip_smoke phase 39's PS trainer at a tiny DeepFM: (losses, final
    rows, the faults fired)."""
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
    cfg = DeepFMConfig.tiny()
    rng = np.random.RandomState(5)
    batches = [cs.ps_records(rng, 16, cfg) for _ in range(steps)]
    nn.seed(0)
    model = DeepFM(cfg, device="cpu")
    srv = tps.Server(tables=cs.ps_tables(cfg)).start()
    try:
        with fault_plan(plan) if plan else contextlib.nullcontext() as armed:
            cli = _client(tps, [f"127.0.0.1:{srv.port}"],
                          retry_policy=_fast_policy(max_attempts=6,
                                                    deadline=30))
            tr = cs.PSTrainer(torch, model, cli)
            losses = [tr.step(*b) for b in batches]
        ids = np.unique(np.concatenate([model.flat_ids(b[1]).ravel()
                                        for b in batches]))
        rows = cli.pull_sparse(2, ids, cfg.embed_dim)
        fired = armed.stats()["fired"] if plan else {}
    finally:
        srv.stop()
    return losses, rows, fired


def test_faulty_transport_deepfm_loop_equals_the_fault_free_one():
    want_l, want_r, _ = _deepfm_loop(None)
    plan = ("ps.transport:connect@1:raise;"
            "ps.transport:pull_sparse@2..3:raise;"
            "ps.transport:push_sparse@2:raise;"
            "ps.transport.after:push_sparse@3:raise;"
            "ps.transport.after:push_sparse@6:raise")
    got_l, got_r, fired = _deepfm_loop(plan)
    assert fired.get("ps.transport:pull_sparse", 0) >= 2
    assert fired.get("ps.transport.after:push_sparse", 0) >= 2
    assert got_l == want_l
    np.testing.assert_array_equal(got_r, want_r)
