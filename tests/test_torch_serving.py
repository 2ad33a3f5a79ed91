"""The port's serving layer against the JAX package's (CPU).

Generation: the same weights and requests go to
`paddle_tpu.serving.generation` and `paddle_tpu_torch.serving.generation`,
over each engine; greedy tokens must be identical. Then the server's own
behaviour, driven step by step with no threads where it can be: cancel,
queue bound, drain and abort, fault injection at the generation choke
points, and parking admission on an exhausted block pool.

One-shot serving (`serving.batcher` / `serving.pool`): the dynamic
batcher forms the JAX batcher's batches from the same seeded arrival
sequence on a fake clock (same requests, buckets and expiries); the JAX
package's batcher, parking-heap and server-robustness cases run on the
port; over a real port Predictor the batched outputs equal the port's
serial `Predictor.run` within the float32 tolerance of
tests/test_torch_inference.py (1e-4 / 1e-5) and the JAX Predictor's on
the same saved model within the same. Under
tests/test_torch_executor_capture.py's `cuda_tape` (the capture path on
CPU tensors) each bucket is one captured entry, traffic after warmup
captures nothing, a second server restores the ladder from the compile
cache's manifest, and 8 threads replaying one shared captured entry
each get back their own rows.
"""
import jax
import numpy as np
import pytest

from paddle_tpu.ops import generation as jgen
from paddle_tpu.serving import generation as jserve
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import generation as tgen
from paddle_tpu_torch.reliability.faults import KNOWN_SITES, fault_plan
from paddle_tpu_torch.serving import generation as tserve
from paddle_tpu_torch.serving.batcher import QueueFullError, ServerClosed
from paddle_tpu_torch.weights import params_from_jax

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
           max_len=64)
CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    jmodel = jgen.TinyDecoderLM(jgen.LMConfig(**CFG))
    jparams = jmodel.init_params(11)
    tmodel = tgen.TinyDecoderLM(tgen.LMConfig(**CFG), device=CPU)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _requests(seed, n=6):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 64, size=16)
    out = []
    for i in range(n):
        tail = rng.randint(1, 64, size=rng.randint(2, 12))
        prompt = np.concatenate([shared, tail]) if i % 2 else tail
        out.append((prompt.astype(np.int32), int(rng.randint(4, 14))))
    return out


def _serve(server, requests):
    try:
        reqs = [server.submit(p, n) for p, n in requests]
        return [r.result(timeout=120)["tokens"] for r in reqs]
    finally:
        server.shutdown(drain=False, timeout=30)


def _drive(batcher, limit=2000):
    steps = 0
    while not batcher.idle():
        batcher.step(now=float(steps))
        steps += 1
        assert steps < limit, "batcher failed to drain"
    return steps


# ---------------------------------------------------------------------
# parity with the JAX server
# ---------------------------------------------------------------------

def test_contiguous_server_matches_jax_server(models):
    jmodel, jparams, tmodel = models
    reqs = _requests(1)
    want = _serve(jserve.GenerationServer(
        jgen.DecodeEngine(jmodel, jparams, batch_size=3, max_len=64),
        idle_wait_s=0.001), reqs)
    got = _serve(tserve.GenerationServer(
        tgen.DecodeEngine(tmodel, batch_size=3, max_len=64, device=CPU),
        idle_wait_s=0.001), reqs)
    assert got == want


def test_paged_server_with_draft_matches_jax_server(models):
    jmodel, jparams, tmodel = models
    reqs = _requests(2)
    want = _serve(jserve.GenerationServer(
        jgen.PagedDecodeEngine(jmodel, jparams, batch_size=3, max_len=64,
                               block_size=8, spec_k=2),
        draft=jgen.NgramDraft(64), idle_wait_s=0.001), reqs)
    srv = tserve.GenerationServer(
        tgen.PagedDecodeEngine(tmodel, batch_size=3, max_len=64,
                               block_size=8, spec_k=2, device=CPU),
        draft=tgen.NgramDraft(64), idle_wait_s=0.001)
    stats_before = srv.stats()["speculative"]
    got = _serve(srv, reqs)
    assert got == want
    assert stats_before["verify_ticks"] == 0
    spec = srv.stats()["speculative"]
    assert spec["prefix_hit_admissions"] >= 1
    assert spec["verify_ticks"] + spec["plain_ticks"] >= 1


# ---------------------------------------------------------------------
# batcher behaviour (deterministic, no threads)
# ---------------------------------------------------------------------

def test_cancelled_client_frees_slot_next_tick(models):
    _, _, tmodel = models
    eng = tgen.DecodeEngine(tmodel, batch_size=1, max_len=64, device=CPU)
    b = tserve.ContinuousBatcher(eng)
    hog = b.submit(tserve.GenerationRequest([2], 30, enqueued_at=0.0))
    queued = b.submit(tserve.GenerationRequest([5, 5], 4, enqueued_at=0.0))
    b.step()
    assert b.live_slots == 1 and b.queue_depth == 1
    hog.cancel()
    b.step()                      # retire hog, admit queued SAME tick
    assert b.live_slots == 1
    _drive(b)
    ref = tgen.greedy_decode(tmodel, [5, 5], 4, device=CPU)
    assert queued.result(timeout=0)["tokens"] == ref.tolist()
    with pytest.raises(tserve.GenerationAborted):
        hog.result(timeout=0)
    assert b.counters.eval()["cancelled"] == 1


def test_queue_bound_and_validation(models):
    _, _, tmodel = models
    eng = tgen.DecodeEngine(tmodel, batch_size=1, max_len=32, device=CPU)
    b = tserve.ContinuousBatcher(eng, max_queue=2)
    b.submit(tserve.GenerationRequest([1], 4, enqueued_at=0.0))
    b.submit(tserve.GenerationRequest([1], 4, enqueued_at=0.0))
    with pytest.raises(QueueFullError):
        b.submit(tserve.GenerationRequest([1], 4, enqueued_at=0.0))
    assert b.counters.eval()["rejected"] == 1
    with pytest.raises(EnforceError):
        # prompt + budget exceeds the (batch, max_len) rung
        tserve.ContinuousBatcher(eng).submit(tserve.GenerationRequest(
            [1] * 10, 30, enqueued_at=0.0))


def test_drain_finishes_queued_and_abort_fails_them(models):
    _, _, tmodel = models
    eng = tgen.DecodeEngine(tmodel, batch_size=1, max_len=64, device=CPU)
    with tserve.GenerationServer(eng, idle_wait_s=0.001) as srv:
        reqs = [srv.submit([3 + i], 5) for i in range(3)]
    # __exit__ drained: every request finished with its full budget
    assert all(r.result(timeout=0)["stop_cause"] == "max_tokens"
               for r in reqs)
    b = tserve.ContinuousBatcher(tgen.DecodeEngine(
        tmodel, batch_size=1, max_len=64, device=CPU))
    running = b.submit(tserve.GenerationRequest([2], 30, enqueued_at=0.0))
    queued = b.submit(tserve.GenerationRequest([3], 4, enqueued_at=0.0))
    b.step()
    b.close(drain=False)
    with pytest.raises(ServerClosed):
        queued.result(timeout=0)
    with pytest.raises(tserve.GenerationAborted):
        running.result(timeout=0)
    with pytest.raises(ServerClosed):
        b.submit(tserve.GenerationRequest([1], 2, enqueued_at=0.0))


def test_stream_yields_what_result_returns(models):
    _, _, tmodel = models
    eng = tgen.DecodeEngine(tmodel, batch_size=2, max_len=64, device=CPU)
    with tserve.GenerationServer(eng, idle_wait_s=0.001) as srv:
        req = srv.submit([3, 4, 5], max_new_tokens=6)
        streamed = list(req.stream(timeout=30.0))
        res = req.result(timeout=30.0)
        assert streamed == res["tokens"]
        assert res["ttft_s"] is not None and res["ttft_s"] >= 0
        assert srv.stats()["counters"]["completed"] == 1


def test_lockstep_baseline_matches_continuous_tokens(models):
    _, _, tmodel = models
    eng = tgen.DecodeEngine(tmodel, batch_size=2, max_len=64, device=CPU)
    budgets = [3, 9, 3]
    reqs = [tserve.GenerationRequest([4 + i, 7], n, enqueued_at=0.0)
            for i, n in enumerate(budgets)]
    results, steps = tserve.lockstep_generate(eng, reqs)
    for i, (n, toks) in enumerate(zip(budgets, results)):
        ref = tgen.greedy_decode(tmodel, [4 + i, 7], n, device=CPU)
        assert toks == ref.tolist()
    assert steps == (9 - 1) + (3 - 1)    # each wave pays its longest


# ---------------------------------------------------------------------
# chaos choke points
# ---------------------------------------------------------------------

def test_prefill_fault_fails_only_that_request(models):
    _, _, tmodel = models
    eng = tgen.DecodeEngine(tmodel, batch_size=2, max_len=64, device=CPU)
    b = tserve.ContinuousBatcher(eng)
    with fault_plan("generation.prefill:s0@1:raise"):
        victim = b.submit(tserve.GenerationRequest([2], 4, enqueued_at=0.0))
        survivor = b.submit(tserve.GenerationRequest([3], 4,
                                                     enqueued_at=0.0))
        _drive(b)
    with pytest.raises(tserve.GenerationAborted, match="prefill fault"):
        victim.result(timeout=0)
    ref = tgen.greedy_decode(tmodel, [3], 4, device=CPU)
    assert survivor.result(timeout=0)["tokens"] == ref.tolist()
    assert b.counters.eval()["prefill_faults"] == 1


def test_decode_and_verify_faults_skip_ticks_exactly(models):
    _, _, tmodel = models
    ref = tgen.greedy_decode(tmodel, [4, 5], 6, device=CPU).tolist()
    b = tserve.ContinuousBatcher(tgen.DecodeEngine(
        tmodel, batch_size=1, max_len=64, device=CPU))
    with fault_plan("generation.decode_step@2..3:raise"):
        r = b.submit(tserve.GenerationRequest([4, 5], 6, enqueued_at=0.0))
        _drive(b)
    assert r.result(timeout=0)["tokens"] == ref
    assert b.counters.eval()["step_faults"] == 2
    draft = tgen.NgramDraft(64)
    draft.observe([4, 5] + ref)
    pb = tserve.PagedBatcher(tgen.PagedDecodeEngine(
        tmodel, batch_size=1, max_len=64, block_size=8, spec_k=2,
        device=CPU), draft=draft)
    with fault_plan("generation.verify_step@1:raise;"
                    "generation.draft_step@2:raise"):
        r = pb.submit(tserve.GenerationRequest([4, 5], 6, enqueued_at=0.0))
        _drive(pb)
    assert r.result(timeout=0)["tokens"] == ref
    spec = pb.spec_counters.eval()
    assert spec["verify_faults"] == 1 and spec["draft_faults"] == 1


def test_every_known_site_has_a_call_site():
    import pathlib
    from paddle_tpu_torch import inference as tinf
    from paddle_tpu_torch.serving import gateway as tgw
    from paddle_tpu_torch.serving import pool as tpool
    from paddle_tpu_torch.serving import registry as treg
    from paddle_tpu_torch.serving import wire as twire
    from paddle_tpu_torch.static import io as tio
    from paddle_tpu_torch.core import compile_cache as tcc
    from paddle_tpu_torch.fleet import backend as tfb
    from paddle_tpu_torch.fleet import discovery as tfd
    from paddle_tpu_torch.fleet import router as tfr
    from paddle_tpu_torch.reliability import checkpoint as tck
    from paddle_tpu_torch.reliability import training as ttr
    from paddle_tpu_torch import ps as tps
    src = "".join(pathlib.Path(m.__file__).read_text()
                  for m in (tserve, tgen, tinf, tio, tpool, tgw, treg,
                            twire, tcc, tfb, tfd, tfr, tck, ttr, tps))
    for site in KNOWN_SITES:
        assert f'inject_point("{site}"' in src, site


# ---------------------------------------------------------------------
# paged admission under pool pressure
# ---------------------------------------------------------------------

def test_exhausted_pool_parks_fifo_and_drains(models):
    _, _, tmodel = models
    # 9 blocks: the garbage block + one full slot (8 x 8 positions)
    eng = tgen.PagedDecodeEngine(tmodel, batch_size=2, max_len=64,
                                 block_size=8, num_blocks=9, spec_k=0,
                                 device=CPU)
    b = tserve.PagedBatcher(eng)
    big = b.submit(tserve.GenerationRequest([1] * 20, 40, enqueued_at=0.0))
    small = b.submit(tserve.GenerationRequest([7, 8], 3, enqueued_at=0.0))
    b.step()
    # big holds all 8 blocks; small parks at the head of the queue
    assert b.live_slots == 1 and b.queue_depth == 1
    assert b.spec_counters.eval()["parked"] >= 1
    _drive(b)
    for req in (big, small):
        ref = tgen.greedy_decode(tmodel, req.prompt, req.max_new_tokens,
                                 device=CPU)
        assert req.result(timeout=0)["tokens"] == ref.tolist()
    pool = eng.pool.stats()
    assert pool["live"] == 0
    assert pool["free"] + pool["cached"] == eng.num_blocks - 1


def test_spans_parent_under_the_request_context(models):
    from paddle_tpu_torch.observability import trace
    _, _, tmodel = models
    tracer = trace.get_tracer()
    tracer.reset()
    root = trace.start_span("client.request")
    b = tserve.ContinuousBatcher(tgen.DecodeEngine(
        tmodel, batch_size=1, max_len=64, device=CPU))
    b.submit(tserve.GenerationRequest([3, 4], 3, enqueued_at=0.0,
                                      trace_ctx=root))
    _drive(b)
    root.finish()
    spans = tracer.finished_spans()
    gen_spans = [s for s in spans if s.name == "serving.generate"]
    steps = [s for s in spans if s.name == "serving.decode_step"]
    assert len(gen_spans) == 1 and len(steps) == 2
    assert all(s.parent is root for s in gen_spans + steps)
    assert len({s.trace_id for s in spans}) == 1
    assert gen_spans[0].attrs["tokens"] == 3
    assert gen_spans[0].attrs["stop_cause"] == "max_tokens"
    trace.set_enabled(False)
    try:
        assert trace.start_span("x").finish() is not None
        assert len(tracer.finished_spans()) == len(spans)
    finally:
        trace.set_enabled(True)


# =====================================================================
# one-shot serving: the dynamic batcher and the replica pool
# =====================================================================

import threading  # noqa: E402
import time  # noqa: E402

from paddle_tpu.serving import batcher as jbatcher  # noqa: E402
from paddle_tpu_torch.reliability.faults import (  # noqa: E402
    fault_plan as tfault_plan,
)
from paddle_tpu_torch.serving import batcher as tbatcher  # noqa: E402
from paddle_tpu_torch.serving.batcher import (  # noqa: E402
    Batch, DynamicBatcher, Request, RequestTimeout, default_buckets,
)
from paddle_tpu_torch.serving.pool import (  # noqa: E402
    InferenceServer, ReplicaHealth,
)

#: float32 predictors, as tests/test_torch_inference.py holds them
TOL = dict(rtol=1e-4, atol=1e-5)


def _req(rows, t, deadline=None, dim=2, mod=tbatcher):
    # row i of a request carries value i+1 in every column, so padding
    # (a copy of the LAST row) is distinguishable from real rows
    x = np.arange(1, rows + 1, dtype=np.float32).reshape(rows, 1)
    return mod.Request({"x": np.repeat(x, dim, axis=1)}, enqueued_at=t,
                       deadline=deadline)


@pytest.mark.parametrize("n", [1, 5, 8, 12, 32])
def test_default_buckets_match_jax(n):
    assert default_buckets(n) == jbatcher.default_buckets(n)


def _arrivals(seed, n=48):
    """A seeded arrival sequence: (time, rows, deadline, priority) per
    request, with polls between arrivals and some retries."""
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.002))
        rows = int(rng.randint(1, 4))
        deadline = t + float(rng.uniform(0.002, 0.02)) \
            if rng.rand() < 0.3 else None
        out.append((t, rows, deadline, int(rng.randint(0, 3)),
                    bool(rng.rand() < 0.15), bool(rng.rand() < 0.1)))
    return out


def _replay(mod, buckets, arrivals, max_queue):
    """Feed one arrival sequence to `mod`'s DynamicBatcher on a fake
    clock; returns what happened: formed batches (request ids, bucket,
    padded feed), expiries, rejections, preemptions."""
    now = [0.0]
    b = mod.DynamicBatcher(buckets, max_wait=0.004, max_queue=max_queue,
                           clock=lambda: now[0])
    log, reqs = [], {}
    for i, (t, rows, deadline, prio, retry, preempt) in enumerate(
            arrivals):
        now[0] = t
        x = np.full((rows, 2), i, np.float32)
        r = mod.Request({"x": x}, enqueued_at=t, deadline=deadline,
                        priority=prio)
        reqs[id(r)] = i
        try:
            b.put(r)
        except mod.QueueFullError:
            if preempt and b.preempt_lower(prio) is not None:
                b.put(r)
                log.append(("preempted-for", i))
            else:
                log.append(("rejected", i))
        for _ in range(2):
            batch = b.poll(now=t)
            if batch is None:
                break
            ids = [reqs[id(q)] for q in batch.requests]
            log.append(("batch", t, ids, batch.bucket,
                        batch.build_feed()["x"].tolist()))
            if retry:
                for q in batch.requests:
                    q.ready_at = t + 0.003
                b.requeue(batch.requests)
                log.append(("requeued", ids))
    now[0] += 1.0
    b.close(drain=True)
    while True:
        batch = b.poll(now=now[0])
        if batch is None:
            break
        log.append(("batch", now[0], [reqs[id(q)] for q in batch.requests],
                    batch.bucket, None))
    return log


@pytest.mark.parametrize("seed,buckets,max_queue", [
    (0, [1, 2, 4, 8], 64), (1, [1, 2, 4], 6), (2, [4], 5), (3, [1, 3, 8], 8)])
def test_batcher_forms_the_jax_batches(seed, buckets, max_queue):
    arrivals = _arrivals(seed)
    want = _replay(jbatcher, buckets, arrivals, max_queue)
    got = _replay(tbatcher, buckets, arrivals, max_queue)
    assert got == want
    assert any(e[0] == "batch" for e in got)


def test_full_bucket_flushes_immediately():
    b = DynamicBatcher([1, 2, 4, 8], max_wait=10.0, max_queue=64,
                       clock=lambda: 0.0)
    for _ in range(8):
        b.put(_req(1, t=0.0))
    batch = b.poll(now=0.0)
    assert batch.bucket == 8 and batch.rows == 8 and batch.occupancy == 1
    assert b.poll(now=0.0) is None


def test_max_wait_flush_and_bucket_selection():
    b = DynamicBatcher([1, 2, 4, 8], max_wait=0.010, max_queue=64,
                       clock=lambda: 0.0)
    b.put(_req(1, t=0.000))
    b.put(_req(2, t=0.001))
    assert b.poll(now=0.009) is None
    batch = b.poll(now=0.010)
    assert batch.rows == 3 and batch.bucket == 4
    assert batch.occupancy == pytest.approx(0.75)


def test_padding_replicates_last_row():
    b = DynamicBatcher([4], max_wait=0.0, max_queue=64, clock=lambda: 0.0)
    b.put(_req(1, t=0.0))
    b.put(_req(2, t=0.0))
    feed = b.poll(now=0.0).build_feed()
    np.testing.assert_array_equal(feed["x"][:, 0], [1.0, 1.0, 2.0, 2.0])


def test_fifo_take_never_splits_or_reorders():
    b = DynamicBatcher([1, 2, 4], max_wait=0.0, max_queue=64,
                       clock=lambda: 0.0)
    r1, r2, r3 = _req(3, 0.0), _req(3, 0.0), _req(1, 0.0)
    for r in (r1, r2, r3):
        b.put(r)
    first = b.poll(now=0.0)
    assert first.requests == [r1] and first.bucket == 4
    second = b.poll(now=0.0)
    assert second.requests == [r2, r3] and second.bucket == 4


def test_deadline_expiry_in_queue():
    b = DynamicBatcher([1, 2], max_wait=10.0, max_queue=64,
                       clock=lambda: 0.0)
    r1 = _req(1, t=0.0, deadline=0.005)
    r2 = _req(1, t=0.0)
    b.put(r1)
    b.put(r2)
    assert b.poll(now=0.006) is None
    with pytest.raises(RequestTimeout):
        r1.result(timeout=0)
    assert b.poll(now=10.0).requests == [r2]


def test_backpressure_oversize_and_unbatched_fetch():
    b = DynamicBatcher([4], max_wait=10.0, max_queue=2, clock=lambda: 0.0)
    b.put(_req(1, t=0.0))
    b.put(_req(1, t=0.0))
    with pytest.raises(QueueFullError):
        b.put(_req(1, t=0.0))
    with pytest.raises(EnforceError):
        DynamicBatcher([1, 2], max_wait=0.0, max_queue=8).put(
            _req(3, t=0.0))
    batch = Batch([_req(1, 0.0), _req(2, 0.0)], 4)
    with pytest.raises(EnforceError):
        batch.scatter([np.zeros((2, 3), np.float32)])


class _TickClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class TestRequeueParkingHeap:
    def test_parked_until_ready_then_front(self):
        clk = _TickClock()
        b = DynamicBatcher([1, 2, 4], max_wait=0.0, max_queue=64,
                           clock=clk)
        fresh = _req(1, t=0.0)
        b.put(fresh)
        retry = _req(1, t=0.0)
        retry.ready_at = 5.0
        b.requeue([retry])
        assert b.depth == 2
        assert b.poll(now=0.0).requests == [fresh]
        assert b.poll(now=4.99) is None
        clk.t = 5.0
        assert b.poll(now=5.0).requests == [retry]

    def test_matured_retry_jumps_queue_front(self):
        clk = _TickClock()
        b = DynamicBatcher([1], max_wait=0.0, max_queue=64, clock=clk)
        retry = _req(1, t=0.0)
        retry.ready_at = 1.0
        b.requeue([retry])
        fresh = _req(1, t=0.5)
        b.put(fresh)
        clk.t = 1.0
        assert b.poll(now=1.0).requests == [retry]
        assert b.poll(now=1.0).requests == [fresh]

    def test_promotion_order_among_matured(self):
        clk = _TickClock()
        b = DynamicBatcher([1], max_wait=0.0, max_queue=64, clock=clk)
        r_late, r_early = _req(1, t=0.0), _req(1, t=0.0)
        r_late.ready_at, r_early.ready_at = 2.0, 1.0
        b.requeue([r_late])
        b.requeue([r_early])
        clk.t = 3.0
        assert b.poll(now=3.0).requests == [r_early]
        assert b.poll(now=3.0).requests == [r_late]

    def test_parked_request_can_expire(self):
        clk = _TickClock()
        b = DynamicBatcher([1], max_wait=0.0, max_queue=64, clock=clk)
        retry = _req(1, t=0.0, deadline=1.0)
        retry.ready_at = 5.0
        b.requeue([retry])
        clk.t = 2.0
        assert b.poll(now=2.0) is None
        with pytest.raises(RequestTimeout):
            retry.result(timeout=0)
        assert b.depth == 0

    def test_wait_timeout_sees_heap_top(self):
        b = DynamicBatcher([4], max_wait=10.0, max_queue=64,
                           clock=_TickClock())
        retry = _req(1, t=0.0)
        retry.ready_at = 3.0
        b.requeue([retry])
        with b._cond:
            assert b._wait_timeout(0.0) == pytest.approx(3.0)

    def test_close_nodrain_rejects_parked(self):
        b = DynamicBatcher([1], max_wait=0.0, max_queue=64,
                           clock=_TickClock())
        retry = _req(1, t=0.0)
        retry.ready_at = 5.0
        b.requeue([retry])
        b.close(drain=False)
        with pytest.raises(ServerClosed):
            retry.result(timeout=0)

    def test_drain_waits_for_parked(self):
        clk = _TickClock()
        b = DynamicBatcher([1], max_wait=0.0, max_queue=64, clock=clk)
        retry = _req(1, t=0.0)
        retry.ready_at = 1.0
        b.requeue([retry])
        b.close(drain=True)
        assert b.poll(now=0.0) is None
        clk.t = 1.0
        assert b.poll(now=1.0).requests == [retry]

    def test_requeue_bypasses_bound_but_not_nondrain_close(self):
        b = DynamicBatcher([1], max_wait=0.0, max_queue=1,
                           clock=lambda: 0.0)
        b.put(_req(1, 0.0))
        b.requeue([_req(1, 0.0)])
        assert b.depth == 2
        b.close(drain=False)
        r = _req(1, 0.0)
        b.requeue([r])
        with pytest.raises(ServerClosed):
            r.result(timeout=0)


def test_breaker_open_halfopen_close_transitions():
    now = [0.0]
    events = []
    h = ReplicaHealth(0, threshold=3, cooldown=1.0, clock=lambda: now[0],
                      on_transition=lambda hh, kind: events.append(kind))
    boom = RuntimeError("boom")
    h.record_failure(boom)
    h.record_failure(boom)
    assert h.state == ReplicaHealth.HEALTHY
    h.record_failure(boom)
    assert h.state == ReplicaHealth.QUARANTINED
    assert h.admission_delay(now[0]) == pytest.approx(1.0)
    now[0] = 1.0
    assert h.admission_delay(now[0]) == 0.0
    assert h.state == ReplicaHealth.PROBING
    h.record_failure(boom, now=now[0])
    assert h.state == ReplicaHealth.QUARANTINED
    now[0] = 2.5
    assert h.admission_delay(now[0]) == 0.0
    h.record_success()
    assert h.state == ReplicaHealth.HEALTHY
    assert events == ["quarantine", "probe", "quarantine", "probe",
                      "readmit"]
    d = h.to_dict()
    assert d["quarantines"] == 2 and d["total_failures"] == 4


class _FakePredictor:
    """get_input_names / clone / run engine: y = 2x, optionally gated so
    a test controls when a batch 'executes'."""

    def __init__(self, gate=None, started=None):
        self.gate = gate
        self.started = started

    def get_input_names(self):
        return ["x"]

    def clone(self):
        return _FakePredictor(self.gate, self.started)

    def run(self, feed=None):
        if self.started is not None:
            self.started.set()
        if self.gate is not None:
            assert self.gate.wait(30), "test gate never opened"
        return [np.asarray(feed["x"]) * 2.0]


def _one():
    return {"x": np.ones((1, 2), np.float32)}


def test_server_backpressure_timeout_and_drain():
    gate, started = threading.Event(), threading.Event()
    srv = InferenceServer(_FakePredictor(gate, started), num_replicas=1,
                          buckets=[1], max_wait_ms=0, max_queue=2)
    r1 = srv.submit(_one())
    assert started.wait(10)
    r2 = srv.submit(_one(), timeout_ms=30)     # expires in the queue
    r3 = srv.submit(_one())
    with pytest.raises(QueueFullError):
        srv.submit(_one())
    with pytest.raises(RequestTimeout):
        r1.result(timeout=0.05)                # client-side budget
    time.sleep(0.05)
    gate.set()
    for r in (r1, r3):
        np.testing.assert_array_equal(r.result(timeout=30)[0],
                                      np.full((1, 2), 2.0, np.float32))
    with pytest.raises(RequestTimeout):
        r2.result(timeout=30)
    st = srv.stats()
    srv.shutdown()
    assert st["requests"]["rejected"] == 1
    assert st["requests"]["timed_out"] == 1
    assert st["requests"]["completed"] == 2
    with pytest.raises(ServerClosed):
        srv.submit(_one())


def test_drain_completes_queued_and_nondrain_rejects():
    srv = InferenceServer(_FakePredictor(), num_replicas=1, buckets=[4],
                          max_wait_ms=60000, max_queue=8)
    reqs = [srv.submit({"x": np.full((1, 2), i, np.float32)})
            for i in range(3)]
    assert srv.shutdown(drain=True)["drained"]
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.result(timeout=0)[0],
                                      np.full((1, 2), 2.0 * i, np.float32))
    gate, started = threading.Event(), threading.Event()
    srv = InferenceServer(_FakePredictor(gate, started), num_replicas=1,
                          buckets=[1], max_wait_ms=0, max_queue=8)
    r1 = srv.submit(_one())
    assert started.wait(10)
    r2 = srv.submit(_one())
    srv.shutdown(drain=False, timeout=0.05)
    with pytest.raises(ServerClosed):
        r2.result(timeout=1)
    gate.set()
    np.testing.assert_array_equal(r1.result(timeout=30)[0],
                                  np.full((1, 2), 2.0, np.float32))
    srv.shutdown()
    assert srv.stats()["requests"]["cancelled"] == 1
    assert srv.stats()["shutdown"]["undrained_requests"] == 0


def test_failures_retry_on_a_healthy_replica_and_surface_when_spent():
    class _FailTwice(_FakePredictor):
        calls = 0

        def clone(self):
            return self

        def run(self, feed=None):
            type(self).calls += 1
            if type(self).calls <= 2:
                raise RuntimeError("transient")
            return super().run(feed=feed)

    srv = InferenceServer(_FailTwice(), num_replicas=1, buckets=[1],
                          max_wait_ms=0, max_queue=8, max_retries=3,
                          retry_backoff_ms=5, breaker_threshold=10)
    out = srv.infer(_one(), timeout_ms=20000)
    np.testing.assert_array_equal(out[0], np.full((1, 2), 2.0, np.float32))
    rel = srv.stats()["reliability"]
    srv.shutdown()
    assert rel["batch_failures"] == 2 and rel["retried_requests"] == 2

    class _Broken(_FakePredictor):
        def clone(self):
            return self

        def run(self, feed=None):
            raise RuntimeError("engine exploded")

    srv = InferenceServer(_Broken(), num_replicas=1, buckets=[1],
                          max_wait_ms=0, max_queue=8, max_retries=1,
                          retry_backoff_ms=1, breaker_threshold=100)
    req = srv.submit(_one())
    with pytest.raises(RuntimeError, match="engine exploded"):
        req.result(timeout=20)
    st = srv.stats()
    srv.shutdown()
    assert st["reliability"]["batch_failures"] == 2
    assert st["requests"]["failed"] == 1


def test_replica_kill_midstream_no_request_lost():
    feeds = [np.full((1, 2), i, np.float32) for i in range(40)]
    with tfault_plan("serving.run_batch:r1@1..4:raise"):
        srv = InferenceServer(_FakePredictor(), num_replicas=3,
                              buckets=[1, 2, 4], max_wait_ms=1,
                              max_queue=256, max_retries=5,
                              breaker_threshold=3, breaker_cooldown_ms=50,
                              retry_backoff_ms=5)
        try:
            reqs = []
            for f in feeds:
                reqs.append(srv.submit({"x": f}))
                time.sleep(0.001)
            for f, r in zip(feeds, reqs):
                np.testing.assert_array_equal(r.result(timeout=30)[0],
                                              f * 2.0)
            st = srv.stats()
        finally:
            srv.shutdown()
    assert st["requests"]["failed"] == 0
    assert st["reliability"]["batch_failures"] >= 1


def test_nan_guard_unbatched_fetch_and_feed_names():
    with tfault_plan("serving.run_batch@1:nan"):
        srv = InferenceServer(_FakePredictor(), num_replicas=1,
                              buckets=[1], max_wait_ms=0, max_queue=8,
                              max_retries=2, retry_backoff_ms=5,
                              breaker_threshold=100, guard_non_finite=True)
        try:
            out = srv.infer(_one(), timeout_ms=20000)
            np.testing.assert_array_equal(
                out[0], np.full((1, 2), 2.0, np.float32))
            assert srv.stats()["reliability"]["batch_failures"] == 1
            with pytest.raises(EnforceError):
                srv.submit({"y": np.ones((1, 2), np.float32)})
        finally:
            srv.shutdown()

    class _Scalar(_FakePredictor):
        def run(self, feed=None):
            return [np.float32(1.0)]

    srv = InferenceServer(_Scalar(), num_replicas=1, buckets=[2],
                          max_wait_ms=0, max_queue=8)
    r = srv.submit(_one())
    with pytest.raises(EnforceError, match="not batched along axis 0"):
        r.result(timeout=30)
    srv.shutdown()


# --- over real Predictors ------------------------------------------------

from test_torch_executor_capture import TapeGraph, cuda_tape  # noqa: E402,F401


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    """A tiny MLP saved once by the JAX package (x [8] -> fc 16 relu ->
    fc 4 softmax): the port and the JAX package load the same files."""
    import paddle_tpu as pt
    from paddle_tpu.core import ir as jir
    from paddle_tpu.core.scope import Scope as JScope, scope_guard as jguard
    d = str(tmp_path_factory.mktemp("mlp") / "model")
    main, startup = jir.Program(), jir.Program()
    startup.random_seed = 7
    with jir.program_guard(main, startup), jguard(JScope()):
        x = pt.static.data("x", [8], "float32")
        h = pt.static.fc(x, 16, act="relu")
        out = pt.static.fc(h, 4, act="softmax")
        exe = pt.Executor()
        exe.run(startup)
        pt.static.io.save_inference_model(d, ["x"], [out], exe,
                                          main_program=main)
    return d


def _port_predictor(model_dir):
    from paddle_tpu_torch import inference as tinf
    cfg = tinf.Config(model_dir)
    cfg.disable_gpu()
    return tinf.create_predictor(cfg)


def _feeds(seed, rows):
    rng = np.random.RandomState(seed)
    return [rng.rand(r, 8).astype(np.float32) for r in rows]


def test_batched_outputs_match_serial_port_and_jax(mlp_dir):
    from paddle_tpu import inference as jinf
    from paddle_tpu_torch.utils import profiler
    pred = _port_predictor(mlp_dir)
    jpred = jinf.create_predictor(jinf.Config(mlp_dir))
    feeds = _feeds(0, [1, 2, 3, 1, 2, 1, 1, 4, 2, 3, 1, 1])
    serial = [pred.run(feed={"x": f})[0] for f in feeds]
    jserial = [np.asarray(jpred.run(feed={"x": f})[0]) for f in feeds]
    profiler.reset_profiler()
    with InferenceServer(pred, num_replicas=2, max_batch_size=8,
                         max_wait_ms=20, max_queue=64) as srv:
        reqs = [srv.submit({"x": f}) for f in feeds]
        results = [r.result(timeout=60)[0] for r in reqs]
        st = srv.stats()
    for got, want, jwant in zip(results, serial, jserial):
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, jwant, **TOL)
    assert st["requests"]["completed"] == len(feeds)
    assert 0 < st["batches"]["count"] < len(feeds)
    assert st["buckets"] == [1, 2, 4, 8]
    assert st["latency_ms"]["p50"] <= st["latency_ms"]["p99"]
    assert "serving/batch_run" in [n for n, _, _ in profiler.host_events()]
    assert [d["code"] for d in st["startup_findings"]
            if d["severity"] != "info"] == []


def test_each_bucket_is_one_capture_and_traffic_captures_none(
        mlp_dir, cuda_tape):
    from paddle_tpu_torch.observability import profile as tprof
    pred = _port_predictor(mlp_dir)
    with InferenceServer(pred, num_replicas=2, buckets=[1, 2, 4],
                         max_wait_ms=2, max_queue=64) as srv:
        assert srv.warmup({"x": np.zeros((1, 8), np.float32)}) == [1, 2, 4]
        assert len(cuda_tape.made) == 3            # one graph per bucket
        graphs = tprof.compile_ledger().compile_events(
            scope=srv.ledger_scope, kind="graph")
        assert sorted(e.key for e in graphs) == ["bucket1", "bucket2",
                                                 "bucket4"]
        feeds = _feeds(1, [1, 2, 3, 4, 1, 3, 2, 1])
        reqs = [srv.submit({"x": f}) for f in feeds]
        got = [r.result(timeout=60)[0] for r in reqs]
        st = srv.stats()
    assert len(cuda_tape.made) == 3                # traffic: replays only
    assert st["compiles"] == {"bucket_misses": 0, "warmup": 3}
    assert sum(g.replays for g in cuda_tape.made) >= st["batches"]["count"]
    eager = _port_predictor(mlp_dir)
    for f, g in zip(feeds, got):
        np.testing.assert_allclose(g, eager.run(feed={"x": f})[0], **TOL)


def test_warm_start_restores_the_ladder(mlp_dir, cuda_tape, tmp_path):
    from paddle_tpu_torch.core import compile_cache as tcc
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu_torch.observability import profile as tprof
    tflags.set_flag("compile_cache_dir", str(tmp_path / "cc"))
    tcc.reset_compile_cache()
    ex = {"x": np.zeros((1, 8), np.float32)}
    try:
        with InferenceServer(_port_predictor(mlp_dir), buckets=[1, 2, 4],
                             max_wait_ms=2) as first:
            first.warmup(ex)
            assert first.stats()["warm_start"]["found"] is False
        name = first.warm_manifest_name()
        assert len(tcc.compile_cache().load_manifest(name)["entries"]) == 3
        with InferenceServer(_port_predictor(mlp_dir), buckets=[1, 2, 4],
                             max_wait_ms=2) as second:
            assert second.warm_manifest_name() == name
            made = len(cuda_tape.made)
            second.warmup(ex)
            ws = second.stats()["warm_start"]
            assert (ws["found"], ws["requested"], ws["loaded"],
                    ws["captured"]) == (True, 3, 3, 3)
            assert len(cuda_tape.made) == made + 3
            ledger = tprof.compile_ledger()
            assert ledger.compile_events(scope=second.ledger_scope) == []
            hits = ledger.cache_entries(event="hit",
                                        scope=second.ledger_scope)
            assert len([e for e in hits if e.kind == "graph"]) == 3
            second.infer({"x": np.ones((3, 8), np.float32)},
                         timeout_ms=60000)
            assert len(cuda_tape.made) == made + 3   # no capture
    finally:
        tflags.set_flag("compile_cache_dir", "")
        tcc.reset_compile_cache()


def test_threads_replaying_one_entry_get_their_own_rows(mlp_dir,
                                                       cuda_tape):
    """8 threads, each with its own rows, through one shared captured
    entry (a Predictor and 7 clones share the Executor): every output is
    the thread's own rows' result, bit for bit."""
    pred = _port_predictor(mlp_dir)
    clones = [pred] + [pred.clone() for _ in range(7)]
    feeds = _feeds(2, [4] * 8)
    want = [pred.run(feed={"x": f})[0] for f in feeds]   # the capture
    assert len(cuda_tape.made) == 1
    errors = []
    start = threading.Barrier(8)

    def worker(i):
        start.wait()
        for _ in range(25):
            got = clones[i].run(feed={"x": feeds[i]})[0]
            if not np.array_equal(got, want[i]):
                errors.append(i)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert len(cuda_tape.made) == 1 and cuda_tape.made[0].replays >= 200
    assert errors == []
