"""The port's generation server against the JAX package's (CPU).

The same weights and requests go to `paddle_tpu.serving.generation` and
`paddle_tpu_torch.serving.generation`, over each engine; greedy tokens
must be identical. Then the server's own behaviour, driven step by step
with no threads where it can be: cancel, queue bound, drain and abort,
fault injection at the generation choke points, and parking admission
on an exhausted block pool.
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
    from paddle_tpu_torch.static import io as tio
    src = "".join(pathlib.Path(m.__file__).read_text()
                  for m in (tserve, tgen, tinf, tio))
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
