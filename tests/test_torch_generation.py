"""The port's generation engines against the JAX package's (CPU).

The same numpy-seeded weights and prompts go through
`paddle_tpu.ops.generation` and `paddle_tpu_torch.ops.generation`:

* the weights round-trip exactly between the two packages, and the
  port's `init_params(seed)` draws the JAX recipe's numbers;
* `forward_full` / cached-step logits agree at atol 1e-4 (float32; the
  two frameworks sum in different orders);
* greedy tokens from the port's DecodeEngine equal JAX `greedy_decode`
  and `generate_reference`, and the paged engine — with prefix reuse and
  speculative verify — gives the plain engine's tokens;
* BlockPool accounting follows the JAX tests' expectations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import generation as jgen
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import generation as tgen
from paddle_tpu_torch.weights import params_from_jax, params_to_numpy

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
           max_len=64)
CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    jmodel = jgen.TinyDecoderLM(jgen.LMConfig(**CFG))
    jparams = jmodel.init_params(3)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = tgen.TinyDecoderLM(tgen.LMConfig(**CFG), device=CPU)
    tmodel.load_state_dict(params_from_jax(tree))
    return jmodel, jparams, tree, tmodel


def _prompts(rng, n, lo=2, hi=12, vocab=64):
    return [rng.randint(1, vocab, size=rng.randint(lo, hi)).astype(
        np.int32) for _ in range(n)]


# ---------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------

def test_params_round_trip_is_exact(models):
    _, _, tree, tmodel = models
    back = params_to_numpy(tmodel)
    leaves_a = jax.tree_util.tree_leaves(tree)
    leaves_b = jax.tree_util.tree_leaves(back)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(back))
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_init_params_reproduces_jax_draws(models):
    _, _, tree, _ = models
    port = tgen.TinyDecoderLM(tgen.LMConfig(**CFG), device=CPU)
    port.init_params(3)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params_to_numpy(port))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------

def test_forward_full_logits_match_jax(models):
    jmodel, jparams, _, tmodel = models
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, CFG["vocab_size"], size=(2, 16)).astype(
        np.int32)
    lengths = np.asarray([16, 9], np.int32)
    jl, jks, _ = jmodel.forward_full(jparams, jnp.asarray(tokens),
                                     jnp.asarray(lengths))
    tl, tks, _ = tmodel.forward_full(torch.from_numpy(tokens).long(),
                                     torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tks[1].numpy(), np.asarray(jks[1]),
                               atol=1e-4, rtol=1e-4)


def test_prefill_and_step_logits_match_jax(models):
    """Two slots prefilled mid-flight, then three cached decode steps
    with one slot inactive: every logits row agrees with the JAX engine
    (forward_step through K5's plain version)."""
    jmodel, jparams, _, tmodel = models
    jeng = jgen.DecodeEngine(jmodel, jparams, batch_size=2, max_len=32)
    teng = tgen.DecodeEngine(tmodel, batch_size=2, max_len=32, device=CPU)
    js, ts = jeng.init_state(), teng.init_state()
    for slot, prompt in enumerate(([5, 9, 2], [7] * 11)):
        js, jrow = jeng.prefill(js, slot, prompt)
        ts, trow = teng.prefill(ts, slot, prompt)
        np.testing.assert_allclose(trow, jrow, atol=1e-4, rtol=1e-4)
    tokens = np.asarray([3, 4], np.int32)
    for active in ([True, True], [True, False], [True, True]):
        js, jl = jeng.step(js, tokens, np.asarray(active))
        ts, tl = teng.step(ts, tokens, np.asarray(active))
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(ts.lengths.numpy(),
                                      np.asarray(js.lengths))
        tokens = np.argmax(tl, axis=-1).astype(np.int32)


# ---------------------------------------------------------------------
# decode loops
# ---------------------------------------------------------------------

def test_greedy_decode_matches_jax_and_oracles(models):
    """Cached greedy equals the JAX engine's and both no-cache oracles.
    The JAX oracle runs op by op and compiles every op at every new
    length (~3 s a token here), so it checks the first token only; the
    port's own oracle runs the full budget on two prompts."""
    jmodel, jparams, _, tmodel = models
    rng = np.random.RandomState(2)
    prompts = _prompts(rng, 2)
    want = jgen.greedy_decode(jmodel, jparams, prompts[0], 10)
    np.testing.assert_array_equal(
        tgen.greedy_decode(tmodel, prompts[0], 10, device=CPU), want)
    np.testing.assert_array_equal(
        jgen.generate_reference(jmodel, jparams, prompts[0], 1), want[:1])
    for prompt in prompts:
        np.testing.assert_array_equal(
            tgen.generate_reference(tmodel, prompt, 10, device=CPU),
            tgen.greedy_decode(tmodel, prompt, 10, device=CPU))


def test_sample_decode_matches_jax_per_seed(models):
    jmodel, jparams, _, tmodel = models
    want = jgen.sample_decode(jmodel, jparams, [4, 8, 15], 8,
                              temperature=0.8, seed=5)
    got = tgen.sample_decode(tmodel, [4, 8, 15], 8, temperature=0.8,
                             seed=5, device=CPU)
    np.testing.assert_array_equal(got, want)


def test_greedy_decode_stop_token_and_logits_hook(models):
    _, _, _, tmodel = models
    rows = []
    ref = tgen.greedy_decode(tmodel, [3, 4], 12, device=CPU,
                             on_logits=rows.append)
    assert len(rows) == len(ref)
    assert [int(np.argmax(r)) for r in rows] == ref.tolist()
    stop = int(ref[2])
    first = ref.tolist().index(stop)
    got = tgen.greedy_decode(tmodel, [3, 4], 12, stop_token=stop,
                             device=CPU)
    assert got.tolist() == ref.tolist()[:first + 1]


# ---------------------------------------------------------------------
# paged engine
# ---------------------------------------------------------------------

def _paged_greedy(eng, prompts, budget, spec_refs=None, k=0):
    """Admit every prompt, then decode `budget` tokens per slot, plain
    (spec_refs None) or through verify with a scripted draft that
    proposes a cycling mix of true and junk tokens."""
    state = eng.init_state()
    out, last, infos = [], np.zeros(eng.batch_size, np.int64), []
    for i, p in enumerate(prompts):
        state, row, info = eng.admit(state, i, p, total_len=p.size + budget)
        infos.append(info)
        out.append([tgen.select_token(row)])
        last[i] = out[i][0]
    tick = 0
    while min(len(o) for o in out) < budget:
        if spec_refs is None:
            state, logits = eng.step(state, last,
                                     np.ones(eng.batch_size, bool))
            for i in range(eng.batch_size):
                out[i].append(tgen.select_token(logits[i]))
                last[i] = out[i][-1]
            continue
        toks = np.zeros((eng.batch_size, k + 1), np.int32)
        counts = np.zeros(eng.batch_size, np.int32)
        props = []
        for i in range(eng.batch_size):
            ki = max(min(k, budget - len(out[i]) - 1), 0)
            good = (tick + i) % (ki + 1) if ki else 0
            drafts = list(spec_refs[i][len(out[i]):len(out[i]) + good])
            while len(drafts) < ki:
                drafts.append((int(last[i]) + 13) % CFG["vocab_size"])
            props.append(drafts)
            toks[i, 0] = last[i]
            toks[i, 1:1 + ki] = drafts
            counts[i] = 1 + ki
        state, logits = eng.verify(state, toks, counts)
        for i in range(eng.batch_size):
            em, _ = tgen.greedy_verify(props[i], logits[i])
            em = em[:budget - len(out[i])]
            eng.advance(i, len(em))
            out[i].extend(em)
            last[i] = out[i][-1]
        tick += 1
    for i in range(eng.batch_size):
        eng.free_slot(i)
    return out, infos


def test_paged_prefix_reuse_and_spec_verify_match_plain(models):
    _, _, _, tmodel = models
    rng = np.random.RandomState(4)
    shared = rng.randint(1, 64, size=17).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, 64, size=n)]).astype(
        np.int32) for n in (3, 6)]
    budget = 12
    refs = [tgen.greedy_decode(tmodel, p, budget, device=CPU).tolist()
            for p in prompts]
    eng = tgen.PagedDecodeEngine(tmodel, batch_size=2, max_len=64,
                                 block_size=8, spec_k=3, device=CPU)
    got, infos = _paged_greedy(eng, prompts, budget)
    assert got == refs
    # the second admission shares the two full blocks of the prefix
    assert [i["shared_blocks"] for i in infos] == [0, 2]
    got, _ = _paged_greedy(eng, prompts, budget, spec_refs=refs, k=3)
    assert got == refs
    assert eng.pool.live_count() == 0


def test_paged_serves_int8_kv_on_the_cpu(models):
    """An int8 pool serves through the server (K7's plain version on the
    CPU): quantized payloads and their scales are written, and greedy
    tokens equal the float32 pool's here."""
    from paddle_tpu_torch.serving.generation import GenerationServer
    _, _, _, tmodel = models
    prompt = [5, 9, 2, 7, 7, 1, 3, 3, 8, 2]
    want = tgen.greedy_decode(tmodel, prompt, 6, device=CPU).tolist()
    eng = tgen.PagedDecodeEngine(tmodel, batch_size=2, max_len=64,
                                 kv_dtype="int8", device=CPU)
    assert eng.kv_dtype == "int8"
    with GenerationServer(eng, idle_wait_s=0.001) as srv:
        got = srv.generate(prompt, 6, timeout=60)["tokens"]
        stats = srv.stats()
    assert got == want
    assert stats["kv_dtype"] == "int8"
    state = srv.batcher._state
    assert state.cache_k.dtype == torch.int8
    assert bool((state.scale_k > 0).any())


def test_engine_rejects_oversized_geometry(models):
    _, _, _, tmodel = models
    with pytest.raises(EnforceError):
        tgen.DecodeEngine(tmodel, batch_size=1, max_len=128, device=CPU)
    eng = tgen.DecodeEngine(tmodel, batch_size=1, max_len=16, device=CPU)
    assert eng.buckets == tgen.prompt_buckets(16) == [8, 16]
    with pytest.raises(ValueError):
        eng.bucket_for(17)


# ---------------------------------------------------------------------
# block pool (the JAX tests' expectations, tests/test_paged_generation.py)
# ---------------------------------------------------------------------

def _pool_zero_leak():
    pool = tgen.BlockPool(num_blocks=9, block_size=8)
    total = pool.num_blocks - 1

    def invariant():
        s = pool.stats()
        assert s["free"] + s["cached"] + s["live"] == total, s

    a = pool.alloc(4)
    b = pool.alloc(4)
    invariant()
    with pytest.raises(tgen.PoolExhausted):
        pool.alloc(1)
    invariant()
    pool.release(a)
    assert pool.free_count() == 4
    c = pool.alloc(3)
    pool.release(b)
    pool.release(c)
    invariant()
    assert pool.free_count() == total and pool.live_count() == 0


def _pool_publish_lookup_lifecycle():
    pool = tgen.BlockPool(num_blocks=9, block_size=4)
    hashes = tgen.prefix_block_hashes(np.arange(12, dtype=np.int32), 4)
    assert len(hashes) == 3
    ids = pool.alloc(3)
    pool.publish(ids, hashes)
    assert pool.lookup(hashes) == ids
    pool.release(ids)
    assert pool.live_count() == 0 and pool.cached_count() == 3
    assert pool.lookup(hashes) == ids
    pool.ref(ids)
    assert pool.live_count() == 3 and pool.cached_count() == 0
    pool.ref(ids)
    pool.release(ids)
    assert pool.live_count() == 3
    pool.release(ids)
    assert pool.cached_count() == 3


def _pool_lookup_stops_at_first_miss():
    pool = tgen.BlockPool(num_blocks=9, block_size=4)
    h = tgen.prefix_block_hashes(np.arange(12, dtype=np.int32), 4)
    ids = pool.alloc(3)
    pool.publish([ids[0], ids[2]], [h[0], h[2]])
    assert pool.lookup(h) == [ids[0]]


def _pool_lru_eviction_order():
    pool = tgen.BlockPool(num_blocks=4, block_size=4)
    h = tgen.prefix_block_hashes(np.arange(12, dtype=np.int32), 4)
    ids = pool.alloc(3)
    pool.publish(ids, h)
    pool.release([ids[1]])
    pool.release([ids[0]])
    pool.release([ids[2]])
    assert pool.alloc(1) == [ids[1]]
    assert pool.evictions == 1
    assert pool.lookup(h) == [ids[0]]


def _pool_acquire_pins_shared():
    pool = tgen.BlockPool(num_blocks=4, block_size=4)
    h = tgen.prefix_block_hashes(np.arange(12, dtype=np.int32), 4)
    ids = pool.alloc(3)
    pool.publish(ids, h)
    pool.release(ids)
    shared = pool.lookup(h[:2])
    assert shared == ids[:2]
    own = pool.acquire(shared, 1)
    assert own == [ids[2]] and set(own).isdisjoint(shared)
    assert pool.evictions == 1
    pool.release(shared + own)


def _pool_acquire_exhaustion_rolls_back():
    pool = tgen.BlockPool(num_blocks=4, block_size=4)
    h = tgen.prefix_block_hashes(np.arange(12, dtype=np.int32), 4)
    ids = pool.alloc(3)
    pool.publish(ids, h)
    pool.release(ids)
    shared = pool.lookup(h[:2])
    hits = pool.prefix_hits
    with pytest.raises(tgen.PoolExhausted):
        pool.acquire(shared, 2)
    s = pool.stats()
    assert s["live"] == 0 and s["cached"] == 3
    assert pool.prefix_hits == hits and pool.lookup(h) == ids


def _chain_hashes_match_jax():
    rng = np.random.RandomState(8)
    toks = rng.randint(0, 1000, size=37).astype(np.int32)
    assert (tgen.prefix_block_hashes(toks, 8)
            == jgen.prefix_block_hashes(toks, 8))
    b = toks.copy()
    b[20] += 1
    ha, hb = (tgen.prefix_block_hashes(toks, 8),
              tgen.prefix_block_hashes(b, 8))
    assert ha[:2] == hb[:2] and ha[2] != hb[2]


@pytest.mark.parametrize("case", [
    _pool_zero_leak, _pool_publish_lookup_lifecycle,
    _pool_lookup_stops_at_first_miss, _pool_lru_eviction_order,
    _pool_acquire_pins_shared, _pool_acquire_exhaustion_rolls_back,
    _chain_hashes_match_jax], ids=lambda f: f.__name__.lstrip("_"))
def test_block_pool(case):
    case()


def test_draft_and_acceptance_rules_match_jax():
    rng = np.random.RandomState(6)
    seq = rng.randint(0, 8, size=60).tolist()
    jd, td = jgen.NgramDraft(8), tgen.NgramDraft(8)
    jd.observe(seq)
    td.observe(seq)
    for i in range(10, 60, 7):
        assert td.propose(seq[:i], 4) == jd.propose(seq[:i], 4)
    rows = rng.randn(5, 8)
    for props in ([], [int(np.argmax(rows[0]))], [1, 2, 3, 4]):
        assert (tgen.greedy_verify(props, rows)
                == jgen.greedy_verify(props, rows))
    sampled = td.propose_sampled(seq[:20], 3, np.random.RandomState(1))
    assert (tgen.rejection_verify(sampled, rows, 0.7,
                                  np.random.RandomState(2))
            == jgen.rejection_verify(sampled, rows, 0.7,
                                     np.random.RandomState(2)))
