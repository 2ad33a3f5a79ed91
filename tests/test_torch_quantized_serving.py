"""Quantized paged-KV serving in the port against the JAX package (CPU).

The same numpy-seeded weights, prompts and pools go through
`paddle_tpu.ops.generation` / `paddle_tpu.serving.generation` and their
counterparts in `paddle_tpu_torch`, at the JAX tests' tiny size
(tests/test_quantized_serving.py: vocab 48, d_model 32, 4 heads, 2
layers, max_len 64):

* `_kv_quantize_rows` gives the JAX payloads and scales bit for bit
  (int8, fp8 e4m3, an all-zero row);
* K7's plain version equals the JAX reference and the Pallas kernel run
  under the interpreter (C <= 8) at atol/rtol 1e-5 (float32; the two sum
  in another order);
* the int8 and fp8 engines' logits agree with the JAX engines' within
  1e-4 of their max, greedy tokens are equal, and the scales land in the
  same pool rows;
* greedy streams are bit-stable across spill demote and promote;
* v2 state documents: the CRC equals the JAX CRC, documents cross
  between the packages in both directions (int8 and fp8) and resume the
  uninterrupted stream; v1, cross-dtype and tampered documents are
  refused;
* the degradation ladder walks the JAX batcher's rungs tick for tick and
  recovers, and `submit_resumed` gives the uninterrupted stream.

On the CPU the K7 wrapper runs its plain version; the CUDA kernel's own
tests are in tests/test_torch_kernels_cuda.py.
"""
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops import generation as jgen
from paddle_tpu.serving import generation as jserve
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import generation as tgen
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.reliability.faults import fault_plan
from paddle_tpu_torch.serving import generation as tserve
from paddle_tpu_torch.weights import (
    kv_from_numpy, kv_to_numpy, params_from_jax, state_doc_to_jax,
)

# the package re-exports a function of the module's name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

CFG = dict(vocab_size=48, d_model=32, num_heads=4, num_layers=2,
           max_len=64)
CPU = "cpu"
TOL = dict(atol=1e-5, rtol=1e-5)
#: engine logits: max |port - JAX| over max |JAX| per row (float32 with
#: the same quantized payloads; matmuls sum in another order)
LOGIT_TOL = 1e-4
QUANT = ("int8", "fp8_e4m3")
FP8 = ml_dtypes.float8_e4m3fn


@pytest.fixture(scope="module")
def lm():
    jmodel = jgen.TinyDecoderLM(jgen.LMConfig(**CFG))
    jparams = jmodel.init_params(0)
    tmodel = tgen.TinyDecoderLM(tgen.LMConfig(**CFG), device=CPU)
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _jax_engine(lm, kv_dtype, batch_size=2, spill_blocks=16, **kw):
    jmodel, jparams, _ = lm
    return jgen.PagedDecodeEngine(
        jmodel, jparams, batch_size=batch_size, max_len=64, block_size=8,
        spec_k=2, spill_blocks=spill_blocks, kv_dtype=kv_dtype,
        buckets=[8, 16], **kw)


def _engine(lm, kv_dtype, batch_size=2, spill_blocks=16, **kw):
    return tgen.PagedDecodeEngine(
        lm[2], batch_size=batch_size, max_len=64, block_size=8, spec_k=2,
        spill_blocks=spill_blocks, kv_dtype=kv_dtype, device=CPU, **kw)


def _greedy(eng, state, row, slot, n):
    """Greedy-decode `slot` alone from its admission row: (state, tokens,
    logits rows of the steps)."""
    out = [tgen.select_token(row)]
    last = np.zeros(eng.batch_size, np.int64)
    last[slot] = out[0]
    active = np.asarray([i == slot for i in range(eng.batch_size)])
    rows = []
    while len(out) < n:
        state, logits = eng.step(state, last, active)
        rows.append(np.array(logits[slot]))
        out.append(tgen.select_token(logits[slot]))
        last[slot] = out[-1]
    return state, out, rows


def _bytes_of(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# ---------------------------------------------------------------------
# row quantization and K7's plain version
# ---------------------------------------------------------------------

def _rows(case):
    rng = np.random.RandomState(3)
    if case == "zero":
        x = np.zeros((2, 3, 4, 8), np.float32)
        x[1, 2] = rng.randn(4, 8)
        return x
    scale = {"unit": 1.0, "wide": 300.0, "tiny": 1e-4}[case]
    return (rng.randn(6, 5, 4, 8) * scale).astype(np.float32)


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("case", ["unit", "wide", "tiny", "zero"])
def test_quantize_rows_bit_exact_against_jax(kv_dtype, case):
    x = _rows(case)
    jq, js = jgen._kv_quantize_rows(jnp.asarray(x), kv_dtype)
    tq, ts = tgen._kv_quantize_rows(torch.from_numpy(x), kv_dtype)
    assert tq.dtype == tgen.kv_torch_dtype(kv_dtype)
    np.testing.assert_array_equal(kv_to_numpy(tq), _bytes_of(jq)
                                  if kv_dtype == "fp8_e4m3" else jq)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "zero":
        assert not ts[0].any() and not kv_to_numpy(tq)[0].any()


def _k7_inputs(kv_dtype, c, seed=5, b=3, n=2, d=16, bs=4, m=6, nb=10):
    """q, quantized pools with scales (the JAX quantizer's), tables with
    repeated and out-of-order blocks, lengths — as numpy."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, c, n, d).astype(np.float32)
    kq, ks = jgen._kv_quantize_rows(
        jnp.asarray(3.0 * rng.randn(nb, bs, n, d).astype(np.float32)),
        kv_dtype)
    vq, vs = jgen._kv_quantize_rows(
        jnp.asarray(rng.randn(nb, bs, n, d).astype(np.float32)), kv_dtype)
    tables = rng.randint(0, nb, size=(b, m)).astype(np.int32)
    lengths = np.asarray([0, 7, m * bs - c], np.int32)
    return [q, np.array(kq), np.array(vq), np.array(ks), np.array(vs),
            tables, lengths]


def _port_k7(arrays, kv_dtype):
    q, kq, vq, ks, vs, tables, lengths = arrays
    return tda.quantized_paged_decode_attention(
        torch.from_numpy(q), kv_from_numpy(kq), kv_from_numpy(vq),
        torch.from_numpy(ks), torch.from_numpy(vs),
        torch.from_numpy(tables), torch.from_numpy(lengths)).numpy()


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("c", [1, 5, 8])
def test_k7_plain_matches_interpreted_pallas_kernel(kv_dtype, c):
    arrays = _k7_inputs(kv_dtype, c)
    want = jfa.flash_quantized_paged_decode_attention(
        *(jnp.asarray(a) for a in arrays), use_kernel=True, interpret=True)
    np.testing.assert_allclose(_port_k7(arrays, kv_dtype), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("c", [1, 16])
def test_k7_plain_matches_jax_reference(kv_dtype, c):
    """C=16 is beyond the TPU kernel's 8 rows: the prefill buckets."""
    arrays = _k7_inputs(kv_dtype, c, seed=9, nb=14, m=8)
    want = jfa.quantized_paged_decode_attention_reference(
        *(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_port_k7(arrays, kv_dtype), np.asarray(want),
                               **TOL)


def test_k7_plain_folds_scales_like_a_dequantized_k6():
    """The folded scales equal K6 over the dequantized pools."""
    q, kq, vq, ks, vs, tables, lengths = (
        torch.from_numpy(a) for a in _k7_inputs("int8", 3, seed=2))
    got = tda.quantized_paged_decode_attention(q, kq, vq, ks, vs, tables,
                                               lengths)
    want = tda.paged_decode_attention(
        q, kq.float() * ks[..., None, None], vq.float() * vs[..., None, None],
        tables, lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------
# engines against the JAX engines
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", QUANT)
def test_engine_matches_jax_engine(lm, kv_dtype):
    """Prefill, decode with a second slot arriving mid-flight, and one
    verify chunk: logits agree within LOGIT_TOL of their max, greedy
    tokens are equal, and the scales sit in the same rows. (The payload
    bytes may differ where the two packages' K/V projections round a row
    differently in the last bit; the quantizer itself is bit-exact.)"""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 48, size=n).astype(np.int32) for n in (12, 5)]
    je, te = _jax_engine(lm, kv_dtype), _engine(lm, kv_dtype)
    js, ts = je.init_state(), te.init_state()

    def close(t, j):
        j = np.asarray(j)
        assert np.abs(np.asarray(t) - j).max() <= LOGIT_TOL * np.abs(j).max()

    last = np.zeros(2, np.int64)
    js, jrow, _ = je.admit(js, 0, prompts[0], total_len=40)
    ts, trow, _ = te.admit(ts, 0, prompts[0], total_len=40)
    close(trow, jrow)
    last[0] = tgen.select_token(jrow)
    for tick in range(8):
        active = np.asarray([True, tick >= 3])
        if tick == 3:
            js, jrow, _ = je.admit(js, 1, prompts[1], total_len=30)
            ts, trow, _ = te.admit(ts, 1, prompts[1], total_len=30)
            close(trow, jrow)
            last[1] = tgen.select_token(jrow)
        js, jl = je.step(js, last, active)
        ts, tl = te.step(ts, last, active)
        close(tl, jl)
        for i in np.flatnonzero(active):
            assert tgen.select_token(tl[i]) == tgen.select_token(jl[i])
            last[i] = tgen.select_token(jl[i])
    toks = np.stack([last, (last + 3) % 48, (last + 7) % 48], axis=1)
    js, jl = je.verify(js, toks, [3, 2])
    ts, tl = te.verify(ts, toks, [3, 2])
    close(tl, jl)
    # every block but garbage block 0, where masked rows collide in an
    # unspecified order
    for got, want in ((ts.scale_k, js.scale_k), (ts.scale_v, js.scale_v)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=1e-5)
    assert te.kv_pool_bytes() == je.kv_pool_bytes()


def test_engine_config_and_pool_bytes(lm):
    with pytest.raises(EnforceError):
        _engine(lm, "int4")
    assert tgen.KV_DTYPES == jgen.KV_DTYPES
    e32, e8 = _engine(lm, "f32"), _engine(lm, "int8")
    rows = CFG["num_layers"] * e32.num_blocks * e32.block_size
    assert e32.kv_pool_bytes() == 2 * rows * CFG["d_model"] * 4
    assert e8.kv_pool_bytes() == 2 * rows * (CFG["d_model"] + 4)
    state = e8.init_state()
    assert state.cache_k.dtype == torch.int8
    assert tuple(state.scale_k.shape) == (2, e8.num_blocks, 8)
    assert tgen.fp8_kv_supported()
    assert _engine(lm, "fp8_e4m3").kv_dtype == "fp8_e4m3"


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_stream_bit_stable_across_spill_demote_and_promote(lm, kv_dtype):
    eng = _engine(lm, kv_dtype, num_blocks=9)
    prompt = np.arange(1, 18).astype(np.int32)
    st = eng.init_state()
    st, row_a, _ = eng.admit(st, 0, prompt, total_len=28)
    st, out_a, rows_a = _greedy(eng, st, row_a, 0, 6)
    eng.free_slot(0)
    assert eng.spill_cached(st) == 2
    assert eng.pool.cached_count() == 0 and len(eng.spill) == 2
    # a filler takes every free block, so the demoted blocks' device
    # copies are overwritten before the promotion
    filler = np.full(8, 5, np.int32)
    st, _, _ = eng.admit(st, 1, filler, total_len=64)
    eng.free_slot(1)
    st, row_b, info = eng.admit(st, 0, prompt, total_len=28)
    assert info["spill_blocks"] == 2 and info["shared_blocks"] == 0
    np.testing.assert_array_equal(row_a, row_b)
    st, out_b, rows_b = _greedy(eng, st, row_b, 0, 6)
    assert out_a == out_b
    np.testing.assert_array_equal(np.stack(rows_a), np.stack(rows_b))
    assert eng.spill.stats()["promoted"] == 2


def test_spill_store_fifo_and_spill_faults(lm):
    """The JAX SpillStore golden, then the two spill sites (hits count
    per site and tag, i.e. per chain hash): faulted writes drop the
    payloads and a faulted read falls back to prefill — the same logits
    either way."""
    s = tgen.SpillStore(3)
    for tag, h in enumerate((b"a", b"b", b"c")):
        s.put(h, np.full((2, 4), tag, np.float32), None)
    s.put(b"a", np.full((2, 4), 9.0, np.float32), None)
    assert s.demoted == 3
    s.put(b"d", None, None)
    s.put(b"e", None, None)
    assert b"b" not in s and b"c" not in s and b"a" in s
    assert s.dropped == 2 and s.demoted == 5
    assert s.get(b"a")[0][0, 0] == 9.0 and b"a" not in s
    assert s.get(b"zz") is None
    eng = _engine(lm, "int8")
    prompt = np.arange(1, 18).astype(np.int32)
    st = eng.init_state()
    st, ref_row, _ = eng.admit(st, 0, prompt, total_len=20)
    eng.free_slot(0)
    with fault_plan("generation.spill_write@1:raise"):
        assert eng.spill_cached(st) == 2   # the blocks are freed anyway
    assert len(eng.spill) == 0 and eng.pool.cached_count() == 0
    st, row, info = eng.admit(st, 0, prompt, total_len=20)
    assert info["spill_blocks"] == 0       # re-prefilled
    np.testing.assert_array_equal(row, ref_row)
    eng.free_slot(0)
    assert eng.spill_cached(st) == 2 and len(eng.spill) == 2
    with fault_plan("generation.spill_read@1:raise"):
        st, row, info = eng.admit(st, 0, prompt, total_len=20)
    assert info["spill_blocks"] == 0       # the chain stops at the fault
    np.testing.assert_array_equal(row, ref_row)
    assert eng.pool.live_count() == 3


# ---------------------------------------------------------------------
# v2 state documents, across the two packages
# ---------------------------------------------------------------------

def _export(eng, lm_prompt, budget, cut):
    st = eng.init_state()
    st, row, _ = eng.admit(st, 0, lm_prompt, total_len=lm_prompt.size
                           + budget)
    st, committed, _ = _greedy(eng, st, row, 0, cut)
    full = np.concatenate([lm_prompt, np.asarray(committed, np.int32)])
    return eng.export_state(st, 0, full), committed


def _resume(eng, doc, total, n):
    res = eng.import_state(doc)
    st = eng.init_state()
    st, row, info = eng.admit(st, 0, res["tokens"], total_len=total)
    _, rest, _ = _greedy(eng, st, row, 0, n)
    return res, info, rest


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_state_documents_cross_between_packages(lm, kv_dtype):
    budget, cut = 10, 5
    prompt = np.random.RandomState(13).randint(1, 48, size=10).astype(
        np.int32)
    total = prompt.size + budget
    ref = tgen.greedy_decode(lm[2], prompt, budget, device=CPU).tolist()
    jdoc, jcommitted = _export(_jax_engine(lm, kv_dtype, batch_size=1,
                                           spill_blocks=8),
                               prompt, budget, cut)
    tdoc, tcommitted = _export(_engine(lm, kv_dtype, batch_size=1,
                                       spill_blocks=8),
                               prompt, budget, cut)
    assert tcommitted == jcommitted == ref[:cut]
    assert tdoc["version"] == jdoc["version"] == tgen.STATE_DOC_VERSION
    assert tdoc["kv_dtype"] == kv_dtype and len(tdoc["kv"]) == 1
    assert tdoc["block_hashes"] == jdoc["block_hashes"]
    for tent, jent in zip(tdoc["kv"], jdoc["kv"]):
        assert tent["hash"] == jent["hash"]
        for key in ("k", "v", "k_scale", "v_scale"):
            assert tent[key].shape == jent[key].shape
            assert tent[key].dtype.itemsize == jent[key].dtype.itemsize
        np.testing.assert_allclose(tent["k_scale"], jent["k_scale"],
                                   rtol=1e-5)
    # a document has the same CRC in both packages
    assert tgen._state_doc_crc(jdoc) == jdoc["crc32"]
    to_jax = state_doc_to_jax(tdoc, FP8)
    assert jgen._state_doc_crc(to_jax) == tdoc["crc32"]
    # a JAX document resumes in the port, a port document in JAX
    res, info, rest = _resume(_engine(lm, kv_dtype, batch_size=1,
                                      spill_blocks=8), jdoc, total,
                              budget - cut)
    assert res["spilled_blocks"] == info["spill_blocks"] == 1
    assert jcommitted + rest == ref
    res, info, rest = _resume(_jax_engine(lm, kv_dtype, batch_size=1,
                                          spill_blocks=8), to_jax, total,
                              budget - cut)
    assert res["spilled_blocks"] == info["spill_blocks"] == 1
    assert tcommitted + rest == ref


def test_state_documents_refused(lm):
    e32, e8 = _engine(lm, "f32"), _engine(lm, "int8", batch_size=1)
    with pytest.raises(tgen.StateDocError, match="version"):
        e32.import_state({"version": 1})
    doc = {"version": 2, "block_size": 8, "kv_dtype": "int8",
           "tokens": [1], "length": 0, "block_hashes": [], "kv": []}
    doc["crc32"] = tgen._state_doc_crc(doc)
    assert doc["crc32"] == jgen._state_doc_crc(doc)
    with pytest.raises(tgen.KVDtypeMismatch, match="kv_dtype"):
        e32.import_state(doc)
    tdoc, _ = _export(e8, np.arange(1, 17).astype(np.int32), 6, 3)
    flipped = dict(tdoc, kv=[dict(e) for e in tdoc["kv"]])
    scale = flipped["kv"][0]["k_scale"].copy()
    scale.view(np.uint8)[0, 0] ^= 1                # one flipped scale bit
    flipped["kv"][0]["k_scale"] = scale
    eng = _engine(lm, "int8", batch_size=1)
    with pytest.raises(tgen.StateDocError, match="CRC mismatch"):
        eng.import_state(flipped)
    with pytest.raises(tgen.StateDocError):
        eng.import_state(dict(tdoc, kv_dtype="fp8_e4m3"))
    assert len(eng.spill) == 0                     # all-or-nothing
    with pytest.raises(tgen.KVDtypeMismatch):
        _engine(lm, "fp8_e4m3").import_state(tdoc)
    assert eng.import_state(tdoc)["spilled_blocks"] == 2


# ---------------------------------------------------------------------
# serving: the degradation ladder and resume
# ---------------------------------------------------------------------

def _ladder_run(serve_mod, batcher, prompts, budget):
    reqs = [batcher.submit(serve_mod.GenerationRequest(p, budget,
                                                       enqueued_at=0.0))
            for p in prompts]
    rungs = []
    while not batcher.idle():
        batcher.step(now=float(len(rungs)))
        rungs.append(batcher.ladder_rung)
        assert len(rungs) < 2000, "ladder batcher failed to drain"
    batcher.step(now=float(len(rungs)))      # one clean idle tick
    rungs.append(batcher.ladder_rung)
    return [r.tokens for r in reqs], rungs


@pytest.mark.parametrize("min_budget", [None, 4], ids=["no-shrink", "shrink"])
def test_ladder_walks_the_jax_rungs_and_recovers(lm, min_budget):
    """A 9-block pool (one full slot) under 6 requests that share a
    2-block prefix (the JAX oracle, tests/test_paged_generation.py,
    under more pressure): the port walks the JAX batcher's rungs tick
    for tick — shed_spec, shrink_budget when min_degraded_budget is set,
    evict_spill, park — recovers to normal, and emits the same
    tokens."""
    jmodel, jparams, tmodel = lm
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 48, size=16)
    prompts = [np.concatenate([shared, rng.randint(1, 48, size=rng.randint(
        9, 25))]).astype(np.int32) for _ in range(6)]
    kw = dict(batch_size=2, max_len=64, block_size=8, num_blocks=9,
              spec_k=2, kv_dtype="int8", spill_blocks=8)
    draft = jgen.NgramDraft(48), tgen.NgramDraft(48)
    jb = jserve.PagedBatcher(
        jgen.PagedDecodeEngine(jmodel, jparams, buckets=[16, 64], **kw),
        draft=draft[0], clock=lambda: 0.0, min_degraded_budget=min_budget)
    tb = tserve.PagedBatcher(
        tgen.PagedDecodeEngine(tmodel, device=CPU, **kw), draft=draft[1],
        clock=lambda: 0.0, min_degraded_budget=min_budget)
    jtoks, jrungs = _ladder_run(jserve, jb, prompts, 12)
    ttoks, trungs = _ladder_run(tserve, tb, prompts, 12)
    assert trungs == jrungs and ttoks == jtoks
    lad = tb.stats()["ladder"]
    assert lad["shed_spec"] > 0 and lad["evict_spill"] > 0
    assert lad["park"] > 0 and lad["recovered"] > 0 and tb.ladder_rung == 0
    assert (lad["shrink_budget"] > 0) == (min_budget is not None)
    assert lad["spill_evicted_blocks"] > 0
    assert tb.stats()["spill"]["demoted"] > 0
    pool = tb.stats()["pool"]
    assert pool["live"] == 0
    assert pool["free"] + pool["cached"] == tb.engine.num_blocks - 1
    assert tb.engine.pool.drop_cached() == pool["cached"]
    assert tb.engine.pool.free_count() == tb.engine.num_blocks - 1
    assert jb.stats()["ladder"]["spill_evicted_blocks"] == \
        lad["spill_evicted_blocks"]


def test_submit_resumed_gives_the_uninterrupted_stream(lm):
    """A stream cut halfway on one server resumes on another engine from
    its exported document: a spill hit at admission, the remaining
    tokens equal the uninterrupted stream's."""
    tmodel = lm[2]
    prompt = np.random.RandomState(21).randint(1, 48, size=19).astype(
        np.int32)
    budget, cut = 14, 7
    ref = tgen.greedy_decode(tmodel, prompt, budget, device=CPU).tolist()
    donor = _engine(lm, "int8", batch_size=2, spill_blocks=8)
    b = tserve.PagedBatcher(donor)
    req = b.submit(tserve.GenerationRequest(prompt, budget,
                                            enqueued_at=0.0))
    while len(req.tokens) < cut:
        b.step()
    committed = list(req.tokens)
    snap = b.snapshot_requests()[req.request_id]
    assert snap["state"] == "live" and snap["committed"] == committed
    doc = donor.export_state(b._state, snap["slot"],
                             list(prompt) + committed)
    peer = _engine(lm, "int8", batch_size=2, spill_blocks=8)
    assert peer.import_state(doc)["spilled_blocks"] == len(doc["kv"]) >= 2
    with tserve.GenerationServer(peer, idle_wait_s=0.001) as srv:
        resumed = srv.submit_resumed(prompt, committed, budget)
        rest = resumed.result(timeout=60)["tokens"]
        stats = srv.stats()
    assert committed + rest == ref
    assert resumed.resume_offset == cut and resumed.spill_blocks >= 2
    assert stats["resume"]["resumed"] == 1
    assert stats["speculative"]["spill_hit_admissions"] == 1
