"""The port's engines and TrainStep in the CompileLedger against the JAX
package's, at a tiny width on the CPU.

The same weights and requests go through the JAX DecodeEngine /
PagedDecodeEngine and the port's (contiguous; paged with float32 and
int8 pools; paged with spec_k > 0 and a draft). Both ledgers must hold
the same keys, with the same argument signatures once the JAX
package's `params` leaves are left out (the port's rungs close over the
model's weights), the same `compile_count()` after `warmup()` and after
the traffic, and the same `stats()["compiled_signatures"]`; `warmup()`
returns the JAX package's keys, `warm_start` among them. TrainStep
records one entry per input signature, under the JAX package's key and
signature. Each JAX side runs once per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.observability import profile as jprof
from paddle_tpu.ops import generation as jgen
from paddle_tpu.serving import generation as jserve
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.observability import profile as tprof
from paddle_tpu_torch.ops import generation as tgen
from paddle_tpu_torch.serving import generation as tserve
from paddle_tpu_torch.weights import params_from_jax

CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
           max_len=32)
CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    jmodel = jgen.TinyDecoderLM(jgen.LMConfig(**CFG))
    jparams = jmodel.init_params(5)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = tgen.TinyDecoderLM(tgen.LMConfig(**CFG), device=CPU)
    tmodel.load_state_dict(params_from_jax(tree))
    return jmodel, jparams, tmodel


def _requests():
    rng = np.random.RandomState(11)
    shared = rng.randint(1, 64, size=9)
    out = []
    for i in range(5):
        tail = rng.randint(1, 64, size=rng.randint(2, 7))
        prompt = np.concatenate([shared, tail]) if i % 2 else tail
        out.append((prompt.astype(np.int32), int(rng.randint(3, 8))))
    return out


def _serve(batcher, greq):
    reqs = [batcher.submit(greq(p, n, enqueued_at=0.0))
            for p, n in _requests()]
    steps = 0
    while not batcher.idle():
        batcher.step(now=float(steps))
        steps += 1
        assert steps < 500
    return [list(r.tokens) for r in reqs], batcher.stats()


def _ledger(prof, scope):
    """{key: signature without the params leaves} of one engine."""
    out = {}
    for r in prof.compile_ledger().entries(scope=scope):
        assert r.key not in out, r.key
        out[r.key] = tuple(s for s in r.signature
                           if not s[0].startswith("params"))
    return out


ENGINES = {
    "contiguous": dict(paged=False),
    "paged f32": dict(paged=True, spec_k=0),
    "paged int8": dict(paged=True, spec_k=0, kv_dtype="int8"),
    "paged int8 spec_k=2": dict(paged=True, spec_k=2, kv_dtype="int8"),
}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_ledger_is_the_references(models, kind):
    jmodel, jparams, tmodel = models
    opts = dict(ENGINES[kind])
    paged = opts.pop("paged")
    if paged:
        jeng = jgen.PagedDecodeEngine(jmodel, jparams, batch_size=3,
                                      max_len=CFG["max_len"], block_size=8,
                                      **opts)
        teng = tgen.PagedDecodeEngine(tmodel, batch_size=3,
                                      max_len=CFG["max_len"], block_size=8,
                                      device=CPU, **opts)
    else:
        jeng = jgen.DecodeEngine(jmodel, jparams, batch_size=3,
                                 max_len=CFG["max_len"])
        teng = tgen.DecodeEngine(tmodel, batch_size=3,
                                 max_len=CFG["max_len"], device=CPU)
    jrep, trep = jeng.warmup(), teng.warmup()
    assert set(trep) == set(jrep)
    assert trep["warm_start"] is None and jrep["warm_start"] is None
    assert trep["prefill_buckets"] == jrep["prefill_buckets"]
    jled, tled = _ledger(jprof, jeng.ledger_scope), _ledger(
        tprof, teng.ledger_scope)
    assert tled == jled
    assert teng.compile_count() == jeng.compile_count() == len(jled)

    def batcher(pkg, eng):
        if not paged:
            return pkg.ContinuousBatcher(eng)
        draft = (None if not opts.get("spec_k")
                 else (jgen if pkg is jserve else tgen).NgramDraft(64))
        return pkg.PagedBatcher(eng, draft=draft)

    jtoks, jstats = _serve(batcher(jserve, jeng), jserve.GenerationRequest)
    ttoks, tstats = _serve(batcher(tserve, teng), tserve.GenerationRequest)
    assert ttoks == jtoks
    assert teng.compile_count() == jeng.compile_count() == len(jled)
    assert (tstats["compiled_signatures"] == jstats["compiled_signatures"]
            == len(jled))
    assert _ledger(tprof, teng.ledger_scope) == _ledger(
        jprof, jeng.ledger_scope)
    if opts.get("spec_k"):
        assert tstats["speculative"]["verify_ticks"] >= 1


def test_train_step_records_one_entry_per_signature():
    jnet = jnn.Linear(4, 3)
    tnet = tnn.Linear(4, 3, device=CPU)
    with torch.no_grad():
        for k, v in jnet.trainable_dict().items():
            tnet.trainable_dict()[k].copy_(torch.from_numpy(np.array(v)))

    def jloss(m, x, y):
        return jnp.mean((m(x) - y) ** 2)

    def tloss(m, x, y):
        return ((m(x) - y) ** 2).mean()

    jstep = jnn.TrainStep(jnet, jloss, learning_rate=0.1, momentum=0.9)
    tstep = tnn.TrainStep(tnet, tloss, learning_rate=0.1, momentum=0.9)
    rng = np.random.RandomState(3)
    jprof.reset_profile()
    tprof.reset_profile()
    losses = []
    for b in (2, 5, 2, 5, 2):
        x = rng.randn(b, 4).astype(np.float32)
        y = rng.randn(b, 3).astype(np.float32)
        jl = float(jstep(jnp.asarray(x), jnp.asarray(y)))
        tl = tstep(torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(tl))
        np.testing.assert_allclose(float(tl), jl, rtol=1e-5, atol=1e-6)
    jrecs = jprof.compile_ledger().entries(component="train")
    trecs = tprof.compile_ledger().entries(component="train")
    assert len(trecs) == len(jrecs) == 2
    assert [r.key for r in trecs] == [r.key for r in jrecs] == [
        "train_step/Linear"] * 2
    assert [r.signature for r in trecs] == [r.signature for r in jrecs]
    assert all(r.kind == "eager" for r in trecs)
    assert trecs[1].forensics["changed"][0]["arg"] == "[2]"
    stats = tprof.executable_stats()["train/train_step/Linear"]
    assert stats["calls"] == 5 and stats["flops"] > 0
