"""The planner's memory half, the lints and the quantization parity gate
of the port against the JAX package's (CPU).

* `estimate_peak_memory` gives the JAX package's bytes (params, feeds,
  fetches, intermediate peak, high-water op) on the same LeNet, tiny
  ResNet and tiny BERT programs built by each package's static API at
  several batch sizes, and `step_peak_bytes` agrees with the discount
  passed explicitly on both sides (the port's default discount is 1.0,
  the JAX package's 0.25: see analysis/planner.py).
* The fit gate refuses and accepts the same programs with the same
  diagnostic; the decode-rung geometry estimates equal the JAX ones on
  the same engine configuration; the cross-check's ok/fail/skip legs
  behave as the JAX package's; the sharding half plans meshes beyond
  one device (held against the JAX package in
  test_torch_planner_sharding.py).
* The lints (verifier excluded) give the JAX package's findings, code
  by code and place by place, on the three programs and on programs
  built to trip each lint; the one pinned divergence is
  `lint_host_sync_ops`, which in the port reads the host marks of the
  capture plan (a `while` is a host op, one WARNING) where the JAX
  package's AST checker finds nothing.
* `quant_parity_check` returns the JAX package's relative error and
  verdict.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.analysis import AnalysisManager as JManager
from paddle_tpu.analysis import LINT_PASSES as JLINTS
from paddle_tpu.analysis import numerics as jnumerics
from paddle_tpu.analysis import planner as jplanner
from paddle_tpu.core import ir as jir
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.analysis import AnalysisManager as TManager
from paddle_tpu_torch.analysis import LINT_PASSES as TLINTS
from paddle_tpu_torch.analysis import lint_graph
from paddle_tpu_torch.analysis import numerics as tnumerics
from paddle_tpu_torch.analysis import planner as tplanner
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet

SIDES = {"jax": (jir, pt.static, jlenet, jresnet, jplanner),
         "port": (tir, tstatic, tlenet, tresnet, tplanner)}


@pytest.fixture(autouse=True)
def _clean_estimates():
    tplanner.clear_static_estimates()
    yield
    tplanner.clear_static_estimates()


def _tiny_bert(S, seq=16, hidden=32, heads=4, layers=2, vocab=64):
    ids = S.data("ids", [seq], "int64")
    label = S.data("label", [1], "int64")
    h = S.embedding(ids, size=[vocab, hidden])
    pos = S.create_parameter([seq, hidden], "float32", name="pos_emb")
    h = S.layer_norm(S.elementwise_add(h, pos, axis=1), begin_norm_axis=2)
    dh = hidden // heads

    def split(x):
        return S.transpose(S.reshape(x, [-1, seq, heads, dh]), [0, 2, 1, 3])

    for _ in range(layers):
        q = split(S.fc(h, hidden, num_flatten_dims=2))
        k = split(S.fc(h, hidden, num_flatten_dims=2))
        v = split(S.fc(h, hidden, num_flatten_dims=2))
        att = S.softmax(S.matmul(q, k, transpose_y=True,
                                 alpha=dh ** -0.5))
        ctx = S.reshape(S.transpose(S.matmul(att, v), [0, 2, 1, 3]),
                        [-1, seq, hidden])
        h = S.layer_norm(S.elementwise_add(
            h, S.fc(ctx, hidden, num_flatten_dims=2)), begin_norm_axis=2)
        f = S.fc(S.fc(h, 4 * hidden, num_flatten_dims=2, act="gelu"),
                 hidden, num_flatten_dims=2)
        h = S.layer_norm(S.elementwise_add(h, f), begin_norm_axis=2)
    cls = S.slice(h, axes=[1], starts=[0], ends=[1])
    logits = S.fc(S.reshape(cls, [-1, hidden]), 2)
    S.mean(S.softmax_with_cross_entropy(logits, label))
    return ["ids", "label"], logits


def _lenet(S, lenet, resnet):
    img = S.data("img", [1, 28, 28], "float32")
    label = S.data("label", [1], "int64")
    return ["img", "label"], lenet.build_static(img, label)[0]


def _resnet(S, lenet, resnet):
    img = S.data("img", [3, 32, 32], "float32")
    label = S.data("label", [1], "int64")
    return ["img", "label"], resnet.build_static(
        img, label, blocks=(1, 1), width=8, num_classes=10)[0]


MODELS = {"lenet": _lenet, "resnet": _resnet,
          "bert": lambda S, lenet, resnet: _tiny_bert(S)}


def _build(side, model):
    ir, S, lenet, resnet, _ = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        feeds, fetch = MODELS[model](S, lenet, resnet)
    main.meta["feed_targets"] = feeds
    main.meta["fetch_targets"] = [fetch.name]
    return main


def _est_fields(est):
    return (est.params_bytes, est.feeds_bytes, est.fetch_bytes,
            est.intermediates_peak_bytes, est.residency_peak_bytes,
            est.high_water_op_index, est.high_water_op_type,
            sorted(est.unsized_vars))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_peak_memory_estimates_match_jax(model):
    programs = {side: _build(side, model) for side in SIDES}
    for batch in (1, 4, 32):
        want = jplanner.estimate_peak_memory(programs["jax"],
                                             batch_size=batch)
        got = tplanner.estimate_peak_memory(programs["port"],
                                            batch_size=batch)
        assert _est_fields(got) == _est_fields(want), (model, batch)
        assert got.params_bytes > 0 and got.intermediates_peak_bytes > 0
        for discount in (0.25, 1.0):
            for donate in (False, True):
                assert got.step_peak_bytes(donate, discount) == \
                    want.step_peak_bytes(donate, discount)
        assert got.step_peak_bytes() == want.step_peak_bytes(
            fusion_discount=1.0)
        # a capture holds every intermediate of the block at once
        assert want.intermediates_peak_bytes <= \
            got.intermediates_total_bytes == got.capture_peak_bytes()
        assert got.capture_peak_bytes(0.25) == int(
            0.25 * got.intermediates_total_bytes)
        for budget in (1024, 1e12):
            jd = jplanner.plan_program(programs["jax"], batch_size=batch,
                                       hbm_budget_bytes=budget)
            td = tplanner.plan_program(programs["port"], batch_size=batch,
                                       hbm_budget_bytes=budget)
            assert td.fits() == jd.fits() == (budget > 1024)
            jdiag, tdiag = jd.fit_diagnostic(), td.fit_diagnostic()
            assert (tdiag is None) == (jdiag is None)
            if tdiag is not None:
                assert (tdiag.code, tdiag.severity, tdiag.op_index,
                        tdiag.op_type) == (jdiag.code, jdiag.severity,
                                           jdiag.op_index, jdiag.op_type)


def _mlp(side, batch=-1):
    ir = SIDES[side][0]
    p = ir.Program()
    b = p.global_block()
    b.create_var(name="x", shape=(batch, 4), dtype="float32", is_data=True)
    b.create_var(name="w", shape=(4, 8), dtype="float32", persistable=True,
                 is_parameter=True)
    b.create_var(name="h", shape=(batch, 8), dtype="float32")
    b.create_var(name="y", shape=(batch, 8), dtype="float32")
    b.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["h"]})
    b.append_op("relu", {"X": ["h"]}, {"Out": ["y"]})
    p.meta["feed_targets"] = ["x"]
    p.meta["fetch_targets"] = ["y"]
    return p, b


def test_estimator_units_match_jax():
    for side, mod in (("jax", jplanner), ("port", tplanner)):
        p, b = _mlp(side)
        est = mod.estimate_peak_memory(p, batch_size=8)
        assert (est.params_bytes, est.feeds_bytes, est.fetch_bytes,
                est.intermediates_peak_bytes, est.high_water_op_index) == \
            (4 * 8 * 4, 8 * 4 * 4, 8 * 8 * 4, 2 * 8 * 8 * 4, 1)
        b.append_op("scale", {"X": ["w"]}, {"Out": ["w"]},
                    attrs={"scale": 0.5})
        b.create_var(name="blind")
        b.append_op("relu", {"X": ["y"]}, {"Out": ["blind"]})
        est2 = mod.estimate_peak_memory(p, batch_size=8)
        assert est2.intermediates_peak_bytes == est.intermediates_peak_bytes
        assert "blind" in est2.unsized_vars
        assert mod.var_bytes(b.var("x").desc, batch_size=8) == 128
        assert mod.var_bytes(b.var("blind").desc) is None
        assert mod.dtype_bytes("float64") == 8
        assert mod.dtype_bytes("int64") == 8
        est3 = mod.MemoryEstimate(params_bytes=100, feeds_bytes=10,
                                  fetch_bytes=20,
                                  intermediates_peak_bytes=60,
                                  stash_bytes=7)
        assert est3.residency_peak_bytes == 177
        assert est3.step_peak_bytes(fusion_discount=0.5) == \
            110 + 120 + 7 + 20
        p, _ = _mlp(side)
        plan = mod.plan_program(p, batch_size=8, hbm_budget_bytes=64)
        d = plan.fit_diagnostic()
        assert d.code == "model-does-not-fit"
        for needle in ("budget", "high-water mark", "params", "batch 8"):
            assert needle in d.message
        assert {x.code for x in mod.plan_program(
            p, batch_size=8, hbm_budget_bytes=1e9).diagnostics()} == \
            {"peak-memory"}


def test_sharding_half_waits_for_item_15():
    """Item 15a ported the sharding half: meshes beyond one device parse
    and plan (tests/test_torch_planner_sharding.py holds it against the
    JAX package)."""
    assert tplanner.MeshSpec.parse("dp:1").total() == 1
    assert tplanner.MeshSpec.parse(None).describe() == "single-device"
    with pytest.raises(EnforceError):
        tplanner.MeshSpec.parse("dp")
    mesh = tplanner.MeshSpec.parse("dp:2,tp:4")
    assert mesh.total() == 8 and mesh.batch_axis() == "dp"
    p, _ = _mlp("port")
    plan = tplanner.plan_program(p, mesh="dp:2", batch_size=4)
    assert plan.mesh.describe() == "dp:2"
    specs, hazards, events = tplanner.propagate_shardings(p, None)
    assert events == []
    assert tplanner.price_collectives([], None)["count"] == 0
    assert tplanner.PlannerPass().run(p, None)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_rung_estimates_match_jax(paged):
    import jax
    from paddle_tpu.ops import generation as jgen
    from paddle_tpu_torch.ops import generation as tgen
    from paddle_tpu_torch.weights import params_from_jax
    cfg = dict(vocab_size=32, d_model=16, num_heads=2, num_layers=1,
               max_len=32)
    jlm = jgen.TinyDecoderLM(jgen.LMConfig(**cfg))
    jparams = jlm.init_params(0)
    tlm = tgen.TinyDecoderLM(tgen.LMConfig(**cfg), device="cpu")
    tlm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    if paged:
        kw = dict(batch_size=2, max_len=32, block_size=8, spec_k=2,
                  kv_dtype="int8")
        want = jplanner.estimate_paged_rungs(
            jgen.PagedDecodeEngine(jlm, jparams, **kw))
        got = tplanner.estimate_paged_rungs(
            tgen.PagedDecodeEngine(tlm, device="cpu", **kw),
            fusion_discount=0.25)
    else:
        want = jplanner.estimate_decode_rungs(
            jgen.DecodeEngine(jlm, jparams, batch_size=2, max_len=32))
        got = tplanner.estimate_decode_rungs(
            tgen.DecodeEngine(tlm, batch_size=2, max_len=32, device="cpu"),
            fusion_discount=0.25)
    assert got == want and all(v > 0 for v in got.values())


class _Entry:
    def __init__(self, memory, static_args=()):
        self.memory = memory
        self.static_args = tuple(static_args)


class _FakeLedger:
    def __init__(self, table):
        self._table = table

    def entries(self, scope=None, key=None):
        return list(self._table.get((scope, key), []))


def _cross_check_story(mod):
    mod.clear_static_estimates()
    for key in ("good", "bad", "silent", "degraded", "eager"):
        mod.register_static_estimate("s", key, 100)
    mod.register_static_estimate("s", "prefill", 100,
                                 static_args={"bucket": 8})
    ledger = _FakeLedger({
        ("s", "good"): [_Entry({"peak_bytes": 1000.0}),
                        _Entry({"peak_bytes": 110.0}),
                        _Entry({"degraded": True})],
        ("s", "bad"): [_Entry({"peak_bytes": 400.0})],
        ("s", "silent"): [],
        ("s", "degraded"): [_Entry({"degraded": True})],
        ("s", "eager"): [_Entry(None)],
        ("s", "prefill"): [
            _Entry({"peak_bytes": 105.0}, static_args=(("bucket", 8),)),
            _Entry({"peak_bytes": 900.0}, static_args=(("bucket", 16),))],
    })
    cc = mod.cross_check(tolerance=0.25, ledger=ledger)
    mod.clear_static_estimates(scope="s")
    return cc, mod.cross_check_section()


def test_cross_check_legs_match_jax():
    want = _cross_check_story(jplanner)
    got = _cross_check_story(tplanner)
    assert got == want
    by = {leg["key"]: leg for leg in got[0]["legs"]}
    assert by["good"]["status"] == "ok" and by["prefill"]["status"] == "ok"
    assert by["bad"]["status"] == "fail"
    assert by["silent"]["skip_reason"] == "no-measurement"
    assert by["degraded"]["skip_reason"] == "memory-analysis-degraded"
    assert got[1] is None


def test_server_registers_capture_estimates_and_clears_them(tmp_path):
    from paddle_tpu_torch import inference as tinf
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.observability import profile as tprof
    from paddle_tpu_torch.serving import InferenceServer, ModelRegistry
    from paddle_tpu_torch.serving.registry import SwapError
    tir.reset_unique_names()
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [8], "float32")
        out = tstatic.fc(tstatic.fc(x, 16, act="relu"), 4, act="softmax")
    d = str(tmp_path / "m")
    exe = Executor("cpu")
    with scope_guard(Scope()):
        exe.run(startup)
        tstatic.io.save_inference_model(d, ["x"], [out], exe,
                                        main_program=main)
    cfg = tinf.Config(d)
    cfg.disable_gpu()
    srv = InferenceServer(tinf.create_predictor(cfg), buckets=[1, 4],
                          max_wait_ms=5)
    try:
        mine = {r["key"]: r for r in tplanner.registered_estimates()
                if r["scope"] == srv.ledger_scope}
        assert set(mine) == {"bucket1", "bucket4"}
        plan = srv.stats()["plan"]
        est = tplanner.estimate_peak_memory(
            tinf.create_predictor(cfg)._program, batch_size=4)
        assert mine["bucket4"]["estimate_bytes"] == est.capture_peak_bytes()
        assert plan["bucket4"] == est.step_peak_bytes()
        srv.warmup({"x": np.zeros((1, 8), np.float32)})
        section = tprof.profile_snapshot()["plan_check"]
        legs = [g for g in section["legs"] if g["scope"] == srv.ledger_scope]
        # eager runs on the CPU measure nothing: skip, never a pass
        assert [g["status"] for g in legs] == ["skip", "skip"]
    finally:
        srv.shutdown(drain=False)
    assert not [r for r in tplanner.registered_estimates()
                if r["scope"] == srv.ledger_scope]
    reg = ModelRegistry(buckets=[1, 4], max_wait_ms=5)
    try:
        with pytest.raises(SwapError) as ei:
            reg.deploy("m", "v1", tinf.create_predictor(cfg),
                       hbm_budget_bytes=100.0)
        assert ei.value.stage == "verify"
        assert "model-does-not-fit" in str(ei.value)
        assert reg.deploy("m", "v2", tinf.create_predictor(cfg),
                          hbm_budget_bytes=16e9)["ok"]
    finally:
        reg.drain_all()


# ---------------------------------------------------------------------------
# lints
# ---------------------------------------------------------------------------

def _lint(side, program):
    mgr = (JManager if side == "jax" else TManager)(
        passes=list(JLINTS if side == "jax" else TLINTS), raise_on=None)
    return sorted(((d.code, d.severity, d.block_idx, d.op_index, d.op_type,
                    d.var) for d in mgr.run(program)), key=repr)


def _hazards(side):
    """A program tripping every lint but the host-sync one."""
    ir = SIDES[side][0]
    p = ir.Program()
    b = p.global_block()
    b.create_var(name="x", shape=(-1, -1), dtype="float32", is_data=True)
    b.create_var(name="u", shape=None, dtype="float32", is_data=True)
    b.create_var(name="d", shape=(4,), dtype="float64")
    b.create_var(name="w", shape=(4, 4), dtype="float32", persistable=True)
    b.create_var(name="big", shape=(300, 300), dtype="float32")
    b.create_var(name="c", shape=(4,), dtype="float32")
    b.append_op("assign_value", {}, {"Out": ["big"]},
                attrs={"values": np.zeros((300, 300), np.float32),
                       "shape": [300, 300], "dtype": "float32"})
    b.append_op("cast", {"X": ["x"]}, {"Out": ["d"]},
                attrs={"out_dtype": "float64", "in_dtype": "float32"})
    b.append_op("scale", {"X": ["c"]}, {"Out": ["w"]},
                attrs={"scale": 2.0})
    b.append_op("sgd", {"Param": ["w"], "Grad": ["c"],
                        "LearningRate": ["c"]}, {"ParamOut": ["w"]},
                role="optimize")
    p.meta["is_test"] = True
    return p


@pytest.mark.parametrize("model", sorted(MODELS) + ["hazards"])
def test_lints_match_jax(model):
    if model == "hazards":
        programs = {side: _hazards(side) for side in SIDES}
    else:
        programs = {side: _build(side, model) for side in SIDES}
    got = _lint("port", programs["port"])
    assert got == _lint("jax", programs["jax"])
    if model == "hazards":
        assert {g[0] for g in got} == {
            "tpu-float64", "tpu-host-constant", "tpu-dynamic-inner-dim",
            "tpu-unbounded-feed", "tpu-missing-donation",
            "tpu-state-write-in-inference"}


def _while_program(side):
    ir, S = SIDES[side][:2]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = S.data("x", [4], "float32")
        acc = S.fill_constant([1, 4], "float32", 0.0)
        i = S.fill_constant([1], "int64", 0)
        n = S.fill_constant([1], "int64", 3)
        cond = S.less_than(i, n)
        loop = S.While(cond)
        with loop.block():
            S.assign(S.elementwise_add(acc, x), acc)
            ni = S.increment(S.assign(i), value=1)
            S.assign(ni, i)
            S.assign(S.less_than(ni, n), cond)
    main.meta["feed_targets"] = ["x"]
    main.meta["fetch_targets"] = [acc.name]
    return main


def test_host_sync_lint_divergence_is_pinned():
    """The port's `lint_host_sync_ops` warns once per host op type (a
    `while` ends a captured segment); the JAX package's AST checker
    finds nothing in its `while` kernel. Every other lint agrees."""
    port = _lint("port", _while_program("port"))
    jax_ = _lint("jax", _while_program("jax"))
    host = [g for g in port if g[0] == "tpu-host-sync"]
    assert [(g[1], g[4]) for g in host] == [("warning", "while")]
    assert not [g for g in jax_ if g[0] == "tpu-host-sync"]
    assert [g for g in port if g[0] != "tpu-host-sync"] == jax_
    diags = lint_graph(_while_program("port"))
    assert any(d.code == "tpu-host-sync" and "host" in d.message
               for d in diags)


def test_quant_parity_check_matches_jax():
    rng = np.random.RandomState(0)
    ref = [rng.randn(4, 10).astype(np.float32), rng.rand(4).astype(
        np.float32)]
    for noise, threshold in ((1e-3, 0.05), (0.5, 0.05), (0.0, 0.0)):
        out = [r + noise * rng.randn(*r.shape).astype(np.float32)
               for r in ref]
        jrel, jdiag = jnumerics.quant_parity_check(out, ref, threshold)
        trel, tdiag = tnumerics.quant_parity_check(out, ref, threshold)
        assert trel == jrel
        assert (tdiag is None) == (jdiag is None)
        if tdiag is not None:
            assert (tdiag.code, tdiag.severity, tdiag.message) == (
                jdiag.code, jdiag.severity, jdiag.message)
    with pytest.raises(EnforceError):
        tnumerics.quant_parity_check(ref, ref[:1])
