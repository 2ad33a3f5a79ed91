"""Save/load, the export passes, post-training quantization and the
Predictor of the port against the JAX package, on the CPU, with a tiny
ResNet (width 8, blocks (1, 1, 1, 1), 3 x 32 x 32, 10 classes).

The saved artifact (`__model__.json` + `params.npz`) carries weights
between the packages in both directions. Tolerances:

* float32 predictors: rtol 1e-4 / atol 1e-5 (convolutions sum in
  another order);
* the export passes: the same program and bit-equal params (both fold
  batch norm in float64 numpy);
* PTQ: the same frozen op list; x_scale within 1e-5 relative for
  "abs_max" and within one histogram bin (hist_max / 2048) for "hist";
  int8 outputs within INT8_REL (mean |diff| / mean |reference|);
* a JAX-frozen int8 artifact served by the port: the stem's int8 conv
  within 1e-6 relative (the same codes and int32 accumulators; inside
  its jitted program XLA folds the two rescale constants, so outputs
  differ in the last bit), the logits within INT8_REL: from the second
  int8 layer on, a last-bit difference moves the odd activation code
  across a rounding edge, one quantization step (1/127 of the scale).
  This tiny net reads 0.0031 on the CPU; int8 against float32 is about
  0.02 (the JAX package's ResNet-50 reading).
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.models.resnet import build_static as jresnet
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.inference import optimize as topt
from paddle_tpu_torch.models.resnet import build_static as tresnet
from paddle_tpu_torch.reliability.faults import FaultError, fault_plan
from paddle_tpu_torch.weights import scope_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
INT8_REL = 1e-2
TINY = dict(num_classes=10, width=8, blocks=(1, 1, 1, 1))


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, 3, 32, 32).astype(np.float32)


LOADER = [{"img": _images(4, 100 + i)} for i in range(3)]
FEED = {"img": _images(5, 7)}


def _jax_build():
    jir.reset_unique_names()
    main, startup = jir.Program(), jir.Program()
    with jir.program_guard(main, startup):
        img = pt.static.data("img", [3, 32, 32], "float32")
        label = pt.static.data("label", [1], "int64")
        logits, _, _ = jresnet(img, label, **TINY)
    return main, startup, logits


def _port_build():
    tir.reset_unique_names()
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        img = tstatic.data("img", [3, 32, 32], "float32")
        label = tstatic.data("label", [1], "int64")
        logits, _, _ = tresnet(img, label, **TINY)
    return main, startup, logits


def _jax_save(dirname):
    """A JAX-initialized tiny ResNet saved by the JAX package; returns its
    persistables (numpy) too."""
    main, startup, logits = _jax_build()
    exe = pt.Executor()
    exe.run(startup)
    # non-trivial BN statistics, so the conv+BN fold has work to do
    rng = np.random.RandomState(3)
    scope = pt.global_scope()
    for v in main.list_vars():
        if v.name.startswith("bn_mean"):
            scope.set(v.name, rng.randn(*v.shape).astype(np.float32) * 0.1)
        elif v.name.startswith("bn_var"):
            scope.set(v.name, rng.rand(*v.shape).astype(np.float32) + 0.5)
    weights = {v.name: scope.find_np(v.name) for v in main.list_vars()
               if v.persistable and scope.has(v.name)}
    pt.static.io.save_inference_model(dirname, ["img"], [logits], exe,
                                      main_program=main)
    return main, logits, weights


def _port_config(dirname):
    cfg = tinf.Config(dirname)
    cfg.disable_gpu()
    return cfg


def _rel(a, b):
    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))


def test_jax_saved_model_served_by_port_predictor(tmp_path):
    d = str(tmp_path / "m")
    _jax_save(d)
    (want,) = pt.inference.create_predictor(pt.inference.Config(d)).run(FEED)
    pred = tinf.create_predictor(_port_config(d))
    assert pred.get_input_names() == ["img"]
    (got,) = pred.run(FEED)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    types = [op.type for op in pred._program.global_block().ops]
    assert "batch_norm" not in types and types[-1] == "fc"


def test_both_packages_export_the_same_artifact(tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jmain, jlogits, weights = _jax_save(jd)
    tmain, _, tlogits = _port_build()
    scope_from_jax(weights, tstatic.io.global_scope(), "cpu")
    tstatic.io.save_inference_model(td, ["img"], [tlogits], TExecutor("cpu"),
                                    main_program=tmain)
    with open(os.path.join(jd, "__model__.json")) as f:
        jmodel = json.load(f)
    with open(os.path.join(td, "__model__.json")) as f:
        tmodel = json.load(f)
    assert tmodel == jmodel
    with np.load(os.path.join(jd, "params.npz")) as j, \
            np.load(os.path.join(td, "params.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        for name in j.files:
            np.testing.assert_array_equal(t[name], j[name])


def test_port_saved_model_loads_in_jax(tmp_path):
    d = str(tmp_path / "m")
    main, startup, logits = _port_build()
    exe = TExecutor("cpu")
    exe.run(startup)
    test = main.clone(for_test=True)
    (ref,) = exe.run(test, feed=dict(FEED, label=np.zeros((5, 1), np.int64)),
                     fetch_list=[logits])
    tstatic.io.save_inference_model(d, ["img"], [logits], exe,
                                    main_program=main)
    (got,) = tinf.create_predictor(_port_config(d)).run(FEED)
    (want,) = pt.inference.create_predictor(pt.inference.Config(d)).run(FEED)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def _frozen_ops(program):
    return [(op.type, op.inputs, op.outputs) for op in
            program.global_block().ops]


@pytest.mark.parametrize("algo", ["abs_max", "hist"])
def test_ptq_at_load_matches_jax(tmp_path, algo, monkeypatch):
    d = str(tmp_path / "m")
    _jax_save(d)
    # Config.enable_int8 runs the default algorithm; pin it per case in
    # both packages
    import paddle_tpu.slim as jslim
    from paddle_tpu_torch import slim as tslim
    for mod in (jslim, tslim):
        cls = mod.PostTrainingQuantization
        monkeypatch.setattr(cls, "__init__", _with_algo(cls.__init__, algo))
    jcfg = pt.inference.Config(d)
    jcfg.enable_int8(LOADER)
    jpred = pt.inference.create_predictor(jcfg)
    tcfg = _port_config(d)
    tcfg.enable_int8(LOADER)
    tpred = tinf.create_predictor(tcfg)
    jprog, tprog = jpred._program, tpred._program
    assert _frozen_ops(tprog) == _frozen_ops(jprog)
    types = [op.type for op in tprog.global_block().ops]
    assert types.count("quantized_conv2d") == 17
    assert types.count("quantized_mul") == 1
    assert not any(t.startswith("fake_") for t in types)
    f32 = tinf.create_predictor(_port_config(d))
    act_names = [op.inputs.get("Input", op.inputs.get("X"))[0]
                 for op in tprog.global_block().ops
                 if op.type.startswith("quantized_")]
    max_abs = np.zeros(len(act_names))
    for batch in LOADER:
        outs = f32.run(batch, fetch_list=act_names)[1:]
        max_abs = np.maximum(max_abs, [np.abs(o).max() for o in outs])
    for jop, top, amax in zip(
            [o for o in jprog.global_block().ops if "x_scale" in o.attrs],
            [o for o in tprog.global_block().ops if "x_scale" in o.attrs],
            max_abs):
        js, ts = jop.attrs["x_scale"], top.attrs["x_scale"]
        tol = 1e-5 * js if algo == "abs_max" else 1.01 * amax / 2048
        assert abs(ts - js) <= tol, (top.type, ts, js)
    (want,) = jpred.run(FEED)
    (got,) = tpred.run(FEED)
    assert _rel(got, np.asarray(want)) < INT8_REL


def _with_algo(init, algo):
    def patched(self, *a, **kw):
        kw["algo"] = algo
        init(self, *a, **kw)
    return patched


def test_jax_frozen_int8_artifact_runs_in_port(tmp_path):
    d, frozen = str(tmp_path / "m"), str(tmp_path / "frozen")
    _jax_save(d)
    jcfg = pt.inference.Config(d)
    jcfg.enable_int8(LOADER)
    jpred = pt.inference.create_predictor(jcfg)
    (want,) = jpred.run(FEED)
    from paddle_tpu.core.scope import scope_guard as jscope_guard
    with jscope_guard(jpred._scope):
        pt.static.io.save_inference_model(
            frozen, ["img"], jpred.get_output_names(), jpred._exe,
            main_program=jpred._program, optimize=False)
    tpred = tinf.create_predictor(_port_config(frozen))
    types = [op.type for op in tpred._program.global_block().ops]
    assert types.count("quantized_conv2d") == 17 and "quantized_mul" in types
    stem = tpred._program.global_block().ops[0]
    assert stem.type == "quantized_conv2d"
    stem_out = stem.outputs["Output"][0]
    (got, got_stem) = tpred.run(FEED, fetch_list=[stem_out])
    (want_stem,) = jpred._exe.run(jpred._program, feed=FEED,
                                  fetch_list=[stem_out], scope=jpred._scope,
                                  training=False)
    np.testing.assert_allclose(got_stem, np.asarray(want_stem), rtol=1e-6,
                               atol=1e-6)
    assert _rel(got, np.asarray(want)) < INT8_REL
    # the same artifact through the port's int8 config: already frozen,
    # nothing to calibrate
    cfg = _port_config(frozen)
    cfg.enable_int8()
    (again,) = tinf.create_predictor(cfg).run(FEED)
    np.testing.assert_array_equal(again, got)


def test_clone_and_handles(tmp_path):
    d = str(tmp_path / "m")
    _jax_save(d)
    pred = tinf.create_predictor(_port_config(d))
    (ref,) = pred.run(FEED)
    clone = pred.clone()
    assert clone._scope is pred._scope and clone._exe is pred._exe
    h = clone.get_input_handle("img")
    h.reshape(FEED["img"].shape)
    h.copy_from_cpu(FEED["img"].reshape(5, -1))
    assert h.shape == (5, 3, 32, 32)
    clone.run()
    out = clone.get_output_handle(clone.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(out, ref)
    # the original's handles are its own
    assert pred.get_input_handle("img")._value is None
    with pytest.raises(Exception, match="not set"):
        pred.run()


def test_predictor_fault_site_and_unported_options(tmp_path):
    d = str(tmp_path / "m")
    _jax_save(d)
    pred = tinf.create_predictor(_port_config(d))
    with fault_plan("predictor.run@1:raise"):
        with pytest.raises(FaultError):
            pred.run(FEED)
        (out,) = pred.run(FEED)
    assert np.isfinite(out).all()
    for fn in (tinf.export_stablehlo, tinf.export_aot_bundle):
        with pytest.raises(NotImplementedError):
            fn()


def test_bf16_predictor_matches_jax(tmp_path):
    """Config.enable_bfloat16 (ported with the AMP rewrite, which raised
    before): the same rewritten program as the JAX Predictor's, logits
    within 2e-2 of the JAX bf16 Predictor's mean magnitude (the two
    round inside bf16 convs at other points) and of the f32 ones."""
    d = str(tmp_path / "m")
    _jax_save(d)
    jcfg = pt.inference.Config(d)
    jcfg.enable_bfloat16()
    jpred = pt.inference.create_predictor(jcfg)
    (want,) = jpred.run(FEED)
    cfg = _port_config(d)
    cfg.enable_bfloat16()
    pred = tinf.create_predictor(cfg)
    assert pred._program.to_dict()["blocks"] == \
        jpred._program.to_dict()["blocks"]
    assert "cast" in [op.type for op in pred._program.global_block().ops]
    (got,) = pred.run(FEED)
    (f32,) = tinf.create_predictor(_port_config(d)).run(FEED)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _rel(got, np.asarray(want)) < 2e-2, _rel(got, np.asarray(want))
    assert _rel(got, f32) < 2e-2, _rel(got, f32)


def test_persistables_round_trip_and_atomic_write(tmp_path):
    d = str(tmp_path / "ckpt")
    main, startup, _ = _port_build()
    exe = TExecutor("cpu")
    exe.run(startup)
    scope = tstatic.io.global_scope()
    tstatic.io.save_persistables(exe, d, main_program=main)
    before = scope.find_np("conv2d_w_0")
    # a crash between write and publish leaves the previous file intact
    scope.set("conv2d_w_0", torch.zeros(tuple(before.shape)))
    with fault_plan("io.save_persistables:raise"):
        with pytest.raises(FaultError):
            tstatic.io.save_persistables(exe, d, main_program=main)
    fresh = Scope()
    with scope_guard(fresh):
        tstatic.io.load_persistables(exe, d)
    np.testing.assert_array_equal(fresh.find_np("conv2d_w_0"), before)
    # the JAX package reads the port's params file
    pt.static.io.load_persistables(None, d)
    np.testing.assert_array_equal(pt.global_scope().find_np("conv2d_w_0"),
                                  before)
    with pytest.raises(tstatic.io.CheckpointError):
        tstatic.io.load_persistables(exe, str(tmp_path / "missing"))


def test_load_persistables_without_an_executor_means_the_gpu(tmp_path):
    """The port's entry points take device=None as CUDA: with no executor,
    load_persistables resolves the GPU and raises where none is visible,
    never loading onto the CPU quietly; with a CPU executor it still
    round-trips."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: device=None resolves to it")
    d = str(tmp_path / "ckpt")
    main, startup, _ = _port_build()
    exe = TExecutor("cpu")
    exe.run(startup)
    tstatic.io.save_persistables(exe, d, main_program=main)
    before = tstatic.io.global_scope().find_np("conv2d_w_0")
    fresh = Scope()
    with scope_guard(fresh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstatic.io.load_persistables(None, d)
        assert fresh.find_np("conv2d_w_0") is None
        tstatic.io.load_persistables(exe, d)
        np.testing.assert_array_equal(fresh.find_np("conv2d_w_0"), before)


def test_export_passes_match_jax():
    """optimize_inference_program of both packages on the same program
    and params: the same program and bit-equal params."""
    from paddle_tpu.inference.optimize import optimize_inference_program
    jmain, jstart, jlogits = _jax_build()
    with jir.program_guard(jmain, jstart):
        c = pt.static.fill_constant([10], "float32", 2.0)
        bias = pt.static.scale(c, scale=3.0, bias=1.0)
        out = pt.static.elementwise_add(jlogits, bias)
    exe = pt.Executor()
    exe.run(jstart)
    scope = pt.global_scope()
    test = pt.static.io.prune(jmain.clone(for_test=True), [out.name])
    test.meta.update(feed_targets=["img"], fetch_targets=[out.name])
    params = {v.name: scope.find_np(v.name) for v in test.list_vars()
              if v.persistable and scope.has(v.name)}
    tprog = tir.Program.from_json(test.to_json())
    jprog, jparams = optimize_inference_program(test, dict(params))
    tprog, tparams = topt.optimize_inference_program(tprog, dict(params))
    assert tprog.to_dict() == jprog.to_dict()
    assert sorted(tparams) == sorted(jparams)
    for n in jparams:
        np.testing.assert_array_equal(tparams[n], np.asarray(jparams[n]))
    types = [op.type for op in tprog.global_block().ops]
    assert "fill_constant" not in types and "scale" not in types
    assert types.count("fc") == 1 and "batch_norm" not in types


def test_elide_transpose_reshape_matches_jax():
    from paddle_tpu.inference import optimize as jopt
    progs = []
    for ir in (jir, tir):
        p = ir.Program()
        b = p.global_block()
        for n in ("x", "t1", "t2", "r1", "r2"):
            b.create_var(name=n, shape=[2, 3, 4], dtype="float32")
        b.append_op("transpose", {"X": ["x"]}, {"Out": ["t1"]},
                    {"axis": [0, 2, 1]})
        b.append_op("transpose", {"X": ["t1"]}, {"Out": ["t2"]},
                    {"axis": [0, 2, 1]})
        b.append_op("reshape", {"X": ["t2"]}, {"Out": ["r1"]},
                    {"shape": [6, 4]})
        b.append_op("reshape", {"X": ["r1"]}, {"Out": ["r2"]},
                    {"shape": [24]})
        p.meta["fetch_targets"] = ["r2"]
        progs.append(p)
    jopt.elide_transpose_reshape(progs[0])
    topt.elide_transpose_reshape(progs[1])
    assert progs[1].to_dict() == progs[0].to_dict()
    assert [op.type for op in progs[1].global_block().ops] == ["assign",
                                                              "reshape"]


def _lenet(static, img, label):
    c1 = static.conv2d(img, 6, 5, padding=2, act="relu")
    p1 = static.pool2d(c1, 2, "max")
    f1 = static.fc(p1, 32, act="relu")
    return static.fc(f1, 10)


def test_qat_transform_and_freeze_match_jax():
    """QuantizationTransformPass (moving-average activations, per-channel
    weights) gives the same programs in both packages; one training-mode
    run bootstraps the same activation scales; the freeze pass then gives
    the same int8 program (x_scale within 1e-5 relative) and weights."""
    from paddle_tpu import slim as jslim
    from paddle_tpu_torch import slim as tslim
    progs = {}
    for side, ir, static in (("jax", jir, pt.static),
                             ("port", tir, tstatic)):
        ir.reset_unique_names()
        main, startup = ir.Program(), ir.Program()
        with ir.program_guard(main, startup):
            img = static.data("img", [1, 12, 12], "float32")
            label = static.data("label", [1], "int64")
            logits = _lenet(static, img, label)
        mod = jslim if side == "jax" else tslim
        mod.QuantizationTransformPass().apply(main, startup)
        progs[side] = (main, startup, logits)
    (jm, js, jl), (tm, ts, tl) = progs["jax"], progs["port"]
    assert tm.to_dict() == jm.to_dict() and ts.to_dict() == js.to_dict()
    assert any(op.type == "fake_quantize_dequantize_moving_average_abs_max"
               for op in tm.global_block().ops)
    pt.Executor().run(js)
    jscope = pt.global_scope()
    weights = {v.name: jscope.find_np(v.name) for v in jm.list_vars()
               if v.persistable and jscope.has(v.name)}
    tscope = scope_from_jax(weights, Scope(), "cpu")
    feed = {"img": np.random.RandomState(9).randn(3, 1, 12, 12).astype(
        np.float32)}
    (want,) = pt.Executor().run(jm, feed=feed, fetch_list=[jl])
    (got,) = TExecutor("cpu").run(tm, feed=feed, fetch_list=[tl],
                                  scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for name in weights:
        if name.endswith(".quant_scale_0"):
            np.testing.assert_allclose(tscope.find_np(name),
                                       jscope.find_np(name), rtol=1e-5)
            assert tscope.find_np(name)[0] > 0.0
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    jslim.QuantizationFreezePass().apply(jtest, jscope)
    tslim.QuantizationFreezePass().apply(ttest, tscope)
    jd, td = jtest.to_dict(), ttest.to_dict()
    jops, tops = jd["blocks"][0]["ops"], td["blocks"][0]["ops"]
    assert [o["type"] for o in tops] == [o["type"] for o in jops]
    for jo, to in zip(jops, tops):
        js_, ts_ = jo["attrs"].pop("x_scale", None), to["attrs"].pop(
            "x_scale", None)
        assert to == jo
        if js_ is not None:
            assert abs(ts_ - js_) <= 1e-5 * js_
    assert td["blocks"][0]["vars"] == jd["blocks"][0]["vars"]
    for n in ("conv2d_w_0.int8", "conv2d_w_0.scale", "fc_w_1.int8",
              "fc_w_1.scale"):
        np.testing.assert_array_equal(tscope.find_np(n), jscope.find_np(n))
    (want8,) = pt.Executor().run(jtest, feed=feed, fetch_list=[jl])
    (got8,) = TExecutor("cpu").run(ttest, feed=feed, fetch_list=[tl],
                                   scope=tscope)
    assert _rel(got8, np.asarray(want8)) < INT8_REL


def test_convert_to_int8_and_ptq_avg_match_jax(tmp_path):
    """ConvertToInt8Pass stores the same int8 weights and scales; PTQ
    with algo="avg" picks the same scales (1e-5 relative)."""
    from paddle_tpu import slim as jslim
    from paddle_tpu.core.scope import scope_guard as jscope_guard
    from paddle_tpu_torch import slim as tslim
    d = str(tmp_path / "m")
    _jax_save(d)
    jexe = pt.Executor()
    jscope = pt.core.scope.Scope()
    with jscope_guard(jscope):
        jprog, _, _ = pt.static.io.load_inference_model(d, jexe)
    tscope = Scope()
    texe = TExecutor("cpu")
    with scope_guard(tscope):
        tprog, _, _ = tstatic.io.load_inference_model(d, texe)
    jslim.ConvertToInt8Pass().apply(jprog, jscope)
    tslim.ConvertToInt8Pass().apply(tprog, tscope)
    int8_names = [k for k in jscope.keys() if k.endswith((".int8", ".scale"))]
    assert len(int8_names) == 2 * 18
    for n in int8_names:
        np.testing.assert_array_equal(tscope.find_np(n), jscope.find_np(n))
    scales = {}
    for side, mod, exe, prog, scope in (("jax", jslim, jexe, jprog, jscope),
                                        ("port", tslim, texe, tprog, tscope)):
        ptq = mod.PostTrainingQuantization(exe, prog, ["img"], LOADER,
                                           scope=scope, algo="avg")
        if side == "jax":
            with jscope_guard(jscope):
                ptq.quantize()
        else:
            ptq.quantize()
        scales[side] = [op.attrs["x_scale"] for op in prog.global_block().ops
                        if "x_scale" in op.attrs]
    assert len(scales["port"]) == len(scales["jax"]) == 18
    np.testing.assert_allclose(scales["port"], scales["jax"], rtol=1e-5)
