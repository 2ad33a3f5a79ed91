"""The Fluid static core of the port (Program IR, registry, scope,
lowering, Executor, flags, dtypes, the static builders) against the JAX
package, on the CPU, with a tiny ResNet (width 8, blocks (1, 1, 1, 1),
3 x 32 x 32, 10 classes) and LeNet.

* Program JSON round-trips in both directions, and the same builder
  calls (after `reset_unique_names` in both packages) give equal
  `to_dict()`, every VarDesc's shape and dtype included.
* The Executor on the JAX package's weights (moved by name as numpy
  arrays) gives the JAX Executor's outputs: logits within rtol 1e-4 /
  atol 1e-5 (float32; convolutions sum in another order).
* A program with an `autodiff` op, loaded from the JAX package's JSON,
  now trains through the port's Executor (the static-training slice)
  with the JAX run's losses (rtol 1e-5); the name of that test is the
  one it had when such a program raised NotImplementedError.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.models.lenet import build_static as jlenet
from paddle_tpu.models.resnet import build_static as jresnet
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import dtypes as tdt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.enforce import EnforceError, OpRunError
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.models.lenet import build_static as tlenet
from paddle_tpu_torch.models.resnet import build_static as tresnet
from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(num_classes=10, width=8, blocks=(1, 1, 1, 1))


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """The port's counterpart of conftest's JAX isolation: new default
    programs, unique names and scope per test."""
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


MODELS = {
    "resnet": ((3, 32, 32), lambda i, l: jresnet(i, l, **TINY),
               lambda i, l: tresnet(i, l, **TINY)),
    "lenet": ((1, 28, 28), jlenet, tlenet),
}


def _build(side, model):
    shape, jfn, tfn = MODELS[model]
    ir, static = (jir, pt.static) if side == "jax" else (tir, tstatic)
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        img = static.data("img", list(shape), "float32")
        label = static.data("label", [1], "int64")
        outs = (jfn if side == "jax" else tfn)(img, label)
    return main, startup, outs


def _batch(model, n=4, seed=0):
    rng = np.random.RandomState(seed)
    shape = MODELS[model][0]
    return {"img": rng.randn(n, *shape).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


def _jax_weights(jmain, jstartup):
    exe = pt.Executor()
    exe.run(jstartup)
    scope = pt.global_scope()
    return {v.name: scope.find_np(v.name) for v in jmain.list_vars()
            if v.persistable and scope.has(v.name)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_same_builder_calls_give_equal_programs(model):
    jmain, jstart, _ = _build("jax", model)
    tmain, tstart, _ = _build("port", model)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    # spot-check the declared dtypes the IR records (x64 declared types)
    blk = tmain.global_block()
    assert blk.var("label").dtype == torch.int64
    assert blk.var("top_k_out_1").dtype == torch.int64
    assert blk.var("accuracy_out_0").shape == ()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_program_json_round_trips_both_ways(model):
    jmain, jstart, _ = _build("jax", model)
    tmain, tstart, _ = _build("port", model)
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        assert tir.Program.from_json(jp.to_json()).to_dict() == jp.to_dict()
        assert jir.Program.from_json(tp.to_json()).to_dict() == tp.to_dict()
        again = tir.Program.from_json(tp.to_json())
        assert again.to_json() == tp.to_json()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_executor_on_jax_weights_matches_jax(model):
    jmain, jstart, jouts = _build("jax", model)
    weights = _jax_weights(jmain, jstart)
    feed = _batch(model)
    jtest = jmain.clone(for_test=True)
    want = pt.Executor().run(jtest, feed=feed, fetch_list=list(jouts))
    tmain, _, touts = _build("port", model)
    scope = scope_from_jax(weights, Scope(), "cpu")
    got = TExecutor("cpu").run(tmain.clone(for_test=True), feed=feed,
                               fetch_list=list(touts), scope=scope)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_training_mode_forward_updates_running_stats_like_jax():
    """A main program run in training mode (batch statistics) writes the
    new running mean/variance back to the scope in both packages."""
    jmain, jstart, jouts = _build("jax", "resnet")
    weights = _jax_weights(jmain, jstart)
    feed = _batch("resnet", n=6, seed=1)
    want = pt.Executor().run(jmain, feed=feed, fetch_list=[jouts[0]])
    tmain, _, touts = _build("port", "resnet")
    scope = scope_from_jax(weights, Scope(), "cpu")
    got = TExecutor("cpu").run(tmain, feed=feed, fetch_list=[touts[0]],
                               scope=scope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    jscope = pt.global_scope()
    for name in ("bn_mean_0", "bn_var_0", "bn_mean_3"):
        np.testing.assert_allclose(scope.find_np(name),
                                   jscope.find_np(name), **TOL)
        assert not np.allclose(scope.find_np(name), weights[name])


def test_autodiff_program_raises_not_implemented():
    jmain, jstart, (logits, loss, acc) = _build("jax", "lenet")
    with jir.program_guard(jmain, jstart):
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    assert any(op.type == "autodiff" for op in jmain.global_block().ops)
    tmain = tir.Program.from_json(jmain.to_json())
    scope = scope_from_jax(_jax_weights(jmain, jstart), Scope(), "cpu")
    exe, texe = pt.Executor(), TExecutor("cpu")
    for _ in range(2):
        (want,) = exe.run(jmain, feed=_batch("lenet"), fetch_list=[loss.name])
        (got,) = texe.run(tmain, feed=_batch("lenet"),
                          fetch_list=[loss.name], scope=scope)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_startup_program_seeds_reproducibly():
    _, tstart, _ = _build("port", "resnet")
    runs = []
    for seed in (0, 0, 1):
        tstart.random_seed = seed
        scope = Scope()
        TExecutor("cpu").run(tstart, scope=scope)
        runs.append(scope_to_numpy(scope, ["conv2d_w_0", "fc_w_0",
                                           "bn_var_0"]))
    for name in runs[0]:
        np.testing.assert_array_equal(runs[0][name], runs[1][name])
    assert not np.array_equal(runs[0]["conv2d_w_0"], runs[2]["conv2d_w_0"])
    np.testing.assert_array_equal(runs[0]["bn_var_0"], np.ones(8, np.float32))
    # conv weights ~ Normal(0, sqrt(2 / (7 * 7 * 3)))
    std = float(np.std(runs[0]["conv2d_w_0"]))
    assert abs(std / (2.0 / 147) ** 0.5 - 1.0) < 0.1


def test_feed_is_validated_against_vardescs():
    tmain, _, (logits, _, _) = _build("port", "lenet")
    exe = TExecutor("cpu")
    scope = Scope()
    exe.run(tir.default_startup_program(), scope=scope)
    with pytest.raises(EnforceError, match="rank mismatch"):
        exe.run(tmain, feed={"img": np.zeros((2, 28, 28), np.float32)},
                fetch_list=[logits], scope=scope)
    with pytest.raises(EnforceError, match="shape mismatch"):
        exe.run(tmain, feed={"img": np.zeros((2, 1, 27, 28), np.float32)},
                fetch_list=[logits], scope=scope)


def test_executor_caches_one_step_per_program_version():
    tmain, tstart, (logits, _, _) = _build("port", "lenet")
    exe = TExecutor("cpu")
    scope = Scope()
    test = tmain.clone(for_test=True)
    with scope_guard(scope):
        exe.run(tstart)
        feed = _batch("lenet")
        a = exe.run(test, feed=feed, fetch_list=[logits])
        b = exe.run(test, feed=feed, fetch_list=[logits])
        assert len(exe._cache) == 2   # startup + test program
        np.testing.assert_array_equal(a[0], b[0])
        test._version += 1
        exe.run(test, feed=feed, fetch_list=[logits])
        assert len(exe._cache) == 3


def test_make_step_fn_without_a_device_means_the_gpu(monkeypatch):
    """make_step_fn takes device=None as CUDA, as every entry point of the
    port does: where no GPU is visible it raises instead of building a
    step on the CPU; with device="cpu" the step runs there."""
    from paddle_tpu_torch.core.lowering import make_step_fn
    _, tstart, _ = _build("port", "lenet")
    state = [v.name for v in tstart.list_vars() if v.persistable]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_step_fn(tstart, [], [], [])
    step = make_step_fn(tstart, [], state, [], device="cpu")
    fetches, new_state = step({}, {}, 0)
    assert fetches and all(t.device == torch.device("cpu") for t in fetches)
    assert set(state) <= set(new_state)


def test_construction_time_shape_inference_is_strict():
    """A mis-built static graph fails where it is built, naming the op;
    a -1 batch dim defers failures that the sentinel could cause."""
    main = tir.Program()
    with tir.program_guard(main, tir.Program()):
        x = tstatic.data("x", [4, 6], append_batch_size=False)
        w = main.global_block().create_var(name="w", shape=(5, 3),
                                           dtype="float32", persistable=True)
        with pytest.raises(OpRunError, match="construction-time shape"):
            tstatic.mul(x, w)
        y = tstatic.data("y", [6])
        out = tstatic.relu(y)
        assert out.shape == (-1, 6) and out.dtype == torch.float32


def test_flags_check_nan_inf_and_verify_program():
    tmain, tstart, (logits, _, _) = _build("port", "lenet")
    exe = TExecutor("cpu")
    scope = Scope()
    exe.run(tstart, scope=scope)
    bad = dict(_batch("lenet"), img=np.full((4, 1, 28, 28), np.nan,
                                            np.float32))
    tflags.set_flag("check_nan_inf", True)
    try:
        with pytest.raises(EnforceError, match="check_nan_inf"):
            exe.run(tmain.clone(for_test=True), feed=bad,
                    fetch_list=[logits], scope=scope)
    finally:
        tflags.set_flag("check_nan_inf", False)
    broken = tmain.clone(for_test=True)
    broken.global_block().ops[0].inputs["Input"] = ["nowhere"]
    tflags.set_flag("verify_program", True)
    try:
        with pytest.raises(tanalysis.AnalysisError, match="undefined-input"):
            exe.run(broken, feed=_batch("lenet"), fetch_list=[logits],
                    scope=scope)
    finally:
        tflags.set_flag("verify_program", False)
    assert set(tflags.all_flags()) >= {"check_nan_inf", "executor_log_level",
                                       "verify_program"}


def test_verifier_findings_match_jax():
    """The same broken programs give the same (code, op index, var)
    findings from both verifiers."""
    from paddle_tpu import analysis as janalysis
    jmain, _, (jlogits, _, _) = _build("jax", "resnet")
    jtest = jmain.clone(for_test=True)
    jtest.meta["fetch_targets"] = [jlogits.name]
    ops = jtest.global_block().ops
    ops[3].inputs["X"] = ["ghost"]              # undefined input
    ops[5], ops[6] = ops[6], ops[5]             # use before write
    jtest.global_block().vars["conv2d_out_1"].shape = (-1, 9, 8, 8)
    ttest = tir.Program.from_json(jtest.to_json())

    def key(diags):
        return sorted((d.code, d.severity, d.op_index, d.var) for d in diags)

    want = janalysis.verify_program(jtest, raise_on=None)
    got = tanalysis.verify_program(ttest, raise_on=None)
    assert key(got) == key(want)
    assert {d.code for d in got} >= {"undefined-input", "use-before-write",
                                     "shape-mismatch"}


def test_scope_find_np_always_copies():
    scope = Scope()
    t = torch.zeros(4)
    scope.set("w", t)
    host = scope.find_np("w")
    t.add_(1.0)
    assert host.sum() == 0.0
    moved = scope.tensor_on("w", torch.device("cpu"))
    assert moved is t
    scope.set("n", np.arange(3, dtype=np.int64))
    assert scope.tensor_on("n", torch.device("cpu")).dtype == torch.int64


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32",
                                  "float64", "int8", "uint8", "int16",
                                  "int32", "int64", "bool"])
def test_dtype_registry_names(name):
    from paddle_tpu.core import dtypes as jdt
    d = tdt.normalize_dtype(name)
    assert tdt.dtype_name(d) == name == jdt.dtype_name(jdt.normalize_dtype(name))
    assert tdt.device_dtype(name) is d    # 64-bit stays 64-bit on the card
    assert tdt.is_floating(d) == jdt.is_floating(jdt.normalize_dtype(name))
    if name != "bfloat16":
        assert tdt.normalize_dtype(np.dtype(name)) is d
        assert tdt.numpy_dtype(d) == np.dtype(name)


@pytest.mark.parametrize("expr", ["x + y", "x - y", "x * y", "x / y",
                                  "x + 2.0", "3.0 - x", "x * 0.5", "x / 4.0",
                                  "2.0 / x", "x ** 2.0", "-x"])
def test_variable_operators_match_jax(expr):
    rng = np.random.RandomState(4)
    feed = {"x": np.abs(rng.randn(3, 5)).astype(np.float32) + 0.5,
            "y": np.abs(rng.randn(3, 5)).astype(np.float32) + 0.5}
    outs = {}
    for side, ir, static in (("jax", jir, pt.static), ("port", tir, tstatic)):
        ir.reset_unique_names()
        main = ir.Program()
        with ir.program_guard(main, ir.Program()):
            x = static.data("x", [5])
            y = static.data("y", [5])
            out = eval(expr)
        outs[side] = (main, out)
    (jm, jo), (tm, to) = outs["jax"], outs["port"]
    assert tm.to_dict() == jm.to_dict()
    want = pt.Executor().run(jm, feed=feed, fetch_list=[jo])
    got = TExecutor("cpu").run(tm, feed=feed, fetch_list=[to], scope=Scope())
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6)
