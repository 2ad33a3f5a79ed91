"""The rest of the Fluid surface in the port, against the JAX package on
the CPU: distributions, save / load and save_combine / load_combine
(files cross both ways), WeightedAverage, contrib, the top-level
package surface, the flags, and the ratchet on the static names.

* Distributions: log_prob, entropy and kl_divergence of the port's four
  classes equal the JAX classes' on the same arrays (rtol 1e-6, atol
  1e-6); samples are torch's draws, held by their moments (5 sigma),
  their shapes and their support.
* contrib's tests (tests/test_contrib.py) run through the port's
  contrib, Program and Executor, with their own numbers.
* `import paddle_tpu_torch` builds and loads no kernel, and neither
  does resolving pt.Executor, pt.Program, pt.layers.fc.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import average as javerage
from paddle_tpu.core import flags as jflags
from paddle_tpu.static import distributions as jdist
import paddle_tpu_torch as ptt
from paddle_tpu_torch import average as taverage
from paddle_tpu_torch import contrib as tcontrib
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
from paddle_tpu_torch.static import distributions as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


# ----------------------------------------------------------- distributions
def _pair(name, rng):
    if name == "Uniform":
        lo = rng.uniform(-2, 0, (3, 4)).astype(np.float32)
        return (lo, lo + rng.uniform(0.5, 2, (3, 4)).astype(np.float32))
    if name == "Normal":
        return (rng.randn(3, 4).astype(np.float32),
                rng.uniform(0.5, 2, (3, 4)).astype(np.float32))
    if name == "Categorical":
        return (rng.randn(3, 5).astype(np.float32),)
    return (rng.randn(4).astype(np.float32),
            np.diag(rng.uniform(0.5, 2, 4)).astype(np.float32))


def _value(name, rng):
    if name == "Categorical":
        return rng.randint(0, 5, (3,))
    if name == "MultivariateNormalDiag":
        return rng.randn(4).astype(np.float32)
    return rng.uniform(-2, 2, (3, 4)).astype(np.float32)


NAMES = ("Uniform", "Normal", "Categorical", "MultivariateNormalDiag")


@pytest.mark.parametrize("name", NAMES)
def test_distribution_matches_jax(name):
    rng = np.random.RandomState(NAMES.index(name))
    args, other = _pair(name, rng), _pair(name, rng)
    j, t = getattr(jdist, name)(*args), getattr(tdist, name)(*args,
                                                             device="cpu")
    value = _value(name, rng)
    tv = torch.from_numpy(np.asarray(value))
    np.testing.assert_allclose(t.log_prob(tv).numpy(),
                               np.asarray(j.log_prob(value)), **TOL)
    np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()),
                               **TOL)
    if name != "Uniform":
        np.testing.assert_allclose(
            t.kl_divergence(getattr(tdist, name)(*other,
                                                 device="cpu")).numpy(),
            np.asarray(j.kl_divergence(getattr(jdist, name)(*other))),
            **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_distribution_samples_hold_their_moments(name):
    rng = np.random.RandomState(10 + NAMES.index(name))
    args = _pair(name, rng)
    d = getattr(tdist, name)(*args, device="cpu")
    n = 20000
    s = d.sample([n], seed=3)
    again = d.sample([n], seed=3)
    assert not torch.equal(s, again)          # the draw count moves on
    if name == "Categorical":
        assert tuple(s.shape) == (n, 3) and s.dtype == torch.int64
        p = torch.softmax(torch.from_numpy(args[0]), -1).numpy()
        for row in range(3):
            freq = np.bincount(s[:, row].numpy(), minlength=5) / n
            assert (np.abs(freq - p[row])
                    < 5 * np.sqrt(p[row] * (1 - p[row]) / n) + 1e-9).all()
        return
    x = s.double().numpy()
    if name == "Uniform":
        lo, hi = args
        assert (x >= lo).all() and (x < hi).all()
        mean, std = (lo + hi) / 2, (hi - lo) / np.sqrt(12)
    elif name == "Normal":
        mean, std = args
    else:
        mean, std = args[0], np.diag(args[1])
    assert x.shape == (n,) + tuple(np.shape(mean))
    assert (np.abs(x.mean(0) - mean) < 5 * std / np.sqrt(n)).all()
    assert (np.abs(x.var(0) - std ** 2)
            < 5 * std ** 2 * np.sqrt(2.0 / n)).all()


def test_distributions_refuse_graph_variables():
    main = tir.Program()
    with tir.program_guard(main, tir.Program()):
        v = tstatic.data("v", [2], append_batch_size=False)
    with pytest.raises(NotImplementedError):
        tdist.Normal(v, v)


# --------------------------------------------------------------- save/load
def _fc_program(side):
    ir = pt.core.ir if side == "jax" else tir
    static = pt.static if side == "jax" else tstatic
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [-1, 4], append_batch_size=False)
        y = static.fc(static.fc(x, 3, act="relu"), 2)
    return main, startup, y.name


def _jax_state(main):
    scope = pt.global_scope()
    return {v.name: scope.find_np(v.name) for v in main.list_vars()
            if v.persistable and scope.has(v.name)}


def test_save_load_cross_both_ways(tmp_path):
    jmain, jstart, out = _fc_program("jax")
    tmain, tstart, tout = _fc_program("port")
    assert out == tout
    exe = pt.Executor()
    exe.run(jstart)
    want = _jax_state(jmain)
    pt.static.save(jmain, str(tmp_path / "jax" / "model"))
    texe = TExecutor("cpu")
    tstatic.load(tmain, str(tmp_path / "jax" / "model"), texe)
    xv = np.random.RandomState(0).rand(5, 4).astype(np.float32)
    got, = texe.run(tmain, feed={"x": xv}, fetch_list=[out])
    jgot, = exe.run(jmain, feed={"x": xv}, fetch_list=[out])
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-6)
    # the port's save, read back by the JAX package
    with scope_guard(Scope()):
        texe.run(tstart)
        mine = {n: global_scope().find_np(n) for n in want}
        tstatic.save(tmain, str(tmp_path / "port" / "model"))
    with open(tmp_path / "port" / "model.json") as f:
        assert json.load(f) == tmain.to_dict()
    pt.static.load(jmain, str(tmp_path / "port" / "model"))
    for name, arr in mine.items():
        np.testing.assert_array_equal(pt.global_scope().find_np(name), arr)


def test_load_raises_a_checkpoint_error_on_a_missing_file(tmp_path):
    from paddle_tpu_torch.static.io import CheckpointError
    with pytest.raises(CheckpointError, match="missing"):
        tstatic.load(tir.Program(), str(tmp_path / "nothing"),
                     TExecutor("cpu"))


def test_save_combine_load_combine_cross_both_ways(tmp_path):
    """The file is one np.savez archive, the JAX package's format. The
    JAX functions themselves cannot run: they call `.open` on
    io.fs.get_fs's (fs, path) tuple (paddle_tpu/static/compat.py:288,
    :295; ROADMAP Queue 3), so the JAX side here is that format, written
    and read as their code does (np.savez into a buffer, np.load of the
    bytes)."""
    import io
    rng = np.random.RandomState(1)
    arrays = {"a": rng.rand(2, 3).astype(np.float32),
              "b": rng.randint(0, 9, (4,)).astype(np.int64)}
    for name, arr in arrays.items():
        pt.global_scope().set(name, arr)
    with pytest.raises(AttributeError, match="open"):
        pt.static.save_combine(["a", "b"], str(tmp_path / "jax.bin"))
    with pytest.raises(AttributeError, match="open"):
        pt.static.load_combine(["a", "b"], str(tmp_path / "jax.bin"))
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    (tmp_path / "jax.bin").write_bytes(buf.getvalue())
    texe = TExecutor("cpu")
    tstatic.load_combine(["a", "b"], str(tmp_path / "jax.bin"), texe)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(global_scope().find_np(name), arr)
    global_scope().set("c", torch.arange(5, dtype=torch.float32))
    tstatic.save_combine(["a", "c"], str(tmp_path / "port.bin"))
    data = np.load(io.BytesIO((tmp_path / "port.bin").read_bytes()))
    assert sorted(data.files) == ["a", "c"]
    np.testing.assert_array_equal(data["a"], arrays["a"])
    np.testing.assert_array_equal(data["c"], np.arange(5, dtype=np.float32))
    with pytest.raises(EnforceError):
        tstatic.save_combine(["missing"], str(tmp_path / "x.bin"))
    with pytest.raises(EnforceError):
        tstatic.load_combine(["b"], str(tmp_path / "port.bin"), texe)


# ---------------------------------------------------------- average, contrib
def test_weighted_average_matches_jax():
    j, t = javerage.WeightedAverage(), taverage.WeightedAverage()
    for v, w in ((1.0, 2), (np.array([3.0, 4.0]), 1), (0.5, 3)):
        if np.ndim(v):
            j2, t2 = javerage.WeightedAverage(), taverage.WeightedAverage()
            for a in (j2, t2):
                a.add(v, w)
                a.add(v * 2, 3)
            np.testing.assert_allclose(t2.eval(), j2.eval())
            continue
        j.add(v, w)
        t.add(v, w)
    assert t.eval() == j.eval()
    t.reset()
    with pytest.raises(ValueError):
        t.eval()


def _contrib_fc(decay, rng_seed=3):
    xs = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    ys = np.random.RandomState(1).rand(8, 1).astype(np.float32)
    tir.reset_unique_names()
    main, startup = tir.Program(), tir.Program()
    main.random_seed = startup.random_seed = rng_seed
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [-1, 4], append_batch_size=False)
        y = tstatic.data("y", [-1, 1], append_batch_size=False)
        pred = tstatic.fc(x, 1)
        loss = tstatic.mean(tstatic.square(pred - y))
        if decay:
            tcontrib.extend_with_decoupled_weight_decay(topt.SGD)(
                0.1, coeff=0.01).minimize(loss)
        else:
            topt.SGD(0.1).minimize(loss)
    scope = Scope()
    exe = TExecutor("cpu")
    exe.run(startup, scope=scope)
    wname = [v.name for v in main.all_parameters() if "w" in v.name][0]
    before = scope.find_np(wname)
    exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss], scope=scope)
    return before, scope.find_np(wname)


def test_decoupled_weight_decay_math():
    """tests/test_contrib.py::test_decoupled_weight_decay_math in the
    port: p_new = sgd_update(p) - coeff p_old."""
    w0, plain = _contrib_fc(False)
    w0b, decayed = _contrib_fc(True)
    np.testing.assert_allclose(w0, w0b)
    np.testing.assert_allclose(decayed, plain - 0.01 * w0, rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(EnforceError):
        tcontrib.extend_with_decoupled_weight_decay(object)


def test_decoupled_decay_param_filter_and_program_tools():
    cls = tcontrib.extend_with_decoupled_weight_decay(topt.SGD)
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [-1, 256], append_batch_size=False)
        h = tstatic.fc(x, 8, act="relu")
        h = tstatic.fc(h, 8, act="relu")
        loss = tstatic.mean(tstatic.square(h))
        cls(0.1, coeff=0.05,
            apply_decay_param_fun=lambda n: "w" in n).minimize(loss)
    assert len([op for op in main.global_block().ops if op.type == "scale"
                and op.attrs.get("scale") == 0.05]) == 2
    uni, adj = tcontrib.op_freq_statistic(main)
    assert uni["mul"] == 2 and uni["relu"] == 2
    assert adj["elementwise_add->relu"] == 2
    assert list(uni) == sorted(uni, key=lambda k: -uni[k])
    lo, hi = tcontrib.memory_usage(main, batch_size=64)
    assert 0 < lo < hi and hi > 0.0078 and lo < 10.0
    with pytest.raises(EnforceError):
        tcontrib.memory_usage(main, batch_size=0)


def test_contrib_summary_and_transpiler_match_jax(capsys):
    def build(side):
        ir = pt.core.ir if side == "jax" else tir
        static = pt.static if side == "jax" else tstatic
        main, startup = ir.Program(), ir.Program()
        with ir.program_guard(main, startup):
            img = static.data("img", [1, 3, 8, 8], "float32",
                              append_batch_size=False)
            c = static.nn.conv2d(img, 4, 3, padding=1, bias_attr=False)
            static.fc(c, 10)
        return main, startup

    jmain, _ = build("jax")
    tmain, tstart = build("port")
    assert tcontrib.summary(tmain) == pt.contrib.summary(jmain)
    rows, totals = tcontrib.summary(tmain)
    assert totals["params"] == 108 + 4 * 8 * 8 * 10 + 10
    assert "Total PARAMs" in capsys.readouterr().out
    assert tcontrib.memory_usage(tmain, 4) == pt.contrib.memory_usage(
        jmain, 4)
    t = tcontrib.QuantizeTranspiler(activation_quantize_type="abs_max")
    t.training_transpile(tmain, tstart)
    assert any("quantize" in op.type for op in tmain.global_block().ops)


# ------------------------------------------------------- top-level surface
#: the JAX package's top-level names the port does not have, each with
#: the ROADMAP Queue 1 item that brings it (or its port counterpart)
TOP_LEVEL_LEFT = {"TPUPlace": "CUDAPlace", "is_compiled_with_tpu":
                  "is_compiled_with_cuda"}


def test_top_level_surface_is_the_references():
    ref = {n for n in dir(pt) if not n.startswith("_")
           and not isinstance(getattr(pt, n), type(pt))
           or n in ("static", "nn", "optimizer", "io", "amp", "inference",
                    "serving", "analysis", "reliability", "slim", "contrib",
                    "utils", "ops", "flags", "layers", "parallel",
                    "distributed")}
    ref -= {n for n in ref if n.startswith("_")}
    port = set(dir(ptt))
    assert ref - port == set(TOP_LEVEL_LEFT)
    for name in ref & port:
        getattr(ptt, name)
    assert ptt.layers is ptt.static is tstatic
    assert ptt.Executor is TExecutor and ptt.Program is tir.Program
    assert ptt.float32 is torch.float32
    from paddle_tpu_torch import unique_name
    assert unique_name.generate("fc").startswith("fc_")
    with pytest.raises(AttributeError):
        ptt.not_a_name


def test_importing_the_package_builds_no_kernel():
    code = (
        "import sys\n"
        "import paddle_tpu_torch as pt\n"
        "assert pt.Executor and pt.Program and pt.layers.fc\n"
        "from paddle_tpu_torch.ops.kernels import _build\n"
        "assert not _build.build_info(), _build.build_info()\n"
        "assert not any(m.split('.')[0] in ('jax', 'paddle_tpu')\n"
        "               for m in sys.modules)\n"
        "print('LIGHT-OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LIGHT-OK" in proc.stdout


#: the flags paddle_tpu/observability/profile.py and
#: paddle_tpu/core/compile_cache.py define that the port keeps in its
#: core/flags.py (compile_cache_jax_cache has no counterpart)
PROFILE_FLAGS = ("profile_compile_ledger", "profile_memory_sample_every",
                 "profile_peak_flops", "compile_cache_dir",
                 "compile_cache_keep", "compile_cache_slow_compile_s")
#: the flags paddle_tpu/analysis/planner.py defines, which the port keeps
#: in its core/flags.py; plan_fusion_discount's default is the port's own
#: (1.0: a captured graph fuses nothing; analysis/planner.py)
PLANNER_FLAGS = ("plan_hbm_bytes", "plan_fusion_discount",
                 "plan_large_param_mb", "plan_link_gbps")


def test_flags_are_the_references():
    """Every flag paddle_tpu/core/flags.py defines, same default and
    type (other JAX modules add their own flags to the registry), plus
    the profile, compile-cache and planner flags."""
    import re

    import paddle_tpu.analysis.planner  # noqa: F401  (defines flags)
    import paddle_tpu.core.compile_cache  # noqa: F401
    import paddle_tpu.observability.profile  # noqa: F401
    with open(os.path.join(REPO, "paddle_tpu", "core", "flags.py")) as f:
        names = set(re.findall(r'define_flag\("(\w+)"', f.read()))
    ref = {k: v for k, v in jflags.all_flags().items() if k in names}
    assert len(ref) == len(names) == 34
    ref.update({k: jflags._REGISTRY[k].default
                for k in PROFILE_FLAGS + PLANNER_FLAGS})
    assert ref["plan_fusion_discount"] == 0.25
    ref["plan_fusion_discount"] = 1.0
    assert tflags.all_flags() == ref
    for name in ref:
        assert type(tflags._REGISTRY[name].default) is type(
            jflags._REGISTRY[name].default), name
    tflags._WARNED.discard("eager_delete_tensor_gb")
    with pytest.warns(UserWarning, match="eager_delete_tensor_gb"):
        tflags.set_flag("eager_delete_tensor_gb", 3.0)
    assert tflags.get_flag("eager_delete_tensor_gb") == 3.0
    tflags.set_flag("eager_delete_tensor_gb", 0.0)


#: the flags a module of the port reads; every other flag names why not
READ_FLAGS = {"check_nan_inf", "executor_log_level", "verify_program",
              "deterministic", "default_dtype", "amp_dtype",
              *PROFILE_FLAGS, "trace_sample_every", "slo_eval_interval_s",
              "slo_availability_objective", "slo_latency_objective",
              "slo_wire_p99_threshold_s", "slo_healthy_score",
              "slo_degraded_score", "plan_hbm_bytes",
              "plan_fusion_discount", "plan_large_param_mb",
              "plan_link_gbps", "fault_plan", "watchdog_deadline_s",
              "train_numerics", "fleet_heartbeat_interval_s",
              "fleet_suspect_after_s", "fleet_lost_after_s",
              "fleet_poll_interval_s", "fleet_reroute_attempts",
              "fleet_spawn_timeout_s", "fleet_scale_cooldown_s",
              "fleet_quiet_after_s", "fleet_min_backends",
              "fleet_max_backends", "ps_retry_attempts", "ps_retry_base_s",
              "ps_retry_max_s", "ps_retry_deadline_s",
              "ps_failover_after_s", "concurrency_check"}


def test_unread_flags_warn_once_and_read_flags_take_effect(monkeypatch):
    from paddle_tpu_torch.amp import decorator as tamp_dec
    from paddle_tpu_torch.amp import eager as tamp_eager
    from paddle_tpu_torch.static.helper import LayerHelper
    reg = tflags._REGISTRY
    assert {n for n, f in reg.items() if not f.unread} == READ_FLAGS
    for name, f in reg.items():
        assert (f.unread is None) == (name in READ_FLAGS), name
        assert f.help.startswith("not read") == (f.unread is not None), name

    # an unread flag set away from its default warns once, from the
    # environment or from set_flag; its default value does not warn
    tflags._WARNED.discard("eager_delete_tensor_gb")
    with pytest.warns(UserWarning,
                      match="eager_delete_tensor_gb.*no effect"):
        tflags.set_flag("eager_delete_tensor_gb", 0.5)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tflags.set_flag("eager_delete_tensor_gb", 0.6)    # once only
        tflags.set_flag("allocator_strategy", "xla")      # its default
        tflags.set_flag("eager_delete_tensor_gb", 0.0)
        tflags.set_flag("ps_retry_deadline_s", 0.5)     # read: no warning
        tflags.set_flag("ps_retry_deadline_s", 30.0)
        tflags.set_flag("fleet_min_backends", 3)       # read: no warning
        tflags.set_flag("fleet_min_backends", 1)
    monkeypatch.setenv("PT_FLAGS_probe_unread", "3")
    with pytest.warns(UserWarning, match="probe_unread"):
        tflags.define_flag("probe_unread", 1, "not read: probe",
                           unread="probe")
    del reg["probe_unread"]

    # the read flags change what the port does
    monkeypatch.setattr(reg["default_dtype"], "value", "float64")
    with tir.program_guard(tir.Program(), tir.Program()):
        w = LayerHelper("probe").create_parameter(None, [2, 3])
    assert w.dtype == torch.float64
    monkeypatch.setattr(reg["amp_dtype"], "value", "float16")
    with tamp_eager.auto_cast():
        assert tamp_eager.get_compute_dtype() == torch.float16
    prog = tir.Program()
    tamp_dec.rewrite_program(prog)
    assert prog.meta["amp"] == "float16"
    monkeypatch.setattr(reg["deterministic"], "value", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    TExecutor("cpu").run(tir.Program())
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark


# ------------------------------------------------------ static-name ratchet
#: the names of paddle_tpu.static that the port's static lacks: a module
#: the JAX package's star imports leak
STATIC_LEFT = {"builtins": "not API: the module common.py imports"}


def test_static_names_left_equal_the_list():
    ref = {n for n in dir(pt.static) if not n.startswith("_")}
    port = {n for n in dir(tstatic) if not n.startswith("_")}
    assert ref - port == set(STATIC_LEFT)
