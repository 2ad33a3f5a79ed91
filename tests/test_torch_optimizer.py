"""The port's optimizer ops, optimizers, regularizers and clips against
the JAX package, on the CPU, in float32.

* Each op that static training appends after `autodiff` (`sgd`,
  `momentum` with and without Nesterov, `adam`, `sum`, `sign`, `clip`,
  `sqrt`, `squared_l2_norm`, `frobenius_norm`, `square_error_cost`)
  against the reference op on the same numpy inputs: the same shapes and
  dtypes, values within rtol 1e-6 / atol 1e-7 (the same float32
  operations in the same order; only libm and vector widths differ).
* The optimizers name their accumulators and learning rate as the
  reference does, and `minimize` builds the same program for every
  clip, regularizer and Nesterov setting; SGD, Momentum (Nesterov) and
  Adam with GradientClipByValue / ByNorm and a ParamAttr regularizer
  train a small fc net like the JAX package (rtol 1e-5 / atol 1e-7).
* `set_gradient_clip` applies to every later `minimize`;
  `ErrorClipByValue` clips a torch tensor.
* LarsMomentum, Adamax, Adagrad, DecayedAdagrad, Adadelta, RMSProp
  (plain, with momentum, centered), Ftrl, Lamb and Dpsgd (sigma 0: no
  noise) train fit_a_line (fc 13 -> 1, `uci_housing` batches of 32) for
  5 steps like the JAX package from its startup weights: the same
  program, each step's loss and, by name, every parameter and
  accumulator within rtol 1e-5 / atol 1e-7; Dpsgd's noise is seeded
  from the run.
* ExponentialMovingAverage and ModelAverage append the same ops, keep
  the same averages over 3 steps, and `apply()` swaps them in and out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.clip as jclip_mod
import paddle_tpu.regularizer as jreg
from paddle_tpu.io import dataset as jdataset
from paddle_tpu.core import ir as jir
from paddle_tpu.core import registry as jreg_ops
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import clip as tclip_mod
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import registry as treg_ops
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
from paddle_tpu_torch.utils.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.weights import scope_from_jax

OP_TOL = dict(rtol=1e-6, atol=1e-7)
RUN_TOL = dict(rtol=1e-5, atol=1e-7)

SIDES = {
    "jax": (jir, pt.static, pt.optimizer, jreg, jclip_mod, JParamAttr),
    "port": (tir, tstatic, topt, treg, tclip_mod, TParamAttr),
}


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)
    tclip_mod.set_gradient_clip(None)


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _cases():
    rng = np.random.RandomState(0)
    p, g, v = _f32(rng, 5, 7), _f32(rng, 5, 7), _f32(rng, 5, 7)
    m2 = np.abs(_f32(rng, 5, 7))
    lr = np.array([0.05], np.float32)
    pows = (np.array([0.9 ** 3], np.float32), np.array([0.999 ** 3],
                                                       np.float32))
    x = _f32(rng, 4, 6)
    return {
        "sgd": ({}, [p, g, lr]),
        "momentum": ({"mu": 0.9}, [p, g, v, lr]),
        "momentum_nesterov": ({"mu": 0.9, "use_nesterov": True},
                              [p, g, v, lr]),
        "adam": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
                 [p, g, v, m2, *pows, lr]),
        "sum": ({}, [[x, 2 * x, _f32(rng, 4, 6)]]),
        "sign": ({}, [np.array([-2.0, -0.0, 0.0, 3.0], np.float32)]),
        "clip": ({"min": -0.5, "max": 0.25}, [x]),
        "sqrt": ({}, [np.abs(x)]),
        "squared_l2_norm": ({}, [x]),
        "frobenius_norm": ({}, [x]),
        "square_error_cost": ({}, [x, _f32(rng, 4, 6)]),
    }


CASES = _cases()


def _as(fn, a):
    return [fn(t) for t in a] if isinstance(a, list) else fn(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_the_reference_op(case):
    attrs, args = CASES[case]
    op_type = case.split("_nesterov")[0]
    jfn = jreg_ops.get_op(op_type).fn
    tfn = treg_ops.get_op(op_type).fn
    want = jfn(jreg_ops.OpContext(attrs, None, True, 0),
               *[_as(jnp.asarray, a) for a in args])
    got = tfn(treg_ops.OpContext(attrs, None, True, 0, "cpu"),
              *[_as(torch.from_numpy, a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape and t.numpy().dtype == j.dtype
        np.testing.assert_allclose(t.numpy(), j, **OP_TOL)


def test_optimizer_ops_register_under_the_reference_slots():
    for op_type in ("sgd", "momentum", "adam", "sum", "sign", "clip",
                    "sqrt", "squared_l2_norm", "frobenius_norm",
                    "square_error_cost"):
        t, j = treg_ops.get_op(op_type), jreg_ops.get_op(op_type)
        assert [s.name for s in t.in_slots] == [s.name for s in j.in_slots]
        assert [s.name for s in t.out_slots] == [s.name for s in j.out_slots]


def _net(side, opt_name, reg_attr=False, clip=None, **kw):
    """x[6] -> fc 5 (relu) -> fc 1, square error; `reg_attr` gives the
    first weight its own L2Decay through ParamAttr."""
    ir, static, opt, reg, clip_mod, param_attr = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [6], "float32")
        y = static.data("y", [1], "float32")
        attr = param_attr(regularizer=reg.L2Decay(0.01)) if reg_attr \
            else None
        h = static.fc(x, 5, act="relu", param_attr=attr)
        loss = static.mean(static.square_error_cost(static.fc(h, 1), y))
        grad_clip = None
        if clip == "value":
            grad_clip = clip_mod.GradientClipByValue(0.02)
        elif clip == "norm":
            grad_clip = clip_mod.GradientClipByNorm(0.05)
        getattr(opt, opt_name)(grad_clip=grad_clip, **kw).minimize(loss)
    return main, startup, loss.name


NETS = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd_clip_value_reg_attr": ("SGDOptimizer", dict(
        learning_rate=0.1, clip="value", reg_attr=True,
        regularization=treg.L1Decay(1e-3))),
    "momentum_nesterov_clip_norm": ("Momentum", dict(
        learning_rate=0.1, momentum=0.8, use_nesterov=True, clip="norm")),
    "momentum_optimizer": ("MomentumOptimizer", dict(learning_rate=0.1)),
    "adam": ("Adam", dict(learning_rate=0.01, beta1=0.8, beta2=0.99)),
    "adam_optimizer": ("AdamOptimizer", dict(learning_rate=0.01)),
}


def _net_pair(case):
    opt_name, kw = NETS[case]
    kw = dict(kw)
    built = {}
    for side in ("jax", "port"):
        skw = dict(kw)
        if "regularization" in skw:    # the same decay, each package's
            skw["regularization"] = SIDES[side][3].L1Decay(1e-3)
        built[side] = _net(side, opt_name, **skw)
    return built


@pytest.mark.parametrize("case", sorted(NETS))
def test_optimizer_trains_like_jax(case):
    built = _net_pair(case)
    (jmain, jstart, loss), (tmain, tstart, _) = built["jax"], built["port"]
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    exe = pt.Executor()
    exe.run(jstart)
    jscope = pt.global_scope()
    names = [v.name for v in jmain.list_vars()
             if v.persistable and jscope.has(v.name)]
    scope = scope_from_jax({n: jscope.find_np(n) for n in names}, Scope(),
                           "cpu")
    rng = np.random.RandomState(7)
    feed = {"x": _f32(rng, 16, 6), "y": _f32(rng, 16, 1)}
    texe = TExecutor("cpu")
    for _ in range(4):
        (jl,) = exe.run(jmain, feed=feed, fetch_list=[loss])
        (tl,) = texe.run(tmain, feed=feed, fetch_list=[loss], scope=scope)
        np.testing.assert_allclose(tl, jl, **RUN_TOL)
    for n in names:
        np.testing.assert_allclose(scope.find_np(n), jscope.find_np(n),
                                   err_msg=n, **RUN_TOL)


def test_accumulators_carry_the_reference_names():
    for side in ("jax", "port"):
        main, startup, _ = _net(side, "Adam", learning_rate=0.01)
        persist = sorted(v.name for v in main.list_vars() if v.persistable)
        assert persist == sorted(
            ["fc_w_0", "fc_b_0", "fc_w_1", "fc_b_1", "learning_rate_Adam"]
            + [f"{p}_{s}_Adam" for p in ("fc_w_0", "fc_b_0", "fc_w_1",
                                          "fc_b_1")
               for s in ("moment1", "moment2", "beta1pow", "beta2pow")])
        init = {op.outputs["Out"][0]: op.attrs["value"]
                for op in startup.global_block().ops
                if op.type == "fill_constant"}
        assert init["fc_w_0_beta2pow_Adam"] == 0.999
        assert init["learning_rate_Adam"] == 0.01
    main, _, _ = _net("port", "Momentum", learning_rate=0.1, name="mom")
    assert main.global_block().has_var("fc_w_0_velocity_mom")
    assert main.meta["optimizer"] == "mom"


def test_set_gradient_clip_applies_to_later_minimize():
    tclip_mod.set_gradient_clip(tclip_mod.GradientClipByValue(0.5, -0.25))
    assert isinstance(tclip_mod.get_gradient_clip(),
                      tclip_mod.GradientClipByValue)
    main, _, _ = _net("port", "SGD", learning_rate=0.1)
    clips = [op for op in main.global_block().ops if op.type == "clip"]
    assert [op.attrs for op in clips] == [{"min": -0.25, "max": 0.5}] * 4
    tclip_mod.set_gradient_clip(None)
    main, _, _ = _net("port", "SGD", learning_rate=0.1)
    assert not any(op.type == "clip" for op in main.global_block().ops)


def test_error_clip_by_value_clips_a_tensor():
    c = tclip_mod.ErrorClipByValue(0.5)
    got = c.apply(torch.tensor([-1.0, -0.2, 0.7]))
    assert torch.equal(got, torch.tensor([-0.5, -0.2, 0.5]))
    assert (c.min, c.max) == (-0.5, 0.5)
    assert tclip_mod.ErrorClipByValue(1.0, min=-2.0).min == -2.0


#: the nine optimizers of this slice on fit_a_line: (class, kwargs)
FIT_OPTIMIZERS = {
    "lars_momentum": ("LarsMomentum", dict(learning_rate=0.1,
                                           momentum=0.8)),
    "adamax": ("AdamaxOptimizer", dict(learning_rate=0.05, beta1=0.8)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1)),
    "decayed_adagrad": ("DecayedAdagradOptimizer", dict(learning_rate=0.05,
                                                        decay=0.9)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9,
                                  epsilon=1e-4)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01)),
    "rmsprop_momentum": ("RMSPropOptimizer", dict(learning_rate=0.01,
                                                  momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1, l1=1e-3, l2=1e-3)),
    "lamb": ("LambOptimizer", dict(learning_rate=0.02)),
    "dpsgd": ("Dpsgd", dict(learning_rate=0.5, clip=5.0, batch_size=4.0,
                            sigma=0.0)),
}


def _fit_a_line(side, opt_name, extra=None, **kw):
    """fit_a_line: fc 13 -> 1, mean square error, `opt_name`; `extra`
    (ema / model_average) after minimize."""
    ir, static, opt, _, _, _ = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    meta = None
    with ir.program_guard(main, startup):
        x = static.data("x", [13], "float32")
        y = static.data("y", [1], "float32")
        loss = static.mean(static.square_error_cost(static.fc(x, 1), y))
        getattr(opt, opt_name)(**kw).minimize(loss)
        if extra == "ema":
            meta = opt.ExponentialMovingAverage(0.9)
            meta.update()
        elif extra == "model_average":
            meta = opt.ModelAverage(0.15)
    return main, startup, loss.name, meta


def _fit_batches(steps):
    samples = list(jdataset.uci_housing.train(32 * steps)())
    for i in range(steps):
        chunk = samples[32 * i:32 * (i + 1)]
        yield {"x": np.stack([s[0] for s in chunk]),
               "y": np.stack([s[1] for s in chunk])}


def _jax_persistables(main):
    jscope = pt.global_scope()
    return {v.name: jscope.find_np(v.name) for v in main.list_vars()
            if v.persistable and jscope.has(v.name)}


@pytest.mark.parametrize("case", sorted(FIT_OPTIMIZERS))
def test_fit_a_line_optimizer_matches_jax(case):
    opt_name, kw = FIT_OPTIMIZERS[case]
    jmain, jstart, loss, _ = _fit_a_line("jax", opt_name, **kw)
    tmain, tstart, _, _ = _fit_a_line("port", opt_name, **kw)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    exe = pt.Executor()
    exe.run(jstart)
    scope = scope_from_jax(_jax_persistables(jmain), Scope(), "cpu")
    texe = TExecutor("cpu")
    for feed in _fit_batches(5):
        (jl,) = exe.run(jmain, feed=feed, fetch_list=[loss])
        (tl,) = texe.run(tmain, feed=feed, fetch_list=[loss], scope=scope)
        np.testing.assert_allclose(tl, jl, **RUN_TOL)
    want = _jax_persistables(jmain)
    assert len(want) >= 3
    for n, w in want.items():
        np.testing.assert_allclose(scope.find_np(n), w, err_msg=n,
                                   **RUN_TOL)


def test_dpsgd_noise_is_seeded_from_the_run():
    """sigma > 0: two runs of the same program from the same state and
    the same run seed update alike; the noise moves the weights off the
    noiseless update."""
    main, startup, loss, _ = _fit_a_line("port", "Dpsgd", learning_rate=0.5,
                                         clip=5.0, batch_size=4.0, sigma=1.0)
    feed = next(_fit_batches(1))
    out = []
    for _ in range(2):
        scope = Scope()
        exe = TExecutor("cpu")
        exe.run(startup, scope=scope)
        w0 = scope.find_np("fc_w_0")
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        out.append(scope.find_np("fc_w_0"))
    np.testing.assert_array_equal(out[0], out[1])
    assert np.abs(out[0] - w0).max() > 0


@pytest.mark.parametrize("extra", ["ema", "model_average"])
def test_averages_match_jax(extra):
    jmain, jstart, loss, jmeta = _fit_a_line("jax", "SGD", extra,
                                             learning_rate=0.05)
    tmain, tstart, _, tmeta = _fit_a_line("port", "SGD", extra,
                                          learning_rate=0.05)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    types = {op.type for op in tmain.global_block().ops}
    assert ({"scale", "sum"} if extra == "ema" else {"increment", "sum"}) \
        <= types
    exe = pt.Executor()
    exe.run(jstart)
    scope = scope_from_jax(_jax_persistables(jmain), global_scope(), "cpu")
    texe = TExecutor("cpu")
    for feed in _fit_batches(3):
        exe.run(jmain, feed=feed, fetch_list=[loss])
        texe.run(tmain, feed=feed, fetch_list=[loss])
    want = _jax_persistables(jmain)
    for n, w in want.items():
        np.testing.assert_allclose(scope.find_np(n), w, err_msg=n,
                                   **RUN_TOL)
    trained = scope.find_np("fc_w_0")
    with tmeta.apply():
        inside = scope.find_np("fc_w_0")
    with jmeta.apply():
        jinside = pt.global_scope().find_np("fc_w_0")
    np.testing.assert_allclose(inside, jinside, **RUN_TOL)
    assert np.abs(inside - trained).max() > 0
    np.testing.assert_array_equal(scope.find_np("fc_w_0"), trained)
