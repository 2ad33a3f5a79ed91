"""Fluid static training in the port against the JAX package, on the CPU.

A program built with `static.*`, then `optimizer.X().minimize(loss)`,
trains through the port's Executor as it trains through the JAX one.
Every run starts from the JAX startup program's weights, moved by name
as numpy arrays (`weights.scope_from_jax`), and its state comes back the
same way (`weights.scope_to_numpy`). float32 throughout.

* `append_backward` + `minimize` give the same ops, var names and
  `autodiff` attributes in both packages (fit_a_line, the tiny ResNet,
  LeNet; with clip, L1Decay and a per-parameter learning rate too).
* fit_a_line (fc 13 -> 1, SGD 0.05, `uci_housing` batches of 32): 20
  steps, per-step loss within rtol 1e-5, the weights within atol 1e-5.
* The tiny ResNet (blocks (1, 1, 1, 1), width 8, 3 x 32 x 32, 10
  classes, batch 4, Momentum 0.0125 / 0.9, L2Decay 1e-4): 3 steps, each
  from the JAX run's state (see `test_resnet_momentum_l2_steps_match_jax`
  for why), the loss within rtol 1e-5 and every parameter, velocity and
  BN statistic within 1e-3 of that var's largest change in the step.
* LeNet (Adam 1e-3, batch 8): 3 steps, losses within rtol 1e-5, the
  moments and beta powers within rtol 1e-4 (atol 1e-6 of the var's max),
  every parameter within 1% of the most Adam moves an element in three
  steps (3 x lr): Adam divides each element's gradient by its own RMS,
  so a gradient that cancels to ~1e-10 carries its rounding into the
  update magnified up to lr / eps (one element of LeNet's fc_w_0 moves
  1.2e-5 apart).
* A `stop_gradient` var cuts the gradient (zeros, as `jax.grad` gives);
  no scope tensor carries autograd state after a training run; at most
  one `autodiff` op a block.
* `io.dataset` (mnist, uci_housing) and the reader decorators give the
  reference's samples bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.clip as jclip_mod
import paddle_tpu.data_feeder as jdata_feeder
import paddle_tpu.regularizer as jreg
import paddle_tpu.unique_name as junique
from paddle_tpu.core import ir as jir
from paddle_tpu.io import dataset as jdataset
from paddle_tpu.io import reader as jreader
from paddle_tpu.models.lenet import build_static as jlenet
from paddle_tpu.models.resnet import build_static as jresnet
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import clip as tclip_mod
from paddle_tpu_torch import data_feeder as tdata_feeder
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch import unique_name as tunique
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.io import dataset as tdataset
from paddle_tpu_torch.io import reader as treader
from paddle_tpu_torch.models.lenet import build_static as tlenet
from paddle_tpu_torch.models.resnet import build_static as tresnet
from paddle_tpu_torch.utils.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

TINY = dict(num_classes=10, width=8, blocks=(1, 1, 1, 1))

#: per package: (ir, static, optimizer module, regularizer module, clip
#: module, ParamAttr)
SIDES = {
    "jax": (jir, pt.static, pt.optimizer, jreg, jclip_mod, JParamAttr),
    "port": (tir, tstatic, topt, treg, tclip_mod, TParamAttr),
}


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """New default programs, unique names and scope of the port per test
    (conftest does the same for the JAX package)."""
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


def _fit_a_line(side):
    _, static, opt, _, _, _ = SIDES[side]
    x = static.data("x", [13], "float32")
    y = static.data("y", [1], "float32")
    pred = static.fc(x, 1)
    loss = static.mean(static.square_error_cost(pred, y))
    opt.SGD(learning_rate=0.05).minimize(loss)
    return loss


def _resnet(side):
    _, static, opt, reg, _, _ = SIDES[side]
    img = static.data("img", [3, 32, 32], "float32")
    label = static.data("label", [1], "int64")
    _, loss, _ = (jresnet if side == "jax" else tresnet)(img, label, **TINY)
    opt.Momentum(learning_rate=0.0125, momentum=0.9,
                 regularization=reg.L2Decay(1e-4)).minimize(loss)
    return loss


def _lenet(side):
    _, static, opt, _, _, _ = SIDES[side]
    img = static.data("img", [1, 28, 28], "float32")
    label = static.data("label", [1], "int64")
    _, loss, _ = (jlenet if side == "jax" else tlenet)(img, label)
    opt.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _clipped(side):
    """fc -> fc with L1Decay, a global-norm clip and one parameter at half
    the learning rate."""
    _, static, opt, reg, clip, param_attr = SIDES[side]
    x = static.data("x", [6], "float32")
    y = static.data("y", [1], "float32")
    h = static.fc(x, 5, act="relu",
                  param_attr=param_attr(name="slow_w", learning_rate=0.5))
    pred = static.fc(h, 1)
    loss = static.mean(static.square_error_cost(pred, y))
    opt.SGD(learning_rate=0.1, regularization=reg.L1Decay(1e-3),
            grad_clip=clip.GradientClipByGlobalNorm(0.05)).minimize(loss)
    return loss


MODELS = {"fit_a_line": _fit_a_line, "resnet": _resnet, "lenet": _lenet,
          "clipped": _clipped}


def _build(side, model):
    ir = SIDES[side][0]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        loss = MODELS[model](side)
    return main, startup, loss.name


def _jax_state(jmain):
    scope = pt.global_scope()
    return {v.name: scope.find_np(v.name) for v in jmain.list_vars()
            if v.persistable and scope.has(v.name)}


def _pair(model):
    """Both packages' programs, the JAX startup run; returns (jax main,
    port main, loss name, JAX executor, the startup state as numpy)."""
    jmain, jstart, loss = _build("jax", model)
    tmain, _, tloss = _build("port", model)
    assert tloss == loss
    exe = pt.Executor()
    exe.run(jstart)
    return jmain, tmain, loss, exe, _jax_state(jmain)


def _image_batch(shape, n, seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(n, *shape).astype(np.float32),
            "label": rng.randint(0, 10, (n, 1)).astype(np.int64)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_minimize_gives_the_same_program(model):
    jmain, jstart, _ = _build("jax", model)
    tmain, tstart, _ = _build("port", model)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    ad = [op for op in tmain.global_block().ops if op.type == "autodiff"]
    assert len(ad) == 1 and ad[0].role == tir.OpRole.BACKWARD
    params = ad[0].attrs["params"]
    assert ad[0].outputs["Grads"] == [p + "@GRAD" for p in params]
    assert params == [v.name for v in tmain.all_parameters()
                      if v.desc.trainable and not v.desc.stop_gradient]
    roles = {op.role for op in tmain.global_block().ops
             if op.type in ("sgd", "momentum", "adam")}
    assert roles == {tir.OpRole.OPTIMIZE}


def test_fit_a_line_trains_like_jax():
    jmain, tmain, loss, exe, state = _pair("fit_a_line")
    scope = scope_from_jax(state, Scope(), "cpu")
    texe = TExecutor("cpu")
    feeder = tdata_feeder.DataFeeder(
        [tmain.global_block().var("x"), tmain.global_block().var("y")])
    batches = treader.batch(tdataset.uci_housing.train(32 * 20), 32)()
    jl, tl = [], []
    for _ in range(20):
        feed = feeder.feed(next(batches))
        jl.append(float(exe.run(jmain, feed=feed, fetch_list=[loss])[0]))
        tl.append(float(texe.run(tmain, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] / 4
    for name in ("fc_w_0", "fc_b_0", "learning_rate_SGD"):
        np.testing.assert_allclose(scope.find_np(name),
                                   pt.global_scope().find_np(name),
                                   rtol=0, atol=1e-5)


def test_resnet_momentum_l2_steps_match_jax():
    """Three steps, each from the JAX run's state. Chained, the tiny
    ResNet is too ill-conditioned for an f32 comparison: batch-4 BN
    statistics and updates of ~30% of the weights grow a 1e-7 weight
    perturbation into 2e-4 of the velocities in three steps of the port
    alone. Data seed 1: with seed 0 the third step puts one ReLU
    pre-activation within 1e-6 of zero (2.2e-7 in the port, below zero in
    the JAX run and in float64), and its flipped mask moves conv2d_w_1's
    gradient by 13% of its update; `test_resnet_kink_step_matches_in_
    float64` pins that step."""
    jmain, tmain, loss, exe, state = _pair("resnet")
    feed = _image_batch((3, 32, 32), 4, seed=1)
    texe = TExecutor("cpu")
    losses = []
    for _ in range(3):
        before = _jax_state(jmain)
        scope = scope_from_jax(before, Scope(), "cpu")
        (tl,) = texe.run(tmain, feed=feed, fetch_list=[loss], scope=scope)
        (jl,) = exe.run(jmain, feed=feed, fetch_list=[loss])
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        losses.append(float(tl))
        after = _jax_state(jmain)
        for name, want in after.items():
            step = np.abs(want - before[name]).max()
            err = np.abs(scope.find_np(name) - want).max()
            assert err <= 1e-3 * step + 1e-7, (name, err, step)
    assert losses[-1] < losses[0]
    # velocities, BN statistics and every parameter were compared
    assert {"conv2d_w_0_velocity_Momentum", "bn_mean_0", "bn_var_4",
            "fc_w_0", "learning_rate_Momentum"} <= set(after)


def test_resnet_kink_step_matches_in_float64():
    """Data seed 0's third step (see above): the port, with every float32
    var of the program and state made float64, computes the JAX run's
    update of that step within 1e-3 of each var's change, so the f32
    difference is the ReLU's kink, not the port's arithmetic."""
    jmain, tmain, loss, exe, _ = _pair("resnet")
    feed = _image_batch((3, 32, 32), 4, seed=0)
    for _ in range(2):
        exe.run(jmain, feed=feed, fetch_list=[loss])
    before = _jax_state(jmain)
    exe.run(jmain, feed=feed, fetch_list=[loss])
    after = _jax_state(jmain)
    wide = tir.Program.from_dict(tmain.to_dict())
    for v in wide.global_block().vars.values():
        if v.dtype == torch.float32:
            v.dtype = torch.float64
    scope = scope_from_jax(
        {n: a.astype(np.float64) if a.dtype == np.float32 else a
         for n, a in before.items()}, Scope(), "cpu")
    feed = dict(feed, img=feed["img"].astype(np.float64))
    TExecutor("cpu").run(wide, feed=feed, fetch_list=[loss], scope=scope)
    for name, want in after.items():
        step = np.abs(want - before[name]).max()
        err = np.abs(scope.find_np(name) - want).max()
        assert err <= 1e-3 * step + 1e-7, (name, err, step)


def test_lenet_adam_trains_like_jax():
    jmain, tmain, loss, exe, state = _pair("lenet")
    scope = scope_from_jax(state, Scope(), "cpu")
    texe = TExecutor("cpu")
    feed = _image_batch((1, 28, 28), 8, seed=0)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(exe.run(jmain, feed=feed, fetch_list=[loss])[0]))
        tl.append(float(texe.run(tmain, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    want = _jax_state(jmain)
    assert "fc_w_2_moment2_Adam" in want and "conv2d_w_1_beta1pow_Adam" in want
    got = scope_to_numpy(scope, sorted(want))
    for name in want:
        if name.endswith("_Adam"):      # moments and beta powers
            np.testing.assert_allclose(
                got[name], want[name], rtol=1e-4,
                atol=1e-6 * np.abs(want[name]).max(), err_msg=name)
        else:   # 1% of the most Adam can move an element in 3 steps
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-2 * 3 * 1e-3, err_msg=name)


def test_clip_l1_and_param_learning_rate_train_like_jax():
    jmain, tmain, loss, exe, state = _pair("clipped")
    types = [op.type for op in tmain.global_block().ops]
    assert {"sign", "sum", "squared_l2_norm", "sqrt", "clip",
            "elementwise_div", "scale"} <= set(types)
    scope = scope_from_jax(state, Scope(), "cpu")
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(16, 6).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    texe = TExecutor("cpu")
    for _ in range(3):
        jl = exe.run(jmain, feed=feed, fetch_list=[loss, "slow_w@GRAD"])
        tl = texe.run(tmain, feed=feed, fetch_list=[loss, "slow_w@GRAD"],
                      scope=scope)
        for t, j in zip(tl, jl):
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    for name, want in _jax_state(jmain).items():
        np.testing.assert_allclose(scope.find_np(name), want, rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_stop_gradient_var_cuts_the_gradient():
    """The first fc's output is marked stop_gradient: its parameters get
    zero gradients (as `jax.grad` gives) and SGD leaves them as they
    were; the second fc still trains."""
    grads = {}
    for side in ("jax", "port"):
        ir, static, opt, _, _, _ = SIDES[side]
        ir.reset_unique_names()
        main, startup = ir.Program(), ir.Program()
        with ir.program_guard(main, startup):
            x = static.data("x", [4], "float32")
            h = static.fc(x, 3)
            h.stop_gradient = True
            loss = static.mean(static.fc(h, 1))
            opt.SGD(learning_rate=0.1).minimize(loss)
        grads[side] = (main, startup)
    jmain, jstart = grads["jax"]
    tmain, _ = grads["port"]
    exe = pt.Executor()
    exe.run(jstart)
    state = _jax_state(jmain)
    scope = scope_from_jax(state, Scope(), "cpu")
    feed = {"x": np.random.RandomState(0).randn(5, 4).astype(np.float32)}
    names = ["fc_w_0@GRAD", "fc_b_0@GRAD", "fc_w_1@GRAD"]
    got = TExecutor("cpu").run(tmain, feed=feed, fetch_list=names,
                               scope=scope)
    want = exe.run(jmain, feed=feed, fetch_list=names)
    np.testing.assert_array_equal(got[0], np.zeros((4, 3), np.float32))
    np.testing.assert_array_equal(got[1], np.zeros(3, np.float32))
    assert np.abs(got[2]).max() > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(scope.find_np("fc_w_0"), state["fc_w_0"])


def test_scope_holds_no_autograd_state_after_a_training_run():
    _, tmain, loss, _, state = _pair("resnet")
    scope = scope_from_jax(state, Scope(), "cpu")
    grad_mode = torch.is_grad_enabled()
    (out,) = TExecutor("cpu").run(tmain, feed=_image_batch((3, 32, 32), 4, 0),
                                  fetch_list=[loss], scope=scope,
                                  return_numpy=False)
    assert out.grad_fn is None and not out.requires_grad
    names = [v.name for v in tmain.list_vars() if v.persistable]
    assert names and all(scope.has(n) for n in names)
    for n in names:
        t = scope.get(n)
        assert t.grad_fn is None and not t.requires_grad, n
    assert torch.is_grad_enabled() == grad_mode


def test_at_most_one_autodiff_op_a_block():
    tmain, _, loss = _build("port", "fit_a_line")
    block = tmain.global_block()
    block.ops.insert(-1, next(op for op in block.ops
                              if op.type == "autodiff"))
    with pytest.raises(EnforceError, match="at most one autodiff"):
        TExecutor("cpu").run(tmain, feed={
            "x": np.zeros((2, 13), np.float32),
            "y": np.zeros((2, 1), np.float32)}, fetch_list=[loss])


def test_gradients_names_the_grad_vars():
    for side in ("jax", "port"):
        ir, static, _, _, _, _ = SIDES[side]
        ir.reset_unique_names()
        main, startup = ir.Program(), ir.Program()
        with ir.program_guard(main, startup):
            x = static.data("x", [4], "float32")
            loss = static.mean(static.fc(x, 2))
            grads = static.gradients(loss, ["fc_w_0"])
        assert [g.name for g in grads] == ["fc_w_0@GRAD"]
        ad = main.global_block().ops[-1]
        assert ad.type == "autodiff" and ad.attrs["params"] == ["fc_w_0"]


@pytest.mark.parametrize("name,split", [
    ("mnist", "train"), ("mnist", "test"), ("uci_housing", "train"),
    ("uci_housing", "test")])
def test_datasets_and_batches_equal_the_reference(name, split):
    n = 37
    tr = getattr(getattr(tdataset, name), split)(n)
    jr = getattr(getattr(jdataset, name), split)(n)
    tb = list(treader.batch(tr, 8, drop_last=False)())
    jb = list(jreader.batch(jr, 8, drop_last=False)())
    assert [len(b) for b in tb] == [len(b) for b in jb] == [8, 8, 8, 8, 5]
    for bt, bj in zip(tb, jb):
        for (xt, yt), (xj, yj) in zip(bt, bj):
            assert xt.dtype == xj.dtype and np.asarray(yt).dtype == \
                np.asarray(yj).dtype
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)


def test_reader_decorators_and_feeder_equal_the_reference():
    def src():
        return iter(range(10))

    def both(fn_name, *args):
        return (list(getattr(treader, fn_name)(*args)()),
                list(getattr(jreader, fn_name)(*args)()))

    t, j = both("map_readers", lambda a, b: a * b, src, src)
    assert t == j == [i * i for i in range(10)]
    t, j = both("buffered", src, 3)
    assert t == j == list(range(10))
    cached = treader.cache(src)
    assert list(cached()) == list(cached()) == list(range(10))
    assert sorted(treader.shuffle(src, 4)()) == list(range(10))
    assert list(treader.batch(src, 4)()) == list(jreader.batch(src, 4)())
    samples = [(np.full(3, i, np.float32), np.int64(i)) for i in range(4)]
    tvars = [tstatic.data("a", [3]), tstatic.data("b", [1], "int64")]
    jvars = [pt.static.data("a", [3]), pt.static.data("b", [1], "int64")]
    tf = tdata_feeder.DataFeeder(tvars).feed(samples)
    jf = jdata_feeder.DataFeeder(jvars).feed(samples)
    assert tf.keys() == jf.keys() == {"a", "b"}
    for k in tf:
        np.testing.assert_array_equal(tf[k], jf[k])


def test_unique_name_guard_matches_the_reference():
    for uniq, ir in ((tunique, tir), (junique, jir)):
        ir.reset_unique_names()
        assert uniq.generate("fc") == "fc_0"
        with uniq.guard():
            assert uniq.generate("fc") == "fc_0"
        assert uniq.generate("fc") == "fc_1"
        old = uniq.switch()
        assert uniq.generate("fc") == "fc_0"
        uniq.switch(old)
        assert uniq.generate("fc") == "fc_2"
