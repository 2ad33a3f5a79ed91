"""Static automatic mixed precision of the port against the JAX package,
on the CPU.

* `rewrite_program` and `decorate(...).minimize` build the same main and
  startup programs as the JAX package (`to_dict()` equal), for bfloat16
  and float16, with and without loss scaling, and through the two-phase
  `backward()` / `apply_gradients()` flow.
* The loss-scaling ops (`check_finite_and_unscale`,
  `update_loss_scaling`) equal the JAX ops on the same inputs, finite
  and overflowing: unscaled grads within 1e-7 relative, the flags, the
  scale and the step counts exactly.
* Three decorated Momentum steps and an overflowing fourth from the JAX
  startup state, each package's Executor: the losses and every
  parameter within 8 machine epsilons of the low dtype (bfloat16 2**-7,
  float16 2**-10) relative to its max, and the loss scale equal (halved
  by the overflow). The two packages round at other points inside the
  low-precision matmuls and sums; the worst measured is a bias, whose
  change is one low-precision sum over the batch: 2.3 eps (bf16) and
  3.1 eps (fp16).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.core import registry as jregistry
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.weights import scope_from_jax

SIDES = {"jax": (jir, pt.static, pt.optimizer, pt.amp),
         "port": (tir, tstatic, topt, tamp)}
TOL = {"bfloat16": 8 * 2.0 ** -7, "float16": 8 * 2.0 ** -10}


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


def _mlp(static):
    x = static.data("x", [-1, 8], append_batch_size=False)
    y = static.data("y", [-1, 1], append_batch_size=False)
    h = static.fc(x, 16, act="relu")
    pred = static.fc(h, 1)
    return static.mean(static.square_error_cost(pred, y))


def _build(side, how, dest, **kw):
    """(main, startup, loss name, the decorated optimizer or None)."""
    ir, static, opt, amp = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    dec = None
    with ir.program_guard(main, startup):
        loss = _mlp(static)
        if how == "rewrite":
            amp.rewrite_program(main, dest_dtype=dest)
        else:
            dec = amp.decorate(opt.Momentum(0.05, momentum=0.9),
                               dest_dtype=dest, **kw)
            if how == "minimize":
                dec.minimize(loss)
            else:
                dec.apply_gradients(dec.backward(loss), program=main)
    return main, startup, loss.name, dec


CONFIGS = [
    ("rewrite", "bfloat16", {}),
    ("rewrite", "float16", {}),
    ("minimize", "bfloat16", {}),
    ("minimize", "bfloat16", dict(init_loss_scaling=2.0 ** 7)),
    ("minimize", "float16", {}),
    ("minimize", "float16", dict(use_dynamic_loss_scaling=False,
                                 init_loss_scaling=2.0 ** 6)),
    ("two-phase", "float16", dict(init_loss_scaling=2.0 ** 6)),
]


@pytest.mark.parametrize("how,dest,kw", CONFIGS,
                         ids=[f"{h}-{d}-{sorted(k)}" for h, d, k in CONFIGS])
def test_same_programs_as_jax(how, dest, kw):
    jmain, jstart, jloss, jdec = _build("jax", how, dest, **kw)
    tmain, tstart, tloss, tdec = _build("port", how, dest, **kw)
    assert tloss == jloss
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    ops = [op.type for op in tmain.global_block().ops]
    assert "cast" in ops
    scaled = how != "rewrite" and (dest == "float16" or kw)
    assert ("check_finite_and_unscale" in ops) == bool(scaled)
    if tdec is not None:
        assert (tdec.get_loss_scaling(tmain) is None) == (not scaled)


@pytest.mark.parametrize("overflow", [False, True])
def test_loss_scaling_ops_equal_jax(overflow):
    rng = np.random.RandomState(2)
    xs = [rng.randn(3, 4).astype(np.float32) * 50,
          rng.randn(5).astype(np.float32)]
    if overflow:
        xs[1][2] = np.inf
    scale = np.array([512.0], np.float32)
    jimpl = jregistry.get_op("check_finite_and_unscale")
    timpl = tregistry.get_op("check_finite_and_unscale")
    jctx = jregistry.OpContext({}, None, True, 0)
    tctx = tregistry.OpContext({}, None, True, 0, "cpu")
    jouts, jfound = jimpl.fn(jctx, [np.asarray(x) for x in xs], scale)
    touts, tfound = timpl.fn(tctx, [torch.from_numpy(x) for x in xs],
                             torch.from_numpy(scale))
    assert tuple(tfound.shape) == (1,) and bool(tfound[0]) == overflow
    assert bool(np.asarray(jfound)[0]) == overflow
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-7)
    attrs = {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}
    for good, bad in ((0, 0), (2, 0), (0, 1), (5, 1)):
        args = (np.array([overflow]), scale, np.array([good], np.int32),
                np.array([bad], np.int32))
        want = jregistry.get_op("update_loss_scaling").fn(
            jregistry.OpContext(attrs, None, True, 0), *args)
        got = tregistry.get_op("update_loss_scaling").fn(
            tregistry.OpContext(attrs, None, True, 0, "cpu"),
            *(torch.from_numpy(a) for a in args))
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.asarray(w).shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_state(jmain):
    scope = pt.global_scope()
    return {v.name: scope.find_np(v.name) for v in jmain.list_vars()
            if v.persistable and scope.has(v.name)}


@pytest.mark.parametrize("dest", ["bfloat16", "float16"])
def test_decorated_steps_match_jax(dest):
    kw = dict(init_loss_scaling=2.0 ** 7, decr_every_n_nan_or_inf=1,
              use_dynamic_loss_scaling=True)
    jmain, jstart, loss, jdec = _build("jax", "minimize", dest, **kw)
    tmain, _, _, tdec = _build("port", "minimize", dest, **kw)
    exe = pt.Executor()
    exe.run(jstart)
    scope = scope_from_jax(_jax_state(jmain), Scope(), "cpu", program=tmain)
    texe = TExecutor("cpu")
    rng = np.random.RandomState(0)
    w = rng.randn(8, 1).astype(np.float32)
    scale_name = tdec.get_loss_scaling(tmain).name
    assert scale_name == jdec.get_loss_scaling(jmain).name
    params = [v.name for v in tmain.all_parameters()]
    for step in range(4):
        xs = rng.randn(32, 8).astype(np.float32)
        if step == 3:           # overflow: the scale halves
            xs[0, 0] = np.inf
        feed = {"x": xs, "y": xs @ w}
        jl = float(np.asarray(exe.run(jmain, feed=feed,
                                      fetch_list=[loss])[0]).ravel()[0])
        tl = float(np.asarray(texe.run(tmain, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]).ravel()[0])
        if step < 3:
            assert abs(tl - jl) <= TOL[dest] * abs(jl), (step, tl, jl)
        for p in params:
            want = pt.global_scope().find_np(p)
            err = np.abs(scope.find_np(p) - want).max()
            assert err <= TOL[dest] * np.abs(want).max(), (step, p, err)
        assert scope.find_np(scale_name)[0] == \
            pt.global_scope().find_np(scale_name)[0]
    assert scope.find_np(scale_name)[0] == 2.0 ** 6
