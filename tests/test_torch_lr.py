"""The LR schedulers of the port (`optimizer/lr.py`) against the JAX
package's, on the CPU.

* Each of the eight schedulers (and the staircase and Variable-rate
  forms) builds the same program in both packages, and over 12 runs
  from startup gives the same rate and the same `lr_global_step`
  (1, 2, ..., 12 — twice that for a schedule of a schedule, whose two
  counters are one var) within rtol 1e-6.
* The counter is a persistable [1] float32 var that the program's
  `increment` advances and the executor writes back every run; a
  second executor continues from the scope.
* `noam_decay` driving Adam on fit_a_line trains like the JAX package
  for 5 steps (losses, parameters and moments within rtol 1e-5).
* `weights.scope_from_jax(..., program=)` moves the counter and the
  accumulators mid-run by name: the port continues the JAX run's
  schedule and Adam state; a state without the counter is refused.
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.io import dataset as jdataset
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.weights import scope_from_jax

LR_TOL = dict(rtol=1e-6, atol=0)
RUN_TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 12
SIDES = {"jax": (jir, pt.static, pt.optimizer),
         "port": (tir, tstatic, topt)}

SCHEDULES = {
    "noam_decay": lambda s: s.noam_decay(64, 4, learning_rate=2.0),
    "exponential_decay": lambda s: s.exponential_decay(0.1, 3, 0.5),
    "exponential_decay_staircase": lambda s: s.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp_decay": lambda s: s.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_decay_staircase": lambda s: s.natural_exp_decay(
        0.1, 3, 0.5, staircase=True),
    "inverse_time_decay": lambda s: s.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_decay_staircase": lambda s: s.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    "polynomial_decay": lambda s: s.polynomial_decay(0.1, 8, 0.001,
                                                     power=2.0),
    "piecewise_decay": lambda s: s.piecewise_decay([3, 7],
                                                   [0.1, 0.05, 0.01]),
    "cosine_decay": lambda s: s.cosine_decay(0.1, 2, 6),
    "linear_lr_warmup": lambda s: s.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "linear_lr_warmup_of_a_schedule": lambda s: s.linear_lr_warmup(
        s.exponential_decay(0.1, 3, 0.5), 5, 0.0, 0.1),
}


def _build(side, case):
    ir, static, _ = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        lr = SCHEDULES[case](static)
    return main, startup, lr.name


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_jax(case):
    jmain, jstart, lr = _build("jax", case)
    tmain, tstart, tlr = _build("port", case)
    assert tlr == lr
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    incs = [op for op in tmain.global_block().ops if op.type == "increment"]
    assert [(op.inputs["X"], op.outputs["Out"]) for op in incs] == \
        [(["lr_global_step"], ["lr_global_step"])] * len(incs) and incs
    step = tmain.global_block().var("lr_global_step")
    assert step.persistable and tuple(step.shape) == (1,)

    exe = pt.Executor()
    exe.run(jstart)
    scope = Scope()
    texe = TExecutor("cpu")
    texe.run(tstart, scope=scope)
    got, want = [], []
    for _ in range(STEPS):
        want.append([np.asarray(v).reshape(-1)[0] for v in exe.run(
            jmain, fetch_list=[lr, "lr_global_step"])])
        got.append([np.asarray(v).reshape(-1)[0] for v in texe.run(
            tmain, fetch_list=[lr, "lr_global_step"], scope=scope)])
    got, want = np.array(got), np.array(want)
    # one increment a scheduler: a schedule of a schedule counts twice a
    # run, in both packages
    np.testing.assert_array_equal(got[:, 1],
                                  len(incs) * np.arange(1, STEPS + 1))
    np.testing.assert_allclose(got[:, 1], want[:, 1], **LR_TOL)
    np.testing.assert_allclose(got[:, 0], want[:, 0], **LR_TOL)
    assert scope.find_np("lr_global_step").dtype == np.float32
    # a new executor continues from the counter in the scope
    (nxt,) = TExecutor("cpu").run(tmain, fetch_list=["lr_global_step"],
                                  scope=scope)
    assert float(np.asarray(nxt).reshape(-1)[0]) == len(incs) * (STEPS + 1)


def test_schedule_rate_stays_a_tensor():
    """The rate and the counter come back as tensors of the executor's
    device when asked (no host value in the step)."""
    tmain, tstart, lr = _build("port", "piecewise_decay")
    scope = Scope()
    texe = TExecutor("cpu")
    texe.run(tstart, scope=scope)
    out = texe.run(tmain, fetch_list=[lr, "lr_global_step"], scope=scope,
                   return_numpy=False)
    assert all(t.device.type == "cpu" and t.shape == (1,) for t in out)
    assert scope.get("lr_global_step").device.type == "cpu"


def _noam_fit_a_line(side):
    ir, static, opt = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [13], "float32")
        y = static.data("y", [1], "float32")
        loss = static.mean(static.square_error_cost(static.fc(x, 1), y))
        opt.Adam(learning_rate=static.noam_decay(16, 3, 0.5)).minimize(loss)
    return main, startup, loss.name


def test_noam_decay_drives_adam_like_jax():
    jmain, jstart, loss = _noam_fit_a_line("jax")
    tmain, tstart, _ = _noam_fit_a_line("port")
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    exe = pt.Executor()
    exe.run(jstart)
    jscope = pt.global_scope()

    def state():
        return {v.name: jscope.find_np(v.name) for v in jmain.list_vars()
                if v.persistable and jscope.has(v.name)}

    scope = scope_from_jax(state(), Scope(), "cpu")
    samples = list(jdataset.uci_housing.train(32 * 5)())
    texe = TExecutor("cpu")
    for i in range(5):
        chunk = samples[32 * i:32 * (i + 1)]
        feed = {"x": np.stack([s[0] for s in chunk]),
                "y": np.stack([s[1] for s in chunk])}
        (jl,) = exe.run(jmain, feed=feed, fetch_list=[loss])
        (tl,) = texe.run(tmain, feed=feed, fetch_list=[loss], scope=scope)
        np.testing.assert_allclose(tl, jl, **RUN_TOL)
    want = state()
    assert "lr_global_step" in want and "fc_w_0_moment2_Adam" in want
    for n, w in want.items():
        np.testing.assert_allclose(scope.find_np(n), w, err_msg=n, **RUN_TOL)


def test_counter_and_accumulators_move_mid_run():
    jmain, jstart, loss = _noam_fit_a_line("jax")
    tmain, _, _ = _noam_fit_a_line("port")
    exe = pt.Executor()
    exe.run(jstart)
    jscope = pt.global_scope()
    samples = list(jdataset.uci_housing.train(32 * 3)())
    feeds = [{"x": np.stack([s[0] for s in samples[32 * i:32 * (i + 1)]]),
              "y": np.stack([s[1] for s in samples[32 * i:32 * (i + 1)]])}
             for i in range(3)]
    for feed in feeds[:2]:
        exe.run(jmain, feed=feed, fetch_list=[loss])
    state = {v.name: jscope.find_np(v.name) for v in jmain.list_vars()
             if v.persistable and jscope.has(v.name)}
    with pytest.raises(EnforceError, match="lr_global_step"):
        scope_from_jax({k: v for k, v in state.items()
                        if k != "lr_global_step"}, Scope(), "cpu",
                       program=tmain)
    scope = scope_from_jax(state, Scope(), "cpu", program=tmain)
    assert float(scope.find_np("lr_global_step")[0]) == 2.0
    (jl,) = exe.run(jmain, feed=feeds[2], fetch_list=[loss])
    (tl,) = TExecutor("cpu").run(tmain, feed=feeds[2], fetch_list=[loss],
                                 scope=scope)
    np.testing.assert_allclose(tl, jl, **RUN_TOL)
    for n in ("lr_global_step", "fc_w_0_moment1_Adam", "fc_w_0"):
        np.testing.assert_allclose(scope.find_np(n), jscope.find_np(n),
                                   err_msg=n, **RUN_TOL)
