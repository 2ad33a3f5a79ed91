"""The port's pipeline engine against the JAX package's single-device
math, on the CPU (4 gloo ranks, one stage each).

* `Pipeline.loss_and_grad` under every schedule (gpipe with remat,
  1f1b, interleaved with v=2) at M ∈ {4, 5, 8}: the loss and every
  stage's gradients against `jax.grad` of the sequential composition of
  the same stages over the same microbatches (the mean of the
  microbatch losses), and the forward against the sequential forward.
  Parameters go through the JAX package's `stack_stage_params` /
  `stack_virtual_stage_params` layout and the port's
  `local_stage_params`. The JAX package's own pipeline tests are not
  the oracle: ROADMAP lists them as unreliable here.
* `PipelineOptimizer(cut_list=...)` through `PipelineCompiledProgram`
  and the port's Executor (1f1b over 4 sections, interleaved over 8
  with v=2): two SGD steps against the JAX Executor running the same
  program without the pipeline, from the same state.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as pt
import torch_parallel_ranks as R
from paddle_tpu.core import ir as jir
from paddle_tpu.parallel import (stack_stage_params,
                                 stack_virtual_stage_params)
from paddle_tpu_torch.parallel.ranks import RankPool

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_parallel_ranks.py")
S = 4
DIM = 8


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(S, backend="gloo", device="cpu",
                 store=str(tmp_path_factory.mktemp("ranks") / "store"),
                 timeout=90)
    try:
        yield p
    finally:
        p.close(kill=True)


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _oracle(per, x, tgt, M):
    def total(ps):
        h = x
        for p in ps:
            h = _stage(p, h)
        err = (h - tgt) ** 2
        return jnp.mean(jnp.mean(err.reshape(M, -1, DIM), axis=(1, 2))), h
    (loss, y), grads = jax.value_and_grad(total, has_aux=True)(per)
    return float(loss), grads, np.asarray(y)


@pytest.mark.parametrize("M", [4, 5, 8])
@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("1f1b", 1),
                                        ("interleaved", 2)])
def test_schedule_matches_jax_sequential_grad(pool, schedule, v, M):
    r = np.random.RandomState(M + 10 * v)
    per = [{"w": (r.randn(DIM, DIM) * 0.5).astype(np.float32),
            "b": (r.randn(DIM) * 0.1).astype(np.float32)}
           for _ in range(S * v)]
    x = r.randn(2 * M, DIM).astype(np.float32)
    tgt = r.randn(2 * M, DIM).astype(np.float32)
    loss, grads, y = _oracle(per, x, tgt, M)
    stacked = (stack_virtual_stage_params(per, S) if v > 1
               else stack_stage_params(per))
    stacked = jax.tree_util.tree_map(np.asarray, stacked)
    got = pool.run(RANKS, "pipeline", schedule, M, v, stacked, x, tgt)
    for stage, (l, g, yr, jax_loaded) in enumerate(got):
        assert not jax_loaded
        np.testing.assert_allclose(l, loss, rtol=1e-5)
        np.testing.assert_allclose(yr, y, rtol=1e-5, atol=1e-6)
        chunks = g if v > 1 else [g]
        for c, gc in enumerate(chunks):
            want = grads[c * S + stage]
            for k in ("w", "b"):
                np.testing.assert_allclose(gc[k], np.asarray(want[k]),
                                           rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("schedule,v,M", [("1f1b", 1, 4),
                                          ("interleaved", 2, 4)])
def test_pipeline_optimizer_through_the_executor(pool, schedule, v, M):
    main, startup, loss = R.pipeline_program(
        pt.static, jir, pt.optimizer, None, schedule, S * v, M, v)
    r = np.random.RandomState(4)
    xs = r.randn(16, DIM).astype(np.float32)
    ys = r.randn(16, DIM).astype(np.float32)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor()
        exe.run(startup)
        state = {vv.name: np.asarray(scope.get(vv.name))
                 for vv in main.list_vars()
                 if vv.persistable and scope.get(vv.name) is not None}
        want = [float(np.asarray(exe.run(main, feed={"x": xs, "y": ys},
                                         fetch_list=[loss])[0]).reshape(-1)[0])
                for _ in range(2)]
        final = {n: np.asarray(scope.get(n)) for n in state}
    got = pool.run(RANKS, "pipeline_static", state, xs, ys, schedule, M, v)
    for losses, params in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        for n, a in final.items():
            np.testing.assert_allclose(params[n], a, rtol=1e-4, atol=1e-6,
                                       err_msg=n)
