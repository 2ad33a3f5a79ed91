"""Data, tensor and expert parallelism of the port against the JAX
package, on the CPU (4 gloo ranks against a 4-device JAX mesh).

* `CompiledProgram.with_data_parallel` over dp=4: tests/test_parallel.py's
  fc + Momentum program, its per-step loss against the JAX CompiledProgram
  at rtol 1e-5 (the reference's dist-vs-local bar), from the JAX
  package's startup state; with a batch norm (moments over the global
  batch: sync_batch_norm) and a conv + BN stem; a `reduce_sum` fetch is
  the global sum; an uneven global batch raises.
* tp=4 and tp2×dp2 (Megatron shardings on the two fcs): per-step loss at
  atol 1e-5 against the JAX run; each rank stores a quarter (half) of
  w1 and the fetched w1 is the whole, equal to the JAX one.
* GradientScaleStrategy.One: the sum of the ranks' per-shard gradients.
* `ParallelExecutor` (a list of per-device feeds) and `nn.DataParallel`
  (global loss, replicated gradients) against single-process runs.
* `switch_moe` over ep=4 (each rank 2 of 8 experts) against the JAX
  `switch_moe`, forward and gradients; the static `switch_moe` with
  ep-sharded experts through CompiledProgram against the JAX run.
* No rank process has jax or paddle_tpu loaded.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
import torch_parallel_ranks as R
from paddle_tpu.core import ir as jir
from paddle_tpu.parallel import CompiledProgram as JCompiled
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch.parallel.ranks import RankPool

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_parallel_ranks.py")
WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", device="cpu",
                 store=str(tmp_path_factory.mktemp("ranks") / "store"),
                 timeout=90)
    try:
        yield p
    finally:
        p.close(kill=True)


def _batches(n, bs=32, conv=False):
    r = np.random.RandomState(7)
    dim = 3 * 8 * 8 if conv else 32
    W = r.randn(dim, 4)
    out = []
    for _ in range(n):
        xs = r.randn(bs, dim).astype(np.float32)
        ys = np.argmax(xs @ W, axis=1).reshape(-1, 1).astype(np.int64)
        out.append((xs.reshape((bs, 3, 8, 8)) if conv else xs, ys))
    return out


def _jax_fc(mesh_axes, batches, tp=False, bn=False, conv=False,
            opt="momentum", prep=None):
    """The JAX run: (startup state as numpy, per-step (loss, sum), w1);
    `prep(state)` edits the startup state in place before the steps."""
    main, startup, loss, total = R.fc_program(
        pt.static, jir, JParamAttr, tp=tp, bn=bn,
        optimizer=R.fc_optimizer(pt, opt), conv=conv)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor()
        exe.run(startup)
        state = {v.name: np.asarray(scope.get(v.name))
                 for v in main.list_vars()
                 if v.persistable and scope.get(v.name) is not None}
        if prep is not None:
            prep(state)
            for name, value in state.items():
                scope.set(name, value)
        prog = main
        if mesh_axes:
            prog = JCompiled(main).with_data_parallel(
                loss_name=loss.name,
                mesh=jmake_mesh(mesh_axes, devices=jax.devices()[:WORLD]))
        out, w1 = [], None
        for xs, ys in batches:
            lv, tv, w1 = exe.run(prog, feed={"x": xs, "y": ys},
                                 fetch_list=[loss, total, "w1"])
            out.append((float(np.asarray(lv).reshape(-1)[0]),
                        float(np.asarray(tv).reshape(-1)[0])))
    return state, out, w1


@pytest.mark.parametrize("case", ["fc", "bn", "conv_bn"])
def test_dp_loss_parity_with_jax_compiled_program(pool, case):
    bn, conv = case == "bn", case == "conv_bn"
    batches = _batches(2, conv=conv)
    state, want, w1 = _jax_fc({"dp": WORLD}, batches, bn=bn, conv=conv)
    got = pool.run(RANKS, "train_static", {"dp": WORLD}, state, batches,
                   bn=bn, conv=conv)
    for r in range(WORLD):
        losses, w1_r, shape, jax_loaded = got[r]
        assert not jax_loaded
        np.testing.assert_allclose([l for l, _ in losses],
                                   [l for l, _ in want], rtol=1e-5)
        # the reduce_sum fetch is the global batch's sum
        np.testing.assert_allclose([t for _, t in losses],
                                   [t for _, t in want], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(w1_r, w1, rtol=1e-4, atol=1e-6)


def test_dp_batch_norm_moments_are_global(pool):
    """Per-rank moments would differ: the JAX single-device run of the
    same global batch is what the dp run equals."""
    batches = _batches(2)
    state, want, _ = _jax_fc(None, batches, bn=True)
    got = pool.run(RANKS, "train_static", {"dp": WORLD}, state, batches,
                   bn=True)
    np.testing.assert_allclose([l for l, _ in got[0][0]],
                               [l for l, _ in want], rtol=1e-5)


def test_dp_uneven_batch_raises(pool):
    state, _, _ = _jax_fc(None, [])
    (xs, ys), = _batches(1, bs=30)
    msgs = pool.run(RANKS, "uneven_batch", state, xs, ys)
    assert all(m and "does not split evenly" in m for m in msgs)


@pytest.mark.parametrize("axes", [{"tp": 4}, {"dp": 2, "tp": 2}],
                         ids=["tp4", "tp2xdp2"])
def test_tp_training_parity(pool, axes):
    batches = _batches(2)
    state, want, w1 = _jax_fc(axes, batches, tp=True)
    got = pool.run(RANKS, "train_static", axes, state, batches, tp=True)
    for r in range(WORLD):
        losses, w1_r, shape, _ = got[r]
        np.testing.assert_allclose([l for l, _ in losses],
                                   [l for l, _ in want], rtol=0, atol=1e-5)
        assert shape == (32, 64 // axes["tp"])
        np.testing.assert_allclose(w1_r, w1, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("opt", ["clip", "lars", "lamb", "dpsgd"])
def test_tp_whole_parameter_norms_match_jax(pool, opt):
    """A global-norm clip, LARS, LAMB and dpsgd reduce over a whole
    parameter: under tp=2 each rank holds half of w1 and w2 (and of
    their gradients and moments), and the norms must still be the
    whole's, as in the JAX package's GSPMD program: per-step losses and
    the final w1 against the JAX CompiledProgram over the same mesh."""
    axes = {"dp": 2, "tp": 2}
    batches = _batches(3)
    state, want, w1 = _jax_fc(axes, batches, tp=True, opt=opt)
    got = pool.run(RANKS, "train_static", axes, state, batches, tp=True,
                   opt=opt)
    for r in range(WORLD):
        losses, w1_r, shape, _ = got[r]
        assert shape == (32, 32)
        np.testing.assert_allclose([l for l, _ in losses],
                                   [l for l, _ in want], rtol=0, atol=1e-5)
        np.testing.assert_allclose(w1_r, w1, rtol=1e-4, atol=1e-6)


def _overflow_on_rank0_slice(state):
    """w1 scaled by 1e-10 (with x scaled by 1e10 the activations stay as
    they were) and w2's second half of rows zeroed: the gradients of
    rank 0's slice of w1 grow 1e10-fold, rank 1's are 0, and the other
    gradients stay as they were."""
    state["w1"] = (state["w1"] * 1e-10).astype(np.float32)
    state["w2"] = state["w2"].copy()
    state["w2"][32:] = 0.0


def test_tp_amp_overflow_in_one_slice_skips_the_step_everywhere(pool):
    """Under a 1e32 loss scale only rank 0's slice of the w1 gradient
    overflows. check_finite_and_unscale must see every slice,
    as the JAX package's GSPMD program does: every rank skips the first
    step and drops the scale to 1e22, then the steps after it update:
    on one batch fed three times, the first two losses are equal. Judged
    on the slice alone, rank 1 would update the biases in step 1 and
    keep the 1e32 scale."""
    axes = {"dp": 2, "tp": 2}
    (xs, ys), = _batches(1)
    batches = [(xs * np.float32(1e10), ys)] * 3
    state, want, w1 = _jax_fc(axes, batches, tp=True, opt="amp",
                              prep=_overflow_on_rank0_slice)
    assert want[0][0] == want[1][0] and want[1][0] != want[2][0]
    got = pool.run(RANKS, "train_static", axes, state, batches, tp=True,
                   opt="amp")
    for r in range(WORLD):
        losses, w1_r, shape, _ = got[r]
        assert shape == (32, 32)
        np.testing.assert_allclose([l for l, _ in losses],
                                   [l for l, _ in want], rtol=0, atol=1e-5)
        np.testing.assert_allclose(w1_r, w1, rtol=1e-4, atol=1e-16)


def test_gradient_scale_one_sums_the_shard_gradients(pool):
    """One: each rank's per-shard mean-loss gradient summed, so one step
    moves w1 dp times as far as CoeffNumDevice's from the same state."""
    batches = _batches(1)
    state, _, _ = _jax_fc(None, [])
    coeff = pool.run(RANKS, "train_static", {"dp": WORLD}, state, batches)
    one = pool.run(RANKS, "train_static", {"dp": WORLD}, state, batches,
                   scale="one")
    w0 = state["w1"]
    np.testing.assert_allclose(one[0][1] - w0, WORLD * (coeff[0][1] - w0),
                               rtol=1e-4, atol=1e-6)


def test_dp_ops_over_the_batch_axis_match_jax(pool):
    """arg_max / arg_min / softmax / log_softmax over dim 0 and a pad
    of dim 0 read the whole batch: each equals the JAX CompiledProgram's;
    a fetch dp cannot classify raises instead of a rank's local value."""
    main, startup, outs, _ = R.axis_program(pt.static, jir, JParamAttr)
    xs = np.random.RandomState(5).randn(32, 32).astype(np.float32)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor()
        exe.run(startup)
        state = {v.name: np.asarray(scope.get(v.name))
                 for v in main.list_vars()
                 if v.persistable and scope.get(v.name) is not None}
        prog = JCompiled(main).with_data_parallel(
            mesh=jmake_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD]))
        want = [np.asarray(v) for v in exe.run(prog, feed={"x": xs},
                                               fetch_list=outs)]
    for got, msg in pool.run(RANKS, "axis_ops", state, xs):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)
        assert msg and "neither a shard nor a global value" in msg


def test_rank_pool_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA"):
        RankPool(2, backend="gloo")


def test_parallel_executor_matches_single_process(pool):
    batches = _batches(2)
    state, want, _ = _jax_fc(None, batches)
    got = pool.run(RANKS, "parallel_executor", state, batches)
    for losses, count in got:
        assert count == WORLD
        np.testing.assert_allclose(losses, [l for l, _ in want], rtol=1e-5)


def test_data_parallel_value_and_grad(pool):
    r = np.random.RandomState(3)
    params = {"weight": r.randn(6, 3).astype(np.float32),
              "bias": r.randn(3).astype(np.float32)}
    xs = r.randn(8, 6).astype(np.float32)
    ys = r.randn(8, 3).astype(np.float32)

    def f(p):
        return jnp.mean((xs @ p["weight"] + p["bias"] - ys) ** 2)
    loss, grads = jax.value_and_grad(f)(
        {k: jnp.asarray(v) for k, v in params.items()})
    got = pool.run(RANKS, "data_parallel", params, xs, ys)
    for l, g, y in got:
        np.testing.assert_allclose(l, float(loss), rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(g[k], np.asarray(grads[k]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(y, xs @ params["weight"] + params["bias"],
                                   rtol=1e-5, atol=1e-6)


def test_switch_moe_expert_parallel_matches_jax(pool):
    from paddle_tpu.parallel.moe import switch_moe as jmoe
    r = np.random.RandomState(5)
    n, d, e, h = 64, 16, 8, 32
    x = r.randn(n, d).astype(np.float32)
    gw = (r.randn(d, e) * 0.1).astype(np.float32)
    wi = (r.randn(e, d, h) * 0.1).astype(np.float32)
    wo = (r.randn(e, h, d) * 0.1).astype(np.float32)
    cot = r.randn(n, d).astype(np.float32)

    def f(*a):
        y, aux = jmoe(*a)
        return jnp.sum(y * cot) + 0.01 * aux
    y_ref, aux_ref = jmoe(x, gw, wi, wo)
    grads = jax.grad(f, argnums=(0, 1, 2, 3))(x, gw, wi, wo)
    got = pool.run(RANKS, "moe", x, gw, wi, wo, cot)
    k = e // WORLD
    for rank, (y, aux, gx, ggw, gwi, gwo) in enumerate(got):
        np.testing.assert_allclose(y, np.asarray(y_ref), atol=1e-5)
        assert abs(aux - float(aux_ref)) <= 1e-5 and aux > 0
        np.testing.assert_allclose(gx, np.asarray(grads[0]), atol=1e-5)
        np.testing.assert_allclose(ggw, np.asarray(grads[1]), atol=1e-5)
        sl = slice(rank * k, (rank + 1) * k)
        np.testing.assert_allclose(gwi, np.asarray(grads[2])[sl], atol=1e-5)
        np.testing.assert_allclose(gwo, np.asarray(grads[3])[sl], atol=1e-5)


def test_static_switch_moe_over_ep_matches_jax(pool):
    main, startup, loss = R.moe_program(pt.static, jir, pt.optimizer,
                                        JParamAttr)
    r2 = np.random.RandomState(2)
    xs = r2.rand(16, 8).astype(np.float32)
    ys = (xs @ r2.rand(8, 1)).astype(np.float32)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor()
        exe.run(startup)
        state = {v.name: np.asarray(scope.get(v.name))
                 for v in main.list_vars()
                 if v.persistable and scope.get(v.name) is not None}
        want = [float(np.asarray(exe.run(main, feed={"x": xs, "y": ys},
                                         fetch_list=[loss])[0]).reshape(-1)[0])
                for _ in range(2)]
    got = pool.run(RANKS, "moe_static", state, xs, ys, {"ep": WORLD})
    for losses in got:
        np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)


def test_bert_param_shardings_match_jax():
    from paddle_tpu.models.bert import Bert as JBert
    from paddle_tpu.models.bert import BertConfig as JConfig
    from paddle_tpu_torch.models.bert import Bert as TBert
    from paddle_tpu_torch.models.bert import BertConfig as TConfig
    want = {k: tuple(v) for k, v in
            JBert(JConfig.tiny()).param_shardings().items()}
    got = TBert(TConfig.tiny(), device="cpu").param_shardings()
    assert got == want
    assert got["layers.i0.attn.qkv.weight"] == (None, "tp")
