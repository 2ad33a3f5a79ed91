"""Dropout, resampling and the index ops' edge cases, the port against
the JAX package, on the CPU.

Dropout's masks cannot match (`jax.random` against `torch.Generator`,
and the card's generator draws other masks than the CPU's), so both
implementations are held to the op's contract instead:

* test mode: `downgrade_in_infer` gives x (1 - p), `upscale_in_train`
  gives x, in both packages exactly;
* training: the mask is 0 / 1, the output x mask (downgrade) or
  x mask / (1 - p) (upscale), the kept fraction within 5 sigma of 1 - p;
  p = 0 is the identity;
* seeding: the same run seed and op index draw the same mask, another
  op index or seed another; an Executor's runs of a program are
  reproducible from `program.random_seed`;
* the gradient is mask · dout, / (1 - p) for upscale_in_train, in both
  packages (each with its own mask).

`interpolate` / `trilinear_interp` keep `jax.image.resize`'s semantics
(half-pixel centres; a linear kernel widened, so antialiased, when it
downsamples), not `F.interpolate`'s: each mode against the JAX op on
downsampling, upsampling and mixed shapes, within 1e-5.

The index ops do not clamp in the port: an id outside the table raises
(IndexError on the CPU; a device assert on the card), where the JAX
package's `jnp.take` fills NaN rows (gather, lookup_table), wraps a
negative id, clamps (gather_nd) or drops the row (scatter). Each case's
behaviour is pinned here, and the divergence is logged in ROADMAP
Queue 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu.core.registry import get_op as jget_op
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.registry import OpContext as TCtx
from paddle_tpu_torch.core.registry import get_op as tget_op
from paddle_tpu_torch.core.scope import Scope

IMPLS = ["downgrade_in_infer", "upscale_in_train"]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).uniform(0.5, 1.5, size=shape).astype(
        np.float32)


def _port(x, attrs, seed=0, op_index=0, training=True):
    out, mask = tget_op("dropout").fn(
        TCtx(dict(attrs), seed, training, op_index, "cpu"),
        torch.from_numpy(x))
    return out.numpy(), mask.numpy()


def _jax(x, attrs, seed=0, op_index=0, training=True):
    out, mask = jget_op("dropout").fn(
        JCtx(dict(attrs), jax.random.key(seed), training, op_index),
        jnp.asarray(x))
    return np.asarray(out), np.asarray(mask)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("how", ["is_test", "not_training"])
def test_test_mode_matches_jax(impl, how):
    x = _x(4, 5)
    attrs = {"dropout_prob": 0.3, "dropout_implementation": impl,
             "is_test": how == "is_test"}
    training = how == "is_test"
    got, gm = _port(x, attrs, training=training)
    want, wm = _jax(x, attrs, training=training)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(
        got, x if impl == "upscale_in_train" else x * np.float32(0.7))


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_training_keeps_one_minus_p(side, impl, p):
    x = _x(64, 512)
    out, mask = (_port if side == "port" else _jax)(
        x, {"dropout_prob": p, "dropout_implementation": impl})
    assert set(np.unique(mask)) <= {0.0, 1.0}
    keep = 1.0 - p
    want = x * mask / np.float32(keep) if impl == "upscale_in_train" \
        else x * mask
    np.testing.assert_allclose(out, want, rtol=1e-6)
    n = mask.size
    sigma = np.sqrt(keep * p / n)
    assert abs(mask.mean() - keep) < 5 * sigma, (mask.mean(), keep, sigma)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_zero_rate_is_the_identity(side):
    x = _x(3, 7)
    out, mask = (_port if side == "port" else _jax)(
        x, {"dropout_prob": 0.0})
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(mask, np.ones_like(x))


def test_masks_follow_the_seed_and_the_op_index():
    x = _x(32, 32)
    attrs = {"dropout_prob": 0.5}
    a = _port(x, attrs, seed=3, op_index=2)[1]
    np.testing.assert_array_equal(a, _port(x, attrs, seed=3, op_index=2)[1])
    assert (a != _port(x, attrs, seed=3, op_index=1)[1]).any()
    assert (a != _port(x, attrs, seed=4, op_index=2)[1]).any()


def test_program_runs_reproduce_from_the_random_seed():
    """Two executors running the same program from the same seed draw
    the same masks run by run; successive runs draw new ones."""
    tir.reset_unique_names()
    main, startup = tir.Program(), tir.Program()
    main.random_seed = 7
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [16], "float32")
        y = tstatic.dropout(x, 0.5)
    feed = {"x": _x(8, 16)}
    runs = []
    for _ in range(2):
        exe = TExecutor("cpu")
        runs.append([exe.run(main, feed=feed, fetch_list=[y],
                             scope=Scope())[0] for _ in range(2)])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert (runs[0][0] != runs[0][1]).any()
    (infer,) = TExecutor("cpu").run(main.clone(for_test=True), feed=feed,
                                    fetch_list=[y], scope=Scope())
    np.testing.assert_allclose(infer, feed["x"] * np.float32(0.5))


@pytest.mark.parametrize("impl", IMPLS)
def test_gradient_is_the_mask_times_dout(impl):
    x = _x(8, 9)
    cot = _x(8, 9, seed=1)
    p = 0.25
    attrs = {"dropout_prob": p, "dropout_implementation": impl}
    scale = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    # the port
    xt = torch.from_numpy(x).requires_grad_()
    with torch.enable_grad():
        out, mask = tget_op("dropout").fn(TCtx(attrs, 0, True, 0, "cpu"), xt)
        (g,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), xt)
    np.testing.assert_allclose(g.numpy(), mask.numpy() * cot * scale,
                               rtol=1e-6)
    # the JAX op, with its own mask
    ctx = JCtx(attrs, jax.random.key(0), True, 0)
    _, jmask = jget_op("dropout").fn(ctx, jnp.asarray(x))
    _, vjp = jax.vjp(lambda v: jget_op("dropout").fn(ctx, v)[0],
                     jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(np.asarray(jg), np.asarray(jmask) * cot *
                               scale, rtol=1e-6)


# --- the index ops outside their range ---

X = np.arange(15, dtype=np.float32).reshape(5, 3)
ONES = np.ones((2, 3), np.float32)
NAN = [np.nan] * 3

#: op, inputs, the JAX package's result, whether the port raises
#: IndexError (else its result equals the JAX one)
INDEX_CASES = {
    "gather_past_the_end": ("gather", (X, np.array([1, 7], np.int64)),
                            [X[1].tolist(), NAN], True),
    "gather_negative": ("gather", (X, np.array([1, -1], np.int64)),
                        [X[1].tolist(), X[4].tolist()], True),
    "lookup_table_past_the_end": (
        "lookup_table", (X, np.array([[1], [5]], np.int64)),
        [X[1].tolist(), NAN], True),
    "lookup_table_v2_negative": (
        "lookup_table_v2", (X, np.array([1, -2], np.int64)),
        [X[1].tolist(), X[3].tolist()], True),
    "gather_nd_past_the_end": (
        "gather_nd", (X, np.array([[1, 2], [9, 0]], np.int64)),
        [5.0, 12.0], True),
    "scatter_past_the_end": (
        "scatter", (X, np.array([1, 8], np.int64), ONES),
        np.where(np.arange(5)[:, None] == 1, 1.0, X).tolist(), True),
    "scatter_negative": (
        "scatter", (X, np.array([1, -1], np.int64), ONES),
        np.where(np.isin(np.arange(5), [1, 4])[:, None], 1.0, X).tolist(),
        False),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_out_of_range_ids_are_pinned(case):
    op, args, jax_result, port_raises = INDEX_CASES[case]
    got = jget_op(op).fn(JCtx({}, None, True, 0),
                         *[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(np.asarray(got), np.array(jax_result,
                                                             np.float32))
    targs = [torch.from_numpy(a) for a in args]
    if port_raises:
        with pytest.raises(IndexError):
            tget_op(op).fn(TCtx({}, None, True, 0, "cpu"), *targs)
    else:
        out = tget_op(op).fn(TCtx({}, None, True, 0, "cpu"), *targs)
        np.testing.assert_array_equal(out.numpy(), np.asarray(got))


# --- resampling ---

RESIZE_CASES = {
    "bilinear_up": ("interpolate", (2, 3, 5, 4), dict(out_h=9, out_w=11,
                                                      interp_method="bilinear")),
    "bilinear_down": ("interpolate", (2, 3, 12, 10),
                      dict(out_h=5, out_w=3, interp_method="bilinear")),
    "bilinear_mixed": ("interpolate", (1, 2, 7, 8),
                       dict(out_h=3, out_w=13, interp_method="bilinear")),
    "nearest_up": ("interpolate", (2, 3, 5, 4), dict(out_h=9, out_w=11)),
    "nearest_down": ("interpolate", (2, 3, 12, 10), dict(out_h=5, out_w=3)),
    "trilinear_up": ("trilinear_interp", (1, 2, 3, 4, 5),
                     dict(out_d=5, out_h=7, out_w=6)),
    "trilinear_down": ("trilinear_interp", (1, 2, 8, 9, 6),
                       dict(out_d=3, out_h=4, out_w=6)),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_matches_jax_image(case):
    op, shape, attrs = RESIZE_CASES[case]
    x = np.random.RandomState(len(case)).randn(*shape).astype(np.float32)
    want = jget_op(op).fn(JCtx(attrs, None, True, 0), jnp.asarray(x))
    got = tget_op(op).fn(TCtx(attrs, None, True, 0, "cpu"),
                         torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if "down" in case and "bilinear" in case:
        # not F.interpolate's (unantialiased) bilinear
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x), size=(attrs["out_h"], attrs["out_w"]),
            mode="bilinear", align_corners=False)
        assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-2
