"""Every op the static serving slice ports, against the JAX package's
registered function on the same numpy inputs (CPU).

Both sides are called through their registries: `get_op(type).fn(ctx,
*inputs)`. Tolerances, float32: elementwise and normalization ops
atol 1e-5 / rtol 1e-5; convolutions and GEMMs atol 1e-4 / rtol 1e-4
(other summation order). The int8 ops hold codes and int32 accumulators
exactly, and outputs within 4 ulps. Random ops cannot match `jax.random`
and are held to their distribution and their seeding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu.core.registry import get_op as jget_op
from paddle_tpu.slim import quant_ops as jquant
from paddle_tpu_torch.core.registry import OpContext as TCtx
from paddle_tpu_torch.core.registry import get_op as tget_op
from paddle_tpu_torch.core.registry import registered_ops
from paddle_tpu_torch.ops.kernels import quantized_matmul as tk8
from paddle_tpu_torch.slim import quant_ops as tquant

FLOAT = dict(atol=1e-5, rtol=1e-5)
GEMM = dict(atol=1e-4, rtol=1e-4)

#: the op set of the slice (ISSUE: the ResNet/LeNet training, startup,
#: inference and int8 programs), plus the Variable operators' forms
SLICE_OPS = {
    "fill_constant", "gaussian_random", "uniform_random", "relu",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "reduce_mean", "mul", "mean",
    "softmax", "top_k", "scale", "reciprocal", "pow", "conv2d", "pool2d",
    "batch_norm", "softmax_with_cross_entropy", "accuracy", "fc",
    "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max", "quantized_mul",
    "quantized_conv2d",
}


def _run_both(op_type, inputs, attrs, training=False):
    j_args = [None if a is None else jnp.asarray(a) for a in inputs]
    t_args = [None if a is None else torch.from_numpy(np.array(a))
              for a in inputs]
    jout = jget_op(op_type).fn(JCtx(dict(attrs), None, training, 0), *j_args)
    tout = tget_op(op_type).fn(TCtx(dict(attrs), None, training, 0, "cpu"),
                               *t_args)
    if not isinstance(jout, (tuple, list)):
        jout, tout = (jout,), (tout,)
    return ([np.asarray(o) for o in jout],
            [o.detach().numpy() for o in tout])


def _r(*shape, seed=0, positive=False):
    a = np.random.RandomState(seed + sum(shape)).randn(*shape).astype(
        np.float32)
    return np.abs(a) + 0.5 if positive else a


def _labels(n, classes, seed=0):
    return np.random.RandomState(seed).randint(0, classes, (n, 1)).astype(
        np.int64)


CASES = [
    # (id, op, inputs, attrs, training, tolerance)
    ("relu", "relu", [_r(3, 4, 5)], {}, False, FLOAT),
    ("reciprocal", "reciprocal", [_r(3, 4, positive=True)], {}, False, FLOAT),
    ("pow", "pow", [_r(3, 4, positive=True)], {"factor": 2.5}, False, FLOAT),
    ("add_same", "elementwise_add", [_r(2, 3, 4), _r(2, 3, 4, seed=1)],
     {"axis": -1}, False, FLOAT),
    ("add_axis1", "elementwise_add", [_r(2, 3, 4, 5), _r(3, seed=1)],
     {"axis": 1}, False, FLOAT),
    ("add_trailing", "elementwise_add", [_r(2, 6), _r(6, seed=1)],
     {"axis": -1}, False, FLOAT),
    ("fc_bias_axis", "elementwise_add", [_r(4, 10), _r(10, seed=2)],
     {"axis": 1}, False, FLOAT),
    ("sub", "elementwise_sub", [_r(2, 3), _r(2, 3, seed=1)], {}, False, FLOAT),
    ("mul", "elementwise_mul", [_r(2, 3), _r(3, seed=1)], {}, False, FLOAT),
    ("div", "elementwise_div", [_r(2, 3), _r(2, 3, seed=1, positive=True)],
     {}, False, FLOAT),
    ("pow_elem", "elementwise_pow", [_r(2, 3, positive=True),
                                     _r(2, 3, seed=1)], {}, False, FLOAT),
    ("scale_after", "scale", [_r(3, 4)], {"scale": 2.5, "bias": -1.0},
     False, FLOAT),
    ("scale_before", "scale", [_r(3, 4)],
     {"scale": 2.5, "bias": -1.0, "bias_after_scale": False}, False, FLOAT),
    ("matmul_col1", "mul", [_r(2, 3, 4), _r(12, 5, seed=1)],
     {"x_num_col_dims": 1, "y_num_col_dims": 1}, False, GEMM),
    ("matmul_col2", "mul", [_r(2, 3, 4), _r(4, 5, seed=1)],
     {"x_num_col_dims": 2, "y_num_col_dims": 1}, False, GEMM),
    ("reduce_mean_hw", "reduce_mean", [_r(2, 3, 4, 5)],
     {"dim": [2, 3], "keep_dim": False, "reduce_all": False}, False, FLOAT),
    ("reduce_mean_keep", "reduce_mean", [_r(2, 3, 4)],
     {"dim": [1], "keep_dim": True, "reduce_all": False}, False, FLOAT),
    ("reduce_mean_all", "reduce_mean", [_r(2, 3, 4)],
     {"dim": None, "keep_dim": False, "reduce_all": True}, False, FLOAT),
    ("mean", "mean", [_r(3, 7)], {}, False, FLOAT),
    ("softmax_last", "softmax", [_r(4, 10)], {"axis": -1}, False, FLOAT),
    ("softmax_axis1", "softmax", [_r(2, 5, 3)], {"axis": 1}, False, FLOAT),
    ("top_k", "top_k", [_r(5, 10)], {"k": 3}, False, FLOAT),
    ("conv_stem", "conv2d", [_r(2, 3, 16, 16), _r(8, 3, 7, 7, seed=1), None],
     {"strides": [2, 2], "paddings": [3, 3], "dilations": [1, 1],
      "groups": 1}, False, GEMM),
    ("conv_groups_bias", "conv2d",
     [_r(2, 4, 9, 9), _r(6, 2, 3, 3, seed=1), _r(6, seed=2)],
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 2}, False, GEMM),
    ("conv_dilation", "conv2d",
     [_r(1, 3, 12, 12), _r(4, 3, 3, 3, seed=1), None],
     {"strides": [1, 2], "paddings": [2, 1], "dilations": [2, 1],
      "groups": 1}, False, GEMM),
] + [
    (f"conv_fuse_{act}", "conv2d",
     [_r(2, 3, 8, 8), _r(4, 3, 3, 3, seed=1), _r(4, seed=2)],
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1, "fuse_activation": act}, False, GEMM)
    for act in ("relu", "relu6", "sigmoid", "tanh")
] + [
    ("pool_max_stem", "pool2d", [_r(2, 3, 9, 9)],
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1]}, False, FLOAT),
    ("pool_avg_exclusive", "pool2d", [_r(2, 3, 9, 9)],
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": True}, False, FLOAT),
    ("pool_avg_inclusive", "pool2d", [_r(2, 3, 9, 9)],
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": False}, False, FLOAT),
    ("pool_max_ceil", "pool2d", [_r(2, 3, 10, 10)],
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [0, 0], "ceil_mode": True}, False, FLOAT),
    ("pool_avg_ceil_exclusive", "pool2d", [_r(2, 3, 10, 11)],
     {"pooling_type": "avg", "ksize": [3, 2], "strides": [2, 2],
      "paddings": [1, 0], "ceil_mode": True, "exclusive": True},
     False, FLOAT),
    ("pool_global", "pool2d", [_r(2, 3, 5, 7)],
     {"pooling_type": "avg", "ksize": [1, 1], "global_pooling": True},
     False, FLOAT),
    ("pool_adaptive", "pool2d", [_r(2, 3, 8, 6)],
     {"pooling_type": "max", "ksize": [2, 3], "adaptive": True},
     False, FLOAT),
    ("bn_train", "batch_norm",
     [_r(4, 3, 5, 5), _r(3, seed=1), _r(3, seed=2), _r(3, seed=3),
      _r(3, seed=4, positive=True)],
     {"momentum": 0.9, "epsilon": 1e-5, "is_test": False}, True, FLOAT),
    ("bn_test", "batch_norm",
     [_r(4, 3, 5, 5), _r(3, seed=1), _r(3, seed=2), _r(3, seed=3),
      _r(3, seed=4, positive=True)],
     {"momentum": 0.9, "epsilon": 1e-5, "is_test": True}, True, FLOAT),
    ("swce_hard", "softmax_with_cross_entropy",
     [_r(6, 10), _labels(6, 10)], {"axis": -1, "ignore_index": -100},
     False, FLOAT),
    ("swce_ignore", "softmax_with_cross_entropy",
     [_r(6, 10), np.array([[1], [3], [-100], [0], [9], [-100]], np.int64)],
     {"axis": -1, "ignore_index": -100}, False, FLOAT),
    ("swce_soft", "softmax_with_cross_entropy",
     [_r(4, 5), np.full((4, 5), 0.2, np.float32)],
     {"axis": -1, "soft_label": True}, False, FLOAT),
    ("accuracy", "accuracy",
     [_r(6, 2), np.array([[3, 1], [0, 2], [4, 4], [1, 0], [2, 3], [0, 1]],
                         np.int64), _labels(6, 5)], {}, False, FLOAT),
    ("fc_bias", "fc", [_r(4, 12), _r(12, 5, seed=1), _r(5, seed=2)],
     {"in_num_col_dims": 1, "activation": ""}, False, GEMM),
    ("fc_relu_nd2", "fc", [_r(2, 3, 12), _r(12, 5, seed=1), _r(5, seed=2)],
     {"in_num_col_dims": 2, "activation": "relu"}, False, GEMM),
    ("fc_softmax", "fc", [_r(4, 12), _r(12, 5, seed=1), None],
     {"in_num_col_dims": 1, "activation": "softmax"}, False, GEMM),
    ("fake_qdq_abs_max", "fake_quantize_dequantize_abs_max", [_r(4, 6)],
     {"bit_length": 8}, False, FLOAT),
    ("fake_qdq_channel_axis0", "fake_channel_wise_quantize_dequantize_abs_max",
     [_r(4, 3, 3, 3)], {"bit_length": 8, "quant_axis": 0}, False, FLOAT),
    ("fake_qdq_channel_axis1", "fake_channel_wise_quantize_dequantize_abs_max",
     [_r(6, 5)], {"bit_length": 4, "quant_axis": 1}, False, FLOAT),
    ("fake_qdq_moving_boot", "fake_quantize_dequantize_moving_average_abs_max",
     [_r(4, 6), np.zeros(1, np.float32)],
     {"bit_length": 8, "moving_rate": 0.9}, True, FLOAT),
    ("fake_qdq_moving_update",
     "fake_quantize_dequantize_moving_average_abs_max",
     [_r(4, 6), np.array([1.7], np.float32)],
     {"bit_length": 8, "moving_rate": 0.9}, True, FLOAT),
    ("fake_qdq_moving_test",
     "fake_quantize_dequantize_moving_average_abs_max",
     [_r(4, 6), np.array([1.7], np.float32)],
     {"bit_length": 8, "moving_rate": 0.9, "is_test": True}, True, FLOAT),
]


@pytest.mark.parametrize("op_type,inputs,attrs,training,tol",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_op_matches_jax(op_type, inputs, attrs, training, tol):
    jouts, touts = _run_both(op_type, inputs, attrs, training)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert j.shape == t.shape, (j.shape, t.shape)
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("dtype,value", [("float32", 1.5), ("int64", 7),
                                         ("int32", -3)])
def test_fill_constant(dtype, value):
    attrs = {"shape": [2, 3], "value": value, "dtype": dtype}
    (j,), (t,) = _run_both("fill_constant", [], attrs)
    np.testing.assert_array_equal(t, j)
    # int64 stays int64 on the port's devices; the JAX package narrows
    # it to int32 with x64 off (core/dtypes.py of both packages)
    assert t.dtype == np.dtype(dtype)


@pytest.mark.parametrize("op_type,attrs", [
    ("gaussian_random", {"shape": [200, 300], "mean": 0.5, "std": 2.0}),
    ("uniform_random", {"shape": [200, 300], "min": -3.0, "max": 1.0}),
])
def test_random_ops_distribution_and_seeding(op_type, attrs):
    fn = tget_op(op_type).fn
    a = fn(TCtx(dict(attrs), 11, False, 3, "cpu"))
    b = fn(TCtx(dict(attrs), 11, False, 3, "cpu"))
    c = fn(TCtx(dict(attrs), 11, False, 4, "cpu"))
    fixed = fn(TCtx(dict(attrs, seed=5), 11, False, 3, "cpu"))
    fixed2 = fn(TCtx(dict(attrs, seed=5), 99, False, 8, "cpu"))
    assert a.shape == (200, 300) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(fixed, fixed2)   # a non-zero seed attr wins
    if op_type == "gaussian_random":
        assert abs(float(a.mean()) - 0.5) < 0.05
        assert abs(float(a.std()) - 2.0) < 0.05
    else:
        assert float(a.min()) >= -3.0 and float(a.max()) < 1.0
        assert abs(float(a.mean()) + 1.0) < 0.05


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("xd,shape", [(1, (4, 3, 8)), (2, (4, 3, 8)),
                                      (-1, (2, 5, 8))])
def test_quantized_mul(xd, shape):
    x = _r(*shape)
    k = 24 if xd == 1 else 8
    w_q, w_s = jquant.quantize_weight(_r(k, 6, seed=1), channel_axis=1)
    attrs = {"x_scale": float(np.abs(x).max()), "bit_length": 8,
             "x_num_col_dims": xd}
    (j,), (t,) = _run_both("quantized_mul", [x, w_q, w_s], attrs)
    assert t.shape == j.shape and t.dtype == np.float32
    assert _ulps(t, j) <= 4


@pytest.mark.parametrize("strides,pads,dilations,groups,bias", [
    ([2, 2], [3, 3], [1, 1], 1, False),
    ([1, 1], [1, 1], [1, 1], 2, True),
    ([1, 2], [2, 0], [2, 1], 1, True),
])
def test_quantized_conv2d_exact_accumulator(strides, pads, dilations, groups,
                                            bias):
    x = _r(2, 4, 11, 11)
    w_q, w_s = jquant.quantize_weight(_r(6, 4 // groups, 3, 3, seed=1),
                                      channel_axis=0)
    b = _r(6, seed=2) if bias else None
    xs = float(np.abs(x).max()) * 0.8
    attrs = {"x_scale": xs, "bit_length": 8, "strides": strides,
             "paddings": pads, "dilations": dilations, "groups": groups}
    # codes and int32 accumulator: lax.conv(preferred_element_type=int32)
    j_codes = jquant._quant_act(jnp.asarray(x), xs, 8)
    j_acc = np.asarray(lax.conv_general_dilated(
        j_codes, jnp.asarray(w_q), window_strides=tuple(strides),
        padding=[(pads[0], pads[0]), (pads[1], pads[1])],
        rhs_dilation=tuple(dilations), feature_group_count=groups,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32))
    t_codes = tk8.quantize_activation(torch.from_numpy(x), xs, 8)
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(j_codes))
    t_acc = tquant.quantized_conv2d_acc(t_codes, torch.from_numpy(w_q),
                                        tuple(strides), tuple(pads),
                                        tuple(dilations), groups)
    assert t_acc.dtype == torch.int32
    np.testing.assert_array_equal(t_acc.numpy(), j_acc)
    (j,), (t,) = _run_both("quantized_conv2d", [x, w_q, w_s, b], attrs)
    assert t.shape == j.shape
    assert _ulps(t, j) <= 4


def test_registry_holds_the_slice_ops_and_slots():
    """Every op of the slice is registered under the JAX package's op
    type with the same input and output slot names."""
    assert SLICE_OPS <= set(registered_ops())
    for op_type in SLICE_OPS:
        j, t = jget_op(op_type), tget_op(op_type)
        for js, ts in ((j.in_slots, t.in_slots), (j.out_slots, t.out_slots)):
            assert [(s.name, s.optional, s.variadic) for s in js] == \
                [(s.name, s.optional, s.variadic) for s in ts], op_type


def test_ops_run_on_meta_tensors_for_shape_inference():
    """The registry's abstract evaluation runs each non-random op of the
    slice on meta tensors, as jax.eval_shape runs the JAX ones, and
    yields the same output shapes."""
    for _, op_type, inputs, attrs, training, _ in CASES:
        metas = [None if a is None else
                 torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                             device="meta") for a in inputs]
        t = tget_op(op_type).fn(TCtx(dict(attrs), None, training, 0, "meta"),
                                *metas)
        j = jax.eval_shape(
            lambda *a: jget_op(op_type).fn(JCtx(dict(attrs), None, training,
                                                0), *a),
            *[None if a is None else jax.ShapeDtypeStruct(a.shape, a.dtype)
              for a in inputs])
        t = t if isinstance(t, (tuple, list)) else (t,)
        j = j if isinstance(j, (tuple, list)) else (j,)
        assert [tuple(o.shape) for o in t] == [tuple(o.shape) for o in j], \
            op_type
