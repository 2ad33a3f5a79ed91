"""The static layer API of the port against the JAX package's, on the
CPU.

Each case builds one small program with the same builder calls in both
packages (`static.*`, `static.nets.*`) and checks:

* the same program: op types, slot names, attrs, var names, shapes and
  dtypes (`Program.to_dict()`), main and startup;
* the same outputs: the JAX startup's weights moved into a port scope by
  name, the same numpy feed through both Executors, every fetch within
  atol / rtol 1e-5 (float32), 1e-4 where a GEMM or a convolution sums
  (other summation order).

Random layers run in test mode here (dropout's masks cannot match
jax.random; tests/test_torch_dropout.py holds them to their
distribution).
"""
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.utils.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.weights import scope_from_jax

FLOAT = dict(atol=1e-5, rtol=1e-5)
GEMM = dict(atol=1e-4, rtol=1e-4)


def _r(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed + sum(shape)).uniform(
        lo, hi, size=shape).astype(np.float32)


def _unary(s, _):
    x = s.data("x", [3, 5], "float32")
    outs = [s.relu(x), s.sigmoid(x), s.tanh(x), s.exp(x), s.square(x),
            s.abs(x), s.ceil(x), s.floor(x), s.round(x), s.softsign(x),
            s.softplus(x), s.sin(x), s.cos(x), s.erf(x), s.sign(x),
            s.logsigmoid(x), s.gelu(x), s.gelu(x, approximate=True),
            s.leaky_relu(x, 0.1), s.elu(x, 0.5), s.relu6(x), s.swish(x, 2.0),
            s.hard_sigmoid(x), s.hard_swish(x), s.softmax(x, axis=0),
            s.log_softmax(x), s.pow(x, 2.0), s.clip(x, -0.3, 0.4),
            s.scale(x, 2.0, 0.5, act="tanh"), s.cumsum(x, axis=1),
            s.cumsum(x, axis=1, exclusive=True, reverse=True)]
    y = s.data("y", [3, 5], "float32")
    outs += [s.log(y), s.sqrt(y), s.rsqrt(y), s.reciprocal(y)]
    return outs, {"x": _r(2, 3, 5) * 3, "y": _r(2, 3, 5, lo=0.5, hi=2.0)}


def _binary(s, _):
    x = s.data("x", [3, 4], "float32")
    y = s.data("y", [3, 4], "float32")
    b = s.data("b", [3], "float32", append_batch_size=False)
    outs = [s.elementwise_add(x, y), s.elementwise_sub(x, y),
            s.elementwise_mul(x, y, act="relu"), s.elementwise_div(x, y),
            s.elementwise_min(x, y), s.elementwise_max(x, y),
            s.elementwise_mod(x, y), s.elementwise_pow(s.abs(x), y),
            s.elementwise_add(x, b, axis=1), s.elementwise_mul(x, b, axis=1),
            x + y, x - 2.0, 3.0 - x, x * y, x / 4.0, 2.0 / y, x ** 2.0,
            2.0 ** x, -x]
    outs += [s.cast(c, "float32") for c in (
        s.equal(x, y), s.not_equal(x, y), s.less_than(x, y),
        s.less_equal(x, y), s.greater_than(x, y), s.greater_equal(x, y),
        s.logical_and(s.less_than(x, y), s.greater_than(x, s.zeros_like(x))),
        s.logical_or(s.less_than(x, y), s.less_than(y, x)),
        s.logical_xor(s.less_than(x, y), s.less_than(y, x)),
        s.logical_not(s.less_than(x, y)))]
    outs.append(s.cast(s.isfinite(x), "int32"))
    return outs, {"x": _r(2, 3, 4), "y": _r(2, 3, 4, lo=0.5, hi=2.0),
                  "b": _r(3, seed=5)}


def _reductions(s, _):
    x = s.data("x", [3, 4], "float32")
    pos = s.greater_than(x, s.zeros_like(x))
    outs = [s.reduce_sum(x), s.reduce_sum(x, dim=1, keep_dim=True),
            s.reduce_mean(x, dim=[1, 2]), s.reduce_max(x, dim=0),
            s.reduce_min(x, dim=-1), s.reduce_prod(x, dim=[0, 2]),
            s.mean(x), s.sum(x), s.sums([x, x, x]),
            s.cast(s.reduce_all(pos, dim=1), "float32"),
            s.cast(s.reduce_any(pos), "float32")]
    return outs, {"x": _r(2, 3, 4)}


def _matmuls(s, _):
    x = s.data("x", [3, 4], "float32", append_batch_size=False)
    y = s.data("y", [5, 4], "float32", append_batch_size=False)
    z = s.data("z", [2, 3, 4], "float32", append_batch_size=False)
    outs = [s.matmul(x, y, transpose_y=True, alpha=0.5),
            s.matmul(y, x, transpose_x=False, transpose_y=True),
            s.matmul(z, x, transpose_y=True), x @ s.transpose(y, [1, 0]),
            s.mul(z, s.transpose(y, [1, 0]), x_num_col_dims=2)]
    return outs, {"x": _r(3, 4), "y": _r(5, 4), "z": _r(2, 3, 4)}


def _tensor(s, _):
    x = s.data("x", [2, 3, 4], "float32", append_batch_size=False)
    idx = s.data("idx", [3], "int64", append_batch_size=False)
    ids = s.data("ids", [2, 2], "int64", append_batch_size=False)
    a, b = s.split(x, [1, 3], dim=-1)
    u = s.unstack(x, axis=1)
    outs = [s.reshape(x, [0, -1]), s.transpose(x, [2, 0, 1]),
            s.concat([x, x], axis=1), a, b] + u + [
        s.stack([x, x], axis=0), s.squeeze(s.unsqueeze(x, [0, 3]), [0]),
        s.slice(x, [1, 2], [0, 1], [2, 3]),
        s.strided_slice(x, [2], [3], [0], [-2]),
        x[:, 1:, ::2], x[0, ..., None],
        s.gather(s.reshape(x, [2, 12]), s.assign(np.array([1, 0],
                                                          np.int64))),
        s.gather(s.reshape(x, [6, 4]), idx),
        s.gather_nd(x, ids), s.expand(x, [1, 2, 1]),
        s.expand_as(s.slice(x, [0], [0], [1]), x),
        s.pad(x, [0, 1, 1, 0, 0, 2], pad_value=0.5),
        s.pad2d(s.reshape(x, [1, 2, 3, 4]), [1, 0, 2, 1], mode="reflect"),
        s.pad2d(s.reshape(x, [1, 2, 3, 4]), [1, 1, 0, 1], mode="edge"),
        s.flatten(x, axis=2),
        s.scatter(s.reshape(x, [6, 4]), idx,
                  s.fill_constant([3, 4], "float32", 2.0)),
        s.scatter(s.reshape(x, [6, 4]), idx,
                  s.fill_constant([3, 4], "float32", 2.0), overwrite=False),
        s.where(s.greater_than(x, s.zeros_like(x)), x, s.ones_like(x)),
        s.cast(s.where(s.greater_than(x, s.zeros_like(x))), "float32"),
        s.cast(s.shape(x), "float32"), s.one_hot(ids, 5),
        s.cast(s.argmax(x, axis=1), "float32"),
        s.cast(s.argmin(x), "float32")]
    vals, order = s.argsort(x, axis=2, descending=True)
    tv, ti = s.topk(x, 2)
    outs += [vals, s.cast(order, "float32"), tv, s.cast(ti, "float32"),
             s.range(0, 6, 2, "int64"), s.linspace(0.0, 1.0, 5),
             s.zeros([2, 3]), s.ones([2], "int32"), s.eye(3, 4),
             s.diag(s.assign(np.array([1.0, 2.0], np.float32))),
             s.fill_constant_batch_size_like(x, [1, 3], "float32", 7.0),
             s.increment(s.fill_constant([1], "float32", 1.0), 2.0,
                         in_place=False)]
    return outs, {"x": _r(2, 3, 4),
                  "idx": np.array([4, 0, 2], np.int64),
                  "ids": np.array([[0, 1], [1, 2]], np.int64)}


def _losses(s, _):
    x = s.data("x", [4], "float32")
    y = s.data("y", [4], "float32")
    lbl = s.data("lbl", [1], "int64")
    prob = s.softmax(x)
    outs = [s.cross_entropy(prob, lbl),
            s.cross_entropy(prob, s.softmax(y), soft_label=True),
            s.softmax_with_cross_entropy(x, lbl),
            s.sigmoid_cross_entropy_with_logits(x, s.sigmoid(y)),
            s.square_error_cost(x, y), s.smooth_l1(x, y, sigma=2.0),
            s.huber_loss(x, y, delta=0.5),
            s.kldiv_loss(s.log_softmax(x), prob, reduction="batchmean"),
            s.mse_loss(x, y), s.label_smooth(s.one_hot(lbl, 4)),
            s.accuracy(prob, lbl, k=2)]
    return outs, {"x": _r(3, 4), "y": _r(3, 4, seed=1),
                  "lbl": np.array([[0], [3], [1]], np.int64)}


def _metrics(s, _):
    p = s.data("p", [2], "float32")
    lbl = s.data("lbl", [1], "int64")
    auc, _ = s.auc(s.softmax(p), lbl, num_thresholds=63)
    return [auc], {"p": _r(16, 2) * 3,
                   "lbl": (np.arange(16) % 3 == 0).astype(np.int64)
                   .reshape(-1, 1)}


def _layers(s, pa):
    img = s.data("img", [4, 6, 6], "float32")
    ids = s.data("ids", [1], "int64")
    emb = s.embedding(ids, size=[10, 3], padding_idx=-1,
                      param_attr=pa(name="emb_w"))
    c = s.conv2d_transpose(img, 3, 3, stride=2, padding=1, act="relu")
    outs = [emb, s.embedding(ids, size=[10, 3], param_attr=pa(name="emb_w")),
            c, s.adaptive_pool2d(img, 3, pool_type="max"),
            s.adaptive_pool2d(img, [2, 3]),
            s.layer_norm(img, begin_norm_axis=2, act="tanh"),
            s.group_norm(img, 2), s.prelu(img), s.prelu(img, mode="channel"),
            s.dropout(img, 0.3, is_test=True),
            s.dropout(img, 0.3, is_test=True,
                      dropout_implementation="upscale_in_train")]
    return outs, {"img": _r(2, 4, 6, 6),
                  "ids": np.array([[3], [9], [0]], np.int64)}


def _nets(s, _):
    img = s.data("img", [3, 8, 8], "float32")
    seq = s.data("seq", [5, 8], "float32")
    outs = [s.nets.simple_img_conv_pool(img, 4, 3, 2, 2, act="relu"),
            s.nets.img_conv_group(img, [4, 4], 2, conv_act="relu",
                                  conv_with_batchnorm=True,
                                  conv_batchnorm_drop_rate=[0.0, 0.0],
                                  pool_stride=2),
            s.nets.img_conv_group(img, 2, 2, conv_with_batchnorm=False),
            s.nets.glu(seq, dim=-1),
            s.nets.scaled_dot_product_attention(seq, seq, seq,
                                                num_heads=2)]
    return outs, {"img": _r(2, 3, 8, 8), "seq": _r(2, 5, 8)}


CASES = {"unary": (_unary, FLOAT), "binary": (_binary, FLOAT),
         "reductions": (_reductions, FLOAT), "matmuls": (_matmuls, GEMM),
         "tensor": (_tensor, FLOAT), "losses": (_losses, FLOAT),
         "metrics": (_metrics, FLOAT), "layers": (_layers, GEMM),
         "nets": (_nets, GEMM)}

SIDES = {"jax": (jir, pt.static, JParamAttr),
         "port": (tir, tstatic, TParamAttr)}


def _build(side, case):
    ir, static, pa = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        outs, feed = CASES[case][0](static, pa)
    return main, startup, [o.name for o in outs], feed


@pytest.mark.parametrize("case", sorted(CASES))
def test_builders_match_jax(case):
    jmain, jstart, names, feed = _build("jax", case)
    tmain, tstart, tnames, _ = _build("port", case)
    assert tnames == names
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    exe = pt.Executor()
    exe.run(jstart)
    scope = pt.global_scope()
    state = {v.name: scope.find_np(v.name) for v in jmain.list_vars()
             if v.persistable and scope.has(v.name)}
    tscope = scope_from_jax(state, Scope(), "cpu")
    want = exe.run(jmain, feed=feed, fetch_list=names)
    got = TExecutor("cpu").run(tmain, feed=feed, fetch_list=names,
                               scope=tscope)
    tol = CASES[case][1]
    for n, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), err_msg=n, **tol)
