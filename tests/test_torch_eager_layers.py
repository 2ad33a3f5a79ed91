"""The port's eager functional ops and layers against the JAX package's,
on the CPU.

Every case makes its inputs with a numpy seed, builds the JAX layer, moves
its parameters and buffers into the port's layer by name
(`weights.layer_state_from_jax`) and compares, in float32:

* the forward output, and
* the gradients of sum(out * cot) (cot uniform [0.5, 1.5), seeded) with
  respect to every parameter and every float input: `torch.autograd`
  against `jax.value_and_grad` of the JAX layer, jitted per case (eager
  JAX dispatch compiles every primitive).

Tolerance: max |port - JAX| <= 1e-5 x max |JAX| (float32 sums in a
different order). The JAX `test_eager_ext_layers_forward_and_grad` (FC
and GRUUnit run and backprop) is the oracle the extension layers widen.
NCE draws its negatives from each package's own generator, so it is held
to the reference formula on the samples it drew.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn import layers_ext


@pytest.fixture(autouse=True)
def _seeded():
    """Parameter draws that do not depend on which tests ran before in
    this process (both packages draw from a module-level generator)."""
    jnn.layers.seed(0)
    tnn.seed(0)


TOL = 1e-5


def assert_close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max err {err:.3g} of max |JAX| > {tol}"


def jax_state(jl):
    """A JAX layer's ({param: numpy}, {buffer: numpy})."""
    params = {k: np.asarray(v) for k, v in jl.trainable_dict().items()}
    buffers = {k: np.asarray(v) for k, v in jl.state_dict().items()
               if k not in params}
    return params, buffers


def pair(cls, *args, **kw):
    """The JAX and the port layer of one class, the JAX weights in both."""
    jl = getattr(jnn, cls)(*args, **kw)
    tcls = getattr(tnn, cls)
    if "device" in inspect.signature(tcls).parameters:
        kw = dict(kw, device="cpu")
    tl = tcls(*args, **kw)
    weights.layer_state_from_jax(*jax_state(jl), tl)
    return jl, tl


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def compare_layer(jl, tl, inputs, call=lambda layer, *a: layer(*a),
                  tol=TOL, seed=7):
    """Forward and gradients (parameters and float inputs) of the two
    layers on the same numpy inputs."""
    fl = [i for i, a in enumerate(inputs) if _is_float(a)]
    params = jl.trainable_dict()

    def loss(p, fargs, cot):
        jl.load_trainable(p)
        a = [jnp.asarray(x) for x in inputs]
        for i, v in zip(fl, fargs):
            a[i] = v
        out = call(jl, *a)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    # the port first: its output shape gives the cotangent's
    t_in = [torch.from_numpy(np.array(a, copy=True)) for a in inputs]
    for i in fl:
        t_in[i].requires_grad_()
    out_t = call(tl, *t_in)
    cot = np.random.RandomState(seed).uniform(
        0.5, 1.5, tuple(out_t.shape)).astype(np.float32)
    (out_t.float() * torch.from_numpy(cot)).sum().backward()
    (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        params, [jnp.asarray(inputs[i]) for i in fl], jnp.asarray(cot))
    jl.load_trainable(params)
    assert_close(out_t.detach().numpy(), out_j, tol, "forward")
    for name, p in tl.named_parameters():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        assert_close(g, gp[name], tol, f"d{name}")
    for i, g in zip(fl, gx):
        assert_close(t_in[i].grad.numpy(), g, tol, f"dinput{i}")


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- functional
CONV_CASES = [
    # (N, C, H, W, O, k, stride, pad, dilation, groups)
    (2, 4, 9, 9, 6, 3, 1, 1, 1, 1),
    (2, 4, 9, 8, 6, 3, 2, 1, 1, 2),
    (1, 6, 11, 11, 6, 3, 1, 2, 2, 3),
    (2, 3, 7, 7, 5, (3, 1), (2, 1), (1, 0), 1, 1),
]


def _pairs(v):
    return tuple(v) if isinstance(v, tuple) else (v, v)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(
    str(v) for v in c[:5]) + f"-g{c[-1]}-d{c[-2]}")
def test_conv2d(case, fmt):
    n, c, h, w, o, k, s, p, d, g = case
    kh, kw = _pairs(k)
    rng = np.random.RandomState(0)
    x = _f(rng, n, c, h, w)
    wt = _f(rng, o, c // g, kh, kw)
    b = _f(rng, o)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        wt = np.ascontiguousarray(wt.transpose(2, 3, 1, 0))
    args = (_pairs(s), _pairs(p), _pairs(d), g, fmt)
    want = jax.jit(lambda *a: jF.conv2d(*a, *args))(x, wt, b)
    got = tF.conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                    torch.from_numpy(b), *args)
    assert_close(got.numpy(), want, what="conv2d")
    if fmt == "NHWC":
        assert got.is_contiguous(), "NHWC out is a channels-last view"


@pytest.mark.parametrize("stride,pad,k", [(1, 0, 3), (2, 1, 3), (2, 0, 4),
                                          (3, 2, 5)])
def test_conv2d_transpose(stride, pad, k):
    rng = np.random.RandomState(1)
    x = _f(rng, 2, 4, 5, 6)
    w = _f(rng, 4, 3, k, k)          # IOHW
    b = _f(rng, 3)
    args = ((stride, stride), (pad, pad))
    want = jax.jit(lambda *a: jF.conv2d_transpose(*a, *args))(x, w, b)
    got = tF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), *args)
    assert got.shape[2] == (5 - 1) * stride - 2 * pad + k
    assert_close(got.numpy(), want, what="conv2d_transpose")


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind,k,s,p,glob", [
    ("max", (3, 3), (2, 2), (1, 1), False),
    ("avg", (3, 3), (2, 2), (1, 1), False),
    ("max", (2, 2), (2, 2), (0, 0), False),
    ("avg", (3, 2), (1, 2), (2, 1), False),
    ("max", None, None, (0, 0), True),
    ("avg", None, None, (0, 0), True),
], ids=["max-pad", "avg-pad", "max", "avg-pad-wide", "max-global",
        "avg-global"])
def test_pool2d(kind, k, s, p, glob, fmt):
    rng = np.random.RandomState(2)
    x = _f(rng, 2, 3, 9, 8) - 2.0       # negative values: -inf padding shows
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    k = k or (1, 1)
    want = jax.jit(lambda a: jF.pool2d(a, k, kind, s, p, glob, fmt))(x)
    got = tF.pool2d(torch.from_numpy(x), k, kind, s, p, glob, fmt)
    assert_close(got.numpy(), want, what=f"pool2d {kind}")


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_running_statistics_and_eval(fmt):
    """Two training steps move the running statistics as the JAX
    package's (momentum 0.9, biased batch variance); then the eval
    output on them."""
    rng = np.random.RandomState(3)
    shape = (4, 5, 6, 3) if fmt == "NCHW" else (4, 6, 3, 5)
    xs = [_f(rng, *shape) * 2.0 + 1.5 for _ in range(2)]
    scale, bias = _f(rng, 5), _f(rng, 5)
    jbn = jax.jit(jF.batch_norm, static_argnames=(
        "momentum", "epsilon", "training", "data_format"))
    jm, jv = np.zeros(5, np.float32), np.ones(5, np.float32)
    tm, tv = torch.zeros(5), torch.ones(5)
    for x in xs:
        jy, jm, jv = jbn(x, scale, bias, jm, jv, momentum=0.9,
                         epsilon=1e-5, training=True, data_format=fmt)
        ty, tm, tv = tF.batch_norm(torch.from_numpy(x),
                                   torch.from_numpy(scale),
                                   torch.from_numpy(bias), tm, tv, 0.9, 1e-5,
                                   True, fmt)
        assert_close(ty.numpy(), jy, what="train output")
    assert_close(tm.numpy(), jm, what="running mean")
    assert_close(tv.numpy(), jv, what="running var")
    x = _f(rng, *shape)
    jy, _, _ = jbn(x, scale, bias, jm, jv, momentum=0.9, epsilon=1e-5,
                   training=False, data_format=fmt)
    ty, _, _ = tF.batch_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), tm, tv, 0.9, 1e-5,
                             False, fmt)
    assert_close(ty.numpy(), jy, what="eval output")


@pytest.mark.parametrize("groups,shape", [(2, (2, 6, 4, 5)), (3, (3, 6, 7)),
                                          (6, (2, 6, 3, 3))])
def test_group_norm(groups, shape):
    rng = np.random.RandomState(4)
    x = _f(rng, *shape) * 3.0 + 1.0
    w, b = _f(rng, shape[1]), _f(rng, shape[1])
    want = jax.jit(lambda *a: jF.group_norm(a[0], groups, a[1], a[2]))(
        x, w, b)
    got = tF.group_norm(torch.from_numpy(x), groups, torch.from_numpy(w),
                        torch.from_numpy(b))
    assert_close(got.numpy(), want, what="group_norm")


# -------------------------------------------------------------------- layers
def _layer_cases():
    rng = np.random.RandomState(5)
    img = _f(rng, 2, 4, 8, 8)
    nhwc = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    return [
        ("Conv2D", (4, 6, 3), dict(padding=1, act="relu"), (img,)),
        ("Conv2D", (4, 6, 3), dict(stride=2, groups=2, bias_attr=False),
         (img,)),
        ("Conv2D", (4, 6, 3), dict(padding=1, data_format="NHWC"), (nhwc,)),
        ("Conv2DTranspose", (4, 3, 3), dict(stride=2, padding=1), (img,)),
        ("Pool2D", (3, "max"), dict(pool_stride=2, pool_padding=1), (img,)),
        ("Pool2D", (2, "avg"), dict(), (img,)),
        ("BatchNorm", (4,), dict(act="relu"), (img * 2.0 + 1.0,)),
        ("BatchNorm", (4,), dict(data_format="NHWC"), (nhwc,)),
        ("GroupNorm", (4, 2), dict(), (img,)),
        ("LayerNorm", (8,), dict(), (img,)),
        ("Linear", (8, 5), dict(act="tanh"), (img,)),
        ("Linear", (8, 5), dict(bias_attr=False), (img,)),
    ]


@pytest.mark.parametrize("case", _layer_cases(),
                         ids=lambda c: f"{c[0]}-{sorted(c[2])}")
def test_layer_forward_and_grad(case):
    cls, args, kw, inputs = case
    jl, tl = pair(cls, *args, **kw)
    compare_layer(jl, tl, inputs)


def test_layer_eval_mode_switches_batch_norm():
    """eval() reaches every sublayer: a Sequential's batch norm then
    uses its running statistics, moved by two training forwards."""
    rng = np.random.RandomState(6)
    jl = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1),
                        jnn.BatchNorm(4, act="relu"))
    tl = tnn.Sequential(tnn.Conv2D(3, 4, 3, padding=1, device="cpu"),
                        tnn.BatchNorm(4, act="relu", device="cpu"))
    weights.layer_state_from_jax(*jax_state(jl), tl)
    assert list(tl.state_dict()) == list(jl.state_dict())
    for _ in range(2):
        x = _f(rng, 2, 3, 6, 6)
        jl(jnp.asarray(x))                      # eager: stats move
        tl(torch.from_numpy(x))
    for name, b in tl.named_buffers():
        assert_close(b.numpy(), jl.state_dict()[name], what=name)
    jl.eval()
    tl.eval()
    assert not any(m.training for m in tl.modules())
    x = _f(rng, 2, 3, 6, 6)
    assert_close(tl(torch.from_numpy(x)).detach().numpy(),
                 jl(jnp.asarray(x)), what="eval forward")
    tl.train()
    assert all(m.training for m in tl.modules())


def test_embedding_padding_idx_zeroes_rows_and_their_gradient():
    jl, tl = pair("Embedding", [7, 3], padding_idx=2)
    ids = np.array([[0, 2, 5], [2, 2, 6]], np.int64)
    compare_layer(jl, tl, (ids,))
    with torch.no_grad():
        out = tl(torch.from_numpy(ids))
    assert float(out[0, 1].abs().sum()) == 0.0


def test_to_variable_and_layer_surface():
    x = tnn.to_variable(np.arange(6).reshape(2, 3), dtype="float32",
                        device="cpu")
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    import paddle_tpu.nn as jnn_mod
    names = [n for n in dir(jnn_mod) if not n.startswith("_")
             and n not in ("contextlib",)]
    missing = [n for n in names if not hasattr(tnn, n)]
    assert missing == [], missing
    with tnn.guard():
        with tnn.no_grad():
            assert not torch.is_grad_enabled()
    with pytest.raises(NotImplementedError, match="item 15"):
        tnn.DataParallel(tnn.Linear(2, 2, device="cpu"))


# ------------------------------------------------------------ ext layers
def _ext_cases():
    rng = np.random.RandomState(8)
    edges = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6], [0, 0]],
                      [[1, 2], [2, 3], [3, 4], [0, 0], [0, 0], [0, 0]]],
                     np.int32)
    return [
        ("FC", (12, 4), dict(act="relu"), (_f(rng, 2, 3, 4),), None),
        ("FC", (4, 5), dict(num_flatten_dims=2, bias_attr=False),
         (_f(rng, 2, 3, 4),), None),
        ("Conv3D", (4, 6, 3), dict(padding=1, act="tanh"),
         (_f(rng, 2, 4, 5, 5, 5),), None),
        ("Conv3D", (4, 6, 3), dict(stride=2, groups=2, dilation=1),
         (_f(rng, 1, 4, 6, 6, 6),), None),
        ("Conv3DTranspose", (4, 6, 3), dict(stride=2, padding=1),
         (_f(rng, 2, 4, 3, 4, 3),), None),
        ("Conv3DTranspose", (4, 6, 3), dict(groups=2),
         (_f(rng, 1, 4, 3, 3, 3),), None),
        ("BilinearTensorProduct", (4, 5, 3), dict(act="sigmoid"),
         (_f(rng, 6, 4), _f(rng, 6, 5)), None),
        ("PRelu", ("all",), dict(), (_f(rng, 2, 3, 4, 4),), None),
        ("PRelu", ("channel",), dict(channel=3), (_f(rng, 2, 3, 4, 4),),
         None),
        ("PRelu", ("element",), dict(input_shape=(2, 3, 4, 4)),
         (_f(rng, 2, 3, 4, 4),), None),
        ("GRUUnit", (12,), dict(), (_f(rng, 2, 12), _f(rng, 2, 4)),
         lambda l, x, h: l(x, h)[0]),
        ("GRUUnit", (12,), dict(origin_mode=True),
         (_f(rng, 2, 12), _f(rng, 2, 4)),
         lambda l, x, h: l(x, h)[0] + l(x, h)[2].sum()),
        ("RowConv", (5, 2), dict(act="relu"), (_f(rng, 2, 6, 5),), None),
        ("SequenceConv", (5, 4), dict(filter_size=3),
         (_f(rng, 2, 6, 5), np.array([6, 3], np.int64)), None),
        ("SpectralNorm", ((6, 4, 3),), dict(dim=0, power_iters=3), (
            _f(rng, 6, 4, 3),), None),
        ("SpectralNorm", ((6, 4, 3),), dict(dim=1), (_f(rng, 6, 4, 3),),
         None),
        ("TreeConv", (3, 2), dict(num_filters=2, max_depth=2),
         (_f(rng, 2, 6, 3), edges), None),
        ("TreeConv", (3, 2), dict(max_depth=3, act=None),
         (_f(rng, 2, 6, 3), edges), None),
    ]


@pytest.mark.parametrize("case", _ext_cases(),
                         ids=lambda c: f"{c[0]}-{sorted(c[2])}")
def test_ext_layer_forward_and_grad(case):
    cls, args, kw, inputs, call = case
    jl, tl = pair(cls, *args, **kw)
    if call is None:
        compare_layer(jl, tl, inputs)
    else:
        compare_layer(jl, tl, inputs, call)


def test_ext_layer_names_match_jax():
    for cls, args, kw, _, _ in _ext_cases():
        jl, tl = pair(cls, *args, **kw)
        assert list(tl.state_dict()) == list(jl.state_dict()), cls


def test_nce_layer_is_the_reference_formula_on_its_samples(monkeypatch):
    """NCE's cost on the negatives it drew: sigmoid logits w[s].x + b[s],
    -log(o / (o + k/V)) for the true class, -log((k/V) / (o + k/V)) for
    each negative; fresh negatives each call; gradients finite."""
    seen = []
    real = layers_ext._run_op

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(layers_ext, "_run_op", spy)
    tnn.seed(3)
    layer = tnn.NCE(20, 6, num_neg_samples=5, device="cpu")
    rng = np.random.RandomState(9)
    x = torch.from_numpy(_f(rng, 4, 6)).requires_grad_()
    label = torch.from_numpy(rng.randint(0, 20, (4, 1)))
    cost = layer(x, label)
    cost.sum().backward()
    _, logits, samples = seen[0]
    s = samples.long()
    want_logits = (layer.weight[s] * x[:, None, :]).sum(-1) + layer.bias[s]
    assert_close(logits.detach().numpy(), want_logits.detach().numpy(),
                 what="logits")
    o = torch.sigmoid(logits.detach().double())
    bq = 5 / 20
    per = torch.cat([-torch.log(o[:, :1] / (o[:, :1] + bq)),
                     -torch.log(bq / (o[:, 1:] + bq))], dim=1)
    assert_close(cost.detach().numpy(), per.sum(1, keepdim=True).numpy(),
                 what="cost")
    assert torch.isfinite(x.grad).all() and layer.weight.grad.abs().max() > 0
    layer(x, label)
    assert not torch.equal(seen[0][2], seen[1][2]), "negatives repeat"
