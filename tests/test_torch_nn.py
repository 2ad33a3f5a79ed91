"""Eager layers, functional ops and TrainStep of the port against the JAX
package (`paddle_tpu.nn`), on the CPU.

Parameters move by flat name as numpy arrays; inputs come from a numpy
seed. Tolerances, float32: values 1e-5, gradients and two training
steps 1e-5 relative + 1e-6 absolute (the two sides sum in different
orders). Dropout cannot match `jax.random`, so it is held to keep-rate
statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import dtypes as tdt
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.utils.initializer import Constant, Normal

TOL = dict(atol=1e-6, rtol=1e-5)


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.create_parameter("scale", (4,), is_bias=True)
        self.emb = jnn.Embedding([10, 8])
        self.blocks = jnn.LayerList([jnn.Linear(8, 16, act="gelu"),
                                     jnn.Linear(16, 8)])
        self.ln = jnn.LayerNorm(8)
        self.head = jnn.Linear(8, 4)

    def forward(self, ids):
        x = self.emb(ids)
        for layer in self.blocks:
            x = layer(x)
        return self.head(self.ln(x)) + self._parameters["scale"]


class _TNet(tnn.Layer):
    def __init__(self):
        super().__init__(device="cpu")
        self.create_parameter("scale", (4,), is_bias=True)
        self.emb = tnn.Embedding([10, 8], device="cpu")
        self.blocks = tnn.LayerList([tnn.Linear(8, 16, act="gelu",
                                                device="cpu"),
                                     tnn.Linear(16, 8, device="cpu")])
        self.ln = tnn.LayerNorm(8, device="cpu")
        self.head = tnn.Linear(8, 4, device="cpu")

    def forward(self, ids):
        x = self.emb(ids)
        for layer in self.blocks:
            x = layer(x)
        return self.head(self.ln(x)) + self.scale


def _pair():
    jnn.layers.seed(3)
    jnet, tnet = _JNet(), _TNet()
    flat = {k: np.asarray(v) for k, v in jnet.trainable_dict().items()}
    tnet.load_state_dict({k: torch.from_numpy(v.copy())
                          for k, v in flat.items()})
    return jnet, tnet


def test_trainable_names_equal_the_jax_names():
    jnet, tnet = _pair()
    assert list(tnet.trainable_dict()) == list(jnet.trainable_dict())
    assert list(tnet.state_dict()) == list(jnet.state_dict())
    assert "blocks.i1.weight" in tnet.trainable_dict()
    for k, v in jnet.trainable_dict().items():
        assert tuple(tnet.trainable_dict()[k].shape) == tuple(v.shape)


def test_forward_matches_jax():
    jnet, tnet = _pair()
    ids = np.random.RandomState(0).randint(0, 10, size=(3, 5))
    want = np.asarray(jnet(jnp.asarray(ids)))
    got = tnet(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_train_and_eval_reach_every_sublayer():
    _, tnet = _pair()
    tnet.eval()
    assert not any(m.training for m in tnet.sublayers(include_self=True))
    tnet.train()
    assert all(m.training for m in tnet.sublayers(include_self=True))
    assert len(tnet.sublayers()) == 6


def test_load_trainable_assigns_by_name():
    _, tnet = _pair()
    w = torch.full((8, 4), 0.5)
    tnet.load_trainable({"head.weight": w})
    assert torch.equal(tnet.head.weight, w)
    with pytest.raises(KeyError):
        tnet.load_trainable({"head.nope": w})


@pytest.mark.parametrize("shape", [(4, 16), (2, 3, 32)])
def test_layer_norm_value_and_grad_match_jax(shape):
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * 3 + 5).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)

    def jloss(x, w, b):
        return jnp.sum(jF.layer_norm(x, w, b) * dy)

    jval = jF.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = tF.layer_norm(*ts)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jval), **TOL)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=1e-5, rtol=1e-5)


def test_layer_norm_without_affine_matches_jax():
    x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    np.testing.assert_allclose(
        tF.layer_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jF.layer_norm(jnp.asarray(x))), **TOL)


def test_layer_norm_bf16_keeps_the_input_dtype():
    x = torch.randn(4, 16).to(torch.bfloat16)
    y = tF.layer_norm(x, torch.ones(16), torch.zeros(16))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["gelu", "tanh", "relu", "sigmoid", "swish"])
def test_activations_match_jax(act):
    x = np.linspace(-4, 4, 41).astype(np.float32)
    np.testing.assert_allclose(
        tF.activation(torch.from_numpy(x), act).numpy(),
        np.asarray(jF.activation(jnp.asarray(x), act)), **TOL)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-3, 3, 13)
    tanh_form = 0.5 * x * (1 + torch.tanh(0.7978845608028654
                                          * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(tF.activation(x, "gelu"), tanh_form,
                               atol=1e-6, rtol=1e-6)
    assert not torch.allclose(tF.activation(x, "gelu"),
                              torch.nn.functional.gelu(x), atol=1e-5)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 7).astype(np.float32)
    labels = rng.randint(0, 7, size=(5,)).astype(np.int32)
    np.testing.assert_allclose(
        tF.softmax_cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels)).numpy(),
        np.asarray(jF.softmax_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels))), **TOL)


def test_add_bias_casts_to_the_activation_dtype():
    y = torch.zeros(2, 3, dtype=torch.bfloat16)
    out = tF.add_bias(y, torch.tensor([1.0, 2.0, 3.0]))
    assert out.dtype == torch.bfloat16


def _bf16_ulp(t):
    """The spacing of bfloat16 (8 significant bits) at each |t|."""
    mag = t.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def test_linear_bf16_accumulates_in_f32_and_returns_bf16():
    """A bf16 GEMM accumulates in f32 but in its own summation order, so
    an f32 sum within rounding of a bf16 midpoint may round either way:
    the result is held to one bf16 ulp of the f32-accumulated reference
    (seeded inputs). A row whose 63 small terms vanish one by one against
    1.0 in bf16 arithmetic pins the f32 accumulation itself."""
    gen = torch.Generator().manual_seed(0)
    lin = tnn.Linear(64, 8, device="cpu")
    lin.load_trainable({"weight": (0.2 * torch.randn(
        64, 8, generator=gen)).to(torch.bfloat16)})
    x = torch.randn(4, 64, generator=gen).to(torch.bfloat16)
    y = lin(x)
    assert y.dtype == torch.bfloat16
    want = (x.float() @ lin.weight.float()).to(torch.bfloat16)
    assert ((y.float() - want.float()).abs() <= _bf16_ulp(want)).all()
    lin.load_trainable({"weight": torch.ones(64, 8, dtype=torch.bfloat16)})
    row = torch.full((1, 64), 2.0 ** -9, dtype=torch.bfloat16)
    row[0, 0] = 1.0
    out = lin(row)
    assert out.dtype == torch.bfloat16
    assert (out.float() == 1.125).all(), out    # 1 + 63/512, rounded once


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(p):
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = tF.dropout(x, p, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert tF.dropout(x, p, gen, training=False) is x
    layer = tnn.Dropout(p)
    layer.eval()
    assert layer(x) is x


def test_embedding_gathers_rows():
    emb = tnn.Embedding([6, 4], device="cpu")
    out = emb(torch.tensor([[0, 2]], dtype=torch.int32))
    assert torch.equal(out[0], emb.weight[[0, 2]])


def test_initializers_and_dtypes():
    t = torch.empty(3)
    assert torch.equal(Constant(2.0).init(t), torch.full((3,), 2.0))
    n = Normal(0.0, 2.0).init(torch.empty(20000),
                              torch.Generator().manual_seed(1))
    assert abs(float(n.std()) - 2.0) < 0.05
    assert tdt.normalize_dtype("bfloat16") is torch.bfloat16
    assert tdt.dtype_name(torch.float32) == "float32"
    assert tdt.dtype_name("int32") == "int32"
    with pytest.raises(ValueError):
        tdt.normalize_dtype("complex64")


def test_value_and_grad_matches_jax():
    jnet, tnet = _pair()
    ids = np.random.RandomState(5).randint(0, 10, size=(4, 3))
    labels = np.random.RandomState(6).randint(0, 4, size=(4, 3))

    def jloss():
        return jnp.mean(jF.softmax_cross_entropy(jnet(jnp.asarray(ids)),
                                                 jnp.asarray(labels)))

    def tloss():
        return tF.softmax_cross_entropy(tnet(torch.from_numpy(ids)),
                                        torch.from_numpy(labels)).mean()

    jval, jgrads = jnn.value_and_grad(jloss, jnet)()
    tval, tgrads = tnn.value_and_grad(tloss, tnet)()
    np.testing.assert_allclose(float(tval), float(jval), **TOL)
    assert set(tgrads) == set(jgrads)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]),
                                   **TOL)
    assert set(tnn.grad(tloss, tnet)()) == set(jgrads)


def test_train_step_two_steps_match_jax():
    jnet, tnet = _pair()
    ids = np.random.RandomState(7).randint(0, 10, size=(4, 3))
    labels = np.random.RandomState(8).randint(0, 4, size=(4, 3))

    def jloss(model, ids, labels):
        return jnp.mean(jF.softmax_cross_entropy(model(ids), labels))

    def tloss(model, ids, labels):
        return tF.softmax_cross_entropy(model(ids), labels).mean()

    jstep = jnn.TrainStep(jnet, jloss, learning_rate=0.1, momentum=0.9)
    tstep = tnn.TrainStep(tnet, tloss, learning_rate=0.1, momentum=0.9)
    for _ in range(2):
        jl = jstep(jnp.asarray(ids), jnp.asarray(labels))
        tl = tstep(torch.from_numpy(ids), torch.from_numpy(labels))
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for k, v in jnet.trainable_dict().items():
        np.testing.assert_allclose(tnet.trainable_dict()[k].detach().numpy(),
                                   np.asarray(v), **TOL)
