"""The port's eager model zoo against the JAX package's, on the CPU.

Each model is built by the JAX package, its parameters and buffers moved
into the port's model by name (`weights.layer_state_from_jax`), and both
run on the same numpy-seeded batch. Compared, in float32:

* the loss, and every parameter's gradient of one step, each within
  1e-4 x max |JAX| (relative to the largest JAX value of that tensor,
  floored at 1e-4 of the model's largest gradient: a gradient whose
  exact value is 0, such as an attention key projection's bias, is
  rounding noise on both sides);
* the vision zoo in eval mode (batch norm on its running statistics)
  as above; in training mode at batch 16 the loss within 1e-4 and the
  gradients within 2e-2 of the model's largest gradient: batch
  statistics over few samples (1 x 1 maps late in the nets at 32 x 32)
  make the f32 step ill-conditioned, and a ReLU or max-pool input
  within the forward error of a kink takes the other branch in one of
  the two (as in the static ResNet-50 step). Measured over parameter
  seeds 0-3: loss within 1.1e-5, gradients within 7.9e-3 (VGG-11); each
  package's f32 step is as far from the port's float64 step (up to
  1.7e-2), while in eval mode they agree to 2e-6;
* chained training (ResNet 2 SGD steps, DeepFM 3): each step starts from
  the JAX model's state, so an f32 difference cannot grow across steps
  (PERF.md §6);
* decoded ids: equal.

JAX's side is jitted per case. The Transformer's JAX flash path runs the
Pallas kernels in interpret mode; the port's flash path on the CPU is
the kernels' plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights

TOL = 1e-4


@pytest.fixture(autouse=True)
def _seeded():
    """Parameter draws that do not depend on which tests ran before in
    this process (both packages draw from a module-level generator)."""
    jnn.layers.seed(0)
    tnn.seed(0)


def assert_close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max err {err:.3g} of max |JAX| > {tol}"


def jax_state(jl):
    params = {k: np.asarray(v) for k, v in jl.trainable_dict().items()}
    buffers = {k: np.asarray(v) for k, v in jl.state_dict().items()
               if k not in params}
    return params, buffers


_JITTED = {}


def jax_loss_and_grads(jm, loss_fn, params, *args):
    """jitted (loss, {name: grad}) of loss_fn(model, *args) at params; the
    jitted function is kept per (model, loss_fn), so a second step of one
    model reuses its compile."""
    key = (id(jm), id(loss_fn))
    if key not in _JITTED:
        def inner(p, *a):
            jm.load_trainable(p)
            return loss_fn(jm, *a)

        # the model and loss stay referenced, so their ids stay theirs
        _JITTED[key] = (jm, loss_fn, jax.jit(jax.value_and_grad(inner)))
    out = _JITTED[key][2](params, *args)
    jm.load_trainable(params)
    return float(out[0]), {k: np.asarray(v) for k, v in out[1].items()}


def port_loss_and_grads(tm, loss_fn, *args):
    tm.zero_grad()
    loss = loss_fn(tm, *args)
    loss.backward()
    return float(loss), {k: (p.grad if p.grad is not None
                             else torch.zeros_like(p)).numpy()
                         for k, p in tm.named_parameters()}


def compare_step(jm, tm, jloss, tloss, jargs, targs, tol=TOL):
    """Load the JAX state into the port model, then compare one step's
    loss and gradients. Returns the JAX (params, grads)."""
    params = jm.trainable_dict()
    weights.layer_state_from_jax(*jax_state(jm), tm)
    lj, gj = jax_loss_and_grads(jm, jloss, params, *jargs)
    lt, gt = port_loss_and_grads(tm, tloss, *targs)
    assert abs(lt - lj) <= tol * max(abs(lj), 1e-30), (lt, lj)
    assert set(gt) == set(gj)
    floor = 1e-4 * max(float(np.abs(g).max()) for g in gj.values())
    for k in gj:
        scale = max(float(np.abs(gj[k]).max()), floor)
        err = float(np.abs(gt[k] - gj[k]).max()) / scale
        assert err <= tol, f"grad {k}: max err {err:.3g} > {tol}"
    return params, gj


def jce(logits, y):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))


def tce(logits, y):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, y[:, None].long()).mean()


def images(seed, n, c, size, classes):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c, size, size).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int32))


def _classify_case(jm, tm, x, y, fmt="NCHW"):
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    compare_step(jm, tm, lambda m, a, b: jce(m(a), b),
                 lambda m, a, b: tce(m(a), b),
                 (jnp.asarray(x), jnp.asarray(y)),
                 (torch.from_numpy(x), torch.from_numpy(y)))


def test_lenet():
    from paddle_tpu.models.lenet import LeNet as JLeNet
    from paddle_tpu_torch.models.lenet import LeNet
    x, y = images(0, 4, 1, 28, 10)
    _classify_case(JLeNet(), LeNet(device="cpu"), x, y)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet_two_sgd_steps_against_jax(fmt):
    from paddle_tpu.models.resnet import ResNet as JResNet
    from paddle_tpu_torch.models.resnet import ResNet
    jm = JResNet(50, num_classes=5, blocks=(1, 1), width=8, data_format=fmt)
    tm = ResNet(50, num_classes=5, blocks=(1, 1), width=8, data_format=fmt,
                device="cpu")
    assert list(tm.state_dict()) == list(jm.state_dict())
    x, y = images(1, 4, 3, 16, 5)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))

    def jloss(m, a, b):
        return jce(m(a), b)

    for _ in range(2):
        params, grads = compare_step(
            jm, tm, jloss, lambda m, a, b: tce(m(a), b),
            (jnp.asarray(x), jnp.asarray(y)),
            (torch.from_numpy(x), torch.from_numpy(y)))
        jm.load_trainable({k: params[k] - 0.1 * grads[k] for k in params})


def test_resnet_nhwc_equals_nchw():
    """The port's NHWC ResNet on the NCHW one's weights (filters OIHW ->
    HWIO): the same logits and loss gradient, train and eval."""
    from paddle_tpu_torch.models.resnet import ResNet
    m1 = ResNet(50, num_classes=7, blocks=(1, 1), width=8, device="cpu")
    m2 = ResNet(50, num_classes=7, blocks=(1, 1), width=8,
                data_format="NHWC", device="cpu")
    with torch.no_grad():
        for (k, p1), p2 in zip(m1.state_dict().items(),
                               m2.state_dict().values()):
            p2.copy_(p1.permute(2, 3, 1, 0) if p1.dim() == 4 else p1)
    x, y = images(2, 2, 3, 32, 7)
    xt = torch.from_numpy(x)
    for mode in ("train", "eval"):
        getattr(m1, mode)()
        getattr(m2, mode)()
        o1, o2 = m1(xt), m2(xt.permute(0, 2, 3, 1).contiguous())
        assert_close(o2.detach().numpy(), o1.detach().numpy(), 1e-5, mode)
    yt = torch.from_numpy(y)
    l1, g1 = port_loss_and_grads(m1.train(), lambda m, a: tce(m(a), yt), xt)
    l2, g2 = port_loss_and_grads(m2.train(), lambda m, a: tce(m(a), yt),
                                 xt.permute(0, 2, 3, 1).contiguous())
    assert abs(l1 - l2) <= 1e-5 * abs(l1)
    for k in g1:
        g = g2[k].transpose(3, 2, 0, 1) if g1[k].ndim == 4 else g2[k]
        assert_close(g, g1[k], TOL, k)


_JAX_ZOO = {}


@pytest.fixture(scope="module", autouse=True)
def _jax_zoo_once():
    """Each family's JAX model (its parameter draws take seconds) is
    built once a module, shared by the eval and the training test."""
    _JAX_ZOO.clear()
    yield
    _JAX_ZOO.clear()
    _JITTED.clear()


def _zoo(family):
    """(JAX model, port model) of a family; the port model is new, the
    JAX one shared (its weights are loaded into the port model before
    each comparison, and a comparison restores them)."""
    from paddle_tpu.models import vision_zoo as J
    from paddle_tpu_torch.models import vision_zoo as T
    if family not in _JAX_ZOO:
        _JAX_ZOO[family] = (
            J.VGG(11, num_classes=4, image_size=32, dropout=0.0)
            if family == "vgg11" else
            J.MobileNetV1(num_classes=4, scale=0.25)
            if family == "mobilenet_v1" else
            J.SEResNeXt(50, num_classes=4, cardinality=4, width=8))
    if family == "vgg11":
        tm = T.VGG(11, num_classes=4, image_size=32, dropout=0.0,
                   device="cpu")
    elif family == "mobilenet_v1":
        tm = T.MobileNetV1(num_classes=4, scale=0.25, device="cpu")
    else:
        tm = T.SEResNeXt(50, num_classes=4, cardinality=4, width=8,
                         device="cpu")
    return _JAX_ZOO[family], tm


@pytest.mark.parametrize("family", ["vgg11", "mobilenet_v1", "se_resnext50"])
def test_vision_zoo_eval_mode(family):
    jm, tm = _zoo(family)
    assert list(tm.state_dict()) == list(jm.state_dict())
    jm.eval()
    tm.eval()
    x, y = images(3, 4, 3, 32, 4)
    _classify_case(jm, tm, x, y)


@pytest.mark.parametrize("family", ["vgg11", "mobilenet_v1", "se_resnext50"])
def test_vision_zoo_training_step(family):
    jm, tm = _zoo(family)
    jm.train()
    x, y = images(3, 16, 3, 32, 4)
    weights.layer_state_from_jax(*jax_state(jm), tm)
    lj, gj = jax_loss_and_grads(jm, lambda m, a, b: jce(m(a), b),
                                jm.trainable_dict(), jnp.asarray(x),
                                jnp.asarray(y))
    lt, gt = port_loss_and_grads(tm, lambda m, a, b: tce(m(a), b),
                                 torch.from_numpy(x), torch.from_numpy(y))
    assert abs(lt - lj) <= TOL * abs(lj), (lt, lj)
    top = max(float(np.abs(g).max()) for g in gj.values())
    dist = max(float(np.abs(gt[k] - gj[k]).max()) for k in gj) / top
    assert dist <= 2e-2, dist


def test_deepfm_three_steps():
    from paddle_tpu.models.deepfm import DeepFM as JDeepFM
    from paddle_tpu.models.deepfm import DeepFMConfig as JCfg
    from paddle_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
    jm = JDeepFM(JCfg.tiny())
    tm = DeepFM(DeepFMConfig.tiny(), device="cpu")
    rng = np.random.RandomState(4)
    for step in range(3):
        dense = rng.randn(16, 4).astype(np.float32)
        ids = rng.randint(0, 100, (16, 8)).astype(np.int32)
        labels = rng.randint(0, 2, 16).astype(np.int32)
        params, grads = compare_step(
            jm, tm, lambda m, *a: m.loss(*a), lambda m, *a: m.loss(*a),
            tuple(jnp.asarray(a) for a in (dense, ids, labels)),
            tuple(torch.from_numpy(a) for a in (dense, ids, labels)))
        jm.load_trainable({k: params[k] - 0.5 * grads[k] for k in params})
    with torch.no_grad():
        p = tm.predict_proba(torch.from_numpy(dense), torch.from_numpy(ids))
    assert p.shape == (16,) and bool(((p > 0) & (p < 1)).all())


# ------------------------------------------------------------- Transformer
def _mt_batch(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(2, 100, (2, 16)).astype(np.int32)
    src_len = np.array([16, 9], np.int32)
    trg_in = rng.randint(2, 100, (2, 16)).astype(np.int32)
    trg_out = rng.randint(2, 100, (2, 16)).astype(np.int32)
    trg_out[1, 12:] = 0                              # padding, excluded
    return src, src_len, trg_in, trg_out


@pytest.fixture(scope="module")
def jax_transformer():
    from paddle_tpu.models.transformer import Transformer as JT
    from paddle_tpu.models.transformer import TransformerConfig as JC
    jnn.layers.seed(11)
    out = {}
    for impl in ("xla", "flash"):
        cfg = JC.tiny()
        cfg.attention_impl = impl
        out[impl] = JT(cfg)
    out["flash"].load_trainable(out["xla"].trainable_dict())
    return out


@pytest.mark.parametrize("port_impl", ["xla", "flash"])
@pytest.mark.parametrize("jax_impl", ["xla", "flash"])
def test_transformer_tiny_loss_and_grads(jax_transformer, jax_impl,
                                         port_impl):
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)
    cfg = TransformerConfig.tiny()
    cfg.attention_impl = port_impl
    tm = Transformer(cfg, device="cpu")
    jm = jax_transformer[jax_impl]
    assert list(tm.state_dict()) == list(jm.state_dict())
    batch = _mt_batch()
    compare_step(jm, tm, lambda m, *a: m.loss(*a), lambda m, *a: m.loss(*a),
                 tuple(jnp.asarray(a) for a in batch),
                 tuple(torch.from_numpy(a) for a in batch))


@pytest.mark.parametrize("port_impl", ["xla", "flash"])
def test_transformer_tiny_decodes_equal_jax(jax_transformer, port_impl):
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, host_reads, reset_host_reads)
    cfg = TransformerConfig.tiny()
    cfg.attention_impl = port_impl
    jm = jax_transformer["xla"]
    tm = Transformer(cfg, device="cpu")
    weights.layer_state_from_jax(*jax_state(jm), tm)
    src, src_len, _, _ = _mt_batch(1)
    j_src, j_len = jnp.asarray(src), jnp.asarray(src_len)
    t_src, t_len = torch.from_numpy(src), torch.from_numpy(src_len)
    want = np.asarray(jax.jit(lambda s, n: jm.greedy_decode(
        s, n, max_len=10))(j_src, j_len))
    reset_host_reads()
    got = tm.greedy_decode(t_src, t_len, max_len=10).numpy()
    np.testing.assert_array_equal(got, want)
    assert host_reads["greedy_decode"] == 10     # no row reaches eos
    jseq, jsc = jax.jit(lambda s, n: jm.beam_search_decode(
        s, n, max_len=8, beam_size=3))(j_src, j_len)
    tseq, tsc = tm.beam_search_decode(t_src, t_len, max_len=8, beam_size=3)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    assert_close(tsc.numpy(), jsc, 1e-5, "beam scores")


def test_transformer_greedy_stops_when_every_row_ends():
    """A model whose argmax is always eos: one step, then the host read
    sees every row done."""
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, host_reads, reset_host_reads)
    tm = Transformer(TransformerConfig.tiny(), device="cpu")
    with torch.no_grad():
        tm.proj.bias.zero_()
        tm.proj.bias[1] = 1e4
    reset_host_reads()
    out = tm.greedy_decode(torch.ones((2, 5), dtype=torch.int32),
                           torch.tensor([5, 3]), max_len=6)
    assert host_reads["greedy_decode"] == 2
    np.testing.assert_array_equal(out[:, 0].numpy(), [1, 1])


def test_transformer_argmax_ties_go_to_the_lower_index():
    logits = torch.tensor([[0.5, 2.0, 1.0, 2.0], [3.0, 3.0, 3.0, -1.0]])
    assert torch.argmax(logits, dim=-1).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)
                      ).tolist() == [1, 0]


def test_flash_head_dim_refused_at_construction_on_cuda(monkeypatch):
    """A flash Transformer for a CUDA device takes any head dim up to 128
    (the name is kept from when a head dim outside (32, 64, 128) was
    refused here): a D = 80 model constructs for "cuda", and its call
    reaches the kernel with D padded to 128 and the true D's sm_scale.
    The parameters are placed on the CPU and the wrapper's CUDA dispatch
    is driven through the kernel library's recording stub
    (tests/test_torch_flash_dispatch.py)."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.nn import layers
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(layers, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    monkeypatch.setattr(tfa, "_stream", lambda device: 0)

    def on_cuda(q, k, v, mask=None, causal=False, sm_scale=None, **kw):
        # flash_attention past its device check, as on a CUDA tensor
        cfg = tfa._resolve(q, sm_scale, causal, 0.0, None)
        return tfa._on_kernels(q, k, v, mask, cfg, False)[0]

    monkeypatch.setattr(T, "flash_attention", on_cuda)
    mha = T.MultiHeadAttention(160, 2, impl="flash", device="cuda")
    x = torch.zeros((2, 5, 160))
    with torch.no_grad():
        out = mha(x, x, x)
    assert out.shape == (2, 5, 160)
    (name, args), = calls
    assert name == "ptt_flash_fwd_f32"
    nptr = 6
    assert args[nptr:nptr + 5] == (2, 2, 5, 5, 128)       # B N Tq Tk D
    assert args[nptr + 6] == pytest.approx(1.0 / 80 ** 0.5)
    cfg = T.TransformerConfig.tiny()          # head dim 16, padded to 32
    cfg.attention_impl = "flash"
    T.Transformer(cfg, device="cuda")
    with pytest.raises(Exception, match="attention_impl"):
        T.MultiHeadAttention(64, 2, impl="pallas", device="cpu")
    T.Transformer(cfg, device="cpu")
    T.MultiHeadAttention(64, 4, impl="xla", device="cpu")


def test_transformer_bf16_dtype_casts_activations():
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)
    cfg = TransformerConfig.tiny()
    cfg.dtype = "bfloat16"
    tm = Transformer(cfg, device="cpu")
    src, src_len, trg_in, trg_out = (torch.from_numpy(a)
                                     for a in _mt_batch())
    enc, _ = tm.encode(src, src_len)
    assert enc.dtype == torch.bfloat16
    assert tm.proj.weight.dtype == torch.float32
    loss = tm.loss(src, src_len, trg_in, trg_out)
    loss.backward()
    assert torch.isfinite(loss) and tm.proj.weight.grad is not None


# -------------------------------------------------------------------- BERT
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bert_remat_gradients_equal_no_remat(impl):
    """remat=True recomputes each layer in the backward with the same
    dropout masks: loss and every gradient equal remat=False."""
    from paddle_tpu_torch.models.bert import Bert, BertConfig, synthetic_batch
    grads = {}
    for remat in (False, True):
        cfg = BertConfig.tiny()
        cfg.attention_impl = impl
        cfg.remat = remat
        tm = Bert(cfg, device="cpu")
        if remat:
            tm.load_state_dict(state)
        else:
            state = tm.state_dict()
        ids, types, attn, labels, nsp = (torch.from_numpy(a).long() for a in
                                         synthetic_batch(0, 2, 32, cfg))
        gen = torch.Generator().manual_seed(5)
        loss = tm.pretrain_loss(ids, types, attn, labels, nsp, rngs=gen)
        loss.backward()
        grads[remat] = (float(loss), {k: p.grad.clone()
                                      for k, p in tm.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for k, g in grads[False][1].items():
        assert torch.equal(grads[True][1][k], g), k
