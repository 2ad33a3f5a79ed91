"""Dygraph checkpoints, traced layers, eager AMP, the eager grad clips
and ragged batching of the port against the JAX package, on the CPU.

* `save_dygraph` / `load_dygraph`: a checkpoint written by either
  package loads in the other (the same `.npz` / `.opt.npz` files) and
  gives the same forward, bit for bit (float32 arrays round-trip
  exactly).
* `TracedLayer` (torch.export): trace, call, save, load; outputs equal
  the eager eval forward within 1e-6 of its max (the exported program
  may fuse), and the layer's mode is restored.
* `GradScaler`: the loss-scale sequence over an overflow schedule
  equals the JAX scaler's exactly (powers of two); unscaled grads 1e-7.
* `auto_cast` / `get_compute_dtype` / `cast_compute` /
  `bf16_compute_params`, the amp op lists.
* The three dygraph grad clips against the JAX ones: 1e-6 relative.
* `RaggedBatcher`, `NestedRaggedBatcher`, `flatten_nested`: every batch
  array equal to the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import dygraph_grad_clip as jclip
from paddle_tpu import nn as jnn
from paddle_tpu.io import ragged as jragged
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import dygraph_grad_clip as tclip
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.io import ragged as tragged


@pytest.fixture(autouse=True)
def _seeded():
    """Parameter draws that do not depend on which tests ran before in
    this process (both packages draw from a module-level generator)."""
    jnn.layers.seed(0)
    tnn.seed(0)


def jax_state(jl):
    params = {k: np.asarray(v) for k, v in jl.trainable_dict().items()}
    buffers = {k: np.asarray(v) for k, v in jl.state_dict().items()
               if k not in params}
    return params, buffers


def _resnets():
    from paddle_tpu.models.resnet import ResNet as JResNet
    from paddle_tpu_torch.models.resnet import ResNet
    jm = JResNet(50, num_classes=5, blocks=(1, 1), width=8)
    tm = ResNet(50, num_classes=5, blocks=(1, 1), width=8, device="cpu")
    return jm, tm


def _moved_stats(tm, seed=0):
    """Two training forwards: the batch norms' running stats move."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for _ in range(2):
            tm(torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dygraph_checkpoint_loads_in_the_other_package(tmp_path, writer):
    jm, tm = _resnets()
    path = str(tmp_path / "ckpt" / "resnet")
    x = np.random.RandomState(1).rand(2, 3, 16, 16).astype(np.float32)
    if writer == "port":
        _moved_stats(tm)
        opt = {"fc.weight_velocity": np.ones((32, 5), np.float32)}
        tnn.save_dygraph(tm.state_dict(), path)
        tnn.save_dygraph(opt, path + ".opt")
        params, opt_back = jnn.load_dygraph(path)
        jm.set_state_dict(params)
        np.testing.assert_array_equal(opt_back["fc.weight_velocity"],
                                      opt["fc.weight_velocity"])
    else:
        jnn.save_dygraph(jm.state_dict(), path)
        params, opt_back = tnn.load_dygraph(path)
        assert opt_back is None
        tm.set_state_dict(params)
    assert set(params) == set(tm.state_dict()) == set(jm.state_dict())
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            jm.state_dict()[k]), err_msg=k)
    jm.eval()
    tm.eval()
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)


def test_dygraph_round_trip_is_bit_exact(tmp_path):
    _, tm = _resnets()
    _moved_stats(tm)
    path = tnn.save_dygraph(tm.state_dict(), str(tmp_path / "m"))
    assert path.endswith("m.npz")
    _, fresh = _resnets()
    params, _ = tnn.load_dygraph(str(tmp_path / "m"))
    fresh.set_state_dict(params)
    for (k, a), b in zip(tm.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(Exception, match="no dygraph checkpoint"):
        tnn.load_dygraph(str(tmp_path / "missing"))


def test_traced_layer_round_trip(tmp_path):
    from paddle_tpu_torch.models.lenet import LeNet
    _, tm = _resnets()
    _moved_stats(tm)
    tm.train()
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 3, 16, 16)
                         .astype(np.float32))
    out, traced = tnn.TracedLayer.trace(tm, inputs=[x])
    assert tm.training, "trace must restore train mode"
    tm.eval()
    with torch.no_grad():
        want = tm(x)
    scale = float(want.abs().max())
    assert float((out - want).abs().max()) <= 1e-6 * scale
    assert float((traced([x]) - want).abs().max()) <= 1e-6 * scale
    traced.save_inference_model(str(tmp_path / "traced"))
    loaded = tnn.TracedLayer.load(str(tmp_path / "traced"))
    assert float((loaded(x) - want).abs().max()) <= 1e-6 * scale
    lenet = LeNet(device="cpu")
    img = torch.rand(3, 1, 28, 28)
    _, t2 = tnn.TracedLayer.trace(lenet, [img])
    with torch.no_grad():
        np.testing.assert_allclose(t2(img).numpy(), lenet(img).numpy(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(Exception, match="no traced model"):
        tnn.TracedLayer.load(str(tmp_path / "nothing"))


# ----------------------------------------------------------------- AMP
def test_grad_scaler_scale_sequence_matches_jax():
    schedule = [False, False, True, False, True, True, False, False, False,
                True, True, True, False, False, False, False]
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw, device="cpu")
    rng = np.random.RandomState(3)
    seq_j, seq_t = [], []
    for overflow in schedule:
        g = rng.randn(4, 3).astype(np.float32) * 100.0
        if overflow:
            g[1, 2] = np.inf
        b = rng.randn(3).astype(np.float32)
        jg, jinf = js.unscale_and_update({"w": jnp.asarray(g),
                                          "b": jnp.asarray(b)})
        tg, tinf = ts.unscale_and_update({"w": torch.from_numpy(g),
                                          "b": torch.from_numpy(b)})
        assert bool(jinf) == bool(tinf) == overflow
        for k in ("w", "b"):
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-7, atol=0)
        seq_j.append(js.loss_scaling)
        seq_t.append(ts.loss_scaling)
    assert seq_t == seq_j
    steps = np.diff(seq_t)
    assert (steps > 0).any() and (steps < 0).any(), seq_t
    assert int(ts.state["good"]) == int(js.state["good"])
    assert int(ts.state["bad"]) == int(js.state["bad"])
    loss = torch.tensor(1.5)
    assert float(ts.scale(loss)) == float(js.scale(jnp.asarray(1.5)))
    static = tamp.GradScaler(use_dynamic_loss_scaling=False, device="cpu")
    static.unscale_and_update({"w": torch.tensor([np.inf])})
    assert static.loss_scaling == 2.0 ** 15


def test_auto_cast_and_compute_dtype():
    assert tamp.get_compute_dtype() is None
    assert tamp.get_compute_dtype(torch.float32) == torch.float32
    x = torch.ones(2, 3)
    with tamp.auto_cast():
        assert tamp.get_compute_dtype() == torch.bfloat16
        assert tamp.cast_compute(x).dtype == torch.bfloat16
        assert tamp.cast_compute(torch.ones(2, dtype=torch.int64)).dtype \
            == torch.int64
        with tamp.auto_cast(dtype="float16"):
            assert tamp.get_compute_dtype() == torch.float16
        with tamp.auto_cast(enable=False):
            assert tamp.cast_compute(x).dtype == torch.float32
        assert tamp.get_compute_dtype() == torch.bfloat16
    assert tamp.cast_compute(x) is x
    with jamp.auto_cast():
        assert str(jamp.get_compute_dtype()) == "bfloat16"
    params = {"w": torch.ones(3, 4), "b": torch.ones(4),
              "ids": torch.ones(3, 4, dtype=torch.int32)}
    low = tamp.bf16_compute_params(params)
    assert low["w"].dtype == torch.bfloat16
    assert low["b"].dtype == torch.float32 and low["ids"].dtype == torch.int32
    jlow = jamp.bf16_compute_params({k: jnp.asarray(v.numpy())
                                     for k, v in params.items()})
    assert {k: str(v.dtype) for k, v in jlow.items()} == {
        k: str(v.dtype).replace("torch.", "") for k, v in low.items()}


def test_amp_lists_match_jax():
    from paddle_tpu.amp import fp16_lists as jl
    from paddle_tpu_torch.amp import fp16_lists as tl
    assert tl.WHITE_LIST == jl.WHITE_LIST
    assert tl.BLACK_LIST == jl.BLACK_LIST
    lists = tamp.AutoMixedPrecisionLists(custom_white_list=["softmax"],
                                         custom_black_list=["mul"])
    assert "softmax" in lists.white_list and "mul" in lists.black_list
    with pytest.raises(ValueError):
        tamp.AutoMixedPrecisionLists(custom_white_list=["exp"],
                                     custom_black_list=["exp"])


# ------------------------------------------------------------ grad clips
@pytest.mark.parametrize("make", [
    lambda m: m.GradClipByValue(0.3),
    lambda m: m.GradClipByValue(-0.2, 0.5),
    lambda m: m.GradClipByNorm(0.7),
    lambda m: m.GradClipByNorm(100.0),
    lambda m: m.GradClipByGlobalNorm(1.0),
    lambda m: m.GradClipByGlobalNorm(1e3),
], ids=["value", "value-range", "norm", "norm-loose", "global",
        "global-loose"])
def test_grad_clip_matches_jax(make):
    rng = np.random.RandomState(4)
    grads = [rng.randn(3, 4).astype(np.float32), None,
             rng.randn(5).astype(np.float32) * 0.1]
    want = make(jclip)([(f"p{i}", None if g is None else jnp.asarray(g))
                        for i, g in enumerate(grads)])
    got = make(tclip)([(f"p{i}", None if g is None else torch.from_numpy(g))
                       for i, g in enumerate(grads)])
    for (pw, w), (pg, g) in zip(want, got):
        assert pw == pg
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


# --------------------------------------------------------------- ragged
def _pairs_reader(seed, n=300):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            t = int(rng.randint(3, 70))
            src = rng.randint(2, 50, t).astype(np.int64)
            yield src, src[::-1].copy(), np.int64(t % 5)
    return reader


@pytest.mark.parametrize("drop_last", [False, True])
def test_ragged_batcher_equals_jax(drop_last):
    bounds = tragged.bucket_boundaries(64)
    assert bounds == jragged.bucket_boundaries(64) == [16, 32, 64]
    assert tragged.bucket_boundaries(256, num_buckets=3) == \
        jragged.bucket_boundaries(256, num_buckets=3)
    kw = dict(batch_size=8, boundaries=bounds, ragged_indices=[0, 1],
              drop_last=drop_last)
    got = list(tragged.RaggedBatcher(_pairs_reader(5), **kw)())
    want = list(jragged.RaggedBatcher(_pairs_reader(5), **kw)())
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_nested_ragged_batcher_equals_jax():
    def docs():
        rng = np.random.RandomState(6)
        for _ in range(20):
            n = int(rng.randint(0, 5))
            yield ([rng.randint(1, 9, int(rng.randint(1, 20)))
                    for _ in range(n)], np.float32(rng.rand()))
    kw = dict(batch_size=6, boundaries=[8, 16, 32])
    got = list(tragged.NestedRaggedBatcher(docs, **kw)())
    want = list(jragged.NestedRaggedBatcher(docs, **kw)())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    tokens, counts, lens = got[0][:3]
    flat, flat_lens = tragged.flatten_nested(torch.from_numpy(tokens),
                                             torch.from_numpy(lens))
    jflat, jflat_lens = jragged.flatten_nested(tokens, lens)
    np.testing.assert_array_equal(flat.numpy(), jflat)
    np.testing.assert_array_equal(flat_lens.numpy(), jflat_lens)
    back = tragged.unflatten_nested(flat, tokens.shape[0], tokens.shape[1])
    np.testing.assert_array_equal(back.numpy(), tokens)


def test_layer_state_from_jax_refuses_a_mismatch():
    jm, tm = _resnets()
    params, buffers = jax_state(jm)
    del buffers["stem_bn.mean"]
    with pytest.raises(Exception, match="buffers differ"):
        weights.layer_state_from_jax(params, buffers, tm)
    params, buffers = jax_state(jm)
    params["fc.weight"] = params["fc.weight"].T
    with pytest.raises(Exception, match="JAX shape"):
        weights.layer_state_from_jax(params, buffers, tm)
    params, buffers = jax_state(jm)
    weights.layer_state_from_jax(params, buffers, tm)
    p2, b2 = weights.layer_state_to_numpy(tm)
    for k in params:
        np.testing.assert_array_equal(p2[k], params[k])
    for k in buffers:
        np.testing.assert_array_equal(b2[k], buffers[k])
