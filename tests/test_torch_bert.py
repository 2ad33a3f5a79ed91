"""BERT of the port against the JAX package's, on the CPU.

`BertConfig.tiny()` in float32, with the JAX model's parameters moved by
name (`weights.bert_params_from_jax`); `eval()` so dropout is off on both
sides. The pretraining loss and every parameter's gradient must match
for both attention implementations ("flash" runs the interpreted Pallas
kernels on the JAX side and the plain flash versions on the port's).
Tolerances: loss 1e-5 relative, gradients 2e-4 absolute + 2e-4 relative
(float32; a 2-layer model's gradients pass through two softmaxes and
LayerNorms summed in different orders). The Adam step is held to a
numpy restatement of `bench.py`'s update over 2 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import bert_pretrain as tpre
from paddle_tpu_torch.nn import value_and_grad

GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _models(impl, seed=0):
    cfg = dataclasses.replace(jbert.BertConfig.tiny(), attention_impl=impl)
    jnn.layers.seed(seed)
    jmodel = jbert.Bert(cfg)
    jmodel.eval()
    tcfg = tbert.BertConfig(**dataclasses.asdict(cfg))
    tmodel = tbert.Bert(tcfg, device="cpu")
    flat = {k: np.asarray(v) for k, v in jmodel.trainable_dict().items()}
    tmodel.load_state_dict(weights.bert_params_from_jax(flat))
    tmodel.eval()
    return cfg, jmodel, tmodel


def _batch(cfg, b=2, t=32, seed=0, pad_row=True):
    ids, types, attn, labels, nsp = jbert.synthetic_batch(seed, b, t, cfg)
    types[:, t // 2:] = 1
    if pad_row:
        attn[0, t - 7:] = 0          # a padding mask on one row
    return ids, types, attn, labels, nsp


def _jax_loss_and_grads(jmodel, batch, **kw):
    def loss_fn():
        return jmodel.pretrain_loss(*(jnp.asarray(a) for a in batch), **kw)
    loss, grads = jnn.value_and_grad(loss_fn, jmodel)()
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _torch_loss_and_grads(tmodel, batch, **kw):
    def loss_fn():
        return tmodel.pretrain_loss(*(torch.from_numpy(a) for a in batch), **kw)
    loss, grads = value_and_grad(loss_fn, tmodel)()
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def test_parameter_names_and_shapes_equal_the_jax_model():
    _, jmodel, tmodel = _models("xla")
    jflat = jmodel.trainable_dict()
    assert list(tmodel.trainable_dict()) == list(jflat)
    for k, v in jflat.items():
        assert tuple(tmodel.trainable_dict()[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_every_gradient_match_jax(impl):
    cfg, jmodel, tmodel = _models(impl)
    batch = _batch(cfg)
    jl, jg = _jax_loss_and_grads(jmodel, batch)
    tl, tg = _torch_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD_TOL)
    # the tied decoder: tok_emb's gradient holds both of its uses
    assert np.abs(tg["tok_emb.weight"]).sum() > 0


def test_flash_and_xla_agree_inside_the_port():
    cfg, _, tmodel = _models("xla")
    batch = _batch(cfg)
    xl, xg = _torch_loss_and_grads(tmodel, batch)
    tmodel.cfg.attention_impl = "flash"
    for layer in tmodel.layers:
        layer.attn.cfg = tmodel.cfg
    fl, fg = _torch_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(fl, xl, rtol=1e-5)
    for k in xg:
        np.testing.assert_allclose(fg[k], xg[k], err_msg=k, **GRAD_TOL)


def test_param_round_trip_is_exact():
    _, jmodel, tmodel = _models("xla", seed=4)
    back = weights.bert_params_to_numpy(tmodel)
    jflat = jmodel.trainable_dict()
    assert list(back) == list(jflat)
    for k, v in jflat.items():
        assert back[k].dtype == np.float32
        assert np.array_equal(back[k], np.asarray(v)), k
    bf = weights.bert_params_from_jax(
        {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in jflat.items()})
    assert bf["tok_emb.weight"].dtype == torch.bfloat16
    assert np.array_equal(
        bf["tok_emb.weight"].float().numpy(),
        np.asarray(jnp.asarray(jflat["tok_emb.weight"], jnp.bfloat16)
                   ).astype(np.float32))


def test_rows_with_few_masked_tokens_pick_the_same_positions():
    """Row 0 has 2 masked tokens and n_pred = 6: lax.top_k pads with the
    lowest unmasked indices at weight 0; the stable sort must pick the
    same positions, so the losses agree."""
    cfg, jmodel, tmodel = _models("xla")
    ids, types, attn, labels, nsp = _batch(cfg, pad_row=False)
    labels[0] = -100
    labels[0, [9, 3]] = [17, 23]
    batch = (ids, types, attn, labels, nsp)
    jl, jg = _jax_loss_and_grads(jmodel, batch, max_predictions=6)
    tl, tg = _torch_loss_and_grads(tmodel, batch, max_predictions=6)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg["mlm_dense.weight"],
                               jg["mlm_dense.weight"], **GRAD_TOL)
    mask = (labels >= 0).astype(np.int32)
    _, want = jax.lax.top_k(jnp.asarray(mask), 6)
    got = torch.sort(torch.from_numpy(mask), dim=1, descending=True,
                     stable=True)[1][:, :6]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flops_per_token_and_synthetic_batch_match():
    cfg = jbert.BertConfig.base()
    tcfg = tbert.BertConfig.base()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jbert.BertConfig.tiny()) == \
        dataclasses.asdict(tbert.BertConfig.tiny())
    tiny = tbert.Bert(tbert.BertConfig.tiny(), device="cpu")
    jnn.layers.seed(0)
    assert tiny.flops_per_token() == jbert.Bert(
        jbert.BertConfig.tiny()).flops_per_token()
    for a, b in zip(tbert.synthetic_batch(3, 2, 64, cfg),
                    jbert.synthetic_batch(3, 2, 64, cfg)):
        np.testing.assert_array_equal(a, b)


def _adam_numpy(master, m1, m2, grads, t, lr=1e-4, b1=0.9, b2=0.999,
                eps=1e-8):
    """bench.py:242-248 in numpy, float32."""
    out = {}
    f = np.float32
    for k in master:
        g = grads[k].astype(np.float32)
        m1[k] = f(b1) * m1[k] + f(1 - b1) * g
        m2[k] = f(b2) * m2[k] + f(1 - b2) * g * g
        mhat = m1[k] / (f(1) - f(b1) ** f(t))
        vhat = m2[k] / (f(1) - f(b2) ** f(t))
        out[k] = master[k] - f(lr) * mhat / (np.sqrt(vhat) + f(eps))
    return out


def test_adam_step_matches_numpy_restatement_over_two_steps():
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), hidden_dropout=0.0,
                              attention_dropout=0.0)
    tbert_nn_seed = 5
    from paddle_tpu_torch.nn import layers
    layers.seed(tbert_nn_seed)
    trainer = tpre.BertPretrainer(cfg, device="cpu")
    data = trainer.batch(*tbert.synthetic_batch(0, 2, 32, cfg))
    master = {k: v.numpy().copy() for k, v in trainer.master.items()}
    m1 = {k: np.zeros_like(v) for k, v in master.items()}
    m2 = {k: np.zeros_like(v) for k, v in master.items()}
    losses = []
    for t in (1, 2):
        _, grads = value_and_grad(
            lambda: trainer.model.pretrain_loss(*data), trainer.model)()
        master = _adam_numpy(master, m1, m2,
                             {k: g.numpy() for k, g in grads.items()}, t)
        losses.append(float(trainer.step(data)))
        for k, p in trainer.params.items():
            np.testing.assert_allclose(trainer.master[k].numpy(), master[k],
                                       atol=1e-7, rtol=1e-6, err_msg=k)
            assert torch.equal(p.detach(), trainer.master[k])
    assert trainer.t == 2 and all(np.isfinite(losses))


def test_bf16_trainer_casts_matrices_and_keeps_f32_master():
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), dtype="bfloat16",
                              attention_impl="flash")
    trainer = tpre.BertPretrainer(cfg, device="cpu")
    p = trainer.params
    assert p["layers.i0.attn.qkv.weight"].dtype == torch.bfloat16
    assert p["tok_emb.weight"].dtype == torch.bfloat16
    assert p["mlm_bias"].dtype == torch.bfloat16
    assert p["layers.i0.ln1.weight"].dtype == torch.float32
    assert p["layers.i0.attn.qkv.bias"].dtype == torch.float32
    assert all(m.dtype == torch.float32 for m in trainer.master.values())
    assert trainer.model.training


def test_run_trains_on_the_cpu_with_dropout_on():
    """Dropout is on (train mode): loss falls over repeated steps on one
    batch, and two runs from the same seeds give the same losses."""
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), attention_impl="flash")
    from paddle_tpu_torch.nn import layers
    layers.seed(0)
    a = tpre.run(4, 2, 32, device="cpu", cfg=cfg)
    layers.seed(0)
    b = tpre.run(4, 2, 32, device="cpu", cfg=cfg)
    assert a["loss"] == b["loss"]
    assert len(a["step_s"]) == 4 and all(np.isfinite(a["loss"]))
    assert a["loss"][-1] < a["loss"][0]


def test_layer_seeds_and_step_generator_are_deterministic():
    s1 = tbert.layer_seeds(tpre.step_generator(3), 12)
    s2 = tbert.layer_seeds(tpre.step_generator(3), 12)
    assert s1 == s2 and len(s1) == 12
    assert all(0 <= a < (1 << 23) for a, _, _ in s1)
    assert s1 != tbert.layer_seeds(tpre.step_generator(4), 12)


def test_remat_is_not_ported():
    """remat=True, which raised until it was ported, now builds and
    computes the same loss as remat=False (the gradients' equality is in
    tests/test_torch_eager_models.py)."""
    cfg = dataclasses.replace(tbert.BertConfig.tiny(), remat=True)
    model = tbert.Bert(cfg, device="cpu")
    plain = tbert.Bert(tbert.BertConfig.tiny(), device="cpu")
    plain.load_state_dict(model.state_dict())
    ids, types, attn, labels, nsp = (torch.from_numpy(a).long() for a in
                                     tbert.synthetic_batch(0, 2, 16, cfg))
    losses = [m.pretrain_loss(ids, types, attn, labels, nsp).detach()
              for m in (model, plain)]
    assert float(losses[0]) == float(losses[1])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.Bert(tbert.BertConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.BertPretrainer(tbert.BertConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.run(1, 1, 8, cfg=tbert.BertConfig.tiny())
