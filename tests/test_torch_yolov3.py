"""YOLOv3 in the port against the JAX package's, on the CPU.

`YoloConfig.tiny()` (4 classes, DarkNet widths x 1/16, one block a
stage) at 1 x 32^2, which still gives the three scales (1^2, 2^2 and
4^2 cells); the JAX model's parameters and batch-norm statistics
carried into the port by name (`weights.layer_state_from_jax`), the
same numpy-seeded images and ground truth (4 boxes and 2 zero rows of
padding) through both, the JAX side jitted once a test. Compared:

* eval mode: the three heads within 1e-5 of each one's max |JAX|, and
  `predict`'s [1, 100, 6] (yolo_box + multiclass_nms): classes and row
  order equal, values within 1e-5 of the max |JAX|;
* training mode: the loss within rtol 1e-5 and every parameter's
  gradient against `jax.grad` within 5e-4 of its tensor's max |JAX|,
  floored at 1e-4 of the model's largest gradient. At batch 1 the
  deepest batch norms see 1 or 4 values, which makes the f32 step
  ill-conditioned: measured over parameter seeds 0-2, the loss within
  7e-7 and the gradients within 1.2e-4 (a stage-1 filter), in both
  directions between the packages.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import yolov3 as jyolo
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import yolov3 as tyolo

HEAD_TOL, PREDICT_TOL = 1e-5, 1e-5
LOSS_RTOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 5e-4, 1e-4


@pytest.fixture
def models():
    jnn.layers.seed(0)
    tnn.seed(0)
    jm = jyolo.YOLOv3(jyolo.YoloConfig.tiny())
    tm = tyolo.YOLOv3(tyolo.YoloConfig.tiny(), device="cpu")
    params = {k: np.asarray(v) for k, v in jm.trainable_dict().items()}
    buffers = {k: np.asarray(v) for k, v in jm.state_dict().items()
               if k not in params}
    weights.layer_state_from_jax(params, buffers, tm)
    return jm, tm, params


def _batch():
    rng = np.random.RandomState(0)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    gt = np.zeros((1, 6, 4), np.float32)
    gt[0, :4, :2] = rng.uniform(0.1, 0.9, (4, 2))
    gt[0, :4, 2:] = rng.uniform(0.05, 0.6, (4, 2))
    label = rng.randint(0, 4, (1, 6)).astype(np.int32)
    return x, gt, label


def test_names_and_config_match_jax(models):
    jm, tm, params = models
    assert list(dict(tm.named_parameters())) == list(params)
    assert tyolo.YoloConfig() == tyolo.YoloConfig(
        **jyolo.YoloConfig().__dict__)
    assert tyolo.YoloConfig.tiny() == tyolo.YoloConfig(
        **jyolo.YoloConfig.tiny().__dict__)


def test_heads_and_predict_match_jax(models):
    jm, tm, _ = models
    jm.eval()
    tm.eval()
    x, _, _ = _batch()
    size = np.array([[32, 32]], np.int32)
    jheads, jpred = jax.jit(lambda a, s: (jm(a), jm.predict(a, s)))(x, size)
    with torch.no_grad():
        theads = tm(torch.from_numpy(x))
        tpred = tm.predict(torch.from_numpy(x),
                           torch.from_numpy(size)).numpy()
    assert [tuple(h.shape) for h in theads] == [(1, 27, 1, 1),
                                               (1, 27, 2, 2), (1, 27, 4, 4)]
    for j, t in zip(jheads, theads):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= HEAD_TOL * np.abs(j).max()
    jpred = np.asarray(jpred)
    assert tpred.shape == jpred.shape == (1, 100, 6)
    np.testing.assert_array_equal(tpred[..., 0], jpred[..., 0])
    assert (jpred[..., 0] >= 0).sum() > 0
    assert np.abs(tpred - jpred).max() <= PREDICT_TOL * np.abs(jpred).max()


def test_loss_and_gradients_match_jax(models):
    jm, tm, params = models
    x, gt, label = _batch()

    def jloss(p, *a):
        jm.load_trainable(p)
        return jm.loss(*a)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jm.trainable_dict(), x, gt,
                                                label)
    jm.load_trainable(params)
    tm.zero_grad()
    lt = tm.loss(torch.from_numpy(x), torch.from_numpy(gt),
                 torch.from_numpy(label))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    gj = {k: np.asarray(v) for k, v in gj.items()}
    tg = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(tg) == set(gj)
    top = max(float(np.abs(g).max()) for g in gj.values())
    for k, want in gj.items():
        scale = max(float(np.abs(want).max()), GRAD_FLOOR * top)
        err = float(np.abs(tg[k] - want).max()) / scale
        assert err <= GRAD_TOL, f"grad {k}: {err:.3g} > {GRAD_TOL}"
