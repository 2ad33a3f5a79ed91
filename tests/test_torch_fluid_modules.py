"""The random and metric ops, the synthetic datasets and the small Fluid
modules of the port against the JAX package, on the CPU.

* `truncated_gaussian_random`, `randint`, `shuffle_batch`,
  `sampling_id`, `multinomial`: `jax.random` draws cannot be matched,
  so both packages' ops are held to the same contract — shape, dtype,
  support, first two moments within 5 sigma, a permutation that is one,
  categories drawn in proportion to their probabilities; the port's
  draws follow the `seed` attr, else the run seed and the op index.
* `auc` and `precision_recall` against the JAX ops on the same inputs
  (rtol 1e-6), their streaming state carried over two batches.
* `io.dataset`'s cifar, imikolov, imdb, wmt16 and ctr give the
  reference's samples bit for bit.
* The initializers TruncatedNormal, NumpyArrayInitializer and Bilinear
  emit the reference's startup op specs; `lod_tensor`, `input` and
  `initializer` match the reference's module paths; `install_check`
  runs its eager and static steps on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.initializer as jinit_mod
import paddle_tpu.lod_tensor as jlod
from paddle_tpu.core.registry import OpContext as JCtx
from paddle_tpu.core.registry import get_op as jget_op
from paddle_tpu.io import dataset as jdataset
from paddle_tpu_torch import initializer as tinit_mod
from paddle_tpu_torch import input as tinput
from paddle_tpu_torch import install_check
from paddle_tpu_torch import lod_tensor as tlod
from paddle_tpu_torch.core.registry import OpContext as TCtx
from paddle_tpu_torch.core.registry import get_op as tget_op
from paddle_tpu_torch.io import dataset as tdataset


def _port(op, attrs, *inputs, seed=0, op_index=0):
    return tget_op(op).fn(TCtx(dict(attrs), seed, True, op_index, "cpu"),
                          *[torch.from_numpy(np.asarray(a)) for a in inputs])


def _jax(op, attrs, *inputs, seed=0):
    return jget_op(op).fn(JCtx(dict(attrs), jax.random.key(seed), True, 0),
                          *[jnp.asarray(a) for a in inputs])


SIDES = {"port": lambda op, attrs, *a: _port(op, attrs, *a).numpy(),
         "jax": lambda op, attrs, *a: np.asarray(_jax(op, attrs, *a))}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_truncated_gaussian_random(side):
    attrs = {"shape": [200, 300], "mean": 1.0, "std": 2.0}
    x = SIDES[side]("truncated_gaussian_random", attrs)
    assert x.shape == (200, 300) and x.dtype == np.float32
    assert x.min() >= 1.0 - 4.0 - 1e-5 and x.max() <= 1.0 + 4.0 + 1e-5
    # N(0, 1) truncated to [-2, 2]: variance 0.7737413
    var = 4.0 * 0.7737413
    n = x.size
    assert abs(x.mean() - 1.0) < 5 * np.sqrt(var / n)
    assert abs(x.var() - var) < 5 * var * np.sqrt(2.0 / n)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_randint(side):
    x = SIDES[side]("randint", {"shape": [4000], "low": 3, "high": 9,
                                "dtype": "int32"})
    assert x.dtype == np.int32 and x.shape == (4000,)
    assert set(np.unique(x)) == set(range(3, 9))


@pytest.mark.parametrize("side", sorted(SIDES))
def test_shuffle_batch_permutes_rows(side):
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = SIDES[side]("shuffle_batch", {}, x)
    assert sorted(y[:, 0].tolist()) == x[:, 0].tolist()
    np.testing.assert_array_equal(y[:, 1] - y[:, 0], np.ones(20))
    assert (y != x).any()


@pytest.mark.parametrize("side", sorted(SIDES))
@pytest.mark.parametrize("op", ["sampling_id", "multinomial"])
def test_categorical_draws_follow_the_probabilities(side, op):
    p = np.array([[0.1, 0.6, 0.3, 0.0]] * 2000, np.float32)
    attrs = {"num_samples": 3} if op == "multinomial" else {}
    s = SIDES[side](op, attrs, p)
    assert s.shape == ((2000, 3) if op == "multinomial" else (2000,))
    counts = np.bincount(s.reshape(-1), minlength=4) / s.size
    assert counts[3] == 0
    sigma = np.sqrt(p[0] * (1 - p[0]) / s.size)
    assert (np.abs(counts - p[0]) < 5 * sigma + 1e-12).all(), counts


def test_port_draws_follow_the_seed():
    attrs = {"shape": [64], "low": 0, "high": 1000}
    a = _port("randint", attrs, seed=1, op_index=3).numpy()
    np.testing.assert_array_equal(a, _port("randint", attrs, seed=1,
                                           op_index=3).numpy())
    assert (a != _port("randint", attrs, seed=1, op_index=4).numpy()).any()
    fixed = dict(attrs, seed=7)
    np.testing.assert_array_equal(
        _port("randint", fixed, seed=1).numpy(),
        _port("randint", fixed, seed=2, op_index=5).numpy())


def test_auc_streams_like_jax():
    rng = np.random.RandomState(0)
    pos = np.zeros(64, np.float32)
    neg = np.zeros(64, np.float32)
    state = {"port": (pos, neg), "jax": (pos, neg)}
    for _ in range(2):
        pred = rng.uniform(size=(50, 2)).astype(np.float32)
        lbl = (rng.uniform(size=(50, 1)) < pred[:, 1:]).astype(np.int64)
        outs = {}
        for side, fn in (("port", _port), ("jax", _jax)):
            auc, p, n = fn("auc", {}, pred, lbl, *state[side])
            outs[side] = [np.asarray(v) for v in (auc, p, n)]
            state[side] = (outs[side][1], outs[side][2])
        for g, w in zip(outs["port"], outs["jax"]):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    assert 0.5 < float(outs["port"][0]) <= 1.0


def test_precision_recall_like_jax():
    rng = np.random.RandomState(1)
    states = np.zeros((5, 4), np.float32)
    args = (rng.uniform(size=(40, 1)).astype(np.float32),
            rng.randint(0, 5, (40, 1)).astype(np.int64),
            rng.randint(0, 5, (40, 1)).astype(np.int64), states)
    got = [o.numpy() for o in _port("precision_recall", {}, *args)]
    want = [np.asarray(o) for o in _jax("precision_recall", {}, *args)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


DATASETS = [("cifar", "train10"), ("cifar", "test10"), ("cifar", "train100"),
            ("imikolov", "train"), ("imikolov", "test"), ("imdb", "train"),
            ("wmt16", "test"), ("ctr", "train")]


@pytest.mark.parametrize("name,split", DATASETS)
def test_dataset_equals_the_reference(name, split):
    t = list(getattr(getattr(tdataset, name), split)(13)())
    j = list(getattr(getattr(jdataset, name), split)(13)())
    assert len(t) == len(j) == 13
    for st, sj in zip(t, j):
        assert len(st) == len(sj)
        for a, b in zip(st, sj):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    for attr in ("VOCAB", "IMAGE_SHAPE", "SRC_VOCAB", "SLOTS"):
        ref = getattr(getattr(jdataset, name), attr, None)
        assert getattr(getattr(tdataset, name), attr, None) == ref


@pytest.mark.parametrize("init", [
    ("TruncatedNormal", (0.5, 2.0, 3)), ("NumpyArrayInitializer",
                                         (np.arange(6.0).reshape(2, 3),)),
    ("Bilinear", ())])
def test_initializer_op_specs_equal_the_reference(init):
    name, args = init
    shape = [2, 3] if name != "Bilinear" else [2, 3, 4, 4]
    t = getattr(tinit_mod, name)(*args).op_spec(shape, "float32")
    j = getattr(jinit_mod, name)(*args).op_spec(shape, "float32")
    assert t == j


def test_fluid_module_paths():
    assert tinput.embedding.__module__ == "paddle_tpu_torch.static.nn"
    assert tinput.one_hot.__module__ == "paddle_tpu_torch.static.common"
    assert set(tinit_mod.__all__) >= {"TruncatedNormal", "Bilinear",
                                      "NumpyArrayInitializer", "Xavier"}
    seqs = [np.arange(3), np.arange(5), np.arange(1)]
    for t, j in zip(tlod.create_lod_tensor(seqs, [[3, 5, 1]]),
                    jlod.create_lod_tensor(seqs, [[3, 5, 1]])):
        np.testing.assert_array_equal(t, j)
    flat = np.arange(8.0).reshape(8, 1)
    for t, j in zip(tlod.create_lod_tensor(flat, [[2, 6]]),
                    jlod.create_lod_tensor(flat, [[2, 6]])):
        np.testing.assert_array_equal(t, j)
    data, lens = tlod.create_random_int_lodtensor([[2, 4]], [3], None, 1, 5)
    assert data.shape == (2, 4, 3) and lens.tolist() == [2, 4]
    assert data.min() >= 0 and data.max() <= 5


def test_install_check_runs_on_the_cpu(capsys):
    eager, static = install_check.run_check("cpu")
    assert np.isfinite(eager) and np.isfinite(static)
    assert "works well on CPU" in capsys.readouterr().out
