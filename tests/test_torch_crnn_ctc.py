"""Fluid's CRNN-CTC OCR model (models/crnn_ctc.py) in the port against
the JAX package's Executor, on the CPU, at a tiny config (1 x 16 x 64
images, conv groups of 4 / 4 / 8 / 8 filters, GRU 8, 5 + 1 classes,
labels of 1-3, batch 4).

* The program: `crnn_ctc_programs` built with the JAX package's
  builders is the port's op for op (main and startup), and the full
  config's shapes are the model file's (128 x 6 x 64 features, 64 steps
  of 768, 96 logits).
* Two Momentum steps from the same weights (the JAX startup's, moved by
  name): each step's loss within rtol 1e-5; each parameter's gradient
  within rtol 1e-5 with a floor of 1e-5 of its own largest entry — but
  the conv biases that feed a batch norm, whose gradient is exactly 0
  in exact arithmetic and rounding noise in both packages, are held
  under 1e-5 of the largest gradient in both; the parameters after each
  step within 1e-6 of lr; each step's argmax equal where its top-2
  logit gap exceeds 1e-4, and the decoded ids, lengths and edit
  distances equal on every row whose every step does. At the model's
  small initial weights the logits are close, so the program seed is
  one (0) at which every row is such a row: all 4 rows of both steps
  and of the test batch are compared (smallest gap 4.8e-4; at seed 7,
  say, no row of the first step is), and the test asserts it.
* The test program (cloned before the optimizer) decodes the same.
"""
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.utils.initializer import Normal as JNormal
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu.utils.regularizer import L2Decay as JL2Decay
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models import crnn_ctc
from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

CFG = crnn_ctc.CRNNConfig.tiny()
BATCH = 4
JAX_API = SimpleNamespace(static=pt.static, optimizer=pt.optimizer,
                          ir=pt.core.ir, ParamAttr=JParamAttr, Normal=JNormal,
                          L2Decay=JL2Decay)
GAP = 1e-4


def _programs(side, cfg=CFG, batch=BATCH):
    ir = pt.core.ir if side == "jax" else tir
    ir.reset_unique_names()
    return crnn_ctc.crnn_ctc_programs(
        cfg, batch, JAX_API if side == "jax" else None, seed=0)


def _bn_biases(program):
    ops = program.global_block().ops
    normed = {op.inputs["X"][0] for op in ops if op.type == "batch_norm"}
    return {op.inputs["Bias"][0] for op in ops
            if op.type == "conv2d" and op.inputs.get("Bias")
            and op.outputs["Output"][0] in normed}


def test_full_config_shapes_are_the_model_files():
    main, test, startup, names = _programs("port", crnn_ctc.CRNNConfig(), 2)
    block = main.global_block()
    assert tuple(block.var(names["logits"]).shape) == (2, 64, 96)
    seq = [op for op in block.ops if op.type == "im2sequence"][0]
    assert tuple(block.var(seq.inputs["X"][0]).shape) == (2, 128, 6, 64)
    assert tuple(block.var(seq.outputs["Out"][0]).shape) == (128, 768)
    assert tuple(block.var(names["decoded"]).shape) == (2, 64)
    grus = [op for op in block.ops if op.type == "gru"]
    assert [op.attrs["is_reverse"] for op in grus] == [False, True]
    assert {op.attrs["candidate_activation"] for op in grus} == {"relu"}
    assert not any(op.type == "momentum" for op in test.global_block().ops)


def test_crnn_ctc_trains_like_jax():
    jmain, jtest, jstart, names = _programs("jax")
    tmain, ttest, tstart, tnames = _programs("port")
    assert tnames == names
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    assert ttest.to_dict() == jtest.to_dict()
    params = [v.name for v in tmain.all_parameters() if v.desc.trainable]
    cancelled = _bn_biases(tmain)
    assert len(cancelled) == 8
    grads = [p + "@GRAD" for p in params]
    fetch = [names[k] for k in ("loss", "logits", "decoded",
                                "decoded_length", "distance", "seq_num")]
    exe = pt.Executor()
    exe.run(jstart)
    state = {v.name: pt.global_scope().find_np(v.name)
             for v in jmain.list_vars() if v.persistable
             and pt.global_scope().has(v.name)}
    scope = scope_from_jax(state, Scope(), "cpu", program=tmain)
    texe = TExecutor("cpu")
    losses = []
    for step in range(2):
        batch = crnn_ctc.synthetic_batch(CFG, BATCH, step)
        feed = {names[k]: v for k, v in batch.items()}
        jout = exe.run(jmain, feed=feed, fetch_list=fetch + grads)
        tout = texe.run(tmain, feed=feed, fetch_list=fetch + grads,
                        scope=scope)
        np.testing.assert_allclose(tout[0], jout[0], rtol=1e-5)
        losses.append(float(tout[0]))
        jg = dict(zip(params, jout[len(fetch):]))
        tg = dict(zip(params, tout[len(fetch):]))
        top = max(float(np.abs(v).max()) for v in jg.values())
        for p in params:
            if p in cancelled:
                for g in (jg[p], tg[p]):
                    assert np.abs(g).max() < 1e-5 * top, p
                continue
            np.testing.assert_allclose(
                tg[p], jg[p], rtol=1e-5,
                atol=1e-5 * float(np.abs(jg[p]).max()), err_msg=p)
        logits = np.asarray(jout[1])
        top = np.sort(logits, axis=-1)
        sure = (top[..., -1] - top[..., -2]) > GAP          # [B, T]
        np.testing.assert_array_equal(
            np.asarray(tout[1]).argmax(-1)[sure], logits.argmax(-1)[sure])
        rows = sure.all(axis=1)
        assert rows.all(), f"step {step}: {rows.sum()} of {BATCH} rows sure"
        for i in (2, 3, 4):
            np.testing.assert_array_equal(np.asarray(tout[i])[rows],
                                          np.asarray(jout[i])[rows])
        assert int(tout[5][0]) == BATCH
        want = {v.name: pt.global_scope().find_np(v.name)
                for v in jmain.list_vars() if v.persistable
                and pt.global_scope().has(v.name)}
        got = scope_to_numpy(scope, sorted(want))
        for name in params:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-6 * CFG.lr, err_msg=name)
    assert all(np.isfinite(losses))
    # the test clone decodes the same from the same state
    feed = {names[k]: v for k, v in
            crnn_ctc.synthetic_batch(CFG, BATCH, 9).items()}
    jd = exe.run(jtest, feed=feed, fetch_list=fetch[1:])
    td = texe.run(ttest, feed=feed, fetch_list=fetch[1:], scope=scope)
    np.testing.assert_allclose(td[0], jd[0], rtol=1e-5, atol=1e-6)
    top = np.sort(np.asarray(jd[0]), axis=-1)
    rows = ((top[..., -1] - top[..., -2]) > GAP).all(axis=1)
    assert rows.all(), f"test batch: {rows.sum()} of {BATCH} rows sure"
    for a, b in zip(td[1:4], jd[1:4]):
        np.testing.assert_array_equal(np.asarray(a)[rows], np.asarray(b)[rows])
    assert int(td[4][0]) == int(jd[4][0]) == BATCH


def test_synthetic_batch_is_the_documented_one():
    batch = crnn_ctc.synthetic_batch(crnn_ctc.CRNNConfig(), 32, 0)
    assert batch["pixel"].shape == (32, 1, 48, 512)
    lens = batch["label_length"][:, 0]
    assert lens.min() >= 1 and lens.max() <= 24
    lab = batch["label"]
    assert lab.shape == (32, 24) and lab.max() < 95
    for row, n in zip(lab, lens):
        assert not row[n:].any()


@pytest.mark.parametrize("batch", [1, 3])
def test_any_static_batch_builds(batch):
    main, _, _, names = _programs("port", batch=batch)
    assert main.global_block().var(names["logits"]).shape[0] == batch
