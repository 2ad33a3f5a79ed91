"""The port's loss ops (`paddle_tpu_torch/ops/loss.py`) against the JAX
package's, on the CPU.

Each of the ten op types on the same numpy inputs (the JAX loss
corpus's, `tests/test_ops_loss.py`, where it has them) through
`test_torch_ops_corpus.check_case`: forward against the numpy oracle
(brute-force path enumeration for the CRF and Viterbi, the reference
CTC recursion) and the JAX op at the case's tolerance, and, where the
case checks them, autograd's gradients against `jax.vjp` (rtol 1e-4,
atol 1e-6 of the largest). The CRF and Viterbi also run on ragged
lengths with a length-1 row. `nce` and `sampled_softmax_with_cross_
entropy` are held with custom negatives (their samplers draw from
different generators); their sampling paths are checked for shape and
range. A float64 CRF computes in float64 (1e-12 of the brute force).
"""
import itertools

import numpy as np
import torch

import test_ops_loss as jl
from op_test import OpCase
from paddle_tpu_torch.core.registry import OpContext, get_op
from test_torch_ops_corpus import check_case

R = np.random.RandomState(97)


def _f(*shape, s=0.5):
    return (R.uniform(-1, 1, size=shape) * s).astype(np.float32)


# ragged CRF inputs with a length-1 row (jl's tag count D = 3)
_EM3 = _f(3, 4, jl.D)
_LBL3 = R.randint(0, jl.D, (3, 4)).astype(np.int32)
_LEN3 = np.array([4, 1, 3], np.int32)


def _crf(em, tr, lbl, lens, name):
    return OpCase(
        "linear_chain_crf",
        {"Emission": em, "Transition": tr, "Label": lbl, "Length": lens},
        oracle=lambda Emission, Transition, Label, Length, attrs:
            (jl._crf_nll_np(Emission, Transition, Label, Length), None),
        grad_inputs=["Emission", "Transition"],
        grad_outputs=["LogLikelihood"], atol=1e-4, rtol=1e-4, name=name)


def _viterbi(em, tr, lens, name):
    return OpCase(
        "crf_decoding", {"Emission": em, "Transition": tr, "Length": lens},
        oracle=lambda Emission, Transition, Length, attrs:
            jl._viterbi_np(Emission, Transition, Length),
        check_grad=False, name=name)


def test_linear_chain_crf():
    check_case(_crf(jl._EM, jl._TR, jl._LBL, jl._LEN, "crf"))


def test_linear_chain_crf_ragged_with_a_length_one_row():
    check_case(_crf(_EM3, jl._TR, _LBL3, _LEN3, "crf_ragged"))


def test_crf_decoding():
    check_case(_viterbi(jl._EM, jl._TR, jl._LEN, "viterbi"))


def test_crf_decoding_ragged_with_a_length_one_row():
    check_case(_viterbi(_EM3, jl._TR, _LEN3, "viterbi_ragged"))


def test_crf_decoding_label_flags():
    lbl = jl._viterbi_np(_EM3, jl._TR, _LEN3)
    lbl[0, 1] = (lbl[0, 1] + 1) % jl.D        # one wrong tag
    mask = np.arange(4)[None, :] < _LEN3[:, None]
    want = ((lbl == jl._viterbi_np(_EM3, jl._TR, _LEN3)) & mask).astype(
        np.int32)
    check_case(OpCase(
        "crf_decoding", {"Emission": _EM3, "Transition": jl._TR,
                         "Label": lbl, "Length": _LEN3},
        oracle=lambda Emission, Transition, Label, Length, attrs: want,
        check_grad=False, name="viterbi_flags"))


def test_linear_chain_crf_float64_stays_float64():
    em = _EM3.astype(np.float64)
    tr = jl._TR.astype(np.float64)
    impl = get_op("linear_chain_crf")
    ll, alpha = impl.fn(OpContext({}, 0, True, 0, "cpu"),
                        torch.from_numpy(em), torch.from_numpy(tr),
                        torch.from_numpy(_LBL3), torch.from_numpy(_LEN3))
    assert ll.dtype == torch.float64 and alpha.dtype == torch.float64
    want = np.zeros((3, 1))
    for b in range(3):      # the brute force in float64
        L = _LEN3[b]
        scores = [jl._crf_score(em[b, :L], tr, p)
                  for p in itertools.product(range(jl.D), repeat=L)]
        want[b, 0] = np.logaddexp.reduce(scores) - jl._crf_score(
            em[b, :L], tr, _LBL3[b, :L])
    np.testing.assert_allclose(ll.numpy(), want, rtol=1e-12)


def test_warpctc():
    check_case(OpCase(
        "warpctc",
        {"Logits": jl._LOGITS, "Label": jl._CLAB,
         "LogitsLength": jl._CTLEN, "LabelLength": jl._CLLEN},
        oracle=lambda Logits, Label, LogitsLength, LabelLength, attrs:
            jl._ctc_np(Logits, Label, LogitsLength, LabelLength),
        atol=1e-4, rtol=1e-4, name="warpctc"))


def test_warpctc_norm_by_times():
    check_case(OpCase(
        "warpctc",
        {"Logits": jl._LOGITS, "Label": jl._CLAB,
         "LogitsLength": jl._CTLEN, "LabelLength": jl._CLLEN},
        attrs={"norm_by_times": True},
        oracle=lambda Logits, Label, LogitsLength, LabelLength, attrs:
            jl._ctc_np(Logits, Label, LogitsLength, LabelLength)
            / LogitsLength[:, None],
        atol=1e-4, rtol=1e-4, name="warpctc_norm"))


def test_nce_custom_negatives():
    num_total, d, custom = 8, 4, [1, 5, 6]
    check_case(OpCase(
        "nce", {"Input": _f(3, d),
                "Label": R.randint(0, num_total, (3, 1)).astype(np.int32),
                "Weight": _f(num_total, d), "Bias": _f(num_total)},
        attrs={"num_total_classes": num_total, "custom_neg_classes": custom},
        oracle=lambda Input, Label, Weight, Bias, attrs:
            (jl._nce_np(Input, Label, Weight, Bias, custom, num_total),
             None, None),
        grad_inputs=["Input", "Weight", "Bias"], grad_outputs=["Cost"],
        atol=1e-4, rtol=1e-4, name="nce"))


def test_nce_samplers_draw_in_range():
    impl = get_op("nce")
    for sampler in ("uniform", "log_uniform"):
        cost, logits, samples = impl.fn(
            OpContext({"num_total_classes": 8, "num_neg_samples": 4,
                       "sampler": sampler}, 3, True, 5, "cpu"),
            torch.from_numpy(_f(3, 4)), torch.tensor([[1], [2], [7]]),
            torch.from_numpy(_f(8, 4)), torch.from_numpy(_f(8)), None)
        assert cost.shape == (3, 1) and (cost > 0).all()
        assert samples.shape == (3, 5) and samples.dtype == torch.int32
        assert samples[:, 0].tolist() == [1, 2, 7]
        assert ((samples >= 0) & (samples < 8)).all()


def test_hsigmoid():
    num_classes, d = 6, 4
    check_case(OpCase(
        "hsigmoid", {"X": _f(3, d), "Label": np.array([[0], [3], [5]],
                                                      np.int32),
                     "W": _f(num_classes - 1, d),
                     "Bias": _f(num_classes - 1)},
        attrs={"num_classes": num_classes},
        oracle=lambda X, Label, W, Bias, attrs:
            (jl._hsig_np(X, Label, W, Bias, num_classes), None),
        grad_inputs=["X", "W", "Bias"], grad_outputs=["Out"],
        atol=1e-4, rtol=1e-4, name="hsigmoid"))


def test_hsigmoid_custom_tree():
    x, w = _f(2, 3), _f(3, 3)
    p0, p1 = np.clip(x[0] @ w[0], -40, 40), np.clip(x[0] @ w[1], -40, 40)
    want0 = (np.log1p(np.exp(p0)) - p0) + np.log1p(np.exp(p1))
    check_case(OpCase(
        "hsigmoid", {"X": x, "Label": np.array([[0], [1]], np.int32),
                     "W": w, "PathTable": np.array([[0, 1], [0, -1]],
                                                   np.int32),
                     "PathCode": np.array([[1, 0], [0, 0]], np.int32)},
        attrs={"num_classes": 3},
        oracle=lambda X, Label, W, PathTable, PathCode, attrs:
            (np.array([[want0], [np.log1p(np.exp(np.clip(x[1] @ w[0], -40,
                                                         40)))
                                 + np.log(2.0)]], np.float32), None),
        grad_inputs=["X", "W"], grad_outputs=["Out"], atol=1e-5, rtol=1e-4,
        name="hsigmoid_custom"))


def test_hinge_loss():
    logits = _f(5, 1, s=2.0)
    labels = R.randint(0, 2, (5, 1)).astype(np.float32)
    check_case(OpCase(
        "hinge_loss", {"Logits": logits, "Labels": labels},
        oracle=lambda Logits, Labels, attrs:
            np.maximum(0.0, 1.0 - Logits * (2 * Labels - 1)),
        grad_inputs=["Logits"], name="hinge"))


def test_modified_huber_loss():
    x = np.array([[-2.5], [-0.7], [0.2], [0.9], [1.8], [-1.4]], np.float32)
    y = np.array([[1], [1], [0], [1], [1], [0]], np.float32)

    def oracle(X, Y, attrs):
        z = X * (2 * Y - 1)
        return z, np.where(z < -1, -4 * z, np.where(z < 1, (1 - z) ** 2, 0))
    check_case(OpCase("modified_huber_loss", {"X": x, "Y": y},
                      oracle=oracle, grad_inputs=["X"], name="huber"))


def test_squared_l2_distance_broadcasts_one_row():
    x, y = _f(4, 3), _f(1, 3)
    check_case(OpCase(
        "squared_l2_distance", {"X": x, "Y": y},
        oracle=lambda X, Y, attrs: (X - Y, ((X - Y) ** 2).sum(1,
                                                            keepdims=True)),
        name="sq_l2"))


def test_center_loss():
    x, centers = _f(5, 3), _f(4, 3)
    label = np.array([[0], [2], [2], [3], [0]], np.int64)

    def oracle(X, Label, Centers, CenterUpdateRate, attrs):
        lbl = Label.ravel()
        diff = X - Centers[lbl]
        acc = np.zeros_like(Centers)
        cnt = np.zeros(len(Centers), np.float32)
        for i, c in enumerate(lbl):
            acc[c] += diff[i]
            cnt[c] += 1
        return (diff, 0.5 * (diff ** 2).sum(1, keepdims=True),
                Centers + CenterUpdateRate[0] * acc / (1 + cnt[:, None]))
    check_case(OpCase(
        "center_loss", {"X": x, "Label": label, "Centers": centers,
                        "CenterUpdateRate": np.array([0.1], np.float32)},
        oracle=oracle, atol=1e-5, rtol=1e-5, name="center"))


def test_sampled_softmax_custom_samples():
    logits = _f(3, 10, s=2.0)
    label = np.array([[1], [4], [9]], np.int64)
    samples = np.array([[1, 3, 4, 1], [4, 0, 4, 7], [9, 2, 5, 8]], np.int64)
    probs = R.uniform(0.05, 0.5, (3, 4)).astype(np.float32)

    def oracle(Logits, Label, CustomizedSamples, CustomizedProbabilities,
               attrs):
        g = np.take_along_axis(Logits, CustomizedSamples, 1) - np.log(
            CustomizedProbabilities)
        hit = CustomizedSamples[:, 1:] == Label
        g[:, 1:] += np.where(hit, -1e20, 0.0)
        g = g - g.max(1, keepdims=True)
        logp = g - np.log(np.exp(g).sum(1, keepdims=True))
        return -logp[:, :1], CustomizedSamples
    check_case(OpCase(
        "sampled_softmax_with_cross_entropy",
        {"Logits": logits, "Label": label, "CustomizedSamples": samples,
         "CustomizedProbabilities": probs},
        attrs={"num_samples": 3}, oracle=oracle, grad_inputs=["Logits"],
        grad_outputs=["Loss"], atol=1e-5, rtol=1e-5, name="sampled_softmax"))


def test_sampled_softmax_sampler_draws_in_range():
    impl = get_op("sampled_softmax_with_cross_entropy")
    loss, samples = impl.fn(
        OpContext({"num_samples": 6}, 11, True, 2, "cpu"),
        torch.from_numpy(_f(4, 50)), torch.tensor([[3], [0], [49], [7]]),
        None, None)
    assert loss.shape == (4, 1) and torch.isfinite(loss).all()
    assert samples.shape == (4, 7) and samples.dtype == torch.int32
    assert samples[:, 0].tolist() == [3, 0, 49, 7]
    assert ((samples >= 0) & (samples < 50)).all()
