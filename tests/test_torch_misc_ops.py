"""The misc, text, CTR and fused op families of the port against the JAX
package, on the CPU (the op corpus of these families runs in
tests/test_torch_ops_corpus.py).

* The reference's hand-written tests run through the port: each test
  function of tests/test_ops_misc2.py, tests/test_ops_text.py and
  tests/test_ops_coverage.py named below is called with its
  `check_output` / `run_case` replaced by the port's, which runs the
  case through the port's registry, holds it against the case's oracle
  and against the JAX op (tests/test_torch_ops_corpus.py::check_case,
  its tolerances), and hands the port's outputs to the test's own
  assertions.
* `hash` and `pyramid_hash` are bit-equal to the JAX ops on seeded ids
  (negative and past 2^31 included).
* `cvm` and `data_norm` have hand-written gradients (ctr.py): the port's
  autograd equals jax.grad of the JAX op, to 1e-6 relative.
* `edit_distance`, `ctc_greedy_decoder`, `gather_tree` and `unique` on
  seeded random inputs equal the JAX ops (ids, counts, lengths) or
  agree to 1e-6 (distances).
* The random ops (`*_batch_size_like`, `random_crop`) are held to their
  contract, not the JAX package's bits: shapes, range, moments within 5
  sigma, crops that are sub-windows of the input, the same draws from
  the same run seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import op_test
import test_ops_coverage
import test_ops_misc2
import test_ops_text
from op_test import OpCase
from test_torch_ops_corpus import _out_slots, _pick, _port_run, _torch, \
    check_case
from paddle_tpu.core import registry as jregistry
from paddle_tpu_torch.core import registry as tregistry


def _forward_only(case):
    c = OpCase(case.op, case.inputs, case.attrs, case.oracle, case.out_slots,
               case.variadic_out, case.grad_inputs, case.grad_outputs,
               False, case.atol, case.rtol, name=case.name)
    return c


def port_check_output(case):
    """op_test.check_output through the port: the case against its oracle
    and the JAX op (check_case, forward), the port's outputs returned."""
    check_case(_forward_only(case))
    np_in = {k: [np.asarray(a) for a in v] if isinstance(v, (list, tuple))
             else np.asarray(v) for k, v in case.inputs.items()}
    t_in = {k: [_torch(a) for a in v] if isinstance(v, list) else _torch(v)
            for k, v in np_in.items()}
    impl, result = _port_run(case, t_in)
    return [o.detach().numpy()
            for o in _pick(result, impl, _out_slots(impl, case))]


@pytest.fixture
def through_port(monkeypatch):
    """The reference test modules' check_output / run_case, the port's."""
    for mod in (test_ops_misc2, test_ops_coverage, op_test):
        monkeypatch.setattr(mod, "check_output", port_check_output)
    for mod in (test_ops_misc2, test_ops_text):
        monkeypatch.setattr(mod, "run_case", check_case)


HAND_TESTS = [
    (test_ops_misc2, "test_edit_distance"),
    (test_ops_misc2, "test_ctc_greedy_decoder"),
    (test_ops_misc2, "test_gather_tree"),
    (test_ops_misc2, "test_hash_deterministic_in_range"),
    (test_ops_misc2, "test_teacher_student_sigmoid_loss_branches"),
    (test_ops_text, "test_pyramid_hash"),
    (test_ops_coverage, "test_hard_shrink"),
    (test_ops_coverage, "test_softshrink"),
    (test_ops_coverage, "test_thresholded_relu"),
    (test_ops_coverage, "test_unique_with_counts"),
    (test_ops_coverage, "test_unique"),
    (test_ops_coverage, "test_npair_loss"),
    (test_ops_coverage, "test_sequence_scatter"),
]


@pytest.mark.parametrize("mod,name", HAND_TESTS,
                         ids=[f"{m.__name__}-{n}" for m, n in HAND_TESTS])
def test_reference_hand_test_through_port(through_port, mod, name):
    getattr(mod, name)()


# ------------------------------------------------------------- helpers
def _run(op, attrs, *args, seed=0):
    impl = tregistry.get_op(op)
    ctx = tregistry.OpContext(dict(attrs), seed, True, 0, "cpu")
    return impl.fn(ctx, *[None if a is None else torch.as_tensor(a)
                          if not isinstance(a, list)
                          else [torch.as_tensor(x) for x in a]
                          for a in args])


def _jrun(op, attrs, *args):
    impl = jregistry.get_op(op)
    ctx = jregistry.OpContext(dict(attrs), jax.random.key(0), True, 0)
    return impl.fn(ctx, *[None if a is None else jnp.asarray(a)
                          for a in args])


# ------------------------------------------------------------ bit-equal
@pytest.mark.parametrize("mod_by,num_hash", [(100, 2), (1_000_003, 2),
                                             (7, 1)])
def test_hash_is_bit_equal_to_jax(mod_by, num_hash):
    rng = np.random.RandomState(mod_by)
    # int32 ids (the JAX package's with x64 off), the extremes included
    x = rng.randint(-2 ** 31, 2 ** 31 - 1, size=(64, 3)).astype(np.int32)
    x[0] = [0, -1, 2 ** 31 - 1]
    attrs = {"mod_by": mod_by, "num_hash": num_hash}
    got = _run("hash", attrs, x).numpy()
    want = np.asarray(_jrun("hash", attrs, x))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_hash_third_seed_wraps_where_jax_overflows():
    """The JAX op's seed offset i * 0x9E3779B9 leaves uint32 from the
    third hash on, and jnp.uint32 raises (ROADMAP Queue 3); the port
    wraps it mod 2^32, the op's uint32 arithmetic, and keeps the first
    two hashes equal to the JAX op's."""
    x = np.random.RandomState(11).randint(0, 2 ** 31 - 1, (8, 2)).astype(
        np.int32)
    attrs = {"mod_by": 1_000_003, "num_hash": 3}
    with pytest.raises(OverflowError):
        _jrun("hash", attrs, x)
    got = _run("hash", attrs, x).numpy()
    np.testing.assert_array_equal(
        got[:, :2], np.asarray(_jrun("hash", dict(attrs, num_hash=2), x)))
    ids = x.astype(np.uint64)
    mixed = ((ids + (2 * 0x9E3779B9 % 2 ** 32)) % 2 ** 32
             * 2654435761) % 2 ** 32
    mixed ^= mixed >> 16
    np.testing.assert_array_equal(got[:, 2], mixed % 1_000_003)


@pytest.mark.parametrize("layers,white,black", [(3, False, False),
                                                (4, True, True)])
def test_pyramid_hash_is_bit_equal_to_jax(layers, white, black):
    rng = np.random.RandomState(layers)
    x = rng.randint(0, 2 ** 31 - 1, size=(6, 9)).astype(np.int32)
    w = rng.randn(97, 4).astype(np.float32)
    lengths = np.array([9, 5, 1, 0, 7, 3], np.int64)
    # the seed-0 bigram hashes of row 0 (the JAX op's own) seed the lists
    ids = jnp.asarray(x, jnp.uint32)
    h0 = np.asarray(jregistry.get_op("pyramid_hash").fn.__globals__[
        "_ngram_hash"](ids, 2, 0))[0]
    wl = (h0[:6].astype(np.int64) if white else None)
    bl = (h0[2:4].astype(np.int64) if black else None)
    attrs = {"num_emb": 8, "rand_len": 4, "space_len": 97,
             "pyramid_layer": layers, "drop_out_percent": 0.0,
             "is_training": 0}
    got = _run("pyramid_hash", attrs, x, w, wl, bl, lengths)
    want = _jrun("pyramid_hash", attrs, x, w, wl, bl, lengths)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert got[1].sum() > 0


# ------------------------------------------------- custom gradients
CVM_X = np.random.RandomState(3).uniform(0.2, 3.0, (6, 5)).astype(np.float32)
CVM_IN = np.random.RandomState(4).uniform(0.0, 1.0, (6, 2)).astype(
    np.float32)


@pytest.mark.parametrize("use_cvm", [True, False])
def test_cvm_gradient_is_the_reference_one(use_cvm):
    cot = np.random.RandomState(5).uniform(
        0.5, 1.5, (6, 5 if use_cvm else 3)).astype(np.float32)
    x = torch.tensor(CVM_X, requires_grad=True)
    y = _run("cvm", {"use_cvm": use_cvm}, x, CVM_IN)
    g, = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [x])
    jg = jax.grad(lambda a: jnp.sum(_jrun("cvm", {"use_cvm": use_cvm}, a,
                                          CVM_IN) * cot))(jnp.asarray(CVM_X))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_array_equal(g[:, :2].numpy(), CVM_IN)


def test_data_norm_statistic_gradients_are_the_reference_ones():
    rng = np.random.RandomState(6)
    args = [rng.uniform(0.5, 2.0, (7, 4)).astype(np.float32),
            np.full(4, 100.0, np.float32),
            rng.uniform(10, 30, 4).astype(np.float32),
            np.full(4, 400.0, np.float32)]
    cot = rng.uniform(0.5, 1.5, (7, 4)).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y = _run("data_norm", {"epsilon": 1e-4}, *leaves)[0]
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    want = jax.grad(lambda *a: jnp.sum(_jrun("data_norm", {"epsilon": 1e-4},
                                             *a)[0] * cot),
                    argnums=(0, 1, 2, 3))(*[jnp.asarray(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), 7.0)


# ------------------------------------------------- decoding on random data
@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_random_equals_jax(normalized):
    rng = np.random.RandomState(7)
    b, lh, lr = 16, 9, 7
    hyps = rng.randint(0, 4, (b, lh)).astype(np.int64)
    refs = rng.randint(0, 4, (b, lr)).astype(np.int64)
    hl = rng.randint(0, lh + 1, b).astype(np.int64)
    rl = rng.randint(0, lr + 1, b).astype(np.int64)
    attrs = {"normalized": normalized}
    d, n = _run("edit_distance", attrs, hyps, refs, hl, rl)
    jd, jn = _jrun("edit_distance", attrs, hyps, refs, hl, rl)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    assert d.dtype == torch.float32 and int(n[0]) == int(jn[0]) == b

    def lev(a, c):
        row = list(range(len(c) + 1))
        for i in range(1, len(a) + 1):
            new = [i]
            for j in range(1, len(c) + 1):
                new.append(min(row[j] + 1, new[j - 1] + 1,
                               row[j - 1] + (a[i - 1] != c[j - 1])))
            row = new
        return row[-1]

    want = [lev(hyps[i, :hl[i]], refs[i, :rl[i]]) for i in range(b)]
    if normalized:
        want = [w / max(r, 1) for w, r in zip(want, rl)]
    np.testing.assert_allclose(d.numpy()[:, 0], want, rtol=1e-6)


def test_ctc_greedy_decoder_random_equals_jax():
    rng = np.random.RandomState(8)
    # few classes and coarse values: repeats, blanks and argmax ties
    probs = rng.randint(0, 3, (12, 10, 4)).astype(np.float32)
    length = rng.randint(0, 11, 12).astype(np.int64)
    for blank in (0, 3):
        out, ln = _run("ctc_greedy_decoder", {"blank": blank}, probs, length)
        jout, jln = _jrun("ctc_greedy_decoder", {"blank": blank}, probs,
                          length)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
        assert out.dtype == ln.dtype == torch.int32


def test_gather_tree_random_equals_jax():
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 50, (6, 3, 4)).astype(np.int64)
    parents = rng.randint(0, 4, (6, 3, 4)).astype(np.int64)
    np.testing.assert_array_equal(
        _run("gather_tree", {}, ids, parents).numpy(),
        np.asarray(_jrun("gather_tree", {}, ids, parents)))


def test_unique_with_counts_random_equals_jax():
    x = np.random.RandomState(10).randint(-5, 6, (4, 9)).astype(np.int64)
    got = _run("unique_with_counts", {}, x)
    want = _jrun("unique_with_counts", {}, x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == got[2].dtype == torch.int64


# ------------------------------------------------------------ random ops
@pytest.mark.parametrize("op,attrs", [
    ("gaussian_random_batch_size_like",
     {"shape": [-1, 4000], "mean": 1.5, "std": 2.0}),
    ("uniform_random_batch_size_like",
     {"shape": [-1, 4000], "min": -3.0, "max": 5.0}),
])
def test_batch_size_like_draws_hold_their_contract(op, attrs):
    ref = np.zeros((5, 2), np.float32)
    out = _run(op, dict(attrs, input_dim_idx=0, output_dim_idx=0), ref)
    assert tuple(out.shape) == (5, 4000) and out.dtype == torch.float32
    v = out.double().numpy().ravel()
    if op.startswith("gaussian"):
        mean, std = attrs["mean"], attrs["std"]
    else:
        lo, hi = attrs["min"], attrs["max"]
        assert v.min() >= lo and v.max() < hi
        mean, std = (lo + hi) / 2, (hi - lo) / np.sqrt(12)
    n = v.size
    assert abs(v.mean() - mean) < 5 * std / np.sqrt(n)
    assert abs(v.var() - std ** 2) < 5 * std ** 2 * np.sqrt(2.0 / n)
    again = _run(op, dict(attrs, input_dim_idx=0, output_dim_idx=0), ref)
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    other = _run(op, dict(attrs, input_dim_idx=0, output_dim_idx=0), ref,
                 seed=1)
    assert not np.array_equal(out.numpy(), other.numpy())


def test_random_crop_takes_sub_windows():
    x = np.arange(3 * 9 * 11, dtype=np.float32).reshape(3, 9, 11)
    seen = set()
    for seed in range(12):
        out = _run("random_crop", {"shape": [4, 5]}, x, seed=seed).numpy()
        assert out.shape == (3, 4, 5)
        r0, c0 = divmod(int(out[0, 0, 0]), 11)
        np.testing.assert_array_equal(out, x[:, r0:r0 + 4, c0:c0 + 5])
        seen.add((r0, c0))
    assert len(seen) > 1


def test_pyramid_hash_training_dropout_holds_its_contract():
    """With is_training and drop_out_percent, each n-gram is kept with
    probability 1 - p from the op's generator (the JAX op draws from
    jax.random): the kept share within 5 sigma, dropped rows zero, kept
    rows the inference rows, the same draws from the same run seed."""
    rng = np.random.RandomState(12)
    x = rng.randint(0, 2 ** 31 - 1, size=(64, 20)).astype(np.int64)
    w = rng.randn(97, 4).astype(np.float32)
    attrs = {"num_emb": 8, "rand_len": 4, "space_len": 97,
             "pyramid_layer": 3, "drop_out_percent": 0.3, "is_training": 1}
    out, keep, _ = _run("pyramid_hash", attrs, x, w, None, None, None)
    full, valid, _ = _run("pyramid_hash", dict(attrs, is_training=0), x, w,
                          None, None, None)
    k, v = keep.numpy().astype(bool), valid.numpy().astype(bool)
    assert not (k & ~v).any()
    n = v.sum()
    assert abs(k.sum() / n - 0.7) < 5 * np.sqrt(0.7 * 0.3 / n)
    np.testing.assert_array_equal(out.numpy()[~k], 0.0)
    np.testing.assert_array_equal(out.numpy()[k], full.numpy()[k])
    again = _run("pyramid_hash", attrs, x, w, None, None, None)[1]
    np.testing.assert_array_equal(again.numpy(), keep.numpy())
