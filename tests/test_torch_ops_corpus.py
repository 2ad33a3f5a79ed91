"""The op corpus (`tests/test_ops_{tensor,math,nn,optimizer,sequence,
rnn,detection,detection3,vision,misc2}.py`) run through the port's
registry, on the CPU.

One case for every `OpCase` of those files whose op type the port
registers, each its own test (a case the JAX suite marks `slow` for its
finite-difference gradients runs here unmarked: the gradient here is
`jax.vjp`), the sequence ops of `tests/test_ops_text.py`
(`sequence_topk_avg_pooling`, `sequence_erase`), `tree_conv` of the
text corpus (the eager TreeConv layer runs it), and `unpool` as
`tests/test_ops_vision.py::test_unpool_values` builds its case, every
other case of `tests/test_ops_text.py` (`CASES`: the CTR, text and loss
ops; `CASES2`: the fused ones), and the fused cases that
`tests/test_ops_coverage.py`'s test functions build (captured by
running those functions with its `check_output` recording the case):

* forward: the case's inputs (numpy) through the port's registered
  function, against the case's numpy oracle at the corpus's own
  tolerance, and against the JAX package's registered function on the
  same inputs (same tolerance);
* float inputs, where the case checks gradients: `torch.autograd`
  gradients of sum(out · cotangent) against `jax.vjp` of the JAX op
  with the same cotangent (uniform [0.5, 1.5), seeded), rtol 1e-4 and
  an absolute floor of 1e-6 of the largest gradient.

The corpus files are read, never edited.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ops_detection
import test_ops_detection3
import test_ops_coverage
import test_ops_math
import test_ops_misc2
import test_ops_nn
import test_ops_optimizer
import test_ops_rnn
import test_ops_sequence
import test_ops_tensor
import test_ops_text
import test_ops_vision
from op_test import OpCase
from paddle_tpu.core import registry as jregistry
from paddle_tpu_torch.core import registry as tregistry

FAMILIES = {"tensor": test_ops_tensor, "math": test_ops_math,
            "nn": test_ops_nn, "optimizer": test_ops_optimizer,
            "sequence": test_ops_sequence, "rnn": test_ops_rnn,
            "detection": test_ops_detection,
            "detection3": test_ops_detection3, "misc2": test_ops_misc2}


def _unwrap(case):
    """An OpCase, also from inside a pytest.param."""
    return case.values[0] if hasattr(case, "values") else case


#: the sequence ops of the text corpus
TEXT_CASES = [c for c in test_ops_text.CASES2
              if c.op == "sequence_topk_avg_pooling"] + [
    OpCase("sequence_erase",
           {"X": np.array([[2, 0, 5, 2, 7], [9, 2, 2, 1, 4]], np.int64),
            "Lengths": np.array([5, 3], np.int64)},
           attrs={"tokens": [2, 0]},
           oracle=lambda X, Lengths, attrs: (
               np.array([[5, 7, 0, 0, 0], [9, 0, 0, 0, 0]]),
               np.array([2, 1], np.int32)),
           check_grad=False)]
def _unpool_values_case():
    """tests/test_ops_vision.py::test_unpool_values's case."""
    x = np.random.RandomState(5).uniform(-1, 1, (1, 1, 2, 2)).astype(
        np.float32)
    idx = np.array([[[[0, 5], [10, 15]]]], np.int32)
    exp = np.zeros((1, 1, 4, 4), np.float32)
    for i, (r, c) in enumerate(((0, 0), (1, 1), (2, 2), (3, 3))):
        exp[0, 0, r, c] = x.reshape(-1)[i]
    return OpCase("unpool", {"X": x, "Indices": idx},
                  attrs={"ksize": [2, 2], "strides": [2, 2],
                         "paddings": [0, 0]},
                  oracle=lambda X, Indices, attrs: exp, name="unpool_values")


def _coverage_fused_cases():
    """The OpCases of tests/test_ops_coverage.py's fused tests, recorded
    by running each with its `check_output` capturing the case (no
    result is read by these tests)."""
    cases = []
    saved = test_ops_coverage.check_output
    test_ops_coverage.check_output = cases.append
    try:
        for name in ("test_fusion_seqpool_concat",
                     "test_fusion_seqpool_concat_sqrt",
                     "test_fusion_transpose_flatten_concat",
                     "test_fusion_lstm_numpy_recurrence",
                     "test_fusion_seqconv_eltadd_relu",
                     "test_fusion_seqpool_cvm_concat",
                     "test_fused_embedding_fc_lstm"):
            getattr(test_ops_coverage, name)()
    finally:
        test_ops_coverage.check_output = saved
    for c in cases:
        c.name = c.name + "_coverage"
    return cases


#: the text corpus's fused cases (CASES2) but the sequence op above
FUSED_CASES = [c for c in test_ops_text.CASES2
               if c.op != "sequence_topk_avg_pooling"] + \
    _coverage_fused_cases()
#: the vision corpus (every case, the slow-marked one too), unpool, the
#: text corpus's CTR, text and loss cases (tree_conv for nn.TreeConv),
#: and the fused ones
LAYER_CASES = [("vision", _unwrap(c)) for c in test_ops_vision.CASES] + [
    ("vision", _unpool_values_case())] + [
    ("text", _unwrap(c)) for c in test_ops_text.CASES] + [
    ("fused", c) for c in FUSED_CASES]
CASES = [(fam, _unwrap(case)) for fam, mod in FAMILIES.items()
         for case in mod.CASES if tregistry.has_op(_unwrap(case).op)] + [
    ("text", case) for case in TEXT_CASES] + LAYER_CASES
#: the corpus's op types the port leaves out: `sync_batch_norm` waits
#: for the collectives
NOT_PORTED = {"sync_batch_norm"}
GRAD_RTOL = 1e-4


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _out_slots(impl, case):
    """(slot name, count or None) of the outputs the case checks, in
    registry order (op_test.py's `_build` rule)."""
    out = []
    for slot in impl.out_slots:
        if case.out_slots is not None and slot.name not in case.out_slots:
            continue
        if slot.variadic:
            n = case.variadic_out.get(slot.name)
            if n is not None:
                out.append((slot.name, n))
        else:
            out.append((slot.name, None))
    return out


def _pick(result, impl, slots):
    """The checked outputs of an op's result, flattened in slot order."""
    if not isinstance(result, (tuple, list)):
        result = (result,)
    by_slot = dict(zip([s.name for s in impl.out_slots], result))
    out = []
    for name, n in slots:
        v = by_slot[name]
        out.extend(list(v) if n is not None else [v])
    return out


def _args(impl, inputs, convert):
    args = []
    for slot in impl.in_slots:
        if slot.name not in inputs:
            args.append([] if slot.variadic else None)
        elif slot.variadic:
            args.append([convert(a) for a in inputs[slot.name]])
        else:
            args.append(convert(inputs[slot.name]))
    return args


def _grad_leaves(impl, case):
    """[(slot, index or None)] of the float inputs whose gradients are
    checked: the case's grad_inputs, else every float input."""
    want = case.grad_inputs
    leaves = []
    for slot in impl.in_slots:
        if slot.name not in case.inputs:
            continue
        if want is not None and slot.name not in want:
            continue
        val = case.inputs[slot.name]
        if slot.variadic:
            leaves += [(slot.name, j) for j, a in enumerate(val)
                       if _is_float(a)]
        elif _is_float(val):
            leaves.append((slot.name, None))
    return leaves


def _port_run(case, inputs):
    impl = tregistry.get_op(case.op)
    ctx = tregistry.OpContext(dict(case.attrs), 0, True, 0, "cpu")
    return impl, impl.fn(ctx, *_args(impl, inputs, lambda a: a))


def _jax_run(case, inputs):
    impl = jregistry.get_op(case.op)
    ctx = jregistry.OpContext(dict(case.attrs), jax.random.key(0), True, 0)
    return impl, impl.fn(ctx, *_args(impl, inputs, lambda a: a))


def _torch(a):
    return torch.from_numpy(np.array(a, copy=True))


def _with(inputs, leaves, values):
    out = {k: list(v) if isinstance(v, (list, tuple)) else v
           for k, v in inputs.items()}
    for (name, j), v in zip(leaves, values):
        if j is None:
            out[name] = v
        else:
            out[name][j] = v
    return out


def test_corpus_op_types_are_ported():
    want = {_unwrap(c).op for mod in FAMILIES.values() for c in mod.CASES}
    assert {c.op for fam, c in CASES
            if fam not in ("text", "vision", "fused")} == want - NOT_PORTED
    assert {c.op for c in TEXT_CASES} == {"sequence_topk_avg_pooling",
                                          "sequence_erase"}
    assert sorted({c.op for f, c in LAYER_CASES if f == "vision"}) == [
        "affine_grid", "deformable_conv", "deformable_conv_v1",
        "deformable_psroi_pooling", "max_pool2d_with_index", "prroi_pool",
        "psroi_pool", "spectral_norm", "spp", "unpool"]
    assert {c.op for f, c in LAYER_CASES if f == "text"} == {
        _unwrap(c).op for c in test_ops_text.CASES}
    assert {c.op for f, c in LAYER_CASES if f == "fused"} == {
        "fused_elemwise_activation", "fused_embedding_seq_pool",
        "fusion_seqpool_concat", "fusion_transpose_flatten_concat",
        "fusion_lstm", "fusion_seqconv_eltadd_relu",
        "fusion_seqpool_cvm_concat", "fused_embedding_fc_lstm"}
    assert len(CASES) >= 290


def _float_outputs(case, slots, got):
    """Indices of the checked outputs that carry a gradient: float ones,
    within the case's grad_outputs."""
    names = [name for name, n in slots for _ in range(n or 1)]
    return [i for i, (g, name) in enumerate(zip(got, names))
            if np.issubdtype(g.dtype, np.floating)
            and (case.grad_outputs is None or name in case.grad_outputs)]


def _jax_side(case, np_in, slots, leaves, float_out, cots):
    """The JAX op's checked outputs and, given leaves, the vjp of its
    float outputs with `cots`: one jitted function a case (the JAX
    executor's own mode; eager dispatch compiles every primitive)."""
    j_in = {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
            else jnp.asarray(v) for k, v in np_in.items()}

    def fwd(*vals):
        jimpl, r = _jax_run(case, _with(j_in, leaves, vals))
        return tuple(_pick(r, jimpl, slots))

    def run(*vals):
        if not float_out:
            return fwd(*vals), ()
        _, vjp = jax.vjp(lambda *v: tuple(fwd(*v)[i] for i in float_out),
                         *vals)
        return fwd(*vals), vjp(tuple(jnp.asarray(c) for c in cots))

    vals = [jnp.asarray(np_in[n] if j is None else np_in[n][j])
            for n, j in leaves]
    outs, grads = jax.jit(run)(*vals)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("fam,case", CASES,
                         ids=[f"{f}-{c.name}" for f, c in CASES])
def test_op_case(fam, case):
    check_case(case)


def check_case(case):
    """The port's op against the case's oracle and the JAX op (forward)
    and against jax.vjp (gradients), as set out above."""
    np_in = {k: [np.asarray(a) for a in v] if isinstance(v, (list, tuple))
             else np.asarray(v) for k, v in case.inputs.items()}
    t_in = {k: [_torch(a) for a in v] if isinstance(v, list) else _torch(v)
            for k, v in np_in.items()}

    impl, result = _port_run(case, t_in)
    slots = _out_slots(impl, case)
    got = [o.detach().numpy() for o in _pick(result, impl, slots)]
    leaves = _grad_leaves(impl, case) if case.check_grad else []
    float_out = _float_outputs(case, slots, got) if leaves else []
    rng = np.random.RandomState(1234)
    cots = [rng.uniform(0.5, 1.5, size=got[i].shape).astype(got[i].dtype)
            for i in float_out]
    want, jgrads = _jax_side(case, np_in, slots, leaves, float_out, cots)

    # forward against the numpy oracle, at the corpus's tolerance
    if case.oracle is not None:
        expected = case.oracle(**np_in, attrs=case.attrs)
        if not isinstance(expected, (tuple, list)):
            expected = (expected,)
        checked = 0
        for g, e in zip(got, expected):
            if e is None:
                continue
            np.testing.assert_allclose(
                np.asarray(g, dtype=np.asarray(e).dtype), e, atol=case.atol,
                rtol=case.rtol, err_msg=f"{case.name}: port vs oracle")
            checked += 1
        assert checked
    # forward against the JAX op on the same inputs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (case.name, g.shape, w.shape)
        np.testing.assert_allclose(
            np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64),
            atol=case.atol, rtol=case.rtol,
            err_msg=f"{case.name}: port vs JAX")
    if not float_out:
        return

    # the port: autograd of sum(out . cot)
    t_leaves = [_torch(np_in[n] if j is None else np_in[n][j])
                .requires_grad_() for n, j in leaves]
    with torch.enable_grad():
        impl, res = _port_run(case, _with(t_in, leaves, t_leaves))
        outs = _pick(res, impl, slots)
        loss = sum((outs[i] * _torch(c)).sum()
                   for i, c in zip(float_out, cots))
        tg = (torch.autograd.grad(loss, t_leaves, allow_unused=True)
              if loss.requires_grad else [None] * len(t_leaves))
    for (n, j), leaf, a, b in zip(leaves, t_leaves, tg, jgrads):
        a = np.zeros(tuple(leaf.shape), b.dtype) if a is None else a.numpy()
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(
            a, b, rtol=GRAD_RTOL, atol=1e-6 * scale,
            err_msg=f"{case.name}: d/d{n}{'' if j is None else j}")
