"""The sequence slice's ops on the card against the CPU: `lstm` (the
book SRL's relu candidate and sigmoid cell, peepholes, reversed), `gru`
(with H0), `linear_chain_crf`, `crf_decoding`, `beam_search` and a
`While` beam decode.

The same numpy inputs on the card and on the CPU (TF32 off), in float64
and in float32: forward outputs within 1e-10 (float64) / 1e-5 (float32)
of their max, the float inputs' gradients of sum(out · cotangent) the
same, Viterbi paths and beam ids equal. `beam_search` runs a case built
to tie (frozen beams, a uniform row) and must select what the CPU
selects. The While program (gru_unit, beam_search, array_write,
beam_search_decode) gives the CPU's ids on the card, and reads its
condition once an iteration on the host.

Marked `cuda`: it skips without a GPU. It imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_sequence_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import static
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.registry import OpContext, get_op
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.ops import control_flow

pytestmark = pytest.mark.cuda

R = np.random.RandomState(23)
B, T, D = 4, 7, 16
LENS = np.array([7, 3, 1, 5], np.int64)
TOL = {np.float64: 1e-10, np.float32: 1e-5}


def _f(*shape, s=0.5):
    return R.uniform(-s, s, size=shape)


#: op, inputs in slot order (float ones as float64), attrs, indices of
#: the float inputs whose gradient is checked
CASES = {
    "lstm_srl": ("lstm", (_f(B, T, 4 * D), _f(D, 4 * D), _f(1, 7 * D), None,
                          None, LENS),
                 {"candidate_activation": "relu",
                  "cell_activation": "sigmoid", "is_reverse": True},
                 [0, 1, 2]),
    "gru_h0": ("gru", (_f(B, T, 3 * D), _f(D, 3 * D), _f(1, 3 * D),
                       _f(B, D), LENS), {}, [0, 1, 2, 3]),
    "linear_chain_crf": ("linear_chain_crf",
                         (_f(B, T, 6, s=2.0), _f(8, 6),
                          R.randint(0, 6, (B, T)), LENS), {}, [0, 1]),
    "crf_decoding": ("crf_decoding", (_f(B, T, 6, s=2.0), _f(8, 6), None,
                                      LENS), {}, []),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card against the CPU")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _tensor(a, dtype, device):
    if a is None:
        return None
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(dtype)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _run(op, args, attrs, dtype, device, grads):
    impl = get_op(op)
    ts = [_tensor(a, dtype, device) for a in args]
    leaves = [ts[i].requires_grad_() for i in grads]
    with torch.enable_grad():
        out = impl.fn(OpContext(dict(attrs), 0, True, 0, device), *ts)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        floats = [o for o in out if o.is_floating_point()]
        g = []
        if leaves:
            rng = np.random.RandomState(1)
            loss = sum((o * _tensor(rng.uniform(0.5, 1.5, tuple(o.shape)),
                                    dtype, device)).sum() for o in floats)
            g = torch.autograd.grad(loss, leaves)
    return ([o.detach().cpu().numpy() for o in out],
            [x.cpu().numpy() for x in g])


def _close(got, want, tol):
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1e-30))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_op_on_the_card_matches_the_cpu(cuda, case, dtype):
    op, args, attrs, grads = CASES[case]
    got, gg = _run(op, args, attrs, dtype, "cuda", grads)
    want, wg = _run(op, args, attrs, dtype, "cpu", grads)
    for a, b in zip(got + gg, want + wg):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_beam_search_on_the_card_matches_the_cpu(cuda, dtype):
    K, V, eos = 3, 5, 2
    tie = (np.array([[eos, 4, eos], [eos, eos, eos]], np.int32),
           np.array([[-1.0, -0.5, -1.0], [-2.0, -2.0, -2.0]]),
           np.concatenate([np.zeros((1, K, V)), _f(1, K, V)]))
    wide = (R.randint(0, 1000, (16, 4)).astype(np.int32), _f(16, 4, s=3.0),
            _f(16, 4, 1000, s=4.0))
    for args, k in ((tie, K), (wide, 4)):
        attrs = {"beam_size": k, "end_id": eos}
        got, _ = _run("beam_search", args, attrs, dtype, "cuda", [])
        want, _ = _run("beam_search", args, attrs, dtype, "cpu", [])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        _close(got[1], want[1], TOL[dtype])


def _while_decode(dtype):
    B_, K_, V_, H_, steps = 4, 3, 50, 16, 6
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        h = static.fill_constant([B_ * K_, H_], dtype, 0.1)
        pre_ids = static.fill_constant([B_, K_], "int32", 1)
        pre_scores = static.assign(np.array(
            [[0.0] + [-1e9] * (K_ - 1)] * B_, dtype))
        ids_arr = static.create_array(steps, [B_, K_], "int32")
        par_arr = static.create_array(steps, [B_, K_], "int32")
        base = static.reshape(static.range(0, B_ * K_, K_, "int32"), [B_, 1])
        i = static.fill_constant([1], "int64", 0)
        n = static.fill_constant([1], "int64", steps)
        cond = static.less_than(i, n)
        w = static.While(cond)
        with w.block():
            emb = static.embedding(static.reshape(static.assign(pre_ids),
                                                  [B_ * K_, 1]),
                                   [V_, 3 * H_], dtype=dtype)
            h_new, _, _ = static.gru_unit(emb, static.assign(h), 3 * H_)
            logits = static.reshape(static.fc(h_new, V_), [B_, K_, V_])
            sel, sc, par = static.beam_search(
                static.assign(pre_ids), static.assign(pre_scores), logits,
                K_, 2)
            static.assign(static.array_write(sel, i, ids_arr), ids_arr)
            static.assign(static.array_write(par, i, par_arr), par_arr)
            static.assign(sel, pre_ids)
            static.assign(sc, pre_scores)
            static.assign(static.gather(h_new, static.reshape(
                static.elementwise_add(par, base), [B_ * K_])), h)
            ni = static.increment(static.assign(i), value=1)
            static.assign(ni, i)
            static.assign(static.less_than(ni, n), cond)
        out = static.beam_search_decode(ids_arr, par_arr, pre_scores,
                                        end_id=2)
    return main, startup, [v.name for v in out], steps


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_while_beam_decode_on_the_card_matches_the_cpu(cuda, dtype):
    main, startup, fetch, steps = _while_decode(dtype)
    init = Scope()
    Executor("cpu").run(startup, scope=init)
    runs = {}
    for dev in ("cuda", "cpu"):
        scope = Scope()
        for v in main.list_vars():
            if v.persistable and init.has(v.name):
                scope.set(v.name, init.get(v.name).to(dev))
        control_flow.reset_host_reads()
        out = Executor(dev).run(main, fetch_list=fetch, scope=scope,
                                training=False)
        runs[dev] = (out, dict(control_flow.host_reads))
    (ids, scores), reads = runs["cuda"]
    (cids, cscores), _ = runs["cpu"]
    np.testing.assert_array_equal(ids, cids)
    _close(scores, cscores, TOL[np.dtype(dtype).type])
    assert reads["while"] == steps + 1
    assert reads["while_iterations"] == steps
