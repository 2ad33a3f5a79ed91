"""Control flow in the port (`static/control_flow.py`, `ops/control_flow.py`,
sub-blocks in `core/lowering.py`) against the JAX package, on the CPU.

* The programs of `tests/test_control_flow.py` and `tests/test_rnn_api.py`
  built in both packages: the same program (`to_dict()`), the JAX
  startup's weights moved into the port by name, the same feeds; fetches
  equal (integers and the exact sums) or within rtol 1e-5 (float32 RNN
  outputs; 1e-6 absolute where a value is zero-masked). StaticRNN with an
  fc trains 3 Adam steps, each from the JAX state: loss within rtol 1e-5,
  parameters within 3% of lr.
* `while` under autodiff raises in both packages when the loss depends on
  a parameter through the loop's carry, and runs when it does not.
* A carried var that changes shape or dtype raises, with the op's
  callsite; on meta tensors (`registry.abstract_eval` with the block)
  `while` checks one body pass, `conditional_block` both branches, `scan`
  one step, and no value is read.
* `beam_search` on a case built to tie (frozen beams, uniform rows)
  selects what `lax.top_k` selects; `beam_search_decode` and the eager
  `beam_search` match.
* A `__model__.json` with a While sub-block saved by either package runs
  in the other (outputs within rtol 1e-5).
* Every op context, a sub-block's included, carries the Executor's
  device, and a sub-block's ops are numbered base + 1000 (i + 1) + j.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.enforce import EnforceError, OpRunError
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.ops import beam_search as tbeam
from paddle_tpu_torch.utils.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

SIDES = {"jax": (jir, pt.static, pt.optimizer, JParamAttr),
         "port": (tir, tstatic, topt, TParamAttr)}
R = np.random.RandomState(9)


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


def _build(side, fn):
    ir, static, opt, param_attr = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        fetch = fn(static, opt, param_attr)
    return main, startup, [f if isinstance(f, str) else f.name
                           for f in fetch]


def _persistables(program, scope):
    return {v.name: scope.find_np(v.name) for v in program.list_vars()
            if v.persistable and scope.has(v.name)}


def _run_both(fn, feeds):
    """Build `fn` in both packages (the same program), run the JAX
    startup, move its state into the port, run every feed in both."""
    jmain, jstart, fetch = _build("jax", fn)
    tmain, tstart, tfetch = _build("port", fn)
    assert tfetch == fetch
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    jscope = JScope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    tscope = scope_from_jax(_persistables(jmain, jscope), Scope(), "cpu")
    texe = TExecutor("cpu")
    out = []
    for feed in feeds:
        j = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        t = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        out.append(([np.asarray(a) for a in j], [np.asarray(a) for a in t]))
    return out


def _equal(pairs, rtol=0.0, atol=0.0):
    for j, t in pairs:
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert a.shape == b.shape, (a.shape, b.shape)
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=rtol,
                                       atol=atol)


# --- the programs of tests/test_control_flow.py ---

def _while_accumulates(S, opt, PA):
    n = S.fill_constant([1], "int64", 10)
    i = S.fill_constant([1], "int64", 0)
    acc = S.fill_constant([1], "float32", 0.0)
    cond = S.less_than(i, n)
    w = S.While(cond)
    with w.block():
        ni = S.increment(S.assign(i), value=1)
        S.assign(ni, i)
        S.assign(S.elementwise_add(acc, S.cast(ni, "float32")), acc)
        S.assign(S.less_than(ni, n), cond)
    return [acc, i]


def test_while_accumulates_like_jax():
    ((j, t),) = _run_both(_while_accumulates, [{}])
    _equal([(j, t)])
    assert float(t[0][0]) == 55.0 and int(t[1][0]) == 10


def test_while_requires_cond_update():
    with tir.program_guard(tir.Program(), tir.Program()):
        i = tstatic.fill_constant([1], "int64", 0)
        n = tstatic.fill_constant([1], "int64", 3)
        w = tstatic.While(tstatic.less_than(i, n))
        with pytest.raises(EnforceError, match="condition"):
            with w.block():
                tstatic.assign(tstatic.increment(tstatic.assign(i)), i)


T_, B_, D_ = 5, 3, 4
XV = R.randn(T_, B_, D_).astype(np.float32)


def _static_rnn_cumsum(S, opt, PA):
    x = S.data("x", [T_, B_, D_], "float32", append_batch_size=False)
    h0 = S.fill_constant([B_, D_], "float32", 0.0)
    rnn = S.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(init=h0)
        nh = S.elementwise_add(h, x_t)
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    return [rnn()]


def test_static_rnn_cumsum_like_jax():
    ((j, t),) = _run_both(_static_rnn_cumsum, [{"x": XV}])
    _equal([(j, t)], rtol=1e-6)
    np.testing.assert_allclose(t[0], np.cumsum(XV, axis=0), rtol=1e-5)


def _dynamic_rnn(S, opt, PA):
    x = S.data("x", [3, 6, 2], "float32", append_batch_size=False)
    ln = S.data("lens", [3], "int64", append_batch_size=False)
    h0 = S.fill_constant([3, 2], "float32", 0.0)
    drnn = S.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x, lens=ln)
        h = drnn.memory(init=h0)
        nh = S.elementwise_add(h, x_t)
        drnn.update_memory(h, nh)
        drnn.output(nh)
    return [drnn()]


def test_dynamic_rnn_freezes_past_length_like_jax():
    feed = {"x": np.ones((3, 6, 2), np.float32),
            "lens": np.array([2, 6, 4], np.int64)}
    ((j, t),) = _run_both(_dynamic_rnn, [feed])
    _equal([(j, t)])
    np.testing.assert_array_equal(t[0][:, :, 0], [[1, 2, 0, 0, 0, 0],
                                                  [1, 2, 3, 4, 5, 6],
                                                  [1, 2, 3, 4, 0, 0]])


def _cond(S, opt, PA):
    a = S.data("a", [1], "float32", append_batch_size=False)
    pred = S.less_than(a, S.fill_constant([1], "float32", 0.0))
    return [S.cond(pred, lambda: S.scale(a, scale=-1.0),
                   lambda: S.scale(a, scale=2.0))]


def test_cond_branches_like_jax():
    out = _run_both(_cond, [{"a": np.array([-3.0], np.float32)},
                            {"a": np.array([3.0], np.float32)}])
    _equal(out)
    assert [float(t[0][0]) for _, t in out] == [3.0, 6.0]


def _switch(S, opt, PA):
    step = S.data("step", [1], "int64", append_batch_size=False)
    lr = S.fill_constant([1], "float32", 0.0)
    b1 = S.less_than(step, S.fill_constant([1], "int64", 100))
    b2 = S.less_than(step, S.fill_constant([1], "int64", 200))
    with S.Switch() as sw:
        with sw.case(b1):
            S.assign(S.fill_constant([1], "float32", 0.1), lr)
        with sw.case(b2):
            S.assign(S.fill_constant([1], "float32", 0.01), lr)
        with sw.default():
            S.assign(S.fill_constant([1], "float32", 0.001), lr)
    return [lr]


def test_switch_lr_schedule_like_jax():
    out = _run_both(_switch, [{"step": np.array([s], np.int64)}
                              for s in (50, 150, 500)])
    _equal(out)
    assert [float(t[0][0]) for _, t in out] == pytest.approx(
        [0.1, 0.01, 0.001])


def _case(S, opt, PA):
    x = S.data("x", [1], "float32", append_batch_size=False)
    zero = S.fill_constant([1], "float32", 0.0)
    one = S.fill_constant([1], "float32", 1.0)
    return [S.case(
        [(S.less_than(x, zero), lambda: S.fill_constant([1], "float32", -1.0)),
         (S.greater_than(x, one), lambda: S.fill_constant([1], "float32", 2.0))],
        default=lambda: S.fill_constant([1], "float32", 0.5))]


def test_case_api_like_jax():
    out = _run_both(_case, [{"x": np.array([v], np.float32)}
                            for v in (-5.0, 3.0, 0.5)])
    _equal(out)
    assert [float(t[0][0]) for _, t in out] == [-1.0, 2.0, 0.5]


def _static_rnn_fc(S, opt, PA):
    x = S.data("x", [8, 4, 3], "float32", append_batch_size=False)
    y = S.data("y", [8, 1], "float32", append_batch_size=False)
    xt_major = S.transpose(x, [1, 0, 2])
    h0 = S.fill_constant([8, 1], "float32", 0.0)
    rnn = S.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(xt_major)
        h = rnn.memory(init=h0)
        nh = S.elementwise_add(h, S.fc(x_t, 1, bias_attr=False))
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    last = S.slice(rnn(), axes=[0], starts=[3], ends=[4])
    loss = S.mean(S.square(S.reshape(last, [8, 1]) - y))
    opt.Adam(learning_rate=0.05).minimize(loss)
    return [loss]


def test_static_rnn_with_params_trains_like_jax():
    """Three Adam steps through the scan (closure-read weights), each
    from the JAX state; then the port alone fits the recurrence."""
    xv = R.randn(8, 4, 3).astype(np.float32)
    yv = np.sum(xv @ R.randn(3, 1).astype(np.float32), axis=1)
    feed = {"x": xv, "y": yv}
    jmain, jstart, fetch = _build("jax", _static_rnn_fc)
    tmain, tstart, _ = _build("port", _static_rnn_fc)
    assert tmain.to_dict() == jmain.to_dict()
    jscope, jexe, texe = JScope(), pt.Executor(), TExecutor("cpu")
    jexe.run(jstart, scope=jscope)
    params = [v.name for v in tmain.all_parameters()]
    for _ in range(3):
        state = _persistables(jmain, jscope)
        tscope = scope_from_jax(state, Scope(), "cpu", program=tmain)
        (jl,) = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        (tl,) = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        want = _persistables(jmain, jscope)
        got = scope_to_numpy(tscope, params)
        for p in params:
            np.testing.assert_allclose(got[p], want[p], rtol=0,
                                       atol=3e-2 * 0.05, err_msg=p)
    scope = Scope()
    texe.run(tstart, scope=scope)
    losses = [float(texe.run(tmain, feed=feed, fetch_list=fetch,
                             scope=scope)[0]) for _ in range(60)]
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])


# --- the programs of tests/test_rnn_api.py ---

def _rnn_cells(S, opt, PA):
    x = S.data("rc_x", [2, 4, 6], "float32", append_batch_size=False)
    ln = S.data("rc_ln", [2], "int64", append_batch_size=False)
    out, last = S.rnn(S.GRUCell(hidden_size=5), x, sequence_length=ln)
    out2, (h2, c2) = S.rnn(S.LSTMCell(hidden_size=5), x)
    outr, _ = S.rnn(S.GRUCell(hidden_size=5), x, is_reverse=True)
    return [out, last, out2, h2, c2, outr]


def test_rnn_cells_and_masking_like_jax():
    feed = {"rc_x": R.randn(2, 4, 6).astype(np.float32),
            "rc_ln": np.array([4, 2], np.int64)}
    ((j, t),) = _run_both(_rnn_cells, [feed])
    _equal([(j, t)], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t[1][1], t[0][1, 1], rtol=1e-6)
    assert np.abs(t[0][1, 2:]).max() == 0.0


V_, K_, BB_ = 5, 2, 2


def _dynamic_decode(S, opt, PA):
    h0 = S.data("dd_h0", [BB_, 8], "float32", append_batch_size=False)

    class TableCell(S.RNNCell):
        hidden_size = 8

        def call(self, inputs, states):
            return inputs, states

    W = np.full((V_, V_), -5.0, np.float32)
    for t in range(V_):
        W[t, (t + 1) % V_] = 5.0
    W[3, 4] = 8.0

    def output_fn(out):
        wv = S.assign(W)
        return S.matmul(out, wv)

    dec = S.BeamSearchDecoder(
        TableCell(), start_token=0, end_token=4, beam_size=K_,
        embedding_fn=lambda tok: S.one_hot(S.reshape(tok, [-1]), V_),
        output_fn=output_fn)
    return list(S.dynamic_decode(dec, inits=h0, max_step_num=6))


def test_dynamic_decode_beam_search_like_jax():
    ((j, t),) = _run_both(_dynamic_decode,
                          [{"dd_h0": np.zeros((BB_, 8), np.float32)}])
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=1e-6)
    assert list(t[0][0, 0, :4]) == [1, 2, 3, 4] and (t[0][0, 0, 4:] == 4).all()


def test_rnn_cell_weights_are_tied():
    with tir.program_guard(tir.Program()):
        x = tstatic.data("wt_x", [2, 6, 4], "float32",
                         append_batch_size=False)
        tstatic.rnn(tstatic.GRUCell(hidden_size=3), x)
        names = [v for v in tir.default_main_program().global_block().vars
                 if "GRUCell" in v]
    assert len(names) == 3, names


# --- while under autodiff, carry discipline, meta evaluation ---

def _while_of_params(depends):
    def fn(S, opt, PA):
        x = S.data("x", [2, 3], "float32", append_batch_size=False)
        h = S.fc(x, 3, param_attr=PA(name="w0"))
        acc = S.fill_constant([2, 3], "float32", 0.0)
        acc.stop_gradient = False
        S.assign(h, acc)
        i = S.fill_constant([1], "int64", 0)
        n = S.fill_constant([1], "int64", 3)
        cond = S.less_than(i, n)
        w = S.While(cond)
        with w.block():
            y = S.fc(S.assign(acc), 3, param_attr=PA(name="w1"),
                     bias_attr=False, act="tanh")
            S.assign(y, acc)
            ni = S.increment(S.assign(i), value=1)
            S.assign(ni, i)
            S.assign(S.less_than(ni, n), cond)
        loss = S.mean(acc if depends else h)
        opt.SGD(0.1).minimize(loss)
        return [loss]
    return fn


def test_while_gradient_raises_like_jax_when_the_loss_reads_the_carry():
    feed = {"x": np.ones((2, 3), np.float32)}
    jmain, jstart, fetch = _build("jax", _while_of_params(True))
    tmain, tstart, _ = _build("port", _while_of_params(True))
    assert tmain.to_dict() == jmain.to_dict()
    jscope, jexe = JScope(), pt.Executor()
    jexe.run(jstart, scope=jscope)
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    tscope = scope_from_jax(_persistables(jmain, jscope), Scope(), "cpu")
    with pytest.raises(OpRunError, match="reverse-mode differentiation "
                       "does not work for a while loop"):
        TExecutor("cpu").run(tmain, feed=feed, fetch_list=fetch,
                             scope=tscope)
    # nothing was updated
    np.testing.assert_array_equal(tscope.find_np("w1"), jscope.find_np("w1"))


def test_while_runs_under_autodiff_when_the_loss_skips_the_carry():
    out = _run_both(_while_of_params(False),
                    [{"x": np.ones((2, 3), np.float32)}] * 2)
    _equal(out, rtol=1e-6)


def _carry_changes(S, opt, PA):
    acc = S.fill_constant([1], "float32", 0.0)
    i = S.fill_constant([1], "int64", 0)
    n = S.fill_constant([1], "int64", 2)
    cond = S.less_than(i, n)
    w = S.While(cond)
    with w.block():
        S.assign(S.concat([acc, acc], axis=0), acc)
        ni = S.increment(S.assign(i), value=1)
        S.assign(ni, i)
        S.assign(S.less_than(ni, n), cond)
    return [acc]


def test_a_carry_that_changes_shape_raises_with_the_callsite():
    jmain, jstart, fetch = _build("jax", _carry_changes)
    with pytest.raises(Exception):
        pt.Executor().run(jmain, fetch_list=fetch, scope=JScope())
    tmain, _, _ = _build("port", _carry_changes)
    with pytest.raises(OpRunError) as e:
        TExecutor("cpu").run(tmain, fetch_list=fetch, scope=Scope())
    msg = str(e.value)
    assert "error running op 'while'" in msg
    assert "from (1,)" in msg and "to (2,)" in msg
    assert "test_torch_control_flow.py" in msg      # the While's callsite


def _ops_of(program, op_type):
    return [(b, op) for b in program.blocks for op in b.ops
            if op.type == op_type]


def _abstract(program, op_type):
    ((block, op),) = _ops_of(program, op_type)
    env, _ = tregistry.abstract_inputs(op, block)
    return tregistry.abstract_eval(op, env, block), env, op


def test_control_flow_ops_evaluate_on_meta_tensors():
    tmain, _, _ = _build("port", _while_accumulates)
    out, env, op = _abstract(tmain, "while")
    for n in op.outputs["CarryOut"]:
        assert out[n].is_meta and out[n].shape == env[n].shape
    tmain, _, _ = _build("port", _carry_changes)
    with pytest.raises(EnforceError, match="changed"):
        _abstract(tmain, "while")
    tmain, _, _ = _build("port", _cond)
    out, _, op = _abstract(tmain, "conditional_block")
    assert out[op.outputs["Out"][0]].shape == (1,)
    tmain, _, _ = _build("port", _static_rnn_cumsum)
    out, _, op = _abstract(tmain, "scan")
    assert out[op.outputs["YsOut"][0]].shape == (T_, B_, D_)

    def mismatched(S, opt, PA):
        a = S.data("a", [2], "float32", append_batch_size=False)
        pred = S.less_than(S.reduce_sum(a), S.fill_constant([1], "float32",
                                                            0.0))
        return [S.cond(pred, lambda: a,
                       lambda: S.concat([a, a], axis=0))]
    tmain, _, _ = _build("port", mismatched)
    with pytest.raises(EnforceError, match="else branch"):
        _abstract(tmain, "conditional_block")


def test_op_contexts_carry_the_executor_device_and_jax_numbering(
        monkeypatch):
    seen = []

    class Recording(tregistry.OpContext):
        __slots__ = ()

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append((self.op_index, self.device))

    monkeypatch.setattr(tlowering, "OpContext", Recording)
    tmain, tstart, fetch = _build("port", _while_accumulates)
    TExecutor("cpu").run(tmain, fetch_list=fetch, scope=Scope())
    assert {d for _, d in seen} == {torch.device("cpu")}
    ops = tmain.global_block().ops
    w = next(i for i, op in enumerate(ops) if op.type == "while")
    body = len(tmain.blocks[1].ops)
    want = [1000 * (w + 1) + j for j in range(body)] * 10
    assert [i for i, _ in seen if i >= 1000] == want
    with pytest.raises(TypeError):
        tregistry.OpContext({}, 0, True, 0)
    with pytest.raises(EnforceError, match="needs a device"):
        tregistry.OpContext({}, 0, True, 0, None)


# --- beam search ---

def _both_ops(op_type, attrs, *args):
    jimpl, timpl = jregistry.get_op(op_type), tregistry.get_op(op_type)
    j = jimpl.fn(jregistry.OpContext(attrs, None, False, 0), *args)
    t = timpl.fn(tregistry.OpContext(attrs, None, False, 0, "cpu"),
                 *[torch.from_numpy(np.asarray(a)) for a in args])
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def test_beam_search_breaks_ties_as_lax_top_k():
    """Row 0: beams 0 and 2 finished at equal scores (their EOS
    candidates tie), beam 1 live over a uniform row (five-way tie);
    row 1: every beam finished at one score (EOS ties, then the
    NEG_INF continuations tie)."""
    K, V, eos = 3, 5, 2
    pre_ids = np.array([[eos, 4, eos], [eos, eos, eos]], np.int32)
    pre_scores = np.array([[-1.0, -0.5, -1.0], [-2.0, -2.0, -2.0]],
                          np.float32)
    logits = np.zeros((2, K, V), np.float32)
    logits[1] = R.randn(K, V)
    j, t = _both_ops("beam_search", {"beam_size": K, "end_id": eos},
                     pre_ids, pre_scores, logits)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(t[0], [[eos, eos, 0], [eos, eos, eos]])
    np.testing.assert_array_equal(t[2], [[0, 2, 1], [0, 1, 2]])
    # the same through K * V candidates that all tie
    j, t = _both_ops("beam_search", {"beam_size": 4, "end_id": 0},
                     np.ones((1, 4), np.int32), np.zeros((1, 4), np.float32),
                     np.zeros((1, 4, 6), np.float32))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(t[2], [[0, 0, 0, 0]])


def test_beam_search_decode_like_jax():
    T, B, K = 6, 2, 3
    ids = R.randint(0, 5, (T, B, K)).astype(np.int32)
    parents = R.randint(0, K, (T, B, K)).astype(np.int32)
    scores = R.randn(B, K).astype(np.float32)
    for alpha in (0.0, 0.6):
        j, t = _both_ops("beam_search_decode",
                         {"end_id": 2, "length_penalty": alpha},
                         ids, parents, scores)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_allclose(t[1], j[1], rtol=1e-6)


def test_eager_beam_search_like_jax():
    """The JAX suite's garden-path table: beam search beats greedy."""
    import jax.numpy as jnp
    from paddle_tpu.ops import beam_search as jbeam
    table = np.full((4, 4), -10.0, np.float32)
    table[0, 2], table[0, 3] = 2.0, 1.5
    table[2, :], table[2, 1] = 0.0, 0.1
    table[3, 1] = 5.0
    for k in (1, 3):
        js, jsc = jbeam.beam_search(
            lambda tok, s: (jnp.asarray(table)[tok], s), {}, batch_size=1,
            beam_size=k, vocab_size=4, bos_id=0, eos_id=1, max_len=4,
            length_penalty=0.0)
        tt = torch.from_numpy(table)
        ts, tsc = tbeam.beam_search(
            lambda tok, s: (tt[tok.long()], s), {}, batch_size=1,
            beam_size=k, vocab_size=4, bos_id=0, eos_id=1, max_len=4,
            length_penalty=0.0, device="cpu")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    assert ts[0, 0, 0] == 3      # beam recovers from the trap


# --- a While program saved by one package runs in the other ---

def _while_model(S, opt, PA):
    x = S.data("x", [2, 3], "float32", append_batch_size=False)
    acc = S.fill_constant([2, 3], "float32", 0.0)
    S.assign(S.fc(x, 3, param_attr=PA(name="m_w0")), acc)
    i = S.fill_constant([1], "int64", 0)
    n = S.fill_constant([1], "int64", 4)
    cond = S.less_than(i, n)
    w = S.While(cond)
    with w.block():
        S.assign(S.fc(S.assign(acc), 3, param_attr=PA(name="m_w1"),
                      bias_attr=False, act="tanh"), acc)
        ni = S.increment(S.assign(i), value=1)
        S.assign(ni, i)
        S.assign(S.less_than(ni, n), cond)
    return [acc]


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_while_model_saved_by_one_package_runs_in_the_other(saver,
                                                            tmp_path):
    feed = {"x": R.randn(2, 3).astype(np.float32)}
    main, startup, fetch = _build(saver, _while_model)
    d = str(tmp_path / "while_model")
    if saver == "jax":
        with pt.core.scope.scope_guard(JScope()):
            exe = pt.Executor()
            exe.run(startup)
            (want,) = exe.run(main, feed=feed, fetch_list=fetch)
            pt.static.io.save_inference_model(d, ["x"], [fetch[0]], exe,
                                              main_program=main)
        texe = TExecutor("cpu")
        prog, feeds, fetches = tstatic.io.load_inference_model(d, texe)
        assert len(prog.blocks) == 2 and _ops_of(prog, "while")
        (got,) = texe.run(prog, feed={feeds[0]: feed["x"]},
                          fetch_list=fetches)
    else:
        texe = TExecutor("cpu")
        texe.run(startup)
        (want,) = texe.run(main, feed=feed, fetch_list=fetch)
        tstatic.io.save_inference_model(d, ["x"], [fetch[0]], texe,
                                        main_program=main)
        with pt.core.scope.scope_guard(JScope()):
            exe = pt.Executor()
            prog, feeds, fetches = pt.static.io.load_inference_model(d, exe)
            assert len(prog.blocks) == 2
            (got,) = exe.run(prog, feed={feeds[0]: feed["x"]},
                             fetch_list=fetches)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)
