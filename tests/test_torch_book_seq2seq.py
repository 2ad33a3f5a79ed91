"""The Fluid book's three sequence chapters in the port, on the CPU
(tests/test_book_seq2seq.py): machine_translation (GRU seq2seq, beam
search decoded inside While), rnn_encoder_decoder (LSTM seq2seq, greedy
While decode) and label_semantic_roles (bi-LSTM + linear-chain CRF).

* Parity: each chapter's program built in both packages from the JAX
  book test's builder calls (the same program, `to_dict()`;
  machine_translation's also equals the JAX test's own builder's), the
  JAX startup's weights moved into the port by name, then 3 Adam steps
  on the JAX test's batches, each step from the JAX run's state: the
  loss within rtol 1e-5, Adam's moments within rtol 1e-4 (atol 1e-5 of
  the var's max) and every parameter within 3% of lr (Adam divides a
  gradient by its own RMS, tests/test_torch_book.py).
* Decode: machine_translation's beam-search program and
  rnn_encoder_decoder's greedy one (parameters shared by name) run on
  the JAX state after those steps in both packages: ids equal, beam
  scores within rtol 1e-5; label_semantic_roles' Viterbi paths equal.
* Convergence: the port alone, from its own startup, at the JAX book
  tests' thresholds and schedules (600-800 steps), `slow`-marked as the
  JAX tests are.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import test_book_seq2seq as jbook
from paddle_tpu.core import ir as jir
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.utils.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.utils.param_attr import ParamAttr as TParamAttr
from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

SIDES = {"jax": (jir, pt.static, pt.optimizer, JParamAttr),
         "port": (tir, tstatic, topt, TParamAttr)}
V, T, H, E = jbook.V, jbook.T, jbook.H, jbook.E
BOS, EOS, B, K, MAXLEN = jbook.BOS, jbook.EOS, jbook.B, jbook.K, jbook.MAXLEN
NT, SB, ST = jbook.NT, 16, 6
#: the book programs pool without lengths, as the JAX book tests do
pytestmark = pytest.mark.filterwarnings(
    "ignore:sequence_pool called without lengths")


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


# --- machine_translation (tests/test_book_seq2seq.py:32-133) ---

def _mt_encoder(S, PA, src):
    semb = S.embedding(src, [V, E], param_attr=PA(name="src_emb_w"))
    enc_in = S.fc(semb, 3 * H, num_flatten_dims=2,
                  param_attr=PA(name="enc_fc_w"),
                  bias_attr=PA(name="enc_fc_b"))
    enc = S.dynamic_gru(enc_in, H, param_attr=PA(name="enc_gru_w"),
                        bias_attr=PA(name="enc_gru_b"))
    return S.sequence_pool(enc, "LAST")


def _mt_train(S, PA):
    src = S.data("src", [B, T], dtype="int64", append_batch_size=False)
    trg_in = S.data("trg_in", [B, T + 1], dtype="int64",
                    append_batch_size=False)
    trg_out = S.data("trg_out", [B, T + 1, 1], dtype="int64",
                     append_batch_size=False)
    enc_last = _mt_encoder(S, PA, src)
    temb = S.embedding(trg_in, [V, E], param_attr=PA(name="trg_emb_w"))
    dec_in = S.fc(temb, 3 * H, num_flatten_dims=2,
                  param_attr=PA(name="dec_fc_w"),
                  bias_attr=PA(name="dec_fc_b"))
    dec = S.dynamic_gru(dec_in, H, h_0=enc_last,
                        param_attr=PA(name="dec_gru_w"),
                        bias_attr=PA(name="dec_gru_b"))
    logits = S.fc(dec, V, num_flatten_dims=2,
                  param_attr=PA(name="out_fc_w"),
                  bias_attr=PA(name="out_fc_b"))
    return S.reduce_mean(S.softmax_with_cross_entropy(logits, trg_out))


def _init_scores(S):
    """[1, K] row (0, -1e9, ...): only beam 0 live at step 0."""
    helper = S.LayerHelper("init_scores")
    out = helper.create_tmp(dtype="float32")
    helper.append_op("assign_value", {}, {"Out": out},
                     {"shape": [1, K], "values": [0.0] + [-1e9] * (K - 1),
                      "dtype": "float32"})
    return out


def _mt_decode(S, PA):
    src = S.data("src", [B, T], dtype="int64", append_batch_size=False)
    enc_last = _mt_encoder(S, PA, src)
    h0 = S.reshape(S.expand(S.unsqueeze(enc_last, axes=[1]),
                            expand_times=[1, K, 1]), [B * K, H])
    h = S.fill_constant([B * K, H], "float32", 0.0)
    S.assign(h0, h)
    pre_ids = S.fill_constant([B, K], "int32", BOS)
    pre_scores = S.fill_constant([B, K], "float32", 0.0)
    S.assign(S.elementwise_add(pre_scores, _init_scores(S)), pre_scores)
    ids_arr = S.create_array(MAXLEN, [B, K], "int32")
    parents_arr = S.create_array(MAXLEN, [B, K], "int32")
    base = S.cast(S.reshape(S.range(0, B * K, K, "int32"), [B, 1]), "int32")
    i = S.fill_constant([1], "int64", 0)
    n = S.fill_constant([1], "int64", MAXLEN)
    cond = S.less_than(i, n)
    w = S.While(cond)
    with w.block():
        tok = S.reshape(S.assign(pre_ids), [B * K, 1])
        temb = S.embedding(tok, [V, E], param_attr=PA(name="trg_emb_w"))
        dec_in = S.fc(temb, 3 * H, param_attr=PA(name="dec_fc_w"),
                      bias_attr=PA(name="dec_fc_b"))
        h_new, _, _ = S.gru_unit(dec_in, S.assign(h), 3 * H,
                                 param_attr=PA(name="dec_gru_w"),
                                 bias_attr=PA(name="dec_gru_b"))
        logits = S.fc(h_new, V, param_attr=PA(name="out_fc_w"),
                      bias_attr=PA(name="out_fc_b"))
        sel_ids, sel_scores, parent = S.beam_search(
            S.assign(pre_ids), S.assign(pre_scores),
            S.reshape(logits, [B, K, V]), K, EOS)
        flat = S.reshape(S.elementwise_add(parent, base), [B * K])
        S.assign(S.array_write(sel_ids, i, ids_arr), ids_arr)
        S.assign(S.array_write(parent, i, parents_arr), parents_arr)
        S.assign(sel_ids, pre_ids)
        S.assign(sel_scores, pre_scores)
        S.assign(S.gather(h_new, flat), h)
        ni = S.increment(S.assign(i), value=1)
        S.assign(ni, i)
        S.assign(S.less_than(ni, n), cond)
    return S.beam_search_decode(ids_arr, parents_arr, pre_scores,
                                end_id=EOS)


def _mt_feeds(seed=7):
    rng = np.random.RandomState(seed)
    while True:
        src, trg_in, trg_out = jbook._mt_batch(rng)
        yield {"src": src, "trg_in": trg_in, "trg_out": trg_out[..., None]}


# --- rnn_encoder_decoder ---

def _red_encoder(S, PA, src):
    semb = S.embedding(src, [V, E], param_attr=PA(name="r_semb"))
    enc_in = S.fc(semb, 4 * H, num_flatten_dims=2,
                  param_attr=PA(name="r_efc_w"),
                  bias_attr=PA(name="r_efc_b"))
    return S.dynamic_lstm(enc_in, 4 * H, use_peepholes=False,
                          param_attr=PA(name="r_elstm_w"),
                          bias_attr=PA(name="r_elstm_b"))


def _red_train(S, PA):
    src = S.data("src", [B, T], dtype="int64", append_batch_size=False)
    trg_in = S.data("trg_in", [B, T + 1], dtype="int64",
                    append_batch_size=False)
    trg_out = S.data("trg_out", [B, T + 1, 1], dtype="int64",
                     append_batch_size=False)
    enc_h, enc_c = _red_encoder(S, PA, src)
    h_last = S.sequence_pool(enc_h, "LAST")
    c_last = S.sequence_pool(enc_c, "LAST")
    temb = S.embedding(trg_in, [V, E], param_attr=PA(name="r_temb"))
    dec_in = S.fc(temb, 4 * H, num_flatten_dims=2,
                  param_attr=PA(name="r_dfc_w"), bias_attr=PA(name="r_dfc_b"))
    dec_h, _ = S.dynamic_lstm(dec_in, 4 * H, h_0=h_last, c_0=c_last,
                              use_peepholes=False,
                              param_attr=PA(name="r_dlstm_w"),
                              bias_attr=PA(name="r_dlstm_b"))
    logits = S.fc(dec_h, V, num_flatten_dims=2,
                  param_attr=PA(name="r_ofc_w"), bias_attr=PA(name="r_ofc_b"))
    return S.reduce_mean(S.softmax_with_cross_entropy(logits, trg_out))


def _red_decode(S, PA):
    src = S.data("src", [B, T], dtype="int64", append_batch_size=False)
    enc_h, enc_c = _red_encoder(S, PA, src)
    h = S.fill_constant([B, H], "float32", 0.0)
    c = S.fill_constant([B, H], "float32", 0.0)
    S.assign(S.sequence_pool(enc_h, "LAST"), h)
    S.assign(S.sequence_pool(enc_c, "LAST"), c)
    toks = S.fill_constant([B, 1], "int32", BOS)
    out_arr = S.create_array(MAXLEN, [B], "int32")
    i = S.fill_constant([1], "int64", 0)
    n = S.fill_constant([1], "int64", MAXLEN)
    cond = S.less_than(i, n)
    w = S.While(cond)
    with w.block():
        temb = S.embedding(S.assign(toks), [V, E],
                           param_attr=PA(name="r_temb"))
        dec_in = S.fc(temb, 4 * H, param_attr=PA(name="r_dfc_w"),
                      bias_attr=PA(name="r_dfc_b"))
        h_seq, c_seq = S.dynamic_lstm(
            S.unsqueeze(dec_in, axes=[1]), 4 * H, h_0=S.assign(h),
            c_0=S.assign(c), use_peepholes=False,
            param_attr=PA(name="r_dlstm_w"), bias_attr=PA(name="r_dlstm_b"))
        h1 = S.reshape(h_seq, [B, H])
        c1 = S.reshape(c_seq, [B, H])
        logits = S.fc(h1, V, param_attr=PA(name="r_ofc_w"),
                      bias_attr=PA(name="r_ofc_b"))
        nxt = S.cast(S.argmax(logits, axis=-1), "int32")
        S.assign(S.array_write(nxt, i, out_arr), out_arr)
        S.assign(S.reshape(nxt, [B, 1]), toks)
        S.assign(h1, h)
        S.assign(c1, c)
        ni = S.increment(S.assign(i), value=1)
        S.assign(ni, i)
        S.assign(S.less_than(ni, n), cond)
    return [out_arr]


def _red_feeds(seed=11):
    rng = np.random.RandomState(seed)
    while True:
        src = rng.randint(3, V, (B, T)).astype(np.int64)
        yield {"src": src,
               "trg_in": np.concatenate([np.full((B, 1), BOS, np.int64),
                                         src], 1),
               "trg_out": np.concatenate([src, np.full((B, 1), EOS,
                                                       np.int64)],
                                         1)[..., None]}


# --- label_semantic_roles ---

def _srl(S, PA):
    words = S.data("words", [SB, ST], dtype="int64", append_batch_size=False)
    pred = S.data("pred", [SB, 1], dtype="int64", append_batch_size=False)
    labels = S.data("labels", [SB, ST], dtype="int32",
                    append_batch_size=False)
    wemb = S.embedding(words, [V, E], param_attr=PA(name="srl_wemb"))
    pemb = S.embedding(pred, [V, E], param_attr=PA(name="srl_pemb"))
    pemb_t = S.expand(S.unsqueeze(pemb, axes=[1]), expand_times=[1, ST, 1])
    x = S.concat([wemb, pemb_t], axis=2)
    fwd_in = S.fc(x, 4 * H, num_flatten_dims=2)
    fw, _ = S.dynamic_lstm(fwd_in, 4 * H, use_peepholes=False)
    bw, _ = S.dynamic_lstm(fwd_in, 4 * H, use_peepholes=False,
                           is_reverse=True)
    emission = S.fc(S.concat([fw, bw], axis=2), NT, num_flatten_dims=2)
    crf_cost = S.linear_chain_crf(emission, labels, PA(name="srl_crf_w"))
    decode = S.crf_decoding(emission, PA(name="srl_crf_w"))
    return S.reduce_mean(crf_cost), decode


def _srl_feeds(seed=13):
    rng = np.random.RandomState(seed)
    while True:
        words = rng.randint(0, V, (SB, ST)).astype(np.int64)
        pred = rng.randint(0, V, (SB, 1)).astype(np.int64)
        labels = ((words + np.roll(words, 1, axis=1)) % NT).astype(np.int32)
        yield {"words": words, "pred": pred, "labels": labels}


def _train_fn(chapter):
    """(builder → (loss, extra fetches), lr, feeds) of a chapter."""
    if chapter == "machine_translation":
        return (lambda S, PA: (_mt_train(S, PA), [])), 0.01, _mt_feeds
    if chapter == "rnn_encoder_decoder":
        return (lambda S, PA: (_red_train(S, PA), [])), 0.01, _red_feeds
    return (lambda S, PA: (lambda ld: (ld[0], [ld[1]]))(_srl(S, PA))), \
        0.02, _srl_feeds


CHAPTERS = ["machine_translation", "rnn_encoder_decoder",
            "label_semantic_roles"]


def _build_train(side, chapter):
    ir, static, opt, param_attr = SIDES[side]
    fn, lr, _ = _train_fn(chapter)
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        loss, extra = fn(static, param_attr)
        opt.Adam(learning_rate=lr).minimize(loss)
    return main, startup, [loss.name] + [v.name for v in extra]


def _build_decode(side, builder):
    ir, static, _, param_attr = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        out = builder(static, param_attr)
    return main, [v.name for v in out]


def _jax_state(program, scope):
    return {v.name: scope.find_np(v.name) for v in program.list_vars()
            if v.persistable and scope.has(v.name)}


def test_machine_translation_program_is_the_jax_book_tests():
    jir.reset_unique_names()
    ref = jir.Program()
    with jir.program_guard(ref, jir.Program()):
        jbook._mt_train_program()
    mine = jir.Program()
    jir.reset_unique_names()
    with jir.program_guard(mine, jir.Program()):
        _mt_train(pt.static, JParamAttr)
    assert mine.to_dict() == ref.to_dict()


@pytest.mark.parametrize("chapter", CHAPTERS)
def test_chapter_trains_and_decodes_like_jax(chapter):
    jmain, jstart, fetch = _build_train("jax", chapter)
    tmain, tstart, tfetch = _build_train("port", chapter)
    assert tfetch == fetch
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    _, lr, feeds = _train_fn(chapter)
    params = [v.name for v in tmain.all_parameters() if v.desc.trainable]
    jscope, jexe, texe = JScope(), pt.Executor(), TExecutor("cpu")
    jexe.run(jstart, scope=jscope)
    feeds = feeds()
    for _ in range(3):
        feed = next(feeds)
        tscope = scope_from_jax(_jax_state(jmain, jscope), Scope(), "cpu",
                                program=tmain)
        jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        tout = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(float(tout[0]), float(jout[0]),
                                   rtol=1e-5)
        for a, b in zip(jout[1:], tout[1:]):       # Viterbi paths
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        want = _jax_state(jmain, jscope)
        got = scope_to_numpy(tscope, sorted(want))
        assert set(params) <= set(want)
        for name in want:
            if name.endswith("_Adam"):
                np.testing.assert_allclose(
                    got[name], want[name], rtol=1e-4,
                    atol=1e-5 * np.abs(want[name]).max(), err_msg=name)
            else:
                np.testing.assert_allclose(got[name], want[name], rtol=0,
                                           atol=3e-2 * lr, err_msg=name)
    if chapter == "label_semantic_roles":
        return
    # decode on the trained JAX state, in both packages
    builder = _mt_decode if chapter == "machine_translation" else _red_decode
    jdec, dfetch = _build_decode("jax", builder)
    tdec, _ = _build_decode("port", builder)
    assert tdec.to_dict() == jdec.to_dict()
    tscope = scope_from_jax(_jax_state(jmain, jscope), Scope(), "cpu")
    src = {"src": next(feeds)["src"]}
    jout = jexe.run(jdec, feed=src, fetch_list=dfetch, scope=jscope,
                    training=False)
    tout = texe.run(tdec, feed=src, fetch_list=dfetch, scope=tscope,
                    training=False)
    np.testing.assert_array_equal(np.asarray(tout[0]), np.asarray(jout[0]))
    if chapter == "machine_translation":
        assert tout[0].shape == (B, K, MAXLEN)
        np.testing.assert_allclose(tout[1], np.asarray(jout[1]), rtol=1e-5)
        assert (tout[1][:, 0] >= tout[1][:, -1] - 1e-5).all()


def _port_train(chapter, steps):
    """The port alone from its own startup: (losses, the last step's
    fetches and feed, main, fetch names, scope, executor)."""
    main, startup, fetch = _build_train("port", chapter)
    scope, exe = Scope(), TExecutor("cpu")
    exe.run(startup, scope=scope)
    feeds = _train_fn(chapter)[2]()
    losses = []
    for _ in range(steps):
        feed = next(feeds)
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
    return losses, out, feed, main, fetch, scope, exe


@pytest.mark.slow
def test_machine_translation_converges(tmp_path):
    losses, _, _, _, _, scope, exe = _port_train("machine_translation", 800)
    assert losses[-1] < 0.5 and losses[-1] < losses[0] * 0.3, \
        (losses[0], losses[-1])
    dec, dfetch = _build_decode("port", _mt_decode)
    src = jbook._mt_batch(np.random.RandomState(3))[0]
    ids, scores = exe.run(dec, feed={"src": src}, fetch_list=dfetch,
                          scope=scope, training=False)
    assert float((ids[:, 0, :T] == src[:, ::-1]).mean()) > 0.8
    assert (scores[:, 0] >= scores[:, -1] - 1e-5).all()
    d = str(tmp_path / "mt.model")
    with scope_guard(scope):
        tstatic.io.save_inference_model(d, ["src"], [dfetch[0]], exe,
                                        main_program=dec)
        prog, feeds, fetches = tstatic.io.load_inference_model(d, exe)
        (ids2,) = exe.run(prog, feed={feeds[0]: src}, fetch_list=fetches,
                          training=False)
    np.testing.assert_array_equal(ids, ids2)


@pytest.mark.slow
def test_rnn_encoder_decoder_converges():
    losses, _, _, _, _, scope, exe = _port_train("rnn_encoder_decoder", 800)
    assert losses[-1] < 0.5, losses[-1]
    dec, dfetch = _build_decode("port", _red_decode)
    src = np.random.RandomState(5).randint(3, V, (B, T)).astype(np.int64)
    (out,) = exe.run(dec, feed={"src": src}, fetch_list=dfetch, scope=scope,
                     training=False)
    assert float((out.T[:, :T] == src).mean()) > 0.8


@pytest.mark.slow
def test_label_semantic_roles_converges(tmp_path):
    losses, out, feed, main, fetch, scope, exe = _port_train(
        "label_semantic_roles", 600)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert float((np.asarray(out[1]) == feed["labels"]).mean()) > 0.8
    d = str(tmp_path / "srl.model")
    x = {"words": feed["words"], "pred": feed["pred"]}
    with scope_guard(scope):
        tstatic.io.save_inference_model(d, ["words", "pred"], [fetch[1]],
                                        exe, main_program=main)
        prog, feeds, fetches = tstatic.io.load_inference_model(d, exe)
        dec2, dec3 = (exe.run(prog, feed=x, fetch_list=fetches,
                              training=False)[0] for _ in range(2))
    assert float((dec2 == feed["labels"]).mean()) > 0.8
    np.testing.assert_array_equal(dec2, dec3)
