"""The long-tail static builders (static/extras.py, static/compat.py) of
the port against the JAX package's, on the CPU.

Each group of builders is built into a program by both packages (the
same builder calls through `static`): the programs must be the same op
for op (`to_dict()`, main and startup), the JAX startup's state moves
into the port by name (`weights.scope_from_jax`), and one run on the same
seeded feed must agree — every output within rtol / atol 1e-5 of the
JAX Executor's (integer outputs equal), the random ops by shape only.
Then the reference's hand-written static tests run through the port
(tests/test_ops_misc2.py's extras smoke, py_func and Print, the lstm
layers), the rnn_impl builders and cells, and compat's warn-once and
readers.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as pt
import test_ops_misc2
from paddle_tpu.core import ir as jir
from paddle_tpu.static import compat as jcompat
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.static import compat as tcompat
from paddle_tpu_torch.weights import scope_from_jax

SIDES = {"jax": (jir, pt.static), "port": (tir, tstatic)}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


def _f(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _build(side, group):
    ir, static = SIDES[side]
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 1
    with ir.program_guard(main, startup):
        exact, shaped = group(static)
    return main, startup, [v.name for v in exact], [v.name for v in shaped]


def _jax_state(program):
    scope = pt.global_scope()
    return {v.name: scope.find_np(v.name) for v in program.list_vars()
            if v.persistable and scope.has(v.name)}


#: vars the JAX package declares float64 where both packages compute
#: float32: its shape evaluation runs under x64, and mean_iou's int64
#: count promotes there (the detection family's prior boxes likewise)
X64_DECLARED = {"mean_iou_out_0"}


def _declared(program):
    d = program.to_dict()
    for block in d["blocks"]:
        for name in X64_DECLARED & set(block["vars"]):
            block["vars"][name] = dict(block["vars"][name], dtype=None)
    return d


def run_both(group, feed):
    """Build `group` in both packages, check the programs are the same,
    run once from the JAX startup's state; returns (jax outputs, port
    outputs) of the exact and the shape-only fetches."""
    jm, js, exact, shaped = _build("jax", group)
    tm, ts, texact, tshaped = _build("port", group)
    assert (texact, tshaped) == (exact, shaped)
    assert _declared(tm) == _declared(jm)
    assert ts.to_dict() == js.to_dict()
    exe = pt.Executor()
    exe.run(js)
    scope = scope_from_jax(_jax_state(jm), Scope(), "cpu")
    fetch = exact + shaped
    jout = exe.run(jm, feed=feed, fetch_list=fetch)
    tout = TExecutor("cpu").run(tm, feed=feed, fetch_list=fetch, scope=scope)
    for name, j, t in zip(fetch, jout, tout):
        j, t = np.asarray(j), np.asarray(t)
        assert j.shape == t.shape, (name, j.shape, t.shape)
        if name in exact:
            np.testing.assert_allclose(t.astype(np.float64),
                                       j.astype(np.float64), err_msg=name,
                                       **TOL)
    return jout, tout


# ----------------------------------------------------------- the groups
def _activations(s):
    x = s.data("x", [4, 6], append_batch_size=False)
    img = s.data("img", [2, 4, 4, 4], append_batch_size=False)
    outs = [s.brelu(x, -0.5, 0.5), s.soft_relu(x, 0.7), s.selu(x),
            s.stanh(x), s.maxout(img, groups=2), s.lrn(img, n=3),
            s.hard_shrink(x, 0.3), s.softshrink(x, 0.4),
            s.thresholded_relu(x, 0.2), s.clip_by_norm(x, 1.0),
            s.l2_normalize(x, axis=1), s.cos_sim(x, x * 2.0 + 1.0)]
    return outs, []


def _losses(s):
    p = s.data("p", [4, 1], append_batch_size=False)
    lab = s.data("lab", [4, 1], append_batch_size=False)
    x = s.data("x", [4, 6], append_batch_size=False)
    y = s.data("y", [4, 6], append_batch_size=False)
    cls = s.data("cls", [4, 1], "int64", append_batch_size=False)
    img = s.data("img", [2, 4, 4, 4], append_batch_size=False)
    return [s.log_loss(p, lab), s.rank_loss(lab, p, p * 0.5),
            s.margin_rank_loss(lab, p, p * 0.3),
            s.bpr_loss(x, cls), s.dice_loss(s.sigmoid(x), s.sigmoid(y)),
            s.npair_loss(x, y, cls),
            s.teacher_student_sigmoid_loss(p, lab),
            s.fsp_matrix(img, img * 0.5)], []


def _tensor_ops(s):
    x = s.data("x", [4, 6], append_batch_size=False)
    y = s.data("y", [4, 6], append_batch_size=False)
    cls = s.data("cls", [4, 1], "int64", append_batch_size=False)
    idx = s.data("idx", [3, 1], "int64", append_batch_size=False)
    img = s.data("img", [2, 4, 4, 4], append_batch_size=False)
    seq = s.data("seq", [2, 3, 6], append_batch_size=False)
    sel = s.data("sel", [4, 1], "int32", append_batch_size=False)
    return [s.multiplex([x, y], sel),
            s.scatter_nd_add(x, idx, s.slice(y, [0], [0], [3])),
            s.scatter_nd(idx, s.slice(y, [0], [0], [3]), [5, 6]),
            s.shard_index(cls, 20, 2, 0), s.space_to_depth(img, 2),
            s.shuffle_channel(img, 2), s.unfold(img, [2, 2], paddings=1),
            s.crop_tensor(x, [2, 3], [1, 2]), s.crop(x, [3, 3]),
            s.pad_constant_like(x, s.slice(y, [0, 1], [0, 0], [2, 3]), 1.5),
            s.reverse(x, [0, 1]), s.add_position_encoding(seq, 0.5, 2.0),
            s.bilinear_tensor_product(x, y, 3), s.has_inf(x), s.has_nan(x),
            s.is_empty(x), s.size(x), s.rank(img),
            s.elementwise_floordiv(s.cast(x * 10.0, "int64"),
                                   s.cast(y * 0 + 3.0, "int64"))], []


def _sequence_ops(s):
    ids = s.data("ids", [2, 5], "int64", append_batch_size=False)
    ln = s.data("ln", [2], "int64", append_batch_size=False)
    seq = s.data("seq", [2, 3, 6], append_batch_size=False)
    x = s.data("x", [4, 6], append_batch_size=False)
    par = s.data("par", [3, 2, 2], "int64", append_batch_size=False)
    tok = s.data("tok", [3, 2, 2], "int64", append_batch_size=False)
    probs = s.data("probs", [2, 5, 4], append_batch_size=False)
    return [s.sequence_enumerate(ids, 3, pad_value=-1, lengths=ln),
            s.sequence_scatter(s.slice(x, [0], [0], [2]),
                               s.slice(ids, [1], [0], [3]),
                               s.slice(x, [0, 1], [0, 0], [2, 3]),
                               lengths=ln),
            s.sequence_reshape(seq, 9), s.gather_tree(tok, par),
            *s.ctc_greedy_decoder(probs, blank=0),
            *s.edit_distance(ids, s.slice(ids, [1], [1], [4]),
                             input_length=ln, label_length=ln),
            *s.mean_iou(s.slice(ids, [0], [0], [1]),
                        s.slice(ids, [0], [1], [2]), 10),
            s.hash(ids, 1000, num_hash=2)], []


def _vision(s):
    img = s.data("img", [2, 4, 4, 4], append_batch_size=False)
    vol = s.data("vol", [2, 3, 4, 4, 4], append_batch_size=False)
    grid = s.data("grid", [2, 3, 3, 2], append_batch_size=False)
    seq = s.data("seq", [2, 3, 6], append_batch_size=False)
    sc = s.data("sc", [4], append_batch_size=False)
    return [s.conv3d(vol, 2, 2, act="relu"), s.pool3d(vol, 2),
            s.conv3d_transpose(vol, 2, 2, stride=2),
            s.row_conv(seq, 1), s.affine_channel(img, sc, sc * 0.5),
            s.instance_norm(img), s.grid_sampler(img, grid),
            s.im2sequence(img, filter_size=2, stride=2, padding=1),
            s.pixel_shuffle(img, 2), s.temporal_shift(img, 2),
            s.image_resize(img, [6, 5]), s.resize_bilinear(img, scale=1.5),
            s.resize_nearest(img, [2, 3]), s.image_resize_short(img, 6),
            s.resize_trilinear(vol, [3, 5, 6]),
            s.adaptive_pool3d(vol, 2)], []


def _ctr_text(s):
    x = s.data("x", [4, 6], append_batch_size=False)
    show = s.data("show", [4, 6], append_batch_size=False)
    cvm = s.data("cvm", [4, 2], append_batch_size=False)
    cls = s.data("cls", [4, 1], "int64", append_batch_size=False)
    tags = s.data("tags", [4, 2], "int64", append_batch_size=False)
    ftag = s.data("ftag", [2], "int64", append_batch_size=False)
    img = s.data("img", [2, 4, 4, 4], append_batch_size=False)
    seq = s.data("seq", [2, 3, 6], append_batch_size=False)
    ln = s.data("ln", [2], "int64", append_batch_size=False)
    ids = s.data("ids", [2, 5], "int64", append_batch_size=False)
    chunks = s.data("chunks", [2, 5], "int64", append_batch_size=False)
    nodes = s.data("nodes", [2, 4, 3], append_batch_size=False)
    edges = s.data("edges", [2, 3, 2], "int64", append_batch_size=False)
    topx = s.data("topx", [2, 2, 3, 4], append_batch_size=False)
    row = s.data("row", [2], "int64", append_batch_size=False)
    col = s.data("col", [2], "int64", append_batch_size=False)
    out, lw = s.filter_by_instag(x, tags, ftag)
    return [s.continuous_value_model(show, cvm),
            s.continuous_value_model(show, cvm, use_cvm=False),
            s.data_norm(x), s.spectral_norm(s.create_parameter(
                [3, 5], "float32", name="sn_w")),
            s.center_loss(x, cls, 5, 0.1), out, lw,
            s.similarity_focus(img, 1, [0, 2]),
            *s.chunk_eval(chunks, ids, "IOB", 2, seq_length=ln),
            s.var_conv_2d(img, row, col, 4, 3, 3),
            *s.match_matrix_tensor(seq, seq, 2, x_lengths=ln),
            s.tree_conv(nodes, edges, 2, num_filters=2),
            s.sequence_topk_avg_pooling(topx, row, col, [1, 2], 2),
            s.fused_embedding_seq_pool(ids, [20, 3], padding_idx=0,
                                       lengths=ln),
            *s.fused_elemwise_activation(x, show, ["relu",
                                                   "elementwise_add"]),
            s.search_pyramid_hash(ids, 8, 97, 3, 4, 0.0, 0, False, 0, 0, 0,
                                  lengths=ln),
            s.cross_entropy2(s.softmax(x), cls),
            *s.unique(s.cast(ids, "int32")),
            *s.unique_with_counts(s.cast(ids, "int32"))], []


def _framework(s):
    x = s.data("x", [4, 6], append_batch_size=False)
    mask = s.data("mask", [4, 1], "bool", append_batch_size=False)
    probs = s.data("probs", [4, 5], append_batch_size=False)
    t = s.create_tensor("float32", name="ct")
    s.assign(x, t)
    g = s.create_global_var([2, 3], 1.5, "float32", persistable=True,
                            name="gv")
    step = s.autoincreased_step_counter("counter", begin=3)
    arr = s.stack([x, x * 2.0], axis=0)
    cat, n = s.tensor_array_to_tensor(arr, axis=1)
    stacked, n2 = s.tensor_array_to_tensor(arr, use_stack=True)
    out_t, out_f = s.split_lod_tensor(x, mask)
    merged = s.merge_lod_tensor(out_t, out_f, x, mask)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sel = s.get_tensor_from_selected_rows(x)
        msel = s.merge_selected_rows(x)
    exact = [t, g, step, cat, n, stacked, n2, s.array_length(arr), out_t,
             out_f, merged, sel, msel, s.max_sequence_len(x)]
    shaped = [s.sampling_id(probs), s.random_crop(x, [2, 3]),
              s.gaussian_random_batch_size_like(x, [-1, 7]),
              s.uniform_random_batch_size_like(x, [-1, 7])]
    return exact, shaped


def _feed(rng):
    return {
        "x": _f(rng, 4, 6), "y": _f(rng, 4, 6),
        "p": _f(rng, 4, 1, lo=0.1, hi=0.9),
        "lab": np.array([[-2.0], [-1.0], [0.6], [1.4]], np.float32),
        "cls": np.array([[1], [4], [1], [0]], np.int64),
        "sel": np.array([[1], [0], [0], [1]], np.int32),
        "idx": np.array([[3], [0], [3]], np.int64),
        "img": _f(rng, 2, 4, 4, 4), "vol": _f(rng, 2, 3, 4, 4, 4),
        "grid": _f(rng, 2, 3, 3, 2), "seq": _f(rng, 2, 3, 6),
        "sc": _f(rng, 4), "show": _f(rng, 4, 6, lo=0.2, hi=3.0),
        "cvm": _f(rng, 4, 2, lo=0.0, hi=1.0),
        "tags": np.array([[1, 0], [2, 0], [3, 2], [4, 0]], np.int64),
        "ftag": np.array([2, 4], np.int64),
        "ids": rng.randint(0, 6, (2, 5)).astype(np.int64),
        "ln": np.array([5, 3], np.int64),
        "row": np.array([3, 2], np.int64), "col": np.array([4, 2], np.int64),
        "chunks": rng.randint(0, 5, (2, 5)).astype(np.int64),
        "par": rng.randint(0, 2, (3, 2, 2)).astype(np.int64),
        "tok": rng.randint(0, 9, (3, 2, 2)).astype(np.int64),
        "probs": _f(rng, 2, 5, 4, lo=0.0, hi=1.0),
        "nodes": _f(rng, 2, 4, 3),
        "edges": np.array([[[1, 2], [1, 3], [2, 4]], [[1, 2], [2, 3],
                                                      [0, 0]]], np.int64),
        "topx": _f(rng, 2, 2, 3, 4),
        "mask": np.array([[True], [False], [True], [False]]),
    }


GROUPS = {"activations": _activations, "losses": _losses,
          "tensor": _tensor_ops, "sequence": _sequence_ops,
          "vision": _vision, "ctr_text": _ctr_text, "framework": _framework}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_builders_make_the_jax_program_and_agree(name):
    group = GROUPS[name]
    feed = _feed(np.random.RandomState(sorted(GROUPS).index(name)))
    if name == "framework":
        feed = {k: feed[k] for k in ("x", "mask")}
        feed["probs"] = np.full((4, 5), 0.2, np.float32)
    jm, _, _, _ = _build("jax", group)
    used = {n for op in jm.global_block().ops for ns in op.inputs.values()
            for n in ns}
    run_both(group, {k: v for k, v in feed.items() if k in used})


def test_im2sequence_ignores_padding_as_the_reference():
    """The reference builder takes `padding` and does not pass it on: the
    op pads nothing (ROADMAP Queue 3, kept from the reference; Fluid
    pads)."""
    def group(s):
        img = s.data("img", [1, 2, 5, 5], append_batch_size=False)
        return [s.im2sequence(img, filter_size=2, stride=1, padding=3),
                s.im2sequence(img, filter_size=2, stride=1)], []

    img = np.arange(50, dtype=np.float32).reshape(1, 2, 5, 5)
    jout, tout = run_both(group, {"img": img})
    assert tout[0].shape == (16, 8)
    np.testing.assert_array_equal(tout[0], tout[1])
    tm, _, _, _ = _build("port", group)
    assert [op.attrs for op in tm.global_block().ops
            if op.type == "im2sequence"][0] == {"kernels": [2, 2],
                                                "strides": [1, 1]}


def test_random_builders_draw_from_the_run_seed():
    def group(s):
        x = s.data("x", [4, 6], append_batch_size=False)
        return [s.random_crop(x, [2, 3]),
                s.gaussian_random_batch_size_like(x, [-1, 7]),
                s.uniform_random_batch_size_like(x, [-1, 7], min=2.0,
                                                 max=3.0)], []

    tm, ts, names, _ = _build("port", group)
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    runs = []
    for seed in (5, 5, 6):
        tm.random_seed = seed
        runs.append(TExecutor("cpu").run(tm, feed={"x": x},
                                         fetch_list=names, scope=Scope()))
    crop, gauss, uni = runs[0]
    r0, c0 = divmod(int(crop[0, 0]), 6)
    np.testing.assert_array_equal(crop, x[r0:r0 + 2, c0:c0 + 3])
    assert gauss.shape == uni.shape == (4, 7)
    assert (uni >= 2.0).all() and (uni < 3.0).all()
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0][1], runs[2][1])


# ------------------------------- the reference's hand tests, both sides
def test_static_extras_smoke_through_port():
    """tests/test_ops_misc2.py::test_static_extras_smoke's program."""
    def group(s):
        x = s.data("ex_x", [2, 6], append_batch_size=False)
        img = s.data("ex_img", [1, 4, 4, 4], append_batch_size=False)
        outs = [s.brelu(x), s.selu(x), s.stanh(x),
                s.l2_normalize(x, axis=1), s.clip_by_norm(x, 2.0),
                s.maxout(img, groups=2), s.shuffle_channel(img, group=2),
                s.space_to_depth(img, 2), s.size(x), s.rank(x),
                s.reverse(x, 1)]
        outs.append(s.sequence_reverse(
            s.data("ex_seq", [2, 3, 2], append_batch_size=False)))
        return outs, []

    test_ops_misc2.test_static_extras_smoke()
    rng = np.random.RandomState(0)
    run_both(group, {"ex_x": _f(rng, 2, 6), "ex_img": _f(rng, 1, 4, 4, 4),
                     "ex_seq": _f(rng, 2, 3, 2)})


def test_py_func_and_print_through_port(capsys):
    """tests/test_ops_misc2.py::test_py_func_and_print in the port: the
    host function's result, Print's message and the same program."""
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tstatic.data("pf_x", [3, 2], append_batch_size=False)
        out = main.global_block().create_var(
            name="pf_out", shape=(3, 2), dtype="float32", stop_gradient=True)
        tstatic.py_func(lambda a: a * 2.0, x, out)
        tstatic.Print(out, message="pyfunc out:")
    xv = _f(np.random.RandomState(1), 3, 2)
    res, = TExecutor("cpu").run(main, feed={"pf_x": xv}, fetch_list=[out],
                                scope=Scope())
    np.testing.assert_allclose(res, xv * 2.0, rtol=1e-6)
    assert "pyfunc out:" in capsys.readouterr().out
    types = [op.type for op in main.global_block().ops]
    assert types[0].startswith("py_func_") and types[1] == "print"


@pytest.mark.parametrize("bidirec", [False, True])
def test_lstm_layer_matches_jax(bidirec):
    """tests/test_ops_misc2.py::test_lstm_layer_cudnn_style / _bidirec:
    fluid.layers.lstm's fc + dynamic_lstm parameters carry across by
    name."""
    h = 8 if bidirec else 16

    def group(s):
        x = s.data("ls_x", [2, 5, 6], append_batch_size=False)
        h0 = s.data("ls_h", [2, h], append_batch_size=False)
        c0 = s.data("ls_c", [2, h], append_batch_size=False)
        return list(s.lstm(x, h0, c0, max_len=5, hidden_size=h,
                           num_layers=1 if bidirec else 2,
                           is_bidirec=bidirec)), []

    rng = np.random.RandomState(2)
    jout, tout = run_both(group, {"ls_x": _f(rng, 2, 5, 6),
                                  "ls_h": _f(rng, 2, h),
                                  "ls_c": _f(rng, 2, h)})
    assert tout[0].shape == (2, 5, 16)
    assert tout[2].shape == (2, 16)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("bidirectional,batch_first", [(False, True),
                                                       (True, False)])
def test_basic_rnn_matches_jax(kind, bidirectional, batch_first):
    def group(s):
        x = s.data("x", [2, 4, 3] if batch_first else [4, 2, 3],
                   append_batch_size=False)
        ln = s.data("ln", [2], "int64", append_batch_size=False)
        init = s.data("h0", [4 if bidirectional else 2, 2, 5],
                      append_batch_size=False)
        if kind == "gru":
            return list(s.basic_gru(x, init, 5, num_layers=2,
                                    sequence_length=ln if batch_first
                                    else None,
                                    bidirectional=bidirectional,
                                    batch_first=batch_first)), []
        return list(s.basic_lstm(x, init, init * 0.5, 5, num_layers=2,
                                 sequence_length=ln if batch_first else None,
                                 bidirectional=bidirectional,
                                 batch_first=batch_first)), []

    rng = np.random.RandomState(3)
    feed = {"x": _f(rng, 2, 4, 3) if batch_first else _f(rng, 4, 2, 3),
            "h0": _f(rng, 4 if bidirectional else 2, 2, 5)}
    if batch_first:
        feed["ln"] = np.array([4, 2], np.int64)
    run_both(group, feed)


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_basic_units_match_jax(kind):
    """The eager rnn_impl cells, the JAX cell's weights copied in."""
    import torch

    rng = np.random.RandomState(4)
    x, h, c = _f(rng, 3, 4), _f(rng, 3, 5), _f(rng, 3, 5)
    if kind == "gru":
        junit = pt.static.BasicGRUUnit(hidden_size=5)
        tunit = tstatic.BasicGRUUnit(hidden_size=5, device="cpu")
        want = np.asarray(junit(x, h))
        tunit._cell.ensure(4)
        tunit._cell.set_state_dict({k: np.asarray(v) for k, v in
                                    junit._cell._parameters.items()})
        got = tunit(torch.from_numpy(x), torch.from_numpy(h)).detach()
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    junit = pt.static.BasicLSTMUnit(hidden_size=5, forget_bias=0.5)
    tunit = tstatic.BasicLSTMUnit(hidden_size=5, forget_bias=0.5,
                                  device="cpu")
    want = junit(x, h, c)
    tunit._cell.ensure(4)
    tunit._cell.set_state_dict({k: np.asarray(v) for k, v in
                                junit._cell._parameters.items()})
    got = tunit(*[torch.from_numpy(a) for a in (x, h, c)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


# ----------------------------------------------------------------- compat
def test_compat_lod_identities_warn_once_in_both():
    """tests/test_contrib.py::test_compat_lod_identities_warn_once, in
    both packages' compat."""
    for compat in (jcompat, tcompat):
        compat._warned.discard("lod_append")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            compat.lod_append("x", 1)
            compat.lod_append("x", 1)
        assert len(w) == 1
        assert "identity" in str(w[0].message)
    assert tcompat.lod_reset("x", y="len") == ("x", "len")
    assert tcompat.lod_reset("x") == "x"


def test_py_reader_feeds_the_executor():
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        reader = tstatic.py_reader(4, [[2, 3], [2, 1]],
                                   ["float32", "int64"], name="rd")
        reader = tstatic.double_buffer(reader)
        x, y = tstatic.read_file(reader)
        out = tstatic.elementwise_add(
            tstatic.reduce_sum(x), tstatic.cast(tstatic.reduce_sum(y),
                                                "float32"))
    assert tstatic.monkey_patch_reader_methods(reader) is reader
    rng = np.random.RandomState(5)
    batches = [(_f(rng, 2, 3), rng.randint(0, 9, (2, 1))) for _ in range(3)]
    reader.decorate_batch_generator(lambda: iter(batches))
    reader.start()
    exe = TExecutor("cpu")
    got = [float(exe.run(main, feed=feed, fetch_list=[out],
                         scope=Scope())[0]) for feed in reader]
    reader.reset()
    np.testing.assert_allclose(got, [a.sum() + b.sum() for a, b in batches],
                               rtol=1e-6)
    main2 = tir.Program()
    with tir.program_guard(main2, tir.Program()):
        v = tstatic.data("v", [2], append_batch_size=False)
        r2 = tstatic.create_py_reader_by_data(2, [v])
    assert tstatic.read_file(r2) is v
