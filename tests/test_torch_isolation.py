"""The port stands alone: no JAX, no paddle_tpu, no silent CPU fallback.

* In a fresh interpreter with `jax` and `paddle_tpu` blocked on
  sys.meta_path, every module of `paddle_tpu_torch` (the static,
  inference, slim and analysis subpackages among them) and
  `chip_smoke.py` imports, one CPU decode step runs, and a tiny static
  ResNet is built, saved and served by an int8 Predictor, a
  fit_a_line program trains three Momentum steps, the book's
  word2vec (shared embedding, concat, reshape, fc) trains one Adam step
  under `exponential_decay`, its LR counter advanced in the scope, a
  float16 AMP-decorated step runs with loss scaling, and a
  toy While beam decode (gru_unit, beam_search, array_write,
  beam_search_decode) runs, and the dygraph slice runs eagerly: a tiny
  Transformer trains a TrainStep and decodes (greedy and beam), a LeNet
  goes through save_dygraph / load_dygraph and TracedLayer, an NHWC
  ResNet, the zoo's blocks, DeepFM, the extension layers, the AMP
  scaler, the grad clips and the ragged batcher take one call each, and
  the detection slice runs: a tiny YOLOv3's loss and predict and a
  static multi_box_head -> ssd_loss Momentum step, and a tiny CRNN-CTC
  Momentum step, save / load, a distribution, contrib, WeightedAverage
  and the top-level surface; the native library loads, a parameter
  server answers a client and a MultiSlot file trains a step through
  `Executor.train_from_dataset`; the analysis, slim and reader tails
  take one call each (a plan's veto, a channel prune, a DataLoader over
  xmap_readers, a mem:// save, an armed lock cycle, the AST lint of the
  package, a NAS controller step, flops_of).
* A source scan finds no import of jax or of the JAX package in the
  port or in chip_smoke.py, and no path into paddle_tpu/ in the port's
  code (the native build reads only the port's copy of the C++).
* The launcher's children and a pserver child, each with jax and
  paddle_tpu blocked, run a parameter-server round trip through the
  fleet.
* `device=None` means CUDA: without a GPU the entry points raise
  (`Executor()`, a Predictor from a default `Config`,
  `weights.scope_from_jax`, `YOLOv3`, `DetectionMAP.eval`, a
  distribution over arrays, `static.load`), and
  chip_smoke.py exits non-zero without printing a result.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"

_BLOCKED_RUN = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "paddle_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import paddle_tpu_torch
    for mod in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                     "paddle_tpu_torch."):
        importlib.import_module(mod.name)
    import chip_smoke
    from paddle_tpu_torch.ops import generation as gen
    from paddle_tpu_torch.ops.kernels import _build
    model = gen.TinyDecoderLM(gen.LMConfig(), device="cpu").init_params(0)
    eng = gen.DecodeEngine(model, batch_size=2, max_len=32, device="cpu")
    state = eng.init_state()
    state, row = eng.prefill(state, 0, [1, 2, 3])
    state, logits = eng.step(state, np.asarray([int(row.argmax()), 0]),
                             np.asarray([True, False]))
    assert logits.shape == (2, gen.LMConfig().vocab_size)
    assert np.isfinite(logits).all()
    for kv_dtype in ("int8", "fp8_e4m3"):
        peng = gen.PagedDecodeEngine(model, batch_size=1, max_len=32,
                                     kv_dtype=kv_dtype, spill_blocks=4,
                                     device="cpu")
        assert peng.kv_dtype == kv_dtype
        pstate = peng.init_state()
        pstate, row, _ = peng.admit(pstate, 0, list(range(1, 11)), 12)
        doc = peng.export_state(pstate, 0, list(range(1, 11)))
        assert len(doc["kv"]) == 1 and np.isfinite(row).all()
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    for sub in ("static", "inference", "slim", "analysis"):
        assert "paddle_tpu_torch." + sub in names, sub
    # the static serving slice: build, init, save, int8 Predictor
    import tempfile
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.models.resnet import build_static
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        img = static.data("img", [3, 16, 16])
        label = static.data("label", [1], "int64")
        logits, _, _ = build_static(img, label, num_classes=4, width=4,
                                    blocks=(1, 1))
    exe = Executor("cpu")
    exe.run(startup)
    d = tempfile.mkdtemp()
    static.io.save_inference_model(d, ["img"], [logits], exe,
                                   main_program=main)
    cfg = inference.Config(d)
    cfg.disable_gpu()
    cfg.enable_int8([{"img": np.ones((2, 3, 16, 16), np.float32)}])
    (out,) = inference.create_predictor(cfg).run(
        {"img": np.ones((2, 3, 16, 16), np.float32)})
    assert out.shape == (2, 4) and np.isfinite(out).all()
    # the static-training slice: fit_a_line, Momentum + L2Decay, 3 steps
    from paddle_tpu_torch import optimizer, regularizer
    from paddle_tpu_torch.io import dataset, reader
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [13])
        y = static.data("y", [1])
        cost = static.mean(static.square_error_cost(static.fc(x, 1), y))
        optimizer.Momentum(0.01, regularization=regularizer.L2Decay(
            1e-4)).minimize(cost)
    exe.run(startup)
    feeder = reader.DataFeeder([main.global_block().var("x"),
                                main.global_block().var("y")])
    losses = [float(exe.run(main, feed=feeder.feed(b), fetch_list=[cost])[0])
              for b in reader.batch(dataset.uci_housing.train(96), 32)()]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    # static AMP: a float16 decorated Momentum step with loss scaling
    from paddle_tpu_torch import amp
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [13])
        y = static.data("y", [1])
        cost = static.mean(static.square_error_cost(static.fc(x, 1), y))
        amp.decorate(optimizer.Momentum(0.01), dest_dtype="float16",
                     init_loss_scaling=64.0).minimize(cost)
    exe.run(startup)
    (lv,) = exe.run(main, feed={"x": np.ones((4, 13), np.float32),
                                "y": np.ones((4, 1), np.float32)},
                    fetch_list=[cost])
    assert np.isfinite(lv).all()
    # the book's word2vec: one Adam step under exponential_decay
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        words = [static.data(f"w{i}", [1], "int64") for i in range(5)]
        embs = [static.reshape(static.embedding(
            w, size=[dataset.imikolov.VOCAB, 8],
            param_attr=ParamAttr(name="shared_emb")), [-1, 8])
            for w in words[:-1]]
        logits = static.fc(static.fc(static.concat(embs, axis=1), 16,
                                     act="relu"), dataset.imikolov.VOCAB)
        cost = static.mean(static.softmax_with_cross_entropy(logits,
                                                             words[-1]))
        optimizer.Adam(static.exponential_decay(0.01, 10, 0.5)).minimize(
            cost)
    exe.run(startup)
    cols = list(zip(*dataset.imikolov.train(16)()))
    feed = {f"w{i}": np.asarray(c).reshape(-1, 1) for i, c in
            enumerate(cols)}
    (lv,) = exe.run(main, feed=feed, fetch_list=[cost])
    from paddle_tpu_torch.core.scope import global_scope
    assert np.isfinite(lv).all()
    assert float(global_scope().find_np("lr_global_step")[0]) == 1.0
    # a toy While beam decode: gru_unit, beam_search, array_write,
    # beam_search_decode, parameters read inside the sub-block
    B, K, V, H = 2, 3, 7, 8
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        h = static.fill_constant([B * K, H], "float32", 0.1)
        pre_ids = static.fill_constant([B, K], "int32", 1)
        pre_scores = static.assign(np.array([[0.0] + [-1e9] * (K - 1)] * B,
                                            np.float32))
        ids_arr = static.create_array(5, [B, K], "int32")
        par_arr = static.create_array(5, [B, K], "int32")
        base = static.reshape(static.range(0, B * K, K, "int32"), [B, 1])
        i = static.fill_constant([1], "int64", 0)
        n = static.fill_constant([1], "int64", 5)
        cond = static.less_than(i, n)
        w = static.While(cond)
        with w.block():
            emb = static.embedding(static.reshape(static.assign(pre_ids),
                                                  [B * K, 1]), [V, 3 * H])
            h_new, _, _ = static.gru_unit(emb, static.assign(h), 3 * H)
            logits = static.reshape(static.fc(h_new, V), [B, K, V])
            sel, sc, par = static.beam_search(
                static.assign(pre_ids), static.assign(pre_scores), logits,
                K, 2)
            static.assign(static.array_write(sel, i, ids_arr), ids_arr)
            static.assign(static.array_write(par, i, par_arr), par_arr)
            static.assign(sel, pre_ids)
            static.assign(sc, pre_scores)
            static.assign(static.gather(h_new, static.reshape(
                static.elementwise_add(par, base), [B * K])), h)
            ni = static.increment(static.assign(i), value=1)
            static.assign(ni, i)
            static.assign(static.less_than(ni, n), cond)
        sent, scores = static.beam_search_decode(ids_arr, par_arr,
                                                 pre_scores, end_id=2)
    exe.run(startup)
    ids, sc = exe.run(main, fetch_list=[sent, scores])
    assert ids.shape == (B, K, 5) and np.isfinite(sc).all()
    assert (sc[:, 0] >= sc[:, -1]).all()
    # the dygraph slice: eager layers, models, checkpoints, AMP, ragged
    import torch
    from paddle_tpu_torch import amp, dygraph_grad_clip, nn as tnn
    from paddle_tpu_torch.io import ragged
    from paddle_tpu_torch.models import deepfm, lenet, resnet, vision_zoo
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)
    cfg = TransformerConfig.tiny()
    cfg.attention_impl = "flash"
    tm = Transformer(cfg, device="cpu")
    src = torch.randint(2, 100, (2, 12))
    src_len = torch.tensor([12, 7])
    trg = torch.randint(2, 100, (2, 10))
    step = tnn.TrainStep(tm, lambda m, *b: m.loss(*b), 0.01)
    first = float(step(src, src_len, trg, trg))
    assert float(step(src, src_len, trg, trg)) < first
    assert tm.greedy_decode(src, src_len, max_len=5).shape == (2, 5)
    seqs, _ = tm.beam_search_decode(src, src_len, max_len=4, beam_size=2)
    assert seqs.shape == (2, 2, 4)
    net = lenet.LeNet(device="cpu")
    path = tnn.save_dygraph(net.state_dict(), tempfile.mkdtemp() + "/le")
    params, _ = tnn.load_dygraph(path)
    net.set_state_dict(params)
    img = torch.rand(2, 1, 28, 28)
    _, traced = tnn.TracedLayer.trace(net, [img])
    assert traced([img]).shape == (2, 10)
    rn = resnet.ResNet(50, 4, width=4, blocks=(1, 1), data_format="NHWC",
                       device="cpu")
    assert rn(torch.rand(2, 16, 16, 3)).shape == (2, 4)
    mb = vision_zoo.MobileNetV1(4, scale=0.25, device="cpu")
    assert mb(torch.rand(2, 3, 32, 32)).shape == (2, 4)
    fm = deepfm.DeepFM(deepfm.DeepFMConfig.tiny(), device="cpu")
    assert torch.isfinite(fm.loss(torch.rand(4, 4),
                                  torch.randint(0, 100, (4, 8)),
                                  torch.randint(0, 2, (4,))))
    sn = tnn.SpectralNorm((4, 3), device="cpu")
    tc = tnn.TreeConv(3, 2, device="cpu")
    assert sn(torch.rand(4, 3)).shape == (4, 3)
    assert tc(torch.rand(1, 3, 3), torch.tensor([[[1, 2], [1, 3]]])
              ).shape == (1, 3, 2, 1)
    scaler = amp.GradScaler(device="cpu")
    grads, inf = scaler.unscale_and_update({"w": torch.ones(2)})
    assert not bool(inf)
    clip = dygraph_grad_clip.GradClipByGlobalNorm(1.0)
    assert clip([("w", torch.ones(4))])[0][1].norm() <= 1.0 + 1e-6
    batches = list(ragged.RaggedBatcher(
        lambda: ((np.arange(n), n) for n in (3, 20, 5, 17)), 2,
        ragged.bucket_boundaries(32))())
    assert [b[0].shape for b in batches] == [(2, 16), (2, 32)]
    # the detection slice: a tiny YOLOv3's loss and predict, a static
    # multi_box_head -> ssd_loss step
    from paddle_tpu_torch.models.yolov3 import YOLOv3, YoloConfig
    yolo = YOLOv3(YoloConfig.tiny(), device="cpu")
    gt = torch.zeros(1, 4, 4)
    gt[0, :2] = torch.tensor([[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.2]])
    assert torch.isfinite(yolo.loss(torch.rand(1, 3, 32, 32), gt,
                                    torch.zeros(1, 4, dtype=torch.int32)))
    yolo.eval()
    with torch.no_grad():
        det = yolo.predict(torch.rand(1, 3, 32, 32),
                           torch.tensor([[32, 32]], dtype=torch.int32))
    assert det.shape == (1, 100, 6)
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        img = static.data("s_img", [2, 3, 32, 32], append_batch_size=False)
        gtb = static.data("s_gtb", [2, 2, 4], append_batch_size=False)
        gtl = static.data("s_gtl", [2, 2, 1], "int64",
                          append_batch_size=False)
        f1 = static.conv2d(img, 4, 3, padding=1, stride=8, act="relu")
        f2 = static.conv2d(f1, 4, 3, padding=1, stride=2, act="relu")
        f3 = static.conv2d(f2, 4, 3, padding=1, stride=2, act="relu")
        locs, confs, box, var = static.multi_box_head(
            [f1, f2, f3], img, base_size=32, num_classes=3,
            aspect_ratios=[[2.0]] * 3, min_ratio=20, max_ratio=90,
            flip=True)
        loss = static.reduce_mean(static.ssd_loss(locs, confs, gtb, gtl,
                                                  box, var))
        optimizer.Momentum(0.01, 0.9).minimize(loss)
    exe.run(startup)
    gtb_v = np.tile(np.array([[0.2, 0.2, 0.6, 0.6], [0.5, 0.1, 0.9, 0.4]],
                             np.float32), (2, 1, 1))
    (lv,) = exe.run(main, feed={"s_img": np.random.rand(2, 3, 32, 32)
                                .astype(np.float32), "s_gtb": gtb_v,
                                "s_gtl": np.ones((2, 2, 1), np.int64)},
                    fetch_list=[loss])
    assert np.isfinite(lv).all()
    # the rest of the op library and the static API: a tiny CRNN-CTC
    # Momentum step (conv, im2sequence, GRUs, warpctc, greedy decode,
    # edit distance), save / load, distributions, contrib, the surface
    from paddle_tpu_torch import average, contrib
    from paddle_tpu_torch.models import crnn_ctc
    from paddle_tpu_torch.static import distributions
    ccfg = crnn_ctc.CRNNConfig.tiny()
    ir.reset_unique_names()
    main, _, startup, names = crnn_ctc.crnn_ctc_programs(ccfg, 2)
    exe.run(startup)
    lv, dec = exe.run(main, feed=crnn_ctc.synthetic_batch(ccfg, 2, 0),
                      fetch_list=[names["loss"], names["decoded"]])
    assert np.isfinite(lv).all() and dec.shape == (2, ccfg.steps)
    d = tempfile.mkdtemp()
    static.save(main, d + "/crnn")
    static.load(main, d + "/crnn", exe)
    assert contrib.op_freq_statistic(main)[0]["gru"] == 2
    nrm = distributions.Normal(np.zeros(2), np.ones(2), device="cpu")
    assert tuple(nrm.sample([3]).shape) == (3, 2)
    wavg = average.WeightedAverage()
    wavg.add(2.0, 1)
    assert wavg.eval() == 2.0
    assert paddle_tpu_torch.Executor is Executor
    # the native runtime: a PS round trip, a dataset-driven step
    import os
    from paddle_tpu_torch import native, ps
    from paddle_tpu_torch.io import fluid_dataset
    srv = ps.Server(tables=[ps.TableConfig(1, "sparse", dim=2)]).start()
    cli = ps.Client(["127.0.0.1:%d" % srv.port]).connect()
    assert cli.pull_sparse(1, np.array([4], np.uint64), 2).shape == (1, 2)
    cli.stop_servers()
    srv.join()
    path = d + "/part-0"
    with open(path, "w") as f:
        f.write("\\n".join("13 " + " ".join(["0.5"] * 13) + " 1 %d" % i
                           for i in range(8)) + "\\n")
    ds = fluid_dataset.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_slots([("x", "dense", 13), ("y", "dense", 1)])
    ds.set_batch_size(4)
    ds.set_filelist([path])
    ds.load_into_memory()
    from paddle_tpu_torch.core.scope import Scope
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        cost = static.mean(static.square_error_cost(
            static.fc(static.data("x", [13]), 1), static.data("y", [1])))
        optimizer.SGD(0.01).minimize(cost)
    sc = Scope()
    exe.run(startup, scope=sc)
    assert len(exe.train_from_dataset(main, ds, fetch_list=[cost],
                                      scope=sc)) == 2
    assert native.library_path().startswith(
        os.path.dirname(paddle_tpu_torch.__file__))
    # the analysis / slim / reader tails: a plan vetoes an overflowing
    # mul, a channel prune, a DataLoader over xmap_readers, a mem://
    # save, an armed lock pair, the AST lint, a NAS step and a download
    modules = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    for sub in ("analysis.numerics", "analysis.concurrency",
                "analysis.interleave", "analysis.astlint", "slim.prune",
                "slim.distill", "slim.nas", "io.fs", "io.dataset_ext"):
        assert "paddle_tpu_torch." + sub in modules, sub
    from paddle_tpu_torch import analysis, slim
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.analysis import astlint, concurrency
    from paddle_tpu_torch.core import flags
    big = ir.Program()
    b = big.global_block()
    b.create_var(name="x", shape=[-1, 200000], dtype="float32",
                 is_data=True)
    b.create_var(name="w", shape=[200000, 2], dtype="float32",
                 persistable=True).desc.is_parameter = True
    b.create_var(name="o", shape=[-1, 2], dtype="float32")
    b.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["o"]})
    assert analysis.plan_quantization(big).vetoed_ops() == [0]
    psc = Scope()
    psc.set("cw", np.ones((4, 2, 3, 3), np.float32))
    slim.Pruner("channel").prune(psc, {"cw": 0.5})
    assert slim.sparsity(psc, ["cw"]) == 0.5
    feeds = list(tio.DataLoader(["a"]).set_sample_generator(
        tio.xmap_readers(lambda s: s, lambda: iter([(1.0,)] * 4), 1, 2),
        2))
    assert len(feeds) == 2 and feeds[0]["a"].shape == (2,)
    from paddle_tpu_torch.core.scope import scope_guard
    with scope_guard(sc):
        static.io.save_params(exe, "mem://iso/p", main_program=main)
    assert tio.fs.get_fs("mem://")[0].exists("mem://iso/p/params.npz")
    flags.set_flag("concurrency_check", True)
    la, lb = concurrency.make_lock("iso.a"), concurrency.make_lock("iso.b")
    with la:
        with lb:
            pass
    with lb:
        with la:
            pass
    assert [f.code for f in concurrency.findings()] == ["lock-order-cycle"]
    flags.set_flag("concurrency_check", False)
    assert astlint.lint_package(os.path.dirname(
        paddle_tpu_torch.__file__)) == {}
    ctl = slim.SAController(seed=0)
    ctl.reset([3, 3])
    assert len(ctl.next_tokens()) == 2
    assert slim.flops_of(torch.matmul, torch.ones(4, 4),
                         torch.ones(4, 4)) == 128
    assert not _build.build_info(), "a CPU step must not build kernels"
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
    assert not leaked, leaked
    print("ISOLATED-OK")
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_and_steps_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK" in proc.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "paddle_tpu"), (
                f"{path.relative_to(REPO)} imports {name}")


def test_source_scan_finds_no_path_into_the_jax_package():
    """No string the port's code uses (docstrings aside) is a path into
    paddle_tpu/, nor joins "paddle_tpu" into one: the native build and
    every data file come from the port's own tree."""
    hits = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and ("paddle_tpu/" in node.value
                         or "paddle_tpu\\" in node.value)):
                hits.append((str(path.relative_to(REPO)), node.lineno))
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "join"
                    and any(isinstance(a, ast.Constant)
                            and a.value == "paddle_tpu" for a in node.args)):
                hits.append((str(path.relative_to(REPO)), node.lineno))
    assert not hits, hits
    from paddle_tpu_torch import native
    for name in native._LIB_SRCS + tuple(
            s for srcs in native._BIN_SRCS.values() for s in srcs):
        assert (pathlib.Path(native.SRC_DIR) / name).is_file(), name
    assert pathlib.Path(native.SRC_DIR).is_relative_to(PKG)
    assert pathlib.Path(native.BUILD_DIR).is_relative_to(PKG / "_build")


_BLOCK = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
""")


def test_launched_children_and_a_pserver_import_neither(tmp_path):
    """A pserver child (fleet.run_server) and two trainers started by the
    launcher (fleet.init_worker, a pull, a push, a barrier,
    fleet.stop_worker), each with jax and paddle_tpu blocked."""
    import socket
    socks = [socket.socket() for _ in range(3)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    ps_port, started, master = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    pserver = f"127.0.0.1:{ps_port}"
    server = tmp_path / "server.py"
    server.write_text(_BLOCK + textwrap.dedent("""
        from paddle_tpu_torch import ps
        from paddle_tpu_torch.distributed import fleet, PaddleCloudRoleMaker
        ps.register_table(ps.TableConfig(1, "sparse", dim=4))
        fleet.init(PaddleCloudRoleMaker(is_collective=False))
        fleet.run_server()
        print("SERVER-OK rows=%d" % ps._active_server.sparse_rows(1))
        assert not any(m.split(".")[0] in ("jax", "paddle_tpu")
                       for m in sys.modules)
    """))
    trainer = tmp_path / "trainer.py"
    trainer.write_text(_BLOCK + textwrap.dedent("""
        import numpy as np
        from paddle_tpu_torch import ps
        from paddle_tpu_torch.distributed import fleet, PaddleCloudRoleMaker
        fleet.init(PaddleCloudRoleMaker(is_collective=False))
        fleet.init_worker()
        rank = fleet.worker_index()
        cli = ps.client()
        ids = np.array([rank, 7], np.uint64)
        cli.push_sparse(1, ids, np.ones((2, 4), np.float32)
                        * cli.pull_sparse(1, ids, 4))
        cli.barrier(rank)
        assert not any(m.split(".")[0] in ("jax", "paddle_tpu")
                       for m in sys.modules)
        print("TRAINER-OK", rank, flush=True)
        cli.barrier(rank)
        fleet.stop_worker()
    """))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PADDLE_", "TRAINING_ROLE"))}
    base["PYTHONPATH"] = str(REPO)
    trainers = f"127.0.0.1:{started},127.0.0.1:{started + 1}"
    srv = subprocess.Popen(
        [sys.executable, str(server)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(base, TRAINING_ROLE="PSERVER", PADDLE_PORT=str(ps_port),
                 POD_IP="127.0.0.1", PADDLE_PSERVERS_IP_PORT_LIST=pserver,
                 PADDLE_TRAINER_ENDPOINTS=trainers))
    try:
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node=2", f"--started_port={started}",
             f"--master_port={master}", f"--log_dir={tmp_path}/logs",
             str(trainer)], cwd=REPO, capture_output=True, text=True,
            timeout=180, env=dict(base, TRAINING_ROLE="TRAINER",
                                  PADDLE_PSERVERS_IP_PORT_LIST=pserver))
        out, _ = srv.communicate(timeout=60)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    logs = [(tmp_path / "logs" / f"workerlog.{i}").read_text()
            for i in range(2)]
    assert r.returncode == 0, (r.stderr[-2000:], logs)
    assert srv.returncode == 0 and "SERVER-OK rows=3" in out, out[-2000:]
    for i, log in enumerate(logs):
        assert f"TRAINER-OK {i}" in log, log[-2000:]


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from paddle_tpu_torch.core.places import (
        CPUPlace, CUDAPlace, resolve_device,
    )
    from paddle_tpu_torch.ops import generation as gen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(CUDAPlace(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.TinyDecoderLM(gen.LMConfig())
    model = gen.TinyDecoderLM(gen.LMConfig(), device=CPUPlace())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.DecodeEngine(model, batch_size=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.PagedDecodeEngine(model, batch_size=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.greedy_decode(model, [1, 2], 3)
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.core.executor import Executor
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.create_predictor(inference.Config("unused_model_dir"))
    from paddle_tpu_torch.models.yolov3 import YOLOv3, YoloConfig
    from paddle_tpu_torch.utils.metrics import DetectionMAP
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YOLOv3(YoloConfig.tiny())
    det_map = DetectionMAP(class_num=2)
    det_map.update([[[1, 0.9, 0, 0, 4, 4]]], [[[1, 0, 0, 4, 4]]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        det_map.eval()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import distributions
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributions.Normal([0.0], [1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        static.load(None, "unused_model_path_never_read")
    assert Executor("cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_scope_from_jax_defaults_to_cuda_and_raises_without_it(
        monkeypatch):
    import numpy as np

    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.weights import scope_from_jax
    arrays = {"fc.w": np.ones((2, 3), np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scope_from_jax(arrays, Scope())
    scope = scope_from_jax(arrays, Scope(), "cpu")
    assert scope.get("fc.w").device == torch.device("cpu")


@pytest.mark.cuda
def test_scope_from_jax_puts_weights_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the default device is the card")
    import numpy as np

    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.weights import scope_from_jax
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    scope = scope_from_jax({"fc.w": arr}, Scope())
    assert scope.get("fc.w").is_cuda
    np.testing.assert_array_equal(scope.get("fc.w").cpu().numpy(), arr)


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in-repo", "script-alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the failure path needs none")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
