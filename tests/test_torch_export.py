"""Program export of the port (paddle_tpu_torch.inference.export) against
the JAX package's (paddle_tpu.inference: export_stablehlo, the AOT
bundle), on the CPU, and K8 as a registered op.

* The JAX package's `test_stablehlo_artifact_executes` on the port: a
  model the JAX package saved and served is loaded by the port, exported
  with `torch.export` and served from the artifact alone, within 1e-5 of
  the JAX Predictor; a wrong shape raises, naming "shape".
* A frozen int8 program: its exported graph names
  `paddle_tpu_torch.fused_dequant_matmul` (K8); the artifact's output is
  bit-equal to the port's int8 Predictor (the same ops on the CPU) and
  within INT8_REL (mean |diff| / mean |reference|, 1e-2, as
  tests/test_torch_inference.py) of the JAX int8 Predictor.
* A program with a host segment (a `while`) is refused, naming the op.
* K8's op and the int8 quantize / rescale ops pass
  `torch.library.opcheck`, and the schemas the libtorch runner registers
  (native/src/aoti_ops.cc) are the Python ones.
* The AOT bundle: the JAX package's `_export_bundle` case
  (tests/test_compile_cache.py, buckets [1, 2]) bit-equal to the port's
  Executor through the `exported` tier; a truncated file is refused; a
  stamp mismatch and a failing native loader degrade to `exported`; a
  native tier compiled for another device is never loaded; a rung with
  no viable tier lists every tier's failure; a JAX package
  bundle is refused by its format name. No test here compiles
  AOTInductor (tens of seconds a rung): the native tier's package is a
  stand-in file, its loader a stub, except in the one test marked slow,
  which builds `pt_aoti_run` against the CPU libtorch and runs a CPU
  AOTInductor package of the int8 net through it.
"""
import json
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.inference import export as texport
from paddle_tpu_torch.ops.kernels import quantized_matmul as k8

INT8_REL = 1e-2


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    prev_m = tir.switch_main_program(tir.Program())
    prev_s = tir.switch_startup_program(tir.Program())
    tir.reset_unique_names()
    with scope_guard(Scope()):
        yield
    tir.switch_main_program(prev_m)
    tir.switch_startup_program(prev_s)


def _jax_fc_model(model_dir, seed=0):
    """The JAX package's two-fc net of test_stablehlo_artifact_executes,
    saved; returns its input [4, 12]."""
    rng = np.random.RandomState(seed)
    exe = pt.Executor()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.static.data("x", [4, 12], "float32", append_batch_size=False)
        h = pt.static.fc(x, 24, act="relu")
        y = pt.static.fc(h, 5, act="softmax")
    exe.run(startup)
    pt.static.io.save_inference_model(model_dir, ["x"], [y], exe,
                                      main_program=main)
    return rng.rand(4, 12).astype(np.float32)


def _jax_run(model_dir, feed, int8_loader=None):
    cfg = JConfig(model_dir)
    if int8_loader is not None:
        cfg.enable_int8(int8_loader)
    pred = jcreate(cfg)
    for n, v in feed.items():
        pred.get_input_handle(n).copy_from_cpu(v)
    return np.asarray(pred.run()[0])


@pytest.fixture(scope="module")
def fc_model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fc") / "m")
    arr = _jax_fc_model(d)
    return d, arr, _jax_run(d, {"x": arr})


def test_stablehlo_artifact_executes(fc_model, tmp_path):
    """The JAX package's case on the port: JAX Predictor -> the port's
    export -> the artifact alone, within 1e-5; a wrong shape raises."""
    model_dir, arr, expected = fc_model
    prog, _, _ = tstatic.io.load_inference_model(model_dir, TExecutor("cpu"))
    art = str(tmp_path / "art")
    path = tinf.export_program(prog, {"x": ((4, 12), "float32")}, art,
                               device="cpu")
    assert path == os.path.join(art, "model.pt2")
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert meta["feed_order"] == ["x"] and meta["format"] == "torch_export"
    assert meta["feeds"] == {"x": [[4, 12], "float32"]}
    assert meta["fetches"] == prog.meta["fetch_targets"]
    tir.switch_main_program(tir.Program())       # nothing of the program
    runner = tinf.load_exported(art, device="cpu")
    outs = runner.run({"x": arr})
    assert len(outs) == 1
    np.testing.assert_allclose(outs[0], expected, rtol=1e-5, atol=1e-5)
    with pytest.raises(EnforceError, match="shape"):
        runner.run({"x": np.random.rand(2, 12).astype(np.float32)})
    with pytest.raises(EnforceError, match="missing feed"):
        runner.run({})
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        tinf.load_exported(art)                 # None is the card
    meta["device"] = "cuda"                     # an artifact of the card's
    with open(os.path.join(art, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(EnforceError, match="exported on cuda"):
        tinf.load_exported(art, device="cpu")


LOADER = [{"x": np.random.RandomState(100 + i).rand(4, 12)
           .astype(np.float32)} for i in range(3)]


@pytest.fixture(scope="module")
def int8_model(fc_model):
    """The fc net frozen to int8 by the port's Predictor (PTQ at load on
    LOADER) and by the JAX package's, and the port Predictor's output."""
    model_dir, arr, _ = fc_model
    cfg = tinf.Config(model_dir)
    cfg.disable_gpu()
    cfg.enable_int8(LOADER)
    pred = tinf.create_predictor(cfg)
    (want,) = pred.run({"x": arr})
    return pred, arr, want, _jax_run(model_dir, {"x": arr}, LOADER)


def test_int8_export_names_k8_and_matches_the_predictors(int8_model,
                                                         tmp_path):
    pred, arr, want, jax_int8 = int8_model
    types = [op.type for op in pred._program.global_block().ops]
    assert types.count("quantized_mul") == 2, types
    art = str(tmp_path / "int8")
    tinf.export_program(pred._program, {"x": ((4, 12), "float32")}, art,
                        scope=pred._scope, device="cpu")
    runner = tinf.load_exported(art, device="cpu")
    targets = [str(n.target) for n in runner.exported_program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paddle_tpu_torch.fused_dequant_matmul.default") \
        == 2, targets
    (got,) = runner.run({"x": arr})
    np.testing.assert_array_equal(got, want)
    rel = np.abs(got - jax_int8).mean() / np.abs(jax_int8).mean()
    assert rel < INT8_REL, rel


def test_program_with_a_host_segment_is_refused(tmp_path):
    S = tstatic
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = S.data("x", [2], "float32", append_batch_size=False)
        n = S.fill_constant([1], "int64", 3)
        i = S.fill_constant([1], "int64", 0)
        cond = S.less_than(i, n)
        w = S.While(cond)
        with w.block():
            ni = S.increment(S.assign(i), value=1)
            S.assign(ni, i)
            S.assign(S.less_than(ni, n), cond)
        out = S.scale(x, 2.0)
    main.meta["feed_targets"] = ["x"]
    main.meta["fetch_targets"] = [out.name]
    with pytest.raises(EnforceError, match=r"op \d+ 'while' runs on the "
                       "host"):
        tinf.export_program(main, {"x": ((2,), "float32")},
                            str(tmp_path / "w"), device="cpu")
    assert not os.path.exists(tmp_path / "w" / "model.pt2")


def test_k8_ops_pass_opcheck_and_the_runner_registers_their_schemas():
    """K8 and the int8 quantize / rescale it shares with the frozen conv
    pass opcheck, K8 equals its plain version, and aoti_ops.cc registers
    the Python schemas character for character."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(5, 33).astype(np.float32))
    w_q = torch.from_numpy(rng.randint(-127, 128, (33, 17)).astype(np.int8))
    w_s = torch.from_numpy(rng.rand(17).astype(np.float32) + 0.1)
    for args in ((x, w_q, w_s, 2.5, 8), (x, w_q, w_s, None, 8),
                 (x, w_q, w_s, 1.0, 4)):
        torch.library.opcheck(k8.op().default, args)
        np.testing.assert_array_equal(
            k8.op()(*args).numpy(),
            k8.dequant_matmul_reference(*args[:3], x_scale=args[3],
                                        bits=args[4]).numpy())
    x8 = torch.from_numpy(rng.randn(2, 3, 4, 5).astype(np.float32))
    acc = torch.from_numpy(rng.randint(-9000, 9000, (2, 3, 4, 5))
                           .astype(np.int32))
    for name, args in (("quantize_activation", (x8, 0.7, 8)),
                       ("quantize_activation", (x, 2.5, 4)),
                       ("int8_rescale", (acc, w_s[:3], 0.7, 8))):
        torch.library.opcheck(getattr(torch.ops.paddle_tpu_torch, name)
                              .default, args)
    src = open(os.path.join(os.path.dirname(tinf.__file__), os.pardir,
                            "native", "src", "aoti_ops.cc")).read()
    for var, schema in (("kSchema", k8.OP_SCHEMA),
                        ("kQuantizeSchema", k8.QUANTIZE_SCHEMA),
                        ("kRescaleSchema", k8.RESCALE_SCHEMA)):
        name = schema.split("(", 1)[0]
        assert str(getattr(torch.ops.paddle_tpu_torch, name).default
                   ._schema) == "paddle_tpu_torch::" + schema
        decl = src[src.index(f"{var} ="):].split(";", 1)[0]
        assert "".join(re.findall(r'"([^"]*)"', decl)) == schema, var


# ---- the AOT bundle ------------------------------------------------------

_B2 = np.arange(12, dtype=np.float32).reshape(2, 6) / 12.0


def _port_bundle(tmp_path, monkeypatch=None, native=False):
    """The JAX package's `_export_bundle` program on the port, exported
    with buckets [1, 2]; with `native`, the native tier's package is a
    stand-in file (no AOTInductor compile on the CPU)."""
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tstatic.data("x", [-1, 6], "float32")
        out = tstatic.fc(x, 4, act="softmax")
    exe = TExecutor("cpu")
    exe.run(startup)
    main.meta["feed_targets"] = ["x"]
    main.meta["fetch_targets"] = [out.name]
    if native:
        monkeypatch.setattr(texport, "_compile_aoti",
                            lambda ep, path: open(path, "wb").write(b"aoti"))
    bdir = str(tmp_path / "bundle")
    path = tinf.export_aot_bundle(main, {"x": ((1, 6), "float32")}, bdir,
                                  buckets=[1, 2], device="cpu",
                                  native=native)
    assert path == os.path.join(bdir, "BUNDLE.json")
    ref = exe.run(main, feed={"x": _B2}, fetch_list=[out], training=False)
    return bdir, np.asarray(ref[0])


def test_aot_bundle_round_trips_bit_exact(tmp_path):
    bdir, ref = _port_bundle(tmp_path)
    with open(os.path.join(bdir, "BUNDLE.json")) as f:
        doc = json.load(f)
    assert doc["format"] == "ptt-aot-bundle-v1"
    assert doc["stamp"]["platform"] == "cpu" and doc["feed_order"] == ["x"]
    assert [r["dir"] for r in doc["buckets"]] == ["bucket_1", "bucket_2"]
    assert all(r["tiers"] == ["exported"] for r in doc["buckets"])
    assert sorted(doc["files"]) == sorted(
        f"bucket_{b}/{n}" for b in (1, 2) for n in ("model.pt2",
                                                    "meta.json"))
    bundle = tinf.load_aot_bundle(bdir, device="cpu")
    assert sorted(bundle.runners) == [1, 2]
    assert bundle.tiers == {1: "exported", 2: "exported"}
    assert "native: not in this bundle" in bundle.errors[2][0]
    out = bundle.runners[2].run({"x": _B2})
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(
        bundle.runners[1].run({"x": _B2[1:]})[0], ref[1:])
    with pytest.raises(EnforceError, match="shape"):
        bundle.runners[1].run({"x": _B2})


def test_aot_bundle_truncated_file_is_refused(tmp_path):
    bdir, _ = _port_bundle(tmp_path)
    victim = os.path.join(bdir, "bucket_2", "model.pt2")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(EnforceError, match="corrupt|missing"):
        tinf.load_aot_bundle(bdir, device="cpu")
    os.unlink(victim)
    with pytest.raises(EnforceError, match="corrupt|missing"):
        tinf.load_aot_bundle(bdir, device="cpu")


def test_aot_bundle_tier_ladder(tmp_path, monkeypatch):
    """With a native tier in the bundle: a matching stamp and a loader
    that works serve `native`; a stamp mismatch, or a loader that fails,
    degrade to `exported` (bit-exact); a rung whose every tier fails
    raises at load, naming each."""
    from paddle_tpu_torch.core import compile_cache
    bdir, ref = _port_bundle(tmp_path, monkeypatch, native=True)
    with open(os.path.join(bdir, "BUNDLE.json")) as f:
        doc = json.load(f)
    assert all(r["tiers"] == ["native", "exported"] for r in doc["buckets"])
    assert "bucket_2/model.aoti.pt2" in doc["files"]
    calls = []

    def stub_native(path, device):
        calls.append(path)
        return lambda args: [torch.full((args[0].shape[0], 4), 7.0)]

    monkeypatch.setattr(texport, "_load_aoti", stub_native)
    bundle = tinf.load_aot_bundle(bdir, device="cpu")
    assert bundle.stamp_ok and bundle.tiers == {1: "native", 2: "native"}
    assert calls[-1] == os.path.join(bdir, "bucket_2", "model.aoti.pt2")
    np.testing.assert_array_equal(bundle.runners[2].run({"x": _B2})[0],
                                  np.full((2, 4), 7.0, np.float32))

    stamp = compile_cache.device_stamp()
    monkeypatch.setattr(compile_cache, "device_stamp",
                        lambda: dict(stamp, device_kind="another card"))
    bundle = tinf.load_aot_bundle(bdir, device="cpu")
    assert not bundle.stamp_ok
    assert bundle.tiers == {1: "exported", 2: "exported"}
    assert bundle.errors[2] == ["native: device stamp mismatch"]
    np.testing.assert_array_equal(bundle.runners[2].run({"x": _B2})[0], ref)
    monkeypatch.setattr(compile_cache, "device_stamp", lambda: stamp)

    def failing_native(path, device):
        raise RuntimeError("no AOTInductor runtime here")

    monkeypatch.setattr(texport, "_load_aoti", failing_native)
    bundle = tinf.load_aot_bundle(bdir, device="cpu")
    assert bundle.tiers == {1: "exported", 2: "exported"}
    assert bundle.errors[1] == ["native: no AOTInductor runtime here"]
    np.testing.assert_array_equal(bundle.runners[2].run({"x": _B2})[0], ref)

    def failing_load(path):
        raise RuntimeError("unreadable archive")

    monkeypatch.setattr(torch.export, "load", failing_load)
    with pytest.raises(RuntimeError, match=r"rung bucket_1: no viable tier "
                       r"\(native: no AOTInductor runtime here; exported: "
                       r"unreadable archive\)"):
        tinf.load_aot_bundle(bdir, device="cpu")


def test_aot_bundle_native_tier_loads_only_on_its_device(tmp_path,
                                                        monkeypatch):
    """A rung compiled on the card asked for on the CPU skips its native
    tier (the package would run on the card while the feeds stay on the
    CPU): with the stamp matching and a native loader that works, the
    load raises, naming the native tier's device and the exported
    tier's, and the native loader is never called."""
    bdir, _ = _port_bundle(tmp_path, monkeypatch, native=True)
    calls = []
    monkeypatch.setattr(texport, "_load_aoti",
                        lambda path, device: calls.append(path))
    assert tinf.load_aot_bundle(bdir, device="cpu").tiers == {
        1: "native", 2: "native"}
    assert len(calls) == 2
    read_meta = texport._read_meta
    monkeypatch.setattr(texport, "_read_meta",
                        lambda d: dict(read_meta(d), device="cuda"))
    with pytest.raises(RuntimeError, match=r"rung bucket_1: no viable tier "
                       r"\(native: compiled for cuda, loading on cpu; "
                       r"exported: .* was exported on cuda; load it there, "
                       r"not on cpu\)"):
        tinf.load_aot_bundle(bdir, device="cpu")
    assert len(calls) == 2


def test_jax_package_bundle_is_refused_by_its_format(tmp_path):
    from paddle_tpu import inference as jinf
    exe = pt.Executor()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.static.data("x", [-1, 6], "float32")
        out = pt.static.fc(x, 4, act="softmax")
    exe.run(startup)
    main.meta["feed_targets"] = ["x"]
    main.meta["fetch_targets"] = [out.name]
    bdir = str(tmp_path / "jax_bundle")
    jinf.export_aot_bundle(main, {"x": ((1, 6), "float32")}, bdir)
    with pytest.raises(EnforceError, match="'pt-aot-bundle-v1' is not "
                       "'ptt-aot-bundle-v1'"):
        tinf.load_aot_bundle(bdir, device="cpu")
    with pytest.raises(EnforceError, match="'stablehlo' artifact"):
        tinf.load_exported(os.path.join(bdir, "bucket_default"),
                           device="cpu")


@pytest.mark.slow
def test_pt_aoti_run_serves_the_int8_package_on_the_cpu(int8_model,
                                                        tmp_path):
    """Slow (~2 min): builds pt_aoti_run against the CPU libtorch (~30 s)
    and compiles the int8 net's rung with AOTInductor (~20-50 s). The
    binary runs the package with K8's op registered by aoti_ops.cc (its
    plain version on the CPU): outputs equal the Python-loaded package's
    and, within INT8_REL, the port Predictor's; its last line reads ok."""
    from paddle_tpu_torch import native
    pred, arr, want, _ = int8_model
    bdir = str(tmp_path / "b")
    tinf.export_aot_bundle(pred._program, {"x": ((4, 12), "float32")}, bdir,
                           scope=pred._scope, device="cpu", native=True)
    bundle = tinf.load_aot_bundle(bdir, device="cpu")
    assert bundle.tiers == {None: "native"}
    (py_out,) = bundle.runners[None].run({"x": arr})
    rel = np.abs(py_out - want).mean() / np.abs(want).mean()
    assert rel < INT8_REL, rel
    exe = native.build_pt_aoti_run()
    np.save(tmp_path / "x.npy", arr)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    proc = subprocess.run(
        [exe, "--model-dir", os.path.join(bdir, "bucket_default"),
         "--input", f"x={tmp_path / 'x.npy'}", "--output-dir",
         str(out_dir), "--repeat", "3"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["ok"] and doc["engine"] == "aoti" and doc["n_outputs"] == 1
    assert doc["device"] == "cpu" and doc["k8_launches"] == 0
    np.testing.assert_array_equal(np.load(out_dir / "out_0.npy"), py_out)
