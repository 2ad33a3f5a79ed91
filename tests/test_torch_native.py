"""The port's native C++ runtime (paddle_tpu_torch.native) against the
JAX package's (paddle_tpu.native), on the CPU.

* The build: the port compiles its own copy of the sources
  (paddle_tpu_torch/native/src) into paddle_tpu_torch/_build/native;
  loading it leaves every file under paddle_tpu/native/ as it was.
  Processes that load at once build once (the file lock; each sees the
  same library file), and a source that does not compile raises
  NativeBuildError with nothing loaded.
* NativeDataset: batches, local shuffles, global_shuffle's trainer
  partitions and the parse error equal the JAX package's on the same
  files and seeds.
* NativePredictor and pt_infer on a model the port saved equal the JAX
  package's NativePredictor on it; the Predictor behind
  Config.enable_native_engine() agrees with the Executor's Predictor;
  pt_train trains the port's saved program as the port's Executor does.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu import native as jnative
from paddle_tpu_torch import native as tnative

REPO = pathlib.Path(__file__).resolve().parents[1]
SLOTS = [("feat", "dense", 3), ("ids", "sparse", 0)]


def _run_py(code, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=timeout)


def _mtimes(root):
    return {str(p): p.stat().st_mtime_ns for p in root.rglob("*")
            if p.is_file()}


def test_library_is_the_ports_and_leaves_the_jax_package_untouched():
    build = pathlib.Path(tnative.BUILD_DIR)
    assert build.parent == REPO / "paddle_tpu_torch" / "_build"
    assert pathlib.Path(tnative.SRC_DIR) == (REPO / "paddle_tpu_torch"
                                             / "native" / "src")
    assert pathlib.Path(tnative.library_path()).parent == build
    objs, _ = tnative._plan(tnative._LIB_SRCS, ["g++"])
    for o, cmd in objs:
        assert pathlib.Path(o).parent == build / "obj"
        assert pathlib.Path(cmd[-1]).parent == pathlib.Path(tnative.SRC_DIR)
    # built once (maybe by another test), then a fresh process loads it
    tnative.load()
    before = _mtimes(REPO / "paddle_tpu" / "native")
    proc = _run_py(
        "from paddle_tpu_torch import native\n"
        "lib = native.load()\n"
        "print(lib._name)\n"
        "import sys\n"
        "assert not any(m.split('.')[0] in ('jax', 'paddle_tpu')\n"
        "               for m in sys.modules)\n")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == tnative.library_path()
    assert _mtimes(REPO / "paddle_tpu" / "native") == before


def _scratch_build(tmp_path):
    """A copy of the sources and of the object cache: builds there only
    link (or recompile what a test changed)."""
    src, build = tmp_path / "src", tmp_path / "build"
    shutil.copytree(tnative.SRC_DIR, src)
    tnative.load()
    shutil.copytree(os.path.join(tnative.BUILD_DIR, "obj"), build / "obj")
    return str(src), str(build)


def test_processes_loading_at_once_build_once(tmp_path):
    src, build = _scratch_build(tmp_path)
    code = (
        "import os\n"
        "from paddle_tpu_torch import native\n"
        f"native.SRC_DIR, native.BUILD_DIR = {src!r}, {build!r}\n"
        "native.load()\n"
        "print(os.stat(native.library_path()).st_ino)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    inodes = {o.strip() for o, _ in outs}
    assert len(inodes) == 1, inodes
    assert not [f for f in os.listdir(build) if f.startswith(".libpt")]


def test_a_failed_build_raises_and_loads_nothing(tmp_path, monkeypatch):
    src, build = _scratch_build(tmp_path)
    with open(os.path.join(src, "datafeed.cc"), "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(tnative, "SRC_DIR", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", build)
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(tnative.NativeBuildError, match="datafeed.cc"):
        tnative.load()
    assert tnative._lib is None
    assert not tnative.available()
    assert not os.path.exists(os.path.join(build, "libpt_native.so"))
    # pt_aoti_run (XLA's pt_pjrt_run's counterpart) is built too, and a
    # failed build raises the same way: here without torch's include
    # paths, so both sources stop at their first #include
    assert not hasattr(tnative, "build_pt_pjrt_run")
    monkeypatch.setattr(tnative, "_libtorch_flags", lambda lib: (
        ("-O2", "-std=c++17", "-fPIC"), ["-ldl"]))
    with pytest.raises(tnative.NativeBuildError,
                       match="(pt_aoti_run|aoti_ops).cc: build failed"):
        tnative.build_pt_aoti_run()
    assert not os.path.exists(os.path.join(build, "pt_aoti_run"))


@pytest.fixture(scope="module")
def multislot(tmp_path_factory):
    """3 MultiSlot files: a dense slot of 3 and a ragged sparse slot."""
    rng = np.random.RandomState(3)
    d = tmp_path_factory.mktemp("multislot")
    files = []
    for fi in range(3):
        p = d / f"part-{fi}.txt"
        with open(p, "w") as f:
            for _ in range(100):
                dense = " ".join(f"{v:.4f}" for v in rng.randn(3))
                n = rng.randint(1, 5)
                ids = " ".join(str(rng.randint(0, 1000)) for _ in range(n))
                f.write(f"3 {dense} {n} {ids}\n")
        files.append(str(p))
    return files


def _batches(mod, files, shuffle=None, trainer=None, bs=64):
    ds = mod.NativeDataset(SLOTS)
    ds.set_filelist(files)
    ds.load_into_memory(1)          # one reader: file order
    if shuffle == "local":
        ds.local_shuffle(42)
    elif shuffle == "global":
        ds.set_trainer(*trainer)
        ds.global_shuffle(7)
    return ds.size(), list(ds.batches(bs))


@pytest.mark.parametrize("case", ["plain", "local", "global0", "global1"])
def test_dataset_batches_equal_the_references(multislot, case):
    shuffle = None if case == "plain" else case.rstrip("01")
    trainer = (int(case[-1]), 2) if shuffle == "global" else None
    jn, jb = _batches(jnative, multislot, shuffle, trainer)
    tn, tb = _batches(tnative, multislot, shuffle, trainer)
    assert tn == jn and len(tb) == len(jb)
    if shuffle != "global":
        assert tn == 300
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t["feat"], j["feat"])
        for a, b in zip(t["ids"], j["ids"]):
            np.testing.assert_array_equal(a, b)


def test_global_shuffle_partitions_the_records(multislot):
    sizes = [_batches(tnative, multislot, "global", (i, 2))[0]
             for i in range(2)]
    assert sum(sizes) == 300 and min(sizes) > 100


def test_parse_error_equals_the_references(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("3 1.0 2.0\n")      # the dense slot claims 3 values
    msgs = []
    for mod in (jnative, tnative):
        ds = mod.NativeDataset([("feat", "dense", 3)])
        ds.set_filelist([str(p)])
        with pytest.raises(RuntimeError) as e:
            ds.load_into_memory(1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "parse error" in msgs[1]


def _port_model(d):
    """A small MLP + softmax the port builds, initialises and saves."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 4
    with ir.program_guard(main, startup):
        x = static.data("x", [-1, 6], append_batch_size=False)
        h = static.fc(x, 8, act="relu")
        out = static.softmax(static.fc(h, 3))
    exe = Executor("cpu")
    exe.run(startup)
    static.io.save_inference_model(d, ["x"], [out], exe, main_program=main)
    return out


def test_native_predictor_and_pt_infer_equal_the_references(tmp_path):
    d = str(tmp_path / "m")
    _port_model(d)
    x = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    (want,) = jnative.NativePredictor(d).run({"x": x})
    tp = tnative.NativePredictor(d)
    assert tp.input_names() == ["x"]
    (got,) = tp.run({"x": x})
    np.testing.assert_array_equal(got, want)
    (clone,) = tp.clone().run({"x": x})
    np.testing.assert_array_equal(clone, want)
    exe = tnative.build_pt_infer()
    assert pathlib.Path(exe).parent == pathlib.Path(tnative.BUILD_DIR)
    np.save(tmp_path / "x.npy", x)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    proc = subprocess.run([exe, "--model-dir", d, "--output-dir",
                           str(out_dir), "--input", f"x={tmp_path}/x.npy"],
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["ok"] is True
    with open(out_dir / "outputs.json") as f:
        idx = json.load(f)
    np.testing.assert_array_equal(
        np.load(out_dir / idx["fetches"][0]["file"]), want)


def test_native_engine_predictor_matches_the_executors(tmp_path):
    from paddle_tpu_torch import inference
    d = str(tmp_path / "m")
    _port_model(d)
    x = np.random.RandomState(1).randn(4, 6).astype(np.float64)
    cfg = inference.Config(d)
    cfg.disable_gpu()
    (want,) = inference.create_predictor(cfg).run({"x": x})
    cfg.enable_native_engine()
    pred = inference.create_predictor(cfg)
    assert type(pred).__name__ == "_NativeEnginePredictor"
    pred.get_input_handle("x").copy_from_cpu(x)      # float64 -> declared
    (got,) = pred.run()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu(),
        got)
    (again,) = pred.clone().run({"x": x})
    np.testing.assert_array_equal(again, got)
    cfg.enable_int8([{"x": x}])
    with pytest.raises(Exception, match="float32"):
        inference.create_predictor(cfg)


def test_pt_train_trains_the_ports_program_as_its_executor(tmp_path):
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    rng = np.random.RandomState(2)
    xs = rng.rand(16, 8).astype(np.float32)
    ys = (xs @ rng.rand(8, 1)).astype(np.float32)
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        x = static.data("x", [-1, 8], append_batch_size=False)
        y = static.data("y", [-1, 1], append_batch_size=False)
        loss = static.mean(static.square(static.fc(x, 1) - y))
        optimizer.SGD(0.1).minimize(loss)
    exe = Executor("cpu")
    exe.run(startup)
    model_dir = tmp_path / "train"
    model_dir.mkdir()
    static.io.save_persistables(exe, str(model_dir), main_program=main)
    with open(model_dir / "__model__.json", "w") as f:
        json.dump(main.to_dict(), f)
    want = [float(np.asarray(exe.run(main, feed={"x": xs, "y": ys},
                                     fetch_list=[loss])[0]))
            for _ in range(5)]
    np.save(tmp_path / "x.npy", xs)
    np.save(tmp_path / "y.npy", ys)
    proc = subprocess.run(
        [tnative.build_pt_train(), "--model-dir", str(model_dir), "--loss",
         loss.name, "--steps", "5", "--input", f"x={tmp_path}/x.npy",
         "--input", f"y={tmp_path}/y.npy"], capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert lines[-1]["ok"] is True
    np.testing.assert_allclose([ln["loss"] for ln in lines[:-1]], want,
                               rtol=1e-4, atol=1e-4)
