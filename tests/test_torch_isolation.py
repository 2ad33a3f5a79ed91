"""The port stands alone: no JAX, no paddle_tpu, no silent CPU fallback.

* In a fresh interpreter with `jax` and `paddle_tpu` blocked on
  sys.meta_path, every module of `paddle_tpu_torch` and `chip_smoke.py`
  imports, and one CPU decode step runs.
* A source scan finds no import of jax or of the JAX package in the
  port or in chip_smoke.py.
* `device=None` means CUDA: without a GPU the entry points raise, and
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
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


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
