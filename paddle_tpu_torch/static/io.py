"""Model save/load.

Counterpart of paddle_tpu/static/io.py (the reference's python/paddle/
fluid/io.py: save_persistables :523, save/load_inference_model
:1011/:1215). Persistence is a host-side operation on the Scope:

    dirname/
      __model__.json     the serialized Program (ProgramDesc analogue)
      params.npz         every persistable var (numpy archive)

The artifact is the JAX package's, so each package loads what the other
saved. Every file is published atomically (write a temp file, then
rename). Paths go through `io.fs` (`get_fs` / `join`), so `file://`,
`mem://` and any registered scheme work as local paths do.
"""
import json
import os
import zipfile

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.core.ir import Program, Variable, default_main_program
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.io.fs import get_fs, join as _fs_join
from paddle_tpu_torch.reliability.faults import inject_point

__all__ = ["MODEL_FILENAME", "PARAMS_FILENAME", "CheckpointError",
           "save_persistables", "save_params", "load_persistables", "prune",
           "save_inference_model", "load_inference_model", "save", "load"]

MODEL_FILENAME = "__model__.json"
PARAMS_FILENAME = "params.npz"


class CheckpointError(Exception):
    """A model/checkpoint file is missing, truncated, or corrupt — the
    message names the file."""


def _atomic_write(fs, path, mode, writer, params_file=False):
    """Write-temp-then-rename on `fs`: `writer(f)` fills a sibling temp
    file, which replaces `path` only after the write completed, so a
    crash leaves the previous file (and an inert temp), never a truncated
    one. A params file passes the `io.save_persistables` fault site
    between write and publish."""
    tmp = path + ".saving"
    with fs.open(tmp, mode) as f:
        writer(f)
    if params_file:
        inject_point("io.save_persistables", tag=path)
    fs.rename(tmp, path)


def _collect_persistables(program, scope):
    out = {}
    for v in program.list_vars():
        if v.persistable and scope.has(v.name):
            out[v.name] = scope.find_np(v.name)
    return out


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Write every persistable var of the program that the scope holds
    (io.py:523), atomically."""
    program = main_program or default_main_program()
    fs, dirname = get_fs(dirname)
    fs.mkdirs(dirname)
    arrs = _collect_persistables(program, global_scope())
    enforce(arrs, "nothing persistable to save")
    _atomic_write(fs, _fs_join(dirname, filename or PARAMS_FILENAME), "wb",
                  lambda f: np.savez(f, **arrs), params_file=True)


save_params = save_persistables


def load_persistables(executor, dirname, main_program=None, filename=None):
    """Read a params file into the current scope, as tensors on the
    executor's device; without an executor, on the GPU
    (`core.places.resolve_device(None)`: raises when none is visible)."""
    fs, dirname = get_fs(dirname)
    path = _fs_join(dirname, filename or PARAMS_FILENAME)
    inject_point("io.load_persistables", tag=path)
    try:
        with fs.open(path, "rb") as f, np.load(f) as data:
            loaded = {name: np.asarray(data[name]) for name in data.files}
    except (OSError, EnforceError) as e:
        raise CheckpointError(
            f"params file {path} missing or unreadable: {e}") from e
    except (ValueError, KeyError, zipfile.BadZipFile) as e:
        raise CheckpointError(
            f"params file {path} is corrupt (truncated write?): {e}") from e
    device = (executor.device if executor is not None
              else resolve_device(None))
    scope = global_scope()
    for name, arr in loaded.items():
        scope.set(name, torch.from_numpy(arr).to(device))


def _op_block_attrs(op):
    """Every sub-block an op references (sub_block, else_block, ...)."""
    return [v for k, v in op.attrs.items()
            if k.endswith("_block") and isinstance(v, int) and v >= 0]


def _subblock_refs(program, block_idx, seen=None):
    """Names a sub-block (and its nested sub-blocks) reads from ancestor
    blocks."""
    seen = set() if seen is None else seen
    if block_idx in seen:
        return set()
    seen.add(block_idx)
    sub = program.blocks[block_idx]
    names = set()
    for op in sub.ops:
        names |= set(op.input_names()) | set(op.output_names())
        for idx in _op_block_attrs(op):
            names |= _subblock_refs(program, idx, seen)
    return {n for n in names if n not in sub.vars}


def prune(program, fetch_names):
    """Dead-op elimination backward from the fetch targets (Program._prune
    parity, used by save_inference_model)."""
    pruned = Program.from_dict(program.to_dict())
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if op.type == "autodiff":
            continue
        if set(op.output_names()) & needed:
            keep.append(op)
            needed |= set(op.input_names())
            for idx in _op_block_attrs(op):
                needed |= _subblock_refs(pruned, idx)
    block.ops = list(reversed(keep))
    used = set()
    for op in block.ops:
        used |= set(op.input_names()) | set(op.output_names())
        for idx in _op_block_attrs(op):
            used |= _subblock_refs(pruned, idx)
    used |= set(fetch_names)
    block.vars = {k: v for k, v in block.vars.items() if k in used}
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         optimize=True):
    """io.py:1011 parity: clone for test, prune to the feed → fetch
    subgraph, run the export passes (inference/optimize.py: conv+BN fold,
    conv+act fuse, fc fuse, constant fold) on detached copies of the
    params, and save program and params. Returns the fetch names."""
    program = (main_program or default_main_program()).clone(for_test=True)
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    program = prune(program, fetch_names)
    program.meta["feed_targets"] = list(feeded_var_names)
    program.meta["fetch_targets"] = fetch_names
    program.meta["is_test"] = True

    arrs = _collect_persistables(program, global_scope())
    if optimize:
        from paddle_tpu_torch.inference.optimize import (
            optimize_inference_program,
        )
        program, arrs = optimize_inference_program(program, arrs)
        program.meta["ir_optimized"] = True  # Predictor load skips rerun

    fs, dirname = get_fs(dirname)
    fs.mkdirs(dirname)
    # params first, program last: the artifact is loadable iff the model
    # file exists, so a crash between the two never yields a program
    # whose params are missing
    _atomic_write(fs, _fs_join(dirname, params_filename or PARAMS_FILENAME),
                  "wb", lambda f: np.savez(f, **arrs),
                  params_file=True)
    _atomic_write(fs, _fs_join(dirname, model_filename or MODEL_FILENAME),
                  "w", lambda f: json.dump(program.to_dict(), f))
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """io.py:1215 parity → (program, feed_target_names, fetch_targets);
    the params go into the current scope on the executor's device."""
    fs, fs_dirname = get_fs(dirname)
    mpath = _fs_join(fs_dirname, model_filename or MODEL_FILENAME)
    try:
        with fs.open(mpath, "r") as f:
            program = Program.from_dict(json.load(f))
    except (OSError, EnforceError) as e:
        raise CheckpointError(
            f"model file {mpath} missing or unreadable: {e}") from e
    except ValueError as e:
        raise CheckpointError(
            f"model file {mpath} is corrupt (truncated write?): {e}") from e
    load_persistables(executor, dirname, program, params_filename)
    feeds = program.meta.get("feed_targets", [])
    fetches = [program.global_block().var(n)
               for n in program.meta.get("fetch_targets", [])]
    return program, feeds, fetches


def save(program, model_path):
    """fluid.save (io.py:1493): the program's persistables to
    `model_path`.npz and the program to `model_path`.json, each
    published atomically; the JAX package's two files."""
    fs, path = get_fs(model_path)
    if os.path.dirname(path):
        fs.mkdirs(os.path.dirname(path))
    arrs = _collect_persistables(program, global_scope())
    _atomic_write(fs, path + ".npz", "wb",
                  lambda f: np.savez(f, **arrs), params_file=True)
    _atomic_write(fs, path + ".json", "w",
                  lambda f: json.dump(program.to_dict(), f))


def load(program, model_path, executor=None):
    """fluid.load: every array of `model_path`.npz into the current
    scope, on the executor's device (None: CUDA, as
    `core.places.resolve_device`)."""
    device = (executor.device if executor is not None
              else resolve_device(None))
    fs, path = get_fs(model_path)
    path += ".npz"
    try:
        with fs.open(path, "rb") as f, np.load(f) as data:
            loaded = {name: np.asarray(data[name]) for name in data.files}
    except (OSError, EnforceError) as e:
        raise CheckpointError(
            f"state file {path} missing or unreadable: {e}") from e
    except (ValueError, zipfile.BadZipFile) as e:
        raise CheckpointError(f"state file {path} is corrupt: {e}") from e
    scope = global_scope()
    for name, arr in loaded.items():
        scope.set(name, torch.from_numpy(arr).to(device))
