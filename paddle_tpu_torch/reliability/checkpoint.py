"""Crash-safe checkpoints: manifest + CRC + atomic publish + resume.

Counterpart of paddle_tpu/reliability/checkpoint.py, on the same disk
layout, so a checkpoint written by either package restores in the
other::

    dir/
      ckpt-42/
        params.npz       persistable vars (static/io.py format)
        MANIFEST.json    {"step", "format", "files": {name: {crc32,
                         size}}, "meta"} — written LAST
      ckpt-50.tmp/       an interrupted write (ignored, GC'd)

* writes land in `ckpt-<step>.tmp/` and are published with one
  `os.replace` after the CRC32-stamped manifest is in place — a crash at
  any byte leaves either the previous snapshot set or an inert .tmp;
* `latest_valid()` walks steps newest-first and returns the first
  snapshot whose manifest parses AND every file matches its recorded
  size and CRC — truncated or bit-flipped snapshots are skipped;
* keep-last-N GC never deletes the newest valid snapshot;
* `inject_point("checkpoint.write" / "checkpoint.read")` sit on both
  paths.

`restore_into_scope` writes each restored value into the tensor the
scope already holds under that name, in place, when shape and dtype
match: on the card that tensor is the one an Executor entry's captured
graphs are bound to (`Scope.bind`), so a graph captured before the
restore replays on the restored values.
"""
import json
import os
import shutil
import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.reliability.faults import inject_point

__all__ = ["CheckpointManager", "MANIFEST_FILENAME", "PARAMS_FILENAME"]

MANIFEST_FILENAME = "MANIFEST.json"
PARAMS_FILENAME = "params.npz"
MANIFEST_FORMAT = 1


def _crc32_file(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


class CheckpointManager:
    """Step-indexed, validated checkpoints over the static/io.py
    persistable format."""

    def __init__(self, directory, keep=3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step):
        return os.path.join(self.directory, f"ckpt-{int(step)}")

    def all_steps(self):
        """Every published (non-.tmp) step directory, ascending; validity
        not checked."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("-", 1)[1]))
                except ValueError:
                    pass
        return sorted(steps)

    # -- validation ----------------------------------------------------
    def validate(self, step):
        """(ok, reason): the manifest parses and every recorded file
        matches its size and CRC32."""
        d = self._step_dir(step)
        mpath = os.path.join(d, MANIFEST_FILENAME)
        if not os.path.isfile(mpath):
            return False, "missing manifest"
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except ValueError:
            return False, "corrupt manifest (not JSON)"
        files = manifest.get("files")
        if manifest.get("step") != step or not isinstance(files, dict):
            return False, "manifest does not describe this step"
        for name, rec in files.items():
            p = os.path.join(d, name)
            if not os.path.isfile(p):
                return False, f"missing file {name}"
            if os.path.getsize(p) != rec.get("size"):
                return False, f"truncated file {name}"
            if _crc32_file(p) != rec.get("crc32"):
                return False, f"CRC mismatch in {name}"
        return True, "ok"

    def valid_steps(self):
        return [s for s in self.all_steps() if self.validate(s)[0]]

    def latest_valid(self):
        """Newest step that passes validation, or None: the resume
        anchor."""
        for step in reversed(self.all_steps()):
            if self.validate(step)[0]:
                return step
        return None

    # -- write ---------------------------------------------------------
    def save(self, step, tree=None, program=None, scope=None, meta=None):
        """Publish one snapshot atomically. State comes from `tree`
        ({name: array or tensor}) or from `program`'s persistables in
        `scope`. Returns the published path."""
        if tree is None:
            tree = _collect_state(program, scope)
        enforce(tree, "nothing to checkpoint at step %s", step)
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # the .tmp stays on a failure below, invisible to all_steps and
        # latest_valid, and the next save's GC removes it
        params = os.path.join(tmp, PARAMS_FILENAME)
        np.savez(params, **{k: _host(v) for k, v in tree.items()})
        manifest = {
            "step": int(step),
            "format": MANIFEST_FORMAT,
            "files": {PARAMS_FILENAME: {"crc32": _crc32_file(params),
                                        "size": os.path.getsize(params)}},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, MANIFEST_FILENAME), "w") as f:
            json.dump(manifest, f)
        # a crash HERE (data written, not published) leaves only the .tmp
        inject_point("checkpoint.write", tag=str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    # -- read ----------------------------------------------------------
    def restore(self, step=None):
        """(tree of numpy arrays, step). step=None resumes from
        latest_valid(). Raises CheckpointError when the snapshot is
        absent or corrupt."""
        from paddle_tpu_torch.static.io import CheckpointError
        if step is None:
            step = self.latest_valid()
            if step is None:
                raise CheckpointError(
                    f"no valid checkpoint under {self.directory}")
        ok, reason = self.validate(step)
        if not ok:
            raise CheckpointError(
                f"checkpoint {self._step_dir(step)} invalid: {reason}")
        inject_point("checkpoint.read", tag=str(step))
        with np.load(os.path.join(self._step_dir(step),
                                  PARAMS_FILENAME)) as data:
            tree = {k: np.asarray(data[k]) for k in data.files}
        return tree, step

    def restore_into_scope(self, step=None, program=None, scope=None):
        """Load a snapshot into `scope` (restricted to `program`'s
        persistables when given), writing through the tensors the scope
        holds. Returns the restored step."""
        from paddle_tpu_torch.core.scope import global_scope
        scope = scope or global_scope()
        tree, step = self.restore(step)
        wanted = None
        if program is not None:
            wanted = {v.name for v in program.list_vars() if v.persistable}
        for name, val in tree.items():
            if wanted is not None and name not in wanted:
                continue
            cur = scope.get(name)
            if (isinstance(cur, torch.Tensor)
                    and tuple(cur.shape) == val.shape
                    and _same_dtype(cur.dtype, val.dtype)):
                with torch.no_grad():
                    cur.copy_(torch.from_numpy(np.ascontiguousarray(val)))
            elif isinstance(cur, torch.Tensor):
                scope.set(name, torch.from_numpy(val).to(cur.device))
            else:
                scope.set(name, val)
        return step

    def metadata(self, step):
        with open(os.path.join(self._step_dir(step),
                               MANIFEST_FILENAME)) as f:
            return json.load(f).get("meta", {})

    # -- retention -----------------------------------------------------
    def _gc(self):
        """Keep the newest `keep` VALID snapshots; drop older ones and
        any stale .tmp. A corrupt snapshot newer than the newest valid one
        stays for post-mortem."""
        if not self.keep:
            return
        valid = self.valid_steps()
        keep = set(valid[-self.keep:])
        newest_valid = valid[-1] if valid else None
        for step in self.all_steps():
            if step in keep:
                continue
            if newest_valid is None or (step > newest_valid
                                        and step not in valid):
                continue
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _same_dtype(tdtype, ndtype):
    try:
        return torch.empty((), dtype=tdtype).numpy().dtype == ndtype
    except TypeError:          # a torch dtype numpy lacks (bfloat16)
        return False


def _collect_state(program, scope):
    """Every persistable the program declares that the scope holds —
    params, optimizer accumulators, LR counters — as host numpy copies."""
    from paddle_tpu_torch.core.scope import global_scope
    enforce(program is not None,
            "checkpoint save needs a tree or a program")
    scope = scope or global_scope()
    return {v.name: scope.find_np(v.name) for v in program.list_vars()
            if v.persistable and scope.has(v.name)}
