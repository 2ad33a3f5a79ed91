"""Checkpoint / resume.

Counterpart of paddle_tpu/io/checkpoint.py (the reference's save/load
ops, io.save_persistables and fleet's checkpoint helpers). The JAX
package writes sharded jax.Arrays with orbax; here
`torch.distributed.checkpoint` (DCP) takes that role: each rank writes
its own shards of the state (under a process group; without one, the
one process writes everything). It is the default, as orbax is the JAX
package's. `use_dcp=False` takes the numpy path, whose files are the JAX
package's `use_orbax=False` files: `state.npz` (nested keys joined by
the ASCII unit separator, so "/" in a name survives) and `dtypes.json`
(bfloat16 stored widened to float32, restored by the recorded name).
Either package loads the other's numpy checkpoints. The card's machine
has no `ml_dtypes`, so numpy has no bfloat16 there: a bfloat16 entry
comes back as a `torch.bfloat16` CPU tensor. DCP checkpoints and orbax
ones do not cross.

`CheckpointManager` adds step retention, atomic publish (a `.tmp`
directory, then `os.replace`), async saves and latest-step resume. An
async save copies the state to the host before `save` returns (the JAX
package's snapshot against donated buffers): an Executor's captured
graph writes its state buffers in place on its next replay, so a write
in flight must not read them. A failed background save raises on the
next `save` or `wait`; an exiting process waits for the save in flight.
"""
import atexit
import json
import os
import shutil
import threading
import warnings
import weakref

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["Checkpointer", "CheckpointManager", "save_checkpoint",
           "load_checkpoint"]

# nesting separator: ASCII unit separator, the JAX package's ("/"
# appears in real parameter names and must survive a round trip)
_SEP = "\x1f"


def _dcp():
    import torch.distributed.checkpoint as dcp
    # without a process group DCP writes (and reads) every entry in the
    # one process, and says so on every call
    warnings.filterwarnings("ignore", category=UserWarning,
                            message="torch.distributed is disabled")
    return dcp


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = k if not prefix else prefix + _SEP + k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def _to_host(value):
    """A host copy of one leaf: a CPU tensor for a tensor (any dtype),
    a numpy array otherwise; never a view of the caller's buffer."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return np.array(value, copy=True)


def _as_tensor(value):
    """A tensor of one leaf for DCP, a 0-dim leaf (a step counter, a
    scalar) kept 0-dim."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.array(value, copy=True, order="C"))


class Checkpointer:
    """Single-checkpoint save/restore of a nested dict of tensors or
    arrays. use_dcp=False forces the numpy path (host-local)."""

    def __init__(self, use_dcp=None):
        self.use_dcp = True if use_dcp is None else bool(use_dcp)

    def save(self, path, tree):
        path = os.path.abspath(path)
        if os.path.exists(path):
            shutil.rmtree(path)
        if self.use_dcp:
            state = {k: _as_tensor(v) for k, v in _flatten(tree).items()}
            _dcp().save(state, checkpoint_id=path)
            return
        os.makedirs(path, exist_ok=True)
        arrays, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu()
                dtypes[k] = str(v.dtype).replace("torch.", "")
                # bfloat16 (no numpy dtype without ml_dtypes): stored
                # widened to float32, restored by the recorded name
                a = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            else:
                a = np.asarray(v)
                dtypes[k] = str(a.dtype) if a.dtype.kind != "V" else \
                    str(getattr(v, "dtype", a.dtype))
                if a.dtype.kind == "V" or dtypes[k] == "bfloat16":
                    a = a.astype(np.float32)
            arrays[k] = a
        np.savez(os.path.join(path, "state.npz"), **arrays)
        with open(os.path.join(path, "dtypes.json"), "w") as f:
            json.dump(dtypes, f)

    def restore(self, path, template=None):
        """The saved tree: numpy arrays from the numpy path (bfloat16 as
        torch.bfloat16 CPU tensors), CPU tensors from DCP (loaded into
        `template`'s tensors when given)."""
        path = os.path.abspath(path)
        enforce(os.path.exists(path), "checkpoint %s does not exist", path)
        if not os.path.exists(os.path.join(path, "state.npz")):
            return self._restore_dcp(path, template)
        with np.load(os.path.join(path, "state.npz")) as data:
            flat = {k: data[k] for k in data.files}
        dt_path = os.path.join(path, "dtypes.json")
        if os.path.exists(dt_path):
            with open(dt_path) as f:
                dtypes = json.load(f)
            for k, name in dtypes.items():
                if k not in flat or str(flat[k].dtype) == name:
                    continue
                if name == "bfloat16":
                    flat[k] = torch.from_numpy(flat[k]).to(torch.bfloat16)
                else:
                    flat[k] = flat[k].astype(np.dtype(name))
        return _unflatten(flat)

    def _restore_dcp(self, path, template):
        dcp = _dcp()
        if template is not None:
            state = {k: _as_tensor(v) for k, v in _flatten(template).items()}
        else:
            meta = dcp.FileSystemReader(path).read_metadata()
            state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                     for k, m in meta.state_dict_metadata.items()}
        dcp.load(state, checkpoint_id=path)
        return _unflatten(state)


class CheckpointManager:
    """Step-indexed checkpoints with retention, atomic publish, async
    save, and latest-step resume."""

    def __init__(self, directory, max_to_keep=3, async_save=True,
                 use_dcp=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._ckptr = Checkpointer(use_dcp=use_dcp)
        self._thread = None
        self._error = None
        # an in-flight async save must complete even if the process exits
        # right after the train loop's final save()
        ref = weakref.ref(self)
        atexit.register(lambda: ref() and ref().wait())

    def _step_dir(self, step):
        return os.path.join(self.directory, f"ckpt-{step}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("-", 1)[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, tree, metrics=None):
        """Save `tree` for `step`. The previous save is awaited first (at
        most one in flight); with async_save the state is copied to the
        host here and written by a background thread."""
        self.wait()  # one in-flight save; surfaces prior errors
        if self.async_save:
            tree = _unflatten({k: _to_host(v)
                               for k, v in _flatten(tree).items()})

        def work():
            try:
                tmp = self._step_dir(step) + ".tmp"
                final = self._step_dir(step)
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                self._ckptr.save(tmp, tree)
                if metrics is not None:
                    with open(os.path.join(tmp, "metrics.json"), "w") as f:
                        json.dump(metrics, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced on next save/wait
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=False,
                                            name=f"ckpt-save-{step}")
            self._thread.start()
        else:
            work()
            self._raise_pending()

    def restore(self, step=None, template=None):
        self.wait()
        if step is None:
            step = self.latest_step()
            enforce(step is not None, "no checkpoints in %s", self.directory)
        return self._ckptr.restore(self._step_dir(step), template), step

    def metrics(self, step):
        p = os.path.join(self._step_dir(step), "metrics.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def in_flight(self):
        """Whether a background save is still writing."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


#: the program-level helpers' managers, one per directory, so a load
#: waits for an async save in flight to the same directory
_managers = {}


def _manager(dirname, async_save):
    key = os.path.abspath(dirname)
    mgr = _managers.get(key)
    if mgr is None:
        mgr = _managers[key] = CheckpointManager(key, async_save=async_save)
    mgr.async_save = async_save
    return mgr


def _scope(scope):
    from paddle_tpu_torch.core.scope import global_scope
    return global_scope() if scope is None else scope


def save_checkpoint(executor, dirname, main_program=None, step=0,
                    async_save=False, scope=None):
    """Program-level save (io.save_persistables shape): every persistable
    var the program references, from `scope` (None: the global scope).
    With `async_save` the state is copied to the host before this
    returns and written in the background; the next save or load of the
    directory waits for it."""
    from paddle_tpu_torch.core.ir import default_main_program
    from paddle_tpu_torch.core.lowering import referenced_state

    program = main_program or default_main_program()
    scope = _scope(scope)
    names = referenced_state(program, scope)
    tree = {n: scope.get(n) for n in names}
    _manager(dirname, async_save).save(step, tree)
    return step


def load_checkpoint(executor, dirname, main_program=None, step=None,
                    scope=None):
    """Restore the latest (or given) step into `scope` (None: the global
    scope); with a program, only that program's persistables are touched
    (a shared scope keeps other models' state). Returns the step
    restored."""
    scope = _scope(scope)
    tree, step = _manager(dirname, False).restore(step)
    wanted = None
    if main_program is not None:
        wanted = {v.name for b in main_program.blocks
                  for v in b.vars.values() if v.persistable}
    for name, val in tree.items():
        if wanted is None or name in wanted:
            scope.set(name, val)
    return step
