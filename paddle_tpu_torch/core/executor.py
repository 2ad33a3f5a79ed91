"""Executor — run programs.

Counterpart of paddle_tpu/core/executor.py (the reference's Python
Executor, executor.py:418, run :672). `run()` validates the feed against
the program's VarDescs, builds the program's step function once per
(program identity and version, feed signature, fetch list, state names,
mode) and runs it eagerly on the executor's device (core/lowering.py).
There is no jit, no compile ledger and no persistent compile cache: what
replaces them is an open decision (ROADMAP Queue 1 item 13).

`Executor(place=None)` runs on the GPU and raises without one; pass
`place="cpu"` (or `CPUPlace()`) for the CPU.
"""
import logging

import numpy as np
import torch

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.core.ir import Variable, default_main_program
from paddle_tpu_torch.core.lowering import make_step_fn, referenced_state
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.core.scope import global_scope, to_numpy

__all__ = ["Executor"]

logger = logging.getLogger("paddle_tpu_torch.executor")

#: ops that draw randomness even outside training
_RNG_OPS = frozenset({
    "uniform_random", "gaussian_random", "truncated_gaussian_random",
    "gaussian_random_batch_size_like", "uniform_random_batch_size_like",
    "randint", "shuffle_batch", "sampling_id", "multinomial",
    "random_crop", "dropout", "nce", "dpsgd",
})


def _fetch_name(f):
    return f.name if isinstance(f, Variable) else str(f)


class Executor:
    def __init__(self, place=None):
        self.place = place
        dev = resolve_device(place)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._cache = {}
        self._rng_scan = {}   # (id(program), version) -> (program, has rng ops)
        self._step_counter = 0

    def _consumes_rng(self, program):
        key = (id(program), program._version)
        hit = self._rng_scan.get(key)
        if hit is not None and hit[0] is program:
            return hit[1]
        has_rng = any(op.type in _RNG_OPS
                      for b in program.blocks for op in b.ops)
        self._rng_scan[key] = (program, has_rng)
        return has_rng

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, training=None):
        """Run `program` once: feed → step → fetches. `training`
        defaults to True unless the program was cloned for test."""
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        if training is None:
            training = not program.meta.get("is_test", False)

        feed_vals = self._prepare_feed(program, dict(feed or {}))
        state_names = referenced_state(program, scope)
        key = (id(program), program._version,
               tuple(sorted((n, tuple(v.shape), str(v.dtype))
                            for n, v in feed_vals.items())),
               tuple(fetch_names), tuple(state_names), training)
        # the cache holds the Program and checks identity: an id() can be
        # reused by a new Program after the old one is collected
        cached = self._cache.get(key)
        step = cached[1] if cached is not None and cached[0] is program \
            else None
        if step is None:
            if flags.get_flag("executor_log_level") > 0:
                logger.info("new step function: program v%s feeds=%s "
                            "fetches=%s", program._version,
                            sorted(feed_vals), fetch_names)
            step = make_step_fn(program, feed_vals.keys(), fetch_names,
                                state_names, training=training,
                                device=self.device)
            self._cache[key] = (program, step)

        if training or self._consumes_rng(program):
            seed = program.random_seed * 1_000_003 + self._step_counter
            self._step_counter += 1
        else:
            seed = program.random_seed
        if flags.get_flag("deterministic"):   # FLAGS_cudnn_deterministic
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        state = {n: scope.tensor_on(n, self.device) for n in state_names}
        with torch.no_grad():     # the autodiff segment turns grad on
            fetches, new_state = step(state, feed_vals, seed)
        for n, v in new_state.items():
            scope.set(n, v)

        if flags.get_flag("check_nan_inf"):
            for n, v in zip(fetch_names, fetches):
                if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                    raise EnforceError(
                        f"check_nan_inf: fetched var {n!r} contains NaN/Inf "
                        f"(FLAGS_check_nan_inf parity, reference flags.cc:44)")
        if return_numpy:
            fetches = [to_numpy(v) for v in fetches]
        return fetches

    def _prepare_feed(self, program, feed):
        """numpy (or tensors) → tensors on the executor's device, cast to
        and validated against the declared VarDescs (DataFeeder parity).
        64-bit feeds stay 64-bit on the card (core/dtypes.py), so no feed
        is narrowed or range-checked."""
        block = program.global_block()
        out = {}
        for name, value in feed.items():
            if isinstance(value, torch.Tensor):
                t = value
            else:
                arr = np.asarray(value)
                if block.has_var(name) and block.var(name).dtype is not None:
                    arr = arr.astype(_dt.numpy_dtype(block.var(name).dtype))
                t = torch.from_numpy(np.ascontiguousarray(arr))
            if block.has_var(name):
                desc = block.var(name).desc
                if desc.dtype is not None:
                    t = t.to(desc.dtype)
                if desc.shape is not None:
                    enforce(len(t.shape) == len(desc.shape),
                            "feed %r rank mismatch: fed %s, declared %s",
                            name, tuple(t.shape), desc.shape)
                    for fd, dd in zip(t.shape, desc.shape):
                        enforce(dd == -1 or fd == dd,
                                "feed %r shape mismatch: fed %s, declared %s",
                                name, tuple(t.shape), desc.shape)
            out[name] = t.to(self.device)
        return out
