"""Executor — capture and run programs.

Counterpart of paddle_tpu/core/executor.py (the reference's Python
Executor, executor.py:418, run :672). `run()` validates the feed against
the program's VarDescs and builds the program's step function once per
(program identity and version, feed signature, fetch list, state names,
mode), as the JAX Executor jit-compiles once per signature. Each cache
entry is an `observability.profile.LedgerJit` at the JAX site name
(`executor/{id:x}v{version}/{fetches}/{train|infer}`, executor.py:
209-248) with the JAX cache token (`prog:<content hash>/fetch:.../
state:.../train|infer`, :99-123):

* On the card the entry replays one captured CUDA graph per segment of
  the program's capture plan (core/lowering.py): a program without host
  ops is one graph, a `while` body one graph replayed per iteration
  with its condition read on the host. The graphs of all entries share
  the Executor's memory pool, and their replays are serialised. The
  first run of a signature is its eager warm-up.
* The graphs hold the scope's state tensors: a training run writes the
  new state into them in place, the counterpart of the JAX Executor's
  donation (`donate_argnums=(0,)`, :195-201); an inference run writes
  none (Predictor clones run over one scope). A tensor taken from the
  scope with `get` and held across a training run therefore changes
  (core/scope.py); a value set between runs is copied in.
* Fetches are copied out before `run` returns: with `return_numpy=False`
  every call returns fresh tensors.
* The feeds' copies to the card, the step and the fetches' copies to the
  host each hold the process's capture gate shared
  (`observability.profile.capture_gate`), so another thread's capture
  never overlaps them.
* The run seed (program.random_seed and the step counter, :254-270)
  re-seeds each draw site's persistent generator before a replay, so a
  captured run draws what an eager run draws.

A `parallel.CompiledProgram` runs on the rank's batch shard through its
data-parallel op hook under its mesh (parallel/compiler.py) and returns
global fetches; a `PipelineCompiledProgram` runs its own schedule.

On the CPU, and on the card inside `profile.disable_capture()`, the same
segments run eagerly. `Executor(place=None)` runs on the GPU and raises
without one; pass `place="cpu"` (or `CPUPlace()`) for the CPU.
"""
import logging

import numpy as np
import torch

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.enforce import EnforceError, enforce
from paddle_tpu_torch.core.ir import Variable, default_main_program
from paddle_tpu_torch.core.lowering import make_step_fn, referenced_state
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.core.scope import global_scope, to_numpy
from paddle_tpu_torch.observability import profile as obs_profile

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
        # Predictor clones on several threads share the Executor: one
        # signature makes one entry
        self._cache_mu = make_lock("executor.cache")
        self._rng_scan = {}   # (id(program), version) -> (program, has rng ops)
        self._step_counter = 0
        self._pool = obs_profile.ExecutorPool()

    @staticmethod
    def _cache_token(program, fetch_names, state_names, training,
                     compiled=None):
        """The persistent cache's identity of one entry: the program's
        content hash, fetches, state names and mode (the JAX token), and
        a CompiledProgram's plan fingerprint."""
        from paddle_tpu_torch.core.compile_cache import program_cache_token
        token = (f"prog:{program_cache_token(program)}"
                 f"/fetch:{','.join(fetch_names)}"
                 f"/state:{','.join(state_names)}"
                 f"/{'train' if training else 'infer'}")
        if compiled is not None:
            token += f"/plan:{compiled.cache_fingerprint()}"
        return token

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
        compiled = None
        if program is not None and hasattr(program, "with_data_parallel"):
            compiled = program
            if hasattr(compiled, "build_step"):      # the pipeline's run
                return compiled.run(self, feed, fetch_list, scope,
                                    return_numpy, training)
            program = compiled.program
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        if training is None:
            training = not program.meta.get("is_test", False)

        with obs_profile.capture_gate().shared():
            feed_vals = self._prepare_feed(program, dict(feed or {}))
        hook = None
        if compiled is not None:
            enforce(compiled.mesh is not None,
                    "call CompiledProgram.with_data_parallel first")
            compiled.shard_state(scope)
            feed_vals, b_local, b_global = compiled.shard_feeds(feed_vals)
        state_names = referenced_state(program, scope)
        key = (id(program), program._version, id(compiled),
               tuple(sorted((n, tuple(v.shape), str(v.dtype))
                            for n, v in feed_vals.items())),
               tuple(fetch_names), tuple(state_names), training)
        if compiled is not None:
            hook = compiled.hook(key, b_local, b_global)
            hook.begin(feed_vals)
        with self._cache_mu:
            step = self._entry(key, program, feed_vals, fetch_names,
                               state_names, training, compiled)
            if training or self._consumes_rng(program):
                seed = (program.random_seed * 1_000_003
                        + self._step_counter)
                self._step_counter += 1
            else:
                seed = program.random_seed
        if flags.get_flag("deterministic"):   # FLAGS_cudnn_deterministic
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        if compiled is None:
            fetches = step(scope, state_names, feed_vals, seed)
        else:
            fetches = self._run_compiled(compiled, hook, step, scope,
                                         state_names, feed_vals, seed,
                                         fetch_names)

        with obs_profile.capture_gate().shared():
            if flags.get_flag("check_nan_inf"):
                for n, v in zip(fetch_names, fetches):
                    if v.is_floating_point() and not bool(
                            torch.isfinite(v).all()):
                        raise EnforceError(
                            f"check_nan_inf: fetched var {n!r} contains "
                            f"NaN/Inf (FLAGS_check_nan_inf parity, "
                            f"reference flags.cc:44)")
            if return_numpy:
                fetches = [to_numpy(v) for v in fetches]
        return fetches

    @staticmethod
    def _run_compiled(compiled, hook, step, scope, state_names, feed_vals,
                      seed, fetch_names):
        """One CompiledProgram step: the program's ops through the
        data-parallel hook under the mesh, the fetches made global; on a
        gloo group eagerly (its collectives are host work)."""
        from paddle_tpu_torch.core.lowering import op_hook
        from paddle_tpu_torch.parallel.env import bind_mesh
        with bind_mesh(compiled.mesh), op_hook(hook):
            if compiled.uses_host_collectives():
                with obs_profile.disable_capture():
                    fetches = step(scope, state_names, feed_vals, seed)
            else:
                fetches = step(scope, state_names, feed_vals, seed)
            with torch.no_grad():
                return [hook.fetch(n, v)
                        for n, v in zip(fetch_names, fetches)]

    def _entry(self, key, program, feed_vals, fetch_names, state_names,
               training, compiled=None):
        """The LedgerJit of one signature, made on its first run. The
        cache holds the Program and checks identity: an id() can be
        reused by a new Program after the old one is collected."""
        cached = self._cache.get(key)
        if cached is not None and cached[0] is program:
            return cached[1]
        if flags.get_flag("executor_log_level") > 0:
            logger.info("new step function: program v%s feeds=%s "
                        "fetches=%s", program._version,
                        sorted(feed_vals), fetch_names)
        step = obs_profile.LedgerJit(
            make_step_fn(program, feed_vals.keys(), fetch_names,
                         state_names, training=training,
                         device=self.device),
            site=(f"executor/{id(program):x}v{program._version}/"
                  f"{','.join(fetch_names)}/"
                  f"{'train' if training else 'infer'}"),
            cache_token=self._cache_token(program, fetch_names,
                                          state_names, training, compiled),
            device=self.device, pool=self._pool)
        self._cache[key] = (program, step)
        return step

    def train_from_dataset(self, program, dataset, fetch_list=None,
                           fetch_callback=None, epochs=1, scope=None,
                           prefetch=8):
        """The dataset-driven loop (executor.py:1098). The reference runs
        C++ trainer threads (trainer.h:38 MultiTrainer,
        hogwild_worker.cc:163-181); here a prefetch thread reads the
        next batches and copies them to this Executor's device (pinned,
        non-blocking on the card) while the current step runs. Returns
        each run's fetches."""
        from paddle_tpu_torch.io.reader import buffered
        if hasattr(dataset, "batches"):
            def read():
                return dataset.batches(self.device)
        else:
            def read():
                return iter(dataset)
        results = []
        for _ in range(epochs):
            src = buffered(read, prefetch) if prefetch else read
            for batch in src():
                res = self.run(program, feed=batch, fetch_list=fetch_list,
                               scope=scope)
                if fetch_callback is not None:
                    fetch_callback(res)
                results.append(res)
        return results

    def infer_from_dataset(self, program, dataset, fetch_list=None,
                           scope=None):
        """One inference run per batch of the dataset."""
        batches = (dataset.batches(self.device)
                   if hasattr(dataset, "batches") else iter(dataset))
        return [self.run(program, feed=b, fetch_list=fetch_list,
                         scope=scope, training=False) for b in batches]

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
