"""Meta-optimizers: EMA, ModelAverage, Lookahead, Recompute.

Counterpart of paddle_tpu/optimizer/meta.py (the reference's
optimizer.py ModelAverage :2484, ExponentialMovingAverage :2786,
RecomputeOptimizer :3313, Lookahead :3606). EMA and ModelAverage append
`scale`, `sum` and `increment` ops after the updates; `apply()` swaps
the averages into the scope for evaluation and restores the
parameters after. Lookahead syncs its slow weights in the scope from
the host (`sync()` after each run), as the JAX package does.
RecomputeOptimizer records its checkpoints on the `autodiff` op; the
port's lowering, like the JAX one, recomputes nothing (autograd keeps
the forward's tensors), so its numbers equal the inner optimizer's.
"""
import contextlib

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.ir import (OpRole, default_main_program,
                                      default_startup_program)
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer",
           "RecomputeOptimizer"]


def _trainable(program):
    return [v for v in program.all_parameters() if v.desc.trainable]


class ExponentialMovingAverage:
    """ema = decay ema + (1 - decay) param for every trainable parameter,
    in the program after its update ops (var `{param}_{name}`)."""

    def __init__(self, decay=0.999, name=None):
        self.decay = decay
        self._name = name or "ema"
        self._pairs = []  # (param name, ema name)

    def update(self):
        from paddle_tpu_torch.optimizer import _persistable_var
        program = default_main_program()
        startup = default_startup_program()
        block = program.global_block()
        with program.op_role_guard(OpRole.OPTIMIZE):
            for p in _trainable(program):
                ema = f"{p.name}_{self._name}"
                _persistable_var(program, startup, ema, p.shape,
                                 _dt.dtype_name(p.dtype), 0.0)
                t1 = block.create_var(dtype=p.dtype).name
                t2 = block.create_var(dtype=p.dtype).name
                block.append_op("scale", {"X": [ema]}, {"Out": [t1]},
                                {"scale": self.decay})
                block.append_op("scale", {"X": [p.name]}, {"Out": [t2]},
                                {"scale": 1.0 - self.decay})
                block.append_op("sum", {"X": [t1, t2]}, {"Out": [ema]})
                self._pairs.append((p.name, ema))

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        scope = global_scope()
        saved = {p: scope.get(p) for p, _ in self._pairs}
        for p, e in self._pairs:
            scope.set(p, scope.get(e))
        try:
            yield
        finally:
            if need_restore:
                for p, _ in self._pairs:
                    scope.set(p, saved[p])

    def restore(self, executor=None):
        """A no-op: `apply`'s context restores the parameters."""


class ModelAverage:
    """The running mean of every trainable parameter: `{param}_{name}_sum`
    accumulates it each run and `{name}_count` counts the runs; `apply`
    divides."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, name=None):
        from paddle_tpu_torch.optimizer import _persistable_var
        self._name = name or "model_avg"
        self._pairs = []
        program = default_main_program()
        startup = default_startup_program()
        block = program.global_block()
        cnt = f"{self._name}_count"
        _persistable_var(program, startup, cnt, [1], "float32", 0.0)
        with program.op_role_guard(OpRole.OPTIMIZE):
            block.append_op("increment", {"X": [cnt]}, {"Out": [cnt]},
                            {"step": 1.0})
            for p in _trainable(program):
                acc = f"{p.name}_{self._name}_sum"
                _persistable_var(program, startup, acc, p.shape,
                                 _dt.dtype_name(p.dtype), 0.0)
                block.append_op("sum", {"X": [acc, p.name]}, {"Out": [acc]})
                self._pairs.append((p.name, acc, cnt))

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        scope = global_scope()
        saved = {p: scope.get(p) for p, _, _ in self._pairs}
        for p, acc, cnt in self._pairs:
            n = max(float(scope.find_np(cnt).reshape(-1)[0]), 1.0)
            scope.set(p, scope.get(acc) / n)
        try:
            yield
        finally:
            if need_restore:
                for p, _, _ in self._pairs:
                    scope.set(p, saved[p])


class LookaheadOptimizer:
    """Fast and slow weights: every k-th `sync()` moves the slow weights
    alpha of the way to the fast ones and sets the fast ones to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow = {}
        self._step = 0
        self._params = []

    def minimize(self, loss, startup_program=None):
        ops, pg = self.inner.minimize(loss, startup_program)
        self._params = [p.name for p, _ in pg]
        return ops, pg

    def sync(self):
        """Call once per training step, after the executor's run."""
        self._step += 1
        scope = global_scope()
        if not self._slow:
            for p in self._params:
                self._slow[p] = scope.get(p)
        if self._step % self.k == 0:
            for p in self._params:
                slow = self._slow[p] + self.alpha * (scope.get(p)
                                                     - self._slow[p])
                self._slow[p] = slow
                scope.set(p, slow)


class RecomputeOptimizer:
    """Gradient checkpointing's API: the checkpoints go onto the
    `autodiff` op (module docstring)."""

    def __init__(self, optimizer):
        self.inner = optimizer
        self._checkpoints = []

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = [c if isinstance(c, str) else c.name
                             for c in checkpoints]

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        return self.inner.backward(loss, startup_program, parameter_list,
                                   no_grad_set,
                                   checkpoints=checkpoints
                                   or self._checkpoints)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        pg = self.backward(loss, startup_program, parameter_list,
                           no_grad_set)
        ops = self.inner.apply_gradients(pg, program=loss.block.program,
                                         startup_program=startup_program)
        return ops, pg

    def apply_gradients(self, params_grads, program=None,
                        startup_program=None):
        return self.inner.apply_gradients(params_grads, program=program,
                                          startup_program=startup_program)
