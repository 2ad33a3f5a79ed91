"""Learning-rate schedulers.

Counterpart of paddle_tpu/optimizer/lr.py (the reference's
layers/learning_rate_scheduler.py): noam_decay, exponential_decay,
natural_exp_decay, inverse_time_decay, polynomial_decay,
piecewise_decay, cosine_decay and linear_lr_warmup. Each scheduler
appends a global step counter — the persistable [1] float32 var
`lr_global_step`, 0 at startup, advanced by an in-program `increment`
that the executor writes back every run — and computes the rate from it
with ops, so the rate is a device tensor of the step: no host sync and
no `.item()` a step. Pass the returned Variable as an Optimizer's
`learning_rate`.
"""
import math

from paddle_tpu_torch.core.ir import (default_main_program,
                                      default_startup_program)
from paddle_tpu_torch.static import common as L

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup"]

#: the counter's var name, as in the JAX package
STEP_VAR = "lr_global_step"


def _global_step_counter():
    """The persistable float step, +1 each run (before the rate reads
    it: the first step sees 1)."""
    from paddle_tpu_torch.optimizer import _persistable_var
    program = default_main_program()
    _persistable_var(program, default_startup_program(), STEP_VAR, [1],
                     "float32", 0.0)
    gb = program.global_block()
    gb.append_op("increment", {"X": [STEP_VAR]}, {"Out": [STEP_VAR]},
                 {"step": 1.0})
    return gb.var(STEP_VAR)


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _global_step_counter()
    a = step ** -0.5
    b = step * (warmup_steps ** -1.5)
    return (learning_rate * (d_model ** -0.5)) * L.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = L.floor(div)
    return learning_rate * (decay_rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = L.floor(div)
    return learning_rate * L.exp(-1.0 * decay_rate * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _global_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = L.floor(div)
    return learning_rate / (1.0 + decay_rate * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _global_step_counter()
    capped = L.elementwise_min(step, L.fill_constant([1], "float32",
                                                     float(decay_steps)))
    frac = (1.0 - capped / float(decay_steps)) ** power
    return (learning_rate - end_learning_rate) * frac + end_learning_rate


def piecewise_decay(boundaries, values):
    """lr = values[i] for a step in [boundaries[i-1], boundaries[i])."""
    step = _global_step_counter()
    lr = L.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = L.less_than(step, L.fill_constant([1], "float32", float(b)))
        lr = L.where(cond, L.fill_constant([1], "float32", v), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step_counter()
    epoch = L.floor(step / float(step_each_epoch))
    return learning_rate * 0.5 * (L.cos(epoch * (math.pi / epochs)) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step_counter()
    wsteps = L.fill_constant([1], "float32", float(warmup_steps))
    warm = start_lr + (end_lr - start_lr) * (step / float(warmup_steps))
    if not hasattr(learning_rate, "name"):
        learning_rate = L.fill_constant([1], "float32", float(learning_rate))
    return L.where(L.less_than(step, wsteps), warm, learning_rate)
