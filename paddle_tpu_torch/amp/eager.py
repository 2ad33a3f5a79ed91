"""Eager-mode mixed precision for the `paddle_tpu_torch.nn` layers.

Counterpart of paddle_tpu/amp/eager.py: parameters stay float32 and the
forward computes in a low-precision dtype.

* `auto_cast()` sets the ambient compute dtype (per thread) that
  `get_compute_dtype()` / `cast_compute()` and model code consult;
* `bf16_compute_params(params)` gives low-precision copies of the float
  parameters with two or more dims (matmul and conv weights) for the
  forward; biases and norm scales stay float32;
* `GradScaler` is dynamic loss scaling for float16 loops: a functional
  half on state dicts of device tensors (`init_state`, `scale_loss`,
  `unscale`, `update_state`) and an imperative half that keeps the
  state on itself (`scale`, `unscale_and_update`).
"""
import threading

import torch

from paddle_tpu_torch.amp import schedule
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import flags

__all__ = ["auto_cast", "get_compute_dtype", "cast_compute",
           "bf16_compute_params", "GradScaler"]

_state = threading.local()


def _ambient():
    return getattr(_state, "dtype", None)


class auto_cast:
    """with amp.auto_cast(): ... sets the ambient low-precision dtype."""

    def __init__(self, enable=True, dtype=None):
        self._dtype = _dt.normalize_dtype(
            dtype or flags.get_flag("amp_dtype")) if enable else None

    def __enter__(self):
        self._prev = _ambient()
        _state.dtype = self._dtype
        return self

    def __exit__(self, *exc):
        _state.dtype = self._prev
        return False


def get_compute_dtype(default=None):
    """The dtype model code should compute in under auto_cast, else
    `default`."""
    d = _ambient()
    return d if d is not None else default


def cast_compute(x):
    """A float tensor cast to the ambient auto_cast dtype (unchanged
    outside auto_cast, and for any other value)."""
    d = _ambient()
    if d is not None and isinstance(x, torch.Tensor) and \
            x.is_floating_point():
        return x.to(d)
    return x


def bf16_compute_params(params, dtype="bfloat16"):
    """{name: tensor} -> the same names, float tensors of two or more
    dims cast to `dtype`, the rest as they are."""
    dtype = _dt.normalize_dtype(dtype)
    return {k: p.to(dtype) if isinstance(p, torch.Tensor)
            and p.is_floating_point() and p.dim() >= 2 else p
            for k, p in params.items()}


class GradScaler:
    """Dynamic loss scaler for eager loops."""

    def __init__(self, init_loss_scaling=2.0 ** 15, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
                 use_dynamic_loss_scaling=True, device=None):
        self.incr_every_n_steps = int(incr_every_n_steps)
        self.decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self.incr_ratio = float(incr_ratio)
        self.decr_ratio = float(decr_ratio)
        self.dynamic = bool(use_dynamic_loss_scaling)
        self.state = self.init_state(init_loss_scaling, device)

    @staticmethod
    def init_state(init_loss_scaling=2.0 ** 15, device=None):
        from paddle_tpu_torch.core.places import resolve_device
        dev = resolve_device(device)
        return {"scale": torch.tensor(float(init_loss_scaling),
                                      dtype=torch.float32, device=dev),
                "good": torch.tensor(0, dtype=torch.int32, device=dev),
                "bad": torch.tensor(0, dtype=torch.int32, device=dev)}

    # functional core
    def scale_loss(self, loss, state):
        return loss * state["scale"].to(loss.dtype)

    def unscale(self, grads, state):
        """{name: grad} -> ({name: unscaled grad}, found_inf); every grad
        is zeroed on overflow."""
        names = list(grads)
        outs, found_inf = schedule.unscale_and_check(
            [grads[k] for k in names], state["scale"])
        return dict(zip(names, outs)), found_inf

    def update_state(self, state, found_inf):
        if not self.dynamic:
            return state
        scale, good, bad = schedule.update_scale(
            state["scale"], state["good"], state["bad"], found_inf,
            self.incr_every_n_steps, self.decr_every_n_nan_or_inf,
            self.incr_ratio, self.decr_ratio)
        return {"scale": scale, "good": good.to(torch.int32),
                "bad": bad.to(torch.int32)}

    # imperative wrappers
    def scale(self, loss):
        return self.scale_loss(loss, self.state)

    def unscale_and_update(self, grads):
        grads, found_inf = self.unscale(grads, self.state)
        self.state = self.update_state(self.state, found_inf)
        return grads, found_inf

    @property
    def loss_scaling(self):
        return float(self.state["scale"])
