"""Scope — runtime variable store.

Counterpart of paddle_tpu/core/scope.py (the reference's name → Variable
map, scope.h:46). A Scope maps names to torch tensors: parameters and
other persistable state. The Executor moves a value onto its own device
the first time a program reads it and stores it back there, so a value
loaded or rewritten on the host (a params file, a freeze pass's int8
weights) lives on the card from then on.

**Bound state.** On the card an Executor entry's captured graphs hold
the state tensors they read (`bind`): a training run writes the new
values into them in place, the counterpart of the JAX Executor's
donated state. A value `set` under a bound name between runs
(`load_persistables`, `static.load`, a freeze pass, a user) is copied
into the bound tensor by the next run, which puts the bound tensor back
(`refresh`). So a tensor taken with `get` and held across a training
run changes under its holder (where the JAX package's donated buffer
would be invalid): copy it (`find_np`, `.clone()`) to keep a value. No
tensor is bound under two names, and no scope value points into a
graph's memory pool.

`find_np` always returns a copy: on a CPU tensor `.cpu()` and
`.numpy()` share its storage, and a host copy must not change when the
tensor is later updated in place.
"""

import numpy as np
import torch

from paddle_tpu_torch.analysis.concurrency import make_lock

__all__ = ["Scope", "global_scope", "scope_guard", "to_numpy"]


def to_numpy(value):
    """A host numpy copy of a tensor or array (never a view of it)."""
    if isinstance(value, torch.Tensor):
        return np.array(value.detach().cpu().numpy(), copy=True)
    return np.array(value, copy=True)


class Scope:
    def __init__(self):
        self._vars = {}
        self._bound = {}      # id(tensor) -> (name, tensor): bound state
        self._lock = make_lock("core.scope")

    def set(self, name, value):
        with self._lock:
            self._vars[name] = value

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def has(self, name):
        return name in self._vars

    def find_np(self, name):
        """The value as a numpy array, always a copy (None if absent)."""
        v = self.get(name)
        return None if v is None else to_numpy(v)

    def erase(self, name):
        with self._lock:
            self._vars.pop(name, None)

    def tensor_on(self, name, device):
        """The value of `name` as a tensor on `device`; a value held
        elsewhere (numpy, another device) is moved and stored back."""
        with self._lock:
            v = self._vars[name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, copy=True))
            if v.device != device:
                v = v.to(device)
            self._vars[name] = v
            return v

    def bind(self, name, device):
        """The tensor a captured graph holds for `name`: the value on
        `device` (as `tensor_on`), or a copy of it when that tensor is
        already bound under another name."""
        v = self.tensor_on(name, device)
        with self._lock:
            owner = self._bound.get(id(v))
            if owner is not None and owner[0] != name:
                v = v.clone()
                self._vars[name] = v
            self._bound[id(v)] = (name, v)
            return v

    def refresh(self, name, bound):
        """Before a run: when `name` holds another value than its bound
        tensor (of the same shape and dtype), copy the value in and put
        the bound tensor back; another name holding the bound tensor
        keeps its value in a copy. Returns whether it copied."""
        with self._lock:
            v = self._vars.get(name)
            if v is bound:
                return False
            for n, other in self._vars.items():
                if other is bound and n != name:
                    self._vars[n] = bound.clone()
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, copy=True))
            bound.copy_(v)
            self._vars[name] = bound
            return True

    def __repr__(self):
        return f"<Scope vars={len(self._vars)}>"


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


class scope_guard:
    """`with scope_guard(scope): ...` (executor.py scope_guard parity)."""

    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _scope_stack.pop()
