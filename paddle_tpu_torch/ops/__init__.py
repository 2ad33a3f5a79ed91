"""Operator library.

Counterpart of paddle_tpu/ops/__init__.py, with its exports: the op
modules `math`, `nn`, `tensor`, `random`, `optimizer_ops`,
`control_flow`, `collective`, `metrics`, `sequence`, `detection`, `rnn`,
`loss`, `beam_search`, `misc`, `vision`, `ctr`, `text`, `fused` and
`detection_train` (and the port's `generation` and `kernels`). Every op
is a PyTorch function registered in `core.registry`; the hand-written
CUDA kernels for Hopper live in `ops/kernels/` and `csrc/`. The
registry imports the op modules on its first lookup; here a submodule
is imported on first access (a module `__getattr__`), so importing a
kernel wrapper does not register the whole library.
"""
import importlib

_SUBMODULES = ("math", "nn", "tensor", "random", "optimizer_ops",
               "control_flow", "collective", "metrics", "sequence",
               "detection", "rnn", "loss", "beam_search", "misc", "vision",
               "ctr", "text", "fused", "detection_train", "generation",
               "kernels")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name not in _SUBMODULES:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
