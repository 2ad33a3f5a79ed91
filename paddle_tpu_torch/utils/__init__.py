"""Utilities: initializers, param attrs, regularizers, clip, metrics,
debug and profiler (the fluid.{initializer,param_attr,regularizer,clip,
metrics,profiler} modules).

Counterpart of paddle_tpu/utils/__init__.py, with its exports: the
submodules `initializer`, `regularizer`, `clip`, `metrics`, `debug`,
`profiler` (and the port's `param_attr` and `mask_util`) and
`ParamAttr`, each imported on first access (a module `__getattr__`).
"""
import importlib

_SUBMODULES = ("initializer", "regularizer", "clip", "metrics", "debug",
               "profiler", "param_attr", "mask_util")

__all__ = ["ParamAttr"] + list(_SUBMODULES)


def __getattr__(name):
    if name == "ParamAttr":
        from paddle_tpu_torch.utils.param_attr import ParamAttr
        return ParamAttr
    if name not in _SUBMODULES:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
