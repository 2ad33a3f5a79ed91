"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module paths and public names for the slices ported so far, in
PyTorch, with the TPU's Pallas kernels rewritten by hand for Hopper
(`csrc/`, built on first use by `ops/kernels/_build.py`).

It imports torch, numpy and the standard library only, never `jax` and
never a module of `paddle_tpu`. Entry points run on `cuda` unless the
caller passes `device="cpu"`, and raise when asked for a GPU that is not
there.

The top-level surface is the JAX package's (`paddle_tpu/__init__.py`):

    import paddle_tpu_torch as pt
    pt.Program, pt.Executor, pt.Scope, pt.program_guard, pt.global_scope
    pt.static (= pt.layers), pt.nn, pt.optimizer, pt.io, pt.amp, ...

Importing this package is light: a name resolves, and its module is
imported, on first access (a module `__getattr__`); torch is not
imported until a name needs it, and nothing builds or loads the
kernels. A name that is also a submodule's is the
submodule (`unique_name`: fluid's module, `generate` / `guard`). The
reference's `TPUPlace` / `is_compiled_with_tpu` become `CUDAPlace` /
`is_compiled_with_cuda`.
"""
import importlib

#: name -> (module, attribute); attribute None means the module itself
_LAZY = {
    **{n: ("paddle_tpu_torch.core.places", n) for n in (
        "CPUPlace", "CUDAPlace", "resolve_device")},
    **{n: ("paddle_tpu_torch.core.dtypes", n) for n in (
        "float32", "float64", "float16", "bfloat16", "int8", "int16",
        "int32", "int64", "bool_", "uint8")},
    **{n: ("paddle_tpu_torch.core.ir", n) for n in (
        "Program", "Block", "OpDesc", "VarDesc", "Variable",
        "default_main_program", "default_startup_program", "program_guard",
        "switch_main_program", "name_scope")},
    **{n: ("paddle_tpu_torch.core.scope", n) for n in (
        "Scope", "global_scope", "scope_guard")},
    "Executor": ("paddle_tpu_torch.core.executor", "Executor"),
    "AsyncExecutor": ("paddle_tpu_torch.async_executor", "AsyncExecutor"),
    "DataFeedDesc": ("paddle_tpu_torch.data_feed_desc", "DataFeedDesc"),
    "EnforceError": ("paddle_tpu_torch.core.enforce", "EnforceError"),
    "enforce": ("paddle_tpu_torch.core.enforce", "enforce"),
    "flags": ("paddle_tpu_torch.core.flags", None),
    "ParallelExecutor": ("paddle_tpu_torch.parallel_executor",
                         "ParallelExecutor"),
    "layers": ("paddle_tpu_torch.static", None),
    **{n: (f"paddle_tpu_torch.{n}", None) for n in (
        "ops", "static", "nn", "optimizer", "io", "amp", "inference",
        "serving", "analysis", "reliability", "slim", "contrib", "utils",
        "models", "average", "evaluator", "regularizer", "initializer",
        "clip", "weights", "unique_name", "parallel", "compiler",
        "distributed")},
}

__all__ = ["is_compiled_with_cuda", "__version__"] + sorted(_LAZY)

__version__ = "0.1.0"


def is_compiled_with_cuda():
    """Whether torch sees a CUDA device (the reference's
    is_compiled_with_tpu)."""
    import torch
    return torch.cuda.is_available()


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                             f"{name!r}")
    module, attr = _LAZY[name]
    mod = importlib.import_module(module)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
