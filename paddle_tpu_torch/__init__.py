"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module paths and public names for the slices ported so far, in
PyTorch, with the TPU's Pallas kernels rewritten by hand for Hopper
(`csrc/`, built on first use by `ops/kernels/_build.py`).

It imports torch, numpy and the standard library only, never `jax` and
never a module of `paddle_tpu`. Entry points run on `cuda` unless the
caller passes `device="cpu"`, and raise when asked for a GPU that is not
there.

Importing this package is light: it does not build or load the kernels.
"""
from paddle_tpu_torch.core.places import CPUPlace, CUDAPlace, resolve_device

__all__ = ["CPUPlace", "CUDAPlace", "resolve_device"]
