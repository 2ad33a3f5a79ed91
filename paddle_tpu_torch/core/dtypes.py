"""Dtype names.

Counterpart of paddle_tpu/core/dtypes.py (`normalize_dtype`,
`dtype_name`) for the names the BERT slice uses. The JAX package maps
names to jnp dtypes; here they map to torch dtypes. The 64-bit
narrowing rules and the rest of the registry wait for the static path.
"""
import torch

__all__ = ["normalize_dtype", "dtype_name"]

_NAME_TO_DTYPE = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "int32": torch.int32,
    # fluid-style aliases
    "fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32,
}
_DTYPE_TO_NAME = {torch.float16: "float16", torch.bfloat16: "bfloat16",
                  torch.float32: "float32", torch.int32: "int32"}


def normalize_dtype(dtype):
    """A name or a torch dtype → the torch dtype (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        if dtype not in _NAME_TO_DTYPE:
            raise ValueError(f"unknown dtype name: {dtype!r}")
        return _NAME_TO_DTYPE[dtype]
    if isinstance(dtype, torch.dtype) and dtype in _DTYPE_TO_NAME:
        return dtype
    raise ValueError(f"unsupported dtype: {dtype!r}")


def dtype_name(dtype):
    """The stable string name of a dtype (None stays None)."""
    if dtype is None:
        return None
    return _DTYPE_TO_NAME[normalize_dtype(dtype)]
