"""Dtype registry.

Counterpart of paddle_tpu/core/dtypes.py. The JAX package maps the
serialized names to jnp dtypes; here they map to torch dtypes, and
`numpy_dtype` gives the host dtype of a torch one.

The 64-bit contract differs from the JAX package's on purpose. There,
x64 is off on the device, so `device_dtype` narrows int64/uint64/float64
to 32 bits and the executor range-checks 64-bit feeds. PyTorch has real
64-bit tensors on the card, so here `device_dtype` is the identity: an
int64 var stays int64 on the GPU and no feed is narrowed. The IR records
the same DECLARED dtypes in both packages (the JAX package infers under
x64 for that reason), so a serialized program reads the same in both.
"""
import numpy as np
import torch

__all__ = ["normalize_dtype", "dtype_name", "numpy_dtype", "is_floating",
           "device_dtype", "float16",
           "bfloat16", "float32", "float64", "int8", "uint8", "int16",
           "int32", "int64", "bool_"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
uint8 = torch.uint8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
bool_ = torch.bool

_DTYPE_TO_NAME = {float16: "float16", bfloat16: "bfloat16",
                  float32: "float32", float64: "float64", int8: "int8",
                  uint8: "uint8", int16: "int16", int32: "int32",
                  int64: "int64", bool_: "bool"}
_NAME_TO_DTYPE = {name: dt for dt, name in _DTYPE_TO_NAME.items()}
# fluid-style aliases
_NAME_TO_DTYPE.update(fp16=float16, bf16=bfloat16, fp32=float32,
                      fp64=float64)


def normalize_dtype(dtype):
    """A name, a torch dtype or a numpy dtype (or type) → the torch dtype
    (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        if dtype not in _NAME_TO_DTYPE:
            raise ValueError(f"unknown dtype name: {dtype!r}")
        return _NAME_TO_DTYPE[dtype]
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPE_TO_NAME:
            raise ValueError(f"unsupported dtype: {dtype!r}")
        return dtype
    try:
        name = np.dtype(dtype).name
    except TypeError as e:
        raise ValueError(f"unsupported dtype: {dtype!r}") from e
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype):
    """The stable string name of a dtype (None stays None)."""
    if dtype is None:
        return None
    return _DTYPE_TO_NAME[normalize_dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype of a declared dtype (bfloat16 has none)."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        raise ValueError("bfloat16 has no numpy dtype here")
    return np.dtype(name)


def is_floating(dtype):
    return normalize_dtype(dtype).is_floating_point


def device_dtype(dtype):
    """The on-device dtype of a declared dtype: the dtype itself (64-bit
    types stay 64-bit on the card; see the module docstring)."""
    return normalize_dtype(dtype)
