"""Build and load the port's CUDA kernels.

The sources under `paddle_tpu_torch/csrc/` have a plain C interface.
On first use they are compiled by `nvcc` for `sm_90a` into one shared
library under `paddle_tpu_torch/_build/`, named by a hash of the
sources (so an edited kernel is rebuilt, an unchanged one is reused),
and loaded with `ctypes`. Nothing here runs at import time: this module
is imported on machines without `nvcc` or a GPU, where only the plain
PyTorch versions of the kernels run.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["BuildError", "load_library", "library_path", "build_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_c_ll, _c_float = ctypes.c_longlong, ctypes.c_float

#: argtypes of every exported function: each pointer and the stream is a
#: c_void_p, so ctypes never truncates them to 32 bits
SIGNATURES = {
    "ptt_decode_attention_f32": (
        [_c_void_p] * 8 + [_c_int] * 4 + [_c_ll] * 8
        + [_c_int, _c_float, _c_void_p]),
    "ptt_paged_decode_attention_f32": (
        [_c_void_p] * 9 + [_c_int] * 7 + [_c_ll] * 9
        + [_c_int, _c_float, _c_void_p]),
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


_lock = threading.Lock()
_lib = [None]
_info = {}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def library_path():
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"libptt_kernels_{h.hexdigest()[:16]}.so")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                     "the CUDA kernels cannot be built on this machine")


def _compile(out_path):
    os.makedirs(_BUILD, exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    tmp = f"{out_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    with open(out_path + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out_path)       # atomic: concurrent builders agree
    return seconds, log


def load_library():
    """The loaded kernel library, building it first if needed."""
    with _lock:
        if _lib[0] is not None:
            return _lib[0]
        path = library_path()
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            seconds, log = _compile(path)
        lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _info.update(path=path, build_seconds=seconds, nvcc_log=log,
                     built=bool(log))
        _lib[0] = lib
        return lib


def build_info():
    """{"path", "build_seconds", "nvcc_log", "built"} of the loaded
    library (empty before the first load_library())."""
    return dict(_info)
