"""Build and load the port's CUDA kernels.

The sources under `paddle_tpu_torch/csrc/` have a plain C interface.
On first use each `.cu` is compiled by its own `nvcc` process for
`sm_90a` (all started together), the objects are linked into one shared
library under `paddle_tpu_torch/_build/`, named by a hash of the
sources (so an edited kernel is rebuilt, an unchanged one is reused),
and the library is loaded with `ctypes`. Nothing here runs at import time: this module
is imported on machines without `nvcc` or a GPU, where only the plain
PyTorch versions of the kernels run.
"""
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

from paddle_tpu_torch.analysis.concurrency import make_lock

__all__ = ["BuildError", "load_library", "library_path", "build_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int, _c_uint = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_c_ll, _c_float = ctypes.c_longlong, ctypes.c_float
_c_ll_p = ctypes.POINTER(ctypes.c_longlong)
# (B, N, Tq, Tk, D, strides, scale, causal, dropout, seed, thresh,
#  keep_scale, stream)
_FLASH_TAIL = [_c_int] * 5 + [_c_ll_p, _c_float, _c_int, _c_int, _c_uint,
                              _c_uint, _c_float, _c_void_p]

#: argtypes of every exported function: each pointer and the stream is a
#: c_void_p, so ctypes never truncates them to 32 bits
SIGNATURES = {
    "ptt_decode_attention_f32": (
        [_c_void_p] * 5 + [_c_int] * 4 + [_c_ll] * 8
        + [_c_int, _c_float, _c_void_p]),
    "ptt_paged_decode_attention_f32": (
        [_c_void_p] * 6 + [_c_int] * 7 + [_c_ll] * 9
        + [_c_int, _c_float, _c_void_p]),
    "ptt_paged_prefill_attention_f32": (
        [_c_void_p] * 9 + [_c_int] * 7 + [_c_ll] * 9
        + [_c_int, _c_float, _c_void_p]),
    "ptt_quantized_paged_decode_attention": (
        [_c_void_p] * 9 + [_c_int] * 7 + [_c_ll] * 11
        + [_c_int, _c_float, _c_int, _c_void_p]),
    "ptt_quantized_paged_prefill_attention": (
        [_c_void_p] * 11 + [_c_int] * 7 + [_c_ll] * 11
        + [_c_int, _c_float, _c_int, _c_void_p]),
    "ptt_flash_fwd": [_c_void_p] * 6 + _FLASH_TAIL,
    "ptt_flash_bwd": [_c_void_p] * 11 + _FLASH_TAIL,
    "ptt_flash_fwd_f32": [_c_void_p] * 6 + _FLASH_TAIL,
    "ptt_flash_bwd_f32": [_c_void_p] * 11 + _FLASH_TAIL,
    "ptt_quantized_matmul": ([_c_void_p] * 6 + [_c_ll] + [_c_int] * 4
                             + [_c_float] * 3 + [_c_void_p]),
    "ptt_quantized_matmul_plan": [_c_int] * 4 + [_c_void_p, _c_ll_p],
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


_lock = make_lock("kernels.build")
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
    """One nvcc per source, all running at once, then one link."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for i, src in enumerate(p for p in _sources() if p.endswith(".cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", f"{tmp}.{i}.o", src]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp + ".so"] + [c[-2] for c, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for cmd, _ in jobs:
        if os.path.exists(cmd[-2]):
            os.remove(cmd[-2])
    seconds = time.perf_counter() - t0
    log = "".join(log)
    with open(out_path + ".log", "w") as f:
        f.write(log)
    if failed:
        raise BuildError(f"nvcc failed (exit {failed[0]}):\n{log}")
    os.replace(tmp + ".so", out_path)   # atomic: concurrent builds agree
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
