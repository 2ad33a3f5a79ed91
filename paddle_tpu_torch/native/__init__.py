"""The native C++ runtime: the data-feed pipeline, the sparse parameter
server and the Program-IR interpreter, bound with ctypes.

Counterpart of paddle_tpu/native/__init__.py (the reference binds its
C++ runtime with pybind11, paddle/fluid/pybind/pybind.cc). The port
keeps its own copy of the C++ sources in `native/src/` and builds them
with `g++` on first use into `paddle_tpu_torch/_build/native/`:

* `libpt_native.so` (datafeed.cc, ps.cc, c_api.cc, interp.cc), loaded by
  `load()`: `NativeDataset`, `NativePredictor` here, the PS client and
  server in `paddle_tpu_torch.ps`;
* the Python-free binaries `pt_infer` and `pt_train` (`build_pt_infer`,
  `build_pt_train`);
* `pt_aoti_run` (`build_pt_aoti_run`): an AOTInductor package of an
  exported Program (`inference.export_aot_bundle`'s native tier) run
  through libtorch, built against `torch.utils.cpp_extension`'s include
  and library paths, with K8 registered by `aoti_ops.cc`.

Each `.cc` compiles to an object named by a hash of the command, the
source and the headers (all objects of a build start together; an
unchanged one is reused), and each output is linked to a temporary name
and moved into place with `os.replace`, under a file lock held across
build and load, so processes that start together (test workers, a
launcher's trainers) build once. A failed build raises
`NativeBuildError`: nothing falls back. Nothing builds at import time.

The wire of the parameter server is the same C++ as the JAX package's,
so a port client talks to a JAX-package server and back. `pt_aoti_run`
takes XLA's PJRT runner's place (`pt_pjrt_run`, with its command line but
for `--plugin`).
"""
import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from paddle_tpu_torch.analysis.concurrency import make_lock

__all__ = ["NativeBuildError", "NativeDataset", "NativePredictor", "load",
           "available", "library_path", "build_pt_infer", "build_pt_train",
           "build_pt_aoti_run", "BUILD_DIR", "SRC_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")

CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread")
_LIB_SRCS = ("datafeed.cc", "ps.cc", "c_api.cc", "interp.cc")
_BIN_SRCS = {"pt_infer": ("pt_infer.cc", "interp.cc"),
             "pt_train": ("pt_train.cc", "interp.cc")}
_AOTI_SRCS = ("pt_aoti_run.cc", "aoti_ops.cc")

_lock = make_lock("native.build")
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _run(cmd, what):
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{what}: build failed to run: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"{what}: build failed:\n"
                               f"{proc.stderr[-4000:]}")


def _digest(*parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _headers():
    return sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".h"))


def _plan(srcs, link, cxx_flags=CXX_FLAGS):
    """([(object path, compile command)] of `srcs`, the hash that keys
    the output linked from them by `link`)."""
    hdr = b"".join(open(os.path.join(SRC_DIR, f), "rb").read()
                   for f in _headers())
    objs = []
    for src in srcs:
        path = os.path.join(SRC_DIR, src)
        with open(path, "rb") as f:
            body = f.read()
        cmd = ["g++", *cxx_flags, "-c", path]
        # the object's name hashes what decides it (flags, source,
        # headers), not where the checkout lies
        key = _digest(" ".join(cmd[:-1]), src, body, hdr)
        o = os.path.join(BUILD_DIR, "obj", f"{src[:-3]}-{key}.o")
        objs.append((o, cmd))
    key = _digest(" ".join(link), *(o for o, _ in objs))
    return objs, key


def _compile(o, cmd):
    if os.path.exists(o):
        return
    os.makedirs(os.path.dirname(o), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".o", dir=os.path.dirname(o))
    os.close(fd)
    try:
        _run(cmd + ["-o", tmp], os.path.basename(cmd[-1]))
        os.replace(tmp, o)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _FileLock:
    """An exclusive flock on BUILD_DIR/.lock (across processes)."""

    def __enter__(self):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._fd = os.open(os.path.join(BUILD_DIR, ".lock"),
                           os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._fd, fcntl.LOCK_UN)
        os.close(self._fd)


def _build_locked(name, srcs, link_flags, cxx_flags=CXX_FLAGS, libs=()):
    """Build `name` under BUILD_DIR if its sources or command changed;
    the caller holds the file lock. `libs` follow the objects on the
    link line. Returns the output path."""
    out = os.path.join(BUILD_DIR, name)
    link = ["g++", *cxx_flags, *link_flags]
    objs, key = _plan(srcs, link + list(libs), cxx_flags)
    stamp = out + ".srchash"
    try:
        with open(stamp) as f:
            if f.read().strip() == key and os.path.exists(out):
                return out
    except OSError:
        pass
    with ThreadPoolExecutor(len(objs)) as ex:
        for fut in [ex.submit(_compile, o, cmd) for o, cmd in objs]:
            fut.result()
    fd, tmp = tempfile.mkstemp(prefix=f".{name}.", dir=BUILD_DIR)
    os.close(fd)
    try:
        _run(link + ["-o", tmp] + [o for o, _ in objs] + list(libs), name)
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(stamp + ".tmp", "w") as f:
        f.write(key)
    os.replace(stamp + ".tmp", stamp)
    return out


def library_path():
    """Where `load()` builds and finds libpt_native.so."""
    return os.path.join(BUILD_DIR, "libpt_native.so")


def load():
    """Build (if its sources changed) and load libpt_native.so. Raises
    NativeBuildError when it does not build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with _FileLock():
            path = _build_locked("libpt_native.so", _LIB_SRCS, ["-shared"])
            lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
        return _lib


def available():
    """Whether the library builds and loads here."""
    try:
        load()
        return True
    except NativeBuildError:
        return False


def _build_bin(name):
    with _lock, _FileLock():
        return _build_locked(name, _BIN_SRCS[name], [])


def build_pt_infer():
    """Build the `pt_infer` binary (the Python-free serving CLI over a
    saved inference model); returns its path."""
    return _build_bin("pt_infer")


def build_pt_train():
    """Build the `pt_train` binary (Python-free training of a saved
    Program); returns its path."""
    return _build_bin("pt_train")


def _libtorch_flags(kernel_lib):
    """(compile flags, link libraries) of a libtorch binary: torch's
    include and library paths and C++ ABI, K8's kernel library path
    (PTT_KERNEL_LIB) and, with a CUDA build of torch, its CUDA kernel
    (PTT_WITH_CUDA) and libraries."""
    import torch
    from torch.utils import cpp_extension

    cuda = torch.version.cuda is not None
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    cxx = ("-O2", "-std=c++17", "-fPIC", "-pthread",
           f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
           *(f"-I{p}" for p in cpp_extension.include_paths()),
           f'-DPTT_KERNEL_LIB="{kernel_lib}"',
           *(("-DPTT_WITH_CUDA",) if cuda else ()))
    libdir = cpp_extension.library_paths()[0]
    libs = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-Wl,--no-as-needed",
            "-ltorch", "-ltorch_cpu", "-lc10",
            *(("-ltorch_cuda", "-lc10_cuda") if cuda else ()), "-ldl"]
    return cxx, libs


def build_pt_aoti_run(kernel_lib=None):
    """Build the `pt_aoti_run` binary (an AOTInductor package of an
    exported Program through libtorch, no Python) with g++ against the
    installed torch; returns its path. `kernel_lib` is the CUDA kernel
    library its K8 op loads on first use (None: the one
    `ops/kernels/_build.py` builds for the current sources). Takes tens of
    seconds the first time (the torch headers)."""
    from paddle_tpu_torch.ops.kernels import _build
    cxx, libs = _libtorch_flags(kernel_lib or _build.library_path())
    with _lock, _FileLock():
        return _build_locked("pt_aoti_run", _AOTI_SRCS, [], cxx, libs)


def _declare(lib):
    c = ctypes
    P = c.POINTER
    sigs = {
        # dataset
        "ptds_dataset_create": (c.c_void_p, [c.c_char_p, P(c.c_int32),
                                             P(c.c_int32), c.c_int]),
        "ptds_dataset_destroy": (None, [c.c_void_p]),
        "ptds_dataset_set_filelist": (None, [c.c_void_p, c.c_char_p]),
        "ptds_dataset_set_trainer": (None, [c.c_void_p, c.c_int, c.c_int]),
        "ptds_dataset_load_into_memory": (None, [c.c_void_p, c.c_int]),
        "ptds_dataset_local_shuffle": (None, [c.c_void_p, c.c_uint64]),
        "ptds_dataset_global_shuffle": (None, [c.c_void_p, c.c_uint64]),
        "ptds_dataset_size": (c.c_int64, [c.c_void_p]),
        "ptds_dataset_release_memory": (None, [c.c_void_p]),
        "ptds_dataset_last_error": (c.c_int, [c.c_void_p, c.c_char_p,
                                              c.c_int]),
        "ptds_feeder_create": (c.c_void_p, [c.c_void_p, c.c_int, c.c_int]),
        "ptds_feeder_destroy": (None, [c.c_void_p]),
        "ptds_feeder_next": (c.c_int, [c.c_void_p]),
        "ptds_feeder_reset": (None, [c.c_void_p]),
        "ptds_feeder_dense": (P(c.c_float), [c.c_void_p, c.c_int]),
        "ptds_feeder_sparse_ids": (P(c.c_int64), [c.c_void_p, c.c_int]),
        "ptds_feeder_sparse_lod": (P(c.c_int64), [c.c_void_p, c.c_int]),
        "ptds_feeder_sparse_len": (c.c_int64, [c.c_void_p, c.c_int]),
        # parameter server
        "ptps_server_create": (c.c_void_p, [c.c_int]),
        "ptps_server_destroy": (None, [c.c_void_p]),
        "ptps_server_add_sparse_table": (None, [c.c_void_p, c.c_int32,
                                                c.c_int32, c.c_int32,
                                                c.c_float, c.c_float]),
        "ptps_server_add_dense_table": (None, [c.c_void_p, c.c_int32,
                                               c.c_int64, c.c_int32,
                                               c.c_float]),
        "ptps_server_set_num_workers": (None, [c.c_void_p, c.c_int]),
        "ptps_server_start": (c.c_int, [c.c_void_p]),
        "ptps_server_port": (c.c_int, [c.c_void_p]),
        "ptps_server_stop": (None, [c.c_void_p]),
        "ptps_server_running": (c.c_int, [c.c_void_p]),
        "ptps_server_sparse_rows": (c.c_uint64, [c.c_void_p, c.c_int32]),
        "ptps_server_lost_workers": (c.c_int, [c.c_void_p, c.c_double,
                                               P(c.c_int32), c.c_int]),
        "ptps_server_evict_worker": (None, [c.c_void_p, c.c_int32]),
        "ptps_client_create": (c.c_void_p, [c.c_char_p]),
        "ptps_client_destroy": (None, [c.c_void_p]),
        "ptps_client_connect": (c.c_int, [c.c_void_p]),
        "ptps_client_last_error": (c.c_int, [c.c_void_p, c.c_char_p,
                                             c.c_int]),
        "ptps_client_pull_sparse": (c.c_int, [c.c_void_p, c.c_int32,
                                              P(c.c_uint64), c.c_uint64,
                                              c.c_int32, P(c.c_float)]),
        "ptps_client_push_sparse": (c.c_int, [c.c_void_p, c.c_int32,
                                              P(c.c_uint64), c.c_uint64,
                                              c.c_int32, P(c.c_float)]),
        "ptps_client_set_connect_attempts": (None, [c.c_void_p, c.c_int,
                                                    c.c_int]),
        "ptps_client_set_push_id": (None, [c.c_void_p, c.c_uint64]),
        "ptps_client_broken_endpoints": (c.c_int, [c.c_void_p,
                                                   P(c.c_int32), c.c_int]),
        "ptps_client_push_sparse_seq": (c.c_int, [c.c_void_p, c.c_int32,
                                                  c.c_uint64, P(c.c_uint64),
                                                  c.c_uint64, c.c_int32,
                                                  P(c.c_float)]),
        "ptps_client_push_dense_seq": (c.c_int, [c.c_void_p, c.c_int32,
                                                 c.c_uint64, P(c.c_float),
                                                 c.c_uint64]),
        "ptps_client_pull_dense": (c.c_int, [c.c_void_p, c.c_int32,
                                             P(c.c_float), c.c_uint64]),
        "ptps_client_push_dense": (c.c_int, [c.c_void_p, c.c_int32,
                                             P(c.c_float), c.c_uint64]),
        "ptps_client_init_dense": (c.c_int, [c.c_void_p, c.c_int32,
                                             P(c.c_float), c.c_uint64]),
        "ptps_client_heartbeat": (c.c_int, [c.c_void_p, c.c_int32]),
        "ptps_client_barrier": (c.c_int, [c.c_void_p, c.c_int32]),
        "ptps_client_shrink": (c.c_int, [c.c_void_p, c.c_int32,
                                         c.c_uint64]),
        "ptps_client_stop_servers": (c.c_int, [c.c_void_p]),
        # the inference C API (reference capi/c_api.h)
        "pd_predictor_create": (c.c_void_p, [c.c_char_p, c.c_char_p,
                                             c.c_char_p, c.c_char_p,
                                             c.c_int]),
        "pd_predictor_destroy": (None, [c.c_void_p]),
        "pd_predictor_clone": (c.c_void_p, [c.c_void_p]),
        "pd_predictor_num_inputs": (c.c_int, [c.c_void_p]),
        "pd_predictor_num_outputs": (c.c_int, [c.c_void_p]),
        "pd_predictor_input_name": (c.c_char_p, [c.c_void_p, c.c_int]),
        "pd_predictor_output_name": (c.c_char_p, [c.c_void_p, c.c_int]),
        "pd_predictor_set_input": (c.c_int, [c.c_void_p, c.c_char_p,
                                             c.c_void_p, P(c.c_int64),
                                             c.c_int, c.c_int]),
        "pd_predictor_run": (c.c_int, [c.c_void_p]),
        "pd_predictor_last_error": (c.c_int, [c.c_void_p, c.c_char_p,
                                              c.c_int]),
        "pd_predictor_output_ndim": (c.c_int, [c.c_void_p, c.c_int]),
        "pd_predictor_output_shape": (None, [c.c_void_p, c.c_int,
                                             P(c.c_int64)]),
        "pd_predictor_output_dtype": (c.c_int, [c.c_void_p, c.c_int]),
        "pd_predictor_output_data": (c.c_void_p, [c.c_void_p, c.c_int]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


# ---- numpy wrappers -------------------------------------------------------

DENSE, SPARSE = 0, 1


class NativeDataset:
    """The C++ Dataset (data_set.h:92): MultiSlot text files parsed by a
    thread pool into memory, local / global shuffles, batches."""

    def __init__(self, slots):
        """slots: list of (name, "dense"|"sparse", dim)."""
        self._lib = load()
        self.slots = list(slots)
        names = "|".join(s[0] for s in slots).encode()
        types = np.asarray([DENSE if s[1] == "dense" else SPARSE
                            for s in slots], np.int32)
        dims = np.asarray([s[2] for s in slots], np.int32)
        self._h = self._lib.ptds_dataset_create(
            names, types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(slots))
        self._dense_idx = [i for i, s in enumerate(slots) if s[1] == "dense"]
        self._sparse_idx = [i for i, s in enumerate(slots)
                            if s[1] == "sparse"]

    def set_filelist(self, files):
        self._lib.ptds_dataset_set_filelist(self._h,
                                            "|".join(files).encode())

    def set_trainer(self, trainer_id, trainer_num):
        self._lib.ptds_dataset_set_trainer(self._h, trainer_id, trainer_num)

    def load_into_memory(self, num_threads=4):
        self._lib.ptds_dataset_load_into_memory(self._h, num_threads)
        if self.size() == 0:
            buf = ctypes.create_string_buffer(512)
            if self._lib.ptds_dataset_last_error(self._h, buf, 512) > 0:
                raise RuntimeError(f"load_into_memory: {buf.value.decode()}")

    def local_shuffle(self, seed=0):
        self._lib.ptds_dataset_local_shuffle(self._h, seed)

    def global_shuffle(self, seed=0):
        self._lib.ptds_dataset_global_shuffle(self._h, seed)

    def size(self):
        return self._lib.ptds_dataset_size(self._h)

    def release_memory(self):
        self._lib.ptds_dataset_release_memory(self._h)

    def batches(self, batch_size, drop_last=False):
        """Yield dicts slot name -> float32 [B, dim] (dense) or (ids
        int64, lod int64 [B + 1]) (sparse), copied out of the feeder."""
        lib = self._lib
        f = lib.ptds_feeder_create(self._h, batch_size, int(drop_last))
        try:
            while True:
                b = lib.ptds_feeder_next(f)
                if b == 0:
                    break
                out = {}
                for k, i in enumerate(self._dense_idx):
                    name, _, dim = self.slots[i]
                    out[name] = np.ctypeslib.as_array(
                        lib.ptds_feeder_dense(f, k), shape=(b, dim)).copy()
                for k, i in enumerate(self._sparse_idx):
                    n = int(lib.ptds_feeder_sparse_len(f, k))
                    ids = (np.empty(0, np.int64) if n == 0 else
                           np.ctypeslib.as_array(
                               lib.ptds_feeder_sparse_ids(f, k),
                               shape=(n,)).copy())
                    lod = np.ctypeslib.as_array(
                        lib.ptds_feeder_sparse_lod(f, k),
                        shape=(b + 1,)).copy()
                    out[self.slots[i][0]] = (ids, lod)
                yield out
        finally:
            lib.ptds_feeder_destroy(f)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ptds_dataset_destroy(self._h)
        except Exception:
            pass


_NP_DTYPE_CODE = {"float32": 0, "int64": 1, "int32": 2, "float64": 3,
                  "uint8": 4, "bool": 5, "int8": 6}
_CODE_NP_DTYPE = {0: np.float32, 1: np.int64, 2: np.int32, 3: np.float64,
                  4: np.uint8, 5: np.bool_, 6: np.int8}


class NativePredictor:
    """The C inference API (pd_predictor_*, reference capi/c_api.h): a
    saved `__model__.json` + `params.npz` run by the C++ interpreter on
    the host, the in-process twin of `pt_infer`."""

    def __init__(self, model_dir, model_filename=None, params_filename=None,
                 _handle=None):
        self._lib = load()
        if _handle is not None:
            self._h = _handle
            return
        err = ctypes.create_string_buffer(512)
        self._h = self._lib.pd_predictor_create(
            str(model_dir).encode(),
            model_filename.encode() if model_filename else None,
            params_filename.encode() if params_filename else None,
            err, 512)
        if not self._h:
            raise RuntimeError(f"NativePredictor: {err.value.decode()}")

    def clone(self):
        """A handle sharing the loaded model, with its own feed and output
        buffers (AnalysisPredictor::Clone)."""
        return NativePredictor(None, _handle=self._lib.pd_predictor_clone(
            self._h))

    def input_names(self):
        n = self._lib.pd_predictor_num_inputs(self._h)
        return [self._lib.pd_predictor_input_name(self._h, i).decode()
                for i in range(n)]

    def output_names(self):
        n = self._lib.pd_predictor_num_outputs(self._h)
        return [self._lib.pd_predictor_output_name(self._h, i).decode()
                for i in range(n)]

    def run(self, feeds):
        """feeds: {name: np.ndarray} -> list of np.ndarray outputs."""
        for name, arr in feeds.items():
            arr = np.ascontiguousarray(arr)
            code = _NP_DTYPE_CODE.get(str(arr.dtype))
            if code is None:
                raise TypeError(f"unsupported feed dtype {arr.dtype}")
            shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
            if self._lib.pd_predictor_set_input(
                    self._h, name.encode(),
                    arr.ctypes.data_as(ctypes.c_void_p), shape, arr.ndim,
                    code) != 0:
                raise RuntimeError(f"set_input({name}) failed")
        if self._lib.pd_predictor_run(self._h) != 0:
            buf = ctypes.create_string_buffer(512)
            self._lib.pd_predictor_last_error(self._h, buf, 512)
            raise RuntimeError(f"NativePredictor.run: {buf.value.decode()}")
        outs = []
        for i in range(self._lib.pd_predictor_num_outputs(self._h)):
            nd = self._lib.pd_predictor_output_ndim(self._h, i)
            shape = (ctypes.c_int64 * nd)()
            self._lib.pd_predictor_output_shape(self._h, i, shape)
            dt = _CODE_NP_DTYPE[self._lib.pd_predictor_output_dtype(
                self._h, i)]
            ptr = self._lib.pd_predictor_output_data(self._h, i)
            n = int(np.prod(shape)) if nd else 1
            buf = (ctypes.c_char * (n * np.dtype(dt).itemsize)
                   ).from_address(ptr)
            outs.append(np.frombuffer(buf, dtype=dt).reshape(
                tuple(shape)).copy())
        return outs

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.pd_predictor_destroy(self._h)
        except Exception:
            pass
