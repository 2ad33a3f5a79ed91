"""Filesystem abstraction for model IO.

Counterpart of paddle_tpu/io/fs.py (the reference's framework/io/fs.h
and the fleet's HDFS utils). Save and load paths take scheme-prefixed
URIs; each scheme maps to a FileSystem:

    file://  (or no scheme)  local disk            LocalFS
    mem://                   in-process store      MemFS (tests, fakes)
    gs:// hdfs:// afs://     register your own     register_fs()

Remote schemes are pluggable: a deployment registers a client-backed
FileSystem once, and every save / load call of static/io.py and every
`dataset_ext.download` works against it unchanged.
"""
import io as _io
import os

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.core.enforce import enforce

_REGISTRY = {}
_LOCK = make_lock("io.fs")


class FileSystem:
    def open(self, path, mode="rb"):
        raise NotImplementedError

    def exists(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def listdir(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def rename(self, src, dst):
        """Move src over dst (the atomic publish of static/io.py's
        write-then-rename savers). The generic fallback is copy + delete;
        a remote FileSystem overrides it with its native rename."""
        with self.open(src, "rb") as s, self.open(dst, "wb") as d:
            d.write(s.read())
        self.delete(src)


class LocalFS(FileSystem):
    def open(self, path, mode="rb"):
        return open(path, mode)

    def rename(self, src, dst):
        os.replace(src, dst)

    def exists(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def listdir(self, path):
        return sorted(os.listdir(path))

    def delete(self, path):
        if os.path.isdir(path):
            import shutil
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


class _MemFile(_io.BytesIO):
    def __init__(self, store, path):
        super().__init__()
        self._store = store
        self._path = path

    def close(self):
        self._store[self._path] = self.getvalue()
        super().close()


class _MemTextFile(_io.StringIO):
    def __init__(self, store, path):
        super().__init__()
        self._store = store
        self._path = path

    def close(self):
        self._store[self._path] = self.getvalue().encode()
        super().close()


class MemFS(FileSystem):
    """In-process filesystem — deterministic fake for tests and the
    single-process stand-in for a remote object store."""

    def __init__(self):
        self._files = {}

    def open(self, path, mode="rb"):
        if "r" in mode:
            enforce(path in self._files, "mem:// file %r not found", path)
            data = self._files[path]
            if "b" in mode:
                return _io.BytesIO(data)
            return _io.StringIO(data.decode())
        if "b" in mode:
            return _MemFile(self._files, path)
        return _MemTextFile(self._files, path)

    def exists(self, path):
        return path in self._files or any(
            k.startswith(path.rstrip("/") + "/") for k in self._files)

    def mkdirs(self, path):
        pass  # directories are implicit

    def listdir(self, path):
        prefix = path.rstrip("/") + "/"
        names = {k[len(prefix):].split("/")[0]
                 for k in self._files if k.startswith(prefix)}
        return sorted(names)

    def delete(self, path):
        prefix = path.rstrip("/") + "/"
        for k in list(self._files):
            if k == path or k.startswith(prefix):
                del self._files[k]

    def rename(self, src, dst):
        enforce(src in self._files, "mem:// file %r not found", src)
        self._files[dst] = self._files.pop(src)


def register_fs(scheme, fs):
    """Register a FileSystem for a URI scheme (e.g. 'gs', 'hdfs')."""
    with _LOCK:
        _REGISTRY[scheme] = fs


def has_fs(scheme):
    """Is a FileSystem registered for `scheme`?"""
    with _LOCK:
        return scheme in _REGISTRY


def get_fs(path):
    """(FileSystem, path-without-scheme) for a possibly-prefixed path."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        with _LOCK:
            fs = _REGISTRY.get(scheme)
        enforce(fs is not None,
                "no filesystem registered for scheme %r (register_fs)",
                scheme)
        # keep mem:// keys stable including the scheme-less form
        return fs, rest if not isinstance(fs, MemFS) else path
    return _LOCAL, path


def join(path, *parts):
    """Scheme-aware join (os.path.join breaks URIs)."""
    out = path.rstrip("/")
    for p in parts:
        out += "/" + p.strip("/")
    return out


_LOCAL = LocalFS()
_MEM = MemFS()
register_fs("file", _LOCAL)
register_fs("mem", _MEM)
