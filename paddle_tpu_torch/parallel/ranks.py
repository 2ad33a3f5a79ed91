"""A pool of rank processes: one worker per rank of a process group.

The JAX package needs none (its tests run one process over 8 forced host
devices); the port's parallelism is one process per rank, so its tests
and the smoke script start a pool of workers once and send them work:

    with RankPool(4, backend="gloo", device="cpu", store=path) as pool:
        results = pool.run("/abs/path/module.py", "fn", arg, ...)

Each worker (`python -m paddle_tpu_torch.parallel.ranks`, or a
`command` whose program hands its arguments to `worker`) connects back
to the parent over a localhost socket, initializes the process group
(`init_process_group(backend, init_method="file://<store>")`, the
backend the caller's explicit argument), then calls `fn(ctx, *args)` for
each request, `ctx` holding its rank, the world size, its device and
backend. `fn` is a module-level function of a module named by file path
or dotted name; its results come back pickled. Every wait has a
deadline: a worker that does not answer in time, or an error on any
rank, kills the whole pool before the exception is raised, and the pool
kills its workers when it closes.
"""
import argparse
import datetime
import importlib
import importlib.util
import os
import pickle
import secrets
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Client, Listener

__all__ = ["RankPool", "RankContext", "RankError", "worker"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class RankError(RuntimeError):
    pass


class RankContext:
    """What a rank function gets: rank, world size, device, backend."""

    def __init__(self, rank, world, device, backend):
        self.rank, self.world = rank, world
        self.device, self.backend = device, backend

    @property
    def jax_loaded(self):
        return "jax" in sys.modules or "paddle_tpu" in sys.modules


class RankPool:
    """`device=None` is the card (raises without one); tests pass
    `device="cpu"`. The backend ("nccl" or "gloo") is explicit."""

    def __init__(self, world_size, backend, device=None,
                 store=None, timeout=120.0, start_timeout=180.0,
                 command=None, env=None):
        from paddle_tpu_torch.core.places import resolve_device
        device = resolve_device(device)
        self.world = int(world_size)
        self.backend, self.device = backend, device
        self.timeout = float(timeout)
        self.procs, self.conns = [], [None] * self.world
        if store is None:
            import tempfile
            store = os.path.join(tempfile.mkdtemp(prefix="ranks-"), "store")
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        host, port = self._listener.address
        penv = dict(os.environ if env is None else env)
        penv["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in penv.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        try:
            for r in range(self.world):
                self.procs.append(subprocess.Popen(
                    list(command or [sys.executable, "-m",
                                     "paddle_tpu_torch.parallel.ranks"])
                    + ["--rank", str(r), "--world", str(self.world),
                     "--backend", backend, "--device", str(device),
                     "--store", store, "--address", f"{host}:{port}",
                     "--authkey", key.hex(),
                     "--timeout", str(int(self.timeout))],
                    env=penv, cwd=_REPO))
            self._accept(start_timeout)
            self.run_module("paddle_tpu_torch.parallel.ranks", "_ready",
                            timeout=start_timeout)
        except BaseException:
            self.close(kill=True)
            raise

    def _accept(self, timeout):
        sock = self._listener._listener._socket
        deadline = time.monotonic() + timeout
        got = 0
        while got < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{self.world - got} rank(s) did not "
                                   f"connect in {timeout:.0f} s")
            for p in self.procs:
                if p.poll() is not None:
                    raise RankError(f"a rank exited with {p.returncode} "
                                    f"before connecting")
            sock.settimeout(min(left, 1.0))
            try:
                conn = self._listener.accept()
            except OSError:       # the accept timed out: check the procs
                continue
            rank = conn.recv()
            self.conns[rank] = conn
            got += 1

    def run(self, path, name, *args, timeout=None, **kwargs):
        """Call `name` of the module at file `path` on every rank with
        (ctx, *args, **kwargs); returns the results by rank."""
        return self._call(("call", path, name, args, kwargs), timeout)

    def run_module(self, module, name, *args, timeout=None, **kwargs):
        """As `run`, for a function of an importable module."""
        return self._call(("call", module, name, args, kwargs), timeout)

    def run_each(self, path, name, per_rank_args, timeout=None):
        """Call `name` with rank r's own argument tuple per_rank_args[r]."""
        if not self.procs:
            raise RankError("the rank pool is closed")
        for r, conn in enumerate(self.conns):
            conn.send(("call", path, name, tuple(per_rank_args[r]), {}))
        return self._collect(timeout)

    def _call(self, msg, timeout):
        if not self.procs:
            raise RankError("the rank pool is closed")
        for conn in self.conns:
            conn.send(msg)
        return self._collect(timeout)

    def _collect(self, timeout):
        deadline = time.monotonic() + (timeout or self.timeout)
        out = [None] * self.world
        pending = set(range(self.world))
        try:
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"rank(s) {sorted(pending)} did not answer in "
                        f"{timeout or self.timeout:.0f} s")
                for r in list(pending):
                    if self.conns[r].poll(min(0.05, max(left, 0.0))):
                        status, value = self.conns[r].recv()
                        pending.discard(r)
                        if status == "ok":
                            out[r] = value
                        else:
                            # a rank failed: its peers may wait forever
                            raise RankError(f"rank {r} failed:\n{value}")
                    elif self.procs[r].poll() is not None:
                        raise RankError(f"rank {r} exited with "
                                        f"{self.procs[r].returncode}")
        except BaseException:
            self.close(kill=True)
            raise
        return out

    def close(self, kill=False):
        """Stop the workers (kill=True: at once) and reap them."""
        if not kill:
            for conn in self.conns:
                try:
                    if conn is not None:
                        conn.send(("exit",))
                except OSError:
                    pass
            end = time.monotonic() + 10
            for p in self.procs:
                try:
                    p.wait(timeout=max(end - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    pass
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for conn in self.conns:
            if conn is not None:
                conn.close()
        self.conns = [None] * self.world
        self.procs = []
        self._listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def _ready(ctx):
    return {"rank": ctx.rank, "jax_loaded": ctx.jax_loaded}


_MODULES = {}


def _load(path):
    mod = _MODULES.get(path)
    if mod is None:
        if os.sep in path or path.endswith(".py"):
            name = "_rank_fns_" + str(abs(hash(path)))
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
        else:
            mod = importlib.import_module(path)
        _MODULES[path] = mod
    return mod


def worker(argv=None):
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--timeout"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--backend", "--device", "--store", "--address",
                 "--authkey"):
        ap.add_argument(flag, required=True)
    a = ap.parse_args(argv)
    host, port = a.address.rsplit(":", 1)
    conn = Client((host, int(port)), authkey=bytes.fromhex(a.authkey))
    conn.send(a.rank)
    import torch
    import torch.distributed as dist
    dev = torch.device(a.device)
    if dev.type == "cuda":
        torch.cuda.set_device(0 if dev.index is None else dev.index)
    dist.init_process_group(
        a.backend, init_method="file://" + a.store, world_size=a.world,
        rank=a.rank, timeout=datetime.timedelta(seconds=a.timeout))
    ctx = RankContext(a.rank, a.world, a.device, a.backend)
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg[0] == "exit":
                break
            _, path, name, args, kwargs = msg
            try:
                value = getattr(_load(path), name)(ctx, *args, **kwargs)
                pickle.dumps(value)
                conn.send(("ok", value))
            except BaseException:
                conn.send(("err", traceback.format_exc()))
    finally:
        try:
            dist.destroy_process_group()
        except Exception:
            pass
        conn.close()


if __name__ == "__main__":
    worker()
