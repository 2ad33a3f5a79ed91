"""Mesh management over torch.distributed.

Counterpart of paddle_tpu/parallel/env.py. The JAX package is one
process holding a `jax.sharding.Mesh` of named axes; the port is one
process per rank, a `torch.distributed` process group that the caller
initializes (its backend, nccl or gloo, is the caller's explicit
argument to `init_process_group`), and a `DeviceMesh` with named dims
over that group. Standard axis names:

    dp  — data parallel (batch sharding)
    tp  — tensor/model parallel
    pp  — pipeline stages
    sp  — sequence/context parallel
    ep  — expert parallel

`make_mesh` keeps the reference's `-1` rule (one axis absorbs the rest of
the world) and may span a subset of the world's ranks. A mesh of one
rank needs no process group. The mesh's device
type comes from the `device` argument (None means CUDA and raises
without a GPU), never from the environment.

The *bound* mesh (`set_mesh`, or `bind_mesh` for a block) is what the
collectives of `ops/collective.py` run over: an axis the bound mesh does
not have (or a mesh without a process group) makes a collective the
identity, as an unbound axis name does in the JAX package.
"""
import contextlib
import threading

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.places import resolve_device

__all__ = ["DEFAULT_DP_AXIS", "Mesh", "make_mesh", "set_mesh", "get_mesh",
           "bound_mesh", "bind_mesh", "device_count", "axis_info"]

DEFAULT_DP_AXIS = "dp"

_current_mesh = None
_local = threading.local()


def device_count():
    """Ranks in the world (the JAX package's device count): the process
    group's size, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class Mesh:
    """Named axes over ranks of the world: `axis_names`, `shape` ({name:
    size}), `ranks` (the global ranks in mesh order), this rank's
    coordinate on each axis, one process group per axis, the device this
    rank computes on, and the `DeviceMesh` when the mesh spans the
    world."""

    def __init__(self, names, sizes, device, groups=None, coords=None,
                 ranks=None, device_mesh=None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device = device
        self.groups = dict(groups or {})
        self.coords = dict(coords or {})
        self.ranks = list(ranks) if ranks is not None else [0]
        self.device_mesh = device_mesh

    @property
    def size(self):
        return int(np.prod(list(self.shape.values()) or [1]))

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def group(self, axis):
        """The process group of `axis` (None without a process group)."""
        return self.groups.get(axis)

    def coord(self, axis):
        """This rank's index along `axis`."""
        return self.coords.get(axis, 0)

    def backend(self, axis):
        g = self.group(axis)
        return None if g is None else dist.get_backend(g)

    def describe(self):
        return ",".join(f"{k}:{v}" for k, v in self.shape.items()) or \
            "single"

    def __repr__(self):
        return f"Mesh({self.describe()}, device={self.device})"


def make_mesh(axes=None, device=None, ranks=None):
    """axes: {name: size} (e.g. {"dp": 2, "tp": 2}) or None for all-dp.
    One size may be -1: it absorbs the ranks the others leave. The mesh
    spans `ranks` (default: the whole world); every rank of the world
    calls make_mesh alike (a process group is made collectively), and a
    rank outside `ranks` gets None. Without a process group the mesh has
    one rank and no group (its collectives are the identity)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ranks = list(range(device_count())) if ranks is None else list(ranks)
    n = len(ranks)
    if not axes:
        axes = {DEFAULT_DP_AXIS: n}
    names = list(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    enforce(total == n, "mesh %s has %d ranks but spans %d",
            dict(zip(names, sizes)), total, n)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(names, sizes, dev)
    me = dist.get_rank()
    arr = np.asarray(ranks).reshape(sizes)
    if n == dist.get_world_size() and ranks == sorted(ranks):
        from torch.distributed.device_mesh import DeviceMesh
        dm = DeviceMesh(dev.type, arr.tolist(), mesh_dim_names=tuple(names))
        return Mesh(names, sizes, dev,
                    {a: dm.get_group(a) for a in names},
                    {a: dm.get_local_rank(a) for a in names}, ranks, dm)
    groups, coords = {}, {}
    for i, name in enumerate(names):
        for row in np.moveaxis(arr, i, -1).reshape(-1, sizes[i]).tolist():
            g = dist.new_group(row)
            if me in row:
                groups[name], coords[name] = g, row.index(me)
    if me not in ranks:
        return None
    return Mesh(names, sizes, dev, groups, coords, ranks)


def set_mesh(mesh):
    """Bind `mesh` for this process (the collectives run over it)."""
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh():
    """The bound mesh; without one, an all-dp mesh over the world on the
    default device (CUDA), which is then bound."""
    global _current_mesh
    mesh = bound_mesh()
    if mesh is None:
        mesh = _current_mesh = make_mesh()
    return mesh


def bound_mesh():
    """The mesh a `bind_mesh` block or `set_mesh` bound, or None."""
    stack = getattr(_local, "stack", None)
    if stack:
        return stack[-1]
    return _current_mesh


@contextlib.contextmanager
def bind_mesh(mesh):
    """Bind `mesh` on this thread for the block."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


class AxisInfo:
    __slots__ = ("name", "group", "size", "rank", "backend")

    def __init__(self, name, group, size, rank, backend):
        self.name, self.group, self.size = name, group, size
        self.rank, self.backend = rank, backend


def axis_info(name):
    """The bound mesh's axis `name` as (group, size, this rank's index,
    backend), or None when no mesh binds it or the mesh has no process
    group (a size-1 axis over a process group is a real one-rank group:
    its collectives run, as a world of one NCCL rank's do)."""
    mesh = bound_mesh()
    if mesh is None or name not in mesh.shape:
        return None
    g = mesh.group(name)
    if g is None:
        return None
    return AxisInfo(name, g, mesh.axis_size(name), mesh.coord(name),
                    dist.get_backend(g))
