"""Collective communication ops over the bound mesh's process groups.

Counterpart of paddle_tpu/ops/collective.py (the reference's
operators/collective/: c_allreduce_{sum,max,min,prod}, c_broadcast,
c_allgather, c_reducescatter, c_sync_*_stream, c_comm_init,
c_gen_nccl_id). The JAX package lowers them to XLA collectives over a
named mesh axis bound by shard_map; here each runs `torch.distributed`
over the process group of the bound mesh's dim named by attr
`axis_name` (default "dp", parallel/env.py). Where no mesh binds that
axis (or its mesh has no process group) a collective is the identity, as the
reference's `_have_axis` makes it. `c_comm_init`, `c_gen_unique_id` and
the two stream syncs are no-ops: the process group is made by the
caller, and the collectives run on the current stream.

Each collective that carries data is a `torch.autograd.Function` whose
backward is the transpose `jax.vjp` gives the reference: all_reduce sum
↔ all_reduce sum, all_gather ↔ reduce_scatter, all_to_all ↔ the inverse
all_to_all, `c_permute` ↔ the reverse shift, broadcast ↔ the root
summing every rank's cotangent. A rank's autograd graph then computes
its share of the gradient, and a value replicated across ranks gets the
sum of its replicas' cotangents (the convention parallel/compiler.py's
data-parallel step is built on).

Where this differs from the JAX package:

* `c_allreduce_prod` is the true product across ranks (an all_gather
  and a product). The reference computes exp(psum(log x)), which is NaN
  for a negative x and loses a zero's sign (ROADMAP Queue 3).
* gloo takes CUDA tensors for its collectives (all_reduce, broadcast,
  all_gather, reduce_scatter, all_to_all) but not for send / recv: a
  CUDA send aborts the rank process (seen on an H100). So `exchange`
  stages a CUDA tensor on a gloo group through a pinned host buffer
  and back (GLOO_STAGED); `staged` counts those copies and their bytes.
  A staged copy moves bytes, no compute. NCCL never stages. `issued`
  counts the collectives Python issues, by kind.
  On gloo a collective is host work, so a program holding one runs its
  autodiff region eagerly (core/lowering.py's capture plan); NCCL
  collectives are captured in the step's CUDA graph.
"""
import torch
import torch.distributed as dist

from paddle_tpu_torch.core.registry import register_op

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "permute", "broadcast", "exchange", "staged", "issued",
           "reset_staged", "GLOO_STAGED"]

#: what gloo refuses CUDA tensors for, so stages through the host
GLOO_STAGED = frozenset({"send_recv"})

#: copies staged through the host for gloo: {"copies", "bytes"}
staged = {"copies": 0, "bytes": 0}
#: collectives issued from Python, by kind (a captured graph's replay
#: reruns its collectives without issuing them again)
issued = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
          "all_to_all": 0, "send_recv": 0, "broadcast": 0}


def reset_staged():
    staged["copies"] = 0
    staged["bytes"] = 0
    for k in issued:
        issued[k] = 0


def _stages(ax, kind, device):
    return (ax.backend == "gloo" and torch.device(device).type == "cuda"
            and kind in GLOO_STAGED)


def _host(t):
    """A pinned host copy of CUDA tensor t (one staged copy)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    staged["copies"] += 1
    staged["bytes"] += t.numel() * t.element_size()
    return h


def _back(h, device):
    out = h.to(device, non_blocking=False)
    staged["copies"] += 1
    staged["bytes"] += h.numel() * h.element_size()
    return out


_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}


def _all_reduce(ax, x, op="sum"):
    issued["all_reduce"] += 1
    out = x.contiguous().clone()
    dist.all_reduce(out, op=_REDUCE[op], group=ax.group)
    return out


def _all_gather(ax, x, dim):
    """Tiled all_gather: the ranks' x concatenated along `dim`."""
    issued["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(ax, x, dim):
    """Tiled reduce_scatter: the sum over ranks of x, this rank's slice
    along `dim`."""
    n = x.shape[dim]
    assert n % ax.size == 0, (
        f"reduce_scatter: dim {dim} of size {n} does not split over "
        f"{ax.size} ranks")
    issued["reduce_scatter"] += 1
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n // ax.size,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xm, group=ax.group)
    return out.movedim(0, dim).contiguous()


def _all_to_all(ax, x, split_dim, concat_dim):
    """Tiled all_to_all: split x into `size` chunks along split_dim, send
    chunk j to rank j, concatenate what arrives along concat_dim."""
    issued["all_to_all"] += 1
    p = ax.size
    assert x.shape[split_dim] % p == 0, (
        f"all_to_all: dim {split_dim} of size {x.shape[split_dim]} does "
        f"not split over {p} ranks")
    chunks = torch.stack(torch.chunk(x, p, dim=split_dim)).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=ax.group)
    return torch.cat(list(out.unbind(0)), dim=concat_dim)


def _shift(ax, x, shift):
    """Ring shift: rank r's x goes to rank (r + shift) % size."""
    got, = exchange(ax, [(x, (ax.rank + shift) % ax.size, 0)],
                    [(x.shape, x.dtype, x.device,
                      (ax.rank - shift) % ax.size, 0)])
    return got


def exchange(ax, sends, recvs):
    """Point-to-point exchange within the group of axis `ax` in one
    batch: `sends` are (tensor, peer index, tag), `recvs` are (shape,
    dtype, device, peer index, tag); returns the received tensors in
    `recvs` order. Posts sends before receives, each in list order, so
    two ranks that list a pair's messages in the same order match them
    on NCCL (which ignores tags) as on gloo."""
    issued["send_recv"] += 1
    ops, outs, staged_outs = [], [], []
    for t, peer, tag in sends:
        t = t.contiguous()
        src = _host(t) if _stages(ax, "send_recv", t.device) else t
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(ax.group, peer),
                              ax.group, tag))
    for shape, dtype, device, peer, tag in recvs:
        dev = torch.device(device)
        stage = _stages(ax, "send_recv", dev)
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if stage else dev,
                          pin_memory=stage)
        outs.append(buf)
        staged_outs.append(dev if stage else None)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(ax.group, peer),
                              ax.group, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [o if d is None else _back(o, d)
            for o, d in zip(outs, staged_outs)]


def _broadcast(ax, x, root):
    issued["broadcast"] += 1
    out = x.contiguous().clone()
    dist.broadcast(out, dist.get_global_rank(ax.group, root),
                   group=ax.group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(ax, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.ax, g), None


class _AllReduceExtreme(torch.autograd.Function):
    """pmax / pmin: the cotangents of every rank, summed, flow to the
    elements that attain the extreme (split evenly between ties across
    ranks)."""

    @staticmethod
    def forward(ctx, x, ax, op):
        out = _all_reduce(ax, x, op)
        hit = (x == out).to(x.dtype)
        ctx.ax = ax
        ctx.save_for_backward(hit, _all_reduce(ax, hit))
        return out

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        return _all_reduce(ctx.ax, g) * hit / count, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.ax, g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _reduce_scatter(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.ax, g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.ax, ctx.dims = ax, (split_dim, concat_dim)
        return _all_to_all(ax, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(ctx.ax, g, concat_dim, split_dim), None, None, \
            None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, shift):
        ctx.ax, ctx.shift = ax, shift
        return _shift(ax, x, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.ax, g, -ctx.shift), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, root):
        ctx.ax, ctx.root = ax, root
        return _broadcast(ax, x, root)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(ctx.ax, g)
        if ctx.ax.rank != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None


# ---------------------------------------------------------------- the API
def axis_info(name):
    """parallel.env.axis_info (imported when called: the parallel
    package imports this module)."""
    from paddle_tpu_torch.parallel.env import axis_info as info
    return info(name)


def _ax(axis):
    return axis if hasattr(axis, "group") else axis_info(axis)


def all_reduce(x, axis="dp", op="sum"):
    """Reduce x across the ranks of `axis` (sum, max, min or prod); the
    identity where the axis is not bound."""
    ax = _ax(axis)
    if ax is None:
        return x
    if op == "sum":
        return _AllReduceSum.apply(x, ax)
    if op == "prod":
        return _AllGather.apply(x.unsqueeze(0), ax, 0).prod(dim=0)
    return _AllReduceExtreme.apply(x, ax, op)


def all_gather(x, axis="dp", dim=0):
    ax = _ax(axis)
    return x if ax is None else _AllGather.apply(x, ax, dim)


def reduce_scatter(x, axis="dp", dim=0):
    ax = _ax(axis)
    return x if ax is None else _ReduceScatter.apply(x, ax, dim)


def all_to_all(x, axis="dp", split_dim=0, concat_dim=0):
    ax = _ax(axis)
    return x if ax is None else _AllToAll.apply(x, ax, split_dim,
                                                concat_dim)


def permute(x, axis="dp", shift=1):
    """Ring shift (collective_permute): rank r's x arrives at rank
    (r + shift) % size."""
    ax = _ax(axis)
    return x if ax is None else _Shift.apply(x, ax, int(shift))


def broadcast(x, axis="dp", root=0):
    ax = _ax(axis)
    return x if ax is None else _Broadcast.apply(x, ax, int(root))


# ---------------------------------------------------------------- the ops
def _axis(ctx):
    return ctx.attr("axis_name", "dp")


def _host_reason(op_desc):
    """A collective over a gloo group is host work: it splits the
    capture plan (NCCL's are captured)."""
    ax = axis_info(op_desc.attrs.get("axis_name", "dp"))
    if ax is not None and ax.backend == "gloo":
        return "a gloo collective runs on the host"
    return None


def _register_allreduce(op_name, op):
    @register_op(op_name, inputs=["X"], outputs=["Out"], host=_host_reason)
    def _impl(ctx, x, _op=op):
        return all_reduce(x, _axis(ctx), _op)


_register_allreduce("c_allreduce_sum", "sum")
_register_allreduce("c_allreduce_max", "max")
_register_allreduce("c_allreduce_min", "min")
_register_allreduce("c_allreduce_prod", "prod")


@register_op("c_broadcast", inputs=["X"], outputs=["Out"], host=_host_reason)
def _c_broadcast(ctx, x):
    return broadcast(x, _axis(ctx), ctx.attr("root", 0))


@register_op("c_allgather", inputs=["X"], outputs=["Out"], host=_host_reason)
def _c_allgather(ctx, x):
    return all_gather(x, _axis(ctx), 0)


@register_op("c_reducescatter", inputs=["X"], outputs=["Out"],
             host=_host_reason)
def _c_reducescatter(ctx, x):
    return reduce_scatter(x, _axis(ctx), 0)


@register_op("c_alltoall", inputs=["X"], outputs=["Out"], host=_host_reason)
def _c_alltoall(ctx, x):
    """all-to-all over the axis (the Ulysses building block)."""
    return all_to_all(x, _axis(ctx), 0, 0)


@register_op("c_permute", inputs=["X"], outputs=["Out"], host=_host_reason)
def _c_permute(ctx, x):
    """collective_permute (ring shift) — ring attention / pipeline p2p."""
    return permute(x, _axis(ctx), ctx.attr("shift", 1))


@register_op("c_sync_calc_stream", inputs=["X"], outputs=["Out"])
def _c_sync_calc_stream(ctx, x):
    return x


@register_op("c_sync_comm_stream", inputs=["X"], outputs=["Out"])
def _c_sync_comm_stream(ctx, x):
    return x


@register_op("c_comm_init", inputs=[], outputs=[])
def _c_comm_init(ctx):
    """c_comm_init_op.cc: the process group is the caller's
    (torch.distributed.init_process_group, parallel/env.py)."""
    return ()


@register_op("c_gen_unique_id", inputs=[], outputs=[])
def _c_gen_unique_id(ctx):
    return ()
