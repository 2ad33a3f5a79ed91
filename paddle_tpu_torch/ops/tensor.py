"""Tensor manipulation and creation ops.

Counterpart of paddle_tpu/ops/tensor.py (the reference's reshape_op,
transpose_op, concat_op, split_op, slice_op, strided_slice_op,
gather/scatter, squeeze/unsqueeze, stack, expand, pad, flatten,
fill_constant, assign, one_hot, shape, ...): all 40 op types, under the
JAX package's type and slot names.

Where PyTorch and jax.numpy differ, the op keeps jax.numpy's result:
slices with a negative stride go through an index list (PyTorch slicing
takes positive steps only), `one_hot` of an out-of-range id is a zero
row, and `where_index` pads to a static [cond.size, ndim] with -1 rows
by a stable sort rather than `nonzero`, so it also runs on meta tensors
for shape inference. Index dtypes are int64 (the declared dtype; the
JAX package narrows them to int32 with x64 off).

The index ops (`gather`, `gather_nd`, `scatter`) do not clamp: an
out-of-range id raises on the CPU and trips a device assert on the card,
where `jnp.take` / `.at[]` fill or drop it (ROADMAP Queue 3).
"""
import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import device_dtype
from paddle_tpu_torch.core.registry import constant, register_op


def _axis(ax, ndim):
    return ax + ndim if ax < 0 else ax


@register_op("reshape", inputs=["X"], outputs=["Out"])
def _reshape(ctx, x):
    """reshape_op.cc: 0 copies the input dim, -1 is inferred."""
    shape = [int(x.shape[i]) if d == 0 else int(d)
             for i, d in enumerate(ctx.attr("shape"))]
    return torch.reshape(x, shape)


@register_op("transpose", inputs=["X"], outputs=["Out"])
def _transpose(ctx, x):
    # both attr spellings appear in the IR: `axis` (transpose2 / fluid
    # layers) and `perm` (the modern paddle surface)
    perm = ctx.attr("axis", None) or ctx.attr("perm", None)
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return x.permute(*perm)


@register_op("concat", inputs=["X[]"], outputs=["Out"])
def _concat(ctx, xs):
    return torch.cat(xs, dim=ctx.attr("axis", 0))


@register_op("split", inputs=["X"], outputs=["Out[]"])
def _split(ctx, x):
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", None)
    if sections:
        return (list(torch.split(x, list(sections), dim=axis)),)
    n = ctx.attr("num")
    return (list(torch.split(x, int(x.shape[axis]) // n, dim=axis)),)


@register_op("stack", inputs=["X[]"], outputs=["Out"])
def _stack(ctx, xs):
    return torch.stack(xs, dim=ctx.attr("axis", 0))


@register_op("unstack", inputs=["X"], outputs=["Out[]"])
def _unstack(ctx, x):
    return (list(torch.unbind(x, dim=ctx.attr("axis", 0))),)


@register_op("squeeze", inputs=["X"], outputs=["Out"])
def _squeeze(ctx, x):
    axes = ctx.attr("axes", None)
    if not axes:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=tuple(axes))


@register_op("unsqueeze", inputs=["X"], outputs=["Out"])
def _unsqueeze(ctx, x):
    """jnp.expand_dims: the axes index the output's dims."""
    axes = list(ctx.attr("axes"))
    nd = x.dim() + len(axes)
    for ax in sorted(_axis(a, nd) for a in axes):
        x = x.unsqueeze(ax)
    return x


def _slice_axis(x, ax, start, stop, step):
    """x[..., start:stop:step, ...] on dim `ax`, Python's rules, any step
    sign."""
    step = 1 if step is None else int(step)
    if step > 0:
        idx = [slice(None)] * x.dim()
        idx[ax] = slice(start, stop, step)
        return x[tuple(idx)]
    rows = range(*slice(start, stop, step).indices(int(x.shape[ax])))
    return torch.index_select(x, ax, constant(list(rows), torch.int64,
                                              x.device))


@register_op("slice", inputs=["X"], outputs=["Out"])
def _slice(ctx, x):
    """slice_op.cc: python-style slicing on the given axes."""
    for ax, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                        ctx.attr("ends")):
        x = _slice_axis(x, _axis(ax, x.dim()), s, e, 1)
    return x


@register_op("strided_slice", inputs=["X"], outputs=["Out"])
def _strided_slice(ctx, x):
    for ax, s, e, st in zip(*(ctx.attr(k) for k in
                              ("axes", "starts", "ends", "strides"))):
        x = _slice_axis(x, _axis(ax, x.dim()), s, e, st)
    return x


@register_op("getitem", inputs=["X"], outputs=["Out"])
def _getitem(ctx, x):
    """Python subscript sugar on Variables: a list of ("slice", s, e,
    st) | ("int", i) | ("ellipsis",) | ("none",), applied dim by dim as
    numpy's basic indexing does."""
    spec = ctx.attr("slices")
    consumed = sum(1 for it in spec if it[0] in ("slice", "int"))
    ndim = x.dim()
    d = 0
    for item in spec:
        kind = item[0]
        if kind == "slice":
            x = _slice_axis(x, d, item[1], item[2], item[3])
            d += 1
        elif kind == "int":
            x = x.select(d, int(item[1]))
        elif kind == "ellipsis":
            d += ndim - consumed
        elif kind == "none":
            x = x.unsqueeze(d)
            d += 1
    return x


@register_op("gather", inputs=["X", "Index"], outputs=["Out"])
def _gather(ctx, x, index):
    """gather_op.cc: rows of x by a 1-D index."""
    return torch.index_select(x, 0, index.reshape(-1).long())


@register_op("gather_nd", inputs=["X", "Index"], outputs=["Out"])
def _gather_nd(ctx, x, index):
    return x[tuple(torch.unbind(index.long(), dim=-1))]


@register_op("scatter", inputs=["X", "Ids", "Updates"], outputs=["Out"])
def _scatter(ctx, x, ids, updates):
    """scatter_op.cc: overwrite (or add) rows of x at ids."""
    ids = ids.reshape(-1).long()
    return torch.index_put(x, (ids,), updates,
                           accumulate=not ctx.attr("overwrite", True))


@register_op("expand", inputs=["X"], outputs=["Out"])
def _expand(ctx, x):
    """expand_op.cc: tile by expand_times per dim."""
    return x.repeat(*ctx.attr("expand_times"))


@register_op("expand_as", inputs=["X", "Y"], outputs=["Out"])
def _expand_as(ctx, x, y):
    return torch.broadcast_to(x, tuple(y.shape))


@register_op("pad", inputs=["X"], outputs=["Out"])
def _pad(ctx, x):
    """pad_op.cc: paddings = [before0, after0, before1, after1, ...]."""
    p = list(ctx.attr("paddings"))
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return F.pad(x, flat, value=ctx.attr("pad_value", 0.0))


@register_op("pad2d", inputs=["X"], outputs=["Out"])
def _pad2d(ctx, x):
    """pad2d_op.cc: NCHW spatial padding, constant / reflect / edge."""
    t, b, l, r = ctx.attr("paddings", [0, 0, 0, 0])
    mode = ctx.attr("mode", "constant")
    if mode == "constant":
        return F.pad(x, (l, r, t, b), value=ctx.attr("pad_value", 0.0))
    return F.pad(x, (l, r, t, b),
                 mode={"reflect": "reflect", "edge": "replicate"}[mode])


def _flatten_impl(ctx, x):
    lead = 1
    for d in x.shape[:ctx.attr("axis", 1)]:
        lead *= int(d)
    return torch.reshape(x, (lead, -1))


register_op("flatten", inputs=["X"], outputs=["Out"])(_flatten_impl)
register_op("flatten2", inputs=["X"], outputs=["Out"])(_flatten_impl)


@register_op("fill_constant", inputs=[], outputs=["Out"])
def _fill_constant(ctx):
    return torch.full(tuple(ctx.attr("shape")), ctx.attr("value", 0.0),
                      dtype=device_dtype(ctx.attr("dtype", "float32")),
                      device=ctx.device)


@register_op("fill_constant_batch_size_like", inputs=["Input"],
             outputs=["Out"])
def _fill_constant_batch_size_like(ctx, ref):
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = int(
        ref.shape[ctx.attr("input_dim_idx", 0)])
    return torch.full(tuple(shape), ctx.attr("value", 0.0),
                      dtype=device_dtype(ctx.attr("dtype", "float32")),
                      device=ref.device)


@register_op("assign", inputs=["X"], outputs=["Out"])
def _assign(ctx, x):
    return x


@register_op("zeros_like", inputs=["X"], outputs=["Out"])
def _zeros_like(ctx, x):
    """Exact constants even for non-finite inputs (0*inf would be NaN)."""
    return torch.zeros_like(x)


@register_op("ones_like", inputs=["X"], outputs=["Out"])
def _ones_like(ctx, x):
    return torch.ones_like(x)


@register_op("fill_any_like", inputs=["X"], outputs=["Out"])
def _fill_any_like(ctx, x):
    """fill_any_like_op.cc: a constant tensor shaped like X, with an
    optional dtype override."""
    dtype = ctx.attr("dtype", None)
    dt = device_dtype(dtype) if dtype not in (None, -1) else x.dtype
    return torch.full(tuple(x.shape), ctx.attr("value", 0.0), dtype=dt,
                      device=x.device)


@register_op("assign_value", inputs=[], outputs=["Out"])
def _assign_value(ctx):
    dtype = device_dtype(ctx.attr("dtype", "float32"))
    shape = tuple(ctx.attr("shape"))
    if ctx.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return constant(np.asarray(ctx.attr("values")), dtype,
                    ctx.device).reshape(shape)


@register_op("shape", inputs=["Input"], outputs=["Out"])
def _shape(ctx, x):
    return constant([int(d) for d in x.shape], torch.int32, x.device)


@register_op("one_hot", inputs=["X"], outputs=["Out"])
def _one_hot(ctx, x):
    """jax.nn.one_hot: an id outside [0, depth) gives a zero row."""
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(tuple(x.shape[:-1]))
    classes = torch.arange(ctx.attr("depth"), device=x.device)
    return (x.long().unsqueeze(-1) == classes).to(torch.float32)


@register_op("range", inputs=[], outputs=["Out"])
def _range(ctx):
    return torch.arange(ctx.attr("start", 0), ctx.attr("end"),
                        ctx.attr("step", 1),
                        dtype=device_dtype(ctx.attr("dtype", "int64")),
                        device=ctx.device)


@register_op("linspace", inputs=[], outputs=["Out"])
def _linspace(ctx):
    return torch.linspace(ctx.attr("start"), ctx.attr("stop"),
                          ctx.attr("num"),
                          dtype=device_dtype(ctx.attr("dtype", "float32")),
                          device=ctx.device)


@register_op("where", inputs=["Condition", "X", "Y"], outputs=["Out"])
def _where(ctx, cond, x, y):
    return torch.where(cond.bool(), x, y)


@register_op("where_index", inputs=["Condition"], outputs=["Out"])
def _where_index(ctx, cond):
    """where_index_op.cc (fluid layers.where(cond)): the indices of the
    true elements, row-major, in a static [cond.size, ndim] padded with
    -1 rows."""
    n = cond.numel()
    flat = cond.reshape(-1).bool()
    pos = torch.arange(n, dtype=torch.int64, device=cond.device)
    # true positions first, in order: a stable sort on (not true, position)
    key = torch.where(flat, pos, pos + n)
    order = torch.sort(key, stable=True).values
    valid = order < n
    order = torch.where(valid, order, torch.zeros_like(order))
    cols = []
    stride = 1
    for size in reversed([int(d) for d in cond.shape]):
        cols.append((order // stride) % size)
        stride *= size
    idx = torch.stack(cols[::-1], dim=-1) if cols else \
        torch.zeros((n, 0), dtype=torch.int64, device=cond.device)
    return torch.where(valid.unsqueeze(-1), idx, torch.full_like(idx, -1))


@register_op("tril_triu", inputs=["X"], outputs=["Out"])
def _tril_triu(ctx, x):
    k = ctx.attr("diagonal", 0)
    return torch.tril(x, k) if ctx.attr("lower", True) else torch.triu(x, k)


@register_op("diag", inputs=["Diagonal"], outputs=["Out"])
def _diag(ctx, d):
    return torch.diag(d)


@register_op("eye", inputs=[], outputs=["Out"])
def _eye(ctx):
    return torch.eye(ctx.attr("num_rows"), ctx.attr("num_columns"),
                     dtype=device_dtype(ctx.attr("dtype", "float32")),
                     device=ctx.device)


@register_op("flip", inputs=["X"], outputs=["Out"])
def _flip(ctx, x):
    return torch.flip(x, dims=tuple(ctx.attr("dims")))


@register_op("roll", inputs=["X"], outputs=["Out"])
def _roll(ctx, x):
    """jnp.roll over `dims`; one int shift applies to each of them."""
    dims = list(ctx.attr("dims"))
    shifts = ctx.attr("shifts")
    if isinstance(shifts, int):
        shifts = [shifts] * len(dims)
    return torch.roll(x, shifts=list(shifts), dims=dims)


@register_op("meshgrid", inputs=["X[]"], outputs=["Out[]"])
def _meshgrid(ctx, xs):
    return (list(torch.meshgrid(*xs, indexing="ij")),)


@register_op("increment", inputs=["X"], outputs=["Out"])
def _increment(ctx, x):
    """increment_op.cc, the loop and step counter. Out names X in the
    IR, so the step rebinds the persistable var (the LR counter) and the
    executor writes it back to the scope every run."""
    return x + ctx.attr("step", 1.0)
