"""Static resource planner, the memory half: a program's peak memory
predicted from the Program graph alone, before any capture.

Counterpart of paddle_tpu/analysis/planner.py (the reference decides
buffer reuse statically in its memory-optimize transpilers):

* **liveness peak-memory estimator** (`estimate_peak_memory`) — a
  forward dataflow over block 0 over the verifier's liveness machinery
  (`consumer_map` / `feedable_names`): per-op live sets sized from
  declared shapes and dtypes (`-1` batch dims resolved by the caller's
  batch size), persistable rebinds modeled as in-place writes (zero new
  bytes), fetch targets pinned live to the end. Reports the peak and the
  op at the high-water mark; the same bytes as the JAX package's on the
  same program.
* **the fit gate** (`plan_program(...).fit_diagnostic()`) — the
  model-does-not-fit ERROR `InferenceServer` and `ModelRegistry.deploy`
  abort on when the largest bucket's estimate exceeds the budget.
* **decode-rung geometry** (`estimate_decode_rungs`,
  `estimate_paged_rungs`) for the generation engines, which have no
  Program.
* **the ledger cross-check** (`register_static_estimate` /
  `cross_check`): each registered estimate against the newest measured
  peak the CompileLedger holds for its (scope, key). On the card that is
  a capture's `peak_bytes` (`CompileRecord.memory`: the growth of
  `torch.cuda.max_memory_allocated` over the capture), which the
  serving pool registers `MemoryEstimate.capture_peak_bytes()` against:
  the bytes a captured graph allocates in its pool. The parameters are
  bound and the feeds sit in static buffers made before the capture;
  every value a segment computes is one of the graph's outputs and
  lives as long as the graph (core/lowering.py keeps a segment's
  values until it ends), so the graph holds them all at once: the
  estimate is the sum of the block's intermediates, not the liveness
  peak.

`plan_fusion_discount` (PT_FLAGS_plan_fusion_discount) is the share of
the intermediate transient an estimate charges. The JAX package's 0.25
was calibrated against XLA's fused executables; a captured graph fuses
nothing, so the port charges all of it (1.0). Callers that must match
the JAX package pass the discount explicitly.

The sharding half is the JAX package's, rule for rule:

* **sharding propagation** (`propagate_shardings`) seeds per-param and
  per-feed specs from declared `VarDesc.sharding`, a `MeshSpec` or a
  strategy's `mesh_axes`, pushes them through op semantics (elementwise,
  matmul contraction, reshape/transpose, batch-preserving ops, reductions,
  `moe_switch`) and flags `axis-mismatch`, `reshard-on-hot-path`,
  `replicated-large-param` (PT_FLAGS_plan_large_param_mb) and
  `unshardable-op`. Its `CollectiveEvent`s are what the port's
  data-parallel step reads to combine a reduction over the batch across
  ranks and to tell a batch-sharded fetch from a replicated one
  (parallel/compiler.py).
* **communication-cost model** (`price_collectives`): ring / all-to-all
  transfer bytes per device at PT_FLAGS_plan_link_gbps GB/s per link.
* `plan_program(..., mesh=...)` and `PlannerPass` run all three.
"""
import math

import torch

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.analysis.diagnostic import Diagnostic, Severity
from paddle_tpu_torch.analysis.framework import Pass, register_pass
from paddle_tpu_torch.analysis.verifier import consumer_map, feedable_names
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import enforce

__all__ = ["PLANNER_PASSES", "MeshSpec", "MemoryEstimate", "ResourcePlan",
           "dtype_bytes", "var_bytes", "estimate_peak_memory",
           "plan_program", "propagate_shardings", "price_collectives",
           "PlannerPass", "estimate_decode_rungs", "estimate_paged_rungs",
           "register_static_estimate", "clear_static_estimates",
           "registered_estimates", "cross_check", "cross_check_section"]

PLANNER_PASSES = ("plan_resources",)

PASS_NAME = "plan_resources"

def _human(nbytes):
    if nbytes is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(nbytes) < 1024.0 or unit == "GiB":
            return (f"{nbytes:.0f}{unit}" if unit == "B"
                    else f"{nbytes:.2f}{unit}")
        nbytes /= 1024.0


class MeshSpec:
    """Named device mesh: ordered {axis name: size}, parsed from a
    "dp:2,tp:4" string, a dict, a strategy's `mesh_axes`, a
    parallel.env.Mesh or another MeshSpec."""

    __slots__ = ("axes",)

    def __init__(self, axes=None):
        self.axes = {}
        for k, v in dict(axes or {}).items():
            size = int(v)
            enforce(size >= 1, "mesh axis %r must have size >= 1, got %s",
                    k, v)
            self.axes[str(k)] = size

    @classmethod
    def parse(cls, spec):
        if spec is None or isinstance(spec, cls):
            return spec if spec is not None else cls()
        if isinstance(spec, dict):
            return cls(spec)
        mesh_axes = getattr(spec, "mesh_axes", None)
        if mesh_axes is not None:
            return cls(mesh_axes)
        if isinstance(getattr(spec, "shape", None), dict):   # env.Mesh
            return cls(spec.shape)
        enforce(isinstance(spec, str),
                "cannot parse mesh spec from %r", spec)
        axes = {}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            enforce(":" in part or "=" in part,
                    "mesh axis %r must look like name:size", part)
            name, _, size = part.replace("=", ":").partition(":")
            axes[name.strip()] = int(size)
        return cls(axes)

    def has_axis(self, axis):
        return axis in self.axes

    def size(self, axis):
        return self.axes.get(axis, 1)

    def batch_axis(self):
        """The axis feeds are sharded over by default: `dp` when
        present, else the first declared axis."""
        if "dp" in self.axes:
            return "dp"
        return next(iter(self.axes), None)

    def total(self):
        n = 1
        for s in self.axes.values():
            n *= s
        return n

    def shard_factor(self, sharding):
        f = 1
        for ax in sharding or ():
            if ax:
                f *= self.size(ax)
        return f

    def describe(self):
        if not self.axes:
            return "single-device"
        return ",".join(f"{k}:{v}" for k, v in self.axes.items())

    def __repr__(self):
        return f"MeshSpec({self.describe()})"


# ---------------------------------------------------------------------------
# var sizing
# ---------------------------------------------------------------------------

def dtype_bytes(dtype):
    """Bytes per element of a declared dtype (a torch dtype or a name);
    4 for one the port does not know."""
    try:
        return int(_dt.normalize_dtype(dtype).itemsize)
    except (KeyError, TypeError, ValueError, AttributeError):
        return 4


def var_bytes(desc, batch_size=1, mesh=None, sharding=None):
    """Declared size of one VarDesc in bytes: `-1` dims resolve to
    `batch_size`, sharded dims divide by the mesh axis size. None when
    the desc declares no shape (a planner blind spot)."""
    if desc is None or desc.shape is None:
        return None
    n = 1
    for d in desc.shape:
        n *= int(batch_size) if d == -1 else int(d)
    n *= dtype_bytes(desc.dtype if desc.dtype is not None
                     else torch.float32)
    spec = sharding if sharding is not None else desc.sharding
    if mesh is not None and spec:
        n = int(math.ceil(n / mesh.shard_factor(spec)))
    return n


# ---------------------------------------------------------------------------
# liveness peak-memory estimator
# ---------------------------------------------------------------------------

def _discount(fusion_discount):
    if fusion_discount is None:
        return float(_flags.get_flag("plan_fusion_discount"))
    return float(fusion_discount)


class MemoryEstimate:
    """Static memory plan for one Program at one batch size.

    `residency_peak_bytes` is the pure liveness model (everything the
    graph materializes at the high-water op). `step_peak_bytes()` prices
    the JAX package's executable convention (arguments + outputs −
    donated state + a discounted share of the intermediate transient)
    and is what the fit gate compares with a budget, as there.
    `capture_peak_bytes()` is what a captured graph of the step
    allocates in its pool: every intermediate the block makes
    (`intermediates_total_bytes`, the fetches included), discounted;
    parameters are bound in the graph and the feeds sit in static
    buffers made before the capture."""

    __slots__ = ("params_bytes", "feeds_bytes", "fetch_bytes",
                 "intermediates_peak_bytes", "stash_bytes", "batch_size",
                 "high_water_op_index", "high_water_op_type",
                 "unsized_vars", "intermediates_total_bytes")

    def __init__(self, params_bytes=0, feeds_bytes=0, fetch_bytes=0,
                 intermediates_peak_bytes=0, stash_bytes=0, batch_size=1,
                 high_water_op_index=None, high_water_op_type=None,
                 unsized_vars=(), intermediates_total_bytes=0):
        self.params_bytes = int(params_bytes)
        self.feeds_bytes = int(feeds_bytes)
        self.fetch_bytes = int(fetch_bytes)
        self.intermediates_peak_bytes = int(intermediates_peak_bytes)
        self.stash_bytes = int(stash_bytes)
        self.batch_size = int(batch_size)
        self.high_water_op_index = high_water_op_index
        self.high_water_op_type = high_water_op_type
        self.unsized_vars = tuple(unsized_vars)
        self.intermediates_total_bytes = int(intermediates_total_bytes)

    @property
    def residency_peak_bytes(self):
        return (self.params_bytes + self.feeds_bytes + self.stash_bytes
                + self.intermediates_peak_bytes)

    def step_peak_bytes(self, donate_state=False, fusion_discount=None):
        """The JAX package's step peak: inference steps round-trip the
        state (parameters counted twice), training steps donate it."""
        args = self.params_bytes + self.feeds_bytes
        outs = self.fetch_bytes + (0 if donate_state
                                   else self.params_bytes)
        inter = max(self.intermediates_peak_bytes - self.fetch_bytes, 0)
        return int(args + outs + self.stash_bytes
                   + _discount(fusion_discount) * inter)

    def capture_peak_bytes(self, fusion_discount=None):
        """The bytes a captured graph of the step allocates: every
        intermediate of the block, discounted."""
        return int(_discount(fusion_discount)
                   * self.intermediates_total_bytes)

    def high_water(self):
        if self.high_water_op_index is None:
            return "program"
        return (f"op[{self.high_water_op_index}] "
                f"{self.high_water_op_type or '?'}")

    def to_dict(self):
        return {
            "params_bytes": self.params_bytes,
            "feeds_bytes": self.feeds_bytes,
            "fetch_bytes": self.fetch_bytes,
            "intermediates_peak_bytes": self.intermediates_peak_bytes,
            "intermediates_total_bytes": self.intermediates_total_bytes,
            "stash_bytes": self.stash_bytes,
            "batch_size": self.batch_size,
            "residency_peak_bytes": self.residency_peak_bytes,
            "step_peak_bytes": self.step_peak_bytes(),
            "capture_peak_bytes": self.capture_peak_bytes(),
            "high_water_op_index": self.high_water_op_index,
            "high_water_op_type": self.high_water_op_type,
            "unsized_vars": list(self.unsized_vars),
        }


def estimate_peak_memory(program, batch_size=1, mesh=None,
                         shardings=None, stash_bytes=0):
    """Forward liveness walk over block 0: the initial env (persistable
    state + data/feeds) is the baseline; each op transiently holds its
    inputs AND its freshly-materialized outputs; an intermediate dies
    after its last reader (fetch targets and names carried into
    sub-blocks stay live to the end). Persistable rebinds add zero new
    bytes."""
    mesh = MeshSpec.parse(mesh)
    shardings = shardings or {}
    block = program.global_block()
    env0 = feedable_names(program)
    fetches = set(program.meta.get("fetch_targets", []))
    feeds = set(program.meta.get("feed_targets", []))

    def _desc(name):
        return block.var(name).desc if block.has_var(name) else None

    def _bytes(name):
        return var_bytes(_desc(name), batch_size, mesh,
                         shardings.get(name))

    params_bytes = feeds_bytes = 0
    unsized = []
    for name in sorted(env0):
        d = _desc(name)
        b = _bytes(name)
        if b is None:
            unsized.append(name)
            continue
        if d is not None and (d.is_data or name in feeds) \
                and not d.persistable:
            feeds_bytes += b
        else:
            params_bytes += b

    # names read by any op OUTSIDE block 0 (or carried into sub-blocks)
    # stay live across the whole block-0 walk
    pinned = set(fetches)
    readers = consumer_map(program)
    last_use = {}
    for name, sites in readers.items():
        for b_idx, op_idx in sites:
            if b_idx != 0:
                pinned.add(name)
            else:
                last_use[name] = max(last_use.get(name, -1), op_idx)
    for op in block.ops:
        for attr in ("carry_vars", "x_vars", "y_vars", "input_vars",
                     "output_vars", "cond_var"):
            v = op.attrs.get(attr)
            if isinstance(v, str):
                pinned.add(v)
            elif isinstance(v, (list, tuple)):
                pinned.update(v)

    live = {}            # intermediate name -> bytes
    inter_peak = inter_total = 0
    hw_idx = hw_type = None
    fetch_bytes = 0
    for i, op in enumerate(block.ops):
        fresh = {}
        for name in op.output_names():
            if name in env0 or name in live:
                continue     # persistable rebind / already materialized
            b = _bytes(name)
            if b is None:
                if name not in unsized:
                    unsized.append(name)
                continue
            fresh[name] = b
        inter_total += sum(fresh.values())
        transient = sum(live.values()) + sum(fresh.values())
        if transient > inter_peak:
            inter_peak = transient
            hw_idx, hw_type = i, op.type
        live.update(fresh)
        for name in list(live):
            if name in pinned:
                continue
            if last_use.get(name, -1) <= i:
                del live[name]
    for name in fetches:
        b = _bytes(name)
        if b is not None:
            fetch_bytes += b

    return MemoryEstimate(
        params_bytes=params_bytes, feeds_bytes=feeds_bytes,
        fetch_bytes=fetch_bytes, intermediates_peak_bytes=inter_peak,
        stash_bytes=stash_bytes, batch_size=batch_size,
        high_water_op_index=hw_idx, high_water_op_type=hw_type,
        unsized_vars=unsized, intermediates_total_bytes=inter_total)


# ---------------------------------------------------------------------------
# sharding propagation
# ---------------------------------------------------------------------------

class CollectiveEvent:
    """One implied collective: what moves, how much, over which axis."""

    __slots__ = ("kind", "payload_bytes", "axis", "op_index", "op_type",
                 "var")

    def __init__(self, kind, payload_bytes, axis, op_index=None,
                 op_type=None, var=None):
        self.kind = kind                  # all_reduce/all_gather/
        self.payload_bytes = int(payload_bytes)   # reduce_scatter/all_to_all
        self.axis = axis
        self.op_index = op_index
        self.op_type = op_type
        self.var = var

    def to_dict(self):
        return {"kind": self.kind, "payload_bytes": self.payload_bytes,
                "axis": self.axis, "op_index": self.op_index,
                "op_type": self.op_type, "var": self.var}


#: ops whose single output carries its single data input's spec verbatim
_ELEMENTWISE_UNARY = frozenset({
    "relu", "relu6", "leaky_relu", "elu", "gelu", "tanh", "sigmoid",
    "hard_sigmoid", "hard_swish", "swish", "logsigmoid", "exp", "log",
    "sqrt", "rsqrt", "square", "abs", "floor", "ceil", "round", "sign",
    "pow", "scale", "cast", "clip", "dropout", "assign", "relu_",
    "increment", "softsign", "softplus", "stanh", "brelu", "cos", "sin",
})

#: binary broadcasting ops: output spec joins both inputs
_ELEMENTWISE_BINARY = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod",
})

_MATMUL_OPS = frozenset({"mul", "matmul", "matmul_v2"})

_RESHAPE_OPS = frozenset({"reshape", "reshape2", "flatten", "flatten2",
                          "squeeze", "squeeze2", "unsqueeze",
                          "unsqueeze2"})

_TRANSPOSE_OPS = frozenset({"transpose", "transpose2"})

#: structured ops that keep the batch (leading) dim and operate within
#: each example — dim-0 sharding flows through, other dims replicate
_BATCH_PRESERVING = frozenset({
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "pool2d",
    "max_pool2d_with_index", "batch_norm", "sync_batch_norm",
    "layer_norm", "instance_norm", "group_norm", "softmax",
    "log_softmax", "lrn", "pad", "pad2d", "prelu", "data_norm",
    "cross_entropy", "softmax_with_cross_entropy", "one_hot",
    "lookup_table", "embedding", "accuracy", "top_k", "arg_max",
})

_REDUCE_OPS = frozenset({"reduce_sum", "reduce_mean", "reduce_max",
                         "reduce_min", "reduce_prod", "mean"})


def _first(op, slot):
    names = op.inputs.get(slot) or []
    return names[0] if names else None


def _join_specs(a, b):
    """Elementwise join of two equal-rank specs; None on conflict."""
    out = []
    for x, y in zip(a, b):
        if x and y and x != y:
            return None
        out.append(x or y)
    return tuple(out)


def propagate_shardings(program, mesh, batch_size=1,
                        large_param_bytes=None):
    """Seed + propagate sharding specs over block 0.

    Returns (specs, hazards, events): `specs` maps var name → a
    PartitionSpec-like tuple (axis name or None per dim), `hazards` are
    ready Diagnostics, `events` the implied CollectiveEvents for
    `price_collectives`. Seeds come from declared `VarDesc.sharding`
    first; feeds with no declared spec default to batch-dim sharding
    over the mesh's batch axis. With a trivial mesh (total size 1) the
    walk still validates declared specs but prices nothing.
    """
    mesh = MeshSpec.parse(mesh)
    if large_param_bytes is None:
        large_param_bytes = int(float(
            _flags.get_flag("plan_large_param_mb")) * (1 << 20))
    block = program.global_block()
    env0 = feedable_names(program)
    feeds = set(program.meta.get("feed_targets", []))
    nontrivial = mesh.total() > 1
    batch_axis = mesh.batch_axis()
    specs, hazards, events = {}, [], []

    def _desc(name):
        return block.var(name).desc if block.has_var(name) else None

    def _rank(name):
        d = _desc(name)
        return len(d.shape) if d is not None and d.shape is not None \
            else None

    def _nbytes(name):
        return var_bytes(_desc(name), batch_size, mesh,
                         specs.get(name))

    def _spec(name):
        s = specs.get(name)
        if s is not None:
            return s
        r = _rank(name)
        return (None,) * r if r is not None else None

    def _haz(code, severity, message, **kw):
        kw.setdefault("pass_name", PASS_NAME)
        hazards.append(Diagnostic(code, severity, message, block_idx=0,
                                  **kw))

    def _gather_to_replicated(name, i, op):
        """Pessimistic reshard: all-gather `name` to replicated."""
        s = specs.get(name)
        if not s or not any(s):
            return
        b = _nbytes(name)
        if b:
            events.append(CollectiveEvent(
                "all_gather", b,
                next(ax for ax in s if ax), op_index=i,
                op_type=op.type, var=name))
        specs[name] = (None,) * len(s)

    # -- seeds ---------------------------------------------------------
    for name in sorted(env0):
        d = _desc(name)
        if d is None or d.shape is None:
            continue
        rank = len(d.shape)
        if d.sharding:
            spec = tuple(d.sharding) + (None,) * (rank - len(d.sharding))
            bad = [ax for ax in spec if ax and not mesh.has_axis(ax)]
            if bad:
                _haz("axis-mismatch", Severity.ERROR,
                     f"declared sharding {tuple(d.sharding)} names mesh "
                     f"axes {bad} absent from mesh "
                     f"({mesh.describe()})", var=name,
                     hint="fix VarDesc.sharding or extend the mesh")
                spec = (None,) * rank
            specs[name] = spec
        elif (d.is_data or name in feeds) and not d.persistable \
                and nontrivial and batch_axis and rank >= 1:
            # default data-parallel seed: shard the batch dim
            specs[name] = (batch_axis,) + (None,) * (rank - 1)
        else:
            specs[name] = (None,) * rank
        if d.is_parameter and nontrivial and not any(specs[name]):
            b = var_bytes(d, batch_size)
            if b is not None and b > large_param_bytes:
                _haz("replicated-large-param", Severity.WARNING,
                     f"parameter is replicated on every device "
                     f"({_human(b)} × {mesh.total()} devices, threshold "
                     f"{_human(large_param_bytes)})", var=name,
                     hint="declare VarDesc.sharding over a mesh axis "
                          "(tp/ep) or raise PT_FLAGS_plan_large_param_mb")

    # -- per-op propagation --------------------------------------------
    for i, op in enumerate(block.ops):
        in_names = [n for n in op.input_names()]
        sharded_in = [n for n in in_names
                      if specs.get(n) and any(specs[n])]
        out_names = op.output_names()

        def _set_outputs(spec_fn):
            for n in out_names:
                r = _rank(n)
                if r is None:
                    specs[n] = None
                    continue
                s = spec_fn(n, r)
                if s is None:
                    s = (None,) * r
                specs[n] = tuple(s[:r]) + (None,) * (r - len(s))

        if op.type in _MATMUL_OPS:
            x, y = _first(op, "X"), _first(op, "Y")
            sx, sy = _spec(x) or (), _spec(y) or ()
            cx = sx[-1] if sx else None      # x's contraction dim
            cy = sy[0] if sy else None       # y's contraction dim
            out = tuple(sx[:-1]) + ((sy[-1] if sy else None),)
            if cx and cy and cx != cy:
                _haz("axis-mismatch", Severity.ERROR,
                     f"contraction dims are sharded on different mesh "
                     f"axes ({x}:{cx} vs {y}:{cy}) — the matmul cannot "
                     f"be partitioned", op_index=i, op_type=op.type,
                     hint="align both operands' contraction sharding")
            elif cx and cy:
                # sharded contraction: partial results all-reduce
                o = out_names[0] if out_names else None
                b = _nbytes(o) if o else 0
                if b:
                    events.append(CollectiveEvent(
                        "all_reduce", b, cx, op_index=i,
                        op_type=op.type, var=o))
            elif cx or cy:
                # one side sharded on the contraction dim: the other is
                # replicated there, so the sharded side reduces locally
                # then all-reduces nothing — but the OUTPUT inherits a
                # partial sum; price an all-reduce of the output
                o = out_names[0] if out_names else None
                b = _nbytes(o) if o else 0
                if b:
                    events.append(CollectiveEvent(
                        "all_reduce", b, cx or cy, op_index=i,
                        op_type=op.type, var=o))
            _set_outputs(lambda n, r: out)
        elif op.type in _ELEMENTWISE_BINARY:
            x, y = _first(op, "X"), _first(op, "Y")
            sx, sy = _spec(x), _spec(y)
            if sx is None or sy is None:
                _set_outputs(lambda n, r: sx or sy or (None,) * r)
            elif len(sx) == len(sy):
                j = _join_specs(sx, sy)
                if j is None:
                    _haz("axis-mismatch", Severity.ERROR,
                         f"operands {x!r} and {y!r} are sharded on "
                         f"different axes per dim ({sx} vs {sy})",
                         op_index=i, op_type=op.type)
                    j = (None,) * len(sx)
                _set_outputs(lambda n, r: j)
            else:
                # broadcasting add (bias): the smaller operand aligns to
                # the larger's trailing dims; output follows the larger
                big = sx if len(sx) >= len(sy) else sy
                _set_outputs(lambda n, r: big)
        elif op.type in _ELEMENTWISE_UNARY:
            x = _first(op, "X") or (in_names[0] if in_names else None)
            s = _spec(x) if x else None
            _set_outputs(lambda n, r: s or (None,) * r)
        elif op.type in _TRANSPOSE_OPS:
            x = _first(op, "X")
            s = _spec(x)
            perm = op.attrs.get("perm") or op.attrs.get("axis")
            if s is not None and perm:
                out = tuple(s[p] for p in perm)
                _set_outputs(lambda n, r: out)
            else:
                _set_outputs(lambda n, r: (None,) * r)
        elif op.type in _RESHAPE_OPS:
            x = _first(op, "X")
            s = _spec(x) or ()
            dx = _desc(x)
            lead = s[0] if s else None
            inner = [ax for ax in s[1:] if ax]
            if inner:
                _haz("reshard-on-hot-path", Severity.WARNING,
                     f"reshape of a tensor sharded on inner dims "
                     f"({s}) implies an all-gather inside the step",
                     op_index=i, op_type=op.type, var=x,
                     hint="reshape before sharding, or shard only the "
                          "batch dim across reshapes")
                _gather_to_replicated(x, i, op)
                lead = specs[x][0] if specs.get(x) else None
            # leading (batch) dim survives when the reshape keeps it
            keeps_lead = False
            for n in out_names:
                do = _desc(n)
                if dx is not None and do is not None and dx.shape and \
                        do.shape and dx.shape[0] == do.shape[0]:
                    keeps_lead = True
            _set_outputs(lambda n, r:
                         ((lead,) + (None,) * (r - 1))
                         if keeps_lead else (None,) * r)
        elif op.type in _REDUCE_OPS:
            x = _first(op, "X") or (in_names[0] if in_names else None)
            s = _spec(x) if x else None
            dims = op.attrs.get("dim")
            if op.type == "mean" or dims is None:
                dims = list(range(len(s))) if s else []
            elif isinstance(dims, int):
                dims = [dims]
            reduced_axes = sorted({s[d] for d in dims
                                   if s and -len(s) <= d < len(s)
                                   and s[d]})
            if reduced_axes and out_names:
                b = _nbytes(out_names[0]) or dtype_bytes("float32")
                for ax in reduced_axes:
                    events.append(CollectiveEvent(
                        "all_reduce", b, ax, op_index=i,
                        op_type=op.type, var=out_names[0]))
            keep = op.attrs.get("keep_dim", False)
            if s is None:
                _set_outputs(lambda n, r: (None,) * r)
            elif keep:
                out = tuple(None if d in dims else ax
                            for d, ax in enumerate(s))
                _set_outputs(lambda n, r: out)
            else:
                out = tuple(ax for d, ax in enumerate(s)
                            if d not in dims)
                _set_outputs(lambda n, r: out)
        elif op.type == "moe_switch":
            _moe_rule(op, i, specs, events, hazards, mesh, _spec,
                      _desc, _nbytes, batch_size)
            _set_outputs(lambda n, r: (_spec(_first(op, "X")) or
                                       (None,) * r) if r > 1
                         else (None,) * r)
        elif op.type in _BATCH_PRESERVING or (
                sharded_in and all(
                    (specs.get(n) and specs[n][0] and
                     not any(specs[n][1:])) or not any(specs.get(n) or ())
                    for n in in_names if specs.get(n) is not None)):
            # structured-but-per-example op, or the generic heuristic:
            # everything sharded here is sharded ONLY on the batch dim
            # and the op keeps a leading batch dim — let dim-0 flow
            lead = None
            for n in in_names:
                s = specs.get(n)
                if s and s[0]:
                    lead = s[0]
                    break
            bad = [n for n in in_names
                   if specs.get(n) and any(specs[n][1:])]
            if bad and op.type in _BATCH_PRESERVING:
                _haz("reshard-on-hot-path", Severity.WARNING,
                     f"{op.type} input(s) {bad} sharded on non-batch "
                     f"dims imply a gather before the op",
                     op_index=i, op_type=op.type)
                for n in bad:
                    _gather_to_replicated(n, i, op)
            _set_outputs(lambda n, r:
                         (lead,) + (None,) * (r - 1) if r >= 1 else ())
        else:
            # unknown semantics with sharded inputs: the planner cannot
            # place it — gather everything, replicate the outputs
            if sharded_in:
                _haz("unshardable-op", Severity.INFO,
                     f"no sharding rule for op {op.type!r} with sharded "
                     f"inputs {sharded_in} — planning an all-gather to "
                     f"replicated (pessimistic)",
                     op_index=i, op_type=op.type,
                     hint="add a rule to analysis/planner.py or attach "
                          "sharding metadata to the op")
                for n in sharded_in:
                    _gather_to_replicated(n, i, op)
            _set_outputs(lambda n, r: (None,) * r)

    # any event inside the step body is, by definition, on the hot path
    if events and nontrivial:
        kinds = {}
        for ev in events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        summary = ", ".join(f"{v}×{k}" for k, v in sorted(kinds.items()))
        _haz("reshard-on-hot-path", Severity.WARNING,
             f"step graph implies {len(events)} collective(s) "
             f"({summary}) — every one is paid per step",
             hint="fold collectives into the parallel plan "
                  "(DistributedStrategy) or accept the comms budget")
    return specs, hazards, events


def _moe_rule(op, i, specs, events, hazards, mesh, _spec, _desc,
              _nbytes, batch_size):
    """Price the Switch-MoE dispatch: tokens [N,D] route into expert
    slices [E,C,D] sharded over the expert axis — one all-to-all in,
    one all-to-all back (parallel/moe.py's GSPMD layout)."""
    ep_axis = op.attrs.get("expert_axis", "ep")
    x = _first(op, "X")
    gw = _first(op, "GateW")
    dx, dg = _desc(x), _desc(gw)
    if dx is None or dx.shape is None or dg is None or dg.shape is None:
        return
    n_dim = dx.shape[0]
    n_tok = int(batch_size) if n_dim == -1 else int(n_dim)
    d_model = int(dx.shape[-1])
    n_experts = int(dg.shape[-1])
    cap = op.attrs.get("capacity")
    if cap is None:
        cf = float(op.attrs.get("capacity_factor", 1.25))
        cap = int(max(1, (n_tok * cf) // max(n_experts, 1)))
    payload = (n_experts * int(cap) * d_model
               * dtype_bytes(dx.dtype or "float32"))
    if mesh.has_axis(ep_axis) and mesh.size(ep_axis) > 1:
        for _ in range(2):   # dispatch + combine
            events.append(CollectiveEvent(
                "all_to_all", payload, ep_axis, op_index=i,
                op_type=op.type, var=x))
    elif mesh.total() > 1:
        hazards.append(Diagnostic(
            "axis-mismatch", Severity.ERROR,
            f"moe_switch routes over expert axis {ep_axis!r} which is "
            f"not in the mesh ({mesh.describe()})", block_idx=0,
            op_index=i, op_type=op.type,
            hint="add the expert axis to the mesh or set the op's "
                 "expert_axis attr", pass_name=PASS_NAME))


# ---------------------------------------------------------------------------
# communication-cost model
# ---------------------------------------------------------------------------

def price_collectives(events, mesh, link_gbps=None):
    """Ring / all-to-all transfer model: on an n-way ring an all-gather
    or reduce-scatter moves b·(n-1)/n bytes per device, an all-reduce
    2·b·(n-1)/n (reduce-scatter + all-gather), and an all-to-all
    exchanges b·(n-1)/n. Seconds assume `link_gbps` GB/s per link
    (PT_FLAGS_plan_link_gbps)."""
    mesh = MeshSpec.parse(mesh)
    if link_gbps is None:
        link_gbps = float(_flags.get_flag("plan_link_gbps"))
    priced = []
    total_payload = wire = 0
    for ev in events:
        n = mesh.size(ev.axis)
        frac = (n - 1) / n if n > 1 else 0.0
        factor = 2.0 if ev.kind == "all_reduce" else 1.0
        w = int(ev.payload_bytes * frac * factor)
        total_payload += ev.payload_bytes
        wire += w
        d = ev.to_dict()
        d["participants"] = n
        d["wire_bytes"] = w
        priced.append(d)
    seconds = wire / (link_gbps * 1e9) if link_gbps > 0 else 0.0
    return {
        "events": priced,
        "count": len(priced),
        "total_payload_bytes": total_payload,
        "wire_bytes": wire,
        "step_seconds": seconds,
        "link_gbps": link_gbps,
    }


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class ResourcePlan:
    """plan_program's result: memory estimate + shardings + hazards +
    priced comms, renderable as Diagnostics or JSON."""

    __slots__ = ("memory", "shardings", "hazards", "comms", "mesh",
                 "batch_size", "hbm_budget_bytes")

    def __init__(self, memory, shardings, hazards, comms, mesh,
                 batch_size, hbm_budget_bytes=None):
        self.memory = memory
        self.shardings = shardings
        self.hazards = list(hazards)
        self.comms = comms
        self.mesh = mesh
        self.batch_size = batch_size
        self.hbm_budget_bytes = hbm_budget_bytes

    def fits(self):
        if not self.hbm_budget_bytes:
            return True
        return self.memory.step_peak_bytes() <= self.hbm_budget_bytes

    def fit_diagnostic(self):
        """The ERROR the deploy gate aborts with, or None when the
        estimate fits (or no budget was given)."""
        if self.fits():
            return None
        est = self.memory.step_peak_bytes()
        return Diagnostic(
            "model-does-not-fit", Severity.ERROR,
            f"static peak-memory estimate {_human(est)} exceeds the "
            f"device HBM budget {_human(self.hbm_budget_bytes)} at "
            f"batch {self.batch_size} (high-water mark at "
            f"{self.memory.high_water()}, params "
            f"{_human(self.memory.params_bytes)}, mesh "
            f"{self.mesh.describe()})",
            block_idx=0, op_index=self.memory.high_water_op_index,
            op_type=self.memory.high_water_op_type,
            hint="shard the parameters over the mesh, shrink the "
                 "serving ladder, or deploy on a device with more HBM",
            pass_name=PASS_NAME)

    def diagnostics(self):
        """Hazards + the peak-memory / comms summary INFO findings +
        the fit verdict (when a budget was set)."""
        m = self.memory
        out = [Diagnostic(
            "peak-memory", Severity.INFO,
            f"estimated step peak {_human(m.step_peak_bytes())} "
            f"(residency {_human(m.residency_peak_bytes)}, params "
            f"{_human(m.params_bytes)}, batch {m.batch_size}, mesh "
            f"{self.mesh.describe()}); high-water mark at "
            f"{m.high_water()}",
            block_idx=0, op_index=m.high_water_op_index,
            op_type=m.high_water_op_type, pass_name=PASS_NAME)]
        if m.unsized_vars:
            out.append(Diagnostic(
                "unsized-var", Severity.INFO,
                f"{len(m.unsized_vars)} var(s) declare no shape and "
                f"count 0 bytes: {sorted(m.unsized_vars)[:8]}",
                block_idx=0, pass_name=PASS_NAME,
                hint="declare shapes, or accept the blind spot "
                     "(tools/repo_lint.py tracks shape-blind ops)"))
        if self.comms["count"]:
            c = self.comms
            out.append(Diagnostic(
                "comm-budget", Severity.INFO,
                f"step comms: {c['count']} collective(s), payload "
                f"{_human(c['total_payload_bytes'])}, wire "
                f"{_human(c['wire_bytes'])} "
                f"(~{c['step_seconds'] * 1e3:.3f}ms at "
                f"{c['link_gbps']:g}GB/s per link)",
                block_idx=0, pass_name=PASS_NAME))
        out.extend(self.hazards)
        fit = self.fit_diagnostic()
        if fit is not None:
            out.append(fit)
        return out

    def to_dict(self):
        return {
            "mesh": self.mesh.axes,
            "batch_size": self.batch_size,
            "memory": self.memory.to_dict(),
            "comms": self.comms,
            "shardings": {n: list(s) if s else None
                          for n, s in sorted(self.shardings.items())},
            "hazards": [d.to_dict() for d in self.hazards],
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "fits": self.fits(),
        }


def plan_program(program, mesh=None, batch_size=1, stash_bytes=0,
                 hbm_budget_bytes=None, large_param_bytes=None,
                 link_gbps=None):
    """Run the full planner: sharding propagation → sharded liveness
    memory estimate → collective pricing. Returns a ResourcePlan."""
    mesh = MeshSpec.parse(mesh)
    specs, hazards, events = propagate_shardings(
        program, mesh, batch_size=batch_size,
        large_param_bytes=large_param_bytes)
    memory = estimate_peak_memory(program, batch_size=batch_size,
                                  mesh=mesh, shardings=specs,
                                  stash_bytes=stash_bytes)
    comms = price_collectives(events, mesh, link_gbps=link_gbps)
    return ResourcePlan(memory, specs, hazards, comms, mesh,
                        batch_size, hbm_budget_bytes=hbm_budget_bytes)


@register_pass(PASS_NAME)
class PlannerPass(Pass):
    """The planner as a framework pass. A default-constructed instance
    (what `get_pass("plan_resources")` builds) reads the mesh from
    `program.meta["mesh_axes"]` and the HBM budget from
    PT_FLAGS_plan_hbm_bytes; explicit instances (the --mesh CLI mode,
    the serving fit gate) carry their own configuration."""

    def __init__(self, mesh=None, batch_size=None, hbm_budget_bytes=None,
                 stash_bytes=0):
        self._mesh = mesh
        self._batch_size = batch_size
        self._hbm_budget = hbm_budget_bytes
        self._stash_bytes = stash_bytes

    def run(self, program, context):
        mesh = self._mesh
        if mesh is None:
            mesh = program.meta.get("mesh_axes")
        budget = self._hbm_budget
        if budget is None:
            budget = float(_flags.get_flag("plan_hbm_bytes")) or None
        plan = plan_program(
            program, mesh=mesh,
            batch_size=self._batch_size or 1,
            stash_bytes=self._stash_bytes,
            hbm_budget_bytes=budget)
        if context is not None:
            context.scratch["resource_plan"] = plan
        return plan.diagnostics()


# ---------------------------------------------------------------------------
# decode-rung geometry estimates (generation has no Program IR)
# ---------------------------------------------------------------------------

def _param_bytes(engine):
    """Bytes of an engine's parameters (the model's tensors, or an
    explicit `params` tree)."""
    params = getattr(engine, "params", None)
    if params is None:
        params = engine.model.state_dict()
    total, stack = 0, [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "numel"):
            total += int(node.numel()) * dtype_bytes(node.dtype)
        elif hasattr(node, "size") and hasattr(node, "dtype"):
            total += int(node.size) * int(node.dtype.itemsize)
    return total


def _head_dim(cfg):
    return int(getattr(cfg, "head_dim", 0)
               or cfg.d_model // cfg.num_heads)


def estimate_decode_rungs(engine, fusion_discount=None):
    """Static peaks for a DecodeEngine's rung ladder (the JAX package's
    geometry): the decode step holds its cache carry once; prefill
    materializes the full [1, bucket, vocab] logits. Returns
    {"decode[BxS]": bytes, ("prefill", bucket): bytes, ...}."""
    cfg = engine.model.config
    hd = _head_dim(cfg)
    params = _param_bytes(engine)
    cache = (2 * cfg.num_layers * engine.batch_size * engine.max_len
             * cfg.num_heads * hd * 4)                    # k + v, f32
    vocab = int(getattr(cfg, "vocab_size", 0))
    d_model = int(getattr(cfg, "d_model", 0))
    fusion = _discount(fusion_discount)
    out = {}
    b = engine.batch_size
    logits = b * vocab * 4
    small = b * (4 + 4 + 1 + 4)     # tokens/lengths/active in+out
    out[f"decode[{b}x{engine.max_len}]"] = params + cache + logits + small
    for bucket in engine.buckets:
        t = int(bucket)
        act = t * vocab * 4 + 2 * cfg.num_layers * t * cfg.num_heads \
            * hd * 4 + t * d_model * 4
        out[("prefill", t)] = int(params + cache + vocab * 4
                                  + (t * vocab * 4) + fusion * act)
    return out


def estimate_paged_rungs(engine, fusion_discount=None):
    """Static peaks for a PagedDecodeEngine's rung ladder (the JAX
    package's geometry): the pools (`kv_pool_bytes()`, quantized pools
    at their payload and scale bytes) once per rung, the chunk's logits
    and activations, and the gathered attention window. Returns
    {"paged_step[chunk=C]": bytes, ("paged_prefill", bucket): bytes}."""
    cfg = engine.model.config
    hd = _head_dim(cfg)
    params = _param_bytes(engine)
    if hasattr(engine, "kv_pool_bytes"):
        pool = int(engine.kv_pool_bytes())
    else:
        pool = (2 * cfg.num_layers * engine.num_blocks
                * engine.block_size * cfg.num_heads * hd * 4)
    vocab = int(getattr(cfg, "vocab_size", 0))
    d_model = int(getattr(cfg, "d_model", 0))
    fusion = _discount(fusion_discount)
    b = engine.batch_size
    tables = b * engine.blocks_per_slot * 4
    window = engine.blocks_per_slot * engine.block_size   # == max_len

    def chunk_act(rows, c):
        return (rows * c * vocab * 4
                + 2 * cfg.num_layers * rows * c * cfg.num_heads * hd * 4
                + rows * c * d_model * 4)

    def attn_window(rows, c):
        return (rows * cfg.num_heads * c * window * 4
                + 2 * rows * window * cfg.num_heads * hd * 4)

    out = {}
    chunks = [1]
    if getattr(engine, "spec_k", 0) > 0:
        chunks.append(engine.spec_k + 1)
    for c in chunks:
        out[f"paged_step[chunk={c}]"] = int(
            params + pool + tables + fusion * chunk_act(b, c)
            + attn_window(b, c) + b * c * vocab * 4)
    for bucket in engine.buckets:
        t = int(bucket)
        out[("paged_prefill", t)] = int(
            params + pool + tables + fusion * chunk_act(1, t)
            + attn_window(1, t) + t * vocab * 4)
    return out


# ---------------------------------------------------------------------------
# ledger cross-check: static estimate vs the measured capture peak
# ---------------------------------------------------------------------------

_EST_MU = make_lock("planner.estimates")
_ESTIMATES = {}          # (scope, key, static args) -> estimate record


def register_static_estimate(scope, key, estimate_bytes, component=None,
                             static_args=None, detail=None):
    """Register the planner's prediction for one executable identity
    (the CompileLedger's (scope, key) attribution; `static_args` narrows
    to one static-arg signature). `cross_check` joins it against the
    ledger's measured memory."""
    rec = {
        "scope": scope, "key": key,
        "estimate_bytes": int(estimate_bytes),
        "component": component,
        "static_args": dict(static_args) if static_args else None,
        "detail": detail,
    }
    with _EST_MU:
        _ESTIMATES[(scope, key,
                    tuple(sorted((static_args or {}).items())))] = rec
    return rec


def clear_static_estimates(scope=None):
    with _EST_MU:
        if scope is None:
            _ESTIMATES.clear()
        else:
            for k in [k for k in _ESTIMATES if k[0] == scope]:
                del _ESTIMATES[k]


def registered_estimates():
    with _EST_MU:
        return [dict(v) for v in _ESTIMATES.values()]


def _measured_peak(entries, static_args):
    """Newest usable measured peak among ledger entries; returns
    (peak_bytes or None, skip_reason or None). A record whose memory has
    no peak (an eager first run on the CPU) is no measurement."""
    want = tuple(sorted(static_args.items())) if static_args else None
    degraded = False
    for e in reversed(entries):
        if want is not None and tuple(e.static_args) != want:
            continue
        mem = e.memory
        if not mem:
            continue
        if mem.get("degraded"):
            degraded = True
            continue
        peak = mem.get("peak_bytes")
        if peak is not None:
            return float(peak), None
    return None, ("memory-analysis-degraded" if degraded
                  else "no-measurement")


def cross_check(tolerance=0.25, ledger=None):
    """Compare every registered static estimate against the newest
    measured peak in the CompileLedger. A leg is `ok` when
    estimate/measured ∈ [1−tol, 1+tol], `fail` when outside, and `skip`
    (never a vacuous pass) when nothing was measured."""
    if ledger is None:
        from paddle_tpu_torch.observability import profile as obs_profile
        ledger = obs_profile.compile_ledger()
    legs = []
    counts = {"ok": 0, "fail": 0, "skip": 0}
    for rec in registered_estimates():
        entries = ledger.entries(scope=rec["scope"], key=rec["key"])
        measured, skip = _measured_peak(entries, rec["static_args"])
        leg = dict(rec)
        if measured is None:
            leg.update(status="skip", skip_reason=skip,
                       measured_bytes=None, ratio=None)
        else:
            ratio = rec["estimate_bytes"] / measured if measured else \
                math.inf
            ok = (1.0 - tolerance) <= ratio <= (1.0 + tolerance)
            leg.update(status="ok" if ok else "fail",
                       skip_reason=None,
                       measured_bytes=measured,
                       ratio=round(ratio, 4))
        counts[leg["status"]] += 1
        legs.append(leg)
    legs.sort(key=lambda g: (str(g["scope"]), str(g["key"]),
                             str(g["static_args"])))
    return {
        "tolerance": tolerance,
        "legs": legs,
        "counts": counts,
        "ok": counts["fail"] == 0,
    }


def cross_check_section(tolerance=0.25):
    """The `plan_check` section of GET /profile: None until any
    estimate is registered (nothing to vacuously pass)."""
    with _EST_MU:
        empty = not _ESTIMATES
    if empty:
        return None
    try:
        return cross_check(tolerance=tolerance)
    except Exception:        # pragma: no cover - exposition guard rail
        return None
