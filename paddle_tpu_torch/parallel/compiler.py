"""CompiledProgram — data/tensor-parallel execution of a Program.

Counterpart of paddle_tpu/parallel/compiler.py (the reference's
compiler.py:65 CompiledProgram / with_data_parallel :138 and the C++
ParallelExecutor behind it). The JAX package compiles one logical
program over the global batch with GSPMD shardings, so "mean loss,
batch-norm moments are GLOBAL-batch exact". The port is one process per
rank and keeps that promise rank by rank:

* Every rank is fed the global batch and returns the global fetches.
  It runs its slice of the batch (dim 0 of each feed, split over the
  mesh's batch axis: `dp`, else the first axis); an uneven split raises.
* The forward ops run through an op hook (core/lowering.py `op_hook`)
  that tracks which values are batch-sharded. A per-example op (an
  elementwise, conv, pool, norm, softmax or loss op, a matmul over a
  batch-sharded X, a reshape that keeps dim 0, ...) runs on the shard;
  a reduction over the batch dim (mean, reduce_*) runs on the shard and
  is combined across the ranks (all-reduced, the mean divided by the
  rank count); any other op that reads a batch-sharded value gets it
  all-gathered and runs on the global batch (`accuracy`, `switch_moe`,
  ...). A replicated, non-persistable operand of a per-example op that
  carries the global batch is cut to the shard. Training `batch_norm` runs as
  `sync_batch_norm` (moments all-reduced over the batch axis).
* A parameter declared sharded (`VarDesc.sharding`, `ParamAttr(
  sharding=...)`) is stored sliced on each rank, its optimizer state
  sliced alike; the hook all-gathers it before its first use in the
  step (its gradient comes back reduce-scattered). An elementwise
  update op runs on the slices; any other update op that reads a slice
  (a global-norm clip, LARS' and LAMB's norms, the AMP overflow check)
  runs on the gathered whole (`_UpdateHook`). The results equal the replicated program's, as
  GSPMD's do; Megatron-style split compute is later work (ROADMAP).
* Gradients: every collective's backward is its true transpose
  (ops/collective.py), so each rank's autodiff holds its share of the
  gradient of the global loss. The hook all-reduces each gradient over
  the mesh's axes (a sharded parameter's over the axes but its own) and
  scales it by 1/ranks (`GradientScaleStrategy.CoeffNumDevice`, the JAX
  package's global gradient) or by batch ranks/ranks (`One`: the sum of
  the ranks' per-shard gradients, as in the reference).
* Fetches: a batch-sharded value is all-gathered, a sharded parameter
  gathered along its dim, every other value is replicated and returned
  as it is.
* A collective on a gloo group is host work: the step runs eagerly
  (`profile.disable_capture()`). On NCCL the collectives are captured in
  the step's CUDA graph and replayed with it.

Programs with control-flow sub-blocks are refused under a mesh.
"""
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.parallel.env import (DEFAULT_DP_AXIS, axis_info,
                                           bind_mesh, get_mesh)

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram"]


class BuildStrategy:
    """build_strategy.h:54 parity: the reduce and gradient-scale
    strategies are read; the fusion and memory toggles are kept for
    source compatibility."""

    class ReduceStrategy:
        AllReduce = "all_reduce"
        Reduce = "reduce"

    class GradientScaleStrategy:
        CoeffNumDevice = "coeff_num_device"
        One = "one"

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_optimizer_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.remat = None
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """execution_strategy.h parity, kept for source compatibility."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = True


# ---------------------------------------------------------------------------
# the data-parallel op hook
# ---------------------------------------------------------------------------

_UNARY = frozenset({
    "relu", "relu6", "leaky_relu", "elu", "gelu", "tanh", "sigmoid",
    "hard_sigmoid", "hard_swish", "swish", "logsigmoid", "exp", "log",
    "sqrt", "rsqrt", "square", "abs", "floor", "ceil", "round", "sign",
    "pow", "scale", "cast", "clip", "dropout", "assign", "softsign",
    "softplus", "stanh", "brelu", "cos", "sin", "reciprocal", "erf",
    "selu", "soft_relu", "thresholded_relu", "hard_shrink",
    "softshrink", "tanh_shrink", "log_softmax", "softmax",
})
_BINARY = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
})
#: per-example ops: dim 0 of every output is the batch
_PER_EXAMPLE = frozenset({
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d", "pool2d",
    "pool3d", "max_pool2d_with_index", "batch_norm", "sync_batch_norm",
    "layer_norm", "instance_norm", "group_norm", "lrn", "pad", "pad2d",
    "prelu", "cross_entropy", "softmax_with_cross_entropy", "one_hot",
    "lookup_table", "embedding", "top_k", "arg_max", "arg_min",
    "square_error_cost", "sigmoid_cross_entropy_with_logits",
    "fill_constant_batch_size_like", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "label_smooth", "fc",
    "bilinear_interp", "nearest_interp", "flash_attention",
})
_REDUCE = {"mean": "mean", "reduce_mean": "mean", "reduce_sum": "sum",
           "reduce_max": "max", "reduce_min": "min", "reduce_prod": "prod"}
_AXIS_OPS = frozenset({"concat", "split", "slice", "stack", "squeeze",
                       "squeeze2", "unsqueeze", "unsqueeze2"})
#: per-example ops whose attr (default) names a dim they reduce or mix
#: over: on dim 0 they read the whole batch
_OVER_AXIS = {"softmax": ("axis", -1), "log_softmax": ("axis", -1),
              "arg_max": ("axis", -1), "arg_min": ("axis", -1),
              "softmax_with_cross_entropy": ("axis", -1),
              "layer_norm": ("begin_norm_axis", 1)}


def _axes_attr(op):
    for k in ("axes", "axis", "dim"):
        if k in op.attrs:
            v = op.attrs[k]
            return list(v) if isinstance(v, (list, tuple)) else [v]
    return [0]


class _DataParallelHook:
    """Runs a rank's forward ops on its batch shard (module docstring).
    `states` (name -> batch-sharded) persists across runs: it is a
    function of the program and the feed signature, so a captured
    replay, which runs no op, keeps the capture's."""

    def __init__(self, compiled, b_local, b_global):
        self.compiled = compiled
        self.mesh = compiled.mesh
        self.batch_axis = compiled.dp_axis
        self.b_local, self.b_global = b_local, b_global
        self.sharded = compiled.sharded
        self.persistable = {v.name for b in compiled.program.blocks
                            for v in b.vars.values() if v.persistable}
        self.states = {}
        self._mode = None
        self._gathered = {}

    # -- per run ------------------------------------------------------
    def begin(self, feed):
        self._gathered = {}
        for n, v in feed.items():
            self.states[n] = (v.dim() >= 1 and self.b_global != self.b_local
                              and v.shape[0] == self.b_local)

    def _value(self, name, env):
        """env[name], a sharded parameter all-gathered (once a run)."""
        v = env[name]
        spec = self.sharded.get(name)
        if spec is None or not isinstance(v, torch.Tensor):
            return v
        hit = self._gathered.get(name)
        if hit is None or hit[0] is not v:
            from paddle_tpu_torch.ops.collective import all_gather
            dim, axis = spec
            hit = self._gathered[name] = (v, all_gather(v, axis, dim))
        return hit[1]

    def _args(self, impl, op, env, transform=None):
        args = []
        for slot in impl.in_slots:
            names = op.inputs.get(slot.name, [])
            vals = [self._value(n, env) for n in names]
            if transform is not None:
                vals = [transform(n, v) for n, v in zip(names, vals)]
            if slot.variadic:
                args.append(vals)
            elif not vals:
                args.append(None)
            else:
                args.append(vals[0])
        return args

    def _gather(self, n, v):
        from paddle_tpu_torch.ops.collective import all_gather
        if self.states.get(n) and isinstance(v, torch.Tensor):
            return all_gather(v, self.batch_axis, 0)
        return v

    def _cut(self, n, v):
        """A replicated value carrying the global batch, cut to this
        rank's shard (its gradient: the shard's rows, zero elsewhere)."""
        if (not self.states.get(n) and n not in self.persistable
                and isinstance(v, torch.Tensor) and v.dim() >= 1
                and v.shape[0] == self.b_global):
            c = self.mesh.coord(self.batch_axis)
            return v.narrow(0, c * self.b_local, self.b_local)
        return v

    def _mode_of(self, op, sharded_in, env):
        t = op.type
        if not sharded_in:
            return "replicated"
        enforce(not any(k in op.attrs for k in ("sub_block",
                                                "else_block")),
                "data parallelism: op %r reads the batch-sharded %s in a "
                "sub-block; control flow under a mesh is not supported",
                t, sharded_in)
        if t in _OVER_AXIS:
            attr, default = _OVER_AXIS[t]
            rank = max(env[sharded_in[0]].dim(), 1)
            if op.attrs.get(attr, default) % rank == 0:
                return "gather"
        if t == "pad" and any(op.attrs.get("paddings", [0, 0])[:2]):
            return "gather"
        if t in _UNARY or t in _PER_EXAMPLE or t in _BINARY:
            return "batch"
        if t in _REDUCE:
            dims = op.attrs.get("dim")
            if (t == "mean" or op.attrs.get("reduce_all", False)
                    or dims is None):
                return "combine"
            rank = max(env[op.inputs["X"][0]].dim(), 1)
            dims = dims if isinstance(dims, (list, tuple)) else [dims]
            return "combine" if any(d % rank == 0 for d in dims) \
                else "batch"
        if t in ("mul", "matmul", "matmul_v2"):
            y = (op.inputs.get("Y") or [None])[0]
            if y in sharded_in and env[y].dim() == 2:
                return "gather"
            return "batch"
        if t in ("reshape", "reshape2"):
            shape = op.attrs.get("shape") or [0]
            return "batch" if shape[0] in (-1, 0) else "gather"
        if t in ("flatten", "flatten2"):
            return "batch" if op.attrs.get("axis", 1) >= 1 else "gather"
        if t in ("transpose", "transpose2"):
            perm = op.attrs.get("axis") or op.attrs.get("perm") or [0]
            return "batch" if perm[0] == 0 else "gather"
        if t in _AXIS_OPS:
            return "batch" if 0 not in _axes_attr(op) else "gather"
        return "gather"

    def _classified(self, names, what):
        lost = [n for n in names if n in self.states
                and self.states[n] is None]
        enforce(not lost, "data parallelism: %s reads %s, which a "
                "per-example op gave a dim 0 other than the rank's batch "
                "shard (%d rows), so neither a shard nor a global value",
                what, lost, self.b_local)

    def run_op(self, op, impl, ctx, env):
        from paddle_tpu_torch.core.registry import get_op
        self._classified(op.input_names(), "op %r" % op.type)
        sharded_in = [n for n in op.input_names() if self.states.get(n)]
        mode = self._mode = self._mode_of(op, sharded_in, env)
        if mode == "gather":
            return impl.fn(ctx, *self._args(impl, op, env, self._gather))
        if (op.type == "batch_norm" and ctx.training
                and not op.attrs.get("is_test", False)
                and not op.attrs.get("use_global_stats", False)):
            ctx.attrs = dict(op.attrs, axis_name=self.batch_axis)
            impl = get_op("sync_batch_norm")
        out = impl.fn(ctx, *self._args(
            impl, op, env, self._cut if mode == "batch" else None))
        if mode != "combine":
            return out
        from paddle_tpu_torch.ops.collective import all_reduce
        how = _REDUCE[op.type]
        if how == "mean":
            ax = axis_info(self.batch_axis)
            return all_reduce(out, self.batch_axis) / ax.size
        return all_reduce(out, self.batch_axis, how)

    def after_op(self, op, env):
        """Classify the outputs: a per-example op's tensor is a shard
        when its dim 0 is the shard's rows; one with another dim 0 is
        unclassified (None: reading or fetching it raises). Batch
        norm's moments are all-reduced, so replicated."""
        mode, self._mode = self._mode, None
        for slot, names in op.outputs.items():
            for n in names:
                v = env.get(n)
                if (mode != "batch" or not isinstance(v, torch.Tensor)
                        or (op.type in ("batch_norm", "sync_batch_norm")
                            and slot != "Y")):
                    self.states[n] = False
                elif v.dim() >= 1 and v.shape[0] == self.b_local:
                    self.states[n] = True
                else:
                    self.states[n] = None

    def on_grads(self, params, grads):
        from paddle_tpu_torch.ops.collective import all_reduce
        scale = self.compiled.grad_scale()
        out = []
        for p, g in zip(params, grads):
            own = self.sharded.get(p, (None, None))[1]
            for axis in self.mesh.axis_names:
                if axis != own:
                    g = all_reduce(g, axis)
            out.append(g * scale)
        return out

    def update_hook(self, params, grad_names):
        """The hook of the step's update ops (after the autodiff op)."""
        return _UpdateHook(self.mesh, self.sharded, params, grad_names)

    def fetch(self, name, value):
        """The global value of a fetch."""
        from paddle_tpu_torch.ops.collective import all_gather
        if not isinstance(value, torch.Tensor):
            return value
        self._classified([name], "the fetch")
        if self.states.get(name):
            return all_gather(value, self.batch_axis, 0)
        spec = self.sharded.get(name)
        if spec is not None:
            return all_gather(value, spec[1], spec[0])
        return value


#: update-side ops that are elementwise in every tensor they read: on
#: the rank's slices of a sharded parameter, its gradient and its state
#: they make the slices of the whole's results
_ON_SLICES = _BINARY | frozenset({
    "sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
    "adadelta", "rmsprop", "ftrl", "proximal_gd",
    "scale", "sum", "clip", "sign", "abs", "square", "sqrt", "cast",
    "assign",
})


class _UpdateHook:
    """Runs a step's update ops (regularizers, clips, loss scaling,
    optimizer ops) under a mesh. They see replicated values and the
    rank's slices of the sharded parameters, their optimizer state and
    their gradients. An op of `_ON_SLICES` whose every tensor operand is
    a slice of one layout or a scalar runs on the slices and makes
    slices. Any other op that reads a slice (a global-norm clip's
    squared_l2_norm, LARS' and LAMB's norms, check_finite_and_unscale's
    overflow flag, dpsgd's clip) runs on the gathered wholes, as the JAX
    package's GSPMD program computes it; an output that names a sliced
    input, or has the whole shape of exactly one layout read, is cut
    back to the rank's slice, and one whose layout is ambiguous raises."""

    def __init__(self, mesh, sharded, params, grad_names):
        self.mesh = mesh
        self.sliced = dict(sharded)          # name -> (dim, axis)
        for p, g in zip(params, grad_names):
            if p in sharded:
                self.sliced[g] = sharded[p]
        self._run = None

    def _whole_shape(self, piece, spec):
        dim, axis = spec
        return piece[:dim] + (piece[dim] * self.mesh.axis_size(axis),) + \
            piece[dim + 1:]

    def run_op(self, op, impl, ctx, env):
        from paddle_tpu_torch.ops.collective import all_gather
        hit = {n: (self.sliced[n], tuple(env[n].shape))
               for n in op.input_names() if n in self.sliced}
        self._run = None
        if hit:
            layouts = set(hit.values())
            if op.type in _ON_SLICES and len(layouts) == 1 and all(
                    n in hit or not isinstance(env.get(n), torch.Tensor)
                    or env[n].numel() == 1 for n in op.input_names()):
                self._run = ("slices", layouts.pop())
            else:
                self._run = ("whole", hit)
                env = {**env, **{n: all_gather(env[n], spec[1], spec[0])
                                 for n, (spec, _) in hit.items()}}
        return impl.fn(ctx, *impl.gather_inputs(op, env))

    def after_op(self, op, env):
        run, self._run = self._run, None
        for name in op.output_names():
            v = env.get(name)
            spec = None
            if run is not None and isinstance(v, torch.Tensor):
                spec = self._output_layout(op, name, tuple(v.shape), run)
            if spec is None:
                self.sliced.pop(name, None)
                continue
            if run[0] == "whole":
                dim, axis = spec
                piece = v.shape[dim] // self.mesh.axis_size(axis)
                v = v.narrow(dim, self.mesh.coord(axis) * piece,
                             piece).contiguous()
                env[name] = v
            self.sliced[name] = spec

    def _output_layout(self, op, name, shape, run):
        """The (dim, axis) of output `name` of shape `shape`, None when
        it is replicated."""
        kind, what = run
        if kind == "slices":
            return what[0] if shape == what[1] else None
        if name in what:
            spec, piece = what[name]
            return spec if shape == self._whole_shape(piece, spec) else None
        specs = {spec for spec, piece in what.values()
                 if shape == self._whole_shape(piece, spec)}
        enforce(len(specs) <= 1, "tensor parallelism: output %r of update "
                "op %r has the whole shape %s of sharded operands laid "
                "out differently %s", name, op.type, shape, sorted(specs))
        return specs.pop() if specs else None


# ---------------------------------------------------------------------------
# CompiledProgram
# ---------------------------------------------------------------------------

class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self.program = program_or_graph
        self.build_strategy = build_strategy or BuildStrategy()
        self.mesh = None
        self.dp_axis = None
        self._is_data_parallel = False
        self.sharded = {}
        self._hooks = {}

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None, mesh=None,
                           share_vars_from=None, distributed_strategy=None):
        """compiler.py:138 parity. `mesh` is a parallel.env.Mesh (default:
        the bound mesh, or all-dp over the world on the card); `places`
        is accepted for source compatibility (the mesh names the device).
        `distributed_strategy` carries a pipeline schedule override onto
        a program PipelineOptimizer(cut_list=...) annotated."""
        self.build_strategy = build_strategy or self.build_strategy
        self.mesh = mesh or get_mesh()
        names = self.mesh.axis_names
        self.dp_axis = DEFAULT_DP_AXIS if DEFAULT_DP_AXIS in names \
            else names[0]
        self._is_data_parallel = True
        if loss_name is not None:
            self.program.meta["loss"] = loss_name
        if distributed_strategy is not None:
            plan = getattr(self.program, "meta", {}).get("pipeline")
            sched = getattr(distributed_strategy, "pipeline_schedule", None)
            if plan is not None and sched:
                from paddle_tpu_torch.parallel.schedules import SCHEDULES
                enforce(sched in SCHEDULES,
                        "unknown pipeline_schedule %r (choose from %s)",
                        sched, SCHEDULES)
                plan["schedule"] = sched
                v = getattr(distributed_strategy,
                            "pipeline_virtual_stages", 1)
                if v and int(v) > 1:
                    plan["virtual_stages"] = int(v)
        self.sharded = self._sharded_state()
        return self

    def cache_fingerprint(self):
        """The parallel plan's identity for the compile cache: the mesh's
        dims and sizes and the batch axis."""
        mesh = ("none" if self.mesh is None else
                f"{tuple(self.mesh.axis_names)}x"
                f"{tuple(self.mesh.shape.values())}")
        return f"dp:{self.dp_axis}/mesh:{mesh}"

    # -- sharded state -------------------------------------------------
    def _sharded_state(self):
        """{name: (dim, axis)} of the parameters declared sharded on a
        mesh axis of size > 1, and of the optimizer state of theirs that
        has their shape (sliced alike)."""
        block = self.program.global_block()
        out = {}
        for name, desc in block.vars.items():
            spec = desc.sharding
            if not spec or not desc.persistable:
                continue
            dims = [(d, a) for d, a in enumerate(spec)
                    if a and self.mesh.axis_size(a) > 1]
            enforce(len(dims) <= 1, "parameter %r is sharded on %d dims; "
                    "one is supported", name, len(dims))
            if dims:
                out[name] = dims[0]
        for op in block.ops:
            params = op.inputs.get("Param") or []
            if len(params) != 1 or params[0] not in out:
                continue
            shape = block.var(params[0]).desc.shape
            for names in list(op.inputs.values()) + \
                    list(op.outputs.values()):
                for n in names:
                    if n in out or not block.has_var(n):
                        continue
                    d = block.var(n).desc
                    if d.persistable and d.shape == shape and \
                            not n.endswith("@GRAD"):
                        out[n] = out[params[0]]
        return out

    def shard_state(self, scope):
        """Cut this rank's slice of each sharded state var the scope
        still holds whole (after the startup program)."""
        block = self.program.global_block()
        for name, (dim, axis) in self.sharded.items():
            if not scope.has(name):
                continue
            v = scope.get(name)
            full = block.var(name).desc.shape[dim]
            if v.shape[dim] != full:
                continue
            n = self.mesh.axis_size(axis)
            enforce(full % n == 0, "%r dim %d of size %d does not split "
                    "over %s=%d", name, dim, full, axis, n)
            size = full // n
            scope.set(name, v.narrow(dim, self.mesh.coord(axis) * size,
                                     size).contiguous())

    def full_state(self, scope, names=None):
        """{name: numpy} of the scope's state with the sharded vars
        gathered whole (what a checkpoint of the replicated program
        holds); every rank of the mesh calls it."""
        from paddle_tpu_torch.ops.collective import all_gather
        from paddle_tpu_torch.core.scope import to_numpy
        out = {}
        with bind_mesh(self.mesh):
            for name in (names or sorted(scope._vars)):
                v = scope.get(name)
                spec = self.sharded.get(name)
                if spec is not None and isinstance(v, torch.Tensor):
                    v = all_gather(v, spec[1], spec[0])
                out[name] = to_numpy(v)
        return out

    def grad_scale(self):
        ranks = self.mesh.size
        if self.build_strategy.gradient_scale_strategy == \
                BuildStrategy.GradientScaleStrategy.One:
            return self.mesh.axis_size(self.dp_axis) / ranks
        return 1.0 / ranks

    # -- the Executor's side -------------------------------------------
    def shard_feeds(self, feed_vals):
        """This rank's slice of each batch feed and the (local, global)
        batch sizes. The batch is dim 0 of the feeds that share the
        largest leading dim; an uneven split raises."""
        n = self.mesh.axis_size(self.dp_axis)
        lead = [v.shape[0] for v in feed_vals.values() if v.dim() >= 1]
        b_global = max(lead) if lead else 1
        if n == 1 or not lead:
            return feed_vals, b_global, b_global
        enforce(b_global % n == 0, "data parallelism: global batch %d "
                "does not split evenly over %s=%d", b_global, self.dp_axis,
                n)
        b = b_global // n
        c = self.mesh.coord(self.dp_axis)
        out = {k: (v.narrow(0, c * b, b) if v.dim() >= 1 and
                   v.shape[0] == b_global else v)
               for k, v in feed_vals.items()}
        return out, b, b_global

    def hook(self, key, b_local, b_global):
        """The persistent op hook of one Executor entry."""
        h = self._hooks.get(key)
        if h is None:
            h = self._hooks[key] = _DataParallelHook(self, b_local,
                                                     b_global)
        return h

    def uses_host_collectives(self):
        return any(self.mesh.backend(a) == "gloo"
                   for a in self.mesh.axis_names)
