"""Pipeline parallelism over a `pp` mesh axis, one rank per stage.

Counterpart of paddle_tpu/parallel/pipeline.py (the reference's
PipelineOptimizer, optimizer.py:3020-3066, and its SectionWorkers,
section_worker.cc:141-171). The JAX package runs every stage in one
SPMD scan over a static table, moving activations with `lax.ppermute`;
here each rank of the `pp` group is a stage and runs its own row of the
same `ScheduleTable` (parallel/schedules.py) tick by tick:

* a forward tick runs the stage (chunk `chunk` of the rank's virtual
  stages) on the fresh microbatch or on the activation its rx slot
  holds; a backward tick backpropagates the stashed microbatch with the
  cotangent its brx slot holds (the loss seed 1/M on the last stage) and
  accumulates the parameter gradients;
* at the end of each tick the rank sends what the table's `send_fwd` /
  `send_bwd` flags say and receives what the next tick's `rx_store` /
  `brx_store` slots expect, in one `batch_isend_irecv`
  (ops.collective.exchange), so a send always meets its receive;
* the stash holds the autograd graphs of the in-flight microbatches: at
  most S-s of them under `1f1b`, which keeps them as its true residuals
  and recomputes nothing; `gpipe` with `remat=True` wraps each stage
  forward in `torch.utils.checkpoint`, so its backward ticks recompute.

Gradient accumulation across microbatches matches the reference's for
every schedule: the loss is the mean of the microbatch losses, the
gradients those of that mean. Stages must be homogeneous in their wire
format (y.shape == x.shape); embeddings and heads run outside the
pipeline. Parameters are per rank: `stage_params` is this rank's stage
(a tree of tensors; a list of v trees, chunk c = virtual stage c·S + s,
under `interleaved`); `local_stage_params` picks it from the
`stack_*` layout, which is the JAX package's, so stacked parameters move
between the packages as numpy arrays.

`PipelineOptimizer(cut_list=...)` records the plan of a static program
and `PipelineCompiledProgram` runs it through the port's Executor: each
rank runs its sections' ops, the gradients are summed over the `pp`
group, and every rank applies the program's own optimizer ops.
"""
import collections
import time

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.collective import all_reduce, exchange
from paddle_tpu_torch.parallel import schedules as _sched
from paddle_tpu_torch.parallel.env import axis_info, bind_mesh
from paddle_tpu_torch.parallel.grad_hooks import _tree_map
from paddle_tpu_torch.parallel.schedules import (
    K_BWD_LAST, K_BWD_MID, K_FWD_LAST, K_FWD_MID, SRC_FRESH, make_schedule,
)

__all__ = ["Pipeline", "GPipe", "pipeline_apply", "bubble_fraction",
           "schedule_report", "stack_stage_params", "unstack_stage_params",
           "stack_virtual_stage_params", "unstack_virtual_stage_params",
           "local_stage_params", "PipelineOptimizer",
           "PipelineCompiledProgram"]


# ---------------------------------------------------------------------------
# trees and the stack_* layout
# ---------------------------------------------------------------------------
def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _stack(xs):
    if all(isinstance(x, np.ndarray) for x in xs):
        return np.stack(xs)
    return torch.stack([torch.as_tensor(x) for x in xs])


def stack_stage_params(per_stage_params):
    """List of per-stage param trees (same structure) → one tree with a
    leading stage axis (numpy arrays stay numpy)."""
    return _tree_map(lambda *xs: _stack(xs), *per_stage_params)


def unstack_stage_params(stacked, num_stages):
    """Inverse of stack_stage_params."""
    return [_tree_map(lambda x: x[i], stacked) for i in range(num_stages)]


def stack_virtual_stage_params(per_stage_params, num_stages):
    """List of v·S per-virtual-stage trees (model order) → a tree with
    leading [v, S] axes: virtual stage j at [j // S, j % S], so device d
    owns {d, d+S, ..., d+(v-1)S}."""
    S = int(num_stages)
    J = len(per_stage_params)
    if J % S:
        raise ValueError(f"{J} virtual stages not divisible by {S} devices")
    stacked = stack_stage_params(per_stage_params)
    return _tree_map(lambda x: x.reshape((J // S, S) + tuple(x.shape[1:])),
                     stacked)


def unstack_virtual_stage_params(stacked, num_stages):
    """Inverse of stack_virtual_stage_params (model order)."""
    flat = _tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])),
                     stacked)
    n = _leaves(flat)[0].shape[0]
    return unstack_stage_params(flat, n)


def local_stage_params(stacked, stage, virtual_stages=1):
    """Rank `stage`'s share of stacked params: the tree at [stage] for
    v = 1, the list over chunks c of the trees at [c, stage] for v > 1."""
    if virtual_stages == 1:
        return _tree_map(lambda x: x[stage], stacked)
    return [_tree_map(lambda x: x[c, stage], stacked)
            for c in range(virtual_stages)]


# ---------------------------------------------------------------------------
# the tick engine
# ---------------------------------------------------------------------------
def _run_table(table, ax, stage, chunk_fn, fresh, wire, chunk_leaves,
               fwd_only=False):
    """Run this rank's row of `table`.

    chunk_fn(c, x, m, last) -> the stage output (the microbatch loss on
    the last virtual stage of a training table); fresh(m) -> microbatch
    m's input; wire = (shape, dtype, device) of an activation;
    chunk_leaves[c] -> the parameter tensors of chunk c that gradients
    are taken for. Returns (loss sum / M, {c: grads}, {m: last output}).
    """
    S, T, M = table.num_stages, table.T, table.num_microbatches
    rx, brx, stash = {}, {}, {}
    inc_f = inc_b = None
    loss = None
    grads = {}
    outputs = {}
    shape, dtype, device = wire
    for t in range(T):
        if table.rx_store[t, stage] >= 0:
            rx[int(table.rx_store[t, stage])] = inc_f
        if table.brx_store[t, stage] >= 0:
            brx[int(table.brx_store[t, stage])] = inc_b
        k = int(table.kind[t, stage])
        c, m = int(table.chunk[t, stage]), int(table.mb[t, stage])
        y_send = d_send = None
        if k in (K_FWD_MID, K_FWD_LAST):
            src = int(table.fwd_src[t, stage])
            x = fresh(m) if src == SRC_FRESH else rx.pop(src)
            last = k == K_FWD_LAST
            if fwd_only:
                with torch.no_grad():
                    out = chunk_fn(c, x, m, last)
                if last:
                    outputs[m] = out
            else:
                x_leaf = x.detach().requires_grad_(src != SRC_FRESH)
                with torch.enable_grad():
                    out = chunk_fn(c, x_leaf, m, last)
                if last:
                    lv = out.detach().float().reshape(()) / M
                    loss = lv if loss is None else loss + lv
                stash[(last, int(table.res_slot[t, stage]))] = (x_leaf, out)
            if table.send_fwd[t, stage]:
                y_send = out.detach()
        elif k in (K_BWD_MID, K_BWD_LAST):
            last = k == K_BWD_LAST
            x_leaf, out = stash.pop((last, int(table.res_slot[t, stage])))
            if last:
                seed = torch.full_like(out, 1.0 / M)
            else:
                seed = brx.pop(int(table.bwd_src[t, stage]))
            leaves = chunk_leaves[c]
            inputs = list(leaves) + ([x_leaf] if x_leaf.requires_grad
                                     else [])
            got = torch.autograd.grad(out, inputs, grad_outputs=seed,
                                      allow_unused=True)
            acc = grads.setdefault(c, [None] * len(leaves))
            for i, g in enumerate(got[:len(leaves)]):
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i] + g
            if table.send_bwd[t, stage]:
                d_send = got[-1]
        sends, recvs = [], []
        if y_send is not None:
            sends.append((y_send, (stage + 1) % S, 1))
        if d_send is not None:
            sends.append((d_send, (stage - 1) % S, 2))
        if t + 1 < T and table.rx_store[t + 1, stage] >= 0:
            recvs.append((shape, dtype, device, (stage - 1) % S, 1))
        if t + 1 < T and table.brx_store[t + 1, stage] >= 0:
            recvs.append((shape, dtype, device, (stage + 1) % S, 2))
        if sends or recvs:
            got = exchange(ax, sends, recvs)
            for (_, _, _, _, tag), g in zip(recvs, got):
                if tag == 1:
                    inc_f = g
                else:
                    inc_b = g
    return loss, grads, outputs


def _fwd_table(schedule, S, M, v):
    sched = "interleaved" if v > 1 else "gpipe"
    return make_schedule(sched, S, M, v, fwd_only=True)


def _as_chunks(stage_params, v):
    return list(stage_params) if v > 1 else [stage_params]


def pipeline_apply(stage_fn, stage_params, microbatches, axis_name="pp",
                   remat=True, schedule="gpipe", virtual_stages=1):
    """Pipelined forward over the ranks of `axis_name`: stage_fn(params,
    x) -> y with y.shape == x.shape; stage_params this rank's (a list of
    v chunk trees under `interleaved`); microbatches [M, b, ...], the
    same on every rank. Returns the last stage's [M, b, ...] outputs on
    every rank (no gradient: `Pipeline.loss_and_grad` trains)."""
    ax = axis_info(axis_name)
    S = 1 if ax is None else ax.size
    stage = 0 if ax is None else ax.rank
    v = virtual_stages if schedule == "interleaved" else 1
    M = microbatches.shape[0]
    table = _fwd_table(schedule, S, M, v)
    chunks = _as_chunks(stage_params, v)

    def chunk_fn(c, x, m, last):
        return stage_fn(chunks[c], x)

    wire = (tuple(microbatches.shape[1:]), microbatches.dtype,
            microbatches.device)
    _, _, outputs = _run_table(table, ax, stage, chunk_fn,
                               lambda m: microbatches[m], wire, None,
                               fwd_only=True)
    out = torch.zeros_like(microbatches)
    if stage == S - 1:
        out = torch.stack([outputs[m] for m in range(M)])
    if ax is not None:
        import torch.distributed as dist
        out = out.contiguous()
        dist.broadcast(out, dist.get_global_rank(ax.group, S - 1),
                       group=ax.group)
    return out


# ---------------------------------------------------------------------------
# user-facing wrapper
# ---------------------------------------------------------------------------
class Pipeline:
    """Schedule-aware pipeline over the `pp` dim of `mesh`: split the
    batch into microbatches and run this rank's stage on the schedule.

    >>> pipe = Pipeline(mesh, block_fn, num_stages=4, num_microbatches=8,
    ...                 schedule="1f1b")
    >>> y = pipe(stage_params, x)                        # forward, [B, ...]
    >>> loss, grads = pipe.loss_and_grad(loss_fn, stage_params, x, tgt)

    schedule: "gpipe" (fill-drain; `remat` recomputes the stage
    forwards in the backward ticks), "1f1b" (at most S-s in-flight
    microbatches, their autograd graphs kept), "interleaved" (1f1b with
    `virtual_stages` v > 1 chunks per rank). `batch_axis` also splits
    each microbatch over a data-parallel dim of the mesh.
    """

    def __init__(self, mesh, stage_fn, num_stages, num_microbatches,
                 axis="pp", batch_axis=None, remat=True, schedule="gpipe",
                 virtual_stages=1, residuals=None):
        if schedule not in _sched.SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; choose from "
                             f"{_sched.SCHEDULES}")
        self.mesh = mesh
        self.stage_fn = stage_fn
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.axis = axis
        self.batch_axis = batch_axis
        self.remat = remat
        self.schedule = schedule
        self.virtual_stages = (virtual_stages if schedule == "interleaved"
                               else 1)
        self.residuals = residuals or "stash"
        if axis in mesh.shape:
            assert mesh.shape[axis] == num_stages, (
                f"mesh axis {axis}={mesh.shape[axis]} != stages {num_stages}")
        # measured walls per kind, the first call of each discarded
        self._measured = {"fwd": collections.deque(maxlen=32),
                          "fused": collections.deque(maxlen=32)}
        self._measured_calls = {"fwd": 0, "fused": 0}

    @property
    def stage(self):
        return self.mesh.coord(self.axis)

    def local_params(self, stacked):
        """This rank's params from the stack_* layout."""
        return local_stage_params(stacked, self.stage, self.virtual_stages)

    # -- schedule accounting -------------------------------------------
    def schedule_table(self, fwd_only=False):
        return make_schedule(self.schedule, self.num_stages,
                             self.num_microbatches, self.virtual_stages,
                             fwd_only=fwd_only)

    def _recompute(self):
        return self.remat if self.schedule == "gpipe" \
            else self.residuals == "recompute"

    def bubble_fraction(self, t_fwd=1.0, t_bwd=2.0, measured=False):
        """The analytic lockstep-model bubble of this configuration;
        `measured=True` prices it with tick times solved from this
        pipe's own measured walls (`measured_tick_times`)."""
        if measured:
            times = self.measured_tick_times()
            if times is None:
                return None
            t_fwd, t_bwd = times["t_fwd"], times["t_bwd"]
        return self.schedule_table().bubble_fraction(
            t_fwd, t_bwd, recompute_in_bwd=self._recompute())

    def _observe_wall(self, kind, seconds):
        self._measured_calls[kind] += 1
        if self._measured_calls[kind] > 1:
            self._measured[kind].append(seconds)
            from paddle_tpu_torch.observability import profile as obs
            obs.observe_run(
                "pipeline", f"{self.schedule}/S{self.num_stages}"
                f"M{self.num_microbatches}/{kind}", seconds)

    def measured_tick_times(self):
        """(t_fwd, t_bwd) solved from the measured walls under the
        lockstep model, as in the JAX package; None before a measured
        training step."""
        fused = list(self._measured["fused"])
        if not fused:
            return None
        fused_wall = float(np.median(fused))
        prof = self.schedule_table().tick_profile()
        n_f, n_b = prof["fwd_only_ticks"], prof["bwd_ticks"]
        fwd = list(self._measured["fwd"])
        fwd_wall = float(np.median(fwd)) if fwd else None
        if fwd_wall is not None:
            fwd_ticks = self.schedule_table(
                fwd_only=True).tick_profile()["ticks"]
            t_fwd = fwd_wall / max(fwd_ticks, 1)
            t_bwd = (fused_wall - n_f * t_fwd) / max(n_b, 1)
            t_bwd = max(t_bwd, t_fwd * 0.1)
        else:
            t_fwd = fused_wall / max(n_f + 2 * n_b, 1)
            t_bwd = 2.0 * t_fwd
        return {"t_fwd": t_fwd, "t_bwd": t_bwd, "fwd_wall": fwd_wall,
                "fused_wall": fused_wall, "samples": len(fused)}

    def _log_schedule(self):
        from paddle_tpu_torch.utils import profiler
        vals = self.schedule_table().counters()
        vals["bubble_model"] = round(self.bubble_fraction(), 6)
        measured = self.bubble_fraction(measured=True)
        if measured is not None:
            vals["bubble_measured"] = round(measured, 6)
            times = self.measured_tick_times()
            vals["t_fwd_measured_s"] = times["t_fwd"]
            vals["t_bwd_measured_s"] = times["t_bwd"]
        profiler.log_counters(f"pipeline/{self.schedule}", vals)

    # -- microbatches --------------------------------------------------
    def _split(self, x):
        M = self.num_microbatches
        B = x.shape[0]
        assert B % M == 0, f"batch {B} % microbatches {M} != 0"
        mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
        if self.batch_axis and self.mesh.axis_size(self.batch_axis) > 1:
            n = self.mesh.axis_size(self.batch_axis)
            b = mb.shape[1] // n
            mb = mb.narrow(1, self.mesh.coord(self.batch_axis) * b, b)
        return mb

    def _wire(self, mb):
        return (tuple(mb.shape[1:]), mb.dtype, mb.device)

    # -- forward -------------------------------------------------------
    def __call__(self, stage_params, x):
        mb = self._split(x)
        t0 = time.perf_counter()
        with bind_mesh(self.mesh):
            y = pipeline_apply(self.stage_fn, stage_params, mb,
                               axis_name=self.axis, remat=self.remat,
                               schedule=self.schedule,
                               virtual_stages=self.virtual_stages)
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        self._observe_wall("fwd", time.perf_counter() - t0)
        if self.batch_axis and self.mesh.axis_size(self.batch_axis) > 1:
            from paddle_tpu_torch.ops.collective import all_gather
            with bind_mesh(self.mesh), torch.no_grad():
                y = all_gather(y, self.batch_axis, 1)
        return y.reshape((x.shape[0],) + tuple(y.shape[2:]))

    # -- fused training step -------------------------------------------
    def loss_and_grad(self, loss_fn, stage_params, x, *aux):
        """(mean-over-microbatches loss, grads of this rank's
        stage_params), the loss the same on every rank. loss_fn(y_mb,
        *aux_mb) -> scalar for one microbatch."""
        self._log_schedule()
        v = self.virtual_stages
        mb = self._split(x)
        aux_mb = [self._split(a) for a in aux]
        chunks = _as_chunks(stage_params, v)
        leaf_chunks = [_tree_map(lambda p: p.detach().requires_grad_(), c)
                       for c in chunks]
        flat = [_leaves(c) for c in leaf_chunks]
        stage_fn = self.stage_fn
        if self.schedule == "gpipe" and self.remat:
            from torch.utils.checkpoint import checkpoint

            def stage_fn(p, xx, _fn=self.stage_fn):
                return checkpoint(_fn, p, xx, use_reentrant=False)

        def chunk_fn(c, xx, m, last):
            y = stage_fn(leaf_chunks[c], xx)
            if last:
                return loss_fn(y, *[a[m] for a in aux_mb])
            return y

        table = self.schedule_table()
        t0 = time.perf_counter()
        with bind_mesh(self.mesh):
            ax = axis_info(self.axis)
            loss, grads, _ = _run_table(table, ax, self.stage, chunk_fn,
                                        lambda m: mb[m], self._wire(mb),
                                        flat)
            if loss is None:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=mb.device)
            loss = all_reduce(loss, self.axis)
            out = []
            for c in range(len(chunks)):
                g = grads.get(c, [None] * len(flat[c]))
                g = [torch.zeros_like(p) if gi is None else gi
                     for p, gi in zip(flat[c], g)]
                if self.batch_axis:
                    n = self.mesh.axis_size(self.batch_axis)
                    g = [all_reduce(gi, self.batch_axis) / n for gi in g]
                out.append(_unflatten(chunks[c], g))
            if self.batch_axis:
                loss = all_reduce(loss, self.batch_axis) / \
                    self.mesh.axis_size(self.batch_axis)
        if mb.is_cuda:
            torch.cuda.synchronize(mb.device)
        self._observe_wall("fused", time.perf_counter() - t0)
        return loss, (out if v > 1 else out[0])


class GPipe(Pipeline):
    """`GPipe(...)` == `Pipeline(..., schedule="gpipe")` unless a
    schedule is passed."""


def bubble_fraction(schedule, num_stages, num_microbatches,
                    virtual_stages=1, t_fwd=1.0, t_bwd=2.0,
                    recompute_in_bwd=None):
    """Analytic bubble fraction of a schedule configuration."""
    return make_schedule(schedule, num_stages, num_microbatches,
                         virtual_stages).bubble_fraction(
        t_fwd, t_bwd, recompute_in_bwd=recompute_in_bwd)


def schedule_report(schedule, num_stages, num_microbatches,
                    virtual_stages=1, t_fwd=1.0, t_bwd=2.0):
    """Table stats and the analytic bubble."""
    table = make_schedule(schedule, num_stages, num_microbatches,
                          virtual_stages)
    rep = table.stats()
    rep["bubble_model"] = table.bubble_fraction(t_fwd, t_bwd)
    rep["bubble_formula_fill_drain"] = (
        (num_stages - 1) / (num_microbatches + num_stages - 1))
    return rep


# ---------------------------------------------------------------------------
# the static program's pipeline
# ---------------------------------------------------------------------------
class PipelineOptimizer:
    """Static-graph pipeline parallelism (reference optimizer.py:3020).
    `cut_list` names the boundary tensors (S-1 of them, or v·S-1 under
    `interleaved`); `minimize` appends the normal autodiff and optimizer
    ops and records the plan, schedule included, in program.meta, which
    `PipelineCompiledProgram` runs. Without cut_list and with more than
    one microbatch the gradients of `num_microbatches` runs are merged
    before one optimizer step (`distributed.CollectiveOptimizer`'s
    gradient merge), as in the reference."""

    def __init__(self, optimizer, num_microbatches=1, cut_list=None,
                 start_cpu_core_id=0, schedule="gpipe", virtual_stages=1):
        if schedule not in _sched.SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self._opt = optimizer
        self._k = int(num_microbatches)
        self._cut_list = list(cut_list or [])
        self._schedule = schedule
        self._virtual_stages = (int(virtual_stages)
                                if schedule == "interleaved" else 1)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._cut_list:
            result = self._opt.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)
            program = loss.block.program
            program.meta["pipeline"] = {
                "cut_vars": [v if isinstance(v, str) else v.name
                             for v in self._cut_list],
                "num_microbatches": self._k,
                "loss": loss.name,
                "schedule": self._schedule,
                "virtual_stages": self._virtual_stages,
            }
            return result
        if self._k <= 1:
            return self._opt.minimize(loss, startup_program,
                                      parameter_list, no_grad_set)
        from paddle_tpu_torch.distributed.fleet import CollectiveOptimizer
        from paddle_tpu_torch.distributed.strategy import (
            DistributedStrategy)
        s = DistributedStrategy()
        s.gradient_merge_steps = self._k
        return CollectiveOptimizer(self._opt, strategy=s).minimize(
            loss, startup_program, parameter_list, no_grad_set)


class PipelineCompiledProgram:
    """Executor adapter running a PipelineOptimizer-annotated Program on
    its schedule over mesh[pp_axis]: all cut tensors share one shape
    (the wire format), sections are deterministic, and section s > 0
    reads only its cut input, parameters, state and feeds.
    `schedule` / `virtual_stages` override the recorded plan."""

    def __init__(self, program, mesh, pp_axis="pp", schedule=None,
                 virtual_stages=None):
        self.program = program
        self.mesh = mesh
        self.pp_axis = pp_axis
        self.schedule = schedule
        self.virtual_stages = virtual_stages

    def with_data_parallel(self, *a, distributed_strategy=None, **kw):
        """CompiledProgram duck type: the fleet strategy's
        pipeline_schedule / pipeline_virtual_stages pick the schedule."""
        if distributed_strategy is not None:
            sched = getattr(distributed_strategy, "pipeline_schedule", None)
            if sched:
                self.schedule = sched
            v = getattr(distributed_strategy, "pipeline_virtual_stages", None)
            if v:
                self.virtual_stages = int(v)
        return self

    def cache_fingerprint(self):
        mesh = (f"{tuple(self.mesh.axis_names)}x"
                f"{tuple(self.mesh.shape.values())}")
        return (f"pp:{self.pp_axis}/sched:{self.schedule}"
                f"/vs:{self.virtual_stages}/mesh:{mesh}")

    # -- the Executor calls run() --------------------------------------
    def run(self, exe, feed=None, fetch_list=None, scope=None,
            return_numpy=True, training=None):
        from paddle_tpu_torch.core.executor import _fetch_name
        from paddle_tpu_torch.core.scope import global_scope, to_numpy
        program = self.program
        scope = scope or global_scope()
        fetch_names = [_fetch_name(f) for f in (fetch_list or [])]
        feed_vals = exe._prepare_feed(program, dict(feed or {}))
        state = {}
        for b in program.blocks:
            for v in b.vars.values():
                if v.persistable and scope.has(v.name):
                    state[v.name] = scope.tensor_on(v.name, exe.device)
        step = self.build_step(program, list(feed_vals), fetch_names,
                               sorted(state), True, exe.device)
        seed = program.random_seed * 1_000_003 + exe._step_counter
        exe._step_counter += 1
        with bind_mesh(self.mesh), torch.no_grad():
            fetches, new_state = step(state, feed_vals, seed)
        for n, v in new_state.items():
            scope.set(n, v)
        return [to_numpy(f) for f in fetches] if return_numpy else fetches

    def build_step(self, program, feed_names, fetch_names, state_names,
                   training, device=None):
        from paddle_tpu_torch.core.lowering import run_ops
        plan = program.meta.get("pipeline")
        enforce(plan is not None, "program has no pipeline plan "
                "(use PipelineOptimizer(cut_list=...).minimize)")
        cut_vars = list(plan["cut_vars"])
        M = int(plan["num_microbatches"])
        loss_name = plan["loss"]
        schedule = self.schedule or plan.get("schedule", "gpipe")
        S = self.mesh.axis_size(self.pp_axis)
        J = len(cut_vars) + 1
        if schedule == "interleaved":
            v = int(self.virtual_stages or plan.get("virtual_stages", 0)
                    or J // S)
            enforce(v >= 2 and J == v * S,
                    "interleaved pipeline: mesh %s=%d with %d sections "
                    "needs sections == virtual_stages*stages "
                    "(virtual_stages >= 2)", self.pp_axis, S, J)
        else:
            v = 1
            enforce(S == J, "mesh %s=%d but cut_list defines %d sections",
                    self.pp_axis, S, J)
        block = program.global_block()
        ops = list(block.ops)
        ad_idx = next(i for i, op in enumerate(ops)
                      if op.type == "autodiff")
        fwd_ops, ad_op = ops[:ad_idx], ops[ad_idx]
        param_names = list(ad_op.attrs["params"])
        bounds = []
        for cv in cut_vars:
            producers = [i for i, op in enumerate(fwd_ops)
                         if cv in op.output_names()]
            enforce(producers, "pipeline cut var %r is produced by no "
                    "forward op (cut_list entries must be intermediate "
                    "activations, not feeds/parameters)", cv)
            bounds.append(max(producers) + 1)
        enforce(bounds == sorted(bounds), "cut_list must be in program order")
        sections, start = [], 0
        for b in bounds + [len(fwd_ops)]:
            sections.append((start, fwd_ops[start:b]))
            start = b
        table = make_schedule(schedule, S, M, v)
        persist = sorted({var.name for b in program.blocks
                          for var in b.vars.values() if var.persistable})

        def step(state, feed, seed):
            stage = self.mesh.coord(self.pp_axis)
            ax = axis_info(self.pp_axis)
            env = dict(state)
            mb_feeds = {}
            for n in feed_names:
                a = feed[n]
                enforce(a.shape[0] % M == 0,
                        "batch %d %% microbatches %d != 0", a.shape[0], M)
                mb_feeds[n] = a.reshape((M, a.shape[0] // M)
                                        + tuple(a.shape[1:]))
            base = {n: env[n] for n in state_names if n not in param_names}
            leaves = {p: env[p].detach().requires_grad_()
                      for p in param_names}
            leaf_list = [leaves[p] for p in param_names]
            b_mb = next(iter(mb_feeds.values())).shape[1]
            cdesc = block.var(cut_vars[0]).desc
            wire = (tuple(b_mb if d == -1 else d for d in cdesc.shape),
                    cdesc.dtype, device)

            def chunk_fn(c, x, m, last):
                j = c * S + stage
                e = {**base, **leaves,
                     **{n: a[m] for n, a in mb_feeds.items()}}
                if j > 0:
                    e[cut_vars[j - 1]] = x
                off, sec = sections[j]
                run_ops(sec, block, e, seed, training, device,
                        start=off)
                if j == J - 1:
                    return e[loss_name].reshape(())
                return e[cut_vars[j]]

            # section 0 reads its feeds from the env: its fresh input is
            # an empty placeholder
            empty = torch.zeros(0, device=device)
            loss, grads, _ = _run_table(
                table, ax, stage, chunk_fn, lambda m: empty, wire,
                [leaf_list] * v)
            if loss is None:
                loss = torch.zeros((), dtype=torch.float32, device=device)
            total = [torch.zeros_like(p) for p in leaf_list]
            for gs in grads.values():
                for i, g in enumerate(gs):
                    if g is not None:
                        total[i] = total[i] + g
            env[loss_name] = all_reduce(loss, self.pp_axis).reshape(
                block.var(loss_name).desc.shape or ())
            for gname, g in zip(ad_op.outputs["Grads"], total):
                env[gname] = all_reduce(g, self.pp_axis)
            run_ops(ops[ad_idx + 1:], block, env, seed, training, device,
                    start=ad_idx + 1)
            fetches = []
            for n in fetch_names:
                enforce(n in env, "pipeline fetch %r is not the loss, a "
                        "gradient or state", n)
                fetches.append(env[n])
            return fetches, {n: env[n] for n in persist if n in env}

        return step
