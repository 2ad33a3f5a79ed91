"""Running a Program's block: the capture plan and the step function.

Counterpart of paddle_tpu/core/lowering.py. The JAX package lowers a
block to one pure function that XLA compiles; here a block runs by its
**capture plan** (`capture_plan`): maximal straight-line segments of ops
between the host ops, which the registry marks (`register_op(...,
host=reason)`: a `while` or `conditional_block` reading its condition, a
`py_func` callback, ...). On the card the Executor captures each graph
segment into a CUDA graph on first use and replays it after
(observability/profile.py's `LedgerJit`); on the CPU, or under
`profile.disable_capture()`, the same segments run eagerly, one op after
another, as the reference's interpreter loop does (executor.cc:451-454).

    step(state: dict, feed: dict, seed: int) -> (fetches: list, new_state: dict)

`state` holds the persistable variables the program reads and
`new_state` every persistable variable it produced (a startup program
creates its parameters this way).

`autodiff` (static/backward.py's meta-op) is expanded with
`torch.autograd.grad`, as the JAX package expands it with `jax.grad`:
the forward ops before it run once, with autograd on, over leaf copies
of the parameters (never the scope's own tensors); the gradients are
bound under the names the IR records (`w@GRAD`; zeros for a parameter
the loss does not reach, as `jax.grad` gives), and the ops after it
(regularization, clip, the optimizer's updates) run on detached values,
so nothing that reaches the fetches or the new state carries the step's
graph. The autodiff region (the forward, the gradient and the ops after
it: the whole block) is one segment: a graph, or, when it holds a host
op, one eager segment that the plan names.

Control-flow ops (`while`, `conditional_block`, `scan`) run their
sub-blocks through `ctx.run_subblock(idx, sub_env)`, as in the JAX
package: the sub-block's ops run over the enclosing environment updated
by `sub_env` (the carry, a step's inputs), so values the body only reads
(weights, outer tensors) need no declaration. A sub-block runs by its
own plan: a `while` body is one graph replayed per iteration, its carry
written back into the graph's own input buffers. A sub-block's ops draw
their randomness under the op index base `base + 1000 * (i + 1)` of the
control-flow op at position `i`, the JAX package's numbering; a `scan`
has no host read and runs inside its enclosing segment.
"""
import contextlib
import contextvars
from collections import namedtuple

import torch

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import OpRunError, enforce
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.core.registry import OpContext, get_op, host_reason

__all__ = ["Segment", "capture_plan", "run_ops", "run_block",
           "make_step_fn", "referenced_state", "op_hook"]

#: one part of a block's capture plan: ops[start:stop]; kind "graph" (a
#: straight-line run of device ops), "host" (one host op, `reason` why)
#: or "eager" (an autodiff region that holds host ops); `reads` the names
#: its ops read (their sub-blocks' too), `writes` the names they write
Segment = namedtuple("Segment", "kind start stop reason reads writes")

#: the op hook of a data-parallel step (parallel/compiler.py): while one
#: is set, forward ops run through `hook.run_op(op, impl, ctx, env)` and
#: the autodiff region's gradients through `hook.on_grads(params, grads)`,
#: the update ops after it through `hook.update_hook(params, grad_names)`
_OP_HOOK = contextvars.ContextVar("paddle_tpu_torch_op_hook", default=None)


@contextlib.contextmanager
def op_hook(hook):
    """Run the block's ops through `hook` (None: plainly) for the block."""
    token = _OP_HOOK.set(hook)
    try:
        yield hook
    finally:
        _OP_HOOK.reset(token)


def _sub_blocks(op):
    return [op.attrs[k] for k in ("sub_block", "else_block")
            if isinstance(op.attrs.get(k), int) and op.attrs[k] >= 0]


def _op_reads(program, op):
    names = set(op.input_names())
    for idx in _sub_blocks(op):
        for sub_op in program.blocks[idx].ops:
            names |= _op_reads(program, sub_op)
    return names


def _op_host_reason(program, op):
    """Why `op` needs the host: its registration's reason, or a host op
    in one of its sub-blocks (the `autodiff` meta-op is not registered:
    it needs none)."""
    if op.type == "autodiff":
        return None
    reason = host_reason(op)
    if reason:
        return reason
    for idx in _sub_blocks(op):
        for sub_op in program.blocks[idx].ops:
            inner = _op_host_reason(program, sub_op)
            if inner:
                return f"sub-block {idx} holds {sub_op.type!r} ({inner})"
    return None


def _segment(program, ops, kind, start, stop, reason=None):
    reads, writes = set(), []
    for op in ops[start:stop]:
        reads |= _op_reads(program, op)
        writes.extend(n for n in op.output_names() if n not in writes)
    return Segment(kind, start, stop, reason, frozenset(reads),
                   tuple(writes))


def capture_plan(program, block_idx=0):
    """The capture plan of one block: a tuple of Segments in op order,
    maximal straight-line "graph" segments between "host" ops; a block
    with an `autodiff` op is one segment ("eager" when it holds a host
    op, with every host op named). A pure function of the program,
    memoised per program version."""
    memo = program.__dict__.setdefault("_capture_plans", {})
    hit = memo.get((program._version, block_idx))
    if hit is not None:
        return hit
    ops = list(program.blocks[block_idx].ops)
    reasons = [_op_host_reason(program, op) for op in ops]
    plan = []
    if _find_autodiff(ops) is not None:
        hosts = [f"op {i} {ops[i].type!r}: {r}"
                 for i, r in enumerate(reasons) if r]
        plan.append(_segment(
            program, ops, "eager" if hosts else "graph", 0, len(ops),
            "the autodiff region holds host ops: " + "; ".join(hosts)
            if hosts else None))
    else:
        start = 0
        for i, r in enumerate(reasons):
            if r is None:
                continue
            if start < i:
                plan.append(_segment(program, ops, "graph", start, i))
            plan.append(_segment(program, ops, "host", i, i + 1, r))
            start = i + 1
        if start < len(ops):
            plan.append(_segment(program, ops, "graph", start, len(ops)))
    plan = tuple(plan)
    memo[(program._version, block_idx)] = plan
    return plan


def _maybe_stop_gradient(block, name, value):
    """Detach a floating value whose var the IR marks `stop_gradient`
    (the JAX package's lax.stop_gradient)."""
    if (isinstance(value, torch.Tensor) and value.requires_grad
            and block.has_var(name) and block.var(name).desc.stop_gradient
            and value.is_floating_point()):
        return value.detach()
    return value


def run_ops(ops, block, env, seed, training, device, op_index_base=0,
            rngs=None, session=None, start=0):
    """Run a straight-line op list, the block's ops from position `start`
    on, into env: op i draws under the index `op_index_base + start + i`.
    `rngs` are the step's persistent generators (registry.RunGenerators);
    `session` the capturing runner a host op's sub-blocks run through
    (None: eagerly). An op's failure is an OpRunError carrying its block
    and op index."""
    hook = _OP_HOOK.get()
    for i, op in enumerate(ops, start):
        impl = get_op(op.type)
        ctx = OpContext(op.attrs, seed, training, op_index_base + i, device,
                        block=block, rngs=rngs)
        if "sub_block" in op.attrs:
            ctx.run_subblock = _subblock_runner(
                block.program, env, seed, training, device,
                op_index_base + 1000 * (i + 1), rngs, session)
        try:
            if hook is None:
                result = impl.fn(ctx, *impl.gather_inputs(op, env))
            else:
                result = hook.run_op(op, impl, ctx, env)
        except OpRunError:
            raise
        except Exception as e:  # attach IR context (op_call_stack.cc parity)
            err = OpRunError(op.type, str(e), op.callsite)
            err.block_idx, err.op_index = block.idx, op_index_base + i
            raise err from e
        impl.bind_outputs(op, env, result)
        for n in op.output_names():
            env[n] = _maybe_stop_gradient(block, n, env[n])
        if hook is not None:
            hook.after_op(op, env)
    return env


def run_block(program, block_idx, env, seed, training, device,
              op_index_base=0, rngs=None, session=None, live=None,
              carry=(), write_back=False):
    """Run a block by its capture plan over env and return env. Without a
    `session` every segment runs eagerly; with one, each graph segment
    goes through `session.segment` (captured on first use, replayed
    after) and host ops run eagerly, their sub-blocks through the
    session. `live(segment)`: the names of a segment's writes that later
    code reads (default: all of them); `carry`: names a graph writes back
    into its own input buffers (a while body's carry); `write_back`:
    persistable results go into the session's bound state in the graph."""
    block = program.blocks[block_idx]
    ops = block.ops
    for seg in capture_plan(program, block_idx):

        def run(e, seg=seg):
            return _run_segment(program, block, seg, e, seed, training,
                                device, op_index_base, rngs)

        if session is None or seg.kind != "graph":
            env = (run(env) if seg.kind != "host" else run_ops(
                ops[seg.start:seg.stop], block, env, seed, training, device,
                op_index_base, rngs, session, seg.start))
            continue
        names = sorted(n for n in seg.reads if n in env)
        outs = seg.writes if live is None else live(seg)

        def fn(vals, run=run, outs=outs):
            e = run(dict(vals))
            return {n: e[n] for n in outs if n in e}

        env.update(session.segment(
            (block_idx, seg.start, op_index_base), fn,
            {n: env[n] for n in names}, seed, carry=carry,
            write_back=write_back))
    return env


def _run_segment(program, block, seg, env, seed, training, device, base,
                 rngs):
    """One graph or eager segment's ops, eagerly (the autodiff region
    expanded), over env; returns the environment after them. `base` is
    the block's op index base."""
    ops = block.ops[seg.start:seg.stop]
    ad_idx = _find_autodiff(ops)
    if ad_idx is None:
        return run_ops(ops, block, env, seed, training, device, base, rngs,
                       start=seg.start)
    ad_op = ops[ad_idx]
    params = list(ad_op.attrs["params"])
    loss_name = ad_op.inputs["Loss"][0]
    leaves = [env[p].detach().requires_grad_() for p in params]
    env.update(zip(params, leaves))
    with torch.enable_grad():
        run_ops(ops[:ad_idx], block, env, seed, training, device, base, rngs)
        loss = env[loss_name]
        enforce(loss.numel() == 1, "loss %r must be a scalar, got shape %s",
                loss_name, tuple(loss.shape))
        grads = _grads(loss.reshape(()), leaves)
    hook = _OP_HOOK.get()
    if hook is not None:
        grads = hook.on_grads(params, grads)
    # drop the graph: later ops, fetches and state see plain values
    env = {n: v.detach() if isinstance(v, torch.Tensor) else v
           for n, v in env.items()}
    env.update(zip(ad_op.outputs["Grads"], grads))
    # the update ops see replicated values and the rank's slices of the
    # sharded state; an op reducing over a slice runs on the whole
    upd = None if hook is None else hook.update_hook(
        params, ad_op.outputs["Grads"])
    with op_hook(upd):
        return run_ops(ops[ad_idx + 1:], block, env, seed, training,
                       device, base, rngs, start=ad_idx + 1)


def _subblock_runner(program, env, seed, training, device, op_index_base,
                     rngs, session):
    """`run_subblock(idx, sub_env, carry=())` for a control-flow op run
    over `env`: sub-block `idx` over {**env, **sub_env} by its plan,
    returning that environment."""
    def run_subblock(idx, sub_env, carry=()):
        return run_block(program, idx, {**env, **sub_env}, seed, training,
                         device, op_index_base, rngs, session, carry=carry)
    return run_subblock


def _find_autodiff(ops):
    idx = [i for i, op in enumerate(ops) if op.type == "autodiff"]
    enforce(len(idx) <= 1, "at most one autodiff op per block (got %d)",
            len(idx))
    return idx[0] if idx else None


def _grads(loss, leaves):
    """d loss / d each leaf; zeros where the loss does not reach it."""
    if not loss.requires_grad:      # every path to the loss is cut
        return [torch.zeros_like(t) for t in leaves]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, got)]


class StepFn:
    """The step function of a program's global block (make_step_fn).
    `plan` is the block's capture plan; `live(segment)` the names of a
    segment's writes that a later segment, a fetch or the new state
    reads."""

    def __init__(self, program, fetch_names, training, device):
        self.program = program
        self.fetch_names = list(fetch_names)
        self.training = training
        self.device = device
        self.block = program.global_block()
        self.plan = capture_plan(program, 0)
        self.persist_names = sorted({v.name for b in program.blocks
                                     for v in b.vars.values()
                                     if v.persistable})
        wanted = set(self.fetch_names) | set(self.persist_names)
        self._live = {}
        for i, seg in enumerate(self.plan):
            later = set(wanted)
            for s in self.plan[i + 1:]:
                later |= s.reads
            self._live[seg.start] = tuple(n for n in seg.writes
                                          if n in later)

    def live(self, seg):
        return self._live[seg.start]

    def __call__(self, state, feed, seed, rngs=None, session=None):
        block = self.block
        env = dict(state)
        for n, v in feed.items():
            env[n] = _maybe_stop_gradient(block, n, v)
        env = run_block(self.program, 0, env, seed, self.training,
                        self.device, rngs=rngs, session=session,
                        live=self.live,
                        write_back=session is not None and self.training)
        fetches = []
        for n in self.fetch_names:
            enforce(n in env, "fetch target %r was not produced by the "
                    "program", n)
            fetches.append(env[n])
        new_state = {n: env[n] for n in self.persist_names if n in env}
        return fetches, new_state


def make_step_fn(program, feed_names, fetch_names, state_names,
                 training=True, device=None):
    """The step function of a program's global block on `device` (None:
    the GPU, through `places.resolve_device`, which raises where none is
    visible): a StepFn, `step(state, feed, seed)`."""
    device = resolve_device(device)
    if _flags.get_flag("verify_program"):
        from paddle_tpu_torch.analysis import verify_program
        verify_program(program, label="make_step_fn")
    return StepFn(program, fetch_names, training, device)


def referenced_state(program, scope):
    """Names of persistable vars the program declares that live in the
    scope — the state the step reads."""
    names = []
    for b in program.blocks:
        for v in b.vars.values():
            if v.persistable and scope.has(v.name):
                names.append(v.name)
    return sorted(set(names))
