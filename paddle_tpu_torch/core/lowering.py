"""Running a Program's block: the step function.

Counterpart of paddle_tpu/core/lowering.py. The JAX package lowers a
block to one pure function that XLA compiles; here the step function
runs the ops eagerly, one after another, as the reference's interpreter
loop does (executor.cc:451-454): each op's registered PyTorch function on
tensors of the executor's device.

    step(state: dict, feed: dict, seed: int) -> (fetches: list, new_state: dict)

`state` holds the persistable variables the program reads and
`new_state` every persistable variable it produced (a startup program
creates its parameters this way).

`autodiff` (static/backward.py's meta-op) is expanded with
`torch.autograd.grad`, as the JAX package expands it with `jax.grad`:
the forward segment before it runs once, with autograd on, over leaf
copies of the parameters (never the scope's own tensors); the gradients
are bound under the names the IR records (`w@GRAD`; zeros for a
parameter the loss does not reach, as `jax.grad` gives), and the ops
after it (regularization, clip, the optimizer's updates) run on detached
values, so nothing that reaches the fetches or the new state carries
the step's graph.

Control-flow ops (`while`, `conditional_block`, `scan`) run their
sub-blocks through `ctx.run_subblock(idx, sub_env)`, as in the JAX
package: the sub-block's ops run over the enclosing environment updated
by `sub_env` (the carry, a step's inputs), so values the body only reads
(weights, outer tensors) need no declaration. A sub-block's ops draw
their randomness under the op index base `base + 1000 * (i + 1)` of the
control-flow op at position `i`, the JAX package's numbering. The loops
run eagerly on the host: `while` reads its condition once an iteration
(ops/control_flow.py).
"""
import torch

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import OpRunError, enforce
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.core.registry import OpContext, get_op

__all__ = ["run_ops", "make_step_fn", "referenced_state"]


def _maybe_stop_gradient(block, name, value):
    """Detach a floating value whose var the IR marks `stop_gradient`
    (the JAX package's lax.stop_gradient)."""
    if (isinstance(value, torch.Tensor) and value.requires_grad
            and block.has_var(name) and block.var(name).desc.stop_gradient
            and value.is_floating_point()):
        return value.detach()
    return value


def run_ops(ops, block, env, seed, training, device, op_index_base=0):
    """Run a straight-line op list into env."""
    for i, op in enumerate(ops):
        impl = get_op(op.type)
        ctx = OpContext(op.attrs, seed, training, op_index_base + i, device,
                        block=block)
        if "sub_block" in op.attrs:
            ctx.run_subblock = _subblock_runner(
                block.program, env, seed, training, device,
                op_index_base + 1000 * (i + 1))
        try:
            args = impl.gather_inputs(op, env)
            result = impl.fn(ctx, *args)
        except OpRunError:
            raise
        except Exception as e:  # attach IR context (op_call_stack.cc parity)
            raise OpRunError(op.type, str(e), op.callsite) from e
        impl.bind_outputs(op, env, result)
        for n in op.output_names():
            env[n] = _maybe_stop_gradient(block, n, env[n])
    return env


def _subblock_runner(program, env, seed, training, device, op_index_base):
    """`run_subblock(idx, sub_env)` for a control-flow op run over `env`:
    sub-block `idx` over {**env, **sub_env}, returning that environment."""
    def run_subblock(idx, sub_env):
        sub = program.blocks[idx]
        return run_ops(sub.ops, sub, {**env, **sub_env}, seed, training,
                       device, op_index_base)
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


def make_step_fn(program, feed_names, fetch_names, state_names,
                 training=True, device=None):
    """The step function of a program's global block on `device` (None:
    the GPU, through `places.resolve_device`, which raises where none is
    visible)."""
    device = resolve_device(device)
    if _flags.get_flag("verify_program"):
        from paddle_tpu_torch.analysis import verify_program
        verify_program(program, label="make_step_fn")
    block = program.global_block()
    ops = list(block.ops)
    ad_idx = _find_autodiff(ops)
    fetch_names = list(fetch_names)
    persist_names = sorted({v.name for b in program.blocks
                            for v in b.vars.values() if v.persistable})

    def step(state, feed, seed):
        env = dict(state)
        for n, v in feed.items():
            env[n] = _maybe_stop_gradient(block, n, v)
        if ad_idx is None:
            run_ops(ops, block, env, seed, training, device)
        else:
            ad_op = ops[ad_idx]
            params = list(ad_op.attrs["params"])
            loss_name = ad_op.inputs["Loss"][0]
            leaves = [env[p].detach().requires_grad_() for p in params]
            env.update(zip(params, leaves))
            with torch.enable_grad():
                run_ops(ops[:ad_idx], block, env, seed, training, device)
                loss = env[loss_name]
                enforce(loss.numel() == 1, "loss %r must be a scalar, got "
                        "shape %s", loss_name, tuple(loss.shape))
                grads = _grads(loss.reshape(()), leaves)
            # drop the graph: later ops, fetches and state see plain values
            env = {n: v.detach() if isinstance(v, torch.Tensor) else v
                   for n, v in env.items()}
            env.update(zip(ad_op.outputs["Grads"], grads))
            run_ops(ops[ad_idx + 1:], block, env, seed, training, device,
                    op_index_base=ad_idx + 1)
        fetches = []
        for n in fetch_names:
            enforce(n in env, "fetch target %r was not produced by the "
                    "program", n)
            fetches.append(env[n])
        new_state = {n: env[n] for n in persist_names if n in env}
        return fetches, new_state

    return step


def referenced_state(program, scope):
    """Names of persistable vars the program declares that live in the
    scope — the state the step reads."""
    names = []
    for b in program.blocks:
        for v in b.vars.values():
            if v.persistable and scope.has(v.name):
                names.append(v.name)
    return sorted(set(names))
