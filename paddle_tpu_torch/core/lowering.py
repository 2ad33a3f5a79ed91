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

Static training is a later slice: a program holding an `autodiff` op
(static/backward.py's meta-op) raises NotImplementedError here instead of
running without its gradients.
"""
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import OpRunError, enforce
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.core.registry import OpContext, get_op

__all__ = ["run_ops", "make_step_fn", "referenced_state"]


def run_ops(ops, block, env, seed, training, device, op_index_base=0):
    """Run a straight-line op list into env."""
    for i, op in enumerate(ops):
        impl = get_op(op.type)
        ctx = OpContext(op.attrs, seed, training, op_index_base + i, device)
        try:
            args = impl.gather_inputs(op, env)
            result = impl.fn(ctx, *args)
        except OpRunError:
            raise
        except Exception as e:  # attach IR context (op_call_stack.cc parity)
            raise OpRunError(op.type, str(e), op.callsite) from e
        impl.bind_outputs(op, env, result)
    return env


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
    if any(op.type == "autodiff" for op in ops):
        raise NotImplementedError(
            "this program holds an `autodiff` op (static training: "
            "static/backward.py, optimizer/); the port runs static "
            "programs for inference only until the static-training slice "
            "ports them")
    fetch_names = list(fetch_names)
    persist_names = sorted({v.name for b in program.blocks
                            for v in b.vars.values() if v.persistable})

    def step(state, feed, seed):
        env = dict(state)
        env.update(feed)
        run_ops(ops, block, env, seed, training, device)
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
