"""Autodiff as a program transform.

Counterpart of paddle_tpu/static/backward.py (the reference's
backward.py:933 `append_backward`). As in the JAX package, no per-op
gradient ops are emitted: `append_backward` appends ONE `autodiff`
meta-op (role backward) that records the loss, the trainable parameters
and the length of the forward segment, and core/lowering.py expands it
with `torch.autograd.grad` over that segment. Gradient variables keep
the `<param>@GRAD` names, so a program built in either package has the
same op list and the same var names.
"""
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import OpRole, default_main_program

__all__ = ["GRAD_SUFFIX", "grad_var_name", "append_backward", "gradients"]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_SUFFIX


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    checkpoints=None, program=None):
    """Append the backward transform for `loss`. Returns a list of
    (param Variable, grad Variable). The parameters are the program's
    trainable ones that do not stop the gradient, in
    `program.all_parameters()` order, unless `parameter_list` names
    them; `checkpoints` are recorded on the op."""
    program = program or default_main_program()
    block = program.global_block()
    no_grad = set(no_grad_set or ())

    if parameter_list:
        params = [p if isinstance(p, str) else p.name for p in parameter_list]
    else:
        params = [v.name for v in program.all_parameters()
                  if v.desc.trainable and not v.desc.stop_gradient]
    params = [p for p in params if p not in no_grad]
    enforce(params, "no trainable parameters found for backward")

    fwd_count = len(block.ops)
    grad_names = []
    for p in params:
        pv = block.var(p).desc
        g = block.create_var(name=grad_var_name(p), shape=pv.shape,
                             dtype=pv.dtype, stop_gradient=True)
        grad_names.append(g.name)

    loss_name = loss if isinstance(loss, str) else loss.name
    with program.op_role_guard(OpRole.BACKWARD):
        block.append_op(
            "autodiff", {"Loss": [loss_name]}, {"Grads": grad_names},
            {"params": params, "forward_op_count": fwd_count,
             "checkpoints": list(checkpoints or [])})
    program.meta["loss"] = loss_name
    return [(block.var(p), block.var(g)) for p, g in zip(params, grad_names)]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients for a scalar target, through append_backward."""
    t = targets[0] if isinstance(targets, (list, tuple)) else targets
    pg = append_backward(t, parameter_list=inputs, no_grad_set=no_grad_set)
    return [g for _, g in pg]
