"""Control-flow ops: while, conditional_block, scan, the tensor arrays,
feed and fetch.

Counterpart of paddle_tpu/ops/control_flow.py, with its slots and
attrs. The JAX package lowers a sub-block to `lax.while_loop` /
`lax.cond` / `lax.scan`; here the sub-block's ops run eagerly through
`ctx.run_subblock` (core/lowering.py), once an iteration, a branch or a
time step. Where the two differ:

* `while` reads its condition on the host once an iteration (and
  `conditional_block` its predicate once): a scalar `.item()`, the one
  device-to-host read of these ops (`host_reads` counts them). The JAX
  package's loop stays on the device.
* The carry stays shape-stable, `lax.while_loop`'s rule: an iteration
  that changes a carried var's shape or dtype raises.
* Reverse-mode differentiation through `while` raises when a gradient
  reaches the loop's carry, as `jax.grad` does over `lax.while_loop`;
  `scan` (StaticRNN, DynamicRNN) and `conditional_block` differentiate.
* On meta tensors (shape inference) no value is read: `while` runs its
  body once and checks that the carry's shapes hold,
  `conditional_block` runs both branches and checks that their outputs
  agree (`lax.cond`'s rule), `scan` runs one step.

Tensor arrays are preallocated [T, ...] buffers; `tensor_array_write`
writes out of place (`index_copy`), so a tensor that another name or a
fetch holds is never changed under it.
"""
import time

import torch

from paddle_tpu_torch.core.enforce import OpRunError, enforce
from paddle_tpu_torch.core.registry import register_op

__all__ = ["host_reads", "reset_host_reads"]

#: condition reads on the host by op type, the while loops' iterations
#: and the seconds the host waited in the reads (the device finishing
#: the work queued before each): what chip_smoke's phase 21 reports
host_reads = {"while": 0, "while_iterations": 0, "conditional_block": 0,
              "wait_s": 0.0}


def reset_host_reads():
    for k in host_reads:
        host_reads[k] = type(host_reads[k])(0)


def _scalar_bool(t, op_type):
    enforce(t.numel() == 1, "%s: condition must hold one value, got shape "
            "%s", op_type, tuple(t.shape))
    host_reads[op_type] += 1
    t0 = time.perf_counter()
    value = bool(t.reshape(()).item())
    host_reads["wait_s"] += time.perf_counter() - t0
    return value


def _check_same(kind, names, before, after):
    for n, a, b in zip(names, before, after):
        enforce(tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype,
                "%s changed %r from %s %s to %s %s (the carry must keep its "
                "shape and dtype)", kind, n, tuple(a.shape), a.dtype,
                tuple(b.shape), b.dtype)


class _NoReverseMode(torch.autograd.Function):
    """Identity forward; a gradient arriving here raises (jax.grad over
    lax.while_loop)."""

    @staticmethod
    def forward(ctx, names, *xs):
        ctx.names = names
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        raise OpRunError(
            "while", "reverse-mode differentiation does not work for a "
            "while loop (the JAX package's lax.while_loop raises the same): "
            f"the loss depends on a parameter through the carried vars "
            f"{ctx.names}; StaticRNN / DynamicRNN (scan) differentiate")


def _guard_reverse_mode(names, vals):
    idx = [i for i, v in enumerate(vals)
           if torch.is_grad_enabled() and v.requires_grad]
    if not idx:
        return vals
    guarded = _NoReverseMode.apply([names[i] for i in idx],
                                   *[vals[i] for i in idx])
    out = list(vals)
    for i, g in zip(idx, guarded):
        out[i] = g
    return out


@register_op("while", inputs=["Condition", "Carry[]"], outputs=["CarryOut[]"])
def _while(ctx, cond0, carry):
    """while_op.cc: run the sub-block while the condition holds; the
    sub-block computes the new carry and the new condition (attr
    cond_var, itself carried)."""
    sub_idx = ctx.attr("sub_block")
    carry_names = list(ctx.attr("carry_vars"))
    cond_name = ctx.attr("cond_var")
    vals = list(carry)
    if ctx.device.type == "meta":
        env = ctx.run_subblock(sub_idx, dict(zip(carry_names, vals)))
        _check_same("a while iteration", carry_names, vals,
                    [env[n] for n in carry_names])
        return (vals,)
    cond = cond0
    it = 0
    while _scalar_bool(cond, "while"):
        env = ctx.run_subblock(sub_idx, dict(zip(carry_names, vals)))
        new = [env[n] for n in carry_names]
        _check_same(f"while iteration {it}", carry_names, vals, new)
        vals, cond = new, env[cond_name]
        it += 1
    host_reads["while_iterations"] += it
    return (_guard_reverse_mode(carry_names, vals),)


@register_op("conditional_block", inputs=["Cond", "Input[]"],
             outputs=["Out[]"])
def _conditional_block(ctx, cond, inputs):
    """conditional_block_op.cc: the sub-block when Cond holds, else the
    else-block (attr else_block) or the inputs unchanged."""
    sub_idx = ctx.attr("sub_block")
    else_idx = ctx.attr("else_block", -1)
    in_names = list(ctx.attr("input_vars"))
    out_names = list(ctx.attr("output_vars"))

    def run_block(idx, vals):
        if idx < 0:
            enforce(len(out_names) == len(in_names),
                    "conditional_block without else requires outputs to "
                    "mirror inputs")
            return list(vals)
        env = ctx.run_subblock(idx, dict(zip(in_names, vals)))
        return [env[n] for n in out_names]

    if ctx.device.type == "meta":
        taken = run_block(sub_idx, inputs)
        _check_same("conditional_block's else branch", out_names, taken,
                    run_block(else_idx, inputs))
        return (taken,)
    idx = sub_idx if _scalar_bool(cond, "conditional_block") else else_idx
    return (run_block(idx, inputs),)


@register_op("scan", inputs=["Xs[]", "Init[]"],
             outputs=["YsOut[]", "CarryOut[]"])
def _scan(ctx, xs, init):
    """StaticRNN / recurrent_op.cc: the sub-block once per step of the
    time axis (0) of Xs, carrying carry_vars; YsOut stacks y_vars.
    is_reverse walks the steps backwards (ys keep their step's place)."""
    sub_idx = ctx.attr("sub_block")
    x_names = list(ctx.attr("x_vars"))
    carry_names = list(ctx.attr("carry_vars"))
    y_names = list(ctx.attr("y_vars"))
    reverse = ctx.attr("is_reverse", False)
    enforce(xs, "scan needs at least one per-step input")
    t = xs[0].shape[0]
    carry = list(init)
    meta = ctx.device.type == "meta"
    order = range(t - 1, -1, -1) if reverse else range(t)
    ys = {}
    for i in ([0] if meta else order):
        env = dict(zip(carry_names, carry))
        env.update(zip(x_names, [x[i] for x in xs]))
        env = ctx.run_subblock(sub_idx, env)
        new = [env[n] for n in carry_names]
        _check_same(f"scan step {i}", carry_names, carry, new)
        carry = new
        ys[i] = [env[n] for n in y_names]
    if meta:
        stacked = [y[None].expand((t,) + tuple(y.shape)) for y in ys[0]]
    else:
        stacked = [torch.stack([ys[i][j] for i in range(t)])
                   for j in range(len(y_names))]
    return stacked, carry


def _index(i):
    return i.reshape(1).to(torch.int64)


@register_op("tensor_array_write", inputs=["Array", "X", "I"],
             outputs=["Out"])
def _ta_write(ctx, arr, x, i):
    """write_to_array_op on a preallocated [T, ...] buffer: a new array
    with row i set to x (out of place)."""
    return arr.index_copy(0, _index(i), x.unsqueeze(0))


@register_op("tensor_array_read", inputs=["Array", "I"], outputs=["Out"])
def _ta_read(ctx, arr, i):
    return arr.index_select(0, _index(i))[0]


@register_op("feed", inputs=["X"], outputs=["Out"])
def _feed(ctx, x):
    """feed_op.cc: identity (feeds are the step's arguments)."""
    return x


@register_op("fetch", inputs=["X"], outputs=["Out"])
def _fetch(ctx, x):
    return x
