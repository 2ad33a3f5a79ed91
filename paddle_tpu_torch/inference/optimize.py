"""Inference-graph optimization passes (export time).

Counterpart of paddle_tpu/inference/optimize.py (the reference's
paddle_pass_builder.cc:155 pass list: conv_bn_fuse_pass, fc_fuse_pass,
constant folding, ...). The passes run once at export on the saved
Program and its params ({name: numpy array}); the Predictor serves the
optimized graph. The arithmetic is the JAX package's (float64 host math
for the BN fold), so both packages export the same artifact.

Safety rules shared by every pass:
  * a pattern fires only when the intermediate value has exactly ONE
    consumer across ALL blocks;
  * a var that is ever re-bound (written by a second op) is never folded
    into a parameter;
  * fetch targets are never renamed away.
"""
import numpy as np
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.core.registry import OpContext, get_op
from paddle_tpu_torch.core.scope import to_numpy

__all__ = ["optimize_inference_program", "fold_conv_bn", "fuse_conv_act",
           "fuse_fc", "fold_constants", "elide_transpose_reshape"]

# ops evaluated at export by fold_constants — pure, feed-independent,
# rng-free
_FOLDABLE = frozenset({
    "fill_constant", "assign_value", "range", "linspace", "cast",
    "reshape", "reshape2", "transpose", "transpose2", "unsqueeze",
    "unsqueeze2", "squeeze", "squeeze2", "concat", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div", "scale",
    "expand", "assign", "zeros_like", "ones_like", "shape", "one_hot",
})
_FOLD_MAX_ELEMS = 1 << 20

_CONV_ACTS = ("relu", "relu6", "sigmoid", "tanh")
_FC_ACTS = ("relu", "sigmoid", "tanh", "softmax")


def _all_ops(program):
    for b in program.blocks:
        yield from b.ops


def _consumer_counts(program):
    counts = {}
    for op in _all_ops(program):
        for n in op.input_names():
            counts[n] = counts.get(n, 0) + 1
    return counts


def _writer_counts(program):
    counts = {}
    for op in _all_ops(program):
        for n in op.output_names():
            counts[n] = counts.get(n, 0) + 1
    return counts


def _fetches(program):
    return set(program.meta.get("fetch_targets", []))


def optimize_inference_program(program, params, verify=True):
    """Run the export pass list. `params` is {name: np.ndarray} (detached
    from the live scope); returns (program, params) with block 0's op
    list and the parameter values rewritten. With verify=True the
    verifier runs before and after the pipeline."""
    from paddle_tpu_torch.analysis import verify_program
    if verify:
        verify_program(program, label="pre-optimize", params=params)
    fold_constants(program, params)
    fold_conv_bn(program, params)
    fuse_conv_act(program)
    fuse_fc(program)
    elide_transpose_reshape(program)
    _prune_unused_params(program, params)
    _prune_unused_vars(program)
    if verify:
        verify_program(program, label="post-optimize", params=params)
    return program, params


def fold_conv_bn(program, params):
    """conv2d → batch_norm (inference) folded into the conv's Filter/Bias
    (conv_bn_fuse_pass.cc: W' = W·γ/σ per output channel,
    b' = β + (b − μ)·γ/σ)."""
    block = program.global_block()
    consumers = _consumer_counts(program)
    writers = _writer_counts(program)
    ops = block.ops
    removed = set()
    for i, op in enumerate(ops):
        if op.type not in ("conv2d", "depthwise_conv2d"):
            continue
        out_name = op.outputs.get("Output", [None])[0]
        if out_name is None or consumers.get(out_name, 0) != 1:
            continue
        if writers.get(out_name, 0) != 1 or out_name in _fetches(program):
            continue
        bn = next((o for o in ops[i + 1:] if out_name in o.input_names()),
                  None)
        if bn is None or bn.type != "batch_norm":
            continue
        if bn.inputs.get("X", [None])[0] != out_name:
            continue
        names = {s: bn.inputs.get(s, [None])[0]
                 for s in ("Scale", "Bias", "Mean", "Variance")}
        if any(n not in params for n in names.values()):
            continue
        # a Filter/Bias shared with another op must not be rewritten
        w_name = op.inputs["Filter"][0]
        if any(consumers.get(n, 0) > 1
               for n in [w_name] + op.inputs.get("Bias", [])):
            continue
        y_name = bn.outputs["Y"][0]
        if writers.get(y_name, 0) != 1:
            continue
        eps = bn.attrs.get("epsilon", 1e-5)
        gamma = params[names["Scale"]].astype(np.float64)
        beta = params[names["Bias"]].astype(np.float64)
        mean = params[names["Mean"]].astype(np.float64)
        var = params[names["Variance"]].astype(np.float64)
        g = gamma / np.sqrt(var + eps)

        w = params[w_name]
        params[w_name] = (w.astype(np.float64)
                          * g.reshape(-1, 1, 1, 1)).astype(w.dtype)
        b_names = op.inputs.get("Bias", [])
        if b_names:
            b_old = params[b_names[0]].astype(np.float64)
            params[b_names[0]] = (beta + (b_old - mean) * g).astype(w.dtype)
        else:
            nb_name = y_name + "__bnfold_b"
            params[nb_name] = (beta - mean * g).astype(w.dtype)
            block.create_var(name=nb_name, shape=(g.size,),
                             dtype=str(w.dtype), persistable=True)
            op.inputs["Bias"] = [nb_name]
        op.outputs["Output"] = [y_name]
        removed.add(id(bn))
    if removed:
        block.ops[:] = [o for o in block.ops if id(o) not in removed]


def fuse_conv_act(program):
    """conv2d + {relu, relu6, sigmoid, tanh} → the conv's
    `fuse_activation` attr."""
    block = program.global_block()
    consumers = _consumer_counts(program)
    writers = _writer_counts(program)
    ops = block.ops
    removed = set()
    for i, op in enumerate(ops):
        if op.type not in ("conv2d", "depthwise_conv2d"):
            continue
        if op.attrs.get("fuse_activation"):
            continue
        out_name = op.outputs.get("Output", [None])[0]
        if out_name is None or consumers.get(out_name, 0) != 1:
            continue
        if writers.get(out_name, 0) != 1 or out_name in _fetches(program):
            continue
        act = next((o for o in ops[i + 1:] if out_name in o.input_names()),
                   None)
        if act is None or act.type not in _CONV_ACTS:
            continue
        y_name = act.outputs["Out"][0]
        if writers.get(y_name, 0) != 1:
            continue
        op.attrs["fuse_activation"] = act.type
        op.outputs["Output"] = [y_name]
        removed.add(id(act))
    if removed:
        block.ops[:] = [o for o in block.ops if id(o) not in removed]


def fuse_fc(program):
    """mul + elementwise_add(bias) [+ activation] → one `fc` op
    (fc_fuse_pass.cc)."""
    block = program.global_block()
    ops = block.ops
    changed = True
    while changed:
        changed = False
        consumers = _consumer_counts(program)
        writers = _writer_counts(program)
        fetches = _fetches(program)
        for i, op in enumerate(ops):
            if op.type != "mul" or op.attrs.get("y_num_col_dims", 1) != 1:
                continue
            if op.attrs.get("quantization_type"):
                continue  # a QAT-marked mul stays visible to the freeze pass
            mul_out = op.outputs["Out"][0]
            if consumers.get(mul_out, 0) != 1 or \
                    writers.get(mul_out, 0) != 1 or mul_out in fetches:
                continue
            add = next((o for o in ops[i + 1:]
                        if mul_out in o.input_names()), None)
            if add is None or add.type != "elementwise_add":
                continue
            if add.inputs.get("X", [None])[0] != mul_out:
                continue
            # the add's Y must be an fc bias: a parameter of size
            # W.shape[1] — a residual add must not fuse
            b_name = add.inputs.get("Y", [None])[0]
            bvar = (block.var(b_name).desc if b_name is not None
                    and block.has_var(b_name) else None)
            if bvar is None or not bvar.is_parameter:
                continue
            w_name = op.inputs["Y"][0]
            wvar = block.var(w_name).desc if block.has_var(w_name) else None
            bshape = [d for d in (bvar.shape or []) if d != 1]
            if wvar is None or wvar.shape is None or len(bshape) != 1 or \
                    bshape[0] != wvar.shape[-1]:
                continue
            ncol = op.attrs.get("x_num_col_dims", 1)
            if add.attrs.get("axis", -1) not in (ncol, -1):
                continue
            out_name = add.outputs["Out"][0]
            if writers.get(out_name, 0) != 1:
                continue
            activation = ""
            last = add
            if consumers.get(out_name, 0) == 1 and out_name not in fetches:
                act = next((o for o in ops if out_name in o.input_names()
                            and o is not add), None)
                if act is not None and act.type in _FC_ACTS:
                    if act.type != "softmax" or act.attrs.get("axis", -1) == -1:
                        activation = act.type
                        last = act
                        out_name = act.outputs["Out"][0]
            if writers.get(out_name, 0) != 1:
                continue
            fc = type(op)(
                "fc",
                {"Input": [op.inputs["X"][0]], "W": [op.inputs["Y"][0]],
                 "Bias": [add.inputs["Y"][0]]},
                {"Out": [out_name]},
                {"in_num_col_dims": ncol, "activation": activation},
                role=op.role)
            idx = ops.index(op)
            drop = {id(op), id(add), id(last)}
            block.ops[:] = (ops[:idx] + [fc]
                            + [o for o in ops[idx + 1:] if id(o) not in drop])
            ops = block.ops
            changed = True
            break


def fold_constants(program, params):
    """Evaluate feed-independent ops at export, on CPU tensors; their
    outputs become parameters. Folding is best-effort: an op whose
    evaluation fails stays in the program."""
    block = program.global_block()
    writers = _writer_counts(program)
    fetches = _fetches(program)
    known = set(params)
    env = {}
    folded_ops = set()
    new_params = {}
    for op in block.ops:
        if op.type not in _FOLDABLE:
            continue
        if any(n not in known for n in op.input_names()):
            continue
        outs = op.output_names()
        # a name written more than once is loop state, not a constant; a
        # fetch must stay a produced var
        if any(writers.get(n, 0) != 1 or n in fetches for n in outs):
            continue
        for n in op.input_names():
            if n not in env:
                env[n] = torch.from_numpy(np.array(params[n], copy=True))
        try:
            impl = get_op(op.type)
            ctx = OpContext(op.attrs, None, False, 0, device="cpu")
            result = impl.fn(ctx, *impl.gather_inputs(op, env))
            impl.bind_outputs(op, env, result)
        except (EnforceError, RuntimeError, ValueError, TypeError,
                KeyError):
            continue  # leave the op in place
        vals = {n: to_numpy(env[n]) for n in outs}
        if any(v.size > _FOLD_MAX_ELEMS for v in vals.values()):
            continue
        new_params.update(vals)
        known.update(outs)
        folded_ops.add(id(op))
    if not folded_ops:
        return
    block.ops[:] = [o for o in block.ops if id(o) not in folded_ops]
    for n, v in new_params.items():
        params[n] = v
        if block.has_var(n):
            block.var(n).desc.persistable = True
        else:
            block.create_var(name=n, shape=v.shape, dtype=str(v.dtype),
                             persistable=True)


def _prune_unused_params(program, params):
    """Drop params no op references anymore (folded BN stats etc.)."""
    referenced = set()
    for op in _all_ops(program):
        referenced.update(op.input_names())
        referenced.update(op.output_names())
    for n in list(params):
        if n not in referenced:
            del params[n]


def _prune_unused_vars(program):
    """Drop block-0 VarDescs no op references anymore (the fuse passes
    rewire outputs past intermediates). Persistable/data vars and
    feed/fetch targets always survive."""
    block = program.global_block()
    referenced = set(program.meta.get("feed_targets", []))
    referenced |= set(program.meta.get("fetch_targets", []))
    for op in _all_ops(program):
        referenced |= set(op.input_names()) | set(op.output_names())
        for attr in ("carry_vars", "x_vars", "y_vars", "input_vars",
                     "output_vars", "cond_var"):
            v = op.attrs.get(attr)
            if isinstance(v, str):
                referenced.add(v)
            elif isinstance(v, (list, tuple)):
                referenced.update(v)
    block.vars = {k: v for k, v in block.vars.items()
                  if k in referenced or v.persistable or v.is_data}


def elide_transpose_reshape(program):
    """transpose∘transpose composing to identity → assign; reshape into
    reshape → one reshape. Conservative: adjacent-in-dataflow pairs with a
    single-consumer, write-once intermediate."""
    block = program.global_block()
    writers = _writer_counts(program)
    fetches = _fetches(program)
    changed = True
    while changed:
        changed = False
        consumers = _consumer_counts(program)
        ops = block.ops
        for i, op in enumerate(ops):
            if op.type not in ("transpose", "transpose2", "reshape",
                               "reshape2"):
                continue
            mid = op.outputs["Out"][0]
            if consumers.get(mid, 0) != 1 or writers.get(mid, 0) != 1 or \
                    mid in fetches:
                continue
            nxt = next((o for o in ops[i + 1:] if mid in o.input_names()),
                       None)
            if nxt is None or nxt.inputs.get("X", [None])[0] != mid:
                continue
            kind = "transpose" if op.type.startswith("transpose") \
                else "reshape"
            if not nxt.type.startswith(kind):
                continue
            out_name = nxt.outputs["Out"][0]
            if writers.get(out_name, 0) != 1:
                continue
            if kind == "transpose":
                p1 = list(op.attrs.get("axis") or op.attrs.get("perm") or [])
                p2 = list(nxt.attrs.get("axis") or nxt.attrs.get("perm")
                          or [])
                if not p1 or not p2:
                    continue  # implicit-reverse transposes: rank unknown
                if len(p1) != len(p2) or \
                        [p1[a] for a in p2] != list(range(len(p1))):
                    continue  # only the identity composition is elided
                rewrite = type(op)("assign", {"X": [op.inputs["X"][0]]},
                                   {"Out": [out_name]}, {}, role=op.role)
            else:
                shape = nxt.attrs.get("shape")
                if not shape or any(d == 0 for d in shape):
                    continue  # 0-dims copy from the INTERMEDIATE shape
                rewrite = type(op)("reshape", {"X": [op.inputs["X"][0]]},
                                   {"Out": [out_name]},
                                   {"shape": list(shape)}, role=op.role)
            idx = ops.index(op)
            drop = {id(op), id(nxt)}
            block.ops[:] = (ops[:idx] + [rewrite]
                            + [o for o in ops[idx + 1:] if id(o) not in drop])
            changed = True
            break
