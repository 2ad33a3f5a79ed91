"""Operator registry.

Counterpart of paddle_tpu/core/registry.py (the reference's
REGISTER_OPERATOR / REGISTER_OP_*_KERNEL, op_registry.h:199). An op
implementation is one PyTorch function `fn(ctx, *inputs) -> outputs`
registered under the JAX package's op type and slot names; the Executor
calls it eagerly on tensors of its device.

Slot-spec syntax for register_op(inputs=[...], outputs=[...]):
    "X"     required single variable
    "X?"    optional single variable (compute receives None when absent)
    "X[]"   variadic list of variables (compute receives a list)

Construction-time shape inference (`infer_shapes`) runs an op's function
on `device="meta"` tensors, which carry shape and dtype but no data —
the counterpart of the JAX package's `jax.eval_shape`.

The op library registers itself on first lookup (`_load_op_library`), so
a program loaded from disk runs without its builders being imported.
"""
import importlib

import torch

from paddle_tpu_torch.core.enforce import OpRunError, enforce

__all__ = ["OpContext", "OpImpl", "register_op", "get_op", "has_op",
           "registered_ops", "infer_shapes", "op_generator"]

_OPS = {}

#: the modules that register ops, imported on the first registry lookup
_OP_MODULES = ("paddle_tpu_torch.ops.tensor", "paddle_tpu_torch.ops.random",
               "paddle_tpu_torch.ops.math", "paddle_tpu_torch.ops.nn",
               "paddle_tpu_torch.ops.metrics", "paddle_tpu_torch.ops.fused",
               "paddle_tpu_torch.slim.quant_ops")
_loaded = [False]


def _load_op_library():
    if not _loaded[0]:
        _loaded[0] = True
        for name in _OP_MODULES:
            importlib.import_module(name)


def op_generator(seed, op_index, device):
    """The torch.Generator of one op in one run: seeded from the run's
    seed and the op's index (the JAX package folds the op index into the
    run's PRNG key), so a program's randomness is reproducible."""
    mixed = (int(seed) * 1_000_003 + int(op_index) * 7_919) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


class OpContext:
    """Per-op context handed to compute functions: attrs, the run's
    randomness, the mode, and the device new tensors are made on."""

    __slots__ = ("attrs", "_seed", "training", "op_index", "device")

    def __init__(self, attrs, seed, training, op_index, device=None):
        self.attrs = attrs
        self._seed = seed
        self.training = training
        self.op_index = op_index
        self.device = torch.device(device or "cpu")

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rng(self):
        """A torch.Generator for this op, seeded from the run's seed and
        the op index."""
        enforce(self._seed is not None,
                "op requested randomness but no seed was provided")
        return op_generator(self._seed, self.op_index, self.device)


class _Slot:
    __slots__ = ("name", "optional", "variadic")

    def __init__(self, spec):
        self.optional = spec.endswith("?")
        self.variadic = spec.endswith("[]")
        self.name = spec[:-2] if self.variadic else spec.rstrip("?")


class OpImpl:
    def __init__(self, type_, fn, in_slots, out_slots):
        self.type = type_
        self.fn = fn
        self.in_slots = [_Slot(s) for s in in_slots]
        self.out_slots = [_Slot(s) for s in out_slots]

    def gather_inputs(self, op_desc, env):
        """Map an OpDesc's named input slots to positional compute args."""
        args = []
        for slot in self.in_slots:
            names = op_desc.inputs.get(slot.name, [])
            if slot.variadic:
                args.append([env[n] for n in names])
            elif not names:
                enforce(slot.optional, "op %s missing required input slot %s",
                        self.type, slot.name)
                args.append(None)
            else:
                args.append(env[names[0]])
        return args

    def bind_outputs(self, op_desc, env, result):
        """Write compute results back into the environment by slot order."""
        if not isinstance(result, (tuple, list)):
            result = (result,)
        ri = 0
        for slot in self.out_slots:
            names = op_desc.outputs.get(slot.name, [])
            if slot.variadic:
                vals = result[ri]
                ri += 1
                enforce(len(vals) == len(names),
                        "op %s slot %s produced %d values for %d names",
                        self.type, slot.name, len(vals), len(names))
                for n, v in zip(names, vals):
                    env[n] = v
            else:
                if not names:
                    enforce(slot.optional, "op %s missing output slot %s",
                            self.type, slot.name)
                    ri += 1
                    continue
                env[names[0]] = result[ri]
                ri += 1


def register_op(type_, inputs, outputs):
    """Decorator: register `fn(ctx, *inputs) -> outputs` under `type_`."""

    def deco(fn):
        enforce(type_ not in _OPS, "op %r registered twice", type_)
        _OPS[type_] = OpImpl(type_, fn, inputs, outputs)
        return fn

    return deco


def get_op(type_):
    _load_op_library()
    enforce(type_ in _OPS, "op %r is not registered (registered: %d ops)",
            type_, len(_OPS))
    return _OPS[type_]


def has_op(type_):
    _load_op_library()
    return type_ in _OPS


def registered_ops():
    _load_op_library()
    return sorted(_OPS)


# ---------------------------------------------------------------------------
# construction-time shape inference
# ---------------------------------------------------------------------------

#: stands in for a -1 (dynamic) dim during abstract evaluation: a large
#: prime, so it never collides with a real static dim
_DYN_SENTINEL = 12289

#: ops that skip construction-time inference, as in the JAX package:
#: random ops (no run seed exists yet), control flow and collectives.
#: An op whose function needs real values (`.item()`, host numpy) would
#: have to be listed here too; none of the ported ops does.
_DYNAMIC_SHAPE_OPS = {
    "gaussian_random", "uniform_random", "truncated_gaussian_random",
    "gaussian_random_batch_size_like", "uniform_random_batch_size_like",
    "randint", "shuffle_batch", "sampling_id", "multinomial", "dropout",
    "random_crop",
    "dpsgd", "nce", "while", "conditional_block", "scan", "tensor_array_write",
    "tensor_array_read", "autodiff",
}


def skips_inference(op_type):
    return op_type in _DYNAMIC_SHAPE_OPS or op_type.startswith("c_")


def abstract_inputs(op_desc, block):
    """{name: meta tensor} for the op's inputs from their VarDescs, and
    whether any dim was dynamic; None when an input has no shape or
    dtype (nothing to infer from)."""
    env = {}
    any_dynamic = False
    for n in op_desc.input_names():
        v = block.var(n).desc
        if v.shape is None or v.dtype is None:
            return None, False
        any_dynamic = any_dynamic or any(d == -1 for d in v.shape)
        shape = tuple(_DYN_SENTINEL if d == -1 else d for d in v.shape)
        env[n] = torch.empty(shape, dtype=v.dtype, device="meta")
    return env, any_dynamic


def abstract_eval(op_desc, env):
    """Run the op on meta tensors → {output name: meta tensor}."""
    impl = get_op(op_desc.type)
    ctx = OpContext(op_desc.attrs, None, training=True, op_index=0,
                    device="meta")
    result = impl.fn(ctx, *impl.gather_inputs(op_desc, env))
    out_env = {}
    impl.bind_outputs(op_desc, out_env, result)
    return out_env


def inferred_shape(t):
    """A meta tensor's shape with sentinel-derived dims mapped back to -1."""
    return tuple(-1 if (d % _DYN_SENTINEL == 0 and d > 0) else d
                 for d in t.shape)


def infer_shapes(op_desc, block):
    """InferShape parity (reference operator.cc:841): run the op on meta
    tensors, substituting a sentinel for dynamic (-1) dims, and write the
    outputs' shapes (sentinel-derived dims back to -1) and dtypes into
    their VarDescs.

    Strict: an op whose abstract evaluation fails raises here, with its
    type and Python callsite — unless an input dim was dynamic, where the
    sentinel can fail shape math that is valid at run time (the JAX
    package's rule). Ops in _DYNAMIC_SHAPE_OPS skip inference."""
    if skips_inference(op_desc.type):
        return
    env, any_dynamic = abstract_inputs(op_desc, block)
    if env is None:
        return  # untyped input: skip static inference
    with torch.no_grad():
        try:
            out_env = abstract_eval(op_desc, env)
        except (RuntimeError, ValueError, TypeError, IndexError) as e:
            if any_dynamic:
                return
            raise OpRunError(
                op_desc.type,
                "construction-time shape inference failed: %s" % e,
                getattr(op_desc, "callsite", None)) from e
    for n, t in out_env.items():
        if not block.has_var(n):
            continue
        desc = block.var(n).desc
        desc.shape = inferred_shape(t)
        desc.dtype = t.dtype
