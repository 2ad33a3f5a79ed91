"""Operator registry.

Counterpart of paddle_tpu/core/registry.py (the reference's
REGISTER_OPERATOR / REGISTER_OP_*_KERNEL, op_registry.h:199). An op
implementation is one PyTorch function `fn(ctx, *inputs) -> outputs`
registered under the JAX package's op type and slot names; the Executor
calls it on tensors of its device, eagerly or inside a captured CUDA
graph (core/lowering.py's capture plan).

An op that must read the device from the host, or run host code, while
it runs (a `while` condition, a `py_func` callback) says so when it is
registered: `register_op(..., host=reason)`, where `reason` is a string
or a function of the OpDesc giving one (None when that op runs on the
device alone). The capture plan ends a graph segment at each such op.

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
import contextlib
import importlib
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import OpRunError, enforce

__all__ = ["OpContext", "OpImpl", "register_op", "get_op", "has_op",
           "registered_ops", "infer_shapes", "op_generator", "host_reason",
           "RunGenerators", "constant", "constants_kept"]

_OPS = {}

#: the modules that register ops, imported on the first registry lookup
_OP_MODULES = ("paddle_tpu_torch.ops.tensor", "paddle_tpu_torch.ops.random",
               "paddle_tpu_torch.ops.math", "paddle_tpu_torch.ops.nn",
               "paddle_tpu_torch.ops.metrics", "paddle_tpu_torch.ops.fused",
               "paddle_tpu_torch.ops.optimizer_ops",
               "paddle_tpu_torch.ops.sequence", "paddle_tpu_torch.ops.rnn",
               "paddle_tpu_torch.ops.control_flow",
               "paddle_tpu_torch.ops.beam_search",
               "paddle_tpu_torch.ops.loss",
               "paddle_tpu_torch.ops.vision", "paddle_tpu_torch.ops.text",
               "paddle_tpu_torch.ops.detection",
               "paddle_tpu_torch.ops.detection_train",
               "paddle_tpu_torch.ops.misc", "paddle_tpu_torch.ops.ctr",
               "paddle_tpu_torch.ops.collective",
               "paddle_tpu_torch.parallel.moe",
               "paddle_tpu_torch.amp.amp_ops",
               "paddle_tpu_torch.slim.quant_ops")
_loaded = [False]


def _load_op_library():
    if not _loaded[0]:
        _loaded[0] = True
        for name in _OP_MODULES:
            importlib.import_module(name)


def _mixed_seed(seed, op_index):
    return (int(seed) * 1_000_003 + int(op_index) * 7_919) % (2 ** 63 - 1)


_kept = threading.local()


@contextlib.contextmanager
def constants_kept(store):
    """While the block is open on this thread, `constant` keeps its device
    copies in the dict `store`, one per (value, dtype, device): a graph's
    warm-up makes them, its capture reads them, and the graph holds
    `store` for as long as its replays read them."""
    prev = getattr(_kept, "store", None)
    _kept.store = store
    try:
        yield store
    finally:
        _kept.store = prev


def constant(values, dtype, device):
    """A new tensor on `device` holding host `values` (a number, list or
    numpy array) as `dtype`. Inside `constants_kept` the copy from the
    host is made once per value, never while a CUDA graph is being
    captured (where a copy from pageable host memory is not permitted),
    and each call returns a device-side copy of it, which a capture
    records; elsewhere each call copies from the host."""
    arr = np.asarray(values)
    device = torch.device(device)
    store = getattr(_kept, "store", None)
    if store is not None:
        key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, device)
        if key in store:
            return store[key].clone()
    enforce(device.type != "cuda"
            or not torch.cuda.is_current_stream_capturing(),
            "a constant of shape %s was first asked for while a CUDA "
            "graph was being captured", arr.shape)
    t = torch.from_numpy(np.array(arr)).to(dtype).to(device)
    if store is None:
        return t
    store[key] = t
    return t.clone()


def op_generator(seed, op_index, device):
    """The torch.Generator of one op in one run: seeded from the run's
    seed and the op's index (the JAX package folds the op index into the
    run's PRNG key), so a program's randomness is reproducible."""
    return torch.Generator(device=device).manual_seed(
        _mixed_seed(seed, op_index))


class RunGenerators:
    """The persistent torch.Generators of one step function's draw sites.

    Eagerly, `draw` re-seeds the site's generator from the run seed and
    the op index (or the op's own `seed` attr) on every call: the numbers
    `op_generator` gives. A captured graph cannot make or seed a generator
    while it is captured, so each draw of a segment run (`begin` starts
    one) has a generator of its own, keyed by (op index, how many draws
    the site made before in this segment run): the segment's graph
    registers them and `reseed` sets each one before every replay, so a
    replay draws what an eager run at the same seed draws, a site drawn
    twice in one run (a `scan` body) included. The Executor's entry calls
    `begin` at the start of every run too, so the keys of an eager run
    stay (op index, 0..n) and its generators are reused run after run."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._gens = {}
        self._counts = {}
        self._used = None
        self.capturing = False

    def begin(self):
        """Start a run or a segment's capture: returns the list that
        collects its draws as (generator, op index, fixed seed)."""
        self._counts = {}
        self._used = []
        return self._used

    def draw(self, seed, op_index, fixed=None):
        k = self._counts.get(op_index, 0)
        self._counts[op_index] = k + 1
        gen = self._gens.get((op_index, k))
        if gen is None:
            gen = self._gens[(op_index, k)] = torch.Generator(
                device=self.device)
        if not self.capturing:
            gen.manual_seed(fixed if fixed else _mixed_seed(seed, op_index))
        if self._used is not None:
            self._used.append((gen, op_index, fixed))
        return gen

    @staticmethod
    def reseed(used, seed):
        """Seed a segment's generators for a run at `seed` (on the host,
        before its graph replays)."""
        for gen, op_index, fixed in used:
            gen.manual_seed(fixed if fixed else _mixed_seed(seed, op_index))


class OpContext:
    """Per-op context handed to compute functions: attrs, the run's
    randomness, the mode, the device new tensors are made on, and for
    control-flow ops the block being run and `run_subblock(idx, sub_env)`
    (runs sub-block `idx` over the enclosing environment updated by
    `sub_env` and returns the resulting environment).

    `device` is required: the caller names it (the Executor's device,
    "meta" for shape inference), so no op context, a sub-block's
    included, can fall back to another device."""

    __slots__ = ("attrs", "_seed", "training", "op_index", "device",
                 "block", "run_subblock", "_rngs")

    def __init__(self, attrs, seed, training, op_index, device, block=None,
                 run_subblock=None, rngs=None):
        enforce(device is not None, "OpContext needs a device")
        self.attrs = attrs
        self._seed = seed
        self.training = training
        self.op_index = op_index
        self.device = torch.device(device)
        self.block = block
        self.run_subblock = run_subblock
        self._rngs = rngs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rng(self, fixed=None):
        """A torch.Generator for this op, seeded from the run's seed and
        the op index, or from `fixed` (an op's own non-zero `seed` attr);
        the step function's persistent generator for the site when the
        run has one (RunGenerators)."""
        enforce(self._seed is not None,
                "op requested randomness but no seed was provided")
        if self._rngs is not None:
            return self._rngs.draw(self._seed, self.op_index, fixed)
        if fixed:
            return torch.Generator(device=self.device).manual_seed(fixed)
        return op_generator(self._seed, self.op_index, self.device)

    def has_rng(self):
        """False during shape inference (no run seed): a sampling op then
        makes placeholder draws of the right shape."""
        return self._seed is not None


class _Slot:
    __slots__ = ("name", "optional", "variadic")

    def __init__(self, spec):
        self.optional = spec.endswith("?")
        self.variadic = spec.endswith("[]")
        self.name = spec[:-2] if self.variadic else spec.rstrip("?")


class OpImpl:
    def __init__(self, type_, fn, in_slots, out_slots, host=None):
        self.type = type_
        self.fn = fn
        self.in_slots = [_Slot(s) for s in in_slots]
        self.out_slots = [_Slot(s) for s in out_slots]
        self.host = host

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


def register_op(type_, inputs, outputs, host=None):
    """Decorator: register `fn(ctx, *inputs) -> outputs` under `type_`.
    `host`: why the op needs the host while it runs (a string, or a
    function of the OpDesc returning one or None), for the capture
    plan."""

    def deco(fn):
        enforce(type_ not in _OPS, "op %r registered twice", type_)
        _OPS[type_] = OpImpl(type_, fn, inputs, outputs, host=host)
        return fn

    return deco


def host_reason(op_desc):
    """Why `op_desc` needs the host while it runs (its registration's
    `host`), or None when it runs on the device alone."""
    host = get_op(op_desc.type).host
    return host(op_desc) if callable(host) else host


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
#: have to be listed here too; the host ops (`host=`) return meta
#: tensors on meta inputs instead.
_DYNAMIC_SHAPE_OPS = {
    "gaussian_random", "uniform_random", "truncated_gaussian_random",
    "gaussian_random_batch_size_like", "uniform_random_batch_size_like",
    "randint", "shuffle_batch", "sampling_id", "multinomial", "dropout",
    "random_crop",
    "dpsgd", "nce", "while", "conditional_block", "scan", "tensor_array_write",
    "tensor_array_read", "autodiff",
}
#: the IR records no inferred shapes for these, as in the JAX package;
#: the control-flow ops still evaluate on meta tensors through
#: `abstract_eval(op, env, block)` (one body pass, both branches)


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


class _MetaEnv(dict):
    """An environment of meta tensors that makes a missing name's value
    from its VarDesc (a sub-block reads the enclosing block's vars)."""

    def __init__(self, block, *args):
        super().__init__(*args)
        self.block = block

    def __missing__(self, name):
        desc = self.block.var(name).desc
        enforce(desc.shape is not None and desc.dtype is not None,
                "var %r has no static shape and dtype to evaluate on", name)
        shape = tuple(_DYN_SENTINEL if d == -1 else d for d in desc.shape)
        self[name] = torch.empty(shape, dtype=desc.dtype, device="meta")
        return self[name]


def abstract_eval(op_desc, env, block=None):
    """Run the op on meta tensors → {output name: meta tensor}. Given the
    op's `block`, a control-flow op evaluates its sub-blocks on meta
    tensors too (reads of the enclosing block's vars come from their
    VarDescs); no value is read."""
    impl = get_op(op_desc.type)
    run_subblock = None
    if block is not None:
        from paddle_tpu_torch.core.lowering import run_ops

        def run_subblock(idx, sub_env, carry=()):
            sub = block.program.blocks[idx]
            return run_ops(sub.ops, sub, _MetaEnv(sub, {**env, **sub_env}),
                           None, True, "meta")
    ctx = OpContext(op_desc.attrs, None, training=True, op_index=0,
                    device="meta", block=block, run_subblock=run_subblock)
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
