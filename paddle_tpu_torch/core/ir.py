"""Program IR — the serializable model format.

Counterpart of paddle_tpu/core/ir.py (the reference's ProgramDesc
protobuf, framework.proto:43-205, mirrored as Program / Block / OpDesc /
VarDesc / Variable). The module is framework-neutral: VarDesc dtypes are
torch dtypes in memory and the JAX package's names on the wire, so
`to_dict` / `from_dict` / `to_json` produce and read the same JSON as
the JAX package, in both directions.

Ops are pure; a parameter update is an op whose output rebinds a
persistable name. The Executor (core/executor.py) runs a block's ops
eagerly, one after another (core/lowering.py).
"""
import contextlib
import copy
import json

import numpy as np

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.enforce import EnforceError, capture_callsite, enforce

__all__ = ["IR_VERSION", "IR_MINOR", "OpRole", "VarDesc", "OpDesc", "Block",
           "Program", "Variable", "default_main_program",
           "default_startup_program", "switch_main_program",
           "switch_startup_program", "program_guard", "unique_name",
           "reset_unique_names", "name_scope", "op_version", "register_op_version"]

IR_VERSION = 1        # major: breaking serialization changes only
IR_MINOR = 1          # minor: additive (new attrs/ops) — forward-loadable

# Per-op versions (reference op_version_registry.h). Every op type is at
# version 1 unless registered here; a saved program records the versions
# of the ops it uses. Loading: equal → ok; older → run the registered
# migrations in order; newer → an error naming the op.
OP_VERSIONS = {}       # op_type -> current version (absent = 1)
_OP_MIGRATIONS = {}    # (op_type, from_version) -> fn(op_desc), one step


def op_version(op_type):
    return OP_VERSIONS.get(op_type, 1)


def register_op_version(op_type, version, migrations=None):
    """Declare `op_type` is now at `version`. `migrations` maps
    from_version -> callable(OpDesc) that upgrades one step."""
    OP_VERSIONS[op_type] = int(version)
    for frm, fn in (migrations or {}).items():
        _OP_MIGRATIONS[(op_type, int(frm))] = fn


def _migrate_op(op, saved_versions):
    cur = op_version(op.type)
    saved = int(saved_versions.get(op.type, 1))
    if saved == cur:
        return
    if saved > cur:
        raise EnforceError(
            f"program uses op {op.type!r} at version {saved}, but this "
            f"build only knows version {cur} — upgrade paddle_tpu_torch to "
            f"load this model (op_compatible_info DEFIN_NOT)")
    v = saved
    while v < cur:
        fn = _OP_MIGRATIONS.get((op.type, v))
        enforce(fn is not None,
                "no migration for op %r from version %s to %s",
                op.type, v, v + 1)
        fn(op)
        v += 1


class OpRole:
    """OpRole tags (op_proto_maker.h:26-48)."""
    FORWARD = "forward"
    BACKWARD = "backward"
    OPTIMIZE = "optimize"
    LOSS = "loss"
    RPC = "rpc"
    DIST = "dist"


class VarDesc:
    """Static description of a variable (framework.proto:165). shape uses
    -1 for the dynamic batch dimension; dtype is a torch dtype."""

    __slots__ = ("name", "shape", "dtype", "persistable", "is_data",
                 "is_parameter", "lod_level", "stop_gradient", "initializer",
                 "trainable", "sharding", "attrs")

    def __init__(self, name, shape=None, dtype=None, persistable=False,
                 is_data=False, is_parameter=False, lod_level=0,
                 stop_gradient=None, trainable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = _dt.normalize_dtype(dtype)
        self.persistable = persistable
        self.is_data = is_data
        self.is_parameter = is_parameter
        self.lod_level = lod_level
        self.trainable = trainable
        self.stop_gradient = ((not is_parameter) if stop_gradient is None
                              else stop_gradient)
        self.initializer = None   # dict spec, e.g. {"type": "Xavier"}
        self.sharding = None      # PartitionSpec-like tuple or None
        self.attrs = {}

    def to_dict(self):
        return {
            "name": self.name, "shape": list(self.shape) if self.shape else None,
            "dtype": _dt.dtype_name(self.dtype), "persistable": self.persistable,
            "is_data": self.is_data, "is_parameter": self.is_parameter,
            "lod_level": self.lod_level, "stop_gradient": self.stop_gradient,
            "trainable": self.trainable, "initializer": self.initializer,
            "sharding": list(self.sharding) if self.sharding else None,
            "attrs": self.attrs,
        }

    @classmethod
    def from_dict(cls, d):
        v = cls(d["name"], d.get("shape"), d.get("dtype"),
                d.get("persistable", False), d.get("is_data", False),
                d.get("is_parameter", False), d.get("lod_level", 0),
                d.get("stop_gradient"), d.get("trainable", True))
        v.initializer = d.get("initializer")
        s = d.get("sharding")
        v.sharding = tuple(s) if s else None
        v.attrs = d.get("attrs", {})
        return v


class OpDesc:
    """One operator (framework.proto:43): type, named input/output slots
    (each a list of variable names), attrs and role."""

    __slots__ = ("type", "inputs", "outputs", "attrs", "role", "callsite")

    def __init__(self, type, inputs=None, outputs=None, attrs=None,
                 role=OpRole.FORWARD, callsite=""):
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.role = role
        self.callsite = callsite

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def to_dict(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _jsonify_attrs(self.attrs),
                "role": self.role}

    @classmethod
    def from_dict(cls, d):
        return cls(d["type"], d.get("inputs"), d.get("outputs"),
                   _unjsonify_attrs(d.get("attrs", {})),
                   d.get("role", OpRole.FORWARD))

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"


def _jsonify_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def _unjsonify_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


class Block:
    """A straight-line op list and its variables (framework.proto:174).
    Sub-blocks resolve names through their parent chain (scope.h:46)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}   # name -> VarDesc
        self.ops = []    # list[OpDesc]

    def create_var(self, name=None, **kwargs):
        name = name or unique_name("tmp")
        enforce(name not in self.vars, "variable %r already exists in block",
                name)
        desc = VarDesc(name, **kwargs)
        self.vars[name] = desc
        return Variable(self, desc)

    def var(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return Variable(b, b.vars[name])
            b = b.parent
        raise EnforceError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent
        return False

    @property
    def parent(self):
        return None if self.parent_idx < 0 else self.program.blocks[self.parent_idx]

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  role=None, callsite=None):
        role = role or self.program._current_role
        if callsite is None:
            callsite = capture_callsite()
        op = OpDesc(type, inputs, outputs, attrs, role, callsite)
        self.ops.append(op)
        self.program._version += 1
        return op

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": {k: v.to_dict() for k, v in self.vars.items()},
                "ops": [op.to_dict() for op in self.ops]}

    @classmethod
    def from_dict(cls, program, d):
        b = cls(program, d["idx"], d.get("parent_idx", -1))
        b.vars = {k: VarDesc.from_dict(v) for k, v in d["vars"].items()}
        b.ops = [OpDesc.from_dict(o) for o in d["ops"]]
        return b


class Program:
    """The serializable model (framework.proto:181 ProgramDesc)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._current_block_idx = 0
        self._current_role = OpRole.FORWARD
        self._version = 0          # bumped on mutation; keys step caches
        self.random_seed = 0
        self.meta = {}

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx=None):
        """Open a sub-block (a control-flow body) under the current block
        (or `parent_idx`) and make it current."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def _rollback(self):
        """Close the current sub-block: its parent becomes current."""
        self._current_block_idx = self.current_block().parent_idx

    @contextlib.contextmanager
    def op_role_guard(self, role):
        """Ops appended inside carry `role` (op_proto_maker.h OpRole)."""
        prev, self._current_role = self._current_role, role
        try:
            yield
        finally:
            self._current_role = prev

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield Variable(b, v)

    def all_parameters(self):
        return [v for v in self.list_vars() if v.desc.is_parameter]

    def to_dict(self):
        used = sorted({op.type for b in self.blocks for op in b.ops})
        return {"ir_version": IR_VERSION, "ir_minor": IR_MINOR,
                "op_versions": {t: op_version(t) for t in used},
                "random_seed": self.random_seed,
                "meta": self.meta,
                "blocks": [b.to_dict() for b in self.blocks]}

    def to_json(self):
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d):
        enforce(d.get("ir_version", 0) <= IR_VERSION,
                "program was saved with a newer IR major version %s (this "
                "build reads <= %s)", d.get("ir_version"), IR_VERSION)
        p = cls()
        p.random_seed = d.get("random_seed", 0)
        p.meta = d.get("meta", {})
        p.blocks = [Block.from_dict(p, bd) for bd in d["blocks"]]
        saved_versions = d.get("op_versions", {})
        for b in p.blocks:
            for op in b.ops:
                _migrate_op(op, saved_versions)
        return p

    @classmethod
    def from_json(cls, s):
        return cls.from_dict(json.loads(s))

    def clone(self, for_test=False):
        """Program.clone parity. for_test=True keeps forward and loss ops
        only and sets every `is_test` attr."""
        p = Program.from_dict(copy.deepcopy(self.to_dict()))
        p._version = self._version
        if for_test:
            for b in p.blocks:
                b.ops = [op for op in b.ops
                         if op.role in (OpRole.FORWARD, OpRole.LOSS)]
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
            p.meta.pop("train", None)
            p.meta["is_test"] = True
        return p

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"<Program blocks={len(self.blocks)} ops={n_ops} v={self._version}>"


class Variable:
    """Python handle over a VarDesc inside a block (framework.py:561).
    Arithmetic operators append elementwise ops to the variable's program
    (math_op_patch.py parity)."""

    def __init__(self, block, desc):
        self.block = block
        self.desc = desc

    @property
    def name(self):
        return self.desc.name

    @property
    def shape(self):
        return self.desc.shape

    @property
    def dtype(self):
        return self.desc.dtype

    @property
    def persistable(self):
        return self.desc.persistable

    @property
    def stop_gradient(self):
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v):
        self.desc.stop_gradient = v

    def _binary(self, other, op_type, reverse=False):
        from paddle_tpu_torch.static import _elementwise_binary
        return _elementwise_binary(self, other, op_type, reverse)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "elementwise_pow")

    def __rpow__(self, o):
        # c ** x = exp(x ln c)
        import math
        from paddle_tpu_torch import static
        return static.exp(self._binary(math.log(o), "elementwise_mul"))

    def __neg__(self):
        return self._binary(-1.0, "elementwise_mul")

    def __matmul__(self, o):
        from paddle_tpu_torch import static
        return static.matmul(self, o)

    def __getitem__(self, idx):
        from paddle_tpu_torch import static
        return static.getitem(self, idx)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={_dt.dtype_name(self.dtype)})")


# ---------------------------------------------------------------------------
# default programs and guards (framework.py default_main_program)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program):
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_start = (switch_startup_program(startup_program)
                  if startup_program else None)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_start is not None:
            switch_startup_program(prev_start)


# ---------------------------------------------------------------------------
# unique names (fluid/unique_name.py)
# ---------------------------------------------------------------------------

_name_counters = {}
_name_scope_stack = []


def unique_name(prefix="tmp"):
    scope = "/".join(_name_scope_stack)
    key = f"{scope}/{prefix}" if scope else prefix
    i = _name_counters.get(key, 0)
    _name_counters[key] = i + 1
    return f"{key}_{i}"


@contextlib.contextmanager
def name_scope(name):
    """Prefix the unique names made inside the block with `name/`
    (fluid.name_scope)."""
    _name_scope_stack.append(name)
    try:
        yield
    finally:
        _name_scope_stack.pop()


def reset_unique_names():
    _name_counters.clear()
