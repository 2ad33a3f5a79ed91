"""LayerHelper — shared machinery for the static layer functions.

Counterpart of paddle_tpu/static/helper.py (the reference's
layer_helper.py): creates parameters (a persistable var in the main
program, mirrored into the startup program with its init op), creates
temporaries, appends the layer's op and runs shape inference on it.
"""
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import (Variable, default_main_program,
                                      default_startup_program, unique_name)
from paddle_tpu_torch.core.registry import infer_shapes
from paddle_tpu_torch.utils.initializer import Constant, Xavier
from paddle_tpu_torch.utils.param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs

    @property
    def main_block(self):
        return default_main_program().current_block()

    @property
    def startup_block(self):
        return default_startup_program().global_block()

    def create_parameter(self, attr, shape, dtype=None, is_bias=False,
                         default_initializer=None):
        """A trainable parameter: a persistable var in BOTH the main
        program (read by ops) and the startup program (written by its
        init op)."""
        attr = ParamAttr.to_attr(attr)
        if attr is False:
            return None
        dtype = _dt.normalize_dtype(dtype or "float32")
        name = attr.name or unique_name(
            f"{self.layer_type}_{'b' if is_bias else 'w'}")
        init = attr.initializer or default_initializer or \
            (Constant(0.0) if is_bias else Xavier())
        enforce(all(d != -1 for d in shape),
                "parameter %r shape must be static, got %s", name, shape)

        # weight sharing: a ParamAttr naming an existing parameter
        # returns it instead of re-creating it
        gb = self.main_block.program.global_block()
        if attr.name and gb.has_var(name):
            existing = gb.var(name)
            enforce(existing.desc.is_parameter,
                    "var %r exists but is not a parameter", name)
            enforce(tuple(existing.shape) == tuple(shape),
                    "shared parameter %r shape mismatch: %s vs %s",
                    name, existing.shape, shape)
            return existing

        main_var = gb.create_var(
            name=name, shape=shape, dtype=dtype, persistable=True,
            is_parameter=True, stop_gradient=False, trainable=attr.trainable)
        main_var.desc.attrs["learning_rate"] = attr.learning_rate
        if attr.regularizer is not None:
            main_var.desc.attrs["regularizer"] = type(attr.regularizer).__name__
            main_var.desc.attrs["regularizer_coeff"] = attr.regularizer.coeff
        main_var.desc.initializer = {"type": type(init).__name__}
        if attr.sharding is not None:
            main_var.desc.sharding = tuple(attr.sharding)
        sb = self.startup_block
        if not sb.has_var(name):
            sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                          is_parameter=True, stop_gradient=False)
            op_type, attrs = init.op_spec(shape, dtype)
            attrs = dict(attrs)
            attrs.setdefault("dtype", _dt.dtype_name(dtype))
            sb.append_op(op_type, {}, {"Out": [name]}, attrs)
        return main_var

    def create_tmp(self, dtype=None, stop_gradient=False, lod_level=0):
        return self.main_block.create_var(
            name=unique_name(f"{self.layer_type}_out"),
            dtype=_dt.normalize_dtype(dtype) if dtype else None,
            stop_gradient=stop_gradient, lod_level=lod_level)

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None,
                  role=None):
        op = self.main_block.append_op(type or self.layer_type,
                                       _names(inputs), _names(outputs),
                                       attrs, role=role)
        infer_shapes(op, self.main_block)
        return op

    def append_simple(self, inputs, attrs=None, n_out=1, dtype=None,
                      out_slots=None, op_type=None):
        """One-op layer: create n_out temps bound to out_slots (default
        ["Out"]) and return them."""
        out_slots = out_slots or (["Out"] if n_out == 1 else None)
        enforce(out_slots is not None and len(out_slots) == n_out,
                "need out_slots for multi-output op")
        in0 = next((v[0] for v in _names(inputs).values() if v), None)
        if dtype is None and in0 is not None and self.main_block.has_var(in0):
            dtype = self.main_block.var(in0).dtype
        outs = [self.create_tmp(dtype=dtype) for _ in range(n_out)]
        self.append_op(op_type or self.layer_type, inputs,
                       {s: [o.name] for s, o in zip(out_slots, outs)}, attrs)
        return outs[0] if n_out == 1 else tuple(outs)


def _names(d):
    """Map {slot: Variable|name|list} → {slot: [names]}."""
    if not d:
        return {}
    out = {}
    for k, v in d.items():
        if v is None:
            continue
        if not isinstance(v, (list, tuple)):
            v = [v]
        out[k] = [x.name if isinstance(x, Variable) else str(x) for x in v]
    return out
