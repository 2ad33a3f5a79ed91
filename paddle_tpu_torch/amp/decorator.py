"""Automatic mixed precision as a program transform.

Counterpart of paddle_tpu/amp/decorator.py (the reference's
contrib/mixed_precision/decorator.py): `decorate(optimizer)` returns an
`OptimizerWithMixedPrecision` whose `minimize()` (or `backward()` then
`apply_gradients()`)

1. rewrites the forward program, inserting `cast` ops around white and
   black ops per the AMP lists (reference fp16_utils.py:158
   rewrite_program),
2. scales the loss by a (possibly dynamic) loss-scaling factor,
3. appends backward,
4. unscales the gradients and checks them for nan / inf
   (`check_finite_and_unscale`), zeroing them on overflow,
5. updates the dynamic loss scale (`update_loss_scaling`),
6. applies the inner optimizer.

Master parameters stay float32: casts sit at the use sites, so
gradients flow back through the cast into float32 and the updates run
in float32. The programs equal the JAX package's op for op. bfloat16
(the default) needs no loss scaling; float16 keeps the reference's
dynamic scaling from 2**15.
"""
import paddle_tpu_torch.amp.amp_ops  # noqa: F401  (registers the ops)
from paddle_tpu_torch.amp.fp16_lists import AutoMixedPrecisionLists
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.ir import (
    OpDesc, OpRole, default_main_program, unique_name,
)
from paddle_tpu_torch.optimizer import Optimizer, _persistable_var

__all__ = ["rewrite_program", "OptimizerWithMixedPrecision", "decorate"]

_LOW = ("float16", "bfloat16")


def _dtype_str(d):
    return _dt.dtype_name(_dt.normalize_dtype(d)) if d is not None else None


def _is_float(name, block, cur_dtype):
    d = cur_dtype.get(name)
    if d is None and block.has_var(name):
        d = _dtype_str(block.var(name).dtype)
    return d is None or d.startswith("float") or d == "bfloat16"


def rewrite_program(program, amp_lists=None, dest_dtype=None):
    """Insert cast ops into the program's global block so white-listed ops
    compute in `dest_dtype` and black-listed ops in float32
    (fp16_utils.py:158); `dest_dtype` None reads the amp_dtype flag.
    Returns the program (modified in place)."""
    dest_dtype = dest_dtype or flags.get_flag("amp_dtype")
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    block = program.global_block()
    cur_dtype = {}       # var name -> current dtype string as the walk sees it
    cast_cache = {}      # (src name, dst dtype) -> cast output name
    new_ops = []

    def current_dtype(name):
        d = cur_dtype.get(name)
        if d is None and block.has_var(name):
            d = _dtype_str(block.var(name).dtype)
        return d or "float32"

    def cast_to(name, dst):
        key = (name, dst)
        if key in cast_cache:
            return cast_cache[key]
        out = unique_name(f"{name}.cast_{dst}")
        block.create_var(name=out, dtype=dst, stop_gradient=False,
                         shape=(block.var(name).shape if block.has_var(name)
                                else None))
        new_ops.append(OpDesc("cast", {"X": [name]}, {"Out": [out]},
                              {"in_dtype": current_dtype(name),
                               "out_dtype": dst},
                              role=OpRole.FORWARD))
        cast_cache[key] = out
        cur_dtype[out] = dst
        return out

    for op in block.ops:
        cls = amp_lists.classify(op)
        if cls == "white":
            want = dest_dtype
        elif cls == "black":
            want = "float32"
        else:
            # gray: follow the inputs. If any float input is already low
            # precision, pull the rest down with it: bf16 + f32 promotes
            # to f32, which would undo AMP for every op after the first
            # bias add (fp16_utils.py's gray-op handling)
            float_ins = [n for n in op.input_names()
                         if _is_float(n, block, cur_dtype)]
            in_ds = {current_dtype(n) for n in float_ins}
            want = next((d for d in _LOW if d in in_ds), None)
        if want is not None:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [
                    cast_to(n, want)
                    if (_is_float(n, block, cur_dtype)
                        and current_dtype(n) != want)
                    else n
                    for n in names]
        out_d = want
        new_ops.append(op)
        for n in op.output_names():
            if out_d is not None and _is_float(n, block, cur_dtype):
                cur_dtype[n] = out_d
            # an output redefinition invalidates cached casts of that name
            for dst in _LOW + ("float32",):
                cast_cache.pop((n, dst), None)
    block.ops[:] = new_ops
    program.meta["amp"] = dest_dtype
    return program


class OptimizerWithMixedPrecision(Optimizer):
    """decorator.py:27: wraps a real optimizer; owns the loss-scaling
    state and the program rewrite."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=None,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.5,
                 use_dynamic_loss_scaling=None, dest_dtype=None):
        super().__init__(learning_rate=optimizer._lr)
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        dest_dtype = dest_dtype or flags.get_flag("amp_dtype")
        # bfloat16 has float32's exponent range: no scaling needed, and
        # the default path pays for no isfinite sweep a step. float16
        # keeps the reference's dynamic-loss-scaling defaults.
        fp16 = dest_dtype == "float16"
        if use_dynamic_loss_scaling is None:
            use_dynamic_loss_scaling = fp16
        if init_loss_scaling is None:
            init_loss_scaling = 2.0 ** 15 if fp16 else 1.0
        self._init_loss_scaling = float(init_loss_scaling)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._use_dynamic_loss_scaling = bool(use_dynamic_loss_scaling)
        self._dest_dtype = dest_dtype
        self._loss_scaling_name = None

    @property
    def _use_scaling(self):
        """Whether any loss-scaling machinery goes into the program."""
        return self._use_dynamic_loss_scaling or self._init_loss_scaling != 1.0

    def get_loss_scaling(self, program=None):
        if self._loss_scaling_name is None:
            return None  # bf16 default: no scaling machinery in the program
        program = program or default_main_program()
        return program.global_block().var(self._loss_scaling_name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        params_grads = self.backward(loss, startup_program=startup_program,
                                     parameter_list=parameter_list,
                                     no_grad_set=no_grad_set)
        opt_ops = self.apply_gradients(params_grads, program=program,
                                       startup_program=startup_program)
        program.meta["optimizer"] = f"amp({self._optimizer._name})"
        return opt_ops, params_grads

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        """AMP program rewrite + loss scaling + backward — a full AMP step,
        so the reference's two-phase `backward(); apply_gradients()` flow
        (used by meta/distributed optimizer wrappers) works identically to
        minimize() (reference decorator.py:81 backward does the same)."""
        import paddle_tpu_torch.core.ir as ir
        program = loss.block.program
        startup = startup_program or ir.default_startup_program()
        block = program.global_block()

        if program.meta.get("amp") != self._dest_dtype:  # rewrite once
            rewrite_program(program, self._amp_lists, self._dest_dtype)

        target = loss
        if self._use_scaling:
            scale_var = _persistable_var(
                program, startup, unique_name("loss_scaling"), [1],
                "float32", self._init_loss_scaling)
            self._loss_scaling_name = scale_var.name
            scaled = block.create_var(name=unique_name("scaled_loss"),
                                      dtype="float32", stop_gradient=False)
            block.append_op("elementwise_mul",
                            {"X": [loss.name], "Y": [scale_var.name]},
                            {"Out": [scaled.name]}, {"axis": -1},
                            role=OpRole.LOSS)
            target = block.var(scaled.name)

        return self._optimizer.backward(
            target, startup_program=startup, parameter_list=parameter_list,
            no_grad_set=no_grad_set, checkpoints=checkpoints)

    def apply_gradients(self, params_grads, program=None,
                        startup_program=None):
        """Unscale + finite-check + dynamic scale update, then the inner
        optimizer's updates (reference decorator.py:134 apply_gradients)."""
        import paddle_tpu_torch.core.ir as ir
        program = program or default_main_program()
        startup = startup_program or ir.default_startup_program()
        block = program.global_block()

        if self._use_scaling:
            scale_name = self._loss_scaling_name
            grad_names = [g.name for _, g in params_grads]
            found_inf = block.create_var(name=unique_name("found_infinite"),
                                         dtype="bool", shape=[1],
                                         stop_gradient=True)
            with program.op_role_guard(OpRole.BACKWARD):
                block.append_op("check_finite_and_unscale",
                                {"X": grad_names, "Scale": [scale_name]},
                                {"Out": grad_names,
                                 "FoundInfinite": [found_inf.name]})
                if self._use_dynamic_loss_scaling:
                    good = _persistable_var(program, startup,
                                            unique_name("good_steps"), [1],
                                            "int32", 0)
                    bad = _persistable_var(program, startup,
                                           unique_name("bad_steps"), [1],
                                           "int32", 0)
                    block.append_op(
                        "update_loss_scaling",
                        {"FoundInfinite": [found_inf.name],
                         "PrevLossScaling": [scale_name],
                         "InGoodSteps": [good.name], "InBadSteps": [bad.name]},
                        {"LossScaling": [scale_name],
                         "OutGoodSteps": [good.name],
                         "OutBadSteps": [bad.name]},
                        {"incr_every_n_steps": self._incr_every_n_steps,
                         "decr_every_n_nan_or_inf":
                             self._decr_every_n_nan_or_inf,
                         "incr_ratio": self._incr_ratio,
                         "decr_ratio": self._decr_ratio})

        return self._optimizer.apply_gradients(
            params_grads, program=program, startup_program=startup)


def decorate(optimizer, amp_lists=None, init_loss_scaling=None,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5, use_dynamic_loss_scaling=None,
             dest_dtype=None):
    """mixed_precision.decorate (decorator.py:216). dest_dtype None reads
    the amp_dtype flag. Defaults follow dest_dtype: bfloat16, no loss
    scaling; float16, dynamic loss scaling
    from 2**15 (the reference's defaults)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, incr_every_n_steps,
        decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        use_dynamic_loss_scaling, dest_dtype)
