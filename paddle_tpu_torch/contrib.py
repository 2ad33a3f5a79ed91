"""fluid.contrib odds-and-ends.

Counterpart of paddle_tpu/contrib.py, over the port's Program, Optimizer
and slim passes:
* extend_with_decoupled_weight_decay —
  contrib/extend_optimizer/extend_optimizer_with_weight_decay.py:102.
  Decoupled (AdamW-style) decay: p_new = base_update(p) - coeff * p_old,
  applied as program ops of the step.
* memory_usage — contrib/memory_usage_calc.py:46: rough activation+param
  memory estimate from VarDesc shapes.
* op_freq_statistic — contrib/op_frequence.py:23: op-type histogram.
* QuantizeTranspiler — contrib/quantize/quantize_transpiler.py: thin
  front-end over the slim QAT passes (slim/quantization_pass.py), kept
  for source compatibility with contrib-era scripts.
"""
from collections import Counter, OrderedDict

from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import OpRole


def extend_with_decoupled_weight_decay(base_optimizer):
    """Return a subclass of `base_optimizer` whose minimize() applies
    decoupled weight decay: after the base update, every trainable param
    is shifted by -coeff * p_old (p_old captured BEFORE the update, the
    reference's _scale_parameters contract)."""
    from paddle_tpu_torch.optimizer import Optimizer

    enforce(isinstance(base_optimizer, type)
            and issubclass(base_optimizer, Optimizer),
            "extend_with_decoupled_weight_decay needs an Optimizer class, "
            "got %s", base_optimizer)

    class OptimizerWithDecoupledWeightDecay(base_optimizer):
        def __init__(self, *args, coeff=0.0, apply_decay_param_fun=None,
                     **kwargs):
            super().__init__(*args, **kwargs)
            self._coeff = float(coeff)
            self._decay_fn = apply_decay_param_fun

        def apply_gradients(self, params_grads, program=None,
                            startup_program=None):
            from paddle_tpu_torch.core.ir import default_main_program
            program = program or default_main_program()
            block = program.global_block()
            decays = []
            if self._coeff:
                with program.op_role_guard(OpRole.OPTIMIZE):
                    for p, _ in params_grads:
                        pname = p.name if hasattr(p, "name") else str(p)
                        if self._decay_fn is not None and \
                                not self._decay_fn(pname):
                            continue
                        d = block.create_var(dtype="float32").name
                        block.append_op("scale", {"X": [pname]},
                                        {"Out": [d]},
                                        {"scale": self._coeff})
                        decays.append((pname, d))
            ops = super().apply_gradients(params_grads, program=program,
                                          startup_program=startup_program)
            if decays:
                with program.op_role_guard(OpRole.OPTIMIZE):
                    for pname, d in decays:
                        block.append_op("elementwise_sub",
                                        {"X": [pname], "Y": [d]},
                                        {"Out": [pname]})
            return ops

    OptimizerWithDecoupledWeightDecay.__name__ = (
        f"{base_optimizer.__name__}WithDecoupledWeightDecay")
    return OptimizerWithDecoupledWeightDecay


_DTYPE_BYTES = {"float32": 4, "float64": 8, "int64": 8, "int32": 4,
                "bfloat16": 2, "float16": 2, "uint8": 1, "bool": 1,
                "int8": 1}


def memory_usage(program, batch_size):
    """contrib/memory_usage_calc.py:46 parity: lower/upper estimate (MB)
    of var memory for one iteration at `batch_size`. The reference applies
    a +-30% band around the shape sum; kept for API familiarity."""
    enforce(batch_size > 0, "batch_size must be positive, got %s",
            batch_size)
    total = 0.0
    for var in program.list_vars():
        shape = var.desc.shape
        if shape is None:
            continue
        n = 1
        for d in shape:
            n *= batch_size if d in (-1, 0) else d
        dt = _dt.dtype_name(var.desc.dtype) if var.desc.dtype else "float32"
        total += n * _DTYPE_BYTES.get(dt, 4)
    mb = total / (1 << 20)
    return mb * 0.7, mb * 1.3


def op_freq_statistic(program):
    """contrib/op_frequence.py:23 parity: (uni_op_freq, adj_op_freq) —
    op-type histogram and adjacent-pair histogram, most frequent first."""
    uni = Counter()
    adj = Counter()
    for block in program.blocks:
        prev = None
        for op in block.ops:
            uni[op.type] += 1
            if prev is not None:
                adj[f"{prev}->{op.type}"] += 1
            prev = op.type
    order = lambda c: OrderedDict(c.most_common())  # noqa: E731
    return order(uni), order(adj)


def summary(main_prog):
    """contrib/model_stat.py:40 parity: per-op PARAMs/FLOPs table for the
    conv/mul/pool/activation families, printed and returned as
    (rows, totals). FLOPs counted like the reference: conv = 2·K·K·Cin·
    Cout·Hout·Wout (per image), mul = 2·M·K·N, elementwise/act = numel."""
    rows = []
    total_params = 0
    total_flops = 0
    block = main_prog.global_block()

    def shape_of(name):
        if block.has_var(name):
            return block.var(name).desc.shape
        return None

    def numel(shape, batch=1):
        n = 1
        for d in shape or ():
            n *= batch if d in (-1, 0) else d
        return n

    for i, op in enumerate(block.ops):
        ins = [n for ns in op.inputs.values() for n in ns]
        outs = [n for ns in op.outputs.values() for n in ns]
        params = 0
        for n in ins:
            if block.has_var(n) and block.var(n).desc.is_parameter:
                params += numel(shape_of(n))
        flops = 0
        if op.type in ("conv2d", "depthwise_conv2d"):
            w = shape_of(op.inputs["Filter"][0])
            o = shape_of(op.outputs["Output"][0])
            if w and o:
                flops = 2 * numel(w) * numel(o[2:])
        elif op.type in ("mul", "matmul"):
            x = shape_of(op.inputs["X"][0])
            o = shape_of(op.outputs["Out"][0])
            if x and o:
                flops = 2 * numel(x) * (o[-1] if o[-1] and o[-1] > 0 else 1)
        elif op.type in ("relu", "sigmoid", "tanh", "elementwise_add",
                         "elementwise_mul", "pool2d", "batch_norm",
                         "softmax"):
            o = shape_of(outs[0]) if outs else None
            flops = numel(o)
        rows.append({"no": i, "type": op.type, "params": params,
                     "flops": flops})
        total_params += params
        total_flops += flops

    print(f"Total PARAMs: {total_params} "
          f"({total_params / 1e6:.4f}M)")
    print(f"Total FLOPs: {total_flops} ({total_flops / 1e9:.2f}G)")
    return rows, {"params": total_params, "flops": total_flops}


class QuantizeTranspiler:
    """contrib/quantize/quantize_transpiler.py source-compat front-end
    over the slim QAT passes."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.window_size = window_size

    def training_transpile(self, program=None, startup_program=None):
        from paddle_tpu_torch import slim
        from paddle_tpu_torch.core.ir import default_main_program
        program = program or default_main_program()
        slim.QuantizationTransformPass(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            activation_quantize_type=self.activation_quantize_type,
            weight_quantize_type=self.weight_quantize_type).apply(
                program, startup_program)
        return program

    def freeze_program(self, program, place=None, scope=None):
        from paddle_tpu_torch import slim
        from paddle_tpu_torch.core.scope import global_scope
        slim.QuantizationFreezePass(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits).apply(
                program, scope or global_scope())
        return program
