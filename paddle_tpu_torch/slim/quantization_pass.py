"""Quantization passes over the Program IR.

Counterpart of paddle_tpu/slim/quantization_pass.py (the reference's
contrib/slim/quantization/quantization_pass.py: QuantizationTransformPass
:58, QuantizationFreezePass :585, ConvertToInt8Pass :884). The Program's
flat op list is rewritten directly.

    QAT:  transform(program) → train → freeze(program, scope) → int8 infer
    PTQ:  PostTrainingQuantization collects activation scales by running
          calibration batches, then freezes with them.

Both rewrites are registered passes ("quant_transform" / "quant_freeze")
that act only when armed through `AnalysisContext.scratch`; the entry
point is `quantize_program`, the verify → pass → verify sandwich. The
JAX package's `plan` argument (a `analysis.numerics.QuantPlan`) waits
for the numerics analyzer; until then an op stays in float when its
`skip_quant` attr is set.
"""
import numpy as np

from paddle_tpu_torch.analysis.diagnostic import Severity
from paddle_tpu_torch.analysis.framework import Pass, register_pass
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.ir import OpDesc, OpRole, unique_name
from paddle_tpu_torch.optimizer import _persistable_var
from paddle_tpu_torch.slim import quant_ops

__all__ = ["SLIM_PASSES", "QUANTIZABLE", "QuantizationTransformPass",
           "QuantizationFreezePass", "ConvertToInt8Pass",
           "quantize_program"]

SLIM_PASSES = ("quant_transform", "quant_freeze")

# op type -> (activation input slot, weight input slot)
QUANTIZABLE = {
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    # the export-time fc fusion output (inference/optimize.py) — freeze
    # splits it back into quantized_mul + bias + activation
    "fc": ("Input", "W"),
}
# weight channel axis per op type (OIHW convs: out channels at 0;
# mul/matmul/fc weights [in, out]: out channels at 1)
_CHANNEL_AXIS = {"conv2d": 0, "depthwise_conv2d": 0, "mul": 1, "matmul": 1,
                 "fc": 1}


def _is_param(block, name):
    return block.has_var(name) and block.var(name).desc.is_parameter


class QuantizationTransformPass:
    """Insert fake quant-dequant ops ahead of quantizable ops (QAT).

    weight_quantize_type: "abs_max" | "channel_wise_abs_max"
    activation_quantize_type: "moving_average_abs_max" | "abs_max"
    """

    def __init__(self, weight_bits=8, activation_bits=8,
                 weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 moving_rate=0.9, quantizable_op_type=None,
                 skip_pattern="skip_quant"):
        self.wbits = weight_bits
        self.abits = activation_bits
        self.wtype = weight_quantize_type
        self.atype = activation_quantize_type
        self.rate = moving_rate
        self.ops = set(quantizable_op_type or QUANTIZABLE)
        self.skip_pattern = skip_pattern

    def apply(self, program, startup_program=None):
        from paddle_tpu_torch.core import ir as _ir
        startup = startup_program or _ir.default_startup_program()
        block = program.global_block()
        new_ops = []
        qdq_cache = {}  # (var name, kind) -> quantized name

        def fq_weight(name, op_type):
            key = (name, "w")
            if key in qdq_cache:
                return qdq_cache[key]
            out = unique_name(name + ".qdq")
            scale = unique_name(name + ".wscale")
            block.create_var(name=out, dtype="float32", stop_gradient=False)
            block.create_var(name=scale, dtype="float32", stop_gradient=True)
            if self.wtype == "channel_wise_abs_max":
                new_ops.append(OpDesc(
                    "fake_channel_wise_quantize_dequantize_abs_max",
                    {"X": [name]}, {"Out": [out], "OutScale": [scale]},
                    {"bit_length": self.wbits,
                     "quant_axis": _CHANNEL_AXIS[op_type]},
                    OpRole.FORWARD))
            else:
                new_ops.append(OpDesc(
                    "fake_quantize_dequantize_abs_max",
                    {"X": [name]}, {"Out": [out], "OutScale": [scale]},
                    {"bit_length": self.wbits}, OpRole.FORWARD))
            qdq_cache[key] = out
            return out

        def fq_act(name):
            key = (name, "a")
            if key in qdq_cache:
                return qdq_cache[key]
            out = unique_name(name + ".qdq")
            block.create_var(name=out, dtype="float32", stop_gradient=False)
            if self.atype == "moving_average_abs_max":
                state = unique_name(name + ".quant_scale")
                _persistable_var(program, startup, state, [1], "float32", 0.0)
                new_ops.append(OpDesc(
                    "fake_quantize_dequantize_moving_average_abs_max",
                    {"X": [name], "InScale": [state]},
                    {"Out": [out], "OutScale": [state]},
                    {"bit_length": self.abits, "moving_rate": self.rate},
                    OpRole.FORWARD))
            else:
                scale = unique_name(name + ".ascale")
                block.create_var(name=scale, dtype="float32",
                                 stop_gradient=True)
                new_ops.append(OpDesc(
                    "fake_quantize_dequantize_abs_max",
                    {"X": [name]}, {"Out": [out], "OutScale": [scale]},
                    {"bit_length": self.abits}, OpRole.FORWARD))
            qdq_cache[key] = out
            return out

        def _quantizable(op):
            if op.type not in self.ops or op.role != OpRole.FORWARD or \
                    op.attrs.get(self.skip_pattern, False):
                return False
            if op.type == "matmul":
                # the frozen quantized_mul computes x @ w with w a 2-D
                # [in, out] parameter; transposes / alpha would be
                # silently dropped, so such matmuls stay in float
                if op.attrs.get("transpose_X") or \
                        op.attrs.get("transpose_Y") or \
                        op.attrs.get("alpha", 1.0) != 1.0:
                    return False
                w = op.inputs.get("Y", [])
                if w and block.has_var(w[0]):
                    shape = block.var(w[0]).desc.shape
                    if shape is None or len(shape) != 2:
                        return False
            return True

        for op in block.ops:
            if _quantizable(op):
                act_slot, w_slot = QUANTIZABLE[op.type]
                acts = op.inputs.get(act_slot, [])
                ws = op.inputs.get(w_slot, [])
                if acts and ws and _is_param(block, ws[0]):
                    op.inputs[act_slot] = [fq_act(acts[0])]
                    op.inputs[w_slot] = [fq_weight(ws[0], op.type)]
                    op.attrs["quantization_type"] = "qat"
                    op.attrs["bit_length"] = self.wbits
            new_ops.append(op)
        block.ops = new_ops
        program._version += 1
        return program


class QuantizationFreezePass:
    """Rewrite a QAT (or PTQ-calibrated) program for int8 inference:
    weights become stored int8 + per-channel scales, and the activation
    fake-quant ops disappear into the quantized ops' on-the-fly
    quantization (QuantizationFreezePass :585 semantics)."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_scales=None):
        self.wbits = weight_bits
        self.abits = activation_bits
        # PTQ: {activation var name: scale} collected by calibration
        self.act_scales = dict(activation_scales or {})

    def apply(self, program, scope):
        block = program.global_block()
        # 1) activation scales from the fake-quant ops: quantized name ->
        #    (source name, scale)
        act_src = {}
        for op in block.ops:
            if op.type == "fake_quantize_dequantize_moving_average_abs_max":
                src = op.inputs["X"][0]
                sc = scope.find_np(op.inputs["InScale"][0])
                scale = float(sc.reshape(-1)[0]) if sc is not None else \
                    self.act_scales.get(src, 0.0)
                act_src[op.outputs["Out"][0]] = (src, scale)
            elif op.type == "fake_quantize_dequantize_abs_max":
                src = op.inputs["X"][0]
                if not _is_param(block, src):
                    scale = self.act_scales.get(src)
                    if scale is None:
                        val = scope.find_np(src)
                        scale = float(np.max(np.abs(val))) if val is not None \
                            else 0.0
                    act_src[op.outputs["Out"][0]] = (src, float(scale))

        # weight fake-qdq: quantized name -> source param name
        w_src = {}
        for op in block.ops:
            if op.type in ("fake_quantize_dequantize_abs_max",
                           "fake_channel_wise_quantize_dequantize_abs_max"):
                src = op.inputs["X"][0]
                if _is_param(block, src):
                    w_src[op.outputs["Out"][0]] = src

        new_ops = []
        for op in block.ops:
            if op.type.startswith("fake_quantize") or \
                    op.type.startswith("fake_channel_wise_quantize"):
                continue  # absorbed into the quantized ops
            if op.attrs.get("quantization_type") == "qat" and \
                    op.type in QUANTIZABLE:
                new_ops.extend(self._rewrite(op, block, scope, act_src,
                                             w_src))
                continue
            new_ops.append(op)
        block.ops = new_ops
        # 2) drop the fake-quant plumbing and the replaced f32 weights from
        #    the block: the Executor reads every persistable block var
        #    present in the scope, so a stale f32 weight desc would keep
        #    the full-precision copy resident beside its int8 replacement
        stale = set(w_src.values())     # the replaced f32 weights
        stale.update(act_src)           # the activation .qdq outputs
        stale.update(w_src)             # the weight .qdq outputs
        live = set()
        for op in block.ops:
            live.update(op.input_names())
            live.update(op.output_names())
        meta = program.meta if isinstance(program.meta, dict) else {}
        live.update(meta.get("feed_targets") or [])
        live.update(meta.get("fetch_targets") or [])
        for name in list(block.vars):
            if name in live:
                continue
            if name in stale or ".qdq" in name or ".wscale" in name \
                    or ".ascale" in name or ".quant_scale" in name:
                del block.vars[name]
        program._version += 1
        return program

    def _rewrite(self, op, block, scope, act_src, w_src):
        act_slot, w_slot = QUANTIZABLE[op.type]
        a_q = op.inputs[act_slot][0]
        w_q = op.inputs[w_slot][0]
        enforce(a_q in act_src and w_q in w_src,
                "freeze: op %s inputs not fake-quantized", op.type)
        a_name, a_scale = act_src[a_q]
        enforce(a_scale > 0.0,
                "freeze: no calibrated scale for %s — run training or PTQ "
                "calibration first", a_name)
        w_name = w_src[w_q]
        w_val = scope.find_np(w_name)
        enforce(w_val is not None, "freeze: weight %s has no value in scope",
                w_name)
        w_int8, w_scale = quant_ops.quantize_weight(
            w_val, self.wbits, channel_axis=_CHANNEL_AXIS[op.type])
        int8_name = w_name + ".int8"
        scale_name = w_name + ".scale"
        if not block.has_var(int8_name):
            block.create_var(name=int8_name, shape=w_int8.shape,
                             dtype="int8", persistable=True,
                             stop_gradient=True)
            block.create_var(name=scale_name, shape=w_scale.shape,
                             dtype="float32", persistable=True,
                             stop_gradient=True)
        scope.set(int8_name, w_int8)
        scope.set(scale_name, w_scale)
        attrs = dict(op.attrs)
        attrs["x_scale"] = a_scale
        attrs["bit_length"] = self.wbits
        out = []
        if op.type in ("conv2d", "depthwise_conv2d"):
            inputs = {"Input": [a_name], "Filter": [int8_name],
                      "FilterScale": [scale_name]}
            if op.inputs.get("Bias"):
                inputs["Bias"] = op.inputs["Bias"]
            # the quantized conv has no fuse_activation path: re-emit the
            # activation the export fusion absorbed
            fact = attrs.pop("fuse_activation", "")
            final = op.outputs["Output"][0]
            conv_out = final
            if fact:
                conv_out = unique_name(final + ".qconv")
                block.create_var(name=conv_out, dtype="float32",
                                 stop_gradient=True)
            out.append(OpDesc("quantized_conv2d", inputs,
                              {"Output": [conv_out]}, attrs, op.role))
            if fact:
                out.append(OpDesc(fact, {"X": [conv_out]}, {"Out": [final]},
                                  {}, op.role))
        elif op.type == "fc":
            # split the fused op back: int8 GEMM, then the bias and the
            # activation the fusion had absorbed
            attrs["x_num_col_dims"] = op.attrs.get("in_num_col_dims", 1)
            cur = unique_name(op.outputs["Out"][0] + ".qm")
            block.create_var(name=cur, dtype="float32", stop_gradient=True)
            out.append(OpDesc("quantized_mul",
                              {"X": [a_name], "Y": [int8_name],
                               "YScale": [scale_name]},
                              {"Out": [cur]}, attrs, op.role))
            final = op.outputs["Out"][0]
            act = op.attrs.get("activation", "")
            bias = op.inputs.get("Bias", [])
            if bias:
                nxt = unique_name(final + ".qb") if act else final
                if nxt != final:
                    block.create_var(name=nxt, dtype="float32",
                                     stop_gradient=True)
                out.append(OpDesc(
                    "elementwise_add", {"X": [cur], "Y": bias},
                    {"Out": [nxt]},
                    {"axis": op.attrs.get("in_num_col_dims", 1)}, op.role))
                cur = nxt
            if act:
                out.append(OpDesc(act, {"X": [cur]}, {"Out": [final]}, {},
                                  op.role))
            elif not bias:
                out[-1].outputs["Out"] = [final]
        else:  # mul / matmul -> 2D GEMM
            if op.type == "matmul":
                attrs["x_num_col_dims"] = -1   # flatten all leading dims
            out.append(OpDesc("quantized_mul",
                              {"X": [a_name], "Y": [int8_name],
                               "YScale": [scale_name]},
                              {"Out": op.outputs["Out"]}, attrs, op.role))
        return out


class ConvertToInt8Pass:
    """Store quantizable parameters as int8 in the scope without rewriting
    compute ops (ConvertToInt8Pass :884 — export-size reduction)."""

    def __init__(self, weight_bits=8):
        self.wbits = weight_bits

    def apply(self, program, scope):
        block = program.global_block()
        converted = set()
        for op in block.ops:
            if op.type not in QUANTIZABLE:
                continue
            _, w_slot = QUANTIZABLE[op.type]
            for w_name in op.inputs.get(w_slot, []):
                if not _is_param(block, w_name) or w_name in converted:
                    continue
                val = scope.find_np(w_name)
                if val is None:
                    continue
                q, s = quant_ops.quantize_weight(
                    val, self.wbits, channel_axis=_CHANNEL_AXIS[op.type])
                scope.set(w_name + ".int8", q)
                scope.set(w_name + ".scale", s)
                converted.add(w_name)
        return program


# ---------------------------------------------------------------------------
# pass-framework integration: registered wrappers + the sandwich driver
# ---------------------------------------------------------------------------

def _armed(context, key):
    scratch = getattr(context, "scratch", None) if context else None
    if not isinstance(scratch, dict):
        return None
    return scratch.get(key)


@register_pass("quant_transform")
class RegisteredQuantTransform(Pass):
    """QuantizationTransformPass behind the pass registry. MUTATING —
    arms only when `context.scratch['quant_transform']` carries a config
    ({startup_program, **TransformPass kwargs}); no-ops otherwise."""

    def run(self, program, context):
        cfg = _armed(context, "quant_transform")
        if cfg is None:
            return
        cfg = dict(cfg)
        startup = cfg.pop("startup_program", None)
        QuantizationTransformPass(**cfg).apply(program, startup)
        n = sum(1 for op in program.global_block().ops
                if op.attrs.get("quantization_type") == "qat")
        yield self.diag("quant-transform-applied", Severity.INFO,
                        f"inserted fake quant-dequant around {n} ops")


@register_pass("quant_freeze")
class RegisteredQuantFreeze(Pass):
    """QuantizationFreezePass behind the pass registry. MUTATING — arms
    only when `context.scratch['quant_freeze']` carries
    {scope, **FreezePass kwargs}; no-ops otherwise."""

    def run(self, program, context):
        cfg = _armed(context, "quant_freeze")
        if cfg is None:
            return
        cfg = dict(cfg)
        scope = cfg.pop("scope")
        QuantizationFreezePass(**cfg).apply(program, scope)
        n = sum(1 for op in program.global_block().ops
                if op.type.startswith("quantized_"))
        yield self.diag("quant-freeze-applied", Severity.INFO,
                        f"rewrote {n} ops to int8 kernels")


def quantize_program(program, scope=None, *, plan=None,
                     startup_program=None, transform_kwargs=None,
                     freeze_kwargs=None, freeze=True, label="slim"):
    """The verify → pass → verify sandwich over the slim rewrites:
    structural verification brackets every mutation. `plan` must be None
    here (QuantPlan comes with the numerics analyzer); set an op's
    `skip_quant` attr to keep it in float. Returns the Diagnostics the
    armed passes emitted."""
    from paddle_tpu_torch import analysis

    if plan is not None:
        raise NotImplementedError(
            "quantize_program(plan=...) needs analysis.numerics.QuantPlan, "
            "which is not ported yet; set `skip_quant` on ops to keep them "
            "in float")
    analysis.verify_program(program, label=f"{label}:pre-quant")
    scratch = {"quant_transform": dict(transform_kwargs or {},
                                       startup_program=startup_program)}
    if freeze:
        enforce(scope is not None,
                "quantize_program(freeze=True) needs a scope")
        scratch["quant_freeze"] = dict(freeze_kwargs or {}, scope=scope)
    mgr = analysis.AnalysisManager(passes=["quant_transform"], raise_on=None)
    diags = list(mgr.run(program, label=f"{label}:transform",
                         scratch=scratch))
    analysis.verify_program(program, label=f"{label}:post-transform")
    if freeze:
        mgr = analysis.AnalysisManager(passes=["quant_freeze"],
                                       raise_on=None)
        diags.extend(mgr.run(program, label=f"{label}:freeze",
                             scratch=scratch))
        analysis.verify_program(program, label=f"{label}:post-freeze")
    return diags
