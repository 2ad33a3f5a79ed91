"""Static numerics analysis and quantization planning over Programs.

Counterpart of paddle_tpu/analysis/numerics.py. It decides where int8
is safe, what it saves and what it would break, before anything runs on
the card. Three layers, all pure walks of the Program:

* **Interval dataflow**: a per-var value range propagated through block
  0 in program order. Seeds are the exact [min, max] of the parameters
  given as numpy (`params`), the calibration ranges post-training
  quantization stamps on VarDesc attrs (`calib_abs_max`,
  slim/post_training_quantization.py), constant fills, and an unknown
  range (top) elsewhere. Per-op transfer rules cover the contraction,
  elementwise, activation, normalization, reduce, shape and quantized
  families (registry below).
* **Precision ladder**: a verdict per op (float32 -> bfloat16 ->
  fp8_e4m3 / int8), with the quant/dequant boundaries counted and a
  frozen quantized op that feeds another flagged (`redundant-requant`).
  float64 sits above the ladder (the `lint_float64` pass reports it).
* **`plan_quantization(program, mesh, hbm_budget)` -> QuantPlan**: joins
  the verdicts to the planner's `var_bytes` / `estimate_peak_memory`. A
  shadow clone of the Program with the eligible weights re-declared int8
  (plus per-channel scale vars) prices the frozen program's step peak
  without building it; `price_quantized_kv` prices a paged KV pool at
  int8 with per-block scales. Estimates register into the planner's
  cross-check (`QuantPlan.register_estimate`).

Hazard codes:

* ``int8-range-overflow`` (ERROR): a quantizable contraction deeper than
  the int32 accumulator holds, K * qmax^2 > 2^31 - 1 (K > 133,152 at 8
  bits).
* ``fp8-saturation-risk`` (WARNING): a calibrated activation range above
  the fp8 e4m3 maximum (448).
* ``uncalibrated-tensor`` (INFO): a quantizable activation with no
  calibrated range; run PTQ calibration first.
* ``redundant-requant`` (WARNING): a quantized op's output consumed by
  another quantized op.
* ``quant-quality-regression`` (ERROR): the deploy-time parity gate
  (`quant_parity_check`, `ModelRegistry.deploy` stage "verify").

`quantization_pass.quantize_program(plan=...)` consumes the plan's
vetoes; `NumericsPass` is registered as `lint_numerics` (opt-in, not in
the default lint pipeline).
"""
import math

import numpy as np

from paddle_tpu_torch.analysis.diagnostic import Diagnostic, Severity
from paddle_tpu_torch.analysis.framework import Pass, register_pass
from paddle_tpu_torch.analysis.planner import (MeshSpec, dtype_bytes,
                                         estimate_peak_memory,
                                         register_static_estimate,
                                         var_bytes)
from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import enforce

NUMERICS_PASSES = ("lint_numerics",)
PASS_NAME = "lint_numerics"

INT32_MAX = 2 ** 31 - 1
FP8_E4M3_MAX = 448.0
# |x̂| bound assumed for a standardized (zero-mean unit-var) normalization
# core — the heuristic the norm-family transfer rules use (≈8σ)
NORM_CORE_BOUND = 8.0
# the dtype ladder, cheapest storage last
RUNGS = ("float32", "bfloat16", "fp8_e4m3", "int8")

# op type -> (activation slot, weight slot) — mirrors
# slim.quantization_pass.QUANTIZABLE without importing slim at module
# import time (slim imports this package); test_torch_numerics asserts
# the two tables stay identical.
QUANT_OPS = {
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    "fc": ("Input", "W"),
}
_QUANT_CHANNEL_AXIS = {"conv2d": 0, "depthwise_conv2d": 0, "mul": 1,
                       "matmul": 1, "fc": 1}
_QUANTIZED_KERNELS = {"quantized_mul": ("X", "Y"),
                      "quantized_conv2d": ("Input", "Filter")}


# ---------------------------------------------------------------------------
# intervals
# ---------------------------------------------------------------------------

class Interval:
    """A closed value range [lo, hi] with a calibration pedigree.

    `calibrated` records whether the range descends from real data
    (param values, PTQ calib attrs, constant fills) — an uncalibrated
    interval may still be finite (e.g. a sigmoid output) but a
    quantizer should not trust it for scale selection."""

    __slots__ = ("lo", "hi", "calibrated")

    def __init__(self, lo, hi, calibrated=False):
        self.lo = float(lo)
        self.hi = float(hi)
        if self.lo > self.hi:
            self.lo, self.hi = self.hi, self.lo
        self.calibrated = bool(calibrated)

    @classmethod
    def top(cls):
        return cls(-math.inf, math.inf, calibrated=False)

    @classmethod
    def point(cls, v, calibrated=True):
        return cls(v, v, calibrated=calibrated)

    @classmethod
    def abs_bound(cls, m, calibrated=False):
        m = abs(float(m))
        return cls(-m, m, calibrated=calibrated)

    @property
    def is_top(self):
        return math.isinf(self.lo) or math.isinf(self.hi)

    def abs_max(self):
        return max(abs(self.lo), abs(self.hi))

    # -- arithmetic ----------------------------------------------------
    def _cal(self, other):
        return self.calibrated and other.calibrated

    def add(self, other):
        return Interval(self.lo + other.lo, self.hi + other.hi,
                        self._cal(other))

    def sub(self, other):
        return Interval(self.lo - other.hi, self.hi - other.lo,
                        self._cal(other))

    def mul(self, other):
        cands = [_prod(a, b) for a in (self.lo, self.hi)
                 for b in (other.lo, other.hi)]
        return Interval(min(cands), max(cands), self._cal(other))

    def div(self, other):
        if other.lo <= 0.0 <= other.hi:
            return Interval.top()      # divisor range spans zero
        inv = Interval(1.0 / other.hi, 1.0 / other.lo, other.calibrated)
        return self.mul(inv)

    def neg(self):
        return Interval(-self.hi, -self.lo, self.calibrated)

    def scaled(self, k, bias=0.0):
        a, b = self.lo * k + bias, self.hi * k + bias
        return Interval(min(a, b), max(a, b), self.calibrated)

    def clamp(self, lo, hi):
        """Range certainty comes from the clamp itself, so the result
        is calibrated even over a ⊤ input."""
        return Interval(max(self.lo, lo), min(max(self.hi, lo), hi),
                        calibrated=True)

    def join(self, other):
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi),
                        self._cal(other))

    def monotone(self, fn):
        return Interval(fn(self.lo), fn(self.hi), self.calibrated)

    def to_dict(self):
        def _f(v):
            return None if math.isinf(v) else round(v, 6)
        return {"lo": _f(self.lo), "hi": _f(self.hi),
                "calibrated": self.calibrated}

    def __repr__(self):
        tag = "cal" if self.calibrated else "⊤" if self.is_top else "est"
        return f"Interval[{self.lo:.4g}, {self.hi:.4g}]({tag})"


def _prod(a, b):
    # interval endpoints: 0 × ±inf is 0, not nan
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


def _join_all(ivs):
    out = None
    for iv in ivs:
        out = iv if out is None else out.join(iv)
    return out if out is not None else Interval.top()


# ---------------------------------------------------------------------------
# transfer-rule registry
# ---------------------------------------------------------------------------

_TRANSFER = {}          # op type -> (family, fn)


def register_transfer(family, *op_types):
    """Register one interval transfer rule for `op_types`. The rule
    takes (op, ctx) and returns an Interval (applied to every output)
    or a {output var name: Interval} dict."""

    def deco(fn):
        for t in op_types:
            enforce(t not in _TRANSFER,
                    "numerics transfer rule for %r registered twice", t)
            _TRANSFER[t] = (family, fn)
        return fn

    return deco


def numerics_covered_ops():
    """Sorted op types with an interval transfer rule (the JAX
    package's set, asserted by tests/test_torch_numerics.py)."""
    return sorted(_TRANSFER)


def transfer_families():
    """{family: sorted op types}."""
    fams = {}
    for t, (family, _) in _TRANSFER.items():
        fams.setdefault(family, []).append(t)
    return {f: sorted(ts) for f, ts in sorted(fams.items())}


class _RuleCtx:
    """What a transfer rule may look at: the interval env, the block
    (for shapes), and the shipped param values."""

    __slots__ = ("env", "block", "params", "batch_size")

    def __init__(self, env, block, params, batch_size):
        self.env = env
        self.block = block
        self.params = params or {}
        self.batch_size = batch_size

    def get(self, name):
        return self.env.get(name, Interval.top())

    def first_in(self, op, slot):
        names = op.inputs.get(slot) or []
        return self.get(names[0]) if names else Interval.top()

    def in_intervals(self, op):
        return [self.get(n) for names in op.inputs.values()
                for n in names]

    def shape(self, name):
        if self.block.has_var(name):
            return self.block.var(name).desc.shape
        return None

    def numel(self, name):
        shape = self.shape(name)
        if shape is None:
            return None
        n = 1
        for d in shape:
            n *= self.batch_size if d == -1 else int(d)
        return n


# -- shape / selection family (output values ⊆ input values) ---------------

_SHAPE_OPS = (
    "reshape", "reshape2", "flatten", "flatten2", "squeeze", "unsqueeze",
    "transpose", "transpose2", "expand", "expand_as", "slice",
    "strided_slice", "split", "gather", "gather_nd", "reverse", "flip",
    "roll", "crop_tensor", "unstack", "unfold", "im2sequence",
    "space_to_depth", "pixel_shuffle", "shuffle_channel",
    "sequence_reshape", "sequence_reverse", "sequence_slice",
    "sequence_unpad", "sequence_expand", "temporal_shift", "tril_triu",
    "diag", "getitem",
    # lazily registered on first pt.static.Print() — a debug passthrough,
    # so the identity transfer is exact
    "print",
)


@register_transfer("shape", *_SHAPE_OPS)
def _t_shape(op, ctx):
    return _join_all(ctx.in_intervals(op))


@register_transfer("shape", "cast")
def _t_cast(op, ctx):
    iv = _join_all(ctx.in_intervals(op))
    dt = str(op.attrs.get("out_dtype", op.attrs.get("dtype", "")))
    if dt in ("bool",):
        return Interval(0.0, 1.0, calibrated=True)
    if dt in ("int8", "uint8", "int16", "int32", "int64"):
        info = np.iinfo(dt)
        return Interval(max(iv.lo, info.min), min(iv.hi, info.max),
                        iv.calibrated)
    return iv


# -- join family (output drawn from the union of inputs) -------------------

@register_transfer("join", "concat", "stack", "sequence_concat",
                   "multiplex", "where", "pad", "pad2d",
                   "pad_constant_like", "sequence_pad", "label_smooth",
                   "meshgrid")
def _t_join(op, ctx):
    iv = _join_all(ctx.in_intervals(op))
    pad = op.attrs.get("pad_value", op.attrs.get("value"))
    if pad is not None and isinstance(pad, (int, float)):
        iv = iv.join(Interval.point(float(pad)))
    if op.type == "label_smooth":
        iv = iv.join(Interval(0.0, 1.0, calibrated=True))
    return iv


# -- pooling (selection / convex combination of the window) ----------------

@register_transfer("pool", "pool2d", "pool3d", "spp", "sequence_pool",
                   "max_pool2d_with_index", "maxout", "prroi_pool",
                   "roi_pool", "roi_align", "psroi_pool",
                   "sequence_topk_avg_pooling", "unpool")
def _t_pool(op, ctx):
    return _join_all(ctx.in_intervals(op))


# -- bounded activations ---------------------------------------------------

_FIXED_RANGE = {
    "sigmoid": (0.0, 1.0), "hard_sigmoid": (0.0, 1.0),
    "softmax": (0.0, 1.0), "sequence_softmax": (0.0, 1.0),
    "tanh": (-1.0, 1.0), "softsign": (-1.0, 1.0), "sign": (-1.0, 1.0),
    "sin": (-1.0, 1.0), "cos": (-1.0, 1.0), "erf": (-1.0, 1.0),
    "cos_sim": (-1.0, 1.0), "l2_normalize": (-1.0, 1.0),
    "one_hot": (0.0, 1.0), "sequence_mask": (0.0, 1.0),
    "accuracy": (0.0, 1.0), "dice_loss": (0.0, 1.0),
    "mean_iou": (0.0, 1.0),
}


@register_transfer("activation", *_FIXED_RANGE)
def _t_fixed(op, ctx):
    lo, hi = _FIXED_RANGE[op.type]
    return Interval(lo, hi, calibrated=True)


@register_transfer("activation", "relu", "relu6", "brelu", "leaky_relu",
                   "elu", "selu", "gelu", "swish", "hard_swish",
                   "soft_relu", "softplus", "thresholded_relu", "prelu",
                   "stanh", "hard_shrink", "softshrink", "logsigmoid",
                   "log_softmax")
def _t_relu_like(op, ctx):
    x = _join_all(ctx.in_intervals(op))
    t = op.type
    if t == "relu":
        return Interval(max(x.lo, 0.0), max(x.hi, 0.0), x.calibrated)
    if t == "relu6":
        return x.clamp(0.0, 6.0)
    if t == "brelu":
        return x.clamp(float(op.attrs.get("t_min", 0.0)),
                       float(op.attrs.get("t_max", 24.0)))
    if t == "leaky_relu":
        a = float(op.attrs.get("alpha", 0.02))
        return Interval(min(x.lo, a * x.lo), max(x.hi, a * x.hi),
                        x.calibrated)
    if t == "elu":
        a = abs(float(op.attrs.get("alpha", 1.0)))
        return Interval(max(-a, min(x.lo, 0.0)), max(x.hi, 0.0),
                        x.calibrated)
    if t == "selu":
        # scale*alpha ≈ 1.7581: the fixed lower asymptote
        return Interval(max(-1.7581, min(x.lo, 0.0)),
                        1.0507 * max(x.hi, 0.0), x.calibrated)
    if t == "gelu":
        return Interval(min(-0.17, x.lo if x.lo > -0.17 else -0.17)
                        if x.lo < 0 else 0.0,
                        max(x.hi, 0.0), x.calibrated)
    if t == "swish":
        return Interval(-0.2785 if x.lo < 0 else 0.0, max(x.hi, 0.0),
                        x.calibrated)
    if t == "hard_swish":
        return Interval(-0.375 if x.lo < 0 else 0.0, max(x.hi, 0.0),
                        x.calibrated)
    if t in ("soft_relu", "softplus"):
        hi = math.inf if math.isinf(x.hi) else max(x.hi, 0.0) + 0.6932
        return Interval(0.0, hi, x.calibrated)
    if t == "thresholded_relu":
        return Interval(0.0, max(x.hi, 0.0), x.calibrated)
    if t == "prelu":
        # learned alpha assumed ∈ [0, 1] (documented heuristic)
        return Interval(min(x.lo, 0.0), max(x.hi, 0.0), x.calibrated)
    if t == "stanh":
        b = abs(float(op.attrs.get("scale_b", 1.7159)))
        return Interval(-b, b, calibrated=True)
    if t in ("hard_shrink", "softshrink"):
        return Interval(min(x.lo, 0.0), max(x.hi, 0.0), x.calibrated)
    if t in ("logsigmoid", "log_softmax"):
        lo = -math.inf if math.isinf(x.lo) else min(x.lo, 0.0) - 0.6932
        return Interval(lo, 0.0, x.calibrated)
    return Interval.top()     # pragma: no cover - list above is closed


# -- monotone / simple unary ----------------------------------------------

@register_transfer("unary", "exp", "log", "sqrt", "rsqrt", "square",
                   "abs", "floor", "ceil", "round", "reciprocal",
                   "increment", "scale", "pow", "clip", "clip_by_norm",
                   "logical_not")
def _t_unary(op, ctx):
    x = _join_all(ctx.in_intervals(op))
    t = op.type
    if t == "exp":
        return x.monotone(lambda v: math.exp(min(v, 700.0)))
    if t == "log":
        if x.lo <= 0.0:
            return Interval(-math.inf,
                            math.log(x.hi) if 0 < x.hi < math.inf
                            else math.inf, False)
        return x.monotone(math.log)
    if t == "sqrt":
        return Interval(math.sqrt(max(x.lo, 0.0)),
                        math.sqrt(max(x.hi, 0.0)) if x.hi < math.inf
                        else math.inf, x.calibrated)
    if t == "rsqrt":
        if x.lo <= 0.0:
            return Interval(0.0, math.inf, False)
        return Interval(1.0 / math.sqrt(x.hi), 1.0 / math.sqrt(x.lo),
                        x.calibrated)
    if t == "square":
        m = x.abs_max()
        lo = 0.0 if x.lo <= 0.0 <= x.hi else min(x.lo ** 2, x.hi ** 2)
        return Interval(lo, m * m if m < math.inf else math.inf,
                        x.calibrated)
    if t == "abs":
        lo = 0.0 if x.lo <= 0.0 <= x.hi else min(abs(x.lo), abs(x.hi))
        return Interval(lo, x.abs_max(), x.calibrated)
    if t in ("floor", "ceil", "round"):
        fn = {"floor": math.floor, "ceil": math.ceil,
              "round": round}[t]
        return Interval(fn(x.lo) if not math.isinf(x.lo) else x.lo,
                        fn(x.hi) if not math.isinf(x.hi) else x.hi,
                        x.calibrated)
    if t == "reciprocal":
        return Interval.point(1.0).div(x)
    if t == "increment":
        return x.scaled(1.0, bias=float(op.attrs.get("step", 1.0)))
    if t == "scale":
        return x.scaled(float(op.attrs.get("scale", 1.0)),
                        bias=float(op.attrs.get("bias", 0.0)))
    if t == "pow":
        f = float(op.attrs.get("factor", 1.0))
        if f == int(f) and f >= 0:
            out = Interval.point(1.0, x.calibrated)
            for _ in range(int(f)):
                out = out.mul(x)
            return out
        return Interval.top()
    if t == "clip":
        return x.clamp(float(op.attrs.get("min", -math.inf)),
                       float(op.attrs.get("max", math.inf)))
    if t == "clip_by_norm":
        m = abs(float(op.attrs.get("max_norm", 1.0)))
        return Interval(max(x.lo, -m), min(x.hi, m), calibrated=True)
    if t == "logical_not":
        return Interval(0.0, 1.0, calibrated=True)
    return Interval.top()     # pragma: no cover - list above is closed


# -- comparisons (boolean outputs) ----------------------------------------

@register_transfer("compare", "equal", "not_equal", "greater_equal",
                   "greater_than", "less_equal", "less_than",
                   "logical_and", "logical_or", "logical_xor",
                   "is_empty", "isfinite", "has_inf", "has_nan")
def _t_compare(op, ctx):
    return Interval(0.0, 1.0, calibrated=True)


# -- elementwise binary ----------------------------------------------------

@register_transfer("elementwise", "elementwise_add", "elementwise_sub",
                   "elementwise_mul", "elementwise_div",
                   "elementwise_max", "elementwise_min",
                   "elementwise_mod", "elementwise_floordiv",
                   "elementwise_pow", "sum", "cumsum")
def _t_elementwise(op, ctx):
    t = op.type
    ivs = ctx.in_intervals(op)
    if t == "sum":
        out = None
        for iv in ivs:
            out = iv if out is None else out.add(iv)
        return out if out is not None else Interval.top()
    if t == "cumsum":
        x = _join_all(ivs)
        axis = op.attrs.get("axis", -1)
        shape = op.inputs.get("X") and ctx.shape(op.inputs["X"][0])
        if shape:
            d = shape[int(axis)]
            n = ctx.batch_size if d == -1 else int(d)
            return Interval(min(n * x.lo, x.lo), max(n * x.hi, x.hi),
                            x.calibrated)
        return Interval.top()
    x, y = (ivs + [Interval.top(), Interval.top()])[:2]
    if t == "elementwise_add":
        return x.add(y)
    if t == "elementwise_sub":
        return x.sub(y)
    if t == "elementwise_mul":
        return x.mul(y)
    if t == "elementwise_div":
        return x.div(y)
    if t == "elementwise_max":
        return Interval(max(x.lo, y.lo), max(x.hi, y.hi), x._cal(y))
    if t == "elementwise_min":
        return Interval(min(x.lo, y.lo), min(x.hi, y.hi), x._cal(y))
    if t in ("elementwise_mod", "elementwise_floordiv"):
        m = y.abs_max()
        if math.isinf(m):
            return Interval.top()
        if t == "elementwise_mod":
            return Interval(-m, m, x._cal(y))
        return x.div(y).monotone(
            lambda v: math.floor(v) if not math.isinf(v) else v)
    if t == "elementwise_pow":
        if 0 <= y.lo and y.hi < math.inf and 0 <= x.lo:
            hi = max(x.hi ** y.hi, 1.0) if x.hi < math.inf else math.inf
            return Interval(0.0, hi, x._cal(y))
        return Interval.top()
    return Interval.top()     # pragma: no cover - list above is closed


# -- matmul / convolution (contractions) -----------------------------------

_CONTRACTION_OPS = ("mul", "matmul", "matmul_v2", "fc", "conv2d",
                    "depthwise_conv2d", "conv2d_transpose", "conv3d",
                    "conv3d_transpose", "sequence_conv")


def contraction_depth(op, block, batch_size=1):
    """Accumulation length K of one contraction op — the number of
    int8×int8 products summed per output element (the int32-overflow
    denominator). None when the weight shape is unknown."""
    w_slot = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
              "conv2d_transpose": "Filter", "conv3d": "Filter",
              "conv3d_transpose": "Filter", "sequence_conv": "Filter",
              "fc": "W", "quantized_conv2d": "Filter"}.get(op.type, "Y")
    names = op.inputs.get(w_slot) or []
    if not names or not block.has_var(names[0]):
        return None
    shape = block.var(names[0]).desc.shape
    if not shape:
        return None
    dims = [batch_size if d == -1 else int(d) for d in shape]
    if op.type in ("conv2d", "depthwise_conv2d", "conv2d_transpose",
                   "conv3d", "conv3d_transpose", "quantized_conv2d"):
        # OIHW(±D): every dim but the output channels contracts
        k = 1
        for d in dims[1:]:
            k *= d
        return k
    if len(dims) >= 2:
        # [K, N] GEMM weights (mul/matmul/fc/quantized_mul)
        return dims[0]
    return dims[0]


@register_transfer("matmul", *_CONTRACTION_OPS)
def _t_contraction(op, ctx):
    act_slot, w_slot = QUANT_OPS.get(
        op.type, ("X", "Filter" if "conv" in op.type else "Y"))
    x = ctx.first_in(op, act_slot)
    w = ctx.first_in(op, w_slot)
    k = contraction_depth(op, ctx.block, ctx.batch_size)
    if k is None or x.is_top or w.is_top:
        return Interval.top()
    bound = k * x.abs_max() * w.abs_max()
    return Interval.abs_bound(bound, calibrated=x._cal(w))


@register_transfer("matmul", *_QUANTIZED_KERNELS)
def _t_quantized(op, ctx):
    x_scale = float(op.attrs.get("x_scale", 0.0))
    w_slot = "Y" if op.type == "quantized_mul" else "Filter"
    s_slot = "YScale" if op.type == "quantized_mul" else "FilterScale"
    s = ctx.first_in(op, s_slot)
    k = contraction_depth(op, ctx.block, ctx.batch_size)
    if x_scale <= 0.0 or k is None:
        return Interval.top()
    w_max = s.abs_max() if not s.is_top else 1.0
    return Interval.abs_bound(k * x_scale * w_max,
                              calibrated=not s.is_top)


@register_transfer("matmul", "fake_quantize_dequantize_abs_max",
                   "fake_channel_wise_quantize_dequantize_abs_max",
                   "fake_quantize_dequantize_moving_average_abs_max")
def _t_fake_quant(op, ctx):
    x = ctx.first_in(op, "X")
    out = {}
    for name in op.outputs.get("Out", []):
        out[name] = x            # qdq output ⊆ input range
    for name in op.outputs.get("OutScale", []):
        hi = x.abs_max()
        out[name] = Interval(0.0, hi if hi < math.inf else math.inf,
                             x.calibrated)
    return out


# -- normalization ---------------------------------------------------------

@register_transfer("norm", "batch_norm", "sync_batch_norm", "layer_norm",
                   "instance_norm", "group_norm", "data_norm")
def _t_norm(op, ctx):
    gamma = _join_all([ctx.get(n)
                       for n in op.inputs.get("Scale", [])]) \
        if op.inputs.get("Scale") else Interval(-1.0, 1.0)
    beta = _join_all([ctx.get(n) for n in op.inputs.get("Bias", [])]) \
        if op.inputs.get("Bias") else Interval.point(0.0)
    if gamma.is_top or beta.is_top:
        return Interval.top()
    bound = NORM_CORE_BOUND * gamma.abs_max() + beta.abs_max()
    # the standardized core bounds the output regardless of the input
    # range — calibrated whenever γ/β are
    out = Interval.abs_bound(bound,
                             calibrated=gamma.calibrated
                             and beta.calibrated)
    res = {}
    for slot, names in op.outputs.items():
        for name in names:
            if slot in ("Y", "Out", "Output"):
                res[name] = out
            else:
                res[name] = Interval.top()   # saved mean/var side outputs
    return res


@register_transfer("norm", "lrn", "spectral_norm")
def _t_norm_contained(op, ctx):
    return _join_all(ctx.in_intervals(op))


# -- reductions ------------------------------------------------------------

@register_transfer("reduce", "reduce_sum", "reduce_mean", "reduce_max",
                   "reduce_min", "reduce_prod", "reduce_all",
                   "reduce_any", "mean", "frobenius_norm", "l1_norm",
                   "squared_l2_norm", "squared_l2_distance")
def _t_reduce(op, ctx):
    t = op.type
    x = _join_all(ctx.in_intervals(op))
    if t in ("reduce_all", "reduce_any"):
        return Interval(0.0, 1.0, calibrated=True)
    if t in ("reduce_mean", "reduce_max", "reduce_min", "mean"):
        return x
    n = None
    names = op.inputs.get("X") or []
    if names:
        n = ctx.numel(names[0])
    if n is None or x.is_top:
        if t in ("frobenius_norm", "l1_norm", "squared_l2_norm",
                 "squared_l2_distance"):
            return Interval(0.0, math.inf, False)
        return Interval.top()
    m = x.abs_max()
    if t == "reduce_sum":
        return Interval.abs_bound(n * m, x.calibrated)
    if t == "reduce_prod":
        if m <= 1.0:
            return Interval(-1.0, 1.0, x.calibrated)
        return Interval.top()
    if t == "frobenius_norm":
        return Interval(0.0, math.sqrt(n) * m, x.calibrated)
    if t == "l1_norm":
        return Interval(0.0, n * m, x.calibrated)
    if t in ("squared_l2_norm", "squared_l2_distance"):
        return Interval(0.0, n * m * m * (4 if "distance" in t else 1),
                        x.calibrated)
    return Interval.top()     # pragma: no cover - list above is closed


# -- constants / fills -----------------------------------------------------

@register_transfer("constant", "fill_constant",
                   "fill_constant_batch_size_like", "fill_any_like")
def _t_fill(op, ctx):
    v = op.attrs.get("value", 0.0)
    try:
        return Interval.point(float(v))
    except (TypeError, ValueError):
        return Interval.top()


@register_transfer("constant", "zeros_like")
def _t_zeros(op, ctx):
    return Interval.point(0.0)


@register_transfer("constant", "ones_like")
def _t_ones(op, ctx):
    return Interval.point(1.0)


@register_transfer("constant", "eye")
def _t_eye(op, ctx):
    return Interval(0.0, 1.0, calibrated=True)


@register_transfer("constant", "uniform_random",
                   "uniform_random_batch_size_like")
def _t_uniform(op, ctx):
    return Interval(float(op.attrs.get("min", -1.0)),
                    float(op.attrs.get("max", 1.0)), calibrated=True)


@register_transfer("constant", "range", "linspace")
def _t_range(op, ctx):
    return Interval.top()     # endpoints arrive as tensors


# -- embeddings ------------------------------------------------------------

@register_transfer("embedding", "lookup_table", "lookup_table_v2")
def _t_embedding(op, ctx):
    return ctx.first_in(op, "W")       # rows of the table


# -- losses (non-negative scalars) -----------------------------------------

@register_transfer("loss", "cross_entropy", "softmax_with_cross_entropy",
                   "sigmoid_cross_entropy_with_logits", "log_loss",
                   "hinge_loss", "huber_loss", "mse_loss",
                   "square_error_cost", "kldiv_loss", "smooth_l1_loss",
                   "rank_loss", "margin_rank_loss", "npair_loss",
                   "sigmoid_focal_loss", "modified_huber_loss",
                   "teacher_student_sigmoid_loss")
def _t_loss(op, ctx):
    res = {}
    for slot, names in op.outputs.items():
        for name in names:
            if slot == "Softmax":
                res[name] = Interval(0.0, 1.0, calibrated=True)
            else:
                res[name] = Interval(0.0, math.inf, False)
    return res


# -- dropout (inverted scaling at train time) ------------------------------

@register_transfer("elementwise", "dropout")
def _t_dropout(op, ctx):
    x = _join_all(ctx.in_intervals(op))
    p = float(op.attrs.get("dropout_prob", 0.5))
    if op.attrs.get("is_test") or p <= 0.0 or p >= 1.0:
        return x.join(Interval.point(0.0, x.calibrated))
    return x.scaled(1.0 / (1.0 - p)).join(
        Interval.point(0.0, x.calibrated))


# ---------------------------------------------------------------------------
# interval dataflow
# ---------------------------------------------------------------------------

CALIB_ATTR = "calib_abs_max"
CALIB_ALGO_ATTR = "calib_algo"


def seed_intervals(program, params=None, batch_size=1):
    """The initial environment: exact param ranges, PTQ calibration
    attrs, ⊤ elsewhere."""
    env = {}
    block = program.global_block()
    params = params or {}
    for name, d in block.vars.items():
        calib = d.attrs.get(CALIB_ATTR)
        if name in params:
            arr = np.asarray(params[name])
            if arr.size and np.issubdtype(arr.dtype, np.number):
                env[name] = Interval(float(arr.min()), float(arr.max()),
                                     calibrated=True)
                continue
        if calib is not None:
            try:
                env[name] = Interval.abs_bound(float(calib),
                                               calibrated=True)
                continue
            except (TypeError, ValueError):
                pass
        env[name] = Interval.top()
    return env


def propagate_intervals(program, params=None, batch_size=1):
    """Run the transfer rules over block 0 in program order; returns
    the final {var name: Interval} environment. Ops without a rule
    write ⊤ to their outputs — soundly unknown, never silently wrong."""
    block = program.global_block()
    env = seed_intervals(program, params=params, batch_size=batch_size)
    ctx = _RuleCtx(env, block, params, batch_size)
    for op in block.ops:
        rule = _TRANSFER.get(op.type)
        if rule is None:
            for name in op.output_names():
                if name not in env or env[name].is_top:
                    env[name] = Interval.top()
            continue
        _, fn = rule
        res = fn(op, ctx)
        if isinstance(res, Interval):
            res = {name: res for name in op.output_names()}
        for name, iv in (res or {}).items():
            # calibration attrs (PTQ-observed) beat derived bounds
            seeded = env.get(name)
            if seeded is not None and seeded.calibrated \
                    and not seeded.is_top and block.has_var(name) \
                    and block.var(name).desc.attrs.get(CALIB_ATTR) \
                    is not None:
                continue
            env[name] = iv
    return env


# ---------------------------------------------------------------------------
# precision ladder + hazards
# ---------------------------------------------------------------------------

class LadderVerdict:
    """One op's dtype-ladder verdict: the chosen rung, every feasible
    rung, and why the lower rungs were refused."""

    __slots__ = ("op_index", "op_type", "rung", "feasible", "reasons")

    def __init__(self, op_index, op_type, rung, feasible, reasons):
        self.op_index = op_index
        self.op_type = op_type
        self.rung = rung
        self.feasible = list(feasible)
        self.reasons = list(reasons)

    def to_dict(self):
        return {"op_index": self.op_index, "op_type": self.op_type,
                "rung": self.rung, "feasible": self.feasible,
                "reasons": self.reasons}


# op families the bf16 rung is safe for (no long accumulations in f32)
_BF16_FAMILIES = frozenset({"shape", "join", "pool", "activation",
                            "unary", "compare", "elementwise", "matmul",
                            "embedding", "constant"})


def _var_dtype(block, name):
    """Canonical dtype NAME of a block var (descs hold normalized
    dtypes, so a raw str() would not equal "float64")."""
    if not block.has_var(name):
        return ""
    return dtype_name(block.var(name).desc.dtype) or ""


def _weight_param(block, op):
    """(weight name, channel axis) when `op` is quantizable with a
    parameter weight; (None, None) otherwise."""
    slots = QUANT_OPS.get(op.type)
    if slots is None:
        return None, None
    ws = op.inputs.get(slots[1]) or []
    if not ws or not block.has_var(ws[0]) \
            or not block.var(ws[0]).desc.is_parameter:
        return None, None
    return ws[0], _QUANT_CHANNEL_AXIS[op.type]


class NumericsReport:
    """Everything one analysis run produced: the interval environment,
    the per-op ladder, the hazard diagnostics, and the quant/dequant
    boundary accounting."""

    __slots__ = ("intervals", "ladder", "diagnostics", "boundaries",
                 "regions", "covered_ops", "uncovered_ops")

    def __init__(self, intervals, ladder, diagnostics, boundaries,
                 regions, covered_ops, uncovered_ops):
        self.intervals = intervals
        self.ladder = ladder
        self.diagnostics = diagnostics
        self.boundaries = boundaries
        self.regions = regions
        self.covered_ops = covered_ops
        self.uncovered_ops = uncovered_ops

    def verdict(self, op_index):
        for v in self.ladder:
            if v.op_index == op_index:
                return v
        return None

    def to_dict(self):
        return {
            "ladder": [v.to_dict() for v in self.ladder],
            "boundaries": self.boundaries,
            "regions": self.regions,
            "covered_ops": self.covered_ops,
            "uncovered_ops": self.uncovered_ops,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }


def _qmax(bits):
    return 2 ** (int(bits) - 1) - 1


def analyze_numerics(program, params=None, batch_size=1,
                     pass_name=PASS_NAME):
    """The full static numerics run: interval dataflow, dtype-ladder
    verdicts, hazard diagnostics, quant/dequant boundary accounting.
    A pure walk of the Program: nothing runs."""
    block = program.global_block()
    env = propagate_intervals(program, params=params,
                              batch_size=batch_size)
    diags = []
    ladder = []
    covered = uncovered = 0
    producer_rung = {}        # var name -> rung of its producer op

    def diag(code, severity, message, **kw):
        kw.setdefault("pass_name", pass_name)
        kw.setdefault("block_idx", 0)
        diags.append(Diagnostic(code, severity, message, **kw))

    for i, op in enumerate(block.ops):
        family = _TRANSFER.get(op.type, (None, None))[0]
        if family is None:
            uncovered += 1
        else:
            covered += 1
        feasible = ["float32"]
        reasons = []
        rung = "float32"

        # float64 anywhere on the op: above the ladder entirely (the
        # tpu-float64 lint reports it; the ladder refuses every rung)
        f64 = [n for n in list(op.input_names())
               + list(op.output_names())
               if _var_dtype(block, n) == "float64"]
        if f64:
            ladder.append(LadderVerdict(
                i, op.type, "float64", [],
                [f"float64 operand {f64[0]!r} sits above the dtype "
                 f"ladder (see tpu-float64)"]))
            for name in op.output_names():
                producer_rung[name] = "float64"
            continue

        w_name, _ = _weight_param(block, op)
        bits = int(op.attrs.get("bit_length", 8) or 8)
        if w_name is not None:
            act_slot = QUANT_OPS[op.type][0]
            acts = op.inputs.get(act_slot) or []
            act_name = acts[0] if acts else None
            act_iv = env.get(act_name, Interval.top()) if act_name \
                else Interval.top()
            k = contraction_depth(op, block, batch_size)
            feasible.append("bfloat16")
            overflow = (k is not None
                        and k * _qmax(bits) * _qmax(bits) > INT32_MAX)
            if overflow:
                diag("int8-range-overflow", Severity.ERROR,
                     f"contraction depth K={k} overflows the int32 "
                     f"accumulator at {bits}-bit operands "
                     f"(K·qmax² = {k * _qmax(bits) ** 2} > {INT32_MAX})",
                     op_index=i, op_type=op.type, var=w_name,
                     hint="split the contraction, widen the "
                          "accumulator, or keep this op in bf16/f32")
                reasons.append(f"int8 refused: K={k} overflows int32")
                rung = "bfloat16"
            else:
                feasible.append("int8")
            if act_name and act_iv.is_top and not act_iv.calibrated:
                diag("uncalibrated-tensor", Severity.INFO,
                     f"quantizable activation {act_name!r} has no "
                     f"calibrated range (⊤ interval)",
                     op_index=i, op_type=op.type, var=act_name,
                     hint="run slim.PostTrainingQuantization to record "
                          f"{CALIB_ATTR} on the var")
                reasons.append("int8 deferred: activation uncalibrated")
                if rung == "float32":
                    rung = "bfloat16"
            elif not overflow:
                rung = "int8"
                if act_iv.abs_max() > FP8_E4M3_MAX:
                    diag("fp8-saturation-risk", Severity.WARNING,
                         f"activation range ±{act_iv.abs_max():.1f} "
                         f"exceeds the fp8 e4m3 max "
                         f"({FP8_E4M3_MAX:.0f}) — the fp8 rung would "
                         f"saturate",
                         op_index=i, op_type=op.type, var=act_name,
                         hint="clamp the activation or serve this op "
                              "at int8/bf16")
                    reasons.append("fp8 refused: range exceeds e4m3 max")
                else:
                    feasible.append("fp8_e4m3")
        elif op.type in _QUANTIZED_KERNELS:
            k = contraction_depth(op, block, batch_size)
            if k is not None and k * _qmax(bits) * _qmax(bits) \
                    > INT32_MAX:
                diag("int8-range-overflow", Severity.ERROR,
                     f"frozen kernel contraction depth K={k} overflows "
                     f"the int32 accumulator at {bits}-bit operands",
                     op_index=i, op_type=op.type,
                     hint="split the contraction or re-freeze at fewer "
                          "bits of depth")
            rung = "int8"
            feasible = ["int8"]
        elif family in _BF16_FAMILIES:
            rung = "bfloat16"
            feasible.append("bfloat16")
        else:
            reasons.append("accumulation-sensitive family; stays f32"
                           if family else "no transfer rule; stays f32")
        ladder.append(LadderVerdict(i, op.type, rung, feasible, reasons))
        for name in op.output_names():
            producer_rung[name] = rung

    # quant/dequant boundary accounting + redundant-requant detection
    boundaries = 0
    regions = 0
    prev_int8 = False
    for i, op in enumerate(block.ops):
        v = ladder[i] if i < len(ladder) else None
        is_int8 = v is not None and v.rung == "int8"
        if is_int8 and not prev_int8:
            regions += 1
        prev_int8 = is_int8
        for name in op.input_names():
            src = producer_rung.get(name)
            if src is None:
                continue
            if (src == "int8") != is_int8:
                boundaries += 1
        if op.type in _QUANTIZED_KERNELS:
            act_slot = _QUANTIZED_KERNELS[op.type][0]
            for name in op.inputs.get(act_slot) or []:
                if producer_rung.get(name) == "int8":
                    diag("redundant-requant", Severity.WARNING,
                         f"input {name!r} is a quantized op's output "
                         f"re-quantized here — dequant→requant "
                         f"ping-pong on the hot path",
                         op_index=i, op_type=op.type, var=name,
                         hint="fuse the int8 region (keep the "
                              "intermediate quantized) instead of "
                              "round-tripping through float")

    return NumericsReport(env, ladder, diags, boundaries, regions,
                          covered, uncovered)


@register_pass(PASS_NAME)
class NumericsPass(Pass):
    """Registered read-only wrapper over `analyze_numerics`. Opt-in
    like the planner: not part of ALL_PASSES, so default lint_graph
    output stays stable."""

    def run(self, program, context):
        params = getattr(context, "params", None) if context else None
        return analyze_numerics(program, params=params).diagnostics


# ---------------------------------------------------------------------------
# deploy-time parity gate
# ---------------------------------------------------------------------------

def quant_parity_check(outputs, reference, threshold=0.05,
                       pass_name=PASS_NAME):
    """Parity of quantized outputs vs the fp32 oracle: worst
    mean-relative-error across fetch tensors. Returns
    (rel_err, Diagnostic or None) — the Diagnostic is the ERROR
    `quant-quality-regression` `ModelRegistry.deploy` aborts on at
    stage "verify" (pre-commit, so the rollback contract holds)."""
    outputs = list(outputs)
    reference = list(reference)
    enforce(len(outputs) == len(reference),
            "parity check: %d outputs vs %d reference tensors",
            len(outputs), len(reference))
    worst = 0.0
    for q, r in zip(outputs, reference):
        q = np.asarray(q, np.float64)
        r = np.asarray(r, np.float64)
        denom = max(float(np.mean(np.abs(r))), 1e-6)
        worst = max(worst, float(np.mean(np.abs(q - r))) / denom)
    if worst > threshold:
        return worst, Diagnostic(
            "quant-quality-regression", Severity.ERROR,
            f"quantized outputs diverge from the fp32 oracle: mean "
            f"relative error {worst:.4f} > threshold {threshold:.4f}",
            hint="recalibrate (more batches / hist algo), keep the "
                 "offending ops in float, or raise the deploy "
                 "threshold deliberately", pass_name=pass_name)
    return worst, None


# ---------------------------------------------------------------------------
# quantized-KV pricing (estimate_paged_rungs-style geometry accounting)
# ---------------------------------------------------------------------------

def price_quantized_kv(engine=None, *, num_layers=None, num_heads=None,
                       head_dim=None, block_size=None, num_blocks=None,
                       blocks_per_slot=None):
    """Statically price a paged KV pool at int8 with PER-BLOCK scales
    (one f32 scale per (k|v, layer, block)): bytes per block, pool
    bytes, HBM saved, and the capacity multipliers — how many MORE
    decode slots and prefix-cache blocks the same pool HBM holds.
    Geometry comes from a PagedDecodeEngine or explicit kwargs; pure
    arithmetic: nothing runs."""
    if engine is not None:
        cfg = engine.model.config
        num_layers = cfg.num_layers
        num_heads = cfg.num_heads
        head_dim = cfg.head_dim
        block_size = engine.block_size
        num_blocks = engine.num_blocks
        blocks_per_slot = getattr(engine, "blocks_per_slot",
                                  blocks_per_slot)
    enforce(None not in (num_layers, num_heads, head_dim, block_size,
                         num_blocks),
            "price_quantized_kv needs an engine or the full geometry")
    elems = 2 * num_layers * block_size * num_heads * head_dim  # k + v
    block_f32 = elems * 4
    scales = 2 * num_layers * 4           # per-block k/v scales per layer
    block_int8 = elems * 1 + scales
    pool_f32 = block_f32 * num_blocks
    blocks_int8_same_hbm = pool_f32 // block_int8
    ratio = block_f32 / block_int8
    out = {
        "geometry": {"num_layers": num_layers, "num_heads": num_heads,
                     "head_dim": head_dim, "block_size": block_size,
                     "num_blocks": num_blocks,
                     "blocks_per_slot": blocks_per_slot},
        "block_bytes_f32": block_f32,
        "block_bytes_int8": block_int8,
        "scales_bytes_per_block": scales,
        "pool_bytes_f32": pool_f32,
        "pool_bytes_int8": block_int8 * num_blocks,
        "hbm_saved_bytes": (block_f32 - block_int8) * num_blocks,
        "blocks_at_same_hbm": int(blocks_int8_same_hbm),
        "prefix_cache_capacity_multiplier": round(ratio, 3),
    }
    if blocks_per_slot:
        slots_f32 = num_blocks // blocks_per_slot
        slots_int8 = blocks_int8_same_hbm // blocks_per_slot
        out["servable_slots_f32"] = int(slots_f32)
        out["servable_slots_int8"] = int(slots_int8)
        out["servable_slots_multiplier"] = round(
            slots_int8 / slots_f32, 3) if slots_f32 else None
    else:
        out["servable_slots_multiplier"] = round(ratio, 3)
    return out


# ---------------------------------------------------------------------------
# QuantPlan
# ---------------------------------------------------------------------------

def quant_working_bytes(block, weights, batch_size=1):
    """The largest working set one frozen quantized op of the port holds
    besides its inputs and output (slim/quant_ops.py): quantized_conv2d
    computes its exact accumulator as a float64 GEMM of unfolded codes,
    so the float64 columns [N, C * kh * kw, L], the float64 filter
    [O, C / g * kh * kw] and the float64 accumulator [N, O, L] are alive
    at once; quantized_mul runs K8, which quantizes on the fly into an
    int32 tile and makes no operand copy. Where the JAX package prices a
    widened int32 copy of the largest weight, this is the port's
    counterpart (ROADMAP Queue 3)."""
    best = 0
    for w in weights:
        if w["vetoed"] or w["op_type"] not in ("conv2d", "depthwise_conv2d"):
            continue
        op = block.ops[w["op_index"]]
        shapes = []
        for slot, names in (("Input", op.inputs), ("Filter", op.inputs),
                            ("Output", op.outputs)):
            name = (names.get(slot) or [None])[0]
            shape = block.var(name).desc.shape \
                if name and block.has_var(name) else None
            if not shape:
                break
            shapes.append([batch_size if d == -1 else int(d)
                           for d in shape])
        if len(shapes) != 3 or len(shapes[0]) != 4 or len(shapes[2]) != 4:
            continue
        (n, c, _, _), (o, cg, kh, kw), (_, _, oh, ow) = shapes
        cols = n * c * kh * kw * oh * ow
        best = max(best, 8 * (cols + o * cg * kh * kw + n * o * oh * ow))
    return best


class QuantPlan:
    """The joined verdict: which weights quantize, what that saves,
    whether the quantized program fits, and the KV-pool multipliers.
    Prices come from `estimate_peak_memory` over a SHADOW clone of the
    Program whose eligible weights are re-declared int8 (+ per-channel
    scale vars), plus the working set of the port's quantized ops
    (`quant_working_bytes`) — the same sizes the frozen program will
    measure, without building it.

    Two prices: `quant_step_peak_bytes` (the planner's step peak, the JAX
    package's executable convention, which the fit gate compares with a
    budget) and `quant_capture_peak_bytes` (what a captured graph of the
    frozen program allocates in its pool: every intermediate, as the
    planner's `capture_peak_bytes`). `register_estimate` registers the
    capture price, the one the CompileLedger measures on the card."""

    def __init__(self, program, report, weights, baseline, shadow,
                 mesh=None, batch_size=1, hbm_budget_bytes=None,
                 kv=None, weight_bits=8):
        self.report = report
        self.weights = weights
        self.baseline = baseline          # MemoryEstimate, fp32
        self._shadow = shadow             # int8-weight shadow Program
        self.mesh = mesh
        self.batch_size = batch_size
        self.hbm_budget_bytes = hbm_budget_bytes
        self.kv = kv
        self.weight_bits = weight_bits
        self.quantized = estimate_peak_memory(
            shadow, batch_size=batch_size, mesh=mesh)
        self.int8_working_bytes = self.working_bytes()

    # -- pricing -------------------------------------------------------
    @property
    def weights_saved_bytes(self):
        return sum(w["saved_bytes"] for w in self.weights
                   if not w["vetoed"])

    def working_bytes(self, batch_size=None):
        """`quant_working_bytes` at `batch_size` (the plan's default)."""
        return quant_working_bytes(self._shadow.global_block(),
                                   self.weights,
                                   batch_size or self.batch_size)

    def _estimate(self, batch_size):
        if batch_size is None or batch_size == self.batch_size:
            return self.quantized
        return estimate_peak_memory(self._shadow, batch_size=batch_size,
                                    mesh=self.mesh)

    def quant_step_peak_bytes(self, batch_size=None):
        """The frozen program's predicted step peak: the shadow's step
        peak plus the quantized ops' working set."""
        return (self._estimate(batch_size).step_peak_bytes()
                + self.working_bytes(batch_size))

    def quant_capture_peak_bytes(self, batch_size=None):
        """What a captured graph of the frozen program allocates: the
        shadow's capture peak (every intermediate) plus the quantized
        ops' working set."""
        return (self._estimate(batch_size).capture_peak_bytes()
                + self.working_bytes(batch_size))

    def register_estimate(self, scope, key, batch_size=None,
                          static_args=None):
        """Register this plan's capture price into the planner's
        cross-check under a CompileLedger (scope, key) identity: the
        capture of that identity measures its peak on the card."""
        return register_static_estimate(
            scope=scope, key=key,
            estimate_bytes=self.quant_capture_peak_bytes(batch_size),
            component="quant", static_args=static_args,
            detail={"batch_size": batch_size or self.batch_size,
                    "weight_bits": self.weight_bits,
                    "weights_saved_bytes": self.weights_saved_bytes,
                    "step_peak_bytes":
                        self.quant_step_peak_bytes(batch_size)})

    # -- verdicts ------------------------------------------------------
    def vetoed_ops(self):
        """Op indices the numerics verdicts refuse int8 for (overflow)
        — quantize_program sets skip_quant on exactly these."""
        return sorted({w["op_index"] for w in self.weights
                       if w["vetoed"]})

    def fit_diagnostic(self):
        if not self.hbm_budget_bytes:
            return None
        peak = self.quant_step_peak_bytes()
        if peak <= self.hbm_budget_bytes:
            return None
        return Diagnostic(
            "model-does-not-fit", Severity.ERROR,
            f"quantized step peak {peak} bytes exceeds budget "
            f"{int(self.hbm_budget_bytes)} bytes (high-water mark "
            f"{self.quantized.high_water()})",
            hint="quantization alone does not close the gap — shard, "
                 "shrink buckets, or raise the budget",
            pass_name=PASS_NAME)

    def diagnostics(self):
        out = list(self.report.diagnostics)
        fit = self.fit_diagnostic()
        if fit is not None:
            out.append(fit)
        return out

    def to_dict(self):
        d = {
            "batch_size": self.batch_size,
            "weight_bits": self.weight_bits,
            "weights": self.weights,
            "weights_saved_bytes": self.weights_saved_bytes,
            "baseline_step_peak_bytes": self.baseline.step_peak_bytes(),
            "quantized_step_peak_bytes": self.quant_step_peak_bytes(),
            "quantized_capture_peak_bytes": self.quant_capture_peak_bytes(),
            "int8_working_bytes": self.int8_working_bytes,
            "baseline": self.baseline.to_dict(),
            "quantized": self.quantized.to_dict(),
            "boundaries": self.report.boundaries,
            "regions": self.report.regions,
            "ladder": [v.to_dict() for v in self.report.ladder],
            "vetoed_ops": self.vetoed_ops(),
            "kv": self.kv,
        }
        if self.hbm_budget_bytes:
            d["hbm_budget_bytes"] = int(self.hbm_budget_bytes)
            d["fits"] = self.fit_diagnostic() is None
        return d


def plan_quantization(program, mesh=None, hbm_budget_bytes=None, *,
                      batch_size=1, params=None, weight_bits=8,
                      engine=None, kv_geometry=None):
    """Static quantization plan for one Program: numerics verdicts +
    int8-weight memory pricing + optional paged-KV pricing, without
    running anything. `mesh`/`hbm_budget_bytes` thread through the planner's
    var sizing and fit gate; `engine` (a PagedDecodeEngine) or
    `kv_geometry` (kwargs for price_quantized_kv) adds the KV leg."""
    from paddle_tpu_torch.core.ir import Program

    mesh = MeshSpec.parse(mesh)
    report = analyze_numerics(program, params=params,
                              batch_size=batch_size)
    baseline = estimate_peak_memory(program, batch_size=batch_size,
                                    mesh=mesh)
    shadow = Program.from_dict(program.to_dict())
    block = program.global_block()
    sblock = shadow.global_block()

    vetoed_idx = {d.op_index for d in report.diagnostics
                  if d.code == "int8-range-overflow"}
    weights = []
    seen = set()
    for i, op in enumerate(block.ops):
        w_name, ch_axis = _weight_param(block, op)
        if w_name is None or w_name in seen:
            continue
        seen.add(w_name)
        desc = block.var(w_name).desc
        b_f32 = var_bytes(desc, batch_size, mesh)
        if b_f32 is None:
            continue
        channels = desc.shape[ch_axis] if desc.shape \
            and len(desc.shape) > ch_axis else 1
        b_int8 = (b_f32 // dtype_bytes(desc.dtype or "float32")
                  + int(channels) * 4)
        vetoed = i in vetoed_idx
        weights.append({
            "param": w_name, "op_index": i, "op_type": op.type,
            "bytes_f32": int(b_f32), "bytes_int8": int(b_int8),
            "saved_bytes": int(b_f32 - b_int8), "vetoed": vetoed,
            "reason": "int8-range-overflow" if vetoed else None,
        })
        if not vetoed:
            sdesc = sblock.var(w_name).desc
            sdesc.dtype = "int8"
            scale_name = w_name + ".scale"
            if not sblock.has_var(scale_name):
                sblock.create_var(name=scale_name,
                                  shape=[int(channels)],
                                  dtype="float32", persistable=True,
                                  stop_gradient=True)

    kv = None
    if engine is not None:
        kv = price_quantized_kv(engine)
    elif kv_geometry:
        kv = price_quantized_kv(**kv_geometry)

    return QuantPlan(program, report, weights, baseline, shadow,
                     mesh=mesh, batch_size=batch_size,
                     hbm_budget_bytes=hbm_budget_bytes, kv=kv,
                     weight_bits=weight_bits)
