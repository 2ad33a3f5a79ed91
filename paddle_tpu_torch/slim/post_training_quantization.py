"""Post-training quantization.

Counterpart of paddle_tpu/slim/post_training_quantization.py (the
reference's contrib/slim/quantization/post_training_quantization.py):
run calibration batches through the float program, collect statistics
of every quantizable op's activation input, derive scales, and freeze the
program to int8 (QuantizationFreezePass).

Algorithms: "abs_max" (max over all batches), "avg" (mean of per-batch
abs max), "hist" (the percentile of the |x| histogram, 2048 bins,
default percentile 0.9999). The histogram arithmetic is the JAX
package's, on host numpy.
"""
import numpy as np

from paddle_tpu_torch.analysis.numerics import CALIB_ALGO_ATTR, CALIB_ATTR
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.slim.quantization_pass import (QUANTIZABLE, _is_param,
                                                     quantize_program)

__all__ = ["PostTrainingQuantization", "CALIB_ATTR", "CALIB_ALGO_ATTR"]


class PostTrainingQuantization:
    def __init__(self, executor, program, feed_names, data_loader,
                 scope=None, batch_nums=10, algo="hist",
                 hist_percent=0.9999, weight_bits=8, activation_bits=8):
        enforce(algo in ("abs_max", "avg", "hist"), f"unknown algo {algo}")
        self.exe = executor
        self.program = program
        self.feed_names = list(feed_names)
        self.loader = data_loader
        self.batch_nums = batch_nums
        self.algo = algo
        self.hist_percent = hist_percent
        self.wbits = weight_bits
        self.abits = activation_bits
        if scope is None:
            from paddle_tpu_torch.core.scope import global_scope
            scope = global_scope()
        self.scope = scope
        self._stats = {}

    def _activation_names(self):
        block = self.program.global_block()
        names = []
        for op in block.ops:
            if op.type in QUANTIZABLE:
                act_slot, w_slot = QUANTIZABLE[op.type]
                acts = op.inputs.get(act_slot, [])
                ws = op.inputs.get(w_slot, [])
                if acts and ws and _is_param(block, ws[0]):
                    names.append(acts[0])
        return sorted(set(names))

    def _observe(self, name, arr):
        a = np.abs(np.asarray(arr, np.float32)).ravel()
        st = self._stats.setdefault(name, {"max": 0.0, "sum": 0.0, "n": 0,
                                           "hist": None, "hist_max": 1e-8})
        amax = float(a.max(initial=0.0))
        st["max"] = max(st["max"], amax)
        st["sum"] += amax
        st["n"] += 1
        if self.algo == "hist":
            hm = max(st["hist_max"], amax)
            if st["hist"] is None or hm > st["hist_max"] * 1.001:
                # rebin on range growth
                old = st["hist"]
                st["hist"] = np.zeros(2048, np.float64)
                if old is not None:
                    st["hist"][:len(old)] += old  # coarse carry-over
                st["hist_max"] = hm
            h, _ = np.histogram(a, bins=2048, range=(0.0, st["hist_max"]))
            st["hist"] += h

    def _scales(self):
        out = {}
        for name, st in self._stats.items():
            if self.algo == "abs_max":
                out[name] = st["max"]
            elif self.algo == "avg":
                out[name] = st["sum"] / max(st["n"], 1)
            else:
                h = st["hist"]
                if h is None or h.sum() == 0:
                    out[name] = st["max"]
                    continue
                cdf = np.cumsum(h) / h.sum()
                idx = int(np.searchsorted(cdf, self.hist_percent))
                out[name] = (idx + 0.5) / len(h) * st["hist_max"]
            enforce(out[name] > 0.0,
                    "calibration produced zero scale for %s", name)
        return out

    def _stamp_calibration(self, scales):
        """Record the observed |x| ranges on the activation VarDescs
        (CALIB_ATTR); VarDesc attrs survive save/load."""
        block = self.program.global_block()
        for name, s in scales.items():
            if block.has_var(name):
                d = block.var(name).desc
                d.attrs[CALIB_ATTR] = float(s)
                d.attrs[CALIB_ALGO_ATTR] = self.algo

    def calibrate(self):
        """Run the calibration batches, derive the activation scales and
        stamp them on the activation VarDescs (CALIB_ATTR), which is what
        `analysis.numerics.plan_quantization` reads. Returns the scales
        ({activation name: |x| bound})."""
        acts = self._activation_names()
        enforce(acts, "program has no quantizable ops")
        for bi, feed in enumerate(self.loader):
            if bi >= self.batch_nums:
                break
            vals = self.exe.run(self.program, feed=feed, fetch_list=acts,
                                scope=self.scope, training=False)
            for name, v in zip(acts, vals):
                self._observe(name, v)
        enforce(self._stats, "calibration loader yielded no batches")
        scales = self._scales()
        self._stamp_calibration(scales)
        return scales

    def freeze(self, scales, plan=None):
        """Freeze with calibrated `scales` through the verify -> pass ->
        verify sandwich; `plan` (a numerics.QuantPlan) keeps its vetoed
        ops in float. Returns the int8 program (the input program,
        rewritten in place)."""
        # PTQ marks ops as QAT-equivalent, then freezes with the collected
        # scales: per-channel abs_max weight fake-quant (the scope weights
        # are final) and abs_max activation placeholders
        quantize_program(
            self.program, self.scope, plan=plan, label="ptq",
            transform_kwargs=dict(
                weight_bits=self.wbits, activation_bits=self.abits,
                weight_quantize_type="channel_wise_abs_max",
                activation_quantize_type="abs_max"),
            freeze_kwargs=dict(
                weight_bits=self.wbits, activation_bits=self.abits,
                activation_scales=scales))
        return self.program

    def quantize(self, plan=None):
        """Calibrate, then freeze (`plan` as in `freeze`)."""
        return self.freeze(self.calibrate(), plan=plan)
