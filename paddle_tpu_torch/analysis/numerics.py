"""Numerics: the deploy-time quantization parity gate.

Counterpart of `quant_parity_check` in paddle_tpu/analysis/numerics.py
(:1101), the check `ModelRegistry.deploy(quality_gate=...)` runs at
stage "verify". The rest of that module (interval dataflow, the
dtype-ladder precision propagation, the static quantization planner and
the `lint_numerics` pass) waits for ROADMAP Queue 1 item 17.
"""
import numpy as np

from paddle_tpu_torch.analysis.diagnostic import Diagnostic, Severity
from paddle_tpu_torch.core.enforce import enforce

__all__ = ["PASS_NAME", "quant_parity_check"]

PASS_NAME = "lint_numerics"


def quant_parity_check(outputs, reference, threshold=0.05,
                       pass_name=PASS_NAME):
    """Parity of quantized outputs vs the fp32 oracle: worst
    mean-relative-error across fetch tensors (numpy, in float64).
    Returns (rel_err, Diagnostic or None) — the Diagnostic is the ERROR
    `quant-quality-regression` `ModelRegistry.deploy` aborts on at stage
    "verify" (pre-commit, so the rollback contract holds)."""
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
