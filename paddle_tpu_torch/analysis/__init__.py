"""Program analysis: the diagnostic model, the pass framework, the
verifier family and the device-hazard lints (counterpart of
paddle_tpu/analysis/), the planner's memory half (`planner`), the static
numerics analysis and quantization planner (`numerics`), and the
concurrency checker (`concurrency`, `interleave`, and the static
`astlint`).

* **verifier** (verifier.py, `VERIFY_PASSES`) — structural
  well-formedness.
* **lints** (lints.py, `LINT_PASSES`, the JAX package's tpu_lints.py) —
  hazards at the capture boundary: float64, oversized host constants,
  recompile traps, state-write discipline, host ops that end a captured
  segment.
* **planner** (planner.py, `PLANNER_PASSES`) — opt-in like the JAX
  package's: the `InferenceServer` / `ModelRegistry.deploy` fit gate and
  the cross-check of its estimates against the captures' peaks
  (GET /profile "plan_check").
* **numerics** (numerics.py, `NUMERICS_PASSES`) — interval dataflow,
  the precision ladder and `plan_quantization` -> QuantPlan; opt-in
  (`lint_numerics`), consumed by `slim.quantize_program(plan=...)`, with
  the deploy-time parity gate `quant_parity_check`.

`lint_graph` (verifier + lints, collect mode) is what `InferenceServer`
runs at startup.
"""
from paddle_tpu_torch.analysis.diagnostic import (  # noqa: F401
    Diagnostic, Severity, count_by_severity, format_record,
    render_diagnostics, sort_diagnostics,
)
from paddle_tpu_torch.analysis.framework import (  # noqa: F401
    AnalysisContext, AnalysisError, AnalysisManager, Pass, get_pass,
    register_pass, registered_passes,
)
from paddle_tpu_torch.analysis.verifier import VERIFY_PASSES  # noqa: F401
from paddle_tpu_torch.analysis.lints import LINT_PASSES  # noqa: F401
from paddle_tpu_torch.analysis.planner import (  # noqa: F401
    PLANNER_PASSES, MemoryEstimate, MeshSpec, ResourcePlan, cross_check,
    cross_check_section, estimate_peak_memory, plan_program,
    register_static_estimate,
)
from paddle_tpu_torch.analysis.numerics import (  # noqa: F401
    NUMERICS_PASSES, Interval, LadderVerdict, NumericsPass,
    NumericsReport, QuantPlan, analyze_numerics, numerics_covered_ops,
    plan_quantization, price_quantized_kv, propagate_intervals,
    quant_parity_check, transfer_families,
)

# the planner and numerics families are opt-in (the serving fit gate,
# PT_FLAGS_plan_hbm_bytes, the slim sandwich): registered but not part of
# the default lint pipeline, so lint_graph output stays stable
ALL_PASSES = VERIFY_PASSES + LINT_PASSES


def verify_program(program, raise_on=Severity.ERROR, label=None,
                   params=None):
    """Run the verifier family; by default raises AnalysisError on any
    ERROR finding and returns the (sorted) findings otherwise."""
    mgr = AnalysisManager(passes=list(VERIFY_PASSES), raise_on=raise_on)
    return mgr.run(program, params=params, label=label)


def lint_graph(program, params=None):
    """Run verifier + lints in collect mode (never raises)."""
    mgr = AnalysisManager(passes=list(ALL_PASSES), raise_on=None)
    return mgr.run(program, params=params)
