"""Program analysis: the diagnostic model, the pass framework and the
verifier family (counterpart of paddle_tpu/analysis/ for what the export
passes and the slim sandwich call), plus `concurrency` (named locks)."""
from paddle_tpu_torch.analysis.diagnostic import (  # noqa: F401
    Diagnostic, Severity,
)
from paddle_tpu_torch.analysis.framework import (  # noqa: F401
    AnalysisContext, AnalysisError, AnalysisManager, Pass, get_pass,
    register_pass, registered_passes,
)
from paddle_tpu_torch.analysis.verifier import VERIFY_PASSES


def verify_program(program, raise_on=Severity.ERROR, label=None,
                   params=None):
    """Run the verifier family; by default raises AnalysisError on any
    ERROR finding and returns the (sorted) findings otherwise."""
    mgr = AnalysisManager(passes=list(VERIFY_PASSES), raise_on=raise_on)
    return mgr.run(program, params=params, label=label)
