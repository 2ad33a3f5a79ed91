"""Pass framework: Pass base, pass registry, AnalysisManager.

Counterpart of paddle_tpu/analysis/framework.py (the reference's
framework/ir pass.h:42 / REGISTER_PASS :196, sequenced like the inference
IRPassManager). Analysis passes take a Program and return Diagnostics;
the AnalysisManager runs a pass list and either returns the findings or
raises AnalysisError when one reaches `raise_on`. The slim rewrites
register here too and act only when armed through the context's
`scratch` dict.
"""
from paddle_tpu_torch.analysis.diagnostic import (
    Diagnostic, Severity, render_diagnostics, sort_diagnostics,
)
from paddle_tpu_torch.core.enforce import EnforceError, enforce

__all__ = ["AnalysisError", "AnalysisContext", "Pass", "register_pass",
           "get_pass", "registered_passes", "AnalysisManager"]


class AnalysisError(EnforceError):
    """Raised by AnalysisManager when findings reach the raise threshold;
    carries the findings (`.diagnostics`)."""

    def __init__(self, diagnostics, threshold, label=None):
        self.diagnostics = sort_diagnostics(diagnostics)
        self.threshold = threshold
        head = "program verification failed"
        if label:
            head += f" ({label})"
        super().__init__(render_diagnostics(self.diagnostics, head + ":"))


class AnalysisContext:
    """Per-run context handed to every pass: optional parameter values
    and a scratch dict passes may share."""

    __slots__ = ("params", "scratch")

    def __init__(self, params=None):
        self.params = params
        self.scratch = {}


class Pass:
    """One analysis over a Program. Subclasses set `name` and implement
    `run(program, context)` yielding Diagnostics."""

    name = None

    def run(self, program, context):
        raise NotImplementedError

    def diag(self, code, severity, message, **kw):
        kw.setdefault("pass_name", self.name)
        return Diagnostic(code, severity, message, **kw)



_PASSES = {}


def register_pass(name):
    """Decorator mirroring the reference's REGISTER_PASS(name, Class)."""

    def deco(cls):
        enforce(issubclass(cls, Pass), "register_pass expects a Pass "
                "subclass, got %r", cls)
        enforce(name not in _PASSES, "analysis pass %r registered twice",
                name)
        cls.name = name
        _PASSES[name] = cls
        return cls

    return deco


def get_pass(name):
    enforce(name in _PASSES,
            "analysis pass %r is not registered (registered: %s)",
            name, ", ".join(sorted(_PASSES)))
    return _PASSES[name]()


def registered_passes():
    return sorted(_PASSES)


class AnalysisManager:
    """Run a pass list over a Program and collect or raise.

    passes:   pass names or Pass instances; defaults to every registered
              pass.
    raise_on: severity threshold for AnalysisError, or None to always
              collect. Default "error" — warnings never abort.
    """

    def __init__(self, passes=None, raise_on=Severity.ERROR):
        if raise_on is not None:
            Severity.rank(raise_on)  # validate
        self.raise_on = raise_on
        names = passes if passes is not None else registered_passes()
        self.passes = [p if isinstance(p, Pass) else get_pass(p)
                       for p in names]

    def run(self, program, params=None, label=None, scratch=None):
        """Returns sorted Diagnostics; raises AnalysisError when any
        finding reaches `raise_on`. `scratch` pre-populates the context's
        scratch dict (the arming channel of the slim rewrites)."""
        ctx = AnalysisContext(params=params)
        if scratch:
            ctx.scratch.update(scratch)
        diags = []
        for p in self.passes:
            diags.extend(p.run(program, ctx))
        diags = sort_diagnostics(diags)
        if self.raise_on is not None and any(
                Severity.at_least(d.severity, self.raise_on)
                for d in diags):
            raise AnalysisError(diags, self.raise_on, label=label)
        return diags
