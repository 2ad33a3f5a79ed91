"""Diagnostic model — the finding record every analysis pass emits.

Counterpart of paddle_tpu/analysis/diagnostic.py (framework-neutral):
findings with a severity tier, a stable code and an IR location (block /
op index / var name), rendered by one `format_record`.
"""

__all__ = ["Severity", "Diagnostic", "format_record", "sort_diagnostics",
           "render_diagnostics", "count_by_severity"]


class Severity:
    """Ordered severity tiers. ERROR findings abort (AnalysisManager's
    raise mode); WARNING is a real hazard that does not invalidate the
    graph; INFO is advisory."""

    INFO = "info"
    WARNING = "warning"
    ERROR = "error"

    _ORDER = {INFO: 0, WARNING: 1, ERROR: 2}

    @classmethod
    def rank(cls, severity):
        if severity not in cls._ORDER:
            raise ValueError(f"unknown severity {severity!r} "
                             f"(expected one of {sorted(cls._ORDER)})")
        return cls._ORDER[severity]

    @classmethod
    def at_least(cls, severity, threshold):
        return cls.rank(severity) >= cls.rank(threshold)


def format_record(severity, code, location, message, hint=None):
    """The one canonical text rendering: `SEV [code] location: message`."""
    line = f"{severity.upper():7s} [{code}] {location}: {message}"
    if hint:
        line += f"\n        hint: {hint}"
    return line


class Diagnostic:
    """One finding: what (code/message), how bad (severity), where (block
    idx / op index / op type / var name), and how to fix it (hint)."""

    __slots__ = ("code", "severity", "message", "block_idx", "op_index",
                 "op_type", "var", "hint", "pass_name")

    def __init__(self, code, severity, message, block_idx=None,
                 op_index=None, op_type=None, var=None, hint=None,
                 pass_name=None):
        Severity.rank(severity)  # validate early
        self.code = code
        self.severity = severity
        self.message = message
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.var = var
        self.hint = hint
        self.pass_name = pass_name

    def location(self):
        """`block 0 op[3] conv2d` / `block 0 var 'x'` / `program`."""
        bits = []
        if self.block_idx is not None:
            bits.append(f"block {self.block_idx}")
        if self.op_index is not None:
            op = f"op[{self.op_index}]"
            if self.op_type:
                op += f" {self.op_type}"
            bits.append(op)
        if self.var is not None:
            bits.append(f"var {self.var!r}")
        return " ".join(bits) if bits else "program"

    def render(self):
        return format_record(self.severity, self.code, self.location(),
                             self.message, self.hint)

    def to_dict(self):
        """The JAX package's JSON shape: every key present, absent
        fields null."""
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "block_idx": self.block_idx,
            "op_index": self.op_index,
            "op_type": self.op_type,
            "var": self.var,
            "hint": self.hint,
            "pass": self.pass_name,
        }

    def sort_key(self):
        """Most severe first, then program order (block, op, var)."""
        return (-Severity.rank(self.severity),
                self.block_idx if self.block_idx is not None else -1,
                self.op_index if self.op_index is not None else -1,
                self.var or "", self.code)

    def __repr__(self):
        return (f"Diagnostic({self.code!r}, {self.severity!r}, "
                f"{self.location()!r})")


def sort_diagnostics(diags):
    return sorted(diags, key=lambda d: d.sort_key())


def render_diagnostics(diags, header=None):
    """Human-readable block: sorted findings and a severity tally."""
    diags = sort_diagnostics(diags)
    lines = [header] if header else []
    lines += [d.render() for d in diags]
    counts = count_by_severity(diags)
    lines.append("%d error(s), %d warning(s), %d info" % (
        counts[Severity.ERROR], counts[Severity.WARNING],
        counts[Severity.INFO]))
    return "\n".join(lines)


def count_by_severity(diags):
    counts = {Severity.ERROR: 0, Severity.WARNING: 0, Severity.INFO: 0}
    for d in diags:
        counts[d.severity] += 1
    return counts
