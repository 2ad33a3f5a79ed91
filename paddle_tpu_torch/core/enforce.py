"""Error checking.

Parity: PADDLE_ENFORCE* macros (reference paddle/fluid/platform/enforce.h:291)
attach file/line and a readable message to every invariant failure, and
op_call_stack.cc attaches the Python stack to op errors. Here the lowering
layer wraps per-op failures with the op's type, its IR location, and the
definition-site Python stack captured when the op was appended.
"""
import traceback


class EnforceError(RuntimeError):
    pass


def enforce(cond, msg, *fmt_args):
    if not cond:
        raise EnforceError(msg % fmt_args if fmt_args else msg)


def enforce_eq(a, b, msg=""):
    if a != b:
        raise EnforceError(f"expected {a!r} == {b!r}. {msg}")


def enforce_in(x, seq, msg=""):
    if x not in seq:
        raise EnforceError(f"expected {x!r} in {list(seq)!r}. {msg}")


def capture_callsite(skip_frames=2, limit=6):
    """Capture the user-code stack at op-definition time (op_call_stack.cc
    analogue). Returns a short formatted string, filtering framework frames."""
    frames = traceback.extract_stack()[:-skip_frames]
    user = [f for f in frames if "/paddle_tpu_torch/" not in f.filename]
    return "".join(traceback.format_list(user[-limit:])) if user else ""


class OpRunError(EnforceError):
    """Error raised while lowering/running one op, carrying IR context."""

    def __init__(self, op_type, message, callsite=""):
        self.op_type = op_type
        msg = f"error running op '{op_type}': {message}"
        if callsite:
            msg += f"\n  op defined at (most recent call last):\n{callsite}"
        super().__init__(msg)
