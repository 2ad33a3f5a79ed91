"""Device-hazard lints — hazards at the capture boundary.

Counterpart of paddle_tpu/analysis/tpu_lints.py, registered under the
same pass names and finding codes. Where the verifier (verifier.py)
checks that a Program CAN run, these passes check that it runs WELL as
captured CUDA graphs: no float64 (half the float32 rate on the card and
no tensor-core path), no oversized host constants copied to the card
with every capture, no recompile traps (dynamic inner dims the serving
bucket ladder cannot pad away, so each new shape is a new capture), no
state writes that leak across serving requests, and no host op inside
the program: a host op ends a captured segment (core/lowering.py's
capture plan), as a host sync ends an XLA executable.

`lint_host_sync_ops` differs from the JAX package's by design. There it
runs an AST checker (analysis/astlint.py) over the compute function of
each op type the program uses; here it reads the host marks the capture
plan already uses (`register_op(..., host=reason)`): each op type that
needs the host is one WARNING with its reason. On a program with a
`while`, a `conditional_block`, `py_func` or `Print` the port therefore
warns where the JAX package, whose lowering keeps those ops inside one
executable, says nothing (pinned by tests/test_torch_planner.py).

Everything here is WARNING/INFO: a hazard degrades latency, memory or
determinism but does not make the graph malformed.
"""
import numpy as np
import torch

from paddle_tpu_torch.analysis.diagnostic import Severity
from paddle_tpu_torch.analysis.framework import Pass, register_pass
from paddle_tpu_torch.analysis.verifier import iter_ops
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import registry as _reg

__all__ = ["LINT_PASSES"]

LINT_PASSES = (
    "lint_float64",
    "lint_host_constants",
    "lint_recompile_hazards",
    "lint_state_discipline",
    "lint_host_sync_ops",
)

# one host constant per capture is fine for small tables; above this the
# attr payload should be a parameter living in scope (copied to the card
# once) instead of re-copied by every capture that runs the op
_HOST_CONST_MAX_ELEMS = 1 << 16


def _is_f64(dtype):
    try:
        return _dt.dtype_name(dtype) == "float64"
    except (KeyError, TypeError, ValueError):
        return False


@register_pass("lint_float64")
class Float64Pass(Pass):
    """float64 anywhere in the graph: the card runs it at half the
    float32 rate, with no tensor-core path. int64 ids are exempt (the
    norm for labels and embedding ids)."""

    def run(self, program, context):
        for block in program.blocks:
            for n, v in block.vars.items():
                if v.dtype is not None and _is_f64(v.dtype):
                    yield self.diag(
                        "tpu-float64", Severity.WARNING,
                        "declared float64 — half the float32 rate on the "
                        "card, and no tensor-core path",
                        block_idx=block.idx, var=n,
                        hint="declare float32 (or bfloat16) explicitly")
        for block, i, op in iter_ops(program):
            for k, val in op.attrs.items():
                if "dtype" in k and (val is torch.float64 or (
                        isinstance(val, str)
                        and val in ("float64", "fp64"))):
                    yield self.diag(
                        "tpu-float64", Severity.WARNING,
                        f"attr {k!r} requests float64 output",
                        block_idx=block.idx, op_index=i, op_type=op.type,
                        hint="request float32 instead")


@register_pass("lint_host_constants")
class HostConstantsPass(Pass):
    """Large array attrs (assign_value weight blobs etc.) are copied to
    the card by every capture of a graph that runs the op, one copy per
    feed-shape signature. Parameters belong in scope, where the graphs
    hold them."""

    def run(self, program, context):
        for block, i, op in iter_ops(program):
            for k, val in op.attrs.items():
                size = (val.size if isinstance(val, np.ndarray) else
                        val.numel() if isinstance(val, torch.Tensor)
                        else 0)
                if size > _HOST_CONST_MAX_ELEMS:
                    yield self.diag(
                        "tpu-host-constant", Severity.WARNING,
                        f"attr {k!r} holds a {size}-element host "
                        f"array copied into every captured graph",
                        block_idx=block.idx, op_index=i, op_type=op.type,
                        hint="store it as a persistable parameter "
                             "instead of an attr")


@register_pass("lint_recompile_hazards")
class RecompileHazardsPass(Pass):
    """The Executor captures one graph per distinct feed-shape
    signature. The serving bucket ladder (serving/batcher.py) bounds
    that ONLY for the leading batch dim; a data var with a dynamic (-1)
    inner dim or no declared shape captures anew on every novel shape."""

    def run(self, program, context):
        for block in program.blocks:
            for n, v in block.vars.items():
                if not v.is_data:
                    continue
                if v.shape is None:
                    yield self.diag(
                        "tpu-unbounded-feed", Severity.WARNING,
                        "data var has no declared shape — every distinct "
                        "feed shape captures a new graph",
                        block_idx=block.idx, var=n,
                        hint="declare the shape with -1 only on the "
                             "batch dim")
                    continue
                inner_dyn = [d for d in v.shape[1:] if d == -1]
                if inner_dyn:
                    yield self.diag(
                        "tpu-dynamic-inner-dim", Severity.WARNING,
                        f"data var shape {tuple(v.shape)} has dynamic "
                        f"non-batch dim(s) — the serving bucket ladder "
                        f"pads only the leading dim, so each distinct "
                        f"inner shape captures its own graph",
                        block_idx=block.idx, var=n,
                        hint="pad/bucket the inner dims at the data "
                             "layer (lod_tensor bucketing)")


@register_pass("lint_state_discipline")
class StateDisciplinePass(Pass):
    """State-write discipline at the Executor boundary:

    * optimize-role ops inside a program marked is_test: Executor.run
      picks training=False from the meta, so the graphs write no state
      back and the update runs for nothing — a mis-cloned program;
    * persistable vars rebound (non-self) in an inference program:
      serving clones share one scope (Predictor.clone), so a state
      write leaks one request's value into the next replica's read.
    """

    def run(self, program, context):
        if not program.meta.get("is_test"):
            return
        for block, i, op in iter_ops(program):
            if op.role == "optimize":
                yield self.diag(
                    "tpu-missing-donation", Severity.WARNING,
                    "optimize-role op inside an is_test program — the "
                    "executor runs it with training=False (no state "
                    "write-back) and still computes the update",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    hint="clone(for_test=True) strips optimize ops; "
                         "re-export the program")
                continue
            ins = set(op.input_names())
            for n in op.output_names():
                if n in ins:
                    continue  # self-rebind (batch_norm stats) is benign
                if block.has_var(n) and block.var(n).desc.persistable:
                    yield self.diag(
                        "tpu-state-write-in-inference", Severity.INFO,
                        f"writes persistable {n!r} in an inference "
                        f"program — concurrent serving clones share one "
                        f"scope, so the write leaks across requests",
                        block_idx=block.idx, op_index=i, op_type=op.type,
                        var=n,
                        hint="keep request state in the feed/fetch "
                             "contract, not in scope")


@register_pass("lint_host_sync_ops")
class HostSyncOpsPass(Pass):
    """One WARNING per op type the program uses that needs the host
    (its registration's `host=` reason): each such op ends a captured
    segment, so the step is several graphs with host work between them.
    A registration's reason may depend on the op's attributes, so each
    op is asked until its type has a finding."""

    def run(self, program, context):
        reported = set()
        for block, i, op in iter_ops(program):
            if op.type in reported or not _reg.has_op(op.type):
                continue
            reason = _reg.host_reason(op)
            if reason:
                reported.add(op.type)
                yield self.diag(
                    "tpu-host-sync", Severity.WARNING,
                    f"{op.type!r} needs the host ({reason}): it ends a "
                    f"captured segment, so the step replays several "
                    f"graphs with host work between them",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    hint="keep host ops out of serving programs, or "
                         "accept the extra segments")
