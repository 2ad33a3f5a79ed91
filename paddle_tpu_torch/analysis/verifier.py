"""Program verifier passes — structural well-formedness of the IR.

Counterpart of paddle_tpu/analysis/verifier.py: each invariant is one
registered analysis pass over a Program, so a malformed graph (dangling
input, use-before-write, dtype mismatch, dead op, double-written
parameter, broken fetch list, bad sub-block) surfaces as a targeted
Diagnostic instead of an error deep inside the Executor. ERROR findings
are defects the Executor genuinely rejects; hazards that degrade but do
not break are WARNING/INFO. The shape re-check runs each op on meta
tensors (core/registry.py's abstract evaluation).
"""
import torch

from paddle_tpu_torch.analysis.diagnostic import Severity
from paddle_tpu_torch.analysis.framework import Pass, register_pass
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import registry as _reg

__all__ = ["VERIFY_PASSES", "iter_ops", "op_subblock_attrs",
           "feedable_names", "consumer_map"]

# the default verifier pipeline, in dependency order (structure first,
# then dataflow, then typing, then liveness)
VERIFY_PASSES = (
    "verify_ops_registered",
    "verify_vars_defined",
    "verify_write_order",
    "verify_param_writers",
    "verify_fetch_integrity",
    "verify_subblocks",
    "verify_shapes_dtypes",
    "verify_dead_code",
)


def iter_ops(program):
    """Yield (block, op_index, op) over every block in program order."""
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            yield block, i, op


def op_subblock_attrs(op):
    """Every sub-block index an op references."""
    idxs = []
    for k, v in op.attrs.items():
        if k.endswith("block") and isinstance(v, int) and v >= 0:
            idxs.append(v)
        elif k.endswith("blocks") and isinstance(v, (list, tuple)):
            idxs.extend(int(b) for b in v if isinstance(b, int) and b >= 0)
    return idxs


def feedable_names(program):
    """Names present in the step env before any op runs: persistable
    state, data vars and declared feed targets."""
    names = set(program.meta.get("feed_targets", []))
    for b in program.blocks:
        for n, v in b.vars.items():
            if v.persistable or v.is_data:
                names.add(n)
    return names


def consumer_map(program):
    """var name -> list of (block_idx, op_index) readers, all blocks."""
    readers = {}
    for block, i, op in iter_ops(program):
        for n in op.input_names():
            readers.setdefault(n, []).append((block.idx, i))
    return readers


@register_pass("verify_ops_registered")
class OpsRegisteredPass(Pass):
    """Every op type must resolve in the op registry; `autodiff` is the
    meta-op the step function handles itself."""

    _META_OPS = frozenset({"autodiff"})

    def run(self, program, context):
        for block, i, op in iter_ops(program):
            if op.type in self._META_OPS:
                continue
            if not _reg.has_op(op.type):
                yield self.diag(
                    "unregistered-op", Severity.ERROR,
                    f"op type {op.type!r} is not in the op registry",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    hint="register the op (core/registry.register_op) or "
                         "fix the serialized program")


@register_pass("verify_vars_defined")
class VarsDefinedPass(Pass):
    """Every name an op references must have a VarDesc in its block or
    an ancestor."""

    def run(self, program, context):
        for block, i, op in iter_ops(program):
            for n in op.input_names():
                if not block.has_var(n):
                    yield self.diag(
                        "undefined-input", Severity.ERROR,
                        f"input {n!r} has no VarDesc in block "
                        f"{block.idx} or its ancestors",
                        block_idx=block.idx, op_index=i, op_type=op.type,
                        var=n,
                        hint="create_var the name before referencing it")
            for n in op.output_names():
                if not block.has_var(n):
                    yield self.diag(
                        "undeclared-output", Severity.WARNING,
                        f"output {n!r} has no VarDesc (the step binds it "
                        f"but it is invisible to shape inference, "
                        f"serialization and feed checking)",
                        block_idx=block.idx, op_index=i, op_type=op.type,
                        var=n)


@register_pass("verify_write_order")
class WriteOrderPass(Pass):
    """Block-0 dataflow order: an op may only read names in the initial
    step env or written by an EARLIER op."""

    def run(self, program, context):
        block = program.global_block()
        available = feedable_names(program)
        all_writes = {}
        for i, op in enumerate(block.ops):
            for n in op.output_names():
                all_writes.setdefault(n, i)
        written = set()
        for i, op in enumerate(block.ops):
            for n in op.input_names():
                if n in available or n in written:
                    continue
                if n in all_writes:
                    yield self.diag(
                        "use-before-write", Severity.ERROR,
                        f"reads {n!r} which is first written by "
                        f"op[{all_writes[n]}]",
                        block_idx=0, op_index=i, op_type=op.type, var=n,
                        hint="reorder the ops or carry the value "
                             "explicitly")
                else:
                    yield self.diag(
                        "dangling-input", Severity.ERROR,
                        f"reads {n!r} which no op writes and which is "
                        f"not persistable, data, or a feed target",
                        block_idx=0, op_index=i, op_type=op.type, var=n)
            written.update(op.output_names())


@register_pass("verify_param_writers")
class ParamWritersPass(Pass):
    """A parameter may have at most one writer per block."""

    def run(self, program, context):
        for block in program.blocks:
            writers = {}
            for i, op in enumerate(block.ops):
                for n in op.output_names():
                    writers.setdefault(n, []).append(i)
            for n, idxs in writers.items():
                if len(idxs) < 2 or not block.has_var(n):
                    continue
                if block.var(n).desc.is_parameter:
                    yield self.diag(
                        "duplicate-param-writer", Severity.ERROR,
                        f"parameter {n!r} is written by ops "
                        f"{idxs} in the same block — the earlier "
                        f"update is silently discarded",
                        block_idx=block.idx, op_index=idxs[1],
                        op_type=block.ops[idxs[1]].type, var=n,
                        hint="fuse the updates or write distinct vars")


@register_pass("verify_fetch_integrity")
class FetchIntegrityPass(Pass):
    """meta fetch/feed lists must refer to real, reachable names."""

    def run(self, program, context):
        block = program.global_block()
        produced = set()
        for op in block.ops:
            produced.update(op.output_names())
        env0 = feedable_names(program)
        for n in program.meta.get("fetch_targets", []):
            if not block.has_var(n):
                yield self.diag(
                    "fetch-undeclared", Severity.ERROR,
                    f"fetch target {n!r} has no VarDesc in block 0",
                    block_idx=0, var=n)
            elif n not in produced and n not in env0:
                yield self.diag(
                    "fetch-unreachable", Severity.ERROR,
                    f"fetch target {n!r} is neither produced by any op "
                    f"nor part of the initial env (state/feed)",
                    block_idx=0, var=n,
                    hint="prune the fetch list or keep the producing op")
        for n in program.meta.get("feed_targets", []):
            if not block.has_var(n):
                yield self.diag(
                    "feed-undeclared", Severity.ERROR,
                    f"feed target {n!r} has no VarDesc in block 0 — "
                    f"feeds bypass dtype/shape validation",
                    block_idx=0, var=n)


@register_pass("verify_subblocks")
class SubblocksPass(Pass):
    """Control-flow well-formedness: sub-block indices in range, parent
    chain consistent, required carry attrs present, carried names
    resolvable, no orphan blocks."""

    _REQUIRED_ATTRS = {
        "while": ("sub_block", "carry_vars", "cond_var"),
        "conditional_block": ("sub_block", "input_vars", "output_vars"),
        "scan": ("sub_block", "x_vars", "carry_vars", "y_vars"),
    }

    def run(self, program, context):
        referenced = set()
        for block, i, op in iter_ops(program):
            for need in self._REQUIRED_ATTRS.get(op.type, ()):
                if need not in op.attrs:
                    yield self.diag(
                        "malformed-control-flow", Severity.ERROR,
                        f"{op.type} op is missing required attr "
                        f"{need!r}",
                        block_idx=block.idx, op_index=i, op_type=op.type)
            for idx in op_subblock_attrs(op):
                referenced.add(idx)
                if idx <= 0 or idx >= len(program.blocks):
                    yield self.diag(
                        "bad-subblock-index", Severity.ERROR,
                        f"references sub-block {idx} but the program "
                        f"has blocks 0..{len(program.blocks) - 1} "
                        f"(0 cannot be a sub-block)",
                        block_idx=block.idx, op_index=i, op_type=op.type)
                    continue
                sub = program.blocks[idx]
                b, chain_ok, seen = sub, False, set()
                while b is not None and b.idx not in seen:
                    seen.add(b.idx)
                    if b.idx == block.idx:
                        chain_ok = True
                        break
                    b = b.parent
                if not chain_ok:
                    yield self.diag(
                        "subblock-parent-mismatch", Severity.ERROR,
                        f"sub-block {idx} does not have block "
                        f"{block.idx} in its parent chain",
                        block_idx=block.idx, op_index=i, op_type=op.type)
                    continue
                for attr in ("carry_vars", "x_vars", "y_vars",
                             "input_vars", "output_vars"):
                    for n in op.attrs.get(attr, []) or []:
                        if not sub.has_var(n) and not block.has_var(n):
                            yield self.diag(
                                "subblock-undefined-var", Severity.ERROR,
                                f"attr {attr!r} names {n!r} which "
                                f"resolves in neither sub-block {idx} "
                                f"nor the op's scope",
                                block_idx=block.idx, op_index=i,
                                op_type=op.type, var=n)
        for block in program.blocks[1:]:
            if block.idx not in referenced:
                yield self.diag(
                    "orphan-block", Severity.WARNING,
                    f"block {block.idx} is referenced by no control-flow "
                    f"op — dead weight in the serialized program",
                    block_idx=block.idx)


@register_pass("verify_shapes_dtypes")
class ShapesDtypesPass(Pass):
    """Re-run construction-time shape inference (each op on meta tensors)
    and cross-check the DECLARED VarDescs against it. Dynamic (-1) dims
    are excluded from the comparison; a fully static op whose abstract
    evaluation fails is reported (the Executor would fail the same
    way)."""

    def run(self, program, context):
        for block, i, op in iter_ops(program):
            if _reg.skips_inference(op.type) or not _reg.has_op(op.type):
                continue
            if any(not block.has_var(n) for n in op.input_names()):
                continue  # verify_vars_defined owns that finding
            env, any_dynamic = _reg.abstract_inputs(op, block)
            if env is None:
                continue
            try:
                with torch.no_grad():
                    out_env = _reg.abstract_eval(op, env)
            except (RuntimeError, ValueError, TypeError, IndexError,
                    KeyError) as e:
                if any_dynamic:
                    continue  # sentinel shape math; not provably broken
                yield self.diag(
                    "infer-failed", Severity.ERROR,
                    f"abstract evaluation failed: {e}",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    hint="the Executor will fail identically — fix the "
                         "op's inputs/attrs")
                continue
            for n, t in out_env.items():
                if not block.has_var(n):
                    continue
                yield from self._compare(block, i, op, n, t)

    def _compare(self, block, i, op, n, t):
        desc = block.var(n).desc
        inferred = _reg.inferred_shape(t)
        if desc.dtype is not None and desc.dtype != t.dtype:
            yield self.diag(
                "dtype-mismatch", Severity.ERROR,
                f"output {n!r} is declared {_dt.dtype_name(desc.dtype)} "
                f"but the op computes {_dt.dtype_name(t.dtype)}",
                block_idx=block.idx, op_index=i, op_type=op.type, var=n,
                hint="update the VarDesc or cast explicitly")
        if desc.shape is None:
            return
        if len(desc.shape) != len(inferred):
            yield self.diag(
                "shape-mismatch", Severity.ERROR,
                f"output {n!r} is declared rank {len(desc.shape)} "
                f"{tuple(desc.shape)} but the op computes rank "
                f"{len(inferred)} {inferred}",
                block_idx=block.idx, op_index=i, op_type=op.type, var=n)
            return
        for dd, di in zip(desc.shape, inferred):
            if dd != -1 and di != -1 and dd != di:
                yield self.diag(
                    "shape-mismatch", Severity.ERROR,
                    f"output {n!r} is declared {tuple(desc.shape)} but "
                    f"the op computes {inferred}",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    var=n)
                return


@register_pass("verify_dead_code")
class DeadCodePass(Pass):
    """Dead ops (every output unread, not fetched, not carried, not a
    persistable rebind) and unreachable vars. WARNING/INFO only."""

    def run(self, program, context):
        readers = consumer_map(program)
        fetches = set(program.meta.get("fetch_targets", []))
        feeds = set(program.meta.get("feed_targets", []))
        # liveness is only judgeable against a declared fetch contract
        judge_ops = bool(fetches)
        sub_carried = set()
        for _, _, op in iter_ops(program):
            for attr in ("carry_vars", "x_vars", "y_vars", "input_vars",
                         "output_vars", "cond_var"):
                v = op.attrs.get(attr)
                if isinstance(v, str):
                    sub_carried.add(v)
                elif isinstance(v, (list, tuple)):
                    sub_carried.update(v)
        for block, i, op in iter_ops(program):
            if not judge_ops:
                break
            live = False
            for n in op.output_names():
                if n in readers or n in fetches or n in sub_carried:
                    live = True
                    break
                if block.has_var(n) and block.var(n).desc.persistable:
                    live = True  # state write-back is an effect
                    break
            if not live and op.output_names():
                yield self.diag(
                    "dead-op", Severity.WARNING,
                    "no output of this op is read, fetched, carried, "
                    "or persistable — the op is dead",
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    hint="prune it (static/io.prune) or fetch its output")
        referenced = set(readers)
        for _, _, op in iter_ops(program):
            referenced.update(op.output_names())
        for block in program.blocks:
            for n, v in block.vars.items():
                if n in referenced or n in fetches or n in feeds or \
                        n in sub_carried or v.persistable or v.is_data:
                    continue
                yield self.diag(
                    "unreachable-var", Severity.INFO,
                    "declared but referenced by no op and not "
                    "feed/fetch/persistable",
                    block_idx=block.idx, var=n)
