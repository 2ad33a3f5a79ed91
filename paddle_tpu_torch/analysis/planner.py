"""Static resource planner, the memory half: a program's peak memory
predicted from the Program graph alone, before any capture.

Counterpart of paddle_tpu/analysis/planner.py (the reference decides
buffer reuse statically in its memory-optimize transpilers):

* **liveness peak-memory estimator** (`estimate_peak_memory`) — a
  forward dataflow over block 0 over the verifier's liveness machinery
  (`consumer_map` / `feedable_names`): per-op live sets sized from
  declared shapes and dtypes (`-1` batch dims resolved by the caller's
  batch size), persistable rebinds modeled as in-place writes (zero new
  bytes), fetch targets pinned live to the end. Reports the peak and the
  op at the high-water mark; the same bytes as the JAX package's on the
  same program.
* **the fit gate** (`plan_program(...).fit_diagnostic()`) — the
  model-does-not-fit ERROR `InferenceServer` and `ModelRegistry.deploy`
  abort on when the largest bucket's estimate exceeds the budget.
* **decode-rung geometry** (`estimate_decode_rungs`,
  `estimate_paged_rungs`) for the generation engines, which have no
  Program.
* **the ledger cross-check** (`register_static_estimate` /
  `cross_check`): each registered estimate against the newest measured
  peak the CompileLedger holds for its (scope, key). On the card that is
  a capture's `peak_bytes` (`CompileRecord.memory`: the growth of
  `torch.cuda.max_memory_allocated` over the capture), which the
  serving pool registers `MemoryEstimate.capture_peak_bytes()` against:
  the bytes a captured graph allocates in its pool. The parameters are
  bound and the feeds sit in static buffers made before the capture;
  every value a segment computes is one of the graph's outputs and
  lives as long as the graph (core/lowering.py keeps a segment's
  values until it ends), so the graph holds them all at once: the
  estimate is the sum of the block's intermediates, not the liveness
  peak.

`plan_fusion_discount` (PT_FLAGS_plan_fusion_discount) is the share of
the intermediate transient an estimate charges. The JAX package's 0.25
was calibrated against XLA's fused executables; a captured graph fuses
nothing, so the port charges all of it (1.0). Callers that must match
the JAX package pass the discount explicitly.

The sharding half — `MeshSpec` beyond one device, `propagate_shardings`,
`price_collectives`, `plan_program` with a mesh and `PlannerPass` — waits
for the port's parallelism (ROADMAP Queue 1 item 15) and raises
NotImplementedError naming it.
"""
import math

import torch

from paddle_tpu_torch.analysis.concurrency import make_lock
from paddle_tpu_torch.analysis.diagnostic import Diagnostic, Severity
from paddle_tpu_torch.analysis.verifier import consumer_map, feedable_names
from paddle_tpu_torch.core import dtypes as _dt
from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import enforce

__all__ = ["PLANNER_PASSES", "MeshSpec", "MemoryEstimate", "ResourcePlan",
           "dtype_bytes", "var_bytes", "estimate_peak_memory",
           "plan_program", "propagate_shardings", "price_collectives",
           "PlannerPass", "estimate_decode_rungs", "estimate_paged_rungs",
           "register_static_estimate", "clear_static_estimates",
           "registered_estimates", "cross_check", "cross_check_section"]

PLANNER_PASSES = ("plan_resources",)

PASS_NAME = "plan_resources"

_ITEM15 = ("the planner's sharding half (sharding propagation, collective "
           "pricing, meshes beyond one device) waits for the port's "
           "parallelism, ROADMAP Queue 1 item 15")


def _human(nbytes):
    if nbytes is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(nbytes) < 1024.0 or unit == "GiB":
            return (f"{nbytes:.0f}{unit}" if unit == "B"
                    else f"{nbytes:.2f}{unit}")
        nbytes /= 1024.0


class MeshSpec:
    """Named device mesh: ordered {axis name: size}, parsed from a
    "dp:2,tp:4" string, a dict or another MeshSpec. Only a single-device
    mesh (no axis, or axes of size 1) is planned until item 15."""

    __slots__ = ("axes",)

    def __init__(self, axes=None):
        self.axes = {}
        for k, v in dict(axes or {}).items():
            size = int(v)
            enforce(size >= 1, "mesh axis %r must have size >= 1, got %s",
                    k, v)
            self.axes[str(k)] = size
        if self.total() > 1:
            raise NotImplementedError(
                f"mesh {self.describe()}: {_ITEM15}")

    @classmethod
    def parse(cls, spec):
        if spec is None or isinstance(spec, cls):
            return spec if spec is not None else cls()
        if isinstance(spec, dict):
            return cls(spec)
        mesh_axes = getattr(spec, "mesh_axes", None)
        if mesh_axes is not None:
            return cls(mesh_axes)
        enforce(isinstance(spec, str),
                "cannot parse mesh spec from %r", spec)
        axes = {}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            enforce(":" in part or "=" in part,
                    "mesh axis %r must look like name:size", part)
            name, _, size = part.replace("=", ":").partition(":")
            axes[name.strip()] = int(size)
        return cls(axes)

    def size(self, axis):
        return self.axes.get(axis, 1)

    def total(self):
        n = 1
        for s in self.axes.values():
            n *= s
        return n

    def shard_factor(self, sharding):
        f = 1
        for ax in sharding or ():
            if ax:
                f *= self.size(ax)
        return f

    def describe(self):
        if not self.axes:
            return "single-device"
        return ",".join(f"{k}:{v}" for k, v in self.axes.items())

    def __repr__(self):
        return f"MeshSpec({self.describe()})"


# ---------------------------------------------------------------------------
# var sizing
# ---------------------------------------------------------------------------

def dtype_bytes(dtype):
    """Bytes per element of a declared dtype (a torch dtype or a name);
    4 for one the port does not know."""
    try:
        return int(_dt.normalize_dtype(dtype).itemsize)
    except (KeyError, TypeError, ValueError, AttributeError):
        return 4


def var_bytes(desc, batch_size=1, mesh=None, sharding=None):
    """Declared size of one VarDesc in bytes: `-1` dims resolve to
    `batch_size`, sharded dims divide by the mesh axis size. None when
    the desc declares no shape (a planner blind spot)."""
    if desc is None or desc.shape is None:
        return None
    n = 1
    for d in desc.shape:
        n *= int(batch_size) if d == -1 else int(d)
    n *= dtype_bytes(desc.dtype if desc.dtype is not None
                     else torch.float32)
    spec = sharding if sharding is not None else desc.sharding
    if mesh is not None and spec:
        n = int(math.ceil(n / mesh.shard_factor(spec)))
    return n


# ---------------------------------------------------------------------------
# liveness peak-memory estimator
# ---------------------------------------------------------------------------

def _discount(fusion_discount):
    if fusion_discount is None:
        return float(_flags.get_flag("plan_fusion_discount"))
    return float(fusion_discount)


class MemoryEstimate:
    """Static memory plan for one Program at one batch size.

    `residency_peak_bytes` is the pure liveness model (everything the
    graph materializes at the high-water op). `step_peak_bytes()` prices
    the JAX package's executable convention (arguments + outputs −
    donated state + a discounted share of the intermediate transient)
    and is what the fit gate compares with a budget, as there.
    `capture_peak_bytes()` is what a captured graph of the step
    allocates in its pool: every intermediate the block makes
    (`intermediates_total_bytes`, the fetches included), discounted;
    parameters are bound in the graph and the feeds sit in static
    buffers made before the capture."""

    __slots__ = ("params_bytes", "feeds_bytes", "fetch_bytes",
                 "intermediates_peak_bytes", "stash_bytes", "batch_size",
                 "high_water_op_index", "high_water_op_type",
                 "unsized_vars", "intermediates_total_bytes")

    def __init__(self, params_bytes=0, feeds_bytes=0, fetch_bytes=0,
                 intermediates_peak_bytes=0, stash_bytes=0, batch_size=1,
                 high_water_op_index=None, high_water_op_type=None,
                 unsized_vars=(), intermediates_total_bytes=0):
        self.params_bytes = int(params_bytes)
        self.feeds_bytes = int(feeds_bytes)
        self.fetch_bytes = int(fetch_bytes)
        self.intermediates_peak_bytes = int(intermediates_peak_bytes)
        self.stash_bytes = int(stash_bytes)
        self.batch_size = int(batch_size)
        self.high_water_op_index = high_water_op_index
        self.high_water_op_type = high_water_op_type
        self.unsized_vars = tuple(unsized_vars)
        self.intermediates_total_bytes = int(intermediates_total_bytes)

    @property
    def residency_peak_bytes(self):
        return (self.params_bytes + self.feeds_bytes + self.stash_bytes
                + self.intermediates_peak_bytes)

    def step_peak_bytes(self, donate_state=False, fusion_discount=None):
        """The JAX package's step peak: inference steps round-trip the
        state (parameters counted twice), training steps donate it."""
        args = self.params_bytes + self.feeds_bytes
        outs = self.fetch_bytes + (0 if donate_state
                                   else self.params_bytes)
        inter = max(self.intermediates_peak_bytes - self.fetch_bytes, 0)
        return int(args + outs + self.stash_bytes
                   + _discount(fusion_discount) * inter)

    def capture_peak_bytes(self, fusion_discount=None):
        """The bytes a captured graph of the step allocates: every
        intermediate of the block, discounted."""
        return int(_discount(fusion_discount)
                   * self.intermediates_total_bytes)

    def high_water(self):
        if self.high_water_op_index is None:
            return "program"
        return (f"op[{self.high_water_op_index}] "
                f"{self.high_water_op_type or '?'}")

    def to_dict(self):
        return {
            "params_bytes": self.params_bytes,
            "feeds_bytes": self.feeds_bytes,
            "fetch_bytes": self.fetch_bytes,
            "intermediates_peak_bytes": self.intermediates_peak_bytes,
            "intermediates_total_bytes": self.intermediates_total_bytes,
            "stash_bytes": self.stash_bytes,
            "batch_size": self.batch_size,
            "residency_peak_bytes": self.residency_peak_bytes,
            "step_peak_bytes": self.step_peak_bytes(),
            "capture_peak_bytes": self.capture_peak_bytes(),
            "high_water_op_index": self.high_water_op_index,
            "high_water_op_type": self.high_water_op_type,
            "unsized_vars": list(self.unsized_vars),
        }


def estimate_peak_memory(program, batch_size=1, mesh=None,
                         shardings=None, stash_bytes=0):
    """Forward liveness walk over block 0: the initial env (persistable
    state + data/feeds) is the baseline; each op transiently holds its
    inputs AND its freshly-materialized outputs; an intermediate dies
    after its last reader (fetch targets and names carried into
    sub-blocks stay live to the end). Persistable rebinds add zero new
    bytes."""
    mesh = MeshSpec.parse(mesh)
    shardings = shardings or {}
    block = program.global_block()
    env0 = feedable_names(program)
    fetches = set(program.meta.get("fetch_targets", []))
    feeds = set(program.meta.get("feed_targets", []))

    def _desc(name):
        return block.var(name).desc if block.has_var(name) else None

    def _bytes(name):
        return var_bytes(_desc(name), batch_size, mesh,
                         shardings.get(name))

    params_bytes = feeds_bytes = 0
    unsized = []
    for name in sorted(env0):
        d = _desc(name)
        b = _bytes(name)
        if b is None:
            unsized.append(name)
            continue
        if d is not None and (d.is_data or name in feeds) \
                and not d.persistable:
            feeds_bytes += b
        else:
            params_bytes += b

    # names read by any op OUTSIDE block 0 (or carried into sub-blocks)
    # stay live across the whole block-0 walk
    pinned = set(fetches)
    readers = consumer_map(program)
    last_use = {}
    for name, sites in readers.items():
        for b_idx, op_idx in sites:
            if b_idx != 0:
                pinned.add(name)
            else:
                last_use[name] = max(last_use.get(name, -1), op_idx)
    for op in block.ops:
        for attr in ("carry_vars", "x_vars", "y_vars", "input_vars",
                     "output_vars", "cond_var"):
            v = op.attrs.get(attr)
            if isinstance(v, str):
                pinned.add(v)
            elif isinstance(v, (list, tuple)):
                pinned.update(v)

    live = {}            # intermediate name -> bytes
    inter_peak = inter_total = 0
    hw_idx = hw_type = None
    fetch_bytes = 0
    for i, op in enumerate(block.ops):
        fresh = {}
        for name in op.output_names():
            if name in env0 or name in live:
                continue     # persistable rebind / already materialized
            b = _bytes(name)
            if b is None:
                if name not in unsized:
                    unsized.append(name)
                continue
            fresh[name] = b
        inter_total += sum(fresh.values())
        transient = sum(live.values()) + sum(fresh.values())
        if transient > inter_peak:
            inter_peak = transient
            hw_idx, hw_type = i, op.type
        live.update(fresh)
        for name in list(live):
            if name in pinned:
                continue
            if last_use.get(name, -1) <= i:
                del live[name]
    for name in fetches:
        b = _bytes(name)
        if b is not None:
            fetch_bytes += b

    return MemoryEstimate(
        params_bytes=params_bytes, feeds_bytes=feeds_bytes,
        fetch_bytes=fetch_bytes, intermediates_peak_bytes=inter_peak,
        stash_bytes=stash_bytes, batch_size=batch_size,
        high_water_op_index=hw_idx, high_water_op_type=hw_type,
        unsized_vars=unsized, intermediates_total_bytes=inter_total)


# ---------------------------------------------------------------------------
# the plan (one device)
# ---------------------------------------------------------------------------

def propagate_shardings(*args, **kwargs):
    raise NotImplementedError(_ITEM15)


def price_collectives(*args, **kwargs):
    raise NotImplementedError(_ITEM15)


class ResourcePlan:
    """plan_program's result on one device: the memory estimate and the
    fit verdict, renderable as Diagnostics or JSON."""

    __slots__ = ("memory", "mesh", "batch_size", "hbm_budget_bytes")

    def __init__(self, memory, mesh, batch_size, hbm_budget_bytes=None):
        self.memory = memory
        self.mesh = mesh
        self.batch_size = batch_size
        self.hbm_budget_bytes = hbm_budget_bytes

    def fits(self):
        if not self.hbm_budget_bytes:
            return True
        return self.memory.step_peak_bytes() <= self.hbm_budget_bytes

    def fit_diagnostic(self):
        """The ERROR the deploy gate aborts with, or None when the
        estimate fits (or no budget was given)."""
        if self.fits():
            return None
        est = self.memory.step_peak_bytes()
        return Diagnostic(
            "model-does-not-fit", Severity.ERROR,
            f"static peak-memory estimate {_human(est)} exceeds the "
            f"device HBM budget {_human(self.hbm_budget_bytes)} at "
            f"batch {self.batch_size} (high-water mark at "
            f"{self.memory.high_water()}, params "
            f"{_human(self.memory.params_bytes)}, mesh "
            f"{self.mesh.describe()})",
            block_idx=0, op_index=self.memory.high_water_op_index,
            op_type=self.memory.high_water_op_type,
            hint="shard the parameters over the mesh, shrink the "
                 "serving ladder, or deploy on a device with more HBM",
            pass_name=PASS_NAME)

    def diagnostics(self):
        """The peak-memory INFO finding, the unsized-var blind spot and
        the fit verdict (when a budget was set)."""
        m = self.memory
        out = [Diagnostic(
            "peak-memory", Severity.INFO,
            f"estimated step peak {_human(m.step_peak_bytes())} "
            f"(residency {_human(m.residency_peak_bytes)}, params "
            f"{_human(m.params_bytes)}, batch {m.batch_size}, mesh "
            f"{self.mesh.describe()}); high-water mark at "
            f"{m.high_water()}",
            block_idx=0, op_index=m.high_water_op_index,
            op_type=m.high_water_op_type, pass_name=PASS_NAME)]
        if m.unsized_vars:
            out.append(Diagnostic(
                "unsized-var", Severity.INFO,
                f"{len(m.unsized_vars)} var(s) declare no shape and "
                f"count 0 bytes: {sorted(m.unsized_vars)[:8]}",
                block_idx=0, pass_name=PASS_NAME,
                hint="declare shapes, or accept the blind spot"))
        fit = self.fit_diagnostic()
        if fit is not None:
            out.append(fit)
        return out

    def to_dict(self):
        return {"mesh": self.mesh.axes, "batch_size": self.batch_size,
                "memory": self.memory.to_dict(),
                "hbm_budget_bytes": self.hbm_budget_bytes,
                "fits": self.fits()}


def plan_program(program, mesh=None, batch_size=1, stash_bytes=0,
                 hbm_budget_bytes=None):
    """The single-device plan: the liveness memory estimate and the fit
    verdict. A mesh beyond one device raises NotImplementedError."""
    mesh = MeshSpec.parse(mesh)
    memory = estimate_peak_memory(program, batch_size=batch_size,
                                  mesh=mesh, stash_bytes=stash_bytes)
    return ResourcePlan(memory, mesh, batch_size,
                        hbm_budget_bytes=hbm_budget_bytes)


class PlannerPass:
    """The planner as an analysis pass waits for item 15: its default
    instance reads a mesh from the program and pairs sharding hazards
    with the memory plan."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_ITEM15)


# ---------------------------------------------------------------------------
# decode-rung geometry estimates (generation has no Program IR)
# ---------------------------------------------------------------------------

def _param_bytes(engine):
    """Bytes of an engine's parameters (the model's tensors, or an
    explicit `params` tree)."""
    params = getattr(engine, "params", None)
    if params is None:
        params = engine.model.state_dict()
    total, stack = 0, [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif hasattr(node, "numel"):
            total += int(node.numel()) * dtype_bytes(node.dtype)
        elif hasattr(node, "size") and hasattr(node, "dtype"):
            total += int(node.size) * int(node.dtype.itemsize)
    return total


def _head_dim(cfg):
    return int(getattr(cfg, "head_dim", 0)
               or cfg.d_model // cfg.num_heads)


def estimate_decode_rungs(engine, fusion_discount=None):
    """Static peaks for a DecodeEngine's rung ladder (the JAX package's
    geometry): the decode step holds its cache carry once; prefill
    materializes the full [1, bucket, vocab] logits. Returns
    {"decode[BxS]": bytes, ("prefill", bucket): bytes, ...}."""
    cfg = engine.model.config
    hd = _head_dim(cfg)
    params = _param_bytes(engine)
    cache = (2 * cfg.num_layers * engine.batch_size * engine.max_len
             * cfg.num_heads * hd * 4)                    # k + v, f32
    vocab = int(getattr(cfg, "vocab_size", 0))
    d_model = int(getattr(cfg, "d_model", 0))
    fusion = _discount(fusion_discount)
    out = {}
    b = engine.batch_size
    logits = b * vocab * 4
    small = b * (4 + 4 + 1 + 4)     # tokens/lengths/active in+out
    out[f"decode[{b}x{engine.max_len}]"] = params + cache + logits + small
    for bucket in engine.buckets:
        t = int(bucket)
        act = t * vocab * 4 + 2 * cfg.num_layers * t * cfg.num_heads \
            * hd * 4 + t * d_model * 4
        out[("prefill", t)] = int(params + cache + vocab * 4
                                  + (t * vocab * 4) + fusion * act)
    return out


def estimate_paged_rungs(engine, fusion_discount=None):
    """Static peaks for a PagedDecodeEngine's rung ladder (the JAX
    package's geometry): the pools (`kv_pool_bytes()`, quantized pools
    at their payload and scale bytes) once per rung, the chunk's logits
    and activations, and the gathered attention window. Returns
    {"paged_step[chunk=C]": bytes, ("paged_prefill", bucket): bytes}."""
    cfg = engine.model.config
    hd = _head_dim(cfg)
    params = _param_bytes(engine)
    if hasattr(engine, "kv_pool_bytes"):
        pool = int(engine.kv_pool_bytes())
    else:
        pool = (2 * cfg.num_layers * engine.num_blocks
                * engine.block_size * cfg.num_heads * hd * 4)
    vocab = int(getattr(cfg, "vocab_size", 0))
    d_model = int(getattr(cfg, "d_model", 0))
    fusion = _discount(fusion_discount)
    b = engine.batch_size
    tables = b * engine.blocks_per_slot * 4
    window = engine.blocks_per_slot * engine.block_size   # == max_len

    def chunk_act(rows, c):
        return (rows * c * vocab * 4
                + 2 * cfg.num_layers * rows * c * cfg.num_heads * hd * 4
                + rows * c * d_model * 4)

    def attn_window(rows, c):
        return (rows * cfg.num_heads * c * window * 4
                + 2 * rows * window * cfg.num_heads * hd * 4)

    out = {}
    chunks = [1]
    if getattr(engine, "spec_k", 0) > 0:
        chunks.append(engine.spec_k + 1)
    for c in chunks:
        out[f"paged_step[chunk={c}]"] = int(
            params + pool + tables + fusion * chunk_act(b, c)
            + attn_window(b, c) + b * c * vocab * 4)
    for bucket in engine.buckets:
        t = int(bucket)
        out[("paged_prefill", t)] = int(
            params + pool + tables + fusion * chunk_act(1, t)
            + attn_window(1, t) + t * vocab * 4)
    return out


# ---------------------------------------------------------------------------
# ledger cross-check: static estimate vs the measured capture peak
# ---------------------------------------------------------------------------

_EST_MU = make_lock("planner.estimates")
_ESTIMATES = {}          # (scope, key, static args) -> estimate record


def register_static_estimate(scope, key, estimate_bytes, component=None,
                             static_args=None, detail=None):
    """Register the planner's prediction for one executable identity
    (the CompileLedger's (scope, key) attribution; `static_args` narrows
    to one static-arg signature). `cross_check` joins it against the
    ledger's measured memory."""
    rec = {
        "scope": scope, "key": key,
        "estimate_bytes": int(estimate_bytes),
        "component": component,
        "static_args": dict(static_args) if static_args else None,
        "detail": detail,
    }
    with _EST_MU:
        _ESTIMATES[(scope, key,
                    tuple(sorted((static_args or {}).items())))] = rec
    return rec


def clear_static_estimates(scope=None):
    with _EST_MU:
        if scope is None:
            _ESTIMATES.clear()
        else:
            for k in [k for k in _ESTIMATES if k[0] == scope]:
                del _ESTIMATES[k]


def registered_estimates():
    with _EST_MU:
        return [dict(v) for v in _ESTIMATES.values()]


def _measured_peak(entries, static_args):
    """Newest usable measured peak among ledger entries; returns
    (peak_bytes or None, skip_reason or None). A record whose memory has
    no peak (an eager first run on the CPU) is no measurement."""
    want = tuple(sorted(static_args.items())) if static_args else None
    degraded = False
    for e in reversed(entries):
        if want is not None and tuple(e.static_args) != want:
            continue
        mem = e.memory
        if not mem:
            continue
        if mem.get("degraded"):
            degraded = True
            continue
        peak = mem.get("peak_bytes")
        if peak is not None:
            return float(peak), None
    return None, ("memory-analysis-degraded" if degraded
                  else "no-measurement")


def cross_check(tolerance=0.25, ledger=None):
    """Compare every registered static estimate against the newest
    measured peak in the CompileLedger. A leg is `ok` when
    estimate/measured ∈ [1−tol, 1+tol], `fail` when outside, and `skip`
    (never a vacuous pass) when nothing was measured."""
    if ledger is None:
        from paddle_tpu_torch.observability import profile as obs_profile
        ledger = obs_profile.compile_ledger()
    legs = []
    counts = {"ok": 0, "fail": 0, "skip": 0}
    for rec in registered_estimates():
        entries = ledger.entries(scope=rec["scope"], key=rec["key"])
        measured, skip = _measured_peak(entries, rec["static_args"])
        leg = dict(rec)
        if measured is None:
            leg.update(status="skip", skip_reason=skip,
                       measured_bytes=None, ratio=None)
        else:
            ratio = rec["estimate_bytes"] / measured if measured else \
                math.inf
            ok = (1.0 - tolerance) <= ratio <= (1.0 + tolerance)
            leg.update(status="ok" if ok else "fail",
                       skip_reason=None,
                       measured_bytes=measured,
                       ratio=round(ratio, 4))
        counts[leg["status"]] += 1
        legs.append(leg)
    legs.sort(key=lambda g: (str(g["scope"]), str(g["key"]),
                             str(g["static_args"])))
    return {
        "tolerance": tolerance,
        "legs": legs,
        "counts": counts,
        "ok": counts["fail"] == 0,
    }


def cross_check_section(tolerance=0.25):
    """The `plan_check` section of GET /profile: None until any
    estimate is registered (nothing to vacuously pass)."""
    with _EST_MU:
        empty = not _ESTIMATES
    if empty:
        return None
    try:
        return cross_check(tolerance=tolerance)
    except Exception:        # pragma: no cover - exposition guard rail
        return None
