"""Runtime flags.

Counterpart of paddle_tpu/core/flags.py: a typed registry initialised
from `PT_FLAGS_<name>` environment variables (the reference's gflags
whitelist, python/paddle/fluid/__init__.py:162-189), with every flag of
the JAX package under its name, type and default. The port reads
check_nan_inf, executor_log_level, verify_program and deterministic (the
Executor), default_dtype (static parameters), amp_dtype (`amp`), the
profile_* flags (`observability.profile`), the compile_cache_* flags
(`core.compile_cache`), trace_sample_every (`serving.gateway`), the
slo_* flags (`observability.slo` and `observability.health`),
plan_hbm_bytes and plan_fusion_discount (`analysis.planner`), fault_plan
(`reliability.faults`), watchdog_deadline_s and train_numerics
(`reliability.training`), the fleet_* flags (`fleet`) and the ps_retry_*
and ps_failover_after_s flags (`ps`) and concurrency_check
(`analysis.concurrency`). The JAX package's compile_cache_jax_cache has
no counterpart: it plumbs the cache directory into jax's own
compilation cache, and a captured CUDA graph has no compiler cache
beneath it. The two flags no module reads say why (`unread`); a value
other than the default warns once that it has no effect. No flag picks
the device: that is `core.places.resolve_device`'s.
"""
import os
import warnings

__all__ = ["define_flag", "get_flag", "set_flag", "all_flags"]

_REGISTRY = {}
_WARNED = set()


class _Flag:
    __slots__ = ("name", "default", "type", "help", "value", "unread")

    def __init__(self, name, default, type_, help_, unread=None):
        self.name, self.default, self.type, self.help = (name, default,
                                                         type_, help_)
        self.value = default
        self.unread = unread


def _check_read(f):
    """Warn once for a flag the port does not read, set away from its
    default."""
    if f.unread and f.value != f.default and f.name not in _WARNED:
        _WARNED.add(f.name)
        warnings.warn(f"flag {f.name!r} = {f.value!r} has no effect: the "
                      f"port does not read it ({f.unread})", stacklevel=3)


def define_flag(name, default, help_="", unread=None):
    """`unread`: why the port does not read the flag yet (None when it
    does)."""
    f = _Flag(name, default, type(default), help_, unread)
    env = os.environ.get(f"PT_FLAGS_{name}")
    if env is not None:
        if f.type is bool:
            f.value = env.lower() in ("1", "true", "yes")
        else:
            f.value = f.type(env)
    _REGISTRY[name] = f
    _check_read(f)
    return f


def get_flag(name):
    return _REGISTRY[name].value


def set_flag(name, value):
    f = _REGISTRY[name]
    f.value = value
    _check_read(f)


def all_flags():
    return {k: v.value for k, v in _REGISTRY.items()}


#: the reason of the flags no module of the port reads
_PARITY = "kept for API parity, no counterpart in the port"


define_flag("check_nan_inf", False,
            "verify finiteness of every fetched tensor (flags.cc:44)")
define_flag("executor_log_level", 0,
            "verbosity of the executor (VLOG): > 0 logs each new step "
            "function")
define_flag("verify_program", False,
            "debug mode: run the paddle_tpu_torch.analysis verifier on "
            "every program entering make_step_fn and raise on ERROR "
            "findings")
define_flag("deterministic", False,
            "Executor.run puts cuDNN in deterministic mode "
            "(torch.backends.cudnn.deterministic, benchmark off; "
            "flags.cc:98 cudnn_deterministic)")
define_flag("profile_compile_ledger", True,
            "record every capture and every first eager run of a "
            "signature (signature, wall time, static flops, memory, "
            "recompile forensics) in the process-wide CompileLedger; "
            "False turns the ledger off, never the capture")
define_flag("profile_memory_sample_every", 0,
            "sample the device allocator into the memory ledger every N "
            "observed executable runs; 0 samples only on explicit "
            "MemoryLedger.sample() calls")
define_flag("profile_peak_flops", 0.0,
            "roofline peak FLOP/s used for the MFU derivation; 0 "
            "resolves from the device-name table (GPU) or a one-time "
            "matmul calibration (CPU)")
define_flag("compile_cache_dir", "",
            "root directory of the persistent signature cache (entries "
            "and warm-start manifests); empty disables it")
define_flag("compile_cache_keep", 256,
            "keep-last-N GC bound on cache entries (by publish time); 0 "
            "disables GC")
define_flag("compile_cache_slow_compile_s", 10.0,
            "captures slower than this are recorded in the cache's "
            "PATHOLOGY.json, so a known-slow signature is flagged on "
            "every later cold start")
define_flag("eager_delete_tensor_gb", 0.0,
            "not read: torch's caching allocator frees tensors "
            "(flags.cc eager_delete_tensor_gb)", unread=_PARITY)
define_flag("allocator_strategy", "xla",
            "not read: allocation is torch's caching allocator "
            "(flags.cc:310)", unread=_PARITY)
define_flag("default_dtype", "float32",
            "dtype of a static parameter whose builder names none "
            "(LayerHelper.create_parameter)")
define_flag("amp_dtype", "bfloat16",
            "low-precision dtype of amp.auto_cast, amp.decorate and "
            "amp.rewrite_program when the caller names none")
define_flag("fault_plan", "",
            "the seeded fault-injection plan (site[@hits]:action; ...) "
            "armed on the first get_fault_plan()")
define_flag("ps_retry_attempts", 5,
            "PS client RPC retry budget per verb "
            "(rpc_client.h FLAGS_rpc_retry_times)")
define_flag("ps_retry_base_s", 0.05,
            "PS client retry backoff base delay in seconds")
define_flag("ps_retry_max_s", 2.0,
            "PS client retry backoff cap in seconds")
define_flag("ps_retry_deadline_s", 30.0,
            "per-RPC wall-clock deadline across all retries "
            "(FLAGS_rpc_deadline)")
define_flag("ps_failover_after_s", 5.0,
            "seconds an endpoint may stay unreachable before the PS "
            "client fails over to its backup")
define_flag("watchdog_deadline_s", 0.0,
            "the hung-step watchdog's deadline around "
            "resilient_train_loop steps (0 disables)")
define_flag("slo_eval_interval_s", 0.5,
            "SLO engine background evaluation period in "
            "seconds")
define_flag("slo_availability_objective", 0.999,
            "serving-availability SLO target fraction")
define_flag("slo_latency_objective", 0.99,
            "wire-latency SLO target fraction")
define_flag("slo_wire_p99_threshold_s", 0.25,
            "wire-latency SLO threshold in seconds")
define_flag("slo_healthy_score", 0.8,
            "health score at or above which the verdict "
            "is 'healthy'")
define_flag("slo_degraded_score", 0.4,
            "health score at or above which the verdict "
            "is 'degraded'")
define_flag("train_numerics", True,
            "per-step training numerics telemetry of "
            "resilient_train_loop")
define_flag("concurrency_check", False,
            "arm the lock checker: make_lock() sites return TrackedLocks "
            "feeding the process-wide LockRegistry (lock-order cycles, "
            "wait/hold histograms) and guarded_by() annotations check "
            "shared-structure access against the thread's held locks "
            "(analysis/concurrency.py)")
define_flag("trace_sample_every", 8,
            "the gateway traces 1 in N requests that "
            "carry no trace context")
define_flag("fleet_heartbeat_interval_s", 0.5,
            "backend -> router heartbeat period")
define_flag("fleet_suspect_after_s", 2.0,
            "heartbeat age after which a backend is SUSPECT")
define_flag("fleet_lost_after_s", 6.0,
            "heartbeat age after which a backend is LOST and evicted")
define_flag("fleet_poll_interval_s", 1.0,
            "router poll period for each backend's /healthz and "
            "/stats")
define_flag("fleet_reroute_attempts", 4,
            "backends an idempotent request is tried against before "
            "it fails")
define_flag("fleet_spawn_timeout_s", 180.0,
            "budget for a spawned backend to print its FLEET-READY "
            "line")
define_flag("fleet_scale_cooldown_s", 5.0,
            "autoscaler's minimum gap between scaling actions")
define_flag("fleet_quiet_after_s", 30.0,
            "quiet time after which the autoscaler retires one "
            "backend")
define_flag("fleet_min_backends", 1,
            "autoscaler floor of live backends")
define_flag("fleet_max_backends", 8,
            "autoscaler ceiling of live backends")
define_flag("plan_hbm_bytes", 0.0,
            "device memory budget (bytes) for the serving fit gate; 0 "
            "disables. InferenceServer aborts startup with a "
            "model-does-not-fit ERROR when the static peak estimate of "
            "its largest bucket exceeds it")
define_flag("plan_fusion_discount", 1.0,
            "fraction of the liveness intermediate transient the "
            "planner's step-peak and capture-peak estimates charge. A "
            "captured graph fuses nothing (every intermediate the eager "
            "ops make is allocated in its pool), so the port charges it "
            "all; the JAX package's 0.25 was calibrated against XLA's "
            "fused executables")
define_flag("plan_large_param_mb", 64.0,
            "replicated-large-param hazard threshold (MiB) of the "
            "planner's sharding propagation: an unsharded parameter "
            "above it on a multi-rank mesh is flagged")
define_flag("plan_link_gbps", 100.0,
            "per-link bandwidth (GB/s) of the planner's ring / "
            "all-to-all collective transfer model")
