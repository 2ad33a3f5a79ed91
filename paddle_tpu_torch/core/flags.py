"""Runtime flags.

Counterpart of paddle_tpu/core/flags.py: a typed registry initialised
from `PT_FLAGS_<name>` environment variables (the reference's gflags
whitelist, python/paddle/fluid/__init__.py:162-189), with every flag of
the JAX package under its name, type and default. The port reads
check_nan_inf, executor_log_level, verify_program and deterministic (the
Executor), default_dtype (static parameters) and amp_dtype (`amp`). The
others name the module of a later slice that will read them (`unread`);
until then a value other than the default warns once that it has no
effect. No flag picks the device: that is `core.places.resolve_device`'s.
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


#: the reasons of the flags no module of the port reads yet
_PARITY = "kept for API parity, no counterpart in the port"
_ITEM12 = "read by the serving gateway, ROADMAP Queue 1 item 12"
_ITEM14 = "read by the reliability / SLO / fleet services, ROADMAP " \
          "Queue 1 item 14"
_ITEM15 = "read by the parameter-server client, ROADMAP Queue 1 item 15"
_ITEM17 = "read by analysis.concurrency, ROADMAP Queue 1 item 17"


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
            "not read yet: the seeded fault-injection plan "
            "(site[@hits]:action; ...) that arms the inject_point "
            "sites", unread=_ITEM14)
define_flag("ps_retry_attempts", 5,
            "not read yet: PS client RPC retry budget per verb "
            "(rpc_client.h FLAGS_rpc_retry_times)", unread=_ITEM15)
define_flag("ps_retry_base_s", 0.05,
            "not read yet: PS client retry backoff base delay in "
            "seconds", unread=_ITEM15)
define_flag("ps_retry_max_s", 2.0,
            "not read yet: PS client retry backoff cap in seconds",
            unread=_ITEM15)
define_flag("ps_retry_deadline_s", 30.0,
            "not read yet: per-RPC wall-clock deadline across all "
            "retries (FLAGS_rpc_deadline)", unread=_ITEM15)
define_flag("ps_failover_after_s", 5.0,
            "not read yet: seconds an endpoint may stay unreachable "
            "before the PS client fails over to its backup",
            unread=_ITEM15)
define_flag("watchdog_deadline_s", 0.0,
            "not read yet: the hung-step watchdog's deadline around "
            "resilient_train_loop steps (0 disables)", unread=_ITEM14)
define_flag("slo_eval_interval_s", 0.5,
            "not read yet: SLO engine background evaluation period in "
            "seconds", unread=_ITEM14)
define_flag("slo_availability_objective", 0.999,
            "not read yet: serving-availability SLO target fraction",
            unread=_ITEM14)
define_flag("slo_latency_objective", 0.99,
            "not read yet: wire-latency SLO target fraction",
            unread=_ITEM14)
define_flag("slo_wire_p99_threshold_s", 0.25,
            "not read yet: wire-latency SLO threshold in seconds",
            unread=_ITEM14)
define_flag("slo_healthy_score", 0.8,
            "not read yet: health score at or above which the verdict "
            "is 'healthy'", unread=_ITEM14)
define_flag("slo_degraded_score", 0.4,
            "not read yet: health score at or above which the verdict "
            "is 'degraded'", unread=_ITEM14)
define_flag("train_numerics", True,
            "not read yet: per-step training numerics telemetry of "
            "resilient_train_loop", unread=_ITEM14)
define_flag("concurrency_check", False,
            "not read yet: arm the lock-order and guarded-by checks of "
            "make_lock() sites", unread=_ITEM17)
define_flag("trace_sample_every", 8,
            "not read yet: the gateway traces 1 in N requests that "
            "carry no trace context", unread=_ITEM12)
define_flag("fleet_heartbeat_interval_s", 0.5,
            "not read yet: backend -> router heartbeat period",
            unread=_ITEM14)
define_flag("fleet_suspect_after_s", 2.0,
            "not read yet: heartbeat age after which a backend is "
            "SUSPECT", unread=_ITEM14)
define_flag("fleet_lost_after_s", 6.0,
            "not read yet: heartbeat age after which a backend is LOST "
            "and evicted", unread=_ITEM14)
define_flag("fleet_poll_interval_s", 1.0,
            "not read yet: router poll period for each backend's "
            "/healthz and /stats", unread=_ITEM14)
define_flag("fleet_reroute_attempts", 4,
            "not read yet: backends an idempotent request is tried "
            "against before it fails", unread=_ITEM14)
define_flag("fleet_spawn_timeout_s", 180.0,
            "not read yet: budget for a spawned backend to print its "
            "FLEET-READY line", unread=_ITEM14)
define_flag("fleet_scale_cooldown_s", 5.0,
            "not read yet: autoscaler's minimum gap between scaling "
            "actions", unread=_ITEM14)
define_flag("fleet_quiet_after_s", 30.0,
            "not read yet: quiet time after which the autoscaler "
            "retires one backend", unread=_ITEM14)
define_flag("fleet_min_backends", 1,
            "not read yet: autoscaler floor of live backends",
            unread=_ITEM14)
define_flag("fleet_max_backends", 8,
            "not read yet: autoscaler ceiling of live backends",
            unread=_ITEM14)
