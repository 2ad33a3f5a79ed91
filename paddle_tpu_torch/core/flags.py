"""Runtime flags.

Counterpart of paddle_tpu/core/flags.py for the flags the Executor
reads: a typed registry initialised from `PT_FLAGS_<name>` environment
variables (the reference's gflags whitelist, python/paddle/fluid/
__init__.py:162-189). The JAX package's other flags (fleet, SLO, PS
retry, fault plans) wait for the modules that read them.
"""
import os

__all__ = ["define_flag", "get_flag", "set_flag", "all_flags"]

_REGISTRY = {}


class _Flag:
    __slots__ = ("name", "default", "type", "help", "value")

    def __init__(self, name, default, type_, help_):
        self.name, self.default, self.type, self.help = (name, default,
                                                         type_, help_)
        self.value = default


def define_flag(name, default, help_=""):
    f = _Flag(name, default, type(default), help_)
    env = os.environ.get(f"PT_FLAGS_{name}")
    if env is not None:
        if f.type is bool:
            f.value = env.lower() in ("1", "true", "yes")
        else:
            f.value = f.type(env)
    _REGISTRY[name] = f
    return f


def get_flag(name):
    return _REGISTRY[name].value


def set_flag(name, value):
    _REGISTRY[name].value = value


def all_flags():
    return {k: v.value for k, v in _REGISTRY.items()}


define_flag("check_nan_inf", False,
            "verify finiteness of every fetched tensor (flags.cc:44)")
define_flag("executor_log_level", 0,
            "verbosity of the executor (VLOG): > 0 logs each new step "
            "function")
define_flag("verify_program", False,
            "debug mode: run the paddle_tpu_torch.analysis verifier on "
            "every program entering make_step_fn and raise on ERROR "
            "findings")
