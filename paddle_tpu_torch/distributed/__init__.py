"""Distributed training: the fleet API, role discovery, strategy and the
launcher.

Counterpart of paddle_tpu/distributed/ (the reference's
python/paddle/fluid/incubate/fleet/ — fleet_base.py:38,
collective/__init__.py:41 — and python/paddle/distributed/launch.py).
Collective mode runs over a `torch.distributed` process group that
`fleet.init()` starts from the launcher's PADDLE_* environment;
parameter-server mode delegates to `paddle_tpu_torch.ps`.

The names resolve on first access (a module `__getattr__`), so
`python -m paddle_tpu_torch.distributed.launch` starts its workers
without importing torch first.
"""
import importlib

_LAZY = {
    **{n: ("paddle_tpu_torch.distributed.fleet", n) for n in (
        "CollectiveOptimizer", "Fleet", "choose_backend", "fleet")},
    **{n: ("paddle_tpu_torch.distributed.role_maker", n) for n in (
        "PaddleCloudRoleMaker", "Role", "RoleMakerBase",
        "UserDefinedRoleMaker")},
    "DistributedStrategy": ("paddle_tpu_torch.distributed.strategy",
                            "DistributedStrategy"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'paddle_tpu_torch.distributed' has no "
                             f"attribute {name!r}")
    module, attr = _LAZY[name]
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
