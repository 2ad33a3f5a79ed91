"""fluid.unique_name module path (the reference's unique_name.py):
generate / switch / guard over the IR's name generator
(core/ir.py `unique_name`)."""
import contextlib

from paddle_tpu_torch.core import ir as _ir

__all__ = ["generate", "switch", "guard"]


def generate(key):
    return _ir.unique_name(key)


def switch(new_generator=None):
    """Swap in a new counter set and return the old one."""
    old = dict(_ir._name_counters)
    _ir._name_counters.clear()
    if new_generator:
        _ir._name_counters.update(new_generator)
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """Fresh names inside; the previous counters come back on exit."""
    old = switch(new_generator if isinstance(new_generator, dict) else None)
    try:
        yield
    finally:
        switch(old)
