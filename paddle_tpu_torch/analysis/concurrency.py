"""Named lock constructors.

Counterpart of the two factories of paddle_tpu/analysis/concurrency.py
that the serving path uses. Product code takes its locks from here so
every lock has a name; the reference's lock-order checker and contention
metrics (armed there by PT_FLAGS_concurrency_check) wait for the port's
analysis slice, so these return plain `threading` primitives.
"""
import threading

__all__ = ["make_lock", "make_rlock", "make_condition"]


def make_lock(name):
    """A plain threading.Lock for the lock called `name`."""
    del name
    return threading.Lock()


def make_rlock(name):
    del name
    return threading.RLock()


def make_condition(name, lock=None):
    """A Condition over `lock`, or over a fresh re-entrant lock named
    `name`."""
    if lock is None:
        lock = make_rlock(name)
    return threading.Condition(lock)
