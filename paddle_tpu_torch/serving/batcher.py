"""Serving-layer errors.

Counterpart of the error classes of paddle_tpu/serving/batcher.py; the
one-shot DynamicBatcher there waits for the port's serving slice.
"""

__all__ = ["ServingError", "QueueFullError", "RequestTimeout",
           "ServerClosed"]


class ServingError(Exception):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Backpressure rejection: the bounded request queue is full."""


class RequestTimeout(ServingError):
    """The request's deadline passed before a result was produced."""


class ServerClosed(ServingError):
    """The server is shut down (or shutting down) and not accepting."""
