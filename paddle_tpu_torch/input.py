"""fluid.input module path: `embedding` and `one_hot` as module-level
builders (counterpart of paddle_tpu/input.py)."""
from paddle_tpu_torch.static.common import one_hot  # noqa: F401
from paddle_tpu_torch.static.nn import embedding  # noqa: F401

__all__ = ["embedding", "one_hot"]
