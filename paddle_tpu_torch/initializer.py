"""fluid.initializer module path: re-export of utils/initializer.py
(counterpart of paddle_tpu/initializer.py)."""
from paddle_tpu_torch.utils.initializer import *  # noqa: F401,F403
from paddle_tpu_torch.utils.initializer import __all__  # noqa: F401
