"""Static-graph API — the fluid.layers + Program surface.

Counterpart of paddle_tpu/static/ for the serving and static-training
slices: the layer builders that ResNet, LeNet and fit_a_line call,
`LayerHelper`, `io` (save/load of inference models and persistables)
and `append_backward` / `gradients` (static/backward.py). Control flow,
RNNs and detection are later slices.
"""
from paddle_tpu_torch.core.ir import (  # noqa: F401
    Program, default_main_program, default_startup_program, program_guard,
)
from paddle_tpu_torch.static.backward import (  # noqa: F401
    append_backward, gradients,
)
from paddle_tpu_torch.static.common import *  # noqa: F401,F403
from paddle_tpu_torch.static.common import _elementwise_binary  # noqa: F401
from paddle_tpu_torch.static.helper import LayerHelper  # noqa: F401
from paddle_tpu_torch.static.nn import (  # noqa: F401
    batch_norm, conv2d, data, fc, pool2d,
)
from paddle_tpu_torch.static import io  # noqa: F401,E402
