"""Static-graph API — the fluid.layers + Program surface.

Counterpart of paddle_tpu/static/ for the serving and static-training
slices: the single-op builders (`common.py`), the layers (`nn.py`), the
composite nets (`nets.py`), `LayerHelper`, `io` (save/load of inference
models and persistables), `append_backward` / `gradients` and the LR
schedulers (re-exported from `optimizer.lr`, as in `fluid.layers`).
Control flow, RNNs, the sequence family and detection are later slices.
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
    adaptive_pool2d, batch_norm, conv2d, conv2d_transpose, data, dropout,
    embedding, fc, group_norm, layer_norm, pool2d, prelu,
)
from paddle_tpu_torch.static import io  # noqa: F401,E402
from paddle_tpu_torch.static import nets  # noqa: F401,E402
from paddle_tpu_torch.optimizer.lr import (  # noqa: F401,E402
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
