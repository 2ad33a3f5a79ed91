"""Static-graph API — the fluid.layers + Program surface.

Counterpart of paddle_tpu/static/: the single-op builders (`common.py`),
the layers (`nn.py`), the composite nets (`nets.py`), `LayerHelper`,
`io` (save/load of inference models and persistables),
`append_backward` / `gradients`, the LR schedulers (re-exported from
`optimizer.lr`, as in `fluid.layers`), control flow
(`control_flow.py`: While, StaticRNN, DynamicRNN, cond, case, Switch),
the recurrent layers, tensor arrays and beam-search steps (`rnn.py`),
the structured losses (`losses.py`), the cell API (`rnn_api.py`), the
long-tail builders (`extras.py`), the compatibility surface
(`compat.py`), the detection layers (`detection.py`, also exported
flat, as `fluid.layers` does), `distributions` and `save` / `load`:
every name of the JAX package's static.
"""
from paddle_tpu_torch.core.ir import (  # noqa: F401
    Program, Variable, default_main_program, default_startup_program,
    program_guard,
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
from paddle_tpu_torch.static.control_flow import (  # noqa: F401,E402
    DynamicRNN, StaticRNN, Switch, While, case, cond, switch_case,
)
from paddle_tpu_torch.static.rnn import (  # noqa: F401,E402
    array_read, array_write, beam_search, beam_search_decode, create_array,
    dynamic_gru, dynamic_lstm, dynamic_lstmp, gru_unit, lstm_unit)
from paddle_tpu_torch.static.losses import (  # noqa: F401,E402
    crf_decoding, hsigmoid, linear_chain_crf, nce,
    sampled_softmax_with_cross_entropy, warpctc)
from paddle_tpu_torch.static.extras import *  # noqa: F401,F403,E402
from paddle_tpu_torch.static.compat import *  # noqa: F401,F403,E402
from paddle_tpu_torch.static.rnn_api import (  # noqa: F401,E402
    RNNCell, GRUCell, LSTMCell, rnn, Decoder, BeamSearchDecoder,
    dynamic_decode)
from paddle_tpu_torch.static import detection  # noqa: F401,E402
from paddle_tpu_torch.static.detection import (  # noqa: F401,E402
    anchor_generator, bipartite_match, box_clip, box_coder,
    box_decoder_and_assign, collect_fpn_proposals, density_prior_box,
    detection_map, detection_output, distribute_fpn_proposals,
    generate_mask_labels, generate_proposal_labels, generate_proposals,
    iou_similarity, multi_box_head, multiclass_nms,
    polygon_box_transform, prior_box, retinanet_detection_output,
    retinanet_target_assign, roi_align, roi_perspective_transform,
    roi_pool, rpn_target_assign, sigmoid_focal_loss, ssd_loss,
    target_assign, yolo_box, yolov3_loss)
from paddle_tpu_torch.static import distributions  # noqa: F401,E402
from paddle_tpu_torch.static.io import load, save  # noqa: F401,E402
