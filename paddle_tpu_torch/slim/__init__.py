"""Model compression: the int8 part of contrib/slim (counterpart of
paddle_tpu/slim/ for the serving slice) — the quantization ops, the QAT
transform / freeze passes, ConvertToInt8Pass and post-training
quantization. Pruning, distillation and NAS are later slices."""
from paddle_tpu_torch.slim import quant_ops  # noqa: F401  (registers ops)
from paddle_tpu_torch.slim.quantization_pass import (  # noqa: F401
    SLIM_PASSES, ConvertToInt8Pass, QuantizationFreezePass,
    QuantizationTransformPass, quantize_program,
)
from paddle_tpu_torch.slim.post_training_quantization import (  # noqa: F401
    PostTrainingQuantization,
)
