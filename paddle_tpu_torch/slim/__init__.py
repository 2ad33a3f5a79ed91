"""Model compression: the contrib/slim capability set (counterpart of
paddle_tpu/slim/) — the quantization ops, the QAT transform / freeze
passes, ConvertToInt8Pass, post-training quantization and the plan
vetoes, magnitude / channel pruning with sensitivity analysis,
knowledge distillation, and architecture search (the reference's
simulated-annealing searcher)."""
from paddle_tpu_torch.slim import quant_ops  # noqa: F401  (registers ops)
from paddle_tpu_torch.slim.quantization_pass import (  # noqa: F401
    SLIM_PASSES, ConvertToInt8Pass, QuantizationFreezePass,
    QuantizationTransformPass, apply_plan_vetoes, quantize_program,
)
from paddle_tpu_torch.slim.post_training_quantization import (  # noqa: F401
    PostTrainingQuantization,
)
from paddle_tpu_torch.slim.prune import (  # noqa: F401
    Pruner, sensitivity, sparsity,
)
from paddle_tpu_torch.slim.nas import (  # noqa: F401
    EvolutionaryController, NASSearcher, SAController, SearchSpace,
    flops_of,
)
from paddle_tpu_torch.slim import distill  # noqa: F401
