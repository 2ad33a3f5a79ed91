"""fluid.regularizer module path — re-export of utils/regularizer.py."""
from paddle_tpu_torch.utils.regularizer import (  # noqa: F401
    L1Decay, L1DecayRegularizer, L2Decay, L2DecayRegularizer, Regularizer)
