"""incubate/fleet/collective: the collective fleet
(paddle_tpu_torch.distributed.fleet)."""
from paddle_tpu_torch.distributed.fleet import (  # noqa: F401
    CollectiveOptimizer, fleet)
from paddle_tpu_torch.distributed.strategy import (  # noqa: F401
    DistributedStrategy)
