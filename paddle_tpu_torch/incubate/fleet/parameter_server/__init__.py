"""incubate/fleet/parameter_server: the fleet's parameter-server mode
(paddle_tpu_torch.distributed.fleet over paddle_tpu_torch.ps)."""
from paddle_tpu_torch.distributed.fleet import fleet  # noqa: F401
