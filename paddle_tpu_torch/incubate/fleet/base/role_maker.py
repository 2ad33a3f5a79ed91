"""incubate/fleet/base/role_maker.py: the role makers
(paddle_tpu_torch.distributed.role_maker)."""
from paddle_tpu_torch.distributed.role_maker import *  # noqa: F401,F403
from paddle_tpu_torch.distributed.role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker)
