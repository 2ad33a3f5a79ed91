"""paddle_tpu_torch.fleet: a multi-process replica fleet behind a
routing tier.

Counterpart of paddle_tpu/fleet/__init__.py. N backend processes — each
a full gateway + registry + pool with its own interpreter and CUDA
context — behind a `FleetRouter` that speaks the unchanged PTGW binary +
HTTP wire. Membership is heartbeat-driven (`FleetDirectory`); capacity
follows the SLO engine's burn-rate alerts (`FleetAutoscaler`); every
backend warm-starts through the shared persistent compile cache. An
active/standby router pair with epoch fencing (`StandbyMonitor`,
`ha.py`), a durable directory (`DirectoryStore`) the promoted router
re-adopts backends from, and the client's committed-token journal keep
a generate stream alive across a backend or router death.

    directory = FleetDirectory()
    router = FleetRouter(directory)
    host, port = router.start()
    manager = FleetManager(directory, spec_factory, router=router)
    manager.spawn()                       # backend 1 (warm start)
    scaler = FleetAutoscaler(manager, slo_engine=router.slo)
    scaler.start()
    # clients dial (host, port) with the ordinary GatewayClient

The router never touches the card; a backend runs on the card unless its
spec says ``"device": "cpu"``.
"""

from paddle_tpu_torch.fleet.autoscaler import FleetAutoscaler
from paddle_tpu_torch.fleet.backend import (
    BackendProcess, BackendServer, DeviceDelayPredictor,
    DeviceSimPredictor, FleetManager, build_predictor,
)
from paddle_tpu_torch.fleet.discovery import (
    JOINING, LIVE, LOST, SUSPECT, BackendRecord, DirectoryStore,
    FleetDirectory,
)
from paddle_tpu_torch.fleet.ha import RouterProcess, StandbyMonitor
from paddle_tpu_torch.fleet.router import (
    IDEMPOTENT_OPS, FleetRouter, HashRing, NoBackendError,
)

__all__ = [
    "BackendProcess", "BackendRecord", "BackendServer",
    "DeviceDelayPredictor", "DeviceSimPredictor", "DirectoryStore",
    "FleetAutoscaler", "FleetDirectory", "FleetManager", "FleetRouter",
    "HashRing", "IDEMPOTENT_OPS", "JOINING", "LIVE", "LOST",
    "NoBackendError", "RouterProcess", "StandbyMonitor", "SUSPECT",
    "build_predictor",
]
