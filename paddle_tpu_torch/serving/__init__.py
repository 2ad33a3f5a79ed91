"""paddle_tpu_torch.serving — dynamic-batching inference serving.

Counterpart of paddle_tpu/serving/ (its `__init__` exports, :55-76):

* `batcher` — bounded request queue + dynamic batcher: bucket ladder
  (one captured Executor entry per bucket, ever), max-wait deadline,
  per-request timeouts, explicit backpressure rejection;
* `pool` — `InferenceServer`: replica workers over `Predictor.clone()`,
  per-replica circuit breakers, requeue-with-backoff, warmup (the
  bucket ladder captured before traffic, restored from the compile
  cache's manifest when one is armed) and graceful drain;
* `metrics` — per-request/per-batch accounting over the unified metrics
  registry;
* `admission` — per-tenant token-bucket quotas, priority classes with
  preemption, deadline-aware shedding, bounded in-flight;
* `registry` — name → version → server, verify (lints, fit gate,
  quality gate) → prewarm → atomic commit → drain, rollback on any
  pre-commit failure;
* `wire` + `gateway` — the PTGW binary framing and HTTP/JSON on one
  port, byte-compatible with the JAX package's, streaming generation as
  206 frames and chunked HTTP;
* `generation` — continuous batching over the decode engines.
"""
from paddle_tpu_torch.serving.batcher import (  # noqa: F401
    Batch, DynamicBatcher, Preempted, QueueFullError, Request,
    RequestTimeout, ServerClosed, ServingError, default_buckets,
)
from paddle_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from paddle_tpu_torch.serving.pool import (  # noqa: F401
    InferenceServer, ReplicaHealth, create_server,
)
from paddle_tpu_torch.serving.admission import (  # noqa: F401
    Admission, AdmissionController, TenantQuota, TokenBucket,
)
from paddle_tpu_torch.serving.registry import (  # noqa: F401
    ModelRegistry, SwapError, UnknownModelError,
)
from paddle_tpu_torch.serving.gateway import ServingGateway  # noqa: F401
from paddle_tpu_torch.serving.generation import (  # noqa: F401
    ContinuousBatcher, GenerationAborted, GenerationRequest,
    GenerationServer, lockstep_generate,
)
from paddle_tpu_torch.serving.wire import (  # noqa: F401
    GatewayClient, GatewayError, WireError,
)
