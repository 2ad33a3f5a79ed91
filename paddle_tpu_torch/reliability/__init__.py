"""paddle_tpu_torch.reliability — fault injection, fault tolerance, resume.

Counterpart of paddle_tpu/reliability/__init__.py, exporting what it
does:

* `faults` — the seeded fault-injection registry: `FaultPlan` rules at
  named `inject_point()` choke points, armed in code or from
  PT_FLAGS_fault_plan;
* `checkpoint` — `CheckpointManager`: atomic publishes, CRC32 manifest,
  keep-last-N GC, `latest_valid()` resume;
* `training` — `resilient_train_loop`: interval + SIGTERM checkpointing
  around the Executor step loop with auto-resume;
* `retry` — `RetryPolicy`: deadline, capped exponential backoff with
  seeded jitter, bounded attempts; wrapped around every parameter-server
  client verb (`paddle_tpu_torch.ps`) with a retry-safety class per verb
  and seq-stamped at-most-once pushes;
* `supervisor` — `Supervisor` / `WorkerSpec`: the supervision loop
  behind `distributed.launch --elastic`: restart budget in a sliding
  window, same-rank restart with checkpoint resume, SIGTERM drain, JSON
  supervision report;
* `watchdog` — `Watchdog`: hung-step detection with a stack, counter
  and flight-recorder dump, then abort / event / callback.
"""
from paddle_tpu_torch.reliability.faults import (  # noqa: F401
    KNOWN_SITES, FaultError, FaultPlan, FaultPlanError, fault_plan,
    get_fault_plan, inject_point, set_fault_plan,
)
from paddle_tpu_torch.reliability.checkpoint import (  # noqa: F401
    CheckpointManager,
)
from paddle_tpu_torch.reliability.retry import (  # noqa: F401
    RetryError, RetryPolicy,
)
from paddle_tpu_torch.reliability.training import (  # noqa: F401
    TrainingInterrupted, resilient_train_loop,
)
from paddle_tpu_torch.reliability.watchdog import (  # noqa: F401
    HungStepError, StallReport, Watchdog,
)
from paddle_tpu_torch.reliability.supervisor import (  # noqa: F401
    Supervisor, WorkerSpec,
)
