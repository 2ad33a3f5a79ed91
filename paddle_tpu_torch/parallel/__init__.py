"""Parallel execution over torch.distributed process groups.

Counterpart of paddle_tpu/parallel/ (its exports, `__init__.py:22-44`).
The JAX package is one process over a `jax.sharding.Mesh` whose
collectives GSPMD and shard_map insert; the port is one process per
rank over a `torch.distributed` process group (nccl or gloo, the
caller's choice) with named mesh dims (`env.make_mesh`), and every
collective is explicit (`ops/collective.py`):

* `CompiledProgram.with_data_parallel` / `ParallelExecutor`: a Program
  run rank by rank over the global batch, batch-norm moments and
  reductions global, sharded parameters gathered (compiler.py).
* pipeline parallelism (pipeline.py): one rank per stage, the schedule
  tables of schedules.py, activations and cotangents by send / recv.
* sequence parallelism (context_parallel.py): ring, ring-flash and
  Ulysses attention on the flash kernels.
* Switch MoE over an `ep` axis (moe.py), DGC and LocalSGD
  (grad_hooks.py).
* `ranks.RankPool`: worker processes, one per rank, for tests and the
  smoke script.
"""
from paddle_tpu_torch.parallel.env import (  # noqa: F401
    DEFAULT_DP_AXIS, Mesh, bind_mesh, bound_mesh, device_count, get_mesh,
    make_mesh, set_mesh,
)
from paddle_tpu_torch.parallel.compiler import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy,
)
from paddle_tpu_torch.parallel.context_parallel import (  # noqa: F401
    flash_attention_fn, ring_attention, ring_flash_attention,
    shard_map_attention, shard_sequence, ulysses_attention,
)
from paddle_tpu_torch.parallel.pipeline import (  # noqa: F401
    GPipe, Pipeline, PipelineCompiledProgram, PipelineOptimizer,
    bubble_fraction, pipeline_apply, schedule_report,
    stack_stage_params, stack_virtual_stage_params,
    unstack_stage_params, unstack_virtual_stage_params,
)
from paddle_tpu_torch.parallel.schedules import (  # noqa: F401
    ScheduleTable, make_schedule,
)
from paddle_tpu_torch.parallel.moe import moe_op_attrs, switch_moe  # noqa: F401
from paddle_tpu_torch.parallel.grad_hooks import (  # noqa: F401
    dgc_allreduce, dgc_init_state, dgc_sparsity, dgc_transform,
    local_sgd_average,
)
