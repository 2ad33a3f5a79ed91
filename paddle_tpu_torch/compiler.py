"""fluid.compiler module-path alias (compiler.py:65), counterpart of
paddle_tpu/compiler.py: CompiledProgram and the strategies live in
paddle_tpu_torch.parallel."""
from paddle_tpu_torch.parallel.compiler import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy)
