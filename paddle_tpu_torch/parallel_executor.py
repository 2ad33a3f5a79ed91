"""fluid.ParallelExecutor source compatibility (parallel_executor.py:28).

Counterpart of paddle_tpu/parallel_executor.py: the legacy construct-
then-run API over CompiledProgram and the Executor. Each rank of the
mesh constructs one and runs it with the GLOBAL batch (a list of
per-device feed dicts is concatenated first); the fetches are global.
`use_cuda` picks the device (True: the card, False: the CPU)."""
import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.ir import default_main_program
from paddle_tpu_torch.parallel.compiler import CompiledProgram
from paddle_tpu_torch.parallel.env import get_mesh

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, mesh=None):
        self._program = main_program or default_main_program()
        self._compiled = CompiledProgram(
            self._program, build_strategy).with_data_parallel(
                loss_name=loss_name, exec_strategy=exec_strategy,
                mesh=mesh or get_mesh())
        self._exe = Executor("cuda" if use_cuda else "cpu")
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        """Feed the GLOBAL batch (a list of per-device dicts is
        concatenated along the batch)."""
        feed = feed if feed is not None else feed_dict
        if isinstance(feed, (list, tuple)):
            merged = {}
            for d in feed:
                for k, v in d.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            feed = {k: np.concatenate(v, axis=0) for k, v in merged.items()}
        enforce(isinstance(feed, dict), "ParallelExecutor.run needs a "
                "feed dict (or list of dicts)")
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=list(fetch_list),
                             scope=self._scope, return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        pass

    @property
    def device_count(self):
        return self._compiled.mesh.size
