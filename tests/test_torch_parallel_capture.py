"""A CompiledProgram step under the Executor's capture, on the CPU tape
of tests/test_torch_executor_capture.py (`cuda_tape`: a dispatch mode
records the capture's ops, a replay reruns them), over a one-rank gloo
process group made in this process:

* reported as an NCCL group, the step is captured with its collectives
  inside the graph: the tape holds the c10d all-reduces and every replay
  reruns them; the losses equal the plain program's run from the same
  state, replay after replay;
* as the gloo group it is, the collectives are host work: the step runs
  eagerly and no graph is made, with the same losses.
"""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as R
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.parallel import CompiledProgram, env, make_mesh
from test_torch_executor_capture import cuda_tape  # noqa: F401 (fixture)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh({"dp": 1}, device="cpu")
    finally:
        dist.destroy_process_group()


def _losses(prog, tape, steps=3):
    main, startup, loss, _ = R._port_fc(bn=True)
    scope = Scope()
    exe = Executor("cpu")
    exe.run(startup, scope=scope)
    tape.made.clear()               # the startup program's own capture
    run = prog(main, loss) if prog else main
    xs, ys = np.random.RandomState(0).randn(8, 32).astype(np.float32), \
        np.arange(8).reshape(8, 1) % 4
    return [float(exe.run(run, feed={"x": xs, "y": ys}, fetch_list=[loss],
                          scope=scope)[0].reshape(-1)[0])
            for _ in range(steps)]


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_collectives_in_the_graph_or_eager(one_rank, cuda_tape,
                                           monkeypatch, backend):
    want = _losses(None, cuda_tape)
    mesh = one_rank
    if backend == "nccl":
        monkeypatch.setattr(env.Mesh, "backend",
                            lambda self, axis: "nccl")
    got = _losses(lambda main, loss: CompiledProgram(
        main).with_data_parallel(loss_name=loss.name, mesh=mesh), cuda_tape)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    graphs = [g for g in cuda_tape.made if g.tape is not None]
    if backend == "gloo":
        assert graphs == []
        return
    assert graphs and max(g.replays for g in graphs) >= 1
    names = [str(f) for g in graphs for f, *_ in g.tape.ops]
    assert any("allreduce" in n for n in names), names[:20]
