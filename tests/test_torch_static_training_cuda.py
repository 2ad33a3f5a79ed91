"""Static training on the card against the CPU: three Momentum + L2Decay
steps of the tiny ResNet (blocks (1, 1, 1, 1), width 8, 3 x 32 x 32, 10
classes, batch 4), with chip_smoke phase 14(a)'s gates.

With every float var made float64, three chained steps: each loss within
1e-4 (relative), each parameter's change over the three steps within
1e-3 of its max |change|, BN running statistics and velocities within
1e-5 of their max |value|. In float32 each step starts from the CPU run's
state and holds the loss and the BN statistics to the same gates; its
updates are not gated, because a ReLU pre-activation within float32's
forward error of zero takes the other side of the kink on one device
(chip_smoke.py `step_agreement`).

Marked `cuda`: it skips without a GPU. It imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_static_training_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer, regularizer, static
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models.resnet import build_static
from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

LOSS_RTOL, UPDATE_TOL, STATE_TOL = 1e-4, 1e-3, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card against the CPU")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _programs():
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        img = static.data("img", [3, 32, 32], "float32")
        label = static.data("label", [1], "int64")
        _, loss, _ = build_static(img, label, num_classes=10, width=8,
                                  blocks=(1, 1, 1, 1))
        optimizer.Momentum(learning_rate=0.0125, momentum=0.9,
                           regularization=regularizer.L2Decay(1e-4)
                           ).minimize(loss)
    scope = Scope()
    Executor("cpu").run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    return main, loss.name, scope_to_numpy(scope, names)


def _widened(program):
    p = ir.Program.from_dict(program.to_dict())
    for v in p.global_block().vars.values():
        if v.dtype == torch.float32:
            v.dtype = torch.float64
    return p


def _feed(dtype):
    rng = np.random.RandomState(0)
    return {"img": rng.randn(4, 3, 32, 32).astype(dtype),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}


def _steps(program, state, feed, loss, device, n):
    scope = scope_from_jax(state, Scope(), device)
    exe = Executor(device)
    losses = [float(exe.run(program, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(n)]
    return losses, scope_to_numpy(scope, sorted(state))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.cuda
def test_three_float64_steps_on_the_card_match_the_cpu(cuda):
    main, loss, state = _programs()
    wide = _widened(main)
    state = {n: a.astype(np.float64) if a.dtype == np.float32 else a
             for n, a in state.items()}
    feed = _feed(np.float64)
    gl, gpu = _steps(wide, state, feed, loss, cuda, 3)
    cl, cpu = _steps(wide, state, feed, loss, "cpu", 3)
    np.testing.assert_allclose(gl, cl, rtol=LOSS_RTOL)
    assert cl[-1] < cl[0]
    params = next(op for op in main.global_block().ops
                  if op.type == "autodiff").attrs["params"]
    for n in params:
        assert _rel(gpu[n] - state[n], cpu[n] - state[n]) <= UPDATE_TOL, n
    for n in state:
        if n.startswith("bn_") or n.endswith("_velocity_Momentum"):
            assert _rel(gpu[n], cpu[n]) <= STATE_TOL, n


@pytest.mark.cuda
def test_float32_steps_on_the_card_match_the_cpu_in_loss_and_bn_stats(cuda):
    main, loss, state = _programs()
    feed = _feed(np.float32)
    for _ in range(3):
        (gl,), gpu = _steps(main, state, feed, loss, cuda, 1)
        (cl,), cpu = _steps(main, state, feed, loss, "cpu", 1)
        assert abs(gl - cl) <= LOSS_RTOL * abs(cl)
        for n in state:
            if n.startswith("bn_"):
                assert _rel(gpu[n], cpu[n]) <= STATE_TOL, n
        state = cpu
