"""fluid.install_check (install_check.py:45 run_check): one eager train
step and one static train step on the card, so that
`paddle_tpu_torch.install_check.run_check()` certifies an install the way
the reference's does (counterpart of paddle_tpu/install_check.py).

`device=None` means CUDA and raises without a GPU, as every entry point
of the port does; `run_check("cpu")` checks the host.
"""
import numpy as np

__all__ = ["run_check"]


def run_check(device=None):
    import torch

    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.places import resolve_device
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.nn import layers
    from paddle_tpu_torch.nn.train import TrainStep

    dev = resolve_device(device)
    rng = np.random.RandomState(0)

    # eager: one Linear step
    model = layers.Linear(4, 2, device=dev)
    x = torch.from_numpy(rng.rand(2, 4).astype(np.float32)).to(dev)
    loss = TrainStep(model, lambda m, xb: (m(xb) ** 2).mean(), 0.1)(x)
    assert bool(torch.isfinite(loss)), "eager step: loss not finite"

    # static: one fc step through Program -> Executor
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        xv = static.data("x", [-1, 4], append_batch_size=False)
        loss_v = static.mean(static.square(static.fc(xv, 2)))
        optimizer.SGD(0.1).minimize(loss_v)
    exe = Executor(dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    (lv,) = exe.run(main, feed={"x": rng.rand(2, 4).astype(np.float32)},
                    fetch_list=[loss_v], scope=scope)
    assert np.isfinite(float(lv)), "static step: loss not finite"

    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")
    print(f"Your paddle_tpu_torch works well on {dev.type.upper()} "
          f"({name}).")
    print("Your paddle_tpu_torch is installed successfully! Let's start "
          "deep learning with paddle_tpu_torch now.")
    return float(loss), float(lv)
