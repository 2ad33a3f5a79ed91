"""The index ops, dropout and the LR counter on the card against the
CPU.

* `gather`, `gather_nd`, `scatter` (overwrite and add), `lookup_table`
  (with padding_idx, the book's four lookups of one shared table),
  `lookup_table_v2`, `one_hot` and `where_index`: the same numpy inputs
  on the card and on the CPU, forward equal (`scatter` with
  overwrite=False within 1e-6 of its max), and the float inputs'
  gradients of sum(out · cotangent) within 1e-6 of their max: the
  card's scatter-add sums a row's contributions in a varying order, so
  an accumulating scatter and the table's gradient are held to a
  tolerance, not to bits.
* dropout on the card keeps 1 - p within 5 sigma and its gradient is
  mask · dout.
* A `piecewise_decay` and an `exponential_decay` program on the card:
  over 8 runs the rate and `lr_global_step` equal the CPU's, and the
  counter and the rate stay tensors on the card.
* `install_check.run_check()` runs its eager and static steps on the
  card (its default device).

Marked `cuda`: it skips without a GPU. It imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_ops_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import static
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.registry import OpContext, get_op
from paddle_tpu_torch.core.scope import Scope

pytestmark = pytest.mark.cuda

R = np.random.RandomState(5)
X = R.randn(6, 4).astype(np.float32)
TABLE = R.randn(50, 8).astype(np.float32)
IDS4 = R.randint(0, 50, (64, 4, 1)).astype(np.int64)

#: op, inputs (numpy, in slot order), attrs, indices of the float inputs
#: whose gradient is checked
CASES = {
    "gather": ("gather", (X, np.array([5, 0, 2, 2], np.int64)), {}, [0]),
    "gather_nd": ("gather_nd", (X, np.array([[1, 2], [5, 3], [1, 2]],
                                            np.int64)), {}, [0]),
    "scatter": ("scatter", (X, np.array([1, 4], np.int64),
                            R.randn(2, 4).astype(np.float32)), {}, [0, 2]),
    "scatter_add": ("scatter", (X, np.array([1, 4, 1], np.int64),
                                R.randn(3, 4).astype(np.float32)),
                    {"overwrite": False}, [0, 2]),
    "lookup_table_padding": ("lookup_table", (TABLE, IDS4[:, 0]),
                             {"padding_idx": 3}, [0]),
    "lookup_table_shared": ("lookup_table", (TABLE, IDS4), {}, [0]),
    "lookup_table_v2": ("lookup_table_v2", (TABLE, IDS4[:, :, 0]), {}, [0]),
    "one_hot": ("one_hot", (np.array([[1], [7], [0]], np.int64),),
                {"depth": 6}, []),
    "where_index": ("where_index", (X > 0.3,), {}, []),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card against the CPU")


def _run(op, args, attrs, device, grads):
    impl = get_op(op)
    ts = [torch.from_numpy(np.array(a, copy=True)).to(device) for a in args]
    leaves = [ts[i].requires_grad_() for i in grads]
    with torch.enable_grad():
        out = impl.fn(OpContext(dict(attrs), 0, True, 0, device), *ts)
        g = []
        if leaves:
            cot = torch.from_numpy(np.random.RandomState(1).uniform(
                0.5, 1.5, tuple(out.shape)).astype(np.float32)).to(device)
            g = torch.autograd.grad((out * cot).sum(), leaves)
    return out.detach().cpu().numpy(), [x.cpu().numpy() for x in g]


@pytest.mark.parametrize("case", sorted(CASES))
def test_index_op_on_the_card_matches_the_cpu(cuda, case):
    op, args, attrs, grads = CASES[case]
    got, gg = _run(op, args, attrs, "cuda", grads)
    want, wg = _run(op, args, attrs, "cpu", grads)
    if attrs.get("overwrite", True):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def test_dropout_on_the_card(cuda):
    x = torch.rand(256, 512, device="cuda") + 0.5
    x.requires_grad_()
    with torch.enable_grad():
        out, mask = get_op("dropout").fn(
            OpContext({"dropout_prob": 0.3}, 0, True, 0, "cuda"), x)
        (g,) = torch.autograd.grad(out.sum(), x)
    keep = mask.mean().item()
    sigma = (0.7 * 0.3 / mask.numel()) ** 0.5
    assert abs(keep - 0.7) < 5 * sigma
    assert torch.equal(g, mask)
    assert torch.equal(out.detach(), x.detach() * mask)


@pytest.mark.parametrize("schedule", ["piecewise", "exponential"])
def test_lr_counter_on_the_card(cuda, schedule):
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        lr = (static.piecewise_decay([2, 5], [0.1, 0.05, 0.01])
              if schedule == "piecewise"
              else static.exponential_decay(0.1, 3, 0.5))
    runs = {}
    for dev in ("cuda", "cpu"):
        scope = Scope()
        exe = Executor(dev)
        exe.run(startup, scope=scope)
        out = [exe.run(main, fetch_list=[lr, "lr_global_step"],
                       scope=scope, return_numpy=False) for _ in range(8)]
        assert all(t.device.type == dev for pair in out for t in pair)
        assert scope.get("lr_global_step").device.type == dev
        runs[dev] = np.array([[float(t.cpu()) for t in pair]
                              for pair in out])
    np.testing.assert_array_equal(runs["cuda"][:, 1], np.arange(1, 9))
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-6)


def test_install_check_on_the_card(cuda, capsys):
    from paddle_tpu_torch import install_check
    eager, static_loss = install_check.run_check()
    assert np.isfinite(eager) and np.isfinite(static_loss)
    assert "works well on CUDA" in capsys.readouterr().out
