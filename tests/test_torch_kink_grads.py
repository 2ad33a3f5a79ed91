"""The op library's kinks and ties against `jax.vjp`, on the CPU: the
corpus's check (tests/test_torch_ops_corpus.py `check_case`: the numpy
oracle, the JAX op's forward and `jax.vjp` at GRAD_RTOL) on inputs that
sit exactly on a bound.

* F1: relu6, hard_sigmoid, hard_swish, clip, brelu and soft_relu take
  jnp.clip's derivative on a bound (1/2: minimum of maximum).
* F2: the static relu takes jnp.maximum's derivative at 0 (1/2).
* F3: abs and l1_norm take jnp.abs's derivative at 0 (1).
* F4: fake_channel_wise_quantize_dequantize_abs_max of a 1-D X with
  quant_axis 0 keeps one scale per element.
"""
import numpy as np
import pytest

from op_test import OpCase
from test_torch_ops_corpus import check_case


def _f(*v):
    return np.array(v, np.float32)


def _clip(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


CASES = [
    OpCase("relu6", {"X": _f(-1, 0, 3, 6, 7)}, {"threshold": 6.0},
           oracle=lambda X, attrs: _clip(X, 0, 6)),
    # slope 1/4: the bounds are exact in float32 with or without a fused
    # multiply-add
    OpCase("hard_sigmoid", {"X": _f(-2, 0, 2, 3)},
           {"slope": 0.25, "offset": 0.5},
           oracle=lambda X, attrs: _clip(0.25 * X + 0.5, 0, 1)),
    OpCase("hard_swish", {"X": _f(-3, -1, 3, 4)},
           oracle=lambda X, attrs: X * _clip(X + 3, 0, 6) / 6),
    OpCase("clip", {"X": _f(-0.5, 0.2, 1.0, 2.0)},
           {"min": -0.5, "max": 1.0},
           oracle=lambda X, attrs: _clip(X, -0.5, 1.0)),
    OpCase("brelu", {"X": _f(0, 5, 24, 30)}, {"t_min": 0.0, "t_max": 24.0},
           oracle=lambda X, attrs: _clip(X, 0, 24)),
    OpCase("soft_relu", {"X": _f(-40, 0, 40)}, {"threshold": 40.0},
           oracle=lambda X, attrs: np.log1p(np.exp(_clip(X, -40, 40)))),
    OpCase("relu", {"X": _f(-1, 0, 2)},
           oracle=lambda X, attrs: np.maximum(X, 0)),
    OpCase("abs", {"X": _f(-1, 0, 2)}, oracle=lambda X, attrs: np.abs(X)),
    OpCase("l1_norm", {"X": _f(-1, 0, 2)},
           oracle=lambda X, attrs: np.abs(X).sum()),
    OpCase("fake_channel_wise_quantize_dequantize_abs_max",
           {"X": _f(0.5, -0.25, 2.0)}, {"quant_axis": 0, "bit_length": 8},
           oracle=lambda X, attrs: (X, np.abs(X))),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.op)
def test_kink_matches_jax_vjp(case):
    check_case(case)
