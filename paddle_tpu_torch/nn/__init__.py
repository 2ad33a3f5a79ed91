"""Eager, define-by-run module API (Fluid's dygraph mode).

Counterpart of paddle_tpu/nn: layers as `nn.Module`s with the JAX
package's flat parameter and buffer names, the extension layers, the
functional ops, the eager training helpers, dygraph checkpoints and
traced layers. Autograd is the tape. `DataParallel` waits for the
parallel slice and raises.

`guard()` is accepted and does nothing (eager is always on, as in the
JAX package); `no_grad` is `torch.no_grad`, a decorator or a context.
"""
import contextlib

import torch

from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.layers import (  # noqa: F401
    BatchNorm, Conv2D, Conv2DTranspose, Dropout, Embedding, GroupNorm,
    Layer, LayerList, LayerNorm, Linear, Pool2D, Sequential, seed,
    to_variable,
)
from paddle_tpu_torch.nn.layers_ext import (  # noqa: F401
    FC, NCE, BilinearTensorProduct, Conv3D, Conv3DTranspose, GRUUnit,
    PRelu, RowConv, SequenceConv, SpectralNorm, TreeConv,
)
from paddle_tpu_torch.nn.train import TrainStep, grad, value_and_grad  # noqa: F401
from paddle_tpu_torch.nn import jit  # noqa: F401
from paddle_tpu_torch.nn.jit import (  # noqa: F401
    DataParallel, TracedLayer, load_dygraph, save_dygraph,
)


@contextlib.contextmanager
def guard(place=None):
    """fluid.dygraph.guard: eager needs no mode switch here."""
    yield


def no_grad(fn=None):
    """fluid.dygraph.no_grad: `@no_grad` on a function, or `with
    no_grad():`."""
    if fn is None:
        return torch.no_grad()
    return torch.no_grad()(fn)
