"""Eager, define-by-run module API.

Counterpart of paddle_tpu/nn for the BERT slice: layers as `nn.Module`s
with the JAX package's flat parameter names, the functional ops, and the
eager training helpers.
"""
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.layers import (  # noqa: F401
    Dropout, Embedding, Layer, LayerList, LayerNorm, Linear, seed,
)
from paddle_tpu_torch.nn.train import TrainStep, grad, value_and_grad  # noqa: F401
