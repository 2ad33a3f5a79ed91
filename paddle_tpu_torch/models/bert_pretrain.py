"""The BERT pretraining step: bf16 parameters, f32 master weights, Adam.

Counterpart of the step inside the JAX package's `bench.py::main`
(`bench.py:210-278`); `bench.py` itself, its timing harness and its TPU
peak table are not ported. What carries over:

* parameters: f32 leaves with ndim >= 2 become the model's dtype when it
  is bfloat16 (`mlm_bias` is already made in that dtype; LayerNorm
  parameters and biases stay f32);
* an f32 master copy and Adam moments (lr 1e-4, beta 0.9 / 0.999,
  eps 1e-8, bias correction by the step number t, in f32), the master
  written back into the parameters in their dtype;
* `model.train()`: dropout on, in the attention kernel and on the hidden
  states;
* per-step randomness from one generator seeded from (42, t), from which
  `Bert.encode` draws three seeds per layer.

The JAX step donates parameters and optimizer state to jit, so XLA
updates them in place; here the update is in place explicitly
(`mul_`/`add_`/`copy_` into the same tensors).
"""
import time

import numpy as np
import torch

from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.models.bert import Bert, BertConfig, synthetic_batch
from paddle_tpu_torch.nn.train import value_and_grad

__all__ = ["step_generator", "BertPretrainer", "run"]


def step_generator(t, base=42):
    """The CPU generator of step t: seeded with (base << 32) + t."""
    return torch.Generator().manual_seed((int(base) << 32) + int(t))


class BertPretrainer:
    """Owns a `Bert` in train mode, its f32 master weights and Adam
    moments. `step(batch)` runs one pretraining step and returns the
    loss (a 0-dim f32 tensor on the device, not synchronised)."""

    def __init__(self, cfg=None, device=None, lr=1e-4, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.device = resolve_device(device)
        self.cfg = cfg or BertConfig(dtype="bfloat16", attention_impl="flash")
        self.model = Bert(self.cfg, device=self.device)
        self.model.train()
        low = self.model._dtype
        if low != torch.float32:
            self.model.load_trainable({
                k: p.detach().to(low)
                for k, p in self.model.trainable_dict().items()
                if p.dtype == torch.float32 and p.dim() >= 2})
        self.params = self.model.trainable_dict()
        self.master = {k: p.detach().to(torch.float32, copy=True)
                       for k, p in self.params.items()}
        self.m1 = {k: torch.zeros_like(p) for k, p in self.master.items()}
        self.m2 = {k: torch.zeros_like(p) for k, p in self.master.items()}
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0

    def batch(self, ids, types, attn, labels, nsp):
        """numpy arrays (as `synthetic_batch` gives them) → device tensors."""
        return tuple(torch.as_tensor(np.asarray(a), device=self.device)
                     for a in (ids, types, attn, labels, nsp))

    def step(self, batch):
        self.t += 1
        gen = step_generator(self.t)
        model = self.model
        loss, grads = value_and_grad(
            lambda: model.pretrain_loss(*batch, rngs=gen), model)()
        t = np.float32(self.t)
        # bias corrections in f32, as the JAX step computes b ** t with an
        # f32 t
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k].float()
                m1, m2, mst = self.m1[k], self.m2[k], self.master[k]
                m1.mul_(self.b1).add_((1 - self.b1) * g)
                m2.mul_(self.b2).add_((1 - self.b2) * g * g)
                mst.sub_(self.lr * (m1 / bc1)
                         / ((m2 / bc2).sqrt_().add_(self.eps)))
                p.copy_(mst)
        return loss


def run(steps, batch, seq, device=None, cfg=None, seed=0):
    """`steps` pretraining steps on the fixed `synthetic_batch(seed, ...)`.
    Returns {"loss": [float per step], "step_s": [wall seconds per step,
    each ending in a device synchronisation]}."""
    trainer = BertPretrainer(cfg, device=device)
    data = trainer.batch(*synthetic_batch(seed, batch, seq, trainer.cfg))
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = trainer.step(data)
        losses.append(float(loss))      # synchronises
        times.append(time.perf_counter() - t0)
    return {"loss": losses, "step_s": times}
