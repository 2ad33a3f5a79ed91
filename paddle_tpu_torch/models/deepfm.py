"""DeepFM CTR (BASELINE.md config 5), eager.

Counterpart of paddle_tpu/models/deepfm.py: per-slot ids index one flat
first-order table and one flat factor table ([slots * vocab, dim]: slot
s id i is row s * vocab + i), the FM second-order term 0.5 * ((sum v)^2
- sum v^2), and an MLP over the concatenated embeddings and the dense
features; the logit is their sum.

Parameter-server mode (the reference's CTR configs): the two flat tables
live on the parameter server (`paddle_tpu_torch.ps`, tables keyed by
`flat_ids`); a trainer pulls the batch's rows, runs `forward_rows` on
its device with the local `dense_w` and `mlp`, and pushes the rows'
gradients back (chip_smoke phase 39).
"""
import numpy as np
from dataclasses import dataclass

import torch

from paddle_tpu_torch import nn

__all__ = ["DeepFMConfig", "DeepFM"]


@dataclass
class DeepFMConfig:
    num_slots: int = 26
    vocab_per_slot: int = 10000
    dense_dim: int = 13
    embed_dim: int = 16
    mlp_dims: tuple = (400, 400, 400)
    dtype: str = "float32"

    @staticmethod
    def tiny():
        return DeepFMConfig(num_slots=8, vocab_per_slot=100, dense_dim=4,
                            embed_dim=8, mlp_dims=(32, 32))


class DeepFM(nn.Layer):
    def __init__(self, cfg=None, device=None):
        cfg = cfg or DeepFMConfig()
        super().__init__(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        total_vocab = cfg.num_slots * cfg.vocab_per_slot
        self.w1 = nn.Embedding([total_vocab, 1], device=device)
        self.emb = nn.Embedding([total_vocab, cfg.embed_dim], device=device)
        self.dense_w = nn.Linear(cfg.dense_dim, 1, device=device)
        layers = []
        prev = cfg.num_slots * cfg.embed_dim + cfg.dense_dim
        for d in cfg.mlp_dims:
            layers.append(nn.Linear(prev, d, act="relu", device=device))
            prev = d
        layers.append(nn.Linear(prev, 1, device=device))
        self.mlp = nn.Sequential(*layers)

    def _flat_ids(self, sparse_ids):
        cfg = self.cfg
        offsets = torch.arange(cfg.num_slots, device=sparse_ids.device
                               )[None, :] * cfg.vocab_per_slot
        return sparse_ids.long() + offsets

    def flat_ids(self, sparse_ids):
        """[B, num_slots] per-slot ids (numpy) -> the tables' uint64 row
        ids, slot s id i at s * vocab + i (the parameter server's keys)."""
        cfg = self.cfg
        offsets = (np.arange(cfg.num_slots, dtype=np.uint64)
                   * np.uint64(cfg.vocab_per_slot))[None, :]
        return np.asarray(sparse_ids).astype(np.uint64) + offsets

    def forward(self, dense, sparse_ids):
        """dense: [B, dense_dim]; sparse_ids: [B, num_slots] per-slot ids
        -> logit [B, 1]."""
        flat = self._flat_ids(sparse_ids)
        return self.forward_rows(dense, self.w1(flat), self.emb(flat))

    def forward_rows(self, dense, w1_rows, emb_rows):
        """The logit from the batch's table rows, [B, S, 1] and [B, S, D]
        (looked up here, or pulled from the parameter server)."""
        first = w1_rows[..., 0].sum(dim=1, keepdim=True) \
            + self.dense_w(dense)
        v = emb_rows                                           # [B, S, D]
        s = v.sum(dim=1)
        fm = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=1, keepdim=True)
        deep = self.mlp(torch.cat([v.reshape(v.shape[0], -1), dense], dim=1))
        return first + fm + deep

    @staticmethod
    def logit_loss(logit, labels):
        """Mean sigmoid cross-entropy of [B] logits against 0/1 labels."""
        y = labels.float()
        return torch.mean(torch.clamp(logit, min=0) - logit * y
                          + torch.log1p(torch.exp(-logit.abs())))

    def loss(self, dense, sparse_ids, labels):
        """Mean sigmoid cross-entropy of the logits against 0/1 labels."""
        return self.logit_loss(self.forward(dense, sparse_ids)[:, 0], labels)

    def predict_proba(self, dense, sparse_ids):
        return torch.sigmoid(self.forward(dense, sparse_ids)[:, 0])
