"""BERT pretraining model.

Counterpart of paddle_tpu/models/bert.py, on the port's eager layers:
post-LN encoder blocks with a fused QKV projection `[H, 3H]`, the MLM
head with its decoder tied to the token embedding, and the NSP head.
Attention runs through `attention_impl`: "xla" is the plain einsum path
(torch matmuls), "flash" the flash-attention kernels
(`ops/kernels/flash_attention.py`) with dropout inside the kernel.

Randomness: where the JAX model folds a key per layer (`fold_in(rngs,
i*3 + j)`), `encode` takes a `torch.Generator` and draws three seeds per
layer from it (`layer_seeds`): the attention kernel's integer seed in
[0, 2**23) and the seeds of the two hidden-dropout generators. The draws
are torch's, not `jax.random`'s.

`remat=True` checkpoints each encoder layer (`torch.utils.checkpoint`,
non-reentrant): its activations are recomputed in the backward. The
recomputed forward draws the same dropout masks, since every mask comes
from the layer's integer seeds (a generator made from a seed on the
plain path, the counter hash in the flash kernels), so the gradients
equal those without remat. `param_shardings` (the TP layout) waits for
the parallel slice.
"""
import math
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels.flash_attention import (
    SEED_LIMIT, flash_attention,
)

__all__ = ["BertConfig", "attention_kernel", "layer_seeds",
           "BertSelfAttention", "BertLayer", "Bert", "synthetic_batch"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    dtype: str = "float32"          # activation dtype ("bfloat16" for perf)
    attention_impl: str = "xla"     # "xla" | "flash"
    remat: bool = False

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=4, intermediate_size=512,
                          max_position=128)


def _device_generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def layer_seeds(generator, num_layers):
    """[(attention seed in [0, 2**23), hidden seed 1, hidden seed 2)] per
    layer, drawn in order from `generator` (a CPU torch.Generator)."""
    out = []
    for _ in range(num_layers):
        attn = int(torch.randint(0, SEED_LIMIT, (1,), generator=generator))
        h1, h2 = (int(x) for x in torch.randint(0, 2 ** 62, (2,),
                                                  generator=generator))
        out.append((attn, h1, h2))
    return out


def attention_kernel(q, k, v, mask, impl="xla", dropout=0.0, rng=None):
    """q, k, v: [B, T, N, D]; mask: [B, 1, 1, T] additive or None; rng:
    the layer's integer attention seed (None: no dropout)."""
    if impl == "flash":
        if dropout > 0.0 and rng is not None:
            # in-kernel dropout: the keep mask is regenerated inside the
            # forward and backward kernels from a counter hash, so no
            # [B, N, T, T] mask reaches device memory
            return flash_attention(q, k, v, mask, dropout_rate=dropout,
                                   dropout_seed=rng)
        return flash_attention(q, k, v, mask)
    enforce(impl == "xla", "attention_impl must be 'xla' or 'flash', got %r",
            impl)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # [B, N, T, T], f32 accumulation of the operands' exact products
    logits = torch.einsum("btnd,bsnd->bnts", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout > 0.0 and rng is not None:
        probs = F.dropout(probs, dropout, _device_generator(rng, q.device))
    return torch.einsum("bnts,bsnd->btnd", probs.float(), v.float()).to(q.dtype)


class BertSelfAttention(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__(dtype=cfg.dtype, device=device)
        h = cfg.hidden_size
        self.cfg = cfg
        self.qkv = nn.Linear(h, 3 * h, device=device)
        self.out = nn.Linear(h, h, device=device)

    def forward(self, x, mask, rng=None):
        cfg = self.cfg
        b, t, h = x.shape
        n, d = cfg.num_heads, h // cfg.num_heads
        # q, k, v are strided views of the fused projection: the flash
        # kernels read them in place
        qkv = self.qkv(x).reshape(b, t, 3, n, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = attention_kernel(q, k, v, mask, cfg.attention_impl,
                               cfg.attention_dropout if self.training else 0.0,
                               rng)
        return self.out(ctx.reshape(b, t, h))


class BertLayer(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__(dtype=cfg.dtype, device=device)
        h = cfg.hidden_size
        self.attn = BertSelfAttention(cfg, device=device)
        self.ln1 = nn.LayerNorm(h, device=device)
        self.fc1 = nn.Linear(h, cfg.intermediate_size, act="gelu",
                             device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, h, device=device)
        self.ln2 = nn.LayerNorm(h, device=device)
        self.dropout = cfg.hidden_dropout

    def forward(self, x, mask, seeds=None):
        # post-LN residual blocks (original BERT)
        r1 = r2 = r3 = None
        if seeds is not None:
            r1, r2, r3 = seeds
        h = self.attn(x, mask, r1)
        if self.training and r2 is not None:
            h = F.dropout(h, self.dropout, _device_generator(r2, x.device))
        x = self.ln1(x + h)
        m = self.fc2(self.fc1(x))
        if self.training and r3 is not None:
            m = F.dropout(m, self.dropout, _device_generator(r3, x.device))
        return self.ln2(x + m)


class Bert(nn.Layer):
    def __init__(self, cfg=None, device=None):
        cfg = cfg or BertConfig()
        super().__init__(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        h = cfg.hidden_size
        # mlm_bias first: the JAX trainable_dict lists a layer's own
        # parameters before its sublayers'
        self.create_parameter("mlm_bias", (cfg.vocab_size,), is_bias=True)
        self.tok_emb = nn.Embedding([cfg.vocab_size, h], device=device)
        self.pos_emb = nn.Embedding([cfg.max_position, h], device=device)
        self.type_emb = nn.Embedding([cfg.type_vocab_size, h], device=device)
        self.emb_ln = nn.LayerNorm(h, device=device)
        self.layers = nn.LayerList([BertLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(h, h, act="tanh", device=device)
        # MLM head: transform + tied decoder (weight = tok_emb.weight)
        self.mlm_dense = nn.Linear(h, h, act="gelu", device=device)
        self.mlm_ln = nn.LayerNorm(h, device=device)
        self.nsp = nn.Linear(h, 2, device=device)

    def encode(self, input_ids, token_type_ids=None, attention_mask=None,
               rngs=None):
        cfg = self.cfg
        b, t = input_ids.shape
        pos = torch.arange(t, device=input_ids.device)[None, :]
        x = self.tok_emb(input_ids) + self.pos_emb(pos)
        if token_type_ids is not None:
            x = x + self.type_emb(token_type_ids)
        x = self.emb_ln(x).to(self._dtype)
        mask = None
        if attention_mask is not None:
            # [B, T] 1/0 → additive [B, 1, 1, T] in f32
            mask = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        seeds = (layer_seeds(rngs, len(self.layers)) if rngs is not None
                 else [None] * len(self.layers))
        for layer, s in zip(self.layers, seeds):
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, mask, s, use_reentrant=False)
            else:
                x = layer(x, mask, s)
        return x

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                rngs=None):
        seq = self.encode(input_ids, token_type_ids, attention_mask, rngs)
        pooled = self.pooler(seq[:, 0])
        return seq, pooled

    def mlm_logits(self, seq):
        h = self.mlm_ln(self.mlm_dense(seq))
        w = self.tok_emb.weight
        # f32 logits from the operands rounded to w's dtype, as the JAX
        # einsum with preferred_element_type=f32
        logits = torch.matmul(h.to(w.dtype).float(), w.float().t())
        return logits + self.mlm_bias

    def pretrain_loss(self, input_ids, token_type_ids, attention_mask,
                      mlm_labels, nsp_labels, rngs=None,
                      max_predictions=None):
        """Masked-LM + next-sentence loss. mlm_labels: -100 = unmasked.
        Hidden states are gathered at up to `max_predictions` masked
        positions per row (default int(0.15 T) + 1) before the vocab
        projection."""
        seq, pooled = self.forward(input_ids, token_type_ids, attention_mask,
                                   rngs)
        t = input_ids.shape[1]
        n_pred = max_predictions or max(1, int(t * 0.15) + 1)
        n_pred = min(n_pred, t)
        is_masked = (mlm_labels >= 0).to(torch.int32)
        # lax.top_k over the 0/1 mask keeps the lowest index on ties; a
        # stable descending sort does the same (torch.topk promises no
        # tie order). Rows with fewer masked tokens pad with weight 0.
        score, pos = torch.sort(is_masked, dim=1, descending=True,
                                stable=True)
        score, pos = score[:, :n_pred], pos[:, :n_pred]
        weights = score.float()
        h = torch.gather(seq, 1, pos[..., None].expand(-1, -1, seq.shape[-1]))
        labels = torch.gather(
            torch.where(mlm_labels >= 0, mlm_labels,
                        torch.zeros_like(mlm_labels)), 1, pos)
        logits = self.mlm_logits(h)                            # [B, P, V]
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        mlm_loss = -(picked * weights).sum() / torch.clamp(weights.sum(),
                                                            min=1.0)
        nsp_logits = self.nsp(pooled)
        nsp_loss = F.softmax_cross_entropy(nsp_logits, nsp_labels).mean()
        return mlm_loss + nsp_loss

    def param_shardings(self, mesh_axes=("dp", "tp")):
        """PartitionSpec-like tuple per parameter for Megatron-style
        tensor parallelism over `tp` (the JAX package's specs): QKV and
        MLP-in column-sharded, out and MLP-out row-sharded, the token
        embedding vocab-sharded, everything else replicated (())."""
        tp = mesh_axes[1] if len(mesh_axes) > 1 else None
        specs = {}
        for name in self.trainable_dict():
            if tp is None:
                specs[name] = ()
            elif "qkv.weight" in name or "fc1.weight" in name:
                specs[name] = (None, tp)
            elif "qkv.bias" in name or "fc1.bias" in name:
                specs[name] = (tp,)
            elif "out.weight" in name or "fc2.weight" in name:
                specs[name] = (tp, None)
            elif "tok_emb.weight" in name:
                specs[name] = (tp, None)
            else:
                specs[name] = ()
        return specs

    def flops_per_token(self):
        """Approximate training FLOPs/token (fwd+bwd ≈ 6*N params matmul
        + attention), as the JAX package counts them."""
        cfg = self.cfg
        h, L, i = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
        per_layer = 2 * h * 3 * h + 2 * h * h + 2 * h * i * 2  # qkv+out+mlp MACs
        emb = 2 * h * cfg.vocab_size  # tied mlm head matmul
        fwd = L * 2 * per_layer + 2 * emb  # *2: MAC→FLOP
        return 3 * fwd  # fwd + 2x bwd


def synthetic_batch(rng, batch, seq, cfg, mask_frac=0.15):
    """Deterministic synthetic pretraining batch."""
    import numpy as np
    r = np.random.RandomState(rng)
    ids = r.randint(10, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    types = np.zeros((batch, seq), np.int32)
    attn = np.ones((batch, seq), np.int32)
    labels = np.full((batch, seq), -100, np.int32)
    nmask = max(1, int(seq * mask_frac))
    for b in range(batch):
        pos = r.choice(seq, nmask, replace=False)
        labels[b, pos] = ids[b, pos]
        ids[b, pos] = 3  # [MASK]
    nsp = r.randint(0, 2, size=(batch,)).astype(np.int32)
    return ids, types, attn, labels, nsp
