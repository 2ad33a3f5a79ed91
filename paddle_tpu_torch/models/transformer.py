"""Transformer NMT (BASELINE.md config 4), eager.

Counterpart of paddle_tpu/models/transformer.py: post-LN encoder and
decoder layers with separate q / k / v / o projections, sinusoid
positions, label-smoothed training loss over the non-padding targets,
greedy decoding and beam search. `TransformerConfig.big()` is the
Transformer-big of Vaswani et al. 2017 (d_model 1024, 16 heads, FFN
4096, 6 + 6 layers) at 30000-word vocabularies.

Attention: `attention_impl="flash"` calls the flash kernels
(`ops/kernels/flash_attention.py`) with sm_scale 1/sqrt(D), the [B, 1,
1, Tk] padding bias on encoder self-attention and cross-attention, and
`causal=True` (top-left aligned, key <= query) on decoder
self-attention; "xla" is the plain einsum path. Any head dim up to 128
runs on the kernels: the wrapper pads one they have no instantiation
for (32, 64, 128) to the next.

Where the port differs from the JAX model:

* `dtype` casts the activations after the embeddings (parameters stay
  float32 and matmuls accumulate in float32), as the port's BERT does:
  "bfloat16" runs the bf16 flash kernels. The JAX model's `dtype`
  reaches no layer, so it computes in float32 whatever it says. A port
  model made float64 (`dtype="float64"`, then `.double()`) computes in
  float64 on the plain path (layer norm, attention and the loss keep
  float64), for step checks across devices.
* Greedy decoding is a Python loop that reads `all(done)` on the host
  once a step (`host_reads` counts the reads and the host's wait in
  them), where the JAX model runs `lax.while_loop` on the device. Ties
  in the argmax go to the lower index, as `jnp.argmax` does.
"""
import math
import time
from dataclasses import dataclass

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention

__all__ = ["TransformerConfig", "sinusoid_position_encoding",
           "MultiHeadAttention", "EncoderLayer", "DecoderLayer",
           "Transformer", "host_reads", "reset_host_reads"]

#: greedy decoding's reads of `all(done)` on the host and the seconds
#: the host waited in them (the device finishing the queued step)
host_reads = {"greedy_decode": 0, "wait_s": 0.0}


def reset_host_reads():
    for k in host_reads:
        host_reads[k] = type(host_reads[k])(0)


@dataclass
class TransformerConfig:
    src_vocab: int = 30000
    trg_vocab: int = 30000
    d_model: int = 512
    num_heads: int = 8
    ffn_dim: int = 2048
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    max_len: int = 256
    dropout: float = 0.1            # unused, as in the JAX model
    dtype: str = "float32"
    attention_impl: str = "xla"     # "xla" | "flash"

    @staticmethod
    def big():
        return TransformerConfig(d_model=1024, num_heads=16, ffn_dim=4096)

    @staticmethod
    def tiny():
        return TransformerConfig(src_vocab=1000, trg_vocab=1000, d_model=64,
                                 num_heads=4, ffn_dim=128,
                                 num_encoder_layers=2, num_decoder_layers=2,
                                 max_len=64)


def sinusoid_position_encoding(max_len, d_model):
    """[max_len, d_model] f32: sin on the even columns, cos on the odd."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    i = torch.arange(d_model // 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0), 2 * i / d_model)
    pe = torch.zeros((max_len, d_model))
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def _check_impl(impl):
    """Every head dim runs on either path: the flash wrapper pads one the
    kernels have no instantiation for (ops/kernels/flash_attention.py)."""
    enforce(impl in ("xla", "flash"), "attention_impl must be 'xla' or "
            "'flash', got %r", impl)


class MultiHeadAttention(nn.Layer):
    def __init__(self, d_model, num_heads, dtype="float32", impl="xla",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self.n = num_heads
        self.d = d_model // num_heads
        _check_impl(impl)
        self.impl = impl
        self.q = nn.Linear(d_model, d_model, device=device)
        self.k = nn.Linear(d_model, d_model, device=device)
        self.v = nn.Linear(d_model, d_model, device=device)
        self.o = nn.Linear(d_model, d_model, device=device)

    def forward(self, q_in, k_in, v_in, mask=None, causal=False):
        """mask: additive key bias [B, 1, 1, Tk] (padding) or None;
        causal masks keys after the query (decoder self-attention)."""
        b, tq, h = q_in.shape
        tk = k_in.shape[1]
        q = self.q(q_in).reshape(b, tq, self.n, self.d)
        k = self.k(k_in).reshape(b, tk, self.n, self.d)
        v = self.v(v_in).reshape(b, tk, self.n, self.d)
        if self.impl == "flash":
            ctx = flash_attention(q, k, v, mask=mask, causal=causal,
                                  sm_scale=1.0 / math.sqrt(self.d))
            return self.o(ctx.reshape(b, tq, h))
        logits = torch.einsum("btnd,bsnd->bnts", at_least_f32(q),
                              at_least_f32(k))
        logits = logits / math.sqrt(self.d)
        if mask is not None:
            logits = logits + mask
        if causal:
            above = 1.0 - torch.tril(torch.ones((tq, tk), device=q.device))
            logits = logits + above[None, None] * -1e9
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        ctx = torch.einsum("bnts,bsnd->btnd", at_least_f32(probs),
                           at_least_f32(v)).to(q.dtype)
        return self.o(ctx.reshape(b, tq, h))


class EncoderLayer(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__(dtype=cfg.dtype, device=device)
        dev = device
        self.attn = MultiHeadAttention(cfg.d_model, cfg.num_heads, cfg.dtype,
                                       cfg.attention_impl, dev)
        self.ln1 = nn.LayerNorm(cfg.d_model, device=dev)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim, act="relu",
                             device=dev)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model, device=dev)
        self.ln2 = nn.LayerNorm(cfg.d_model, device=dev)

    def forward(self, x, mask):
        x = self.ln1(x + self.attn(x, x, x, mask))
        return self.ln2(x + self.fc2(self.fc1(x)))


class DecoderLayer(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__(dtype=cfg.dtype, device=device)
        dev = device
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                            cfg.dtype, cfg.attention_impl,
                                            dev)
        self.ln1 = nn.LayerNorm(cfg.d_model, device=dev)
        self.cross_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                             cfg.dtype, cfg.attention_impl,
                                             dev)
        self.ln2 = nn.LayerNorm(cfg.d_model, device=dev)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim, act="relu",
                             device=dev)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model, device=dev)
        self.ln3 = nn.LayerNorm(cfg.d_model, device=dev)

    def forward(self, x, enc, cross_mask):
        x = self.ln1(x + self.self_attn(x, x, x, None, causal=True))
        x = self.ln2(x + self.cross_attn(x, enc, enc, cross_mask))
        return self.ln3(x + self.fc2(self.fc1(x)))


class Transformer(nn.Layer):
    def __init__(self, cfg=None, device=None):
        cfg = cfg or TransformerConfig()
        _check_impl(cfg.attention_impl)
        super().__init__(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        dev = device
        self.src_emb = nn.Embedding([cfg.src_vocab, cfg.d_model], device=dev)
        self.trg_emb = nn.Embedding([cfg.trg_vocab, cfg.d_model], device=dev)
        self.register_buffer("pe", sinusoid_position_encoding(
            cfg.max_len, cfg.d_model))
        self.encoder = nn.LayerList([EncoderLayer(cfg, dev)
                                     for _ in range(cfg.num_encoder_layers)])
        self.decoder = nn.LayerList([DecoderLayer(cfg, dev)
                                     for _ in range(cfg.num_decoder_layers)])
        self.proj = nn.Linear(cfg.d_model, cfg.trg_vocab, device=dev)

    @staticmethod
    def _pad_mask(lengths, t):
        """[B] lengths -> additive f32 key bias [B, 1, 1, T]."""
        keep = (torch.arange(t, device=lengths.device)[None, :]
                < lengths[:, None])
        return (1.0 - keep[:, None, None, :].float()) * -1e9

    def _embed(self, emb, ids):
        t = ids.shape[1]
        x = emb(ids) * math.sqrt(self.cfg.d_model) + self.pe[:t]
        return x.to(self._dtype)

    def encode(self, src, src_len):
        """-> (encoder output [B, Ts, H], key bias [B, 1, 1, Ts])."""
        x = self._embed(self.src_emb, src)
        mask = self._pad_mask(src_len, src.shape[1])
        for layer in self.encoder:
            x = layer(x, mask)
        return x, mask

    def decode(self, trg_in, enc, cross_mask):
        """-> logits [B, Tt, trg_vocab] in the activation dtype."""
        x = self._embed(self.trg_emb, trg_in)
        for layer in self.decoder:
            x = layer(x, enc, cross_mask)
        return self.proj(x)

    def forward(self, src, src_len, trg_in):
        enc, cross_mask = self.encode(src, src_len)
        return self.decode(trg_in, enc, cross_mask)

    def loss(self, src, src_len, trg_in, trg_out, pad_id=0,
             label_smooth_eps=0.1):
        """Label-smoothed cross-entropy (soft targets (1 - eps) one-hot +
        eps / V) in f32, averaged over the targets that are not pad_id.
        The soft targets are summed in closed form: no [B, T, V] one-hot
        is made."""
        logits = self.forward(src, src_len, trg_in)
        v = logits.shape[-1]
        logp = torch.log_softmax(at_least_f32(logits), dim=-1)
        picked = torch.gather(logp, -1, trg_out.long()[..., None])[..., 0]
        loss = -((1 - label_smooth_eps) * picked
                 + label_smooth_eps / v * logp.sum(dim=-1))
        valid = (trg_out != pad_id).float()
        return (loss * valid).sum() / torch.clamp(valid.sum(), min=1.0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def greedy_decode(self, src, src_len, bos=0, eos=1, max_len=None):
        """Greedy decoding of [B, max_len] int32 ids: every step decodes
        the whole max_len prefix (the JAX model's static shapes) and
        takes the argmax at the step's position; a finished row repeats
        eos. Stops at max_len or once every row has finished (one host
        read a step)."""
        max_len = max_len or self.cfg.max_len
        b = src.shape[0]
        enc, cross_mask = self.encode(src, src_len)
        tokens = torch.full((b, max_len + 1), bos, dtype=torch.int32,
                            device=src.device)
        done = torch.zeros((b,), dtype=torch.bool, device=src.device)
        eos_t = torch.full((b,), eos, dtype=torch.int32, device=src.device)
        i = 0
        while i < max_len and not self._all(done):
            logits = self.decode(tokens[:, :max_len], enc, cross_mask)
            step_tok = torch.argmax(logits[:, i], dim=-1).to(torch.int32)
            step_tok = torch.where(done, eos_t, step_tok)
            tokens[:, i + 1] = step_tok
            done = done | (step_tok == eos)
            i += 1
        return tokens[:, 1:]

    @staticmethod
    def _all(done):
        host_reads["greedy_decode"] += 1
        t0 = time.perf_counter()
        value = bool(done.all())
        host_reads["wait_s"] += time.perf_counter() - t0
        return value

    @torch.no_grad()
    def beam_search_decode(self, src, src_len, bos=0, eos=1, max_len=None,
                           beam_size=4, length_penalty=0.6):
        """Beam search through `ops.beam_search.beam_search`, each step
        decoding the whole [B*K, max_len] prefix (eos past the step, as
        in the JAX model). -> (sequences [B, K, max_len] int32, scores
        [B, K])."""
        from paddle_tpu_torch.ops.beam_search import beam_search, tile_beam

        cfg = self.cfg
        max_len = max_len or cfg.max_len
        b = src.shape[0]
        enc, cross_mask = self.encode(src, src_len)
        enc_t = tile_beam(enc, beam_size)
        mask_t = tile_beam(cross_mask, beam_size)
        pos = [0]

        def step_fn(tokens, state):
            t = pos[0]
            prefix = state["prefix"].clone()
            prefix[:, t] = tokens
            logits = self.decode(prefix, enc_t, mask_t)[:, t]
            pos[0] += 1
            return logits, {"prefix": prefix}

        prefix0 = torch.full((b * beam_size, max_len), eos,
                             dtype=torch.int32, device=src.device)
        return beam_search(step_fn, {"prefix": prefix0}, batch_size=b,
                           beam_size=beam_size, vocab_size=cfg.trg_vocab,
                           bos_id=bos, eos_id=eos, max_len=max_len,
                           length_penalty=length_penalty)
