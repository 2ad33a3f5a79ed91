"""Autoregressive generation: the KV-cache incremental-decode engines.

Counterpart of paddle_tpu/ops/generation.py, in PyTorch:

* `TinyDecoderLM` is an `nn.Module` (pre-LN GPT block: learned token and
  position embeddings, fused QKV, tanh-GELU MLP at 4x d_model, final
  LayerNorm, untied head). Weights keep the JAX package's `[in, out]`
  layout as plain parameters and compute `x @ w`, so a JAX params pytree
  loads by name (`weights.params_from_jax`) and `init_params(seed)`
  draws the JAX recipe's numbers from the same numpy RandomState.
* `DecodeEngine` keeps per-layer KV caches `[L, B, S, N, Dh]`; decode
  attention runs through kernel K5 (`ops/kernels/decode_attention.py`).
* `PagedDecodeEngine` keeps a batch-free block pool
  `[L, num_blocks, block_size, N, Dh]` with host-side block tables, the
  chain-hash prefix index (`BlockPool`) and a chunk forward that serves
  plain decode (C=1), speculative verify (C=k+1) and prefill
  continuation (C=bucket). Its pool holds float32 KV and attends through
  kernel K6, or int8 / float8 e4m3 payloads with per-row float32 scales
  (`kv_dtype`) and attends through kernel K7. Evicted prefix blocks can
  demote to a host spill tier (`SpillStore`) and come back on a later
  prefix hit; a live slot exports as a CRC'd v2 state document that
  either package imports.

The JAX engines jit one executable per rung and donate their cache
buffers so XLA updates them in place. Here each rung is one captured
CUDA graph (`observability.profile.profiled_graph`, the port's
`jax.jit`) under the JAX ledger keys: `decode[BxS]` and
`prefill[bucket=b]` for `DecodeEngine`, `paged_step[chunk=C]` and
`paged_prefill[bucket=b]` for `PagedDecodeEngine`. An engine owns its
pools: `init_state()` zeroes them and returns them, every rung is bound
to them (a replay with another state raises), and the graphs write them
in place. A rung's host inputs (tokens, slot, lengths, block tables,
masks) are copied into the graph's static buffers before each replay;
no Python value is baked into a graph. `warmup()` captures the whole
ladder (restoring it from the compile cache's manifest when
PT_FLAGS_compile_cache_dir is set), `compile_count()` and
`stats()["compiled_signatures"]` are views over the CompileLedger, and
`observability.profile.disable_capture()` runs the rungs eagerly. On the
CPU the rungs run eagerly and the ledger records their first sights.
The planner's rung geometry (`analysis.planner.estimate_decode_rungs` /
`estimate_paged_rungs`) prices the ladder on request; unlike the
reference's engines, these do not register it for the ledger
cross-check at construction.
"""
import collections
import hashlib
import json
import itertools
import math
import warnings
import zlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import profile as obs_profile
from paddle_tpu_torch.ops.kernels.decode_attention import (
    KERNEL_HEAD_DIMS as DECODE_HEAD_DIMS, NEG_INF, decode_attention,
    paged_decode_attention, quantized_paged_decode_attention,
)
from paddle_tpu_torch.reliability.faults import FaultError, inject_point
from paddle_tpu_torch.weights import kv_to_numpy

__all__ = [
    "LMConfig", "TinyDecoderLM", "DecodeState", "DecodeEngine",
    "BlockPool", "PoolExhausted", "SpillStore", "StateDocError",
    "KVDtypeMismatch", "KV_DTYPES", "STATE_DOC_VERSION",
    "fp8_kv_supported", "kv_torch_dtype", "PagedDecodeState",
    "PagedDecodeEngine", "NgramDraft", "greedy_verify",
    "rejection_verify", "prefix_block_hashes", "greedy_decode", "sample_decode", "generate_reference",
    "prompt_buckets", "select_token",
]

def prompt_buckets(max_len, lo=8):
    """Power-of-two prompt-length ladder up to max_len (one prefill rung
    per entry)."""
    enforce(max_len >= 1, "max_len must be >= 1, got %s", max_len)
    out, b = [], int(lo)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(int(max_len))
    return sorted(set(out))


class LMConfig(NamedTuple):
    """Decoder-only LM hyperparameters (pre-LN GPT block)."""
    vocab_size: int = 64
    d_model: int = 32
    num_heads: int = 4
    num_layers: int = 2
    max_len: int = 128

    @property
    def head_dim(self):
        return self.d_model // self.num_heads


def _ln(x, g, b, eps=1e-5):
    # population variance over the last axis, as the reference's _ln
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _param(*shape, device):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class _Block(nn.Module):
    """One pre-LN transformer block's weights, named as the reference's
    per-layer params dict."""

    def __init__(self, d, device):
        super().__init__()
        self.ln1_g = _param(d, device=device)
        self.ln1_b = _param(d, device=device)
        self.wqkv = _param(d, 3 * d, device=device)
        self.bqkv = _param(3 * d, device=device)
        self.wo = _param(d, d, device=device)
        self.bo = _param(d, device=device)
        self.ln2_g = _param(d, device=device)
        self.ln2_b = _param(d, device=device)
        self.w1 = _param(d, 4 * d, device=device)
        self.b1 = _param(4 * d, device=device)
        self.w2 = _param(4 * d, d, device=device)
        self.b2 = _param(d, device=device)

    def qkv(self, x, shape):
        h = _ln(x, self.ln1_g, self.ln1_b)
        qkv = h @ self.wqkv + self.bqkv
        return (a.reshape(shape) for a in qkv.chunk(3, dim=-1))

    def finish(self, x, att):
        x = x + att @ self.wo + self.bo
        h = _ln(x, self.ln2_g, self.ln2_b)
        return x + _gelu(h @ self.w1 + self.b1) @ self.w2 + self.b2


class TinyDecoderLM(nn.Module):
    """A small but real pre-LN transformer decoder LM. Everything is
    float32; per-row results are independent of the batch dimension (no
    cross-slot ops), which is what makes continuous batching match a
    single-request run."""

    def __init__(self, config=None, device=None):
        super().__init__()
        self.config = config or LMConfig()
        cfg = self.config
        enforce(cfg.d_model % cfg.num_heads == 0,
                "d_model %d must divide by num_heads %d",
                cfg.d_model, cfg.num_heads)
        dev = resolve_device(device)
        d = cfg.d_model
        self.layers = nn.ModuleList(
            [_Block(d, dev) for _ in range(cfg.num_layers)])
        self.tok_emb = _param(cfg.vocab_size, d, device=dev)
        self.pos_emb = _param(cfg.max_len, d, device=dev)
        self.lnf_g = _param(d, device=dev)
        self.lnf_b = _param(d, device=dev)
        self.head = _param(d, cfg.vocab_size, device=dev)

    @torch.no_grad()
    def init_params(self, seed=0):
        """Fill the weights with the reference recipe: normal(0,
        1/sqrt(fan_in)) matrices drawn from np.random.RandomState(seed)
        in the reference's order (per layer wqkv, wo, w1, w2; then
        tok_emb, pos_emb, head), LayerNorm gains 1, biases 0. The same
        seed gives the JAX package's weights. Returns self."""
        rng = np.random.RandomState(seed)

        def fill(p):
            scale = 1.0 / math.sqrt(p.shape[0])
            arr = rng.normal(0.0, scale, tuple(p.shape)).astype(np.float32)
            p.copy_(torch.from_numpy(arr))

        for blk in self.layers:
            for name in ("wqkv", "wo", "w1", "w2"):
                fill(getattr(blk, name))
            for name in ("ln1_g", "ln2_g"):
                getattr(blk, name).fill_(1.0)
            for name in ("ln1_b", "bqkv", "bo", "ln2_b", "b1", "b2"):
                getattr(blk, name).zero_()
        fill(self.tok_emb)
        fill(self.pos_emb)
        fill(self.head)
        self.lnf_g.fill_(1.0)
        self.lnf_b.zero_()
        return self

    def _logits(self, x):
        return _ln(x, self.lnf_g, self.lnf_b) @ self.head

    # -- full (no-cache) forward: prefill + the O(T²) oracle -----------
    @staticmethod
    def _attn_full(q, k, v, lengths):
        """Causal + validity masked attention, plain PyTorch (the
        reference's prefill attention is masked einsum, not a kernel).
        q/k/v: [B, T, N, Dh]."""
        t = q.shape[1]
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.einsum("btnd,bsnd->bnts", q, k) * scale
        rows = torch.arange(t, device=q.device)
        causal = rows[:, None] >= rows[None, :]                 # [T, T]
        valid = rows[None, :] < lengths.to(q.device).long()[:, None]
        mask = causal[None, None] & valid[:, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bnts,bsnd->btnd", p, v)

    @torch.no_grad()
    def forward_full(self, tokens, lengths):
        """Full causal forward: tokens [B, T] → (logits [B, T, V],
        per-layer k/v lists of [B, T, N, Dh]). The k/v lists are what
        prefill writes into the cache."""
        cfg = self.config
        b, t = tokens.shape
        pos = torch.arange(t, device=tokens.device)
        x = self.tok_emb[tokens] + self.pos_emb[pos][None]
        shape = (b, t, cfg.num_heads, cfg.head_dim)
        ks, vs = [], []
        for blk in self.layers:
            q, k, v = blk.qkv(x, shape)
            ks.append(k)
            vs.append(v)
            att = self._attn_full(q, k, v, lengths)
            x = blk.finish(x, att.reshape(b, t, cfg.d_model))
        return self._logits(x), ks, vs

    # -- cached single-step forward ------------------------------------
    @torch.no_grad()
    def forward_step(self, tokens, cache_k, cache_v, lengths, active):
        """One decode step for every slot. tokens [B] are each slot's
        last emitted token; cache_k/cache_v [L, B, S, N, Dh], written in
        place; lengths [B] int32 committed entries (== the new token's
        position). Returns (logits [B, V], lengths' [B] int32).

        Inactive slots still compute but do not advance `lengths`; their
        clamped in-place write lands on a row that the next prefill
        overwrites or masks."""
        cfg = self.config
        b = tokens.shape[0]
        s_len = cache_k.shape[2]
        pos = torch.clamp(lengths, max=s_len - 1)               # [B] i32
        pos_l = pos.long()
        x = self.tok_emb[tokens] + self.pos_emb[pos_l]          # [B, D]
        iota = torch.arange(b, device=tokens.device)
        limits = pos + 1
        shape = (b, cfg.num_heads, cfg.head_dim)
        for li, blk in enumerate(self.layers):
            q, k, v = blk.qkv(x, shape)
            # append this position's k/v into the slot's cache ring
            cache_k[li].index_put_((iota, pos_l), k)
            cache_v[li].index_put_((iota, pos_l), v)
            att = decode_attention(q, cache_k[li], cache_v[li], limits)
            x = blk.finish(x, att.reshape(b, cfg.d_model))
        logits = self._logits(x)                                # [B, V]
        new_lengths = torch.where(
            active, torch.clamp(lengths + 1, max=s_len), lengths)
        return logits, new_lengths.to(torch.int32)

    # -- paged chunk forward -------------------------------------------
    @torch.no_grad()
    def forward_chunk(self, tokens, cache_k, cache_v, tables, lengths,
                      wmask, scale_k=None, scale_v=None):
        """tokens [R, C] at positions lengths[r]+c; scatter each row's
        KV into the block pools [L, NB, bs, N, Dh] (in place) through
        the block tables [R, M] int32 — masked rows go to garbage block
        0 — then chunked paged attention with exact per-row causality.
        With scale arrays [L, NB, bs] the pools are int8 / float8: each
        row is quantized as it is scattered (its scale lands at the same
        [blk, off]) and attention runs through K7; otherwise through K6.
        Returns logits [R, C, V]."""
        cfg = self.config
        r, c = tokens.shape
        bs = cache_k.shape[2]
        m = tables.shape[1]
        pos = (lengths.long()[:, None]
               + torch.arange(c, device=tokens.device)[None, :])  # [R, C]
        pos_c = torch.clamp(pos, max=cfg.max_len - 1)
        blk_idx = torch.clamp(pos // bs, max=m - 1)
        blk = torch.gather(tables.long(), 1, blk_idx)
        blk = torch.where(wmask, blk, torch.zeros_like(blk))  # garbage
        off = pos % bs
        kv_dtype = (None if scale_k is None else
                    "int8" if cache_k.dtype == torch.int8 else "fp8_e4m3")
        x = self.tok_emb[tokens] + self.pos_emb[pos_c]         # [R, C, D]
        shape = (r, c, cfg.num_heads, cfg.head_dim)
        for li, blk_mod in enumerate(self.layers):
            q, k, v = blk_mod.qkv(x, shape)
            if kv_dtype is None:
                cache_k[li].index_put_((blk, off), k)
                cache_v[li].index_put_((blk, off), v)
                att = paged_decode_attention(q, cache_k[li], cache_v[li],
                                             tables, lengths)
            else:
                qk, sk = _kv_quantize_rows(k, kv_dtype)
                qv, sv = _kv_quantize_rows(v, kv_dtype)
                _bytes(cache_k[li]).index_put_((blk, off), _bytes(qk))
                _bytes(cache_v[li]).index_put_((blk, off), _bytes(qv))
                scale_k[li].index_put_((blk, off), sk)
                scale_v[li].index_put_((blk, off), sv)
                att = quantized_paged_decode_attention(
                    q, cache_k[li], cache_v[li], scale_k[li], scale_v[li],
                    tables, lengths)
            x = blk_mod.finish(x, att.reshape(r, c, cfg.d_model))
        return self._logits(x)


class DecodeState(NamedTuple):
    """The decode carry: stacked per-layer cache buffers
    [L, B, S, N, Dh] plus per-slot committed lengths [B] int32, all on
    the engine's device and updated in place."""
    cache_k: torch.Tensor
    cache_v: torch.Tensor
    lengths: torch.Tensor


def select_token(logits, mode="greedy", temperature=1.0, rng=None):
    """Host-side token selection from one [V] logits row. Greedy argmax
    (first-max tie-break) or seeded temperature sampling (float64
    softmax so the sampled distribution is exact)."""
    row = np.asarray(logits, np.float64).reshape(-1)
    if mode == "greedy":
        return int(np.argmax(row))
    enforce(rng is not None, "sample mode needs a seeded RandomState")
    z = row / max(float(temperature), 1e-6)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(row.size, p=p))


def _engine_device(model, device, decode_kernels=False):
    """Resolve the engine's device and move the model there (in place,
    as nn.Module.to does). Float32 matmuls run in full float32. An
    engine that attends through the decode kernels (`decode_kernels`)
    refuses, on the card, a head dim they have no instantiation for: the
    JAX package's K5-K7 take any D, but padding a cache or pool to the
    next width would copy it on every tick (ROADMAP Queue 3)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        enforce(not decode_kernels
                or model.config.head_dim in DECODE_HEAD_DIMS,
                "the decode kernels take head dims %s on the card, got "
                "%d (d_model / num_heads)", DECODE_HEAD_DIMS,
                model.config.head_dim)
        torch.backends.cuda.matmul.allow_tf32 = False
    model.to(dev)
    return dev


def _to_numpy(t):
    return t.detach().cpu().numpy()


class DecodeEngine:
    """KV-cached incremental decode over a fixed slot bank.

    One engine = one (batch_size, max_len) decode rung plus one prefill
    rung per prompt-length bucket, each a captured CUDA graph on the card.
    The host drives it slot-wise: `prefill()` admits a prompt into a free
    slot mid-flight (other slots' rows untouched), `step()` advances every
    slot one token and returns the full logits rows so the caller owns
    token selection and termination."""

    def __init__(self, model, batch_size, max_len, device=None,
                 cache_token=None):
        cfg = model.config
        enforce(max_len <= cfg.max_len,
                "engine max_len %d exceeds the model's positional table "
                "%d", max_len, cfg.max_len)
        enforce(batch_size >= 1, "batch_size must be >= 1")
        self.device = _engine_device(model, device, decode_kernels=True)
        self.model = model
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.buckets = prompt_buckets(max_len)
        self.cache_token = (cache_token if cache_token is not None
                            else self._default_cache_token())
        self.ledger_scope = f"generation@{next(_scope_ids)}"
        self._state = None
        self._step = _rung(self, self._step_body,
                           f"decode[{self.batch_size}x{self.max_len}]",
                           "decode",
                           ("cache_k", "cache_v", "lengths", "tokens",
                            "active"), ())
        self._prefill = _rung(self, self._prefill_body, "prefill",
                              "prefill",
                              ("cache_k", "cache_v", "lengths", "tokens",
                               "length", "slot"), ("bucket",))

    def _default_cache_token(self):
        """Model identity for the compile cache: class, config, the
        parameters' names, shapes and dtypes, and the engine geometry."""
        return _model_token(self.model) + (
            f"/B{self.batch_size}xS{self.max_len}"
            f"/buckets:{','.join(map(str, self.buckets))}")

    def _bound(self):
        st = self._state
        return {"cache_k": st.cache_k, "cache_v": st.cache_v,
                "lengths": st.lengths}

    # -- the rung bodies -----------------------------------------------
    @torch.no_grad()
    def _step_body(self, cache_k, cache_v, lengths, tokens, active):
        logits, new_lengths = self.model.forward_step(
            tokens.long(), cache_k, cache_v, lengths, active)
        lengths.copy_(new_lengths)
        return logits

    @torch.no_grad()
    def _prefill_body(self, cache_k, cache_v, lengths, tokens, length, slot,
                      *, bucket):
        """Prefill one slot: full forward over the [1, bucket]-padded
        prompt, its k/v rows into the slot's cache rows [0, bucket),
        lengths[slot] = length, and the logits row at the last valid
        position, all indexed on the device."""
        length = length.reshape(1)
        slot = slot.reshape(1).long()
        logits, ks, vs = self.model.forward_full(tokens.long(), length)
        rows = torch.arange(bucket, device=tokens.device)
        for li in range(len(ks)):
            cache_k[li].index_put_((slot, rows), ks[li][0])
            cache_v[li].index_put_((slot, rows), vs[li][0])
        lengths.index_copy_(0, slot, length)
        last = torch.clamp(length.long() - 1, min=0)
        return logits[0].index_select(0, last)[0]

    # -- host surface --------------------------------------------------
    def init_state(self):
        """The engine's pools, zeroed: caches [L, B, S, N, Dh] and lengths
        [B]. They are allocated once; every call zeroes the same tensors
        (an engine serves one state at a time)."""
        if self._state is None:
            cfg = self.model.config
            shape = (cfg.num_layers, self.batch_size, self.max_len,
                     cfg.num_heads, cfg.head_dim)
            self._state = DecodeState(
                cache_k=torch.zeros(shape, dtype=torch.float32,
                                    device=self.device),
                cache_v=torch.zeros(shape, dtype=torch.float32,
                                    device=self.device),
                lengths=torch.zeros((self.batch_size,), dtype=torch.int32,
                                    device=self.device))
        else:
            for t in self._state:
                t.zero_()
        return self._state

    def bucket_for(self, prompt_len):
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.buckets[-1]}")

    def compile_count(self):
        """Signatures captured (on the CPU: first run) so far by this
        engine's rungs, a CompileLedger query; rungs warm_start captured
        from a manifest are hits and do not count, nor do eager runs
        under disable_capture() on the card."""
        return _compile_count(self)

    def warm_manifest_name(self):
        """The compile cache's manifest name for this engine's ladder."""
        h = hashlib.sha256(self.cache_token.encode()).hexdigest()[:16]
        return f"generation-{h}"

    def warmup(self):
        """Capture the whole rung ladder off the request path (every
        prefill bucket, then the decode step), first from the compile
        cache's manifest when there is one, then write the manifest.
        The rungs run on the engine's own pools, which are zeroed again
        at the end. Returns {"prefill_buckets", "decode",
        "warm_start"}."""
        pcache, manifest, warm_report = _warm_start(
            self, (self._step, self._prefill))
        state = self.init_state()
        for b in self.buckets:
            prompt = np.zeros((min(b, self.max_len),), np.int32)
            state, _ = self.prefill(state, 0, prompt)
        self.step(state, np.zeros((self.batch_size,), np.int32),
                  np.zeros((self.batch_size,), bool))
        if manifest is not None:
            pcache.write_manifest(manifest, scope=self.ledger_scope)
        self.init_state()
        return {"prefill_buckets": list(self.buckets), "decode": True,
                "warm_start": warm_report}

    def prefill(self, state, slot, prompt):
        """Admit `prompt` (1-D int sequence) into `slot`. Returns
        (state, logits row [V] as np.ndarray). Other slots' cache rows
        and lengths are untouched — the mid-flight refill the continuous
        batcher leans on."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        enforce(prompt.size >= 1, "empty prompt")
        enforce(0 <= slot < self.batch_size,
                "slot %s outside [0, %d)", slot, self.batch_size)
        enforce(prompt.size <= self.max_len,
                "prompt length %d exceeds max_len %d",
                prompt.size, self.max_len)
        bucket = self.bucket_for(prompt.size)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :prompt.size] = prompt
        last = self._prefill(
            state.cache_k, state.cache_v, state.lengths,
            torch.from_numpy(padded),
            torch.tensor(prompt.size, dtype=torch.int32),
            torch.tensor(int(slot), dtype=torch.int32), bucket=bucket)
        return state, _to_numpy(last)

    def step(self, state, tokens, active):
        """One decode tick for all slots. tokens [B] int, active [B]
        bool. Returns (state, logits [B, V] np.ndarray). Each active
        slot's row is the distribution for its next token at position
        lengths[b]."""
        logits = self._step(
            state.cache_k, state.cache_v, state.lengths,
            torch.from_numpy(np.asarray(tokens, np.int32)),
            torch.from_numpy(np.asarray(active, bool)))
        return state, _to_numpy(logits)


#: engine ledger scopes: never reused (an id() can recycle after a dead
#: engine is collected, and its ledger records would count for the new one)
_scope_ids = itertools.count(1)


def _model_token(model):
    """Class, config and the parameters' (name, shape, dtype) hash:
    weight values stay out, as in the JAX package's token."""
    sig = ";".join(f"{k}:{tuple(p.shape)}:{p.dtype}"
                   for k, p in model.named_parameters())
    h = hashlib.sha256(sig.encode()).hexdigest()[:16]
    return f"{type(model).__qualname__}:{model.config}/params:{h}"


def _rung(engine, body, name, kind, arg_names, static_argnames):
    """A rung of `engine`: a profiled_graph in the "generation" component,
    scoped to the engine, bound to its pools, counted into
    pt_generation_compiles_total{kind} on each capture."""
    counter = obs_metrics.registry().counter(
        "pt_generation_compiles_total",
        "decode-engine executable signatures compiled",
        labels=("kind",)).labels(kind=kind)
    return obs_profile.profiled_graph(
        body, component="generation", name=name,
        static_argnames=static_argnames, scope=engine.ledger_scope,
        on_compile=lambda rec: counter.inc(), arg_names=arg_names,
        cache_token=f"{engine.cache_token}/{name.split('[')[0]}",
        bound=engine._bound, device=engine.device)


def _compile_count(engine):
    kind = "graph" if engine.device.type == "cuda" else "eager"
    return len(obs_profile.compile_ledger().compile_events(
        component="generation", scope=engine.ledger_scope, kind=kind))


def _warm_start(engine, rungs):
    """(cache, manifest name, warm_start report) for an engine's warmup:
    the rungs its manifest lists captured before traffic (None, None,
    None without PT_FLAGS_compile_cache_dir)."""
    from paddle_tpu_torch.core import compile_cache as _cc
    pcache = _cc.compile_cache()
    if pcache is None:
        return None, None, None
    manifest = engine.warm_manifest_name()
    engine.init_state()
    return pcache, manifest, pcache.warm_start(manifest, rungs)


# ---------------------------------------------------------------------------
# single-request loops + the no-cache oracle
# ---------------------------------------------------------------------------

def _decode_loop(model, prompt, max_new_tokens, stop_token, max_len, pick,
                 device):
    engine = DecodeEngine(model, batch_size=1,
                          max_len=max_len or model.config.max_len,
                          device=device)
    state = engine.init_state()
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    budget = min(int(max_new_tokens), engine.max_len - prompt.size)
    enforce(budget >= 1,
            "no room to generate: prompt %d + 1 > max_len %d",
            prompt.size, engine.max_len)
    state, logits = engine.prefill(state, 0, prompt)
    out = []
    tok = pick(logits)
    for _ in range(budget):
        out.append(tok)
        if stop_token is not None and tok == stop_token:
            break
        if len(out) >= budget:
            break
        state, logits = engine.step(
            state, np.asarray([tok]), np.asarray([True]))
        tok = pick(logits[0])
    return np.asarray(out, np.int32)


def greedy_decode(model, prompt, max_new_tokens, stop_token=None,
                  max_len=None, device=None, on_logits=None):
    """KV-cached greedy decode of ONE prompt: returns the generated
    tokens (stop token included when hit). Termination: stop_token or
    max_new_tokens (clamped so prompt + generation fits max_len).
    `on_logits(row)`, when given, sees every logits row before its token
    is picked."""
    def pick(lg):
        if on_logits is not None:
            on_logits(lg)
        return select_token(lg, "greedy")
    return _decode_loop(model, prompt, max_new_tokens, stop_token,
                        max_len, pick, device)


def sample_decode(model, prompt, max_new_tokens, stop_token=None,
                  max_len=None, temperature=1.0, seed=0, device=None):
    """KV-cached temperature sampling of ONE prompt, deterministic for a
    given seed (host-side float64 softmax + seeded RandomState)."""
    rng = np.random.RandomState(seed)
    return _decode_loop(
        model, prompt, max_new_tokens, stop_token, max_len,
        lambda lg: select_token(lg, "sample", temperature=temperature,
                                rng=rng), device)


def generate_reference(model, prompt, max_new_tokens, stop_token=None,
                       device=None):
    """The O(T²) no-cache oracle: re-run the FULL forward over the whole
    sequence every step and take the last position's argmax."""
    dev = _engine_device(model, device)
    seq = list(np.asarray(prompt, np.int32).reshape(-1))
    out = []
    budget = min(int(max_new_tokens), model.config.max_len - len(seq))
    for _ in range(budget):
        tokens = torch.tensor([seq], dtype=torch.long, device=dev)
        logits, _, _ = model.forward_full(
            tokens, torch.tensor([len(seq)], device=dev))
        tok = select_token(_to_numpy(logits[0, len(seq) - 1]))
        out.append(tok)
        seq.append(tok)
        if stop_token is not None and tok == stop_token:
            break
    return np.asarray(out, np.int32)


# ---------------------------------------------------------------------------
# Paged KV cache: block pool, prefix index, and the paged decode engine
#
# The paged engine keeps per-layer KV in a batch-free BLOCK POOL
# `[L, num_blocks, block_size, N, Dh]` and gives each slot an ordered
# BLOCK TABLE mapping its logical positions [j*bs, (j+1)*bs) onto pool
# blocks. Full prompt blocks are published into a chain-hash prefix
# index, so a later admission with the same prefix refs them instead of
# recomputing (prefill runs only over the unshared tail). Shared blocks
# are never written: decode writes start at the prompt's end, outside
# every published (complete) block. Rejected speculative proposals need
# no rollback: their KV sits beyond the committed `lengths`, is masked
# out of every later attention, and is overwritten by the next chunk.
#
# Pool block 0 is a reserved GARBAGE block: masked rows (inactive slots,
# bucket padding) scatter there and nothing ever reads it back.
# ---------------------------------------------------------------------------


class PoolExhausted(RuntimeError):
    """No free or evictable block satisfies an allocation — admission
    should PARK the request (leave it queued) until retirement returns
    blocks, never crash."""


class StateDocError(ValueError):
    """An export_state document failed validation (CRC tamper, version
    skew, geometry mismatch) — refused outright, never misread."""


class KVDtypeMismatch(StateDocError):
    """The document's KV payload dtype does not match the importing
    engine's pool dtype. Payload bytes mean something only with their
    scales under the dtype that produced them, so the caller must route
    the document to a same-dtype engine or re-prefill from tokens."""


# -- quantized KV block storage ---------------------------------------------
#
# The pool's payload dtype is chosen per engine: "f32", "int8" or
# "fp8_e4m3" (torch.float8_e4m3fn, probed once; a torch without it falls
# back to int8 and says so). Quantized pools carry a per-row float32 scale
# array [L, NB, bs] per side, set to absmax(row)/qmax when the row is
# scattered. A row's scale is a function of that row alone, so a block's
# payload and scales move (spill demote/promote, export/import) without
# ever being re-quantized.

KV_DTYPES = ("f32", "int8", "fp8_e4m3")

#: dequant multiplier bound per dtype: scale = absmax / qmax, payload
#: = value / scale (int8: rounded and clipped; e4m3: clipped and cast,
#: finite max 448)
_KV_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}

_FP8_PROBE = [None]


def fp8_kv_supported():
    """Probe (once) whether this torch round-trips float8_e4m3fn through
    a cast — the capability gate for the fp8 KV pool."""
    if _FP8_PROBE[0] is None:
        try:
            x = torch.tensor([0.5, -448.0])
            back = x.to(torch.float8_e4m3fn).to(torch.float32)
            _FP8_PROBE[0] = bool(torch.equal(back, x))
        except (AttributeError, RuntimeError, TypeError):
            _FP8_PROBE[0] = False
    return _FP8_PROBE[0]


def kv_torch_dtype(kv_dtype):
    """The pool tensor dtype of a KV_DTYPES name."""
    return {"f32": torch.float32, "int8": torch.int8,
            "fp8_e4m3": torch.float8_e4m3fn}[kv_dtype]


def _kv_quantize_rows(x, kv_dtype):
    """Quantize a batch of KV rows: x [..., N, Dh] float32 → (payload
    [..., N, Dh] in kv_dtype, scale [...] float32) with scale =
    absmax(row)/qmax; dequant is payload * scale. An all-zero row gets
    scale 0 and payload 0. The JAX order, to the bit: scale = amax /
    qmax, safe = max(scale, 1e-30), x / safe, then round (half to even)
    and clip for int8, clip then cast for e4m3."""
    qmax = _KV_QMAX[kv_dtype]
    amax = torch.amax(torch.abs(x), dim=(-2, -1))
    scale = amax / qmax
    safe = torch.clamp(scale, min=1e-30)[..., None, None]
    if kv_dtype == "int8":
        q = torch.clamp(torch.round(x / safe), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(x / safe, -qmax, qmax).to(torch.float8_e4m3fn)
    return q, scale


def prefix_block_hashes(tokens, block_size):
    """Chain hashes of the FULL blocks of a token sequence: h_j =
    blake2b(h_{j-1} || tokens[j*bs:(j+1)*bs]). A hash identifies both a
    block's contents AND everything before it."""
    arr = np.asarray(tokens, np.int32).reshape(-1)
    bs = int(block_size)
    out = []
    h = b""
    for j in range(arr.size // bs):
        h = hashlib.blake2b(h + arr[j * bs:(j + 1) * bs].tobytes(),
                            digest_size=16).digest()
        out.append(h)
    return out


class BlockPool:
    """Host-side accounting for the KV block pool.

    A block is FREE (on the free stack), LIVE (refcount >= 1) or CACHED
    (refcount 0 but resident and indexed by its prefix chain hash —
    evictable in LRU order). Block 0 is the reserved garbage block and is
    never handed out. `free + cached + live == num_blocks - 1` holds
    across any alloc/ref/release sequence."""

    def __init__(self, num_blocks, block_size):
        enforce(num_blocks >= 2,
                "pool needs >= 2 blocks (block 0 is reserved), got %s",
                num_blocks)
        enforce(block_size >= 1, "block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}            # id -> refcount >= 1        (LIVE)
        self._cached = {}         # hash -> id, insertion = LRU (CACHED)
        self._index = {}          # hash -> id (LIVE or CACHED, indexed)
        self._hash_of = {}        # id -> hash for indexed blocks
        self.evictions = 0
        self.prefix_hits = 0      # blocks handed out via lookup()

    def free_count(self):
        return len(self._free)

    def cached_count(self):
        return len(self._cached)

    def live_count(self):
        return len(self._ref)

    def available(self):
        """Blocks an allocation could obtain: free + evictable."""
        return len(self._free) + len(self._cached)

    def stats(self):
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free": self.free_count(), "cached": self.cached_count(),
                "live": self.live_count(), "evictions": self.evictions,
                "prefix_hits": self.prefix_hits}

    def _unindex(self, block_id):
        h = self._hash_of.pop(block_id, None)
        if h is not None:
            self._index.pop(h, None)
            self._cached.pop(h, None)

    def alloc(self, n, demote_cb=None):
        """Take n blocks (refcount 1 each): the free stack first, then
        CACHED blocks oldest-first. Raises PoolExhausted — atomically,
        nothing is taken — when fewer than n blocks are obtainable.
        `demote_cb(block_id, hash)` fires for each CACHED eviction before
        the block is unindexed and handed out: the spill tier's last
        chance to copy the payload off the device."""
        n = int(n)
        if n == 0:
            return []
        if self.available() < n:
            raise PoolExhausted(
                f"need {n} blocks, only {self.available()} obtainable "
                f"(free {len(self._free)}, cached {len(self._cached)})")
        out = []
        for _ in range(n):
            if self._free:
                bid = self._free.pop()
            else:
                h, bid = next(iter(self._cached.items()))   # LRU-oldest
                if demote_cb is not None:
                    demote_cb(bid, h)
                self._unindex(bid)
                self.evictions += 1
            self._ref[bid] = 1
            out.append(bid)
        return out

    def ref(self, ids):
        """Take shared references on resident blocks (a prefix hit).
        CACHED blocks revive to LIVE; their index entry stays."""
        for bid in ids:
            if bid in self._ref:
                self._ref[bid] += 1
            else:
                h = self._hash_of.get(bid)
                enforce(h is not None and h in self._cached,
                        "ref() on block %s which is neither live nor "
                        "cached", bid)
                del self._cached[h]
                self._ref[bid] = 1
            self.prefix_hits += 1

    def acquire(self, shared, n_own, demote_cb=None):
        """Ref `shared` (a lookup() result) and alloc `n_own` fresh
        blocks, atomically. The shared prefix is pinned FIRST, so
        alloc()'s LRU eviction cannot hand a shared block back as an
        own block. On PoolExhausted nothing is taken."""
        shared = list(shared)
        self.ref(shared)
        try:
            return self.alloc(n_own, demote_cb=demote_cb)
        except PoolExhausted:
            self.release(shared)
            self.prefix_hits -= len(shared)
            raise

    def release(self, ids):
        """Drop one reference per id. A block reaching refcount 0
        becomes CACHED if indexed, else returns to the free stack."""
        for bid in ids:
            count = self._ref.get(bid)
            enforce(count is not None and count >= 1,
                    "release() on unowned block %s", bid)
            if count > 1:
                self._ref[bid] = count - 1
                continue
            del self._ref[bid]
            h = self._hash_of.get(bid)
            if h is not None:
                self._cached[h] = bid        # most-recently released
            else:
                self._free.append(bid)

    def publish(self, ids, hashes):
        """Index complete prompt blocks by their chain hash. A hash
        already indexed keeps its first block."""
        for bid, h in zip(ids, hashes):
            if h in self._index:
                continue
            self._index[h] = bid
            self._hash_of[bid] = h

    def lookup(self, hashes):
        """Longest indexed prefix of the hash chain → resident block ids
        (the caller refs them). Stops at the first miss."""
        out = []
        for h in hashes:
            bid = self._index.get(h)
            if bid is None:
                break
            out.append(bid)
        return out

    def evict_cached(self, n=None, demote_cb=None):
        """Evict up to `n` CACHED blocks (all when None) back to the free
        stack, oldest-first — the degradation ladder's evict-to-spill
        rung. `demote_cb(block_id, hash)` fires per block before
        unindexing, as in alloc(). Returns the number evicted."""
        count = 0
        for h in list(self._cached):
            if n is not None and count >= n:
                break
            bid = self._cached[h]
            if demote_cb is not None:
                demote_cb(bid, h)
            self._unindex(bid)
            self._free.append(bid)
            count += 1
        return count

    def drop_cached(self):
        """Evict every CACHED block back to the free stack."""
        return self.evict_cached()


class SpillStore:
    """Bounded host-RAM spill tier for evicted CACHED KV blocks.

    Keyed by the prefix chain hashes of the pool's device index, so an
    entry identifies the block's contents AND everything before it.
    Entries age FIFO by demotion order; past `capacity` the oldest is
    dropped (counted: a lost reuse chance, never a correctness event).
    `get()` POPS on a hit: the payload is about to be restored into a
    LIVE device block that the pool re-publishes under the same hash.
    Payloads are host numpy arrays (float8 bytes as uint8). Counters
    surface as `pt_generation_spill_{demoted,promoted,dropped}_total`."""

    def __init__(self, capacity):
        enforce(capacity >= 1, "spill capacity must be >= 1, got %s",
                capacity)
        self.capacity = int(capacity)
        # hash -> (k, v, k_scale, v_scale) host numpy; scales None for f32
        self._store = collections.OrderedDict()
        self.demoted = 0
        self.promoted = 0
        self.dropped = 0
        reg = obs_metrics.registry()
        self._m_demoted = reg.counter(
            "pt_generation_spill_demoted_total",
            "KV blocks demoted from the device pool to the host spill "
            "tier")
        self._m_promoted = reg.counter(
            "pt_generation_spill_promoted_total",
            "spill-tier KV blocks promoted back on a prefix hit")
        self._m_dropped = reg.counter(
            "pt_generation_spill_dropped_total",
            "spill-tier KV blocks dropped by the capacity bound")

    def __len__(self):
        return len(self._store)

    def __contains__(self, h):
        return h in self._store

    def put(self, h, k, v, k_scale=None, v_scale=None):
        """Demote one block's KV payload ([L, block_size, N, Dh] each,
        any pool dtype) under its chain hash; quantized pools pass the
        block's per-row scale strips ([L, block_size] float32) with it —
        payload bytes without their scales mean nothing. Re-demoting a
        resident hash refreshes its age without recounting."""
        inject_point("generation.spill_write", tag=h)
        if h in self._store:
            self._store.move_to_end(h)
            self._store[h] = (k, v, k_scale, v_scale)
            return
        self._store[h] = (k, v, k_scale, v_scale)
        self.demoted += 1
        self._m_demoted.inc()
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)        # FIFO-oldest
            self.dropped += 1
            self._m_dropped.inc()

    def get(self, h):
        """Pop the payload for `h` — (k, v, k_scale, v_scale) on a hit
        (scales None for f32 pools), None on a miss."""
        hit = self._store.pop(h, None)
        if hit is None:
            return None
        inject_point("generation.spill_read", tag=h)
        self.promoted += 1
        self._m_promoted.inc()
        return hit

    def stats(self):
        return {"capacity": self.capacity, "resident": len(self._store),
                "demoted": self.demoted, "promoted": self.promoted,
                "dropped": self.dropped}


#: export_state document version. v2 carries an explicit kv_dtype and
#: per-entry scale strips, and hashes payload bytes under their native
#: dtype; the JAX package writes and reads the same version.
STATE_DOC_VERSION = 2

#: the CRC's dtype tag of an e4m3 payload: the JAX package hashes its
#: ml_dtypes arrays under this name, and the port, whose host copies are
#: the same bytes as uint8, hashes them under it too
_FP8_TAG = "float8_e4m3fn"


def _payload_tag(arr, kv_dtype):
    tag = str(arr.dtype)
    if kv_dtype == "fp8_e4m3" and tag == "uint8":
        return _FP8_TAG
    return tag


def _state_doc_crc(doc):
    """CRC32 of an export_state document's canonical bytes: the JSON of
    its metadata (sorted keys, kv_dtype included) chained with every KV
    payload's dtype tag and raw C-order bytes — equal to the JAX
    package's CRC of the same document."""
    kv_dtype = doc.get("kv_dtype", "f32")
    meta = {"version": doc["version"], "block_size": doc["block_size"],
            "kv_dtype": kv_dtype,
            "tokens": [int(t) for t in doc["tokens"]],
            "length": int(doc["length"]),
            "block_hashes": list(doc["block_hashes"]),
            "kv_hashes": [e["hash"] for e in doc.get("kv", ())]}
    crc = zlib.crc32(json.dumps(meta, sort_keys=True).encode("utf-8"))
    for e in doc.get("kv", ()):
        for key in ("k", "v", "k_scale", "v_scale"):
            if key not in e:
                continue
            arr = np.ascontiguousarray(np.asarray(e[key]))
            tag = (_payload_tag(arr, kv_dtype) if key in ("k", "v")
                   else str(arr.dtype))
            crc = zlib.crc32(tag.encode("utf-8"), crc)
            crc = zlib.crc32(arr.tobytes(), crc)
    return crc & 0xFFFFFFFF


def _bytes(t):
    """t, or its uint8 view when it holds float8: indexing and scatter
    are not implemented for float8 tensors everywhere, so the pools are
    moved as bytes and only the quantizing cast uses the float8 dtype."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


class PagedDecodeState(NamedTuple):
    """The paged carry: per-layer block pools
    [L, num_blocks, block_size, N, Dh] (float32, or the engine's int8 /
    float8 payload dtype) plus, for quantized pools, the per-row dequant
    scales [L, num_blocks, block_size] float32 (None for float32 pools),
    all updated in place. Tables, lengths and the pool accounting live
    host-side on the engine."""
    cache_k: torch.Tensor
    cache_v: torch.Tensor
    scale_k: torch.Tensor = None
    scale_v: torch.Tensor = None


class PagedDecodeEngine:
    """Block-table paged KV decode engine with a unified chunk forward.

    `[R, C]` token rows scatter their KV through the slot block tables
    (masked rows land in garbage block 0) and attend with per-row limits
    lengths[r]+c+1: through kernel K6 over a float32 pool, or through K7
    over an int8 / float8 e4m3 pool (`kv_dtype`) with per-row scales. The
    rungs are prefill (R=1, C=bucket: a prompt, or the unshared tail
    after a prefix hit), plain decode (R=B, C=1) and speculative verify
    (R=B, C=k+1).

    Host-side the engine owns the BlockPool, the per-slot tables [B, M],
    committed lengths [B] and, with `spill_blocks`, the host SpillStore;
    the device state is the two pools (and their scale arrays)."""

    def __init__(self, model, batch_size, max_len, block_size=8,
                 num_blocks=None, spec_k=4, spill_blocks=None,
                 kv_dtype="f32", device=None, cache_token=None):
        cfg = model.config
        enforce(max_len <= cfg.max_len,
                "engine max_len %d exceeds the model's positional table "
                "%d", max_len, cfg.max_len)
        enforce(batch_size >= 1, "batch_size must be >= 1")
        enforce(max_len % block_size == 0,
                "max_len %d must be a multiple of block_size %d",
                max_len, block_size)
        enforce(spec_k >= 0, "spec_k must be >= 0")
        enforce(kv_dtype in KV_DTYPES,
                "kv_dtype must be one of %s, got %r", KV_DTYPES, kv_dtype)
        self.device = _engine_device(model, device, decode_kernels=True)
        self.model = model
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.blocks_per_slot = self.max_len // self.block_size
        self.spec_k = int(spec_k)
        self.kv_dtype_requested = kv_dtype
        if kv_dtype == "fp8_e4m3" and not fp8_kv_supported():
            # the next rung down, loudly
            warnings.warn("fp8_e4m3 KV storage unsupported by this torch; "
                          "falling back to int8", RuntimeWarning)
            kv_dtype = "int8"
        self.kv_dtype = kv_dtype
        self._kv_quantized = kv_dtype != "f32"
        if num_blocks is None:
            # every slot fully allocated, plus the garbage block
            num_blocks = self.batch_size * self.blocks_per_slot + 1
        enforce(num_blocks >= self.blocks_per_slot + 1,
                "pool of %s blocks cannot hold one full slot (%s)",
                num_blocks, self.blocks_per_slot)
        self.num_blocks = int(num_blocks)
        self.buckets = prompt_buckets(max_len)
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.spill = SpillStore(spill_blocks) if spill_blocks else None
        self.tables = np.zeros((self.batch_size, self.blocks_per_slot),
                               np.int32)
        self.lengths = np.zeros((self.batch_size,), np.int32)
        self._slot_blocks = {}      # slot -> [block ids] (incl. shared)
        self._slot_capacity = {}    # slot -> allocated positions
        reg = obs_metrics.registry()
        reg.gauge("pt_quant_kv_pool_bytes",
                  "KV block-pool device bytes (payload + scale arrays)",
                  labels=("dtype",)).labels(dtype=self.kv_dtype).set(
                      self.kv_pool_bytes())
        if self.kv_dtype != self.kv_dtype_requested:
            reg.counter("pt_quant_kv_dtype_fallback_total",
                        "engines whose requested KV dtype was unsupported "
                        "and fell back a rung",
                        labels=("requested", "effective")).labels(
                            requested=self.kv_dtype_requested,
                            effective=self.kv_dtype).inc()
        self.cache_token = (cache_token if cache_token is not None
                            else self._default_cache_token())
        self.ledger_scope = f"generation-paged@{next(_scope_ids)}"
        self._state = None
        names = ("cache_k", "cache_v", "scale_k", "scale_v", "tokens",
                 "tables", "lengths", "wmask")
        self._step_fn = _rung(self, self._chunk_body, "paged_step",
                              "paged_step", names, ("chunk",))
        self._prefill_fn = _rung(self, self._chunk_body, "paged_prefill",
                                 "paged_prefill", names, ("bucket",))

    def _default_cache_token(self):
        return _model_token(self.model) + (
            f"/paged:B{self.batch_size}xS{self.max_len}"
            f"/bs{self.block_size}xNB{self.num_blocks}/kv:{self.kv_dtype}"
            f"/buckets:{','.join(map(str, self.buckets))}")

    def _bound(self):
        st = self._state
        return {"cache_k": st.cache_k, "cache_v": st.cache_v,
                "scale_k": st.scale_k, "scale_v": st.scale_v}

    @torch.no_grad()
    def _chunk_body(self, cache_k, cache_v, scale_k, scale_v, tokens,
                    tables, lengths, wmask, *, chunk=None, bucket=None):
        """The one body of every paged rung (the static argument is the
        ledger key; the shapes carry it)."""
        return self.model.forward_chunk(tokens.long(), cache_k, cache_v,
                                        tables, lengths, wmask,
                                        scale_k=scale_k, scale_v=scale_v)

    def kv_pool_bytes(self):
        """Device bytes of one init_state() KV carry: the payload pools
        (k + v, in the pool dtype) plus, quantized, the float32 scale
        arrays."""
        cfg = self.model.config
        rows = cfg.num_layers * self.num_blocks * self.block_size
        itemsize = 1 if self._kv_quantized else 4
        payload = 2 * rows * cfg.num_heads * cfg.head_dim * itemsize
        scales = 2 * rows * 4 if self._kv_quantized else 0
        return payload + scales

    def _chunk(self, state, tokens, tables, lengths, wmask, **static):
        """Run a rung on host arrays: `chunk=C` (the decode and verify
        ticks) or `bucket=b` (a prefill). The arrays are copied to the
        rung's device buffers, then the rung runs; returns logits
        [R, C, V] (the pools are written in place)."""
        fn = self._prefill_fn if "bucket" in static else self._step_fn
        return fn(state.cache_k, state.cache_v, state.scale_k,
                  state.scale_v,
                  torch.from_numpy(np.asarray(tokens, np.int32)),
                  torch.from_numpy(np.ascontiguousarray(tables, np.int32)),
                  torch.from_numpy(np.asarray(lengths, np.int32)),
                  torch.from_numpy(np.asarray(wmask, bool)), **static)

    def init_state(self):
        """Zeroed device pools AND fresh host accounting (pool, tables,
        lengths) — a paged state and its block bookkeeping are one unit.
        The pools are allocated once; every call zeroes the same
        tensors, which every rung is bound to."""
        cfg = self.model.config
        shape = (cfg.num_layers, self.num_blocks, self.block_size,
                 cfg.num_heads, cfg.head_dim)
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.tables[:] = 0
        self.lengths[:] = 0
        self._slot_blocks.clear()
        self._slot_capacity.clear()
        if self._state is not None:
            for t in self._state:
                if t is not None:
                    _bytes(t).zero_()    # float8 zeros as zero bytes
            return self._state
        dt = kv_torch_dtype(self.kv_dtype)

        def pool():
            # float8 zeros as zero bytes (+0.0 in e4m3)
            raw = torch.zeros(shape, device=self.device,
                              dtype=torch.uint8 if dt.itemsize == 1 else dt)
            return raw.view(dt)

        if not self._kv_quantized:
            self._state = PagedDecodeState(cache_k=pool(), cache_v=pool())
            return self._state
        sshape = shape[:3]              # [L, NB, bs] per-row scales
        self._state = PagedDecodeState(
            cache_k=pool(), cache_v=pool(),
            scale_k=torch.zeros(sshape, dtype=torch.float32,
                                device=self.device),
            scale_v=torch.zeros(sshape, dtype=torch.float32,
                                device=self.device))
        return self._state

    def bucket_for(self, prompt_len):
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.buckets[-1]}")

    def slot_capacity(self, slot):
        return self._slot_capacity.get(slot, 0)

    def admit(self, state, slot, prompt, total_len, prefix_reuse=True):
        """Admit `prompt` into `slot` with `total_len` positions (prompt +
        generation budget) allocated up front, so a live slot cannot hit
        pool exhaustion. Raises PoolExhausted (atomically — nothing
        taken) when the pool cannot cover the unshared blocks.

        With `prefix_reuse`, prompt chain hashes are matched against the
        prefix index; hit blocks are reffed (never recomputed) and
        prefill runs only over the unshared tail — at least one token,
        so the admission always has a logits row to emit from. With a
        spill tier the chain is probed past the device index: spilled
        payloads (with their scales) are restored into own blocks and
        re-published, so a spill hit re-prefills nothing either. Returns
        (state, last-logits-row [V], {"shared_blocks", "spill_blocks",
        "shared_tokens", "tail_bucket"})."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        enforce(prompt.size >= 1, "empty prompt")
        enforce(0 <= slot < self.batch_size,
                "slot %s outside [0, %d)", slot, self.batch_size)
        enforce(slot not in self._slot_blocks,
                "slot %s already admitted", slot)
        total_len = int(total_len)
        enforce(prompt.size <= total_len <= self.max_len,
                "total_len %s outside [prompt %s, max_len %s]",
                total_len, prompt.size, self.max_len)
        hashes = prefix_block_hashes(prompt, self.block_size)
        shared, spill_want = [], []
        if prefix_reuse and hashes:
            # keep >= 1 tail token to prefill (the emission row)
            max_shared = (prompt.size - 1) // self.block_size
            shared = self.pool.lookup(hashes)[:max_shared]
            if self.spill is not None:
                # peek only: payloads are popped after the allocation
                # commits, so PoolExhausted parks without losing entries
                for j in range(len(shared), max_shared):
                    if hashes[j] not in self.spill:
                        break
                    spill_want.append(hashes[j])
        n_total = -(-total_len // self.block_size)
        # lock-ok: BlockPool.acquire allocates KV blocks, not a lock
        own = self.pool.acquire(shared, n_total - len(shared),  # lock-ok
                                demote_cb=self._demote_cb(state))
        promoted = []
        for h in spill_want:
            try:
                hit = self.spill.get(h)
            except FaultError:
                hit = None    # an injected read fault: prefill the rest
            if hit is None:
                break
            promoted.append(hit)
        if promoted:
            self._restore(state, own[:len(promoted)], promoted)
        ids = shared + own
        self._slot_blocks[slot] = ids
        self._slot_capacity[slot] = n_total * self.block_size
        self.tables[slot, :] = 0
        self.tables[slot, :len(ids)] = ids
        shared_tokens = (len(shared) + len(promoted)) * self.block_size
        tail = prompt[shared_tokens:]
        bucket = self.bucket_for(tail.size)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :tail.size] = tail
        wmask = np.zeros((1, bucket), bool)
        wmask[0, :tail.size] = True
        logits = self._chunk(state, tokens, self.tables[slot:slot + 1],
                             [shared_tokens], wmask, bucket=bucket)
        self.lengths[slot] = prompt.size
        # publish the COMPLETE prompt blocks (decode writes start at
        # prompt.size, outside every one of them); restored blocks
        # re-enter the device index under their original hashes
        n_pub = prompt.size // self.block_size
        self.pool.publish(ids[:n_pub], hashes[:n_pub])
        last = _to_numpy(logits[0, tail.size - 1])
        return (state, last,
                {"shared_blocks": len(shared),
                 "spill_blocks": len(promoted),
                 "shared_tokens": shared_tokens,
                 "tail_bucket": bucket})

    def step(self, state, tokens, active):
        """Plain decode tick (chunk=1): scatter each active slot's token
        at its length and return the next-token logits [B, V]. Advances
        committed lengths for active slots."""
        active = np.asarray(active, bool)
        logits = self._chunk(state, np.asarray(tokens)[:, None],
                             self.tables, self.lengths, active[:, None],
                             chunk=1)
        self.lengths = np.where(active, self.lengths + 1,
                                self.lengths).astype(np.int32)
        return state, _to_numpy(logits[:, 0])

    def verify(self, state, tokens, counts):
        """Speculative verify (chunk=C): row (b, 0) carries slot b's last
        emitted token, rows 1..counts[b]-1 its draft proposals. Returns
        the full [B, C, V] logits — row j is the distribution AFTER
        consuming rows 0..j. Does NOT advance lengths: call
        `advance(slot, accepted+1)` after acceptance."""
        tokens = np.asarray(tokens, np.int32)
        counts = np.asarray(counts, np.int32)
        b, c = tokens.shape
        enforce(b == self.batch_size, "verify batch %s != %s", b,
                self.batch_size)
        for i in range(b):
            if counts[i]:
                cap = self._slot_capacity.get(i, 0)
                enforce(self.lengths[i] + counts[i] <= cap,
                        "slot %s verify rows %s overrun capacity %s at "
                        "length %s", i, counts[i], cap, self.lengths[i])
        wmask = (np.arange(c, dtype=np.int32)[None, :]
                 < counts[:, None])
        logits = self._chunk(state, tokens, self.tables, self.lengths,
                             wmask, chunk=c)
        return state, _to_numpy(logits)

    def advance(self, slot, n):
        """Commit n positions for `slot` (acceptance outcome)."""
        n = int(n)
        enforce(n >= 0, "advance must be >= 0")
        cap = self._slot_capacity.get(slot, 0)
        enforce(self.lengths[slot] + n <= cap,
                "advance(%s, %s) overruns capacity %s at length %s",
                slot, n, cap, self.lengths[slot])
        self.lengths[slot] += n

    def free_slot(self, slot):
        """Retire a slot: release every table block (shared ones drop a
        reference; complete prompt blocks stay CACHED in the prefix
        index, evictable)."""
        ids = self._slot_blocks.pop(slot, None)
        if ids is None:
            return
        self._slot_capacity.pop(slot, None)
        self.pool.release(ids)
        self.tables[slot, :] = 0
        self.lengths[slot] = 0

    # -- spill tier and state relocation -------------------------------
    def _block_to_host(self, state, bid):
        """One block's payloads [L, bs, N, Dh] and, quantized, its scale
        strips [L, bs] as host numpy copies (float8 bytes as uint8). The
        device-to-host copy is synchronous, so the host holds the bytes
        before any later kernel on the stream can overwrite the block."""
        out = [kv_to_numpy(t[:, bid]) for t in (state.cache_k, state.cache_v)]
        if not self._kv_quantized:
            return out + [None, None]
        return out + [kv_to_numpy(t[:, bid])
                      for t in (state.scale_k, state.scale_v)]

    def _restore(self, state, bids, payloads):
        """Scatter n spilled (k, v, k_scale, v_scale) payloads into pool
        blocks `bids`, one indexed copy per tensor — a block's payload
        and its scales land together."""
        dev = self.device
        idx = torch.as_tensor(np.asarray(bids, np.int64), device=dev)
        for j, dst in enumerate((state.cache_k, state.cache_v,
                                 state.scale_k, state.scale_v)):
            if dst is None:
                continue
            src = torch.from_numpy(np.stack([p[j] for p in payloads]))
            _bytes(dst)[:, idx] = _bytes(src.to(dev)).movedim(0, 1)

    def _demote_cb(self, state):
        """Demotion callback for pool evictions: copy the victim block's
        KV (and scales) to the host and spill it under its chain hash.
        None without a spill tier (eviction destroys the payload)."""
        if self.spill is None:
            return None

        def cb(bid, h):
            payload = self._block_to_host(state, bid)
            try:
                self.spill.put(h, *payload)
            except FaultError:
                pass    # an injected write fault: the payload is gone,
                        # the next admit of this prefix re-prefills
        return cb

    def spill_cached(self, state, n=None):
        """Demote up to `n` CACHED blocks (all when None) to the spill
        tier and free them — the degradation ladder's evict-to-spill
        rung. Without a spill tier the payloads are simply dropped.
        Returns the number of blocks freed."""
        return self.pool.evict_cached(n, demote_cb=self._demote_cb(state))

    def export_state(self, state, slot, tokens, include_kv=True):
        """Snapshot a live slot as a relocatable v2 document: the
        committed token sequence, the committed length, the prompt chain
        hashes, the kv_dtype and (with `include_kv`) the raw payloads of
        every fully scattered block — `lengths[slot] // block_size` of
        them — with their scale strips when quantized. Payloads keep
        their native dtype (float8 as its bytes in uint8). A CRC32 over
        the canonical bytes makes import_state refuse a corrupt
        document; the JAX package computes the same CRC."""
        inject_point("generation.state_export", tag=str(slot))
        enforce(slot in self._slot_blocks,
                "export_state on unadmitted slot %s", slot)
        toks = np.asarray(tokens, np.int32).reshape(-1)
        length = int(self.lengths[slot])
        enforce(toks.size >= length,
                "slot %s has %s committed positions but only %s tokens "
                "were passed", slot, length, toks.size)
        hashes = prefix_block_hashes(toks, self.block_size)
        doc = {"version": STATE_DOC_VERSION,
               "block_size": self.block_size,
               "kv_dtype": self.kv_dtype,
               "tokens": [int(t) for t in toks],
               "length": length,
               "block_hashes": [h.hex() for h in hashes],
               "kv": []}
        if include_kv:
            ids = self._slot_blocks[slot]
            for j in range(min(length // self.block_size, len(hashes))):
                k, v, ks, vs = self._block_to_host(state, ids[j])
                ent = {"hash": hashes[j].hex(), "k": k, "v": v}
                if self._kv_quantized:
                    ent["k_scale"], ent["v_scale"] = ks, vs
                doc["kv"].append(ent)
        doc["crc32"] = _state_doc_crc(doc)
        return doc

    def import_state(self, doc):
        """Validate an export_state document (the port's or the JAX
        package's: e4m3 payloads may be ml_dtypes arrays, whose raw
        bytes are read) and deposit its KV payloads into the spill tier.
        The device is untouched: the next admit() of the same token
        prefix promotes them, so a resumed request re-prefills nothing.
        A document without KV, or an engine without a spill tier, still
        validates (the caller re-prefills). Returns {"tokens", "length",
        "spilled_blocks"}. Raises StateDocError on version skew, CRC
        mismatch or geometry, KVDtypeMismatch on another pool dtype."""
        inject_point("generation.state_import")
        if int(doc.get("version", -1)) != STATE_DOC_VERSION:
            raise StateDocError(
                f"unknown DecodeState document version "
                f"{doc.get('version')!r} (this engine speaks "
                f"{STATE_DOC_VERSION})")
        if _state_doc_crc(doc) != doc.get("crc32"):
            raise StateDocError(
                "DecodeState document CRC mismatch — refusing to import "
                "corrupt state")
        if int(doc["block_size"]) != self.block_size:
            raise StateDocError(
                f"document block_size {doc['block_size']} != engine "
                f"block_size {self.block_size}")
        doc_dtype = doc.get("kv_dtype", "f32")
        if doc_dtype != self.kv_dtype:
            raise KVDtypeMismatch(
                f"document kv_dtype {doc_dtype!r} != engine kv_dtype "
                f"{self.kv_dtype!r} — refusing cross-precision KV import")
        want = {"f32": "float32", "int8": "int8",
                "fp8_e4m3": _FP8_TAG}[self.kv_dtype]
        entries = []
        for ent in (doc.get("kv", ()) if self.spill is not None else ()):
            k, v = np.asarray(ent["k"]), np.asarray(ent["v"])
            tags = {_payload_tag(k, doc_dtype), _payload_tag(v, doc_dtype)}
            if tags != {want}:
                raise KVDtypeMismatch(
                    f"document payload dtype {k.dtype}/{v.dtype} != pool "
                    f"dtype {want}")
            # the spill tier keeps e4m3 payloads as their bytes
            payload = [np.ascontiguousarray(a).view(np.uint8)
                       if want == _FP8_TAG else a for a in (k, v)]
            if self._kv_quantized:
                payload += [np.asarray(ent[key], np.float32)
                            for key in ("k_scale", "v_scale")]
            else:
                payload += [None, None]
            entries.append((bytes.fromhex(ent["hash"]), payload))
        for h, payload in entries:
            self.spill.put(h, *payload)
        return {"tokens": np.asarray(doc["tokens"], np.int32),
                "length": int(doc["length"]),
                "spilled_blocks": len(entries)}

    def compile_count(self):
        """As DecodeEngine.compile_count."""
        return _compile_count(self)

    def warm_manifest_name(self):
        h = hashlib.sha256(self.cache_token.encode()).hexdigest()[:16]
        return f"generation-paged-{h}"

    def warmup(self):
        """Capture the full paged rung ladder off the request path (every
        prefill bucket, the plain chunk=1 decode and the chunk=spec_k+1
        verify), first from the compile cache's manifest when there is
        one, then write the manifest. The rungs run against an
        all-garbage table (block 0) on the engine's own pools, then the
        pools and the host accounting are reset. Returns
        {"prefill_buckets", "step_chunks", "warm_start"}."""
        pcache, manifest, warm_report = _warm_start(
            self, (self._step_fn, self._prefill_fn))
        state = self.init_state()
        zt = np.zeros((1, self.blocks_per_slot), np.int32)
        for b in self.buckets:
            self._chunk(state, np.zeros((1, b), np.int32), zt, [0],
                        np.ones((1, b), bool), bucket=b)
        chunks = [1]
        if self.spec_k > 0:
            chunks.append(self.spec_k + 1)
        tables = np.zeros((self.batch_size, self.blocks_per_slot),
                          np.int32)
        for c in chunks:
            self._chunk(state, np.zeros((self.batch_size, c), np.int32),
                        tables, np.zeros(self.batch_size, np.int32),
                        np.ones((self.batch_size, c), bool), chunk=c)
        if manifest is not None:
            pcache.write_manifest(manifest, scope=self.ledger_scope)
        self.init_state()
        return {"prefill_buckets": list(self.buckets),
                "step_chunks": chunks, "warm_start": warm_report}


# ---------------------------------------------------------------------------
# Speculative decoding: the n-gram draft and the two acceptance rules
# ---------------------------------------------------------------------------

class NgramDraft:
    """Prompt-lookup n-gram draft: a frequency table over token windows
    (highest order wins, backing off) proposes up to k chained
    continuations per tick — pure host work, zero device launches. The
    table learns from `observe()` feeds.

    `min_count` / `min_frac` gate proposals on evidence. Greedy
    proposals are deterministic (max count, lowest token id on ties).
    `propose_sampled` draws from the table's empirical distribution q
    and RETURNS q — what the rejection-sampling rule needs."""

    def __init__(self, vocab_size, orders=(4, 3, 2, 1), min_count=1,
                 min_frac=0.0):
        enforce(vocab_size >= 1, "vocab_size must be >= 1")
        self.vocab_size = int(vocab_size)
        self.orders = tuple(sorted(set(int(o) for o in orders),
                                   reverse=True))
        enforce(self.orders and self.orders[-1] >= 1,
                "orders must be >= 1")
        self.min_count = int(min_count)
        self.min_frac = float(min_frac)
        self._tabs = {o: collections.defaultdict(collections.Counter)
                      for o in self.orders}

    def observe(self, tokens, n_new=None):
        """Count every window ending in the last `n_new` positions of
        `tokens` (all positions when None)."""
        toks = [int(t) for t in tokens]
        n = len(toks)
        lo = 0 if n_new is None else max(n - int(n_new), 0)
        for o in self.orders:
            tab = self._tabs[o]
            for i in range(max(lo, o), n):
                tab[tuple(toks[i - o:i])][toks[i]] += 1

    def _lookup(self, ctx):
        """Highest-order gated match: (token, q-counter, total) or
        None."""
        for o in self.orders:
            if len(ctx) < o:
                continue
            counter = self._tabs[o].get(tuple(ctx[-o:]))
            if not counter:
                continue
            total = sum(counter.values())
            tok, cnt = max(counter.items(),
                           key=lambda kv: (kv[1], -kv[0]))
            if cnt >= self.min_count and cnt / total >= self.min_frac:
                return tok, counter, total
        return None

    def propose(self, context, k):
        """Up to k chained greedy proposals (stops at the first
        no-confidence step)."""
        ctx = [int(t) for t in context]
        out = []
        for _ in range(int(k)):
            hit = self._lookup(ctx)
            if hit is None:
                break
            out.append(hit[0])
            ctx.append(hit[0])
        return out

    def propose_sampled(self, context, k, rng):
        """Up to k chained SAMPLED proposals; returns
        [(token, q [V] float64), ...] where token ~ q."""
        ctx = [int(t) for t in context]
        out = []
        for _ in range(int(k)):
            hit = self._lookup(ctx)
            if hit is None:
                break
            _, counter, total = hit
            q = np.zeros(self.vocab_size, np.float64)
            for tok, cnt in counter.items():
                q[tok] = cnt / total
            tok = int(rng.choice(self.vocab_size, p=q))
            out.append((tok, q))
            ctx.append(tok)
        return out

    def stats(self):
        return {o: len(t) for o, t in self._tabs.items()}


def greedy_verify(proposed, logits_rows):
    """Greedy acceptance: accept while the proposal IS the argmax, emit
    the argmax correction at the first mismatch, and the bonus argmax of
    the final row when everything was accepted. Returns (emitted tokens,
    n_accepted); always emits n_accepted+1 tokens."""
    emitted = []
    for i, d in enumerate(proposed):
        t = select_token(logits_rows[i])
        emitted.append(t)
        if int(d) != t:
            return emitted, i               # t is the correction
    emitted.append(select_token(logits_rows[len(proposed)]))
    return emitted, len(proposed)


def _softmax64(row, temperature):
    z = np.asarray(row, np.float64).reshape(-1)
    z = z / max(float(temperature), 1e-6)
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def rejection_verify(proposed, logits_rows, temperature, rng):
    """Rejection-sampling acceptance for temperature sampling: proposal
    d_i ~ q_i is accepted with probability min(1, p_i(d_i)/q_i(d_i)); on
    rejection the correction is drawn from normalize(max(p_i - q_i, 0)),
    and a full acceptance draws the bonus token from the final row.
    `proposed` is propose_sampled() output. Returns (emitted,
    n_accepted)."""
    emitted = []
    for i, (d, q) in enumerate(proposed):
        p = _softmax64(logits_rows[i], temperature)
        accept_p = min(1.0, float(p[int(d)])
                       / max(float(q[int(d)]), 1e-300))
        if rng.uniform() < accept_p:
            emitted.append(int(d))
        else:
            residual = np.maximum(p - q, 0.0)
            mass = residual.sum()
            probs = residual / mass if mass > 0.0 else p
            emitted.append(int(rng.choice(p.size, p=probs)))
            return emitted, i
    p = _softmax64(logits_rows[len(proposed)], temperature)
    emitted.append(int(rng.choice(p.size, p=p)))
    return emitted, len(proposed)
