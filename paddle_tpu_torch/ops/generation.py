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
  continuation (C=bucket) through kernel K6.

The JAX engines donate their cache buffers to jit so XLA updates them in
place; here the engines run eagerly and write the caches in place
explicitly (`index_put_` / slice assignment). The state tuples the
methods return hold the same tensors they were given.

The reference's jit ladder, CompileLedger, persistent compile cache and
planner estimates have no counterpart: `warmup()` runs every rung once
to build the kernels and warm the allocator. Only float32 KV is served
(`kv_dtype="f32"`); the spill tier and state documents wait for a later
slice.
"""
import collections
import hashlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.places import resolve_device
from paddle_tpu_torch.ops.kernels.decode_attention import (
    NEG_INF, decode_attention, paged_decode_attention,
)

__all__ = [
    "LMConfig", "TinyDecoderLM", "DecodeState", "DecodeEngine",
    "BlockPool", "PoolExhausted", "PagedDecodeState",
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
                      wmask):
        """tokens [R, C] at positions lengths[r]+c; scatter each row's
        KV into the block pools [L, NB, bs, N, Dh] (in place) through
        the block tables [R, M] int32 — masked rows go to garbage block
        0 — then chunked paged attention with exact per-row causality.
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
        x = self.tok_emb[tokens] + self.pos_emb[pos_c]         # [R, C, D]
        shape = (r, c, cfg.num_heads, cfg.head_dim)
        for li, blk_mod in enumerate(self.layers):
            q, k, v = blk_mod.qkv(x, shape)
            cache_k[li].index_put_((blk, off), k)
            cache_v[li].index_put_((blk, off), v)
            att = paged_decode_attention(q, cache_k[li], cache_v[li],
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


def _engine_device(model, device):
    """Resolve the engine's device and move the model there (in place,
    as nn.Module.to does). Float32 matmuls run in full float32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    model.to(dev)
    return dev


def _to_numpy(t):
    return t.detach().cpu().numpy()


class DecodeEngine:
    """KV-cached incremental decode over a fixed slot bank.

    One engine = one (batch_size, max_len) decode rung plus one prefill
    rung per prompt-length bucket. The host drives it slot-wise:
    `prefill()` admits a prompt into a free slot mid-flight (other
    slots' rows untouched), `step()` advances every slot one token and
    returns the full logits rows so the caller owns token selection and
    termination."""

    def __init__(self, model, batch_size, max_len, device=None):
        cfg = model.config
        enforce(max_len <= cfg.max_len,
                "engine max_len %d exceeds the model's positional table "
                "%d", max_len, cfg.max_len)
        enforce(batch_size >= 1, "batch_size must be >= 1")
        self.device = _engine_device(model, device)
        self.model = model
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.buckets = prompt_buckets(max_len)

    def init_state(self):
        cfg = self.model.config
        shape = (cfg.num_layers, self.batch_size, self.max_len,
                 cfg.num_heads, cfg.head_dim)
        return DecodeState(
            cache_k=torch.zeros(shape, dtype=torch.float32,
                                device=self.device),
            cache_v=torch.zeros(shape, dtype=torch.float32,
                                device=self.device),
            lengths=torch.zeros((self.batch_size,), dtype=torch.int32,
                                device=self.device))

    def bucket_for(self, prompt_len):
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.buckets[-1]}")

    def warmup(self):
        """Run every prefill bucket and the decode step once on a
        throwaway state (builds the kernels, warms the allocator).
        Returns {"prefill_buckets", "decode"}."""
        state = self.init_state()
        for b in self.buckets:
            prompt = np.zeros((min(b, self.max_len),), np.int32)
            state, _ = self.prefill(state, 0, prompt)
        self.step(state, np.zeros((self.batch_size,), np.int32),
                  np.zeros((self.batch_size,), bool))
        return {"prefill_buckets": list(self.buckets), "decode": True}

    @torch.no_grad()
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
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :prompt.size] = prompt
        tokens = torch.from_numpy(padded).to(self.device)
        length = torch.tensor([prompt.size], dtype=torch.int32,
                              device=self.device)
        logits, ks, vs = self.model.forward_full(tokens, length)
        for li in range(len(ks)):
            state.cache_k[li, slot, :bucket] = ks[li][0]
            state.cache_v[li, slot, :bucket] = vs[li][0]
        state.lengths[slot] = prompt.size
        return state, _to_numpy(logits[0, prompt.size - 1])

    @torch.no_grad()
    def step(self, state, tokens, active):
        """One decode tick for all slots. tokens [B] int, active [B]
        bool. Returns (state, logits [B, V] np.ndarray). Each active
        slot's row is the distribution for its next token at position
        lengths[b]."""
        tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(
            self.device)
        act = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        logits, lengths = self.model.forward_step(
            tok, state.cache_k, state.cache_v, state.lengths, act)
        state.lengths.copy_(lengths)
        return state, _to_numpy(logits)


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

    def alloc(self, n):
        """Take n blocks (refcount 1 each): the free stack first, then
        CACHED blocks oldest-first. Raises PoolExhausted — atomically,
        nothing is taken — when fewer than n blocks are obtainable."""
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
                _h, bid = next(iter(self._cached.items()))  # LRU-oldest
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

    def acquire(self, shared, n_own):
        """Ref `shared` (a lookup() result) and alloc `n_own` fresh
        blocks, atomically. The shared prefix is pinned FIRST, so
        alloc()'s LRU eviction cannot hand a shared block back as an
        own block. On PoolExhausted nothing is taken."""
        shared = list(shared)
        self.ref(shared)
        try:
            return self.alloc(n_own)
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


class PagedDecodeState(NamedTuple):
    """The paged carry: per-layer block pools
    [L, num_blocks, block_size, N, Dh] float32, updated in place. Tables,
    lengths and the pool accounting live host-side on the engine."""
    cache_k: torch.Tensor
    cache_v: torch.Tensor


class PagedDecodeEngine:
    """Block-table paged KV decode engine with a unified chunk forward.

    `[R, C]` token rows scatter their KV through the slot block tables
    (masked rows land in garbage block 0) and attend through kernel K6
    with per-row limits lengths[r]+c+1. The rungs are prefill (R=1,
    C=bucket: a prompt, or the unshared tail after a prefix hit), plain
    decode (R=B, C=1) and speculative verify (R=B, C=k+1).

    Host-side the engine owns the BlockPool, the per-slot tables [B, M]
    and committed lengths [B]; the device state is the two pools."""

    def __init__(self, model, batch_size, max_len, block_size=8,
                 num_blocks=None, spec_k=4, kv_dtype="f32", device=None):
        cfg = model.config
        if kv_dtype != "f32":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: quantized paged KV needs kernel "
                f"K7 (flash_quantized_paged_decode_attention), which is "
                f"still to be ported (ROADMAP.md, Queue 2, K7); the port "
                f"serves kv_dtype='f32' only")
        enforce(max_len <= cfg.max_len,
                "engine max_len %d exceeds the model's positional table "
                "%d", max_len, cfg.max_len)
        enforce(batch_size >= 1, "batch_size must be >= 1")
        enforce(max_len % block_size == 0,
                "max_len %d must be a multiple of block_size %d",
                max_len, block_size)
        enforce(spec_k >= 0, "spec_k must be >= 0")
        self.device = _engine_device(model, device)
        self.model = model
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.blocks_per_slot = self.max_len // self.block_size
        self.spec_k = int(spec_k)
        self.kv_dtype = kv_dtype
        if num_blocks is None:
            # every slot fully allocated, plus the garbage block
            num_blocks = self.batch_size * self.blocks_per_slot + 1
        enforce(num_blocks >= self.blocks_per_slot + 1,
                "pool of %s blocks cannot hold one full slot (%s)",
                num_blocks, self.blocks_per_slot)
        self.num_blocks = int(num_blocks)
        self.buckets = prompt_buckets(max_len)
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.tables = np.zeros((self.batch_size, self.blocks_per_slot),
                               np.int32)
        self.lengths = np.zeros((self.batch_size,), np.int32)
        self._slot_blocks = {}      # slot -> [block ids] (incl. shared)
        self._slot_capacity = {}    # slot -> allocated positions

    def kv_pool_bytes(self):
        """Device bytes of one init_state() KV carry (k + v pools)."""
        cfg = self.model.config
        rows = cfg.num_layers * self.num_blocks * self.block_size
        return 2 * rows * cfg.num_heads * cfg.head_dim * 4

    def _chunk(self, state, tokens, tables, lengths, wmask):
        """Run the chunk forward on host arrays; returns logits
        [R, C, V] as a device tensor (the pools are written in place)."""
        dev = self.device
        return self.model.forward_chunk(
            torch.from_numpy(np.asarray(tokens, np.int64)).to(dev),
            state.cache_k, state.cache_v,
            torch.from_numpy(np.ascontiguousarray(tables, np.int32)).to(dev),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev),
            torch.from_numpy(np.asarray(wmask, bool)).to(dev))

    def init_state(self):
        """Fresh device pools AND fresh host accounting (pool, tables,
        lengths) — a paged state and its block bookkeeping are one
        unit."""
        cfg = self.model.config
        shape = (cfg.num_layers, self.num_blocks, self.block_size,
                 cfg.num_heads, cfg.head_dim)
        self.pool = BlockPool(self.num_blocks, self.block_size)
        self.tables[:] = 0
        self.lengths[:] = 0
        self._slot_blocks.clear()
        self._slot_capacity.clear()
        return PagedDecodeState(
            cache_k=torch.zeros(shape, dtype=torch.float32,
                                device=self.device),
            cache_v=torch.zeros(shape, dtype=torch.float32,
                                device=self.device))

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
        so the admission always has a logits row to emit from. Returns
        (state, last-logits-row [V], {"shared_blocks", "shared_tokens",
        "tail_bucket"})."""
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
        shared = []
        if prefix_reuse and hashes:
            # keep >= 1 tail token to prefill (the emission row)
            max_shared = (prompt.size - 1) // self.block_size
            shared = self.pool.lookup(hashes)[:max_shared]
        n_total = -(-total_len // self.block_size)
        own = self.pool.acquire(shared, n_total - len(shared))
        ids = shared + own
        self._slot_blocks[slot] = ids
        self._slot_capacity[slot] = n_total * self.block_size
        self.tables[slot, :] = 0
        self.tables[slot, :len(ids)] = ids
        shared_tokens = len(shared) * self.block_size
        tail = prompt[shared_tokens:]
        bucket = self.bucket_for(tail.size)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :tail.size] = tail
        wmask = np.zeros((1, bucket), bool)
        wmask[0, :tail.size] = True
        logits = self._chunk(state, tokens, self.tables[slot:slot + 1],
                             [shared_tokens], wmask)
        self.lengths[slot] = prompt.size
        # publish the COMPLETE prompt blocks (decode writes start at
        # prompt.size, outside every one of them)
        n_pub = prompt.size // self.block_size
        self.pool.publish(ids[:n_pub], hashes[:n_pub])
        last = _to_numpy(logits[0, tail.size - 1])
        return (state, last,
                {"shared_blocks": len(shared),
                 "shared_tokens": shared_tokens,
                 "tail_bucket": bucket})

    def step(self, state, tokens, active):
        """Plain decode tick (chunk=1): scatter each active slot's token
        at its length and return the next-token logits [B, V]. Advances
        committed lengths for active slots."""
        active = np.asarray(active, bool)
        logits = self._chunk(state, np.asarray(tokens)[:, None],
                             self.tables, self.lengths, active[:, None])
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
                             wmask)
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

    def warmup(self):
        """Run every prefill bucket, the plain chunk=1 decode and the
        chunk=spec_k+1 verify once against an all-garbage table (builds
        the kernels, warms the allocator), then reset the host
        accounting. Returns {"prefill_buckets", "step_chunks"}."""
        state = self.init_state()
        zt = np.zeros((1, self.blocks_per_slot), np.int32)
        for b in self.buckets:
            self._chunk(state, np.zeros((1, b), np.int32), zt, [0],
                        np.ones((1, b), bool))
        chunks = [1]
        if self.spec_k > 0:
            chunks.append(self.spec_k + 1)
        tables = np.zeros((self.batch_size, self.blocks_per_slot),
                          np.int32)
        for c in chunks:
            self._chunk(state, np.zeros((self.batch_size, c), np.int32),
                        tables, np.zeros(self.batch_size, np.int32),
                        np.ones((self.batch_size, c), bool))
        del state
        self.init_state()             # reset host accounting
        return {"prefill_buckets": list(self.buckets),
                "step_chunks": chunks}


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
