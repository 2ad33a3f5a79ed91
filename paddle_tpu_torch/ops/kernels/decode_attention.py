"""Decode attention: kernels K5 (contiguous cache) and K6 (paged pools).

Counterpart of the decode half of
`paddle_tpu/ops/pallas/flash_attention.py`. Each kernel is a CUDA C++
kernel for Hopper (`paddle_tpu_torch/csrc/decode_attention.cu`, built by
`_build.py` on first use), and beside it stands its plain PyTorch
version, the same masked-gather + softmax arithmetic as the JAX package's
`decode_attention_reference` / `paged_decode_attention_reference`.

A wrapper takes the plain version only because the tensors it was given
lie on the CPU. On a CUDA tensor it launches the kernel or raises: a
failed build or a refused launch is an error, never a fallback.
`launch_counts` counts kernel launches per wrapper, so a run can show
that its main path went through the kernels.
"""
import math

import torch

from paddle_tpu_torch.core.enforce import enforce

__all__ = [
    "NEG_INF", "decode_attention", "paged_decode_attention",
    "decode_attention_reference", "paged_decode_attention_reference",
    "launch_counts", "reset_launch_counts", "split_count",
]

#: masked-logit value of the JAX package (not -inf: an all-masked row
#: softmaxes to a finite uniform row, which the callers then zero)
NEG_INF = -1e30

#: head dims the kernels are instantiated for (D/4 lanes per key group)
KERNEL_HEAD_DIMS = (32, 64, 128)

#: streaming multiprocessors of an H100 SXM; split-K aims for this many
#: blocks times _BLOCKS_PER_SM
_SMS = 132
_BLOCKS_PER_SM = 4
_MAX_SPLITS = 16

#: kernel launches per wrapper (bumped once per launched call)
launch_counts = {"decode_attention": 0, "paged_decode_attention": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def decode_attention_reference(q, k_cache, v_cache, lengths):
    """Masked decode attention. q [B, N, D]: one query row per slot;
    k_cache/v_cache [B, S, N, D]; lengths [B] valid entries per slot.
    Logits are scaled by 1/sqrt(D). Rows with lengths == 0 return
    zeros."""
    s_len = k_cache.shape[1]
    logits = (torch.einsum("bnd,bsnd->bns", q, k_cache)
              * (1.0 / math.sqrt(q.shape[-1])))
    lengths = lengths.to(torch.int32)
    valid = (torch.arange(s_len, dtype=torch.int32, device=q.device)[None, :]
             < lengths[:, None])                          # [B, S]
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    # an all-masked row softmaxes NEG_INF uniformly; zero it instead
    probs = torch.where((lengths > 0)[:, None, None], probs,
                        torch.zeros_like(probs))
    return torch.einsum("bns,bsnd->bnd", probs, v_cache)


def paged_decode_attention_reference(q, k_pool, v_pool, tables, lengths):
    """Masked paged decode attention. q [B, C, N, D]: row c of slot b
    sits at position lengths[b]+c and attends to positions
    < lengths[b]+c+1; k_pool/v_pool [NB, bs, N, D]; tables [B, M] block
    ids (position p of slot b lives in block tables[b, p // bs] at
    offset p % bs). Rows with an empty window return zeros."""
    bs = k_pool.shape[1]
    b, c = q.shape[0], q.shape[1]
    m = tables.shape[1]
    tables = tables.long().clamp(0, k_pool.shape[0] - 1)
    win_k = k_pool[tables].reshape((b, m * bs) + tuple(k_pool.shape[2:]))
    win_v = v_pool[tables].reshape((b, m * bs) + tuple(v_pool.shape[2:]))
    logits = (torch.einsum("bcnd,bsnd->bncs", q, win_k)
              * (1.0 / math.sqrt(q.shape[-1])))
    limits = (lengths.to(torch.int32)[:, None]
              + torch.arange(c, dtype=torch.int32, device=q.device)[None, :]
              + 1)                                        # [B, C]
    valid = (torch.arange(m * bs, dtype=torch.int32,
                          device=q.device)[None, None, :]
             < limits[:, :, None])                        # [B, C, S]
    logits = torch.where(valid[:, None, :, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where((limits > 0)[:, None, :, None], probs,
                        torch.zeros_like(probs))
    return torch.einsum("bncs,bsnd->bcnd", probs, win_v)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def split_count(blocks, capacity):
    """Key ranges per (slot, head, row tile) block (flash-decoding
    split-K): enough to put _BLOCKS_PER_SM blocks on every SM, at most
    _MAX_SPLITS, and never more than the window could fill with 32 keys
    each."""
    want = -(-(_SMS * _BLOCKS_PER_SM) // max(int(blocks), 1))
    return int(max(1, min(want, _MAX_SPLITS, -(-int(capacity) // 32))))


def _check_operand(name, t, ndim):
    enforce(t.is_cuda, "%s must be a CUDA tensor, got device %s", name,
            t.device)
    enforce(t.dtype == torch.float32, "%s must be float32, got %s", name,
            t.dtype)
    enforce(t.dim() == ndim, "%s must have %d dims, got shape %s", name,
            ndim, tuple(t.shape))
    enforce(t.stride(-1) == 1, "%s must be contiguous in its last dim "
            "(strides %s)", name, t.stride())
    enforce(all(s % 4 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0,
            "%s rows must be 16-byte aligned (strides %s)", name, t.stride())


def _check_index(name, t, ndim, device):
    enforce(t.device == device, "%s must lie on %s, got %s", name, device,
            t.device)
    enforce(t.dtype == torch.int32, "%s must be int32, got %s", name,
            t.dtype)
    enforce(t.dim() == ndim and t.is_contiguous(),
            "%s must be a contiguous %d-dim tensor, got shape %s", name,
            ndim, tuple(t.shape))


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def _partials(rows, nsplit, d, device):
    if nsplit == 1:
        return None, None, None
    return (torch.empty((rows, nsplit), dtype=torch.float32, device=device),
            torch.empty((rows, nsplit), dtype=torch.float32, device=device),
            torch.empty((rows, nsplit, d), dtype=torch.float32,
                        device=device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_attention(q, k_cache, v_cache, lengths):
    """K5: single-step cached attention, q [B, N, D] against a
    contiguous cache [B, S, N, D] (read through its strides, so a layer's
    view of a stacked [L, B, S, N, D] cache needs no copy) with per-slot
    validity `lengths` [B] int32. Returns [B, N, D]."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths)
    from paddle_tpu_torch.ops.kernels import _build
    _check_operand("q", q, 3)
    _check_operand("k_cache", k_cache, 4)
    _check_operand("v_cache", v_cache, 4)
    b, n, d = q.shape
    s_len = k_cache.shape[1]
    enforce(tuple(k_cache.shape) == (b, s_len, n, d)
            and v_cache.shape == k_cache.shape,
            "cache shapes %s / %s do not match q %s",
            tuple(k_cache.shape), tuple(v_cache.shape), tuple(q.shape))
    enforce(d in KERNEL_HEAD_DIMS, "head dim %d not in %s", d,
            KERNEL_HEAD_DIMS)
    enforce(q.device == k_cache.device == v_cache.device,
            "q and caches must share a device")
    _check_index("lengths", lengths, 1, q.device)
    enforce(lengths.shape[0] == b, "lengths %s != batch %d",
            tuple(lengths.shape), b)
    out = torch.empty((b, n, d), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return out
    nsplit = split_count(b * n, s_len)
    pm, pl, pacc = _partials(b * n, nsplit, d, q.device)
    lib = _build.load_library()
    err = lib.ptt_decode_attention_f32(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), _ptr(pm), _ptr(pl), _ptr(pacc),
        b, s_len, n, d, q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        nsplit, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "decode_attention")
    launch_counts["decode_attention"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, tables, lengths):
    """K6: chunked paged decode attention, q [B, C, N, D] against block
    pools [NB, bs, N, D] through block tables [B, M] int32, with
    committed lengths [B] int32; row c sees positions < lengths[b]+c+1.
    Any C (decode 1, verify k+1, prefill continuation up to max_len).
    Returns [B, C, N, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                lengths)
    from paddle_tpu_torch.ops.kernels import _build
    _check_operand("q", q, 4)
    _check_operand("k_pool", k_pool, 4)
    _check_operand("v_pool", v_pool, 4)
    b, c, n, d = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    enforce(tuple(k_pool.shape) == (nb, bs, n, d)
            and v_pool.shape == k_pool.shape,
            "pool shapes %s / %s do not match q %s", tuple(k_pool.shape),
            tuple(v_pool.shape), tuple(q.shape))
    enforce(d in KERNEL_HEAD_DIMS, "head dim %d not in %s", d,
            KERNEL_HEAD_DIMS)
    enforce(q.device == k_pool.device == v_pool.device,
            "q and pools must share a device")
    _check_index("tables", tables, 2, q.device)
    _check_index("lengths", lengths, 1, q.device)
    m = tables.shape[1]
    enforce(tables.shape[0] == b and lengths.shape[0] == b,
            "tables %s / lengths %s do not match batch %d",
            tuple(tables.shape), tuple(lengths.shape), b)
    out = torch.empty((b, c, n, d), dtype=torch.float32, device=q.device)
    if b == 0 or c == 0 or n == 0:
        return out
    row_tiles = 1 if c == 1 else -(-c // 8)
    nsplit = split_count(b * n * row_tiles, m * bs)
    pm, pl, pacc = _partials(b * c * n, nsplit, d, q.device)
    lib = _build.load_library()
    err = lib.ptt_paged_decode_attention_f32(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), _ptr(pm),
        _ptr(pl), _ptr(pacc), b, c, n, d, nb, bs, m,
        q.stride(0), q.stride(1), q.stride(2),
        k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
        v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
        nsplit, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_decode_attention")
    launch_counts["paged_decode_attention"] += 1
    return out
