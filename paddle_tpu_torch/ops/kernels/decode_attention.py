"""Decode attention: kernels K5 (contiguous cache), K6 (paged pools) and
K7 (paged pools with int8 / float8 e4m3 payloads and per-row scales).

Counterpart of the decode half of
`paddle_tpu/ops/pallas/flash_attention.py`. Each kernel is a CUDA C++
kernel for Hopper (`paddle_tpu_torch/csrc/decode_attention.cu`, built by
`_build.py` on first use), and beside it stands its plain PyTorch
version, the same masked-gather + softmax arithmetic as the JAX package's
`decode_attention_reference` / `paged_decode_attention_reference` /
`quantized_paged_decode_attention_reference`.

K5 runs one kernel on the CUDA cores, `f32_decode_kernel`, which is
also K6's decode route. K6 and K7 each have two kernels on the card.
Decode ticks (and K6's chunks below PAGED_TC_MIN_C rows) go to a decode
kernel on the CUDA cores, every longer chunk (verify and prefill) to a
prefill kernel on the bf16 tensor cores that keeps f32 accuracy by
splitting operands into three bf16 pieces: K7's `qattn_prefill_tc_kernel`
splits q and p * s_v (its codes are exact in bf16), K6's
`paged_prefill_tc_kernel` splits q, k, v and p and sums six piece
products per f32 product. Both kernels of a wrapper take the same
arguments and compute the same function. The decode kernels run as one
launch that allocates nothing but its output: their keys are split from
the window's capacity (K5's and K6's striped in stages over the blocks
of a tile, K7's in ranges) and merged inside the launch, K5's and K6's
in a thread-block cluster through distributed shared memory, K7's
through a zeroed workspace per (device, stream) that the kernel leaves
zeroed.

A wrapper takes the plain version only because the tensors it was given
lie on the CPU. On a CUDA tensor it launches the kernel or raises: a
failed build or a refused launch is an error, never a fallback.
`launch_counts` counts kernel launches per wrapper, so a run can show
that its main path went through the kernels. The dict is registered with
`observability.profile`, so a captured CUDA graph adds the launches its
capture saw on every replay; each launch also reports its operations
(4 per (row, key) pair per head element, keys counted at the window's
capacity, the static count) to the profile's cost of the run that
measures it.
"""
import math

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import profile as _profile

__all__ = [
    "NEG_INF", "decode_attention", "paged_decode_attention",
    "quantized_paged_decode_attention", "decode_attention_reference",
    "paged_decode_attention_reference",
    "quantized_paged_decode_attention_reference", "launch_counts",
    "reset_launch_counts", "split_count", "chunk_split_count",
    "decode_split_count", "f32_decode_split_count",
    "PAGED_TC_MIN_C",
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

#: query rows and keys per tile of the prefill kernels (C > 1)
_PREFILL_ROWS = 64
_PREFILL_KEYS = 64

#: chunks of at least this many rows take K6's tensor-core kernel; on
#: the card (chip_smoke phase 2's crossover at B = 8) its CUDA-core kernel
#: was faster at C = 2, 5 and 8 and slower from C = 16 on; the threshold
#: sits at the smallest prefill bucket, 8, so every prefill (one slot,
#: not timed on both kernels) stays on the tensor cores, and the decode
#: ticks and the verify chunk (spec_k + 1 = 5) take the CUDA cores
PAGED_TC_MIN_C = 8

#: kernel launches per wrapper (bumped once per launched call);
#: "paged_decode_attention" counts every K6 call and
#: "paged_prefill_attention" the chunks (C >= PAGED_TC_MIN_C) among them;
#: "quantized_paged_decode_attention" counts every K7 call, and
#: "quantized_paged_prefill_attention" the chunks (C > 1) among them
launch_counts = _profile.register_launch_counts(
    {"decode_attention": 0, "paged_decode_attention": 0,
     "paged_prefill_attention": 0,
     "quantized_paged_decode_attention": 0,
     "quantized_paged_prefill_attention": 0})

#: workspaces of K7's decode kernel, one per (device, stream): int32
#: zeros, zeroed once here; each launch leaves what it used zero again.
#: A captured graph holds the pointer of the workspace it was captured
#: with, so one that is outgrown stays alive in _retired_workspaces, and
#: growing one while a capture runs raises (the capture's warm-up run
#: sizes it first)
_workspaces = {}
_retired_workspaces = []

#: payload dtypes of K7 and the kernel's fp8 flag for each
_PAYLOAD_FP8 = {torch.int8: 0, torch.float8_e4m3fn: 1}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def decode_attention_reference(q, k_cache, v_cache, lengths, sm_scale=None):
    """Masked decode attention. q [B, N, D]: one query row per slot;
    k_cache/v_cache [B, S, N, D]; lengths [B] valid entries per slot.
    Logits are scaled by `sm_scale` (1/sqrt(D) when None). Rows with
    lengths == 0 return zeros."""
    s_len = k_cache.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnd,bsnd->bns", q, k_cache) * sm_scale
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


def _payload_window(pool, tables):
    """pool[tables] as float32. A float8 pool is gathered through its
    uint8 view (indexing is not implemented for float8 tensors
    everywhere); only the final cast needs the float8 dtype."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[tables].view(pool.dtype).float()
    return pool[tables].float()


def quantized_paged_decode_attention_reference(q, k_pool, v_pool, k_scale,
                                               v_scale, tables, lengths):
    """Masked paged decode attention over quantized pools: q [B, C, N, D]
    float32; k_pool/v_pool [NB, bs, N, D] int8 or float8_e4m3fn
    payloads; k_scale/v_scale [NB, bs] float32 per-row multipliers
    (payload * scale == value); tables/lengths as in
    paged_decode_attention_reference. The scales fold in the JAX order:
    logits = (q . k_q) * s_k * sm_scale, then softmax, then
    (probs * s_v) . v_q; the window is gathered but never dequantized."""
    bs = k_pool.shape[1]
    b, c = q.shape[0], q.shape[1]
    m = tables.shape[1]
    tables = tables.long().clamp(0, k_pool.shape[0] - 1)
    win_kq = _payload_window(k_pool, tables).reshape(
        (b, m * bs) + tuple(k_pool.shape[2:]))
    win_vq = _payload_window(v_pool, tables).reshape(
        (b, m * bs) + tuple(v_pool.shape[2:]))
    win_ks = k_scale[tables].reshape(b, m * bs)
    win_vs = v_scale[tables].reshape(b, m * bs)
    logits = torch.einsum("bcnd,bsnd->bncs", q, win_kq)
    logits = (logits * win_ks[:, None, None, :]
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
    probs = probs * win_vs[:, None, None, :]
    return torch.einsum("bncs,bsnd->bcnd", probs, win_vq)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def split_count(blocks, capacity, min_keys=32):
    """Key ranges per (row tile, slot, head) block of K7's prefill
    kernel (flash-decoding split-K): enough to put _BLOCKS_PER_SM blocks
    on every SM, at most _MAX_SPLITS, and never more than the window
    could fill with `min_keys` keys each (its key tile of 64)."""
    want = -(-(_SMS * _BLOCKS_PER_SM) // max(int(blocks), 1))
    return int(max(1, min(want, _MAX_SPLITS,
                          -(-int(capacity) // int(min_keys)))))


def chunk_split_count(blocks, capacity):
    """Key ranges per (64-row tile, slot, head) of K6's chunk kernel:
    about three blocks an SM, rounded down (the kernel holds two an SM,
    with 106 KB of shared memory at D = 64 against K7's 42 KB, so K7's
    rule of four would queue three waves of the 96 tiles of the main
    path's verify chunk), at most _MAX_SPLITS and never under one key
    tile of 64 a range."""
    want = _SMS * 3 // max(int(blocks), 1)
    return int(max(1, min(want, _MAX_SPLITS,
                          -(-int(capacity) // _PREFILL_KEYS))))


def decode_split_count(capacity, d):
    """Key ranges per (slot, head) of K7's decode kernel: as many as give
    each block at most two steps of keys (its 128 / (D / 16) lane groups
    take 4 keys a step: 256 keys at D = 64, so 4 ranges of a 1024-key
    window), at most _MAX_SPLITS. The ranges are cut from the capacity
    and all of them run at once: the slowest block, not the count, sets
    the time."""
    keys = 2 * 4 * 128 // (int(d) // 16)
    return int(max(1, min(_MAX_SPLITS, -(-int(capacity) // keys))))


def f32_decode_split_count(capacity, d):
    """Blocks per (row tile, slot, head) of f32_decode_kernel (K5, K6's
    decode route), one thread-block cluster that the window's stages are
    striped over: one per 128 KB of f32 K and V in a full window (16384
    / D keys: 4 blocks of a 1024-key window at D = 64), at most
    _MAX_SPLITS (a cluster's most)."""
    keys = 16384 // int(d)
    return int(max(1, min(_MAX_SPLITS, -(-int(capacity) // keys))))


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


def _check_payload(name, t, ndim):
    enforce(t.is_cuda, "%s must be a CUDA tensor, got device %s", name,
            t.device)
    enforce(t.dtype in _PAYLOAD_FP8, "%s must be int8 or float8_e4m3fn, "
            "got %s", name, t.dtype)
    enforce(t.dim() == ndim, "%s must have %d dims, got shape %s", name,
            ndim, tuple(t.shape))
    enforce(t.stride(-1) == 1, "%s must be contiguous in its last dim "
            "(strides %s)", name, t.stride())
    enforce(all(s % 16 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0,
            "%s rows must be 16-byte aligned (strides %s)", name, t.stride())


def _check_scale(name, t, shape, device):
    enforce(t.device == device, "%s must lie on %s, got %s", name, device,
            t.device)
    enforce(t.dtype == torch.float32, "%s must be float32, got %s", name,
            t.dtype)
    enforce(tuple(t.shape) == shape and t.stride(-1) == 1,
            "%s must be a %s tensor contiguous in its last dim, got shape "
            "%s strides %s", name, shape, tuple(t.shape), t.stride())


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
    """Partial (m, l, acc) buffers of a chunk kernel's split keys."""
    if nsplit == 1:
        return None, None, None
    return (torch.empty((rows, nsplit), dtype=torch.float32, device=device),
            torch.empty((rows, nsplit), dtype=torch.float32, device=device),
            torch.empty((rows, nsplit, d), dtype=torch.float32,
                        device=device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def decode_attention(q, k_cache, v_cache, lengths, sm_scale=None):
    """K5: single-step cached attention, q [B, N, D] against a
    contiguous cache [B, S, N, D] (read through its strides, so a layer's
    view of a stacked [L, B, S, N, D] cache needs no copy) with per-slot
    validity `lengths` [B] int32; logits scaled by `sm_scale` (1/sqrt(D)
    when None, as the JAX package's flash_decode_attention). Returns
    [B, N, D]."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          sm_scale)
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
    return _launch_contiguous(q, k_cache, v_cache, lengths, sm_scale)


def _launch_contiguous(q, k_cache, v_cache, lengths, sm_scale=None):
    """One K5 launch on checked operands, counted. Returns [B, N, D]
    float32."""
    from paddle_tpu_torch.ops.kernels import _build
    b, n, d = q.shape
    s_len = k_cache.shape[1]
    out = torch.empty((b, n, d), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return out
    lib = _build.load_library()
    err = lib.ptt_decode_attention_f32(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        b, s_len, n, d, q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        f32_decode_split_count(s_len, d),
        1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale),
        _stream(q.device))
    _raise_on(err, "decode_attention")
    launch_counts["decode_attention"] += 1
    _profile.note_kernel_flops(4.0 * b * s_len * n * d)
    return out


def paged_decode_attention(q, k_pool, v_pool, tables, lengths):
    """K6: chunked paged decode attention, q [B, C, N, D] against block
    pools [NB, bs, N, D] through block tables [B, M] int32, with
    committed lengths [B] int32; row c sees positions < lengths[b]+c+1.
    Any C (decode 1, verify k+1, prefill continuation up to max_len): a
    decode tick and a chunk of fewer than PAGED_TC_MIN_C rows take the
    CUDA-core kernel (one launch), a longer chunk the tensor-core kernel.
    Returns [B, C, N, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                lengths)
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
    enforce(tables.shape[0] == b and lengths.shape[0] == b,
            "tables %s / lengths %s do not match batch %d",
            tuple(tables.shape), tuple(lengths.shape), b)
    return _launch_paged(q, k_pool, v_pool, tables, lengths)


def _launch_paged(q, k_pool, v_pool, tables, lengths):
    """One K6 launch on checked operands, counted: a decode tick or a
    chunk of fewer than PAGED_TC_MIN_C rows on the CUDA-core kernel (one
    launch, no buffer), a longer chunk on the tensor-core kernel
    (partials and a combine). Returns [B, C, N, D] float32."""
    from paddle_tpu_torch.ops.kernels import _build
    b, c, n, d = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    m = tables.shape[1]
    out = torch.empty((b, c, n, d), dtype=torch.float32, device=q.device)
    if b == 0 or c == 0 or n == 0:
        return out
    chunk = c >= PAGED_TC_MIN_C
    if chunk:
        nsplit = chunk_split_count(b * n * -(-c // _PREFILL_ROWS), m * bs)
        fn = "ptt_paged_prefill_attention_f32"
        buffers = _partials(b * c * n, nsplit, d, q.device)
    else:
        nsplit = f32_decode_split_count(m * bs, d)
        fn = "ptt_paged_decode_attention_f32"
        buffers = ()
    lib = _build.load_library()
    err = getattr(lib, fn)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        *map(_ptr, buffers), b, c, n, d, nb, bs, m,
        q.stride(0), q.stride(1), q.stride(2),
        k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
        v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
        nsplit, 1.0 / math.sqrt(d), _stream(q.device))
    _raise_on(err, "paged_decode_attention")
    launch_counts["paged_decode_attention"] += 1
    if chunk:
        launch_counts["paged_prefill_attention"] += 1
    _profile.note_kernel_flops(4.0 * b * c * m * bs * n * d)
    return out


def _launch_quantized(q, k_pool, v_pool, k_scale, v_scale, tables,
                      lengths):
    """One K7 launch on checked operands, counted: a decode tick (C = 1)
    on the decode kernel (one launch; its workspace when the keys split),
    a longer chunk on the prefill kernel (partials and a combine).
    Returns [B, C, N, D] float32."""
    from paddle_tpu_torch.ops.kernels import _build
    b, c, n, d = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    m = tables.shape[1]
    out = torch.empty((b, c, n, d), dtype=torch.float32, device=q.device)
    if b == 0 or c == 0 or n == 0:
        return out
    if c == 1:
        nsplit = decode_split_count(m * bs, d)
        fn = "ptt_quantized_paged_decode_attention"
        work = None
        if nsplit > 1:   # arrival counters, then (acc, m, l) records
            rows = b * n
            work = _workspace(-(-rows // 4) * 4 + rows * nsplit * (d + 4),
                              q.device)
        buffers = (work,)
    else:
        nsplit = split_count(b * n * -(-c // _PREFILL_ROWS), m * bs,
                             _PREFILL_KEYS)
        fn = "ptt_quantized_paged_prefill_attention"
        buffers = _partials(b * c * n, nsplit, d, q.device)
    lib = _build.load_library()
    err = getattr(lib, fn)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), *map(_ptr, buffers),
        b, c, n, d, nb, bs, m,
        q.stride(0), q.stride(1), q.stride(2),
        k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
        v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
        k_scale.stride(0), v_scale.stride(0),
        nsplit, 1.0 / math.sqrt(d), _PAYLOAD_FP8[k_pool.dtype],
        _stream(q.device))
    if err != 0 and c == 1:   # the workspace may not be zero any more
        _workspaces.pop((q.device, _stream(q.device)), None)
    _raise_on(err, "quantized_paged_decode_attention")
    launch_counts["quantized_paged_decode_attention"] += 1
    if c > 1:
        launch_counts["quantized_paged_prefill_attention"] += 1
    _profile.note_kernel_flops(4.0 * b * c * m * bs * n * d)
    return out


def _workspace(size, device):
    """At least `size` zeroed int32 of the decode kernel's workspace for
    `device`'s current stream (kernels on one stream run in order, so
    they can share it); allocated, and zeroed, only when it has to
    grow."""
    key = (device, _stream(device))
    work = _workspaces.get(key)
    if work is None or work.numel() < size:
        enforce(device.type != "cuda"
                or not torch.cuda.is_current_stream_capturing(),
                "K7's decode workspace would grow from %s to %s int32 "
                "while a CUDA graph is being captured; run the rung once "
                "on the capture stream first", 0 if work is None
                else work.numel(), size)
        if work is not None:
            _retired_workspaces.append(work)
        work = _workspaces[key] = torch.zeros(size, dtype=torch.int32,
                                              device=device)
    return work


def quantized_paged_decode_attention(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, lengths):
    """K7: K6 over quantized pools. q [B, C, N, D] float32 against
    payload pools [NB, bs, N, D] (int8 or float8_e4m3fn, the same for
    both) with per-row scales [NB, bs] float32, through block tables
    [B, M] int32, committed lengths [B] int32; row c sees positions
    < lengths[b]+c+1. Any C: a decode tick (C = 1) takes the decode
    kernel, a longer chunk the prefill kernel. Returns [B, C, N, D]
    float32."""
    if q.device.type == "cpu":
        return quantized_paged_decode_attention_reference(
            q, k_pool, v_pool, k_scale, v_scale, tables, lengths)
    _check_operand("q", q, 4)
    _check_payload("k_pool", k_pool, 4)
    _check_payload("v_pool", v_pool, 4)
    b, c, n, d = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    enforce(tuple(k_pool.shape) == (nb, bs, n, d)
            and v_pool.shape == k_pool.shape
            and v_pool.dtype == k_pool.dtype,
            "pools %s %s / %s %s do not match q %s", tuple(k_pool.shape),
            k_pool.dtype, tuple(v_pool.shape), v_pool.dtype, tuple(q.shape))
    enforce(d in KERNEL_HEAD_DIMS, "head dim %d not in %s", d,
            KERNEL_HEAD_DIMS)
    enforce(q.device == k_pool.device == v_pool.device,
            "q and pools must share a device")
    _check_scale("k_scale", k_scale, (nb, bs), q.device)
    _check_scale("v_scale", v_scale, (nb, bs), q.device)
    _check_index("tables", tables, 2, q.device)
    _check_index("lengths", lengths, 1, q.device)
    enforce(tables.shape[0] == b and lengths.shape[0] == b,
            "tables %s / lengths %s do not match batch %d",
            tuple(tables.shape), tuple(lengths.shape), b)
    return _launch_quantized(q, k_pool, v_pool, k_scale, v_scale, tables,
                             lengths)
