"""The CUDA kernels on the card (K5, K6 and K7 with both routes each; K1-K4
and K8 below): each against its plain PyTorch version, the launch
counters, K7's decode workspace, and the wrappers' input checks.

Every test here carries the `cuda` marker and skips without a GPU (the
kernels are CUDA C++ for sm_90a and have no CPU mode). The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch, with the repo's JAX conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops.kernels import decode_attention as tda

#: float32 with TF32 off; the kernels sum in another order
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for "
                    "sm_90a and have no CPU mode")
    return torch.device("cuda")


def _randn(rng, *shape, device):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)


def _ints(values, device):
    return torch.tensor(np.asarray(values, np.int32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lengths", [
    ((8, 1024, 12, 64), [0, 1, 511, 1024, 3, 700, 64, 1000]),
    ((8, 1024, 12, 32), [0, 1, 1024, 700, 129, 128, 5, 900]),
    ((4, 1024, 12, 128), [0, 1024, 1, 333]),
    ((3, 24, 4, 32), [0, 13, 24]),
    ((2, 100, 2, 128), [57, 100]),
    ((2, 5000, 2, 64), [4999, 5000]),   # ranges of several stages
])
def test_k5_kernel_matches_plain(cuda, shape, lengths):
    """One layer of stacked [2, L, B, S, N, D] caches, D = 32, 64 and 128,
    lengths 0, 1, the full capacity and ones that end inside a range:
    within TOL of the plain version, zeros for an empty window, one
    launch counted, and two calls give the same bits."""
    b, s, n, d = shape
    rng = np.random.RandomState(2 + d)
    q = _randn(rng, b, n, d, device=cuda)
    cache = _randn(rng, 2, 2, b, s, n, d, device=cuda)
    k, v = cache[0, 1], cache[1, 1]
    ln = _ints(lengths, cuda)
    before = tda.launch_counts["decode_attention"]
    got = tda.decode_attention(q, k, v, ln)
    want = tda.decode_attention_reference(q, k, v, ln)
    again = tda.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tda.launch_counts["decode_attention"] == before + 2
    assert float((got - want).abs().max()) <= TOL
    assert torch.equal(got, again)
    if lengths[0] == 0:
        assert not got[0].any()


@pytest.mark.cuda
def test_k5_kernel_reads_strided_layer_views(cuda):
    """The engine's operands: q a view of the fused QKV output, k/v one
    layer of a stacked [L, B, S, N, D] cache."""
    rng = np.random.RandomState(3)
    qkv = _randn(rng, 4, 3 * 768, device=cuda)
    q = qkv[:, :768].reshape(4, 12, 64)
    cache = _randn(rng, 2, 3, 4, 256, 12, 64, device=cuda)
    ln = _ints([1, 256, 17, 100], cuda)
    got = tda.decode_attention(q, cache[0, 2], cache[1, 2], ln)
    want = tda.decode_attention_reference(q, cache[0, 2], cache[1, 2], ln)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8, 9, 512])
def test_k6_kernel_matches_plain(cuda, c, d):
    """One layer of stacked [2, L, NB, bs, N, D] pools through shuffled
    tables, q a view of a fused QKV projection, lengths 0, 1, the full
    capacity (the last row sees every key) and one that ends inside a
    key range: C = 1-4 on the decode route (CUDA cores, one launch; two
    calls give the same bits), C >= 5 on the chunk route."""
    b, n, bs, m = 4, 12, 8, 128
    nb = b * m + 1
    rng = np.random.RandomState(4 + c + d)
    qkv = _randn(rng, b, c, 3 * n * d, device=cuda)
    q = qkv[..., n * d:2 * n * d].reshape(b, c, n, d)
    pools = _randn(rng, 2, 2, nb, bs, n, d, device=cuda)
    kp, vp = 3.0 * pools[0, 1], pools[1, 1]
    tables = _ints(rng.permutation(np.arange(1, nb)).reshape(b, m), cuda)
    ln = _ints([0, 1, m * bs - c, 300], cuda)
    before = dict(tda.launch_counts)
    got = tda.paged_decode_attention(q, kp, vp, tables, ln)
    want = tda.paged_decode_attention_reference(q, kp, vp, tables, ln)
    torch.cuda.synchronize()
    assert tda.launch_counts["paged_decode_attention"] == \
        before["paged_decode_attention"] + 1
    assert tda.launch_counts["paged_prefill_attention"] == \
        before["paged_prefill_attention"] + (c >= tda.PAGED_TC_MIN_C)
    assert got.shape == (b, c, n, d) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL
    if c < tda.PAGED_TC_MIN_C:
        again = tda.paged_decode_attention(q, kp, vp, tables, ln)
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 40, 128, 256, 512])
def test_f32_decode_clusters_of_every_size(cuda, m):
    """Capacities whose key ranges make clusters of 1, 2, 4, 8 and 16
    blocks (16 is a non-portable cluster size), K5 and K6 at C = 1 and
    3: each call within TOL of the plain version."""
    rng = np.random.RandomState(12 + m)
    b, n, d, bs = 3, 4, 64, 8
    nb = b * m + 1
    cap = m * bs
    assert tda.f32_decode_split_count(cap, d) == min(16, -(-cap // 256))
    kp = _randn(rng, nb, bs, n, d, device=cuda)
    vp = _randn(rng, nb, bs, n, d, device=cuda)
    tables = _ints(rng.permutation(np.arange(1, nb)).reshape(b, m), cuda)
    for c in (1, 3):
        q = _randn(rng, b, c, n, d, device=cuda)
        ln = _ints([0, cap - c, rng.randint(0, cap - c + 1)], cuda)
        got = tda.paged_decode_attention(q, kp, vp, tables, ln)
        want = tda.paged_decode_attention_reference(q, kp, vp, tables, ln)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= TOL
    cache_k = _randn(rng, b, cap, n, d, device=cuda)
    cache_v = _randn(rng, b, cap, n, d, device=cuda)
    ln = _ints([cap, 1, rng.randint(0, cap + 1)], cuda)
    got = tda.decode_attention(q[:, 0], cache_k, cache_v, ln)
    want = tda.decode_attention_reference(q[:, 0], cache_k, cache_v, ln)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("c", [2, 5, 16, 64, 512])
def test_k6_chunk_route_matches_plain(cuda, monkeypatch, c, b, d):
    """The tensor-core kernel (six bf16 piece products per f32 product)
    over a shuffled pool (block_size 8, M = 128), K at 3x the scale of V,
    lengths from 0 to a full window, from the shortest chunk (C = 2,
    routed there by lowering PAGED_TC_MIN_C) and the verify chunk (C = 5)
    to the largest prefill bucket; B = 1 splits the keys, B = 8 at C =
    512 does not."""
    monkeypatch.setattr(tda, "PAGED_TC_MIN_C", 2)
    n, bs, m = 4, 8, 128
    nb = b * m + 1
    rng = np.random.RandomState(c + b + d + 1)
    q = _randn(rng, b, c, n, d, device=cuda)
    kp = 3.0 * _randn(rng, nb, bs, n, d, device=cuda)
    vp = _randn(rng, nb, bs, n, d, device=cuda)
    tables = _ints(rng.permutation(np.arange(1, nb)).reshape(b, m), cuda)
    top = m * bs - c
    ln = _ints(np.concatenate([[0, top], rng.randint(0, top + 1, 6)])
               if b > 1 else [top // 2 if c == 64 else 0], cuda)
    before = dict(tda.launch_counts)
    got = tda.paged_decode_attention(q, kp, vp, tables, ln)
    want = tda.paged_decode_attention_reference(q, kp, vp, tables, ln)
    torch.cuda.synchronize()
    for key in ("paged_decode_attention", "paged_prefill_attention"):
        assert tda.launch_counts[key] == before[key] + 1
    assert got.shape == (b, c, n, d) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_k6_chunk_route_reads_a_layer_view_of_the_engine_pools(cuda):
    """The engine's operands: one layer of [L, NB, bs, N, D] pools, q a
    view of the fused QKV projection, tables with repeated blocks."""
    rng = np.random.RandomState(10)
    n, d, bs, nb = 12, 64, 8, 17
    pools = _randn(rng, 2, 2, nb, bs, n, d, device=cuda)
    qkv = _randn(rng, 2, 70, 3 * n * d, device=cuda)
    q = qkv[..., :n * d].reshape(2, 70, n, d)
    tab = rng.randint(0, nb, size=(2, 16))
    tables = _ints(tab, cuda)
    ln = _ints([5, 40], cuda)
    got = tda.paged_decode_attention(q, pools[0, 1], pools[1, 1], tables, ln)
    want = tda.paged_decode_attention_reference(q, pools[0, 1], pools[1, 1],
                                                tables, ln)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    rng = np.random.RandomState(1)
    q = _randn(rng, 2, 2, 64, device=cuda)
    k = _randn(rng, 2, 16, 2, 64, device=cuda)
    v = _randn(rng, 2, 16, 2, 64, device=cuda)
    ln = _ints([3, 16], cuda)
    with pytest.raises(EnforceError):
        tda.decode_attention(q.double(), k, v, ln)          # dtype
    with pytest.raises(EnforceError):
        tda.decode_attention(q, k, v, ln.long())             # index dtype
    with pytest.raises(EnforceError):
        tda.decode_attention(q[..., :48], k[..., :48], v[..., :48], ln)
    with pytest.raises(EnforceError):
        tda.decode_attention(q, k.cpu(), v, ln)              # device
    tables = _ints(np.zeros((2, 4)), cuda)
    with pytest.raises(EnforceError):
        tda.paged_decode_attention(q[:, None], k.reshape(8, 4, 2, 64),
                                   v.reshape(8, 4, 2, 64), tables.long(),
                                   ln)


# ---------------------------------------------------------------------
# K7: paged attention over int8 / float8 e4m3 pools with per-row scales
# ---------------------------------------------------------------------

from paddle_tpu_torch.ops.generation import _kv_quantize_rows  # noqa: E402


def _quantized_pools(rng, nb, bs, n, d, kv_dtype, device):
    """Pools quantized by the engine's own row quantizer, with scales."""
    kq, ks = _kv_quantize_rows(3.0 * _randn(rng, nb, bs, n, d,
                                            device=device), kv_dtype)
    vq, vs = _kv_quantize_rows(_randn(rng, nb, bs, n, d, device=device),
                               kv_dtype)
    return kq, vq, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("c,d", [(1, 64), (5, 64), (64, 64), (1, 32),
                                 (9, 128)])
def test_k7_kernel_matches_plain(cuda, kv_dtype, c, d):
    """Tables with repeated and out-of-order blocks (fewer pool blocks
    than table entries), lengths from an empty prefix to a full window."""
    b, n, bs, m = 4, 12, 8, 32
    nb = m + 9
    rng = np.random.RandomState(7)
    q = _randn(rng, b, c, n, d, device=cuda)
    kq, vq, ks, vs = _quantized_pools(rng, nb, bs, n, d, kv_dtype, cuda)
    tab = rng.randint(0, nb, size=(b, m))
    tab[0] = np.arange(m)[::-1]
    tables = _ints(tab, cuda)
    ln = _ints([0, 1, m * bs - c, 100], cuda)
    before = tda.launch_counts["quantized_paged_decode_attention"]
    got = tda.quantized_paged_decode_attention(q, kq, vq, ks, vs, tables,
                                               ln)
    want = tda.quantized_paged_decode_attention_reference(
        q, kq, vq, ks, vs, tables, ln)
    torch.cuda.synchronize()
    assert tda.launch_counts["quantized_paged_decode_attention"] == \
        before + 1
    assert got.shape == (b, c, n, d) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("c", [2, 5, 16, 64, 512])
def test_k7_prefill_route_matches_plain(cuda, c, b, d, kv_dtype):
    """The tensor-core kernel over a shuffled pool (block_size 8, M =
    128), lengths from 0 to a full window, from the shortest chunk (C =
    2) and the verify chunk (C = 5) to the largest prefill bucket; B = 1
    splits the keys, B = 8 at C = 512 does not."""
    n, bs, m = 4, 8, 128
    nb = b * m + 1
    rng = np.random.RandomState(c + b + d)
    q = _randn(rng, b, c, n, d, device=cuda)
    kq, vq, ks, vs = _quantized_pools(rng, nb, bs, n, d, kv_dtype, cuda)
    tables = _ints(rng.permutation(np.arange(1, nb)).reshape(b, m), cuda)
    top = m * bs - c
    ln = _ints(np.concatenate([[0, top], rng.randint(0, top + 1, 6)])
               if b > 1 else [top // 2 if c == 64 else 0], cuda)
    before = dict(tda.launch_counts)
    got = tda.quantized_paged_decode_attention(q, kq, vq, ks, vs, tables,
                                               ln)
    want = tda.quantized_paged_decode_attention_reference(
        q, kq, vq, ks, vs, tables, ln)
    torch.cuda.synchronize()
    for key in ("quantized_paged_decode_attention",
                "quantized_paged_prefill_attention"):
        assert tda.launch_counts[key] == before[key] + 1
    assert got.shape == (b, c, n, d) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_k7_decode_calls_share_a_workspace_and_leave_it_zero(cuda):
    """Decode ticks (C = 1) of several shapes in a row on one stream, the
    keys split into ranges: each call is one launch, right, and leaves
    every counter and record of the shared workspace zero."""
    rng = np.random.RandomState(11)
    for b, n, d, m, kv_dtype in [(8, 12, 64, 128, "int8"),
                                 (3, 4, 128, 64, "fp8_e4m3"),
                                 (8, 12, 64, 128, "fp8_e4m3"),
                                 (2, 2, 32, 200, "int8")]:
        bs = 8
        nb = b * m + 1
        assert tda.decode_split_count(m * bs, d) > 1
        q = _randn(rng, b, 1, n, d, device=cuda)
        kq, vq, ks, vs = _quantized_pools(rng, nb, bs, n, d, kv_dtype, cuda)
        tables = _ints(rng.permutation(np.arange(1, nb)).reshape(b, m), cuda)
        ln = _ints(rng.randint(0, m * bs, size=b), cuda)
        got = tda.quantized_paged_decode_attention(q, kq, vq, ks, vs, tables,
                                                   ln)
        want = tda.quantized_paged_decode_attention_reference(
            q, kq, vq, ks, vs, tables, ln)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= TOL
        work = tda._workspaces[(q.device, tda._stream(q.device))]
        assert int(work.abs().max()) == 0


@pytest.mark.cuda
def test_k7_reads_a_layer_view_of_the_engine_pools(cuda):
    """The engine's operands: one layer of [L, NB, bs, N, D] payload and
    [L, NB, bs] scale pools, q a view of the fused QKV projection."""
    rng = np.random.RandomState(8)
    n, d, bs, nb = 12, 64, 8, 17
    kq, vq, ks, vs = _quantized_pools(rng, 2 * nb, bs, n, d, "int8", cuda)
    kq, vq = kq.reshape(2, nb, bs, n, d), vq.reshape(2, nb, bs, n, d)
    ks, vs = ks.reshape(2, nb, bs), vs.reshape(2, nb, bs)
    qkv = _randn(rng, 2, 3, 3 * n * d, device=cuda)
    q = qkv[..., :n * d].reshape(2, 3, n, d)
    tables = _ints(rng.permutation(np.arange(1, nb))[:16].reshape(2, 8),
                   cuda)
    ln = _ints([5, 40], cuda)
    got = tda.quantized_paged_decode_attention(q, kq[1], vq[1], ks[1],
                                               vs[1], tables, ln)
    want = tda.quantized_paged_decode_attention_reference(
        q, kq[1], vq[1], ks[1], vs[1], tables, ln)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_k7_raises_instead_of_falling_back(cuda):
    rng = np.random.RandomState(9)
    n, d, bs, nb = 2, 64, 8, 6
    kq, vq, ks, vs = _quantized_pools(rng, nb, bs, n, d, "int8", cuda)
    q = _randn(rng, 2, 1, n, d, device=cuda)
    tables = _ints(np.ones((2, 3)), cuda)
    ln = _ints([3, 9], cuda)
    fn = tda.quantized_paged_decode_attention
    before = dict(tda.launch_counts)
    with pytest.raises(EnforceError, match="int8 or float8"):
        fn(q, kq.float(), vq.float(), ks, vs, tables, ln)       # f32 pool
    with pytest.raises(EnforceError, match="do not match"):
        fn(q, kq, vq.view(torch.uint8).view(torch.float8_e4m3fn), ks, vs,
           tables, ln)                                          # mixed
    raw = torch.zeros(kq.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = raw[1:].view(kq.shape)
    with pytest.raises(EnforceError, match="16-byte aligned"):
        fn(q, shifted, vq, ks, vs, tables, ln)                  # misaligned
    with pytest.raises(EnforceError, match="float32"):
        fn(q, kq, vq, ks.double(), vs, tables, ln)              # scale dtype
    with pytest.raises(EnforceError, match="k_scale"):
        fn(q, kq, vq, ks[:, :4], vs, tables, ln)                # scale shape
    with pytest.raises(EnforceError, match="must lie on"):
        fn(q, kq, vq, ks.cpu(), vs, tables, ln)                 # device
    with pytest.raises(EnforceError, match="int32"):
        fn(q, kq, vq, ks, vs, tables.long(), ln)                # index dtype
    assert tda.launch_counts == before


# ---------------------------------------------------------------------
# K1-K4: the flash-attention kernels: bfloat16 on the tensor cores
# (flash_fwd, flash_bwd); float32 on the tensor cores too, every operand
# in three bf16 pieces (flash_fwd_f32, flash_bwd_f32)
# ---------------------------------------------------------------------

from paddle_tpu_torch.ops.kernels import flash_attention as tfa  # noqa: E402

#: max |kernel - plain| / max |plain| per output. float32 (TF32 off):
#: summation order only. bfloat16: both sides start from the same bf16
#: inputs, but the kernels round p (unnormalised, online) and ds to bf16
#: where the plain version rounds the normalised probabilities, and
#: outputs keep 8 bits.
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _flash_case(device, dtype, b, t, n, d, causal=False, pad=False,
                rate=0.0, mask_grad=False, lse=False, seed=0):
    """Kernel and plain version on the same inputs (q, k, v views of one
    fused [B, T, 3, N, D] tensor, as BERT's QKV projection gives them):
    {name: relative error} over o (and lse) and every gradient."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, t, 3, n, d), generator=g, device=device).to(dtype)
    dout = torch.randn((b, t, n, d), generator=g, device=device).to(dtype)
    dlse = torch.randn((b, t, n, 1), generator=g, device=device)
    mask = None
    if pad or mask_grad:
        mask = torch.zeros((b, 1, 1, t), device=device)
        if pad:
            mask[0, ..., t - t // 3:] = -1e9
        if mask_grad:
            mask = mask + 0.5 * torch.randn(mask.shape, generator=g,
                                            device=device)
    kw = dict(causal=causal)
    if not lse:
        kw.update(dropout_rate=rate, dropout_seed=12345 if rate else None,
                  mask_grad=mask_grad)
    results = {}
    for side in ("kernel", "plain"):
        x = qkv.detach().clone().requires_grad_()
        m = None if mask is None else mask.detach().clone().requires_grad_(
            mask_grad)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        if side == "kernel":
            fn = tfa.flash_attention_lse if lse else tfa.flash_attention
            res = fn(q, k, v, mask=m, **kw)
        else:
            keep = (tfa.batch_keep_masks(12345, b, n, t, t, rate,
                                         device=device) if rate else None)
            res = tfa.attention_reference(q, k, v, mask=m, causal=causal,
                                          keep_masks=keep, return_lse=lse)
        o, l = res if lse else (res, None)
        loss = (o.float() * dout.float()).sum()
        if lse:
            loss = loss + (l * dlse).sum()
        loss.backward()
        results[side] = dict(o=o.detach(), dqkv=x.grad)
        if lse:
            results[side]["lse"] = l.detach()
        if mask_grad:
            results[side]["dmask"] = m.grad
    torch.cuda.synchronize()
    return {key: _rel_err(results["kernel"][key], results["plain"][key])
            for key in results["plain"]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(b=2, t=512, n=4, d=64, pad=True),                   # BERT's T
    dict(b=2, t=512, n=4, d=64, pad=True, rate=0.1),         # dropout
    dict(b=1, t=1000, n=2, d=32, causal=True, mask_grad=True),
    dict(b=2, t=200, n=2, d=128, rate=0.2, mask_grad=True),
    dict(b=1, t=300, n=2, d=64, causal=True, lse=True),
    dict(b=1, t=64, n=3, d=64, pad=True),                    # one tile
    dict(b=2, t=512, n=12, d=64, rate=0.1),                  # BERT-base heads
    dict(b=2, t=129, n=2, d=128, causal=True),               # one past a tile
], ids=["bert-T", "dropout", "causal-ragged-dbias", "d128-dropout-dbias",
        "lse", "single-tile", "bert-heads-dropout", "t129-d128-causal"])
def test_flash_kernels_match_plain(cuda, dtype, case):
    before = dict(tfa.launch_counts)
    errs = _flash_case(cuda, dtype, **case)
    fwd, bwd = tfa.KERNELS[dtype]
    # each call launches its dtype's kernels once and no other kernel
    assert tfa.launch_counts == {
        k: n + (k in (fwd, *bwd)) for k, n in before.items()}
    tol = FLASH_TOL[dtype]
    assert all(e <= tol for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_f32_reads_views_that_are_not_16_byte_aligned(cuda, d):
    """q, k, v one float into their buffer (rows 4 bytes past a 16-byte
    boundary) take the forward's 4-byte loads: o and lse as close to the
    plain version as on aligned views, and the f32 kernels launched."""
    b, t, n = 2, 200, 3
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((b, t, 3, n, d), generator=g, device=cuda)
    buf = torch.empty(qkv.numel() + 1, device=cuda)
    buf[1:].copy_(qkv.reshape(-1))
    x = buf[1:].view(qkv.shape)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    assert q.data_ptr() % 16 == 4
    mask = 0.5 * torch.randn((b, 1, 1, t), generator=g, device=cuda)
    before = tfa.launch_counts["flash_fwd_f32"]
    o, lse = tfa.flash_attention_lse(q, k, v, mask=mask, causal=True)
    want, want_lse = tfa.attention_reference(q, k, v, mask, causal=True,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert tfa.launch_counts["flash_fwd_f32"] == before + 1
    assert _rel_err(o, want) <= FLASH_TOL[torch.float32]
    assert _rel_err(lse, want_lse) <= FLASH_TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset-view"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_f32_backward_matches_plain(cuda, d, offset):
    """The f32 backward kernel (flash_bwd_f32: dQ, dK, dV and dbias from
    one launch on the tensor cores) at every head dim, T = 200 (not a
    multiple of 64), causal, mask_grad and dropout 0.1, on q, k, v views
    of a fused tensor that starts `offset` floats into its buffer (one
    float: rows 4 bytes past a 16-byte boundary). dQ and dmask are summed
    with atomics, so they are held to the tolerance, not to bits."""
    b, t, n = 2, 200, 3
    g = torch.Generator(device=cuda).manual_seed(11 + d)
    qkv = torch.randn((b, t, 3, n, d), generator=g, device=cuda)
    dout = torch.randn((b, t, n, d), generator=g, device=cuda)
    mask = 0.5 * torch.randn((b, 1, 1, t), generator=g, device=cuda)
    keep = tfa.batch_keep_masks(12345, b, n, t, t, 0.1, device=cuda)
    grads = {}
    for side in ("kernel", "plain"):
        buf = torch.empty(qkv.numel() + offset, device=cuda)
        buf[offset:].copy_(qkv.reshape(-1))
        buf.requires_grad_()
        x = buf[offset:].view(qkv.shape)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        m = mask.clone().requires_grad_()
        before = dict(tfa.launch_counts)
        if side == "kernel":
            assert q.data_ptr() % 16 == 4 * offset
            o = tfa.flash_attention(q, k, v, m, causal=True,
                                    dropout_rate=0.1, dropout_seed=12345,
                                    mask_grad=True)
        else:
            o = tfa.attention_reference(q, k, v, m, True, keep_masks=keep)
        (o * dout).sum().backward()
        want = ({"flash_fwd_f32", "flash_bwd_f32"} if side == "kernel"
                else set())
        assert {kname for kname, c in tfa.launch_counts.items()
                if c != before[kname]} == want
        grads[side] = (buf.grad[offset:].view(qkv.shape), m.grad)
    torch.cuda.synchronize()
    (gx, gm), (wx, wm) = grads["kernel"], grads["plain"]
    errs = {name: _rel_err(gx[:, :, i], wx[:, :, i])
            for i, name in enumerate(("dq", "dk", "dv"))}
    errs["dmask"] = _rel_err(gm, wm)
    assert all(e <= FLASH_TOL[torch.float32] for e in errs.values()), errs


@pytest.mark.cuda
def test_flash_dropout_keeps_the_rate_and_varies_with_the_seed(cuda):
    b, t, n, d = 1, 256, 2, 64
    q = torch.ones((b, t, n, d), device=cuda)
    v = torch.ones((b, t, n, d), device=cuda)
    # uniform attention over ones: o = fraction kept / (1 - p)
    o1 = tfa.flash_attention(q, q, v, dropout_rate=0.25, dropout_seed=1)
    o2 = tfa.flash_attention(q, q, v, dropout_rate=0.25, dropout_seed=2)
    torch.cuda.synchronize()
    assert abs(float(o1.mean()) - 1.0) < 0.02
    assert not torch.equal(o1, o2)


@pytest.mark.cuda
def test_flash_raises_instead_of_falling_back(cuda):
    before = dict(tfa.launch_counts)
    q = torch.randn((1, 16, 2, 48), device=cuda)
    with pytest.raises(EnforceError, match="head dim"):
        tfa.flash_attention(q, q, q)
    q = torch.randn((1, 16, 2, 64), device=cuda)
    with pytest.raises(EnforceError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(EnforceError, match="device"):
        tfa.flash_attention(q, q.cpu(), q)
    assert tfa.launch_counts == before


# ---------------------------------------------------------------------
# K8: fused dequant matmul
# ---------------------------------------------------------------------

from paddle_tpu_torch.ops.kernels import quantized_matmul as tk8  # noqa: E402


def _k8_inputs(m, k, n, bits, device, seed=5):
    rng = np.random.RandomState(seed + m + k)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    qm = 2 ** (bits - 1) - 1
    scale = np.maximum(np.abs(w).max(axis=0), 1e-8).astype(np.float32)
    w_q = np.clip(np.round(w / scale * qm), -qm, qm).astype(np.int8)
    x_scale = float(np.abs(x).max()) * 0.7
    return (torch.from_numpy(x).to(device), torch.from_numpy(w_q).to(device),
            torch.from_numpy(scale).to(device), x_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(5, 33, 17), (130, 257, 129),
                                   (32, 2048, 1000), (1, 64, 64),
                                   (64, 32, 64), (1, 2048, 1000),
                                   (8, 2048, 1000), (4096, 768, 3072)])
@pytest.mark.parametrize("bits", [8, 4])
def test_k8_int8_mode_matches_plain(cuda, m, k, n, bits):
    """Codes, int32 accumulators and outputs bit-equal to the plain
    version (the same IEEE operations in the same order; gate 1 ulp)."""
    x, w_q, w_s, xs = _k8_inputs(m, k, n, bits, cuda)
    before = tk8.launch_counts["quantized_matmul"]
    got, acc = tk8.fused_dequant_matmul(x, w_q, w_s, x_scale=xs, bits=bits,
                                        return_acc=True)
    want, want_acc = tk8.dequant_matmul_reference(x, w_q, w_s, x_scale=xs,
                                                  bits=bits, return_acc=True)
    torch.cuda.synchronize()
    assert tk8.launch_counts["quantized_matmul"] == before + 1
    assert torch.equal(acc, want_acc)
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long())
    assert int(ulps.abs().max()) <= 1


@pytest.mark.cuda
def test_k8_split_calls_share_a_workspace_and_leave_it_zero(cuda):
    """Split-K calls of several shapes in a row on one stream reuse one
    workspace: each stays exact and leaves every sum and counter zero."""
    for m, k, n in [(32, 2048, 1000), (130, 257, 129), (1, 2048, 1000),
                    (32, 2048, 1000)]:
        assert tk8.k8_plan(m, k, n)["splits"] > 1
        x, w_q, w_s, xs = _k8_inputs(m, k, n, 8, cuda)
        _, acc = tk8.fused_dequant_matmul(x, w_q, w_s, x_scale=xs,
                                          return_acc=True)
        _, want = tk8.dequant_matmul_reference(x, w_q, w_s, x_scale=xs,
                                               return_acc=True)
        torch.cuda.synchronize()
        assert torch.equal(acc, want)
        work = tk8._workspaces[(x.device, tk8._stream(x.device))]
        assert int(work.abs().max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(5, 33, 17), (130, 257, 129),
                                   (32, 2048, 1000), (1, 2048, 1000),
                                   (8, 2048, 1000), (16, 1000, 48),
                                   (64, 512, 256), (4096, 768, 3072),
                                   (3, 4, 5)])
def test_k8_weight_only_mode_matches_plain(cuda, m, k, n):
    """x in three bf16 pieces against the codes on the tensor cores:
    within 1e-5 of max |plain| (summation order), and the same bits from
    a second call (split-K partials summed in split order)."""
    x, w_q, w_s, _ = _k8_inputs(m, k, n, 8, cuda)
    before = dict(tk8.launch_counts)
    got = tk8.fused_dequant_matmul(x, w_q, w_s)
    again = tk8.fused_dequant_matmul(x, w_q, w_s)
    want = tk8.dequant_matmul_reference(x, w_q, w_s)
    torch.cuda.synchronize()
    assert tk8.launch_counts == {k: v + 2 for k, v in before.items()}
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_k8_weight_only_split_calls_leave_their_counters_zero(cuda):
    """Split weight-only calls of several shapes on one stream share one
    workspace (a call with fewer tiles and more partials after one with
    more tiles, then that one again); each stays right and leaves every
    arrival counter zero."""
    for m, k, n in [(32, 2048, 1000), (1, 2048, 1000), (130, 257, 129),
                    (32, 2048, 1000)]:
        assert tk8.k8_plan(m, k, n, int8_mode=False)["splits"] > 1
        x, w_q, w_s, _ = _k8_inputs(m, k, n, 8, cuda)
        got = tk8.fused_dequant_matmul(x, w_q, w_s)
        want = tk8.dequant_matmul_reference(x, w_q, w_s)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
        work = tk8._wo_workspaces[(x.device, tk8._stream(x.device))]
        assert int(work[:256].abs().max()) == 0


@pytest.mark.cuda
def test_k8_raises_instead_of_falling_back(cuda):
    x, w_q, w_s, xs = _k8_inputs(4, 16, 8, 8, cuda)
    before = tk8.launch_counts["quantized_matmul"]
    with pytest.raises(EnforceError, match="int8"):
        tk8.fused_dequant_matmul(x, w_q.float(), w_s, x_scale=xs)
    with pytest.raises(EnforceError, match="contiguous"):
        tk8.fused_dequant_matmul(x.t(), w_q, w_s, x_scale=xs)
    with pytest.raises(EnforceError, match="must lie on"):
        tk8.fused_dequant_matmul(x, w_q.cpu(), w_s, x_scale=xs)
    assert tk8.launch_counts["quantized_matmul"] == before
