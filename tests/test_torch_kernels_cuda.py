"""K5 and K6 on the card: each CUDA kernel against its plain PyTorch
version, the launch counters, and the wrappers' input checks.

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
    ((3, 24, 4, 32), [0, 13, 24]),
    ((2, 100, 2, 128), [57, 100]),
])
def test_k5_kernel_matches_plain(cuda, shape, lengths):
    b, s, n, d = shape
    rng = np.random.RandomState(2)
    q = _randn(rng, b, n, d, device=cuda)
    k = _randn(rng, b, s, n, d, device=cuda)
    v = _randn(rng, b, s, n, d, device=cuda)
    ln = _ints(lengths, cuda)
    before = tda.launch_counts["decode_attention"]
    got = tda.decode_attention(q, k, v, ln)
    want = tda.decode_attention_reference(q, k, v, ln)
    torch.cuda.synchronize()
    assert tda.launch_counts["decode_attention"] == before + 1
    assert float((got - want).abs().max()) <= TOL
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
@pytest.mark.parametrize("c", [1, 5, 8, 9, 512])
def test_k6_kernel_matches_plain(cuda, c):
    b, n, d, bs, m = 4, 12, 64, 8, 128
    nb = b * m + 1
    rng = np.random.RandomState(4)
    q = _randn(rng, b, c, n, d, device=cuda)
    kp = _randn(rng, nb, bs, n, d, device=cuda)
    vp = _randn(rng, nb, bs, n, d, device=cuda)
    tables = _ints(rng.permutation(np.arange(1, nb)).reshape(b, m), cuda)
    ln = _ints([0, 1, m * bs - c, 300], cuda)
    before = tda.launch_counts["paged_decode_attention"]
    got = tda.paged_decode_attention(q, kp, vp, tables, ln)
    want = tda.paged_decode_attention_reference(q, kp, vp, tables, ln)
    torch.cuda.synchronize()
    assert tda.launch_counts["paged_decode_attention"] == before + 1
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
# K1-K4: the flash-attention forward, dK/dV and dQ kernels
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
], ids=["bert-T", "dropout", "causal-ragged-dbias", "d128-dropout-dbias",
        "lse", "single-tile"])
def test_flash_kernels_match_plain(cuda, dtype, case):
    before = dict(tfa.launch_counts)
    errs = _flash_case(cuda, dtype, **case)
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert tfa.launch_counts[k] == before[k] + 1, k
    tol = FLASH_TOL[dtype]
    assert all(e <= tol for e in errs.values()), errs


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
