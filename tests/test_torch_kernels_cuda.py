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
