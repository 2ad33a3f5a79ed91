"""Decode-attention kernels K5 and K6 of the port (CPU + card).

On the CPU the wrappers take their plain PyTorch versions; these are
held against the JAX package's references and against the Pallas
kernels run under the interpreter, as the JAX package's own tests run
them (tests/test_generation.py, tests/test_paged_generation.py), on the
same numpy-seeded inputs, at atol/rtol 1e-5 (float32; the kernels sum in
another order). The CUDA kernels themselves run only on a card; their
tests are in tests/test_torch_kernels_cuda.py.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import decode_attention as tda

# the package re-exports a function of the module's name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _k5_inputs(seed, b, s, n, d, lengths):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, d).astype(np.float32),
            rng.randn(b, s, n, d).astype(np.float32),
            rng.randn(b, s, n, d).astype(np.float32),
            np.asarray(lengths, np.int32))


def _k6_inputs(seed, b, c, n, d, nb, bs, m, lengths):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, c, n, d).astype(np.float32),
            rng.randn(nb, bs, n, d).astype(np.float32),
            rng.randn(nb, bs, n, d).astype(np.float32),
            rng.randint(1, nb, size=(b, m)).astype(np.int32),
            np.asarray(lengths, np.int32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------
# K5: contiguous cache
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,lengths", [
    ((3, 24, 4, 16), [1, 13, 24]),          # the JAX test's case
    ((4, 20, 2, 8), [0, 20, 7, 1]),         # empty and full windows
    ((2, 37, 3, 32), [37, 19]),             # S prime: no block divides it
])
def test_k5_plain_matches_jax_reference(shape, lengths):
    arrays = _k5_inputs(5, *shape, lengths)
    want = jfa.decode_attention_reference(*_jax(*arrays))
    got = tda.decode_attention(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


@pytest.mark.parametrize("block_k", [8, 16, 32])
def test_k5_plain_matches_interpreted_pallas_kernel(block_k):
    """block_k 16 does not divide S=24 and 32 exceeds it (the Pallas
    wrapper pads); lengths cover 0, partial and full windows.

    A length-0 slot is where the two JAX functions disagree: the
    reference returns zeros, while the Pallas kernel's online softmax
    sees every logit at NEG_INF, so exp(s - m) is 1 and the row comes
    out as the mean of V over the (padded) keys. The port follows the
    reference (zeros); the JAX engines never pass a length of 0 to the
    kernel (a decode step attends to at least the token it just
    wrote)."""
    arrays = _k5_inputs(6, 3, 24, 4, 16, [0, 13, 24])
    want = np.asarray(jfa.flash_decode_attention(
        *_jax(*arrays), use_kernel=True, interpret=True, block_k=block_k))
    got = tda.decode_attention(*_torch(*arrays)).numpy()
    np.testing.assert_allclose(got[1:], want[1:], **TOL)
    assert not got[0].any()
    v_sum = arrays[2][0].sum(axis=0)
    padded = int(round(v_sum.flat[0] / want[0].flat[0]))
    assert padded in (24, 32)
    np.testing.assert_allclose(want[0], v_sum / padded, **TOL)


@pytest.mark.parametrize("sm_scale", [0.3, 1.7])
def test_k5_sm_scale_matches_flash_decode_attention(sm_scale):
    """An sm_scale that is not 1/sqrt(D) reaches the plain version, as
    flash_decode_attention's (reference and interpreted kernel) take it;
    None keeps 1/sqrt(D)."""
    arrays = _k5_inputs(8, 3, 24, 4, 16, [5, 13, 24])
    got = tda.decode_attention(*_torch(*arrays), sm_scale=sm_scale).numpy()
    for use_kernel in (False, True):
        want = np.asarray(jfa.flash_decode_attention(
            *_jax(*arrays), sm_scale=sm_scale, use_kernel=use_kernel,
            interpret=True, block_k=8))
        np.testing.assert_allclose(got, want, **TOL)
    default = tda.decode_attention(*_torch(*arrays)).numpy()
    np.testing.assert_allclose(default, tda.decode_attention(
        *_torch(*arrays), sm_scale=0.25).numpy(), **TOL)
    assert np.abs(got - default).max() > 1e-3


def test_k5_reads_a_strided_layer_view():
    """The engine hands K5 `cache[li]` of a stacked [L, B, S, N, D]
    cache and q as a view of the fused QKV projection."""
    rng = np.random.RandomState(7)
    stacked = torch.from_numpy(rng.randn(3, 2, 10, 2, 8).astype(np.float32))
    qkv = torch.from_numpy(rng.randn(2, 3 * 16).astype(np.float32))
    q = qkv[:, :16].reshape(2, 2, 8)
    assert not q.is_contiguous()
    lengths = torch.tensor([4, 10], dtype=torch.int32)
    got = tda.decode_attention(q, stacked[1], stacked[2], lengths)
    want = jfa.decode_attention_reference(
        jnp.asarray(q.contiguous().numpy()), jnp.asarray(stacked[1].numpy()),
        jnp.asarray(stacked[2].numpy()), jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------
# K6: paged pools
# ---------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 5, 8])
def test_k6_plain_matches_interpreted_pallas_kernel(c):
    arrays = _k6_inputs(5, 3, c, 2, 16, 10, 4, 6, [0, 7, 24 - c])
    want = jfa.flash_paged_decode_attention(*_jax(*arrays),
                                            use_kernel=True,
                                            interpret=True)
    got = tda.paged_decode_attention(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [16, 32])
def test_k6_plain_matches_jax_reference(c):
    """Chunks beyond the TPU kernel's 8 rows (prefill continuation)."""
    arrays = _k6_inputs(9, 2, c, 3, 8, 40, 8, 6, [0, 48 - c])
    want = jfa.paged_decode_attention_reference(*_jax(*arrays))
    got = tda.paged_decode_attention(*_torch(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k6_contiguous_tables_reproduce_k5():
    """A paged layout that happens to be contiguous reproduces the
    contiguous kernel's rows (C=1, row limit lengths+1)."""
    rng = np.random.RandomState(3)
    b, s, n, d, bs = 2, 16, 2, 8, 4
    q = torch.from_numpy(rng.randn(b, 1, n, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
    tables = torch.arange(b * s // bs, dtype=torch.int32).reshape(b, -1)
    lengths = torch.tensor([3, 15], dtype=torch.int32)
    paged = tda.paged_decode_attention(
        q, k.reshape(-1, bs, n, d), v.reshape(-1, bs, n, d), tables,
        lengths)
    flat = tda.decode_attention(q[:, 0], k, v, lengths + 1)
    np.testing.assert_allclose(paged[:, 0].numpy(), flat.numpy(), **TOL)


# ---------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tda.reset_launch_counts()
    arrays = _k5_inputs(1, 2, 8, 2, 8, [3, 8])
    tda.decode_attention(*_torch(*arrays))
    arrays = _k6_inputs(1, 2, 3, 2, 8, 6, 4, 3, [0, 5])
    q, kp, vp, tables, lengths = _torch(*arrays)
    tda.paged_decode_attention(q, kp, vp, tables, lengths)
    tda.quantized_paged_decode_attention(
        q, kp.to(torch.int8), vp.to(torch.int8), kp[..., 0, 0].abs(),
        vp[..., 0, 0].abs(), tables, lengths)
    assert tda.launch_counts == {"decode_attention": 0,
                                 "paged_decode_attention": 0,
                                 "paged_prefill_attention": 0,
                                 "quantized_paged_decode_attention": 0,
                                 "quantized_paged_prefill_attention": 0}


@pytest.mark.parametrize("blocks,capacity,want", [
    (96, 1024, 6),        # 96 tiles (K7's prefill route at B=8, N=12,
                          # C <= 64): split-K fills the card
    (12 * 64 * 8, 1024, 1),   # prefill tiles fill it alone
    (1, 1024, 16),        # capped
    (1, 40, 2),           # never fewer than 32 keys per range
])
def test_split_count(blocks, capacity, want):
    assert tda.split_count(blocks, capacity) == want


def test_library_is_named_by_its_sources():
    from paddle_tpu_torch.ops.kernels import _build
    path = _build.library_path()
    assert path.startswith(_build._BUILD + "/libptt_kernels_")
    assert path == _build.library_path()
    assert set(_build.SIGNATURES) == {"ptt_decode_attention_f32",
                                      "ptt_paged_decode_attention_f32",
                                      "ptt_paged_prefill_attention_f32",
                                      "ptt_quantized_paged_decode_attention",
                                      "ptt_quantized_paged_prefill_attention",
                                      "ptt_flash_fwd", "ptt_flash_bwd",
                                      "ptt_flash_fwd_f32",
                                      "ptt_flash_bwd_f32",
                                      "ptt_quantized_matmul",
                                      "ptt_quantized_matmul_plan"}
