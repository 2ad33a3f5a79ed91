"""Sequence parallelism of the port against the JAX package, on the CPU
(4 gloo ranks, the sequence split over `sp`).

* ring, ring_flash, ulysses and ulysses_flash attention (the flash
  wrappers on their plain path: CPU tensors) with a padding mask, with
  and without causal masking: each rank's output shard and the
  gradients of its q, k, v shards against the JAX package's
  `attention_reference` over the whole sequence and `jax.vjp` of it
  (rtol 1e-4, atol 1e-5); the plain ring also against the JAX
  `shard_map_attention(impl="ring")` on a 4-device mesh.
* a 2-D dp×sp mesh (batch over dp=2, sequence over sp=2), ring_flash,
  causal.
"""
import os

import numpy as np
import pytest

import jax

from paddle_tpu.ops.pallas.flash_attention import attention_reference
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.context_parallel import shard_map_attention
from paddle_tpu_torch.parallel.ranks import RankPool

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_parallel_ranks.py")
WORLD = 4
B, T, N, D = 2, 16, 4, 8


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", device="cpu",
                 store=str(tmp_path_factory.mktemp("ranks") / "store"),
                 timeout=90)
    try:
        yield p
    finally:
        p.close(kill=True)


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    q, k, v, cot = (r.randn(B, T, N, D).astype(np.float32)
                    for _ in range(4))
    mask = np.zeros((B, 1, 1, T), np.float32)
    mask[1, ..., -5:] = -1e9                  # padded keys of example 1
    return q, k, v, mask, cot


def _oracle(q, k, v, mask, cot, causal):
    def f(q, k, v):
        return attention_reference(q, k, v, mask=mask, causal=causal)
    out, vjp = jax.vjp(f, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(cot)]


def _assemble(got, batch_split=1, seq_split=WORLD):
    """Global [B, T, ...] arrays from the ranks' (coords, out, grads)."""
    def cat(pick):
        rows = []
        for bi in range(batch_split):
            parts = sorted((c[1], pick(o, g)) for c, o, g in got
                           if c[0] == bi)
            rows.append(np.concatenate([p for _, p in parts], axis=1))
        return np.concatenate(rows, axis=0)
    return (cat(lambda o, g: o),
            [cat(lambda o, g, i=i: g[i]) for i in range(3)])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ring_flash", "ulysses",
                                  "ulysses_flash"])
def test_sequence_parallel_attention_matches_jax(pool, impl, causal):
    q, k, v, mask, cot = _inputs()
    want, wgrads = _oracle(q, k, v, mask, cot, causal)
    got = pool.run(RANKS, "attention", impl, q, k, v, mask, cot, causal,
                   {"sp": WORLD})
    out, grads = _assemble(got)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    if impl == "ring":
        mesh = jmake_mesh({"sp": WORLD}, devices=jax.devices()[:WORLD])
        ring = jax.jit(lambda *a: shard_map_attention(
            mesh, *a, causal=causal, impl="ring"))(q, k, v, mask)
        np.testing.assert_allclose(out, np.asarray(ring), rtol=1e-4,
                                   atol=1e-5)


def test_ring_flash_2d_dp_x_sp(pool):
    q, k, v, mask, cot = _inputs(1)
    want, wgrads = _oracle(q, k, v, mask, cot, True)
    got = pool.run(RANKS, "attention", "ring_flash", q, k, v, mask, cot,
                   True, {"dp": 2, "sp": 2}, batch_axis="dp")
    out, grads = _assemble(got, batch_split=2, seq_split=2)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
