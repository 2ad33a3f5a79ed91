"""Flash attention of the port (kernels K1-K4): the plain versions on CPU.

On the CPU `flash_attention` / `flash_attention_lse` take their plain
PyTorch versions. These are held against the JAX package's
`flash_attention` / `flash_attention_lse` run as its own tests run them
on the CPU (the Pallas kernels under the interpreter), on the same
numpy-seeded inputs: forward values and the gradients of one scalar
loss, from `jax.grad` on one side and `torch.autograd` on the other.
Tolerances, float32: outputs 2e-5, gradients 5e-4 (atol = rtol), the
bounds of the JAX package's own tests; the two sides sum in different
orders and the Pallas kernels run an online softmax. The dropout mask
must agree bit for bit. The CUDA kernels run only on a card
(tests/test_torch_kernels_cuda.py).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

# the package re-exports a function of the module's name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(seed, b, t, n, d, masked_tail=None, mask_noise=False):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, t, n, d).astype(np.float32) for _ in range(3))
    mask = None
    if masked_tail is not None:
        keep = np.ones((b, t), np.float32)
        keep[0, masked_tail:] = 0.0
        mask = ((1.0 - keep) * -1e9)[:, None, None, :].astype(np.float32)
    if mask_noise:
        mask = rng.randn(b, 1, 1, t).astype(np.float32) * 0.5
    return q, k, v, mask


def _jax_seed(key):
    """The integer seed the JAX wrapper derives from its dropout key."""
    return int(jax.random.randint(jax.random.PRNGKey(key), (1,), 0, 1 << 23)[0])


def _run_jax(q, k, v, mask, causal, block, rate, key, mask_grad, lse):
    kw = dict(causal=causal, block_q=block, block_k=block)

    def loss(q, k, v, m):
        if lse:
            o, l = jfa.flash_attention_lse(q, k, v, mask=m, **kw)
            return jnp.sum(o * jnp.cos(o)) + jnp.sum(jnp.sin(l)), o
        o = jfa.flash_attention(
            q, k, v, mask=m, dropout_rate=rate, mask_grad=mask_grad,
            dropout_rng=jax.random.PRNGKey(key) if rate else None, **kw)
        return jnp.sum(o * jnp.cos(o)), o

    args = [jnp.asarray(a) for a in (q, k, v)]
    argnums = (0, 1, 2)
    if mask is not None:
        argnums = (0, 1, 2, 3)
    (val, out), grads = jax.value_and_grad(loss, argnums=argnums,
                                           has_aux=True)(
        *args, None if mask is None else jnp.asarray(mask))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _run_torch(q, k, v, mask, causal, rate, seed, mask_grad, lse):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask.copy()).requires_grad_()
    if lse:
        o, l = tfa.flash_attention_lse(*ts, mask=m, causal=causal)
        loss = (o * torch.cos(o)).sum() + torch.sin(l).sum()
    else:
        o = tfa.flash_attention(*ts, mask=m, causal=causal, dropout_rate=rate,
                                dropout_seed=seed, mask_grad=mask_grad)
        loss = (o * torch.cos(o)).sum()
    loss.backward()
    grads = [t.grad.numpy() for t in ts]
    if m is not None:
        grads.append(np.zeros_like(mask) if m.grad is None else m.grad.numpy())
    return o.detach().numpy(), grads


CASES = {
    # name: (t, block, causal, masked_tail, rate, mask_grad, lse)
    "single-tile": (64, None, False, None, 0.0, False, False),
    "single-tile-causal": (64, None, True, None, 0.0, False, False),
    "general": (64, 32, False, None, 0.0, False, False),
    "general-causal": (64, 32, True, None, 0.0, False, False),
    "single-tile-padding-mask": (64, None, False, 50, 0.0, False, False),
    "general-padding-mask": (64, 32, False, 50, 0.0, False, False),
    "unaligned-single-tile": (100, None, False, 70, 0.0, False, False),
    "unaligned-general-causal": (100, 32, True, None, 0.0, False, False),
    "single-tile-dropout": (64, None, False, 50, 0.2, False, False),
    "general-dropout": (64, 32, False, 50, 0.2, False, False),
    "general-causal-dropout": (64, 32, True, None, 0.25, False, False),
    "single-tile-mask-grad": (64, None, False, "noise", 0.0, True, False),
    "general-mask-grad-dropout": (64, 32, False, "noise", 0.2, True, False),
    "lse-single-tile": (64, None, True, None, 0.0, False, True),
    "lse-general": (64, 32, True, None, 0.0, False, True),
    "lse-general-padding-mask": (64, 32, False, 50, 0.0, False, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_interpreted_pallas(name):
    t, block, causal, tail, rate, mask_grad, lse = CASES[name]
    b, n, d = (1, 2, 64) if "dropout" in name else (2, 2, 32)
    q, k, v, mask = _inputs(len(name), b, t, n, d,
                            masked_tail=None if tail == "noise" else tail,
                            mask_noise=tail == "noise")
    key = 7
    seed = _jax_seed(key) if rate else None
    want_o, want_g = _run_jax(q, k, v, mask, causal, block, rate, key,
                              mask_grad, lse)
    got_o, got_g = _run_torch(q, k, v, mask, causal, rate, seed, mask_grad,
                              lse)
    np.testing.assert_allclose(got_o, want_o, **OUT_TOL)
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    if mask is not None and not mask_grad:
        assert not np.any(want_g[3]) and not np.any(got_g[3])


@pytest.mark.parametrize("seed,bh,t", [
    (0, 0, 64), (1, 5, 96), (123457, 383, 128), ((1 << 23) - 1, 7, 64),
    ((1 << 23) - 2, 0, 1024),
])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_bit_identical_to_numpy_oracle(seed, bh, t, rate):
    want = jfa._np_keep_mask(seed, bh, t, t, rate)
    got = tfa.keep_mask_reference(seed, bh, t, t, rate).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_batch_keep_masks_lead_with_batch_and_head():
    b, n, t, rate, seed = 2, 3, 16, 0.3, 99
    masks = tfa.batch_keep_masks(seed, b, n, t, t, rate)
    assert masks.shape == (b, n, t, t)
    for bi in range(b):
        for ni in range(n):
            np.testing.assert_array_equal(
                masks[bi, ni].numpy(),
                jfa._np_keep_mask(seed, bi * n + ni, t, t, rate))


def test_attention_reference_matches_jax_reference():
    q, k, v, mask = _inputs(3, 2, 48, 2, 32, masked_tail=30)
    keep = tfa.batch_keep_masks(5, 2, 2, 48, 48, 0.1)
    want = jfa.attention_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                   mask=jnp.asarray(mask), causal=True,
                                   keep_masks=jnp.asarray(keep.numpy()))
    got = tfa.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                  mask=torch.from_numpy(mask), causal=True,
                                  keep_masks=keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_keep_rate_statistics():
    rate = 0.1
    m = tfa.keep_mask_reference(1234, torch.arange(8), 256, 256, rate)
    kept = float((m > 0).float().mean())
    assert abs(kept - (1 - rate)) < 0.005
    assert np.allclose(m[m > 0].numpy(), np.float32(1) / np.float32(0.9))
    assert not torch.equal(m[0], m[1])


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tfa.reset_launch_counts()
    q, k, v, _ = (torch.from_numpy(a) if a is not None else None
                  for a in _inputs(1, 1, 16, 2, 32))
    tfa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=3)
    tfa.flash_attention_lse(q, k, v, causal=True)
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_bwd": 0,
                                 "flash_fwd_f32": 0, "flash_bwd_f32": 0}


def test_arguments_are_checked_before_any_dispatch():
    q, k, v, _ = (torch.from_numpy(a) if a is not None else None
                  for a in _inputs(1, 1, 16, 2, 32))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="2\\*\\*23"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=1 << 23)
    with pytest.raises(ValueError, match="dropout_rate"):
        tfa.flash_attention(q, k, v, dropout_rate=1.0, dropout_seed=1)
