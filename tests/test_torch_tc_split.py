"""The numerics of K7's prefill route, on the CPU, before any card.

The prefill kernel (`qattn_prefill_tc_kernel` in
paddle_tpu_torch/csrc/decode_attention.cu) runs both products of K7 on
the bf16 tensor cores yet is held to the float32 kernel's tolerance
(max |kernel - plain| <= 2e-5). Two facts carry that design, and this
file checks both in PyTorch on the CPU:

* every int8 code and every finite float8 e4m3 value is exact in bf16,
  so the key and value codes enter the tensor cores unrounded;
* q, and p * s_v, split into three bf16 pieces h = bf16(x),
  m = bf16(x - h), l = bf16(x - h - m), carry all 24 bits of a float32,
  and a product of a piece and a code is exact in float32.

`tc_prefill_emulation` repeats the kernel's arithmetic (64-key tiles,
the pieces summed in float32, s = S * s_k * scale, the online softmax,
a fresh float32 sum of each tile's P.V added to O) and is held against
the port's plain version and the JAX package's reference at C = 16 and
512. With two pieces the same emulation misses the tolerance: that is
why the kernel spends three products where bf16 would spend one.

K6's chunk kernel (`paged_prefill_tc_kernel`) has f32 keys and values,
which bf16 does not hold exactly, so k and v are split into three pieces
too and each product is a sum of piece products. `tc_paged_emulation`
repeats that arithmetic for a chosen set of piece pairs (i, j), i the
piece of q (or p), j of k (or v): the six pairs with i + j <= 2 that the
kernel runs meet the tolerance at D = 32, 64 and 128, C = 2, 16 and
512, against the JAX package's reference; every set of five misses it.

Two more kernels rest on the same pieces:

* K8's weight-only mode (`qmm_weight_only_tc_kernel` in
  csrc/quantized_matmul.cu): x in three pieces against the int8 codes,
  a fresh float32 sum per 64-k tile added into a running sum.
  `k8_weight_only_emulation` meets K8_WO_TOL (1e-5 of max |plain|) at
  every shape of chip_smoke's phase 11 with a wide margin. Two pieces
  meet it as well (2.5e-6 to 3.2e-6 here), at three times or more the
  error of three; one piece (x in bf16) misses it a hundredfold. The
  kernel keeps three: the margin is what the tensor cores' own
  summation order may spend.
* The f32 flash forward (`flash_fwd_f32_tc_kernel` in
  csrc/flash_fwd_f32_tc.cu): q, k, v and p in pieces, the six pairs,
  s = S * scale + bias, causal, the dropout keep mask, lse.
  `flash_f32_emulation` stays within half of the card's tolerance
  (FLASH_TOL["float32"] = 1e-5 of max |plain|) of the JAX package's
  `attention_reference` at T = 1024 and within 1e-6, the level of the
  CUDA-core f32 kernel it replaces (4.4e-7 on the card); every set of
  five pairs is past 1e-6 (2.7e-6 to 4.2e-6 here), though inside the
  1e-5 gate.
* The f32 flash backward (`flash_bwd_f32_tc_kernel` in
  csrc/flash_bwd_f32_tc.cu): q, k, v, dO, p x keep and ds in pieces,
  each of its five products over the six pairs. `flash_f32_bwd_emulation`
  keeps dq, dk, dv and dmask within a quarter of the card's gate of the
  plain version at D = 32, 64 and 128 (T = 1024, causal, bias,
  mask_grad, dropout); every set of five pairs also meets the gate
  there, at 2.5x the six pairs' error or more.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.quantized_matmul import (
    dequant_matmul_reference as jax_dequant_matmul)
from paddle_tpu_torch.ops import generation as tgen
from paddle_tpu_torch.ops.kernels import decode_attention as tda
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import quantized_matmul as tk8
from paddle_tpu_torch.weights import kv_to_numpy

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

#: the card's tolerance for K7 (chip_smoke phase 2)
TOL = 2e-5
QUANT = ("int8", "fp8_e4m3")


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def split_pieces(x, pieces=3):
    """x (float32) as `pieces` bf16 values, largest first, whose float32
    sum is x to within the last piece's rounding."""
    out, rest = [], x
    for _ in range(pieces):
        p = _bf16(rest)
        out.append(p)
        rest = rest - p
    return out


def tc_prefill_emulation(q, k_pool, v_pool, k_scale, v_scale, tables,
                         lengths, pieces=3, key_tile=64):
    """K7 as the prefill kernel computes it, in float32 on the CPU:
    S = sum over q's pieces of piece . codes^T, s = S * s_k * scale,
    masked to keys < lengths[b] + row + 1; an online softmax over tiles
    of `key_tile` keys; O_tile = sum over (p * s_v)'s pieces of
    piece . V codes, O = O * corr + O_tile; out = O / l."""
    b, c, n, d = q.shape
    bs, m = k_pool.shape[1], tables.shape[1]
    idx = tables.long().clamp(0, k_pool.shape[0] - 1)
    codes_k = tda._payload_window(k_pool, idx).reshape(b, m * bs, n, d)
    codes_v = tda._payload_window(v_pool, idx).reshape(b, m * bs, n, d)
    ks = k_scale[idx].reshape(b, m * bs)
    vs = v_scale[idx].reshape(b, m * bs)
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    for bi in range(b):
        lim = (int(lengths[bi]) + torch.arange(c) + 1).clamp(max=m * bs)
        n_keys = int(lim.max())
        for h in range(n):
            qp = split_pieces(q[bi, :, h], pieces)              # [C, D] each
            o = torch.zeros(c, d)
            mx = torch.full((c,), tda.NEG_INF)
            l_sum = torch.zeros(c)
            for k0 in range(0, n_keys, key_tile):
                keys = torch.arange(k0, min(k0 + key_tile, n_keys))
                kc = _bf16(codes_k[bi, keys, h])                # exact
                vc = _bf16(codes_v[bi, keys, h])
                s = sum(p @ kc.T for p in reversed(qp))
                s = s * ks[bi, keys] * scale
                s = torch.where(keys[None, :] < lim[:, None], s,
                                torch.full_like(s, tda.NEG_INF))
                m_new = torch.maximum(mx, s.max(dim=1).values)
                corr = torch.exp(mx - m_new)
                mu = torch.where(m_new == tda.NEG_INF,
                                 torch.zeros_like(m_new), m_new)
                p = torch.exp(s - mu[:, None])
                l_sum = l_sum * corr + p.sum(dim=1)
                pv = split_pieces(p * vs[bi, keys][None, :], pieces)
                o = o * corr[:, None] + sum(x @ vc for x in reversed(pv))
                mx = m_new
            inv = torch.where(l_sum > 0, 1.0 / l_sum, torch.zeros_like(l_sum))
            out[bi, :, h] = o * inv[:, None]
    return out


def test_every_int8_code_is_exact_in_bf16():
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    x = codes.to(torch.float32)
    assert torch.equal(_bf16(x), x)
    assert torch.equal(x.to(torch.bfloat16).to(torch.int32),
                       codes.to(torch.int32))


def test_every_finite_e4m3_byte_is_exact_in_bf16():
    raw = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    x = raw.view(torch.float8_e4m3fn).to(torch.float32)
    finite = torch.isfinite(x)
    assert int(finite.sum()) == 254          # 0x7f and 0xff are NaN
    assert torch.equal(_bf16(x[finite]), x[finite])
    # the subnormals (exponent field 0) among them
    sub = x[finite & (raw & 0x78 == 0) & (raw & 0x07 != 0)]
    assert sub.numel() == 14 and float(sub.abs().min()) == 2.0 ** -9


@pytest.mark.parametrize("pieces,bound", [(3, 2 ** -24), (2, 2 ** -16)])
def test_pieces_carry_the_float32_bits(pieces, bound):
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32)) * 300
    total = sum(split_pieces(x, pieces))
    assert float(((total - x).abs() / x.abs()).max()) <= bound


def _inputs(kv_dtype, b, c, n, d, seed, bs=8, m=128):
    """q, pools from the engine's row quantizer (K at 3x the scale of V,
    as chip_smoke's phase 2), shuffled tables and lengths including 0."""
    rng = np.random.RandomState(seed)
    nb = b * m + 1
    q = torch.from_numpy(rng.randn(b, c, n, d).astype(np.float32))
    kq, ks = tgen._kv_quantize_rows(torch.from_numpy(
        3.0 * rng.randn(nb, bs, n, d).astype(np.float32)), kv_dtype)
    vq, vs = tgen._kv_quantize_rows(torch.from_numpy(
        rng.randn(nb, bs, n, d).astype(np.float32)), kv_dtype)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(b, m))
    top = m * bs - c
    lengths = torch.tensor([0, min(511, top)][:b], dtype=torch.int32)
    return q, kq, vq, ks, vs, tables, lengths


def _jax_reference(args):
    q, kq, vq, ks, vs, tables, lengths = args
    payload = (lambda t: jnp.asarray(kv_to_numpy(t))
               if t.dtype == torch.int8 else
               jnp.asarray(kv_to_numpy(t)).view(jnp.float8_e4m3fn))
    out = jfa.quantized_paged_decode_attention_reference(
        jnp.asarray(q.numpy()), payload(kq), payload(vq),
        jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
        jnp.asarray(tables.numpy()), jnp.asarray(lengths.numpy()))
    return np.asarray(out)


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("c", [16, 512])
def test_three_pieces_meet_the_f32_tolerance(kv_dtype, c):
    args = _inputs(kv_dtype, 2, c, 2, 64, seed=c)
    want = tda.quantized_paged_decode_attention_reference(*args)
    got = tc_prefill_emulation(*args)
    err = float((got - want).abs().max())
    assert err <= TOL, f"three pieces: {err}"
    np.testing.assert_allclose(got.numpy(), _jax_reference(args),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_two_pieces_miss_it(kv_dtype):
    """Two pieces keep 16 bits of q and of p * s_v: at C = 512 the output
    error is 2.4e-5 to 2.8e-5, over the 2e-5 the card holds K7 to, where
    three pieces stay at 4e-6 to 5e-6 (one piece, plain bf16: 2e-2)."""
    args = _inputs(kv_dtype, 2, 512, 2, 64, seed=512)
    want = tda.quantized_paged_decode_attention_reference(*args)
    err2 = float((tc_prefill_emulation(*args, pieces=2) - want).abs().max())
    err3 = float((tc_prefill_emulation(*args, pieces=3) - want).abs().max())
    assert err2 > TOL > err3, (err2, err3)


# ---------------------------------------------------------------------
# K6's chunk kernel: f32 pools, both operands in pieces
# ---------------------------------------------------------------------

#: the piece pairs the kernel sums, smallest products first
SIX_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def tc_paged_emulation(q, k_pool, v_pool, tables, lengths, pairs=SIX_PAIRS,
                       key_tile=64):
    """K6 as the chunk kernel computes it, in float32 on the CPU: S = sum
    over `pairs` (i, j) of q's piece i . k's piece j ^T, s = S * scale,
    masked to keys < lengths[b] + row + 1; an online softmax over tiles
    of `key_tile` keys; O_tile = sum over `pairs` of p's piece i . v's
    piece j, O = O * corr + O_tile; out = O / l."""
    b, c, n, d = q.shape
    bs, m = k_pool.shape[1], tables.shape[1]
    idx = tables.long().clamp(0, k_pool.shape[0] - 1)
    win_k = k_pool[idx].reshape(b, m * bs, n, d)
    win_v = v_pool[idx].reshape(b, m * bs, n, d)
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    for bi in range(b):
        lim = (int(lengths[bi]) + torch.arange(c) + 1).clamp(max=m * bs)
        n_keys = int(lim.max())
        for h in range(n):
            qp = split_pieces(q[bi, :, h])
            o = torch.zeros(c, d)
            mx = torch.full((c,), tda.NEG_INF)
            l_sum = torch.zeros(c)
            for k0 in range(0, n_keys, key_tile):
                keys = torch.arange(k0, min(k0 + key_tile, n_keys))
                kp = split_pieces(win_k[bi, keys, h])
                vp = split_pieces(win_v[bi, keys, h])
                s = sum(qp[i] @ kp[j].T for i, j in pairs) * scale
                s = torch.where(keys[None, :] < lim[:, None], s,
                                torch.full_like(s, tda.NEG_INF))
                m_new = torch.maximum(mx, s.max(dim=1).values)
                corr = torch.exp(mx - m_new)
                mu = torch.where(m_new == tda.NEG_INF,
                                 torch.zeros_like(m_new), m_new)
                p = torch.exp(s - mu[:, None])
                l_sum = l_sum * corr + p.sum(dim=1)
                pp = split_pieces(p)
                o = o * corr[:, None] + sum(pp[i] @ vp[j] for i, j in pairs)
                mx = m_new
            inv = torch.where(l_sum > 0, 1.0 / l_sum, torch.zeros_like(l_sum))
            out[bi, :, h] = o * inv[:, None]
    return out


def _paged_inputs(b, c, n, d, seed, bs=8, m=128):
    """q, f32 pools (K at 3x the scale of V, as chip_smoke's phase 2),
    shuffled tables over a 1024-key window, lengths 0 and 511."""
    rng = np.random.RandomState(seed)
    nb = b * m + 1
    q = torch.from_numpy(rng.randn(b, c, n, d).astype(np.float32))
    kp = torch.from_numpy((3.0 * rng.randn(nb, bs, n, d)).astype(np.float32))
    vp = torch.from_numpy(rng.randn(nb, bs, n, d).astype(np.float32))
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = torch.from_numpy(perm.reshape(b, m))
    lengths = torch.tensor([0, min(511, m * bs - c)][:b], dtype=torch.int32)
    return q, kp, vp, tables, lengths


def test_six_pairs_are_those_of_total_rank_at_most_two():
    assert sorted(SIX_PAIRS) == sorted(
        (i, j) for i in range(3) for j in range(3) if i + j <= 2)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("c", [2, 16, 512])
def test_six_pairs_meet_the_f32_tolerance(c, d):
    """With margin: within half the card's tolerance, so the tensor
    cores' own summation has room."""
    args = _paged_inputs(2, c, 2, d, seed=c + d)
    got = tc_paged_emulation(*args)
    want = tda.paged_decode_attention_reference(*args)
    assert float((got - want).abs().max()) <= TOL / 2
    jax_out = np.asarray(jfa.paged_decode_attention_reference(
        *(jnp.asarray(t.numpy()) for t in args)))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=TOL, rtol=0)


@pytest.mark.parametrize("dropped", [(2, 0), (1, 1), (0, 2)])
def test_five_pairs_miss_it(dropped):
    """Leaving out any pair of total rank 2 (an error term of 2^-16 of a
    product, like K7's two pieces) puts the output 2.7e-5 to 3.3e-5 from
    the plain version at C = 512, D = 64, over the 2e-5 the card holds
    K6 to, where the six pairs stay near 5e-6."""
    args = _paged_inputs(2, 512, 2, 64, seed=512 + 64)
    want = tda.paged_decode_attention_reference(*args)
    five = tuple(p for p in SIX_PAIRS if p != dropped)
    err5 = float((tc_paged_emulation(*args, pairs=five) - want).abs().max())
    err6 = float((tc_paged_emulation(*args) - want).abs().max())
    assert err5 > TOL > err6, (err5, err6)



# ---------------------------------------------------------------------
# K8 weight-only: x in pieces against the int8 codes
# ---------------------------------------------------------------------

#: chip_smoke phase 11's weight-only gate: max |kernel - plain| <=
#: K8_WO_TOL * max |plain|
K8_WO_TOL = 1e-5
#: chip_smoke's K8_SHAPES: the ResNet-50 fc at batch 32, 8, 1, a BERT-base
#: FFN GEMM and two odd shapes
K8_SHAPES = ((32, 2048, 1000), (8, 2048, 1000), (1, 2048, 1000),
             (4096, 768, 3072), (5, 33, 17), (130, 257, 129))


def k8_weight_only_emulation(x, w_q, w_scale, pieces=3, k_tile=64):
    """K8's weight-only mode as the kernel computes it, in float32 on the
    CPU: per 64-k tile a fresh sum over x's pieces (smallest first) of
    piece . codes (each product exact in f32), added into a running f32
    sum; then acc * (w_scale / qmax) with the quotient rounded once."""
    codes = _bf16(w_q.to(torch.float32))                    # exact
    xp = split_pieces(x, pieces)
    run = torch.zeros(x.shape[0], w_q.shape[1])
    for k0 in range(0, x.shape[1], k_tile):
        sl = slice(k0, k0 + k_tile)
        run = run + sum(p[:, sl] @ codes[sl] for p in reversed(xp))
    return run * (w_scale.reshape(1, -1) / tk8._f32(tk8.qmax(8), "cpu"))


def _k8_inputs(m, k, n, seed=11):
    """As chip_smoke's phase 11: x and w standard normal, w quantized per
    output column at its abs-max."""
    rng = np.random.RandomState(seed + m)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy(rng.randn(k, n).astype(np.float32))
    w_s = w.abs().amax(dim=0).clamp_min(1e-8)
    w_q = torch.clamp(torch.round(w / w_s * 127.0), -127, 127).to(torch.int8)
    return x, w_q, w_s


def _rel(got, want):
    want = torch.as_tensor(np.array(want))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m,k,n", K8_SHAPES)
def test_k8_three_pieces_meet_the_weight_only_tolerance(m, k, n):
    """Within a tenth of K8_WO_TOL of the port's plain version, and within
    K8_WO_TOL of the JAX package's dequant_matmul_reference (whose own
    summation order puts it up to 2e-6 from the port's plain version)."""
    x, w_q, w_s = _k8_inputs(m, k, n)
    got = k8_weight_only_emulation(x, w_q, w_s)
    assert _rel(got, tk8.dequant_matmul_reference(x, w_q, w_s)) <= (
        K8_WO_TOL / 10)
    want = jax_dequant_matmul(jnp.asarray(x.numpy()), jnp.asarray(
        w_q.numpy()), jnp.asarray(w_s.numpy()))
    assert _rel(got, want) <= K8_WO_TOL


@pytest.mark.parametrize("m,k,n", K8_SHAPES)
def test_k8_fewer_pieces_lose_the_margin(m, k, n):
    """Two pieces keep 16 bits of x: still inside K8_WO_TOL here, at two
    times (or more) the error of three; one piece, x in bf16, misses the
    tolerance a hundredfold."""
    x, w_q, w_s = _k8_inputs(m, k, n)
    want = tk8.dequant_matmul_reference(x, w_q, w_s)
    err = {p: _rel(k8_weight_only_emulation(x, w_q, w_s, pieces=p), want)
           for p in (1, 2, 3)}
    assert err[3] <= K8_WO_TOL / 10
    assert 2 * err[3] <= err[2] <= K8_WO_TOL, err
    assert err[1] > 100 * K8_WO_TOL, err


# ---------------------------------------------------------------------
# the f32 flash forward: six piece pairs with bias, causal, dropout, lse
# ---------------------------------------------------------------------

#: chip_smoke phase 6's float32 gate (max |kernel - plain| / max |plain|)
FLASH_F32_TOL = 1e-5
#: the accuracy of the CUDA-core f32 kernel the tensor-core forward
#: replaced (4.4e-7 relative on the card), with room
F32_LEVEL = 1e-6


def flash_f32_emulation(q, k, v, bias, causal, keep, pairs=SIX_PAIRS,
                        key_tile=64):
    """The f32 flash forward as the tensor-core kernel computes it, in
    float32 on the CPU, for q/k/v [B, T, N, D], bias [B, Tk] or None, keep
    [B, N, Tq, Tk] or None: S = sum over `pairs` (i, j) of q's piece i .
    k's piece j ^T, s = S * scale + bias, causal keeps col <= row; an
    online softmax over tiles of `key_tile` keys with l summing the
    undropped p; O_tile = sum over `pairs` of (p x keep)'s piece i . v's
    piece j, O = O * corr + O_tile; o = O / safe_l, lse = m +
    log(safe_l). Returns o [B, T, N, D] and lse [B, N, T]."""
    b, t, n, d = q.shape
    tk = k.shape[1]
    scale = np.float32(1.0 / math.sqrt(d))
    rows = torch.arange(t)
    out = torch.zeros_like(q)
    lse = torch.zeros(b, n, t)
    for bi in range(b):
        for h in range(n):
            qp = split_pieces(q[bi, :, h])
            o = torch.zeros(t, d)
            mx = torch.full((t,), tfa.NEG_INF)
            l_sum = torch.zeros(t)
            for k0 in range(0, tk, key_tile):
                keys = torch.arange(k0, min(k0 + key_tile, tk))
                kp = split_pieces(k[bi, keys, h])
                vp = split_pieces(v[bi, keys, h])
                s = sum(qp[i] @ kp[j].T for i, j in pairs) * scale
                if bias is not None:
                    s = s + bias[bi, keys][None, :]
                if causal:
                    s = torch.where(keys[None, :] <= rows[:, None], s,
                                    torch.full_like(s, tfa.NEG_INF))
                m_new = torch.maximum(mx, s.max(dim=1).values)
                corr = torch.exp(mx - m_new)
                mu = torch.where(m_new == tfa.NEG_INF,
                                 torch.zeros_like(m_new), m_new)
                p = torch.exp(s - mu[:, None])
                l_sum = l_sum * corr + p.sum(dim=1)
                if keep is not None:
                    p = p * keep[bi, h][:, keys]
                pp = split_pieces(p)
                o = o * corr[:, None] + sum(pp[i] @ vp[j] for i, j in pairs)
                mx = m_new
            safe = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
            out[bi, :, h] = o / safe[:, None]
            lse[bi, h] = mx + torch.log(safe)
    return out, lse


def _flash_inputs(d, t=1024, b=1, n=2, rate=0.1, seed=3):
    """Standard normal q, k, v (as chip_smoke's phase 6), a random key
    bias (its mask_grad case), the kernels' dropout masks."""
    rng = np.random.RandomState(seed + d)
    q, k, v = (torch.from_numpy(rng.randn(b, t, n, d).astype(np.float32))
               for _ in range(3))
    bias = torch.from_numpy((0.5 * rng.randn(b, t)).astype(np.float32))
    keep = tfa.batch_keep_masks(12345, b, n, t, t, rate)
    return q, k, v, bias, keep


def _jax_attention(q, k, v, bias, keep):
    b, t = bias.shape
    return np.asarray(jfa.attention_reference(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        mask=jnp.asarray(bias.numpy()).reshape(b, 1, 1, t), causal=True,
        keep_masks=jnp.asarray(keep.numpy())))


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_f32_six_pairs_meet_the_tolerance(d):
    """T = 1024, causal, bias, dropout 0.1: o within half of the card's
    f32 gate of the JAX reference (and within F32_LEVEL), lse within
    F32_LEVEL of the plain version's."""
    q, k, v, bias, keep = _flash_inputs(d)
    got, lse = flash_f32_emulation(q, k, v, bias, True, keep)
    want = _jax_attention(q, k, v, bias, keep)
    assert _rel(got, want) <= min(FLASH_F32_TOL / 2, F32_LEVEL)
    b, t = bias.shape
    _, want_lse = tfa.attention_reference(q, k, v, bias.reshape(b, 1, 1, t),
                                          True, keep_masks=keep,
                                          return_lse=True)
    assert _rel(lse, want_lse[..., 0].permute(0, 2, 1)) <= F32_LEVEL


@pytest.mark.parametrize("dropped", [(2, 0), (1, 1), (0, 2)])
def test_flash_f32_five_pairs_lose_f32_accuracy(dropped):
    """Leaving out a pair of total rank 2 (an error term of 2^-16 of a
    product) puts o past F32_LEVEL of the plain version at D = 64, where
    the six pairs stay near 3e-7."""
    q, k, v, bias, keep = _flash_inputs(64)
    b, t = bias.shape
    want = tfa.attention_reference(q, k, v, bias.reshape(b, 1, 1, t), True,
                                   keep_masks=keep)
    five = tuple(p for p in SIX_PAIRS if p != dropped)
    err5 = _rel(flash_f32_emulation(q, k, v, bias, True, keep, five)[0],
                want)
    err6 = _rel(flash_f32_emulation(q, k, v, bias, True, keep)[0], want)
    assert err5 > F32_LEVEL > err6, (err5, err6)


# ---------------------------------------------------------------------
# the f32 flash backward: five products, each over the six piece pairs
# ---------------------------------------------------------------------

#: the six pairs' level for the backward's four outputs: a quarter of the
#: card's gate (the plain version's own f32 sums over T = 1024 rows put
#: the emulation up to 2e-6 from it)
BWD_LEVEL = FLASH_F32_TOL / 4


def _piece_product(a, b, pairs):
    """sum over `pairs` (i, j) of a[i] @ b[j], for piece lists a and b."""
    return sum(a[i] @ b[j] for i, j in pairs)


def flash_f32_bwd_emulation(q, k, v, bias, causal, keep, dout, lse, delta,
                            pairs=SIX_PAIRS, tile=64):
    """The f32 flash backward as the tensor-core kernel
    (`flash_bwd_f32_tc_kernel` in csrc/flash_bwd_f32_tc.cu) computes it,
    in float32 on the CPU. q, k, v and dout are split into three bf16
    pieces; S^T = K.Q^T and dP^T = V.dO^T are sums over `pairs`; s = S *
    scale + bias, causal keeps col <= row, p = exp(s - lse) (the kernel
    takes exp2 of (s - lse) * log2 e, a few ulps away); g = p * (dp
    * keep - delta) is dbias's term and ds = g * scale. p x keep and ds
    are split into pieces after the subtraction, in f32; dV and dK sum a
    fresh product per `tile` query rows ((p x keep)^T . dO, ds^T . q),
    dQ one per `tile` keys (ds . k), each over `pairs`. lse and delta
    are [B, N, Tq]. Returns dq, dk, dv [B, T, N, D] and dbias [B, Tk]."""
    b, t, n, d = q.shape
    tk = k.shape[1]
    scale = np.float32(1.0 / math.sqrt(d))
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dbias = torch.zeros(b, tk)
    seen = (torch.arange(tk)[None, :] <= torch.arange(t)[:, None] if causal
            else torch.ones(t, tk, dtype=torch.bool))
    for bi in range(b):
        for h in range(n):
            qp, kp, vp, op = (split_pieces(x[bi, :, h])
                              for x in (q, k, v, dout))
            s = _piece_product(qp, [x.T for x in kp], pairs) * scale
            s = s + bias[bi][None, :]
            p = torch.where(seen, torch.exp(s - lse[bi, h][:, None]),
                            torch.zeros_like(s))
            dp = _piece_product(op, [x.T for x in vp], pairs)
            kf = keep[bi, h] if keep is not None else torch.ones_like(p)
            g = p * (dp * kf - delta[bi, h][:, None])
            dbias[bi] += g.sum(0)
            pk, ds = split_pieces(p * kf), split_pieces(g * scale)
            for r0 in range(0, t, tile):
                sl = slice(r0, r0 + tile)
                dv[bi, :, h] += _piece_product(
                    [x[sl].T for x in pk], [x[sl] for x in op], pairs)
                dk[bi, :, h] += _piece_product(
                    [x[sl].T for x in ds], [x[sl] for x in qp], pairs)
            for k0 in range(0, tk, tile):
                sl = slice(k0, k0 + tile)
                dq[bi, :, h] += _piece_product(
                    [x[:, sl] for x in ds], [x[sl] for x in kp], pairs)
    return dq, dk, dv, dbias


def _flash_bwd_case(d):
    """chip_smoke phase 6's f32 case at T = 1024 (causal, mask_grad) plus
    dropout 0.1: the emulation's inputs and the plain version's dq, dk,
    dv, dmask (autograd through `attention_reference`, float32)."""
    q, k, v, bias, keep = _flash_inputs(d)
    b, t = bias.shape
    dout = torch.from_numpy(np.random.RandomState(d).randn(*q.shape)
                            .astype(np.float32))
    x = [a.clone().requires_grad_() for a in (q, k, v)]
    m = bias.reshape(b, 1, 1, t).clone().requires_grad_()
    o, lse = tfa.attention_reference(*x, m, True, keep_masks=keep,
                                     return_lse=True)
    (o * dout).sum().backward()
    args = (q, k, v, bias, True, keep, dout,
            lse[..., 0].permute(0, 2, 1).detach(),
            tfa.bwd_delta(o.detach(), dout))
    return args, [a.grad for a in x] + [m.grad.reshape(b, t)]


def _rel_all(got, want):
    return [_rel(g, w) for g, w in zip(got, want)]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_f32_backward_six_pairs_meet_the_tolerance(d):
    """T = 1024, causal, bias with mask_grad, dropout 0.1: dq, dk, dv and
    dmask within a quarter of the card's gate (BWD_LEVEL) of the plain
    version (4.2e-7 to 2.0e-6 here), and within half the gate of the JAX
    package's gradients of `attention_reference` (jax.vjp)."""
    import jax
    args, want = _flash_bwd_case(d)
    got = flash_f32_bwd_emulation(*args)
    assert max(_rel_all(got, want)) <= BWD_LEVEL, _rel_all(got, want)
    q, k, v, bias, _, keep, dout = args[:7]
    b, t = bias.shape
    _, vjp = jax.vjp(
        lambda q_, k_, v_, m_: jfa.attention_reference(
            q_, k_, v_, mask=m_, causal=True,
            keep_masks=jnp.asarray(keep.numpy())),
        *(jnp.asarray(x.numpy()) for x in (q, k, v, bias.reshape(b, 1, 1, t))))
    jax_grads = [np.asarray(g) for g in vjp(jnp.asarray(dout.numpy()))]
    jax_grads[3] = jax_grads[3].reshape(b, t)
    errs = _rel_all(got, jax_grads)
    assert max(errs) <= FLASH_F32_TOL / 2, errs


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dropped", [(2, 0), (1, 1), (0, 2)])
def test_flash_f32_backward_five_pairs_lose_f32_accuracy(d, dropped):
    """Which sets of five pairs would do: leaving out a pair of total rank
    2 puts the worst of dq, dk, dv, dmask at 4.9e-6 to 8.5e-6 of max
    |plain| here, past BWD_LEVEL and at 2.5 times the six pairs' worst
    error or more. Every set of five still meets the card's 1e-5 gate at
    this size, with a margin of 1.2x to 2x; the kernel keeps six, whose
    margin (5x or more) is what the tensor cores' own summation order
    and the atomics' order may spend."""
    args, want = _flash_bwd_case(d)
    five = tuple(p for p in SIX_PAIRS if p != dropped)
    err5 = max(_rel_all(flash_f32_bwd_emulation(*args, pairs=five), want))
    err6 = max(_rel_all(flash_f32_bwd_emulation(*args), want))
    assert err5 > BWD_LEVEL >= err6, (err5, err6)
    assert err5 > 2.4 * err6, (err5, err6)
    assert err5 <= FLASH_F32_TOL, err5
