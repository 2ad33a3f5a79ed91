"""K8's plain PyTorch version (the CPU path of
`paddle_tpu_torch.ops.kernels.quantized_matmul`) against the JAX
package: `dequant_matmul_reference` and the interpreted Pallas kernel
(`fused_dequant_matmul(use_kernel=True, interpret=True)`), on the same
numpy inputs, in both modes, at (5, 33, 17) and (130, 257, 129), with
bits 8 and 4.

Tolerances. int8-activation mode: the activation codes and the int32
accumulators are equal, the output equals the JAX reference bit for bit
(the same fold order), and is within 4 ulps of the interpreted kernel
(XLA may reassociate its two constant scale multiplies, as
tests/test_quantized_serving.py holds). Weight-only mode: float32
accumulation in another order, max |diff| <= 1e-5 * max |reference|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from paddle_tpu.ops.pallas.quantized_matmul import (
    dequant_matmul_reference, fused_dequant_matmul,
)
from paddle_tpu.slim.quant_ops import quantize_weight
from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
from paddle_tpu_torch.slim.quant_ops import quantize_weight as tquantize_weight

SHAPES = [(5, 33, 17), (130, 257, 129)]
BITS = [8, 4]
WEIGHT_ONLY_RTOL = 1e-5
MAX_ULPS = 4


def _inputs(m, k, n, bits, seed=0):
    rng = np.random.RandomState(seed + m)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    w_q, w_s = quantize_weight(w, bits, channel_axis=1)
    # a scale below max |x|: some activations clip
    x_scale = float(np.abs(x).max()) * 0.7
    return x, w_q, w_s, x_scale


def _jax_codes_and_acc(x, w_q, x_scale, bits):
    """The JAX reference's intermediate values (quantized_matmul.py:56-58)."""
    qm = float(2 ** (bits - 1) - 1)
    s = max(float(x_scale), 1e-8)
    xq = jnp.clip(jnp.round(jnp.asarray(x) / s * qm), -qm, qm).astype(jnp.int8)
    acc = lax.dot(xq, jnp.asarray(w_q), preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(acc)


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_int8_mode_equals_jax_reference(m, k, n, bits):
    x, w_q, w_s, xs = _inputs(m, k, n, bits)
    want = np.asarray(dequant_matmul_reference(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_s), x_scale=xs,
        bits=bits))
    got, acc = k8.fused_dequant_matmul(
        torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(w_s),
        x_scale=xs, bits=bits, return_acc=True)
    codes = k8.quantize_activation(torch.from_numpy(x), xs, bits).numpy()
    j_codes, j_acc = _jax_codes_and_acc(x, w_q, xs, bits)
    np.testing.assert_array_equal(codes, j_codes)
    np.testing.assert_array_equal(acc.numpy(), j_acc)
    assert acc.dtype == torch.int32
    assert _ulps(got.numpy(), want) == 0


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_int8_mode_matches_interpreted_pallas_kernel(m, k, n, bits):
    """Within 4 ulps of the interpreted Pallas kernel, except on rows
    where that kernel departs from its own oracle: inside the kernel XLA
    folds `x / s * qm` into `x * (qm / s)`, so an activation whose
    quotient is exactly a half (52.5 at (130, 257, 129), bits 8) rounds
    the other way and one code is off by one (ROADMAP Queue 3). The
    port keeps the oracle's order; those rows are pinned here."""
    x, w_q, w_s, xs = _inputs(m, k, n, bits)
    kern = np.asarray(fused_dequant_matmul(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_s), x_scale=xs,
        bits=bits, use_kernel=True, interpret=True))
    got = k8.fused_dequant_matmul(
        torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(w_s),
        x_scale=xs, bits=bits).numpy()
    assert got.shape == kern.shape == (m, n)
    qm = np.float32(2 ** (bits - 1) - 1)
    s = np.float32(max(xs, 1e-8))
    folded = np.clip(np.round(x * (qm / s)), -qm, qm)
    divided = np.clip(np.round(x / s * qm), -qm, qm)
    tie_rows = set(np.where((folded != divided).any(axis=1))[0])
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - kern.view(np.int32).astype(np.int64)).max(axis=1)
    bad_rows = set(np.where(ulps > MAX_ULPS)[0])
    assert bad_rows == tie_rows
    if (m, bits) == (130, 8):
        assert tie_rows == {119}   # the pinned reference fault


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("oracle", ["reference", "interpreted_kernel"])
def test_weight_only_mode(m, k, n, bits, oracle):
    x, w_q, w_s, _ = _inputs(m, k, n, bits)
    if oracle == "reference":
        want = dequant_matmul_reference(jnp.asarray(x), jnp.asarray(w_q),
                                        jnp.asarray(w_s), bits=bits)
    else:
        want = fused_dequant_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                    jnp.asarray(w_s), bits=bits,
                                    use_kernel=True, interpret=True)
    want = np.asarray(want)
    got = k8.fused_dequant_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                                  torch.from_numpy(w_s), bits=bits).numpy()
    err = float(np.abs(got - want).max())
    assert err <= WEIGHT_ONLY_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("bits", BITS)
def test_quantize_weight_equals_jax(bits):
    rng = np.random.RandomState(3)
    w = rng.randn(7, 5, 3, 3).astype(np.float32)
    for axis in (None, 0, 1):
        jq, js = quantize_weight(w, bits, channel_axis=axis)
        tq, ts = tquantize_weight(w, bits, channel_axis=axis)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)


def test_wrapper_takes_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; so does
    the meta device (shape inference evaluates ops without data)."""
    x, w_q, w_s, xs = _inputs(5, 33, 17, 8)
    k8.reset_launch_counts()
    k8.fused_dequant_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                            torch.from_numpy(w_s), x_scale=xs)
    meta = k8.fused_dequant_matmul(torch.empty(5, 33, device="meta"),
                                   torch.empty(33, 17, dtype=torch.int8,
                                               device="meta"),
                                   torch.empty(17, device="meta"), x_scale=xs)
    assert meta.shape == (5, 17) and meta.dtype == torch.float32
    assert k8.launch_counts["quantized_matmul"] == 0


def test_ctypes_signature_matches_the_cuda_entry_point():
    """The argtypes `_build` declares have the arity and kinds of the C
    function in csrc/quantized_matmul.cu (a mismatch shows only on the
    card otherwise)."""
    import ctypes
    import pathlib
    import re

    from paddle_tpu_torch.ops.kernels import _build
    src = (pathlib.Path(_build.__file__).parents[2] / "csrc"
           / "quantized_matmul.cu").read_text()
    proto = re.search(r'extern "C" int ptt_quantized_matmul\(([^)]*)\)',
                      src).group(1)
    params = [p.strip() for p in proto.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.startswith("float") else
             ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
             for p in params]
    assert _build.SIGNATURES["ptt_quantized_matmul"] == kinds
