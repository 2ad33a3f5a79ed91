"""The flash kernels at the Transformer's shapes, and a small Transformer
through them, on the card.

* The kernels against their plain version at chip_smoke's phase-22
  cases (TRANSFORMER_FLASH_CASES: self-attention with a key-padding
  bias, causal self-attention and cross-attention with the bias, at
  ragged lengths, Tq != Tk, and every shape phases 23-24 launch),
  through chip_smoke's `flash_case`: forward (o, lse) and backward (dq,
  dk, dv), float32 (TF32 off) and bfloat16, within FLASH_TOL of the
  plain version's max.
* A Transformer at head dim 32 (d_model 128, 4 heads) with
  attention_impl "flash" against "xla" on the same weights: loss and
  gradients within 1e-4 of each tensor's max (floored at 1e-2 of the
  largest gradient), greedy and beam ids equal.
* torch.argmax breaks ties toward the lower index on the card (the
  greedy decode relies on it, as jnp.argmax does).

Every test carries the `cuda` marker and skips without a GPU. No JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_eager_cuda.py -q
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as tfa

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (chip_smoke.py at the repo root)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels are CUDA C++ "
                    "for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "label,b,tq,tk,causal,pad", chip_smoke.TRANSFORMER_FLASH_CASES,
    ids=[f"{c[0]}-B{c[1]}-{c[2]}x{c[3]}".replace(" ", "-")
         for c in chip_smoke.TRANSFORMER_FLASH_CASES])
def test_flash_at_transformer_shapes(cuda, dtype, label, b, tq, tk, causal,
                                     pad):
    n, d = chip_smoke.TRANSFORMER_HEADS, chip_smoke.TRANSFORMER_HEAD_DIM
    lengths = (chip_smoke.transformer_lengths(np.random.RandomState(tq + tk),
                                              b, tk) if pad else None)
    errs, launched = chip_smoke.flash_case(
        torch, tfa, cuda, dtype, b, tq, n, d, tk=tk, lengths=lengths,
        causal=causal, seed=tq * 7 + tk)
    fwd, (bwd,) = tfa.KERNELS[dtype]
    # one forward for o, one for lse; one backward
    assert launched == {fwd: 2, bwd: 1}
    tol = chip_smoke.FLASH_TOL[str(dtype).split(".")[-1]]
    assert all(rel <= tol for _, rel in errs.values()), (label, errs)


@pytest.mark.cuda
def test_argmax_ties_go_to_the_lower_index_on_the_card(cuda):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 4, (64, 30000)).astype(np.float32))
    want = torch.from_numpy(np.argmax(x.numpy(), axis=-1))
    assert torch.equal(torch.argmax(x.to(cuda), dim=-1).cpu(), want)


def _floored_close(got, want, tol=1e-4):
    """Each gradient within tol of its max, the max floored at 1e-2 of
    the largest gradient: the key biases' exact gradient is 0, so both
    sides hold rounding noise there (~1e-10 measured on the card)."""
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), floor), (k, err)


@pytest.mark.cuda
def test_transformer_flash_matches_xla_on_the_card(cuda):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)
    cfg = dataclasses.replace(TransformerConfig.tiny(), d_model=128,
                              num_heads=4, ffn_dim=256)
    nn.seed(3)
    models = {}
    for impl in ("xla", "flash"):
        models[impl] = Transformer(dataclasses.replace(
            cfg, attention_impl=impl))
    models["flash"].load_state_dict(models["xla"].state_dict())
    rng = np.random.RandomState(1)
    src = torch.from_numpy(rng.randint(2, 1000, (4, 40))).to(cuda)
    src_len = torch.tensor([40, 17, 33, 25], device=cuda)
    trg_in = torch.from_numpy(rng.randint(2, 1000, (4, 36))).to(cuda)
    trg_out = torch.from_numpy(rng.randint(0, 1000, (4, 36))).to(cuda)
    out = {}
    for impl, m in models.items():
        loss = m.loss(src, src_len, trg_in, trg_out)
        loss.backward()
        out[impl] = (float(loss.detach()), {k: p.grad for k, p in
                                   m.named_parameters()})
    assert abs(out["flash"][0] - out["xla"][0]) <= 1e-5 * out["xla"][0]
    _floored_close(out["flash"][1], out["xla"][1])
    ids = {impl: m.greedy_decode(src, src_len, max_len=12)
           for impl, m in models.items()}
    assert torch.equal(ids["flash"], ids["xla"])
    beams = {impl: m.beam_search_decode(src[:2], src_len[:2], max_len=10,
                                        beam_size=3)[0]
             for impl, m in models.items()}
    assert torch.equal(beams["flash"], beams["xla"])
