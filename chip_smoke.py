#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]
    python3 chip_smoke.py --latency [ROOT]
    python3 chip_smoke.py --decode-rows [ROOT]
    python3 chip_smoke.py --flash-sweep [ROOT]

Phases, each of which raises (exit code != 0) when its check fails:

1. Device: the card's name and power limit (nvidia-smi), then the build
   of the CUDA kernels from `paddle_tpu_torch/csrc/` and the build
   report of the tensor-core kernels (BUILD_CHECKS): each
   instantiation's ptxas line and its SASS opcodes (cuobjdump), failing
   on a spill, on no HGMMA in the bf16 flash pair, the f32 flash pair,
   K6's / K7's chunk kernels or K8's weight-only kernel, on no IMMA in
   K8's int8 kernel or on IDP4A there.
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the serving path gives them, max |kernel - plain| <= 2e-5
   (float32, TF32 off; the tolerance covers summation order): K5 at
   B=8, S=1024, N=12, D=64; K6 (f32 pools) and K7 (int8 and float8 e4m3
   pools with per-row scales) at block_size 8, M=128 over a shuffled
   pool at K6_CASES / K7_CASES: C in {1, 2, 5, 8, 16, 64, 512} at B=8,
   the main path's prefill (B=1, C=512) and D=32 and 128: decode ticks
   on the decode kernels (CUDA cores, one launch a call, checked from
   the profiler's rows: K5, K6 at C = 1, 2 and 5, K7 at C = 1; the
   printed line names K5's and K6's key split), chunks on the chunk kernels
   (tensor cores; K7's from C = 2, K6's from PAGED_TC_MIN_C rows, shorter
   ones on its CUDA-core kernel), the route of each case read from the
   launch counters; K6's chunks at B=8, D=64 also timed on both of its
   kernels (the crossover). Each is timed beside its plain version,
   `F.scaled_dot_product_attention` on the same (for K7: dequantized)
   window (a yardstick the port never calls) and its bound (bytes or
   operations over the H100's peak rates; the chunk routes count their
   bf16 products per f32 product, three for K7 and six for K6, at 989
   TFLOP/s).
3. Contiguous serving: GenerationServer over DecodeEngine over
   TinyDecoderLM at GPT-2-small widths (vocab 50257, d_model 768, 12
   heads, 12 layers, max_len 1024; seeded random weights), 16 greedy
   requests with prompts of 16..512 tokens, 32..64 new tokens each.
   Every request's tokens must equal the port's single-request
   greedy_decode, except after a position where the single-request
   logits' top-2 gap is < 1e-4 (batched and unbatched matmuls may pick
   different argmaxes there; such cases are printed and the comparison
   of that request stops). K5 must have launched >= layers x steps.
4. Paged serving: the same model and prompts under PagedDecodeEngine
   (block_size 8, spec_k 4) with an NgramDraft distilled from phase 3's
   outputs; half the prompts share a 256-token prefix, so admissions hit
   the prefix index and verify runs at chunk 5. Tokens must equal phase
   3's under the same near-tie rule; K6's chunk kernel must have
   launched once per layer on every admission (and on every verify tick
   whose chunk reaches PAGED_TC_MIN_C), its decode kernel once per layer
   on every other tick.
4'. Paged serving without speculation: the same requests under
   PagedDecodeEngine(batch_size=8, block_size 8, spec_k=0). Tokens must
   equal phase 3's (near-tie rule); every tick is a plain tick, so K6's
   decode kernel must have launched once per layer on every tick and its
   chunk kernel once per layer on every admission.
4a. Quantized serving, int8 then fp8 e4m3: the same requests and draft
   under PagedDecodeEngine(kv_dtype=...). Tokens must equal the
   single-request greedy streams of a batch_size=1, spec_k=0 engine of
   the same dtype (near-tie rule); K7's prefill route must have launched
   once per layer on every admission and on every verify tick (chunk
   spec_k + 1 > 1), its decode route once per layer on every plain
   tick, and K6 never. The pool's bytes (kv_pool_bytes() and what
   torch.cuda allocated) beside float32's, and the token agreement with
   phase 3. Then fidelity: phase 3's streams teacher-forced through
   each dtype, mean |dlogits| / mean |logits_f32| below 0.05 (int8) and
   0.35 (fp8), the JAX package's gates.
4b. Pool pressure, int8: a pool of PRESSURE_BLOCKS (about four worst-case
   requests) with a 256-block spill tier serves the requests twice over
   in one queue: admissions park, the degradation ladder reaches
   evict_spill, at least one admission is a spill hit, and the tokens
   still equal the int8 references, with the same route counts.
4c. Relocation, int8: a request decodes half its budget on one engine,
   is exported (v2 state document), imported into a second engine's
   spill tier and resumed with submit_resumed: the stream equals the
   uninterrupted one, its admission promotes spilled blocks, and a
   document with one flipped scale byte is refused.
5. Where a decode step's time goes with 8 live slots, on the contiguous
   f32 engine and on the int8 paged engine: host wall time per step,
   device time per step and the top kernels from torch.profiler, and
   the device's idle share.
6. The flash-attention kernels (K1-K4), each against its plain PyTorch
   version:
   `flash_fwd` and `flash_bwd` (bf16, tensor cores) at BERT-base shapes
   (B=32, T=512, N=12, D=64; all-ones mask, padding mask, dropout 0.1)
   and the f32 pair (`flash_fwd_f32` and `flash_bwd_f32`, on the bf16
   tensor cores with every operand in three bf16 pieces and six piece
   products per f32 product) on the general path (T=1024, causal,
   mask_grad) and on views whose rows are not 16-byte aligned (offset by
   one float): o, lse, dq/dk/dv(/dmask) within FLASH_TOL of max |plain|,
   each case launching only its dtype's kernels. The bf16 pair is timed
   at the main path's case (dropout 0.1) and the f32 pair at phase 8's
   (batch 4), each beside its plain version,
   `F.scaled_dot_product_attention` on the same tensors (a yardstick the
   port never calls) and its bound (the f32 pair's as six bf16 products
   per f32 product at 989 TFLOP/s). Then the f32 backward and SDPA's f32
   backward at B=4, N=12, D=64, T in FLASH_SWEEP_T, causal and not (see
   `flash_sweep`).
7. The BERT-base pretraining step at full published width (12 layers,
   hidden 768, 12 heads, vocab 30522; bf16 params, f32 master + Adam,
   dropout on, flash attention), batch 32 x 512: 3 warm-up and 10 timed
   steps on one synthetic batch; every loss finite, the last below the
   first, `flash_fwd` and `flash_bwd` launched 12 times per timed step
   and the f32 kernels never; step ms, tokens/s, model-flops share of
   989 TFLOP/s and peak memory.
8. The same weights in f32, eval(), batch 4 x 512: pretrain_loss and
   every gradient under attention_impl="flash" against "xla" within
   MODEL_LOSS_TOL / MODEL_GRAD_TOL; the f32 pair launched once per
   layer and the bf16 pair never.
9. Where a training step's time goes (torch.profiler, device rows).
10. (No phase 10: phases 11-13 are the static serving slice's.)
11. K8 (the fused dequant matmul) against its plain version on the card,
    int8-activation and weight-only modes, at the ResNet-50 fc at batch
    32, 8 and 1 ((M, 2048, 1000)), a BERT-base FFN GEMM (4096, 768, 3072)
    and two odd shapes: int32 accumulators equal and outputs within 1 ulp
    (int8 mode), max |kernel - plain| <= 1e-5 max |plain| and two calls
    bit-equal (weight-only: x in three bf16 pieces on wgmma, split-K
    summed in split order); each timed beside its plain version, its
    bound (weight-only: three bf16 products per f32 product at 989
    TFLOP/s) and a yardstick the port never calls (int8: `torch._int_mm`
    plus the rescale where it takes the shape, its accumulators equal to
    the kernel's; weight-only: f32 `torch.matmul` on the dequantized
    weight), with each mode's split count.
    (Both kernels' ptxas lines are in phase 1's build report.) TF32 is
    off for the static phases (and printed so).
12. ResNet-50 int8 serving through the Predictor at the published width
    (He et al. 2015 Table 1: 50 layers, 224 x 224, 1000 classes; depth
    not cut; random weights from --seed): built with the port's static
    API, initialized on the card, saved with save_inference_model, then
    an f32 Predictor and an int8 one (PTQ at load over 4 batches of 8
    images, hist) serve 4 requests each at batch 1, 8 and 32 through the
    handles. Checks: 53 quantized_conv2d + 1 quantized_mul and no fake
    op; K8 launched on every int8 request; the served fc equals K8's
    plain version + bias within 1 ulp; the stem's and a 3x3 conv's int32
    accumulators equal float64 on the CPU; int8 vs f32 mean |dlogits| /
    mean |logits_f32| < 0.2 (top-1 agreement recorded, not gated).
    Images/s and p50 latency per batch size, PTQ load time and peak
    memory, int8 weight bytes beside f32's.
13. Where an int8 batch-32 request's time goes (torch.profiler).

Then a `{"kernels": [...]}` line and, last, the device line
`{"ok": true, "device": {...}}`. Every number is printed beside the
card's name and power limit.

Launch counters are reset just before each main-path phase (serving,
training, int8 ResNet serving) and read just after it, so launches made
to compare kernels with their plain versions do not count; K6's two
lines (decode route, chunk route) report phases 4 and 4' together, K7's two
lines those of its three serving runs (phases 4a and 4b) together.

`--latency [ROOT]` runs none of the phases: it measures, with the port
found under ROOT (default: this checkout), one prompt's prefill latency
at LATENCY_LENS and f32 / int8 / fp8 paged serving (see `latency`), and
prints one line `LATENCY {...}`. `--decode-rows [ROOT]` likewise
profiles the decode routes at phase 2's cases, K5, K6 at C = 1 and 2,
and K7 (see `decode_rows`), and
prints `DECODE_ROWS {...}`. `--flash-sweep [ROOT]` times the f32 flash
backward of the port under ROOT beside SDPA's (see `flash_sweep`) and
prints `FLASH_SWEEP {...}`. Run any of them on two checkouts in one call
(parent, change, change, parent) to compare them on the same card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 CUDA-core
#: flop/s, dense bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: dense int8 tensor-core operations/s of the H100 SXM (data sheet)
INT8_OPS = 1979e12

GPT2_SMALL = dict(vocab_size=50257, d_model=768, num_heads=12,
                  num_layers=12, max_len=1024)
TOL = 2e-5
NEAR_TIE = 1e-4
#: phase 4b's pool: four worst-case requests (512 + 64 positions = 72
#: blocks of 8 each) and the garbage block
PRESSURE_BLOCKS = 4 * 72 + 1
#: the paged wrappers' launch counters: every call -> the chunks among
#: them (K6's and K7's tensor-core routes)
CHUNK_ROUTES = {"paged_decode_attention": "paged_prefill_attention",
                "quantized_paged_decode_attention":
                    "quantized_paged_prefill_attention"}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def timed_ms(torch, fn, argsets, iters=30):
    """Median device time of one call: each call is bracketed by CUDA
    events behind a ~1 ms device sleep, so the host's enqueue time stays
    outside the bracket. `argsets` rotate, each set on its own copy of
    the inputs, so every call finds its inputs cold in the 50 MB L2."""
    for a in argsets:
        fn(*a)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for i, (s, e) in enumerate(ev):
        torch.cuda._sleep(2_000_000)
        s.record()
        fn(*argsets[i % len(argsets)])
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def bound_ms(nbytes, flops, peak_flops=F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: phase 2's K5 case (B, S, N, D): the contiguous engine's decode step
K5_CASE = (8, 1024, 12, 64)


def k5_lengths(rng, b, s):
    """Phase 2's K5 lengths: an empty window, one key, 511, a full
    window, then random ones."""
    return np.concatenate([[0, 1, 511, s],
                           rng.randint(1, s + 1, size=b - 4)]).astype(
        np.int32)


def f32_split(da, cap, d):
    """The key split of f32_decode_kernel (K5, K6's decode route) at a
    capacity: the blocks a tile (one cluster) that the window's stages
    are striped over, and their keys at a full window."""
    nsplit = da.f32_decode_split_count(cap, d)
    return (f"keys striped over {nsplit} blocks (one cluster), "
            f"{-(-cap // nsplit)} keys a block at a full window")


def one_kernel_a_call(torch, fn, sets, what, tag):
    """The profiler's rows of `fn` over `sets`: exactly one kernel a
    call, f32_decode_kernel. Returns the rows."""
    kernels = kernel_rows(torch, fn, sets)
    assert len(kernels) == 1 and kernels[0]["launches_per_call"] == 1 \
        and "f32_decode_kernel" in kernels[0]["name"], (what, kernels)
    print(f"{what}: kernels per call (torch.profiler): " + "; ".join(
        f"{k['launches_per_call']:g} x {k['name'][:60]} "
        f"{k['us_per_call']:.3f} us" for k in kernels) + f" {tag}")
    return kernels


def check_contiguous_kernel(torch, da, seed, tag, copies=4):
    """Phase 2, K5. Returns its summary dict; `tag` (the card line) is
    printed beside every number."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    # K5: decode step of the contiguous engine
    b, s, n, d = K5_CASE
    lens = k5_lengths(rng, b, s)
    lengths = torch.tensor(lens, device=dev)
    sets = [(randn(b, n, d), randn(b, s, n, d), randn(b, s, n, d),
             lengths) for _ in range(copies)]
    got = da.decode_attention(*sets[0])
    want = da.decode_attention_reference(*sets[0])
    torch.cuda.synchronize()
    err5 = float((got - want).abs().max())
    assert got.shape == (b, n, d) and bool(torch.isfinite(got).all())
    assert err5 <= TOL, f"K5 max |kernel - plain| {err5} > {TOL}"

    def k5_library(q, k, v, ln):
        mask = (torch.arange(s, device=dev)[None, :] < ln[:, None])
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :])

    kernels = one_kernel_a_call(torch, da.decode_attention, sets,
                                f"K5 B={b} S={s} N={n} D={d}", tag)
    keys = int(np.minimum(lens, s).sum())
    nbytes = 2 * b * n * d * 4 + b * 4 + 2 * keys * n * d * 4
    bnd, by = bound_ms(nbytes, 4.0 * keys * n * d)
    k5 = {"name": "K5 decode_attention", "route": "cuda",
          "source": "paddle_tpu_torch/csrc/decode_attention.cu",
          "replaces": "paddle_tpu/ops/pallas/flash_attention.py:954",
          "max_abs_err": err5,
          "ms": timed_ms(torch, da.decode_attention, sets),
          "plain_ms": timed_ms(torch, da.decode_attention_reference, sets),
          "bound_ms": bnd, "bound_by": by,
          "library_ms": timed_ms(torch, k5_library, sets),
          "kernels": kernels, "split": f32_split(da, s, d),
          "shape": f"B={b} S={s} N={n} D={d} lengths={lens.tolist()}"}
    print(f"K5 B={b} S={s} N={n} D={d}: {k5['split']}, "
          f"max_abs_err={err5:.3g} "
          f"kernel_ms={k5['ms']:.5f} plain_ms={k5['plain_ms']:.5f} "
          f"library_ms={k5['library_ms']:.5f} "
          f"bound_us={bnd * 1e3:.3f} ({by}) {tag}")

    return k5


#: phase 2's K6 and K7 cases (B, C, D): decode C = 1, the shortest chunk
#: C = 2, the verify chunk C = 5, the prefill buckets 8, 16, 64 and 512
#: at B = 8, the main path's prefill (one slot, C = 512) and head dims 32
#: and 128
K7_CASES = ((8, 1, 64), (8, 2, 64), (8, 5, 64), (8, 8, 64), (8, 16, 64),
            (8, 64, 64), (8, 512, 64), (1, 512, 64), (8, 64, 32),
            (8, 64, 128))
K6_CASES = K7_CASES


def window_pairs(c, lens, cap):
    """(distinct keys, (row, key) pairs) of a chunk of c rows over slots
    of committed lengths `lens` in windows of cap keys."""
    distinct = int(np.minimum(lens + c, cap).sum())
    pairs = int(sum(np.minimum(ln + np.arange(c) + 1, cap).sum()
                    for ln in lens))
    return distinct, pairs


def k6_bound(b, c, n, d, lens, m, bs, route):
    """(bound ms, what bounds it) of one K6 call: bytes (q in, out, the
    tables, lengths and each distinct key's f32 K and V rows once) over
    3.35 TB/s against operations (4 per (row, key) pair per element) at
    the route's rate: f32 on the CUDA cores (67 TFLOP/s) for the decode
    route; six bf16 products per f32 product on the tensor cores (6 x 4 x
    pairs x N x D at 989 TFLOP/s) for the chunk route."""
    distinct, pairs = window_pairs(c, lens, m * bs)
    nbytes = (2 * b * c * n * d * 4 + b * m * 4 + b * 4
              + 2 * distinct * n * d * 4)
    flops = 4.0 * pairs * n * d
    if route == "chunk":
        return bound_ms(nbytes, 6 * flops, BF16_FLOPS)
    return bound_ms(nbytes, flops)


def case_lengths(rng, b, c, cap):
    """Committed lengths of a phase-2 case: an empty window, one key, 511
    and a full window, then random ones; 0 for the main path's one-slot
    prefill (a prompt from nothing)."""
    top = cap - c
    lens = np.concatenate([[0, 1, min(511, top), top],
                           rng.randint(0, top + 1, size=4)])[:b]
    return (np.zeros(1) if b == 1 else lens).astype(np.int32)


def check_paged_kernel(torch, da, seed, tag, copies=4):
    """Phase 2, K6: paged attention over f32 pools (K at 3x the scale of
    V, as K7's), block_size 8, M=128 over a shuffled pool, N=12, at
    K6_CASES: max |kernel - plain| <= TOL, every C below PAGED_TC_MIN_C
    (1, 2, 5) on the CUDA-core kernel (one kernel a call by the
    profiler's rows) and every longer chunk on the tensor-core kernel
    (each case's route read from the launch counters). Each case is timed beside its
    plain version, SDPA on the gathered window (gathered outside the
    call; a yardstick the port never calls) and its route's bound; at
    B=8, D=64 each chunk is also timed on both kernels (the threshold
    moved for the call), the crossover PAGED_TC_MIN_C is read from.
    Returns the
    summary dicts of the decode route (C = 1) and of the chunk route
    (the main path's B = 1, C = 512)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    rng = np.random.RandomState(seed + 5)
    n, bs, m = 12, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)

    def library(q, kp, vp, tab, ln, wk, wv):
        lim = ln[:, None] + torch.arange(q.shape[1], device=dev)[None] + 1
        mask = (torch.arange(m * bs, device=dev)[None, None]
                < lim[..., None])
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), wk, wv, attn_mask=mask[:, None])

    rows, err_all, pools = [], 0.0, {}
    for b, c, d in K6_CASES:
        if (b, d) not in pools:
            pools.clear()
            torch.cuda.empty_cache()
            nb = b * m + 1
            perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
            pools[(b, d)] = (torch.tensor(perm.reshape(b, m), device=dev),
                             [(3.0 * randn(nb, bs, n, d), randn(nb, bs, n, d))
                              for _ in range(copies)])
        tables, made = pools[(b, d)]
        win = tables.long()
        lens = case_lengths(rng, b, c, m * bs)
        lengths = torch.tensor(lens, device=dev)
        sets = [(randn(b, c, n, d), kp, vp, tables, lengths)
                for kp, vp in made]
        route = "chunk" if c >= da.PAGED_TC_MIN_C else "decode"
        want = da.paged_decode_attention_reference(*sets[0])
        before = da.launch_counts["paged_prefill_attention"]
        got = da.paged_decode_attention(*sets[0])
        torch.cuda.synchronize()
        took = ("chunk" if da.launch_counts["paged_prefill_attention"]
                > before else "decode")
        assert took == route, (c, took)
        err = float((got - want).abs().max())
        assert got.shape == (b, c, n, d) and bool(torch.isfinite(got).all())
        assert err <= TOL, (f"K6 B={b} C={c} D={d} {route} route: "
                            f"max |kernel - plain| {err} > {TOL}")
        err_all = max(err_all, err)
        lib_sets = [a + (kp[win].reshape(b, m * bs, n, d).transpose(1, 2),
                         vp[win].reshape(b, m * bs, n, d).transpose(1, 2))
                    for a, (kp, vp) in zip(sets, made)]
        split = ""
        if route == "decode":   # one launch a call: the profiler's rows
            row_kernels = one_kernel_a_call(
                torch, da.paged_decode_attention, sets,
                f"K6 B={b} C={c} D={d}", tag)
            split = f"{f32_split(da, m * bs, d)}, "
        row = {"B": b, "C": c, "D": d, "route": route, "max_abs_err": err,
               "kernels": row_kernels if route == "decode" else None,
               "ms": timed_ms(torch, da.paged_decode_attention, sets),
               "plain_ms": timed_ms(
                   torch, da.paged_decode_attention_reference, sets),
               "library_ms": timed_ms(torch, library, lib_sets),
               "lengths": lens.tolist()}
        row["bound_ms"], row["bound_by"] = k6_bound(b, c, n, d, lens, m, bs,
                                                    route)
        core = ""
        if c > 1 and b == 8 and d == 64:   # the crossover: both kernels
            threshold = da.PAGED_TC_MIN_C
            try:
                for key, forced in (("cuda_core_ms", 1 << 30),
                                    ("tensor_core_ms", 2)):
                    da.PAGED_TC_MIN_C = forced
                    got = da.paged_decode_attention(*sets[0])
                    torch.cuda.synchronize()
                    forced_err = float((got - want).abs().max())
                    assert forced_err <= TOL, (c, key, forced_err)
                    row[key] = timed_ms(torch, da.paged_decode_attention,
                                        sets)
            finally:
                da.PAGED_TC_MIN_C = threshold
            core = (f" (crossover: cuda_core_ms={row['cuda_core_ms']:.5f} "
                    f"tensor_core_ms={row['tensor_core_ms']:.5f})")
        rows.append(row)
        print(f"K6 B={b} C={c} N={n} D={d} bs={bs} M={m}: route={route} "
              f"{split}max_abs_err={err:.3g} kernel_ms={row['ms']:.5f}{core} "
              f"plain_ms={row['plain_ms']:.5f} "
              f"library_ms={row['library_ms']:.5f} (SDPA on the window, "
              f"gathered outside the call) bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) {tag}")
        del sets, lib_sets
    pools.clear()
    torch.cuda.empty_cache()

    def summary(name, pick, shape):
        r = next(x for x in rows if pick(x))
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/decode_attention.cu",
                "replaces": "paddle_tpu/ops/pallas/flash_attention.py:1131",
                "max_abs_err": err_all, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": shape, "by_case": rows}

    return (summary("K6 paged_decode_attention (decode route)",
                    lambda x: x["C"] == 1,
                    f"B=8 C=1 N={n} D=64 bs={bs} M={m} (times); "
                    f"max_abs_err over every case"),
            summary("K6 paged_prefill_attention (chunk route)",
                    lambda x: x["C"] == 512 and x["B"] == 1,
                    f"B=1 C=512 N={n} D=64 bs={bs} M={m}, lengths 0 "
                    f"(times); max_abs_err over every case"))


def k7_bound(b, c, n, d, lens, m, bs, route):
    """(bound ms, what bounds it) of one K7 call: bytes (q in, out, the
    tables, lengths and each distinct key's payload and scales once)
    over 3.35 TB/s against operations (4 per (row, key) pair per element)
    at the route's rate: the decode route's f32 on the CUDA cores (67
    TFLOP/s); the prefill route's three bf16 products per f32 product
    on the tensor cores (3 x 4 x pairs x N x D at 989 TFLOP/s)."""
    distinct, pairs = window_pairs(c, lens, m * bs)
    nbytes = (2 * b * c * n * d * 4 + b * m * 4 + b * 4
              + 2 * distinct * (n * d + 4))
    flops = 4.0 * pairs * n * d
    if route == "prefill":
        return bound_ms(nbytes, 3 * flops, BF16_FLOPS)
    return bound_ms(nbytes, flops)


def check_quantized_kernel(torch, da, gen, seed, tag, copies=4):
    """Phase 2, K7: paged attention over int8 and float8 e4m3 pools
    (payloads and scales from the engine's own row quantizer), block_size
    8, M=128 over a shuffled pool, N=12, at K7_CASES: max |kernel - plain|
    <= TOL (C = 1 on the decode kernel, one kernel a call by the
    profiler's rows; longer chunks on the prefill kernel). Each case is
    timed beside its plain version, SDPA on the
    dequantized gathered window (gathered and dequantized outside the
    call; a yardstick the port never calls) and its route's bound.
    Returns the summary dicts of the decode route (C = 1) and of the
    prefill route (the main path's B = 1, C = 512), int8."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    rng = np.random.RandomState(seed + 7)
    n, bs, m = 12, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)

    def library(q, kq, vq, ks, vs, tab, ln, wk, wv):
        lim = ln[:, None] + torch.arange(q.shape[1], device=dev)[None] + 1
        mask = (torch.arange(m * bs, device=dev)[None, None]
                < lim[..., None])
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), wk, wv, attn_mask=mask[:, None])

    rows, err_all = [], 0.0
    for kv_dtype in ("int8", "fp8_e4m3"):
        pools = {}
        for b, c, d in K7_CASES:
            if (b, d) not in pools:
                nb = b * m + 1
                perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
                tables = torch.tensor(perm.reshape(b, m), device=dev)
                made = []
                for _ in range(copies):
                    kq, ks = gen._kv_quantize_rows(
                        3.0 * randn(nb, bs, n, d), kv_dtype)
                    vq, vs = gen._kv_quantize_rows(randn(nb, bs, n, d),
                                                   kv_dtype)
                    made.append((kq, vq, ks, vs))
                assert made[0][0].dtype == gen.kv_torch_dtype(kv_dtype)
                pools[(b, d)] = (tables, made)
            tables, made = pools[(b, d)]
            win = tables.long()

            def deq(pool, scale):
                """The dequantized window [B, N, M * bs, D] SDPA reads."""
                w = pool.view(torch.uint8)[win].view(pool.dtype).float()
                w = w * scale[win][..., None, None]
                return w.reshape(b, m * bs, n, d).transpose(1, 2).contiguous()

            lens = case_lengths(rng, b, c, m * bs)
            lengths = torch.tensor(lens, device=dev)
            sets = [(randn(b, c, n, d),) + pool + (tables, lengths)
                    for pool in made]
            route = "decode" if c == 1 else "prefill"
            want = da.quantized_paged_decode_attention_reference(*sets[0])
            before = da.launch_counts["quantized_paged_prefill_attention"]
            got = da.quantized_paged_decode_attention(*sets[0])
            torch.cuda.synchronize()
            took = ("prefill" if da.launch_counts[
                "quantized_paged_prefill_attention"] > before else "decode")
            assert took == route, (c, took)
            err = float((got - want).abs().max())
            assert got.shape == (b, c, n, d) and bool(
                torch.isfinite(got).all())
            assert err <= TOL, (f"K7 {kv_dtype} B={b} C={c} D={d} {route} "
                                f"route: max |kernel - plain| {err} > {TOL}")
            err_all = max(err_all, err)
            lib_sets = [a + (deq(a[1], a[3]), deq(a[2], a[4])) for a in sets]
            kernels = None
            if route == "decode":   # one launch a call: the profiler's rows
                kernels = kernel_rows(torch,
                                      da.quantized_paged_decode_attention,
                                      sets)
                assert len(kernels) == 1 and kernels[0][
                    "launches_per_call"] == 1 and "qattn_decode_kernel" in \
                    kernels[0]["name"], kernels
            row = {"kv_dtype": kv_dtype, "B": b, "C": c, "D": d,
                   "route": route, "max_abs_err": err, "kernels": kernels,
                   "ms": timed_ms(torch, da.quantized_paged_decode_attention,
                                  sets),
                   "plain_ms": timed_ms(
                       torch, da.quantized_paged_decode_attention_reference,
                       sets),
                   "library_ms": timed_ms(torch, library, lib_sets),
                   "lengths": lens.tolist()}
            row["bound_ms"], row["bound_by"] = k7_bound(b, c, n, d, lens, m,
                                                        bs, route)
            rows.append(row)
            if kernels:
                print(f"K7 {kv_dtype} B={b} C={c} D={d}: kernels per call "
                      f"(torch.profiler): " + "; ".join(
                          f"{k['launches_per_call']:g} x {k['name'][:60]} "
                          f"{k['us_per_call']:.3f} us" for k in kernels)
                      + f" {tag}")
            print(f"K7 {kv_dtype} B={b} C={c} N={n} D={d} bs={bs} M={m}: "
                  f"route={route} max_abs_err={err:.3g} "
                  f"kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f}"
                  f" library_ms={row['library_ms']:.5f} (SDPA on the "
                  f"dequantized window, gathered outside the call) "
                  f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
                  f"{tag}")
            del sets, lib_sets
        del pools
        torch.cuda.empty_cache()

    def summary(name, pick, shape):
        r = next(x for x in rows if pick(x))
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/decode_attention.cu",
                "replaces": "paddle_tpu/ops/pallas/flash_attention.py:1302",
                "max_abs_err": err_all, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": shape, "by_case": rows}

    return (summary("K7 quantized_paged_decode_attention (decode route)",
                    lambda x: x["kv_dtype"] == "int8" and x["C"] == 1,
                    f"int8 B=8 C=1 N={n} D=64 bs={bs} M={m} (times); "
                    f"max_abs_err over every case"),
            summary("K7 quantized_paged_prefill_attention (prefill route)",
                    lambda x: (x["kv_dtype"] == "int8" and x["C"] == 512
                               and x["B"] == 1),
                    f"int8 B=1 C=512 N={n} D=64 bs={bs} M={m}, lengths 0 "
                    f"(times); max_abs_err over every case"))


def make_prompts(rng, vocab, count):
    """Half the prompts share one 256-token prefix (tails 16..256), half
    are independent (16..512 tokens); budgets 32..64 new tokens."""
    shared = rng.randint(0, vocab, size=256)
    prompts = []
    for i in range(count):
        if i % 2 == 0:
            tail = rng.randint(0, vocab, size=rng.randint(16, 257))
            p = np.concatenate([shared, tail])
        else:
            p = rng.randint(0, vocab, size=rng.randint(16, 513))
        prompts.append(p.astype(np.int32))
    budgets = [int(x) for x in rng.randint(32, 65, size=count)]
    return prompts, budgets


def top2_gap(row):
    row = np.asarray(row, np.float64)
    assert np.isfinite(row).all(), "non-finite logits"
    top = np.partition(row, -2)[-2:]
    return float(top[1] - top[0])


def compare(label, got, want, gaps):
    """Tokens must agree; a mismatch is excused only at a near-tie of
    the single-request logits, and the comparison stops there. Returns
    the number of excused positions (0 or 1)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        if gaps[i] < NEAR_TIE:
            print(f"near-tie: {label} position {i}: top-2 gap "
                  f"{gaps[i]:.3g} < {NEAR_TIE}, got {g} want {w}; "
                  f"comparison of this request stops here")
            return 1
        raise AssertionError(
            f"{label}: token {i} is {g}, single-request greedy gives {w} "
            f"(top-2 gap {gaps[i]:.3g})")
    assert len(got) == len(want), (
        f"{label}: {len(got)} tokens, expected {len(want)}")
    return 0


def dev_us(e):
    """Device microseconds of a torch.profiler row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_rows(torch, run):
    """torch.profiler's device-side rows over `run()`: a CPU op's row
    also carries the device time of the kernels it launched, which would
    count them twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]


def kernel_rows(torch, fn, argsets, calls=20):
    """The kernels one call of `fn` launches, from the profiler's device
    rows over `calls` calls (rotating `argsets`, each warmed once):
    [{"name", "launches_per_call", "us_per_call"}]."""
    for a in argsets:
        fn(*a)
    torch.cuda.synchronize()

    def run():
        for i in range(calls):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()

    return [{"name": e.key, "launches_per_call": e.count / calls,
             "us_per_call": dev_us(e) / calls}
            for e in device_rows(torch, run)]


def profile_device(torch, run, steps, top=8):
    """Host wall time per step of `run(steps)` (which ends in a
    synchronisation), then device time per step, the idle share and the
    top kernels from torch.profiler over a second `run(steps)`."""
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    events = device_rows(torch, lambda: run(steps))
    device_ms = sum(dev_us(e) for e in events) / steps / 1e3
    ranked = sorted(events, key=dev_us, reverse=True)[:top]
    return {"step_wall_ms": wall_ms,
            "step_device_ms": device_ms if events else None,
            "device_idle_share": (1.0 - device_ms / wall_ms
                                  if events else None),
            "top_kernels": [{"name": e.key[:80],
                             "us_per_step": dev_us(e) / steps,
                             "calls_per_step": e.count / steps}
                            for e in ranked]}


def print_profile(label, brk, tag):
    dev = ("not measured (the profiler saw no device time)"
           if brk["step_device_ms"] is None else
           f"{brk['step_device_ms']:.3f} ms on the device, idle share "
           f"{brk['device_idle_share']:.3f}")
    print(f"{label}: {brk['step_wall_ms']:.3f} ms wall, {dev} {tag}")
    for k in brk["top_kernels"]:
        print(f"  {k['us_per_step']:9.2f} us/step  "
              f"{k['calls_per_step']:6.1f} calls/step  {k['name']}")


def step_breakdown(torch, gen, model, prompts, steps=20, kv_dtype=None):
    """Where one decode step's time goes with 8 live slots, on the
    contiguous engine (kv_dtype None) or on a paged engine of kv_dtype
    (plain chunk=1 ticks): host wall time per step (synchronised), device
    time per step and the top kernels from torch.profiler, and the
    device's idle share."""
    if kv_dtype is None:
        eng = gen.DecodeEngine(model, batch_size=8, max_len=1024)
    else:
        eng = gen.PagedDecodeEngine(model, batch_size=8, max_len=1024,
                                    block_size=8, spec_k=0,
                                    kv_dtype=kv_dtype)
    state = eng.init_state()
    tokens = np.zeros(8, np.int32)
    for i in range(8):
        if kv_dtype is None:
            state, row = eng.prefill(state, i, prompts[i])
        else:   # room for the 3 + 2 x steps ticks below
            state, row, _ = eng.admit(state, i, prompts[i],
                                      prompts[i].size + 4 + 2 * steps)
        tokens[i] = int(np.argmax(row))
    active = np.ones(8, bool)

    def run(n):
        nonlocal state, tokens
        for _ in range(n):
            state, logits = eng.step(state, tokens, active)
            tokens = logits.argmax(axis=-1).astype(np.int32)
        torch.cuda.synchronize()

    run(3)
    out = profile_device(torch, run, steps)
    del eng, state
    return out


def serve(server_cls, engine, prompts, budgets, **kw):
    """Submit every request at once to a fresh server; returns (token
    lists, ttft seconds, wall seconds, stats)."""
    srv = server_cls(engine, **kw)
    try:
        t0 = time.perf_counter()
        reqs = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
        results = [r.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        stats = srv.stats()
    finally:
        srv.shutdown(drain=False, timeout=60)
    return ([r["tokens"] for r in results],
            [r["ttft_s"] for r in results], wall, stats)


# ---------------------------------------------------------------------------
# the quantized paged-KV slice: K7, the spill tier, the ladder, relocation
# ---------------------------------------------------------------------------

#: mean |logits_q - logits_f32| / mean |logits_f32| under teacher forcing
#: (the JAX package's gates, tests/test_quantized_serving.py)
FIDELITY_GATE = {"int8": 0.05, "fp8_e4m3": 0.35}
QUANT_DTYPES = ("int8", "fp8_e4m3")


def paged_greedy(gen, model, prompts, budgets, kv_dtype, num_blocks=None,
                 forced=None):
    """One request at a time through a batch_size=1, spec_k=0 paged
    engine of `kv_dtype`, in submission order with prefix reuse on, as
    the server admits them. Greedy, or teacher-forced along `forced`
    streams. Returns (token lists, top-2 gap lists, and the logits rows
    of teacher-forced runs)."""
    eng = gen.PagedDecodeEngine(model, batch_size=1, max_len=1024,
                                block_size=8, num_blocks=num_blocks,
                                spec_k=0, kv_dtype=kv_dtype)
    assert eng.kv_dtype == kv_dtype, (eng.kv_dtype, kv_dtype)
    state = eng.init_state()
    streams, gaps, rows = [], [], []
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        state, row, _ = eng.admit(state, 0, p, total_len=p.size + n)
        toks, g, r = [], [], []
        while True:
            g.append(top2_gap(row))
            if forced is not None:
                r.append(row)
            toks.append(int(np.argmax(row)) if forced is None
                        else forced[i][len(toks)])
            if len(toks) >= n:
                break
            state, logits = eng.step(state, np.asarray([toks[-1]]),
                                     np.asarray([True]))
            row = logits[0]
        eng.free_slot(0)
        streams.append(toks)
        gaps.append(g)
        rows.append(r)
    return streams, gaps, rows


def fidelity(gen, model, prompts, streams, count=8):
    """Teacher-force the f32 phase's streams of the first `count`
    requests through batch_size=1 engines of each dtype: mean |logits_q -
    logits_f32| / mean |logits_f32| per quantized dtype."""
    sums = {dt: 0.0 for dt in QUANT_DTYPES}
    ref_sum = 0.0
    for i in range(count):
        one = ([prompts[i]], [len(streams[i])])
        _, _, (f32,) = paged_greedy(gen, model, *one, "f32",
                                    forced=[streams[i]])
        f32 = np.stack(f32)
        ref_sum += float(np.abs(f32).sum())
        for dt in QUANT_DTYPES:
            _, _, (q,) = paged_greedy(gen, model, *one, dt,
                                      forced=[streams[i]])
            sums[dt] += float(np.abs(np.stack(q) - f32).sum())
    return {dt: v / ref_sum for dt, v in sums.items()}


def agreement(got, want):
    """Positions equal and requests equal in full, of got against want."""
    same = sum(int(a == b) for g, w in zip(got, want) for a, b in zip(g, w))
    total = sum(min(len(g), len(w)) for g, w in zip(got, want))
    return same / total, sum(int(g == w) for g, w in zip(got, want))


#: --latency's prompt lengths (prefill chunks of 16 .. 1024 rows)
LATENCY_LENS = (16, 64, 128, 256, 512, 1000)
#: --latency's pools: f32 (K6), int8 and fp8 (K7)
LATENCY_DTYPES = ("f32",) + QUANT_DTYPES


def latency(torch, seed, reps=7):
    """--latency: with the port found first on sys.path, for f32 (phase
    4's engine), int8 and fp8 pools, the wall time (synchronised) of one
    admission (a random
    prompt prefilled from an empty window, prefix reuse off) on a
    batch_size=1 engine at LATENCY_LENS, the median of the last reps - 2
    of reps admissions, then tokens/s and p50 TTFT of 16 requests
    (make_prompts) on a batch_size=8, spec_k=4 engine with an NgramDraft.
    Only the engine's and the server's public API is used, so any
    checkout of the port can be measured. Returns the dict it prints."""
    from paddle_tpu_torch.ops import generation as gen
    from paddle_tpu_torch.serving.generation import GenerationServer
    cfg = gen.LMConfig(**GPT2_SMALL)
    model = gen.TinyDecoderLM(cfg).init_params(seed)
    rng = np.random.RandomState(seed)
    out = {"card": card_line()}
    for dt in LATENCY_DTYPES:
        eng = gen.PagedDecodeEngine(model, batch_size=1, max_len=1024,
                                    block_size=8, spec_k=0, kv_dtype=dt)
        eng.warmup()
        state = eng.init_state()
        res = {}
        for n in LATENCY_LENS:
            prompt = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _, _ = eng.admit(state, 0, prompt, n + 1,
                                        prefix_reuse=False)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                eng.free_slot(0)
            res[n] = float(np.median(times[2:]))
        out[f"prefill_ms_{dt}"] = res
        del eng, state
        torch.cuda.empty_cache()
    prompts, budgets = make_prompts(np.random.RandomState(seed),
                                    cfg.vocab_size, 16)
    for dt in LATENCY_DTYPES:
        eng = gen.PagedDecodeEngine(model, batch_size=8, max_len=1024,
                                    block_size=8, spec_k=4, kv_dtype=dt)
        eng.warmup()
        toks, ttft, wall, stats = serve(GenerationServer, eng, prompts,
                                        budgets,
                                        draft=gen.NgramDraft(cfg.vocab_size))
        out[f"serve_{dt}"] = {
            "tokens_per_s": sum(map(len, toks)) / wall,
            "p50_ttft_ms": float(np.median(ttft)) * 1e3,
            "steps": stats["counters"]["steps"]}
        del eng
        torch.cuda.empty_cache()
    return out


def decode_rows(torch, seed, calls=50):
    """--decode-rows: with the port found first on sys.path, the decode
    routes at phase 2's cases, each kernel a call launches with its
    device time (torch.profiler rows over `calls` calls) and the call's
    time (timed_ms): K5 (B=8, S=1024, N=12, D=64, k5_lengths; and at
    phase 5's lengths, its 8 prompts after 20 decode steps) and K6's
    decode route at C = 1 and C = 2 (B=8, N=12, D=64, block_size 8,
    M=128 over a shuffled pool, case_lengths); then K7's (C = 1), int8
    and fp8, with the key ranges the wrapper picks and with one range
    (its split functions patched to 1). Only the wrappers'
    public functions are called, so any checkout of the port can be
    measured. Returns the dict it prints."""
    from paddle_tpu_torch.ops import generation as gen
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    dev = torch.device("cuda")
    out = {"card": card_line()}

    def measure(key, fn, ref, sets):
        got = fn(*sets[0])
        want = ref(*sets[0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= TOL, (key, err)
        out[key] = {"max_abs_err": err,
                    "kernels": kernel_rows(torch, fn, sets, calls),
                    "ms": timed_ms(torch, fn, sets)}

    # K5 and K6's decode route, phase 2's inputs from the same seeds
    g = torch.Generator(device=dev).manual_seed(seed)
    b, s, n, d = K5_CASE
    lengths = torch.tensor(k5_lengths(np.random.RandomState(seed), b, s),
                           device=dev)
    k5_sets = [tuple(torch.randn(shape, generator=g, device=dev)
                     for shape in ((b, n, d), (b, s, n, d), (b, s, n, d)))
               + (lengths,) for _ in range(4)]
    prompts, _ = make_prompts(np.random.RandomState(seed), GPT2_SMALL[
        "vocab_size"], 16)
    step_lengths = torch.tensor([p.size + 20 for p in prompts[:b]],
                                dtype=torch.int32, device=dev)
    rng = np.random.RandomState(seed + 5)
    bs, m = 8, 128
    nb = b * m + 1
    tables = torch.tensor(rng.permutation(np.arange(1, nb)).astype(
        np.int32).reshape(b, m), device=dev)
    pools = [(3.0 * torch.randn((nb, bs, n, d), generator=g, device=dev),
              torch.randn((nb, bs, n, d), generator=g, device=dev))
             for _ in range(4)]
    k6_sets = {}
    for c in (1, 2):
        ln = torch.tensor(case_lengths(rng, b, c, m * bs), device=dev)
        k6_sets[c] = [(torch.randn((b, c, n, d), generator=g, device=dev),
                       kp, vp, tables, ln) for kp, vp in pools]
    measure("K5", da.decode_attention, da.decode_attention_reference,
            k5_sets)
    measure("K5 at phase 5's lengths", da.decode_attention,
            da.decode_attention_reference,
            [x[:3] + (step_lengths,) for x in k5_sets])
    for c, sets in k6_sets.items():
        measure(f"K6 C={c}", da.paged_decode_attention,
                da.paged_decode_attention_reference, sets)
    del k5_sets, k6_sets, pools
    torch.cuda.empty_cache()

    # K7's decode route
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    rng = np.random.RandomState(seed + 7)
    tables = torch.tensor(rng.permutation(np.arange(1, nb)).astype(
        np.int32).reshape(b, m), device=dev)
    lengths = torch.tensor(case_lengths(rng, b, 1, m * bs), device=dev)
    for dt in QUANT_DTYPES:
        sets = []
        for _ in range(4):
            kq, ks = gen._kv_quantize_rows(3.0 * torch.randn(
                (nb, bs, n, d), generator=g, device=dev), dt)
            vq, vs = gen._kv_quantize_rows(torch.randn(
                (nb, bs, n, d), generator=g, device=dev), dt)
            sets.append((torch.randn((b, 1, n, d), generator=g, device=dev),
                         kq, vq, ks, vs, tables, lengths))
        for label in ("wrapper's split", "one range"):
            saved = {f: getattr(da, f) for f in ("split_count",
                                                 "decode_split_count")
                     if hasattr(da, f)}
            if label == "one range":
                for f in saved:
                    setattr(da, f, lambda *a, **k: 1)
            try:
                measure(f"{dt}, {label}", da.quantized_paged_decode_attention,
                        da.quantized_paged_decode_attention_reference, sets)
            finally:
                for f, v in saved.items():
                    setattr(da, f, v)
        del sets
    return out


# ---------------------------------------------------------------------------
# the BERT-base pretraining slice: flash kernels K1-K4 and the train step
# ---------------------------------------------------------------------------

#: max |kernel - plain| / max |plain| per output. float32 with TF32 off:
#: summation order only. bfloat16: the same bf16 inputs on both sides,
#: but the kernels round p (unnormalised, online) and ds to bf16 where
#: the plain version rounds the normalised probabilities, and outputs
#: keep 8 bits.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: flash vs einsum inside BERT-base, float32, TF32 off: the loss
#: (relative) and each parameter's gradient (max abs diff over max abs)
MODEL_LOSS_TOL = 1e-5
MODEL_GRAD_TOL = 1e-4
#: the flash kernels of each dtype, all on the tensor cores: bfloat16 (the
#: main path's) and float32 in three bf16 pieces (phase 8's)
FLASH_BF16 = ("flash_fwd", "flash_bwd")
FLASH_F32 = ("flash_fwd_f32", "flash_bwd_f32")
FLASH_KERNELS = FLASH_BF16 + FLASH_F32
#: which outputs each flash kernel writes
FLASH_OUTPUTS = {"flash_fwd": ("o", "lse"),
                 "flash_bwd": ("dq", "dk", "dv", "dmask"),
                 "flash_fwd_f32": ("o", "lse"),
                 "flash_bwd_f32": ("dq", "dk", "dv", "dmask")}
_PALLAS = "paddle_tpu/ops/pallas/flash_attention.py"
_FWD_REPLACES = f"{_PALLAS}:160 (_fwd_kernel, K1), :280 (_fwd1_kernel, K4f)"
_BWD_REPLACES = (f"{_PALLAS}:468 (_bwd_dkv_kernel, K2), :543 "
                 "(_bwd_dq_kernel, K3), :311 (_bwd1_kernel, K4b)")
FLASH_REPLACES = {"flash_fwd": _FWD_REPLACES, "flash_bwd": _BWD_REPLACES,
                  "flash_fwd_f32": _FWD_REPLACES,
                  "flash_bwd_f32": _BWD_REPLACES}
_CSRC = "paddle_tpu_torch/csrc/"
FLASH_SOURCES = {"flash_fwd": _CSRC + "flash_attention_tc.cu",
                 "flash_bwd": _CSRC + "flash_attention_tc.cu",
                 "flash_fwd_f32": _CSRC + "flash_fwd_f32_tc.cu",
                 "flash_bwd_f32": _CSRC + "flash_bwd_f32_tc.cu"}
SEED_ATTN = 12345
BERT_BATCH, BERT_SEQ = 32, 512


def flash_inputs(torch, dev, dtype, b, t, n, d, pad, mask_grad, seed):
    """q, k, v as views of one fused [B, T, 3, N, D] tensor (as BERT's
    QKV projection gives them), dO, and the additive key mask
    [B, 1, 1, T] (zeros: an all-ones attention mask)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, t, 3, n, d), generator=g, device=dev).to(dtype)
    dout = torch.randn((b, t, n, d), generator=g, device=dev).to(dtype)
    mask = torch.zeros((b, 1, 1, t), device=dev)
    if pad:   # rows 0..3 keep 511, 384, 256 and 100 keys
        for row, keep in enumerate((t - 1, 3 * t // 4, t // 2, 100)):
            mask[row, ..., keep:] = -1e9
    if mask_grad:
        mask = mask + 0.5 * torch.randn(mask.shape, generator=g, device=dev)
    return qkv, dout, mask


def flash_case(torch, tfa, dev, dtype, b, t, n, d, causal=False, pad=False,
               rate=0.0, mask_grad=False, offset=0, seed=0):
    """Kernels and plain version on the same inputs: forward o and lse,
    and dq/dk/dv (+dmask) from one backward. With `offset`, q, k, v are
    views of a fused tensor that starts `offset` elements into its
    buffer (rows not 16-byte aligned for an offset of one float).
    Returns {output: (max abs err, relative err)}."""
    qkv, dout, mask = flash_inputs(torch, dev, dtype, b, t, n, d, pad,
                                   mask_grad, seed)
    seed_k = SEED_ATTN if rate else None
    res = {}
    for side in ("kernel", "plain"):
        buf = torch.empty(qkv.numel() + offset, dtype=dtype, device=dev)
        buf[offset:].copy_(qkv.reshape(-1))
        buf.requires_grad_()
        x = buf[offset:].view(qkv.shape)
        m = mask.detach().clone().requires_grad_(mask_grad)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        if side == "kernel":
            o = tfa.flash_attention(q, k, v, m, causal=causal,
                                    dropout_rate=rate, dropout_seed=seed_k,
                                    mask_grad=mask_grad)
            cfg = (causal, 1.0 / d ** 0.5, rate, seed_k)
            _, lse = tfa._launch_fwd(q.detach(), k.detach(), v.detach(),
                                     mask.reshape(b, t).contiguous(), cfg)
            lse = lse.permute(0, 2, 1)[..., None]
        else:
            keep = (tfa.batch_keep_masks(SEED_ATTN, b, n, t, t, rate,
                                         device=dev) if rate else None)
            o, lse = tfa.attention_reference(q, k, v, m, causal,
                                             keep_masks=keep,
                                             return_lse=True)
        (o.float() * dout.float()).sum().backward()
        grad = buf.grad[offset:].view(qkv.shape)
        res[side] = {"o": o.detach(), "lse": lse.detach(),
                     "dq": grad[:, :, 0], "dk": grad[:, :, 1],
                     "dv": grad[:, :, 2]}
        if mask_grad:
            res[side]["dmask"] = m.grad
    torch.cuda.synchronize()
    out = {}
    for key, want in res["plain"].items():
        got, want = res["kernel"][key].float(), want.float()
        diff = float((got - want).abs().max())
        assert bool(torch.isfinite(got).all()), f"{key}: non-finite values"
        out[key] = (diff, diff / max(float(want.abs().max()), 1e-30))
    return out


#: the kernels whose ptxas lines and SASS the build report checks: mangled
#: name stem -> (instantiations, opcodes its SASS must hold, opcodes it
#: must not). The bf16 and f32 flash pairs, K6's and K7's chunk routes
#: and K8's weight-only mode run on wgmma (HGMMA); K8's int8
#: mode on mma.sync s8 (IMMA), with no dp4a left; the decode kernels on
#: the CUDA cores (K7's; K5's and K6's f32_decode_kernel) are listed for
#: their ptxas lines (0 spill).
BUILD_CHECKS = {
    "flash_fwd_tc_kernel": (3, ("HGMMA",), ()),
    "flash_bwd_tc_kernel": (3, ("HGMMA",), ()),
    "flash_fwd_f32_tc_kernel": (3, ("HGMMA",), ()),
    "flash_bwd_f32_tc_kernel": (3, ("HGMMA",), ()),
    "qattn_prefill_tc_kernel": (6, ("HGMMA",), ()),
    "paged_prefill_tc_kernel": (3, ("HGMMA",), ()),
    "qattn_decode_kernel": (6, (), ()),
    "f32_decode_kernel": (12, (), ()),
    "qmm_int8_tc_kernel": (2, ("IMMA",), ("IDP4A",)),
    "qmm_weight_only_tc_kernel": (5, ("HGMMA",), ()),
}
SASS_OPS = ("HGMMA", "HMMA", "IMMA", "IDP4A")


def build_report(info, tag):
    """The tensor-core kernels as built: each instantiation's ptxas line
    (registers, shared memory, spills) and the count of HGMMA, HMMA,
    IMMA and IDP4A instructions in its SASS, from `cuobjdump -sass` of
    the built library. Fails unless every instantiation in BUILD_CHECKS
    spills nothing, holds its required opcodes and none it must not."""
    import re
    import shutil
    log = info["nvcc_log"]
    if not log and os.path.exists(info["path"] + ".log"):
        with open(info["path"] + ".log") as f:
            log = f.read()

    def label(mangled):
        stem = next((k for k in BUILD_CHECKS if k in mangled), None)
        if stem is None:
            return None
        targs = re.findall(r"L[ib](\d+)E", mangled.split(stem, 1)[1])
        return f"{stem}<{','.join(targs)}>"

    report, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = label(line)
        elif current and ("Used" in line or "spill" in line):
            row = report.setdefault(current, {"ptxas": []})
            row["ptxas"].append(line.split(":", 1)[-1].strip())
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                row["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", info["path"]],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = label(line)
            if current:
                report.setdefault(current, {"ptxas": []}).update(
                    {op: 0 for op in SASS_OPS})
        elif current:
            for op in SASS_OPS:
                report[current][op] += bool(re.search(rf"\b{op}\b", line))
    for stem, (count, need, banned) in BUILD_CHECKS.items():
        rows = sorted(k for k in report if k.startswith(stem + "<"))
        assert len(rows) == count, f"{stem}: instantiations {rows}"
        for name in rows:
            row = report[name]
            print(f"ptxas {name}: {'; '.join(row['ptxas'])} {tag}")
            print(f"sass {name}: " + ", ".join(
                f"{row.get(op, 0)} {op}" for op in SASS_OPS) + f" {tag}")
            for op in need:
                assert row.get(op, 0) > 0, f"{name}: no {op} in its SASS"
            for op in banned:
                assert row.get(op, 0) == 0, f"{name}: {op} in its SASS"
            assert row.get("spill_bytes") == 0, f"{name}: spills {row}"
    return report


def time_flash(torch, tfa, dtype, b, t, n, d, rate, seed, tag, copies=2):
    """The flash kernels of `dtype` timed at (b, t, n, d) with dropout
    `rate` and an all-ones mask, on q, k, v views of [B, T, 3, N, D]:
    each beside its plain version, SDPA on the same tensors (forward; dq,
    dk, dv in one backward call) and its bound. Returns {kernel: row}."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    bf16 = dtype == torch.bfloat16
    cfg = (False, 1.0 / d ** 0.5, rate, SEED_ATTN if rate else None)

    def keep():
        return (tfa.batch_keep_masks(SEED_ATTN, b, n, t, t, rate, device=dev)
                if rate else None)

    sets = []
    for i in range(copies):
        qkv, dout, mask = flash_inputs(torch, dev, dtype, b, t, n, d, False,
                                       False, seed + 1 + i)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        bias = mask.reshape(b, t).contiguous()
        o, lse = tfa._launch_fwd(q, k, v, bias, cfg)
        sets.append(dict(q=q, k=k, v=v, bias=bias, mask=mask, dout=dout,
                         lse=lse, delta=tfa.bwd_delta(o, dout)))

    def graph(s, lib):
        """A forward graph kept for timing the backward alone."""
        x = [s[key].detach().clone().requires_grad_() for key in "qkv"]
        if lib:
            out = F.scaled_dot_product_attention(
                *(a.transpose(1, 2) for a in x),
                attn_mask=s["mask"].to(dtype), dropout_p=rate)
            return x, out, s["dout"].transpose(1, 2)
        return x, tfa.attention_reference(*x, s["mask"], keep_masks=keep()), \
            s["dout"]

    def grad_of(which):
        return lambda g: torch.autograd.grad(
            g[1], [g[0][i] for i in which], g[2], retain_graph=True)

    def bwd_args(s):
        return (s["q"], s["k"], s["v"], s["bias"], s["dout"], s["lse"],
                s["delta"], cfg)

    def plain_fwd(s):
        return tfa.attention_reference(s["q"], s["k"], s["v"], s["mask"],
                                       keep_masks=keep())

    def lib_fwd(s):
        return F.scaled_dot_product_attention(
            s["q"].transpose(1, 2), s["k"].transpose(1, 2),
            s["v"].transpose(1, 2), attn_mask=s["mask"].to(dtype),
            dropout_p=rate)

    args = [(s,) for s in sets]
    plain_graphs = [(graph(s, False),) for s in sets]
    lib_graphs = [(graph(s, True),) for s in sets]
    lib_fwd_ms = timed_ms(torch, lib_fwd, args)
    lib_bwd_ms = timed_ms(torch, grad_of((0, 1, 2)), lib_graphs)
    bhttd = b * n * t * t * d
    nbytes = b * t * n * d * (2 if bf16 else 4)
    rows = b * n * t * 4
    bias_bytes = b * t * 4

    def fwd(s):
        return tfa._launch_fwd(s["q"], s["k"], s["v"], s["bias"], cfg)

    # (kernel, plain version (None: its backward graph), bytes, flops)
    if bf16:
        timings = {
            "flash_fwd": (fwd, plain_fwd, 4 * nbytes + bias_bytes + rows,
                          4 * bhttd),
            "flash_bwd": (lambda s: tfa._launch_bwd_tc(*bwd_args(s), False),
                          grad_of((0, 1, 2)),
                          7 * nbytes + 2 * rows + bias_bytes, 10 * bhttd)}
    else:
        timings = {
            # six bf16 products per f32 product on the tensor cores
            "flash_fwd_f32": (fwd, plain_fwd,
                              4 * nbytes + bias_bytes + rows, 6 * 4 * bhttd),
            "flash_bwd_f32": (
                lambda s: tfa._launch_bwd_tc(*bwd_args(s), False),
                grad_of((0, 1, 2)), 7 * nbytes + 2 * rows + bias_bytes,
                6 * 10 * bhttd)}
    dname = str(dtype).split(".")[-1]
    shape = (f"B={b} T={t} N={n} D={d} {dname} dropout {rate} (q, k, v "
             f"views of [B, T, 3, N, D])")
    out = {}
    for kname, (fn, plain, nb, flops) in timings.items():
        bnd, by = bound_ms(nb, flops, BF16_FLOPS)
        lib_ms = lib_fwd_ms if plain is plain_fwd else lib_bwd_ms
        row = out[kname] = dict(
            name=kname, route="cuda", source=FLASH_SOURCES[kname],
            replaces=FLASH_REPLACES[kname], ms=timed_ms(torch, fn, args),
            plain_ms=(timed_ms(torch, plain, args) if plain is plain_fwd
                      else timed_ms(torch, plain, plain_graphs)),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms, shape=shape)
        print(f"{kname} {shape}: kernel_ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} library_ms={lib_ms:.5f} "
              f"bound_ms={bnd:.5f} ({by}; "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s) {tag}")
    print(f"library ({dname}): SDPA forward {lib_fwd_ms:.5f} ms, SDPA "
          f"backward (dq, dk, dv together) {lib_bwd_ms:.5f} ms on the same "
          f"tensors {tag}")
    del sets, plain_graphs, lib_graphs, args
    torch.cuda.empty_cache()
    return out


def check_flash(torch, tfa, seed, tag):
    """Phase 6. The flash kernels against their plain versions: the
    tensor-core pair at BERT-base shapes (B=32, T=512, N=12, D=64, bf16:
    an all-ones mask, a padding mask, dropout 0.1), the f32 pair on the
    general path (T=1024, causal, mask_grad) and on views offset by one
    float (rows not 16-byte aligned). Then the bf16 pair timed at the
    main path's case (dropout 0.1), the f32 pair at phase 8's (batch 4,
    no dropout), and the f32 backward's T sweep (`flash_sweep`). Returns
    {kernel: summary dict}."""
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    b, t, n, d = BERT_BATCH, BERT_SEQ, 12, 64
    cases = [
        ("bf16 all-ones mask", bf16, dict(b=b, t=t, n=n, d=d)),
        ("bf16 padding mask", bf16, dict(b=b, t=t, n=n, d=d, pad=True)),
        ("bf16 dropout 0.1", bf16, dict(b=b, t=t, n=n, d=d, rate=0.1)),
        ("f32 T=1024 causal mask_grad", f32,
         dict(b=4, t=1024, n=n, d=d, causal=True, mask_grad=True)),
        # rows 4 bytes past a 16-byte boundary: the 4-byte load path
        ("f32 offset view", f32,
         dict(b=4, t=t, n=n, d=d, mask_grad=True, offset=1)),
    ]
    kernels = {k: {"max_abs_err": 0.0, "cases": {}} for k in FLASH_KERNELS}
    for label, dtype, kw in cases:
        before = dict(tfa.launch_counts)
        errs = flash_case(torch, tfa, dev, dtype, seed=seed, **kw)
        names = FLASH_BF16 if dtype == bf16 else FLASH_F32
        launched = {k for k in FLASH_KERNELS
                    if tfa.launch_counts[k] != before[k]}
        assert launched == set(names), (
            f"flash {label}: launched {sorted(launched)}, want {names}")
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        for kname in names:
            row = {k: errs[k] for k in FLASH_OUTPUTS[kname] if k in errs}
            kernels[kname]["cases"][label] = row
            kernels[kname]["max_abs_err"] = max(
                kernels[kname]["max_abs_err"], *(a for a, _ in row.values()))
        print(f"flash {label} {kw} ({', '.join(names)}): " + ", ".join(
            f"{k} abs {a:.3g} rel {r:.3g}" for k, (a, r) in errs.items())
            + f" (tolerance rel {tol}) {tag}")
        bad = {k: r for k, (_, r) in errs.items() if not r <= tol}
        assert not bad, f"flash {label}: relative errors {bad} > {tol}"
        torch.cuda.empty_cache()

    timed = time_flash(torch, tfa, bf16, b, t, n, d, 0.1, seed, tag)
    timed.update(time_flash(torch, tfa, f32, 4, t, n, d, 0.0, seed, tag))
    for kname, row in timed.items():
        kernels[kname].update(row)
    kernels["flash_bwd_f32"]["sweep"] = flash_sweep(torch, tfa, seed, tag)
    return kernels


#: the sequence lengths of the f32 backward's sweep (phase 6 and
#: --flash-sweep): B=4, N=12, D=64, each causal and not
FLASH_SWEEP_T = (128, 512, 1024, 2048)


def flash_sweep(torch, tfa, seed, tag, ts=FLASH_SWEEP_T, b=4, n=12, d=64):
    """The f32 flash backward of the port in `tfa` at (b, T, n, d), no
    mask, no dropout, T in `ts`, causal and not: the backward kernels
    called as the autograd function calls them, on q, k, v views of [B,
    T, 3, N, D], beside SDPA's f32 backward (dq, dk, dv in one call) on
    the same tensors and the bound (six bf16 products per f32 product of
    10 B N D x the (row, key) pairs the mask keeps, at 989 TFLOP/s). A
    port from before the tensor-core f32 backward (`_launch_dkv` and
    `_launch_dq`, the CUDA-core pair) is timed as its two launches, so
    --flash-sweep on a parent checkout and on this one compares the two.
    Returns {"T=<t> causal=<c>": {"ms", "library_ms", "bound_ms"}}."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    if hasattr(tfa, "_launch_dkv"):
        def bwd(s):
            tfa._launch_dkv(*s["args"], False)
            tfa._launch_dq(*s["args"])
    else:
        def bwd(s):
            tfa._launch_bwd_tc(*s["args"], False)

    def lib_bwd(s):
        return torch.autograd.grad(s["out"], s["x"], s["dout_t"],
                                   retain_graph=True)

    out = {}
    for t in ts:
        for causal in (False, True):
            cfg = (causal, 1.0 / d ** 0.5, 0.0, None)
            sets = []
            for i in range(2):
                qkv, dout, _ = flash_inputs(torch, dev, torch.float32, b, t,
                                            n, d, False, False, seed + 1 + i)
                q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
                o, lse = tfa._launch_fwd(q, k, v, None, cfg)
                x = [a.detach().clone().requires_grad_() for a in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(
                    *(a.transpose(1, 2) for a in x), is_causal=causal)
                sets.append(dict(
                    args=(q, k, v, None, dout, lse, tfa.bwd_delta(o, dout),
                          cfg),
                    x=x, out=lib_out, dout_t=dout.transpose(1, 2)))
            args = [(st,) for st in sets]
            ms = timed_ms(torch, bwd, args)
            lib_ms = timed_ms(torch, lib_bwd, args)
            pairs = t * (t + 1) // 2 if causal else t * t
            bnd, by = bound_ms(7 * b * t * n * d * 4 + 2 * b * n * t * 4,
                               6 * 10 * b * n * pairs * d, BF16_FLOPS)
            row = out[f"T={t} causal={causal}"] = dict(
                ms=ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)
            print(f"f32 flash backward sweep B={b} T={t} N={n} D={d} "
                  f"causal={causal}: kernel_ms={ms:.5f} "
                  f"library_ms={lib_ms:.5f} (SDPA f32 backward) "
                  f"bound_ms={bnd:.5f} ({by}) {tag}")
            del sets, args
            torch.cuda.empty_cache()
    return out


def flash_sweep_mode(torch, seed):
    """--flash-sweep: `flash_sweep` on the port found on sys.path."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    return {"card": card, "sweep": flash_sweep(torch, tfa, seed,
                                               f"[{card}]")}


def bert_train(torch, tfa, seed, tag, warmup=3, steps=10):
    """Phase 7. The BERT-base pretraining step at full published width
    (Devlin et al. 2019 §3 BERT-BASE, the bert-base-uncased config;
    depth not cut): bf16, flash attention with dropout, batch 32 x 512
    from synthetic_batch(0, ...), weights from the port's seeded init;
    `warmup` + `steps` steps on the repeated batch, launch counts reset
    just before the timed steps. Returns (trainer, batch, summary)."""
    from paddle_tpu_torch.models.bert import BertConfig, synthetic_batch
    from paddle_tpu_torch.models.bert_pretrain import BertPretrainer
    from paddle_tpu_torch.nn import layers
    layers.seed(seed)
    cfg = BertConfig(dtype="bfloat16", attention_impl="flash")
    t0 = time.perf_counter()
    trainer = BertPretrainer(cfg)
    data = trainer.batch(*synthetic_batch(0, BERT_BATCH, BERT_SEQ, cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.step(data) for _ in range(warmup)]
    torch.cuda.synchronize()
    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [trainer.step(data) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(tfa.launch_counts)
    losses = [float(x) for x in losses]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"
    assert losses[-1] < losses[0], (
        f"loss did not fall over {len(losses)} steps: {losses}")
    # bf16: the bf16 pair once per layer per step, no f32 kernel
    for k in FLASH_KERNELS:
        want = cfg.num_layers * steps if k in FLASH_BF16 else 0
        assert launches[k] == want, (
            f"{k} launched {launches[k]} times in {steps} steps of "
            f"{cfg.num_layers} layers (want {want})")
    n_params = sum(p.numel() for p in trainer.params.values())
    step_ms = dt / steps * 1e3
    tokens_per_s = BERT_BATCH * BERT_SEQ * steps / dt
    # bench.py's formula: 6 * N params (incl. the tied MLM head) +
    # attention 12 * L * h * seq
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_layers * cfg.hidden_size * BERT_SEQ)
    out = {"config": "BERT-base L=12 H=768 A=12 I=3072 V=30522, bf16, "
                     "flash, dropout 0.1/0.1, batch 32 x seq 512",
           "params": n_params, "init_s": init_s, "losses": losses,
           "step_ms": step_ms, "tokens_per_s": tokens_per_s,
           "mfu_bf16_989": tokens_per_s * flops_per_token / BF16_FLOPS,
           "flops_per_token": flops_per_token, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "peak_mem_gib": peak_gib}
    print(f"bert-base train: {n_params} params, losses "
          f"{[round(x, 4) for x in losses]} {tag}")
    print(f"bert-base train: {step_ms:.2f} ms/step, {tokens_per_s:.0f} "
          f"tokens/s, model-flops share {out['mfu_bf16_989']:.4f} of 989 "
          f"TFLOP/s (bench.py's flops/token formula), launches/step "
          f"{out['launches_per_step']}, peak memory {peak_gib:.2f} GiB {tag}")
    return trainer, data, out


def flash_vs_einsum(torch, tfa, trainer, tag, batch=4):
    """Phase 8. The trained BERT-base weights in f32, eval(), batch 4 x
    512 with a padding mask on one row: pretrain_loss and every
    parameter's gradient under attention_impl="flash" against "xla"."""
    import dataclasses
    from paddle_tpu_torch.models.bert import Bert, synthetic_batch
    from paddle_tpu_torch.nn.train import value_and_grad
    cfg = dataclasses.replace(trainer.cfg, dtype="float32",
                              attention_impl="xla")
    model = Bert(cfg)
    model.load_state_dict(trainer.master)
    model.eval()
    arrays = list(synthetic_batch(1, batch, BERT_SEQ, cfg))
    arrays[2][0, BERT_SEQ - 100:] = 0
    data = trainer.batch(*arrays)
    res = {}
    for impl in ("xla", "flash"):
        cfg.attention_impl = impl      # shared by every layer
        tfa.reset_launch_counts()
        loss, grads = value_and_grad(lambda: model.pretrain_loss(*data),
                                     model)()
        res[impl] = (float(loss), grads)
        # f32: the f32 pair once per layer, never the bf16 pair
        want = cfg.num_layers if impl == "flash" else 0
        assert all(tfa.launch_counts[k] == (want if k in FLASH_F32 else 0)
                   for k in FLASH_KERNELS), (
            f"{impl}: flash launches {tfa.launch_counts}")
    (lx, gx), (lf, gf) = res["xla"], res["flash"]
    loss_err = abs(lf - lx) / abs(lx)
    grad_err = {k: float((gf[k] - gx[k]).abs().max()
                         / gx[k].abs().max().clamp_min(1e-30)) for k in gx}
    worst = max(grad_err, key=grad_err.get)
    print(f"flash vs einsum, BERT-base f32 eval batch {batch} x {BERT_SEQ}: "
          f"loss {lf:.6f} vs {lx:.6f} (rel {loss_err:.3g}, tolerance "
          f"{MODEL_LOSS_TOL}); worst gradient {worst} rel "
          f"{grad_err[worst]:.3g} (tolerance {MODEL_GRAD_TOL}) {tag}")
    assert np.isfinite(lf) and loss_err <= MODEL_LOSS_TOL, (lf, lx)
    assert grad_err[worst] <= MODEL_GRAD_TOL, (worst, grad_err[worst])
    del model, res
    torch.cuda.empty_cache()
    return {"loss_flash": lf, "loss_xla": lx, "loss_rel_err": loss_err,
            "worst_grad": worst, "worst_grad_rel_err": grad_err[worst]}


# ---------------------------------------------------------------------------
# the Fluid static serving slice: K8 and ResNet-50 int8 through the Predictor
# ---------------------------------------------------------------------------

#: phase 11's (M, K, N): the ResNet-50 fc at batch 32, 8 and 1 (the main
#: path's K8 calls), the BERT-base FFN up-projection at 32 x 128 tokens
#: (a GEMM that fills the card) and two odd shapes (edge tiles)
K8_SHAPES = ((32, 2048, 1000), (8, 2048, 1000), (1, 2048, 1000),
             (4096, 768, 3072), (5, 33, 17), (130, 257, 129))
#: weight-only mode: max |kernel - plain| <= K8_WO_TOL * max |plain|
K8_WO_TOL = 1e-5
#: int8 serving: mean |logits_int8 - logits_f32| / mean |logits_f32|,
#: the JAX package's int8 Predictor gate
#: (tests/test_inference_checkpoint.py:74-75)
INT8_FIDELITY_GATE = 0.2
RESNET_BATCHES = (1, 8, 32)
RESNET_REQUESTS_PER_BATCH = 4


def ulps(torch, a, b):
    """Max distance in units in the last place of two float32 tensors."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def check_quantized_matmul(torch, k8, seed, tag, copies=3):
    """Phase 11. K8 against its plain version on the card in both modes
    at K8_SHAPES: int8-activation mode with equal int32 accumulators and
    outputs within 1 ulp, weight-only within K8_WO_TOL of max |plain|.
    Weight-only mode runs twice on the same inputs and must give the
    same bits (its split-K sums the partials in split order). Each case
    is timed beside its plain version, its bound (max(bytes / 3.35 TB/s,
    ops / peak), bytes 4MK + KN + 4N + 4MN; int8: 2MKN at 1979 TOP/s;
    weight-only: three bf16 products per f32 product, 3 x 2MKN at 989
    TFLOP/s) and a yardstick
    the port never calls: in int8 mode, where it takes
    the shape (M > 16, K and N multiples of 8), `torch._int_mm` on the
    same int8 operands plus the rescale, whose accumulators must equal
    the kernel's; in weight-only mode an f32 `torch.matmul` (TF32 off) on
    the weight dequantized outside the call. Prints each shape's split
    counts. Returns the summary dicts of the int8 and the weight-only
    kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    rows = []
    for m, k, n in K8_SHAPES:
        sets = []
        for _ in range(copies):
            x = torch.randn((m, k), generator=g, device=dev)
            w = torch.randn((k, n), generator=g, device=dev)
            w_s = w.abs().amax(dim=0).clamp_min(1e-8)
            w_q = torch.clamp(torch.round(w / w_s * 127.0), -127, 127).to(
                torch.int8)
            sets.append((x, w_q, w_s))
        xs = float(sets[0][0].abs().max()) * 0.7
        x, w_q, w_s = sets[0]
        got, acc = k8.fused_dequant_matmul(x, w_q, w_s, x_scale=xs,
                                           return_acc=True)
        want, want_acc = k8.dequant_matmul_reference(x, w_q, w_s,
                                                     x_scale=xs,
                                                     return_acc=True)
        got_wo = k8.fused_dequant_matmul(x, w_q, w_s)
        again_wo = k8.fused_dequant_matmul(x, w_q, w_s)
        want_wo = k8.dequant_matmul_reference(x, w_q, w_s)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got_wo).all()) and got_wo.shape == (m, n)
        assert torch.equal(got_wo.view(torch.int32),
                           again_wo.view(torch.int32)), (
            f"K8 ({m}, {k}, {n}) weight-only: two calls differ")
        assert bool(torch.isfinite(got).all()) and got.shape == (m, n)
        assert torch.equal(acc, want_acc), (
            f"K8 ({m}, {k}, {n}): int32 accumulators differ in "
            f"{int((acc != want_acc).sum())} places")
        err_ulp = ulps(torch, got, want)
        assert err_ulp <= 1, f"K8 ({m}, {k}, {n}) int8: {err_ulp} ulps"
        wo_rel = float((got_wo - want_wo).abs().max()
                       / want_wo.abs().max())
        assert wo_rel <= K8_WO_TOL, (
            f"K8 ({m}, {k}, {n}) weight-only: {wo_rel} > {K8_WO_TOL}")
        nbytes = 4 * m * k + k * n + 4 * n + 4 * m * n
        bnd, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS)
        # weight-only: three bf16 products (x's pieces) per f32 product
        wo_bnd, wo_by = bound_ms(nbytes, 3 * 2.0 * m * k * n, BF16_FLOPS)
        args = [(a, b, c, xs) for a, b, c in sets]
        deq = [(a, b.float() * (c / 127.0)) for a, b, c in sets]
        row = {"M": m, "K": k, "N": n, "splits": k8.k8_split_count(m, k, n),
               "tile": k8.k8_tile(m), "max_ulps": err_ulp,
               "max_abs_err": float((got - want).abs().max()),
               "weight_only_rel_err": wo_rel,
               "weight_only_max_abs_err": float(
                   (got_wo - want_wo).abs().max()),
               "weight_only_splits": k8.k8_wo_split_count(m, k, n),
               "weight_only_tile": k8.k8_wo_tile(m, n),
               "ms": timed_ms(torch, lambda a, b, c, s:
                              k8.fused_dequant_matmul(a, b, c, x_scale=s),
                              args),
               "plain_ms": timed_ms(torch, lambda a, b, c, s:
                                    k8.dequant_matmul_reference(
                                        a, b, c, x_scale=s), args),
               "weight_only_ms": timed_ms(torch, k8.fused_dequant_matmul,
                                          [a[:3] for a in args]),
               "weight_only_plain_ms": timed_ms(
                   torch, k8.dequant_matmul_reference, [a[:3] for a in args]),
               "weight_only_library_ms": timed_ms(torch, torch.matmul, deq),
               "weight_only_bound_ms": wo_bnd, "weight_only_bound_by": wo_by,
               "bound_ms": bnd, "bound_by": by, "library_ms": None}
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            lib_args = [(k8.quantize_activation(a, xs),
                         b.t().contiguous().t(), c) for a, b, c in sets]
            ref = lib_args[0]
            lib_acc = torch._int_mm(ref[0], ref[1])
            torch.cuda.synchronize()
            assert torch.equal(lib_acc, want_acc), "_int_mm disagrees"
            row["library_ms"] = timed_ms(
                torch, lambda a, b, c: k8.int8_rescale(
                    torch._int_mm(a, b), xs, c), lib_args)
        rows.append(row)
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.5f}")
        print(f"K8 M={m} K={k} N={n}: int8 tile {row['tile']} splits "
              f"{row['splits']}, max_ulps={err_ulp} acc equal, "
              f"kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
              f"_int_mm+rescale_ms={lib} bound_ms={bnd:.5f} ({by}); "
              f"weight-only tile {row['weight_only_tile']} splits "
              f"{row['weight_only_splits']}, rel_err={wo_rel:.3g}, two "
              f"calls bit-equal, kernel_ms="
              f"{row['weight_only_ms']:.5f} plain_ms="
              f"{row['weight_only_plain_ms']:.5f} matmul_ms="
              f"{row['weight_only_library_ms']:.5f} bound_ms={wo_bnd:.5f} "
              f"({wo_by}) {tag}")
        del sets, args, deq
    torch.cuda.empty_cache()
    main = rows[0]
    common = {"route": "cuda",
              "source": "paddle_tpu_torch/csrc/quantized_matmul.cu",
              "replaces": "paddle_tpu/ops/pallas/quantized_matmul.py:63"}
    int8_mode = dict(
        common, name="K8 quantized_matmul",
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        shape="int8 mode M=32 K=2048 N=1000 (times); max_abs_err over "
              "every shape", by_shape=rows)
    weight_only = dict(
        common, name="K8 quantized_matmul weight-only",
        max_abs_err=max(r["weight_only_max_abs_err"] for r in rows),
        ms=main["weight_only_ms"], plain_ms=main["weight_only_plain_ms"],
        bound_ms=main["weight_only_bound_ms"],
        bound_by=main["weight_only_bound_by"],
        library_ms=main["weight_only_library_ms"],
        shape="weight-only mode M=32 K=2048 N=1000 (times); max_abs_err "
              "over every shape")
    return int8_mode, weight_only


def resnet_images(rng, n, size=224):
    return rng.randn(n, 3, size, size).astype(np.float32)


def serve_requests(pred, requests):
    """Each request through the zero-copy handles: copy_from_cpu, run,
    copy_to_cpu. Returns (outputs, seconds per request)."""
    h_in = pred.get_input_handle(pred.get_input_names()[0])
    h_out = pred.get_output_handle(pred.get_output_names()[0])
    outs, secs = [], []
    for x in requests:
        t0 = time.perf_counter()
        h_in.copy_from_cpu(x)
        pred.run()
        outs.append(h_out.copy_to_cpu())
        secs.append(time.perf_counter() - t0)
    return outs, secs


def resnet_int8_serving(torch, k8, seed, tag, image_size=224):
    """Phase 12. ResNet-50 at its published width (He et al. 2015 Table
    1, 50 layers, 224 x 224, 1000 classes; depth not cut), built with the
    port's static API, initialized on the card from `seed`, saved with
    save_inference_model, then served by an f32 Predictor and an int8 one
    (PTQ at load, the default hist algorithm over 4 batches of 8 images):
    4 requests each at batch 1, 8 and 32 through the handles. Returns
    (summary, int8 predictor, a batch-32 input, launches)."""
    import shutil
    import tempfile
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models.resnet import build_static
    from paddle_tpu_torch.slim import quant_ops

    rng = np.random.RandomState(seed + 12)
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        img = static.data("img", [3, image_size, image_size], "float32")
        label = static.data("label", [1], "int64")
        logits, _, _ = build_static(img, label, depth=50)
    model_dir = tempfile.mkdtemp(prefix="resnet50_")
    try:
        t0 = time.perf_counter()
        exe = Executor()
        with scope_guard(Scope()):
            exe.run(startup)
            static.io.save_inference_model(model_dir, ["img"], [logits], exe,
                                           main_program=main)
        save_s = time.perf_counter() - t0
        f32 = inference.create_predictor(inference.Config(model_dir))
        loader = [{"img": resnet_images(rng, 8, image_size)}
                  for _ in range(4)]
        cfg = inference.Config(model_dir)
        cfg.enable_int8(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        int8 = inference.create_predictor(cfg)
        torch.cuda.synchronize()
        ptq_s = time.perf_counter() - t0
        ptq_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    ops = int8._program.global_block().ops
    types = [op.type for op in ops]
    n_conv, n_mul = types.count("quantized_conv2d"), types.count(
        "quantized_mul")
    assert n_conv == 53 and n_mul == 1, (n_conv, n_mul)
    assert not any(t.startswith("fake_") for t in types), types
    assert "conv2d" not in types and "fc" not in types, types

    def state_bytes(pred):
        prog = pred._program
        return sum(pred._scope.get(v.name).numel()
                   * pred._scope.get(v.name).element_size()
                   for v in prog.list_vars()
                   if v.persistable and pred._scope.has(v.name))

    requests = [resnet_images(rng, b, image_size) for b in RESNET_BATCHES
                for _ in range(RESNET_REQUESTS_PER_BATCH)]
    for pred in (f32, int8):          # warm-up: allocator, cuDNN plans
        serve_requests(pred, requests[::RESNET_REQUESTS_PER_BATCH])
    torch.cuda.synchronize()
    f32_bytes, int8_bytes = state_bytes(f32), state_bytes(int8)
    f32_out, f32_s = serve_requests(f32, requests)
    k8.reset_launch_counts()
    int8_out, int8_s = serve_requests(int8, requests)
    launches = dict(k8.launch_counts)
    assert launches["quantized_matmul"] >= len(requests), (
        f"K8 launched {launches} times over {len(requests)} int8 requests")
    num = sum(float(np.abs(a - b).sum()) for a, b in zip(int8_out, f32_out))
    den = sum(float(np.abs(b).sum()) for b in f32_out)
    fidelity = num / den
    top1 = float(np.mean(np.concatenate(
        [a.argmax(-1) == b.argmax(-1) for a, b in zip(int8_out, f32_out)])))
    for out in int8_out + f32_out:
        assert np.isfinite(out).all() and out.shape[1] == 1000
    print(f"resnet-50 int8 vs f32: mean |dlogits| / mean |logits_f32| = "
          f"{fidelity:.5f} (gate {INT8_FIDELITY_GATE}), top-1 agreement "
          f"{top1:.4f} (random weights: not gated) {tag}")
    assert fidelity < INT8_FIDELITY_GATE, fidelity

    # the main path's fc: K8's plain version on the served inputs + bias
    qmul = next(op for op in ops if op.type == "quantized_mul")
    add = next(op for op in ops if op.type == "elementwise_add"
               and op.inputs["X"] == qmul.outputs["Out"])
    x32 = requests[-1]
    served, fc_in = int8.run({"img": x32}, fetch_list=[qmul.inputs["X"][0]])
    sc = int8._scope
    fc_x = torch.from_numpy(fc_in).cuda()
    plain = k8.dequant_matmul_reference(
        fc_x.reshape(fc_x.shape[0], -1), sc.get(qmul.inputs["Y"][0]),
        sc.get(qmul.inputs["YScale"][0]).reshape(-1),
        x_scale=qmul.attrs["x_scale"]) + sc.get(add.inputs["Y"][0])
    fc_ulps = ulps(torch, torch.from_numpy(served).cuda(), plain)
    assert fc_ulps <= 1, f"served fc vs plain K8 + bias: {fc_ulps} ulps"

    # the stem's and a 3x3 conv's int32 accumulators against float64 on
    # the CPU, on the same codes (8 images of the batch-32 request)
    conv3 = next(op for op in ops if op.type == "quantized_conv2d"
                 and tuple(sc.get(op.inputs["Filter"][0]).shape[2:])
                 == (3, 3))
    checked = {}
    for label_, op in (("stem 7x7", ops[0]), ("first 3x3", conv3)):
        assert op.type == "quantized_conv2d"
        (_, xin) = int8.run({"img": x32[:8]},
                            fetch_list=[op.inputs["Input"][0]])
        args = (tuple(op.attrs["strides"]), tuple(op.attrs["paddings"]),
                tuple(op.attrs["dilations"]), op.attrs["groups"])
        xs = op.attrs["x_scale"]
        w = sc.get(op.inputs["Filter"][0])
        codes = k8.quantize_activation(torch.from_numpy(xin).cuda(), xs)
        codes_cpu = k8.quantize_activation(torch.from_numpy(xin), xs)
        acc = quant_ops.quantized_conv2d_acc(codes, w, *args).cpu()
        acc_cpu = quant_ops.quantized_conv2d_acc(codes_cpu, w.cpu(), *args)
        assert torch.equal(codes.cpu(), codes_cpu), f"{label_}: codes differ"
        assert torch.equal(acc, acc_cpu), f"{label_}: accumulators differ"
        checked[label_] = {"K": int(w[0].numel()),
                           "max_abs_acc": int(acc.abs().max())}
    print(f"resnet-50 int8: 53 quantized_conv2d + 1 quantized_mul; served "
          f"fc = plain K8 + bias within {fc_ulps} ulp; int32 accumulators "
          f"equal float64 on the CPU: {checked} {tag}")

    per_batch = {}
    for i, b in enumerate(RESNET_BATCHES):
        sl = slice(i * RESNET_REQUESTS_PER_BATCH,
                   (i + 1) * RESNET_REQUESTS_PER_BATCH)
        row = {}
        for name, secs in (("f32", f32_s[sl]), ("int8", int8_s[sl])):
            p50 = float(np.median(secs))
            row[name] = {"p50_ms": p50 * 1e3, "images_per_s": b / p50}
        per_batch[b] = row
        print(f"resnet-50 batch {b}: f32 p50 {row['f32']['p50_ms']:.2f} ms "
              f"({row['f32']['images_per_s']:.1f} images/s), int8 p50 "
              f"{row['int8']['p50_ms']:.2f} ms "
              f"({row['int8']['images_per_s']:.1f} images/s) {tag}")
    print(f"resnet-50: build + init + save {save_s:.1f} s; int8 load with "
          f"PTQ (4 x 8 images, hist) {ptq_s:.1f} s, peak {ptq_peak:.2f} GiB; "
          f"weights {int8_bytes} bytes int8 vs {f32_bytes} f32 "
          f"({f32_bytes / int8_bytes:.3f}x); K8 launches {launches} over "
          f"{len(requests)} int8 requests {tag}")
    summary = {"config": "ResNet-50 (He et al. 2015 Table 1), 224 x 224, "
                         "1000 classes, random weights from seed",
               "fidelity": fidelity, "top1_agreement": top1,
               "fc_ulps": fc_ulps, "acc_checked": checked,
               "per_batch": per_batch, "save_s": save_s, "ptq_s": ptq_s,
               "ptq_peak_gib": ptq_peak, "int8_weight_bytes": int8_bytes,
               "f32_weight_bytes": f32_bytes, "k8_launches": launches,
               "requests": len(requests)}
    del f32
    return summary, int8, requests[-1], launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    ap.add_argument("--latency", nargs="?", const=".", default=None,
                    metavar="ROOT",
                    help="only measure prefill latency and paged serving "
                         "(f32, int8, fp8) with the port under ROOT "
                         "(default: this checkout); print one LATENCY line")
    ap.add_argument("--decode-rows", nargs="?", const=".", default=None,
                    metavar="ROOT",
                    help="only profile the decode routes (K5, K6, K7) at "
                         "phase 2's cases "
                         "with the port under ROOT (default: this "
                         "checkout); print one DECODE_ROWS line")
    ap.add_argument("--flash-sweep", nargs="?", const=".", default=None,
                    metavar="ROOT",
                    help="only time the f32 flash backward beside SDPA's "
                         "at FLASH_SWEEP_T with the port under ROOT "
                         "(default: this checkout); print one FLASH_SWEEP "
                         "line")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to drive",
              file=sys.stderr)
        return 2
    for mode, fn, label in ((args.latency, latency, "LATENCY"),
                            (args.decode_rows, decode_rows, "DECODE_ROWS"),
                            (args.flash_sweep, flash_sweep_mode,
                             "FLASH_SWEEP")):
        if mode is None:
            continue
        root = os.path.abspath(mode)
        sys.path.insert(0, root)
        import paddle_tpu_torch
        assert os.path.dirname(os.path.dirname(
            os.path.abspath(paddle_tpu_torch.__file__))) == root, (
            paddle_tpu_torch.__file__, root)
        torch.backends.cuda.matmul.allow_tf32 = False
        out = fn(torch, args.seed)
        print(f"{label} " + json.dumps({"root": mode, **out}))
        return 0
    from paddle_tpu_torch.ops import generation as gen
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.serving.generation import GenerationServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device + build
    card = card_line()
    print(f"card: {card}")
    tag = f"[{card}]"
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['build_seconds']:.2f} s, "
          f"{'built' if info['built'] else 'already built'}) {tag}")
    # the tensor-core kernels' ptxas lines and SASS
    build = build_report(info, tag)

    # 2. kernels against their plain versions
    kernels = {"decode_attention": check_contiguous_kernel(
        torch, da, args.seed, tag)}
    (kernels["paged_decode_attention"],
     kernels["paged_prefill_attention"]) = check_paged_kernel(
        torch, da, args.seed, tag)
    (kernels["quantized_paged_decode_attention"],
     kernels["quantized_paged_prefill_attention"]) = check_quantized_kernel(
        torch, da, gen, args.seed, tag)
    for k in CHUNK_ROUTES.keys() | CHUNK_ROUTES.values():
        kernels[k]["launches"] = 0

    # 3. contiguous serving
    cfg = gen.LMConfig(**GPT2_SMALL)
    t0 = time.perf_counter()
    model = gen.TinyDecoderLM(cfg).init_params(args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg} params={n_params} init "
          f"{time.perf_counter() - t0:.1f} s {tag}")
    rng = np.random.RandomState(args.seed)
    prompts, budgets = make_prompts(rng, cfg.vocab_size, 16)
    refs, gaps = [], []
    t0 = time.perf_counter()
    for p, n in zip(prompts, budgets):
        g = []
        refs.append(gen.greedy_decode(
            model, p, n, on_logits=lambda r: g.append(top2_gap(r))
        ).tolist())
        gaps.append(g)
    print(f"single-request references: {len(refs)} requests, "
          f"{sum(map(len, refs))} tokens in "
          f"{time.perf_counter() - t0:.1f} s; smallest top-2 gap "
          f"{min(min(g) for g in gaps):.3g} {tag}")

    results = {"card": card, "seed": args.seed, "config": cfg._asdict(),
               "kernels": kernels, "phases": {}, "build_report": build}

    def run_phase(phase, engine, kname, want=None, absent=(), reqs=None,
                  **server_kw):
        """Warm the engine, serve every request with the launch counts
        reset just before, check tokens (against `want`, the (references,
        gaps) of the f32 single-request streams by default) and
        launches, record the row."""
        want_refs, want_gaps = want or (refs, gaps)
        reqs = reqs or (prompts, budgets)
        t0 = time.perf_counter()
        engine.warmup()
        warm_s = time.perf_counter() - t0
        da.reset_launch_counts()
        toks, ttft, wall, stats = serve(GenerationServer, engine, *reqs,
                                        **server_kw)
        launches = da.launch_counts[kname]
        steps = stats["counters"]["steps"]
        assert launches >= cfg.num_layers * steps > 0, (
            f"{phase}: {kname} launched {launches} times over {steps} "
            f"decode steps of {cfg.num_layers} layers")
        for other in absent:
            assert da.launch_counts[other] == 0, (
                f"{phase}: {other} launched {da.launch_counts[other]} times")
        excused = sum(compare(f"{phase} request {i}", t, r, g)
                      for i, (t, r, g) in enumerate(
                          zip(toks, want_refs, want_gaps)))
        n_tok = sum(map(len, toks))
        refills = stats["counters"]["refills"]
        row = {"tokens": n_tok, "wall_s": wall,
               "tokens_per_s": n_tok / wall,
               "p50_ttft_ms": float(np.median(ttft)) * 1e3,
               "decode_steps": steps, "admissions": refills,
               "launches": launches, "launches_per_step": launches / steps,
               "warmup_s": warm_s, "near_ties": excused,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if kname in CHUNK_ROUTES:
            # K6's and K7's two routes, in every layer: the chunk kernel
            # on every admission's prefill (every bucket is a chunk) and
            # on the verify ticks (chunk spec_k + 1), the decode kernel on
            # the plain ticks
            chunk = CHUNK_ROUTES[kname]
            min_c = (da.PAGED_TC_MIN_C if kname == "paged_decode_attention"
                     else 2)
            pre = da.launch_counts[chunk]
            verify = stats["speculative"]["verify_ticks"]
            assert min(engine.buckets) >= min_c, (engine.buckets, min_c)
            # verify chunks below the route's threshold take the decode
            # kernel
            want_pre = refills + (verify if engine.spec_k + 1 >= min_c
                                  else 0)
            assert pre == cfg.num_layers * want_pre, (
                f"{phase}: {chunk} launched {pre} times over "
                f"{refills} admissions and {verify} verify ticks (chunk "
                f"{engine.spec_k + 1}, route threshold {min_c}) of "
                f"{cfg.num_layers} layers")
            assert launches - pre == cfg.num_layers * (steps + refills
                                                       - want_pre), (
                f"{phase}: decode route launched {launches - pre} times "
                f"over {steps} ticks of {cfg.num_layers} layers")
            row.update(prefill_route_launches=pre,
                       decode_route_launches=launches - pre)
            kernels[chunk]["launches"] += pre
            kernels[kname]["launches"] += launches - pre
        else:
            kernels[kname]["launches"] = (kernels[kname].get("launches", 0)
                                          + launches)
        results["phases"][phase] = row
        routes = ("" if "prefill_route_launches" not in row else
                  f" (prefill route {row['prefill_route_launches']} over "
                  f"{refills} admissions, decode route "
                  f"{row['decode_route_launches']})")
        print(f"{phase}: {n_tok} tokens in {wall:.2f} s = "
              f"{row['tokens_per_s']:.1f} tokens/s, p50 TTFT "
              f"{row['p50_ttft_ms']:.1f} ms, {steps} decode steps, "
              f"{kname} launches {launches}{routes}, near-ties {excused} "
              f"{tag}")
        return toks, stats, row

    contiguous, _, _ = run_phase(
        "contiguous", gen.DecodeEngine(model, batch_size=8, max_len=1024),
        "decode_attention")
    torch.cuda.empty_cache()

    # 4. paged serving, the draft distilled from phase 3's outputs
    draft = gen.NgramDraft(cfg.vocab_size)
    for p, toks in zip(prompts, contiguous):
        draft.observe(list(p) + toks)
    paged, stats, row = run_phase(
        "paged", gen.PagedDecodeEngine(model, batch_size=8, max_len=1024,
                                       block_size=8, spec_k=4),
        "paged_decode_attention", draft=draft)
    row["near_ties"] += sum(
        compare(f"paged vs contiguous request {i}", t, r, g)
        for i, (t, r, g) in enumerate(zip(paged, contiguous, gaps)))
    spec = stats["speculative"]
    assert spec["prefix_hit_admissions"] > 0, "no prefix hit"
    assert spec["verify_ticks"] > 0, "speculative verify never ran"
    row.update(prefix_hit_admissions=spec["prefix_hit_admissions"],
               accepted=spec["accepted"], proposed=spec["proposed"],
               verify_ticks=spec["verify_ticks"],
               plain_ticks=spec["plain_ticks"])
    print(f"paged: prefix-hit admissions {spec['prefix_hit_admissions']}, "
          f"accepted proposals {spec['accepted']} of {spec['proposed']} "
          f"over {spec['verify_ticks']} verify ticks (draft distilled from "
          f"the contiguous phase's outputs) {tag}")
    torch.cuda.empty_cache()

    # 4'. paged serving without speculation: every tick on K6's decode
    # route, every admission on its chunk route
    plain, stats, row = run_phase(
        "paged spec_k=0", gen.PagedDecodeEngine(model, batch_size=8,
                                                max_len=1024, block_size=8,
                                                spec_k=0),
        "paged_decode_attention")
    row["near_ties"] += sum(
        compare(f"paged spec_k=0 vs contiguous request {i}", t, r, g)
        for i, (t, r, g) in enumerate(zip(plain, contiguous, gaps)))
    spec = stats["speculative"]
    assert spec["verify_ticks"] == 0 and spec["plain_ticks"] > 0, spec
    row.update(plain_ticks=spec["plain_ticks"],
               prefix_hit_admissions=spec["prefix_hit_admissions"])
    torch.cuda.empty_cache()

    # 4a. quantized serving, int8 then fp8, the draft of phase 4
    quant = {}
    f32_pool_bytes = None
    for dt in QUANT_DTYPES:
        t0 = time.perf_counter()
        qrefs, qgaps, _ = paged_greedy(gen, model, prompts, budgets, dt,
                                       num_blocks=8 * 128 + 1)
        quant[dt] = (qrefs, qgaps)
        print(f"{dt} single-request references (batch_size=1, spec_k=0): "
              f"{sum(map(len, qrefs))} tokens in "
              f"{time.perf_counter() - t0:.1f} s; smallest top-2 gap "
              f"{min(min(g) for g in qgaps):.3g} {tag}")
        eng = gen.PagedDecodeEngine(model, batch_size=8, max_len=1024,
                                    block_size=8, spec_k=4, kv_dtype=dt)
        assert eng.kv_dtype == dt, (eng.kv_dtype, dt)
        if f32_pool_bytes is None:
            f32_pool_bytes = (2 * cfg.num_layers * eng.num_blocks * 8
                              * cfg.d_model * 4)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        state = eng.init_state()
        allocated = torch.cuda.memory_allocated() - before
        del state
        toks, stats, row = run_phase(
            f"paged {dt}", eng, "quantized_paged_decode_attention",
            want=quant[dt], absent=("paged_decode_attention",), draft=draft)
        frac, full = agreement(toks, contiguous)
        row.update(kv_pool_bytes=eng.kv_pool_bytes(),
                   pool_bytes_allocated=allocated,
                   f32_pool_bytes=f32_pool_bytes,
                   f32_token_agreement=frac, f32_requests_equal=full,
                   verify_ticks=stats["speculative"]["verify_ticks"])
        # the caching allocator rounds each tensor up to 512 bytes
        assert 0 <= allocated - row["kv_pool_bytes"] <= 4 * 512, (
            f"{dt}: kv_pool_bytes {row['kv_pool_bytes']}, allocated "
            f"{allocated}")
        print(f"paged {dt}: pool {eng.kv_pool_bytes()} bytes "
              f"(torch.cuda allocated {allocated}) vs f32 "
              f"{f32_pool_bytes}: ratio {f32_pool_bytes / allocated:.3f}; "
              f"token agreement with phase 3 {frac:.4f} ({full} of "
              f"{len(toks)} requests equal in full) {tag}")
        del eng
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fid = fidelity(gen, model, prompts, contiguous)
    results["fidelity"] = fid
    for dt in QUANT_DTYPES:
        print(f"fidelity {dt}: mean |dlogits| / mean |logits_f32| = "
              f"{fid[dt]:.5f} (gate {FIDELITY_GATE[dt]}; phase 3's streams "
              f"of 8 requests teacher-forced, "
              f"{time.perf_counter() - t0:.1f} s) {tag}")
        assert fid[dt] < FIDELITY_GATE[dt], (dt, fid[dt])
    torch.cuda.empty_cache()

    # 4b. pool pressure, int8: the requests twice over in one queue
    eng = gen.PagedDecodeEngine(model, batch_size=8, max_len=1024,
                                block_size=8, num_blocks=PRESSURE_BLOCKS,
                                spec_k=4, spill_blocks=256, kv_dtype="int8")
    int8_twice = tuple(r + r for r in quant["int8"])
    _, stats, row = run_phase(
        "pressure int8", eng, "quantized_paged_decode_attention",
        want=int8_twice, absent=("paged_decode_attention",), draft=draft,
        reqs=(prompts + prompts, budgets + budgets))
    spec, lad = stats["speculative"], stats["ladder"]
    row.update(num_blocks=PRESSURE_BLOCKS, spill=stats["spill"], ladder=lad,
               parked=spec["parked"],
               spill_hit_admissions=spec["spill_hit_admissions"],
               prefix_hit_admissions=spec["prefix_hit_admissions"])
    print(f"pressure int8: {PRESSURE_BLOCKS} blocks, parked "
          f"{spec['parked']} times, ladder {lad}, spill {stats['spill']}, "
          f"spill-hit admissions {spec['spill_hit_admissions']}, "
          f"prefix-hit admissions {spec['prefix_hit_admissions']} {tag}")
    assert spec["parked"] >= 1, "no admission parked"
    assert lad["evict_spill"] >= 1, "the ladder never reached evict_spill"
    assert spec["spill_hit_admissions"] >= 1, "no spill-hit admission"
    del eng
    torch.cuda.empty_cache()

    # 4c. relocation, int8: export half-way, import, submit_resumed
    from paddle_tpu_torch.serving.generation import (
        GenerationRequest, PagedBatcher)
    i = 1
    p, n = prompts[i], budgets[i]
    cut = n // 2
    donor = gen.PagedDecodeEngine(model, batch_size=1, max_len=1024,
                                  block_size=8, spec_k=0, kv_dtype="int8")
    bat = PagedBatcher(donor)
    req = bat.submit(GenerationRequest(p, n, enqueued_at=0.0))
    while len(req.tokens) < cut:
        bat.step()
    committed = list(req.tokens)
    slot = bat.snapshot_requests()[req.request_id]["slot"]
    doc = donor.export_state(bat._state, slot, list(p) + committed)
    bat.close(drain=False)
    del bat, donor
    peer = gen.PagedDecodeEngine(model, batch_size=8, max_len=1024,
                                 block_size=8, spec_k=4, spill_blocks=256,
                                 kv_dtype="int8")
    bad = dict(doc, kv=[dict(e) for e in doc["kv"]])
    scale = bad["kv"][0]["k_scale"].copy()
    scale.view(np.uint8).flat[0] ^= 1
    bad["kv"][0]["k_scale"] = scale
    try:
        peer.import_state(bad)
    except gen.StateDocError as e:
        refused = str(e)
    else:
        raise AssertionError("a document with a flipped scale byte was "
                             "imported")
    imported = peer.import_state(doc)
    srv = GenerationServer(peer)
    try:
        resumed = srv.submit_resumed(p, committed, n)
        rest = resumed.result(timeout=600)["tokens"]
    finally:
        srv.shutdown(drain=False, timeout=60)
    got = committed + rest
    excused = compare("relocation", got, quant["int8"][0][i],
                      quant["int8"][1][i])
    assert resumed.spill_blocks > 0, "the resumed admission hit no spill"
    results["phases"]["relocation int8"] = {
        "request": i, "committed": cut, "remaining": len(rest),
        "doc_blocks": len(doc["kv"]),
        "spilled_blocks": imported["spilled_blocks"],
        "spill_blocks_at_admission": resumed.spill_blocks,
        "near_ties": excused, "tampered_refused": refused}
    print(f"relocation int8: request {i} exported after {cut} of {n} "
          f"tokens ({len(doc['kv'])} blocks, crc32 {doc['crc32']}), "
          f"resumed with {resumed.spill_blocks} spilled blocks promoted, "
          f"stream equal to the uninterrupted one (near-ties {excused}); "
          f"flipped scale byte refused: {refused} {tag}")
    del peer
    torch.cuda.empty_cache()

    # 5. where a decode step's time goes: contiguous f32, paged int8
    brk = step_breakdown(torch, gen, model, prompts)
    results["step_breakdown"] = brk
    print_profile("decode step, 8 live slots", brk, tag)
    brk = step_breakdown(torch, gen, model, prompts, kv_dtype="int8")
    results["step_breakdown_int8"] = brk
    print_profile("int8 paged decode step, 8 live slots", brk, tag)
    del model
    torch.cuda.empty_cache()

    # 6. flash kernels against their plain versions (their ptxas lines
    # and SASS are in phase 1's build report)
    kernels.update(check_flash(torch, tfa, args.seed, tag))

    # 7. the BERT-base pretraining step, the slice's main path
    trainer, data, bert = bert_train(torch, tfa, args.seed, tag)
    results["bert_train"] = bert
    for k in FLASH_KERNELS:
        kernels[k]["launches"] = bert["launches"][k]

    # 8. flash against the einsum path inside the model
    results["flash_vs_einsum"] = flash_vs_einsum(torch, tfa, trainer, tag)

    # 9. where a training step's time goes
    def train(n):
        for _ in range(n):
            trainer.step(data)
        torch.cuda.synchronize()

    brk = profile_device(torch, train, 3, top=10)
    results["bert_step_breakdown"] = brk
    print_profile("bert-base train step", brk, tag)

    # 11. K8 against its plain version (TF32 stays off: set above)
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    print(f"static phases: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} (f32 convs and GEMMs in "
          f"true f32) {tag}")
    (kernels["quantized_matmul"],
     kernels["quantized_matmul_weight_only"]) = check_quantized_matmul(
        torch, k8, args.seed, tag)
    del trainer, data
    torch.cuda.empty_cache()

    # 12. ResNet-50 int8 serving through the Predictor, the main path
    resnet, int8, x32, launches = resnet_int8_serving(torch, k8, args.seed,
                                                      tag)
    results["resnet50_int8"] = resnet
    # every call counts under "quantized_matmul", weight-only calls also
    # under their own key
    wo = launches["quantized_matmul_weight_only"]
    kernels["quantized_matmul"]["launches"] = launches["quantized_matmul"] - wo
    kernels["quantized_matmul_weight_only"]["launches"] = wo

    # 13. where an int8 batch-32 request's time goes
    def serve32(n):
        for _ in range(n):
            int8.run({"img": x32})
        torch.cuda.synchronize()

    serve32(1)
    brk = profile_device(torch, serve32, 3, top=10)
    results["resnet50_int8_breakdown"] = brk
    print_profile("resnet-50 int8 request, batch 32", brk, tag)
    del int8

    results["total_s"] = time.perf_counter() - t_start
    print(f"total: {results['total_s']:.1f} s {tag}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = {"kernels": [{k: kernels[name][k] for k in keys}
                        for name in ("decode_attention",
                                     "paged_decode_attention",
                                     "paged_prefill_attention",
                                     "quantized_paged_decode_attention",
                                     "quantized_paged_prefill_attention")
                        + FLASH_KERNELS + ("quantized_matmul",
                                           "quantized_matmul_weight_only")]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
