#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, each of which raises (exit code != 0) when its check fails:

1. Device: the card's name and power limit (nvidia-smi), then the build
   of the CUDA kernels from `paddle_tpu_torch/csrc/`.
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the serving path gives them, max |kernel - plain| <= 2e-5
   (float32, TF32 off; the tolerance covers summation order): K5 at
   B=8, S=1024, N=12, D=64 and K6 at block_size 8, M=128 over a
   shuffled pool with C in {1, 5, 512}. Each is timed beside its plain
   version, `F.scaled_dot_product_attention` on the same window (a
   yardstick the port never calls) and its bound (bytes or flops over
   the H100's peak rates).
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
   3's under the same near-tie rule; K6 must have launched.
5. Where a contiguous decode step's time goes with 8 live slots: host
   wall time per step, device time per step and the top kernels from
   torch.profiler, and the device's idle share.
6. The flash-attention kernels (K1-K4: forward, dK/dV(+dbias), dQ)
   against their plain PyTorch versions at BERT-base shapes (B=32,
   T=512, N=12, D=64, bf16; all-ones mask, padding mask, dropout 0.1)
   and in f32 on the general path (T=1024, causal, mask_grad): o, lse,
   dq/dk/dv(/dmask) within FLASH_TOL of max |plain|. The dropout case is
   timed beside its plain version, `F.scaled_dot_product_attention` on
   the same tensors (a yardstick the port never calls) and its bound.
7. The BERT-base pretraining step at full published width (12 layers,
   hidden 768, 12 heads, vocab 30522; bf16 params, f32 master + Adam,
   dropout on, flash attention), batch 32 x 512: 3 warm-up and 10 timed
   steps on one synthetic batch; every loss finite, the last below the
   first, each flash kernel launched >= 12 times per timed step; step
   ms, tokens/s, model-flops share of 989 TFLOP/s and peak memory.
8. The same weights in f32, eval(), batch 4 x 512: pretrain_loss and
   every gradient under attention_impl="flash" against "xla" within
   MODEL_LOSS_TOL / MODEL_GRAD_TOL.
9. Where a training step's time goes (torch.profiler, device rows).
10. Numbers, each beside the card's name and power limit, then a
    `{"kernels": [...]}` line and, last, the device line
    `{"ok": true, "device": {...}}`.

Launch counters are reset just before each main-path phase (serving,
training) and read just after it, so launches made to compare kernels
with their plain versions do not count.
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

GPT2_SMALL = dict(vocab_size=50257, d_model=768, num_heads=12,
                  num_layers=12, max_len=1024)
TOL = 2e-5
NEAR_TIE = 1e-4


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


def check_kernels(torch, da, seed, tag, copies=4):
    """Phase 2. Returns {kernel name: summary dict}; `tag` (the card
    line) is printed beside every number."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    # K5: decode step of the contiguous engine
    b, s, n, d = 8, 1024, 12, 64
    lens = np.concatenate([[0, 1, 511, 1024],
                           rng.randint(1, s + 1, size=b - 4)]).astype(
        np.int32)
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
          "shape": f"B={b} S={s} N={n} D={d} lengths={lens.tolist()}"}
    print(f"K5 B={b} S={s} N={n} D={d}: max_abs_err={err5:.3g} "
          f"kernel_ms={k5['ms']:.5f} plain_ms={k5['plain_ms']:.5f} "
          f"library_ms={k5['library_ms']:.5f} "
          f"bound_us={bnd * 1e3:.3f} ({by}) {tag}")

    # K6: paged chunk attention, block_size 8, M = 128 over a shuffled
    # pool (every slot's table a random slice of one permutation)
    bs, m = 8, 128
    nb = b * m + 1
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = torch.tensor(perm.reshape(b, m), device=dev)
    pools = [(randn(nb, bs, n, d), randn(nb, bs, n, d))
             for _ in range(copies)]
    k6_rows, err6 = [], 0.0
    for c in (1, 5, 512):
        top = m * bs - c
        lens = np.concatenate([[0, 1, min(511, top), top],
                               rng.randint(0, top + 1, size=b - 4)]
                              ).astype(np.int32)
        lengths = torch.tensor(lens, device=dev)
        sets = [(randn(b, c, n, d), kp, vp, tables, lengths)
                for kp, vp in pools]
        got = da.paged_decode_attention(*sets[0])
        want = da.paged_decode_attention_reference(*sets[0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert got.shape == (b, c, n, d) and bool(torch.isfinite(got).all())
        assert err <= TOL, f"K6 C={c} max |kernel - plain| {err} > {TOL}"
        err6 = max(err6, err)
        win = tables.long()

        def k6_library(q, kp, vp, tab, ln, wk, wv):
            lim = ln[:, None] + torch.arange(q.shape[1], device=dev)[None] + 1
            mask = torch.arange(m * bs, device=dev)[None, None] < lim[..., None]
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), wk, wv, attn_mask=mask[:, None])

        lib_sets = [a + (kp[win].reshape(b, m * bs, n, d).transpose(1, 2),
                         vp[win].reshape(b, m * bs, n, d).transpose(1, 2))
                    for a, (kp, vp) in zip(sets, pools)]
        cap = m * bs
        distinct = int(np.minimum(lens + c, cap).sum())
        pairs = int(sum(np.minimum(ln + np.arange(c) + 1, cap).sum()
                        for ln in lens))
        nbytes = (2 * b * c * n * d * 4 + b * m * 4 + b * 4
                  + 2 * distinct * n * d * 4)
        bnd, by = bound_ms(nbytes, 4.0 * pairs * n * d)
        row = {"C": c, "max_abs_err": err,
               "ms": timed_ms(torch, da.paged_decode_attention, sets),
               "plain_ms": timed_ms(
                   torch, da.paged_decode_attention_reference, sets),
               "library_ms": timed_ms(torch, k6_library, lib_sets),
               "bound_ms": bnd, "bound_by": by,
               "lengths": lens.tolist()}
        k6_rows.append(row)
        print(f"K6 B={b} C={c} N={n} D={d} bs={bs} M={m}: "
              f"max_abs_err={err:.3g} kernel_ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.5f} "
              f"library_ms={row['library_ms']:.5f} (window gathered "
              f"outside the call) bound_us={bnd * 1e3:.3f} ({by}) {tag}")
        del sets, lib_sets
    decode = k6_rows[0]
    k6 = {"name": "K6 paged_decode_attention", "route": "cuda",
          "source": "paddle_tpu_torch/csrc/decode_attention.cu",
          "replaces": "paddle_tpu/ops/pallas/flash_attention.py:1131",
          "max_abs_err": err6, "ms": decode["ms"],
          "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
          "bound_by": decode["bound_by"],
          "library_ms": decode["library_ms"],
          "shape": f"B={b} C=1 N={n} D={d} bs={bs} M={m} (times); "
                   f"max_abs_err over C in (1, 5, 512)",
          "by_chunk": k6_rows}
    return {"decode_attention": k5, "paged_decode_attention": k6}


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


def profile_device(torch, run, steps, top=8):
    """Host wall time per step of `run(steps)` (which ends in a
    synchronisation), then device time per step, the idle share and the
    top kernels from torch.profiler over a second `run(steps)`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run(steps)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's row also carries the device
    # time of the kernels it launched, which would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
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


def step_breakdown(torch, gen, model, prompts, steps=20):
    """Where one contiguous decode step's time goes with 8 live slots:
    host wall time per step (synchronised), device time per step and the
    top kernels from torch.profiler, and the device's idle share."""
    eng = gen.DecodeEngine(model, batch_size=8, max_len=1024)
    state = eng.init_state()
    tokens = np.zeros(8, np.int32)
    for i in range(8):
        state, row = eng.prefill(state, i, prompts[i])
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
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
#: which outputs each flash kernel writes
FLASH_OUTPUTS = {"flash_fwd": ("o", "lse"),
                 "flash_bwd_dkv": ("dk", "dv", "dmask"),
                 "flash_bwd_dq": ("dq",)}
FLASH_REPLACES = {
    "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:160 (_fwd_kernel, "
                 "K1), :280 (_fwd1_kernel, K4f)",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:468 "
                     "(_bwd_dkv_kernel, K2), :311 (_bwd1_kernel, K4b)",
    "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:543 "
                    "(_bwd_dq_kernel, K3), :311 (_bwd1_kernel, K4b)"}
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
               rate=0.0, mask_grad=False, seed=0):
    """Kernels and plain version on the same inputs: forward o and lse,
    and dq/dk/dv (+dmask) from one backward. Returns {output: (max abs
    err, relative err)}."""
    qkv, dout, mask = flash_inputs(torch, dev, dtype, b, t, n, d, pad,
                                   mask_grad, seed)
    seed_k = SEED_ATTN if rate else None
    res = {}
    for side in ("kernel", "plain"):
        x = qkv.detach().clone().requires_grad_()
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
        res[side] = {"o": o.detach(), "lse": lse.detach(),
                     "dq": x.grad[:, :, 0], "dk": x.grad[:, :, 1],
                     "dv": x.grad[:, :, 2]}
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


def check_flash(torch, tfa, seed, tag, copies=2):
    """Phase 6. The three flash kernels against their plain versions at
    BERT-base shapes (B=32, T=512, N=12, D=64, bf16: an all-ones mask, a
    padding mask, dropout 0.1) and in f32 on the general path (T=1024,
    causal, mask_grad); then the bf16 dropout case timed beside its plain
    version, SDPA and its bound. Returns {kernel: summary dict}."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    b, t, n, d = BERT_BATCH, BERT_SEQ, 12, 64
    cases = [
        ("bf16 all-ones mask", bf16, dict(b=b, t=t, n=n, d=d)),
        ("bf16 padding mask", bf16, dict(b=b, t=t, n=n, d=d, pad=True)),
        ("bf16 dropout 0.1", bf16, dict(b=b, t=t, n=n, d=d, rate=0.1)),
        ("f32 T=1024 causal mask_grad", f32,
         dict(b=4, t=1024, n=n, d=d, causal=True, mask_grad=True)),
    ]
    kernels = {k: {"max_abs_err": 0.0, "cases": {}} for k in FLASH_KERNELS}
    for label, dtype, kw in cases:
        errs = flash_case(torch, tfa, dev, dtype, seed=seed, **kw)
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        for kname, keys in FLASH_OUTPUTS.items():
            row = {k: errs[k] for k in keys if k in errs}
            kernels[kname]["cases"][label] = row
            kernels[kname]["max_abs_err"] = max(
                kernels[kname]["max_abs_err"], *(a for a, _ in row.values()))
        print(f"flash {label} {kw}: " + ", ".join(
            f"{k} abs {a:.3g} rel {r:.3g}" for k, (a, r) in errs.items())
            + f" (tolerance rel {tol}) {tag}")
        bad = {k: r for k, (_, r) in errs.items() if not r <= tol}
        assert not bad, f"flash {label}: relative errors {bad} > {tol}"
        torch.cuda.empty_cache()

    # timing: the main path's case (bf16, dropout 0.1, all-ones mask)
    rate, scale = 0.1, 1.0 / d ** 0.5
    cfg = (False, scale, rate, SEED_ATTN)
    sets = []
    for i in range(copies):
        qkv, dout, mask = flash_inputs(torch, dev, bf16, b, t, n, d, False,
                                       False, seed + 1 + i)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        bias = mask.reshape(b, t).contiguous()
        o, lse = tfa._launch_fwd(q, k, v, bias, cfg)
        delta = tfa.bwd_delta(o, dout)
        sets.append(dict(q=q, k=k, v=v, bias=bias, mask=mask, dout=dout,
                         lse=lse, delta=delta))

    def plain_graph(s, lib):
        """A forward graph kept for timing the backward alone."""
        x = [s[key].detach().clone().requires_grad_() for key in "qkv"]
        if lib:
            out = F.scaled_dot_product_attention(
                *(a.transpose(1, 2) for a in x),
                attn_mask=s["mask"].to(bf16), dropout_p=rate)
            dout = s["dout"].transpose(1, 2)
        else:
            keep = tfa.batch_keep_masks(SEED_ATTN, b, n, t, t, rate,
                                        device=dev)
            out = tfa.attention_reference(*x, s["mask"], keep_masks=keep)
            dout = s["dout"]
        return x, out, dout

    def fwd(s):
        return tfa._launch_fwd(s["q"], s["k"], s["v"], s["bias"], cfg)

    def dkv(s):
        return tfa._launch_dkv(s["q"], s["k"], s["v"], s["bias"], s["dout"],
                               s["lse"], s["delta"], cfg, False)

    def dq(s):
        return tfa._launch_dq(s["q"], s["k"], s["v"], s["bias"], s["dout"],
                              s["lse"], s["delta"], cfg)

    def plain_fwd(s):
        keep = tfa.batch_keep_masks(SEED_ATTN, b, n, t, t, rate, device=dev)
        return tfa.attention_reference(s["q"], s["k"], s["v"], s["mask"],
                                       keep_masks=keep)

    def lib_fwd(s):
        return F.scaled_dot_product_attention(
            s["q"].transpose(1, 2), s["k"].transpose(1, 2),
            s["v"].transpose(1, 2), attn_mask=s["mask"].to(bf16),
            dropout_p=rate)

    def grad_of(g, which):
        x, out, dout = g
        return torch.autograd.grad(out, [x[i] for i in which], dout,
                                   retain_graph=True)

    args = [(s,) for s in sets]
    plain_graphs = [(plain_graph(s, False),) for s in sets]
    lib_graphs = [(plain_graph(s, True),) for s in sets]
    lib_bwd_ms = timed_ms(torch, lambda g: grad_of(g, (0, 1, 2)), lib_graphs)
    bhttd = b * n * t * t * d
    nbytes_qkv = b * t * n * d * 2
    rows = b * n * t * 4
    timings = {
        "flash_fwd": (fwd, plain_fwd, timed_ms(torch, lib_fwd, args),
                      4 * nbytes_qkv + b * t * 4 + rows, 4 * bhttd),
        "flash_bwd_dkv": (dkv, None, lib_bwd_ms,
                          6 * nbytes_qkv + 2 * rows + b * t * 4, 8 * bhttd),
        "flash_bwd_dq": (dq, None, lib_bwd_ms,
                         5 * nbytes_qkv + 2 * rows + b * t * 4, 6 * bhttd),
    }
    plain_bwd = {"flash_bwd_dkv": lambda g: grad_of(g, (1, 2)),
                 "flash_bwd_dq": lambda g: grad_of(g, (0,))}
    for kname, (fn, plain, lib_ms, nbytes, flops) in timings.items():
        bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
        row = kernels[kname]
        row.update(
            name=kname, route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention.cu",
            replaces=FLASH_REPLACES[kname],
            ms=timed_ms(torch, fn, args),
            plain_ms=(timed_ms(torch, plain, args) if plain else
                      timed_ms(torch, plain_bwd[kname], plain_graphs)),
            bound_ms=bnd, bound_by=by, library_ms=lib_ms,
            shape=f"B={b} T={t} N={n} D={d} bf16 dropout {rate} "
                  f"(q, k, v views of [B, T, 3, N, D])")
        print(f"{kname} B={b} T={t} N={n} D={d} bf16 dropout {rate}: "
              f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={bnd:.4f} ({by}; "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s) {tag}")
    print(f"library: SDPA forward {timings['flash_fwd'][2]:.4f} ms, "
          f"SDPA backward (dq, dk, dv together) {lib_bwd_ms:.4f} ms on the "
          f"same bf16 tensors {tag}")
    del sets, plain_graphs, lib_graphs, args
    torch.cuda.empty_cache()
    return kernels


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
    for k in FLASH_KERNELS:
        assert launches[k] >= cfg.num_layers * steps, (
            f"{k} launched {launches[k]} times in {steps} steps of "
            f"{cfg.num_layers} layers")
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
        want = cfg.num_layers if impl == "flash" else 0
        assert all(tfa.launch_counts[k] == want for k in FLASH_KERNELS), (
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to drive",
              file=sys.stderr)
        return 2
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

    # 2. kernels against their plain versions
    kernels = check_kernels(torch, da, args.seed, tag)

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
               "kernels": kernels, "phases": {}}

    def run_phase(phase, engine, kname, **server_kw):
        """Warm the engine, serve every request with the launch counts
        reset just before, check tokens and launches, record the row."""
        t0 = time.perf_counter()
        engine.warmup()
        warm_s = time.perf_counter() - t0
        da.reset_launch_counts()
        toks, ttft, wall, stats = serve(GenerationServer, engine, prompts,
                                        budgets, **server_kw)
        launches = da.launch_counts[kname]
        steps = stats["counters"]["steps"]
        assert launches >= cfg.num_layers * steps > 0, (
            f"{phase}: {kname} launched {launches} times over {steps} "
            f"decode steps of {cfg.num_layers} layers")
        excused = sum(compare(f"{phase} request {i}", t, r, g)
                      for i, (t, r, g) in enumerate(zip(toks, refs, gaps)))
        n_tok = sum(map(len, toks))
        row = {"tokens": n_tok, "wall_s": wall,
               "tokens_per_s": n_tok / wall,
               "p50_ttft_ms": float(np.median(ttft)) * 1e3,
               "decode_steps": steps, "launches": launches,
               "launches_per_step": launches / steps,
               "warmup_s": warm_s, "near_ties": excused,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        results["phases"][phase] = row
        kernels[kname]["launches"] = launches
        print(f"{phase}: {n_tok} tokens in {wall:.2f} s = "
              f"{row['tokens_per_s']:.1f} tokens/s, p50 TTFT "
              f"{row['p50_ttft_ms']:.1f} ms, {steps} decode steps, "
              f"{kname} launches {launches}, near-ties {excused} {tag}")
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

    # 5. where a decode step's time goes
    brk = step_breakdown(torch, gen, model, prompts)
    results["step_breakdown"] = brk
    print_profile("decode step, 8 live slots", brk, tag)
    del model
    torch.cuda.empty_cache()

    # 6. flash kernels against their plain versions
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

    results["total_s"] = time.perf_counter() - t_start
    print(f"total: {results['total_s']:.1f} s {tag}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = {"kernels": [{k: kernels[name][k] for k in keys}
                        for name in ("decode_attention",
                                     "paged_decode_attention")
                        + FLASH_KERNELS]}
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
