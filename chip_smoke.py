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
14. ResNet-50 static training at the published width (depth 50, 224 x
    224, 1000 classes; random weights from --seed): build_static, the
    test clone, Momentum(0.0125, 0.9) + L2Decay(1e-4).minimize (Fluid's
    0.1 at batch 256 scaled to 32), startup on the card, one synthetic
    batch of 32 fed as numpy, f32 with TF32 off. (a) One step at batch
    4 from the startup weights on the card and on the host CPU: in
    float32 the loss within 1e-4 and the BN running statistics within
    1e-5 of their max, updates and velocities printed with the ReLU
    masks that differ between the two runs; with every float var made
    float64, the loss, every parameter's update (1e-3 of its max), the
    BN statistics and velocities (1e-5) (see `step_agreement`). (b) 3
    warm-up and 10 timed steps at batch 32: every loss finite, the last
    below the first; step ms (wall), images/s, peak memory, beside the
    step's f32 bound (3 x 32 x flops_per_image(50) at 67 TFLOP/s). (c)
    save_inference_model (feed img, target logits) into an f32
    Predictor: its logits at batch 4 equal the test clone's within 1e-5
    of max |logits|. No hand-written kernel is on this path.
15. Where a training step's time goes (torch.profiler): wall and device
    ms, the idle share, the top kernels, and the launches and device ms
    of the forward, the backward and the regularizer + update ops.
16. VGG-16-BN static training at the published width (the Fluid book's
    image_classification `vgg_bn_drop`, built here from
    static.nets.img_conv_group: 13 3x3 convs of 64..512 with batch norm
    + ReLU and their dropouts, 2x2 max pools, dropout 0.5, fc 512, BN,
    dropout 0.5, fc 512, fc 10 softmax; cross_entropy, accuracy; CIFAR-10
    3 x 32 x 32; random weights from --seed), Adam(0.001), the test
    clone, startup on the card, one synthetic batch of 128 from
    io.dataset.cifar fed as numpy, f32 with TF32 off. (a) One step at
    batch 4 with every drop rate 0, card against the host CPU: float32
    loss within 1e-4 and BN statistics within 1e-5 of their max; with
    every float var made float64, every parameter's change within 1e-3
    of lr, the Adam moments within 1e-5 of their max (the conv and fc
    biases in front of a batch norm, whose exact gradient is zero, left
    out of that gate), the ReLU masks that differ printed (see
    `vgg_step_agreement`). (b) 3 warm-up and 10 timed steps at batch 128
    with dropout on: every loss finite, the last below the first; one
    more step's masks: each dropout op's kept fraction within 5 sigma of
    1 - p; step ms (wall), images/s, peak memory, beside the step's f32
    bound (3 x 128 x the program's forward flops an image, computed from
    its conv and mul shapes, at 67 TFLOP/s). (c) save_inference_model of
    the class probabilities into an f32 Predictor: within 1e-5 of the
    test clone's max at batch 4 (dropout in test mode there).
17. Where a VGG step's time goes, as phase 15: wall and device ms, the
    idle share, the top kernels, the launches and device ms of the
    forward, the backward and the Adam update.
18. The Fluid book's word2vec at its width (chapter 04: N = 5, the
    synthetic imikolov vocabulary of 2048, embedding 32 shared by four
    lookups, hidden 256 sigmoid, softmax fc, cross_entropy, SGD 0.001,
    batch 100): one float64 step card against CPU, the shared table's
    update within 1e-9 of its max; then 20 steps on one batch under a
    piecewise_decay schedule from 0.001, on the card and on the CPU: the
    card's loss falls and its rate equals the CPU's at every step.
19. The Fluid book's label_semantic_roles at its width (chapter 07
    `db_lstm`: 8 embedded inputs, the word and its 5 context words
    through the shared frozen `emb` table (word_dim 32), the predicate
    (32), the mark (5); an fc 512 tanh each, summed; 8 dynamic_lstm(512)
    with relu candidate and sigmoid cell, the direction alternating, a
    sum of two tanh fcs between them; two tanh fcs to the 35 labels;
    linear_chain_crf with crfw at learning rate 1e-3, crf_decoding; SGD
    under exponential_decay(0.01, 1e5, 0.5, staircase)), on the JAX
    package's synthetic conll05 (dictionaries 801 / 60 / 35), batches
    padded to their longest sentence with the lengths fed to every LSTM
    and the CRF, f32 with TF32 off, random weights from --seed, startup
    on the card. (a) One step at batch 4, card against the host CPU:
    float32 loss within 1e-4; with every float var (and the programs'
    float32 dtype attrs) float64, the loss within 1e-9, each parameter's
    change within 1e-6 of its largest change, the Viterbi paths equal.
    (b) 3 warm-up and 20 timed steps on one batch of 10: every loss
    finite, the last below the first; step ms, words/s, peak memory.
    (c) save_inference_model of the Viterbi path, loaded and run with
    training=False: equal to the test clone's, two runs bit-equal.
20. machine_translation (tests/test_book_seq2seq.py's GRU seq2seq) at
    the book's chapter 08 widths: dictionaries 30000, word_dim 512,
    hidden 512, sequence_pool LAST into the decoder's h_0, the 30000-
    class fc, softmax_with_cross_entropy masked by sequence_mask over the
    target lengths, Adam 0.01; batch 64 from --seed with numpy (sources
    of 4-30 ids in [3, 30000), the target the reversed source with BOS 1
    and EOS 2), padded, lengths fed. (a) One step at batch 4, card
    against CPU: float32 loss within 1e-4; float64, every parameter's
    change within 1e-3 of lr and the Adam moments within 1e-5 of their
    max. (b) 3 warm-up and 10 timed steps at batch 64: losses finite and
    falling; step ms, target tokens/s, peak memory beside the step's f32
    bound (3 x the forward flops over the padded lengths at 67 TFLOP/s).
    (c) The decode program (While + gru_unit + beam_search + gather +
    array_write + beam_search_decode, parameters shared by name; batch
    16, beam 4, 32 steps) on the trained weights: float64 card against
    CPU ids equal and scores within 1e-9 of their max; in f32 on the
    card the best beam's score >= the last beam's, and
    save_inference_model -> load_inference_model gives the same ids.
21. Where the sequence models' time goes, as phases 15 and 17: wall and
    device ms of an SRL and an MT step, the idle share, the top kernels,
    the launches and device ms of the forward, the backward and the
    update; for the decode, launches a While iteration and the host's
    condition reads (count and the seconds the host waited in them).

22. The flash kernels at the Transformer-big attention shapes (N=16,
    D=64) against their plain version (`flash_case`), forward and
    backward, f32 (TF32 off) and bf16, within FLASH_TOL, q and k / v
    separate tensors (TRANSFORMER_FLASH_CASES): at B=32, self-attention
    at T=250 with a padding bias (lengths in [16, 250]), causal
    self-attention at T=231, cross-attention Tq=231 against Tk=250 with
    the bias and Tq=48 against Tk=64; then every shape the main path
    launches (self with the bias, causal, cross with the bias at 256 x
    256, B=32, and 128 x 128, B=64; the decodes' 64 x 64, 48 x 48 and 48
    x 64 at B=8); each case's forward and forward + backward timed
    beside SDPA's.
23. Transformer-big (d_model 1024, 16 heads, FFN 4096, 6 + 6 layers,
    30000-word vocabularies; Vaswani et al. 2017) trained eagerly through
    nn.TrainStep (momentum SGD) with attention_impl "flash", f32, TF32
    off, on seeded synthetic pairs (lengths in [16, 256]) bucketed by
    io.ragged.RaggedBatcher over bucket_boundaries(256): one warm-up and
    3 timed steps on one batch of the 256 bucket at B=32, then of the
    128 bucket at B=64; every step launches the f32 flash kernels 18
    times forward and 18 backward (6 encoder self-, 6 decoder self- and
    6 cross-attentions); per step wall ms, target tokens/s and peak
    memory, per bucket a profiled step (device ms, idle share,
    launches) beside the bound (6 x tokens x matmul parameters + the
    attentions, at 67 TFLOP/s); losses finite, falling. (c) One step at
    batch 4 from the same weights, card against the host CPU
    (MT_BIG_CHECK): f32 through the flash kernels, float64 through the
    plain attention, and as the gate's control the card's bf16 step
    against the CPU's f32 one, which must fail the f32 gate. (d) One
    bf16 step at B=32: finite loss, the bf16 flash kernels launched 18 +
    18 times.
24. The trained model's greedy decode (B=8, sources in the 64 bucket,
    max_len 48) and beam search (K=4, B=2) through the flash kernels:
    ids equal to the same decodes through the plain attention on the
    card; the loops' host reads and the host's wait in them.
25. The eager zoo at full width: resnet50() at batch 32, 224^2, NCHW and
    NHWC from the same weights (the logits and the step's loss agree,
    ZOO_LAYOUT_TOL; the loss after the step is printed); two steps
    each (the second timed) of vgg16, MobileNetV1 and SE-ResNeXt-50 at
    batch 16 and of DeepFM at its default config (26 slots x 10000 ids,
    embedding 16, MLP 400^3) at batch 4096; the ResNet through
    save_dygraph / load_dygraph bit-exact and through a TracedLayer
    (torch.export) within TRACED_TOL of the eager eval forward.

26. The detection ops at YOLOv3's full-width shapes (YoloConfig():
    DarkNet-53, 80 classes, the COCO anchors; batch 8 at 608^2) and at
    an FPN's (Mask R-CNN's P2, 200 x 272 x 256, 1024 rois): yolo_box on
    the 19^2, 38^2 and 76^2 heads (255 channels), yolov3_loss with 50
    ground-truth rows at each scale (1-50 real boxes an image),
    multiclass_nms over their 22743 boxes x 80 classes (YOLO_NMS),
    roi_align (7 x 7, sampling ratio 2, scale 1/4) and
    generate_proposals (2000 before NMS, 1000 after, IoU 0.7), card
    against the host CPU on seeded inputs: in float64 every continuous
    output and gradient within DET_F64_TOL of its max, the discrete
    ones equal; the f32 reading printed; each op timed in f32 (median
    of 30, L2-cold) with its launches a call.
27. YOLOv3 training at batch 8 x 608^2 (Fluid's Momentum 0.9, lr 1e-3,
    L2Decay 5e-4 on the conv filters, as PaddleCV yolov3): (c) one step
    at batch 2 x 320^2 card against CPU from the same seeded weights,
    float64 loss and gradients gated (YOLO_CHECK), f32 printed; then
    warm-up and timed steps on one seeded batch, losses finite and
    falling; step wall ms, images/s, peak memory and a profiled step
    (device ms, idle share, launches, top kernels).
28. YOLOv3 `predict` (yolo_box + multiclass_nms, NMS top-k 400, keep
    100, IoU 0.45, thresholds 0.005) at batch 8 x 608^2 in eval mode,
    the batch norms' statistics set from a calibration batch
    (`precise_bn`): p50 request ms over 10 requests, images/s, launches
    and host reads (synchronising calls); float64 card against CPU at
    batch 2, classes and rows equal, values within DET_F64_TOL. Phases
    26-28 launch none of the kernels of the kernels line (asserted).
29. CRNN-CTC (PaddleCV/ocr_recognition's crnn_ctc_model.py: 1 x 48 x
    512 grey images, conv groups of 16 / 32 / 64 / 128, im2sequence to
    64 steps of 768, two GRUs of 200, 95 + 1 classes, warpctc,
    ctc_greedy_decoder, edit_distance; Momentum 0.9, lr 1e-3,
    L2Decay(4e-4)) through the static Executor, f32, TF32 off: (c) one
    step at batch 2 in float64 card against CPU (CRNN_CHECK: loss,
    gradients; decoded ids, lengths and distances equal); 20 steps at
    batch 32 on one seeded batch, losses finite and falling; step wall
    ms, images/s, a profiled step; (b) the decode: the test program
    through Executor.run (forward, ctc_greedy_decoder, edit_distance),
    0 host reads (torch.cuda.set_sync_debug_mode), p50 ms.
30. Every op type of ops.{misc,text,ctr,fused} once (`misc_op_cases`),
    card against CPU in float64: continuous outputs and gradients within
    MISC_F64_TOL of their max, integer outputs equal, the random ops by
    their contract; the CTR ops and seqpool fusions at CTR-DNN's widths
    (26 slots, embedding 10, a 1,000,001-row table, batch 512), the
    recurrent fusions at db_lstm's (hidden 512), the rest at their
    reference cases at batch 64; each op's f32 ms and launches a call.
    Phases 29-30 launch none of the kernels of the kernels line
    (asserted).

Then a `{"kernels": [...]}` line and, last, the device line
`{"ok": true, "device": {...}}`. Every number is printed beside the
card's name and power limit.

Launch counters are reset just before each main-path phase (serving,
training, int8 ResNet serving, Transformer-big training and decoding;
phases 14, 16-21 and 25-30 launch none of the kernels)
and read just after it, so launches made
to compare kernels with their plain versions do not count; the flash
lines' `launches` add phases 23-24's (the Transformer's) to phase 7's
(BERT's), and their `launches_by_path` keeps the two apart; K6's two
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


#: phase 2's K5 case with a softmax scale that is not 1/sqrt(D)
K5_SM_SCALE = 0.3


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
    # an sm_scale that is not 1/sqrt(D), as flash_decode_attention takes
    got = da.decode_attention(*sets[1], sm_scale=K5_SM_SCALE)
    want = da.decode_attention_reference(*sets[1], sm_scale=K5_SM_SCALE)
    torch.cuda.synchronize()
    err_scaled = float((got - want).abs().max())
    assert err_scaled <= TOL, (
        f"K5 sm_scale={K5_SM_SCALE}: max |kernel - plain| {err_scaled} > "
        f"{TOL}")
    print(f"K5 B={b} S={s} N={n} D={d} sm_scale={K5_SM_SCALE}: "
          f"max_abs_err={err_scaled:.3g} (gate {TOL}) {tag}")

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
          "max_abs_err": err5, "max_abs_err_sm_scale": err_scaled,
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


#: the CUDA runtime / driver calls that launch a kernel, as the
#: profiler's host rows name them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def host_launches(torch, fn, argsets, calls=4):
    """Kernel launches a call of `fn`, counted on the host: the
    profiler's rows of the launch calls over `calls` calls (each argset
    warmed once). Unlike the device rows it does not depend on the
    activity records of short kernels reaching the profiler."""
    from torch.profiler import ProfilerActivity, profile
    for a in argsets:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in LAUNCH_CALLS) / calls


def profile_device(torch, run, steps, top=8):
    """Host wall time per step of `run(steps)` (which ends in a
    synchronisation), then device time and kernel launches per step, the
    idle share and the top kernels from torch.profiler over a second
    `run(steps)`."""
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    events = device_rows(torch, lambda: run(steps))
    device_ms = sum(dev_us(e) for e in events) / steps / 1e3
    ranked = sorted(events, key=dev_us, reverse=True)[:top]
    return {"step_wall_ms": wall_ms,
            "step_device_ms": device_ms if events else None,
            "launches_per_step": sum(e.count for e in events) / steps,
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


def attn_inputs(torch, dev, dtype, b, tq, tk, n, d, lengths, seed):
    """The Transformer's attention inputs: q [B, Tq, N, D] and k, v [B,
    Tk, N, D] as separate tensors (its separate projections), dO, and
    with `lengths` [B] its key bias [B, 1, 1, Tk] (-1e9 on the keys at
    and past each row's length), else None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, t, n, d), generator=g, device=dev).to(dtype)
               for t in (tq, tk, tk))
    dout = torch.randn((b, tq, n, d), generator=g, device=dev).to(dtype)
    mask = None
    if lengths is not None:
        keep = (torch.arange(tk, device=dev)[None, :]
                < torch.as_tensor(lengths, device=dev)[:, None])
        mask = ((1.0 - keep.float()) * -1e9).reshape(b, 1, 1, tk)
    return dict(q=q, k=k, v=v, dout=dout, mask=mask)


def flash_case(torch, tfa, dev, dtype, b, t, n, d, tk=None, lengths=None,
               causal=False, pad=False, rate=0.0, mask_grad=False, offset=0,
               seed=0):
    """Kernels and plain version on the same inputs: forward o and lse,
    and dq/dk/dv (+dmask) from one backward. Without `tk`, q, k, v are
    views of a fused [B, T, 3, N, D] tensor (BERT's) that starts `offset`
    elements into its buffer (rows not 16-byte aligned for an offset of
    one float); with `tk`, they are the Transformer's separate tensors,
    q of T rows against Tk keys, under the key bias of `lengths`
    (`attn_inputs`). Returns ({output: (max abs err, relative err)},
    {kernel: launches of the kernel side}): one forward for o, one for
    lse, one backward."""
    if tk is None:
        qkv, dout, mask = flash_inputs(torch, dev, dtype, b, t, n, d, pad,
                                       mask_grad, seed)
    else:
        ins = attn_inputs(torch, dev, dtype, b, t, tk, n, d, lengths, seed)
        dout, mask = ins["dout"], ins["mask"]
    seed_k = SEED_ATTN if rate else None
    res, launched = {}, {}
    for side in ("kernel", "plain"):
        if tk is None:
            buf = torch.empty(qkv.numel() + offset, dtype=dtype, device=dev)
            buf[offset:].copy_(qkv.reshape(-1))
            buf.requires_grad_()
            x = buf[offset:].view(qkv.shape)
            q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        else:
            q, k, v = (ins[key].detach().clone().requires_grad_()
                       for key in "qkv")
        m = (None if mask is None
             else mask.detach().clone().requires_grad_(mask_grad))
        if side == "kernel":
            before = dict(tfa.launch_counts)
            o = tfa.flash_attention(q, k, v, m, causal=causal,
                                    dropout_rate=rate, dropout_seed=seed_k,
                                    mask_grad=mask_grad)
            cfg = (causal, 1.0 / d ** 0.5, rate, seed_k)
            bias = None if mask is None else mask.reshape(b, -1).contiguous()
            _, lse = tfa._launch_fwd(q.detach(), k.detach(), v.detach(),
                                     bias, cfg)
            lse = lse.permute(0, 2, 1)[..., None]
        else:
            keep = (tfa.batch_keep_masks(SEED_ATTN, b, n, t, t, rate,
                                         device=dev) if rate else None)
            o, lse = tfa.attention_reference(q, k, v, m, causal,
                                             keep_masks=keep,
                                             return_lse=True)
        (o.float() * dout.float()).sum().backward()
        if side == "kernel":
            launched = {kn: tfa.launch_counts[kn] - before[kn]
                        for kn in tfa.launch_counts
                        if tfa.launch_counts[kn] != before[kn]}
        if tk is None:
            grad = buf.grad[offset:].view(qkv.shape)
            dq, dk, dv = grad[:, :, 0], grad[:, :, 1], grad[:, :, 2]
        else:
            dq, dk, dv = q.grad, k.grad, v.grad
        res[side] = {"o": o.detach(), "lse": lse.detach(),
                     "dq": dq, "dk": dk, "dv": dv}
        if mask_grad:
            res[side]["dmask"] = m.grad
    torch.cuda.synchronize()
    out = {}
    for key, want in res["plain"].items():
        got, want = res["kernel"][key].float(), want.float()
        diff = float((got - want).abs().max())
        assert bool(torch.isfinite(got).all()), f"{key}: non-finite values"
        out[key] = (diff, diff / max(float(want.abs().max()), 1e-30))
    return out, launched


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
        errs, launched = flash_case(torch, tfa, dev, dtype, seed=seed, **kw)
        names = FLASH_BF16 if dtype == bf16 else FLASH_F32
        assert set(launched) == set(names), (
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


# ---------------------------------------------------------------------------
# the Fluid static training slice: ResNet-50 through minimize and Executor
# ---------------------------------------------------------------------------

#: phase 14's optimizer: Fluid's ResNet-50 recipe (Momentum 0.9, L2Decay
#: 1e-4, learning rate 0.1 at batch 256) with the rate scaled to batch 32
TRAIN_LR, TRAIN_MOMENTUM, TRAIN_L2 = 0.0125, 0.9, 1e-4
TRAIN_BATCH, CHECK_BATCH = 32, 4
#: phase 14(a), the card against the CPU after one step at CHECK_BATCH:
#: the loss (relative), each parameter's update (after - before) against
#: its max |update|, BN running statistics and velocities against their
#: max |value| (see `step_agreement` for which hold in float32)
LOSS_RTOL, UPDATE_TOL, STATE_TOL = 1e-4, 1e-3, 1e-5
#: phase 14(c): the Predictor's logits against the test clone's, of max
#: |logits|
LOGITS_TOL = 1e-5


def resnet_train_programs(seed, image_size=224):
    """ResNet-50 (build_static(depth=50)), its test clone (made before
    minimize) and Momentum + L2Decay's minimize: (main, startup, test,
    logits name, loss name)."""
    from paddle_tpu_torch import optimizer, regularizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.models.resnet import build_static

    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        img = static.data("img", [3, image_size, image_size], "float32")
        label = static.data("label", [1], "int64")
        logits, loss, _ = build_static(img, label, depth=50)
        test = main.clone(for_test=True)
        optimizer.Momentum(
            learning_rate=TRAIN_LR, momentum=TRAIN_MOMENTUM,
            regularization=regularizer.L2Decay(TRAIN_L2)).minimize(loss)
    return main, startup, test, logits.name, loss.name


def widened(torch, program):
    """A copy of `program` whose float32 vars are float64 (batch norm and
    the updates then compute in float64 too: `dtypes.at_least_f32`)."""
    from paddle_tpu_torch.core import ir
    p = ir.Program.from_dict(program.to_dict())
    for b in p.blocks:
        for v in b.vars.values():
            if v.dtype == torch.float32:
                v.dtype = torch.float64
    return p


def widen_state(state):
    """A state (numpy) with its float32 arrays made float64."""
    return {n: a.astype(np.float64) if a.dtype == np.float32 else a
            for n, a in state.items()}


def one_step(torch, program, state, feed, fetch, device):
    """One run of `program` from `state` (numpy) on `device`: (the
    fetches, the state after), as numpy."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy
    scope = scope_from_jax(state, Scope(), device, program=program)
    outs = Executor(device).run(program, feed=feed, fetch_list=fetch,
                                scope=scope)
    return outs, scope_to_numpy(scope, sorted(state))


def step_agreement(torch, main, state, feed, loss, tag):
    """Phase 14(a): one step at CHECK_BATCH from the same weights on the
    card and on the host CPU, in float32 and with every float var made
    float64. float32 holds the loss (LOSS_RTOL) and the BN running
    statistics (STATE_TOL); its updates and velocities are printed with
    the ReLU masks that differ between the two runs: a pre-activation
    within float32's forward error of zero takes the other side of the
    kink, and the gradient behind it moves by that element's whole
    upstream value. float64 holds the loss, every update (UPDATE_TOL of
    its max), the BN statistics and the velocities (STATE_TOL)."""
    ops = main.global_block().ops
    params = next(op for op in ops if op.type == "autodiff").attrs["params"]
    relu_in = [op.inputs["X"][0] for op in ops if op.type == "relu"]
    classes = {
        "update": params,
        "bn statistics": [n for n in state if n.startswith("bn_")],
        "velocity": [n for n in state if n.endswith("_velocity_Momentum")]}
    gates = {"update": UPDATE_TOL, "bn statistics": STATE_TOL,
             "velocity": STATE_TOL}
    wide = widen_state(state)
    runs = {("float32", dev): one_step(torch, main, state, feed,
                                       [loss] + relu_in, dev)
            for dev in ("cuda", "cpu")}
    feed64 = dict(feed, img=feed["img"].astype(np.float64))
    runs.update({("float64", dev): one_step(
        torch, widened(torch, main), wide, feed64, [loss] + relu_in, dev)
        for dev in ("cuda", "cpu")})

    def err(got, want, name):
        if name in params:       # updates: after - before
            got, want = got - state[name], want - state[name]
        return float(np.abs(got - want).max() / np.abs(want).max())

    row, failed = {}, []
    for dt in ("float32", "float64"):
        (gf, gpu), (cf, cpu) = runs[(dt, "cuda")], runs[(dt, "cpu")]
        flips = sum(int(((a > 0) != (b > 0)).sum())
                    for a, b in zip(gf[1:], cf[1:]))
        r = {"loss": {"card": float(gf[0]), "cpu": float(cf[0]),
                      "rel_err": abs(float(gf[0]) - float(cf[0]))
                      / abs(float(cf[0])), "gate": LOSS_RTOL},
             "relu_mask_flips": flips,
             "relu_elements": sum(a.size for a in gf[1:])}
        if r["loss"]["rel_err"] > LOSS_RTOL:
            failed.append(f"{dt} loss")
        print(f"resnet-50 one step at batch {CHECK_BATCH}, {dt}, card vs "
              f"CPU: loss {gf[0]:.9g} vs {cf[0]:.9g}, rel "
              f"{r['loss']['rel_err']:.3g} (gate {LOSS_RTOL}); ReLU masks "
              f"that differ: {flips} of {r['relu_elements']} elements {tag}")
        for cls, names in classes.items():
            ranked = sorted(names, key=lambda n: -err(gpu[n], cpu[n], n))
            gated = dt == "float64" or cls == "bn statistics"
            r[cls] = {"vars": len(names), "gate": gates[cls] if gated
                      else None, "worst": {n: err(gpu[n], cpu[n], n)
                                           for n in ranked[:3]}}
            worst = r[cls]["worst"][ranked[0]]
            if gated and worst > gates[cls]:
                failed.append(f"{dt} {cls}")
            print(f"  {cls}: {len(names)} vars, worst "
                  f"{r[cls]['worst']} (gate "
                  f"{gates[cls] if gated else 'none: printed'}) {tag}")
        row[dt] = r
    assert not failed, f"phase 14(a): card vs CPU outside the gate: {failed}"
    return row


def resnet_static_training(torch, seed, tag, image_size=224, warmup=3,
                           steps=10):
    """Phase 14. ResNet-50 at its published width trained through the
    port's static path: build_static, Momentum + L2Decay minimize,
    startup on the card, one synthetic batch of TRAIN_BATCH from `seed`.
    (a) `step_agreement`; (b) `warmup` + `steps` steps at TRAIN_BATCH,
    every loss finite and the last below the first; (c)
    save_inference_model of the trained program, an f32 Predictor's
    logits against the test clone's. Returns (summary, main program,
    scope, batch, loss name)."""
    import shutil
    import tempfile
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models.resnet import flops_per_image
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

    main, startup, test, logits, loss = resnet_train_programs(seed,
                                                              image_size)
    exe = Executor()
    scope = Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    start = scope_to_numpy(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    rng = np.random.RandomState(seed + 14)
    batch = {"img": resnet_images(rng, TRAIN_BATCH, image_size),
             "label": rng.randint(0, 1000, (TRAIN_BATCH, 1)).astype(
                 np.int64)}

    # (a) card against the CPU, one step at CHECK_BATCH
    small = {k: v[:CHECK_BATCH] for k, v in batch.items()}
    agreement = step_agreement(torch, main, start, small, loss, tag)

    # (b) training at TRAIN_BATCH from the startup weights
    scope = scope_from_jax(start, Scope())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        outs += exe.run(main, feed=batch, fetch_list=[loss], scope=scope,
                        return_numpy=False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(o) for o in outs]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    flops = 3 * TRAIN_BATCH * flops_per_image(50, image_size)
    bound = flops / F32_FLOPS * 1e3
    print(f"resnet-50 static training, batch {TRAIN_BATCH}, f32 (TF32 off), "
          f"Momentum {TRAIN_MOMENTUM} + L2Decay {TRAIN_L2}, lr {TRAIN_LR}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{warmup + steps} steps; {step_ms:.2f} ms a step (wall, "
          f"{steps} steps after {warmup}), {TRAIN_BATCH / step_ms * 1e3:.1f} "
          f"images/s; f32 bound {bound:.2f} ms ({flops / 1e9:.1f} GFLOP at "
          f"{F32_FLOPS / 1e12:.0f} TFLOP/s); peak {peak_gib:.2f} GiB; "
          f"startup on the card {init_s:.2f} s {tag}")

    # (c) the book-test contract: save, load into a Predictor, compare
    x4 = batch["img"][:CHECK_BATCH]
    (want,) = exe.run(test, feed={k: v[:CHECK_BATCH] for k, v in
                                  batch.items()},
                      fetch_list=[logits], scope=scope)
    model_dir = tempfile.mkdtemp(prefix="resnet50_trained_")
    try:
        with scope_guard(scope):
            static.io.save_inference_model(model_dir, ["img"], [logits],
                                           exe, main_program=main)
        pred = inference.create_predictor(inference.Config(model_dir))
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    (got,) = pred.run({"img": x4})
    logits_err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"resnet-50 trained: Predictor logits vs the test clone's at "
          f"batch {CHECK_BATCH}: max |d| / max |logits| {logits_err:.3g} "
          f"(gate {LOGITS_TOL}) {tag}")
    assert got.shape == (CHECK_BATCH, 1000) and np.isfinite(got).all()
    assert logits_err <= LOGITS_TOL, logits_err
    summary = {"config": "ResNet-50 (He et al. 2015 Table 1), 224 x 224, "
                         "1000 classes, random weights from seed; "
                         f"Momentum {TRAIN_MOMENTUM}, L2Decay {TRAIN_L2}, "
                         f"lr {TRAIN_LR}, batch {TRAIN_BATCH}, f32",
               "agreement": agreement, "losses": losses,
               "step_ms": step_ms,
               "images_per_s": TRAIN_BATCH / step_ms * 1e3,
               "bound_ms": bound, "peak_gib": peak_gib, "init_s": init_s,
               "predictor_logits_err": logits_err}
    del pred
    return summary, main, scope, batch, loss


def training_step_profile(torch, main, scope, batch, loss, tag, steps=3,
                          label=f"resnet-50 train step, batch {TRAIN_BATCH}"):
    """Phases 15 and 17. Where a training step's time goes: wall and
    device ms a step, the idle share and the top kernels
    (torch.profiler), then the launches and device ms of the forward
    alone and of forward + backward (prefixes of the program's ops); the
    rest of the step is the regularizer's ops (none without one) and the
    update ops."""
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor

    exe = Executor()
    ops = main.global_block().ops
    ad = next(i for i, op in enumerate(ops) if op.type == "autodiff")
    counts = {"forward": ad,
              "regularizer": sum(op.role == ir.OpRole.BACKWARD
                                 for op in ops[ad + 1:]),
              "update": sum(op.role == ir.OpRole.OPTIMIZE for op in ops)}

    def runner(program):
        def run(n):
            for _ in range(n):
                exe.run(program, feed=batch, fetch_list=[loss], scope=scope,
                        return_numpy=False)
            torch.cuda.synchronize()
        run(1)
        return run

    run = runner(main)
    brk = profile_device(torch, run, steps, top=10)
    print_profile(label, brk, tag)
    seg = []
    for n_ops in (ad, ad + 1):      # forward; forward + backward
        prefix = ir.Program.from_dict(main.to_dict())
        prefix.global_block().ops = prefix.global_block().ops[:n_ops]
        p = profile_device(torch, runner(prefix), steps)
        seg.append((p["launches_per_step"], p["step_device_ms"] or 0.0))
    (fl, fm), (bl, bm) = seg
    sl, sm = brk["launches_per_step"], brk["step_device_ms"] or 0.0
    updates = sorted({op.type for op in ops
                      if op.role == ir.OpRole.OPTIMIZE})
    print(f"{label} ops: {counts['forward']} forward, 1 "
          f"autodiff, {counts['regularizer']} regularizer, "
          f"{counts['update']} update ({', '.join(updates)}); launches a "
          f"step: forward {fl:.0f}, "
          f"backward {bl - fl:.0f}, regularizer + update {sl - bl:.0f}, "
          f"total {sl:.0f}; device ms a step: forward {fm:.3f}, backward "
          f"{bm - fm:.3f}, regularizer + update {sm - bm:.3f} {tag}")
    brk.update(ops=counts, launches={"forward": fl, "backward": bl - fl,
                                     "update": sl - bl, "total": sl},
               device_ms={"forward": fm, "backward": bm - fm,
                          "update": sm - bm, "total": sm})
    return brk


# ---------------------------------------------------------------------------
# the Fluid book: VGG-16-BN (chapter 03) and word2vec (chapter 04)
# ---------------------------------------------------------------------------

#: phase 16: the book's image-classification recipe (Adam 0.001, batch
#: 128, CIFAR-10 3 x 32 x 32)
VGG_LR, VGG_BATCH, VGG_CHECK_BATCH = 1e-3, 128, 4
#: phase 16(a): float64 parameter changes card against CPU, of lr; Adam
#: moments, of their max
VGG_UPDATE_TOL, VGG_MOMENT_TOL = 1e-3, 1e-5
#: phase 18: the book's word2vec (N-gram of 5, embedding 32, hidden 256,
#: SGD 0.001, batch 100) over the synthetic imikolov vocabulary, and the
#: schedule that starts at the book's rate
W2V_EMBED, W2V_HIDDEN, W2V_BATCH, W2V_STEPS = 32, 256, 100, 20
W2V_BOUNDARIES, W2V_RATES = [5, 10, 15], [1e-3, 8e-4, 6e-4, 4e-4]
#: phase 18: the shared table's float64 update, card against CPU, of its
#: max
W2V_TABLE_TOL = 1e-9


def vgg_bn_drop(static, img, dropout=True):
    """The Fluid book's vgg_bn_drop (image_classification/train.py):
    five img_conv_group blocks of 3x3 convs, each with batch norm + ReLU
    and a dropout of its rate, 2x2 max pools; dropout 0.5, fc 512, BN
    ReLU, dropout 0.5, fc 512, fc 10 softmax. `dropout=False` sets every
    rate to 0 (phase 16(a))."""
    def rates(rs):
        return [r if dropout else 0.0 for r in rs]

    def block(x, nf, groups, rs):
        return static.nets.img_conv_group(
            x, [nf] * groups, 2, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True, conv_batchnorm_drop_rate=rates(rs),
            pool_stride=2, pool_type="max")

    t = block(img, 64, 2, [0.3, 0])
    t = block(t, 128, 2, [0.4, 0])
    for _ in range(3):
        t = block(t, 256 if _ == 0 else 512, 3, [0.4, 0.4, 0])
    t = static.dropout(t, 0.5 if dropout else 0.0)
    t = static.batch_norm(static.fc(t, 512), act="relu")
    t = static.dropout(t, 0.5 if dropout else 0.0)
    return static.fc(static.fc(t, 512), 10, act="softmax")


def program_flops(program, batch):
    """Forward flops of a program's convs and GEMMs at `batch` images: 2
    per multiply-add, from each conv2d's filter and output shapes and
    each mul's operands."""
    block = program.global_block()
    total = 0
    for op in block.ops:
        if op.type == "conv2d":
            w = block.var(op.inputs["Filter"][0]).shape
            out = block.var(op.outputs["Output"][0]).shape
            total += 2 * int(np.prod(w)) * out[2] * out[3] * batch
        elif op.type == "mul":
            y = block.var(op.inputs["Y"][0]).shape
            total += 2 * y[0] * y[1] * batch
    return total


def vgg_programs(seed, dropout):
    """VGG-16-BN, its test clone (before minimize) and Adam's minimize:
    (main, startup, test, predict name, loss name, acc name)."""
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir

    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        img = static.data("img", [3, 32, 32], "float32")
        label = static.data("label", [1], "int64")
        predict = vgg_bn_drop(static, img, dropout)
        loss = static.mean(static.cross_entropy(predict, label))
        acc = static.accuracy(predict, label)
        test = main.clone(for_test=True)
        optimizer.Adam(learning_rate=VGG_LR).minimize(loss)
    return main, startup, test, predict.name, loss.name, acc.name


def bn_cancelled_biases(program):
    """The biases added (a conv2d's Bias, an elementwise_add's Y) into a
    batch norm's input: their exact gradient is zero (the norm
    subtracts the batch mean), so what each device computes is rounding
    noise."""
    block = program.global_block()
    normed = {op.inputs["X"][0] for op in block.ops
              if op.type == "batch_norm"}
    out = set()
    for op in block.ops:
        if op.type == "conv2d" and op.inputs.get("Bias") \
                and op.outputs["Output"][0] in normed:
            out.add(op.inputs["Bias"][0])
        elif op.type == "elementwise_add" and op.outputs["Out"][0] in normed \
                and block.var(op.inputs["Y"][0]).desc.is_parameter:
            out.add(op.inputs["Y"][0])
    return out


def vgg_step_agreement(torch, main, state, feed, loss, tag):
    """Phase 16(a): one step at VGG_CHECK_BATCH from the same weights,
    every drop rate 0, on the card and on the host CPU. float32: the loss
    (LOSS_RTOL) and the BN running statistics (STATE_TOL of their max).
    float64 (every float var widened): the loss, every parameter's
    change within VGG_UPDATE_TOL x lr, the Adam moments within
    VGG_MOMENT_TOL of their max, and the ReLU masks that differ printed.
    The conv biases in front of a batch norm (`bn_cancelled_biases`)
    have a gradient of rounding noise on each device; their moments are
    left out of the moment gate (their changes stay in the update
    gate)."""
    ops = main.global_block().ops
    params = next(op for op in ops if op.type == "autodiff").attrs["params"]
    relu_in = [op.inputs["X"][0] for op in ops if op.type == "relu"]
    noise = bn_cancelled_biases(main)
    moments = [n for n in state if n.endswith(("_moment1_Adam",
                                               "_moment2_Adam"))
               and n.rsplit("_moment", 1)[0] not in noise]
    bn_stats = [n for n in state if n.startswith("bn_")]
    wide = widen_state(state)
    feed64 = dict(feed, img=feed["img"].astype(np.float64))
    runs = {}
    for dt, prog, st, fd in (("float32", main, state, feed),
                             ("float64", widened(torch, main), wide,
                              feed64)):
        for dev in ("cuda", "cpu"):
            runs[(dt, dev)] = one_step(torch, prog, st, fd,
                                       [loss] + relu_in, dev)

    def worst(names, got, want, scale):
        errs = {n: float(np.abs(got[n] - want[n]).max() / scale(n))
                for n in names}
        top = sorted(errs, key=errs.get, reverse=True)[:3]
        return {n: errs[n] for n in top}

    row, failed = {}, []
    for dt in ("float32", "float64"):
        (gf, gpu), (cf, cpu) = runs[(dt, "cuda")], runs[(dt, "cpu")]
        flips = sum(int(((a > 0) != (b > 0)).sum())
                    for a, b in zip(gf[1:], cf[1:]))
        rel = abs(float(gf[0]) - float(cf[0])) / abs(float(cf[0]))
        r = {"loss": {"card": float(gf[0]), "cpu": float(cf[0]),
                      "rel_err": rel, "gate": LOSS_RTOL},
             "relu_mask_flips": flips,
             "relu_elements": sum(a.size for a in gf[1:]),
             "bn statistics": worst(bn_stats, gpu, cpu,
                                    lambda n: np.abs(cpu[n]).max())}
        if rel > LOSS_RTOL:
            failed.append(f"{dt} loss")
        if max(r["bn statistics"].values()) > STATE_TOL:
            failed.append(f"{dt} bn statistics")
        if dt == "float64":
            r["update_of_lr"] = worst(
                params, {n: gpu[n] - state[n] for n in params},
                {n: cpu[n] - state[n] for n in params}, lambda n: VGG_LR)
            r["moments"] = worst(moments, gpu, cpu,
                                 lambda n: max(np.abs(cpu[n]).max(), 1e-300))
            if max(r["update_of_lr"].values()) > VGG_UPDATE_TOL:
                failed.append("float64 updates")
            if max(r["moments"].values()) > VGG_MOMENT_TOL:
                failed.append("float64 moments")
        print(f"vgg-16-bn one step at batch {len(feed['img'])}, {dt}, card "
              f"vs CPU, drop rates 0: loss {gf[0]:.9g} vs {cf[0]:.9g}, rel "
              f"{rel:.3g} (gate {LOSS_RTOL}); BN statistics worst "
              f"{r['bn statistics']} (gate {STATE_TOL}); ReLU masks that "
              f"differ: {flips} of {r['relu_elements']} {tag}")
        if dt == "float64":
            print(f"  float64 parameter changes, worst |d| / lr "
                  f"{r['update_of_lr']} (gate {VGG_UPDATE_TOL}); Adam "
                  f"moments worst {r['moments']} (gate {VGG_MOMENT_TOL}; "
                  f"the moments of {len(noise)} biases before a BN left out) {tag}")
        row[dt] = r
    assert not failed, f"phase 16(a): card vs CPU outside the gate: {failed}"
    return row


def vgg_static_training(torch, seed, tag, batch=VGG_BATCH,
                        check_batch=VGG_CHECK_BATCH, warmup=3, steps=10):
    """Phase 16. The Fluid book's VGG-16-BN on CIFAR-10 shapes trained
    through the port's static path: vgg_bn_drop from
    static.nets.img_conv_group, Adam(VGG_LR), startup on the card, one
    synthetic batch of `batch` from io.dataset.cifar fed as numpy. (a)
    `vgg_step_agreement` at `check_batch` with every drop rate 0; (b)
    `warmup` + `steps` steps with dropout on, every loss finite and the
    last below the first, each dropout op's kept fraction within 5 sigma
    of 1 - p; (c) save_inference_model of the class probabilities into
    an f32 Predictor against the test clone's. Returns (summary, main
    program, scope, batch, loss name)."""
    import shutil
    import tempfile
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.io import dataset, reader
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

    samples = next(reader.batch(dataset.cifar.train10(batch), batch)())
    feed = {"img": np.stack([s[0] for s in samples]),
            "label": np.stack([s[1] for s in samples]).reshape(-1, 1)}

    # (a) card against the CPU, one step, every drop rate 0
    main0, startup0, _, _, loss0, _ = vgg_programs(seed, dropout=False)
    scope = Scope()
    Executor().run(startup0, scope=scope)
    start = scope_to_numpy(scope, sorted(
        v.name for v in main0.list_vars() if v.persistable))
    agreement = vgg_step_agreement(
        torch, main0, start, {k: v[:check_batch] for k, v in feed.items()},
        loss0, tag)

    # (b) training with dropout on, from the same startup weights
    main, startup, test, predict, loss, acc = vgg_programs(seed, True)
    assert main.to_dict()["blocks"][0]["vars"].keys() >= {
        n for n in start}, "the two builds name their state alike"
    flops = program_flops(test, 1)
    exe = Executor()
    scope = scope_from_jax(start, Scope())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss, acc],
                            scope=scope, return_numpy=False))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(o[0]) for o in outs]
    accs = [float(o[1]) for o in outs]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    bound = 3 * flops * batch / F32_FLOPS * 1e3
    print(f"vgg-16-bn static training, batch {batch}, f32 (TF32 off), "
          f"Adam {VGG_LR}, dropout on: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, accuracy {accs[0]:.3f} -> {accs[-1]:.3f} "
          f"over {warmup + steps} steps; {step_ms:.2f} ms a step (wall, "
          f"{steps} steps after {warmup}), {batch / step_ms * 1e3:.1f} "
          f"images/s; f32 bound {bound:.3f} ms (3 x {flops / 1e9:.4f} "
          f"GFLOP an image x {batch} at {F32_FLOPS / 1e12:.0f} TFLOP/s); "
          f"peak {peak_gib:.2f} GiB {tag}")
    # each dropout op's kept fraction, from one more step's masks
    drops = [op for op in main.global_block().ops if op.type == "dropout"]
    masks = exe.run(main, feed=feed, fetch_list=[op.outputs["Mask"][0]
                                                 for op in drops],
                    scope=scope, return_numpy=False)
    kept = []
    for op, m in zip(drops, masks):
        p = op.attrs["dropout_prob"]
        frac = float(m.float().mean())
        sigma = (p * (1 - p) / m.numel()) ** 0.5
        kept.append({"p": p, "kept": frac, "sigmas": abs(frac - (1 - p))
                     / sigma})
        assert abs(frac - (1 - p)) < 5 * sigma, (op.outputs["Mask"], p, frac)
    print(f"vgg-16-bn dropout: {len(drops)} ops, kept fractions "
          f"{[round(k['kept'], 4) for k in kept]} against 1 - p "
          f"{[1 - k['p'] for k in kept]}, worst "
          f"{max(k['sigmas'] for k in kept):.2f} sigma (gate 5) {tag}")

    # (c) save, load into a Predictor, compare with the test clone
    small = {k: v[:check_batch] for k, v in feed.items()}
    (want,) = exe.run(test, feed=small, fetch_list=[predict], scope=scope)
    model_dir = tempfile.mkdtemp(prefix="vgg16_bn_trained_")
    try:
        with scope_guard(scope):
            static.io.save_inference_model(model_dir, ["img"], [predict],
                                           exe, main_program=main)
        pred = inference.create_predictor(inference.Config(model_dir))
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    (got,) = pred.run({"img": small["img"]})
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"vgg-16-bn trained: Predictor class probabilities vs the test "
          f"clone's at batch {check_batch}: max |d| / max |p| {err:.3g} "
          f"(gate {LOGITS_TOL}) {tag}")
    assert got.shape == (check_batch, 10) and np.isfinite(got).all()
    assert err <= LOGITS_TOL, err
    summary = {"config": "VGG-16-BN (Fluid book ch. 03 vgg_bn_drop), "
                         "CIFAR-10 3 x 32 x 32, 10 classes, random weights "
                         f"from seed; Adam {VGG_LR}, batch {batch}, f32",
               "agreement": agreement, "losses": losses,
               "accuracies": accs, "step_ms": step_ms,
               "images_per_s": batch / step_ms * 1e3,
               "flops_per_image": flops, "bound_ms": bound,
               "peak_gib": peak_gib, "dropout": kept,
               "predictor_err": err}
    del pred
    return summary, main, scope, feed, loss


def word2vec_programs(seed, scheduled):
    """The book's word2vec: four lookups of one shared table, concat,
    fc 256 sigmoid, fc softmax over the vocabulary, cross_entropy, SGD
    (0.001, or the piecewise schedule that starts there): (main,
    startup, loss name, the schedule's var name or None)."""
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.io import dataset
    from paddle_tpu_torch.utils.param_attr import ParamAttr

    vocab = dataset.imikolov.VOCAB
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        words = [static.data(f"w{i}", [1], "int64") for i in range(5)]
        embs = [static.embedding(w, size=[vocab, W2V_EMBED],
                                 param_attr=ParamAttr(name="shared_w"))
                for w in words[:-1]]
        hidden = static.fc(static.concat(embs, axis=1), W2V_HIDDEN,
                           act="sigmoid")
        predict = static.fc(hidden, vocab, act="softmax")
        loss = static.mean(static.cross_entropy(predict, words[-1]))
        lr = (static.piecewise_decay(W2V_BOUNDARIES, W2V_RATES)
              if scheduled else W2V_RATES[0])
        optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss.name, lr.name if scheduled else None


def word2vec_training(torch, seed, tag, steps=W2V_STEPS):
    """Phase 18. The book's word2vec at its width on the card: one
    float64 step card against CPU (the shared table's update within
    W2V_TABLE_TOL of its max), then `steps` steps of the scheduled
    program on one batch of W2V_BATCH windows on the card and on the
    CPU: the loss falls and the rate equals the CPU's at every step."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.io import dataset
    from paddle_tpu_torch.weights import scope_to_numpy

    cols = list(zip(*dataset.imikolov.train(W2V_BATCH)()))
    feed = {f"w{i}": np.asarray(c, np.int64).reshape(-1, 1)
            for i, c in enumerate(cols)}
    main, startup, loss, _ = word2vec_programs(seed, scheduled=False)
    scope = Scope()
    Executor().run(startup, scope=scope)
    start = scope_to_numpy(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    wide = widen_state(start)
    steps64 = {dev: one_step(torch, widened(torch, main), wide, feed,
                             [loss], dev) for dev in ("cuda", "cpu")}
    (gl,), g = steps64["cuda"]
    (cl,), c = steps64["cpu"]
    upd = c["shared_w"] - wide["shared_w"]
    table_err = float(np.abs(g["shared_w"] - c["shared_w"]).max()
                      / np.abs(upd).max())
    print(f"word2vec one step at batch {W2V_BATCH}, float64, card vs CPU: "
          f"loss {float(gl):.12g} vs {float(cl):.12g}; shared table update "
          f"max |d| / max |update| {table_err:.3g} (gate {W2V_TABLE_TOL}; "
          f"{int((np.abs(upd).sum(axis=1) > 0).sum())} rows updated) {tag}")
    assert table_err <= W2V_TABLE_TOL, table_err

    main, startup, loss, lr = word2vec_programs(seed, scheduled=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        scope = Scope()
        exe = Executor(dev)
        exe.run(startup, scope=scope)
        if dev == "cuda":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = [exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope,
                       return_numpy=False) for _ in range(steps)]
        if dev == "cuda":
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / steps * 1e3
        runs[dev] = (np.array([float(o[0]) for o in out]),
                     np.array([float(o[1]) for o in out]))
    losses, rates = runs["cuda"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert np.array_equal(rates, runs["cpu"][1]), (rates, runs["cpu"][1])
    print(f"word2vec {steps} steps on the card, piecewise_decay "
          f"{W2V_BOUNDARIES} {W2V_RATES}: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; rates {sorted(set(rates.tolist()))} equal "
          f"the CPU's at every step; {step_ms:.2f} ms a step (wall, first "
          f"step included) {tag}")
    return {"config": "word2vec (Fluid book ch. 04): N 5, vocab "
                      f"{dataset.imikolov.VOCAB} (synthetic imikolov), embedding "
                      f"{W2V_EMBED} shared by 4 lookups, hidden {W2V_HIDDEN} "
                      f"sigmoid, softmax, SGD, batch {W2V_BATCH}",
            "float64_table_err": table_err, "losses": losses.tolist(),
            "rates": rates.tolist(), "step_ms": step_ms}


# ---------------------------------------------------------------------------
# the Fluid book's sequence chapters: label_semantic_roles (chapter 07)
# and machine_translation (chapter 08)
# ---------------------------------------------------------------------------

#: phase 19: the book's db_lstm (word_dim 32, mark_dim 5, hidden 512,
#: depth 8, batch 10; SGD under exponential_decay(0.01, 1e5, 0.5,
#: staircase); the CRF's transition at learning rate 1e-3)
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HIDDEN, SRL_DEPTH = 32, 5, 512, 8
SRL_BATCH, SRL_CHECK_BATCH, SRL_CRF_LR = 10, 4, 1e-3
SRL_FEATURES = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
                "pred", "mark")
#: phase 19(a) in float64: the loss (relative) and each parameter's
#: change against its largest change
SRL_LOSS_TOL64, SRL_UPDATE_TOL64 = 1e-9, 1e-6
#: phase 20: the book's machine_translation widths (dictionaries 30000,
#: word_dim 512, hidden 512) with GRU encoder and decoder, Adam 0.01,
#: batch 64; sources of 4-30 ids, targets the reversed source + EOS,
#: padded to MT_SRC_LEN / MT_TRG_LEN
MT_VOCAB, MT_DIM, MT_HIDDEN, MT_LR = 30000, 512, 512, 0.01
MT_BATCH, MT_CHECK_BATCH, MT_BOS, MT_EOS = 64, 4, 1, 2
MT_SRC_LEN = 30
MT_TRG_LEN = MT_SRC_LEN + 1
#: phase 20(c): the decode program's batch, beam and steps; its float64
#: scores card against CPU, of their max
MT_DECODE_BATCH, MT_BEAM, MT_DECODE_STEPS, MT_SCORE_TOL64 = 16, 4, 32, 1e-9


def fully_widened(torch, program):
    """`widened`, and the ops' float32 dtype attrs (fill_constant, cast,
    assign_value, sequence_mask, ...) made float64 too, so constants made
    inside the program (a loop's scores, a mask) are float64 as well."""
    p = widened(torch, program)
    for b in p.blocks:
        for op in b.ops:
            for k in ("dtype", "out_dtype"):
                if op.attrs.get(k) == "float32":
                    op.attrs[k] = "float64"
    return p


def change_err(params, before, got, want):
    """{param: max |d_got - d_want| / max |d_want|} of the changes from
    `before` (a parameter the step leaves unchanged must stay so)."""
    out = {}
    for n in params:
        dg, dw = got[n] - before[n], want[n] - before[n]
        top = float(np.abs(dw).max())
        diff = float(np.abs(dg - dw).max())
        out[n] = diff / top if top > 0 else (0.0 if diff == 0 else np.inf)
    return out


def worst3(errs):
    return {n: errs[n] for n in sorted(errs, key=errs.get,
                                       reverse=True)[:3]}


def srl_programs(seed):
    """The book's db_lstm on conll05: 8 embedded inputs (the word and
    its 5 context words through the shared, frozen `emb` table, the
    predicate through `vemb`, the mark), an fc 512 tanh each, summed;
    8 dynamic_lstm(512) with relu candidate and sigmoid cell, the
    direction alternating, a sum of two tanh fcs between them; the sum
    of two tanh fcs to the labels; linear_chain_crf (crfw at learning
    rate 1e-3), mean, crf_decoding; SGD under exponential_decay. Every
    sequence is padded, its lengths fed to each LSTM and to the CRF.
    Returns (main, startup, test clone, loss name, decode name)."""
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.io import dataset_ext
    from paddle_tpu_torch.utils.param_attr import ParamAttr

    word_dict, verb_dict, label_dict = dataset_ext.conll05.get_dict()
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        feats = [static.data(n, [-1, -1], "int64", append_batch_size=False)
                 for n in SRL_FEATURES]
        target = static.data("target", [-1, -1], "int64",
                             append_batch_size=False)
        lens = static.data("lens", [-1], "int64", append_batch_size=False)
        embs = [static.embedding(x, [len(word_dict), SRL_WORD_DIM],
                                 param_attr=ParamAttr(name="emb",
                                                      trainable=False))
                for x in feats[:6]]
        embs.append(static.embedding(feats[6], [len(verb_dict),
                                                SRL_WORD_DIM],
                                     param_attr=ParamAttr(name="vemb")))
        embs.append(static.embedding(feats[7], [2, SRL_MARK_DIM]))

        def fc(x, size):
            return static.fc(x, size, num_flatten_dims=2, act="tanh")

        hidden = static.sums([fc(e, SRL_HIDDEN) for e in embs])
        lstm_kw = dict(lengths=lens, candidate_activation="relu",
                       gate_activation="sigmoid", cell_activation="sigmoid")
        lstm, _ = static.dynamic_lstm(hidden, SRL_HIDDEN, **lstm_kw)
        for i in range(1, SRL_DEPTH):
            hidden = static.sums([fc(hidden, SRL_HIDDEN),
                                  fc(lstm, SRL_HIDDEN)])
            lstm, _ = static.dynamic_lstm(hidden, SRL_HIDDEN,
                                          is_reverse=i % 2 == 1, **lstm_kw)
        feature = static.sums([fc(hidden, len(label_dict)),
                               fc(lstm, len(label_dict))])
        crf_cost = static.linear_chain_crf(
            feature, target, ParamAttr(name="crfw",
                                       learning_rate=SRL_CRF_LR),
            length=lens)
        loss = static.mean(crf_cost)
        decode = static.crf_decoding(feature, ParamAttr(name="crfw"),
                                     length=lens)
        test = main.clone(for_test=True)
        optimizer.SGD(learning_rate=static.exponential_decay(
            0.01, 100000, 0.5, staircase=True)).minimize(loss)
    return main, startup, test, loss.name, decode.name


def srl_batch(samples):
    """conll05 samples padded to the longest, with their lengths."""
    lens = np.array([len(s[0]) for s in samples], np.int64)
    t = int(lens.max())

    def col(i):
        return np.stack([np.pad(np.asarray(s[i], np.int64),
                                (0, t - len(s[i]))) for s in samples])
    feed = {n: col(i) for i, n in enumerate(SRL_FEATURES)}
    feed.update(target=col(8), lens=lens)
    return feed


def srl_training(torch, seed, tag, batch=SRL_BATCH,
                 check_batch=SRL_CHECK_BATCH, warmup=3, steps=20):
    """Phase 19. The book's label_semantic_roles at its width on the
    card. (a) One step at `check_batch` from the startup weights, card
    against the host CPU: float32 loss within LOSS_RTOL; every float var
    float64, the loss within SRL_LOSS_TOL64, each parameter's change
    within SRL_UPDATE_TOL64 of its largest change, the Viterbi paths
    equal. (b) `warmup` + `steps` steps on one batch of `batch`: every
    loss finite, the last below the first; step ms, words/s, peak
    memory. (c) save_inference_model of the Viterbi path, loaded and run
    with training=False: equal to the test clone's, two runs bit-equal.
    Returns (summary, main, scope, batch feed, loss name)."""
    import shutil
    import tempfile
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.io import dataset_ext
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

    samples = list(dataset_ext.conll05.test(64)())
    feed = srl_batch(samples[:batch])
    small = srl_batch(samples[:check_batch])
    main, startup, test, loss, decode = srl_programs(seed)
    scope = Scope()
    Executor().run(startup, scope=scope)
    start = scope_to_numpy(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    params = next(op for op in main.global_block().ops
                  if op.type == "autodiff").attrs["params"]

    # (a) card against the CPU, one step
    runs = {("float32", d): one_step(torch, main, start, small,
                                     [loss, decode], d)
            for d in ("cuda", "cpu")}
    wide, main64 = widen_state(start), fully_widened(torch, main)
    runs.update({("float64", d): one_step(torch, main64, wide, small,
                                          [loss, decode], d)
                 for d in ("cuda", "cpu")})
    agreement = {}
    for dt, tol in (("float32", LOSS_RTOL), ("float64", SRL_LOSS_TOL64)):
        (gl, gp), g = runs[(dt, "cuda")]
        (cl, cp), c = runs[(dt, "cpu")]
        rel = abs(float(gl) - float(cl)) / abs(float(cl))
        flips = int((np.asarray(gp) != np.asarray(cp)).sum())
        row = {"loss_card": float(gl), "loss_cpu": float(cl),
               "loss_rel_err": rel, "loss_gate": tol,
               "viterbi_positions_differing": flips}
        if dt == "float64":
            errs = change_err(params, wide, g, c)
            row.update(update_err=worst3(errs),
                       update_gate=SRL_UPDATE_TOL64)
            assert max(errs.values()) <= SRL_UPDATE_TOL64, worst3(errs)
            assert flips == 0, f"float64 Viterbi paths differ at {flips}"
        print(f"srl db_lstm one step at batch {check_batch}, {dt}, card vs "
              f"CPU: loss {float(gl):.12g} vs {float(cl):.12g}, rel "
              f"{rel:.3g} (gate {tol}); Viterbi positions that differ "
              f"{flips}" + (f"; parameter changes worst "
                            f"{row['update_err']} (gate {SRL_UPDATE_TOL64})"
                            if dt == "float64" else "") + f" {tag}")
        assert rel <= tol, (dt, rel)
        agreement[dt] = row

    # (b) training on one batch
    exe = Executor()
    scope = scope_from_jax(start, Scope())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            return_numpy=False)[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(o) for o in outs]
    words = int(feed["lens"].sum())
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    print(f"srl db_lstm training, batch {batch} ({words} words, padded to "
          f"{feed['word'].shape[1]}), f32 (TF32 off), SGD under "
          f"exponential_decay: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{warmup + steps} steps; {step_ms:.2f} ms a step (wall, {steps} "
          f"steps after {warmup}), {words / step_ms * 1e3:.1f} words/s; peak "
          f"{peak_gib:.2f} GiB {tag}")

    # (c) the Viterbi path through save / load, in test mode
    infeed = {k: v for k, v in feed.items() if k != "target"}
    (want,) = exe.run(test, feed=feed, fetch_list=[decode], scope=scope)
    model_dir = tempfile.mkdtemp(prefix="srl_db_lstm_")
    try:
        with scope_guard(scope):
            static.io.save_inference_model(
                model_dir, list(SRL_FEATURES) + ["lens"], [decode], exe,
                main_program=main)
        with scope_guard(Scope()):
            prog, feeds, fetches = static.io.load_inference_model(
                model_dir, exe)
            got = [exe.run(prog, feed={k: infeed[k] for k in feeds},
                           fetch_list=fetches, training=False)[0]
                   for _ in range(2)]
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    assert np.array_equal(got[0], got[1]), "two loaded runs differ"
    assert np.array_equal(got[0], want), "loaded paths differ from the test " \
        "clone's"
    acc = float(((got[0] == feed["target"]) & (np.arange(
        got[0].shape[1])[None, :] < feed["lens"][:, None])).sum() / words)
    print(f"srl db_lstm saved and loaded: Viterbi paths equal the test "
          f"clone's and each other's over two runs; {acc:.3f} of the words "
          f"tagged as labelled after {warmup + steps} steps {tag}")
    summary = {"config": "label_semantic_roles db_lstm (Fluid book ch. 07): "
                         "word_dim 32, mark_dim 5, hidden 512, depth 8, "
                         "synthetic conll05 dictionaries 801 / 60 / 35, "
                         f"batch {batch}, SGD + exponential_decay, f32",
               "agreement": agreement, "losses": losses, "step_ms": step_ms,
               "words": words, "words_per_s": words / step_ms * 1e3,
               "peak_gib": peak_gib, "tag_accuracy": acc}
    return summary, main, scope, feed, loss


def mt_encoder(static, param_attr, src, src_len):
    """The GRU encoder's last state [B, 512] (test_book_seq2seq's)."""
    semb = static.embedding(src, [MT_VOCAB, MT_DIM],
                            param_attr=param_attr(name="src_emb_w"))
    enc_in = static.fc(semb, 3 * MT_HIDDEN, num_flatten_dims=2,
                       param_attr=param_attr(name="enc_fc_w"),
                       bias_attr=param_attr(name="enc_fc_b"))
    enc = static.dynamic_gru(enc_in, MT_HIDDEN, lengths=src_len,
                             param_attr=param_attr(name="enc_gru_w"),
                             bias_attr=param_attr(name="enc_gru_b"))
    return static.sequence_pool(enc, "LAST", lengths=src_len)


def mt_programs(seed):
    """The training program of tests/test_book_seq2seq.py's
    machine_translation at the book's widths: embeddings of 30000 x 512,
    GRU encoder (its last state through sequence_pool LAST) and decoder
    of 512, the 30000-class fc, softmax_with_cross_entropy masked by
    sequence_mask over the target lengths, Adam 0.01. (main, startup,
    loss name)."""
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.utils.param_attr import ParamAttr

    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        src = static.data("src", [MT_SRC_LEN], "int64")
        src_len = static.data("src_len", [-1], "int64",
                              append_batch_size=False)
        trg_in = static.data("trg_in", [MT_TRG_LEN], "int64")
        trg_out = static.data("trg_out", [MT_TRG_LEN, 1], "int64")
        trg_len = static.data("trg_len", [-1], "int64",
                              append_batch_size=False)
        enc_last = mt_encoder(static, ParamAttr, src, src_len)
        temb = static.embedding(trg_in, [MT_VOCAB, MT_DIM],
                                param_attr=ParamAttr(name="trg_emb_w"))
        dec_in = static.fc(temb, 3 * MT_HIDDEN, num_flatten_dims=2,
                           param_attr=ParamAttr(name="dec_fc_w"),
                           bias_attr=ParamAttr(name="dec_fc_b"))
        dec = static.dynamic_gru(dec_in, MT_HIDDEN, h_0=enc_last,
                                 lengths=trg_len,
                                 param_attr=ParamAttr(name="dec_gru_w"),
                                 bias_attr=ParamAttr(name="dec_gru_b"))
        logits = static.fc(dec, MT_VOCAB, num_flatten_dims=2,
                           param_attr=ParamAttr(name="out_fc_w"),
                           bias_attr=ParamAttr(name="out_fc_b"))
        ce = static.reshape(static.softmax_with_cross_entropy(
            logits, trg_out), [-1, MT_TRG_LEN])
        mask = static.sequence_mask(trg_len, maxlen=MT_TRG_LEN,
                                    dtype="float32")
        loss = static.elementwise_div(
            static.reduce_sum(static.elementwise_mul(ce, mask)),
            static.reduce_sum(mask))
        optimizer.Adam(learning_rate=MT_LR).minimize(loss)
    return main, startup, loss.name


def mt_decode_program():
    """The decode program: the encoder, then While over MT_DECODE_STEPS
    steps of embedding, fc, gru_unit, the output fc, beam_search
    (MT_BEAM beams) and the state gathered by parent beam, ids and
    parents into tensor arrays, beam_search_decode; parameters shared
    with the training program by name. (program, [ids, scores] names)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.utils.param_attr import ParamAttr as PA

    B, K, V, H = MT_DECODE_BATCH, MT_BEAM, MT_VOCAB, MT_HIDDEN
    ir.reset_unique_names()
    prog = ir.Program()
    with ir.program_guard(prog, ir.Program()):
        src = static.data("src", [B, MT_SRC_LEN], "int64",
                          append_batch_size=False)
        src_len = static.data("src_len", [B], "int64",
                              append_batch_size=False)
        enc_last = mt_encoder(static, PA, src, src_len)
        h = static.fill_constant([B * K, H], "float32", 0.0)
        static.assign(static.reshape(static.expand(
            static.unsqueeze(enc_last, axes=[1]), expand_times=[1, K, 1]),
            [B * K, H]), h)
        pre_ids = static.fill_constant([B, K], "int32", MT_BOS)
        pre_scores = static.fill_constant([B, K], "float32", 0.0)
        static.assign(static.elementwise_add(pre_scores, static.assign(
            np.array([[0.0] + [-1e9] * (K - 1)], np.float32))), pre_scores)
        ids_arr = static.create_array(MT_DECODE_STEPS, [B, K], "int32")
        parents_arr = static.create_array(MT_DECODE_STEPS, [B, K], "int32")
        base = static.reshape(static.range(0, B * K, K, "int32"), [B, 1])
        i = static.fill_constant([1], "int64", 0)
        n = static.fill_constant([1], "int64", MT_DECODE_STEPS)
        cond = static.less_than(i, n)
        loop = static.While(cond)
        with loop.block():
            tok = static.reshape(static.assign(pre_ids), [B * K, 1])
            temb = static.embedding(tok, [V, MT_DIM],
                                    param_attr=PA(name="trg_emb_w"))
            dec_in = static.fc(temb, 3 * H, param_attr=PA(name="dec_fc_w"),
                               bias_attr=PA(name="dec_fc_b"))
            h_new, _, _ = static.gru_unit(dec_in, static.assign(h), 3 * H,
                                          param_attr=PA(name="dec_gru_w"),
                                          bias_attr=PA(name="dec_gru_b"))
            logits = static.fc(h_new, V, param_attr=PA(name="out_fc_w"),
                               bias_attr=PA(name="out_fc_b"))
            sel_ids, sel_scores, parent = static.beam_search(
                static.assign(pre_ids), static.assign(pre_scores),
                static.reshape(logits, [B, K, V]), K, MT_EOS)
            static.assign(static.array_write(sel_ids, i, ids_arr), ids_arr)
            static.assign(static.array_write(parent, i, parents_arr),
                          parents_arr)
            static.assign(sel_ids, pre_ids)
            static.assign(sel_scores, pre_scores)
            static.assign(static.gather(h_new, static.reshape(
                static.elementwise_add(parent, base), [B * K])), h)
            ni = static.increment(static.assign(i), value=1)
            static.assign(ni, i)
            static.assign(static.less_than(ni, n), cond)
        ids, scores = static.beam_search_decode(ids_arr, parents_arr,
                                                pre_scores, end_id=MT_EOS)
    return prog, [ids.name, scores.name]


def mt_batch(rng, n, src_len=MT_SRC_LEN):
    """`n` pairs from numpy: sources of 4-src_len ids in [3, 30000), the
    target the reversed source (test_book_seq2seq's rule) after BOS and
    before EOS, padded with 0, with their lengths."""
    lens = rng.randint(4, src_len + 1, n).astype(np.int64)
    src = np.zeros((n, src_len), np.int64)
    trg_in = np.zeros((n, src_len + 1), np.int64)
    trg_out = np.zeros((n, src_len + 1), np.int64)
    for b, L in enumerate(lens):
        s = rng.randint(3, MT_VOCAB, L)
        src[b, :L] = s
        trg_in[b, :L + 1] = np.concatenate([[MT_BOS], s[::-1]])
        trg_out[b, :L + 1] = np.concatenate([s[::-1], [MT_EOS]])
    return {"src": src, "src_len": lens, "trg_in": trg_in,
            "trg_out": trg_out[..., None], "trg_len": lens + 1}


def mt_forward_flops(program, batch):
    """Forward flops of the MT program at `batch` pairs over the padded
    lengths: 2 per multiply-add of each fc (`mul`, its rows batch x the
    padded length) and of each GRU's recurrent matmuls (h [B, 512]
    against the [512, 1536] weight at every padded step)."""
    block = program.global_block()
    total = 0
    for op in block.ops:
        if op.type == "mul":
            x = block.var(op.inputs["X"][0]).shape
            y = block.var(op.inputs["Y"][0]).shape
            rows = batch * int(np.prod(x[1:op.attrs.get("x_num_col_dims",
                                                        1)]))
            total += 2 * y[0] * y[1] * rows
        elif op.type == "gru":
            steps = block.var(op.inputs["Input"][0]).shape[1]
            w = block.var(op.inputs["Weight"][0]).shape
            total += 2 * w[0] * w[1] * batch * steps
    return total


def mt_training(torch, seed, tag, batch=MT_BATCH,
                check_batch=MT_CHECK_BATCH, warmup=3, steps=10):
    """Phase 20. machine_translation at the book's widths on the card.
    (a) One step at `check_batch`, card against the host CPU: float32
    loss within LOSS_RTOL; float64, every parameter's change within
    VGG_UPDATE_TOL of lr and the Adam moments within VGG_MOMENT_TOL of
    their max. (b) `warmup` + `steps` steps at `batch`: losses finite
    and falling; step ms, target tokens/s and peak memory beside the
    step's f32 bound (3 x the forward flops at 67 TFLOP/s). (c) the
    decode program on the trained weights: float64 card against CPU (ids
    equal, scores within MT_SCORE_TOL64 of their max), then f32 on the
    card timed, the best beam's scores >= the last's, and save / load
    giving the same ids. Returns (summary, main, scope, feed, loss,
    decode program, its feed, its fetches)."""
    import shutil
    import tempfile
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy

    rng = np.random.RandomState(seed + 20)
    feed = mt_batch(rng, batch)
    small = {k: v[:check_batch] for k, v in feed.items()}
    main, startup, loss = mt_programs(seed)
    scope = Scope()
    Executor().run(startup, scope=scope)
    start = scope_to_numpy(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    params = next(op for op in main.global_block().ops
                  if op.type == "autodiff").attrs["params"]

    # (a) card against the CPU, one step
    agreement = {}
    wide = widen_state(start)
    main64 = fully_widened(torch, main)
    for dt, prog, st in (("float32", main, start), ("float64", main64,
                                                    wide)):
        (gl,), g = one_step(torch, prog, st, small, [loss], "cuda")
        (cl,), c = one_step(torch, prog, st, small, [loss], "cpu")
        rel = abs(float(gl) - float(cl)) / abs(float(cl))
        row = {"loss_card": float(gl), "loss_cpu": float(cl),
               "loss_rel_err": rel, "loss_gate": LOSS_RTOL}
        line = (f"mt one step at batch {check_batch}, {dt}, card vs CPU: "
                f"loss {float(gl):.12g} vs {float(cl):.12g}, rel {rel:.3g} "
                f"(gate {LOSS_RTOL})")
        assert rel <= LOSS_RTOL, (dt, rel)
        if dt == "float64":
            upd = {n: float(np.abs((g[n] - st[n]) - (c[n] - st[n])).max()
                            / MT_LR) for n in params}
            moments = [n for n in c if n.endswith(("_moment1_Adam",
                                                   "_moment2_Adam"))]
            mom = {n: float(np.abs(g[n] - c[n]).max()
                            / max(np.abs(c[n]).max(), 1e-300))
                   for n in moments}
            row.update(update_of_lr=worst3(upd), moments=worst3(mom))
            line += (f"; parameter changes worst |d| / lr {worst3(upd)} "
                     f"(gate {VGG_UPDATE_TOL}); Adam moments worst "
                     f"{worst3(mom)} (gate {VGG_MOMENT_TOL})")
            assert max(upd.values()) <= VGG_UPDATE_TOL, worst3(upd)
            assert max(mom.values()) <= VGG_MOMENT_TOL, worst3(mom)
        print(line + f" {tag}")
        agreement[dt] = row

    # (b) training at `batch`
    flops = mt_forward_flops(main, batch)
    bound = 3 * flops / F32_FLOPS * 1e3
    exe = Executor()
    scope = scope_from_jax(start, Scope())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            return_numpy=False)[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(o) for o in outs]
    tokens = int(feed["trg_len"].sum())
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    print(f"mt training, batch {batch} ({tokens} target tokens, padded to "
          f"{MT_TRG_LEN}), f32 (TF32 off), Adam {MT_LR}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} over {warmup + steps} steps; "
          f"{step_ms:.2f} ms a step (wall, {steps} steps after {warmup}), "
          f"{tokens / step_ms * 1e3:.1f} target tokens/s; f32 bound "
          f"{bound:.3f} ms (3 x {flops / 1e9:.2f} GFLOP at "
          f"{F32_FLOPS / 1e12:.0f} TFLOP/s); peak {peak_gib:.2f} GiB {tag}")

    # (c) the decode program on the trained weights
    dec, dfetch = mt_decode_program()
    dfeed = {k: v for k, v in mt_batch(
        np.random.RandomState(seed + 21), MT_DECODE_BATCH).items()
        if k in ("src", "src_len")}
    names = [v.name for v in dec.list_vars() if v.persistable]
    trained = scope_to_numpy(scope, sorted(n for n in names
                                           if scope.has(n)))
    dec64 = fully_widened(torch, dec)
    (gi, gs), _ = one_step(torch, dec64, widen_state(trained), dfeed,
                           dfetch, "cuda")
    (ci, cs), _ = one_step(torch, dec64, widen_state(trained), dfeed,
                           dfetch, "cpu")
    score_err = float(np.abs(gs - cs).max() / np.abs(cs).max())
    print(f"mt decode, float64, card vs CPU: ids equal "
          f"{bool(np.array_equal(gi, ci))}, scores max |d| / max |s| "
          f"{score_err:.3g} (gate {MT_SCORE_TOL64}) {tag}")
    assert np.array_equal(gi, ci), "float64 decode ids differ"
    assert score_err <= MT_SCORE_TOL64, score_err
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, scores = exe.run(dec, feed=dfeed, fetch_list=dfetch, scope=scope,
                          training=False)
    decode_ms = (time.perf_counter() - t0) * 1e3
    assert ids.shape == (MT_DECODE_BATCH, MT_BEAM, MT_DECODE_STEPS)
    assert np.isfinite(scores).all()
    assert (scores[:, 0] >= scores[:, -1]).all(), scores
    model_dir = tempfile.mkdtemp(prefix="mt_decode_")
    try:
        with scope_guard(scope):
            static.io.save_inference_model(model_dir, ["src", "src_len"],
                                           [dfetch[0]], exe,
                                           main_program=dec)
        with scope_guard(Scope()):
            prog, feeds, fetches = static.io.load_inference_model(
                model_dir, exe)
            (ids2,) = exe.run(prog, feed={k: dfeed[k] for k in feeds},
                              fetch_list=fetches, training=False)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    assert np.array_equal(np.asarray(ids2).reshape(ids.shape), ids)
    ended = float((ids[:, 0] == MT_EOS).any(axis=-1).mean())
    print(f"mt decode, batch {MT_DECODE_BATCH}, beam {MT_BEAM}, "
          f"{MT_DECODE_STEPS} steps, f32 on the card: {decode_ms:.2f} ms "
          f"(wall, one run); best beam >= last beam in every row; "
          f"{ended:.3f} of the best beams end in EOS; saved and loaded: "
          f"ids equal {tag}")
    summary = {"config": "machine_translation (test_book_seq2seq's GRU "
                         "seq2seq at Fluid book ch. 08 widths): "
                         "dictionaries 30000, word_dim 512, hidden 512, "
                         f"Adam {MT_LR}, batch {batch}, sources 4-30, f32",
               "agreement": agreement, "losses": losses, "step_ms": step_ms,
               "target_tokens": tokens,
               "target_tokens_per_s": tokens / step_ms * 1e3,
               "forward_flops": flops, "bound_ms": bound,
               "peak_gib": peak_gib,
               "decode": {"float64_score_err": score_err,
                          "ms": decode_ms, "best_beams_ended": ended}}
    return summary, main, scope, feed, loss, dec, dfeed, dfetch


def decode_profile(torch, dec, dfeed, dfetch, scope, tag, runs=3):
    """Phase 21's decode: wall and device ms a decode run, the idle share
    and top kernels, the launches a While iteration, and the condition
    reads on the host (count and the seconds the host waited in them)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.ops import control_flow

    exe = Executor()

    def run(n):
        for _ in range(n):
            exe.run(dec, feed=dfeed, fetch_list=dfetch, scope=scope,
                    training=False, return_numpy=False)
        torch.cuda.synchronize()

    run(1)
    control_flow.reset_host_reads()
    t0 = time.perf_counter()
    run(runs)
    wall = (time.perf_counter() - t0) / runs * 1e3
    reads = dict(control_flow.host_reads)
    brk = profile_device(torch, run, runs, top=10)
    label = (f"mt decode run, batch {MT_DECODE_BATCH}, beam {MT_BEAM}, "
             f"{MT_DECODE_STEPS} While iterations")
    print_profile(label, brk, tag)
    per_iter = brk["launches_per_step"] / MT_DECODE_STEPS
    print(f"{label}: {brk['launches_per_step']:.0f} launches a run, "
          f"{per_iter:.1f} a While iteration; condition reads on the host "
          f"{reads['while'] / runs:.0f} a run ({reads['while_iterations'] / runs:.0f} "
          f"iterations), the host waited {reads['wait_s'] / runs * 1e3:.3f} "
          f"ms a run in them ({reads['wait_s'] / runs * 1e3 / wall:.3f} of "
          f"the {wall:.3f} ms wall) {tag}")
    brk.update(launches_per_iteration=per_iter,
               condition_reads_per_run=reads["while"] / runs,
               condition_wait_ms_per_run=reads["wait_s"] / runs * 1e3,
               wall_ms_unprofiled=wall)
    return brk


# ---------------------------------------------------------------------------
# Fluid's dygraph mode: Transformer-big on the flash kernels, the eager zoo
# ---------------------------------------------------------------------------

#: phase 22: the Transformer-big attentions (N=16, D=64) as (label, B,
#: Tq, Tk, causal, key bias): encoder self-attention with the padding
#: bias, decoder self-attention (causal, no bias) and cross-attention
#: with the bias; first ragged lengths (T = 250 and 231, Tq != Tk), then
#: the shapes the main path launches (RaggedBatcher pads each batch to
#: its bucket: 256 at B=32 and 128 at B=64 in phase 23; phase 24's
#: encoder over the 64 bucket and its 48-token prefix, at B=8 in both
#: decodes)
TRANSFORMER_FLASH_CASES = (
    ("self-pad", 32, 250, 250, False, True),
    ("causal", 32, 231, 231, True, False),
    ("cross-pad", 32, 231, 250, False, True),
    ("decode", 32, 48, 64, False, True),
    ("train self-pad", 32, 256, 256, False, True),
    ("train causal", 32, 256, 256, True, False),
    ("train cross-pad", 32, 256, 256, False, True),
    ("train self-pad", 64, 128, 128, False, True),
    ("train causal", 64, 128, 128, True, False),
    ("train cross-pad", 64, 128, 128, False, True),
    ("decode self-pad", 8, 64, 64, False, True),
    ("decode causal", 8, 48, 48, True, False),
    ("decode cross-pad", 8, 48, 64, False, True),
)
TRANSFORMER_HEADS, TRANSFORMER_HEAD_DIM = 16, 64
#: phase 23: momentum SGD (the JAX package's TrainStep) on one batch
#: per bucket; bucket -> batch size
MT_BIG_LR = 0.05
#: phase 23's synthetic pairs draw ids in [2, MT_BIG_VOCAB)
MT_BIG_VOCAB = 30000
MT_BIG_BUCKETS = {256: 32, 128: 64}
MT_BIG_TIMED = 3
#: phase 23's one step at batch 4 (the 32 bucket), card against the host
#: CPU: the loss (relative) and each parameter's gradient, max |diff| of
#: its tensor's max, floored at `floor` of the largest gradient (the key
#: biases' exact gradient is 0, both sides hold rounding noise there):
#: f32 through the flash kernels (their plain version on the CPU);
#: float64 through the plain attention on both. The f32 gate's control,
#: the card's bf16 step (the bf16 flash kernels) against the CPU's f32
#: one, must read above `f32_grad`. On an H100 80GB HBM3 at 700 W the
#: f32 step read 4.12e-6 (at a cross-attention's q weight) and the
#: control 0.2; `f32_grad` is the power of ten at or above 10x the f32
#: reading.
MT_BIG_CHECK = dict(batch=4, bucket=32, f32_loss=1e-5, f32_grad=1e-4,
                    f32_floor=1e-2, f64_loss=1e-12, f64_grad=1e-9,
                    f64_floor=1e-6)
#: phase 24: greedy decoding at B=8 of sources in the 64 bucket, beam
#: search K=4 at B=2, 48 target tokens
MT_DECODE = dict(greedy_batch=8, beam_batch=2, beam=4, bucket=64,
                 max_len=48)
#: phase 25: ResNet-50 NCHW against NHWC from the same weights (cuDNN
#: picks other algorithms per layout): the first step's loss (relative)
#: and the logits before it (of their max)
ZOO_LAYOUT_TOL = dict(loss=1e-4, logits=1e-3)
#: phase 25: a TracedLayer against the eager eval forward, of its max
TRACED_TOL = 1e-5


def attention_flops(b, n, tq, tk, d, causal):
    """Forward FLOPs of one attention: QK^T and PV, halved for causal."""
    f = 4 * b * n * tq * tk * d
    return f // 2 if causal else f


def transformer_lengths(rng, b, tk):
    """Phase 22's key lengths: [B] drawn in [16, Tk], row 0 full."""
    lengths = rng.randint(16, tk + 1, b)
    lengths[0] = tk
    return lengths


def transformer_flash(torch, tfa, seed, tag, n=TRANSFORMER_HEADS,
                      d=TRANSFORMER_HEAD_DIM, cases=TRANSFORMER_FLASH_CASES,
                      copies=2, dev="cuda"):
    """Phase 22. The flash kernels at the Transformer's shapes against
    their plain version (`flash_case`: forward o and lse, backward dq,
    dk, dv), f32 and bf16, within FLASH_TOL of the plain version's max;
    then each case's forward and forward + backward timed beside SDPA's
    on the same tensors."""
    import torch.nn.functional as F
    dev = torch.device(dev)
    rng = np.random.RandomState(seed + 22)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        fwd_k, (bwd_k,) = tfa.KERNELS[dtype]
        for label, b, tq, tk, causal, pad in cases:
            lengths = transformer_lengths(rng, b, tk) if pad else None
            errs, launched = flash_case(torch, tfa, dev, dtype, b, tq, n, d,
                                        tk=tk, lengths=lengths,
                                        causal=causal, seed=seed + tq + tk)
            assert launched == {fwd_k: 2, bwd_k: 1}, (label, dname,
                                                      launched)
            errs = {k: r for k, (_, r) in errs.items()}
            worst = max(errs.values())
            sets = [attn_inputs(torch, dev, dtype, b, tq, tk, n, d, lengths,
                                seed + 100 * i + tq + tk)
                    for i in range(copies)]

            def fwd(s):
                return tfa.flash_attention(s["q"], s["k"], s["v"], s["mask"],
                                           causal=causal)

            def lib(s):
                return F.scaled_dot_product_attention(
                    s["q"].transpose(1, 2), s["k"].transpose(1, 2),
                    s["v"].transpose(1, 2),
                    attn_mask=(None if s["mask"] is None
                               else s["mask"].to(dtype)), is_causal=causal)

            def fwd_bwd(attn):
                def run(s):
                    x = [s[key].detach().requires_grad_() for key in "qkv"]
                    o = attn(dict(s, q=x[0], k=x[1], v=x[2]))
                    if o.shape[1] != tq:        # SDPA's [B, N, T, D]
                        o = o.transpose(1, 2)
                    return torch.autograd.grad(o, x, s["dout"])
                return run

            args = [(t,) for t in sets]
            row = dict(
                dtype=dname, b=b, tq=tq, tk=tk, causal=causal, pad=pad,
                rel_err=errs, fwd_ms=timed_ms(torch, fwd, args),
                sdpa_fwd_ms=timed_ms(torch, lib, args),
                fwd_bwd_ms=timed_ms(torch, fwd_bwd(fwd), args),
                sdpa_fwd_bwd_ms=timed_ms(torch, fwd_bwd(lib), args),
                flops_fwd=attention_flops(b, n, tq, tk, d, causal))
            out[f"{label} B={b} {tq}x{tk} {dname}"] = row
            print(f"phase 22 {label} {dname} B={b} Tq={tq} Tk={tk} N={n} "
                  f"D={d} causal={causal} pad={pad}: max rel err "
                  f"{worst:.3g} (o {errs['o']:.3g}, lse {errs['lse']:.3g}, "
                  f"dq {errs['dq']:.3g}, dk {errs['dk']:.3g}, dv "
                  f"{errs['dv']:.3g}; tol {FLASH_TOL[dname]}); kernel fwd "
                  f"{row['fwd_ms']:.5f} ms, fwd+bwd {row['fwd_bwd_ms']:.5f} "
                  f"ms; SDPA fwd {row['sdpa_fwd_ms']:.5f} ms, fwd+bwd "
                  f"{row['sdpa_fwd_bwd_ms']:.5f} ms {tag}")
            assert worst <= FLASH_TOL[dname], (label, dname, errs)
            del sets
    torch.cuda.empty_cache()
    return out


def mt_pairs(seed, n, max_len=256, vocab=None):
    """Seeded synthetic translation pairs: source lengths uniform in
    [16, max_len], ids in [2, vocab); the target is a fixed permutation
    of the reversed source (a learnable mapping); (src, trg_in, trg_out)
    with trg_in = [BOS 0] + trg[:-1]."""
    vocab = vocab or MT_BIG_VOCAB

    def reader():
        rng = np.random.RandomState(seed)
        perm = rng.permutation(vocab - 2) + 2
        for _ in range(n):
            t = int(rng.randint(16, max_len + 1))
            src = rng.randint(2, vocab, t).astype(np.int64)
            trg = perm[src[::-1] - 2].astype(np.int64)
            yield src, np.concatenate([[0], trg[:-1]]), trg
    return reader


def mt_bucket_batch(seed, bucket, batch, skip=0, n=4000):
    """The (skip+1)-th batch of `batch` pairs whose source falls in
    `bucket` of bucket_boundaries(256), from io.ragged.RaggedBatcher:
    (src [B, T], src_len [B], trg_in [B, T], trg_out [B, T]) numpy, the
    targets padded with 0 (the loss's pad id) to the same bucket."""
    from paddle_tpu_torch.io import ragged
    batcher = ragged.RaggedBatcher(mt_pairs(seed, n), batch,
                                   ragged.bucket_boundaries(256),
                                   ragged_indices=[0, 1, 2], drop_last=True)
    found = (bt for bt in batcher() if bt[0].shape[1] == bucket)
    for _ in range(skip):
        next(found)
    return next(found)


def mt_flops(cfg, b, t):
    """Training FLOPs of one Transformer step at [b, t] (source and
    target): 6 x tokens x matmul parameters (the q/k/v/o projections,
    the FFNs, the output projection) plus the 18 attentions (3 x their
    forward; the decoder's causal ones halved)."""
    h, f, v = cfg.d_model, cfg.ffn_dim, cfg.trg_vocab
    enc = cfg.num_encoder_layers * (4 * h * h + 2 * h * f)
    dec = cfg.num_decoder_layers * (8 * h * h + 2 * h * f)
    matmul = 6 * b * t * (enc + dec + h * v)
    n, d = cfg.num_heads, cfg.d_model // cfg.num_heads
    attn = 3 * (cfg.num_encoder_layers * attention_flops(b, n, t, t, d, False)
                + cfg.num_decoder_layers * (
                    attention_flops(b, n, t, t, d, True)
                    + attention_flops(b, n, t, t, d, False)))
    return matmul + attn


def _to(torch, batch, device):
    return tuple(torch.from_numpy(np.asarray(a)).to(device) for a in batch)


def mt_big_config():
    """Phase 23's model: TransformerConfig.big() through the flash
    kernels."""
    import dataclasses

    from paddle_tpu_torch.models.transformer import TransformerConfig
    return dataclasses.replace(TransformerConfig.big(),
                               attention_impl="flash")


def grad_err(got, want, floor):
    """max over the tensors of max |got - want| / max |want|, that max
    floored at `floor` of the largest |want|; -> (error, its tensor)."""
    top = max(float(w.abs().max()) for w in want.values())
    errs = {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), floor * top)
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def mt_step_check(torch, cfg, state, seed, tag, dev="cuda"):
    """Phase 23(c). One step at batch 4 (the 32 bucket) from the same
    weights on the card and on the host CPU: in f32 through the flash
    kernels (the CPU's plain version) and in float64 through the plain
    attention on both; then the card's bf16 step against the CPU's f32
    one, the control that the f32 gradient gate must reject; gates
    MT_BIG_CHECK."""
    import dataclasses

    from paddle_tpu_torch.models.transformer import Transformer
    chk = MT_BIG_CHECK
    batch = mt_bucket_batch(seed + 1, chk["bucket"], chk["batch"])

    def step(impl, dt, where, dtype=None):
        mcfg = dataclasses.replace(cfg, attention_impl=impl,
                                   dtype=dtype or str(dt).split(".")[-1])
        m = Transformer(mcfg, device=where).to(dt)
        m.load_state_dict(state)
        loss = m.loss(*_to(torch, batch, where))
        loss.backward()
        return float(loss.detach()), {k: p.grad.detach().to("cpu", dt)
                             for k, p in m.named_parameters()}

    out, f32_cpu = {}, None
    for label, impl, dt, key in (
            ("f32 flash", "flash", torch.float32, "f32"),
            ("float64 plain", "xla", torch.float64, "f64"),
            ("bf16 flash control", "flash", torch.float32, None)):
        if key:
            (lc, gc), (lh, gh) = (step(impl, dt, where)
                                  for where in (dev, "cpu"))
        else:   # the control: the card in bf16 against the CPU in f32
            (lc, gc), (lh, gh) = step(impl, dt, dev, "bfloat16"), f32_cpu
        if key == "f32":
            f32_cpu = (lh, gh)
        floor = chk[f"{key or 'f32'}_floor"]
        gates = (chk[f"{key or 'f32'}_loss"], chk[f"{key or 'f32'}_grad"])
        loss_err = abs(lc - lh) / abs(lh)
        gerr, worst = grad_err(gc, gh, floor)
        out[label] = dict(loss_card=lc, loss_cpu=lh, loss_rel_err=loss_err,
                          grad_err=gerr, worst=worst, gates=gates)
        print(f"phase 23(c) {label}, batch {chk['batch']} x "
              f"{chk['bucket']}: loss card {lc:.9f} cpu {lh:.9f} (rel "
              f"{loss_err:.3g}, gate {gates[0]}), gradient err {gerr:.3g} "
              f"at {worst} (each of its tensor's max floored at {floor} "
              f"of the largest; gate {gates[1]}"
              f"{', must fail' if key is None else ''}) {tag}")
        if key:
            assert loss_err <= gates[0] and gerr <= gates[1], (label,
                                                               out[label])
        else:
            assert gerr > gates[1], ("the f32 gate passes the bf16 step",
                                     out[label])
        del gc
        torch.cuda.empty_cache()
    return out


def mt_big_training(torch, tfa, seed, tag, dev="cuda"):
    """Phase 23. Transformer-big (TransformerConfig.big(): d_model 1024,
    16 heads, FFN 4096, 6 + 6 layers, 30000-word vocabularies),
    attention_impl "flash", f32 with TF32 off, trained by nn.TrainStep
    (momentum SGD). One batch per bucket of bucket_boundaries(256) from
    io.ragged.RaggedBatcher: the 256 bucket at B=32, then the 128 bucket
    at B=64, each one warm-up step then MT_BIG_TIMED timed steps (the
    flash launches of every step counted: 18 forward, 18 backward), then
    one profiled step (device ms, idle share, launches). Then (c) the
    card against the CPU at batch 4, and (d) one bf16 step at B=32.
    Returns (results, the trained model, the flash launches of the timed
    and warm-up steps)."""
    import dataclasses

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.transformer import Transformer
    cfg = mt_big_config()
    nn.seed(seed)
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev)
    init_s = time.perf_counter() - t0
    state0 = {k: v.detach().to("cpu", copy=True)
              for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 23: Transformer-big {cfg}, {n_params} parameters, init "
          f"{init_s:.1f} s {tag}")
    out = {"params": n_params, "buckets": {}}
    # (c) first, from the initial weights
    out["check"] = mt_step_check(torch, cfg, state0, seed, tag, dev)
    step = nn.TrainStep(model, lambda m, *b: m.loss(*b), MT_BIG_LR, 0.9)
    flash_launches = {k: 0 for k in FLASH_F32}
    fk, bk = FLASH_F32
    for bucket, bsz in MT_BIG_BUCKETS.items():
        batch = _to(torch, mt_bucket_batch(seed, bucket, bsz), dev)
        tokens = int((batch[3] != 0).sum())
        flops = mt_flops(cfg, bsz, bucket)
        bnd = flops / F32_FLOPS * 1e3
        losses, rows = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(1 + MT_BIG_TIMED):
            before = dict(tfa.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(*batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launched = {k: tfa.launch_counts[k] - before[k] for k in FLASH_F32}
            assert launched == {fk: 18, bk: 18}, launched
            for k in FLASH_F32:
                flash_launches[k] += launched[k]
            losses.append(float(loss))
            if i:
                rows.append(dict(wall_ms=wall, tokens_per_s=tokens / wall
                                 * 1e3, flash=launched))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        def run(k):
            for _ in range(k):
                step(*batch)
            torch.cuda.synchronize()

        before = dict(tfa.launch_counts)
        prof = profile_device(torch, run, 1, top=8)
        for k in FLASH_F32:
            flash_launches[k] += tfa.launch_counts[k] - before[k]
        res = dict(batch=bsz, bucket=bucket, target_tokens=tokens,
                   losses=losses, steps=rows, peak_gib=peak, bound_ms=bnd,
                   tflop=flops / 1e12, profile=prof)
        out["buckets"][bucket] = res
        for i, r in enumerate(rows):
            print(f"phase 23 bucket {bucket} B={bsz} step {i + 1}: wall "
                  f"{r['wall_ms']:.3f} ms, {r['tokens_per_s']:.1f} target "
                  f"tokens/s, flash launches {r['flash'][fk]} forward + "
                  f"{r['flash'][bk]} backward, peak {peak:.2f} GiB {tag}")
        dms = ("not measured" if prof["step_device_ms"] is None else
               f"{prof['step_device_ms']:.3f} ms, idle share "
               f"{prof['device_idle_share']:.3f}")
        print(f"phase 23 bucket {bucket} B={bsz}: profiled step wall "
              f"{prof['step_wall_ms']:.3f} ms, device {dms}, "
              f"{prof['launches_per_step']:.0f} launches; losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; {flops / 1e12:.2f} "
              f"TFLOP a step, bound {bnd:.3f} ms at 67 TFLOP/s {tag}")
        print_profile(f"transformer-big step, bucket {bucket} B={bsz}",
                      prof, tag)
        del batch
    # (d) one bf16 step at B=32: the bf16 flash kernels on the path
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bmodel = Transformer(bcfg, device=dev)
    bmodel.load_state_dict(state0)
    bstep = nn.TrainStep(bmodel, lambda m, *b: m.loss(*b), MT_BIG_LR, 0.9)
    bucket, bsz = next(iter(MT_BIG_BUCKETS.items()))
    batch = _to(torch, mt_bucket_batch(seed, bucket, bsz), dev)
    before = dict(tfa.launch_counts)
    t0 = time.perf_counter()
    bl = float(bstep(*batch))
    torch.cuda.synchronize()
    bwall = (time.perf_counter() - t0) * 1e3
    blaunch = {k: tfa.launch_counts[k] - before[k] for k in FLASH_BF16}
    assert np.isfinite(bl) and blaunch == dict.fromkeys(FLASH_BF16, 18), (
        bl, blaunch)
    for k in FLASH_BF16:
        flash_launches[k] = blaunch[k]
    out["bf16"] = dict(loss=bl, wall_ms=bwall, flash=blaunch)
    print(f"phase 23(d) bf16 step B={bsz} x {bucket}: loss {bl:.4f} (f32 "
          f"step 1: {out['buckets'][bucket]['losses'][0]:.4f}), wall "
          f"{bwall:.1f} ms "
          f"(first bf16 call), flash launches {blaunch} {tag}")
    del bmodel, bstep, batch, step
    torch.cuda.empty_cache()
    return out, model, flash_launches


def mt_big_decode(torch, tfa, model, seed, tag, dev="cuda"):
    """Phase 24. Greedy decoding (B=8, sources in the 64 bucket,
    max_len 48) and beam search (K=4, B=2) of the trained
    Transformer-big through the flash kernels, against the same decodes
    through the plain attention on the card (the same weights): the ids
    must be equal. Host reads of the decode loops and the host's wait in
    them. Returns (results, flash launches)."""
    import dataclasses

    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import beam_search as bs
    dc = MT_DECODE
    plain = T.Transformer(dataclasses.replace(model.cfg,
                                              attention_impl="xla"),
                          device=dev)
    plain.load_state_dict(model.state_dict())
    model.eval()
    plain.eval()
    src, src_len, _, _ = _to(torch, mt_bucket_batch(
        seed + 2, dc["bucket"], dc["greedy_batch"]), dev)
    x = torch.tensor([[0.0, 3.0, 1.0, 3.0], [2.0, 2.0, 2.0, -1.0]],
                     device=dev)
    assert torch.argmax(x, dim=-1).tolist() == [1, 0], "argmax tie order"
    out = {}
    launches = dict.fromkeys(FLASH_F32, 0)
    for label, fn in (
            ("greedy", lambda m: m.greedy_decode(src, src_len,
                                                 max_len=dc["max_len"])),
            ("beam", lambda m: m.beam_search_decode(
                src[:dc["beam_batch"]], src_len[:dc["beam_batch"]],
                max_len=dc["max_len"], beam_size=dc["beam"]))):
        res = {}
        for impl, m in (("flash", model), ("plain", plain)):
            T.reset_host_reads()
            bs.reset_host_reads()
            before = dict(tfa.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = fn(m)
            ids = ids[0] if isinstance(ids, tuple) else ids
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reads = (T.host_reads["greedy_decode"] if label == "greedy"
                     else bs.host_reads["beam_search"])
            wait = (T.host_reads["wait_s"] if label == "greedy"
                    else bs.host_reads["wait_s"])
            res[impl] = dict(ids=ids.cpu(), wall_s=wall, host_reads=reads,
                             wait_s=wait, flash={
                                 k: tfa.launch_counts[k] - before[k]
                                 for k in FLASH_F32})
            if impl == "flash":
                for k in FLASH_F32:
                    launches[k] += res[impl]["flash"][k]
        assert torch.equal(res["flash"]["ids"], res["plain"]["ids"]), label
        assert res["flash"]["flash"][FLASH_F32[0]] > 0
        assert res["plain"]["flash"][FLASH_F32[0]] == 0
        f = res["flash"]
        out[label] = dict(shape=tuple(f["ids"].shape), wall_s=f["wall_s"],
                          plain_wall_s=res["plain"]["wall_s"],
                          host_reads=f["host_reads"], wait_s=f["wait_s"],
                          flash_launches=f["flash"][FLASH_F32[0]])
        print(f"phase 24 {label} {tuple(f['ids'].shape)}: ids equal to the "
              f"plain attention's; flash {f['wall_s'] * 1e3:.1f} ms, plain "
              f"{res['plain']['wall_s'] * 1e3:.1f} ms; {f['host_reads']} "
              f"host reads, the host waited {f['wait_s'] * 1e3:.3f} ms in "
              f"them; {f['flash'][FLASH_F32[0]]} flash forward launches "
              f"{tag}")
    del plain
    torch.cuda.empty_cache()
    return out, launches


def zoo_step(torch, model, loss_fn, args, lr=0.01):
    """Two momentum-SGD steps of `model` (nn.TrainStep) on one batch:
    (first loss, second loss, wall ms of the second step)."""
    from paddle_tpu_torch import nn
    step = nn.TrainStep(model, loss_fn, lr, 0.9)
    first = float(step(*args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = float(step(*args))
    torch.cuda.synchronize()
    return first, second, (time.perf_counter() - t0) * 1e3


def eager_zoo(torch, seed, tag, image=224, resnet_batch=32, zoo_batch=16,
              ctr_batch=4096, dev="cuda"):
    """Phase 25. The eager vision and CTR zoo at full width on the card:
    (a) resnet50() NCHW and NHWC from the same weights (filters OIHW ->
    HWIO), the logits and loss before a step, then one step each;
    (b) one step each of vgg16, MobileNetV1 and SE-ResNeXt-50; (c)
    DeepFM at its default config; (d) save_dygraph / load_dygraph of the
    ResNet, bit-exact; (e) a TracedLayer of the ResNet in eval mode
    against the eager forward."""
    import tempfile

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import deepfm, resnet, vision_zoo
    F = nn.functional
    rng = np.random.RandomState(seed + 25)
    out = {}

    def ce(logits, y):
        return F.softmax_cross_entropy(logits, y).mean()

    x = torch.from_numpy(rng.rand(resnet_batch, 3, image, image).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, resnet_batch)).to(dev)
    nn.seed(seed)
    nchw = resnet.resnet50(device=dev)
    nhwc = resnet.resnet50(data_format="NHWC", device=dev)
    with torch.no_grad():
        for (k, a), b in zip(nchw.state_dict().items(),
                             nhwc.state_dict().values()):
            b.copy_(a.permute(2, 3, 1, 0) if a.dim() == 4 else a)
    state = {k: v.detach().clone() for k, v in nchw.state_dict().items()}
    xh = x.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        l1, l2 = nchw(x), nhwc(xh)
    logit_err = float((l1 - l2).abs().max()) / float(l1.abs().max())
    loss1, after1, ms1 = zoo_step(torch, nchw, lambda m, a, b: ce(m(a), b),
                                  (x, y))
    loss2, after2, ms2 = zoo_step(torch, nhwc, lambda m, a, b: ce(m(a), b),
                                  (xh, y))
    loss_err = abs(loss1 - loss2) / abs(loss1)
    after_err = abs(after1 - after2) / abs(after1)
    out["resnet50"] = dict(logits_rel_err=logit_err, loss_nchw=loss1,
                           loss_nhwc=loss2, loss_rel_err=loss_err,
                           after_step_loss_rel_err=after_err,
                           step_ms_nchw=ms1, step_ms_nhwc=ms2,
                           images_per_s_nchw=resnet_batch / ms1 * 1e3,
                           images_per_s_nhwc=resnet_batch / ms2 * 1e3)
    print(f"phase 25(a) resnet50 batch {resnet_batch} x {image}^2: NHWC vs "
          f"NCHW from the same weights: logits {logit_err:.3g} of max (gate "
          f"{ZOO_LAYOUT_TOL['logits']}), step loss {loss1:.6f} vs "
          f"{loss2:.6f} (rel {loss_err:.3g}, gate "
          f"{ZOO_LAYOUT_TOL['loss']}), loss after the step {after1:.6f} vs "
          f"{after2:.6f} (rel {after_err:.3g}); second step {ms1:.1f} ms "
          f"NCHW, {ms2:.1f} ms NHWC ({resnet_batch / ms1 * 1e3:.1f} / "
          f"{resnet_batch / ms2 * 1e3:.1f} images/s) {tag}")
    assert logit_err <= ZOO_LAYOUT_TOL["logits"], logit_err
    assert loss_err <= ZOO_LAYOUT_TOL["loss"], loss_err
    del nhwc, xh
    torch.cuda.empty_cache()
    # (d) checkpoint round trip, (e) traced layer
    with tempfile.TemporaryDirectory() as d:
        path = nn.save_dygraph(nchw.state_dict(), os.path.join(d, "rn50"))
        fresh = resnet.resnet50(device=dev)
        params, _ = nn.load_dygraph(path)
        fresh.set_state_dict(params)
        exact = all(torch.equal(a, b) for a, b in zip(
            nchw.state_dict().values(), fresh.state_dict().values()))
        assert exact, "save_dygraph / load_dygraph changed a tensor"
        del fresh
        xe = x[:8]
        t0 = time.perf_counter()
        _, traced = nn.TracedLayer.trace(nchw, [xe])
        traced.save_inference_model(os.path.join(d, "traced"))
        loaded = nn.TracedLayer.load(os.path.join(d, "traced"))
        trace_s = time.perf_counter() - t0
        nchw.eval()
        with torch.no_grad():
            want = nchw(xe)
        got = loaded(xe)
        traced_err = float((got - want).abs().max()) / float(
            want.abs().max())
    out["resnet50"].update(checkpoint_bit_exact=exact,
                           traced_rel_err=traced_err, trace_s=trace_s)
    print(f"phase 25(d, e) resnet50: save_dygraph / load_dygraph "
          f"bit-exact; TracedLayer (torch.export, saved and loaded, "
          f"{trace_s:.1f} s) vs eager eval forward {traced_err:.3g} of max "
          f"(gate {TRACED_TOL}) {tag}")
    assert traced_err <= TRACED_TOL, traced_err
    del nchw, loaded, traced, state
    torch.cuda.empty_cache()
    # (b) the vision zoo at batch 16
    xs = x[:zoo_batch]
    ys = y[:zoo_batch]
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, build, fwd in (
            ("vgg16", lambda: vision_zoo.vgg16(image_size=image, device=dev),
             lambda m, a: m(a, gen)),
            ("mobilenet_v1", lambda: vision_zoo.MobileNetV1(device=dev),
             lambda m, a: m(a)),
            ("se_resnext50", lambda: vision_zoo.SEResNeXt(50, device=dev),
             lambda m, a: m(a))):
        m = build()
        loss, _, ms = zoo_step(torch, m, lambda mm, a, b: ce(fwd(mm, a), b),
                               (xs, ys))
        assert np.isfinite(loss), (name, loss)
        out[name] = dict(loss=loss, step_ms=ms,
                         images_per_s=zoo_batch / ms * 1e3)
        print(f"phase 25(b) {name} batch {zoo_batch} x {image}^2: loss "
              f"{loss:.4f}, step {ms:.1f} ms ({zoo_batch / ms * 1e3:.1f} "
              f"images/s) {tag}")
        del m
        torch.cuda.empty_cache()
    del x, y, xs, ys
    # (c) DeepFM at its default config
    cfg = deepfm.DeepFMConfig()
    m = deepfm.DeepFM(cfg, device=dev)
    dense = torch.from_numpy(rng.rand(ctr_batch, cfg.dense_dim).astype(
        np.float32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_per_slot, (
        ctr_batch, cfg.num_slots))).to(dev)
    labels = torch.from_numpy(rng.randint(0, 2, ctr_batch)).to(dev)
    loss, _, ms = zoo_step(torch, m, lambda mm, *a: mm.loss(*a),
                           (dense, ids, labels))
    assert np.isfinite(loss), loss
    out["deepfm"] = dict(loss=loss, step_ms=ms,
                         examples_per_s=ctr_batch / ms * 1e3)
    print(f"phase 25(c) deepfm {cfg}, batch {ctr_batch}: loss {loss:.4f}, "
          f"step {ms:.2f} ms ({ctr_batch / ms * 1e3:.0f} examples/s) {tag}")
    del m
    torch.cuda.empty_cache()
    return out


#: phases 26-28: YOLOv3 at YoloConfig() (DarkNet-53, 80 classes, the COCO
#: anchors and masks; Redmon & Farhadi 2018) with the training and NMS
#: settings of the Fluid models repo's PaddleCV/yolov3/config.py
YOLO_IMAGE, YOLO_BATCH, YOLO_MAX_BOXES = 608, 8, 50
YOLO_LR, YOLO_MOMENTUM, YOLO_L2 = 1e-3, 0.9, 5e-4
YOLO_NMS = dict(score_threshold=0.005, nms_top_k=400, keep_top_k=100,
                nms_threshold=0.45)
YOLO_WARMUP, YOLO_TIMED, YOLO_REQUESTS = 2, 4, 10
#: phase 27(c): one step at batch 2 x 320^2 (a published YOLOv3 input
#: size), card against the host CPU: float64 gates on the loss
#: (relative) and each gradient (of its tensor's max, floored at `floor`
#: of the largest)
YOLO_CHECK = dict(batch=2, image=320, loss=1e-12, grad=1e-9, floor=1e-6)
#: phase 26: float64 card against CPU, each continuous output of its max
DET_F64_TOL = 1e-9
#: phase 26's FPN widths: Mask R-CNN's P2 level (stride 4) of an
#: 800 x 1088 input, 512 sampled rois an image, 7 x 7 bins
FPN_FEAT, FPN_ROIS, FPN_IM = (2, 256, 200, 272), 512, (800, 1088)


def run_op(torch, name, args, attrs, dev):
    """One op of the port's registry, called as the Executor calls it."""
    from paddle_tpu_torch.core.registry import OpContext, get_op
    return get_op(name).fn(OpContext(attrs, None, True, 0, dev), *args)


def yolo_gt(rng, batch, max_boxes=YOLO_MAX_BOXES, classes=80):
    """Synthetic ground truth: 1..max_boxes boxes an image as normalized
    (cx, cy, w, h) inside the image, then zero rows (yolov3_loss's
    padding); labels in [0, classes)."""
    box = np.zeros((batch, max_boxes, 4), np.float32)
    label = np.zeros((batch, max_boxes), np.int32)
    for i in range(batch):
        k = rng.randint(1, max_boxes + 1)
        wh = rng.uniform(0.02, 0.5, (k, 2))
        box[i, :k] = np.concatenate([rng.uniform(wh / 2, 1 - wh / 2), wh], 1)
        label[i, :k] = rng.randint(0, classes, k)
    return box, label


def detection_cases(torch, seed):
    """Phase 26's cases: dicts of the op, its float64 numpy inputs, its
    attrs, the input whose gradient is checked (or None) and the
    outputs that must be equal, not close: {output: column or None}."""
    from paddle_tpu_torch.models.yolov3 import YoloConfig
    cfg = YoloConfig()
    rng = np.random.RandomState(seed + 26)
    n = YOLO_BATCH
    img = np.full((n, 2), YOLO_IMAGE, np.int32)
    gt_box, gt_label = yolo_gt(rng, n)
    cases, boxes, scores = [], [], []
    for hi, d in enumerate(cfg.downsamples):
        s = YOLO_IMAGE // d
        x = rng.randn(n, 255, s, s)
        anchors = [cfg.anchors[2 * a + k] for a in cfg.anchor_masks[hi]
                   for k in (0, 1)]
        attrs = dict(anchors=anchors, class_num=cfg.num_classes,
                     conf_thresh=0.005, downsample_ratio=d)
        cases.append(dict(label=f"yolo_box {s}^2", op="yolo_box",
                          inputs=[x, img], attrs=attrs, grad=None, exact={}))
        b, sc = run_op(torch, "yolo_box", [torch.from_numpy(x),
                                           torch.from_numpy(img)], attrs,
                       "cpu")
        boxes.append(b.numpy())
        scores.append(sc.numpy())
        cases.append(dict(
            label=f"yolov3_loss {s}^2", op="yolov3_loss",
            inputs=[x, gt_box.astype(np.float64), gt_label, None],
            attrs=dict(anchors=list(cfg.anchors),
                       anchor_mask=list(cfg.anchor_masks[hi]),
                       class_num=cfg.num_classes,
                       ignore_thresh=cfg.ignore_thresh, downsample_ratio=d,
                       use_label_smooth=True),
            grad=0, exact={1: None, 2: None}))
    cases.append(dict(
        label=f"multiclass_nms {sum(b.shape[1] for b in boxes)} x "
              f"{cfg.num_classes}", op="multiclass_nms",
        inputs=[np.concatenate(boxes, 1),
                np.concatenate(scores, 1).transpose(0, 2, 1)],
        attrs=dict(YOLO_NMS, background_label=-1), grad=None,
        exact={0: 0}))
    bsz, c, h, w = FPN_FEAT
    feat = rng.randn(*FPN_FEAT)
    wh = rng.uniform(16, 400, (bsz * FPN_ROIS, 2))
    xy = rng.uniform(0, 1, (bsz * FPN_ROIS, 2)) * (
        np.array(FPN_IM[::-1]) - wh)
    rois = np.concatenate([np.repeat(np.arange(bsz), FPN_ROIS)[:, None],
                           xy, xy + wh], 1)
    cases.append(dict(label=f"roi_align {bsz * FPN_ROIS} rois",
                      op="roi_align", inputs=[feat, rois, None],
                      attrs=dict(pooled_height=7, pooled_width=7,
                                 spatial_scale=0.25, sampling_ratio=2),
                      grad=0, exact={}))
    anchors, _ = run_op(torch, "anchor_generator",
                        [torch.zeros((1, 1, h, w), dtype=torch.float64)],
                        dict(anchor_sizes=[32.0], aspect_ratios=[0.5, 1.0,
                                                                 2.0],
                             stride=[4.0, 4.0]), "cpu")
    cases.append(dict(
        label=f"generate_proposals {h}x{w}x3", op="generate_proposals",
        inputs=[rng.uniform(0, 1, (bsz, 3, h, w)),
                0.1 * rng.randn(bsz, 12, h, w),
                np.array([[*FPN_IM, 1.0]] * bsz), anchors.numpy(),
                np.ones(anchors.shape)],
        attrs=dict(pre_nms_topN=2000, post_nms_topN=1000, nms_thresh=0.7,
                   min_size=0.0), grad=None, exact={1: None}))
    return cases


def det_run(torch, case, dev, dtype):
    """The case's outputs (and, with a gradient input, that input's
    gradient of sum(output 0 x cotangent) last) on `dev` in `dtype`."""
    args = []
    for a in case["inputs"]:
        t = None if a is None else torch.from_numpy(np.asarray(a))
        if t is not None and t.is_floating_point():
            t = t.to(dtype)
        args.append(None if t is None else t.to(dev))
    g = case["grad"]
    if g is not None:
        args[g].requires_grad_(True)
    with torch.enable_grad():
        outs = run_op(torch, case["op"], args, case["attrs"], dev)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        if g is not None:
            cot = torch.from_numpy(np.random.RandomState(0).uniform(
                0.5, 1.5, tuple(outs[0].shape))).to(dev, outs[0].dtype)
            outs.append(torch.autograd.grad((outs[0] * cot).sum(),
                                            [args[g]])[0])
    return [o.detach().to("cpu") for o in outs]


def det_errors(got, want, exact):
    """(max over outputs of max |got - want| / max |want|, whether every
    `exact` part is equal in got's dtype, the fraction of its entries
    that are)."""
    err, equal, agree = 0.0, True, []
    for i, (a, b) in enumerate(zip(got, want)):
        if i in exact:
            col = exact[i]
            pa, pb = (a, b) if col is None else (a[..., col], b[..., col])
            same = pa == pb.to(pa.dtype)
            equal = equal and bool(same.all())
            agree.append(float(same.double().mean()))
        if b.is_floating_point():
            scale = max(float(b.abs().max()), 1e-300)
            err = max(err, float((a.double() - b.double()).abs().max())
                      / scale)
    return err, equal, (min(agree) if agree else 1.0)


def detection_ops(torch, seed, tag, dev="cuda"):
    """Phase 26. The detection ops at YOLOv3's full-width shapes and an
    FPN's, card against the host CPU: in float64 every continuous output
    (and gradient) within DET_F64_TOL of its max and the discrete ones
    (NMS classes and row order, the objectness and match masks, the
    proposals' scores) equal; the f32 reading beside it; each op timed
    in f32 (median of 30, inputs L2-cold) with its launches a call."""
    out = {}
    for case in detection_cases(torch, seed):
        label = case["label"]
        t0 = time.perf_counter()
        want = det_run(torch, case, "cpu", torch.float64)
        cpu_s = time.perf_counter() - t0
        got = det_run(torch, case, dev, torch.float64)
        err, equal, _ = det_errors(got, want, case["exact"])
        err32, _, agree32 = det_errors(det_run(torch, case, dev,
                                               torch.float32), want,
                                       case["exact"])
        argsets = []
        for _ in range(2):
            a = [None if v is None else torch.from_numpy(np.asarray(v))
                 for v in case["inputs"]]
            argsets.append([None if t is None else
                            t.to(dev, torch.float32 if t.is_floating_point()
                                 else t.dtype) for t in a])

        def call(*args):
            return run_op(torch, case["op"], list(args), case["attrs"], dev)

        ms = timed_ms(torch, call, argsets)
        launches = host_launches(torch, call, argsets, calls=3)
        row = dict(f64_err=err, f64_discrete_equal=equal, f32_err=err32,
                   f32_discrete_agreement=agree32, ms=ms, launches=launches,
                   cpu_reference_s=cpu_s, case_s=time.perf_counter() - t0)
        extra = ""
        if case["grad"] is not None:
            g = case["grad"]

            def fwd_bwd(*args):
                args = list(args)
                args[g] = args[g].detach().requires_grad_(True)
                with torch.enable_grad():
                    o = call(*args)
                    o = o[0] if isinstance(o, (tuple, list)) else o
                    return torch.autograd.grad(o.sum(), [args[g]])

            row["fwd_bwd_ms"] = timed_ms(torch, fwd_bwd, argsets)
            row["fwd_bwd_launches"] = host_launches(torch, fwd_bwd,
                                                    argsets, calls=3)
            extra = (f"; forward + backward {row['fwd_bwd_ms']:.3f} ms, "
                     f"{row['fwd_bwd_launches']:.0f} launches")
        out[label] = row
        print(f"phase 26 {label}: float64 card vs CPU {err:.3g} of max (gate "
              f"{DET_F64_TOL}), discrete outputs "
              f"{'equal' if equal else 'DIFFER'}; f32 card vs float64 CPU "
              f"{err32:.3g}, discrete agreement {agree32:.4f}; f32 "
              f"{ms:.3f} ms (median of 30, L2-cold), {launches:.0f} "
              f"launches a call{extra}; {row['case_s']:.1f} s, the CPU's "
              f"float64 reference {cpu_s:.1f} s {tag}")
        assert err <= DET_F64_TOL and equal, (label, row)
        del argsets
        torch.cuda.empty_cache()
    return out


def yolo_batch(torch, rng, batch, image, dev):
    """Seeded images (uniform [0, 1)) and yolo_gt ground truth on `dev`."""
    box, label = yolo_gt(rng, batch)
    x = rng.rand(batch, 3, image, image).astype(np.float32)
    return _to(torch, (x, box, label), dev)


def yolo_step(torch, model, vel, batch):
    """One training step: the loss, its backward, then Fluid's Momentum
    (v = mu v + g; p -= lr v) with L2Decay (g += coeff p) on the conv
    filters (PaddleCV yolov3 gives the batch norms' scale and offset and
    the heads' biases L2Decay(0.)). Returns the loss, on the device."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    loss = model.loss(*batch)
    loss.backward()
    with torch.no_grad():
        grads = [p.grad for p in params]
        filters = [i for i, p in enumerate(params) if p.dim() == 4]
        torch._foreach_add_([grads[i] for i in filters],
                            [params[i] for i in filters], alpha=YOLO_L2)
        torch._foreach_mul_(vel, YOLO_MOMENTUM)
        torch._foreach_add_(vel, grads)
        torch._foreach_add_(params, vel, alpha=-YOLO_LR)
    return loss.detach()


def yolo_copy(cfg, state, dev, dtype):
    from paddle_tpu_torch.models.yolov3 import YOLOv3
    m = YOLOv3(cfg, device=dev).to(dtype)
    m.load_state_dict(state)
    return m


def yolo_step_check(torch, cfg, state, seed, tag, dev="cuda"):
    """Phase 27(c). One step's loss and gradients at batch 2 x 320^2 from
    the same weights on the card and on the host CPU (training mode):
    float64 gated by YOLO_CHECK, float32 printed."""
    chk = YOLO_CHECK
    rng = np.random.RandomState(seed + 270)
    box, label = yolo_gt(rng, chk["batch"])
    x = rng.rand(chk["batch"], 3, chk["image"], chk["image"])
    out = {}
    for dt in (torch.float64, torch.float32):
        res = []
        for where in (dev, "cpu"):
            m = yolo_copy(cfg, state, where, dt)
            batch = _to(torch, (x, box, label), where)
            loss = m.loss(batch[0].to(dt), *batch[1:])
            loss.backward()
            res.append((float(loss.detach()),
                        {k: p.grad.detach().to("cpu", torch.float64)
                         for k, p in m.named_parameters()}))
            del m, loss
        (lc, gc), (lh, gh) = res
        loss_err = abs(lc - lh) / abs(lh)
        gerr, worst = grad_err(gc, gh, chk["floor"])
        name = str(dt).split(".")[-1]
        out[name] = dict(loss_card=lc, loss_cpu=lh, loss_rel_err=loss_err,
                         grad_err=gerr, worst=worst)
        gate = (f"gates {chk['loss']}, {chk['grad']}" if dt == torch.float64
                else "not gated")
        print(f"phase 27(c) {name}, batch {chk['batch']} x {chk['image']}^2: "
              f"loss card {lc:.12f} cpu {lh:.12f} (rel {loss_err:.3g}), "
              f"gradient err {gerr:.3g} at {worst} (each of its tensor's "
              f"max floored at {chk['floor']} of the largest; {gate}) {tag}")
        if dt == torch.float64:
            assert loss_err <= chk["loss"] and gerr <= chk["grad"], out[name]
        del gc, gh
        torch.cuda.empty_cache()
    return out


def yolo_training(torch, seed, tag, dev="cuda"):
    """Phase 27. YOLOv3 at YoloConfig() trained at batch 8 x 608^2 (f32,
    TF32 off) on one seeded batch (1-50 boxes an image): (c) first, one
    step card against CPU; then YOLO_WARMUP + YOLO_TIMED steps, losses
    finite and falling; step wall ms, images/s, peak memory; a profiled
    step (device ms, idle share, launches, top kernels). Returns the
    numbers and the seeded initial weights (phase 28's)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.yolov3 import YOLOv3, YoloConfig
    cfg = YoloConfig()
    nn.seed(seed)
    t0 = time.perf_counter()
    model = YOLOv3(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 27: YOLOv3 {cfg}, {n_params} parameters, init "
          f"{time.perf_counter() - t0:.1f} s {tag}")
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {"params": n_params,
           "check": yolo_step_check(torch, cfg, state, seed, tag, dev)}
    batch = yolo_batch(torch, np.random.RandomState(seed + 27), YOLO_BATCH,
                       YOLO_IMAGE, dev)
    vel = [torch.zeros_like(p) for p in model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [yolo_step(torch, model, vel, batch)
              for _ in range(YOLO_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [yolo_step(torch, model, vel, batch)
               for _ in range(YOLO_TIMED)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / YOLO_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    def train(k):
        for _ in range(k):
            yolo_step(torch, model, vel, batch)
        torch.cuda.synchronize()

    brk = profile_device(torch, train, 2, top=8)
    out.update(losses=losses, step_ms=step_ms,
               images_per_s=YOLO_BATCH / step_ms * 1e3, peak_mem_gib=peak,
               breakdown=brk)
    print(f"phase 27 batch {YOLO_BATCH} x {YOLO_IMAGE}^2: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; step {step_ms:.1f} ms "
          f"wall ({YOLO_BATCH / step_ms * 1e3:.1f} images/s), peak memory "
          f"{peak:.2f} GiB {tag}")
    print_profile(f"yolov3 train step, batch {YOLO_BATCH} x {YOLO_IMAGE}^2",
                  brk, tag)
    print(f"  launches a step: {brk['launches_per_step']:.0f} {tag}")
    del vel, batch, model
    torch.cuda.empty_cache()
    return out, state


def precise_bn(torch, model, x):
    """Set every batch norm's running statistics to those of the batch x
    (one forward in training mode at momentum 0, Detectron's PreciseBN):
    a few training steps leave them far from the weights' own, and the
    eval-mode activations of 75 layers then grow past exp's range in the
    box decode."""
    from paddle_tpu_torch import nn
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm)]
    saved = [b.momentum for b in bns]
    for b in bns:
        b.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(x)
    for b, momentum in zip(bns, saved):
        b.momentum = momentum
    model.eval()


def yolo_predict(torch, state, seed, tag, dev="cuda"):
    """Phase 28. `predict` (yolo_box + multiclass_nms at YOLO_NMS) of
    YOLOv3 at phase 27's seeded initial weights (a few training steps
    teach it only that no cell holds an object: every objectness falls
    under 0.005 and NMS keeps no row) in eval mode, its batch-norm
    statistics those of a seeded calibration batch (`precise_bn`), at
    batch 8 x 608^2: [8, 100, 6] finite, rows kept;
    p50 request ms over YOLO_REQUESTS, images/s, launches, idle share and
    the request's host reads (synchronising calls, counted by
    torch.cuda.set_sync_debug_mode); then float64 card against CPU on the
    same weights at batch 2, classes and row order equal and values
    within DET_F64_TOL of their max, and the f32 rows' agreement."""
    import warnings

    from paddle_tpu_torch.models.yolov3 import YoloConfig
    model = yolo_copy(YoloConfig(), state, dev, torch.float32)
    rng = np.random.RandomState(seed + 28)
    cal, x = (torch.from_numpy(rng.rand(YOLO_BATCH, 3, YOLO_IMAGE,
                                        YOLO_IMAGE).astype(np.float32))
              .to(dev) for _ in range(2))
    precise_bn(torch, model, cal)
    del cal
    im = torch.full((YOLO_BATCH, 2), YOLO_IMAGE, dtype=torch.int32,
                    device=dev)

    def request(m=model, xs=x, ims=im):
        with torch.no_grad():
            return m.predict(xs, ims, **YOLO_NMS)

    first = request()
    torch.cuda.synchronize()
    assert tuple(first.shape) == (YOLO_BATCH, 100, 6), first.shape
    assert bool(torch.isfinite(first).all())
    kept = int((first[..., 0] >= 0).sum())
    assert kept > 0, "NMS kept no row"
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        request()
    torch.cuda.set_sync_debug_mode(0)
    host_reads = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    times = []
    for _ in range(YOLO_REQUESTS):
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))

    def serve(k):
        for _ in range(k):
            request()
        torch.cuda.synchronize()

    brk = profile_device(torch, serve, 2, top=8)
    state = model.state_dict()
    got, want = (request(yolo_copy(model.cfg, state, where,
                                   torch.float64).eval(),
                         x[:2].to(where, torch.float64), im[:2].to(where))
                 .to("cpu") for where in (dev, "cpu"))
    err, equal, _ = det_errors([got], [want], {0: 0})
    _, _, agree32 = det_errors([first[:2].to("cpu")], [want], {0: 0})
    out = dict(p50_request_ms=p50, images_per_s=YOLO_BATCH / p50 * 1e3,
               host_reads=host_reads, breakdown=brk, f64_err=err,
               f64_classes_equal=equal, f32_class_agreement=agree32,
               kept_rows=kept)
    print(f"phase 28 predict batch {YOLO_BATCH} x {YOLO_IMAGE}^2 "
          f"({YOLO_NMS}): p50 {p50:.2f} ms over {YOLO_REQUESTS} requests "
          f"({YOLO_BATCH / p50 * 1e3:.1f} images/s), "
          f"{brk['launches_per_step']:.0f} launches a request, host reads "
          f"{host_reads}, {out['kept_rows']} rows kept; float64 card vs "
          f"CPU at batch 2: classes and rows "
          f"{'equal' if equal else 'DIFFER'}, values {err:.3g} of max "
          f"(gate {DET_F64_TOL}); f32 card vs float64 CPU class agreement "
          f"{agree32:.4f} {tag}")
    print_profile(f"yolov3 predict request, batch {YOLO_BATCH}", brk, tag)
    assert equal and err <= DET_F64_TOL, out
    return out


# ---------------------------------------------------------------------------
# the rest of Fluid's op library (ops.misc, text, ctr, fused) and the
# CRNN-CTC text recogniser
# ---------------------------------------------------------------------------

#: phase 29: crnn_ctc_model.py at its widths, batch 32; warm-up and
#: timed steps on one seeded batch
CRNN_BATCH, CRNN_WARMUP, CRNN_TIMED, CRNN_DECODES = 32, 4, 16, 20
#: phase 29(c): one step at batch 2 in float64, card against CPU: the
#: loss (relative), each gradient of its max floored at `floor` of the
#: largest; decoded ids, lengths and edit distances equal
CRNN_CHECK = dict(batch=2, loss=1e-12, grad=1e-9, floor=1e-6)
#: phase 30: float64 card against CPU, each continuous output and
#: gradient of its max
MISC_F64_TOL = 1e-9
#: phase 30's widths: the CTR ops and the seqpool fusions at the PaddleRec
#: CTR-DNN's (26 sparse slots, embedding 10, a 1,000,001-row table, 13
#: dense features, batch 512; `seq` ids a slot), the recurrent fusions
#: at phase 19's db_lstm (word_dim 32, hidden 512, batch 10; `steps` a
#: sentence), the rest at their reference test cases with the batch
#: raised to 64
MISC_WIDTHS = dict(batch=64, ctr_batch=512, slots=26, emb=10,
                   table=1_000_001, dense=13, seq=8, rnn_batch=SRL_BATCH,
                   steps=32, word=SRL_WORD_DIM, hidden=SRL_HIDDEN)


def misc_op_cases(seed, w=MISC_WIDTHS):
    """Phase 30's cases, one an op type of ops.{misc,text,ctr,fused}:
    dicts of the label, the op, its {slot: numpy} inputs (float64), its
    attrs, the float slots whose gradient is checked (of the output
    `grad_out`) and, for a random op, its contract ("gauss", "uniform",
    "crop") instead of an agreement."""
    rng = np.random.RandomState(seed + 30)
    b, cb, rb, t = w["batch"], w["ctr_batch"], w["rnn_batch"], w["steps"]
    emb, d, h = w["emb"], w["word"], w["hidden"]

    def f(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, size=shape)

    def ids(hi, *shape):
        return rng.randint(0, hi, size=shape).astype(np.int64)

    def case(op, inputs, attrs=None, grad=(), contract=None, grad_out=0):
        return dict(label=op, op=op, inputs=inputs, attrs=attrs or {},
                    grad=list(grad), grad_out=grad_out, contract=contract)

    lens = rng.randint(1, 9, b).astype(np.int64)
    cases = [
        case("brelu", {"X": f(b, 4, lo=-30, hi=30)},
             {"t_min": 1.0, "t_max": 20.0}, ["X"]),
        case("soft_relu", {"X": f(b, 4)}, {"threshold": 0.8}, ["X"]),
        case("selu", {"X": f(b, 4)}, {}, ["X"]),
        case("stanh", {"X": f(b, 4)}, {}, ["X"]),
        case("maxout", {"X": f(b, 6, 3)}, {"groups": 3}, ["X"]),
        case("lrn", {"X": f(b, 6, 3, 3)},
             {"n": 3, "k": 1.0, "alpha": 1e-2, "beta": 0.75}, ["X"]),
        case("hard_shrink", {"X": f(b, 7)}, {"threshold": 0.3}, ["X"]),
        case("softshrink", {"X": f(b, 7)}, {"lambda": 0.4}, ["X"]),
        case("thresholded_relu", {"X": f(b, 7)}, {"threshold": 0.2}, ["X"]),
        case("clip_by_norm", {"X": f(b, 4, lo=1, hi=2)}, {"max_norm": 1.0},
             ["X"]),
        case("l2_normalize", {"X": f(b, 4)}, {"axis": 1}, ["X"]),
        case("cos_sim", {"X": f(b, 5), "Y": f(b, 5)}, {}, ["X", "Y"]),
        case("log_loss", {"Predicted": f(b, 1, lo=0.1, hi=0.9),
                          "Labels": (f(b, 1) > 0) * 1.0}, {}, ["Predicted"]),
        case("rank_loss", {"Label": (f(b, 1) > 0) * 1.0, "Left": f(b, 1),
                           "Right": f(b, 1)}, {}, ["Left", "Right"]),
        case("margin_rank_loss", {"Label": np.sign(f(b, 1)),
                                  "X1": f(b, 1), "X2": f(b, 1)},
             {"margin": 0.1}, ["X1", "X2"]),
        case("bpr_loss", {"X": f(b, 5), "Label": ids(5, b, 1)}, {}, ["X"]),
        case("dice_loss", {"X": f(b, 8, lo=0, hi=1),
                           "Label": (f(b, 8) > 0) * 1.0}, {}, ["X"]),
        case("npair_loss", {"Anchor": f(b, 6), "Positive": f(b, 6),
                            "Labels": ids(8, b)}, {}, ["Anchor", "Positive"]),
        case("teacher_student_sigmoid_loss",
             {"X": f(b, 1), "Label": rng.choice([-2.0, -1.0, 0.3, 1.6],
                                                (b, 1))}, {}, ["X"]),
        case("fsp", {"X": f(b, 3, 4, 4), "Y": f(b, 5, 4, 4)}, {},
             ["X", "Y"]),
        case("multiplex", {"X": [f(b, 3), f(b, 3)], "Ids": ids(2, b, 1)}),
        case("scatter_nd_add", {"X": f(b, 3), "Index": ids(b, 16, 1),
                                "Updates": f(16, 3)}, {}, ["X", "Updates"]),
        case("scatter_nd", {"Index": ids(3, 16, 2), "Updates": f(16)},
             {"shape": [3, 3]}, ["Updates"]),
        case("shard_index", {"X": ids(w["table"], cb, w["slots"])},
             {"index_num": w["table"], "nshards": 8, "shard_id": 3}),
        case("space_to_depth", {"X": f(b, 2, 4, 4)}, {"blocksize": 2},
             ["X"]),
        case("shuffle_channel", {"X": f(b, 6, 2, 2)}, {"group": 2}, ["X"]),
        case("unfold", {"X": f(b, 2, 4, 4)},
             {"kernel_sizes": [2, 2], "strides": [2, 2], "paddings": [1, 0],
              "dilations": [1, 1]}, ["X"]),
        case("crop_tensor", {"X": f(b, 5)},
             {"shape": [b // 2, 3], "offsets": [1, 1]}, ["X"]),
        case("pad_constant_like", {"X": f(b, 5), "Y": f(b // 2, 3)},
             {"pad_value": 0.5}, ["Y"]),
        case("reverse", {"X": f(b, 4)}, {"axis": [0, 1]}, ["X"]),
        case("add_position_encoding", {"X": f(b, 3, 6)},
             {"alpha": 1.0, "beta": 1.0}, ["X"]),
        case("bilinear_tensor_product",
             {"X": f(b, 4), "Y": f(b, 5), "Weight": f(2, 4, 5),
              "Bias": f(2)}, {}, ["X", "Y", "Weight"]),
        case("gather_tree", {"Ids": ids(100, 8, b, 4),
                             "Parents": ids(4, 8, b, 4)}),
        case("conv3d_transpose", {"Input": f(b, 2, 3, 3, 3),
                                  "Filter": f(2, 3, 2, 2, 2, lo=-0.5,
                                              hi=0.5)},
             {"strides": [2, 2, 2], "paddings": [1, 1, 1]},
             ["Input", "Filter"]),
        case("gaussian_random_batch_size_like", {"Input": f(b, 2)},
             {"shape": [-1, 4096], "mean": 1.5, "std": 2.0},
             contract="gauss"),
        case("uniform_random_batch_size_like", {"Input": f(b, 2)},
             {"shape": [-1, 4096], "min": -3.0, "max": 5.0},
             contract="uniform"),
        case("random_crop", {"X": np.arange(b * 9 * 11, dtype=np.float64)
                             .reshape(b, 9, 11)}, {"shape": [4, 5]},
             contract="crop"),
        case("mean_iou", {"Predictions": ids(10, b, 32),
                          "Labels": ids(10, b, 32)}, {"num_classes": 10}),
        case("edit_distance", {"Hyps": ids(6, b, 24), "Refs": ids(6, b, 24),
                               "HypsLength": rng.randint(0, 25, b),
                               "RefsLength": rng.randint(1, 25, b)},
             {"normalized": True}),
        case("ctc_greedy_decoder",
             {"Input": rng.randint(0, 3, (b, 64, 6)) * 1.0,
              "Length": rng.randint(1, 65, b)}, {"blank": 5}),
        case("has_inf", {"X": np.append(f(b * 4), np.inf)}),
        case("has_nan", {"X": np.append(f(b * 4), np.nan)}),
        case("is_empty", {"X": f(b)}),
        case("size", {"Input": f(b, 4)}),
        case("sequence_enumerate", {"X": ids(50, b, 8), "Length": lens},
             {"win_size": 3, "pad_value": 0}),
        case("sequence_scatter", {"X": f(b, 9), "Ids": ids(9, b, 4),
                                  "Updates": f(b, 4), "Length": lens % 5},
             {}, ["X", "Updates"]),
        case("sequence_reshape", {"X": f(b, 4, 3)}, {"new_dim": 6}, ["X"]),
        case("hash", {"X": ids(2 ** 31 - 1, cb, w["slots"])},
             {"mod_by": w["table"], "num_hash": 2}),
        case("unique_with_counts", {"X": ids(64, cb, w["slots"])}),
        case("unique", {"X": ids(64, cb, w["slots"])}),
        # ops.text
        case("conv_shift", {"X": f(b, 7), "Y": f(b, 3)}, {}, ["X", "Y"]),
        case("similarity_focus", {"X": f(b, 3, 4, 5)},
             {"axis": 1, "indexes": [0, 2]}),
        case("chunk_eval", {"Inference": ids(5, b, 8),
                            "Label": ids(5, b, 8), "SeqLength": lens},
             {"num_chunk_types": 2, "chunk_scheme": "IOB"}),
        case("match_matrix_tensor", {"X": f(b, 3, 4), "Y": f(b, 4, 4),
                                     "W": f(4, 2, 4),
                                     "LengthsX": rng.randint(1, 4, b),
                                     "LengthsY": rng.randint(1, 5, b)},
             {"dim_t": 2}, ["X", "Y", "W"]),
        case("var_conv_2d", {"X": f(b, 2, 5, 6), "W": f(3, 2 * 3 * 3),
                             "ROW": rng.randint(1, 6, b),
                             "COLUMN": rng.randint(1, 7, b)},
             {"InputChannel": 2, "OutputChannel": 3, "KernelH": 3,
              "KernelW": 3, "StrideH": 1, "StrideW": 2}, ["X", "W"]),
        case("tree_conv", {"NodesVector": f(b, 5, 3),
                           "EdgeSet": np.tile(np.array(
                               [[1, 2], [1, 3], [2, 4], [2, 5]]), (b, 1, 1)),
                           "Filter": f(3, 3, 2, 2)}, {"max_depth": 2},
             ["NodesVector", "Filter"]),
        case("pyramid_hash", {"X": ids(2 ** 31 - 1, b, 12),
                              "W": f(1000, 4), "Lengths": lens + 4},
             {"num_emb": 8, "rand_len": 4, "space_len": 1000,
              "pyramid_layer": 4, "drop_out_percent": 0.0,
              "is_training": 0}, ["W"]),
        # ops.ctr at the CTR-DNN's widths
        case("cvm", {"X": f(cb, 2 + emb, lo=0.2, hi=3.0),
                     "CVM": f(cb, 2, lo=0.0, hi=1.0)}, {"use_cvm": True},
             ["X"]),
        case("data_norm", {"X": f(cb, w["dense"], lo=0.5, hi=2.0),
                           "BatchSize": np.full(w["dense"], 1e4),
                           "BatchSum": f(w["dense"], lo=10, hi=30),
                           "BatchSquareSum": np.full(w["dense"], 1e4)},
             {"epsilon": 1e-4}, ["X", "BatchSize", "BatchSum",
                                 "BatchSquareSum"]),
        case("filter_by_instag", {"Ins": f(cb, w["slots"] * emb),
                                  "Ins_tag": ids(20, cb, 4),
                                  "Filter_tag": np.arange(1, 9)},
             {}, ["Ins"]),
        case("positive_negative_pair",
             {"Score": np.round(f(cb, 1), 2), "Label": ids(3, cb, 1) * 1.0,
              "QueryID": ids(32, cb, 1)}, {"column": 0}),
        # ops.fused: the CTR family at its widths, the recurrent ones at
        # db_lstm's
        case("fc", {"Input": f(cb, w["slots"] * emb), "W": f(w["slots"]
                                                              * emb, 400),
                    "Bias": f(400)}, {"activation": "relu"},
             ["Input", "W"]),
        case("fused_elemwise_activation", {"X": f(b, 4), "Y": f(b, 4)},
             {"functor_list": ["relu", "elementwise_add"]}, ["X", "Y"]),
        case("fused_embedding_seq_pool",
             {"Ids": ids(w["table"], cb, w["seq"]),
              "W": f(w["table"], emb), "Lengths": rng.randint(
                  1, w["seq"] + 1, cb)},
             {"combiner": "sum", "padding_idx": 0}, ["W"]),
        case("fusion_seqpool_concat",
             {"X": [f(cb, w["seq"], emb) for _ in range(w["slots"])]},
             {"pooltype": "SUM"}),
        case("fusion_seqpool_cvm_concat",
             {"X": [f(cb, w["seq"], 2 + emb, lo=0.0, hi=1.0)
                    for _ in range(w["slots"])],
              "CVM": f(cb, 2, lo=0.0, hi=1.0)},
             {"pooltype": "SUM", "use_cvm": True}),
        case("fusion_squared_mat_sub", {"X": f(cb, w["slots"] * emb),
                                        "Y": f(w["slots"] * emb, emb)},
             {"scalar": 0.5}, ["X", "Y"], grad_out=3),
        case("fusion_repeated_fc_relu",
             {"X": f(cb, w["slots"] * emb),
              "W": [f(w["slots"] * emb, 400) * 0.1, f(400, 400) * 0.1,
                    f(400, 400) * 0.1],
              "Bias": [f(400), f(400), f(400)]}, {}, ["X"]),
        case("fusion_transpose_flatten_concat",
             {"X": [f(b, 3, 4, 5), f(b, 6, 4, 5)]},
             {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
              "concat_axis": 1}),
        case("fused_fc_elementwise_layernorm",
             {"X": f(b, 6), "W": f(6, 8), "Y": f(b, 8), "Scale": f(8),
              "Bias1": f(8)}, {"epsilon": 1e-5}, ["X", "W", "Y"]),
        case("fusion_lstm", {"X": f(rb, t, d), "WeightX": f(d, 4 * h) * 0.1,
                             "WeightH": f(h, 4 * h) * 0.1,
                             "Bias": f(1, 4 * h) * 0.1},
             {"use_peepholes": False}, ["X", "WeightX", "WeightH"]),
        case("fusion_gru", {"X": f(rb, t, d), "WeightX": f(d, 3 * h) * 0.1,
                            "WeightH": f(h, 3 * h) * 0.1,
                            "Bias": f(1, 3 * h) * 0.1}, {},
             ["X", "WeightX", "WeightH"]),
        case("fused_embedding_fc_lstm",
             {"Ids": ids(1000, rb, t), "Embeddings": f(1000, 4 * h) * 0.2,
              "WeightH": f(h, 4 * h) * 0.1, "Bias": f(1, 4 * h) * 0.1},
             {"use_peepholes": False}, ["Embeddings", "WeightH"]),
        case("fusion_seqconv_eltadd_relu",
             {"X": f(rb, t, d), "Filter": f(3 * d, h) * 0.3,
              "Bias": f(1, h) * 0.3, "Length": rng.randint(1, t + 1, rb)},
             {"contextLength": 3}, ["X", "Filter"]),
        case("attention_lstm",
             {"X": f(rb, t, d), "C0": f(rb, h) * 0.1,
              "AttentionWeight": f(d + h, 1) * 0.1,
              "LSTMWeight": f(d + h, 4 * h) * 0.05, "LSTMBias": f(4 * h)},
             {}, ["X", "LSTMWeight"]),
    ]
    return cases


def misc_args(torch, case, dev, dtype):
    """The case's inputs as the op's positional arguments on `dev`, the
    float ones in `dtype`; -> (args, {slot: tensor} of the gradient
    slots, made leaves)."""
    from paddle_tpu_torch.core.registry import get_op

    def tensor(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return (t.to(dtype) if t.is_floating_point() else t).to(dev)

    args, leaves = [], {}
    for slot in get_op(case["op"]).in_slots:
        v = case["inputs"].get(slot.name)
        if v is None:
            args.append([] if slot.variadic else None)
            continue
        t = [tensor(a) for a in v] if slot.variadic else tensor(v)
        if slot.name in case["grad"]:
            t.requires_grad_(True)
            leaves[slot.name] = t
        args.append(t)
    return args, leaves


def misc_run(torch, case, dev, dtype):
    """The case's outputs (flattened) and, with gradient slots, their
    gradients of sum(output `grad_out` x cotangent), on the CPU."""
    from paddle_tpu_torch.core.registry import OpContext, get_op
    args, leaves = misc_args(torch, case, dev, dtype)
    with torch.enable_grad():
        outs = get_op(case["op"]).fn(OpContext(dict(case["attrs"]), 0, True,
                                               0, dev), *args)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        flat = [o for out in outs
                for o in (out if isinstance(out, list) else [out])]
        grads = []
        if leaves:
            first = flat[case["grad_out"]]
            cot = torch.from_numpy(np.random.RandomState(0).uniform(
                0.5, 1.5, tuple(first.shape))).to(dev, first.dtype)
            grads = list(torch.autograd.grad((first * cot).sum(),
                                             list(leaves.values())))
    return [o.detach().to("cpu") for o in flat + grads]


def misc_contract(torch, case, out):
    """A random op's contract on its output (float64): shape, range,
    moments within 5 sigma, or a crop that is a window of the input."""
    kind, x = case["contract"], out[0].double().numpy()
    if kind == "crop":
        src = case["inputs"]["X"]
        h, w = case["attrs"]["shape"]
        r0, c0 = divmod(int(x[0, 0, 0]), src.shape[2])
        return bool(np.array_equal(x, src[:, r0:r0 + h, c0:c0 + w]))
    a = case["attrs"]
    if kind == "gauss":
        mean, std = a["mean"], a["std"]
        ok = True
    else:
        ok = bool(x.min() >= a["min"] and x.max() < a["max"])
        mean, std = (a["min"] + a["max"]) / 2, (a["max"] - a["min"]) / 12 ** .5
    n = x.size
    return ok and abs(x.mean() - mean) < 5 * std / n ** .5 and \
        abs(x.var() - std ** 2) < 5 * std ** 2 * (2.0 / n) ** .5


def misc_ops(torch, seed, tag, dev="cuda"):
    """Phase 30. Every op type of ops.{misc,text,ctr,fused} once on its
    case (`misc_op_cases`), card against the host CPU in float64: the
    continuous outputs and the gradients within MISC_F64_TOL of their
    max, the integer outputs equal, a random op by its contract on the
    card; each op's f32 ms (median of 10, L2-cold) and launches a call
    (`host_launches`) printed."""
    from paddle_tpu_torch.core.registry import OpContext, get_op
    out = {}
    for case in misc_op_cases(seed):
        label = case["label"]
        t0 = time.perf_counter()
        got = misc_run(torch, case, dev, torch.float64)
        if case["contract"] is not None:
            ok = misc_contract(torch, case, got)
            err, equal = 0.0, ok
        else:
            want = misc_run(torch, case, "cpu", torch.float64)
            err, equal, _ = det_errors(got, want, {
                i: None for i, w in enumerate(want)
                if not w.is_floating_point()})
            ok = err <= MISC_F64_TOL and equal
        argsets = [misc_args(torch, case, dev, torch.float32)[0]
                   for _ in range(2)]

        def call(*args, _c=case):
            with torch.no_grad():
                return get_op(_c["op"]).fn(
                    OpContext(dict(_c["attrs"]), seed, True, 0, dev), *args)

        row = dict(f64_err=err, discrete_equal=equal,
                   contract=case["contract"],
                   ms=timed_ms(torch, call, argsets, iters=10),
                   launches=host_launches(torch, call, argsets))
        del argsets
        row["case_s"] = time.perf_counter() - t0
        out[label] = row
        timing = (f"; f32 {row['ms']:.4f} ms (median of 10, L2-cold), "
                  f"{row['launches']:g} launches a call")
        check = (f"contract {'held' if ok else 'BROKEN'} on the card"
                 if case["contract"] else
                 f"float64 card vs CPU {err:.3g} of max, integer outputs "
                 f"{'equal' if equal else 'DIFFER'}")
        print(f"phase 30 {label}: {check}{timing} {tag}")
        assert ok, (label, row)
    torch.cuda.empty_cache()
    return out


def crnn_programs(cfg, batch, seed):
    """crnn_ctc_programs with fresh unique names, so every build names
    its parameters alike."""
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.models import crnn_ctc
    ir.reset_unique_names()
    return crnn_ctc.crnn_ctc_programs(cfg, batch, seed=seed)


def crnn_feed(torch, cfg, batch, seed, dev):
    """A seeded synthetic batch (models.crnn_ctc.synthetic_batch) as
    tensors on `dev`, by feed name."""
    from paddle_tpu_torch.models import crnn_ctc
    return {k: torch.from_numpy(v).to(dev) for k, v in
            crnn_ctc.synthetic_batch(cfg, batch, seed).items()}


def crnn_step_check(torch, cfg, state, seed, tag, dev="cuda"):
    """Phase 29(c). One training step at batch 2 from the same weights,
    float64 (`fully_widened`), on the card and on the host CPU: the loss,
    the gradients (CRNN_CHECK), and the decoded ids, their lengths and
    the edit distances equal."""
    chk = CRNN_CHECK
    main, _, _, names = crnn_programs(cfg, chk["batch"], seed)
    main = fully_widened(torch, main)
    params = [v.name for v in main.all_parameters() if v.desc.trainable]
    feed = crnn_feed(torch, cfg, chk["batch"], seed + 290, "cpu")
    feed["pixel"] = feed["pixel"].double()
    fetch = [names[k] for k in ("loss", "decoded", "decoded_length",
                                "distance")] + [p + "@GRAD" for p in params]
    state64 = widen_state({n: a for n, a in state.items()})
    res = {}
    for where in (dev, "cpu"):
        outs, _ = one_step(torch, main, state64,
                           {k: v.to(where) for k, v in feed.items()}, fetch,
                           where)
        res[where] = outs
    card, cpu = res[dev], res["cpu"]
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    gc = {p: torch.from_numpy(np.asarray(g)) for p, g in zip(params,
                                                              card[4:])}
    gh = {p: torch.from_numpy(np.asarray(g)) for p, g in zip(params,
                                                              cpu[4:])}
    gerr, worst = grad_err(gc, gh, chk["floor"])
    equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(card[1:4], cpu[1:4]))
    print(f"phase 29(c) crnn-ctc step, batch {chk['batch']} x "
          f"{'x'.join(map(str, cfg.image_shape))}, float64 card vs CPU: loss "
          f"{float(card[0]):.10f} vs {float(cpu[0]):.10f} (rel "
          f"{loss_err:.3g}, gate {chk['loss']}), gradients {gerr:.3g} of "
          f"max (worst {worst}, gate {chk['grad']}), decoded ids, lengths "
          f"and edit distances {'equal' if equal else 'DIFFER'} {tag}")
    assert loss_err <= chk["loss"] and gerr <= chk["grad"] and equal, (
        loss_err, gerr, worst, equal)
    return dict(loss_rel_err=loss_err, grad_err=gerr, worst=worst,
                decode_equal=equal)


def crnn_training(torch, seed, tag, dev="cuda"):
    """Phase 29. crnn_ctc_model.py at its widths (1 x 48 x 512 images,
    95 + 1 classes, GRU 200) through the static Executor on the card,
    f32, TF32 off: (c) first, the float64 step against the CPU; then
    CRNN_WARMUP + CRNN_TIMED Momentum steps at batch 32 on one seeded
    batch (labels of 1-24), losses finite and falling; step wall ms,
    images/s and a profiled step; (b) the decode — the test program
    through Executor.run, fetching ctc_greedy_decoder's ids and lengths
    and edit_distance's distances — with its host reads
    (torch.cuda.set_sync_debug_mode) and p50 ms over CRNN_DECODES."""
    import warnings

    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import crnn_ctc
    cfg = crnn_ctc.CRNNConfig()
    main, test, startup, names = crnn_programs(cfg, CRNN_BATCH, seed)
    scope = Scope()
    exe = Executor(dev)
    exe.run(startup, scope=scope)
    state = {v.name: scope.find_np(v.name) for v in main.list_vars()
             if v.persistable and scope.has(v.name)}
    n_params = sum(int(np.prod(v.shape)) for v in main.all_parameters())
    out = {"params": n_params,
           "check": crnn_step_check(torch, cfg, state, seed, tag, dev)}
    feed = crnn_feed(torch, cfg, CRNN_BATCH, seed + 29, dev)
    loss = names["loss"]

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0]

    losses = [step() for _ in range(CRNN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(CRNN_TIMED)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / CRNN_TIMED * 1e3
    losses = [float(v) for v in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    def train(k):
        for _ in range(k):
            step()
        torch.cuda.synchronize()

    brk = profile_device(torch, train, 2, top=8)
    print(f"phase 29 crnn-ctc {n_params} parameters, batch {CRNN_BATCH} x "
          f"{'x'.join(map(str, cfg.image_shape))}: losses "
          f"{', '.join(f'{v:.3f}' for v in losses)}; step {step_ms:.2f} ms "
          f"wall ({CRNN_BATCH / step_ms * 1e3:.1f} images/s) {tag}")
    print_profile(f"crnn-ctc train step, batch {CRNN_BATCH}", brk, tag)
    print(f"  launches a step: {brk['launches_per_step']:.0f} {tag}")
    # (b) the served program: the test clone through the Executor,
    # fetching the decode and its edit distance, no host read
    fetch = [names[k] for k in ("distance", "decoded", "decoded_length")]

    def decode():
        return exe.run(test, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    decode()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dist, ids, n = decode()
    torch.cuda.set_sync_debug_mode(0)
    host_reads = sum("synchroniz" in str(w.message) for w in caught)
    times = []
    for _ in range(CRNN_DECODES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    dist, ids, n = (t.cpu().numpy() for t in (dist, ids, n))
    assert dist.shape == (CRNN_BATCH, 1) and np.isfinite(dist).all()
    assert ids.shape == (CRNN_BATCH, cfg.steps) and n.shape == (
        CRNN_BATCH,) and ((n >= 0) & (n <= cfg.steps)).all()
    assert host_reads == 0, f"the decode read the device {host_reads} times"

    def decodes(k):
        for _ in range(k):
            decode()
        torch.cuda.synchronize()

    dbrk = profile_device(torch, decodes, 3, top=4)
    out.update(losses=losses, step_ms=step_ms,
               images_per_s=CRNN_BATCH / step_ms * 1e3, breakdown=brk,
               decode_p50_ms=p50, decode_host_reads=host_reads,
               decode_launches=dbrk["launches_per_step"],
               mean_edit_distance=float(dist.mean()))
    print(f"phase 29(b) decode (the test program through Executor.run: "
          f"forward, ctc_greedy_decoder, edit_distance; batch {CRNN_BATCH} "
          f"x {cfg.steps} steps): p50 {p50:.3f} ms over {CRNN_DECODES}, "
          f"{dbrk['launches_per_step']:.0f} launches, host reads "
          f"{host_reads}; mean normalized edit distance "
          f"{float(dist.mean()):.4f} {tag}")
    del scope
    torch.cuda.empty_cache()
    return out


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
    torch.cuda.empty_cache()

    # 14. ResNet-50 static training, the static-training slice's main path
    train, main_prog, scope, batch, loss = resnet_static_training(
        torch, args.seed, tag)
    results["resnet50_train"] = train

    # 15. where a training step's time goes
    results["resnet50_train_breakdown"] = training_step_profile(
        torch, main_prog, scope, batch, loss, tag)
    del scope
    torch.cuda.empty_cache()

    # 16. VGG-16-BN static training, the Fluid book's image
    # classification at its published width
    vgg, main_prog, scope, batch, loss = vgg_static_training(
        torch, args.seed, tag)
    results["vgg16_bn_train"] = vgg

    # 17. where a VGG step's time goes
    results["vgg16_bn_train_breakdown"] = training_step_profile(
        torch, main_prog, scope, batch, loss, tag,
        label=f"vgg-16-bn train step, batch {VGG_BATCH}")
    del scope
    torch.cuda.empty_cache()

    # 18. the book's word2vec: float64 card vs CPU, a scheduled SGD run
    results["word2vec"] = word2vec_training(torch, args.seed, tag)

    # 19. the book's label_semantic_roles (db_lstm) at its width
    t_seq = time.perf_counter()
    results["srl"], srl_main, srl_scope, srl_feed, srl_loss = srl_training(
        torch, args.seed, tag)

    # 20. machine_translation at the book's widths, its While decode
    (results["mt"], mt_main, mt_scope, mt_feed, mt_loss, dec, dfeed,
     dfetch) = mt_training(torch, args.seed, tag)

    # 21. where the sequence models' time goes
    results["srl_breakdown"] = training_step_profile(
        torch, srl_main, srl_scope, srl_feed, srl_loss, tag,
        label=f"srl db_lstm train step, batch {SRL_BATCH}")
    results["mt_breakdown"] = training_step_profile(
        torch, mt_main, mt_scope, mt_feed, mt_loss, tag,
        label=f"mt train step, batch {MT_BATCH}")
    results["mt_decode_breakdown"] = decode_profile(
        torch, dec, dfeed, dfetch, mt_scope, tag)
    results["sequence_phases_s"] = time.perf_counter() - t_seq
    print(f"phases 19-21: {results['sequence_phases_s']:.1f} s {tag}")
    del srl_scope, mt_scope
    torch.cuda.empty_cache()

    # 22. the flash kernels at the Transformer's shapes
    t_dy = time.perf_counter()
    results["transformer_flash"] = transformer_flash(torch, tfa, args.seed,
                                                     tag)

    # 23. Transformer-big training through the flash kernels, the dygraph
    # slice's main path (launch counts reset just before, read after)
    tfa.reset_launch_counts()
    results["transformer_big"], mt_model, mt_launches = mt_big_training(
        torch, tfa, args.seed, tag)

    # 24. its greedy and beam decodes against the plain attention's
    results["transformer_decode"], dec_launches = mt_big_decode(
        torch, tfa, mt_model, args.seed, tag)
    del mt_model
    torch.cuda.empty_cache()
    dygraph = {k: mt_launches.get(k, 0) + dec_launches.get(k, 0)
               for k in FLASH_KERNELS}
    assert all(dygraph[k] > 0 for k in FLASH_KERNELS), dygraph
    for k in FLASH_KERNELS:
        kernels[k]["launches_by_path"] = {
            "bert": kernels[k]["launches"], "transformer": dygraph[k]}
        kernels[k]["launches"] += dygraph[k]
    results["transformer_launches"] = dygraph
    print(f"phases 23-24 flash launches (the kernels line's "
          f"launches_by_path): {dygraph} {tag}")

    # 25. the eager vision and CTR zoo at full width
    results["eager_zoo"] = eager_zoo(torch, args.seed, tag)
    results["dygraph_phases_s"] = time.perf_counter() - t_dy
    print(f"phases 22-25: {results['dygraph_phases_s']:.1f} s {tag}")

    # 26-28. the detection ops and YOLOv3, which launch none of the
    # kernels: every count stays 0
    t_det = time.perf_counter()
    for mod in (da, tfa, k8):
        mod.reset_launch_counts()
    results["detection_ops"] = detection_ops(torch, args.seed, tag)
    results["yolov3_train"], yolo = yolo_training(torch, args.seed, tag)
    results["yolov3_predict"] = yolo_predict(torch, yolo, args.seed, tag)
    del yolo
    torch.cuda.empty_cache()
    counts = {**da.launch_counts, **tfa.launch_counts, **k8.launch_counts}
    assert not any(counts.values()), counts
    results["detection_phases_s"] = time.perf_counter() - t_det
    print(f"phases 26-28: {results['detection_phases_s']:.1f} s (no kernel "
          f"of the kernels line launched) {tag}")

    # 29-30. the CRNN-CTC recogniser and the rest of the op library,
    # which launch none of the kernels: every count stays 0
    t_crnn = time.perf_counter()
    for mod in (da, tfa, k8):
        mod.reset_launch_counts()
    results["crnn_ctc"] = crnn_training(torch, args.seed, tag)
    results["crnn_phase_s"] = time.perf_counter() - t_crnn
    t_misc = time.perf_counter()
    results["misc_ops"] = misc_ops(torch, args.seed, tag)
    results["misc_phase_s"] = time.perf_counter() - t_misc
    counts = {**da.launch_counts, **tfa.launch_counts, **k8.launch_counts}
    assert not any(counts.values()), counts
    print(f"phase 29: {results['crnn_phase_s']:.1f} s, phase 30: "
          f"{results['misc_phase_s']:.1f} s (no kernel of the kernels line "
          f"launched) {tag}")

    results["total_s"] = time.perf_counter() - t_start
    print(f"total: {results['total_s']:.1f} s {tag}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = []
    for name in (("decode_attention", "paged_decode_attention",
                  "paged_prefill_attention",
                  "quantized_paged_decode_attention",
                  "quantized_paged_prefill_attention")
                 + FLASH_KERNELS + ("quantized_matmul",
                                    "quantized_matmul_weight_only")):
        rows.append({k: kernels[name][k] for k in keys})
        if "launches_by_path" in kernels[name]:
            rows[-1]["launches_by_path"] = kernels[name]["launches_by_path"]
    line = {"kernels": rows}
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
