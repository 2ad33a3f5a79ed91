#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]
    python3 chip_smoke.py --latency [ROOT]
    python3 chip_smoke.py --decode-rows [ROOT]
    python3 chip_smoke.py --flash-sweep [ROOT]
    python3 chip_smoke.py --capture
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --fleet
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --ps
    python3 chip_smoke.py --slim

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
    greedy ids equal to the same decode through the plain attention on
    the card; beam ids too, where a row that differs is excused only by
    measured ties (`beam_near_ties`: the flash model teacher forced on
    the plain run's beams may choose other candidates only where their
    plain scores lie within NEAR_TIE of the plain run's own choices at
    the same slots, each such step printed with its gap), and the
    plain model with its attention logits scaled by 1.01 (or, where that
    moves no beam past a tie, the next of BEAM_CONTROL_SCALES that does),
    the rule's control, must be refused; the loops' host reads and the
    host's wait in them.
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

31. (Run right after phase 5, while phase 3's model is alive.) The
    captured rungs against eager ones. Every engine rung and every
    nn.TrainStep signature is one captured CUDA graph
    (`observability.profile.profiled_graph`), so phases 3-4c and 23 run
    captured; their launch counts hold because each graph adds the
    launches its capture saw on every replay. Phase 31 turns the
    compile cache on in a temporary directory and holds the captured
    path against `disable_capture()`: (a) GPT-2-small with phase 3's 16
    greedy requests on 8 slots through DecodeEngine and through
    PagedDecodeEngine (spec_k 4, a draft distilled from the eager
    contiguous run) with f32 and int8 pools, each engine once eager and
    once captured: the tokens equal (near-tie rule with phase 3's
    gaps), compile_count() equal to the rung count after warmup() and
    unchanged after the requests (= stats()["compiled_signatures"]),
    and every rung's logits on the same live state within
    CAPTURE_LOGIT_TOL of max |eager|, each rung's capture ms, pool
    bytes, GFLOP and launches a replay printed; (b) a second contiguous
    engine warm-starts from the first one's manifest: every rung a hit,
    compile_count() 0 after warmup() and after the requests, tokens
    equal; (c) the decode tick at 8 slots, f32 contiguous and int8
    paged, eager and captured: wall ms, device ms, idle share, kernels
    and host launch calls a tick; (d) Transformer-big TrainStep at the
    128 bucket (B=64), two captured steps against two eager ones from
    the same weights: losses within CAPTURE_LOSS_TOL, each update within
    CAPTURE_UPDATE_TOL of its max floored at CAPTURE_UPDATE_FLOOR of the
    largest, an eager-vs-eager control printed beside; 18 + 18 flash
    launches a step. Then profile_snapshot()'s ledger size and a Chrome
    trace (CAPTURE_TRACE, beside --out's file or in the temporary
    directory). `--capture` builds the kernels, makes phase
    3's references and runs phases 31 and 32 alone, then prints one
    CAPTURE line and the device line.

32. The Executor's programs, captured against `disable_capture()`
    from the same state (on the card every `Executor.run` signature
    replays one CUDA graph per segment of its capture plan, so phases
    12-21 and 27-29 run captured too): ResNet-50 static training at
    batch 32 x 224^2 (phase 14's program), VGG-16-BN with dropout at
    batch 128 (phase 16's) and CRNN-CTC at batch 32 (phase 29's): from
    the state after one captured step, two replayed steps against two
    eager ones, losses within CAPTURE_LOSS_TOL, each update within
    CAPTURE_UPDATE_TOL of its max floored at CAPTURE_UPDATE_FLOOR of the
    largest, an eager-vs-eager control printed, VGG's dropout masks
    bit-equal; CRNN-CTC's test program: decoded ids, lengths and edit
    distances equal; the f32 and int8 ResNet-50 Predictors (phase 12's)
    at batch 1, 8 and 32, EXEC_REQUESTS requests each: logits within
    CAPTURE_LOGIT_TOL of max |eager|, no ledger record after the first
    request of a batch size, K8 launched once per int8 request under
    replay and the replayed fc = plain K8 + bias within 1 ulp; the MT
    While decode (phase 20's program): ids equal, condition reads a
    run unchanged. For each program: step or request wall against
    device ms, idle share, host launch calls against device launches,
    segments, graphs, capture ms and pool bytes.

33. The serving front end (`serving.ServingGateway` over `ModelRegistry`
    over `InferenceServer`): phase 12's ResNet-50 saved, loaded as an f32
    and an int8 (PTQ) Predictor; f32 deployed as resnet50:v1 behind the
    gateway on 127.0.0.1 with SERVE_REPLICAS replicas and the bucket
    ladder SERVE_BUCKETS, captured in warmup (its time printed); 8 PTGW
    clients x 32 one-row requests, every response within LOGITS_TOL of
    the same row through the f32 Predictor alone, no capture during the
    traffic, wire p50 / p99, batches per bucket, occupancy and the serial
    loop's p50 printed; a hot swap to resnet50:v2 = int8 (quality gate
    against the f32 Predictor, INT8_FIDELITY_GATE) under the same
    traffic, which goes on past the cutover: no request fails, both
    versions answer, rows within their version's tolerance
    (SERVE_INT8_ROW_TOL for int8), the pause at the capture gate printed;
    K8's launches over an int8 burst equal its batches; a deploy with a
    1 MiB budget refused at stage "verify" while v2 serves; a second
    server over a fresh f32 Predictor restores the ladder from the
    compile cache's manifest (loaded = captured = the ladder's length, no
    capture paid, the first request captures nothing); the planner's
    capture-peak estimates against the measured capture peaks per bucket
    (printed; a leg outside 0.25 fails nothing); /healthz and /slo. Then
    a GenerationServer at GPT-2-small widths behind the gateway, int8
    pools (K7) then f32 pools (K6), spec_k 0: SERVE_GEN_REQUESTS of phase
    3's prompts in process, then 4 concurrent PTGW streams and 1 chunked
    HTTP stream, tokens against single-request references under the
    near-tie rule, the chunk route once per layer on every admission and
    the decode route once per layer on every tick over the wire window.
    `--serving` builds the kernels and runs phase 33 alone, then prints
    one SERVING line and the device line.

34. The fleet (`paddle_tpu_torch.fleet`): an active and a standby
    router, each a `RouterProcess` child (the standby's `StandbyMonitor`
    watching the active), and backend processes spawned by a
    `FleetManager` (this process keeps a `FleetDirectory` with a
    `DirectoryStore`, the manager and a `FleetAutoscaler`), sharing one
    compile-cache directory. Each backend serves GPT-2-small generation
    (phase 3's widths, seed-0 weights) on int8 paged pools (K7), spec_k 0,
    8 slots, and a saved fc stack (FLEET_MLP_*: a flat `x` of 784, four fc
    + relu of 1024, softmax 10; the ladder FLEET_BUCKETS). (a) b1 starts
    with the routers, b2 after it: spawn-to-READY seconds and their
    stages, captures paid; b2 restores both ladders from b1's manifests
    (loaded = captured = requested, the fc ladder's 4). (b) PTGW clients
    with endpoints = the pair: one-row infer requests throughout (each
    row within LOGITS_TOL of the serial `Predictor.run`), FLEET_STREAMS
    concurrent streams of FLEET_TOKENS, each equal to its single-request
    int8 reference (`paged_greedy`; near-tie rule); a session's second
    stream lands on its ring backend. (c) b1 is SIGKILLed at the third
    token of a FLEET_KILL_TOKENS stream: the router resumes it on b2 with
    the journal (K7's prefill route at the prompt plus the journal), the
    stream equals the reference, gapless and exactly once, 0 infer
    requests fail, the active's directory walks b1 through SUSPECT to
    LOST; kill-to-resume-dispatch and kill-to-first-resumed-token ms.
    (d) The active router's wire-latency SLO (threshold
    FLEET_SLO_THRESHOLD_S) pages under a burst of streams; its page
    alerts, relayed from GET /slo, make the autoscaler spawn b3, which
    warm-starts and joins LIVE. (e) The active router is SIGKILLed with
    FLEET_STREAMS streams mid-decode: the standby promotes to epoch 2
    (takeover ms), the backends stay LIVE on it, every stream resumes
    from its client's journal and equals its reference, 0 infer requests
    fail, and the promoted router's page alerts spawn nothing (the
    cooldown). (f) b2 and b3 drain: their FLEET-DRAIN documents carry no
    capture paid during traffic, no jax, and K7's decode and prefill
    launches (> 0; the kernels line's `launches_by_path` "fleet").
35. Fault-tolerant training: phase 14's ResNet-50 program at batch 32 x
    224^2 under deterministic cuDNN, FT_STEPS steps of
    `resilient_train_loop` checkpointing every FT_SAVE_EVERY: (a)
    uninterrupted in this process, while (b) a `Supervisor` runs the
    same training as a worker process (`chip_smoke.py --ft-worker`)
    whose environment arms `train.step:FT_CRASH_AT:crash`: the first
    incarnation dies right after the step-8 snapshot, the supervisor
    restarts it once, it resumes from step 8, and its final parameters
    and losses are bit-equal to (a)'s. (c) The supervision report:
    exit codes [17, 0], one restart, the incarnations' flight-dump
    paths, the restart-to-first-step seconds and their stages. No kernel
    of the kernels line launches in (a) or in the worker. `--fleet`
    builds the kernels and runs phases 34 and 35 alone, then prints one
    FLEET line and the device line.
36-38. Parallelism over torch.distributed: one pool of RANK_WORLD = 4
    rank processes (`chip_smoke.py --rank-worker`, started together) in
    one gloo group on the card; each loads the kernel library phase 1
    built and reports that it holds no jax. First a probe that gloo
    takes CUDA tensors for every collective ops/collective.py hands it
    unstaged (it stages only send / recv, through pinned host buffers,
    and counts them).
    36 (`par_data_parallel`): ResNet-50 over CompiledProgram dp=2, the
    same step at world size 1 over NCCL inside a captured graph, and
    the tp fc programs over tp=4. 37 (`par_sequence_expert`): the f32
    flash pair against attention_reference at a ring chunk's shapes
    (with the lse cotangent) and Ulysses' (`par_flash_cases`), the
    GPT-2-small-wide causal LM at T=8192 over sp=4 under ring_flash and
    ulysses_flash (K1-K4 on every rank), switch_moe over ep=4. 38
    (`par_pipeline`): BERT-base's encoder over pp=4 under 1f1b and
    interleaved (v=3). Every check is against a single-process run on
    the card from the same numpy-seeded weights (PAR_TOL). `--parallel`
    builds the kernels and runs phases 36-38 alone, then prints one
    PARALLEL line and the device line.
39. The parameter server, the launcher and dataset training, with DeepFM
    at BASELINE config 5 (26 slots x 10000 ids, embed 16, 13 dense, MLP
    400-400-400, f32, batch PS_BATCH = 1024 a trainer): the port's native
    library built with g++, PS_RECORDS MultiSlot records written from
    --seed and read through `io.fluid_dataset.InMemoryDataset` (global
    shuffle, trainer shards). (a) One trainer pulls the batch's rows,
    computes DeepFM's logit from them with dense_w and the MLP on the
    card and pushes the row gradients synchronously to a fresh port
    Server, PS_SYNC_STEPS steps, against the same loop on the CPU and a
    second server: losses and the touched rows (PS_TOL). (b) A pserver
    process (TRAINING_ROLE=PSERVER, fleet.run_server) and two trainers
    started by `python -m paddle_tpu_torch.distributed.launch` on the
    card, all started together: sparse pushes through an
    AsyncCommunicator, the dense part through a GeoCommunicator,
    PS_FLEET_STEPS steps each; each trainer's loss falls, both tables
    hold rows, the dense table moved, nothing undelivered, every process
    exits 0. (c) The launcher's two ranks train the static CTR program
    through fleet.distributed_optimizer and CompiledProgram's data
    parallelism over the gloo group fleet.init starts: each rank's loss
    within 1e-5 of one process's. (d) Executor.train_from_dataset and
    AsyncExecutor.run of that program over the files, bit-equal to
    Executor.run on the same batches. No kernel of the kernels line
    launches (the flash, K5-K8 lines record 0 under "ps"). `--ps` runs
    phase 39 alone (no kernel build), then prints one PS line and the
    device line.
40. The slim pipeline on ResNet-50 at its published width (224 x 224,
    1000 classes, weights from --seed): (a) `slim.Pruner("channel")`
    zeroes half the output channels of each bottleneck's 3 x 3 conv
    (shapes kept), `sparsity` and `sensitivity` printed; (b) the unpruned
    network as a frozen teacher (`distill.merge`), the student's cross
    entropy plus T^2 x a soft-label term at T = 4, phase 14's Momentum +
    L2Decay: one step card against CPU at phase 14's gates, then 8 steps
    at batch 32 fed by `io.DataLoader` over `xmap_readers`, masks
    re-applied; the teacher bit-equal, pruned channels 0, the loss
    falling; the student saved to `mem://` through io.fs. (c) Loaded
    back, PTQ-calibrated, planned by `analysis.plan_quantization` and
    frozen by `quantize_program(plan=...)`: phase 12's op counts, the
    plan's int8 bytes equal to the Predictor's, its capture price within
    25% of each batch size's measured capture peak, K8 on every request at
    batch 1, 8 and 32, the served fc = plain K8 + bias within 1 ulp,
    int8 vs f32 under phase 12's gate; a planted K = 200000 `mul` is
    vetoed and stays f32 (within 1e-5 of float64), and its unplanned
    quantization's error is printed. (d) The lock checker armed
    (PT_FLAGS_concurrency_check) before the gateway is built: the
    planned int8 model served, then hot-swapped to the f32 student
    under 4 PTGW clients; rows equal the serial runs, no capture during
    plain traffic, no lock-order cycle and no guarded-by violation, GET
    /profile's "concurrency" section; a planted A -> B / B -> A pair
    must give exactly one cycle. (e) `slim.NASSearcher` with an
    `SAController` over the four stages' block counts, 6 candidates
    each trained 2 steps at batch 8, none over `max_flops` (`flops_of`
    of the full network). K8's launches in (c) and (d) are its "slim"
    path. `--slim` builds the kernels and runs phase 40 alone, then
    prints one SLIM line and the device line.
41. Deployment artifacts. (a) ResNet-50 at phase 12's width frozen to
    int8 (PTQ at load), the frozen program saved and loaded back, then
    `inference.export_aot_bundle` at feed (8, 3, 224, 224), one rung:
    `torch.export` (the graph names K8, a registered op) and an
    AOTInductor package; the bundle loads its native tier (stamp
    matching), the rung's exported tier loads on its own; 6 requests
    through each: exported rows bit-equal to the reloaded int8
    Predictor's, native within SERVE_INT8_ROW_TOL of max, K8 once a
    request on each tier; export and compile seconds and each tier's p50
    printed. (b) The f32 ResNet-50 training program, 2 captured steps,
    `io.save_checkpoint(async_save=True)` while 2 more replay, then
    `io.load_checkpoint` and the 2 again: losses bit-equal, the saved
    tensors the state at the save. (c) `pt_aoti_run` (built with g++
    beside phase 1) in a child on (a)'s rung: outputs equal to the
    native tier's, its JSON line ok with K8 launched. (d) The flash
    wrappers' widened shapes against the plain version: D = 80 bf16 and
    f32, float16, an unaligned bf16 view, B * N = 67200 with dropout
    (chunked), T = 65600 forward and backward in f32 and bf16 (one of
    each with dropout and a key bias). K8's launches of the two tiers
    and the child are its "deploy" path. In the whole script (a)'s
    export child starts before phase 26 and each phase that starts
    while it runs says so (their timings are taken beside its compile);
    `--deploy-child-late` starts it at phase 41 instead, a baseline for
    those timings. `--deploy` builds the kernels and runs phase 41
    alone, then prints one DEPLOY line and the device line.

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
lines those of its three serving runs (phases 4a and 4b) together; phase
33's gateway windows add to K6's, K7's and K8's lines, and their
`launches_by_path` keeps them apart ("in_process" or "predictor", and
"gateway"); phase 34's backend processes add K7's launches under
"fleet" (each backend zeroes its counts after its warm-up and reports
them in its drain document); phases 37-38's ranks add the flash lines'
launches under "parallel" (each rank zeroes its counts before a step
and reports them after it); phase 40 adds K8's int8 line's launches
under "slim", phase 41 under "deploy".

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
import atexit
import contextlib
import json
import os
import subprocess
import sys
import tempfile
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


def one_kernel_a_call(torch, fn, sets, what, tag, windows=3):
    """The profiler's rows of `fn` over `sets`: exactly one kernel a
    call, f32_decode_kernel. Returns the rows. A window whose one row
    counts fewer launches than calls lost device records (a short
    kernel's activity record can miss the profiler: 5 of 20 once on an
    H100): it is printed and measured again, up to `windows` windows,
    each held to the same gate."""
    for _ in range(windows):
        kernels = kernel_rows(torch, fn, sets)
        if len(kernels) != 1 or kernels[0]["launches_per_call"] >= 1:
            break
        print(f"{what}: the profiler's window lost device records "
              f"({kernels[0]['launches_per_call']:g} launches a call of "
              f"{kernels[0]['name'][:60]}); measured again {tag}")
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


#: phase 24's control: the plain model with every attention's logits
#: scaled by 1.01 (its q projections), a change the near-tie rule must
#: refuse; where 1% moves no beam of a lightly trained model past a tie,
#: the next scale that does is the control
BEAM_CONTROL_SCALES = (1.01, 1.02, 1.05, 1.1)


def recorded_beam(m, fn):
    """`fn(m)` with each beam-search step recorded (the model's `decode`
    wrapped): (fn's result, {"steps": [logits [B*K, V] a step],
    "prefixes": [the [B*K, T] prefix each step decoded], "enc", "mask":
    the encoder output and cross mask it decoded against})."""
    rec = {"steps": [], "prefixes": [], "enc": None, "mask": None}
    decode = m.decode

    def record(prefix, enc, mask):
        out = decode(prefix, enc, mask)
        t = len(rec["steps"])
        rec["steps"].append(out[:, t].detach().clone())
        rec["prefixes"].append(prefix.clone())
        rec["enc"], rec["mask"] = enc, mask
        return out
    m.decode = record
    try:
        return fn(m), rec
    finally:
        del m.decode


def forced_steps(torch, m, ref, own):
    """Model `m`'s logits at each step of the reference run `ref` (a
    `recorded_beam` record), decoding the reference's prefixes against
    m's own encoder output (`own`, m's record): the beam steps teacher
    forced on the reference's beams."""
    with torch.no_grad():
        return [m.decode(prefix, own["enc"], own["mask"])[:, t]
                for t, prefix in enumerate(ref["prefixes"])]


def beam_choices(torch, steps, batch, beam, eos, other=None):
    """Replay ops.beam_search's pruning over the reference's recorded
    logits: per step, the candidates it chose ([B, K], source beam * V +
    token, best first) with their scores ([B, K]) and, given `other`
    logits of the same steps (teacher forced), the candidates they choose
    from the reference's beams with the reference's scores of them."""
    from paddle_tpu_torch.ops import beam_search as bs
    dev = steps[0].device
    logp = torch.full((batch, beam), bs.NEG_INF, dtype=torch.float32,
                      device=dev)
    logp[:, 0] = 0.0
    fin = torch.zeros((batch, beam), dtype=torch.bool, device=dev)
    out = []
    for t, lg in enumerate(steps):
        lg = lg.reshape(batch, beam, -1).to(torch.float32)
        v = lg.shape[-1]
        step_logp = torch.log_softmax(lg, dim=-1)
        eos_row = torch.full((v,), bs.NEG_INF, dtype=torch.float32,
                             device=dev)
        eos_row[eos] = 0.0
        cand = (logp[..., None] + torch.where(fin[..., None], eos_row,
                                              step_logp)).reshape(batch, -1)
        chosen = scores = None
        if other is not None:
            o_tok, _, o_src = bs._prune_step(
                logp, fin, other[t].reshape(batch, beam, -1).to(dev), beam,
                eos)
            chosen = (o_src.to(torch.int64) * v + o_tok.to(torch.int64))
            scores = cand.gather(1, chosen).cpu()
            chosen = chosen.cpu()
        tokens, logp, src = bs._prune_step(logp, fin, lg, beam, eos)
        src = src.to(torch.int64)
        mine = src * v + tokens.to(torch.int64)
        out.append((mine.cpu(), cand.gather(1, mine).cpu(), chosen, scores))
        fin = torch.take_along_dim(fin, src, dim=1) | (tokens == eos)
    return out


def _final_rank_tie(torch, got, want, scores, got_scores):
    """The largest gap of a final-ranking tie, or None when `got`'s beams
    [K, T] are not a reordering of `want`'s (a beam of one the other
    lacks). Two gaps count: between the reference's final `scores` [K]
    of the beams the reordering swaps, and between the final score
    `got_scores` [K] of each beam and the reference's of the same beam."""
    rows = [tuple(b) for b in want.tolist()]
    perm = []
    for b in got.tolist():
        if tuple(b) not in rows:
            return None
        perm.append(rows.index(tuple(b)))
    if sorted(perm) != list(range(len(rows))):
        return None
    return max(max(float(abs(scores[p] - scores[k])),
                   float(abs(got_scores[k] - scores[p])))
               for k, p in enumerate(perm))


def beam_near_ties(torch, label, got, want, forced, want_steps, batch,
                   beam, eos, want_scores=None, got_scores=None):
    """Phase 24's rule for beam ids ([B, K, T] against the reference's):
    rows whose ids are equal are held to bit equality; a row whose ids
    differ is excused only when the other model, teacher forced on the
    reference's beams (`forced`, its logits on the reference's prefixes),
    chooses otherwise than the reference only inside groups of tied
    candidates: at every step and every slot where the two choices
    differ, the reference's score of the other model's candidate lies
    within NEAR_TIE of the reference's score of its own candidate there.
    Each such step is printed with its largest gap; a slot without a tie
    raises. A row whose every step chose the reference's candidates is
    excused only as a tie of the final ranking (beam search orders the
    beams by their length-penalised scores: `want_scores` [B, K] the
    reference's, `got_scores` the other model's): the same beams,
    reordered only among beams whose final scores lie within NEAR_TIE,
    each scoring within NEAR_TIE of the reference's score of it (step
    "final"). Returns [(row, step, gap)]."""
    steps = beam_choices(torch, want_steps, batch, beam, eos, forced)
    excused = []
    for r in range(batch):
        if torch.equal(got[r], want[r]):
            continue
        ties = []
        for t, (cw, sw, co, so) in enumerate(steps):
            diff = torch.nonzero(co[r] != cw[r]).flatten()
            if not len(diff):
                continue
            gaps = (sw[r, diff] - so[r, diff]).abs()
            worst = int(torch.argmax(gaps))
            gap = float(gaps[worst])
            if not gap < NEAR_TIE:
                raise AssertionError(
                    f"{label} row {r}: at step {t} the candidate chosen "
                    f"from the same beams at slot {int(diff[worst])} scores "
                    f"{gap:.3g} >= {NEAR_TIE} away from the reference's "
                    f"there: no tie")
            ties.append((r, t, gap))
        if not ties:
            gap = (None if want_scores is None else _final_rank_tie(
                torch, got[r], want[r], want_scores[r], got_scores[r]))
            if gap is None or not gap < NEAR_TIE:
                raise AssertionError(
                    f"{label} row {r}: the ids differ where every step "
                    f"chose the same candidates (final-ranking gap {gap}; "
                    f"got {got[r].tolist()}, want {want[r].tolist()})")
            ties.append((r, "final", gap))
        for _, t, gap in ties:
            what = ("the final ranking reorders beams" if t == "final" else
                    f"step {t} chose otherwise from the same beams")
            print(f"near-tie: {label} row {r}: {what} at a score gap of "
                  f"{gap:.3g} < {NEAR_TIE}")
        excused += ties
    return excused


def dev_us(e):
    """Device microseconds of a torch.profiler row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_rows(torch, run, host=None):
    """torch.profiler's device-side rows over `run()`: a CPU op's row
    also carries the device time of the kernels it launched, which would
    count them twice. With a dict `host`, also the host's launch calls
    over the run: host["launches"] (kernel launch calls and graph
    launches) and host["graph_launches"]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run()
    rows = prof.key_averages()
    if host is not None:
        graphs = sum(e.count for e in rows if e.key in GRAPH_LAUNCH_CALLS)
        host["graph_launches"] = graphs
        host["launches"] = graphs + sum(e.count for e in rows
                                        if e.key in LAUNCH_CALLS)
    return [e for e in rows
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
#: the calls that launch a captured CUDA graph
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


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
    host = {}
    events = device_rows(torch, lambda: run(steps), host)
    device_ms = sum(dev_us(e) for e in events) / steps / 1e3
    ranked = sorted(events, key=dev_us, reverse=True)[:top]
    return {"step_wall_ms": wall_ms,
            "step_device_ms": device_ms if events else None,
            "launches_per_step": sum(e.count for e in events) / steps,
            "host_launches_per_step": host["launches"] / steps,
            "graph_launches_per_step": host["graph_launches"] / steps,
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
        eng = gen.DecodeEngine(model, batch_size=8,
                               max_len=model.config.max_len)
    else:
        eng = gen.PagedDecodeEngine(model, batch_size=8,
                                    max_len=model.config.max_len,
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
    return _case_errors(torch, res), launched


def _case_errors(torch, res):
    """{output: (max abs err, relative err)} of res["kernel"] against
    res["plain"]; fails on a non-finite kernel output."""
    torch.cuda.synchronize()
    out = {}
    for key, want in res["plain"].items():
        got, want = res["kernel"][key].float(), want.float()
        diff = float((got - want).abs().max())
        assert bool(torch.isfinite(got).all()), f"{key}: non-finite values"
        out[key] = (diff, diff / max(float(want.abs().max()), 1e-30))
    return out


def flash_lse_case(torch, tfa, dev, b, tq, tk, n, d, causal, fused,
                   seed=0):
    """A ring step's use of the f32 pair: `flash_attention_lse` of q
    against one K/V chunk, and one backward with cotangents on both o
    and the lse (which the kernel folds into delta), against
    `attention_reference(..., return_lse=True)` on the same inputs. With
    `fused` (tq == tk) q, k, v are views of one [B, T, 3, N, D] leaf, as
    the LM's projections give a rank's own chunk; else separate tensors,
    as the received K/V chunks are. Returns ({output: (max abs err,
    relative err)}, {kernel: launches of the kernel side})."""
    f32 = torch.float32
    ins = attn_inputs(torch, dev, f32, b, tq, tk, n, d, None, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dlse = torch.randn((b, tq, n, 1), generator=g, device=dev)
    res, launched = {}, {}
    for side in ("kernel", "plain"):
        if fused:
            leaf = torch.stack([ins[key] for key in "qkv"], dim=2) \
                .detach().requires_grad_()
            q, k, v = leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2]
        else:
            q, k, v = (ins[key].detach().clone().requires_grad_()
                       for key in "qkv")
        if side == "kernel":
            before = dict(tfa.launch_counts)
            o, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
        else:
            o, lse = tfa.attention_reference(q, k, v, None, causal,
                                             return_lse=True)
        ((o * ins["dout"]).sum() + (lse * dlse).sum()).backward()
        if side == "kernel":
            launched = {kn: tfa.launch_counts[kn] - before[kn]
                        for kn in tfa.launch_counts
                        if tfa.launch_counts[kn] != before[kn]}
        if fused:
            dq, dk, dv = leaf.grad[:, :, 0], leaf.grad[:, :, 1], \
                leaf.grad[:, :, 2]
        else:
            dq, dk, dv = q.grad, k.grad, v.grad
        res[side] = {"o": o.detach(), "lse": lse.detach(), "dq": dq,
                     "dk": dk, "dv": dv}
    return _case_errors(torch, res), launched


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
        plan, wo_plan = (k8.k8_plan(m, k, n, mode) for mode in (True, False))
        row = {"M": m, "K": k, "N": n, "splits": plan["splits"],
               "tile": plan["tile"], "max_ulps": err_ulp,
               "max_abs_err": float((got - want).abs().max()),
               "weight_only_rel_err": wo_rel,
               "weight_only_max_abs_err": float(
                   (got_wo - want_wo).abs().max()),
               "weight_only_splits": wo_plan["splits"],
               "weight_only_tile": wo_plan["tile"],
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


def served_fc_ulps(torch, k8, pred, x):
    """An int8 Predictor's served fc on `x` against K8's plain version on
    the same fc input, plus the fc's bias: the largest difference in
    float32 ulps."""
    ops = pred._program.global_block().ops
    qmul = next(op for op in ops if op.type == "quantized_mul")
    add = next(op for op in ops if op.type == "elementwise_add"
               and op.inputs["X"] == qmul.outputs["Out"])
    served, fc_in = pred.run({"img": x}, fetch_list=[qmul.inputs["X"][0]])
    sc = pred._scope
    w = sc.get(qmul.inputs["Y"][0])
    fc_x = torch.from_numpy(fc_in).to(w.device)
    plain = k8.dequant_matmul_reference(
        fc_x.reshape(fc_x.shape[0], -1), w,
        sc.get(qmul.inputs["YScale"][0]).reshape(-1),
        x_scale=qmul.attrs["x_scale"]) + sc.get(add.inputs["Y"][0])
    return ulps(torch, torch.from_numpy(served).to(w.device), plain)


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
    x32 = requests[-1]
    fc_ulps = served_fc_ulps(torch, k8, int8, x32)
    assert fc_ulps <= 1, f"served fc vs plain K8 + bias: {fc_ulps} ulps"
    sc = int8._scope

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


def step_agreement(torch, main, state, feed, loss, tag,
                   devs=("cuda", "cpu")):
    """Phase 14(a): one step at CHECK_BATCH from the same weights on the
    card and on the host CPU, in float32 and with every float var made
    float64. float32 holds the loss (LOSS_RTOL) and the BN running
    statistics (STATE_TOL); its updates and velocities are printed with
    the ReLU masks that differ between the two runs: a pre-activation
    within float32's forward error of zero takes the other side of the
    kink, and the gradient behind it moves by that element's whole
    upstream value. float64 holds the loss, every update (UPDATE_TOL of
    its max), the BN statistics and the velocities (STATE_TOL). `devs`:
    the card's device and the host's."""
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
    runs = {("float32", k): one_step(torch, main, state, feed,
                                     [loss] + relu_in, dev)
            for k, dev in zip(("cuda", "cpu"), devs)}
    feed64 = dict(feed, img=feed["img"].astype(np.float64))
    runs.update({("float64", k): one_step(
        torch, widened(torch, main), wide, feed64, [loss] + relu_in, dev)
        for k, dev in zip(("cuda", "cpu"), devs)})

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
    eos = 1                           # beam_search_decode's default
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
            scores = None
            if label == "beam":
                (ids, scores), rec = recorded_beam(m, fn)
                scores = scores.cpu()
            else:
                ids, rec = fn(m), None
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reads = (T.host_reads["greedy_decode"] if label == "greedy"
                     else bs.host_reads["beam_search"])
            wait = (T.host_reads["wait_s"] if label == "greedy"
                    else bs.host_reads["wait_s"])
            res[impl] = dict(ids=ids.cpu(), scores=scores, wall_s=wall,
                             host_reads=reads,
                             wait_s=wait, rec=rec, flash={
                                 k: tfa.launch_counts[k] - before[k]
                                 for k in FLASH_F32})
            if impl == "flash":
                for k in FLASH_F32:
                    launches[k] += res[impl]["flash"][k]
        excused = []
        if label == "greedy":
            assert torch.equal(res["flash"]["ids"], res["plain"]["ids"]), label
        else:
            bk = (dc["beam_batch"], dc["beam"], eos)
            ref = res["plain"]["rec"]
            excused = beam_near_ties(
                torch, "phase 24 beam", res["flash"]["ids"],
                res["plain"]["ids"],
                forced_steps(torch, model, ref, res["flash"]["rec"]),
                ref["steps"], *bk, want_scores=res["plain"]["scores"],
                got_scores=res["flash"]["scores"])
            control = beam_control(torch, T, plain, fn, res["plain"], bk,
                                   dev)
        assert res["flash"]["flash"][FLASH_F32[0]] > 0
        assert res["plain"]["flash"][FLASH_F32[0]] == 0
        f = res["flash"]
        out[label] = dict(shape=tuple(f["ids"].shape), wall_s=f["wall_s"],
                          plain_wall_s=res["plain"]["wall_s"],
                          host_reads=f["host_reads"], wait_s=f["wait_s"],
                          flash_launches=f["flash"][FLASH_F32[0]],
                          near_ties=excused)
        if label == "beam":
            out[label]["control"] = control
        print(f"phase 24 {label} {tuple(f['ids'].shape)}: ids equal to the "
              f"plain attention's"
              f"{'' if label == 'greedy' else ' (near-tie rule: %d rows excused)' % len(excused)}; "
              f"flash {f['wall_s'] * 1e3:.1f} ms, plain "
              f"{res['plain']['wall_s'] * 1e3:.1f} ms; {f['host_reads']} "
              f"host reads, the host waited {f['wait_s'] * 1e3:.3f} ms in "
              f"them; {f['flash'][FLASH_F32[0]]} flash forward launches "
              f"{tag}")
    del plain
    torch.cuda.empty_cache()
    return out, launches


def beam_control(torch, T, plain, fn, ref, bk, dev):
    """Phase 24's control: the plain model with its attention logits
    scaled by the first of BEAM_CONTROL_SCALES that moves a beam past a
    tie decodes the same rows; against the plain decode the near-tie
    rule must refuse it. A scale whose beams part only at ties of the
    plain scores (the rule excuses every row: no divergence to refuse)
    is passed over like one that moves no beam. Returns the refusal."""
    ctl = T.Transformer(plain.cfg, device=dev)
    for scale in BEAM_CONTROL_SCALES:
        ctl.load_state_dict(plain.state_dict())
        ctl.eval()
        with torch.no_grad():
            for mod in ctl.modules():
                if isinstance(mod, T.MultiHeadAttention):
                    mod.q.weight.mul_(scale)
                    mod.q.bias.mul_(scale)
        (ids, scores), rec = recorded_beam(ctl, fn)
        ids = ids.cpu()
        if torch.equal(ids, ref["ids"]):
            print(f"phase 24 control: attention logits x {scale} move no "
                  f"beam")
            continue
        try:
            ties = beam_near_ties(torch, "phase 24 control", ids, ref["ids"],
                                  forced_steps(torch, ctl, ref["rec"], rec),
                                  ref["rec"]["steps"], *bk,
                                  want_scores=ref["scores"],
                                  got_scores=scores.cpu())
        except AssertionError as e:
            print(f"phase 24 control (attention logits x {scale}) refused, "
                  f"as it must be: {e}")
            return str(e)
        print(f"phase 24 control: attention logits x {scale} part beams "
              f"only at ties ({len(ties)} steps, largest gap "
              f"{max(g for _, _, g in ties):.3g})")
    raise AssertionError(f"phase 24: no control scale in "
                         f"{BEAM_CONTROL_SCALES} moved a beam past a tie")


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
    # the dropout generator is a step argument: a captured step draws
    # fresh masks from it on every replay
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, build, fwd in (
            ("vgg16", lambda: vision_zoo.vgg16(image_size=image, device=dev),
             lambda m, a, g: m(a, g)),
            ("mobilenet_v1", lambda: vision_zoo.MobileNetV1(device=dev),
             lambda m, a, g: m(a)),
            ("se_resnext50", lambda: vision_zoo.SEResNeXt(50, device=dev),
             lambda m, a, g: m(a))):
        m = build()
        loss, _, ms = zoo_step(torch, m,
                               lambda mm, a, b, g: ce(fwd(mm, a, g), b),
                               (xs, ys, gen))
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
        case("switch_moe", {"X": f(b, 16), "GateW": f(16, 4),
                            "WIn": f(4, 16, 32) * 0.3,
                            "WOut": f(4, 32, 16) * 0.3},
             {"capacity_factor": 1.25}, ["X", "GateW", "WIn", "WOut"]),
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


def check_kernels(torch, da, gen, seed, tag):
    """Phase 2: K5, K6 and K7 against their plain versions; the summary
    dict of each kernel, launches zeroed for the serving phases."""
    kernels = {"decode_attention": check_contiguous_kernel(
        torch, da, seed, tag)}
    (kernels["paged_decode_attention"],
     kernels["paged_prefill_attention"]) = check_paged_kernel(
        torch, da, seed, tag)
    (kernels["quantized_paged_decode_attention"],
     kernels["quantized_paged_prefill_attention"]) = check_quantized_kernel(
        torch, da, gen, seed, tag)
    for k in CHUNK_ROUTES.keys() | CHUNK_ROUTES.values():
        kernels[k]["launches"] = 0
    return kernels


# ---------------------------------------------------------------------------
# phase 31: the captured rungs (one CUDA graph per signature) against eager
# ---------------------------------------------------------------------------

#: each rung's captured logits against its eager logits on the same state,
#: relative to max |eager|: the same kernels in the same order, so only
#: the summation order of a library GEMM could differ
CAPTURE_LOGIT_TOL = 1e-6
#: Transformer-big's captured steps against eager ones from the same
#: weights: the loss (relative) and each parameter's update within
#: CAPTURE_UPDATE_TOL of its max, floored at CAPTURE_UPDATE_FLOOR of the
#: largest (dQ and dbias are summed with f32 atomics, in an order that
#: changes between runs: the eager-vs-eager control is printed beside)
CAPTURE_LOSS_TOL = 1e-6
CAPTURE_UPDATE_TOL = 1e-4
CAPTURE_UPDATE_FLOOR = 1e-2
CAPTURE_MT_BUCKET = (128, 64)
#: phase 31's Chrome trace (spans, captures, executable runs), written
#: beside --out's file, or in the temporary directory
CAPTURE_TRACE = "phase31_trace.json"


def rung_ladder(gen, eng):
    """The ledger keys warmup() captures, in its order."""
    if isinstance(eng, gen.PagedDecodeEngine):
        chunks = [1] + ([eng.spec_k + 1] if eng.spec_k > 0 else [])
        return ([f"paged_prefill[bucket={b}]" for b in eng.buckets]
                + [f"paged_step[chunk={c}]" for c in chunks])
    return ([f"prefill[bucket={b}]" for b in eng.buckets]
            + [f"decode[{eng.batch_size}x{eng.max_len}]"])


def _host(x):
    return x if isinstance(x, np.ndarray) else x.detach().cpu().numpy()


def rung_logits(gen, prof, eng, state, vocab):
    """Every rung of `eng` once captured and once eager (disable_capture)
    on the same state, the pools restored after each run: [(key, max
    |captured - eager|, max |eager|)]."""
    pools = [t for t in state if t is not None]
    saved = [t.clone() for t in pools]

    def restore():
        for t, s in zip(pools, saved):
            t.copy_(s)

    def toks(*shape):
        return (np.arange(int(np.prod(shape))) * 7919 % vocab).astype(
            np.int32).reshape(shape)

    b = eng.batch_size
    calls = []
    if isinstance(eng, gen.PagedDecodeEngine):
        # a prefill from position 0 over distinct blocks (the other
        # slots', restored after): no two rows scatter to one place
        table = np.arange(1, eng.blocks_per_slot + 1, dtype=np.int32)[None]
        for bk in eng.buckets:
            calls.append((f"paged_prefill[bucket={bk}]", lambda bk=bk:
                          eng._chunk(state, toks(1, bk), table, [0],
                                     np.ones((1, bk), bool), bucket=bk)))
        for c in [1] + ([eng.spec_k + 1] if eng.spec_k > 0 else []):
            calls.append((f"paged_step[chunk={c}]", lambda c=c:
                          eng._chunk(state, toks(b, c), eng.tables,
                                     eng.lengths, np.ones((b, c), bool),
                                     chunk=c)))
    else:
        for bk in eng.buckets:
            calls.append((f"prefill[bucket={bk}]", lambda bk=bk:
                          eng.prefill(state, 0, toks(bk))[1]))
        calls.append((f"decode[{b}x{eng.max_len}]", lambda:
                      eng.step(state, toks(b), np.ones(b, bool))[1]))
    out = []
    for key, fn in calls:
        got = _host(fn())
        restore()
        with prof.disable_capture():
            want = _host(fn())
        restore()
        out.append((key, float(np.abs(got - want).max()),
                    float(np.abs(want).max())))
    return out


def live_state(eng, prompts, budgets):
    """The engine's pools with the first batch_size prompts admitted."""
    state = eng.init_state()
    for i in range(eng.batch_size):
        p = prompts[i]
        if hasattr(eng, "admit"):
            state, _, _ = eng.admit(state, i, p, p.size + budgets[i])
        else:
            state, _ = eng.prefill(state, i, p)
    return state


def capture_serving(torch, gen, prof, model, prompts, budgets, gaps, tag):
    """Phase 31(a) and (b). Each engine serves phase 3's 16 requests
    eagerly (disable_capture) and captured; the tokens must be equal
    (near-tie rule), compile_count() must equal the rung count after
    warmup() and after the requests, every rung's logits must agree on
    the same state. Then (b): a second contiguous engine warm-starts
    from the first one's manifest."""
    from paddle_tpu_torch.serving.generation import GenerationServer
    led = prof.compile_ledger()
    out, draft, first = {}, None, None
    s = model.config.max_len
    engines = (
        ("contiguous f32", lambda: gen.DecodeEngine(model, batch_size=8,
                                                    max_len=s)),
        ("paged f32", lambda: gen.PagedDecodeEngine(
            model, batch_size=8, max_len=s, block_size=8, spec_k=4)),
        ("paged int8", lambda: gen.PagedDecodeEngine(
            model, batch_size=8, max_len=s, block_size=8, spec_k=4,
            kv_dtype="int8")))
    for label, make in engines:
        kw = {} if label.startswith("contiguous") else {"draft": draft}
        eng = make()
        with prof.disable_capture():
            eng.warmup()
            eager, _, eager_wall, _ = serve(GenerationServer, eng, prompts,
                                            budgets, **kw)
        del eng
        torch.cuda.empty_cache()
        if draft is None:
            draft = gen.NgramDraft(model.config.vocab_size)
            for p, t in zip(prompts, eager):
                draft.observe(list(p) + t)
        eng = make()
        t0 = time.perf_counter()
        rep = eng.warmup()
        warm_s = time.perf_counter() - t0
        ladder = rung_ladder(gen, eng)
        recs = led.entries(scope=eng.ledger_scope, kind=(
            "graph" if eng.device.type == "cuda" else "eager"))
        assert sorted(r.key for r in recs) == sorted(ladder), (
            label, [r.key for r in recs], ladder)
        assert eng.compile_count() == len(ladder), (label,
                                                    eng.compile_count())
        got, _, wall, stats = serve(GenerationServer, eng, prompts, budgets,
                                    **kw)
        assert eng.compile_count() == stats["compiled_signatures"] == len(
            ladder), (label, eng.compile_count(), stats)
        ties = sum(compare(f"31(a) {label} request {i}", g, e, gp)
                   for i, (g, e, gp) in enumerate(zip(got, eager, gaps)))
        errs = rung_logits(gen, prof, eng, live_state(eng, prompts, budgets),
                           model.config.vocab_size)
        worst = max(errs, key=lambda r: r[1] / r[2])
        for key, err, top in errs:
            assert err <= CAPTURE_LOGIT_TOL * top, (label, key, err, top)
        rungs = {r.key: {"capture_ms": r.compile_s * 1e3,
                         "warmup_ms": (r.memory or {}).get("warmup_s", 0.0)
                         * 1e3,
                         "pool_bytes": (r.memory or {}).get("pool_bytes"),
                         "peak_bytes": (r.memory or {}).get("peak_bytes"),
                         "launches": r.launches,
                         "gflop": r.flops / 1e9} for r in recs}
        n_tok = sum(map(len, got))
        out[label] = dict(
            rungs=rungs, warmup_s=warm_s, compile_count=len(ladder),
            eager_tokens_per_s=sum(map(len, eager)) / eager_wall,
            tokens_per_s=n_tok / wall, near_ties=ties,
            logits_max_rel=worst[1] / worst[2], logits_worst_rung=worst[0],
            warm_start=rep["warm_start"])
        print(f"phase 31(a) {label}: {n_tok} tokens captured "
              f"{n_tok / wall:.1f} tokens/s, eager "
              f"{out[label]['eager_tokens_per_s']:.1f} tokens/s, equal "
              f"(near-ties {ties}); compile_count {len(ladder)} after "
              f"warmup ({warm_s:.2f} s) and after the requests; rung "
              f"logits max |captured - eager| / max |eager| "
              f"{worst[1] / worst[2]:.3g} at {worst[0]} (gate "
              f"{CAPTURE_LOGIT_TOL}) {tag}")
        for key in ladder:
            r = rungs[key]
            print(f"  {key}: capture {r['capture_ms']:.1f} ms (warm-up "
                  f"{r['warmup_ms']:.1f}), pool {r['pool_bytes']} bytes, "
                  f"peak {r['peak_bytes']} bytes, {r['gflop']:.3f} GFLOP, "
                  f"launches a replay {r['launches']}")
        if first is None:
            first = got
            out["warm_start"] = warm_start_check(
                torch, gen, prof, make, prompts, budgets, got, gaps,
                len(ladder), tag)
        del eng
        torch.cuda.empty_cache()
    return out


def warm_start_check(torch, gen, prof, make, prompts, budgets, want, gaps,
                     n_rungs, tag):
    """Phase 31(b): a second engine reads the first one's manifest:
    every rung a warm-start hit, and traffic captures nothing."""
    from paddle_tpu_torch.serving.generation import GenerationServer
    eng = make()
    t0 = time.perf_counter()
    rep = eng.warmup()
    warm_s = time.perf_counter() - t0
    ws = rep["warm_start"]
    hits = prof.compile_ledger().cache_entries(event="hit",
                                               scope=eng.ledger_scope)
    assert ws and ws["found"] and ws["requested"] == ws["loaded"] == \
        ws["captured"] == n_rungs == len(hits), (ws, len(hits))
    assert eng.compile_count() == 0, eng.compile_count()
    got, _, _, stats = serve(GenerationServer, eng, prompts, budgets)
    assert eng.compile_count() == stats["compiled_signatures"] == 0
    ties = sum(compare(f"31(b) request {i}", g, w, gp)
               for i, (g, w, gp) in enumerate(zip(got, want, gaps)))
    print(f"phase 31(b) warm start: manifest {ws['manifest']}, "
          f"{ws['loaded']} of {ws['requested']} rungs hits, captured in "
          f"{ws['seconds']:.2f} s (warmup {warm_s:.2f} s); traffic "
          f"captured nothing (compile_count 0), tokens equal to 31(a)'s "
          f"(near-ties {ties}) {tag}")
    return dict(ws, warmup_s=warm_s, near_ties=ties)


def capture_ticks(torch, gen, prof, model, prompts, tag):
    """Phase 31(c): the decode tick at 8 slots, f32 contiguous and int8
    paged, eager and captured: wall, device, idle share, kernels and
    host launch calls per tick."""
    import contextlib
    out = {}
    for kv in (None, "int8"):
        for mode in ("eager", "captured"):
            ctx = (prof.disable_capture() if mode == "eager"
                   else contextlib.nullcontext())
            with ctx:
                brk = step_breakdown(torch, gen, model, prompts, kv_dtype=kv)
            label = f"{'f32 contiguous' if kv is None else 'int8 paged'} " \
                    f"{mode}"
            out[label] = brk
            dms = ("not measured" if brk["step_device_ms"] is None else
                   f"{brk['step_device_ms']:.3f} ms, idle share "
                   f"{brk['device_idle_share']:.3f}")
            print(f"phase 31(c) decode tick, 8 slots, {label}: wall "
                  f"{brk['step_wall_ms']:.3f} ms, device {dms}, "
                  f"{brk['launches_per_step']:.0f} kernels and "
                  f"{brk['host_launches_per_step']:.0f} host launch calls "
                  f"({brk['graph_launches_per_step']:.0f} graph launches) "
                  f"a tick {tag}")
            torch.cuda.empty_cache()
    return out


def capture_training(torch, tfa, prof, seed, tag, dev="cuda"):
    """Phase 31(d): Transformer-big through nn.TrainStep at the 128 bucket
    (B=64), two captured steps against two eager ones from the same
    weights, and two more eager ones as the control; each run launches
    the f32 flash kernels 18 + 18 times a step."""
    import contextlib

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.transformer import Transformer
    cfg = mt_big_config()
    nn.seed(seed)
    init = Transformer(cfg, device=dev)
    state0 = {k: v.detach().to("cpu", copy=True)
              for k, v in init.state_dict().items()}
    del init
    bucket, bsz = CAPTURE_MT_BUCKET
    batch = _to(torch, mt_bucket_batch(seed, bucket, bsz), dev)

    def run(eager):
        m = Transformer(cfg, device=dev)
        m.load_state_dict(state0)
        step = nn.TrainStep(m, lambda mm, *b: mm.loss(*b), MT_BIG_LR, 0.9)
        before = dict(tfa.launch_counts)
        losses, walls = [], []
        with (prof.disable_capture() if eager
              else contextlib.nullcontext()):
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(*batch)))
                walls.append((time.perf_counter() - t0) * 1e3)
        launched = {k: tfa.launch_counts[k] - before[k] for k in FLASH_F32}
        assert dev == "cpu" or launched == dict.fromkeys(FLASH_F32,
                                                         36), launched
        upd = {k: p.detach().to("cpu") - state0[k]
               for k, p in m.named_parameters()}
        del m, step
        torch.cuda.empty_cache()
        return losses, upd, walls

    prof.reset_profile()
    cl, cu, cw = run(False)
    rec = prof.compile_ledger().entries(
        component="train", kind="graph" if dev == "cuda" else "eager")
    assert len(rec) == 1, [r.key for r in rec]
    el, eu, ew = run(True)
    kl, ku, _ = run(True)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, el))
    upd_err, worst = grad_err(cu, eu, CAPTURE_UPDATE_FLOOR)
    ctl_loss = max(abs(a - b) / abs(b) for a, b in zip(kl, el))
    ctl_upd, ctl_worst = grad_err(ku, eu, CAPTURE_UPDATE_FLOOR)
    r = rec[0]
    mem = r.memory or {"warmup_s": 0.0, "pool_bytes": None}
    print(f"phase 31(d) Transformer-big TrainStep, bucket {bucket} B={bsz}, "
          f"two steps: captured losses {cl}, eager {el}: loss rel err "
          f"{loss_err:.3g} (gate {CAPTURE_LOSS_TOL}), update err "
          f"{upd_err:.3g} at {worst} (each tensor's max floored at "
          f"{CAPTURE_UPDATE_FLOOR} of the largest; gate "
          f"{CAPTURE_UPDATE_TOL}); control eager vs eager: loss "
          f"{ctl_loss:.3g}, update {ctl_upd:.3g} at {ctl_worst}; capture "
          f"{r.key}: {r.compile_s * 1e3:.1f} ms (warm-up "
          f"{mem['warmup_s'] * 1e3:.1f}), pool "
          f"{mem['pool_bytes']} bytes, {r.flops / 1e12:.3f} TFLOP; "
          f"step walls captured {cw[0]:.1f} / {cw[1]:.1f} ms, eager "
          f"{ew[0]:.1f} / {ew[1]:.1f} ms {tag}")
    assert loss_err <= CAPTURE_LOSS_TOL and upd_err <= CAPTURE_UPDATE_TOL, (
        loss_err, upd_err, worst)
    return dict(captured_losses=cl, eager_losses=el, loss_rel_err=loss_err,
                update_err=upd_err, worst=worst, control_loss=ctl_loss,
                control_update=ctl_upd, capture_ms=r.compile_s * 1e3,
                pool_bytes=mem["pool_bytes"], tflop=r.flops / 1e12,
                captured_wall_ms=cw, eager_wall_ms=ew)


def capture_phase(torch, gen, tfa, model, prompts, budgets, gaps, seed, tag,
                  out_dir=None):
    """Phase 31: the captured path against eager runs (see the module
    docstring). The compile cache lives in a temporary directory for the
    phase; the Chrome trace goes to `out_dir` (default: the temporary
    directory)."""
    from paddle_tpu_torch.core import compile_cache as cc
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.observability import profile as prof
    from paddle_tpu_torch.observability import trace
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as cache_dir:
        flags.set_flag("compile_cache_dir", cache_dir)
        cc.reset_compile_cache()
        try:
            out["serving"] = capture_serving(torch, gen, prof, model,
                                             prompts, budgets, gaps, tag)
            out["cache"] = cc.compile_cache().stats()
        finally:
            flags.set_flag("compile_cache_dir", "")
            cc.reset_compile_cache()
    out["ticks"] = capture_ticks(torch, gen, prof, model, prompts, tag)
    out["training"] = capture_training(torch, tfa, prof, seed, tag)
    snap = prof.profile_snapshot()
    trace_path = os.path.join(out_dir or tempfile.gettempdir(),
                              CAPTURE_TRACE)
    trace.export_chrome_trace(trace_path, extra_events=prof.chrome_events())
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 31: {out['seconds']:.1f} s; profile_snapshot ledger "
          f"{snap['ledger']['events']} records since the last reset, "
          f"{len(snap['executables'])} executables; Chrome trace "
          f"{trace_path}; compile cache {out['cache']['entries']} "
          f"entries, events {out['cache']['events']} {tag}")
    return out


# ---------------------------------------------------------------------------
# phase 32: the Executor's programs captured against eager
# ---------------------------------------------------------------------------

#: phase 32's requests per Predictor and batch size (the first captures)
EXEC_REQUESTS = 4
#: phase 32's profile windows: steps (or requests) per window
EXEC_PROFILE_STEPS = 2


def executor_records(prof, program, since=0):
    """The ledger's "graph" records of `program`'s Executor entries
    (those after record `since`)."""
    site = f"executor/{id(program):x}v{program._version}/"
    return [r for r in prof.compile_ledger().entries(kind="graph")
            if r.site.startswith(site) and r.seq > since]


def entry_stats(prof, program, since=0):
    """Segments, graphs captured, capture ms, pool bytes and launches a
    replay adds over `program`'s Executor entries (recorded after record
    `since`)."""
    recs = executor_records(prof, program, since)
    assert recs, f"no captured entry for {program}"
    launches = {}
    for r in recs:
        for k, v in (r.launches or {}).items():
            launches[k] = launches.get(k, 0) + v
    return dict(entries=len(recs),
                segments=max(r.tags["segments"] for r in recs),
                graphs=sum(r.tags["captured"] for r in recs),
                host_ops=recs[0].tags["host_ops"],
                capture_ms=sum(r.compile_s for r in recs) * 1e3,
                pool_bytes=max(r.memory["pool_bytes"] for r in recs),
                gflop=sum(r.flops for r in recs) / 1e9,
                kernel_launches=launches)


def exec_profiles(torch, prof, label, runs, steps, stats, tag):
    """Profile `runs[mode](k)` (k steps or requests, ending in a
    synchronisation) captured and under disable_capture(): wall and
    device ms, idle share, host launch calls (kernels plus graphs)
    against device launches."""
    rows = {}
    for mode in ("captured", "eager"):
        with (prof.disable_capture() if mode == "eager"
              else contextlib.nullcontext()):
            runs[mode](1)
            brk = profile_device(torch, runs[mode], steps, top=3)
        rows[mode] = {k: brk[k] for k in (
            "step_wall_ms", "step_device_ms", "device_idle_share",
            "launches_per_step", "host_launches_per_step",
            "graph_launches_per_step")}
    c, e = rows["captured"], rows["eager"]
    print(f"phase 32 {label}: wall {e['step_wall_ms']:.3f} eager -> "
          f"{c['step_wall_ms']:.3f} ms captured, device "
          f"{e['step_device_ms']:.3f} -> {c['step_device_ms']:.3f} ms, idle "
          f"{e['device_idle_share']:.3f} -> {c['device_idle_share']:.3f}; "
          f"host launch calls {e['host_launches_per_step']:.0f} + "
          f"{e['graph_launches_per_step']:.0f} graphs -> "
          f"{c['host_launches_per_step']:.0f} + "
          f"{c['graph_launches_per_step']:.0f} graphs, device launches "
          f"{e['launches_per_step']:.0f} / {c['launches_per_step']:.0f}; "
          f"segments {stats['segments']}, graphs {stats['graphs']}, capture "
          f"{stats['capture_ms']:.1f} ms, pool {stats['pool_bytes']} bytes "
          f"{tag}")
    return dict(rows, **stats)


def deterministic_cudnn(torch, flags, on):
    """FLAGS_cudnn_deterministic on (the Executor then asks cuDNN for
    deterministic algorithms) or back off with cuDNN's defaults."""
    flags.set_flag("deterministic", on)
    if not on:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = False


def exec_training(torch, prof, label, main, startup, feed, loss, tag,
                  masks=(), steps=EXEC_PROFILE_STEPS):
    """Phase 32, a training program: from the state after one captured
    step (the warm-up and capture), two replayed steps against two eager
    ones and, as the control, two more eager ones, all with cuDNN's
    deterministic algorithms (its default backward sums with atomics,
    so two eager runs differ): losses within CAPTURE_LOSS_TOL, each
    update within CAPTURE_UPDATE_TOL of its max floored at
    CAPTURE_UPDATE_FLOOR of the largest, the `masks` fetched (dropout
    masks) bit-equal. Then the profiles with cuDNN's defaults, on a
    captured entry of their own. Returns the row and the captured run's
    (executor, scope)."""
    from paddle_tpu_torch.core import flags
    deterministic_cudnn(torch, flags, True)
    try:
        return _exec_training(torch, prof, flags, label, main, startup,
                              feed, loss, tag, masks, steps)
    finally:
        deterministic_cudnn(torch, flags, False)


def _exec_training(torch, prof, flags, label, main, startup, feed, loss,
                   tag, masks, steps):
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy
    exe, scope = Executor(), Scope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars()
                   if v.persistable and scope.has(v.name))
    fetch = [loss, *masks]
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    start, counter = scope_to_numpy(scope, names), exe._step_counter

    def two(e, sc, eager):
        with (prof.disable_capture() if eager else contextlib.nullcontext()):
            outs = [e.run(main, feed=feed, fetch_list=fetch, scope=sc,
                          return_numpy=False) for _ in range(2)]
        upd = {n: torch.from_numpy(a - start[n]) for n, a in
               scope_to_numpy(sc, names).items()
               if np.issubdtype(a.dtype, np.floating)}
        return ([float(o[0]) for o in outs],
                [[m.cpu() for m in o[1:]] for o in outs], upd)

    runs = {"captured": two(exe, scope, False)}
    for k in ("eager", "control"):
        e = Executor()
        e._step_counter = counter            # the same run seeds
        runs[k] = two(e, scope_from_jax(start, Scope()), True)
    (cl, cm, cu), (el, em, eu), (kl, _, ku) = (runs[k] for k in (
        "captured", "eager", "control"))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, el))
    upd_err, worst = grad_err(cu, eu, CAPTURE_UPDATE_FLOOR)
    ctl_loss = max(abs(a - b) / abs(b) for a, b in zip(kl, el))
    ctl_upd, ctl_worst = grad_err(ku, eu, CAPTURE_UPDATE_FLOOR)
    masks_equal = all(torch.equal(a, b) for x, y in zip(cm, em)
                      for a, b in zip(x, y))
    print(f"phase 32 {label}: two replayed steps vs two eager from the same "
          f"state: losses {cl} vs {el}, rel err {loss_err:.3g} (gate "
          f"{CAPTURE_LOSS_TOL}); update err {upd_err:.3g} at {worst} (gate "
          f"{CAPTURE_UPDATE_TOL}, floor {CAPTURE_UPDATE_FLOOR}); control "
          f"eager vs eager: loss {ctl_loss:.3g}, update {ctl_upd:.3g} at "
          f"{ctl_worst}" + (f"; {len(masks)} dropout masks a step "
                            f"{'bit-equal' if masks_equal else 'DIFFER'}"
                            if masks else "") + f" {tag}")
    assert loss_err <= CAPTURE_LOSS_TOL and upd_err <= CAPTURE_UPDATE_TOL, (
        label, loss_err, upd_err, worst)
    assert masks_equal, f"{label}: dropout masks differ"
    deterministic_cudnn(torch, flags, False)
    seq0 = max([r.seq for r in prof.compile_ledger().entries()], default=0)
    exe, scope = Executor(), scope_from_jax(start, Scope())
    eager_exe, eager_scope = Executor(), scope_from_jax(start, Scope())

    def steps_on(e, sc):
        def run(k):
            for _ in range(k):
                e.run(main, feed=feed, fetch_list=fetch, scope=sc,
                      return_numpy=False)
            torch.cuda.synchronize()
        return run

    runs = {"captured": steps_on(exe, scope),
            "eager": steps_on(eager_exe, eager_scope)}
    runs["captured"](1)                 # the profiled entry's capture
    row = exec_profiles(torch, prof, f"{label} step", runs, steps,
                        entry_stats(prof, main, seq0), tag)
    row.update(captured_losses=cl, eager_losses=el, loss_rel_err=loss_err,
               update_err=upd_err, worst=worst, control_loss=ctl_loss,
               control_update=ctl_upd, masks_equal=masks_equal)
    return row, exe, scope


def exec_predictors(torch, prof, k8, seed, tag, image_size=224):
    """Phase 32, the f32 and int8 ResNet-50 Predictors (phase 12's): at
    batch 1, 8 and 32, EXEC_REQUESTS requests captured (the first of
    each batch size captures; no ledger record after it) against the
    same requests eager: logits within CAPTURE_LOGIT_TOL of max |eager|;
    K8 launched once per captured int8 request; the int8 fc under replay
    still K8's plain version + bias within 1 ulp."""
    import shutil
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models.resnet import build_static

    rng = np.random.RandomState(seed + 32)
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        img = static.data("img", [3, image_size, image_size], "float32")
        label = static.data("label", [1], "int64")
        logits, _, _ = build_static(img, label, depth=50)
    model_dir = tempfile.mkdtemp(prefix="resnet50_exec_")
    try:
        exe = Executor()
        with scope_guard(Scope()):
            exe.run(startup)
            static.io.save_inference_model(model_dir, ["img"], [logits], exe,
                                           main_program=main)
        preds = {"f32": inference.create_predictor(
            inference.Config(model_dir))}
        cfg = inference.Config(model_dir)
        cfg.enable_int8([{"img": resnet_images(rng, 8, image_size)}
                         for _ in range(4)])
        preds["int8"] = inference.create_predictor(cfg)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    out = {}
    for name, pred in preds.items():
        row = {}
        k8n = 0
        for b in RESNET_BATCHES:
            reqs = [resnet_images(rng, b, image_size)
                    for _ in range(EXEC_REQUESTS)]
            k8.reset_launch_counts()
            seq0 = max([r.seq for r in prof.compile_ledger().entries()],
                       default=0)
            got, _ = serve_requests(pred, reqs[:1])
            n0 = prof.compile_ledger().count()
            more, _ = serve_requests(pred, reqs[1:])
            new = prof.compile_ledger().count() - n0
            k8n += k8.launch_counts["quantized_matmul"]
            with prof.disable_capture():
                want, _ = serve_requests(pred, reqs)
            err = max(float(np.abs(g - w).max()) / float(np.abs(w).max())
                      for g, w in zip(got + more, want))
            assert err <= CAPTURE_LOGIT_TOL and new == 0, (name, b, err,
                                                          new)

            def requests(k, x=reqs[0]):
                for _ in range(k):
                    pred.run({"img": x})
                torch.cuda.synchronize()

            row[b] = exec_profiles(
                torch, prof, f"{name} ResNet-50 Predictor, batch {b}",
                {"captured": requests, "eager": requests},
                EXEC_PROFILE_STEPS,
                entry_stats(prof, pred._program, seq0), tag)
            row[b].update(logits_err=err, new_records=new)
            print(f"phase 32 {name} Predictor batch {b}: {EXEC_REQUESTS} "
                  f"requests captured vs eager, logits max |d| / max |eager| "
                  f"{err:.3g} (gate {CAPTURE_LOGIT_TOL}); ledger records "
                  f"after the first request: {new} {tag}")
        if name == "int8":
            want_k8 = EXEC_REQUESTS * len(RESNET_BATCHES)
            assert k8n == want_k8, (k8n, want_k8)
            row["k8_launches"] = k8n
            row["fc_ulps"] = exec_fc_check(torch, k8, pred,
                                           resnet_images(rng, 32,
                                                         image_size))
            print(f"phase 32 int8 Predictor: K8 launched {k8n} times over "
                  f"{want_k8} int8 requests (one a request, replays "
                  f"included); the replayed fc = plain K8 + bias within "
                  f"{row['fc_ulps']} ulp {tag}")
        out[name] = row
    del preds
    torch.cuda.empty_cache()
    return out


def exec_fc_check(torch, k8, pred, x32):
    """The int8 Predictor's fc, fetched under replay (the second run of
    that fetch list), against K8's plain version on its input + bias."""
    ops = pred._program.global_block().ops
    qmul = next(op for op in ops if op.type == "quantized_mul")
    add = next(op for op in ops if op.type == "elementwise_add"
               and op.inputs["X"] == qmul.outputs["Out"])
    for _ in range(2):
        served, fc_in = pred.run({"img": x32},
                                 fetch_list=[qmul.inputs["X"][0]])
    sc = pred._scope
    fc_x = torch.from_numpy(fc_in).cuda()
    plain = k8.dequant_matmul_reference(
        fc_x.reshape(fc_x.shape[0], -1), sc.get(qmul.inputs["Y"][0]),
        sc.get(qmul.inputs["YScale"][0]).reshape(-1),
        x_scale=qmul.attrs["x_scale"]) + sc.get(add.inputs["Y"][0])
    fc_ulps = ulps(torch, torch.from_numpy(served).cuda(), plain)
    assert fc_ulps <= 1, f"replayed fc vs plain K8 + bias: {fc_ulps} ulps"
    return fc_ulps


def exec_crnn(torch, prof, seed, tag):
    """Phase 32, CRNN-CTC at batch CRNN_BATCH (phase 29's programs): the
    training step (`exec_training`) and the test program, captured
    against eager from the same state: decoded ids, lengths and edit
    distances equal."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.models import crnn_ctc
    cfg = crnn_ctc.CRNNConfig()
    main, test, startup, names = crnn_programs(cfg, CRNN_BATCH, seed)
    feed = crnn_feed(torch, cfg, CRNN_BATCH, seed + 32, "cuda")
    row, exe, scope = exec_training(torch, prof, "crnn-ctc train",
                                    main, startup, feed, names["loss"], tag)
    fetch = [names[k] for k in ("decoded", "decoded_length", "distance")]
    got = [exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
           for _ in range(3)]
    with prof.disable_capture():
        want = Executor().run(test, feed=feed, fetch_list=fetch, scope=scope)
    equal = all(np.array_equal(a, b) for g in got for a, b in zip(g, want))
    print(f"phase 32 crnn-ctc test program: decoded ids, lengths and edit "
          f"distances of 3 captured runs (1 warm-up, 2 replays) "
          f"{'equal' if equal else 'DIFFER'} to the eager run's {tag}")
    assert equal, "crnn-ctc decode: captured differs from eager"

    def decodes(e):
        def run(k):
            for _ in range(k):
                e.run(test, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
            torch.cuda.synchronize()
        return run

    row["decode"] = exec_profiles(
        torch, prof, "crnn-ctc decode (test program)",
        {"captured": decodes(exe), "eager": decodes(Executor())},
        EXEC_PROFILE_STEPS, entry_stats(prof, test), tag)
    row["decode"]["equal"] = equal
    del scope
    torch.cuda.empty_cache()
    return row


def exec_mt_decode(torch, prof, control_flow, seed, tag):
    """Phase 32, the machine_translation While decode (phase 20's
    program, MT_DECODE_STEPS iterations) from the startup weights:
    captured (the plan's segments, the body one graph replayed an
    iteration) against eager, ids equal and the condition reads a run
    unchanged."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    _, startup, _ = mt_programs(seed)
    scope = Scope()
    Executor().run(startup, scope=scope)
    dec, dfetch = mt_decode_program()
    dfeed = {k: v for k, v in mt_batch(
        np.random.RandomState(seed + 32), MT_DECODE_BATCH).items()
        if k in ("src", "src_len")}
    res = {}
    for mode, exe in (("captured", Executor()), ("eager", Executor())):
        with (prof.disable_capture() if mode == "eager"
              else contextlib.nullcontext()):
            runs = []
            for _ in range(3):
                control_flow.reset_host_reads()
                runs.append((exe.run(dec, feed=dfeed, fetch_list=dfetch,
                                     scope=scope),
                             dict(control_flow.host_reads)))
        res[mode] = (runs, exe)
    (cruns, cexe), (eruns, eexe) = res["captured"], res["eager"]
    ids_equal = all(np.array_equal(c[0][0], eruns[0][0][0]) for c in cruns)
    reads = [(c[1]["while"], c[1]["while_iterations"]) for c in cruns]
    want_reads = (eruns[0][1]["while"], eruns[0][1]["while_iterations"])
    verdict = "equal" if ids_equal else "DIFFER"
    print(f"phase 32 mt While decode, batch {MT_DECODE_BATCH}, beam "
          f"{MT_BEAM}: ids of 3 captured runs {verdict} to the eager run's; "
          f"condition reads and iterations a run {reads} captured, "
          f"{want_reads} eager {tag}")
    assert ids_equal and all(r == want_reads for r in reads), (ids_equal,
                                                              reads)

    def decodes(e):
        def run(k):
            for _ in range(k):
                e.run(dec, feed=dfeed, fetch_list=dfetch, scope=scope,
                      return_numpy=False)
            torch.cuda.synchronize()
        return run

    stats = entry_stats(prof, dec)
    row = exec_profiles(torch, prof, "mt While decode",
                        {"captured": decodes(cexe),
                         "eager": decodes(eexe)}, EXEC_PROFILE_STEPS, stats,
                        tag)
    row.update(ids_equal=ids_equal, host_reads=reads)
    del scope
    torch.cuda.empty_cache()
    return row


def executor_phase(torch, seed, tag):
    """Phase 32: each Executor program of phases 12, 14, 16, 20 and 29
    captured against `disable_capture()` from the same state (see the
    module docstring)."""
    from paddle_tpu_torch.io import dataset, reader
    from paddle_tpu_torch.observability import profile as prof
    from paddle_tpu_torch.ops import control_flow
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    t0 = time.perf_counter()
    out = {}
    main, startup, _, _, loss = resnet_train_programs(seed)
    rng = np.random.RandomState(seed + 320)
    batch = {"img": resnet_images(rng, TRAIN_BATCH),
             "label": rng.randint(0, 1000, (TRAIN_BATCH, 1)).astype(
                 np.int64)}
    out["resnet50_train"], _, _ = exec_training(
        torch, prof, f"resnet-50 train, batch {TRAIN_BATCH}", main, startup,
        batch, loss, tag)
    torch.cuda.empty_cache()
    main, startup, _, _, loss, _ = vgg_programs(seed, True)
    samples = next(reader.batch(dataset.cifar.train10(VGG_BATCH),
                                VGG_BATCH)())
    feed = {"img": np.stack([s[0] for s in samples]),
            "label": np.stack([s[1] for s in samples]).reshape(-1, 1)}
    masks = [op.outputs["Mask"][0] for op in main.global_block().ops
             if op.type == "dropout"]
    out["vgg16_bn_train"], _, _ = exec_training(
        torch, prof, f"vgg-16-bn train (dropout), batch {VGG_BATCH}", main,
        startup, feed, loss, tag, masks=masks)
    torch.cuda.empty_cache()
    out["crnn_ctc"] = exec_crnn(torch, prof, seed, tag)
    out["predictors"] = exec_predictors(torch, prof, k8, seed, tag)
    out["mt_decode"] = exec_mt_decode(torch, prof, control_flow, seed, tag)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 32: {out['seconds']:.1f} s {tag}")
    return out


# ---------------------------------------------------------------------------
# phase 33: the serving front end on the card
# ---------------------------------------------------------------------------

#: phase 33's bucket ladder, replicas and traffic (clients x requests a
#: client, one row a request)
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
#: phase 33's ResNet-50 input side (phase 12's)
SERVE_IMAGE = 224
SERVE_REPLICAS = 2
SERVE_CLIENTS, SERVE_REQUESTS = 8, 32
#: a batched int8 response against the same row through the int8
#: Predictor alone: a batch's float32 convolutions may sum in another
#: order than batch 1's and move an activation across the rounding
#: boundary of its int8 code, so int8 rows are held to the phase-12
#: int8 gate's scale; f32 rows to LOGITS_TOL
SERVE_INT8_ROW_TOL = 1e-2
#: the swap window's clients pause this long between requests: at full
#: load the 18 busy threads of one process starve the prewarm's eager
#: warm-ups of the GIL (27 s to prewarm the int8 ladder unpaced, H100
#: 80GB HBM3)
SERVE_SWAP_PACE_S = 0.002
#: phase 33's generation: requests and new tokens each (phase 3's
#: prompts, budgets cut to this)
SERVE_GEN_REQUESTS, SERVE_GEN_TOKENS = 5, 24


def _row_err(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _traffic(client_cls, host, port, images, clients, per_client,
             on_start=None, until=None, pace_s=0.0, model="resnet50"):
    """`clients` threads, each with its own PTGW connection, send
    `per_client` one-row requests of `images` (thread c takes rows
    c, c + clients, ...), `pace_s` apart, and go on while `until()` is
    false. Returns (per request: (row, output, version, wall seconds,
    start, end)), errors)."""
    import threading
    out, errors = [], []
    lock = threading.Lock()
    started = threading.Barrier(clients + 1)

    def run(c):
        try:
            with client_cls(host, port, tenant=f"c{c}",
                            timeout_s=120.0) as cli:
                started.wait()
                k = 0
                while k < per_client or (until is not None and not until()):
                    row = (c + k * clients) % len(images)
                    k += 1
                    t0 = time.perf_counter()
                    outs, resp = cli.infer(model,
                                           {"img": images[row:row + 1]})
                    t1 = time.perf_counter()
                    with lock:
                        out.append((row, outs[0], resp["version"], t1 - t0,
                                    t0, t1))
                    if pace_s:
                        time.sleep(pace_s)
        except Exception as e:           # every request must complete
            with lock:
                errors.append(f"client {c}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    started.wait()
    if on_start is not None:
        on_start()
    for t in threads:
        t.join(600)
    return out, errors


def _gen_launches(da, kname, before, after, layers):
    """Launch counts of K6's or K7's two routes over a window of a paged
    GenerationServer with spec_k = 0: the chunk route once per layer on
    every admission, the decode route once per layer on every tick."""
    chunk = CHUNK_ROUTES[kname]
    steps = after["counters"]["steps"] - before["counters"]["steps"]
    refills = after["counters"]["refills"] - before["counters"]["refills"]
    pre = da.launch_counts[chunk]
    dec = da.launch_counts[kname] - pre
    assert pre == layers * refills > 0, (kname, pre, refills)
    assert dec == layers * steps > 0, (kname, dec, steps)
    return {chunk: pre, kname: dec, "ticks": steps, "admissions": refills}


def serving_generation(torch, gen, seed, tag):
    """Phase 33(h): a GenerationServer over PagedDecodeEngine at phase
    3's GPT-2-small widths behind the gateway, int8 pools (K7) then f32
    pools (K6): SERVE_GEN_REQUESTS of phase 3's prompts in process, then
    over the wire (four concurrent PTGW streams and one chunked HTTP
    stream), tokens against single-request greedy references under the
    near-tie rule, the routes' launches counted over the wire window."""
    import threading
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.serving import GatewayClient, ServingGateway, wire
    from paddle_tpu_torch.serving.generation import GenerationServer
    cfg = gen.LMConfig(**GPT2_SMALL)
    model = gen.TinyDecoderLM(cfg).init_params(seed)
    rng = np.random.RandomState(seed)
    prompts, budgets = make_prompts(rng, cfg.vocab_size, 16)
    prompts = prompts[:SERVE_GEN_REQUESTS]
    budgets = [min(b, SERVE_GEN_TOKENS) for b in budgets][
        :SERVE_GEN_REQUESTS]
    out, launches = {}, {}
    for kv, kname in (("int8", "quantized_paged_decode_attention"),
                      ("f32", "paged_decode_attention")):
        t0 = time.perf_counter()
        refs, gaps, _ = paged_greedy(gen, model, prompts, budgets, kv)
        ref_s = time.perf_counter() - t0
        eng = gen.PagedDecodeEngine(model, batch_size=8, max_len=1024,
                                    block_size=8, spec_k=0, kv_dtype=kv)
        eng.warmup()
        srv = GenerationServer(eng)
        gw = ServingGateway(read_timeout_s=600.0, write_timeout_s=60.0)
        gw.deploy_generator("gpt2", srv)
        host, port = gw.start()
        try:
            reqs = [srv.submit(p, n) for p, n in zip(prompts, budgets)]
            local = [r.result(timeout=600)["tokens"] for r in reqs]
            near = sum(compare(f"phase 33 {kv} in-process request {i}", t,
                               r, g) for i, (t, r, g) in
                       enumerate(zip(local, refs, gaps)))
            before = srv.stats()
            da.reset_launch_counts()
            got = [None] * len(prompts)

            def stream(i):
                with GatewayClient(host, port, timeout_s=600.0) as c:
                    got[i] = c.generate("gpt2", prompts[i], budgets[i])[
                        "tokens"]

            t0 = time.perf_counter()
            threads = [threading.Thread(target=stream, args=(i,))
                       for i in range(len(prompts) - 1)]
            for t in threads:
                t.start()
            chunks = _http_stream(wire, host, port, prompts[-1],
                                  budgets[-1])
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            after = srv.stats()
            row = _gen_launches(da, kname, before, after, cfg.num_layers)
            got[-1] = chunks[-1]["tokens"]
            assert [c["token"] for c in chunks[:-1]] == got[-1], chunks
            assert all(g is not None for g in got), got
            near += sum(compare(f"phase 33 {kv} wire request {i}", t, r, g)
                        for i, (t, r, g) in enumerate(zip(got, refs, gaps)))
        finally:
            gw.shutdown(timeout_s=60.0)
        for k in (kname, CHUNK_ROUTES[kname]):
            launches[k] = row[k]
        n_tok = sum(map(len, got))
        out[kv] = dict(row, tokens=n_tok, wall_s=wall,
                       tokens_per_s=n_tok / wall, near_ties=near,
                       reference_s=ref_s,
                       wire_equals_in_process=got == local)
        print(f"phase 33(h) generation, {kv} pools, over the gateway: "
              f"{len(prompts) - 1} PTGW streams + 1 chunked HTTP, "
              f"{n_tok} tokens in {wall:.2f} s ({n_tok / wall:.1f} "
              f"tokens/s); tokens equal the single-request references "
              f"(near-ties {near}), wire == in-process: "
              f"{got == local}; {kname} decode route {row[kname]} over "
              f"{row['ticks']} ticks, {CHUNK_ROUTES[kname]} "
              f"{row[CHUNK_ROUTES[kname]]} over {row['admissions']} "
              f"admissions ({cfg.num_layers} layers) {tag}")
        del eng, srv
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return out, launches


def _http_stream(wire, host, port, prompt, n):
    """POST /v1/models/gpt2:generate: the chunked stream's JSON lines."""
    import socket
    with socket.create_connection((host, port), timeout=600) as s:
        body = json.dumps({"inputs": [int(t) for t in prompt],
                           "max_new_tokens": int(n)}).encode()
        s.sendall(f"POST /v1/models/gpt2:generate HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(4096)
            assert chunk, "connection closed before the response head"
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200"), head

        class _Sock:
            pre = rest

            def recv(self, k):
                if self.pre:
                    got, self.pre = self.pre, b""
                    return got
                return s.recv(k)

        return list(wire.iter_http_chunks(_Sock()))


def serving_phase(torch, gen, seed, tag):
    """Phase 33: the serving front end on the card (see the module
    docstring). Returns (results, launches by kernel over the gateway
    windows)."""
    import shutil
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.analysis import planner
    from paddle_tpu_torch.core import compile_cache, flags, ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models.resnet import build_static
    from paddle_tpu_torch.observability import profile as prof
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    from paddle_tpu_torch.serving import (
        GatewayClient, InferenceServer, ModelRegistry, ServingGateway, wire)
    from paddle_tpu_torch.serving.registry import SwapError
    t_phase = time.perf_counter()
    out = {}
    rng = np.random.RandomState(seed + 33)
    cache_dir = tempfile.mkdtemp(prefix="phase33_cache_")
    model_dir = tempfile.mkdtemp(prefix="phase33_resnet50_")
    flags.set_flag("compile_cache_dir", cache_dir)
    compile_cache.reset_compile_cache()
    gw = None
    try:
        # (a) phase 12's ResNet-50, saved; f32 and int8 (PTQ) Predictors
        ir.reset_unique_names()
        main, startup = ir.Program(), ir.Program()
        startup.random_seed = seed
        with ir.program_guard(main, startup):
            img = static.data("img", [3, SERVE_IMAGE, SERVE_IMAGE],
                              "float32")
            label = static.data("label", [1], "int64")
            logits, _, _ = build_static(img, label, depth=50)
        exe = Executor()
        with scope_guard(Scope()):
            exe.run(startup)
            static.io.save_inference_model(model_dir, ["img"], [logits],
                                           exe, main_program=main)
        f32 = inference.create_predictor(inference.Config(model_dir))
        cfg8 = inference.Config(model_dir)
        cfg8.enable_int8([{"img": resnet_images(rng, 8, SERVE_IMAGE)}
                          for _ in range(4)])
        int8 = inference.create_predictor(cfg8)
        images = resnet_images(rng, SERVE_CLIENTS * SERVE_REQUESTS,
                               SERVE_IMAGE)
        ex = {"img": images[:1]}

        # (b) v1 = f32 behind the gateway, the ladder captured in warmup
        registry = ModelRegistry(num_replicas=SERVE_REPLICAS,
                                 buckets=list(SERVE_BUCKETS),
                                 max_wait_ms=2.0, max_queue=1024,
                                 drain_timeout_s=120.0)
        gw = ServingGateway(registry=registry, read_timeout_s=600.0,
                            write_timeout_s=60.0, max_in_flight=4096)
        ledger = prof.compile_ledger()
        entry = registry.deploy("resnet50", "v1", f32, prewarm_feed=ex,
                                tier="fp32")
        v1 = registry.resolve("resnet50").server
        caps = {e.key: e.compile_s for e in ledger.entries(
            scope=v1.ledger_scope, kind="graph")}
        assert sorted(caps) == sorted(f"bucket{b}" for b in SERVE_BUCKETS), \
            caps
        out["ladder_capture"] = {"prewarm_s": entry["prewarm_s"],
                                 "per_bucket_s": caps}
        print(f"phase 33(b) v1 (f32) ladder {list(SERVE_BUCKETS)} captured "
              f"in warmup: {entry['prewarm_s']:.2f} s; per bucket (warm-up "
              f"+ capture) {json.dumps({k: round(v, 3) for k, v in caps.items()})} "
              f"{tag}")
        legs = planner.cross_check()["legs"]
        out["cross_check_f32"] = [
            {"bucket": g["detail"]["bucket"], "estimate": g["estimate_bytes"],
             "measured": g["measured_bytes"], "ratio": g["ratio"],
             "status": g["status"]}
            for g in legs if g["scope"] == v1.ledger_scope]
        host, port = gw.start()

        # (c) the serial reference: each row through the f32 Predictor
        ref = f32.clone()
        secs, f32_rows = [], []
        for i in range(len(images)):
            t0 = time.perf_counter()
            f32_rows.append(ref.run(feed={"img": images[i:i + 1]})[0])
            secs.append(time.perf_counter() - t0)
        serial_p50 = float(np.median(secs)) * 1e3

        # (d) traffic: 8 clients x 32 one-row requests over PTGW
        n0 = len(ledger.compile_events())
        st0 = v1.stats()
        got, errors = _traffic(GatewayClient, host, port, images,
                               SERVE_CLIENTS, SERVE_REQUESTS)
        assert not errors, errors[:3]
        assert len(got) == SERVE_CLIENTS * SERVE_REQUESTS
        new = len(ledger.compile_events()) - n0
        assert new == 0, f"{new} captures during traffic"
        err = max(_row_err(o, f32_rows[r]) for r, o, *_ in got)
        assert err <= LOGITS_TOL, err
        st1 = v1.stats()
        lat = np.asarray([g[3] for g in got]) * 1e3
        per_bucket = {b: st1["batches"]["per_bucket"].get(b, 0)
                      - st0["batches"]["per_bucket"].get(b, 0)
                      for b in SERVE_BUCKETS}
        wall = max(g[5] for g in got) - min(g[4] for g in got)
        out["traffic"] = {
            "requests": len(got), "p50_ms": float(np.median(lat)),
            "p99_ms": float(np.percentile(lat, 99)),
            "rows_per_s": len(got) / wall,
            "serial_p50_ms": serial_p50, "max_row_err": err,
            "server_p50_ms": st1["latency_ms"]["p50"],
            "batch_exec_p50_ms": st1["batches"]["exec_ms_p50"],
            "batches_per_bucket": per_bucket,
            "mean_occupancy": st1["batches"]["mean_occupancy"],
            "captures_during_traffic": new}
        print(f"phase 33(d) {SERVE_CLIENTS} PTGW clients x "
              f"{SERVE_REQUESTS} one-row requests to v1 (f32): wire p50 "
              f"{out['traffic']['p50_ms']:.2f} ms, p99 "
              f"{out['traffic']['p99_ms']:.2f} ms, "
              f"{out['traffic']['rows_per_s']:.1f} rows/s (in the server: "
              f"submit to answer p50 {st1['latency_ms']['p50']:.2f} ms, a "
              f"batch's run p50 {st1['batches']['exec_ms_p50']:.2f} ms); "
              f"serial Predictor.run p50 {serial_p50:.2f} ms at batch 1; "
              f"batches "
              f"per bucket {per_bucket}, mean occupancy "
              f"{st1['batches']['mean_occupancy']:.3f}; rows vs serial "
              f"max |d| / max |ref| {err:.3g} (gate {LOGITS_TOL}); "
              f"captures during traffic {new} {tag}")

        # (e) hot swap to v2 = int8 under the same traffic
        gate = prof.capture_gate()
        gate.reset_stats()
        swap = {}

        def do_swap():
            time.sleep(0.05)
            try:
                swap.update(registry.deploy(
                    "resnet50", "v2", int8, prewarm_feed=ex, tier="int8",
                    quality_gate={"feed": {"img": images[:3]},
                                  "reference": f32.clone(),
                                  "threshold": INT8_FIDELITY_GATE}))
            except Exception as e:
                swap["error"] = f"{type(e).__name__}: {e}"

        import threading
        swapper = threading.Thread(target=do_swap)
        swapped = []

        def after_swap():
            # traffic goes on past the cutover: 0.2 s after the deploy
            # returned, every client stops
            if swapper.is_alive():
                return False
            swapped.append(time.perf_counter())
            return swapped[-1] - swapped[0] > 0.2

        got, errors = _traffic(GatewayClient, host, port, images,
                               SERVE_CLIENTS, SERVE_REQUESTS,
                               on_start=swapper.start, until=after_swap,
                               pace_s=SERVE_SWAP_PACE_S)
        swapper.join(600)
        assert swap.get("ok") and swap["replaced"] == "v1", swap
        assert not errors, errors[:3]
        assert len(got) >= SERVE_CLIENTS * SERVE_REQUESTS
        pause = gate.stats()
        v2 = registry.resolve("resnet50").server
        int8_ref = int8.clone()
        # the response's "version" names the active version when the
        # answer is written (the JAX gateway's rule), so a request in
        # flight at the cutover computed by v1 may say v2: each row is
        # held to whichever version's serial run it matches, and must
        # match one
        by_version, labels, int8_rows = {}, {}, {}
        worst = {"v1": 0.0, "v2": 0.0}
        for r, o, version, *_ in got:
            labels[version] = labels.get(version, 0) + 1
            if r not in int8_rows:
                int8_rows[r] = int8_ref.run(
                    feed={"img": images[r:r + 1]})[0]
            e1, e2 = _row_err(o, f32_rows[r]), _row_err(o, int8_rows[r])
            computed = "v1" if e1 <= LOGITS_TOL else "v2"
            err = e1 if computed == "v1" else e2
            assert err <= (LOGITS_TOL if computed == "v1"
                           else SERVE_INT8_ROW_TOL), (r, version, e1, e2)
            by_version[computed] = by_version.get(computed, 0) + 1
            worst[computed] = max(worst[computed], err)
        assert by_version.get("v1") and by_version.get("v2"), by_version
        lat = np.asarray([g[3] for g in got]) * 1e3
        legs = planner.cross_check()["legs"]
        out["cross_check_int8"] = [
            {"bucket": g["detail"]["bucket"], "estimate": g["estimate_bytes"],
             "measured": g["measured_bytes"], "ratio": g["ratio"],
             "status": g["status"]}
            for g in legs if g["scope"] == v2.ledger_scope]
        out["swap"] = {
            "requests": len(got), "failed": 0, "by_version": by_version,
            "labels": labels,
            "max_row_err": worst, "prewarm_s": swap["prewarm_s"],
            "quality_rel_err": swap["quality_rel_err"],
            "drain_report": swap["drain_report"], "gate": pause,
            "p50_ms": float(np.median(lat)), "max_ms": float(lat.max())}
        print(f"phase 33(e) hot swap v1 (f32) -> v2 (int8) under "
              f"{SERVE_CLIENTS} clients x {SERVE_REQUESTS}: {len(got)} "
              f"requests, 0 failed, computed by {by_version} (labelled "
              f"{labels}); rows vs that version's serial run {worst} "
              f"(gates f32 "
              f"{LOGITS_TOL}, int8 {SERVE_INT8_ROW_TOL}); quality gate "
              f"rel err {swap['quality_rel_err']:.4f} (threshold "
              f"{INT8_FIDELITY_GATE}); prewarm {swap['prewarm_s']:.2f} s; "
              f"traffic paused at the capture gate {pause['shared_waits']} "
              f"times, longest {pause['max_shared_wait_s'] * 1e3:.1f} ms, "
              f"{pause['captures']} captures held it "
              f"{pause['held_s'] * 1e3:.1f} ms in all (longest "
              f"{pause['max_held_s'] * 1e3:.1f} ms); request latency p50 "
              f"{out['swap']['p50_ms']:.2f} ms, max "
              f"{out['swap']['max_ms']:.2f} ms; v1 drained "
              f"{swap['drain_report']} {tag}")

        # K8 in the int8 requests' graphs: launches counted over a burst
        stb = v2.stats()["batches"]["count"]
        k8.reset_launch_counts()
        got, errors = _traffic(GatewayClient, host, port, images,
                               SERVE_CLIENTS, 8)
        assert not errors, errors[:3]
        batches = v2.stats()["batches"]["count"] - stb
        k8n = k8.launch_counts["quantized_matmul"]
        assert k8n == batches > 0, (k8n, batches)
        assert all(g[2] == "v2" for g in got)
        out["k8_gateway"] = {"launches": k8n, "batches": batches,
                             "requests": len(got)}
        print(f"phase 33(e) K8 over the gateway: {k8n} launches for "
              f"{batches} int8 batches ({len(got)} requests; the fc's "
              f"quantized_mul, one launch a replay) {tag}")

        # (f) the fit gate refuses a deploy at 1 MiB; v2 keeps serving
        try:
            registry.deploy("resnet50", "v3",
                            inference.create_predictor(
                                inference.Config(model_dir)),
                            hbm_budget_bytes=1 << 20)
        except SwapError as e:
            refusal = {"stage": e.stage, "error": str(e)[:160]}
        else:
            raise AssertionError("a 1 MiB budget did not refuse the deploy")
        assert refusal["stage"] == "verify" and \
            "model-does-not-fit" in refusal["error"], refusal
        with GatewayClient(host, port) as c:
            _, resp = c.infer("resnet50", {"img": images[:1]})
        assert resp["version"] == "v2", resp
        out["refusal"] = refusal
        print(f"phase 33(f) deploy of v3 with hbm_budget_bytes 1 MiB "
              f"refused at stage {refusal['stage']!r} "
              f"(model-does-not-fit); v2 still serving {tag}")

        # (g) warm start: a second server over a fresh f32 Predictor
        # restores v1's ladder from the manifest before traffic
        fresh = InferenceServer(
            inference.create_predictor(inference.Config(model_dir)),
            buckets=list(SERVE_BUCKETS), max_wait_ms=2.0)
        try:
            t0 = time.perf_counter()
            fresh.warmup(ex)
            warm_s = time.perf_counter() - t0
            ws = fresh.stats()["warm_start"]
            assert ws["found"] and ws["loaded"] == len(SERVE_BUCKETS) == \
                ws["captured"], ws
            paid = ledger.compile_events(scope=fresh.ledger_scope)
            assert paid == [], [e.key for e in paid]
            n0 = ledger.count()
            first = fresh.infer({"img": images[:3]}, timeout_ms=60000)[0]
            assert ledger.count() == n0, "the first request captured"
            werr = max(_row_err(first[i], f32_rows[i]) for i in range(3))
            assert werr <= LOGITS_TOL, werr
        finally:
            fresh.shutdown(timeout=60)
        out["warm_start"] = dict(ws, warmup_s=warm_s, row_err=werr)
        print(f"phase 33(g) warm start: manifest {ws['manifest']} found, "
              f"{ws['loaded']} of {ws['requested']} entries loaded and "
              f"captured before traffic in {warm_s:.2f} s (cache hits, no "
              f"capture paid); first request captured nothing, rows vs "
              f"serial {werr:.3g} {tag}")

        # the planner's estimates against the captures' peaks
        for label, key in (("f32", "cross_check_f32"),
                           ("int8", "cross_check_int8")):
            text = ", ".join(
                f"b{g['bucket']}: {g['estimate']} vs "
                f"{None if g['measured'] is None else int(g['measured'])} "
                f"({g['ratio']}, {g['status']})"
                for g in sorted(out[key], key=lambda g: g["bucket"]))
            print(f"phase 33 cross-check {label} (capture-peak estimate vs "
                  f"measured capture peak, bytes; tolerance 0.25): {text} "
                  f"{tag}")

        st, health, _ = wire.http_request(host, port, "GET", "/healthz")
        st2, slo, _ = wire.http_request(host, port, "GET", "/slo")
        assert st == 200 and health["status"] in ("healthy", "degraded"), \
            health
        assert st2 == 200, slo
        out["healthz"] = {"status": health["status"],
                          "score": health["score"],
                          "models": {n: m["verdict"] for n, m in
                                     health["models"].items()}}
        out["slo"] = {"firing": slo["firing"], "error_budget_remaining": {
            n: s.get("error_budget_remaining")
            for n, s in slo["slos"].items()}}
        print(f"phase 33 /healthz {st}: {json.dumps(out['healthz'])}; /slo "
              f"{st2}: {json.dumps(out['slo'])} {tag}")
    finally:
        if gw is not None:
            gw.shutdown(timeout_s=120.0)
        flags.set_flag("compile_cache_dir", "")
        compile_cache.reset_compile_cache()
        shutil.rmtree(model_dir, ignore_errors=True)
        shutil.rmtree(cache_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {"quantized_matmul": out["k8_gateway"]["launches"]}

    # (h) streamed generation over the gateway (K7, then K6)
    out["generation"], gen_launches = serving_generation(torch, gen, seed,
                                                        tag)
    launches.update(gen_launches)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 33: {out['seconds']:.1f} s; gateway launches {launches} "
          f"{tag}")
    return out, launches


#: phase 34's fc stack (tools/fleet_bench.py::build_mlp's shape: a flat
#: `x`, fc + relu layers, a softmax over 10), at MNIST's input width
FLEET_MLP_IN, FLEET_MLP_HIDDEN, FLEET_MLP_LAYERS = 784, 1024, 4
FLEET_BUCKETS = (1, 2, 4, 8)
#: concurrent generate streams and their new tokens; the backend-death
#: stream's budget (long enough that the SIGKILL lands mid-stream)
FLEET_STREAMS, FLEET_TOKENS, FLEET_KILL_TOKENS = 4, 32, 64
#: GPT-2-small prompts of 16..128 tokens, none sharing a block
FLEET_PROMPT_LEN = (16, 129)
#: the routers' wire-latency SLO threshold: a stream that takes longer
#: is a bad event, so a burst of streams burns the page rule
FLEET_SLO_THRESHOLD_S = 0.05
#: liveness: backend beats, the routers' directory edges, the standby's
#: watch of the active
FLEET_BEAT_S, FLEET_SUSPECT_S, FLEET_LOST_S = 0.1, 0.5, 1.5
FLEET_MONITOR = dict(beat_interval_s=0.05, monitor_suspect_after_s=0.2,
                     monitor_lost_after_s=0.4)
#: where the backends run (None: the card; a CPU rehearsal sets "cpu")
FLEET_BACKEND_DEVICE = None
#: phase 35: steps, the checkpoint interval and the crash step; phase
#: 14's batch and image side; the worker's device (None: the card)
FT_STEPS, FT_SAVE_EVERY, FT_CRASH_AT = 12, 4, 8
FT_BATCH, FT_IMAGE, FT_DEVICE = TRAIN_BATCH, 224, None


def fleet_warm_check(ws):
    """A backend spawned after the first restored both ladders from the
    shared cache's manifests: every listed entry loaded and captured
    before traffic (the Predictor's: one per bucket)."""
    model, lm = ws["model"], ws["generator"]
    assert model["found"] and model["loaded"] == model["captured"] == \
        len(FLEET_BUCKETS), ws
    assert lm["found"] and lm["loaded"] == lm["captured"] == \
        lm["requested"] > 0, ws


def fleet_mlp(static, ir, Executor, mdir, seed):
    """The fc stack, initialised on the card from `seed` and saved with
    save_inference_model (feed `x`, target the softmax)."""
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        x = static.data("x", [FLEET_MLP_IN], "float32")
        h = x
        for _ in range(FLEET_MLP_LAYERS):
            h = static.fc(h, FLEET_MLP_HIDDEN, act="relu")
        out = static.fc(h, 10, act="softmax")
    exe = Executor()
    exe.run(startup)
    static.io.save_inference_model(mdir, ["x"], [out], exe,
                                   main_program=main)
    return mdir


def _free_ports(n):
    """`n` free TCP ports on 127.0.0.1 (bound together, then released)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def _http_json(wire, addr, path):
    status, doc, _ = wire.http_request(addr[0], addr[1], "GET", path,
                                       timeout=10.0)
    return status, doc


def _wait_for(cond, timeout_s, what, poll=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(poll)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")


def _live_on(wire, addr, names):
    """The router at `addr` holds every one of `names` LIVE."""
    status, doc = _http_json(wire, addr, "/fleet")
    backends = (doc or {}).get("directory", {}).get("backends", {})
    return all(backends.get(n, {}).get("state") == "LIVE" for n in names)


class _InferLoad:
    """One PTGW client (endpoints = the HA pair, a patient retry policy)
    sending one-row infer requests `pace_s` apart until stopped; each
    answer is kept with its row for the comparison with the serial
    Predictor."""

    def __init__(self, wire, RetryPolicy, endpoints, xs, pace_s=0.01):
        import threading
        self.wire, self.endpoints, self.xs = wire, endpoints, xs
        self.retry = RetryPolicy(max_attempts=60, base_delay=0.05,
                                 max_delay=0.3, jitter=0.2, deadline=60.0)
        self.pace_s = pace_s
        self.rows, self.failed, self.errors = [], 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        with self.wire.GatewayClient(*self.endpoints[0],
                                     endpoints=self.endpoints,
                                     timeout_s=60.0,
                                     retry_policy=self.retry) as c:
            k = 0
            while not self._stop.is_set():
                i = k % len(self.xs)
                k += 1
                try:
                    outs, _ = c.infer("m", {"x": self.xs[i:i + 1]})
                    self.rows.append((i, np.asarray(outs[0])))
                except Exception as e:       # counted: the gate is 0
                    self.failed += 1
                    self.errors.append(f"{type(e).__name__}: {e}")
                time.sleep(self.pace_s)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(120)
        return self


def _stream(wire, endpoints, prompt, n, session, on_token=None):
    """One generate stream through the HA pair: (tokens as the callback
    saw them, their indices, the end frame)."""
    toks, idxs = [], []

    def cb(t, i):
        toks.append(int(t))
        idxs.append(int(i))
        if on_token is not None:
            on_token(len(toks))

    with wire.GatewayClient(*endpoints[0], endpoints=endpoints,
                            timeout_s=300.0) as c:
        end = c.generate("gpt2", [int(t) for t in prompt], n,
                         session=session, on_token=cb)
    return toks, idxs, end


def _check_stream(label, got, ref, gaps):
    toks, idxs, end = got
    assert idxs == list(range(len(toks))), (label, idxs)
    assert [int(t) for t in end["tokens"]] == toks, (label, end, toks)
    return compare(label, toks, ref, gaps)


def _timings(doc):
    return ", ".join(f"{k[:-2]} {v:.1f}" for k, v in
                     sorted(doc["timings"].items()))


def _page_alerts(wire, addr):
    """The page alerts the router at `addr` has firing, as the
    SloEngine's fire events."""
    try:
        _, doc = _http_json(wire, addr, "/slo")
    except (OSError, wire.WireError, ValueError):
        return []                # a dead router has no alerts to relay
    return [{"event": "fire", "slo": a["slo"], "rule": a["rule"],
             "severity": a["severity"], "t": time.monotonic()}
            for a in (doc or {}).get("firing", ())
            if a.get("severity") == "page"]


def fleet_phase(torch, gen, seed, tag):
    """Phase 34: the fleet on the card (see the module docstring).
    Returns (results, K7's launches on the fleet path by kernel)."""
    import shutil
    import threading
    from paddle_tpu_torch import fleet, inference, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.fleet.ha import RouterProcess
    from paddle_tpu_torch.reliability.retry import RetryPolicy
    from paddle_tpu_torch.serving import wire

    t_phase = time.perf_counter()
    cfg = gen.LMConfig(**GPT2_SMALL)
    tmp = tempfile.mkdtemp(prefix="pt_fleet_")
    out = {}
    routers, manager, loads = [], None, []
    saved_env = {k: os.environ.get(k) for k in
                 ("PT_FLAGS_compile_cache_dir",
                  "PT_FLAGS_slo_wire_p99_threshold_s")}
    try:
        # the served fc stack and its serial answers
        ir.reset_unique_names()
        mdir = fleet_mlp(static, ir, Executor, os.path.join(tmp, "mlp"),
                         seed)
        rng = np.random.RandomState(seed + 34)
        xs = rng.rand(16, FLEET_MLP_IN).astype(np.float32)
        pred = inference.create_predictor(inference.Config(mdir))
        want_rows = [pred.run({"x": xs[i:i + 1]})[0] for i in range(16)]
        del pred
        # the HA pair, each a child process; backends share the cache
        cache, snap = os.path.join(tmp, "cache"), os.path.join(tmp, "snap")
        os.environ["PT_FLAGS_compile_cache_dir"] = cache
        os.environ["PT_FLAGS_slo_wire_p99_threshold_s"] = str(
            FLEET_SLO_THRESHOLD_S)
        common = {"snapshot_dir": snap, "suspect_after_s": FLEET_SUSPECT_S,
                  "lost_after_s": FLEET_LOST_S, "poll_interval_s": 0.5}
        # ports picked here, so the routers and the first backend start
        # together (a backend's heartbeater dials until its routers are up)
        a_addr, s_addr = [("127.0.0.1", p) for p in _free_ports(2)]
        endpoints = [a_addr, s_addr]
        active = RouterProcess(dict(common, name="r-active", epoch=1,
                                    port=a_addr[1])).start()
        routers.append(active)
        standby = RouterProcess(dict(common, **FLEET_MONITOR,
                                     name="r-standby", standby=True,
                                     port=s_addr[1],
                                     active=list(a_addr))).start()
        routers.append(standby)

        # the parent's control plane: a directory of what it spawned,
        # snapshotted with the autoscaler's state, the manager, the
        # autoscaler (its page alerts relayed from the routers' /slo)
        directory = fleet.FleetDirectory(suspect_after_s=3600.0,
                                         lost_after_s=7200.0)
        store = fleet.DirectoryStore(os.path.join(tmp, "control"))
        directory.attach_store(store)
        gen_spec = dict(GPT2_SMALL, seed=seed, slots=8, paged=True,
                        block_size=8, spec_k=0, kv_dtype="int8",
                        name="gpt2")

        def spec_factory(name):
            spec = {"model": {"kind": "model_dir", "dir": mdir},
                    "buckets": list(FLEET_BUCKETS),
                    "in_dim": FLEET_MLP_IN, "read_timeout_s": 600.0,
                    "heartbeat_interval_s": FLEET_BEAT_S,
                    "hbm_budget_bytes": 8 << 30,
                    "router": list(a_addr), "generator": dict(gen_spec)}
            if FLEET_BACKEND_DEVICE is not None:
                spec["device"] = FLEET_BACKEND_DEVICE
            return spec

        manager = fleet.FleetManager(directory, spec_factory,
                                     routers=[s_addr],
                                     spawn_timeout_s=300.0)
        scaler = fleet.FleetAutoscaler(manager, slo_engine=None,
                                       min_backends=1, max_backends=3,
                                       cooldown_s=600.0,
                                       quiet_after_s=1e9,
                                       spawn_async=False)
        directory.extra_state("autoscaler", scaler.export_state)

        # (a) spawn and warm start: b1 starts with the routers and the
        # references are made meanwhile; b2 restores b1's manifests
        t_spawn = time.perf_counter()
        h1 = manager.spawn("b1", wait=False)
        # the int8 single-request references of every stream
        t0 = time.perf_counter()
        model = gen.TinyDecoderLM(cfg).init_params(seed)
        n_prompts = 2 * FLEET_STREAMS + 2
        prompts = [rng.randint(0, cfg.vocab_size,
                               size=rng.randint(*FLEET_PROMPT_LEN)
                               ).astype(np.int32) for _ in range(n_prompts)]
        budgets = [FLEET_TOKENS] * n_prompts
        budgets[-2] = FLEET_KILL_TOKENS
        refs, gaps, _ = paged_greedy(gen, model, prompts, budgets, "int8")
        del model
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t0

        assert active.wait_ready(120) == a_addr
        assert standby.wait_ready(120) == s_addr
        directory.announce("b1", h1.wait_ready(300),
                           meta={"pid": h1.pid})
        spawned = {"b1": h1.ready_doc,
                   "b2": manager.spawn("b2").ready_doc}
        spawn_s = time.perf_counter() - t_spawn
        _wait_for(lambda: _live_on(wire, a_addr, ["b1", "b2"])
                  and _live_on(wire, s_addr, ["b1", "b2"]), 30,
                  "b1 and b2 LIVE on both routers")
        fleet_warm_check(spawned["b2"]["warm_start"])
        for name, doc in spawned.items():
            print(f"phase 34(a) {name}: spawn-to-READY "
                  f"{doc['t_ready_s']:.2f} s ({_timings(doc)}), captures "
                  f"paid {doc['compiles_paid']}, warm start model "
                  f"{doc['warm_start']['model']}, generator "
                  f"{doc['warm_start']['generator']} {tag}")
        print(f"phase 34(a) routers, b1 and the references, then b2: "
              f"{spawn_s:.1f} s (references {ref_s:.1f} s) {tag}")
        out["spawn"] = {n: {"ready_s": d["t_ready_s"],
                            "timings": d["timings"],
                            "captures_paid": d["compiles_paid"],
                            "warm_start": d["warm_start"]}
                        for n, d in spawned.items()}
        out["spawn_s"] = spawn_s

        # (b) traffic through the active router
        loads = [_InferLoad(wire, RetryPolicy, endpoints, xs).start()]
        ring = fleet.HashRing()
        ring.rebuild(["b1", "b2"])
        sessions = [f"s{i}" for i in range(FLEET_STREAMS)]
        got = [None] * FLEET_STREAMS

        def run(i):
            got[i] = _stream(wire, endpoints, prompts[i], budgets[i],
                             sessions[i])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(FLEET_STREAMS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        streams_s = time.perf_counter() - t0
        near = sum(_check_stream(f"phase 34(b) stream {i}", got[i],
                                 refs[i], gaps[i])
                   for i in range(FLEET_STREAMS))
        # affinity: a session's second stream goes where its first went
        addrs = {n: tuple(directory.get(n)["address"])
                 for n in ("b1", "b2")}

        def gen_requests():
            return {n: _http_json(wire, a, "/stats")[1]["counters"][
                "gen_requests"] for n, a in addrs.items()}

        for i in range(2):
            pre = gen_requests()
            again = _stream(wire, endpoints, prompts[i], budgets[i],
                            sessions[i])
            post = gen_requests()
            moved = {n: post[n] - pre[n] for n in addrs}
            want = ring.lookup(sessions[i])
            assert moved[want] == 1 and sum(moved.values()) == 1, (
                sessions[i], want, moved)
            near += _check_stream(f"phase 34(b) stream {i} again", again,
                                  refs[i], gaps[i])
        print(f"phase 34(b) traffic: {FLEET_STREAMS} concurrent streams "
              f"of {FLEET_TOKENS} tokens in {streams_s:.2f} s, tokens equal "
              f"the int8 references (near-ties {near}), sessions "
              f"{sessions[:2]} on their ring backends "
              f"{[ring.lookup(s) for s in sessions[:2]]} {tag}")

        # (c) backend death mid-stream
        victim_session = next(f"k{i}" for i in range(64)
                              if ring.lookup(f"k{i}") == "b1")
        kill_at, arrived = {}, []

        def on_token(n):
            arrived.append(time.monotonic())
            if n == 3 and "t" not in kill_at:
                manager.kill("b1")
                kill_at["t"] = time.monotonic()

        k = len(prompts) - 2
        killed = _stream(wire, endpoints, prompts[k], budgets[k],
                         victim_session, on_token=on_token)
        assert "t" in kill_at, "the stream ended before the kill"
        near_c = _check_stream("phase 34(c) killed backend's stream",
                               killed, refs[k], gaps[k])
        assert killed[2].get("resumed") is True, killed[2]
        # the router's failover record: the first resumed token is the one
        # at the journal's length (the router's clock is the system's
        # monotonic clock, as this process's)
        (resume,) = _http_json(wire, a_addr, "/fleet")[1]["stream_resumes"]
        assert resume["backend"] == "b2" and resume["failed"] == ["b1"]
        resume_ms = (arrived[resume["committed"]] - kill_at["t"]) * 1e3
        dispatch_ms = (resume["t"] - kill_at["t"]) * 1e3
        _wait_for(lambda: "b1" in _http_json(wire, a_addr, "/fleet")[1][
            "directory"]["tombstones"], 3 * FLEET_LOST_S + 5,
            "b1 evicted LOST on the active router")
        fdoc = _http_json(wire, a_addr, "/fleet")[1]
        walk = [e["event"] for e in fdoc["directory"]["events"]
                if e["backend"] == "b1"]
        assert fdoc["directory"]["tombstones"]["b1"]["state"] == "LOST"
        assert "suspect" in walk and walk.index("suspect") < \
            walk.index("evict"), walk
        directory.evict("b1", reason="lost")
        counters = fdoc["counters"]
        assert counters["stream_resumed"] >= 1, counters
        print(f"phase 34(c) SIGKILL of b1 at token 3 of a {budgets[k]}-token "
              f"stream: resumed on b2 via the journal, "
              f"{resume['committed']} tokens committed, kill-to-resume-"
              f"dispatch {dispatch_ms:.1f} ms, kill-to-first-resumed-token "
              f"{resume_ms:.1f} ms, stream "
              f"equal to the reference (near-ties {near_c}), directory walk "
              f"{walk}, router counters stream_resumed "
              f"{counters['stream_resumed']} forward_failures "
              f"{counters['forward_failures']} {tag}")

        # (d) a page alert spawns a replacement (the infer load paused:
        # the window's events are the streams')
        loads[-1].stop()
        alerts = []

        def paged():
            alerts[:] = _page_alerts(wire, a_addr)
            if not alerts:
                burst = [threading.Thread(
                    target=_stream, args=(wire, endpoints, prompts[i],
                                          budgets[i], f"p{i}"))
                         for i in range(FLEET_STREAMS)]
                for t in burst:
                    t.start()
                for t in burst:
                    t.join(300)
            return alerts

        _wait_for(paged, 60, "a page alert on the active router", 0.2)
        for evt in alerts:
            scaler.on_alert(evt)
        assert scaler.counters["spawns"] == 1, (scaler.counters,
                                                 scaler.timeline[-4:])
        b3 = next(n for n in manager.names() if n not in ("b1", "b2"))
        h3 = manager.handle(b3)
        _wait_for(lambda: _live_on(wire, a_addr, [b3]), 30,
                  f"{b3} LIVE on the active router")
        ws3 = h3.ready_doc["warm_start"]
        fleet_warm_check(ws3)
        print(f"phase 34(d) page alerts {[a['slo'] for a in alerts]} -> "
              f"autoscaler spawned {b3}: spawn-to-READY "
              f"{h3.ready_doc['t_ready_s']:.2f} s "
              f"({_timings(h3.ready_doc)}), captures paid "
              f"{h3.ready_doc['compiles_paid']}, warm start {ws3} {tag}")
        out["autoscale"] = {"alerts": alerts, "backend": b3,
                            "ready_s": h3.ready_doc["t_ready_s"],
                            "captures_paid": h3.ready_doc["compiles_paid"],
                            "warm_start": ws3}

        # (e) the active router dies mid-stream
        loads.append(_InferLoad(wire, RetryPolicy, endpoints, xs).start())
        spawns = scaler.counters["spawns"]
        progress = [0] * FLEET_STREAMS
        got = [None] * FLEET_STREAMS
        base = FLEET_STREAMS

        def run_e(i):
            def mark(n):
                progress[i] = n
            got[i] = _stream(wire, endpoints, prompts[base + i],
                             budgets[base + i], f"e{i}", on_token=mark)

        threads = [threading.Thread(target=run_e, args=(i,))
                   for i in range(FLEET_STREAMS)]
        for t in threads:
            t.start()
        _wait_for(lambda: min(progress) >= 2, 120,
                  "every stream mid-decode")
        t_kill = time.time()
        active.kill()
        for t in threads:
            t.join(300)
        promoted = standby.wait_promoted(30)
        assert promoted is not None, standby.tail()
        takeover_ms = (promoted["t_wall"] - t_kill) * 1e3
        assert promoted["epoch"] == 2, promoted
        resumed_e = sum(bool(g[2].get("resumed")) for g in got)
        assert resumed_e >= 1, "no stream was resumed on the standby"
        near_e = sum(_check_stream(f"phase 34(e) stream {i}", got[i],
                                   refs[base + i], gaps[base + i])
                     for i in range(FLEET_STREAMS))
        _wait_for(lambda: _live_on(wire, s_addr, ["b2", b3]),
                  10 * FLEET_BEAT_S + 5, "b2 and b3 LIVE on the promoted "
                  "router")
        # the promoted router's alerts reach the autoscaler too: the
        # cooldown inherited from (d) holds every one of them
        for evt in _page_alerts(wire, s_addr):
            scaler.on_alert(evt)
        assert scaler.counters["spawns"] == spawns, scaler.counters
        loads[-1].stop()
        print(f"phase 34(e) SIGKILL of the active router with "
              f"{FLEET_STREAMS} streams mid-decode: standby promoted to "
              f"epoch {promoted['epoch']} in {takeover_ms:.1f} ms "
              f"(adopted {promoted['adopted']}), {resumed_e} streams "
              f"resumed from the clients' journals, all equal to the "
              f"references (near-ties {near_e}), spawns after the "
              f"takeover {scaler.counters['spawns'] - spawns} {tag}")
        rows = [r for ld in loads for r in ld.rows]
        failed = sum(ld.failed for ld in loads)
        errs = [_row_err(o, want_rows[i]) for i, o in rows]
        assert failed == 0, [e for ld in loads for e in ld.errors][:4]
        assert rows and max(errs) <= LOGITS_TOL, max(errs)
        print(f"phase 34 infer: {len(rows)} one-row requests through the "
              f"routers over (b)-(c) and (e), 0 failed, max row error "
              f"{max(errs):.3g} (LOGITS_TOL {LOGITS_TOL}) against the "
              f"serial Predictor {tag}")

        # (f) drain: K7's launches, captures during traffic
        drains = {}

        def retire(name):
            drains[name] = manager.retire(name, drain=True, timeout_s=60.0)

        retiring = [threading.Thread(target=retire, args=(n,))
                    for n in ("b2", b3)]
        for t in retiring:
            t.start()
        for t in retiring:
            t.join(120)
        assert all(drains.get(n) for n in ("b2", b3)), drains
        ready = {"b2": spawned["b2"], b3: h3.ready_doc}
        for name, doc in drains.items():
            assert doc["compiles_paid"] == ready[name]["compiles_paid"], (
                name, doc["compiles_paid"], ready[name]["compiles_paid"])
            assert not doc["jax_loaded"], name
        launches = {k: sum(d["launch_counts"][k] for d in drains.values())
                    for k in ("quantized_paged_decode_attention",
                              "quantized_paged_prefill_attention")}
        launches["quantized_paged_decode_attention"] -= launches[
            "quantized_paged_prefill_attention"]
        # every route launches once per layer
        assert all(v > 0 and v % cfg.num_layers == 0
                   for v in launches.values()), launches
        phase_s = time.perf_counter() - t_phase
        out.update(
            reference_s=ref_s, streams_s=streams_s, near_ties=near + near_c
            + near_e, kill_to_first_resumed_token_ms=resume_ms,
            kill_to_resume_dispatch_ms=dispatch_ms,
            resume_committed=resume["committed"],
            takeover_ms=takeover_ms, epoch_after=promoted["epoch"],
            directory_walk=walk, infer_requests=len(rows),
            infer_failed=failed, max_row_err=max(errs),
            resumed_after_takeover=resumed_e,
            spawns_after_takeover=scaler.counters["spawns"] - spawns,
            launches=launches, drained=sorted(drains), phase_s=phase_s,
            snapshot_loads=store.load_latest()[0] is not None)
        print(f"phase 34(f) K7 launches on the fleet path (drain docs of "
              f"{sorted(drains)}; b1's died with it): {launches}; no "
              f"capture during traffic; phase 34: {phase_s:.1f} s {tag}")
        return out, launches
    finally:
        for ld in loads:
            ld.stop()
        if manager is not None:
            for name in manager.names():
                manager.handle(name).kill()
            manager.shutdown_all(drain=False, timeout_s=10.0)
        for r in routers:
            r.kill()
            r.terminate(timeout_s=10.0)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def ft_train(torch, seed, ckpt_dir, batch=None, image=None, device=None,
             on_step=None):
    """Phase 35's run: phase 14's ResNet-50 program at `batch` x
    `image`^2 on one seeded batch, f32 with TF32 off, cuDNN
    deterministic, FT_STEPS steps of `resilient_train_loop`
    checkpointing every FT_SAVE_EVERY steps into `ckpt_dir` (resuming
    from it when it holds a snapshot). Returns (losses of the steps this
    process ran, the final persistables as numpy, the loop's report, the
    kernels' launch counts). None takes FT_BATCH, FT_IMAGE, FT_DEVICE."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    from paddle_tpu_torch.reliability import resilient_train_loop
    from paddle_tpu_torch.weights import scope_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    flags.set_flag("deterministic", True)
    batch = FT_BATCH if batch is None else batch
    image = FT_IMAGE if image is None else image
    device = FT_DEVICE if device is None else device
    main, startup, _, _, loss = resnet_train_programs(seed, image)
    exe, scope = Executor(device), Scope()
    exe.run(startup, scope=scope)
    if on_step is not None:
        on_step(None)
    rng = np.random.RandomState(seed + 35)
    feed = {"img": resnet_images(rng, batch, image),
            "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)}
    for mod in (da, tfa, k8):
        mod.reset_launch_counts()
    losses = []

    def step_cb(step, fetches):
        losses.append(float(np.asarray(fetches[0]).reshape(-1)[0]))
        if on_step is not None:
            on_step(step)

    report = resilient_train_loop(exe, main, lambda step: feed, [loss],
                                  FT_STEPS, ckpt_dir,
                                  save_every=FT_SAVE_EVERY, scope=scope,
                                  on_step=step_cb)
    if exe.device.type == "cuda":
        torch.cuda.synchronize()
    final = scope_to_numpy(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    counts = {**da.launch_counts, **tfa.launch_counts, **k8.launch_counts}
    return losses, final, report, counts


def ft_worker(spec):
    """The supervised worker of phase 35 (`chip_smoke.py --ft-worker
    JSON`): prints FT-START / FT-STEP lines with wall times, trains, and
    writes its losses, final persistables and launch counts to
    spec["out"] (an .npz beside a .json)."""
    import torch
    print("FT-START " + json.dumps({"t_wall": time.time(), "pid":
                                    os.getpid()}), flush=True)

    def on_step(step):
        if step is None:            # the program built, startup run
            print("FT-BUILT " + json.dumps({"t_wall": time.time()}),
                  flush=True)
            return
        print("FT-STEP " + json.dumps({"step": step, "t_wall":
                                       time.time()}), flush=True)

    losses, final, report, counts = ft_train(
        torch, spec["seed"], spec["ckpt"], spec["batch"], spec["image"],
        spec["device"], on_step=on_step)
    np.savez(spec["out"] + ".npz", **final)
    with open(spec["out"] + ".json", "w") as f:
        json.dump({"losses": losses, "resumed_from": report["resumed_from"],
                   "launches": counts,
                   "jax_loaded": "jax" in sys.modules}, f)
    return 0


def _ft_lines(path, mark):
    with open(path) as f:
        return [json.loads(ln[len(mark):]) for ln in f
                if ln.startswith(mark)]


def ft_phase(torch, seed, tag):
    """Phase 35: fault-tolerant training on the card (see the module
    docstring). Returns the results."""
    import shutil
    import threading
    from paddle_tpu_torch.reliability import Supervisor, WorkerSpec

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pt_ft_")
    procs, supervised = [], None
    try:
        # (b) the run under the supervisor, crashed at FT_CRASH_AT, in a
        # thread: its workers' start-up overlaps (a)
        out = os.path.join(tmp, "worker")
        log = os.path.join(tmp, "worker.log")
        spec = {"seed": seed, "ckpt": os.path.join(tmp, "ckpt"), "out": out,
                "batch": FT_BATCH, "image": FT_IMAGE, "device": FT_DEVICE}
        assert FT_CRASH_AT % FT_SAVE_EVERY == 0
        worker = WorkerSpec(0, [sys.executable, os.path.abspath(__file__),
                                "--ft-worker", json.dumps(spec)],
                            env={"PT_FLAGS_fault_plan":
                                 f"train.step:{FT_CRASH_AT}:crash"},
                            log_path=log)

        def popen(cmd, **kw):
            procs.append(subprocess.Popen(cmd, **kw))
            return procs[-1]

        sup = Supervisor([worker], max_restarts=2, restart_window=600.0,
                         restart_delay=0.0, drain_timeout=10.0,
                         report_path=os.path.join(tmp, "report.json"),
                         flight_dir=os.path.join(tmp, "flight"),
                         handle_signals=False, popen=popen)
        done = {}
        supervised = threading.Thread(
            target=lambda: done.update(report=sup.run(poll=0.05)))
        t0 = time.perf_counter()
        supervised.start()
        # (a) the same run uninterrupted, in this process
        t1 = time.perf_counter()
        losses, want, rep, counts = ft_train(torch, seed,
                                             os.path.join(tmp, "plain"))
        plain_s = time.perf_counter() - t1
        assert rep["resumed_from"] == 0 and len(losses) == FT_STEPS, rep
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert not any(counts.values()), counts
        supervised.join(600)
        assert "report" in done, "the supervised run did not finish"
        report = done["report"]
        supervised_s = time.perf_counter() - t0
        w = report["workers"]["0"]
        assert report["success"] and report["exit_code"] == 0, report
        assert report["restarts_total"] == 1 and w["restarts"] == 1, report
        assert w["exit_codes"] == [17, 0], w
        assert len(w["flight_dumps"]) == 2, w
        starts = _ft_lines(log, "FT-START ")
        built = _ft_lines(log, "FT-BUILT ")
        steps = _ft_lines(log, "FT-STEP ")
        first = [s for s in steps if s["step"] == FT_CRASH_AT]
        last_before = [s for s in steps if s["step"] == FT_CRASH_AT - 1]
        assert len(starts) == 2 and len(first) == 1, (starts, steps)
        restart_s = first[0]["t_wall"] - last_before[0]["t_wall"]
        # the restart's stages: the crash, the snapshot and a new
        # interpreter to its start; torch, the program and startup; the
        # restore and the first (eager) step
        stages = {"to_start_s": starts[1]["t_wall"] - last_before[0][
                      "t_wall"],
                  "to_built_s": built[1]["t_wall"] - starts[1]["t_wall"],
                  "to_first_step_s": first[0]["t_wall"] - built[1][
                      "t_wall"]}
        with open(out + ".json") as f:
            doc = json.load(f)
        assert doc["resumed_from"] == FT_CRASH_AT, doc
        assert not any(doc["launches"].values()), doc["launches"]
        assert not doc["jax_loaded"]
        with np.load(out + ".npz") as z:
            got = {k: z[k] for k in z.files}
        assert sorted(got) == sorted(want)
        diffs = {k: float(np.abs(got[k].astype(np.float64)
                                 - want[k].astype(np.float64)).max())
                 for k in want if want[k].dtype.kind == "f"}
        worst = max(diffs.values())
        loss_diff = abs(doc["losses"][-1] - losses[-1])
        bit_equal = all(np.array_equal(got[k], want[k]) for k in want)
        resumed_losses = doc["losses"]
        assert len(resumed_losses) == FT_STEPS - FT_CRASH_AT
        assert bit_equal and resumed_losses == losses[FT_CRASH_AT:], (
            f"resumed run differs: max |param diff| {worst:.3g}, last "
            f"loss {doc['losses'][-1]!r} vs {losses[-1]!r}")
        phase_s = time.perf_counter() - t_phase
        staged = ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        print(f"phase 35: ResNet-50 b{FT_BATCH} x {FT_IMAGE}^2, {FT_STEPS} "
              f"steps (save_every {FT_SAVE_EVERY}): uninterrupted "
              f"{plain_s:.1f} s; supervised with train.step:{FT_CRASH_AT}:"
              f"crash: exit codes {w['exit_codes']}, restarts "
              f"{report['restarts_total']}, resumed from step "
              f"{doc['resumed_from']}, restart-to-first-step "
              f"{restart_s:.2f} s ({staged}), "
              f"supervised {supervised_s:.1f} s; final "
              f"parameters and losses bit-equal to the uninterrupted run "
              f"(max |diff| {worst:.3g}, last loss {losses[-1]:.6f}); "
              f"flight dumps {[d['exists'] for d in w['flight_dumps']]}; "
              f"0 table-kernel launches; phase 35: {phase_s:.1f} s {tag}")
        return {"uninterrupted_s": plain_s, "supervised_s": supervised_s,
                "restart_to_first_step_s": restart_s,
                "restart_stages": stages,
                "exit_codes": w["exit_codes"],
                "restarts": report["restarts_total"],
                "resumed_from": doc["resumed_from"],
                "bit_equal": bit_equal, "max_param_diff": worst,
                "last_loss_diff": loss_diff, "losses": losses,
                "flight_dumps": w["flight_dumps"], "phase_s": phase_s}
    finally:
        if supervised is not None and supervised.is_alive():
            sup.request_stop()
            supervised.join(60)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 36-38. parallelism over torch.distributed: the rank pool
# ---------------------------------------------------------------------------
#: the rank pool: 4 worker processes (`chip_smoke.py --rank-worker`) in one
#: gloo process group on the one card (NCCL refuses two ranks on one
#: device)
RANK_WORLD = 4
RANK_TIMEOUT_S = 240
#: phase 36(a): ResNet-50 (phase 14's program) data parallel over dp=2
PAR_RESNET = dict(batch=32, image=224, steps=2)
#: and its float64 check (dp=2 and per-rank BN against one process)
PAR_RESNET_F64 = dict(batch=4, image=64, steps=2)
#: phase 36(c): tests/test_parallel.py's tp fc programs at these widths
PAR_TP = dict(batch=64, d_in=1024, hidden=4096, classes=16, steps=3)
#: phase 37(a): tests/test_long_context_training.py's causal LM at
#: GPT-2-small widths, B=1, T=8192 over sp=4
PAR_LM = dict(vocab=50257, hidden=768, heads=12, layers=12, batch=1,
              seq=8192)
#: phase 37(b): switch_moe over ep=4
PAR_MOE = dict(n=4096, d=768, h=3072, e=8)
#: phase 38: BERT-base's encoder over pp=4, M microbatches
PAR_BERT = dict(layers=12, micro=8, mb_batch=2, seq=512, virtual=3)
#: gates. Losses: relative; gradients: max |got - want| over max |want|
#: (each tensor; the f32 ring / Ulysses / pipeline sums reorder the
#: single-process step's); ResNet-50 over dp=2: the first loss and the
#: first update's error norm against the update's norm, then every
#: later loss and the final parameters' error norm against the whole
#: run's update norm, looser (cuDNN picks its algorithms per batch size
#: and f32 ReLU masks flip, so the steps drift apart), exact in float64
PAR_TOL = dict(resnet_loss=1e-5, resnet_update=2e-2, resnet_later_loss=1e-2,
               resnet_final=5e-2, resnet64=1e-9,
               nccl_loss=1e-5,
               tp_loss=1e-5, tp_sum=1e-5, lm_loss=1e-5, lm_grad=1e-3,
               moe=1e-4, bert_loss=1e-5, bert_grad=1e-3)


def rank_worker_main(argv):
    """`chip_smoke.py --rank-worker ...`: one rank of the pool."""
    from paddle_tpu_torch.parallel.ranks import worker
    return worker(argv)


def _rank_setup(torch, ctx):
    """Every rank function's first step: TF32 off, the kernel library
    phase 1 built loaded (no rank builds), the counters at 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ctx.device.startswith("cuda"):
        from paddle_tpu_torch.ops.kernels import _build
        assert os.path.exists(_build.library_path()), (
            "the kernel library is not built: phase 1 builds it")
        _build.load_library()
    from paddle_tpu_torch.ops import collective
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    tfa.reset_launch_counts()
    collective.reset_staged()


def _sync(torch, device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def _flash_launches(tfa):
    return {k: int(tfa.launch_counts.get(k, 0)) for k in FLASH_KERNELS}


#: the collectives the probe tries on CUDA tensors over gloo: those
#: ops/collective.py hands gloo as they are. Not send / recv (its
#: GLOO_STAGED): gloo's send of a device pointer aborts the rank process
#: ("writev: Bad address"), which this probe saw on the card when it
#: tried it in a pool of its own.
GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
                  "all_to_all")


def rank_probe_op(ctx, op):
    """Try one collective on CUDA tensors over gloo: True, or the
    exception's name when gloo refuses it."""
    import torch
    import torch.distributed as dist
    x = torch.ones(4, device=ctx.device)
    fns = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(ctx.world)], x),
        "reduce_scatter": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // ctx.world, device=ctx.device), x),
        "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(x),
                                                     x)}

    try:
        fns[op]()
        torch.cuda.synchronize()
        return True
    except Exception as e:                 # the probe records a refusal
        return f"refused ({type(e).__name__})"


def gloo_cuda_probe(pool, tag):
    """Which collectives gloo takes CUDA tensors for on this card's
    torch (GLOO_PROBE_OPS, on the pool's ranks): {op: True |
    "refused (...)"}. Fails unless gloo takes every one that
    ops/collective.py does not stage."""
    from paddle_tpu_torch.ops.collective import GLOO_STAGED
    out = {}
    for op in GLOO_PROBE_OPS:
        got = pool.run(__file__, "rank_probe_op", op)
        out[op] = got[0] if all(g == got[0] for g in got) else got
    print(f"gloo on CUDA tensors (torch's own support; ops/collective.py "
          f"stages {sorted(GLOO_STAGED)} only): {out} {tag}")
    assert not set(GLOO_PROBE_OPS) & GLOO_STAGED, GLOO_STAGED
    refused = {op: r for op, r in out.items() if r is not True}
    assert not refused, f"gloo refuses CUDA tensors unstaged: {refused}"
    return out


# -- 36. data parallel ------------------------------------------------------
def _par_state_file(state, path):
    np.savez(path, **state)
    return path


def _load_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _resnet_run(torch, main, loss, prog, state, feeds, device, params):
    """Run `prog` (main or a CompiledProgram of it) from `state` over the
    numpy `feeds` (img{i}, label{i}) under deterministic cuDNN: the
    losses, each step's wall ms, and `params` after the first and the
    last step."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy
    scope = scope_from_jax(state, Scope(), device, program=main)
    exe = Executor(device)
    steps = len([k for k in feeds if k.startswith("img")])
    losses, walls, first = [], [], None
    flags.set_flag("deterministic", True)
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            lv, = exe.run(prog, feed={"img": feeds[f"img{i}"],
                                      "label": feeds[f"label{i}"]},
                          fetch_list=[loss], scope=scope)
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
            if i == 0:
                first = scope_to_numpy(scope, params)
    finally:
        flags.set_flag("deterministic", False)
    return losses, walls, first, scope_to_numpy(scope, params)


def _resnet_dp_programs(image, f64):
    main, _, _, _, loss = resnet_train_programs(0, image)
    params = sorted(v.name for v in main.list_vars()
                    if v.desc.is_parameter)
    if f64:
        import torch
        main = widened(torch, main)
    return main, loss, params


@contextlib.contextmanager
def _per_rank_batch_norm():
    """36(a)'s control: CompiledProgram runs a training batch_norm as
    sync_batch_norm; inside this block the rank process's op registry
    maps that name to batch_norm, so each rank normalizes its shard by
    the shard's own moments."""
    from paddle_tpu_torch.core import registry
    plain = registry.get_op("batch_norm")
    saved = registry.get_op("sync_batch_norm")
    registry._OPS["sync_batch_norm"] = plain
    try:
        yield
    finally:
        registry._OPS["sync_batch_norm"] = saved


def rank_resnet_dp(ctx, state_path, feeds_path, sync_bn, image, f64):
    """36(a): ResNet-50 training through CompiledProgram over dp=2
    (ranks 0 and 1; ranks 2 and 3 join the group's making and wait);
    rank 0 returns the losses, the step walls and the parameters after
    the first and the last step."""
    import torch
    from paddle_tpu_torch.ops import collective
    from paddle_tpu_torch.parallel import CompiledProgram, make_mesh
    _rank_setup(torch, ctx)
    mesh = make_mesh({"dp": 2}, device=ctx.device, ranks=[0, 1])
    if mesh is None:
        return None
    main, loss, params = _resnet_dp_programs(image, f64)
    state = _load_npz(state_path)
    if f64:
        state = widen_state(state)
    prog = CompiledProgram(main).with_data_parallel(loss_name=loss,
                                                    mesh=mesh)
    with contextlib.ExitStack() as stack:
        if not sync_bn:
            stack.enter_context(_per_rank_batch_norm())
        losses, walls, first, last = _resnet_run(
            torch, main, loss, prog, state, _load_npz(feeds_path),
            ctx.device, params)
    return {"losses": losses, "step_ms": walls,
            "first": first if ctx.rank == 0 else None,
            "last": last if ctx.rank == 0 else None,
            "staged": dict(collective.staged),
            "jax_loaded": ctx.jax_loaded}


def _tp_programs(tp, kind, c):
    """tests/test_parallel.py's tp programs at `c`'s widths (PAR_TP):
    "train" (column-parallel fc1, row-parallel fc2, Momentum) or "sum"
    (one column-parallel fc, relu, reduce_sum)."""
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = 11
    with ir.program_guard(main, startup):
        x = static.data("x", [-1, c["d_in"]], append_batch_size=False)
        a1 = ParamAttr(name="w1", sharding=(None, "tp") if tp else None)
        if kind == "sum":
            h = static.fc(x, c["hidden"], param_attr=a1, bias_attr=False,
                          act="relu")
            out = static.reduce_sum(h)
            return main, startup, out.name
        y = static.data("y", [-1, 1], dtype="int64",
                        append_batch_size=False)
        a2 = ParamAttr(name="w2", sharding=("tp", None) if tp else None)
        h = static.fc(x, c["hidden"], param_attr=a1, act="relu")
        logits = static.fc(h, c["classes"], param_attr=a2)
        loss = static.mean(static.softmax_with_cross_entropy(logits, y))
        optimizer.Momentum(0.05, 0.9).minimize(loss,
                                               startup_program=startup)
    return main, startup, loss.name


def _tp_run(device, mesh, kind, state, feeds, c):
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.parallel import CompiledProgram
    from paddle_tpu_torch.weights import scope_from_jax
    main, _, fetch = _tp_programs(mesh is not None, kind, c)
    scope = scope_from_jax(state, Scope(), device, program=main)
    prog = main if mesh is None else CompiledProgram(
        main).with_data_parallel(loss_name=fetch, mesh=mesh)
    exe = Executor(device)
    return [float(np.asarray(exe.run(prog, feed=f, fetch_list=[fetch],
                                     scope=scope)[0]).reshape(-1)[0])
            for f in feeds]


def rank_tp(ctx, kind, state, feeds, c):
    """36(c): a tp program over tp=4 (every rank stores its slice)."""
    import torch
    from paddle_tpu_torch.parallel import make_mesh
    _rank_setup(torch, ctx)
    mesh = make_mesh({"tp": ctx.world}, device=ctx.device)
    return _tp_run(ctx.device, mesh, kind, state, feeds, c)


def par_data_parallel(torch, pool, seed, tag, dev="cuda"):
    """Phase 36. (a) ResNet-50 static training (phase 14's program at
    full width) through CompiledProgram over dp=2 ranks of the pool,
    global batch PAR_RESNET (16 a rank), Momentum, deterministic cuDNN,
    against the single-process run of the same global batches from the
    same state: in f32 the first step's loss (1e-5 relative) and update
    (the norm of the parameter difference over the update's), every
    later loss and the final parameters against the whole run's update,
    looser (PAR_TOL: f32 ReLU masks flip between the two runs' conv
    algorithms, and the steps drift apart, as phase 14 found); in
    float64 at PAR_RESNET_F64 every loss, the first update and the final
    parameters to 1e-9, and the same program with per-rank batch norm
    (`_per_rank_batch_norm`), which must land far from it. (b) the same
    f32 step at world size 1 over NCCL in this process: equal to the
    plain program's run, captured, no collective issued from Python in
    its replays (a one-rank in-place all-reduce leaves nothing in a
    graph to see); and a program of c_allgather and c_reducescatter
    (out of place: NCCL copies into the output, a node of the graph)
    whose replayed outputs follow new feeds only if the collectives
    replay inside the graph (`nccl_graph_collectives`). (c) the tp
    programs of tests/test_parallel.py at PAR_TP's widths over tp=4
    against their replicated runs (atol 1e-5 on the loss, rtol 1e-5 on
    the sum)."""
    import tempfile
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.weights import scope_to_numpy
    out = {}
    c = PAR_RESNET
    tmp = tempfile.mkdtemp(prefix="phase36-")

    def update_err(got, want, start, params):
        num = sum(float(np.sum((got[n].astype(np.float64) - want[n]) ** 2))
                  for n in params)
        den = sum(float(np.sum((want[n].astype(np.float64) - start[n]) ** 2))
                  for n in params)
        return (num / den) ** 0.5

    def case(image, batch, steps, f64, sync_variants):
        main, startup, _, _, loss = resnet_train_programs(seed, image)
        exe, scope = Executor(dev), Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars()
                       if v.persistable and scope.has(v.name))
        state = scope_to_numpy(scope, names)
        del scope
        rng = np.random.RandomState(seed + 36 + image)
        feeds = {}
        for i in range(steps):
            feeds[f"img{i}"] = resnet_images(rng, batch, image)
            feeds[f"label{i}"] = rng.randint(0, 1000, (batch, 1)).astype(
                np.int64)
        tag_ = f"{image}-{int(f64)}"
        sp = _par_state_file(state, os.path.join(tmp, f"state{tag_}.npz"))
        fp = _par_state_file(feeds, os.path.join(tmp, f"feeds{tag_}.npz"))
        pmain, ploss, params = _resnet_dp_programs(image, f64)
        st = widen_state(state) if f64 else state
        ref = _resnet_run(torch, pmain, ploss, pmain, st, feeds, dev,
                          params)
        torch.cuda.empty_cache()
        rows = {}
        for sync in sync_variants:
            t0 = time.perf_counter()
            got = pool.run(__file__, "rank_resnet_dp", sp, fp, sync,
                           image, f64, timeout=RANK_TIMEOUT_S)
            assert not any(g and g["jax_loaded"] for g in got), got
            g = got[0]
            rows[sync] = {
                "losses": g["losses"], "single_losses": ref[0],
                "loss_rel_err": [abs(a - b) / abs(b) for a, b in
                                 zip(g["losses"], ref[0])],
                "first_update_rel_err": update_err(g["first"], ref[2],
                                                   st, params),
                "final_update_rel_err": update_err(g["last"], ref[3],
                                                   st, params),
                "rank0_step_ms": g["step_ms"], "single_step_ms": ref[1],
                "staged": g["staged"], "wall_s": time.perf_counter() - t0}
        return rows

    f32 = case(c["image"], c["batch"], c["steps"], False, (True,))[True]
    print(f"phase 36(a) resnet-50 dp=2 (gloo, f32, global batch "
          f"{c['batch']} x {c['image']}^2, Momentum): losses "
          f"{f32['losses']} vs single {f32['single_losses']} (rel "
          f"{f32['loss_rel_err']}), first update |got - want| / |update| "
          f"{f32['first_update_rel_err']:.3g}, final parameters "
          f"{f32['final_update_rel_err']:.3g}; step ms rank 0 "
          f"{f32['rank0_step_ms']} (two ranks share the card) vs single "
          f"{f32['single_step_ms']}; staged {f32['staged']} {tag}")
    assert f32["loss_rel_err"][0] <= PAR_TOL["resnet_loss"], f32
    assert f32["first_update_rel_err"] <= PAR_TOL["resnet_update"], f32
    assert max(f32["loss_rel_err"]) <= PAR_TOL["resnet_later_loss"], f32
    assert f32["final_update_rel_err"] <= PAR_TOL["resnet_final"], f32
    f64 = case(PAR_RESNET_F64["image"], PAR_RESNET_F64["batch"],
               PAR_RESNET_F64["steps"], True, (True, False))
    print(f"phase 36(a) float64 at batch {PAR_RESNET_F64['batch']} x "
          f"{PAR_RESNET_F64['image']}^2, {PAR_RESNET_F64['steps']} steps: "
          f"sync BN loss rel {f64[True]['loss_rel_err']}, first update "
          f"rel {f64[True]['first_update_rel_err']:.3g}, final parameters "
          f"rel {f64[True]['final_update_rel_err']:.3g}; per-rank BN loss "
          f"rel {f64[False]['loss_rel_err']}, first update rel "
          f"{f64[False]['first_update_rel_err']:.3g} {tag}")
    assert max(f64[True]["loss_rel_err"]) <= PAR_TOL["resnet64"], f64
    assert f64[True]["first_update_rel_err"] <= PAR_TOL["resnet64"], f64
    assert f64[True]["final_update_rel_err"] <= PAR_TOL["resnet64"], f64
    assert f64[False]["first_update_rel_err"] > 1e3 * PAR_TOL["resnet64"]
    out["resnet_dp"] = {"f32": f32, "f64": {"sync_bn": f64[True],
                                            "per_rank_bn": f64[False]}}
    main, startup, _, _, loss = resnet_train_programs(seed, c["image"])
    exe, scope = Executor(dev), Scope()
    exe.run(startup, scope=scope)
    state = scope_to_numpy(scope, sorted(
        v.name for v in main.list_vars()
        if v.persistable and scope.has(v.name)))
    del scope
    rng = np.random.RandomState(seed + 36)
    feeds = {"img0": resnet_images(rng, c["batch"], c["image"]),
             "label0": rng.randint(0, 1000, (c["batch"], 1)).astype(
                 np.int64)}
    out["resnet_nccl_world1"] = par_nccl_world1(
        torch, main, startup, loss, state, feeds, tmp, tag, dev)

    # (c) tp=4
    rows = {}
    for kind in ("train", "sum"):
        pmain, pstart, fetch = _tp_programs(False, kind, PAR_TP)
        s = Scope()
        Executor(dev).run(pstart, scope=s)
        st = scope_to_numpy(s, sorted(v.name for v in pmain.list_vars()
                                      if v.persistable and s.has(v.name)))
        r = np.random.RandomState(seed + 360)
        fs = []
        for _ in range(PAR_TP["steps"] if kind == "train" else 1):
            xs = r.randn(PAR_TP["batch"], PAR_TP["d_in"]).astype(np.float32)
            f = {"x": xs}
            if kind == "train":
                f["y"] = r.randint(0, PAR_TP["classes"],
                                   (PAR_TP["batch"], 1)).astype(np.int64)
            fs.append(f)
        want = _tp_run(dev, None, kind, st, fs, PAR_TP)
        got_tp = pool.run(__file__, "rank_tp", kind, st, fs, PAR_TP,
                          timeout=RANK_TIMEOUT_S)
        for g in got_tp:
            if kind == "train":
                err = max(abs(a - b) for a, b in zip(g, want))
                assert err <= PAR_TOL["tp_loss"], (g, want)
            else:
                err = max(abs(a - b) / abs(b) for a, b in zip(g, want))
                assert err <= PAR_TOL["tp_sum"], (g, want)
        rows[kind] = {"got": got_tp[0], "want": want, "err": err}
    print(f"phase 36(c) tp=4 fc programs ({PAR_TP}): train losses "
          f"{rows['train']['got']} vs {rows['train']['want']} (max abs err "
          f"{rows['train']['err']:.3g}), reduce_sum rel err "
          f"{rows['sum']['err']:.3g} {tag}")
    out["tp"] = rows
    return out


def par_nccl_world1(torch, main, startup, loss, state, feeds, tmp, tag,
                    dev):
    """36(b): a one-rank NCCL group in this process; the ResNet-50 step
    through CompiledProgram (captured: the Executor's first run of a
    signature is its eager warm-up) against the plain program's run."""
    import datetime
    import torch.distributed as dist
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.ops import collective
    from paddle_tpu_torch.parallel import CompiledProgram, make_mesh
    from paddle_tpu_torch.weights import scope_from_jax
    feed = {"img": feeds["img0"], "label": feeds["label0"]}
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'nccl-store')}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    flags.set_flag("deterministic", True)
    try:
        mesh = make_mesh({"dp": 1}, device=dev)
        runs = {}
        for label, make in (("plain", lambda: main),
                            ("compiled", lambda: CompiledProgram(
                                main).with_data_parallel(loss_name=loss,
                                                         mesh=mesh))):
            scope = scope_from_jax(state, Scope(), dev, program=main)
            exe, prog = Executor(dev), make()
            collective.reset_staged()
            runs[label] = [float(np.asarray(exe.run(
                prog, feed=feed, fetch_list=[loss], scope=scope)[0])
                .reshape(-1)[0]) for _ in range(3)]
            if label == "compiled":
                capture_issued = dict(collective.issued)

                def step(n, exe=exe, prog=prog, scope=scope):
                    for _ in range(n):
                        exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope)
                    torch.cuda.synchronize()
                collective.reset_staged()
                host = {}
                rows = device_rows(torch, lambda: step(2), host)
                replay_issued = dict(collective.issued)
        nccl = [e.key for e in rows if "nccl" in e.key.lower()]
        err = max(abs(a - b) / abs(b)
                  for a, b in zip(runs["compiled"], runs["plain"]))
        print(f"phase 36(b) resnet-50 at world size 1 over nccl: losses "
              f"{runs['compiled']} vs plain {runs['plain']} (rel err "
              f"{err:.3g}); collectives issued in the first 3 runs (eager "
              f"warm-up, capture, replay) {capture_issued}, in 2 more "
              f"replayed steps {replay_issued} with "
              f"{host['graph_launches']} graph launches (a one-rank NCCL "
              f"all-reduce is in place: no kernel, NCCL kernels seen "
              f"{sorted(set(nccl))[:3]}) {tag}")
        assert err <= PAR_TOL["nccl_loss"], runs
        assert capture_issued["all_reduce"] > 0, capture_issued
        assert not any(replay_issued.values()), replay_issued
        assert host["graph_launches"] >= 2, host
        gathered = nccl_graph_collectives(torch, mesh, dev, tag)
        return {"collective_program": gathered,
                "losses": runs["compiled"], "plain_losses": runs["plain"],
                "loss_rel_err": err, "nccl_kernels": sorted(set(nccl)),
                "issued_first_3_runs": capture_issued,
                "issued_2_replays": replay_issued,
                "graph_launches_2_steps": host["graph_launches"]}
    finally:
        flags.set_flag("deterministic", False)
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def nccl_graph_collectives(torch, mesh, dev, tag):
    """36(b)'s falsifiable half: a static program of c_allgather and
    c_reducescatter over the one-rank NCCL group (each out of place, so
    NCCL copies its input into the output buffer: a node of the graph),
    run through CompiledProgram by the Executor, which captures its
    second run; the later runs are replays. Every run's fetches must
    equal its own feed (world size 1), so a replay whose graph lacks the
    collectives returns stale or unwritten memory, not the new feed."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.ops import collective
    from paddle_tpu_torch.parallel import CompiledProgram
    from paddle_tpu_torch.static.helper import LayerHelper
    ir.reset_unique_names()
    main = ir.Program()
    with ir.program_guard(main, ir.Program()):
        x = static.data("x", [-1, 256], append_batch_size=False)
        gathered = LayerHelper("c_allgather").append_simple(
            {"X": x}, {"axis_name": "dp"})
        scattered = LayerHelper("c_reducescatter").append_simple(
            {"X": gathered}, {"axis_name": "dp"})
    prog = CompiledProgram(main).with_data_parallel(mesh=mesh)
    exe, scope = Executor(dev), Scope()
    rng = np.random.RandomState(361)
    feeds = [rng.randn(64, 256).astype(np.float32) for _ in range(6)]

    def run(f):
        return [np.asarray(v) for v in exe.run(
            prog, feed={"x": f}, fetch_list=[gathered, scattered],
            scope=scope)]
    early = [run(f) for f in feeds[:2]]              # eager, capture
    collective.reset_staged()
    host, late = {}, []
    device_rows(torch, lambda: late.extend(run(f) for f in feeds[2:]),
                host)
    issued = dict(collective.issued)
    errs = [max(float(np.abs(o - f).max()) for o in outs)
            for outs, f in zip(early + late, feeds)]
    print(f"phase 36(b) c_allgather + c_reducescatter at world size 1 "
          f"over nccl: max |fetch - feed| per run {errs} (runs 3-6 "
          f"replayed: {host['graph_launches']} graph launches, collectives "
          f"issued from Python {issued}) {tag}")
    assert max(errs) == 0.0, errs
    assert host["graph_launches"] >= len(feeds) - 2, host
    assert not any(issued.values()), issued
    return {"max_abs_err_by_run": errs,
            "graph_launches_4_replays": host["graph_launches"],
            "issued_in_replays": issued}


# -- 37. sequence and expert parallel ----------------------------------------
def lm_params(torch, seed, dev, c):
    """tests/test_long_context_training.py's causal LM at `c`'s widths
    (tied embedding, no norms), weights from numpy's `seed`."""
    r = np.random.RandomState(seed)
    h, L = c["hidden"], c["layers"]

    def w(*shape):
        return torch.tensor((r.standard_normal(shape) * 0.02).astype(
            np.float32), device=dev)
    p = {"emb": w(c["vocab"], h)}
    for i in range(L):
        p[f"qkv_w{i}"] = w(h, 3 * h)
        p[f"out_w{i}"] = w(h, h)
        p[f"mlp1_w{i}"] = w(h, 4 * h)
        p[f"mlp2_w{i}"] = w(4 * h, h)
        for name, n in (("qkv_b", 3 * h), ("out_b", h), ("mlp1_b", 4 * h),
                        ("mlp2_b", h)):
            p[f"{name}{i}"] = torch.zeros(n, device=dev)
    return p


def lm_loss_sum(torch, p, ids, labels, attn, c):
    """Sum over the given tokens of the LM's next-token NLL."""
    import torch.nn.functional as F
    b, t = ids.shape
    nh, dh = c["heads"], c["hidden"] // c["heads"]
    x = p["emb"][ids]
    for i in range(c["layers"]):
        qkv = x @ p[f"qkv_w{i}"] + p[f"qkv_b{i}"]
        q, k, v = (a.reshape(b, t, nh, dh) for a in qkv.chunk(3, dim=-1))
        x = x + attn(q, k, v).reshape(b, t, -1) @ p[f"out_w{i}"] \
            + p[f"out_b{i}"]
        m = F.gelu(x @ p[f"mlp1_w{i}"] + p[f"mlp1_b{i}"],
                   approximate="tanh")
        x = x + m @ p[f"mlp2_w{i}"] + p[f"mlp2_b{i}"]
    logp = torch.log_softmax(x @ p["emb"].t(), dim=-1)
    return -logp.gather(-1, labels[..., None]).sum()


def _lm_tokens(seed, c):
    r = np.random.RandomState(seed + 37)
    ids = r.randint(0, c["vocab"], (c["batch"], c["seq"] + 1))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def rank_lm(ctx, impl, seed, c):
    """37(a): one training step of the LM with the sequence over sp=4:
    each rank its T/4 tokens, the attention `impl`; the loss and the
    gradients summed over the group. Returns them (rank 0) with the
    rank's flash launches and staged copies."""
    import torch
    from paddle_tpu_torch.ops import collective
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.parallel import (make_mesh, shard_map_attention,
                                           shard_sequence)
    _rank_setup(torch, ctx)
    mesh = make_mesh({"sp": ctx.world}, device=ctx.device)
    p = {k: v.requires_grad_() for k, v in
         lm_params(torch, seed, ctx.device, c).items()}
    ids, labels = (shard_sequence(torch.tensor(a, device=ctx.device), mesh)
                   for a in _lm_tokens(seed, c))
    n_tok = c["batch"] * c["seq"]

    def attn(q, k, v):
        return shard_map_attention(mesh, q, k, v, causal=True, impl=impl)
    _sync(torch, ctx.device)
    tfa.reset_launch_counts()
    collective.reset_staged()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = lm_loss_sum(torch, p, ids, labels, attn, c) / n_tok
        grads = torch.autograd.grad(loss, list(p.values()))
    with torch.no_grad():
        from paddle_tpu_torch.parallel import bind_mesh
        with bind_mesh(mesh):
            loss = collective.all_reduce(loss.detach(), "sp")
            grads = [collective.all_reduce(g, "sp") for g in grads]
    _sync(torch, ctx.device)
    wall = time.perf_counter() - t0
    out = {"launches": _flash_launches(tfa), "staged": dict(
        collective.staged), "wall_s": wall, "loss": float(loss),
        "jax_loaded": ctx.jax_loaded}
    if ctx.rank == 0:
        out["grads"] = {k: g.cpu().numpy() for k, g in zip(p, grads)}
    return out


def rank_moe(ctx, seed, c):
    """37(b): switch_moe over ep=4, each rank 2 of the 8 experts; the
    output, aux loss and gradients (summed over the group) of rank 0."""
    import torch
    from paddle_tpu_torch.ops.collective import all_reduce
    from paddle_tpu_torch.parallel import bind_mesh, make_mesh, switch_moe
    _rank_setup(torch, ctx)
    mesh = make_mesh({"ep": ctx.world}, device=ctx.device)
    x, gw, wi, wo, cot = _moe_inputs(seed, c)
    e = gw.shape[1]
    k = e // ctx.world
    sl = slice(ctx.rank * k, (ctx.rank + 1) * k)
    leaves = [torch.tensor(a, device=ctx.device).requires_grad_()
              for a in (x, gw, wi[sl], wo[sl])]
    cot_t = torch.tensor(cot, device=ctx.device)
    with bind_mesh(mesh), torch.enable_grad():
        y, aux = switch_moe(*leaves, mesh=mesh)
        g = torch.autograd.grad(((y * cot_t).sum() + 0.01 * aux)
                                / ctx.world, leaves)
        gx, ggw = all_reduce(g[0], "ep"), all_reduce(g[1], "ep")
    return {"y": y.detach().cpu().numpy(), "aux": float(aux),
            "gx": gx.cpu().numpy(), "ggw": ggw.cpu().numpy(),
            "gwi": g[2].cpu().numpy(), "gwo": g[3].cpu().numpy()}


def _moe_inputs(seed, c):
    r = np.random.RandomState(seed + 371)
    f = np.float32
    return (r.standard_normal((c["n"], c["d"])).astype(f),
            (r.standard_normal((c["d"], c["e"])) * 0.1).astype(f),
            (r.standard_normal((c["e"], c["d"], c["h"])) * 0.02).astype(f),
            (r.standard_normal((c["e"], c["h"], c["d"])) * 0.02).astype(f),
            r.standard_normal((c["n"], c["d"])).astype(f))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def par_flash_cases(torch, tfa, seed, tag, dev, c):
    """37's kernels against their plain version at the shapes the ranks
    give them: a ring step's diagonal chunk (causal, q, k, v views of
    the fused projection) and a past chunk (no mask, received K/V) of
    T_local rows through `flash_attention_lse` with cotangents on o and
    the lse, and Ulysses' head shard (all T, heads / sp) through
    `flash_attention`, causal; every output within FLASH_TOL's f32
    relative error. These launches are not counted on the path: the
    ranks' own counters are."""
    b, t, heads = c["batch"], c["seq"], c["heads"]
    t_local, d = t // RANK_WORLD, c["hidden"] // heads
    cases = [
        ("ring diagonal chunk", lambda: flash_lse_case(
            torch, tfa, dev, b, t_local, t_local, heads, d, True, True,
            seed)),
        ("ring past chunk", lambda: flash_lse_case(
            torch, tfa, dev, b, t_local, t_local, heads, d, False, False,
            seed)),
        ("ulysses head shard", lambda: flash_case(
            torch, tfa, dev, torch.float32, b, t, heads // RANK_WORLD, d,
            tk=t, causal=True, seed=seed)),
    ]
    tol = FLASH_TOL["float32"]
    out = {}
    for label, run in cases:
        errs, launched = run()
        torch.cuda.empty_cache()
        print(f"phase 37 flash f32 {label}: " + ", ".join(
            f"{k} abs {a:.3g} rel {r:.3g}" for k, (a, r) in errs.items())
            + f" (tolerance rel {tol}; launched {launched}) {tag}")
        assert set(launched) == set(FLASH_F32), (label, launched)
        bad = {k: r for k, (_, r) in errs.items() if not r <= tol}
        assert not bad, f"flash {label}: relative errors {bad} > {tol}"
        out[label] = errs
    return out


def par_sequence_expert(torch, tfa, pool, seed, tag, dev="cuda"):
    """Phase 37. First the f32 flash pair against its plain version at
    the ranks' shapes (`par_flash_cases`). (a) the causal LM at PAR_LM's
    GPT-2-small widths, B=1,
    T=8192 over sp=4 (T_local 2048): one training step under
    `ring_flash` and one under `ulysses_flash`, the loss and every
    parameter gradient against the single-process step on the flash
    kernels over the whole sequence (PAR_TOL; the tolerance was checked
    in float64 on the plain path first), each rank's K1/K2 launches from
    its own counters (> 0). (b) switch_moe at PAR_MOE over ep=4 against
    the unsharded call, output, aux loss and gradients. Returns (row,
    the ranks' flash launches summed)."""
    c = PAR_LM
    out = {"flash_cases": par_flash_cases(torch, tfa, seed, tag, dev, c)}
    p = {k: v.requires_grad_() for k, v in lm_params(torch, seed, dev,
                                                     c).items()}
    ids, labels = (torch.tensor(a, device=dev) for a in _lm_tokens(seed, c))

    def attn(q, k, v):
        return tfa.flash_attention(q, k, v, causal=True)
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss = lm_loss_sum(torch, p, ids, labels, attn, c) / (
            c["batch"] * c["seq"])
        grads = torch.autograd.grad(loss, list(p.values()))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    want = {k: g.cpu().numpy() for k, g in zip(p, grads)}
    want_loss = float(loss)
    del p, grads, loss
    torch.cuda.empty_cache()
    out["lm_single_s"], launches = ref_s, {k: 0 for k in FLASH_KERNELS}
    for impl in ("ring_flash", "ulysses_flash"):
        t0 = time.perf_counter()
        got = pool.run(__file__, "rank_lm", impl, seed, c,
                       timeout=RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        g0 = got[0]
        loss_err = abs(g0["loss"] - want_loss) / abs(want_loss)
        grad_err = max(_rel(g0["grads"][k], want[k]) for k in want)
        per_rank = [g["launches"] for g in got]
        print(f"phase 37(a) LM {c} sp={RANK_WORLD} {impl}: loss "
              f"{g0['loss']:.6f} vs {want_loss:.6f} (rel {loss_err:.3g}), "
              f"max gradient err / max |grad| {grad_err:.3g}; per-rank "
              f"flash launches {per_rank}; staged {g0['staged']}; step "
              f"{g0['wall_s']:.2f} s (four ranks share the card) {tag}")
        assert not any(g["jax_loaded"] for g in got)
        assert loss_err <= PAR_TOL["lm_loss"], (g0["loss"], want_loss)
        assert grad_err <= PAR_TOL["lm_grad"], grad_err
        for g in got:
            assert all(g["launches"][k] > 0 for k in FLASH_F32), (
                impl, g["launches"])
            for k, n in g["launches"].items():
                launches[k] += n
        out[impl] = {"loss": g0["loss"], "single_loss": want_loss,
                     "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                     "rank_launches": per_rank, "staged": g0["staged"],
                     "rank0_step_s": g0["wall_s"], "wall_s": wall}
    del want
    # (b) MoE
    from paddle_tpu_torch.parallel import switch_moe
    x, gw, wi, wo, cot = _moe_inputs(seed, PAR_MOE)
    leaves = [torch.tensor(a, device=dev).requires_grad_()
              for a in (x, gw, wi, wo)]
    with torch.enable_grad():
        y, aux = switch_moe(*leaves)
        g = torch.autograd.grad((y * torch.tensor(cot, device=dev)).sum()
                                + 0.01 * aux, leaves)
    ref = [y.detach().cpu().numpy()] + [t.cpu().numpy() for t in g]
    got = pool.run(__file__, "rank_moe", seed, PAR_MOE,
                   timeout=RANK_TIMEOUT_S)
    k = PAR_MOE["e"] // RANK_WORLD
    errs = {"y": max(_rel(r["y"], ref[0]) for r in got),
            "aux": max(abs(r["aux"] - float(aux)) for r in got),
            "gx": max(_rel(r["gx"], ref[1]) for r in got),
            "ggw": max(_rel(r["ggw"], ref[2]) for r in got),
            "gwi": max(_rel(r["gwi"], ref[3][i * k:(i + 1) * k])
                       for i, r in enumerate(got)),
            "gwo": max(_rel(r["gwo"], ref[4][i * k:(i + 1) * k])
                       for i, r in enumerate(got))}
    print(f"phase 37(b) switch_moe {PAR_MOE} ep={RANK_WORLD}: errors "
          f"against the unsharded call {errs} {tag}")
    assert all(v <= PAR_TOL["moe"] for v in errs.values()), errs
    out["moe"] = errs
    return out, launches


# -- 38. pipeline ------------------------------------------------------------
def _bert_template(torch, dev, count):
    """`count` BERT-base encoder layers (flash attention, no dropout):
    the structure a stage function runs with a chunk's parameters."""
    from paddle_tpu_torch.models.bert import BertConfig, BertLayer
    cfg = BertConfig(attention_impl="flash", hidden_dropout=0.0,
                     attention_dropout=0.0)
    return [BertLayer(cfg, device=dev).eval() for _ in range(count)]


def _bert_layer_params(torch, dev, first, count, seed):
    """Layers first .. first+count-1's weights, layer i's from numpy's
    seed + i (normal 0.02, zero biases, unit norm scales), named
    "{j}.{parameter}" for the j-th layer of the chunk."""
    names = [(n, tuple(t.shape)) for n, t in
             _bert_template(torch, "cpu", 1)[0].named_parameters()]
    params = {}
    for j in range(count):
        r = np.random.RandomState(seed + first + j)
        for name, shape in names:
            a = (r.standard_normal(shape) * 0.02).astype(np.float32)
            if name.endswith("bias"):
                a[:] = 0.0
            elif name.startswith("ln"):
                a[:] = 1.0
            params[f"{j}.{name}"] = torch.tensor(a, device=dev)
    return params


def _bert_stage_fn(torch, layers):
    """stage_fn(params, x): the template layers in order, each with its
    "{j}." parameters (torch.func.functional_call)."""
    from torch.func import functional_call

    def fn(p, x):
        for j, layer in enumerate(layers):
            own = {k.split(".", 1)[1]: v for k, v in p.items()
                   if k.split(".", 1)[0] == str(j)}
            x = functional_call(layer, own, (x, None))
        return x
    return fn


def _bert_inputs(seed, c):
    r = np.random.RandomState(seed + 38)
    b = c["micro"] * c["mb_batch"]
    x = (r.standard_normal((b, c["seq"], 768)) * 0.5).astype(np.float32)
    tgt = r.standard_normal((b, c["seq"], 768)).astype(np.float32)
    return x, tgt


def _mse(y, t):
    return ((y - t) ** 2).mean()


def rank_bert_pipe(ctx, schedule, v, seed, c):
    """38: BERT-base's encoder over pp=4 under `schedule` (v virtual
    stages a rank): two fused training steps (the first's wall is the
    warm-up), this rank's stage gradients and the measured bubble."""
    import torch
    from paddle_tpu_torch.ops import collective
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.parallel import Pipeline, make_mesh
    _rank_setup(torch, ctx)
    S = ctx.world
    per = c["layers"] // (S * v)
    mesh = make_mesh({"pp": S}, device=ctx.device)
    firsts = [(chunk * S + ctx.rank) * per for chunk in range(v)]
    chunks = [_bert_layer_params(torch, ctx.device, f, per, seed)
              for f in firsts]
    pipe = Pipeline(mesh, _bert_stage_fn(torch, _bert_template(
        torch, ctx.device, per)), S, c["micro"], schedule=schedule,
        virtual_stages=v)
    x, tgt = (torch.tensor(a, device=ctx.device)
              for a in _bert_inputs(seed, c))
    losses = []
    stage_params = chunks if v > 1 else chunks[0]
    for _ in range(2):
        with torch.no_grad():
            pipe(stage_params, x)           # the forward-only wall
        tfa.reset_launch_counts()
        collective.reset_staged()
        loss, grads = pipe.loss_and_grad(_mse, stage_params, x, tgt)
        losses.append(float(loss))
    grads = grads if v > 1 else [grads]
    return {"loss": losses[-1], "losses": losses,
            "grads": [{k: g.cpu().numpy() for k, g in gc.items()}
                      for gc in grads],
            "firsts": firsts, "per": per,
            "launches": _flash_launches(tfa),
            "staged": dict(collective.staged),
            "bubble_model": pipe.bubble_fraction(),
            "bubble_measured": pipe.bubble_fraction(measured=True),
            "tick_times": pipe.measured_tick_times(),
            "jax_loaded": ctx.jax_loaded}


def par_pipeline(torch, pool, seed, tag, dev="cuda"):
    """Phase 38. BERT-base's 12 encoder layers (flash attention, K1-K4)
    over pp=4 ranks, f32, PAR_BERT's M=8 microbatches of 2 x 512, under
    `1f1b` (3 layers a stage) and `interleaved` with v=3 (1 layer a
    virtual stage); the embeddings and the head run outside (the input
    is the embeddings' output, the loss an MSE against a target). Gate:
    the loss and every stage's gradients against the single-process
    12-layer step (PAR_TOL). Prints schedule_report's model bubble
    beside the one measured from the step walls. Returns (row, the
    ranks' flash launches summed)."""
    from paddle_tpu_torch.parallel import schedule_report
    c = PAR_BERT
    layers = _bert_template(torch, dev, c["layers"])
    params = {k: v.requires_grad_() for k, v in _bert_layer_params(
        torch, dev, 0, c["layers"], seed).items()}
    x, tgt = (torch.tensor(a, device=dev) for a in _bert_inputs(seed, c))
    t0 = time.perf_counter()
    with torch.enable_grad():
        y = _bert_stage_fn(torch, layers)(params, x)
        loss = _mse(y, tgt)
        g = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    want = {k: t.cpu().numpy() for k, t in zip(params, g)}
    want_loss = float(loss)
    del params, g, y, loss
    torch.cuda.empty_cache()
    out, launches = {"single_s": ref_s}, {k: 0 for k in FLASH_KERNELS}
    for schedule, v in (("1f1b", 1), ("interleaved", c["virtual"])):
        t0 = time.perf_counter()
        got = pool.run(__file__, "rank_bert_pipe", schedule, v, seed, c,
                       timeout=RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        assert not any(r["jax_loaded"] for r in got)
        loss_err = max(abs(r["loss"] - want_loss) / abs(want_loss)
                       for r in got)
        grad_err = 0.0
        for r in got:
            for first, gc in zip(r["firsts"], r["grads"]):
                for k, a in gc.items():
                    j, name = k.split(".", 1)
                    grad_err = max(grad_err, _rel(
                        a, want[f"{first + int(j)}.{name}"]))
        rep = schedule_report(schedule, RANK_WORLD, c["micro"], v)
        per_rank = [r["launches"] for r in got]
        print(f"phase 38 BERT-base encoder pp={RANK_WORLD} {schedule} "
              f"(v={v}, M={c['micro']}): loss {got[0]['loss']:.6f} vs "
              f"{want_loss:.6f} (rel {loss_err:.3g}), max gradient err / "
              f"max |grad| {grad_err:.3g}; bubble model "
              f"{rep['bubble_model']:.3f} (fill-drain formula "
              f"{rep['bubble_formula_fill_drain']:.3f}), measured "
              f"{[r['bubble_measured'] for r in got]}; per-rank flash "
              f"launches {per_rank}; staged {got[0]['staged']} {tag}")
        assert loss_err <= PAR_TOL["bert_loss"], (got[0]["loss"], want_loss)
        assert grad_err <= PAR_TOL["bert_grad"], grad_err
        for r in got:
            assert all(r["launches"][k] > 0 for k in FLASH_F32), (
                schedule, r["launches"])
            for k, n in r["launches"].items():
                launches[k] += n
        out[schedule] = {
            "loss": got[0]["loss"], "single_loss": want_loss,
            "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "schedule_report": {k: rep[k] for k in (
                "ticks", "peak_in_flight", "bubble_model",
                "bubble_formula_fill_drain")},
            "bubble_measured": [r["bubble_measured"] for r in got],
            "tick_times": got[0]["tick_times"],
            "rank_launches": per_rank, "staged": got[0]["staged"],
            "wall_s": wall}
    return out, launches


def parallel_phases(torch, tfa, seed, tag, device="cuda"):
    """Phases 36-38 over one pool of RANK_WORLD rank processes (started
    together; each loads the kernel library phase 1 built); every rank
    is killed when they end. Returns (row, the flash launches of the
    ranks in phases 37 and 38)."""
    import tempfile
    from paddle_tpu_torch.parallel.ranks import RankPool
    t0 = time.perf_counter()
    store = os.path.join(tempfile.mkdtemp(prefix="ranks-"), "store")
    pool = RankPool(RANK_WORLD, backend="gloo", device=device, store=store,
                    timeout=RANK_TIMEOUT_S,
                    command=[sys.executable, os.path.abspath(__file__),
                             "--rank-worker"])
    try:
        out = {"pool_start_s": time.perf_counter() - t0}
        ready = pool.run_module("paddle_tpu_torch.parallel.ranks", "_ready")
        print(f"phases 36-38: pool of {RANK_WORLD} gloo ranks up in "
              f"{out['pool_start_s']:.1f} s {tag}")
        assert not any(r["jax_loaded"] for r in ready), ready
        out["gloo_cuda_probe"] = gloo_cuda_probe(pool, tag)
        t = time.perf_counter()
        out["data_parallel"] = par_data_parallel(torch, pool, seed, tag,
                                                 device)
        out["phase36_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["sequence_expert"], l37 = par_sequence_expert(
            torch, tfa, pool, seed, tag, device)
        out["phase37_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["pipeline"], l38 = par_pipeline(torch, pool, seed, tag, device)
        out["phase38_s"] = time.perf_counter() - t
    finally:
        pool.close()
    out["total_s"] = time.perf_counter() - t0
    launches = {k: l37[k] + l38[k] for k in FLASH_KERNELS}
    print(f"phases 36-38: {out['total_s']:.1f} s (36: "
          f"{out['phase36_s']:.1f}, 37: {out['phase37_s']:.1f}, 38: "
          f"{out['phase38_s']:.1f}); the ranks' flash launches {launches} "
          f"{tag}")
    return out, launches


# ---------------------------------------------------------------------------
# 39. the parameter server, the launcher and dataset training
# ---------------------------------------------------------------------------

#: phase 39's trainer batch (BASELINE config 5: DeepFMConfig() at batch
#: 1024 a trainer), the MultiSlot records the phase writes (PS_FILES
#: files), and each leg's depth
PS_BATCH = 1024
PS_RECORDS = 40960
PS_FILES = 8
PS_SYNC_STEPS = 20          # (a): one trainer, synchronous pushes
PS_FLEET_STEPS = 60         # (b): each of the two launched trainers
PS_GEO_STEPS = 5            # (b): the dense part's GeoCommunicator k
PS_COLLECTIVE_STEPS = 5     # (c): global batch 2 x PS_BATCH
PS_DATASET_FILES = 2        # (d): the files train_from_dataset reads
PS_SPARSE_LR = 0.05         # the server's SGD on the two sparse tables
PS_DENSE_LR = 0.05          # the trainer's SGD on dense_w and the MLP
PS_CTR_LR = 0.05            # (c), (d): the static program's SGD
PS_TABLES = {"w1": 1, "emb": 2, "dense": 3}
PS_LEG_TIMEOUT_S = 300
#: (a) card against the CPU: per-step loss (relative) and the touched
#: rows of both tables (of their largest magnitude) after 20 chained f32
#: steps, where a ReLU pre-activation within rounding of 0 flips its mask
#: between the two and moves the hot rows (slot ids are Zipf: id 0 is in
#: ~25% of a batch's rows, ~260 duplicate pushes a step). The rows gate
#: lies between the faithful runs (2.06e-06 - 6.17e-05 of max on an H100)
#: and the bf16-forward control (8.57e-04 - 1.02e-03), near their
#: geometric mean; (c) each rank's loss against one process (absolute:
#: test_dist_parity.py's bar)
PS_TOL = dict(loss=1e-5, rows=2.5e-4, collective=1e-5)


def ps_config():
    from paddle_tpu_torch.models.deepfm import DeepFMConfig
    return DeepFMConfig()


def ps_slots(cfg):
    """The MultiSlot schema: label, the dense features, one sparse slot of
    one id per categorical feature (C0..C25 at config 5)."""
    return ([("label", "dense", 1), ("dense", "dense", cfg.dense_dim)]
            + [(f"C{s}", "sparse", 0) for s in range(cfg.num_slots)])


def ps_records(rng, n, cfg):
    """`n` synthetic CTR records: Gaussian dense features, Zipf-skewed
    per-slot ids (many repeats in a batch, as in CTR logs), a label from
    the dense features and slot 0's id."""
    w = rng.randn(cfg.dense_dim) / np.sqrt(cfg.dense_dim)
    effect = rng.randn(cfg.vocab_per_slot)
    dense = rng.randn(n, cfg.dense_dim).astype(np.float32)
    ids = np.minimum(rng.zipf(1.3, (n, cfg.num_slots)) - 1,
                     cfg.vocab_per_slot - 1).astype(np.int64)
    score = dense @ w + 0.5 * effect[ids[:, 0]] + 0.3 * rng.randn(n)
    return dense, ids, (score > 0).astype(np.int64)


def ps_write_files(dirname, seed, cfg, records=None, files=None):
    """Write `records` (PS_RECORDS) MultiSlot lines from `seed` into
    `files` (PS_FILES) files; returns their paths."""
    records = PS_RECORDS if records is None else records
    files = PS_FILES if files is None else files
    rng = np.random.RandomState(seed + 39)
    dense, ids, label = ps_records(rng, records, cfg)
    fmt = " ".join(["1 %d", f"{cfg.dense_dim}"]
                   + ["%.9g"] * cfg.dense_dim + ["1 %d"] * cfg.num_slots)
    rows = np.concatenate([label[:, None].astype(object),
                           dense.astype(object), ids.astype(object)], 1)
    paths, per = [], records // files
    for f in range(files):
        path = os.path.join(dirname, f"part-{f:03d}")
        with open(path, "w") as fh:
            fh.write("\n".join(fmt % tuple(r)
                               for r in rows[f * per:(f + 1) * per]))
            fh.write("\n")
        paths.append(path)
    return paths


def ps_dataset(files, cfg, batch, fleet=None, seed=0, kind="InMemoryDataset",
               threads=4):
    """The files through the port's fluid_dataset: loaded, and shuffled
    globally (a trainer's hash shard under `fleet`) when in memory."""
    from paddle_tpu_torch.io.fluid_dataset import DatasetFactory
    ds = DatasetFactory().create_dataset(kind)
    ds.set_slots(ps_slots(cfg))
    ds.set_batch_size(batch)
    ds.set_thread(threads)
    ds.set_filelist(list(files))
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        ds.global_shuffle(fleet, seed)
    return ds


def ps_arrays(feed, cfg):
    """A dataset batch -> (dense [B, 13], per-slot ids [B, 26], labels
    [B]) as numpy."""
    ids = np.concatenate([np.asarray(feed[f"C{s}"])[:, :1]
                          for s in range(cfg.num_slots)], 1)
    return (np.asarray(feed["dense"], np.float32), ids,
            np.asarray(feed["label"]).reshape(-1))


def ps_tables(cfg, dense_size=None):
    """The server's tables: w1 (dim 1) and emb (dim 16), SGD; with
    `dense_size`, the dense table the GeoCommunicator syncs."""
    from paddle_tpu_torch import ps
    out = [ps.TableConfig(PS_TABLES["w1"], "sparse", dim=1, optimizer="sgd",
                          lr=PS_SPARSE_LR),
           ps.TableConfig(PS_TABLES["emb"], "sparse", dim=cfg.embed_dim,
                          optimizer="sgd", lr=PS_SPARSE_LR)]
    if dense_size is not None:
        out.append(ps.TableConfig(PS_TABLES["dense"], "dense",
                                  size=dense_size, optimizer="sgd", lr=1.0))
    return out


class PSTrainer:
    """The parameter-server trainer step of tests/test_dist_parity.py's
    PS trainer at DeepFM's full width: pull the batch's w1 and emb rows
    for the flat ids, the logit from them and the local dense_w + MLP on
    `device` (DeepFM.forward_rows), push the rows' gradients (duplicate
    ids stay duplicate rows) synchronously or through `comm`, SGD on the
    dense part, and a GeoCommunicator sync of the dense part when `geo`
    is given. Counts the bytes it copies host -> device and back, and
    times each step's parts: the pulls and the pushes on the host's
    clock, the model's forward, backward and dense update on the card's
    (CUDA events; none on the CPU). `autocast`: a dtype the forward
    runs in under torch.autocast (phase 39(a)'s control)."""

    def __init__(self, torch, model, client, comm=None, geo=None,
                 autocast=None):
        self.torch, self.model, self.client = torch, model, client
        self.comm, self.geo, self.autocast = comm, geo, autocast
        self.dev = next(model.mlp.parameters()).device
        self.dense_params = [p for n, p in model.named_parameters()
                             if not n.startswith(("w1.", "emb."))]
        self.bytes = {"h2d": 0, "d2h": 0}
        self.times = {"pull_ms": [], "push_ms": [], "device_ms": []}
        self.steps = 0

    def _event(self):
        if self.dev.type != "cuda":
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _to(self, a):
        self.bytes["h2d"] += a.nbytes
        return self.torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def _host(self, t):
        a = t.detach().cpu().numpy()
        self.bytes["d2h"] += a.nbytes
        return a

    def dense_vector(self):
        return np.concatenate([self._host(p).reshape(-1)
                               for p in self.dense_params])

    def load_dense(self, vec):
        t = self._to(vec.astype(np.float32))
        i = 0
        with self.torch.no_grad():
            for p in self.dense_params:
                p.copy_(t[i:i + p.numel()].view_as(p))
                i += p.numel()

    def step(self, dense, ids, labels):
        torch, cfg = self.torch, self.model.cfg
        b, s, d = ids.shape[0], cfg.num_slots, cfg.embed_dim
        flat = self.model.flat_ids(ids).reshape(-1)
        t = time.perf_counter()
        w1 = self.client.pull_sparse(PS_TABLES["w1"], flat, 1)
        emb = self.client.pull_sparse(PS_TABLES["emb"], flat, d)
        self.times["pull_ms"].append(1e3 * (time.perf_counter() - t))
        w1_t = self._to(w1).view(b, s, 1).requires_grad_()
        emb_t = self._to(emb).view(b, s, d).requires_grad_()
        dense_t, labels_t = self._to(dense), self._to(labels)
        ev = [self._event()]
        with torch.autocast(self.dev.type, dtype=self.autocast,
                            enabled=self.autocast is not None):
            logit = self.model.forward_rows(dense_t, w1_t, emb_t)
            loss = self.model.logit_loss(logit[:, 0].float(), labels_t)
        grads = torch.autograd.grad(loss, [w1_t, emb_t] + self.dense_params)
        ev.append(self._event())
        g1 = self._host(grads[0]).reshape(-1, 1)
        g2 = self._host(grads[1]).reshape(-1, d)
        push = (self.client.push_sparse if self.comm is None
                else self.comm.push_sparse_async)
        t = time.perf_counter()
        push(PS_TABLES["w1"], flat, g1)
        push(PS_TABLES["emb"], flat, g2)
        self.times["push_ms"].append(1e3 * (time.perf_counter() - t))
        ev.append(self._event())
        with torch.no_grad():
            for p, g in zip(self.dense_params, grads[2:]):
                p.sub_(PS_DENSE_LR * g)
        ev.append(self._event())
        self.steps += 1
        if self.geo is not None:
            if self.steps % self.geo.k == 0:    # the geo step that syncs
                self.geo.local = self.dense_vector()
            if self.geo.maybe_sync():
                self.load_dense(self.geo.local)
        out = float(self._host(loss))
        if ev[0] is not None:         # the loss's copy waited for them
            self.times["device_ms"].append(ev[0].elapsed_time(ev[1])
                                           + ev[2].elapsed_time(ev[3]))
        return out


def _ps_launch_counts():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    return {**da.launch_counts, **tfa.launch_counts, **k8.launch_counts}


def _ps_reset_counts():
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
    for mod in (da, tfa, k8):
        mod.reset_launch_counts()


def ps_sync_leg(torch, cfg, files, seed, tag, dev="cuda"):
    """(a) One trainer, synchronous pushes, PS_SYNC_STEPS steps on `dev`
    against a fresh port Server, and on the CPU against a second fresh
    server, on the same batches from the same weights: per-step losses
    and the touched rows of both tables. The control, a third CPU run
    whose forward runs in bfloat16 (torch.autocast), must fail both
    gates against the CPU run. The card run's steps are split into the
    pulls and the pushes (host clock) and the model's device work (CUDA
    events)."""
    from paddle_tpu_torch import nn, ps
    from paddle_tpu_torch.models.deepfm import DeepFM
    t0 = time.perf_counter()
    ds = ps_dataset(files, cfg, PS_BATCH, seed=seed)
    batches = [ps_arrays(f, cfg) for f, _ in zip(ds, range(PS_SYNC_STEPS))]
    assert len(batches) == PS_SYNC_STEPS, len(batches)
    nn.seed(seed)
    ref = DeepFM(cfg, device="cpu")
    runs = {}
    for key, where, cast in (("dev", dev, None), ("cpu", "cpu", None),
                             ("control", "cpu", torch.bfloat16)):
        model = DeepFM(cfg, device=where)
        model.load_state_dict(ref.state_dict())
        srv = ps.Server(tables=ps_tables(cfg), num_workers=1).start()
        cli = ps.Client([f"127.0.0.1:{srv.port}"]).connect()
        tr = PSTrainer(torch, model, cli, autocast=cast)
        losses, times = [], []
        for b in batches:
            t = time.perf_counter()
            losses.append(tr.step(*b))
            times.append(time.perf_counter() - t)
        touched = np.unique(np.concatenate(
            [model.flat_ids(b[1]).reshape(-1) for b in batches]))
        rows = (cli.pull_sparse(PS_TABLES["w1"], touched, 1),
                cli.pull_sparse(PS_TABLES["emb"], touched, cfg.embed_dim))
        runs[key] = dict(losses=losses, rows=rows, times=times,
                         parts={k: float(np.median(v[1:])) if v[1:] else None
                                for k, v in tr.times.items()},
                         bytes=dict(tr.bytes), n_rows=len(touched),
                         server_rows=[srv.sparse_rows(1),
                                      srv.sparse_rows(2)])
        cli.stop_servers()
        srv.join()
        cli.close()
        del model

    def errs(x, y):
        return (max(abs(u - v) / abs(v) for u, v in zip(x["losses"],
                                                         y["losses"])),
                max(float(np.abs(u - v).max()) / float(np.abs(v).max())
                    for u, v in zip(x["rows"], y["rows"])))

    a, c = runs["dev"], runs["cpu"]
    loss_err, rows_err = errs(a, c)
    ctl_loss_err, ctl_rows_err = errs(runs["control"], c)
    out = {"steps": PS_SYNC_STEPS, "losses": a["losses"],
           "cpu_losses": c["losses"], "loss_err": loss_err,
           "rows_err": rows_err, "control_loss_err": ctl_loss_err,
           "control_rows_err": ctl_rows_err, "touched_rows": a["n_rows"],
           "server_rows": a["server_rows"],
           "first_step_ms": 1e3 * a["times"][0],
           "step_ms": 1e3 * float(np.median(a["times"][1:])),
           "cpu_step_ms": 1e3 * float(np.median(c["times"][1:])),
           "parts_ms": a["parts"],
           "bytes": a["bytes"], "seconds": time.perf_counter() - t0}
    parts = ", ".join(f"{k[:-3]} {v:.3f} ms" for k, v in a["parts"].items()
                      if v is not None)
    print(f"phase 39(a) one trainer, sync push, {PS_SYNC_STEPS} steps at "
          f"batch {PS_BATCH}: losses {a['losses'][0]:.5f} -> "
          f"{a['losses'][-1]:.5f}, card vs cpu loss err {loss_err:.3g} "
          f"(gate {PS_TOL['loss']}), rows err {rows_err:.3g} of max "
          f"({a['n_rows']} touched rows; gate {PS_TOL['rows']}); control "
          f"(bf16 forward on the cpu) vs cpu loss err {ctl_loss_err:.3g}, "
          f"rows err {ctl_rows_err:.3g}; median step "
          f"{out['step_ms']:.2f} ms after a first of "
          f"{out['first_step_ms']:.1f} (cpu {out['cpu_step_ms']:.2f}), "
          f"its medians: {parts}; "
          f"host->card {a['bytes']['h2d']} B, card->host "
          f"{a['bytes']['d2h']} B; {out['seconds']:.1f} s {tag}")
    assert a["losses"][-1] < a["losses"][0], a["losses"]
    assert loss_err <= PS_TOL["loss"], loss_err
    assert rows_err <= PS_TOL["rows"], rows_err
    assert ctl_loss_err > PS_TOL["loss"] and ctl_rows_err > PS_TOL["rows"], \
        ("the bf16 control passed a gate", ctl_loss_err, ctl_rows_err)
    assert a["server_rows"] == [a["n_rows"]] * 2, (a["server_rows"],
                                                   a["n_rows"])
    return out


def ps_server_main(spec):
    """`chip_smoke.py --ps-server JSON`: phase 39(b)'s pserver, its role
    from the environment (TRAINING_ROLE=PSERVER); prints PS-SERVER with
    the tables' rows once a trainer stopped it."""
    from paddle_tpu_torch import ps
    from paddle_tpu_torch.distributed import PaddleCloudRoleMaker, fleet
    from paddle_tpu_torch.models.deepfm import DeepFMConfig
    cfg = DeepFMConfig(**spec["cfg"])
    for t in ps_tables(cfg, spec["dense_size"]):
        ps.register_table(t)
    fleet.init(PaddleCloudRoleMaker(is_collective=False))
    assert fleet.is_server()
    print("PS-SERVER-UP", flush=True)
    fleet.run_server()
    srv = ps._active_server
    print("PS-SERVER " + json.dumps({
        "sparse_rows": [srv.sparse_rows(PS_TABLES["w1"]),
                        srv.sparse_rows(PS_TABLES["emb"])],
        "jax_loaded": "jax" in sys.modules}), flush=True)
    return 0


def ps_trainer_main(spec):
    """`chip_smoke.py --ps-trainer JSON` under the launcher: one of phase
    39(b)'s trainers (PaddleCloudRoleMaker from the PADDLE_* environment,
    fleet.init_worker), sparse pushes through an AsyncCommunicator, the
    dense part through GeoCommunicator(k=PS_GEO_STEPS); prints
    PS-TRAINER."""
    import torch
    from paddle_tpu_torch import nn, ps
    from paddle_tpu_torch.distributed import PaddleCloudRoleMaker, fleet
    from paddle_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DeepFMConfig(**spec["cfg"])
    fleet.init(PaddleCloudRoleMaker(is_collective=False))
    fleet.init_worker()
    rank, n = fleet.worker_index(), fleet.worker_num()
    cli = ps.client()
    nn.seed(spec["seed"])
    model = DeepFM(cfg, device=spec["device"])
    tr = PSTrainer(torch, model, cli)
    init = tr.dense_vector()
    if rank == 0:
        cli.init_dense(PS_TABLES["dense"], init)
    cli.barrier(rank)
    dense_cfg = ps_tables(cfg, init.size)[-1]
    tr.geo = ps.GeoCommunicator(cli, dense_cfg, k_steps=PS_GEO_STEPS,
                                n_workers=n)
    tr.load_dense(tr.geo.local)
    tr.comm = ps.AsyncCommunicator(cli).start()
    _ps_reset_counts()
    ds = ps_dataset(spec["files"], cfg, spec["batch"], fleet, spec["seed"])
    losses, times = [], []
    while len(losses) < spec["steps"]:
        for feed in ds:
            if len(losses) == spec["steps"]:
                break
            t = time.perf_counter()
            losses.append(tr.step(*ps_arrays(feed, cfg)))
            times.append(time.perf_counter() - t)
    undelivered = tr.comm.stop()
    cli.barrier(rank)           # every trainer's pushes are in
    moved = None
    if rank == 0:
        final = cli.pull_dense(PS_TABLES["dense"], init.size)
        moved = float(np.abs(final - init).max())
    print("PS-TRAINER " + json.dumps({
        "rank": rank, "losses": losses, "step_s": times,
        "ready_s": spec["t_start"] and time.time() - spec["t_start"]
        - sum(times),
        "shard_records": ds.get_memory_data_size(),
        "undelivered": undelivered, "dense_moved": moved,
        "bytes": tr.bytes, "launches": _ps_launch_counts(),
        "client": cli.stats()["verbs"],
        "jax_loaded": "jax" in sys.modules}), flush=True)
    fleet.stop_worker()
    return 0


def _ps_marks(text, mark):
    return [json.loads(ln[len(mark):]) for ln in text.splitlines()
            if ln.startswith(mark)]


def _launch(args, script_args, log_dir, env):
    """`python -m paddle_tpu_torch.distributed.launch` on this file."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *args, f"--log_dir={log_dir}", os.path.abspath(__file__),
         *script_args], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _worker_logs(log_dir, n):
    out = []
    for r in range(n):
        with open(os.path.join(log_dir, f"workerlog.{r}")) as f:
            out.append(f.read())
    return out


def ps_fleet_leg(torch, cfg, files, seed, tag, dev="cuda"):
    """(b) A fleet PS cluster: one pserver process (TRAINING_ROLE=PSERVER,
    fleet.run_server) and two trainers started by the launcher on the
    card, all three started together; each trainer's last-5 mean loss
    below its first-5, both sparse tables hold rows, the dense table
    moved from its initial values, nothing left undelivered,
    fleet.stop_worker ends the server and every process exits 0."""
    from paddle_tpu_torch.models.deepfm import DeepFM
    t0 = time.perf_counter()
    ps_port, started, master = _free_ports(3)
    here = os.path.dirname(os.path.abspath(__file__))
    log_dir = tempfile.mkdtemp(prefix="pt_ps_logs_")
    pserver = f"127.0.0.1:{ps_port}"
    trainers = f"127.0.0.1:{started},127.0.0.1:{started + 1}"
    probe = DeepFM(cfg, device="cpu")
    dense_size = sum(p.numel() for n, p in probe.named_parameters()
                     if not n.startswith(("w1.", "emb.")))
    del probe
    spec = {"cfg": dict(cfg.__dict__), "seed": seed, "files": files,
            "steps": PS_FLEET_STEPS, "device": dev, "batch": PS_BATCH,
            "dense_size": dense_size, "t_start": time.time()}
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("PADDLE_", "TRAINING_ROLE"))}
    srv = subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--ps-server",
         json.dumps(spec)], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(base, TRAINING_ROLE="PSERVER", PADDLE_PORT=str(ps_port),
                 POD_IP="127.0.0.1", PADDLE_PSERVERS_IP_PORT_LIST=pserver,
                 PADDLE_TRAINER_ENDPOINTS=trainers))
    launcher = _launch(["--nproc_per_node=2", f"--started_port={started}",
                        f"--master_port={master}"],
                       ["--ps-trainer", json.dumps(spec)], log_dir,
                       dict(base, TRAINING_ROLE="TRAINER",
                            PADDLE_PSERVERS_IP_PORT_LIST=pserver))
    try:
        launch_out, _ = launcher.communicate(timeout=PS_LEG_TIMEOUT_S)
        if launcher.returncode != 0:
            srv.kill()
        srv_out, _ = srv.communicate(timeout=60)
    finally:
        for p in (launcher, srv):
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = _worker_logs(log_dir, 2)
    assert launcher.returncode == 0 and srv.returncode == 0, (
        launcher.returncode, srv.returncode, launch_out[-2000:],
        srv_out[-2000:], [lg[-3000:] for lg in logs])
    server = _ps_marks(srv_out, "PS-SERVER ")[0]
    rows = [_ps_marks(lg, "PS-TRAINER ")[0] for lg in logs]
    out = {"trainers": [], "server_rows": server["sparse_rows"],
           "seconds": time.perf_counter() - t0}
    for r in rows:
        first5 = float(np.mean(r["losses"][:5]))
        last5 = float(np.mean(r["losses"][-5:]))
        out["trainers"].append({
            "rank": r["rank"], "first5": first5, "last5": last5,
            "ready_s": r["ready_s"],
            "step_ms": 1e3 * float(np.median(r["step_s"][1:])),
            "first_step_ms": 1e3 * r["step_s"][0],
            "shard_records": r["shard_records"],
            "undelivered": r["undelivered"], "bytes": r["bytes"],
            "launches": sum(r["launches"].values()),
            "retries": sum(v["retries"] for v in r["client"].values())})
        assert last5 < first5, (r["rank"], first5, last5)
        assert r["undelivered"] == 0, r
        assert not r["jax_loaded"] and not any(r["launches"].values()), r
    moved = [r["dense_moved"] for r in rows if r["dense_moved"] is not None]
    out["dense_moved"] = moved[0]
    assert moved[0] > 1e-4, moved
    assert all(n > 0 for n in server["sparse_rows"]), server
    assert not server["jax_loaded"], server
    assert sum(t["shard_records"] for t in out["trainers"]) == len(
        files) * (PS_RECORDS // len(files)), out["trainers"]
    print(f"phase 39(b) fleet PS cluster (1 pserver + 2 launched trainers "
          f"on the card, {PS_FLEET_STEPS} steps each, async sparse pushes, "
          f"geo k={PS_GEO_STEPS}): " + "; ".join(
              f"trainer {t['rank']} first-5 {t['first5']:.5f} last-5 "
              f"{t['last5']:.5f}, median step {t['step_ms']:.2f} ms "
              f"(first {t['first_step_ms']:.1f}), "
              f"{t['shard_records']} records, host->card "
              f"{t['bytes']['h2d']} B, card->host {t['bytes']['d2h']} B, "
              f"undelivered {t['undelivered']}, outside its steps "
              f"{t['ready_s']:.1f} s" for t in out["trainers"])
          + f"; server rows {server['sparse_rows']}, dense moved "
          f"{moved[0]:.3g}; {out['seconds']:.1f} s {tag}")
    return out


def ps_ctr_program(static, ir, optimizer, ParamAttr, cfg, lr=PS_CTR_LR,
                   seed=5, dist_opt=None):
    """The static CTR program at `cfg`'s widths in the package of
    `static`: the 26 id slots concatenated and offset to the flat rows,
    static.embedding over the flat [S x V, 16] and [S x V, 1] tables, the
    embeddings concatenated with the dense features through fc 400 x 3
    (relu) and fc 1, plus the first-order sum, sigmoid cross-entropy,
    SGD (wrapped by `dist_opt`, e.g. fleet.distributed_optimizer).
    Returns (main, startup, loss)."""
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    main.random_seed = startup.random_seed = seed
    n, v = cfg.num_slots, cfg.vocab_per_slot
    with ir.program_guard(main, startup):
        label = static.data("label", [-1, 1], "float32",
                            append_batch_size=False)
        dense = static.data("dense", [-1, cfg.dense_dim], "float32",
                            append_batch_size=False)
        ids = [static.data(f"C{s}", [-1, 1], "int64",
                           append_batch_size=False) for s in range(n)]
        flat = static.elementwise_add(
            static.concat(ids, axis=1),
            static.assign(np.arange(n, dtype=np.int64) * v))
        emb = static.embedding(flat, [n * v, cfg.embed_dim],
                               param_attr=ParamAttr(name="emb"))
        w1 = static.embedding(flat, [n * v, 1],
                              param_attr=ParamAttr(name="w1"))
        h = static.concat([static.reshape(emb, [-1, n * cfg.embed_dim]),
                           dense], axis=1)
        for d in cfg.mlp_dims:
            h = static.fc(h, d, act="relu")
        first = static.unsqueeze(
            static.reduce_sum(w1, dim=[1, 2], keep_dim=False), [1])
        logit = static.elementwise_add(static.fc(h, 1), first)
        loss = static.mean(static.sigmoid_cross_entropy_with_logits(
            logit, label))
        opt = optimizer.SGD(lr)
        if dist_opt is not None:
            opt = dist_opt(opt)
        opt.minimize(loss)
    return main, startup, loss


def _ps_ctr(cfg, dist_opt=None):
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.utils.param_attr import ParamAttr
    return ps_ctr_program(static, ir, optimizer, ParamAttr, cfg,
                          dist_opt=dist_opt)


def ps_ctr_feed(dense, ids, labels):
    feed = {"label": labels.reshape(-1, 1).astype(np.float32),
            "dense": dense}
    feed.update({f"C{s}": ids[:, s:s + 1] for s in range(ids.shape[1])})
    return feed


def ps_collective_main(spec):
    """`chip_smoke.py --collective-worker JSON` under the launcher: one
    rank of phase 39(c): fleet.init (a process group over the PADDLE_*
    environment and MASTER_ADDR / MASTER_PORT), the CTR program through
    fleet.distributed_optimizer, CompiledProgram over the group's mesh;
    prints PS-COLLECTIVE."""
    stages = {"started": time.time() - spec["t_start"]}
    import torch
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.distributed import PaddleCloudRoleMaker, fleet
    from paddle_tpu_torch.models.deepfm import DeepFMConfig
    from paddle_tpu_torch.parallel import CompiledProgram, make_mesh
    from paddle_tpu_torch.weights import scope_from_jax
    torch.backends.cuda.matmul.allow_tf32 = False
    stages["imported"] = time.time() - spec["t_start"]
    cfg = DeepFMConfig(**spec["cfg"])
    fleet.init(PaddleCloudRoleMaker(), device=spec["device"])
    stages["group"] = time.time() - spec["t_start"]
    main, _, loss = _ps_ctr(cfg, fleet.distributed_optimizer)
    with np.load(spec["state"]) as f:
        state = {k: f[k] for k in f.files}
    scope = scope_from_jax(state, Scope(), fleet.device, program=main)
    stages["state"] = time.time() - spec["t_start"]
    prog = CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=make_mesh(device=fleet.device))
    exe = Executor(fleet.device)
    _ps_reset_counts()
    ready = stages["mesh"] = time.time() - spec["t_start"]
    losses, times = [], []
    with np.load(spec["batches"]) as f:
        for step in range(spec["steps"]):
            feed = ps_ctr_feed(f[f"dense{step}"], f[f"ids{step}"],
                               f[f"label{step}"])
            t = time.perf_counter()
            (lv,) = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
            times.append(time.perf_counter() - t)
    fleet.barrier_worker()
    print("PS-COLLECTIVE " + json.dumps({
        "rank": fleet.worker_index(), "losses": losses, "ready_s": ready,
        "stages_s": stages, "step_s": times,
        "backend": fleet.backend, "world": fleet.worker_num(),
        "launches": _ps_launch_counts(),
        "jax_loaded": "jax" in sys.modules}), flush=True)
    return 0


def ps_collective_leg(torch, cfg, seed, tag, dev="cuda", during=None):
    """(c) `launch --nproc_per_node=2` trains the CTR program through
    fleet.distributed_optimizer(SGD) and CompiledProgram's data
    parallelism on the card (one gloo group: the two ranks share it);
    each rank's per-step loss against one process's full-batch run.
    `during()` runs while the ranks start (their ~30 s of imports, CUDA
    context and state). Returns (results, what `during` returned)."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pt_ps_coll_")
    main, startup, loss = _ps_ctr(cfg)
    exe, scope = Executor(dev), Scope()
    exe.run(startup, scope=scope)
    state = scope_to_numpy(scope, sorted(
        v.name for v in main.list_vars() if v.persistable))
    np.savez(os.path.join(tmp, "state.npz"), **state)
    rng = np.random.RandomState(seed + 3900)
    batches = {}
    for step in range(PS_COLLECTIVE_STEPS):
        d, i, lb = ps_records(rng, 2 * PS_BATCH, cfg)
        batches.update({f"dense{step}": d, f"ids{step}": i,
                        f"label{step}": lb})
    np.savez(os.path.join(tmp, "batches.npz"), **batches)
    spec = {"cfg": dict(cfg.__dict__), "device": dev,
            "steps": PS_COLLECTIVE_STEPS,
            "state": os.path.join(tmp, "state.npz"),
            "batches": os.path.join(tmp, "batches.npz"),
            "t_start": time.time()}
    started, master = _free_ports(2)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "TRAINING_ROLE"))}
    launcher = _launch(["--nproc_per_node=2", f"--started_port={started}",
                        f"--master_port={master}"],
                       ["--collective-worker", json.dumps(spec)],
                       os.path.join(tmp, "logs"), env)
    during_out = during() if during is not None else None
    # the single-process full-batch run
    one = scope_from_jax(state, Scope(), exe.device, program=main)
    single, single_s = [], []
    for step in range(PS_COLLECTIVE_STEPS):
        feed = ps_ctr_feed(batches[f"dense{step}"], batches[f"ids{step}"],
                           batches[f"label{step}"])
        t = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=one)
        single.append(float(np.asarray(lv).reshape(-1)[0]))
        single_s.append(time.perf_counter() - t)
    try:
        launch_out, _ = launcher.communicate(timeout=PS_LEG_TIMEOUT_S)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    logs = _worker_logs(os.path.join(tmp, "logs"), 2)
    assert launcher.returncode == 0, (launcher.returncode,
                                      launch_out[-2000:],
                                      [lg[-3000:] for lg in logs])
    ranks = [_ps_marks(lg, "PS-COLLECTIVE ")[0] for lg in logs]
    err = max(abs(a - b) for r in ranks for a, b in zip(r["losses"],
                                                         single))
    out = {"single": single, "ranks": [r["losses"] for r in ranks],
           "backend": ranks[0]["backend"], "loss_err": err,
           "rank_ready_s": [r["ready_s"] for r in ranks],
           "rank_stages_s": [r["stages_s"] for r in ranks],
           "rank_step_ms": [[1e3 * x for x in r["step_s"]] for r in ranks],
           "single_step_ms": [1e3 * x for x in single_s],
           "seconds": time.perf_counter() - t0}
    print(f"phase 39(c) fleet collective ({ranks[0]['backend']}, 2 "
          f"launched ranks, CompiledProgram dp=2, global batch "
          f"{2 * PS_BATCH}, {PS_COLLECTIVE_STEPS} steps): losses "
          f"{single[0]:.6f} -> {single[-1]:.6f}, max |rank - one process| "
          f"{err:.3g} (gate {PS_TOL['collective']}); ranks ready after "
          f"{max(out['rank_ready_s']):.1f} s (rank 0: "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      out["rank_stages_s"][0].items())
          + f"), rank 0's steps "
          f"{[round(x, 1) for x in out['rank_step_ms'][0]]} ms, one "
          f"process's {[round(x, 1) for x in out['single_step_ms']]} ms; "
          f"{out['seconds']:.1f} s {tag}")
    for r in ranks:
        assert len(r["losses"]) == PS_COLLECTIVE_STEPS, r
        assert not r["jax_loaded"] and not any(r["launches"].values()), r
    assert err <= PS_TOL["collective"], (single, out["ranks"])
    return out, during_out


def ps_feed_desc(cfg, batch):
    """A DataFeedDesc of the phase's slots in the reference's proto text."""
    from paddle_tpu_torch.data_feed_desc import DataFeedDesc
    lines = ['name: "MultiSlotDataFeed"', f"batch_size: {batch}",
             "multi_slot_desc {"]
    for name, kind, dim in ps_slots(cfg):
        lines += ["  slots {", f'    name: "{name}"',
                  f'    type: "{"float" if kind == "dense" else "uint64"}"',
                  f"    is_dense: {'true' if kind == 'dense' else 'false'}",
                  "    is_used: true"]
        if kind == "dense":
            lines.append(f"    shape: {dim}")
        lines.append("  }")
    lines.append("}")
    return DataFeedDesc("\n".join(lines))


def ps_dataset_leg(torch, cfg, files, seed, tag, dev="cuda"):
    """(d) Dataset training: Executor.train_from_dataset over an
    InMemoryDataset of the phase's files and AsyncExecutor.run over them
    (a QueueDataset, one reader thread: file order), each from the same
    initial state, against Executor.run on the same batches in the same
    order: losses and every persistable bit-equal."""
    from paddle_tpu_torch.async_executor import AsyncExecutor
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.weights import scope_from_jax, scope_to_numpy
    t0 = time.perf_counter()
    main, startup, loss = _ps_ctr(cfg)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    exe, scope = Executor(dev), Scope()
    exe.run(startup, scope=scope)
    state = scope_to_numpy(scope, names)

    def fresh():
        return scope_from_jax(state, Scope(), exe.device, program=main)

    def by_run(feeds):
        s = fresh()
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=s)[0]
                  for f in feeds]
        return losses, scope_to_numpy(s, names)

    def diff(a, b):
        return max(float(np.abs(np.asarray(x, np.float64)
                                - np.asarray(y, np.float64)).max())
                   for x, y in zip(a, b))

    sub = files[:PS_DATASET_FILES]
    ds = ps_dataset(sub, cfg, PS_BATCH, seed=seed)
    s1 = fresh()
    t = time.perf_counter()
    got = [r[0] for r in exe.train_from_dataset(main, ds, fetch_list=[loss],
                                                scope=s1)]
    tfd_s = time.perf_counter() - t
    want, want_state = by_run(list(ds))
    got_state = scope_to_numpy(s1, names)
    tfd = (diff(got, want), diff([got_state[n] for n in names],
                                 [want_state[n] for n in names]))
    ae = AsyncExecutor(exe.device)
    s3 = fresh()
    with scope_guard(s3):
        t = time.perf_counter()
        got3 = [r[0] for r in ae.run(main, ps_feed_desc(cfg, PS_BATCH), sub,
                                     1, [loss])]
        ae_s = time.perf_counter() - t
    q = ps_dataset(sub, cfg, PS_BATCH, kind="QueueDataset", threads=1)
    want3, want3_state = by_run(list(q))
    got3_state = scope_to_numpy(s3, names)
    aex = (diff(got3, want3), diff([got3_state[n] for n in names],
                                   [want3_state[n] for n in names]))
    out = {"batches": len(got), "train_from_dataset": {
        "loss_diff": tfd[0], "state_diff": tfd[1], "seconds": tfd_s},
        "async_executor": {"batches": len(got3), "loss_diff": aex[0],
                           "state_diff": aex[1], "seconds": ae_s},
        "losses": [float(np.asarray(x).reshape(-1)[0]) for x in got],
        "seconds": time.perf_counter() - t0}
    print(f"phase 39(d) dataset training ({len(sub)} files, "
          f"{len(got)} batches of {PS_BATCH}): train_from_dataset vs "
          f"Executor.run loss diff {tfd[0]:.3g}, state diff {tfd[1]:.3g} "
          f"({tfd_s:.2f} s); AsyncExecutor.run vs Executor.run loss diff "
          f"{aex[0]:.3g}, state diff {aex[1]:.3g} ({len(got3)} batches, "
          f"{ae_s:.2f} s); losses {out['losses'][0]:.5f} -> "
          f"{out['losses'][-1]:.5f}; {out['seconds']:.1f} s {tag}")
    want_n = -(-len(sub) * (PS_RECORDS // len(files)) // PS_BATCH)
    assert len(got) == len(got3) == want_n, (len(got), len(got3), want_n)
    assert tfd == (0.0, 0.0) and aex == (0.0, 0.0), (tfd, aex)
    return out


def start_native_build():
    """Build the port's native library on a thread (g++ beside phase 1's
    nvcc); returns a join() that re-raises its failure and returns the
    build's seconds."""
    from paddle_tpu_torch import native
    join = start_build(native.load, "native-build")
    return lambda: join()[0]


def ps_phase(torch, seed, tag, dev="cuda", native_build=None):
    """Phase 39: the parameter server, the launcher and dataset training
    with DeepFM at BASELINE config 5 (legs (a)-(d); (c)'s ranks start
    while (b) runs); the kernel counts are reset before and read after,
    in this process and in every child, and must stay 0. `native_build`
    joins the native library's build started beside the kernels' (None:
    build it here). Returns (results, this process's launches)."""
    from paddle_tpu_torch import native
    t0 = time.perf_counter()
    # built once here; the children load it
    build_s = (native_build or start_native_build())()
    cfg = ps_config()
    tmp = tempfile.mkdtemp(prefix="pt_ps_data_")
    t = time.perf_counter()
    files = ps_write_files(tmp, seed, cfg)
    write_s = time.perf_counter() - t
    print(f"phase 39: native library built in {build_s:.1f} s, waited "
          f"{time.perf_counter() - t0:.1f} s for it "
          f"({native.library_path()}), {PS_RECORDS} MultiSlot records in "
          f"{PS_FILES} files written in {write_s:.1f} s; DeepFM "
          f"{cfg.num_slots} x {cfg.vocab_per_slot} ids, embed "
          f"{cfg.embed_dim}, {cfg.dense_dim} dense, MLP {cfg.mlp_dims} "
          f"{tag}")
    _ps_reset_counts()
    out = {"native_build_s": build_s, "write_s": write_s}
    out["sync"] = ps_sync_leg(torch, cfg, files, seed, tag, dev)
    out["collective"], out["fleet"] = ps_collective_leg(
        torch, cfg, seed, tag, dev,
        during=lambda: ps_fleet_leg(torch, cfg, files, seed, tag, dev))
    out["dataset"] = ps_dataset_leg(torch, cfg, files, seed, tag, dev)
    counts = _ps_launch_counts()
    assert not any(counts.values()), counts
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 39: {out['seconds']:.1f} s (no kernel of the kernels "
          f"line launched, here or in a child) {tag}")
    return out, counts


# ---------------------------------------------------------------------------
# phase 40: the slim pipeline: prune, distill, plan, quantize, serve armed
# ---------------------------------------------------------------------------

#: phase 40's network: ResNet-50 at its published width (He et al. 2015
#: Table 1), 224 x 224, 1000 classes; build_static's keyword arguments
SLIM_NET = dict(depth=50)
SLIM_IMAGE = 224
#: (a) the fraction of output channels pruned in every bottleneck's 3 x 3
#: conv; sensitivity over the first SLIM_SENS_PARAMS of them
SLIM_PRUNE_RATIO = 0.5
SLIM_SENS_PARAMS, SLIM_SENS_RATIOS = 2, (0.3, 0.5)
#: (b) distillation: steps at SLIM_BATCH (one batch from --seed, fed
#: SLIM_STEPS times through the DataLoader), the soft-label temperature
SLIM_STEPS, SLIM_BATCH, SLIM_TEMPERATURE = 8, 32, 4.0
#: (c) where the saved student lives (io.fs's in-process store), the
#: ledger scope of the planned Predictor's captures, the pricing gate
#: (the JAX package's tools/quant_check.py TOLERANCE) and the planted
#: veto's contraction depth (tests/test_slim_passes.py)
SLIM_DIR = "mem://slim/student"
SLIM_SCOPE = "slim-int8"
SLIM_PRICE_TOL = 0.25
SLIM_VETO_K = 200000
SLIM_VETO_TOL = 1e-5
#: (d) the gateway's buckets and its two windows' clients x requests
SLIM_BUCKETS = (1, 2, 4, 8)
SLIM_CLIENTS, SLIM_REQUESTS = 4, 8
#: (e) the search's steps; a candidate trains two steps at this batch
SLIM_NAS_STEPS, SLIM_NAS_BATCH = 6, 8


def slim_blocks():
    from paddle_tpu_torch.models.resnet import CFG
    return tuple(SLIM_NET.get("blocks") or CFG[SLIM_NET["depth"]])


def slim_programs(seed, image_size):
    """The student (ResNet-50 by build_static, its test clone made before
    anything is added) and the teacher: the same build under the same
    names, its test clone pruned to the logits. Returns (main, startup,
    test, teacher, logits, loss)."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.models.resnet import build_static
    from paddle_tpu_torch.static.io import prune

    def build():
        ir.reset_unique_names()
        main, startup = ir.Program(), ir.Program()
        startup.random_seed = seed
        with ir.program_guard(main, startup):
            img = static.data("img", [3, image_size, image_size], "float32")
            label = static.data("label", [1], "int64")
            logits, loss, _ = build_static(img, label, **SLIM_NET)
        return main, startup, logits, loss

    tmain, _, tlogits, _ = build()
    teacher = prune(tmain.clone(for_test=True), [tlogits.name])
    main, startup, logits, loss = build()
    return main, startup, main.clone(for_test=True), teacher, logits, loss


def precise_bn_stats(exe, main, scope, feed):
    """Set every batch norm's running mean and variance to its statistics
    on `feed` (one training forward of `main`, fetching each op's batch
    mean and inverse standard deviation): a random-weight network in
    inference mode then normalizes as training does, where the initial
    statistics (0, 1) let its activations grow through 50 layers."""
    bns = [op for op in main.global_block().ops if op.type == "batch_norm"]
    fetch = ([op.outputs["SavedMean"][0] for op in bns]
             + [op.outputs["SavedVariance"][0] for op in bns])
    outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    for op, m, inv in zip(bns, outs[:len(bns)], outs[len(bns):]):
        eps = op.attrs.get("epsilon", 1e-5)
        scope.set(op.inputs["Mean"][0], m.astype(np.float32))
        scope.set(op.inputs["Variance"][0],
                  (1.0 / np.square(inv.astype(np.float64)) - eps)
                  .astype(np.float32))


def slim_prune_distill(torch, seed, tag, dev="cuda", image_size=None):
    """Phase 40(a)-(b). (a) `sensitivity` over two of the bottlenecks'
    3 x 3 convs at SLIM_SENS_RATIOS, its metric the test clone's loss on
    one batch; then `slim.Pruner("channel")` zeroes SLIM_PRUNE_RATIO of
    the output channels of every bottleneck's 3 x 3 conv (masks; shapes
    kept); `sparsity` over those and over every student parameter. (b)
    `distill.merge` of the unpruned teacher (same seeded weights, test
    mode, every batch norm's statistics set from the training batch by
    `precise_bn_stats`) into the student; the loss is the student's
    cross entropy plus T^2 x KL(teacher || student) at T =
    SLIM_TEMPERATURE (`distill.soft_label_loss` from the static layers),
    minimized by phase 14's Momentum + L2Decay. One step at CHECK_BATCH
    card against CPU (`step_agreement`, phase 14's gates), then
    SLIM_STEPS steps at SLIM_BATCH fed by `io.DataLoader` over
    `xmap_readers(process_num=1)`, the masks re-applied after each. The
    teacher stays bit-equal, pruned channels stay 0, losses fall. The
    student is saved to SLIM_DIR through io.fs. Returns (summary,
    student logits name)."""
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch import optimizer, regularizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.slim import Pruner, distill, sensitivity, sparsity
    from paddle_tpu_torch.weights import scope_to_numpy
    image_size = image_size or SLIM_IMAGE
    t0 = time.perf_counter()
    main, startup, test, teacher, logits, loss = slim_programs(seed,
                                                               image_size)
    exe, scope = Executor(dev), Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed + 40)
    classes = SLIM_NET.get("num_classes", 1000)
    imgs = resnet_images(rng, SLIM_BATCH, image_size)
    labels = rng.randint(0, classes, (SLIM_BATCH, 1)).astype(np.int64)

    def samples():
        for _ in range(SLIM_STEPS):
            for i in range(SLIM_BATCH):
                yield imgs[i], labels[i]

    def mapper(s):          # per-image standardization, on the worker
        x = s[0]
        return ((x - x.mean()) / (x.std() + 1e-6)).astype(np.float32), s[1]

    serial = list(tio.batch(tio.map_readers(mapper, samples),
                            SLIM_BATCH)())
    first = {"img": np.stack([s[0] for s in serial[0]]),
             "label": np.stack([s[1] for s in serial[0]])}
    precise_bn_stats(exe, main, scope, first)
    fixed = {"img": np.stack([mapper((x, 0))[0] for x in resnet_images(
                 rng, CHECK_BATCH * 2, image_size)]),
             "label": rng.randint(0, classes, (CHECK_BATCH * 2, 1))
             .astype(np.int64)}
    # the teacher's weights (and statistics) are the student's before
    # pruning
    distill.merge(teacher, main, {"img": "img"}, scope=scope)
    blk = main.global_block()
    t_logits = blk.var("teacher_" + logits.name)
    opt_startup = ir.Program()
    with ir.program_guard(main, opt_startup):
        # slim.distill.soft_label_loss from the static layers: KL(teacher
        # || student) at temperature T, times T^2
        T = SLIM_TEMPERATURE
        log_t = static.log_softmax(static.scale(t_logits, 1.0 / T))
        log_s = static.log_softmax(static.scale(logits, 1.0 / T))
        kl = static.mean(static.reduce_sum(static.elementwise_mul(
            static.exp(log_t), static.elementwise_sub(log_t, log_s)),
            dim=-1))
        total = static.elementwise_add(loss, static.scale(kl, T * T))
        optimizer.Momentum(
            learning_rate=TRAIN_LR, momentum=TRAIN_MOMENTUM,
            regularization=regularizer.L2Decay(TRAIN_L2)).minimize(total)
    exe.run(opt_startup, scope=scope)
    teacher_names = sorted(n for n, d in blk.vars.items()
                           if n.startswith("teacher_") and d.persistable)
    student = sorted(v.name for v in main.all_parameters()
                     if not v.name.startswith("teacher_"))
    assert teacher_names and all(not blk.var(n).desc.trainable
                                 for n in teacher_names)

    # (a) sensitivity of the unpruned network, then prune and sparsity
    convs3 = [n for n in student if len(blk.var(n).shape) == 4
              and tuple(blk.var(n).shape[2:]) == (3, 3)]
    assert len(convs3) == sum(slim_blocks()), convs3

    def eval_loss():
        return float(exe.run(test, feed=fixed, fetch_list=[loss.name],
                             scope=scope)[0])

    base = eval_loss()
    sens = sensitivity(test, exe, scope, convs3[:SLIM_SENS_PARAMS],
                       eval_loss, SLIM_SENS_RATIOS)
    assert eval_loss() == base          # sensitivity restored the weights
    pruner = Pruner("channel")
    masks = pruner.prune(scope, {n: SLIM_PRUNE_RATIO for n in convs3})
    sp3, sp_all = sparsity(scope, convs3), sparsity(scope, student)
    print(f"phase 40(a) Pruner('channel') at {SLIM_PRUNE_RATIO} over the "
          f"{len(convs3)} bottleneck 3x3 convs: sparsity {sp3:.4f} there, "
          f"{sp_all:.4f} over all {len(student)} student parameters; "
          f"sensitivity before pruning (l1_norm; the test clone's loss on "
          f"a batch of {len(fixed['img'])}, {base:.6g} unpruned) "
          f"{json.dumps(sens)} {tag}")
    assert abs(sp3 - SLIM_PRUNE_RATIO) < 0.01, sp3
    assert all(np.isfinite(v) for d in sens.values() for v in d.values())

    # (b) one step card against CPU from the pruned start (phase 14's
    # method and gates), then training
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    start = scope_to_numpy(scope, names)
    small = {k: v[:CHECK_BATCH] for k, v in fixed.items()}
    agreement = step_agreement(torch, main, start, small, total.name, tag,
                               devs=(dev, "cpu"))
    loader = tio.DataLoader.from_generator(
        feed_list=[blk.var("img"), blk.var("label")], capacity=2)
    loader.set_sample_generator(tio.xmap_readers(mapper, samples, 1, 64),
                                SLIM_BATCH)
    t_before = {n: scope.find_np(n) for n in teacher_names}
    losses, feeds_equal = [], True
    t_train = time.perf_counter()
    for i, feed in enumerate(loader):
        want = serial[i]
        feeds_equal &= (np.array_equal(feed["img"], np.stack(
            [s[0] for s in want])) and np.array_equal(
            feed["label"], np.stack([s[1] for s in want])))
        losses.append(float(exe.run(main, feed=feed, fetch_list=[total],
                                    scope=scope)[0]))
        pruner.apply_masks(scope, masks)
    if dev == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    assert len(losses) == SLIM_STEPS and feeds_equal, (len(losses),
                                                      feeds_equal)
    teacher_same = all(np.array_equal(scope.find_np(n), a)
                       for n, a in t_before.items())
    zero = all(not np.any(scope.find_np(n)[~masks[n]]) for n in convs3)
    sp_after = sparsity(scope, convs3)
    print(f"phase 40(b) distillation (teacher: the unpruned ResNet-50, "
          f"{len(teacher_names)} frozen persistables): {SLIM_STEPS} steps "
          f"at batch {SLIM_BATCH} through DataLoader(xmap_readers(1 "
          f"thread)), feed dicts equal the serial reader's: {feeds_equal}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in {train_s:.1f} s; "
          f"teacher bit-equal {teacher_same}, pruned channels all 0 "
          f"{zero}, sparsity {sp_after:.4f} {tag}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert teacher_same and zero and sp_after == sp3

    with scope_guard(scope):
        static.io.save_inference_model(SLIM_DIR, ["img"], [logits], exe,
                                       main_program=main)
    out = {"pruned_params": len(convs3), "sparsity_pruned": sp3,
           "sparsity_all": sp_all, "sensitivity": sens,
           "sensitivity_base": base,
           "agreement": agreement, "losses": losses, "train_s": train_s,
           "teacher_bit_equal": teacher_same, "feeds_equal": feeds_equal,
           "seconds": time.perf_counter() - t0}
    return out, logits.name


def slim_frozen_bytes(pred):
    """The int8 codes and float32 scales the frozen program's quantized
    ops read, as the Predictor holds them: (bytes, devices)."""
    slots = {"quantized_conv2d": ("Filter", "FilterScale"),
             "quantized_mul": ("Y", "YScale")}
    seen, total, devices = set(), 0, set()
    for op in pred._program.global_block().ops:
        for slot in slots.get(op.type, ()):
            name = op.inputs[slot][0]
            if name in seen:
                continue
            seen.add(name)
            t = pred._scope.get(name)
            total += t.numel() * t.element_size()
            devices.add(t.device.type)
    return total, devices


def slim_quantize(torch, k8, seed, tag, dev="cuda", image_size=None):
    """Phase 40(c). The student loaded from SLIM_DIR twice: an f32
    Predictor, and one that PTQ calibrates (4 batches of 8, hist), that
    `analysis.plan_quantization` plans (params from its scope as numpy,
    the card's free memory as the budget) and that
    `quantize_program(plan=...)` freezes. 4 requests each at batch 1, 8
    and 32; K8 launches on every one; the served fc equals K8's plain
    version + bias within 1 ulp; int8 vs f32 under INT8_FIDELITY_GATE;
    the plan's int8 bytes equal what the frozen Predictor holds; its
    capture price against each batch size's measured capture peak
    (`QuantPlan.register_estimate`, `planner.cross_check`, within
    SLIM_PRICE_TOL on the card). Returns (summary, int8 Predictor, f32
    Predictor, K8 launches over the requests)."""
    from collections import Counter
    from paddle_tpu_torch import inference, slim
    from paddle_tpu_torch.analysis import planner, plan_quantization
    from paddle_tpu_torch.observability import profile as prof
    image_size = image_size or SLIM_IMAGE
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 41)
    f32 = inference.create_predictor(inference.Config(SLIM_DIR, device=dev))
    pred = inference.create_predictor(inference.Config(SLIM_DIR,
                                                       device=dev))
    loader = [{"img": resnet_images(rng, 8, image_size)} for _ in range(4)]
    ptq = slim.PostTrainingQuantization(pred._exe, pred._program, ["img"],
                                        loader, scope=pred._scope,
                                        batch_nums=4)
    scales = ptq.calibrate()
    params = {v.name: pred._scope.find_np(v.name)
              for v in pred._program.list_vars()
              if v.persistable and pred._scope.has(v.name)}
    budget = torch.cuda.mem_get_info()[0] if dev == "cuda" else None
    t_plan = time.perf_counter()
    plan = plan_quantization(pred._program, params=params,
                             batch_size=max(RESNET_BATCHES),
                             hbm_budget_bytes=budget)
    plan_s = time.perf_counter() - t_plan
    del params
    rungs = dict(Counter(v.rung for v in plan.report.ladder))
    hazards = dict(Counter(d.code for d in plan.diagnostics()))
    print(f"phase 40(c) plan_quantization (batch {max(RESNET_BATCHES)}, "
          f"budget {budget} B free on the card) in {plan_s:.2f} s: ladder "
          f"{rungs}, hazards {hazards}, vetoed ops {plan.vetoed_ops()}, "
          f"weights saved {plan.weights_saved_bytes} B of "
          f"{sum(w['bytes_f32'] for w in plan.weights)} B {tag}")
    assert plan.vetoed_ops() == [] and "int8-range-overflow" not in hazards
    assert plan.fit_diagnostic() is None
    ptq.freeze(scales, plan=plan)
    pred._program._version += 1
    types = [op.type for op in pred._program.global_block().ops]
    blocks = slim_blocks()
    want_convs = 1 + 3 * sum(blocks) + len(blocks)
    assert types.count("quantized_conv2d") == want_convs and \
        types.count("quantized_mul") == 1, Counter(types)
    assert not any(t.startswith("fake_") for t in types)
    assert "conv2d" not in types and "fc" not in types and "mul" not in types

    # each batch size's first runs (warm-up, capture) under the ledger
    # scope the plan's estimates register against
    requests = [resnet_images(rng, b, image_size) for b in RESNET_BATCHES
                for _ in range(RESNET_REQUESTS_PER_BATCH)]
    planner.clear_static_estimates(scope=SLIM_SCOPE)
    for b, x in zip(RESNET_BATCHES, requests[::RESNET_REQUESTS_PER_BATCH]):
        with prof.attribution("predictor", key=f"batch{b}",
                              scope=SLIM_SCOPE):
            for _ in range(2):
                pred.run({"img": x})
        plan.register_estimate(SLIM_SCOPE, f"batch{b}", batch_size=b)
        f32.run({"img": x})
    # what the frozen Predictor holds on the card once it has run
    held, devices = slim_frozen_bytes(pred)
    planned = sum(w["bytes_int8"] for w in plan.weights if not w["vetoed"])
    assert devices == {dev} and held == planned, (held, planned, devices)
    legs = [g for g in planner.cross_check(SLIM_PRICE_TOL)["legs"]
            if g["scope"] == SLIM_SCOPE]
    pricing = {g["key"]: {"estimate": g["estimate_bytes"],
                          "measured": g["measured_bytes"],
                          "ratio": g["ratio"], "status": g["status"],
                          "step_peak": g["detail"]["step_peak_bytes"],
                          "working": plan.working_bytes(
                              g["detail"]["batch_size"])}
               for g in legs}
    print(f"phase 40(c) pricing: the plan's quant_capture_peak_bytes (the "
          f"shadow's every intermediate + the quantized ops' working set) "
          f"vs the measured capture peak (tolerance {SLIM_PRICE_TOL}; its "
          f"quant_step_peak_bytes beside): {json.dumps(pricing)} {tag}")
    if dev == "cuda":
        assert all(p["status"] == "ok" for p in pricing.values()), pricing
    k8.reset_launch_counts()
    int8_out, int8_s = serve_requests(pred, requests)
    launches = dict(k8.launch_counts)
    assert launches["quantized_matmul"] == len(requests), launches
    f32_out, _ = serve_requests(f32, requests)
    num = sum(float(np.abs(a - b).sum()) for a, b in zip(int8_out, f32_out))
    fidelity = num / sum(float(np.abs(b).sum()) for b in f32_out)
    for o in int8_out:
        assert np.isfinite(o).all()
    fc = served_fc_ulps(torch, k8, pred, requests[-1])
    p50 = {b: 1e3 * float(np.median(int8_s[i * RESNET_REQUESTS_PER_BATCH:
                                           (i + 1) *
                                           RESNET_REQUESTS_PER_BATCH]))
           for i, b in enumerate(RESNET_BATCHES)}
    print(f"phase 40(c) the planned int8 Predictor: {want_convs} "
          f"quantized_conv2d + 1 quantized_mul, int8 codes + scales held "
          f"{held} B = planned {planned} B; K8 {launches['quantized_matmul']}"
          f" launches over {len(requests)} requests; served fc vs plain K8 "
          f"+ bias {fc} ulp; int8 vs the f32 student mean |dlogits| / mean "
          f"|logits| {fidelity:.5f} (gate {INT8_FIDELITY_GATE}); p50 ms by "
          f"batch {json.dumps(p50)} {tag}")
    assert fc <= 1 and fidelity < INT8_FIDELITY_GATE, (fc, fidelity)
    out = {"rungs": rungs, "hazards": hazards,
           "vetoed_ops": plan.vetoed_ops(),
           "weights_saved_bytes": plan.weights_saved_bytes,
           "int8_bytes_held": held, "int8_bytes_planned": planned,
           "plan_s": plan_s, "pricing": pricing,
           "int8_working_bytes": plan.int8_working_bytes,
           "k8_launches": launches["quantized_matmul"],
           "requests": len(requests), "fc_ulps": fc, "fidelity": fidelity,
           "p50_ms": p50, "seconds": time.perf_counter() - t0}
    return out, pred, f32, launches


def slim_planted_veto(torch, seed, tag, dev="cuda"):
    """Phase 40(c)'s planted veto: the K = SLIM_VETO_K `mul` of
    tests/test_slim_passes.py with x and w positive and every element at
    its calibrated abs max. Planned, the op is vetoed (`skip_quant`) and
    stays float32: it must equal float64 on the CPU within SLIM_VETO_TOL
    of the result. Quantized without the plan, K * 127^2 products
    overflow int32: its error is printed, not gated. Returns the
    readings."""
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.analysis import plan_quantization
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    k, n, m = SLIM_VETO_K, 4, 2
    xv, wv = 0.5, 0.25
    x = np.full((m, k), xv, np.float32)
    want = float(np.float64(xv) * np.float64(wv) * k)

    def program():
        p = ir.Program()
        b = p.global_block()
        b.create_var(name="x", shape=[-1, k], dtype="float32", is_data=True)
        w = b.create_var(name="w", shape=[k, n], dtype="float32",
                         persistable=True)
        w.desc.is_parameter = True
        b.create_var(name="out", shape=[-1, n], dtype="float32")
        b.append_op("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["out"]})
        return p

    exe, res = Executor(dev), {}
    for planned in (True, False):
        prog, scope = program(), Scope()
        scope.set("w", np.full((k, n), wv, np.float32))
        ptq = slim.PostTrainingQuantization(exe, prog, ["x"], [{"x": x}],
                                            scope=scope, batch_nums=1,
                                            algo="abs_max")
        scales = ptq.calibrate()
        plan = None
        if planned:
            plan = plan_quantization(prog, params={"w": scope.find_np("w")},
                                     batch_size=m)
            assert plan.vetoed_ops() == [0], plan.vetoed_ops()
        ptq.freeze(scales, plan=plan)
        types = [op.type for op in prog.global_block().ops]
        (got,) = exe.run(prog, feed={"x": x}, fetch_list=["out"],
                         scope=scope)
        rel = float(np.abs(got.astype(np.float64) - want).max() / want)
        res["planned" if planned else "unplanned"] = {
            "ops": types, "rel_err": rel, "out": float(got.flat[0])}
    p, u = res["planned"], res["unplanned"]
    print(f"phase 40(c) planted veto, mul K={k} (K x 127^2 = "
          f"{k * 127 ** 2} > 2^31 - 1): planned -> {p['ops']}, f32 result "
          f"{p['out']:.6g} vs float64 {want:.6g}, rel {p['rel_err']:.3g} "
          f"(gate {SLIM_VETO_TOL}); unplanned -> {u['ops']}, result "
          f"{u['out']:.6g}, rel {u['rel_err']:.3g} (recorded, not gated) "
          f"{tag}")
    assert p["ops"] == ["mul"] and p["rel_err"] <= SLIM_VETO_TOL, p
    assert u["ops"] == ["quantized_mul"], u
    return res


def slim_serving(torch, k8, int8, f32, seed, tag, dev="cuda",
                 image_size=None):
    """Phase 40(d). The lock checker armed (PT_FLAGS_concurrency_check,
    `set_enabled(True)`) before the registry, the replica pool and the
    gateway are built: the planned int8 Predictor deployed as slim:v1,
    SLIM_CLIENTS PTGW clients x SLIM_REQUESTS one-row requests (no
    capture), then the same again with a hot swap to the f32 student
    (slim:v2) under traffic (only v2's prewarm captures). Every row
    equals the serial Predictor.run of the version that computed it
    (phase 33's tolerances); the checker finds no lock-order cycle and
    no guarded-by violation; GET /profile carries its section. Control:
    two tracked locks taken A -> B on one thread and B -> A on another,
    one after the other: exactly one lock-order-cycle naming both
    stacks. Returns (summary, K8 launches over the two windows)."""
    import threading
    from paddle_tpu_torch.analysis import concurrency as cc
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.observability import profile as prof
    from paddle_tpu_torch.serving import (GatewayClient, ModelRegistry,
                                          ServingGateway, wire)
    image_size = image_size or SLIM_IMAGE
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 42)
    images = resnet_images(rng, SLIM_CLIENTS * SLIM_REQUESTS, image_size)
    ex = {"img": images[:1]}
    ledger = prof.compile_ledger()
    out, gw = {}, None
    flags.set_flag("concurrency_check", True)
    cc.set_enabled(True)
    cc.clear_findings()
    try:
        registry = ModelRegistry(num_replicas=2, buckets=list(SLIM_BUCKETS),
                                 max_wait_ms=2.0, max_queue=1024,
                                 drain_timeout_s=120.0)
        gw = ServingGateway(registry=registry, read_timeout_s=600.0,
                            write_timeout_s=60.0, max_in_flight=4096,
                            device=dev)
        registry.deploy("slim", "v1", int8, prewarm_feed=ex, tier="int8")
        v1 = registry.resolve("slim").server
        assert isinstance(registry._mu, cc.TrackedLock)
        host, port = gw.start()
        refs = {"v1": int8.clone(), "v2": f32.clone()}
        serial = {v: {} for v in refs}
        k8.reset_launch_counts()
        n0 = len(ledger.compile_events())
        got, errors = _traffic(GatewayClient, host, port, images,
                               SLIM_CLIENTS, SLIM_REQUESTS, model="slim")
        assert not errors, errors[:3]
        plain_caps = len(ledger.compile_events()) - n0
        assert plain_caps == 0, f"{plain_caps} captures during traffic"
        swap = {}

        def do_swap():
            time.sleep(0.05)
            try:
                swap.update(registry.deploy("slim", "v2", f32,
                                            prewarm_feed=ex, tier="fp32"))
            except Exception as e:
                swap["error"] = f"{type(e).__name__}: {e}"

        swapper = threading.Thread(target=do_swap)
        swapped = []

        def after_swap():
            if swapper.is_alive():
                return False
            swapped.append(time.perf_counter())
            return swapped[-1] - swapped[0] > 0.2

        n1 = len(ledger.compile_events())
        more, errors = _traffic(GatewayClient, host, port, images,
                                SLIM_CLIENTS, SLIM_REQUESTS,
                                on_start=swapper.start, until=after_swap,
                                pace_s=SERVE_SWAP_PACE_S, model="slim")
        swapper.join(600)
        assert swap.get("ok") and swap["replaced"] == "v1", swap
        assert not errors, errors[:3]
        v2 = registry.resolve("slim").server
        caps = ledger.compile_events()[n1:]
        assert caps and all(e.scope == v2.ledger_scope for e in caps), \
            [(e.scope, e.key) for e in caps]
        launches = dict(k8.launch_counts)
        got += more
        assert len(got) >= 2 * SLIM_CLIENTS * SLIM_REQUESTS
        by_version, worst = {}, {"v1": 0.0, "v2": 0.0}
        tol = {"v1": SERVE_INT8_ROW_TOL, "v2": LOGITS_TOL}
        for r, o, _, *rest in got:
            errs = {}
            for v, ref in refs.items():
                if r not in serial[v]:
                    serial[v][r] = ref.run(
                        feed={"img": images[r:r + 1]})[0]
                errs[v] = _row_err(o, serial[v][r])
            computed = min(errs, key=lambda v: errs[v] / tol[v])
            assert errs[computed] <= tol[computed], (r, errs)
            by_version[computed] = by_version.get(computed, 0) + 1
            worst[computed] = max(worst[computed], errs[computed])
        assert by_version.get("v1") and by_version.get("v2"), by_version
        assert launches["quantized_matmul"] > 0, launches
        st, profile_doc, _ = wire.http_request(host, port, "GET", "/profile")
        section = profile_doc.get("concurrency")
        assert st == 200 and section and section["locks"], st
        found = cc.findings()
        bad = [d for d in found if d.code in ("lock-order-cycle",
                                              "guarded-by-violation")]
        assert not bad, [d.message for d in bad]
        top = sorted(section["locks"].items(),
                     key=lambda kv: -kv[1]["wait_total_s"])[:3]
        out.update(requests=len(got), by_version=by_version,
                   max_row_err=worst, captures_plain=plain_caps,
                   captures_swap=len(caps), findings=len(found),
                   tracked_locks=len(section["locks"]),
                   top_waits={n: {"wait_total_s": d["wait_total_s"],
                                  "contended": d["contended"],
                                  "acquisitions": d["acquisitions"]}
                              for n, d in top},
                   prewarm_s=swap["prewarm_s"])
        # the control: A -> B on one thread, then B -> A on another
        cc.clear_findings()
        a, b = (cc.make_lock("slim.control.A"),
                cc.make_lock("slim.control.B"))

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for fn in (ab, ba):
            th = threading.Thread(target=fn)
            th.start()
            th.join(10)
        recs = cc.finding_records()
    finally:
        if gw is not None:
            gw.shutdown(timeout_s=120.0)
        flags.set_flag("concurrency_check", False)
        cc.clear_findings()
    assert [r["diagnostic"]["code"] for r in recs] == ["lock-order-cycle"], \
        recs
    assert set(recs[0]["stacks"]) == {"slim.control.A -> slim.control.B",
                                      "slim.control.B -> slim.control.A"}
    out["control"] = {"findings": len(recs),
                      "stacks": sorted(recs[0]["stacks"])}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 40(d) armed lock checker, slim:v1 (planned int8) then a "
          f"hot swap to slim:v2 (f32 student) under {SLIM_CLIENTS} clients: "
          f"{out['requests']} requests computed by {out['by_version']}, "
          f"rows vs serial {out['max_row_err']} (gates int8 "
          f"{SERVE_INT8_ROW_TOL}, f32 {LOGITS_TOL}); captures during plain "
          f"traffic {plain_caps}, in the swap window {len(caps)} (v2's "
          f"prewarm); {out['tracked_locks']} tracked locks, findings "
          f"{out['findings']} (no cycle, no guarded-by violation); largest "
          f"waits {json.dumps(out['top_waits'])}; K8 launches {launches}; "
          f"control A->B / B->A: {len(recs)} lock-order-cycle naming both "
          f"stacks {tag}")
    return out, launches


def slim_nas(torch, seed, tag, dev="cuda", image_size=None):
    """Phase 40(e). `slim.NASSearcher` with `SAController(seed)` over the
    network's four stage block counts (each from 1 to its count), for
    SLIM_NAS_STEPS steps. `max_flops` is `flops_of` of the full network
    at batch 1 (printed beside `flops_per_image`); a candidate's reward
    is its loss drop over two momentum-SGD steps at SLIM_NAS_BATCH on the
    card (eager). No evaluated candidate exceeds `max_flops`."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.resnet import ResNet, flops_per_image
    from paddle_tpu_torch.observability import profile as prof
    from paddle_tpu_torch.slim import (NASSearcher, SAController,
                                       SearchSpace, flops_of)
    image_size = image_size or SLIM_IMAGE
    t0 = time.perf_counter()
    full = slim_blocks()
    classes = SLIM_NET.get("num_classes", 1000)
    kw = {k: v for k, v in SLIM_NET.items() if k in ("width", "num_classes")}
    rng = np.random.RandomState(seed + 43)
    x1 = torch.from_numpy(resnet_images(rng, 1, image_size)).to(dev)
    xb = torch.from_numpy(resnet_images(rng, SLIM_NAS_BATCH,
                                        image_size)).to(dev)
    yb = torch.from_numpy(rng.randint(0, classes, SLIM_NAS_BATCH)).to(dev)
    flops_cache, evaluated = {}, []

    def net(tokens):
        nn.seed(seed)
        return ResNet(blocks=tuple(t + 1 for t in tokens), device=dev, **kw)

    def flops_fn(tokens):
        key = tuple(tokens)
        if key not in flops_cache:
            m = net(tokens).eval()
            flops_cache[key] = flops_of(m, x1)
            del m
        return flops_cache[key]

    def loss_fn(model, x, y):
        return torch.nn.functional.cross_entropy(model(x), y)

    def eval_fn(tokens):
        m = net(tokens)
        with prof.disable_capture():
            first, second, _ = zoo_step(torch, m, loss_fn, (xb, yb))
        evaluated.append((list(tokens), first - second))
        del m
        return first - second

    class Space(SearchSpace):
        def init_tokens(self):
            return [n - 1 for n in full]

        def range_table(self):
            return list(full)

    max_flops = flops_fn([n - 1 for n in full])
    searcher = NASSearcher(Space(), SAController(seed=seed),
                           max_flops=max_flops, flops_fn=flops_fn,
                           search_steps=SLIM_NAS_STEPS)
    best, reward, history = searcher.search(eval_fn)
    over = [t for t, _ in evaluated if flops_fn(t) > max_flops]
    out = {"max_flops": max_flops,
           "flops_per_image": flops_per_image(SLIM_NET["depth"],
                                              image_size),
           "history": [(t, r, flops_cache[tuple(t)]) for t, r in history],
           "best": best, "best_reward": reward,
           "seconds": time.perf_counter() - t0}
    print(f"phase 40(e) NAS, SAController(seed={seed}) over stage blocks "
          f"1..{list(full)}, {len(history)} candidates: max_flops "
          f"{max_flops:.4g} (flops_of, batch 1 x {image_size}^2; "
          f"flops_per_image {out['flops_per_image']:.4g}); history "
          f"{[(t, round(r, 4)) for t, r in history]}; best {best} "
          f"(loss drop {reward:.4f}); candidates over max_flops: {len(over)} "
          f"{tag}")
    assert len(history) == SLIM_NAS_STEPS and not over, (history, over)
    return out


def slim_phase(torch, k8, seed, tag, dev="cuda"):
    """Phase 40 (see the module docstring). Returns (results, K8 launches
    over the main path: the planned Predictor's requests and the
    gateway's two windows)."""
    t0 = time.perf_counter()
    out = {}
    out["prune_distill"], _ = slim_prune_distill(torch, seed, tag, dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["quantize"], int8, f32, served = slim_quantize(torch, k8, seed, tag,
                                                       dev)
    out["planted_veto"] = slim_planted_veto(torch, seed, tag, dev)
    out["serving"], gw_launches = slim_serving(torch, k8, int8, f32, seed,
                                               tag, dev)
    del int8, f32
    from paddle_tpu_torch.io import fs
    fs.get_fs(SLIM_DIR)[0].delete(SLIM_DIR)
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["nas"] = slim_nas(torch, seed, tag, dev)
    launches = {"quantized_matmul": served["quantized_matmul"]
                + gw_launches["quantized_matmul"]}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 40: {out['seconds']:.1f} s; K8 launches on the slim path "
          f"{launches} {tag}")
    return out, launches


# ---------------------------------------------------------------------------
# phase 41: the deployment artifacts (export, the AOT bundle, pt_aoti_run),
# checkpoints on captured state, and the flash wrappers' widened shapes
# ---------------------------------------------------------------------------

#: 41(a): ResNet-50 (phase 12's configuration) frozen to int8, exported at
#: one rung of this batch and served from the artifact by each tier
DEPLOY_NET = dict(depth=50)
DEPLOY_IMAGE, DEPLOY_BATCH, DEPLOY_REQUESTS = 224, 8, 6
#: 41(b): the f32 ResNet-50 training program's batch
CKPT_BATCH = 8
#: 41(d): relative tolerance of a float16 output (one float16 rounding of
#: the float32 kernels' result, 2^-10, with room for the plain version's
#: float16 probabilities)
FLASH_F16_TOL = 2e-3


def start_build(build, name):
    """`build()` on a thread beside phase 1's nvcc; returns a join() that
    re-raises its failure and returns (seconds, its result)."""
    import threading
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["result"] = build()
        except BaseException as e:     # re-raised by join()
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=run, daemon=True, name=name)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["seconds"], box.get("result")
    return join


def start_aoti_build():
    """pt_aoti_run (g++ against the torch headers, ~30 s) on a thread."""
    from paddle_tpu_torch import native
    return start_build(native.build_pt_aoti_run, "aoti-build")


def _timed_runs(torch, run, requests):
    """(outputs, seconds a request) of `run` over `requests`, each
    synchronised."""
    outs, secs = [], []
    for x in requests:
        t0 = time.perf_counter()
        out = run(x)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    return outs, secs


def deploy_artifacts(torch, seed, work, dev="cuda", image_size=None,
                     net=None, batch=None, native=None):
    """Phase 41(a)'s artifacts, built in `work`: ResNet-50 at phase 12's
    width (224 x 224, 1000 classes), initialized from `seed`, saved,
    frozen to int8 by a Predictor's PTQ at load (2 batches of 8), the
    frozen program saved (`int8/`) and loaded back, then
    `export_aot_bundle` at feed (batch, 3, 224, 224) with buckets=None
    (one rung, the JAX package's default) into `bundle/`. Returns the
    timings and the op counts."""
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models.resnet import build_static

    image_size = image_size or DEPLOY_IMAGE
    batch = batch or DEPLOY_BATCH
    net = net or DEPLOY_NET
    rng = np.random.RandomState(seed + 41)
    t0 = time.perf_counter()
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = seed
    with ir.program_guard(main, startup):
        img = static.data("img", [3, image_size, image_size], "float32")
        label = static.data("label", [1], "int64")
        logits, _, _ = build_static(img, label, **net)
    f32_dir, int8_dir = (os.path.join(work, n) for n in ("f32", "int8"))
    exe = Executor(dev)
    with scope_guard(Scope()):
        exe.run(startup)
        static.io.save_inference_model(f32_dir, ["img"], [logits], exe,
                                       main_program=main)
    cfg = inference.Config(f32_dir)
    if dev == "cpu":
        cfg.disable_gpu()
    cfg.enable_int8([{"img": resnet_images(rng, 8, image_size)}
                     for _ in range(2)])
    ptq = inference.create_predictor(cfg)
    fetch = ptq.get_output_names()[0]
    ptq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with scope_guard(ptq._scope):
        static.io.save_inference_model(
            int8_dir, ["img"], [ptq._program.global_block().var(fetch)],
            ptq._exe, main_program=ptq._program)
    scope = Scope()
    with scope_guard(scope):
        prog, _, _ = static.io.load_inference_model(int8_dir, Executor(dev))
    save_load_s = time.perf_counter() - t0
    types = [op.type for op in prog.global_block().ops]
    ops = {"quantized_conv2d": types.count("quantized_conv2d"),
           "quantized_mul": types.count("quantized_mul")}
    if net == DEPLOY_NET:
        assert ops == {"quantized_conv2d": 53, "quantized_mul": 1}, ops
    t0 = time.perf_counter()
    inference.export_aot_bundle(prog, {"img": ((batch, 3, image_size,
                                                image_size), "float32")},
                                os.path.join(work, "bundle"), scope=scope,
                                device=dev, native=native)
    with open(os.path.join(work, "bundle", "BUNDLE.json")) as f:
        rung = json.load(f)["buckets"][0]
    return {"config": f"ResNet-50 (phase 12) {net}, {image_size} x "
                      f"{image_size}, int8 (PTQ at load), one rung at batch "
                      f"{batch}",
            "quantized_ops": ops, "init_and_ptq_s": ptq_s,
            "int8_save_load_s": save_load_s,
            "bundle_s": time.perf_counter() - t0,
            "export_s": rung["export_seconds"],
            "aoti_compile_s": rung.get("aoti_seconds"),
            "aoti_cxx": (inference.export.aoti_compiler()
                         if "native" in rung["tiers"] else None),
            "tiers": rung["tiers"], "batch": batch,
            "image_size": image_size, "work": work}


def deploy_export_main(spec):
    """`chip_smoke.py --deploy-export JSON`: phase 41(a)'s artifacts in a
    child process (so AOTInductor's compile can run beside earlier
    phases); prints DEPLOY-EXPORT with `deploy_artifacts`' summary."""
    import torch
    if spec["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = deploy_artifacts(torch, spec["seed"], spec["work"],
                           dev=spec["device"], **spec.get("kw", {}))
    out["child_s"] = time.perf_counter() - t0
    print("DEPLOY-EXPORT " + json.dumps(out), flush=True)
    return 0


def start_deploy_export(seed, dev="cuda", **kw):
    """Phase 41(a)'s artifacts built by a child process from now on;
    returns a join() that waits for it, fails on its failure, and
    returns its summary (with the seconds it ran beside the caller)."""
    work = tempfile.mkdtemp(prefix="deploy_")
    log = open(os.path.join(work, "export.log"), "w")
    t0 = time.perf_counter()
    # niced: its compile workers yield the host's cores to the phases it
    # runs beside
    proc = subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--deploy-export",
         json.dumps({"seed": seed, "work": work, "device": dev, "kw": kw})],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
        stderr=subprocess.STDOUT, text=True, preexec_fn=lambda: os.nice(10))
    # a failure before the join must not leave the child running
    atexit.register(lambda: proc.poll() is None and proc.kill())

    def join():
        t1 = time.perf_counter()
        rc = proc.wait()
        log.close()
        with open(os.path.join(work, "export.log")) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("DEPLOY-EXPORT ")]
        assert rc == 0 and lines, f"41(a) export child rc {rc}:\n{text[-4000:]}"
        out = json.loads(lines[-1][len("DEPLOY-EXPORT "):])
        out["waited_s"] = time.perf_counter() - t1
        out["started_before_s"] = t1 - t0
        out["beside_phases"] = list(join.beside)
        return out

    def beside(phases, tag):
        """Phases `phases` start now: noted (and said) if the child is
        still running, so their timings are read as taken beside it."""
        if proc.poll() is None:
            join.beside.append(phases)
            print(f"phase {phases} starts beside phase 41(a)'s export child "
                  f"({time.perf_counter() - t0:.1f} s into it) {tag}")
    join.beside = []
    join.note = beside
    return join


def deploy_export(torch, k8, tag, export_join, dev="cuda"):
    """Phase 41(a), served. The artifacts of `deploy_artifacts` (built by
    the child that `export_join` waits for): the bundle loads with its
    native tier (the stamp matches) and the rung's `exported` tier loads
    on its own; DEPLOY_REQUESTS requests through each and through the
    reloaded int8 Predictor, K8's counts reset just before each one's
    requests: the exported tier bit-equal to the Predictor's rows, the
    native tier within SERVE_INT8_ROW_TOL of max, K8 once a request on
    each tier. Returns (summary, launches, (rung dir, an input, its
    native rows, the work dir))."""
    import shutil
    from paddle_tpu_torch import inference

    summary = export_join()
    work, batch = summary["work"], summary["batch"]
    image_size = summary["image_size"]
    bdir = os.path.join(work, "bundle")
    with open(os.path.join(bdir, "BUNDLE.json")) as f:
        rung = json.load(f)["buckets"][0]
    rung_dir = os.path.join(bdir, rung["dir"])
    t0 = time.perf_counter()
    bundle = inference.load_aot_bundle(bdir, device=dev)
    load_s = time.perf_counter() - t0
    has_native = "native" in rung["tiers"]
    assert bundle.tiers[None] == ("native" if has_native else "exported"), (
        bundle.tiers, bundle.errors)
    assert not has_native or bundle.stamp_ok
    exported = inference.load_exported(rung_dir, device=dev)
    graph_k8 = sum(str(n.target) == "paddle_tpu_torch.fused_dequant_matmul"
                   ".default" for n in exported.exported_program.graph.nodes)
    n_mul = summary["quantized_ops"]["quantized_mul"]
    assert graph_k8 == n_mul, graph_k8

    cfg = inference.Config(os.path.join(work, "int8"))
    if dev == "cpu":
        cfg.disable_gpu()
    reloaded = inference.create_predictor(cfg)
    rng = np.random.RandomState(4101)
    requests = [resnet_images(rng, batch, image_size)
                for _ in range(DEPLOY_REQUESTS)]
    tiers = {"predictor": lambda x: reloaded.run({"img": x})[0],
             "exported": lambda x: exported.run({"img": x})[0]}
    if has_native:
        tiers["native"] = lambda x: bundle.runners[None].run({"img": x})[0]
    rows, per_tier, launches = {}, {}, {"quantized_matmul": 0}
    for name, run in tiers.items():
        run(requests[0])                 # warm-up: allocator, capture
        k8.reset_launch_counts()
        rows[name], secs = _timed_runs(torch, run, requests)
        n = k8.launch_counts["quantized_matmul"]
        per_tier[name] = {"p50_ms": float(np.median(secs)) * 1e3,
                          "k8_launches": n}
        if name in ("exported", "native"):
            # the CPU (a rehearsal) runs K8's plain version: no launch
            assert n == (len(requests) if dev == "cuda" else 0), (name, n)
            launches["quantized_matmul"] += n
    want = rows["predictor"]
    exported_equal = all(np.array_equal(a, b)
                         for a, b in zip(rows["exported"], want))
    native_err = None
    if has_native:
        native_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                         for a, b in zip(rows["native"], want))
    summary.update(load_s=load_s, per_tier=per_tier,
                   exported_bit_equal=exported_equal,
                   native_max_err=native_err, requests=len(requests),
                   k8_in_graph=graph_k8)
    print(f"deploy (a): built in a child over {summary['child_s']:.1f} s "
          f"(waited {summary['waited_s']:.1f} s for it here): init + PTQ "
          f"{summary['init_and_ptq_s']:.2f} s, int8 save + load "
          f"{summary['int8_save_load_s']:.2f} s, torch.export "
          f"{summary['export_s']:.2f} s, AOTInductor "
          f"{summary['aoti_compile_s'] or 0.0:.2f} s ({summary['aoti_cxx']});"
          f" bundle load {load_s:.2f} s; p50 ms a request of {batch}: "
          + ", ".join(f"{k} {v['p50_ms']:.3f} (K8 {v['k8_launches']})"
                      for k, v in per_tier.items())
          + f"; exported == Predictor: {exported_equal}, native max err "
          f"{native_err} (gate {SERVE_INT8_ROW_TOL}) {tag}")
    assert exported_equal, "exported tier != the int8 Predictor"
    assert native_err is None or native_err <= SERVE_INT8_ROW_TOL, native_err
    for out in rows["exported"]:
        assert np.isfinite(out).all() and out.shape[0] == batch, out.shape
    handoff = (rung_dir, requests[0],
               rows["native"][0] if has_native else None, work)
    del reloaded, bundle, exported
    if not has_native:
        shutil.rmtree(work, ignore_errors=True)
    return summary, launches, handoff


def deploy_checkpoint(torch, seed, tag, dev="cuda", image_size=None,
                      batch=None):
    """Phase 41(b). The f32 ResNet-50 training program (phase 14's) at
    batch CKPT_BATCH under deterministic cuDNN: 2 steps (the eager
    warm-up, then the captured graph), `save_checkpoint` with
    `async_save` while 2 more steps replay (their losses A); then
    `load_checkpoint` and the 2 steps again (losses B). A == B bit for
    bit, and the saved tensors equal the state at the save, not after
    it. Returns the summary."""
    import shutil
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.lowering import referenced_state
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.io import checkpoint as ckpt_mod

    image_size = image_size or DEPLOY_IMAGE
    batch = batch or CKPT_BATCH
    main, startup, _, _, loss = resnet_train_programs(seed, image_size)
    rng = np.random.RandomState(seed + 4102)
    feeds = [{"img": resnet_images(rng, batch, image_size),
              "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)}
             for _ in range(2)]
    ck = tempfile.mkdtemp(prefix="ckpt_")
    deterministic_cudnn(torch, flags, True)
    try:
        exe, scope = Executor(dev), Scope()
        with scope_guard(scope):
            exe.run(startup)
            for i in range(2):
                exe.run(main, feed=feeds[i], fetch_list=[loss])
            names = referenced_state(main, scope)
            at_save = {n: scope.find_np(n) for n in names}
            t0 = time.perf_counter()
            tio.save_checkpoint(exe, ck, main, step=2, async_save=True)
            save_return_ms = (time.perf_counter() - t0) * 1e3
            mgr = ckpt_mod._managers[os.path.abspath(ck)]
            la = [float(exe.run(main, feed=feeds[i], fetch_list=[loss])[0])
                  for i in range(2)]
            steps_s = time.perf_counter() - t0
            in_flight = mgr.in_flight()
            mgr.wait()
            save_s = time.perf_counter() - t0
            after = {n: scope.find_np(n) for n in names}
            assert tio.load_checkpoint(exe, ck, main) == 2
            lb = [float(exe.run(main, feed=feeds[i], fetch_list=[loss])[0])
                  for i in range(2)]
        saved, _ = tio.CheckpointManager(ck).restore(2)
        saved_equal = all(np.array_equal(np.asarray(saved[n]), at_save[n])
                          for n in names)
        moved = sum(not np.array_equal(after[n], at_save[n]) for n in names)
    finally:
        deterministic_cudnn(torch, flags, False)
        shutil.rmtree(ck, ignore_errors=True)
    assert la == lb, (la, lb)
    assert saved_equal, "the checkpoint is not the state at the save"
    assert moved > 0, "the steps after the save moved no state"
    summary = {"losses": la, "resumed_losses": lb, "bit_equal": la == lb,
               "state_names": len(names), "changed_after_save": moved,
               "saved_equals_state_at_save": saved_equal,
               "save_return_ms": save_return_ms,
               "steps_during_save_s": steps_s, "save_total_s": save_s,
               "in_flight_after_steps": in_flight}
    print(f"deploy (b): async save of {len(names)} tensors returned in "
          f"{save_return_ms:.1f} ms; 2 captured steps ran {steps_s:.3f} s "
          f"after it began (still writing after them: {in_flight}); the "
          f"save took {save_s:.3f} s; resumed losses {lb} == {la}; saved "
          f"== state at the save ({moved} tensors moved after it) {tag}")
    return summary


def deploy_aoti_run(torch, tag, aoti_build, handoff):
    """Phase 41(c). `pt_aoti_run` (built beside phase 1) in a child
    process on (a)'s rung with the first request as .npy: its outputs
    equal (a)'s native tier's rows on that input, its last line reads ok
    with K8 launched in the child. Returns (summary, its K8 launches)."""
    import shutil
    rung_dir, x, native_rows, work = handoff
    build_s, exe = aoti_build()
    try:
        xin = os.path.join(work, "img.npy")
        np.save(xin, x)
        out_dir = os.path.join(work, "aoti_out")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        proc = subprocess.run([exe, "--model-dir", rung_dir, "--input",
                               f"img={xin}", "--output-dir", out_dir,
                               "--repeat", str(DEPLOY_REQUESTS)],
                              capture_output=True, text=True, timeout=300)
        wall_s = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-3000:]
        doc = json.loads(proc.stdout.strip().splitlines()[-1])
        got = np.load(os.path.join(out_dir, "out_0.npy"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert doc["ok"] and doc["engine"] == "aoti", doc
    assert doc["k8_launches"] == (DEPLOY_REQUESTS if doc["device"] == "cuda"
                                  else 0), doc
    equal = bool(np.array_equal(got, native_rows))
    assert equal, float(np.abs(got - native_rows).max())
    summary = dict(doc, build_s=build_s, child_wall_s=wall_s,
                   equals_native_tier=equal)
    print(f"deploy (c): pt_aoti_run built in {build_s:.1f} s; child "
          f"{wall_s:.2f} s, a request {doc['latency_ms_avg']:.3f} ms avg / "
          f"{doc['latency_ms_best']:.3f} best over {doc['repeat']}, K8 "
          f"{doc['k8_launches']} in the child; outputs == native tier "
          f"{tag}")
    return summary, doc["k8_launches"]


def widened_flash_case(torch, tfa, dtype, b, t, n, d, offset=0, rate=0.0,
                       pad=False, backward=True, seed=0):
    """One of Step 0's shapes through the public wrappers against the
    plain version on the same inputs: q, k, v views of a fused
    [B, T, 3, N, D] tensor `offset` elements into its buffer, the
    padding mask of `flash_inputs`, forward o (and lse through
    flash_attention_lse when there is no dropout) and one backward.
    Returns ({output: (max abs err, relative err)}, launches)."""
    dev = "cuda"
    qkv, dout, mask = flash_inputs(torch, dev, dtype, b, t, n, d, pad,
                                   False, seed)
    seed_k = SEED_ATTN if rate else None
    res = {}
    for side in ("kernel", "plain"):
        buf = torch.empty(qkv.numel() + offset, dtype=dtype, device=dev)
        buf[offset:].copy_(qkv.reshape(-1))
        buf.requires_grad_(backward)
        x = buf[offset:].view(qkv.shape)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        if side == "kernel":
            before = dict(tfa.launch_counts)
            o = tfa.flash_attention(q, k, v, mask, dropout_rate=rate,
                                    dropout_seed=seed_k)
            lse = (None if rate else tfa.flash_attention_lse(
                q.detach(), k.detach(), v.detach(), mask)[1])
        else:
            keep = (tfa.batch_keep_masks(SEED_ATTN, b, n, t, t, rate,
                                         device=dev) if rate else None)
            o, lse = tfa.attention_reference(q, k, v, mask, keep_masks=keep,
                                             return_lse=True)
        out = {"o": o.detach()}
        if lse is not None and not rate:
            out["lse"] = lse.detach()
        if backward:
            (o.float() * dout.float()).sum().backward()
            grad = buf.grad[offset:].view(qkv.shape)
            out.update(dq=grad[:, :, 0], dk=grad[:, :, 1], dv=grad[:, :, 2])
        if side == "kernel":
            launched = {kn: tfa.launch_counts[kn] - before[kn]
                        for kn in tfa.launch_counts
                        if tfa.launch_counts[kn] != before[kn]}
        res[side] = out
    return _case_errors(torch, res), launched


def _attention_f64(torch, q, k, v, mask, keep):
    """`attention_reference`'s arithmetic (no causal) in float64, with
    lse: the exact answer the float32 kernels and the float32 plain
    version are both held to at T = 65600, where float32's own rounding
    over 65600 keys reaches FLASH_TOL (the plain version computes its
    logits in float32 by design)."""
    logits = torch.einsum("btnd,bsnd->bnts", q, k) * (1.0 / q.shape[-1] ** 0.5)
    if mask is not None:
        logits = logits + mask[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    if keep is not None:
        probs = probs * keep.double()
    out = torch.einsum("bnts,bsnd->btnd", probs, v)
    return out, torch.logsumexp(logits, dim=-1).permute(0, 2, 1)[..., None]


def long_sequence_case(torch, tfa, dtype, t=65600, n=2, d=32, rows=256,
                       rate=0.0, bias=False, seed=0, dev="cuda"):
    """T >= 65536 (no longer refused): one forward and backward of n
    heads over t queries and keys on the kernels, the first and last
    `rows` query rows held against the plain version on those rows (all
    keys): o (and lse without dropout), and, with the output's cotangent
    zero on every other row (so no other row adds to them), dq on those
    rows, dk and dv over all keys, and with `bias` the gradient of an
    additive key bias over all keys; dq of every other row must be
    exactly 0. The plain version's dropout mask is drawn at the rows'
    own indices (`row0`; past row 65535 the counter wraps, as the
    kernels' and the JAX package's). The plain version is
    `attention_reference` in the kernels' dtype; for float32 also the
    same arithmetic in float64 (`_attention_f64`). Returns ({"plain":
    {output: (max abs err, relative err)}, "f64": the kernel's errors
    against float64 (float32 only), "plain_f64": the float32 plain
    version's against float64}, launches)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((1, t, n, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    mask = (torch.randn((1, t), generator=g, device=dev) * 0.5
            if bias else None)
    sls = (slice(0, rows), slice(t - rows, t))
    dout = torch.zeros((1, t, n, d), device=dev)
    for sl in sls:
        dout[:, sl] = torch.randn((1, rows, n, d), generator=g, device=dev)
    got = {}
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    m_leaf = mask.clone().requires_grad_() if bias else None
    before = dict(tfa.launch_counts)
    if rate or bias:
        o = tfa.flash_attention(*leaves, m_leaf, dropout_rate=rate,
                                dropout_seed=SEED_ATTN if rate else None,
                                mask_grad=bias)
    else:
        o, lse = tfa.flash_attention_lse(*leaves)
        got.update({f"lse_{i}": lse[:, sl].detach()
                    for i, sl in enumerate(sls)})
    (o.float() * dout).sum().backward()
    launched = {kn: tfa.launch_counts[kn] - before[kn]
                for kn in tfa.launch_counts
                if tfa.launch_counts[kn] != before[kn]}
    dq = leaves[0].grad
    rest = float(dq[:, rows:t - rows].float().abs().max())
    assert rest == 0.0, f"T={t}: dq of rows with a zero cotangent {rest}"
    got.update({f"o_{i}": o[:, sl].detach() for i, sl in enumerate(sls)})
    got.update({f"dq_{i}": dq[:, sl] for i, sl in enumerate(sls)})
    got.update(dk=leaves[1].grad, dv=leaves[2].grad)
    if bias:
        got["dbias"] = m_leaf.grad
    keep = (torch.cat([tfa.keep_mask_reference(
        SEED_ATTN, torch.arange(n).reshape(1, n), rows, t, rate,
        device=dev, row0=sl.start) for sl in sls], 2) if rate else None)
    dout_rows = torch.cat([dout[:, sl] for sl in sls], 1)

    def plain(f64):
        cast = (lambda x: x.double()) if f64 else (lambda x: x.clone())
        q_rows = cast(torch.cat([q[:, sl] for sl in sls], 1))
        kp, vp = cast(k), cast(v)
        mp = cast(mask) if bias else None
        for x in (q_rows, kp, vp) + ((mp,) if bias else ()):
            x.requires_grad_()
        if f64:
            po, plse = _attention_f64(torch, q_rows, kp, vp, mp, keep)
        else:
            po, plse = tfa.attention_reference(q_rows, kp, vp, mp,
                                               keep_masks=keep,
                                               return_lse=True)
        (po.to(torch.float64 if f64 else torch.float32)
         * cast(dout_rows)).sum().backward()
        want = {}
        for i in range(len(sls)):
            part = slice(i * rows, (i + 1) * rows)
            want[f"o_{i}"] = po[:, part].detach()
            want[f"dq_{i}"] = q_rows.grad[:, part]
            if f"lse_{i}" in got:
                want[f"lse_{i}"] = plse[:, part].detach()
        want.update(dk=kp.grad, dv=vp.grad)
        if bias:
            want["dbias"] = mp.grad
        return want

    want = plain(False)
    out = {"plain": _case_errors(torch, {"kernel": got, "plain": want})}
    if dtype == torch.float32:
        exact = plain(True)
        out["f64"] = _case_errors(torch, {"kernel": got, "plain": exact})
        out["plain_f64"] = _case_errors(torch, {"kernel": want,
                                                "plain": exact})
    return out, launched


def deploy_flash(torch, tfa, seed, tag):
    """Phase 41(d). Step 0's shapes on the card, each against its plain
    version: D = 80 in bfloat16 and float32 (padded to 128), float16 (the
    float32 kernels on a copy), a bfloat16 view one element off its
    16-byte rows (copied), B * N = 67200 > 65535 at T = 8 with dropout
    (chunked launches, each chunk's seed moved), and T = 65600 in float32
    and bfloat16, each without and with dropout and a key bias, forward
    and backward (`long_sequence_case`). Gates: FLASH_TOL of the
    kernels' dtype (at T = 65600 in float32 against the float64 answer,
    the float32 plain version's own distance from it printed beside),
    FLASH_F16_TOL for float16. Returns the summary."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = {
        "d80_bf16": (dict(dtype=bf16, b=4, t=256, n=4, d=80, pad=True),
                     FLASH_TOL["bfloat16"]),
        "d80_f32": (dict(dtype=f32, b=4, t=256, n=4, d=80, pad=True),
                    FLASH_TOL["float32"]),
        "f16": (dict(dtype=f16, b=4, t=256, n=4, d=64, pad=True),
                FLASH_F16_TOL),
        "bf16_unaligned": (dict(dtype=bf16, b=2, t=256, n=4, d=64,
                                offset=1), FLASH_TOL["bfloat16"]),
        "bn_67200_dropout": (dict(dtype=f32, b=2100, t=8, n=32, d=32,
                                  rate=0.1), FLASH_TOL["float32"]),
    }
    out = {}
    for name, (kw, tol) in cases.items():
        errs, launched = widened_flash_case(torch, tfa, seed=seed, **kw)
        assert launched, name
        out[name] = {"errors": errs, "launches": launched, "tol": tol}
    chunks = len(tfa.bh_chunks(2100, 32))
    assert out["bn_67200_dropout"]["launches"] == {
        "flash_fwd_f32": chunks, "flash_bwd_f32": chunks}, out
    # T = 65600: float32 held to the float64 answer, bfloat16 to its plain
    # version; every case runs and prints before any is gated
    for name, dtype in (("f32", f32), ("bf16", bf16)):
        tol = FLASH_TOL[str(dtype).replace("torch.", "")]
        for extra, kw in (("", {}), ("_dropout_bias",
                                     dict(rate=0.1, bias=True))):
            errs, launched = long_sequence_case(torch, tfa, dtype, seed=seed,
                                                **kw)
            out[f"t_65600_{name}{extra}"] = {
                "errors": errs.get("f64", errs["plain"]), "launches":
                launched, "tol": tol, "against": ("float64" if "f64" in errs
                                                  else "plain"),
                "vs_plain": errs["plain"], "plain_vs_f64":
                errs.get("plain_f64")}

    def worst(errs):
        return max(rel for _, rel in errs.values())

    for name, row in out.items():
        extra = ""
        if row.get("plain_vs_f64"):
            extra = (f" against float64; the kernel against the float32 "
                     f"plain version {worst(row['vs_plain']):.3e}, that "
                     f"plain version against float64 "
                     f"{worst(row['plain_vs_f64']):.3e}")
        print(f"deploy (d) flash {name}: worst relative error "
              f"{worst(row['errors']):.3e}{extra} (gate {row['tol']}), "
              f"launches {row['launches']} {tag}")
    for name, row in out.items():
        assert worst(row["errors"]) <= row["tol"], (name, row["errors"])
        if name.startswith("t_65600"):
            kinds = (("flash_fwd_f32", "flash_bwd_f32") if "f32" in name
                     else ("flash_fwd", "flash_bwd"))
            assert row["launches"] == dict.fromkeys(kinds, 1), (
                name, row["launches"])
    return out


def k8_dispatch_cost(torch, k8, tag, calls=300, m=8, k=2048, n=1000):
    """The registered op's dispatch cost on an eager call: host
    microseconds a call (enqueue, no synchronise inside the window) of
    `torch.ops.paddle_tpu_torch.fused_dequant_matmul` against the
    wrapper's checked launch it dispatches to, at the ResNet-50 fc's
    shape, in turns (direct, op, op, direct). Launches made here are a
    comparison's, reset after."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=g, device="cuda")
    w_q = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                        dtype=torch.int8)
    w_s = torch.rand((n,), generator=g, device="cuda") + 0.1
    fns = {"direct": lambda: k8._checked_launch(x, w_q, w_s, 2.5, 8, False),
           "op": lambda: k8.op()(x, w_q, w_s, 2.5, 8)}
    assert torch.equal(fns["direct"](), fns["op"]())
    us = {name: [] for name in fns}
    for name in ("direct", "op", "op", "direct"):
        fns[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name]()
        us[name].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    k8.reset_launch_counts()
    out = {name: float(np.mean(v)) for name, v in us.items()}
    out["dispatch_us"] = out["op"] - out["direct"]
    print(f"deploy K8 dispatch: {out['op']:.2f} us a call through "
          f"torch.ops against {out['direct']:.2f} us for the wrapper's "
          f"launch ({out['dispatch_us']:.2f} us of dispatch; host time, "
          f"{calls} calls x 2 turns each, M={m} K={k} N={n}) {tag}")
    return out


def deploy_phase(torch, k8, tfa, seed, tag, aoti_build, export_join=None,
                 dev="cuda"):
    """Phase 41, legs (a)-(d); (a)'s artifacts come from the child that
    `export_join` waits for (started now when None). K8's launches of the
    exported and native tiers and of pt_aoti_run's child are its "deploy"
    path. Returns (summary, launches)."""
    t0 = time.perf_counter()
    out = {}
    if export_join is None:
        export_join = start_deploy_export(seed, dev)
    # (d) and (b) first: they run while the export child compiles
    out["flash"] = deploy_flash(torch, tfa, seed, tag)
    torch.cuda.empty_cache()
    out["checkpoint"] = deploy_checkpoint(torch, seed, tag, dev=dev)
    torch.cuda.empty_cache()
    out["k8_dispatch"] = k8_dispatch_cost(torch, k8, tag)
    out["export"], launches, handoff = deploy_export(torch, k8, tag,
                                                     export_join, dev=dev)
    out["aoti_run"], child = deploy_aoti_run(torch, tag, aoti_build,
                                             handoff)
    launches["quantized_matmul"] += child
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    beside = out["export"]["beside_phases"]
    print(f"phase 41: {out['seconds']:.1f} s here (its export child ran "
          f"{out['export']['child_s']:.1f} s, from "
          f"{out['export']['started_before_s']:.1f} s before (a) waited for "
          f"it, beside phases {', '.join(beside + ['41(d), 41(b)'])}); K8 "
          f"launches on the deploy path {launches} {tag}")
    return out, launches


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--rank-worker"]:
        return rank_worker_main(argv[1:])
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
    ap.add_argument("--capture", action="store_true",
                    help="only build the kernels, make phase 3's "
                         "references and run phases 31 and 32 (the "
                         "captured rungs and Executor programs against "
                         "eager runs); print one CAPTURE line")
    ap.add_argument("--serving", action="store_true",
                    help="only build the kernels and run phase 33 (the "
                         "serving front end: gateway, registry, hot swap, "
                         "warm start, streamed generation); print one "
                         "SERVING line")
    ap.add_argument("--fleet", action="store_true",
                    help="only build the kernels and run phases 34 and 35 "
                         "(the fleet: routers, backend processes, failover, "
                         "autoscaling; fault-tolerant training under the "
                         "supervisor); print one FLEET line")
    ap.add_argument("--parallel", action="store_true",
                    help="only build the kernels and run phases 36-38 "
                         "(data, tensor, sequence, expert and pipeline "
                         "parallelism over a pool of 4 gloo ranks); print "
                         "one PARALLEL line")
    ap.add_argument("--ps", action="store_true",
                    help="only run phase 39 (the parameter server, the "
                         "launcher and dataset training with DeepFM); "
                         "print one PS line")
    ap.add_argument("--slim", action="store_true",
                    help="only build the kernels and run phase 40 (prune, "
                         "distill, plan, quantize and serve ResNet-50 under "
                         "the armed lock checker, then NAS); print one SLIM "
                         "line")
    ap.add_argument("--deploy", action="store_true",
                    help="only build the kernels and run phase 41 (ResNet-50 "
                         "int8 exported, bundled with an AOTInductor tier "
                         "and served from the artifact, pt_aoti_run, "
                         "checkpoints on captured state, the widened flash "
                         "shapes); print one DEPLOY line")
    ap.add_argument("--deploy-child-late", action="store_true",
                    help="in the whole script, start phase 41's export "
                         "child at phase 41 rather than before phase 26: "
                         "the phases it would run beside are then timed "
                         "without it (about 2 minutes longer in all)")
    ap.add_argument("--ft-worker", default=None, metavar="JSON",
                    help=argparse.SUPPRESS)
    for role in ("--ps-server", "--ps-trainer", "--collective-worker",
                 "--deploy-export"):
        ap.add_argument(role, default=None, metavar="JSON",
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ft_worker is not None:
        return ft_worker(json.loads(args.ft_worker))
    for spec, fn in ((args.deploy_export, deploy_export_main),
                     (args.ps_server, ps_server_main),
                     (args.ps_trainer, ps_trainer_main),
                     (args.collective_worker, ps_collective_main)):
        if spec is not None:
            return fn(json.loads(spec))
    out_dir = (os.path.dirname(os.path.abspath(args.out)) if args.out
               else None)

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

    # 1. device + build (phase 39's native library on a thread beside)
    card = card_line()
    print(f"card: {card}")
    tag = f"[{card}]"
    native_build = (start_native_build() if not any(
        (args.capture, args.serving, args.fleet, args.parallel,
         args.slim, args.deploy)) else None)
    # phase 41's pt_aoti_run, g++ against the torch headers, likewise
    aoti_build = (start_aoti_build() if not any(
        (args.capture, args.serving, args.fleet, args.parallel, args.slim,
         args.ps)) else None)
    if args.ps:
        out, _ = ps_phase(torch, args.seed, tag, native_build=native_build)
        print("PS " + json.dumps(out, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['build_seconds']:.2f} s, "
          f"{'built' if info['built'] else 'already built'}) {tag}")
    # the tensor-core kernels' ptxas lines and SASS
    build = build_report(info, tag)

    if args.deploy:
        from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
        out, launches = deploy_phase(torch, k8, tfa, args.seed, tag,
                                     aoti_build)
        print("DEPLOY " + json.dumps(dict(out, launches=launches),
                                     default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.slim:
        from paddle_tpu_torch.ops.kernels import quantized_matmul as k8
        out, launches = slim_phase(torch, k8, args.seed, tag)
        print("SLIM " + json.dumps(dict(out, launches=launches),
                                   default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.parallel:
        out, launches = parallel_phases(torch, tfa, args.seed, tag)
        print("PARALLEL " + json.dumps(dict(out, launches=launches),
                                       default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.fleet:
        out, launches = fleet_phase(torch, gen, args.seed, tag)
        ft = ft_phase(torch, args.seed, tag)
        print("FLEET " + json.dumps({"fleet": out, "launches": launches,
                                     "fault_tolerant_training": ft},
                                    default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.serving:
        out, launches = serving_phase(torch, gen, args.seed, tag)
        print("SERVING " + json.dumps(dict(out, launches=launches),
                                      default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 2. kernels against their plain versions
    if not args.capture:
        kernels = check_kernels(torch, da, gen, args.seed, tag)

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

    if args.capture:
        out = capture_phase(torch, gen, tfa, model, prompts, budgets, gaps,
                            args.seed, tag, out_dir)
        del model
        torch.cuda.empty_cache()
        out["executor"] = executor_phase(torch, args.seed, tag)
        print("CAPTURE " + json.dumps(out, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
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

    # 31. the captured rungs against eager runs (while phase 3's model
    # and references are alive)
    results["capture"] = capture_phase(torch, gen, tfa, model, prompts,
                                       budgets, gaps, args.seed, tag,
                                       out_dir)
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

    # phase 41(a)'s artifacts (ResNet-50 int8 exported and compiled by
    # AOTInductor, ~2 minutes of host compile) are built by a child from
    # here on, beside the phases that start before it ends (each says
    # so); with --deploy-child-late, from phase 41 on
    deploy_export_join = (None if args.deploy_child_late
                          else start_deploy_export(args.seed))

    def beside_child(phases):
        if deploy_export_join is not None:
            deploy_export_join.note(phases, tag)

    # 26-28. the detection ops and YOLOv3, which launch none of the
    # kernels: every count stays 0
    beside_child("26-28")
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
    beside_child("29-30")
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

    # 32. the Executor's programs captured against eager runs
    beside_child("32")
    results["executor_capture"] = executor_phase(torch, args.seed, tag)

    # 33. the serving front end: the gateway's launches of K6, K7 and K8
    # (counts reset just before each gateway window, read just after)
    beside_child("33")
    results["serving"], gw_launches = serving_phase(torch, gen, args.seed,
                                                    tag)
    for k, n in gw_launches.items():
        assert n > 0, (k, gw_launches)
        first = ("predictor" if k == "quantized_matmul" else "in_process")
        kernels[k]["launches_by_path"] = {first: kernels[k]["launches"],
                                          "gateway": n}
        kernels[k]["launches"] += n

    # 34. the fleet: K7's launches in the backend processes, read from
    # their drain documents (each backend zeroes its counts after its
    # warm-up)
    beside_child("34")
    results["fleet"], fleet_launches = fleet_phase(torch, gen, args.seed,
                                                   tag)
    for k, n in fleet_launches.items():
        kernels[k]["launches_by_path"]["fleet"] = n
        kernels[k]["launches"] += n
    torch.cuda.empty_cache()

    # 35. fault-tolerant training, which launches none of the kernels
    beside_child("35")
    results["fault_tolerant_training"] = ft_phase(torch, args.seed, tag)
    torch.cuda.empty_cache()

    # 36-38. parallelism over a pool of gloo ranks: the flash kernels'
    # launches in the ranks of phases 37 and 38, read from each rank's
    # own counters (zeroed just before each step)
    beside_child("36-38")
    results["parallel"], par_launches = parallel_phases(
        torch, tfa, args.seed, tag)
    for k in FLASH_KERNELS:
        kernels[k]["launches_by_path"]["parallel"] = par_launches[k]
        kernels[k]["launches"] += par_launches[k]
    # phase 37's f32 flash cases at the ranks' shapes
    for errs in results["parallel"]["sequence_expert"][
            "flash_cases"].values():
        for kname in FLASH_F32:
            kernels[kname]["max_abs_err"] = max(
                kernels[kname]["max_abs_err"],
                *(errs[o][0] for o in FLASH_OUTPUTS[kname] if o in errs))

    # 39. the parameter server, the launcher and dataset training, which
    # launch none of the kernels, here or in a child process
    beside_child("39")
    results["ps"], ps_launches = ps_phase(torch, args.seed, tag,
                                          native_build=native_build)
    for name in kernels:
        by_path = kernels[name].setdefault(
            "launches_by_path", {"main": kernels[name]["launches"]})
        by_path["ps"] = ps_launches.get(name, 0)

    # 40. the slim pipeline: K8's int8 launches on the pruned, distilled
    # and planned ResNet-50 (counts reset just before its requests and its
    # gateway windows, read just after)
    beside_child("40")
    results["slim"], slim_launches = slim_phase(torch, k8, args.seed, tag)
    for name in kernels:
        n = slim_launches.get(name, 0)
        kernels[name]["launches_by_path"]["slim"] = n
        kernels[name]["launches"] += n

    # 41. the deployment artifacts: K8's launches through the exported and
    # native tiers of the int8 ResNet-50's bundle and in pt_aoti_run's
    # child (counts reset just before each tier's requests, read just
    # after; the child counts its own; the export child launches none)
    results["deploy"], deploy_launches = deploy_phase(
        torch, k8, tfa, args.seed, tag, aoti_build, deploy_export_join)
    for name in kernels:
        n = deploy_launches.get(name, 0)
        kernels[name]["launches_by_path"]["deploy"] = n
        kernels[name]["launches"] += n

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
