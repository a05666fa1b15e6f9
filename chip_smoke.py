#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (each prints one JSON line):

1. device   -- the card's name and power limit (``nvidia-smi``).
2. build    -- compiles ``multimodal_moe_torch/csrc/{nms_keep,ms_deform_fwd,
               ms_deform_bwd,moe_ffn_fwd,gmm}.cu`` with nvcc, all at once, into
               ``multimodal_moe_torch/build/``, and ``nms_keep.cu`` a second
               time without its margin filter; build seconds and ptxas
               register and spill counts.
3. nms_keep -- the NMS keep-mask kernel against its plain PyTorch version on
               the card (``NMS_CASES``): B=128 K=512 class-agnostic, B=16
               K=1024 and B=128 K=1024 with 3 classes (forced score ties,
               repeated boxes, boxes exactly at the IoU threshold, one
               all-invalid image), above the shared-memory walk B=16 K=1025,
               2048 and 4096 with 3 classes and B=2 K=18,018 (the headline
               model's every anchor), K=300 and K=1000 (no multiple of 64), B=1,
               every box identical, every box disjoint, pairs at IoU exactly
               0.7 at scales 5 to 1000, NaN / +-inf / 1e30 coordinates, and
               thresholds 0.0 and 1.0. Keep masks and ``NmsResult`` must be
               bitwise equal; each case's time called eagerly
               (``kernel_ms``) and on the device alone (``device_ms``, a
               CUDA graph of 20 calls), its bound and CTAs an image of the
               mask launch. The build without the margin filter
               (``NMS_NO_FILTER``) must give the same keep masks; its device
               time beside the default build's (``no_filter_device_ms``).
4. serving  -- YOLO-s (``arch="tpu"``, random weights from seed 0) at
               704x1248 through ``make_serving_step``:
               fp32 B=8 with TF32 off: full and topk tails bitwise equal, the
               kernel tail equal to the plain tail on the same forward;
               card against CPU, fp32 B=1: logits within
               |d| <= 1e-4 + 1e-3*|cpu|;
               the headline, bf16 B=128 pool 512 full tail: forward ms, NMS
               tail ms and its split (preselection, kernel, compaction),
               img/s and peak memory, with the launch count of the kernel
               taken over this run alone; the kernel on the forward's own
               candidates at K=512 and K=1024 against its plain version.
4b. evaluate -- the evaluation path at 704x1248: a YOLO-s run dir (random
               weights from seed 0, ``model_config.json`` and
               ``CheckpointManager``'s ``weights/best``) loaded onto the card
               by ``loading.load_detector`` and scored by
               ``evaluator.evaluate_detector`` with ``make_inference_step``
               (pool 1024) over four seeded batches of 16 (one with two
               padded rows, one as YUV420 planes), ground truth planted from
               a first pass's detections; then one batch of 16 each of
               MoE-YOLO-s (E=4, ``auto``, solar bins) and RT-DETR r50vd
               (``use_nms=False``). Checks: each batch's tail bitwise equal
               to the plain tail on the same forward outputs on the CPU, the
               YUV frames to the CPU conversion, the metrics to
               ``coco_map.evaluate_detections`` on the recorded results, 0 <
               mAP50 < 1, B1 launched once a batch and B4 six times;
               printed: the metrics, the three ``speed_*_ms_per_img``,
               ``model_flops_g``, and ``artifacts.collect_runtime_info``,
               which names the card (written with ``save_metrics_json`` and
               ``save_run_metadata_artifacts`` in a temp dir).
4c. server  -- the serving deployment at 704x1248: YOLO-s, MoE-YOLO-s (E=4,
               ``auto``) and RT-DETR r50vd run dirs (random weights from seed
               0) loaded onto the card by ``loading.load_detector``, each
               behind ``server.BatchingDetector`` (batch 16, pool 512, a 20 ms
               window) and ``DetectorHTTPServer`` on 127.0.0.1:0, launch
               counts from zero over the requests the server takes. Checks:
               one request's detections equal to the raw step's on the same
               zero-padded batch, whose tail is bitwise the plain tail on the
               CPU on the same forward outputs; 16 requests in one device
               call, each equal to the raw step on that batch; a response
               independent of its batch neighbours (YOLO-s, MoE-YOLO-s); raw
               and JPEG bodies over HTTP (PIL where the native decoder is
               missing: ``native_jpeg``); MoE-YOLO-s's ``?context=3`` equal
               to the raw step with that context; RT-DETR through the DETR
               top-k tail; B1 launched once a YOLO / MoE device call and B4
               six times an RT-DETR one; no ``errors``. The serve CLI, an
               ``--int8 --calib-images`` serve CLI and the predict CLI (20
               seeded JPEGs of odd sizes) as child processes started
               together after the load, with no kernel built again: ``/healthz`` and one raw
               ``/predict`` each, the fp one equal to the in-process answer
               under torch's TF32 defaults (which the CLIs keep), one entry
               an image with every box inside it. Printed: for YOLO-s under
               closed-loop load (a 1 s ramp, then a timed window: raw bodies
               at 1, 16 and 64 keep-alive clients, JPEG at 16 and 64; every
               request must succeed) requests sent, answered and failed,
               req/s, latency p50 and p99 (p99 from 100 latencies on), mean
               batch fill, and the collector's split of a device call
               (assembly, step to answers, wait); a 64-client raw window
               under ``torch.profiler`` (the card's busy share, its top ops);
               1 client with the handler's Nagle algorithm off;
               ``last_step_ms``; the bare B=16 step by CUDA events; each
               model's warmup seconds.
5. ms_deform_fwd -- the deformable-attention kernel against its plain
               version, and the grid_sample formulation against the plain
               version, at the RT-DETR headline (B=16, levels
               88x156/44x78/22x39, NH=8, D=32, L=3, P=4, Q=300, locations in
               [-0.3, 1.3]), the shape of tests/test_deformable_pallas.py
               (D=8 < 32), locations exactly on pixel centres and on the
               borders 0 and 1, NaN / +inf / -inf / 1e30 locations (the
               kernel only: element for element, the pattern of finite
               values equal), and D=6 (the 4-byte path) and D=8 (a narrow
               16-byte path) at the headline's levels. Tolerance: max |d| <=
               1e-5 * max(1, max|values|).
6. rtdetr_fp32 -- RT-DETR r50vd (hidden 256, 300 queries, 6 decoder layers,
               ``arch="tpu"``, random weights from seed 0), fp32 with TF32 off,
               B=1 at 704x1248, card against CPU (plain deformable version):
               encoder scores, encoder top-k logits, final logits and boxes
               within |d| <= 1e-4 + 1e-3*|cpu|, the CPU decoding the card's
               top-300 queries; the same top-300 selection where the CPU's
               scores are not closer than the card-CPU difference; the
               kernel on decoder layer 0's own inputs against the plain
               version; ``ms_deform_fwd_launches`` up by exactly 6.
7. rtdetr_serving -- RT-DETR through ``make_serving_step`` (DETR top-k tail,
               max_det 300, score threshold 0.001), 704x1248, B=16, in fp32
               (TF32 off, the repo's own RT-DETR configuration) and in bf16:
               step, forward and tail ms, img/s, peak memory, the forward
               split (backbone / encoder / query selection + decoder, CUDA
               events), the kernel's launches over one step from zero; the
               kernel, plain and grid_sample times on the bf16 step's own
               decoder-layer-0 inputs, and the bound from the value rows
               those inputs really sample.
8. moe_ffn_fwd -- the fused expert-FFN kernel against its plain version on the
               card: bf16 at the three MoE-YOLO-s level shapes of the B=128
               headline (E=4; d=128/256/512, h=2d; C from the code's own
               capacity rule, rounded up to 256), fp32 at the shape of
               tests/test_moe_kernels.py, experts 0, 1 and 3 zeroed (only
               expert 2's rows may be non-zero), the widest MoE-YOLO width
               (d=576, h=1152: a partial column block) and h off the
               64-wide hidden chunks (d=192, h=80). Tolerances: fp32
               |d| <= 1e-4*max(1, max|ref|); bf16 one bf16 ulp of the hidden
               tile carried through |W2| plus one ulp of the output
               (``moe_kernels.ffn_tolerance``). Kernel, plain and library
               (two cuBLAS baddbmm with SiLU between) times, the bound, the
               bound share and whether the kernel beat the library call
               (printed, not checked); the kernel's branch-free SiLU against
               its exact division over every float32 input it takes
               (``moe_ffn_silu_check``: no bit may differ).
8b. moe_sweep_fwd -- the fused expert sweep (``csrc/moe_sweep_fwd.cu``: all
               experts' FFN, the gate combine and the residual of one MoE
               level) against its plain version at the three MoE-YOLO-s level
               shapes of the B=128 headline (T = 128 * the level's cells, E=4,
               k=2, d=128/256/512, h=2d, bf16), within
               ``moe_sweep.sweep_tolerance``, bit-identical on a repeat; a
               ragged last tile (T=300); kernel, plain (fp32 products) and
               library (``x + moe_apply_sweep``, the cuBLAS path it replaces)
               times against the bound (4*T*E*d*h flops at 989 TFLOP/s).
9. moe_yolo_fp32 -- MoE-YOLO-s (E=4, k=2, cf=1.25, ``arch="tpu"``, random
               weights from seed 0, context bias randomised), fp32 with TF32
               off, B=2 at 704x1248, seeded context ids, card against CPU in
               ``sweep`` and in ``sparse`` with ``use_fused_ffn``. The CPU
               replays the card's top-2 expert choice; logits within
               |d| <= 1e-4 + 1e-3*|cpu|; per level, the tokens whose own top-2
               differ on the CPU beside the tokens whose 2nd/3rd probability
               gap is below twice the router logit difference (a difference
               is allowed only there); ``moe_ffn_fwd_launches`` up by exactly 3
               per fused forward; the kernel on level 0's own buffer.
10. moe_yolo_serving -- the MoE headline: MoE-YOLO-s bf16 B=128 at 704x1248
               through ``make_serving_step`` (pool 512, full tail, IoU 0.7,
               score threshold 0.001, max_det 300) with seeded context ids,
               on ``dispatch="auto"`` (resolves to sweep at all three
               levels) and on ``sparse`` with each level's ``use_fused_ffn``:
               step ms, img/s, peak memory, the forward split (backbone +
               neck / each MoE level / head + decode; CUDA events from hooks)
               and the tail, the launches over one step from zero, the
               dropped-token share and expert load per level; then the kernel
               on the step's own three level buffers against its plain
               version, with times and bounds.
11. ms_deform_bwd -- the deformable-attention backward kernel, one launch
               for dv, d_loc and d_attn, against its plain version (the
               plain backward and its elementwise part) at the training
               shape (B=16, Q=684, levels 88x156/44x78/22x39, NH=8, D=32,
               L=3, P=4, locations in [-0.3, 1.3]), the shape of
               tests/test_deformable_pallas.py (D=8), pixel centres and the
               borders 0/1, a contention case (every sample of a (batch,
               head) on one location), NaN / +inf / -inf / 1e30 locations,
               D=6 and D=8. Tolerances: each element of dv, d_loc and d_attn
               within 2·n·u of the sum of the n absolute terms that make it
               (u = 2^-24: two summation orders;
               deformable_kernel.deform_bwd_tolerance), d_loc and d_attn also
               within 1e-5·max(1, max|ref|); the pattern of finite values
               equal. The whole backward's time (the dv zero fill included)
               and the zero fill's alone, the bound of the fused function
               beside the unfused one's (s written in place of d_loc and
               d_attn).
12. rtdetr_train_fp32 -- one DetectionTrainer.train_step of RT-DETR r50vd
               (scripts/train_rtdetr.py's model and optimizer, random
               weights from seed 0) at B=1, 704x1248, 96 ground-truth
               slots, fp32 with TF32 off, card against CPU with the same
               augmentation and denoising draws; the CPU solves its own
               assignment where the card's optimum is unique by more than
               the card-CPU cost difference and replays the card's
               elsewhere. Checks: the loss, each module's gradient, the
               deformable projections' gradients finite and non-zero, and
               ms_deform_fwd / ms_deform_bwd each launched exactly 6 times.
13. rtdetr_train -- the training headline: the configuration of
               scripts/train_rtdetr.py (B=16, 704x1248, AdamW lr 1e-4,
               remat, 96 ground-truth slots, HSV jitter and flips), fp32 with
               TF32 on: step ms, img/s, peak memory, the step's split
               (forward / loss with the host matcher's own time / backward /
               optimizer + EMA, CUDA events), 6 + 6 launches per step; B5 on
               the step's own inputs (the last decoder layer's backward) and
               B4 on its own forward inputs (decoder layer 0, Q=684) against
               their plain versions, with times and bounds; then a learning
               check (one fixed batch, B=4, no augmentation, warmup of 1
               step: the loss falls over 20 steps).
14. gmm_kernel -- the grouped GEMM (csrc/gmm.cu) against its plain versions:
               gmm, the transposed gmm (the lhs gradient) and tgmm (the rhs
               gradient) at the six level shapes of the MoE-YOLO-s B=16
               training step (M = 2 x 219,648 / 54,912 / 13,728 rows; K, N =
               128/256, 256/128, 256/512, 512/256, 512/1024, 1024/512; E=4,
               segment sizes from a seeded router), float32 with TF32 off;
               one bf16 shape, one mixed bf16 x float32 shape, an empty
               group, the collapse case (all rows in one group), a row count
               that is no multiple of the tile, tgmm segments of 1, 3, 15, 16
               and 17 rows (the edge of the exact short-sum path) and K, N
               below it. Tolerance: each element within 2·n·u·Σ|aᵢbᵢ|
               (u = 2^-24, n the length of its sum), err_over_bound per case
               (and per tgmm segment); two tgmm launches on the level-0
               inputs bitwise equal; a NaN in lhs and in the output gradient
               reaches the same outputs as in the plain versions. Kernel,
               plain, library (one cuBLAS mm per segment) and bound times per
               launch at the level shapes (the bound: bytes, or 1-3 TF32
               products by input types at 495 TFLOP/s), and tgmm's two
               passes' device times.
15. moe_yolo_train_fp32 -- one DetectionTrainer.train_step of MoE-YOLO-s on
               ``dispatch="gmm"`` (scripts/train_moe.py's model and optimizer,
               random weights from seed 0) at B=1, 704x1248, 96 ground-truth
               slots, fp32 with TF32 off, card against CPU with the same
               augmentation draws; the CPU replays the card's expert choice
               and TAL assignment and counts where its own differ. Checks:
               the loss, each MoE level's parameter gradients on the card's
               own inputs and output gradient, 12 gmm and 6 tgmm launches.
16. moe_yolo_train -- the slice's headline: the B=16 step of
               scripts/train_moe.py (SGD-Nesterov, HSV + flips, 96 slots, a
               solar bin a frame) on ``dispatch="gmm"`` and on ``auto`` (the
               sweep), fp32 with TF32 on: step ms, img/s, peak memory, the
               split (augment / trunk / each MoE level / head / loss with
               the assignment / backward / optimizer + EMA, CUDA events),
               launches per step (12 + 6 on gmm, 0 on auto); then a 20-step
               learning check at B=4 on one fixed batch.
17. yolo_train -- the B=16 YOLO-s step of scripts/train_yolo.py with the
               trainer's default yolo_loss: step ms, img/s, peak memory, split.
18. int8    -- int8 PTQ serving (random weights from seed 0, absmax
               calibration on 2 seeded batches of 4 frames, 2 of 2 for
               RT-DETR, the default bf16 epilogue), 704x1248: ``int8_conv2d``
               (``torch._int_mm``) bitwise against its float64 version at every
               distinct conv shape of a YOLO-s B=2 forward, on that forward's
               codes (the class prediction's N = 1 among them), and each shape
               timed at B=32 (whole conv, im2col, ``_int_mm``) beside the bf16
               cuDNN conv; YOLO-s card against CPU at B=1 in the ``silu`` and
               ``bf16`` epilogues (the first conv's int32 accumulator bitwise,
               the share of output codes one apart per requantizing conv, logits
               20x closer card-to-CPU than int8-to-fp); the YOLO-s and
               MoE-YOLO-s (E=4, solar bins, the w8a8 sweep) B=128 headlines
               (pool 512, full tail: step, forward and tail ms, img/s, peak
               memory beside the same run's bf16 headline, B1 once a step, the
               kernel tail bitwise against the plain tail, the forward's im2col /
               ``_int_mm`` / epilogue device time from ``torch.profiler``);
               RT-DETR r50vd int8 at B=16 (step ms, img/s, peak memory, B4 six
               times a step and on decoder layer 0's own inputs against its plain
               version); ``evaluate_detector`` on a ``loading.quantize_loaded``
               YOLO-s run dir (the npz written by the first load, reused by the
               second; four batches of 16, each tail bitwise against the plain
               tail on the CPU, B1 once a batch, 0 < mAP50 < 1).
19. data    -- the data path at 704x1248, B=16. The host's libraries first
               (``host_lacks``: pandas, pyarrow, PIL, g++, libjpeg). With all
               five: a corpus of 64 distinct pre-resized 4:2:0 JPEGs (PIL)
               cycled by a parquet of 4,032 rows and split CSVs;
               ``ResidentDetectionLoader(store="yuv420")`` over the
               4,000-frame train split (5.27 GB of planes on the card:
               ``decode_s``, ``upload_s``, ``upload_gb_s``, bytes, peak
               memory), a B=16 gather + conversion timed (``gather_ms``,
               median of 20) and bitwise equal to ``yuv420_to_rgb_u8`` of the
               same planes on the CPU; ``DetectionLoader(store="yuv420",
               num_workers=8)`` over 160 frames (``loader_img_s``), through
               ``prefetch_to_device`` (``h2d_gb_s``), each ``image`` bitwise
               and the targets equal to the resident loader's; ``store="rgb"``'s
               ``loader_img_s``; then ``DetectionTrainer.fit`` for one epoch of
               MoE-YOLO-s (``gmm``, TF32 on) over a resident and a streaming
               160-frame split with ``make_ema_val_fn`` over a streaming
               32-frame val split (B=12, the last batch padded):
               ``fit_step_ms`` beside the ``moe_yolo_train`` step; B3's 18
               launches a step, B1 once a val batch; finite losses;
               ``fit_progress.json`` and ``weights/last`` written. Where the
               host cannot decode the corpus to planes, the same device half
               on numpy planes and targets at the same sizes (the rgb loader
               and the val split still from the corpus where PIL, pandas and
               pyarrow are there).
20. multigpu -- DetectionTrainer on a mesh of two ranks sharing the card over
               gloo (NCCL refuses two ranks on one device; gloo stages each
               CUDA collective through the host, so the times are not a
               multi-GPU speed), started by ``parallel.distributed.run_ranks``
               as ``chip_smoke.py --multigpu-rank DIR``: MoE-YOLO-s (E=4) at
               704x1248, global B=16 (8 a rank), one step from seed-0 weights
               on 1 data x 2 expert on ``sweep`` and on ``gmm``, on 2 x 1 on
               ``auto``, and YOLO-s on 2 x 1, fp32 with TF32 off, each against
               the one-process step on the same global batch, weights and
               draws: the loss within 1e-5 relative, the metrics equal on
               both ranks, every parameter within 1e-3 of its update plus an
               ulp, every momentum trace (the gradient, the first step's lr
               being 0) within 1e-3 of its norm, every running mean within
               1e-6 of sqrt(var) and running variance within 1e-6 relative
               (tests/test_torch_distributed.py's rules), each MoE level's
               top-2 sets identical outside the near ties (2nd and 3rd
               probabilities within twice the largest probability
               difference: the two steps sum in different orders, so such a
               token may fall either way), which stay under 1% of the
               level's tokens; B3 6 + 6 + 6 launches a rank on ``gmm`` (``multigpu_launches`` in the
               ``kernels`` line), none on the others; each rank's first and
               second step ms and peak memory beside the one-process step's.
               RT-DETR r50vd (``rtdetr_2x1``: scripts/train_rtdetr.py's
               trainer, remat, AdamW 1e-4, 96 ground-truth slots) on 2 x 1
               with the same global B=16: the first step on the one-process
               step's query selection and matching (each rank its rows; at
               random init float32 noise moves the decoder's costs, so the
               ranks' own matching may differ only where the one-process
               costs prefer their choice by no more than the two steps'
               costs differ on the two assignments), the loss and each
               part, the gradient (summed over the ranks, before the clip)
               in norm and in scale (its projection on the one-process
               gradient), and Adam's mu, within 3x what the one-process step
               moves by when repeated or run on the batch with its halves
               swapped (floors 1e-4 of the loss, 1e-2 of the gradient, 1e-3
               of mu's norm), the scale of every top-level module's gradient
               whose direction that noise moves by at most 10% within 0.125,
               two planted faults (detr_loss summing only its counts over
               the ranks; rank 1's loss halved) failing those checks, the
               parameters (lr 0) by the rule above, the running statistics
               within 1e-5, the EMA within 1e-3
               (``MG_RT_*``), B4 and B5 six times a rank. A
               one-epoch ``fit`` of MoE-YOLO-s on 1 x 2 (``gmm``, two global
               steps of 16, each rank its strided shard) with
               ``make_ema_val_fn`` over 16 frames in two batches: both ranks'
               history (and ``fit_progress.json``) equal, B1 twice on rank 0
               and never on rank 1 (rank 0 evaluates the gathered EMA and
               broadcasts the metrics). Then ``dryrun_multichip(2)``
               through NCCL, which runs one rank (one card) and prints JAX's
               line.
21. remat   -- YOLO ``remat`` on the card: one MoE-YOLO-s B=16 fp32 step (TF32
               on) of scripts/train_moe.py's trainer on ``dispatch="gmm"`` with
               ``remat=False``, ``remat=True`` and ``remat=False`` again, the
               same weights, batch and draws, cuDNN deterministic: the peak
               memory (``torch.cuda.max_memory_allocated``) and step ms of
               each; the loss equal, every gradient outside the MoE levels
               bitwise equal, and each MoE level gradient within
               ``REMAT_GRAD_TOL`` of its norm, remat against no remat beside
               the repeat's (the expert biases' gradients add by
               ``index_add_`` in any order); peak memory lower with remat.
22. cli     -- the port's CLIs at 704x1248 on a corpus written as the
               ``data`` phase writes one, with split CSVs of its own (64
               train frames: an epoch is four steps of B=16; 32 val frames):
               (a) ``train_moe --resident --epochs 2 --max-epochs-this-run 1``
               as a child, then again with ``--resume``: the resident store
               the card's host takes (RGB where the native decoder cannot be
               built), ``fit_progress.json`` at epoch 1, every run-dir file,
               ``run_metadata.json`` naming the card, B1 once a validation
               batch; (b) ``train_rtdetr.main`` in this process, one epoch on
               the streaming store: B4 and B5 six times a step, B4 six times
               a validation batch, no B1; (c) ``eval_detector`` as a child on
               (a)'s run dir: B1 once a batch, ``metrics.json``'s keys the
               ``evaluate`` phase's plus the CLI's own; (d)
               ``quantize_yolo.main`` in this process on a YOLO-s run dir
               written as the ``evaluate`` phase writes one, then
               ``eval_detector --int8`` as a child reading that npz; (e)
               ``train_vision_baseline`` as a child on the train split
               (ResNet-50 at 256x256, B=32, two epochs): finite loss lines,
               the wall time, the plot written or skipped; (f)
               ``analyze_moe_routing`` as a child on (a)'s run dir over the
               val split (``--per-context 5``: every solar bin): both files
               written, a bin each, every load row summing to k=2. Children
               run their module as ``python -m`` does (``runpy``) and print
               their kernel counts at exit; each has a timeout; wall seconds
               per run.
23. ingest  -- the port's ingestion chain on this host, then the port's
               entry points on what it wrote, every step a child as in
               ``cli``: (a) ``build_synth_corpus --frames 160 --seed 49``
               at the protocol geometry (3848x2168 frames rendered at
               1924x1084, resized to 1248x704, 8 index workers): each
               stage's wall seconds and seconds a frame (render, index,
               boxes, solar bins, splits), the bytes on disk; the splits
               128 / 16 / 16, disjoint, covering every indexed frame, every
               frame's ``solar_context_bin`` the bin of its elevation;
               ``analyze_index_qa`` passing with no parallel-array or
               occlusion fault; ``analyze_context_frequencies`` (its plot
               written or skipped); (b) ``export_yolo_dataset`` and
               ``export_coco_dataset``: each frame's label lines the boxes
               the unclear policy keeps, as many COCO annotations, every
               image symlink resolving; (c) ``train_yolo --data-yaml`` on
               the YOLO export, one epoch (8 steps of B=16 at 704x1248,
               fp32), validating on its val split: a finite loss, every
               run-dir file, B1 once a validation batch; (d) ``train_moe``
               (MoE-YOLO-s, E=4, k=2, capacity factor 1.25, ``auto``) one
               epoch on the built parquet and splits: the same checks, and
               the solar ids that the child's training forwards hand the
               routers, counted over the epoch, those of the parquet's
               column on the train split; (e)
               ``eval_detector`` on (d)'s run over the test split: B1 once a
               batch, ``metrics.json``'s keys the ``cli`` phase's. Also
               whether sklearn, tqdm, matplotlib and tabulate import here.
24. tools   -- the port's last tools, after ``ingest``, on what ``cli`` and
               ``ingest`` wrote (one work directory for the three phases):
               (a) ``load_test_server`` as a child at its defaults (704x1248,
               fp32, B=16, pool 512, a 20 ms window) on random-weight YOLO-s
               and MoE-YOLO-s run dirs, ``--concurrency 1,16 --duration 3
               --raw`` each, then YOLO-s with JPEG bodies at 16 clients and
               with ``--int8`` (self-calibrating) at 16 raw clients: every
               level with 0 errors, completions and a mean batch fill in
               [1, 16]; B1 counted in each child, above 0 and at least the
               levels' device calls; (b) in this process on the ``ingest``
               corpus: ``sanity_dataloader`` (its three lines),
               ``report_detector_benchmarks`` over the eval dirs (a row for
               each eval run dir, the plots written or skipped),
               ``vis_boxes`` (``min(12, pool)`` annotated frames) and
               ``print_paths`` (a line a registered path), no kernel
               launched; whether nbformat and nbclient import here (the
               notebooks are not built); (c) ``train_vision_baseline``
               on two gloo ranks sharing the card (``chip_smoke.py
               --vision-rank DIR``, as ``multigpu`` launches its ranks;
               ResNet-50 at 256x256, 64 frames of the train split, 16 a
               rank, one epoch, TF32 off), its first step's loss, before
               the update, within 1e-4 relative of the one-process run's
               (``--batch 32``) on the same global batch, its gradient norm
               within the larger of 1e-4 and 5x the norm's noise when only
               the rows' order changes (the largest difference between the
               one-process steps in the CLI's order, the ranks' row order
               and its reverse); the control, the two halves each with its
               own BatchNorm statistics, must fail that.

"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import http.client
import io
import itertools
import json
import os
import queue
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from multimodal_moe_torch import _build, loading, quant  # noqa: E402
from multimodal_moe_torch import server as server_module  # noqa: E402
from multimodal_moe_torch._device import model_device  # noqa: E402
from multimodal_moe_torch.data import native_decode as data_native  # noqa: E402
from multimodal_moe_torch.data import pipeline as data_pipeline  # noqa: E402
from multimodal_moe_torch.data import resident as data_resident  # noqa: E402
from multimodal_moe_torch.losses import hungarian as hungarian_module  # noqa: E402
from multimodal_moe_torch.losses import tal as tal_module  # noqa: E402
from multimodal_moe_torch.models import layers as layers_module  # noqa: E402
from multimodal_moe_torch.models import moe as moe_module  # noqa: E402
from multimodal_moe_torch.models import rtdetr as rtdetr_module  # noqa: E402
from multimodal_moe_torch.models import yolo as yolo_module  # noqa: E402
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector, moe_yolo_loss  # noqa: E402
from multimodal_moe_torch.models.rtdetr import (  # noqa: E402
    RTDETRDetector,
    anchors_for,
    rtdetr_loss,
)
from multimodal_moe_torch.models.yolo import YoloDetector  # noqa: E402
from multimodal_moe_torch.ops import (  # noqa: E402
    coco_map,
    deformable_kernel,
    gmm_kernel,
    int8_conv,
    moe_kernels,
    moe_sweep,
    nms_kernel,
    preprocess,
)
from multimodal_moe_torch.ops.assignment import assignment_margin  # noqa: E402
from multimodal_moe_torch.ops.augment import augment_draws  # noqa: E402
from multimodal_moe_torch.ops.deformable import (  # noqa: E402
    level_shapes_to_offsets,
    ms_deform_attn_bwd_plain,
    ms_deform_attn_loc_attn_grads,
    ms_deformable_attention,
)
from multimodal_moe_torch.ops import nms as nms_module  # noqa: E402
from multimodal_moe_torch.ops.nms import (  # noqa: E402
    NEG_INF,
    _batched_nms_plain,
    _preselect,
    batched_nms,
)
from multimodal_moe_torch.ops.nms import stable_topk  # noqa: E402
from multimodal_moe_torch import serving as serving_module  # noqa: E402
from multimodal_moe_torch.server import BatchingDetector, DetectorHTTPServer  # noqa: E402
from multimodal_moe_torch.serving import (  # noqa: E402
    detr_topk_select,
    make_serving_step,
    yolo_serving_nms,
)
from multimodal_moe_torch.train import artifacts, evaluator  # noqa: E402
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig  # noqa: E402
from multimodal_moe_torch.train.state import CheckpointManager  # noqa: E402

IMG_H, IMG_W = 704, 1248
POOL, IOU, SCORE_THR, MAX_DET = 512, 0.7, 0.001, 300
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM bandwidth. The bound is stated against these.
PEAK_FP32_FLOPS = 67e12  # counts a multiply-add as two operations
PEAK_FP32_OPS = PEAK_FP32_FLOPS / 2  # single fp32 operations (no multiply-add)
PEAK_BF16_FLOPS = 989e12  # dense tensor cores
PEAK_TF32_FLOPS = 495e12  # dense tensor cores
PEAK_BYTES_PER_S = 3.35e12
IOU_FLOPS = 14  # min/max/sub/mul/add/div/compare per pair, areas amortised
KERNELS = ("nms_keep", "ms_deform_fwd", "ms_deform_bwd", "moe_ffn_fwd", "gmm", "moe_sweep_fwd")
# RT-DETR headline (bench.py: RT_B=16 at the protocol resolution).
RT_B, RT_QUERIES, RT_LAYERS = 16, 300, 6
RT_LEVELS = ((IMG_H // 8, IMG_W // 8), (IMG_H // 16, IMG_W // 16), (IMG_H // 32, IMG_W // 32))
RT_NH, RT_D, RT_P = 8, 32, 4
# Per sample point beyond the 4 corners' 2*D multiply-adds: geometry,
# bilinear weights and bounds tests.
DEFORM_POINT_FLOPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def tf32_state() -> dict:
    return {
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def results_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def bitwise_equal(a, b) -> bool:
    """Equal bits, field by field (NaN boxes gathered from one input agree)."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) if x.dtype == torch.float32
               else torch.equal(x, y) for x, y in zip(a, b))


def max_abs(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(a, b))


def nms_bound(valid: torch.Tensor, classes: "torch.Tensor | None" = None):
    """Least time for the keep mask of ``valid`` (B, K): every input byte
    read once, the mask written once, and for each pair j > i of valid
    candidates the IoU's 14 single fp32 operations (no multiply-add) at half
    the fp32 peak. With ``classes`` (class-aware NMS) a pair of different
    classes needs one compare instead (its IoU is 0). The greedy walk's
    K-step serial chain is not in it."""
    b, k = valid.shape
    n = valid.sum(dim=1, dtype=torch.float64)
    pairs = float((n * (n - 1) / 2).sum())
    same = pairs
    if classes is not None:
        image = torch.arange(b, device=valid.device, dtype=torch.int64)[:, None]
        key = image * 2**33 + (classes.long() - int(classes.min()))
        counts = torch.unique(key[valid.bool()], return_counts=True)[1].double()
        same = float((counts * (counts - 1) / 2).sum())
    nbytes = b * k * (16 + 4 + 4) + b * k * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (same * IOU_FLOPS + (pairs - same)) / PEAK_FP32_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device milliseconds of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so the host's time
    to launch is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def device_rows(prof) -> list:
    """(name, ms on the card, calls) of each device op in a profile, the
    longest first."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def synthetic_candidates(b, n, num_classes, seed, dev, kind="synthetic"):
    """Candidates for the NMS phase. ``synthetic``: random boxes, many score
    ties, repeated boxes, a pair at IoU exactly 0.7 in image 1 and an
    all-invalid image 0. The other kinds: ``identical`` (every box of an
    image the same: each later candidate is removed), ``disjoint`` (no two
    boxes touch: none is), ``at_threshold`` (pairs at IoU exactly 0.7 at
    scales 0.5 to 1000), ``non_finite`` (NaN, +-inf and 1e30 coordinates)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (b, n, 2))
    wh = rng.uniform(5, 120, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (rng.integers(1, 40, (b, n)) / 40.0).astype(np.float32)  # many ties
    classes = rng.integers(0, num_classes, (b, n)).astype(np.int32)
    if kind == "synthetic":
        boxes[:, 1::7] = boxes[:, 0:1]                                 # repeated boxes
        if b > 1:
            # IoU([0,0,10,10],[0,0,10,7]) is exactly 0.7: suppressed at IoU >= 0.7.
            boxes[1, :4] = [[0, 0, 10, 10], [0, 0, 10, 7], [0, 0, 10, 10], [0, 0, 7, 10]]
            scores[1, :4] = [0.99, 0.98, 0.98, 0.97]
            scores[0] = 0.0                                            # all invalid
            classes[1, :4] = 0
    elif kind == "identical":
        boxes[:] = boxes[:, :1]
    elif kind == "disjoint":
        idx = np.arange(n)
        grid = np.stack([(idx % 64) * 20.0, (idx // 64) * 20.0], -1)
        boxes[:] = np.concatenate([grid, grid + 10.0], -1)
    elif kind == "at_threshold":
        # [x, y, x+s, y+s] against [x, y, x+s, y+0.7s]: IoU 0.7s^2 / (s^2 + 1e-7)
        # rounds to float32(0.7) exactly for these scales and offsets.
        for m in range(min(n // 2, 64)):
            s = (5.0, 10.0, 100.0, 1000.0)[m % 4]
            x0 = 2048.0 * (m + 1)
            boxes[:, 2 * m] = [x0, 0, x0 + s, s]
            boxes[:, 2 * m + 1] = [x0, 0, x0 + s, 0.7 * s]
            scores[:, 2 * m], scores[:, 2 * m + 1] = 0.9, 0.8
            classes[:, 2 * m + 1] = classes[:, 2 * m]
    elif kind == "non_finite":
        values = np.array([np.nan, np.inf, -np.inf, 1e30], np.float32)
        bad = rng.random(boxes.shape) < 0.15
        boxes = np.where(bad, values[rng.integers(0, 4, boxes.shape)], boxes).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(boxes), t(scores), t(classes)


# YOLO-s's anchors at 704x1248 (88x156 + 44x78 + 22x39): the largest pool
# JAX's batched_nms takes on the headline's forward.
HEADLINE_ANCHORS = sum((IMG_H // s) * (IMG_W // s) for s in (8, 16, 32))


def headline_candidates(b: int, dev):
    """Boxes and scores of the headline's model (YOLO-s bf16, seed 0) on
    ``b`` seeded images, and class 0 for every anchor."""
    model = build_model(torch.bfloat16, dev)
    with torch.inference_mode():
        out = model(random_images(b, seed=2, dev=dev).float() / 255.0)
        scores = torch.sigmoid(out["cls_logits"][..., 0])
    zeros = torch.zeros(scores.shape, dtype=torch.int32, device=dev)
    return out["boxes"].clone(), scores.clone(), zeros


# (name, B, K, classes, class_agnostic, kind, iou_threshold)
NMS_CASES = (
    ("B128_K512", 128, 512, 1, True, "synthetic", IOU),
    ("B16_K1024_3cls", 16, 1024, 3, False, "synthetic", IOU),
    ("B128_K1024_3cls", 128, 1024, 3, False, "synthetic", IOU),
    ("B4_K300", 4, 300, 3, False, "synthetic", IOU),
    ("B4_K1000", 4, 1000, 3, False, "synthetic", IOU),
    ("B1_K512", 1, 512, 1, True, "synthetic", IOU),
    ("identical", 8, 512, 1, True, "identical", IOU),
    ("disjoint", 8, 512, 1, True, "disjoint", IOU),
    ("at_threshold", 8, 512, 2, False, "at_threshold", IOU),
    ("non_finite", 8, 512, 3, False, "non_finite", IOU),
    ("threshold_0", 8, 512, 3, False, "synthetic", 0.0),
    ("threshold_1", 8, 512, 1, True, "synthetic", 1.0),
    # Above the shared-memory walk's K = 1024: the kernel's other two launches.
    ("B16_K1025_3cls", 16, 1025, 3, False, "synthetic", IOU),
    ("B16_K2048_3cls", 16, 2048, 3, False, "synthetic", IOU),
    ("B16_K4096_3cls", 16, 4096, 3, False, "synthetic", IOU),
    ("B2_K18018_headline", 2, HEADLINE_ANCHORS, 1, False, "headline", IOU),
)


# The cases whose plain version, launches and build without the margin
# filter are timed too.
NMS_TIMED = ("B128_K512", "B16_K1024_3cls", "B128_K1024_3cls", "B16_K1025_3cls",
             "B16_K2048_3cls", "B16_K4096_3cls", "B2_K18018_headline")
# The second build of csrc/nms_keep.cu: the margin filter left out, the exact
# zero-intersection shortcut kept. Only timed and checked against the first.
NMS_NO_FILTER = ("NMS_MARGIN_FILTER=0",)


def nms_ctas(b: int) -> int:
    return nms_kernel.ctas_per_image(b, torch.cuda.get_device_properties(0).multi_processor_count)


def nms_keep_args(boxes, scores, classes, k):
    top_boxes, top_scores, top_classes = _preselect(
        boxes, scores, classes, score_threshold=SCORE_THR, num_candidates=k)
    return (top_boxes.contiguous(), (top_scores > NEG_INF / 2).to(torch.int32),
            top_classes.contiguous())


def nms_times(args, keep_kw) -> dict:
    """The keep-mask wrapper's time called eagerly (``kernel_ms``, the host's
    launch included, as every kernel of the port is timed) and its device
    time (``device_ms``, a CUDA graph of 20 calls)."""
    call = lambda: nms_kernel.nms_keep_mask(*args, **keep_kw)  # noqa: E731
    return {"kernel_ms": cuda_ms(call, reps=50, warmup=3), "device_ms": graph_ms(call)}


def nms_no_filter(args, keep_kw, keep, timed: bool) -> dict:
    """The build without the margin filter on the same inputs: its keep mask
    must equal ``keep``; with ``timed``, its device time beside the default
    build's (no launch count: a comparison, not the path)."""
    lib = nms_kernel._lib(NMS_NO_FILTER)
    call = lambda: nms_kernel._launch(lib, *args, keep_kw["iou_threshold"],  # noqa: E731
                                      keep_kw["class_agnostic"])
    check(torch.equal(call(), keep), "keep mask without the margin filter")
    return {"no_filter_device_ms": graph_ms(call)} if timed else {}


def phase_kernel(dev) -> dict:
    report = {}
    for name, b, k, ncls, agnostic, kind, iou in NMS_CASES:
        if kind == "headline":
            boxes, scores, classes = headline_candidates(b, dev)
        else:
            boxes, scores, classes = synthetic_candidates(b, 2 * k, ncls, seed=k, dev=dev,
                                                          kind=kind)
        kw = dict(iou_threshold=iou, score_threshold=SCORE_THR, max_det=MAX_DET,
                  num_candidates=k, class_agnostic=agnostic)
        args = nms_keep_args(boxes, scores, classes, k)
        keep_kw = dict(iou_threshold=iou, class_agnostic=agnostic)
        keep = nms_kernel.nms_keep_mask(*args, **keep_kw)
        keep_plain = nms_kernel._nms_keep_mask_plain(*args, **keep_kw)
        got = batched_nms(boxes, scores, classes, **kw)
        ref = _batched_nms_plain(boxes, scores, classes, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, keep_plain), f"keep mask {name}")
        check(bitwise_equal(got, ref), f"NmsResult {name}")
        if kind == "synthetic" and b > 1:
            check(not bool(got.valid[0].any()), "all-invalid image kept nothing")
        if kind == "synthetic" and b > 1 and iou == IOU:
            check(got.valid[1, :2].tolist() == [True, True] and int(keep[1, 1]) == 0,
                  "IoU exactly at the threshold suppresses")
        if kind == "identical":
            check(bool((keep.sum(dim=1) <= ncls).all()), "identical boxes: one kept a class")
        if kind == "disjoint":
            check(torch.equal(keep, args[1]), "disjoint boxes: every valid one kept")
        if kind == "at_threshold":
            x1, y1, x2, y2 = args[0].unbind(-1)
            paired = (x1 >= 2048) & (args[1] == 1)
            short = paired & (y2 - y1 < x2 - x1)
            check(bool(short.any()) and not bool(keep.bool()[short].any())
                  and bool(keep.bool()[paired & ~short].all()),
                  "pairs at IoU exactly 0.7: the second of each removed, the first kept")
        report[name] = {
            "B": b, "K": k, "classes": ncls, "class_agnostic": agnostic, "kind": kind,
            "iou_threshold": iou, "ctas_per_image": nms_ctas(b),
            "kept": int(keep.sum()), "valid_out": int(got.valid.sum()),
            "max_abs_err": float((keep - keep_plain).abs().max()),
            **nms_times(args, keep_kw),
            "bound_ms": nms_bound(args[1], None if agnostic else args[2])[0],
            **nms_no_filter(args, keep_kw, keep, timed=name in NMS_TIMED),
        }
        if name in NMS_TIMED:
            reps = 2 if k <= 1024 else 1
            report[name]["plain_ms"] = cuda_ms(
                lambda: nms_kernel._nms_keep_mask_plain(*args, **keep_kw), reps=reps, warmup=1)
            report[name]["launch_split_ms"] = nms_launch_split(
                lambda: nms_kernel.nms_keep_mask(*args, **keep_kw))
    return {"phase": "nms_keep", "cases": report, **tf32_state()}


def build_model(dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = YoloDetector(num_classes=1, variant="s", dtype=dtype, arch="tpu", generator=gen)
    return model.eval().to(dev).to(memory_format=torch.channels_last)


def random_images(b, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (b, IMG_H, IMG_W, 3), generator=gen, device=dev,
                         dtype=torch.uint8)


def phase_fp32(dev) -> dict:
    model = build_model(torch.float32, dev)
    nms_kw = dict(iou_threshold=IOU, score_threshold=SCORE_THR, max_det=MAX_DET)
    images = random_images(8, seed=1, dev=dev)
    before = nms_kernel.nms_keep_launches
    full = make_serving_step(model, pool=POOL, tail="full", **nms_kw)(images)
    topk = make_serving_step(model, pool=POOL, tail="topk", **nms_kw)(images)
    torch.cuda.synchronize()
    check(nms_kernel.nms_keep_launches > before, "serving step launched the kernel")
    check(results_equal(full, topk), "full and topk tails bitwise (fp32 B=8)")
    with torch.inference_mode():
        out = model(images.float() / 255.0)
        scores = torch.sigmoid(out["cls_logits"][..., 0])
        zeros = torch.zeros(scores.shape, dtype=torch.int32, device=dev)
        kern = batched_nms(out["boxes"], scores, num_candidates=POOL, **nms_kw)
        plain = _batched_nms_plain(out["boxes"], scores, zeros, num_candidates=POOL,
                                   class_agnostic=False, **nms_kw)
        topk_same = yolo_serving_nms(out, k=POOL, **nms_kw)
    check(results_equal(kern, plain), "kernel tail == plain tail on one forward")
    check(results_equal(kern, topk_same), "full == topk tail on one forward")
    check(results_equal(kern, full), "serving step == tail on a repeated forward")
    check(all(bool(torch.isfinite(t).all()) for t in full[:2]), "finite outputs")
    check(tuple(full.boxes.shape) == (images.shape[0], MAX_DET, 4), "NmsResult shape")

    # Card against CPU: the same weights, one image.
    cpu_model = copy.deepcopy(model).cpu()
    img1 = images[:1]
    with torch.inference_mode():
        on_card = {k: v.cpu() for k, v in model(img1.float() / 255.0).items()}
        on_cpu = cpu_model(img1.cpu().float() / 255.0)
    errs = {}
    for k in ("box_logits", "cls_logits"):
        d = (on_card[k] - on_cpu[k]).abs()
        errs[k] = float(d.max())
        check(bool((d <= 1e-4 + 1e-3 * on_cpu[k].abs()).all()), f"card vs CPU {k}")
    errs["boxes_px"] = float((on_card["boxes"] - on_cpu["boxes"]).abs().max())
    return {
        "phase": "serving_fp32", "batch": 8, "tails_bitwise": True,
        "plain_tail_equal": True, "valid_out": int(full.valid.sum()),
        "card_vs_cpu_max_abs": errs, "tolerance": "|d| <= 1e-4 + 1e-3*|cpu|",
        **tf32_state(),
    }


def phase_headline(dev, smi: str):
    b = 128
    model = build_model(torch.bfloat16, dev)
    nms_kw = dict(iou_threshold=IOU, score_threshold=SCORE_THR, max_det=MAX_DET)
    step = make_serving_step(model, pool=POOL, tail="full", **nms_kw)
    images = random_images(b, seed=2, dev=dev)

    def forward():
        with torch.inference_mode():
            return model(images.float() / 255.0)

    with torch.inference_mode():
        out = forward()
        scores = torch.sigmoid(out["cls_logits"][..., 0])

    def tail():
        with torch.inference_mode():
            return batched_nms(out["boxes"], scores, num_candidates=POOL, **nms_kw)

    # The main path: launch counts from zero over the serving run alone.
    nms_kernel.nms_keep_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: step(images), reps=5)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = nms_kernel.nms_keep_launches
    check(launches > 0, "headline serving launched nms_keep")
    res = step(images)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in res[:2]), "finite bf16 outputs")
    check(tuple(res.boxes.shape) == (images.shape[0], MAX_DET, 4), "bf16 NmsResult shape")

    forward_ms = cuda_ms(forward, reps=5)
    tail_ms = cuda_ms(tail, reps=10)
    with torch.inference_mode():
        tail_split = nms_tail_split(out["boxes"], scores, reps=10)

    # The kernel on the main path's own candidates, against its plain version.
    zeros = torch.zeros(scores.shape, dtype=torch.int32, device=dev)
    args = nms_keep_args(out["boxes"], scores, zeros, POOL)
    kw = dict(iou_threshold=IOU, class_agnostic=False)
    keep = nms_kernel.nms_keep_mask(*args, **kw)
    keep_plain = nms_kernel._nms_keep_mask_plain(*args, **kw)
    with torch.inference_mode():
        plain_tail = _batched_nms_plain(out["boxes"], scores, zeros, num_candidates=POOL,
                                        class_agnostic=False, **nms_kw)
    torch.cuda.synchronize()
    check(torch.equal(keep, keep_plain), "keep mask on the headline candidates")
    check(results_equal(tail(), plain_tail), "headline kernel tail == plain tail")
    times = nms_times(args, kw)
    plain_ms = cuda_ms(lambda: nms_kernel._nms_keep_mask_plain(*args, **kw), reps=3, warmup=1)
    bound_ms, bound_by = nms_bound(args[1], args[2])
    err = max(float((keep - keep_plain).abs().max()), max_abs(tail(), plain_tail))

    # The evaluator's pool (K=1024) on the same forward.
    args_1024 = nms_keep_args(out["boxes"], scores, zeros, 1024)
    keep_1024 = nms_kernel.nms_keep_mask(*args_1024, **kw)
    check(torch.equal(keep_1024, nms_kernel._nms_keep_mask_plain(*args_1024, **kw)),
          "keep mask on the headline forward at K=1024")

    serving = {
        "phase": "serving_headline", "model": "yolo-s arch=tpu", "dtype": "bfloat16",
        "batch": b, "img_hw": [IMG_H, IMG_W], "pool": POOL, "max_det": MAX_DET,
        "tail": "full", "step_ms": step_ms, "forward_ms": forward_ms, "nms_tail_ms": tail_ms,
        "nms_tail_split_ms": tail_split,
        "img_per_s": b * 1000.0 / step_ms, "peak_mem_gib": peak_gib,
        "valid_out": int(res.valid.sum()), "kept_in_pool": int(keep.sum()),
        "gpu": smi, **tf32_state(),
    }
    kernel = {
        "name": "nms_keep", "route": "cuda",
        "source": "multimodal_moe_torch/csrc/nms_keep.cu",
        "replaces": "multimodal_moe_tpu/ops/nms_pallas.py:40 (_nms_keep_kernel)",
        "shape": {"B": b, "K": POOL}, "ctas_per_image": nms_ctas(b),
        "launches": launches, "max_abs_err": err,
        "ms": times["kernel_ms"], **times, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "launch_split_ms": nms_launch_split(lambda: nms_kernel.nms_keep_mask(*args, **kw)),
        **nms_no_filter(args, kw, keep, timed=True),
        **{f"k1024_{key}": ms for key, ms in nms_times(args_1024, kw).items()},
        "k1024_bound_ms": nms_bound(args_1024[1], args_1024[2])[0],
        "k1024_launch_split_ms": nms_launch_split(
            lambda: nms_kernel.nms_keep_mask(*args_1024, **kw)),
    }
    return serving, kernel


# --------------------------------------------------------------------------
# the evaluation path: a run dir loaded, evaluated, written out
# --------------------------------------------------------------------------

EVAL_B, EVAL_BATCHES, EVAL_POOL = 16, 4, 1024   # evaluator.make_inference_step's pool
EVAL_FAMILIES = (
    {"family": "yolo", "variant": "s"},
    {"family": "moe", "variant": "s", "num_experts": 4},
    {"family": "rtdetr", "hidden_dim": 256, "num_queries": RT_QUERIES,
     "num_decoder_layers": RT_LAYERS},
)


def write_run_dir(root: Path, cfg: dict, seed: int = 0) -> Path:
    """A run dir of the port: ``model_config.json`` and ``weights/best``,
    random weights from ``seed`` saved by ``CheckpointManager``."""
    run = root / cfg["family"]
    run.mkdir(parents=True)
    (run / "model_config.json").write_text(json.dumps(cfg))
    torch.manual_seed(seed)
    _, template = loading.build_detector(cfg)
    trainer = DetectionTrainer(template, DetTrainConfig(variant=cfg.get("variant", "s")),
                               steps_per_epoch=1, device="cpu")
    CheckpointManager(run / "weights").save_best(trainer.init_state())
    return run


def eval_batches(n: int, b: int, seed: int) -> list:
    """``n`` seeded host batches of ``b`` uint8 frames at 704x1248, a solar
    bin a frame; batch 1 has two padded rows (``batch_valid`` false) and
    batch 2 comes as YUV420 planes, as the ``store="yuv420"`` loader gives
    them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        batch = {"batch_valid": np.ones(b, bool),
                 "solar_bin": rng.integers(0, moe_module.NUM_SOLAR_BINS, b).astype(np.int32)}
        if i == 2:
            batch.update(y=rng.integers(0, 256, (b, IMG_H, IMG_W), dtype=np.uint8),
                         cb=rng.integers(0, 256, (b, IMG_H // 2, IMG_W // 2), dtype=np.uint8),
                         cr=rng.integers(0, 256, (b, IMG_H // 2, IMG_W // 2), dtype=np.uint8))
        else:
            batch["image"] = rng.integers(0, 256, (b, IMG_H, IMG_W, 3), dtype=np.uint8)
        if i == 1 and b > 2:
            batch["batch_valid"][-2:] = False
        out.append(batch)
    return out


def host_rgb(batch: dict) -> np.ndarray:
    """The batch's frames as uint8 RGB, converted on the CPU where it is YUV."""
    if "y" not in batch:
        return batch["image"]
    planes = (torch.from_numpy(batch[k]) for k in ("y", "cb", "cr"))
    return preprocess.yuv420_to_rgb_u8(*planes).numpy()


def plant_ground_truth(batches, detect, seed: int) -> None:
    """Ground truth from a first pass's kept boxes: ranks 0, 2 and 5 of each
    image jittered by ~2 px, one box nothing detects, one padded slot; so
    mAP50 lies strictly between 0 and 1."""
    rng = np.random.default_rng(seed)
    for batch in batches:
        res = detect(batch)
        b = len(res.valid)
        gt = np.zeros((b, 5, 4), np.float32)
        mask = np.zeros((b, 5), bool)
        for i in range(b):
            kept = res.boxes[i][res.valid[i]].cpu().numpy()[[0, 2, 5]]
            gt[i, :3] = kept + rng.normal(0, 2.0, kept.shape)
            gt[i, 3] = [40.0, 40.0, 140.0, 90.0]
            mask[i, :4] = True
        batch.update(gt_boxes=gt, gt_mask=mask)


def coco_of(batches, results) -> dict:
    """``coco_map.evaluate_detections`` on recorded results, as
    ``evaluate_detector`` gathers them."""
    det_boxes, det_scores, gts = [], [], []
    for batch, res in zip(batches, results):
        for i in range(len(res.valid)):
            if not batch["batch_valid"][i]:
                continue
            keep = res.valid[i].cpu().numpy()
            det_boxes.append(res.boxes[i].cpu().numpy()[keep])
            det_scores.append(res.scores[i].cpu().numpy()[keep])
            gts.append(batch["gt_boxes"][i][batch["gt_mask"][i]])
    return coco_map.evaluate_detections(det_boxes, det_scores, gts).to_metrics_dict()


def evaluate_recorded(loaded, batches, use_nms: bool):
    """``evaluate_detector`` over ``batches`` with ``make_inference_step``
    (pool 1024) on the loaded variables, recording each batch's images on
    the card, the forward's (boxes, scores) and the tail's result. The
    launch counts start at 0 here."""
    step = evaluator.make_inference_step(loaded.model, num_candidates=EVAL_POOL)
    seen, results = [], []

    def infer(images, context_ids=None):
        boxes, scores = step(loaded.variables, images, context_ids)
        seen.append((images.clone(), boxes.clone(), scores.clone()))
        return boxes, scores

    def recording(real):
        def tail(*args, **kwargs):
            res = real(*args, **kwargs)
            results.append(res)
            return res
        return tail

    tail_name = "batched_nms" if use_nms else "detr_topk_select"
    nms_kernel.nms_keep_launches = 0
    deformable_kernel.ms_deform_fwd_launches = 0
    with patched(evaluator, tail_name, recording):
        metrics = evaluator.evaluate_detector(iter(batches), infer, use_nms=use_nms,
                                              device=model_device(loaded.model))
    launches = {"nms_keep": nms_kernel.nms_keep_launches,
                "ms_deform_fwd": deformable_kernel.ms_deform_fwd_launches}
    return metrics, seen, results, launches


def check_evaluation(name, batches, metrics, seen, results, use_nms: bool) -> None:
    """Each batch's tail bitwise equal to the plain tail on the same forward
    outputs moved to the CPU, YUV frames to the CPU conversion, and the
    metrics to ``coco_map`` on the recorded results."""
    check(len(seen) == len(results) == len(batches), f"{name}: one tail a batch")
    for n, (batch, (images, boxes, scores), res) in enumerate(zip(batches, seen, results)):
        boxes, scores = boxes.cpu(), scores.cpu()
        if use_nms:
            zeros = torch.zeros(scores.shape, dtype=torch.int32)
            plain = _batched_nms_plain(
                boxes, scores, zeros, iou_threshold=IOU, score_threshold=SCORE_THR,
                max_det=MAX_DET, num_candidates=EVAL_POOL, class_agnostic=False)
        else:
            plain = detr_topk_select(boxes, scores, max_det=MAX_DET, score_threshold=SCORE_THR)
        check(bitwise_equal(tuple(t.cpu() for t in res), plain),
              f"{name}: batch {n}'s tail == plain tail on the CPU")
        if "y" in batch:
            check(torch.equal(images.cpu(), torch.from_numpy(host_rgb(batch))),
                  f"{name}: YUV batch == CPU yuv420_to_rgb_u8")
    ref = coco_of(batches, results)
    got = {k: v for k, v in metrics.items() if not k.startswith("speed_") and k != "n_images"}
    check(got == ref, f"{name}: metrics == coco_map.evaluate_detections on the results")
    check(0.0 < metrics["map50"] < 1.0, f"{name}: mAP50 strictly between 0 and 1")
    check(metrics["n_images"] == sum(int(b["batch_valid"].sum()) for b in batches),
          f"{name}: padded rows not scored")


def phase_evaluate(dev, smi: str) -> dict:
    """The evaluation path: a YOLO-s run dir written, loaded onto the card
    and evaluated over four batches of 16 (pool 1024, B1 once a batch; one
    batch with padded rows, one as YUV420 planes), then one batch each of
    MoE-YOLO-s (``auto``, solar bins) and RT-DETR r50vd (``use_nms=False``,
    B4 six times), and the metrics and the runtime written out."""
    t0 = time.perf_counter()
    rec = {"phase": "evaluate", "img_hw": [IMG_H, IMG_W], "batch": EVAL_B, "pool": EVAL_POOL,
           "iou_threshold": IOU, "score_threshold": SCORE_THR, "max_det": MAX_DET,
           "models": {}, "gpu": smi, **tf32_state()}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for cfg in EVAL_FAMILIES:
            family = cfg["family"]
            t_load = time.perf_counter()
            loaded = loading.load_detector(write_run_dir(root / "runs", cfg), device=dev)
            check(next(loaded.model.parameters()).device.type == "cuda", f"{family} on the card")
            load_s = time.perf_counter() - t_load
            n = EVAL_BATCHES if family == "yolo" else 1
            batches = eval_batches(n, EVAL_B, seed=len(rec["models"]) + 20)
            if family != "moe":
                for batch in batches:
                    del batch["solar_bin"]
            use_nms = family != "rtdetr"
            infer = evaluator.make_inference_fn(loaded.model, loaded.variables)

            def first_pass(batch):
                ctx = batch.get("solar_bin")
                boxes, scores = infer(host_rgb(batch), ctx)
                with torch.inference_mode():
                    return (batched_nms(boxes, scores) if use_nms else
                            detr_topk_select(boxes, scores, max_det=MAX_DET))

            plant_ground_truth(batches, first_pass, seed=5)
            metrics, seen, results, launches = evaluate_recorded(loaded, batches, use_nms)
            torch.cuda.synchronize()
            check_evaluation(family, batches, metrics, seen, results, use_nms)
            want = {"nms_keep": n if use_nms else 0,
                    "ms_deform_fwd": RT_LAYERS * n if family == "rtdetr" else 0}
            check(launches == want, f"{family}: launches {launches}, expected {want}")
            rec["models"][family] = {
                "config": cfg, "batches": n, "load_s": load_s, "launches": launches,
                "metrics": {k: v for k, v in metrics.items() if k != "curves_results"},
                "model_flops_g": evaluator.model_flops_g(loaded.model, IMG_H, IMG_W),
            }
            del loaded, infer, seen, results
            torch.cuda.empty_cache()
        metrics_path = artifacts.save_metrics_json(rec["models"]["yolo"]["metrics"],
                                                   root / "eval" / "metrics.json")
        runtime = artifacts.collect_runtime_info()
        meta_json, meta_csv = artifacts.save_run_metadata_artifacts(
            {"family": "yolo", "variant": "s", "img_h": IMG_H, "img_w": IMG_W, **runtime},
            root / "eval" / "run_metadata.json", root / "eval" / "run_metadata.csv")
        check(json.loads(metrics_path.read_text()) == rec["models"]["yolo"]["metrics"],
              "metrics.json round trip")
        check(json.loads(meta_json.read_text())["device_kind"] == runtime["device_kind"]
              and meta_csv.read_text().startswith("metric,value"), "run_metadata written")
    check(runtime["device_kind"] == torch.cuda.get_device_name(0) and runtime["device_count"] >= 1,
          "runtime info names the card")
    check(rec["models"]["yolo"]["model_flops_g"] is not None, "model_flops_g counted")
    rec["runtime_info"] = runtime
    rec["seconds"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------------------
# the serving deployment: BatchingDetector behind HTTP, the CLIs
# --------------------------------------------------------------------------

SERVER_B, SERVER_WAIT_MS = 16, 20.0     # scripts/serve_detector.py's defaults
# (raw bodies, concurrent clients, seconds measured after the ramp); no
# JPEG level at 1 client: the host's decode shows at 16 and 64
SERVER_LEVELS = ((True, 1, 3.0), (True, 16, 5.0), (False, 16, 5.0),
                 (True, 64, 6.0), (False, 64, 6.0))
SERVER_RAMP_S = 1.0                     # a level's first second, not counted
SERVER_PROFILE_S = 3.0                  # the profiled 64-client raw window
P99_MIN = 100                           # p99 from this many latencies on
SERVER_IMAGES = 20                      # the predict CLI's JPEGs
CLI_WAIT_S = 300                        # a child's start, or its run, at most
# torch's own TF32 defaults, which the CLIs leave as they are
TORCH_DEFAULT_TF32 = {"cudnn": True, "matmul": False}


@contextlib.contextmanager
def http_server(det):
    """``det`` behind a ``DetectorHTTPServer`` on a free local port."""
    httpd = DetectorHTTPServer(("127.0.0.1", 0), det)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def http_post(port: int, body: bytes, query: str = "", raw: bool = True, conn=None) -> dict:
    """POST ``body`` to ``/predict?query``; the JSON answer (status 200)."""
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=CLI_WAIT_S)
    try:
        headers = {"Content-Type": "application/x-mmoe-raw"} if raw else {}
        conn.request("POST", f"/predict{'?' + query if query else ''}", body=body,
                     headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"POST /predict answered {resp.status}: {data[:200]!r}")
        return json.loads(data)
    finally:
        if own:
            conn.close()


def http_get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        check(resp.status == 200, f"GET {url} answered {resp.status}")
        return json.loads(resp.read())


def server_images(n: int, seed: int) -> list:
    """``n`` seeded uint8 frames at the model's size."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (IMG_H, IMG_W, 3), dtype=np.uint8) for _ in range(n)]


def smooth_jpegs(n: int, seed: int, sizes=None) -> list:
    """``n`` seeded JPEG files' bytes (quality 90): coarse noise blown up
    bilinearly, so they compress as photographs do; at the model's size or
    at ``sizes`` (width, height)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w, h = sizes[i] if sizes else (IMG_W, IMG_H)
        small = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def expected_detections(res, row: int, conf: float) -> list:
    """What ``BatchingDetector._run`` answers for ``row`` of a step's
    ``NmsResult`` for a frame at the model's size (2 and 4 decimals)."""
    boxes, scores, valid = (t[row].cpu().numpy() for t in (res.boxes, res.scores, res.valid))
    keep = valid & (scores >= conf)
    xyxy = boxes[keep].astype(np.float64)
    xyxy[:, 0::2] = xyxy[:, 0::2].clip(0, IMG_W)
    xyxy[:, 1::2] = xyxy[:, 1::2].clip(0, IMG_H)
    return [{"xyxy": [round(float(v), 2) for v in b], "score": round(float(s), 4)}
            for b, s in zip(xyxy, scores[keep])]


def recorded_step(det, images, ctx=None):
    """``det``'s serving step on the zero-padded batch of ``images``,
    recording the forward's (boxes, scores) that reach the tail."""
    batch = np.zeros((SERVER_B, IMG_H, IMG_W, 3), np.uint8)
    batch[: len(images)] = images
    ids = np.zeros((SERVER_B,), np.int32)
    if ctx is not None:
        ids[: len(ctx)] = ctx
    seen = []

    def recording(real):
        def tail(boxes, scores, *args, **kwargs):
            seen.append((boxes.clone(), scores.clone()))
            return real(boxes, scores, *args, **kwargs)
        return tail

    with patched(serving_module, "batched_nms", recording), \
            patched(serving_module, "detr_topk_select", recording):
        res = det._step(batch, ids)
    check(len(seen) == 1, "one tail a step")
    return res, seen[0]


def check_tail_on_cpu(name: str, res, forward, detr: bool) -> None:
    """The step's tail bitwise equal to the plain tail on the CPU on the
    same forward outputs (as the ``evaluate`` phase holds it)."""
    boxes, scores = (t.cpu() for t in forward)
    if detr:
        plain = detr_topk_select(boxes, scores, max_det=MAX_DET, score_threshold=SCORE_THR)
    else:
        zeros = torch.zeros(scores.shape, dtype=torch.int32)
        plain = _batched_nms_plain(boxes, scores, zeros, iou_threshold=IOU,
                                   score_threshold=SCORE_THR, max_det=MAX_DET,
                                   num_candidates=POOL, class_agnostic=False)
    check(bitwise_equal(tuple(t.cpu() for t in res), plain),
          f"{name}: the raw step's tail == the plain tail on the CPU")


def start_child(args: list) -> "tuple[subprocess.Popen, queue.Queue]":
    """``python -m multimodal_moe_torch.cli.<args>`` from the checkout, its
    output lines into a queue."""
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[str]" = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put("")   # end of output

    threading.Thread(target=read, daemon=True).start()
    return proc, lines


def child_url(proc, lines, what: str) -> str:
    """The URL of a serving child's ``[serve] listening on`` line."""
    deadline = time.monotonic() + CLI_WAIT_S
    seen = []
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
        except queue.Empty:
            break
        seen.append(line)
        if "listening on" in line:
            return line.split("listening on ")[1].split()[0]
        if line == "" and proc.poll() is not None:
            break
    raise RuntimeError(f"chip_smoke check failed: {what} did not listen: {''.join(seen)[-3000:]}")


def stop_child(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def kernel_libraries() -> dict:
    """The kernels' built libraries and their modification times."""
    return {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")
            if not p.name.startswith("libmmoe_jpeg")}


@contextlib.contextmanager
def collector_clock(det):
    """Host-clock marks of each ``_run`` of ``det``'s collector thread: its
    start, its step's start and its end (the answers set)."""
    marks, step_at = [], []
    run, step = det._run, det._step

    def timed_step(*args, **kwargs):
        step_at.append(time.perf_counter())
        return step(*args, **kwargs)

    def timed_run(group):
        t0 = time.perf_counter()
        run(group)
        marks.append((t0, step_at.pop() if step_at else t0, time.perf_counter()))

    det._run, det._step = timed_run, timed_step
    try:
        yield marks
    finally:
        det._run, det._step = run, step


def device_busy(prof, top: int = 6) -> dict:
    """The kernels' and copies' time on the card in a profiler window (one
    stream: their sum is the card's busy time), and the ``top`` of them."""
    rows = device_rows(prof)
    return {"busy_ms": sum(ms for _, ms, _ in rows),
            "top": [{"op": k[:70], "ms": ms, "calls": n} for k, ms, n in rows[:top]]}


def load_level(det, port: int, bodies: list, raw: bool, clients: int, seconds: float,
               profile: bool = False) -> dict:
    """Closed-loop load: ``clients`` keep-alive connections, each sending
    its next request when the last is answered, for ``SERVER_RAMP_S`` (not
    counted) and then a window of ``seconds``, after which the clients send
    nothing more and wait for their answers. req/s counts the answers inside
    the window; p50 and p99 are over the requests sent inside it (p99 only
    from ``P99_MIN`` of them on); the batch fill and the collector's split
    are over the device calls that start inside it. Any request that fails
    fails the phase. The connections are opened one after another before
    the clock starts (the server's listen backlog is the standard library's
    5). With ``profile``, ``torch.profiler`` records the card over the
    window: its busy share and the ops that fill it."""
    done, errors = [], []
    lock, stop = threading.Lock(), threading.Event()
    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=CLI_WAIT_S)
             for _ in range(clients)]
    for conn in conns:
        conn.connect()

    def client(i):
        conn, j = conns[i], i
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                http_post(port, bodies[j % len(bodies)], raw=raw, conn=conn)
                with lock:
                    done.append((t0, time.perf_counter()))
                j += clients
        except Exception as e:   # counted, and the phase fails below
            with lock:
                errors.append(repr(e))
        finally:
            conn.close()

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA]) \
        if profile else None
    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    with collector_clock(det) as marks:
        try:
            for t in threads:
                t.start()
            time.sleep(SERVER_RAMP_S)
            if prof:
                prof.start()
            lo = time.perf_counter()
            with det._lock:
                before = dict(det.stats)
            time.sleep(seconds)
            hi = time.perf_counter()
            with det._lock:
                after = dict(det.stats)
            if prof:
                prof.stop()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=CLI_WAIT_S)
    check(not any(t.is_alive() for t in threads), f"load level {clients}: a client hung")
    check(not errors, f"load level {clients}: {len(errors)} requests failed: {errors[:3]}")
    calls = after["device_calls"] - before["device_calls"]
    check(calls > 0, f"load level {clients}: no device call in {hi - lo:.2f} s")
    ms = np.asarray([b - a for a, b in done if lo <= a < hi]) * 1e3
    starts = [m[0] for m in marks]
    inside = [(m, starts[i + 1] if i + 1 < len(marks) else None)
              for i, m in enumerate(marks) if lo <= m[0] < hi]
    rec = {"body": "raw" if raw else "jpeg", "clients": clients, "seconds": hi - lo,
           "sent": len(done) + len(errors), "answered": len(done), "failed": len(errors),
           "latencies": len(ms), "req_per_s": sum(lo <= b < hi for _, b in done) / (hi - lo),
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)) if len(ms) >= P99_MIN else None,
           "device_calls": calls,
           "batch_fill": (after["batched_images"] - before["batched_images"]) / calls,
           "last_step_ms": after["last_step_ms"],
           # the collector's time a device call: the padded batch's assembly,
           # the step to the answers set, then its wait for the next group
           "assemble_ms": float(np.mean([b - a for (a, b, _), _ in inside]) * 1e3),
           "step_to_answers_ms": float(np.mean([c - b for (_, b, c), _ in inside]) * 1e3),
           "between_calls_ms": float(np.mean([n - c for (_, _, c), n in inside
                                              if n is not None]) * 1e3)}
    if prof:
        busy = device_busy(prof)
        rec["device_busy_share"] = busy["busy_ms"] / (rec["seconds"] * 1e3)
        rec["device_top"] = busy["top"]
    return rec


def server_family(name: str, run: Path, dev, jpegs: list) -> "tuple[dict, object]":
    """One run dir loaded onto the card behind ``BatchingDetector`` and
    HTTP: the main path (every request through the server, launch counts
    from zero), then the raw step's checks. Returns the record and the
    ``LoadedDetector``."""
    loaded = loading.load_detector(run, img_h=IMG_H, img_w=IMG_W, device=dev)
    check(model_device(loaded.model).type == dev.type, f"{name}: on {dev.type}")
    if loaded.family == "moe":   # an init's context bias is 0: the bins would change nothing
        gen = torch.Generator().manual_seed(65)
        with torch.no_grad():
            for pname, p in loaded.model.named_parameters():
                if pname.endswith("context_bias"):
                    p.copy_(torch.randn(p.shape, generator=gen))
    det = BatchingDetector(loaded.model, loaded.variables, batch=SERVER_B, img_h=IMG_H,
                           img_w=IMG_W, pool=POOL, max_wait_ms=SERVER_WAIT_MS)
    rec = {"family": loaded.family}
    detr, moe = loaded.family == "rtdetr", loaded.family == "moe"
    images = server_images(SERVER_B, seed=60 + len(name))
    try:
        t0 = time.perf_counter()
        det.warmup()
        rec["warmup_s"] = time.perf_counter() - t0
        with http_server(det) as port:
            # the main path: counts from zero, every call through the server
            nms_kernel.nms_keep_launches = 0
            deformable_kernel.ms_deform_fwd_launches = 0
            with det._lock:
                calls0 = det.stats["device_calls"]
            single = http_post(port, images[0].tobytes(), "conf=0")["detections"]
            with det._lock:
                solo_calls = det.stats["device_calls"] - calls0
            # 16 requests queued while the step of a 17th runs (a submit's
            # copy of a frame costs ~2 ms of page faults on these hosts, so
            # 16 in a row from one thread outlast the 20 ms window)
            primer = det.submit(images[-1], conf=0.0)
            time.sleep(2.5 * det.max_wait_s)
            t_submit = time.perf_counter()
            futs = [det.submit(img, conf=0.0) for img in images]
            rec["submit_ms"] = (time.perf_counter() - t_submit) * 1e3
            primer.result(timeout=CLI_WAIT_S)
            together = [f.result(timeout=CLI_WAIT_S) for f in futs]
            with det._lock:
                coalesced = det.stats["device_calls"] - calls0 - solo_calls - 1
            ctx_answer = http_post(port, images[1].tobytes(), "context=3&conf=0")["detections"] \
                if moe else None
            jpeg = http_post(port, jpegs[0], "conf=0", raw=False)
            if name == "yolo":
                bodies = {True: [i.tobytes() for i in images], False: jpegs}
                rec["load"] = [load_level(det, port, bodies[raw], raw, clients, seconds)
                               for raw, clients, seconds in SERVER_LEVELS]
                rec["load_profiled"] = load_level(det, port, bodies[True], True, 64,
                                                  SERVER_PROFILE_S, profile=True)
                # the handler's Nagle algorithm off (it is on in both
                # servers): what it costs one client a request
                with patched(server_module._Handler, "disable_nagle_algorithm",
                             lambda real: True):
                    rec["load_nodelay"] = load_level(det, port, bodies[True], True, 1,
                                                     SERVER_LEVELS[0][2])
            with det._lock:
                stats = dict(det.stats)
            launches = {"nms_keep": nms_kernel.nms_keep_launches,
                        "ms_deform_fwd": deformable_kernel.ms_deform_fwd_launches}
            device_calls = stats["device_calls"] - calls0
            health = http_get(f"http://127.0.0.1:{port}/healthz")
        rec.update(launches=launches, device_calls=device_calls, errors=stats["errors"],
                   last_step_ms=stats["last_step_ms"], coalesced_device_calls=coalesced,
                   healthz_keys=sorted(health))
        check(stats["errors"] == 0, f"{name}: the server counted errors")
        want = {"nms_keep": 0 if detr else device_calls,
                "ms_deform_fwd": RT_LAYERS * device_calls if detr else 0}
        check(launches == want, f"{name}: launches {launches}, expected {want}")
        check(solo_calls == 1 and coalesced == 1, f"{name}: {SERVER_B} requests in "
              f"{coalesced} device calls (one request: {solo_calls}; submitted in "
              f"{rec['submit_ms']:.1f} ms)")
        check(health["ok"] and health["batch"] == SERVER_B, f"{name}: healthz {health}")

        # the raw step on the same padded batches
        res, forward = recorded_step(det, images[:1])
        check_tail_on_cpu(name, res, forward, detr)
        expect = expected_detections(res, 0, 0.0)
        check(single == expect and len(single) > 0,
              f"{name}: one request == the raw step ({len(single)} vs {len(expect)})")
        rec["detections_per_request"] = len(single)
        if not detr:
            rec["independent_of_neighbours"] = together[0] == single
            check(rec["independent_of_neighbours"],
                  f"{name}: a response depends on its batch neighbours")
        full, forward = recorded_step(det, images)
        check_tail_on_cpu(name, full, forward, detr)
        check(together == [expected_detections(full, i, 0.0) for i in range(SERVER_B)],
              f"{name}: {SERVER_B} coalesced requests == the raw step")
        if moe:
            res3, _ = recorded_step(det, images[1:2], ctx=[3])
            res0, _ = recorded_step(det, images[1:2])
            check(ctx_answer == expected_detections(res3, 0, 0.0),
                  f"{name}: ?context=3 == the raw step with context 3")
            rec["context_changes_answer"] = ctx_answer != expected_detections(res0, 0, 0.0)
            check(rec["context_changes_answer"], f"{name}: the context bins change nothing")
        # the JPEG round trip: decoded as the handler decodes it
        if data_native.native_available():
            arr = data_native.decode_jpeg_bytes(jpegs[0], IMG_H, IMG_W)
        else:
            from PIL import Image

            with Image.open(io.BytesIO(jpegs[0])) as im:
                arr = np.asarray(im.convert("RGB"), np.uint8)
        res_j, _ = recorded_step(det, [arr])
        check(jpeg["detections"] == expected_detections(res_j, 0, 0.0)
              and (jpeg["width"], jpeg["height"]) == (IMG_W, IMG_H),
              f"{name}: the JPEG round trip == the raw step on the decoded frame")
        if name == "yolo":
            dev_images = torch.as_tensor(np.stack(images), device=dev)
            rec["bare_step_ms"] = cuda_ms(lambda: det._step(dev_images), reps=5)
    finally:
        det.close()
    return rec, loaded


def phase_server(dev, smi: str) -> dict:
    """The serving deployment at 704x1248: YOLO-s, MoE-YOLO-s (E=4) and
    RT-DETR r50vd run dirs (random weights from seed 0) loaded onto the card
    behind ``BatchingDetector`` (batch 16, pool 512, 20 ms window) and
    ``DetectorHTTPServer``; then the serve and predict CLIs and an int8
    serve CLI as child processes, started together."""
    t0 = time.perf_counter()
    rec = {"phase": "server", "gpu": smi, "img_hw": [IMG_H, IMG_W], "batch": SERVER_B,
           "pool": POOL, "max_wait_ms": SERVER_WAIT_MS, "native_jpeg": data_native.native_available(),
           "families": {}, **tf32_state()}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        runs = {cfg["family"]: write_run_dir(root / "runs", cfg) for cfg in EVAL_FAMILIES}
        sizes = [(int(w), int(h)) for w, h in np.random.default_rng(61).integers(
            (160, 90), (2 * IMG_W, 2 * IMG_H), (SERVER_IMAGES, 2))]
        (root / "imgs").mkdir()
        for i, data in enumerate(smooth_jpegs(SERVER_IMAGES, seed=62, sizes=sizes)):
            (root / "imgs" / f"frame_{i:02d}.jpg").write_bytes(data)
        libraries = kernel_libraries()
        check(all(_build.library_path(k).name in libraries for k in KERNELS),
              "the build phase's libraries are there for the children")
        size = ["--img-h", str(IMG_H), "--img-w", str(IMG_W), "--batch", str(SERVER_B)]
        serve = ["multimodal_moe_torch.cli.serve_detector", "--weights", str(runs["yolo"]),
                 "--port", "0", *size]
        jpegs = smooth_jpegs(SERVER_B, seed=63)
        for name in ("yolo", "moe", "rtdetr"):
            rec["families"][name], loaded = server_family(name, runs[name], dev, jpegs)
            if name == "yolo":
                yolo = loaded
            del loaded
            torch.cuda.empty_cache()
        # the children after the timed load: their start-up would share the host
        t_children = time.perf_counter()
        children = {
            "serve": start_child(serve),
            "serve_int8": start_child([*serve, "--int8", "--calib-images", str(root / "imgs")]),
            "predict": start_child(["multimodal_moe_torch.cli.predict_detector",
                                    "--weights", str(runs["yolo"]), "--images",
                                    str(root / "imgs"), "--out", str(root / "preds"),
                                    "--conf", "0", *size]),
        }
        try:
            rec["children"] = server_children(children, yolo)
            preds = json.loads((root / "preds" / "predictions.json").read_text())
            check([p["image"] for p in preds] == sorted(p.name for p in (root / "imgs").iterdir()),
                  "predict CLI: one entry an image")
            for p, (w, h) in zip(preds, sizes):
                check((p["width"], p["height"]) == (w, h) and len(p["detections"]) > 0
                      and all(0 <= d["xyxy"][0] <= d["xyxy"][2] <= w
                              and 0 <= d["xyxy"][1] <= d["xyxy"][3] <= h
                              for d in p["detections"]),
                      f"predict CLI: {p['image']}'s boxes inside its {w}x{h} image")
            rec["children"]["predict"]["images"] = len(preds)
            rec["children"]["predict"]["detections"] = sum(len(p["detections"]) for p in preds)
            rec["children"]["seconds"] = time.perf_counter() - t_children
        finally:
            for proc, _ in children.values():
                stop_child(proc)
        check(kernel_libraries() == libraries, "the children built no kernel")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def server_children(children: dict, loaded) -> dict:
    """The serve CLI's ``/healthz`` and one raw ``/predict``, equal to the
    in-process answer under torch's default TF32 state (the CLIs keep it);
    the int8 serve CLI's; the predict CLI's exit."""
    out = {}
    img = server_images(1, seed=64)[0]
    for name in ("serve", "serve_int8"):
        proc, lines = children[name]
        url = child_url(proc, lines, name)
        health = http_get(f"{url}/healthz")
        check(health["ok"] and health["batch"] == SERVER_B, f"{name}: healthz {health}")
        answer = http_post(int(url.rsplit(":", 1)[1]), img.tobytes(), "conf=0")["detections"]
        check(len(answer) > 0, f"{name}: no detections")
        out[name] = {"healthz": health, "detections": len(answer), "answer": answer}
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = TORCH_DEFAULT_TF32["cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = TORCH_DEFAULT_TF32["matmul"]
    det = BatchingDetector(loaded.model, loaded.variables, batch=SERVER_B, img_h=IMG_H,
                           img_w=IMG_W, pool=POOL, max_wait_ms=SERVER_WAIT_MS)
    try:
        local = det.submit(img, conf=0.0).result(timeout=CLI_WAIT_S)
    finally:
        det.close()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    served = out["serve"].pop("answer")
    out["serve_int8"].pop("answer")
    out["serve"]["equal_to_in_process"] = served == local
    check(served == local, "serve CLI: /predict == the in-process answer (torch's TF32 defaults)")
    proc, lines = children["predict"]
    proc.wait(timeout=CLI_WAIT_S)
    log = []
    while not lines.empty():
        log.append(lines.get())
    check(proc.returncode == 0, f"predict CLI exited {proc.returncode}: {''.join(log)[-2000:]}")
    out["predict"] = {"log_tail": "".join(log)[-300:]}
    return out


def nms_launch_split(fn, reps: int = 20) -> dict:
    """Device ms of each of the keep mask's two launches (the IoU bitmask,
    the walk; above K = 1024 ``mask_tiles_kernel`` and
    ``walk_global_kernel``) a call of ``fn``, by ``torch.profiler``, and
    ``profiler_windows``, the windows profiled. The profiler has been seen
    to record no kernel at all in a window on an H100, for a cause not
    found; another window (up to three) is then profiled, and the count
    says how often that happens."""
    fn()
    torch.cuda.synchronize()
    pattern = {"mask_kernel": re.compile(r"mask_(tiles_)?kernel"),
               "walk_kernel": re.compile(r"walk_(global_)?kernel")}
    for windows in range(1, 4):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {"mask_kernel": 0.0, "walk_kernel": 0.0}
        for key, ms, _ in device_rows(prof):
            for name in split:
                if pattern[name].search(key):
                    split[name] += ms / reps
        if all(ms > 0 for ms in split.values()):
            break
    check(all(ms > 0 for ms in split.values()), "the profiler saw both NMS launches")
    return {**split, "profiler_windows": windows}


def nms_tail_split(boxes, scores, reps: int) -> dict:
    """The NMS tail of ``batched_nms`` (``ops.nms._batched_nms_kernel``, run
    as it is) stage by stage between CUDA events, recorded by wrappers around
    its ``_preselect`` and ``_compact``: the preselection (the stable sort and
    gathers), the keep-mask kernel with its inputs' casts, and the
    compaction to max_det with the final gathers."""
    zeros = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    totals = [0.0, 0.0, 0.0]
    preselect, compact = nms_module._preselect, nms_module._compact

    def timed_preselect(*args, **kwargs):
        out = preselect(*args, **kwargs)
        events[1].record()
        return out

    def timed_compact(*args, **kwargs):
        events[2].record()
        return compact(*args, **kwargs)

    nms_module._preselect, nms_module._compact = timed_preselect, timed_compact
    try:
        for rep in range(reps + 1):
            events[0].record()
            nms_module._batched_nms_kernel(
                boxes, scores, zeros, iou_threshold=IOU, score_threshold=SCORE_THR,
                max_det=MAX_DET, num_candidates=POOL, class_agnostic=False)
            events[3].record()
            torch.cuda.synchronize()
            if rep:  # the first pass warms up
                for i in range(3):
                    totals[i] += events[i].elapsed_time(events[i + 1])
    finally:
        nms_module._preselect, nms_module._compact = preselect, compact
    return {"preselect": totals[0] / reps, "kernel": totals[1] / reps,
            "compaction": totals[2] / reps}


def ptxas_functions(log: str) -> list:
    """Each kernel instantiation in a ``-Xptxas -v`` log with its registers
    and spill bytes (names demangled by c++filt where the host has it)."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        if m := re.search(r"entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append({"function": name, "registers": int(m.group(1)), "spill_bytes": spill})
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r["function"] for r in rows),
                               capture_output=True, text=True, check=True, timeout=60)
        for row, pretty in zip(rows, names.stdout.splitlines()):
            row["function"] = pretty.replace("(anonymous namespace)::", "")
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def build_kernels() -> dict:
    """Build every kernel of the port at once (one nvcc each, in parallel)."""
    t0 = time.perf_counter()
    builds = [(name, ()) for name in KERNELS] + [("nms_keep", NMS_NO_FILTER)]
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda nd: _build.build(*nd), builds))
    report = {}
    for (name, defines), lib in zip(builds, libs):
        key = _build.build_key(name, defines)
        report[key] = {
            "library": str(lib.relative_to(ROOT)),
            "compiled": key in _build.build_seconds,
            "nvcc_seconds": _build.build_seconds.get(key),
            "functions": ptxas_functions(_build.build_logs.get(key, "")),
        }
    return {"phase": "build", "seconds": time.perf_counter() - t0, "kernels": report,
            "nvcc_flags": {_build.build_key(*nd): list(_build.nvcc_flags(*nd))
                           for nd in builds}}


# --------------------------------------------------------------------------
# multi-scale deformable attention
# --------------------------------------------------------------------------

def deform_tol(values) -> float:
    """Every output is a combination of value rows with weights summing to
    at most 1, summed in another order than the plain version."""
    return 1e-5 * max(1.0, float(values.abs().max()))


def deform_bound(values, level_shapes, loc, attn) -> dict:
    """Least time for what these inputs need: every value row (one head's D
    floats) that a corner in bounds with a non-zero weight samples, read
    once, ``loc`` and ``attn`` read once and the output written once, over
    the memory rate; or those corners' multiply-adds and each point's
    geometry over the fp32 rate. Rows no query samples are not counted."""
    b, total, nh, d = values.shape
    _, q, _, n_levels, _, _ = loc.shape
    dev = loc.device
    hw = torch.tensor(level_shapes, dtype=torch.float32, device=dev).view(1, 1, 1, n_levels, 1, 2)
    hgt, wid = hw[..., 0], hw[..., 1]
    starts = torch.tensor(level_shapes_to_offsets(level_shapes)[0], device=dev)
    starts = starts.view(1, 1, 1, n_levels, 1)
    x = loc[..., 0] * wid - 0.5          # the kernel's geometry, in fp32
    y = loc[..., 1] * hgt - 0.5
    x0, y0 = x.floor(), y.floor()
    wx, wy = x - x0, y - y0
    batch = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    head = torch.arange(nh, device=dev).view(1, 1, nh, 1, 1)
    rows, corners = [], 0
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            w = attn * (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            ok = (cx >= 0) & (cx < wid) & (cy >= 0) & (cy < hgt) & (w != 0)
            pix = (starts + torch.where(ok, cy, 0).long() * wid.long()
                   + torch.where(ok, cx, 0).long())
            rows.append((((batch * total + pix) * nh + head))[ok])
            corners += int(ok.sum())
    n_rows = int(torch.unique(torch.cat(rows)).numel())
    nbytes = 4 * (n_rows * d + loc.numel() + attn.numel() + b * q * nh * d)
    flops = corners * 2 * d + attn.numel() * DEFORM_POINT_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "value_rows_read": n_rows,
            "value_rows_total": b * total * nh, "corners_in_bounds": corners,
            "corners_total": 4 * attn.numel()}


def grid_sample_deform(values, level_shapes, loc, attn):
    """The upstream RT-DETR's PyTorch formulation (the library yardstick):
    per level ``F.grid_sample`` on (B·NH, D, H, W), then the attention-
    weighted sum. Timed and checked here only; the port never calls it."""
    b, _, nh, d = values.shape
    _, q, _, n_levels, n_points, _ = loc.shape
    grids = 2 * loc - 1
    sampled = []
    sizes = [h * w for h, w in level_shapes]
    for lvl, (v_l, (h, w)) in enumerate(zip(values.split(sizes, dim=1), level_shapes)):
        v_l = v_l.permute(0, 2, 3, 1).reshape(b * nh, d, h, w)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(b * nh, q, n_points, 2)
        sampled.append(F.grid_sample(v_l, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))              # (B·NH, D, Q, P)
    s = torch.stack(sampled, dim=-2)                                    # (B·NH, D, Q, L, P)
    a = attn.permute(0, 2, 1, 3, 4).reshape(b * nh, 1, q, n_levels, n_points)
    out = (s * a).sum((-1, -2)).view(b, nh, d, q)
    return out.permute(0, 3, 1, 2).reshape(b, q, nh * d)


NON_FINITE = (float("nan"), float("inf"), float("-inf"), 1e30)


def deform_problem(levels, b, nh, d, p, q, seed, dev, mode="uniform"):
    """Seeded values and softmaxed weights; locations uniform in
    [-0.3, 1.3] (out of bounds on every side), on pixel centres and the
    borders 0 and 1 (``mode="grid"``), or uniform with NaN, +inf, -inf and
    1e30 in one coordinate or both of every 7th, 11th and 13th point
    (``mode="non_finite"``)."""
    rng = np.random.default_rng(seed)
    total = sum(h * w for h, w in levels)
    values = rng.normal(0.0, 1.0, (b, total, nh, d)).astype(np.float32)
    shape = (b, q, nh, len(levels), p)
    if mode in ("uniform", "non_finite"):
        loc = rng.uniform(-0.3, 1.3, shape + (2,))
    else:
        hw = np.asarray(levels, np.float64)[None, None, None, :, None, ::-1]  # (W, H)
        loc = (np.floor(rng.uniform(0, 1, shape + (2,)) * hw) + 0.5) / hw
        pick = rng.integers(0, 4, shape + (2,))
        loc = np.where(pick == 1, 0.0, np.where(pick == 2, 1.0, loc))
    if mode == "non_finite":
        flat = loc.reshape(-1, 2)
        for i, bad in enumerate(NON_FINITE):
            flat[i::7 * len(NON_FINITE), 0] = bad
            flat[i::11 * len(NON_FINITE), 1] = bad
            flat[i::13 * len(NON_FINITE), :] = bad
    logits = rng.normal(0.0, 1.0, (b, q, nh, len(levels) * p))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return t(values), t(loc), t(attn.reshape(shape))


def deform_compare(values, levels, loc, attn, library: bool = True) -> dict:
    """Kernel (and grid_sample, unless ``library`` is False: it has its own
    semantics at non-finite locations) against the plain version on the
    same inputs, element for element, with the pattern of finite values
    equal; the numbers are emitted before any check can raise."""
    got = deformable_kernel.ms_deform_attn_fwd(values, levels, loc, attn)
    ref = ms_deformable_attention(values, levels, loc, attn)
    rec = {"tolerance": deform_tol(values),
           "max_abs_err": float((got - ref).abs().max()),
           "finite": bool(torch.isfinite(got).all()),
           "finite_pattern_equal": torch.equal(torch.isfinite(got), torch.isfinite(ref))}
    if library:
        lib = grid_sample_deform(values, levels, loc, attn)
        rec["grid_sample_max_abs_err"] = float((lib - ref).abs().max())
    torch.cuda.synchronize()
    return rec


def check_deform(rec: dict, what: str) -> None:
    check(rec["finite"] and rec["finite_pattern_equal"], f"{what}: finite kernel output")
    check(rec["max_abs_err"] <= rec["tolerance"], f"{what}: kernel vs plain")
    if "grid_sample_max_abs_err" in rec:
        check(rec["grid_sample_max_abs_err"] <= rec["tolerance"], f"{what}: grid_sample vs plain")


def deform_times(values, levels, loc, attn) -> dict:
    fn = deformable_kernel.ms_deform_attn_fwd
    bound = deform_bound(values, levels, loc, attn)
    kernel_ms = cuda_ms(lambda: fn(values, levels, loc, attn), reps=20, warmup=3)
    return {
        "kernel_ms": kernel_ms,
        "plain_ms": cuda_ms(lambda: ms_deformable_attention(values, levels, loc, attn), reps=5),
        "library_ms": cuda_ms(lambda: grid_sample_deform(values, levels, loc, attn), reps=5),
        **bound,
        # The bytes these inputs need over the kernel's time.
        "achieved_gb_per_s": bound["bytes"] / kernel_ms / 1e6,
    }


def phase_deform_kernel(dev) -> dict:
    cases = {
        "headline": (RT_LEVELS, RT_B, RT_NH, RT_D, RT_P, RT_QUERIES, "uniform"),
        "test_shape": (((8, 12), (4, 6), (2, 3)), 2, 2, 8, 4, 7, "uniform"),
        "centres_and_borders": (RT_LEVELS, 2, RT_NH, RT_D, RT_P, RT_QUERIES, "grid"),
        "non_finite": (RT_LEVELS, 2, RT_NH, RT_D, RT_P, RT_QUERIES, "non_finite"),
        "d6_scalar": (RT_LEVELS, 2, RT_NH, 6, RT_P, RT_QUERIES, "uniform"),
        "d8_vector": (RT_LEVELS, 2, RT_NH, 8, RT_P, RT_QUERIES, "uniform"),
    }
    report = {}
    for seed, (name, (levels, b, nh, d, p, q, mode)) in enumerate(cases.items()):
        values, loc, attn = deform_problem(levels, b, nh, d, p, q, seed, dev, mode)
        rec = {"levels": levels, "B": b, "NH": nh, "D": d, "P": p, "Q": q, "loc": mode,
               **deform_compare(values, levels, loc, attn, library=mode != "non_finite")}
        if name == "headline":
            rec.update(deform_times(values, levels, loc, attn))
        report[name] = rec
    emit({"phase": "ms_deform_fwd", "cases": report})
    for name, rec in report.items():
        check_deform(rec, f"ms_deform_fwd {name}")
    return report


# --------------------------------------------------------------------------
# RT-DETR
# --------------------------------------------------------------------------

def build_rtdetr(dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = RTDETRDetector(num_classes=1, num_queries=RT_QUERIES, num_decoder_layers=RT_LAYERS,
                           arch="tpu", dtype=dtype, generator=gen)
    return model.eval().to(dev).to(memory_format=torch.channels_last)


@contextlib.contextmanager
def patched(module, name, make):
    """Replace ``module.name`` by ``make(real)`` for the duration."""
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def topk_selection(module, record: "list | None" = None, replay: "list | None" = None,
                   scores_seen: "list | None" = None):
    """Wrap ``module.stable_topk`` (RTDETRDetector's query selection, the MoE
    routers' expert choice): append the indices each call picks to
    ``record``, or make the calls pick ``replay``'s, in order, so that two
    forwards select the same queries or experts; append the scores each
    call selects from to ``scores_seen``."""
    def make(real):
        def select(scores, k):
            if scores_seen is not None:
                scores_seen.append(scores.detach().float().cpu())
            if replay is None:
                picked = real(scores, k)
                record.append(picked[1])
                return picked
            idx = replay.pop(0).to(scores.device)
            return torch.gather(scores, 1, idx), idx
        return select
    return patched(module, "stable_topk", make)


class Capture:
    """Forward hooks: the encoder scores and the deformable kernel's inputs
    of decoder layer 0 (recomputed from the layer's own inputs by
    ``MSDeformAttn.sampling_inputs``, the code the forward runs)."""

    def __init__(self, model):
        self.enc_logits = None
        self.kernel_inputs = None
        self._handles = [
            model.enc_score.register_forward_hook(self._enc),
            model.decoder0.cross_attn.register_forward_hook(self._cross),
        ]

    def _enc(self, module, args, out):
        self.enc_logits = out.float()

    def _cross(self, module, args, out):
        query, ref, values, level_shapes = args
        self.kernel_inputs = (*module.sampling_inputs(query, ref, values), level_shapes)

    def remove(self):
        for h in self._handles:
            h.remove()


def phase_rtdetr_fp32(dev) -> "tuple[dict, float]":
    model = build_rtdetr(torch.float32, dev)
    cpu_model = copy.deepcopy(model).cpu().to(memory_format=torch.contiguous_format)
    images = random_images(1, seed=3, dev=dev)
    card_cap, cpu_cap = Capture(model), Capture(cpu_model)
    before = deformable_kernel.ms_deform_fwd_launches
    picked = []
    with torch.inference_mode():
        with topk_selection(rtdetr_module, record=picked):
            on_card = model(images.float() / 255.0)
        torch.cuda.synchronize()
        launched = deformable_kernel.ms_deform_fwd_launches - before
        # The CPU decodes the card's queries, whatever its own scores pick.
        with topk_selection(rtdetr_module, replay=[picked[0]]):
            on_cpu = cpu_model(images.cpu().float() / 255.0)
    card_cap.remove()
    cpu_cap.remove()

    tol = lambda ref: 1e-4 + 1e-3 * ref.abs()  # noqa: E731
    # The top-300 selection, on each device from its own encoder scores.
    _, valid = anchors_for(RT_LEVELS)
    valid = torch.as_tensor(valid)
    scores = {k: c.enc_logits.cpu().max(-1).values.masked_fill(~valid[None], -1e9)
              for k, c in (("card", card_cap), ("cpu", cpu_cap))}
    top_card = picked[0].cpu()
    top_cpu = stable_topk(scores["cpu"], RT_QUERIES)[1]
    srt = torch.sort(scores["cpu"], dim=-1, descending=True).values[0, : RT_QUERIES + 1]
    gaps = srt[:-1] - srt[1:]
    same_selection = torch.equal(top_card, top_cpu)
    errs = {"enc_scores": float((scores["card"] - scores["cpu"]).abs().max())}
    # Scores closer than twice the largest card-CPU difference may swap.
    selection_defined = bool(gaps.min() > 2 * errs["enc_scores"])
    ok = {"enc_scores": bool(((scores["card"] - scores["cpu"]).abs() <= tol(scores["cpu"])).all())}
    pairs = {"enc_outputs.pred_logits": (on_card["enc_outputs"]["pred_logits"],
                                         on_cpu["enc_outputs"]["pred_logits"]),
             "pred_logits": (on_card["pred_logits"], on_cpu["pred_logits"]),
             "pred_boxes": (on_card["pred_boxes"], on_cpu["pred_boxes"])}
    for k, (a, b) in pairs.items():
        d = (a.cpu() - b).abs()
        errs[k] = float(d.max())
        ok[k] = bool((d <= tol(b)).all())

    # The kernel on decoder layer 0's own inputs, against the plain version.
    v, loc, attn, levels = card_cap.kernel_inputs
    main = deform_compare(v, levels, loc, attn)
    rec = {
        "phase": "rtdetr_fp32", "model": "rtdetr r50vd arch=tpu", "batch": 1,
        "img_hw": [IMG_H, IMG_W], "launches_per_forward": launched,
        "card_vs_cpu_max_abs": errs, "within_tolerance": ok,
        "tolerance": "|d| <= 1e-4 + 1e-3*|cpu|",
        "same_top300": same_selection, "top300_defined": selection_defined,
        "decoded_queries": "the card's top-300 on both",
        "cpu_gap_300_301": float(gaps[-1]), "cpu_min_gap_top301": float(gaps.min()),
        "kernel_on_decoder0_inputs": main, **tf32_state(),
    }
    if not same_selection and not selection_defined:
        rec["note"] = ("the CPU's encoder scores have near-ties closer than twice the "
                       "card-CPU difference, so its own top-300 may differ from the card's")
    emit(rec)
    check(launched == RT_LAYERS, f"ms_deform_fwd launched {launched} times, not {RT_LAYERS}")
    check_deform(main, "ms_deform_fwd on decoder layer 0's inputs")
    check(ok["enc_scores"], "card vs CPU encoder scores")
    check(same_selection or not selection_defined, "card vs CPU top-300 selection")
    for k in pairs:
        check(ok[k], f"card vs CPU {k}")
    return rec, main["max_abs_err"]


def event_split(model, call, marks, parts, reps: int) -> dict:
    """Mean ms between CUDA events recorded from module hooks: ``marks`` is
    a list of (module, "pre" or "post"), one event each per forward;
    ``parts`` names the spans between consecutive marks."""
    runs, cur = [], []

    def mark(*_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        cur.append(e)

    handles = [m.register_forward_pre_hook(mark) if kind == "pre" else m.register_forward_hook(mark)
               for m, kind in marks]
    try:
        with torch.inference_mode():
            for i in range(reps + 1):
                cur = []
                call()
                if i:  # the first is a warm-up
                    runs.append(cur)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {p: float(np.mean([r[j].elapsed_time(r[j + 1]) for r in runs]))
            for j, p in enumerate(parts)}


def phase_rtdetr_serving(dev, smi: str, dtype) -> "tuple[dict, dict]":
    model = build_rtdetr(dtype, dev)
    kw = dict(max_det=MAX_DET, score_threshold=SCORE_THR)
    step = make_serving_step(model, **kw)
    images = random_images(RT_B, seed=4, dev=dev)

    # The main path: the counts from zero over one serving step.
    cap = Capture(model)
    deformable_kernel.ms_deform_fwd_launches = 0
    nms_kernel.nms_keep_launches = 0
    res = step(images)
    torch.cuda.synchronize()
    launches = deformable_kernel.ms_deform_fwd_launches
    nms_launches = nms_kernel.nms_keep_launches
    cap.remove()
    check(launches == RT_LAYERS, f"RT-DETR step launched ms_deform_fwd {launches} times")
    check(all(bool(torch.isfinite(t).all()) for t in res[:2]), "finite RT-DETR outputs")
    check(tuple(res.boxes.shape) == (RT_B, min(MAX_DET, RT_QUERIES), 4),
          "RT-DETR NmsResult shape")

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: step(images), reps=5)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    def forward():
        with torch.inference_mode():
            return model(images.float() / 255.0)

    forward_ms = cuda_ms(forward, reps=5)
    out = forward()
    scores = torch.sigmoid(out["cls_logits"][..., 0].float())
    tail_ms = cuda_ms(lambda: detr_topk_select(out["boxes"], scores, **kw), reps=20)
    rec = {
        "phase": "rtdetr_serving", "model": "rtdetr r50vd arch=tpu",
        "dtype": str(dtype).replace("torch.", ""), "batch": RT_B, "img_hw": [IMG_H, IMG_W],
        "num_queries": RT_QUERIES, "decoder_layers": RT_LAYERS, "max_det": MAX_DET,
        "step_ms": step_ms, "forward_ms": forward_ms, "tail_ms": tail_ms,
        "img_per_s": RT_B * 1000.0 / step_ms, "peak_mem_gib": peak_gib,
        "forward_split": event_split(
            model, forward,
            [(model, "pre"), (model.backbone, "post"), (model.encoder, "post"), (model, "post")],
            ["backbone_ms", "encoder_ms", "select_and_decoder_ms"], reps=3),
        "ms_deform_fwd_launches": launches, "nms_keep_launches": nms_launches,
        "valid_out": int(res.valid.sum()), "gpu": smi, **tf32_state(),
    }
    v, loc, attn, levels = cap.kernel_inputs
    main = {"shape": {"B": RT_B, "sum_hw": v.shape[1], "NH": v.shape[2], "D": v.shape[3],
                      "L": attn.shape[3], "P": attn.shape[4], "Q": attn.shape[1]},
            "launches": launches, **deform_compare(v, levels, loc, attn),
            **deform_times(v, levels, loc, attn)}
    rec["kernel_on_step_inputs"] = main
    emit(rec)
    check_deform(main, f"ms_deform_fwd on the {rec['dtype']} step's inputs")
    return rec, main


# --------------------------------------------------------------------------
# RT-DETR training and the deformable-attention backward
# --------------------------------------------------------------------------

RT_MAX_BOXES, RT_DN_GROUPS = 96, 2                          # scripts/train_rtdetr.py
RT_TRAIN_Q = RT_QUERIES + 2 * RT_DN_GROUPS * RT_MAX_BOXES   # 684 decoder queries
RT_STEPS_PER_EPOCH = 1000   # the schedule's length; the timed steps sit in the warmup
U32 = 2.0 ** -24            # float32 unit roundoff
# Per point, B5's fused elementwise part (ms_deform_attn_loc_attn_grads): per
# corner 2 products and a sum for d_attn, s·attn, 2 products and a sum for
# dwx, 2 products and a sum for dwy; then the scales by W_l and H_l.
DEFORM_BWD_EPILOGUE_FLOPS = 4 * 10 + 2


def deform_bwd_compare(values, levels, loc, attn, g) -> dict:
    """B5's (dv, d_loc, d_attn) from one launch against the plain backward
    and its elementwise part on the same inputs, per element under
    ``deformable_kernel.deform_bwd_tolerance`` (2·n·u·Σ|terms|), d_loc and
    d_attn also under 1e-5·max(1, max|ref|), and the pattern of finite
    values equal; the numbers are returned before any check can raise."""
    got = deformable_kernel.ms_deform_attn_bwd(values, levels, loc, attn, g)
    ref_dv, ref_s = ms_deform_attn_bwd_plain(values, levels, loc, attn, g)
    ref = (ref_dv, *ms_deform_attn_loc_attn_grads(levels, loc, attn, ref_s))
    tols = deformable_kernel.deform_bwd_tolerance(values, levels, loc, attn, g)
    torch.cuda.synchronize()
    rec = {"finite": all(bool(torch.isfinite(t).all()) for t in got),
           "finite_pattern_equal": all(torch.equal(torch.isfinite(a), torch.isfinite(b))
                                       for a, b in zip(got, ref)),
           "tolerance": "dv, d_loc, d_attn: 2·n·u·Σ|terms| per element "
                        "(deformable_kernel.deform_bwd_tolerance); d_loc, d_attn also "
                        "1e-5·max(1, max|ref|)"}
    for name, a, r, tol in zip(("dv", "d_loc", "d_attn"), got, ref, tols):
        d = (a - r).abs()
        rec[f"{name}_max_abs_err"] = float(d.max())
        rec[f"{name}_err_over_tolerance"] = float(torch.where(d == 0, 0.0, d / tol).max())
        rec[f"{name}_within_tolerance"] = bool((d <= tol).all())
        if name != "dv":
            rec[f"{name}_within_1e-5"] = float(d.max()) <= 1e-5 * max(1.0, float(r.abs().max()))
    rec["max_abs_err"] = max(rec[f"{n}_max_abs_err"] for n in ("dv", "d_loc", "d_attn"))
    rec["dv_rows_written"] = int((ref_dv.abs().amax(-1) > 0).sum())
    del got, ref, ref_dv, ref_s, tols
    return rec


def check_deform_bwd(rec: dict, what: str) -> None:
    check(rec["finite"] and rec["finite_pattern_equal"], f"{what}: finite kernel outputs")
    for name in ("dv", "d_loc", "d_attn"):
        check(rec[f"{name}_within_tolerance"], f"{what}: {name} kernel vs plain")
    for name in ("d_loc", "d_attn"):
        check(rec[f"{name}_within_1e-5"], f"{what}: {name} kernel vs plain, 1e-5")


def deform_bwd_bound(values, levels, loc, attn) -> dict:
    """Least time for B5's fused function on these inputs: the value rows
    that in-bounds corners sample, g, loc and attn read once, dv (the size
    of ``values``), d_loc and d_attn (3 floats a point) written once, over
    the memory rate; or each in-bounds corner's dot and add (4·D flops) and
    each point's geometry and elementwise part over the fp32 rate. The
    bound of the unfused function (``s``, 4 floats a point, written in place
    of d_loc and d_attn, and no elementwise part) is printed beside it."""
    fwd = deform_bound(values, levels, loc, attn)   # rows, loc, attn, and g's size
    corner_flops = fwd["corners_in_bounds"] * 4 * values.shape[3]
    out = {}
    for key, per_point, point_flops in (("", 3, DEFORM_POINT_FLOPS + DEFORM_BWD_EPILOGUE_FLOPS),
                                        ("with_s_", 4, DEFORM_POINT_FLOPS)):
        nbytes = fwd["bytes"] + 4 * (attn.numel() * per_point + values.numel())
        flops = corner_flops + attn.numel() * point_flops
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
        out.update({f"{key}bound_ms": max(t_bytes, t_ops),
                    f"{key}bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    f"{key}bytes": nbytes, f"{key}flops": flops})
    return {**out, "dv_bytes": 4 * values.numel(), "value_rows_read": fwd["value_rows_read"],
            "corners_in_bounds": fwd["corners_in_bounds"]}


def deform_bwd_times(values, levels, loc, attn, g) -> dict:
    """The whole backward (the ``dv`` zero fill and the one launch) against
    its plain version and the library yardstick; the zero fill alone."""
    bound = deform_bwd_bound(values, levels, loc, attn)
    bwd = deformable_kernel.ms_deform_attn_bwd
    kernel_ms = cuda_ms(lambda: bwd(values, levels, loc, attn, g), reps=10, warmup=2)
    memset_ms = cuda_ms(lambda: torch.zeros_like(values), reps=10)

    def plain():
        _, s = ms_deform_attn_bwd_plain(values, levels, loc, attn, g)
        return ms_deform_attn_loc_attn_grads(levels, loc, attn, s)

    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    # The library yardstick: autograd's backward through the grid_sample
    # formulation, which yields the same dv, d_loc and d_attn.
    inputs = [t.detach().requires_grad_() for t in (values, loc, attn)]
    out = grid_sample_deform(inputs[0], levels, inputs[1], inputs[2])
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True), reps=5)
    lib_dv = torch.autograd.grad(out, inputs, g, retain_graph=True)[0]
    ref_dv, _ = ms_deform_attn_bwd_plain(values, levels, loc, attn, g)
    lib_err = float((lib_dv - ref_dv).abs().max())
    del out, inputs, lib_dv, ref_dv
    return {"kernel_ms": kernel_ms, "backward_ms": kernel_ms, "memset_ms": memset_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_dv_max_abs_err": lib_err,
            **bound, "achieved_gb_per_s": bound["bytes"] / kernel_ms / 1e6}


def phase_deform_bwd(dev) -> dict:
    cases = {
        "training_shape": (RT_LEVELS, RT_B, RT_NH, RT_D, RT_P, RT_TRAIN_Q, "uniform"),
        "test_shape": (((8, 12), (4, 6), (2, 3)), 2, 2, 8, 4, 7, "uniform"),
        "centres_and_borders": (RT_LEVELS, 2, RT_NH, RT_D, RT_P, RT_TRAIN_Q, "grid"),
        "contention": (RT_LEVELS, 2, RT_NH, RT_D, RT_P, RT_TRAIN_Q, "one_location"),
        "non_finite": (RT_LEVELS, 2, RT_NH, RT_D, RT_P, RT_TRAIN_Q, "non_finite"),
        "d6_scalar": (RT_LEVELS, 2, RT_NH, 6, RT_P, RT_TRAIN_Q, "uniform"),
        "d8_vector": (RT_LEVELS, 2, RT_NH, 8, RT_P, RT_TRAIN_Q, "uniform"),
    }
    report = {}
    for seed, (name, (levels, b, nh, d, p, q, mode)) in enumerate(cases.items()):
        values, loc, attn = deform_problem(levels, b, nh, d, p, q, 20 + seed, dev,
                                           "uniform" if mode == "one_location" else mode)
        if mode == "one_location":   # every sample of a (batch, head) on one spot
            loc = torch.tensor([0.37, 0.61], device=dev).expand_as(loc).contiguous()
        gen = torch.Generator(device=dev).manual_seed(30 + seed)
        g = torch.randn((b, q, nh * d), generator=gen, device=dev)
        rec = {"levels": levels, "B": b, "NH": nh, "D": d, "P": p, "Q": q, "loc": mode,
               **deform_bwd_compare(values, levels, loc, attn, g)}
        if name == "training_shape":
            rec.update(deform_bwd_times(values, levels, loc, attn, g))
        report[name] = rec
        del values, loc, attn, g
        torch.cuda.empty_cache()
    emit({"phase": "ms_deform_bwd", "cases": report})
    for name, rec in report.items():
        check_deform_bwd(rec, f"ms_deform_bwd {name}")
    return report


def rtdetr_trainer(dev, b: int, template=None, mesh=None, **cfg_kw) -> DetectionTrainer:
    """scripts/train_rtdetr.py's model and trainer: r50vd, hidden 256, 300
    queries, 6 decoder layers, remat, AdamW lr 1e-4 flat after a 1-epoch
    warmup, weight decay 1e-4; random weights from seed 0."""
    if template is None:
        template = RTDETRDetector(num_classes=1, hidden_dim=256, num_queries=RT_QUERIES,
                                  num_decoder_layers=RT_LAYERS, remat=True,
                                  generator=torch.Generator().manual_seed(0))
    cfg = DetTrainConfig(**{**dict(variant="r50vd", img_h=IMG_H, img_w=IMG_W, batch=b, lr0=1e-4,
                                   lrf=1.0, optimizer="adamw", weight_decay=1e-4,
                                   warmup_epochs=1.0), **cfg_kw})
    return DetectionTrainer(template, cfg, loss_fn=functools.partial(rtdetr_loss,
                                                                     img_hw=(IMG_H, IMG_W)),
                            steps_per_epoch=RT_STEPS_PER_EPOCH, device=dev, mesh=mesh)


def rt_train_batch(b: int, seed: int, dev) -> dict:
    """Seeded uint8 frames and 96 ground-truth slots per frame, 4–23 of
    them pedestrians (boxes 8–120 px wide, 16–200 px tall at 704×1248)."""
    rng = np.random.default_rng(seed)
    m = RT_MAX_BOXES
    w = rng.uniform(8 / 1248, 120 / 1248, (b, m)) * IMG_W
    h = rng.uniform(16 / 704, 200 / 704, (b, m)) * IMG_H
    x1, y1 = rng.uniform(0, 1, (b, m)) * (IMG_W - 1 - w), rng.uniform(0, 1, (b, m)) * (IMG_H - 1 - h)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    mask = np.arange(m)[None] < rng.integers(4, 24, (b, 1))
    boxes[~mask] = 0.0
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return {"image": random_images(b, seed, dev), "gt_boxes": t(boxes),
            "gt_labels": t(np.zeros((b, m), np.int32)), "gt_mask": t(mask)}


def decoder_io(model, store: dict) -> list:
    """Hooks that keep each decoder layer's inputs and its output's
    gradient (the cotangent the rest of the step sends back into it)."""
    def keep(li):
        def hook(module, args, kwargs, out):
            rec = store.setdefault(li, {})
            rec["args"] = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
            rec["attn_mask"] = kwargs.get("attn_mask")
            out.register_hook(lambda g: rec.update(grad=g.detach()))
        return hook
    return [getattr(model, f"decoder{li}").register_forward_hook(keep(li), with_kwargs=True)
            for li in range(RT_LAYERS)]


def run_train_step(trainer, batch, draws=None, assign=None, layer_io=None,
                   io_hooks=decoder_io) -> dict:
    """One ``train_step`` from a fresh state: the loss, its metrics and the
    gradients handed to the optimizer (on the host), with the matcher
    wrapped by ``assign(real)`` when given; the inputs and output gradient
    of each module that ``io_hooks`` hooks (the decoder layers) into
    ``layer_io`` when given."""
    state = trainer.init_state()
    grads = {}
    apply = state.apply_gradients

    def capture(g):
        grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = capture
    hooks = io_hooks(state.model, layer_io) if layer_io is not None else []
    with contextlib.ExitStack() as stack:
        if assign is not None:
            stack.enter_context(patched(hungarian_module, "batched_lsa_assign", assign))
        _, metrics = trainer.train_step(state, batch, draws=draws)
    for h in hooks:
        h.remove()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "model": state.model}


def rel_err(got: dict, ref: dict) -> float:
    """‖got − ref‖ / ‖ref‖ over all tensors of the two dicts together."""
    diff = sum(float(((got[k] - ref[k]).double() ** 2).sum()) for k in ref)
    norm = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    return (diff / max(norm, 1e-30)) ** 0.5


def decoder_layer_replay(template, layer_io: dict, card_grads: dict) -> dict:
    """Each decoder layer of the card's step again on the CPU, on the card's
    own inputs and output gradient: the layer's parameter gradients (its
    kernels B4 and B5 in place, against the plain versions) compared with
    the card's."""
    errs = {}
    for li, rec in sorted(layer_io.items()):
        layer = copy.deepcopy(getattr(template, f"decoder{li}")).train()
        args = tuple(a.cpu() if torch.is_tensor(a) else a for a in rec["args"])
        mask = rec["attn_mask"].cpu() if rec["attn_mask"] is not None else None
        layer(*args, attn_mask=mask).backward(rec["grad"].cpu())
        cpu = {f"decoder{li}.{k}": p.grad for k, p in layer.named_parameters()}
        errs[f"decoder{li}"] = rel_err({k: card_grads[k] for k in cpu}, cpu)
    return errs


def phase_rtdetr_train_fp32(dev) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b, m = 1, RT_MAX_BOXES
    trainer = rtdetr_trainer(dev, b)
    cpu_trainer = rtdetr_trainer(torch.device("cpu"), b, template=trainer.model)
    batch = rt_train_batch(b, seed=9, dev=dev)
    gen = torch.Generator().manual_seed(10)
    draws = {"augment": augment_draws(b, gen, torch.device("cpu")),
             "denoise": (torch.rand((b, 2 * RT_DN_GROUPS, m, 2), generator=gen) * 2 - 1,
                         torch.rand((b, 2 * RT_DN_GROUPS, m, 2), generator=gen) - 0.5)}
    to_dev = lambda t: t.to(dev)  # noqa: E731
    card_draws = {"augment": {k: to_dev(v) for k, v in draws["augment"].items()},
                  "denoise": tuple(map(to_dev, draws["denoise"]))}
    solved = {}

    def record(real):
        def assign(cost, col_valid=None):
            out = real(cost, col_valid)
            solved.update(cost=cost.cpu().numpy(), assigned=out.cpu().numpy(),
                          valid=col_valid.cpu().numpy())
            return out
        return assign

    before = (deformable_kernel.ms_deform_fwd_launches, deformable_kernel.ms_deform_bwd_launches)
    picked, enc, layer_io = [], {"card": [], "cpu": []}, {}
    with topk_selection(rtdetr_module, record=picked, scores_seen=enc["card"]):
        card = run_train_step(trainer, batch, card_draws, record, layer_io=layer_io)
    torch.cuda.synchronize()
    launches = (deformable_kernel.ms_deform_fwd_launches - before[0],
                deformable_kernel.ms_deform_bwd_launches - before[1])
    replay = {}

    def own_where_defined(real):
        """The CPU's own solve where the card's optimum is unique by more
        than 2·(valid columns)·(largest card-CPU cost difference); the
        card's assignment elsewhere."""
        def assign(cost, col_valid=None):
            own = real(cost, col_valid).numpy()
            delta = float(np.abs(cost.numpy() - solved["cost"]).max())
            defined = np.array([assignment_margin(c, v) > 2 * v.sum() * delta
                                for c, v in zip(solved["cost"], solved["valid"])])
            replay.update(problems=len(defined), well_defined=int(defined.sum()), cost_delta=delta,
                          same_where_defined=bool((own[defined] == solved["assigned"][defined])
                                                  .all()))
            return torch.from_numpy(np.where(defined[:, None], own, solved["assigned"]))
        return assign

    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    # The CPU decodes the card's top-300 queries, whatever its own scores pick.
    cpu_io = {}
    with topk_selection(rtdetr_module, replay=[picked[0].cpu()], scores_seen=enc["cpu"]):
        cpu = run_train_step(cpu_trainer, cpu_batch, draws, own_where_defined, layer_io=cpu_io)
    # How far the two forwards drift apart: the encoder memory, and the
    # queries entering each decoder layer (max |card − cpu|, max |cpu|).
    drift = lambda a, b: [float((a.cpu() - b).abs().max()), float(b.abs().max())]  # noqa: E731
    divergence = {"memory": drift(layer_io[0]["args"][3], cpu_io[0]["args"][3])}
    divergence.update({f"decoder{li}_query_in": drift(layer_io[li]["args"][0],
                                                       cpu_io[li]["args"][0])
                       for li in range(RT_LAYERS)})
    card_scores, cpu_scores = enc["card"][0], enc["cpu"][0]
    score_diff = float((card_scores - cpu_scores).abs().max())
    srt = torch.sort(cpu_scores, dim=-1, descending=True).values[0, : RT_QUERIES + 1]
    selection = {"same_top300": torch.equal(stable_topk(cpu_scores, RT_QUERIES)[1],
                                            picked[0].cpu()),
                 "top300_defined": bool((srt[:-1] - srt[1:]).min() > 2 * score_diff),
                 "enc_scores_max_abs": score_diff, "decoded_queries": "the card's top-300 on both"}

    groups = {}
    for k in cpu["grads"]:
        groups.setdefault(k.split(".")[0], []).append(k)
    step_errs = {g: rel_err({k: card["grads"][k] for k in keys}, {k: cpu["grads"][k] for k in keys})
                 for g, keys in groups.items()}
    layer_errs = decoder_layer_replay(trainer.model, layer_io, card["grads"])
    deform_grads = {k: (bool(torch.isfinite(v).all()), float(v.abs().max()))
                    for k, v in card["grads"].items()
                    if any(n in k for n in ("value_proj", "sampling_offsets", "attention_weights"))}
    rec = {"phase": "rtdetr_train_fp32", "model": "rtdetr r50vd arch=tpu remat", "batch": b,
           "img_hw": [IMG_H, IMG_W], "gt_slots": m, "gt_valid": int(batch["gt_mask"].sum()),
           "decoder_queries": RT_TRAIN_Q,
           "launches_per_step": {"ms_deform_fwd": launches[0], "ms_deform_bwd": launches[1]},
           "loss": {"card": card["metrics"]["loss"], "cpu": cpu["metrics"]["loss"]},
           "metrics_card": card["metrics"], "metrics_cpu": cpu["metrics"], "matching": replay,
           "selection": selection,
           "step_grad_rel_err_by_module": step_errs, "forward_divergence": divergence,
           "decoder_layer_grad_rel_err": layer_errs,
           "tolerance": ("each decoder layer on the card's own inputs and output gradient: "
                         "‖card − cpu‖ ≤ 1e-4·‖cpu‖ over its parameter gradients; the whole "
                         "step's loss rtol 1e-2 (random weights and train-mode batch statistics "
                         "make the decoder chaotic: card-CPU differences grow 2-3x per layer)"),
           "deform_projection_grads_finite_nonzero": all(f and a > 0 for f, a in deform_grads.values()),
           **tf32_state()}
    emit(rec)
    check(launches == (RT_LAYERS, RT_LAYERS),
          f"train step launched ms_deform_fwd / ms_deform_bwd {launches} times, not 6 and 6")
    check(len(deform_grads) == 3 * 2 * RT_LAYERS and rec["deform_projection_grads_finite_nonzero"],
          "value_proj / sampling_offsets / attention_weights gradients finite and non-zero")
    check(replay["same_where_defined"], "card and CPU assignments equal where well defined")
    check(selection["same_top300"] or not selection["top300_defined"],
          "card vs CPU top-300 selection where it is well defined")
    check(abs(rec["loss"]["card"] - rec["loss"]["cpu"]) <= 1e-2 * abs(rec["loss"]["cpu"]),
          "card vs CPU loss")
    check(len(layer_errs) == RT_LAYERS, "every decoder layer replayed")
    for layer, e in layer_errs.items():
        check(e <= 1e-4, f"card vs CPU gradient of {layer} on the card's inputs: {e:.2e}")
    del trainer, cpu_trainer, card, cpu, layer_io, cpu_io
    torch.cuda.empty_cache()
    return rec


class StepSplit:
    """CUDA events around the parts of one ``train_step``: forward (model
    hooks), loss (the loss function), backward (loss end to optimizer
    start), optimizer + EMA (``apply_gradients``); and the host matcher's
    own time (after a synchronize, so that it excludes the forward)."""

    def __init__(self, trainer, state):
        self.events, self.matcher_ms = {}, []
        self.trainer, self.state = trainer, state

    def mark(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[name] = e

    def run(self, batch) -> dict:
        model, real_loss, apply = self.state.model, self.trainer.loss_fn, self.state.apply_gradients
        hooks = [model.register_forward_pre_hook(lambda *a: self.mark("forward0")),
                 model.register_forward_hook(lambda *a: self.mark("forward1"))]

        def loss_fn(*a, **k):
            self.mark("loss0")
            out = real_loss(*a, **k)
            self.mark("loss1")
            return out

        def matcher(real):
            def assign(cost, col_valid=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(cost, col_valid)
                self.matcher_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return assign

        def step_apply(grads):
            self.mark("opt0")
            out = apply(grads)
            self.mark("opt1")
            return out

        self.trainer.loss_fn, self.state.apply_gradients = loss_fn, step_apply
        try:
            with patched(hungarian_module, "batched_lsa_assign", matcher):
                self.mark("step0")
                self.trainer.train_step(self.state, batch)
                self.mark("step1")
            torch.cuda.synchronize()
        finally:
            self.trainer.loss_fn = real_loss
            del self.state.apply_gradients
            for h in hooks:
                h.remove()
        ev = self.events
        span = lambda a, b: ev[a].elapsed_time(ev[b])  # noqa: E731
        return {"step_ms": span("step0", "step1"), "augment_ms": span("step0", "forward0"),
                "forward_ms": span("forward0", "forward1"), "loss_ms": span("loss0", "loss1"),
                "matcher_host_ms": self.matcher_ms[-1], "backward_ms": span("loss1", "opt0"),
                "optimizer_ema_ms": span("opt0", "opt1")}


def recording_bwd(record: list):
    """Keep the arguments of the first B5 call (the last decoder layer's)."""
    def make(real):
        def bwd(*args):
            if not record:
                record.append(args)
            return real(*args)
        return bwd
    return patched(deformable_kernel, "ms_deform_attn_bwd", make)


def recording_fwd(record: list):
    """Keep the arguments of the first B4 call (decoder layer 0's forward)."""
    def make(real):
        def fwd(*args):
            if not record:
                record.append(args)
            return real(*args)
        return fwd
    return patched(deformable_kernel, "_fwd", make)


def phase_rtdetr_train(dev, smi: str) -> "tuple[dict, dict, dict]":
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    trainer = rtdetr_trainer(dev, RT_B)
    state = trainer.init_state()
    batch = rt_train_batch(RT_B, seed=11, dev=dev)

    # The main path: the counts from zero over one train step.
    bwd_args, fwd_args = [], []
    deformable_kernel.ms_deform_fwd_launches = 0
    deformable_kernel.ms_deform_bwd_launches = 0
    with recording_bwd(bwd_args), recording_fwd(fwd_args):
        _, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
    launches = (deformable_kernel.ms_deform_fwd_launches, deformable_kernel.ms_deform_bwd_launches)
    first_loss = float(metrics["loss"])

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: trainer.train_step(state, batch), reps=5, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    splits = [StepSplit(trainer, state).run(batch) for _ in range(3)]
    split = {k: float(np.mean([sp[k] for sp in splits])) for k in splits[0]}
    rec = {"phase": "rtdetr_train", "model": "rtdetr r50vd arch=tpu remat",
           "config": "scripts/train_rtdetr.py:149-173 (B=16, AdamW lr 1e-4, wd 1e-4, "
                     "96 GT slots, HSV + hflip)", "batch": RT_B, "img_hw": [IMG_H, IMG_W],
           "decoder_queries": RT_TRAIN_Q, "step_ms": step_ms, "img_per_s": RT_B * 1000.0 / step_ms,
           "peak_mem_gib": peak_gib, "split": split,
           "launches_per_step": {"ms_deform_fwd": launches[0], "ms_deform_bwd": launches[1]},
           "first_loss": first_loss, "gt_valid": int(batch["gt_mask"].sum()), "gpu": smi,
           **tf32_state()}
    values, levels, loc, attn, g = (a.detach() if torch.is_tensor(a) else a for a in bwd_args[0])
    main = {"shape": {"B": RT_B, "sum_hw": values.shape[1], "NH": values.shape[2],
                      "D": values.shape[3], "L": attn.shape[3], "P": attn.shape[4],
                      "Q": attn.shape[1]},
            "launches": launches[1], **deform_bwd_compare(values, levels, loc, attn, g),
            **deform_bwd_times(values, levels, loc, attn, g)}
    rec["kernel_on_step_inputs"] = main
    # B4 on the step's own forward inputs (decoder layer 0, Q=684).
    v, levels, loc, attn = (a.detach() if torch.is_tensor(a) else a for a in fwd_args[0])
    fwd_main = {"shape": {"B": RT_B, "sum_hw": v.shape[1], "NH": v.shape[2], "D": v.shape[3],
                          "L": attn.shape[3], "P": attn.shape[4], "Q": attn.shape[1]},
                "launches": launches[0], **deform_compare(v, levels, loc, attn),
                **deform_times(v, levels, loc, attn)}
    rec["fwd_kernel_on_step_inputs"] = fwd_main
    del bwd_args, fwd_args, values, v, loc, attn, g, state, trainer, batch
    torch.cuda.empty_cache()

    # Learning check: one fixed batch, B=4, no augmentation, lr 0 then 1e-4.
    trainer4 = rtdetr_trainer(dev, 4, warmup_epochs=0.0, hsv_aug=False, hflip_prob=0.0)
    state4 = trainer4.init_state()
    batch4 = rt_train_batch(4, seed=12, dev=dev)
    losses = [float(trainer4.train_step(state4, batch4)[1]["loss"]) for _ in range(20)]
    rec["learning_check"] = {"batch": 4, "steps": 20, "losses": losses,
                             "first5_mean": float(np.mean(losses[:5])),
                             "last5_mean": float(np.mean(losses[-5:]))}
    del trainer4, state4, batch4
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(rec)
    check(launches == (RT_LAYERS, RT_LAYERS),
          f"training step launched ms_deform_fwd / ms_deform_bwd {launches} times, not 6 and 6")
    check(np.isfinite(first_loss) and np.isfinite(losses).all(), "finite training losses")
    check_deform_bwd(main, "ms_deform_bwd on the training step's inputs")
    check_deform(fwd_main, "ms_deform_fwd on the training step's inputs")
    check(rec["learning_check"]["last5_mean"] < rec["learning_check"]["first5_mean"]
          and losses[-1] < losses[0], "the loss falls over 20 steps on a fixed batch")
    return rec, main, fwd_main


# --------------------------------------------------------------------------
# MoE-YOLO and the fused expert FFN
# --------------------------------------------------------------------------

MOE_E, MOE_K, MOE_CF, MOE_B = 4, 2, 1.25, 128
MOE_WIDTHS = (128, 256, 512)          # MoE-YOLO-s neck widths; h = 2d
MOE_LEVELS = ((IMG_H // 8, IMG_W // 8), (IMG_H // 16, IMG_W // 16), (IMG_H // 32, IMG_W // 32))


def fused_capacity(tokens: int) -> int:
    """MoEFFN's capacity on the fused route (models/moe.py)."""
    return moe_kernels.round_up_capacity(max(int(tokens * MOE_K * MOE_CF / MOE_E), MOE_K))


def ffn_bound(e, c, d, h, dtype) -> "tuple[float, str]":
    """Least time for the fused FFN: the buffer read and the output written
    once, the weights read once, over the memory rate; or the two products'
    4*E*C*d*h flops over the peak of the type (bf16 tensor cores, or fp32
    outside them). Every row of the buffer counts: the kernel's function
    covers the empty ones too."""
    elt = 2 if dtype == torch.bfloat16 else 4
    nbytes = elt * (2 * e * c * d + e * (2 * d * h + h + d))
    flops = 4 * e * c * d * h
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_ffn(buf, w1, b1, w2, b2, capacity):
    """The library yardstick: two cuBLAS ``baddbmm`` with SiLU between, in
    the working dtype. Timed here only; the port never calls it."""
    e = w1.shape[0]
    x = buf.view(e, capacity, -1)
    mid = F.silu(torch.baddbmm(b1, x, w1))
    return torch.baddbmm(b2, mid, w2).view(e * capacity, -1)


def ffn_problem(e, c, d, h, dtype, seed, dev, fill=0.8, weight_scale=None):
    """A capacity buffer whose segments are ``fill`` full (the rest zeros,
    as dispatch leaves them) and Flax-scaled expert weights with small
    random biases, from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    buf = rnd(e, c, d)
    buf[:, int(c * fill):] = 0
    s1 = weight_scale or (e * d) ** -0.5
    s2 = weight_scale or (e * h) ** -0.5
    args = (buf.view(e * c, d), rnd(e, d, h) * s1, rnd(e, 1, h) * 0.1, rnd(e, h, d) * s2,
            rnd(e, 1, d) * 0.1)
    return tuple(t.to(dtype).contiguous() for t in args)


@torch.inference_mode()
def ffn_compare(args, capacity) -> dict:
    """The kernel and the library yardstick against the plain version on
    the same inputs; numbers are returned before any check can raise."""
    got = moe_kernels.moe_ffn_fwd(*args, capacity)
    ref = moe_kernels._ffn_plain(*args, capacity)
    lib = library_ffn(*args, capacity)
    tol = moe_kernels.ffn_tolerance(*args, capacity, ref)
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs()
    rec = {"max_abs_err": float(d.max()), "max_err_over_tolerance": float((d / tol).max()),
           "within_tolerance": bool((d <= tol).all()), "finite": bool(torch.isfinite(got).all()),
           "library_max_abs_err": float((lib.float() - ref.float()).abs().max()),
           "max_abs_ref": float(ref.float().abs().max())}
    del got, ref, lib, tol, d
    return rec


@torch.inference_mode()
def ffn_times(args, capacity) -> dict:
    buf, w1 = args[0], args[1]
    e, d, h = w1.shape
    bound_ms, bound_by = ffn_bound(e, capacity, d, h, buf.dtype)
    kernel_ms = cuda_ms(lambda: moe_kernels.moe_ffn_fwd(*args, capacity), reps=10, warmup=2)
    flops = 4 * e * capacity * d * h
    library_ms = cuda_ms(lambda: library_ffn(*args, capacity), reps=10, warmup=2)
    # kernel_below_library is printed for the reader, not checked: times are noisy.
    return {"kernel_ms": kernel_ms,
            "plain_ms": cuda_ms(lambda: moe_kernels._ffn_plain(*args, capacity), reps=3, warmup=1),
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / kernel_ms, "library_over_kernel": library_ms / kernel_ms,
            "kernel_below_library": kernel_ms < library_ms,
            "kernel_tflops": flops / kernel_ms / 1e9, "flops": flops}


def check_ffn(rec: dict, what: str) -> None:
    check(rec["finite"], f"{what}: finite kernel output")
    check(rec["within_tolerance"], f"{what}: kernel vs plain within tolerance")


def _f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


# float32 inputs in silu_fast's range (csrc/moe_ffn_fwd.cu, silu_fast_ok):
# +0, 2^-60 <= v <= FLT_MAX, -80 <= v <= -2^-60.
SILU_FAST_INPUTS = (1 + _f32_bits(3.4028234663852886e38) - _f32_bits(2.0 ** -60) + 1
                    + _f32_bits(-80.0) - _f32_bits(-(2.0 ** -60)) + 1)


def silu_check(dev) -> dict:
    """The kernel's branch-free SiLU against its exact division over every
    float32 input in the branch-free range (``moe_ffn_silu_check``)."""
    lib = moe_kernels._lib()
    lib.moe_ffn_silu_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.moe_ffn_silu_check.restype = ctypes.c_int
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    err = lib.moe_ffn_silu_check(counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err == 0, f"moe_ffn_silu_check launch: cudaError_t {err}")
    torch.cuda.synchronize()
    return {"mismatches": int(counts[0]), "inputs_checked": int(counts[1])}


def phase_moe_ffn(dev) -> dict:
    cases = {}
    for lvl, ((hh, ww), d) in enumerate(zip(MOE_LEVELS, MOE_WIDTHS)):
        c = fused_capacity(MOE_B * hh * ww)
        cases[f"level{lvl}"] = (torch.bfloat16, MOE_E, c, d, 2 * d, None)
    cases["test_shape_f32"] = (torch.float32, 4, 512, 64, 128, 0.05)
    cases["experts_0_1_3_zeroed"] = (torch.bfloat16, 4, 512, 128, 256, None)
    # The widest MoE-YOLO width (a 64-column block of three), and h off the
    # 64-wide hidden chunks.
    cases["widest_576"] = (torch.bfloat16, 2, 256, 576, 1152, None)
    cases["bf16_partial_tiles"] = (torch.bfloat16, 3, 256, 192, 80, None)
    report = {}
    for seed, (name, (dtype, e, c, d, h, scale)) in enumerate(cases.items()):
        args = ffn_problem(e, c, d, h, dtype, seed, dev, weight_scale=scale)
        if name == "experts_0_1_3_zeroed":
            args[1][[0, 1, 3]] = 0
            args[2].zero_()
            args[4].zero_()
        rec = {"dtype": str(dtype).replace("torch.", ""), "E": e, "C": c, "d": d, "h": h,
               "rows": e * c, **ffn_compare(args, c)}
        if name == "experts_0_1_3_zeroed":
            out = moe_kernels.moe_ffn_fwd(*args, c).view(e, c, d)
            rec["zeroed_experts_max_abs"] = float(out[[0, 1, 3]].float().abs().max())
            rec["expert2_nonzero"] = bool(out[2].float().abs().sum() > 0)
        if name.startswith("level"):
            rec.update(ffn_times(args, c))
        report[name] = rec
        del args
        torch.cuda.empty_cache()
    silu = silu_check(dev)
    emit({"phase": "moe_ffn_fwd", "cases": report, "silu_check": silu})
    check(silu["inputs_checked"] == SILU_FAST_INPUTS and silu["mismatches"] == 0,
          f"branch-free SiLU differs from the exact division: {silu}")
    for name, rec in report.items():
        check_ffn(rec, f"moe_ffn_fwd {name}")
    zeroed = report["experts_0_1_3_zeroed"]
    check(zeroed["zeroed_experts_max_abs"] == 0 and zeroed["expert2_nonzero"],
          "moe_ffn_fwd picks each row tile's own expert")
    return report


def build_moe_yolo(dtype, dev, seed=0):
    """MoE-YOLO-s with random weights from ``seed``; the context bias is
    randomised too (it initialises to zeros), so that the bins matter."""
    gen = torch.Generator().manual_seed(seed)
    model = MoEYoloDetector(num_classes=1, variant="s", num_experts=MOE_E, k=MOE_K,
                            capacity_factor=MOE_CF, dtype=dtype, arch="tpu", generator=gen)
    with torch.no_grad():
        for i in range(3):
            bias = getattr(model, f"moe_level{i}").router.context_bias
            bias.copy_(torch.randn(bias.shape, generator=gen) * 0.5)
    return model.eval().to(dev).to(memory_format=torch.channels_last)


def moe_levels(model):
    return [getattr(model, f"moe_level{i}") for i in range(3)]


def set_route(model, route: str) -> None:
    """``auto``, ``sweep``, or ``fused`` (``sparse`` with each level's own
    ``use_fused_ffn``, the JAX MoEFFN's ``use_pallas_ffn``)."""
    for m in moe_levels(model):
        m.dispatch = "sparse" if route == "fused" else route
        m.use_fused_ffn = route == "fused"


def context_ids(b, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, moe_module.NUM_SOLAR_BINS, (b,), generator=gen).to(dev)


def recording_ffn(record: list):
    """Record the arguments of every fused expert-FFN call (level order)."""
    def make(real):
        def ffn(*args):
            record.append(tuple(a.detach() if torch.is_tensor(a) else a for a in args))
            return real(*args)
        return ffn
    return patched(moe_kernels, "fused_expert_ffn", make)


def router_logits(model):
    logits, handles = [], []
    for m in moe_levels(model):
        handles.append(m.router.register_forward_hook(lambda mod, a, o: logits.append(o.float())))
    return logits, handles


def sweep_problem(t, d, seed, dev):
    """A level's bf16 tokens, a top-2 routing of seeded logits and
    Flax-scaled expert weights with small biases (h = 2d)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
    h = 2 * d
    idx, gates, _, _ = moe_module.route_top_k_dropless(rnd(t, MOE_E) * 1.5, k=MOE_K)
    args = (rnd(t, d), rnd(MOE_E, d, h) * (MOE_E * d) ** -0.5, rnd(MOE_E, 1, h) * 0.1,
            rnd(MOE_E, h, d) * (MOE_E * h) ** -0.5, rnd(MOE_E, 1, d) * 0.1)
    x, w1, b1, w2, b2 = (a.to(torch.bfloat16).contiguous() for a in args)
    return x, idx.contiguous(), gates, w1, b1, w2, b2


def sweep_bound(t, d, h) -> "tuple[float, str]":
    """Least time for one level's sweep: the tokens read and the output
    written once, the weights once; or both products of every expert,
    4*T*E*d*h flops, at the bf16 tensor-core peak."""
    nbytes = 2 * (2 * t * d + MOE_E * (2 * d * h + h + d)) + 12 * t * MOE_K
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * t * MOE_E * d * h / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@torch.inference_mode()
def phase_moe_sweep(dev) -> dict:
    levels = [(MOE_B * hh * ww, d) for (hh, ww), d in zip(MOE_LEVELS, MOE_WIDTHS)]
    report = {}
    for seed, (name, (t, d)) in enumerate([*((f"level{i}", lv) for i, lv in enumerate(levels)),
                                           ("ragged_300", (300, 128))]):
        args = sweep_problem(t, d, seed, dev)
        x, idx, gates, w1, b1, w2, b2 = args
        got = moe_sweep.moe_sweep_fwd(*args)
        ref = moe_sweep._sweep_plain(*args)
        tol = moe_sweep.sweep_tolerance(*args, ref)
        again = moe_sweep.moe_sweep_fwd(*args)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        rec = {"T": t, "d": d, "h": 2 * d, "E": MOE_E, "k": MOE_K,
               "max_abs_err": float(diff.max()),
               "max_err_over_tolerance": float((diff / tol).max()),
               "within_tolerance": bool((diff <= tol).all()),
               "finite": bool(torch.isfinite(got).all()),
               "bitwise_repeat": bool(torch.equal(got.view(torch.int16), again.view(torch.int16))),
               "library_max_abs_err": float(
                   ((x + moe_module.moe_apply_sweep(x, idx, gates, w1, b1, w2, b2)).float()
                    - ref.float()).abs().max())}
        del got, ref, tol, again, diff
        if name.startswith("level"):
            bound_ms, bound_by = sweep_bound(t, d, 2 * d)
            kernel_ms = cuda_ms(lambda: moe_sweep.moe_sweep_fwd(*args), reps=10, warmup=2)
            library_ms = cuda_ms(
                lambda: x + moe_module.moe_apply_sweep(x, idx, gates, w1, b1, w2, b2), reps=5)
            rec.update(kernel_ms=kernel_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bound_share=bound_ms / kernel_ms, library_ms=library_ms,
                       plain_ms=cuda_ms(lambda: moe_sweep._sweep_plain(*args), reps=2, warmup=1),
                       library_over_kernel=library_ms / kernel_ms,
                       kernel_tflops=4 * t * MOE_E * d * 2 * d / kernel_ms / 1e9)
        report[name] = rec
        del args, x, idx, gates, w1, b1, w2, b2
        torch.cuda.empty_cache()
    total = lambda k: float(sum(r[k] for r in report.values() if k in r))  # noqa: E731
    rec = {"phase": "moe_sweep_fwd", "cases": report, "kernel_ms": total("kernel_ms"),
           "plain_ms": total("plain_ms"), "library_ms": total("library_ms"),
           "bound_ms": total("bound_ms"), "bound_share": total("bound_ms") / total("kernel_ms")}
    emit(rec)
    for name, r in report.items():
        check(r["finite"] and r["within_tolerance"], f"moe_sweep_fwd {name}: within tolerance")
        check(r["bitwise_repeat"], f"moe_sweep_fwd {name}: repeats bit for bit")
    return rec


def moe_sweep_entry(rec, launches) -> dict:
    """The ``kernels`` entry of the sweep kernel: the three B=128 levels."""
    levels = [r for name, r in rec["cases"].items() if name.startswith("level")]
    return {
        "name": "moe_sweep_fwd", "route": "cuda",
        "source": "multimodal_moe_torch/csrc/moe_sweep_fwd.cu",
        "replaces": "none (the JAX sweep, models/moe.py:moe_apply_sweep, is XLA's matmuls)",
        "shape": {"E": MOE_E, "k": MOE_K, "levels": [{"T": r["T"], "d": r["d"], "h": r["h"]}
                                                     for r in levels], "dtype": "bfloat16"},
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rec["cases"].values()),
        "ms": rec["kernel_ms"], "kernel_ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": "operations", "library_ms": rec["library_ms"],
        "bound_share": rec["bound_share"],
        "per_level": [{k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_share", "max_abs_err", "max_err_over_tolerance")}
                      for r in levels],
    }


def phase_moe_yolo_fp32(dev) -> "tuple[dict, float]":
    b = 2
    model = build_moe_yolo(torch.float32, dev)
    cpu_model = copy.deepcopy(model).cpu().to(memory_format=torch.contiguous_format)
    images = random_images(b, seed=5, dev=dev)
    ctx = context_ids(b, seed=6, dev=dev)
    tol = lambda ref: 1e-4 + 1e-3 * ref.abs()  # noqa: E731
    rec = {"phase": "moe_yolo_fp32", "model": "moe-yolo-s E=4 k=2 cf=1.25 arch=tpu",
           "batch": b, "img_hw": [IMG_H, IMG_W], "context_ids": ctx.tolist(),
           "tolerance": "|d| <= 1e-4 + 1e-3*|cpu|", "routes": {}, **tf32_state()}
    ok, kernel_err = {}, 0.0
    for route in ("sweep", "fused"):
        set_route(model, route)
        set_route(cpu_model, route)
        picked, ffn_args = [], []
        card_logits, h1 = router_logits(model)
        cpu_logits, h2 = router_logits(cpu_model)
        before = moe_kernels.moe_ffn_fwd_launches
        with torch.inference_mode():
            with topk_selection(moe_module, record=picked), recording_ffn(ffn_args):
                on_card = model(images.float() / 255.0, context_ids=ctx)
            torch.cuda.synchronize()
            launched = moe_kernels.moe_ffn_fwd_launches - before
            # The CPU routes each token to the card's experts, whatever its own
            # logits pick; where they would pick otherwise is counted below.
            with topk_selection(moe_module, replay=[p.cpu() for p in picked]):
                on_cpu = cpu_model(images.cpu().float() / 255.0, context_ids=ctx.cpu())
        for h in h1 + h2:
            h.remove()
        r = {"moe_ffn_fwd_launches": launched, "levels": []}
        for lvl, (lc, lp, p) in enumerate(zip(card_logits, cpu_logits, picked)):
            diff = float((lc.cpu() - lp).abs().max())
            probs = torch.softmax(lp, -1)
            srt = torch.sort(probs, dim=-1, descending=True).values
            close = (srt[:, MOE_K - 1] - srt[:, MOE_K]) <= 2 * diff
            own = moe_module.stable_topk(probs, MOE_K)[1]
            differ = (torch.sort(own, -1).values != torch.sort(p.cpu(), -1).values).any(-1)
            r["levels"].append({"tokens": int(lp.shape[0]), "router_logit_max_abs": diff,
                                "top2_differ": int(differ.sum()),
                                "gap_below_2x_diff": int(close.sum()),
                                "differ_only_where_close": bool((~differ | close).all())})
        errs = {}
        for k in ("box_logits", "cls_logits"):
            d = (on_card[k].cpu() - on_cpu[k]).abs()
            errs[k] = float(d.max())
            ok[f"{route}.{k}"] = bool((d <= tol(on_cpu[k])).all())
        errs["boxes_px"] = float((on_card["boxes"].cpu() - on_cpu["boxes"]).abs().max())
        r.update({"card_vs_cpu_max_abs": errs,
                  "moe_aux_loss": {"card": float(on_card["moe_aux_loss"]),
                                   "cpu": float(on_cpu["moe_aux_loss"])},
                  "expert_load": {"card": on_card["expert_load"].cpu().tolist(),
                                  "cpu": on_cpu["expert_load"].tolist()}})
        if route == "fused":
            r["kernel_on_level0_buffer"] = ffn_compare(ffn_args[0][:5], ffn_args[0][5])
            kernel_err = r["kernel_on_level0_buffer"]["max_abs_err"]
        rec["routes"][route] = r
        del on_card, on_cpu, ffn_args, picked
    emit(rec)
    fused = rec["routes"]["fused"]
    check(fused["moe_ffn_fwd_launches"] == 3,
          f"fused MoE-YOLO forward launched moe_ffn_fwd {fused['moe_ffn_fwd_launches']} times, not 3")
    check(rec["routes"]["sweep"]["moe_ffn_fwd_launches"] == 0, "the sweep route launches no FFN kernel")
    check_ffn(fused["kernel_on_level0_buffer"], "moe_ffn_fwd on level 0's own fp32 buffer")
    for route, r in rec["routes"].items():
        for lvl, lr in enumerate(r["levels"]):
            check(lr["differ_only_where_close"], f"{route} level {lvl}: top-2 differs only at near-ties")
    for k, v in ok.items():
        check(v, f"MoE-YOLO card vs CPU {k}")
    return rec, kernel_err


def phase_moe_yolo_serving(dev, smi: str) -> "tuple[dict, dict]":
    b = MOE_B
    model = build_moe_yolo(torch.bfloat16, dev)
    nms_kw = dict(iou_threshold=IOU, score_threshold=SCORE_THR, max_det=MAX_DET)
    step = make_serving_step(model, pool=POOL, tail="full", **nms_kw)
    images = random_images(b, seed=7, dev=dev)
    ctx = context_ids(b, seed=8, dev=dev)
    x = images.float() / 255.0
    tokens = [b * hh * ww for hh, ww in MOE_LEVELS]
    levels = moe_levels(model)
    rec = {"phase": "moe_yolo_serving", "model": "moe-yolo-s E=4 k=2 cf=1.25 arch=tpu",
           "dtype": "bfloat16", "batch": b, "img_hw": [IMG_H, IMG_W], "pool": POOL,
           "max_det": MAX_DET, "tail": "full", "tokens_per_level": tokens,
           "context_ids_histogram": torch.bincount(ctx, minlength=6).tolist(), "routes": {},
           "gpu": smi, **tf32_state()}
    step_buffers = None

    def forward():
        with torch.inference_mode():
            return model(x, context_ids=ctx)

    for route in ("auto", "fused"):
        set_route(model, route)
        # The main path: the counts from zero over one serving step.
        moe_kernels.moe_ffn_fwd_launches = 0
        moe_sweep.moe_sweep_fwd_launches = 0
        nms_kernel.nms_keep_launches = 0
        dropped, ffn_args = [], []

        def sparse_router(real):
            def route_fn(logits, **kw):
                rd = real(logits, **kw)
                dropped.append(float(1.0 - rd.valid.float().mean()))
                return rd
            return route_fn

        with patched(moe_module, "route_top_k_sparse", sparse_router), recording_ffn(ffn_args):
            res = step(images, ctx)
            torch.cuda.synchronize()
        r = {"resolved_dispatch": [moe_module.resolve_dispatch(m.dispatch, t, MOE_E)
                                   for m, t in zip(levels, tokens)],
             "moe_ffn_fwd_launches": moe_kernels.moe_ffn_fwd_launches,
             "moe_sweep_fwd_launches": moe_sweep.moe_sweep_fwd_launches,
             "nms_keep_launches": nms_kernel.nms_keep_launches,
             "dropped_token_share": dropped or None}
        check(all(bool(torch.isfinite(t).all()) for t in res[:2]), f"finite MoE outputs ({route})")
        check(tuple(res.boxes.shape) == (b, MAX_DET, 4), "MoE NmsResult shape")
        if route == "fused":
            step_buffers = [(a[:5], a[5]) for a in ffn_args]
        del ffn_args

        torch.cuda.reset_peak_memory_stats(dev)
        r["step_ms"] = cuda_ms(lambda: step(images, ctx), reps=5)
        r["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        r["img_per_s"] = b * 1000.0 / r["step_ms"]
        out = forward()
        with torch.inference_mode():
            scores = torch.sigmoid(out["cls_logits"][..., 0])
        r["expert_load"] = out["expert_load"].tolist()
        r["moe_aux_loss"] = float(out["moe_aux_loss"])
        r["forward_ms"] = cuda_ms(forward, reps=5)
        r["tail_ms"] = cuda_ms(lambda: batched_nms(out["boxes"], scores, num_candidates=POOL,
                                                   **nms_kw), reps=10)
        r["forward_split"] = event_split(
            model, forward,
            [(model, "pre"), (model.neck, "post")] + [(m, "post") for m in levels]
            + [(model, "post")],
            ["backbone_neck_ms", "moe_level0_ms", "moe_level1_ms", "moe_level2_ms",
             "head_decode_ms"], reps=3)
        r["valid_out"] = int(res.valid.sum())
        rec["routes"][route] = r
        del out, scores, res
        torch.cuda.empty_cache()

    # The kernel on the fused step's own three level buffers.
    per_level = []
    for (args, c), d in zip(step_buffers, MOE_WIDTHS):
        e, _, h = args[1].shape
        lv = {"E": e, "C": c, "d": d, "h": h, "rows": e * c, **ffn_compare(args, c),
              **ffn_times(args, c)}
        lv["filled_rows"] = int((args[0].abs().amax(-1) > 0).sum())
        per_level.append(lv)
    del step_buffers
    torch.cuda.empty_cache()
    rec["kernel_on_step_buffers"] = per_level
    emit(rec)
    fused, auto = rec["routes"]["fused"], rec["routes"]["auto"]
    check(auto["resolved_dispatch"] == ["sweep"] * 3, f"auto resolves to {auto['resolved_dispatch']}")
    check(fused["moe_ffn_fwd_launches"] == 3,
          f"fused serving step launched moe_ffn_fwd {fused['moe_ffn_fwd_launches']} times, not 3")
    check(auto["moe_ffn_fwd_launches"] == 0, "the auto (sweep) step launches no FFN kernel")
    check(auto["moe_sweep_fwd_launches"] == 3,
          f"auto serving step launched moe_sweep_fwd {auto['moe_sweep_fwd_launches']} times, not 3")
    check(fused["moe_sweep_fwd_launches"] == 0, "the fused (sparse) step launches no sweep kernel")
    for route, r in rec["routes"].items():
        check(r["nms_keep_launches"] >= 1, f"{route} serving step launched nms_keep")
    for lvl, lv in enumerate(per_level):
        check_ffn(lv, f"moe_ffn_fwd on the step's level {lvl} buffer")
    return rec, per_level


def moe_kernel_entry(per_level, launches, errs) -> dict:
    """One ``kernels`` entry for the three launches of a fused step: times
    and bounds summed over the levels, each level beside them."""
    total = lambda k: float(sum(lv[k] for lv in per_level))  # noqa: E731
    ops_ms = sum(lv["bound_ms"] for lv in per_level if lv["bound_by"] == "operations")
    return {
        "name": "moe_ffn_fwd", "route": "cuda",
        "source": "multimodal_moe_torch/csrc/moe_ffn_fwd.cu",
        "replaces": "multimodal_moe_tpu/ops/moe_kernels.py:28 (_ffn_kernel)",
        "shape": {"E": MOE_E, "levels": [{"C": lv["C"], "d": lv["d"], "h": lv["h"]}
                                         for lv in per_level], "dtype": "bfloat16"},
        "launches": launches, "max_abs_err": max(errs),
        "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if ops_ms >= total("bound_ms") / 2 else "bytes",
        "library_ms": total("library_ms"),
        "bound_share": total("bound_ms") / total("kernel_ms"),
        "library_over_kernel": total("library_ms") / total("kernel_ms"),
        "per_level": [{k: lv[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "bound_share", "library_over_kernel",
                                          "kernel_below_library", "max_abs_err",
                                          "max_err_over_tolerance")} for lv in per_level],
    }


# --------------------------------------------------------------------------
# MoE-YOLO and YOLO training, and the grouped GEMM
# --------------------------------------------------------------------------

YOLO_B = 16                  # scripts/train_moe.py / train_yolo.py: batch 16
GMM_LEVEL_TOKENS = tuple(YOLO_B * hh * ww for hh, ww in MOE_LEVELS)   # 219,648 / 54,912 / 13,728


def routed_sizes(tokens: int, seed: int, dev) -> torch.Tensor:
    """Segment sizes of ``tokens``·k rows from a seeded router: random
    logits with a random per-expert bias, top-2 per token (uneven, not an
    equal split), counted on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = (torch.randn(tokens, MOE_E, generator=gen, device=dev)
              + torch.randn(MOE_E, generator=gen, device=dev) * 0.5)
    idx = torch.topk(logits, MOE_K, dim=-1).indices.reshape(-1)
    return torch.bincount(idx, minlength=MOE_E).to(torch.int32)


def gmm_problem(sizes: torch.Tensor, k: int, n: int, dtype, seed: int, dev, rhs_dtype=None):
    """lhs (M, K) and the output gradient g (M, N) ~ N(0, 1), rhs (E, K, N)
    at Flax's LeCun scale; lhs in ``dtype``, rhs in ``rhs_dtype`` (default
    ``dtype``), g float32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = int(sizes.sum())
    lhs = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    rhs = (torch.randn(sizes.shape[0], k, n, generator=gen, device=dev) * k ** -0.5)
    g = torch.randn(m, n, generator=gen, device=dev)
    return lhs, rhs.to(rhs_dtype or dtype), g


def gmm_bound(m, k, n, e, elt_a=4, elt_b=4) -> "tuple[float, str]":
    """Least time for one grouped product (M, K)·(K, N) per group as the
    kernel computes it: the operands and the float32 output moved once over
    the memory rate, or its tensor-core products over the TF32 rate. An
    fp32-accurate product on the tensor cores is three TF32 products of
    2·M·K·N flops each for float32 × float32 (small·big, big·small,
    big·big), two for a bf16 × float32 pair and one for bf16 × bf16 (a bf16
    value is exact in TF32, its small part is zero). The same for the
    transposed product and for tgmm: the same three arrays in other roles."""
    nbytes = elt_a * m * k + elt_b * e * k * n + 4 * m * n
    products = 1 + (elt_a == 4) + (elt_b == 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = products * 2 * m * k * n / PEAK_TF32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def segment_mm(lhs, rhs, offs, out, transpose=False, weight_grad=False):
    """The library yardstick: one cuBLAS ``torch.mm`` per segment into a
    preallocated output, the offsets read on the host beforehand."""
    for g in range(len(offs) - 1):
        a, b = offs[g], offs[g + 1]
        if weight_grad:
            torch.mm(lhs[a:b].T, rhs[a:b], out=out[g])
        elif b > a:
            torch.mm(lhs[a:b], rhs[g].T if transpose else rhs[g], out=out[a:b])
    return out


@torch.inference_mode()
def gmm_compare(lhs, rhs, sizes, g, repeat: bool = False) -> dict:
    """gmm, the transposed gmm (the lhs gradient) and tgmm (the rhs
    gradient) against their plain versions, each element within 2·n·u·Σ|aᵢbᵢ|
    (n the length of its sum, u = 2⁻²⁴), tgmm also per segment; with
    ``repeat``, a second tgmm launch must equal the first bitwise. The
    numbers are returned before any check can raise."""
    offs = [0] + np.cumsum(sizes.tolist()).tolist()
    lf, rf = lhs.float(), rhs.float()
    rec = {}
    runs = {
        "gmm": (lambda: gmm_kernel.gmm(lhs, rhs, sizes),
                lambda: gmm_kernel.gmm_plain(lhs, rhs, sizes), lhs.shape[1],
                lambda i, sl: lf[sl].abs() @ rf[i].abs()),
        "gmm_transposed": (lambda: gmm_kernel.gmm(g, rhs, sizes, transpose_rhs=True),
                           lambda: gmm_kernel.gmm_plain(g, rhs, sizes, True), g.shape[1],
                           lambda i, sl: g[sl].abs() @ rf[i].abs().T),
    }
    for name, (kern, plain, length, absprod) in runs.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        worst, ok = 0.0, bool(torch.isfinite(got).all())
        for i in range(len(offs) - 1):
            sl = slice(offs[i], offs[i + 1])
            if sl.stop > sl.start:
                bound = 2 * length * U32 * absprod(i, sl)
                d = (got[sl] - ref[sl]).abs()
                worst = max(worst, float(torch.where(d == 0, 0.0, d / bound).max()))
                ok &= bool((d <= bound).all())
        rec[name] = {"max_abs_err": float((got - ref).abs().max()), "err_over_bound": worst,
                     "within_bound": ok, "rows_past_groups_zero": bool(
                         got[offs[-1]:].abs().sum() == 0)}
        del got, ref
    got, ref = gmm_kernel.tgmm(lhs, g, sizes), gmm_kernel.tgmm_plain(lhs, g, sizes)
    torch.cuda.synchronize()
    worst, ok = 0.0, bool(torch.isfinite(got).all())
    per_group = []
    for i in range(len(offs) - 1):
        sl = slice(offs[i], offs[i + 1])
        if sl.stop == sl.start:
            ok &= bool(got[i].abs().max() == 0)     # an empty group: zeros
            per_group.append({"rows": 0, "zero": bool(got[i].abs().max() == 0)})
            continue
        bound = 2 * (sl.stop - sl.start) * U32 * (lf[sl].abs().T @ g[sl].abs())
        d = (got[i] - ref[i]).abs()
        seg = float(torch.where(d == 0, 0.0, d / bound).max())
        per_group.append({"rows": sl.stop - sl.start, "err_over_bound": seg})
        worst = max(worst, seg)
        ok &= bool((d <= bound).all())
    rec["tgmm"] = {"max_abs_err": float((got - ref).abs().max()), "err_over_bound": worst,
                   "within_bound": ok, "per_group": per_group}
    if repeat:
        rec["tgmm"]["bitwise_repeatable"] = bool(torch.equal(got, gmm_kernel.tgmm(lhs, g, sizes)))
    return rec


@torch.inference_mode()
def gmm_times(lhs, rhs, sizes, g) -> dict:
    """Per launch: kernel, plain version, library yardstick and bound, for
    each of the three products."""
    (m, k), n, e = lhs.shape, rhs.shape[2], rhs.shape[0]
    offs = [0] + np.cumsum(sizes.tolist()).tolist()
    out_f = torch.empty(m, n, device=lhs.device)
    out_t = torch.empty(m, k, device=lhs.device)
    out_w = torch.empty(e, k, n, device=lhs.device)
    lf, rf = lhs.float(), rhs.float()
    elt_l, elt_r, elt_g = lhs.element_size(), rhs.element_size(), g.element_size()
    cases = {
        "gmm": (lambda: gmm_kernel.gmm(lhs, rhs, sizes),
                lambda: gmm_kernel.gmm_plain(lhs, rhs, sizes),
                lambda: segment_mm(lf, rf, offs, out_f), gmm_bound(m, k, n, e, elt_l, elt_r)),
        "gmm_transposed": (lambda: gmm_kernel.gmm(g, rhs, sizes, transpose_rhs=True),
                           lambda: gmm_kernel.gmm_plain(g, rhs, sizes, True),
                           lambda: segment_mm(g, rf, offs, out_t, transpose=True),
                           gmm_bound(m, n, k, e, elt_g, elt_r)),
        "tgmm": (lambda: gmm_kernel.tgmm(lhs, g, sizes),
                 lambda: gmm_kernel.tgmm_plain(lhs, g, sizes),
                 lambda: segment_mm(lf, g, offs, out_w, weight_grad=True),
                 gmm_bound(m, k, n, e, elt_l, elt_g)),
    }
    rec = {}
    for name, (kern, plain, lib, (bound_ms, bound_by)) in cases.items():
        kernel_ms = cuda_ms(kern, reps=5, warmup=1)
        rec[name] = {"kernel_ms": kernel_ms, "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                     "library_ms": cuda_ms(lib, reps=5, warmup=1), "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
                     "kernel_tflops": 2 * m * k * n / kernel_ms / 1e9}
    return rec


@torch.inference_mode()
def tgmm_passes(lhs, g, sizes) -> dict:
    """The device time of tgmm's two passes a launch (``torch.profiler``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            gmm_kernel.tgmm(lhs, g, sizes)
        torch.cuda.synchronize()
    passes = {"partial_ms": 0.0, "reduce_ms": 0.0}
    for name, ms, _ in device_rows(prof):
        for key in ("partial", "reduce"):
            if f"tgmm_{key}_kernel" in name:
                passes[f"{key}_ms"] += ms / 3
    return passes


@torch.inference_mode()
def gmm_nan_check(dev) -> dict:
    """A NaN made on the card (0/0, the canonical NaN) in lhs and in the
    output gradient, in a segment on the tensor-core path and in one on the
    exact short-sum path, reaches the same outputs of the three products as
    in their plain versions."""
    sizes = torch.tensor([3000, 5, 0, 1200], dtype=torch.int32, device=dev)
    lhs, rhs, g = gmm_problem(sizes, 128, 64, torch.float32, 70, dev)
    nan = torch.zeros((), device=dev) / torch.zeros((), device=dev)
    lhs[10, 3], lhs[3002, 70], g[500, 9], g[3001, 40] = nan, nan, nan, nan
    pairs = {"gmm": (gmm_kernel.gmm(lhs, rhs, sizes), gmm_kernel.gmm_plain(lhs, rhs, sizes)),
             "gmm_transposed": (gmm_kernel.gmm(g, rhs, sizes, transpose_rhs=True),
                                gmm_kernel.gmm_plain(g, rhs, sizes, True)),
             "tgmm": (gmm_kernel.tgmm(lhs, g, sizes), gmm_kernel.tgmm_plain(lhs, g, sizes))}
    torch.cuda.synchronize()
    return {name: {"nan_outputs": int(torch.isnan(ref).sum()),
                   "same_nan_positions": bool(torch.isnan(ref).any())
                   and bool(torch.equal(torch.isnan(got), torch.isnan(ref)))}
            for name, (got, ref) in pairs.items()}


def check_gmm(rec: dict, what: str) -> None:
    for name in ("gmm", "gmm_transposed", "tgmm"):
        check(rec[name]["within_bound"], f"{what}: {name} kernel vs plain within 2·n·u·Σ|ab|")
    for name in ("gmm", "gmm_transposed"):
        check(rec[name]["rows_past_groups_zero"], f"{what}: {name} rows past the groups are zero")


def phase_gmm_kernel(dev) -> dict:
    """The three products at the six level shapes of the B=16 training step
    (float32, routed sizes), then one bf16 shape, one mixed bf16 × float32
    shape and the edge cases: an empty group, all rows in one group, a row
    count that is no multiple of the tile, tgmm segments at the edge of the
    exact short-sum path (1, 3, 15, 16, 17 rows), K and N below it, and NaN
    inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = []
    for lvl, (t, d) in enumerate(zip(GMM_LEVEL_TOKENS, MOE_WIDTHS)):
        sizes = routed_sizes(t, seed=40 + lvl, dev=dev)
        shapes += [(f"level{lvl}_w1", sizes, d, 2 * d, torch.float32, None),
                   (f"level{lvl}_w2", sizes, 2 * d, d, torch.float32, None)]
    i32 = functools.partial(torch.tensor, dtype=torch.int32, device=dev)
    short = gmm_kernel.SHORT_REDUCTION
    edges = [
        ("level1_w1_bf16", routed_sizes(GMM_LEVEL_TOKENS[1], 41, dev), 256, 512, torch.bfloat16,
         None),
        ("level1_w1_mixed", routed_sizes(GMM_LEVEL_TOKENS[1], 41, dev), 256, 512,
         torch.bfloat16, torch.float32),
        ("zero_group", i32([5000, 0, 3000, 1234]), 128, 256, torch.float32, None),
        ("collapse", i32([0, 0, 8192, 0]), 128, 256, torch.float32, None),
        ("ragged_rows", i32([1000, 37, 500, 4]), 256, 128, torch.float32, None),
        ("short_segments", i32([1, 3, short - 1, short, short + 1, 2000]), 256, 128,
         torch.float32, None),
        ("short_k_and_n", i32([700, 0, 300, 24]), short - 4, short - 8, torch.float32, None),
    ]
    report = {}
    for seed, (name, sizes, k, n, dtype, rhs_dtype) in enumerate(shapes + edges):
        lhs, rhs, g = gmm_problem(sizes, k, n, dtype, 50 + seed, dev, rhs_dtype)
        rec = {"M": int(lhs.shape[0]), "K": k, "N": n, "E": int(sizes.shape[0]),
               "sizes": sizes.tolist(), "dtype": str(dtype).replace("torch.", ""),
               "rhs_dtype": str(rhs.dtype).replace("torch.", ""),
               **gmm_compare(lhs, rhs, sizes, g, repeat=name.startswith("level0"))}
        if name.startswith("level") and dtype == torch.float32:
            for kname, t in gmm_times(lhs, rhs, sizes, g).items():
                rec[kname].update(t)
            rec["tgmm"]["passes"] = tgmm_passes(lhs, g, sizes)
        report[name] = rec
        del lhs, rhs, g
        torch.cuda.empty_cache()
    nan = gmm_nan_check(dev)
    emit({"phase": "gmm_kernel",
          "tolerance": "each element within 2·n·u·Σ|aᵢbᵢ|, u = 2^-24, n = K (gmm), N "
                       "(transposed), the segment length (tgmm); TF32 off",
          "short_reduction": short, "cases": report, "nan": nan, **tf32_state()})
    for name, rec in nan.items():
        check(rec["same_nan_positions"], f"gmm nan: {name} NaN outputs as in the plain version")
    for name, rec in report.items():
        check_gmm(rec, f"gmm {name}")
        if "bitwise_repeatable" in rec["tgmm"]:
            check(rec["tgmm"]["bitwise_repeatable"], f"gmm {name}: two tgmm launches equal")
    return report


def gmm_kernel_entries(report: dict, launches: dict) -> list:
    """The ``kernels`` entries of csrc/gmm.cu: each product summed over the
    six launches of a training step (three levels × two FFN products)."""
    levels = [r for name, r in report.items()
              if name.startswith("level") and "kernel_ms" in r["gmm"]]
    replaces = {"gmm": "multimodal_moe_tpu/models/moe.py:281,285 (megablox gmm in moe_apply_gmm)",
                "gmm_transposed": "multimodal_moe_tpu/models/moe.py:281,285 (megablox gmm VJP: "
                                  "gmm with transpose_rhs)",
                "tgmm": "multimodal_moe_tpu/models/moe.py:281,285 (megablox gmm VJP: tgmm)"}
    entries = []
    for name, rep in replaces.items():
        total = lambda key: float(sum(r[name][key] for r in levels))  # noqa: E731
        ops_ms = sum(r[name]["bound_ms"] for r in levels if r[name]["bound_by"] == "operations")
        entries.append({
            "name": name, "route": "cuda", "source": "multimodal_moe_torch/csrc/gmm.cu",
            "replaces": rep, "launches": launches[name],
            "max_abs_err": max(r[name]["max_abs_err"] for r in report.values()),
            "max_err_over_bound": max(r[name]["err_over_bound"] for r in report.values()),
            "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_ms >= total("bound_ms") / 2 else "bytes",
            "bound_share": total("bound_ms") / total("kernel_ms"),
            "library_ms": total("library_ms"),
            "per_launch": [{"M": r["M"], "K": r["K"], "N": r["N"],
                            **{k: r[name][k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                                        "bound_ms", "bound_by", "bound_share",
                                                        "kernel_tflops")}}
                           for r in levels],
        })
    return entries


def yolo_trainer(dev, b: int, moe: bool = True, dispatch: str = "gmm", template=None,
                 mesh=None, **cfg_kw) -> DetectionTrainer:
    """scripts/train_moe.py's model and trainer (MoE-YOLO-s, E=4, k=2, cf
    1.25, ``moe_yolo_loss``) or scripts/train_yolo.py's (YOLO-s, the
    trainer's default ``yolo_loss``), float32, with DetTrainConfig's
    defaults (SGD-Nesterov, lr0 0.01, momentum 0.937, wd 5e-4, 3 warm-up
    epochs, HSV jitter + flips); random weights from seed 0."""
    if template is None:
        gen = torch.Generator().manual_seed(0)
        template = (MoEYoloDetector(num_classes=1, variant="s", num_experts=MOE_E, k=MOE_K,
                                    capacity_factor=MOE_CF, dispatch=dispatch, generator=gen)
                    if moe else YoloDetector(num_classes=1, variant="s", generator=gen))
    cfg = DetTrainConfig(**{**dict(variant="s", img_h=IMG_H, img_w=IMG_W, batch=b), **cfg_kw})
    kw = {"loss_fn": moe_yolo_loss} if moe else {}
    return DetectionTrainer(template, cfg, steps_per_epoch=RT_STEPS_PER_EPOCH, device=dev,
                            mesh=mesh, **kw)


def yolo_train_batch(b: int, seed: int, dev) -> dict:
    """``rt_train_batch``'s frames and 96 ground-truth slots, and one
    seeded solar bin per frame."""
    return {**rt_train_batch(b, seed, dev), "solar_bin": context_ids(b, seed + 1, dev)}


def moe_level_io(model, store: dict) -> list:
    """Hooks that keep each MoE level's inputs and its output's gradient."""
    def keep(i):
        def hook(module, args, out):
            rec = store.setdefault(i, {})
            rec["args"] = tuple(a.detach() for a in args)
            out[0].register_hook(lambda g: rec.update(grad=g.detach()))
        return hook
    return [m.register_forward_hook(keep(i)) for i, m in enumerate(moe_levels(model))]


def moe_level_replay(template, io: dict, picks: list, card_grads: dict) -> dict:
    """Each MoE level of the card's step again on the CPU, on the card's
    own inputs, expert choice and output gradient (the level's share of
    the aux loss included): its parameter gradients (gmm, transposed gmm
    and tgmm on the card, the plain versions here) against the card's."""
    errs = {}
    for i, rec in sorted(io.items()):
        level = copy.deepcopy(moe_levels(template)[i]).train()
        tokens, ctx = (a.cpu() for a in rec["args"])
        with topk_selection(moe_module, replay=[picks[i].cpu()]):
            out, aux = level(tokens, ctx)
        ((out * rec["grad"].cpu()).sum() + aux["moe_aux_loss"] / 3).backward()
        cpu = {f"moe_level{i}.{k}": p.grad for k, p in level.named_parameters()}
        errs[f"moe_level{i}"] = rel_err({k: card_grads[k] for k in cpu}, cpu)
    return errs


def phase_moe_yolo_train_fp32(dev) -> dict:
    """One train step of MoE-YOLO-s on ``gmm`` at B=1, card against CPU,
    TF32 off, with the same weights, batch and augmentation draws."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 1
    trainer = yolo_trainer(dev, b)
    cpu_trainer = yolo_trainer(torch.device("cpu"), b, template=trainer.model)
    batch = yolo_train_batch(b, seed=13, dev=dev)
    draws = {"augment": augment_draws(b, torch.Generator().manual_seed(14), torch.device("cpu"))}
    card_draws = {"augment": {k: v.to(dev) for k, v in draws["augment"].items()}}
    assigned = []

    def record(real):
        def assign(*args):
            out = real(*args)
            assigned.append(out)
            return out
        return assign

    before = (gmm_kernel.gmm_launches, gmm_kernel.tgmm_launches)
    picks, io = [], {}
    with topk_selection(moe_module, record=picks), patched(tal_module, "assign_targets", record):
        card = run_train_step(trainer, batch, card_draws, layer_io=io, io_hooks=moe_level_io)
    torch.cuda.synchronize()
    launches = {"gmm": gmm_kernel.gmm_launches - before[0],
                "tgmm": gmm_kernel.tgmm_launches - before[1]}

    # The CPU takes the card's expert choice and assignment, and counts
    # where its own would differ.
    differ = {"tokens_top2": [], "anchors_fg": 0, "anchors_fg_card": 0}
    card_picks = [p.cpu() for p in picks]

    def replay_select(real):
        def select(scores, k):
            own = real(scores, k)[1]
            idx = card_picks[len(differ["tokens_top2"])]
            differ["tokens_top2"].append(int((torch.sort(own, -1).values
                                              != torch.sort(idx, -1).values).any(-1).sum()))
            return torch.gather(scores, 1, idx), idx
        return select

    def replay_assign(real):
        def assign(*args):
            own = real(*args)
            ref = tal_module.AssignResult(*(t.cpu() for t in assigned[0]))
            differ["anchors_fg"] = int((own.fg_mask != ref.fg_mask).sum())
            differ["anchors_fg_card"] = int(ref.fg_mask.sum())
            return ref
        return assign

    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    with patched(moe_module, "stable_topk", replay_select), \
            patched(tal_module, "assign_targets", replay_assign):
        cpu = run_train_step(cpu_trainer, cpu_batch, draws)
    level_errs = moe_level_replay(trainer.model, io, picks, card["grads"])
    groups = {}
    for k in cpu["grads"]:
        groups.setdefault(k.split(".")[0], []).append(k)
    step_errs = {g: rel_err({k: card["grads"][k] for k in keys}, {k: cpu["grads"][k] for k in keys})
                 for g, keys in groups.items()}
    rec = {"phase": "moe_yolo_train_fp32", "model": "moe-yolo-s E=4 k=2 cf=1.25 dispatch=gmm",
           "batch": b, "img_hw": [IMG_H, IMG_W], "gt_valid": int(batch["gt_mask"].sum()),
           "launches_per_step": launches, "loss": {"card": card["metrics"]["loss"],
                                                   "cpu": cpu["metrics"]["loss"]},
           "metrics_card": card["metrics"], "metrics_cpu": cpu["metrics"],
           "replayed_from_card": differ, "step_grad_rel_err_by_module": step_errs,
           "moe_level_grad_rel_err": level_errs,
           "tolerance": ("the loss rtol 1e-3 (the CPU replays the card's expert choice and "
                         "assignment; train-mode batch statistics sum in other orders); each "
                         "MoE level on the card's own inputs, expert choice and output gradient: "
                         "‖card − cpu‖ ≤ 1e-4·‖cpu‖ over its parameter gradients"),
           **tf32_state()}
    emit(rec)
    check(launches == {"gmm": 12, "tgmm": 6},
          f"MoE-YOLO train step launched gmm / tgmm {launches}, not 12 and 6")
    check(abs(rec["loss"]["card"] - rec["loss"]["cpu"]) <= 1e-3 * abs(rec["loss"]["cpu"]),
          "card vs CPU loss")
    check(len(level_errs) == 3, "every MoE level replayed")
    for level, e in level_errs.items():
        check(e <= 1e-4, f"card vs CPU gradient of {level} on the card's inputs: {e:.2e}")
    del trainer, cpu_trainer, card, cpu, io
    torch.cuda.empty_cache()
    return rec


class YoloStepSplit:
    """CUDA events around the parts of one YOLO ``train_step``: augment,
    forward (trunk to the neck's output, each MoE level, head and decode),
    loss with the TAL assignment inside it, backward, optimizer + EMA; the
    forward gmm launches are read when the loss starts."""

    def __init__(self, trainer, state):
        self.trainer, self.state, self.events = trainer, state, {}
        self.forward_gmm = None

    def mark(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[name] = e

    def run(self, batch) -> dict:
        model, real_loss, apply = self.state.model, self.trainer.loss_fn, self.state.apply_gradients
        levels = moe_levels(model) if hasattr(model, "moe_level0") else []
        hooks = [model.register_forward_pre_hook(lambda *a: self.mark("forward0")),
                 model.neck.register_forward_hook(lambda *a: self.mark("trunk1")),
                 model.register_forward_hook(lambda *a: self.mark("forward1"))]
        hooks += [m.register_forward_hook(lambda *a, i=i: self.mark(f"level{i}"))
                  for i, m in enumerate(levels)]
        start = gmm_kernel.gmm_launches

        def loss_fn(*a, **k):
            self.forward_gmm = gmm_kernel.gmm_launches - start
            self.mark("loss0")
            out = real_loss(*a, **k)
            self.mark("loss1")
            return out

        def timed_assign(real):
            def assign(*a):
                self.mark("assign0")
                out = real(*a)
                self.mark("assign1")
                return out
            return assign

        def step_apply(grads):
            self.mark("opt0")
            out = apply(grads)
            self.mark("opt1")
            return out

        self.trainer.loss_fn, self.state.apply_gradients = loss_fn, step_apply
        try:
            with patched(tal_module, "assign_targets", timed_assign):
                self.mark("step0")
                self.trainer.train_step(self.state, batch)
                self.mark("step1")
            torch.cuda.synchronize()
        finally:
            self.trainer.loss_fn = real_loss
            del self.state.apply_gradients
            for h in hooks:
                h.remove()
        ev = self.events
        span = lambda a, b: ev[a].elapsed_time(ev[b])  # noqa: E731
        out = {"step_ms": span("step0", "step1"), "augment_ms": span("step0", "forward0"),
               "forward_ms": span("forward0", "forward1"), "trunk_ms": span("forward0", "trunk1")}
        prev = "trunk1"
        for i in range(len(levels)):
            out[f"moe_level{i}_ms"] = span(prev, f"level{i}")
            prev = f"level{i}"
        out["head_decode_ms"] = span(prev, "forward1")
        out.update({"loss_ms": span("loss0", "loss1"), "assign_ms": span("assign0", "assign1"),
                    "backward_ms": span("loss1", "opt0"), "optimizer_ema_ms": span("opt0", "opt1")})
        return out


def profile_step(trainer, state, batch, top: int = 12) -> dict:
    """The ``top`` kernels of one train step by their time on the card
    (``torch.profiler``), in ms, and the sum of all kernel time in the step
    (kernels on one stream: the card's busy time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return {"kernel_ms_total": sum(ms for _, ms, _ in rows),
            "top_kernels": [{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:top]]}


def train_headline(trainer, batch, dev, reps: int = 5) -> dict:
    """Step ms over ``reps`` steps after one warm-up, img/s, peak memory,
    the mean split of three instrumented steps and a profile of one more
    step, on one state."""
    state = trainer.init_state()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: trainer.train_step(state, batch), reps=reps, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    splits = []
    for _ in range(3):
        sp = YoloStepSplit(trainer, state)
        splits.append({**sp.run(batch), "forward_gmm_launches": sp.forward_gmm})
    split = {k: float(np.mean([s[k] for s in splits])) for k in splits[0]}
    b = batch["image"].shape[0]
    return {"step_ms": step_ms, "img_per_s": b * 1000.0 / step_ms, "peak_mem_gib": peak_gib,
            "split": split, "profile": profile_step(trainer, state, batch)}


def phase_moe_yolo_train(dev, smi: str) -> dict:
    """The slice's headline: the B=16 step of scripts/train_moe.py on
    ``dispatch="gmm"``, TF32 on; the same step on ``auto``; then a 20-step
    learning check on one fixed batch."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    batch = yolo_train_batch(YOLO_B, seed=15, dev=dev)
    rec = {"phase": "moe_yolo_train", "model": "moe-yolo-s E=4 k=2 cf=1.25 arch=tpu float32",
           "config": "scripts/train_moe.py:151-172 (B=16, SGD-Nesterov lr0 0.01, 96 GT slots, "
                     "HSV + hflip, one solar bin a frame)", "batch": YOLO_B,
           "img_hw": [IMG_H, IMG_W], "tokens_per_level": list(GMM_LEVEL_TOKENS),
           "gt_valid": int(batch["gt_mask"].sum()), "gpu": smi, "dispatch": {}, **tf32_state()}
    for dispatch in ("gmm", "auto"):
        trainer = yolo_trainer(dev, YOLO_B, dispatch=dispatch)
        state = trainer.init_state()
        # The main path: the counts from zero over one train step (the
        # forward's gmm launches read when the loss starts).
        real_loss, seen = trainer.loss_fn, {}

        def loss_fn(*a, **k):
            seen["gmm_forward"] = gmm_kernel.gmm_launches
            return real_loss(*a, **k)

        trainer.loss_fn = loss_fn
        gmm_kernel.gmm_launches = gmm_kernel.tgmm_launches = 0
        _, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        trainer.loss_fn = real_loss
        r = {"resolved_dispatch": [moe_module.resolve_dispatch(dispatch, t, MOE_E)
                                   for t in GMM_LEVEL_TOKENS],
             "launches_per_step": {"gmm": gmm_kernel.gmm_launches,
                                   "tgmm": gmm_kernel.tgmm_launches,
                                   "gmm_forward": seen["gmm_forward"]},
             "first_step_metrics": {k: float(v) for k, v in metrics.items()}}
        del state
        r.update(train_headline(trainer, batch, dev))
        rec["dispatch"][dispatch] = r
        del trainer
        torch.cuda.empty_cache()

    # Learning check: one fixed batch, B=4, no augmentation, SGD-Nesterov at
    # a flat lr 1e-3 from step 1 (at lr0 0.01 without the 3-epoch warmup a
    # random-weight YOLO overshoots within 20 steps).
    trainer4 = yolo_trainer(dev, 4, warmup_epochs=0.0, lr0=1e-3, lrf=1.0, hsv_aug=False,
                            hflip_prob=0.0)
    state4 = trainer4.init_state()
    batch4 = yolo_train_batch(4, seed=16, dev=dev)
    losses = [float(trainer4.train_step(state4, batch4)[1]["loss"]) for _ in range(20)]
    rec["learning_check"] = {"batch": 4, "steps": 20, "dispatch": "gmm", "lr": 1e-3,
                             "losses": losses, "first5_mean": float(np.mean(losses[:5])),
                             "last5_mean": float(np.mean(losses[-5:]))}
    del trainer4, state4, batch4
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(rec)
    gmm, auto = rec["dispatch"]["gmm"], rec["dispatch"]["auto"]
    check(gmm["launches_per_step"] == {"gmm": 12, "tgmm": 6, "gmm_forward": 6},
          f"the gmm step launched gmm / tgmm {gmm['launches_per_step']}, not 12 (6 in the "
          "forward) and 6")
    check(auto["resolved_dispatch"] == ["sweep"] * 3,
          f"auto resolves to {auto['resolved_dispatch']}")
    check(auto["launches_per_step"] == {"gmm": 0, "tgmm": 0, "gmm_forward": 0},
          "the auto (sweep) step launches no gmm")
    for d, r in rec["dispatch"].items():
        check(all(np.isfinite(v) for v in r["first_step_metrics"].values()), f"finite {d} metrics")
    check(np.isfinite(losses).all() and rec["learning_check"]["last5_mean"]
          < rec["learning_check"]["first5_mean"] and losses[-1] < losses[0],
          "the loss falls over 20 steps on a fixed batch")
    return rec


def phase_yolo_train(dev, smi: str) -> dict:
    """The B=16 YOLO-s step of scripts/train_yolo.py (the trainer's default
    yolo_loss), TF32 on."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    batch = yolo_train_batch(YOLO_B, seed=17, dev=dev)
    trainer = yolo_trainer(dev, YOLO_B, moe=False)
    state = trainer.init_state()
    _, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    rec = {"phase": "yolo_train", "model": "yolo-s arch=tpu float32",
           "config": "scripts/train_yolo.py (B=16, SGD-Nesterov lr0 0.01, 96 GT slots, "
                     "HSV + hflip)",
           "batch": YOLO_B, "img_hw": [IMG_H, IMG_W], "loss_fn": trainer.loss_fn.__name__,
           "first_step_metrics": {k: float(v) for k, v in metrics.items()}, "gpu": smi,
           **tf32_state()}
    del state
    rec.update(train_headline(trainer, batch, dev))
    del trainer, batch
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(rec)
    check(rec["loss_fn"] == "yolo_loss", "YOLO trains with the default yolo_loss")
    check(all(np.isfinite(v) for v in rec["first_step_metrics"].values()), "finite YOLO metrics")
    return rec


# --------------------------------------------------------------------------
# int8 PTQ serving: calibration, folding and the int8 forwards on the card
# --------------------------------------------------------------------------

INT8_CALIB_BATCHES, INT8_CALIB_B = 2, 4   # seeded calibration frames (RT-DETR: B=2)
INT8_B = 128                              # the headlines (MoE: MOE_B)
INT8_CONV_TIME_B = 32                     # the per-shape conv timings
# The card's int8 logits must be at least this many times closer to the
# CPU's (mean |d|) than the CPU's int8 logits are to its fp logits, the
# relation tests/_torch_int8.py holds the port to against JAX.
INT8_CLOSER = 20.0
# Codes one apart allowed between the card's and the CPU's epilogue on the
# same int32 accumulators (their sigmoids may round one ulp apart).
INT8_LOCAL_SHARE = 1e-4
INT8_RANGES = (("int8.im2col", int8_conv, "im2col"), ("int8.int_mm", int8_conv, "int_mm"),
               ("int8.int_mm", moe_module, "int_mm"),
               ("int8.epilogue", layers_module, "apply_i8_epilogue"))


@contextlib.contextmanager
def epilogue_mode(mode: str):
    """``MMOE_I8_EPILOGUE=mode`` for the duration."""
    old = os.environ.get("MMOE_I8_EPILOGUE")
    os.environ["MMOE_I8_EPILOGUE"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["MMOE_I8_EPILOGUE"]
        else:
            os.environ["MMOE_I8_EPILOGUE"] = old


def calib_batches(n: int, b: int, seed: int, dev) -> list:
    """``n`` seeded batches of ``b`` normalized frames on the card."""
    return [random_images(b, seed=seed + i, dev=dev).float() / 255.0 for i in range(n)]


def quantized(model_fp, model_q, batches, **kw):
    """Calibrate ``model_fp`` on the card over ``batches``, fold its weights
    into ``model_q``'s quant tree and load ``model_q`` (on the card) with it
    and the fp islands' weights."""
    t0 = time.perf_counter()
    tree = quant.quantize_detector(model_fp, model_q, batches, **kw)
    quant.load_serving(model_q, quant.merge_serving_variables(tree, model_fp.state_dict()))
    torch.cuda.synchronize()
    return model_q.eval(), time.perf_counter() - t0


def recording_convs(record: list):
    """Record the arguments of every int8 conv of a forward."""
    stack = contextlib.ExitStack()

    def make(real):
        def conv(q, w_q, stride=1, padding=0, **kw):
            record.append((q, w_q, stride, padding))
            return real(q, w_q, stride, padding, **kw)
        return conv

    for mod in (layers_module, yolo_module):
        stack.enter_context(patched(mod, "int8_conv2d", make))
    return stack


def conv_shapes(record: list) -> list:
    """The distinct conv shapes of a recorded forward, with their call counts
    and one recorded input each."""
    shapes: dict = {}
    for q, w, s, p in record:
        key = (tuple(q.shape), tuple(w.shape), s, p)
        if key in shapes:
            shapes[key][-1] += 1
        else:
            shapes[key] = [q, w, s, p, 1]
    return list(shapes.values())


def int8_conv_check(model_q, images) -> list:
    """``int8_conv2d`` (``torch._int_mm``) against its float64 version at
    every distinct conv shape of one forward, on that forward's own codes."""
    record = []
    with recording_convs(record), torch.inference_mode():
        model_q(images.float() / 255.0)
    rows = []
    for q, w, s, p, calls in conv_shapes(record):
        got = int8_conv.int8_conv2d(q, w, s, p)
        ref = int8_conv.int8_conv2d_plain(q, w, s, p)
        k = w.shape[1] * w.shape[2] * w.shape[3]
        rows.append({"input": list(q.shape), "weight": list(w.shape), "stride": s,
                     "calls": calls, "K": k, "N": w.shape[0], "bitwise": torch.equal(got, ref),
                     "max_abs_err": float((got - ref).abs().max())})
    torch.cuda.synchronize()
    return rows


def int8_conv_times(rows: list, dev) -> dict:
    """Each conv shape at B = ``INT8_CONV_TIME_B`` on random codes: the whole
    ``int8_conv2d``, its im2col and its ``torch._int_mm`` alone, and the bf16
    cuDNN conv of the same shape (channels-last); totals weighted by the
    shape's calls in one forward."""
    gen = torch.Generator(device=dev).manual_seed(50)
    out, total = [], {"int8_conv_ms": 0.0, "im2col_ms": 0.0, "int_mm_ms": 0.0, "bf16_cudnn_ms": 0.0}
    for r in rows:
        _, c, h, w = r["input"]
        o, _, k, _ = r["weight"]
        s, p = r["stride"], k // 2
        q = torch.randint(-127, 128, (INT8_CONV_TIME_B, h, w, c), generator=gen, device=dev,
                          dtype=torch.int8).permute(0, 3, 1, 2)
        wq = torch.randint(-127, 128, (o, c, k, k), generator=gen, device=dev, dtype=torch.int8)
        w_gemm = int8_conv.gemm_weight(wq)
        x = q.permute(0, 2, 3, 1).contiguous()
        cols = int8_conv.im2col(x, k, s, p, w_gemm.shape[0])
        xb = q.to(torch.bfloat16)
        wb = wq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        t = {"int8_conv_ms": cuda_ms(lambda: int8_conv.int8_conv2d(q, wq, s, p), reps=5),
             "im2col_ms": cuda_ms(lambda: int8_conv.im2col(x, k, s, p, w_gemm.shape[0]), reps=5),
             "int_mm_ms": cuda_ms(lambda: int8_conv.int_mm(cols, w_gemm), reps=5),
             "bf16_cudnn_ms": cuda_ms(lambda: F.conv2d(xb, wb, stride=s, padding=p), reps=5)}
        out.append({"input": [INT8_CONV_TIME_B, c, h, w], "weight": r["weight"], "stride": s,
                    "calls": r["calls"], **t})
        for key, ms in t.items():
            total[key] += ms * r["calls"]
        del q, wq, w_gemm, x, cols, xb, wb
    torch.cuda.empty_cache()
    return {"batch": INT8_CONV_TIME_B, "per_shape": out, "forward_total": total}


def int8_profile(forward) -> dict:
    """The device time of one forward's im2col, ``torch._int_mm`` and epilogue
    passes (``torch.profiler``, ``record_function`` ranges around the port's
    functions) and of all its kernels."""
    def ranged(label):
        def make(real):
            def fn(*args, **kwargs):
                with torch.profiler.record_function(label):
                    return real(*args, **kwargs)
            return fn
        return make

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with contextlib.ExitStack() as stack:
        for label, mod, name in INT8_RANGES:
            stack.enter_context(patched(mod, name, ranged(label)))
        forward()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            forward()
            torch.cuda.synchronize()
    labels = {label for label, _, _ in INT8_RANGES}

    def device_us(e) -> float:
        """The kernels a CPU op launched, its children's included (the GPU-side
        copies of the ranges themselves left out)."""
        return (sum(k.duration for k in e.kernels if k.name not in labels)
                + sum(device_us(c) for c in e.cpu_children))

    split = dict.fromkeys(sorted(labels), 0.0)
    kernels = 0.0
    for e in prof.events():
        on_card = str(e.device_type).endswith("CUDA")
        if e.name in labels:
            if not on_card:
                split[e.name] += device_us(e)
        elif on_card:
            kernels += e.time_range.elapsed_us()
    split = {k.replace("int8.", "") + "_ms": v / 1e3 for k, v in split.items()}
    split["kernel_ms_total"] = kernels / 1e3
    split["other_kernel_ms"] = split["kernel_ms_total"] - sum(
        split[k] for k in ("im2col_ms", "int_mm_ms", "epilogue_ms"))
    return split


def int8_card_vs_cpu(model_q, model_fp, images) -> dict:
    """One frame on the card and on the CPU, in the ``silu`` and ``bf16``
    epilogues: the first conv's int32 accumulator bit for bit; each
    requantizing conv of the card on the CPU's own input codes against the
    CPU's output codes (equal, or one apart at no more than
    ``INT8_LOCAL_SHARE``); the whole forward's codes layer by layer, where a
    code one apart feeds every later layer; and the logits against
    ``INT8_CLOSER``, checked in the bf16 epilogue."""
    cpu_q = copy.deepcopy(model_q).cpu()
    cpu_fp = copy.deepcopy(model_fp).cpu().to(memory_format=torch.contiguous_format)
    x = images.float() / 255.0
    with torch.inference_mode():
        fp_out = cpu_fp(x.cpu())
    requant = lambda m: "s_out" in getattr(m, "_quant_leaves", ())  # noqa: E731
    pairs = [(c, m) for c, m in zip(model_q.modules(), cpu_q.modules()) if requant(m)]
    rec = {}
    for mode in ("silu", "bf16"):
        io = {"card": [], "cpu": []}
        firsts = {"card": [], "cpu": []}
        hooks = [m.register_forward_hook(
                     lambda mod, a, o, side=side: io[side].append((mod, a[0], o)))
                 for card_m, cpu_m in pairs for side, m in (("card", card_m), ("cpu", cpu_m))]
        try:
            with epilogue_mode(mode), torch.inference_mode():
                with recording_convs(firsts["card"]):
                    card = model_q(x)
                with recording_convs(firsts["cpu"]):
                    cpu = cpu_q(x.cpu())
        finally:
            for h in hooks:
                h.remove()
        q_card, w_card, s, p = firsts["card"][0]
        q_cpu, w_cpu, _, _ = firsts["cpu"][0]
        inputs_equal = torch.equal(q_card.cpu(), q_cpu)
        acc_equal = torch.equal(int8_conv.int8_conv2d(q_card, w_card, s, p).cpu(),
                                int8_conv.int8_conv2d(q_cpu, w_cpu, s, p))
        # Layer by layer: each card conv on the CPU forward's own input codes.
        to_card = {id(cpu_m): card_m for card_m, cpu_m in pairs}
        local, n_diff, n_all, local_max = [], 0, 0, 0
        with epilogue_mode(mode), torch.inference_mode():
            for mod, inp, out in io["cpu"]:
                got = to_card[id(mod)](quant.QT(inp.q.to(x.device), inp.s.to(x.device)))
                d = (got.q.cpu().int() - out.q.int()).abs()
                local.append(float((d > 0).float().mean()))
                local_max = max(local_max, int(d.max()))
                n_diff += int((d > 0).sum())
                n_all += d.numel()
        chained = [float((a[2].q.cpu() != b[2].q).float().mean())
                   for a, b in zip(io["card"], io["cpu"])]
        logits = {}
        for k in ("box_logits", "cls_logits"):
            diff = (card[k].cpu() - cpu[k]).abs()
            logits[k] = {"card_vs_cpu_mean_abs": float(diff.mean()),
                         "card_vs_cpu_max_abs": float(diff.max()),
                         "int8_vs_fp_mean_abs": float((cpu[k] - fp_out[k]).abs().mean())}
        rec[mode] = {"first_conv_inputs_equal": inputs_equal,
                     "first_conv_accumulator_bitwise": acc_equal,
                     "requant_convs": len(local), "local_code_share_one_apart": n_diff / n_all,
                     "local_max_share_in_a_layer": max(local), "local_max_code_diff": local_max,
                     "chained_code_share_by_layer": chained, "logits": logits}
    emit({"phase": "int8_progress", "yolo_card_vs_cpu": rec})
    for mode, r in rec.items():
        check(r["first_conv_inputs_equal"], f"{mode}: the first conv's input codes card == CPU")
        check(r["first_conv_accumulator_bitwise"], f"{mode}: the first conv's int32 accumulator")
        check(r["local_max_code_diff"] <= 1 and r["local_code_share_one_apart"] <= INT8_LOCAL_SHARE,
              f"{mode}: each conv's codes on the CPU's inputs equal or one apart")
    for k, v in rec["bf16"]["logits"].items():
        check(INT8_CLOSER * v["card_vs_cpu_mean_abs"] <= v["int8_vs_fp_mean_abs"],
              f"bf16: card vs CPU {k} within the relation")
    return rec


def int8_headline(model_q, images, ctx, dev) -> dict:
    """The int8 serving step (pool 512, full tail): step, forward and tail
    ms, img/s, peak memory, B1's launches over the timed steps from zero (one
    a step), the kernel tail bitwise against the plain tail on the same
    forward outputs, and the forward's profiler split."""
    b = images.shape[0]
    nms_kw = dict(iou_threshold=IOU, score_threshold=SCORE_THR, max_det=MAX_DET)
    step = make_serving_step(model_q, pool=POOL, tail="full", **nms_kw)
    kwargs = {} if ctx is None else {"context_ids": ctx}

    def forward():
        with torch.inference_mode():
            return model_q(images.float() / 255.0, **kwargs)

    # The main path: the counts from zero over the timed serving steps.
    nms_kernel.nms_keep_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: step(images, ctx), reps=5)      # 2 warm-up + 5 steps
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = nms_kernel.nms_keep_launches
    res = step(images, ctx)
    torch.cuda.synchronize()
    out = forward()
    with torch.inference_mode():
        scores = torch.sigmoid(out["cls_logits"][..., 0])
        kern = batched_nms(out["boxes"], scores, num_candidates=POOL, **nms_kw)
        zeros = torch.zeros(scores.shape, dtype=torch.int32, device=dev)
        plain = _batched_nms_plain(out["boxes"], scores, zeros, num_candidates=POOL,
                                   class_agnostic=False, **nms_kw)
    torch.cuda.synchronize()
    rec = {"batch": b, "step_ms": step_ms, "img_per_s": b * 1000.0 / step_ms,
           "peak_mem_gib": peak_gib, "nms_keep_launches": launches, "timed_steps": 7,
           "forward_ms": cuda_ms(forward, reps=3),
           "nms_tail_ms": cuda_ms(lambda: batched_nms(out["boxes"], scores, num_candidates=POOL,
                                                      **nms_kw), reps=10),
           "tail_bitwise_plain": bitwise_equal(kern, plain), "valid_out": int(res.valid.sum()),
           "forward_profile": int8_profile(forward)}
    check(launches == 7, f"int8 serving launched nms_keep {launches} times over 7 steps")
    check(rec["tail_bitwise_plain"], "int8 kernel tail == plain tail on one forward")
    check(all(bool(torch.isfinite(t).all()) for t in res[:2]), "finite int8 outputs")
    check(tuple(res.boxes.shape) == (b, MAX_DET, 4), "int8 NmsResult shape")
    return rec


def int8_rtdetr(dev) -> dict:
    """RT-DETR r50vd int8 (backbone and CCFF int8, AIFI and the decoder fp)
    at B=16: step ms, img/s, peak memory, B4 six times a step from zero,
    and B4 on decoder layer 0's own inputs against its plain version."""
    fp = build_rtdetr(torch.float32, dev)
    q = RTDETRDetector(num_classes=1, num_queries=RT_QUERIES, num_decoder_layers=RT_LAYERS,
                       arch="tpu", int8=True).to(dev)
    q, calib_s = quantized(fp, q, calib_batches(INT8_CALIB_BATCHES, 2, seed=60, dev=dev))
    del fp
    torch.cuda.empty_cache()
    kw = dict(max_det=MAX_DET, score_threshold=SCORE_THR)
    step = make_serving_step(q, **kw)
    images = random_images(RT_B, seed=4, dev=dev)
    cap = Capture(q)
    deformable_kernel.ms_deform_fwd_launches = 0
    res = step(images)
    torch.cuda.synchronize()
    launches = deformable_kernel.ms_deform_fwd_launches
    cap.remove()
    check(launches == RT_LAYERS, f"int8 RT-DETR step launched ms_deform_fwd {launches} times")
    check(all(bool(torch.isfinite(t).all()) for t in res[:2]), "finite int8 RT-DETR outputs")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: step(images), reps=5)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    def forward():
        with torch.inference_mode():
            return q(images.float() / 255.0)

    v, loc, attn, levels = cap.kernel_inputs
    b4 = deform_compare(v, levels, loc, attn, library=False)
    rec = {"batch": RT_B, "calibration_s": calib_s, "step_ms": step_ms,
           "img_per_s": RT_B * 1000.0 / step_ms, "peak_mem_gib": peak_gib,
           "ms_deform_fwd_launches": launches, "b4_on_step_inputs": b4,
           "forward_ms": cuda_ms(forward, reps=3), "forward_profile": int8_profile(forward),
           "valid_out": int(res.valid.sum())}
    check_deform(b4, "ms_deform_fwd on the int8 RT-DETR step's inputs")
    del q, step, cap, v, loc, attn
    torch.cuda.empty_cache()
    return rec


def int8_evaluate(dev) -> dict:
    """``evaluate_detector`` on a ``quantize_loaded`` YOLO-s run dir: the npz
    written by the first load and reused by the second, four batches of 16
    (pool 1024), each tail bitwise against the plain tail on the CPU, B1
    once a batch, 0 < mAP50 < 1."""
    with tempfile.TemporaryDirectory() as tmp:
        run = write_run_dir(Path(tmp), {"family": "yolo", "variant": "s"})
        loaded = loading.load_detector(run, device=dev)
        npz = run / "weights" / "int8_quant_best.npz"
        check(not npz.exists(), "no quant npz before the first load")
        calib = [x.cpu().numpy() for x in
                 calib_batches(INT8_CALIB_BATCHES, INT8_CALIB_B, seed=63, dev=dev)]
        t0 = time.perf_counter()
        first = loading.quantize_loaded(loaded, calib)
        first_s = time.perf_counter() - t0
        check(npz.exists(), "quantize_loaded wrote the quant npz")

        def refuse(real):
            def calibrate(*a, **k):
                raise RuntimeError("the quant npz beside the checkpoint was not reused")
            return calibrate

        t0 = time.perf_counter()
        with patched(quant, "calibrate", refuse):
            int8 = loading.quantize_loaded(loaded, [])
        second_s = time.perf_counter() - t0
        check(all(torch.equal(v, int8.variables[k]) for k, v in first.variables.items()),
              "the reused npz gives the same int8 model")
        check(model_device(int8.model).type == "cuda", "the int8 model on the card")
        batches = eval_batches(EVAL_BATCHES, EVAL_B, seed=30)
        for batch in batches:
            del batch["solar_bin"]
        infer = evaluator.make_inference_fn(int8.model, int8.variables)

        def first_pass(batch):
            boxes, scores = infer(host_rgb(batch))
            with torch.inference_mode():
                return batched_nms(boxes, scores)

        plant_ground_truth(batches, first_pass, seed=5)
        metrics, seen, results, launches = evaluate_recorded(int8, batches, use_nms=True)
        torch.cuda.synchronize()
        check_evaluation("yolo int8", batches, metrics, seen, results, use_nms=True)
        check(launches["nms_keep"] == EVAL_BATCHES, f"int8 evaluate launched B1 {launches}")
    return {"quantize_loaded_first_s": first_s, "quantize_loaded_reuse_s": second_s,
            "npz_written_then_reused": True, "batches": EVAL_BATCHES, "batch": EVAL_B,
            "launches": launches,
            "metrics": {k: v for k, v in metrics.items() if k != "curves_results"}}


def phase_int8(dev, smi: str, bf16: dict) -> dict:
    """int8 PTQ serving on the card (random weights from seed 0, calibrated
    on seeded batches, 704x1248): the conv at every YOLO-s shape against its
    float64 version, YOLO-s card against CPU, the YOLO-s and MoE-YOLO-s
    B=128 headlines, RT-DETR r50vd at B=16, and evaluation of a
    ``quantize_loaded`` run dir. ``bf16`` holds the same run's bf16
    headlines."""
    t_phase = time.perf_counter()
    rec = {"phase": "int8", "img_hw": [IMG_H, IMG_W], "epilogue": "bf16 (default)",
           "calibration": {"mode": "absmax", "batches": INT8_CALIB_BATCHES,
                           "frames": INT8_CALIB_B},
           "gpu": smi, **tf32_state()}
    # YOLO-s
    fp = build_model(torch.float32, dev)
    q = YoloDetector(num_classes=1, variant="s", arch="tpu", int8=True).to(dev)
    q, calib_s = quantized(fp, q, calib_batches(INT8_CALIB_BATCHES, INT8_CALIB_B, seed=40, dev=dev))
    conv_rows = int8_conv_check(q, random_images(2, seed=41, dev=dev))
    rec["conv_check"] = {"batch": 2, "shapes": conv_rows}
    check(all(r["bitwise"] for r in conv_rows), "int8_conv2d == float64 conv at every shape")
    check(any(r["K"] % 8 or r["N"] % 8 for r in conv_rows), "a shape with K or N off 8")
    rec["conv_times"] = int8_conv_times(conv_rows, dev)
    rec["yolo_card_vs_cpu"] = int8_card_vs_cpu(q, fp, random_images(1, seed=42, dev=dev))
    del fp
    torch.cuda.empty_cache()
    rec["yolo"] = {"model": "yolo-s arch=tpu int8", "calibration_s": calib_s,
                   **int8_headline(q, random_images(INT8_B, seed=2, dev=dev), None, dev),
                   "bf16_same_run": bf16["yolo"]}
    emit({"phase": "int8_progress", "done": "yolo", "yolo": rec["yolo"]})
    del q
    torch.cuda.empty_cache()
    # MoE-YOLO-s
    fp = build_moe_yolo(torch.float32, dev)
    q = MoEYoloDetector(num_classes=1, variant="s", num_experts=MOE_E, k=MOE_K,
                        capacity_factor=MOE_CF, arch="tpu", int8=True).to(dev)
    q, calib_s = quantized(fp, q, calib_batches(INT8_CALIB_BATCHES, INT8_CALIB_B, seed=43, dev=dev),
                           context_ids=context_ids(INT8_CALIB_B, seed=44, dev=dev))
    del fp
    torch.cuda.empty_cache()
    rec["moe"] = {"model": "moe-yolo-s E=4 k=2 int8 (w8a8 sweep)", "calibration_s": calib_s,
                  **int8_headline(q, random_images(MOE_B, seed=7, dev=dev),
                                  context_ids(MOE_B, seed=8, dev=dev), dev),
                  "bf16_same_run": bf16["moe"]}
    del q
    torch.cuda.empty_cache()
    rec["rtdetr"] = {"model": "rtdetr r50vd int8 (backbone + CCFF)", **int8_rtdetr(dev),
                     "bf16_same_run": bf16["rtdetr"]}
    rec["evaluate"] = int8_evaluate(dev)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


DATA_FRAMES = 4000       # the resident split: 80 % of the protocol's 5,000 frames
DATA_DISTINCT = 64       # distinct JPEGs the corpus cycles over
DATA_FIT_FRAMES = 160    # fit has no step limit: 10 steps of B=16
DATA_VAL_FRAMES, DATA_VAL_B = 32, 12   # three val batches, the last one padded
DATA_WORKERS = 8         # scripts/train_moe.py:43 --workers
DATA_MAX_BOXES = 96
DATA_SOLAR = ["night(<-6)", "twilight(-6..0)", "low_sun(0..15)", "mid_sun(15..45)",
              "high_sun(>45)", "missing"]


def plane_bytes() -> int:
    """One frame as 4:2:0 planes: 1,317,888 B at 704x1248."""
    return IMG_H * IMG_W * 3 // 2


def host_lacks() -> list:
    """Which of pandas, pyarrow, PIL, g++ and libjpeg this host lacks (the
    last shows as a native decoder that cannot be built)."""
    import importlib.util
    import shutil

    from multimodal_moe_torch.data import native_decode

    lacks = [m for m in ("pandas", "pyarrow", "PIL") if importlib.util.find_spec(m) is None]
    if shutil.which("g++") is None:
        lacks.append("g++")
    elif not native_decode.native_available():
        lacks.append("libjpeg")
    return lacks


def data_frames(n: int, seed: int) -> "tuple[list, list]":
    """``n`` distinct smooth 704x1248 RGB frames, each with 1-6 figure-sized
    rectangles, and their boxes (xyxy)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, IMG_H, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, IMG_W, dtype=np.float32)[None, :, None]
    frames, boxes = [], []
    for _ in range(n):
        a, b, c = (rng.uniform(-120, 120, 3).astype(np.float32) for _ in range(3))
        img = np.clip(a * yy + b * xx + c + 128.0, 0, 255).astype(np.uint8)
        fb = []
        for _ in range(int(rng.integers(1, 7))):
            w, h = int(rng.integers(IMG_W // 60, IMG_W // 20)), int(rng.integers(IMG_H // 14, IMG_H // 5))
            x0, y0 = int(rng.integers(0, IMG_W - w)), int(rng.integers(0, IMG_H - h))
            img[y0 : y0 + h, x0 : x0 + w] = rng.integers(0, 256, 3)
            fb.append([float(x0), float(y0), float(x0 + w), float(y0 + h)])
        frames.append(img)
        boxes.append(fb)
    return frames, boxes


def write_data_corpus(root: Path, seed: int = 40) -> dict:
    """The phase's corpus: ``DATA_DISTINCT`` pre-resized 4:2:0 JPEGs at
    704x1248 (PIL, ``subsampling=2``), a parquet of ``DATA_FRAMES`` +
    ``DATA_VAL_FRAMES`` rows cycling over them (every solar label, some
    boxes unclear) and split CSVs: train (the first ``DATA_FRAMES``), fit
    (the first ``DATA_FIT_FRAMES`` of those) and val (the rest)."""
    import pandas as pd
    from PIL import Image

    root.mkdir(parents=True)
    frames, boxes = data_frames(DATA_DISTINCT, seed)
    paths = []
    for i, img in enumerate(frames):
        paths.append(root / f"frame_{i:02d}.jpg")
        Image.fromarray(img).save(paths[-1], quality=90, subsampling=2)
    rng = np.random.default_rng(seed + 1)
    n = DATA_FRAMES + DATA_VAL_FRAMES
    rows = [{"frame_id": f"{i:06d}", "resized_image_path": str(paths[i % DATA_DISTINCT]),
             "xyxy_bboxes": boxes[i % DATA_DISTINCT],
             "ped_unclear_list": [bool(u) for u in rng.random(len(boxes[i % DATA_DISTINCT])) < 0.2],
             "ped_present": True, "solar_context_bin": DATA_SOLAR[i % len(DATA_SOLAR)]}
            for i in range(n)]
    pd.DataFrame(rows).to_parquet(root / "frames.parquet")
    splits = {"train": range(DATA_FRAMES), "fit": range(DATA_FIT_FRAMES), "val": range(DATA_FRAMES, n)}
    for name, ids in splits.items():
        (root / f"{name}_ids.csv").write_text("frame_id\n" + "\n".join(f"{i:06d}" for i in ids) + "\n")
    return {"parquet": root / "frames.parquet", **{k: root / f"{k}_ids.csv" for k in splits}}


def numpy_split(n: int, seed: int) -> dict:
    """The host half's arrays made with numpy, for a host that cannot decode
    the corpus to planes: ``n`` frames cycling over ``DATA_DISTINCT``
    distinct 4:2:0 plane sets, their boxes and solar bins."""
    frames, boxes = data_frames(DATA_DISTINCT, seed)
    y = np.stack([f[..., 0] for f in frames])
    cb = np.stack([f[::2, ::2, 1] for f in frames])
    cr = np.stack([f[1::2, 1::2, 2] for f in frames])
    gt = np.zeros((DATA_DISTINCT, DATA_MAX_BOXES, 4), np.float32)
    mask = np.zeros((DATA_DISTINCT, DATA_MAX_BOXES), bool)
    for i, fb in enumerate(boxes):
        gt[i, : len(fb)], mask[i, : len(fb)] = fb, True
    cyc = np.arange(n) % DATA_DISTINCT
    return {"y": y[cyc], "cb": cb[cyc], "cr": cr[cyc], "gt_boxes": gt[cyc], "gt_mask": mask[cyc],
            "gt_labels": np.zeros((n, DATA_MAX_BOXES), np.int32), "label": np.ones(n, np.int32),
            "solar_bin": (np.arange(n) % len(DATA_SOLAR)).astype(np.int32)}


class HostPlaneLoader:
    """Host batches of numpy planes and targets as a ``store="yuv420"``
    ``DetectionLoader`` yields them (its epoch order and zero padding), for
    a host without the native decoder."""

    def __init__(self, arrays: dict, batch_size: int, *, shuffle=False, seed=0, drop_last=True):
        self.arrays, self.batch_size = arrays, batch_size
        self.shuffle, self.seed, self.drop_last, self._epoch = shuffle, seed, drop_last, 0
        self._n = len(arrays["y"])

    def __len__(self) -> int:
        return self._n // self.batch_size if self.drop_last else -(-self._n // self.batch_size)

    def __iter__(self):
        order = data_pipeline.epoch_order(self._n, self.shuffle, self.seed, self._epoch)
        self._epoch += 1
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs : (b + 1) * bs]
            out = {k: v[idx] for k, v in self.arrays.items()}
            pad = bs - len(idx)
            out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in out.items()}
            out["batch_valid"] = np.arange(bs) < len(idx)
            yield out


def batch_bytes(batch: dict) -> int:
    return sum(np.asarray(v).nbytes for k, v in batch.items() if k != "batch_valid")


def cuda_ms_median(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the card, one pair of CUDA events a call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def same_targets(a: dict, b: dict) -> bool:
    return all(torch.equal(torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu())
               for k in data_resident.TARGET_KEYS)


def fit_once(dev, loader, val_loader, run_dir: Path) -> dict:
    """One epoch of ``DetectionTrainer.fit`` on MoE-YOLO-s (``gmm``, B=16,
    TF32 on, the ``moe_yolo_train`` phase's trainer) over ``loader``, with
    ``make_ema_val_fn`` over ``val_loader()``: the step time from the second
    step to the validation, B3's launches in training (forward, transposed,
    tgmm) and in validation, B1's."""
    trainer = yolo_trainer(dev, YOLO_B, dispatch="gmm", epochs=1)
    marks, fwd = [], []
    step, loss_fn = trainer.train_step, trainer.loss_fn

    def timed_step(state, batch, draws=None):
        marks.append((time.perf_counter(), gmm_kernel.gmm_launches))
        return step(state, batch, draws)

    def counted_loss(*a, **k):
        fwd.append(gmm_kernel.gmm_launches - marks[-1][1])
        return loss_fn(*a, **k)

    val = evaluator.make_ema_val_fn(trainer.model, val_loader)
    at_val = {}

    def counted_val(state):
        torch.cuda.synchronize()
        at_val.update(t=time.perf_counter(), gmm=gmm_kernel.gmm_launches,
                      tgmm=gmm_kernel.tgmm_launches, nms=nms_kernel.nms_keep_launches)
        metrics = val(state)
        at_val.update(val_gmm=gmm_kernel.gmm_launches - at_val["gmm"],
                      val_tgmm=gmm_kernel.tgmm_launches - at_val["tgmm"],
                      val_nms=nms_kernel.nms_keep_launches - at_val["nms"])
        return metrics

    trainer.train_step, trainer.loss_fn = timed_step, counted_loss
    gmm_kernel.gmm_launches = gmm_kernel.tgmm_launches = nms_kernel.nms_keep_launches = 0
    t0 = time.perf_counter()
    state, summary = trainer.fit(loader, run_dir=run_dir, val_fn=counted_val)
    torch.cuda.synchronize()
    steps = len(marks)
    row = summary["history"][0]
    rec = {"steps": steps, "fit_s": time.perf_counter() - t0,
           "fit_step_ms": 1000.0 * (at_val["t"] - marks[1][0]) / (steps - 1),
           "launches": {"gmm_forward": sum(fwd), "gmm_transposed": at_val["gmm"] - sum(fwd),
                        "tgmm": at_val["tgmm"], "nms_keep": at_val["nms"],
                        "val_gmm_forward": at_val["val_gmm"], "val_tgmm": at_val["val_tgmm"],
                        "val_nms_keep": at_val["val_nms"]},
           "loss": row.get("loss"), "val_map50": row.get("val_map50"),
           "progress_written": (run_dir / "fit_progress.json").exists(),
           "last_written": (run_dir / "weights" / "last").exists()}
    del trainer, state
    torch.cuda.empty_cache()
    return rec


def check_fit(name: str, rec: dict, val_batches: int) -> None:
    n = rec["steps"]
    want = {"gmm_forward": 6 * n, "gmm_transposed": 6 * n, "tgmm": 6 * n, "nms_keep": 0,
            "val_gmm_forward": 6 * val_batches, "val_tgmm": 0, "val_nms_keep": val_batches}
    check(n == DATA_FIT_FRAMES // YOLO_B, f"{name}: fit took {n} steps")
    check(rec["launches"] == want, f"{name}: launches {rec['launches']}, expected {want}")
    check(rec["loss"] is not None and np.isfinite(rec["loss"]), f"{name}: finite loss")
    check(rec["progress_written"] and rec["last_written"],
          f"{name}: fit_progress.json and weights/last written")


def phase_data(dev, smi: str, prestaged: dict) -> dict:
    """The data path on the card: the resident store at 4,000 frames, the
    gather and conversion, the streaming loaders through
    ``prefetch_to_device``, and ``fit`` over a resident and a streaming
    160-frame split with validation over a streaming 32-frame split. Where
    the host cannot decode the corpus to planes, the device half runs on
    numpy planes at the same sizes."""
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    lacks = host_lacks()
    tables = not ({"pandas", "pyarrow", "PIL"} & set(lacks))
    planes = not lacks
    rec = {"phase": "data", "gpu": smi, "host_lacks": lacks,
           "native_build_error": data_native.build_error,
           "host_half": "corpus decoded by the native decoder" if planes else
           "numpy planes and targets (the device half alone)",
           "frames": DATA_FRAMES, "distinct_jpegs": DATA_DISTINCT, "batch": YOLO_B,
           "img_hw": [IMG_H, IMG_W], "plane_bytes_per_frame": plane_bytes(), **tf32_state()}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cfg = lambda split: data_pipeline.ZODMoEDataConfig(  # noqa: E731
            frames_parquet=str(corpus["parquet"]), split_csv=str(corpus[split]),
            img_h=IMG_H, img_w=IMG_W, max_boxes=DATA_MAX_BOXES)
        corpus = write_data_corpus(root / "corpus") if tables else None
        ds = {s: data_pipeline.ZODMoEVisionDataset(cfg(s)) for s in ("train", "fit", "val")} \
            if tables else {}
        t_host = time.perf_counter()
        host = None if planes else numpy_split(DATA_FRAMES + DATA_VAL_FRAMES, seed=40)
        rec["numpy_host_s"] = None if planes else time.perf_counter() - t_host

        # The resident store at the protocol's size.
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
        if planes:
            resident = data_resident.ResidentDetectionLoader(
                ds["train"], YOLO_B, num_workers=DATA_WORKERS, store="yuv420", device=dev)
        else:
            arrays = {k: v[:DATA_FRAMES] for k, v in host.items()}
            resident = data_resident.ResidentDetectionLoader.from_arrays(arrays, YOLO_B, device=dev)
        rec["resident"] = {**resident.timings, "bytes": resident.resident_bytes,
                           "plane_bytes": DATA_FRAMES * plane_bytes(),
                           "upload_gb_s": resident.resident_bytes / resident.timings["upload_s"] / 1e9,
                           "device_bytes": torch.cuda.memory_allocated(dev) - mem0,
                           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        check(resident.resident_bytes >= DATA_FRAMES * plane_bytes(), "5.27 GB of planes resident")
        first = DATA_FRAMES // 40   # frames 100-115 at 4,000
        idx = torch.arange(first, first + YOLO_B, device=dev)
        rec["resident"]["gather_ms"] = cuda_ms_median(lambda: resident.gather(idx), reps=20)
        got = resident.gather(idx)
        if planes:
            y, cb, cr = data_native.decode_jpeg_files_yuv420(
                [ds["train"].image_path(i) for i in range(first, first + YOLO_B)], IMG_H, IMG_W)
        else:
            y, cb, cr = (host[k][first : first + YOLO_B] for k in ("y", "cb", "cr"))
        cpu = preprocess.yuv420_to_rgb_u8(*(torch.from_numpy(a) for a in (y, cb, cr)))
        rec["resident"]["gather_bitwise"] = torch.equal(got["image"].cpu(), cpu)
        check(rec["resident"]["gather_bitwise"], "gathered images equal the CPU conversion")

        # The streaming loaders: the host alone, then through prefetch_to_device.
        n_stream = DATA_FIT_FRAMES // YOLO_B
        stream = {}
        if planes:
            t1 = time.perf_counter()
            host_batches = list(data_pipeline.DetectionLoader(
                ds["fit"], YOLO_B, num_workers=DATA_WORKERS, store="yuv420"))
            stream["loader_img_s"] = DATA_FIT_FRAMES / (time.perf_counter() - t1)
        else:
            host_batches = list(HostPlaneLoader({k: v[:DATA_FIT_FRAMES] for k, v in host.items()},
                                                YOLO_B))
            stream["loader_img_s"] = None   # no native decoder on this host
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dev_batches = list(data_pipeline.prefetch_to_device(iter(host_batches), device=dev))
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t1
        stream["h2d_bytes"] = sum(batch_bytes(b) for b in host_batches)
        stream["h2d_gb_s"] = stream["h2d_bytes"] / h2d_s / 1e9
        same = [torch.equal(s["image"], r["image"]) and same_targets(s, r)
                for s, r in zip(dev_batches, resident)]
        stream["batches"], stream["bitwise_equal_to_resident"] = len(same), all(same)
        check(len(same) == n_stream and all(same),
              f"streaming batches equal the resident ones ({same})")
        if tables:
            t1 = time.perf_counter()
            n_rgb = len(list(data_pipeline.DetectionLoader(
                ds["fit"], YOLO_B, num_workers=DATA_WORKERS, store="rgb")))
            stream["rgb_loader_img_s"] = n_rgb * YOLO_B / (time.perf_counter() - t1)
        rec["streaming"] = stream
        del resident, dev_batches, host_batches, got
        torch.cuda.empty_cache()

        # fit over a resident and a streaming 160-frame split.
        if planes:
            fit_resident = data_resident.ResidentDetectionLoader(
                ds["fit"], YOLO_B, shuffle=True, num_workers=DATA_WORKERS, device=dev)
            fit_stream = data_pipeline.DetectionLoader(
                ds["fit"], YOLO_B, shuffle=True, num_workers=DATA_WORKERS, store="yuv420")
        else:
            fit_arrays = {k: v[:DATA_FIT_FRAMES] for k, v in host.items()}
            fit_resident = data_resident.ResidentDetectionLoader.from_arrays(
                fit_arrays, YOLO_B, shuffle=True, device=dev)
            fit_stream = HostPlaneLoader(fit_arrays, YOLO_B, shuffle=True)
        if tables:
            val_loader = lambda: data_pipeline.DetectionLoader(  # noqa: E731
                ds["val"], DATA_VAL_B, drop_last=False, num_workers=DATA_WORKERS,
                store="yuv420" if planes else "rgb")
        else:
            val_arrays = {k: v[DATA_FRAMES:] for k, v in host.items()}
            val_loader = lambda: HostPlaneLoader(val_arrays, DATA_VAL_B, drop_last=False)  # noqa: E731
        val_batches = -(-DATA_VAL_FRAMES // DATA_VAL_B)
        rec["val"] = {"frames": DATA_VAL_FRAMES, "batch": DATA_VAL_B, "batches": val_batches,
                      "store": "yuv420" if planes else ("rgb" if tables else "numpy planes")}
        rec["fit"] = {}
        for name, loader in (("resident", fit_resident), ("streaming", fit_stream)):
            rec["fit"][name] = fit_once(dev, loader, val_loader, root / f"fit_{name}")
        rec["fit"]["prestaged_step_ms"] = prestaged["step_ms"]
    del fit_resident, fit_stream, host
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    for name in ("resident", "streaming"):
        check_fit(name, rec["fit"][name], val_batches)
    return rec


# --------------------------------------------------------------------------
# multigpu: the trainer on a mesh of two gloo ranks sharing the card
# --------------------------------------------------------------------------

MULTIGPU_B = 16            # the global batch (8 a rank)
MULTIGPU_SEED = 21
# (name, MoE-YOLO-s or YOLO-s, dispatch, num_data, num_expert)
MULTIGPU_CASES = (("moe_sweep_1x2", True, "sweep", 1, 2), ("moe_gmm_1x2", True, "gmm", 1, 2),
                  ("moe_auto_2x1", True, "auto", 2, 1), ("yolo_2x1", False, "gmm", 2, 1))
MULTIGPU_RANKS = 2
# RT-DETR r50vd (scripts/train_rtdetr.py's trainer) on 2 data x 1 expert, the
# global batch of rt_train_batch's frames and 96 ground-truth slots.
MULTIGPU_RT, MULTIGPU_RT_SEED = ("rtdetr_2x1", 2, 1), 23
# RT-DETR at random init is ill-conditioned: float32 noise (statistics
# summed in another order) moves the decoder's costs, and the backward
# through the random r50vd trunk, which carries almost all of the gradient
# (norm ~4e3, clipped to 10), turns it into a ~9% change of the gradient's
# direction in every trunk leaf, where its norm and its scale (its
# projection on the one-process gradient) move by ~1e-3 (CPU, r50vd
# 128x256, B=4, the batch's halves swapped). The ranks therefore replay the
# one-process step's query selection and matching, and the loss and each
# part, the gradient's norm and scale (summed over the ranks, before the
# clip) and Adam's mu (0.1 of the clipped gradient: blind to the gradient's
# scale) are held to 3x what the one-process step itself moves by when
# repeated or when its batch's halves are swapped; the scale of each group
# of leaves (top-level module) whose direction that noise moves by at most
# 10% is held to 0.125, half the smaller planted fault's. Two planted
# faults must fail these checks: detr_loss summing only its counts over the
# ranks (the gradient comes out ranks x too small: scale -0.5) and rank 1's
# loss halved (-0.25). On an H100 80GB HBM3 at 700 W, this phase's inputs:
# the gradient's norm 1254, the swapped batch moves its direction 27%, its
# norm 0.95% and its scale 4.6%, the mesh 34%, 0.75% and 6.6%; the steady
# modules' scales at most 7.2e-2 off; the controls' scales -0.53 and -0.30
# (their noise-free encoder score head: -0.5000 and -0.2500). The decoder's
# forward is itself chaotic at this size (each layer samples the value maps
# where the last one put its boxes): the matcher's costs move by up to 2.9
# with the batch's order alone. The ranks' own matching may differ from the
# one-process one only where the one-process costs prefer their choice by
# no more than the two steps' costs differ on the two assignments (a bound
# that holds for any pair of exact matchers).
MG_RT_LOSS_RTOL = 1e-4       # the loss's (and each part's) floor, of the loss
MG_RT_NOISE_FACTOR = 3.0     # every check against the one-process noise
MG_RT_GRAD_RTOL = 1e-3       # mu's floor, and the EMA (lr 0: equal to the parameters)
MG_RT_BN_TOL = 1e-5          # running mean (of sqrt var) and variance, relative
MG_RT_GRAD_SCALE_RTOL = 1e-2  # the gradient norm's and scale's floor
MG_RT_GROUP_NOISE = 0.1      # a group whose gradient the one-process noise turns by at most this
MG_RT_GROUP_SCALE_TOL = 0.125  # ... keeps its scale within this: half the smaller control's
MG_RT_CONTROLS = ("numerators_local", "rank1_loss_halved")
# The two-rank fit: MoE-YOLO-s on 1 x 2 (gmm), two global steps of 16, rank
# 0 validating over two batches of 8 with make_ema_val_fn.
MULTIGPU_FIT_FRAMES, MULTIGPU_VAL_FRAMES, MULTIGPU_VAL_B = 32, 16, 8
# The CPU tests' tolerances (tests/test_torch_distributed.py).
MG_LOSS_RTOL, MG_PARAM_TOL, MG_TRACE_RTOL, MG_BN_TOL = 1e-5, 1e-3, 1e-3, 1e-6
# Routing: identical outside the near ties, which stay under 1% of a level's
# tokens (the near-tie rule of the fused MoE-YOLO phase's card-CPU check).
MG_NEAR_TIE_SHARE = 0.01


def multigpu_batch(dev) -> dict:
    return yolo_train_batch(MULTIGPU_B, seed=MULTIGPU_SEED, dev=dev)


def multigpu_step(trainer, state, batch) -> dict:
    """One step from ``state``: the metrics, the B3 launches (the forward's
    read when the loss starts), each MoE level's router logits, the step's
    time on the card (CUDA events) and the state after it."""
    real_loss, seen = trainer.loss_fn, {}

    def loss_fn(*a, **k):
        seen["gmm_forward"] = gmm_kernel.gmm_launches
        return real_loss(*a, **k)

    logits, handles = router_logits(state.model) if hasattr(state.model, "moe_level0") \
        else ([], [])
    trainer.loss_fn = loss_fn
    gmm_kernel.gmm_launches = gmm_kernel.tgmm_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    state, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    trainer.loss_fn = real_loss
    for h in handles:
        h.remove()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "logits": [x.detach() for x in logits],
            "launches": {"gmm_forward": seen.get("gmm_forward", 0),
                         "gmm_transposed": gmm_kernel.gmm_launches - seen.get("gmm_forward", 0),
                         "tgmm": gmm_kernel.tgmm_launches},
            "step_ms": start.elapsed_time(end), "state": state}


@contextlib.contextmanager
def replayed_choices(record: dict, replay: "dict | None" = None,
                     rows: "torch.Tensor | None" = None, keep_cost: bool = False):
    """RT-DETR's two discrete choices wrapped: the query selection
    (``stable_topk``) and ``detr_loss``'s matcher. Each call's own choice
    (with ``keep_cost`` the matcher's cost) goes into ``record``; with
    ``replay`` (each call's choice over the global batch, the matcher's
    layer-major), the rows ``rows`` of it (the global rows this process
    holds, in its order) are returned in place of its own, so that two
    runs compare on the same queries and the same matching."""
    record.setdefault("select", [])
    record.setdefault("assign", [])

    def make_select(real):
        def select(scores, k):
            values, idx = real(scores, k)
            record["select"].append(idx.cpu())
            if replay is None:
                return values, idx
            idx = replay["select"][len(record["select"]) - 1][rows].to(scores.device)
            return torch.gather(scores, 1, idx), idx
        return select

    def make_assign(real):
        def assign(cost, col_valid=None):
            own = real(cost, col_valid)
            rec = {"assigned": own.cpu()}
            if keep_cost:
                rec.update(cost=cost.detach().float().cpu(), valid=col_valid.cpu())
            record["assign"].append(rec)
            if replay is None:
                return own
            ref = replay["assign"][len(record["assign"]) - 1]
            layers = ref.shape[0] // MULTIGPU_B
            return ref.reshape(layers, MULTIGPU_B, -1)[:, rows].reshape(own.shape).to(own.device)
        return assign

    with patched(rtdetr_module, "stable_topk", make_select), \
            patched(hungarian_module, "batched_lsa_assign", make_assign):
        yield record


def rt_multigpu_step(trainer, state, batch, replay=None, rows=None, keep_cost=False,
                     draws=None, keep_grads=False) -> dict:
    """One RT-DETR step from ``state`` with its choices recorded (and
    replayed): the metrics, B4's and B5's launches, the step's time on the
    card, the state after it and, with ``keep_grads``, the gradients the
    optimizer was given (summed over the ranks, before the clip) on the
    host."""
    record, grads = {}, {}
    deformable_kernel.ms_deform_fwd_launches = deformable_kernel.ms_deform_bwd_launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if keep_grads:
        real_apply = state.apply_gradients

        def apply(g):
            grads.update({k: v.detach().to("cpu", torch.float32, copy=True)
                          for k, v in g.items()})
            return real_apply(g)

        state.apply_gradients = apply
    try:
        with replayed_choices(record, replay, rows, keep_cost):
            torch.cuda.synchronize()
            start.record()
            state, metrics = trainer.train_step(state, batch, draws=draws)
            end.record()
            torch.cuda.synchronize()
    finally:
        if keep_grads:
            del state.apply_gradients
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "choices": record,
            "launches": {"ms_deform_fwd": deformable_kernel.ms_deform_fwd_launches,
                         "ms_deform_bwd": deformable_kernel.ms_deform_bwd_launches},
            "step_ms": start.elapsed_time(end), "state": state, "grads": grads}


def own_choices(choices: dict, costs: bool = False) -> dict:
    """A step's own selection and matching, as ``replayed_choices`` replays
    them; with ``costs`` the matcher's costs too."""
    out = {"select": choices["select"], "assign": [a["assigned"] for a in choices["assign"]]}
    if costs:
        out["cost"] = [a["cost"] for a in choices["assign"]]
    return out


@contextlib.contextmanager
def planted_fault(fault: str, trainer, rank: int):
    """A fault planted for the ``rtdetr_2x1`` checks' controls:
    ``numerators_local`` has ``detr_loss`` sum only its two counts over the
    ranks (each rank's numerators stay its own, so the gradient comes out
    ranks x too small); ``rank1_loss_halved`` halves rank 1's loss."""
    real_mesh, real_loss = hungarian_module.active_mesh, trainer.loss_fn

    class CountsOnly:
        def __init__(self, mesh):
            self.mesh = mesh

        def all_reduce(self, flat):
            return torch.cat([flat[:-2], self.mesh.all_reduce(flat)[-2:]])

    def halved(*a, **k):
        total, metrics = real_loss(*a, **k)
        return total * 0.5, metrics

    if fault == "numerators_local":
        hungarian_module.active_mesh = lambda: CountsOnly(real_mesh())
    elif fault == "rank1_loss_halved":
        if rank == 1:
            trainer.loss_fn = halved
    else:
        raise ValueError(f"unknown fault {fault}")
    try:
        yield
    finally:
        hungarian_module.active_mesh, trainer.loss_fn = real_mesh, real_loss


class RankLoader:
    """``fit``'s loader contract over this process's strided shard of a
    global host split (as ``DetectionLoader`` shards it)."""

    def __init__(self, data: dict, local_batch: int, rank: int, world: int):
        self.process_index, self.process_count = rank, world
        self.data, self.local_batch = data, local_batch
        self.idx = list(range(len(data["image"])))[rank::world]

    def __len__(self):
        return len(self.idx) // self.local_batch

    def __iter__(self):
        for i in range(len(self)):
            sel = self.idx[i * self.local_batch:(i + 1) * self.local_batch]
            yield {k: v[sel] for k, v in self.data.items()}


def host_split(n: int, seed: int) -> dict:
    """``yolo_train_batch``'s frames as host numpy arrays."""
    return {k: v.numpy() for k, v in yolo_train_batch(n, seed, torch.device("cpu")).items()}


def multigpu_fit(dev, mesh, work: Path) -> dict:
    """One epoch of ``fit`` on ``mesh`` validating with ``make_ema_val_fn``:
    the history, B1's launches on this rank (rank 0 validates), the time."""
    from multimodal_moe_torch.parallel.distributed import loader_shard

    rank, world = loader_shard()
    data = host_split(MULTIGPU_FIT_FRAMES, seed=MULTIGPU_SEED + 5)
    val = host_split(MULTIGPU_VAL_FRAMES, seed=MULTIGPU_SEED + 6)
    val_batches = [{k: v[i:i + MULTIGPU_VAL_B] for k, v in val.items()}
                   for i in range(0, MULTIGPU_VAL_FRAMES, MULTIGPU_VAL_B)]
    trainer = yolo_trainer(dev, MULTIGPU_B, dispatch="gmm", mesh=mesh, epochs=1)
    val_fn = evaluator.make_ema_val_fn(trainer.model, lambda: iter(val_batches))
    nms_kernel.nms_keep_launches = 0
    t0 = time.perf_counter()
    _, summary = trainer.fit(RankLoader(data, MULTIGPU_B // world, rank, world),
                             run_dir=work / "fit_val", val_fn=val_fn, log_every=1)
    torch.cuda.synchronize()
    return {"history": summary["history"], "nms_keep": nms_kernel.nms_keep_launches,
            "fit_s": time.perf_counter() - t0, "val_batches": len(val_batches)}


def to_cpu(obj):
    """Every tensor of a nested dict on the host."""
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    return obj.detach().to("cpu", copy=True) if torch.is_tensor(obj) else obj


def multigpu_rank(work: Path) -> int:
    """One rank of the ``multigpu`` phase (``chip_smoke.py --multigpu-rank
    DIR``, started by ``run_ranks``): every case's first step on its mesh,
    then a second step for its time; rank 0 writes the records."""
    from multimodal_moe_torch.parallel.distributed import (
        loader_shard, maybe_initialize_distributed, rank_device)
    from multimodal_moe_torch.parallel.mesh import batch_slice, create_mesh
    from multimodal_moe_torch.train.state import one_process_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(backend="gloo")
    rank, world = loader_shard()
    dev = rank_device()
    meshes = {(nd, ne): create_mesh(nd, ne) for _, _, _, nd, ne in MULTIGPU_CASES}
    batch = multigpu_batch(dev)
    records = {}
    for name, moe, dispatch, nd, ne in MULTIGPU_CASES:
        mesh = meshes[(nd, ne)]
        trainer = yolo_trainer(dev, MULTIGPU_B, moe=moe, dispatch=dispatch, mesh=mesh)
        state = trainer.init_state()
        rows = batch_slice(mesh, MULTIGPU_B)
        local = {k: v[rows] for k, v in batch.items()}
        r = multigpu_step(trainer, state, local)
        state = r.pop("state")
        rec = {"metrics": r["metrics"], "launches": r["launches"], "first_step_ms": r["step_ms"],
               "state": to_cpu(one_process_state_dict(state, mesh)),
               "logits": [mesh.gather(x.contiguous()).cpu() for x in r["logits"]]}
        rec["step_ms"] = multigpu_step(trainer, state, local)["step_ms"]
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        if rank != 0:
            rec = {k: rec[k] for k in ("metrics", "launches", "first_step_ms", "step_ms",
                                       "peak_mem_gib")}
        records[name] = rec
        del trainer, state, r
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    del batch

    # RT-DETR on 2 x 1: the first step on the one-process step's assignments
    # (its own recorded beside them), then a second step for its time.
    name, nd, ne = MULTIGPU_RT
    mesh = meshes[(nd, ne)]
    batch = rt_train_batch(MULTIGPU_B, seed=MULTIGPU_RT_SEED, dev=dev)
    rows = batch_slice(mesh, MULTIGPU_B)
    local = {k: v[rows] for k, v in batch.items()}
    replay = torch.load(work / "rt_choices.pt", weights_only=True)
    trainer = rtdetr_trainer(dev, MULTIGPU_B, mesh=mesh)
    state = trainer.init_state()
    global_rows = torch.arange(MULTIGPU_B)[rows]
    r = rt_multigpu_step(trainer, state, local, replay=replay, rows=global_rows,
                         keep_cost=True, keep_grads=rank == 0)
    state = r.pop("state")
    sd = one_process_state_dict(state, mesh)
    rec = {"metrics": r["metrics"], "launches": r["launches"], "first_step_ms": r["step_ms"],
           "own": own_choices(r["choices"], costs=True), "grads": r["grads"]}
    if rank == 0:
        rec.update(model=to_cpu(sd["model"]), mu=to_cpu(sd["opt_state"]["mu"]),
                   ema=to_cpu(sd["ema_params"]))
    rec["step_ms"] = rt_multigpu_step(trainer, state, local)["step_ms"]
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del state, r, sd
    torch.cuda.empty_cache()
    # The checks' controls: the same first step with a fault planted.
    rec["controls"] = {}
    for fault in MG_RT_CONTROLS:
        state = trainer.init_state()
        with planted_fault(fault, trainer, rank):
            r = rt_multigpu_step(trainer, state, local, replay=replay, rows=global_rows,
                                 keep_grads=rank == 0)
        rec["controls"][fault] = {"metrics": r["metrics"], "grads": r["grads"]}
        del state, r
        torch.cuda.empty_cache()
    records[name] = rec
    del trainer, batch, local
    torch.cuda.empty_cache()

    records["fit"] = multigpu_fit(dev, meshes[(1, 2)], work)
    torch.save(records, work / f"rank{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def step_errors(got: dict, ref: dict) -> dict:
    """The multi-rank state after a step against the one-process one, each
    as a ratio to its tolerance (the CPU tests' rules): parameters against
    1e-3 of their update plus an ulp an element, momentum traces 1e-3 of
    their norm, running means 1e-6 of √var, running variances 1e-6 of var."""
    out = {"param": 0.0, "trace": 0.0, "bn_mean": 0.0, "bn_var": 0.0}
    for k, want in ref["model"].items():
        have = got["model"][k].double()
        want = want.double()
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_mean"):
            var = ref["model"][k.replace("running_mean", "running_var")].double()
            out["bn_mean"] = max(out["bn_mean"], float(((have - want).abs() / var.sqrt()).max()))
        elif k.endswith("running_var"):
            out["bn_var"] = max(out["bn_var"], float(((have - want).abs() / want).max()))
        else:
            tol = MG_PARAM_TOL * float((want - ref["before"][k].double()).norm()) \
                + float(torch.finfo(torch.float32).eps * want.norm())
            out["param"] = max(out["param"], float((have - want).norm()) / max(tol, 1e-30))
    for k, want in ref["opt_state"]["trace"].items():
        d = (got["opt_state"]["trace"][k].double() - want.double()).norm()
        out["trace"] = max(out["trace"], float(d / want.double().norm().clamp_min(1e-30)))
    return out


def routing_compare(got: list, ref: list) -> list:
    """Each MoE level's top-2 expert sets, multi-rank against one process:
    the tokens whose sets differ, and the near ties, the tokens whose 2nd
    and 3rd probabilities are within twice the largest probability
    difference. The two steps sum in different orders (a rank's convolutions
    see 8 images, not 16; BatchNorm adds two partial sums), so a near tie
    may fall either way; a set may differ only there."""
    out = []
    for g, r in zip(got, ref):
        pg, pr = torch.softmax(g.double(), -1), torch.softmax(r.double(), -1)
        pick = lambda p: torch.sort(torch.topk(p, MOE_K).indices, -1).values  # noqa: E731
        differ = (pick(pg) != pick(pr)).any(-1)
        ordered = torch.sort(pr, -1, descending=True).values
        near = (ordered[:, MOE_K - 1] - ordered[:, MOE_K]) <= 2 * float((pg - pr).abs().max())
        out.append({"tokens": int(g.shape[0]), "differ": int(differ.sum()),
                    "near_ties": int(near.sum()), "differ_outside_near_ties":
                    int((differ & ~near).sum()), "max_logit_diff": float((g - r).abs().max())})
    return out


def rt_global_draws(trainer, dev) -> dict:
    """The draws the trainer's first step makes for the global batch:
    ``train_augment``'s from stream 0, the denoising ``shift_u`` then
    ``scale_u`` from stream 1 (``build_denoising_queries``' order)."""
    shape = (MULTIGPU_B, 2 * RT_DN_GROUPS, RT_MAX_BOXES, 2)
    dn = trainer._generator(0, 1)
    shift = torch.rand(shape, generator=dn, device=dev) * 2 - 1
    scale = torch.rand(shape, generator=dn, device=dev) - 0.5
    return {"augment": augment_draws(MULTIGPU_B, trainer._generator(0, 0), dev),
            "denoise": (shift, scale)}


def rtdetr_reference(dev, work: Path) -> dict:
    """The one-process RT-DETR step on the global batch with its query
    selection and matching recorded (the matcher's costs kept; both written
    to ``work`` for the ranks to replay), then a second step for its time.
    Then the noise floor, two more one-process first steps on the same
    draws, selection and matching: ``repeated`` (the same batch again: the
    card's own run-to-run rounding) and ``reordered`` (the batch's halves
    swapped, which changes only the order of the batch's sums)."""
    batch = rt_train_batch(MULTIGPU_B, seed=MULTIGPU_RT_SEED, dev=dev)
    trainer = rtdetr_trainer(dev, MULTIGPU_B)
    state = trainer.init_state()
    before = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats(dev)
    r = rt_multigpu_step(trainer, state, batch, keep_cost=True, keep_grads=True)
    state = r.pop("state")
    replay = own_choices(r["choices"])
    torch.save(replay, work / "rt_choices.pt")
    sd = state.state_dict()
    ref = {"metrics": r["metrics"], "launches": r["launches"], "assign": r["choices"]["assign"],
           "select": replay["select"], "grads": r["grads"], "before": before,
           "model": to_cpu(sd["model"]),
           "mu": to_cpu(sd["opt_state"]["mu"]), "ema": to_cpu(sd["ema_params"]),
           "step_ms": rt_multigpu_step(trainer, state, batch)["step_ms"],
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    del state, r, sd
    torch.cuda.empty_cache()

    draws = rt_global_draws(trainer, dev)
    for name, perm in (("repeated", torch.arange(MULTIGPU_B)),
                       ("reordered", torch.roll(torch.arange(MULTIGPU_B), MULTIGPU_B // 2))):
        on_dev = perm.to(dev)
        state = trainer.init_state()
        r = rt_multigpu_step(
            trainer, state, {k: v[on_dev] for k, v in batch.items()}, replay=replay, rows=perm,
            draws={"augment": {k: v[on_dev] for k, v in draws["augment"].items()},
                   "denoise": tuple(d[on_dev] for d in draws["denoise"])},
            keep_cost=True, keep_grads=True)
        own = own_choices(r["choices"], costs=True)
        inverse = torch.argsort(perm)
        in_order = lambda a: a.reshape((-1, MULTIGPU_B) + a.shape[1:])[:, inverse].reshape(  # noqa: E731
            a.shape)
        ref[name] = {
            "metrics": r["metrics"], "mu": to_cpu(r["state"].opt.state["mu"]),
            "grads": r["grads"],
            "own": {"select": [own["select"][0][inverse]],
                    "assign": [in_order(a) for a in own["assign"]],
                    "cost": [in_order(c) for c in own["cost"]]}}
        del state, r
    del trainer, batch
    torch.cuda.empty_cache()
    return ref


def rel_diff(got: dict, ref: dict) -> float:
    """‖got − ref‖ / ‖ref‖ over all tensors of ``ref`` together."""
    diff = sum(float(((got[k] - v).double() ** 2).sum()) for k, v in ref.items())
    return (diff / max(sum(float((v.double() ** 2).sum()) for v in ref.values()), 1e-300)) ** 0.5


def rt_step_errors(got: dict, ref: dict) -> dict:
    """The multi-rank RT-DETR state after its first step against the
    one-process one: parameters (the first step's lr is 0) and running
    statistics by ``step_errors``' rules, Adam's ``mu`` (0.1 of the
    gradient) and the EMA over all tensors together, relative to their
    norms; and ``mu`` of the repeated and reordered one-process steps."""
    out = step_errors({"model": got["model"]}, {"model": ref["model"], "before": ref["before"],
                                                "opt_state": {"trace": {}}})
    del out["trace"]
    out["mu"], out["ema"] = rel_diff(got["mu"], ref["mu"]), rel_diff(got["ema"], ref["ema"])
    for name in ("repeated", "reordered"):
        out[f"{name}_mu"] = rel_diff(ref[name]["mu"], ref["mu"])
    return out


def choice_flips(own: dict, ref: dict) -> dict:
    """A run's own query selection and matching (in the global batch's
    order) against the one-process step's: the images that selected
    another query set, the (layer × image) problems assigned otherwise, the
    one-process optimality margins among those, and the near-tie bound.
    Both runs match the same queries (the selection replayed), so with
    costs ``C`` (one process) and ``C'`` (the run), each matcher exact,
    ``C(A') − C(A) ≤ Σ_A' |C' − C| + Σ_A |C' − C|``: a run's assignment
    ``A'`` may cost more than ``A`` under ``C`` only by what the two costs
    differ on the two assignments. ``excess_within_bound`` says every
    differing problem keeps that bound (else a matcher is not exact or was
    given other costs)."""
    pick = lambda i: torch.sort(i, -1).values  # noqa: E731
    select = int((pick(own["select"][0]) != pick(ref["select"][0])).any(-1).sum())
    want = ref["assign"][0]
    differ = torch.nonzero((own["assign"][0] != want["assigned"]).any(-1)).flatten().tolist()
    margins = [assignment_margin(want["cost"][i].numpy(), want["valid"][i].numpy())
               for i in differ]
    out = {"images": int(ref["select"][0].shape[0]), "selection_differs": select,
           "problems": int(want["assigned"].shape[0]), "matching_differs": len(differ),
           "max_margin_of_differing": max(margins) if margins else None,
           "differing_with_margin_le_1e-5": sum(m <= 1e-5 for m in margins)}
    if "cost" in own:
        got_cost, excess = own["cost"][0].double(), []
        for i in differ:
            cols = torch.nonzero(want["valid"][i]).flatten()
            c_ref = want["cost"][i].double()
            delta = (got_cost[i] - c_ref).abs()
            a_own, a_ref = own["assign"][0][i][cols], want["assigned"][i][cols]
            excess.append((float(c_ref[a_own, cols].sum() - c_ref[a_ref, cols].sum()),
                           float(delta[a_own, cols].sum() + delta[a_ref, cols].sum())))
        valid = want["valid"][:, None, :].expand_as(got_cost)
        out.update(max_cost_diff=float((got_cost - want["cost"].double()).abs()[valid].max()),
                   max_excess=max((x for x, _ in excess), default=None),
                   excess_within_bound=all(x <= b + 1e-6 for x, b in excess))
    return out


def grad_errors(got: dict, ref: dict, noise: dict) -> dict:
    """A step's gradient (summed over the ranks, before the clip) against
    the one-process step's, beside the one-process ``noise`` steps': the
    global norm's relative error; the scale ``<g, g_ref> / |g_ref|^2 - 1``,
    of the whole and of each group of leaves (the model's top-level
    modules), which the float32 noise barely moves (it turns the gradient's
    direction, it does not rescale it) and a fault in the loss's sums
    moves by a fraction of one; the relative error of the whole and of each
    group; the five leaves the noise moves most. Leaves without gradient
    are left out."""
    live = [k for k, v in ref.items() if bool(v.any())]
    names = {k: k.split(".")[0] for k in live}

    def sums(g):
        """Per group: <g, ref>, |ref|^2, |g - ref|^2, |g|^2."""
        out = {}
        for k in live:
            x, r = g[k].double(), ref[k].double()
            acc = out.setdefault(names[k], [0.0, 0.0, 0.0, 0.0])
            acc[0] += float((x * r).sum())
            acc[1] += float((r * r).sum())
            acc[2] += float(((x - r) ** 2).sum())
            acc[3] += float((x * x).sum())
        return out

    def summary(acc):
        tot = [sum(v[i] for v in acc.values()) for i in range(4)]
        return {"norm_rel_err": abs((tot[3] / tot[1]) ** 0.5 - 1), "scale": tot[0] / tot[1] - 1,
                "rel_err": (tot[2] / tot[1]) ** 0.5,
                "groups": {n: {"scale": v[0] / v[1] - 1, "rel_err": (v[2] / v[1]) ** 0.5,
                               "share_of_norm": (v[1] / tot[1]) ** 0.5}
                           for n, v in acc.items() if v[1] > 0}}

    mine, others = summary(sums(got)), {n: summary(sums(g)) for n, g in noise.items()}
    leaf_noise = {k: max(float((g[k].double() - ref[k].double()).norm() / ref[k].double().norm())
                         for g in noise.values()) for k in live}
    for n, grp in mine["groups"].items():
        grp["noise_scale"] = max(abs(o["groups"][n]["scale"]) for o in others.values())
        grp["noise_rel_err"] = max(o["groups"][n]["rel_err"] for o in others.values())
    return {**mine, "one_process_norm": sum(float((ref[k].double() ** 2).sum())
                                              for k in live) ** 0.5,
            "noise": {n: {k: o[k] for k in ("norm_rel_err", "scale", "rel_err")}
                      for n, o in others.items()},
            "leaves": len(ref), "live_leaves": len(live),
            "loudest_leaves": {k: {"noise_rel_err": leaf_noise[k],
                                   "rel_err": float((got[k].double() - ref[k].double()).norm()
                                                    / ref[k].double().norm())}
                               for k in sorted(live, key=lambda k: -leaf_noise[k])[:5]}}


def rt_step_record(metrics_by_rank: list, grads: dict, ref: dict) -> dict:
    """A mesh step's loss and gradient against the one-process step's, and
    which checks they pass (``rt_checks``)."""
    got = metrics_by_rank[0]
    loss, ref_loss = got["loss"], ref["metrics"]["loss"]
    rec = {"loss": loss, "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
           "parts_err_over_loss": max(abs(got[k] - v) / abs(ref_loss)
                                      for k, v in ref["metrics"].items()),
           "noise_loss_rel_err": {n: abs(ref[n]["metrics"]["loss"] - ref_loss) / abs(ref_loss)
                                  for n in ("repeated", "reordered")},
           "metric_keys_equal": set(got) == set(ref["metrics"]),
           "metrics_equal_on_ranks": all(m == got for m in metrics_by_rank),
           "grad": grad_errors(grads, ref["grads"],
                               {n: ref[n]["grads"] for n in ("repeated", "reordered")})}
    rec["checks"] = rt_checks(rec)
    return rec


def rt_checks(rec: dict) -> dict:
    """``rtdetr_2x1``'s checks of a step's loss and gradient: the loss and
    its parts, the gradient's norm and scale each within
    ``MG_RT_NOISE_FACTOR`` times the one-process noise (with their floors),
    and the scale of every group whose direction the noise moves by at most
    ``MG_RT_GROUP_NOISE`` within ``MG_RT_GROUP_SCALE_TOL``."""
    factor, g = MG_RT_NOISE_FACTOR, rec["grad"]
    loss_tol = max(factor * max(rec["noise_loss_rel_err"].values()), MG_RT_LOSS_RTOL)
    noise = g["noise"].values()
    norm_tol = max(factor * max(n["norm_rel_err"] for n in noise), MG_RT_GRAD_SCALE_RTOL)
    scale_tol = max(factor * max(abs(n["scale"]) for n in noise), MG_RT_GRAD_SCALE_RTOL)
    steady = [v for v in g["groups"].values() if v["noise_rel_err"] <= MG_RT_GROUP_NOISE]
    return {
        "loss": bool(np.isfinite(rec["loss"]) and rec["loss_rel_err"] <= loss_tol
                     and rec["parts_err_over_loss"] <= loss_tol and rec["metric_keys_equal"]),
        "metrics_equal_on_ranks": rec["metrics_equal_on_ranks"],
        "grad_norm": g["norm_rel_err"] <= norm_tol,
        "grad_scale": abs(g["scale"]) <= scale_tol,
        "group_scales": len(steady) > 0
        and all(abs(v["scale"]) <= MG_RT_GROUP_SCALE_TOL for v in steady)}


def ranks_choices(ranks: list) -> dict:
    """The ranks' own selection, matching and matcher costs put back in the
    global batch's order."""
    owns = [r["own"] for r in ranks]
    layers = owns[0]["assign"][0].shape[0] * len(ranks) // MULTIGPU_B

    def cat(key):
        parts = [o[key][0].reshape((layers, MULTIGPU_B // len(ranks)) + o[key][0].shape[1:])
                 for o in owns]
        return [torch.cat(parts, 1).reshape((layers * MULTIGPU_B,) + parts[0].shape[2:])]

    return {"select": [torch.cat([o["select"][0] for o in owns])], "assign": cat("assign"),
            "cost": cat("cost")}


def phase_multigpu(dev, smi: str) -> dict:
    """The trainer on a mesh: two gloo ranks on the one card (NCCL refuses
    two ranks on one device), MoE-YOLO-s (E=4) at 704x1248, global B=16,
    on 1 data x 2 expert (``sweep``, ``gmm``) and 2 x 1 (``auto``), YOLO-s
    on 2 x 1 and RT-DETR r50vd on 2 x 1, fp32 with TF32 off: each first
    step against the one-process step on the same global batch, weights and
    draws (RT-DETR's on the one-process query selection and matching, its
    own recorded, beside the one-process step on the reordered batch); B3's
    launches a rank on ``gmm``, B4's and B5's on RT-DETR; a one-epoch
    ``fit`` of MoE-YOLO-s on 1 x 2 validating with ``make_ema_val_fn``
    (rank 0 evaluates, the metrics broadcast); then
    ``dryrun_multichip(2)`` through NCCL (one rank: the card is one)."""
    from multimodal_moe_torch.entry import dryrun_multichip
    from multimodal_moe_torch.parallel.distributed import run_ranks

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = multigpu_batch(dev)
    refs = {}
    for name, moe, dispatch, _, _ in MULTIGPU_CASES:
        trainer = yolo_trainer(dev, MULTIGPU_B, moe=moe, dispatch=dispatch)
        state = trainer.init_state()
        before = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats(dev)
        r = multigpu_step(trainer, state, batch)
        state = r.pop("state")
        sd = state.state_dict()
        refs[name] = {"metrics": r["metrics"], "launches": r["launches"],
                      "logits": [x.cpu() for x in r["logits"]], "before": before,
                      "model": to_cpu(sd["model"]), "opt_state": to_cpu(sd["opt_state"]),
                      "step_ms": multigpu_step(trainer, state, batch)["step_ms"],
                      "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        del trainer, state, r, sd
        torch.cuda.empty_cache()
    del batch
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        rt_ref = rtdetr_reference(dev, work)
        t0 = time.perf_counter()
        run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--multigpu-rank", str(work)],
                  MULTIGPU_RANKS, timeout=600, cwd=str(ROOT))
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                 for r in range(MULTIGPU_RANKS)]
        progress = json.loads((work / "fit_val" / "fit_progress.json").read_text())
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = dryrun_multichip(2)
    dry_s = time.perf_counter() - t0

    rec = {"phase": "multigpu", "gpu": smi, "ranks": MULTIGPU_RANKS, "backend": "gloo",
           "note": "two ranks sharing one card over gloo (collectives staged through the "
                   "host by gloo): not a multi-GPU speed",
           "batch": MULTIGPU_B, "img_hw": [IMG_H, IMG_W], "ranks_s": ranks_s, "cases": {},
           "dryrun_multichip": {**dry, "seconds": dry_s}, **tf32_state()}
    for name, moe, dispatch, nd, ne in MULTIGPU_CASES:
        ref, got = refs[name], ranks[0][name]
        loss, ref_loss = got["metrics"]["loss"], ref["metrics"]["loss"]
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        rec["cases"][name] = {
            "model": "moe-yolo-s E=4" if moe else "yolo-s", "dispatch": dispatch if moe else None,
            "mesh": {"data": nd, "expert": ne}, "loss": got["metrics"]["loss"],
            "one_process_loss": ref["metrics"]["loss"], "loss_rel_err": loss_rel,
            "metrics_equal_on_ranks": all(r[name]["metrics"] == got["metrics"] for r in ranks),
            "errors_over_tolerance": step_errors(got["state"], ref),
            "routing": routing_compare(got["logits"], ref["logits"]) if moe else None,
            "launches_per_rank": [r[name]["launches"] for r in ranks],
            "one_process_launches": ref["launches"],
            "first_step_ms_per_rank": [r[name]["first_step_ms"] for r in ranks],
            "step_ms_per_rank": [r[name]["step_ms"] for r in ranks],
            "one_process_step_ms": ref["step_ms"],
            "peak_mem_gib_per_rank": [r[name]["peak_mem_gib"] for r in ranks],
            "one_process_peak_mem_gib": ref["peak_mem_gib"],
        }
    name = MULTIGPU_RT[0]
    got = ranks[0][name]
    rec["rtdetr"] = {
        "name": name, "model": "rtdetr r50vd, remat, AdamW 1e-4",
        "mesh": {"data": MULTIGPU_RT[1], "expert": MULTIGPU_RT[2]},
        "one_process_loss": rt_ref["metrics"]["loss"],
        **rt_step_record([r[name]["metrics"] for r in ranks], got["grads"], rt_ref),
        "controls": {f: rt_step_record([r[name]["controls"][f]["metrics"] for r in ranks],
                                       got["controls"][f]["grads"], rt_ref)
                     for f in MG_RT_CONTROLS},
        "errors": rt_step_errors(got, rt_ref),
        "own_choices": choice_flips(ranks_choices([r[name] for r in ranks]), rt_ref),
        "noise_own_choices": {n: choice_flips(rt_ref[n]["own"], rt_ref)
                              for n in ("repeated", "reordered")},
        "launches_per_rank": [r[name]["launches"] for r in ranks],
        "one_process_launches": rt_ref["launches"],
        "first_step_ms_per_rank": [r[name]["first_step_ms"] for r in ranks],
        "step_ms_per_rank": [r[name]["step_ms"] for r in ranks],
        "one_process_step_ms": rt_ref["step_ms"],
        "peak_mem_gib_per_rank": [r[name]["peak_mem_gib"] for r in ranks],
        "one_process_peak_mem_gib": rt_ref["peak_mem_gib"]}
    fits = [r["fit"] for r in ranks]
    rec["fit"] = {"model": "moe-yolo-s E=4 gmm", "mesh": {"data": 1, "expert": 2},
                  "frames": MULTIGPU_FIT_FRAMES, "val_frames": MULTIGPU_VAL_FRAMES,
                  "history_equal_on_ranks": all(f["history"] == fits[0]["history"] for f in fits),
                  "progress_equal": progress["history"] == fits[0]["history"],
                  "val": {k: v for k, v in fits[0]["history"][-1].items() if k.startswith("val_")
                          and not k.startswith("val_speed")},
                  "loss": fits[0]["history"][-1].get("loss"),
                  "nms_keep_per_rank": [f["nms_keep"] for f in fits],
                  "fit_s_per_rank": [f["fit_s"] for f in fits]}
    emit(rec)
    rt = rec["rtdetr"]
    check(all(rt["checks"].values()),
          f"multigpu {name}: loss {rt['loss']} against one process {rt['one_process_loss']}, "
          f"checks {rt['checks']}, gradient {rt['grad']}")
    for fault, c in rt["controls"].items():
        check(not all(c["checks"].values()),
              f"multigpu {name}: the planted fault {fault} passed every check {c}")
    own = rt["own_choices"]
    check(own["excess_within_bound"],
          f"multigpu {name}: the ranks' own matching prefers assignments beyond the cost "
          f"difference {own}")
    e = rt["errors"]
    check(e["param"] <= 1.0 and e["bn_mean"] <= MG_RT_BN_TOL and e["bn_var"] <= MG_RT_BN_TOL
          and e["mu"] <= max(MG_RT_NOISE_FACTOR * max(e["repeated_mu"], e["reordered_mu"]),
                             MG_RT_GRAD_RTOL)
          and e["ema"] <= MG_RT_GRAD_RTOL, f"multigpu {name}: state after the step {e}")
    want = {"ms_deform_fwd": 6, "ms_deform_bwd": 6}
    check(all(lr == want for lr in rt["launches_per_rank"]) and rt["one_process_launches"] == want,
          f"multigpu {name}: B4/B5 launches a rank {rt['launches_per_rank']}, expected {want}")
    f = rec["fit"]
    check(f["history_equal_on_ranks"] and f["progress_equal"]
          and f["val"].get("val_n_images") == MULTIGPU_VAL_FRAMES
          and f["loss"] is not None and np.isfinite(f["loss"]),
          f"multigpu fit: the ranks' histories and validation {f}")
    check(f["nms_keep_per_rank"] == [fits[0]["val_batches"], 0],
          f"multigpu fit: B1 launches a rank {f['nms_keep_per_rank']}")
    for name, c in rec["cases"].items():
        check(np.isfinite(c["loss"]) and c["loss_rel_err"] <= MG_LOSS_RTOL,
              f"multigpu {name}: loss {c['loss']} against one process {c['one_process_loss']}")
        check(c["metrics_equal_on_ranks"], f"multigpu {name}: every rank holds the global metrics")
        e = c["errors_over_tolerance"]
        check(e["param"] <= 1.0 and e["trace"] <= MG_TRACE_RTOL and e["bn_mean"] <= MG_BN_TOL
              and e["bn_var"] <= MG_BN_TOL, f"multigpu {name}: state after the step {e}")
        if c["routing"] is not None:
            check(all(lv["differ_outside_near_ties"] == 0
                      and lv["near_ties"] <= MG_NEAR_TIE_SHARE * lv["tokens"]
                      for lv in c["routing"]),
                  f"multigpu {name}: routing {c['routing']}")
        gmm = c["dispatch"] == "gmm"
        want = {"gmm_forward": 6, "gmm_transposed": 6, "tgmm": 6} if gmm else \
            {"gmm_forward": 0, "gmm_transposed": 0, "tgmm": 0}
        check(all(lr == want for lr in c["launches_per_rank"]),
              f"multigpu {name}: B3 launches a rank {c['launches_per_rank']}, expected {want}")
    check(dry["ranks"] == min(2, torch.cuda.device_count()) and dry["backend"] == "nccl"
          and np.isfinite(dry["loss"]), f"dryrun_multichip(2): {dry}")
    return rec


# --------------------------------------------------------------------------
# remat: YOLO's trunk recomputed during backward, on the card
# --------------------------------------------------------------------------

# A MoE level's gradient against its norm. Its expert biases' gradients
# add by ``index_add_`` (atomics: any order), so they differ between two
# runs of one step by ~1e-5 with or without remat; every other gradient
# must be bitwise equal.
REMAT_GRAD_TOL = 1e-4


def remat_step(dev, remat: bool, batch: dict) -> dict:
    """One train step of scripts/train_moe.py's trainer on ``gmm`` (seed-0
    weights): its gradients, loss, peak memory above the state and time,
    then the time of two more steps."""
    gen = torch.Generator().manual_seed(0)
    template = MoEYoloDetector(num_classes=1, variant="s", num_experts=MOE_E, k=MOE_K,
                               capacity_factor=MOE_CF, dispatch="gmm", generator=gen,
                               remat=remat)
    trainer = yolo_trainer(dev, YOLO_B, dispatch="gmm", template=template)
    state = trainer.init_state()
    grads, apply = {}, state.apply_gradients

    def keep(g):
        if not grads:
            grads.update({k: v.detach().clone() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = keep
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _, metrics = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    rec = {"remat": remat, "loss": float(metrics["loss"]), "first_step_ms": start.elapsed_time(end),
           "state_gib": base / 2**30, "peak_mem_gib": peak / 2**30,
           "peak_above_state_gib": (peak - base) / 2**30,
           "step_ms": cuda_ms(lambda: trainer.train_step(state, batch), reps=2, warmup=0)}
    del trainer, state
    torch.cuda.empty_cache()
    return rec, grads


def grad_compare(got: dict, ref: dict) -> dict:
    rel = {k: float((got[k] - g).norm() / g.norm().clamp_min(1e-30)) for k, g in ref.items()}
    worst = max(rel, key=rel.get)
    differ = sorted(k for k, g in ref.items() if not torch.equal(got[k], g))
    return {"bitwise": not differ, "tensors": len(ref), "differ": differ,
            "max_rel_err": rel[worst], "worst": worst}


def phase_remat(dev, smi: str) -> dict:
    """The training phases' setting (TF32 on, as scripts/train_moe.py runs),
    with cuDNN deterministic for the comparison. (Deterministic without TF32
    picks other convolution algorithms: 35.6 GiB and 403 ms without remat,
    29.6 GiB and 544 ms with, on an NVIDIA H100 80GB HBM3 at 700 W.)"""
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    batch = yolo_train_batch(YOLO_B, seed=15, dev=dev)
    rec = {"phase": "remat", "model": "moe-yolo-s E=4 k=2 cf=1.25 arch=tpu float32 dispatch=gmm",
           "config": "scripts/train_moe.py (B=16, SGD-Nesterov, HSV + hflip)", "batch": YOLO_B,
           "img_hw": [IMG_H, IMG_W], "gpu": smi, "cudnn_deterministic": True,
           "grad_tol": REMAT_GRAD_TOL, **tf32_state()}
    try:
        off, g_off = remat_step(dev, False, batch)
        on, g_on = remat_step(dev, True, batch)
        again, g_again = remat_step(dev, False, batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rec.update(no_remat=off, remat=on, no_remat_repeat=again,
               remat_vs_no_remat=grad_compare(g_on, g_off),
               repeat_vs_no_remat=grad_compare(g_again, g_off),
               loss_equal=on["loss"] == off["loss"],
               peak_saved_gib=off["peak_mem_gib"] - on["peak_mem_gib"])
    del g_off, g_on, g_again
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    check(np.isfinite(off["loss"]) and rec["loss_equal"],
          f"remat loss {on['loss']} against {off['loss']}")
    cmp = rec["remat_vs_no_remat"]
    check(all(k.startswith("moe_level") for k in cmp["differ"])
          and cmp["max_rel_err"] <= REMAT_GRAD_TOL, f"remat gradients {cmp}")
    check(on["peak_mem_gib"] < off["peak_mem_gib"], "remat lowers the step's peak memory")
    return rec


# --------------------------------------------------------------------------
# cli: the training, evaluation and quantization entry points
# --------------------------------------------------------------------------

CLI_TRAIN_FRAMES, CLI_VAL_FRAMES = 64, 32
ROUTING_PER_CONTEXT = 5   # the val split's 32 frames hold 5 or 6 of each solar bin
CLI_TIMEOUT_S = 300
CLI_RUN_FILES = {"model_config.json", "fit_progress.json", "train_summary.json",
                 "train_summary.csv", "train_metrics.json", "run_metadata.json",
                 "run_metadata.csv", "weights"}
# A child runs the CLI module as ``python -m`` does and prints the kernels'
# launch counts at exit (each process counts from 0). ``gmm`` counts the
# forward and the transposed product; ``gmm_transposed`` counts the
# transposed alone. With ``CHIP_SMOKE_CONTEXT_IDS`` set it also prints the
# context ids that each training forward of MoE-YOLO hands its routers.
COUNTING_MAIN = """
import atexit, json, os, runpy, sys
from multimodal_moe_torch.ops import deformable_kernel, gmm_kernel, moe_kernels, moe_sweep, nms_kernel
transposed, gmm = [0], gmm_kernel.gmm
def counting_gmm(lhs, rhs, group_sizes, transpose_rhs=False):
    before = gmm_kernel.gmm_launches
    out = gmm(lhs, rhs, group_sizes, transpose_rhs)
    transposed[0] += (gmm_kernel.gmm_launches - before) if transpose_rhs else 0
    return out
gmm_kernel.gmm = counting_gmm
atexit.register(lambda: print("[launches] " + json.dumps({
    "nms_keep": nms_kernel.nms_keep_launches,
    "ms_deform_fwd": deformable_kernel.ms_deform_fwd_launches,
    "ms_deform_bwd": deformable_kernel.ms_deform_bwd_launches,
    "moe_ffn_fwd": moe_kernels.moe_ffn_fwd_launches,
    "moe_sweep_fwd": moe_sweep.moe_sweep_fwd_launches,
    "gmm": gmm_kernel.gmm_launches, "gmm_transposed": transposed[0],
    "tgmm": gmm_kernel.tgmm_launches}), flush=True))
if os.environ.get("CHIP_SMOKE_CONTEXT_IDS"):
    from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector
    seen, forward = [], MoEYoloDetector.forward
    def recording_forward(self, images, train=False, context_ids=None):
        if train and context_ids is not None:
            seen.extend(context_ids.tolist())
        return forward(self, images, train=train, context_ids=context_ids)
    MoEYoloDetector.forward = recording_forward
    atexit.register(lambda: print("[context_ids] " + json.dumps(seen), flush=True))
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def kernel_counts() -> dict:
    return {"nms_keep": nms_kernel.nms_keep_launches,
            "ms_deform_fwd": deformable_kernel.ms_deform_fwd_launches,
            "ms_deform_bwd": deformable_kernel.ms_deform_bwd_launches,
            "moe_ffn_fwd": moe_kernels.moe_ffn_fwd_launches,
            "moe_sweep_fwd": moe_sweep.moe_sweep_fwd_launches,
            "gmm": gmm_kernel.gmm_launches, "tgmm": gmm_kernel.tgmm_launches}


def zero_kernel_counts() -> None:
    nms_kernel.nms_keep_launches = 0
    deformable_kernel.ms_deform_fwd_launches = deformable_kernel.ms_deform_bwd_launches = 0
    moe_kernels.moe_ffn_fwd_launches = moe_sweep.moe_sweep_fwd_launches = 0
    gmm_kernel.gmm_launches = gmm_kernel.tgmm_launches = 0


def run_cli_child(module: str, args: list, env: dict) -> dict:
    """``module`` with ``args`` as a child: its exit code, wall seconds,
    output tail and kernel counts."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", COUNTING_MAIN, module, *map(str, args)],
                              cwd=ROOT, env={**os.environ, **env}, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = "timeout", e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    counts = [json.loads(line[len("[launches] "):]) for line in out.splitlines()
              if line.startswith("[launches] ")]
    rec = {"module": module, "rc": rc, "wall_s": time.perf_counter() - t0,
           "launches": counts[-1] if counts else None}
    if rc != 0:
        rec["tail"] = (out + err)[-3000:]
    return rec, out + err


def check_child(rec: dict, what: str) -> None:
    check(rec["rc"] == 0 and rec["launches"] is not None,
          f"{what}: exit {rec['rc']}: {rec.get('tail', '')}")


def cli_corpus(root: Path) -> dict:
    """The ``data`` phase's corpus with split CSVs of this phase: the first
    ``CLI_TRAIN_FRAMES`` frames train, the ``CLI_VAL_FRAMES`` after the
    data phase's train split validate."""
    corpus = write_data_corpus(root / "corpus")
    splits = root / "splits"
    splits.mkdir()
    for name, ids in (("train", range(CLI_TRAIN_FRAMES)),
                      ("val", range(DATA_FRAMES, DATA_FRAMES + CLI_VAL_FRAMES))):
        (splits / f"{name}_ids.csv").write_text(
            "frame_id\n" + "\n".join(f"{i:06d}" for i in ids) + "\n")
    return {"parquet": corpus["parquet"], "splits": splits}


def phase_cli(dev, smi: str, evaluate_keys: set, work: Path) -> dict:
    from multimodal_moe_torch.cli import quantize_yolo, train_rtdetr

    t0 = time.perf_counter()
    val_batches = -(-CLI_VAL_FRAMES // YOLO_B)
    steps = CLI_TRAIN_FRAMES // YOLO_B
    native = "libjpeg" not in host_lacks()
    rec = {"phase": "cli", "gpu": smi, "img_hw": [IMG_H, IMG_W], "batch": YOLO_B,
           "train_frames": CLI_TRAIN_FRAMES, "val_frames": CLI_VAL_FRAMES,
           "steps_per_epoch": steps, "val_batches": val_batches}
    root = work / "cli"
    root.mkdir()
    data = cli_corpus(root)
    common = ["--parquet", data["parquet"], "--splits-dir", data["splits"],
              "--img-h", IMG_H, "--img-w", IMG_W]   # the CLIs' defaults
    env = {"EVAL_DIR": str(work / "eval")}

    # (a) train_moe --resident, paused after one epoch, then resumed.
    run = root / "runs" / "moe"
    train = [*common, "--project", root / "runs", "--name", "moe", "--resident",
             "--epochs", "2", "--max-epochs-this-run", "1"]
    first, log1 = run_cli_child("multimodal_moe_torch.cli.train_moe", train, env)
    check_child(first, "train_moe")
    progress1 = json.loads((run / "fit_progress.json").read_text())
    second, log2 = run_cli_child("multimodal_moe_torch.cli.train_moe", [*train, "--resume"],
                                 env)
    check_child(second, "train_moe --resume")
    progress = json.loads((run / "fit_progress.json").read_text())
    stores = re.findall(r"decoded \((\w+)\)", log1 + log2)
    meta = json.loads((run / "run_metadata.json").read_text())
    rec["train_moe"] = {
        "runs": [first, second], "resident_stores": stores,
        "yuv420_fallback_said": "yuv420 path unavailable" in log1,
        "progress_epochs": [progress1["epoch"], progress["epoch"]],
        "epoch_wall_s": progress["train_wall_s_accum"] / len(progress["history"]),
        "files": sorted(os.listdir(run)), "device_kind": meta["device_kind"],
        "model_config": json.loads((run / "model_config.json").read_text()),
        "last_epoch": {k: v for k, v in progress["history"][-1].items()
                       if k in ("loss", "moe_aux_loss", "val_map50", "val_n_images")}}
    want_store = "yuv420" if native else "rgb"
    check(stores == [want_store] * 4, f"resident stores {stores}, expected {want_store}")
    check(rec["train_moe"]["progress_epochs"] == [0, 1], f"epochs {rec['train_moe']}")
    check(set(os.listdir(run)) == CLI_RUN_FILES and
          {"best", "last"} <= set(os.listdir(run / "weights")), f"run dir {os.listdir(run)}")
    check(meta["device_kind"] == torch.cuda.get_device_name(0), "run_metadata names the card")
    for r in (first, second):
        check(r["launches"]["nms_keep"] == val_batches and r["launches"]["gmm"] == 0,
              f"train_moe launches {r['launches']}")

    # (b) train_rtdetr in this process: B4 and B5 counted in training and
    # in validation (torch's defaults: cuDNN TF32 on, matmul off).
    val_counts = {}

    def counted_val(make):
        def make_val(*a, **k):
            val = make(*a, **k)

            def val_fn(state):
                before = kernel_counts()
                metrics = val(state)
                val_counts.update({k: v - before[k] for k, v in kernel_counts().items()})
                return metrics
            return val_fn
        return make_val

    tf32 = tf32_state()
    torch.backends.cudnn.allow_tf32 = True
    zero_kernel_counts()
    t1 = time.perf_counter()
    try:
        with patched(evaluator, "make_ema_val_fn", counted_val):
            train_rtdetr.main([str(a) for a in (*common, "--project", root / "runs",
                                                "--name", "rtdetr", "--epochs", "1")])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32["cudnn_allow_tf32"]
    total = kernel_counts()
    train_counts = {k: v - val_counts[k] for k, v in total.items()}
    rt_progress = json.loads((root / "runs" / "rtdetr" / "fit_progress.json").read_text())
    rec["train_rtdetr"] = {
        "wall_s": time.perf_counter() - t1, "launches": total,
        "train_launches_per_step": {k: v / steps for k, v in train_counts.items()},
        "val_launches_per_batch": {k: v / val_batches for k, v in val_counts.items()},
        "epoch_wall_s": rt_progress["train_wall_s_accum"],
        "loss": rt_progress["history"][-1].get("loss"),
        "files": sorted(os.listdir(root / "runs" / "rtdetr"))}
    torch.cuda.empty_cache()
    check(train_counts["ms_deform_fwd"] == 6 * steps and train_counts["ms_deform_bwd"] == 6 * steps,
          f"train_rtdetr: B4/B5 {train_counts}, expected 6 a step")
    check(val_counts["ms_deform_fwd"] == 6 * val_batches and val_counts["ms_deform_bwd"] == 0
          and total["nms_keep"] == 0, f"train_rtdetr validation {val_counts}, B1 {total}")
    check(set(os.listdir(root / "runs" / "rtdetr")) == CLI_RUN_FILES, "rtdetr run dir")

    # (c) eval_detector on (a)'s run.
    ev, _ = run_cli_child("multimodal_moe_torch.cli.eval_detector",
                          [*common, "--backend", "moe", "--weights", run,
                           "--run-name", "moe_cli"], env)
    check_child(ev, "eval_detector")
    metrics = json.loads((work / "eval" / "moe" / "moe_cli" / "metrics.json").read_text())
    own = {"params_total", "flops_g", "fps_inference_only", "speed_total_ms_per_img",
           "fps_end_to_end", "curves_results"}
    rec["eval_detector"] = {**ev, "n_images": metrics["n_images"],
                            "params_total": metrics["params_total"],
                            "flops_g": metrics["flops_g"],
                            "speed_inference_ms_per_img": metrics["speed_inference_ms_per_img"],
                            "extra_keys": sorted(set(metrics) - evaluate_keys)}
    check(ev["launches"]["nms_keep"] == val_batches and metrics["n_images"] == CLI_VAL_FRAMES,
          f"eval_detector: B1 {ev['launches']}, {metrics['n_images']} images")
    check(set(metrics) - own == evaluate_keys,
          f"eval keys {sorted(set(metrics) ^ (evaluate_keys | own))}")

    # (d) quantize_yolo in this process on a YOLO-s run dir, then
    # eval_detector --int8 reading its npz.
    yolo_run = write_run_dir(root / "qruns", {"family": "yolo", "variant": "s"})
    t1 = time.perf_counter()
    quantize_yolo.main([str(a) for a in (*common, "--weights", yolo_run)])
    torch.cuda.synchronize()
    npz = yolo_run / "weights" / "int8_quant_best.npz"
    rec["quantize_yolo"] = {"wall_s": time.perf_counter() - t1, "npz_bytes": npz.stat().st_size,
                            "leaves": len(np.load(npz).files)}
    torch.cuda.empty_cache()
    ev8, log8 = run_cli_child("multimodal_moe_torch.cli.eval_detector",
                              [*common, "--backend", "yolo", "--weights", yolo_run, "--int8",
                               "--run-name", "yolo_int8"], env)
    check_child(ev8, "eval_detector --int8")
    m8 = json.loads((work / "eval" / "yolo" / "yolo_int8" / "metrics.json").read_text())
    rec["eval_int8"] = {**ev8, "reused_npz": f"Loaded int8 quant tree <- {npz}" in log8,
                        "quantization": m8.get("quantization"), "n_images": m8["n_images"],
                        "speed_inference_ms_per_img": m8["speed_inference_ms_per_img"]}
    check(rec["eval_int8"]["reused_npz"] and m8.get("quantization") == "int8_w8a8_ptq",
          "eval_detector --int8 read quantize_yolo's npz")
    check(ev8["launches"]["nms_keep"] == val_batches, f"int8 eval B1 {ev8['launches']}")

    # (e) train_vision_baseline as a child on the train split (the
    # subset is the split): ResNet-50 at 256x256, B=32, two epochs.
    plot = root / "plots" / "train_acc.png"
    vb, vlog = run_cli_child("multimodal_moe_torch.cli.train_vision_baseline",
                             ["--parquet", data["parquet"],
                              "--split-csv", data["splits"] / "train_ids.csv",
                              "--img-size", 256, "--batch", 32, "--epochs", 2,
                              "--plot-path", plot], env)
    check_child(vb, "train_vision_baseline")
    epochs = [{"loss": float(loss), "acc": float(acc)}
              for loss, acc in re.findall(r"epoch \d+/2 loss=(\S+) acc=(\S+)", vlog)]
    wall = re.search(r"train wall time: (\S+)s", vlog)
    rec["train_vision_baseline"] = {
        **vb, "epochs": epochs, "steps_per_epoch": CLI_TRAIN_FRAMES // 32,
        "train_wall_s": float(wall.group(1)) if wall else None,
        "plot": "written" if plot.exists() else ("skipped" if "skipped plot" in vlog else None)}
    check(len(epochs) == 2 and all(np.isfinite(e["loss"]) for e in epochs)
          and wall is not None and rec["train_vision_baseline"]["plot"] is not None,
          f"train_vision_baseline: {rec['train_vision_baseline']}")

    # (f) analyze_moe_routing as a child on (a)'s run dir, over the val
    # split's bins (every one holds at least ROUTING_PER_CONTEXT frames).
    out_dir = root / "routing"
    ar, _ = run_cli_child("multimodal_moe_torch.cli.analyze_moe_routing",
                          [*common, "--weights", run, "--per-context", ROUTING_PER_CONTEXT,
                           "--out-dir", out_dir], env)
    check_child(ar, "analyze_moe_routing")
    payload = json.loads((out_dir / "routing_by_context.json").read_text())
    loads = {k: np.asarray(v) for k, v in payload["expert_load_by_context"].items()}
    sums = [float(x) for v in loads.values() for x in v.sum(-1)]
    rec["analyze_moe_routing"] = {
        **ar, "bins": list(loads), "report_written": (out_dir / "routing_report.md").exists(),
        "keys": sorted(payload), "load_row_sums": [min(sums), max(sums)] if sums else None,
        "max_l1_divergence": max((x for v in payload["l1_divergence_per_level"].values()
                                  for x in v), default=None),
        "max_counterfactual_shift": max((x for v in payload[
            "counterfactual_ctx_shift_per_level"].values() for x in v), default=None)}
    check(rec["analyze_moe_routing"]["report_written"] and len(loads) == len(DATA_SOLAR)
          and all(abs(x - MOE_K) <= 1e-5 for x in sums),
          f"analyze_moe_routing: {rec['analyze_moe_routing']}")
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# Phase 23: ingest -- the port's ingestion chain, then training and
# evaluation on the corpus it built
# --------------------------------------------------------------------------

INGEST_FRAMES = 160   # cut: the protocol corpus has 5,000 (build_synth_corpus's default)
# The first seed from 0 whose 160-frame corpus splits: at most seeds (seed
# 0 among them: one "0_twilight" frame) a stratum of a small corpus has a
# single frame, or too few for the 50/50 second split, and both packages'
# splits raise, as sklearn does.
INGEST_SEED = 49
INGEST_WORKERS = 8    # build_synth_corpus --workers (its default)
INGEST_HOST_PACKAGES = ("sklearn", "tqdm", "matplotlib", "tabulate")
INGEST_STAGES = ("render", "index", "boxes", "solar_bins", "splits")


def ingest_split_sizes(n: int) -> dict:
    """sklearn's sizes of the two-stage split: ``ceil(0.2 n)`` held out,
    then half of those (rounded up) to test."""
    held = -(-n // 5)
    test = -(-held // 2)
    return {"train": n - held, "val": held - test, "test": test}


def kept_boxes(row) -> int:
    """The boxes of a row that the exporters keep under their default
    ``exclude_unclear`` policy: the i-th box where the i-th unclear flag is
    false or missing."""
    unclear = list(row["ped_unclear_list"]) if row["ped_unclear_list"] is not None else []
    return sum(1 for i in range(len(row["xyxy_bboxes"])) if not (i < len(unclear) and unclear[i]))


def dir_bytes(root: Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file() and not p.is_symlink())


def symlinks_resolve(images: Path) -> "tuple[int, int]":
    links = list(images.rglob("*.jpg"))
    return len(links), sum(1 for p in links if p.is_symlink() and p.resolve().is_file())


def phase_ingest(smi: str, evaluate_keys: set, cli_extra_keys: list, work: Path) -> dict:
    """The port's ingestion CLIs on this host, then ``train_yolo``,
    ``train_moe`` and ``eval_detector`` on what they wrote, each a child."""
    import importlib.util

    import pandas as pd

    from multimodal_moe_torch.data.solar import SOLAR_BIN_TO_ID, solar_bin_labels

    t0 = time.perf_counter()
    sizes = ingest_split_sizes(INGEST_FRAMES)
    rec = {"phase": "ingest", "gpu": smi, "frames": INGEST_FRAMES, "seed": INGEST_SEED,
           "workers": INGEST_WORKERS, "img_hw": [IMG_H, IMG_W], "batch": YOLO_B,
           "split_sizes": sizes,
           "host_packages": {m: importlib.util.find_spec(m) is not None
                             for m in INGEST_HOST_PACKAGES}}
    root = work / "ingest"
    root.mkdir()
    corpus = root / "corpus"
    env = {"EVAL_DIR": str(work / "eval")}

    # (a) build: tree -> index with resized JPEGs -> boxes -> solar bins -> splits.
    build, log = run_cli_child("multimodal_moe_torch.cli.build_synth_corpus",
                               ["--root", corpus, "--frames", INGEST_FRAMES,
                                "--seed", INGEST_SEED, "--workers", INGEST_WORKERS], env)
    check_child(build, "build_synth_corpus")
    stages = json.loads(next(line for line in log.splitlines()
                             if line.startswith("[stages] "))[len("[stages] "):])["seconds"]
    summary = json.loads((corpus / "corpus_build_summary.json").read_text())
    final = Path(summary["final_parquet"])
    splits_dir = corpus / "splits"
    df = pd.read_parquet(final)
    ids = {k: pd.read_csv(splits_dir / f"{k}_ids.csv", dtype=str)["frame_id"].tolist()
           for k in sizes}
    rec["build"] = {
        **build, "stage_s": stages,
        "stage_s_per_frame": {k: v / INGEST_FRAMES for k, v in stages.items()},
        "bytes": {d: dir_bytes(corpus / d) for d in ("raw", "resized_images", "outputs",
                                                     "splits")},
        "split_sizes": summary["split_sizes"],
        "solar_bins": df["solar_context_bin"].value_counts().to_dict(),
        "boxes": int(df["xyxy_bboxes"].map(len).sum())}
    check(set(stages) == set(INGEST_STAGES), f"stages {stages}")
    check(summary["split_sizes"] == sizes and {k: len(v) for k, v in ids.items()} == sizes,
          f"split sizes {summary['split_sizes']}, expected {sizes}")
    check(len(df) == INGEST_FRAMES and not (set(ids["train"]) & set(ids["val"]))
          and not (set(ids["train"]) & set(ids["test"])) and not (set(ids["val"]) & set(ids["test"]))
          and set(ids["train"]) | set(ids["val"]) | set(ids["test"]) == set(df["frame_id"]),
          "the splits are disjoint and cover every indexed frame")
    labels = df["solar_context_bin"]
    check(bool(labels.notna().all()) and set(labels) <= set(SOLAR_BIN_TO_ID)
          and labels.tolist() == solar_bin_labels(df["solar_angle_elevation"]).tolist()
          and labels.nunique() >= 3, f"solar bins {rec['build']['solar_bins']}")

    # QA and context frequencies over the final parquet.
    qa_run, _ = run_cli_child("multimodal_moe_torch.cli.analyze_index_qa",
                              ["--parquet", final, "--out-dir", root / "qa"], env)
    check_child(qa_run, "analyze_index_qa")
    report = json.loads((root / "qa" / "qa_report.json").read_text())
    freq, freq_log = run_cli_child("multimodal_moe_torch.cli.analyze_context_frequencies",
                                   ["--parquet", final, "--out-dir", root / "ctx"], env)
    check_child(freq, "analyze_context_frequencies")
    rec["qa"] = {**qa_run, "parallel_array_violations": report["parallel_array_violations"],
                 "occlusion_mismatched_frames": report["occlusion"]["n_mismatched_frames"],
                 "n_boxes": report["bboxes"]["n_boxes"],
                 "height_px_p50": report["bboxes"]["height_px"]["p50"]}
    rec["context_frequencies"] = {
        **freq, "plot": "written" if (root / "ctx" / "context_field_frequencies.png").exists()
        else ("skipped" if "skipped plot" in freq_log else None)}
    check(report["parallel_array_violations"] == 0
          and report["occlusion"]["n_mismatched_frames"] == 0, f"QA {rec['qa']}")
    check((root / "ctx" / "context_field_frequencies.csv").exists()
          and rec["context_frequencies"]["plot"] is not None, "context frequencies")

    # (b) the YOLO and COCO exports.
    yolo_dir, coco_dir = root / "exports" / "yolo", root / "exports" / "coco"
    common = ["--parquet", final, "--splits-dir", splits_dir]
    ey, _ = run_cli_child("multimodal_moe_torch.cli.export_yolo_dataset",
                          [*common, "--out-dir", yolo_dir], env)
    check_child(ey, "export_yolo_dataset")
    ec, _ = run_cli_child("multimodal_moe_torch.cli.export_coco_dataset",
                          [*common, "--out-dir", coco_dir], env)
    check_child(ec, "export_coco_dataset")
    by_id = df.set_index("frame_id")
    want_lines, got_lines, mismatched, n_ann = 0, 0, [], 0
    for split, frame_ids in ids.items():
        for fid in frame_ids:
            want = kept_boxes(by_id.loc[fid])
            lines = (yolo_dir / "labels" / split / f"{fid}.txt").read_text().splitlines()
            ok = len(lines) == want and all(
                len(v) == 5 and v[0] == "0" and all(0.0 <= float(x) <= 1.0 for x in v[1:])
                for v in (line.split() for line in lines))
            if not ok:
                mismatched.append(fid)
            want_lines += want
            got_lines += len(lines)
        n_ann += len(json.loads((coco_dir / "annotations" / f"instances_{split}.json")
                                .read_text())["annotations"])
    links = {name: symlinks_resolve(d / "images") for name, d in (("yolo", yolo_dir),
                                                                   ("coco", coco_dir))}
    manifest = json.loads((coco_dir / "export_manifest.json").read_text())
    rec["export"] = {"yolo": ey, "coco": ec, "label_lines": got_lines,
                     "kept_boxes": want_lines, "coco_annotations": n_ann,
                     "symlinks": links, "mismatched_frames": mismatched[:10],
                     "coco_images": sum(s["n_images_written"] for s in manifest["splits"])}
    check(not mismatched and got_lines == want_lines > 0, f"labels {rec['export']}")
    check(n_ann == want_lines, f"COCO annotations {n_ann} against {want_lines} kept boxes")
    check(all(v == (INGEST_FRAMES, INGEST_FRAMES) for v in links.values())
          and rec["export"]["coco_images"] == INGEST_FRAMES, f"image symlinks {links}")

    runs = root / "runs"
    dims = ["--img-h", IMG_H, "--img-w", IMG_W]
    val_batches = -(-sizes["val"] // YOLO_B)
    test_batches = -(-sizes["test"] // YOLO_B)

    # (c) train_yolo on the YOLO export, validating on its val split.
    yolo, _ = run_cli_child("multimodal_moe_torch.cli.train_yolo",
                            ["--data-yaml", yolo_dir / "dataset.yaml", "--epochs", 1,
                             "--project", runs, "--name", "yolo", *dims], env)
    check_child(yolo, "train_yolo --data-yaml")
    rec["train_yolo"] = {**yolo, **run_summary(runs / "yolo"),
                         "steps": sizes["train"] // YOLO_B}
    check(np.isfinite(rec["train_yolo"]["loss"]) and rec["train_yolo"]["files_ok"],
          f"train_yolo: {rec['train_yolo']}")
    check(yolo["launches"]["nms_keep"] == val_batches, f"train_yolo B1 {yolo['launches']}")

    # (d) train_moe on the port's parquet and splits: over the epoch the
    # child's routers get, frame for frame, the solar bin ids of the
    # port's column on the train split (its whole train split when the
    # batch divides it, as 128 / 16 does; the loader drops a last partial
    # batch).
    moe, moe_log = run_cli_child("multimodal_moe_torch.cli.train_moe",
                                 [*common, "--epochs", 1, "--project", runs, "--name",
                                  "moe", *dims], {**env, "CHIP_SMOKE_CONTEXT_IDS": "1"})
    check_child(moe, "train_moe")
    routed = [json.loads(line[len("[context_ids] "):]) for line in moe_log.splitlines()
              if line.startswith("[context_ids] ")]
    want = Counter(SOLAR_BIN_TO_ID[label] for label in by_id.loc[ids["train"],
                                                                  "solar_context_bin"])
    got = Counter(routed[-1]) if routed else Counter()
    rec["train_moe"] = {**moe, **run_summary(runs / "moe"),
                        "routed_solar_ids": dict(sorted(got.items())),
                        "train_split_solar_ids": dict(sorted(want.items()))}
    check(np.isfinite(rec["train_moe"]["loss"]) and rec["train_moe"]["files_ok"],
          f"train_moe: {rec['train_moe']}")
    check(moe["launches"]["nms_keep"] == val_batches, f"train_moe B1 {moe['launches']}")
    check(got <= want and got.total() == sizes["train"] // YOLO_B * YOLO_B
          and len(got) >= 3,
          f"routed solar ids {dict(got)}, the train split's column {dict(want)}")

    # (e) eval_detector on (d)'s run over the test split.
    ev, _ = run_cli_child("multimodal_moe_torch.cli.eval_detector",
                          [*common, "--backend", "moe", "--weights", runs / "moe",
                           "--split", "test", "--run-name", "ingest", *dims], env)
    check_child(ev, "eval_detector")
    metrics = json.loads((work / "eval" / "moe" / "ingest" / "metrics.json").read_text())
    own = {"params_total", "flops_g", "fps_inference_only", "speed_total_ms_per_img",
           "fps_end_to_end", "curves_results"}
    rec["eval_detector"] = {**ev, "n_images": metrics["n_images"],
                            "map50": metrics.get("map50"),
                            "speed_inference_ms_per_img": metrics["speed_inference_ms_per_img"],
                            "extra_keys": sorted(set(metrics) - evaluate_keys)}
    check(ev["launches"]["nms_keep"] == test_batches and metrics["n_images"] == sizes["test"],
          f"eval_detector: B1 {ev['launches']}, {metrics['n_images']} images")
    check(set(metrics) - own == evaluate_keys
          and rec["eval_detector"]["extra_keys"] == cli_extra_keys,
          f"eval keys {sorted(set(metrics) ^ (evaluate_keys | own))}")
    children = [build, qa_run, freq, ey, ec, yolo, moe, ev]
    rec["launches"] = {k: sum(c["launches"][k] for c in children)
                       for k in [*kernel_counts(), "gmm_transposed"]}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


# --------------------------------------------------------------------------
# Phase 24: tools -- the load test against the port's server, the host
# tools, and train_vision_baseline on two ranks
# --------------------------------------------------------------------------

LOAD_LEVELS, LOAD_DURATION_S = "1,16", 3   # the CLI's defaults otherwise
LOAD_RUNS = (("yolo_raw", "yolo", LOAD_LEVELS, ["--raw"]),
             ("moe_raw", "moe", LOAD_LEVELS, ["--raw"]),
             ("yolo_jpeg", "yolo", "16", []),
             ("yolo_int8", "yolo", "16", ["--int8", "--raw"]))
LOAD_FAMILIES = {"yolo": {"family": "yolo", "variant": "s"},
                 "moe": {"family": "moe", "variant": "s", "num_experts": 4}}
VISION_RANKS, VISION_SUBSET, VISION_LOCAL_B = 2, 64, 16   # global B=32, two steps
VISION_IMG = 256          # the CLI's --img-size default
VISION_RTOL = 1e-4        # the loss's tolerance, and the gradient norm's floor
# The gradient norm moves with the order of the batch's rows alone (Flax's
# fast variance at random init, through ResNet-50's 53 BatchNorms: on the
# H100 4.1e-4 to 6.5e-4 between three orders of one batch, the ranks'
# split 1.5e-3), so the ranks' norm is held to this many times the largest
# difference between the one-process steps on three orders of the batch.
VISION_NOISE_FACTOR = 5.0
TOOLS_HOST_PACKAGES = ("nbformat", "nbclient", "matplotlib")


def first_step_recorder(cli) -> dict:
    """Wrap ``cli.loss_and_grads`` (``train_vision_baseline``'s) to record
    its first call: the loss, the accuracy, the gradient's norm (summed
    over the ranks, before the update), the batch on the host."""
    first, real = {}, cli.loss_and_grads

    def recording(model, images_u8, labels, mesh=None):
        loss, acc, grads = real(model, images_u8, labels, mesh)
        if not first:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            first.update(loss=float(loss), acc=float(acc), grad_norm=float(norm),
                         images=images_u8.cpu(), labels=labels.cpu())
        return loss, acc, grads

    cli.loss_and_grads = recording
    return first


def vision_rank(work: Path) -> int:
    """One rank of the ``tools`` phase's ``train_vision_baseline``
    (``chip_smoke.py --vision-rank DIR``, started by ``run_ranks``): the
    CLI's ``main`` on ``args.json``'s arguments over gloo (two ranks share
    the card), TF32 off; its first step, output and kernel counts to
    ``rank<r>.pt``."""
    import torch.distributed as dist

    from multimodal_moe_torch.cli import train_vision_baseline
    from multimodal_moe_torch.cli._common import platform_device
    from multimodal_moe_torch.parallel.distributed import loader_shard, maybe_initialize_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(backend="gloo", device=platform_device())
    rank, _ = loader_shard()
    first = first_step_recorder(train_vision_baseline)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train_vision_baseline.main(json.loads((work / "args.json").read_text()))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    torch.save({**first, "stdout": out.getvalue(), "wall_s": time.perf_counter() - t0,
                "launches": kernel_counts()}, work / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def load_test_child(name: str, run: Path, levels: str, extra: list, out_dir: Path) -> dict:
    """``load_test_server`` as a child on ``run``: its levels, checked."""
    rec, _ = run_cli_child("multimodal_moe_torch.cli.load_test_server",
                           ["--weights", run, "--concurrency", levels,
                            "--duration", LOAD_DURATION_S, "--out-dir", out_dir, *extra], {})
    check_child(rec, f"load_test_server {name}")
    payload = json.loads((out_dir / "load_test.json").read_text())
    calls = sum(level["device_calls"] for level in payload["levels"])
    rec.update(levels=payload["levels"], int8=payload["int8"], window_device_calls=calls)
    check([level["concurrency"] for level in payload["levels"]] ==
          [int(c) for c in levels.split(",")], f"load test {name}: levels {payload['levels']}")
    for level in payload["levels"]:
        check(level["errors"] == 0 and level["req_s"] > 0 and level["device_calls"] > 0
              and 1 <= level["mean_batch_fill"] <= YOLO_B, f"load test {name}: level {level}")
    b1 = rec["launches"]["nms_keep"]
    check(b1 > 0 and b1 >= calls,
          f"load test {name}: B1 {b1} launches against {calls} device calls in the windows")
    return rec


def host_tools(work: Path) -> dict:
    """(b): the host tools in this process on the ``ingest`` corpus and the
    eval dirs of ``cli`` and ``ingest``; none launches a kernel."""
    import importlib.util

    import pandas as pd

    from multimodal_moe_torch import paths
    from multimodal_moe_torch.cli import (print_paths, report_detector_benchmarks,
                                          sanity_dataloader, vis_boxes)

    def run(main, args) -> "tuple[str, float]":
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main([str(a) for a in args])
        return out.getvalue(), time.perf_counter() - t0

    summary = json.loads((work / "ingest" / "corpus" / "corpus_build_summary.json").read_text())
    final, splits = Path(summary["final_parquet"]), work / "ingest" / "corpus" / "splits"
    rec = {"host_packages": {m: importlib.util.find_spec(m) is not None
                             for m in TOOLS_HOST_PACKAGES},
           "host_lacks": host_lacks()}
    zero_kernel_counts()

    text, secs = run(sanity_dataloader.main, ["--parquet", final,
                                              "--split-csv", splits / "train_ids.csv"])
    lines = text.splitlines()
    rec["sanity_dataloader"] = {"lines": lines, "wall_s": secs}
    train = ingest_split_sizes(INGEST_FRAMES)["train"]
    check(len(lines) == 3 and lines[0] == f"dataset length: {train}"
          and lines[2].startswith(f"one batch: image (8, {IMG_H}, {IMG_W}, 3),"),
          f"sanity_dataloader: {lines}")

    bench = work / "tools" / "benchmarks"
    text, secs = run(report_detector_benchmarks.main,
                     ["--eval-dir", work / "eval", "--out-dir", bench])
    found = sorted(f"{d.parent.name}/{d.name}" for d in (work / "eval").glob("*/*")
                   if (d / "metrics.json").exists() or (d / "run_metadata.json").exists())
    table = pd.read_csv(bench / "baseline_runs_aggregated.csv")
    rec["report_detector_benchmarks"] = {
        "runs": [f"{f}/{r}" for f, r in zip(table["family"], table["run"])],
        "eval_run_dirs": found, "wall_s": secs,
        "plots": "written" if "Wrote plots" in text else
        ("skipped" if "skipped plots" in text else None)}
    check(rec["report_detector_benchmarks"]["runs"] == found and len(found) == 3
          and rec["report_detector_benchmarks"]["plots"] is not None,
          f"report_detector_benchmarks: {rec['report_detector_benchmarks']}")

    df = pd.read_parquet(final)
    both = df[(df["ped_count_clear"] > 0) & (df["ped_count_unclear"] > 0)]
    pool = len(both) if len(both) >= 12 else int((df["ped_count_clear"] > 0).sum())
    vis = work / "tools" / "bbox_sanity"
    text, secs = run(vis_boxes.main, ["--parquet", final, "--out-dir", vis])
    drawn = sorted(vis.glob("*.jpg"))
    rec["vis_boxes"] = {"frames": len(drawn), "pool": pool, "wall_s": secs,
                        "line": text.splitlines()[0]}
    check(len(drawn) == min(12, pool) > 0
          and text.startswith(f"Wrote {len(drawn)} annotated frames"), f"vis_boxes: {rec['vis_boxes']}")

    text, secs = run(print_paths.main, [])
    rec["print_paths"] = {"lines": len(text.splitlines()), "wall_s": secs}
    check(len(text.splitlines()) == len(paths.describe_paths()) > 0, f"print_paths: {text}")
    counts = kernel_counts()
    check(not any(counts.values()), f"the host tools launched kernels: {counts}")
    return rec


def vision_ranks(dev, work: Path, ingest_corpus: Path) -> dict:
    """(c): ``train_vision_baseline`` on two gloo ranks, then in this
    process at ``--batch`` 2x on the same global batch; the first steps."""
    from multimodal_moe_torch.cli import train_vision_baseline as cli
    from multimodal_moe_torch.models.resnet import resnet50
    from multimodal_moe_torch.parallel.distributed import run_ranks

    work.mkdir(parents=True)

    def args(batch: int, plot: Path) -> list:
        return [str(a) for a in (
            "--parquet", json.loads((ingest_corpus / "corpus_build_summary.json").read_text())[
                "final_parquet"], "--split-csv", ingest_corpus / "splits" / "train_ids.csv",
            "--epochs", 1, "--batch", batch, "--subset", VISION_SUBSET,
            "--img-size", VISION_IMG, "--plot-path", plot)]

    (work / "args.json").write_text(json.dumps(args(VISION_LOCAL_B, work / "plot.png")))
    t0 = time.perf_counter()
    run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--vision-rank", str(work)],
              VISION_RANKS, timeout=CLI_TIMEOUT_S, cwd=str(ROOT))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(VISION_RANKS)]

    real = cli.loss_and_grads
    tf32 = tf32_state()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one = first_step_recorder(cli)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(args(VISION_LOCAL_B * VISION_RANKS, work / "one" / "plot.png"))
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        cli.loss_and_grads = real
        # The one-process step on the ranks' rows, in their order and
        # reversed (the noise of the order alone), and the control: the two
        # halves each with its own BatchNorm statistics, the losses and
        # gradients averaged (a mesh without global statistics).
        orders = {}
        halves = [(r["images"].to(dev), r["labels"].to(dev)) for r in ranks]
        images, labels = (torch.cat(t) for t in zip(*halves))
        model = resnet50(num_classes=2, generator=torch.Generator().manual_seed(0)).to(dev)
        model.train()
        for name, parts in (("ranks_order", [(images, labels)]),
                            ("reversed", [(images.flip(0), labels.flip(0))]),
                            ("local_statistics", halves)):
            steps = [real(model, x, y) for x, y in parts]
            grads = [torch.stack([g[k] for _, _, g in steps]).mean(0) for k in steps[0][2]]
            orders[name] = {"loss": float(sum(loss for loss, _, _ in steps)) / len(steps),
                            "grad_norm": float(torch.sqrt(sum((g.double() ** 2).sum()
                                                              for g in grads)))}
            del steps, grads
        del model
    finally:
        cli.loss_and_grads = real
        torch.backends.cudnn.allow_tf32 = tf32["cudnn_allow_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = tf32["matmul_allow_tf32"]
    torch.cuda.empty_cache()

    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    frames = lambda images, labels: sorted(  # noqa: E731
        (int(im.sum()), int(lb)) for im, lb in zip(images.long(), labels))
    r0 = ranks[0]
    rec = {"ranks": VISION_RANKS, "backend": "gloo", "img_size": VISION_IMG, "subset": VISION_SUBSET,
           "batch_per_rank": VISION_LOCAL_B, "global_batch": VISION_LOCAL_B * VISION_RANKS,
           "ranks_s": ranks_s, "one_process_s": one_s,
           "rank_wall_s": [r["wall_s"] for r in ranks],
           "loss": r0["loss"], "one_process_loss": one["loss"],
           "grad_norm": r0["grad_norm"], "one_process_grad_norm": one["grad_norm"],
           "loss_rel_err": rel(r0["loss"], one["loss"]),
           "grad_norm_rel_err": rel(r0["grad_norm"], one["grad_norm"]),
           "one_process_by_order": orders,
           "order_noise": {k: max(rel(a[k], b[k]) for a, b in itertools.combinations(
               (one, orders["ranks_order"], orders["reversed"]), 2))
               for k in ("loss", "grad_norm")},
           "local_statistics_err": {k: rel(orders["local_statistics"][k], one[k])
                                    for k in ("loss", "grad_norm")},
           "epoch_lines": [[x for x in r["stdout"].splitlines() if x.startswith("epoch ")]
                           for r in ranks],
           "plot": "written" if (work / "plot.png").exists() else
           ("skipped" if "skipped plot" in r0["stdout"] else None),
           "launches": [r["launches"] for r in ranks]}
    check(all(r["loss"] == r0["loss"] and r["grad_norm"] == r0["grad_norm"] for r in ranks),
          f"the ranks took different steps: {[(r['loss'], r['grad_norm']) for r in ranks]}")
    check(frames(torch.cat([r["images"] for r in ranks]), torch.cat([r["labels"] for r in ranks]))
          == frames(one["images"], one["labels"]), "the ranks' global batch is the one process's")
    rec["grad_norm_tol"] = max(VISION_RTOL, VISION_NOISE_FACTOR * rec["order_noise"]["grad_norm"])
    check(rec["loss_rel_err"] <= VISION_RTOL and rec["grad_norm_rel_err"] <= rec["grad_norm_tol"],
          f"train_vision_baseline on two ranks: {rec}")
    control = rec["local_statistics_err"]
    check(control["loss"] > VISION_RTOL or control["grad_norm"] > rec["grad_norm_tol"],
          f"the check passes a step without global BatchNorm statistics: {rec}")
    check(rec["epoch_lines"][0] == rec["epoch_lines"][1] and len(rec["epoch_lines"][0]) == 1
          and rec["plot"] is not None and "plot" not in ranks[1]["stdout"],
          f"train_vision_baseline ranks' output: {rec}")
    check(not any(v for r in ranks for v in r["launches"].values()),
          f"train_vision_baseline launched kernels: {rec['launches']}")
    return rec


def phase_tools(dev, smi: str, work: Path) -> dict:
    """The load test on the card, the host tools, ``train_vision_baseline``
    on two ranks."""
    t0 = time.perf_counter()
    rec = {"phase": "tools", "gpu": smi, "img_hw": [IMG_H, IMG_W], "batch": YOLO_B,
           "duration_s": LOAD_DURATION_S, "load_test": {}}
    root = work / "tools"
    root.mkdir()
    runs = {name: write_run_dir(root / "runs", cfg) for name, cfg in LOAD_FAMILIES.items()}
    for name, family, levels, extra in LOAD_RUNS:
        rec["load_test"][name] = load_test_child(name, runs[family], levels, extra,
                                                 root / "load" / name)
    rec["load_test_s"] = time.perf_counter() - t0
    rec["host"] = host_tools(work)
    rec["vision_ranks"] = vision_ranks(dev, root / "vision", work / "ingest" / "corpus")
    rec["launches"] = {k: sum(c["launches"][k] for c in rec["load_test"].values())
                       for k in [*kernel_counts(), "gmm_transposed"]}
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def run_summary(run: Path) -> dict:
    """A training child's run dir: its files, the last epoch's loss and
    metrics, its epoch's wall seconds."""
    progress = json.loads((run / "fit_progress.json").read_text())
    last = progress["history"][-1]
    return {"files_ok": set(os.listdir(run)) == CLI_RUN_FILES
            and {"best", "last"} <= set(os.listdir(run / "weights")),
            "loss": float(last.get("loss", float("nan"))),
            "val": {k: v for k, v in last.items() if k.startswith("val_")},
            "epoch_wall_s": progress["train_wall_s_accum"]}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--multigpu-rank":
        return multigpu_rank(Path(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--vision-rank":
        return vision_rank(Path(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    emit(build_kernels())

    emit(phase_kernel(dev))
    emit(phase_fp32(dev))
    serving, nms_entry = phase_headline(dev, smi)
    emit(serving)
    evaluation = phase_evaluate(dev, smi)
    emit(evaluation)
    launches_on_eval = {family: m["launches"] for family, m in evaluation["models"].items()}
    nms_entry["evaluate_launches"] = {f: c["nms_keep"] for f, c in launches_on_eval.items()}
    server = phase_server(dev, smi)
    emit(server)
    launches_on_server = {f: m["launches"] for f, m in server["families"].items()}
    nms_entry["server_launches"] = {f: launches_on_server[f]["nms_keep"] for f in ("yolo", "moe")}

    cases = phase_deform_kernel(dev)
    _, fp32_err = phase_rtdetr_fp32(dev)
    phase_rtdetr_serving(dev, smi, torch.float32)
    rt_bf16, main = phase_rtdetr_serving(dev, smi, torch.bfloat16)
    bwd_cases = phase_deform_bwd(dev)
    train_fp32 = phase_rtdetr_train_fp32(dev)
    train, bwd_main, fwd_train = phase_rtdetr_train(dev, smi)
    deform_entry = {
        "name": "ms_deform_fwd", "route": "cuda",
        "source": "multimodal_moe_torch/csrc/ms_deform_fwd.cu",
        "replaces": "multimodal_moe_tpu/ops/deformable_pallas.py:97 (_fwd_kernel)",
        "shape": main["shape"], "launches": main["launches"],
        "max_abs_err": max([fp32_err, main["max_abs_err"]]
                           + [c["max_abs_err"] for c in cases.values()]),
        "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "training_launches_per_step": train["launches_per_step"]["ms_deform_fwd"],
        "training_queries": RT_TRAIN_Q, "training_ms": fwd_train["kernel_ms"],
        "training_plain_ms": fwd_train["plain_ms"], "training_bound_ms": fwd_train["bound_ms"],
        "training_library_ms": fwd_train["library_ms"],
        "evaluate_launches": launches_on_eval["rtdetr"]["ms_deform_fwd"],
        "server_launches": launches_on_server["rtdetr"]["ms_deform_fwd"],
    }
    bwd_entry = {
        "name": "ms_deform_bwd", "route": "cuda",
        "source": "multimodal_moe_torch/csrc/ms_deform_bwd.cu",
        "replaces": "multimodal_moe_tpu/ops/deformable_pallas.py:114 (_bwd_kernel)",
        "shape": bwd_main["shape"], "launches": bwd_main["launches"],
        "max_abs_err": max([bwd_main["max_abs_err"]] + [c["max_abs_err"] for c in bwd_cases.values()]),
        "ms": bwd_main["kernel_ms"], "kernel_ms": bwd_main["kernel_ms"],
        "plain_ms": bwd_main["plain_ms"], "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"], "library_ms": bwd_main["library_ms"],
        "backward_ms": bwd_main["backward_ms"], "memset_ms": bwd_main["memset_ms"],
        "with_s_bound_ms": bwd_main["with_s_bound_ms"],
        "card_vs_cpu_decoder_layer_grads": train_fp32["decoder_layer_grad_rel_err"],
    }

    ffn_cases = phase_moe_ffn(dev)
    sweep = phase_moe_sweep(dev)
    _, fp32_ffn_err = phase_moe_yolo_fp32(dev)
    moe_serving, per_level = phase_moe_yolo_serving(dev, smi)
    ffn_entry = moe_kernel_entry(
        per_level, moe_serving["routes"]["fused"]["moe_ffn_fwd_launches"],
        [fp32_ffn_err] + [c["max_abs_err"] for c in ffn_cases.values()]
        + [lv["max_abs_err"] for lv in per_level])
    sweep_entry = moe_sweep_entry(sweep, moe_serving["routes"]["auto"]["moe_sweep_fwd_launches"])
    headline_of = lambda r: {k: r[k] for k in ("step_ms", "img_per_s", "peak_mem_gib")}  # noqa: E731
    int8 = phase_int8(dev, smi, {"yolo": headline_of(serving),
                                 "moe": headline_of(moe_serving["routes"]["auto"]),
                                 "rtdetr": headline_of(rt_bf16)})
    emit(int8)
    nms_entry["int8_launches"] = {"yolo": int8["yolo"]["nms_keep_launches"],
                                  "moe": int8["moe"]["nms_keep_launches"],
                                  "evaluate": int8["evaluate"]["launches"]["nms_keep"],
                                  "timed_steps": int8["yolo"]["timed_steps"]}
    deform_entry["int8_launches"] = int8["rtdetr"]["ms_deform_fwd_launches"]
    gmm_cases = phase_gmm_kernel(dev)
    phase_moe_yolo_train_fp32(dev)
    moe_train = phase_moe_yolo_train(dev, smi)
    phase_remat(dev, smi)
    phase_yolo_train(dev, smi)
    data = phase_data(dev, smi, moe_train["dispatch"]["gmm"])
    multigpu = phase_multigpu(dev, smi)
    work_dir = tempfile.TemporaryDirectory()   # what cli and ingest write, tools reads
    work = Path(work_dir.name)
    cli = phase_cli(dev, smi, set(evaluation["models"]["moe"]["metrics"]), work)
    nms_entry["cli_launches"] = {
        "train_moe_validation": [r["launches"]["nms_keep"] for r in cli["train_moe"]["runs"]],
        "train_rtdetr": cli["train_rtdetr"]["launches"]["nms_keep"],
        "eval_detector": cli["eval_detector"]["launches"]["nms_keep"],
        "eval_detector_int8": cli["eval_int8"]["launches"]["nms_keep"]}
    deform_entry["cli_launches"] = {
        "train_rtdetr": cli["train_rtdetr"]["launches"]["ms_deform_fwd"],
        "per_train_step": cli["train_rtdetr"]["train_launches_per_step"]["ms_deform_fwd"],
        "per_val_batch": cli["train_rtdetr"]["val_launches_per_batch"]["ms_deform_fwd"]}
    bwd_entry["cli_launches"] = {
        "train_rtdetr": cli["train_rtdetr"]["launches"]["ms_deform_bwd"],
        "per_train_step": cli["train_rtdetr"]["train_launches_per_step"]["ms_deform_bwd"]}
    # The mesh's RT-DETR step (each rank) and two-rank fit (rank 0 validates).
    deform_entry["multigpu_launches"] = [
        r["ms_deform_fwd"] for r in multigpu["rtdetr"]["launches_per_rank"]]
    bwd_entry["multigpu_launches"] = [
        r["ms_deform_bwd"] for r in multigpu["rtdetr"]["launches_per_rank"]]
    nms_entry["multigpu_val_launches"] = multigpu["fit"]["nms_keep_per_rank"]
    nms_entry["cli_launches"]["analyze_moe_routing"] = \
        cli["analyze_moe_routing"]["launches"]["nms_keep"]
    ingest = phase_ingest(smi, set(evaluation["models"]["moe"]["metrics"]),
                          cli["eval_detector"]["extra_keys"], work)
    nms_entry["ingest_launches"] = {
        "train_yolo_validation": ingest["train_yolo"]["launches"]["nms_keep"],
        "train_moe_validation": ingest["train_moe"]["launches"]["nms_keep"],
        "eval_detector": ingest["eval_detector"]["launches"]["nms_keep"]}
    # B2, B3, B4 and B5 do not run on the ingest path (train_moe runs ``auto``).
    ffn_entry["ingest_launches"] = ingest["launches"]["moe_ffn_fwd"]
    deform_entry["ingest_launches"] = ingest["launches"]["ms_deform_fwd"]
    bwd_entry["ingest_launches"] = ingest["launches"]["ms_deform_bwd"]
    tools = phase_tools(dev, smi, work)
    work_dir.cleanup()
    # B1 once a device call of the load test's children; no other kernel
    # runs on the tools path (YOLO-s and MoE-YOLO-s on ``auto``).
    nms_entry["tools_launches"] = tools["launches"]["nms_keep"]
    nms_entry["tools_launches_by_run"] = {
        name: {"launches": c["launches"]["nms_keep"], "window_device_calls": c["window_device_calls"]}
        for name, c in tools["load_test"].items()}
    ffn_entry["tools_launches"] = tools["launches"]["moe_ffn_fwd"]
    deform_entry["tools_launches"] = tools["launches"]["ms_deform_fwd"]
    bwd_entry["tools_launches"] = tools["launches"]["ms_deform_bwd"]
    counts = moe_train["dispatch"]["gmm"]["launches_per_step"]
    gmm_entries = gmm_kernel_entries(gmm_cases, {
        "gmm": counts["gmm_forward"], "gmm_transposed": counts["gmm"] - counts["gmm_forward"],
        "tgmm": counts["tgmm"]})
    # The data phase's fits: B1 once a validation batch, B3 18 times a step
    # (and the forward's 6 a validation batch).
    fits = {name: data["fit"][name]["launches"] for name in ("resident", "streaming")}
    nms_entry["data_launches"] = {name: c["val_nms_keep"] for name, c in fits.items()}
    for entry in gmm_entries:
        keys = {"gmm": ("gmm_forward", "val_gmm_forward"), "gmm_transposed": ("gmm_transposed",),
                "tgmm": ("tgmm", "val_tgmm")}[entry["name"]]
        entry["data_launches"] = {name: sum(c[k] for k in keys) for name, c in fits.items()}
        key = {"gmm": "gmm_forward", "gmm_transposed": "gmm_transposed", "tgmm": "tgmm"}
        entry["multigpu_launches"] = [r[key[entry["name"]]] for r in
                                      multigpu["cases"]["moe_gmm_1x2"]["launches_per_rank"]]
        entry["ingest_launches"] = {
            "gmm": ingest["launches"]["gmm"] - ingest["launches"]["gmm_transposed"],
            "gmm_transposed": ingest["launches"]["gmm_transposed"],
            "tgmm": ingest["launches"]["tgmm"]}[entry["name"]]
        entry["tools_launches"] = {
            "gmm": tools["launches"]["gmm"] - tools["launches"]["gmm_transposed"],
            "gmm_transposed": tools["launches"]["gmm_transposed"],
            "tgmm": tools["launches"]["tgmm"]}[entry["name"]]
    emit({"kernels": [nms_entry, deform_entry, bwd_entry, ffn_entry, sweep_entry, *gmm_entries]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
