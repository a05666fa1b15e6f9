#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (each prints one JSON line):

1. device   -- the card's name and power limit (``nvidia-smi``).
2. build    -- compiles ``multimodal_moe_torch/csrc/{nms_keep,ms_deform_fwd,
               ms_deform_bwd,moe_ffn_fwd}.cu`` with nvcc, all at once, into
               ``multimodal_moe_torch/build/``; build seconds and ptxas
               register and spill counts.
3. nms_keep -- the NMS keep-mask kernel against its plain PyTorch version on
               the card: B=128 K=512 class-agnostic and B=16 K=1024 with 3
               classes, forced score ties, repeated boxes, boxes exactly at
               the IoU threshold and one all-invalid image. Keep masks and
               ``NmsResult`` must be equal (boxes and scores bitwise).
4. serving  -- YOLO-s (``arch="tpu"``, random weights from seed 0) at
               704x1248 through ``make_serving_step``:
               fp32 B=8 with TF32 off: full and topk tails bitwise equal, the
               kernel tail equal to the plain tail on the same forward;
               card against CPU, fp32 B=1: logits within
               |d| <= 1e-4 + 1e-3*|cpu|;
               the headline, bf16 B=128 pool 512 full tail: forward ms, NMS
               tail ms, img/s and peak memory, with the launch count of the
               kernel taken over this run alone.
5. ms_deform_fwd -- the deformable-attention kernel against its plain
               version, and the grid_sample formulation against the plain
               version, at three shapes: the RT-DETR headline (B=16, levels
               88x156/44x78/22x39, NH=8, D=32, L=3, P=4, Q=300, locations in
               [-0.3, 1.3]), the shape of tests/test_deformable_pallas.py
               (D=8 < 32), and locations exactly on pixel centres and on the
               borders 0 and 1. Tolerance: max |d| <= 1e-5 * max(1, max|values|).
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
               tests/test_moe_kernels.py, and experts 0, 1 and 3 zeroed (only
               expert 2's rows may be non-zero). Tolerances: fp32
               |d| <= 1e-4*max(1, max|ref|); bf16 one bf16 ulp of the hidden
               tile carried through |W2| plus one ulp of the output
               (``moe_kernels.ffn_tolerance``). Kernel, plain and library
               (two cuBLAS baddbmm with SiLU between) times and the bound.
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
11. ms_deform_bwd -- the deformable-attention backward kernel against its
               plain version (dv, the per-corner sums s, and d_loc / d_attn
               through the shared elementwise part) at the training shape
               (B=16, Q=684, levels 88x156/44x78/22x39, NH=8, D=32, L=3, P=4,
               locations in [-0.3, 1.3]), the shape of
               tests/test_deformable_pallas.py (D=8), pixel centres and the
               borders 0/1, and a contention case (every sample of a
               (batch, head) on one location). Tolerances: dv and s within
               2·n·u of the sum of the n absolute terms that make each
               element (u = 2^-24: two summation orders), d_loc and d_attn
               within 1e-5·max(1, max|ref|).
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
               the step's own inputs against its plain version, with times
               and bounds; then a learning check (one fixed batch, B=4, no
               augmentation, warmup of 1 step: the loss falls over 20 steps).

"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from multimodal_moe_torch import _build  # noqa: E402
from multimodal_moe_torch.losses import hungarian as hungarian_module  # noqa: E402
from multimodal_moe_torch.models import moe as moe_module  # noqa: E402
from multimodal_moe_torch.models import rtdetr as rtdetr_module  # noqa: E402
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector  # noqa: E402
from multimodal_moe_torch.models.rtdetr import (  # noqa: E402
    RTDETRDetector,
    anchors_for,
    rtdetr_loss,
)
from multimodal_moe_torch.models.yolo import YoloDetector  # noqa: E402
from multimodal_moe_torch.ops import deformable_kernel, moe_kernels, nms_kernel  # noqa: E402
from multimodal_moe_torch.ops.assignment import assignment_margin  # noqa: E402
from multimodal_moe_torch.ops.augment import augment_draws  # noqa: E402
from multimodal_moe_torch.ops.deformable import (  # noqa: E402
    _corners,
    level_shapes_to_offsets,
    ms_deform_attn_bwd_plain,
    ms_deform_attn_loc_attn_grads,
    ms_deformable_attention,
)
from multimodal_moe_torch.ops.nms import (  # noqa: E402
    NEG_INF,
    _batched_nms_plain,
    _preselect,
    batched_nms,
)
from multimodal_moe_torch.ops.nms import stable_topk  # noqa: E402
from multimodal_moe_torch.serving import (  # noqa: E402
    detr_topk_select,
    make_serving_step,
    yolo_serving_nms,
)
from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig  # noqa: E402

IMG_H, IMG_W = 704, 1248
POOL, IOU, SCORE_THR, MAX_DET = 512, 0.7, 0.001, 300
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM bandwidth. The bound is stated against these.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense tensor cores
PEAK_BYTES_PER_S = 3.35e12
IOU_FLOPS = 14  # min/max/sub/mul/add/div/compare per pair, areas amortised
KERNELS = ("nms_keep", "ms_deform_fwd", "ms_deform_bwd", "moe_ffn_fwd")
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


def max_abs(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(a, b))


def nms_bound(b: int, k: int):
    """Least time for the keep mask: every input byte read once, the mask
    written once, every pair's IoU at the fp32 peak."""
    nbytes = b * k * (16 + 4 + 4) + b * k * 4
    flops = b * k * (k - 1) // 2 * IOU_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def synthetic_candidates(b, n, num_classes, seed, dev):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (b, n, 2))
    wh = rng.uniform(5, 120, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (rng.integers(1, 40, (b, n)) / 40.0).astype(np.float32)  # many ties
    boxes[:, 1::7] = boxes[:, 0:1]                                     # repeated boxes
    # IoU([0,0,10,10],[0,0,10,7]) is exactly 0.7: suppressed at IoU >= 0.7.
    boxes[1, :4] = [[0, 0, 10, 10], [0, 0, 10, 7], [0, 0, 10, 10], [0, 0, 7, 10]]
    scores[1, :4] = [0.99, 0.98, 0.98, 0.97]
    scores[0] = 0.0                                                    # all invalid
    classes = rng.integers(0, num_classes, (b, n)).astype(np.int32)
    classes[1, :4] = 0
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(boxes), t(scores), t(classes)


def phase_kernel(dev) -> dict:
    cases = [(128, 512, 1, True), (16, 1024, 3, False)]
    report = []
    for b, k, ncls, agnostic in cases:
        boxes, scores, classes = synthetic_candidates(b, 2 * k, ncls, seed=k, dev=dev)
        kw = dict(iou_threshold=IOU, score_threshold=SCORE_THR, max_det=MAX_DET,
                  num_candidates=k, class_agnostic=agnostic)
        top_boxes, top_scores, top_classes = _preselect(
            boxes, scores, classes, score_threshold=SCORE_THR, num_candidates=k)
        args = (top_boxes.contiguous(), (top_scores > NEG_INF / 2).to(torch.int32),
                top_classes.contiguous())
        keep = nms_kernel.nms_keep_mask(*args, iou_threshold=IOU, class_agnostic=agnostic)
        keep_plain = nms_kernel._nms_keep_mask_plain(*args, iou_threshold=IOU,
                                                     class_agnostic=agnostic)
        got = batched_nms(boxes, scores, classes, **kw)
        ref = _batched_nms_plain(boxes, scores, classes, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, keep_plain), f"keep mask B={b} K={k}")
        check(results_equal(got, ref), f"NmsResult B={b} K={k}")
        check(not bool(got.valid[0].any()), "all-invalid image kept nothing")
        check(got.valid[1, :2].tolist() == [True, True] and int(keep[1, 1]) == 0,
              "IoU exactly at the threshold suppresses")
        kernel_ms = cuda_ms(
            lambda: nms_kernel.nms_keep_mask(*args, iou_threshold=IOU, class_agnostic=agnostic),
            reps=20)
        report.append({
            "B": b, "K": k, "classes": ncls, "class_agnostic": agnostic,
            "kept": int(keep.sum()), "valid_out": int(got.valid.sum()),
            "max_abs_err": max(max_abs(got, ref), float((keep - keep_plain).abs().max())),
            "kernel_ms": kernel_ms, "bound_ms": nms_bound(b, k)[0],
        })
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

    # The kernel on the main path's own candidates, against its plain version.
    zeros = torch.zeros(scores.shape, dtype=torch.int32, device=dev)
    top_boxes, top_scores, top_classes = _preselect(
        out["boxes"], scores, zeros, score_threshold=SCORE_THR, num_candidates=POOL)
    args = (top_boxes.contiguous(), (top_scores > NEG_INF / 2).to(torch.int32),
            top_classes.contiguous())
    kw = dict(iou_threshold=IOU, class_agnostic=False)
    keep = nms_kernel.nms_keep_mask(*args, **kw)
    keep_plain = nms_kernel._nms_keep_mask_plain(*args, **kw)
    with torch.inference_mode():
        plain_tail = _batched_nms_plain(out["boxes"], scores, zeros, num_candidates=POOL,
                                        class_agnostic=False, **nms_kw)
    torch.cuda.synchronize()
    check(torch.equal(keep, keep_plain), "keep mask on the headline candidates")
    check(results_equal(tail(), plain_tail), "headline kernel tail == plain tail")
    kernel_ms = cuda_ms(lambda: nms_kernel.nms_keep_mask(*args, **kw), reps=50, warmup=3)
    plain_ms = cuda_ms(lambda: nms_kernel._nms_keep_mask_plain(*args, **kw), reps=3, warmup=1)
    bound_ms, bound_by = nms_bound(b, POOL)
    err = max(float((keep - keep_plain).abs().max()), max_abs(tail(), plain_tail))

    serving = {
        "phase": "serving_headline", "model": "yolo-s arch=tpu", "dtype": "bfloat16",
        "batch": b, "img_hw": [IMG_H, IMG_W], "pool": POOL, "max_det": MAX_DET,
        "tail": "full", "step_ms": step_ms, "forward_ms": forward_ms, "nms_tail_ms": tail_ms,
        "img_per_s": b * 1000.0 / step_ms, "peak_mem_gib": peak_gib,
        "valid_out": int(res.valid.sum()), "kept_in_pool": int(keep.sum()),
        "gpu": smi, **tf32_state(),
    }
    kernel = {
        "name": "nms_keep", "route": "cuda",
        "source": "multimodal_moe_torch/csrc/nms_keep.cu",
        "replaces": "multimodal_moe_tpu/ops/nms_pallas.py:40 (_nms_keep_kernel)",
        "shape": {"B": b, "K": POOL}, "launches": launches, "max_abs_err": err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    return serving, kernel


def build_kernels() -> dict:
    """Build every kernel of the port at once (one nvcc each, in parallel)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    report = {}
    for name in KERNELS:
        log = _build.build_logs.get(name, "")
        report[name] = {
            "library": str(libs[name].relative_to(ROOT)),
            "compiled": name in _build.build_seconds,
            "nvcc_seconds": _build.build_seconds.get(name),
            "registers": [int(r) for r in re.findall(r"Used (\d+) registers", log)],
            "spill_bytes": [int(a) + int(b) for a, b in
                            re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)],
        }
    return {"phase": "build", "seconds": time.perf_counter() - t0, "kernels": report,
            "nvcc_flags": {name: list(_build.nvcc_flags(name)) for name in KERNELS}}


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


def deform_problem(levels, b, nh, d, p, q, seed, dev, mode="uniform"):
    """Seeded values and softmaxed weights; locations uniform in
    [-0.3, 1.3] (out of bounds on every side), or on pixel centres and the
    borders 0 and 1 (``mode="grid"``)."""
    rng = np.random.default_rng(seed)
    total = sum(h * w for h, w in levels)
    values = rng.normal(0.0, 1.0, (b, total, nh, d)).astype(np.float32)
    shape = (b, q, nh, len(levels), p)
    if mode == "uniform":
        loc = rng.uniform(-0.3, 1.3, shape + (2,))
    else:
        hw = np.asarray(levels, np.float64)[None, None, None, :, None, ::-1]  # (W, H)
        loc = (np.floor(rng.uniform(0, 1, shape + (2,)) * hw) + 0.5) / hw
        pick = rng.integers(0, 4, shape + (2,))
        loc = np.where(pick == 1, 0.0, np.where(pick == 2, 1.0, loc))
    logits = rng.normal(0.0, 1.0, (b, q, nh, len(levels) * p))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return t(values), t(loc), t(attn.reshape(shape))


def deform_compare(values, levels, loc, attn) -> dict:
    """Kernel and grid_sample against the plain version on the same inputs;
    the numbers are emitted before any check can raise."""
    got = deformable_kernel.ms_deform_attn_fwd(values, levels, loc, attn)
    ref = ms_deformable_attention(values, levels, loc, attn)
    lib = grid_sample_deform(values, levels, loc, attn)
    torch.cuda.synchronize()
    return {"tolerance": deform_tol(values),
            "max_abs_err": float((got - ref).abs().max()),
            "grid_sample_max_abs_err": float((lib - ref).abs().max()),
            "finite": bool(torch.isfinite(got).all())}


def check_deform(rec: dict, what: str) -> None:
    check(rec["finite"], f"{what}: finite kernel output")
    check(rec["max_abs_err"] <= rec["tolerance"], f"{what}: kernel vs plain")
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
    }
    report = {}
    for seed, (name, (levels, b, nh, d, p, q, mode)) in enumerate(cases.items()):
        values, loc, attn = deform_problem(levels, b, nh, d, p, q, seed, dev, mode)
        rec = {"levels": levels, "B": b, "NH": nh, "D": d, "P": p, "Q": q, "loc": mode,
               **deform_compare(values, levels, loc, attn)}
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


def deform_bwd_tolerances(values, levels, loc, attn, g):
    """Per-element bounds for two summation orders, 2·n·u·Σ|terms| with n
    the number of terms: for dv, the corner contributions that land on each
    value row (counted row by row); for s, the D products of each dot."""
    b, total, nh, d = values.shape
    dv_abs, _ = ms_deform_attn_bwd_plain(values, levels, loc, attn, g.abs())
    _, s_abs = ms_deform_attn_bwd_plain(values.abs(), levels, loc, attn, g.abs())
    counts = torch.zeros(b * total * nh, device=values.device)
    batch = torch.arange(b, device=values.device).view(b, 1, 1, 1, 1)
    head = torch.arange(nh, device=values.device).view(1, 1, nh, 1, 1)
    for _, _, _, inside, flat_idx in _corners(levels, loc):
        rows = ((batch * total + flat_idx) * nh + head)[inside]
        counts.index_add_(0, rows, torch.ones(rows.shape, device=values.device))
    return 2 * counts.view(b, total, nh, 1) * U32 * dv_abs, 2 * d * U32 * s_abs


def deform_bwd_compare(values, levels, loc, attn, g) -> dict:
    """B5 (and the shared elementwise part) against the plain backward on
    the same inputs; the numbers are returned before any check can raise."""
    dv, s = deformable_kernel.ms_deform_attn_bwd(values, levels, loc, attn, g)
    ref_dv, ref_s = ms_deform_attn_bwd_plain(values, levels, loc, attn, g)
    grads = ms_deform_attn_loc_attn_grads(levels, loc, attn, s)
    ref_grads = ms_deform_attn_loc_attn_grads(levels, loc, attn, ref_s)
    dv_tol, s_tol = deform_bwd_tolerances(values, levels, loc, attn, g)
    torch.cuda.synchronize()
    rec = {"finite": bool(torch.isfinite(dv).all()) and bool(torch.isfinite(s).all()),
           "tolerance": "dv, s: 2·n·u·Σ|terms| per element; d_loc, d_attn: 1e-5·max(1, max|ref|)"}
    for name, got, ref, tol in (("dv", dv, ref_dv, dv_tol), ("s", s, ref_s, s_tol)):
        d = (got - ref).abs()
        rec[f"{name}_max_abs_err"] = float(d.max())
        rec[f"{name}_err_over_tolerance"] = float(torch.where(d == 0, 0.0, d / tol).max())
        rec[f"{name}_within_tolerance"] = bool((d <= tol).all())
    for name, got, ref in zip(("d_loc", "d_attn"), grads, ref_grads):
        d = float((got - ref).abs().max())
        rec[f"{name}_max_abs_err"] = d
        rec[f"{name}_within_tolerance"] = d <= 1e-5 * max(1.0, float(ref.abs().max()))
    rec["max_abs_err"] = max(rec["dv_max_abs_err"], rec["s_max_abs_err"])
    rec["dv_rows_written"] = int((ref_dv.abs().amax(-1) > 0).sum())
    del dv, s, ref_dv, ref_s, dv_tol, s_tol
    return rec


def check_deform_bwd(rec: dict, what: str) -> None:
    check(rec["finite"], f"{what}: finite kernel outputs")
    for name in ("dv", "s", "d_loc", "d_attn"):
        check(rec[f"{name}_within_tolerance"], f"{what}: {name} kernel vs plain")


def deform_bwd_bound(values, levels, loc, attn) -> dict:
    """Least time for B5's function on these inputs: the value rows that
    in-bounds corners sample, g, loc and attn read once, s and dv written
    once (dv is the size of ``values``), over the memory rate; or each
    in-bounds corner's dot and add (4·D flops) and each point's geometry
    over the fp32 rate."""
    fwd = deform_bound(values, levels, loc, attn)   # rows, loc, attn, and g's size
    nbytes = fwd["bytes"] + 4 * (attn.numel() * 4 + values.numel())
    flops = fwd["corners_in_bounds"] * 4 * values.shape[3] + attn.numel() * DEFORM_POINT_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "dv_bytes": 4 * values.numel(), "flops": flops,
            "value_rows_read": fwd["value_rows_read"], "corners_in_bounds": fwd["corners_in_bounds"]}


def deform_bwd_times(values, levels, loc, attn, g) -> dict:
    bound = deform_bwd_bound(values, levels, loc, attn)
    bwd = deformable_kernel.ms_deform_attn_bwd
    kernel_ms = cuda_ms(lambda: bwd(values, levels, loc, attn, g), reps=10, warmup=2)
    _, s = bwd(values, levels, loc, attn, g)
    elementwise_ms = cuda_ms(lambda: ms_deform_attn_loc_attn_grads(levels, loc, attn, s), reps=10)
    plain_ms = cuda_ms(lambda: ms_deform_attn_bwd_plain(values, levels, loc, attn, g), reps=3,
                       warmup=1)
    # The library yardstick: autograd's backward through the grid_sample
    # formulation, which yields dv, d_loc and d_attn (B5 + the elementwise part).
    inputs = [t.detach().requires_grad_() for t in (values, loc, attn)]
    out = grid_sample_deform(inputs[0], levels, inputs[1], inputs[2])
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True), reps=5)
    lib_dv = torch.autograd.grad(out, inputs, g, retain_graph=True)[0]
    ref_dv, _ = ms_deform_attn_bwd_plain(values, levels, loc, attn, g)
    lib_err = float((lib_dv - ref_dv).abs().max())
    del out, inputs, lib_dv, ref_dv, s
    return {"kernel_ms": kernel_ms, "elementwise_ms": elementwise_ms,
            "backward_ms": kernel_ms + elementwise_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_dv_max_abs_err": lib_err, **bound,
            "achieved_gb_per_s": bound["bytes"] / kernel_ms / 1e6}


def phase_deform_bwd(dev) -> dict:
    cases = {
        "training_shape": (RT_LEVELS, RT_B, RT_NH, RT_D, RT_P, RT_TRAIN_Q, "uniform"),
        "test_shape": (((8, 12), (4, 6), (2, 3)), 2, 2, 8, 4, 7, "uniform"),
        "centres_and_borders": (RT_LEVELS, 2, RT_NH, RT_D, RT_P, RT_TRAIN_Q, "grid"),
        "contention": (RT_LEVELS, 2, RT_NH, RT_D, RT_P, RT_TRAIN_Q, "one_location"),
    }
    report = {}
    for seed, (name, (levels, b, nh, d, p, q, mode)) in enumerate(cases.items()):
        values, loc, attn = deform_problem(levels, b, nh, d, p, q, 20 + seed, dev,
                                           "grid" if mode == "grid" else "uniform")
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


def rtdetr_trainer(dev, b: int, template=None, **cfg_kw) -> DetectionTrainer:
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
                            steps_per_epoch=RT_STEPS_PER_EPOCH, device=dev)


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


def run_train_step(trainer, batch, draws=None, assign=None, layer_io=None) -> dict:
    """One ``train_step`` from a fresh state: the loss, its metrics and the
    gradients handed to the optimizer (on the host), with the matcher
    wrapped by ``assign(real)`` when given; each decoder layer's inputs and
    output gradient into ``layer_io`` when given."""
    state = trainer.init_state()
    grads = {}
    apply = state.apply_gradients

    def capture(g):
        grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = capture
    hooks = decoder_io(state.model, layer_io) if layer_io is not None else []
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


def phase_rtdetr_train(dev, smi: str) -> "tuple[dict, dict]":
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    trainer = rtdetr_trainer(dev, RT_B)
    state = trainer.init_state()
    batch = rt_train_batch(RT_B, seed=11, dev=dev)

    # The main path: the counts from zero over one train step.
    bwd_args = []
    deformable_kernel.ms_deform_fwd_launches = 0
    deformable_kernel.ms_deform_bwd_launches = 0
    with recording_bwd(bwd_args):
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
    del bwd_args, values, loc, attn, g, state, trainer, batch
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
    check(rec["learning_check"]["last5_mean"] < rec["learning_check"]["first5_mean"]
          and losses[-1] < losses[0], "the loss falls over 20 steps on a fixed batch")
    return rec, main


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
    return {"kernel_ms": kernel_ms,
            "plain_ms": cuda_ms(lambda: moe_kernels._ffn_plain(*args, capacity), reps=3, warmup=1),
            "library_ms": cuda_ms(lambda: library_ffn(*args, capacity), reps=10, warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_tflops": flops / kernel_ms / 1e9, "flops": flops}


def check_ffn(rec: dict, what: str) -> None:
    check(rec["finite"], f"{what}: finite kernel output")
    check(rec["within_tolerance"], f"{what}: kernel vs plain within tolerance")


def phase_moe_ffn(dev) -> dict:
    cases = {}
    for lvl, ((hh, ww), d) in enumerate(zip(MOE_LEVELS, MOE_WIDTHS)):
        c = fused_capacity(MOE_B * hh * ww)
        cases[f"level{lvl}"] = (torch.bfloat16, MOE_E, c, d, 2 * d, None)
    cases["test_shape_f32"] = (torch.float32, 4, 512, 64, 128, 0.05)
    cases["experts_0_1_3_zeroed"] = (torch.bfloat16, 4, 512, 128, 256, None)
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
    emit({"phase": "moe_ffn_fwd", "cases": report})
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
                on_card = model(images.float() / 255.0, ctx)
            torch.cuda.synchronize()
            launched = moe_kernels.moe_ffn_fwd_launches - before
            # The CPU routes each token to the card's experts, whatever its own
            # logits pick; where they would pick otherwise is counted below.
            with topk_selection(moe_module, replay=[p.cpu() for p in picked]):
                on_cpu = cpu_model(images.cpu().float() / 255.0, ctx.cpu())
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
            return model(x, ctx)

    for route in ("auto", "fused"):
        set_route(model, route)
        # The main path: the counts from zero over one serving step.
        moe_kernels.moe_ffn_fwd_launches = 0
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
        "per_level": [{k: lv[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err")} for lv in per_level],
    }


def main() -> int:
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

    cases = phase_deform_kernel(dev)
    _, fp32_err = phase_rtdetr_fp32(dev)
    phase_rtdetr_serving(dev, smi, torch.float32)
    _, main = phase_rtdetr_serving(dev, smi, torch.bfloat16)
    bwd_cases = phase_deform_bwd(dev)
    train_fp32 = phase_rtdetr_train_fp32(dev)
    train, bwd_main = phase_rtdetr_train(dev, smi)
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
        "training_queries": RT_TRAIN_Q,
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
        "backward_ms": bwd_main["backward_ms"],
        "card_vs_cpu_decoder_layer_grads": train_fp32["decoder_layer_grad_rel_err"],
    }

    ffn_cases = phase_moe_ffn(dev)
    _, fp32_ffn_err = phase_moe_yolo_fp32(dev)
    moe_serving, per_level = phase_moe_yolo_serving(dev, smi)
    ffn_entry = moe_kernel_entry(
        per_level, moe_serving["routes"]["fused"]["moe_ffn_fwd_launches"],
        [fp32_ffn_err] + [c["max_abs_err"] for c in ffn_cases.values()]
        + [lv["max_abs_err"] for lv in per_level])
    emit({"kernels": [nms_entry, deform_entry, bwd_entry, ffn_entry]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
