#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line):

1. device   -- the card's name and power limit (``nvidia-smi``).
2. build    -- compiles ``multimodal_moe_torch/csrc/*.cu`` with nvcc into
               ``multimodal_moe_torch/build/``.
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

Then the ``kernels`` line, the ``nvidia-smi`` line and, last, the result line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result line; so does a machine without CUDA.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multimodal_moe_torch import _build  # noqa: E402
from multimodal_moe_torch.models.yolo import YoloDetector  # noqa: E402
from multimodal_moe_torch.ops import nms_kernel  # noqa: E402
from multimodal_moe_torch.ops.nms import (  # noqa: E402
    NEG_INF,
    _batched_nms_plain,
    _preselect,
    batched_nms,
)
from multimodal_moe_torch.serving import make_serving_step, yolo_serving_nms  # noqa: E402

IMG_H, IMG_W = 704, 1248
POOL, IOU, SCORE_THR, MAX_DET = 512, 0.7, 0.001, 300
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM bandwidth. The bound is stated against these.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
IOU_FLOPS = 14  # min/max/sub/mul/add/div/compare per pair, areas amortised


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

    t0 = time.perf_counter()
    lib = _build.build("nms_keep")
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "seconds": time.perf_counter() - t0,
          "compiled": "nms_keep" in _build.build_seconds, "nvcc_flags": list(_build.NVCC_FLAGS)})

    emit(phase_kernel(dev))
    emit(phase_fp32(dev))
    serving, kernel = phase_headline(dev, smi)
    emit(serving)
    emit({"kernels": [kernel]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
