"""Greedy NMS keep mask: the CUDA kernel ``csrc/nms_keep.cu``, its wrapper,
its launch count and its plain PyTorch version.

Port of ``multimodal_moe_tpu/ops/nms_pallas.py:_nms_keep_kernel``. Over K
candidates sorted by descending score, a candidate that is valid and still
alive removes every later candidate whose IoU with it is >= the threshold
(and whose class is the same, unless ``class_agnostic``). The result is a
``(B, K)`` int32 keep mask, compacted to ``max_det`` outside.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .boxes import pairwise_iou

# Launches of the CUDA kernel in this process (the plain version does not count).
nms_keep_launches = 0

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def _lib():
    from .._build import load

    lib = load("nms_keep")
    lib.nms_keep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.nms_keep_launch.restype = ctypes.c_int
    return lib


def smem_bytes(k: int) -> int:
    """Shared memory the kernel needs for a pool of ``k`` (csrc/nms_keep.cu)."""
    w = (k + 63) // 64
    return w * (k + 1) * 8 + k * 16 + k * 4


def _nms_keep_mask_plain(boxes, valid, classes, *, iou_threshold, class_agnostic):
    """The same function in plain PyTorch: the Pallas kernel's serial sweep,
    with the batch as a vector dimension and the IoU matrix precomputed."""
    b, k, _ = boxes.shape
    iou = pairwise_iou(boxes, boxes)
    if not class_agnostic:
        iou = torch.where(classes[:, :, None] == classes[:, None, :], iou, 0.0)
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou >= iou_threshold) & later
    alive = valid.bool().clone()
    for i in range(k):
        alive &= ~(suppress[:, i, :] & alive[:, i:i + 1])
    return alive.to(torch.int32)


def nms_keep_mask(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    classes: torch.Tensor,
    *,
    iou_threshold: float,
    class_agnostic: bool,
) -> torch.Tensor:
    """boxes ``(B, K, 4)`` f32 score-sorted, valid ``(B, K)`` i32, classes
    ``(B, K)`` i32 → keep ``(B, K)`` i32."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    for name, t in (("valid", valid), ("classes", classes)):
        if tuple(t.shape) != (b, k):
            raise ValueError(f"{name} must be {(b, k)}, got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on {boxes.device}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if boxes.device.type == "cpu":
        return _nms_keep_mask_plain(
            boxes, valid, classes,
            iou_threshold=iou_threshold, class_agnostic=class_agnostic,
        )
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous() and classes.is_contiguous()):
        raise ValueError("nms_keep_mask needs contiguous tensors")
    if smem_bytes(k) > SMEM_LIMIT:
        raise ValueError(
            f"pool of {k} candidates needs {smem_bytes(k)} B of shared memory; "
            f"the kernel takes at most {SMEM_LIMIT} B (K <= 1024 is the design range)"
        )
    keep = torch.empty((b, k), dtype=torch.int32, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = _lib()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_keep_launch(
            boxes.data_ptr(), valid.data_ptr(), classes.data_ptr(), keep.data_ptr(),
            b, k, float(iou_threshold), int(bool(class_agnostic)), stream,
        )
    if err != 0:
        raise RuntimeError(f"nms_keep kernel launch failed: cudaError_t {err}")
    global nms_keep_launches
    nms_keep_launches += 1
    return keep
