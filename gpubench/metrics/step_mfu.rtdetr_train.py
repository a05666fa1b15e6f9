"""RT-DETR's train step's model FLOPs over its time, as a share of the TF32
peak (495 TFLOP/s: under torch's defaults cuDNN runs the float32
convolutions in TF32; the Linear layers' float32 matmuls run outside the
tensor cores, so the share understates them). The FLOPs are three times
the training forward's walk (``reference/rtdetr.count_flops`` with the
denoising queries of the cell's ground-truth slots) for forward and
backward; remat's recompute of the backbone is left out. The time is the
profiled stretch of whole steps."""

from gpubench import common
from gpubench.reference import rtdetr


def read(run):
    lay = run.layer
    if lay.get("kind") != "train" or run.device.type != "cuda":
        return None
    c = run.cell
    flops = 3 * rtdetr.count_flops(run.config, c["batch"], c["img_h"], c["img_w"],
                                   lay["weight_shapes"], denoising_slots=c["max_boxes"]).flops
    peak = common.PEAK_FLOPS[common.product_precision(c)]
    return 100.0 * flops * lay["steps"] / lay["stretch_s"] / peak
