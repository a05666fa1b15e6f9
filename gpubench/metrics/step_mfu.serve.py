"""The serving step's model FLOPs over its time, as a share of the card's
peak in the cell's precision (bf16: 989 TFLOP/s). The FLOPs are the
reference's walk of the configuration's shapes (``detector.count_flops``):
every convolution, and the MoE levels at the k experts a token that the
model asks for, not the sweep's every expert. The time is the profiled
stretch of whole steps, read-backs included."""

from gpubench import common
from gpubench.reference import detector


def read(run):
    lay = run.layer
    if lay.get("kind") != "serve" or run.device.type != "cuda":
        return None
    c = run.cell
    flops = detector.count_flops(run.config, c["batch"], c["img_h"], c["img_w"],
                                 lay["weight_shapes"]).flops
    peak = common.PEAK_FLOPS[common.product_precision(c)]
    return 100.0 * flops * lay["steps"] / lay["stretch_s"] / peak
