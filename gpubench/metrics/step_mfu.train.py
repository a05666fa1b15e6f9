"""The train step's model FLOPs over its time, as a share of the TF32 peak
(495 TFLOP/s): under torch's defaults, which the train CLIs leave as they
are, cuDNN runs the float32 convolutions in TF32 (the MoE levels' float32
matmuls run outside the tensor cores, so the share understates them). The
FLOPs are three times the forward's walk (``detector.count_flops``:
convolutions, the MoE levels at k experts a token) for forward and
backward; the time is the profiled stretch of whole steps."""

from gpubench import common
from gpubench.reference import detector


def read(run):
    lay = run.layer
    if lay.get("kind") != "train" or run.device.type != "cuda":
        return None
    c = run.cell
    flops = 3 * detector.count_flops(run.config, c["batch"], c["img_h"], c["img_w"],
                                     lay["weight_shapes"]).flops
    peak = common.PEAK_FLOPS[common.product_precision(c)]
    return 100.0 * flops * lay["steps"] / lay["stretch_s"] / peak
