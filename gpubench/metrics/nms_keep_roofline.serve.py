"""B1's keep mask against its roofline: the least time of the mask
(``rooflines.nms_bound``, the arithmetic of ``chip_smoke.py:nms_bound``)
on each profiled step's own valid candidates, over the device time of the
kernel's launches in the profiler's trace (``mask_kernel``,
``mask_tiles_kernel``, ``walk_kernel``, ``walk_global_kernel`` of
``csrc/nms_keep.cu``), in %."""

from gpubench import rooflines


def read(run):
    lay = run.layer
    if lay.get("kind") != "serve" or not lay.get("events"):
        return None
    kernel_us = sum(e - s for n, s, e in lay["events"] if rooflines.is_nms_kernel(n))
    if kernel_us <= 0:
        return None
    bound_s = sum(rooflines.nms_bound(v, run.cell["pool"])[0] for v in lay["nms_valid"])
    return 100.0 * bound_s * 1e6 / kernel_us
