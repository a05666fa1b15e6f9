"""B5 (``csrc/ms_deform_bwd.cu``) against its roofline in the train step:
the least time of every deformable backward call of the profiled stretch
(``deform_rooflines.bwd_bound``, the arithmetic of
``chip_smoke.py:deform_bwd_bound``, from each ``rtdetr.deform`` span's
counts and the call's sampling locations taken again after the window)
over the device time of the kernel's launches in the profiler's trace
(``dv``'s zero fill, a separate launch, left out), in %."""

from gpubench import deform_rooflines as dr


def read(run):
    return dr.share(run, "train", dr.bwd_bound, dr.is_bwd_kernel)
