"""B4 (``csrc/ms_deform_fwd.cu``) against its roofline in the serving
step: the least time of every deformable forward call of the profiled
stretch (``deform_rooflines.fwd_bound``, the arithmetic of
``chip_smoke.py:deform_bound``, from each ``rtdetr.deform`` span's counts
and the call's sampling locations taken again after the window) over the
device time of the kernel's launches in the profiler's trace, in %."""

from gpubench import deform_rooflines as dr


def read(run):
    return dr.share(run, "serve", dr.fwd_bound, dr.is_fwd_kernel)
