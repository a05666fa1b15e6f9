"""Device milliseconds an RT-DETR serving step spends in its decoder: the
span ``rtdetr.decoder`` of ``models/rtdetr.py`` (six layers of
self-attention, B4's deformable cross-attention and the FFN, the box and
class heads), from its entry to its exit on the stream, summed over the
profiled stretch and divided by its steps."""

from gpubench import spans


def read(run):
    return spans.device_ms_per_step(run, "serve", "rtdetr.decoder")
