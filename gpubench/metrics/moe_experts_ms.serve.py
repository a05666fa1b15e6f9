"""Device milliseconds a serving step spends in its MoE levels' experts:
the spans ``moe.experts`` of ``MoEFFN`` (the dispatch mode's expert FFNs
and the combine), summed over the profiled stretch and divided by its
steps."""

from gpubench import spans


def read(run):
    return spans.device_ms_per_step(run, "serve", "moe.experts")
