"""Device milliseconds a serving step spends in its tail: the span
``serve.tail`` of ``serving.make_serving_step`` (the sigmoid, the top-K
preselection, B1's keep mask and the compaction), from its entry to its
exit on the stream, summed over the profiled stretch and divided by its
steps."""

from gpubench import spans


def read(run):
    return spans.device_ms_per_step(run, "serve", "serve.tail")
