"""Device milliseconds a serving step spends routing in its MoE levels:
the spans ``moe.route`` of ``MoEFFN`` (the context gate and the top-k
route with its aux loss), summed over the profiled stretch and divided by
its steps."""

from gpubench import spans


def read(run):
    return spans.device_ms_per_step(run, "serve", "moe.route")
