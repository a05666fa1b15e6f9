"""Device milliseconds a serving step spends in the three ``MoEFFN``
calls: CUDA events recorded by a forward pre-hook and a forward hook on
each ``moe_level{i}`` module over the profiled stretch, summed a step."""


def read(run):
    lay = run.layer
    ms = lay.get("moe_level_ms")
    if lay.get("kind") != "serve" or not ms:
        return None
    return sum(ms) / lay["steps"]
