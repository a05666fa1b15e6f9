"""The share of the profiled stretch of the train window in which no
operation ran on the card: 1 − (the union of the device operations'
intervals in the profiler's trace) / (the stretch's host-clock length)."""


def read(run):
    lay = run.layer
    if lay.get("kind") != "train" or run.device.type != "cuda" or not lay.get("stretch_s"):
        return None
    return 100.0 * (1.0 - run.busy_s / lay["stretch_s"])
