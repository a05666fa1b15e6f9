"""Host milliseconds an RT-DETR train step spends in its Hungarian matcher:
the span ``detr.match`` of ``losses/hungarian.py`` (the cost's
synchronising copy to the host and ``scipy``'s assignment of every matched
set and image), summed over the profiled stretch and divided by its
steps."""

from gpubench import spans


def read(run):
    found = [s["host_ms"] for s in spans.log(run, "train") if s["name"] == "detr.match"]
    if not found:
        return None
    return sum(found) / run.layer["steps"]
