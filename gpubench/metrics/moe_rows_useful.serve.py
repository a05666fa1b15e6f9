"""The share of the rows the MoE experts ran that were routed there: the
counts of the spans ``moe.experts``, Σ ``routed_rows`` (T·k) over Σ
``computed_rows`` (T·E for the sweep, T·k for gmm, the capacity slots
E·C for dense and sparse) over the profiled stretch, in %."""

from gpubench import spans


def read(run):
    found = [s["counts"] for s in spans.log(run, "serve") if s["name"] == "moe.experts"]
    computed = sum(c.get("computed_rows", 0) for c in found)
    if not computed:
        return None
    return 100.0 * sum(c.get("routed_rows", 0) for c in found) / computed
