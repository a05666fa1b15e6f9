"""The least time of the MoE levels' routed work (``rooflines.
moe_routed_bound``: T·k tokens through d → 2d → d plus the router, or the
tokens read and written once and the expert weights read once, at bf16's
peak and HBM's bandwidth) over ``moe_level_ms.serve``, in %. It counts the
same work whatever route (sweep, sparse, gmm) implements the level."""

from gpubench import common, rooflines


def read(run):
    lay = run.layer
    ms = lay.get("moe_level_ms")
    if lay.get("kind") != "serve" or not ms:
        return None
    c = run.cell
    nbytes = 2 if c["precision"] == "bf16" else 4
    bound_s, _ = rooflines.moe_routed_bound(
        run.config, c["batch"], c["img_h"], c["img_w"],
        peak_flops=common.PEAK_FLOPS[common.product_precision(c)],
        act_bytes=nbytes, weight_bytes=nbytes)
    return 100.0 * bound_s * 1e3 / (sum(ms) / lay["steps"])
