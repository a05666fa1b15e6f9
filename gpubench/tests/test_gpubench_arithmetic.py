"""The benchmark's arithmetic, by hand on small shapes: the FLOP walk, the
roofline bounds, the percentile over all requests, the rate over the window."""

import math

import pytest
import torch

from gpubench import common, rooflines
from gpubench.drivers.http_open import latencies_ms, percentile
from gpubench.reference import detector

YOLO = common.load_json("configs", "yolo_s")
MOE = common.load_json("configs", "moe_yolo_s")


def _shapes(cfg):
    return {k: s for k, (s, _) in common.weight_shapes(cfg, torch.float32).items()}


def test_flop_walk_counts_a_convolution_by_hand():
    """The stem's conv at 64×128: 48→64 channels, 3×3, on the 16×32 map
    after space-to-depth 4: 2·48·64·9·16·32 FLOPs an image."""
    counter = detector.Counter()
    w = {"s.conv.weight": torch.empty((64, 48, 3, 3), device="meta")}
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        w[f"s.bn.{leaf}"] = torch.empty(64, device="meta")
    net = detector.Net(w, YOLO, counter=counter)
    net.conv("s", torch.empty((2, 48, 16, 32), device="meta"))
    assert counter.flops == 2 * (2 * 48 * 64 * 9 * 16 * 32)


@pytest.mark.parametrize("cfg", [YOLO, MOE], ids=["yolo_s", "moe_yolo_s"])
def test_flop_walk_scales_with_batch_and_pixels(cfg):
    one = detector.count_flops(cfg, 1, 64, 128, _shapes(cfg)).flops
    assert detector.count_flops(cfg, 3, 64, 128, _shapes(cfg)).flops == pytest.approx(3 * one)
    assert detector.count_flops(cfg, 1, 128, 256, _shapes(cfg)).flops == pytest.approx(4 * one)


def test_moe_levels_count_k_experts_a_token():
    """MoE-YOLO-s adds, at each level of T tokens and width d, T·k·(2·d·2d +
    2·2d·d) for the experts and 2·T·d·E for the router; nothing for E − k."""
    b, h, w = 2, 64, 128
    extra = (detector.count_flops(MOE, b, h, w, _shapes(MOE)).flops
             - detector.count_flops(YOLO, b, h, w, _shapes(YOLO)).flops)
    want = 0.0
    for s, d in zip((8, 16, 32), (128, 256, 512)):
        t = b * (h // s) * (w // s)
        want += t * 2 * (2 * d * 2 * d + 2 * 2 * d * d) + 2 * t * d * 4
    assert extra == pytest.approx(want)


def test_yolo_s_flops_at_the_protocol_size():
    """YOLO-s at 704×1248 (the repository's arch=tpu trunk) is ~89 GFLOP an
    image, ten-odd percent more than the CSP trunk's YOLOv8-s scaled up from
    640² (28.6 × 704·1248 / 640²)."""
    g = detector.count_flops(YOLO, 1, 704, 1248, _shapes(YOLO)).flops / 1e9
    assert 61 < g < 100


def test_moe_routed_bound_by_hand():
    """One level at a time, checked against the formula written out."""
    cfg = dict(MOE)
    s, peak = rooflines.moe_routed_bound(cfg, 1, 32, 32, peak_flops=1e12, act_bytes=2,
                                          weight_bytes=2)
    flops = nbytes = 0.0
    for stride, d in zip((8, 16, 32), (128, 256, 512)):
        t = (32 // stride) ** 2
        flops += t * 2 * 2 * (2 * d * 2 * d) + 2 * t * d * 4
        nbytes += 2 * t * d * 2 + 4 * (2 * d * 2 * d + 2 * d + d) * 2 + (d * 4 + 6 * 4) * 4
    want = max(flops / 1e12, nbytes / common.PEAK_BYTES_PER_S)
    assert s == pytest.approx(want)
    assert peak == ("operations" if flops / 1e12 > nbytes / common.PEAK_BYTES_PER_S else "bytes")


def test_nms_bound_by_hand():
    """Two images of 512 candidates, 500 and 3 valid: 124,750 + 3 pairs at
    14 fp32 operations each, at half the 67 TFLOP/s multiply-add rate,
    against 2·512·28 bytes at 3.35 TB/s."""
    s, by = rooflines.nms_bound(torch.tensor([500, 3]), 512)
    ops = (500 * 499 / 2 + 3) * 14 / 33.5e12
    nbytes = 2 * 512 * 28 / 3.35e12
    assert s == pytest.approx(max(ops, nbytes))
    assert by == "operations"
    assert rooflines.nms_bound(torch.tensor([0, 1]), 512)[1] == "bytes"


def test_nms_kernel_names():
    assert rooflines.is_nms_kernel("void mask_kernel<false, true>(float4 const*, int)")
    assert rooflines.is_nms_kernel("_Z18walk_global_kernelPKiPKjPii")
    assert not rooflines.is_nms_kernel("void at::native::masked_fill_kernel()")


def test_percentile_over_all_requests_with_failures_as_misses():
    """A failed or unanswered request takes the client's longest wait."""
    reqs = [{"latency": 0.001 * (i + 1)} for i in range(95)] + [{"latency": None}] * 5
    lat = latencies_ms(reqs, grace_s=60.0)
    assert len(lat) == 100
    assert percentile(lat, 95) == pytest.approx(95.0)
    assert percentile(lat + [60000.0], 95) == 60000.0
    assert percentile([3.0], 95) == 3.0
    assert percentile(list(range(1, 21)), 50) == 10


def test_rate_is_all_the_work_over_all_the_window():
    """serve_img_s is every image read back in the window over the window's
    seconds (the last step runs to its end)."""
    from gpubench import run as bench_run

    run, line = bench_run.execute(
        ["--workload", "yolo_s.offline_b128", "--seed", "3", "--seconds", "0.5", "--trace", "0"],
        device=torch.device("cpu"), cell_overrides=_SMALL)
    rate = line["metrics"]["serve_img_s"]["value"]
    assert run.window_elapsed >= 0.5
    assert rate == pytest.approx(line["attempted"] / run.window_elapsed)
    assert line["attempted"] % _SMALL["batch"] == 0
    assert math.isfinite(line["metrics"]["setup_s"]["value"])


_SMALL = dict(batch=2, pool_batches=2, img_h=64, img_w=128, check_images=2, profile_steps=2,
              pool=64, max_det=20)
