"""The NMS kernel's per-pair decision rule and its blocked layout, on the CPU.

``nms_kernel.pair_suppresses`` is the rule ``csrc/nms_keep.cu`` applies to
each pair, the exact zero-overlap shortcut and the margin filter included:
it must give, bit for bit, ``pairwise_iou(a, b) >= t`` (with a different
class as IoU 0) for every float input, NaN and ±inf coordinates among them,
and for thresholds at and below 0. ``_simulate_kernel`` replays the
kernel's units, its packed upper-triangle mask (``_group_offset``) and its
walk blocked by 32-candidate groups, and must give the plain keep mask; on
the card the library's own layout is held to that model.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import NMS_KINDS, nms_boxes, require_cuda
from multimodal_moe_torch.ops import nms_kernel
from multimodal_moe_torch.ops.boxes import pairwise_iou

SOURCE = Path(nms_kernel.__file__).resolve().parent.parent / "csrc" / "nms_keep.cu"
NAN = float("nan")
SMEM_MAX_K = 1024  # the largest pool whose mask the walk keeps in shared memory
HEADLINE_K = 18018  # YOLO-s's full anchor set at 704x1248: the largest pool JAX takes there


def _group_offset(g: int) -> int:
    """Offset in 32-bit words of column group ``g`` in the kernel's mask: the
    upper triangle, rows 0..32g+31 of each group, plus 4g words of padding."""
    return 16 * g * (g + 1) + 4 * g


@pytest.mark.parametrize("t", [0.0, 0.7, 1.0, 3.0])
@pytest.mark.parametrize("kind", NMS_KINDS)
def test_pair_rule_matches_pairwise_iou(kind, t):
    boxes = torch.from_numpy(nms_boxes(kind, 96, seed=NMS_KINDS.index(kind)))
    ref = pairwise_iou(boxes, boxes) >= t
    got = nms_kernel.pair_suppresses(boxes[:, None, :], boxes[None, :, :], t)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("t", [-0.5, 0.0, 0.7, NAN])
def test_pair_rule_class_aware(t):
    boxes = torch.from_numpy(nms_boxes("non_finite", 64, seed=3))
    classes = torch.from_numpy(np.random.default_rng(4).integers(0, 3, 64))
    same = classes[:, None] == classes[None, :]
    ref = torch.where(same, pairwise_iou(boxes, boxes), 0.0) >= t
    got = nms_kernel.pair_suppresses(boxes[:, None, :], boxes[None, :, :], t, same)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("t", [0.7, 0.5, 0.3, 1.0, 3.0, 1e-3, 1e-30, 2.0**-90, 2.0**90])
def test_margin_filter_at_the_threshold(t):
    """Pairs whose IoU is within a factor 1 +- 2**-17 of t, so on both sides
    of the filter's margin (2**-20), at scales from 2**-20 to 2**60 (where
    c * den nears overflow), and boxes whose IoU is near 1 for t >= 1."""
    rng = np.random.default_rng(int(abs(np.log2(t))) + 7)
    n = 4000
    s = (2.0 ** rng.uniform(-20, 60, n)).astype(np.float32)
    ratio = np.float32(min(t, 1.0)) * (1 + rng.uniform(-2.0**-17, 2.0**-17, n))
    a = np.stack([np.zeros(n), np.zeros(n), s, s], -1).astype(np.float32)
    b = np.stack([np.zeros(n), np.zeros(n), s, s * ratio], -1).astype(np.float32)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    iou = pairwise_iou(a[:, None], b[:, None])[:, 0, 0]
    got = nms_kernel.pair_suppresses(a, b, t)
    assert torch.equal(got, iou >= t)
    assert bool(got.any()) or t > 1.0
    assert bool((~got).any())


def test_nan_dropping_min_max_would_differ():
    """Why the kernel takes PTX max.NaN / min.NaN: with C's fmaxf / fminf,
    which drop a NaN operand (torch.fmax / torch.fmin here), as the kernel
    before did, some pairs of non-finite boxes get another bit than
    pairwise_iou's NaN-propagating maximum, minimum and clamp give."""
    boxes = torch.from_numpy(nms_boxes("non_finite", 96, seed=NMS_KINDS.index("non_finite")))
    a, b = boxes[:, None, :], boxes[None, :, :]
    zero = torch.tensor(0.0)

    def area(x):
        return torch.fmax(x[..., 2] - x[..., 0], zero) * torch.fmax(x[..., 3] - x[..., 1], zero)

    w = torch.fmax(torch.fmin(a[..., 2], b[..., 2]) - torch.fmax(a[..., 0], b[..., 0]), zero)
    h = torch.fmax(torch.fmin(a[..., 3], b[..., 3]) - torch.fmax(a[..., 1], b[..., 1]), zero)
    inter = w * h
    dropping = inter / (((area(a) + area(b)) - inter) + 1e-7) >= 0.7
    ref = pairwise_iou(boxes, boxes) >= 0.7
    assert bool((dropping != ref).any())
    assert torch.equal(nms_kernel.pair_suppresses(a, b, 0.7), ref)


def test_shortcut_pairs_are_exercised():
    """The cases above hold the shortcut to the division: zero-overlap pairs
    with finite, infinite and NaN area sums all occur."""
    boxes = torch.from_numpy(nms_boxes("non_finite", 96, seed=NMS_KINDS.index("non_finite")))
    a, b = boxes[:, None, :], boxes[None, :, :]
    lt = torch.maximum(a[..., 0:2], b[..., 0:2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = (rb - lt).clamp_min(0.0)
    zero = (wh[..., 0] * wh[..., 1]) == 0
    area = nms_kernel.box_area(boxes)
    s = area[:, None] + area[None, :]
    assert bool((zero & torch.isnan(s)).any())
    assert bool((zero & torch.isinf(s)).any())
    assert bool((zero & torch.isfinite(s)).any())


# --------------------------------------------------------------------------
# the kernel's units, mask layout and blocked walk, replayed
# --------------------------------------------------------------------------

def _unit_of(u: int):
    """csrc/nms_keep.cu unit_of: unit u -> (column group g, 64-row block r2)."""
    s = int(np.sqrt(np.float32(u)))
    while s * s > u:
        s -= 1
    while (s + 1) * (s + 1) <= u:
        s += 1
    g = 2 * s if u >= s * s + s else 2 * s - 1
    h = g // 2
    return g, u - ((h + 1) * (h + 1) if g % 2 else h * (h + 1))


def _n_units(groups: int) -> int:
    h = groups // 2
    return (h + 1) * (h + 1) if groups % 2 else h * (h + 1)


def _simulate_kernel(boxes, valid, classes, t, agnostic, ctas):
    """One image through csrc/nms_keep.cu's steps: ``ctas`` CTAs take equal
    shares of the 64-row x 32-column units and write each row's 32-bit word
    into the packed mask; the walk resolves group g on lane g's diagonal
    rows, then ORs group g's kept rows into every later group. Words never
    written stay garbage, as in shared memory. Above K = 1024 the kernel
    computes the same units and words from per-warp column tiles, and its
    walk makes the same steps with group g's word owned by thread g % 256
    of the CTA instead of lane g, so this replay holds for both."""
    k = boxes.shape[0]
    groups = (k + 31) // 32
    mask = [0xDEADBEEF] * _group_offset(groups)
    pad = 32 * (groups + 1) - k
    boxes = torch.cat([boxes, torch.zeros(pad, 4)])
    classes = torch.cat([classes, torch.zeros(pad, dtype=classes.dtype)])
    units = _n_units(groups)
    lanes = torch.arange(32)
    for rank in range(ctas):
        for u in range(units * rank // ctas, units * (rank + 1) // ctas):
            g, r2 = _unit_of(u)
            rows, cols = 64 * r2 + torch.arange(64), 32 * g + lanes
            same = None if agnostic else classes[rows][:, None] == classes[cols][None, :]
            bits = nms_kernel.pair_suppresses(boxes[rows][:, None], boxes[cols][None, :], t, same)
            bits &= (rows[:, None] < cols[None, :]) & (cols[None, :] < k)
            words = (bits.long() << lanes).sum(1)
            for q in range(64):
                if rows[q] < min(k, 32 * (g + 1)):
                    mask[_group_offset(g) + int(rows[q])] = int(words[q])
    full = 0xFFFFFFFF
    vbits = [sum(1 << q for q in range(32) if 32 * g + q < k and valid[32 * g + q])
             for g in range(groups)]
    # rem[g]: group g's removed word (lane g's up to K = 1024, thread g % 256's above)
    rem = [~vbits[g] & full for g in range(groups)]
    diag = [[mask[_group_offset(g) + 32 * g + q] for q in range(32)] for g in range(groups)]
    for g in range(groups):
        for q in range(32):
            if not (rem[g] >> q) & 1:
                rem[g] |= diag[g][q]
        kept = ~rem[g] & full
        for h in range(g + 1, groups):
            for q in range(32):
                if (kept >> q) & 1:
                    rem[h] |= mask[_group_offset(h) + 32 * g + q]
    return torch.tensor([0 if (rem[j >> 5] >> (j & 31)) & 1 else 1 for j in range(k)],
                        dtype=torch.int32)


@pytest.mark.parametrize("k,ctas,kind,agnostic,t", [
    (300, 2, "random", True, 0.7),
    (1000, 8, "random", False, 0.5),
    (64, 1, "identical", True, 0.7),
    (96, 4, "disjoint", True, 0.7),
    (200, 8, "at_threshold", True, 0.7),
    (160, 2, "non_finite", False, 0.3),
    (97, 4, "random", True, 0.0),
    (128, 2, "identical", False, 1.0),
    (1100, 32, "random", False, 0.7),
])
def test_blocked_walk_matches_plain(k, ctas, kind, agnostic, t):
    rng = np.random.default_rng(k)
    boxes = torch.from_numpy(nms_boxes(kind, k, seed=k))
    valid = torch.from_numpy((rng.random(k) < 0.9).astype(np.int32))
    classes = torch.from_numpy(rng.integers(0, 3, k).astype(np.int32))
    ref = nms_kernel._nms_keep_mask_plain(boxes[None], valid[None], classes[None],
                                          iou_threshold=t, class_agnostic=agnostic)[0]
    got = _simulate_kernel(boxes, valid, classes, t, agnostic, ctas)
    assert torch.equal(got, ref)


def test_mask_layout_is_free_of_bank_conflicts():
    """The walk reads, in each lane, four words of its own group at once
    (16-byte loads, served eight lanes at a time): lanes 0-7, 8-15, ... must
    cover 32 different banks, for the diagonal rows and for every row block
    g of the later groups. The phase-1 stores of a unit are 32 consecutive
    words. Every group's rows start 16-byte aligned and fit before the next
    group's."""
    off = _group_offset
    for g in range(32):
        for p in range(8):
            for first in range(0, 32, 8):
                lanes = [lane for lane in range(first, first + 8) if lane > g]
                banks = [(off(lane) + 32 * g + 4 * p + w) % 32 for lane in lanes for w in range(4)]
                assert len(set(banks)) == len(banks)
    for p in range(8):
        for first in range(0, 32, 8):
            banks = [(off(lane) + 32 * lane + 4 * p + w) % 32
                     for lane in range(first, first + 8) for w in range(4)]
            assert len(set(banks)) == 32
    for g in range(33):
        assert off(g) % 4 == 0
        if g < 32:
            assert off(g) + 32 * (g + 1) <= off(g + 1)


def test_layout_constants_match_the_source():
    """The source's constants that this file's models copy: the mask layout
    the replay uses, 64-bit, and the margin factors ``pair_suppresses`` uses.
    (On the card, ``test_library_layout_matches_the_model`` asks the
    library.) At K = 18,018 an image's mask is 5.1 M words, so B = 128
    passes 2**31 bytes: the scratch count and every offset into it must be
    64-bit."""
    src = SOURCE.read_text()
    assert re.search(r"long long group_offset\(long long g\) \{\s*"
                     r"return 16LL \* g \* \(g \+ 1\) \+ 4LL \* g;\s*\}", src)
    assert 'extern "C" long long nms_scratch_words(int K)' in src
    assert re.search(r"constexpr int kSmemMaxK = (\d+);", src).group(1) == str(SMEM_MAX_K)
    words = _group_offset((HEADLINE_K + 31) // 32)
    assert words == 5_100_816 and 128 * words * 4 > 2**31
    assert "return (size_t)(G + 1) * 32 * (16 + 8);" in src
    assert "return (size_t)group_offset(G) * 4 + 64 * 4;" in src
    assert "t * (1.0f - 0x1p-20f)" in src and "t * (1.0f + 0x1p-20f)" in src
    assert "t >= 0x1p-90f && t <= 0x1p90f" in src
    # Launch 1 stays under the 48 KB a CTA gets without opting in; launch 2
    # opts in, within the 227 KB of one Hopper CTA.
    assert 33 * 32 * 24 <= 48 * 1024
    assert _group_offset(32) * 4 + 64 * 4 <= 232448
    # Above the shared-memory range a warp keeps one 768-byte column tile and
    # the walk 4 bytes a group (+2 words): within 48 KB up to K = 393,000.
    assert "__shared__ float4 tile_box[kWarps][32];" in src
    assert "((size_t)(K + 31) / 32 + 2) * 4" in src
    assert 8 * 32 * 24 <= 48 * 1024 and ((HEADLINE_K + 31) // 32 + 2) * 4 <= 48 * 1024


@pytest.mark.cuda
def test_library_layout_matches_the_model():
    """The library's scratch size is the model's mask size at every pool up
    to YOLO-s's full anchor set, which pins ``_group_offset`` at every group
    boundary, and it is a 64-bit count: past 2**31 words it is not cut."""
    require_cuda()
    lib = nms_kernel._lib()
    for k in range(1, HEADLINE_K + 1):
        assert lib.nms_scratch_words(k) == _group_offset((k + 31) // 32)
    assert lib.nms_scratch_words(400_000) == _group_offset(12_500) > 2**31


@pytest.mark.parametrize("b,expected", [(1, 32), (16, 32), (32, 16), (64, 8), (128, 4), (132, 2),
                                        (264, 1)])
def test_ctas_fill_the_card_twice(b, expected):
    c = nms_kernel.ctas_per_image(b, sm_count=132)
    assert c == expected
    assert c & (c - 1) == 0 and 1 <= c <= nms_kernel.MAX_CTAS
    assert b * c >= 264 or c == nms_kernel.MAX_CTAS


def test_units_cover_the_upper_triangle_once():
    """Every (row, group) word of the packed mask is written by exactly one
    unit, and no unit writes outside it."""
    for groups in (1, 2, 5, 16, 31, 32):
        written = []
        for u in range(_n_units(groups)):
            g, r2 = _unit_of(u)
            assert 0 <= g < groups and 64 * r2 <= 32 * g
            written += [(g, i) for i in range(64 * r2, 64 * r2 + 64) if i < 32 * (g + 1)]
        assert sorted(written) == [(g, i) for g in range(groups) for i in range(32 * (g + 1))]
        assert math.isclose(_n_units(groups), sum(g // 2 + 1 for g in range(groups)))


def test_cpu_wrapper_takes_pools_beyond_the_kernel_range():
    """Past the shared-memory walk's range the card takes the kernel's
    other two launches (``tests/test_torch_nms.py``'s card cases); a CPU
    tensor takes the plain version at any pool."""
    boxes = torch.zeros(1, SMEM_MAX_K + 1, 4)
    ints = torch.zeros(1, SMEM_MAX_K + 1, dtype=torch.int32)
    assert nms_kernel.nms_keep_mask(boxes, ints, ints, iou_threshold=0.7,
                                    class_agnostic=True).shape == (1, SMEM_MAX_K + 1)
    assert not hasattr(nms_kernel, "nms_max_k")
