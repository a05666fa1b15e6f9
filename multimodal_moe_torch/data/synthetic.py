"""Synthetic ZOD-shaped corpus generator (learnable, annotation-consistent).

The port's own copy of ``multimodal_moe_tpu/data/synthetic.py``. It writes
a raw ZOD tree (frame dirs with ``metadata.json``,
``annotations/object_detection.json``, ``camera_front_dnat/*.jpg``) whose
pixels hold the annotated pedestrians: a road-scene background with
pedestrian figures rendered at the boxes, so the whole ingestion chain
(index → boxes → solar bins → splits → exports) runs on it.

* Heights follow ZOD's measured distribution at 704p (p50 18.94 px, 40.5 %
  under 16 px) through an inverse-CDF sampler (``height_dist="zod704"``, the
  default); figures stand on a ground plane, so far ones sit at the horizon.
  ``height_dist="easy"`` gives large figures for quick learnability checks.
* Context follows ZOD's measured frequencies (solar bins night 0.190,
  twilight 0.036, low_sun 0.163, mid_sun 0.414, high_sun 0.197).

This is host numpy by design: the tree is defined by numpy's generator
stream (one ``np.random.default_rng(seed)`` feeds layout, scene and noise in
turn), so the same seed writes JAX's tree byte for byte
(``tests/test_torch_ingest_chain.py``). PIL is imported where it is used.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

ORIG_W, ORIG_H = 3848, 2168  # ZOD camera_front_dnat dims the indexer assumes

# 704p→full-res: the indexer resizes H 2168→704, so heights scale by this.
_FULL_PER_704 = ORIG_H / 704.0

# Empirical inverse CDF of pedestrian box height at 704p, through ZOD's
# measured p10 8.58, p25 12.0957, p50 18.9388, p75 32.016, p90 54.862 px and
# frac<8 0.0771, <12 0.2459, <16 0.405, <24 0.6245; the tails below p10
# (down to a 4 px floor) and above p90 are log-linear extensions.
_ZOD704_HEIGHT_PX = np.array(
    [4.0, 8.0, 8.58, 12.0, 12.0957, 16.0, 18.9388, 24.0, 32.016, 54.862,
     85.0, 260.0, 660.0]
)
_ZOD704_CDF = np.array(
    [0.0, 0.0771, 0.10, 0.2459, 0.25, 0.405, 0.50, 0.6245, 0.75, 0.90,
     0.95, 0.99, 1.0]
)

# Measured context frequencies (solar bin → probability); day is the union
# of the three sun bins (0.773), night 0.190, twilight 0.036.
_SOLAR_BIN_SPECS = (
    # (label, probability, angle_lo, angle_hi, time_of_day)
    ("night", 0.190, -25.0, -6.0, "night"),
    ("twilight", 0.036, -5.9, 0.0, "twilight"),
    ("low_sun", 0.163, 0.1, 15.0, "day"),
    ("mid_sun", 0.414, 15.1, 45.0, "day"),
    ("high_sun", 0.197, 45.1, 62.0, "day"),
)


def sample_heights_704(rng: np.random.Generator, n: int) -> np.ndarray:
    """Draw n pedestrian box heights in 704p pixels from the empirical ZOD
    distribution (log-linear interpolation of the inverse CDF)."""
    u = rng.uniform(0.0, 1.0, n)
    return np.exp(np.interp(u, _ZOD704_CDF, np.log(_ZOD704_HEIGHT_PX)))


def _render_scene(
    rng: np.random.Generator,
    boxes_xyxy: Sequence[Sequence[float]],
    *,
    w: int,
    h: int,
    night: bool,
    horizon: float = 0.45,
) -> np.ndarray:
    """Road-scene-ish background + pedestrian figures at the given boxes.

    A figure is a head disc, a body block and two legs in a clothing colour
    that stands out from the grey scene; its masks are computed inside the
    box's window only (tiny boxes dominate the zod704 distribution)."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    sky = np.array([140, 165, 200], np.float32) * (0.25 if night else 1.0)
    road = np.array([90, 88, 92], np.float32) * (0.35 if night else 1.0)
    t = np.clip((yy - horizon) / 0.08, 0.0, 1.0)
    img = (sky * (1 - t) + road * t)[:, :, None].transpose(0, 2, 1)  # (h,1,3)->broadcast
    img = np.broadcast_to(img.transpose(0, 1, 2), (h, w, 3)).copy()

    # Background clutter: buildings/cars as rectangles, sized relative to the
    # frame so the render scale does not change the scene's look.
    s = w / 962.0
    for _ in range(int(rng.integers(6, 14))):
        cw = int(rng.integers(int(40 * s), int(400 * s)))
        ch = int(rng.integers(int(30 * s), int(260 * s)))
        x0 = int(rng.integers(0, max(1, w - cw)))
        y0 = int(rng.integers(0, max(1, h - ch)))
        col = rng.uniform(30, 160, 3).astype(np.float32) * (0.4 if night else 1.0)
        img[y0 : y0 + ch, x0 : x0 + cw] = 0.6 * img[y0 : y0 + ch, x0 : x0 + cw] + 0.4 * col

    for b in boxes_xyxy:
        x1, y1, x2, y2 = (float(v) for v in b)
        bw, bh = x2 - x1, y2 - y1
        if bw <= 1 or bh <= 2:
            continue
        # Windowed coordinate grids: [wx0, wx1) × [wy0, wy1).
        wx0 = max(0, int(np.floor(x1)) - 1)
        wx1 = min(w, int(np.ceil(x2)) + 2)
        wy0 = max(0, int(np.floor(y1)) - 1)
        wy1 = min(h, int(np.ceil(y2)) + 2)
        if wx1 <= wx0 or wy1 <= wy0:
            continue
        ys, xs = np.mgrid[wy0:wy1, wx0:wx1].astype(np.float32)
        win = img[wy0:wy1, wx0:wx1]

        cx = (x1 + x2) / 2
        base = rng.uniform(0, 1)
        body_col = np.array(
            [[210, 60, 50], [60, 90, 200], [220, 180, 40], [40, 170, 90]][int(base * 4) % 4],
            np.float32,
        ) * (0.55 if night else 1.0)
        skin = np.array([205, 170, 140], np.float32) * (0.5 if night else 1.0)
        head_r = max(bh * 0.14, 0.6)
        head_cy = y1 + head_r
        head = (xs - cx) ** 2 + (ys - head_cy) ** 2 <= head_r**2
        torso = (
            (np.abs(xs - cx) <= max(bw * 0.38, 0.5))
            & (ys >= y1 + 2 * head_r)
            & (ys <= y1 + bh * 0.62)
        )
        leg_w = max(bw * 0.16, 0.4)
        legs = (
            ((np.abs(xs - (cx - bw * 0.18)) <= leg_w) | (np.abs(xs - (cx + bw * 0.18)) <= leg_w))
            & (ys > y1 + bh * 0.62)
            & (ys <= y2)
        )
        win[head] = skin
        win[torso] = body_col
        win[legs] = body_col * 0.7
    img += rng.standard_normal(img.shape, dtype=np.float32) * 3.0
    return np.clip(img, 0, 255).astype(np.uint8)


def _sample_frame_layout(
    rng: np.random.Generator,
    *,
    w_full: int,
    h_full: int,
    max_peds: int,
    height_dist: str,
    horizon_frac: float,
) -> "list[list[float]]":
    """Boxes in full-res coordinates for one frame."""
    n_ped = int(rng.integers(0, max_peds + 1))
    boxes = []
    if height_dist == "easy":
        for _ in range(n_ped):
            bh = float(rng.uniform(120, 700))  # full-res px
            bw = bh * float(rng.uniform(0.28, 0.45))
            x1 = float(rng.uniform(0, w_full - bw))
            y1 = float(rng.uniform(h_full * 0.35, h_full - bh))
            boxes.append([x1, y1, x1 + bw, y1 + bh])
        return boxes
    if height_dist != "zod704":
        raise ValueError(f"unknown height_dist {height_dist!r}")
    heights = sample_heights_704(rng, n_ped) * _FULL_PER_704
    y_h = horizon_frac * h_full
    for bh in heights:
        bh = float(bh)
        bw = bh * float(rng.uniform(0.28, 0.45))
        # Ground plane: feet ~0.8·bh below the horizon (± jitter), so tiny
        # (far) pedestrians sit in the horizon band and near ones reach the
        # bottom of the frame.
        y2 = y_h + bh * float(rng.uniform(0.68, 1.08))
        y2 = min(y2, float(h_full))
        y1 = max(0.0, y2 - bh)
        x1 = float(rng.uniform(0, max(1.0, w_full - bw)))
        boxes.append([x1, y1, x1 + bw, min(y1 + bh, float(h_full))])
    return boxes


def make_synthetic_zod_tree(
    root: "Path | str",
    n_frames: int,
    *,
    seed: int = 0,
    img_wh: "tuple[int, int]" = (ORIG_W, ORIG_H),
    render_scale: int = 2,
    max_peds: int = 8,
    height_dist: str = "zod704",
    night_fraction: Optional[float] = None,
    progress: bool = False,
) -> Path:
    """Write an indexable raw ZOD tree with rendered, learnable pedestrians.

    ``render_scale``: scenes are rendered at ``img_wh / render_scale`` and
    the full dims recorded in the annotations (the indexer resizes to its
    target anyway); the default 2 renders 1924×1084, a strict downscale
    source for 1248×704, so the zod704 distribution's tiny pedestrians
    survive the resize.

    ``night_fraction``: overrides the night rate (None → the measured 0.190
    through the solar-bin sampler)."""
    from PIL import Image

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w_full, h_full = img_wh
    rw, rh = w_full // render_scale, h_full // render_scale

    bin_probs = np.array([s[1] for s in _SOLAR_BIN_SPECS])
    bin_probs = bin_probs / bin_probs.sum()

    for i in range(n_frames):
        fid = f"{i:06d}"
        fd = root / fid
        if (fd / "metadata.json").exists():
            continue
        (fd / "camera_front_dnat").mkdir(parents=True, exist_ok=True)
        (fd / "annotations").mkdir(exist_ok=True)

        # Context: the measured solar-bin frequencies (time of day follows).
        k = int(rng.choice(len(_SOLAR_BIN_SPECS), p=bin_probs))
        _, _, lo, hi, tod = _SOLAR_BIN_SPECS[k]
        solar = float(rng.uniform(lo, hi))
        if night_fraction is not None:
            night = bool(rng.uniform() < night_fraction)
            tod = "night" if night else "day"
            solar = float(rng.uniform(-25, -6)) if night else float(rng.uniform(5, 55))
        night = tod == "night"

        horizon_frac = 0.45 + float(rng.uniform(-0.05, 0.05))
        boxes_full = _sample_frame_layout(
            rng,
            w_full=w_full,
            h_full=h_full,
            max_peds=max_peds,
            height_dist=height_dist,
            horizon_frac=horizon_frac,
        )

        img = _render_scene(
            rng,
            [[v / render_scale for v in b] for b in boxes_full],
            w=rw,
            h=rh,
            night=night,
            horizon=horizon_frac,
        )
        Image.fromarray(img).save(
            fd / "camera_front_dnat" / f"{fid}_camera_front_dnat.jpg", quality=92
        )

        (fd / "metadata.json").write_text(
            json.dumps(
                {
                    "frame_id": fid,
                    "time": "2022-06-01T12:00:00",
                    "scraped_weather": str(rng.choice(["clear", "cloudy", "rain"])),
                    "time_of_day": tod,
                    "solar_angle_elevation": solar,
                    "country_code": "SE",
                    "road_type": str(rng.choice(["city", "highway", "rural"])),
                    "road_condition": "dry",
                }
            )
        )
        objs = []
        for k2, b in enumerate(boxes_full):
            x1, y1, x2, y2 = b
            unclear = bool(rng.uniform() < 0.12)
            objs.append(
                {
                    "properties": {
                        "class": "Pedestrian",
                        "unclear": unclear,
                        "occlusion_ratio": str(
                            rng.choice(["None", "Light", "Medium", "Heavy", "VeryHeavy"])
                        )
                        if not unclear
                        else None,
                        "annotation_uuid": f"{fid}-ped-{k2}",
                    },
                    "geometry": {
                        "coordinates": [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]
                    },
                }
            )
        (fd / "annotations" / "object_detection.json").write_text(json.dumps(objs))
        if progress and (i + 1) % 500 == 0:
            print(f"  synthetic frames: {i + 1}/{n_frames}", flush=True)
    return root
