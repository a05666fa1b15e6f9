"""The ingestion modules of the port against the JAX package's on the CPU:
``data/bboxes.py`` (every scalar and batch function, numpy and torch
inputs, bitwise), ``data/splits.py`` (the port's numpy stratified split
against JAX's sklearn ``train_test_split``: the same rows in the same order
with the same index labels, and a ``ValueError`` in the same cases),
``data/exports.py`` (YOLO labels, symlinks, ``dataset.yaml``, summaries,
COCO JSON, both unclear policies), ``data/qa.py`` (every result, frames by
``assert_frame_equal``). The frames are the JAX tests' synthetic index (``tests/conftest.py``)."""

import json
from dataclasses import asdict

import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multimodal_moe_torch.data import bboxes, exports, qa, splits
from multimodal_moe_tpu.data import bboxes as jbboxes
from multimodal_moe_tpu.data import exports as jexports
from multimodal_moe_tpu.data import qa as jqa
from multimodal_moe_tpu.data import splits as jsplits
from multimodal_moe_tpu.data.index import load_split_frames


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


# ---------------------------------------------------------------------------
# bboxes
# ---------------------------------------------------------------------------

def _points(rng, n, dtype):
    pts = rng.uniform(-50, 1400, (n, 4, 2)).astype(dtype)
    pts[1, :, 0] = pts[1, 0, 0]                   # zero width
    pts[2, :, 1] = pts[2, 0, 1]                   # zero height
    pts[3, 1:3] = np.asarray([[-0.0, 0.0], [0.0, -0.0]], dtype)   # signed zeros
    pts[4, 0, 0] = np.nan
    pts[5, 2, 1] = np.inf
    pts[6, 1, 0] = -np.inf
    return pts


def test_scalar_box_functions_match():
    rng = np.random.default_rng(0)
    for pts in _points(rng, 40, np.float64):
        pts = pts.tolist()   # repr: NaN equals NaN, -0.0 differs from 0.0
        assert repr(bboxes.points_to_xyxy(pts)) == repr(jbboxes.points_to_xyxy(pts))
    for box in rng.uniform(-100, 1500, (60, 4)).tolist() + [[0, 0, 1, 1], [5, 5, 7, 7.5]]:
        for w, h in ((1248, 704), (640, 360)):
            assert bboxes.xyxy_to_yolo(box, w, h) == jbboxes.xyxy_to_yolo(box, w, h)
            assert bboxes.clamp_xyxy(box, w, h) == jbboxes.clamp_xyxy(box, w, h)
        assert bboxes.xyxy_to_yolo(box) == jbboxes.xyxy_to_yolo(box)
        assert bboxes.clamp_xyxy(box) == jbboxes.clamp_xyxy(box)
        assert bboxes.xyxy_to_xywh(box) == jbboxes.xyxy_to_xywh(box)
        for m in (2.0, 0.5):
            assert bboxes.is_valid_box(box, m) == jbboxes.is_valid_box(box, m)
    with pytest.raises(ValueError):
        bboxes.points_to_xyxy([[1, 2, 3]])
    with pytest.raises(ValueError):
        jbboxes.points_to_xyxy([[1, 2, 3]])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_batch_box_functions_are_bitwise(dtype, kind):
    rng = np.random.default_rng(1)
    pts = _points(rng, 24, dtype).reshape(2, 12, 4, 2)
    boxes = rng.uniform(-100, 1500, (2, 12, 4)).astype(dtype)
    boxes[0, :4] = np.asarray([[np.nan, 1, 2, 3], [-0.0, -0.0, 1247.0, 703.0],
                               [np.inf, -np.inf, 5, 5], [10, 10, 11.5, 12.5]], dtype)
    conv = (lambda a: torch.from_numpy(a.copy())) if kind == "torch" else (lambda a: a.copy())
    want_type = torch.Tensor if kind == "torch" else np.ndarray

    got_boxes, got_valid = bboxes.points_to_xyxy_batch(conv(pts))
    ref_boxes, ref_valid = jbboxes.points_to_xyxy_batch(pts, xp=np)
    cases = [(got_boxes, ref_boxes), (got_valid, ref_valid),
             (bboxes.xyxy_to_xywh_batch(conv(boxes)), jbboxes.xyxy_to_xywh_batch(boxes, xp=np)),
             (bboxes.xyxy_to_yolo_batch(conv(boxes)), jbboxes.xyxy_to_yolo_batch(boxes, xp=np)),
             (bboxes.xyxy_to_yolo_batch(conv(boxes), 640, 360),
              jbboxes.xyxy_to_yolo_batch(boxes, 640, 360, xp=np)),
             (bboxes.clamp_xyxy_batch(conv(boxes)), jbboxes.clamp_xyxy_batch(boxes, xp=np)),
             (bboxes.clamp_xyxy_batch(conv(boxes), 640, 360),
              jbboxes.clamp_xyxy_batch(boxes, 640, 360, xp=np)),
             (bboxes.is_valid_box_batch(conv(boxes)), jbboxes.is_valid_box_batch(boxes, xp=np)),
             (bboxes.is_valid_box_batch(conv(boxes), 20.0),
              jbboxes.is_valid_box_batch(boxes, 20.0, xp=np))]
    for i, (got, ref) in enumerate(cases):
        assert isinstance(got, want_type), i
        got_np = got.numpy() if kind == "torch" else got
        assert got_np.dtype == ref.dtype and got_np.shape == ref.shape, i
        assert np.array_equal(bits(got_np), bits(ref)), i


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

COMBOS = [(b, t) for b in range(4) for t in ("day", "night", "twilight")]


def _frames(counts, seed, nan_tod=0):
    """Frames of the classes ``counts[i]`` members of ``COMBOS[i]``, shuffled,
    with a non-default index (labels must follow the rows)."""
    picks = [COMBOS[i] for i, c in enumerate(counts) for _ in range(c)]
    np.random.default_rng(seed).shuffle(picks)
    df = pd.DataFrame({"frame_id": [f"{i:06d}" for i in range(len(picks))],
                       "ped_bin_4": [p[0] for p in picks],
                       "time_of_day": [p[1] for p in picks]},
                      index=np.arange(len(picks)) * 3 + 7)
    if nan_tod:
        df.loc[df.index[:nan_tod], "time_of_day"] = None
    return df


def _split_outcome(module, df, seed):
    try:
        return module.create_stratified_splits(df, seed=seed)
    except ValueError as e:
        return e


def _assert_same_split(df, seed):
    got, ref = _split_outcome(splits, df, seed), _split_outcome(jsplits, df, seed)
    if isinstance(ref, ValueError):
        assert isinstance(got, ValueError), (str(ref), got)
        return False
    assert not isinstance(got, ValueError), got
    assert list(got) == list(ref)
    for name in ref:
        pd.testing.assert_frame_equal(got[name], ref[name])
    return True


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("case", ["uneven", "class_of_two", "nan_time_of_day", "every_class"])
def test_split_matches_sklearn(case, seed):
    # Vectors that sklearn splits at every seed 0-4 (the second split needs
    # every class it meets at least twice, so most vectors raise).
    counts = {"uneven": [50, 26, 43, 47, 0, 42, 0, 0, 0, 58, 10, 66],
              "class_of_two": [50, 26, 43, 47, 0, 42, 0, 0, 0, 58, 2, 66],
              "nan_time_of_day": [0, 0, 0, 0, 0, 0, 44, 35, 44, 0, 0, 0],
              "every_class": [34] * 12}[case]
    df = _frames(counts, seed, nan_tod=14 if case == "nan_time_of_day" else 0)
    assert _assert_same_split(df, seed)


@pytest.mark.parametrize("counts", [
    [20, 20, 1],          # a class of one member
    [3, 3, 3, 3, 3, 3],   # 18 frames: 4 test rows for 6 classes
    [6, 2, 2],            # the second split's classes run short
    [1],                  # one frame: the train split would be empty
])
def test_split_raises_where_sklearn_raises(counts):
    df = _frames(counts, 0)
    with pytest.raises(ValueError):
        jsplits.create_stratified_splits(df, seed=0)
    with pytest.raises(ValueError):
        splits.create_stratified_splits(df, seed=0)


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(counts=st.lists(st.integers(0, 40), min_size=1, max_size=12), seed=st.integers(0, 4))
def test_split_matches_sklearn_on_class_counts(counts, seed):
    if sum(counts) < 2:
        counts = counts + [2]
    _assert_same_split(_frames(counts, seed), seed)


def test_split_csvs_are_byte_equal(tmp_path):
    df = _frames([50, 26, 43, 47, 0, 42, 0, 0, 0, 58, 10, 66], 3)
    got = splits.write_split_csvs(splits.create_stratified_splits(df, seed=3), tmp_path / "port")
    ref = jsplits.write_split_csvs(jsplits.create_stratified_splits(df, seed=3), tmp_path / "jax")
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].read_bytes() == ref[name].read_bytes()


# ---------------------------------------------------------------------------
# exports and qa (the JAX tests' synthetic index)
# ---------------------------------------------------------------------------

def _tree(root):
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", str(p.readlink()))
        elif p.is_file():
            out[rel] = ("file", p.read_bytes())
    return out


@pytest.mark.parametrize("policy", ["exclude_unclear", "keep_all"])
def test_exports_match(boxed_parquet, split_csvs, tmp_path, policy):
    port, ref = tmp_path / "port", tmp_path / "jax"
    for name, csv in split_csvs.items():
        frames = load_split_frames(boxed_parquet, csv)
        got = exports.export_yolo_split(name, frames, port / "yolo", unclear_policy=policy)
        want = jexports.export_yolo_split(name, frames, ref / "yolo", unclear_policy=policy)
        assert asdict(got) == asdict(want)
        got = exports.export_coco_split(split_name=name, frames_df=frames,
                                        out_dataset_dir=port / "coco", unclear_policy=policy)
        want = jexports.export_coco_split(split_name=name, frames_df=frames,
                                          out_dataset_dir=ref / "coco", unclear_policy=policy)
        assert {**asdict(got), "ann_json_path": None} == {**asdict(want), "ann_json_path": None}
        assert got.ann_json_path == str(port / "coco" / "annotations" / f"instances_{name}.json")
        assert json.loads((port / "coco" / "annotations" / f"instances_{name}.json").read_text()) \
            == json.loads((ref / "coco" / "annotations" / f"instances_{name}.json").read_text())
    for names in ({0: "pedestrian"}, ["pedestrian", "cyclist"]):
        got = exports.write_yolo_dataset_yaml(port / "yolo", names)
        want = jexports.write_yolo_dataset_yaml(ref / "yolo", names)
        assert got.read_text() == want.read_text().replace(str(ref.resolve()), str(port.resolve()))
    got_tree, ref_tree = _tree(port), _tree(ref)
    assert list(got_tree) == list(ref_tree)
    n_labels = 0
    for rel, (kind, value) in ref_tree.items():
        if rel.endswith(".yaml"):
            continue
        assert got_tree[rel] == (kind, value), rel   # symlinks name the same images
        n_labels += rel.endswith(".txt")
    assert n_labels == 12


def test_export_helpers_match(tmp_path):
    for box in ([-5.0, 3.0, 1300.0, 800.0], [10, 10, 10, 20], [1, 2, 3, 4], np.float32([0, 0, 5, 5])):
        for w, h in ((1248.0, 704.0), (2.0, 3.0)):
            assert exports.xyxy_to_coco_xywh(box, w, h) == jexports.xyxy_to_coco_xywh(box, w, h)
    for value in (None, [True, False], np.array([False])):
        assert np.array_equal(exports._unclear_flags(value), jexports._unclear_flags(value))
    df = pd.DataFrame({"frame_id": ["000001"]})
    for mod in (exports, jexports):
        with pytest.raises(ValueError, match="missing required column 'xyxy_bboxes'"):
            mod._require_columns(df, ["frame_id", "xyxy_bboxes"])
    src = tmp_path / "img.jpg"
    src.write_bytes(b"x")
    for mod, name in ((exports, "a"), (jexports, "b")):
        mod._symlink_image(src, tmp_path / f"{name}.jpg")
        mod._symlink_image(tmp_path / "other.jpg", tmp_path / f"{name}.jpg")   # kept
        assert (tmp_path / f"{name}.jpg").readlink() == src.resolve()


def _assert_same(got, ref, path="report"):
    if isinstance(ref, pd.DataFrame):
        pd.testing.assert_frame_equal(got, ref)
    elif isinstance(ref, pd.Series):
        pd.testing.assert_series_equal(got, ref)
    elif isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(got), path
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


def test_qa_matches(indexed_parquet, boxed_parquet):
    for parquet in (indexed_parquet, boxed_parquet):
        df = pd.read_parquet(parquet)
        _assert_same(qa.run_full_qa(df), jqa.run_full_qa(df))
        for fn in ("label_distributions", "missing_values", "parallel_array_invariant",
                   "occlusion_consistency", "context_crosstabs", "bbox_stats"):
            _assert_same(getattr(qa, fn)(df), getattr(jqa, fn)(df), fn)
        _assert_same(qa.bbox_stats(df, min_heights=(4, 40)),
                     jqa.bbox_stats(df, min_heights=(4, 40)))

    df = pd.read_parquet(boxed_parquet)
    i = int(df.index[(df.ped_count_clear + df.ped_count_unclear) > 0][0])
    df.at[i, "ped_uuid"] = list(df.at[i, "ped_uuid"])[:-1]
    df.loc[df.index[1], "ped_occ_none"] += 1
    _assert_same(qa.parallel_array_invariant(df), jqa.parallel_array_invariant(df))
    _assert_same(qa.occlusion_consistency(df), jqa.occlusion_consistency(df))
    for mod in (qa, jqa):
        with pytest.raises(AssertionError, match="parallel-array"):
            mod.run_full_qa(df)
    empty = df.iloc[:0]
    _assert_same(qa.bbox_stats(empty), jqa.bbox_stats(empty))
