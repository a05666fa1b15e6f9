"""The ingestion chain of the port against the JAX package's on the CPU.

* ``data/synthetic.py``: the same seed writes the same tree (every JPEG and
  JSON byte-equal) for both height distributions and a night fraction;
  an unknown ``height_dist`` raises in both.
* ``data/indexer.py``: ``build_index`` on one tree gives JAX's frame
  (``assert_frame_equal`` with the resized-image roots substituted), the
  resized JPEGs byte-equal, the parquet read back alike (list columns
  through pyarrow), ``add_xyxy_bboxes``, the ambiguity raise, resized
  files skipped, dict-wrapped annotations, a failed resize, no tqdm.
* The slice as a whole: ``python -m multimodal_moe_torch.cli.build_synth_corpus``
  and JAX's ``scripts/build_synth_corpus.py``, each as a child at the
  protocol geometry (3848×2168 rendered at 1924×1084, resized to
  1248×704) with ``CHAIN_FRAMES`` frames and ``--seed CHAIN_SEED``: every
  written file equal (parquets as frames with the roots substituted, the
  summary without its wall time, the rest as bytes); then the port's
  ``DetectionLoader`` over the port's corpus gives batches bitwise equal to
  JAX's loader over JAX's corpus.

At the protocol's 5,000 frames every stratification class holds tens of
frames; a small corpus has singleton classes at most seeds, and then both
packages' splits raise. ``CHAIN_SEED`` / ``CHAIN_FRAMES`` is a pair where
JAX's chain completes (found by running it), as ``SMALL_SEED`` is at the
small render size the other tests use."""

import builtins
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_data import assert_batches_equal
from multimodal_moe_torch.data import indexer, synthetic
from multimodal_moe_torch.data import pipeline as tp
from multimodal_moe_tpu.data import indexer as jindexer
from multimodal_moe_tpu.data import pipeline as jp
from multimodal_moe_tpu.data import synthetic as jsynthetic

REPO = Path(__file__).resolve().parents[1]
SMALL_WH = (962, 542)           # rendered at 481×271
SMALL_SEED, SMALL_FRAMES = 0, 24
CHAIN_SEED, CHAIN_FRAMES = 11, 42
PATH_COLUMNS = ("image_path", "resized_image_path")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def substituted(df: pd.DataFrame, old: Path, new: Path) -> pd.DataFrame:
    df = df.copy()
    for col in PATH_COLUMNS:
        if col in df.columns:
            df[col] = df[col].map(lambda s: None if s is None else s.replace(str(old), str(new)))
    return df


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest_trees")
    kw = dict(seed=SMALL_SEED, img_wh=SMALL_WH)
    return (synthetic.make_synthetic_zod_tree(root / "port", SMALL_FRAMES, **kw),
            jsynthetic.make_synthetic_zod_tree(root / "jax", SMALL_FRAMES, **kw))


# -- synthetic -----------------------------------------------------------------

def test_synthetic_tree_is_byte_equal(trees):
    port, ref = trees
    got, want = files(port), files(ref)
    assert list(got) == list(want) and len(want) == 3 * SMALL_FRAMES
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.mark.parametrize("height_dist, night_fraction",
                         [("zod704", 0.5), ("easy", None), ("easy", 0.25)])
def test_synthetic_options_are_byte_equal(tmp_path, height_dist, night_fraction):
    # The full frame ("easy" places figures up to 700 px high), rendered at 481×271.
    kw = dict(seed=5, render_scale=8, max_peds=12, height_dist=height_dist,
              night_fraction=night_fraction)
    got = files(synthetic.make_synthetic_zod_tree(tmp_path / "port", 10, **kw))
    want = files(jsynthetic.make_synthetic_zod_tree(tmp_path / "jax", 10, **kw))
    assert got == want


def test_synthetic_pieces_match(tmp_path):
    for name in ("ORIG_W", "ORIG_H", "_FULL_PER_704", "_SOLAR_BIN_SPECS"):
        assert getattr(synthetic, name) == getattr(jsynthetic, name), name
    for name in ("_ZOD704_HEIGHT_PX", "_ZOD704_CDF"):
        assert np.array_equal(getattr(synthetic, name), getattr(jsynthetic, name)), name
    got = synthetic.sample_heights_704(np.random.default_rng(3), 1000)
    assert np.array_equal(got, jsynthetic.sample_heights_704(np.random.default_rng(3), 1000))
    boxes = [[10.0, 20.0, 30.0, 90.0], [0.5, 0.5, 1.2, 2.0], [100.0, 5.0, 140.0, 100.0]]
    for night in (False, True):
        img = synthetic._render_scene(np.random.default_rng(1), boxes, w=160, h=96, night=night)
        ref = jsynthetic._render_scene(np.random.default_rng(1), boxes, w=160, h=96, night=night)
        assert np.array_equal(img, ref)
    for mod in (synthetic, jsynthetic):
        with pytest.raises(ValueError, match="height_dist"):
            mod.make_synthetic_zod_tree(tmp_path / mod.__name__, 2, height_dist="bogus")


# -- indexer -------------------------------------------------------------------

def test_build_index_matches(trees, tmp_path):
    _, raw = trees
    cfg = dict(zod_root=raw, out_parquet=tmp_path / "unused.parquet", new_w=624, new_h=352,
               workers=4)
    got = indexer.build_index(indexer.IndexConfig(resized_img_root=tmp_path / "port", **cfg),
                              progress=False)
    want = jindexer.build_index(jindexer.IndexConfig(resized_img_root=tmp_path / "jax", **cfg),
                                progress=False)
    assert len(want) == SMALL_FRAMES
    pd.testing.assert_frame_equal(substituted(got, tmp_path / "port", tmp_path / "jax"), want)
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    pd.testing.assert_frame_equal(indexer.add_xyxy_bboxes(want), jindexer.add_xyxy_bboxes(want))


def test_write_index_round_trips_as_jax(trees, tmp_path):
    _, raw = trees
    out = {}
    for name, mod in (("port", indexer), ("jax", jindexer)):
        cfg = mod.IndexConfig(zod_root=raw, out_parquet=tmp_path / name / "idx.parquet",
                              resized_img_root=None, workers=2, max_frames=9)
        out[name] = pd.read_parquet(mod.write_index(cfg, progress=True))
    pd.testing.assert_frame_equal(out["port"], out["jax"])
    assert out["jax"]["resized_image_path"].isna().all() and len(out["jax"]) == 9
    assert isinstance(out["port"].loc[0, "ped_points_xy_resized"], np.ndarray)
    pd.testing.assert_frame_equal(indexer.add_xyxy_bboxes(out["jax"]),
                                  jindexer.add_xyxy_bboxes(out["jax"]))


def test_indexer_edges(tmp_path, monkeypatch):
    cam = tmp_path / "f" / "camera_front_dnat"
    cam.mkdir(parents=True)
    for mod in (indexer, jindexer):
        assert mod.find_front_dnat_image(tmp_path / "f") is None
    (cam / "a_resized.jpg").write_bytes(b"")
    (cam / "b.jpg").write_bytes(b"")
    for mod in (indexer, jindexer):
        assert mod.find_front_dnat_image(tmp_path / "f") == cam / "b.jpg"
    (cam / "c.jpg").write_bytes(b"")
    messages = []
    for mod in (indexer, jindexer):
        with pytest.raises(ValueError) as e:
            mod.find_front_dnat_image(tmp_path / "f")
        messages.append(str(e.value))
    assert messages[0] == messages[1]

    anns = [{"properties": {"class": "Pedestrian", "unclear": True, "annotation_uuid": "u1"},
             "geometry": {"coordinates": [[[0, 0], [40, 0], [40, 90], [0, 90]]]}},
            {"properties": {"class": "Pedestrian", "occlusion_ratio": "Weird"},
             "geometry": {"coordinates": [[1, 2], [3, 4]]}},
            {"properties": {"class": "Pedestrian", "occlusion_ratio": " heavy "},
             "geometry": {"coordinates": [[5, 5], [9, "x"], [9, 30], [5, 30], [7, 7]]}},
            {"properties": {"class": "Vehicle"}}, "junk", {"properties": None}]
    for a in (anns, {"annotations": anns}, None, {"other": 1}):
        assert indexer.parse_pedestrian_annotations(a, 0.3, 0.4) == \
            jindexer.parse_pedestrian_annotations(a, 0.3, 0.4)
    for c in ([], None, [[1, 2]], [[[1.5, 2]], [3, 4]], [[[]]], [(1, 2, 3), [True, 2.0]]):
        assert indexer.normalize_multipoint_coords(c) == jindexer.normalize_multipoint_coords(c)
    for occ in (None, "None", "VeryHeavy", "x", 0.5):
        assert indexer.occlusion_bucket(occ) == jindexer.occlusion_bucket(occ)
    for n in (0, 1, 5, 6, 15, 16, 99):
        assert indexer.ped_bin_4(n) == jindexer.ped_bin_4(n)
    assert indexer.resize_points_xy([[1.0, 2.0]] * 3, 0.3, 0.7) == \
        jindexer.resize_points_xy([[1.0, 2.0]] * 3, 0.3, 0.7)
    (tmp_path / "bad.json").write_text("{")
    assert indexer.read_json(tmp_path / "bad.json") is None
    cfg = indexer.IndexConfig(zod_root=tmp_path, out_parquet=tmp_path / "x.parquet")
    assert (cfg.sx, cfg.sy, cfg.jpeg_quality, cfg.workers) == (1248 / 3848, 704 / 2168, 95, 16)
    assert indexer._resize_and_save(cfg, cam / "b.jpg", tmp_path / "out.jpg") is False

    real_import = builtins.__import__

    def no_tqdm(name, *a, **k):
        if name == "tqdm":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tqdm)
    assert indexer.build_index(cfg).empty                  # progress on, no tqdm


# -- the slice as a whole ------------------------------------------------------

def run_corpus_children(root: Path) -> dict:
    env = {**os.environ, "MMOE_XLA_CACHE": "", "OMP_NUM_THREADS": "1",
           "PYTHONDONTWRITEBYTECODE": "1"}
    args = ["--frames", str(CHAIN_FRAMES), "--seed", str(CHAIN_SEED), "--workers", "2"]
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-m", "multimodal_moe_torch.cli.build_synth_corpus",
             "--root", str(root / "port"), *args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "jax": subprocess.Popen(
            [sys.executable, "scripts/build_synth_corpus.py", "--root", str(root / "jax"), *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=150)[0]
            assert proc.returncode == 0, (name, logs[name][-3000:])
    finally:
        for proc in procs.values():
            proc.kill()
    return logs


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest_chain")
    logs = run_corpus_children(root)
    return root / "port", root / "jax", logs


def test_build_synth_corpus_writes_jax_files(corpora):
    port, ref, logs = corpora
    got, want = files(port), files(ref)
    assert list(got) == list(want)
    index = Path("outputs") / "index"
    parquets = sorted(str(index / p) for p in ("ZODmoe_frames.parquet",
                                               "ZODmoe_frames_with_xyxy_bboxes.parquet",
                                               "ZODmoe_frames_with_xyxy_bboxes_and_solar_bins.parquet"))
    assert sorted(r for r in want if r.endswith(".parquet")) == parquets
    for rel in parquets:
        pd.testing.assert_frame_equal(substituted(pd.read_parquet(port / rel), port, ref),
                                      pd.read_parquet(ref / rel))
    summary = {k: v for k, v in json.loads(got.pop("corpus_build_summary.json")).items()
               if k != "wall_s"}
    ref_summary = {k: v for k, v in json.loads(want.pop("corpus_build_summary.json")).items()
                   if k != "wall_s"}
    assert json.loads(json.dumps(summary).replace(str(port), str(ref))) == ref_summary
    assert sum(ref_summary["split_sizes"].values()) == CHAIN_FRAMES
    n_jpegs = 0
    for rel in want:
        if not rel.endswith(".parquet"):
            assert got[rel] == want[rel], rel
            n_jpegs += rel.endswith(".jpg")
    assert n_jpegs == 2 * CHAIN_FRAMES               # raw frames and resized frames
    stages = json.loads(next(line for line in logs["port"].splitlines()
                             if line.startswith("[stages] "))[len("[stages] "):])
    assert set(stages["seconds"]) == {"render", "index", "boxes", "solar_bins", "splits"}


def test_loader_over_the_port_corpus_matches_jax(corpora):
    port, ref, _ = corpora
    batches = {}
    for name, root, mod in (("port", port, tp), ("jax", ref, jp)):
        cfg = mod.ZODMoEDataConfig(
            frames_parquet=str(root / "outputs" / "index"
                               / "ZODmoe_frames_with_xyxy_bboxes_and_solar_bins.parquet"),
            split_csv=str(root / "splits" / "train_ids.csv"), img_h=176, img_w=312,
            max_boxes=12)
        loader = mod.DetectionLoader(mod.ZODMoEVisionDataset(cfg), 8, shuffle=True, seed=2,
                                     num_workers=2)
        batches[name] = list(loader)
    n_train = CHAIN_FRAMES - -(-CHAIN_FRAMES // 5)    # n - ceil(0.2 n)
    assert len(batches["port"]) == len(batches["jax"]) == n_train // 8
    for got, want in zip(batches["port"], batches["jax"]):
        assert_batches_equal(got, want)
