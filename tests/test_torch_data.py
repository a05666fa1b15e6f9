"""The port's host data path against the JAX package's, on the CPU.

``data/solar.py``, ``data/index.py``, ``safe_iter_boxes``,
``ZODMoEVisionDataset`` (``load``, ``load_targets``: the resize and its box
rescale, the unclear policy before ``max_boxes``, a missing solar column),
``DetectionLoader`` (``rgb`` and ``yuv420`` over two shuffled epochs,
``drop_last`` on and off, two processes, ``__len__``, ``store="auto"``
both ways) and ``prefetch_to_device(device="cpu")`` on both stores, on one
seeded corpus of pre-resized 64×128 4:2:0 JPEGs (``tests/_torch_data.py``).
Tolerance: bitwise equality of every array (both sides decode with the
same PIL and libjpeg; the YUV420 conversion is bitwise equal since the
evaluation path's port). The yuv420 cases skip where the port's native
decoder cannot be built.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_data import (MAX_BOXES, H, W, assert_batches_equal, require_native, to_numpy,
                         write_corpus)
from multimodal_moe_torch.data import exports as texports
from multimodal_moe_torch.data import index as tindex
from multimodal_moe_torch.data import pipeline as tp
from multimodal_moe_torch.data import solar as tsolar
from multimodal_moe_tpu.data import exports as jexports
from multimodal_moe_tpu.data import index as jindex
from multimodal_moe_tpu.data import pipeline as jp
from multimodal_moe_tpu.data import solar as jsolar


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("torch_data"), 11, seed=3)


@pytest.fixture(scope="module")
def resize_corpus(tmp_path_factory):
    """Frames at 48×80, not at the configured 64×128: PIL resizes them and
    the boxes are rescaled."""
    return write_corpus(tmp_path_factory.mktemp("torch_data_resize"), 5, h=48, w=80, seed=4)


def _cfgs(corpus, **kw):
    kw = {**dict(frames_parquet=str(corpus["parquet"]), split_csv=str(corpus["train"]),
                 img_h=H, img_w=W, max_boxes=MAX_BOXES), **kw}
    return tp.ZODMoEDataConfig(**kw), jp.ZODMoEDataConfig(**kw)


def _datasets(corpus, **kw):
    tcfg, jcfg = _cfgs(corpus, **kw)
    return tp.ZODMoEVisionDataset(tcfg), jp.ZODMoEVisionDataset(jcfg)


# -- solar, index, exports ---------------------------------------------------

def test_solar_constants_and_bins():
    for name in ("SOLAR_BIN_EDGES", "SOLAR_BIN_LABELS", "MISSING_LABEL", "NUM_SOLAR_BINS",
                 "SOLAR_BIN_TO_ID"):
        assert getattr(tsolar, name) == getattr(jsolar, name), name
    elev = [-90.0, -6.0, -5.999, 0.0, 1e-9, 15.0, 15.5, 45.0, 46.0, None, float("nan"), "x",
            "12.5", 1e12]
    np.testing.assert_array_equal(tsolar.solar_bin_ids(elev), jsolar.solar_bin_ids(elev))
    assert tsolar.solar_bin_ids(elev).dtype == np.int32
    ids = np.array([0, 5, 2, 2])
    np.testing.assert_array_equal(tsolar.solar_bin_one_hot(ids), jsolar.solar_bin_one_hot(ids))


def test_frame_id_normalization():
    values = [1, "2", " 3 ", "4.0", 123456, "000007", 8.0, "1234567"]
    pd.testing.assert_series_equal(tindex.normalize_frame_id_series(values),
                                   jindex.normalize_frame_id_series(values))
    for v in values:
        assert tindex.normalize_frame_id(v) == jindex.normalize_frame_id(v)


def test_load_split_frames_order_and_errors(corpus, tmp_path):
    got = tindex.load_split_frames(corpus["parquet"], corpus["train"])
    want = jindex.load_split_frames(corpus["parquet"], corpus["train"])
    pd.testing.assert_frame_equal(got, want)
    order = [int(v) for v in corpus["train"].read_text().split()[1:]]
    assert got["frame_id"].tolist() == [f"{i:06d}" for i in order]   # split-CSV order
    cols = ["resized_image_path"]
    pd.testing.assert_frame_equal(
        tindex.load_split_frames(corpus["parquet"], corpus["val"], required_columns=cols),
        jindex.load_split_frames(corpus["parquet"], corpus["val"], required_columns=cols))
    empty = tmp_path / "none.csv"
    empty.write_text("frame_id\n999998\n999999\n")
    for mod in (tindex, jindex):
        with pytest.raises(RuntimeError, match="No rows matched"):
            mod.load_split_frames(corpus["parquet"], empty)
    bad = tmp_path / "bad.csv"
    bad.write_text("id\n1\n")
    for mod in (tindex, jindex):
        with pytest.raises(ValueError, match="missing 'frame_id'"):
            mod.load_split_frames(corpus["parquet"], bad)
        with pytest.raises(FileNotFoundError):
            mod.load_split_frames(tmp_path / "absent.parquet", corpus["train"])


@pytest.mark.parametrize("boxes", [
    None, [], np.zeros((0, 4)), [[1, 2, 3, 4], [5, 6, 7, 8]], np.arange(8.0).reshape(2, 4),
    np.arange(4.0), [1, 2, 3], np.arange(6.0).reshape(2, 3),
    np.array([np.arange(4.0), np.arange(3.0), [9, 8, 7, 6]], dtype=object),
    np.array([np.arange(4.0), np.arange(4.0) + 1], dtype=object),
], ids=["none", "list0", "empty2d", "lists", "2d", "1d", "1d3", "2d3", "object_ragged",
        "object"])
def test_safe_iter_boxes(boxes):
    got, want = texports.safe_iter_boxes(boxes), jexports.safe_iter_boxes(boxes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


# -- the dataset ---------------------------------------------------------------

@pytest.mark.parametrize("policy", ["exclude_unclear", "keep_all"])
def test_dataset_load_and_targets(corpus, policy):
    tds, jds = _datasets(corpus, unclear_policy=policy)
    assert len(tds) == len(jds) == 11
    pd.testing.assert_frame_equal(tds.df, jds.df)
    truncated = 0
    for i in range(len(tds)):
        assert_batches_equal(tds.load(i), jds.load(i))
        assert_batches_equal(tds.load_targets(i, 0.5, 2.0), jds.load_targets(i, 0.5, 2.0))
        img, label = tds[i]
        np.testing.assert_array_equal(img, jds[i][0])
        assert label == jds[i][1]
        truncated += len(tds._boxes_for_row(tds.df.iloc[i])) > MAX_BOXES
    assert truncated, "no frame has more boxes than max_boxes"
    # Every solar id, the unknown label's among them (the last id).
    assert {int(tds.load_targets(i)["solar_bin"]) for i in range(len(tds))} == set(range(6))


def test_dataset_resize_rescales_boxes(resize_corpus):
    tds, jds = _datasets(resize_corpus)
    for i in range(len(tds)):
        got, want = tds.load(i), jds.load(i)
        assert_batches_equal(got, want)
        raw = tds.load_targets(i)
        if raw["gt_mask"].any():
            assert not np.array_equal(got["gt_boxes"], raw["gt_boxes"])


def test_dataset_without_solar_column(tmp_path):
    corpus = write_corpus(tmp_path, 4, seed=5, solar=False)
    tds, jds = _datasets(corpus)
    for i in range(len(tds)):
        assert_batches_equal(tds.load_targets(i), jds.load_targets(i))
        assert int(tds.load_targets(i)["solar_bin"]) == tsolar.NUM_SOLAR_BINS - 1


def test_dataset_drops_missing_images(corpus, tmp_path):
    df = pd.read_parquet(corpus["parquet"])
    df.loc[2, "resized_image_path"] = str(tmp_path / "gone.jpg")
    parquet = tmp_path / "frames.parquet"
    df.to_parquet(parquet)
    tds, jds = _datasets(corpus, frames_parquet=str(parquet))
    assert len(tds) == len(jds) == 10
    pd.testing.assert_frame_equal(tds.df, jds.df)


# -- the loader ----------------------------------------------------------------

def _epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


def _assert_loaders_equal(tl, jl, epochs=2):
    assert len(tl) == len(jl)
    for tb, jb in zip(_epochs(tl, epochs), _epochs(jl, epochs)):
        assert len(tb) == len(jb) == len(tl)
        for a, b in zip(tb, jb):
            assert_batches_equal(a, b)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("store", ["rgb", "yuv420"])
def test_loader_two_shuffled_epochs(corpus, store, drop_last):
    if store == "yuv420":
        require_native()
    tds, jds = _datasets(corpus)
    kw = dict(batch_size=4, shuffle=True, seed=9, num_workers=2, drop_last=drop_last,
              store=store)
    tl, jl = tp.DetectionLoader(tds, **kw), jp.DetectionLoader(jds, **kw)
    assert tl.store == jl.store == store
    _assert_loaders_equal(tl, jl)
    if not drop_last:   # 11 = 4 + 4 + 3: the final batch has one zero row
        last = list(tl)[-1]
        np.testing.assert_array_equal(last["batch_valid"], [True] * 3 + [False])
        assert not last["gt_mask"][3].any() and not last["y" if store == "yuv420" else "image"][3].any()


@pytest.mark.parametrize("store", ["rgb", "yuv420"])
def test_loader_two_processes(corpus, store):
    if store == "yuv420":
        require_native()
    tds, jds = _datasets(corpus)
    seen = []
    for pi in range(2):
        kw = dict(batch_size=2, shuffle=True, seed=5, num_workers=1, drop_last=False,
                  process_index=pi, process_count=2, store=store)
        tl, jl = tp.DetectionLoader(tds, **kw), jp.DetectionLoader(jds, **kw)
        _assert_loaders_equal(tl, jl, epochs=1)
        for b in tl:   # the second epoch: another order, the same frames
            key = "y" if store == "yuv420" else "image"
            seen += [x.tobytes() for x in b[key][b["batch_valid"]]]
    assert len(seen) == len(set(seen)) == len(tds)   # disjoint and complete


def test_loader_len(corpus):
    tds, jds = _datasets(corpus)
    for kw in (dict(batch_size=4), dict(batch_size=4, drop_last=False),
               dict(batch_size=2, process_index=1, process_count=2),
               dict(batch_size=3, process_index=0, process_count=3, drop_last=False)):
        assert len(tp.DetectionLoader(tds, **kw)) == len(jp.DetectionLoader(jds, **kw)), kw


def test_loader_store_auto_both_ways(corpus, resize_corpus, capfd):
    require_native()
    tds, jds = _datasets(corpus)
    assert tp.DetectionLoader(tds, 2, store="auto").store == "yuv420"
    assert jp.DetectionLoader(jds, 2, store="auto").store == "yuv420"
    rtds, rjds = _datasets(resize_corpus)
    capfd.readouterr()
    assert tp.DetectionLoader(rtds, 2, store="auto").store == "rgb"
    port_line = capfd.readouterr().err
    assert jp.DetectionLoader(rjds, 2, store="auto").store == "rgb"
    assert port_line == capfd.readouterr().err != ""
    for mod, ds in ((tp, rtds), (jp, rjds)):
        with pytest.raises(ValueError, match="not usable"):
            mod.DetectionLoader(ds, 2, store="yuv420")
        with pytest.raises(ValueError, match="unknown store"):
            mod.DetectionLoader(ds, 2, store="png")


def test_loader_auto_falls_back_without_the_decoder(corpus, monkeypatch, capfd):
    """Where the decoder cannot be built, ``auto`` takes RGB and says why;
    an explicit ``yuv420`` raises."""
    from multimodal_moe_torch.data import native_decode

    monkeypatch.setattr(native_decode, "native_available", lambda: False)
    tds, _ = _datasets(corpus)
    assert tp.DetectionLoader(tds, 2, store="auto").store == "rgb"
    assert "native decoder unavailable" in capfd.readouterr().err
    with pytest.raises(ValueError, match="not usable"):
        tp.DetectionLoader(tds, 2, store="yuv420")


# -- prefetch_to_device ----------------------------------------------------------

@pytest.mark.parametrize("store", ["rgb", "yuv420"])
def test_prefetch_to_cpu_matches_jax(corpus, store):
    if store == "yuv420":
        require_native()
    tds, jds = _datasets(corpus)
    kw = dict(batch_size=4, shuffle=True, seed=2, num_workers=2, drop_last=False, store=store)
    got = list(tp.prefetch_to_device(iter(tp.DetectionLoader(tds, **kw)), device="cpu"))
    want = list(jp.prefetch_to_device(iter(jp.DetectionLoader(jds, **kw))))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert "y" not in a and "cb" not in a and "cr" not in a
        assert isinstance(a["image"], torch.Tensor) and a["image"].device.type == "cpu"
        assert isinstance(a["batch_valid"], np.ndarray)   # the evaluator reads it on the host
        assert_batches_equal(to_numpy(a), to_numpy(b))


def test_prefetch_passes_device_tensors_through(corpus):
    batch = {"image": torch.zeros(2, H, W, 3, dtype=torch.uint8),
             "gt_boxes": np.ones((2, MAX_BOXES, 4), np.float32),
             "batch_valid": np.ones(2, bool)}
    (out,) = list(tp.prefetch_to_device(iter([batch]), device="cpu", buffer_size=1))
    assert out["image"] is batch["image"]
    assert out["batch_valid"] is batch["batch_valid"]
    assert torch.is_tensor(out["gt_boxes"])


def test_prefetch_buffers_ahead():
    """A batch is yielded once ``buffer_size`` batches are queued, as JAX's."""
    pulled = []

    def source():
        for i in range(4):
            pulled.append(i)
            yield {"gt_mask": np.full(2, i)}

    it = tp.prefetch_to_device(source(), device="cpu", buffer_size=3)
    first = next(it)
    assert int(first["gt_mask"][0]) == 0 and pulled == [0, 1, 2]
    assert [int(b["gt_mask"][0]) for b in it] == [1, 2, 3]


def test_prefetch_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tp.prefetch_to_device(iter([{"gt_mask": np.ones(1)}])))
