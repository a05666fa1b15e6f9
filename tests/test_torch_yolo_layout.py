"""The port's ``data/yolo_layout.py`` against the JAX package's (CPU).

The synthetic frames (``tests/conftest.py``) exported to an Ultralytics
layout by JAX's ``export_yolo_split`` and ``write_yolo_dataset_yaml``; both
packages' ``YoloLayoutDataset`` at 64×128 (a resize) and at the exported
size (none), every split: the same images in the same order, and every
sample's arrays bitwise equal, dtype and shape included. The errors for a
missing ``dataset.yaml`` and a missing split are the same."""

import numpy as np
import pytest

from multimodal_moe_torch.data import yolo_layout as tl
from multimodal_moe_tpu.data import yolo_layout as jl
from multimodal_moe_tpu.data.exports import export_yolo_split, write_yolo_dataset_yaml
from multimodal_moe_tpu.data.index import load_split_frames


@pytest.fixture(scope="module")
def exported(boxed_parquet, split_csvs, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_yolo_ds")
    for split in ("train", "val"):
        frames = load_split_frames(boxed_parquet, split_csvs[split])
        export_yolo_split(split_name=split, frames_df=frames, out_dataset_dir=out)
    write_yolo_dataset_yaml(out, {0: "pedestrian"})
    return out


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("size", [(64, 128, 3), (704, 1248, 96)], ids=["resized", "exported"])
def test_samples_bitwise_jax(exported, split, size):
    h, w, max_boxes = size
    kw = dict(dataset_yaml=str(exported / "dataset.yaml"), split=split, img_h=h, img_w=w,
              max_boxes=max_boxes)
    got = tl.YoloLayoutDataset(tl.YoloLayoutConfig(**kw))
    want = jl.YoloLayoutDataset(jl.YoloLayoutConfig(**kw))
    assert got.image_paths == want.image_paths and len(got) == len(want) > 0
    boxes = 0
    for i in range(len(want)):
        g, r = got.load(i), want.load(i)
        assert set(g) == set(r)
        for k in r:
            a, b = np.asarray(g[k]), np.asarray(r[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        boxes += int(r["gt_mask"].sum())
        assert got[i][1] == want[i][1]
    if split == "train":
        assert boxes > 0


def test_missing_yaml_and_split_raise(exported, tmp_path):
    for mod in (tl, jl):
        with pytest.raises(FileNotFoundError, match="dataset.yaml not found"):
            mod.YoloLayoutDataset(mod.YoloLayoutConfig(dataset_yaml=str(tmp_path / "none.yaml")))
        with pytest.raises(FileNotFoundError, match="split images dir not found"):
            mod.YoloLayoutDataset(mod.YoloLayoutConfig(
                dataset_yaml=str(exported / "dataset.yaml"), split="test"))
