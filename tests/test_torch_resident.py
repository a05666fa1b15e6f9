"""The port's device-resident loader against the JAX package's, on the CPU.

``ResidentDetectionLoader(device="cpu")`` and JAX's (on JAX's CPU device)
over the same pre-resized 64×128 4:2:0 corpus (``tests/_torch_data.py``):
batch for batch over two shuffled epochs with ``drop_last=False`` (the
final batch padded with copies of the first local frame, ``batch_valid``
false there), with two processes, on the ``yuv420`` and the ``rgb`` store;
the device half alone (``from_arrays``) against the whole loader; the
resident batches against the streaming loader's through
``prefetch_to_device``; the ``ValueError`` on a corpus that is not
pre-resized. Tolerance: bitwise equality. The yuv420 cases skip where the
port's native decoder cannot be built.
"""

import numpy as np
import pytest
import torch

from _torch_data import (MAX_BOXES, H, W, assert_batches_equal, require_native, to_numpy,
                         write_corpus)
from multimodal_moe_torch.data import pipeline as tp
from multimodal_moe_torch.data import resident as tr
from multimodal_moe_tpu.data import pipeline as jp
from multimodal_moe_tpu.data import resident as jr


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("torch_resident"), 10, seed=6)


def _datasets(corpus, h=H, w=W):
    kw = dict(frames_parquet=str(corpus["parquet"]), split_csv=str(corpus["train"]),
              img_h=h, img_w=w, max_boxes=MAX_BOXES)
    return (tp.ZODMoEVisionDataset(tp.ZODMoEDataConfig(**kw)),
            jp.ZODMoEVisionDataset(jp.ZODMoEDataConfig(**kw)))


def _epochs(loader, n=2):
    return [[to_numpy(b) for b in loader] for _ in range(n)]


def test_target_arrays_match_jax(corpus):
    tds, jds = _datasets(corpus)
    assert_batches_equal(tr._build_target_arrays(tds), jr._build_target_arrays(jds))


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("store", ["yuv420", "rgb"])
def test_resident_two_shuffled_epochs(corpus, store, process_index, process_count):
    if store == "yuv420":
        require_native()
    tds, jds = _datasets(corpus)
    kw = dict(batch_size=4, shuffle=True, seed=3, drop_last=False, num_workers=2,
              process_index=process_index, process_count=process_count, store=store)
    tl = tr.ResidentDetectionLoader(tds, device="cpu", **kw)
    jl = jr.ResidentDetectionLoader(jds, **kw)
    assert tl.store == jl.store == store and len(tl) == len(jl)
    got, want = _epochs(tl), _epochs(jl)
    assert [len(e) for e in got] == [len(e) for e in want] == [len(tl)] * 2
    for ge, we in zip(got, want):
        for a, b in zip(ge, we):
            assert_batches_equal(a, b)
    n_local = len(range(process_index, len(tds), process_count))
    if n_local % 4:   # the pad rows repeat the first local frame
        last, rem = got[0][-1], n_local % 4
        np.testing.assert_array_equal(last["batch_valid"], [True] * rem + [False] * (4 - rem))
        first = to_numpy(tl.gather(torch.zeros(1, dtype=torch.int64)))
        for k in ("image", "gt_boxes", "solar_bin"):
            assert (last[k][rem:] == first[k]).all()


def test_resident_drop_last_and_len(corpus):
    require_native()
    tds, jds = _datasets(corpus)
    tl = tr.ResidentDetectionLoader(tds, 3, shuffle=True, seed=1, device="cpu")
    jl = jr.ResidentDetectionLoader(jds, 3, shuffle=True, seed=1)
    assert len(tl) == len(jl) == 3
    for a, b in zip(_epochs(tl, 1)[0], _epochs(jl, 1)[0]):
        assert_batches_equal(a, b)


def test_device_half_alone_matches_the_loader(corpus):
    """``from_arrays`` over the host half's arrays gives the loader's batches."""
    require_native()
    tds, _ = _datasets(corpus)
    local = np.arange(len(tds))
    arrays = {**tr._build_target_arrays(tds), **tr._load_pixels(tds, local, "yuv420", 2)}
    kw = dict(shuffle=True, seed=4, drop_last=False, device="cpu")
    whole = tr.ResidentDetectionLoader(tds, 4, **kw)
    half = tr.ResidentDetectionLoader.from_arrays(arrays, 4, **kw)
    assert half.resident_bytes == whole.resident_bytes == sum(a.nbytes for a in arrays.values())
    for a, b in zip(_epochs(half)[1], _epochs(whole)[1]):
        assert_batches_equal(a, b)
    with pytest.raises(ValueError, match="missing"):
        tr.ResidentDetectionLoader.from_arrays({"y": arrays["y"]}, 4, device="cpu")


def test_resident_equals_streaming_through_prefetch(corpus):
    """The streaming yuv420 loader's batches, made ``image`` by
    ``prefetch_to_device``, are the resident loader's (the padded rows
    aside: zeros there, the first frame here)."""
    require_native()
    tds, _ = _datasets(corpus)
    kw = dict(shuffle=True, seed=8, drop_last=False)
    stream = tp.prefetch_to_device(iter(tp.DetectionLoader(tds, 4, store="yuv420", **kw)),
                                   device="cpu")
    resident = tr.ResidentDetectionLoader(tds, 4, device="cpu", **kw)
    for s, r in zip(stream, resident):
        valid = s["batch_valid"]
        np.testing.assert_array_equal(valid, r["batch_valid"])
        s, r = to_numpy(s), to_numpy(r)
        assert set(s) == set(r)
        for k in s:
            np.testing.assert_array_equal(s[k][valid], r[k][valid], err_msg=k)


def test_resident_batches_pass_prefetch_untouched(corpus):
    require_native()
    tds, _ = _datasets(corpus)
    resident = tr.ResidentDetectionLoader(tds, 5, device="cpu")
    batches = list(resident)
    resident._epoch = 0
    for b, p in zip(batches, tp.prefetch_to_device(iter(batches), device="cpu")):
        assert all(p[k] is b[k] for k in b)


def test_resident_requires_presized(corpus):
    tds, jds = _datasets(corpus, 32, 64)
    with pytest.raises(ValueError, match="pre-resized"):
        tr.ResidentDetectionLoader(tds, 4, device="cpu")
    with pytest.raises(ValueError, match="pre-resized"):
        jr.ResidentDetectionLoader(jds, 4)


def test_resident_yuv420_stores_rgb_without_the_decoder(corpus, monkeypatch, capsys):
    """Where the native decoder is missing (the card's host has no
    ``jpeglib.h``), the ``yuv420`` store keeps RGB, as JAX's loader does:
    ``store`` says ``"rgb"`` and the batches are bitwise JAX's loader's
    under the same patch, over two shuffled epochs."""
    from multimodal_moe_torch.data import native_decode
    from multimodal_moe_tpu.data import native_decode as jax_native_decode

    monkeypatch.setattr(native_decode, "native_available", lambda: False)
    monkeypatch.setattr(jax_native_decode, "native_available", lambda: False)
    tds, jds = _datasets(corpus)
    kw = dict(shuffle=True, seed=3, drop_last=False)
    port = tr.ResidentDetectionLoader(tds, 4, store="yuv420", device="cpu", **kw)
    assert "yuv420 path unavailable" in capsys.readouterr().err
    ref = jr.ResidentDetectionLoader(jds, 4, store="yuv420", **kw)
    assert port.store == "rgb" and ref.store == "rgb"
    for ours, theirs in zip(_epochs(port), _epochs(ref)):
        assert len(ours) == len(theirs)
        for o, t in zip(ours, theirs):
            assert_batches_equal(o, t)
    with pytest.raises(ValueError, match="unknown store"):
        tr.ResidentDetectionLoader(tds, 4, store="bgr", device="cpu")


def test_resident_needs_a_device_or_cpu(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tds, _ = _datasets(corpus)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.ResidentDetectionLoader(tds, 4)
