"""The port's ctypes binding to the native JPEG decoder against the JAX
package's binding to the same source, on the CPU.

The port builds its own copy of ``native/jpeg_loader/jpeg_loader.cpp`` into
``multimodal_moe_torch/build/``; both bindings must return the same bytes:
RGB (direct and through the decoder's resize), raw 4:2:0 planes one by one
and in batches, a height that is not a multiple of the 16-row MCU, a
corrupt stream raising, a 4:4:4 JPEG giving ``None``, and PIL's RGB where
the decoder is unavailable. Tolerance: bitwise equality. The cases skip
where the decoder cannot be built (no g++ or no libjpeg), as the JAX
package's do.
"""

import numpy as np
import pytest

from _torch_data import frame, require_native, write_jpeg
from multimodal_moe_torch.data import native_decode as tn
from multimodal_moe_tpu.data import native_decode as jn

H, W = 64, 128


@pytest.fixture(autouse=True)
def native():
    require_native()
    if not jn.native_available():
        pytest.skip("the JAX package's native decoder is not built")


def _jpegs(tmp_path, n, h=H, w=W, subsampling=2, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i}_{h}x{w}_{subsampling}.jpg"
        write_jpeg(p, frame(rng, h, w), subsampling=subsampling)
        paths.append(p)
    return paths


def _equal(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_library_is_the_ports_own_and_current():
    lib_path = tn.library_path()
    assert lib_path.parent.name == "build" and lib_path.parent.parent.name == "multimodal_moe_torch"
    assert lib_path.exists() and lib_path.stat().st_mtime >= tn._SRC_PATH.stat().st_mtime
    assert tn.load_library().mmoe_jpeg_version() == tn._EXPECTED_VERSION == jn._EXPECTED_VERSION


@pytest.mark.parametrize("src_hw", [(H, W), (2 * H, 2 * W), (48, 80)],
                         ids=["direct", "dct_scaled", "resized"])
def test_rgb_bytes_and_files(tmp_path, src_hw):
    paths = _jpegs(tmp_path, 5, *src_hw)
    for p in paths:
        _equal(tn.decode_jpeg_bytes(p.read_bytes(), H, W), jn.decode_jpeg_bytes(p.read_bytes(), H, W))
    _equal(tn.decode_jpeg_files(paths, H, W, n_threads=2),
           jn.decode_jpeg_files(paths, H, W, n_threads=2))
    out = np.zeros((5, H, W, 3), np.uint8)
    assert tn.decode_jpeg_files(paths, H, W, out=out) is out
    _equal(out, jn.decode_jpeg_files(paths, H, W))


def test_files_out_is_validated(tmp_path):
    paths = _jpegs(tmp_path, 2)
    for bad in (np.zeros((2, H, W, 3), np.float32), np.zeros((3, H, W, 3), np.uint8),
                np.zeros((2, H, W, 6), np.uint8)[..., ::2]):
        with pytest.raises(ValueError, match="out must be"):
            tn.decode_jpeg_files(paths, H, W, out=bad)


@pytest.mark.parametrize("hw", [(H, W), (56, 128), (40, 96)], ids=["aligned", "h56", "h40"])
def test_yuv420_planes(tmp_path, hw):
    """Raw planes one by one and in a batch; 56 and 40 rows leave MCU
    padding rows in the last MCU row, which must not alias real rows."""
    h, w = hw
    paths = _jpegs(tmp_path, 4, h, w, seed=1)
    for p in paths:
        got, want = tn.decode_jpeg_bytes_yuv420(p.read_bytes(), h, w), \
            jn.decode_jpeg_bytes_yuv420(p.read_bytes(), h, w)
        assert got is not None
        for g, x in zip(got, want):
            _equal(g, x)
    got = tn.decode_jpeg_files_yuv420(paths, h, w, n_threads=3)
    want = jn.decode_jpeg_files_yuv420(paths, h, w, n_threads=3)
    assert got[0].shape == (4, h, w) and got[1].shape == (4, h // 2, w // 2)
    for g, x in zip(got, want):
        _equal(g, x)
    if h % 16:   # the last luma rows are libjpeg's own (PIL's YCbCr draft)
        from PIL import Image

        with Image.open(paths[0]) as img:
            img.draft("YCbCr", img.size)
            _equal(got[0][0], np.asarray(img.convert("YCbCr"))[..., 0])


def test_non_420_gives_none_and_fails_in_a_batch(tmp_path):
    (p444,) = _jpegs(tmp_path, 1, subsampling=0)
    assert tn.decode_jpeg_bytes_yuv420(p444.read_bytes(), H, W) is None
    assert jn.decode_jpeg_bytes_yuv420(p444.read_bytes(), H, W) is None
    (p420,) = _jpegs(tmp_path, 1, seed=2)
    assert tn.decode_jpeg_bytes_yuv420(p420.read_bytes(), H // 2, W) is None   # another size
    for mod in (tn, jn):
        with pytest.raises(ValueError, match="1 files"):
            mod.decode_jpeg_files_yuv420([p420, p444], H, W)


def test_corrupt_raises(tmp_path):
    junk = b"not a jpeg at all" * 10
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(junk)
    (good,) = _jpegs(tmp_path, 1)
    for mod in (tn, jn):
        with pytest.raises(ValueError):
            mod.decode_jpeg_bytes(junk, H, W)
        with pytest.raises(ValueError):
            mod.decode_jpeg_bytes_yuv420(junk, H, W)
        with pytest.raises(ValueError, match="1 files"):
            mod.decode_jpeg_files([good, bad], H, W)
        with pytest.raises(ValueError):
            mod.decode_jpeg_files_yuv420([tmp_path / "absent.jpg"], H, W)


def test_pil_path_without_the_decoder(tmp_path, monkeypatch):
    """Without the decoder, RGB decodes take PIL (as JAX's do) and the
    plane functions cannot run."""
    paths = _jpegs(tmp_path, 2, 48, 80)
    want = [jn._pil_decode_bytes(p.read_bytes(), H, W) for p in paths]
    monkeypatch.setattr(tn, "load_library", lambda: None)
    assert not tn.native_available()
    _equal(tn.decode_jpeg_bytes(paths[0].read_bytes(), H, W), want[0])
    _equal(tn.decode_jpeg_files(paths, H, W), np.stack(want))
    assert tn.decode_jpeg_bytes_yuv420(paths[0].read_bytes(), H, W) is None
    with pytest.raises(RuntimeError, match="unavailable"):
        tn.decode_jpeg_files_yuv420(paths, H, W)
