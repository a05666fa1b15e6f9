"""The port's ``ops/preprocess.py`` against the JAX package's (CPU).

The uint8 conversion ``yuv420_to_rgb_u8`` is compared bitwise over every
(Y, Cb, Cr) triple there is: 16.7 M pixels, 64 images of 512×512 whose
2×2 chroma blocks each carry one (Cb, Cr) pair and four Y values. No pixel
differs. The float results may differ in their last bits: XLA on the CPU
may contract ``yf - 0.344136*cbf - 0.714136*crf`` into multiply-adds, which
PyTorch does not; they are held within 1e-4 of 255 (three float32 ulps at
255) and 1e-6 after the division by 255.
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_moe_torch.ops import preprocess as tp
from multimodal_moe_tpu.ops import preprocess as jp


def _planes(b=3, h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, h, w), dtype=np.uint8),
            rng.integers(0, 256, (b, h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (b, h // 2, w // 2), dtype=np.uint8))


def _torch(fn, *planes):
    return fn(*(torch.from_numpy(np.ascontiguousarray(p)) for p in planes)).numpy()


def test_rgb_u8_bitwise_over_every_yuv_triple():
    c = np.arange(256, dtype=np.uint8)
    cb = np.broadcast_to(c[:, None], (16, 256, 256))
    cr = np.broadcast_to(c[None, :], (16, 256, 256))
    to_u8 = jax.jit(jp.yuv420_to_rgb_u8)
    for b0 in range(0, 64, 16):
        # image b, 2x2 block: Y = 4b + {0, 1, 2, 3}, so the 64 images cover 0..255
        ys = 4 * np.arange(b0, b0 + 16)[:, None, None] + np.array([[0, 1], [2, 3]])
        y = np.tile(ys, (1, 256, 256)).astype(np.uint8)
        ref = np.asarray(to_u8(y, cb, cr))
        got = _torch(tp.yuv420_to_rgb_u8, y, cb, cr)
        assert got.dtype == np.uint8 and got.shape == (16, 512, 512, 3)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,atol", [("yuv420_to_rgb", 1e-4), ("yuv420_to_model_input", 1e-6)])
def test_float_conversions(name, atol):
    planes = _planes()
    ref = np.asarray(jax.jit(getattr(jp, name))(*planes))
    got = _torch(getattr(tp, name), *planes)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (3, 64, 96, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert got.min() >= 0.0 and got.max() <= (255.0 if name == "yuv420_to_rgb" else 1.0)


def test_upsample_and_normalisers():
    y, cb, _ = _planes(seed=1)
    np.testing.assert_array_equal(_torch(tp.upsample2x_nearest, cb),
                                  np.asarray(jp.upsample2x_nearest(cb)))
    images = np.random.default_rng(2).integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_torch(tp.normalize_images_u8, images),
                                  np.asarray(jp.normalize_images_u8(images)))
    x = images.astype(np.float32) / 255.0
    np.testing.assert_allclose(_torch(tp.imagenet_normalize, x),
                               np.asarray(jp.imagenet_normalize(x)), rtol=0, atol=1e-6)
