"""int8 × int8 → int32 convolution for the int8 serving path.

Counterpart of the JAX package's ``lax.conv_general_dilated(...,
preferred_element_type=jnp.int32)`` (``models/layers.py``, ``models/yolo.py``,
``models/resnet.py``): not a Pallas kernel there, so not a kernel port here.
The product is one ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM on the
card) over an im2col of the int8 codes:

* NCHW codes, OIHW weights, symmetric zero padding, ``groups == 1``; the
  result is int32 ``(B, O, Ho, Wo)`` with channels-last strides (the GEMM's
  row-major ``(B·Ho·Wo, O)`` output, permuted), which the next im2col reads
  without a copy.
* ``torch._int_mm`` on CUDA wants more than 16 rows and K and N multiples of 8:
  K (= k·k·C) and N (= O) are zero-padded to multiples of 8 and M to 32 when it
  is 16 or less. Zero codes add nothing, so the padding is exact.
* The im2col buffer is built batch chunk by batch chunk under
  ``IM2COL_BUDGET_BYTES``: at YOLO-s B=128 704×1248 the /4 level's buffer alone
  is 128·176·312·576 B ≈ 4.0 GB.

:func:`int8_conv2d_plain` is the exact float64 ``F.conv2d`` of the same codes
(|Σ| ≤ 127²·k·k·C ≪ 2⁵³); only the tests and ``chip_smoke.py`` call it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IM2COL_BUDGET_BYTES = 1 << 30


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def gemm_weight(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 weights → the GEMM's ``(Kp, Np)`` operand, column-major:
    K ordered (dy, dx, c) as :func:`im2col` orders it, K and N zero-padded
    to multiples of 8."""
    o, c, kh, kw = w_q.shape
    k = kh * kw * c
    w = torch.zeros((_round_up(o, 8), _round_up(k, 8)), dtype=torch.int8, device=w_q.device)
    w[:o, :k] = w_q.permute(0, 2, 3, 1).reshape(o, k)
    return w.t()


def im2col(x_nhwc: torch.Tensor, k: int, stride: int, padding: int, kp: int) -> torch.Tensor:
    """``(B, H, W, C)`` int8 → ``(B·Ho·Wo, kp)`` patches, columns (dy, dx, c),
    columns past k·k·C zero: one strided view of the padded input, copied
    once."""
    b, h, w, c = x_nhwc.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if padding:
        x_nhwc = F.pad(x_nhwc, (0, 0, padding, padding, padding, padding))
    sb, sh, sw, sc = x_nhwc.stride()
    patches = x_nhwc.as_strided((b, ho, wo, k, k, c), (sb, stride * sh, stride * sw, sh, sw, sc))
    cols = patches.reshape(b * ho * wo, k * k * c)
    return F.pad(cols, (0, kp - k * k * c)) if kp != k * k * c else cols


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) @ (K, N)`` int8 → int32 by ``torch._int_mm``, with M padded to
    32 rows where it is 16 or less (K and N must already be multiples of 8)."""
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, a.shape[1]))])
    return torch._int_mm(a, b)[:m]


def int8_conv2d(q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """int8 NCHW ``q`` ⊛ int8 OIHW ``w_q`` → exact int32 ``(B, O, Ho, Wo)``."""
    if q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 codes and weights, got {q.dtype}, {w_q.dtype}")
    b, c, h, w = q.shape
    o, cw, kh, kw = w_q.shape
    if cw != c or kh != kw:
        raise ValueError(f"weights {tuple(w_q.shape)} do not fit input {tuple(q.shape)}")
    w_gemm = gemm_weight(w_q)
    kp = w_gemm.shape[0]
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    x = q.permute(0, 2, 3, 1).contiguous()
    per_image = max(ho * wo * kp, h * w * c)
    chunk = max(1, min(b, IM2COL_BUDGET_BYTES // per_image))
    out = torch.empty((b, ho, wo, o), dtype=torch.int32, device=q.device)
    for s in range(0, b, chunk):
        cols = im2col(x[s:s + chunk], kh, stride, padding, kp)
        y = int_mm(cols, w_gemm)
        out[s:s + chunk] = y[:, :o].reshape(-1, ho, wo, o)
    return out.permute(0, 3, 1, 2)


def int8_conv2d_plain(q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                      padding: int = 0) -> torch.Tensor:
    """The same convolution as a float64 ``F.conv2d``: exact, as every
    partial sum is an integer below 2⁵³."""
    y = F.conv2d(q.double(), w_q.double(), stride=stride, padding=padding)
    return y.to(torch.int32)
