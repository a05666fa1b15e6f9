"""Fused expert FFN over the MoE capacity buffer: the CUDA kernel
``csrc/moe_ffn_fwd.cu``, its wrapper, its launch count, its plain version
and the autograd function around them.

Counterpart of ``multimodal_moe_tpu/ops/moe_kernels.py``. After dispatch,
expert inputs live in a capacity buffer ``(E·C, d)``; expert e owns rows
``[e·C, (e+1)·C)`` and C is a multiple of ``TILE``. The kernel computes
``silu(x·W1[e] + b1[e])·W2[e] + b2[e]`` with the hidden activations kept in
shared memory. A CUDA tensor launches the kernel; a CPU tensor takes the
plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

TILE = 256  # capacity is rounded up to a multiple of this on the fused route

# Launches of the CUDA kernel in this process (the plain version does not count).
moe_ffn_fwd_launches = 0

# The bf16 kernel's shared memory (csrc/moe_ffn_fwd.cu, ``bf16_smem_bytes``)
# fits a Hopper block up to this width; the wrapper refuses wider on every
# device, so that both versions accept the same inputs.
MAX_SMEM_BYTES = 232448
# The kernel's kBM (token rows a block), kT (ring tile edge, hidden columns a
# chunk), kPadH (row pad) and kStages (ring depth).
_BM, _T, _PAD, _STAGES = 128, 64, 8, 4


def bf16_smem_bytes(d: int) -> int:
    """x tile, hidden chunk and the ring of weight tiles, in bf16."""
    return 2 * (_BM * (d + _PAD) + _BM * (_T + _PAD) + _STAGES * _T * (_T + _PAD))


def round_up_capacity(capacity: int) -> int:
    """Round a routing capacity up to the kernel tile size."""
    return -(-capacity // TILE) * TILE


def _ffn_plain(buf, w1, b1, w2, b2, capacity: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (counterpart of ``_ffn_xla``).

    Products are summed in float32, bias and SiLU are applied in float32,
    the hidden activations are rounded once to the buffer's dtype, and the
    output is rounded once: the rounding points of the Pallas kernel
    (``hidden.astype(x.dtype)``). In float32 this is ``_ffn_xla`` exactly."""
    e = w1.shape[0]
    x = buf.reshape(e, capacity, -1).float()
    hidden = F.silu(torch.bmm(x, w1.float()) + b1.float()).to(buf.dtype)
    out = torch.bmm(hidden.float(), w2.float()) + b2.float()
    return out.to(buf.dtype).reshape(e * capacity, -1)


def ffn_tolerance(buf, w1, b1, w2, b2, capacity: int, ref: torch.Tensor) -> torch.Tensor:
    """Bound on ``|kernel − _ffn_plain|``, broadcastable to the output.

    float32: ``1e-4·max(1, max|ref|)`` (the two sum over d and h in other
    orders). bfloat16: both sum exact bf16 products in float32, so their
    hidden values differ before rounding only by summation order, and after
    it by at most one bf16 ulp (≤ 2⁻⁷·|hidden|) where a rounding boundary
    falls between them. Carried through W2 that is ``2⁻⁷·(|hidden|·|W2|)``
    per output; the output's own rounding adds one ulp, ``2⁻⁷·|ref|``."""
    if buf.dtype == torch.float32:
        return torch.tensor(1e-4 * max(1.0, float(ref.abs().max())), device=ref.device)
    e = w1.shape[0]
    x = buf.reshape(e, capacity, -1).float()
    hidden = F.silu(torch.bmm(x, w1.float()) + b1.float()).to(buf.dtype).float()
    carried = torch.bmm(hidden.abs(), w2.float().abs()).reshape(e * capacity, -1)
    return 2.0 ** -7 * (carried + ref.float().abs()) + 1e-6


def _lib():
    from .._build import load

    lib = load("moe_ffn_fwd")
    lib.moe_ffn_fwd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.moe_ffn_fwd_launch.restype = ctypes.c_int
    return lib


def _check(buf, w1, b1, w2, b2, capacity: int) -> None:
    if buf.dim() != 2 or w1.dim() != 3:
        raise ValueError(f"buf must be (E·C, d) and w1 (E, d, h), got {tuple(buf.shape)} "
                         f"and {tuple(w1.shape)}")
    e, d, h = w1.shape
    shapes = {"buf": (e * capacity, d), "b1": (e, 1, h), "w2": (e, h, d), "b2": (e, 1, d)}
    for name, t in (("buf", buf), ("b1", b1), ("w2", w2), ("b2", b2)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    if capacity <= 0 or capacity % TILE:
        raise ValueError(f"capacity {capacity} is not a positive multiple of {TILE}")
    if d % 16 or h % 16:
        raise ValueError(f"d={d} and h={h} must be multiples of 16")
    if bf16_smem_bytes(d) > MAX_SMEM_BYTES:
        raise ValueError(f"d={d} is too wide for the kernel's shared memory")
    for name, t in (("buf", buf), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != buf.dtype:
            raise TypeError(f"all five tensors must be float32 or all bfloat16; "
                            f"{name} is {t.dtype}, buf {buf.dtype}")
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, buf on {buf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def moe_ffn_fwd(buf, w1, b1, w2, b2, capacity: int) -> torch.Tensor:
    """buf ``(E·C, d)``, w1 ``(E, d, h)``, b1 ``(E, 1, h)``, w2 ``(E, h, d)``,
    b2 ``(E, 1, d)``, all float32 or all bfloat16 → ``(E·C, d)``."""
    _check(buf, w1, b1, w2, b2, capacity)
    if buf.device.type == "cpu":
        return _ffn_plain(buf, w1, b1, w2, b2, capacity)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    e, d, h = w1.shape
    out = torch.empty_like(buf)
    tensors = (buf, w1, b1, w2, b2, out)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel reads and writes 16-byte vectors: every tensor "
                         "must start on a 16-byte boundary")
    lib = _lib()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.moe_ffn_fwd_launch(
            *(t.data_ptr() for t in tensors), buf.shape[0], capacity, e, d, h,
            int(buf.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_ffn_fwd kernel launch failed: cudaError_t {err}")
    global moe_ffn_fwd_launches
    moe_ffn_fwd_launches += 1
    return out


class _FusedExpertFFN(torch.autograd.Function):
    """Kernel forward; the backward recomputes the hidden activations with
    plain matmuls (``_ffn_bwd`` of the JAX module)."""

    @staticmethod
    def forward(ctx, buf, w1, b1, w2, b2, capacity):
        ctx.save_for_backward(buf, w1, b1, w2, b2)
        ctx.capacity = capacity
        return moe_ffn_fwd(buf, w1, b1, w2, b2, capacity)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _ffn_plain(*inputs, ctx.capacity)
        grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def fused_expert_ffn(buf, w1, b1, w2, b2, capacity: int) -> torch.Tensor:
    """Fused expert FFN over the capacity buffer (kernel forward, plain
    backward). Args: buf (E·C, d); w1 (E, d, h); b1 (E, 1, h); w2 (E, h, d);
    b2 (E, 1, d)."""
    return _FusedExpertFFN.apply(buf, w1, b1, w2, b2, capacity)
