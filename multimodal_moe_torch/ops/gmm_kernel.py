"""Grouped matrix multiplication for the dropless MoE: the CUDA kernels
``csrc/gmm.cu`` (``gmm`` and ``tgmm``), their wrappers and launch counts,
their plain versions and the autograd function around them.

Counterpart of megablox ``gmm``/``tgmm`` with megablox's VJP
(``jax.experimental.pallas.ops.tpu.megablox.ops``), called by
``multimodal_moe_tpu/models/moe.py:moe_apply_gmm``. The rows of ``lhs`` are
sorted by group: group ``g`` owns the ``group_sizes[g]`` rows after those
of the groups before it.

* ``gmm(lhs (M, K), rhs (E, K, N), group_sizes (E,))`` → ``(M, N)``: each
  group's rows times ``rhs[g]`` (``rhs[g]ᵀ`` with ``transpose_rhs``, rhs
  ``(E, N, K)``); rows past the last group are zeros.
* ``tgmm(lhs (M, K), rhs (M, N), group_sizes)`` → ``(E, K, N)``:
  ``lhs[seg_g]ᵀ · rhs[seg_g]``, zeros for an empty group. (megablox's
  ``tgmm`` takes ``lhs`` already transposed.)

Inputs float32 or bfloat16, sums and outputs float32 (megablox's
``preferred_element_type``). A CUDA tensor launches the kernel, a CPU
tensor takes the plain version; there is no fallback from one to the other.
The wrappers never read the group sizes on the host.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernels in this process (the plain versions do not
# count): gmm counts the forward and the transposed products, tgmm the
# weight gradients.
gmm_launches = 0
tgmm_launches = 0

MAX_GROUPS = 1024  # the kernels keep the group offsets in shared memory
_TILE = 128        # output tile edge of both kernels
_STAGE = 32        # reduction elements a stage of the kernels' tile loop
# Sums shorter than this run the kernels' exact SIMT float32 path instead of
# the split-TF32 tensor-core product (csrc/gmm.cu: kShortReduction): gmm's K,
# tgmm's whole segment length. The split leaves ~3·2⁻²²·Σ|ab| per element,
# inside 2·n·u·Σ|ab| (u = 2⁻²⁴) from n = 12 on.
SHORT_REDUCTION = 16
# tgmm: enough (group, chunk) work items times output tiles to give every
# SM of the card a few blocks (8: tools/tgmm_chunk_sweep.py).
_BLOCKS_PER_SM = 8


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
              transpose_rhs: bool = False) -> torch.Tensor:
    """``gmm`` in plain PyTorch: a loop over the groups with ``torch.mm`` in
    float32 (reads the sizes on the host)."""
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros((m, n), dtype=torch.float32, device=lhs.device)
    off = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size > 0:
            w = rhs[g].float()
            out[off:off + size] = lhs[off:off + size].float() @ (w.T if transpose_rhs else w)
        off += size
    return out


def tgmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``tgmm`` in plain PyTorch: ``lhs[seg]ᵀ · rhs[seg]`` per group in
    float32, zeros for an empty group."""
    e = group_sizes.shape[0]
    out = torch.zeros((e, lhs.shape[1], rhs.shape[1]), dtype=torch.float32, device=lhs.device)
    off = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size > 0:
            out[g] = lhs[off:off + size].float().T @ rhs[off:off + size].float()
        off += size
    return out


def _lib():
    from .._build import load

    lib = load("gmm")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gmm_launch.argtypes = [ptr, i32, ptr, i32, ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.tgmm_launch.argtypes = [ptr, i32, ptr, i32, ptr, ptr, ptr, i64, i32, i32, i32, i64, i32,
                                ptr]
    lib.gmm_launch.restype = lib.tgmm_launch.restype = ctypes.c_int
    return lib


def _check(lhs, rhs, group_sizes, rhs_dims: int) -> None:
    if lhs.dim() != 2 or rhs.dim() != rhs_dims:
        raise ValueError(f"lhs must be 2-D and rhs {rhs_dims}-D, got {tuple(lhs.shape)} and "
                         f"{tuple(rhs.shape)}")
    if group_sizes.dim() != 1 or group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be a 1-D int32 tensor, got {group_sizes.dtype} "
                        f"{tuple(group_sizes.shape)}")
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    for name, t in (("rhs", rhs), ("group_sizes", group_sizes)):
        if t.device != lhs.device:
            raise ValueError(f"{name} is on {t.device}, lhs on {lhs.device}")


def _check_kernel_inputs(tensors: dict, k: int, n: int, e: int) -> None:
    if k % 4 or n % 4:
        raise ValueError(f"the kernel reads 4 elements at a time: K={k} and N={n} must be "
                         "multiples of 4")
    if e > MAX_GROUPS:
        raise ValueError(f"the kernel takes at most {MAX_GROUPS} groups, got {e}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "group_sizes" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {err}")


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        transpose_rhs: bool = False) -> torch.Tensor:
    """lhs ``(M, K)``, rhs ``(E, K, N)`` (``(E, N, K)`` with
    ``transpose_rhs``), group_sizes ``(E,)`` int32 → ``(M, N)`` float32."""
    _check(lhs, rhs, group_sizes, 3)
    k_rhs = rhs.shape[2] if transpose_rhs else rhs.shape[1]
    if lhs.shape[1] != k_rhs or group_sizes.shape[0] != rhs.shape[0]:
        raise ValueError(f"shapes do not match: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}, transpose_rhs={transpose_rhs}")
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes, transpose_rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"unsupported device {lhs.device}")
    m, k = lhs.shape
    e = rhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.empty((m, n), dtype=torch.float32, device=lhs.device)
    if m == 0:
        return out
    _check_kernel_inputs({"lhs": lhs, "rhs": rhs, "group_sizes": group_sizes, "out": out},
                         k, n, e)
    lib = _lib()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        _launch(lib.gmm_launch, lhs.data_ptr(), int(lhs.dtype == torch.bfloat16), rhs.data_ptr(),
                int(rhs.dtype == torch.bfloat16), group_sizes.data_ptr(), out.data_ptr(), m, k, n,
                e, int(transpose_rhs), stream)
    global gmm_launches
    gmm_launches += 1
    return out


def tgmm_rows_per_chunk(m: int, k: int, n: int, num_sms: int) -> int:
    """Rows a tgmm work item sums: the segments are cut so that work items
    × output tiles give each SM ``_BLOCKS_PER_SM`` blocks, in steps of 32
    rows (a stage of the kernel's tile loop)."""
    tiles = -(-k // _TILE) * -(-n // _TILE)
    chunks = max(1, -(-_BLOCKS_PER_SM * num_sms // tiles))
    rows = -(-m // chunks)
    return max(_STAGE, -(-rows // _STAGE) * _STAGE)


def tgmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs ``(M, K)``, rhs ``(M, N)``, group_sizes ``(E,)`` int32 → ``(E, K,
    N)`` float32: ``lhs[seg_g]ᵀ · rhs[seg_g]`` per group."""
    _check(lhs, rhs, group_sizes, 2)
    if lhs.shape[0] != rhs.shape[0]:
        raise ValueError(f"lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} differ in rows")
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"unsupported device {lhs.device}")
    (m, k), n, e = lhs.shape, rhs.shape[1], group_sizes.shape[0]
    out = torch.empty((e, k, n), dtype=torch.float32, device=lhs.device)
    if m == 0:
        return out.zero_()
    num_sms = torch.cuda.get_device_properties(lhs.device).multi_processor_count
    rows = tgmm_rows_per_chunk(m, k, n, num_sms)
    work = -(-m // rows) + e
    partial = torch.empty((work, k, n), dtype=torch.float32, device=lhs.device)
    _check_kernel_inputs({"lhs": lhs, "rhs": rhs, "group_sizes": group_sizes, "out": out,
                          "partial": partial}, k, n, e)
    lib = _lib()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        _launch(lib.tgmm_launch, lhs.data_ptr(), int(lhs.dtype == torch.bfloat16), rhs.data_ptr(),
                int(rhs.dtype == torch.bfloat16), group_sizes.data_ptr(), partial.data_ptr(),
                out.data_ptr(), m, k, n, e, rows, work, stream)
    global tgmm_launches
    tgmm_launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    """``gmm`` forward; the backward is megablox's ``_gmm_bwd``: ``grad_lhs
    = gmm(grad, rhs, transpose_rhs=not transpose_rhs)``, ``grad_rhs =
    tgmm(lhs, grad)`` (transposed back for a transposed rhs), cast to the
    input types. ``group_sizes`` gets no gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, transpose_rhs):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        return gmm(lhs, rhs, group_sizes, transpose_rhs)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.contiguous()
        grad_lhs = grad_rhs = None
        if ctx.needs_input_grad[0]:
            grad_lhs = gmm(grad, rhs, group_sizes, not ctx.transpose_rhs).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            grad_rhs = tgmm(lhs, grad, group_sizes)
            if ctx.transpose_rhs:
                grad_rhs = grad_rhs.transpose(1, 2)
            grad_rhs = grad_rhs.to(rhs.dtype)
        return grad_lhs, grad_rhs, None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                   transpose_rhs: bool = False) -> torch.Tensor:
    """Differentiable ``gmm`` (megablox ``ops.gmm`` with its VJP)."""
    return _GroupedMatmul.apply(lhs, rhs, group_sizes, transpose_rhs)
