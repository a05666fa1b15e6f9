"""Fused MoE expert sweep: the CUDA kernel ``csrc/moe_sweep_fwd.cu``, its
wrapper, its launch count and its plain version.

One call computes a whole MoE level's dropless sweep with its residual,

    out = tokens + Σ_e g[t, e] · (silu(tokens·W1[e] + b1[e])·W2[e] + b2[e]),

where ``g`` is the ``(T, E)`` gate matrix of the top-k routing (the
renormalised gates of the selected experts, 0 elsewhere). It is
``tokens + models.moe.moe_apply_sweep(...)`` with other rounding points: the
products are summed in float32, bias, SiLU and gate are applied in float32,
the gated hidden value is rounded once to the tokens' dtype, and the output
once. The kernel keeps the hidden activations and the per-expert outputs on
the SM; it replaces no Pallas kernel (the JAX sweep is XLA's matmuls).

A CUDA tensor launches the kernel (bfloat16 only); a CPU tensor takes the
plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel in this process (the plain version does not count).
moe_sweep_fwd_launches = 0

MAX_K = 4  # top-k the kernel takes
# The kernel's constants (csrc/moe_sweep_fwd.cu): 64-column slabs, 128-row
# x tiles, 32 KB ring stages, at most 8 of them, shared memory of one block.
_SLAB, _BM, _STAGE_BYTES, _MAX_STAGES, _ALIGN, MAX_SMEM_BYTES = 64, 128, 32768, 8, 1024, 232448


def sweep_stages(d: int) -> int:
    """Ring stages the kernel keeps beside a ``128 × d`` x tile; 0 where
    ``d`` is no positive multiple of 64 or the ring cannot hold one block's
    stages (a W2 stage and ``ceil(d / 256)`` W1 stages): d ≤ 512."""
    if d < _SLAB or d % _SLAB:
        return 0
    free = MAX_SMEM_BYTES - _ALIGN - 8 * (2 * _MAX_STAGES + 2) - (d // _SLAB) * _BM * 128
    s = min(free // _STAGE_BYTES, _MAX_STAGES)
    return s if s >= 1 + -(-d // (4 * _SLAB)) else 0


def _gated_hidden(tokens, expert_idx, gates, w1, b1):
    """The ``(T, E)`` gate matrix (``models.moe.gate_matrix``) and, per
    expert, its gated hidden activations rounded to the tokens' dtype."""
    e = w1.shape[0]
    comb = torch.zeros((tokens.shape[0], e), dtype=torch.float32, device=tokens.device)
    comb.scatter_add_(1, expert_idx, gates.float())
    x = tokens.float()
    hidden = [(F.silu(x @ w1[i].float() + b1[i].float()) * comb[:, i:i + 1]).to(tokens.dtype)
              for i in range(e)]
    return comb, hidden


def _sweep_plain(tokens, expert_idx, gates, w1, b1, w2, b2) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points.

    In float32 this is ``tokens + moe_apply_sweep(...)`` up to the order of
    the float32 sums."""
    comb, hidden = _gated_hidden(tokens, expert_idx, gates, w1, b1)
    acc = tokens.float() + comb @ b2[:, 0].float()
    for i, hid in enumerate(hidden):
        acc = acc + hid.float() @ w2[i].float()
    return acc.to(tokens.dtype)


def sweep_tolerance(tokens, expert_idx, gates, w1, b1, w2, b2, ref) -> torch.Tensor:
    """Bound on ``|kernel − _sweep_plain|``, broadcastable to the output.

    float32: ``1e-4·max(1, max|ref|)``. bfloat16: the two sum exact bf16
    products in float32 in other orders, and the kernel's SiLU is within
    ~1e-6 of the exact one, so a gated hidden value differs before its
    rounding by far less than its ulp, and after it by at most one bf16 ulp
    (≤ 2⁻⁷·|hidden|) where a rounding boundary falls between the two. Carried
    through W2 that is ``2⁻⁷·Σ_e |hidden_e|·|W2_e|`` per output; the output's
    own rounding adds one ulp, ``2⁻⁷·|ref|``, and the float32 sums' order
    ``2⁻¹⁶·(|x| + Σ_e g·|b2_e|)``."""
    if tokens.dtype == torch.float32:
        return torch.tensor(1e-4 * max(1.0, float(ref.abs().max())), device=ref.device)
    comb, hidden = _gated_hidden(tokens, expert_idx, gates, w1, b1)
    carried = sum(hid.float().abs() @ w2[i].float().abs() for i, hid in enumerate(hidden))
    sums = tokens.float().abs() + comb @ b2[:, 0].float().abs()
    return 2.0 ** -7 * (carried + ref.float().abs()) + 2.0 ** -16 * sums + 1e-6


def _lib():
    from .._build import load

    lib = load("moe_sweep_fwd")
    lib.moe_sweep_fwd_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.moe_sweep_fwd_launch.restype = ctypes.c_int
    return lib


def _check(tokens, expert_idx, gates, w1, b1, w2, b2) -> None:
    if tokens.dim() != 2 or w1.dim() != 3 or expert_idx.dim() != 2:
        raise ValueError(f"tokens must be (T, d), expert_idx (T, k) and w1 (E, d, h), got "
                         f"{tuple(tokens.shape)}, {tuple(expert_idx.shape)} and "
                         f"{tuple(w1.shape)}")
    t, d = tokens.shape
    e, _, h = w1.shape
    k = expert_idx.shape[1]
    shapes = {"w1": (e, d, h), "b1": (e, 1, h), "w2": (e, h, d), "b2": (e, 1, d),
              "expert_idx": (t, k), "gates": (t, k)}
    named = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "expert_idx": expert_idx, "gates": gates}
    for name, x in named.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(x.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"top-k {k} is outside 1..{MAX_K}")
    if h % _SLAB:
        raise ValueError(f"h={h} must be a multiple of {_SLAB}")
    if not sweep_stages(d):
        raise ValueError(f"d={d} must be a multiple of {_SLAB} narrow enough for the "
                         f"kernel's shared memory")
    if expert_idx.dtype != torch.int64 or gates.dtype != torch.float32:
        raise TypeError(f"expert_idx must be int64 and gates float32, got {expert_idx.dtype} "
                        f"and {gates.dtype}")
    for name, x in (("tokens", tokens), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if x.dtype not in (torch.float32, torch.bfloat16) or x.dtype != tokens.dtype:
            raise TypeError(f"tokens and the expert weights must be all float32 or all "
                            f"bfloat16; {name} is {x.dtype}, tokens {tokens.dtype}")
    for name, x in (("tokens", tokens), *named.items()):
        if x.device != tokens.device:
            raise ValueError(f"{name} is on {x.device}, tokens on {tokens.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def moe_sweep_fwd(tokens, expert_idx, gates, w1, b1, w2, b2) -> torch.Tensor:
    """``tokens`` (T, d), ``expert_idx`` (T, k) int64 and ``gates`` (T, k)
    float32 of the top-k routing, ``w1`` (E, d, h), ``b1`` (E, 1, h), ``w2``
    (E, h, d), ``b2`` (E, 1, d) → ``tokens`` + the level's sweep, (T, d)."""
    _check(tokens, expert_idx, gates, w1, b1, w2, b2)
    if tokens.device.type == "cpu":
        return _sweep_plain(tokens, expert_idx, gates, w1, b1, w2, b2)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    if tokens.dtype != torch.bfloat16:
        raise TypeError(f"the sweep kernel takes bfloat16, got {tokens.dtype}")
    t, d = tokens.shape
    e, _, h = w1.shape
    if t == 0:
        return tokens.clone()
    # Both B operands K-major: W1 as (E, h, d), W2 as (E, d, h).
    w1t = w1.transpose(1, 2).contiguous()
    w2t = w2.transpose(1, 2).contiguous()
    out = torch.empty_like(tokens)
    tensors = (tokens, expert_idx, gates, w1t, b1, w2t, b2, out)
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("the kernel reads by TMA and in vectors: every tensor must start on "
                         "a 16-byte boundary")
    lib = _lib()
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        err = lib.moe_sweep_fwd_launch(*(x.data_ptr() for x in tensors), t, d, h, e,
                                       expert_idx.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"moe_sweep_fwd kernel launch failed: cudaError_t {err}")
    global moe_sweep_fwd_launches
    moe_sweep_fwd_launches += 1
    return out
