"""PyTorch port of ops/moe_kernels.py against the JAX module (CPU).

The problems are those of tests/test_moe_kernels.py (E=4, C=512, d=64,
h=128, weights scaled by 0.05). The plain version ``_ffn_plain`` against
``_ffn_xla`` and the Pallas kernel in interpret mode: atol 1e-4 (the JAX
test's own). In bfloat16, against the Pallas kernel on the same bf16 values:
within ``ffn_tolerance`` (one bf16 ulp of the hidden tile carried through
W2, plus one ulp of the output). Gradients of ``fused_expert_ffn``: atol
1e-5 of JAX's. On CPU tensors the wrapper ``moe_ffn_fwd`` is the plain
version exactly; the kernel itself runs only on the card (``-m cuda``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import require_cuda
from multimodal_moe_torch.ops import moe_kernels as tk
from multimodal_moe_tpu.ops import moe_kernels as jk

E, C, D, H = 4, jk.TILE * 2, 64, 128


def _inputs(seed=0, e=E, c=C, d=D, h=H):
    rng = np.random.default_rng(seed)
    buf = rng.normal(size=(e * c, d)).astype(np.float32)
    w1 = (rng.normal(size=(e, d, h)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(e, 1, h)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(e, h, d)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(e, 1, d)) * 0.05).astype(np.float32)
    return buf, w1, b1, w2, b2


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def test_tile_and_capacity_rounding_match_jax():
    assert tk.TILE == jk.TILE == 256
    for cap, want in ((1, 256), (256, 256), (257, 512), (68640, 68864)):
        assert tk.round_up_capacity(cap) == jk.round_up_capacity(cap) == want


def test_plain_matches_xla_and_pallas():
    a = _inputs()
    got = tk._ffn_plain(*_torch(a), C).numpy()
    j = [jnp.asarray(x) for x in a]
    np.testing.assert_allclose(got, np.asarray(jk._ffn_xla(*j, capacity=C)), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jk.fused_expert_ffn(*j, C, True)), atol=1e-4,
                               rtol=0)


def test_plain_bf16_matches_pallas_within_bound():
    """bf16 buffer and bf16-valued weights: the Pallas kernel sums the exact
    products in float32 and rounds the hidden tile and the output once, as
    the port does."""
    bf = [t.numpy() for t in (x.to(torch.bfloat16).float() for x in _torch(_inputs(1)))]
    j = [jnp.asarray(bf[0], jnp.bfloat16)] + [jnp.asarray(x) for x in bf[1:]]
    ref = np.asarray(jk.fused_expert_ffn(*j, C, True).astype(jnp.float32))
    args = _torch(bf, torch.bfloat16)
    got = tk._ffn_plain(*args, C)
    assert got.dtype == torch.bfloat16
    tol = tk.ffn_tolerance(*args, C, got).numpy()
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= tol).all(), float((diff - tol).max())
    assert float(np.abs(ref).max()) > 0.1


def test_expert_weight_selection():
    # Zero all experts but #2; only rows [2C, 3C) may be non-zero.
    buf, w1, b1, w2, b2 = _torch(_inputs(1))
    w1[[0, 1, 3]] = 0.0
    b1.zero_()
    b2.zero_()
    out = tk.fused_expert_ffn(buf, w1, b1, w2, b2, C)
    assert out[2 * C : 3 * C].abs().sum() > 0
    assert out[: 2 * C].abs().max() == 0 and out[3 * C :].abs().max() == 0
    ref = jk.fused_expert_ffn(*(jnp.asarray(t.numpy()) for t in (buf, w1, b1, w2, b2)), C, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_gradients_match_jax():
    a = _inputs(2)
    args = [t.requires_grad_() for t in _torch(a)]
    (tk.fused_expert_ffn(*args, C) ** 2).mean().backward()

    def loss(*xs):
        return (jk.fused_expert_ffn(*xs, C, True) ** 2).mean()

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x) for x in a))
    for name, t, r in zip(("buf", "w1", "b1", "w2", "b2"), args, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    args = _torch(_inputs(3), dtype)
    before = tk.moe_ffn_fwd_launches
    got = tk.moe_ffn_fwd(*args, C)
    assert got.dtype == dtype and got.shape == (E * C, D)
    assert torch.equal(got, tk._ffn_plain(*args, C))
    assert tk.moe_ffn_fwd_launches == before  # the plain version is no launch


def test_wrapper_rejects_bad_inputs():
    buf, w1, b1, w2, b2 = _torch(_inputs(4))
    with pytest.raises(TypeError, match="all bfloat16"):
        tk.moe_ffn_fwd(buf, w1.bfloat16(), b1, w2, b2, C)
    with pytest.raises(TypeError, match="float32 or all"):
        tk.moe_ffn_fwd(*(t.double() for t in (buf, w1, b1, w2, b2)), C)
    with pytest.raises(ValueError, match="buf must be"):
        tk.moe_ffn_fwd(buf[:-256], w1, b1, w2, b2, C)
    with pytest.raises(ValueError, match="b1 must be"):
        tk.moe_ffn_fwd(buf, w1, b1[:, 0], w2, b2, C)
    with pytest.raises(ValueError, match="w2 must be"):
        tk.moe_ffn_fwd(buf, w1, b1, w2[:, :, :-16], b2, C)
    with pytest.raises(ValueError, match="multiple of 256"):
        tk.moe_ffn_fwd(buf[: E * 200], w1, b1, w2, b2, 200)
    with pytest.raises(ValueError, match="multiples of 16"):
        a = _torch(_inputs(5, c=256, d=24, h=48))
        tk.moe_ffn_fwd(*a, 256)
    with pytest.raises(ValueError, match="too wide"):
        a = _torch(_inputs(6, e=1, c=256, d=1024, h=32))
        tk.moe_ffn_fwd(*a, 256)
    with pytest.raises(ValueError, match="contiguous"):
        tk.moe_ffn_fwd(buf, w1.transpose(1, 2).contiguous().transpose(1, 2), b1, w2, b2, C)


VARIANT_WIDTHS = (64, 128, 192, 256, 384, 512, 576)  # MoE-YOLO n/s/m/l neck widths


def test_shared_memory_budget():
    # MoE-YOLO widths of all four variants fit a Hopper block (227 KB).
    for d in VARIANT_WIDTHS:
        assert tk.bf16_smem_bytes(d) <= tk.MAX_SMEM_BYTES
    assert tk.bf16_smem_bytes(512) == 188416
    assert tk.bf16_smem_bytes(704) > tk.MAX_SMEM_BYTES


def _kernel_source() -> str:
    return (Path(tk.__file__).resolve().parents[1] / "csrc" / "moe_ffn_fwd.cu").read_text()


@pytest.mark.parametrize("d", VARIANT_WIDTHS)
def test_shared_memory_formula_is_the_kernel_source(d):
    """``bf16_smem_bytes`` mirrors the kernel's: its tile constants, and the
    expression of the source's own ``bf16_smem_bytes`` evaluated here."""
    src = _kernel_source()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kBM"], consts["kT"], consts["kPadH"], consts["kStages"]) == \
        (tk._BM, tk._T, tk._PAD, tk._STAGES)
    body = re.search(r"size_t bf16_smem_bytes\(int d\) \{\s*return (.*?);\s*\}", src, re.S)
    expr = body.group(1).replace("(size_t)", "")
    assert eval(expr, {"__builtins__": {}}, {**consts, "d": d}) == tk.bf16_smem_bytes(d)


# --------------------------------------------------------------------------
# On the card: the kernel against its plain version
# --------------------------------------------------------------------------

CUDA_CASES = {
    "f32_test_shape": (torch.float32, 4, 512, 64, 128),
    "f32_level2_width": (torch.float32, 2, 256, 512, 1024),
    "bf16_level0": (torch.bfloat16, 4, 512, 128, 256),
    "bf16_level1": (torch.bfloat16, 4, 256, 256, 512),
    "bf16_level2": (torch.bfloat16, 4, 256, 512, 1024),
    "bf16_partial_tiles": (torch.bfloat16, 3, 256, 192, 80),   # d % 128, h % 64 != 0
    "bf16_widest_576": (torch.bfloat16, 2, 256, 576, 1152),    # a 64-column block of 3
    "bf16_d64": (torch.bfloat16, 4, 512, 64, 128),             # one W1 tile a chunk
    "bf16_one_expert": (torch.bfloat16, 1, 256, 256, 512),     # one capacity tile, 2 blocks
    "bf16_d80_h48": (torch.bfloat16, 2, 256, 80, 48),          # partial k, chunk and W2 tiles
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_kernel_matches_plain(case):
    dev = require_cuda()
    dtype, e, c, d, h = CUDA_CASES[case]
    buf, w1, b1, w2, b2 = (t.to(dev) for t in _torch(_inputs(7, e, c, d, h), dtype))
    buf[c - 40 : c] = 0          # rows no token filled: silu(b1)·W2 + b2
    if e > 1:
        w1[e - 1] = 0            # an expert that maps everything to its biases
    before = tk.moe_ffn_fwd_launches
    got = tk.moe_ffn_fwd(buf, w1, b1, w2, b2, c)
    torch.cuda.synchronize()
    assert tk.moe_ffn_fwd_launches == before + 1
    ref = tk._ffn_plain(buf, w1, b1, w2, b2, c)
    tol = tk.ffn_tolerance(buf, w1, b1, w2, b2, c, ref)
    assert torch.isfinite(got).all()
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
