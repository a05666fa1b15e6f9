"""The fused MoE sweep (``ops/moe_sweep.py``, ``csrc/moe_sweep_fwd.cu``).

On the CPU: the plain version ``_sweep_plain`` against ``tokens +
models.moe.moe_apply_sweep`` in float32 (atol 2e-5: the same function with
the float32 sums in another order) at the MoE-YOLO-s widths, on routings with
tied probabilities and a 128-row tile that gives one expert no token; in
bfloat16 against the float32 plain version within ``sweep_tolerance``; the
wrapper on CPU tensors is the plain version exactly; its input checks; the
path choice of ``MoEFFN``. On the card (``-m cuda``): the kernel against the
plain version within ``sweep_tolerance`` at the three levels of a B = 8
704×1248 frame, bit-identical repeats, and the launch count of MoE-YOLO-s
forwards. No JAX here: the card's tests run where it is absent.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import require_cuda
from multimodal_moe_torch.models import moe as tm
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector
from multimodal_moe_torch.ops import moe_sweep as ms

E, K = 4, 2
T = 300  # three 128-row tiles, the last one ragged
QUIET = slice(128, 256)  # the tile where expert 3 has no token


def _problem(d, h=None, t=T, seed=0, dtype=torch.float32, quiet=True):
    """Tokens, a top-2 routing and weights. Every fourth token's logits are
    all equal (a four-way tie: experts 0 and 1, gates 0.5), others are rounded
    to halves (ties between two experts); in the ``QUIET`` tile expert 3 is
    never chosen."""
    h = h or 2 * d
    rng = np.random.default_rng(seed)
    logits = np.round(rng.normal(0.0, 1.5, (t, E)) * 2) / 2
    logits[::4] = 0.0
    if quiet:
        logits[QUIET, 3] = -10.0
    idx, gates, _, _ = tm.route_top_k_dropless(torch.from_numpy(logits.astype(np.float32)), k=K)
    arrays = [rng.normal(size=(t, d)), rng.normal(size=(E, d, h)) / np.sqrt(d),
              rng.normal(size=(E, 1, h)) * 0.1, rng.normal(size=(E, h, d)) / np.sqrt(h),
              rng.normal(size=(E, 1, d)) * 0.1]
    x, w1, b1, w2, b2 = (torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays)
    return x, idx.contiguous(), gates, w1, b1, w2, b2


@pytest.mark.parametrize("d", [128, 256, 512])
def test_plain_is_the_sweep_with_its_residual(d):
    x, idx, gates, w1, b1, w2, b2 = _problem(d, seed=d)
    comb = tm.gate_matrix(idx, gates, E)
    assert (comb[QUIET, 3] == 0).all() and (comb[:, 3] > 0).any()
    assert (comb[::4, :2] == 0.5).all()  # the tied tokens
    want = x + tm.moe_apply_sweep(x, idx, gates, w1, b1, w2, b2)
    got = ms._sweep_plain(x, idx, gates, w1, b1, w2, b2)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    assert float(want.abs().max()) > 1.0


def test_quiet_expert_adds_nothing():
    """With expert 3's weights replaced by garbage, the tile where no token
    chose it is unchanged: a zero gate contributes exact zeros."""
    x, idx, gates, w1, b1, w2, b2 = _problem(128, seed=3)
    ref = ms._sweep_plain(x, idx, gates, w1, b1, w2, b2)
    for w in (w1, b1, w2, b2):
        w[3] = 1e3
    got = ms._sweep_plain(x, idx, gates, w1, b1, w2, b2)
    assert torch.equal(got[QUIET], ref[QUIET])
    assert not torch.equal(got, ref)


@pytest.mark.parametrize("d", [128, 256])
def test_bf16_plain_within_tolerance_of_float32(d):
    """The bf16 plain version rounds each gated hidden value and the output
    once (half an ulp each), inside the kernel's bound of one ulp each."""
    args = _problem(d, seed=10 + d, dtype=torch.bfloat16)
    got = ms._sweep_plain(*args)
    assert got.dtype == torch.bfloat16
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    ref = ms._sweep_plain(*f32)
    tol = ms.sweep_tolerance(*args, got)
    diff = (got.float() - ref).abs()
    assert (diff <= tol).all(), float((diff - tol).max())
    assert float(diff.max()) > 0  # the rounding shows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    args = _problem(128, seed=4, dtype=dtype)
    before = ms.moe_sweep_fwd_launches
    got = ms.moe_sweep_fwd(*args)
    assert got.dtype == dtype and got.shape == (T, 128)
    assert torch.equal(got, ms._sweep_plain(*args))
    assert ms.moe_sweep_fwd_launches == before  # the plain version is no launch


def test_wrapper_rejects_bad_inputs():
    x, idx, gates, w1, b1, w2, b2 = _problem(128, seed=5)
    f = ms.moe_sweep_fwd
    with pytest.raises(ValueError, match="tokens must be"):
        f(x[None], idx, gates, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2 must be"):
        f(x, idx, gates, w1, b1, w2[:, :, :64], b2)
    with pytest.raises(ValueError, match="b1 must be"):
        f(x, idx, gates, w1, b1[:, 0], w2, b2)
    with pytest.raises(ValueError, match="gates must be"):
        f(x, idx, gates[:-1], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="top-k 5"):
        f(x, idx.repeat(1, 3)[:, :5].contiguous(), gates.repeat(1, 3)[:, :5].contiguous(),
          w1, b1, w2, b2)
    with pytest.raises(ValueError, match="multiple of 64"):
        a = _problem(96, seed=6)
        f(*a)
    with pytest.raises(ValueError, match="h=160"):
        a = _problem(128, h=160, seed=7)
        f(*a)
    with pytest.raises(ValueError, match="narrow enough"):
        a = _problem(768, h=64, t=8, seed=8, quiet=False)
        f(*a)
    with pytest.raises(TypeError, match="int64"):
        f(x, idx.int(), gates, w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32"):
        f(x, idx, gates.double(), w1, b1, w2, b2)
    with pytest.raises(TypeError, match="all float32 or all"):
        f(x, idx, gates, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(TypeError, match="all float32 or all"):
        f(*(a.double() if a.is_floating_point() and a is not gates else a
            for a in (x, idx, gates, w1, b1, w2, b2)))
    with pytest.raises(ValueError, match="contiguous"):
        f(x.t().contiguous().t(), idx, gates, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        f(x, idx, gates, w1.transpose(1, 2).contiguous().transpose(1, 2), b1, w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        f(x, torch.stack([idx[:, 0], idx[:, 1]], 1).t().contiguous().t(), gates, w1, b1, w2, b2)


@pytest.mark.parametrize("mode", ["sweep", "dense", "sparse", "gmm"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("grad", [False, True], ids=["nograd", "grad"])
def test_path_choice(mode, device, dtype, grad):
    """Only the sweep on bf16 tokens on the card with autograd off takes the
    kernel: the training forward (grad on, fp32) and every other mode keep
    their plain paths."""
    want = mode == "sweep" and device == "cuda" and dtype == torch.bfloat16 and not grad
    assert tm.sweep_kernel_applies(mode, device, dtype, grad, 128) is want


@pytest.mark.parametrize("width,want", [(64, True), (128, True), (256, True), (384, True),
                                        (512, True), (576, False), (96, False)])
def test_path_choice_by_width(width, want):
    """Every MoE-YOLO width up to 512 fits the kernel; MoE-YOLO-m's 576 keeps
    the plain sweep."""
    assert tm.sweep_kernel_applies("sweep", "cuda", torch.bfloat16, False, width) is want


def _kernel_source() -> str:
    return (Path(ms.__file__).resolve().parents[1] / "csrc" / "moe_sweep_fwd.cu").read_text()


def test_stage_count_is_the_kernel_source():
    """``sweep_stages`` mirrors the kernel's constants and formula."""
    src = _kernel_source()
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kSlab"], consts["kBM"], consts["kStageBytes"], consts["kMaxStages"],
            consts["kAlign"], consts["kMaxSmem"], consts["kMaxK"]) == \
        (ms._SLAB, ms._BM, ms._STAGE_BYTES, ms._MAX_STAGES, ms._ALIGN, ms.MAX_SMEM_BYTES,
         ms.MAX_K)
    assert "kMaxSmem - kAlign - 8 * (2 * kMaxStages + 2) - (d / kSlab) * kXSlabBytes" in src
    assert "s >= 1 + (d / kSlab + kW1Slabs - 1) / kW1Slabs ? s : 0" in src
    assert [ms.sweep_stages(d) for d in (64, 128, 192, 256, 384, 512, 576, 640, 704, 96)] == \
        [6, 6, 5, 5, 4, 3, 0, 0, 0, 0]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# The three MoE-YOLO-s levels of a 704×1248 frame: strides 8, 16, 32.
LEVELS = [(88 * 156, 128), (44 * 78, 256), (22 * 39, 512)]


def _card_problem(t, d, dev, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h = 2 * d
    logits = torch.randn(t, E, generator=gen) * 1.5
    idx, gates, _, _ = tm.route_top_k_dropless(logits, k=K)
    x = torch.randn(t, d, generator=gen)
    w1 = torch.randn(E, d, h, generator=gen) / d ** 0.5
    b1 = torch.randn(E, 1, h, generator=gen) * 0.1
    w2 = torch.randn(E, h, d, generator=gen) / h ** 0.5
    b2 = torch.randn(E, 1, d, generator=gen) * 0.1
    bf = [a.to(dev, torch.bfloat16) for a in (x, w1, b1, w2, b2)]
    return bf[0], idx.contiguous().to(dev), gates.to(dev), *bf[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_kernel_matches_plain_on_card(level):
    dev = require_cuda()
    hw, d = LEVELS[level]
    args = _card_problem(8 * hw, d, dev, seed=level)
    got = ms.moe_sweep_fwd(*args)
    ref = ms._sweep_plain(*args)
    torch.cuda.synchronize()
    tol = ms.sweep_tolerance(*args, ref)
    diff = (got.float() - ref.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert (diff <= tol).all(), float((diff - tol).max())
    again = ms.moe_sweep_fwd(*args)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 127, 129, 300])
def test_kernel_ragged_tiles_on_card(t):
    dev = require_cuda()
    args = _card_problem(t, 128, dev, seed=t)
    got = ms.moe_sweep_fwd(*args)
    ref = ms._sweep_plain(*args)
    tol = ms.sweep_tolerance(*args, ref)
    assert ((got.float() - ref.float()).abs() <= tol).all()


@pytest.mark.cuda
def test_moe_yolo_launches_once_a_level():
    dev = require_cuda()
    model = MoEYoloDetector(num_classes=1, variant="s", num_experts=E, k=K, dtype=torch.bfloat16,
                            dispatch="sweep", generator=torch.Generator().manual_seed(0))
    model = model.eval().to(dev)
    images = torch.rand(2, 128, 256, 3, device=dev)  # NHWC
    # Grad on first: the anchors a forward caches must not be inference tensors.
    before = ms.moe_sweep_fwd_launches
    with torch.enable_grad():
        model(images)
    assert ms.moe_sweep_fwd_launches == before
    with torch.inference_mode():
        out = model(images)
    assert ms.moe_sweep_fwd_launches - before == 3
    assert bool(torch.isfinite(out["cls_logits"].float()).all())
