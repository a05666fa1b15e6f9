"""The arithmetic of the grouped GEMM kernels (``csrc/gmm.cu``) emulated on
the CPU, against the plain float32 versions of ``ops/gmm_kernel.py``.

The kernels put an fp32-accurate product on the TF32 tensor cores: each
float32 x becomes ``big = tf32(x)`` and ``small = tf32(x - big)``
(``cvt.rna.tf32.f32``: round to nearest, ties away from zero), and every k8
step of ``mma.sync`` adds ``small·big``, ``big·small`` and ``big·big`` into
the same float32 accumulators. A bf16 value is exact in TF32, so its small
part is zero and its products are skipped: one product for bf16 × bf16, two
for a mixed pair. Sums shorter than ``gmm_kernel.SHORT_REDUCTION`` (gmm's K,
tgmm's segment length) take an exact SIMT path instead: one float32 FMA a
term, in order.

The emulation here rounds to TF32 with integer bit operations and sums each
k8 step's products in float32 (torch's own summation inside the step, one
float32 add per product into the accumulator). It must hold the kernels'
per-element bound 2·n·u·Σ|aᵢbᵢ| (u = 2⁻²⁴, n the length of the sum) against
``gmm_plain`` / ``tgmm_plain`` on ``tests/test_torch_gmm.py``'s problems, in
float32, bf16 and mixed inputs; and without the short-sum rule it must fail
that bound at n = 3, which is why the rule exists.

The emulation is a model of the kernels, not the kernels: its adds round to
nearest, while ``mma.sync`` aligns each k8 step's products to the largest
exponent and truncates. The split and the short-sum rule are what it pins
down. The kernels themselves run only on the card, and their cases of 15, 16
and 17 rows (``tests/test_torch_gmm.py -m cuda``, ``chip_smoke.py``) are what
check the threshold on them.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_moe_torch.ops import gmm_kernel as gk

M, K, N = 296, 64, 96
SIZES = {  # tests/test_torch_gmm.py's: an empty group, one group, a 3-row segment, rows past the end
    "empty_group": [101, 0, 150, 45],
    "one_group": [0, 0, M, 0],
    "ragged": [37, 90, 3, 166],
    "rows_past_the_end": [60, 0, 100, 20],
}
DTYPES = {  # (lhs, rhs); the output gradient is float32, as in training
    "f32": (torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.bfloat16),
    "mixed": (torch.bfloat16, torch.float32),
}
U32 = 2.0 ** -24
CANONICAL_NAN = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)  # the card's


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``: add half a
    TF32 ulp to the magnitude bits, then clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """As the kernels split: a NaN gets the canonical NaN as its big part
    (``tf32`` alone would carry that NaN's mantissa into the sign bit)."""
    big = torch.where(torch.isnan(x), CANONICAL_NAN, tf32(x))
    return big, tf32(x - big)


def emulated_product(a: torch.Tensor, b: torch.Tensor, short_rule: bool = True) -> torch.Tensor:
    """a (m, n) · b (n, p) in float32 as the kernels sum it; a and b keep
    their input types (float32 or bf16)."""
    n = a.shape[1]
    af, bf = a.float(), b.float()
    if short_rule and n < gk.SHORT_REDUCTION:
        # the exact path: acc = fma(a_k, b_k, acc) in order (a float32
        # product is exact in float64, one rounding a term)
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
        for k in range(n):
            acc = (acc.double() + af[:, k, None].double() * bf[None, k].double()).float()
        return acc
    a_big, a_small = split(af)
    b_big, b_small = split(bf)
    terms = []
    if a.dtype == torch.float32:
        terms.append((a_small, b_big))
    if b.dtype == torch.float32:
        terms.append((a_big, b_small))
    terms.append((a_big, b_big))
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, n, 8):
        for x, y in terms:
            acc = acc + x[:, k0:k0 + 8] @ y[k0:k0 + 8]
    return acc


def _bound(a, b) -> torch.Tensor:
    return 2 * a.shape[1] * U32 * (a.double().abs() @ b.double().abs())


def _problem(sizes, dtypes, seed):
    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dtypes[0])
    rhs = torch.from_numpy(rng.normal(0, K ** -0.5, (len(sizes), K, N)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32))
    return lhs, rhs.to(dtypes[1]), torch.tensor(sizes, dtype=torch.int32), cot


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # a TF32 ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0]
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    big, small = split(v)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    # |x - big| <= half a TF32 ulp; big + small leaves at most 2^-22 |x|
    assert bool(((v - big).abs() <= v.abs() * 2.0 ** -11).all())
    assert bool(((v.double() - big.double() - small.double()).abs()
                 <= v.abs().double() * 2.0 ** -22).all())
    w = v.bfloat16().float()  # bf16 is exact in TF32: no small part
    assert torch.equal(tf32(w), w) and bool((split(w)[1] == 0).all())


def test_split_keeps_nan():
    """A NaN in either operand reaches the same outputs as in the float32
    product, for the card's canonical NaN too, which the bare rounding turns
    into -0."""
    assert tf32(CANONICAL_NAN.reshape(1)).view(torch.int32).item() == -2 ** 31
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(24, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32, 40)).astype(np.float32))
    a[3, 7] = CANONICAL_NAN
    b[11, 5] = float("nan")
    for dtypes in DTYPES.values():
        x, y = a.to(dtypes[0]), b.to(dtypes[1])
        got, want = emulated_product(x, y), x.float() @ y.float()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isnan(got).any())


def test_threshold_is_the_kernel_source_constant():
    src = (Path(gk.__file__).resolve().parents[1] / "csrc" / "gmm.cu").read_text()
    assert int(re.search(r"constexpr int kShortReduction = (\d+);", src).group(1)) \
        == gk.SHORT_REDUCTION


@pytest.mark.parametrize("product", ["gmm", "gmm_transposed", "tgmm"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SIZES))
def test_emulated_kernel_holds_the_bound(case, dtype, product):
    sizes = SIZES[case]
    lhs, rhs, gs, cot = _problem(sizes, DTYPES[dtype], seed=len(case) + len(dtype))
    off = np.concatenate([[0], np.cumsum(sizes)])
    if product == "gmm":
        ref = gk.gmm_plain(lhs, rhs, gs)
        parts = [(lhs[off[i]:off[i + 1]], rhs[i]) for i in range(len(sizes))]
    elif product == "gmm_transposed":
        ref = gk.gmm_plain(cot, rhs, gs, transpose_rhs=True)  # the lhs gradient
        parts = [(cot[off[i]:off[i + 1]], rhs[i].T) for i in range(len(sizes))]
    else:
        ref = gk.tgmm_plain(lhs, cot, gs)
        parts = [(lhs[off[i]:off[i + 1]].T, cot[off[i]:off[i + 1]]) for i in range(len(sizes))]
    for i, (a, b) in enumerate(parts):
        if sizes[i] == 0:
            continue
        got = emulated_product(a, b)
        want = ref[i] if product == "tgmm" else ref[off[i]:off[i + 1]]
        ratio = ((got - want).abs().double() / (_bound(a, b) + 1e-300)).max().item()
        assert ratio <= 1.0, (case, dtype, product, i, a.shape[1], ratio)


def test_three_products_alone_fail_the_bound_at_n3():
    """Why the short-sum rule exists: the split leaves ~3·2⁻²²·Σ|ab| per
    element whatever n is, and at n = 3 that exceeds 2·n·u·Σ|ab|."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 512)).astype(np.float32))
    ref, bound = a @ b, _bound(a, b)
    three = (emulated_product(a, b, short_rule=False) - ref).abs().double() / bound
    exact = (emulated_product(a, b) - ref).abs().double() / bound
    assert three.max().item() > 1.0
    assert exact.max().item() <= 1.0


@pytest.mark.parametrize("n", [16, 17, 24])
def test_three_products_hold_the_bound_from_the_threshold(n):
    """At and just past the threshold the tensor-core path alone holds."""
    assert n >= gk.SHORT_REDUCTION
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.normal(size=(256, n)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n, 256)).astype(np.float32))
    ratio = (emulated_product(a, b) - a @ b).abs().double() / _bound(a, b)
    assert ratio.max().item() <= 0.5
