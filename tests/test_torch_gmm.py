"""The grouped GEMM of the dropless MoE (``ops/gmm_kernel.py``) and
``moe_apply_gmm`` against the JAX package on the CPU.

* ``gmm_plain`` (plain and transposed rhs) and ``tgmm_plain`` against
  megablox ``gmm`` itself in interpret mode, forward and ``jax.vjp``
  (``grad_lhs`` is megablox's transposed ``gmm``, ``grad_rhs`` its
  ``tgmm``), through the port's autograd function ``grouped_matmul``.
  Group sizes with an empty group, segments that are not multiples of the
  tile, all rows in one group, and rows past the last group. Tolerance
  (float32): 1e-5·max(1, max|ref|): both sum at most 96 products of
  unit-scale numbers in other orders.
* The port's ``moe_apply_gmm`` against JAX's ``moe_apply_gmm(interpret=True)``
  (the path JAX's own tests take): outputs and the gradients for tokens,
  gates and the four expert tensors, within 1e-5·max(1, max|ref|).
* The collapse case (every token on one expert: nothing dropped) and
  ``gmm`` against ``sweep`` (both dropless) within 1e-5.

``MoEFFN(dispatch="gmm")`` with converted Flax weights is a case of
``tests/test_torch_moe.py::test_moe_ffn_matches_jax``. The kernels run only
on the card: the ``cuda`` tests hold them against the plain versions with
the per-element bound 2·n·u·Σ|aᵢbᵢ| (u = 2⁻²⁴, n the length of each sum:
two summation orders; float32, bf16 and mixed inputs, tgmm segments around
the exact short-sum path), check that two tgmm launches are bitwise equal,
and skip here. ``tests/test_torch_gmm_split.py`` emulates the kernels'
split-TF32 arithmetic on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox import gmm as megablox_gmm

from _torch_parity import require_cuda
from multimodal_moe_torch.models import moe as tm
from multimodal_moe_torch.ops import gmm_kernel as gk

M, K, N = 296, 64, 96
TILING = (8, 32, 32)  # megablox needs M, K and N to be multiples of its tile
SIZES = {
    "empty_group": [101, 0, 150, 45],
    "one_group": [0, 0, M, 0],
    "ragged": [37, 90, 3, 166],
    "rows_past_the_end": [60, 0, 100, 20],   # 116 rows belong to no group
}
U32 = 2.0 ** -24


def _tol(ref) -> float:
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def _problem(sizes, seed, transpose=False):
    rng = np.random.default_rng(seed)
    lhs = rng.normal(size=(M, K)).astype(np.float32)
    rhs = rng.normal(0, K ** -0.5, (len(sizes), N, K) if transpose else (len(sizes), K, N))
    cot = rng.normal(size=(M, N)).astype(np.float32)
    return lhs, rhs.astype(np.float32), np.asarray(sizes, np.int32), cot


@pytest.mark.parametrize("transpose", [False, True], ids=["rhs", "rhs_transposed"])
@pytest.mark.parametrize("case", list(SIZES))
def test_grouped_matmul_matches_megablox(case, transpose):
    lhs, rhs, sizes, cot = _problem(SIZES[case], seed=len(case), transpose=transpose)

    def ref_fn(a, b):
        return megablox_gmm(a, b, jnp.asarray(sizes), transpose_rhs=transpose, tiling=TILING,
                            interpret=True)

    ref, vjp = jax.vjp(ref_fn, jnp.asarray(lhs), jnp.asarray(rhs))
    ref_dl, ref_dr = jax.device_get(vjp(jnp.asarray(cot)))
    ref = np.asarray(ref)

    tl, tr = torch.from_numpy(lhs).requires_grad_(), torch.from_numpy(rhs).requires_grad_()
    out = gk.grouped_matmul(tl, tr, torch.from_numpy(sizes), transpose)
    out.backward(torch.from_numpy(cot))
    assert out.dtype == torch.float32 and out.shape == (M, N)
    # megablox leaves the rows past the last group unwritten; the port
    # writes zeros there (in the output and in the lhs gradient).
    c = int(sizes.sum())
    np.testing.assert_allclose(out.detach().numpy()[:c], ref[:c], rtol=0, atol=_tol(ref[:c]))
    np.testing.assert_allclose(tl.grad.numpy()[:c], ref_dl[:c], rtol=0, atol=_tol(ref_dl[:c]))
    np.testing.assert_allclose(tr.grad.numpy(), ref_dr, rtol=0, atol=_tol(ref_dr))
    for g in np.flatnonzero(sizes == 0):  # an empty group's weight gradient is zero
        assert float(tr.grad[g].abs().max()) == 0.0
    assert float(out.detach()[c:].abs().sum()) == float(tl.grad[c:].abs().sum()) == 0.0


def test_tgmm_plain_is_megablox_weight_gradient():
    """tgmm_plain directly: the vjp's rhs cotangent, as a function of its own."""
    lhs, rhs, sizes, cot = _problem(SIZES["ragged"], seed=3)
    _, vjp = jax.vjp(lambda b: megablox_gmm(jnp.asarray(lhs), b, jnp.asarray(sizes),
                                            tiling=TILING, interpret=True), jnp.asarray(rhs))
    ref = np.asarray(vjp(jnp.asarray(cot))[0])
    got = gk.tgmm(torch.from_numpy(lhs), torch.from_numpy(cot), torch.from_numpy(sizes))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(ref))


def test_bfloat16_inputs_sum_in_float32():
    lhs, rhs, sizes, _ = _problem(SIZES["empty_group"], seed=4)
    a = torch.from_numpy(lhs).bfloat16()
    b = torch.from_numpy(rhs).bfloat16()
    got = gk.gmm(a, b, torch.from_numpy(sizes))
    assert got.dtype == torch.float32
    ref = gk.gmm_plain(a.float(), b.float(), torch.from_numpy(sizes))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    lhs, rhs = torch.zeros(8, 4), torch.zeros(2, 4, 4)
    sizes = torch.tensor([4, 4], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        gk.gmm(lhs, rhs, sizes.long())
    with pytest.raises(ValueError, match="shapes do not match"):
        gk.gmm(torch.zeros(8, 5), rhs, sizes)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gk.gmm(lhs.half(), rhs, sizes)
    with pytest.raises(ValueError, match="differ in rows"):
        gk.tgmm(lhs, torch.zeros(7, 4), sizes)


@pytest.mark.parametrize("m,k,n", [(439296, 128, 256), (27456, 512, 1024), (40, 64, 64)])
def test_tgmm_chunks_are_whole_stages(m, k, n):
    """tgmm's chunks hold whole 32-row stages of the tile loop, and enough
    of them that work items × output tiles give each SM its blocks."""
    tiles = -(-k // 128) * -(-n // 128)
    rows = gk.tgmm_rows_per_chunk(m, k, n, num_sms=132)
    assert rows % 32 == 0 and rows >= 32
    assert -(-m // rows) * tiles >= min(gk._BLOCKS_PER_SM * 132, -(-m // 32) * tiles) * 0.9


# --------------------------------------------------------------------------
# moe_apply_gmm and the MoE layer
# --------------------------------------------------------------------------

T, D, E, KTOP = 64, 16, 4, 2


def _expert_weights(seed, d=D, h=2 * D, e=E):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.3, (e, d, h)).astype(np.float32),
            rng.normal(0, 0.1, (e, 1, h)).astype(np.float32),
            rng.normal(0, 0.3, (e, h, d)).astype(np.float32),
            rng.normal(0, 0.1, (e, 1, d)).astype(np.float32)]


@pytest.mark.parametrize("route", ["random", "one_expert_idle"])
def test_moe_apply_gmm_matches_jax(route):
    # imported here: the card's host has jax but not flax, and runs this
    # file's cuda tests
    from multimodal_moe_tpu.models import moe as jm

    rng = np.random.default_rng(5)
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    logits = rng.normal(0, 1.5, (T, E)).astype(np.float32)
    if route == "one_expert_idle":
        logits[:, 3] = -30.0  # expert 3 gets no token: an empty segment
    idx, gates, _, _ = jax.device_get(jm.route_top_k_dropless(jnp.asarray(logits), k=KTOP))
    weights = _expert_weights(6)
    cot = rng.normal(size=(T, D)).astype(np.float32)

    def ref_fn(x, g, w1, b1, w2, b2):
        return jm.moe_apply_gmm(x, jnp.asarray(idx), g, w1, b1, w2, b2, interpret=True)

    args = [tokens, gates] + weights
    ref, vjp = jax.vjp(ref_fn, *map(jnp.asarray, args))
    ref_grads = jax.device_get(vjp(jnp.asarray(cot)))

    targs = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = tm.moe_apply_gmm(targs[0], torch.from_numpy(np.array(idx)).long(), *targs[1:])
    out.backward(torch.from_numpy(cot))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=_tol(ref))
    names = ("tokens", "gates", "w1", "b1", "w2", "b2")
    for name, t, r in zip(names, targs, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0, atol=_tol(r), err_msg=name)
    if route == "one_expert_idle":
        assert not (np.asarray(idx) == 3).any()
        assert float(targs[4].grad[3].abs().max()) == 0.0


def test_gmm_no_drops_under_collapse():
    """Every token picks one expert: the capacity routes drop, gmm must not
    (tests/test_moe.py's collapse case)."""
    t, d, h, e = 32, 8, 16, 4
    tokens = torch.ones(t, d)
    logits = torch.tensor([[9.0, 0.0, 0.0, 0.0]]).repeat(t, 1)
    idx, gates, _, _ = tm.route_top_k_dropless(logits, k=1)
    out = tm.moe_apply_gmm(tokens, idx, gates, torch.full((e, d, h), 0.01), torch.zeros(e, 1, h),
                           torch.full((e, h, d), 0.01), torch.zeros(e, 1, d))
    assert float(out.abs().min()) > 0
    torch.testing.assert_close(out[0], out[-1], rtol=1e-6, atol=0)


def test_gmm_matches_sweep():
    """Both dropless: the same function of the same routing."""
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
    idx, gates, _, _ = tm.route_top_k_dropless(torch.from_numpy(
        rng.normal(0, 1.5, (T, E)).astype(np.float32)), k=KTOP)
    weights = [torch.from_numpy(w) for w in _expert_weights(8)]
    got = tm.moe_apply_gmm(tokens, idx, gates, *weights)
    ref = tm.moe_apply_sweep(tokens, idx, gates, *weights)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_moe_ffn_gmm_trains():
    """The layer on ``gmm`` backpropagates into every parameter, the router
    through the gates and the aux loss."""
    m = tm.MoEFFN(D, E, dispatch="gmm", generator=torch.Generator().manual_seed(0))
    x = torch.randn(40, D, generator=torch.Generator().manual_seed(1)).requires_grad_()
    out, aux = m(x, torch.zeros(40, dtype=torch.long))
    (out.square().mean() + aux["moe_aux_loss"]).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    for name, p in m.named_parameters():
        if name != "router.context_bias":  # bins 1-5 see no token
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, name


# --------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# --------------------------------------------------------------------------

def _bound(a, b, n) -> torch.Tensor:
    """2·n·u·Σ|aᵢbᵢ| per element, from the products of |a| and |b|."""
    return 2 * n * U32 * (a.abs() @ b.abs()) + 1e-30


def _card_problem(dev, sizes, k, n, dtype, seed):
    """lhs in ``dtype`` (or ``dtype[0]``), rhs in ``dtype`` (or ``dtype[1]``),
    the output gradient float32."""
    lhs_dtype, rhs_dtype = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = sum(sizes)
    lhs = torch.randn(m, k, generator=gen, device=dev).to(lhs_dtype)
    rhs = (torch.randn(len(sizes), k, n, generator=gen, device=dev) * k ** -0.5).to(rhs_dtype)
    g = torch.randn(m, n, generator=gen, device=dev)
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev), g


CARD_CASES = {
    "level0_f32": ([100000, 37, 0, 9999], 128, 256, torch.float32),
    "ragged_bf16": ([1000, 0, 513, 77], 256, 128, torch.bfloat16),
    "one_group": ([0, 4097, 0, 0], 64, 64, torch.float32),
    "mixed_bf16_f32": ([2000, 0, 513, 77], 256, 128, (torch.bfloat16, torch.float32)),
    # tgmm segments around the exact short-sum path (gmm_kernel.SHORT_REDUCTION = 16)
    "short_segments": ([1, 15, 16, 17, 3000], 128, 64, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_kernels_match_plain(case):
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes, k, n, dtype = CARD_CASES[case]
    lhs, rhs, gs, g = _card_problem(dev, sizes, k, n, dtype, seed=len(case))
    lf, rf = lhs.float(), rhs.float()
    off = np.concatenate([[0], np.cumsum(sizes)])
    checks = [
        (gk.gmm(lhs, rhs, gs), gk.gmm_plain(lhs, rhs, gs), k,
         lambda i: (lf[off[i]:off[i + 1]], rf[i])),
        (gk.gmm(g, rhs, gs, transpose_rhs=True), gk.gmm_plain(g, rhs, gs, True), n,
         lambda i: (g[off[i]:off[i + 1]], rf[i].T)),
    ]
    torch.cuda.synchronize()
    for got, ref, length, parts in checks:
        for i in range(len(sizes)):
            if sizes[i]:
                d = (got[off[i]:off[i + 1]] - ref[off[i]:off[i + 1]]).abs()
                assert bool((d <= _bound(*parts(i), length)).all()), (case, i)
    tg, tref = gk.tgmm(lhs, g, gs), gk.tgmm_plain(lhs, g, gs)
    torch.cuda.synchronize()
    for i in range(len(sizes)):
        if sizes[i]:
            seg = slice(off[i], off[i + 1])
            bound = _bound(lf[seg].T, g[seg], sizes[i])
            assert bool(((tg[i] - tref[i]).abs() <= bound).all()), (case, i)
        else:
            assert float(tg[i].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_autograd_matches_plain_autograd():
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    lhs, rhs, gs, g = _card_problem(dev, [3000, 0, 1234, 555], 128, 64, torch.float32, seed=9)
    grads = []
    for fn in (gk.grouped_matmul, gk.gmm_plain):
        a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        fn(a, b, gs, False).backward(g)
        grads.append((a.grad, b.grad))
    before = (gk.gmm_launches, gk.tgmm_launches)
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    gk.grouped_matmul(a, b, gs).backward(g)
    assert (gk.gmm_launches - before[0], gk.tgmm_launches - before[1]) == (2, 1)
    for got, ref in zip(*grads):
        rel = float((got - ref).norm() / ref.norm())
        assert rel <= 1e-5, rel


@pytest.mark.cuda
def test_cuda_tgmm_is_deterministic():
    """The partials are summed in chunk order (no atomics): two launches on
    the same inputs are bitwise equal."""
    dev = require_cuda()
    lhs, _, gs, g = _card_problem(dev, [100000, 37, 0, 9999], 128, 256, torch.float32, seed=12)
    first = gk.tgmm(lhs, g, gs)
    assert torch.equal(first, gk.tgmm(lhs, g, gs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "mixed"])
def test_cuda_kernels_propagate_nan(dtype):
    """A NaN made on the card (0/0, the canonical NaN) in lhs and in the
    output gradient, in a long segment (tensor-core path) and a short one
    (exact path), reaches the same outputs as in the plain versions."""
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = [3000, 5, 0, 1200]
    lhs, rhs, gs, g = _card_problem(dev, sizes, 128, 64, torch.float32, seed=13)
    nan = torch.zeros((), device=dev) / torch.zeros((), device=dev)
    lhs[10, 3], lhs[3002, 70] = nan, nan
    g[500, 9], g[3001, 40] = nan, nan
    if dtype == "mixed":
        lhs = lhs.bfloat16()
    pairs = [(gk.gmm(lhs, rhs, gs), gk.gmm_plain(lhs, rhs, gs)),
             (gk.gmm(g, rhs, gs, transpose_rhs=True), gk.gmm_plain(g, rhs, gs, True)),
             (gk.tgmm(lhs, g, gs), gk.tgmm_plain(lhs, g, gs))]
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert bool(torch.isnan(ref).any())
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
