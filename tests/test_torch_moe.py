"""PyTorch port of models/moe.py against the Flax module (CPU, float32).

Routers on identical numpy logits: every decision equal (selected experts,
queue positions, validity, dispatch masks), gates, combine weights and aux
losses within 1e-6, expert loads (the same counts; JAX's mean may multiply
by 1/T) within 1e-6 relative. Dispatch on the same decision:
``moe_apply_sparse`` and ``moe_apply_sweep`` within 1e-5. ``MoEFFN`` with converted Flax weights in
each mode within 1e-5, after a check that every token's k-th and (k+1)-th
router probabilities are further apart than twice the largest router logit
difference between the two frameworks (routing is discrete: only there may
a decision differ). The fused route is compared with the JAX fused route,
whose Pallas kernel runs in interpret mode; ``gmm`` with JAX's ``gmm``
mode (its CPU path, ``moe_apply_gmm(interpret=True)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_flax
from multimodal_moe_torch.models import moe as tm
from multimodal_moe_torch.quant import QT
from multimodal_moe_tpu.data.solar import NUM_SOLAR_BINS
from multimodal_moe_tpu.models import moe as jm
from multimodal_moe_tpu.ops import moe_kernels as jk

T, D, E, K = 300, 32, 4, 2
ATOL = 1e-5


def _logits(seed, t=T, e=E, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.5, (t, e))
    if ties:
        x = np.round(x * 2) / 2  # many equal logits within a token
    return x.astype(np.float32)


def _np(tree):
    return jax.tree.map(lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
                        tree)


def test_num_solar_bins_matches_jax():
    assert tm.NUM_SOLAR_BINS == NUM_SOLAR_BINS == 6


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_route_top_k_matches(ties):
    logits = _logits(0, ties=ties)
    cap = 120
    ref = _np(jm.route_top_k(jnp.asarray(logits), k=K, capacity=cap))
    got = _np(tm.route_top_k(torch.from_numpy(logits), k=K, capacity=cap))
    np.testing.assert_array_equal(got.dispatch, ref.dispatch)
    np.testing.assert_allclose(got.combine, ref.combine, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.aux_loss, ref.aux_loss, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.expert_load, ref.expert_load, rtol=1e-6, atol=0)
    if ties:  # selection by logits >= kth: ties select more than k
        assert (ref.dispatch.any(-1).sum(-1) > K).any()


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("cap", [40, 150, 600])
def test_route_top_k_sparse_matches(ties, cap):
    logits = _logits(1, ties=ties)
    ref = _np(jm.route_top_k_sparse(jnp.asarray(logits), k=K, capacity=cap))
    got = _np(tm.route_top_k_sparse(torch.from_numpy(logits), k=K, capacity=cap))
    for name in ("expert_idx", "position", "valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(got.gates, ref.gates, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.aux_loss, ref.aux_loss, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.expert_load, ref.expert_load, rtol=1e-6, atol=0)


def test_route_top_k_dropless_matches():
    logits = _logits(2, ties=True)
    ref = _np(jm.route_top_k_dropless(jnp.asarray(logits), k=K))
    got = _np(tm.route_top_k_dropless(torch.from_numpy(logits), k=K))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-6, atol=0)


def _expert_weights(seed, d=D, h=2 * D, e=E):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(d)
    return [rng.normal(0, s, (e, d, h)).astype(np.float32),
            rng.normal(0, 0.1, (e, 1, h)).astype(np.float32),
            rng.normal(0, s, (e, h, d)).astype(np.float32),
            rng.normal(0, 0.1, (e, 1, d)).astype(np.float32)]


@pytest.mark.parametrize("cap", [64, 256])
def test_moe_apply_sparse_matches(cap):
    rng = np.random.default_rng(3)
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    logits = _logits(4)
    weights = _expert_weights(5)
    rd = jm.route_top_k_sparse(jnp.asarray(logits), k=K, capacity=cap)
    ref = jm.moe_apply_sparse(jnp.asarray(tokens), rd, *map(jnp.asarray, weights), capacity=cap)
    trd = tm.RouterDecision(*(torch.from_numpy(np.array(a)) for a in rd))
    trd = trd._replace(expert_idx=trd.expert_idx.long(), position=trd.position.long())
    got = tm.moe_apply_sparse(torch.from_numpy(tokens), trd,
                              *map(torch.from_numpy, weights), capacity=cap)
    assert bool((~np.asarray(rd.valid)).any()) == (cap == 64)  # drops at the small capacity
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_moe_apply_sweep_matches():
    rng = np.random.default_rng(6)
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    idx, gates, _, _ = jm.route_top_k_dropless(jnp.asarray(_logits(7)), k=K)
    weights = _expert_weights(8)
    ref = jm.moe_apply_sweep(jnp.asarray(tokens), idx, gates, *map(jnp.asarray, weights))
    got = tm.moe_apply_sweep(torch.from_numpy(tokens), torch.from_numpy(np.array(idx)).long(),
                             torch.from_numpy(np.array(gates)),
                             *map(torch.from_numpy, weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,e", [(10, 4), (4096, 4), (4097, 4), (4097, 16), (4097, 17),
                                 (200000, 64)])
@pytest.mark.parametrize("dispatch", ["auto", "dense", "sweep", "sparse", "gmm"])
def test_resolve_dispatch_matches(t, e, dispatch):
    assert tm.resolve_dispatch(dispatch, t, e) == jm.resolve_dispatch(dispatch, t, e)


def test_dispatch_thresholds_match():
    assert tm.MoEFFN.DENSE_TOKEN_LIMIT == jm.MoEFFN._DENSE_TOKEN_LIMIT == 4096
    assert tm.MoEFFN.SWEEP_EXPERT_LIMIT == jm.MoEFFN._SWEEP_EXPERT_LIMIT == 16


# --------------------------------------------------------------------------
# MoEFFN with converted Flax weights
# --------------------------------------------------------------------------

def _spread_router(params, seed):
    """A router with well-separated probabilities and bins that matter."""
    rng = np.random.default_rng(seed)
    p = jax.device_get(params)
    r = dict(p["router"])
    d, e = r["router_kernel"].shape
    r["router_kernel"] = rng.normal(0, 2.0 / np.sqrt(d), (d, e)).astype(np.float32)
    r["context_bias"] = rng.normal(0, 1.0, r["context_bias"].shape).astype(np.float32)
    return {**p, "router": r}


@pytest.fixture(scope="module")
def ffn_problem():
    rng = np.random.default_rng(9)
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    ctx = rng.integers(0, NUM_SOLAR_BINS, T).astype(np.int32)
    jmod = jm.MoEFFN(num_experts=E, k=K, dispatch="dense")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(ctx))["params"]
    params = _spread_router(params, 10)
    params["experts_b1"] = rng.normal(0, 0.1, params["experts_b1"].shape).astype(np.float32)
    params["experts_b2"] = rng.normal(0, 0.1, params["experts_b2"].shape).astype(np.float32)
    return tokens, ctx, {"params": params}


def _assert_routing_defined(variables, tokens, ctx, tmodule, k=K):
    """The port's router logits match JAX's, and every token's k-th and
    (k+1)-th probabilities are further apart than twice the difference."""
    ref = np.asarray(jm.ContextGate(E).apply({"params": variables["params"]["router"]},
                                             jnp.asarray(tokens), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tmodule.router(torch.from_numpy(tokens), torch.from_numpy(ctx).long()).numpy()
    diff = float(np.abs(got - ref).max())
    assert diff < 1e-5, diff
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(ref), -1)), axis=-1)[:, ::-1]
    gap = probs[:, k - 1] - probs[:, k]
    assert gap.min() > 2 * diff, (float(gap.min()), diff)


@pytest.mark.parametrize("mode", ["dense", "sweep", "sparse", "sparse_capacity_2.0", "fused",
                                  "gmm"])
def test_moe_ffn_matches_jax(ffn_problem, mode, monkeypatch):
    tokens, ctx, variables = ffn_problem
    fused = mode == "fused"
    cf = 2.0 if mode.endswith("2.0") else 1.25
    dispatch = "sparse" if fused or mode.startswith("sparse") else mode
    if fused:  # the JAX fused route runs its Pallas kernel in interpret mode here
        real = jk.fused_expert_ffn
        monkeypatch.setattr(jk, "fused_expert_ffn", lambda *a: real(*a, True))
    jmod = jm.MoEFFN(num_experts=E, k=K, capacity_factor=cf, dispatch=dispatch,
                     use_pallas_ffn=fused)
    ref_out, ref_aux = jax.device_get(jmod.apply(variables, jnp.asarray(tokens), jnp.asarray(ctx)))
    tmod = load_flax(tm.MoEFFN(D, E, k=K, capacity_factor=cf, dispatch=dispatch,
                               use_fused_ffn=fused), variables)
    _assert_routing_defined(variables, tokens, ctx, tmod)
    with torch.no_grad():
        out, aux = tmod(torch.from_numpy(tokens), torch.from_numpy(ctx).long())
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux["moe_aux_loss"].numpy(), ref_aux["moe_aux_loss"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(aux["expert_load"].numpy(), ref_aux["expert_load"],
                               rtol=1e-6, atol=0)
    assert float(np.abs(ref_out - tokens).max()) > 0.1  # the experts did something


def test_moe_ffn_modes_differ_only_by_drops(ffn_problem):
    """Sweep is dropless; sparse at a capacity no expert exceeds equals it."""
    tokens, ctx, variables = ffn_problem
    x, c = torch.from_numpy(tokens), torch.from_numpy(ctx).long()
    outs = {}
    for mode, cf in (("sweep", 1.25), ("sparse", float(E))):
        m = load_flax(tm.MoEFFN(D, E, k=K, capacity_factor=cf, dispatch=mode), variables)
        with torch.no_grad():
            outs[mode] = m(x, c)[0]
    torch.testing.assert_close(outs["sparse"], outs["sweep"], atol=ATOL, rtol=0)


def test_context_router_matches_jax(ffn_problem):
    tokens, ctx, variables = ffn_problem
    jr = jm.ContextRouter(num_experts=E)
    jv = {"params": {"gate": variables["params"]["router"]}}
    ref = _np(jr.apply(jv, jnp.asarray(tokens), jnp.asarray(ctx)))
    tr = load_flax(tm.ContextRouter(D, E), jv)
    with torch.no_grad():
        got = _np(tr(torch.from_numpy(tokens), torch.from_numpy(ctx).long()))
    np.testing.assert_array_equal(got.dispatch, ref.dispatch)
    np.testing.assert_allclose(got.combine, ref.combine, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.aux_loss, ref.aux_loss, atol=1e-6, rtol=1e-6)


def test_fused_route_rounds_capacity_and_backpropagates(ffn_problem):
    tokens, ctx, variables = ffn_problem
    m = load_flax(tm.MoEFFN(D, E, k=K, dispatch="sparse", use_fused_ffn=True), variables)
    x = torch.from_numpy(tokens).requires_grad_()
    out, aux = m(x, torch.from_numpy(ctx).long())
    (out.square().mean() + aux["moe_aux_loss"]).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in m.parameters())


def test_unported_modes_raise():
    """Raw int8 tokens and unknown modes raise; ``gmm`` (ported) runs. Since
    the w8a8 sweep came (``int8=True``), int8 tokens are a ``quant.QT`` to an
    int8 module: a bare int8 tensor, or a QT to an fp module, is refused."""
    m = tm.MoEFFN(D, E, dispatch="gmm", generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, D, generator=torch.Generator().manual_seed(1))
    c = torch.zeros(8, dtype=torch.long)
    out, aux = m(x, c)
    assert out.shape == (8, D) and torch.isfinite(out).all()
    assert float(aux["expert_load"].sum()) == pytest.approx(K)
    m.dispatch = "sweep"
    with pytest.raises(TypeError, match="quant.QT"):
        m(torch.zeros(8, D, dtype=torch.int8), c)
    with pytest.raises(TypeError, match="int8=True"):
        m(QT(torch.zeros(8, D, dtype=torch.int8), torch.ones(())), c)
    with pytest.raises(ValueError, match="dispatch must be"):
        tm.MoEFFN(D, E, dispatch="einsum")


def test_init_mirrors_flax():
    """lecun_normal on (E, d, h) counts E into the fan-in; the router kernel
    is truncated_normal(0.02); biases and the context bias are zero."""
    d, e = 128, 4
    jmod = jm.MoEFFN(num_experts=e)
    p = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.zeros((16, d)),
                                 jnp.zeros(16, jnp.int32))["params"])
    t = tm.MoEFFN(d, e, generator=torch.Generator().manual_seed(0))
    for name in ("experts_w1", "experts_w2"):
        ref_std = float(np.std(p[name]))
        got = getattr(t, name).detach()
        assert abs(float(got.std()) - ref_std) < 0.03 * ref_std, name
        assert float(got.abs().max()) <= 2 * ref_std / 0.8796 * 1.05
    assert abs(float(np.std(p["experts_w1"])) - 1 / np.sqrt(e * d)) < 0.002  # 0.0442
    rk = t.router.router_kernel.detach()
    assert float(rk.abs().max()) <= 0.04
    assert abs(float(rk.std()) - float(np.std(p["router"]["router_kernel"]))) < 0.003
    for name in ("experts_b1", "experts_b2"):
        assert float(getattr(t, name).detach().abs().max()) == 0
    assert float(t.router.context_bias.detach().abs().max()) == 0
