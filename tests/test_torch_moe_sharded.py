"""``MoEFFN`` on a mesh of gloo ranks against JAX's unsharded layer (CPU).

The problem of ``tests/test_moe_sharded_dispatch.py`` (T = 8192 tokens,
d = 64, E = 4, k = 2; T past the dense limit of 4096), with numpy weights:
a spread router (kernel N(0, 4/d), context bias N(0, 1)) whose expert 0 is
raised by 2 in every bin, so that its queue (~6,100 selections) overflows
the capacity of 5,120 and ``sparse`` and ``dense`` drop pairs; the JAX
weights go to the port through ``convert.py``. Four ranks (two torch
threads each) run ``sweep``, ``sparse``, ``gmm`` and ``dense`` on a 2 data
× 2 expert mesh with the experts sharded (``dense`` there as the masked
sweep of the rank's experts), and ``dense`` and ``auto`` on 4 × 1, where
each rank holds 2,048 tokens: ``auto`` must resolve on the global count (to
``sweep``), not the rank's (``dense``). The loss is ``Σ out² / T + aux``
under the trainer's rule (each rank differentiates ``L / ranks``, the
gradients summed once). Checked against JAX's ``MoEFFN.apply`` and
``jax.grad`` of the same loss on the whole batch: outputs, ``moe_aux_loss``
and ``expert_load`` within 1e-5; every gradient within 1e-5 of its norm;
the kept (token, expert) pairs (selection and capacity drops, which need
global queue positions) identical, after a check that every token's 2nd
and 3rd router probabilities are further apart than twice the largest
difference between the two frameworks' router probabilities.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_flax
from multimodal_moe_torch.models import moe as tm
from multimodal_moe_torch.parallel.distributed import run_ranks
from multimodal_moe_tpu.models import moe as jm

T, D, E, K = 8192, 64, 4, 2
RANKS = 4
MODES = ("sweep", "sparse", "gmm", "dense", "auto")
# each case's JAX dispatch mode: dense_2x2 is dense with the experts sharded
CASES = {**{m: m for m in MODES}, "dense_2x2": "dense"}
WORKER = Path(__file__).with_name("_torch_rank_worker.py")


def _params(seed: int = 0):
    rng = np.random.default_rng(seed)
    h = 2 * D
    bias = rng.normal(0, 1.0, (6, E)).astype(np.float32)
    bias[:, 0] += 2.0
    return {"router": {"router_kernel": rng.normal(0, 2 / np.sqrt(D), (D, E)).astype(np.float32),
                       "context_bias": bias},
            "experts_w1": rng.normal(0, D ** -0.5, (E, D, h)).astype(np.float32),
            "experts_b1": rng.normal(0, 0.1, (E, 1, h)).astype(np.float32),
            "experts_w2": rng.normal(0, h ** -0.5, (E, h, D)).astype(np.float32),
            "experts_b2": rng.normal(0, 0.1, (E, 1, D)).astype(np.float32)}


def _jax_reference(params, tokens, ctx, mode):
    ffn = jm.MoEFFN(num_experts=E, k=K, dispatch=mode)

    def loss(p):
        out, aux = ffn.apply({"params": p}, tokens, ctx)
        return jnp.sum(out ** 2) / T + aux["moe_aux_loss"], (out, aux)

    (value, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return {"loss": float(value), "out": np.asarray(out), "aux": float(aux["moe_aux_loss"]),
            "load": np.asarray(aux["expert_load"]), "grads": jax.device_get(grads)}


def _kept_pairs(logits, capacity):
    """JAX's kept (token, expert) pairs, (T, E) bool, by routing family."""
    sparse = jm.route_top_k_sparse(logits, k=K, capacity=capacity)
    idx, valid = np.asarray(sparse.expert_idx), np.asarray(sparse.valid)
    selected = np.zeros((T, E), bool)
    np.put_along_axis(selected, idx, True, axis=1)
    within = np.zeros((T, E), bool)
    np.put_along_axis(within, np.where(valid, idx, 0), valid, axis=1)
    dense = np.asarray(jm.route_top_k(logits, k=K, capacity=capacity).dispatch.any(-1))
    return {"sweep": selected, "gmm": selected, "auto": selected, "sparse": within,
            "dense": dense, "dense_2x2": dense}


def _port_kept(ranks, mode):
    """The ranks' records put together: pairs kept by any rank, each rank
    speaking for its expert group's tokens and its own experts."""
    kept = np.zeros((T, E), bool)
    for r in ranks:
        lo, hi = r[mode]["group_tokens"]
        (rec,) = r[mode]["kept"]
        idx, mask = rec["idx"].numpy(), rec["mask"].numpy()
        rows = np.broadcast_to(np.arange(lo, hi)[:, None], idx.shape)
        kept[rows[mask], idx[mask]] = True
    return kept


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: several pytest workers run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    work = tmp_path_factory.mktemp("moe_sharded")
    rng = np.random.default_rng(0)
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    ctx = rng.integers(0, 6, T).astype(np.int32)
    params = _params()
    sd = load_flax(tm.MoEFFN(D, E, k=K), {"params": params}).state_dict()
    torch.save({"tokens": torch.from_numpy(tokens), "ctx": torch.from_numpy(ctx).long(),
                "state_dict": sd}, work / "moe_in.pt")
    # The JAX references are computed while the ranks run.
    with ThreadPoolExecutor(1) as pool:
        launch = pool.submit(run_ranks, [sys.executable, str(WORKER), "moe", str(work)], RANKS,
                             env={"OMP_NUM_THREADS": "2"}, timeout=600)
        jt, jc = jnp.asarray(tokens), jnp.asarray(ctx)
        jparams = jax.tree.map(jnp.asarray, params)
        logits = jt @ jparams["router"]["router_kernel"] + jparams["router"]["context_bias"][jc]
        probs = np.asarray(jax.nn.softmax(logits, axis=-1))
        gate = tm.ContextGate(D, E)
        gate.load_state_dict({k[len("router."):]: v for k, v in sd.items()
                              if k.startswith("router.")})
        with torch.no_grad():
            port_logits = gate(torch.from_numpy(tokens), torch.from_numpy(ctx).long())
        port_probs = torch.softmax(port_logits, -1).numpy()
        ordered = np.sort(probs, axis=-1)
        capacity = max(int(T * K * 1.25 / E), K)
        ref = {mode: _jax_reference(jparams, jt, jc, mode) for mode in MODES}
        launch.result()
    ranks = [torch.load(work / f"moe_rank{r}.pt", weights_only=True) for r in range(RANKS)]
    return {"ranks": ranks, "ref": ref, "gap": float((ordered[:, -K] - ordered[:, -K - 1]).min()),
            "prob_diff": float(np.abs(port_probs - probs).max()),
            "kept": _kept_pairs(logits, capacity), "capacity": capacity}


def test_routing_is_well_defined_and_drops(sharded):
    assert sharded["gap"] > 2 * sharded["prob_diff"], (sharded["gap"], sharded["prob_diff"])
    kept = sharded["kept"]
    assert kept["sparse"].sum() < kept["sweep"].sum()        # capacity drops happen
    assert (kept["sweep"][:, 0].sum()) > sharded["capacity"]


@pytest.mark.parametrize("mode", CASES)
def test_forward_matches_jax(sharded, mode):
    ref, got = sharded["ref"][CASES[mode]], sharded["ranks"][0][mode]
    np.testing.assert_allclose(got["out"].numpy(), ref["out"], atol=1e-5, rtol=0)
    for r in sharded["ranks"]:   # the global values, on every rank
        np.testing.assert_allclose(r[mode]["aux"], ref["aux"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(r[mode]["load"].numpy(), ref["load"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(r[mode]["loss"], ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("mode", CASES)
def test_gradients_match_jax(sharded, mode):
    ref = sharded["ref"][CASES[mode]]["grads"]
    flat_ref = {"router.router_kernel": ref["router"]["router_kernel"],
                "router.context_bias": ref["router"]["context_bias"],
                **{k: v for k, v in ref.items() if k.startswith("experts")}}
    for r in sharded["ranks"]:
        got = r[mode]["grads"]
        assert set(got) == set(flat_ref)
        for name, want in flat_ref.items():
            g = got[name].numpy()
            assert g.shape == want.shape, name
            err = np.linalg.norm(g - want)
            assert err <= 1e-5 * np.linalg.norm(want), (name, err, np.linalg.norm(want))


@pytest.mark.parametrize("mode", CASES)
def test_routing_decisions_match_jax(sharded, mode):
    np.testing.assert_array_equal(_port_kept(sharded["ranks"], mode), sharded["kept"][mode])


def test_auto_resolves_on_the_global_token_count(sharded):
    assert tm.resolve_dispatch("auto", T // RANKS, E) == "dense"    # a rank's own count
    for r in sharded["ranks"]:
        assert r["auto"]["resolved"] == [("auto", T, "sweep")]
        assert r["dense"]["resolved"] == [("dense", T, "dense")]
        assert r["dense_2x2"]["resolved"] == [("dense", T, "dense")]
