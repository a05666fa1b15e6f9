"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and handed to both frameworks as
numpy arrays; Flax weights reach torch through ``convert.flax_to_state_dict``.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_moe_torch.convert import flax_to_state_dict


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at import, so every pytest worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card via chip_smoke.py / pytest -m cuda")
    return torch.device("cuda")


def randomize_norm(variables, seed: int = 0):
    """Give every BatchNorm non-trivial statistics and affine terms.

    A fresh Flax init has mean 0, var 1, scale 1, bias 0, where a swapped or
    dropped BN mapping would go unnoticed; random values catch it, and keep
    the activations of a deep random net from fading to nothing."""
    rng = np.random.default_rng(seed)
    variables = jax.device_get(variables)

    def params(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias"}:
                n = v["scale"].shape
                out[k] = {
                    "scale": rng.uniform(0.9, 1.6, n).astype(np.float32),
                    "bias": rng.normal(0.0, 0.2, n).astype(np.float32),
                }
            elif isinstance(v, dict):
                out[k] = params(v)
            else:
                out[k] = np.asarray(v)
        return out

    def stats(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and set(v) == {"mean", "var"}:
                n = v["mean"].shape
                out[k] = {
                    "mean": rng.normal(0.0, 0.1, n).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, n).astype(np.float32),
                }
            else:
                out[k] = stats(v)
        return out

    return {"params": params(variables["params"]), "batch_stats": stats(variables["batch_stats"])}


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load numpy Flax variables into ``module`` (strict) and set eval mode."""
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module.eval()


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------------
# RT-DETR: one model in both frameworks, and the comparison of their outputs
# --------------------------------------------------------------------------

# Detector tolerances (float32; a ResNet trunk, an attention layer and the
# decoder sum in other orders):
RTDETR_LOGIT_TOL = 1e-4   # rtol and atol on logits and encoder scores
RTDETR_BOX_TOL = 1e-5     # atol on normalised cxcywh boxes
RTDETR_PIXEL_TOL = 1e-2   # atol on xyxy pixel boxes


def rtdetr_pair(cfg: dict, seed: int, images: np.ndarray) -> SimpleNamespace:
    """A Flax ``RTDETRDetector`` with depths (1, 1, 1, 1) (init from
    ``seed``, norms randomised) and the port loaded from the same weights,
    both run on ``images`` (NHWC float32). The encoder scores of both are
    captured as well."""
    from multimodal_moe_torch.models.rtdetr import RTDETRDetector as TorchRTDETR
    from multimodal_moe_tpu.models.rtdetr import RTDETRDetector as JaxRTDETR

    h, w = images.shape[1:3]
    jmodel = JaxRTDETR(num_classes=1, backbone_depths=(1, 1, 1, 1), **cfg)
    variables = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, h, w, 3)), train=False))(
        jax.random.PRNGKey(seed))
    variables = randomize_norm(variables, seed=seed)
    out, state = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "enc_score",
    ))(variables, jnp.asarray(images))
    out, enc = jax.device_get((out, state["intermediates"]["enc_score"]["__call__"][0]))
    tmodel = load_flax(TorchRTDETR(num_classes=1, backbone_depths=(1, 1, 1, 1), **cfg),
                       variables)
    captured = []
    hook = tmodel.enc_score.register_forward_hook(lambda m, i, o: captured.append(o.numpy()))
    with torch.inference_mode():
        port_out = tmodel(torch.from_numpy(images))
    hook.remove()
    return SimpleNamespace(cfg=cfg, jmodel=jmodel, variables=variables, tmodel=tmodel,
                           images=images, jax_out=out, jax_enc=enc,
                           port_out=to_numpy(port_out), port_enc=captured[0])


def to_numpy(tree):
    return jax.tree.map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
                        tree)


def assert_rtdetr_selection_well_defined(pair: SimpleNamespace, valid: np.ndarray):
    """The encoder scores agree within the tolerance; JAX's k-th and
    (k+1)-th scores are further apart than it, so both select the same set;
    adjacent scores inside the top k are further apart than twice the
    largest difference seen, so both order it the same."""
    diff = float(np.abs(pair.port_enc - pair.jax_enc).max())
    assert diff <= RTDETR_LOGIT_TOL, diff
    k = pair.cfg["num_queries"]
    scores = np.where(valid[None], pair.jax_enc.max(-1), -1e9)
    gaps = -np.diff(-np.sort(-scores, axis=-1)[:, : k + 1], axis=-1)
    assert gaps[:, -1].min() > RTDETR_LOGIT_TOL, float(gaps[:, -1].min())
    assert gaps.min() > 2 * diff, (float(gaps.min()), diff)


def assert_rtdetr_outputs_match(pair: SimpleNamespace):
    """Every output of the JAX detector, ``aux_outputs`` and
    ``enc_outputs`` included, within the detector tolerances."""
    ref, got, cfg = to_numpy(pair.jax_out), pair.port_out, pair.cfg
    assert set(got) == set(ref)
    assert len(got["aux_outputs"]) == len(ref["aux_outputs"]) == cfg["num_decoder_layers"] - 1
    heads = [("final", got, ref)] + [
        (f"aux{i}", g, r) for i, (g, r) in enumerate(zip(got["aux_outputs"], ref["aux_outputs"]))
    ] + [("enc", got["enc_outputs"], ref["enc_outputs"])]
    b = pair.images.shape[0]
    for tag, g, r in heads:
        assert g["pred_logits"].shape == r["pred_logits"].shape == (b, cfg["num_queries"], 1)
        np.testing.assert_allclose(g["pred_logits"], r["pred_logits"], rtol=RTDETR_LOGIT_TOL,
                                   atol=RTDETR_LOGIT_TOL, err_msg=f"{tag} logits")
        np.testing.assert_allclose(g["pred_boxes"], r["pred_boxes"], rtol=0,
                                   atol=RTDETR_BOX_TOL, err_msg=f"{tag} boxes")
    np.testing.assert_array_equal(got["cls_logits"], got["pred_logits"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=RTDETR_PIXEL_TOL)
    for k in ("pred_logits", "pred_boxes", "boxes"):
        assert got[k].dtype == np.float32
