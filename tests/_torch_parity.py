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


def numpy_variables(module, *args, seed: int = 0, **kwargs):
    """Variables for a Flax ``module`` made with numpy from ``seed``, at
    the shapes of ``module.init(key, *args, **kwargs)`` (found by
    ``jax.eval_shape``: no compile). Kernels ~ N(0, 1/fan_in) (Flax's
    lecun_normal, untruncated), biases 0, raw parameters ~ N(0, 0.02);
    every norm through ``randomize_norm``."""
    shapes = jax.eval_shape(lambda r: module.init(r, *args, **kwargs), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, k)
            elif k == "kernel":
                # attention q/k/v kernels are (in, NH, hd); every other kernel
                # (conv HWIO, Dense, attention ``out`` (NH, hd, out)) has its
                # fan-in on all but the last axis
                qkv = len(v.shape) == 3 and parent != "out"
                fan_in = v.shape[0] if qkv else int(np.prod(v.shape[:-1]))
                out[k] = rng.normal(0.0, fan_in ** -0.5, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = np.zeros(v.shape, np.float32)
            else:
                out[k] = rng.normal(0.0, 0.02, v.shape).astype(np.float32)
        return out

    return randomize_norm({"params": fill(shapes["params"]),
                           "batch_stats": fill(shapes["batch_stats"])}, seed=seed)


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
    return jax.tree.map(lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
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


# --------------------------------------------------------------------------
# training: the draws JAX makes, seeded batches, RT-DETR weights
# --------------------------------------------------------------------------

def jax_augment_draws(rng, b, hflip_prob=0.5):
    """The draws ``multimodal_moe_tpu.ops.augment.train_augment`` makes
    from ``rng`` (its splits, its ranges)."""
    k1, k2 = jax.random.split(rng)
    kh, ks, kv = jax.random.split(k1, 3)
    return {"dh": jax.random.uniform(kh, (b, 1, 1), minval=-0.015, maxval=0.015),
            "gs": 1.0 + jax.random.uniform(ks, (b, 1, 1), minval=-0.7, maxval=0.7),
            "gv": 1.0 + jax.random.uniform(kv, (b, 1, 1), minval=-0.4, maxval=0.4),
            "flip": jax.random.uniform(k2, (b,)) < hflip_prob}


def jax_denoise_draws(rng, b, m, groups=2):
    """The uniform draws ``build_denoising_queries`` makes from ``rng``."""
    k1, k2, _ = jax.random.split(rng, 3)
    shape = (b, 2 * groups, m, 2)
    return (jax.random.uniform(k1, shape, minval=-1.0, maxval=1.0),
            jax.random.uniform(k2, shape, minval=-0.5, maxval=0.5))


def as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def detection_batches(n, h, w, b=2, m=3, seed=0):
    """``n`` seeded host batches (the trainer's five keys but
    ``solar_bin``): uint8 frames, ``m`` box slots, the last one padded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x1 = rng.uniform(0, w - 40, (b, m, 1))
        y1 = rng.uniform(0, h - 30, (b, m, 1))
        boxes = np.concatenate([x1, y1, x1 + rng.uniform(8, 40, (b, m, 1)),
                                y1 + rng.uniform(8, 30, (b, m, 1))], -1).astype(np.float32)
        mask = np.ones((b, m), bool)
        mask[:, -1] = False
        boxes[~mask] = 0.0
        out.append({"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                    "gt_boxes": boxes, "gt_labels": np.zeros((b, m), np.int32),
                    "gt_mask": mask})
    return out


def rtdetr_numpy_variables(jmodel, h: int, w: int, seed: int):
    """``numpy_variables`` for a Flax RT-DETR, with Flax's own init of the
    sampling offsets (zero kernel, directional bias) and the class prior
    bias, so that the random detector is as well conditioned as Flax's."""
    from multimodal_moe_torch.models.rtdetr import CLS_PRIOR_BIAS, _grid_init

    variables = numpy_variables(jmodel, jnp.zeros((1, h, w, 3)), seed=seed)
    for li in range(jmodel.num_decoder_layers):
        offsets = variables["params"][f"decoder{li}"]["cross_attn"]["sampling_offsets"]
        offsets["kernel"][:] = 0.0
        offsets["bias"][:] = _grid_init(jmodel.num_heads, 3, jmodel.num_points)
        variables["params"][f"cls_head{li}"]["bias"][:] = CLS_PRIOR_BIAS
    return variables
