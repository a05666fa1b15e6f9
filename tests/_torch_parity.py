"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and handed to both frameworks as
numpy arrays; Flax weights reach torch through ``convert.flax_to_state_dict``.
"""

from __future__ import annotations

import jax
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
