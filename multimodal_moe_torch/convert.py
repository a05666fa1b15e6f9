"""Weight bridge: a Flax variables tree (as numpy) → a torch ``state_dict``.

The caller turns the JAX arrays into numpy first (``jax.device_get``), so
this module never sees JAX. The torch modules carry the Flax names, so the
map is mechanical. Leaf kinds, keyed by their path:

* conv ``kernel`` HWIO → ``weight`` OIHW
* ``Dense`` ``kernel`` ``(in, out)`` → ``Linear.weight`` ``(out, in)``
* ``MultiHeadDotProductAttention``: the ``query`` / ``key`` / ``value``
  kernels ``(in, NH, hd)`` → ``(NH·hd, in)`` and their biases ``(NH, hd)``
  → ``(NH·hd,)``; the ``out`` kernel ``(NH, hd, out)`` → ``(out, NH·hd)``
* conv / BN / Dense / LayerNorm ``bias`` → ``bias``; BN and LayerNorm
  ``scale`` → ``weight``
* raw parameters, kept in the JAX layout under the same name:
  ``dn_content_embed`` ``(1, 1, C)``; the MoE's ``router_kernel`` ``(d, E)``
  (not a ``Dense`` kernel: never transposed), ``context_bias`` ``(bins, E)``,
  ``experts_w1`` ``(E, d, h)``, ``experts_b1`` ``(E, 1, h)``, ``experts_w2``
  ``(E, h, d)`` and ``experts_b2`` ``(E, 1, d)``
* ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``
  (plus torch's ``num_batches_tracked``, which Flax does not keep)

Any other leaf raises. :func:`quant_tree_to_state_dict` does the same for
the int8 serving tree (``quant.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_RAW_PARAMS = {
    "dn_content_embed", "router_kernel", "context_bias",
    "experts_w1", "experts_b1", "experts_w2", "experts_b2",
}
_QKV = {"query", "key", "value"}


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _param(path, arr: np.ndarray) -> "tuple[str, np.ndarray]":
    """One Flax parameter leaf → (torch key, array in torch layout)."""
    mod, name = ".".join(path[:-1]), path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if name == "kernel" and arr.ndim == 4:
        return f"{mod}.weight", arr.transpose(3, 2, 0, 1)
    if name == "kernel" and arr.ndim == 2:
        return f"{mod}.weight", arr.T
    if name == "kernel" and arr.ndim == 3 and parent in _QKV:
        return f"{mod}.weight", arr.reshape(arr.shape[0], -1).T
    if name == "kernel" and arr.ndim == 3 and parent == "out":
        return f"{mod}.weight", arr.reshape(-1, arr.shape[-1]).T
    if name == "bias" and arr.ndim == 2 and parent in _QKV:
        return f"{mod}.bias", arr.reshape(-1)
    if name in _PARAM_LEAVES and arr.ndim == 1:
        return f"{mod}.{_PARAM_LEAVES[name]}", arr
    if name in _RAW_PARAMS:
        return ".".join(path), arr
    raise ValueError(f"unsupported parameter {'/'.join(path)} {arr.shape}")


def flax_to_state_dict(variables_np: Mapping[str, Any]) -> "Dict[str, torch.Tensor]":
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays → state_dict."""
    unknown = set(variables_np) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unsupported variable collections: {sorted(unknown)}")
    sd: "Dict[str, torch.Tensor]" = {}
    for path, leaf in _walk(variables_np.get("params", {})):
        key, arr = _param(path, np.asarray(leaf))
        sd[key] = torch.from_numpy(arr.copy(order="C"))
    for path, leaf in _walk(variables_np.get("batch_stats", {})):
        mod, name = ".".join(path[:-1]), path[-1]
        if name not in _STAT_LEAVES:
            raise ValueError(f"unsupported batch statistic {'/'.join(path)}")
        sd[f"{mod}.{_STAT_LEAVES[name]}"] = torch.from_numpy(np.asarray(leaf).copy())
        sd.setdefault(f"{mod}.num_batches_tracked", torch.tensor(0, dtype=torch.long))
    return sd


def quant_tree_to_state_dict(quant_np: Mapping[str, Any]) -> "Dict[str, torch.Tensor]":
    """JAX's int8 serving tree ``{"quant": ...}`` (numpy) → the int8 model's
    quant tensors by name. Conv ``w_q`` HWIO → OIHW; every other leaf (the
    scales, biases, and the MoE's ``w1_q`` / ``w2_q`` / ``b1`` / ``b2`` in the
    expert parameters' own layout) is kept as it is, dtype included."""
    unknown = set(quant_np) - {"quant"}
    if unknown:
        raise ValueError(f"unsupported variable collections: {sorted(unknown)}")
    sd: "Dict[str, torch.Tensor]" = {}
    for path, leaf in _walk(quant_np.get("quant", {})):
        arr = np.asarray(leaf)
        if path[-1] == "w_q" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[".".join(path)] = torch.from_numpy(arr.copy(order="C"))
    return sd
