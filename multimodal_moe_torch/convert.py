"""Weight bridge: a Flax variables tree (as numpy) → a torch ``state_dict``.

The caller turns the JAX arrays into numpy first (``jax.device_get``), so
this module never sees JAX. The torch modules carry the Flax names, so the
map is mechanical:

* conv ``kernel`` HWIO → ``weight`` OIHW
* conv / BN ``bias`` → ``bias``; BN ``scale`` → ``weight``
* ``batch_stats`` ``mean`` / ``var`` → ``running_mean`` / ``running_var``
  (plus torch's ``num_batches_tracked``, which Flax does not keep)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables_np: Mapping[str, Any]) -> "Dict[str, torch.Tensor]":
    """``{"params": ..., "batch_stats": ...}`` of numpy arrays → state_dict."""
    unknown = set(variables_np) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unsupported variable collections: {sorted(unknown)}")
    sd: "Dict[str, torch.Tensor]" = {}
    for path, leaf in _walk(variables_np.get("params", {})):
        arr = np.asarray(leaf)
        mod, name = ".".join(path[:-1]), path[-1]
        if name == "kernel" and arr.ndim == 4:
            sd[f"{mod}.weight"] = torch.from_numpy(arr.transpose(3, 2, 0, 1).copy())
        elif name in _PARAM_LEAVES:
            sd[f"{mod}.{_PARAM_LEAVES[name]}"] = torch.from_numpy(arr.copy())
        else:
            raise ValueError(f"unsupported parameter {'/'.join(path)} {arr.shape}")
    for path, leaf in _walk(variables_np.get("batch_stats", {})):
        mod, name = ".".join(path[:-1]), path[-1]
        if name not in _STAT_LEAVES:
            raise ValueError(f"unsupported batch statistic {'/'.join(path)}")
        sd[f"{mod}.{_STAT_LEAVES[name]}"] = torch.from_numpy(np.asarray(leaf).copy())
        sd.setdefault(f"{mod}.num_batches_tracked", torch.tensor(0, dtype=torch.long))
    return sd
