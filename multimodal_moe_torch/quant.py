"""Post-training int8 quantization for the detector serving path.

Counterpart of ``multimodal_moe_tpu/quant.py``, with the same scheme (w8a8
PTQ):

* weights: BatchNorm folded into the conv, then symmetric per-output-channel
  int8 (``w_q = rint(w' / s_w[c])``);
* activations: symmetric per-tensor int8 with static scales from
  calibration (``s_out = absmax / 127``);
* accumulation: exact int32 (``ops/int8_conv.py``, ``torch._int_mm``), the
  epilogue in fp32 or bf16 (``models/layers.apply_i8_epilogue``);
* residual adds requantize with their own calibrated scale; concats
  requantize every part to the largest participating scale; max-pool,
  space-to-depth and nearest upsampling act on the codes;
* the head's 1×1 prediction convs dequantize to fp32, so decode and NMS are
  unchanged.

Flax's ``sow('qcal', ...)`` becomes a recorder: an fp module that sows in
JAX calls :func:`record_absmax`, which stores the statistic under the
module's path while :func:`calibrate` runs and returns at once otherwise.
:func:`calibrate` returns JAX's ``qcal`` tree: the same paths and leaf names.

An int8 module registers its quant tensors as buffers with
:func:`register_quant`, on the module whose path the JAX model gives the
``quant`` collection; the quant tree built here is JAX's (conv weights HWIO),
so ``save_quant_npz`` / ``load_quant_npz`` files pass between the packages,
and ``convert.quant_tree_to_state_dict`` carries a tree onto the port's
tensors (weights OIHW). The folding arithmetic is a copy of JAX's, in float64
numpy on the same float32 weights, so it gives the same codes bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, NamedTuple

import numpy as np
import torch

from ._device import model_device

BN_EPS = 1e-3  # models.layers.ConvBNAct's BatchNorm epsilon
RESNET_BN_EPS = 1e-5  # models.resnet._ConvBN's BatchNorm epsilon
MIN_SCALE = 1e-12


class QT(NamedTuple):
    """A quantized activation: ``x ≈ q · s``, ``q`` int8 (NCHW in the
    detectors), ``s`` a 0-d float32 scale. A module given a ``QT`` takes its
    int8 branch."""

    q: torch.Tensor
    s: torch.Tensor


def quantize_to(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp → int8 with symmetric scale ``s``: round half to even, clip ±127."""
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


def dequantize(x: QT) -> torch.Tensor:
    return x.q.float() * x.s


def q_from_images(images: torch.Tensor) -> QT:
    """Normalized [0, 1] NHWC images → int8 codes at the static scale 1/127,
    returned NCHW (a channels-last view of the NHWC codes)."""
    s = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=images.device)
    q = torch.clamp(torch.round(images.float() * 127.0), -127, 127).to(torch.int8)
    return QT(q.permute(0, 3, 1, 2), s)


def qcat(xs: "list[QT]", dim: int = 1) -> QT:
    """Concatenate QTs along ``dim`` (channels), requantizing every part to
    the largest participating scale. Parts that share one scale tensor (SPPF's
    pools of one map) skip the rescale."""
    if all(x.s is xs[0].s for x in xs):
        return QT(torch.cat([x.q for x in xs], dim=dim), xs[0].s)
    s_t = xs[0].s
    for x in xs[1:]:
        s_t = torch.maximum(s_t, x.s)
    parts = [torch.clamp(torch.round(x.q.float() * (x.s / s_t)), -127, 127).to(torch.int8)
             for x in xs]
    return QT(torch.cat(parts, dim=dim), s_t)


def q_split2(x: QT, dim: int = 1) -> "tuple[QT, QT]":
    a, b = x.q.chunk(2, dim=dim)
    return QT(a, x.s), QT(b, x.s)


def max_pool_codes(q: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """Max-pool int8 codes (padding never wins: codes are ≥ −127). Pooled in
    float16, where every code is exact: CPU ``max_pool2d`` refuses int8 in
    channels-last layout."""
    return torch.nn.functional.max_pool2d(q.half(), kernel, stride, padding).to(torch.int8)


def register_quant(module: torch.nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Register ``tensor`` as a buffer of ``module`` and as one of its quant
    leaves (the ``quant`` collection of the JAX module at the same path)."""
    module.register_buffer(name, tensor)
    module._quant_leaves = getattr(module, "_quant_leaves", ()) + (name,)


def quant_leaves(model: torch.nn.Module):
    """``(module path, leaf name, tensor)`` of every quant buffer of ``model``."""
    for path, mod in model.named_modules():
        for leaf in getattr(mod, "_quant_leaves", ()):
            yield path, leaf, getattr(mod, leaf)


# --------------------------------------------------------------------------
# Calibration (fp model, the recorder in place of the 'qcal' collection)
# --------------------------------------------------------------------------

_RECORDERS: "list[_Recorder]" = []


class _Recorder:
    def __init__(self, model: torch.nn.Module):
        self.paths = {id(m): name.replace(".", "/") for name, m in model.named_modules()}
        self.stats: "Dict[str, torch.Tensor]" = {}

    def add(self, module: torch.nn.Module, leaf: str, value: torch.Tensor) -> None:
        path = self.paths[id(module)]
        key = f"{path}/{leaf}" if path else leaf
        prev = self.stats.get(key)
        # sow's reduce_fn=max over an init of zeros
        self.stats[key] = torch.clamp_min(value, 0.0) if prev is None else torch.maximum(prev, value)


def recording() -> bool:
    """Whether a calibration recorder is active."""
    return bool(_RECORDERS)


def record(module: torch.nn.Module, leaf: str, value: torch.Tensor) -> None:
    """Record the statistic ``value`` as ``leaf`` of ``module``'s node while
    :func:`calibrate` runs (the max over calls); do nothing otherwise."""
    if _RECORDERS:
        _RECORDERS[-1].add(module, leaf, value.detach().float())


def record_absmax(module: torch.nn.Module, leaf: str, x: torch.Tensor) -> None:
    """:func:`record` of ``max |x|``, computed only while recording."""
    if _RECORDERS:
        record(module, leaf, x.detach().abs().amax())


def unflatten(flat: "Mapping[str, Any]") -> Dict:
    """``{'a/b/c': leaf}`` → ``{'a': {'b': {'c': leaf}}}``."""
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def flatten(tree: Mapping, prefix: str = "") -> "Dict[str, Any]":
    """The inverse of :func:`unflatten`."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


def calibrate(model: torch.nn.Module, batches: Iterable, mode: str = "absmax",
              **forward_kwargs) -> Dict:
    """Run the fp ``model`` (eval mode, on its own device) over ``batches``
    (normalized [0, 1] NHWC image arrays or tensors) and return the ``qcal``
    tree of numpy float32 statistics.

    ``mode``: ``absmax`` — the running max of |activation| over all batches;
    ``avgmax`` — the mean over batches of each batch's absmax."""
    if mode not in ("absmax", "avgmax"):
        raise ValueError(f"unknown calibration mode {mode!r}")
    dev = model_device(model)
    kwargs = {k: torch.as_tensor(v, device=dev) if isinstance(v, (np.ndarray, torch.Tensor)) else v
              for k, v in forward_kwargs.items()}
    was_training = model.training
    model.eval()
    per_batch = []
    try:
        for images in batches:
            rec = _Recorder(model)
            _RECORDERS.append(rec)
            try:
                with torch.inference_mode():
                    model(torch.as_tensor(images, device=dev).float(), **kwargs)
            finally:
                _RECORDERS.pop()
            per_batch.append({k: v.cpu().numpy().astype(np.float32) for k, v in rec.stats.items()})
    finally:
        model.train(was_training)
    if not per_batch:
        raise ValueError("calibrate() needs at least one batch")
    if mode == "absmax":
        flat = {k: np.maximum.reduce([b[k] for b in per_batch]) for k in per_batch[0]}
    else:
        flat = {k: sum(np.asarray(b[k], np.float32) for b in per_batch) / len(per_batch)
                for k in per_batch[0]}
    return unflatten(flat)


# --------------------------------------------------------------------------
# Conversion: fp weights + calibration statistics → the 'quant' tree
# --------------------------------------------------------------------------


def _np(sd: Mapping, key: str) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def _hwio(oihw: np.ndarray) -> np.ndarray:
    return oihw.transpose(2, 3, 1, 0)


def _fold_convbn(sd: Mapping, path: str, qcal_node) -> Dict[str, np.ndarray]:
    """Conv + BN (+ calibrated out absmax) → {w_q, s_w, b, s_out}, w_q HWIO.
    ``layers.ConvBNAct`` names its children ``conv``/``bn`` (eps 1e-3),
    ``resnet._ConvBN`` ``Conv_0``/``BatchNorm_0`` (eps 1e-5)."""
    if f"{path}.conv.weight" in sd:
        conv_key, bn_key, eps = "conv", "bn", BN_EPS
    else:
        conv_key, bn_key, eps = "Conv_0", "BatchNorm_0", RESNET_BN_EPS
    kernel = _hwio(_np(sd, f"{path}.{conv_key}.weight"))  # (k, k, cin, cout)
    gamma = _np(sd, f"{path}.{bn_key}.weight")
    beta = _np(sd, f"{path}.{bn_key}.bias")
    mean = _np(sd, f"{path}.{bn_key}.running_mean")
    var = _np(sd, f"{path}.{bn_key}.running_var")
    inv = gamma / np.sqrt(var + eps)
    w = kernel * inv
    b = beta - mean * inv
    s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, MIN_SCALE)
    w_q = np.clip(np.rint(w / s_w), -127, 127).astype(np.int8)
    s_out = np.maximum(float(np.asarray(qcal_node["out_absmax"])) / 127.0, MIN_SCALE)
    return {"w_q": w_q, "s_w": np.asarray(s_w, np.float32), "b": np.asarray(b, np.float32),
            "s_out": np.asarray(s_out, np.float32)}


def _fold_predconv(sd: Mapping, path: str) -> Dict[str, np.ndarray]:
    """A plain 1×1 prediction conv → {w_q, s_w, b} (fp32 output)."""
    kernel = _hwio(_np(sd, f"{path}.weight"))
    bias = _np(sd, f"{path}.bias")
    s_w = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)) / 127.0, MIN_SCALE)
    w_q = np.clip(np.rint(kernel / s_w), -127, 127).astype(np.int8)
    return {"w_q": w_q, "s_w": np.asarray(s_w, np.float32), "b": np.asarray(bias, np.float32)}


def _fold_moe_ffn(sd: Mapping, path: str, qcal_node) -> Dict[str, np.ndarray]:
    """Expert FFN weights (+ calibrated per-expert mid absmax) →
    {w1_q, s_w1, b1, s_mid, w2_q, s_w2, b2}: per-expert-per-output-channel
    weight scales; the fp32 router keeps its own weights."""
    w1 = _np(sd, f"{path}.experts_w1")  # (E, d, h)
    b1 = _np(sd, f"{path}.experts_b1")
    w2 = _np(sd, f"{path}.experts_w2")  # (E, h, d)
    b2 = _np(sd, f"{path}.experts_b2")
    s_w1 = np.maximum(np.abs(w1).max(axis=1) / 127.0, MIN_SCALE)  # (E, h)
    w1_q = np.clip(np.rint(w1 / s_w1[:, None, :]), -127, 127).astype(np.int8)
    s_w2 = np.maximum(np.abs(w2).max(axis=1) / 127.0, MIN_SCALE)  # (E, d)
    w2_q = np.clip(np.rint(w2 / s_w2[:, None, :]), -127, 127).astype(np.int8)
    s_mid = np.maximum(np.asarray(qcal_node["mid_absmax"], np.float64) / 127.0, MIN_SCALE)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"w1_q": w1_q, "s_w1": f32(s_w1), "b1": f32(b1), "s_mid": f32(s_mid),
            "w2_q": w2_q, "s_w2": f32(s_w2), "b2": f32(b2)}


def _jax_shape(leaf: str, t: torch.Tensor) -> tuple:
    shape = tuple(t.shape)
    return (shape[2], shape[3], shape[1], shape[0]) if leaf == "w_q" and t.dim() == 4 else shape


def build_quant_variables(model_q: torch.nn.Module, fp_variables: Mapping, qcal: Mapping) -> Dict:
    """The ``{'quant': ...}`` tree (numpy, JAX's layout) for the int8 model.

    ``model_q`` is the detector built with ``int8=True``: its registered
    quant buffers give the tree's structure and shapes. ``fp_variables`` is
    the fp model's ``state_dict`` and ``qcal`` the :func:`calibrate` tree
    (or JAX's); the values fold the one with the other."""
    modules: "Dict[str, Dict[str, tuple]]" = {}
    for path, leaf, t in quant_leaves(model_q):
        modules.setdefault(path, {})[leaf] = _jax_shape(leaf, t)

    def qcal_node(path: str):
        node = qcal
        for p in path.split(".") if path else ():
            node = node.get(p, {}) if isinstance(node, Mapping) else {}
        return node

    flat: "Dict[str, np.ndarray]" = {}
    for path, leaves in modules.items():
        node = qcal_node(path)
        prefix = path.replace(".", "/")
        if "w1_q" in leaves:
            built = _fold_moe_ffn(fp_variables, path, node)
        elif "w_q" in leaves and "s_out" in leaves:
            built = _fold_convbn(fp_variables, path, node)
        elif "w_q" in leaves:
            built = _fold_predconv(fp_variables, path)
        else:
            built = {}
            for k in leaves:
                # requant scale ↔ calibrated absmax: 's_<stem>_<i>' reads
                # '<stem><i>_absmax' (s_add_0 ↔ add0_absmax, s_moe_out_1 ↔
                # moe_out1_absmax, s_aifi_0 ↔ aifi0_absmax)
                stem, idx = k[2:].rsplit("_", 1)
                absmax = float(np.asarray(node[f"{stem}{idx}_absmax"]))
                built[k] = np.asarray(max(absmax / 127.0, MIN_SCALE), np.float32)
        if set(built) != set(leaves):
            raise ValueError(f"quant node {prefix}: built {sorted(built)}, model has {sorted(leaves)}")
        for k, v in built.items():
            name = f"{prefix}/{k}" if prefix else k
            if tuple(v.shape) != leaves[k]:
                raise ValueError(f"quant leaf {name}: shape {v.shape} != expected {leaves[k]}")
            flat[name] = v
    return {"quant": unflatten(flat)}


def quantize_detector(model_fp: torch.nn.Module, model_q: torch.nn.Module, calib_batches,
                      mode: str = "absmax", **forward_kwargs) -> Dict:
    """One-call PTQ: calibrate ``model_fp`` on ``calib_batches``, then fold
    its weights into the quant tree of ``model_q``."""
    qcal = calibrate(model_fp, list(calib_batches), mode=mode, **forward_kwargs)
    return build_quant_variables(model_q, model_fp.state_dict(), qcal)


def merge_serving_variables(quant_vars: Mapping, fp_variables: Mapping) -> Dict:
    """Serving variables for a partially quantized model: the int8 branches
    read ``quant``, the fp islands (MoE routers, RT-DETR AIFI and decoder,
    the fp box branch) ``params``, the fp model's ``state_dict``."""
    return {**quant_vars, "params": fp_variables}


def load_serving(model_q: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load serving variables (``{'quant': tree}``, or with ``params`` from
    :func:`merge_serving_variables`) into the int8 ``model_q``: every tensor
    of the model must be filled (``strict=True``). Tensors the model does
    not hold are left out, as Flax ignores unused variables: the fp weights
    of quantized blocks, and the box branch's quant leaves under ``fp_box``
    (the npz is always the full-int8 model's tree)."""
    from .convert import quant_tree_to_state_dict

    own = model_q.state_dict()
    sd = {**variables.get("params", {}), **quant_tree_to_state_dict({"quant": variables["quant"]})}
    model_q.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=True)
    return model_q


# --------------------------------------------------------------------------
# Flat (de)serialization of the quant tree, JAX's names
# --------------------------------------------------------------------------


def save_quant_npz(path, quant_variables: Mapping) -> None:
    arrays = {name: np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor) else leaf)
              for name, leaf in flatten(quant_variables).items()}
    np.savez(path, **arrays)


def load_quant_npz(path) -> Dict:
    with np.load(path) as data:
        return unflatten({name: data[name] for name in data.files})

