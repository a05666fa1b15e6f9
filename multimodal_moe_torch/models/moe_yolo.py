"""MoE-routed YOLO detector (PyTorch), fp and int8 serving.

Counterpart of ``multimodal_moe_tpu/models/moe_yolo.py``: the YOLO trunk
(backbone + PAN neck), one context-routed :class:`.moe.MoEFFN` on each neck
level (``moe_level{i}``), then the YOLO head and decode; and its training
loss, :func:`moe_yolo_loss`. Each spatial
location of a level is a token, in NHWC row-major order; every token of an
image carries the image's solar-context bin.

With ``int8=True`` the neck's int8 codes go straight into each level's w8a8
expert sweep; the fp32 MoE output is requantized with the calibrated
``s_moe_out_{i}`` for the int8 head (the fp model records ``moe_out{i}_absmax``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..losses.tal import yolo_loss
from ..quant import QT, quantize_to, record_absmax, register_quant
from .moe import NUM_SOLAR_BINS, MoEFFN
from .yolo import YoloDetector, scaled_channels


class MoEYoloDetector(YoloDetector):
    """YOLO trunk + per-level context-routed MoE FFN + detect head.

    ``forward(images, train=False, context_ids=None)`` (the JAX argument
    order: pass ``context_ids`` by keyword) takes NHWC float images and one
    context bin per image (default: the "missing" bin) and returns the
    YOLO outputs plus ``moe_aux_loss`` (the mean over levels) and
    ``expert_load`` ``(3, E)``. The routers stay float32 in a bf16 model.
    Under an active mesh each level's ``moe_aux_loss`` and ``expert_load``
    are the global batch's (``models/moe.py``), and so are their means.
    ``remat`` recomputes the trunk's stages as :class:`.yolo.YoloDetector`'s;
    the MoE levels and the head are not recomputed, as in JAX.
    """

    context_aware = True  # serving.make_serving_step passes context_ids

    def __init__(self, num_classes: int = 1, variant: str = "s", num_experts: int = 4,
                 k: int = 2, capacity_factor: float = 1.25, dispatch: str = "auto",
                 dtype: torch.dtype = torch.float32, arch: str = "tpu",
                 generator: "torch.Generator | None" = None, int8: bool = False,
                 int8_fp_box: bool = False, remat: bool = False):
        super().__init__(num_classes, variant, dtype, arch, generator, int8=int8,
                         int8_fp_box=int8_fp_box, remat=remat)
        for i, c in enumerate(scaled_channels(variant)[2:5]):
            moe = MoEFFN(c, num_experts, k=k, capacity_factor=capacity_factor, dtype=dtype,
                         dispatch=dispatch, generator=generator, int8=int8)
            self.add_module(f"moe_level{i}", moe.to(dtype))
            if int8:
                register_quant(self, f"s_moe_out_{i}", torch.ones(()))

    def forward(self, images: torch.Tensor, train: bool = False,
                context_ids: "Optional[torch.Tensor]" = None) -> "Dict[str, torch.Tensor]":
        self._check_mode(train)
        b = images.shape[0]
        if context_ids is None:
            context_ids = torch.full((b,), NUM_SOLAR_BINS - 1, dtype=torch.long)
        context_ids = context_ids.to(images.device, torch.long)
        feats = self.neck(self.backbone(self._input(images)))

        aux_total, loads, moe_feats = 0.0, [], []
        for i, f in enumerate(feats):
            quant = isinstance(f, QT)
            bb, c, h, w = (f.q if quant else f).shape
            to_tokens = lambda m: m.permute(0, 2, 3, 1).reshape(bb * h * w, c)  # noqa: E731
            tokens = QT(to_tokens(f.q), f.s) if quant else to_tokens(f)
            token_ctx = torch.repeat_interleave(context_ids, h * w)
            out_tokens, aux = getattr(self, f"moe_level{i}")(tokens, token_ctx)
            out_map = out_tokens.reshape(bb, h, w, c).permute(0, 3, 1, 2)
            if quant:
                s_moe = getattr(self, f"s_moe_out_{i}")
                out_map = QT(quantize_to(out_map.float(), s_moe), s_moe)
            else:
                record_absmax(self, f"moe_out{i}_absmax", out_map)
            moe_feats.append(out_map)
            aux_total = aux_total + aux["moe_aux_loss"]
            loads.append(aux["expert_load"])

        out = self._head_outputs(moe_feats, images)
        out["moe_aux_loss"] = aux_total / len(feats)
        out["expert_load"] = torch.stack(loads)                   # (levels, E)
        return out


def moe_yolo_loss(outputs, gt_labels, gt_boxes, gt_mask):
    """YOLO detection loss plus the MoE auxiliary loss (in the metrics as
    ``moe_aux_loss``; ``loss`` is the total)."""
    total, metrics = yolo_loss(outputs, gt_labels, gt_boxes, gt_mask)
    aux = outputs.get("moe_aux_loss")
    if aux is not None:
        total = total + aux
        metrics = dict(metrics, moe_aux_loss=aux, loss=total)
    return total, metrics
