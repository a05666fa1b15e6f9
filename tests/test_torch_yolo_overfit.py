"""The overfit gate of tests/test_learnability.py on the port: YOLO-n
trained with the port's ``yolo_loss`` on the same synthetic set (8 frames
of 64×128, 1–3 bright rectangles each) for 150 Adam steps at lr 2e-3 on
the CPU, in train mode (batch statistics), then evaluated in eval mode
through the port's ``batched_nms`` (IoU 0.7, score threshold 0.05,
max_det 20) and the port's own copy of ``evaluate_detections`` (COCO mAP,
numpy), which must give the JAX package's metrics exactly. The gate is the
JAX test's: the loss halves, mAP50 > 0.6 and recall > 0.6. This exercises
assignment → losses → optimizer → decode → NMS → mAP end to end.
"""

import numpy as np
import torch

from multimodal_moe_torch.losses.tal import yolo_loss
from multimodal_moe_torch.models.yolo import YoloDetector
from multimodal_moe_torch.ops.coco_map import evaluate_detections
from multimodal_moe_torch.ops.nms import batched_nms
from multimodal_moe_tpu.ops import coco_map as jax_coco_map
from test_learnability import H, N_IMG, W, _make_dataset


def test_port_detector_overfits_to_high_map():
    # Two intra-op threads: at 64×128 more threads gain nothing here, and
    # the suite runs several pytest workers side by side.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        _overfit()
    finally:
        torch.set_num_threads(threads)


def _overfit():
    images, gt_boxes, gt_labels, gt_mask = (torch.from_numpy(np.array(a)) for a in _make_dataset())
    torch.manual_seed(0)
    model = YoloDetector(num_classes=1, variant="n", generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    x = images.float() / 255.0
    model.train()
    losses = []
    for _ in range(150):
        total, _ = yolo_loss(model(x, train=True), gt_labels, gt_boxes, gt_mask)
        opt.zero_grad()
        total.backward()
        opt.step()
        losses.append(total.item())
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])

    model.eval()
    with torch.inference_mode():
        out = model(x)
        nms = batched_nms(out["boxes"], torch.sigmoid(out["cls_logits"][..., 0]),
                          iou_threshold=0.7, score_threshold=0.05, max_det=20)
    det_boxes, det_scores, gts = [], [], []
    for i in range(N_IMG):
        keep = nms.valid[i].numpy()
        det_boxes.append(nms.boxes[i].numpy()[keep])
        det_scores.append(nms.scores[i].numpy()[keep])
        gts.append(gt_boxes[i].numpy()[gt_mask[i].numpy()])
    m = evaluate_detections(det_boxes, det_scores, gts, compute_curves=False)
    ref = jax_coco_map.evaluate_detections(det_boxes, det_scores, gts, compute_curves=False)
    assert m.to_metrics_dict() == ref.to_metrics_dict()
    assert (H, W) == tuple(images.shape[1:3])
    assert m.map50 > 0.6, f"map50={m.map50} (ap_per_iou={m.ap_per_iou})"
    assert m.recall > 0.6, f"recall={m.recall}"
