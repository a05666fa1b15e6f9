"""Faults planted in the program under test, to show that a cell's check
fails them: the timed path broken underneath, the harness unchanged. Used
by ``gpubench/calibrate.py`` and the tests; never by a benchmark run.

* ``half_batch``: the second half of every batch is left out (the first
  half takes its place), so a step's outputs cover half the images it was
  given; in training the loss is the mean over the rest.
* ``answer_altered``: one answer is changed where it is produced (the
  first score of a serving step's result; in training, the gradient of the
  tensor with the largest one doubled before the optimizer takes it).
* ``unchanged``: the train step returns its state unchanged.
"""

from __future__ import annotations

import torch

FAULTS = ("half_batch", "answer_altered", "unchanged")


def _half(t: torch.Tensor) -> torch.Tensor:
    h = t.shape[0] // 2
    return torch.cat([t[:h], t[:t.shape[0] - h]]) if h else t


def plant(name: str):
    """Patch the port with fault ``name``; return the function that undoes it."""
    from multimodal_moe_torch import serving
    from multimodal_moe_torch.ops.nms import NmsResult
    from multimodal_moe_torch.train.detection import DetectionTrainer

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    saved = [(serving, "make_serving_step", serving.make_serving_step),
             (DetectionTrainer, "train_step", DetectionTrainer.train_step)]
    make_step, train_step = serving.make_serving_step, DetectionTrainer.train_step

    def broken_make_step(model, **kw):
        step = make_step(model, **kw)

        def broken(images, context_ids=None):
            images = torch.as_tensor(images)
            if name == "half_batch":
                images = _half(images)
                context_ids = None if context_ids is None else _half(torch.as_tensor(context_ids))
            res = step(images, context_ids)
            if name == "answer_altered":
                scores = res.scores.clone()
                scores[0, 0] += 1e-3
                res = NmsResult(res.boxes, scores, res.classes, res.valid)
            return res

        return broken

    def broken_train_step(self, state, batch, draws=None):
        if name == "unchanged":
            return state, {"loss": torch.zeros((), device=batch["image"].device)}
        if name == "half_batch":
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return train_step(self, state, batch, draws)
        apply = state.apply_gradients

        def doubled(grads):
            top = max(grads, key=lambda k: float(torch.linalg.vector_norm(grads[k])))
            return apply(dict(grads, **{top: grads[top] * 2}))

        state.apply_gradients = doubled
        try:
            return train_step(self, state, batch, draws)
        finally:
            del state.apply_gradients

    serving.make_serving_step = broken_make_step
    DetectionTrainer.train_step = broken_train_step

    def undo():
        for obj, attr, value in saved:
            setattr(obj, attr, value)

    return undo
