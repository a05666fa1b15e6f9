"""Offline scoring of recorded drives with RT-DETR: a closed loop of
serving steps, as ``predict_detector`` and ``eval_detector`` run it.

A pool of ``pool_batches × batch`` distinct seeded uint8 frames lies on the
card. Each step takes the next batch through the port's serving step
(``serving.make_serving_step``: /255, the model in bf16, sigmoid, the
NMS-free top-``max_det`` tail) and reads its ``NmsResult`` back before the
next step starts. ``serve_img_s`` is the images read back in the window
over the window's seconds.

The check, after the window. One step on each batch of the pool, at a step
drawn from the seed, is captured: the final logits and boxes (a forward
hook), the encoder's logits over every anchor and the program's own
top-``Q`` anchors (``rtdetr_common.SelectionCapture``). On a seeded sample
of the images the float32 reference, given the program's top-``Q``,
computes the same outputs: ``logit_err`` and ``box_err`` (relative L2 of the
final logits and of the boxes), ``enc_err`` (of the encoder's logits over
every anchor). ``select_gap`` counts the anchors in which the program's
selection and the reference's own differ and whose reference score lies
further from the reference's ``Q``-th than twice the image's largest
encoder-logit difference: no selection consistent with the program's own
scores can differ there. The reference tail on each batch's captured
outputs gives its expected ``NmsResult``: every result read back in the
window must equal it bit for bit (``tail_mismatch``).
"""

from __future__ import annotations

import gc
import time

import torch

from .. import common, rtdetr_common
from ..reference import rtdetr as ref
from .offline import _read, rel_err


def detr_tail(cls_logits, boxes, *, max_det: int, score_threshold: float) -> tuple:
    """The reference of the NMS-free tail: sigmoid scores, the ``max_det``
    best queries (stable: the lower query first among equal scores), those
    at or under the threshold zeroed (boxes 0, score 0, class -1)."""
    scores = torch.sigmoid(cls_logits[..., 0].float())
    k = min(max_det, scores.shape[-1])
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    picked = torch.gather(boxes.float(), 1, idx[..., None].expand(-1, -1, 4))
    valid = top > score_threshold
    return (torch.where(valid[..., None], picked, 0.0), torch.where(valid, top, 0.0),
            torch.where(valid, 0, -1).to(torch.int32), valid)


def select_gap(prog_topk, prog_enc, ref_enc, valid, q: int) -> int:
    """Anchors of the symmetric difference of the program's and the
    reference's top-``q`` whose reference score lies further than 2δ from
    the reference's ``q``-th, δ the image's largest |program − reference|
    encoder logit over the valid anchors; a program pick that is no anchor
    (index -1) counts too."""
    gap = 0
    for i in range(prog_topk.shape[0]):
        scores = ref_enc[i].masked_fill(~valid, -1e9)
        order = torch.sort(scores, descending=True, stable=True).indices
        kth = scores[order[q - 1]]
        delta = float((prog_enc[i] - ref_enc[i])[valid].abs().max())
        picks = prog_topk[i]
        gap += int((picks < 0).sum())
        mine = set(picks[picks >= 0].tolist())
        theirs = set(order[:q].tolist())
        diff = torch.tensor(sorted(mine ^ theirs), dtype=torch.long, device=scores.device)
        if diff.numel():
            gap += int(((scores[diff] - kth).abs() > 2 * delta).sum())
    return gap


class RTDETROffline:
    def __init__(self, run):
        from multimodal_moe_torch import serving

        self.run = run
        cell, cfg, dev = run.cell, run.config, run.device
        self.B, self.nb = cell["batch"], cell["pool_batches"]
        dtype = common.torch_dtype(cell)
        n = self.B * self.nb
        self.frames = common.make_frames(n, cell["img_h"], cell["img_w"], run.seed, dev)
        run.mark("frames")
        self.weights = rtdetr_common.make_weights(rtdetr_common.weight_shapes(cfg, dtype), cfg,
                                                  run.seed, dev)
        rtdetr_common.fit_to_frames(self.weights, cfg, self.frames[:4])
        run.mark("weights")
        self.model = rtdetr_common.build_model(cfg, dtype, dev, self.weights)
        self.tail_kw = dict(score_threshold=cell["score_threshold"], max_det=cell["max_det"])
        self.step = serving.make_serving_step(self.model, **self.tail_kw)
        gen = torch.Generator().manual_seed(run.seed)
        self.capture_from = 1 + int(torch.randint(0, self.nb, (1,), generator=gen))
        self.sample = torch.randperm(n, generator=gen)[:cell["check_images"]].sort().values
        self.captured: dict = {}
        self.results: list = []
        self.i = 0
        self.selection = rtdetr_common.SelectionCapture(self.model)
        self._hook = self.model.register_forward_hook(self._capture)

    def _capture(self, module, inputs, out) -> None:
        if self.selection.on:
            enc, topk = self.selection.taken.pop()
            self.captured[self.i % self.nb] = (out["cls_logits"].clone(), out["boxes"].clone(),
                                               enc, topk)

    def call(self):
        j = self.i % self.nb
        self.selection.on = self.capture_from <= self.i < self.capture_from + self.nb
        res = _read(self.step(self.frames[j * self.B:(j + 1) * self.B]))
        self.results.append((j, res))
        self.i += 1

    def warm_up(self) -> None:
        for j in range(self.nb):
            _read(self.step(self.frames[j * self.B:(j + 1) * self.B]))
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def window(self) -> None:
        run = self.run
        need = self.capture_from + self.nb
        prof_at = need + 1 if run.trace else None
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        while self.i < need or time.perf_counter() < deadline \
                or (prof_at is not None and self.i <= prof_at):
            if self.i == prof_at:
                self._profiled_stretch()
            else:
                self.call()
        run.window_elapsed = time.perf_counter() - t0
        images = self.i * self.B
        run.e2e["serve_img_s"] = images / run.window_elapsed
        run.attempted = images
        if run.device.type == "cuda":
            run.memory_peak = torch.cuda.max_memory_allocated(run.device)

    def _profiled_stretch(self) -> None:
        run, dev = self.run, self.run.device
        steps = run.cell["profile_steps"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(dev)
        first = self.i
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                self.call()
            t1 = time.perf_counter()
        red = common.reduce_trace(prof)
        run.busy_s, run.window_s = red["busy_s"], t1 - t0
        run.breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        run.layer.update(kind="serve", steps=steps, images=steps * self.B, stretch_s=t1 - t0,
                         events=red["events"], profiled_batches=[
                             j for j, _ in self.results[first:first + steps]],
                         weight_shapes={k: tuple(v.shape) for k, v in self.weights.items()})

    def sampled_work(self) -> None:
        """The sampling locations of the profiled steps' batches, taken
        again after the window: each decoder layer's distinct value rows and
        corners (``deform_rooflines.sampled_work``), in the order of the
        stretch's ``rtdetr.deform`` calls."""
        batches = self.run.layer.get("profiled_batches")
        if not batches:
            return

        def forward():
            with torch.inference_mode():
                for j in batches:
                    self.model(self.frames[j * self.B:(j + 1) * self.B].float() / 255.0)

        self.run.layer["deform_work"] = rtdetr_common.sampled_work(
            self.model, self.run.config["num_decoder_layers"], forward)

    def free_program(self) -> None:
        self._hook.remove()
        self.selection.remove()
        del self.step, self.model
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample_rows(self) -> "tuple[torch.Tensor, dict]":
        rows = {}
        for i in self.sample.tolist():
            cls, boxes, enc, topk = self.captured[i // self.B]
            r = i % self.B
            for key, t in (("cls", cls), ("boxes", boxes), ("enc", enc), ("topk", topk)):
                rows.setdefault(key, []).append(t[r])
        return self.sample, {k: torch.stack(v) for k, v in rows.items()}

    def reference(self, idx, topk, prec=None) -> dict:
        """The reference's final logits, boxes and encoder logits (every
        anchor) on frames ``idx``, given the program's selection ``topk`` (a
        block of images where a program pick is no anchor takes its own)."""
        w32 = {k: v.float() for k, v in self.weights.items()}
        out = {"cls": [], "boxes": [], "enc": []}
        for s in range(0, len(idx), 8):
            rows = idx[s:s + 8].to(self.frames.device)
            given = topk[s:s + 8]
            o = ref.forward(w32, self.run.config, self.frames[rows], prec=prec,
                            topk=given if bool((given >= 0).all()) else None)
            out["cls"].append(o["cls_logits"])
            out["boxes"].append(o["boxes"])
            out["enc"].append(o["enc_logits"][..., 0])
        return {k: torch.cat(v) for k, v in out.items()}

    def check(self) -> None:
        run = self.run
        bad = 0
        expected = {j: _read(detr_tail(c, b, **self.tail_kw))
                    for j, (c, b, _, _) in self.captured.items()}
        for j, res in self.results:
            same = torch.ones(res[0].shape[0], dtype=torch.bool)
            for got, want in zip(res, expected[j]):
                if got.dtype == torch.float32:
                    got, want = got.view(torch.int32), want.view(torch.int32)
                same &= (got == want).flatten(1).all(1)
            bad += int((~same).sum())
        idx, prog = self._sample_rows()
        want = self.ref = self.reference(idx, prog["topk"])
        cfg = run.config
        level_shapes = [(run.cell["img_h"] // s, run.cell["img_w"] // s) for s in (8, 16, 32)]
        _, valid = ref.anchors(level_shapes, prog["enc"].device)
        run.check("logit_err", rel_err(prog["cls"], want["cls"]))
        run.check("box_err", rel_err(prog["boxes"], want["boxes"]))
        run.check("enc_err", rel_err(prog["enc"], want["enc"]))
        run.check("select_gap", select_gap(prog["topk"], prog["enc"], want["enc"], valid,
                                           cfg["num_queries"]), 0)
        run.check("tail_mismatch", bad, 0)

    def control(self, kind: str) -> dict:
        """The reference in a lower precision put in the program's place,
        given the same selection: its readings of the output comparisons."""
        from ..reference.detector import Prec

        idx, prog = self._sample_rows()
        got = self.reference(idx, prog["topk"], Prec(kind))
        return {"logit_err": rel_err(got["cls"], self.ref["cls"]),
                "box_err": rel_err(got["boxes"], self.ref["boxes"]),
                "enc_err": rel_err(got["enc"], self.ref["enc"])}


def run(run) -> None:
    off = run.state = RTDETROffline(run)
    off.warm_up()
    run.mark("warm_up")
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    off.window()
    off.sampled_work()
    off.free_program()
    with common.reference_precision():
        off.check()
