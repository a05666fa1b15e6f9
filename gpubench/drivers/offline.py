"""Offline scoring of recorded drives: a closed loop of serving steps.

A pool of ``pool_batches × batch`` distinct seeded uint8 frames (and, for
a context-routed model, one solar bin a frame) lies on the card. Each step
takes the next batch of the pool through the port's serving step
(``serving.make_serving_step``: /255, the forward, sigmoid, the NMS tail
with the B1 keep-mask kernel) and reads its ``NmsResult`` back to the host
before the next step starts. ``serve_img_s`` is the images read back in the
window over the window's seconds.

The check, after the window: the model's outputs (class logits and boxes)
of one step on each batch of the pool are captured by a forward hook at a
step drawn from the seed. A seeded sample of their images runs through the
float32 reference, and their class logits and box distances must lie
within the cell's limits of it (relative L2 over the whole sample). The
reference tail, run on those captured outputs, gives each batch's expected
``NmsResult``: every result read back in the window must equal it bit for
bit.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import common
from ..reference import detector, nms


def _read(res) -> tuple:
    return tuple(t.cpu() for t in res)


def rel_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """‖prog − ref‖ / ‖ref‖ over every value of the sample together."""
    return float((prog.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30))


def _ltrb(boxes: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points - boxes[..., :2], boxes[..., 2:] - points], -1)


class Offline:
    """Set-up, window and check of one offline run, kept apart so that the
    calibration script can drive each part."""

    def __init__(self, run):
        from multimodal_moe_torch import serving

        self.run = run
        cell, cfg, dev = run.cell, run.config, run.device
        self.B, self.nb = cell["batch"], cell["pool_batches"]
        self.moe = bool(cfg.get("num_experts"))
        dtype = common.torch_dtype(cell)
        n = self.B * self.nb
        self.frames = common.make_frames(n, cell["img_h"], cell["img_w"], run.seed, dev)
        self.bins = (common.make_bins(n, cfg["num_context_bins"], run.seed, dev)
                     if self.moe else None)
        run.mark("frames")
        self.weights = common.make_weights(common.weight_shapes(cfg, dtype), run.seed, dev)
        common.fit_to_frames(self.weights, cfg, self.frames[:4],
                             None if self.bins is None else self.bins[:4])
        run.mark("weights")
        self.model = common.build_model(cfg, dtype, dev, self.weights)
        self.tail_kw = dict(pool=cell["pool"], iou_threshold=cell["iou_threshold"],
                            score_threshold=cell["score_threshold"], max_det=cell["max_det"])
        self.step = serving.make_serving_step(self.model, tail=cell["tail"], **self.tail_kw)
        gen = torch.Generator().manual_seed(run.seed)
        self.capture_from = 1 + int(torch.randint(0, self.nb, (1,), generator=gen))
        self.sample = torch.randperm(n, generator=gen)[:cell["check_images"]].sort().values
        self.captured: dict = {}
        self.results: list = []
        self.i = 0
        self._hook = self.model.register_forward_hook(self._capture)

    def _capture(self, module, inputs, out) -> None:
        if self.capture_from <= self.i < self.capture_from + self.nb:
            self.captured[self.i % self.nb] = (out["cls_logits"].clone(), out["boxes"].clone())

    def call(self):
        j = self.i % self.nb
        rows = slice(j * self.B, (j + 1) * self.B)
        res = _read(self.step(self.frames[rows],
                              None if self.bins is None else self.bins[rows]))
        self.results.append((j, res))
        self.i += 1

    def warm_up(self) -> None:
        """Every batch of the pool once: the kernels build, cuDNN settles."""
        for j in range(self.nb):
            rows = slice(j * self.B, (j + 1) * self.B)
            _read(self.step(self.frames[rows], None if self.bins is None else self.bins[rows]))
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
        t_end = time.perf_counter()
        images = self.i * self.B
        run.window_elapsed = t_end - t0
        run.e2e["serve_img_s"] = images / run.window_elapsed
        run.attempted = images
        if run.device.type == "cuda":
            run.memory_peak = torch.cuda.max_memory_allocated(run.device)

    def _profiled_stretch(self) -> None:
        """``profile_steps`` whole steps under ``torch.profiler``, with CUDA
        events around each MoE level."""
        run, dev = self.run, self.run.device
        steps = run.cell["profile_steps"]
        on_card = dev.type == "cuda"
        level_ms: list = []
        handles = []
        if self.moe and on_card:
            pending: list = []

            def pre(module, inputs):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pending.append(ev)

            def post(module, inputs, out):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                level_ms.append((pending.pop(), ev))

            for i in range(3):
                m = getattr(self.model, f"moe_level{i}")
                handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(dev)
        first = self.i
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                self.call()
            t1 = time.perf_counter()
        for h in handles:
            h.remove()
        red = common.reduce_trace(prof)
        run.busy_s, run.window_s = red["busy_s"], t1 - t0
        run.breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        thr, pool = run.cell["score_threshold"], run.cell["pool"]
        valid = {j: (torch.sigmoid(c[..., 0].float()) > thr).sum(1).clamp_max(pool).cpu()
                 for j, (c, _) in self.captured.items()}
        run.layer.update(
            kind="serve", steps=steps, images=steps * self.B, stretch_s=t1 - t0,
            events=red["events"], moe_level_ms=[a.elapsed_time(b) for a, b in level_ms],
            nms_valid=[valid[j] for j, _ in self.results[first:first + steps]],
            weight_shapes={k: tuple(v.shape) for k, v in self.weights.items()})

    def free_program(self) -> None:
        self._hook.remove()
        del self.step, self.model
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, idx: torch.Tensor, prec: "detector.Prec | None" = None) -> tuple:
        """(class logits, box distances) of the reference on frames ``idx``."""
        w32 = {k: v.float() for k, v in self.weights.items()}
        cls, ltrb = [], []
        for s in range(0, len(idx), 8):
            rows = idx[s:s + 8].to(self.frames.device)
            out = detector.forward(w32, self.run.config, self.frames[rows],
                                   None if self.bins is None else self.bins[rows], prec=prec)
            cls.append(out["cls_logits"])
            ltrb.append(_ltrb(out["boxes"], out["anchor_points"]))
        return torch.cat(cls), torch.cat(ltrb)

    def program_outputs(self, idx: torch.Tensor) -> tuple:
        cfg, cell = self.run.config, self.run.cell
        points, _ = detector.anchors(cell["img_h"], cell["img_w"], self.frames.device)
        cls, ltrb = [], []
        for i in idx.tolist():
            c, b = self.captured[i // self.B]
            cls.append(c[i % self.B])
            ltrb.append(_ltrb(b[i % self.B], points))
        return torch.stack(cls), torch.stack(ltrb)

    def check(self) -> None:
        run = self.run
        expected = {}
        for j, (cls, boxes) in self.captured.items():
            expected[j] = _read(nms.serving_tail(cls, boxes, **self.tail_kw))
        bad = 0
        for j, res in self.results:
            exp = expected[j]
            same = torch.ones(res[0].shape[0], dtype=torch.bool)
            for got, want in zip(res, exp):
                if got.dtype == torch.float32:
                    got, want = got.view(torch.int32), want.view(torch.int32)
                same &= (got == want).flatten(1).all(1)
            bad += int((~same).sum())
        ref_cls, ref_ltrb = self.reference(self.sample)
        cls, ltrb = self.program_outputs(self.sample)
        run.check("logit_err", rel_err(cls, ref_cls))
        run.check("box_err", rel_err(ltrb, ref_ltrb))
        run.check("tail_mismatch", bad, 0)

    def control(self, kind: str) -> dict:
        """The reference in a lower precision put in the program's place:
        its readings of the numbers that compare outputs."""
        ref_cls, ref_ltrb = self.reference(self.sample)
        cls, ltrb = self.reference(self.sample, detector.Prec(kind))
        return {"logit_err": rel_err(cls, ref_cls), "box_err": rel_err(ltrb, ref_ltrb)}


def run(run) -> None:
    off = run.state = Offline(run)
    off.warm_up()
    run.mark("warm_up")
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    off.window()
    off.free_program()
    with common.reference_precision():
        off.check()
