"""The protocol's training step, closed loop, on a pool of batches on the card.

Set-up builds one ``DetectionTrainer`` and its ``TrainState`` (the port's
model loaded with the seeded weights, SGD-Nesterov with clip and EMA as the
train CLIs build them, the protocol's schedule over ``steps_per_epoch``)
and drives it through its first three steps with the window's own call,
``trainer.train_step(state, batch)``, on three distinct batches of the
pool; the same object then runs the window. A step is complete when its
metrics have been read to the host, ``log_every`` steps at a time as
``fit`` reads them. ``train_img_s`` is the images of the steps completed in
the window over the window's seconds.

The check, after the window: the float32 reference (TF32 off) follows the
same three steps from the same weights and draws. Compared: the first
step's forward (class logits and box distances, relative L2 over the
batch, captured by a forward hook on the trained model); each step's loss; the
first step's gradient as the optimizer took it, worked out from
the momentum trace after one step (``trace − wd·p`` on decayed tensors),
and the change of the parameters and of their EMA after three steps, each
by the median tensor of ``|‖program‖ − ‖reference‖| / max(‖reference‖,
the median tensor's ‖reference‖)``, leaving out tensors whose reference
gradient is under a thousandth of the median tensor's. The loss and the
worst tensor are printed beside them (``PERF.md`` says why they are not
compared).
"""

from __future__ import annotations

import gc
import time

import torch

from .. import common
from ..reference import detector, train as ref_train
from .offline import _ltrb, rel_err

CHECKED_STEPS = 3


def _leaf_gaps(prog: dict, ref: dict, keep: list) -> "tuple[list, list]":
    """Per tensor, ``|‖prog‖ − ‖ref‖|`` and ``‖prog − ref‖``, each over
    ``max(‖ref‖, the median tensor's ‖ref‖)``."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    med = float(torch.tensor(list(rn.values())).median())
    norm_gaps, diffs = [], []
    for k in keep:
        scale = max(rn[k], med, 1e-30)
        norm_gaps.append(abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k]) / scale)
        diffs.append(float(torch.linalg.vector_norm(prog[k].double() - ref[k].double())) / scale)
    return norm_gaps, diffs


def _rows_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 error over the batch; an image the program's output
    lacks counts as zeros."""
    if prog.shape[0] < ref.shape[0]:
        prog = torch.cat([prog, torch.zeros_like(ref[prog.shape[0]:])])
    return rel_err(prog, ref)


def _median(xs: list) -> float:
    return float(torch.tensor(xs, dtype=torch.float64).median())


class Train:
    def __init__(self, run):
        from multimodal_moe_torch.losses.tal import yolo_loss
        from multimodal_moe_torch.models.moe_yolo import moe_yolo_loss
        from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig

        self.run = run
        cell, cfg, dev = run.cell, run.config, run.device
        self.B, self.nb = cell["batch"], cell["pool_batches"]
        self.moe = bool(cfg.get("num_experts"))
        n = self.B * self.nb
        self.pool = dict(common.make_ground_truth(n, cell["max_boxes"], cell["img_h"],
                                                  cell["img_w"], run.seed, dev),
                         image=common.make_frames(n, cell["img_h"], cell["img_w"], run.seed, dev))
        if self.moe:
            self.pool["solar_bin"] = common.make_bins(n, cfg["num_context_bins"], run.seed, dev)
        run.mark("frames")
        self.weights = common.make_weights(common.weight_shapes(cfg, torch.float32), run.seed,
                                           dev)
        common.fit_to_frames(self.weights, cfg, self.pool["image"][:4],
                             self.pool["solar_bin"][:4] if self.moe else None)
        run.mark("weights")
        model = common.build_model(cfg, torch.float32, dev, self.weights, train=True)
        self.hp = dict(lr0=cell["lr0"], lrf=cell["lrf"], momentum=cell["momentum"],
                       weight_decay=cell["weight_decay"],
                       warmup_steps=int(cell["steps_per_epoch"] * cell["warmup_epochs"]),
                       total_steps=cell["steps_per_epoch"] * cell["epochs"])
        tcfg = DetTrainConfig(variant=cfg["variant"], num_classes=cfg["num_classes"],
                              img_h=cell["img_h"], img_w=cell["img_w"], epochs=cell["epochs"],
                              batch=self.B, seed=cell["train_seed"], lr0=cell["lr0"],
                              lrf=cell["lrf"], momentum=cell["momentum"],
                              weight_decay=cell["weight_decay"],
                              warmup_epochs=cell["warmup_epochs"])
        self.trainer = DetectionTrainer(model, tcfg,
                                        loss_fn=moe_yolo_loss if self.moe else yolo_loss,
                                        steps_per_epoch=cell["steps_per_epoch"], device=dev)
        self.state = self.trainer.init_state()
        del model
        self.i = 0
        self.pending: list = []

    def batch(self, j: int) -> dict:
        rows = slice(j * self.B, (j + 1) * self.B)
        return {k: v[rows] for k, v in self.pool.items()}

    def call(self):
        self.state, metrics = self.trainer.train_step(self.state, self.batch(self.i % self.nb))
        self.i += 1
        return metrics

    def flush(self) -> None:
        for m in self.pending:
            for v in m.values():
                float(v)
        self.pending.clear()

    def first_steps(self) -> None:
        """The first three steps, with what the check compares."""
        st = self.state
        p0 = {k: p.detach().clone() for k, p in st.model.named_parameters()}
        self.losses, captured = [], []

        def capture(module, inputs, out):
            captured.append((out["cls_logits"].detach().clone(), out["boxes"].detach().clone()))

        hook = st.model.register_forward_hook(capture)
        for s in range(CHECKED_STEPS):
            metrics = self.call()
            if s == 0:
                hook.remove()
                self.first_outputs = captured[0] if captured else None
            self.losses.append(float(metrics["loss"]))
            if s == 0:
                wd = self.hp["weight_decay"]
                trace = self.state.opt.state["trace"]
                self.first_grad = {k: trace[k] - wd * p0[k] if self.state.opt.decayed[k]
                                   else trace[k].clone() for k in p0}
        params = dict(self.state.model.named_parameters())
        self.delta = {k: params[k].detach() - p0[k] for k in p0}
        self.ema_delta = {k: self.state.ema_params[k] - p0[k] for k in p0}
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def window(self) -> None:
        run, every = self.run, self.run.cell["log_every"]
        start = self.i
        prof_at = start + 2 if run.trace else None
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        while time.perf_counter() < deadline or (prof_at is not None and self.i <= prof_at):
            if self.i == prof_at:
                self._profiled_stretch()
                continue
            self.pending.append(self.call())
            if len(self.pending) >= every:
                self.flush()
        self.flush()
        t_end = time.perf_counter()
        images = (self.i - start) * self.B
        run.window_elapsed = t_end - t0
        run.e2e["train_img_s"] = images / run.window_elapsed
        run.attempted = images
        if run.device.type == "cuda":
            run.memory_peak = torch.cuda.max_memory_allocated(run.device)

    def _profiled_stretch(self) -> None:
        run, dev = self.run, self.run.device
        steps = run.cell["profile_steps"]
        self.flush()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                self.pending.append(self.call())
            self.flush()
            t1 = time.perf_counter()
        red = common.reduce_trace(prof)
        run.busy_s, run.window_s = red["busy_s"], t1 - t0
        run.breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        run.layer.update(kind="train", steps=steps, images=steps * self.B, stretch_s=t1 - t0,
                         events=red["events"],
                         weight_shapes={k: tuple(v.shape) for k, v in self.weights.items()})

    def free_program(self) -> None:
        del self.trainer, self.state
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec=None) -> dict:
        return ref_train.train_steps(
            self.weights, self.run.config, [self.batch(s) for s in range(CHECKED_STEPS)],
            hp=self.hp, draw_seed=self.run.cell["train_seed"], prec=prec)

    def readings(self, got: dict, ref: dict) -> dict:
        """The numbers of ``got`` (program or control) against the reference:
        the median and the worst tensor of each comparison, and the loss."""
        norms = {k: float(torch.linalg.vector_norm(g)) for k, g in ref["first_grad"].items()}
        med = _median(list(norms.values()))
        keep = [k for k, v in norms.items() if v >= 1e-3 * med]
        out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))}
        ref_cls, ref_boxes = ref["first_outputs"]
        points = self.anchor_points(ref_boxes.device)
        cls, boxes = got["first_outputs"] or (ref_cls[:0], ref_boxes[:0])   # no forward ran
        out["forward_logit_err"] = _rows_err(cls, ref_cls)
        out["forward_box_err"] = _rows_err(_ltrb(boxes, points), _ltrb(ref_boxes, points))
        for name, key in (("grad", "first_grad"), ("update", "delta"), ("ema", "ema_delta")):
            gaps, diffs = _leaf_gaps(got[key], ref[key], keep)
            out[f"{name}_gap"] = _median(gaps)
            out[f"{name}_gap_worst"] = max(gaps)
            out[f"{name}_diff"] = _median(diffs)
            d = sorted(diffs)
            out[f"{name}_diff_p25"] = d[len(d) // 4]
        return out

    def check(self) -> None:
        self.ref = self.reference()
        got = {"losses": self.losses, "first_grad": self.first_grad, "delta": self.delta,
               "ema_delta": self.ema_delta, "first_outputs": self.first_outputs}
        for name, value in self.readings(got, self.ref).items():
            if name in self.run.cell["checks"]:
                self.run.check(name, value)
            else:
                self.run.info[name] = value

    def anchor_points(self, device):
        return detector.anchors(self.run.cell["img_h"], self.run.cell["img_w"], device)[0]

    def control(self, kind: str) -> dict:
        from ..reference.detector import Prec

        return self.readings(self.reference(Prec(kind)), self.ref)


def run(run) -> None:
    tr = run.state = Train(run)
    tr.first_steps()
    run.mark("first_steps")
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    tr.window()
    tr.free_program()
    with common.reference_precision():
        tr.check()
