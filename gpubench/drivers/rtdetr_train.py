"""RT-DETR's protocol training step, closed loop, on a pool of batches on
the card: the step ``cli/train_rtdetr.py`` builds.

Set-up builds one ``DetectionTrainer`` and its ``TrainState`` (the port's
RT-DETR loaded with the seeded weights, remat as the cell says, AdamW with
clip and EMA, the flat schedule after one warm-up epoch of
``steps_per_epoch``, the set loss at the cell's image size) and drives it
through its first three steps with the window's own call,
``trainer.train_step(state, batch)``, on three distinct batches of the
pool. A step is complete when its metrics have been read to the host,
``log_every`` steps at a time as ``fit`` reads them. ``train_img_s`` is the
images of the steps completed in the window over the window's seconds.

The check, after the window: the float32 reference (TF32 off) follows the
same three steps from the same weights and draws, given the program's own
top-``Q`` anchors (``rtdetr_common.SelectionCapture``) and its matcher's
assignments (the port's ``hungarian_match`` on the outputs and ground
truth the program's loss was given, which the driver's loss function
records). Compared, as ``drivers/train.py`` compares them: the first
step's final logits and boxes, each step's loss, the first gradient as the
optimizer took it (AdamW's first moment after one step over 1 − β1), and
the change of the parameters and of their EMA after three steps.
``match_disagree`` counts the problems (one a matched set and image) whose
program and reference assignments differ although the reference cost's
``assignment_margin`` exceeds 2·columns·δ, δ the largest difference of the
cost entries that the two sides' outputs give: there the optimum cannot
move by rounding.
"""

from __future__ import annotations

import functools
import gc
import time

import torch

from .. import common, rtdetr_common
from ..reference import rtdetr as ref
from .train import CHECKED_STEPS, _leaf_gaps, _median, _rows_err


def _detached(outputs: dict) -> dict:
    """The matched sets of the program's outputs, detached."""
    take = lambda d: {k: d[k].detach().clone() for k in ("pred_logits", "pred_boxes")}  # noqa: E731
    return {"enc_outputs": take(outputs["enc_outputs"]),
            "aux_outputs": [take(d) for d in outputs["aux_outputs"]],
            **take(outputs)}


class RTDETRTrain:
    def __init__(self, run):
        from multimodal_moe_torch.models.rtdetr import rtdetr_loss
        from multimodal_moe_torch.train.detection import DetectionTrainer, DetTrainConfig

        self.run = run
        cell, cfg, dev = run.cell, run.config, run.device
        self.B, self.nb = cell["batch"], cell["pool_batches"]
        self.img_hw = (cell["img_h"], cell["img_w"])
        n = self.B * self.nb
        self.pool = dict(common.make_ground_truth(n, cell["max_boxes"], cell["img_h"],
                                                  cell["img_w"], run.seed, dev),
                         image=common.make_frames(n, cell["img_h"], cell["img_w"], run.seed, dev))
        run.mark("frames")
        self.weights = rtdetr_common.make_weights(
            rtdetr_common.weight_shapes(cfg, torch.float32), cfg, run.seed, dev)
        rtdetr_common.fit_to_frames(self.weights, cfg, self.pool["image"][:4])
        run.mark("weights")
        model = rtdetr_common.build_model(cfg, torch.float32, dev, self.weights, train=True,
                                          remat=cell["remat"])
        self.hp = dict(lr0=cell["lr0"], lrf=cell["lrf"], weight_decay=cell["weight_decay"],
                       warmup_steps=int(cell["steps_per_epoch"] * cell["warmup_epochs"]),
                       total_steps=cell["steps_per_epoch"] * cell["epochs"])
        tcfg = DetTrainConfig(variant=cfg["variant"], num_classes=cfg["num_classes"],
                              img_h=cell["img_h"], img_w=cell["img_w"], epochs=cell["epochs"],
                              batch=self.B, seed=cell["train_seed"], lr0=cell["lr0"],
                              lrf=cell["lrf"], weight_decay=cell["weight_decay"],
                              warmup_epochs=cell["warmup_epochs"], optimizer="adamw")
        loss = functools.partial(rtdetr_loss, img_hw=self.img_hw)
        self.loss_args: list = []
        self.capturing = False

        def loss_fn(outputs, gt_labels, gt_boxes, gt_mask):
            if self.capturing:
                self.loss_args.append((_detached(outputs), gt_boxes.detach().clone()))
            return loss(outputs, gt_labels, gt_boxes, gt_mask)

        self.trainer = DetectionTrainer(model, tcfg, loss_fn=loss_fn,
                                        steps_per_epoch=cell["steps_per_epoch"], device=dev)
        self.state = self.trainer.init_state()
        del model
        self.selection = rtdetr_common.SelectionCapture(self.state.model)
        self.i = 0
        self.pending: list = []
        self.profiled: list = []

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
        self.losses = []
        self.capturing = self.selection.on = True
        for s in range(CHECKED_STEPS):
            self.losses.append(float(self.call()["loss"]))
            if s == 0:
                mu = self.state.opt.state["mu"]
                self.first_grad = {k: mu[k] / (1 - ref.ADAM_B1) for k in p0}
        self.capturing = self.selection.on = False
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
        run.window_elapsed = time.perf_counter() - t0
        images = (self.i - start) * self.B
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
                self.profiled.append((self.state.step, self.i % self.nb))
                self.pending.append(self.call())
            self.flush()
            t1 = time.perf_counter()
        red = common.reduce_trace(prof)
        run.busy_s, run.window_s = red["busy_s"], t1 - t0
        run.breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        run.layer.update(kind="train", steps=steps, images=steps * self.B, stretch_s=t1 - t0,
                         events=red["events"],
                         weight_shapes={k: tuple(v.shape) for k, v in self.weights.items()})

    def sampled_work(self) -> None:
        """The sampling locations of the profiled steps (their batches, their
        draws), taken again after the window with the model as the window
        left it: each decoder layer's distinct value rows and corners, in
        the order of the stretch's ``rtdetr.deform`` calls."""
        from multimodal_moe_torch.ops.augment import train_augment

        if not self.profiled:
            return
        model = self.state.model

        def forward():
            with torch.no_grad():
                for step, j in self.profiled:
                    b = self.batch(j)
                    images, gt = train_augment(b["image"].float() / 255.0, b["gt_boxes"],
                                               generator=self.trainer._generator(step, 0))
                    model(images, train=True, gt_boxes=gt, gt_mask=b["gt_mask"],
                          denoise_generator=self.trainer._generator(step, 1))

        self.run.layer["deform_work"] = rtdetr_common.sampled_work(
            model, self.run.config["num_decoder_layers"], forward)

    def free_program(self) -> None:
        self.selection.remove()
        self.program = self._program_picks()
        del self.trainer, self.state
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _program_picks(self) -> dict:
        """Per checked step, the program's selection and assignment where
        the program ran the step on the whole batch, else None; and its
        outputs and ground truth."""
        from multimodal_moe_torch.losses.hungarian import _gt_cxcywh, hungarian_match

        topk, assigned, taken = [], [], []
        for s in range(CHECKED_STEPS):
            whole = s < len(self.loss_args) and s < len(self.selection.taken) \
                and self.loss_args[s][1].shape[0] == self.B
            if not whole:
                topk.append(None)
                assigned.append(None)
                taken.append(None)
                continue
            out, gt_boxes = self.loss_args[s]
            b = self.batch(s)
            layers = ref.matched_layers(out)
            n = len(layers)
            with torch.no_grad():
                a = hungarian_match(
                    torch.cat([ly["pred_logits"] for ly in layers]),
                    torch.cat([ly["pred_boxes"] for ly in layers]),
                    b["gt_labels"].repeat(n, 1), _gt_cxcywh(gt_boxes, self.img_hw).repeat(n, 1, 1),
                    b["gt_mask"].repeat(n, 1))
            picks = self.selection.taken[s][1]
            topk.append(picks if bool((picks >= 0).all()) else None)
            assigned.append(a.view(n, self.B, -1))
            taken.append((out, gt_boxes))
        return {"topk": topk, "assigned": assigned, "taken": taken}

    def reference(self, prec=None) -> dict:
        return ref.train_steps(
            {k: v.float() for k, v in self.weights.items()}, self.run.config,
            [self.batch(s) for s in range(CHECKED_STEPS)], hp=self.hp,
            draw_seed=self.run.cell["train_seed"], img_hw=self.img_hw, prec=prec,
            topk=self.program["topk"], assigned=self.program["assigned"],
            remat=self.run.device.type == "cuda")

    def readings(self, got: dict, want: dict) -> dict:
        """The numbers of ``got`` (program or control) against the reference:
        the median and the worst tensor of each comparison, and the loss."""
        norms = {k: float(torch.linalg.vector_norm(g)) for k, g in want["first_grad"].items()}
        med = _median(list(norms.values()))
        keep = [k for k, v in norms.items() if v >= 1e-3 * med]
        out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))}
        ref_cls, ref_boxes = want["first_outputs"]
        cls, boxes = got["first_outputs"] or (ref_cls[:0], ref_boxes[:0])
        out["forward_logit_err"] = _rows_err(cls, ref_cls)
        out["forward_box_err"] = _rows_err(boxes, ref_boxes)
        for name, key in (("grad", "first_grad"), ("update", "delta"), ("ema", "ema_delta")):
            gaps, diffs = _leaf_gaps(got[key], want[key], keep)
            out[f"{name}_gap"] = _median(gaps)
            out[f"{name}_gap_worst"] = max(gaps)
            out[f"{name}_diff"] = _median(diffs)
        return out

    def match_disagree(self) -> "tuple[int, int]":
        """(problems counted, problems whose assignments differ at all)."""
        from multimodal_moe_torch.ops.assignment import assignment_margin

        counted = differ_any = 0
        for s, taken in enumerate(self.program["taken"]):
            if taken is None:
                continue
            out, gt_boxes = taken
            b = self.batch(s)
            gt = ref.gt_to_cxcywh(gt_boxes, *self.img_hw)
            prog_cost = ref.layer_costs(out, gt, b["gt_labels"], b["gt_mask"])
            ref_cost = self.ref["cost"][s]
            n = prog_cost.shape[0] // self.B
            valid = b["gt_mask"].repeat(n, 1)
            pa = self.program["assigned"][s].reshape(n * self.B, -1)
            ra = self.ref["assigned"][s].reshape(n * self.B, -1)
            for p in torch.nonzero(((pa != ra) & valid).any(1)).flatten().tolist():
                differ_any += 1
                cols = valid[p]
                delta = float((prog_cost[p][:, cols] - ref_cost[p][:, cols]).abs().max())
                margin = assignment_margin(ref_cost[p].cpu().numpy(), cols.cpu().numpy())
                if margin > 2 * int(cols.sum()) * delta:
                    counted += 1
        return counted, differ_any

    def check(self) -> None:
        self.ref = self.reference()
        got = {"losses": self.losses, "first_grad": self.first_grad, "delta": self.delta,
               "ema_delta": self.ema_delta,
               "first_outputs": None if self.program["taken"][0] is None else (
                   self.program["taken"][0][0]["pred_logits"],
                   self.program["taken"][0][0]["pred_boxes"])}
        for name, value in self.readings(got, self.ref).items():
            if name in self.run.cell["checks"]:
                self.run.check(name, value)
            else:
                self.run.info[name] = value
        counted, differ_any = self.match_disagree()
        self.run.info["match_differ"] = differ_any
        self.run.check("match_disagree", counted, 0)

    def control(self, kind: str) -> dict:
        from ..reference.detector import Prec

        return self.readings(self.reference(Prec(kind)), self.ref)


def run(run) -> None:
    tr = run.state = RTDETRTrain(run)
    tr.first_steps()
    run.mark("first_steps")
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    tr.window()
    tr.sampled_work()
    tr.free_program()
    with common.reference_precision():
        tr.check()
