"""Independent camera clients posting JPEGs to the HTTP server: an open loop.

Set-up serves the port's ``DetectorHTTPServer`` over ``BatchingDetector``
(the ``serve_detector`` deployment: float32 under torch's TF32 defaults,
batch 16, a 20 ms window, pool 512, confidence 0.25) on a free localhost
port, and encodes a pool of seeded smooth frames as JPEGs once. The load
comes from ``gpubench/http_client.py`` in a process of its own: Poisson
arrivals at the cell's fixed rate over keep-alive connections, each
request timed from when it was due to the last byte of its answer, after
``warmup_s`` seconds of the same load that count as set-up.
``http_p95_ms`` is the 95th percentile over every request due in the
window; one that fails or never comes counts at the longest wait the
client allows (``grace``) and in ``failed``.

The check, after the window: in device calls drawn from the seed, a
forward hook captures the model's inputs and outputs, and a wrapper on the
batcher's step the context of each slot, which the client sets to the
request's number. Each captured image must equal, pixel for pixel, the
reference's own PIL decode of the JPEG its request sent; the float32
reference's logits and box distances on those frames must lie within the
cell's limits of the captured outputs; and the reference tail on the
captured outputs, mapped and rounded as the server answers, must give
exactly the answer each of those requests got. No request may go
unanswered. (Answers for one frame from different device calls may differ
in the last digit: under TF32, cuDNN's results for an image move with its
batch; so each answer is judged against its own call.)
"""

from __future__ import annotations

import gc
import io
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import common
from ..http_client import write_bodies
from ..reference import detector, nms
from .offline import _ltrb, rel_err


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def latencies_ms(requests: list, grace_s: float) -> list:
    """Every request's latency in ms; a failed or missing one at ``grace_s``."""
    return [1e3 * (r["latency"] if r["latency"] is not None else grace_s) for r in requests]


def answer(boxes, scores, valid, conf: float, img_w: int, img_h: int) -> dict:
    """The server's JSON answer for one image of model size from its
    ``NmsResult`` row: kept detections at or above ``conf``, mapped to the
    source's pixels (the same size here), clipped and rounded."""
    keep = valid & (scores >= conf)
    xyxy = boxes[keep] * np.array([1.0, 1.0, 1.0, 1.0])
    xyxy[:, 0::2] = xyxy[:, 0::2].clip(0, img_w)
    xyxy[:, 1::2] = xyxy[:, 1::2].clip(0, img_h)
    dets = [{"xyxy": [round(float(v), 2) for v in b], "score": round(float(s), 4)}
            for b, s in zip(xyxy, scores[keep])]
    return {"width": img_w, "height": img_h, "detections": dets}


class Http:
    def __init__(self, run):
        from PIL import Image

        from multimodal_moe_torch.server import BatchingDetector, DetectorHTTPServer

        self.run = run
        cell, cfg, dev = run.cell, run.config, run.device
        dtype = common.torch_dtype(cell)
        # One deployed model: the weights (fitted to frames of their own)
        # come from the cell's fixed ``weights_seed``; the seed draws the
        # traffic, so runs differ in their requests and not in the model.
        wseed = cell["weights_seed"]
        self.weights = common.make_weights(common.weight_shapes(cfg, dtype), wseed, dev)
        common.fit_to_frames(self.weights, cfg,
                             common.make_frames(4, cell["img_h"], cell["img_w"], wseed, dev),
                             conf=cell["conf"])
        run.mark("weights")
        frames = common.make_frames(cell["frames"], cell["img_h"], cell["img_w"], run.seed, dev)
        self.model = common.build_model(cfg, dtype, dev, self.weights)
        self.det = BatchingDetector(self.model, self.weights, batch=cell["batch"],
                                    img_h=cell["img_h"], img_w=cell["img_w"], conf=cell["conf"],
                                    iou_threshold=cell["iou_threshold"], max_det=cell["max_det"],
                                    pool=cell["pool"], max_wait_ms=cell["max_wait_ms"])
        self.bodies = []
        for f in frames.cpu().numpy():
            buf = io.BytesIO()
            Image.fromarray(f).save(buf, format="JPEG", quality=cell["jpeg_quality"])
            self.bodies.append(buf.getvalue())
        self.httpd = DetectorHTTPServer(("127.0.0.1", 0), self.det)
        self.port = self.httpd.server_address[1]
        self.serving = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.serving.start()
        self.calls = 0
        self.capture_calls: set = set()
        self.captured: list = []
        self._context = None
        self._hook = self.model.register_forward_hook(self._capture)
        step = self.det._step

        def step_with_context(images, context_ids=None):
            self._context = torch.as_tensor(context_ids).cpu().clone()
            return step(images, context_ids)

        self.det._step = step_with_context

    def _capture(self, module, inputs, out) -> None:
        if self.calls in self.capture_calls:
            images = (inputs[0] * 255.0).round().to(torch.uint8)
            self.captured.append((images, out["cls_logits"].clone(), out["boxes"].clone(),
                                  self._context))
        self.calls += 1

    def warm_up(self) -> None:
        """The serving step once, then a few requests through HTTP."""
        import http.client

        self.det.warmup()
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        for body in self.bodies[:4]:
            conn.request("POST", "/predict", body=body, headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise RuntimeError(f"warm-up request failed: HTTP {resp.status}")
        conn.close()

    def window(self, rate: float, seconds: float, seed: int) -> dict:
        """One open-loop window at ``rate``; the client's record, with the
        batcher's counters' deltas over it."""
        run, cell = self.run, self.run.cell
        gen = torch.Generator().manual_seed(seed)
        client = subprocess.Popen(
            [sys.executable, "-m", "gpubench.http_client", "--port", str(self.port),
             "--rate", str(rate), "--seconds", str(seconds), "--seed", str(seed),
             "--connections", str(cell["connections"]), "--grace", str(cell["grace_s"]),
             "--warmup", str(cell["warmup_s"])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=str(common.ROOT.parent))
        try:
            write_bodies(client.stdin, self.bodies)
            client.stdin.close()
            if client.stdout.readline().strip() != b"ready":
                raise RuntimeError("the load client did not start")
            with self.det._lock:
                before = dict(self.det.stats)
            first = self.calls + 1 + int(torch.randint(0, 8, (1,), generator=gen))
            self.capture_calls = set(range(first, first + cell["capture_calls"]))
            t_ready = time.perf_counter()
            if run.trace:
                self._profiled_stretch(t_ready + cell["profile_at_s"])
            out = json.loads(client.stdout.readline())
            client.wait(timeout=60)
        finally:
            if client.poll() is None:
                client.kill()
                client.wait()
        with self.det._lock:
            after = dict(self.det.stats)
        out["t_ready"] = t_ready
        for k in ("device_calls", "batched_images", "errors"):
            out[k] = after[k] - before[k]
        return out

    def _profiled_stretch(self, at: float) -> None:
        run, dev = self.run, self.run.device
        time.sleep(max(0.0, at - time.perf_counter()))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            time.sleep(run.cell["profile_s"])
            t1 = time.perf_counter()
        red = common.reduce_trace(prof)
        run.busy_s, run.window_s = red["busy_s"], t1 - t0
        run.breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        run.layer.update(stretch_s=t1 - t0, events=red["events"])

    def measure(self) -> None:
        run, cell = self.run, self.run.cell
        out = self.window(cell["rate"], run.seconds, run.seed)
        run.e2e["setup_s"] = out["t_ready"] - run.t_start
        reqs = out["requests"]
        lat = latencies_ms(reqs, cell["grace_s"])
        run.e2e["http_p95_ms"] = percentile(lat, 95)
        run.attempted = len(reqs)
        run.failed = sum(r["latency"] is None for r in reqs)
        run.layer.update(kind="http", device_calls=out["device_calls"],
                         batched_images=out["batched_images"])
        if run.device.type == "cuda":
            run.memory_peak = torch.cuda.max_memory_allocated(run.device)
        self.out = out
        print(f"http: {len(reqs)} requests due at {cell['rate']}/s, mean body "
              f"{sum(map(len, self.bodies)) / len(self.bodies):.0f} B, generator late by "
              f"{out['generator_late_s'] * 1e3:.1f} ms at most, p50 {percentile(lat, 50):.1f} ms",
              file=sys.stderr)

    def free_program(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.det.close()
        self._hook.remove()
        del self.det, self.model, self.httpd
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def decoded(self) -> torch.Tensor:
        from PIL import Image

        return torch.stack([torch.from_numpy(np.asarray(Image.open(io.BytesIO(b)).convert("RGB"),
                                                        np.uint8).copy())
                            for b in self.bodies])

    def _slots(self):
        """(frame, call, slot, request) of every captured slot that holds a
        request, and the count of those whose image is not, pixel for pixel,
        the reference's decode of the JPEG that request sent."""
        ref = self.decoded().to(self.run.device)
        reqs = self.out["requests"]
        found, unmatched = [], 0
        for c, (images, _, _, context) in enumerate(self.captured):
            for s in range(images.shape[0]):
                if not bool(images[s].any()):
                    continue                       # the batcher's zero padding
                k = int(context[s])
                f = reqs[k]["frame"] if 0 <= k < len(reqs) else -1
                if f >= 0 and torch.equal(images[s], ref[f]):
                    found.append((f, c, s, k))
                else:
                    unmatched += 1
        return ref, found, unmatched

    def reference(self, ref_frames, frames: list, prec=None) -> dict:
        w32 = {k: v.float() for k, v in self.weights.items()}
        out = {}
        for s in range(0, len(frames), 8):
            idx = frames[s:s + 8]
            o = detector.forward(w32, self.run.config, ref_frames[idx], prec=prec)
            ltrb = _ltrb(o["boxes"], o["anchor_points"])
            for j, f in enumerate(idx):
                out[f] = (o["cls_logits"][j], ltrb[j])
        return out

    def check(self) -> None:
        run, cell = self.run, self.run.cell
        ref_frames, found, unmatched = self._slots()
        frames = sorted({f for f, _, _, _ in found})
        ref = self.reference(ref_frames, frames)
        points, _ = detector.anchors(cell["img_h"], cell["img_w"], ref_frames.device)
        got_cls, got_ltrb, ref_cls, ref_ltrb = [], [], [], []
        wrong, dets = 0, []
        for f, c, s, k in found:
            _, cls, boxes, _ = self.captured[c]
            got_cls.append(cls[s])
            got_ltrb.append(_ltrb(boxes[s], points))
            ref_cls.append(ref[f][0])
            ref_ltrb.append(ref[f][1])
            b, sc, _, v = (t[0].cpu().numpy() for t in nms.serving_tail(
                cls[s:s + 1], boxes[s:s + 1], pool=cell["pool"],
                iou_threshold=cell["iou_threshold"], score_threshold=0.001,
                max_det=cell["max_det"]))
            expected = answer(b, sc, v, cell["conf"], cell["img_w"], cell["img_h"])
            got = self.out["requests"][k]["answer"]
            wrong += got is None or json.loads(got) != expected
            dets.append(len(expected["detections"]))
        run.info.update(requests_checked=len(found), frames_checked=len(frames),
                        detections_per_answer=sum(dets) / max(1, len(dets)))
        lat = [r["latency"] for r in self.out["requests"]]
        third = max(1, len(lat) // 3)
        for part, xs in (("first", lat[:third]), ("last", lat[-third:])):
            ok = [x for x in xs if x is not None]
            run.info[f"p50_ms_{part}_third"] = 1e3 * percentile(ok, 50) if ok else None
        run.check("logit_err", rel_err(torch.stack(got_cls), torch.stack(ref_cls)))
        run.check("box_err", rel_err(torch.stack(got_ltrb), torch.stack(ref_ltrb)))
        run.check("decode_mismatch", unmatched, 0)
        run.check("answer_mismatch", wrong, 0)
        run.check("unanswered", run.failed, 0)
        run.check("requests_checked_short", max(0, cell["min_requests_checked"] - len(found)), 0)

    def control(self, kind: str) -> dict:
        ref_frames, found, _ = self._slots()
        frames = sorted({f for f, _, _, _ in found})
        ref = self.reference(ref_frames, frames)
        low = self.reference(ref_frames, frames, detector.Prec(kind))
        return {name: rel_err(torch.stack([low[f][i] for f in frames]),
                              torch.stack([ref[f][i] for f in frames]))
                for i, name in enumerate(("logit_err", "box_err"))}


def run(run) -> None:
    h = run.state = Http(run)
    run.mark("server")
    h.warm_up()
    run.mark("warm_up")
    h.measure()
    h.free_program()
    with common.reference_precision():
        h.check()
