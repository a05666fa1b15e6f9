"""Dynamic-batching detection server: the serving layer behind HTTP.

Counterpart of ``multimodal_moe_tpu/server.py``, with its names and its
behaviour:

* :class:`BatchingDetector` — owns the serving step (forward + NMS on the
  model's device, :func:`serving.make_serving_step`: the keep-mask kernel
  on the card), a collector thread that groups requests up to ``batch`` or
  ``max_wait_ms`` (whichever first), pads the tail to the fixed batch, and
  resolves per-request futures with detections mapped back to each source
  image's pixel space.
* :class:`DetectorHTTPServer` / :func:`serve_forever` — a stdlib
  ``ThreadingHTTPServer`` front end: ``POST /predict`` with image bytes
  (JPEG/PNG, or ``application/x-mmoe-raw``: H·W·3 uint8 RGB at model
  resolution) returns JSON detections; ``GET /healthz`` (or ``/stats``)
  returns liveness and the serving stats (requests, device calls, batched
  images, last step ms, errors, and the cumulative seconds below).

Each stage of a request adds its seconds to a cumulative counter of
``stats``, whether or not a profiler is active: ``decode_s`` (turning a
body into a frame of model size: the handler's decode, ``submit``'s
resize), ``queue_wait_s`` (each request, from ``submit`` until the
collector starts its batch, ``max_wait_ms`` included), ``assemble_s`` (the
batch's host array), ``step_s`` (the serving step's call) and
``readback_s`` (its results to the host). A window's average is the
difference of two reads. Under a profiler the same stages, and
``server.respond``, are spans (``utils.profiler.annotate``).

A response never depends on its batch neighbours: convolutions, BatchNorm
in eval mode and NMS work image by image, so coalescing and zero padding
change nothing (held by tests/test_torch_server.py, and on the card by
``chip_smoke.py``'s ``server`` phase).
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, SimpleQueue
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ._device import model_device
from .utils.profiler import annotate

_SENTINEL = object()


class _Request:
    __slots__ = ("image", "context_id", "orig_size", "conf", "future", "t_submit")

    def __init__(self, image, context_id, orig_size, conf, future):
        self.image = image            # (img_h, img_w, 3) uint8, model space
        self.context_id = context_id  # int (solar bin for MoE routing)
        self.orig_size = orig_size    # (width, height) of the source image
        self.conf = conf              # per-request confidence floor
        self.future = future
        self.t_submit = time.perf_counter()


class BatchingDetector:
    """Fixed-batch serving step behind a coalescing request queue.

    ``variables`` (``LoadedDetector.variables``: the model's tensors by
    name) are loaded into ``model`` strictly; the step runs on the model's
    own device."""

    def __init__(
        self,
        model: torch.nn.Module,
        variables,
        *,
        batch: int = 16,
        img_h: int = 704,
        img_w: int = 1248,
        conf: float = 0.25,
        iou_threshold: float = 0.7,
        max_det: int = 300,
        pool: int = 512,
        early_exit: bool = False,
        max_wait_ms: float = 20.0,
    ):
        from .serving import make_serving_step

        self.batch = int(batch)
        self.img_h, self.img_w = int(img_h), int(img_w)
        self.conf = float(conf)
        self.max_wait_s = float(max_wait_ms) / 1e3
        model.load_state_dict(variables, strict=True)
        self.variables = variables
        self.device = model_device(model)
        self._step = make_serving_step(
            model.eval(),
            pool=pool,
            iou_threshold=iou_threshold,
            max_det=max_det,
            early_exit=early_exit,
        )
        self._queue: SimpleQueue = SimpleQueue()
        self._lock = threading.Lock()
        self.stats: Dict[str, Any] = {
            "requests": 0,
            "device_calls": 0,
            "batched_images": 0,
            "last_step_ms": None,
            "errors": 0,
            "decode_s": 0.0,
            "queue_wait_s": 0.0,
            "assemble_s": 0.0,
            "step_s": 0.0,
            "readback_s": 0.0,
        }
        self._closed = False
        self._thread = threading.Thread(
            target=self._collector, name="mmoe-batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- public
    def warmup(self) -> None:
        """Run the serving step once on a zero batch and wait for it: the
        kernels build and the convolution libraries initialise here, not on
        the first request."""
        zeros = torch.zeros((self.batch, self.img_h, self.img_w, 3), dtype=torch.uint8,
                            device=self.device)
        ctx = torch.zeros((self.batch,), dtype=torch.int32, device=self.device)
        res = self._step(zeros, ctx)
        int(res.valid.sum())  # a read on the host: the step has completed
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(
        self,
        image: np.ndarray,
        *,
        context_id: int = 0,
        conf: Optional[float] = None,
        orig_size: "Optional[Tuple[int, int]]" = None,
    ) -> "Future[List[dict]]":
        """Queue one image (H, W, 3 uint8, any resolution); the future
        resolves to a list of ``{"xyxy": [...], "score": s}`` detections in
        the source image's pixel space.

        ``orig_size`` (width, height): pass when ``image`` was already
        decoded+resized to model space by the caller (the HTTP handler's
        native-decode fast path) so detections still map back to the source
        pixel grid."""
        if self._closed:
            raise RuntimeError("server is closed")
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) image, got {image.shape}")
        h0, w0 = image.shape[:2]
        if orig_size is not None:
            w0, h0 = int(orig_size[0]), int(orig_size[1])
        if image.shape[:2] != (self.img_h, self.img_w):
            from PIL import Image

            with self.timed("decode"):
                image = np.asarray(
                    Image.fromarray(image.astype(np.uint8)).resize(
                        (self.img_w, self.img_h), Image.BILINEAR
                    ),
                    np.uint8,
                )
        fut: "Future[List[dict]]" = Future()
        self._queue.put(
            _Request(
                image.astype(np.uint8), int(context_id), (w0, h0),
                self.conf if conf is None else float(conf), fut,
            )
        )
        with self._lock:
            self.stats["requests"] += 1
        return fut

    def predict(self, image: np.ndarray, **kw) -> List[dict]:
        return self.submit(image, **kw).result()

    @contextlib.contextmanager
    def timed(self, stage: str):
        """Add the block's seconds to ``stats[f"{stage}_s"]``; under a
        profiler it is the span ``server.<stage>``."""
        t0 = time.perf_counter()
        with annotate(f"server.{stage}"):
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats[f"{stage}_s"] += dt

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(_SENTINEL)
            self._thread.join(timeout=30)

    # ----------------------------------------------------------- internal
    def _collector(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            group = [item]
            deadline = time.monotonic() + self.max_wait_s
            while len(group) < self.batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except Empty:
                    break
                if nxt is _SENTINEL:
                    self._run(group)
                    return
                group.append(nxt)
            self._run(group)

    def _run(self, group: List[_Request]) -> None:
        t_start = time.perf_counter()
        with self._lock:
            self.stats["queue_wait_s"] += sum(t_start - req.t_submit for req in group)
        try:
            with self.timed("assemble"):
                imgs = np.zeros(
                    (self.batch, self.img_h, self.img_w, 3), np.uint8
                )
                ctx = np.zeros((self.batch,), np.int32)
                for i, req in enumerate(group):
                    imgs[i] = req.image
                    ctx[i] = req.context_id
            t0 = time.perf_counter()
            with self.timed("step"):
                res = self._step(imgs, ctx)
            with self.timed("readback"):
                boxes = res.boxes.cpu().numpy()
                scores = res.scores.cpu().numpy()
                valid = res.valid.cpu().numpy()
            step_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.stats["device_calls"] += 1
                self.stats["batched_images"] += len(group)
                self.stats["last_step_ms"] = round(step_ms, 2)
            for i, req in enumerate(group):
                w0, h0 = req.orig_size
                keep = valid[i] & (scores[i] >= req.conf)
                sx, sy = w0 / self.img_w, h0 / self.img_h
                xyxy = boxes[i][keep] * np.array([sx, sy, sx, sy])
                xyxy[:, 0::2] = xyxy[:, 0::2].clip(0, w0)
                xyxy[:, 1::2] = xyxy[:, 1::2].clip(0, h0)
                req.future.set_result(
                    [
                        {
                            "xyxy": [round(float(v), 2) for v in b],
                            "score": round(float(s), 4),
                        }
                        for b, s in zip(xyxy, scores[i][keep])
                    ]
                )
        except Exception as e:  # one bad batch must not kill the loop
            with self._lock:
                self.stats["errors"] += 1
            for req in group:
                if not req.future.done():
                    req.future.set_exception(e)


def _jpeg_dims(data: bytes) -> "Optional[Tuple[int, int]]":
    """(width, height) from a JPEG's SOF marker, or None if not a parseable
    JPEG. ~µs header probe so the native decoder (which resizes during
    decode and never materializes the full-res image) can be used while
    still reporting detections in source-pixel space."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    i = 2
    n = len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker == 0xFF:
            # 0xFF fill byte: the marker is the LAST 0xFF in the run —
            # advance one byte so the next iteration re-tests this 0xFF
            # against the real marker (advancing 2 would skip the marker
            # and desync the scan into raw segment bytes).
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            i += 2
            continue
        if marker in (0xD9, 0xDA):  # EOI / start-of-scan: no SOF seen
            return None
        seg_len = (data[i + 2] << 8) | data[i + 3]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = (data[i + 5] << 8) | data[i + 6]
            w = (data[i + 7] << 8) | data[i + 8]
            return (w, h) if w and h else None
        i += 2 + seg_len
    return None


class _Handler(BaseHTTPRequestHandler):
    # Keep-alive: without it every request tears down its TCP connection and
    # ThreadingHTTPServer spawns a fresh thread per request. Safe because
    # every response path sends Content-Length.
    protocol_version = "HTTP/1.1"

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        will_close = self.close_connection  # set by error paths pre-response
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if will_close:
            # Advertise the close we're about to do (send_response resets
            # close_connection from the request headers, so re-assert it).
            self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = self.close_connection or will_close
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        det: BatchingDetector = self.server.detector  # type: ignore[attr-defined]
        if urlparse(self.path).path in ("/healthz", "/stats"):
            with det._lock:
                stats = dict(det.stats)
            self._json(200, {"ok": True, "batch": det.batch, **stats})
        else:
            self._json(404, {"error": "unknown path"})

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        det: BatchingDetector = self.server.detector  # type: ignore[attr-defined]
        parsed = urlparse(self.path)
        if parsed.path != "/predict":
            self._json(404, {"error": "unknown path"})
            return
        # Keep-alive safety: a request whose body we can't fully consume
        # (chunked, or no Content-Length) would leave unread bytes on the
        # socket that get parsed as the NEXT request line, poisoning the
        # persistent connection for every later request — close instead.
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            self.close_connection = True
            self._json(411, {"error": "chunked bodies unsupported; send Content-Length"})
            return
        try:
            length = int(self.headers.get("Content-Length") or "")
        except ValueError:
            self.close_connection = True
            self._json(411, {"error": "Content-Length required"})
            return
        try:
            body = self.rfile.read(length)
            kw: Dict[str, Any] = {}
            # Pre-decoded path: Content-Type application/x-mmoe-raw carries
            # H*W*3 uint8 RGB at model resolution, with no decode per
            # request; the natural path for upstream pipelines that already
            # hold decoded frames.
            ctype = (self.headers.get("Content-Type") or "").lower()
            if ctype == "application/x-mmoe-raw":
                want = det.img_h * det.img_w * 3
                if length != want:
                    self._json(400, {
                        "error": f"raw body must be exactly {want} bytes "
                                 f"({det.img_h}x{det.img_w}x3 uint8 RGB), "
                                 f"got {length}",
                    })
                    return
                with det.timed("decode"):
                    arr = np.frombuffer(body, np.uint8).reshape(
                        det.img_h, det.img_w, 3
                    )
                dims = (det.img_w, det.img_h)
                qs = parse_qs(parsed.query)
                if "context" in qs:
                    kw["context_id"] = int(qs["context"][0])
                if "conf" in qs:
                    kw["conf"] = float(qs["conf"][0])
                dets = det.predict(arr, **kw)
                with annotate("server.respond"):
                    self._json(
                        200,
                        {"width": dims[0], "height": dims[1], "detections": dets},
                    )
                return
            # Fast path: native libjpeg decode straight to model resolution
            # (decode-time resize, no full-res materialization, no PIL);
            # source dims come from the ~µs SOF header probe. The native
            # decoder's parity with PIL is held by
            # tests/test_torch_native_decode.py.
            with det.timed("decode"):
                arr = None
                dims = _jpeg_dims(body)
                if dims is not None:
                    from .data.native_decode import decode_jpeg_bytes, native_available

                    if native_available():
                        arr = decode_jpeg_bytes(body, det.img_h, det.img_w)
                        kw["orig_size"] = dims
                if arr is None:
                    from PIL import Image

                    with Image.open(io.BytesIO(body)) as im:
                        arr = np.asarray(im.convert("RGB"), np.uint8)
                    dims = (arr.shape[1], arr.shape[0])
            qs = parse_qs(parsed.query)
            if "context" in qs:
                kw["context_id"] = int(qs["context"][0])
            if "conf" in qs:
                kw["conf"] = float(qs["conf"][0])
            dets = det.predict(arr, **kw)
            with annotate("server.respond"):
                self._json(
                    200,
                    {
                        "width": dims[0],
                        "height": dims[1],
                        "detections": dets,
                    },
                )
        except Exception as e:
            self._json(400, {"error": str(e)[:300]})

    def log_message(self, fmt: str, *args) -> None:  # silence stdlib chatter
        pass


class DetectorHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr: Tuple[str, int], detector: BatchingDetector):
        super().__init__(addr, _Handler)
        self.detector = detector


def serve_forever(
    detector: BatchingDetector, host: str = "127.0.0.1", port: int = 8000
) -> None:
    httpd = DetectorHTTPServer((host, port), detector)
    print(
        f"[serve] listening on http://{host}:{httpd.server_address[1]} "
        f"(batch {detector.batch}, {detector.img_w}x{detector.img_h})",
        flush=True,
    )
    try:
        httpd.serve_forever()
    finally:
        detector.close()
