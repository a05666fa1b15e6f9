"""The port's dynamic-batching server (``multimodal_moe_torch/server.py``) on
the CPU: each test of tests/test_server.py mirrored against the port
(YOLO-n, 64×128, batch 4), then what the port adds to hold it to JAX.

* single-request correctness against the raw step, coalescing (``batch``
  concurrent requests → ONE device call), padding independence, the
  per-request conf, HTTP round trips + healthz, the raw-plane body, the
  DETR tail, the JPEG SOF probe, ``orig_size``;
* parity: JAX's ``BatchingDetector`` and the port's, on the same Flax
  weights (converted) and images, give the same detections in the same
  order, boxes within 0.016 px (the 2-decimal rounding plus slice 1's 5e-3
  px), scores within 1.1e-4 (the 4-decimal rounding plus the forward's
  difference). First the NMS decisions are shown well defined at the
  forward's tolerance, as tests/test_torch_evaluator.py does (class heads
  scaled by 10, conf 0.3);
* MoE-YOLO-n with ``?context=``; a tiny RT-DETR through the server; a raw
  body of the wrong size answered 400 on a connection that stays usable;
  411 for a body without ``Content-Length``; a batch that raises counts
  ``errors`` and reaches its futures.

Every wait has its own timeout; servers and detectors shut down in
``finally`` or in fixture teardown."""

import contextlib
import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import load_flax, randomize_norm
from multimodal_moe_torch.models.moe_yolo import MoEYoloDetector as TorchMoE
from multimodal_moe_torch.models.rtdetr import RTDETRDetector as TorchRTDETR
from multimodal_moe_torch.models.yolo import YoloDetector as TorchYolo
from multimodal_moe_torch.ops import nms_kernel
from multimodal_moe_torch.server import BatchingDetector, DetectorHTTPServer, _jpeg_dims
from multimodal_moe_torch.utils.profiler import clear_spans, spans
from multimodal_moe_tpu.models.yolo import YoloDetector as JaxYolo
from multimodal_moe_tpu.server import BatchingDetector as JaxBatchingDetector
from multimodal_moe_tpu.server import _jpeg_dims as jax_jpeg_dims
from test_torch_evaluator import SCORE_THR, Pair, _assert_well_defined, _scaled_yolo_heads

H, W, BATCH = 64, 128, 4
WAIT = 120  # seconds: every blocking wait has one
STAGE_KEYS = ("decode_s", "queue_wait_s", "assemble_s", "step_s", "readback_s")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several pytest workers side by
    side, and more threads each only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _detector(model, **kw):
    kw = {"batch": BATCH, "img_h": H, "img_w": W, "conf": 0.0, "max_wait_ms": 300.0, **kw}
    return BatchingDetector(model, dict(model.state_dict()), **kw)


@pytest.fixture(scope="module")
def detector():
    torch.manual_seed(0)
    det = _detector(TorchYolo(num_classes=1, variant="n"))
    try:
        det.warmup()
        yield det
    finally:
        det.close()


@contextlib.contextmanager
def serving(detector):
    """The detector behind a ``DetectorHTTPServer`` on a free port."""
    httpd = DetectorHTTPServer(("127.0.0.1", 0), detector)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def _img(seed: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


def _raw_row(detector, img, ctx=0):
    """Row 0 of the raw step on a zero-padded batch: (boxes, scores) kept."""
    batch = np.zeros((detector.batch, detector.img_h, detector.img_w, 3), np.uint8)
    batch[0] = img
    ctx_ids = np.zeros((detector.batch,), np.int32)
    ctx_ids[0] = ctx
    res = detector._step(batch, ctx_ids)
    valid = res.valid[0].numpy()
    return res.boxes[0].numpy()[valid], res.scores[0].numpy()[valid]


def _assert_matches_raw(dets, boxes, scores, w=W, h=H):
    assert len(dets) == len(boxes)
    got = np.array([d["xyxy"] for d in dets]).reshape(-1, 4)
    np.testing.assert_allclose(got, boxes.clip(0, [w, h, w, h]), atol=0.011)
    np.testing.assert_allclose([d["score"] for d in dets], scores, atol=1e-4)


# --------------------------------------------------------------------------
# tests/test_server.py, against the port
# --------------------------------------------------------------------------

def test_single_request_matches_raw_step(detector):
    img = _img(0)
    dets = detector.predict(img)
    assert isinstance(dets, list) and len(dets) > 0  # conf 0.0: the pool fills
    _assert_matches_raw(dets, *_raw_row(detector, img))


def test_coalesces_full_batch_into_one_device_call(detector):
    calls_before = detector.stats["device_calls"]
    futs = []
    barrier = threading.Barrier(BATCH)

    def go(i):
        barrier.wait(timeout=WAIT)
        futs.append(detector.submit(_img(i + 10)))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(BATCH)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    results = [f.result(timeout=WAIT) for f in futs]
    assert all(isinstance(r, list) for r in results)
    # 4 requests inside one 300ms window, batch 4 -> exactly one step
    assert detector.stats["device_calls"] == calls_before + 1


def test_response_independent_of_batch_neighbours(detector):
    img = _img(99)
    solo = detector.submit(img).result(timeout=WAIT)
    futs = [detector.submit(_img(50 + i)) for i in range(BATCH - 1)]
    futs.append(detector.submit(img))
    batched = futs[-1].result(timeout=WAIT)
    for f in futs[:-1]:
        f.result(timeout=WAIT)
    assert solo == batched


def test_per_request_conf_filters(detector):
    # random-init class logits sit near the prior: sigmoid ~0.01 < 0.999
    assert detector.submit(_img(7), conf=0.999).result(timeout=WAIT) == []


def test_resizes_and_rescales_to_source_pixels(detector):
    dets = detector.submit(_img(3, h=2 * H, w=3 * W)).result(timeout=WAIT)
    assert len(dets) > 0
    for d in dets:
        x1, y1, x2, y2 = d["xyxy"]
        assert 0 <= x1 <= 3 * W and 0 <= x2 <= 3 * W
        assert 0 <= y1 <= 2 * H and 0 <= y2 <= 2 * H


def test_http_roundtrip_and_healthz(detector):
    from PIL import Image

    with serving(detector) as port:
        buf = io.BytesIO()
        Image.fromarray(_img(42)).save(buf, format="JPEG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict?conf=0.0", data=buf.getvalue()
        )
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            payload = json.loads(resp.read())
        assert resp.status == 200
        assert payload["width"] == W and payload["height"] == H
        assert len(payload["detections"]) > 0
        for d in payload["detections"]:
            assert set(d) == {"xyxy", "score"}

        for path in ("healthz", "stats"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}", timeout=30) as resp:
                health = json.loads(resp.read())
            assert health["ok"] is True
            assert health["batch"] == BATCH
            assert health["device_calls"] >= 1
            assert health["requests"] >= 1
            assert set(health) == {"ok", "batch", "requests", "device_calls",
                                   "batched_images", "last_step_ms", "errors", *STAGE_KEYS}

        # unknown path -> 404 JSON, not a stack trace
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert err.value.code == 404
        assert json.loads(err.value.read()) == {"error": "unknown path"}


def test_http_raw_plane_path_matches_jpeg_free_decode(detector):
    """application/x-mmoe-raw carries pre-decoded H*W*3 uint8 RGB at model
    resolution: the server skips decode and returns the detections
    ``submit()`` gives for the same array; a wrong-sized body is a 400."""
    with serving(detector) as port:
        img = _img(7)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict?conf=0.0",
            data=img.tobytes(),
            headers={"Content-Type": "application/x-mmoe-raw"},
        )
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            payload = json.loads(resp.read())
        assert resp.status == 200
        assert payload["width"] == W and payload["height"] == H
        direct = detector.submit(img, conf=0.0).result(timeout=WAIT)
        assert payload["detections"] == direct

        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=img.tobytes()[:-7],
            headers={"Content-Type": "application/x-mmoe-raw"},
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400


def test_detr_family_takes_nms_free_tail():
    """``make_serving_step`` resolves the tail from model outputs: a
    DETR-style head (no ``anchor_points``) routes to ``detr_topk_select``."""
    from multimodal_moe_torch.serving import make_serving_step

    class FakeDetr(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("anchor", torch.zeros(1))

        def forward(self, images):
            b, q = images.shape[0], 8
            boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]]).repeat(b, q, 1)
            logits = torch.linspace(-2.0, 2.0, q)[None, :, None].repeat(b, 1, 1)
            return {"boxes": boxes, "cls_logits": logits}

    step = make_serving_step(FakeDetr(), max_det=5)
    res = step(torch.zeros((2, 16, 16, 3), dtype=torch.uint8))
    # top-5 of 8 queries by score, all with the same box, no NMS suppression
    assert tuple(res.scores.shape) == (2, 5)
    assert bool(res.valid.all())
    assert float(res.scores[0, 0]) > float(res.scores[0, -1])


def test_jpeg_dims_probe():
    """SOF header probe: correct (w, h) for baseline + progressive JPEGs,
    None for non-JPEG bytes; the same answers as JAX's probe."""
    from PIL import Image

    arr = _img(5, h=123, w=457)
    cases = []
    for progressive in (False, True):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", progressive=progressive)
        assert _jpeg_dims(buf.getvalue()) == (457, 123), progressive
        cases.append(buf.getvalue())
    png = io.BytesIO()
    Image.fromarray(arr).save(png, format="PNG")
    assert _jpeg_dims(png.getvalue()) is None
    assert _jpeg_dims(b"") is None
    assert _jpeg_dims(b"\xff\xd8\xff\xd9") is None  # SOI+EOI, no SOF
    # 0xFF fill bytes before a marker are legal (ITU T.81 B.1.1.2): the
    # marker is the LAST 0xFF of the run.
    data = cases[0]
    padded = data[:2] + b"\xff" * 3 + data[2:]
    assert _jpeg_dims(padded) == (457, 123)
    for case in cases + [png.getvalue(), b"", b"\xff\xd8\xff\xd9", padded]:
        assert _jpeg_dims(case) == jax_jpeg_dims(case)


def test_submit_orig_size_maps_back(detector):
    """A pre-resized (model-space) image with an explicit ``orig_size``
    returns detections in the ORIGINAL pixel grid."""
    dets_native = detector.submit(_img(3), orig_size=(3 * W, 2 * H)).result(timeout=WAIT)
    assert len(dets_native) > 0
    for d in dets_native:
        x1, y1, x2, y2 = d["xyxy"]
        assert 0 <= x1 <= 3 * W and 0 <= x2 <= 3 * W
        assert 0 <= y1 <= 2 * H and 0 <= y2 <= 2 * H
    dets_model = detector.submit(_img(3)).result(timeout=WAIT)
    assert len(dets_model) == len(dets_native)
    for dm, dn in zip(dets_model, dets_native):
        assert dn["xyxy"][0] == pytest.approx(dm["xyxy"][0] * 3, abs=0.05)
        assert dn["xyxy"][1] == pytest.approx(dm["xyxy"][1] * 2, abs=0.05)


# --------------------------------------------------------------------------
# the port against JAX's server, and what else the port must hold
# --------------------------------------------------------------------------

def test_matches_jax_batching_detector():
    jmodel = JaxYolo(num_classes=1, variant="n")
    variables = jax.device_get(jax.jit(
        lambda r: jmodel.init(r, jnp.zeros((1, H, W, 3)), train=False))(jax.random.PRNGKey(0)))
    variables = _scaled_yolo_heads(randomize_norm(variables, seed=2))
    pair = Pair(jmodel, variables, load_flax(TorchYolo(num_classes=1, variant="n"), variables))
    images = [_img(200 + i) for i in range(BATCH)]
    batch = {"image": np.stack(images), "batch_valid": np.ones(BATCH, bool)}
    _assert_well_defined([batch], [pair.anchor_outputs(batch["image"])], box_tol=5e-3)

    kw = dict(batch=BATCH, img_h=H, img_w=W, conf=SCORE_THR, max_wait_ms=300.0)
    jdet = JaxBatchingDetector(jmodel, variables, **kw)
    tdet = BatchingDetector(pair.tmodel, pair.params, **kw)
    try:
        results = []
        for det in (jdet, tdet):
            futs = [det.submit(img) for img in images]
            results.append([f.result(timeout=WAIT) for f in futs])
    finally:
        jdet.close()
        tdet.close()
    assert tdet.stats["device_calls"] == 1 and tdet.stats["errors"] == 0
    n = 0
    for ref, got in zip(*results):
        assert len(got) == len(ref)
        n += len(got)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g["xyxy"], r["xyxy"], rtol=0, atol=0.016)
            assert abs(g["score"] - r["score"]) <= 1.1e-4
    assert n >= 5


def test_moe_context_query_reaches_the_router():
    torch.manual_seed(1)
    model = TorchMoE(num_classes=1, variant="n")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("context_bias"):
                p.copy_(torch.randn(p.shape, generator=gen))
    det = _detector(model, max_wait_ms=5.0)
    img = _img(31)
    try:
        with serving(det) as port:
            answers = {}
            for ctx in (3, 0):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict?context={ctx}", data=img.tobytes(),
                    headers={"Content-Type": "application/x-mmoe-raw"})
                with urllib.request.urlopen(req, timeout=WAIT) as resp:
                    answers[ctx] = json.loads(resp.read())["detections"]
        _assert_matches_raw(answers[3], *_raw_row(det, img, ctx=3))
        _assert_matches_raw(answers[0], *_raw_row(det, img, ctx=0))
        assert answers[3] != answers[0]  # other bins, other scores
    finally:
        det.close()


def test_rtdetr_through_the_server():
    torch.manual_seed(3)
    model = TorchRTDETR(num_classes=1, hidden_dim=64, num_queries=20, num_decoder_layers=2,
                        num_heads=4, backbone_depths=(1, 1, 1, 1))
    det = _detector(model, max_det=10, max_wait_ms=5.0)
    try:
        det.warmup()
        img = _img(41)
        before = nms_kernel.nms_keep_launches
        dets = det.submit(img).result(timeout=WAIT)
        assert nms_kernel.nms_keep_launches == before
        assert len(dets) == 10  # the top-10 queries, no NMS
        boxes, scores = _raw_row(det, img)
        _assert_matches_raw(dets, boxes, scores)
        assert [d["score"] for d in dets] == sorted((d["score"] for d in dets), reverse=True)
    finally:
        det.close()


def test_raw_body_400_keeps_the_connection_usable(detector):
    img = _img(8)
    raw = {"Content-Type": "application/x-mmoe-raw"}
    with serving(detector) as port:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
        try:
            conn.request("POST", "/predict", body=img.tobytes()[:-3], headers=raw)
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 400 and "raw body must be exactly" in body["error"]
            conn.request("POST", "/predict?conf=0.0", body=img.tobytes(), headers=raw)
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read())["detections"] == detector.submit(img).result(
                timeout=WAIT)
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["ok"] is True
        finally:
            conn.close()


def test_body_without_length_is_411(detector):
    with serving(detector) as port:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
        try:
            conn.putrequest("POST", "/predict")
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 411 and resp.getheader("Connection") == "close"
            assert "Content-Length" in json.loads(resp.read())["error"]
        finally:
            conn.close()


def test_failing_batch_reaches_its_futures():
    torch.manual_seed(0)
    det = _detector(TorchYolo(num_classes=1, variant="n"), max_wait_ms=5.0)

    def broken(images, context_ids=None):
        raise RuntimeError("device lost")

    try:
        det._step = broken
        fut = det.submit(_img(1))
        with pytest.raises(RuntimeError, match="device lost"):
            fut.result(timeout=WAIT)
        assert det.stats["errors"] == 1 and det.stats["device_calls"] == 0
    finally:
        det.close()
    with pytest.raises(RuntimeError, match="closed"):
        det.submit(_img(1))


# --------------------------------------------------------------------------
# the stage counters and spans the port adds
# --------------------------------------------------------------------------

def _stats(det):
    with det._lock:
        return dict(det.stats)


def _post_jpeg(port, img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict?conf=0.0",
                                 data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_stage_seconds_only_grow_and_count_the_batching_wait(detector):
    """A lone request waits the whole ``max_wait_ms`` (300 ms) for company:
    ``queue_wait_s`` counts it. Each stage's cumulative seconds grow with
    every batch, and a body decoded by the handler (or a frame resized by
    ``submit``) adds to ``decode_s``."""
    before = _stats(detector)
    detector.submit(_img(41, h=2 * H, w=W)).result(timeout=WAIT)    # resized: a decode
    mid = _stats(detector)
    assert mid["queue_wait_s"] - before["queue_wait_s"] >= 0.29
    for k in STAGE_KEYS:
        assert mid[k] > before[k], k
    with serving(detector) as port:
        _post_jpeg(port, _img(42))
    after = _stats(detector)
    for k in STAGE_KEYS:
        assert after[k] > mid[k], k
    assert after["device_calls"] == mid["device_calls"] + 1


def test_server_spans_name_each_stage_and_thread(detector):
    """Under a profiler: ``server.decode`` and ``server.respond`` on the
    handler's thread; ``server.assemble``, ``server.step`` (the serving
    step's ``serve.step`` inside it) and ``server.readback`` on the
    collector's."""
    clear_spans()
    try:
        with serving(detector) as port:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                _post_jpeg(port, _img(43))
            for _ in range(200):        # the handler ends its span after the client has read
                if any(s["name"] == "server.respond" for s in spans()):
                    break
                threading.Event().wait(0.05)
        log = spans()
        by_name = {s["name"]: s for s in log}
        assert {(s["name"], s["parent"]) for s in log if s["name"].startswith("server.")} == {
            ("server.decode", None), ("server.respond", None), ("server.assemble", None),
            ("server.step", None), ("server.readback", None)}
        assert by_name["serve.step"]["parent"] == "server.step"
        assert by_name["server.decode"]["thread"] == by_name["server.respond"]["thread"]
        for name in ("server.assemble", "server.step", "server.readback"):
            assert by_name[name]["thread"] == "mmoe-batcher"
    finally:
        clear_spans()
