"""Concurrent-client load test for the HTTP serving layer, on the card.

The counterpart of the JAX package's ``scripts/load_test_server.py``, with
its flags, defaults, printed lines and written file. It drives a real
``DetectorHTTPServer`` (in process, the code path of
``cli/serve_detector.py``: ``server.BatchingDetector`` over
``serving.make_serving_step``, whose NMS keep mask is the ``nms_keep``
kernel on the card) with N keep-alive HTTP client threads per concurrency
level and reports, per level: achieved req/s, latency p50/p95/p99, and mean
batch fill (``batched_images / device_calls`` deltas from ``/healthz``).

Each level runs a ramp of ``min(3, duration / 3)`` seconds, then the timed
window. A level without a completion in its window has ``None``
percentiles, never NaN. Bodies are the JPEG of ``--image`` (default: a
generated scene, byte for byte JAX's) decoded by the server, or with
``--raw`` that image's RGB planes at model resolution, decoded once here
before the load starts. ``--int8`` calibrates on JAX's draw (two uniform
frames from ``np.random.default_rng(0)``) unless an int8 npz lies beside
the checkpoint. One difference from JAX's client: each client connects before
its thread starts, one after another, since the server's listen backlog is
the standard library's 5. ``MMOE_PLATFORM=cpu`` serves on the CPU.

    python -m multimodal_moe_torch.cli.load_test_server --weights outputs/runs/yolo/<run> \\
        --concurrency 1,4,8,16,32 --duration 10 [--int8]

Writes ``<out-dir>/load_test.json`` and a markdown table to stdout.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--checkpoint", choices=["best", "last"], default="best")
    p.add_argument("--img-h", type=int, default=704)
    p.add_argument("--img-w", type=int, default=1248)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=20.0)
    p.add_argument("--pool", type=int, default=512)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int8-fp-box", action="store_true")
    p.add_argument("--concurrency", type=str, default="1,4,8,16,32")
    p.add_argument("--duration", type=float, default=10.0,
                   help="Timed window per concurrency level (s).")
    p.add_argument("--raw", action="store_true",
                   help="send pre-decoded raw RGB planes (application/"
                        "x-mmoe-raw) instead of JPEG bytes: zero per-request "
                        "decode on the server, isolating HTTP+batching+device "
                        "cost on 1-core front-ends")
    p.add_argument("--image", type=str, default=None,
                   help="JPEG to send (default: a generated 1248x704 scene).")
    p.add_argument("--out-dir", type=str,
                   default=str(Path("outputs/analysis/serving_load")))
    return p.parse_args(argv)


def _make_jpeg(h: int, w: int) -> bytes:
    """Natural-ish scene JPEG (same recipe as bench.py's corpus)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(0)
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    img = np.broadcast_to(120 + 80 * y + 30 * np.sin(6.28 * 3 * x), (h, w, 3)).copy()
    for _ in range(12):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = int(rng.integers(20, 120))
        yy, xx = np.ogrid[:h, :w]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] += rng.uniform(-60, 60, 3)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=92
    )
    return buf.getvalue()


class _Client(threading.Thread):
    """One keep-alive HTTP client hammering POST /predict until stopped.
    Its connection is opened here, before the thread starts."""

    def __init__(self, port: int, body: bytes, conf: float, stop: threading.Event,
                 content_type: str = "image/jpeg"):
        super().__init__(daemon=True)
        self.port, self.body, self.conf, self.stop = port, body, conf, stop
        self.content_type = content_type
        self.latencies: "list[float]" = []
        self.errors = 0
        self.conn = http.client.HTTPConnection("127.0.0.1", self.port)
        self.conn.connect()

    def run(self) -> None:
        conn = self.conn
        path = f"/predict?conf={self.conf}"
        while not self.stop.is_set():
            t0 = time.perf_counter()
            try:
                conn.request("POST", path, body=self.body,
                             headers={"Content-Type": self.content_type})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    self.errors += 1
                    continue
                json.loads(data)
            except Exception:
                self.errors += 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", self.port)
                continue
            self.latencies.append(time.perf_counter() - t0)
        conn.close()


def _stats(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port)
    conn.request("GET", "/healthz")
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..loading import load_detector, quantize_loaded
    from ..server import BatchingDetector, DetectorHTTPServer
    from ._common import cli_device

    loaded = load_detector(
        args.weights, checkpoint=args.checkpoint,
        img_h=args.img_h, img_w=args.img_w, device=cli_device(),
    )
    if args.int8:
        rng = np.random.default_rng(0)
        calib = [rng.random((2, args.img_h, args.img_w, 3), np.float32)]
        loaded = quantize_loaded(loaded, calib, fp_box=args.int8_fp_box)

    det = BatchingDetector(
        loaded.model, loaded.variables,
        batch=args.batch, img_h=args.img_h, img_w=args.img_w,
        conf=args.conf, pool=args.pool, max_wait_ms=args.max_wait_ms,
    )
    print("[load] compiling serving step...", flush=True)
    det.warmup()
    httpd = DetectorHTTPServer(("127.0.0.1", 0), det)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    try:
        body = (
            Path(args.image).read_bytes() if args.image
            else _make_jpeg(args.img_h, args.img_w)
        )
        content_type = "image/jpeg"
        if args.raw:
            from PIL import Image
            import io as _io

            with Image.open(_io.BytesIO(body)) as im:
                arr = np.asarray(
                    im.convert("RGB").resize((args.img_w, args.img_h)), np.uint8
                )
            body = arr.tobytes()
            content_type = "application/x-mmoe-raw"
        levels = [int(c) for c in args.concurrency.split(",")]
        rows = []
        for c in levels:
            # Short warmup at this concurrency, then the timed window.
            stop = threading.Event()
            clients = [
                _Client(port, body, args.conf, stop, content_type)
                for _ in range(c)
            ]
            for cl in clients:
                cl.start()
            time.sleep(min(3.0, args.duration / 3))
            s0 = _stats(port)
            for cl in clients:
                cl.latencies.clear()
            t0 = time.perf_counter()
            time.sleep(args.duration)
            wall = time.perf_counter() - t0
            s1 = _stats(port)
            stop.set()
            for cl in clients:
                cl.join(timeout=30)

            got_any = any(cl.latencies for cl in clients)
            lat = (
                np.concatenate([np.asarray(cl.latencies) for cl in clients])
                if got_any
                else np.asarray([])
            )
            calls = s1["device_calls"] - s0["device_calls"]
            imgs = s1["batched_images"] - s0["batched_images"]

            def _pct(q):
                # Explicit zero-throughput row (no completions in the window)
                # instead of NaN percentiles in the JSON and the table.
                return round(float(np.percentile(lat, q)) * 1e3, 1) if got_any else None

            row = {
                "concurrency": c,
                "req_s": round(len(lat) / wall, 1),
                "p50_ms": _pct(50),
                "p95_ms": _pct(95),
                "p99_ms": _pct(99),
                "mean_batch_fill": round(imgs / calls, 2) if calls else None,
                "device_calls": calls,
                "errors": sum(cl.errors for cl in clients),
            }
            rows.append(row)
            print(json.dumps({"section": "level", **row}), flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        det.close()

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "weights": str(args.weights),
        "int8": args.int8,
        "batch": args.batch,
        "max_wait_ms": args.max_wait_ms,
        "duration_s": args.duration,
        "levels": rows,
    }
    (out_dir / "load_test.json").write_text(json.dumps(payload, indent=2))

    print("\n| clients | req/s | p50 ms | p95 ms | p99 ms | mean fill /"
          f"{args.batch} | errors |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['concurrency']} | {r['req_s']} | {r['p50_ms']} | "
            f"{r['p95_ms']} | {r['p99_ms']} | {r['mean_batch_fill']} | "
            f"{r['errors']} |"
        )
    print(f"\n[load] wrote {out_dir / 'load_test.json'}", flush=True)


if __name__ == "__main__":
    main()
