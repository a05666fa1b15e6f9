"""Open-loop HTTP load: Poisson arrivals at a fixed rate over keep-alive
connections, from a process of its own (it imports neither torch nor the
port).

    python -m gpubench.http_client --port P --rate R --seconds S --seed N \\
        --connections 64 < bodies

The bodies come on standard input: a 4-byte count, then each body as a
4-byte length and its bytes. The arrival times and each request's body are
drawn from ``--seed`` in this way: every seed sends the same multiset of
gaps between arrivals (exponential at the rate, drawn once), in an order
and with bodies drawn from the seed, so runs differ in order and not in
load. First ``--warmup`` seconds of requests at the same rate go out and
are answered, outside the window. Request ``k`` posts to ``/predict?context=k``: the
server hands the context to the serving step beside the image (a detector
that is not context-routed ignores it), so the step's inputs name the
requests in each device call. A request is due at its arrival time; it
goes out on the next free connection, and its latency runs from when it
was due to the last byte of its response, so a stall shows in every
request behind it. Once the schedule is done the client waits up to
``--grace`` seconds for the answers. It prints ``ready`` when its
connections are open, then one JSON object: each request's frame, due
time, latency (None if it failed or never came), status and answer, and
how late the generator ran.
"""

from __future__ import annotations

import argparse
import http.client
import json
import queue
import random
import struct
import sys
import threading
import time


def read_bodies(stream) -> list:
    (n,) = struct.unpack("<I", stream.read(4))
    out = []
    for _ in range(n):
        (size,) = struct.unpack("<I", stream.read(4))
        out.append(stream.read(size))
    return out


def write_bodies(stream, bodies: list) -> None:
    stream.write(struct.pack("<I", len(bodies)))
    for b in bodies:
        stream.write(struct.pack("<I", len(b)))
        stream.write(b)


def schedule(rate: float, seconds: float, n_bodies: int, seed: int) -> list:
    """(due seconds, body index) of every arrival: the gaps of a Poisson
    process at ``rate`` over ``seconds``, drawn once, in the order and with
    the bodies of ``seed``."""
    fixed = random.Random(0)
    gaps, t = [], 0.0
    while True:
        g = fixed.expovariate(rate)
        if t + g >= seconds:
            break
        gaps.append(g)
        t += g
    rng = random.Random(seed)
    rng.shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        t += g
        out.append((t, rng.randrange(n_bodies)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--rate", type=float, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--connections", type=int, default=64)
    p.add_argument("--grace", type=float, default=60.0)
    p.add_argument("--warmup", type=float, default=0.0)
    args = p.parse_args(argv)
    bodies = read_bodies(sys.stdin.buffer)
    plan = schedule(args.rate, args.seconds, len(bodies), args.seed)
    results: list = [None] * len(plan)
    work: "queue.Queue" = queue.Queue()
    warm: "queue.Queue" = queue.Queue()

    # One connection after another: the server's listen backlog is 5.
    conns = [http.client.HTTPConnection("127.0.0.1", args.port, timeout=args.grace)
             for _ in range(args.connections)]
    for c in conns:
        c.connect()
    t0_box: list = []

    def worker(conn):
        while True:
            item = work.get()
            if item is None:
                return
            k, due, frame = item
            status, answer = None, None
            try:
                conn.request("POST", f"/predict?context={k}", body=bodies[frame],
                             headers={"Content-Type": "image/jpeg"})
                resp = conn.getresponse()
                answer = resp.read().decode()
                status = resp.status
                done = time.perf_counter() - t0_box[0]
            except (OSError, http.client.HTTPException, UnicodeDecodeError):
                conn.close()
                done = None
            if k < 0:
                warm.put(status)
                continue
            latency = None if done is None or status != 200 else done - due
            results[k] = {"frame": frame, "due": due, "latency": latency, "status": status,
                          "answer": answer}

    threads = [threading.Thread(target=worker, args=(c,), daemon=True) for c in conns]
    for t in threads:
        t.start()

    def send(items, start):
        t0_box[:] = [start]
        late = 0.0
        for k, (due, frame) in items:
            wait = due - (time.perf_counter() - start)
            if wait > 0:
                time.sleep(wait)
            late = max(late, time.perf_counter() - start - due)
            work.put((k, due, frame))
        return late

    warm_plan = schedule(args.rate, args.warmup, len(bodies), args.seed + 1)
    send([(-1 - j, x) for j, x in enumerate(warm_plan)], time.perf_counter())
    for _ in warm_plan:
        if warm.get(timeout=args.grace) != 200:
            raise SystemExit("a warm-up request failed")
    print("ready", flush=True)
    late = send(list(enumerate(plan)), time.perf_counter())
    for _ in threads:
        work.put(None)
    end = time.perf_counter() + args.seconds + args.grace
    for t in threads:
        t.join(timeout=max(0.0, end - time.perf_counter()))
    out = {"requests": [r if r is not None else {"frame": plan[k][1], "due": plan[k][0],
                                                  "latency": None, "status": None, "answer": None}
                        for k, r in enumerate(results)],
           "generator_late_s": late}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
