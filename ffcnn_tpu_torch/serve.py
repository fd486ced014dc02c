"""The HTTP inference service over the port's pipeline, the port of
``ffcnn_tpu/serve.py`` (stdlib only):

    GET  /healthz          -> 200 "ok" once every batch bucket is built and
                              a probe inference has run
    GET  /dump             -> the net_dump layer table
    GET  /statz            -> JSON serving metrics: request/image/dispatch
                              counters, dispatch-batch histogram, p50/p99
                              dispatch latency, error counts, queue depth
    POST /detect           -> body: one 24-bit BMP; response: JSON
                              {"detections": [{score, class_id, box}, ...]}

Concurrent requests are MICRO-BATCHED: the card's throughput comes from
batching, so request threads enqueue decoded images and one dispatcher
thread drains the queue into one padded batch per dispatch.  Same-size
images share a dispatch, and the batch is bucketed to powers of two, so
steady load replays a handful of captured graphs (``Net.warmup`` captures
them before /healthz goes green).

    python -m ffcnn_tpu_torch.serve --cfg models/yolo-fastest-xl.cfg \
        --weights yolo-fastest-xl.weights          # on the card

``--device cpu`` serves from the CPU (tests).  ``--mode int8`` serves an
int8 plan: ``--quant-plan PATH`` loads it where the file exists, else it is
calibrated from ``--calib`` BMP frames and, with ``--quant-plan``, saved
there (the JAX package's npz format, so either package's plan serves).

    python -m ffcnn_tpu_torch.serve --artifact m.b1.pt2 m.b2.pt2 ...

serves ``cli export`` artifacts (``export.ArtifactNet``): no cfg, no
weights file, no graph builder; the artifacts' golden probes must replay
before /healthz goes green.  Not ported yet, and refused: ``--dp`` (M14).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .imageio.bmp import bmp_decode


class Overloaded(RuntimeError):
    """Raised by MicroBatcher.detect when the pending-request bound is hit;
    the HTTP layer maps it to 503 so a load balancer sheds load instead of
    the process queueing unboundedly toward OOM."""


class _Pending:
    __slots__ = ("img", "event", "result", "error")

    def __init__(self, img):
        self.img = img
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Collect concurrent same-size requests into one device dispatch.

    Requests are grouped by image shape; the dispatcher always serves the
    group that has waited longest and re-queues a group with leftovers at the
    BACK of the rotation, so mixed-size traffic is served round-robin — a
    steady stream of one size can never starve another (a v1 defect).  The
    pending set is bounded (``Overloaded`` beyond ``max_pending``), waits are
    bounded (``wait_timeout``), and the dispatcher survives ANY per-round
    exception by fanning it out to that round's callers."""

    def __init__(self, net, max_batch: int = 64, max_pending: int = 512,
                 wait_timeout: float = 300.0):
        self.net = net
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.wait_timeout = wait_timeout
        self._cv = threading.Condition()
        self._groups: "OrderedDict[tuple, deque]" = OrderedDict()
        self._npending = 0
        self._closed = False
        # Serving metrics (GET /statz).  Mutated only by the dispatcher
        # thread except requests/overloaded (request threads, int += under
        # the CPython GIL is fine for counters read loosely).
        self.metrics = {"requests": 0, "images": 0, "dispatches": 0,
                        "dispatch_errors": 0, "overloaded": 0,
                        "padded_slots": 0, "batch_hist": {}}
        self._dispatch_ms = deque(maxlen=512)
        # Rounds overlap only when the net can dispatch without blocking;
        # for sync-only nets the previous round must be fanned out FIRST
        # (its results are already done: holding them behind the next
        # round's blocking detect() would double caller latency).
        self._async = callable(getattr(net, "detect_async", None))
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._closed

    def close(self):
        """Stop the dispatcher after the current round; pending and future
        requests fail fast instead of blocking."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def detect(self, img):
        p = _Pending(img)
        with self._cv:
            self.metrics["requests"] += 1
            if self._closed or not self._thread.is_alive():
                raise RuntimeError("batcher dispatcher is not running")
            if self._npending >= self.max_pending:
                self.metrics["overloaded"] += 1
                raise Overloaded(
                    f"{self._npending} requests pending (max {self.max_pending})")
            self._groups.setdefault(tuple(img.shape), deque()).append(p)
            self._npending += 1
            self._cv.notify()
        if not p.event.wait(self.wait_timeout):
            p.error = TimeoutError("batcher did not answer in "
                                   f"{self.wait_timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _take_group(self):
        """(lock held) Pop up to max_batch requests from the oldest size
        group; rotate a non-empty remainder to the back of the order."""
        shape, dq = next(iter(self._groups.items()))
        group = []
        while dq and len(group) < self.max_batch:
            group.append(dq.popleft())
        del self._groups[shape]
        if dq:
            self._groups[shape] = dq          # to the back: round-robin
        self._npending -= len(group)
        return group

    def _fail_all(self, err):
        with self._cv:
            groups, self._groups = self._groups, OrderedDict()
            self._npending = 0
        for dq in groups.values():
            for p in dq:
                p.error = err
                p.event.set()

    def _dispatch(self, group):
        """Assemble one padded batch and start its device round.  Returns
        (finish, t0): ``finish()`` blocks until results and returns the
        per-image Detection lists.  A net exposing ``detect_async`` (the
        port's ``Net`` does) gets true overlap: the upload and the replay
        run while the dispatcher assembles and starts the NEXT round and
        fans out the PREVIOUS round's results (``Net.detect_device``
        returns clones, so the next replay cannot overwrite them); a net
        with only ``detect`` runs inline (and the loop completes the
        previous round first)."""
        n = self._bucket(len(group))
        batch = np.zeros((n,) + group[0].img.shape, np.uint8)
        for i, p in enumerate(group):
            batch[i] = p.img
        t0 = time.perf_counter()
        if self._async:
            return self.net.detect_async(batch), t0
        results = self.net.detect(batch)
        return (lambda: results), t0

    def _complete(self, group, finish, t0):
        """Wait for one round's results and fan them out to its callers."""
        try:
            results = finish()
            m = self.metrics
            m["dispatches"] += 1
            m["images"] += len(group)
            m["padded_slots"] += self._bucket(len(group)) - len(group)
            n = self._bucket(len(group))
            m["batch_hist"][n] = m["batch_hist"].get(n, 0) + 1
            self._dispatch_ms.append((time.perf_counter() - t0) * 1000.0)
            for p, dets in zip(group, results):
                p.result = dets
                p.event.set()
        except Exception as e:  # noqa: BLE001 — fan out, keep serving
            self.metrics["dispatch_errors"] += 1
            for p in group:
                p.error = e
                p.event.set()

    def _loop(self):
        prev = None                       # (group, finish, t0) in flight
        while True:
            try:
                with self._cv:
                    while not self._groups and not self._closed \
                            and prev is None:
                        self._cv.wait()
                    if self._closed:
                        break
                    group = self._take_group() if self._groups else None
                if group is not None and not self._async and prev is not None:
                    # Sync-only net: the previous round's results are done;
                    # fan them out before blocking in the next dispatch.
                    self._complete(*prev)
                    prev = None
                if group is not None:
                    # Async net: start this round BEFORE completing the
                    # previous one — the device is never idle while the
                    # dispatcher copies pixels or decodes results.
                    try:
                        nxt = (group,) + self._dispatch(group)
                    except Exception as e:  # noqa: BLE001 — dispatch failed
                        self.metrics["dispatch_errors"] += 1
                        for p in group:
                            p.error = e
                            p.event.set()
                        nxt = None
                else:
                    nxt = None            # idle: just drain the in-flight round
                if prev is not None:
                    self._complete(*prev)
                prev = nxt
            except BaseException as e:  # noqa: BLE001 — never die silently
                err = RuntimeError(f"batcher dispatcher error: {e!r}")
                if prev is not None:
                    # the in-flight round's callers are no longer queued;
                    # fail them explicitly or they block until wait_timeout
                    for p in prev[0]:
                        p.error = err
                        p.event.set()
                    prev = None
                self._fail_all(err)
        if prev is not None:
            self._complete(*prev)
        self._fail_all(RuntimeError("batcher closed"))


def parse_geometry(geo: str) -> tuple:
    """``"WxH"`` (the CLI convention, e.g. 640x480) -> ``(h, w)`` (the
    internal image-array convention used by warmup/probe sizes)."""
    w, h = map(int, geo.lower().split("x"))
    if w <= 0 or h <= 0:
        raise ValueError(geo)
    return (h, w)


class DetectorService:
    # Largest request body accepted by POST /detect: a 24-bit BMP at
    # 2048x2048 is ~12 MB; anything bigger is rejected before the body is
    # read so one request can't allocate arbitrary memory pre-validation.
    MAX_BODY_BYTES = 16 << 20

    def __init__(self, net, probe_hw=None, max_batch: int = 64,
                 max_pending: int = 512, warm_batches=None, warm_hw=()):
        self.net = net
        self._ready = False
        self._error: str | None = None
        self._batcher = MicroBatcher(net, max_batch=max_batch,
                                     max_pending=max_pending)
        # Probe at the model's own input size: each distinct request image
        # size still builds its own bucket lazily on first use, but the
        # common case (images at/near net dims) is hot at ready time.
        # (an ArtifactNet has fixed shapes and gives its input_hw)
        self._probe_hw = probe_hw or (
            net.input_hw if hasattr(net, "input_hw")
            else (net.ir.blobs[0].h, net.ir.blobs[0].w))
        # Warm every batch bucket the batcher can emit (1,2,4,...,max_batch):
        # otherwise the first concurrent burst after /healthz goes green pays
        # a graph capture per new bucket.
        if warm_batches is None:
            warm_batches, b = [], 1
            while b <= max_batch:
                warm_batches.append(b)
                b *= 2
        self._warm_batches = tuple(warm_batches)
        # Extra (h, w) request geometries to pre-warm alongside probe_hw.
        # Each distinct request image size is its own bucket, so a worker
        # that will see e.g. 480x640 camera frames should warm that
        # geometry up front, or the first request at it pays the capture.
        self._warm_hw = tuple(dict.fromkeys(
            (self._probe_hw,) + tuple(warm_hw)))

    def warmup(self):
        """Build and run probes at every dispatchable batch bucket (and
        every requested warm geometry) so /healthz reflects real
        readiness.  A warmup failure is captured and
        surfaced through /healthz rather than dying silently in the
        background thread."""
        if self._ready:
            return
        try:
            self.net.warmup(image_sizes=list(self._warm_hw),
                            batch_sizes=self._warm_batches)
            self._ready = True
        except Exception as e:  # noqa: BLE001 — report via health check
            self._error = f"{type(e).__name__}: {e}"
            raise

    @property
    def ready(self) -> bool:
        # A wedged/dead dispatcher must flip health red even after a good
        # warmup, or a load balancer keeps routing to a stuck worker.
        return self._ready and self._batcher.alive

    @property
    def error(self) -> str | None:
        if self._error is None and self._ready and not self._batcher.alive:
            return "batcher dispatcher is not running"
        return self._error

    def stats(self) -> dict:
        """Serving metrics snapshot (GET /statz): counters, dispatch-batch
        histogram, and p50/p99 dispatch wall latency over the last 512
        dispatches.  Wall time here includes the upload, the replay and
        the wait for its results: the number a capacity planner sees, not
        the kernels' device time."""
        b = self._batcher
        # Lock-free snapshot: the dispatcher may append mid-copy, which can
        # raise "mutated during iteration" — retry rather than lock the
        # serving hot path for a metrics read.
        for _ in range(8):
            try:
                lat = sorted(b._dispatch_ms)
                snap = {k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in b.metrics.items()}
                break
            except RuntimeError:
                continue
        else:
            lat, snap = [], {"batch_hist": {}}
        pct = (lambda q: round(lat[min(len(lat) - 1,
                                       int(q * len(lat)))], 2)) if lat \
            else (lambda q: None)
        m = snap
        m["batch_hist"] = {str(k): v
                           for k, v in sorted(m["batch_hist"].items())}
        m.update(pending=b._npending, ready=self.ready,
                 dispatch_p50_ms=pct(0.50), dispatch_p99_ms=pct(0.99))
        return m

    def detect_bmp_bytes(self, raw: bytes):
        img = bmp_decode(raw)
        dets = self._batcher.detect(img)     # concurrent requests coalesce
        return [{"score": round(d.score, 4), "class_id": d.class_id,
                 "box": [round(v, 2) for v in (d.x1, d.y1, d.x2, d.y2)]}
                for d in dets]


def make_server(service: DetectorService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):           # quiet; structured logs upstream
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                if service.ready:
                    self._send(200, b"ok", "text/plain")
                elif service.error:
                    self._send(503, f"warmup failed: {service.error}"
                               .encode(), "text/plain")
                else:
                    self._send(503, b"warming up", "text/plain")
            elif self.path == "/dump":
                self._send(200, service.net.dump().encode(), "text/plain")
            elif self.path == "/statz":
                self._send(200, json.dumps(service.stats()).encode())
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/detect":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", "0"))
            if n > service.MAX_BODY_BYTES:
                self._send(413, json.dumps(
                    {"error": f"body {n} bytes exceeds "
                              f"{service.MAX_BODY_BYTES}"}).encode())
                return
            raw = self.rfile.read(n)
            try:
                dets = service.detect_bmp_bytes(raw)
            except Overloaded as e:
                self._send(503, json.dumps({"error": str(e)}).encode())
                return
            except TimeoutError as e:
                self._send(504, json.dumps({"error": str(e)}).encode())
                return
            except Exception as e:  # noqa: BLE001 — surface as 400
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            self._send(200, json.dumps({"detections": dets}).encode())

    return ThreadingHTTPServer((host, port), Handler)


def parser() -> argparse.ArgumentParser:
    """The server's command line."""
    ap = argparse.ArgumentParser(prog="python -m ffcnn_tpu_torch.serve")
    ap.add_argument("--cfg", default=None,
                    help="the model's cfg (needed without --artifact)")
    ap.add_argument("--weights", default=None,
                    help="its weights (needed without --artifact)")
    ap.add_argument("--mode", choices=("fast", "parity", "int8"),
                    default="fast")
    ap.add_argument("--calib", nargs="*", default=None,
                    help="representative BMP frames for int8 calibration "
                         "(needed with --mode int8 unless --quant-plan "
                         "names a saved plan)")
    ap.add_argument("--quant-plan", default=None,
                    help="int8 calibration cache: loaded if it exists, "
                         "else written after calibrating from --calib")
    ap.add_argument("--artifact", nargs="*", default=None,
                    help="serve from torch.export artifacts (cli export) "
                         "instead of cfg/weights: the worker needs no model "
                         "files and builds no graph; export buckets "
                         "1,2,4,... up to the wanted max batch")
    ap.add_argument("--dp", action="store_true",
                    help="not ported yet (ROADMAP M14)")
    ap.add_argument("--warm-hw", nargs="*", default=(), metavar="WxH",
                    help="extra request geometries to pre-warm (e.g. "
                         "640x480 for camera frames): each distinct request "
                         "image size is its own bucket; warming it here "
                         "moves its capture before /healthz goes green "
                         "instead of into the first unlucky client's "
                         "latency")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' is asked for")
    return ap


def load_net(args, error):
    """The Net ``args`` ask for, its int8 plan installed in int8 mode (as
    ``ffcnn_tpu/serve.py::main`` installs it); ``error(message)`` for
    arguments that cannot serve."""
    if args.mode == "int8" and not (
            args.calib or (args.quant_plan
                           and os.path.exists(args.quant_plan))):
        error("--mode int8 requires --calib <frame.bmp> [...] or an "
              "existing --quant-plan")
    from .net import Net
    if not (args.cfg and args.weights):
        error("--cfg and --weights are required without --artifact")
    net = Net.load(args.cfg, args.weights, mode=args.mode,
                   cache_dir=args.cache_dir, device=args.device)
    if args.mode == "int8":
        from .quant import load_plan, save_plan
        if args.quant_plan and os.path.exists(args.quant_plan):
            net.set_quant_plan(load_plan(args.quant_plan, net.device))
        else:
            from .imageio.bmp import bmp_load
            net.calibrate(np.stack([bmp_load(p) for p in args.calib]))
            if args.quant_plan:
                save_plan(args.quant_plan, net.quant)
    return net


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.dp:
        ap.error("--dp is not ported yet (ROADMAP M14)")
    try:
        warm_hw = tuple(parse_geometry(g) for g in args.warm_hw)
    except ValueError:
        ap.error(f"--warm-hw wants WxH integers, got {args.warm_hw}")

    if args.artifact is not None:
        if not args.artifact:
            ap.error("--artifact needs at least one artifact path")
        if warm_hw:
            ap.error("--warm-hw only applies to cfg/weights workers; "
                     "artifact workers have fixed input shapes (re-export "
                     "at the wanted geometry instead)")
        from .export import ArtifactNet
        net = ArtifactNet(args.artifact)
        service = DetectorService(net, max_batch=net.max_batch)
        server = make_server(service, args.host, args.port)
        threading.Thread(target=service.warmup, daemon=True).start()
        print(f"serving {len(args.artifact)} artifact(s) on "
              f"http://{args.host}:{server.server_address[1]}", flush=True)
        server.serve_forever()
        return 0

    net = load_net(args, ap.error)
    service = DetectorService(net, warm_hw=warm_hw)
    server = make_server(service, args.host, args.port)
    threading.Thread(target=service.warmup, daemon=True).start()
    print(f"serving on http://{args.host}:{server.server_address[1]}",
          flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
