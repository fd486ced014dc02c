"""The port's inference service (ffcnn_tpu_torch/serve.py) on the CPU: every
case of tests/test_serve.py against the port's Net and batcher, the
refusals of what is not ported, and one differential: the port's server
and JAX's, both in parity mode on the same weights, answer the same BMP
with the same detections."""

import concurrent.futures
import http.client
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import ffcnn_tpu as jt
import ffcnn_tpu_torch as pt
from ffcnn_tpu import serve as jserve
from ffcnn_tpu.darknet import parse_cfg
from ffcnn_tpu.darknet.weights import load_weights, synth_weights_bytes
from ffcnn_tpu.imageio.bmp import bmp_save
from ffcnn_tpu_torch import serve
from ffcnn_tpu_torch.serve import (DetectorService, MicroBatcher, Overloaded,
                                   make_server, parse_geometry)
from ffcnn_tpu_torch.testing import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")


def _net(seed=7, obj_bias=2.0, **kw):
    tir = pt.parse_cfg(MICRO)
    params, _ = load_weights(parse_cfg(MICRO),
                             synth_weights_bytes(parse_cfg(MICRO), seed=seed,
                                                 obj_bias=obj_bias))
    return pt.Net(tir, params, mode="parity", device="cpu", **kw), params


def _start(service):
    srv = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def server():
    net, _ = _net()
    service = DetectorService(net)
    srv = _start(service)
    try:
        yield srv, service
    finally:
        srv.shutdown()
        service._batcher.close()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.server_address[1]}{path}"


def _bmp(tmp_path, img, name="in.bmp"):
    p = str(tmp_path / name)
    bmp_save(p, img)
    with open(p, "rb") as f:
        return f.read()


def _post(srv, raw):
    req = urllib.request.Request(_url(srv, "/detect"), data=raw,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["detections"]


def test_healthz_gates_on_warmup(server):
    srv, service = server
    if not service.ready:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(_url(srv, "/healthz"))
        assert ei.value.code == 503
    service.warmup()
    r = urllib.request.urlopen(_url(srv, "/healthz"))
    assert r.status == 200 and r.read() == b"ok"


def test_dump_endpoint(server):
    srv, service = server
    r = urllib.request.urlopen(_url(srv, "/dump"))
    assert b"yolo" in r.read()


def test_detect_endpoint(server, tmp_path):
    srv, service = server
    service.warmup()
    img = np.random.RandomState(0).randint(0, 256, (64, 64, 3),
                                           dtype=np.uint8)
    dets = _post(srv, _bmp(tmp_path, img))
    want = service.net.detect(img)
    assert len(dets) == len(want) > 0
    for d, w in zip(dets, want):
        assert d["class_id"] == w.class_id
        assert abs(d["score"] - w.score) < 1e-3


def test_detect_rejects_garbage(server):
    srv, service = server
    req = urllib.request.Request(_url(srv, "/detect"), data=b"nonsense",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400


def test_pipeline_nans_clean():
    """The port's counterpart of test_serve's jax_debug_nans case: every
    blob of the parity pipeline, and its result, is finite for in-range
    pixels."""
    net, _ = _net()
    img = np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3),
                                           dtype=np.uint8)
    from ffcnn_tpu_torch.graph.build import forward_features
    from ffcnn_tpu_torch.ops.preprocess import letterbox
    bad = []
    forward_features(net.ir, net.params,
                     letterbox(torch.from_numpy(img), 64, 64),
                     blob_hook=lambda i, v: bad.append(i) if not bool(
                         torch.isfinite(v).all()) else None)
    assert not bad
    res = net.detect_device(img)
    assert all(bool(torch.isfinite(t.float()).all()) for t in res)


def test_microbatch_concurrent_requests_correct(server):
    """Concurrent requests coalesce into one padded dispatch and each caller
    gets ITS image's detections (and mixed sizes are still served)."""
    srv, service = server
    service.warmup()
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(6)]
    imgs.append(rng.randint(0, 256, (96, 64, 3), dtype=np.uint8))
    want = [service.net.detect(im) for im in imgs]
    with concurrent.futures.ThreadPoolExecutor(7) as ex:
        got = list(ex.map(service._batcher.detect, imgs))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.class_id == b.class_id
            assert abs(a.score - b.score) < 1e-6
            assert abs(a.x1 - b.x1) < 1e-4


def test_microbatch_bucket_powers_of_two():
    assert [MicroBatcher._bucket(n) for n in (1, 2, 3, 5, 8, 9)] == \
        [1, 2, 4, 8, 8, 16]


class _FakeNet:
    """net.detect stand-in: returns each image's shape tag; an optional
    per-call hook injects slowness or failures."""

    def __init__(self, hook=None):
        self.hook = hook
        self.batches = []

    def detect(self, batch):
        if self.hook:
            self.hook(batch)
        self.batches.append(batch.shape)
        return [("det", batch.shape[1:], i) for i in range(batch.shape[0])]


def test_microbatch_mixed_size_fairness():
    """A steady stream of size-A requests must not starve a size-B
    request: size groups rotate."""
    release = threading.Event()
    served_b_at = []
    net = _FakeNet(hook=lambda batch: time.sleep(0.01))
    mb = MicroBatcher(net, max_batch=4, wait_timeout=30.0)
    a = np.zeros((8, 8, 3), np.uint8)
    b = np.zeros((16, 8, 3), np.uint8)
    stop = time.monotonic() + 3.0

    def flood_a():
        while time.monotonic() < stop and not release.is_set():
            try:
                mb.detect(a)
            except Exception:
                return

    def one_b():
        mb.detect(b)
        served_b_at.append(time.monotonic())
        release.set()

    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        floods = [ex.submit(flood_a) for _ in range(4)]
        time.sleep(0.05)
        fb = ex.submit(one_b)
        fb.result(timeout=10)
        release.set()
        for f in floods:
            f.result(timeout=10)
    mb.close()
    assert served_b_at and served_b_at[0] < stop


def test_microbatch_backpressure_overload():
    gate = threading.Event()
    net = _FakeNet(hook=lambda b: gate.wait(10))
    mb = MicroBatcher(net, max_batch=1, max_pending=2, wait_timeout=30.0)
    img = np.zeros((8, 8, 3), np.uint8)
    errs = []

    def swallow():
        try:
            mb.detect(img)
        except Overloaded as e:
            errs.append(e)

    threads = [threading.Thread(target=swallow) for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    mb.close()
    assert errs, "expected Overloaded once max_pending was exceeded"


def test_microbatch_survives_detect_failure():
    """A per-round failure fans out to that round's callers and the
    dispatcher keeps serving."""
    calls = {"n": 0}

    def flaky(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise MemoryError("boom")

    mb = MicroBatcher(_FakeNet(hook=flaky), max_batch=1, wait_timeout=10.0)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(MemoryError):
        mb.detect(img)
    assert mb.detect(img)[0] == "det"
    assert mb.alive
    mb.close()


class _FakeAsyncNet:
    """detect_async stand-in: tags each image with its round, and can fail
    at completion time."""

    def __init__(self, fail_round=None):
        self.rounds = 0
        self.fail_round = fail_round

    def detect_async(self, batch):
        self.rounds += 1
        rnd = self.rounds
        shape = batch.shape

        def finish():
            if rnd == self.fail_round:
                raise RuntimeError(f"round {rnd} failed at completion")
            return [("det", rnd, shape[1:], i) for i in range(shape[0])]
        return finish

    def detect(self, batch):
        return self.detect_async(batch)()


def test_microbatch_overlapped_rounds_do_not_mix():
    """Each caller gets its own round's results even when round i+1 starts
    before round i completes."""
    net = _FakeAsyncNet()
    mb = MicroBatcher(net, max_batch=2, wait_timeout=10.0)
    img = np.zeros((8, 8, 3), np.uint8)
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(mb.detect, img) for _ in range(8)]
        results = [f.result(timeout=10) for f in futs]
    mb.close()
    assert all(r[0] == "det" and r[2] == (8, 8, 3) for r in results)
    pairs = [(r[1], r[3]) for r in results]
    assert len(set(pairs)) == len(pairs)
    by_round = {}
    for rnd, slot in pairs:
        by_round.setdefault(rnd, []).append(slot)
    for rnd, slots in by_round.items():
        assert sorted(slots) == list(range(len(slots))), (rnd, slots)


def test_microbatch_overlapped_rounds_on_the_port_net():
    """The port's own detect_async under overlapped rounds: every caller
    gets its image's detections, as from a serial detect."""
    net, _ = _net(seed=11)
    mb = MicroBatcher(net, max_batch=2, wait_timeout=60.0)
    rng = np.random.RandomState(8)
    imgs = [rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(6)]
    want = [net.detect(im) for im in imgs]
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        got = list(ex.map(mb.detect, imgs))
    mb.close()
    assert got == want


def test_microbatch_async_completion_failure_fans_out():
    net = _FakeAsyncNet(fail_round=1)
    mb = MicroBatcher(net, max_batch=1, wait_timeout=10.0)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="failed at completion"):
        mb.detect(img)
    assert mb.detect(img)[0] == "det"
    assert mb.alive
    assert mb.metrics["dispatch_errors"] == 1
    mb.close()


def test_service_health_reflects_dead_dispatcher():
    net = _FakeNet()
    svc = DetectorService.__new__(DetectorService)
    svc.net = net
    svc._ready = True
    svc._error = None
    svc._batcher = MicroBatcher(net, max_batch=1)
    assert svc.ready
    svc._batcher.close()
    time.sleep(0.1)
    assert not svc.ready
    assert "not running" in svc.error
    with pytest.raises(RuntimeError):
        svc._batcher.detect(np.zeros((8, 8, 3), np.uint8))


def test_loadtest_tool(server, tmp_path):
    """tools/loadtest.py drives closed-loop traffic against the port's
    worker and reports coalescing and latency."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import loadtest
    srv, service = server
    service.warmup()
    body = _bmp(tmp_path, np.random.RandomState(5).randint(
        0, 256, (64, 64, 3), dtype=np.uint8))
    stats = loadtest.run_load(_url(srv, ""), body, clients=4, secs=2.0)
    assert stats["errors"] == 0 and stats["requests"] > 0
    assert stats["p50_ms"] is not None and stats["rps"] > 0


def test_detect_rejects_oversized_body(server):
    srv, service = server
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1])
    try:
        conn.putrequest("POST", "/detect")
        conn.putheader("Content-Length", str(service.MAX_BODY_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()           # rejected before the body
        assert resp.status == 413
    finally:
        conn.close()


@pytest.mark.parametrize("args,item", [
    (["--dp"], "M14"), (["--artifact", "m.ffx"], "M15"),
    (["--mode", "int8"], "--calib")])
def test_main_refuses_what_is_not_ported(args, item, capsys, tmp_path,
                                         monkeypatch):
    """The port's main refuses --mode int8 without a plan to serve (--calib
    frames or a saved --quant-plan), as the JAX server does, before it
    loads anything.  --dp (ROADMAP M14, refused before) is ported: main
    serves the Net behind a ``DPNet`` over two CPU slots (the mesh's
    devices, one CPU slot with ``--device cpu``, made two here), goes
    healthy once both replicas' buckets are warm, and answers POST /detect
    as ``Net.detect`` does.  --artifact (M15) is ported: main
    serves an exported artifact with no cfg or weights, goes healthy once
    its golden probe replays, and answers POST /detect as the Net's bucket
    does."""
    if args[0] in ("--artifact", "--dp"):
        net, params = _net()
        if args[0] == "--artifact":
            art = str(tmp_path / args[1])
            net.export(art, batch_size=1)
            argv = ["--artifact", art, "--port", "0"]
        else:
            wpath = str(tmp_path / "micro.weights")
            with open(wpath, "wb") as f:
                f.write(synth_weights_bytes(parse_cfg(MICRO), seed=7,
                                            obj_bias=2.0))
            argv = ["--cfg", MICRO, "--weights", wpath, "--device", "cpu",
                    "--mode", "parity", "--dp", "--port", "0"]
            from ffcnn_tpu_torch.parallel import mesh
            monkeypatch.setattr(mesh, "slot_devices",
                                lambda device: [torch.device(device)] * 2)
        servers = []

        def make(*a, **k):
            servers.append(make_server(*a, **k))
            return servers[-1]
        monkeypatch.setattr(serve, "make_server", make)
        th = threading.Thread(target=serve.main, args=(argv,), daemon=True)
        th.start()
        try:
            deadline = time.time() + 120
            while time.time() < deadline:
                if servers:
                    try:
                        with urllib.request.urlopen(
                                _url(servers[0], "/healthz"), timeout=5) as r:
                            if r.status == 200:
                                break
                    except urllib.error.HTTPError:
                        pass
                time.sleep(0.2)
            else:
                raise AssertionError(f"the {args[0]} server never went "
                                     f"healthy")
            img = np.random.RandomState(2).randint(0, 256, (64, 64, 3),
                                                   dtype=np.uint8)
            bmp = str(tmp_path / "req.bmp")
            bmp_save(bmp, img)
            with open(bmp, "rb") as f:
                req = urllib.request.Request(_url(servers[0], "/detect"),
                                             data=f.read(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got = json.loads(r.read())["detections"]
            # the artifact's top-k is sealed (no parity K-growth retry):
            # the bucket's own result at the Net's K; DPNet grows K as
            # Net.detect does
            want = (net._to_detections(net.detect_device(img[None]))[0]
                    if args[0] == "--artifact" else net.detect(img))
            assert got == [{"score": round(d.score, 4),
                            "class_id": d.class_id,
                            "box": [round(v, 2) for v in d[2:]]}
                           for d in want]
        finally:
            if servers:
                servers[0].shutdown()
            th.join(timeout=30)
        return
    with pytest.raises(SystemExit) as ei:
        serve.main(["--cfg", MICRO, "--weights", "absent.weights",
                    "--device", "cpu"] + args)
    assert ei.value.code == 2
    assert item in capsys.readouterr().err


def test_main_serves_on_the_cpu(tmp_path, monkeypatch):
    """main with --device cpu loads the model (through --cache-dir), warms
    it and serves until the server is shut down."""
    wpath = str(tmp_path / "micro.weights")
    with open(wpath, "wb") as f:
        f.write(pt.synth_weights_bytes(pt.parse_cfg(MICRO), seed=7,
                                       obj_bias=2.0))
    made = []
    real = serve.make_server

    def capture(service, host, port):
        srv = real(service, host, 0)
        made.append((srv, service))
        return srv

    monkeypatch.setattr(serve, "make_server", capture)
    t = threading.Thread(target=serve.main, args=([
        "--cfg", MICRO, "--weights", wpath, "--mode", "parity",
        "--device", "cpu", "--cache-dir", str(tmp_path / "cache")],),
        daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while not made and time.monotonic() < deadline:
        time.sleep(0.05)
    srv, service = made[0]
    try:
        while not service.ready and time.monotonic() < deadline:
            time.sleep(0.05)
        assert service.ready
        assert service.net.device.type == "cpu"
        r = urllib.request.urlopen(_url(srv, "/healthz"))
        assert r.read() == b"ok"
    finally:
        srv.shutdown()
        service._batcher.close()
    t.join(timeout=30)
    assert not t.is_alive()
    assert os.listdir(str(tmp_path / "cache"))


def test_statz_endpoint(server, tmp_path):
    srv, service = server
    service.warmup()
    img = np.random.RandomState(1).randint(0, 256, (64, 64, 3),
                                           dtype=np.uint8)
    _post(srv, _bmp(tmp_path, img, "s.bmp"))
    stats = json.loads(urllib.request.urlopen(_url(srv, "/statz")).read())
    assert stats["requests"] >= 1
    assert stats["images"] >= 1
    assert stats["dispatches"] >= 1
    assert stats["ready"] is True
    assert stats["pending"] == 0
    assert stats["dispatch_p50_ms"] is None or stats["dispatch_p50_ms"] > 0
    assert sum(stats["batch_hist"].values()) == stats["dispatches"]
    assert all(int(k) & (int(k) - 1) == 0 for k in stats["batch_hist"])


def test_warm_hw_prewarms_request_geometry():
    """A geometry passed at construction is built during warmup, so the
    first request at that size finds its bucket."""
    assert parse_geometry("640x480") == (480, 640)
    with pytest.raises(ValueError):
        parse_geometry("0x32")
    net, _ = _net(obj_bias=0.0)
    service = DetectorService(net, warm_hw=(parse_geometry("64x48"),),
                              warm_batches=(1,))
    service.warmup()
    n_buckets = len(net._pipelines)
    dets = net.detect(np.zeros((48, 64, 3), np.uint8))
    assert isinstance(dets, list)
    assert len(net._pipelines) == n_buckets
    net.detect(np.zeros((32, 32, 3), np.uint8))
    assert len(net._pipelines) == n_buckets + 1
    service._batcher.close()


def test_port_server_answers_as_jax_server(tmp_path):
    """Both servers in parity mode on the same weights: the same BMP gets
    the same detections (class, box to 1e-4, score to 1e-6)."""
    net, params = _net(seed=9)
    jnet = jt.Net(parse_cfg(MICRO), params, mode="parity")
    services = [DetectorService(net, warm_batches=(1,)),
                jserve.DetectorService(jnet, warm_batches=(1,))]
    servers = [_start(services[0]), jserve.make_server(services[1],
                                                       "127.0.0.1", 0)]
    threading.Thread(target=servers[1].serve_forever, daemon=True).start()
    img = np.random.RandomState(6).randint(0, 256, (80, 64, 3),
                                           dtype=np.uint8)
    raw = _bmp(tmp_path, img)
    try:
        for s in services:
            s.warmup()
        got, want = (_post(srv, raw) for srv in servers)
    finally:
        for srv, s in zip(servers, services):
            srv.shutdown()
            s._batcher.close()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["class_id"] == w["class_id"]
        assert abs(g["score"] - w["score"]) <= 1e-6
        assert max(abs(a - b) for a, b in zip(g["box"], w["box"])) <= 1e-4
