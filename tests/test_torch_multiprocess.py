"""Data parallelism across processes and the entry points over a mesh, the
port's counterpart of tests/test_multiprocess.py, on the CPU.

Two processes of two CPU slots each join a gloo group over a loopback
address (``parallel/multiprocess.py``): each runs the sharded pipeline on
its own images (``global_batch``), finds its rows at ``rank * local_n``
(``local_results``) and holds them against a parity ``Net`` of its own.
The worker is this file, run as a script:

    python tests/test_torch_multiprocess.py PORT RANK NPROC

Then ``cli bench --dp/--sp --device cpu`` and a ``serve --dp`` round trip,
each against ``Net.detect``."""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = os.path.join(REPO, "models", "ffcnn-micro.cfg")
LOCAL_N = 2
TOPK = 2048                  # micro's every candidate at 64x64: no K growth


def _micro_params():
    from ffcnn_tpu_torch import parse_cfg, synth_weights_bytes
    from ffcnn_tpu_torch.darknet.weights import load_weights
    ir = parse_cfg(MICRO, 64, 64)
    return ir, load_weights(ir, synth_weights_bytes(ir, seed=7,
                                                    obj_bias=2.0))[0]


def _same(dets, boxes, scores, classes, count):
    """One image's Detection list against a result's row."""
    assert int(count) == len(dets), (int(count), len(dets))
    live = scores > 0
    got = sorted((int(c), tuple(int(v) for v in b), float(s))
                 for c, b, s in zip(classes[live], boxes[live],
                                    scores[live]))
    want = sorted((d.class_id, tuple(int(v) for v in d[2:]), d.score)
                  for d in dets)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert all(abs(g[2] - w[2]) <= 1e-5 for g, w in zip(got, want))


def _worker(port: int, rank: int, nproc: int) -> None:
    sys.path.insert(0, REPO)
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch.graph.build import params_from_numpy
    from ffcnn_tpu_torch.parallel import build_sharded_pipeline, make_mesh
    from ffcnn_tpu_torch.parallel.multiprocess import (
        ProcInfo, global_batch, init_distributed, local_results,
        shutdown_distributed)

    cpu = ["cpu", "cpu"]
    info = init_distributed(f"127.0.0.1:{port}", nproc, rank, devices=cpu)
    assert info == ProcInfo(rank, nproc, 2, 2 * nproc), info
    assert init_distributed() == info             # a second call: a no-op
    ir, params = _micro_params()
    mesh = make_mesh(cpu)                         # this process's slots
    fn, place = build_sharded_pipeline(ir, mesh, 64, 64, dtype=torch.float32,
                                       topk=TOPK)
    local = np.random.RandomState(100 + rank).randint(
        0, 256, (LOCAL_N, 64, 64, 3), dtype=np.uint8)
    batch = global_batch(mesh, local)
    assert (batch.start, batch.total) == (rank * LOCAL_N, nproc * LOCAL_N)
    start, mine = local_results(fn(place(params_from_numpy(params)), batch,
                                   (0.0,) * 3, (1 / 255.0,) * 3))
    assert start == rank * LOCAL_N, (start, rank)
    assert isinstance(mine.scores, np.ndarray)
    want = pt.Net(ir, params, mode="parity", topk=TOPK,
                  device="cpu").detect(local)
    assert sum(map(len, want)) > 0
    for i in range(LOCAL_N):
        _same(want[i], mine.boxes[i], mine.scores[i], mine.classes[i],
              mine.count[i])
    shutdown_distributed()
    print(f"MP-OK {rank}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_hold_their_rows():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank),
         "2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-4000:]}"
        assert f"MP-OK {rank}" in out, out[-2000:]


def _weights(tmp_path) -> str:
    from ffcnn_tpu_torch import parse_cfg, synth_weights_bytes
    w = str(tmp_path / "micro.weights")
    with open(w, "wb") as f:
        f.write(synth_weights_bytes(parse_cfg(MICRO), seed=7, obj_bias=2.0))
    return w


@pytest.mark.parametrize("argv,mode", [(["--dp"], "fast"),
                                       (["--sp", "2"], "parity"),
                                       (["--dp", "--sp", "2"], "parity")],
                         ids=["dp", "sp", "dp_sp"])
def test_cli_bench_over_a_mesh_equals_the_net(argv, mode, tmp_path,
                                              monkeypatch, capsys):
    """``cli bench --dp`` (two replicas of a fast Net: bit for bit with
    the Net on the whole batch, every kernel's CPU version computing each
    image alone) and ``--sp 2`` (the parity forward over two row blocks:
    the detections of the parity Net's bucket at the same K) on two
    CPU slots (``slot_devices`` gives two, as two cards would), their
    results caught on the way out."""
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch import cli, parallel
    from ffcnn_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "slot_devices",
                        lambda device: [torch.device(device)] * 2)

    w = _weights(tmp_path)
    seen = []
    if argv == ["--dp"]:
        real = parallel.build_dp_pipeline

        def spy(*a, **k):
            fn = real(*a, **k)
            return lambda b: seen.append(fn(b)) or seen[-1]
        monkeypatch.setattr(parallel, "build_dp_pipeline", spy)
    else:
        real = parallel.build_sharded_pipeline

        def spy(*a, **k):
            fn, place = real(*a, **k)
            return (lambda *b: seen.append(fn(*b)) or seen[-1]), place
        monkeypatch.setattr(parallel, "build_sharded_pipeline", spy)
    assert cli.main(["bench"] + argv + [
        "--device", "cpu", "--cfg", MICRO, "--weights", w, "--size", "64",
        "--batch", "4", "--iters", "1", "--mode",
        mode]) == 0
    assert capsys.readouterr().out.startswith("batch 4 @64x64 ")
    assert len(seen) == 2                         # the warm call and one
    batch = np.random.RandomState(0).randint(0, 255, (4, 64, 64, 3),
                                             np.uint8)
    net = pt.Net.load(MICRO, w, 64, 64, mode=mode, device="cpu")
    want = net.detect_device(batch)
    assert int(want.count.sum()) > 0
    if mode == "fast":
        assert all(torch.equal(g, x) for g, x in zip(seen[-1], want))
        return
    # the sharded pipeline keeps JAX's K of 128, as the Net's bucket does
    # before Net.detect grows it: the bucket's detections
    got = [t.numpy() for t in seen[-1]]
    assert np.array_equal(got[4], want.saturated.numpy())
    for i, dets in enumerate(net._to_detections(want)):
        _same(dets, got[0][i], got[1][i], got[2][i], got[3][i])


def test_serve_dp_round_trip(tmp_path, monkeypatch):
    """``serve --dp``: ``load_net`` wraps the parity Net in a ``DPNet``
    over the mesh's devices (two CPU slots here, as two cards would give);
    three concurrent POSTs (micro-batched, padded over the two replicas)
    answer as ``Net.detect``."""
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch import serve
    from ffcnn_tpu_torch.imageio.bmp import bmp_save
    from ffcnn_tpu_torch.parallel import DPNet, mesh

    monkeypatch.setattr(mesh, "slot_devices",
                        lambda device: [torch.device(device)] * 2)
    w = _weights(tmp_path)
    args = serve.parser().parse_args(
        ["--cfg", MICRO, "--weights", w, "--device", "cpu", "--mode",
         "parity", "--dp"])

    def error(msg):
        raise AssertionError(msg)
    net = serve.load_net(args, error)
    assert isinstance(net, DPNet)
    assert net.mesh.shape == {"data": 2, "spatial": 1, "model": 1}
    service = serve.DetectorService(net, max_batch=4)
    service.warmup()
    assert service.ready
    srv = serve.make_server(service, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(3)]

    def post(i):
        path = str(tmp_path / f"r{i}.bmp")
        bmp_save(path, imgs[i])
        with open(path, "rb") as f:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/detect",
                data=f.read(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["detections"]
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            answers = list(ex.map(post, range(3)))
    finally:
        srv.shutdown()
        service._batcher.close()
    ref = pt.Net.load(MICRO, w, mode="parity", device="cpu")
    for img, got in zip(imgs, answers):
        assert got == [{"score": round(d.score, 4), "class_id": d.class_id,
                        "box": [round(v, 2) for v in d[2:]]}
                       for d in ref.detect(img)]
    assert sum(map(len, answers)) > 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
