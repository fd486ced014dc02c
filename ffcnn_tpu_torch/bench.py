"""The port's benchmark: pixels-to-boxes images a second on the card, the
protocol of the root ``bench.py`` (the JAX package's) on PyTorch.

    python -m ffcnn_tpu_torch.bench [--cfg CFG] [--weights W] \\
        [--batches 256,384,512] [--windows 5] [--iters 30] [--device cpu]

Model: ``models/yolo-fastest-xl.cfg`` at its own 320x320, weights from
``synth_weights_bytes(seed=42, obj_bias=2.0)`` unless ``--weights`` is
given.  Frames: ``tests/fixtures/test320.bmp`` with per-image noise
(``noisy_batches``, the root bench's recipe).  The fusion flags
(``FFCNN_FUSED_*``, ``FFCNN_CONV0_PALLAS``) are read from the environment
when the Nets are built, and the JSON line names those set.

Gates first, each raising on failure:
  1. parity on the device equals parity on the CPU on four frames (class,
     integer box, score to 1e-4, paired as sets); with ``--parity-gate
     candidates`` (a model whose synthetic weights tie scores, such as a
     synthesized YOLOv8n) the pre-NMS candidates instead, and the
     device's tail on the CPU's candidates bit for bit
     (``parity_candidates``);
  2. fast mode on the device against fast mode on the CPU: 90% of each
     side's detections among the other side's candidates (same class,
     within 4 px and 0.02 in score);
  3. int8 mode on the device against int8 mode on the CPU under one plan
     (calibrated on the device from the gate frames, installed on both
     with ``set_quant_plan``), by gate 2's tolerances;
  4. the golden boxes of the reference model, only where its files
     (``cli.REFERENCE``) exist.

Then the rows, each a device-resident batch through ``detect_device`` (a
bucket's CUDA graph replay on the card), a window being ``--iters`` calls
and one synchronise:
  * fast: each of ``--batches`` best of 3 windows, then the median of
    ``--windows`` windows at the winner (``value``);
  * parity at the first of ``--batches``, the median of 3 windows;
  * int8 (``int8_img_s``, informational, as the root bench's row: the JAX
    package demoted int8 on its accuracy) at the batch that won the fast
    sweep, the median of 3 windows;
  * ``detect_stream`` of host batches (the first of ``--batches`` x 6,
    depth 2), best of 2 passes, and the card's busy share in one traced
    pass;
  * 640x448 (the reference demo's geometry) at batch 128 (at most the
    first of ``--batches``), best of 3 windows;
  * batch 1: p50 wall time over 50 synchronised calls, and the device time
    of 20 calls (``profiling.device_op_time_ms``).
No failure is swallowed: any exits non-zero.  The last line of standard
output is one JSON object; progress goes to standard error.  ``--device
cpu`` runs the same protocol on the CPU (host clock; no device metric is
reported: ``mfu``, ``batch1_device_ms`` and ``stream_occupancy`` are null).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import profiling, roofline
from .cli import DEFAULT_CFG, DEFAULT_WEIGHTS, REFERENCE
from .darknet.cfg import parse_cfg
from .darknet.weights import synth_weights_bytes
from .imageio.bmp import bmp_load
from .net import Net
from .ops.preprocess import letterbox_params
from .ops.yolo import decode_heads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
BMP = os.path.join(FIXTURES, "test320.bmp")
SEED = 42
BATCHES = (256, 384, 512)
ITERS = 30
WINDOWS = 5
PICK_WINDOWS = 3             # windows a batch in the sweep, the best counts
STREAM_BATCHES = 6
DEMO_BATCH = 128
BATCH1_CALLS, BATCH1_TRACED = 50, 20
# gate tolerances: chip_smoke.py phase 4 (fast) and phase 5 (parity)
PARITY_SCORE_TOL, PARITY_BOX_NOISE = 1e-4, 1e-3
DET_MATCH_FRAC, DET_MATCH_PX, DET_MATCH_SCORE = 0.9, 4.0, 0.02
GATE_FRAMES = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def noisy_batches(img, batch, n_batches, seed=0):
    """The benchmark's frames, the root bench's recipe: real image content
    (random-noise frames decode to hundreds of spurious boxes, which is not
    a detection workload) plus per-image noise so frames are distinct.
    Each batch is C-contiguous, as a decoder's frames are (numpy may lay
    the broadcast sum out in another order)."""
    rng = np.random.RandomState(seed)
    base = np.broadcast_to(img, (batch,) + img.shape)
    out = []
    for _ in range(n_batches):
        noise = rng.randint(0, 8, base.shape, dtype=np.uint8)
        out.append(np.clip(base.astype(np.int16) + noise, 0, 255)
                   .astype(np.uint8, order="C"))
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gate_frames(img) -> np.ndarray:
    """The fixture and GATE_FRAMES - 1 noisy copies."""
    return np.concatenate([img[None], noisy_batches(
        img, GATE_FRAMES - 1, 1, seed=SEED)[0]])


def parity_gate(cfg, wbytes, device, frames) -> int:
    """Parity on ``device`` against parity on the CPU: the same detections
    per image (class; score to 1e-4; an integer box may differ only where
    float32 noise of 1e-3 px moved a coordinate across an integer), paired
    as sets (synthetic weights give equal-score ties, which come out in
    either order).  Returns the detections compared."""
    got = Net.load(cfg, wbytes, mode="parity", device=device).detect(frames)
    want = Net.load(cfg, wbytes, mode="parity", device="cpu").detect(frames)
    n = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if len(a) != len(b):
            raise AssertionError(f"parity gate: image {i} has {len(a)} "
                                 f"detections, {len(b)} on the CPU")
        free = list(b)
        for g in a:
            c = next((c for c in free if c.class_id == g.class_id
                      and abs(c.score - g.score) <= PARITY_SCORE_TOL
                      and all(int(u) == int(v)
                              or abs(u - v) <= PARITY_BOX_NOISE
                              for u, v in zip(g[2:], c[2:]))), None)
            if c is None:
                raise AssertionError(f"parity gate: image {i} detection {g}"
                                     f" is not among the CPU's")
            free.remove(c)
            n += 1
    return n


def parity_candidates(net: Net, cpu_net: Net, frames,
                      out: Optional[dict] = None) -> int:
    """Parity on ``net``'s device against the CPU for a model whose
    synthetic weights tie scores (tests/test_model_zoo.py's TIE_PRONE: the
    random input's influence washes out over the depth, and greedy NMS
    then keeps one of two tied candidates by float32 noise), on ``frames``:

      1. every pre-NMS candidate of the parity forward equals the CPU's:
         class, score to PARITY_SCORE_TOL, box to 1e-4 of the boxes'
         range (float32 through the whole net in another sum order);
      2. the device's pipeline tail (``Net.postprocess`` at the model's
         candidate count: top-k, the keep mask) on the CPU's candidates
         gives the CPU's result bit for bit.

    Returns the live candidates compared.  ``out``, where given, receives
    the CPU's candidates (``"cpu"``, ``DecodedBoxes``) and its tail on them
    (``"tail"``, the ``NMSResult`` its detections come from)."""
    nw, nh = net.ir.blobs[0].w, net.ir.blobs[0].h
    _, _, s1, s2 = letterbox_params(frames.shape[2], frames.shape[1], nw, nh)
    cands = [decode_heads(n.ir, [f.cpu() for f in n.forward_heads(
        torch.from_numpy(frames).to(n.device))], nw, nh)
        for n in (net, cpu_net)]
    (gb, gs, gc), (wb, ws, wc) = cands
    live = (gs > 0) | (ws > 0)
    box_tol = 1e-4 * float(wb.abs().max())
    bad = [f"{name} {err:.3e} > {tol:.3e}" for name, err, tol in (
        ("score", float((gs - ws).abs().max()), PARITY_SCORE_TOL),
        ("box", float((gb - wb).abs().max()), box_tol)) if err > tol]
    if not torch.equal(gc[live], wc[live]):
        bad.append(f"{int((gc != wc)[live].sum())} classes")
    if bad:
        raise AssertionError("parity gate: candidates differ from the "
                             "CPU's: " + ", ".join(bad))
    k = cpu_net._max_candidates()
    got = net.postprocess(cands[1]._replace(**{
        f: t.to(net.device) for f, t in cands[1]._asdict().items()}),
        k, s1, s2)
    want = cpu_net.postprocess(cands[1], k, s1, s2)
    for f, a, b in zip(want._fields, got, want):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"parity gate: the device's tail on the "
                                 f"CPU's candidates differs in {f}")
    if out is not None:
        out.update(cpu=cands[1], tail=want)
    return int(live.sum())


def _match_fraction(dets, boxes, scores, classes) -> float:
    """Share of ``dets`` among the candidates: same class, every coordinate
    within DET_MATCH_PX, score within DET_MATCH_SCORE."""
    live = scores > 0
    boxes, scores, classes = boxes[live], scores[live], classes[live]
    if not dets:
        return 1.0
    hits = sum(bool(np.any(
        (classes == d.class_id)
        & (np.abs(boxes - np.asarray(d[2:])).max(1) <= DET_MATCH_PX)
        & (np.abs(scores - d.score) <= DET_MATCH_SCORE))) for d in dets)
    return hits / len(dets)


def fast_gate(net: Net, cpu_net: Net, frames) -> float:
    """Fast mode on the net's device against fast mode on the CPU: each
    side's detections among the other side's candidates (the decoded boxes
    before NMS, in the frames' pixels).  Returns the smaller share."""
    nw, nh = net.ir.blobs[0].w, net.ir.blobs[0].h
    _, _, s1, s2 = letterbox_params(frames.shape[2], frames.shape[1], nw, nh)
    dets, cands = [], []
    for n in (net, cpu_net):
        dets.append(n.detect(frames))
        feats = n.forward_heads(torch.from_numpy(frames).to(n.device))
        c = decode_heads(n.ir, [f.float().cpu() for f in feats], nw, nh)
        cands.append((c.boxes * float(np.float32(s1) / np.float32(s2)),
                      c.scores, c.classes))
    worst = 1.0
    for i in range(len(frames)):
        for d, c in ((dets[0], cands[1]), (dets[1], cands[0])):
            fr = _match_fraction(d[i], *(t[i].numpy() for t in c))
            worst = min(worst, fr)
            if fr < DET_MATCH_FRAC:
                raise AssertionError(f"fast gate: image {i}: {fr:.3f} of "
                                     f"the detections among the other "
                                     f"side's candidates")
    return worst


def int8_gate(cfg, wbytes, device, frames) -> Net:
    """int8 mode on ``device`` against int8 mode on the CPU under one plan:
    calibrated on ``device`` from ``frames`` (at most 8), installed on a
    CPU Net with ``set_quant_plan``, then held as ``fast_gate`` holds fast
    mode.  Returns the device's int8 Net."""
    net = Net.load(cfg, wbytes, mode="int8", device=device)
    net.calibrate(frames[:8])
    cpu_net = Net.load(cfg, wbytes, mode="int8", device="cpu")
    cpu_net.set_quant_plan(net.quant)
    worst = fast_gate(net, cpu_net, frames)
    log(f"int8 gate: {len(net.quant.blob_scale)} int8 blobs, "
        f"{len(net.quant.weights)} int8 convs; at least {worst:.3f} of each "
        f"side's detections among the other's candidates")
    return net


def _check_golden(dets, golden_file) -> int:
    golden = []
    with open(golden_file) as f:
        for line in f:
            score = float(line.split("score:")[1].split(",")[0])
            cat = int(line.split("category:")[1].split(",")[0])
            rect = [int(v) for v in line.split("(")[1].split(")")[0].split()]
            golden.append((cat, score, rect))
    if len(dets) != len(golden):
        raise AssertionError(f"golden gate: {len(dets)} detections, "
                             f"{len(golden)} golden")
    for d, (cat, score, rect) in zip(dets, golden):
        if d.class_id != cat or abs(d.score - score) >= 5e-3 or \
                [int(d.x1), int(d.y1), int(d.x2), int(d.y2)] != rect:
            raise AssertionError(f"golden gate: {d} against {cat} {score} "
                                 f"{rect}")
    return len(golden)


def golden_gate(device) -> None:
    """The reference model's parity detections against the C reference's
    golden boxes at 320x320 and at the demo's 640x448 (ALIGN-32 input
    override, ffcnn.c:133-134,573)."""
    net = Net.load(DEFAULT_CFG, DEFAULT_WEIGHTS, mode="parity",
                   device=device)
    n = _check_golden(net.detect(bmp_load(BMP)),
                      os.path.join(FIXTURES, "golden_boxes_320x320.txt"))
    net = Net.load(DEFAULT_CFG, DEFAULT_WEIGHTS, 640, 448, mode="parity",
                   device=device)
    n += _check_golden(net.detect(bmp_load(os.path.join(REFERENCE,
                                                        "test.bmp"))),
                       os.path.join(FIXTURES, "golden_boxes_640x448.txt"))
    log(f"golden gate: {n} golden detections exact")


def timed_windows(net: Net, xb: torch.Tensor, n_windows: int,
                  iters: int) -> List[float]:
    """img/s of ``n_windows`` windows, each ``iters`` ``detect_device``
    calls on the device-resident batch ``xb`` and one synchronise."""
    out = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            net.detect_device(xb)
        _sync(net.device)
        out.append(xb.shape[0] / ((time.perf_counter() - t0) / iters))
    return out


def _upload(net: Net, batch: np.ndarray) -> torch.Tensor:
    """``batch`` on the net's device, its bucket built (on the card: its
    graph captured) outside any timing."""
    xb = torch.from_numpy(batch).to(net.device)
    net.detect_device(xb)
    _sync(net.device)
    return xb


def throughput(net: Net, img, batches: Sequence[int], pick: int,
               windows: int, iters: int, tag: str):
    """Best of ``pick`` windows at each batch picks the batch; then
    ``windows`` windows there.  Returns (median img/s, batch, windows)."""
    best = (0.0, 0, None)
    for bi, b in enumerate(batches):
        (batch,) = noisy_batches(img, b, 1, seed=bi)
        xb = _upload(net, batch)
        ips = max(timed_windows(net, xb, pick, iters))
        log(f"{tag} batch {b:4d}: {ips:10.1f} img/s (best of {pick})")
        if ips > best[0]:
            best = (ips, b, xb)
        del xb
    _, b, xb = best
    wins = sorted(timed_windows(net, xb, windows, iters))
    med = statistics.median(wins)
    log(f"{tag} batch {b:4d}: median {med:10.1f} img/s over {len(wins)} "
        f"windows (min {wins[0]:.1f}, max {wins[-1]:.1f})")
    return med, b, wins


def stream_row(net: Net, img, b: int):
    """``detect_stream`` over STREAM_BATCHES distinct host batches at
    depth 2 (each pays its upload and its results' decode, overlapped with
    the card's work): img/s, best of 2 passes; and the card's busy share
    in one more, traced pass (None on the CPU)."""
    batches = noisy_batches(img, b, STREAM_BATCHES)
    for _ in net.detect_stream(batches[:1]):      # the bucket, built
        pass
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in net.detect_stream(batches, depth=2):
            pass
        dt = min(dt, time.perf_counter() - t0)
    occ = None
    if net.device.type == "cuda":
        events, _ = profiling.trace(
            lambda: list(net.detect_stream(batches, depth=2)))
        occ = profiling.trace_occupancy(events)["occupancy"]
    return b * STREAM_BATCHES / dt, occ


def demo_row(cfg, wbytes, device, b: int, iters: int, windows: int):
    """img/s at the reference demo's geometry: a Net at 640x448 on seeded
    640x448 frames, best of ``windows`` windows."""
    net = Net.load(cfg, wbytes, 640, 448, mode="fast", device=device)
    frame = np.random.RandomState(SEED).randint(0, 256, (448, 640, 3),
                                                dtype=np.uint8)
    (batch,) = noisy_batches(frame, b, 1)
    xb = _upload(net, batch)
    return max(timed_windows(net, xb, windows, iters))


def batch1_row(net: Net, img):
    """(p50 wall ms of a synchronised batch-1 call, device ms a call by
    torch.profiler; None on the CPU)."""
    xb = _upload(net, img[None])
    times = []
    for _ in range(BATCH1_CALLS):
        t0 = time.perf_counter()
        net.detect_device(xb)
        _sync(net.device)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times) * 1e3
    dev_ms = (profiling.device_op_time_ms(lambda: net.detect_device(xb),
                                          BATCH1_TRACED)
              if net.device.type == "cuda" else None)
    return p50, dev_ms


def card(device) -> dict:
    """The device's name and power limit (``nvidia-smi``)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader", "-i",
                          str(device.index or 0)],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": res.stdout.strip()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m ffcnn_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' is asked for")
    ap.add_argument("--cfg", default=CFG)
    ap.add_argument("--weights", default=None,
                    help="default: synthesized from seed 42")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)),
                    help="the fast sweep's batch sizes; the first is also "
                         "parity's and the stream's")
    ap.add_argument("--windows", type=int, default=WINDOWS,
                    help="timed windows at the winning batch")
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="detect_device calls a window")
    ap.add_argument("--parity-gate", choices=("detections", "candidates"),
                    default="detections",
                    help="candidates: hold a model whose synthetic weights "
                         "tie scores on its pre-NMS candidates and its "
                         "tail (parity_candidates), not its detections")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    batches = [int(b) for b in args.batches.split(",")]
    pick = min(PICK_WINDOWS, args.windows)
    ir = parse_cfg(args.cfg)
    if args.weights is None:
        wbytes = synth_weights_bytes(ir, seed=SEED, obj_bias=2.0)
    else:
        with open(args.weights, "rb") as f:
            wbytes = f.read()
    img = bmp_load(BMP)
    flags = {k: v for k, v in sorted(os.environ.items())
             if k.startswith("FFCNN_")}
    log(f"bench on {device}: {os.path.basename(args.cfg)}, flags {flags}")

    frames = _gate_frames(img)
    if args.parity_gate == "candidates":
        n = parity_candidates(
            *(Net.load(args.cfg, wbytes, mode="parity", device=d)
              for d in (device, "cpu")), frames)
        log(f"parity gate: {n} candidates on {len(frames)} frames equal "
            f"the CPU's; the tail on the CPU's candidates bit for bit")
    else:
        n = parity_gate(args.cfg, wbytes, device, frames)
        log(f"parity gate: {n} detections on {len(frames)} frames equal "
            f"the CPU's")
    net = Net.load(args.cfg, wbytes, mode="fast", device=device)
    cpu_net = Net.load(args.cfg, wbytes, mode="fast", device="cpu")
    worst = fast_gate(net, cpu_net, frames)
    log(f"fast gate: at least {worst:.3f} of each side's detections among "
        f"the other's candidates")
    del cpu_net
    int8_net = int8_gate(args.cfg, wbytes, device, frames)
    if os.path.isdir(REFERENCE):
        golden_gate(device)
    else:
        log(f"golden gate: skipped, {REFERENCE} is absent")

    value, batch, wins = throughput(net, img, batches, pick, args.windows,
                                    args.iters, "fast")
    pnet = Net.load(args.cfg, wbytes, mode="parity", device=device)
    parity_ips, parity_batch, parity_wins = throughput(
        pnet, img, batches[:1], 1, min(PICK_WINDOWS, args.windows),
        args.iters, "parity")
    del pnet
    int8_ips, int8_batch, int8_wins = throughput(
        int8_net, img, [batch], 1, min(PICK_WINDOWS, args.windows),
        args.iters, "int8")
    del int8_net
    stream_ips, stream_occ = stream_row(net, img, batches[0])
    log(f"host-input stream (batch {batches[0]} x {STREAM_BATCHES}, depth "
        f"2): {stream_ips:.1f} img/s, card busy {stream_occ}")
    demo_b = min(DEMO_BATCH, batches[0])
    demo_ips = demo_row(args.cfg, wbytes, device, demo_b, args.iters, pick)
    log(f"640x448 batch {demo_b}: {demo_ips:.1f} img/s")
    p50, dev_ms = batch1_row(net, img)
    log(f"batch 1: p50 wall {p50:.3f} ms, device {dev_ms} ms")

    b0 = ir.blobs[0]
    gflop = roofline.model_flops(ir) / 1e9
    row = {
        "metric": f"{os.path.splitext(os.path.basename(args.cfg))[0]} "
                  f"{b0.w}x{b0.h} pixels-to-boxes throughput",
        "value": value,
        "unit": "img/s",
        "batch": batch,
        "mode": "fast",
        "protocol": f"median of {len(wins)} timed windows ({args.iters} "
                    f"detect_device calls + 1 synchronise each) at the "
                    f"sweep-winning batch",
        "fast_windows_img_s": wins,
        "fast_window_spread_pct": (wins[-1] - wins[0]) / value * 100,
        "parity_img_s": parity_ips,
        "parity_batch": parity_batch,
        "parity_windows_img_s": parity_wins,
        "int8_img_s": int8_ips,
        "int8_batch": int8_batch,
        "int8_windows_img_s": int8_wins,
        "int8_note": "informational: the JAX package demoted int8 mode on "
                     "its accuracy (wide-corpus mAP@0.5 0.73-0.78 against "
                     "fast mode's 0.96, measured on the TPU)",
        "stream_host_input_img_s": stream_ips,
        "stream_occupancy": stream_occ,
        "demo_640x448_img_s": demo_ips,
        "demo_640x448_batch": demo_b,
        "p50_batch1_ms": p50,
        "batch1_device_ms": dev_ms,
        "gflop_per_image": gflop,
        "mfu": (gflop * 1e9 * value / roofline.TC_BF16_FLOP_S
                if device.type == "cuda" else None),
        "device": card(device),
        "flags": flags,
        "gates": ("parity on the device == the CPU's"
                  if args.parity_gate == "detections" else
                  "parity candidates on the device == the CPU's, the tail "
                  "bit for bit") + "; fast within phase 4's "
                 "tolerances; int8 within them under one plan"
                 + ("; golden boxes exact"
                                 if os.path.isdir(REFERENCE) else ""),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
