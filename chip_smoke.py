#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ffcnn_tpu_torch``) on one NVIDIA
card.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``; ``CUDA_HOME``
defaults to /usr/local/cuda).  Phases, each of which exits non-zero on
failure:

  1. the card's name and power limit (nvidia-smi)
  2. build the kernels from ffcnn_tpu_torch/csrc/ with nvcc
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it
  4. the main path: yolo-fastest-xl at 320x320 with synthesized weights
     (seed 42), fast mode, ``detect`` on a batch of 64 frames and on one
     640x448 frame; kernel launch counts; heads and detections against the
     same Net on the CPU
  5. parity mode on the card against parity mode on the CPU
  6. timings with CUDA events: kernels against their plain versions, the
     fused runs against the unfused cuDNN chain, fast-mode img/s

The last line of standard output is one JSON object with the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
BMP = os.path.join(REPO, "tests", "fixtures", "test320.bmp")
SEED = 42
BATCH = 64
NMS_KS = (128, 1500)        # fast mode's top-k, and xl's candidate count

# Tolerances of a kernel against its plain version on the same inputs.
# float32: the same sums in another order (<= 448 terms): 2e-5 of the
# output's range.  bfloat16: one rounding of those sums at the store, so a
# value an f32 ulp from a rounding edge may land one bf16 ulp (2^-8
# relative) away; allow two.
K1_TOL = {"float32": 2e-5, "bfloat16": 2 ** -7}
# The whole fast forward on the card against the CPU: every bf16 blob may
# carry such one-ulp flips from the previous layers (the CPU test of the
# port against JAX holds the same bounds).
HEAD_MAX_TOL, HEAD_MEAN_TOL = 2 ** -3, 2 ** -8
# Detections of the two fast forwards: bf16 drift reorders near-equal
# scores, so top-k and greedy NMS may keep another member of a cluster.
# Each side's detections are held against the other side's candidates
# (decoded boxes before NMS): 90% need a same-class candidate within 4 px
# and 0.02 in score (the rest are knife-edges at the ignore threshold).
DET_MATCH_FRAC, DET_MATCH_PX, DET_MATCH_SCORE = 0.9, 4.0, 0.02
# Parity (float32, TF32 off) on the card against the CPU, paired as sets
# per image (synthetic weights give equal-score ties, which come out in
# either order): same class, scores to 1e-4, and an integer box may differ
# only where float32 noise (<= 1e-3 px) moved a coordinate across an
# integer.
PARITY_SCORE_TOL, PARITY_BOX_NOISE = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nms_candidates(n: int, k: int, seed: int):
    """Sorted candidates with equal scores, touching and degenerate boxes
    and five classes (coordinates on a coarse integer grid)."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 64, (n, k, 2)).astype(np.float32)
    wh = rng.randint(0, 24, (n, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    scores = rng.choice([0.5, 0.6, 0.75, 0.9, 1.0], (n, k)).astype(np.float32)
    scores[rng.rand(n, k) < 0.2] = 0.0
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)
    scores = np.take_along_axis(scores, order, axis=1)
    classes = rng.randint(0, 5, (n, k)).astype(np.int32)
    return boxes, scores, classes


def match_fraction(dets, boxes, scores, classes, px: float,
                   score_tol: float) -> float:
    """Share of ``dets`` that are among the candidates (``boxes`` (M, 4),
    ``scores`` (M,), ``classes`` (M,) numpy, score 0 = absent): same class,
    every coordinate within ``px``, score within ``score_tol``."""
    live = scores > 0
    boxes, scores, classes = boxes[live], scores[live], classes[live]
    if not dets:
        return 1.0
    hits = sum(bool(np.any((classes == d.class_id)
                           & (np.abs(boxes - np.asarray(d[2:])).max(1) <= px)
                           & (np.abs(scores - d.score) <= score_tol)))
               for d in dets)
    return hits / len(dets)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import ffcnn_tpu_torch as pt
        from ffcnn_tpu_torch.graph.build import forward_features
        from ffcnn_tpu_torch.kernels import block_fused as bf
        from ffcnn_tpu_torch.kernels import nms as knms
        from ffcnn_tpu_torch.ops.yolo import concat_heads, decode_head
    except ImportError as e:
        print(f"chip_smoke: the repository is not here ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    # 2. build (0 s where the library was already built from these sources)
    seconds = {}
    for name, build in (("K1 block_fused", bf.build), ("K2 nms", knms.build)):
        t0 = time.perf_counter()
        build()
        seconds[name] = time.perf_counter() - t0
    log(f"[2] kernels built in {sum(seconds.values()):.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")

    # the model and its params (the same weights on the card and the CPU)
    wbytes = pt.synth_weights_bytes(pt.parse_cfg(CFG), seed=SEED,
                                    obj_bias=2.0)
    net = pt.load(CFG, wbytes, mode="fast", device="cuda")
    ir, runs = net.ir, net._fused_runs
    if [(r.start, r.end, len(r.blocks)) for r in runs] != \
            [(38, 57, 4), (61, 80, 4), (84, 108, 5)]:
        raise AssertionError(f"unexpected fused plan {runs}")
    gen = torch.Generator().manual_seed(SEED)

    # 3. kernels against their plain versions
    k1_err = 0.0
    for r in runs:
        b = ir.blobs[r.start]
        bp = net._fused_params[r.start][0]
        for dtype in ("float32", "bfloat16"):
            x = torch.randn((BATCH, b.h, b.w, b.c), generator=gen)
            x = x.to(dev, getattr(torch, dtype))
            got = bf.fused_block(x, bp).float()
            want = bf.block_plain(x, bp).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = bool(torch.isfinite(got).all()) and \
                err <= K1_TOL[dtype] * scale
            log(f"[3] K1 block {b.h}x{b.w} C{b.c} E{bp.w1.shape[1]} "
                f"P{bp.w2.shape[1]} batch {BATCH} {dtype}: max|err| {err:.3e}"
                f" (tol {K1_TOL[dtype] * scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("K1 disagrees with its plain version")
            if dtype == "bfloat16":
                k1_err = max(k1_err, err)
    k2_err = 0.0
    for k in NMS_KS:
        for kind in ("min", "union"):
            cand = nms_candidates(BATCH, k, seed=k)
            tb, ts, tc = (torch.from_numpy(a).to(dev) for a in cand)
            got = knms.nms_keep_mask(tb, ts, tc, threshold=0.5,
                                     iou_kind=kind)
            want = knms.keep_mask_plain(tb, ts, tc, 0.5, kind)
            want_cpu = knms.keep_mask_plain(
                *(torch.from_numpy(a) for a in cand), 0.5, kind)
            same = torch.equal(got, want) and \
                torch.equal(got.cpu(), want_cpu)
            k2_err = max(k2_err, (got.float() - want.float()).abs().max()
                         .item())
            log(f"[3] K2 nms K={k} batch {BATCH} iou={kind}: kept "
                f"{int(got.sum())}/{int((ts > 0).sum())}, mismatches "
                f"{int((got != want).sum())} "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError("K2 keep mask differs from plain")

    # 4. the main path
    rng = np.random.RandomState(SEED)
    frames = np.concatenate([pt.bmp_load(BMP)[None], rng.randint(
        0, 256, (BATCH - 1, 320, 320, 3), dtype=np.uint8)])
    bf.fused_block.launches = 0
    knms.nms_keep_mask.launches = 0
    dets = net.detect(frames)
    torch.cuda.synchronize()
    k1_launches = bf.fused_block.launches
    k2_launches = knms.nms_keep_mask.launches
    log(f"[4] fast detect batch {BATCH}: {sum(map(len, dets))} detections "
        f"({len(dets[0])} on test320.bmp); launches K1 {k1_launches} "
        f"K2 {k2_launches}")
    if k1_launches != 13 or k2_launches < 1:
        raise AssertionError("the main path did not run its kernels")
    for d in (x for img in dets for x in img):
        if not (0 < d.score <= 1 and 0 <= d.class_id < 80
                and all(np.isfinite(d[2:]))):
            raise AssertionError(f"bad detection {d}")
    wide = rng.randint(0, 256, (448, 640, 3), dtype=np.uint8)
    bf.fused_block.launches = 0
    d640 = net.detect(wide)
    log(f"[4] fast detect 640x448: {len(d640)} detections, K1 launches "
        f"{bf.fused_block.launches}")
    if bf.fused_block.launches != 13 or not all(
            0 < d.score <= 1 and np.isfinite(d[2:]).all() for d in d640):
        raise AssertionError("640x448 detect failed")

    cpu_net = pt.load(CFG, wbytes, mode="fast", device="cpu")
    few = frames[:4]
    hg = net.forward_heads(torch.from_numpy(few).to(dev))
    hc = cpu_net.forward_heads(torch.from_numpy(few))
    for i, (g, c) in enumerate(zip(hg, hc)):
        g, c = g.float().cpu(), c.float()
        scale = c.abs().max().item()
        err = (g - c).abs()
        ok = bool(torch.isfinite(g).all()) and \
            err.max().item() <= HEAD_MAX_TOL * scale and \
            err.mean().item() <= HEAD_MEAN_TOL * scale
        log(f"[4] head {i} {tuple(g.shape)} card vs CPU: max|err| "
            f"{err.max().item():.3e} mean {err.mean().item():.3e} (scale "
            f"{scale:.2f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fast heads disagree with the CPU")
    dc = cpu_net.detect(few)
    heads = [l for l in ir.layers if l.type == pt.LayerType.YOLO]
    cands = [concat_heads([decode_head(h.float().cpu(), l, 320, 320)
                           for h, l in zip(hs, heads)]) for hs in (hg, hc)]
    for i in range(len(few)):
        fr = [match_fraction(d[i], *(t[i].numpy() for t in c), DET_MATCH_PX,
                             DET_MATCH_SCORE)
              for d, c in ((dets, cands[1]), (dc, cands[0]))]
        ok = min(fr) >= DET_MATCH_FRAC
        log(f"[4] image {i}: card {len(dets[i])} CPU {len(dc[i])} "
            f"detections; among the other side's candidates: card "
            f"{fr[0]:.3f}, CPU {fr[1]:.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fast detections disagree with the CPU")

    # 5. parity mode, card against CPU
    pg = pt.load(CFG, wbytes, mode="parity", device="cuda").detect(few)
    pc = pt.load(CFG, wbytes, mode="parity", device="cpu").detect(few)
    flips = worst = 0
    for a, b in zip(pg, pc):
        if len(a) != len(b):
            raise AssertionError(f"parity counts differ {len(a)} {len(b)}")
        # equal-score ties may come out in either order: pair as sets
        free = list(b)
        for g in a:
            c = next((c for c in free if c.class_id == g.class_id
                      and abs(c.score - g.score) <= PARITY_SCORE_TOL
                      and all(int(u) == int(v) or abs(u - v)
                              <= PARITY_BOX_NOISE
                              for u, v in zip(g[2:], c[2:]))), None)
            if c is None:
                raise AssertionError(f"parity detection {g} not on the CPU")
            free.remove(c)
            worst = max(worst, abs(g.score - c.score))
            flips += sum(int(u) != int(v) for u, v in zip(g[2:], c[2:]))
    log(f"[5] parity card vs CPU: {sum(map(len, pg))} detections equal "
        f"(class, integer box), max |score diff| {worst:.2e}, integer "
        f"flips within {PARITY_BOX_NOISE} px: {flips}")

    # 6. timings (device time by CUDA events)
    x_runs = {r.start: torch.randn(
        (BATCH,) + ir.blobs[r.start].nhwc, generator=gen).to(
            dev, torch.bfloat16) for r in runs}

    def k1_all():
        for r in runs:
            bf.apply_run(x_runs[r.start], r, net._fused_params[r.start])

    def k1_plain():
        for r in runs:
            x = x_runs[r.start]
            for bp in net._fused_params[r.start]:
                x = bf.block_plain(x, bp)

    for r in runs:
        b = ir.blobs[r.start]
        x, bps = x_runs[r.start], net._fused_params[r.start]
        ms = cuda_ms(lambda: bf.fused_block(x, bps[0]))
        pms = cuda_ms(lambda: bf.block_plain(x, bps[0]))
        flop = 2 * BATCH * b.h * b.w * bps[0].w1.shape[1] * (
            2 * b.c + 9) / 1e9
        log(f"[6] K1 one block {b.h}x{b.w} C{b.c} E{bps[0].w1.shape[1]} "
            f"bf16 batch {BATCH}: kernel {ms:.4f} ms ({flop / ms:.1f} "
            f"TFLOP/s useful), plain {pms:.4f} ms")
    k1_ms, k1_pms = cuda_ms(k1_all), cuda_ms(k1_plain)
    k1_pms2 = cuda_ms(k1_plain)
    k1_ms2 = cuda_ms(k1_all)
    log(f"[6] K1 all 13 blocks bf16 batch {BATCH}: kernel {k1_ms:.4f} / "
        f"{k1_ms2:.4f} ms, plain {k1_pms:.4f} / {k1_pms2:.4f} ms")

    nms_ms = {}
    for k in NMS_KS:
        tb, ts, tc = (torch.from_numpy(a).to(dev)
                      for a in nms_candidates(BATCH, k, seed=k))
        ms = cuda_ms(lambda: knms.nms_keep_mask(tb, ts, tc, threshold=0.5))
        pms = cuda_ms(lambda: knms.keep_mask_plain(tb, ts, tc, 0.5),
                      iters=3, warmup=1)
        nms_ms[k] = (ms, pms)
        log(f"[6] K2 nms K={k} batch {BATCH}: kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms")

    # the fused runs against the unfused cuDNN chain, whole forward
    xb = torch.from_numpy(frames).to(dev)
    folded = net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)

    torch.backends.cudnn.allow_tf32 = True   # fast mode: exact on bf16 values

    def fwd(fused):
        forward_features(ir, folded, xb, input_dtype=torch.bfloat16,
                         fused_runs=runs if fused else None,
                         fused_params=net._fused_params)
    f_unf, f_fus = cuda_ms(lambda: fwd(False), 10), cuda_ms(lambda: fwd(True),
                                                            10)
    f_fus2, f_unf2 = cuda_ms(lambda: fwd(True), 10), cuda_ms(
        lambda: fwd(False), 10)
    log(f"[6] fast forward batch {BATCH}: unfused cuDNN {f_unf:.3f} / "
        f"{f_unf2:.3f} ms, fused runs {f_fus:.3f} / {f_fus2:.3f} ms")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.detect_device(xb)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=12, max_name_column_width=48)
    log(f"[6] profile of one fast detect_device, batch {BATCH}:")
    for line in table.splitlines():
        log("    " + line)

    ladder = {}
    for n, iters in ((1, 50), (64, 20), (256, 8)):
        batch = torch.from_numpy(np.resize(frames, (n, 320, 320, 3))).to(dev)
        ms = cuda_ms(lambda: net.detect_device(batch), iters=iters)
        ladder[n] = n / ms * 1e3
        log(f"[6] fast detect_device batch {n}: {ms:.3f} ms/batch, "
            f"{ladder[n]:.1f} img/s (pixels on the card; decode+NMS "
            f"included)")
    torch.cuda.synchronize()
    log(f"[6] peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        f" MiB")

    kernels = [
        {"name": "block_fused_s1", "route": "cuda",
         "source": "ffcnn_tpu_torch/csrc/block_fused.cu",
         "replaces": "ffcnn_tpu/kernels/block_fused.py:206",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_pms},
        {"name": "nms_keep_mask", "route": "cuda",
         "source": "ffcnn_tpu_torch/csrc/nms.cu",
         "replaces": "ffcnn_tpu/kernels/nms_pallas.py:26",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": nms_ms[128][0], "plain_ms": nms_ms[128][1]},
    ]
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
