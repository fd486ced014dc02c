"""``ffcnn-torch`` command-line demo, the port of ``ffcnn_tpu/cli.py``: the
reference main() (ffcnn.c:552-593) on PyTorch, on the card unless
``--device cpu`` is given.

    python -m ffcnn_tpu_torch.cli detect [image.bmp] [-n ITERS] [--cfg FILE] \\
        [--weights FILE] [--mode fast|parity|int8] [-o out.bmp] [--device cpu]
    python -m ffcnn_tpu_torch.cli dump   [--cfg FILE] [--width W] [--height H]
    python -m ffcnn_tpu_torch.cli batch  IMAGE... [--batch N] [--cache-dir D]
    python -m ffcnn_tpu_torch.cli bench  [--batch N] [--size S] [--iters I] \
        [--dp] [--sp N]
    python -m ffcnn_tpu_torch.cli profile [--batch N] [--size S] [--iters I]
    python -m ffcnn_tpu_torch.cli roofline [--batch N] [--size S|WxH]
    python -m ffcnn_tpu_torch.cli convert-v8 SD.pt [-o OUT] [--nc N] \
        [--scale n|s|m|l|x] [--size S] [--conf C]
    python -m ffcnn_tpu_torch.cli export OUT.pt2 [--batch 1,2,...] \
        [--size S] [--cfg FILE] [--weights FILE] [--mode M] [--device cpu]

Output format (scores, categories, int-cast rects, drawn rectangles, timing
line) matches the reference demo and the JAX package's CLI, so the three
are diffable.  ``convert-v8`` turns a YOLOv8 state dict into ``OUT.cfg`` and
``OUT.weights`` on the host (``yolov8.py``); every other command then serves
those files.  ``--mode int8`` runs an int8 plan calibrated on the command's
first frames (at most 8: the image for ``detect``, the first chunk for
``batch``, the batch for ``bench`` and ``profile``), as the JAX package's
CLI does.  ``export`` writes one ``torch.export`` artifact a batch size
(``export.py``; ``--batch 1,2`` writes ``OUT.b1.pt2`` and ``OUT.b2.pt2``),
each with its ``.meta.json`` sidecar, on the device the artifact will run
on; in int8 mode its plan comes from ``--quant-plan`` (a saved plan) or is
calibrated on ``--calib`` frames.  ``bench --dp`` runs the Net on every
slot of a data-parallel mesh (``parallel/dp.py::build_dp_pipeline``, one
replica a slot); ``bench --sp N`` (or ``--dp`` with it) runs the plain
forward with each blob's rows split over N slots
(``build_sharded_pipeline``).  The mesh takes one slot a visible card (one
CPU slot with ``--device cpu``), and at least ``--sp`` slots: the cards
repeat in turn where ``--sp`` outnumbers them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import roofline
from .darknet import dump, parse_cfg
from .imageio.bmp import bmp_load, bmp_save, draw_rectangle
from .imageio.loader import load_batch
from .net import Net, planned_runs
from .tuning import get_flag

# the reference model's files, where the JAX package's CLI looks for them
REFERENCE = "/root/reference"
DEFAULT_CFG = os.path.join(REFERENCE, "yolo-fastest-1.1.cfg")
DEFAULT_WEIGHTS = os.path.join(REFERENCE, "yolo-fastest-1.1.weights")

# the commands that load a Net, and so need the card without --device cpu
_DEVICE_COMMANDS = {"detect", "bench", "profile", "batch", "export"}


def _add_model_args(p):
    p.add_argument("--cfg", default=DEFAULT_CFG)
    p.add_argument("--weights", default=DEFAULT_WEIGHTS)
    p.add_argument("--mode", choices=("fast", "parity", "int8"),
                   default="parity")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card unless 'cpu' is asked for")


def _load(args, w: int, h: int, **kw):
    return Net.load(args.cfg, args.weights, w, h, mode=args.mode,
                    device=args.device, **kw)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cmd_detect(args) -> int:
    bgr = bmp_load(args.image)
    net = _load(args, bgr.shape[1], bgr.shape[0])
    if args.dump:
        sys.stdout.write(net.dump())
    t0 = time.perf_counter()
    for _ in range(args.n):
        dets = net.detect(bgr)
    ms = (time.perf_counter() - t0) * 1000
    print("%d times inference: %d ms" % (args.n, int(ms)))
    for d in dets:
        print("score: %.2f, category: %2d, rect: (%3d %3d %3d %3d)"
              % (d.score, d.class_id, int(d.x1), int(d.y1),
                 int(d.x2), int(d.y2)))
        draw_rectangle(bgr, int(d.x1), int(d.y1), int(d.x2), int(d.y2),
                       0, 255, 0)
    bmp_save(args.output, bgr)
    return 0


def cmd_dump(args) -> int:
    ir = parse_cfg(args.cfg, args.width, args.height)
    sys.stdout.write(dump(ir))
    return 0


def _mesh_slots(args) -> list:
    """The mesh devices: one slot a visible card (one CPU slot with
    ``--device cpu``), repeated in turn up to ``--sp`` slots."""
    from .parallel.mesh import slot_devices
    devs = slot_devices(args.device)
    return [devs[i % len(devs)] for i in range(max(args.sp, len(devs)))]


def cmd_bench(args) -> int:
    """A device-resident batch through ``detect_device`` (a bucket's graph
    replay on the card), or over a mesh with ``--dp``/``--sp``
    (``ffcnn_tpu/cli.py::cmd_bench``'s branches and labels), ``--iters``
    calls timed with one synchronise."""
    batch = np.random.RandomState(0).randint(
        0, 255, (args.batch, args.size, args.size, 3), np.uint8)
    if args.dp and args.sp == 1:
        # pure DP: the Net's own single-card pipeline (its kernels, int8
        # plan and folded preprocess) on every data slot
        from .parallel import build_dp_pipeline, make_mesh
        net = _load(args, args.size, args.size)
        if args.mode == "int8" and net.quant is None:
            # the replicas take the Net's plan: calibrate first, as
            # detect_device would on its first frames
            net.calibrate(batch[: min(8, len(batch))])
        mesh = make_mesh(_mesh_slots(args))
        fn = build_dp_pipeline(net, mesh, args.size, args.size)
        # one upload: re-sending the host batch each call would time it
        xb = torch.from_numpy(batch).to(mesh.devices.flat[0])
        run = lambda: fn(xb)
        label = "dp mesh %s" % dict(mesh.shape)
        devices = set(mesh.devices.flat)
    elif args.dp or args.sp > 1:
        # the plain forward over a mesh: the batch on the data axis, each
        # blob's rows over --sp spatial slots, halo rows gathered
        from .darknet.weights import load_weights
        from .graph.build import params_from_numpy
        from .parallel import build_sharded_pipeline, make_mesh
        ir = parse_cfg(args.cfg, args.size, args.size)
        params = params_from_numpy(load_weights(ir, args.weights)[0])
        mesh = make_mesh(_mesh_slots(args), spatial_parallel=args.sp)
        fn, place = build_sharded_pipeline(
            ir, mesh, args.size, args.size,
            dtype=torch.bfloat16 if args.mode == "fast" else torch.float32)
        placed = place(params)
        xb = torch.from_numpy(batch).to(mesh.devices.flat[0])
        run = lambda: fn(placed, xb, (0.0, 0.0, 0.0), (1 / 255.0,) * 3)
        label = "mesh %s" % dict(mesh.shape)
        devices = set(mesh.devices.flat)
    else:
        net = _load(args, args.size, args.size)
        xb = torch.from_numpy(batch).to(net.device)
        if args.mode == "int8":
            net.calibrate(batch[: min(8, len(batch))])
        run = lambda: net.detect_device(xb)
        label = args.mode
        devices = {net.device}

    def sync():
        for d in devices:
            _sync(d)

    run()
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    sync()
    dt = (time.perf_counter() - t0) / args.iters
    print("batch %d @%dx%d %s: %.2f ms/batch, %.0f img/s"
          % (args.batch, args.size, args.size, label, dt * 1000,
             args.batch / dt))
    return 0


def cmd_profile(args) -> int:
    net = _load(args, args.size, args.size)
    rep = net.profile_layers(
        batch=np.zeros((args.batch, args.size, args.size, 3), np.uint8),
        iters=args.iters)
    sys.stdout.write(rep.render())
    # stage-level roofline with the measured times merged in
    sys.stdout.write("\n" + roofline.render(
        net.ir, net.roofline_costs(args.batch), args.batch,
        measured_us={lp.index: lp.us_per_step for lp in rep.layers},
        measured_label=f"{rep.clock} us"))
    if net.device.type != "cuda":
        print("memory: not measured (CPU Net)")
        return 0
    m = net.memory_stats(batch_size=args.batch)
    print("memory (batch %d): peak %.1f MB  (args %.1f, temp %.1f, "
          "output %.1f, code %.1f)"
          % (args.batch, m["peak"] / 1e6, m["args"] / 1e6, m["temp"] / 1e6,
             m["output"] / 1e6, m["code"] / 1e6))
    return 0


def cmd_batch(args) -> int:
    """Batch detection over many BMPs: fixed-size chunks streamed through
    ``Net.detect_stream`` (two chunks in flight), so the loader decodes
    chunk i+1 while the card runs chunk i.  One bucket whatever the image
    count."""
    paths = args.images
    bs = max(1, min(args.batch, len(paths)))
    probe = load_batch(paths[:1])       # dims only; the net needs a size
    net = _load(args, probe.shape[2], probe.shape[1],
                cache_dir=args.cache_dir)

    def chunks():
        for i in range(0, len(paths), bs):
            imgs = load_batch(paths[i:i + bs], args.threads)
            if imgs.shape[0] < bs:      # pad the tail into the same bucket
                pad = np.zeros((bs - imgs.shape[0],) + imgs.shape[1:],
                               np.uint8)
                imgs = np.concatenate([imgs, pad])
            yield imgs

    # the timed region covers every chunk's decode and detection; only the
    # one-image dims probe and the model load sit outside it
    t0 = time.perf_counter()
    results = []
    for dets in net.detect_stream(chunks(), depth=2):
        results.extend(dets)
    results = results[: len(paths)]
    ms = (time.perf_counter() - t0) * 1000
    print("%d images: %d ms (%.1f img/s)"
          % (len(results), int(ms), len(results) / (ms / 1000)))
    for path, dets in zip(paths, results):
        print(path)
        for d in dets:
            print("  score: %.2f, category: %2d, rect: (%3d %3d %3d %3d)"
                  % (d.score, d.class_id, int(d.x1), int(d.y1),
                     int(d.x2), int(d.y2)))
    return 0


def cmd_export(args) -> int:
    """One artifact a batch size (``ffcnn_tpu/cli.py::cmd_export``); a list
    of batch sizes suffixes each file ``.b{n}``."""
    net = _load(args, args.size, args.size)
    if args.mode == "int8":
        from .quant import load_plan
        if args.quant_plan:
            net.set_quant_plan(load_plan(args.quant_plan, net.device))
        else:
            net.calibrate(np.stack([bmp_load(p) for p in args.calib]))
    size = None if args.size == 0 else (args.size, args.size)
    platforms = args.platforms.split(",") if args.platforms else None
    batches = [int(b) for b in str(args.batch).split(",")]
    for b in batches:
        stem, ext = os.path.splitext(args.out)
        out = args.out if len(batches) == 1 else f"{stem}.b{b}{ext}"
        n = net.export(out, batch_size=b, image_size=size,
                       platforms=platforms)
        print(f"wrote {out}: {n} bytes (batch {b}, device "
              f"{net.device.type}, platforms "
              f"{','.join(platforms or [net.device.type])})")
    return 0


def cmd_convert_v8(args) -> int:
    """YOLOv8 state dict -> ``<out>.cfg`` and ``<out>.weights``
    (``yolov8.py``), on the host only, as ``ffcnn_tpu/cli.py::
    cmd_convert_v8``: detect, batch, dump, profile, roofline and bench then
    serve the two files as they are."""
    from . import yolov8
    from .darknet.weights import load_weights

    sd = torch.load(args.sd, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        print("error: expected a plain state dict "
              "(torch.save(model.state_dict(), path))", file=sys.stderr)
        return 1
    cfg_text, wbytes = yolov8.convert(sd, args.nc, args.scale,
                                      size=args.size, conf=args.conf)
    ir = parse_cfg(cfg_text, is_path=False)
    load_weights(ir, wbytes)       # raises on any float-census mismatch
    cfg_path, w_path = args.out + ".cfg", args.out + ".weights"
    with open(cfg_path, "w") as f:
        f.write(cfg_text)
    with open(w_path, "wb") as f:
        f.write(wbytes)
    heads = sum(1 for l in ir.layers if l.type.name == "YOLOV8")
    print(f"wrote {cfg_path} ({len(ir.layers)} layers, {heads} v8 heads) "
          f"+ {w_path} ({len(wbytes)} bytes, census-validated)")
    print(f"try: python -m ffcnn_tpu_torch.cli detect img.bmp --cfg "
          f"{cfg_path} --weights {w_path}")
    return 0


def cmd_roofline(args) -> int:
    """Static device-memory/FLOP roofline for a cfg, with no device and no
    weights: bytes moved, FLOPs and the time floor per resolution stage
    (``roofline.py``), for the plan a fast Net would run under the
    ``FFCNN_FUSED*`` flags set (the port runs its runs at every batch)."""
    geo = str(args.size)
    w, h = (map(int, geo.split("x")) if "x" in geo
            else (int(geo), int(geo)))
    ir = parse_cfg(args.cfg, w, h)
    runs, heads = planned_runs(ir, not args.no_fused
                               and args.dtype == "bf16")
    store = get_flag("FFCNN_FUSED_STORE", "")
    costs = roofline.layer_costs(
        ir, args.batch, args.dtype, fused_runs=(runs + heads) or None,
        store_dtype=store if store == "f32" else None)
    sys.stdout.write(roofline.render(ir, costs, args.batch))
    if runs:
        print("fused runs: %s" % ", ".join(
            "L%d-%d" % (r.start, r.end) for r in runs))
    if heads:
        print("head runs: %s" % ", ".join(
            "L%d-%d" % (r.start, r.end) for r in heads))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ffcnn-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pd = sub.add_parser("detect", help="detect objects in a BMP image")
    pd.add_argument("image", nargs="?",
                    default=os.path.join(REFERENCE, "test.bmp"))
    pd.add_argument("-n", type=int, default=1, help="inference iterations")
    pd.add_argument("-o", "--output", default="out.bmp")
    pd.add_argument("--dump", action="store_true",
                    help="print the layer table first (like the C demo)")
    _add_model_args(pd)

    pp = sub.add_parser("dump", help="print the net_dump layer table")
    pp.add_argument("--cfg", default=DEFAULT_CFG)
    pp.add_argument("--width", type=int, default=0)
    pp.add_argument("--height", type=int, default=0)

    pb = sub.add_parser("bench", help="throughput micro-benchmark")
    pb.add_argument("--batch", type=int, default=256)
    pb.add_argument("--size", type=int, default=320)
    pb.add_argument("--iters", type=int, default=10)
    pb.add_argument("--dp", action="store_true",
                    help="data-parallel over every mesh slot: the Net's "
                         "own pipeline on each (parallel/dp.py)")
    pb.add_argument("--sp", type=int, default=1, metavar="N",
                    help="split each image's rows over N spatial slots "
                         "(halo rows gathered at every window)")
    _add_model_args(pb)
    pb.set_defaults(mode="fast")

    pf = sub.add_parser("profile", help="per-layer time profile "
                                        "(net_profile)")
    pf.add_argument("--batch", type=int, default=64)
    pf.add_argument("--size", type=int, default=320)
    pf.add_argument("--iters", type=int, default=10)
    _add_model_args(pf)
    pf.set_defaults(mode="fast")

    pe = sub.add_parser("export", help="write torch.export artifacts of the "
                                       "pixels-to-boxes pipeline")
    pe.add_argument("out", help="artifact output path (.pt2)")
    pe.add_argument("--batch", default="1",
                    help="batch size, or a comma list (one file each)")
    pe.add_argument("--size", type=int, default=0)
    pe.add_argument("--calib", nargs="*", default=None,
                    help="BMP frames to calibrate an int8 plan on")
    pe.add_argument("--quant-plan", default=None,
                    help="a saved int8 plan (quant.save_plan's npz)")
    pe.add_argument("--platforms", default=None,
                    help="comma list of cuda, cpu: a program each in the "
                         "one file (default the --device's)")
    _add_model_args(pe)
    pe.set_defaults(mode="fast")

    pr = sub.add_parser(
        "roofline", help="static device-memory/FLOP traffic and time-floor "
                         "table (no device needed)")
    pr.add_argument("--cfg", default=DEFAULT_CFG)
    pr.add_argument("--batch", type=int, default=256)
    pr.add_argument("--size", default="320",
                    help="square size or WxH (e.g. 640x448, the "
                         "reference demo geometry)")
    pr.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    pr.add_argument("--no-fused", action="store_true",
                    help="model per-layer materialization instead of the "
                         "fused-run plan")

    pm = sub.add_parser("batch", help="batch detection over many BMPs")
    pm.add_argument("images", nargs="+")
    pm.add_argument("--batch", type=int, default=64,
                    help="chunk size streamed per dispatch (the loader "
                         "overlaps device compute)")
    pm.add_argument("--threads", type=int, default=0,
                    help="loader threads (0 = all cores)")
    pm.add_argument("--cache-dir", default=None,
                    help="folded-params npz cache directory")
    _add_model_args(pm)
    pm.set_defaults(mode="fast")

    pv = sub.add_parser(
        "convert-v8", help="YOLOv8 state dict -> darknet cfg + .weights "
                           "(then every other command serves the output)")
    pv.add_argument("sd", help="torch-saved PLAIN state dict "
                               "(torch.save(model.state_dict(), path))")
    pv.add_argument("-o", "--out", default="yolov8",
                    help="output basename (writes <out>.cfg + <out>.weights)")
    pv.add_argument("--nc", type=int, default=80, help="class count")
    pv.add_argument("--scale", default="n", choices=("n", "s", "m", "l", "x"))
    pv.add_argument("--size", type=int, default=640, help="net input size")
    pv.add_argument("--conf", type=float, default=0.25,
                    help="score threshold baked into the [yolov8] heads")

    args = ap.parse_args(argv)
    if args.cmd == "export" and args.mode == "int8" and not (
            args.calib or args.quant_plan):
        ap.error("export --mode int8 needs --calib <frame.bmp> [...] or "
                 "--quant-plan")
    if args.cmd in _DEVICE_COMMANDS and args.device == "cuda" \
            and not torch.cuda.is_available():
        ap.error("no CUDA device: the port runs on the card unless "
                 "--device cpu is given")
    return {"detect": cmd_detect, "dump": cmd_dump, "bench": cmd_bench,
            "profile": cmd_profile, "batch": cmd_batch,
            "roofline": cmd_roofline, "export": cmd_export,
            "convert-v8": cmd_convert_v8}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
