"""The int8 conv (``csrc/conv_int8.cu``) alone, at the shapes int8 plans
give it: yolo-fastest-xl's unfused int8 convs at 320x320 (13 depthwise, 16
1x1) at ``chip_smoke.py``'s ``BATCH`` and YOLOv8n's distinct unfused int8
convs at 640x640 at its ``V8_INT8_TIME``, each with seeded codes and
weights of its shape, its output kind and activation, on the card:

    python -m ffcnn_tpu_torch.bench_conv_int8 [--detect] [--stems]

The same shapes through another tree's copy of the package (an A/B
against a parent commit unpacked beside this one, one process a tree on
the same card, in turns):

    python ffcnn_tpu_torch/bench_conv_int8.py --root DIR

The batches, the seed, the sizes, the region flags and the bound are those
of the ``chip_smoke.py`` beside this file; the shapes are
``quant.conv_shapes`` of the timed tree's Nets.  Each shape is checked
against the plain version first (the int32 accumulators and the output,
bit for bit), then timed alone: 20 launches in one CUDA graph, replayed
between CUDA events (``bench_block.graph_launch_ms``), beside the plain
version (CUDA events) and the bound (``chip_smoke.int8_bound``).  With
``--detect`` it also times xl's int8 default and int8 region Nets (one
plan) end to end: ``detect_device`` at batch 1 and ``BATCH``, the
bucket's replays between CUDA events.  With ``--stems`` it also times the
uint8 mode (conv-1 straight off the pixels, ``FFCNN_CONV0_INT8``) at
xl's stem, 320x320 and 322x322 at ``BATCH``, and YOLOv8n's at 640x640 at
``V8_INT8_TIME`` (seeded weights of each stem's shape, checked bit for bit
first), and xl's region Net with and without the flag, ``detect_device``
at batch 1 and ``BATCH`` in turns.  The last line is one JSON object: the
card, the tree, and per model the summed ms (split into depthwise and
dense) and each shape's ms, plain ms, bound and path.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys

import numpy as np

TREE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL_SIZE = 320


@functools.cache
def smoke():
    """The ``chip_smoke.py`` of this file's tree (whatever tree's package
    is timed)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(TREE, "chip_smoke.py"))
    mod = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def label(li: int, geo) -> str:
    h, w, c, f, k, s, _, groups, act, codes = geo
    kind = "dw" if groups > 1 else f"{k}x{k}"
    return (f"L{li} {kind} s{s} {h}x{w} C{c}->{f} act {act} "
            f"{'codes' if codes else 'bf16'}")


def seeded_case(ci, geo, batch: int, gen, device):
    """Seeded int8 codes (batch, h, w, c) and an ``Int8Conv`` of ``geo``."""
    import torch
    h, w, c, f, k, s, pad, groups, act, codes = geo
    wq = torch.randint(-127, 128, (k, k, c // groups, f), generator=gen,
                       dtype=torch.int8)
    ws = (torch.rand(f, generator=gen) * 0.02 + 1e-3).numpy()
    bias = (torch.rand(f, generator=gen) * 2 - 1).numpy()
    cp = ci.prepare(wq.to(device), 0.0413, ws, bias, stride=s, pad=pad,
                    groups=groups, act=act, out_scale=0.05 if codes else None)
    x = torch.randint(-127, 128, (batch, h, w, c), generator=gen,
                      dtype=torch.int8).to(device)
    return x, cp


def check_case(ci, x, cp):
    """The kernel against its plain version: accumulators and outputs bit
    for bit.  Returns the output."""
    import torch
    if not torch.equal(ci.conv_int8(x, cp, raw=True),
                       ci.conv_int8_plain(x, cp, raw=True)):
        raise AssertionError("int8 conv: accumulators differ")
    y = ci.conv_int8(x, cp)
    if not torch.equal(y, ci.conv_int8_plain(x, cp)):
        raise AssertionError("int8 conv: outputs differ")
    return y


def route_of(ci, x, cp) -> str:
    """The path a launch took (``conv_int8.routes``; "first" for a tree
    without them, one path a conv kind)."""
    routes = getattr(ci.conv_int8, "routes", None)
    if routes is None:
        return "first"
    before = dict(routes)
    ci.conv_int8(x, cp)
    return next(k for k, v in routes.items() if v != before[k])


def model_nets(pt, device):
    """xl's and v8n's int8 Nets on ``device``, each calibrated on seeded
    frames."""
    from ffcnn_tpu_torch import yolov8
    from ffcnn_tpu_torch.darknet.weights import load_weights
    cs = smoke()
    rng = np.random.RandomState(cs.SEED)
    wbytes = pt.synth_weights_bytes(pt.parse_cfg(cs.CFG), seed=cs.SEED,
                                    obj_bias=2.0)
    xl = pt.load(cs.CFG, wbytes, mode="int8", device=device)
    xl.calibrate(rng.randint(0, 256, (2, XL_SIZE, XL_SIZE, 3), np.uint8))
    sd = yolov8.synthesize_state_dict(80, "n", seed=0)
    v8cfg, v8w = yolov8.convert(sd, 80, "n", size=cs.V8_SIZE,
                                conf=cs.V8_CONF)
    ir = pt.parse_cfg(v8cfg, is_path=False)
    params, _ = load_weights(ir, v8w)
    v8 = pt.Net(ir, params, mode="int8", device=device)
    v8.calibrate(rng.randint(0, 256, (1, cs.V8_SIZE, cs.V8_SIZE, 3),
                             np.uint8))
    return xl, v8


def detect_ms(pt, xl, iters: int = 20) -> dict:
    """ms a ``detect_device`` call (its bucket's replay, CUDA events over
    ``iters`` calls after a warm-up) of xl's int8 default Net and of an
    int8 region Net under the same plan, at batch 1 and ``BATCH``."""
    import torch
    cs = smoke()
    wbytes = pt.synth_weights_bytes(pt.parse_cfg(cs.CFG), seed=cs.SEED,
                                    obj_bias=2.0)
    with cs.environ(cs.REGION_FLAGS):
        region = pt.load(cs.CFG, wbytes, mode="int8", device="cuda")
    region.set_quant_plan(xl.quant)
    frames = np.random.RandomState(cs.SEED).randint(
        0, 256, (cs.BATCH, XL_SIZE, XL_SIZE, 3), np.uint8)
    out = {}
    for tag, net in (("int8_default", xl), ("int8_region", region)):
        for nb in (1, cs.BATCH):
            batch = torch.from_numpy(frames[:nb]).cuda()
            net.warmup(batch_sizes=(nb,))
            out[f"{tag}_b{nb}"] = cs.cuda_ms(
                lambda: net.detect_device(batch), iters=iters, warmup=1)
            print(f"{tag} detect_device batch {nb}: "
                  f"{out[f'{tag}_b{nb}']:.3f} ms", flush=True)
    return out


def stem_rows(pt, ci, dev) -> list:
    """The uint8 mode at xl's stem (320, 322; ``BATCH``) and YOLOv8n's
    (640; ``V8_INT8_TIME``): each checked against its plain version (the
    int32 accumulators and the bf16 output bit for bit), then timed alone
    (``graph_launch_ms``) beside its bound."""
    import torch
    from ffcnn_tpu_torch.bench_block import graph_launch_ms
    cs = smoke()
    gen = torch.Generator().manual_seed(cs.SEED + 20)
    rows = []
    for tag, cfg, size, batch in (("xl", cs.CFG, 320, cs.BATCH),
                                  ("xl", cs.CFG, 322, cs.BATCH),
                                  ("v8n", None, None, cs.V8_INT8_TIME)):
        x, cp = cs.stem_case(pt, ci, cfg, size, gen, dev, batch=batch)
        check_case(ci, x, cp)
        ms = graph_launch_ms(lambda: ci.conv_int8(x, cp))
        bound, by = cs.u8_bound(x, cp)
        rows.append({"label": f"{tag} stem {x.shape[1]}x{x.shape[2]} F "
                              f"{cp.filters} s{cp.stride} act {cp.act}",
                     "batch": batch, "route": route_of(ci, x, cp), "ms": ms,
                     "bound_ms": bound, "bound_by": by})
        print(f"uint8 mode {rows[-1]['label']} batch {batch}: {ms:.4f} ms "
              f"({rows[-1]['route']}), bound {bound:.4f} ({by})", flush=True)
    return rows


def flag_detect_ms(pt, iters: int = 20) -> dict:
    """ms a ``detect_device`` call of xl's region Net with and without
    ``FFCNN_CONV0_INT8=1`` (conv-1 in the uint8 mode, else K6), at batch 1
    and ``BATCH``, in turns (flag, region, region, flag)."""
    import torch
    cs = smoke()
    wbytes = pt.synth_weights_bytes(pt.parse_cfg(cs.CFG), seed=cs.SEED,
                                    obj_bias=2.0)
    flag = cs.load_net(pt, wbytes, cs.C0Q_FLAGS, "cuda")
    region = cs.load_net(pt, wbytes, cs.REGION_FLAGS, "cuda")
    frames = np.random.RandomState(cs.SEED).randint(
        0, 256, (cs.BATCH, XL_SIZE, XL_SIZE, 3), np.uint8)
    out = {}
    for nb in (1, cs.BATCH):
        batch = torch.from_numpy(frames[:nb]).cuda()
        for net in (flag, region):
            net.warmup(batch_sizes=(nb,))
        (a1, a2), (b1, b2) = cs.turns(lambda: flag.detect_device(batch),
                                      lambda: region.detect_device(batch),
                                      iters)
        out[f"flag_b{nb}"], out[f"region_b{nb}"] = [a1, a2], [b1, b2]
        print(f"region detect_device batch {nb}: with FFCNN_CONV0_INT8=1 "
              f"{a1:.3f}, {a2:.3f} ms; without {b1:.3f}, {b2:.3f} ms",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the tree whose ffcnn_tpu_torch to time (default: "
                         "this one)")
    ap.add_argument("--detect", action="store_true",
                    help="also time the int8 Nets' detect_device")
    ap.add_argument("--stems", action="store_true",
                    help="also time the uint8 mode's stems and the region "
                         "Net's detect_device with and without "
                         "FFCNN_CONV0_INT8")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    # run as a file, its own directory (the package's) leads sys.path
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(args.root or TREE))
    import torch
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch import quant
    from ffcnn_tpu_torch.bench_block import graph_launch_ms
    from ffcnn_tpu_torch.kernels import conv_int8 as ci
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv_int8 needs a CUDA card")
    cs = smoke()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    xl, v8 = model_nets(pt, "cuda")
    result = {"device": torch.cuda.get_device_name(0),
              "tree": os.path.dirname(os.path.dirname(
                  os.path.abspath(pt.__file__)))}
    for name, net, batch, distinct in (("xl", xl, cs.BATCH, False),
                                       ("v8n", v8, cs.V8_INT8_TIME, True)):
        rows = []
        for li, geo in quant.conv_shapes(net, distinct):
            x, cp = seeded_case(ci, geo, batch, gen, dev)
            y = check_case(ci, x, cp)
            ms = graph_launch_ms(lambda: ci.conv_int8(x, cp))
            pms = cs.cuda_ms(lambda: ci.conv_int8_plain(x, cp), iters=2,
                             warmup=1)
            bound, by = cs.int8_bound(*cs.int8_work(x, cp, y))
            rows.append({"label": label(li, geo), "dw": geo[7] > 1,
                         "route": route_of(ci, x, cp), "ms": ms,
                         "plain_ms": pms, "bound_ms": bound, "bound_by": by})
            print(f"{name} {rows[-1]['label']} batch {batch}: {ms:.4f} ms "
                  f"({rows[-1]['route']}), plain {pms:.3f}, bound "
                  f"{bound:.4f} ({by})", flush=True)
        result[name] = {"batch": batch, "shapes": len(rows),
                        "ms": sum(r["ms"] for r in rows),
                        "ms_dw": sum(r["ms"] for r in rows if r["dw"]),
                        "ms_dense": sum(r["ms"] for r in rows
                                        if not r["dw"]),
                        "bound_ms": sum(r["bound_ms"] for r in rows),
                        "rows": rows}
        print(f"{name}: {len(rows)} shapes, {result[name]['ms']:.4f} ms "
              f"(depthwise {result[name]['ms_dw']:.4f}, dense "
              f"{result[name]['ms_dense']:.4f}; bound "
              f"{result[name]['bound_ms']:.4f})", flush=True)
    if args.detect:
        result["detect_ms"] = detect_ms(pt, xl)
    if args.stems:
        result["stems"] = stem_rows(pt, ci, dev)
        result["flag_detect_ms"] = flag_detect_ms(pt)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
