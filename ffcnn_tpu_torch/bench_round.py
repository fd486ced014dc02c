"""K8, K9 and P3 alone on the card: the three kernels on the tensor-core
block body with rounding points (``csrc/block_round_mma.cuh``) and P3's
tap modes, at the shapes of the block bench and the small-C bisection, and
P4 and P5 beside their library calls:

    python -m ffcnn_tpu_torch.bench_round [--only p4,p5]

The same shapes through another tree's copy of the package (an A/B
against a parent commit unpacked beside this one, one process a tree on
the same card, in turns):

    python ffcnn_tpu_torch/bench_round.py --root DIR

Rows:

* K8 (``kernels/mbconv.py``) at ``bench_block``'s seven configs (bf16,
  batch 256, the tool's draws) and at xl's 24 region blocks (bf16, batch
  64), the latter beside K1/K3 on the same blocks;
* K9 (``kernels/mbconv_cs.py``) at the five stride-1 configs and xl's 20
  stride-1 region blocks, the latter beside K1;
* P3 (``kernels/block_variants.py``) in each of its seven modes at
  ``bisect_smallc``'s four geometries (bf16, batch 256);
* P4 (``kernels/mosaic_probes.py``) on the sweep's (16, 128) and at
  (65,536, 128), beside ``x[::2].contiguous()``, each launch of the graph
  on buffers of its own (``rotated``; at (65,536, 128) from HBM);
* P5 on the sweep's input, beside ``x.index_select(0, rows)`` (rows: its
  row map, taken from the plain version, so that any tree's package
  serves).

``--only`` takes a comma list of ``k8``, ``k9``, ``p3``, ``p4``, ``p5``
and builds only their sources.

First each source it times is built alone, one ``nvcc`` at a time, and
its seconds reported (about 0 where the tree had it built).  Then each
kernel is timed alone: 20 launches in one CUDA graph, replayed between CUDA
events (``bench_block.graph_launch_ms``); P3 also as ``bisect_smallc``
times it (a chain of 20 launches between CUDA events).  It checks nothing:
``chip_smoke.py`` phases 7 and 8 hold the kernels against their plain
versions.  The last line is one JSON object: the card, the tree, and the
sums and rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

TREE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P3_BATCH = 256
P4_SHAPES = ((16, 128), (65536, 128))
# each row's sources (K8 and K9 are timed beside K1/K3)
ROWS = {"k8": ("mbconv", "block_fused", "block_down"),
        "k9": ("mbconv_cs", "block_fused"), "p3": ("block_variants",),
        "p4": ("mosaic_probes",), "p5": ("mosaic_probes",)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the tree whose ffcnn_tpu_torch to time (default: "
                         "this one)")
    ap.add_argument("--only", default=",".join(ROWS),
                    help="comma list of the rows to time (default all: "
                         f"{','.join(ROWS)})")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if not only or any(k not in ROWS for k in only):
        ap.error(f"--only takes a comma list of {', '.join(ROWS)}")
    here = os.path.dirname(os.path.abspath(__file__))
    # run as a file, its own directory (the package's) leads sys.path
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(args.root or TREE))
    import torch
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch import bench_block as bb
    from ffcnn_tpu_torch import bisect_smallc as bs
    from ffcnn_tpu_torch import retest_backend_bugs as rb
    from ffcnn_tpu_torch.kernels import _build
    from ffcnn_tpu_torch.kernels import block_variants as bv
    from ffcnn_tpu_torch.kernels import mosaic_probes as mp
    if not torch.cuda.is_available():
        raise SystemExit("bench_round needs a CUDA card")
    dev = torch.device("cuda")
    log = lambda m: print(m, flush=True)
    result = {"device": torch.cuda.get_device_name(0),
              "tree": os.path.dirname(os.path.dirname(
                  os.path.abspath(pt.__file__))), "build_s": {}}
    for name in dict.fromkeys(n for k in only for n in ROWS[k]):
        t0 = time.perf_counter()
        _build.build_all([name])
        result["build_s"][name] = time.perf_counter() - t0
    log("built alone, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in result["build_s"].items()))
    # K8: the tool's configs, then xl's region blocks beside K1/K3; K9:
    # their stride-1 blocks, xl's beside K1
    for part, make in (("a", bb.cases_configs), ("b", bb.cases_xl)):
        if "k8" not in only and "k9" not in only:
            break
        cases = make(dev)
        for key, run, work in (("k8", bb.run_k8, "work8"),
                               ("k9", bb.run_k9, "work9")):
            if key not in only:
                continue
            rows = []
            for c in cases:
                if key == "k9" and c.k9 is None:
                    continue
                r = {"name": c.name,
                     "ms": bb.graph_launch_ms(lambda: run(c)),
                     "bound_ms": getattr(c, work)().bound()[0]}
                if c.block is not None:
                    r["k1k3_ms"] = bb.graph_launch_ms(
                        lambda: bb.run_block(c))
                rows.append(r)
                log(f"{key.upper()} {c.name}: alone {r['ms']:.4f} ms (bound "
                    f"{r['bound_ms']:.4f})"
                    + (f", K1/K3 {r['k1k3_ms']:.4f}" if "k1k3_ms" in r
                       else ""))
            sums = {k: sum(r[k] for r in rows) for k in rows[0]
                    if k != "name"}
            result[f"{key}_{part}"] = {**sums, "rows": rows}
            log(f"{key.upper()} part ({part}), {len(rows)} blocks: alone "
                f"{sums['ms']:.4f} ms (bound {sums['bound_ms']:.4f})"
                + (f", K1/K3 {sums['k1k3_ms']:.4f}" if "k1k3_ms" in sums
                   else ""))
        del cases

    if "p3" in only:
        p3_rows(result, bb, bs, bv, dev, log)
    if "p4" in only:
        # P4 on the sweep's shape and one where bytes matter, beside the
        # strided copy; each of the graph's 20 launches on an input and an
        # output of its own (at (65,536, 128) 480 MiB in all, far past the
        # 50 MB L2: each launch from HBM, as the bound assumes)
        gen = torch.Generator().manual_seed(4)
        result["p4"] = {}
        for shape in P4_SHAPES:
            x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
            xs = [x.clone() for _ in range(20)]
            r = result["p4"]["x".join(map(str, shape))] = {
                "ms": bb.graph_launch_ms(rotated(mp.strided_rows, xs)),
                "contiguous_ms": bb.graph_launch_ms(
                    rotated(lambda v: v[::2].contiguous(), xs)),
                "bound_ms": bb.Work(x.numel() // 2 * 4).bound()[0]}
            del xs
            log(f"P4 {shape}: alone {r['ms']:.5f} ms, x[::2].contiguous() "
                f"alone {r['contiguous_ms']:.5f} ms (bound "
                f"{r['bound_ms']:.5f}, {r['bound_ms'] / r['ms']:.1%} of it)")
    if "p5" in only:
        # P5 on the sweep's input, beside index_select on its row map
        probe = next(p for p in rb.PROBES if p.kernel == "P5")
        x = probe.make_input(dev)
        rows = mp.dynslice_carry_plain(torch.arange(
            x.shape[0], dtype=torch.float32, device=dev)[:, None])[:, 0].long()
        result["p5"] = {
            "ms": bb.graph_launch_ms(lambda: probe.run(x)),
            "index_select_ms": bb.graph_launch_ms(
                lambda: x.index_select(0, rows))}
        log(f"P5 {tuple(x.shape)}: alone {result['p5']['ms']:.5f} ms, "
            f"index_select alone {result['p5']['index_select_ms']:.5f} ms")
    print(json.dumps(result))
    return 0


def rotated(fn, xs):
    """A call of ``fn`` on the next of ``xs`` in turn, each output kept
    alive: ``len(xs)`` calls captured in one CUDA graph read and write
    buffers of their own."""
    import itertools
    it, keep = itertools.cycle(xs), []
    return lambda: keep.append(fn(next(it)))


def p3_rows(result, bb, bs, bv, dev, log) -> None:
    """P3: each mode alone and chained, the bisection's geometries."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    p3 = {m: {"alone_ms": 0.0, "chain_ms": 0.0, "bound_ms": 0.0}
          for m in bv.MODES}
    for geom in bs.GEOMS:
        g = bs.make_geom(geom, P3_BATCH, torch.bfloat16, rng, dev)
        out = torch.empty_like(g.x0)
        for mode in bv.MODES:
            alone = bb.graph_launch_ms(
                lambda: bv.block_variant(mode, g.x0, g.vp, out=out))
            chain = bs.chain_ms(lambda: bs.run_chain(g, mode, 20), 20, dev)
            bound = bs.mode_work(mode, g).bound()[0]
            for k, v in (("alone_ms", alone), ("chain_ms", chain),
                         ("bound_ms", bound)):
                p3[mode][k] += v
            p3[mode][geom[0]] = alone
            log(f"P3 {mode:8s} {geom[0]}: alone {alone:.4f} ms, chained "
                f"{chain:.4f} ms (bound {bound:.4f})")
        del g, out
    result["p3"] = p3
    for mode, r in p3.items():
        log(f"P3 {mode:8s} 4 geometries: alone {r['alone_ms']:.4f} ms, "
            f"chained {r['chain_ms']:.4f} ms (bound {r['bound_ms']:.4f})")
    log(f"P3 all modes: alone {sum(r['alone_ms'] for r in p3.values()):.4f}"
        f" ms, chained {sum(r['chain_ms'] for r in p3.values()):.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
