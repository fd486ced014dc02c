"""K8 and P3 alone on the card: the two kernels on the tensor-core block body
with rounding points (``csrc/block_round_mma.cuh``) and P3's tap modes, at
the shapes of the block bench and the small-C bisection:

    python -m ffcnn_tpu_torch.bench_round

The same shapes through another tree's copy of the package (an A/B
against a parent commit unpacked beside this one, one process a tree on
the same card, in turns):

    python ffcnn_tpu_torch/bench_round.py --root DIR

Rows:

* K8 (``kernels/mbconv.py``) at ``bench_block``'s seven configs (bf16,
  batch 256, the tool's draws) and at xl's 24 region blocks (bf16, batch
  64), the latter beside K1/K3 on the same blocks;
* P3 (``kernels/block_variants.py``) in each of its seven modes at
  ``bisect_smallc``'s four geometries (bf16, batch 256).

Each is timed alone: 20 launches in one CUDA graph, replayed between CUDA
events (``bench_block.graph_launch_ms``); P3 also as ``bisect_smallc``
times it (a chain of 20 launches between CUDA events).  It checks nothing:
``chip_smoke.py`` phases 7 and 8 hold both kernels against their plain
versions.  The last line is one JSON object: the card, the tree, and the
sums and rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

TREE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P3_BATCH = 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the tree whose ffcnn_tpu_torch to time (default: "
                         "this one)")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    # run as a file, its own directory (the package's) leads sys.path
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.abspath(args.root or TREE))
    import numpy as np
    import torch
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch import bench_block as bb
    from ffcnn_tpu_torch import bisect_smallc as bs
    from ffcnn_tpu_torch.kernels import block_variants as bv
    if not torch.cuda.is_available():
        raise SystemExit("bench_round needs a CUDA card")
    dev = torch.device("cuda")
    log = lambda m: print(m, flush=True)
    result = {"device": torch.cuda.get_device_name(0),
              "tree": os.path.dirname(os.path.dirname(
                  os.path.abspath(pt.__file__)))}
    # K8: the tool's configs, then xl's region blocks beside K1/K3
    for part, cases in (("a", bb.cases_configs(dev)),
                        ("b", bb.cases_xl(dev))):
        rows = []
        for c in cases:
            r = {"name": c.name,
                 "ms": bb.graph_launch_ms(lambda: bb.run_k8(c)),
                 "bound_ms": c.work8().bound()[0]}
            if c.block is not None:
                r["k1k3_ms"] = bb.graph_launch_ms(lambda: bb.run_block(c))
            rows.append(r)
            log(f"K8 {c.name}: alone {r['ms']:.4f} ms (bound "
                f"{r['bound_ms']:.4f})"
                + (f", K1/K3 {r['k1k3_ms']:.4f}" if "k1k3_ms" in r else ""))
        sums = {k: sum(r[k] for r in rows) for k in rows[0]
                if k != "name"}
        result["k8_" + part] = {**sums, "rows": rows}
        log(f"K8 part ({part}), {len(rows)} blocks: alone {sums['ms']:.4f} "
            f"ms (bound {sums['bound_ms']:.4f})"
            + (f", K1/K3 {sums['k1k3_ms']:.4f}" if "k1k3_ms" in sums else ""))
        del cases

    # P3: each mode alone and chained, the bisection's geometries
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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
