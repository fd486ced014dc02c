"""Bisect the fused block's time at small C: the block's variants, each
peeling off one component, timed beside the cuDNN chain and the layout
round trip.  The port of ``tools/bisect_smallc.py``.  On the card (the
default):

    python -m ffcnn_tpu_torch.bisect_smallc [--batch 256] [--iters 20]

and on the CPU, at a size the CPU can take (plain versions, host clock):

    python -m ffcnn_tpu_torch.bisect_smallc --device cpu --batch 1 --iters 1

Rows, for each of the tool's four geometries (``GEOMS``; inputs from
``np.random.RandomState(0)`` in the tool's order):

  copy .. fullbf16  the seven variants of ``kernels/block_variants.py`` (P3)
                    in NHWC: copy streams the tile, dwonly/dwmixed/dwbf16
                    the taps alone, pwonly the two products alone, full the
                    whole block (K1's body), fullbf16 it with bf16 operands
  xla               the same block as three ``ops/conv.py::conv2d_fused``
                    calls (cuDNN) plus the residual, as the tool builds it
  tpose             NHWC -> (H, C, W*N) -> NHWC alone: the two copies the
                    P3 step makes around the kernel (the tool adds 1 in
                    between so that XLA cannot cancel them; eager PyTorch
                    runs both as written, so nothing is added here)

Each row is chained ``--iters`` times with a data dependency (a step's
output is the next one's input; the kernel writes two buffers in turn)
inside one pair of CUDA events, and printed per block: microseconds, GB/s
over the dense bytes and over the tool's tile-padded bytes (C padded to 16
rows in bf16, 8 in float32: the TPU's tiling), and the least time an H100
could take for the same work (``bench_block.Work.bound``).  The tool
computes its bandwidth as MB/1e3/ms, which is TB/s; here it is GB/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .bench_block import Work, block_work, timer
from .darknet.ir import Activation
from .kernels import block_variants as bv
from .ops.conv import conv2d_fused

LEAKY, LINEAR = int(Activation.LEAKY), int(Activation.LINEAR)

# (label, H, W, C, E): tools/bisect_smallc.py's geometries.
GEOMS = [
    ("160x160/C8/E32", 160, 160, 8, 32),
    ("80x80/C8/E48", 80, 80, 8, 48),
    ("40x40/C16/E96", 40, 40, 16, 96),
    ("20x20/C24/E136", 20, 20, 24, 136),
]
MODES = bv.MODES
STORES = {"bf16": torch.bfloat16, "f32": torch.float32}


@dataclasses.dataclass
class Geom:
    """One geometry's inputs: x0 (N, H, W, C) for the variants (the tool
    draws it on its (H, C, W*N) layout), the tool's nine params, their
    kernel layout, xh0 (N, H, W, C) for the chain and the round trip, and
    the chain's three convs (OIHW weight, scale, bias, act, pad, groups)."""
    label: str
    x0: torch.Tensor
    params9: tuple
    vp: bv.VariantParams
    xh0: torch.Tensor
    convs: tuple

    @property
    def shape(self):
        """(n, h, w, c, e)"""
        return (*self.x0.shape, self.vp.w1.shape[1])


def make_geom(geom, n: int, dtype: torch.dtype, rng: np.random.RandomState,
              device) -> Geom:
    """The tool's draws for one geometry at batch ``n``: x0, the nine
    params, then xh0."""
    label, hh, width, c, e = geom

    def t(a, dt=torch.float32):
        return torch.from_numpy(a).to(device=device, dtype=dt)
    x0 = t(rng.randn(hh, c, width * n).astype(np.float32) * 0.25, dtype)
    mk = lambda *sh: t(rng.randn(*sh).astype(np.float32) * 0.2)
    col = lambda m: t(rng.rand(m, 1).astype(np.float32) * 0.5 + 0.5)
    params9 = (mk(e, c), col(e), col(e), mk(3, 3, e), col(e), col(e),
               mk(c, e), col(c), col(c))
    xh0 = t(rng.randn(n, hh, width, c).astype(np.float32) * 0.25, dtype)
    w1, s1, b1, kdw, s2, b2, w2, s3, b3 = params9
    sq = lambda v: v.reshape(-1)
    convs = ((w1.reshape(e, c, 1, 1), sq(s1), sq(b1), LEAKY, 0, 1),
             (kdw.permute(2, 0, 1).reshape(e, 1, 3, 3).contiguous(), sq(s2),
              sq(b2), LEAKY, 1, e),
             (w2.reshape(c, e, 1, 1), sq(s3), sq(b3), LINEAR, 0, 1))
    return Geom(label, bv.cs_to_nhwc(x0, n), params9,
                bv.variant_params(params9), xh0, convs)


def mode_work(mode: str, g: Geom) -> Work:
    """What a variant must do: the block's input and output once, float32
    params, the taps' FLOP on the CUDA cores and the pointwise products'
    at the bf16 tensor-core rate (``bench_block.Work``)."""
    n, h, w, c, e = g.shape
    isz, pix = g.x0.element_size(), n * h * w
    io = 2 * isz * pix * c
    if mode == "copy":
        return Work(io)
    if mode in bv.TAP_MODES:
        return Work(io + 4 * 9 * c, f32_flop=2 * 9 * pix * c)
    if mode == "pwonly":
        return Work(io + 4 * (2 * c * e + 2 * e + 2 * c),
                    tc_flop=2 * pix * 2 * c * e)
    return block_work(n, h, w, c, e, c, 1, False, isz)


def xla_block(g: Geom, x: torch.Tensor) -> torch.Tensor:
    """The block as the tool's XLA baseline: three convs, then ``+ x`` in
    x's dtype."""
    y = x
    for w, s, b, act, pad, groups in g.convs:
        y = conv2d_fused(y, w, s, b, stride=1, pad=pad, groups=groups,
                         act=act)
    return y + x


def tpose(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> (H, C, W*N) -> NHWC."""
    return bv.cs_to_nhwc(bv.nhwc_to_cs(x), x.shape[0])


def run_chain(g: Geom, mode: str, iters: int) -> torch.Tensor:
    """``iters`` chained launches of one variant from x0: each step's
    output is the next one's input, in two buffers written in turn (x0 is
    only read)."""
    bufs = (torch.empty_like(g.x0), torch.empty_like(g.x0))
    x = g.x0
    for i in range(iters):
        x = bv.block_variant(mode, x, g.vp, out=bufs[i % 2])
    return x


def chain_ms(fn: Callable[[], torch.Tensor], iters: int, device) -> float:
    """Milliseconds per step of a chain of ``iters`` steps (``fn`` runs the
    whole chain): one warm-up chain, then one timed by a pair of CUDA events
    (the host clock on the CPU)."""
    return timer(fn, device, iters=1, warmup=1) / iters


def run_geom(g: Geom, modes: Sequence[str], iters: int, device,
             store: str, log=print) -> dict:
    """Time every mode, the chain and the round trip on one geometry;
    print one line each and return the row (microseconds per block)."""
    n, h, w, c, e = g.shape
    bpe = g.x0.element_size()
    tile = 16 if bpe == 2 else 8
    dense_mb = 2 * n * h * w * c * bpe / 1e6
    tiled_mb = 2 * n * h * w * (-(-c // tile) * tile) * bpe / 1e6
    row = {"geom": g.label, "batch": n, "store": store,
           "dense_MB": dense_mb, "tiled_MB": tiled_mb}
    log(f"--- {g.label} batch {n} store {store} (stream {dense_mb:.0f} MB "
        f"dense / {tiled_mb:.0f} MB tiled)")

    def line(name, ms, work, unit="block"):
        bound, by = work.bound()
        row[name], row[name + "_bound"] = ms * 1e3, bound * 1e3
        log(f"  {name:8s} {ms * 1e3:9.1f} us/{unit} ({dense_mb / ms:6.0f} "
            f"GB/s dense, {tiled_mb / ms:6.0f} GB/s tiled; bound "
            f"{bound * 1e3:.1f} us by {by})")

    for mode in modes:
        line(mode, chain_ms(lambda: run_chain(g, mode, iters), iters,
                            device), mode_work(mode, g))

    def chained(f):
        def fn():
            x = g.xh0
            for _ in range(iters):
                x = f(x)
            return x
        return fn
    line("xla", chain_ms(chained(lambda x: xla_block(g, x)), iters, device),
         mode_work("full", g))
    line("tpose", chain_ms(chained(tpose), iters, device),
         mode_work("copy", g), "round-trip")
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20,
                    help="chain length inside one pair of CUDA events")
    ap.add_argument("--store", choices=tuple(STORES), default="bf16")
    ap.add_argument("--geoms", nargs="*", default=None)
    ap.add_argument("--modes", nargs="*", default=None,
                    help=f"subset of {' '.join(MODES)} (default: all)")
    ap.add_argument("-o", "--out", default=None,
                    help="append one JSON line a geometry to this file")
    args = ap.parse_args(argv)
    modes = args.modes or MODES
    if set(modes) - set(MODES):
        ap.error(f"unknown modes {sorted(set(modes) - set(MODES))}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (host clock; plain versions)")
    print(f"bisect_smallc on {where}")
    rng = np.random.RandomState(0)
    rows = []
    for geom in GEOMS:
        if args.geoms and geom[0] not in args.geoms:
            continue
        g = make_geom(geom, args.batch, STORES[args.store], rng, device)
        rows.append(run_geom(g, modes, args.iters, device, args.store))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rows[-1]) + "\n")
    return rows


if __name__ == "__main__":
    main()
