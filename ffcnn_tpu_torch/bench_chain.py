"""A/B of the chained kernels K4 (``csrc/block_cascade.cu``) and K5
(``csrc/block_mega.cu``) built at other compile-time settings, on the card:

    python -m ffcnn_tpu_torch.bench_chain [--variant NAME=FLAG[,FLAG...]]...
        [--rounds 2]

Each variant compiles both sources with its ``-D`` flags (``default``, with
none, is what the package builds) into ``_build/variants/``, all at once.
The inputs are yolo-fastest-xl's at 320x320 (synthesized weights, seed
42): the cascade configuration's seven K4 groups and the mega run 84-108.
Each variant is first held against ``chain_plain`` in float32, then timed
with CUDA events in bf16, the variants in turns (A B ... then back), round
after round: every K4 group at the wrapper's tile, their sum, and K5 at
one CTA an image and at a cluster of two, batch 64 and 256.  The
compile-time setting the kernels have is ``FFCNN_CHAIN_THREADS``, the
threads of a CTA (512 for K4, 384 for K5).  The first line is the card's
name and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from typing import Dict, List

import torch

from . import darknet
from .darknet.weights import load_weights, synth_weights_bytes
from .graph.build import params_from_numpy
from .kernels import _build
from .kernels import block_fused as bf

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "models", "yolo-fastest-xl.cfg")


def chains(device):
    """[(name, input blob, [BlockParams])]: xl's seven K4 groups of the
    cascade configuration and its mega run 84-108, at 320x320."""
    ir = darknet.parse_cfg(CFG, 320, 320)
    params = params_from_numpy(load_weights(ir, synth_weights_bytes(
        ir, seed=42, obj_bias=2.0))[0], device)
    out = []
    for r in bf.plan_runs(ir, 8, True):
        for g in bf.cascade_groups(r, 3):
            if len(g) > 1:
                out.append((f"K4 {[b.start for b in g]}", ir.blobs[g[0].start],
                            [bf.block_params(ir, params, b) for b in g]))
    run = [r for r in bf.plan_runs(ir, 24, False) if r.start == 84][0]
    out.append(("K5 84-108", ir.blobs[84],
                [bf.block_params(ir, params, b) for b in run.blocks]))
    return out


def build_variants(variants: Dict[str, List[str]]):
    """{variant: (cascade library, mega library)}, compiled in parallel."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for v, flags in variants.items():
        for name in ("block_cascade", "block_mega"):
            so = out_dir / f"{name}-{v}.so"
            cmd = [_build.nvcc_path(), *_build._ARCH, *_build._BASE_FLAGS,
                   *(f"-D{f}" for f in flags), "-o", str(so),
                   str(_build.CSRC / f"{name}.cu")]
            jobs.append((v, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs: Dict[str, list] = {v: [] for v in variants}
    for v, so, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        libs[v].append(ctypes.CDLL(str(so)))
    for cascade, mega in libs.values():
        for lib, entry, argtypes in (
                (cascade, "ffcnn_cascade", bf.CASCADE_ARGTYPES),
                (mega, "ffcnn_mega", bf.MEGA_ARGTYPES)):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, bf._INT
            err = getattr(lib, entry + "_error_string")
            err.argtypes, err.restype = [bf._INT], ctypes.c_char_p
    return libs


def use(libs) -> None:
    """Point the wrappers' launches at a variant's libraries."""
    bf.build_cascade = lambda: libs[0]
    bf.build_mega = lambda: libs[1]


def ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAG[,FLAG...], -D flags (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    variants = {"default": []}
    for spec in args.variant:
        name, _, flags = spec.partition("=")
        variants[name] = [f for f in flags.split(",") if f]
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(variants)
    cs = chains(dev)
    gen = torch.Generator().manual_seed(0)
    xs = {(name, n): torch.randn((n, blob.h, blob.w, blob.c),
                                 generator=gen).to(dev, torch.bfloat16)
          for name, blob, _ in cs for n in (64, 256)}

    for v, vl in libs.items():
        use(vl)
        worst = 0.0
        for name, blob, bps in cs:
            x = xs[(name, 64)].float()
            want = bf.chain_plain(x, bps)
            if name.startswith("K4"):
                got = [bf.launch_cascade(x, bps, x.dtype,
                                         bf.check_chain_fits(blob.h, blob.w,
                                                             bps))]
            else:
                got = [bf.launch_mega(x, bps, cl) for cl in (1, 2)]
            scale = want.abs().max().item()
            for g in got:
                err = (g - want).abs().max().item() / scale
                worst = max(worst, err)
                if not (err <= 2e-5 and bool(torch.isfinite(g).all())):
                    raise AssertionError(f"{v} {name}: {err:.2e} of the "
                                         f"range")
        print(f"{v} {variants[v]}: agrees with chain_plain in float32, "
              f"max {worst:.2e} of the range", flush=True)

    order = list(libs)
    for rnd in range(args.rounds):
        for v in order if rnd % 2 == 0 else order[::-1]:
            use(libs[v])
            total = 0.0
            for name, blob, bps in cs:
                if name.startswith("K4"):
                    x = xs[(name, 64)]
                    t = bf.check_chain_fits(blob.h, blob.w, bps)
                    t_ms = ms(lambda: bf.launch_cascade(x, bps, x.dtype, t))
                    total += t_ms
                    print(f"round {rnd} {v} {name} batch 64: tile {t} "
                          f"{t_ms:.4f} ms", flush=True)
                    continue
                for n in (64, 256):
                    x = xs[(name, n)]
                    print(f"round {rnd} {v} {name} batch {n}: " + ", ".join(
                        f"cluster {cl} {ms(lambda: bf.launch_mega(x, bps, cl)):.4f} ms"
                        for cl in (1, 2)), flush=True)
            print(f"round {rnd} {v} K4 the 7 groups, batch 64: {total:.4f} "
                  f"ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
