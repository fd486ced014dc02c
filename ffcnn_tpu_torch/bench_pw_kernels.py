"""Micro-bench of 1x1-conv formulations at tiny channel counts, the port of
``tools/bench_pw_kernels.py``.  On the card (the default):

    python -m ffcnn_tpu_torch.bench_pw_kernels

and on the CPU, at a size the CPU can take (plain versions, host clock):

    python -m ffcnn_tpu_torch.bench_pw_kernels --device cpu --batch 2 --hw 16

The tool's constants (batch 256, 80x80, Cin 8, Cout 32, S = batch*80*80
rows, 16 samples packed into K = 128) and its inputs, drawn from
``np.random.RandomState(0)`` in its order.  Rows, as the tool names them:

  A  the 1x1 conv through ``ops/conv.py::conv2d_fused`` (cuDNN, channels
     last; its epilogue casts back to bf16)
  D  one ``torch.mm`` call on the 2-D shapes, the library yardstick: with
     ``out_dtype=torch.float32`` on bf16 operands where the installed
     PyTorch has that overload on the card, else on float32 copies made
     outside the timing (TF32 off); the line says which
  B  P1: ``kernels/pw_matmul.py`` on (S, Cin) @ (Cin, Cout)
  C  P2: the same kernel on the K-packed rows, (S/16, 128) @ (128, 512),
     against the block-diagonal weight (dense: 16x P1's multiply-adds)

B and C also print their plain versions' times, the time of the ``torch.mm``
call on their own shapes (for B, row D) and their ratio to it, their bounds
(the least time an H100 could take for the same work, ``bench_block.Work``)
and their share of it (bound / time), and, on the card, the kernel alone:
its device time from ``torch.profiler`` over 30 calls.  Last comes ``C
maxdiff vs D``, as in the tool.  Times are CUDA events
(``bench_block.timer``) over 30 calls, as the tool takes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .bench_block import Work, kernel_alone_ms, timer
from .darknet.ir import Activation
from .kernels import pw_matmul as pw
from .ops.conv import conv2d_fused

N, H, W, CIN, COUT = 256, 80, 80, 8, 32
PACK = 128 // CIN
ITERS = 30


@dataclasses.dataclass
class Inputs:
    x4: torch.Tensor      # (N, H, W, Cin) bf16
    x2: torch.Tensor      # (S, Cin), a view of x4
    w: torch.Tensor       # (Cin, Cout) bf16
    xp: torch.Tensor      # (S/16, 128), a view of x4
    wb: torch.Tensor      # (128, 512) bf16, block-diagonal


def make_inputs(device, batch: int = N, hw: int = H) -> Inputs:
    """The tool's inputs at ``batch`` x ``hw`` x ``hw``."""
    rng = np.random.RandomState(0)
    bf16 = torch.bfloat16
    x4 = torch.from_numpy(rng.randn(batch, hw, hw, CIN).astype(np.float32)
                          ).to(device=device, dtype=bf16)
    w = torch.from_numpy(rng.randn(CIN, COUT).astype(np.float32) * 0.2
                         ).to(device=device, dtype=bf16)
    s = batch * hw * hw
    if s % PACK:
        raise ValueError(f"{s} rows do not pack by {PACK}")
    wn = w.float().cpu().numpy()
    wblk = np.zeros((PACK * CIN, PACK * COUT), np.float32)
    for p in range(PACK):
        wblk[p * CIN:(p + 1) * CIN, p * COUT:(p + 1) * COUT] = wn
    return Inputs(x4, x4.reshape(s, CIN), w,
                  x4.reshape(s // PACK, PACK * CIN),
                  torch.from_numpy(wblk).to(device=device, dtype=bf16))


def library_mm(x: torch.Tensor, w: torch.Tensor) -> Tuple[Callable, str]:
    """One ``torch.mm`` call that computes ``x @ w`` with float32 sums into
    float32, and how it does."""
    if x.device.type == "cuda" and "dtype" in torch.ops.aten.mm.overloads():
        return (lambda: torch.mm(x, w, out_dtype=torch.float32),
                "torch.mm(bf16, bf16, out_dtype=float32)")
    xf, wf = x.float(), w.float()
    return (lambda: torch.mm(xf, wf),
            "torch.mm on float32 copies made outside the timing")


def work(x: torch.Tensor, w: torch.Tensor) -> Work:
    """x (M, K) @ w (K, N), bf16 in and float32 out: each byte once, the
    multiply-adds at the bf16 tensor-core rate."""
    (m, k), n = x.shape, w.shape[1]
    return Work(2 * (m * k + k * n) + 4 * m * n, tc_flop=2 * m * k * n)


def run(device, batch: int = N, hw: int = H, log=print) -> dict:
    """Time rows A, D, B and C (B and C with their plain versions and, on
    the card, the kernel alone) and return the times (ms), bounds and ``C
    maxdiff vs D``."""
    inp = make_inputs(device, batch, hw)
    s = inp.x2.shape[0]
    mm, how = library_mm(inp.x2, inp.w)
    w_oihw = inp.w.t().reshape(COUT, CIN, 1, 1).contiguous()
    ones = torch.ones(COUT, device=device)
    zeros = torch.zeros(COUT, device=device)
    r = dict(library=how)
    r["A"] = timer(lambda: conv2d_fused(
        inp.x4, w_oihw, ones, zeros, stride=1, pad=0, groups=1,
        act=int(Activation.LINEAR)), device, ITERS)
    log(f"A conv 1x1       {r['A']:8.4f} ms (ops/conv.py)")
    r["D"] = timer(mm, device, ITERS)
    log(f"D torch.mm 2d    {r['D']:8.4f} ms ({how})")
    r["B_library"] = r["D"]
    r["C_library"] = timer(library_mm(inp.xp, inp.wb)[0], device, ITERS)
    for tag, x, w in (("B", inp.x2, inp.w), ("C", inp.xp, inp.wb)):
        r[tag] = timer(lambda: pw.pw_matmul(x, w), device, ITERS)
        r[tag + "_plain"] = timer(lambda: pw.pw_matmul_plain(x, w), device,
                                  ITERS // 3)
        r[tag + "_work"] = work(x, w)
        r[tag + "_bound"] = r[tag + "_work"].bound()
        bound, by = r[tag + "_bound"]
        log(f"{tag} {'2d' if tag == 'B' else 'packed':12s} {r[tag]:8.4f} ms"
            f" (plain {r[tag + '_plain']:8.4f} ms); torch.mm on its shapes "
            f"{r[tag + '_library']:8.4f} ms ({how}), kernel / torch.mm "
            f"{r[tag] / r[tag + '_library']:.3f}")
        if device.type != "cuda":
            log(f"  bound {bound:.4f} ms by {by} (an H100's; no share of it "
                f"on the CPU, and no kernel alone)")
            continue
        r[tag + "_alone"] = kernel_alone_ms(lambda: pw.pw_matmul(x, w),
                                            "pw_stream", ITERS)
        log(f"  bound {bound:.4f} ms by {by}: {bound / r[tag]:.1%} of it; "
            f"kernel alone {r[tag + '_alone']:8.4f} ms by torch.profiler, "
            f"{bound / r[tag + '_alone']:.1%} of it")
    rc = pw.pw_matmul(inp.xp, inp.wb).reshape(s, COUT)
    r["c_vs_d"] = (rc - mm()).abs().max().item()
    log(f"C maxdiff vs D: {r['c_vs_d']:.5f}")
    return r


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--batch", type=int, default=N)
    ap.add_argument("--hw", type=int, default=H, help="H and W (80)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (host clock; plain versions)")
    print(f"bench_pw_kernels on {where}: batch {args.batch}, "
          f"{args.hw}x{args.hw}, Cin {CIN}, Cout {COUT}")
    if device.type == "cuda":
        print("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    return run(device, args.batch, args.hw)


if __name__ == "__main__":
    main()
