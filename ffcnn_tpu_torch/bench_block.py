"""A/B of the fused block kernels K8 and K9 against the three-conv chain, the
port of ``tools/bench_block.py``.  On the card (the default):

    python -m ffcnn_tpu_torch.bench_block

and on the CPU, at a size the CPU can take (plain versions, host clock):

    python -m ffcnn_tpu_torch.bench_block --device cpu --batch 2 \\
        --shrink 5 --xl-size 64 --xl-batch 2

Two parts, each a list of cases (one block each):

(a) the tool's seven ``CONFIGS`` at batch 256 in bfloat16, with inputs made
    from ``np.random.RandomState(0)`` in the tool's order.  Each case runs
    the chain of three ``ops/conv.py::conv2d_fused`` calls with bf16 weights
    (cuDNN on the card; the tool's ``xla_seq``, the yardstick), K8
    (``kernels/mbconv.py``) and, at stride 1, K9 (``kernels/mbconv_cs.py``,
    on the (C, N*H*W) layout, converted before and after, outside the
    timing).
(b) every block of the region plan of yolo-fastest-xl (``plan_runs`` with
    ``min_channels=8, allow_down=True``) at 320x320, batch 64: 20 stride-1
    blocks for K8 and K9, 4 stride-2 blocks for K8, with the weights folded
    from ``synth_weights_bytes(seed=42, obj_bias=2.0)``; a residual block
    passes its input as ``res``.  K8 runs beside K1/K3 on the same block;
    their rounding points differ, so their difference is reported, not
    gated.

For each case it prints the times (ms, CUDA events on the card), each
kernel's bound (the least time an H100 could take for the same work,
``Work.bound``), and max |diff| of each kernel against its plain version
and against the chain (and, in part (b), K8 against K1/K3).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .darknet.cfg import parse_cfg
from .darknet.ir import Activation
from .darknet.weights import load_weights, synth_weights_bytes
from .graph.build import params_from_numpy
from .kernels import block_fused as bf
from .kernels import mbconv as k8
from .kernels import mbconv_cs as k9
from .ops.conv import conv2d_fused
from .roofline import F32_FLOP_S, HBM_BYTES_S, TC_BF16_FLOP_S
from .runtime import capturing

XL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "models", "yolo-fastest-xl.cfg")
CONFIGS = [
    # (N, H, W, Cin, Cmid, Cout, stride, residual): tools/bench_block.py
    (256, 160, 160, 8, 8, 4, 1, True),
    (256, 80, 80, 8, 32, 8, 1, True),
    (256, 40, 40, 16, 96, 16, 1, True),
    (256, 20, 20, 24, 136, 24, 1, True),
    (256, 10, 10, 48, 224, 48, 1, True),
    (256, 160, 160, 8, 24, 8, 2, False),
    (256, 40, 40, 16, 96, 24, 2, False),
]
LEAKY, LINEAR = int(Activation.LEAKY), int(Activation.LINEAR)


@dataclasses.dataclass(frozen=True)
class Work:
    """What a function must do on the card: the bytes it must move (each
    input, residual and output byte once, plus the weights), its pointwise
    multiply-adds (FLOP, fit for the bf16 tensor cores) and its other
    float32 FLOP (depthwise taps, on the CUDA cores)."""
    bytes: float = 0.0
    tc_flop: float = 0.0
    f32_flop: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.bytes + o.bytes, self.tc_flop + o.tc_flop,
                    self.f32_flop + o.f32_flop)

    def bound(self):
        """(ms, "bytes" or "operations"): the larger of the bytes over the
        memory rate and the operations over their peak (tensor cores and
        CUDA cores run side by side, so the slower of the two)."""
        t_bytes = self.bytes / HBM_BYTES_S
        t_ops = max(self.tc_flop / TC_BF16_FLOP_S,
                    self.f32_flop / F32_FLOP_S)
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


def block_work(n: int, h: int, w: int, c: int, e: int, p: int,
               stride: int = 1, extra_res: bool = False, itemsize: int = 2,
               weight_bytes: Optional[int] = None) -> Work:
    """An inverted-residual block on an (n, h, w, c) input: expand over the
    input map, depthwise and project over the (h/stride, w/stride) output
    map.  ``extra_res``: a residual read as a tensor of its own (K8, K9).
    ``weight_bytes``: default float32 weights, scales and biases."""
    oh, ow = h // stride, w // stride
    out = n * oh * ow * p
    if weight_bytes is None:
        weight_bytes = 4 * (c * e + 9 * e + e * p + 4 * e + 2 * p)
    return Work(itemsize * (n * h * w * c + out * (2 if extra_res else 1))
                + weight_bytes,
                2 * n * (h * w * c * e + oh * ow * e * p),
                2 * 9 * n * oh * ow * e)


@dataclasses.dataclass
class Case:
    """One block of the bench: its input, K8's and K9's arguments, the
    three-conv chain's weights, and (part (b)) K1/K3's params."""
    name: str
    part: str
    x: torch.Tensor                   # (N, H, W, Cin)
    k8: tuple                         # fused_mbconv's weight arguments
    res: Optional[torch.Tensor]       # (N, H', W', Cout) or None
    stride: int
    act_mid: bool
    act_out: bool
    chain: tuple                      # three (OIHW weight, scale, bias, act)
    block: Optional[bf.BlockParams] = None
    x_cs: Optional[torch.Tensor] = None
    res_cs: Optional[torch.Tensor] = None
    k9: Optional[tuple] = None        # fused_mbconv_cs's weight arguments

    @property
    def residual(self) -> bool:
        return self.res is not None

    def work8(self) -> Work:
        n, h, w, c = self.x.shape
        e, p = self.k8[0].shape[1], self.k8[6].shape[1]
        return block_work(n, h, w, c, e, p, self.stride, self.residual,
                          self.x.element_size())

    def work9(self) -> Work:
        n, h, w, c = self.x.shape
        e, p = self.k8[0].shape[1], self.k8[6].shape[1]
        isz = self.x.element_size()
        return block_work(n, h, w, c, e, p, 1, self.residual, isz,
                          isz * (c * e + e * p) + 4 * (9 * e + 4 * e + 2 * p))


def _case(name, part, x, w1, s1, b1, wd, sd, bd, w2, s2, b2, res, stride,
          acts, block=None) -> Case:
    """A case from K8's float32 weights (w1 (C, E), wd (3, 3, E), w2 (E, P))
    and the cfg's three activation ids."""
    e, p = w1.shape[1], w2.shape[1]
    chain = ((w1.t().reshape(e, -1, 1, 1), s1, b1, acts[0]),
             (wd.permute(2, 0, 1).reshape(e, 1, 3, 3), sd, bd, acts[1]),
             (w2.t().reshape(p, e, 1, 1), s2, b2, acts[2]))
    case = Case(name, part, x, (w1, s1, b1, wd, sd, bd, w2, s2, b2), res,
                stride, acts[0] == LEAKY, acts[2] == LEAKY,
                tuple(tuple(t.contiguous() if torch.is_tensor(t) else t
                            for t in st) for st in chain), block)
    if stride == 1:
        case.x_cs = k9.nhwc_to_cs(x)
        case.res_cs = None if res is None else k9.nhwc_to_cs(res)
        code = {LEAKY: k9.LEAKY, LINEAR: k9.LINEAR}
        case.k9 = ((w1.t().to(x.dtype).contiguous(), s1, b1, wd, sd, bd,
                    w2.t().to(x.dtype).contiguous(), s2, b2),
                   dict(H=x.shape[1], W=x.shape[2], act_mid=code[acts[0]],
                        act_dw=code[acts[1]], act_out=code[acts[2]]))
    return case


def cases_configs(device, batch: int = 256, shrink: int = 1) -> List[Case]:
    """Part (a): the tool's CONFIGS (N = ``batch``, H and W divided by
    ``shrink``), inputs from RandomState(0) in the tool's order, bf16."""
    rng = np.random.RandomState(0)
    bf16 = torch.bfloat16
    out = []
    for _, h, w, cin, cmid, cout, stride, residual in CONFIGS:
        n, h, w = batch, h // shrink, w // shrink

        def t(a, dtype=torch.float32):
            return torch.from_numpy(a).to(device=device, dtype=dtype)
        x = t(rng.randn(n, h, w, cin).astype(np.float32) * 0.5, bf16)
        w1 = t(rng.randn(cin, cmid).astype(np.float32) * 0.2)
        wd = t(rng.randn(3, 3, cmid).astype(np.float32) * 0.2)
        w2 = t(rng.randn(cmid, cout).astype(np.float32) * 0.2)
        s1, b1, sd, bd, s2, b2 = (t(rng.rand(c).astype(np.float32) + 0.5)
                                  for c in (cmid, cmid, cmid, cmid, cout,
                                            cout))
        oh, ow = h // stride, w // stride
        res = t(rng.randn(n, oh, ow, cout).astype(np.float32) * 0.5,
                bf16) if residual else None
        out.append(_case(f"{h}x{w} {cin}->{cmid}->{cout} s{stride}", "a", x,
                         w1, s1, b1, wd, sd, bd, w2, s2, b2, res, stride,
                         (LEAKY, LEAKY, LINEAR)))
    return out


def cases_xl(device, size: int = 320, batch: int = 64,
             seed: int = 42) -> List[Case]:
    """Part (b): every block of xl's region plan at ``size``, batch
    ``batch``, bf16 inputs from RandomState(``seed``); synthesized weights
    (seed 42, obj_bias 2.0), folded."""
    ir = parse_cfg(XL, size, size)
    params = params_from_numpy(load_weights(ir, synth_weights_bytes(
        ir, seed=42, obj_bias=2.0))[0], device)
    rng = np.random.RandomState(seed)
    out = []
    for run in bf.plan_runs(ir, min_channels=8, allow_down=True):
        for b in run.blocks:
            bp = bf.block_params(ir, params, b)
            if ({bp.acts[0], bp.acts[2]} - {LEAKY, LINEAR}
                    or bp.acts[1] != LEAKY or bp.res_act != LINEAR):
                raise ValueError(f"block {b.start}: K8 takes leaky or linear "
                                 f"pointwise convs, a leaky depthwise and "
                                 f"a linear residual, got {bp.acts}, "
                                 f"{bp.res_act}")
            blob = ir.blobs[b.start]
            x = torch.from_numpy(rng.randn(batch, *blob.nhwc).astype(
                np.float32) * 0.5).to(device=device, dtype=torch.bfloat16)
            e = bp.w1.shape[1]
            wd = bp.kdw.t().reshape(3, 3, e).contiguous()
            out.append(_case(
                f"xl {b.start} {blob.h}x{blob.w} {blob.c}->{e}->"
                f"{bp.w2.shape[1]} s{2 if b.down else 1}", "b", x, bp.w1,
                bp.s1, bp.b1, wd, bp.s2, bp.b2, bp.w2, bp.s3, bp.b3,
                x if b.residual else None, 2 if b.down else 1, bp.acts, bp))
    return out


def run_k8(c: Case) -> torch.Tensor:
    return k8.fused_mbconv(c.x, *c.k8, c.res, stride=c.stride,
                           residual=c.residual, act_mid=c.act_mid,
                           act_out=c.act_out)


def run_k9(c: Case) -> torch.Tensor:
    weights, kw = c.k9
    return k9.fused_mbconv_cs(c.x_cs, *weights, c.res_cs, **kw)


def plain_k8(c: Case) -> torch.Tensor:
    return k8.fused_mbconv_plain(c.x, *c.k8, c.res, stride=c.stride,
                                 residual=c.residual, act_mid=c.act_mid,
                                 act_out=c.act_out)


def plain_k9(c: Case) -> torch.Tensor:
    weights, kw = c.k9
    return k9.fused_mbconv_cs_plain(c.x_cs, *weights, c.res_cs, **kw)


def run_chain(c: Case) -> torch.Tensor:
    """The three-conv chain (the tool's ``xla_seq``): bf16 weights, each
    conv's output in x's dtype, then ``+ res`` in x's dtype."""
    y = c.x
    for (w, s, b, act), stride, pad, groups in zip(
            c.chain, (1, c.stride, 1), (0, 1, 0),
            (1, c.chain[1][0].shape[0], 1)):
        y = conv2d_fused(y, w, s, b, stride=stride, pad=pad, groups=groups,
                         act=act)
    return y + c.res if c.residual else y


def run_block(c: Case) -> torch.Tensor:
    return (bf.fused_down_block if c.stride == 2 else bf.fused_block)(
        c.x, c.block)


def drive(cases: Sequence[Case]):
    """The bench's kernel pass: each case's K8 output and, at stride 1, its
    K9 output back in NHWC; one launch of each kernel per case."""
    outs = []
    for c in cases:
        y9 = None
        if c.k9 is not None:
            n, h, w, _ = c.x.shape
            y9 = k9.cs_to_nhwc(run_k9(c), n, h, w)
        outs.append((run_k8(c), y9))
    return outs


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def timer(fn: Callable, device, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call: CUDA events on the card, the host clock
    on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_launch_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device ms a launch of ``fn``'s one kernel: ``iters`` calls captured
    in one CUDA graph (after three warm-up calls on a side stream), the
    graph replayed ``reps`` times between CUDA events, so no host time
    falls between the launches.  Late in a run torch.profiler recorded no
    device event for some windows of these short launches (a bare trace
    of 5; one range of 29 in one trace, three traces in a row), so these
    times do not come from it; ``kernel_alone_ms`` falls back on it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capturing(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def kernel_alone_ms(fn: Callable, name: str, iters: int,
                    attempts: int = 3) -> float:
    """Device time per call of the kernels whose name holds ``name`` (at
    least one launch a call), by ``torch.profiler`` over ``iters`` calls of
    ``fn`` on the card, after a warm-up step of as many whose events the
    profiler drops.  Late in a long run the profiler recorded none or few
    of the device events of some short traces: a trace that records fewer
    launches than calls is taken again, up to ``attempts`` traces; where
    none records them all, it warns and times ``iters`` launches in a CUDA
    graph instead (``graph_launch_ms``: device time too, no host time
    between the launches)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        rows = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: rows.extend(p.key_averages())
                     ) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        hits = [e for e in rows if name in e.key]
        us = sum(getattr(e, "device_time_total", 0) or
                 getattr(e, "cuda_time_total", 0) for e in hits)
        if us > 0 and sum(e.count for e in hits) >= iters:
            return us / iters / 1e3
    warnings.warn(f"torch.profiler recorded fewer launches of {name} than "
                  f"{iters} calls in {attempts} traces; timed by a CUDA "
                  f"graph instead", RuntimeWarning)
    return graph_launch_ms(fn, iters)


def report(cases: Sequence[Case], outs, iters: int = 10,
           log=print) -> List[dict]:
    """Hold each case's outputs (from ``drive``) against the plain versions,
    the chain and K1/K3, time every version, print one line a case, and
    return one dict a case."""
    rows = []
    for c, (y8, y9) in zip(cases, outs):
        dev = c.x.device
        p8, chain = plain_k8(c), run_chain(c)
        r = dict(name=c.name, part=c.part, stride=c.stride,
                 err8=_maxdiff(y8, p8), range8=p8.float().abs().max().item(),
                 err8_chain=_maxdiff(y8, chain),
                 finite=bool(torch.isfinite(y8.float()).all()),
                 bound8=c.work8().bound(),
                 ms_chain=timer(lambda: run_chain(c), dev, iters),
                 ms8=timer(lambda: run_k8(c), dev, iters),
                 ms_plain8=timer(lambda: plain_k8(c), dev, max(1, iters // 4)))
        line = (f"{c.name:34s} chain {r['ms_chain']:8.4f} ms | K8 "
                f"{r['ms8']:8.4f} ms (bound {r['bound8'][0]:.4f}, plain "
                f"{r['ms_plain8']:8.4f}) |d| plain {r['err8']:.2e} "
                f"({r['err8'] / r['range8']:.1e} of range) chain "
                f"{r['err8_chain']:.2e}")
        if y9 is not None:
            n, h, w, _ = c.x.shape
            p9 = k9.cs_to_nhwc(plain_k9(c), n, h, w)
            r.update(err9=_maxdiff(y9, p9),
                     range9=p9.float().abs().max().item(),
                     err9_chain=_maxdiff(y9, chain),
                     finite=r["finite"] and bool(torch.isfinite(
                         y9.float()).all()),
                     bound9=c.work9().bound(),
                     ms9=timer(lambda: run_k9(c), dev, iters),
                     ms_plain9=timer(lambda: plain_k9(c), dev,
                                     max(1, iters // 4)))
            line += (f" | K9 {r['ms9']:8.4f} ms (bound "
                     f"{r['bound9'][0]:.4f}, plain {r['ms_plain9']:8.4f}) "
                     f"|d| plain {r['err9']:.2e} "
                     f"({r['err9'] / r['range9']:.1e} of range) chain "
                     f"{r['err9_chain']:.2e}")
        if c.block is not None:
            r.update(err8_block=_maxdiff(y8, run_block(c)),
                     ms_block=timer(lambda: run_block(c), dev, iters))
            line += (f" | K{3 if c.stride == 2 else 1} "
                     f"{r['ms_block']:8.4f} ms, K8 vs it {r['err8_block']:.2e}"
                     f" ({r['err8_block'] / r['range8']:.1e} of range)")
        log(line)
        rows.append(r)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--batch", type=int, default=256,
                    help="part (a)'s batch (the tool's 256)")
    ap.add_argument("--shrink", type=int, default=1,
                    help="divide part (a)'s H and W by this")
    ap.add_argument("--xl-size", type=int, default=320)
    ap.add_argument("--xl-batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (host clock; plain versions)")
    print(f"bench_block on {where}")
    cases = (cases_configs(device, args.batch, args.shrink)
             + cases_xl(device, args.xl_size, args.xl_batch))
    return report(cases, drive(cases), args.iters)


if __name__ == "__main__":
    main()
