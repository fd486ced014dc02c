"""Per-layer and per-layer-type profiling, the port of
``ffcnn_tpu/profiling.py`` (the analog of the reference's
``ENABLE_NET_PROFILE`` + ``net_profile()``, ffcnn.c:33,494-510,550).

``graph/build.py::forward_features`` runs every dispatch under a
``torch.profiler.record_function`` range named as the JAX package's
``jax.named_scope`` (``L{li:03d}_{type}``, ``L{li:03d}_fusedrun_to_{end}``,
``L{li:03d}_headrun_to_{end}``, ``L000_conv0_pallas``).  A
``torch.profiler`` trace of CPU and CUDA activity attributes each device
event to the range whose host interval holds the runtime call that
launched it (matched by correlation id); events launched outside every
range (letterbox, decode, arena cap, top-k, the keep mask) go to
``other_us``.

On the CPU there are no device events: the rows are the ranges' CPU time
and the total is the host clock a step, and the report says so.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import time
from typing import Dict, List, Optional

import torch

from .darknet.ir import LAYER_TYPE_NAMES, LayerType, NetIR

_SCOPE_RE = re.compile(r"L(\d\d\d)_[a-z0-9_]+")
# seconds between a trace's window opening and its first traced step
SETTLE_S = 0.2


@dataclasses.dataclass
class LayerProfile:
    index: int
    type_name: str
    desc: str
    us_per_step: float


@dataclasses.dataclass
class ProfileReport:
    layers: List[LayerProfile]
    by_type: Dict[str, float]          # type name -> us/step
    other_us: float                    # preprocess/decode/NMS/etc
    total_us: float
    iters: int
    device: str = "cpu"                # the card's name, or "cpu"
    clock: str = "CPU"                 # "device" (card events) or "CPU"
    # Static roofline floors (roofline.py): layer idx -> floor us, set by
    # Net.profile_layers so the per-layer table shows how far each measured
    # time sits above its bound.
    floors_us: Optional[Dict[int, float]] = None
    # scope (layer index, -1 for none) -> {device event name: count}, over
    # the profiled steps (empty on the CPU)
    kernels: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # the bucket's CUDA graph replay on the same batch: device us a step
    replay_us: Optional[float] = None

    def render(self, per_layer: bool = True) -> str:
        """net_profile-style text report (per layer type, like
        NET.timeused[] ffcnn.h:45), followed (optionally) by the per-layer
        table, with measured-vs-floor columns when floors are attached."""
        lines = ["profile (%s us per step on %s, %d steps averaged):"
                 % (self.clock, self.device, self.iters)]
        for name, us in sorted(self.by_type.items(), key=lambda kv: -kv[1]):
            lines.append("  %-10s %10.1f us  %5.1f%%"
                         % (name, us, 100 * us / max(1e-9, self.total_us)))
        lines.append("  %-10s %10.1f us  %5.1f%%"
                     % ("(pre/post)", self.other_us,
                        100 * self.other_us / max(1e-9, self.total_us)))
        lines.append("  %-10s %10.1f us" % ("total", self.total_us))
        if self.replay_us is not None:
            lines.append("  %-10s %10.1f us  (the bucket's CUDA graph "
                         "replay, device time a step)"
                         % ("replay", self.replay_us))
        if not per_layer:
            return "\n".join(lines) + "\n"
        lines.append("")
        hdr = "%4s %-9s %-40s %10s" % ("idx", "type", "layer", "us/step")
        if self.floors_us:
            hdr += " %9s %8s" % ("floor us", "x floor")
        lines.append(hdr)
        for lp in self.layers:
            if lp.us_per_step <= 0:
                continue
            row = "%4d %-9s %-40s %10.1f" % (lp.index, lp.type_name,
                                             lp.desc, lp.us_per_step)
            if self.floors_us:
                fl = self.floors_us.get(lp.index, 0.0)
                row += " %9.1f %8s" % (
                    fl, ("%.2f" % (lp.us_per_step / fl)) if fl > 0 else "-")
            lines.append(row)
        return "\n".join(lines) + "\n"


def _layer_desc(ir: NetIR, li: int) -> str:
    layer = ir.layers[li]
    ib, ob = ir.blobs[li], ir.blobs[li + 1]
    if layer.type == LayerType.CONV:
        kind = ("dw%dx%d" % (layer.fs, layer.fs) if layer.groups > 1
                else ("pw1x1" if layer.fs == 1 else "conv%d" % layer.fs))
        return "%s s%d %3dx%3dx%3d->%3dx%3dx%3d" % (
            kind, layer.stride, ib.w, ib.h, ib.c, ob.w, ob.h, ob.c)
    return "%s ->%dx%dx%d" % (LAYER_TYPE_NAMES[layer.type], ob.w, ob.h, ob.c)


def _is_device_event(e) -> bool:
    """A device activity (kernel, copy, set), not a range's device-side
    annotation."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not _SCOPE_RE.fullmatch(e.name))


def trace(run_step, iters: int = 1, cuda: bool = True):
    """Run ``run_step()`` ``iters`` times under ``torch.profiler`` (CPU and,
    with ``cuda``, CUDA activity) and return ``(events, host_s)``: the
    trace's events (``prof.events()``, the CPU ops with their parents) and
    the host seconds of those steps (the card synchronised at their end).
    One untraced step runs first inside the profiled window, and the
    traced steps start SETTLE_S after the trace's window opens: late in a
    long run the profiler dropped the device events of a trace's first
    milliseconds, as if the card's timestamps fell before the window."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    got = {}
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.__setitem__("ev", p.events())
                 ) as prof:
        run_step()
        sync()
        prof.step()
        if cuda:
            time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        for _ in range(iters):
            run_step()
        sync()
        host_s = time.perf_counter() - t0
        prof.step()
    if "ev" not in got:
        raise RuntimeError("torch.profiler returned no trace")
    return got["ev"], host_s


def device_op_time_ms(run_step, iters: int = 1) -> float:
    """Device time per step (ms): the summed duration of every device
    event (kernels, copies) of ``iters`` calls of ``run_step`` on the card,
    by ``torch.profiler``.  Raises where the trace holds no device time:
    no card, a CPU step, or a profiler that saw no device activity."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: no device time to measure")
    events, _ = trace(run_step, iters)
    tot = sum(e.time_range.end - e.time_range.start for e in events
              if _is_device_event(e))
    if tot <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return tot / iters / 1e3


def trace_occupancy(events) -> Dict[str, float]:
    """Device busy time against span, as an interval union over the device
    events of a trace (``trace``'s events, or any with ``device_type``,
    ``is_user_annotation``, ``name`` and ``time_range``).  All timestamps
    are the card's, so host time between launches shows up as idle.
    Returns ``{busy_ms, span_ms, occupancy}``."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if _is_device_event(e)
                and e.time_range.end > e.time_range.start)
    if not iv:
        return {"busy_ms": 0.0, "span_ms": 0.0, "occupancy": 0.0}
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, t in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    # the span ends at the LATEST end, which an overlapping long event may
    # hold past the last-starting one's
    span = max(e for _, e in iv) - iv[0][0]
    return {"busy_ms": round(busy / 1e3, 3), "span_ms": round(span / 1e3, 3),
            "occupancy": round(busy / span, 4) if span else 0.0}


def _ranges(events):
    """The layer ranges of a trace, by host start: [(start, end, layer)]."""
    out = []
    for e in events:
        m = _SCOPE_RE.fullmatch(e.name)
        if m and e.device_type == torch.autograd.DeviceType.CPU:
            out.append((e.time_range.start, e.time_range.end,
                        int(m.group(1))))
    return sorted(out)


def _attribute_device(events):
    """({layer: device us}, {layer or -1: {event name: count}}, total us)
    over the trace.  A device event shares its correlation id with the
    runtime call that launched it (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...), a host event; the event goes to the layer
    range whose host interval holds that call, the rest (launched outside
    every range) to -1.  The host interval, not the op tree, decides:
    a kernel's runtime call is made through ctypes inside its ``ffcnn::``
    op's CUDA implementation, on the thread the range is on."""
    ranges = _ranges(events)
    starts = [r[0] for r in ranges]
    launch = {e.id: e for e in events
              if e.device_type == torch.autograd.DeviceType.CPU
              and e.name.startswith("cu")}
    per: Dict[int, float] = collections.Counter()
    names: Dict[int, collections.Counter] = collections.defaultdict(
        collections.Counter)
    total = 0.0
    for d in events:
        if not _is_device_event(d):
            continue
        dur = d.time_range.end - d.time_range.start
        total += dur
        li = -1
        call = launch.get(d.id)
        if call is not None:
            i = bisect.bisect_right(starts, call.time_range.start) - 1
            if i >= 0 and call.time_range.start < ranges[i][1]:
                li = ranges[i][2]
                per[li] += dur
        names[li][d.name] += 1
    return per, {k: dict(v) for k, v in names.items()}, total


def _attribute_cpu(events):
    """{layer: CPU us} over the trace: each range's own host duration."""
    per: Dict[int, float] = collections.Counter()
    for start, end, li in _ranges(events):
        per[li] += end - start
    return per


def profile_layers(run_step, ir: NetIR, iters: int = 10, runs=None,
                   device="cuda") -> ProfileReport:
    """Profile ``run_step()`` (a zero-argument callable running one step of
    the eager pipeline on ``device``; the caller warms it) and attribute
    its time to layers.  On the card: the device events of ``iters`` steps
    by ``torch.profiler``, each given to the layer range that launched it;
    raises where the trace holds no device time.  On the CPU: each range's
    host time, and the host clock a step as the total.

    A CUDA graph's replay runs no Python, so no range encloses its kernels:
    profile the eager pipeline (``Net.profile_layers`` runs
    ``_Pipeline.run``), whose device time a replay matched within about 2%
    on an H100 (region, batch 64: eager 5.865 ms, replay 5.996 ms;
    PERF.md section 5).

    ``runs``: ``[(start, end), ...]`` fused regions active in the pipeline;
    a region's whole device time lands on its start-layer range, so its row
    is labeled as the region."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    events, host_s = trace(run_step, iters, cuda)
    if cuda:
        per, kernels, total = _attribute_device(events)
        if total <= 0:
            raise RuntimeError("torch.profiler recorded no device time")
        name = torch.cuda.get_device_name(dev)
    else:
        per, kernels, total = _attribute_cpu(events), {}, host_s * 1e6
        name = "cpu"
    per_layer = {k: v / iters for k, v in per.items()}
    total /= iters
    run_of = {s: e for s, e in (runs or [])}
    layers = [LayerProfile(li, ("fusedrun" if li in run_of
                                else LAYER_TYPE_NAMES[ir.layers[li].type]),
                           ("region L%03d..L%03d (%d layers)"
                            % (li, run_of[li], run_of[li] - li + 1)
                            if li in run_of else _layer_desc(ir, li)),
                           per_layer.get(li, 0.0))
              for li in range(len(ir.layers))]
    by_type: Dict[str, float] = collections.Counter()
    for lp in layers:
        by_type[lp.type_name] += lp.us_per_step
    scoped = sum(lp.us_per_step for lp in layers)
    return ProfileReport(layers=layers, by_type=dict(by_type),
                         other_us=total - scoped, total_us=total,
                         iters=iters, device=name,
                         clock="device" if cuda else "CPU", kernels=kernels)
