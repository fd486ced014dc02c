"""What a pixels-to-boxes program runs under, shared by ``net.py``'s
buckets and ``export.py``'s artifacts: the capture of a program as one
CUDA graph at one batch size (``Graph``), the TF32 switches of a mode
(``tf32``), results as ``Detection`` lists
(``to_detections``) and batches kept in flight (``stream_detections``).
Imports no graph builder, so an artifact loader can use it.
"""

from __future__ import annotations

import contextlib
import gc
import typing
from collections import deque
from typing import List

import numpy as np
import torch

from .ops.nms import NMSResult

# Eager runs of a pipeline before its capture: they take what the first
# call of a kernel does once (a library's build and load, the raised
# shared-memory caps, cuDNN's and cuBLAS's handles and workspaces).
WARMUP_RUNS = 2


class Detection(typing.NamedTuple):
    """One detection in original-image pixel coords (reference BBOX,
    ffcnn.h:29-32)."""
    score: float
    class_id: int
    x1: float
    y1: float
    x2: float
    y2: float


@contextlib.contextmanager
def tf32(allow: bool):
    """Set cuDNN's and cuBLAS's TF32 switches for the block, then restore
    them (they are process-wide): on in fast and int8 mode, off in parity
    mode (the JAX package's ``Precision.HIGHEST``)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def to_detections(res: NMSResult) -> List[List[Detection]]:
    """An ``NMSResult`` -> one Detection list an image (its nonzero
    scores, in slot order)."""
    scores = res.scores.cpu().numpy()
    ii, jj = np.nonzero(scores > 0)
    sel_scores = scores[ii, jj].astype(float)
    sel_classes = res.classes.cpu().numpy()[ii, jj]
    sel_boxes = res.boxes.cpu().numpy()[ii, jj].astype(float)
    counts = res.count.cpu().numpy()
    out: List[List[Detection]] = [[] for _ in range(scores.shape[0])]
    for i, s, c, (x1, y1, x2, y2) in zip(
            ii.tolist(), sel_scores.tolist(), sel_classes.tolist(),
            sel_boxes.tolist()):
        out[i].append(Detection(s, int(c), x1, y1, x2, y2))
    if any(len(d) != n for d, n in zip(out, counts.tolist())):
        raise RuntimeError("NMS count disagrees with its score mask")
    return out


def stream_detections(detect_async, batches, depth: int = 2):
    """Keep up to ``depth`` batches in flight through a ``detect_async``-
    shaped callable (one uint8 (N, H, W, 3) batch -> a zero-argument
    completion callable); yields each batch's result in order.  The port's
    copy of ``ffcnn_tpu/net.py::stream_detections``."""
    # checked at call time: the generator's body runs at its first item
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")

    def gen():
        inflight: deque = deque()
        for batch in batches:
            batch = np.asarray(batch)
            if batch.ndim != 4 or batch.shape[-1] != 3:
                raise ValueError(f"expected (N, H, W, 3) uint8 "
                                 f"batches, got {batch.shape}")
            inflight.append(detect_async(batch))
            if len(inflight) >= depth:
                yield inflight.popleft()()
        while inflight:
            yield inflight.popleft()()
    return gen()


@contextlib.contextmanager
def capturing(graph, pool=None):
    """Capture the block's launches into ``graph``, its memory from
    ``pool``.  ``thread_local``: another thread's CUDA calls (a server's
    request threads) cannot invalidate the capture.  The garbage collector
    is held off for the block: a collection there that frees a dead CUDA
    graph (a dropped Net's bucket in a reference cycle) destroys it in the
    middle of the capture, which invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            yield
    finally:
        if enabled:
            gc.enable()


def capture(graph, run, x: torch.Tensor, pool):
    """Capture ``run(x)`` into ``graph``, its memory from ``pool``
    (``capturing``); returns the captured outputs."""
    with capturing(graph, pool):
        return run(x)


class Graph:
    """A program captured as a CUDA graph at one input shape: the static
    uint8 (N, H, W, 3) input its replays read and the outputs they
    overwrite.  A replay runs no Python: the kernels' ops count their
    launches at the warm-up runs and at the capture, not at a replay."""

    def __init__(self, run, n: int, h: int, w: int, device, pool):
        # outside the graph's pool: no later capture reuses it
        self.input = torch.zeros((n, h, w, 3), dtype=torch.uint8,
                                 device=device)
        # warm-up on a side stream, as PyTorch's graph docs prescribe
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                run(self.input)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        self.output = capture(self.graph, run, self.input, pool)

    def replay(self, batch: torch.Tensor) -> NMSResult:
        """Copy ``batch`` in, replay, and return clones of the outputs (the
        next replay overwrites them), all on the current stream."""
        self.input.copy_(batch)
        self.graph.replay()
        return NMSResult(*(t.clone() for t in self.output))
