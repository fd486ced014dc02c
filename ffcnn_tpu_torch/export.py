"""AOT deployment artifacts: one serialized, weights-baked program per
(batch, image-size) bucket, the port of ``ffcnn_tpu/export.py``.

The reference ships a 68 KB self-contained binary (readme.txt:128-129): no
runtime dependencies, weights loaded beside it.  The JAX package's analog
is a ``jax.export`` artifact; here it is a ``torch.export`` program (a
``.pt2`` file): the whole pixels-to-boxes pipeline of one ``Net`` bucket
(letterbox, forward with the weights and an int8 plan's constants baked in,
decode, arena cap, top-k and the keep mask), loadable by a serving process
that has neither the cfg/weights pair nor the graph builder: only
``load_exported(path)`` (this module, the ``ffcnn::`` ops of
``kernels/ops.py`` and torch) and pixels.

Every kernel the pipeline launches is an ``ffcnn::`` op, so the program
holds each as one node (the sidecar lists them, as JAX's lists its
custom-call targets); the kernels build from ``csrc/`` at their first
launch, as for a ``Net``.  Top-k and the flags a ``Net`` read are sealed
into the program: there is no K-growth retry, and saturation warns.  A conv
that the float32 knobs force (``FFCNN_HEAD_F32``, ``FFCNN_F32_STAGES``) is
the op ``ffcnn::conv2d_f32``, which turns cuDNN's TF32 off on the card
itself, so a program keeps that precision.

Platforms (``platforms=``, JAX's argument): ``"cuda"`` and ``"cpu"``.  One
platform (the default: the Net's device) is one ``torch.export.save`` file.
Several are one file holding a program each, keyed by platform: an
uncompressed zip of ``<platform>.pt2`` members, each a
``torch.export.save`` archive, beside an index (``BUNDLE_INDEX``).
``torch.export``'s own multi-program archive (``package_pt2``) is not used:
its reader materialises every program on the device it was traced on, so a
host with no card could not open a file that also holds a card program.
Each program is traced on its own device (the other one through
``Net.replica``): the pipeline chooses between launch and plain version,
and prepares the kernels' device buffers, as it traces.  So a ``"cuda"``
program is exported only where there is a card; JAX lowers for a TPU from
a host without one, the port cannot.  The sidecar records each platform's
golden-probe detections, taken from that platform's own run.

``load_exported(path, device=None)`` runs the program of the card where
there is one and the file has it, else the CPU's; a device asked for that
the file lacks raises, naming the platforms it has.  On the card
``ArtifactNet`` captures each artifact as one CUDA graph and replays it,
the port's counterpart of XLA's compiled call.  An artifact exported for
the card alone refuses to load where there is no card.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import warnings
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .kernels import _build
from .kernels import ops as _ops
from .ops.nms import NMSResult
from .runtime import Graph, stream_detections, tf32, to_detections

FORMAT = 1
PROBE_SEED = 20260817
# Probe-verification tolerances (verify_artifact), the JAX package's: the
# same process replays bit for bit; the slack absorbs the drift of an
# artifact probed in another process or build.
PROBE_SCORE_ATOL = 0.05
PROBE_BOX_ATOL = 3.0
# the program's own record of how it runs, inside the .pt2
_EXTRA = "ffcnn_meta.json"
# the platforms an artifact may hold a program for, and the index member of
# a file that holds several
PLATFORMS = ("cuda", "cpu")
BUNDLE_INDEX = "ffcnn_platforms.json"


def meta_path(path: str) -> str:
    """Sidecar metadata file for artifact ``path`` (JSON): the ``ffcnn::``
    ops the program calls, the kernels' source hash, torch's version, and
    the baked golden probe."""
    return path + ".meta.json"


def _probe_image(h: int, w: int, seed: int = PROBE_SEED) -> np.ndarray:
    """Deterministic structured probe frame (the JAX package's bytes):
    gradient + blocks + seeded noise, enough texture that a real detector
    produces a stable (possibly empty) detection set, and any weight or
    graph mismatch shows up."""
    rng = np.random.RandomState(seed)
    ramp = np.linspace(0, 200, w, dtype=np.float32)[None, :, None]
    img = np.broadcast_to(ramp, (h, w, 3)).copy()
    yy, xx = np.mgrid[0:h, 0:w]
    img[:, :, 1] += ((yy // 16 + xx // 16) % 2) * 40
    img += rng.randint(0, 32, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _probe_batch(n: int, h: int, w: int, seed: int = PROBE_SEED):
    return np.broadcast_to(_probe_image(h, w, seed), (n, h, w, 3)).copy()


def _det_rows(res: NMSResult) -> list:
    return [[[d.class_id, round(d.score, 4)] +
             [round(v, 2) for v in (d.x1, d.y1, d.x2, d.y2)] for d in dets]
            for dets in to_detections(res)]


class _Program(torch.nn.Module):
    """A bucket's eager pipeline as the module ``torch.export`` traces."""

    def __init__(self, pipe):
        super().__init__()
        self.pipe = pipe

    def forward(self, x):
        return tuple(self.pipe.run(x))


def _custom_ops(ep) -> list:
    """The ``ffcnn::`` overloads an exported program calls."""
    return sorted({str(n.target).replace(".", "::", 1)
                   for n in ep.graph.nodes
                   if n.op == "call_function"
                   and str(n.target).startswith(_ops.NAMESPACE + ".")})


def _platforms(platforms, default: str) -> Tuple[str, ...]:
    """``platforms`` checked: names from ``PLATFORMS``, each once (default
    ``(default,)``); a ``"cuda"`` program needs the card."""
    if platforms is None:
        return (default,)
    plats = (platforms,) if isinstance(platforms, str) else tuple(platforms)
    bad = [p for p in plats if p not in PLATFORMS]
    if bad or not plats or len(set(plats)) != len(plats):
        raise ValueError(f"platforms {list(plats)}: the port exports for "
                         f"each of {list(PLATFORMS)} at most once "
                         f"(unknown: {bad})")
    if "cuda" in plats and not torch.cuda.is_available():
        raise RuntimeError(
            "exporting for 'cuda' needs the card: the program is traced on "
            "it and holds the kernels' prepared device buffers; this "
            "process has no CUDA device")
    return plats


def _trace(net, batch_size: int, img_h: int, img_w: int, mean, norm):
    """``net``'s bucket traced on its device: (the exported program, the
    golden probe's detections there)."""
    pipe = net._pipeline_for(img_h, img_w, mean, norm)
    probe = torch.from_numpy(_probe_batch(batch_size, img_h, img_w)
                             ).to(net.device)
    with torch.no_grad(), tf32(net.mode != "parity"):
        # the eager run first: it gives the probe's detections and fills
        # the pipeline's per-geometry caches with real tensors, which the
        # trace then bakes in as constants
        expected = _det_rows(pipe.run(probe))
        ep = torch.export.export(_Program(pipe), (probe,), strict=False)
    return ep, expected


def save_programs(path: str, programs: dict, mode: str) -> None:
    """Write ``{platform: exported program}`` to ``path``: one program as
    ``torch.export.save`` writes it, several as one uncompressed zip of
    ``<platform>.pt2`` members beside ``BUNDLE_INDEX``.  Each program
    records its device and ``mode`` inside it."""
    def extra(plat):
        return {_EXTRA: json.dumps({"device": plat, "mode": mode})}
    if len(programs) == 1:
        ((plat, ep),) = programs.items()
        torch.export.save(ep, path, extra_files=extra(plat))
        return
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr(BUNDLE_INDEX, json.dumps(
            {"format": FORMAT, "platforms": list(programs), "mode": mode}))
        for plat, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf, extra_files=extra(plat))
            zf.writestr(f"{plat}.pt2", buf.getvalue())


def export_net(net, path: str, *, batch_size: int = 1,
               image_size: Optional[Tuple[int, int]] = None,
               mean=None, norm=None,
               platforms: Optional[Sequence[str]] = None) -> int:
    """Write ``net``'s pipeline for one (batch, H, W) bucket to ``path`` and
    its sidecar beside it; returns the artifact's size in bytes.
    ``image_size``: (H, W) of the incoming images (default the net's input
    size).  ``platforms``: ``"cuda"`` and/or ``"cpu"``, a program each
    (default the net's device); another device's program is traced on
    ``net.replica`` there.

    The sidecar also bakes a GOLDEN PROBE: a deterministic frame and the
    detections this Net gives on it now, on each platform.  Loaders
    (``ArtifactNet``, ``serve --artifact``) replay it at warmup and refuse
    readiness on a mismatch, so a stale or mismatched artifact fails on its
    semantics, not only on its shapes."""
    from .net import DEFAULT_MEAN, DEFAULT_NORM

    plats = _platforms(platforms, net.device.type)
    if net.mode == "int8" and net.quant is None:
        raise RuntimeError("int8 mode: call calibrate(images) (or "
                           "set_quant_plan) before exporting")
    net_w, net_h = net.ir.blobs[0].w, net.ir.blobs[0].h
    img_h, img_w = image_size or (net_h, net_w)
    mean = mean if mean is not None else DEFAULT_MEAN
    norm = norm if norm is not None else DEFAULT_NORM
    programs, expected = {}, {}
    for plat in plats:
        pnet = net if plat == net.device.type else net.replica(plat)
        programs[plat], expected[plat] = _trace(pnet, batch_size, img_h,
                                                img_w, mean, norm)
    save_programs(path, programs, net.mode)
    with open(meta_path(path), "w") as f:
        json.dump({"format": FORMAT, "torch_version": torch.__version__,
                   "device": plats[0], "mode": net.mode,
                   "platforms": list(plats),
                   "custom_ops": sorted({op for ep in programs.values()
                                         for op in _custom_ops(ep)}),
                   "kernel_hash": _build.source_hash(),
                   "probe": {"seed": PROBE_SEED,
                             "expected": expected[plats[0]],
                             "expected_by_platform": expected}},
                  f, indent=1)
    return os.path.getsize(path)


@dataclasses.dataclass(frozen=True)
class ExportedNet:
    """A loaded artifact.  ``call(batch)`` runs the whole pixels-to-boxes
    program on a uint8 batch of exactly the exported (N, H, W, 3) shape
    (one artifact per bucket) and returns an ``NMSResult`` on the
    artifact's device.  ``meta`` is the sidecar dict, or None for a bare
    artifact; ``platforms`` those the file holds a program for, ``device``
    the one loaded."""
    program: torch.nn.Module
    in_shape: Tuple[int, ...]
    device: torch.device
    mode: str
    meta: Optional[dict] = None
    platforms: Tuple[str, ...] = ()

    def run(self, x: torch.Tensor) -> NMSResult:
        """The program on a checked uint8 tensor on its device, under its
        mode's TF32 switches."""
        with torch.no_grad(), tf32(self.mode != "parity"):
            return NMSResult(*self.program(x))

    def call(self, batch) -> NMSResult:
        x = batch if isinstance(batch, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(batch))
        if tuple(x.shape) != self.in_shape or x.dtype != torch.uint8:
            raise ValueError(f"artifact expects uint8{list(self.in_shape)}, "
                             f"got {x.dtype}{list(x.shape)}")
        return self.run(x.to(self.device))


def choose_platform(platforms: Sequence[str], device=None,
                    cuda: Optional[bool] = None, name: str = "artifact"
                    ) -> str:
    """The platform whose program ``load_exported`` runs: ``device``'s
    where given, else the card's where there is one (``cuda``, default
    ``torch.cuda.is_available()``) and the file has it, else the CPU's.
    Raises, naming ``platforms``, where the file has no such program or
    the card is asked for and absent: never another device's program."""
    cuda = torch.cuda.is_available() if cuda is None else cuda
    plats = tuple(platforms)
    if device is None:
        for plat in ("cuda", "cpu") if cuda else ("cpu",):
            if plat in plats:
                return plat
        raise RuntimeError(f"{name} was exported on the card (platforms "
                           f"{list(plats)}); this process has no CUDA "
                           f"device")
    want = torch.device(device).type
    if want not in plats:
        raise ValueError(f"{name} holds no program for {want!r}: its "
                         f"platforms are {list(plats)}")
    if want == "cuda" and not cuda:
        raise RuntimeError(f"{name}: 'cuda' asked for, but this process has "
                           f"no CUDA device")
    return want


def _bundle_platforms(path: str) -> Optional[Tuple[str, ...]]:
    """The platforms of a file that holds several programs, or None for a
    one-program file."""
    if not zipfile.is_zipfile(path):
        return None
    with zipfile.ZipFile(path) as zf:
        if BUNDLE_INDEX not in zf.namelist():
            return None
        return tuple(json.loads(zf.read(BUNDLE_INDEX))["platforms"])


def load_exported(path: str, device=None) -> ExportedNet:
    """Load an ``export_net`` artifact: the program of ``device`` (a
    ``choose_platform`` choice where None).  Needs this module, the
    ``ffcnn::`` ops and torch: no cfg, no weights file, no graph builder.
    The sidecar is read when present (probe verification happens in
    ``verify_artifact`` and ``ArtifactNet.warmup``, not here: loading stays
    cheap)."""
    meta = None
    if os.path.exists(meta_path(path)):
        with open(meta_path(path)) as f:
            meta = json.load(f)
    # a one-program file holds its sidecar's device's program
    bundle = _bundle_platforms(path)
    plats = bundle or ((meta["device"],) if meta and "device" in meta
                       else None)
    plat = choose_platform(plats, device, name=path) if plats else None
    extra = {_EXTRA: ""}
    src = path
    if bundle:
        with zipfile.ZipFile(path) as zf:
            src = io.BytesIO(zf.read(f"{plat}.pt2"))
    try:
        with warnings.catch_warnings():
            # torch reads the constants into read-only buffers; a program
            # never writes its constants
            warnings.filterwarnings(
                "ignore", message="The given buffer is not writable")
            ep = torch.export.load(src, extra_files=extra)
    except RuntimeError as e:
        if "CUDA" in str(e) and not torch.cuda.is_available():
            raise RuntimeError(f"{path} needs a CUDA device: {e}") from e
        raise
    info = json.loads(extra[_EXTRA]) if extra[_EXTRA] else {}
    if plats is None:                       # a bare one-program file
        plats = (info.get("device", "cpu"),)
        plat = choose_platform(plats, device, name=path)
    (spec,) = [n.meta["val"] for n in ep.graph.nodes
               if n.op == "placeholder"
               and n.name in ep.graph_signature.user_inputs]
    return ExportedNet(program=ep.module(), in_shape=tuple(spec.shape),
                       device=torch.device(plat),
                       mode=info.get("mode", "fast"), meta=meta,
                       platforms=plats)


def verify_artifact(art: ExportedNet, name: str = "artifact") -> None:
    """Semantic health gate: replay the baked golden probe and compare the
    detections with the ones recorded at export.  Raises ``RuntimeError``
    on a mismatch: a worker serving a stale or mismatched artifact must not
    go healthy on shape checks alone.  A no-op (with a warning) for an
    artifact exported without a sidecar."""
    if art.meta is None or "probe" not in art.meta:
        warnings.warn(f"{name}: no .meta.json sidecar; semantic probe gate "
                      "skipped (re-export to bake one)", RuntimeWarning)
        return
    n, h, w, _ = art.in_shape
    probe = _probe_batch(n, h, w, art.meta["probe"].get("seed", PROBE_SEED))
    got = to_detections(art.call(probe))
    # the loaded platform's own detections at export
    want = art.meta["probe"].get("expected_by_platform", {}).get(
        art.device.type, art.meta["probe"]["expected"])
    for i, (g_dets, w_dets) in enumerate(zip(got, want)):
        ok = len(g_dets) == len(w_dets) and all(
            g.class_id == wd[0]
            and abs(g.score - wd[1]) <= PROBE_SCORE_ATOL
            and max(abs(a - b) for a, b in
                    zip((g.x1, g.y1, g.x2, g.y2), wd[2:])) <= PROBE_BOX_ATOL
            for g, wd in zip(g_dets, w_dets))
        if not ok:
            rows = [[d.class_id, round(d.score, 4)]
                    + [round(v, 1) for v in (d.x1, d.y1, d.x2, d.y2)]
                    for d in g_dets]
            raise RuntimeError(
                f"{name}: golden-probe mismatch on image {i}: expected "
                f"{w_dets}, got {rows}; the artifact does not match the "
                f"model it claims to be")


class ArtifactNet:
    """Net-shaped facade over exported artifacts, for serving without the
    model half: ``serve --artifact a.pt2 [...]`` gives a worker that holds
    only deploy artifacts (no cfg parsing, no weights loading, no graph
    building at startup).

    Routing: a ``detect(batch)`` call picks the artifact with the batch's
    (H, W) and the smallest exported batch >= n, padding with zero images
    (the micro-batcher pads to powers of two, so export matching buckets:
    1, 2, ..., max_batch).  On the card each artifact is captured as one
    CUDA graph at its first call (``warmup`` captures them all) and
    replayed after, as a ``Net`` bucket is.  Each artifact runs the
    program ``load_exported`` chooses: the card's where there is a card and
    the file has it, else the CPU's."""

    def __init__(self, paths: Sequence[str]):
        if not paths:
            raise ValueError("at least one artifact path required")
        self._buckets = {}                  # (h, w) -> [(n, ExportedNet)]
        self.paths = tuple(paths)
        self._arts = []
        for p in paths:
            art = load_exported(p)
            self._arts.append(art)
            n, h, w, _ = art.in_shape
            self._buckets.setdefault((h, w), []).append((n, art))
        for v in self._buckets.values():
            v.sort(key=lambda t: t[0])
        # as a Net's buckets: one graph an artifact, one pool, one lock
        self._graphs = {}
        self._lock = threading.Lock()
        devices = {a.device for a in self._arts}
        if len(devices) != 1:
            raise ValueError(f"artifacts for several devices: {devices}")
        self.device = devices.pop()
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._replayed = torch.cuda.Event()

    @property
    def input_hw(self) -> Tuple[int, int]:
        return next(iter(self._buckets))

    @property
    def max_batch(self) -> int:
        return max(n for v in self._buckets.values() for n, _ in v)

    def _pick(self, h: int, w: int, n: int) -> ExportedNet:
        sizes = self._buckets.get((h, w))
        if sizes is None:
            raise ValueError(
                f"no artifact for {h}x{w} images (have "
                f"{sorted(self._buckets)})")
        for bn, art in sizes:
            if bn >= n:
                return art
        raise ValueError(f"batch {n} exceeds largest {h}x{w} artifact "
                         f"({sizes[-1][0]})")

    def _call(self, art: ExportedNet, batch) -> NMSResult:
        """``art`` on a uint8 batch of its shape (numpy, or a tensor): on
        the card its graph's replay (captured at the first call)."""
        if self.device.type != "cuda":
            return art.call(batch)
        x = batch if isinstance(batch, torch.Tensor) else \
            torch.from_numpy(batch).pin_memory()
        x = x.to(self.device, non_blocking=True)
        with self._lock:
            g = self._graphs.get(id(art))
            if g is None:
                n, h, w, _ = art.in_shape
                with tf32(art.mode != "parity"):
                    g = self._graphs[id(art)] = Graph(
                        art.run, n, h, w, self.device, self._pool)
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._replayed)
            res = g.replay(x)
            self._replayed.record(stream)
        return res

    def detect(self, images):
        """(N, H, W, 3) uint8 batch -> a list of Detection lists (the same
        host conversion as ``Net.detect``; no saturation retry, since the
        program's top-k is sealed at export, but saturation warns)."""
        return self.detect_async(images)()

    def detect_async(self, images):
        """Dispatch without waiting; returns a zero-argument completion
        callable (the serving micro-batcher overlaps rounds through it, as
        through ``Net.detect_async``)."""
        batch = np.ascontiguousarray(images)
        if batch.ndim != 4 or batch.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) uint8, got "
                             f"{batch.shape}")
        n, h, w, _ = batch.shape
        art = self._pick(h, w, n)
        bn = art.in_shape[0]
        if bn != n:
            batch = np.concatenate(
                [batch, np.zeros((bn - n,) + batch.shape[1:], np.uint8)])
        res = self._call(art, batch)

        def finish():
            if bool(res.saturated[:n].any()):
                warnings.warn(
                    "NMS top-k saturated: some candidates were dropped "
                    "pre-suppression; re-export the net with a larger topk "
                    "for crowded scenes.", RuntimeWarning, stacklevel=2)
            return to_detections(res)[:n]
        return finish

    def detect_stream(self, batches, depth: int = 2):
        """Pipelined detection over an iterable of uint8 (N, H, W, 3)
        batches, with ``Net.detect_stream``'s overlap."""
        return stream_detections(self.detect_async, batches, depth)

    def warmup(self, image_sizes=None, batch_sizes=None) -> None:
        """Run every artifact once (on the card: capture its graph) and
        verify its baked golden probe (``verify_artifact``): a stale or
        mismatched artifact raises here, which ``serve.py`` surfaces as a
        /healthz that stays 503.  The arguments are taken for a Net's
        interface; artifacts have fixed shapes and warm themselves."""
        for (h, w), sizes in self._buckets.items():
            for n, art in sizes:
                self._call(art, np.zeros((n, h, w, 3), np.uint8))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for p, art in zip(self.paths, self._arts):
            verify_artifact(art, name=p)

    def dump(self) -> str:
        """Inventory table (the graph is sealed inside the artifacts)."""
        lines = ["exported artifacts:"]
        for (h, w), sizes in sorted(self._buckets.items()):
            for n, art in sizes:
                lines.append(f"  {h}x{w} batch {n:4d}  device "
                             f"{art.device.type}  mode {art.mode}  "
                             f"platforms {','.join(art.platforms)}")
        return "\n".join(lines) + "\n"
