"""Fused inverted-residual blocks: pw-expand -> dw3x3 -> pw-project
(+ residual), the expand tensor never in device memory.  Holds the planner
(pure IR code), the CUDA kernels' wrappers and their plain PyTorch versions.

Four kernels.  K1 and K3 are one tensor-core template
(``csrc/block_mma.cuh``); K4 and K5 chain blocks on the float32 chunk
scheme of ``csrc/block_chain.cuh``:

* K1 (``fused_block``, ``csrc/block_fused.cu``) replaces
  ``ffcnn_tpu/kernels/block_fused.py::_make_kernel``, the stride-1 block
  launched once per block by ``_cs_block``.
* K3 (``fused_down_block``, ``csrc/block_down.cu``) replaces
  ``_make_down_kernel``, the stride-2 stage-transition block launched by
  ``_cs_down_block``: H and W halve, no residual.
* K4 (``fused_cascade``, ``csrc/block_cascade.cu``) replaces
  ``_make_cascade_kernel`` (``_cs_cascade``): a group of consecutive
  stride-1 blocks in one launch (``FFCNN_FUSED_CASCADE=k``, groups from
  ``cascade_groups``), the boundaries inside the group kept on chip in
  float32.
* K5 (``fused_mega``, ``csrc/block_mega.cu``) replaces ``_make_mega_kernel``
  (``_apply_run_mega``): a whole run of stride-1 blocks in one launch
  (``FFCNN_FUSED_MEGA``, where ``mega_fits``), one image's map resident on
  chip in float32.

The expand tensor is E/C times the block's input (3-6x on yolo-fastest-xl),
so materialising it dominates the block's device-memory traffic; the
kernels keep it in shared memory instead.  A CTA owns a tile of output
pixels of one image and walks E in chunks: it expands the tile's input halo
into shared memory, applies the depthwise 3x3 and adds the chunk's share of
the projection to float32 accumulators.  In K1 and K3 the expand and the
project run on the tensor cores in 3xTF32 (each float32 operand split into
a TF32 big and small part, the small*small product dropped: about 2^-21 of
each product, within the float32 tolerance one TF32 pass misses), the
depthwise taps in float32 on the CUDA cores, and the activations of the
combinations that ``plan_runs`` yields on ``models/*.cfg`` are fixed at
compile time.  K4 and K5 still run float32 FMAs on the CUDA cores.

Departures from the JAX package, neither of which changes a plan:

* Its TPU gates ``BATCH_QUANTUM``, ``runs_usable`` and the mega route's
  ``n % MEGA_NB == 0`` do not apply: on the card fast mode takes the
  kernels at every batch size.
* ``_pick_rows_cascade`` falls back to per-block launches where a group's
  rows do not fit VMEM or divide the map; here every cascade group runs as
  one K4 launch, because the tile search (``pick_cascade_tile``) bounds the
  shared memory instead, with tiles cut at the map's edge.  So a group the
  JAX package splits at such a geometry keeps its boundaries in float32
  here.
"""

from __future__ import annotations

import ctypes
import functools
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..darknet.ir import LayerType, NetIR
from ..ops.activations import activate
from ..tuning import get_flag
from . import _build

# Input-channel gate of the JAX package, kept so both packages plan the same
# runs.  It is a TPU crossover; the card's has not been measured.
MIN_CHANNELS = 24


@dataclasses.dataclass(frozen=True)
class FusedBlock:
    """One fusable [pw 1x1, dw 3x3 s1|s2, pw 1x1 (, dropout, shortcut)] run.
    ``start``: index of the expand conv; ``end``: last fused layer;
    ``residual``: add the block input; ``down``: the dw is stride 2."""
    start: int
    end: int
    residual: bool
    res_act: int
    down: bool = False


@dataclasses.dataclass(frozen=True)
class FusedRun:
    """Consecutive FusedBlocks sharing one layout round-trip."""
    start: int
    end: int
    blocks: Tuple[FusedBlock, ...]


def find_fused_blocks(ir: NetIR) -> Dict[int, FusedBlock]:
    """Locate fusable triples whose intermediate blobs have no consumers
    outside the block (``ffcnn_tpu/kernels/block_fused.py:74``)."""
    layers = ir.layers
    referenced = set()
    for l in layers:
        if l.type in (LayerType.ROUTE, LayerType.SHORTCUT):
            referenced.update(d + 1 for d in l.depends)

    out: Dict[int, FusedBlock] = {}
    li = 0
    while li + 2 < len(layers):
        a, b, c = layers[li], layers[li + 1], layers[li + 2]
        ok = (a.type == LayerType.CONV and a.fs == 1 and a.stride == 1
              and a.groups == 1
              and b.type == LayerType.CONV and b.fs == 3
              and b.stride in (1, 2)
              and b.groups == a.fn and b.fn == a.fn and b.pad == 1
              and c.type == LayerType.CONV and c.fs == 1 and c.stride == 1
              and c.groups == 1)
        if not ok:
            li += 1
            continue
        if b.stride == 2:
            if (ir.blobs[li].w % 2 == 0 and ir.blobs[li].h % 2 == 0
                    and not referenced & {li + 1, li + 2}):
                out[li] = FusedBlock(start=li, end=li + 2, residual=False,
                                     res_act=0, down=True)
                li += 3
            else:
                li += 1
            continue
        if (li + 4 < len(layers)
                and layers[li + 3].type == LayerType.DROPOUT
                and layers[li + 4].type == LayerType.SHORTCUT
                and layers[li + 4].depends[0] + 1 == li
                and ir.blobs[li].c == c.fn
                and not referenced & {li + 1, li + 2, li + 3, li + 4}):
            out[li] = FusedBlock(start=li, end=li + 4, residual=True,
                                 res_act=layers[li + 4].activation)
            li += 5
            continue
        if not referenced & {li + 1, li + 2}:
            out[li] = FusedBlock(start=li, end=li + 2, residual=False,
                                 res_act=0)
            li += 3
            continue
        li += 1
    return out


def plan_runs(ir: NetIR, min_channels: Optional[int] = None,
              allow_down: Optional[bool] = None) -> List[FusedRun]:
    """Group the blocks whose input has >= ``min_channels`` channels into
    maximal runs.  Two adjacent blocks chain when the blob between them is
    read only inside the second block (its own residual).  Stride-2 blocks
    join only with ``allow_down``, so that runs span whole backbone regions.

    Unset arguments resolve as the JAX package's ``plan_runs`` does:
    ``FFCNN_FUSED_MINC`` (default ``MIN_CHANNELS``) and ``FFCNN_FUSED_DOWN``
    (default off), through ``tuning.get_flag``."""
    if min_channels is None:
        min_channels = int(get_flag("FFCNN_FUSED_MINC", str(MIN_CHANNELS)))
    if allow_down is None:
        allow_down = get_flag("FFCNN_FUSED_DOWN", "0") == "1"
    blocks = find_fused_blocks(ir)
    eligible = [b for _, b in sorted(blocks.items())
                if ir.blobs[b.start].c >= min_channels
                and (allow_down or not b.down)]
    ref_layers: Dict[int, List[int]] = {}
    for li, l in enumerate(ir.layers):
        if l.type in (LayerType.ROUTE, LayerType.SHORTCUT):
            for d in l.depends:
                ref_layers.setdefault(d + 1, []).append(li)

    def chainable(prev: FusedBlock, nxt: FusedBlock) -> bool:
        if prev.end + 1 != nxt.start:
            return False
        return all(nxt.start <= li <= nxt.end
                   for li in ref_layers.get(nxt.start, []))

    runs: List[FusedRun] = []
    cur: List[FusedBlock] = []
    for b in eligible:
        if cur and chainable(cur[-1], b):
            cur.append(b)
        else:
            if cur:
                runs.append(FusedRun(cur[0].start, cur[-1].end, tuple(cur)))
            cur = [b]
    if cur:
        runs.append(FusedRun(cur[0].start, cur[-1].end, tuple(cur)))
    return runs


@dataclasses.dataclass(frozen=True)
class BlockParams:
    """One block's parameters in the kernel's float32 layouts."""
    w1: torch.Tensor      # (C, E)  expand
    s1: torch.Tensor      # (E,)
    b1: torch.Tensor
    kdw: torch.Tensor     # (E, 9)  depthwise taps, row-major (dy, dx)
    s2: torch.Tensor
    b2: torch.Tensor
    w2: torch.Tensor      # (E, P)  project
    s3: torch.Tensor      # (P,)
    b3: torch.Tensor
    acts: Tuple[int, int, int]
    residual: bool
    res_act: int


def block_params(ir: NetIR, params, b: FusedBlock) -> BlockParams:
    """Gather block ``b``'s three convs from a port params dict (OIHW
    weights, ``graph.build.params_from_numpy``)."""
    def get(li):
        p = params[li]
        return (p["weights"].float(), p["scale"].float().contiguous(),
                p["bias"].float().contiguous())
    w1, s1, b1 = get(b.start)
    kdw, s2, b2 = get(b.start + 1)
    w2, s3, b3 = get(b.start + 2)
    e, c = w1.shape[:2]
    return BlockParams(
        w1=w1.reshape(e, c).t().contiguous(), s1=s1, b1=b1,
        kdw=kdw.reshape(e, 9).contiguous(), s2=s2, b2=b2,
        w2=w2.reshape(w2.shape[0], e).t().contiguous(), s3=s3, b3=b3,
        acts=tuple(ir.layers[b.start + i].activation for i in range(3)),
        residual=b.residual, res_act=b.res_act)


def _block_f32(x: torch.Tensor, bp: BlockParams, stride: int,
               matmul=torch.matmul) -> torch.Tensor:
    """The block in plain PyTorch, float32 inside and out, NHWC; ``matmul``
    computes the two pointwise products."""
    xf = x.float()
    n, h, w, _ = x.shape
    ho, wo = h // stride, w // stride
    a = activate(matmul(xf, bp.w1) * bp.s1 + bp.b1, bp.acts[0])
    # the dw zero padding applies to the expand OUTPUT (pw of a zero row is
    # act(b1), not 0)
    a = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, ho, wo, a.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            # output row r reads padded rows stride*r + dy, i.e. input rows
            # stride*r - 1 .. stride*r + 1 (likewise columns)
            acc = acc + (a[:, dy:dy + stride * ho:stride,
                           dx:dx + stride * wo:stride]
                         * bp.kdw[:, dy * 3 + dx])
    h2 = activate(acc * bp.s2 + bp.b2, bp.acts[1])
    y = activate(matmul(h2, bp.w2) * bp.s3 + bp.b3, bp.acts[2])
    if bp.residual:
        y = activate(y + xf, bp.res_act)
    return y


def block_plain(x: torch.Tensor, bp: BlockParams,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The stride-1 block in plain PyTorch, float32 inside, NHWC in and
    out (in ``out_dtype``, default x's): what ``_make_kernel`` computes."""
    return _block_f32(x, bp, 1).to(out_dtype or x.dtype)


def block_down_plain(x: torch.Tensor, bp: BlockParams,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """The stride-2 block in plain PyTorch, float32 inside, NHWC (N, H, W,
    C) -> (N, H/2, W/2, P) for even H and W, in ``out_dtype`` (default
    x's): what ``_make_down_kernel`` computes (no residual)."""
    if bp.residual:
        raise ValueError("a stride-2 block has no residual")
    return _block_f32(x, bp, 2).to(out_dtype or x.dtype)


def chain_plain(x: torch.Tensor, bps: List[BlockParams],
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Stride-1 blocks chained in plain PyTorch, NHWC: float32 between the
    blocks, never rounded, and one cast at the end (to ``out_dtype``,
    default x's).  What ``_make_cascade_kernel`` computes for a group and
    ``_make_mega_kernel`` for a run: the plain version of K4 and of K5."""
    y = x
    for bp in bps:
        y = _block_f32(y, bp, 1)
    return y.to(out_dtype or x.dtype)


# ----------------------------------------------------------------- routing
def cascade_groups(run: FusedRun, k: int) -> List[List[FusedBlock]]:
    """The run's blocks in launch groups, as ``run_blocks_cs`` groups them
    for ``FFCNN_FUSED_CASCADE=k``: a stride-1 block joins the current group
    unless that group is full (k blocks) or ends in a stride-2 block; a
    stride-2 block is a group of its own.  ``k`` < 2: one block a group."""
    groups: List[List[FusedBlock]] = []
    for b in run.blocks:
        if (k > 1 and not b.down and groups and len(groups[-1]) < k
                and not groups[-1][-1].down):
            groups[-1].append(b)
        else:
            groups.append([b])
    return groups


# The JAX mega route's VMEM gate (``_mega_fits``), kept so both packages
# route the same runs: images per chunk and its float32 budget.
MEGA_NB = 128
_MEGA_VMEM_BUDGET = 72 << 20


def mega_fits(ir: NetIR, run: FusedRun) -> bool:
    """``ffcnn_tpu/kernels/block_fused.py::_mega_fits`` as IR math: two
    E-wide float32 stages of a 128-image chunk of the run's map, plus its
    input and output, within the TPU budget."""
    hh, ww = ir.blobs[run.start].h, ir.blobs[run.start].w
    emax = max(ir.layers[b.start].fn for b in run.blocks)
    s = ww * MEGA_NB
    need = 2 * hh * emax * (s + 2 * MEGA_NB) * 4
    need += 2 * hh * max(ir.blobs[run.blocks[0].start].c,
                         ir.blobs[run.end + 1].c) * s * 4
    return need <= _MEGA_VMEM_BUDGET


# Output tiles K1 and K3 accept (csrc/block_fused.cuh kMaxPix,
# max_halo<S>): at most 64 output pixels, and an input halo of at most 104
# pixels at stride 1, 160 at stride 2.
_TILE_MAX_PIX = 64
_TILE_MAX_HALO = {1: 104, 2: 160}
# A CTA's shared memory on sm_90 (csrc/block_fused.cuh kMaxSmem), and the
# blocks a chained launch takes (csrc/block_chain.cuh kMaxChain).
MAX_SMEM = 232448
MAX_CHAIN = 16


@functools.cache
def pick_tile(h: int, w: int, stride: int = 1) -> Tuple[int, int]:
    """The (TH, TW) tile of an (h, w) OUTPUT map that expands the fewest
    halo pixels over the map (ties go to the larger tile).  A tile's halo
    is (stride*TH + 3 - stride) x (stride*TW + 3 - stride) input pixels.
    Cached: every launch asks."""
    best = None
    for th in range(1, min(h, _TILE_MAX_PIX) + 1):
        for tw in range(1, min(w, _TILE_MAX_PIX // th) + 1):
            halo = ((stride * th + 3 - stride)
                    * (stride * tw + 3 - stride))
            if halo > _TILE_MAX_HALO[stride]:
                continue
            cost = -(-h // th) * -(-w // tw) * halo
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    return best[1]


# A chain's widths, (c, e, p) per block: what the chained kernels' shared
# memory and the tile searches depend on.
Widths = Tuple[Tuple[int, int, int], ...]


def _widths(bps: List[BlockParams]) -> Widths:
    return tuple((bp.w1.shape[0], bp.w1.shape[1], bp.w2.shape[1])
                 for bp in bps)


def _pad4(c: int) -> int:
    return -(-c // 4) * 4


def _proj_stride(p: int) -> int:
    g = 32 * (4 if p >= 128 else -(-p // 32))
    return -(-p // g) * g


def _chunk_floats(widths: Widths, halo: int, pix: int) -> int:
    """The chunk buffers of csrc/block_chain.cuh: the expand and project
    weight chunks, the expanded halo and the dw output (32 channels)."""
    cpin = max(_pad4(c) for c, _, _ in widths)
    psmax = max(_proj_stride(p) for _, _, p in widths)
    return 32 * (cpin + psmax + halo + -(-pix // 64) * 64)


def cascade_smem(widths: Widths, th: int, tw: int) -> int:
    """Bytes of shared memory K4 needs at output tile (th, tw), as
    ``cascade_smem`` in ``csrc/block_chain.cuh`` lays it out: block
    j reads a map of (th + 2(k-j)) x (tw + 2(k-j)) pixels from one of two
    float32 buffers and writes one pixel ring smaller into the other."""
    k = len(widths)
    chans = [widths[0][0]] + [p for _, _, p in widths]
    bufs = [0, 0]
    for j in range(k + 1):
        r = k - j
        bufs[j % 2] = max(bufs[j % 2],
                          (th + 2 * r) * (tw + 2 * r) * _pad4(chans[j]))
    return 4 * (sum(bufs) + _chunk_floats(
        widths, (th + 2 * k) * (tw + 2 * k),
        (th + 2 * k - 2) * (tw + 2 * k - 2)))


def mega_smem(widths: Widths, h: int, w: int, th: int, tw: int) -> int:
    """Bytes of shared memory K5 needs for an (h, w) map at output tile
    (th, tw), as ``mega_smem`` in ``csrc/block_chain.cuh`` lays it out:
    two float32 maps with a one-pixel border, and one tile's chunks."""
    cpm = max(max(_pad4(c) for c, _, _ in widths), _pad4(widths[-1][2]))
    return 4 * (2 * (h + 2) * (w + 2) * cpm
                + _chunk_floats(widths, (th + 2) * (tw + 2), th * tw))


def _cut_tiles(h: int, w: int, th: int, tw: int):
    """(rows, cols, count) of the tiles of an (h, w) map at (th, tw), cut
    at the map's bottom and right edges."""
    for rows, nr in ((th, h // th), (h % th, int(h % th > 0))):
        for cols, nc in ((tw, w // tw), (w % tw, int(w % tw > 0))):
            if nr and nc:
                yield rows, cols, nr * nc


def _cascade_cost(widths: Widths, th: int, tw: int) -> int:
    """Multiply-adds of one (th, tw) tile of K4, E counted in whole chunks
    of 32: each block expands its input map and projects its output map."""
    k, cost = len(widths), 0
    for j, (c, e, p) in enumerate(widths):
        r = k - j
        nin = (th + 2 * r) * (tw + 2 * r)
        nout = (th + 2 * r - 2) * (tw + 2 * r - 2)
        cost += -(-e // 32) * 32 * (nin * _pad4(c) + nout * (9 + p))
    return cost


# A CTA's shared memory comes out of its SM's 228 KB, with 1 KB more for
# each resident CTA; an H100 has 132 SMs.  Two CTAs of a chained launch on
# one SM ran 1.0-1.9x as many multiply-adds a second as one alone on xl's
# seven cascade groups at batch 64 and 256 (H100 80GB HBM3, 700 W); the
# tile search takes 1.3.
_SM_SMEM, _CTA_SMEM_EXTRA, _SMS = 233472, 1024, 132
_SM_SPEED = {1: 1.0, 2: 1.3}


def _least_cost_tile(h: int, w: int, widths: Widths, budget: int):
    """The tile of least multiply-adds over an (h, w) map, halo recompute
    included, within ``budget`` bytes of shared memory (ties go to the
    larger tile), and that cost; (None, 0) if no tile fits."""
    best = None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if cascade_smem(widths, th, tw) > budget:
                break                   # grows with tw
            cost = sum(n * _cascade_cost(widths, r, c)
                       for r, c, n in _cut_tiles(h, w, th, tw))
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    return (None, 0) if best is None else (best[1], best[0][0])


@functools.cache
def pick_cascade_tile(h: int, w: int, widths: Widths, n: int = 1
                      ) -> Optional[Tuple[int, int]]:
    """K4's (TH, TW) output tile for a group on an (h, w) map at batch n:
    of the least-cost tiles that let one or two CTAs share an SM, the one
    whose waves of CTAs take the least time at that many a SM.  None if no
    tile fits.  Cached: every launch asks."""
    best = None
    for m, speed in _SM_SPEED.items():
        tile, cost = _least_cost_tile(
            h, w, widths, min(MAX_SMEM, _SM_SMEM // m - _CTA_SMEM_EXTRA))
        if tile is None:
            continue
        per_image = -(-h // tile[0]) * -(-w // tile[1])
        waves = -(-n * per_image // (_SMS * m))
        est = waves * m * cost / per_image / speed
        if best is None or est < best[0]:
            best = (est, tile)
    return None if best is None else best[1]


@functools.cache
def pick_mega_tile(h: int, w: int, widths: Widths
                   ) -> Optional[Tuple[int, int]]:
    """K5's (TH, TW) output tile, walked over the resident (h, w) map: the
    fewest halo pixels expanded over the map within a CTA's shared memory
    (the whole map where it fits); ties go to the larger tile.  None if the
    two maps alone do not fit.  Cached: every launch asks."""
    best = None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if mega_smem(widths, h, w, th, tw) > MAX_SMEM:
                break
            cost = sum(n * (r + 2) * (c + 2)
                       for r, c, n in _cut_tiles(h, w, th, tw))
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    return None if best is None else best[1]


def check_chain_fits(h: int, w: int, bps: List[BlockParams],
                     mega: bool = False, n: int = 1) -> Tuple[int, int]:
    """The tile K4 (or, with ``mega``, K5) takes for the chain on an (h, w)
    map at batch n; raise if the chain cannot run on the card (``Net`` asks
    for every group and mega run when it is built on the card)."""
    widths = _widths(bps)
    if len(bps) > MAX_CHAIN:
        raise ValueError(f"a chain of {len(bps)} blocks; the kernels take "
                         f"at most {MAX_CHAIN}")
    tile = (pick_mega_tile(h, w, widths) if mega
            else pick_cascade_tile(h, w, widths, n))
    if tile is None:
        need = mega_smem(widths, h, w, 1, 1) if mega else \
            cascade_smem(widths, 1, 1)
        raise ValueError(f"the {'mega' if mega else 'cascade'} chain "
                         f"{widths} on a {h}x{w} map needs {need} bytes of "
                         f"shared memory at its smallest tile, more than "
                         f"the {MAX_SMEM} a CTA has on sm_90")
    return tile


# ---------------------------------------------------------------- wrappers
_DTYPES = (torch.float32, torch.bfloat16)


def _check_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda" or x.dim() != 4 or not x.is_contiguous() \
            or x.dtype not in _DTYPES:
        raise ValueError(f"x must be a contiguous NHWC float32/bfloat16 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _check_params(bp: BlockParams, c: int, device) -> None:
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    shapes = {"w1": (c, e), "s1": (e,), "b1": (e,), "kdw": (e, 9),
              "s2": (e,), "b2": (e,), "w2": (e, p), "s3": (p,), "b3": (p,)}
    for name, shape in shapes.items():
        t = getattr(bp, name)
        if (t.device != device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if bp.residual and p != c:
        raise ValueError(f"residual block needs P == C, got {p} != {c}")


def _check(x: torch.Tensor, bps: List[BlockParams], out_dtype) -> None:
    """Raise on what the kernels do not take: a chain's widths must link
    up, each block's params must lie beside x."""
    _check_x(x)
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    c = x.shape[-1]
    for bp in bps:
        _check_params(bp, c, x.device)
        c = bp.w2.shape[1]


def _params_ptrs(bp: BlockParams):
    return (bp.w1.data_ptr(), bp.s1.data_ptr(), bp.b1.data_ptr(),
            bp.kdw.data_ptr(), bp.s2.data_ptr(), bp.b2.data_ptr(),
            bp.w2.data_ptr(), bp.s3.data_ptr(), bp.b3.data_ptr())


def _is_bf16(dtype) -> int:
    return int(dtype == torch.bfloat16)


def fused_block(x: torch.Tensor, bp: BlockParams,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One stride-1 block (K1), NHWC (N, H, W, C) -> (N, H, W, P) in
    ``out_dtype`` (default x's).

    CPU tensors take ``block_plain``; CUDA tensors launch the kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return block_plain(x, bp, out_dtype)
    _check(x, [bp], out_dtype)
    n, h, w, c = x.shape
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    th, tw = pick_tile(h, w)
    y = torch.empty((n, h, w, p), dtype=out_dtype, device=x.device)
    lib = build()
    err = lib.ffcnn_block_s1(
        x.data_ptr(), y.data_ptr(), _is_bf16(x.dtype), _is_bf16(out_dtype),
        *_params_ptrs(bp), n, h, w, c, e, p, *bp.acts, int(bp.residual),
        bp.res_act, th, tw, _build.stream_ptr())
    fused_block.launches += 1
    if err:
        raise RuntimeError("fused block launch failed: "
                           + lib.ffcnn_block_error_string(err).decode())
    return y


fused_block.launches = 0


def fused_down_block(x: torch.Tensor, bp: BlockParams,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """One stride-2 block (K3), NHWC (N, H, W, C) -> (N, H/2, W/2, P) in
    ``out_dtype`` (default x's); H and W must be even.

    CPU tensors take ``block_down_plain``; CUDA tensors launch the
    kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return block_down_plain(x, bp, out_dtype)
    _check(x, [bp], out_dtype)
    n, h, w, c = x.shape
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    if h % 2 or w % 2 or bp.residual:
        raise ValueError(f"a stride-2 block needs even H and W and no "
                         f"residual, got {h}x{w}, residual={bp.residual}")
    th, tw = pick_tile(h // 2, w // 2, 2)
    y = torch.empty((n, h // 2, w // 2, p), dtype=out_dtype,
                    device=x.device)
    lib = build_down()
    err = lib.ffcnn_block_s2(
        x.data_ptr(), y.data_ptr(), _is_bf16(x.dtype), _is_bf16(out_dtype),
        *_params_ptrs(bp), n, h, w, c, e, p, *bp.acts, th, tw,
        _build.stream_ptr())
    fused_down_block.launches += 1
    if err:
        raise RuntimeError("fused stride-2 block launch failed: "
                           + lib.ffcnn_down_error_string(err).decode())
    return y


fused_down_block.launches = 0


def _chain_args(bps: List[BlockParams]):
    """The chained kernels' description of the blocks: 8 ints a block (c e
    p act1 act2 act3 residual res_act) and 9 weight pointers a block."""
    meta, ptrs = [], []
    for (c, e, p), bp in zip(_widths(bps), bps):
        meta += [c, e, p, *bp.acts, int(bp.residual), bp.res_act]
        ptrs += _params_ptrs(bp)
    return ((ctypes.c_int * len(meta))(*meta),
            (ctypes.c_void_p * len(ptrs))(*ptrs))


def fused_cascade(x: torch.Tensor, bps: List[BlockParams],
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A group of stride-1 blocks in one launch (K4), NHWC (N, H, W, C) ->
    (N, H, W, P of the last block) in ``out_dtype`` (default x's); the
    boundaries inside the group stay float32.

    CPU tensors take ``chain_plain``; CUDA tensors launch the kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return chain_plain(x, bps, out_dtype)
    _check(x, bps, out_dtype)
    n, h, w, _ = x.shape
    th, tw = check_chain_fits(h, w, bps, n=n)
    y = torch.empty((n, h, w, bps[-1].w2.shape[1]), dtype=out_dtype,
                    device=x.device)
    lib = build_cascade()
    err = lib.ffcnn_cascade(
        x.data_ptr(), y.data_ptr(), _is_bf16(x.dtype), _is_bf16(out_dtype),
        n, h, w, len(bps), *_chain_args(bps), th, tw, _build.stream_ptr())
    fused_cascade.launches += 1
    if err:
        raise RuntimeError("cascade launch failed: "
                           + lib.ffcnn_cascade_error_string(err).decode())
    return y


fused_cascade.launches = 0


def fused_mega(x: torch.Tensor, bps: List[BlockParams]) -> torch.Tensor:
    """A whole run of stride-1 blocks in one launch (K5), NHWC (N, H, W, C)
    -> (N, H, W, P of the last block) in x's dtype; every boundary stays
    float32.

    CPU tensors take ``chain_plain``; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return chain_plain(x, bps)
    _check(x, bps, x.dtype)
    n, h, w, _ = x.shape
    th, tw = check_chain_fits(h, w, bps, mega=True)
    y = torch.empty((n, h, w, bps[-1].w2.shape[1]), dtype=x.dtype,
                    device=x.device)
    lib = build_mega()
    err = lib.ffcnn_mega(x.data_ptr(), y.data_ptr(), _is_bf16(x.dtype), n,
                         h, w, len(bps), *_chain_args(bps), th, tw,
                         _build.stream_ptr())
    fused_mega.launches += 1
    if err:
        raise RuntimeError("mega run launch failed: "
                           + lib.ffcnn_mega_error_string(err).decode())
    return y


fused_mega.launches = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _load(name: str, entry: str, argtypes, errors: str) -> ctypes.CDLL:
    lib = _build.load_library(name)
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = _INT
    getattr(lib, errors).argtypes = [_INT]
    getattr(lib, errors).restype = ctypes.c_char_p
    return lib


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load K1's library."""
    return _load("block_fused", "ffcnn_block_s1",
                 [_PTR, _PTR, _INT, _INT] + [_PTR] * 9 + [_INT] * 13
                 + [_PTR], "ffcnn_block_error_string")


@functools.cache
def build_down() -> ctypes.CDLL:
    """Build (if needed) and load K3's library."""
    return _load("block_down", "ffcnn_block_s2",
                 [_PTR, _PTR, _INT, _INT] + [_PTR] * 9 + [_INT] * 11
                 + [_PTR], "ffcnn_down_error_string")


@functools.cache
def build_cascade() -> ctypes.CDLL:
    """Build (if needed) and load K4's library."""
    return _load("block_cascade", "ffcnn_cascade",
                 [_PTR, _PTR] + [_INT] * 6 + [ctypes.POINTER(_INT),
                                              ctypes.POINTER(_PTR)]
                 + [_INT, _INT, _PTR], "ffcnn_cascade_error_string")


@functools.cache
def build_mega() -> ctypes.CDLL:
    """Build (if needed) and load K5's library."""
    return _load("block_mega", "ffcnn_mega",
                 [_PTR, _PTR] + [_INT] * 5 + [ctypes.POINTER(_INT),
                                              ctypes.POINTER(_PTR)]
                 + [_INT, _INT, _PTR], "ffcnn_mega_error_string")


# ------------------------------------------------------------ entry points
def run_blocks(x: torch.Tensor, run: FusedRun, bps: List[BlockParams],
               groups: Optional[List[List[FusedBlock]]] = None,
               mid_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A run's blocks group by group, as ``run_blocks_cs`` runs them: a
    group of several blocks is one K4 launch, a single block one K1 (stride
    1) or K3 (stride 2) launch.  ``groups``: ``cascade_groups(run, k)``
    (default one block a group).  The boundaries between groups are stored
    in ``mid_dtype`` (default x's; float32 with ``FFCNN_FUSED_STORE=f32``),
    the run's output in x's dtype.  ``bps``: the run's ``block_params``,
    one per block, prepared once."""
    if len(bps) != len(run.blocks):
        raise ValueError(f"{len(bps)} block params for {len(run.blocks)} "
                         f"blocks")
    if groups is None:
        groups = cascade_groups(run, 0)
    if [b for g in groups for b in g] != list(run.blocks):
        raise ValueError(f"groups {groups} do not partition run {run}")
    final, i = x.dtype, 0
    for gi, g in enumerate(groups):
        od = final if gi == len(groups) - 1 else (mid_dtype or final)
        gbps, i = bps[i:i + len(g)], i + len(g)
        if len(g) > 1:
            x = fused_cascade(x, gbps, od)
        elif g[0].down:
            x = fused_down_block(x, gbps[0], od)
        else:
            x = fused_block(x, gbps[0], od)
    return x


def apply_run(x: torch.Tensor, run: FusedRun, bps: List[BlockParams], *,
              groups: Optional[List[List[FusedBlock]]] = None,
              mega: bool = False,
              mid_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Run a chain of fused blocks on an NHWC blob.  ``mega``: the whole run
    in one K5 launch (every block stride 1; the caller routes the runs
    where the mega flag is set and ``mega_fits`` holds, as the JAX
    ``apply_run`` does); else ``run_blocks`` with ``groups`` and
    ``mid_dtype``.  ``bps``: the run's ``block_params``, one per block,
    prepared once (the JAX ``apply_run(x, ir, params, run)`` gathers them
    inside its trace; eagerly that would cost copies every forward)."""
    if not mega:
        return run_blocks(x, run, bps, groups, mid_dtype)
    if len(bps) != len(run.blocks) or any(b.down for b in run.blocks):
        raise ValueError(f"the mega route takes one params per block and "
                         f"stride-1 blocks only, got {len(bps)} params for "
                         f"run {run}")
    return fused_mega(x, bps)
