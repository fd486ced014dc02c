#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ffcnn_tpu_torch``) on one NVIDIA
card.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``; ``CUDA_HOME``
defaults to /usr/local/cuda).  Four fast-mode paths are driven on
yolo-fastest-xl at 320x320 with synthesized weights (seed 42):

* default: 13 stride-1 blocks through K1;
* region (``FFCNN_FUSED_DOWN=1 FFCNN_FUSED_MINC=8 FFCNN_CONV0_PALLAS=1
  FFCNN_FUSED_HEADS=1``): the uint8 stem K6, 20 K1 and 4 stride-2 K3
  blocks, the head chain K7;
* cascade (the region flags and ``FFCNN_FUSED_CASCADE=3``): K6, 7 groups
  of 2-3 blocks through the halo cascade K4, 2 K1 and 4 K3 blocks, K7;
* mega (``FFCNN_FUSED_MEGA=1``): run 84-108 in one K5 launch, 8 K1 blocks.

Two int8-mode paths (phase 12) run the same model under one calibrated
plan: int8 default (29 convs through the int8 conv, ``csrc/conv_int8.cu``,
and K1 with int8 boundaries) and int8 region (9 int8 convs, K6, K1 and K3).

K1, K3, K4 and K5 run both pointwise products on the tensor cores
(``mma.sync`` in 3xTF32, ``csrc/tf32_mma.cuh``); K4 and K5 keep every
boundary of their chain in shared memory in float32, K5 with a cluster of
two CTAs an image while the batch leaves SMs idle.

K7 runs its pointwise stages on the tensor cores too, with a cluster of
two CTAs an image while the batch leaves SMs idle.  The region
configuration is also built at 416x416 (the 13x13 head chain, whose stage
buffers leave shared memory for device memory with one CTA an image) and
at 96x96 (xl's two head chains there, 3x3 C192 and 6x6 C240).  Then the
block A/B bench (``ffcnn_tpu_torch/bench_block.py``) runs its two parts:
the seven configs of ``tools/bench_block.py`` at batch 256 and the 24
blocks of xl's region plan at batch 64, each through K8 and (stride 1)
K9.  Phases, each of which exits non-zero on failure:

  1. the card's name and power limit (nvidia-smi)
  2. build every kernel from ffcnn_tpu_torch/csrc/ (one nvcc per source,
     all started together)
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it, batch 64 (K4 every group, K5 at both
     cluster sizes; K7 at 10x10 and 13x13 at batch 64, a cluster of two,
     at batch SMs / 2 + 1, one CTA an image, and at batch 1, and the two
     chains at 96x96 at both cluster sizes; K6 on xl's stem at batch 64
     and 1, and on seeded stems of F 8, 16, 32 (its compiled instances),
     20 and 16 with relu (its generic one) at 320x320, 416x416 and 322x322,
     whose rows are not 16-byte aligned; K2 bit for bit, card and CPU, at
     K 1, 31, 32, 33, 128 and 1,500, batch 1 and 64, on random candidates,
     suppression chains across its 32-anchor blocks and one class, min and
     union IoU, and at K 9,000 on the card, past what it stages)
  4. each path: ``detect`` on a batch of 64 frames and on one 640x448
     frame, with every kernel launch count read around the call, which
     builds the bucket (two eager warm-up runs and the CUDA graph's
     capture launch through the wrappers) and replays it; then a second
     ``detect`` of each, a replay alone, with the kernels the card ran
     counted by torch.profiler from their symbols: one forward's, as many
     as an eager run of the pipeline ran and launched, and no launch from
     Python; heads and detections against the same Net on the CPU; the
     region Net at 416x416 likewise
  5. parity mode on the card (a bucket per K as it grows K) against
     parity mode on the CPU, and whether it equals the eager card path
     bit for bit
  6. timings with CUDA events: kernels against their plain versions (K1
     and K3 also by geometry, in us a block; K4 by group, with the work
     its halo recompute adds; K5 at one CTA an image and at a cluster of
     two, batch 64, 66, 67, 128 and 256; each with its tile, CTAs, us a
     block and ratio to the K1 launches they replace; K7 at 10x10 and
     13x13, batch 64 and 256, also against the cuDNN chain of its five
     layers; K6 at 320x320 and K2 at K 128 and 1,500, also by the
     kernel's device time alone, by torch.profiler, and K6 alone at
     320x320 in float32 and at 416x416 and 322x322), the whole forward of
     every path; ``detect_device`` at batch 1, 64 and 256 on every path
     (a bucket's replay), and for default and region also the eager
     pipeline (the parent's ``detect_device``), in turns, each with its
     host CPU and device time by torch.profiler
  7. the block bench: its kernel pass with the K8 and K9 launch counts
     read around it (one launch a case each), its report (each kernel
     against its plain version, the three-conv cuDNN chain and K1/K3, with
     times), then every case again in float32 against the plain versions;
     last, K8 alone at the tool's configs and K9 alone at their five
     stride-1 configs (20 launches in one CUDA graph, its replays between
     CUDA events), and K9 alone beside K1 alone at xl's 20 stride-1 region
     blocks
  8. the probe kernels of tools/, each behind the port of its probe, with
     its launches read around its probe's pass: P1 and P2 (the dense 1x1
     product, ``bench_pw_kernels.py``: one launch each at the tool's
     shapes, at the tool's M - 1 and at M = 1,000, each against the plain
     version and torch.mm; an (8, 64) product refused before any launch;
     then the tool's rows A, D, B, C timed, B and C also by the kernel's
     device time alone); P3 (the block variants, ``bisect_smallc.py``: every
     mode at the tool's four geometries in float32 and bf16 against its
     plain version at batch 64, and ``full`` bit for bit against K1,
     whose template it launches, then each mode chained 20 times at batch
     256 in bf16, counted and timed beside the cuDNN chain and the layout
     round trip, and each mode alone in a CUDA graph); P4 and P5
     (``retest_backend_bugs.py``: bit-exact, timed by events and alone, 20
     launches in one CUDA graph, beside ``x[::2].contiguous()`` and
     ``x.index_select(0, rows)`` on P5's row map both ways); P4 also at
     (65,536, 128), where bytes matter, timed alone beside the strided
     copy, and on its 2-byte path (an odd R, C % 8 != 0, an unaligned
     view), each launch's width, block and grid as the kernel reports them
     against ``mosaic_probes.strided_plan``
  9. serving (its ``detect_stream`` and server parts run after phase 5,
     before the timings, whose traces torch.profiler's counts must
     precede; its ``memory_stats`` and sync-debug parts run last): on
     every path ``detect_stream`` at depth 2 and 3 over four
     batches of one bucket, the kernels it ran counted by torch.profiler,
     against serial ``detect``; the region bucket's ``memory_stats`` at
     batch 1 and 64 (peak >= args + output) and a replay under sync-debug
     mode "error"; then the HTTP server (``ffcnn_tpu_torch/serve.py``) on
     the region Net, its batch buckets 1-64 warmed: 96 concurrent POST
     /detect from 32 threads (the fixture BMP and seeded frames), the
     kernels the card ran counted around them, each answer held against
     the eager card path's candidates, /statz read
 10. the command line (``ffcnn_tpu_torch/cli.py``) through ``cli.main``,
     on the card: ``detect`` in parity and fast mode (its score lines
     against ``Net.detect``'s, its output BMP against ``draw_rectangle``'s
     bytes), ``dump`` against ``Net.dump``, ``roofline`` and ``profile`` at
     batch 64 under the region flags (``Net.profile_layers``: every K1, K3,
     K6 and K7 event in its layer range, K2 outside them; the ten largest
     rows and the bucket's replay time), a strided batch through the
     region stem bit for bit with the dense one, ``batch`` over three BMPs
     against ``Net.detect``; the cost of a layer range to the eager path;
     a 1 GiB copy's rate; then the port's bench
     (``ffcnn_tpu_torch/bench.py``, ``--batches 64,256 --windows 3
     --iters 10``)
     with no flag and with the region flags, each printing its JSON line
 11. YOLOv8n at 640x640 (``ffcnn_tpu_torch/yolov8.py``: a state dict from
     ``synthesize_state_dict(80, "n", seed=0)``, converted with its heads'
     score gate at 0.10): its checks run after phase 9's server, before
     the timings' traces; its ``detect_device`` timings run last.  Parity
     on the card against parity on the CPU (two seeded frames and the
     letterboxed fixture): the synthesized v8n ties scores, so every
     pre-NMS candidate (class, score to 1e-4, box to 1e-4 of the range)
     and the card's tail on the CPU's candidates bit for bit
     (``bench.parity_candidates``); fast on the card against the CPU
     (phase 4's tolerances); the first fast detect's launches (K2 alone,
     the bucket built) and a replay's kernels against an eager run's (K2
     once a call); K2 in union IoU bit for bit against its plain version
     at K 128 and 2,048 (batch 1 and 64) and 8,400 (batch 64, past the
     8,192 candidates it stages), each timed at batch 64 (events, alone,
     the plain call, bound); ``forward_features`` in two segments at two
     cuts bit for bit with the whole forward, xl and v8n in parity; xl's
     region Net under ``FFCNN_HEAD_F32=1`` and under
     ``FFCNN_F32_STAGES=20``, its launches equal to its plan after the
     drop and its detections held to the CPU's; ``cli convert-v8`` on a
     saved state dict, then ``cli detect`` and ``cli roofline`` on its
     files.  Last, v8n's ``detect_device`` at batch 1 and 64, fast and
     parity, bucket and eager, with host CPU and device time
 12. int8 mode (``Net(mode="int8")``, ``quant.py``), its checks after phase
     11's, its timings last: ``Net.calibrate`` on the card against the CPU
     on 8 seeded frames (blob scales to 1e-5, wq codes 99.9% equal); the
     int8 conv (``csrc/conv_int8.cu``) against its plain version at batch
     64 on every unfused int8 conv of xl's default plan (29: 16 dense 1x1
     on the gemm path, 13 depthwise 3x3 and 5x5 on the dw path), the
     seeded dense convs (3x3 at stride 1 and 2, C64->128 SiLU; a
     per-channel requantize; 1x1 to F 272, 240 and 16 and from K 384 at
     odd sizes; C40 on the first dense kernel) and the seeded depthwise
     convs (C40 on dw4; 3x3 at stride 2 and 5x5 at odd sizes; SiLU with a
     per-channel requantize), then v8n's distinct unfused int8 convs under
     its plan at batch 4: int32 accumulators bit for bit, codes equal or
     one apart at a tie of the plain version's float32 value, each call's
     path (``conv_int8.routes``) the one ``conv_int8.route`` names; each
     of xl's shapes timed alone (20 launches in one CUDA graph, its
     replays between CUDA events), the plain version by events, the 1x1
     ones beside ``torch._int_mm`` with the epilogue, and v8n's shapes
     summed at batch 16; K1 (run 84-108 block by block), K4 (in groups
     of three) and K3 (block 81) with the plan's int8 boundaries against
     their plain versions, timed beside the same launches with bf16
     boundaries; int8
     default and int8 region on the card against the CPU under one plan
     installed with ``set_quant_plan`` (the first detect's launches equal
     to the plan's: the int8 conv on each unfused int8 conv, on default 16
     a forward through gemm and 13 through dw, K1/K3/K6 as the plan, K5 =
     K7 = 0; a replay's kernels equal an eager run's;
     phase 4's tolerances); v8n at 640x640 in int8 on one frame, card
     against CPU; ``cli detect --mode int8`` against ``Net.detect``;
     ``serve --mode int8 --quant-plan`` with a saved plan, four POSTs
     against ``Net.detect``.  Last, ``detect_device`` of both int8 nets at
     batch 1 and 64, bucket and eager, with host CPU and device time.
     Phase 10's bench runs its int8 gate and its informational int8 row.
     Conv-1 in int8 (``FFCNN_CONV0_INT8=1``), its checks after phase 12's:
     the int8 conv's uint8 mode against its plain version at xl's stem,
     320x320 and 322x322, batch 64 (accumulators, float32 and bf16 outputs
     bit for bit); the region Net under the flag (the uint8 mode once a
     forward, K6 none), a replay's kernels equal to an eager run's, held to
     the CPU by phase 4's tolerances; last, its time beside K6 and the
     cuDNN stem (graph replays) and the region ``detect_device`` at batch
     64 with and without the flag.
 13. export (``export.py``): xl's region fast Net at batch 1 and 64, the
     parity Net and the int8 default Net (phase 12's plan) at batch 1, each
     exported (time, ``.pt2`` size, its ``ffcnn::`` ops; region fast and
     parity at batch 1 with ``platforms=("cuda", "cpu")``, their size
     against the card program's alone), loaded here and held to
     ``Net.detect_device`` bit for bit on seeded frames, then all four
     loaded in one fresh process that imports only the export module
     (load time, ``verify_artifact``, its results against this process's:
     bit for bit or within the probe tolerances, which is logged), and
     beside it the two two-platform files in a process with
     ``CUDA_VISIBLE_DEVICES=""`` that imports only the export module (its
     platforms, load time, ``verify_artifact`` on the CPU program): bit for
     bit with the CPU Net's ``detect_device``, parity's paired with the
     card's (phase 5); each artifact's replay (``ArtifactNet``, one CUDA
     graph) against the Net bucket's, in turns.  Then the float32 knobs:
     the region Net under ``FFCNN_HEAD_F32=1``, ``FFCNN_F32_STAGES=20`` and
     both, each exported at batch 1 (head_f32 also at 64; time, size, ops),
     its program holding ``ffcnn::conv2d_f32`` once a forced conv and K7
     under stage 20 alone, held to ``Net.detect_device`` under the same
     flags (bit for bit, or the largest difference logged and phase 4's
     tolerances), its replay timed against the bucket's.
 14. multi-device (``ffcnn_tpu_torch/parallel/``), every mesh over slots
     of cuda:0, its checks after phase 12's, its timings last: ``DPNet``
     over the region Net on two slots and on ``make_mesh()``, at batch 64
     and 63 (padded), the replicas' launches counted as their buckets are
     built and a replay's kernels by torch.profiler, each shard bit for
     bit with ``Net.detect_device`` at the shard's batch, the whole batch
     bit for bit or by phase 4's tolerances (logged); the sharded parity
     pipeline on a (2, 2, 2) mesh with the filters sharded, and PP over 2
     and 4 stages, against the parity Net (phase 5's pairing), K2 their
     only kernel; ``cli bench --dp`` and ``--sp 2`` (one slot a card, the
     card repeated for ``--sp``); ``serve --dp`` with four concurrent
     POSTs; two processes through
     ``init_distributed``, ``global_batch`` and ``local_results`` (this
     script with ``--mp-worker``), each bit for bit with its own Net.
     Last, ``detect_device`` of the region Net at batch 64 against DP over
     one and two slots, in turns, each replica's ``memory_stats``, PP's
     step at 2 and 4 stages, 4 and 8 microbatches, against the serial
     parity forward, and the sharded parity pipeline over SP 2 and TP 2
     against one slot.
 15. the BMP codec (``ffcnn_tpu_torch/native/bmp_codec.c``, built by gcc at
     its first use into ``ffcnn_tpu_torch/_build/``) on the card's host,
     after phase 10 (whose ``detect`` and ``batch`` already decode through
     it): the library loaded from ``_build/``; 256 seeded 320x320 frames
     written by ``bmp_save``, four bit for bit against ``bmp_save_plain``;
     ``load_batch`` of 64 bit for bit against ``load_batch_plain`` (the
     thread pool), both timed (median of 10 after a warm-up, the page cache
     warm) with the host's cores; ``cli batch`` over the 256 frames at
     ``--batch 64`` under the region flags, its lines against
     ``Net.detect``'s and the kernels K1, K2, K3, K6 and K7 counted around
     it, its img/s beside the loader's and ``detect_device``'s ms a chunk;
     ``Net.load`` of xl from the weights file, median of 3.

 16. the rest of the Darknet zoo through ``Net``: yolov3-tiny, yolov4-tiny,
     yolov3 and yolov4, each at its cfg's 416x416 with weights from
     ``synth_weights_bytes(seed 42, obj_bias 2.0)``, in a process of its
     own (this script with ``--zoo``, which also runs the phase alone)
     started once the build has ended: parity on the card (K grown a
     bucket a rung, past K2's 8,192 staged candidates on yolov3 and
     yolov4) against the CPU on two seeded frames and the letterboxed
     fixture, by detections (yolov4-tiny and yolov4, whose synthetic
     scores tie: their candidates and the card's tail on the CPU's, the
     ties logged), each replay bit for bit with the eager card path; fast
     mode (K2 alone, once a forward; a replay's kernels equal to an eager
     run's; heads and detections against the CPU on one frame); fast under
     ``FFCNN_CONV0_INT8=1`` (the u8 path once a forward, the Net's stem
     against its plain version, mish within C0Q_MISH_ULPS); int8
     (calibration card vs CPU, every distinct unfused int8 conv shape at
     batch 4 against its plain version with its path, the int8 Net under
     one plan against the CPU).  Then its timings: each model's fast
     ``memory_stats`` at batch 64 and 256, its bucket's ``detect_device``
     at batch 64 in fast, parity and int8 mode (device time by events,
     host enqueue time); for yolov4 also at batch 1 and the eager pipeline
     beside it (host CPU and device time by torch.profiler), and its
     ``profile_layers`` at batch 64 with the ten largest rows; last the
     port's bench once on yolov4 (``--parity-gate candidates --batches 64
     --windows 3 --iters 10``), its JSON line printed.  It logs its
     seconds against its 200 s budget.
Before the last line comes one JSON object with every kernel's name,
source, launches, error, time, plain time and bound (the least time an
H100 could take for the same work, ``bench_block.Work``), K1-K9 and
P1-P5 (K1, K3, K7, K8 and K9 also with the cuDNN chain's time at their
shapes, K7 with its 13x13 time and its cluster size at batch 64, K6, K2,
P1, P2, P4, P5, K8 and K9 with the kernel's device time alone (P4 beside
``x[::2].contiguous()``'s and P5 beside ``index_select``'s,
``library_alone_ms``; K9 also at xl's 20 stride-1 blocks beside K1), K2
with its times and bound
at K 1,500 too and in union IoU at K 128, 2,048 and 8,400; K1-K7's
launches are their wrappers' counts over phase 4's first detect on the
region, cascade and mega paths, which builds the bucket; K1, K3 and K4
also with their int8-boundary times; the int8 conv, its launches counted
over phase 12's first int8 default detect (also by path), its times summed
over xl's 29 unfused int8 convs (also split into the 13 depthwise and the
16 1x1 convs, each beside its bound) and over v8n's distinct ones at batch
16; its uint8 mode, conv-1 in int8, at xl's stem, its
launches counted over the region Net's first detect under the flag);
the line before it is the card's name and power
limit; the last line of standard output is one JSON object with the
device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import struct
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "models", "yolo-fastest-xl.cfg")
BMP = os.path.join(REPO, "tests", "fixtures", "test320.bmp")
SEED = 42
BATCH = 64
NMS_KS = (128, 1500)        # fast mode's top-k, and xl's candidate count
NMS_CHECK_KS = (1, 31, 32, 33) + NMS_KS   # K2's blocks are 32 anchors
NMS_LARGE_K = 9000          # above the 8,192 candidates K2 stages
# K6's seeded stems (F, activation) and sizes beside xl's stem: the
# compiled instances (F 8, 16, 32, leaky), the generic one (F 20; F 16
# relu); 322 * 3 bytes a row is not a multiple of 16 (the word copy)
K6_STEMS = ((8, 2), (16, 2), (20, 2), (32, 2), (16, 1))
K6_SIZES = (320, 416, 322)
K6_TIMED = ((320, "float32"), (416, "bfloat16"), (322, "bfloat16"))
REGION_FLAGS = {"FFCNN_FUSED_DOWN": "1", "FFCNN_FUSED_MINC": "8",
                "FFCNN_CONV0_PALLAS": "1", "FFCNN_FUSED_HEADS": "1"}
PATH_FLAGS = {"default": {}, "region": REGION_FLAGS,
              "cascade": {**REGION_FLAGS, "FFCNN_FUSED_CASCADE": "3"},
              "mega": {"FFCNN_FUSED_MEGA": "1"}}
# the cascade path's launch groups (by their blocks' expand layers)
CASCADE_GROUPS = [[1, 4], [9], [12, 17], [22], [25, 30, 35], [38, 43, 48],
                  [53], [58], [61, 66, 71], [76], [81], [84, 89, 94],
                  [99, 104]]
# the launches each path makes in one forward
WANT_COUNTS = {
    "default": {"K1": 13, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0},
    "region": {"K1": 20, "K3": 4, "K4": 0, "K5": 0, "K6": 1, "K7": 1},
    "cascade": {"K1": 2, "K3": 4, "K4": 7, "K5": 0, "K6": 1, "K7": 1},
    "mega": {"K1": 8, "K3": 0, "K4": 0, "K5": 1, "K6": 0, "K7": 0}}
# Phase 11: YOLOv8n at 640x640, 80 classes, from synthesize_state_dict(80,
# "n", seed=0).  The heads' score gate is 0.10, as tests/test_yolov8.py
# converts them: the synthetic class head (biases near -4) scores about
# 0.1, so the converter's default 0.25 would leave nothing to compare.
# C2f plans no fused run: a v8n forward launches no K1-K7, one K2 a call.
V8_SIZE, V8_CONF = 640, 0.10
V8_KS = (128, 2048, 8400)       # the top-k ladder; 8,400 = v8n's candidates
V8_IOU = 0.7                    # a pure-v8 graph's union-IoU threshold
WANT_COUNTS["v8n"] = {"K1": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
# the float32 knobs on the region configuration (the region flags set)
KNOB_FLAGS = {"head_f32": {**REGION_FLAGS, "FFCNN_HEAD_F32": "1"},
              "stages_20": {**REGION_FLAGS, "FFCNN_F32_STAGES": "20"}}
for _want in WANT_COUNTS.values():
    # no Net path runs the block bench's kernels or the probes', and no
    # float path the int8 conv
    _want.update({k: 0 for k in ("K8", "K9", "P1/P2", "P3", "P4", "P5",
                                 "conv_int8")})
# The path kernels' __global__ symbols, as torch.profiler names their device
# events (demangled or mangled).  K1 and K3 are block_mma.cuh's template at
# S = 1 and S = 2.  A replay runs no Python, so the kernels a graph's replay
# ran are counted from these events, not by the wrappers.
KERNEL_SYMBOLS = {
    "conv_int8": r"conv_int8_(dense|dw4|dw|gemm|grouped|u8)_kernel",
    "K1": r"mma::block_kernel<1,|3mma12block_kernelILi1E",
    "K2": r"(?<![A-Za-z_])nms_keep_kernel",
    "K3": r"mma::block_kernel<2,|3mma12block_kernelILi2E",
    "K4": r"(?<![A-Za-z_])cascade_kernel",
    "K5": r"(?<![A-Za-z_])mega_kernel",
    "K6": r"(?<![A-Za-z_])conv0_kernel",
    "K7": r"(?<![A-Za-z_])head_kernel"}

# Tolerances of a kernel against its plain version on the same inputs, for
# every kernel but K2 (K1, K3, K6, K7: float32 math inside).  float32: the
# same sums in another order (<= 448 terms): 2e-5 of the output's range.
# bfloat16: one rounding of those sums at the store, so a value an f32 ulp
# from a rounding edge may land one bf16 ulp (2^-8 relative) away; allow
# two.
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2 ** -7}
# K8 and K9 against their plain versions, of the output's range.  float32:
# as above (phase 7 measured at most 4.4e-7 over the bench's cases on an
# H100 80GB HBM3 at 700 W).  bfloat16: both round an intermediate to bf16
# before the next stage (K8 the expand and depthwise outputs, K9 the
# depthwise output), so a value that the two sum orders put on either side
# of a rounding edge flips one bf16 ulp there, and the flip, times the taps
# and the projection weights, reaches the output besides the output's own
# one-ulp rounding; phase 7 measured at most 5.8e-3 of the range (1.5
# ulps) on that card; allow four ulps (2^-6).
MBCONV_TOL = {"float32": 2e-5, "bfloat16": 2 ** -6}
# P1/P2 against their plain versions and against torch.mm: bf16 products
# are exact in float32, so only the order of the (8 or 128) sums differs:
# KERNEL_TOL's float32 2e-5 of the range.  P3 (the block variants, at batch
# P3_CHECK_BATCH): copy bit-exact; float32 and bfloat16 storage as
# KERNEL_TOL (float32 sums, one rounding at the store; dwbf16 in bf16 does
# the plain version's roundings in its order); fullbf16 rounds its expand
# and depthwise outputs to bf16, so it takes MBCONV_TOL's 2^-6 in both
# storages.  P4 and P5 are copies: bit-exact.
EXACT = {"float32": 0.0, "bfloat16": 0.0}
# P4 beside the sweep's (16, 128): a shape where bytes matter (8 MiB read,
# the even rows of 16 MiB, and 8 MiB written), and the 2-byte path's cases (label, rows, cols,
# offset in elements of a contiguous view into a larger buffer): an odd R,
# a C that is not a multiple of 8, an unaligned view; and an odd R on the
# 16-byte path.  At P4_LARGE the graph's 20 launches each read and write
# buffers of their own (``rotated``): 480 MiB in all, far past the H100's
# 50 MB L2, so each launch reads and writes HBM, as its bound assumes
P4_LARGE = (65536, 128)
P4_CASES = (("odd R", 17, 130, 0), ("C % 8 != 0", 16, 130, 0),
            ("unaligned view", 16, 128, 1), ("odd R, 16-byte runs", 17, 128,
                                             0))
P3_ITERS, P3_BATCH, P3_CHECK_BATCH = 20, 256, 64
# Phase 9: the server's load (the fixture and seeded frames, each sent
# SERVE_REQUESTS / SERVE_FRAMES times) and detect_stream's depths
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_FRAMES = 96, 32, 16
STREAM_DEPTHS = (2, 3)
# Phase 10: the steps of the layer profile held to its ranges
PROFILE_ITERS = 10
# Phase 15: the BMP codec on the card's host: seeded 320x320 frames
# written, the chunk ``cli batch`` decodes at a time, the timed repeats of
# a loader (after one warm-up) and of ``Net.load``
CODEC_FRAMES, CODEC_CHUNK, LOADER_REPS, NET_LOAD_REPS = 256, 64, 10, 3
# seconds between a trace's window opening and the traced call, and the
# small device ops launched then, before it (``traced``)
TRACE_SETTLE_S, TRACE_SPACER_OPS = 0.2, 1000
# attempts of a replay check whose eager trace lost device events
# (``check_replay``)
TRACE_TRIES = 3


def p3_tols(mode: str) -> dict:
    if mode == "copy":
        return EXACT
    if mode == "fullbf16":
        return dict.fromkeys(KERNEL_TOL, MBCONV_TOL["bfloat16"])
    return KERNEL_TOL


# The whole fast forward on the card against the CPU: every bf16 blob may
# carry such one-ulp flips from the previous layers (the CPU test of the
# port against JAX holds the same bounds).
HEAD_MAX_TOL, HEAD_MEAN_TOL = 2 ** -3, 2 ** -8
# Detections of the two fast forwards: bf16 drift reorders near-equal
# scores, so top-k and greedy NMS may keep another member of a cluster.
# Each side's detections are held against the other side's candidates
# (decoded boxes before NMS): 90% need a same-class candidate within 4 px
# and 0.02 in score (the rest are knife-edges at the ignore threshold).
DET_MATCH_FRAC, DET_MATCH_PX, DET_MATCH_SCORE = 0.9, 4.0, 0.02
# Parity (float32, TF32 off) on the card against the CPU, paired as sets
# per image (synthetic weights give equal-score ties, which come out in
# either order): same class, scores to 1e-4, and an integer box may differ
# only where float32 noise (<= 1e-3 px) moved a coordinate across an
# integer.
PARITY_SCORE_TOL, PARITY_BOX_NOISE = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
    import torch
    for _ in range(warmup):
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


def turns(kernel, plain, iters: int = 20):
    """Kernel and plain timed in the order kernel, plain, plain, kernel."""
    a, b = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    c, d = cuda_ms(plain, iters), cuda_ms(kernel, iters)
    return (a, d), (b, c)


def nms_candidates(n: int, k: int, seed: int):
    """Sorted candidates with equal scores, touching and degenerate boxes
    and five classes (coordinates on a coarse integer grid), numpy."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 64, (n, k, 2)).astype(np.float32)
    wh = rng.randint(0, 24, (n, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    scores = rng.choice([0.5, 0.6, 0.75, 0.9, 1.0], (n, k)).astype(np.float32)
    scores[rng.rand(n, k) < 0.2] = 0.0
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], axis=1)
    scores = np.take_along_axis(scores, order, axis=1)
    classes = rng.randint(0, 5, (n, k)).astype(np.int32)
    return boxes, scores, classes


def nms_chains(n: int, k: int, seed: int):
    """Chains of boxes 10 wide, each 2 to the right of the one before, one
    row and one class (of two) a chain, up to four chains an image cut at
    seeded places, all at one score but the last eighth (absent), numpy.
    Greedy keeps every third box of a chain with min IoU (0.8, 0.6, 0.4 at
    one, two, three steps) and every other with union IoU (0.67, 0.43), so
    a chain that runs over a 32-anchor edge is cut there mid-suppression."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((n, k, 4), np.float32)
    classes = np.zeros((n, k), np.int32)
    for img in range(n):
        cuts = (np.sort(rng.choice(np.arange(1, k), min(3, k - 1),
                                   replace=False)) if k > 1 else [])
        for c, (a, b) in enumerate(zip([0, *cuts], [*cuts, k])):
            i = np.arange(b - a, dtype=np.float32)
            boxes[img, a:b] = np.stack([2 * i, np.full_like(i, 20 * c),
                                        2 * i + 10,
                                        np.full_like(i, 20 * c + 10)], -1)
            classes[img, a:b] = c % 2
    scores = np.full((n, k), 0.9, np.float32)
    scores[:, k - k // 8:] = 0.0
    return boxes, scores, classes


def stem_nms_times(cp, dev) -> dict:
    """K6 and K2 timed at batch 64 on seeded inputs, through their
    wrappers.  K6 on the stem ``cp`` at 320x320 in bf16: CUDA events in
    turns with its plain version, and the kernel's device time alone
    (``bench_block.kernel_alone_ms``, torch.profiler); then the kernel
    alone at each size and dtype of ``K6_TIMED``.  K2 at each K of
    ``NMS_KS`` on ``nms_candidates``, min IoU: events, the plain version's
    events and the kernel alone.  Returns {"K6": {...}, "K2": {k: (ms,
    plain ms, alone ms)}}."""
    import torch
    from ffcnn_tpu_torch.bench_block import kernel_alone_ms
    from ffcnn_tpu_torch.kernels import conv0_fused as c0
    from ffcnn_tpu_torch.kernels import nms as knms
    gen = torch.Generator().manual_seed(SEED)
    bf16 = torch.bfloat16

    def frames(size):
        return torch.randint(0, 256, (BATCH, size, size, 3), generator=gen,
                             dtype=torch.uint8).to(dev)
    x = frames(320)
    (ms, ms2), (pms, pms2) = turns(lambda: c0.conv0_cs(x, cp, bf16),
                                   lambda: c0.conv0_plain(x, cp, bf16))
    k6 = {"ms": ms, "ms2": ms2, "plain_ms": pms, "plain_ms2": pms2,
          "alone": kernel_alone_ms(lambda: c0.conv0_cs(x, cp, bf16),
                                   "conv0_kernel", 50)}
    log(f"[6] K6 stem u8 320x320 -> bf16 batch {BATCH}: kernel {ms:.4f} / "
        f"{ms2:.4f} ms, kernel alone {k6['alone']:.4f} ms (torch.profiler),"
        f" plain {pms:.4f} / {pms2:.4f} ms")
    for size, dt in K6_TIMED:
        xs = frames(size)
        a = kernel_alone_ms(lambda: c0.conv0_cs(xs, cp, getattr(torch, dt)),
                            "conv0_kernel", 50)
        k6[f"alone_{size}_{dt}"] = a
        log(f"[6] K6 stem u8 {size}x{size} -> {dt} batch {BATCH}: kernel "
            f"alone {a:.4f} ms (torch.profiler)")
    k2 = {}
    for k in NMS_KS:
        tb, ts, tc = (torch.from_numpy(a).to(dev)
                      for a in nms_candidates(BATCH, k, seed=k))
        ms = cuda_ms(lambda: knms.nms_keep_mask(tb, ts, tc, threshold=0.5))
        pms = cuda_ms(lambda: knms.keep_mask_plain(tb, ts, tc, 0.5),
                      iters=3, warmup=1)
        alone = kernel_alone_ms(
            lambda: knms.nms_keep_mask(tb, ts, tc, threshold=0.5),
            "nms_keep_kernel", 50)
        k2[k] = (ms, pms, alone)
        log(f"[6] K2 nms K={k} batch {BATCH}: kernel {ms:.4f} ms, kernel "
            f"alone {alone:.4f} ms (torch.profiler), plain {pms:.4f} ms")
    return {"K6": k6, "K2": k2}


def traced(fn):
    """Run ``fn`` once under torch.profiler (host and device activity)
    and return its result and the profiler's rows (``key_averages``).
    A warm-up step comes first, whose events the profiler drops: without
    it, the first device events of a trace went missing (an upload and
    the first kernels of a replay).  Then ``fn`` starts TRACE_SETTLE_S
    after the trace's window opens: late in a run the profiler still
    dropped the device events of a trace's first milliseconds (most of
    an eager batch-1 forward, its last kernels kept), as if the card's
    timestamps fell before the window's start.  In a fresh process too
    (phase 16) it dropped a short eager forward's first two layers, so
    TRACE_SPACER_OPS small device ops go first, for it to drop instead
    (none of them is a path kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    rows = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: rows.extend(p.key_averages())
                 ) as prof:
        torch.ones(1 << 20, device="cuda").sum().item()
        prof.step()
        time.sleep(TRACE_SETTLE_S)
        spacer = torch.zeros(1, device="cuda")
        for _ in range(TRACE_SPACER_OPS):
            spacer.add_(1)
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    if not rows:
        raise AssertionError("torch.profiler returned no trace")
    return out, rows


def recaptured(net) -> None:
    """Drop ``net``'s buckets before its timed rows, so that every graph
    they replay under torch.profiler is captured just before them: the
    replay of a graph captured long before died of a segmentation fault
    under the profiler (in phase 6, and in phase 16's traced replays), and
    never once each traced graph was recent (ROADMAP Queue 3)."""
    net._pipelines.clear()


def profiled_ms(fn, iters: int):
    """(host CPU ms, device ms) a call of ``fn``, by torch.profiler over
    ``iters`` calls after one untraced call: the self CPU time of every
    host event but the closing synchronise, and the time of every device
    event (kernels, copies; a host op's own device time repeats its
    kernels', so host rows are left out of that sum, as are the device
    spans of the eager forward's layer ranges, which repeat theirs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    host = sum(e.self_cpu_time_total for e in rows
               if e.key != "cudaDeviceSynchronize")
    device = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0) for e in rows
                 if e.device_type == DeviceType.CUDA
                 and not re.fullmatch(r"L\d{3}_\w+", e.key))
    return host / 1e3 / iters, device / 1e3 / iters


def eager_bucket_times(nets, frames, dev) -> None:
    """Phase 6's detect times, pixels on the card, at batch 1, 64 and 256:
    every path's bucket (``detect_device``, one graph replay) by CUDA
    events; for default and region also the eager pipeline
    (``_Pipeline.run``: letterbox, forward, decode, arena cap, top-k and
    K2 launched from Python, as ``detect_device`` ran them before the
    buckets, now without its per-call host copies), the two in turns
    (eager, bucket, bucket, eager), and each's host CPU and device time by
    torch.profiler."""
    import torch
    for tag, n in nets.items():
        recaptured(n)
        for nb, iters in ((1, 50), (64, 20), (256, 8)):
            batch = torch.from_numpy(np.resize(frames, (nb, 320, 320, 3))
                                     ).to(dev)
            n.warmup(batch_sizes=(nb,))
            bucket = lambda: n.detect_device(batch)
            row = {}
            if tag in ("default", "region"):
                eager = lambda: bucket_of(n, batch).run(batch)
                (row["eager"], row["eager2"]), (row["bucket"],
                                                row["bucket2"]) = turns(
                    eager, bucket, iters)
                row["eager_host"], row["eager_device"] = profiled_ms(
                    eager, min(iters, 10))
                row["bucket_host"], row["bucket_device"] = profiled_ms(
                    bucket, min(iters, 10))
                log(f"[6] {tag} detect batch {nb}, eager / bucket: events "
                    f"{row['eager']:.3f}, {row['eager2']:.3f} / "
                    f"{row['bucket']:.3f}, {row['bucket2']:.3f} ms "
                    f"({nb / row['bucket'] * 1e3:.1f} img/s bucket); "
                    f"torch.profiler host CPU {row['eager_host']:.3f} / "
                    f"{row['bucket_host']:.3f} ms, device "
                    f"{row['eager_device']:.3f} / {row['bucket_device']:.3f}"
                    f" ms a call")
            else:
                row["bucket"] = cuda_ms(bucket, iters=iters)
                log(f"[6] {tag} detect batch {nb}, bucket: events "
                    f"{row['bucket']:.3f} ms, {nb / row['bucket'] * 1e3:.1f}"
                    f" img/s")


# each ffcnn:: op's module, its attribute there and its CUDA implementation
OP_IMPLS = (("block_fused", "FUSED_BLOCK_OP", "_block_cuda"),
            ("block_fused", "FUSED_DOWN_BLOCK_OP", "_down_cuda"),
            ("block_fused", "FUSED_CASCADE_OP", "_cascade_cuda"),
            ("block_fused", "FUSED_MEGA_OP", "_mega_cuda"),
            ("conv0_fused", "CONV0_OP", "_conv0_cuda"),
            ("head_fused", "HEAD_OP", "_head_cuda"),
            ("nms", "NMS_OP", "_nms_cuda"),
            ("conv_int8", "CONV_INT8_OP", "_conv_cuda"))


@contextlib.contextmanager
def direct_launches():
    """The wrappers call each kernel's CUDA implementation straight (the
    ctypes launch, which counts it), leaving out the ``ffcnn::`` op's
    dispatch: the A/B of what the ops cost on the eager path."""
    import importlib
    saved = []
    for mod, op, impl in OP_IMPLS:
        m = importlib.import_module(f"ffcnn_tpu_torch.kernels.{mod}")
        saved.append((m, op, getattr(m, op)))
        setattr(m, op, getattr(m, impl))
    try:
        yield
    finally:
        for m, op, fn in saved:
            setattr(m, op, fn)


def wall_us(fn, calls: int) -> float:
    """Wall microseconds a call of ``fn`` over ``calls`` calls, one
    synchronise at the end."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def dispatch_times(nets, frames, dev) -> dict:
    """Phase 6, what the ``ffcnn::`` ops cost: the default and region
    eager pipelines (``_Pipeline.run``) at batch 1 and 64 through the ops
    and with the ops' dispatch left out (``direct_launches``), in turns
    (ops, direct, direct, ops) by CUDA events, their launches counted
    once; then one K2 call at batch 1, K 128 (a 0.01 ms kernel, so the
    host sets the pace), as wall microseconds over 2,000 calls, three
    times each way in turns."""
    import torch
    from ffcnn_tpu_torch.kernels import nms as knms
    out = {}
    for tag in ("default", "region"):
        n = nets[tag]
        for nb, iters in ((1, 50), (64, 20)):
            batch = torch.from_numpy(np.resize(frames, (nb, 320, 320, 3))
                                     ).to(dev)
            pipe = bucket_of(n, batch)
            eager = lambda: pipe.run(batch)
            with direct_launches():
                direct = [cuda_ms(eager, iters)]
            ops = [cuda_ms(eager, iters)]
            with direct_launches():
                direct.append(cuda_ms(eager, iters))
            ops.append(cuda_ms(eager, iters))
            out[f"{tag}_{nb}"] = {"ops_ms": ops, "direct_ms": direct}
            log(f"[6] {tag} eager pipeline batch {nb}, through the ops / "
                f"direct launches, in turns: {ops[0]:.3f}, {ops[1]:.3f} / "
                f"{direct[0]:.3f}, {direct[1]:.3f} ms")
    boxes, scores, classes = (torch.from_numpy(t).to(dev)
                              for t in nms_candidates(1, 128, SEED))
    k2 = lambda: knms.nms_keep_mask(boxes, scores, classes, threshold=0.5)
    ops, direct = [], []
    for _ in range(3):
        ops.append(wall_us(k2, 2000))
        with direct_launches():
            direct.append(wall_us(k2, 2000))
    out["k2_us"] = {"ops": ops, "direct": direct}
    log(f"[6] K2 one call batch 1 K 128, wall us through the op / direct: "
        + ", ".join(f"{a:.1f}" for a in ops) + " / "
        + ", ".join(f"{b:.1f}" for b in direct))
    return out


def match_fraction(dets, boxes, scores, classes, px: float,
                   score_tol: float) -> float:
    """Share of ``dets`` that are among the candidates (``boxes`` (M, 4),
    ``scores`` (M,), ``classes`` (M,) numpy, score 0 = absent): same class,
    every coordinate within ``px``, score within ``score_tol``."""
    live = scores > 0
    boxes, scores, classes = boxes[live], scores[live], classes[live]
    if not dets:
        return 1.0
    hits = sum(bool(np.any((classes == d.class_id)
                           & (np.abs(boxes - np.asarray(d[2:])).max(1) <= px)
                           & (np.abs(scores - d.score) <= score_tol)))
               for d in dets)
    return hits / len(dets)


def check_kernel(label: str, got, want, tols=KERNEL_TOL,
                 phase: int = 3) -> float:
    """Hold a kernel's output against its plain version's on the same
    inputs, of the same shape and dtype: bit for bit where ``tols`` gives
    the dtype 0, else within that share of the output's range; returns
    max |err|."""
    import torch
    torch.cuda.synchronize()
    dtype = str(want.dtype).split(".")[-1]
    same = got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if same else float("inf")
    scale = w.abs().max().item()
    tol = tols[dtype] * scale
    ok = same and bool(torch.isfinite(g).all()) and (
        torch.equal(got, want) if tols[dtype] == 0 else err <= tol)
    log(f"[{phase}] {label} batch {got.shape[0]} {dtype}: max|err| "
        f"{err:.3e} ({err / max(scale, 1e-30):.1e} of the range; "
        + ("bit-exact required" if tols[dtype] == 0 else f"tol {tol:.3e}")
        + f") {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def counted(counters, fn):
    """Run ``fn`` with every launch counter set to 0 just before it; return
    its result and the counts read just after it."""
    import torch
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def kernel_events(counters, fn):
    """Run ``fn`` under torch.profiler (``traced``) with every launch
    counter set to 0 just before it; return its result, the path kernels
    the card ran (KERNEL_SYMBOLS, counted from the device events: a
    graph's replays included) and the wrappers' counts (launches from
    Python)."""
    import re
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out, rows = traced(fn)
    ran = dict.fromkeys(KERNEL_SYMBOLS, 0)
    # every device row, for the log of a check that fails
    kernel_events.rows = [(e.key, e.count) for e in rows
                          if e.device_type == DeviceType.CUDA]
    for key, count in kernel_events.rows:
        for k, pat in KERNEL_SYMBOLS.items():
            if re.search(pat, key):
                ran[k] += count
    return out, ran, {k: c.launches for k, c in counters.items()}


def log_device_rows() -> None:
    """Log the device rows of the last ``kernel_events`` call."""
    for key, count in kernel_events.rows:
        log(f"    {count:6d}  {key[:160]}")


def check_against_cpu(tag: str, net, cpu_net, frames, dets,
                      phase: int = 4, cpu_heads=None) -> None:
    """The card's heads and detections against the same Net on the CPU,
    on the first four frames (``dets``: the card's detections of all).
    ``cpu_heads``: the CPU's heads of those frames, already computed."""
    import torch
    from ffcnn_tpu_torch.ops.yolo import decode_heads
    few = frames[:4]
    hg = net.forward_heads(torch.from_numpy(few).to("cuda"))
    hc = cpu_heads if cpu_heads is not None else cpu_net.forward_heads(
        torch.from_numpy(few))
    for i, (g, c) in enumerate(zip(hg, hc)):
        g, c = g.float().cpu(), c.float()
        scale = c.abs().max().item()
        err = (g - c).abs()
        ok = bool(torch.isfinite(g).all()) and \
            err.max().item() <= HEAD_MAX_TOL * scale and \
            err.mean().item() <= HEAD_MEAN_TOL * scale
        log(f"[{phase}] {tag} head {i} {tuple(g.shape)} card vs CPU: max|err| "
            f"{err.max().item():.3e} mean {err.mean().item():.3e} (scale "
            f"{scale:.2f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} heads disagree with the CPU")
    dc = cpu_net.detect(few)
    net_w, net_h = net.ir.blobs[0].w, net.ir.blobs[0].h
    cands = [decode_heads(net.ir, [h.float().cpu() for h in hs], net_w,
                          net_h) for hs in (hg, hc)]
    for i in range(len(few)):
        fr = [match_fraction(d[i], *(t[i].numpy() for t in c), DET_MATCH_PX,
                             DET_MATCH_SCORE)
              for d, c in ((dets, cands[1]), (dc, cands[0]))]
        ok = min(fr) >= DET_MATCH_FRAC
        log(f"[{phase}] {tag} image {i}: card {len(dets[i])} CPU "
            f"{len(dc[i])} "
            f"detections; among the other side's candidates: card "
            f"{fr[0]:.3f}, CPU {fr[1]:.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} detections disagree with the CPU")


def bucket_of(net, frames, topk=None):
    """The bucket (``net._pipeline_for``) that detects ``frames``."""
    import ffcnn_tpu_torch as pt
    return net._pipeline_for(frames.shape[1], frames.shape[2],
                             pt.DEFAULT_MEAN, pt.DEFAULT_NORM, topk)


def check_replay(tag: str, net, counters, frames, first,
                 want=None, phase: int = 4) -> None:
    """A second ``detect`` of ``frames`` (N, H, W, 3), a replay of the
    bucket the first built: the kernels the card ran in it (torch.profiler)
    are one forward's (WANT_COUNTS) and one K2, as many as one eager run of
    the bucket's pipeline on the same batch ran (torch.profiler) and
    launched (its wrappers' counts, which hold the symbols true); no wrapper
    counts in the replay.  Whether it equals the first's (``first``, a
    replay too) bit for bit is reported.  ``want``: one forward's launches
    (default WANT_COUNTS of the tag).  Both traces are taken again, up to
    TRACE_TRIES times in all, only where either trace kept fewer device
    events of a kernel than the eager run's wrappers counted launches: then
    torch.profiler lost events (late in a run it once kept an eager int8
    forward's first ten layers alone; in phase 16 the replay's trace of a
    forward at 416x416 once kept no event of its first kernel, the stem,
    where the eager trace before it, taken again, kept it), and the
    attempt shows nothing of the replay.  Any other disagreement fails at
    once, and the last attempt's fails whatever it is."""
    import torch
    want = want or WANT_COUNTS[tag.replace("416", "")]
    xb = torch.from_numpy(frames).to("cuda")
    for i in range(TRACE_TRIES):
        lost = replay_attempt(tag, net, counters, frames, xb, first, want,
                              last=i == TRACE_TRIES - 1, phase=phase)
        if not lost:
            return
        log(f"    (the eager trace lost device events, traced / launched "
            f"{lost}: both traces taken again)")


def replay_attempt(tag, net, counters, frames, xb, first, want,
                   last: bool, phase: int = 4) -> dict:
    """One attempt of ``check_replay``: both traces, the check.  Returns
    {} where it holds; where it does not, the kernels of which either trace
    kept fewer events than the eager run's wrappers launched (the fewer
    traced, launched), if there are any and ``last`` is false; else
    raises."""
    dets, ran, wrapped = kernel_events(counters, lambda: net.detect(frames))
    _, eager_ran, eager_wrapped = kernel_events(
        counters, lambda: bucket_of(net, xb).run(xb))
    log(f"[{phase}] {tag} bucket batch {len(frames)} at {frames.shape[2]}x"
        f"{frames.shape[1]}: kernels a replay ran "
        + " ".join(f"{k} {v}" for k, v in ran.items() if v)
        + "; an eager run's " + " ".join(
            f"{k} {v}" for k, v in eager_ran.items() if v)
        + ", its wrappers' " + " ".join(
            f"{k} {v}" for k, v in eager_wrapped.items() if v)
        + f"; the replay's wrapper counts {sum(wrapped.values())}; bit for "
        f"bit with the first detect: {dets == first}")
    ok = not any(wrapped.values()) and ran["K2"] == 1 and all(
        ran[k] == want[k] for k in KERNEL_SYMBOLS if k != "K2") and \
        ran == eager_ran == {k: eager_wrapped[k] for k in KERNEL_SYMBOLS}
    if ok:
        return {}
    log_device_rows()
    lost = {k: (min(eager_ran[k], ran[k]), eager_wrapped[k])
            for k in KERNEL_SYMBOLS
            if min(eager_ran[k], ran[k]) < eager_wrapped[k]}
    if lost and not last:
        return lost
    raise AssertionError(f"{tag}: the bucket's replay did not run the "
                         f"kernels an eager run launches")


def eager_detect(net, frames):
    """``detect`` through the eager pipeline, no graph (the parent's path):
    parity mode grows K as ``Net._finish`` does."""
    import torch
    xb = torch.from_numpy(frames).to("cuda")
    max_k = net._max_candidates()
    k = min(net.topk, max_k)
    res = bucket_of(net, frames).run(xb)
    while net.mode == "parity" and bool(res.saturated.any()) and k < max_k:
        k = min(max_k, k * 4)
        res = bucket_of(net, frames, k).run(xb)
    return net._to_detections(res)


def pair_parity(got, want, other: str) -> tuple:
    """Two parity detection lists, paired as sets per image (equal-score
    ties may come out in either order): the same count, the same class,
    scores to PARITY_SCORE_TOL, an integer box equal but where float32
    noise (PARITY_BOX_NOISE) moved a coordinate across an integer.
    Returns (the worst score difference, the integers flipped); raises
    naming ``other``, the side ``want`` came from."""
    flips = worst = 0
    for a, b in zip(got, want):
        if len(a) != len(b):
            raise AssertionError(f"parity counts differ {len(a)} {len(b)}")
        free = list(b)
        for g in a:
            c = next((c for c in free if c.class_id == g.class_id
                      and abs(c.score - g.score) <= PARITY_SCORE_TOL
                      and all(int(u) == int(v) or abs(u - v)
                              <= PARITY_BOX_NOISE
                              for u, v in zip(g[2:], c[2:]))), None)
            if c is None:
                raise AssertionError(f"parity detection {g} not on {other}")
            free.remove(c)
            worst = max(worst, abs(g.score - c.score))
            flips += sum(int(u) != int(v) for u, v in zip(g[2:], c[2:]))
    return worst, flips


def check_dets(tag: str, dets) -> None:
    for d in (x for img in dets for x in img):
        if not (0 < d.score <= 1 and 0 <= d.class_id < 80
                and all(np.isfinite(d[2:]))):
            raise AssertionError(f"{tag}: bad detection {d}")


@contextlib.contextmanager
def environ(flags):
    """``flags`` set in the environment for the block, then restored."""
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def load_net(pt, wbytes, flags, device, size=320):
    """A fast Net of xl built with ``flags`` set in the environment (a Net
    reads them once, when it is built), which are then restored."""
    with environ(flags):
        return pt.load(CFG, wbytes, input_w=size, input_h=size, mode="fast",
                       device=device)


def group_params(net):
    """[(blocks, block params)] of a Net's launch groups, in order."""
    out = []
    for r in net._fused_runs:
        bps = net._fused_params[r.start]
        i = 0
        for g in net._fused_groups[r.start]:
            out.append((g, bps[i:i + len(g)]))
            i += len(g)
    return out


def chain_work(bb, n, h, w, bps, stride=1):
    """What K1 or K3 (one block) or K4 or K5 (a chain in one launch) must
    do on an (n, h, w) bf16 input: each block's operations and float32
    weights; only the chain's input and output cross device memory."""
    work = bb.Work()
    for bp in bps:
        c, e, p = bp.w1.shape[0], bp.w1.shape[1], bp.w2.shape[1]
        work += bb.block_work(n, h, w, c, e, p, stride)
    # each boundary inside the chain was counted as an output and an input
    inner = sum(2 * 2 * n * h * w * bp.w2.shape[1] for bp in bps[:-1])
    return dataclasses.replace(work, bytes=work.bytes - inner)


def halo_work(bf, h, w, bps, tile):
    """K4's work at ``tile`` over the work of its blocks each over the
    whole (h, w) map as one tile, both by the tile search's cost model
    (``_cascade_cost``): how much the chain's halo recompute adds."""
    widths = bf._widths(bps)
    tiled = sum(n * bf._cascade_cost(widths, r, c)
                for r, c, n in bf._cut_tiles(h, w, *tile))
    return tiled / sum(bf._cascade_cost([wd], h, w) for wd in widths)


def head_work(bb, n, hps, c_in):
    """K7's chain over an (n, h, w, c_in) bf16 input to its bf16 head map:
    pointwise and depthwise operations, float32 weights."""
    pix = n * hps.h * hps.w
    work = bb.Work(2 * pix * (c_in + hps.stages[-1].scale.shape[0]))
    for st in hps.stages:
        cout = st.w.shape[1] if st.kind == "pw" else st.w.shape[0]
        work += bb.Work(4 * (st.w.numel() + 2 * cout))
        if st.kind == "pw":
            work += bb.Work(tc_flop=2 * pix * st.w.numel())
        else:
            work += bb.Work(f32_flop=2 * pix * st.w.numel())
    return work


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, work,
                 library_ms=None, **more) -> dict:
    """One kernel's entry in the ``kernels`` line."""
    bound, by = work.bound()
    return {"name": name, "route": "cuda",
            "source": f"ffcnn_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, **more}


def p4_path(mp, label, x, y) -> None:
    """P4's launch, as the kernel reported it, against the Python mirror
    (``mosaic_probes.strided_plan``) of the same call; raises where they
    differ."""
    from ffcnn_tpu_torch.kernels import _build
    want = mp.strided_plan(*x.shape, x.data_ptr(), y.data_ptr(),
                           _build.sm_count(x.device))
    got = mp.strided_rows.plan
    log(f"[8] P4 {label} {tuple(x.shape)}: {got.vec} column(s) a thread, "
        f"block {got.block}, grid {got.grid}; the mirror's "
        f"{'the same' if got == want else want}")
    if got != want:
        raise AssertionError(f"P4 {label}: launched {got}, the mirror says "
                             f"{want}")


def rotated(fn, xs):
    """A call of ``fn`` on the next of ``xs`` in turn, each output kept
    alive: ``len(xs)`` calls captured in one CUDA graph read and write
    buffers of their own, none of which the L2 still holds from the call
    before (``P4_LARGE``)."""
    import itertools
    it, keep = itertools.cycle(xs), []
    return lambda: keep.append(fn(next(it)))


def p4_large(mp, bb, dev) -> dict:
    """P4 off the sweep's shape: the 2-byte path's cases (P4_CASES) and
    the 16-byte path at P4_LARGE, each bit for bit against the plain
    version and its launch against the mirror; then at P4_LARGE the kernel
    alone (20 launches in one CUDA graph, each on its own input and output,
    ``rotated``: from HBM) beside ``x[::2].contiguous()`` alone the same
    way, the plain version by events, and its bound (bytes over the HBM
    rate).  Returns the ``kernels`` entry's extra keys."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 4)
    for label, r, c, off in P4_CASES:
        base = torch.randn(r * c + off, generator=gen).to(dev, torch.bfloat16)
        x = base[off:].view(r, c)
        y = mp.strided_rows(x)
        p4_path(mp, label, x, y)
        check_kernel(f"P4 {label} {tuple(x.shape)}", y,
                     mp.strided_rows_plain(x), EXACT, 8)
        if (mp.strided_rows.plan.vec == 8) != (c % 8 == 0 and off == 0):
            raise AssertionError(f"P4 {label} took the wrong path")
    x = torch.randn(P4_LARGE, generator=gen).to(dev, torch.bfloat16)
    y = mp.strided_rows(x)
    p4_path(mp, "large", x, y)
    check_kernel(f"P4 {P4_LARGE}", y, mp.strided_rows_plain(x), EXACT, 8)
    check_kernel(f"P4 {P4_LARGE} against x[::2].contiguous()", y,
                 x[::2].contiguous(), EXACT, 8)
    xs = [x.clone() for _ in range(20)]
    tag = "x".join(map(str, P4_LARGE))
    t = {f"kernel_alone_ms_{tag}": bb.graph_launch_ms(
             rotated(mp.strided_rows, xs)),
         f"library_alone_ms_{tag}": bb.graph_launch_ms(
             rotated(lambda v: v[::2].contiguous(), xs)),
         f"plain_ms_{tag}": cuda_ms(lambda: mp.strided_rows_plain(x), 20),
         f"bound_ms_{tag}": bb.Work(2 * y.numel() * y.element_size()
                                    ).bound()[0],
         f"path_{tag}": mp.strided_rows.plan._asdict()}
    del xs
    log(f"[8] P4 {P4_LARGE} bf16, each launch from HBM: kernel alone "
        f"{t[f'kernel_alone_ms_{tag}']:.5f} ms "
        f"({t[f'bound_ms_{tag}'] / t[f'kernel_alone_ms_{tag}']:.1%} of its "
        f"bound's rate), x[::2].contiguous() alone "
        f"{t[f'library_alone_ms_{tag}']:.5f} ms, plain "
        f"{t[f'plain_ms_{tag}']:.4f} ms, bound {t[f'bound_ms_{tag}']:.5f} ms")
    return t


def probe_phase(dev, counters) -> list:
    """Phase 8: the probe kernels P1-P5 behind the ports of their probes.
    Each kernel's launches are read around its probe's pass, each is held
    against its plain version, and each is timed; returns their five
    entries of the ``kernels`` line."""
    import torch
    from ffcnn_tpu_torch import bench_block as bb
    from ffcnn_tpu_torch import bench_pw_kernels as bpw
    from ffcnn_tpu_torch import bisect_smallc as bs
    from ffcnn_tpu_torch import retest_backend_bugs as rb
    from ffcnn_tpu_torch.kernels import block_fused as bf
    from ffcnn_tpu_torch.kernels import block_variants as bv
    from ffcnn_tpu_torch.kernels import mosaic_probes as mp
    from ffcnn_tpu_torch.kernels import pw_matmul as pw

    def only(tag, counts, key, n):
        log(f"[8] {tag}: launches " + " ".join(f"{k} {v}" for k, v in
                                              counts.items()))
        if counts[key] != n or any(v for k, v in counts.items() if k != key):
            raise AssertionError(f"{tag} did not launch {key} {n} times "
                                 f"and nothing else")
        return n

    # P1 and P2: one launch each at the tool's shapes, at the tool's M - 1
    # and at M = 1,000 (ragged last tiles), each against the plain version
    # and torch.mm; a shape that is not compiled refused before any launch;
    # then the bench's rows A, D, B, C
    err, launches = {"P1": 0.0, "P2": 0.0}, {}
    inp = bpw.make_inputs(dev)
    for key, x, w in (("P1", inp.x2, inp.w), ("P2", inp.xp, inp.wb)):
        m = x.shape[0]
        for rows in (m, m - 1, 1000):
            xm = x[:rows]
            y, counts = counted(counters, lambda: pw.pw_matmul(xm, w))
            launches[key] = only(f"{key} pw_matmul {tuple(xm.shape)} @ "
                                 f"{tuple(w.shape)}", counts, "P1/P2", 1)
            err[key] = max(err[key], check_kernel(
                f"{key} {rows} rows against its plain version", y,
                pw.pw_matmul_plain(xm, w), phase=8))
            mm, how = bpw.library_mm(xm, w)
            check_kernel(f"{key} {rows} rows against {how}", y, mm(),
                         phase=8)
    w64 = torch.zeros((8, 64), dtype=torch.bfloat16, device=dev)
    for c in counters.values():
        c.launches = 0
    try:
        pw.pw_matmul(inp.x2[:1000], w64)
    except ValueError as e:
        log(f"[8] pw_matmul (1000, 8) @ (8, 64) refused: {e}")
    else:
        raise AssertionError("pw_matmul took a shape it is not compiled for")
    torch.cuda.synchronize()
    if pw.pw_matmul.launches:
        raise AssertionError("the refused product launched")
    del inp, y
    pwr = bpw.run(dev, log=lambda line: log("[8] " + line))

    # P3: every mode at the tool's four geometries in both storages against
    # the plain versions (batch P3_CHECK_BATCH), then the bisection at the
    # tool's batch in bf16: each mode chained P3_ITERS times, counted, then
    # timed
    err["P3"] = 0.0
    rng = np.random.RandomState(1)
    for geom in bs.GEOMS:
        for dt in ("float32", "bfloat16"):
            g = bs.make_geom(geom, P3_CHECK_BATCH, getattr(torch, dt), rng,
                             dev)
            for mode in bv.MODES:
                err["P3"] = max(err["P3"], check_kernel(
                    f"P3 {mode:8s} {geom[0]}",
                    bv.block_variant(mode, g.x0, g.vp),
                    bv.variant_plain(mode, g.x0, g.vp), p3_tols(mode), 8))
            # full launches K1's own code: K1's wrapper gives the same bits
            check_kernel(f"P3 full     {geom[0]} against K1",
                         bv.block_variant("full", g.x0, g.vp),
                         bf.fused_block(g.x0, bv.k1_params(g.vp)), EXACT, 8)
    p3 = dict(ms=0.0, plain_ms=0.0, launches=0, chain=0.0, tpose=0.0,
              full=0.0, work=bb.Work(), alone=dict.fromkeys(bv.MODES, 0.0))
    rng = np.random.RandomState(0)
    for geom in bs.GEOMS:
        g = bs.make_geom(geom, P3_BATCH, torch.bfloat16, rng, dev)
        for mode in bv.MODES:
            _, counts = counted(counters,
                                lambda: bs.run_chain(g, mode, P3_ITERS))
            p3["launches"] += only(f"P3 {mode} {geom[0]} chained {P3_ITERS}"
                                   f" times", counts, "P3", P3_ITERS)
        row = bs.run_geom(g, bv.MODES, P3_ITERS, dev, "bf16",
                          log=lambda line: log("[8] " + line))
        plain = {m: cuda_ms(lambda: bv.variant_plain(m, g.x0, g.vp), 2, 1)
                 for m in bv.MODES}
        log("[8]   plain versions, ms: " + ", ".join(
            f"{m} {v:.4f}" for m, v in plain.items()))
        # each mode alone: its launches in a CUDA graph, replays timed
        out = torch.empty_like(g.x0)
        alone = {m: bb.graph_launch_ms(
            lambda: bv.block_variant(m, g.x0, g.vp, out=out))
            for m in bv.MODES}
        log("[8]   alone (CUDA-graph replays), ms: " + ", ".join(
            f"{m} {v:.4f}" for m, v in alone.items()))
        for m, v in alone.items():
            p3["alone"][m] += v
        p3["ms"] += sum(row[m] for m in bv.MODES) / 1e3
        p3["plain_ms"] += sum(plain.values())
        p3["work"] += sum((bs.mode_work(m, g) for m in bv.MODES), bb.Work())
        for k, r in (("chain", "xla"), ("tpose", "tpose"), ("full", "full")):
            p3[k] += row[r] / 1e3
        del g, out
    log(f"[8] P3 the 4 geometries by mode alone (CUDA-graph replays), bf16 "
        f"batch {P3_BATCH}: " + ", ".join(
            f"{m} {v:.4f}" for m, v in p3["alone"].items())
        + f"; all {sum(p3['alone'].values()):.4f} ms")
    log(f"[8] P3 the 4 geometries x 7 modes, bf16 batch {P3_BATCH}, one "
        f"launch each: kernel {p3['ms']:.4f} ms (bound "
        f"{p3['work'].bound()[0]:.4f} ms), plain {p3['plain_ms']:.4f} ms; "
        f"full alone {p3['full']:.4f} ms, the cuDNN chain {p3['chain']:.4f}"
        f" ms, the layout round trip {p3['tpose']:.4f} ms")

    # P4 and P5 on the sweep's inputs, bit for bit
    times = {}
    for probe in rb.PROBES:
        key, x = probe.kernel, probe.make_input(dev)
        y, counts = counted(counters, lambda: probe.run(x))
        launches[key] = only(f"{key} {probe.name}", counts, key, 1)
        err[key] = check_kernel(f"{key} {probe.name} {tuple(x.shape)}", y,
                                probe.plain(x), EXACT, 8)
        # the library call of the same function: P4 a strided copy, P5 a
        # gather of the rows of its row map (made once, outside the timing)
        if key == "P4":
            p4_path(mp, "the sweep's input", x, y)
            library = lambda: x[::2].contiguous()
        else:
            rows = mp.dynslice_rows(x.shape[0] // 2, 3, dev)
            library = lambda: x.index_select(0, rows)
        check_kernel(f"{key} {probe.name} against the library call", y,
                     library(), EXACT, 8)
        # by events (host time between the launches included), then alone:
        # 20 launches in one CUDA graph, its replays between CUDA events
        t = times[key] = dict(
            ms=cuda_ms(lambda: probe.run(x), 200),
            plain=cuda_ms(lambda: probe.plain(x), 200),
            library=cuda_ms(library, 200),
            alone=bb.graph_launch_ms(lambda: probe.run(x)),
            library_alone=bb.graph_launch_ms(library),
            work=bb.Work(2 * y.numel() * y.element_size()))
        log(f"[8] {key} {probe.name}: kernel {t['ms']:.4f} ms, alone "
            f"{t['alone']:.5f} ms; plain {t['plain']:.4f} ms; "
            f"{'x[::2].contiguous()' if key == 'P4' else 'index_select'} "
            f"{t['library']:.4f} ms, alone {t['library_alone']:.5f} ms; "
            f"bound {t['work'].bound()[0]:.7f} ms")
    times["P4"]["more"] = p4_large(mp, bb, dev)

    return [
        kernel_entry(name, "pw_matmul.cu", f"tools/bench_pw_kernels.py:{line}",
                     launches[key], err[key], pwr[tag], pwr[tag + "_plain"],
                     pwr[tag + "_work"], pwr[tag + "_library"],
                     kernel_alone_ms=pwr[tag + "_alone"])
        for name, key, tag, line in (("pw_matmul_2d", "P1", "B", 61),
                                     ("pw_matmul_packed", "P2", "C", 85))
    ] + [
        kernel_entry("block_variants", "block_variants.cu",
                     "tools/bisect_smallc.py:182", p3["launches"], err["P3"],
                     p3["ms"], p3["plain_ms"], p3["work"],
                     cudnn_chain_ms=p3["chain"], full_ms=p3["full"],
                     tpose_ms=p3["tpose"],
                     kernel_alone_ms=sum(p3["alone"].values()),
                     alone_ms_by_mode=p3["alone"]),
    ] + [kernel_entry(name, "mosaic_probes.cu",
                      f"tools/retest_backend_bugs.py:{line}", launches[key],
                      err[key], times[key]["ms"], times[key]["plain"],
                      times[key]["work"], times[key]["library"],
                      kernel_alone_ms=times[key]["alone"],
                      library_alone_ms=times[key]["library_alone"],
                      **times[key].get("more", {}))
         for name, key, line in (("strided_rows", "P4", 73),
                                 ("dynslice_carry", "P5", 92))]


def bmp_bytes(img) -> bytes:
    """A 24-bit BMP of a (H, W, 3) uint8 BGR frame, rows top-down (a
    negative height), as ``bmp_decode`` reads it."""
    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img.reshape(h, w * 3)
    data = rows.tobytes()
    return struct.pack("<HIHHIIiiHHIIIIII", 0x4D42, 54 + len(data), 0, 0,
                       54, 40, w, -h, 1, 24, 0, len(data), 0, 0, 0,
                       0) + data


def check_path_counts(tag: str, ran, wrapped, want, calls: int,
                      phase: int = 9) -> None:
    """A path's kernels over ``calls`` detects that replay their buckets
    (``ran``, ``kernel_events``): ``want`` (one forward's, WANT_COUNTS)
    times ``calls``, one K2 a call, and no wrapper counts (``wrapped``: no
    launch from Python, no bucket built)."""
    log(f"[{phase}] {tag}: kernels run " + " ".join(f"{k} {v}" for k, v in
                                             ran.items())
        + f"; wrapper counts {sum(wrapped.values())}")
    if ran["K2"] != calls or any(wrapped.values()) or any(
            ran[k] != want[k] * calls for k in KERNEL_SYMBOLS if k != "K2"):
        log_device_rows()
        raise AssertionError(f"{tag} did not run its kernels {calls} times")


def stream_checks(nets, frames, counters) -> None:
    """Each fast path: ``detect_stream`` at depth 2 and 3 over four batches
    of one bucket, the kernels it ran counted (``kernel_events``), against
    serial ``detect``, at
    the CPU tests' tolerances (class, score to 1e-6, box to 1e-4 px)."""
    batches = [frames[i * 8:(i + 1) * 8] for i in range(4)]
    for tag, n in nets.items():
        serial = [n.detect(b) for b in batches]
        for depth in STREAM_DEPTHS:
            got, ran, wrapped = kernel_events(counters, lambda: list(
                n.detect_stream(batches, depth=depth)))
            check_path_counts(f"{tag} detect_stream depth {depth}", ran,
                              wrapped, WANT_COUNTS[tag], len(batches))
            ok = len(got) == len(serial) and all(
                len(gi) == len(si) and all(
                    a.class_id == b.class_id and abs(a.score - b.score) < 1e-6
                    and max(abs(u - v) for u, v in zip(a[2:], b[2:])) < 1e-4
                    for a, b in zip(gi, si))
                for g, s_ in zip(got, serial) for gi, si in zip(g, s_))
            log(f"[9] {tag} detect_stream depth {depth}, 4 batches of 8: "
                f"{sum(len(d) for g in got for d in g)} detections, bit for "
                f"bit with serial detect: {got == serial} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} detect_stream differs from "
                                     f"detect")


def serve_phase(pt, rnet, frames, counters) -> dict:
    """Phase 9: the HTTP server on the region Net.  Warm the batch buckets
    1-64, send SERVE_REQUESTS concurrent POST /detect (the fixture BMP and
    seeded frames, SERVE_CLIENTS client threads) with the kernels the card
    ran counted around them (``kernel_events``), hold each answer against the eager card path's
    candidates (phase 4's tolerances), read /statz.  Returns /statz."""
    import concurrent.futures
    import http.client
    import threading
    import torch
    from ffcnn_tpu_torch.ops.yolo import concat_heads, decode_head
    from ffcnn_tpu_torch.serve import DetectorService, make_server
    imgs = frames[:SERVE_FRAMES]
    with open(BMP, "rb") as f:
        bodies = [f.read()] + [bmp_bytes(im) for im in imgs[1:]]
    if not np.array_equal(pt.bmp_load(BMP), imgs[0]):
        raise AssertionError("the first frame is not the fixture")
    heads = [l for l in rnet.ir.layers if l.type == pt.LayerType.YOLO]
    feats = rnet.forward_heads(torch.from_numpy(imgs).to(rnet.device))
    b0 = rnet.ir.blobs[0]
    cands = concat_heads([decode_head(h.float().cpu(), l, b0.w, b0.h)
                          for h, l in zip(feats, heads)])
    service = DetectorService(rnet, max_batch=BATCH)
    t0 = time.perf_counter()
    service.warmup()
    log(f"[9] server warmup, batch buckets {list(service._warm_batches)}: "
        f"{time.perf_counter() - t0:.2f} s; ready {service.ready}")
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]

    def post(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/detect", body=bodies[i % len(bodies)])
            r = conn.getresponse()
            return i, r.status, json.loads(r.read())
        finally:
            conn.close()

    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as ex:
            answers, ran, wrapped = kernel_events(counters, lambda: list(
                ex.map(post, range(SERVE_REQUESTS))))
        wall = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/statz")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        service._batcher.close()
        thread.join(timeout=30)
    worst, ndet = 1.0, 0
    for i, status, body in answers:
        if status != 200:
            raise AssertionError(f"request {i}: HTTP {status} {body}")
        dets = [pt.Detection(d["score"], d["class_id"], *d["box"])
                for d in body["detections"]]
        ndet += len(dets)
        j = i % len(bodies)
        fr = match_fraction(dets, *(t[j].numpy() for t in cands),
                            DET_MATCH_PX, DET_MATCH_SCORE)
        worst = min(worst, fr)
        if fr < DET_MATCH_FRAC:
            raise AssertionError(f"request {i} (frame {j}): {fr:.3f} of its "
                                 f"detections among the eager candidates")
    log(f"[9] {SERVE_REQUESTS} POST /detect from {SERVE_CLIENTS} threads in "
        f"{wall:.3f} s ({SERVE_REQUESTS / wall:.1f} requests/s): all 200, "
        f"{ndet} detections, worst share among the eager card path's "
        f"candidates {worst:.3f} ok")
    log(f"[9] /statz: dispatches {stats['dispatches']}, images "
        f"{stats['images']}, batch histogram {stats['batch_hist']}, "
        f"dispatch p50 {stats['dispatch_p50_ms']} ms, p99 "
        f"{stats['dispatch_p99_ms']} ms, errors {stats['dispatch_errors']}")
    if stats["images"] < SERVE_REQUESTS or stats["dispatch_errors"]:
        raise AssertionError(f"/statz disagrees: {stats}")
    # the warmup's probes dispatched no round: every dispatch is a request
    check_path_counts(f"server, {stats['dispatches']} dispatches", ran,
                      wrapped, WANT_COUNTS["region"], stats["dispatches"])
    return stats


def graph_checks(rnet, frames) -> None:
    """Phase 9: ``memory_stats`` at batch 1 and 64, and a replay (a batch on
    the card, then a host batch) under sync-debug mode "error"."""
    import torch
    for nb in (1, BATCH):
        m = rnet.memory_stats(batch_size=nb)
        ok = m["peak"] >= m["args"] + m["output"] > 0 and m["temp"] >= 0
        log(f"[9] region memory_stats batch {nb}: " + ", ".join(
            f"{k} {v / 2**20:.3f} MiB" for k, v in m.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"memory_stats at batch {nb}: {m}")
    xb = torch.from_numpy(frames).to("cuda")
    want = rnet.detect_device(xb)
    rnet.detect_device(frames)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rnet.detect_device(xb)
        host = rnet.detect_device(frames)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got, want, host))
    log(f"[9] region detect_device batch {BATCH} under sync-debug 'error', "
        f"a batch on the card and a host batch: no synchronising call; "
        f"results equal the last replay's: {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("replays of one batch differ")


def run_cli(argv) -> str:
    """``ffcnn_tpu_torch.cli.main(argv)`` (on the card: no ``--device``)
    with its standard output captured and returned."""
    from ffcnn_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def det_lines(dets, indent: str = "") -> list:
    """Detections as the CLI prints them."""
    return [indent + "score: %.2f, category: %2d, rect: (%3d %3d %3d %3d)"
            % (d.score, d.class_id, int(d.x1), int(d.y1), int(d.x2),
               int(d.y2)) for d in dets]


def scope_counts(rep) -> dict:
    """{kernel: {layer range or -1: events}} of a profile report, the path
    kernels found by their symbols (KERNEL_SYMBOLS)."""
    out = {k: {} for k in KERNEL_SYMBOLS}
    for li, names in rep.kernels.items():
        for name, n in names.items():
            for k, pat in KERNEL_SYMBOLS.items():
                if re.search(pat, name):
                    out[k][li] = out[k].get(li, 0) + n
    return out


def cli_phase(pt, frames) -> None:
    """Phase 10, the command line on the card through ``cli.main``: detect
    in parity and fast mode against ``Net.detect`` (score lines) and
    ``draw_rectangle`` (the output BMP's bytes); dump against
    ``Net.dump``; roofline and profile at batch 64 under the region flags,
    the profile's kernels in their layer ranges; batch over three BMPs
    against ``Net.detect``, one image a chunk and all three in one."""
    import torch
    from ffcnn_tpu_torch.imageio.bmp import bmp_save, draw_rectangle
    bgr = pt.bmp_load(BMP)
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "xl.weights")
        with open(wpath, "wb") as f:
            f.write(pt.synth_weights_bytes(pt.parse_cfg(CFG), seed=SEED,
                                           obj_bias=2.0))
        for mode in ("parity", "fast"):
            out = os.path.join(tmp, f"{mode}.bmp")
            got = run_cli(["detect", BMP, "--cfg", CFG, "--weights", wpath,
                           "--mode", mode, "-o", out]).splitlines()
            net = pt.load(CFG, wpath, input_w=320, input_h=320, mode=mode,
                          device="cuda")
            dets = net.detect(bgr)
            drawn = bgr.copy()
            for d in dets:
                draw_rectangle(drawn, int(d.x1), int(d.y1), int(d.x2),
                               int(d.y2), 0, 255, 0)
            ref = os.path.join(tmp, f"{mode}_drawn.bmp")
            bmp_save(ref, drawn)
            with open(out, "rb") as a, open(ref, "rb") as b:
                same_bmp = a.read() == b.read()
            same = got[1:] == det_lines(dets)
            log(f"[10] cli detect --mode {mode}: '{got[0]}', {len(dets)} "
                f"detections; score lines equal Net.detect's: {same}; -o "
                f"BMP equals draw_rectangle's bytes: {same_bmp}")
            if not (same and same_bmp and dets):
                raise AssertionError(f"cli detect {mode} disagrees")
        dump = run_cli(["dump", "--cfg", CFG])
        log(f"[10] cli dump: {len(dump.splitlines())} lines, equal to "
            f"Net.dump(): {dump == net.dump()}")
        if dump != net.dump():
            raise AssertionError("cli dump differs from Net.dump")
        with environ(REGION_FLAGS):
            roof = run_cli(["roofline", "--cfg", CFG, "--batch", "64"])
            ok = "TOTAL" in roof and "fused runs: L1-80, L81-108" in roof
            for line in roof.splitlines():
                log(f"[10] cli roofline: {line}")
            if not ok:
                raise AssertionError("cli roofline lacks TOTAL or the runs")
            t0 = time.perf_counter()
            prof = run_cli(["profile", "--cfg", CFG, "--weights", wpath,
                            "--batch", str(BATCH)])
            log(f"[10] cli profile --batch {BATCH} under the region flags "
                f"({time.perf_counter() - t0:.1f} s):")
            for line in prof.splitlines():
                log(f"[10]   {line}")
            want = (f"profile (device us per step on "
                    f"{torch.cuda.get_device_name(0)}, 10 steps averaged)")
            if not prof.startswith(want) or "replay" not in prof \
                    or f"memory (batch {BATCH}): peak" not in prof:
                raise AssertionError("cli profile printed no device table")
            rnet = pt.load(CFG, wpath, mode="fast", device="cuda")
        profile_check(rnet, PROFILE_ITERS)
        # a strided batch (as numpy lays out some broadcast sums) takes the
        # stem kernel's path too, bit for bit with the dense one
        dense = torch.from_numpy(frames[:4]).to("cuda")
        strided = dense.transpose(1, 2).contiguous().transpose(1, 2)
        same = all(torch.equal(a, b) for a, b in zip(
            rnet.forward_heads(strided), rnet.forward_heads(dense)))
        log(f"[10] region forward_heads of a strided batch (strides "
            f"{strided.stride()}) equal the dense batch's: {same}")
        if strided.is_contiguous() or not same:
            raise AssertionError("the strided batch's heads differ")
        paths = [BMP]
        for i in (1, 2):
            paths.append(os.path.join(tmp, f"frame{i}.bmp"))
            bmp_save(paths[-1], frames[i])
        imgs = np.stack([pt.bmp_load(p) for p in paths])
        fnet = pt.load(CFG, wpath, mode="fast", device="cuda")
        for chunk, dets in ((1, [fnet.detect(im) for im in imgs]),
                            (BATCH, fnet.detect(imgs))):
            got = run_cli(["batch", *paths, "--cfg", CFG, "--weights",
                           wpath, "--batch", str(chunk)]).splitlines()
            want = [x for p, d in zip(paths, dets)
                    for x in [p] + det_lines(d, "  ")]
            log(f"[10] cli batch of 3 BMPs, chunks of {min(chunk, 3)}: "
                f"'{got[0]}'; {sum(map(len, dets))} detections, equal to "
                f"Net.detect's on each: {got[1:] == want}")
            if got[1:] != want:
                raise AssertionError("cli batch differs from Net.detect")


def profile_check(rnet, iters: int) -> None:
    """``Net.profile_layers`` on the region Net at batch 64 (the call the
    CLI's profile makes): every K1, K3, K6 and K7 event in the layer range
    of its dispatch (the stem's L000, the runs' L001 and L081, the chain's
    L116), as many as ``iters`` forwards launch; K2 outside every range
    (other), K4, K5 nowhere; the ten largest rows and the replay's time."""
    rep = rnet.profile_layers(batch=np.zeros((BATCH, 320, 320, 3), np.uint8),
                              iters=iters)
    counts = scope_counts(rep)
    where = {"K1": {1, 81}, "K3": {1, 81}, "K6": {0}, "K7": {116},
             "K2": {-1}, "K4": set(), "K5": set()}
    want = dict(WANT_COUNTS["region"], K2=1)
    top = sorted(rep.layers, key=lambda lp: -lp.us_per_step)[:10]
    for lp in top:
        log(f"[10]   row L{lp.index:03d} {lp.type_name:9s} {lp.desc:40s} "
            f"{lp.us_per_step:10.1f} us, floor "
            f"{rep.floors_us.get(lp.index, 0.0):9.1f} us")
    log(f"[10] profile_layers region batch {BATCH}, {iters} steps on "
        f"{rep.device}: total {rep.total_us:.1f} us a step (device), other "
        f"{rep.other_us:.1f} us, the bucket's replay {rep.replay_us:.1f} us;"
        f" path kernels by range: {counts}")
    ok = all(set(counts[k]) <= where[k]
             and sum(counts[k].values()) == want[k] * iters
             for k in where) and all(
        rep.layers[li].us_per_step > 0 for li in (0, 1, 81, 116))
    if not ok:
        raise AssertionError("a path kernel fell outside its layer range")


def scope_cost(nets) -> None:
    """What the layer ranges cost the eager path: one record_function
    entered and left with the profiler off, times the ranges of one
    forward on each path."""
    from torch.profiler import record_function
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function("L000_conv"):
            pass
    us = (time.perf_counter() - t0) / n * 1e6
    for tag, net in nets.items():
        runs = list(net._fused_runs) + list(net._head_runs)
        ranges = len(net.ir.layers) - sum(r.end - r.start for r in runs)
        log(f"[10] a layer range (record_function, profiler off): {us:.3f} "
            f"us on the host; {tag}'s eager forward enters {ranges}: "
            f"{us * ranges / 1e3:.4f} ms")


def copy_rate(dev) -> None:
    """A device-to-device copy of 1 GiB by CUDA events: the card's memory
    rate as PyTorch's copy reaches it (read and write counted)."""
    import torch
    src = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), iters=20)
    log(f"[10] copy of 1 GiB on the card: {ms:.4f} ms, "
        f"{2 * src.numel() / ms / 1e6:.1f} GB/s read and written (published"
        f" peak 3350)")
    del src, dst


def bench_phase() -> None:
    """Phase 10, the port's bench, short: ``--batches 64,256 --windows 3
    --iters 10`` (10 calls a window, not 30, since phase 16 joined the run)
    with no flag, then with the region flags; each prints its JSON line."""
    from ffcnn_tpu_torch import bench
    for tag, flags in (("default", {}), ("region", REGION_FLAGS)):
        t0 = time.perf_counter()
        with environ(flags):
            row = bench.main(["--batches", "64,256", "--windows", "3",
                              "--iters", "10"])
        log(f"[10] bench {tag} ({time.perf_counter() - t0:.1f} s): "
            f"{row['value']:.1f} img/s at batch {row['batch']}, mfu "
            f"{row['mfu']:.4%}, parity {row['parity_img_s']:.1f}, stream "
            f"{row['stream_host_input_img_s']:.1f}, 640x448 "
            f"{row['demo_640x448_img_s']:.1f}, batch 1 p50 "
            f"{row['p50_batch1_ms']:.3f} ms, device "
            f"{row['batch1_device_ms']:.3f} ms; int8 (informational) "
            f"{row['int8_img_s']:.1f} img/s at batch {row['int8_batch']}")
        if not row["int8_img_s"] > 0:
            raise AssertionError("the bench's int8 row is empty")


def median_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``reps`` calls of ``fn``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fs_of(path: str) -> str:
    """The type of the file system that holds ``path`` (/proc/mounts)."""
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) \
                    and len(mount) > len(best):
                best, kind = mount, fstype
    return f"{kind} ({best})"


def codec_phase(pt, wbytes, counters) -> None:
    """Phase 15, the BMP codec on the card's host: the codec loaded from
    ``_build/``; CODEC_FRAMES seeded 320x320 frames written by ``bmp_save``
    (a few bit for bit against ``bmp_save_plain``); ``load_batch`` of a
    chunk bit for bit against ``load_batch_plain``, both timed; ``cli
    batch`` over every frame under the region flags, its lines against
    ``Net.detect``'s and the region path's kernels counted around it,
    beside the loader's and ``detect_device``'s ms a chunk; ``Net.load``
    timed."""
    import torch
    from ffcnn_tpu_torch.imageio import bmp, loader, native
    t_phase = time.perf_counter()
    lib = native.codec().__file__
    if lib != str(native.library_path()) or \
            os.path.dirname(lib) != str(native.BUILD_DIR):
        raise AssertionError(f"the codec was loaded from {lib}")
    cpus, usable = os.cpu_count(), len(os.sched_getaffinity(0))
    log(f"[15] codec {os.path.relpath(lib, REPO)} (gcc at first use); host "
        f"os.cpu_count() {cpus}, usable cores {usable}; card {card_line()}")
    frames = np.random.RandomState(SEED).randint(
        0, 256, (CODEC_FRAMES, 320, 320, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"frame{i:03d}.bmp")
                 for i in range(CODEC_FRAMES)]
        t0 = time.perf_counter()
        for path, frame in zip(paths, frames):
            bmp.bmp_save(path, frame)
        save_s = time.perf_counter() - t0
        plain = os.path.join(tmp, "plain.bmp")
        checked = (0, 1, CODEC_FRAMES // 2, CODEC_FRAMES - 1)
        for i in checked:
            bmp.bmp_save_plain(plain, frames[i])
            with open(paths[i], "rb") as a, open(plain, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"bmp_save of frame {i} differs "
                                         f"from bmp_save_plain")
        chunk = paths[:CODEC_CHUNK]
        got = loader.load_batch(chunk)
        if not (np.array_equal(got, loader.load_batch_plain(chunk))
                and np.array_equal(got, frames[:CODEC_CHUNK])):
            raise AssertionError("load_batch differs from load_batch_plain")
        log(f"[15] bmp_save wrote {CODEC_FRAMES} frames in {save_s:.3f} s, "
            f"frames {checked} bit for bit with bmp_save_plain; load_batch "
            f"of {CODEC_CHUNK} bit for bit with load_batch_plain and the "
            f"frames")
        # the files were just written and read: the page cache is warm
        def read_files():
            for path in chunk:
                with open(path, "rb") as f:
                    f.read()

        ms = {}
        for name, fn in (("codec", loader.load_batch),
                         ("codec, 1 thread", lambda c: loader.load_batch(c,
                                                                         1)),
                         ("thread pool", loader.load_batch_plain),
                         ("open and read alone", lambda c: read_files())):
            fn(chunk)
            ms[name] = median_ms(lambda: fn(chunk), LOADER_REPS)
        log(f"[15] {CODEC_CHUNK} frames of 320x320 in {fs_of(tmp)} (kernel "
            f"{os.uname().release}), warm page cache, median of "
            f"{LOADER_REPS} after one warm-up: codec load_batch "
            f"{ms['codec']:.3f} ms ({min(64, cpus, CODEC_CHUNK)} pthreads; "
            f"1 pthread {ms['codec, 1 thread']:.3f} ms), thread pool "
            f"load_batch_plain {ms['thread pool']:.3f} ms ({min(32, cpus)} "
            f"threads), {ms['thread pool'] / ms['codec']:.2f}x; each file "
            f"opened and read whole in one Python thread "
            f"{ms['open and read alone']:.3f} ms")

        wpath = os.path.join(tmp, "xl.weights")
        with open(wpath, "wb") as f:
            f.write(wbytes)
        with environ(REGION_FLAGS):
            net = pt.load(CFG, wpath, input_w=320, input_h=320,
                          mode="fast", device="cuda")
            dets = []
            for i in range(0, CODEC_FRAMES, CODEC_CHUNK):
                dets += net.detect(frames[i:i + CODEC_CHUNK])
            out, counts = counted(counters, lambda: run_cli(
                ["batch", *paths, "--cfg", CFG, "--weights", wpath,
                 "--batch", str(CODEC_CHUNK)]))
            got = out.splitlines()
            want = [x for p, d in zip(paths, dets)
                    for x in [p] + det_lines(d, "  ")]
            log(f"[15] cli batch of {CODEC_FRAMES} BMPs, --batch "
                f"{CODEC_CHUNK}, region flags: '{got[0]}'; "
                f"{sum(map(len, dets))} detections, equal to Net.detect's: "
                f"{got[1:] == want}; launches "
                + " ".join(f"{k} {v}" for k, v in counts.items()))
            if got[1:] != want:
                raise AssertionError("cli batch differs from Net.detect")
            region = ("K1", "K2", "K3", "K6", "K7")
            if any(counts[k] == 0 for k in region) or any(
                    v for k, v in counts.items() if k not in region):
                raise AssertionError("cli batch did not run the region "
                                     "path's kernels")
            img_s = float(re.search(r"\(([0-9.]+) img/s\)",
                                    got[0]).group(1))
            x = frames[:CODEC_CHUNK]
            dev_ms = cuda_ms(lambda: net.detect_device(x), 10, 2)
            xd = torch.from_numpy(x).to("cuda")
            card_ms = cuda_ms(lambda: net.detect_device(xd), 10, 2)
            log(f"[15] a chunk of {CODEC_CHUNK}: decode (codec) "
                f"{ms['codec']:.3f} ms, detect_device (a bucket's replay) "
                f"{dev_ms:.3f} ms from host frames, {card_ms:.3f} ms from "
                f"frames on the card; cli batch {img_s:.1f} "
                f"img/s = {CODEC_CHUNK / img_s * 1e3:.3f} ms a chunk; the "
                f"slower of the two: "
                f"{'decode' if ms['codec'] > dev_ms else 'the card'}")
            del net
            loads = []
            for _ in range(NET_LOAD_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net = pt.load(CFG, wpath, input_w=320, input_h=320,
                              mode="fast", device="cuda")
                torch.cuda.synchronize()
                loads.append(time.perf_counter() - t0)
                del net
        log(f"[15] Net.load of xl from the weights file (parse, read, fold, "
            f"upload), region flags: median of {NET_LOAD_REPS} "
            f"{statistics.median(loads):.3f} s (each "
            + ", ".join(f"{t:.3f}" for t in loads) + ")")
    log(f"[15] phase 15 took {time.perf_counter() - t_phase:.1f} s")


def plan_counts(net) -> dict:
    """The K1, K3, K6, K7 and int8 conv launches one forward of a
    region-style Net makes, from its plan (each block one launch, no
    cascade or mega; K6 where the stem's guard holds: an int8 plan keeps
    layer 0 and blob 1 float on xl)."""
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch.quant import unfused_int8
    blocks = [b for r in net._fused_runs for b in r.blocks]
    c0 = net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[1]
    return {"K1": sum(not b.down for b in blocks),
            "K3": sum(b.down for b in blocks), "K4": 0, "K5": 0,
            "K6": int(c0 is not None), "K7": len(net._head_runs),
            "conv_int8": len(unfused_int8(net)) if net.quant else 0}


def segments_check(tag: str, net, x, cuts) -> None:
    """``forward_features`` of a parity Net on the card in two segments at
    each cut (the first passing on ``live_blobs``) against the whole
    forward, bit for bit."""
    import torch
    from ffcnn_tpu_torch.graph.build import forward_features, live_blobs
    from ffcnn_tpu_torch.net import _tf32
    ir = net.ir
    with _tf32(False):
        whole = forward_features(ir, net.params, x)
        for cut in cuts:
            h1, kept = forward_features(ir, net.params, x, stop=cut,
                                        keep_blobs=live_blobs(ir, cut))
            h2 = forward_features(ir, net.params, None, start=cut,
                                  blobs_in=kept)
            same = len(h1 + h2) == len(whole) and all(
                torch.equal(a, b) for a, b in zip(h1 + h2, whole))
            log(f"[11] {tag} parity forward_features in two segments, cut "
                f"at layer {cut} (blobs {sorted(kept)} passed on): "
                f"{len(h1)} + {len(h2)} heads, bit for bit with the whole "
                f"forward: {same}")
            if not same:
                raise AssertionError(f"{tag} segments at {cut} differ")


def v8_phase(pt, counters, xl_wbytes, xl_frames, xl_pnet) -> dict:
    """Phase 11, its checks (run after phase 9's server, before the timing
    phases' traces): YOLOv8n at 640x640 converted from a synthesized state
    dict, in parity and fast mode on the card against the CPU; its bucket's
    replay (K2 once a call); K2 in union IoU bit for bit at V8_KS, and
    timed; the segments of xl and v8n; the float32 knobs on xl's region
    Net; ``cli convert-v8``, ``detect`` and ``roofline``.  Returns what
    the timings (``v8_times``) take and K2's union times."""
    import torch
    from ffcnn_tpu_torch import yolov8
    from ffcnn_tpu_torch.darknet.weights import load_weights
    from ffcnn_tpu_torch.kernels import nms as knms
    from ffcnn_tpu_torch.net import WARMUP_RUNS
    t0 = time.perf_counter()
    sd = yolov8.synthesize_state_dict(80, "n", seed=0)
    cfg, wbytes = yolov8.convert(sd, 80, "n", size=V8_SIZE, conf=V8_CONF)
    ir = pt.parse_cfg(cfg, is_path=False)
    params, _ = load_weights(ir, wbytes)
    nets = {(m, d): pt.Net(ir, params, mode=m, device=d)
            for m in ("parity", "fast") for d in ("cuda", "cpu")}
    heads = [(li, l.stride) for li, l in enumerate(ir.layers)
             if l.type == pt.LayerType.YOLOV8]
    max_k = nets["fast", "cuda"]._max_candidates()
    log(f"[11] v8n {V8_SIZE}x{V8_SIZE}: {len(ir.layers)} layers, heads "
        f"{heads}, {len(wbytes)} weight bytes, candidates {max_k}, fused "
        f"runs {nets['fast', 'cuda']._fused_runs}")
    if max_k != V8_KS[-1] or nets["fast", "cuda"]._fused_runs:
        raise AssertionError("unexpected v8n graph")
    rng = np.random.RandomState(SEED)
    seeded = rng.randint(0, 256, (2, V8_SIZE, V8_SIZE, 3), dtype=np.uint8)
    fixture = pt.bmp_load(BMP)[None]

    # parity on the card against parity on the CPU, the seeded frames and
    # the letterboxed fixture.  The synthesized v8n collapses over its
    # depth (2,000 live candidates of two classes on a seeded frame, the
    # top scores equal to 1e-8), so greedy NMS keeps one of two tied
    # candidates by float32 noise: parity is held on the candidates and
    # the tail (bench.parity_candidates), as tests/test_model_zoo.py holds
    # its TIE_PRONE model; the card's detect (a bucket per K as parity
    # mode grows it) must find detections
    from ffcnn_tpu_torch.bench import parity_candidates
    pnet = nets["parity", "cuda"]
    for what, batch in (("2 seeded frames", seeded[:2]),
                        ("the 320x320 fixture", fixture)):
        n = parity_candidates(pnet, nets["parity", "cpu"], batch)
        pg = pnet.detect(batch)
        ks = sorted(k[3] for k in pnet._pipelines if k[0] == batch.shape[1])
        log(f"[11] v8n parity card vs CPU, {what}: {n} live candidates "
            f"equal (class, score to {PARITY_SCORE_TOL}, box to 1e-4 of the"
            f" range), the card's tail on the CPU's candidates bit for bit;"
            f" the card's detect: {[len(d) for d in pg]} detections, "
            f"buckets replayed at K {ks}")
        if not (n and any(pg)):
            raise AssertionError("v8n parity found nothing to compare")
        check_dets("v8n parity", pg)

    # fast: the first detect builds the bucket (no K1-K7, K2 each run),
    # its replay runs one K2, and the card holds to the CPU
    fnet = nets["fast", "cuda"]
    built = WARMUP_RUNS + 1
    dets, counts = counted(counters, lambda: fnet.detect(seeded))
    log(f"[11] v8n fast detect batch {len(seeded)}, its bucket built in "
        f"the call: {[len(d) for d in dets]} detections; launches "
        + " ".join(f"{k} {v}" for k, v in counts.items()))
    if counts["K2"] != built or any(v for k, v in counts.items()
                                    if k != "K2"):
        raise AssertionError("the v8n path did not launch K2 alone")
    check_dets("v8n fast", dets)
    check_replay("v8n", fnet, counters, seeded, dets)
    check_against_cpu("v8n", fnet, nets["fast", "cpu"], seeded, dets, 11)

    # K2 in union IoU against its plain version, bit for bit, up to v8n's
    # 8,400 candidates (past the 8,192 it stages in shared memory); at
    # batch 64 also timed (here, before the timing phases' traces: late in
    # a run torch.profiler dropped some of the kernel's events) by CUDA
    # events, by the kernel's device time alone and beside its bound, the
    # plain version's one checked call timed by events
    from ffcnn_tpu_torch import bench_block as bb
    from ffcnn_tpu_torch.bench_block import kernel_alone_ms
    k2 = {}
    for k in V8_KS:
        for nb in ((1, BATCH) if k < 8192 else (BATCH,)):
            tb, ts, tc = (torch.from_numpy(a).to("cuda")
                          for a in nms_candidates(nb, k, seed=k))
            run = lambda: knms.nms_keep_mask(tb, ts, tc, threshold=V8_IOU,
                                             iou_kind="union")
            got = run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = knms.keep_mask_plain(tb, ts, tc, V8_IOU, "union")
            end.record()
            end.synchronize()
            same = torch.equal(got, want)
            log(f"[11] K2 nms union K={k} batch {nb} ({int((ts > 0).sum())}"
                f" live): kept {int(got.sum())}, mismatches "
                f"{int((got != want).sum())}"
                + (", candidates in device memory" if k > 8192 else "")
                + f" {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"K2 union differs from plain at K={k}")
            if nb != BATCH:
                continue
            ms = cuda_ms(run)
            alone = kernel_alone_ms(run, "nms_keep_kernel", 20)
            pms = start.elapsed_time(end)
            bound = bb.Work(BATCH * k * 28,
                            f32_flop=12 * BATCH * k * (k - 1) / 2).bound()[0]
            k2.update({f"union_ms_{k}": ms,
                       f"union_kernel_alone_ms_{k}": alone,
                       f"union_plain_ms_{k}": pms,
                       f"union_bound_ms_{k}": bound})
            log(f"[11] K2 nms union K={k} batch {BATCH}: kernel {ms:.4f} ms,"
                f" kernel alone {alone:.4f} ms (torch.profiler), plain "
                f"{pms:.4f} ms (one call), bound {bound:.4f} ms")

    # segments: two cuts each, xl and v8n in parity
    from ffcnn_tpu_torch.ops.preprocess import letterbox
    for tag, net, fr in (("xl", xl_pnet, xl_frames[:2]), ("v8n", pnet,
                                                          seeded[:2])):
        # the middle, and the last head (the heads split between segments)
        last = max(li for li, l in enumerate(net.ir.layers)
                   if l.type in (pt.LayerType.YOLO, pt.LayerType.YOLOV8))
        x = letterbox(torch.from_numpy(fr).to("cuda"), fr.shape[2],
                      fr.shape[1])
        segments_check(tag, net, x, (len(net.ir.layers) // 2, last))

    # the float32 knobs on xl's region Net: the launches its plan makes
    # after the drop, and the card against the CPU under the same flags
    region = WANT_COUNTS["region"]
    for tag, flags in KNOB_FLAGS.items():
        n = load_net(pt, xl_wbytes, flags, "cuda")
        c = load_net(pt, xl_wbytes, flags, "cpu")
        want = plan_counts(n)
        few = xl_frames[:8]
        dets, counts = counted(counters, lambda: n.detect(few))
        log(f"[11] {tag} ({' '.join(f'{k}={v}' for k, v in flags.items())})"
            f": {len(n._f32_layers)} float32 layers; runs "
            f"{[(r.start, r.end) for r in n._fused_runs]}, head chains "
            f"{[(r.start, r.end) for r in n._head_runs]}; one forward's "
            f"launches by the plan {want}; the first detect (bucket built) "
            + " ".join(f"{k} {v}" for k, v in counts.items()))
        dropped = (want["K7"] == 0 and all(want[k] == region[k] for k in
                                           ("K1", "K3", "K6"))
                   if tag == "head_f32" else want["K1"] < region["K1"])
        if not dropped or counts["K2"] != built or any(
                counts[k] != want[k] * built for k in want) or any(
                counts[k] for k in ("K8", "K9", "P1/P2", "P3", "P4", "P5")):
            raise AssertionError(f"{tag}: launches differ from the plan")
        check_dets(tag, dets)
        check_against_cpu(tag, n, c, few, dets, 11)

    # the command line: convert-v8 on a torch.save'd state dict, then
    # detect and roofline on its two files
    with tempfile.TemporaryDirectory() as tmp:
        sdp, base = os.path.join(tmp, "v8n_sd.pt"), os.path.join(tmp, "v8n")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, sdp)
        out = run_cli(["convert-v8", sdp, "-o", base, "--size",
                       str(V8_SIZE), "--conf", str(V8_CONF)])
        with open(base + ".cfg") as f, open(base + ".weights", "rb") as g:
            same = f.read() == cfg and g.read() == wbytes
        log(f"[11] cli convert-v8: '{out.splitlines()[0]}'; files equal "
            f"convert()'s: {same}")
        bgr = pt.bmp_load(BMP)
        got = run_cli(["detect", BMP, "--cfg", base + ".cfg", "--weights",
                       base + ".weights", "-o", os.path.join(tmp, "o.bmp")]
                      ).splitlines()
        dnet = pt.load(base + ".cfg", base + ".weights", input_w=bgr.shape[1],
                       input_h=bgr.shape[0], mode="parity", device="cuda")
        want = det_lines(dnet.detect(bgr))
        log(f"[11] cli detect (parity) on its files: '{got[0]}', "
            f"{len(want)} detections; score lines equal Net.detect's: "
            f"{got[1:] == want}")
        roof = run_cli(["roofline", "--cfg", base + ".cfg", "--batch", "64",
                        "--size", str(V8_SIZE)])
        total = [line for line in roof.splitlines() if "TOTAL" in line]
        log(f"[11] cli roofline on its cfg, batch 64: {total}")
        if not (same and got[1:] == want and want and total):
            raise AssertionError("cli convert-v8 / detect / roofline failed")
    log(f"[11] phase 11 checks took {time.perf_counter() - t0:.1f} s")
    return {"nets": nets, "seeded": seeded, "k2": k2, "ir": ir,
            "params": params}


def v8_times(v8, dev) -> None:
    """Phase 11, its timings (run last): v8n's ``detect_device`` at batch
    1 and 64, fast and parity, the bucket's replay and the eager pipeline
    in turns by CUDA events, each with its host CPU and device time
    (torch.profiler)."""
    import torch
    t0 = time.perf_counter()
    for mode in ("fast", "parity"):
        net = v8["nets"][mode, "cuda"]
        recaptured(net)
        for nb, iters in ((1, 10), (BATCH, 3)):
            batch = torch.from_numpy(np.resize(
                v8["seeded"], (nb, V8_SIZE, V8_SIZE, 3))).to(dev)
            net.warmup(image_sizes=[(V8_SIZE, V8_SIZE)], batch_sizes=(nb,))
            bucket = lambda: net.detect_device(batch)
            eager = lambda: bucket_of(net, batch).run(batch)
            (e1, e2), (b1, b2) = turns(eager, bucket, iters)
            eh, ed = profiled_ms(eager, 3)
            bh, bd = profiled_ms(bucket, 3)
            log(f"[11] v8n {mode} detect batch {nb}, eager / bucket: events "
                f"{e1:.3f}, {e2:.3f} / {b1:.3f}, {b2:.3f} ms "
                f"({nb / b1 * 1e3:.1f} img/s bucket); torch.profiler host "
                f"CPU {eh:.3f} / {bh:.3f} ms, device {ed:.3f} / {bd:.3f} ms "
                f"a call")
    log(f"[11] phase 11 timings took {time.perf_counter() - t0:.1f} s")


# Phase 12: int8 mode.  The nets' flags (the region configuration's stem
# runs: an int8 plan keeps xl's layer 0 and blob 1 float), the frames a
# plan is calibrated on, xl's default plan's int8 blobs and unfused int8
# convs (ISSUE counts), and the seeded dense convs held beside xl's shapes.
INT8_FLAGS = {"default": {}, "region": REGION_FLAGS}
INT8_CALIB = 8
XL_INT8_BLOBS, XL_INT8_CONVS, XL_INT8_DW = 102, 29, 13
INT8_SEEDED = (("dense 3x3 s1 C64->128 silu", 20, 64, 128, 3, 1, 6, 0.05),
               ("dense 3x3 s2 C64->128 silu", 20, 64, 128, 3, 2, 6, 0.05),
               ("dense 1x1 C96->64 leaky, per-channel requantize", 20, 96,
                64, 1, 1, 2, "perch"),
               ("dense 1x1 C48->272 leaky 13x13", 13, 48, 272, 1, 1, 2,
                0.05),
               ("dense 1x1 C240->240 21x21 bf16", 21, 240, 240, 1, 1, 0,
                None),
               ("dense 1x1 C384->192 leaky 11x11", 11, 384, 192, 1, 1, 2,
                0.05),
               ("dense 1x1 C48->16 13x13 bf16", 13, 48, 16, 1, 1, 0, None),
               ("dense 3x3 s1 C40->24 leaky 9x9", 9, 40, 24, 3, 1, 2, 0.05))
# Seeded depthwise convs (label, H = W, C, k, stride, act, out scale): C
# off the dw path's 16-channel slice (dw4), and the dw path at odd sizes.
INT8_SEEDED_DW = (("depthwise 3x3 s1 C40 21x21", 21, 40, 3, 1, 2, 0.05),
                  ("depthwise 3x3 s2 C48 21x21", 21, 48, 3, 2, 2, 0.05),
                  ("depthwise 5x5 s1 C240 19x19", 19, 240, 5, 1, 2, 0.05),
                  ("depthwise 3x3 s1 C64 23x23 silu, per-channel", 23, 64,
                   3, 1, 6, "perch"))
# v8n's distinct unfused int8 convs: checked at V8_INT8_CHECK, timed at
# V8_INT8_TIME
V8_INT8_CHECK, V8_INT8_TIME = 4, 16
# A code of the kernel may differ from its plain version's by one where
# the plain version's float32 value before rounding lies this close to a
# tie (k + 1/2): another sum order (K1/K3/K4) or another exp (SiLU).
INT8_TIE = 1e-3


def int8_bound(nbytes, tc_ops=0.0, int32_ops=0.0):
    """(ms, "bytes" or "operations"): the least time an H100 takes to move
    ``nbytes`` and run ``tc_ops`` int8 tensor-core operations and
    ``int32_ops`` int32 operations on the CUDA cores (``roofline.py``'s
    peaks)."""
    from ffcnn_tpu_torch import roofline as rf
    t_b = nbytes / rf.HBM_BYTES_S
    t_o = max(tc_ops / rf.TC_INT8_OP_S, int32_ops / rf.INT32_OP_S)
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def int8_work(x, cvp, y):
    """(bytes, int8 tensor-core operations, int32 operations) of one int8
    conv of ``x`` to ``y``: the input read and the output written once,
    the weights and eff, bias, inv once; two operations a multiply-add, on
    the tensor cores (dense) or the CUDA cores (grouped)."""
    n, oh, ow, f = y.shape
    ops = 2 * n * oh * ow * f * cvp.fs * cvp.fs * cvp.wq.shape[2]
    nbytes = x.numel() + y.numel() * y.element_size() + cvp.wq.numel() \
        + 12 * f
    return nbytes, ops if cvp.groups == 1 else 0, ops if cvp.groups > 1 else 0


def check_codes(label, got, want, pre=None, phase: int = 12) -> int:
    """int8 codes of a kernel against its plain version: equal, or one
    apart where ``pre`` (the plain version's value before rounding) lies
    within INT8_TIE of a tie.  Returns the largest difference."""
    import torch
    d = (got.int() - want.int()).abs()
    err, n = int(d.max()), int((d > 0).sum())
    ties = True
    if n and pre is not None:
        f = pre[d > 0].float()
        ties = bool(((f - f.floor() - 0.5).abs() <= INT8_TIE).all())
    ok = err <= 1 and (n == 0 or pre is not None) and ties
    log(f"[{phase}] {label}: codes differing {n} of {d.numel()} (max {err}"
        + (", each at a tie" if n and ties else "") + f") "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def routed(ci, fn):
    """``fn()`` and the int8 conv's path it launched (``conv_int8.routes``);
    raises unless it launched exactly one."""
    before = dict(ci.conv_int8.routes)
    out = fn()
    took = [k for k, v in ci.conv_int8.routes.items() if v != before[k]]
    if len(took) != 1:
        raise AssertionError(f"int8 conv: paths launched {took}")
    return out, took[0]


def int8_conv_check(ci, label, x, cvp, batch, phase: int = 12):
    """The int8 conv on ``x`` against its plain version: the accumulators
    bit for bit, codes by ``check_codes``, float outputs by
    ``check_kernel``; the path the kernel took must be ``ci.route``'s.
    Returns (output, largest code or float difference, path)."""
    import torch
    from ffcnn_tpu_torch.ops.activations import activate
    acc, path = routed(ci, lambda: ci.conv_int8(x, cvp, raw=True))
    accp = ci.conv_int8_plain(x, cvp, raw=True)
    if not torch.equal(acc, accp):
        raise AssertionError(f"int8 conv {label}: accumulators differ")
    c, fn = x.shape[3], cvp.filters
    want = ci.route(c, fn, cvp.fs, cvp.stride, cvp.groups)
    if path != want:
        raise AssertionError(f"int8 conv {label}: took {path}, want {want}")
    y, yp = ci.conv_int8(x, cvp), ci.conv_int8_plain(x, cvp)
    if cvp.inv is not None:
        pre = activate(accp.float() * cvp.eff + cvp.bias, cvp.act) * cvp.inv
        e = check_codes(f"int8 conv {label} batch {batch} ({path}), "
                        f"accumulators bit for bit", y, yp, pre, phase)
    else:
        e = check_kernel(f"int8 conv {label} batch {batch} ({path}; "
                         f"accumulators bit for bit)", y, yp, phase=phase)
    return y, e, path


def load_int8(pt, wbytes, flags, device):
    """An int8 Net of xl at 320x320 built with ``flags`` set."""
    with environ(flags):
        return pt.load(CFG, wbytes, mode="int8", device=device)


def int8_phase(pt, counters, wbytes, frames, v8) -> dict:
    """Phase 12, its checks (after phase 11's, before the timing phases'
    traces): calibration on the card against the CPU; the int8 conv
    against its plain version on every unfused int8 conv of xl's default
    plan and the seeded shapes at batch 64 (accumulators bit for bit,
    codes), each timed alone beside its bound and, for the 1x1 convs,
    ``torch._int_mm`` with the epilogue; K1, K3 and K4 with int8
    boundaries against their plain versions, timed beside their bf16
    boundaries; int8 default and region on the card against the CPU under
    one plan (launches equal to the plan's, a replay's kernels equal to an
    eager run's); v8n at 640x640 likewise on one frame; ``cli detect
    --mode int8``; ``serve --mode int8 --quant-plan``, saved then loaded.
    Returns what the timings (``int8_times``) and the kernels line take."""
    import threading
    import urllib.request

    import torch
    from ffcnn_tpu_torch import bench_block as bb
    from ffcnn_tpu_torch import quant as tq
    from ffcnn_tpu_torch import serve
    from ffcnn_tpu_torch.kernels import block_fused as bf
    from ffcnn_tpu_torch.kernels import conv_int8 as ci
    from ffcnn_tpu_torch.net import WARMUP_RUNS
    from ffcnn_tpu_torch.ops.activations import activate
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 12)
    nets = {t: load_int8(pt, wbytes, f, "cuda") for t, f in INT8_FLAGS.items()}
    cpus = {t: load_int8(pt, wbytes, f, "cpu") for t, f in INT8_FLAGS.items()}

    # calibration: the card against the CPU on the same frames
    net, cnet = nets["default"], cpus["default"]
    calib = frames[:INT8_CALIB]
    net.calibrate(calib)
    cnet.calibrate(calib)
    gp, cp = net.quant, cnet.quant
    rel = max(abs(gp.blob_scale[b] - s) / s for b, s in cp.blob_scale.items())
    same = sum(int((gp.weights[li]["wq"].cpu() == q["wq"]).sum())
               for li, q in cp.weights.items())
    total = sum(q["wq"].numel() for q in cp.weights.values())
    log(f"[12] calibration on {len(calib)} frames, card vs CPU: "
        f"{len(gp.blob_scale)} int8 blobs, {len(gp.weights)} int8 convs; "
        f"blob scales max rel diff {rel:.2e}; wq codes equal {same} of "
        f"{total} ({same / total:.6f})")
    if sorted(gp.blob_scale) != sorted(cp.blob_scale) or rel > 1e-5 \
            or same < 0.999 * total or sorted(gp.weights) != \
            sorted(cp.weights) or len(gp.blob_scale) != XL_INT8_BLOBS:
        raise AssertionError("calibration on the card differs from the CPU")
    plan = gp
    for t in INT8_FLAGS:
        nets[t].set_quant_plan(plan)
        cpus[t].set_quant_plan(plan)
    convs = tq.unfused_int8(net)
    if len(convs) != XL_INT8_CONVS:
        raise AssertionError(f"{len(convs)} unfused int8 convs, want "
                             f"{XL_INT8_CONVS}")

    # the int8 conv against its plain version, batch 64: xl's shapes, then
    # the seeded ones
    qs = tq.quant_state(net.quant, net.ir, torch.bfloat16, dev)
    cases = []
    for li in convs:
        b, l = net.ir.blobs[li], net.ir.layers[li]
        kind = "dw" if l.groups > 1 else f"{l.fs}x{l.fs}"
        cases.append((f"L{li} {kind} s{l.stride} {b.h}x{b.w} C{b.c}->"
                      f"{l.fn}", b.h, b.c, qs.convs[li]))
    seeded = [(label, hw, c, f, k, st, 1, act, osc)
              for label, hw, c, f, k, st, act, osc in INT8_SEEDED]
    seeded += [(label, hw, c, c, k, st, c, act, osc)
               for label, hw, c, k, st, act, osc in INT8_SEEDED_DW]
    for label, hw, c, f, k, st, groups, act, osc in seeded:
        wq = torch.randint(-127, 128, (k, k, c // groups, f), generator=gen,
                           dtype=torch.int8).to(dev)
        ws = (torch.rand(f, generator=gen) * 0.02 + 1e-3).numpy()
        bias = (torch.rand(f, generator=gen) * 2 - 1).numpy()
        out = (np.linspace(0.02, 0.3, f).astype(np.float32)
               if osc == "perch" else osc)
        cases.append((label, hw, c, ci.prepare(
            wq, 0.0413, ws, bias, stride=st, pad=k // 2, groups=groups,
            act=act, out_scale=out)))
    err = 0
    rows, paths = [], {}
    for label, hw, c, cvp in cases:
        x = torch.randint(-127, 128, (BATCH, hw, hw, c), generator=gen,
                          dtype=torch.int8).to(dev)
        y, e, path = int8_conv_check(ci, label, x, cvp, BATCH)
        err = max(err, e)
        paths[label] = path
        rows.append((label, x, cvp, y))
    xl_paths = [paths[label] for label, _, _, _ in cases[:len(convs)]]
    log(f"[12] int8 conv checks: {len(cases)} shapes; xl's {len(convs)} "
        f"by path: " + ", ".join(f"{k} {xl_paths.count(k)}"
                                 for k in sorted(set(xl_paths)))
        + f" ({time.perf_counter() - t0:.1f} s so far)")
    if xl_paths.count("dw") != XL_INT8_DW or \
            xl_paths.count("gemm") != XL_INT8_CONVS - XL_INT8_DW:
        raise AssertionError("xl's int8 convs did not take the dw and gemm "
                             "paths")
    tim = {}
    for label, x, cvp, y in rows[:len(convs)]:
        ms = bb.graph_launch_ms(lambda: ci.conv_int8(x, cvp))
        pms = cuda_ms(lambda: ci.conv_int8_plain(x, cvp), iters=2, warmup=1)
        f, fs, icg = y.shape[3], cvp.fs, cvp.wq.shape[2]
        work = int8_work(x, cvp, y)
        bound = int8_bound(*work)
        lib = None
        if fs == 1 and cvp.groups == 1:
            wt = cvp.wq.reshape(icg, f)
            x2 = x.reshape(-1, icg)

            def int_mm():
                a = torch._int_mm(x2, wt)
                v = activate(a.float() * cvp.eff + cvp.bias, cvp.act)
                if cvp.inv is None:
                    return v.to(torch.bfloat16)
                return torch.clamp(torch.round(v * cvp.inv), -127,
                                   127).to(torch.int8)
            try:
                if not torch.equal(int_mm().reshape(y.shape), y):
                    log(f"[12] torch._int_mm + epilogue differs from the "
                        f"kernel at {label} (a yardstick only)")
                lib = cuda_ms(int_mm, iters=10)
            except RuntimeError as e:      # the yardstick only
                log(f"[12] torch._int_mm refused {label}: {e}")
        tim[label] = (ms, pms, work, lib)
        log(f"[12] int8 conv {label} batch {BATCH}: kernel alone {ms:.4f}"
            f" ms (a graph of 20 launches), plain {pms:.3f} ms, "
            f"bound {bound[0]:.4f} ms "
            f"({bound[1]})" + (f", torch._int_mm + epilogue {lib:.4f} ms"
                               if lib is not None else ""))

    # K1, K3, K4 with int8 boundaries against their plain versions, and
    # each timed beside the same launch with bf16 boundaries: run 84-108
    # (K1 block by block, K4 in groups of three) and the region's stride-2
    # block 81 (K3)
    run = next(r for r in net._fused_runs if r.start == 84)
    bps = net._fused_params[84]
    ends = [b.end + 1 for b in run.blocks]
    sc = plan.scalar_scale
    blk = {"K1": [], "K3": [], "K4": []}
    works = {"K1": bb.Work(), "K3": bb.Work(), "K4": bb.Work()}

    def block_case(key, label, launch, plain, shape, in_s, out_s, cbps,
                   stride=1):
        xin = (torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8) if in_s is not None
               else torch.randn(shape, generator=gen)).to(
                   dev, torch.int8 if in_s is not None else torch.bfloat16)
        y = launch(xin, in_s, out_s)
        yp = plain(xin, in_s, out_s)
        if out_s is not None:
            pre = plain(xin, in_s, None, torch.float32) * (1.0 / out_s)
            e = check_codes(f"{key} int8 {label}", y, yp, pre)
        else:
            e = check_kernel(f"{key} int8 {label}", y, yp, phase=12)
        xb = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        blk[key].append((lambda: launch(xin, in_s, out_s),
                         lambda: launch(xb, None, None),
                         lambda: plain(xin, in_s, out_s)))
        # the launch's work: its chain's operations and float32 weights,
        # the input and output once each at their storage's width
        w = chain_work(bb, shape[0], shape[1], shape[2], cbps, stride)
        works[key] += dataclasses.replace(
            w, bytes=w.bytes - 2 * (xin.numel() + y.numel())
            + xin.numel() * xin.element_size()
            + y.numel() * y.element_size())
        return e

    shape = (BATCH,) + net.ir.blobs[84].nhwc
    kerr = {"K1": 0, "K3": 0, "K4": 0}
    for i, (b, bp) in enumerate(zip(run.blocks, bps)):
        in_s = sc(ends[i - 1]) if i else None
        out_s = sc(ends[i]) if i + 1 < len(bps) else None
        kerr["K1"] = max(kerr["K1"], block_case(
            "K1", f"block {b.start} 10x10 C96 ({'int8' if in_s else 'bf16'}"
            f" in, {'int8' if out_s else 'bf16'} out)",
            lambda x, i_, o_, bp=bp: bf.fused_block(x, bp, torch.bfloat16,
                                                    i_, o_),
            lambda x, i_, o_, od=torch.bfloat16, bp=bp: bf.block_plain(
                x, bp, od, i_, o_), shape, in_s, out_s, [bp]))
    groups = bf.cascade_groups(run, 3)
    i = 0
    for gi, g in enumerate(groups):
        gbps = bps[i:i + len(g)]
        in_s = sc(groups[gi - 1][-1].end + 1) if gi else None
        out_s = sc(g[-1].end + 1) if gi + 1 < len(groups) else None
        kerr["K4"] = max(kerr["K4"], block_case(
            "K4", f"group {[b.start for b in g]}",
            lambda x, i_, o_, gb=gbps: bf.fused_cascade(
                x, gb, torch.bfloat16, i_, o_),
            lambda x, i_, o_, od=torch.bfloat16, gb=gbps: bf.chain_plain(
                x, gb, od, in_scale=i_, out_scale=o_), shape, in_s, out_s,
            gbps))
        i += len(g)
    rnet = nets["region"]
    rrun = next(r for r in rnet._fused_runs if r.start == 81)
    b81, bp81 = rrun.blocks[0], rnet._fused_params[81][0]
    in81 = sc(81) if plan.blob_is_int8(81) else 0.05
    kerr["K3"] = block_case(
        "K3", f"block 81 20x20 -> 10x10, int8 in and out",
        lambda x, i_, o_: bf.fused_down_block(x, bp81, torch.bfloat16, i_,
                                              o_),
        lambda x, i_, o_, od=torch.bfloat16: bf.block_down_plain(
            x, bp81, od, i_, o_), (BATCH,) + net.ir.blobs[81].nhwc, in81,
        sc(b81.end + 1), [bp81], 2)
    blk_ms = {}
    for key, cs in blk.items():
        ms = sum(cuda_ms(k8, iters=10) for k8, _, _ in cs)
        ms16 = sum(cuda_ms(k16, iters=10) for _, k16, _ in cs)
        pms = sum(cuda_ms(p, iters=2, warmup=1) for _, _, p in cs)
        blk_ms[key] = (ms, ms16, pms, works[key].bound())
        log(f"[12] {key} with the plan's int8 boundaries, {len(cs)} "
            f"launches, batch {BATCH}: {ms:.4f} ms, with bf16 boundaries "
            f"{ms16:.4f} ms, plain {pms:.3f} ms, bound "
            f"{blk_ms[key][3][0]:.4f} ms ({blk_ms[key][3][1]})")

    # the whole int8 nets on the card against the CPU, one plan
    built = WARMUP_RUNS + 1
    main_counts = {}
    main_paths = {}
    for tag, n in nets.items():
        want = plan_counts(n)
        ci.conv_int8.routes.update(dict.fromkeys(ci.ROUTES, 0))
        dets, counts = counted(counters, lambda: n.detect(frames))
        by_path = {k: v for k, v in ci.conv_int8.routes.items() if v}
        log(f"[12] int8 {tag} detect batch {len(frames)}, its bucket built "
            f"in the call: {sum(map(len, dets))} detections; one forward's "
            f"launches by the plan {want}; launches "
            + " ".join(f"{k} {v}" for k, v in counts.items())
            + f"; the int8 conv's by path {by_path}")
        if counts["K2"] != built or any(counts[k] != v * built
                                        for k, v in want.items()) \
                or counts["K5"] or counts["K7"] or not counts["conv_int8"] \
                or sum(by_path.values()) != counts["conv_int8"]:
            raise AssertionError(f"int8 {tag}: launches differ from the plan")
        if tag == "default" and by_path != {
                "gemm": (XL_INT8_CONVS - XL_INT8_DW) * built,
                "dw": XL_INT8_DW * built}:
            raise AssertionError("int8 default: the int8 conv's launches "
                                 "did not go 16 a forward to gemm, 13 to dw")
        main_counts[tag] = counts
        main_paths[tag] = by_path
        check_dets(f"int8 {tag}", dets)
        check_replay(f"int8 {tag}", n, counters, frames, dets, want)
        check_against_cpu(f"int8 {tag}", n, cpus[tag], frames, dets, 12)

    # v8n at 640x640: one frame, card against CPU under the card's plan
    v8n = pt.Net(v8["ir"], v8["params"], mode="int8", device="cuda")
    v8c = pt.Net(v8["ir"], v8["params"], mode="int8", device="cpu")
    one = v8["seeded"][:1]
    v8n.calibrate(one)
    v8c.set_quant_plan(v8n.quant)
    dets, counts = counted(counters, lambda: v8n.detect(one))
    log(f"[12] v8n int8 at {V8_SIZE}x{V8_SIZE}: {len(v8n.quant.blob_scale)}"
        f" int8 blobs, {len(v8n.quant.weights)} int8 convs; detect batch 1 "
        f"(bucket built): {len(dets[0])} detections; launches "
        + " ".join(f"{k} {v}" for k, v in counts.items() if v))
    if counts["conv_int8"] != len(tq.unfused_int8(v8n)) * built:
        raise AssertionError("v8n int8 did not launch its int8 convs")
    check_dets("v8n int8", dets)
    check_against_cpu("v8n int8", v8n, v8c, one, dets, 12)

    # v8n's distinct unfused int8 convs under its plan: checked at batch
    # V8_INT8_CHECK, timed at V8_INT8_TIME
    qs8 = tq.quant_state(v8n.quant, v8n.ir, torch.bfloat16, dev)
    v8_rows = []
    for li, geo in tq.conv_shapes(v8n, distinct=True):
        h, w, c = geo[:3]
        cvp = qs8.convs[li]
        label = f"v8n L{li} {cvp.fs}x{cvp.fs} s{cvp.stride} {h}x{w} " \
            f"C{c}->{cvp.filters}"
        x = torch.randint(-127, 128, (V8_INT8_CHECK, h, w, c),
                          generator=gen, dtype=torch.int8).to(dev)
        _, e, path = int8_conv_check(ci, label, x, cvp, V8_INT8_CHECK)
        err = max(err, e)
        if path != "gemm":
            raise AssertionError(f"{label} took {path}")
        xt = torch.randint(-127, 128, (V8_INT8_TIME, h, w, c),
                           generator=gen, dtype=torch.int8).to(dev)
        v8_rows.append(bb.graph_launch_ms(lambda: ci.conv_int8(xt, cvp)))
    log(f"[12] v8n's {len(v8_rows)} distinct unfused int8 convs bit for "
        f"bit at batch {V8_INT8_CHECK}; at batch {V8_INT8_TIME} the "
        f"kernel alone (a graph of 20 launches a shape) {sum(v8_rows):.4f} "
        f"ms summed")

    # the surfaces: cli detect --mode int8 (calibrated on its image),
    # serve --mode int8 --quant-plan (saved, then loaded)
    bgr = pt.bmp_load(BMP)
    with tempfile.TemporaryDirectory() as tmp:
        wpath, ppath = os.path.join(tmp, "xl.weights"), \
            os.path.join(tmp, "plan.npz")
        with open(wpath, "wb") as f:
            f.write(wbytes)
        got = run_cli(["detect", BMP, "--cfg", CFG, "--weights", wpath,
                       "--mode", "int8", "-o", os.path.join(tmp, "o.bmp")]
                      ).splitlines()
        cn = pt.load(CFG, wpath, mode="int8", device="cuda")
        want = det_lines(cn.detect(bgr))
        log(f"[12] cli detect --mode int8: '{got[0]}', {len(want)} "
            f"detections; score lines equal Net.detect's: {got[1:] == want}")
        if got[1:] != want:
            raise AssertionError("cli detect --mode int8 differs")
        tq.save_plan(ppath, plan)
        ap = serve.parser()
        snet = serve.load_net(ap.parse_args(
            ["--cfg", CFG, "--weights", wpath, "--mode", "int8",
             "--quant-plan", ppath]), ap.error)
        if snet.quant.blob_scale != plan.blob_scale or any(
                not torch.equal(snet.quant.weights[li]["wq"], q["wq"])
                for li, q in plan.weights.items()):
            raise AssertionError("serve's loaded plan differs")
        svc = serve.DetectorService(snet, max_batch=1)
        server = serve.make_server(svc, "127.0.0.1", 0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            svc.warmup()
            port = server.server_address[1]
            same = 0
            for img in [bgr] + list(frames[:3]):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/detect", data=bmp_bytes(img),
                    method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    got = json.loads(r.read())["detections"]
                want = [{"score": round(d.score, 4), "class_id": d.class_id,
                         "box": [round(v, 2) for v in d[2:]]}
                        for d in snet.detect(img)]
                same += got == want
        finally:
            server.shutdown()
            server.server_close()
            svc._batcher.close()
        log(f"[12] serve --mode int8 --quant-plan (saved, then loaded: the "
            f"same plan): 4 sequential POST /detect, {same} of 4 equal to "
            f"Net.detect")
        if same != 4:
            raise AssertionError("serve --mode int8 answers differ")
    log(f"[12] phase 12 checks took {time.perf_counter() - t0:.1f} s")
    return {"nets": nets, "err": err, "kerr": kerr, "tim": tim,
            "blk": blk_ms, "counts": main_counts, "paths": main_paths,
            "nconv": len(convs), "v8n_ms": sum(v8_rows),
            "v8n_shapes": len(v8_rows)}


def int8_entry(i8) -> dict:
    """The int8 conv's entry in the ``kernels`` line: its launches in the
    int8 default path's first detect, the largest code difference and the
    sums of its times over xl's unfused int8 convs at batch 64 (kernel
    alone, plain, bound; ``torch._int_mm`` with the epilogue over the 1x1
    convs beside the kernel's time there)."""
    from ffcnn_tpu_torch import roofline as rf
    tim = i8["tim"].values()
    nbytes = sum(t[2][0] for t in tim)
    t_b = nbytes / rf.HBM_BYTES_S
    t_o = sum(t[2][1] for t in tim) / rf.TC_INT8_OP_S \
        + sum(t[2][2] for t in tim) / rf.INT32_OP_S
    ones = [t for t in tim if t[3] is not None]
    dws = [t for t in tim if t[2][2]]
    return {"name": "conv_int8", "route": "cuda",
            "source": "ffcnn_tpu_torch/csrc/conv_int8.cu",
            "replaces": "ffcnn_tpu/ops/conv.py:99 (conv2d_int8, XLA's int8 "
                        "conv)",
            "launches": i8["counts"]["default"]["conv_int8"],
            "max_abs_err": i8["err"], "ms": sum(t[0] for t in tim),
            "plain_ms": sum(t[1] for t in tim),
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None, "shapes": len(i8["tim"]),
            "ms_1x1": sum(t[0] for t in ones),
            "int_mm_ms_1x1": sum(t[3] for t in ones),
            "bound_ms_1x1": sum(int8_bound(*t[2])[0] for t in ones),
            "ms_dw": sum(t[0] for t in dws),
            "bound_ms_dw": sum(int8_bound(*t[2])[0] for t in dws),
            "launches_by_path": i8["paths"]["default"],
            "v8n_shapes": i8["v8n_shapes"],
            f"v8n_ms_batch{V8_INT8_TIME}": i8["v8n_ms"]}


def int8_times(i8, frames, dev) -> None:
    """Phase 12, its timings (run last): the int8 nets' ``detect_device``
    at batch 1 and 64, the bucket's replay and the eager pipeline in turns
    by CUDA events, each with its host CPU and device time
    (torch.profiler)."""
    import torch
    t0 = time.perf_counter()
    for tag, net in i8["nets"].items():
        recaptured(net)
        for nb, iters in ((1, 20), (BATCH, 8)):
            batch = torch.from_numpy(np.resize(frames, (nb, 320, 320, 3))
                                     ).to(dev)
            net.warmup(batch_sizes=(nb,))
            bucket = lambda: net.detect_device(batch)
            eager = lambda: bucket_of(net, batch).run(batch)
            (e1, e2), (b1, b2) = turns(eager, bucket, iters)
            eh, ed = profiled_ms(eager, 3)
            bh, bd = profiled_ms(bucket, 3)
            log(f"[12] int8 {tag} detect batch {nb}, eager / bucket: events "
                f"{e1:.3f}, {e2:.3f} / {b1:.3f}, {b2:.3f} ms "
                f"({nb / b1 * 1e3:.1f} img/s bucket); torch.profiler host "
                f"CPU {eh:.3f} / {bh:.3f} ms, device {ed:.3f} / {bd:.3f} ms "
                f"a call")
    log(f"[12] phase 12 timings took {time.perf_counter() - t0:.1f} s")


# Phase 12, conv-1 in int8 (FFCNN_CONV0_INT8=1) on the region Net: the
# uint8 mode of the int8 conv at xl's stem, whose sizes these are (322: odd
# output rows, 3 * 322 bytes a row), and one forward's launches under it (K6
# gives way to it, as in JAX)
C0Q_SIZES = (320, 322)
C0Q_FLAGS = {**REGION_FLAGS, "FFCNN_CONV0_INT8": "1"}
C0Q_COUNTS = {**WANT_COUNTS["region"], "K6": 0, "conv_int8": 1}
# the other stems the u8 path specialises, each at its model's input size
# and batch C0Q_STEM_BATCH, seeded weights of its layer 0's shape: (tag,
# cfg, size), the size None for YOLOv8n's (F 16, stride 2, swish; V8_SIZE)
C0Q_STEMS = (("micro", "models/ffcnn-micro.cfg", 64),
             ("yolov3-tiny", "models/yolov3-tiny.cfg", 416),
             ("yolov4-tiny", "models/yolov4-tiny.cfg", 416),
             ("yolov4", "models/yolov4.cfg", 416),
             ("v8n", None, None))
C0Q_STEM_BATCH = 4
# mish on the card (block_fused.cuh: v * tanhf(log1pf(expf(v)))) may round
# apart from torch's; its float32 outputs may differ by this many ulps
C0Q_MISH_ULPS = 2


def ulps(got, want):
    """The largest distance in units in the last place between two float32
    or bfloat16 tensors of one shape (their bits as ordered integers)."""
    import torch
    bits, sign = ((torch.int32, 0x7FFFFFFF) if want.dtype == torch.float32
                  else (torch.int16, 0x7FFF))

    def key(v):
        i = v.contiguous().view(bits).long()
        return torch.where(i >= 0, i, -(i & sign))
    return int((key(got) - key(want)).abs().max())


def check_u8(label, got, want, act, phase: int = 12) -> float:
    """The u8 path against its plain version: bit for bit, except mish's
    float outputs, within C0Q_MISH_ULPS float32 ulps (a bfloat16 output one
    bf16 ulp, the float32 difference's rounding), the largest logged.
    Returns max |err|."""
    import torch
    torch.cuda.synchronize()
    ok = got.shape == want.shape and got.dtype == want.dtype
    err = (got.double() - want.double()).abs().max().item() if ok \
        else float("inf")
    same = ok and torch.equal(got, want)
    note = "bit for bit required"
    if ok and not same and act == 4 and got.dtype != torch.int32:
        u = ulps(got, want)
        lim = C0Q_MISH_ULPS if got.dtype == torch.float32 else 1
        note = f"mish: {u} ulp(s) apart at most, {lim} allowed"
        same = u <= lim and bool(torch.isfinite(got.float()).all())
    log(f"[{phase}] {label}: max|err| {err:.3e}, {note} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def stem_case(pt, ci, cfg, size, gen, dev, batch=C0Q_STEM_BATCH):
    """Seeded uint8 pixels (batch, size, size, 3) and a uint8-mode
    ``Int8Conv`` of ``cfg``'s layer 0 (YOLOv8n's stem where ``cfg`` is
    None) with seeded folded weights, scale and bias."""
    import torch
    if cfg is None:
        size, f, stride, act = V8_SIZE, 16, 2, 6
    else:
        l0 = pt.parse_cfg(os.path.join(REPO, cfg)).layers[0]
        f, stride, act = l0.fn, l0.stride, l0.activation
    w = torch.randn((3, 3, 3, f), generator=gen) * 0.01
    scale = torch.rand(f, generator=gen) + 0.5
    bias = torch.randn(f, generator=gen) * 0.1
    cp = ci.prepare_conv0(w.to(dev), scale.to(dev), bias.to(dev), h=size,
                          w=size, stride=stride, pad=1, act=act)
    x = torch.randint(0, 256, (batch, size, size, 3), generator=gen,
                      dtype=torch.uint8).to(dev)
    return x, cp


def u8_bound(x, cp):
    """(ms, by) the least an H100 takes for a uint8-mode stem (3x3, pad 1)
    on ``x`` to a bf16 output: the pixels, the output, the packed weight
    codes, eff and bias moved once (not m128, which the kernel does not
    read), 27 multiply-adds an output on the int8 tensor cores."""
    n, h, w, _ = x.shape
    oh, ow = (h - 1) // cp.stride + 1, (w - 1) // cp.stride + 1
    f = cp.filters
    nbytes = x.numel() + 2 * n * oh * ow * f + cp.wp.numel() + 8 * f
    return int8_bound(nbytes, tc_ops=2 * n * oh * ow * f * 27)


def u8_cases(ci, label, x, cp, phase: int = 12) -> float:
    """The u8 path on ``x`` against its plain version in its three output
    kinds (int32 accumulators, float32, bf16), each launch routed ``u8``.
    Returns the largest float difference."""
    import torch
    worst = 0.0
    for raw, dt in ((True, None), (False, torch.float32),
                    (False, torch.bfloat16)):
        got, path = routed(ci, lambda: ci.conv_int8(
            x, cp, dt or torch.bfloat16, raw))
        want = ci.conv_int8_plain(x, cp, dt or torch.bfloat16, raw)
        kind = "int32 accumulators" if raw else str(dt).split(".")[-1]
        if path != "u8":
            raise AssertionError(f"{label} took {path}, not u8")
        e = check_u8(f"{label} -> {tuple(got.shape[1:])} {kind} ({path})",
                     got, want, cp.act, phase)
        if not raw:
            worst = max(worst, e)
    return worst


def conv0q_phase(pt, counters, wbytes, frames) -> dict:
    """Phase 12, conv-1 in int8, its checks (after phase 12's, before the
    timing phases' traces): the uint8 mode (the kernel's u8 path) against
    its plain version at xl's layer 0 (the region Net's folded weights) at
    320x320 and 322x322, batch 64, and at the other stems of C0Q_STEMS
    (batch 4, each model's input size), its int32 accumulators and its
    float32 and bf16 outputs bit for bit (mish within C0Q_MISH_ULPS), every
    launch routed u8; the region Net under the flag: its first detect's launches (the
    uint8 mode, no K6, the region path's others), a replay's kernels equal
    to an eager run's, its heads and detections held to the CPU by phase
    4's tolerances.  Returns what ``conv0q_times`` and the kernels line
    take."""
    import torch
    from ffcnn_tpu_torch.kernels import conv_int8 as ci
    from ffcnn_tpu_torch.runtime import WARMUP_RUNS
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 16)
    qnet = load_net(pt, wbytes, C0Q_FLAGS, "cuda")
    qcpu = load_net(pt, wbytes, C0Q_FLAGS, "cpu")
    p0 = qnet._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[0][0]
    l0 = qnet.ir.layers[0]
    cases, worst = {}, 0.0
    for size in C0Q_SIZES:
        cp = ci.prepare_conv0(p0["weights"].permute(2, 3, 1, 0), p0["scale"],
                              p0["bias"], h=size, w=size, stride=l0.stride,
                              pad=l0.pad, act=l0.activation)
        x = torch.randint(0, 256, (BATCH, size, size, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
        worst = max(worst, u8_cases(
            ci, f"conv-1 int8 (the uint8 mode) xl {size}x{size} batch "
                f"{BATCH}", x, cp))
        cases[size] = (x, cp)
    for tag, cfg, size in C0Q_STEMS:
        x, cp = stem_case(pt, ci, cfg, size, gen, dev)
        worst = max(worst, u8_cases(
            ci, f"conv-1 int8 {tag} stem F {cp.filters} s{cp.stride} act "
                f"{cp.act} {x.shape[1]}x{x.shape[2]} batch {x.shape[0]}", x,
            cp))
    built = WARMUP_RUNS + 1
    dets, counts = counted(counters, lambda: qnet.detect(frames))
    log(f"[12] region + FFCNN_CONV0_INT8=1 detect batch {len(frames)}, its "
        f"bucket built in the call: {sum(map(len, dets))} detections; "
        f"launches " + " ".join(f"{k} {v}" for k, v in counts.items()))
    if counts["K2"] != built or any(counts[k] != v * built
                                    for k, v in C0Q_COUNTS.items()):
        raise AssertionError("the conv-1 int8 path did not run its kernels")
    check_dets("conv-1 int8", dets)
    check_replay("conv0_int8", qnet, counters, frames, dets, C0Q_COUNTS)
    check_against_cpu("conv-1 int8 region", qnet, qcpu, frames, dets, 12)
    log(f"[12] conv-1 int8 checks took {time.perf_counter() - t0:.1f} s")
    return {"net": qnet, "cases": cases, "counts": counts, "err": worst}


def conv0q_times(q, rnet, frames, dev) -> dict:
    """Phase 12, conv-1 in int8, its timings: the uint8 mode at xl's stem,
    batch 64, 320x320 and 322x322 (``graph_launch_ms``), beside K6 on the
    same pixels and the default fast path's stem (cuDNN: the pixels cast to
    bf16, ``conv2d_fused`` on the folded weights), its plain version by
    events and its bound; YOLOv8n's stem at 640x640, batch V8_INT8_TIME,
    against its bound; then the region Net's ``detect_device`` at batch 64
    with and without the flag, in turns.  Returns the kernels line's
    entry."""
    import torch
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch import bench_block as bb
    from ffcnn_tpu_torch.kernels import conv0_fused as c0
    from ffcnn_tpu_torch.kernels import conv_int8 as ci
    from ffcnn_tpu_torch.ops.conv import conv2d_fused
    params, c0p = rnet._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
    p0, l0 = params[0], rnet.ir.layers[0]
    rows = {}
    for size, (x, cp) in q["cases"].items():
        ms = bb.graph_launch_ms(lambda: ci.conv_int8(x, cp))
        pms = cuda_ms(lambda: ci.conv0_int8_plain(x, cp), iters=2, warmup=1)
        k6 = bb.graph_launch_ms(lambda: c0.conv0_cs(x, c0p))
        stem = bb.graph_launch_ms(lambda: conv2d_fused(
            x.to(torch.bfloat16), p0["weights"], p0["scale"], p0["bias"],
            stride=l0.stride, pad=l0.pad, groups=1, act=l0.activation))
        bound = u8_bound(x, cp)
        rows[size] = (ms, pms, k6, stem, bound)
        log(f"[12] conv-1 int8 {size}x{size} batch {BATCH}: kernel alone "
            f"{ms:.4f} ms (a graph of 20 launches), K6 {k6:.4f} ms, the "
            f"cuDNN stem (bf16 cast + conv2d_fused) {stem:.4f} ms, plain "
            f"{pms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    xv, cpv = stem_case(pt, ci, None, None, torch.Generator().manual_seed(
        SEED + 20), dev, batch=V8_INT8_TIME)
    v8ms = bb.graph_launch_ms(lambda: ci.conv_int8(xv, cpv))
    v8bound = u8_bound(xv, cpv)
    log(f"[12] conv-1 int8 v8n stem (F 16, s2, swish) {V8_SIZE}x{V8_SIZE} "
        f"batch {V8_INT8_TIME}: kernel alone {v8ms:.4f} ms, bound "
        f"{v8bound[0]:.4f} ms ({v8bound[1]})")
    xb = torch.from_numpy(frames).to(dev)
    qnet = q["net"]
    (a1, a2), (b1, b2) = turns(lambda: qnet.detect_device(xb),
                               lambda: rnet.detect_device(xb), 10)
    log(f"[12] region detect_device batch {BATCH}, bucket replays in turns: "
        f"with FFCNN_CONV0_INT8=1 {a1:.3f}, {a2:.3f} ms; without (K6) "
        f"{b1:.3f}, {b2:.3f} ms")
    ms, pms, k6, stem, (bound, by) = rows[320]
    return {"name": "conv_int8_u8", "route": "cuda",
            "source": "ffcnn_tpu_torch/csrc/conv_int8.cu",
            "replaces": "ffcnn_tpu/ops/conv.py:54 (conv0_int8_from_u8, XLA's "
                        "int8 conv)",
            "launches": q["counts"]["conv_int8"], "max_abs_err": q["err"],
            "ms": ms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "path": "u8", "k6_ms": k6,
            "cudnn_stem_ms": stem, "ms_322": rows[322][0],
            "k6_ms_322": rows[322][2],
            f"v8n_ms_{V8_SIZE}_batch{V8_INT8_TIME}": v8ms,
            f"v8n_bound_ms_{V8_SIZE}_batch{V8_INT8_TIME}": v8bound[0],
            "detect_device_ms": (a1 + a2) / 2,
            "region_detect_device_ms": (b1 + b2) / 2}


# Phase 13: the artifacts exported (tag, the Net's flags, mode, batch)
EXPORTS = (("region_fast_b1", "region", 1), ("region_fast_b64", "region",
                                              BATCH),
           ("parity_b1", "parity", 1), ("int8_default_b1", "int8", 1))
# the float32 knobs on the region Net, exported on the card (tag: flags),
# each at batch 1, EXPORT_KNOB_B64 also at BATCH
EXPORT_KNOBS = {**KNOB_FLAGS, "both": {**REGION_FLAGS, "FFCNN_HEAD_F32": "1",
                                       "FFCNN_F32_STAGES": "20"}}
EXPORT_KNOB_B64 = "head_f32"
# the artifacts of EXPORTS that hold a program for each of EXPORT_PLATFORMS
EXPORT_PLATFORMS = ("cuda", "cpu")
EXPORTS_2P = ("region_fast_b1", "parity_b1")
# the process with no visible card that loads them: it imports only the
# export module, loads the CPU program of each, verifies its golden probe
# and runs it on the saved frames
PLATFORM_LOADER = """
import json, sys, time
t_start = time.perf_counter()
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from ffcnn_tpu_torch import export as ex
out = {"cuda": torch.cuda.is_available()}
for tag, path in json.loads(sys.argv[2]).items():
    t0 = time.perf_counter()
    art = ex.load_exported(path)
    load_s = time.perf_counter() - t0
    ex.verify_artifact(art, name=tag)
    res = art.call(np.load(path + ".frames.npy"))
    torch.save(list(res), path + ".cpu_res.pt")
    out[tag] = {"load_s": load_s, "platforms": art.platforms,
                "device": art.device.type}
out["modules"] = sorted(m for m in sys.modules if m in (
    "ffcnn_tpu_torch.net", "ffcnn_tpu_torch.graph.build",
    "ffcnn_tpu_torch.darknet.cfg") or m.split(".")[0] in ("jax",
                                                         "ffcnn_tpu"))
out["run_s"] = time.perf_counter() - t_start
print("LOADER " + json.dumps(out))
"""
# the fresh process that loads them: it imports only the export module,
# loads and verifies each artifact, runs it on the seeded frames and saves
# the results
EXPORT_LOADER = """
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from ffcnn_tpu_torch import export as ex
out = {}
for tag, path in json.loads(sys.argv[2]).items():
    t0 = time.perf_counter()
    art = ex.load_exported(path)
    load_s = time.perf_counter() - t0
    ex.verify_artifact(art, name=tag)
    res = art.call(np.load(path + ".frames.npy"))
    torch.save([t.cpu() for t in res], path + ".res.pt")
    out[tag] = {"load_s": load_s, "ops": art.meta["custom_ops"]}
out["modules"] = sorted(m for m in sys.modules if m in (
    "ffcnn_tpu_torch.net", "ffcnn_tpu_torch.graph.build",
    "ffcnn_tpu_torch.darknet.cfg") or m.split(".")[0] in ("jax",
                                                         "ffcnn_tpu"))
print("LOADER " + json.dumps(out))
"""


def artifact_vs_net(tag, art, net, batch) -> str:
    """The artifact's result on ``batch`` against ``net.detect_device``'s:
    "bit for bit", or the largest difference, logged, with each side's
    detections held among the other side's candidates by phase 4's
    tolerances (raises outside them)."""
    import torch
    from ffcnn_tpu_torch.ops.yolo import decode_heads
    from ffcnn_tpu_torch.runtime import to_detections
    got, want = art.call(batch), net.detect_device(batch)
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return "bit for bit"
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got[:2], want[:2]))
    net_w, net_h = net.ir.blobs[0].w, net.ir.blobs[0].h
    c = decode_heads(net.ir, [h.float().cpu() for h in net.forward_heads(
        torch.from_numpy(batch).to("cuda"))], net_w, net_h)
    fr = min(match_fraction(d, *(t[i].numpy() for t in c), DET_MATCH_PX,
                            DET_MATCH_SCORE)
             for dets in (to_detections(got), to_detections(want))
             for i, d in enumerate(dets))
    if fr < DET_MATCH_FRAC:
        raise AssertionError(f"{tag}: the artifact differs from the Net "
                             f"(max |diff| {err:.3e}, match {fr:.3f})")
    return (f"NOT bit for bit: max |diff| of boxes and scores {err:.3e}; "
            f"detections among the Net's candidates {fr:.3f} (phase 4's "
            f"tolerances)")


def knob_exports(pt, ex, wbytes, rng, tmp, dev) -> None:
    """Phase 13, the float32 knobs: xl's region Net under each of
    EXPORT_KNOBS exported on the card at batch 1 (EXPORT_KNOB_B64 also at
    BATCH), with its time, .pt2 size and ``ffcnn::`` ops; the program
    holds ``ffcnn::conv2d_f32`` once a forced conv and K7 under stage 20
    alone; loaded, held to ``Net.detect_device`` under the same flags
    (``artifact_vs_net``), its replay (``ArtifactNet``) timed against the
    Net bucket's, in turns."""
    import torch
    from ffcnn_tpu_torch.kernels.head_fused import HEAD_OP
    from ffcnn_tpu_torch.ops.conv import CONV2D_F32_OP
    for tag, flags in EXPORT_KNOBS.items():
        net = load_net(pt, wbytes, flags, "cuda")
        forced = sum(1 for li in net._f32_layers
                     if net.ir.layers[li].type == pt.LayerType.CONV)
        for nb in (1, BATCH) if tag == EXPORT_KNOB_B64 else (1,):
            path = os.path.join(tmp, f"{tag}_b{nb}.pt2")
            te = time.perf_counter()
            size = net.export(path, batch_size=nb)
            te = time.perf_counter() - te
            anet = ex.ArtifactNet([path])
            art = anet._arts[0]
            targets = [n.target for n in art.program.graph.nodes]
            n_f32, n_k7 = targets.count(CONV2D_F32_OP), targets.count(HEAD_OP)
            batch = rng.randint(0, 256, (nb, 320, 320, 3), dtype=np.uint8)
            held = artifact_vs_net(tag, art, net, batch)
            knobs = " ".join(f"{k}={v}" for k, v in flags.items()
                             if k not in REGION_FLAGS)
            log(f"[13] {tag} ({knobs}) batch {nb}: exported in {te:.2f} s, "
                f"{size} bytes, ops {art.meta['custom_ops']}; conv2d_f32 "
                f"nodes {n_f32} for {forced} forced convs, K7 nodes {n_k7}; "
                f"against Net.detect_device under the same flags: {held}")
            if n_f32 != forced or (n_k7 > 0) != (tag == "stages_20"):
                raise AssertionError(f"{tag}: the program's ops differ from "
                                     f"the Net's plan")
            anet.warmup()
            xb = torch.from_numpy(batch).to(dev)
            net.detect_device(xb)
            (a1, a2), (b1, b2) = turns(lambda: anet._call(art, xb),
                                       lambda: net.detect_device(xb), 20)
            log(f"[13] {tag} batch {nb}: artifact replay {a1:.3f}, {a2:.3f} "
                f"ms; the Net bucket's {b1:.3f}, {b2:.3f} ms (in turns)")


def platform_checks(ex, cpu_nets, proc, paths, batches, want) -> None:
    """Phase 13, the artifacts of EXPORTS_2P on the CPU: ``proc``, a process
    with no visible card (``CUDA_VISIBLE_DEVICES=""``, ``PLATFORM_LOADER``)
    that imports only the export module, must have loaded each file's CPU
    program (its platforms, load time, ``verify_artifact``) and run it on
    its frames: bit for bit with the CPU Net's ``detect_device`` (what
    ``Net.detect`` runs first; the detections equal ``detect``'s where
    top-k is not saturated, for parity grows K there and a program's K is
    sealed), and parity's paired with the card's, ``want`` (phase 5's
    pairing)."""
    import torch
    from ffcnn_tpu_torch.runtime import to_detections
    out, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the loader with no card failed:\n"
                             f"{err[-4000:]}")
    line = next(ln for ln in out.splitlines() if ln.startswith("LOADER "))
    info = json.loads(line[len("LOADER "):])
    if info.pop("modules") or info.pop("cuda"):
        raise AssertionError("the loader saw a card or imported the graph "
                             "builder")
    log(f"[13] the process with no visible card ran {info.pop('run_s'):.1f} "
        f"s from its first line to its last, beside the other loader")
    for tag in EXPORTS_2P:
        key = next(k for t, k, _ in EXPORTS if t == tag)
        got = ex.NMSResult(*torch.load(paths[tag] + ".cpu_res.pt"))
        cpu = cpu_nets[key]
        res = cpu.detect_device(batches[tag])
        same = all(torch.equal(a, b) for a, b in zip(got, res))
        dets = to_detections(got)
        sat = bool(res.saturated.any())
        equal = sat or dets == cpu.detect(batches[tag])
        log(f"[13] {tag} with no card: platforms {info[tag]['platforms']}, "
            f"ran {info[tag]['device']}, loaded in "
            f"{info[tag]['load_s']:.2f} s, golden probe verified; "
            f"{sum(map(len, dets))} detections, bit for bit with the CPU "
            f"Net's detect_device: {same}; "
            + ("top-k saturated (the program's K is sealed at export)"
               if sat else f"equal to its detect: {equal}"))
        if not (same and equal) or info[tag]["device"] != "cpu" or \
                tuple(info[tag]["platforms"]) != EXPORT_PLATFORMS:
            raise AssertionError(f"{tag}: the CPU program differs")
        if key == "parity":
            worst, flips = pair_parity(
                dets, to_detections(ex.NMSResult(*want[tag])), "the card")
            log(f"[13] {tag}: the CPU program's detections paired with the "
                f"card program's: worst score difference {worst:.2e}, "
                f"{flips} integer coordinates flipped")


def export_phase(pt, nets, frames, dev, wbytes, cpu_nets) -> None:
    """Phase 13: four artifacts of xl at 320x320 (``Net.export``): the
    region fast Net at batch 1 and 64, parity at batch 1, int8 default at
    batch 1 (phase 12's plan), each with its export time, its .pt2 size
    and the ``ffcnn::`` ops in it; each loaded here and its detections on
    seeded frames held to ``Net.detect_device`` bit for bit; then all
    loaded in one fresh process that imports only
    ``ffcnn_tpu_torch.export`` (its load times, ``verify_artifact`` on
    each, the same frames' results, equal to this process's or within the
    probe tolerances: which of the two is logged); last, each artifact's
    replay (``ArtifactNet``, one CUDA graph) against the Net bucket's at
    its batch, in turns.  The artifacts of EXPORTS_2P hold a program for
    each of EXPORT_PLATFORMS (bytes against the card program's alone); a
    process with no visible card runs their CPU programs beside the fresh
    one (``platform_checks``; ``cpu_nets``: the region and parity Nets on
    the CPU).  Then the float32 knobs (``knob_exports``)."""
    import torch
    from ffcnn_tpu_torch import export as ex
    from ffcnn_tpu_torch.runtime import to_detections
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 13)
    with tempfile.TemporaryDirectory() as tmp:
        paths, want, batches = {}, {}, {}
        for tag, key, nb in EXPORTS:
            net = nets[key]
            path = paths[tag] = os.path.join(tmp, f"{tag}.pt2")
            plats = EXPORT_PLATFORMS if tag in EXPORTS_2P else None
            te = time.perf_counter()
            size = net.export(path, batch_size=nb, platforms=plats)
            te = time.perf_counter() - te
            batch = np.concatenate([frames[:1], rng.randint(
                0, 256, (nb - 1, 320, 320, 3), dtype=np.uint8)])[:nb]
            np.save(path + ".frames.npy", batch)
            batches[tag] = batch
            want[tag] = [t.cpu() for t in net.detect_device(batch)]
            tl = time.perf_counter()
            art = ex.load_exported(path)
            tl = time.perf_counter() - tl
            got = [t.cpu() for t in art.call(batch)]
            same = all(torch.equal(a, b) for a, b in zip(got, want[tag]))
            if plats:
                with zipfile.ZipFile(path) as zf:
                    one = zf.getinfo("cuda.pt2").file_size
                what = (f"for {list(plats)} in {te:.2f} s, {size} bytes "
                        f"({size / one:.3f}x the card program's {one}); "
                        f"platforms {art.platforms}, loaded {art.device.type}")
                same = same and art.platforms == plats \
                    and art.device.type == "cuda"
            else:
                what = f"in {te:.2f} s, {size} bytes"
            log(f"[13] {tag}: exported {what}, ops {art.meta['custom_ops']};"
                f" loaded here in {tl:.2f} s; its detections on {nb} seeded "
                f"frames equal Net.detect_device's bit for bit: {same}")
            if not same:
                raise AssertionError(f"{tag}: the artifact differs from the "
                                     f"Net in the same process")
        # the CPU programs in a process with no visible card, beside the
        # fresh process that loads every card program
        proc = subprocess.Popen(
            [sys.executable, "-c", PLATFORM_LOADER, REPO,
             json.dumps({t: paths[t] for t in EXPORTS_2P})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=tmp, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        try:
            res = subprocess.run(
                [sys.executable, "-c", EXPORT_LOADER, REPO,
                 json.dumps(paths)],
                capture_output=True, text=True, timeout=300, cwd=tmp)
            t1 = time.perf_counter()
            platform_checks(ex, cpu_nets, proc, paths, batches, want)
            t1 = time.perf_counter() - t1
        finally:
            proc.kill()
            proc.wait()
        if res.returncode != 0:
            raise AssertionError(f"the artifact loader failed:\n"
                                 f"{res.stderr[-4000:]}")
        line = next(ln for ln in res.stdout.splitlines()
                    if ln.startswith("LOADER "))
        info = json.loads(line[len("LOADER "):])
        if info.pop("modules"):
            raise AssertionError("the loader imported the graph builder")
        for tag, path in paths.items():
            got = torch.load(path + ".res.pt")
            same = all(torch.equal(a, b) for a, b in zip(got, want[tag]))
            gd = to_detections(ex.NMSResult(*got))
            wd = to_detections(ex.NMSResult(*want[tag]))
            close = all(len(g) == len(w) and all(
                a.class_id == b.class_id
                and abs(a.score - b.score) <= ex.PROBE_SCORE_ATOL
                and max(abs(u - v) for u, v in zip(a[2:], b[2:]))
                <= ex.PROBE_BOX_ATOL for a, b in zip(g, w))
                for g, w in zip(gd, wd))
            log(f"[13] {tag} in a fresh process (imports only the export "
                f"module): loaded in {info[tag]['load_s']:.2f} s, golden "
                f"probe verified; {sum(map(len, gd))} detections, "
                + ("bit for bit with this process" if same else
                   "within the probe tolerances of this process"
                   if close else "OUTSIDE the probe tolerances"))
            if not close:
                raise AssertionError(f"{tag}: the fresh process differs")
        # replays: the artifact's graph against the Net bucket's
        for tag, key, nb in EXPORTS:
            net = nets[key]
            anet = ex.ArtifactNet([paths[tag]])
            anet.warmup()
            art = anet._arts[0]
            xb = torch.from_numpy(batches[tag]).to(dev)
            net.detect_device(xb)
            (a1, a2), (b1, b2) = turns(lambda: anet._call(art, xb),
                                       lambda: net.detect_device(xb), 20)
            log(f"[13] {tag} batch {nb}: artifact replay {a1:.3f}, {a2:.3f} "
                f"ms; the Net bucket's {b1:.3f}, {b2:.3f} ms (in turns)")
        t2 = time.perf_counter()
        knob_exports(pt, ex, wbytes, rng, tmp, dev)
        t2 = time.perf_counter() - t2
    log(f"[13] phase 13 took {time.perf_counter() - t0:.1f} s (the float32 "
        f"knobs {t2:.1f}, the CPU programs' checks {t1:.1f})")


# Phase 14: multi-device (``ffcnn_tpu_torch/parallel/``), every mesh over
# slots of one card: DP over DP_SLOTS replicas of the region Net, the
# sharded parity pipeline on a (2, 2, 2) mesh, PP over PP_STAGES stages,
# and two processes of one slot each
DP_SLOTS = 2
SHARDED_MESH = {"spatial_parallel": 2, "model_parallel": 2}
PP_STAGES, PP_MICROBATCHES, PP_BATCH = (2, 4), (4, 8), 16
MP_PROCS, MP_LOCAL = 2, 4


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def region_candidates(rnet, xb):
    """The region Net's decoded candidates of ``xb`` (eager forward)."""
    from ffcnn_tpu_torch.ops.yolo import decode_heads
    b0 = rnet.ir.blobs[0]
    return decode_heads(rnet.ir, [h.float().cpu()
                                  for h in rnet.forward_heads(xb)],
                        b0.w, b0.h)


def hold_to_candidates(tag, dets, cands, rows) -> float:
    """Each image's detections among ``cands``' (phase 4's tolerances);
    ``rows``: the candidate row of each image.  Returns the worst share."""
    worst = 1.0
    for d, j in zip(dets, rows):
        fr = match_fraction(d, *(t[j].numpy() for t in cands),
                            DET_MATCH_PX, DET_MATCH_SCORE)
        worst = min(worst, fr)
        if fr < DET_MATCH_FRAC:
            raise AssertionError(f"{tag}: image {j} {fr:.3f} of its "
                                 f"detections among the candidates")
    return worst


def parallel_phase(pt, rnet, pnet, wbytes, frames, counters) -> dict:
    """Phase 14, its checks (after phase 12's, before the timing phases'
    traces), every mesh over slots of cuda:0.  ``DPNet`` over the region
    Net on DP_SLOTS slots and on ``make_mesh()`` (every visible card): the
    first call's launches (the replicas' buckets built: WARMUP_RUNS + 1
    forwards each) and a replay's kernels (``kernel_events``: one forward
    a slot, no launch from Python); the result against ``detect_device``
    on each shard (bit for bit: each slot runs the Net's program at the
    shard's batch) and on the whole batch (bit for bit or phase 4's
    tolerances, logged); a batch of 63 padded.  The sharded parity
    pipeline on a (2, 2, 2) mesh (TP filters on) and PP over 2 and 4
    stages against the parity Net (phase 5's pairing), K2 once a data
    shard or microbatch and no other kernel.  ``cli bench --dp`` and
    ``--sp 2``; ``serve --dp`` with four concurrent POSTs held to the
    eager candidates; two processes through ``init_distributed``,
    ``global_batch`` and ``local_results``.  Returns what the timings
    reuse."""
    import concurrent.futures
    import http.client
    import threading
    import torch
    from ffcnn_tpu_torch import parallel as par
    from ffcnn_tpu_torch import serve
    from ffcnn_tpu_torch.net import WARMUP_RUNS
    from ffcnn_tpu_torch.ops.nms import NMSResult
    from ffcnn_tpu_torch.runtime import to_detections
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    xb = torch.from_numpy(frames).to(dev)
    cands = region_candidates(rnet, xb)
    want = WANT_COUNTS["region"]
    out = {"dp": {}}
    for name, mesh in (("dp 2 slots", par.make_mesh([dev] * DP_SLOTS)),
                       ("dp make_mesh()", par.make_mesh())):
        dpn = par.DPNet(rnet, mesh)
        nd = dpn.ndata
        per = BATCH // nd
        built = sum(per not in bucket_of(r, frames).graphs
                    for r in dpn.replicas)
        res, counts = counted(counters, lambda: dpn._fn(320, 320)(xb))
        n_fwd = built * (WARMUP_RUNS + 1)
        log(f"[14] {name} ({mesh.shape}) region detect batch {BATCH}, "
            f"{nd} replica(s) of {per}, {built} bucket(s) built in the "
            f"call: launches " + " ".join(f"{k} {v}" for k, v in
                                           counts.items() if v))
        if counts["K2"] != n_fwd or any(counts[k] != v * n_fwd
                                        for k, v in want.items()):
            raise AssertionError(f"{name}: the replicas did not launch "
                                 f"their kernels")
        check_path_counts(f"{name} replay", *kernel_events(
            counters, lambda: dpn._fn(320, 320)(xb))[1:], want, nd, 14)
        shards = [rnet.detect_device(xb[i * per:(i + 1) * per])
                  for i in range(nd)]
        same = all(torch.equal(a, torch.cat([s[j] for s in shards]))
                   for j, a in enumerate(res))
        whole = rnet.detect_device(xb)
        bit = all(torch.equal(a, b) for a, b in zip(res, whole))
        dets = to_detections(res)
        worst = 1.0 if bit else hold_to_candidates(name, dets, cands,
                                                   range(BATCH))
        d63 = dpn.detect(frames[:63])
        pad_ok = d63 == to_detections(NMSResult(*(t[:63] for t in res)))
        log(f"[14] {name}: {sum(map(len, dets))} detections; bit for bit "
            f"with detect_device on each shard: {same}; with the whole "
            f"batch on one Net: {bit}"
            + ("" if bit else f" (worst share among its candidates "
               f"{worst:.3f}, phase 4's tolerances)")
            + f"; batch 63 padded to {-(-63 // nd) * nd}, its detections "
            f"those of the 64's first 63: {pad_ok}")
        if not (same and pad_ok):
            raise AssertionError(f"{name} differs from the Net")
        out["dp"][name] = dpn
    # the sharded parity pipeline and PP, against the parity Net
    few = frames[:8]
    pdets = pnet.detect(few)
    max_k = pnet._max_candidates()
    mesh3 = par.make_mesh([dev] * 8, **SHARDED_MESH)
    fn, place = par.build_sharded_pipeline(
        pnet.ir, mesh3, 320, 320, dtype=torch.float32, topk=max_k,
        shard_filters=True)
    placed = place(pnet.params)
    res, counts = counted(counters, lambda: fn(placed, few,
                                               pt.DEFAULT_MEAN,
                                               pt.DEFAULT_NORM))
    worst, flips = pair_parity(to_detections(res), pdets,
                               "the parity Net")
    rep = place.report
    log(f"[14] sharded parity pipeline, mesh {mesh3.shape} over cuda:0, "
        f"batch 8: {len(rep['sharded'])} convs sharded on 'model', "
        f"{len(rep['replicated'])} replicated; launches "
        + " ".join(f"{k} {v}" for k, v in counts.items() if v)
        + f"; {sum(map(len, pdets))} detections equal the parity Net's "
        f"(class, integer box), max |score diff| {worst:.2e}, integer "
        f"flips within {PARITY_BOX_NOISE} px: {flips}")
    if counts["K2"] != 2 or sum(counts.values()) != 2:
        raise AssertionError("the sharded pipeline's launches")
    for n_st in PP_STAGES:
        stages = par.plan_stages(pnet.ir, n_st, dtype="f32")
        fn = par.build_pp_pipeline(
            pnet.ir, pnet.params, par.make_mesh([dev] * n_st,
                                                pipeline_parallel=n_st),
            320, 320, n_microbatches=4, topk=max_k, stages=stages)
        res, counts = counted(counters, lambda: fn(few))
        worst, flips = pair_parity(to_detections(res), pdets,
                                   "the parity Net")
        log(f"[14] PP {n_st} stages (cuts "
            f"{[s.start for s in stages[1:]]}, live blobs "
            f"{[len(s.live_in) for s in stages[1:]]}), 4 microbatches of "
            f"2: launches " + " ".join(f"{k} {v}" for k, v in
                                       counts.items() if v)
            + f"; detections equal the parity Net's, max |score diff| "
            f"{worst:.2e}, integer flips {flips}")
        if counts["K2"] != 4 or sum(counts.values()) != 4:
            raise AssertionError(f"PP {n_st} stages' launches")
    # the command line and the server: one slot a visible card
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "xl.weights")
        with open(wpath, "wb") as f:
            f.write(wbytes)
        with environ(REGION_FLAGS):
            line = run_cli(["bench", "--dp", "--cfg", CFG, "--weights",
                            wpath, "--batch", str(BATCH), "--iters",
                            "10"]).strip()
            log(f"[14] cli bench --dp, region flags: {line}")
            if not line.startswith(f"batch {BATCH} @320x320 dp mesh "
                                   f"{{'data': {cards}, "):
                raise AssertionError("cli bench --dp")
            line = run_cli(["bench", "--sp", "2", "--cfg", CFG, "--weights",
                            wpath, "--batch", str(PP_BATCH), "--iters",
                            "3"]).strip()
            log(f"[14] cli bench --sp 2: {line}")
            if not line.startswith(f"batch {PP_BATCH} @320x320 mesh "
                                   "{'data': 1, 'spatial': 2, "):
                raise AssertionError("cli bench --sp 2")
            args = serve.parser().parse_args(
                ["--cfg", CFG, "--weights", wpath, "--dp"])

            def refuse(msg):
                raise AssertionError(msg)
            snet = serve.load_net(args, refuse)
        service = serve.DetectorService(snet, max_batch=8)
        service.warmup()
        srv = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()

        def post(i):
            conn = http.client.HTTPConnection(
                "127.0.0.1", srv.server_address[1], timeout=120)
            try:
                conn.request("POST", "/detect", body=bmp_bytes(frames[i]))
                r = conn.getresponse()
                return r.status, json.loads(r.read())
            finally:
                conn.close()
        try:
            with concurrent.futures.ThreadPoolExecutor(4) as ex:
                answers = list(ex.map(post, range(4)))
        finally:
            srv.shutdown()
            srv.server_close()
            service._batcher.close()
            thread.join(timeout=30)
        if any(st != 200 for st, _ in answers):
            raise AssertionError(f"serve --dp answered {answers}")
        dets = [[pt.Detection(d["score"], d["class_id"], *d["box"])
                 for d in body["detections"]] for _, body in answers]
        worst = hold_to_candidates("serve --dp", dets, cands, range(4))
        log(f"[14] serve --dp ({snet.mesh.shape}): 4 "
            f"concurrent POST /detect, all 200, "
            f"{sum(map(len, dets))} detections, worst share among the eager "
            f"candidates {worst:.3f} ok")
        # two processes of one slot each on the card, over gloo
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-worker",
             str(port), str(rank), wpath], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for rank in range(MP_PROCS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for rank, (p, text) in enumerate(zip(procs, outs)):
            for line in text.splitlines():
                if line.startswith("[14]"):
                    log(line)
            if p.returncode != 0 or f"MP-OK {rank}" not in text:
                log(text[-4000:])
                raise AssertionError(f"process {rank} failed")
    log(f"[14] phase 14 checks took {time.perf_counter() - t0:.1f} s")
    return out


def mp_worker(port: int, rank: int, wpath: str) -> int:
    """One of phase 14's processes: joins the gloo group, runs the region
    Net's DP pipeline on its MP_LOCAL seeded frames (``global_batch``) and
    holds its rows (``local_results``) to its Net's ``detect_device``."""
    import torch
    sys.path.insert(0, REPO)
    import ffcnn_tpu_torch as pt
    from ffcnn_tpu_torch.parallel import build_dp_pipeline, make_mesh
    from ffcnn_tpu_torch.parallel.multiprocess import (
        global_batch, init_distributed, local_results, shutdown_distributed)
    dev = torch.device("cuda", 0)
    info = init_distributed(f"127.0.0.1:{port}", MP_PROCS, rank,
                            devices=[dev])
    with environ(REGION_FLAGS):
        net = pt.load(CFG, wpath, mode="fast", device="cuda")
    mesh = make_mesh([dev])
    local = np.random.RandomState(SEED + 14 + rank).randint(
        0, 256, (MP_LOCAL, 320, 320, 3), dtype=np.uint8)
    start, mine = local_results(build_dp_pipeline(net, mesh, 320, 320)(
        global_batch(mesh, local)))
    want = net.detect_device(local)
    same = all(np.array_equal(a, b.cpu().numpy())
               for a, b in zip(mine, want))
    ok = (same and start == rank * MP_LOCAL and info.process_count == MP_PROCS
          and info.global_devices == MP_PROCS)
    shutdown_distributed()
    print(f"[14] process {rank} of {info.process_count} "
          f"({info.global_devices} devices in the census): rows from "
          f"{start}, {int(mine.count.sum())} detections, bit for bit with "
          f"its Net's detect_device: {same}", flush=True)
    print(f"MP-OK {rank}" if ok else f"MP-FAIL {rank}", flush=True)
    return 0 if ok else 1


def parallel_times(pt, rnet, pnet, p14, frames, dev) -> None:
    """Phase 14, its timings (last; CUDA events, every mesh over slots of
    cuda:0): the region Net's ``detect_device`` at batch 64 against DP
    over ``make_mesh()`` and over DP_SLOTS slots, in turns, and each
    replica's ``memory_stats``; PP over 2 and 4 stages at 4 and 8
    microbatches of a batch of PP_BATCH against the serial parity forward
    (the eager pipeline and the bucket's replay); the sharded parity
    pipeline over SP 2 and TP 2 against it on one slot."""
    import torch
    from ffcnn_tpu_torch import parallel as par
    t0 = time.perf_counter()
    xb = torch.from_numpy(frames).to(dev)
    dps = p14["dp"]
    fns = {"Net": lambda: rnet.detect_device(xb),
           **{k: (lambda f=d._fn(320, 320): f(xb)) for k, d in dps.items()}}
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k].append(cuda_ms(fns[k], 20))
    log(f"[14] region detect_device batch {BATCH} (two turns): " + ", ".join(
        f"{k} {a:.3f} / {b:.3f} ms" for k, (a, b) in ms.items()))
    single = rnet.memory_stats(batch_size=BATCH)
    log(f"[14] region memory_stats, one Net at batch {BATCH}: " + ", ".join(
        f"{k} {v / 2**20:.3f} MiB" for k, v in single.items()))
    for name, dpn in dps.items():
        per = BATCH // dpn.ndata
        for i, r in enumerate(dpn.replicas):
            m = r.memory_stats(batch_size=per)
            log(f"[14] {name} replica {i} memory_stats at batch {per}: "
                + ", ".join(f"{k} {v / 2**20:.3f} MiB" for k, v in m.items()))
    x16 = xb[:PP_BATCH]
    f16 = frames[:PP_BATCH]
    max_k = pnet._max_candidates()
    serial = {"parity eager": lambda: bucket_of(pnet, f16).run(x16),
              "parity bucket": lambda: pnet.detect_device(x16)}
    for k, f in serial.items():
        log(f"[14] serial {k} batch {PP_BATCH}: {cuda_ms(f, 5, 1):.3f} / "
            f"{cuda_ms(f, 5, 1):.3f} ms")
    for n_st in PP_STAGES:
        mesh = par.make_mesh([dev] * n_st, pipeline_parallel=n_st)
        for nmb in PP_MICROBATCHES:
            fn = par.build_pp_pipeline(pnet.ir, pnet.params, mesh, 320, 320,
                                       n_microbatches=nmb, topk=max_k)
            a, b = cuda_ms(lambda: fn(x16), 5, 1), cuda_ms(lambda: fn(x16),
                                                            5, 1)
            log(f"[14] PP {n_st} stages, {nmb} microbatches of "
                f"{PP_BATCH // nmb}, parity: {a:.3f} / {b:.3f} ms a step "
                f"({n_st + nmb - 1} ticks)")
    for name, slots, kw in (("one slot", 1, {}),
                            ("SP 2", 2, {"spatial_parallel": 2}),
                            ("TP 2", 2, {"model_parallel": 2})):
        fn, place = par.build_sharded_pipeline(
            pnet.ir, par.make_mesh([dev] * slots, **kw), 320, 320,
            dtype=torch.float32, topk=max_k,
            shard_filters="model_parallel" in kw)
        placed = place(pnet.params)

        def run():
            return fn(placed, x16, pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
        a, b = cuda_ms(run, 3, 1), cuda_ms(run, 3, 1)
        log(f"[14] sharded parity pipeline, {name}, batch {PP_BATCH}: "
            f"{a:.3f} / {b:.3f} ms")
    log(f"[14] phase 14 timings took {time.perf_counter() - t0:.1f} s")


# Phase 16: the rest of the Darknet zoo through Net, each model at its
# cfg's 416x416 (full width and depth) with weights from
# synth_weights_bytes(seed 42, obj_bias 2.0), in a process of its own
# (``--zoo``) started once the build has ended, so that its Nets' memory at
# batch 256 is apart from the other phases': (tag, cfg)
ZOO = (("yolov3-tiny", "models/yolov3-tiny.cfg"),
       ("yolov4-tiny", "models/yolov4-tiny.cfg"),
       ("yolov3", "models/yolov3.cfg"), ("yolov4", "models/yolov4.cfg"))
# the models whose synthetic scores tie on the CPU, whose parity is held
# on the pre-NMS candidates and the tail: yolov4 (tests/test_model_zoo.py's
# TIE_PRONE), and yolov4-tiny, on whose letterboxed fixture greedy NMS kept
# one of two same-class candidates one float32 ulp apart in score (IoU
# 0.62) on the card and the other on the CPU, their candidates equal
# within the gate's tolerances and 1,472 of the CPU's 2,535 live ones
# within 1e-6 of another's score of their class (an H100 80GB HBM3, 700 W)
ZOO_TIE_PRONE = {"yolov4-tiny", "yolov4"}
# each model's unfused int8 convs by the int8 conv's path
# (``conv_int8.route``; tests/test_torch_zoo.py pins them on the CPU)
ZOO_INT8_PATHS = {"yolov3-tiny": {"gemm": 9}, "yolov4-tiny": {"gemm": 18},
                  "yolov3": {"gemm": 71}, "yolov4": {"gemm": 106}}
# seeded frames a model: the calibration set; the first two are parity's
# and fast mode's batch, the first alone the CPU's fast and int8 check
ZOO_FRAMES = 8
ZOO_INT8_BATCH = 4                  # the int8 conv's shapes checked at it
# detect_device's rows: (batch, iters); ZOO_PROFILE's, eager and bucket,
# at both, every other model's bucket at the last
ZOO_TIMED = ((1, 10), (BATCH, 2))
ZOO_MEMORY = (BATCH, 256)           # memory_stats batches, fast mode
ZOO_PROFILE = "yolov4"              # profile_layers, fast, batch 64
ZOO_BENCH = ["--cfg", os.path.join(REPO, "models", "yolov4.cfg"),
             "--parity-gate", "candidates", "--batches", "64",
             "--windows", "3", "--iters", "10"]
# the phase's budget, the CPU included: what its checks, timings and bench
# took on an H100 80GB HBM3 at 700 W (167.4 and 188.8 s), with room
ZOO_PHASE_S = 200
ZOO_TIMEOUT_S = 900                 # the process's, a hang's guard
# the window within which two same-class candidate scores of the CPU count
# as tied (the evidence for the candidates gate)
ZOO_TIE_WINDOW = 1e-6
# The int8 conv's codes after a mish epilogue: the card's mish (float32
# tanhf(log1pf(expf(v)))) may land C0Q_MISH_ULPS float32 ulps from
# torch's, at most 2^-16 in code units at |code| <= 127, inside INT8_TIE's
# window around a tie (check_codes).


def zoo_model(pt, counters, tag: str, cfg: str) -> dict:
    """Phase 16, one model's checks on the card against the CPU:

    1. parity (float32, TF32 off; the card's detect grows K a bucket a
       rung) against the CPU on two seeded frames and the letterboxed
       fixture: the detections as sets (``pair_parity``), or for a
       ZOO_TIE_PRONE model the candidates and the card's tail on the
       CPU's (``bench.parity_candidates``), with the CPU's tied scores
       logged; each rung's bucket built once (K2 three times a bucket, no
       other kernel), the replays bit for bit with the eager card path;
    2. fast: the first detect's launches (K2 alone, once a forward of the
       bucket's build), a replay's kernels equal to an eager run's, heads
       and detections held to the CPU on one frame (phase 4's tolerances;
       the CPU's bf16 forward timed);
    3. fast under FFCNN_CONV0_INT8=1: the int8 conv's u8 path once a
       forward (no other path), the replay, the stem's params inside the
       Net against its plain version on the Net's letterboxed frames
       (``u8_cases``: bit for bit, mish within C0Q_MISH_ULPS), the CPU;
    4. int8: ``Net.calibrate`` on the card against the CPU on ZOO_FRAMES
       seeded frames (blob scales to 1e-5, weight codes 99.9% equal); every
       distinct unfused int8 conv shape of the plan at batch
       ZOO_INT8_BATCH against its plain version (``int8_conv_check``:
       accumulators bit for bit, the path ``route`` names, codes equal or
       one apart at a tie); the int8 Net under the card's plan, installed
       on both with ``set_quant_plan``: launches (the int8 conv on each
       unfused int8 conv by ZOO_INT8_PATHS, K2), the replay, the CPU.

    Returns the card's Nets and what the timings take."""
    import torch
    from ffcnn_tpu_torch import quant as tq
    from ffcnn_tpu_torch.bench import parity_candidates
    from ffcnn_tpu_torch.darknet.weights import load_weights
    from ffcnn_tpu_torch.kernels import conv_int8 as ci
    from ffcnn_tpu_torch.ops.preprocess import letterbox_uint8
    from ffcnn_tpu_torch.runtime import WARMUP_RUNS
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    path = os.path.join(REPO, cfg)
    ir = pt.parse_cfg(path)
    size = ir.blobs[0].w
    wbytes = pt.synth_weights_bytes(ir, seed=SEED, obj_bias=2.0)
    params, _ = load_weights(ir, wbytes)
    frames = np.random.RandomState(SEED + 16).randint(
        0, 256, (ZOO_FRAMES, size, size, 3), dtype=np.uint8)
    two, one = frames[:2], frames[:1]
    fixture = pt.bmp_load(BMP)[None]
    built = WARMUP_RUNS + 1
    nothing = dict.fromkeys(KERNEL_SYMBOLS, 0)
    cpu_s = {}

    def load(mode, device, flags=None, **kw):
        with environ(flags or {}):
            return pt.Net(ir, params, mode=mode, device=device, **kw)

    def step(what):
        log(f"[16] {tag} {what} took {time.perf_counter() - t0:.1f} s so "
            f"far")

    def on_cpu(key, fn):
        t = time.perf_counter()
        out = fn()
        cpu_s[key] = cpu_s.get(key, 0.0) + time.perf_counter() - t
        return out

    def launched(what, counts, want):
        """The wrappers' counts of a call: ``want``'s, every other 0."""
        log(f"[16] {tag} {what}: launches " + " ".join(
            f"{k} {v}" for k, v in counts.items() if v))
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"{tag} {what}: launches differ from "
                                 f"{want}")

    # 1. parity.  The CPU's Net takes the model's candidate count as its
    # top-k: the detections the card's K growth reaches (once the census
    # fits, every live candidate is in the top K, in the stable sort's
    # order), in one CPU forward where the growth would take one a rung
    pnet = load("parity", "cuda")
    max_k = pnet._max_candidates()
    pcpu = load("parity", "cpu", topk=max_k)
    log(f"[16] {tag} {size}x{size}: {len(ir.layers)} layers, "
        f"{len(wbytes)} weight bytes, {max_k} candidates at most")
    for what, batch in (("2 seeded frames", two),
                        ("the 320x320 fixture, letterboxed", fixture)):
        pg, counts = counted(counters, lambda: pnet.detect(batch))
        ks = sorted(k[3] for k in pnet._pipelines
                    if k[:2] == batch.shape[1:3])
        launched(f"parity detect {what} (a bucket built a rung of K "
                 f"{ks})", counts, {"K2": built * len(ks)})
        check_dets(f"{tag} parity", pg)
        if not any(pg):
            raise AssertionError(f"{tag} parity found nothing")
        if tag in ZOO_TIE_PRONE:
            out = {}
            n = on_cpu("parity", lambda: parity_candidates(
                pnet, pcpu, batch, out=out))
            cs = out["cpu"]
            live = cs.scores > 0
            ties = sum(zoo_ties(cs.scores[i][live[i]],
                                cs.classes[i][live[i]])
                       for i in range(len(batch)))
            try:
                pair_parity(pg, pcpu._to_detections(out["tail"]), "the CPU")
                as_sets = "equal"
            except AssertionError as e:
                as_sets = f"not equal ({e})"
            gate = (f"{n} live candidates equal (class, score to "
                    f"{PARITY_SCORE_TOL}, box to 1e-4 of the range), the "
                    f"card's tail on the CPU's candidates bit for bit; "
                    f"{ties} of the CPU's live candidates within "
                    f"{ZOO_TIE_WINDOW} of another's score of their class; "
                    f"the detections as sets {as_sets}")
        else:
            pc = on_cpu("parity", lambda: pcpu.detect(batch))
            try:
                worst, flips = pair_parity(pg, pc, "the CPU")
            except AssertionError:
                parity_diff(tag, pnet, pcpu, batch, pg, pc)
                raise
            gate = (f"{sum(map(len, pg))} detections equal (class, integer"
                    f" box), max |score diff| {worst:.2e}, integer flips "
                    f"within {PARITY_BOX_NOISE} px: {flips}")
        pe = eager_detect(pnet, batch)
        log(f"[16] {tag} parity card vs CPU, {what}: {gate}; the card "
            f"{[len(d) for d in pg]} detections, K reached {ks[-1]}; bit "
            f"for bit with the eager card path: {pg == pe}")
        if pg != pe:
            raise AssertionError(f"{tag} parity: the bucket's replay "
                                 f"differs from the eager card path")

    step("parity")

    # 2. fast: no block run or head chain on these graphs; K2 alone
    fnet, fcpu = load("fast", "cuda"), load("fast", "cpu")
    if fnet._fused_runs or fnet._head_runs:
        raise AssertionError(f"{tag}: the planners found a run "
                             f"{fnet._fused_runs} {fnet._head_runs}")
    dets, counts = counted(counters, lambda: fnet.detect(two))
    launched("fast detect batch 2, its bucket built in the call", counts,
             {"K2": built})
    check_dets(f"{tag} fast", dets)
    check_replay(f"{tag} fast", fnet, counters, two, dets, nothing, 16)
    heads = on_cpu("fast", lambda: fcpu.forward_heads(torch.from_numpy(one)))
    log(f"[16] {tag} fast: the CPU's bf16 forward of one frame took "
        f"{cpu_s['fast']:.2f} s")
    check_against_cpu(f"{tag} fast", fnet, fcpu, one, dets[:1], 16, heads)

    step("fast")

    # 3. fast under FFCNN_CONV0_INT8=1: conv-1 on the int8 conv's u8 path
    flag = {"FFCNN_CONV0_INT8": "1"}
    qnet, qcpu = load("fast", "cuda", flag), load("fast", "cpu", flag)
    ci.conv_int8.routes.update(dict.fromkeys(ci.ROUTES, 0))
    dets, counts = counted(counters, lambda: qnet.detect(two))
    by_path = {k: v for k, v in ci.conv_int8.routes.items() if v}
    launched(f"conv-1 int8 detect batch 2 (by path {by_path})", counts,
             {"K2": built, "conv_int8": built})
    if by_path != {"u8": built}:
        raise AssertionError(f"{tag} conv-1 int8 took {by_path}")
    check_dets(f"{tag} conv-1 int8", dets)
    check_replay(f"{tag} conv-1 int8", qnet, counters, two, dets,
                 {**nothing, "conv_int8": 1}, 16)
    c0q = qnet._folded_all(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[2]
    x = letterbox_uint8(torch.from_numpy(two).to(dev), size,
                        size).contiguous()
    u8_cases(ci, f"{tag} conv-1 int8, the Net's stem F {c0q.filters} "
                 f"s{c0q.stride} act {c0q.act} {size}x{size} batch 2", x,
             c0q, 16)
    heads = on_cpu("conv-1 int8", lambda: qcpu.forward_heads(
        torch.from_numpy(one)))
    check_against_cpu(f"{tag} conv-1 int8", qnet, qcpu, one, dets[:1], 16,
                      heads)
    del qcpu, fcpu, pcpu
    step("conv-1 int8")

    # 4. int8: calibration card vs CPU, the int8 conv at every distinct
    # unfused shape, the Net under one plan
    inet, icpu = load("int8", "cuda"), load("int8", "cpu")
    inet.calibrate(frames)
    on_cpu("calibrate", lambda: icpu.calibrate(frames))
    gp, cp = inet.quant, icpu.quant
    rel = max(abs(gp.blob_scale[b] - s) / s
              for b, s in cp.blob_scale.items())
    same = sum(int((gp.weights[li]["wq"].cpu() == q["wq"]).sum())
               for li, q in cp.weights.items())
    total = sum(q["wq"].numel() for q in cp.weights.values())
    log(f"[16] {tag} calibration on {len(frames)} frames, card vs CPU: "
        f"{len(gp.blob_scale)} int8 blobs, {len(gp.weights)} int8 convs; "
        f"blob scales max rel diff {rel:.2e}; wq codes equal {same} of "
        f"{total} ({same / total:.6f})")
    if sorted(gp.blob_scale) != sorted(cp.blob_scale) or rel > 1e-5 \
            or same < 0.999 * total or sorted(gp.weights) != \
            sorted(cp.weights):
        raise AssertionError(f"{tag} calibration on the card differs from "
                             f"the CPU")
    inet.set_quant_plan(gp)
    icpu.set_quant_plan(gp)
    step("calibration")
    convs = tq.unfused_int8(inet)
    paths = {}
    for li in convs:
        b, l = ir.blobs[li], ir.layers[li]
        p = ci.route(b.c, l.fn, l.fs, l.stride, l.groups)
        paths[p] = paths.get(p, 0) + 1
    if paths != ZOO_INT8_PATHS[tag]:
        raise AssertionError(f"{tag}: unfused int8 convs by path {paths}, "
                             f"want {ZOO_INT8_PATHS[tag]}")
    qs = tq.quant_state(gp, ir, torch.bfloat16, dev)
    gen = torch.Generator().manual_seed(SEED + 16)
    shapes = tq.conv_shapes(inet, distinct=True)
    for li, geo in shapes:
        h, w, c = geo[:3]
        cvp = qs.convs[li]
        x = torch.randint(-127, 128, (ZOO_INT8_BATCH, h, w, c),
                          generator=gen, dtype=torch.int8).to(dev)
        int8_conv_check(
            ci, f"{tag} L{li} {cvp.fs}x{cvp.fs} s{cvp.stride} {h}x{w} "
                f"C{c}->{cvp.filters} act {cvp.act}", x, cvp,
            ZOO_INT8_BATCH, 16)
    log(f"[16] {tag} the int8 conv at the plan's {len(shapes)} distinct "
        f"unfused shapes ({len(convs)} convs, by path {paths}) against its "
        f"plain version: ok")
    step("the int8 conv's shapes")
    ci.conv_int8.routes.update(dict.fromkeys(ci.ROUTES, 0))
    dets, counts = counted(counters, lambda: inet.detect(one))
    by_path = {k: v for k, v in ci.conv_int8.routes.items() if v}
    launched(f"int8 detect batch 1, its bucket built in the call (by path "
             f"{by_path})", counts,
             {"K2": built, "conv_int8": len(convs) * built})
    if by_path != {k: v * built for k, v in paths.items()}:
        raise AssertionError(f"{tag} int8 took {by_path}")
    check_dets(f"{tag} int8", dets)
    check_replay(f"{tag} int8", inet, counters, one, dets,
                 {**nothing, "conv_int8": len(convs)}, 16)
    heads = on_cpu("int8", lambda: icpu.forward_heads(torch.from_numpy(one)))
    check_against_cpu(f"{tag} int8", inet, icpu, one, dets, 16, heads)
    took = time.perf_counter() - t0
    log(f"[16] {tag} checks took {took:.1f} s, the CPU's sides "
        + ", ".join(f"{k} {v:.1f}" for k, v in cpu_s.items()) + " s")
    return {"nets": {"fast": fnet, "parity": pnet, "int8": inet},
            "ir": ir, "params": params, "size": size, "frames": frames,
            "cpu_s": sum(cpu_s.values())}


def parity_diff(tag, pnet, pcpu, batch, pg, pc) -> None:
    """Log where the card's parity detections ``pg`` differ from the CPU's
    ``pc``: whether the pre-NMS candidates agree (``bench.
    parity_candidates``) and how many of the CPU's tie; for the first
    card detections that are not the CPU's, the CPU's detections of that
    class overlapping it (min-area IoU above NMS's 0.5), with their score
    gaps (near 0: greedy NMS kept another member of a tied cluster)."""
    from ffcnn_tpu_torch.bench import parity_candidates
    out = {}
    try:
        n = parity_candidates(pnet, pcpu, batch, out=out)
        cs = out["cpu"]
        live = cs.scores > 0
        ties = sum(zoo_ties(cs.scores[i][live[i]], cs.classes[i][live[i]])
                   for i in range(len(batch)))
        log(f"[16] {tag} parity: {n} live candidates equal the CPU's, the "
            f"card's tail on them bit for bit; {ties} of the CPU's within "
            f"{ZOO_TIE_WINDOW} of another's score of their class")
    except AssertionError as e:
        log(f"[16] {tag} parity: the candidates differ from the CPU's: {e}")

    def iou(a, b):
        w = min(a[4], b[4]) - max(a[2], b[2])
        h = min(a[5], b[5]) - max(a[3], b[3])
        area = min((a[4] - a[2]) * (a[5] - a[3]), (b[4] - b[2]) * (b[5] - b[3]))
        return w * h / area if w > 0 and h > 0 and area > 0 else 0.0
    for i, (a, b) in enumerate(zip(pg, pc)):
        lone = [g for g in a if not any(
            c.class_id == g.class_id and abs(c.score - g.score)
            <= PARITY_SCORE_TOL and all(int(u) == int(v) or abs(u - v)
                                        <= PARITY_BOX_NOISE
                                        for u, v in zip(g[2:], c[2:]))
            for c in b)]
        log(f"[16] {tag} parity image {i}: card {len(a)}, CPU {len(b)} "
            f"detections, {len(lone)} of the card's not on the CPU")
        for g in lone[:4]:
            log(f"    card {tuple(round(v, 4) for v in g)}; the CPU's "
                f"overlapping: " + ", ".join(
                    f"{tuple(round(v, 4) for v in c)} (IoU {iou(g, c):.3f}"
                    f", score gap {c.score - g.score:.3e})"
                    for c in b if c.class_id == g.class_id
                    and iou(g, c) > 0.5))


def zoo_ties(scores, classes) -> int:
    """How many of one image's live candidate scores lie within
    ZOO_TIE_WINDOW of another candidate's score of the same class."""
    import torch
    n = 0
    for c in torch.unique(classes):
        s = torch.sort(scores[classes == c]).values
        gap = (s[1:] - s[:-1]) <= ZOO_TIE_WINDOW
        near = torch.zeros_like(s, dtype=torch.bool)
        near[1:] |= gap
        near[:-1] |= gap
        n += int(near.sum())
    return n


def host_events_ms(fn, iters: int):
    """(host ms, device ms) a call of ``fn`` over ``iters`` calls after one
    untimed call: the host's wall time over the calls before the closing
    synchronise (a bucket's call waits for the card nowhere, so that is
    the host's time to enqueue it; the card machine's thread CPU clock
    read 0 over three calls), and the CUDA events' time from the first
    call's start to the last one's end (a bucket's replays keep the card
    busy, so that is its device time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    c0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - c0
    end.record()
    end.synchronize()
    return host * 1e3 / iters, start.elapsed_time(end) / iters


def zoo_times(pt, zoo, dev, opts) -> None:
    """Phase 16, its timings, after every model's checks: for each model
    ``memory_stats`` of a fresh fast Net at ZOO_MEMORY's batches; then
    ``detect_device`` in fast, parity and int8 mode: the bucket's replay
    at batch 64, its device time by CUDA events and its host enqueue time
    (``host_events_ms``); for ZOO_PROFILE also at batch 1, and the eager
    pipeline beside it, by events and by torch.profiler (host CPU and
    device time), and ``Net.profile_layers`` of fast mode at batch 64 with
    its ten largest rows.  A model's Net drops its buckets after its rows,
    and the model its Nets after its last.

    ``opts`` (``--zoo``'s flags) bisect a segmentation fault (ROADMAP.md,
    Queue 3): ``trace_replays`` also times each bucket's replays under
    torch.profiler; ``keep_buckets`` drops no bucket and no Net;
    ``recapture`` drops a Net's buckets before its rows, so that every
    timed graph is captured after the Net before dropped its own."""
    import gc
    import torch
    for tag, z in zoo.items():
        size = z["size"]
        mnet = pt.Net(z["ir"], z["params"], mode="fast", device="cuda")
        for nb in ZOO_MEMORY:
            m = mnet.memory_stats(batch_size=nb)
            log(f"[16] {tag} fast memory_stats batch {nb}: " + ", ".join(
                f"{k} {v / 2**20:.3f} MiB" for k, v in m.items()))
        del mnet
        gc.collect()
        torch.cuda.empty_cache()
        for mode, net in z["nets"].items():
            if opts.recapture:
                recaptured(net)
            for nb, iters in ZOO_TIMED[0 if tag == ZOO_PROFILE else -1:]:
                batch = torch.from_numpy(np.resize(
                    z["frames"], (nb, size, size, 3))).to(dev)
                net.warmup(batch_sizes=(nb,))
                bucket = lambda: net.detect_device(batch)
                bh, bd = host_events_ms(bucket, iters)
                text = (f"bucket {bd:.3f} ms a call by events ("
                        f"{nb / bd * 1e3:.1f} img/s), host enqueue "
                        f"{bh:.3f} ms")
                if tag == ZOO_PROFILE:
                    eager = lambda: bucket_of(net, batch).run(batch)
                    ev = cuda_ms(eager, iters, 1)
                    eh, ed = profiled_ms(eager, 2)
                    text += (f"; eager {ev:.3f} ms by events, host CPU "
                             f"{eh:.3f} ms and device {ed:.3f} ms by "
                             f"torch.profiler")
                if opts.trace_replays:
                    th, td = profiled_ms(bucket, 2)
                    text += (f"; the bucket by torch.profiler: host CPU "
                             f"{th:.3f} ms, device {td:.3f} ms")
                log(f"[16] {tag} {mode} detect batch {nb}: {text}")
            if tag == ZOO_PROFILE and mode == "fast":
                rep = net.profile_layers(batch=np.resize(
                    z["frames"], (BATCH, size, size, 3)), iters=3)
                for lp in sorted(rep.layers,
                                 key=lambda lp: -lp.us_per_step)[:10]:
                    log(f"[16]   row L{lp.index:03d} {lp.type_name:9s} "
                        f"{lp.desc:40s} {lp.us_per_step:10.1f} us, floor "
                        f"{rep.floors_us.get(lp.index, 0.0):9.1f} us")
                log(f"[16] {tag} profile_layers fast batch {BATCH}, 3 "
                    f"steps on {rep.device}: total {rep.total_us:.1f} us a "
                    f"step (device), other {rep.other_us:.1f} us, the "
                    f"bucket's replay {rep.replay_us:.1f} us")
            if not opts.keep_buckets:
                net._pipelines.clear()
        if not opts.keep_buckets:
            z["nets"].clear()
        gc.collect()
        torch.cuda.empty_cache()


def zoo_main(opts) -> int:
    """Phase 16 in a process of its own (``chip_smoke.py --zoo``, which the
    whole run starts once the build has ended): every model's checks
    (``zoo_model``), then the timings (``zoo_times``), then the port's
    bench once (ZOO_BENCH), its JSON line printed.  ``opts.tags``, where
    given (``--zoo yolov4``): those models' checks and timings alone, no
    bench, as a reproducer.  Returns 0, or raises."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import ffcnn_tpu_torch as pt
        from ffcnn_tpu_torch import bench
    except ImportError as e:
        print(f"chip_smoke: the repository is not here ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    tags = opts.tags.split(",") if opts.tags else None
    t0 = time.perf_counter()
    zoo = {tag: zoo_model(pt, counters, tag, cfg) for tag, cfg in ZOO
           if tags is None or tag in tags}
    t_checks = time.perf_counter() - t0
    t1 = time.perf_counter()
    zoo_times(pt, zoo, dev, opts)
    t_times = time.perf_counter() - t1
    t1 = time.perf_counter()
    if tags is None:
        row = bench.main(ZOO_BENCH)
        log(f"[16] bench yolov4 ({time.perf_counter() - t1:.1f} s): "
            f"{row['value']:.1f} img/s at batch {row['batch']}, parity "
            f"{row['parity_img_s']:.1f}, int8 {row['int8_img_s']:.1f}, "
            f"stream {row['stream_host_input_img_s']:.1f}, 640x448 "
            f"{row['demo_640x448_img_s']:.1f}, batch 1 p50 "
            f"{row['p50_batch1_ms']:.3f} ms, mfu {row['mfu']:.4%}")
    t_bench = time.perf_counter() - t1
    took = time.perf_counter() - t0
    log(f"[16] phase 16 took {took:.1f} s (checks {t_checks:.1f}, of which "
        f"the CPU's sides {sum(z['cpu_s'] for z in zoo.values()):.1f}; "
        f"timings {t_times:.1f}; the bench {t_bench:.1f}); its budget "
        f"{ZOO_PHASE_S} s {'met' if took <= ZOO_PHASE_S else 'not met'}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    return 0


def kernel_counters() -> dict:
    """Every kernel's wrapper, whose ``launches`` counts its launches."""
    from ffcnn_tpu_torch.kernels import block_fused as bf
    from ffcnn_tpu_torch.kernels import block_variants as bv
    from ffcnn_tpu_torch.kernels import conv0_fused as c0
    from ffcnn_tpu_torch.kernels import conv_int8 as ci
    from ffcnn_tpu_torch.kernels import head_fused as hf
    from ffcnn_tpu_torch.kernels import mbconv as k8
    from ffcnn_tpu_torch.kernels import mbconv_cs as k9
    from ffcnn_tpu_torch.kernels import mosaic_probes as mp
    from ffcnn_tpu_torch.kernels import nms as knms
    from ffcnn_tpu_torch.kernels import pw_matmul as pw
    return {"K1": bf.fused_block, "K2": knms.nms_keep_mask,
            "K3": bf.fused_down_block, "K4": bf.fused_cascade,
            "K5": bf.fused_mega, "K6": c0.conv0_cs,
            "K7": hf.apply_head_run, "K8": k8.fused_mbconv,
            "K9": k9.fused_mbconv_cs, "P1/P2": pw.pw_matmul,
            "P3": bv.block_variant, "P4": mp.strided_rows,
            "P5": mp.dynslice_carry, "conv_int8": ci.conv_int8}


def main() -> int:
    import faulthandler
    import torch
    # a crash in native code (the CUDA runtime, the profiler, a kernel's
    # host side) prints the Python stack that reached it
    faulthandler.enable()
    if sys.argv[1:2] == ["--mp-worker"]:        # one of phase 14's processes
        return mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if sys.argv[1:2] == ["--zoo"]:              # phase 16
        ap = argparse.ArgumentParser(prog="chip_smoke.py --zoo")
        ap.add_argument("tags", nargs="?",
                        help="comma list of models: their checks and "
                             "timings alone, no bench")
        for flag in ("--trace-replays", "--keep-buckets", "--recapture"):
            ap.add_argument(flag, action="store_true",
                            help="zoo_times' bisection of a fault")
        return zoo_main(ap.parse_args(sys.argv[2:]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import ffcnn_tpu_torch as pt
        from ffcnn_tpu_torch import bench_block as bb
        from ffcnn_tpu_torch.graph.build import forward_features
        from ffcnn_tpu_torch.kernels import _build
        from ffcnn_tpu_torch.kernels import block_fused as bf
        from ffcnn_tpu_torch.kernels import conv0_fused as c0
        from ffcnn_tpu_torch.kernels import conv_int8 as ci
        from ffcnn_tpu_torch.kernels import head_fused as hf
        from ffcnn_tpu_torch.kernels import mbconv as k8
        from ffcnn_tpu_torch.kernels import mbconv_cs as k9
        from ffcnn_tpu_torch.kernels import nms as knms
        from ffcnn_tpu_torch.kernels import block_variants as bv
        from ffcnn_tpu_torch.kernels import mosaic_probes as mp
        from ffcnn_tpu_torch.kernels import pw_matmul as pw
        from ffcnn_tpu_torch.net import WARMUP_RUNS
    except ImportError as e:
        print(f"chip_smoke: the repository is not here ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    # 2. build: every source at once (0 s where already built), then load
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for load in (bf.build, bf.build_down, bf.build_cascade, bf.build_mega,
                 c0.build, hf.build, knms.build, k8.build, k9.build,
                 pw.build, bv.build, mp.build, ci.build):
        load()
    log(f"[2] kernels built in {build_s:.1f} s, one nvcc per source in "
        f"parallel: {', '.join(_build.sources())}")

    # 16. the rest of the Darknet zoo, in a process of its own: its Nets at
    # batch 256 take memory that this process's phases could not then hold
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--zoo"], timeout=ZOO_TIMEOUT_S).returncode
    log(f"[16] the phase's process exited {rc} after "
        f"{time.perf_counter() - t0:.1f} s")
    if rc:
        raise AssertionError("phase 16 failed")

    # the nets of every path, on the card and on the CPU (the same weights)
    wbytes = pt.synth_weights_bytes(pt.parse_cfg(CFG), seed=SEED,
                                    obj_bias=2.0)
    nets = {tag: load_net(pt, wbytes, f, "cuda")
            for tag, f in PATH_FLAGS.items()}
    cpus = {tag: load_net(pt, wbytes, f, "cpu")
            for tag, f in PATH_FLAGS.items()}
    net, rnet, cnet, mnet = (nets[t] for t in PATH_FLAGS)
    ir, runs = net.ir, net._fused_runs
    if [(r.start, r.end, len(r.blocks)) for r in runs] != \
            [(38, 57, 4), (61, 80, 4), (84, 108, 5)] or net._head_runs:
        raise AssertionError(f"unexpected default plan {runs}")
    cgroups = group_params(cnet)
    if [[b.start for b in g] for g, _ in cgroups] != CASCADE_GROUPS:
        raise AssertionError(f"unexpected cascade plan {cgroups}")
    cgroups = [(g, bps) for g, bps in cgroups if len(g) > 1]
    if mnet._mega_runs != {84}:
        raise AssertionError(f"unexpected mega runs {mnet._mega_runs}")
    mbps = mnet._fused_params[84]
    # the region configuration at 416x416: the 13x13 head chain, whose
    # stage buffers leave shared memory with one CTA an image (batch
    # SMs / 2 + 1, 67 on 132 SMs) and stay in a cluster of two
    sms = _build.sm_count(dev)
    solo = sms // 2 + 1
    r416 = load_net(pt, wbytes, REGION_FLAGS, "cuda", 416)
    r416cpu = load_net(pt, wbytes, REGION_FLAGS, "cpu", 416)
    hrun416 = r416._head_runs[0]
    hps416 = r416._head_params[hrun416.start]
    if (hps416.h, hps416.w) != (13, 13) \
            or not hf.plan(hps416, solo, sms).scratch \
            or hf.plan(hps416, BATCH, sms).scratch:
        raise AssertionError(f"unexpected 416 head chain {hrun416}")
    # the region configuration at 96x96: xl's two head chains there (3x3
    # C192 and 6x6 C240)
    r96 = load_net(pt, wbytes, REGION_FLAGS, "cuda", 96)
    if [(r.start, r.end) for r in r96._head_runs] != [(116, 120),
                                                     (125, 129)]:
        raise AssertionError(f"unexpected 96 head chains {r96._head_runs}")
    rruns = rnet._fused_runs
    if [(r.start, r.end, len(r.blocks)) for r in rruns] != \
            [(1, 80, 18), (81, 108, 6)] or \
            [(r.start, r.end) for r in rnet._head_runs] != [(116, 120)]:
        raise AssertionError(f"unexpected region plan {rruns} "
                             f"{rnet._head_runs}")
    rc0 = rnet._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[1]
    hrun = rnet._head_runs[0]
    hps = rnet._head_params[hrun.start]
    gen = torch.Generator().manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def k6_plan(x, cp):
        n, h, w, _ = x.shape
        p = c0.plan(n, h, w, cp.wm.shape[1], cp.act, 2, sms,
                    x.data_ptr() % 16 == 0)
        return (f"instance {p.inst_f or 'generic'}, bands of {p.rows}x"
                f"{p.cols}, {'cp.async' if p.aligned else 'word'} copy")

    # 3. kernels against their plain versions
    errs = {k: 0.0 for k in counters}
    dtypes = (torch.float32, torch.bfloat16)
    # K1 at the default path's three geometries, then at the region path's
    # new ones (160x160 C16/E16/P8 and C8/E16/P8 residual, 80x80 C16/E64,
    # 40x40 C16/E96 -> P16 and -> P32); K3 at its four
    k1_blocks = [(ir.blobs[r.start], net._fused_params[r.start][0])
                 for r in runs]
    k3_blocks = []
    for r in rruns:
        for b, bp in zip(r.blocks, rnet._fused_params[r.start]):
            if b.down:
                k3_blocks.append((b.start, ir.blobs[b.start], bp))
            elif b.start in (1, 4, 12, 25, 35):
                k1_blocks.append((ir.blobs[b.start], bp))
    for blob, bp in k1_blocks:
        for dt in dtypes:
            x = rand((BATCH, blob.h, blob.w, blob.c), dt)
            errs["K1"] = max(errs["K1"], check_kernel(
                f"K1 block {blob.h}x{blob.w} C{blob.c} E{bp.w1.shape[1]} "
                f"P{bp.w2.shape[1]}", bf.fused_block(x, bp),
                bf.block_plain(x, bp)))
    for start, blob, bp in k3_blocks:
        for dt in dtypes:
            x = rand((BATCH, blob.h, blob.w, blob.c), dt)
            errs["K3"] = max(errs["K3"], check_kernel(
                f"K3 block {start} {blob.h}x{blob.w} C{blob.c} "
                f"E{bp.w1.shape[1]} -> {blob.h // 2}x{blob.w // 2} "
                f"P{bp.w2.shape[1]}", bf.fused_down_block(x, bp),
                bf.block_down_plain(x, bp)))
    xu8 = torch.randint(0, 256, (BATCH, 320, 320, 3), generator=gen,
                        dtype=torch.uint8).to(dev)
    for dt in dtypes:
        for xs in (xu8, xu8[:1]):
            errs["K6"] = max(errs["K6"], check_kernel(
                f"K6 xl's stem u8 320x320x3 -> 160x160x{rc0.wm.shape[1]}, "
                f"{k6_plan(xs, rc0)}",
                c0.conv0_cs(xs, rc0, dt), c0.conv0_plain(xs, rc0, dt)))
    # K6 on seeded stems: F 8, 16 and 32 leaky (the compiled instances), F
    # 20 and F 16 relu (the generic one), at 320x320, 416x416 and 322x322
    # (rows not 16-byte aligned: the word copy)
    srng = np.random.RandomState(SEED)
    stems = [c0.conv0_params_from(*(torch.from_numpy(a).to(dev) for a in (
        srng.randn(f, 3, 3, 3).astype(np.float32) * 0.02,
        srng.uniform(0.5, 2.0, f).astype(np.float32),
        srng.randn(f).astype(np.float32))), act)
        for f, act in K6_STEMS]
    for size in K6_SIZES:
        xs = torch.randint(0, 256, (BATCH, size, size, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
        for cp in stems:
            for dt in dtypes:
                errs["K6"] = max(errs["K6"], check_kernel(
                    f"K6 stem u8 {size}x{size}x3 -> {size // 2}x{size // 2}"
                    f"x{cp.wm.shape[1]} act {cp.act}, {k6_plan(xs, cp)}",
                    c0.conv0_cs(xs, cp, dt), c0.conv0_plain(xs, cp, dt)))
        del xs
    # K7 at 10x10 and 13x13 at batch 64 (a cluster of two CTAs an image),
    # at the first batch that takes one CTA an image, and at batch 1; xl's
    # two chains at 96x96 at the first two batches
    hb, hb416 = ir.blobs[hrun.start], r416.ir.blobs[hrun416.start]
    k7_cases = [(hrun, hps, (BATCH, solo, 1)),
                (hrun416, hps416, (BATCH, solo, 1))] + [
        (r, r96._head_params[r.start], (BATCH, solo))
        for r in r96._head_runs]
    for run, hp, batches in k7_cases:
        c_in = hp.stages[0].w.shape[0]
        for nb in batches:
            p = hf.plan(hp, nb, sms)
            for dt in dtypes:
                x = rand((nb, hp.h, hp.w, c_in), dt)
                errs["K7"] = max(errs["K7"], check_kernel(
                    f"K7 head chain {run.start}-{run.end} {hp.h}x{hp.w}x"
                    f"{c_in}, {p.cluster} CTA(s) an image, {p.smem} B "
                    f"shared, {p.scratch * 4} B scratch an image",
                    hf.apply_head_run(x, run, hp), hf.head_plain(x, hp)))
    # K4 at the cascade path's 7 groups, K5 at the mega path's run, each
    # with the tile the wrapper picks
    for g, bps in cgroups:
        blob = ir.blobs[g[0].start]
        tile = bf.check_chain_fits(blob.h, blob.w, bps)
        for dt in dtypes:
            x = rand((BATCH, blob.h, blob.w, blob.c), dt)
            errs["K4"] = max(errs["K4"], check_kernel(
                f"K4 group {[b.start for b in g]} {blob.h}x{blob.w} "
                f"C{blob.c} -> P{bps[-1].w2.shape[1]} tile {tile}",
                bf.fused_cascade(x, bps), bf.chain_plain(x, bps)))
    # K5 at the cluster the wrapper picks at this batch, then at the other
    mblob = ir.blobs[84]
    mcluster = bf.mega_cluster(mblob.h, BATCH, _build.sm_count(dev))
    for dt in dtypes:
        x = rand((BATCH, mblob.h, mblob.w, mblob.c), dt)
        want = bf.chain_plain(x, mbps)
        for cl in (mcluster, 3 - mcluster):
            errs["K5"] = max(errs["K5"], check_kernel(
                f"K5 run 84-108 {mblob.h}x{mblob.w} C{mblob.c} 5 blocks, "
                f"{cl} CTA(s) an image, tile "
                f"{bf.check_chain_fits(mblob.h, mblob.w, mbps, True, cluster=cl)}",
                bf.fused_mega(x, mbps) if cl == mcluster
                else bf.launch_mega(x, mbps, cl), want))
    # K2 at K on either side of its 32-anchor blocks, fast mode's and
    # parity mode's largest, batch 1 and 64, on three candidate sets: bit
    # for bit against the plain version on the card and on the CPU
    nms_sets = {"candidates": nms_candidates, "chains": nms_chains,
                "one class": lambda n, k, seed: (
                    *nms_candidates(n, k, seed)[:2],
                    np.zeros((n, k), np.int32))}
    for k in NMS_CHECK_KS:
        for nb in (1, BATCH):
            for set_name, make in nms_sets.items():
                cand = make(nb, k, seed=k)
                tb, ts, tc = (torch.from_numpy(a).to(dev) for a in cand)
                kept = []
                for kind in ("min", "union"):
                    got = knms.nms_keep_mask(tb, ts, tc, threshold=0.5,
                                             iou_kind=kind)
                    want = knms.keep_mask_plain(tb, ts, tc, 0.5, kind)
                    want_cpu = knms.keep_mask_plain(
                        *(torch.from_numpy(a) for a in cand), 0.5, kind)
                    same = torch.equal(got, want) and \
                        torch.equal(got.cpu(), want_cpu)
                    errs["K2"] = max(errs["K2"], (
                        got.float() - want.float()).abs().max().item())
                    kept.append(f"{kind} kept {int(got.sum())}, mismatches "
                                f"{int((got != want).sum())}/"
                                f"{int((got.cpu() != want_cpu).sum())}")
                    if not same:
                        raise AssertionError(
                            f"K2 keep mask differs from plain: K={k} batch "
                            f"{nb} {set_name} {kind}")
                log(f"[3] K2 nms K={k} batch {nb} {set_name} "
                    f"({int((ts > 0).sum())} live): " + "; ".join(kept)
                    + " (card/CPU) ok")
    # past the candidates K2 stages in shared memory (a parity-mode K at
    # larger inputs), against the plain version on the card
    tb, ts, tc = (torch.from_numpy(a).to(dev)
                  for a in nms_candidates(2, NMS_LARGE_K, seed=1))
    for kind in ("min", "union"):
        got = knms.nms_keep_mask(tb, ts, tc, threshold=0.5, iou_kind=kind)
        want = knms.keep_mask_plain(tb, ts, tc, 0.5, kind)
        log(f"[3] K2 nms K={NMS_LARGE_K} batch 2 candidates iou={kind}: "
            f"kept {int(got.sum())}, mismatches {int((got != want).sum())}")
        if not torch.equal(got, want):
            raise AssertionError("K2 keep mask differs from plain")

    # 4. every path, each with its launch counts read around the call
    rng = np.random.RandomState(SEED)
    frames = np.concatenate([pt.bmp_load(BMP)[None], rng.randint(
        0, 256, (BATCH - 1, 320, 320, 3), dtype=np.uint8)])
    wide = rng.randint(0, 256, (448, 640, 3), dtype=np.uint8)
    frames416 = rng.randint(0, 256, (8, 416, 416, 3), dtype=np.uint8)
    main_counts = {}
    for tag, n, cn, fr in [(t, nets[t], cpus[t], frames) for t in nets] + [
            ("region416", r416, r416cpu, frames416)]:
        want = WANT_COUNTS[tag.replace("416", "")]
        # the first detect of a size builds its bucket: WARMUP_RUNS eager
        # runs and the capture go through the wrappers, then it replays
        built = WARMUP_RUNS + 1
        t0 = time.perf_counter()
        dets, counts = counted(counters, lambda: n.detect(fr))
        log(f"[4] {tag} fast detect batch {len(fr)} at {fr.shape[2]}x"
            f"{fr.shape[1]}, its bucket built in the call "
            f"({time.perf_counter() - t0:.2f} s): {sum(map(len, dets))} "
            f"detections ({len(dets[0])} on the first); launches "
            + " ".join(f"{k} {v}" for k, v in counts.items()))
        if counts["K2"] != built or any(counts[k] != v * built
                                        for k, v in want.items()):
            raise AssertionError(f"the {tag} path did not run its kernels")
        check_dets(tag, dets)
        main_counts[tag] = counts
        check_replay(tag, n, counters, fr, dets)
        d640, counts = counted(counters, lambda: n.detect(wide))
        log(f"[4] {tag} fast detect 640x448, its bucket built in the call: "
            f"{len(d640)} detections, launches "
            + " ".join(f"{k} {v}" for k, v in counts.items()))
        if any(counts[k] != v * built for k, v in want.items()) \
                or not all(0 < d.score <= 1 and np.isfinite(d[2:]).all()
                           for d in d640):
            raise AssertionError(f"{tag} 640x448 detect failed")
        check_replay(tag, n, counters, wide[None], [d640])
        check_against_cpu(tag, n, cn, fr, dets)

    # 5. parity mode, card against CPU; the card's detect replays a bucket
    # per K as parity mode grows it
    few = frames[:4]
    pnet = pt.load(CFG, wbytes, mode="parity", device="cuda")
    pg = pnet.detect(few)
    pc = pt.load(CFG, wbytes, mode="parity", device="cpu").detect(few)
    pks = sorted(k[3] for k in pnet._pipelines)
    pe = eager_detect(pnet, few)
    worst, flips = pair_parity(pg, pc, "the CPU")
    log(f"[5] parity card vs CPU: {sum(map(len, pg))} detections equal "
        f"(class, integer box), max |score diff| {worst:.2e}, integer "
        f"flips within {PARITY_BOX_NOISE} px: {flips}; buckets replayed at "
        f"K {pks}; bit for bit with the eager card path: {pg == pe}")

    # 9, its parts that count kernels by torch.profiler: detect_stream on
    # every path, then the HTTP server on the region Net.  They run here,
    # before the timings: late in a run, after the timing phases' traces,
    # torch.profiler dropped the first device events of some traces (an
    # upload and a replay's first kernels, or two whole replays), which it
    # did not in phase 4 or in a process of its own.
    stream_checks(nets, frames, counters)
    serve_phase(pt, rnet, frames, counters)

    # 11, its checks: YOLOv8n at 640x640, K2 in union IoU, the segments,
    # the float32 knobs and convert-v8 (counted by torch.profiler, so here,
    # before the timings' traces); its timings run last
    v8 = v8_phase(pt, counters, wbytes, frames, pnet)

    # 12, its checks: int8 mode (counted by torch.profiler, so here, before
    # the timings' traces); its detect_device timings run last
    i8 = int8_phase(pt, counters, wbytes, frames, v8)
    # 12, conv-1 in int8 (FFCNN_CONV0_INT8=1), its checks likewise
    c0q = conv0q_phase(pt, counters, wbytes, frames)
    # 14, its checks: multi-device over slots of the card (counted by
    # torch.profiler, so here, before the timings' traces); its timings
    # run last
    p14 = parallel_phase(pt, rnet, pnet, wbytes, frames, counters)

    # 6. timings (device time by CUDA events), bf16 as on the main paths
    bf16 = torch.bfloat16
    x_runs = {r.start: rand((BATCH,) + ir.blobs[r.start].nhwc, bf16)
              for r in runs}

    def k1_default(kernel):
        for r in runs:
            x = x_runs[r.start]
            for bp in net._fused_params[r.start]:
                x = bf.fused_block(x, bp) if kernel else bf.block_plain(x, bp)

    (k1_ms, k1_ms2), (k1_pms, k1_pms2) = turns(lambda: k1_default(True),
                                               lambda: k1_default(False))
    log(f"[6] K1 the default path's 13 blocks bf16 batch {BATCH}: kernel "
        f"{k1_ms:.4f} / {k1_ms2:.4f} ms, plain {k1_pms:.4f} / "
        f"{k1_pms2:.4f} ms")

    # the region path's blocks, each on its own input at its own shape
    rblocks = [(b, bp, rand((BATCH,) + ir.blobs[b.start].nhwc, bf16))
               for r in rruns
               for b, bp in zip(r.blocks, rnet._fused_params[r.start])]

    def region_blocks(down, kernel):
        for b, bp, x in rblocks:
            if b.down == down:
                if down:
                    (bf.fused_down_block if kernel
                     else bf.block_down_plain)(x, bp)
                else:
                    (bf.fused_block if kernel else bf.block_plain)(x, bp)

    # K1 and K3 by geometry: one block of each of the region path's
    # geometries (the default path's three are among them)
    geoms = {}
    for b, bp, x in rblocks:
        blob = ir.blobs[b.start]
        geoms.setdefault((b.down, blob.h, blob.w, blob.c, bp.w1.shape[1],
                          bp.w2.shape[1], b.residual), []).append((b, bp, x))
    for (down, h, w, c, e, p, res), blocks in geoms.items():
        _, bp, x = blocks[0]
        ms = cuda_ms(lambda: (bf.fused_down_block if down
                              else bf.fused_block)(x, bp))
        pms = cuda_ms(lambda: (bf.block_down_plain if down
                               else bf.block_plain)(x, bp))
        s = 2 if down else 1
        # expand over the input map, dw and project over the output map
        flop = 2 * BATCH * e * (h * w * c + h * w // (s * s) * (9 + p)) / 1e9
        log(f"[6] {'K3' if down else 'K1'} {h}x{w} C{c} E{e} P{p}"
            f"{' residual' if res else ''}, {len(blocks)} block(s) "
            f"{[b.start for b, _, _ in blocks]}, bf16 batch {BATCH}: "
            f"{ms * 1e3:.1f} us a block ({flop / ms:.1f} TFLOP/s useful), "
            f"plain {pms * 1e3:.1f} us")
    (rk1_ms, rk1_ms2), (rk1_pms, rk1_pms2) = turns(
        lambda: region_blocks(False, True), lambda: region_blocks(False,
                                                                  False))
    log(f"[6] K1 the region path's 20 blocks bf16 batch {BATCH}: kernel "
        f"{rk1_ms:.4f} / {rk1_ms2:.4f} ms, plain {rk1_pms:.4f} / "
        f"{rk1_pms2:.4f} ms")
    (k3_ms, k3_ms2), (k3_pms, k3_pms2) = turns(
        lambda: region_blocks(True, True), lambda: region_blocks(True, False))
    log(f"[6] K3 all 4 stride-2 blocks bf16 batch {BATCH}: kernel "
        f"{k3_ms:.4f} / {k3_ms2:.4f} ms, plain {k3_pms:.4f} / "
        f"{k3_pms2:.4f} ms")
    sn = stem_nms_times(rc0, dev)
    # K7 at 10x10 and 13x13, batch 64 and 256, against its plain version
    # and against its yardstick: the same five layers as the default path
    # runs them, five cuDNN convs (ops.conv.conv2d_fused, TF32 on the
    # bf16-exact values as in fast mode)
    from ffcnn_tpu_torch.ops.conv import conv2d_fused

    def cudnn_chain(x, n_, run):
        for li in range(run.start, run.end + 1):
            l, p = n_.ir.layers[li], n_.params[li]
            x = conv2d_fused(x, p["weights"], p["scale"], p["bias"],
                             stride=l.stride, pad=l.pad, groups=l.groups,
                             act=l.activation)
        return x

    k7 = {}
    for n_, run, hp in ((rnet, hrun, hps), (r416, hrun416, hps416)):
        for nb in (BATCH, 256):
            xh = rand((nb, hp.h, hp.w, hp.stages[0].w.shape[0]), bf16)
            (ms, ms2), (pms, pms2) = turns(
                lambda: hf.apply_head_run(xh, run, hp),
                lambda: hf.head_plain(xh, hp))
            torch.backends.cudnn.allow_tf32 = True
            cms = cuda_ms(lambda: cudnn_chain(xh, n_, run))
            torch.backends.cudnn.allow_tf32 = False
            k7[hp.h, nb] = (ms, pms, cms)
            log(f"[6] K7 head chain {hp.h}x{hp.w}x192 bf16 batch {nb}, "
                f"{hf.plan(hp, nb, sms).cluster} CTA(s) an image: kernel "
                f"{ms:.4f} / {ms2:.4f} ms, plain {pms:.4f} / {pms2:.4f} "
                f"ms, cuDNN chain {cms:.4f} ms")

    def k1_chain(x, bps):
        for bp in bps:
            x = bf.fused_block(x, bp)
        return x

    # K4: each group against the K1 launches it replaces (bf16 boundaries
    # between them) and against plain; then all 7 groups in turns
    xg = [rand((BATCH,) + ir.blobs[g[0].start].nhwc, bf16)
          for g, _ in cgroups]
    for (g, bps), x in zip(cgroups, xg):
        blob = ir.blobs[g[0].start]
        tile = bf.check_chain_fits(blob.h, blob.w, bps)
        ctas = BATCH * -(-blob.h // tile[0]) * -(-blob.w // tile[1])
        ms = cuda_ms(lambda: bf.fused_cascade(x, bps))
        k1ms = cuda_ms(lambda: k1_chain(x, bps))
        pms = cuda_ms(lambda: bf.chain_plain(x, bps), iters=5)
        log(f"[6] K4 group {[b.start for b in g]} {blob.h}x{blob.w} tile "
            f"{tile}, {ctas} CTAs, halo work "
            f"{halo_work(bf, blob.h, blob.w, bps, tile):.2f}x, bf16 batch "
            f"{BATCH}: kernel {ms:.4f} ms "
            f"({ms * 1e3 / len(bps):.1f} us a block), K1 x{len(bps)} "
            f"{k1ms:.4f} ms ({k1ms * 1e3 / len(bps):.1f} us a block), "
            f"ratio {ms / k1ms:.2f}, plain {pms:.4f} ms")

    def k4_all(kernel):
        for (_, bps), x in zip(cgroups, xg):
            (bf.fused_cascade if kernel else bf.chain_plain)(x, bps)
    (k4_ms, k4_ms2), (k4_pms, k4_pms2) = turns(lambda: k4_all(True),
                                               lambda: k4_all(False), 10)
    k4_k1 = cuda_ms(lambda: [k1_chain(x, bps)
                             for (_, bps), x in zip(cgroups, xg)], 10)
    log(f"[6] K4 all 7 groups bf16 batch {BATCH}: kernel {k4_ms:.4f} / "
        f"{k4_ms2:.4f} ms, the 18 K1 launches they replace {k4_k1:.4f} ms "
        f"(ratio {k4_ms / k4_k1:.2f}), plain {k4_pms:.4f} / {k4_pms2:.4f} "
        f"ms")

    # K5 at one CTA an image and at a cluster of two, against its five K1
    # launches; the wrapper picks the cluster by the batch and the card's
    # SMs (2n <= SMs), so batch 66, 67 and 128 read either side of its cut.
    # The size it picks is timed through fused_mega, the other directly.
    k5 = {}
    for nb in (BATCH, 66, 67, 128, 256):
        x = rand((nb, mblob.h, mblob.w, mblob.c), bf16)
        k1ms = cuda_ms(lambda: k1_chain(x, mbps))
        for cl in (1, 2):
            picked = cl == bf.mega_cluster(mblob.h, nb, _build.sm_count(dev))
            (ms, ms2), (pms, pms2) = turns(
                (lambda: bf.fused_mega(x, mbps)) if picked
                else (lambda: bf.launch_mega(x, mbps, cl)),
                lambda: bf.chain_plain(x, mbps), 10)
            tile = bf.check_chain_fits(mblob.h, mblob.w, mbps, True,
                                       cluster=cl)
            if picked:
                k5[nb] = (ms, pms)
            log(f"[6] K5 run 84-108 10x10 C96 E448 bf16 batch {nb}, "
                f"cluster {cl}{' (the wrapper picks it)' if picked else ''}"
                f", tile {tile}, {nb * cl} CTAs: kernel {ms:.4f} / "
                f"{ms2:.4f} ms ({ms * 1e3 / len(mbps):.1f} us a block), "
                f"its 5 K1 launches {k1ms:.4f} ms, ratio {ms / k1ms:.2f}, "
                f"plain {pms:.4f} / {pms2:.4f} ms")

    # the whole fast forward: unfused cuDNN chain, the default fused runs,
    # the region, cascade and mega configurations, each as its Net runs it
    # on 320x320 uint8 frames (folded stem)
    xb = torch.from_numpy(frames).to(dev)
    folded = net._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)[0]
    torch.backends.cudnn.allow_tf32 = True   # fast mode: exact on bf16 values

    def fwd(kind):
        if kind == "unfused":
            return forward_features(ir, folded, xb, input_dtype=bf16)
        n = nets["default" if kind == "fused" else kind]
        p, c0p = n._folded_params(pt.DEFAULT_MEAN, pt.DEFAULT_NORM)
        return forward_features(
            ir, p, xb, input_dtype=bf16, fused_runs=n._fused_runs,
            fused_params=n._fused_params, fused_groups=n._fused_groups,
            mega_runs=n._mega_runs, fused_mid_dtype=n._mid_dtype,
            head_runs=n._head_runs, head_params=n._head_params,
            conv0_pallas=c0p is not None, conv0_params=c0p)
    kinds = ("unfused", "fused", "region", "cascade", "mega")
    fwd_ms = {k: [] for k in kinds}
    for kind in kinds + kinds[::-1]:
        fwd_ms[kind].append(cuda_ms(lambda: fwd(kind), 10))
    log(f"[6] fast forward batch {BATCH} (two turns): " + ", ".join(
        f"{k} {a:.3f} / {b:.3f} ms" for k, (a, b) in fwd_ms.items()))

    from torch.profiler import ProfilerActivity, profile
    for tag, n in nets.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            n.detect_device(xb)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=12,
                                          max_name_column_width=48)
        log(f"[6] profile of one {tag} fast detect_device, batch {BATCH}:")
        for line in table.splitlines():
            log("    " + line)

    eager_bucket_times(nets, frames, dev)
    dispatch_times(nets, frames, dev)
    torch.cuda.synchronize()
    log(f"[6] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
        f"reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB")

    # 7. the block A/B bench: the kernel pass counted (one K8 launch a
    # case, one K9 launch a stride-1 case), then the report, then float32
    cases = bb.cases_configs(dev) + bb.cases_xl(dev)
    outs, bench_counts = counted(counters, lambda: bb.drive(cases))
    want8, want9 = len(cases), sum(c.k9 is not None for c in cases)
    log(f"[7] block bench kernel pass, {len(cases)} cases: launches "
        + " ".join(f"{k} {v}" for k, v in bench_counts.items()))
    if bench_counts["K8"] != want8 or bench_counts["K9"] != want9 or any(
            v for k, v in bench_counts.items() if k not in ("K8", "K9")):
        raise AssertionError("the block bench did not run K8 and K9 once "
                             "a case")
    rows = bb.report(cases, outs, log=lambda line: log("[7] " + line))
    for r in rows:
        for k in ("8", "9"):
            if "err" + k not in r:
                continue
            tol = MBCONV_TOL["bfloat16"] * r["range" + k]
            errs["K" + k] = max(errs["K" + k], r["err" + k])
            if not (r["finite"] and r["err" + k] <= tol):
                raise AssertionError(f"K{k} {r['name']} bf16 disagrees with "
                                     f"its plain version: {r['err' + k]:.3e}"
                                     f" > {tol:.3e}")
    log(f"[7] K8 and K9 against their plain versions in bf16 within "
        f"{MBCONV_TOL['bfloat16']:.4g} of the range: ok")
    for c in cases:
        f = dataclasses.replace(
            c, x=c.x.float(), res=None if c.res is None else c.res.float(),
            x_cs=None if c.x_cs is None else c.x_cs.float(),
            res_cs=None if c.res_cs is None else c.res_cs.float())
        errs["K8"] = max(errs["K8"], check_kernel(
            f"K8 {c.name}", bb.run_k8(f), bb.plain_k8(f), MBCONV_TOL, 7))
        if c.k9 is not None:
            n, h, w, _ = c.x.shape
            errs["K9"] = max(errs["K9"], check_kernel(
                f"K9 {c.name}", k9.cs_to_nhwc(bb.run_k9(f), n, h, w),
                k9.cs_to_nhwc(bb.plain_k9(f), n, h, w), MBCONV_TOL, 7))
    part_a = [(c, r) for c, r in zip(cases, rows) if c.part == "a"]
    bench = {}
    for k, rs in (("8", part_a), ("9", [(c, r) for c, r in part_a
                                        if "ms9" in r])):
        bench[k] = dict(
            ms=sum(r["ms" + k] for _, r in rs),
            plain_ms=sum(r["ms_plain" + k] for _, r in rs),
            chain_ms=sum(r["ms_chain"] for _, r in rs),
            work=sum((c.work8() if k == "8" else c.work9()
                      for c, _ in rs), bb.Work()))
        log(f"[7] K{k} the tool's {len(rs)} configs, bf16 batch 256: kernel "
            f"{bench[k]['ms']:.4f} ms (bound {bench[k]['work'].bound()[0]:.4f}"
            f" ms), cuDNN chain {bench[k]['chain_ms']:.4f} ms, plain "
            f"{bench[k]['plain_ms']:.4f} ms")
    # K8 and K9 alone: each config's launches in a CUDA graph, its replays
    # timed
    for k, run in (("8", bb.run_k8), ("9", bb.run_k9)):
        alone = [bb.graph_launch_ms(lambda: run(c)) for c, _ in part_a
                 if k == "8" or c.k9 is not None]
        bench[k]["alone"] = sum(alone)
        log(f"[7] K{k} the tool's {len(alone)} configs alone (CUDA-graph "
            f"replays): {bench[k]['alone']:.4f} ms (" + ", ".join(
                f"{v:.4f}" for v in alone) + ")")
    part_b = [r for c, r in zip(cases, rows) if c.part == "b"]
    # the cuDNN chain at the region path's blocks: K1's and K3's yardstick
    chain_b = {s: sum(r["ms_chain"] for r in part_b if r["stride"] == s)
               for s in (1, 2)}
    log(f"[7] the cuDNN chain at xl's region blocks, bf16 batch 64: the 20 "
        f"stride-1 blocks {chain_b[1]:.4f} ms, the 4 stride-2 blocks "
        f"{chain_b[2]:.4f} ms")
    for k in ("8", "9"):
        rs = [r for r in part_b if "ms" + k in r]
        log(f"[7] K{k} xl's {len(rs)} region blocks, bf16 batch 64: kernel "
            f"{sum(r['ms' + k] for r in rs):.4f} ms, K1/K3 "
            f"{sum(r['ms_block'] for r in rs):.4f} ms, cuDNN chain "
            f"{sum(r['ms_chain'] for r in rs):.4f} ms, plain "
            f"{sum(r['ms_plain' + k] for r in rs):.4f} ms")
    # K9 alone beside K1 alone at xl's stride-1 blocks
    xl9 = [(bb.graph_launch_ms(lambda: bb.run_k9(c)),
            bb.graph_launch_ms(lambda: bb.run_block(c)))
           for c in cases if c.part == "b" and c.k9 is not None]
    bench["9"]["xl_alone"] = sum(v for v, _ in xl9)
    bench["9"]["xl_k1_alone"] = sum(v for _, v in xl9)
    log(f"[7] K9 xl's {len(xl9)} stride-1 region blocks alone (CUDA-graph "
        f"replays): {bench['9']['xl_alone']:.4f} ms, K1 alone "
        f"{bench['9']['xl_k1_alone']:.4f} ms")

    # the work of every kernel's timed call, for its bound
    def blocks_work(down):
        return sum((chain_work(bb, BATCH, ir.blobs[b.start].h,
                               ir.blobs[b.start].w, [bp], 2 if down else 1)
                    for b, bp, _ in rblocks if b.down == down), bb.Work())
    nk = NMS_KS[0]
    f0 = rc0.wm.shape[1]
    works = {
        "K1": blocks_work(False), "K3": blocks_work(True),
        # boxes, scores, classes in and the keep mask out; about 12 float32
        # operations for each pair's IoU test
        **{("K2", k): bb.Work(BATCH * k * 28,
                              f32_flop=12 * BATCH * k * (k - 1) / 2)
           for k in NMS_KS},
        # uint8 in, bf16 out, 27 float32 taps a channel
        "K6": bb.Work(BATCH * 320 * 320 * 3 + 2 * BATCH * 160 * 160 * f0
                      + 4 * 29 * f0,
                      f32_flop=2 * 27 * f0 * BATCH * 160 * 160),
        "K7": head_work(bb, BATCH, hps, hb.c),
        "K4": sum((chain_work(bb, BATCH, ir.blobs[g[0].start].h,
                              ir.blobs[g[0].start].w, bps)
                   for g, bps in cgroups), bb.Work()),
        "K5": chain_work(bb, BATCH, mblob.h, mblob.w, mbps)}

    def entry(name, key, source, replaces, launches, ms, plain_ms, work,
              **more):
        return kernel_entry(name, source, f"ffcnn_tpu/kernels/{replaces}",
                            launches, errs[key], ms, plain_ms, work, **more)

    launches = main_counts["region"]
    kernels = [
        entry("block_fused_s1", "K1", "block_fused.cu", "block_fused.py:206",
              launches["K1"], rk1_ms, rk1_pms, works["K1"],
              cudnn_chain_ms=chain_b[1]),
        entry("nms_keep_mask", "K2", "nms.cu", "nms_pallas.py:26",
              launches["K2"], sn["K2"][nk][0], sn["K2"][nk][1],
              works["K2", nk], kernel_alone_ms=sn["K2"][nk][2],
              ms_1500=sn["K2"][1500][0], plain_ms_1500=sn["K2"][1500][1],
              kernel_alone_ms_1500=sn["K2"][1500][2],
              bound_ms_1500=works["K2", 1500].bound()[0]),
        entry("block_fused_s2", "K3", "block_down.cu", "block_fused.py:299",
              launches["K3"], k3_ms, k3_pms, works["K3"],
              cudnn_chain_ms=chain_b[2]),
        entry("conv0_fused", "K6", "conv0_fused.cu", "conv0_fused.py:37",
              launches["K6"], sn["K6"]["ms"], sn["K6"]["plain_ms"],
              works["K6"], kernel_alone_ms=sn["K6"]["alone"]),
        entry("head_fused", "K7", "head_fused.cu", "head_fused.py:119",
              launches["K7"], k7[hb.h, BATCH][0], k7[hb.h, BATCH][1],
              works["K7"], cudnn_chain_ms=k7[hb.h, BATCH][2],
              ms_416=k7[hb416.h, BATCH][0],
              cluster=hf.plan(hps, BATCH, sms).cluster),
        entry("block_cascade", "K4", "block_cascade.cu",
              "block_fused.py:374", main_counts["cascade"]["K4"], k4_ms,
              k4_pms, works["K4"]),
        entry("block_mega", "K5", "block_mega.cu", "block_fused.py:709",
              main_counts["mega"]["K5"], k5[BATCH][0], k5[BATCH][1],
              works["K5"]),
        entry("mbconv", "K8", "mbconv.cu", "block_pallas.py:47",
              bench_counts["K8"], bench["8"]["ms"], bench["8"]["plain_ms"],
              bench["8"]["work"], cudnn_chain_ms=bench["8"]["chain_ms"],
              kernel_alone_ms=bench["8"]["alone"]),
        entry("mbconv_cs", "K9", "mbconv_cs.cu", "csblock_pallas.py:59",
              bench_counts["K9"], bench["9"]["ms"], bench["9"]["plain_ms"],
              bench["9"]["work"], cudnn_chain_ms=bench["9"]["chain_ms"],
              kernel_alone_ms=bench["9"]["alone"],
              xl_alone_ms=bench["9"]["xl_alone"],
              xl_k1_alone_ms=bench["9"]["xl_k1_alone"]),
    ]

    # 8. the probe kernels P1-P5 behind the ports of their probes
    kernels += probe_phase(dev, counters)

    # 9, the rest: the region bucket's memory (which resets the peak
    # statistic phase 6 reads) and sync-freedom
    graph_checks(rnet, frames)

    # 10. the command line and the bench, through their entry functions
    t0 = time.perf_counter()
    cli_phase(pt, frames)
    scope_cost({t: nets[t] for t in ("default", "region")})
    copy_rate(dev)
    bench_phase()
    log(f"[10] phase 10 took {time.perf_counter() - t0:.1f} s")

    # 15. the BMP codec on the card's host, and cli batch through it
    codec_phase(pt, wbytes, counters)

    # 11, its timings: v8n's detect_device; K2's union times (taken in its
    # checks) join K2's entry
    v8_times(v8, dev)
    next(k for k in kernels if k["name"] == "nms_keep_mask").update(
        v8["k2"])

    # 12, its timings and entries: the int8 conv (over xl's unfused int8
    # convs at batch 64, each timed alone), and K1, K3 and K4 with the
    # plan's int8 boundaries
    int8_times(i8, frames, dev)
    kernels.append(int8_entry(i8))
    kernels.append(conv0q_times(c0q, rnet, frames, dev))
    for name, key in (("block_fused_s1", "K1"), ("block_fused_s2", "K3"),
                      ("block_cascade", "K4")):
        ms, ms16, pms, (bound, by) = i8["blk"][key]
        next(k for k in kernels if k["name"] == name).update(
            int8_ms=ms, int8_bf16_boundaries_ms=ms16, int8_plain_ms=pms,
            int8_bound_ms=bound, int8_bound_by=by,
            int8_launches=sum(c[key] for c in i8["counts"].values()))
    # 13. export: four artifacts, loaded here and in a fresh process
    export_phase(pt, {"region": rnet, "parity": pnet,
                      "int8": i8["nets"]["default"]}, frames, dev, wbytes,
                 {"region": cpus["region"],
                  "parity": pt.load(CFG, wbytes, mode="parity",
                                    device="cpu")})
    # 14, its timings
    parallel_times(pt, rnet, pnet, p14, frames, dev)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
