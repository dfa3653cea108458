"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

What it does, failing (exit code != 0, no result line) at the first phase
that goes wrong:

1. prints the card's ``nvidia-smi --query-gpu=name,power.limit`` line;
2. builds the CUDA kernels from ``video_features_tpu_torch/kernels/csrc``
   and prints each kernel's registers, shared memory and spills from the
   compiler's ``-Xptxas -v`` report; then prints the card's practical
   bf16 and read rates (``telemetry/roofline.py measure_peak``) beside the
   peak registry's entry for the card;
3. holds level (max abs error 1e-5), proj (1e-4) and packed (1e-5) against
   their plain versions on small ragged cases, whose query counts fill no
   whole tile: 3 pairs on a 7x11 grid (Q = 231), odd level sizes, whole
   windows outside the plane, a pyramid that pools to 1x1 and 0x0, and NaN,
   +-inf and +-1e30 coords (NaN in the same places, :func:`max_abs_err`);
4. for each kernel, at the shapes its path gives it, holds the kernel
   against its plain PyTorch version on the card and times the kernel, the
   plain version and one library call of the same function
   (``F.grid_sample`` as the reference formulates the lookup, over the
   unpacked levels, plus ``torch.matmul`` for proj; no library call reads
   the packed layout); beside proj, ``torch.matmul`` of its shapes alone:
   - the i3d slice's shapes (one 64-frame stack of 240x320 frames resized
     to 256x341 and padded to 256x344: a 32x43 grid, Q = 64 * 1376 =
     88,064 queries): level (max abs error 1e-5), proj (1e-4), packed
     (1e-5);
   - the raft family's shapes (32 pairs of 240x320 frames: a 30x40 grid,
     Q = 32 * 1200 = 38,400 queries): packed (1e-5), and proj (1e-4) with
     convc1's weight and bias rounded to bfloat16 and upcast, as the
     family's bfloat16 default feeds it;
   pyramids from seeded random fmaps;
5. holds RAFT with the kernels (fused, unfused, packed) against RAFT with
   the plain gather lookup on a small input, float32 (flow atol 1e-3 px);
6. drives the i3d slice, ``ExtractI3D(...).extract_frames(...)`` with
   ``flow_type=raft``, both streams, 20 GRU iterations, float32, seeded
   random weights and one stack per RAFT forward, over 129 seeded synthetic
   240x320 frames (two 64-frame stacks), with every launch count set to 0
   just before and read just after: the fused lookup + convc1 kernel must
   have run 20 times per RAFT forward. Then the same with
   ``fuse_convc1=false``: the level kernel must have run 20 times per
   forward (one launch per call, all four levels), and the features must
   match the fused run's (atol 1e-2, the value tier). One profiled run of
   the fused path (device time by kernel, the card's busy share), and fused
   and unfused in turns (F U U F). Last, the fused extractor's RAFT switched
   to ``corr_lookup_impl=packed``, counts set to 0 just before and read just
   after: the packed kernel 20 times per forward, proj and level none, the
   features within 1e-2 of the fused run's;
7. drives the raft family, ``ExtractRAFT(...).extract_frames(...)``, at the
   YAML defaults (``precision=bfloat16``, 20 iterations,
   ``corr_lookup_impl=null``) with ``batch_size=32``, over 65 seeded
   synthetic 240x320 frames (64 flows, two RAFT forwards), counts set to 0
   just before and read just after: proj 20 launches per forward, level and
   packed none; the flows ``(64, 2, 240, 320)`` and finite; the timestamps
   those of frames 0..64. Then the same with ``corr_lookup_impl=packed``:
   packed 20 launches per forward, proj none, and the flows within
   median 0.1 px and p99 1.0 px of the default path's (the JAX package's
   own bfloat16 bound: the fused kernel projects in float32, the packed
   path runs convc1 in bfloat16). Pairs/s of both in turns (D P P D), and
   one profiled run of the default path;
8. drives the pwc family, ``ExtractPWC(...).extract_frames(...)``, at the
   YAML defaults (``precision=bfloat16``) with ``batch_size=32``, over 65
   seeded synthetic 240x320 frames (64 flows, two PWC forwards): the flows
   ``(64, 2, 240, 320)`` and finite, the timestamps those of frames 0..64,
   no lookup kernel launched; then the same in ``float32``, the bfloat16
   flows within the JAX package's bfloat16 band of the float32 ones
   (cosine >= 0.98, max abs <= 2.0 px, ``telemetry/parity.py``). Pairs/s of
   both in turns (B F F B), one profiled run of the default path, with the
   device time of the cost volume and the warp read off profiler ranges;
9. drives I3D with PWC flow, ``ExtractI3D(...).extract_frames(...)`` at the
   i3d YAML defaults (``flow_type=pwc``, both streams, float32,
   ``flow_stack_batch=auto``) with ``clip_batch_size=2`` and
   ``resize=device``, over the slice's 129 frames (two 64-frame stacks at
   256x341, so PWC works at 256x384): features ``(2, 1024)`` per stream and
   finite, no lookup kernel launched; then ``precision=bfloat16``, its
   features within the head band of the float32 run's (cosine >= 0.99,
   max abs <= 0.5). Stacks/s of both in turns (F B B F), one profiled run
   of each (cost volume and warp ranges as above). Then ``flow_type=raft precision=bfloat16`` once,
   counts set to 0 just before and read just after: proj 20 launches per
   RAFT forward, its features in the same band against the slice's fused
   float32 run. Last, the plain cost volume alone (CUDA events) at the five
   decoder levels' shapes of one stack's 64 pairs, in float32 and
   bfloat16, its sum per stack and its share of the profiled run's device
   time;
10. drives R(2+1)D, ``ExtractR21D(...).extract_frames(...)`` at the r21d
   YAML defaults (``r2plus1d_18_16_kinetics``, stack = step = 16,
   ``clip_batch_size=8``, float32 with the float32 wire), over 257 seeded
   synthetic 240x320 frames through the port's ``R21DTransform`` (16 clips
   of 112x112 in two full groups): features ``(16, 512)`` and finite, the
   windows those of ``form_slices(257, 16, 16)``, no lookup kernel
   launched; then ``precision=bfloat16`` (the uint8 wire), its features
   within the head band of the float32 run's (cosine >= 0.99, max abs <=
   0.5); then ``ingest=yuv420`` once (float32): ``yuv420_packed_to_rgb`` on
   the card against its CPU result on frames packed by the port's numpy
   I420 encoder (max abs error 1e-4), and the features in the same band;
   then ``r2plus1d_34_8_ig65m_ft_kinetics`` once on 16 frames (2 clips of
   8): shape and finite values. Clips/s of the whole ``extract_frames``
   run of each dtype, the host transform's ms per frame, clips/s of the
   card's part (the transformed frames through the clip windows, the
   copy, the forward and back) in turns (F B B F), and one profiled
   ``extract_frames`` run of each dtype;
11. drives S3D, ``ExtractS3D(...).extract_frames(...)`` at the s3d YAML
   defaults (stack = step = 64, ``clip_batch_size=8``, float32), over 513
   seeded synthetic 240x320 frames at 25 fps through ``S3DTransform`` (8
   stacks of 224x224 in one full group): features ``(8, 1024)`` and
   finite, the windows those of ``form_slices(513, 64, 64)``, no lookup
   kernel launched; then ``precision=bfloat16``, within the head band.
   Stacks/s as for R(2+1)D;
12. drives ResNet, ``ExtractResNet(...).extract_frames(...)`` at the
   resnet YAML defaults (``resnet50``, ``batch_size=1``, float32) with
   ``resize=device``, over 32 seeded synthetic 240x320 frames; then
   ``batch_size=64`` in float32 and bfloat16 over 256 frames, then
   ``resize=host`` (PIL on the host), ``ingest=yuv420`` (I420 planes
   converted on the card) and ``resnet18`` once beside. Every run: the
   features ``(N, 2048)`` (``(N, 512)`` for resnet18) and finite, the
   timestamps those of frames 0..N-1, no lookup kernel launched (counts set
   to 0 just before and read just after). Bfloat16 within the head band
   of float32, batch 1 and ``resize=host`` within the value tier (max abs
   1e-2) of batch 64 with ``resize=device``, yuv420 against uint8 cosine
   >= 0.99. Frames/s of float32 and bfloat16 in turns (F B B F), FLOPs per
   frame (``torch.utils.flop_counter`` on meta tensors), one profiled run
   of each and of batch 1 (busy share, top device items, launches per
   batch);
13. drives CLIP the same way, ``ExtractCLIP`` at the clip YAML defaults
   (``ViT-B/32``, 512-d, bicubic to 224), with ``RN50`` (1024-d, the
   ModifiedResNet and its attention pool) once beside;
14. drives VGGish, ``ExtractVGGish(...).extract(path)`` on a seeded 600 s
   16 kHz mono WAV (625 examples, 600.015 s), at the vggish YAML defaults
   (``frontend=host``, float32, ``batch_size=32``), with
   ``frontend=device`` (the log-mel on the card: cuFFT and a float32
   matmul), and both in bfloat16; then a 60 s 44.1 kHz stereo WAV once
   (mono mix, ``resample_poly``). Every run: (N, 128) finite embeddings,
   no lookup kernel launched (counts set to 0 just before and read just
   after). The device frontend within 1e-3 of the host one in float32,
   the card's ``logmel_examples`` on the first batch within 1e-4 of the
   numpy frontend, bfloat16 within the head band of float32. Examples/s of
   each run and in turns, the host frontend's ms per example, FLOPs per
   example and the device TFLOP/s they imply, one profile of each float32
   frontend (busy share, top device items, launches per batch);
15. drives the parallel plane (every phase above already runs through
   ``DataParallelApply`` on a one-card mesh and a ``FeatureStream`` of
   depth 4) on two devices: two cards where the machine has them, else two
   replicas on ``cuda:0``. (a) The raft family in float32 with
   ``batch_size=32`` over 65 frames on the two devices: flows within 1e-3
   px of one device, proj 20 launches per forward on each replica (forward
   hooks), level and packed none. (b) r21d at its YAML defaults with
   ``cross_video_batching=true``: 6 seeded videos of 40, 56, ..., 120
   frames (27 clips) through ``extract_frames`` on 3 threads
   (:func:`feed_videos`): per-video features within 1e-4 of the unpacked
   run, groups [8, 8, 8, 3]. (c) CLIP ViT-B/32 with ``model_parallel=2``
   over a ``(data=1, model=2)`` mesh, 64 frames, float32,
   ``resize=device``: within 1e-4 of ``model_parallel=1``, each shard's
   ``in_proj_weight`` (1152, 768). (d) r21d ``extract_frames`` at stream
   depth 4 against 0: identical features, clips/s and the card's busy
   share of each. Rates of both sides of each in turns;
16. drives the multi-family run (:func:`multi_phase`) on the
   vendored ``tests/assets/v_synth_sample.mp4`` (320x240, 19.62 fps, 355
   frames): ``MultiExtractor`` over one shared decode with i3d two-stream
   ``flow_type=raft`` at its YAML defaults, r21d and vggish at theirs,
   resnet50 and ViT-B/32 at ``batch_size=64``, float32, seeded weights;
   vggish's rip is a seeded WAV writer (the sample has no audio track).
   Each family's outputs against its single-family run on the same
   extractors (max abs 1e-4), proj's launches equal in the shared and the
   single i3d run (counts set to 0 just before each and read just after),
   the frames the bus decoded below the private sources' sum; then two
   shared passes with ``cache=true`` into a fresh cache and fresh outputs:
   the second serves every family from the store with no frame decoded,
   no rip and no proj launch, bit-equal to the first. Shared and single
   runs in turns (S, singles, singles, S) and one profiled shared run;
17. drives the main path through the CLI with the run plane off and on
   (:func:`telemetry_phase`): ``cli.main`` on i3d two-stream
   ``flow_type=raft`` at the slice's widths (20 iterations, float32,
   ``flow_stack_batch=1``, ``clip_batch_size=2``, ``resize=device``,
   seeded weights) over the vendored sample decoded at 7.3 fps (132
   frames: two 64-frame stacks), once with every run-plane key off and
   once with ``telemetry=true trace=true health=true profile=true
   roofline=true parity=true profile_trace_dir=...``, counts set to 0 just
   before each and read just after; once more with those keys but no
   capture, so the capture's cost shows apart; and once with those keys
   over the sample and a copy of it ("repeat"), whose second dispatch at
   the same shape runs without the roofline's counting pass; every on run
   with ``history=true alerts=true`` too. Held: the
   features of every video equal bit for bit (max abs 0.0);
   proj 20 launches per stack in every run; the one ``_telemetry.jsonl`` span valid
   under the port's schema, ``done``, with ``decode``, ``h2d``, ``forward``
   and ``write`` all > 0; a final ``_heartbeat_*.json`` and a ``_run.json``
   whose topology names the card; one valid ``_health.jsonl`` record per
   output key with no NaN or Inf; a ``_trace.json`` that parses, with the
   required fields of every event and the load-bearing spans; the
   ``torch.profiler`` Chrome trace with the proj kernel among its device
   events; the profile summary printed; in each on run a ``_roofline.json``
   valid under the port's schema naming the card from the peak registry,
   its FLOPs at least the proj launches' declared operations at the
   slice's shapes, ``0 < mfu <= 1``, effective TFLOPS at most the peak and
   one of the four verdicts, and in the repeat run the one uncounted
   dispatch timed of two; ``_parity.jsonl`` records at the ``decode``,
   ``transform`` and ``head`` seams, each valid, and none at ``backbone``
   (as in JAX, the i3d path's RAFT flow stays on the card; the raft
   family's backbone seam is the certify phase's); the heartbeat's
   ``roofline`` and ``parity`` sections and the manifest's roofline
   filled; in each on run (:func:`check_alert_plane`) one
   ``_history_*.jsonl`` of ``vft.history_sample/1`` samples whose last is
   the final heartbeat's (its ``mfu`` the heartbeat's roofline MFU), the
   heartbeat's ``alerts`` section with no rule failure, both heartbeat
   hooks registered and none failed, and no firing record but
   ``mfu_regression``'s, which is printed as a finding, not failed. The
   walls, each stage's total, the roofline documents and the counting
   pass's cost (the capture_off window less the repeat run's);
18. drives the alerting on the main path (:func:`alerts_phase`): the same
   CLI over one 64-frame stack of the sample (4 fps) with ``telemetry
   trace roofline history alerts``, ``metrics_interval_s=0.3``,
   ``retry_attempts=1`` and ``inject=seed=0;sink.fsync=enospc@n1`` (an
   ENOSPC at the first feature write, after the stack's RAFT forward).
   Held: proj 20 launches; exactly one ``failure_spike`` record in the
   ``firing`` state, valid under ``alert.schema.json``; its bundle passes
   ``verify_incident``, holds the failure journal and a ``roofline.json``
   naming the card; the retained history ends with the failure; a later
   ``telemetry/alerts.py main([dir, "--window", "0.05"])`` resolves it and
   no alert is current after. Then the cost: the run plane without and
   with ``history=true alerts=true`` in turns (off, on, on, off) at
   ``metrics_interval_s=0.3`` and at the default, each run's features
   bit-equal to the first and proj 20 launches per stack, each on run held
   as in step 17, each off run without history or journal; then one
   evaluation of every rule over a clean on run's tree (``observe_root``
   and ``AlertEngine.evaluate``, what each heartbeat tick runs), the median
   of 20;
19. the fleet step (:func:`fleet_step`) over the telemetry and alerts
   phases' roots: ``fleet_report.aggregate`` finds every current host
   ``FINISHED``, i3d throughput from the spans and the roofline roll-up
   naming the card; ``build_prom_dump`` through ``prometheus_text``
   parses; ``stitch`` writes one trace with a lane per host trace and the
   ``video_attempt`` and ``forward`` spans the proj launches ran under; the
   run report (``telemetry/report.py``) renders the fault run, and its
   ``--fail-on-alert`` gate passes after the resolve;
20. certifies each bfloat16 default flip on the card
   (:func:`certify_phase`, ``telemetry/parity.py certify``): ``raft`` and
   ``pwc`` with ``--flip dtype=bf16`` over the vendored sample, reference
   arm float32 and candidate bfloat16 in one process; each verdict valid
   under the port's schema, every seam captured, ``decode`` and
   ``transform`` within their bands; PWC's verdict ``PASS``; RAFT's, whose
   ``PASS`` or ``FAIL`` rests on the random weight draw, held at
   ``backbone`` and ``head`` to its band's cosine and 1.5 times its max
   abs (:data:`DRAW_SPREAD`); the verdict, its first drifted seam and the
   per-seam ``max_abs`` and ``cos`` printed;
21. prints one JSON line each of the i3d slice's, the raft family's, the
   pwc family's, the i3d PWC phase's, the r21d, s3d, resnet, clip,
   vggish, parallel, multi, telemetry, alerts, fleet and certify phases'
   numbers, one of the alerting's numbers beside the card
   (:func:`alerts_plane_line`: history samples, transitions, the bundle's
   artifacts and bytes, one tick's evaluation, the walls), one of the
   kernels' numbers, and last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and needs no ffmpeg: the frames and the WAVs are
synthetic (the WAVs written with the stdlib ``wave`` under
``output/chip_smoke``), the configs are built in code, and the clip-stack
transforms and the I420 encoder are numpy. The multi, telemetry, alerts and
certify phases decode a video, with cv2, and fail without it; the
telemetry, alerts and certify phases read the family YAML with yaml. PIL is needed by the
frame-wise phases' ``resize=host`` runs; scipy by the vggish phase's
resampling.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# the port's one copy of each lookup's declared work and of the peaks its
# bounds are taken against, and of the bfloat16 bands
from video_features_tpu_torch.kernels.corr_lookup import (
    F32_PEAK_FLOPS, HBM_BYTES_PER_S, kernel_work)
from video_features_tpu_torch.telemetry import parity

STACK = 64
FRAME_H, FRAME_W = 240, 320
GRID_H, GRID_W = 32, 43  # 256x341 resized, padded to 256x344, /8
ITERS = 20
RAFT_BATCH = 32  # raft family pairs per RAFT forward
RAFT_GRID_H, RAFT_GRID_W = FRAME_H // 8, FRAME_W // 8
#: the sleep that keeps the card busy while median_ms queues its calls:
#: about 50 ms at the H100's 1.98 GHz boost clock
QUEUE_AHEAD_CYCLES = 100_000_000
#: the bfloat16 flow bound of the JAX package (tests/test_raft.py)
BF16_MEDIAN_PX, BF16_P99_PX = 0.1, 1.0
PWC_BATCH = 32  # pwc family pairs per PWC forward
#: the bfloat16 bands of the port's telemetry/parity.py TOLERANCES (the
#: JAX package's): PWC flows ("pwc", "backbone"), features ("*", "head")
PWC_BF16_COS = parity.tolerance_for("pwc", "backbone")["cos"]
PWC_BF16_MAX_PX = parity.tolerance_for("pwc", "backbone")["max_abs"]
HEAD_COS = parity.tolerance_for("*", "head")["cos"]
HEAD_MAX_ABS = parity.tolerance_for("*", "head")["max_abs"]
#: the clip-stack phases: frames, window (stack = step) and clips per group
R21D_FRAMES, R21D_STACK = 257, 16
S3D_FRAMES, S3D_STACK = 513, 64
CLIP_BATCH = 8
#: the frame-wise phases: frames and batch of the batched runs, and the
#: frames of the run at the YAML default batch_size=1
FRAME_FRAMES, FRAME_BATCH, FRAME_BATCH1_FRAMES = 256, 64, 32
#: the value tier (compare_runs bands): resize=device against resize=host
VALUE_ATOL = 1e-2
#: the vggish phase: examples of 16 kHz mono audio (625: 600.015 s, the
#: last example reading 240 samples past its 0.96 s) and seconds of 44.1
#: kHz stereo; the JAX package's bars (tests/test_vggish.py) for the
#: device frontend against the host one end to end and for the log-mel
#: alone
VGGISH_EXAMPLES, VGGISH_STEREO_SECONDS = 625, 60.0
VGGISH_FRONTEND_ATOL, VGGISH_LOGMEL_ATOL = 1e-3, 1e-4
#: PWC's decoder levels at 256x384 (256x341 frames resized to /64):
#: (level, H, W, C) of the cost volume's inputs
#: the parallel phase: the packed videos' frame counts (2..7 clips of 16
#: frames at r21d's defaults, 27 in all), the threads that feed them, and
#: the frames of the CLIP tensor-parallel run
PACKED_VIDEOS = (40, 56, 72, 88, 104, 120)
PACKED_WORKERS = 3
TP_FRAMES = 64
PWC_LEVELS = ((2, 64, 96, 32), (3, 32, 48, 64), (4, 16, 24, 96),
              (5, 8, 12, 128), (6, 4, 6, 196))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its own
    pair of CUDA events. The card first sleeps while the host queues every
    call, so a call whose host side outlasts its kernels (a wrapper around a
    0.05 ms kernel) is timed by its device work alone, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def grid_sample_lookup(pyramid, coords, radius: int = 4) -> torch.Tensor:
    """The reference's own lookup (corr.py:29-50, bilinear_sampler in
    utils/utils.py:59-73): ``F.grid_sample`` with align_corners=True and
    zeros padding. Timed as the library yardstick only."""
    b, h, w, _ = coords.shape
    q = b * h * w
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        pts = coords.reshape(q, 1, 1, 2) / 2 ** lvl + delta.view(1, 9, 9, 2)
        xg = 2 * pts[..., 0] / (wl - 1) - 1
        yg = 2 * pts[..., 1] / (hl - 1) - 1
        s = F.grid_sample(corr.reshape(q, 1, hl, wl),
                          torch.stack([xg, yg], dim=-1), align_corners=True)
        out.append(s.reshape(b, h, w, -1))
    return torch.cat(out, dim=-1)


def window_cells(shapes, coords, radius: int = 4) -> int:
    """In-plane cells of every query's (2r+2)^2 corner window, summed over
    the levels of ``shapes`` ((Hl, Wl) each): the pyramid bytes this run's
    coords need read."""
    cx = coords[..., 0].reshape(-1).double()
    cy = coords[..., 1].reshape(-1).double()
    n = 2 * radius + 2
    total = 0
    for lvl, (hl, wl) in enumerate(shapes):
        x0 = torch.floor(cx / 2 ** lvl - radius)
        y0 = torch.floor(cy / 2 ** lvl - radius)
        cols = (torch.minimum(x0 + n - 1, torch.tensor(wl - 1.0))
                - torch.clamp(x0, min=0) + 1).clamp(min=0)
        rows = (torch.minimum(y0 + n - 1, torch.tensor(hl - 1.0))
                - torch.clamp(y0, min=0) + 1).clamp(min=0)
        total += int((cols * rows).sum().item())
    return total


def level_shapes(pyramid):
    return [tuple(corr.shape[2:]) for corr in pyramid]


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of ``got`` against ``want`` where ``want`` is not NaN;
    inf unless ``got`` is NaN in exactly the same places (a bare
    ``(got - want).abs().max()`` is NaN as soon as one value is)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    diff = (got - want).abs()[~nan]
    return float(diff.max()) if diff.numel() else 0.0


def seeded_lookup(batch: int, grid_h: int, grid_w: int, seed: int):
    """Seeded random fmaps and coords spread +-12 px around the grid, as a
    RAFT forward of ``batch`` pairs on a (grid_h, grid_w) grid gives the
    lookup, on the CPU: (fmap1, fmap2, coords, the generator)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    f1 = torch.randn((batch, 256, grid_h, grid_w), generator=gen)
    f2 = torch.randn((batch, 256, grid_h, grid_w), generator=gen)
    gy, gx = torch.meshgrid(torch.arange(grid_h, dtype=torch.float32),
                            torch.arange(grid_w, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([gx, gy], -1).expand(batch, grid_h, grid_w, 2) \
        + (torch.rand((batch, grid_h, grid_w, 2), generator=gen) - 0.5) * 24
    return f1, f2, coords.contiguous(), gen


def lookup_inputs(dev, batch: int, grid_h: int, grid_w: int, seed: int):
    """The pyramid and coords of :func:`seeded_lookup` on ``dev``."""
    from video_features_tpu_torch.models.raft import build_corr_pyramid

    f1, f2, coords, gen = seeded_lookup(batch, grid_h, grid_w, seed)
    return build_corr_pyramid(f1.to(dev), f2.to(dev)), coords.to(dev), gen


def packed_row(cl, pyramid, coords) -> dict:
    """The packed kernel against its plain version (and the gather lookup
    of the unpacked levels), timed, with its bound."""
    packed, metas = cl.pack_pyramid(pyramid)
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    got = cl.corr_lookup_packed_cuda(packed, metas, coords)
    want = cl.corr_lookup_packed_ref(packed, metas, coords)
    gather = cl.corr_lookup_gather_ref(pyramid, coords)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    # the gather formulation rounds the bilinear weights at another
    # magnitude (floor(c/2^l + d) against floor(c/2^l - r) + d), a few 1e-6
    # relative, so it is held to the proj kernel's 1e-4
    err_gather = max_abs_err(got, gather)
    if not (err <= 1e-5 and err_gather <= 1e-4):
        raise AssertionError(f"corr_lookup_packed_cuda max abs err {err} "
                             f"(vs gather {err_gather})")
    del want, gather
    b_ms, b_by = bound(*kernel_work(
        "packed", q, window_cells(level_shapes(pyramid), coords)))
    return dict(
        queries=q, max_abs_err=err, max_abs_err_vs_gather=err_gather,
        ms=median_ms(lambda: cl.corr_lookup_packed_cuda(packed, metas,
                                                        coords)),
        plain_ms=median_ms(lambda: cl.corr_lookup_packed_ref(packed, metas,
                                                             coords)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: grid_sample_lookup(pyramid, coords)),
        packed_lanes_per_query=int(packed.shape[1]),
        metas=[list(m) for m in metas])


def proj_row(cl, pyramid, coords, weight, bias) -> dict:
    """The fused lookup + convc1 kernel against its plain version (max abs
    error 1e-4), timed, with its bound; the library call is ``grid_sample``
    and ``matmul``."""
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    got = cl.corr_lookup_proj_cuda(pyramid, coords, weight, bias)
    want = cl.corr_lookup_proj_ref(pyramid, coords, weight, bias)
    taps = torch.rand((q, 324), device=coords.device)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not err <= 1e-4:
        raise AssertionError(f"corr_lookup_proj_cuda max abs err {err}")
    del got, want
    b_ms, b_by = bound(*kernel_work(
        "proj", q, window_cells(level_shapes(pyramid), coords)))
    return dict(
        queries=q, max_abs_err=err,
        ms=median_ms(lambda: cl.corr_lookup_proj_cuda(
            pyramid, coords, weight, bias)),
        plain_ms=median_ms(lambda: cl.corr_lookup_proj_ref(
            pyramid, coords, weight, bias)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.relu(torch.matmul(
            grid_sample_lookup(pyramid, coords), weight) + bias)),
        # cuBLAS's float32 product of the same shapes alone: what the
        # kernel's projection part could take at a library GEMM's rate
        matmul_ms=median_ms(lambda: torch.matmul(taps, weight)))


def check_kernels(dev):
    from video_features_tpu_torch.kernels import corr_lookup as cl

    pyramid, coords, gen = lookup_inputs(dev, STACK, GRID_H, GRID_W, 0)
    weight = (torch.randn((324, 256), generator=gen) / 18.0).to(dev)
    bias = (torch.randn((256,), generator=gen) * 0.1).to(dev)
    q = coords.shape[0] * GRID_H * GRID_W

    rows = []
    with torch.inference_mode():
        got = cl.corr_lookup_level_cuda(pyramid, coords)
        want = cl.corr_lookup_gather_ref(pyramid, coords)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if not err <= 1e-5:
            raise AssertionError(f"corr_lookup_level_cuda max abs err {err}")
        b_ms, b_by = bound(*kernel_work(
            "level", q, window_cells(level_shapes(pyramid), coords)))
        rows.append(dict(
            name="corr_lookup_level_cuda", route="cuda",
            source="video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
            replaces="video_features_tpu/kernels/corr_lookup.py:117",
            max_abs_err=err,
            ms=median_ms(lambda: cl.corr_lookup_level_cuda(pyramid, coords)),
            plain_ms=median_ms(
                lambda: cl.corr_lookup_gather_ref(pyramid, coords)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=median_ms(lambda: grid_sample_lookup(pyramid, coords)),
            queries=q))

        proj = dict(
            name="corr_lookup_proj_cuda", route="cuda",
            source="video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
            replaces="video_features_tpu/kernels/corr_lookup.py:380",
            **proj_row(cl, pyramid, coords, weight, bias))
        rows.append(proj)
        del got, want
        at_i3d = packed_row(cl, pyramid, coords)
        del pyramid, coords
        torch.cuda.empty_cache()

        # the packed row is at the raft family's shapes, whose packed path
        # counts its launches; the i3d shapes ride along
        pyramid, coords, _ = lookup_inputs(dev, RAFT_BATCH, RAFT_GRID_H,
                                           RAFT_GRID_W, 1)
        rows.append(dict(
            name="corr_lookup_packed_cuda", route="cuda",
            source="video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
            replaces="video_features_tpu/kernels/corr_lookup.py:612",
            **packed_row(cl, pyramid, coords), at_i3d_shapes=at_i3d))
        # proj on the raft family's default path: its shapes, and convc1's
        # weight and bias rounded to bfloat16 and upcast, as
        # BasicMotionEncoder.convc1_matrix feeds the bfloat16 model's
        proj["at_raft_shapes"] = proj_row(
            cl, pyramid, coords, weight.bfloat16().float(),
            bias.bfloat16().float())
    del pyramid, coords
    torch.cuda.empty_cache()
    return rows


def ragged_inputs(dev, name: str):
    """The small cases of tests/test_torch_corr_lookup.py, with pyramids from
    the port's build_corr_pyramid on numpy-seeded fmaps: ``q231`` (3 pairs
    on a 7x11 grid, Q = 231, no whole 64-query tile), ``odd`` (odd level
    sizes, a level narrower than the 11-cell window), ``outside`` (whole
    windows out of every level), ``degenerate`` (levels of 1x1 and 0x0)
    and ``nonfinite`` (NaN, +-inf and +-1e30 coords)."""
    from video_features_tpu_torch.models.raft import build_corr_pyramid

    rng = np.random.default_rng({"q231": 7, "odd": 3, "outside": 2,
                                 "degenerate": 4, "nonfinite": 8}[name])
    b, h8, w8, c = {"q231": (3, 7, 11, 32), "odd": (2, 13, 11, 32),
                    "outside": (1, 12, 10, 64),
                    "degenerate": (1, 6, 5, 16),
                    "nonfinite": (1, 12, 10, 64)}[name]
    f1, f2 = (torch.from_numpy(rng.normal(size=(b, c, h8, w8)).astype(
        np.float32)).to(dev) for _ in range(2))
    pyramid = build_corr_pyramid(f1, f2)
    if name == "outside":
        gx, gy = np.meshgrid(np.arange(w8, dtype=np.float32),
                             np.arange(h8, dtype=np.float32))
        coords = np.broadcast_to(np.stack([gx, gy], -1),
                                 (b, h8, w8, 2)).copy()
        coords[:, 0] = -50.0
        coords[:, 1, :, 0] = w8 + 40.0
    else:
        coords = rng.uniform(-6.0, max(h8, w8) + 6.0,
                             size=(b, h8, w8, 2)).astype(np.float32)
    if name == "nonfinite":
        coords[0, 0, 0, 0] = np.nan
        coords[0, 0, 1, 1] = np.nan
        coords[0, 1, 2, 0] = np.inf
        coords[0, 2, 3, 1] = -np.inf
        coords[0, 3, 4, 0] = 1e30
        coords[0, 4, 5, 1] = -1e30
    return pyramid, torch.from_numpy(coords).to(dev)


def check_ragged(dev) -> dict:
    """Level (1e-5), proj (1e-4) and packed (1e-5) against their plain
    versions on the ragged cases; the max abs error of each, NaN in the same
    places (the packed lookup's NaN for a non-finite coord)."""
    from video_features_tpu_torch.kernels import corr_lookup as cl

    rng = np.random.default_rng(9)
    weight = torch.from_numpy((rng.normal(size=(324, 256)) * 0.05).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)).to(
        dev)
    errs = {}
    with torch.inference_mode():
        for name in ("q231", "odd", "outside", "degenerate", "nonfinite"):
            pyramid, coords = ragged_inputs(dev, name)
            packed, metas = cl.pack_pyramid(pyramid)
            e = dict(
                queries=coords.shape[0] * coords.shape[1] * coords.shape[2],
                levels=level_shapes(pyramid),
                level=max_abs_err(
                    cl.corr_lookup_level_cuda(pyramid, coords),
                    cl.corr_lookup_gather_ref(pyramid, coords)),
                proj=max_abs_err(
                    cl.corr_lookup_proj_cuda(pyramid, coords, weight, bias),
                    cl.corr_lookup_proj_ref(pyramid, coords, weight, bias)),
                packed=max_abs_err(
                    cl.corr_lookup_packed_cuda(packed, metas, coords),
                    cl.corr_lookup_packed_ref(packed, metas, coords)))
            if not (e["level"] <= 1e-5 and e["proj"] <= 1e-4
                    and e["packed"] <= 1e-5):
                raise AssertionError(f"ragged case {name}: {e}")
            errs[name] = e
    return errs


def check_small_raft(dev):
    """RAFT through the kernels (fused, unfused, packed) vs the plain gather
    lookup, small input, float32."""
    from video_features_tpu_torch.models.raft import RAFT
    from video_features_tpu_torch.weights.bridge import seeded_init_

    gen = torch.Generator().manual_seed(3)
    x1 = (torch.rand((2, 64, 96, 3), generator=gen) * 255).to(dev)
    x2 = (torch.rand((2, 64, 96, 3), generator=gen) * 255).to(dev)
    model = seeded_init_(RAFT(iters=4), 5).to(dev).eval()
    worst = 0.0
    with torch.inference_mode():
        model.corr_lookup_impl = "gather"
        want = model(x1, x2)
        for impl, fuse in ((None, True), (None, False), ("packed", True)):
            model.corr_lookup_impl, model.fuse_convc1 = impl, fuse
            err = float((model(x1, x2) - want).abs().max())
            if not err <= 1e-3:
                raise AssertionError(f"RAFT corr_lookup_impl={impl} "
                                     f"fuse_convc1={fuse} vs gather: max "
                                     f"abs err {err} px")
            worst = max(worst, err)
    return worst


def slice_config(out_dir: str, **over):
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="i3d", streams=None, flow_type="raft",
               flow_iters=ITERS, flow_stack_batch=1, stack_size=STACK,
               step_size=STACK, clip_batch_size=2, resize="device",
               extraction_fps=None, device="cuda", precision="float32",
               allow_random_weights=True, on_extraction="print",
               output_path=out_dir, tmp_path="tmp/chip_smoke",
               corr_lookup_impl=None, fuse_convc1=None)
    cfg.update(over)
    return Config(cfg)


def synthetic_frames(n: int, seed: int):
    """Smooth moving gradients plus seeded noise, uint8 RGB 240x320, at a
    nominal 25 fps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W].astype(np.float32)
    for t in range(n):
        frame = np.stack([
            127 + 100 * np.sin(xx / 23 + t / 5),
            127 + 100 * np.sin(yy / 17 - t / 7),
            127 + 100 * np.sin((xx + yy) / 31 + t / 3)], axis=-1)
        frame += rng.normal(0, 8, frame.shape)
        yield frame.clip(0, 255).astype(np.uint8), t / 25 * 1000.0, t


def annotated(module, names):
    """Wrap each function ``module.<name>`` in a profiler range of that name
    (undone by calling the returned function), so a profile can attribute
    device time to it."""
    saved = {name: getattr(module, name) for name in names}
    for name, fn in saved.items():
        def ranged(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)
        setattr(module, name, ranged)
    return lambda: [setattr(module, n, f) for n, f in saved.items()]


def profile_run(extractor, frames, ranges=None) -> dict:
    """Device time by kernel over one warm ``extract_frames`` run
    (:func:`profile_call`)."""
    return profile_call(lambda: extractor.extract_frames(iter(frames), 25.0),
                        ranges)


def profile_call(run, ranges=None) -> dict:
    """Device time by kernel over one warm call of ``run``
    (torch.profiler), the share of the wall time the card was busy (the
    union of the kernels' intervals, so nothing counts twice), the host's
    top operators by self CPU time, and the device time of each function
    of ``ranges`` (``(module, [names])``, wrapped by :func:`annotated`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    undo = annotated(*ranges) if ranges else None
    synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        if undo:
            undo()
    names = ranges[1] if ranges else []
    # a range also shows on the device as an annotation spanning its
    # kernels (gaps included): not a kernel, so left out of the spans
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.name not in names})
    if not spans:
        return {"device_time": "not measured (no CUDA events traced)",
                "wall_ms": wall_us / 1e3}
    busy_us, end_us = 0.0, float("-inf")
    by_name: dict = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    averages = prof.key_averages()
    host = sorted((e for e in averages if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    out = {"wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us,
           "kernel_ms_total": sum(v[0] for v in by_name.values()),
           "kernel_launches": sum(v[1] for v in by_name.values()),
           "top_kernels": [{"name": k[:90], "ms": v[0], "calls": v[1]}
                           for k, v in top],
           "top_host_ops": [{"name": e.key[:60],
                             "self_cpu_ms": e.self_cpu_time_total / 1e3,
                             "calls": e.count} for e in host]}
    if ranges:
        # the kernels launched inside each range, summed over its calls
        # (0 where the profiler linked none: then "not measured")
        kernel_us = dict.fromkeys(names, 0.0)
        for e in prof.events():
            if e.name in names and e.device_type == DeviceType.CPU:
                kernel_us[e.name] += e.device_time_total
        out["ranges"] = {
            name: ({"kernel_ms": us / 1e3, "share_of_busy": us / busy_us}
                   if us > 0 else "not measured")
            for name, us in kernel_us.items()}
    return out


def kernel_resources(build) -> dict:
    """Registers, static shared memory and spills of each kernel from the
    built library's ``-Xptxas -v`` report, by short name (``proj_kernel``,
    ``level_kernel``, ``packed_kernel``)."""
    report = build.report_path(build.library_path()).read_text()
    out = {}
    for mangled, res in build.kernel_resources(report).items():
        for short in ("proj_kernel", "level_kernel", "packed_kernel"):
            if short in mangled:
                out[short] = res
    missing = {"proj_kernel", "level_kernel", "packed_kernel"} - set(out)
    if missing:
        raise AssertionError(f"no ptxas report for {sorted(missing)}")
    return out


def reset_counts(cl) -> None:
    cl.corr_lookup_level_cuda.launches = 0
    cl.corr_lookup_proj_cuda.launches = 0
    cl.corr_lookup_packed_cuda.launches = 0


def read_counts(cl) -> dict:
    return {"level": cl.corr_lookup_level_cuda.launches,
            "proj": cl.corr_lookup_proj_cuda.launches,
            "packed": cl.corr_lookup_packed_cuda.launches}


def run_slice(dev):
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    from video_features_tpu_torch.kernels import corr_lookup as cl

    # each extractor runs once before its timed run: the first call at a
    # shape pays cuDNN's algorithm set-up, which is not steady state
    fused = ExtractI3D(slice_config("output/chip_smoke"))
    fused.extract_frames(synthetic_frames(2 * STACK + 1, 7), 25.0)
    fused.flow_stream.forwards = 0
    reset_counts(cl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = fused.extract_frames(synthetic_frames(2 * STACK + 1, 11), 25.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fused_counts = read_counts(cl)
    proj_launches = fused_counts["proj"]
    fwd = fused.flow_stream.forwards
    for s in ("rgb", "flow"):
        if feats[s].shape != (2, 1024) or not np.isfinite(feats[s]).all():
            raise AssertionError(f"{s}: shape {feats[s].shape} or non-finite")
    if feats["timestamps_ms"].tolist() != [STACK / 25 * 1000,
                                           2 * STACK / 25 * 1000]:
        raise AssertionError(f"timestamps {feats['timestamps_ms']}")
    if fwd < 1 or fused_counts != {"level": 0, "proj": ITERS * fwd,
                                   "packed": 0}:
        raise AssertionError(f"fused path: launches {fused_counts} for "
                             f"{fwd} RAFT forwards")

    profile = profile_run(fused, list(synthetic_frames(2 * STACK + 1, 13)))
    profile["stacks"] = 2

    unfused = ExtractI3D(slice_config("output/chip_smoke",
                                      fuse_convc1=False))
    unfused.extract_frames(synthetic_frames(STACK + 1, 7), 25.0)
    unfused.flow_stream.forwards = 0
    reset_counts(cl)
    t0 = time.perf_counter()
    one = unfused.extract_frames(synthetic_frames(2 * STACK + 1, 11), 25.0)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    unfused_counts = read_counts(cl)
    level_launches = unfused_counts["level"]
    fwd_u = unfused.flow_stream.forwards
    if fwd_u < 1 or unfused_counts != {"level": ITERS * fwd_u,
                                       "proj": 0, "packed": 0}:
        raise AssertionError(f"unfused path: launches {unfused_counts} for "
                             f"{fwd_u} RAFT forwards")
    diffs = {s: float(np.abs(one[s] - feats[s]).max()) for s in
             ("rgb", "flow")}
    if not max(diffs.values()) <= 1e-2:
        raise AssertionError(f"unfused vs fused features differ: {diffs}")

    # fused and unfused in turns (F U U F), to compare them within one call
    ab = {"fused": [], "unfused": []}
    for name, ex in (("fused", fused), ("unfused", unfused),
                     ("unfused", unfused), ("fused", fused)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.extract_frames(synthetic_frames(2 * STACK + 1, 17), 25.0)
        torch.cuda.synchronize()
        ab[name].append(2 / (time.perf_counter() - t0))

    # the packed path: RAFT._lookup reads corr_lookup_impl on every forward
    raft = fused.flow_stream.raft
    raft.corr_lookup_impl = "packed"
    fused.flow_stream.forwards = 0
    reset_counts(cl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = fused.extract_frames(synthetic_frames(2 * STACK + 1, 11), 25.0)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    raft.corr_lookup_impl = None
    packed_counts = read_counts(cl)
    fwd_p = fused.flow_stream.forwards
    if fwd_p < 1 or packed_counts != {"level": 0, "proj": 0,
                                      "packed": ITERS * fwd_p}:
        raise AssertionError(f"i3d packed path: launches {packed_counts} "
                             f"for {fwd_p} RAFT forwards")
    diffs_p = {s: float(np.abs(packed[s] - feats[s]).max()) for s in
               ("rgb", "flow")}
    if not max(diffs_p.values()) <= 1e-2:
        raise AssertionError(f"packed vs fused features differ: {diffs_p}")
    return dict(stacks=2, seconds=seconds, stacks_per_s=2 / seconds,
                flow_forwards=fwd, proj_launches=proj_launches,
                unfused_stacks_per_s=2 / unfused_s,
                unfused_flow_forwards=fwd_u,
                level_launches=level_launches,
                unfused_vs_fused_max_abs=diffs,
                fused_unfused_turns_stacks_per_s=ab,
                packed_stacks_per_s=2 / packed_s,
                packed_flow_forwards=fwd_p,
                packed_launches=packed_counts["packed"],
                packed_vs_fused_max_abs=diffs_p,
                profile=profile), proj_launches, level_launches, feats


def raft_config(out_dir: str, **over):
    """The raft family's YAML defaults (configs/raft.yml), on the card,
    with ``batch_size=32``."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="raft", extraction_fps=None,
               extraction_total=None, fps_mode="select", side_size=None,
               resize="auto", resize_to_smaller_edge=True,
               finetuned_on="sintel", iters=None, batch_size=RAFT_BATCH,
               device="cuda", video_decode="inline", on_extraction="print",
               output_path=out_dir, tmp_path="tmp/chip_smoke",
               weights_path=None, allow_random_weights=True,
               precision="bfloat16", corr_lookup_impl=None, fuse_convc1=None)
    cfg.update(over)
    return Config(cfg)


def run_raft_family(dev):
    """The raft family at its defaults (bfloat16, fused lookup) and with
    corr_lookup_impl=packed, over 65 synthetic frames: 64 flows in two RAFT
    forwards of 32 pairs."""
    from video_features_tpu_torch.extractors.raft import ExtractRAFT
    from video_features_tpu_torch.kernels import corr_lookup as cl

    n_frames = 2 * RAFT_BATCH + 1
    frames = list(synthetic_frames(n_frames, 21))
    forwards = -(-(n_frames - 1) // RAFT_BATCH)
    want_ts = [t / 25 * 1000.0 for t in range(n_frames)]
    runs = {}
    for name, impl, kernel in (("default", None, "proj"),
                               ("packed", "packed", "packed")):
        ex = ExtractRAFT(raft_config("output/chip_smoke",
                                     corr_lookup_impl=impl))
        if ex.model.dtype != torch.bfloat16 or ex.model.iters != ITERS:
            raise AssertionError(f"{name}: {ex.model.dtype}, {ex.model.iters}")
        ex.extract_frames(iter(frames), 25.0)  # cuDNN set-up at this shape
        reset_counts(cl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.extract_frames(iter(frames), 25.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(cl)
        want = {"level": 0, "proj": 0, "packed": 0}
        want[kernel] = ITERS * forwards
        if counts != want:
            raise AssertionError(f"raft {name}: launches {counts}, want "
                                 f"{want}")
        flow = out["raft"]
        if flow.shape != (n_frames - 1, 2, FRAME_H, FRAME_W) \
                or flow.dtype != np.float32 or not np.isfinite(flow).all():
            raise AssertionError(f"raft {name}: flow {flow.shape} "
                                 f"{flow.dtype} or non-finite")
        if out["timestamps_ms"].tolist() != want_ts:
            raise AssertionError(f"raft {name}: timestamps "
                                 f"{out['timestamps_ms']}")
        runs[name] = dict(extractor=ex, flow=flow, seconds=seconds,
                          counts=counts)
    d = np.abs(runs["packed"]["flow"] - runs["default"]["flow"])
    vs_default = dict(max_px=float(d.max()), median_px=float(np.median(d)),
                      p99_px=float(np.percentile(d, 99)),
                      median_limit_px=BF16_MEDIAN_PX,
                      p99_limit_px=BF16_P99_PX)
    if not (vs_default["median_px"] < BF16_MEDIAN_PX
            and vs_default["p99_px"] < BF16_P99_PX):
        raise AssertionError(f"raft packed vs default flow: {vs_default}")
    default_abs = np.abs(runs["default"]["flow"])
    # default and packed in turns (D P P D), to compare them within one call
    turns = {"default": [], "packed": []}
    for name in ("default", "packed", "packed", "default"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]["extractor"].extract_frames(iter(frames), 25.0)
        torch.cuda.synchronize()
        turns[name].append((n_frames - 1) / (time.perf_counter() - t0))
    profile = profile_run(runs["default"]["extractor"], frames)
    profile["pairs"] = n_frames - 1
    stats = dict(
        pairs=n_frames - 1, batch_size=RAFT_BATCH, flow_forwards=forwards,
        precision="bfloat16", iters=ITERS,
        flow_abs_px=dict(median=float(np.median(default_abs)),
                         max=float(default_abs.max())),
        packed_vs_default_flow=vs_default,
        turns_pairs_per_s=turns, profile=profile)
    for name in ("default", "packed"):
        stats[f"{name}_pairs_per_s"] = (n_frames - 1) / runs[name]["seconds"]
        stats[f"{name}_launches"] = runs[name]["counts"]
    return stats


def band(got: np.ndarray, want: np.ndarray) -> dict:
    """Cosine and max abs difference of ``got`` against ``want``."""
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return {"cos": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            "max_abs": float(np.abs(a - b).max())}


def synchronize() -> None:
    """Wait for the card (nothing to wait for on the CPU, where the tests
    run the phases' helpers)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def empty_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def timed(extractor, frames):
    """(features, seconds) of one ``extract_frames`` run on the card."""
    synchronize()
    t0 = time.perf_counter()
    out = extractor.extract_frames(iter(frames), 25.0)
    synchronize()
    return out, time.perf_counter() - t0


def pwc_ranges():
    """PWC's plain cost volume and warp, for :func:`profile_run`."""
    from video_features_tpu_torch.models import pwc
    return pwc, ["correlation_volume", "bilinear_warp"]


def pwc_config(out_dir: str, **over):
    """The pwc family's YAML defaults (configs/pwc.yml), on the card, with
    ``batch_size=32``."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="pwc", extraction_fps=None,
               extraction_total=None, fps_mode="select", side_size=None,
               resize="auto", resize_to_smaller_edge=True,
               batch_size=PWC_BATCH, device="cuda", video_decode="inline",
               on_extraction="print", output_path=out_dir,
               tmp_path="tmp/chip_smoke", weights_path=None,
               allow_random_weights=True, precision="bfloat16")
    cfg.update(over)
    return Config(cfg)


def run_pwc_family(dev):
    """The pwc family at its defaults (bfloat16) and in float32, over 65
    synthetic frames: 64 flows in two PWC forwards of 32 pairs."""
    from video_features_tpu_torch.extractors.pwc import ExtractPWC
    from video_features_tpu_torch.kernels import corr_lookup as cl

    n_frames = 2 * PWC_BATCH + 1
    frames = list(synthetic_frames(n_frames, 23))
    want_ts = [t / 25 * 1000.0 for t in range(n_frames)]
    runs = {}
    for precision in ("bfloat16", "float32"):
        ex = ExtractPWC(pwc_config("output/chip_smoke", precision=precision))
        if ex.model.dtype != getattr(torch, precision):
            raise AssertionError(f"pwc {precision}: model {ex.model.dtype}")
        ex.extract_frames(iter(frames), 25.0)  # cuDNN set-up at this shape
        reset_counts(cl)
        out, seconds = timed(ex, frames)
        if any(read_counts(cl).values()):
            raise AssertionError(f"pwc {precision}: lookup kernels "
                                 f"launched {read_counts(cl)}")
        flow = out["pwc"]
        if flow.shape != (n_frames - 1, 2, FRAME_H, FRAME_W) \
                or flow.dtype != np.float32 or not np.isfinite(flow).all():
            raise AssertionError(f"pwc {precision}: flow {flow.shape} "
                                 f"{flow.dtype} or non-finite")
        if out["timestamps_ms"].tolist() != want_ts:
            raise AssertionError(f"pwc {precision}: timestamps "
                                 f"{out['timestamps_ms']}")
        runs[precision] = dict(extractor=ex, flow=flow, seconds=seconds)
    vs_f32 = band(runs["bfloat16"]["flow"], runs["float32"]["flow"])
    vs_f32.update(cos_limit=PWC_BF16_COS, max_abs_limit_px=PWC_BF16_MAX_PX)
    if not (vs_f32["cos"] >= PWC_BF16_COS
            and vs_f32["max_abs"] <= PWC_BF16_MAX_PX):
        raise AssertionError(f"pwc bfloat16 vs float32 flow: {vs_f32}")
    turns = {"bfloat16": [], "float32": []}
    for precision in ("bfloat16", "float32", "float32", "bfloat16"):
        _, seconds = timed(runs[precision]["extractor"], frames)
        turns[precision].append((n_frames - 1) / seconds)
    profile = profile_run(runs["bfloat16"]["extractor"], frames,
                          pwc_ranges())
    profile["pairs"] = n_frames - 1
    f32_abs = np.abs(runs["float32"]["flow"])
    stats = dict(pairs=n_frames - 1, batch_size=PWC_BATCH,
                 flow_forwards=-(-(n_frames - 1) // PWC_BATCH),
                 flow_abs_px=dict(median=float(np.median(f32_abs)),
                                  max=float(f32_abs.max())),
                 bf16_vs_f32_flow=vs_f32, turns_pairs_per_s=turns,
                 profile=profile)
    for precision in ("bfloat16", "float32"):
        stats[f"{precision}_pairs_per_s"] = \
            (n_frames - 1) / runs[precision]["seconds"]
    return stats


def cost_volume_times(dev, busy_ms, stacks: int) -> dict:
    """The plain cost volume alone at the decoder levels' shapes of one
    stack's 64 pairs, float32 and bfloat16 (CUDA-event medians), with each
    level's bytes bound (the two inputs read once, the 81 channels written
    once, over the card's memory rate); the float32 sum per stack and its
    share of ``busy_ms``, the device busy time of a profiled run of
    ``stacks`` stacks (not measured when the profiler traced no device
    time)."""
    from video_features_tpu_torch.kernels.cost_volume import cost_volume_nchw

    gen = torch.Generator(device="cpu").manual_seed(29)
    out = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            levels = []
            for level, h, w, c in PWC_LEVELS:
                f1, f2 = (torch.randn((STACK, c, h, w), generator=gen).to(
                    dev, dtype) for _ in range(2))
                size = f1.element_size()
                bytes_moved = STACK * h * w * (2 * c + 81) * size
                levels.append(dict(
                    level=level, shape=[STACK, c, h, w],
                    ms=median_ms(lambda: cost_volume_nchw(f1, f2)),
                    bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3))
            name = "float32" if dtype == torch.float32 else "bfloat16"
            out[name] = dict(levels=levels, ms_per_stack=sum(
                lv["ms"] for lv in levels))
    out["share_of_profiled_busy"] = "not measured" if busy_ms is None \
        else out["float32"]["ms_per_stack"] * stacks / busy_ms
    return out


def run_i3d_pwc(dev, fused_feats):
    """I3D at its YAML defaults (flow_type=pwc, float32) and in bfloat16 on
    the slice's frames; then flow_type=raft in bfloat16 once, against the
    slice's fused float32 features ``fused_feats``."""
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    from video_features_tpu_torch.kernels import corr_lookup as cl

    frames = list(synthetic_frames(2 * STACK + 1, 11))
    runs = {}
    for precision in ("float32", "bfloat16"):
        ex = ExtractI3D(slice_config("output/chip_smoke", flow_type="pwc",
                                     flow_stack_batch="auto",
                                     precision=precision))
        ex.extract_frames(synthetic_frames(2 * STACK + 1, 7), 25.0)
        ex.flow_stream.forwards = 0
        reset_counts(cl)
        feats, seconds = timed(ex, frames)
        if any(read_counts(cl).values()):
            raise AssertionError(f"i3d pwc {precision}: lookup kernels "
                                 f"launched {read_counts(cl)}")
        for s in ("rgb", "flow"):
            if feats[s].shape != (2, 1024) or not np.isfinite(feats[s]).all():
                raise AssertionError(f"i3d pwc {precision} {s}: shape "
                                     f"{feats[s].shape} or non-finite")
        runs[precision] = dict(extractor=ex, feats=feats, seconds=seconds,
                               flow_forwards=ex.flow_stream.forwards)
    bf16_vs_f32 = {s: band(runs["bfloat16"]["feats"][s],
                           runs["float32"]["feats"][s])
                   for s in ("rgb", "flow")}
    if not all(b["cos"] >= HEAD_COS and b["max_abs"] <= HEAD_MAX_ABS
               for b in bf16_vs_f32.values()):
        raise AssertionError(f"i3d pwc bfloat16 vs float32: {bf16_vs_f32}")
    turns = {"float32": [], "bfloat16": []}
    for precision in ("float32", "bfloat16", "bfloat16", "float32"):
        _, seconds = timed(runs[precision]["extractor"], frames)
        turns[precision].append(2 / seconds)
    profile = profile_run(runs["float32"]["extractor"], frames, pwc_ranges())
    profile["stacks"] = 2
    profile_bf16 = profile_run(runs["bfloat16"]["extractor"], frames,
                               pwc_ranges())
    stats = dict(stacks=2, bf16_vs_f32=bf16_vs_f32,
                 band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
                 turns_stacks_per_s=turns, profile=profile,
                 profile_bfloat16=profile_bf16)
    for precision in ("float32", "bfloat16"):
        stats[f"{precision}_stacks_per_s"] = 2 / runs[precision]["seconds"]
        stats[f"{precision}_flow_forwards"] = runs[precision]["flow_forwards"]
    del runs
    torch.cuda.empty_cache()

    raft = ExtractI3D(slice_config("output/chip_smoke",
                                   precision="bfloat16"))
    reset_counts(cl)
    feats, seconds = timed(raft, frames)
    counts = read_counts(cl)
    fwd = raft.flow_stream.forwards
    if fwd < 1 or counts != {"level": 0, "proj": ITERS * fwd, "packed": 0}:
        raise AssertionError(f"i3d raft bfloat16: launches {counts} for "
                             f"{fwd} RAFT forwards")
    raft_vs_fused = {s: band(feats[s], fused_feats[s])
                     for s in ("rgb", "flow")}
    if not all(b["cos"] >= HEAD_COS and b["max_abs"] <= HEAD_MAX_ABS
               for b in raft_vs_fused.values()):
        raise AssertionError(f"i3d raft bfloat16 vs fused float32: "
                             f"{raft_vs_fused}")
    stats["raft_bfloat16"] = dict(
        flow_forwards=fwd, launches=counts, vs_fused_float32=raft_vs_fused,
        cold_stacks_per_s=2 / seconds)
    del raft
    torch.cuda.empty_cache()
    stats["cost_volume"] = cost_volume_times(
        dev, profile.get("device_busy_ms"), 2)
    return stats, counts["proj"]


def clip_config(feature_type: str, **over):
    """The r21d or s3d YAML defaults (configs/*.yml), on the card."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type=feature_type, stack_size=None, step_size=None,
               clip_batch_size=CLIP_BATCH, extraction_fps=None,
               fps_mode="select", device="cuda", video_decode="inline",
               on_extraction="print", output_path="output/chip_smoke",
               tmp_path="tmp/chip_smoke", show_pred=False, weights_path=None,
               allow_random_weights=True, precision="float32", ingest=None)
    if feature_type == "r21d":
        cfg["model_name"] = "r2plus1d_18_16_kinetics"
    else:
        cfg.update(stack_size=S3D_STACK, step_size=S3D_STACK,
                   extraction_fps=25)
    cfg.update(over)
    return Config(cfg)


def clip_windows(extractor, n_frames: int):
    """The ``(start, end)`` windows ``extractor`` forms over ``n_frames``
    frames (placeholders: the windowing does not read them)."""
    return [w for w, _ in extractor._iter_stacks(
        (np.zeros(1), i / 25 * 1000.0, i) for i in range(n_frames))]


def in_head_band(b: dict) -> bool:
    return b["cos"] >= HEAD_COS and b["max_abs"] <= HEAD_MAX_ABS


def wire_frames(extractor, frames):
    """``frames`` through the extractor's host transform, and the mean ms
    per frame it took."""
    t0 = time.perf_counter()
    out = [(extractor.host_transform(f), t, i) for f, t, i in frames]
    return out, (time.perf_counter() - t0) * 1e3 / len(frames)


def card_part(extractor, wire) -> float:
    """Seconds of the card's part of a run: transformed frames through the
    clip windows, the copy, the forward and back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extractor._features(iter(wire))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def clip_phase(feature_type: str, n_frames: int, dim: int, unit: str):
    """One clip-stack family in float32 (the YAML default) and bfloat16
    over ``n_frames`` seeded frames: the main-path run of each through
    ``extract_frames`` with every launch count set to 0 just before and
    read just after (no lookup kernel runs), the checks, the host
    transform's ms per frame, the card's part in turns (F B B F), one
    profiled run of each. Returns (stats, the frames, the float32
    features)."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.extractors.s3d import ExtractS3D
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils.lists import form_slices

    cls = ExtractR21D if feature_type == "r21d" else ExtractS3D
    frames = list(synthetic_frames(n_frames, 31))
    runs = {}
    for precision in ("float32", "bfloat16"):
        ex = cls(clip_config(feature_type, precision=precision))
        wire, transform_ms = wire_frames(ex, frames)
        card_part(ex, wire)  # the first call at a shape sets up cuDNN
        reset_counts(cl)
        feats, seconds = timed(ex, frames)
        feats = feats[feature_type]
        if any(read_counts(cl).values()):
            raise AssertionError(f"{feature_type} {precision}: lookup "
                                 f"kernels launched {read_counts(cl)}")
        windows = form_slices(n_frames, ex.stack_size, ex.step_size)
        if clip_windows(ex, n_frames) != windows:
            raise AssertionError(f"{feature_type}: windows "
                                 f"{clip_windows(ex, n_frames)}")
        if feats.shape != (len(windows), dim) or \
                not np.isfinite(feats).all():
            raise AssertionError(f"{feature_type} {precision}: shape "
                                 f"{feats.shape} or non-finite")
        runs[precision] = dict(extractor=ex, feats=feats, seconds=seconds,
                               wire=wire, transform_ms=transform_ms,
                               ingest=ex.ingest)
    rows = len(runs["float32"]["feats"])
    vs_f32 = band(runs["bfloat16"]["feats"], runs["float32"]["feats"])
    if not in_head_band(vs_f32):
        raise AssertionError(f"{feature_type} bfloat16 vs float32: {vs_f32}")
    turns = {"float32": [], "bfloat16": []}
    for precision in ("float32", "bfloat16", "bfloat16", "float32"):
        r = runs[precision]
        turns[precision].append(rows / card_part(r["extractor"], r["wire"]))
    stats = dict(frames=n_frames, rows=rows, clip_batch_size=CLIP_BATCH,
                 bf16_vs_f32=vs_f32,
                 band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
                 **{f"card_part_turns_{unit}_per_s": turns})
    for precision, r in runs.items():
        profile = profile_run(r["extractor"], frames)
        profile[unit] = rows
        stats[precision] = dict(
            ingest=r["ingest"], seconds=r["seconds"],
            **{f"{unit}_per_s": rows / r["seconds"]},
            host_transform_ms_per_frame=r["transform_ms"], profile=profile)
    feats = runs["float32"]["feats"]
    del runs
    torch.cuda.empty_cache()
    return stats, frames, feats


def run_r21d(dev):
    """R(2+1)D at the r21d YAML defaults and in bfloat16 (clip_phase),
    then ``ingest=yuv420`` once and the 34-layer variant once."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.ops import colorspace
    from video_features_tpu_torch.ops.host_transforms import R21DTransform

    stats, frames, feats = clip_phase("r21d", R21D_FRAMES, 512, "clips")
    to_u8 = R21DTransform("uint8")
    packed = np.stack([colorspace.rgb_to_yuv420(to_u8(f))
                       for f, _, _ in frames[:R21D_STACK]])
    want = colorspace.yuv420_packed_to_rgb(torch.from_numpy(packed), 112, 112)
    got = colorspace.yuv420_packed_to_rgb(torch.from_numpy(packed).to(dev),
                                          112, 112)
    err = max_abs_err(got.cpu(), want)
    if not err <= 1e-4:
        raise AssertionError(f"yuv420_packed_to_rgb card vs CPU: {err}")
    yuv = ExtractR21D(clip_config("r21d", ingest="yuv420"))
    yuv_feats, yuv_s = timed(yuv, frames)
    yuv_band = band(yuv_feats["r21d"], feats)
    if yuv_feats["r21d"].shape != feats.shape or not in_head_band(yuv_band):
        raise AssertionError(f"r21d yuv420 vs float32: {yuv_band}")
    del yuv
    r34 = ExtractR21D(clip_config(
        "r21d", model_name="r2plus1d_34_8_ig65m_ft_kinetics"))
    r34_feats, r34_s = timed(r34, frames[:16])
    if r34_feats["r21d"].shape != (2, 512) or \
            not np.isfinite(r34_feats["r21d"]).all():
        raise AssertionError(f"r34_8: {r34_feats['r21d'].shape}")
    del r34
    torch.cuda.empty_cache()
    stats["yuv420"] = dict(rgb_card_vs_cpu_max_abs_err=err,
                           vs_float32=yuv_band,
                           cold_clips_per_s=len(feats) / yuv_s)
    stats["r2plus1d_34_8"] = dict(clips=2, cold_seconds=r34_s)
    return stats


def run_s3d(dev):
    """S3D at the s3d YAML defaults and in bfloat16 (clip_phase)."""
    return clip_phase("s3d", S3D_FRAMES, 1024, "stacks")[0]


def frame_config(feature_type: str, **over):
    """The resnet or clip YAML defaults (configs/*.yml: resnet50 or
    ViT-B/32, ``batch_size=1``, float32), on the card, with
    ``resize=device``."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type=feature_type, batch_size=1, extraction_fps=None,
               extraction_total=None, fps_mode="select", device="cuda",
               video_decode="inline", on_extraction="print",
               output_path="output/chip_smoke", tmp_path="tmp/chip_smoke",
               show_pred=False, weights_path=None, allow_random_weights=True,
               precision="float32", ingest=None, resize="device")
    if feature_type == "resnet":
        cfg["model_name"] = "resnet50"
    else:
        cfg.update(model_name="ViT-B/32", pred_texts=None, bpe_path=None,
                   model_parallel=1, vision_attn="dense")
    cfg.update(over)
    return Config(cfg)


def frame_flops(extractor) -> float:
    """Forward FLOPs per frame of a frame-wise extractor's image backbone
    at its crop (``torch.utils.flop_counter`` on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    from video_features_tpu_torch.models import clip, resnet

    with torch.device("meta"):
        if extractor.feature_type == "resnet":
            forward = resnet.ResNet(extractor.model_name)
        else:
            forward = clip.CLIP(extractor.cfg).encode_image
        x = torch.zeros((1, extractor.crop_size, extractor.crop_size, 3))
    with FlopCounterMode(display=False) as counter:
        forward(x)
    return float(counter.get_total_flops())


def frame_phase(feature_type: str, dim: int, other_model: str,
                other_dim: int, n_frames: int = FRAME_FRAMES,
                batch: int = FRAME_BATCH, n_batch1: int = FRAME_BATCH1_FRAMES,
                **over) -> dict:
    """One frame-wise family: the YAML defaults (batch_size=1) over 32
    seeded frames; batch_size=64 in float32 and bfloat16 over 256; then
    resize=host, ingest=yuv420 and ``other_model`` once beside. Every
    extract_frames run is checked (shape, finite, timestamps, no lookup
    kernel launched, counts set to 0 just before and read just after);
    bfloat16 against float32 in the head band, batch 1 and resize=host
    against batch 64 in the value tier, yuv420 against uint8 at cosine
    0.99. Frames/s of float32 and bfloat16 in turns (F B B F), one
    profiled run of each and of batch 1. ``over`` goes into every config
    (the CPU tests run the phase with ``device=cpu`` and small models)."""
    from video_features_tpu_torch.extractors.clip import ExtractCLIP
    from video_features_tpu_torch.extractors.resnet import ExtractResNet
    from video_features_tpu_torch.kernels import corr_lookup as cl

    cls = ExtractResNet if feature_type == "resnet" else ExtractCLIP
    frames = list(synthetic_frames(n_frames, 41))

    def config(**kw):
        return frame_config(feature_type, **{**over, **kw})

    def run(ex, n_frames):
        """(features, seconds) of one checked run over the first
        ``n_frames`` frames, after one batch that sets up cuDNN."""
        used = frames[:n_frames]
        ex.extract_frames(iter(used[:ex.batch_size]), 25.0)
        reset_counts(cl)
        out, seconds = timed(ex, used)
        what = f"{feature_type} {ex.model_name} {ex.precision} " \
            f"batch {ex.batch_size} {ex.resize_mode} {ex.ingest}"
        if any(read_counts(cl).values()):
            raise AssertionError(f"{what}: lookup kernels launched "
                                 f"{read_counts(cl)}")
        feats = out[feature_type]
        want_dim = dim if ex.model_name == default_model else other_dim
        if feats.shape != (n_frames, want_dim) or feats.dtype != np.float32 \
                or not np.isfinite(feats).all():
            raise AssertionError(f"{what}: features {feats.shape} "
                                 f"{feats.dtype} or non-finite")
        if out["timestamps_ms"].tolist() != [t / 25 * 1000.0
                                             for t in range(n_frames)]:
            raise AssertionError(f"{what}: timestamps "
                                 f"{out['timestamps_ms']}")
        return feats, seconds

    batch1 = cls(config())
    default_model = batch1.model_name
    b1_feats, b1_s = run(batch1, n_batch1)
    b1_profile = profile_run(batch1, frames[:n_batch1])
    del batch1
    runs = {}
    for precision in ("float32", "bfloat16"):
        ex = cls(config(batch_size=batch, precision=precision))
        feats, seconds = run(ex, n_frames)
        runs[precision] = dict(extractor=ex, feats=feats, seconds=seconds)
    f32 = runs["float32"]["feats"]
    vs_f32 = band(runs["bfloat16"]["feats"], f32)
    if not in_head_band(vs_f32):
        raise AssertionError(f"{feature_type} bfloat16 vs float32: {vs_f32}")
    b1_vs_b64 = float(np.abs(b1_feats - f32[:n_batch1]).max())
    if not b1_vs_b64 <= VALUE_ATOL:
        raise AssertionError(f"{feature_type} batch 1 vs 64: {b1_vs_b64}")

    host = cls(config(batch_size=batch, resize="host"))
    host_feats, host_s = run(host, n_frames)
    _, transform_ms = wire_frames(host, frames[:batch])
    del host
    host_vs_device = band(host_feats, f32)
    if not host_vs_device["max_abs"] <= VALUE_ATOL:
        raise AssertionError(f"{feature_type} resize=host vs device: "
                             f"{host_vs_device}")
    yuv = cls(config(batch_size=batch, ingest="yuv420"))
    yuv_feats, yuv_s = run(yuv, n_frames)
    del yuv
    yuv_vs_uint8 = band(yuv_feats, f32)
    if not yuv_vs_uint8["cos"] >= HEAD_COS:
        raise AssertionError(f"{feature_type} yuv420 vs uint8: "
                             f"{yuv_vs_uint8}")
    other = cls(config(batch_size=batch, model_name=other_model))
    _, other_s = run(other, batch)
    del other
    empty_cache()

    turns = {"float32": [], "bfloat16": []}
    for precision in ("float32", "bfloat16", "bfloat16", "float32"):
        _, seconds = timed(runs[precision]["extractor"], frames)
        turns[precision].append(n_frames / seconds)
    flops = frame_flops(runs["float32"]["extractor"])
    batches = -(-n_frames // batch)
    stats = dict(
        model=default_model, frames=n_frames, batch_size=batch,
        gflop_per_frame=flops / 1e9, bf16_vs_f32=vs_f32,
        band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
        turns_frames_per_s=turns)
    for precision, r in runs.items():
        profile = profile_run(r["extractor"], frames)
        profile["frames"] = n_frames
        if "kernel_launches" in profile:
            profile["launches_per_batch"] = \
                profile["kernel_launches"] / batches
            profile["device_tflop_per_s"] = \
                flops * n_frames / profile["device_busy_ms"] / 1e9
        stats[precision] = dict(seconds=r["seconds"],
                                frames_per_s=n_frames / r["seconds"],
                                profile=profile)
    del runs
    empty_cache()
    if "kernel_launches" in b1_profile:
        b1_profile["launches_per_batch"] = \
            b1_profile["kernel_launches"] / n_batch1
    stats["batch1"] = dict(frames=n_batch1, seconds=b1_s,
                           frames_per_s=n_batch1 / b1_s,
                           vs_batch64_max_abs=b1_vs_b64,
                           profile=b1_profile)
    stats["resize_host"] = dict(vs_device=host_vs_device,
                                max_abs_limit=VALUE_ATOL,
                                frames_per_s=n_frames / host_s,
                                host_transform_ms_per_frame=transform_ms)
    stats["yuv420"] = dict(vs_uint8=yuv_vs_uint8, cos_limit=HEAD_COS,
                           frames_per_s=n_frames / yuv_s)
    stats[other_model] = dict(frames=batch, dim=other_dim,
                              cold_seconds=other_s)
    return stats


def vggish_config(**over):
    """The vggish YAML defaults (configs/vggish.yml: ``frontend=host``,
    float32, ``batch_size=32``), on the card, with seeded weights."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="vggish", batch_size=32, postprocess=False,
               pca_weights_path=None, device="cuda", video_decode="inline",
               on_extraction="print", output_path="output/chip_smoke",
               tmp_path="tmp/chip_smoke", keep_tmp_files=False,
               show_pred=False, weights_path=None, allow_random_weights=True,
               precision="float32", frontend="host")
    cfg.update(over)
    return Config(cfg)


def write_wav(path: str, seconds: float, rate: int, channels: int,
              seed: int) -> str:
    """A seeded 16-bit PCM WAV (stdlib ``wave``): noise under a few
    drifting tones, ``channels`` channels at ``rate`` Hz."""
    import wave
    rng = np.random.default_rng(seed)
    n = round(seconds * rate)
    t = np.arange(n) / rate
    tones = sum(0.1 * np.sin(2 * np.pi * f * t * (1 + 0.01 * np.sin(t / 7)))
                for f in (220.0, 440.0, 1375.0))
    data = np.stack([tones + rng.normal(0, 0.05, n) for _ in range(channels)],
                    axis=-1)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((data.clip(-1, 1) * 32767).astype("<i2").tobytes())
    return path


def vggish_flops() -> float:
    """Forward FLOPs per 0.96 s example of VGGish
    (``torch.utils.flop_counter`` on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    from video_features_tpu_torch.models.vggish import VGGish

    with torch.device("meta"):
        model = VGGish()
        x = torch.zeros((1, 96, 64, 1))
    with FlopCounterMode(display=False) as counter:
        model(x)
    return float(counter.get_total_flops())


def vggish_phase(n_examples: int = VGGISH_EXAMPLES,
                 stereo_seconds: float = VGGISH_STEREO_SECONDS,
                 **over) -> dict:
    """VGGish through ``ExtractVGGish.extract(path)`` on a seeded 16 kHz
    mono WAV of ``n_examples`` examples (600.015 s for 625): the YAML
    defaults
    (``frontend=host``, float32, ``batch_size=32``), ``frontend=device``,
    and both frontends in bfloat16, in turns; then a 44.1 kHz stereo WAV
    of ``stereo_seconds`` once (the mono mix and ``resample_poly``). Each
    run: (N, 128) finite embeddings, no lookup kernel launched (counts set
    to 0 just before and read just after). Device frontend against host in
    float32 within 1e-3, the card's ``logmel_examples`` on the first batch
    against the numpy frontend within 1e-4, bfloat16 against float32 in
    the head band. Examples/s of each run, the host frontend's ms per
    example, FLOPs per example, the device TFLOP/s they imply, and one
    profile of each float32 frontend. ``over`` goes into every config
    (the CPU tests run the phase with ``device=cpu`` on short audio)."""
    import os
    from video_features_tpu_torch.extractors.vggish import ExtractVGGish
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.ops import audio

    wav_dir = os.path.join("output", "chip_smoke", "vggish")
    os.makedirs(wav_dir, exist_ok=True)
    seconds = ((n_examples - 1) * audio.EXAMPLE_HOP_SAMPLES
               + audio.EXAMPLE_CHUNK_SAMPLES) / audio.SAMPLE_RATE
    mono = write_wav(os.path.join(wav_dir, "mono16k.wav"), seconds, 16000,
                     1, 61)
    stereo = write_wav(os.path.join(wav_dir, "stereo44k.wav"),
                       stereo_seconds, 44100, 2, 62)

    def run(ex, path, rows):
        """(embeddings, seconds) of one checked ``extract(path)``."""
        reset_counts(cl)
        synchronize()
        t0 = time.perf_counter()
        out = ex.extract(path)
        synchronize()
        sec = time.perf_counter() - t0
        what = f"vggish {ex.frontend} {ex.precision} {path}"
        if any(read_counts(cl).values()):
            raise AssertionError(f"{what}: lookup kernels launched "
                                 f"{read_counts(cl)}")
        feats = out["vggish"]
        if set(out) != {"vggish"} or feats.shape != (rows, 128) \
                or feats.dtype != np.float32 or not np.isfinite(feats).all():
            raise AssertionError(f"{what}: embeddings {feats.shape} "
                                 f"{feats.dtype} or non-finite")
        return feats, sec

    names = [(f, p) for p in ("float32", "bfloat16")
             for f in ("host", "device")]
    exs = {(f, p): ExtractVGGish(vggish_config(**{**over, "frontend": f,
                                                  "precision": p}))
           for f, p in names}
    runs = {}
    for key in names:  # the first run of each sets up cuDNN and cuFFT
        run(exs[key], mono, n_examples)
        runs[key] = run(exs[key], mono, n_examples)
    host32, dev32 = runs[("host", "float32")][0], \
        runs[("device", "float32")][0]
    device_vs_host = float(np.abs(dev32 - host32).max())
    if not device_vs_host <= VGGISH_FRONTEND_ATOL:
        raise AssertionError(f"vggish device vs host frontend: "
                             f"{device_vs_host}")
    bands = {f"{f}_bf16_vs_f32": band(runs[(f, "bfloat16")][0],
                                      runs[(f, "float32")][0])
             for f in ("host", "device")}
    if not all(in_head_band(b) for b in bands.values()):
        raise AssertionError(f"vggish bfloat16 vs float32: {bands}")

    data, rate = audio.read_wav(mono)
    t0 = time.perf_counter()
    examples = audio.waveform_to_examples(data, rate)
    host_ms = (time.perf_counter() - t0) * 1e3 / len(examples)
    chunks = torch.from_numpy(audio.chunk_waveform(data, rate)[:32])
    dev = exs[("device", "float32")].device
    with torch.inference_mode():
        logmel = audio.logmel_examples(chunks.to(dev)).cpu().numpy()
    logmel_err = float(np.abs(logmel - examples[:32]).max())
    if not logmel_err <= VGGISH_LOGMEL_ATOL:
        raise AssertionError(f"vggish logmel_examples vs numpy: "
                             f"{logmel_err}")
    stereo_rows = 1 + (int(stereo_seconds * 16000)
                       - audio.EXAMPLE_CHUNK_SAMPLES) \
        // audio.EXAMPLE_HOP_SAMPLES
    _, stereo_s = run(exs[("host", "float32")], stereo, stereo_rows)

    turns = {f"{f}_{p}": [] for f, p in names}
    for key in names + names[::-1]:
        _, sec = run(exs[key], mono, n_examples)
        turns[f"{key[0]}_{key[1]}"].append(n_examples / sec)
    flops = vggish_flops()
    batches = -(-n_examples // exs[names[0]].batch_size)
    stats = dict(seconds_of_audio=seconds, examples=n_examples,
                 batch_size=exs[names[0]].batch_size,
                 gflop_per_example=flops / 1e9,
                 host_frontend_ms_per_example=host_ms,
                 device_vs_host_f32_max_abs=device_vs_host,
                 device_vs_host_limit=VGGISH_FRONTEND_ATOL,
                 logmel_vs_numpy_max_abs=logmel_err,
                 logmel_limit=VGGISH_LOGMEL_ATOL, bands=bands,
                 band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
                 stereo44k=dict(seconds_of_audio=stereo_seconds,
                                examples=stereo_rows,
                                examples_per_s=stereo_rows / stereo_s),
                 turns_examples_per_s=turns)
    for (f, p), (_, sec) in runs.items():
        stats[f"{f}_{p}"] = dict(seconds=sec,
                                 examples_per_s=n_examples / sec)
    for f in ("host", "device"):
        ex = exs[(f, "float32")]
        profile = profile_call(lambda ex=ex: ex.extract(mono))
        if "kernel_launches" in profile:
            profile["launches_per_batch"] = \
                profile["kernel_launches"] / batches
            profile["device_tflop_per_s"] = \
                flops * n_examples / profile["device_busy_ms"] / 1e9
        stats[f"{f}_float32"]["profile"] = profile
    del exs
    empty_cache()
    return stats


def parallel_devices(dev) -> list:
    """The two devices of the parallel phase: two cards where the machine
    has them, else two replicas on ``cuda:0`` (the CPU twice in the
    tests)."""
    if dev.type != "cuda":
        return [dev, dev]
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    return [torch.device("cuda", 0)] * 2


def parallel_raft(devices, n_frames: int = 2 * RAFT_BATCH + 1,
                  timed_turns: bool = True, **over):
    """(a) The raft family in float32 with ``batch_size=32`` on a two-device
    mesh against the one-device run: flows within 1e-3 px; on the card, proj
    launched 20 times per forward on each replica (counted by forward hooks
    around each replica's RAFT; a replica's forwards launch in turn on one
    thread), level and packed never; pairs/s of both in turns (O T T O).
    ``timed_turns=False`` (the CPU test) leaves the turns out, as in the
    other parts."""
    from video_features_tpu_torch.extractors.raft import ExtractRAFT
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.parallel.mesh import get_mesh

    frames = list(synthetic_frames(n_frames, 21))
    cfg = raft_config("output/chip_smoke", precision="float32", **over)
    one = ExtractRAFT(cfg)
    two = ExtractRAFT(cfg, mesh=get_mesh(devices=devices))
    per_replica = [{"forwards": 0, "proj": 0} for _ in two.runner.replicas]
    for replica, tally in zip(two.runner.replicas, per_replica):
        def pre(module, args, _tally=tally):
            _tally["start"] = cl.corr_lookup_proj_cuda.launches

        def post(module, args, out, _tally=tally):
            _tally["forwards"] += 1
            _tally["proj"] += cl.corr_lookup_proj_cuda.launches - \
                _tally.pop("start")
        replica.register_forward_pre_hook(pre)
        replica.register_forward_hook(post)
    if timed_turns:  # cuDNN set-up at these shapes
        one.extract_frames(iter(frames), 25.0)
        two.extract_frames(iter(frames), 25.0)
    want_flow = one.extract_frames(iter(frames), 25.0)["raft"]
    for tally in per_replica:
        tally.update(forwards=0, proj=0)
    reset_counts(cl)
    got, _ = timed(two, frames)
    counts = read_counts(cl)
    per_replica = [dict(t) for t in per_replica]  # the turns count on
    err = float(np.abs(got["raft"] - want_flow).max())
    if got["raft"].shape != want_flow.shape or not err <= 1e-3:
        raise AssertionError(f"raft on two devices vs one: {err} px")
    on_card = devices[0].type == "cuda"
    forwards = sum(t["forwards"] for t in per_replica)
    if on_card and (counts != {"level": 0, "packed": 0,
                               "proj": ITERS * forwards}
                    or any(t["proj"] != ITERS * t["forwards"]
                           or t["forwards"] == 0 for t in per_replica)):
        raise AssertionError(f"raft on two devices: launches {counts}, "
                             f"per replica {per_replica}")
    pairs = n_frames - 1
    stats = dict(devices=[str(d) for d in devices], pairs=pairs,
                 batch_size=two.batch_size, precision="float32",
                 vs_one_device_max_px=err, max_px_limit=1e-3,
                 launches=counts, per_replica=per_replica,
                 proj_per_forward_per_replica=[
                     t["proj"] / max(t["forwards"], 1) for t in per_replica])
    if timed_turns:
        turns = {"one": [], "two": []}
        for name in ("one", "two", "two", "one"):
            _, seconds = timed(one if name == "one" else two, frames)
            turns[name].append(pairs / seconds)
        stats["turns_pairs_per_s"] = turns
    return stats


class _GroupSizes:
    """``runner.dispatch`` that records each dispatched group's size."""

    def __init__(self, runner) -> None:
        self.runner = runner
        self.sizes = []

    def dispatch(self, group):
        self.sizes.append(len(group))
        return self.runner.dispatch(group)


def feed_videos(extractor, videos, workers: int, keep_open: bool):
    """Each video's frames through ``extractor.extract_frames`` on
    ``workers`` threads; returns (per-video features, seconds).

    A feed lock is held from a video's first frame to its last, so that its
    clips enter a packer contiguously, and with ``keep_open`` a keeper
    handle holds the packer open until every video has been fed (as a long
    video still decoding would). Without them a packed run can dispatch a
    short group before the end: the packer flushes when every open video
    is closing, and with 3 workers interleaved adds can leave all three
    closing on a part-filled group while videos wait, and a worker between
    two videos leaves the others alone with it. With contiguous adds of
    these clip counts no three closing videos hold the part-filled group
    in any interleaving (``tools/packer_interleavings.py``), so the keeper
    closes only when everything is fed."""
    from concurrent.futures import ThreadPoolExecutor
    import threading

    feed_lock = threading.Lock()
    fed = threading.Semaphore(0)

    def fed_frames(frames):
        with feed_lock:
            yield from frames
        fed.release()

    def one(frames):
        return extractor.extract_frames(fed_frames(frames), 25.0)[
            extractor.feature_type]

    packer = extractor._get_packer() if keep_open else None
    keeper = packer.open_video() if keep_open else None
    synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(one, frames) for frames in videos]
        stalled = not all(fed.acquire(timeout=120) for _ in videos)
        if keep_open:
            packer.close_video(keeper)
        feats = [f.result(timeout=300) for f in futures]
    synchronize()
    seconds = time.perf_counter() - t0
    if stalled:
        raise AssertionError("packed feed stalled: a part-filled group "
                             "held every worker")
    return feats, seconds


def parallel_packed(lengths=PACKED_VIDEOS, workers: int = PACKED_WORKERS,
                    timed_turns: bool = True, **over):
    """(b) r21d at its YAML defaults with ``cross_video_batching=true``:
    ``len(lengths)`` seeded videos through ``extract_frames`` on
    ``workers`` threads (:func:`feed_videos`), against the same videos
    unpacked: per-video features within 1e-4, ceil(clips / group) groups
    with only the last short; clips/s of both in turns (U P P U)."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.utils.lists import form_slices

    videos = [list(synthetic_frames(n, 50 + i))
              for i, n in enumerate(lengths)]
    plain = ExtractR21D(clip_config("r21d", **over))
    packed = ExtractR21D(clip_config("r21d", cross_video_batching=True,
                                     **over))
    clips = [len(form_slices(n, plain.stack_size, plain.step_size))
             for n in lengths]
    batch = packed.clip_batch_size
    packer = packed._get_packer()
    packer.runner = _GroupSizes(packer.runner)
    if timed_turns:
        plain.extract_frames(iter(videos[0]), 25.0)  # cuDNN set-up
    want, plain_s = feed_videos(plain, videos, workers, keep_open=False)
    packer.runner.sizes.clear()
    got, packed_s = feed_videos(packed, videos, workers, keep_open=True)
    sizes = list(packer.runner.sizes)
    total = sum(clips)
    if sizes != [batch] * (total // batch) + ([total % batch]
                                              if total % batch else []):
        raise AssertionError(f"packed groups {sizes} for {total} clips")
    err = 0.0
    for g, w, n in zip(got, want, clips):
        if g.shape != (n, 512) or w.shape != (n, 512):
            raise AssertionError(f"packed {g.shape} / plain {w.shape}")
        err = max(err, float(np.abs(g - w).max()))
    if not err <= 1e-4:
        raise AssertionError(f"packed vs unpacked r21d: {err}")
    stats = dict(videos=len(lengths), frames=list(lengths), clips=clips,
                 workers=workers, clip_batch_size=batch, group_sizes=sizes,
                 vs_unpacked_max_abs=err, max_abs_limit=1e-4,
                 first_clips_per_s=dict(unpacked=total / plain_s,
                                        packed=total / packed_s))
    if timed_turns:
        turns = {"unpacked": [], "packed": []}
        for name in ("unpacked", "packed", "packed", "unpacked"):
            ex = packed if name == "packed" else plain
            _, seconds = feed_videos(ex, videos, workers,
                                     keep_open=name == "packed")
            turns[name].append(total / seconds)
        stats["turns_clips_per_s"] = turns
    return stats


def parallel_clip_tp(devices, n_frames: int = TP_FRAMES,
                     timed_turns: bool = True, **over):
    """(c) CLIP at the clip YAML defaults (ViT-B/32, float32,
    ``resize=device``) with ``model_parallel=2`` over a ``(data=1,
    model=2)`` mesh of ``devices``, against ``model_parallel=1``: features
    within 1e-4; each shard's ``in_proj_weight`` (3E/2, E); frames/s of
    both in turns (R T T R)."""
    from video_features_tpu_torch.extractors.clip import ExtractCLIP
    from video_features_tpu_torch.parallel.mesh import get_mesh

    frames = list(synthetic_frames(n_frames, 61))
    cfg = dict(batch_size=n_frames, **over)
    ref = ExtractCLIP(frame_config("clip", **cfg))
    tp = ExtractCLIP(frame_config("clip", model_parallel=2, **cfg),
                     mesh=get_mesh(devices=devices,
                                   axis_names=("data", "model"),
                                   shape=(1, 2)))
    e = tp.cfg.vision_width
    attn = tp.runner.replicas[0]["model"].visual.transformer \
        .resblocks[0].attn
    shapes = [tuple(s.in_proj_weight.shape) for s in attn.shards]
    if shapes != [(3 * e // 2, e)] * 2 or \
            [s.device for s in attn.shards] != list(devices):
        raise AssertionError(f"TP shards {shapes} on "
                             f"{[str(s.device) for s in attn.shards]}")
    if timed_turns:  # cuDNN set-up
        ref.extract_frames(iter(frames), 25.0)
        tp.extract_frames(iter(frames), 25.0)
    want, _ = timed(ref, frames)
    got, _ = timed(tp, frames)
    err = float(np.abs(got["clip"] - want["clip"]).max())
    if got["clip"].shape != want["clip"].shape or not err <= 1e-4:
        raise AssertionError(f"CLIP model_parallel=2 vs 1: {err}")
    stats = dict(devices=[str(d) for d in devices],
                 mesh=tp.runner.mesh.shape, model=tp.model_name,
                 frames=n_frames, in_proj_weight_shards=shapes,
                 vs_replicated_max_abs=err, max_abs_limit=1e-4)
    if timed_turns:
        turns = {"replicated": [], "tensor_parallel": []}
        for name in ("replicated", "tensor_parallel", "tensor_parallel",
                     "replicated"):
            _, seconds = timed(ref if name == "replicated" else tp, frames)
            turns[name].append(n_frames / seconds)
        stats["turns_frames_per_s"] = turns
    return stats


def parallel_stream(n_frames: int = R21D_FRAMES, timed_turns: bool = True,
                    **over):
    """(d) r21d ``extract_frames`` at the YAML defaults through its
    FeatureStream at depth 4 against depth 0 (synchronous), one extractor
    switched between them: the features identical; clips/s in turns (4 0 0
    4) and one profiled run of each (the card's busy share: how much the
    next group's host transform now overlaps the card)."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D

    frames = list(synthetic_frames(n_frames, 71))
    ex = ExtractR21D(clip_config("r21d", **over))
    if timed_turns:
        ex.extract_frames(iter(frames[:R21D_STACK]), 25.0)  # cuDNN set-up
    feats, turns = {}, {4: [], 0: []}
    for depth in ((4, 0, 0, 4) if timed_turns else (4, 0)):
        ex.stream_depth = depth
        out, seconds = timed(ex, frames)
        feats.setdefault(depth, out["r21d"])
        turns[depth].append(len(out["r21d"]) / seconds)
    if not np.array_equal(feats[4], feats[0]):
        raise AssertionError("r21d depth=4 and depth=0 features differ: "
                             f"{float(np.abs(feats[4] - feats[0]).max())}")
    stats = dict(frames=n_frames, clips=len(feats[4]))
    if timed_turns:
        stats["turns_clips_per_s"] = {f"depth{d}": v
                                      for d, v in turns.items()}
        for depth in (4, 0):
            ex.stream_depth = depth
            stats[f"depth{depth}_profile"] = profile_run(ex, frames)
    return stats


def parallel_phase(dev) -> dict:
    """The parallel plane at full width: (a) raft over two devices, (b)
    r21d cross-video packing, (c) CLIP tensor parallelism, (d) the
    FeatureStream's overlap."""
    devices = parallel_devices(dev)
    stats = dict(devices=[str(d) for d in devices],
                 two_cards=devices[0] != devices[1])
    stats["raft"] = parallel_raft(devices)
    empty_cache()
    stats["packed_r21d"] = parallel_packed()
    stats["clip_tensor_parallel"] = parallel_clip_tp(devices)
    empty_cache()
    stats["feature_stream"] = parallel_stream()
    empty_cache()
    return stats


#: the multi phase: the vendored sample (320x240, 19.62 fps, 355 frames,
#: no audio track) and the seconds of the seeded WAV that stands in for
#: its rip
SAMPLE_VIDEO = "tests/assets/v_synth_sample.mp4"
SAMPLE_SECONDS = 355 / 19.62
#: families of the multi phase, in the order they are listed
MULTI_FAMILIES = ("i3d", "r21d", "resnet", "clip", "vggish")
#: shared against single runs: float32 on one card, expected 0.0
MULTI_ATOL = 1e-4


def multi_configs(root: str, cache_dir: str, **over) -> dict:
    """The multi phase's configs at published widths: i3d two-stream with
    ``flow_type=raft`` at its YAML defaults (20 iterations, stack = step =
    64, ``flow_stack_batch=auto``, ``clip_batch_size=8``, float32), r21d and
    vggish at their YAML defaults, resnet50 and ViT-B/32 at
    ``batch_size=64``; every family with ``save_numpy``, ``resize=auto``
    (the device resize) and ``cache=true`` into ``cache_dir``, its outputs
    under ``root/<family>``. ``over`` maps a family to its own overrides
    (the CPU test's small sizes)."""
    cfgs = {
        "i3d": slice_config(root, flow_iters=None, flow_stack_batch="auto",
                            clip_batch_size=8, resize="auto"),
        "r21d": clip_config("r21d"),
        "resnet": frame_config("resnet", batch_size=64, resize="auto"),
        "clip": frame_config("clip", batch_size=64, resize="auto"),
        "vggish": vggish_config(),
    }
    for family, cfg in cfgs.items():
        cfg.update(on_extraction="save_numpy", cache=True,
                   cache_dir=cache_dir, cache_scope="shared",
                   retry_attempts=1, output_path=f"{root}/{family}",
                   tmp_path=f"{root}/tmp/{family}")
        cfg.update(over.get(family, {}))
    return cfgs


class StubRip:
    """Stands in for ``utils/io.py extract_wav_from_mp4`` (the sample has no
    audio track and the card's machine no guaranteed ffmpeg): a seeded 16
    kHz mono WAV of ``seconds``, and an empty aac, per call."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.calls = 0

    def __call__(self, video_path: str, tmp_path: str):
        import os
        self.calls += 1
        os.makedirs(tmp_path, exist_ok=True)
        stem = os.path.splitext(os.path.basename(video_path))[0]
        wav = write_wav(os.path.join(tmp_path, f"{stem}.wav"), self.seconds,
                        16000, 1, seed=11)
        aac = os.path.join(tmp_path, f"{stem}.aac")
        open(aac, "wb").close()
        return wav, aac


def read_outputs(root: str) -> dict:
    """``{relative path: array}`` of every ``.npy`` under ``root``."""
    from pathlib import Path
    return {str(p.relative_to(root)): np.load(p)
            for p in sorted(Path(root).rglob("*.npy"))}


def multi_phase(video: str = SAMPLE_VIDEO, seconds: float = SAMPLE_SECONDS,
                timed_turns: bool = True, **over) -> dict:
    """The multi-family run on one video: ``MultiExtractor`` over one
    shared decode (``parallel/fanout.py``) against each family run alone
    (``_extract`` with a private decode), with the same extractors, so the
    same weights. (1) Equality: each family's outputs of the shared run
    against its single run (max abs, limit 1e-4), proj's launches equal in
    both i3d runs. (2) One decode: the frames the bus decoded against the
    sum of the private sources'. (3) Cache: two shared passes with
    ``cache=true`` into a fresh cache and fresh outputs; the second serves
    every family from the store: no frame decoded, no rip, no proj launch,
    outputs bit-equal to the first. (4) Times: shared and singles in turns
    (S, singles, singles, S; each run into fresh outputs and a fresh
    cache), one profile of a shared run. ``over`` maps a family to its own
    overrides (the CPU test's small sizes)."""
    import cv2  # noqa: F401  (the decode of the mp4; fail here without it)
    import os
    import shutil

    from video_features_tpu_torch.cache import cache_stats
    from video_features_tpu_torch.extractors import vggish as vggish_mod
    from video_features_tpu_torch.extractors.multi import MultiExtractor
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.registry import get_extractor_cls
    from video_features_tpu_torch.utils import io as vio

    root, cache_dir = "output/chip_smoke/multi", "output/chip_smoke/mcache"
    cfgs = multi_configs(root, cache_dir, **over)
    t0 = time.perf_counter()
    exts = {f: get_extractor_cls(f)(cfg) for f, cfg in cfgs.items()}
    build_s = time.perf_counter() - t0
    multi = MultiExtractor(cfgs, extractors=exts)
    rip = StubRip(seconds)
    real_rip = vggish_mod.extract_wav_from_mp4
    vggish_mod.extract_wav_from_mp4 = rip

    def fresh(cache: bool = True) -> None:
        shutil.rmtree(root, ignore_errors=True)
        if cache:
            shutil.rmtree(cache_dir, ignore_errors=True)

    def shared() -> dict:
        """One shared run: wall seconds, frames decoded, rips, proj."""
        rip.calls = 0
        reset_counts(cl)
        synchronize()
        t = time.perf_counter()
        statuses = multi.run_video(video)
        synchronize()
        wall = time.perf_counter() - t
        if statuses != dict.fromkeys(MULTI_FAMILIES, "done"):
            raise AssertionError(f"multi: shared run statuses {statuses}")
        bus = multi.last_session.bus
        return dict(seconds=wall, decoded=bus.decoded if bus else 0,
                    rips=rip.calls, proj=read_counts(cl)["proj"])

    def singles() -> dict:
        """Each family alone, in turn: seconds each, frames decoded."""
        out = dict(seconds={}, decoded=0, rips=0, proj=0)
        rip.calls = 0
        for family, ext in exts.items():
            reset_counts(cl)
            before = vio.decoded_frames()
            synchronize()
            t = time.perf_counter()
            if ext._extract(video) is None:
                raise AssertionError(f"multi: single {family} skipped")
            synchronize()
            out["seconds"][family] = time.perf_counter() - t
            out["decoded"] += vio.decoded_frames() - before
            if family == "i3d":
                out["proj"] = read_counts(cl)["proj"]
        out["rips"] = rip.calls
        return out

    try:
        # the singles first: they set up cuDNN at every shape and give
        # each family's reference outputs
        fresh()
        single0 = singles()
        want = read_outputs(root)
        fresh()
        shared0 = shared()
        got = read_outputs(root)
        if sorted(got) != sorted(want) or not want:
            raise AssertionError(f"multi: outputs {sorted(got)} against "
                                 f"{sorted(want)}")
        max_abs = {}
        for family in MULTI_FAMILIES:
            errs = [float(np.abs(got[k].astype(np.float64)
                                 - want[k].astype(np.float64)).max())
                    if got[k].size else 0.0
                    for k in want if k.startswith(family + "/")]
            if not errs:
                raise AssertionError(f"multi: no outputs of {family}")
            max_abs[family] = max(errs)
            if not max_abs[family] <= MULTI_ATOL:
                raise AssertionError(f"multi: {family} shared vs single "
                                     f"max abs {max_abs[family]}")
        if shared0["proj"] != single0["proj"]:
            raise AssertionError(f"multi: proj launches shared "
                                 f"{shared0['proj']}, single "
                                 f"{single0['proj']}")
        on_card = next(iter(exts.values())).device.type == "cuda"
        if on_card and cfgs["i3d"].get("streams") in (None, "flow") \
                and shared0["proj"] == 0:
            raise AssertionError("multi: proj never launched")
        if not 0 < shared0["decoded"] < single0["decoded"]:
            raise AssertionError(f"multi: the bus decoded "
                                 f"{shared0['decoded']} frames, the "
                                 f"private sources {single0['decoded']}")
        if (shared0["rips"], single0["rips"]) != (1, 1):
            raise AssertionError(f"multi: rips shared {shared0['rips']}, "
                                 f"single {single0['rips']}")

        # (3) the cache: a miss that stores, then all hits
        fresh()
        store_pass = shared()
        first = {k: v.tobytes() for k, v in read_outputs(root).items()}
        fresh(cache=False)
        hit_pass = shared()
        second = {k: v.tobytes() for k, v in read_outputs(root).items()}
        if (hit_pass["decoded"], hit_pass["rips"], hit_pass["proj"]) != \
                (0, 0, 0):
            raise AssertionError(f"multi: the all-hit pass {hit_pass}")
        if second != first:
            raise AssertionError("multi: the all-hit pass's outputs differ "
                                 "from the storing pass's")
        stats = cache_stats(cache_dir)
        if stats["entries"] != len(MULTI_FAMILIES):
            raise AssertionError(f"multi: cache entries {stats}")
        lookup_ms = {}
        for family, ext in exts.items():
            t = time.perf_counter()
            if ext.feature_cache().lookup(video,
                                          ext.output_feat_keys) is None:
                raise AssertionError(f"multi: no entry for {family}")
            lookup_ms[family] = (time.perf_counter() - t) * 1e3

        # (4) times in turns, then one profiled shared run
        turns = {"shared_s": [], "singles_s": [], "singles_by_family": []}
        if timed_turns:
            for kind in ("shared", "singles", "singles", "shared"):
                fresh()
                if kind == "shared":
                    turns["shared_s"].append(shared()["seconds"])
                else:
                    each = singles()["seconds"]
                    turns["singles_s"].append(sum(each.values()))
                    turns["singles_by_family"].append(each)
        fresh()
        profile = profile_call(lambda: multi.run_video(video))
        fresh()
    finally:
        vggish_mod.extract_wav_from_mp4 = real_rip
    n = len(MULTI_FAMILIES)
    shared_s = turns["shared_s"] or [shared0["seconds"]]
    singles_s = turns["singles_s"] or [sum(single0["seconds"].values())]
    return dict(
        video=video, families=list(MULTI_FAMILIES), rip="stub",
        build_s=build_s, max_abs_shared_vs_single=max_abs,
        max_abs_limit=MULTI_ATOL,
        proj_launches={"shared": shared0["proj"],
                       "single": single0["proj"],
                       "all_hit_pass": hit_pass["proj"]},
        frames_decoded={"shared_bus": shared0["decoded"],
                        "singles_sum": single0["decoded"],
                        "all_hit_pass": hit_pass["decoded"]},
        rips={"shared": shared0["rips"], "singles": single0["rips"],
              "all_hit_pass": hit_pass["rips"]},
        cache={"entries": stats["entries"], "bytes": stats["bytes"],
               "by_family": stats["families"],
               "store_pass_s": store_pass["seconds"],
               "hit_pass_s": hit_pass["seconds"],
               "lookup_ms_per_entry": lookup_ms},
        single_seconds_first_run=single0["seconds"],
        turns_seconds=turns,
        shared_extractions_per_s=[n / s for s in shared_s],
        singles_extractions_per_s=[n / s for s in singles_s],
        shared_profile=profile)


#: the telemetry phase: the sample at 7.3 fps is 132 frames, two 64-frame
#: stacks; the run-plane keys it turns on (profile_trace_dir beside them),
#: and the retained history and alerting on top of them
TELEMETRY_FPS = 7.3
RUN_PLANE = ("telemetry=true", "trace=true", "health=true", "profile=true",
             "roofline=true", "parity=true")
ALERT_KEYS = ("history=true", "alerts=true")
TELEMETRY_ON = RUN_PLANE + ALERT_KEYS
#: the stages every span of the main path must show
TELEMETRY_STAGES = ("decode", "h2d", "forward", "write")
#: the trace spans the phase requires (profiler stages and the attempt)
TELEMETRY_SPANS = ("decode", "h2d", "forward", "write", "health",
                   "video_attempt")


def telemetry_argv(root: str, video: str, **over) -> list:
    """The CLI arguments of the telemetry phase: i3d two-stream RAFT at the
    slice's widths into ``root``; ``over`` replaces keys (the CPU test's
    small sizes)."""
    cfg = dict(feature_type="i3d", flow_type="raft", streams=None,
               flow_iters=None, flow_stack_batch=1, stack_size=STACK,
               step_size=STACK, clip_batch_size=2, resize="device",
               extraction_fps=TELEMETRY_FPS, device="cuda",
               precision="float32", allow_random_weights=True,
               on_extraction="save_numpy", retry_attempts=1,
               output_path=f"{root}/out", tmp_path=f"{root}/tmp",
               video_paths=video)
    cfg.update(over)
    return [f"{k}={'null' if v is None else v}" for k, v in cfg.items()]


def check_trace_events(doc: dict, required: dict, spans) -> set:
    """The ``X`` span names of a ``_trace.json`` document; raises unless
    every event carries its phase's required fields and every name of
    ``spans`` is there."""
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise AssertionError("telemetry: _trace.json has no events")
    for ev in events:
        missing = [k for k in required.get(ev.get("ph"), ("ph",))
                   if k not in ev]
        if missing:
            raise AssertionError(f"telemetry: trace event {ev} lacks "
                                 f"{missing}")
    names = {e["name"] for e in events if e["ph"] == "X"}
    if not set(spans) <= names:
        raise AssertionError(f"telemetry: trace spans {sorted(names)} lack "
                             f"{sorted(set(spans) - names)}")
    return names


def telemetry_phase(video: str = SAMPLE_VIDEO, **over) -> dict:
    """The main path through ``cli.main`` with the run plane off, then on
    (:data:`TELEMETRY_ON` and ``profile_trace_dir``), from the same seeded
    weights, each run's launch counts set to 0 just before and read just
    after; then every artifact of the on run checked (module docstring,
    step 17). ``over`` replaces CLI keys (the CPU test's small sizes)."""
    import glob
    import os
    import shutil

    import cv2  # noqa: F401  (the decode of the mp4; fail here without it)

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.telemetry import (health, roofline, schema,
                                                    trace)

    root = "output/chip_smoke/telemetry"
    shutil.rmtree(root, ignore_errors=True)
    stem = os.path.splitext(os.path.basename(video))[0]
    again = f"{root}/{stem}_again.mp4"
    os.makedirs(root)
    shutil.copyfile(video, again)
    runs = {}
    # "capture_off": the run plane without the torch.profiler capture, so
    # the capture's own cost shows apart from the recorders'; "repeat": the
    # same over the sample and a copy, whose second dispatch at the same
    # shape runs without the counting pass
    for name, keys, paths in (
            ("off", (), video),
            ("on", TELEMETRY_ON + (f"profile_trace_dir={root}/prof",),
             video),
            ("capture_off", TELEMETRY_ON, video),
            ("repeat", TELEMETRY_ON, f"[{video}, {again}]")):
        argv = telemetry_argv(f"{root}/{name}", paths, **over) + list(keys)
        runs[name] = dict(run_cli(argv, cl), dir=f"{root}/{name}/out/i3d")
    on, off = runs["on"], runs["off"]
    for name, run in runs.items():
        n = 2 if name == "repeat" else 1
        if f"{n} extracted" not in run["stdout"]:
            raise AssertionError(f"telemetry: the {name} run did not "
                                 f"extract: {run['stdout'][-300:]}")

    # the features, bit for bit, and proj's launches in every run
    want = read_outputs(off["dir"])
    stacks = len(want.get(f"{stem}_timestamps_ms.npy", []))
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    proj_want = iters * stacks if on_card else 0
    max_abs = 0.0
    for name, run in runs.items():
        outs = read_outputs(run["dir"])
        again_keys = {k for k in outs if k.startswith(f"{stem}_again_")}
        # each video's outputs, the copy's under the sample's names
        videos = [{k: v for k, v in outs.items() if k not in again_keys}]
        if name == "repeat":
            videos.append({k.replace(f"{stem}_again_", f"{stem}_"): outs[k]
                           for k in again_keys})
        n = len(videos)
        for got in videos:
            if sorted(got) != sorted(want) or not want:
                raise AssertionError(f"telemetry: {name} outputs "
                                     f"{sorted(got)} against {sorted(want)}")
            err = max(float(np.abs(got[k].astype(np.float64)
                                   - want[k].astype(np.float64)).max())
                      if got[k].size else 0.0 for k in want)
            max_abs = max(max_abs, err)
            if err != 0.0 or any(got[k].tobytes() != want[k].tobytes()
                                 for k in want):
                raise AssertionError(f"telemetry: the {name} run's "
                                     f"features differ from the off run's "
                                     f"(max abs {err})")
        if run["launches"] != dict(level=0, proj=n * proj_want, packed=0):
            raise AssertionError(f"telemetry: the {name} run launched "
                                 f"{run['launches']}, proj expected "
                                 f"{n * proj_want} ({stacks} stacks a "
                                 f"video)")

    # the span
    spans = [json.loads(line) for line in
             open(f"{on['dir']}/_telemetry.jsonl") if line.strip()]
    if len(spans) != 1:
        raise AssertionError(f"telemetry: {len(spans)} spans")
    span = spans[0]
    errs = schema.validate(span, schema.load_span_schema())
    stage_s = {k: span["stages"].get(k, {}).get("s", 0.0)
               for k in TELEMETRY_STAGES}
    if errs or span["status"] != "done" or not all(
            v > 0 for v in stage_s.values()):
        raise AssertionError(f"telemetry: span {errs} {span['status']} "
                             f"{span['stages']}")

    # the heartbeat and the manifest
    beats = glob.glob(f"{on['dir']}/_heartbeat_*.json")
    if len(beats) != 1:
        raise AssertionError(f"telemetry: heartbeats {beats}")
    beat = json.load(open(beats[0]))
    manifest = json.load(open(f"{on['dir']}/_run.json"))
    card_name = torch.cuda.get_device_name(0) if on_card else None
    topo = manifest["topology"]
    if not beat["final"] or topo.get("device_name") != card_name or (
            on_card and card_name not in topo.get("device_kinds", [])):
        raise AssertionError(f"telemetry: heartbeat final {beat['final']}, "
                             f"topology {topo}")

    # one valid health record per output key, all finite
    records = [json.loads(line) for line in
               open(f"{on['dir']}/{health.HEALTH_FILENAME}")
               if line.strip()]
    keys = sorted(k[len(stem) + 1:-4] for k in want)
    bad = [r for r in records if health.validate_health(r)
           or r["nan"] or r["inf"]]
    if sorted(r["key"] for r in records) != keys or bad:
        raise AssertionError(f"telemetry: health records "
                             f"{[r['key'] for r in records]} for {keys}, "
                             f"bad {bad}")

    # the host trace and the device trace
    required = {"X": trace.REQUIRED_X_FIELDS, "i": trace.REQUIRED_I_FIELDS,
                "C": trace.REQUIRED_C_FIELDS, "M": trace.REQUIRED_M_FIELDS}
    host_spans = check_trace_events(
        json.load(open(f"{on['dir']}/{trace.TRACE_FILENAME}")), required,
        TELEMETRY_SPANS)
    prof = glob.glob(f"{root}/prof/*.pt.trace.json")
    if len(prof) != 1 or f"profile trace: {prof[0]}" not in on["stdout"]:
        raise AssertionError(f"telemetry: profiler traces {prof}")
    device_events = [e for e in json.load(open(prof[0]))["traceEvents"]
                     if e.get("cat") == "kernel"]
    proj_events = [e for e in device_events
                   if "proj_kernel" in e.get("name", "")]
    if on_card and len(proj_events) != proj_want:
        raise AssertionError(f"telemetry: the profiler trace holds "
                             f"{len(proj_events)} proj kernels of "
                             f"{len(device_events)} device events, "
                             f"{proj_want} expected")
    if "[profile: i3d x 1 videos] total accounted:" not in on["stdout"]:
        raise AssertionError("telemetry: no profile summary printed")
    rooflines = {name: check_roofline(
        json.load(open(f"{runs[name]['dir']}/{roofline.ROOFLINE_FILENAME}")),
        card_name, proj_want) for name in ("on", "capture_off", "repeat")}
    # the repeat run times its uncounted dispatch alone; the capture_off
    # run's one dispatch is its counted one, counting pass included
    rep = rooflines["repeat"]
    if rep["dispatches"] != 2 or rep["forward_calls"] != 1 or rooflines[
            "capture_off"]["forward_calls"] != 1:
        raise AssertionError(f"telemetry: repeat run dispatches "
                             f"{rep['dispatches']}, timed "
                             f"{rep['forward_calls']}")
    counting_pass_s = (rooflines["capture_off"]["forward_s"]
                       - rep["forward_s"])
    seams = check_parity(f"{on['dir']}/{parity.PARITY_FILENAME}")
    if not beat["roofline"].get("families") or not beat["parity"].get(
            "records") or manifest["roofline"].get("schema") != \
            roofline.SCHEMA_VERSION:
        raise AssertionError(f"telemetry: heartbeat roofline "
                             f"{beat['roofline']}, parity {beat['parity']}, "
                             f"manifest roofline {manifest['roofline']}")
    alert_plane = {name: check_alert_plane(runs[name]["dir"],
                                           runs[name]["stdout"])
                   for name in ("on", "capture_off", "repeat")}
    return dict(
        video=video, fps=TELEMETRY_FPS, stacks=stacks,
        wall_s={name: run["wall_s"] for name, run in runs.items()},
        max_abs_on_vs_off=max_abs,
        proj_launches={name: run["launches"]["proj"]
                       for name, run in runs.items()},
        span_stages=span["stages"], span_wall_s=span["wall_s"],
        stage_totals=manifest["stage_totals"],
        health_records=len(records), trace_spans=sorted(host_spans),
        trace_events=len(json.load(open(
            f"{on['dir']}/{trace.TRACE_FILENAME}"))["traceEvents"]),
        profiler_device_events=len(device_events),
        profiler_proj_kernels=len(proj_events),
        profiler_trace_bytes=os.path.getsize(prof[0]),
        topology_device_name=topo.get("device_name"),
        roofline=rooflines, counting_pass_s=counting_pass_s,
        parity_seams=seams,
        heartbeat_roofline=beat["roofline"], heartbeat_parity=beat["parity"],
        alert_plane=alert_plane)


def check_alert_plane(out_dir: str, stdout: str) -> dict:
    """The retained history and the alerting of one ``history=true
    alerts=true`` run in ``out_dir``: one ``_history_*.jsonl`` of at least
    two ``vft.history_sample/1`` samples, the last one the final
    heartbeat's (its ``mfu`` equal to the heartbeat's roofline MFU where
    the run counts it); the heartbeat's ``alerts`` section with no rule
    failure; both hooks registered and none failed; no history write
    failure in the manifest; no firing record but ``mfu_regression``'s,
    which is returned as a finding of the run rather than failed (its
    threshold is the JAX package's). Returns the sample count, the
    journal's (rule, state) transitions and those findings."""
    import glob
    import os

    from video_features_tpu_torch.telemetry import alerts, history, jsonl

    files = glob.glob(f"{out_dir}/{history.HISTORY_GLOB}")
    samples = history.read_history(out_dir)
    beat = json.load(open(glob.glob(f"{out_dir}/_heartbeat_*.json")[0]))
    series = samples.get(beat["host_id"], [])
    manifest = json.load(open(f"{out_dir}/_run.json"))
    if len(files) != 1 or len(series) < 2 or len(samples) != 1 or any(
            s.get("schema") != history.SAMPLE_SCHEMA for s in series):
        raise AssertionError(f"alerts: history {files}, {len(series)} "
                             f"samples of {list(samples)}")
    last = series[-1]
    fams = (beat.get("roofline") or {}).get("families") or {}
    if not last["final"] or last["videos"] != history.sample_from_heartbeat(
            beat)["videos"] or any(
            (last.get("mfu") or {}).get(f) != v.get("mfu")
            for f, v in fams.items()):
        raise AssertionError(f"alerts: the last sample {last} is not the "
                             f"final heartbeat's (roofline {fams})")
    section = beat.get("alerts")
    write_failures = [s for s in manifest["metrics"]["series"]
                      if s["name"] == "vft_telemetry_write_failures_total"]
    if not isinstance(section, dict) or section.get("eval_errors") != 0 \
            or "heartbeat hooks: 2 registered, 0 failed" not in stdout \
            or write_failures:
        raise AssertionError(f"alerts: heartbeat section {section}, write "
                             f"failures {write_failures}, hooks "
                             f"{[ln for ln in stdout.splitlines() if 'hook' in ln]}")
    records = list(jsonl.read_jsonl(
        os.path.join(out_dir, alerts.ALERTS_FILENAME)))
    firing = [r for r in records if r["state"] == "firing"]
    if any(alerts.validate_alert(r) for r in records) or any(
            r["rule"] != "mfu_regression" for r in firing):
        raise AssertionError(f"alerts: firing on a clean run: {firing}")
    return dict(samples=len(series), last_mfu=last.get("mfu"),
                samples_with_mfu=sum(
                    any(v is not None for v in (s.get("mfu") or {}).values())
                    for s in series),
                transitions=[(r["rule"], r["state"]) for r in records],
                mfu_regression=[{k: r[k] for k in (
                    "scope", "value", "threshold", "summary")}
                    for r in firing])


#: the alerts phase: one 64-frame stack of the sample (4 fps: 72 frames),
#: an ENOSPC injected at the first feature write, one attempt
ALERTS_FPS = 4.0
ALERTS_INJECT = "seed=0;sink.fsync=enospc@n1"
ALERTS_ROOT = "output/chip_smoke/alerts"
#: the heartbeat intervals of the cost turns (None: the YAML default, 30 s)
ALERTS_INTERVALS = (0.3, None)
#: evaluations timed on a clean run's tree
EVAL_REPS = 20
PROM_LINE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.e+-]+$'


def run_cli(argv, cl) -> dict:
    """``cli.main(argv)`` with the launch counts set to 0 just before and
    read just after: its wall, launches and stdout."""
    import contextlib
    import io

    from video_features_tpu_torch import cli

    buf = io.StringIO()
    reset_counts(cl)
    synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    synchronize()
    return dict(wall_s=time.perf_counter() - t, launches=read_counts(cl),
                stdout=buf.getvalue())


def alerts_phase(video: str = SAMPLE_VIDEO, intervals=ALERTS_INTERVALS,
                 **over) -> dict:
    """The alerting on the main path (module docstring, step 18): the
    telemetry phase's argv over one stack with :data:`ALERTS_INJECT`,
    ``retry_attempts=1``, ``metrics_interval_s=0.3`` and ``telemetry trace
    roofline history alerts`` fires one ``failure_spike`` with a bundle,
    which a later one-shot evaluation resolves; then the cost turns; then
    the rules' evaluation timed on a clean run's tree. ``over`` replaces
    CLI keys (the CPU test's small sizes)."""
    import contextlib
    import glob
    import io
    import os
    import shutil

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.telemetry import alerts, history, jsonl

    shutil.rmtree(ALERTS_ROOT, ignore_errors=True)
    os.makedirs(ALERTS_ROOT)
    stem = os.path.splitext(os.path.basename(video))[0]
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    card_name = torch.cuda.get_device_name(0) if on_card else None

    # the fault run: its one stack runs through RAFT, then the write fails
    argv = telemetry_argv(f"{ALERTS_ROOT}/fault", video, **{
        "extraction_fps": ALERTS_FPS, **over}) + [
        "telemetry=true", "trace=true", "roofline=true", *ALERT_KEYS,
        "metrics_interval_s=0.3", f"inject={ALERTS_INJECT}"]
    fault = run_cli(argv, cl)
    out_dir = f"{ALERTS_ROOT}/fault/out/i3d"
    proj_want = iters if on_card else 0
    if "0 extracted" not in fault["stdout"] or "1 failed" not in \
            fault["stdout"] or fault["launches"] != dict(
            level=0, proj=proj_want, packed=0):
        raise AssertionError(f"alerts: the fault run launched "
                             f"{fault['launches']}, proj expected "
                             f"{proj_want}: {fault['stdout'][-400:]}")
    records = list(jsonl.read_jsonl(
        f"{out_dir}/{alerts.ALERTS_FILENAME}"))
    firing = [r for r in records if r["state"] == "firing"]
    if any(alerts.validate_alert(r) for r in records) or \
            [r["rule"] for r in firing] != ["failure_spike"] or \
            not firing[0]["incident"]:
        raise AssertionError(f"alerts: records {records}")
    bundle = f"{out_dir}/{firing[0]['incident']}"
    errs = alerts.verify_incident(bundle)
    man = json.load(open(f"{bundle}/manifest.json"))
    paths = [a["path"] for a in man["artifacts"]]
    rf = (json.load(open(f"{bundle}/roofline.json"))
          if "roofline.json" in paths else {})
    beat = json.load(open(glob.glob(f"{out_dir}/_heartbeat_*.json")[0]))
    samples = history.read_history(out_dir).get(beat["host_id"], [])
    if errs or not (rf.get("device") or {}).get("device_kind") or (
            on_card and rf["device"]["device_kind"] != card_name) or not any(
            "_failures" in p for p in paths) or not samples or samples[-1][
            "videos"]["error"] != 1 or beat["alerts"]["eval_errors"] != 0 \
            or "heartbeat hooks: 2 registered, 0 failed" not in \
            fault["stdout"]:
        raise AssertionError(f"alerts: bundle {errs} {paths}, roofline "
                             f"{rf.get('device')}, {len(samples)} samples, "
                             f"heartbeat alerts {beat.get('alerts')}")
    # the failure leaves a window shrunk below the time since: resolved
    time.sleep(0.3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = alerts.main([out_dir, "--window", "0.05"])
    final = list(jsonl.read_jsonl(
        f"{out_dir}/{alerts.ALERTS_FILENAME}"))
    if rc != 0 or alerts.current_alerts(out_dir) or final[-1]["state"] != \
            "resolved" or final[-1]["alert_id"] != firing[0]["alert_id"]:
        raise AssertionError(f"alerts: not resolved: rc {rc}, "
                             f"{final[-1]}: {buf.getvalue()[-300:]}")
    fault_stats = dict(
        wall_s=fault["wall_s"], proj_launches=fault["launches"]["proj"],
        history_samples=len(samples),
        transitions=[(r["rule"], r["state"]) for r in final],
        bundle_artifacts=len(paths),
        bundle_bytes=sum(a["bytes"] for a in man["artifacts"]),
        bundle_paths=paths, bundle_roofline_device=rf["device"])

    # the cost turns: the run plane without and with history and alerts,
    # off on on off at each interval; each run's launches and features, its
    # CLI wall and its video's span wall (the part the ticks run beside)
    walls, planes, last_on = {}, {}, None
    want = None
    for interval in intervals:
        key = str(interval or "default")
        walls[key] = {"off": [], "on": [], "span_off": [], "span_on": []}
        for turn, on in enumerate((False, True, True, False)):
            name = f"{key}_{'on' if on else 'off'}{turn}"
            argv = telemetry_argv(f"{ALERTS_ROOT}/{name}", video, **over) \
                + list(RUN_PLANE) + list(ALERT_KEYS if on else ()) + (
                    [f"metrics_interval_s={interval}"] if interval else [])
            run = run_cli(argv, cl)
            run_dir = f"{ALERTS_ROOT}/{name}/out/i3d"
            outs = read_outputs(run_dir)
            stacks = len(outs.get(f"{stem}_timestamps_ms.npy", []))
            want = outs if want is None else want
            if "1 extracted" not in run["stdout"] or sorted(outs) != sorted(
                    want) or any(outs[k].tobytes() != want[k].tobytes()
                                 for k in want) or run["launches"] != dict(
                    level=0, packed=0, proj=stacks * proj_want):
                raise AssertionError(f"alerts: turn {name} launched "
                                     f"{run['launches']} for {stacks} "
                                     f"stacks, or its features differ")
            walls[key]["on" if on else "off"].append(run["wall_s"])
            span, = jsonl.read_jsonl(f"{run_dir}/_telemetry.jsonl")
            walls[key]["span_on" if on else "span_off"].append(
                span["wall_s"])
            if on:
                planes[name] = check_alert_plane(run_dir, run["stdout"])
                last_on = run_dir
            elif glob.glob(f"{run_dir}/_history_*.jsonl") or os.path.exists(
                    f"{run_dir}/{alerts.ALERTS_FILENAME}"):
                raise AssertionError(f"alerts: turn {name} has history or "
                                     "alerts with both keys off")

    # what one tick's evaluation costs on a clean run's tree: the rules
    # over observe_root, as the heartbeat thread runs them
    eng = alerts.AlertEngine(last_on, capture_incidents=False)
    eval_s, observe_s = [], []
    for _ in range(EVAL_REPS):
        t = time.perf_counter()
        alerts.observe_root(last_on)
        observe_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        if eng.evaluate():
            raise AssertionError(f"alerts: a clean run's tree fires: "
                                 f"{alerts.current_alerts(last_on)}")
        eval_s.append(time.perf_counter() - t)
    return dict(
        fault=fault_stats, walls_s=walls, planes=planes,
        eval_ms_per_tick=1e3 * float(np.median(eval_s)),
        observe_root_ms=1e3 * float(np.median(observe_s)),
        eval_tree=last_on, eval_errors=eng.eval_errors)


def fleet_step(roots: dict, card_name=None) -> dict:
    """The fleet report over each phase root (module docstring, step 19):
    every current host ``FINISHED``, i3d throughput from the spans, the
    roofline roll-up naming the card; the Prometheus textfile parses; one
    stitched trace with a lane per host trace and their ``video_attempt``
    and ``forward`` spans, the host spans the proj launches ran under; the
    port's run report renders the alerts phase's fault run and its
    ``--fail-on-alert`` gate passes after the resolve."""
    import contextlib
    import io
    import re

    from video_features_tpu_torch import fleet_report
    from video_features_tpu_torch.telemetry import metrics, report

    out = {}
    line = re.compile(PROM_LINE)
    for name, root in roots.items():
        agg = fleet_report.aggregate(root)
        hosts = [e for e in agg["hosts"] if not e["prior_run"]]
        fam = agg["families"].get("i3d") or {}
        rf = agg["roofline"] or {}
        kind = (rf.get("device") or {}).get("device_kind")
        if not hosts or {e["state"] for e in hosts} != {"FINISHED"} or \
                not fam.get("done") or fam.get("s_per_video") is None or \
                not kind or (card_name is not None and kind != card_name):
            raise AssertionError(f"fleet {name}: hosts "
                                 f"{[e['state'] for e in hosts]}, i3d "
                                 f"{fam}, roofline device {kind}")
        text = metrics.prometheus_text(fleet_report.build_prom_dump(agg))
        body = [ln for ln in text.splitlines()
                if ln.strip() and not ln.startswith("#")]
        traces = fleet_report.find_trace_files(root)
        path, merged = fleet_report.stitch(root)
        names = {e["name"] for e in merged["traceEvents"]
                 if e.get("ph") == "X"}
        if not body or not all(line.match(ln) for ln in body) or \
                path is None or len(merged["otherData"]["hosts"]) != \
                len(traces) or not {"video_attempt", "forward"} <= names \
                or not merged["otherData"]["aligned"]:
            raise AssertionError(f"fleet {name}: prom {body[:3]}, stitch "
                                 f"{path} of {len(traces)} traces, spans "
                                 f"{sorted(names)}")
        out[name] = dict(hosts=len(hosts), i3d=fam, roofline_device=kind,
                         roofline_mfu=rf["families"].get("i3d", {}).get(
                             "mfu"),
                         prom_series=len(body), stitched_lanes=len(traces),
                         stitched_events=len(merged["traceEvents"]))
    fault_dir = f"{roots['alerts']}/fault/out/i3d"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = report.main([fault_dir, "--fail-on-alert"])
    text = buf.getvalue()
    if rc != 0 or "== heartbeats ==" not in text or "FATAL=1" not in text:
        raise AssertionError(f"fleet: report rc {rc}: {text[-400:]}")
    out["report_lines"] = len(text.splitlines())
    return out


def check_roofline(doc: dict, card_name, proj_want: int) -> dict:
    """A ``_roofline.json`` of the telemetry phase: valid under the port's
    schema, one i3d family with work counted. On a card: the device named
    from the registry, at least the proj launches' declared operations at
    the slice's shapes among the FLOPs, ``0 < mfu <= 1``, effective TFLOPS
    at most the peak and one of the four verdicts. Returns the family's
    numbers and the device block."""
    from video_features_tpu_torch.telemetry import roofline

    errs = roofline.validate_roofline(doc)
    fam = doc["families"].get("i3d") or {}
    if errs or not fam.get("flops_total", 0) > 0 or not fam.get(
            "dispatches"):
        raise AssertionError(f"telemetry: _roofline.json {errs} {fam}")
    dev = doc["device"]
    if card_name is not None:
        least = proj_want * kernel_work("proj", STACK * GRID_H * GRID_W,
                                        0)[1]
        mfu, eff = fam.get("mfu"), fam.get("effective_tflops")
        if dev.get("device_kind") != card_name \
                or dev.get("source") != "registry" \
                or fam["flops_total"] < least or mfu is None \
                or not 0 < mfu <= 1 or eff > dev["peak_tflops"] \
                or fam.get("verdict") not in roofline.VERDICTS:
            raise AssertionError(f"telemetry: roofline device {dev}, family "
                                 f"{fam}, proj's declared operations "
                                 f"{least}")
    return dict(device=dev, **{k: v for k, v in fam.items()
                               if k != "programs"},
                programs=fam["programs"])


#: the seams the i3d path taps, as JAX's i3d does: its RAFT flow stays on
#: the card, so the backbone seam is the raft family's (the certify phase)
I3D_SEAMS = ("decode", "transform", "head")


def check_parity(path: str) -> dict:
    """The ``_parity.jsonl`` of the telemetry phase: every record valid
    under the port's schema, records at each of :data:`I3D_SEAMS` and at
    no other seam. Returns the count per seam."""
    records = [json.loads(line) for line in open(path) if line.strip()]
    bad = [r for r in records if parity.validate_parity(r)]
    seams = {s: sum(r["seam"] == s for r in records) for s in parity.SEAMS}
    if bad or {s for s, n in seams.items() if n} != set(I3D_SEAMS):
        raise AssertionError(f"telemetry: parity records by seam {seams}, "
                             f"invalid {bad[:2]}")
    return seams


#: the certify phase: each family's bfloat16 flip over the vendored sample
CERTIFY_FLIPS = (("raft", "dtype=bf16"), ("pwc", "dtype=bf16"))
#: the families whose bfloat16 verdict on the port's seeded weights may be
#: the weight draw's FAIL, and the factor on their band's ``max_abs`` that
#: still holds them: RAFT's flip read 1.31-2.80 px over four seeded weight
#: draws, FAILing its 2.0 px band on two of them in the port and in the
#: JAX package alike (``tools/certify_seeds.py``, PERF.md). Its ``cos``
#: band holds as it stands.
DRAW_BOUND_FAMILIES = ("raft",)
DRAW_SPREAD = 1.5


def certify_phase(video: str = SAMPLE_VIDEO, **over) -> dict:
    """``parity.certify`` of each family's bfloat16 flip over the sample on
    the card (``over``: config overrides for both arms, the CPU test's
    small sizes). Held: each verdict valid under the port's schema, every
    seam captured, the ``decode`` and ``transform`` seams within their
    bands (host work in float32 that no numerics flip may reach: drift
    there is a leak), and the verdict ``PASS``. A family of
    :data:`DRAW_BOUND_FAMILIES` is held instead at ``backbone`` and
    ``head`` to its band's ``cos`` and to :data:`DRAW_SPREAD` times its
    ``max_abs``. Returns each verdict's per-seam numbers."""
    import os
    import shutil

    root = "output/chip_smoke/certify"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for family, flip in CERTIFY_FLIPS:
        t = time.perf_counter()
        doc = parity.certify(family, flip=flip, videos=[video],
                             out_dir=os.path.join(root, family),
                             extra_overrides=dict({"device": "cuda"},
                                                  **over))
        errs = parity.validate_verdict(doc)
        out[family] = dict(
            flip=flip, verdict=doc["verdict"],
            first_drift=doc["first_drift"], seconds=time.perf_counter() - t,
            seams={s: {k: m[k] for k in ("pairs", "max_abs", "mean_abs",
                                         "cos", "tol_max_abs", "tol_cos")}
                   for s, m in doc["seams"].items()})
        print(json.dumps({"certify": {family: out[family]}}))
        leaked = [s for s in ("decode", "transform")
                  if not doc["seams"][s]["ok"]]
        empty = [s for s, m in doc["seams"].items() if not m["pairs"]]
        if errs or leaked or empty:
            raise AssertionError(f"certify {family} {flip}: {errs}, drift "
                                 f"upstream of the device at {leaked}, no "
                                 f"captures at {empty}")
        if family in DRAW_BOUND_FAMILIES:
            off = [s for s in ("backbone", "head")
                   if not (doc["seams"][s]["cos"]
                           >= parity.tolerance_for(family, s)["cos"]
                           and doc["seams"][s]["max_abs"] <= DRAW_SPREAD
                           * parity.tolerance_for(family, s)["max_abs"])]
            if off:
                raise AssertionError(f"certify {family} {flip}: outside "
                                     f"{DRAW_SPREAD}x its band at {off}: "
                                     f"{out[family]['seams']}")
        elif doc["verdict"] != "PASS":
            raise AssertionError(f"certify {family} {flip}: "
                                 f"{doc['verdict']}, first drift at "
                                 f"{doc['first_drift']}: "
                                 f"{out[family]['seams']}")
    return out


def alerts_plane_line(telemetry_stats: dict, alerts_stats: dict,
                      card: str) -> dict:
    """The numbers of the retained history and the alerting, each run's
    beside the card's ``nvidia-smi`` name and power limit: history samples
    per run, the fault run's transitions and bundle, one tick's
    evaluation, and the main path's walls without and with ``history``
    and ``alerts`` at each heartbeat interval."""
    fault = alerts_stats["fault"]
    samples = {f"telemetry_{k}": v["samples"]
               for k, v in telemetry_stats["alert_plane"].items()}
    samples.update({f"turn_{k}": v["samples"]
                    for k, v in alerts_stats["planes"].items()})
    samples["fault"] = fault["history_samples"]
    findings = [f for p in list(telemetry_stats["alert_plane"].values())
                + list(alerts_stats["planes"].values())
                for f in p["mfu_regression"]]
    return dict(card=card, history_samples=samples,
                transitions=fault["transitions"],
                bundle_artifacts=fault["bundle_artifacts"],
                bundle_bytes=fault["bundle_bytes"],
                eval_ms_per_tick=alerts_stats["eval_ms_per_tick"],
                observe_root_ms=alerts_stats["observe_root_ms"],
                walls_s=alerts_stats["walls_s"],
                mfu_regression_on_clean_runs=findings)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from video_features_tpu_torch.device import set_precision
    from video_features_tpu_torch.kernels import build

    dev = torch.device("cuda")
    set_precision("float32")
    card = card_line()
    print(card)
    # a library left by an earlier build carries that build's report
    cached = build.library_path().exists()
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s, "library": build.library_path().name,
                      "built_in_this_run": not cached,
                      "ptxas": kernel_resources(build)}))
    # the card's practical bf16 and read rates, beside the registry's entry
    # that every roofline MFU of the port divides by
    from video_features_tpu_torch.telemetry import roofline
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"measure_peak": roofline.measure_peak(),
                      "registry": roofline.registry_peak(kind),
                      "device_kind": kind, "card": card}))

    ragged = check_ragged(dev)
    print(json.dumps({"ragged_max_abs_err": ragged}))
    kernels = check_kernels(dev)
    raft_err = check_small_raft(dev)
    slice_stats, proj_launches, level_launches, fused_feats = run_slice(dev)
    raft_stats = run_raft_family(dev)
    torch.cuda.empty_cache()
    pwc_stats = run_pwc_family(dev)
    torch.cuda.empty_cache()
    i3d_pwc_stats, proj_launches_bf16 = run_i3d_pwc(dev, fused_feats)
    torch.cuda.empty_cache()
    r21d_stats = run_r21d(dev)
    s3d_stats = run_s3d(dev)
    resnet_stats = frame_phase("resnet", 2048, "resnet18", 512)
    clip_stats = frame_phase("clip", 512, "RN50", 1024)
    vggish_stats = vggish_phase()
    parallel_stats = parallel_phase(dev)
    empty_cache()
    multi_stats = multi_phase()
    empty_cache()
    telemetry_stats = telemetry_phase()
    empty_cache()
    alerts_stats = alerts_phase()
    empty_cache()
    fleet_stats = fleet_step({"telemetry": "output/chip_smoke/telemetry",
                              "alerts": ALERTS_ROOT}, kind)
    certify_stats = certify_phase()
    empty_cache()
    # each kernel's launches on the path that runs it: the i3d slice for
    # proj (fused) and level (unfused), the raft family for packed
    launches = {"corr_lookup_proj_cuda": proj_launches,
                "corr_lookup_level_cuda": level_launches,
                "corr_lookup_packed_cuda":
                    raft_stats["packed_launches"]["packed"]}
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["card"] = card
    proj_row = next(r for r in kernels
                    if r["name"] == "corr_lookup_proj_cuda")
    proj_row["launches_raft_default"] = raft_stats["default_launches"]["proj"]
    proj_row["launches_i3d_raft_bfloat16"] = proj_launches_bf16
    proj_row["launches_telemetry_off_on"] = [
        telemetry_stats["proj_launches"]["off"],
        telemetry_stats["proj_launches"]["on"]]
    proj_row["launches_alerts_fault"] = alerts_stats["fault"]["proj_launches"]
    proj_row["launches_parallel_raft_per_replica"] = [
        t["proj"] for t in parallel_stats["raft"]["per_replica"]]
    next(r for r in kernels if r["name"] == "corr_lookup_packed_cuda")[
        "launches_i3d"] = slice_stats["packed_launches"]
    slice_stats.update(card=card, small_raft_kernels_vs_gather_px=raft_err)
    raft_stats["card"] = card
    pwc_stats["card"] = card
    i3d_pwc_stats["card"] = card
    r21d_stats["card"] = card
    s3d_stats["card"] = card
    resnet_stats["card"] = card
    clip_stats["card"] = card
    vggish_stats["card"] = card
    parallel_stats["card"] = card
    multi_stats["card"] = card
    telemetry_stats["card"] = card
    alerts_stats["card"] = card
    fleet_stats["card"] = card
    certify_stats["card"] = card
    print(json.dumps({"slice": slice_stats}))
    print(json.dumps({"raft_family": raft_stats}))
    print(json.dumps({"pwc_family": pwc_stats}))
    print(json.dumps({"i3d_pwc": i3d_pwc_stats}))
    print(json.dumps({"r21d": r21d_stats}))
    print(json.dumps({"s3d": s3d_stats}))
    print(json.dumps({"resnet": resnet_stats}))
    print(json.dumps({"clip": clip_stats}))
    print(json.dumps({"vggish": vggish_stats}))
    print(json.dumps({"parallel": parallel_stats}))
    print(json.dumps({"multi": multi_stats}))
    print(json.dumps({"telemetry": telemetry_stats}))
    print(json.dumps({"alerts": alerts_stats}))
    print(json.dumps({"fleet": fleet_stats}))
    print(json.dumps({"certify": certify_stats}))
    print(json.dumps({"alerts_plane": alerts_plane_line(
        telemetry_stats, alerts_stats, card)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
