"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

What it does, failing (exit code != 0, no result line) at the first phase
that goes wrong:

1. prints the card's ``nvidia-smi --query-gpu=name,power.limit`` line;
2. builds the CUDA kernels from ``video_features_tpu_torch/kernels/csrc``;
3. for each kernel, at the shapes its path gives it, holds the kernel
   against its plain PyTorch version on the card and times the kernel, the
   plain version and one library call of the same function
   (``F.grid_sample`` as the reference formulates the lookup, over the
   unpacked levels, plus ``torch.matmul`` for proj; no library call reads
   the packed layout):
   - the i3d slice's shapes (one 64-frame stack of 240x320 frames resized
     to 256x341 and padded to 256x344: a 32x43 grid, Q = 64 * 1376 =
     88,064 queries): level (max abs error 1e-5), proj (1e-4), packed
     (1e-5);
   - the raft family's shapes (32 pairs of 240x320 frames: a 30x40 grid,
     Q = 32 * 1200 = 38,400 queries): packed (1e-5), and proj (1e-4) with
     convc1's weight and bias rounded to bfloat16 and upcast, as the
     family's bfloat16 default feeds it;
   pyramids from seeded random fmaps;
4. holds RAFT with the kernels (fused, unfused, packed) against RAFT with
   the plain gather lookup on a small input, float32 (flow atol 1e-3 px);
5. drives the i3d slice, ``ExtractI3D(...).extract_frames(...)`` with
   ``flow_type=raft``, both streams, 20 GRU iterations, float32, seeded
   random weights and one stack per RAFT forward, over 129 seeded synthetic
   240x320 frames (two 64-frame stacks), with every launch count set to 0
   just before and read just after: the fused lookup + convc1 kernel must
   have run 20 times per RAFT forward. Then the same with
   ``fuse_convc1=false``: the per-level kernel must have run 4 * 20 times
   per forward, and the features must match the fused run's (atol 1e-2,
   the value tier). One profiled run of the fused path (device time by
   kernel, the card's busy share), and fused and unfused in turns (F U U F);
6. drives the raft family, ``ExtractRAFT(...).extract_frames(...)``, at the
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
7. prints one JSON line of the i3d slice's numbers, one of the raft
   family's, one of the kernels' numbers, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX, and needs no cv2, PIL or yaml: the frames are
synthetic and the configs are built in code.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

F32_PEAK_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
STACK = 64
FRAME_H, FRAME_W = 240, 320
GRID_H, GRID_W = 32, 43  # 256x341 resized, padded to 256x344, /8
ITERS = 20
RAFT_BATCH = 32  # raft family pairs per RAFT forward
RAFT_GRID_H, RAFT_GRID_W = FRAME_H // 8, FRAME_W // 8
#: the bfloat16 flow bound of the JAX package (tests/test_raft.py)
BF16_MEDIAN_PX, BF16_P99_PX = 0.1, 1.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def window_cells(pyramid, coords, radius: int = 4) -> int:
    """In-plane cells of every query's (2r+2)^2 corner window, summed over
    levels: the pyramid bytes this run's coords need read."""
    cx = coords[..., 0].reshape(-1).double()
    cy = coords[..., 1].reshape(-1).double()
    n = 2 * radius + 2
    total = 0
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        x0 = torch.floor(cx / 2 ** lvl - radius)
        y0 = torch.floor(cy / 2 ** lvl - radius)
        cols = (torch.minimum(x0 + n - 1, torch.tensor(wl - 1.0))
                - torch.clamp(x0, min=0) + 1).clamp(min=0)
        rows = (torch.minimum(y0 + n - 1, torch.tensor(hl - 1.0))
                - torch.clamp(y0, min=0) + 1).clamp(min=0)
        total += int((cols * rows).sum().item())
    return total


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lookup_inputs(dev, batch: int, grid_h: int, grid_w: int, seed: int):
    """A pyramid from seeded random fmaps and coords spread +-12 px around
    the grid, as a RAFT forward of ``batch`` pairs on a (grid_h, grid_w)
    grid gives the lookup."""
    from video_features_tpu_torch.models.raft import build_corr_pyramid

    gen = torch.Generator(device="cpu").manual_seed(seed)
    f1 = torch.randn((batch, 256, grid_h, grid_w), generator=gen).to(dev)
    f2 = torch.randn((batch, 256, grid_h, grid_w), generator=gen).to(dev)
    pyramid = build_corr_pyramid(f1, f2)
    gy, gx = torch.meshgrid(torch.arange(grid_h, dtype=torch.float32),
                            torch.arange(grid_w, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([gx, gy], -1).expand(batch, grid_h, grid_w, 2) \
        + (torch.rand((batch, grid_h, grid_w, 2), generator=gen) - 0.5) * 24
    return pyramid, coords.contiguous().to(dev), gen


def packed_row(cl, pyramid, coords) -> dict:
    """The packed kernel against its plain version (and the gather lookup
    of the unpacked levels), timed, with its bound."""
    packed, metas = cl.pack_pyramid(pyramid)
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    got = cl.corr_lookup_packed_cuda(packed, metas, coords)
    want = cl.corr_lookup_packed_ref(packed, metas, coords)
    gather = cl.corr_lookup_gather_ref(pyramid, coords)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # the gather formulation rounds the bilinear weights at another
    # magnitude (floor(c/2^l + d) against floor(c/2^l - r) + d), a few 1e-6
    # relative, so it is held to the proj kernel's 1e-4
    err_gather = float((got - gather).abs().max())
    if not (err <= 1e-5 and err_gather <= 1e-4):
        raise AssertionError(f"corr_lookup_packed_cuda max abs err {err} "
                             f"(vs gather {err_gather})")
    del want, gather
    b_ms, b_by = bound(window_cells(pyramid, coords) * 4 + q * 8
                       + q * 324 * 4, q * 324 * 12)
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
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"corr_lookup_proj_cuda max abs err {err}")
    del got, want
    b_ms, b_by = bound(
        window_cells(pyramid, coords) * 4 + q * 8 + (324 + 1) * 256 * 4
        + q * 256 * 4, 2 * q * 324 * 256 + q * 324 * 12)
    return dict(
        queries=q, max_abs_err=err,
        ms=median_ms(lambda: cl.corr_lookup_proj_cuda(
            pyramid, coords, weight, bias)),
        plain_ms=median_ms(lambda: cl.corr_lookup_proj_ref(
            pyramid, coords, weight, bias)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.relu(torch.matmul(
            grid_sample_lookup(pyramid, coords), weight) + bias)))


def check_kernels(dev):
    from video_features_tpu_torch.kernels import corr_lookup as cl

    pyramid, coords, gen = lookup_inputs(dev, STACK, GRID_H, GRID_W, 0)
    weight = (torch.randn((324, 256), generator=gen) / 18.0).to(dev)
    bias = (torch.randn((256,), generator=gen) * 0.1).to(dev)
    q = coords.shape[0] * GRID_H * GRID_W
    cells = window_cells(pyramid, coords)
    tap_flops = q * 324 * 12  # 4 corner weights, 4 products, 4 adds

    rows = []
    with torch.inference_mode():
        got = cl.corr_lookup_level_cuda(pyramid, coords)
        want = cl.corr_lookup_gather_ref(pyramid, coords)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"corr_lookup_level_cuda max abs err {err}")
        b_ms, b_by = bound(cells * 4 + q * 8 + q * 324 * 4, tap_flops)
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


def profile_run(extractor, frames) -> dict:
    """Device time by kernel over one warm ``extract_frames`` run
    (torch.profiler), and the share of the wall time the card was busy
    (the union of the kernels' intervals, so nothing counts twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extractor.extract_frames(iter(frames), 25.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA})
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
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernel_ms_total": sum(v[0] for v in by_name.values()),
            "top_kernels": [{"name": k[:90], "ms": v[0], "calls": v[1]}
                            for k, v in top]}


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
    if fwd_u < 1 or unfused_counts != {"level": 4 * ITERS * fwd_u,
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
    return dict(stacks=2, seconds=seconds, stacks_per_s=2 / seconds,
                flow_forwards=fwd, proj_launches=proj_launches,
                unfused_stacks_per_s=2 / unfused_s,
                unfused_flow_forwards=fwd_u,
                level_launches=level_launches,
                unfused_vs_fused_max_abs=diffs,
                fused_unfused_turns_stacks_per_s=ab,
                profile=profile), proj_launches, level_launches


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
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s, "library": build.library_path().name}))

    kernels = check_kernels(dev)
    raft_err = check_small_raft(dev)
    slice_stats, proj_launches, level_launches = run_slice(dev)
    raft_stats = run_raft_family(dev)
    # each kernel's launches on the path that runs it: the i3d slice for
    # proj (fused) and level (unfused), the raft family for packed
    launches = {"corr_lookup_proj_cuda": proj_launches,
                "corr_lookup_level_cuda": level_launches,
                "corr_lookup_packed_cuda":
                    raft_stats["packed_launches"]["packed"]}
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["card"] = card
    next(r for r in kernels if r["name"] == "corr_lookup_proj_cuda")[
        "launches_raft_default"] = raft_stats["default_launches"]["proj"]
    slice_stats.update(card=card, small_raft_kernels_vs_gather_px=raft_err)
    raft_stats["card"] = card
    print(json.dumps({"slice": slice_stats}))
    print(json.dumps({"raft_family": raft_stats}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
