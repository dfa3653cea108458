"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

What it does, failing (exit code != 0, no result line) at the first phase
that goes wrong:

1. prints the card's ``nvidia-smi --query-gpu=name,power.limit`` line;
2. builds the CUDA kernels from ``video_features_tpu_torch/kernels/csrc``;
3. for each kernel, at the main path's shapes (one 64-frame stack of
   240x320 frames resized to 256x341 and padded to 256x344: a 32x43 grid,
   Q = 64 * 1376 = 88,064 queries, a pyramid from seeded random fmaps),
   holds the kernel against its plain PyTorch version on the card
   (max abs error: level 1e-5, proj 1e-4) and times the kernel, the plain
   version and one library call of the same function (``F.grid_sample`` as
   the reference formulates the lookup, plus ``torch.matmul`` for proj);
4. holds RAFT with the kernels against RAFT with the plain gather lookup on
   a small input (flow atol 1e-3 px);
5. drives the port's main path, ``ExtractI3D(...).extract_frames(...)``
   with ``flow_type=raft``, both streams, 20 GRU iterations, float32,
   seeded random weights and one stack per RAFT forward, over 129 seeded
   synthetic 240x320 frames (two 64-frame stacks), with every launch count
   set to 0 just before and read just after: the fused lookup + convc1
   kernel must have run 20 times per RAFT forward. Then the same with
   ``fuse_convc1=false``: the per-level kernel must have run 4 * 20 times
   per forward, and the features must match the fused run's (atol 1e-2,
   the value tier). Each extractor runs once before its timed run, and
   between the two the main path runs once more under ``torch.profiler``
   for the device time by kernel and the card's busy share; last, fused
   and unfused runs alternate (F U U F) for a like-for-like rate;
6. prints one JSON line of the kernels' numbers, one of the slice's, and
   last ``{"ok": true, "device": {...}}``.

It imports nothing of JAX, and needs no cv2, PIL or yaml: the frames are
synthetic and the config is built in code.
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


def check_kernels(dev):
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.models.raft import build_corr_pyramid

    gen = torch.Generator(device="cpu").manual_seed(0)
    f1 = torch.randn((STACK, 256, GRID_H, GRID_W), generator=gen).to(dev)
    f2 = torch.randn((STACK, 256, GRID_H, GRID_W), generator=gen).to(dev)
    pyramid = build_corr_pyramid(f1, f2)
    gy, gx = torch.meshgrid(torch.arange(GRID_H, dtype=torch.float32),
                            torch.arange(GRID_W, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([gx, gy], -1).expand(STACK, GRID_H, GRID_W, 2) \
        + (torch.rand((STACK, GRID_H, GRID_W, 2), generator=gen) - 0.5) * 24
    coords = coords.contiguous().to(dev)
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

        got = cl.corr_lookup_proj_cuda(pyramid, coords, weight, bias)
        want = cl.corr_lookup_proj_ref(pyramid, coords, weight, bias)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"corr_lookup_proj_cuda max abs err {err}")
        b_ms, b_by = bound(
            cells * 4 + q * 8 + (324 + 1) * 256 * 4 + q * 256 * 4,
            2 * q * 324 * 256 + tap_flops)
        rows.append(dict(
            name="corr_lookup_proj_cuda", route="cuda",
            source="video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
            replaces="video_features_tpu/kernels/corr_lookup.py:380",
            max_abs_err=err,
            ms=median_ms(lambda: cl.corr_lookup_proj_cuda(
                pyramid, coords, weight, bias)),
            plain_ms=median_ms(lambda: cl.corr_lookup_proj_ref(
                pyramid, coords, weight, bias)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=median_ms(lambda: torch.relu(torch.matmul(
                grid_sample_lookup(pyramid, coords), weight) + bias)),
            queries=q))
    del pyramid, f1, f2
    torch.cuda.empty_cache()
    return rows


def check_small_raft(dev):
    """RAFT through the kernels vs the plain gather lookup, small input."""
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
        model.corr_lookup_impl = None
        for fuse in (True, False):
            model.fuse_convc1 = fuse
            err = float((model(x1, x2) - want).abs().max())
            if not err <= 1e-3:
                raise AssertionError(
                    f"RAFT fuse_convc1={fuse} vs gather: max abs err {err} px")
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


def profile_stacks(extractor) -> dict:
    """Device time by kernel over one warm run of the main path's 2 stacks
    (torch.profiler), and the share of the wall time the card was busy
    (the union of the kernels' intervals, so nothing counts twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = list(synthetic_frames(2 * STACK + 1, 13))
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
    return {"stacks": 2, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernel_ms_total": sum(v[0] for v in by_name.values()),
            "top_kernels": [{"name": k[:90], "ms": v[0], "calls": v[1]}
                            for k, v in top]}


def reset_counts(cl) -> None:
    cl.corr_lookup_level_cuda.launches = 0
    cl.corr_lookup_proj_cuda.launches = 0


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
    proj_launches = cl.corr_lookup_proj_cuda.launches
    level_in_fused = cl.corr_lookup_level_cuda.launches
    fwd = fused.flow_stream.forwards
    for s in ("rgb", "flow"):
        if feats[s].shape != (2, 1024) or not np.isfinite(feats[s]).all():
            raise AssertionError(f"{s}: shape {feats[s].shape} or non-finite")
    if feats["timestamps_ms"].tolist() != [STACK / 25 * 1000,
                                           2 * STACK / 25 * 1000]:
        raise AssertionError(f"timestamps {feats['timestamps_ms']}")
    if fwd < 1 or proj_launches != ITERS * fwd or level_in_fused != 0:
        raise AssertionError(f"fused path: {proj_launches} proj and "
                             f"{level_in_fused} level launches for {fwd} "
                             "RAFT forwards")

    profile = profile_stacks(fused)

    unfused = ExtractI3D(slice_config("output/chip_smoke",
                                      fuse_convc1=False))
    unfused.extract_frames(synthetic_frames(STACK + 1, 7), 25.0)
    unfused.flow_stream.forwards = 0
    reset_counts(cl)
    t0 = time.perf_counter()
    one = unfused.extract_frames(synthetic_frames(2 * STACK + 1, 11), 25.0)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    level_launches = cl.corr_lookup_level_cuda.launches
    fwd_u = unfused.flow_stream.forwards
    if fwd_u < 1 or level_launches != 4 * ITERS * fwd_u \
            or cl.corr_lookup_proj_cuda.launches != 0:
        raise AssertionError(f"unfused path: {level_launches} level "
                             f"launches for {fwd_u} RAFT forwards")
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
    for row in kernels:
        row["launches"] = (proj_launches if row["name"] ==
                           "corr_lookup_proj_cuda" else level_launches)
        row["card"] = card
    slice_stats.update(card=card, small_raft_kernels_vs_gather_px=raft_err)
    print(json.dumps({"slice": slice_stats}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
