"""The yardstick of chip_smoke.py on the CPU: the in-plane window cells that
its bytes bound counts, the touched units that tools/level_fetch_model.py
counts, and which of the two bounds each kernel gets at the main paths'
shapes. The scripts are imported without running ``main()``."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch



def _load(name, path):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load("chip_smoke", "chip_smoke.py")
fetch_model = _load("level_fetch_model", "tools/level_fetch_model.py")

#: a small pyramid: odd sizes, a level narrower than the window, 1x1, 0x0
SHAPES = [(13, 11), (6, 5), (1, 1), (0, 0)]


def _coords():
    """Seeded coords around a 13x11 grid, with whole windows outside the
    plane on every side and some straddling its edges."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-8.0, 20.0, size=(2, 13, 11, 2)).astype(np.float32)
    xy[0, 0] = (-60.0, 5.0)     # far left of every level
    xy[0, 1] = (5.0, 90.0)      # far below
    xy[1, 2, :3] = (-4.5, -4.5)  # straddling the upper-left corner
    return torch.from_numpy(xy)


def _windows(coords, shapes, side):
    """Per query q and level, the in-plane (row, col) cells of the ``side`` x
    ``side`` window from (floor(c / 2^l) - 4), by brute force."""
    for q, (cx, cy) in enumerate(coords.reshape(-1, 2).tolist()):
        for lvl, (hl, wl) in enumerate(shapes):
            x0 = int(np.floor(np.float64(cx) / 2 ** lvl - 4))
            y0 = int(np.floor(np.float64(cy) / 2 ** lvl - 4))
            yield q, lvl, [(y, x) for y in range(y0, y0 + side)
                           for x in range(x0, x0 + side)
                           if 0 <= y < hl and 0 <= x < wl]


def test_window_cells_counts_in_plane_corners():
    coords = _coords()
    want = sum(len(cells) for _, _, cells in _windows(coords, SHAPES, 10))
    assert cs.window_cells(SHAPES, coords) == want
    assert 0 < want < coords.numel() // 2 * len(SHAPES) * 100


def test_window_fetch_bytes_counts_touched_units():
    """Query q's plane starts at q * Hl * Wl floats of its level; each window
    row's in-plane cells cost the 32- or 64-byte units they touch."""
    coords = _coords()
    for unit in (32, 64):
        want = 0
        for q, lvl, cells in _windows(coords, SHAPES, 11):
            hl, wl = SHAPES[lvl]
            for row in {y for y, _ in cells}:
                want += unit * len({(q * hl * wl + y * wl + x) * 4 // unit
                                    for y, x in cells if y == row})
        assert want > 0
        assert fetch_model.window_fetch_bytes(SHAPES, coords, unit) == want


@pytest.mark.parametrize("batch,grid", [(cs.STACK, (cs.GRID_H, cs.GRID_W)),
                                        (cs.RAFT_BATCH,
                                         (cs.RAFT_GRID_H, cs.RAFT_GRID_W))])
def test_bound_picks_operations_for_proj_and_bytes_for_level(batch, grid):
    """From shapes alone: proj is bound by its float32 FMAs even if every
    window cell of every level were read; level by its bytes even if no
    cell were."""
    q = batch * grid[0] * grid[1]
    assert cs.bound(*cs.kernel_work("proj", q, q * 4 * 100))[1] == \
        "operations"
    level_ms, by = cs.bound(*cs.kernel_work("level", q, 0))
    assert by == "bytes"
    # the output alone: 324 floats a query over the card's memory rate
    assert level_ms >= q * 324 * 4 / cs.HBM_BYTES_PER_S * 1e3


def test_max_abs_err_passes_equal_nan_layouts():
    want = torch.tensor([[1.0, float("nan"), 3.0], [float("nan"), 0.5, 0.0]])
    got = want.clone()
    got[0, 0] += 2.0 ** -19  # exact in float32
    assert cs.max_abs_err(got, want) == 2.0 ** -19
    assert cs.max_abs_err(want, want) == 0.0
    every = torch.full((2, 3), float("nan"))
    assert cs.max_abs_err(every, every) == 0.0


@pytest.mark.parametrize("where", ["got", "want"])
def test_max_abs_err_fails_a_nan_in_one_place_only(where):
    want = torch.tensor([1.0, float("nan"), 3.0])
    got = want.clone()
    (got if where == "got" else want)[2] = float("nan")
    assert not cs.max_abs_err(got, want) <= 1e-5


def test_ragged_phase_runs_its_cases_on_the_cpu():
    """On the CPU every wrapper takes its plain version, so the phase holds
    each plain version against itself: every case runs, the ``nonfinite``
    one included (NaN, +-inf and +-1e30 coords), with no error."""
    _, coords = cs.ragged_inputs(torch.device("cpu"), "nonfinite")
    assert torch.isnan(coords).sum() == 2 and torch.isinf(coords).sum() == 2
    errs = cs.check_ragged(torch.device("cpu"))
    assert set(errs) == {"q231", "odd", "outside", "degenerate", "nonfinite"}
    for e in errs.values():
        assert e["level"] == e["proj"] == e["packed"] == 0.0


def test_pwc_levels_are_the_models_pyramid_at_256x384():
    """The cost volume's timing shapes are PWCNet's decoder levels for the
    i3d phase's frames: 240x320 resized to 256x341, then to /64 multiples
    (256x384) inside the net."""
    from video_features_tpu_torch.models import pwc
    assert (-(-341 // 64) * 64, -(-256 // 64) * 64) == (384, 256)
    with torch.inference_mode():
        feats = pwc.Extractor()(torch.zeros((1, 3, 256, 384)))
    for level, h, w, c in cs.PWC_LEVELS:
        assert tuple(feats[level - 1].shape[1:]) == (c, h, w), level
    assert [lv for lv, *_ in cs.PWC_LEVELS] == [lv for lv, _ in
                                                 sorted(pwc.LEVELS)]


def test_annotated_wraps_and_restores():
    """The profiler ranges wrap a module's functions by name, keep their
    results, and put the originals back."""
    import types
    mod = types.SimpleNamespace(f=lambda x: x + 1, g=lambda x: 2 * x)
    f, g = mod.f, mod.g
    undo = cs.annotated(mod, ["f", "g"])
    assert mod.f is not f and mod.f(1) == 2 and mod.g(3) == 6
    undo()
    assert mod.f is f and mod.g is g


def test_band_is_cosine_and_max_abs():
    a = np.array([1.0, 2.0, 2.0], np.float32)
    assert cs.band(a, a) == {"cos": pytest.approx(1.0), "max_abs": 0.0}
    got = cs.band(a + np.array([0.0, 0.0, 0.5], np.float32), a)
    assert got["max_abs"] == 0.5 and 0.99 < got["cos"] < 1.0


@pytest.mark.parametrize("feature_type,frames,stack,rows", [
    ("r21d", cs.R21D_FRAMES, cs.R21D_STACK, 16),
    ("s3d", cs.S3D_FRAMES, cs.S3D_STACK, 8)])
def test_clip_phases_cut_full_groups_at_the_yaml_defaults(
        feature_type, frames, stack, rows):
    """257 frames at r21d's default 16/16 make 16 clips, two full groups of
    8; 513 frames at s3d's 64/64 make 8 stacks, one full group; the
    phases' extractors resolve the YAML defaults (float32 wire in float32,
    uint8 in bfloat16)."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.extractors.s3d import ExtractS3D
    from video_features_tpu_torch.utils.lists import form_slices

    cls = ExtractR21D if feature_type == "r21d" else ExtractS3D
    for precision, ingest in (("float32", "float32"), ("bfloat16", "uint8")):
        ex = cls(cs.clip_config(feature_type, device="cpu",
                                precision=precision))
        assert (ex.stack_size, ex.step_size) == (stack, stack)
        assert ex.clip_batch_size == cs.CLIP_BATCH and ex.ingest == ingest
        windows = cs.clip_windows(ex, frames)
        assert windows == form_slices(frames, stack, stack)
        assert len(windows) == rows and rows % cs.CLIP_BATCH == 0
    assert cs.clip_windows(ex, stack - 1) == []


def test_head_band_check():
    a = np.random.default_rng(0).normal(size=(8, 64))
    assert cs.in_head_band(cs.band(a + 0.4, a)) is False  # cos < 0.99
    assert cs.in_head_band(cs.band(a * 1.001, a))
    far = a.copy()
    far[0, 0] += 0.6  # one value past the max abs limit
    assert not cs.in_head_band(cs.band(far, a))


def test_yuv420_phase_packs_with_the_ports_numpy_encoder():
    """The frames the r21d phase packs on the host: R21DTransform's uint8
    crop through the port's I420 encoder (no cv2), decoded back within the
    encoder's rounding."""
    from video_features_tpu_torch.ops import colorspace
    from video_features_tpu_torch.ops.host_transforms import R21DTransform

    frame = next(cs.synthetic_frames(1, 3))[0]
    u8 = R21DTransform("uint8")(frame)
    packed = colorspace.rgb_to_yuv420(u8)
    assert packed.shape == (112 * 112 * 3 // 2,) and packed.dtype == np.uint8
    back = colorspace.yuv420_packed_to_rgb(torch.from_numpy(packed), 112,
                                           112).numpy()
    # luma exact to rounding; chroma of a 2x2 block's top-left pixel
    assert np.median(np.abs(back - u8)) < 8


@pytest.mark.parametrize("feature_type", ["resnet", "clip"])
def test_frame_configs_are_the_yaml_defaults(feature_type):
    """The frame-wise phases' configs are the YAML defaults (resnet50 or
    ViT-B/32, batch_size=1, float32), on the card, with resize=device."""
    from video_features_tpu_torch import config as tconfig

    yaml_cfg = tconfig.load_config(feature_type)
    cfg = cs.frame_config(feature_type)
    changed = {"device", "resize", "allow_random_weights", "output_path",
               "tmp_path"}
    assert set(cfg) <= set(yaml_cfg)
    assert {k: v for k, v in cfg.items() if k not in changed} == \
        {k: yaml_cfg[k] for k in cfg if k not in changed}
    assert (cfg.device, cfg.resize, cfg.batch_size) == ("cuda", "device", 1)
    tconfig.check_ported(cfg)


@pytest.mark.parametrize("feature_type,model_name,gflop", [
    ("resnet", "resnet50", 8.17), ("resnet", "resnet18", 3.63),
    ("clip", "ViT-B/32", 8.82), ("clip", "RN50", 11.59)])
def test_frame_flops_per_frame(feature_type, model_name, gflop):
    """FLOPs per frame of the published backbones, counted on meta
    tensors (ResNet-50 at 224 about 8.2 GFLOP, ViT-B/32 about 8.8)."""
    import types
    from video_features_tpu_torch.models.clip import CONFIGS

    cfg = CONFIGS.get(model_name)
    ex = types.SimpleNamespace(
        feature_type=feature_type, model_name=model_name, cfg=cfg,
        crop_size=cfg.image_resolution if cfg else 224)
    assert cs.frame_flops(ex) / 1e9 == pytest.approx(gflop, rel=2e-3)


def test_frame_phases_run_on_the_cpu(tmp_path):
    """Both frame-wise phases end to end on the CPU at a small size
    (resnet18; a tiny ViT through model_name=custom), every check
    included: the profiles say the device time was not measured."""
    from video_features_tpu_torch.models.clip import CLIP, CLIPConfig
    from video_features_tpu_torch.weights.bridge import seeded_init_

    small = dict(n_frames=5, batch=2, n_batch1=2, device="cpu")
    stats = cs.frame_phase("resnet", 512, "resnet18", 512,
                           model_name="resnet18", **small)
    ckpt = tmp_path / "tiny_clip.pt"
    tiny = CLIPConfig(32, 56, 2, 64, 14, 12, 128, 128, 2, 2)
    torch.save(seeded_init_(CLIP(tiny), 3).state_dict(), ckpt)
    clip_stats = cs.frame_phase("clip", 32, "custom", 32,
                                model_name="custom", weights_path=str(ckpt),
                                **small)
    for st, model in ((stats, "resnet18"), (clip_stats, "custom")):
        assert st["model"] == model and st["frames"] == 5
        assert set(st) >= {"float32", "bfloat16", "batch1", "resize_host",
                           "yuv420", "turns_frames_per_s", "gflop_per_frame"}
        assert len(st["turns_frames_per_s"]["bfloat16"]) == 2
        assert "not measured" in st["float32"]["profile"]["device_time"]
        assert st["resize_host"]["vs_device"]["max_abs"] <= cs.VALUE_ATOL


def test_vggish_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """The vggish phase on 2 examples of audio (batch 2) and 1 s of
    44.1 kHz stereo with ``device=cpu``: every run passes its checks
    (shapes, finite, no lookup kernel, device frontend against host within
    1e-3, log-mel within 1e-4, bfloat16 in the head band); the profiles say
    "not measured" without a card; VGGish is 1.73 GFLOP an example."""
    monkeypatch.chdir(tmp_path)
    stats = cs.vggish_phase(n_examples=2, stereo_seconds=1.0, device="cpu",
                            batch_size=2)
    assert stats["examples"] == 2 and stats["stereo44k"]["examples"] == 1
    assert stats["device_vs_host_f32_max_abs"] <= cs.VGGISH_FRONTEND_ATOL
    assert stats["logmel_vs_numpy_max_abs"] <= cs.VGGISH_LOGMEL_ATOL
    assert abs(stats["gflop_per_example"] - 1.7278) < 1e-3
    assert all(len(v) == 2 for v in stats["turns_examples_per_s"].values())
    assert "not measured" in \
        stats["host_float32"]["profile"]["device_time"]
    assert (tmp_path / "output" / "chip_smoke" / "vggish" /
            "mono16k.wav").exists()


def test_parallel_phase_runs_on_the_cpu(tmp_path):
    """The parallel phase's four parts on the CPU at a small size, with two
    replicas on the CPU and no timed turns: raft over two devices within
    1e-3 px of one (2 pairs, one forward on each replica, 2 GRU iterations
    at 64 px), packed r21d (5 clips of 4 frames, groups of 2: [2, 2, 1])
    within 1e-4 of unpacked, CLIP tensor parallelism (a tiny ViT) within
    1e-4 of replicated with its shards' shapes, and the stream's depth 4
    equal to depth 0."""
    from video_features_tpu_torch.models.clip import CLIP, CLIPConfig
    from video_features_tpu_torch.weights.bridge import seeded_init_

    cpu = torch.device("cpu")
    devices = cs.parallel_devices(cpu)
    assert devices == [cpu, cpu]
    raft = cs.parallel_raft(devices, n_frames=3, timed_turns=False,
                            device="cpu", iters=2, side_size=64,
                            batch_size=2)
    assert raft["vs_one_device_max_px"] <= 1e-3
    assert [t["forwards"] for t in raft["per_replica"]] == [1, 1]
    small = dict(device="cpu", stack_size=4, step_size=4, clip_batch_size=2)
    packed = cs.parallel_packed(lengths=(8, 12), workers=2,
                                timed_turns=False, **small)
    assert packed["clips"] == [2, 3] and packed["group_sizes"] == [2, 2, 1]
    ckpt = tmp_path / "tiny_clip.pt"
    torch.save(seeded_init_(CLIP(CLIPConfig(32, 56, 2, 64, 14, 12, 128, 128,
                                            2, 2)), 3).state_dict(), ckpt)
    tp = cs.parallel_clip_tp(devices, n_frames=3, timed_turns=False,
                             device="cpu", model_name="custom",
                             weights_path=str(ckpt))
    assert tp["in_proj_weight_shards"] == [(96, 64)] * 2
    assert tp["mesh"] == {"data": 1, "model": 2}
    stream = cs.parallel_stream(n_frames=9, timed_turns=False, **small)
    assert stream["clips"] == 2


def test_packed_feed_cannot_stall_with_contiguous_adds():
    """Why ``feed_videos`` holds a feed lock: for the phase's clip counts
    on 3 threads, interleaved adds can leave every thread closing on a
    part-filled group while videos wait (a short group mid-run without the
    keeper); with each video's adds contiguous no interleaving can, and
    the 27 clips go out in ceil(27 / 8) = 4 groups."""
    walk = _load("packer_interleavings", "tools/packer_interleavings.py")
    clips = [(n - cs.R21D_STACK) // cs.R21D_STACK + 1
             for n in cs.PACKED_VIDEOS]
    assert clips == [2, 3, 4, 5, 6, 7]
    assert walk.outcomes(clips, cs.PACKED_WORKERS, cs.CLIP_BATCH) == \
        {4, "stall"}
    assert walk.outcomes(clips, cs.PACKED_WORKERS, cs.CLIP_BATCH,
                         contiguous=True) == {4}


def test_multi_configs_are_the_published_widths():
    """The multi phase runs i3d two-stream with RAFT at the i3d YAML
    defaults, r21d and vggish at theirs, resnet50 and ViT-B/32 at
    ``batch_size=64``, each with the cache on and its own output dir, and
    each passes the port's checks."""
    from video_features_tpu_torch import config as tconfig

    cfgs = cs.multi_configs("out", "cache")
    assert tuple(cfgs) == cs.MULTI_FAMILIES
    yaml_i3d = tconfig.load_config("i3d")
    for key in ("stack_size", "step_size", "flow_stack_batch",
                "clip_batch_size", "flow_iters", "resize", "precision",
                "extraction_fps", "streams"):
        assert cfgs["i3d"][key] == yaml_i3d[key], key
    assert cfgs["i3d"].flow_type == "raft"
    for family in ("r21d", "vggish"):
        yaml_cfg = tconfig.load_config(family)
        for key, value in cfgs[family].items():
            if key in yaml_cfg and key not in {
                    "device", "allow_random_weights", "on_extraction",
                    "output_path", "tmp_path", "cache", "cache_dir",
                    "retry_attempts"}:
                assert value == yaml_cfg[key], (family, key)
    assert (cfgs["resnet"].model_name, cfgs["clip"].model_name) == \
        ("resnet50", "ViT-B/32")
    for family, cfg in cfgs.items():
        assert family not in ("resnet", "clip") or cfg.batch_size == 64
        assert (cfg.cache, cfg.cache_dir, cfg.output_path) == \
            (True, "cache", f"out/{family}")
        tconfig.check_ported(cfg)


def test_multi_phase_runs_on_the_cpu(tmp_path, monkeypatch, sample_video):
    """The multi phase on the CPU at a small size (i3d's RGB stream on one
    10-frame stack, r21d on one clip, resnet18 and a tiny ViT on 3 frames,
    2 s of stub audio) and no timed turns: the shared run equals the single
    runs, the bus decodes fewer frames than the private sources, and the
    second cache pass decodes nothing, rips nothing and is bit-equal."""
    from video_features_tpu_torch.models.clip import CLIP, CLIPConfig
    from video_features_tpu_torch.weights.bridge import seeded_init_

    ckpt = tmp_path / "tiny_clip.pt"
    torch.save(seeded_init_(CLIP(CLIPConfig(32, 56, 2, 64, 14, 12, 128, 128,
                                            2, 2)), 3).state_dict(), ckpt)
    monkeypatch.chdir(tmp_path)
    cpu = dict(device="cpu")
    small = dict(
        i3d=dict(cpu, streams="rgb", stack_size=10, step_size=10,
                 extraction_fps=1, clip_batch_size=1),
        r21d=dict(cpu, extraction_fps=1),
        resnet=dict(cpu, model_name="resnet18", extraction_total=3,
                    batch_size=2),
        clip=dict(cpu, model_name="custom", weights_path=str(ckpt),
                  extraction_total=3, batch_size=2),
        vggish=dict(cpu))
    stats = cs.multi_phase(video=sample_video, seconds=2.0,
                           timed_turns=False, **small)
    assert set(stats["max_abs_shared_vs_single"]) == set(cs.MULTI_FAMILIES)
    assert max(stats["max_abs_shared_vs_single"].values()) == 0.0
    dec = stats["frames_decoded"]
    assert 0 < dec["shared_bus"] < dec["singles_sum"]
    assert dec["all_hit_pass"] == 0
    assert stats["rips"] == {"shared": 1, "singles": 1, "all_hit_pass": 0}
    assert stats["proj_launches"] == {"shared": 0, "single": 0,
                                      "all_hit_pass": 0}
    assert stats["cache"]["entries"] == 5 and stats["cache"]["bytes"] > 0
    assert "not measured" in stats["shared_profile"]["device_time"]
    assert not (tmp_path / "output" / "chip_smoke" / "multi").exists()


def test_telemetry_argv_is_the_slice_through_the_cli():
    """The telemetry phase's CLI arguments are i3d two-stream RAFT at the
    slice's widths and pass the port's checks; the sample at its fps gives
    two 64-frame stacks."""
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.utils.io import plan_frame_selection

    argv = cs.telemetry_argv("root", "v.mp4", device="cpu")
    cfg = tconfig.load_config("i3d", tconfig.parse_dotlist(argv))
    tconfig.sanity_check(cfg)
    want = dict(flow_type="raft", streams=None, flow_iters=None,
                flow_stack_batch=1, stack_size=64, step_size=64,
                clip_batch_size=2, resize="device", precision="float32",
                on_extraction="save_numpy", extraction_fps=cs.TELEMETRY_FPS)
    assert {k: cfg[k] for k in want} == want
    assert cfg.output_path == "root/out/i3d"
    n = plan_frame_selection(19.62, 355, fps=cs.TELEMETRY_FPS)[2]
    assert (n - 1) // cs.STACK == 2


def test_check_trace_events_fails_a_missing_field_or_span():
    from video_features_tpu_torch.telemetry import trace

    required = {"X": trace.REQUIRED_X_FIELDS}
    ev = dict(ph="X", ts=0.0, dur=1.0, pid=1, tid=1, name="decode")
    assert cs.check_trace_events({"traceEvents": [ev]}, required,
                                 ["decode"]) == {"decode"}
    with pytest.raises(AssertionError, match="lack"):
        cs.check_trace_events({"traceEvents": [ev]}, required, ["write"])
    with pytest.raises(AssertionError, match="lacks"):
        cs.check_trace_events({"traceEvents": [
            {k: v for k, v in ev.items() if k != "dur"}]}, required, [])


#: the telemetry test's small sizes: one 10-frame stack, 2 RAFT iterations
SMALL = dict(device="cpu", stack_size=10, step_size=10, flow_iters=2,
             extraction_fps=1)


@pytest.fixture(scope="module")
def run_plane_phases(tmp_path_factory, sample_video):
    """The telemetry and alerts phases and the fleet step over both roots,
    on the CPU at :data:`SMALL` in one working directory (the alerts
    phase's cost turns at the 0.3 s interval only)."""
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp_path_factory.mktemp("run_plane"))
    try:
        telemetry = cs.telemetry_phase(video=sample_video, **SMALL)
        alerts = cs.alerts_phase(video=sample_video, intervals=(0.3,),
                                 **SMALL)
        fleet = cs.fleet_step({"telemetry": "output/chip_smoke/telemetry",
                               "alerts": cs.ALERTS_ROOT})
        yield dict(telemetry=telemetry, alerts=alerts, fleet=fleet)
    finally:
        mp.undo()


def test_telemetry_phase_runs_on_the_cpu(run_plane_phases):
    """The telemetry phase on the CPU at a small size (one 10-frame stack,
    2 RAFT iterations): the run plane on and off give equal features, and
    every artifact checks; no lookup kernel runs on the CPU."""
    stats = run_plane_phases["telemetry"]
    assert stats["max_abs_on_vs_off"] == 0.0 and stats["stacks"] == 1
    assert stats["proj_launches"] == {"off": 0, "on": 0, "capture_off": 0,
                                      "repeat": 0}
    assert stats["health_records"] == 4
    assert {"decode", "h2d", "forward", "write"} <= set(
        stats["stage_totals"])
    assert stats["topology_device_name"] is None
    assert stats["profiler_trace_bytes"] > 0
    # roofline and parity on: counted on the CPU, no peak resolved there
    # (measure_peak needs a card), records at i3d's three seams, live
    # sections; the repeat run times its second, uncounted dispatch alone
    for run in ("on", "capture_off", "repeat"):
        doc = stats["roofline"][run]
        assert doc["device"]["source"] == "unresolved"
        assert doc["flops_total"] > 0 and doc["mfu"] is None
    assert stats["roofline"]["repeat"]["flops_total"] == stats["roofline"][
        "capture_off"]["flops_total"]
    assert isinstance(stats["counting_pass_s"], float)
    assert {s for s, n in stats["parity_seams"].items() if n} == set(
        cs.I3D_SEAMS)
    assert stats["heartbeat_parity"]["records"] == sum(
        stats["parity_seams"].values())
    assert stats["heartbeat_roofline"]["families"]["i3d"]["dispatches"] == 1
    # history and alerts on the on runs: at least the first and the final
    # sample (a run slower than the 30 s interval adds a tick's), no alert;
    # the last sample's MFU the heartbeat's (None on the CPU)
    for run in ("on", "capture_off", "repeat"):
        plane = stats["alert_plane"][run]
        assert plane["samples"] >= 2 and plane["transitions"] == []
        assert plane["last_mfu"] == {"i3d": None}


def test_alerts_phase_and_fleet_step_run_on_the_cpu(run_plane_phases):
    """The alerts phase at the small size: the fault run fires one
    ``failure_spike`` with a verified bundle holding the live roofline
    summary, then resolves; the cost turns keep their features and write
    no history with the keys off; one tick's evaluation timed. The fleet
    step over both roots; the printed line's keys. No proj launch on the
    CPU."""
    stats = run_plane_phases["alerts"]
    fault = stats["fault"]
    assert fault["proj_launches"] == 0
    assert fault["transitions"] == [("failure_spike", "firing"),
                                    ("failure_spike", "resolved")]
    assert fault["history_samples"] >= 2
    assert fault["bundle_roofline_device"]["device_kind"] == "cpu"
    # the run's trace is written at its exit, after the alert fired
    assert {"alert.json", "roofline.json"} <= set(fault["bundle_paths"])
    assert "trace_window.json" not in fault["bundle_paths"]
    assert fault["bundle_artifacts"] == len(fault["bundle_paths"])
    assert fault["bundle_bytes"] > 0
    assert set(stats["walls_s"]) == {"0.3"}
    assert {k: len(v) for k, v in stats["walls_s"]["0.3"].items()} == {
        "off": 2, "on": 2, "span_off": 2, "span_on": 2}
    assert sorted(stats["planes"]) == ["0.3_on1", "0.3_on2"]
    assert stats["eval_ms_per_tick"] > 0 and stats["eval_errors"] == 0
    fleet = run_plane_phases["fleet"]
    for root in ("telemetry", "alerts"):
        assert fleet[root]["hosts"] >= 2 and fleet[root]["prom_series"]
        assert fleet[root]["roofline_device"] == "cpu"
        assert fleet[root]["stitched_lanes"] == fleet[root]["hosts"]
    line = cs.alerts_plane_line(run_plane_phases["telemetry"], stats,
                                "card, 700 W")
    assert set(line) == {
        "card", "history_samples", "transitions", "bundle_artifacts",
        "bundle_bytes", "eval_ms_per_tick", "observe_root_ms", "walls_s",
        "mfu_regression_on_clean_runs"}
    assert line["mfu_regression_on_clean_runs"] == []
    assert set(line["history_samples"]) == {
        "telemetry_on", "telemetry_capture_off", "telemetry_repeat",
        "turn_0.3_on1", "turn_0.3_on2", "fault"}
    json.dumps(line)


def test_check_roofline_and_parity_fail_bad_artifacts(tmp_path):
    from video_features_tpu_torch.telemetry import roofline

    doc = {"schema": roofline.SCHEMA_VERSION, "time": 0.0, "wall_s": 1.0,
           "device": {}, "families": {"i3d": {
               "programs": [], "flops_total": 0.0, "bytes_total": 0.0,
               "dispatches": 1, "forward_s": 0.1, "wall_s": 1.0}}}
    with pytest.raises(AssertionError, match="_roofline.json"):
        cs.check_roofline(doc, None, 0)
    doc["families"]["i3d"]["flops_total"] = 1e12
    assert cs.check_roofline(doc, None, 0)["flops_total"] == 1e12
    with pytest.raises(AssertionError, match="roofline device"):
        cs.check_roofline(doc, "NVIDIA H100 80GB HBM3", 40)
    path = tmp_path / "_parity.jsonl"
    path.write_text(json.dumps({"seam": "decode"}) + "\n")
    with pytest.raises(AssertionError, match="parity records"):
        cs.check_parity(str(path))


def test_certify_phase_runs_on_the_cpu(tmp_path, monkeypatch, sample_video):
    """The certify phase on the CPU at a small size (RAFT at 2 iterations,
    both flows at 64 px): a valid verdict per flip, held, the upstream
    seams bit-exact, every seam captured."""
    monkeypatch.chdir(tmp_path)
    stats = cs.certify_phase(video=sample_video, device="cpu",
                             side_size=64, iters=2)
    assert set(stats) == {f for f, _ in cs.CERTIFY_FLIPS}
    for family, got in stats.items():
        assert got["verdict"] == "PASS", family
        for seam in ("decode", "transform"):
            assert got["seams"][seam]["max_abs"] == 0.0
        assert all(m["pairs"] > 0 for m in got["seams"].values())
    assert (tmp_path / "output" / "chip_smoke" / "certify" / "raft" /
            "_parity_verdict.json").exists()


@pytest.mark.parametrize("family,max_abs,cos,fails", [
    ("pwc", 2.5, 0.99, True), ("pwc", 0.1, 0.99, False),
    ("raft", 2.5, 0.99, False), ("raft", 3.5, 0.99, True),
    ("raft", 0.1, 0.9, True)])
def test_certify_phase_holds_the_verdict(monkeypatch, family, max_abs, cos,
                                         fails):
    """PWC's verdict must be ``PASS``; RAFT's FAIL at ``backbone`` stands
    within its band's cosine and 1.5x its max abs, and no further."""
    def certify(fam, flip, videos, out_dir, extra_overrides):
        band = cs.parity.tolerance_for(fam, "backbone")
        seams = {s: dict(pairs=1, max_abs=0.0, mean_abs=0.0, cos=1.0,
                         tol_max_abs=0.0, tol_cos=1.0, ok=True)
                 for s in ("decode", "transform")}
        ok = max_abs <= band["max_abs"] and cos >= band["cos"]
        for s in ("backbone", "head"):
            seams[s] = dict(pairs=1, max_abs=max_abs, mean_abs=0.1, cos=cos,
                            tol_max_abs=band["max_abs"],
                            tol_cos=band["cos"], ok=ok)
        if fam != family:
            seams["backbone"] = seams["head"] = dict(
                seams["decode"], max_abs=0.01)
            ok = True
        return dict(verdict="PASS" if ok else "FAIL",
                    first_drift=None if ok else "backbone", seams=seams)

    monkeypatch.setattr(cs.parity, "certify", certify)
    monkeypatch.setattr(cs.parity, "validate_verdict", lambda doc: [])
    if fails:
        with pytest.raises(AssertionError, match=f"certify {family}"):
            cs.certify_phase(video="v.mp4")
    else:
        assert cs.certify_phase(video="v.mp4")[family]["verdict"] in (
            "PASS", "FAIL")
