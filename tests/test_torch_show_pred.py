"""``show_pred`` of i3d, raft and pwc on the port against the JAX package.

- ``utils/flow_viz.py``: the colour wheel and ``flow_to_image`` bit-equal to
  JAX's on seeded flows (zero flow, ``clip_flow``, BGR order among them).
- i3d two-stream RAFT with ``show_pred=true`` on 21 seeded frames (two
  10-frame stacks, a group each), both packages reading the same seeded
  checkpoints: the ``At stack {n} ({stream} stream)`` lines equal, each
  stack's 400 logits within 5e-4 of JAX's (tests/test_torch_i3d.py's band),
  and the printed top-5 equal, where the test asserts that JAX's top six
  logits lie further apart than twice the largest difference measured, so
  the order cannot flip inside it. ``resize=device`` warns and runs on the
  host in both. The features with ``show_pred`` are bit-equal to the
  port's own run without it.
- raft and pwc with no display: ``cv2.imshow`` raises ``cv2.error`` (the
  path JAX takes without a display), and each flow is written to
  ``flow_pred_{i}.png`` under the run's ``tmp_path``, equal byte for byte
  to what JAX's ``maybe_show_pred`` writes for the same flows and frames.
"""
import contextlib
import io
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from video_features_tpu.utils import flow_viz as jviz
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.utils import flow_viz as tviz

FPS = 25.0
#: tests/test_torch_i3d.py's band for I3D features and logits
LOGITS_ATOL = 5e-4


def _flows(seed, h=23, w=31):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(h, w, 2)) * rng.uniform(0.5, 30)).astype(
        np.float32)


@pytest.mark.parametrize("case", ["plain", "zero", "clip", "bgr", "wide"])
def test_flow_to_image_matches_jax(case):
    np.testing.assert_array_equal(tviz.make_colorwheel(),
                                  jviz.make_colorwheel())
    flow = {"zero": np.zeros((8, 9, 2), np.float32),
            "wide": _flows(4, 240, 320)}.get(case, _flows(len(case)))
    kwargs = {"clip": dict(clip_flow=5.0),
              "bgr": dict(convert_to_bgr=True)}.get(case, {})
    got = tviz.flow_to_image(flow, **kwargs)
    want = jviz.flow_to_image(flow, **kwargs)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == flow.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)


def _frames(n, h=240, w=320, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for t in range(n):
        f = np.stack([127 + 100 * np.sin(xx / 23 + t / 5),
                      127 + 100 * np.sin(yy / 17 - t / 7),
                      127 + 100 * np.sin((xx + yy) / 31 + t / 3)], -1)
        f += rng.normal(0, 8, f.shape)
        out.append((f.clip(0, 255).astype(np.uint8), t / FPS * 1000.0, t))
    return out


def _i3d_overrides(tmp):
    return {"feature_type": "i3d", "video_paths": "synthetic.mp4",
            "device": "cpu", "flow_type": "raft", "flow_iters": 2,
            "stack_size": 10, "step_size": 10, "clip_batch_size": 1,
            "resize": "device", "precision": "float32", "show_pred": True,
            "allow_random_weights": True, "on_extraction": "print",
            "output_path": str(tmp / "out"), "tmp_path": str(tmp / "tmp")}


class _Recorder:
    """Wraps a module's ``show_predictions_on_dataset``: keeps each row it
    is given and prints as the original does."""

    def __init__(self, original):
        self.original, self.rows = original, []

    def __call__(self, logits, dataset, k=5):
        self.rows.append(np.asarray(logits, np.float32)[0].copy())
        self.original(logits, dataset, k)


@pytest.fixture(scope="module")
def i3d_runs(tmp_path_factory):
    """Both packages' i3d RAFT extractors with ``show_pred=true`` over the
    same frames, reading the same seeded checkpoints (``weights_path``,
    ``flow_weights_path``, ``flow_model_weights_path``): (JAX stdout, JAX
    logits rows, port stdout, port logits rows, port features, port
    features without show_pred)."""
    from video_features_tpu import config as jconfig
    from video_features_tpu.extractors import i3d as jex_mod
    from video_features_tpu.extractors.i3d import ExtractI3D as JaxI3D
    from video_features_tpu_torch.extractors import i3d as tex_mod
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    from video_features_tpu_torch.models import i3d as ti3d
    from video_features_tpu_torch.models import raft as traft
    from video_features_tpu_torch.weights.bridge import seeded_init_

    tmp = tmp_path_factory.mktemp("show_pred_i3d")
    over = _i3d_overrides(tmp)
    for key, net, seed in (
            ("weights_path", ti3d.I3D(400, in_channels=3), 31),
            ("flow_weights_path", ti3d.I3D(400, in_channels=2), 32),
            ("flow_model_weights_path", traft.RAFT(2), 33)):
        over[key] = str(tmp / f"{key}.pt")
        torch.save(seeded_init_(net, seed).state_dict(), over[key])
    frames = _frames(21)
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("VFT_WEIGHTS_DIR", str(tmp / "weights"))
        jrec = _Recorder(jex_mod.show_predictions_on_dataset)
        mp.setattr(jex_mod, "show_predictions_on_dataset", jrec)
        jcfg = jconfig.load_config("i3d", over)
        jconfig.sanity_check(jcfg)
        jbuf = io.StringIO()
        with contextlib.redirect_stdout(jbuf):
            jex = JaxI3D(jcfg)
            jex.video_source = lambda *a, transform=None, **k: \
                types.SimpleNamespace(fps=FPS, frames=lambda: iter(
                    [(transform(f), t, i) for f, t, i in frames]))
            jex.extract("synthetic.mp4")

        trec = _Recorder(tex_mod.show_predictions_on_dataset)
        mp.setattr(tex_mod, "show_predictions_on_dataset", trec)
        tcfg = tconfig.load_config("i3d", over)
        tconfig.sanity_check(tcfg)
        tbuf = io.StringIO()
        with contextlib.redirect_stdout(tbuf):
            tex = ExtractI3D(tcfg)
            feats = tex.extract_frames(iter(frames), FPS)
        tex.show_pred = False
        plain = tex.extract_frames(iter(frames), FPS)
    finally:
        mp.undo()
        for key in ("weights_path", "flow_weights_path",
                    "flow_model_weights_path"):
            Path(over[key]).unlink(missing_ok=True)
    return dict(jout=jbuf.getvalue(), jrows=jrec.rows, tout=tbuf.getvalue(),
                trows=trec.rows, feats=feats, plain=plain,
                resize_mode=(jex.resize_mode, tex.resize_mode))


def _tables(out):
    """(header line, [(logit, prob, label), ...]) per ``At stack`` block."""
    blocks = []
    for line in out.splitlines():
        if line.startswith("At stack"):
            blocks.append((line, []))
        m = re.match(r"^\s*(-?[0-9.]+) \| ([0-9.]+) \| (.*)$", line)
        if m and blocks:
            blocks[-1][1].append((float(m[1]), float(m[2]), m[3]))
    return blocks


def test_i3d_show_pred_lines_match_jax(i3d_runs):
    r = i3d_runs
    assert r["resize_mode"] == ("host", "host")
    warning = "WARNING: resize=device is unsupported with show_pred"
    assert warning in r["jout"] and warning in r["tout"]
    jt, tt = _tables(r["jout"]), _tables(r["tout"])
    heads = [h for h, _ in jt]
    # one stack a group: each group prints its rgb then its flow table,
    # numbered across groups
    assert heads == [f"At stack {n} ({s} stream)" for n, s in (
        (0, "rgb"), (0, "flow"), (1, "rgb"), (1, "flow"))]
    assert [h for h, _ in tt] == heads
    assert len(r["jrows"]) == len(r["trows"]) == 4
    assert all(jl.shape == tl.shape == (400,)
               for jl, tl in zip(r["jrows"], r["trows"]))
    # d: how far the port's logits lie from JAX's, inside the band
    d = max(float(np.abs(tl - jl).max())
            for jl, tl in zip(r["jrows"], r["trows"]))
    assert d <= LOGITS_ATOL
    for (head, jrows), (_, trows), jl in zip(jt, tt, r["jrows"]):
        # two rows d apart entry by entry print the same ordered top-5
        # where JAX's top six lie more than 2 d apart: asserted, not assumed
        gaps = -np.diff(np.sort(jl)[::-1][:6])
        assert gaps.min() > 2 * d, (head, d, gaps)
        assert [x[2] for x in trows] == [x[2] for x in jrows], head
        np.testing.assert_allclose([x[:2] for x in trows],
                                   [x[:2] for x in jrows], atol=2e-3)


def test_i3d_show_pred_keeps_the_features(i3d_runs):
    feats, plain = i3d_runs["feats"], i3d_runs["plain"]
    for key in ("rgb", "flow", "timestamps_ms"):
        assert feats[key].shape == plain[key].shape
        assert feats[key].tobytes() == plain[key].tobytes(), key
    assert feats["rgb"].shape == (2, 1024)


@pytest.mark.parametrize("family", ["raft", "pwc"])
def test_flow_show_pred_writes_pngs_without_a_display(family, tmp_path,
                                                      monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from video_features_tpu.extractors.flow import OpticalFlowExtractor
    from video_features_tpu_torch.extractors.pwc import ExtractPWC
    from video_features_tpu_torch.extractors.raft import ExtractRAFT

    def no_display(*_):
        raise cv2.error("no display")

    monkeypatch.setattr(cv2, "imshow", no_display)
    over = {"device": "cpu", "allow_random_weights": True,
            "precision": "float32", "show_pred": True, "side_size": 32,
            "batch_size": 2, "video_paths": "synthetic.mp4",
            "output_path": str(tmp_path / "out"),
            "tmp_path": str(tmp_path / "port")}
    if family == "raft":
        over["iters"] = 2
    cfg = tconfig.load_config(family, over)
    tconfig.sanity_check(cfg)
    frames = _frames(5, 48, 64, seed=3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex = {"raft": ExtractRAFT, "pwc": ExtractPWC}[family](cfg)
        flows = ex.extract_frames(iter(frames), FPS)[family]
    assert ex.resize_mode == "host"
    assert flows.shape == (4, 2, 32, 42)
    wrote = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("show_pred: no display; wrote ")]
    assert len(wrote) == 4  # one per flow; a batch's files replace the last
    # the last batch (frames 2-4) through JAX's show_pred on the same flows
    last = np.stack([ex.host_transform(f) for f, _, _ in frames[2:]])
    jtmp = tmp_path / "jax"
    jax_buf = io.StringIO()
    with contextlib.redirect_stdout(jax_buf):
        OpticalFlowExtractor.maybe_show_pred(
            types.SimpleNamespace(show_pred=True, tmp_path=str(jtmp)),
            flows[2:].transpose(0, 2, 3, 1), last)
    for i in range(2):
        got = tmp_path / "port" / family / f"flow_pred_{i}.png"
        assert got.read_bytes() == (jtmp / f"flow_pred_{i}.png").read_bytes()
        img = cv2.imread(str(got))
        assert img.shape == (64, 42, 3)
    assert jax_buf.getvalue().count("no display") == 2
