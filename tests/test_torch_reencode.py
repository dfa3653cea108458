"""``fps_mode=reencode`` in the port (``utils/io.py``) against the JAX
package's, on the vendored sample video.

- JAX ``tests/test_io.py``'s reencode cases on the port: the frame timing
  of ``select``, lossy but close pixels, the temp file removed after one
  pass (kept with ``keep_tmp``), ``total`` capped, a second pass raising,
  and the spawned sources refusing ``reencode`` with JAX's message;
- ``fps_filter_map`` equal to JAX's on a seeded sweep of ``(n, src_fps,
  dst_fps)``;
- the ``cv2`` backend: the frames decoded from the two packages' re-encodes
  are byte-equal; the ``ffmpeg`` backend: a stand-in ``ffmpeg`` on ``PATH``
  records the argv, which equals JAX's, and ``auto`` picks it;
- the temp file goes on ``cancel`` and ``release``; the config keys and
  their errors; a CLI run of the port with ``fps_mode=reencode``.
"""
import json
import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu import cache as jcache
from video_features_tpu.utils import io as jio
from video_features_tpu_torch import cache as tcache
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.utils import io as tio


def test_reencode_mode_same_frame_timing(sample_video, tmp_path):
    sel = tio.VideoSource(sample_video, batch_size=4, fps=2.0)
    ren = tio.VideoSource(sample_video, batch_size=4, fps=2.0,
                          fps_mode="reencode", tmp_path=str(tmp_path))
    sel_items = [(ts, idx) for _, ts, idx in sel.frames()]
    ren_items = [(ts, idx) for _, ts, idx in ren.frames()]
    assert len(sel_items) == len(ren_items) == sel.num_frames == len(ren)
    np.testing.assert_allclose([t for t, _ in sel_items],
                               [t for t, _ in ren_items], rtol=1e-9)
    assert ren.fps == pytest.approx(2.0)


def test_reencode_pixels_are_lossy_but_close(sample_video, tmp_path):
    sel = [f for f, _, _ in tio.VideoSource(sample_video, fps=2.0).frames()]
    ren = [f for f, _, _ in tio.VideoSource(
        sample_video, fps=2.0, fps_mode="reencode",
        tmp_path=str(tmp_path)).frames()]
    assert len(sel) == len(ren)
    deltas = [np.abs(a.astype(np.int16) - b.astype(np.int16)).mean()
              for a, b in zip(sel, ren)]
    assert max(deltas) > 0
    assert np.mean(deltas) < 20.0


def test_reencode_tmp_file_cleanup(sample_video, tmp_path):
    src = tio.VideoSource(sample_video, fps=2.0, fps_mode="reencode",
                          tmp_path=str(tmp_path))
    tmp_file = Path(src.path)
    assert tmp_file.name == f"{Path(sample_video).stem}_new_fps.mp4"
    assert tmp_file.exists()
    for _ in src.frames():
        pass
    assert not tmp_file.exists()
    keep = tio.VideoSource(sample_video, fps=2.0, fps_mode="reencode",
                           tmp_path=str(tmp_path), keep_tmp=True)
    for _ in keep.frames():
        pass
    assert Path(keep.path).exists()


def test_reencode_total_mode(sample_video, tmp_path):
    src = tio.VideoSource(sample_video, total=9, fps_mode="reencode",
                          tmp_path=str(tmp_path))
    frames = list(src.frames())
    assert 8 <= len(frames) <= 9
    jsrc = jio.VideoSource(sample_video, total=9, fps_mode="reencode",
                           tmp_path=str(tmp_path / "jax"))
    assert len(frames) == len(list(jsrc.frames()))
    assert (len(src), src.fps) == (len(jsrc), jsrc.fps)


def test_reencode_second_pass_raises(sample_video, tmp_path):
    src = tio.VideoSource(sample_video, fps=2.0, fps_mode="reencode",
                          tmp_path=str(tmp_path))
    for _ in src.frames():
        pass
    with pytest.raises(RuntimeError, match="single-pass"):
        next(src.frames())


@pytest.mark.parametrize("how", ["cancel", "release"])
def test_cancel_and_release_remove_the_tmp_file(sample_video, tmp_path,
                                                how):
    src = tio.VideoSource(sample_video, fps=2.0, fps_mode="reencode",
                          tmp_path=str(tmp_path))
    it = src.frames()
    next(it)
    tmp_file = Path(src.path)
    assert tmp_file.exists()
    getattr(src, how)()
    assert not tmp_file.exists()
    with pytest.raises(tio.DeadlineExceeded):
        list(it)


@pytest.mark.parametrize("cls,kw", [
    ("ParallelVideoSource", {"decode_workers": 2}),
    ("ProcessVideoSource", {})])
def test_spawned_decode_rejects_reencode(sample_video, tmp_path, cls, kw):
    with pytest.raises(NotImplementedError, match="fps_mode=select") as e:
        getattr(tio, cls)(sample_video, fps=2.0, fps_mode="reencode",
                          tmp_path=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError) as j:
        jio.ParallelVideoSource(sample_video, fps=2.0, decode_workers=2,
                                fps_mode="reencode", tmp_path=str(tmp_path))
    assert str(e.value) == str(j.value)


def test_source_arguments_raise_like_jax(sample_video):
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="requires tmp_path"):
            mod.VideoSource(sample_video, fps=2.0, fps_mode="reencode")
        with pytest.raises(ValueError, match="expected 'select' or"):
            mod.VideoSource(sample_video, fps=2.0, fps_mode="resample")


def test_fps_filter_map_equals_jax_on_a_seeded_sweep():
    rng = np.random.default_rng(19)
    for _ in range(300):
        n = int(rng.integers(0, 400))
        src = float(rng.choice([rng.uniform(1, 60), 25.0, 29.97, 19.62]))
        dst = float(rng.choice([rng.uniform(0.1, 90), src / 2, src, 1.0]))
        np.testing.assert_array_equal(tio.fps_filter_map(n, src, dst),
                                      jio.fps_filter_map(n, src, dst))
        for kw in ({"fps": dst}, {"total": int(rng.integers(1, 50))}, {},
                   {"total_cap": int(rng.integers(1, 50))}):
            t = tio.plan_frame_selection(src, n, **kw)
            j = jio.plan_frame_selection(src, n, **kw)
            assert (t[0], t[2]) == (j[0], j[2])
            assert (t[1] is None) == (j[1] is None)
            if t[1] is not None:
                np.testing.assert_array_equal(t[1], j[1])


def _decode_all(path):
    import cv2
    cap = cv2.VideoCapture(str(path))
    frames = []
    try:
        while True:
            ok, f = cap.read()
            if not ok:
                return frames
            frames.append(f)
    finally:
        cap.release()


def test_cv2_backend_decodes_byte_equal_to_jax(sample_video, tmp_path):
    t = tio.reencode_video_with_diff_fps(sample_video, tmp_path / "t", 3.0,
                                         backend="cv2")
    j = jio.reencode_video_with_diff_fps(sample_video, tmp_path / "j", 3.0,
                                         backend="cv2")
    assert Path(t).name == Path(j).name
    tf, jf = _decode_all(t), _decode_all(j)
    assert len(tf) == len(jf) == len(jio.fps_filter_map(355, 19.62, 3.0))
    for a, b in zip(tf, jf):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="unknown reencode backend"):
        tio.reencode_video_with_diff_fps(sample_video, tmp_path, 3.0,
                                         backend="nope")


@pytest.fixture()
def stand_in_ffmpeg(tmp_path, monkeypatch):
    """An ``ffmpeg`` first on ``PATH`` that appends its argv to a log and
    copies its input to its output."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "argv.jsonl"
    exe = bindir / "ffmpeg"
    exe.write_text(
        f"#!{sys.executable}\n"
        "import json, shutil, sys\n"
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "shutil.copyfile(sys.argv[sys.argv.index('-i') + 1], sys.argv[-1])\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return log


def test_ffmpeg_backend_argv_equals_jax(sample_video, tmp_path,
                                        stand_in_ffmpeg):
    outs = {}
    for name, mod, backend in (("port", tio, "ffmpeg"), ("jax", jio,
                                                         "ffmpeg"),
                               ("auto", tio, "auto")):
        outs[name] = mod.reencode_video_with_diff_fps(
            sample_video, tmp_path / "t", 2.5, backend=backend)
    calls = [json.loads(x) for x in stand_in_ffmpeg.read_text().split("\n")
             if x]
    new = str(tmp_path / "t" / f"{Path(sample_video).stem}_new_fps.mp4")
    want = ["-hide_banner", "-loglevel", "panic", "-y", "-i",
            str(sample_video), "-filter:v", "fps=fps=2.5", new]
    assert calls == [want] * 3
    assert outs["port"] == outs["jax"] == outs["auto"] == new
    # a source over the binary's output decodes it natively and removes it
    src = tio.VideoSource(sample_video, fps=2.5, fps_mode="reencode",
                          tmp_path=str(tmp_path / "s"))
    assert len(list(src.frames())) == len(src) > 0
    assert not Path(src.path).exists()


def test_config_keys_as_jax(tmp_path):
    from video_features_tpu.config import load_config as jload, \
        sanity_check as jcheck
    assert "fps_mode" in tcache.SEMANTIC_KEYS
    assert "fps_mode" in jcache.SEMANTIC_KEYS
    base = {"video_paths": "v.mp4", "device": "cpu",
            "output_path": str(tmp_path / "o"),
            "tmp_path": str(tmp_path / "t")}
    for value in ("reencode", "resample"):
        errs = []
        for load, check in ((tconfig.load_config, tconfig.sanity_check),
                            (jload, jcheck)):
            cfg = load("resnet", dict(base, fps_mode=value))
            try:
                check(cfg)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]
    multi = tconfig.load_multi_config(
        ["resnet", "r21d"], dict(base, on_extraction="save_numpy",
                                 fps_mode="reencode"))
    with pytest.raises(ValueError, match="unsupported in multi-family"):
        tconfig.sanity_check_multi(multi)


def test_cli_runs_reencode(sample_video, tmp_path):
    from video_features_tpu_torch.cli import main
    out, tmp = tmp_path / "o", tmp_path / "t"
    main(["feature_type=resnet", "model_name=resnet18", "device=cpu",
          "allow_random_weights=true", "extraction_total=4",
          "fps_mode=reencode", "on_extraction=save_numpy",
          f"output_path={out}", f"tmp_path={tmp}",
          f"video_paths={sample_video}"])
    stem = Path(sample_video).stem
    feats = np.load(out / "resnet" / "resnet18" / f"{stem}_resnet.npy")
    ts = np.load(out / "resnet" / "resnet18" / f"{stem}_timestamps_ms.npy")
    assert feats.shape == (len(ts), 512) and 3 <= len(ts) <= 4
    assert np.isfinite(feats).all()
    assert not list(tmp.rglob("*_new_fps.mp4"))
