"""The port's multi-family run over one shared decode against the JAX
package's (``parallel/fanout.py``, ``extractors/multi.py``, the CLI's comma
list).

- The port's ``FrameBus`` delivers each subscriber the stream of the port's
  private ``VideoSource`` and of the JAX ``FrameBus`` for the same plan, bit
  for bit: frames, timestamps, indices, ``fps`` and ``len``, for resampled,
  native and ``extraction_total`` plans, ``rgb`` and ``i420``, with the
  queues one frame deep and 64 deep; it decodes each source frame once,
  fewer than the private sources together. A probe failure fails every
  family as POISON in both packages; an abandoned subscriber is skipped.
- The multi-family CLI (resnet18, r21d at ``extraction_fps=1``, vggish with
  a seeded stand-in for the wav rip, the JAX package's ``FAMILY_OVERRIDES``)
  writes each family's outputs bit-identical to its single-family run, with
  ``video_workers`` 1 and 2, and within the value tier (atol 1e-2) of the
  JAX multi-family CLI on the same checkpoints (``<family>.weights_path``).
- Every family skipped up front builds no session; a POISON family fails
  and journals alone; configs route per-family overrides as JAX's do.
"""
import contextlib
import io
import json
import shutil
import threading
import wave
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from video_features_tpu.parallel.fanout import FrameBus as JaxBus
from video_features_tpu.utils import faults as jfaults
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.parallel import fanout
from video_features_tpu_torch.parallel.fanout import FrameBus
from video_features_tpu_torch.utils import faults as tfaults
from video_features_tpu_torch.utils import io as tio

#: the JAX package's tests/test_multi_family.py sizes
FAMILY_OVERRIDES = {
    "resnet": ["resnet.model_name=resnet18", "resnet.batch_size=8",
               "resnet.extraction_total=6"],
    "r21d": ["r21d.extraction_fps=1", "r21d.stack_size=10",
             "r21d.step_size=10"],
    "vggish": [],
}
#: rips of the stand-in, by stem
RIPS = {}


def _fake_rip(video_path, tmp_path):
    """A seeded per-stem tone standing in for the ffmpeg wav rip (the
    sample has no audio track): the same function for both packages and
    both kinds of run, distinct per video."""
    stem = Path(video_path).stem
    RIPS[stem] = RIPS.get(stem, 0) + 1
    freq = 200.0 + zlib.crc32(stem.encode()) % 500
    t = np.arange(int(16000 * 2.5)) / 16000.0
    tone = (0.4 * np.sin(2 * np.pi * freq * t) * 32767).astype("<i2")
    Path(tmp_path).mkdir(parents=True, exist_ok=True)
    wav = Path(tmp_path) / f"{stem}.wav"
    aac = Path(tmp_path) / f"{stem}.aac"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(tone.tobytes())
    aac.write_bytes(b"")
    return str(wav), str(aac)


@pytest.fixture(scope="module", autouse=True)
def _patched_wav_rip():
    mp = pytest.MonkeyPatch()
    mp.setattr("video_features_tpu_torch.extractors.vggish."
               "extract_wav_from_mp4", _fake_rip)
    mp.setattr("video_features_tpu.extractors.vggish."
               "extract_wav_from_mp4", _fake_rip)
    yield
    mp.undo()


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        fn(*args)
    return out.getvalue()


# ------------------------------------------------------------------ the bus

def _consume(bus, specs):
    got, errs = {}, []

    def run(name, kw):
        try:
            sub = bus.subscribe(name, **kw)
            got[name] = (list(sub.frames()), sub.fps, len(sub))
        except BaseException as e:  # surfaced below
            errs.append((name, e))

    threads = [threading.Thread(target=run, args=(n, kw))
               for n, kw in specs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    return got


def _assert_same(got, want, what):
    frames, fps, n = got
    wframes, wfps, wn = want
    assert (fps, n) == (wfps, wn), what
    assert len(frames) == len(wframes) == n, what
    for (xg, tg, ig), (xw, tw, iw) in zip(frames, wframes):
        assert (tg, ig) == (tw, iw), what
        np.testing.assert_array_equal(xg, xw, err_msg=what)


@pytest.mark.parametrize("depth", [2, 64])
def test_bus_matches_private_sources_and_jax_bus(sample_video, depth):
    def tf(x):
        return x[::4, ::4].astype(np.float32) / 255.0

    specs = {
        "resampled": dict(fps=3, transform=tf, channel_order="rgb"),
        "native": dict(transform=tf, channel_order="rgb"),
        "total": dict(total=7, channel_order="i420"),
    }
    before = tio.decoded_frames()
    bus = FrameBus(sample_video, list(specs), depth=depth)
    got = _consume(bus, specs)
    assert tio.decoded_frames() - before == bus.decoded
    jgot = _consume(JaxBus(sample_video, list(specs), depth=depth), specs)
    private = 0
    for name, kw in specs.items():
        before = tio.decoded_frames()
        src = tio.VideoSource(sample_video, **kw)
        want = (list(src.frames()), src.fps, len(src))
        private += tio.decoded_frames() - before
        _assert_same(got[name], want, f"{name} vs VideoSource")
        _assert_same(got[name], jgot[name], f"{name} vs the JAX bus")
    # the native plan walks every frame once; the others ride along
    assert bus.decoded == len(got["native"][0]) < private


def test_bus_probe_failure_poisons_every_family(tmp_path):
    bad = tmp_path / "not_a_video.mp4"
    bad.write_bytes(b"junk")
    for bus, classify, poison in (
            (FrameBus(str(bad), ["a"], depth=4), tfaults.classify,
             tfaults.POISON),
            (JaxBus(str(bad), ["a"], depth=4), jfaults.classify,
             jfaults.POISON)):
        with pytest.raises(RuntimeError,
                           match="shared decode probe failed") as ei:
            bus.subscribe("a", fps=2)
        assert classify(ei.value) == poison
        # a repeat or unexpected family declines: it decodes privately
        assert bus.subscribe("a") is None and bus.subscribe("b") is None


def test_bus_skips_an_abandoned_subscriber(sample_video):
    """One family leaves after two frames: the bus, one frame deep, goes on
    serving the other to the end."""
    bus = FrameBus(sample_video, ["quits", "stays"], depth=2)
    got = {}

    def quits():
        sub = bus.subscribe("quits", total=50)
        frames = sub.frames()
        got["quits"] = [next(frames)[2], next(frames)[2]]
        sub.close()

    def stays():
        sub = bus.subscribe("stays", total=20)
        got["stays"] = [i for _, _, i in sub.frames()]

    threads = [threading.Thread(target=f) for f in (quits, stays)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert got == {"quits": [0, 1], "stays": list(range(20))}


def test_bus_under_thread_stress(sample_video):
    """Twelve subscribers (more than the cores) on queues one frame deep,
    with the interpreter switching threads every 10 us: each gets its own
    plan's indices in order, and the bus decodes each source frame once."""
    import sys
    totals = [3, 5, 7, 9, 11, 13, 17, 19, 23, 29, 31, 37]
    specs = {f"f{t}": dict(total=t, transform=lambda x: x[:2, :2].copy())
             for t in totals}
    bus = FrameBus(sample_video, list(specs), depth=2)
    got, errs = {}, []

    def run(name, kw):
        try:
            got[name] = [i for _, _, i in bus.subscribe(name, **kw).frames()]
        except BaseException as e:  # surfaced below
            errs.append((name, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(n, kw))
                   for n, kw in specs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    assert got == {f"f{t}": list(range(t)) for t in totals}
    last = max(int(tio.VideoSource(sample_video, total=t).index_map[-1])
               for t in totals)
    assert bus.decoded == last + 1


# ------------------------------------------------------------- the CLI

def _base_args(tmp, videos):
    return ["device=cpu", "allow_random_weights=true",
            "on_extraction=save_numpy", "retry_attempts=1",
            f"tmp_path={tmp / 'tmp'}", f"video_paths=[{','.join(videos)}]"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, sample_video):
    td = tmp_path_factory.mktemp("multi_corpus")
    vids = []
    for i in range(2):
        dst = td / f"v_mf_{i}.mp4"
        shutil.copy(sample_video, dst)
        vids.append(str(dst))
    return td, vids


@pytest.fixture(scope="module")
def single_runs(corpus):
    """The port's single-family outputs, and the frames each decoded."""
    from video_features_tpu_torch.cli import main
    td, vids = corpus
    out = td / "single"
    decoded = 0
    for fam, over in FAMILY_OVERRIDES.items():
        flat = [o.split(".", 1)[1] for o in over]
        before = tio.decoded_frames()
        _quiet(main, [f"feature_type={fam}", f"output_path={out}"] + flat
               + _base_args(td, vids))
        decoded += tio.decoded_frames() - before
    return out, decoded


def _multi_argv(out, extra=()):
    return ([f"feature_type={','.join(FAMILY_OVERRIDES)}",
             f"output_path={out}"]
            + [o for over in FAMILY_OVERRIDES.values() for o in over]
            + list(extra))


@pytest.mark.parametrize("workers", [1, 2])
def test_multi_cli_bit_identical_to_singles(corpus, single_runs, tmp_path,
                                            workers):
    from video_features_tpu_torch.cli import main
    td, vids = corpus
    singles, single_decoded = single_runs
    out = tmp_path / "multi"
    RIPS.clear()
    before = tio.decoded_frames()
    text = _quiet(main, _multi_argv(out, [f"video_workers={workers}"])
                  + _base_args(td, vids))
    decoded = tio.decoded_frames() - before
    want = sorted(p.relative_to(singles) for p in singles.rglob("*.npy"))
    got = sorted(p.relative_to(out) for p in out.rglob("*.npy"))
    # resnet's [resnet, fps, timestamps_ms], r21d and vggish, x2 videos
    assert want == got and len(want) == 10
    for rel in want:
        np.testing.assert_array_equal(
            np.load(singles / rel), np.load(out / rel),
            err_msg=f"{rel}: single-family vs shared decode "
                    f"(video_workers={workers})")
    assert "2/2 videos x 3 families" in text and "6 extracted" in text
    for fam in FAMILY_OVERRIDES:
        assert f"  {fam}: 2 extracted, 0 already done, 0 failed" in text
    # one decode of each video for the visual families; one rip a video
    assert 0 < decoded < single_decoded
    assert RIPS == {Path(v).stem: 1 for v in vids}
    assert not list((out / "vggish").rglob("*.wav"))  # the session cleaned


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Seeded checkpoints in the reference's torch key layouts, read by both
    packages through ``<family>.weights_path``; removed when the module's
    tests are done."""
    from video_features_tpu_torch.models import r21d, resnet, vggish
    from video_features_tpu_torch.weights.bridge import seeded_init_
    td = tmp_path_factory.mktemp("multi_ckpt")
    nets = {"resnet": resnet.ResNet("resnet18"),
            "r21d": r21d.R2Plus1D("r2plus1d_18_16_kinetics"),
            "vggish": vggish.VGGish()}
    paths = {}
    for i, (fam, net) in enumerate(nets.items()):
        paths[fam] = td / f"{fam}.pt"
        torch.save(seeded_init_(net, 20 + i).state_dict(), paths[fam])
    yield paths
    for path in paths.values():
        path.unlink(missing_ok=True)


def test_multi_cli_matches_jax_multi_cli(corpus, checkpoints, tmp_path):
    from video_features_tpu.cli import main as jmain
    from video_features_tpu_torch.cli import main as tmain
    td, vids = corpus
    weights = [f"{f}.weights_path={p}" for f, p in checkpoints.items()]
    runs = {}
    for name, main in (("port", tmain), ("jax", jmain)):
        out = tmp_path / name
        _quiet(main, _multi_argv(out, weights)
               + _base_args(tmp_path / f"{name}_work", vids[:1]))
        runs[name] = out
    rels = sorted(p.relative_to(runs["jax"])
                  for p in runs["jax"].rglob("*.npy"))
    assert rels == sorted(p.relative_to(runs["port"])
                          for p in runs["port"].rglob("*.npy"))
    assert len(rels) == 5
    for rel in rels:
        want, got = np.load(runs["jax"] / rel), np.load(runs["port"] / rel)
        assert got.shape == want.shape, rel
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2,
                                   err_msg=str(rel))


def test_multi_all_skipped_runs_zero_decode(corpus, single_runs,
                                            monkeypatch):
    """Over complete outputs every family skips up front: no session, no
    decode, no rip, and the tally counts the skips per family."""
    from video_features_tpu_torch.cli import main
    td, vids = corpus
    singles, _ = single_runs

    def must_not_build(*a, **kw):
        raise AssertionError("every family is done: no shared session")
    monkeypatch.setattr(fanout, "SharedDecodeSession", must_not_build)
    RIPS.clear()
    before = tio.decoded_frames()
    text = _quiet(main, _multi_argv(singles) + _base_args(td, vids))
    assert tio.decoded_frames() == before and RIPS == {}
    assert f"{len(FAMILY_OVERRIDES) * len(vids)} already done" in text
    for fam in FAMILY_OVERRIDES:
        assert f"{fam}: 0 extracted, {len(vids)} already done" in text


def test_poison_family_is_isolated(corpus, tmp_path):
    """A POISON failure in one family's transform fails and journals that
    family alone; its sibling's outputs and journal stay clean, and the
    quarantine on the next run touches the poisoned family only."""
    from video_features_tpu_torch.extractors.multi import MultiExtractor
    td, vids = corpus
    out = tmp_path / "iso"
    per = tconfig.load_multi_config(["resnet", "r21d"], {
        "feature_type": "resnet,r21d", "device": "cpu",
        "allow_random_weights": True, "on_extraction": "save_numpy",
        "retry_attempts": 1, "output_path": str(out),
        "tmp_path": str(tmp_path / "t"), "video_paths": vids[0],
        "resnet": {"model_name": "resnet18", "batch_size": 8,
                   "extraction_total": 6},
        "r21d": {"extraction_fps": 1, "stack_size": 10, "step_size": 10}})
    tconfig.sanity_check_multi(per)
    multi = MultiExtractor(per)

    def poison(frame):
        raise tfaults.PoisonError("injected: this family chokes")
    multi.extractors["r21d"].host_transform = poison
    failures = []
    statuses = _quiet_call(multi.run_video, vids[0], failures)
    assert statuses == {"resnet": "done", "r21d": "error"}
    assert [f["family"] for f in failures] == ["r21d"]
    stem = Path(vids[0]).stem
    assert (out / "resnet" / "resnet18" / f"{stem}_resnet.npy").exists()
    recs = [json.loads(line) for line in open(multi.journals["r21d"].path)]
    assert recs and recs[-1]["category"] == "POISON"
    assert not Path(multi.journals["resnet"].path).exists()
    assert _quiet_call(multi.run_video, vids[0], None) == {
        "resnet": "skipped", "r21d": "quarantined"}


def _quiet_call(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*args)


# ------------------------------------------------------------- the configs

def test_multi_config_routes_overrides_like_jax(tmp_path):
    from video_features_tpu import config as jconfig
    over = {"feature_type": "resnet,clip", "extraction_fps": 1,
            "device": "cpu", "on_extraction": "save_numpy",
            "video_paths": "v.mp4", "output_path": str(tmp_path / "o"),
            "tmp_path": str(tmp_path / "t"),
            "clip": {"extraction_fps": 2, "batch_size": 4}}
    port = tconfig.load_multi_config(["resnet", "clip"], over)
    jax_ = jconfig.load_multi_config(["resnet", "clip"], over)
    assert list(port) == list(jax_) == ["resnet", "clip"]
    for fam in port:
        assert port[fam].extraction_fps == jax_[fam].extraction_fps
        assert port[fam].batch_size == jax_[fam].batch_size
        assert port[fam].feature_type == fam
    assert (port["resnet"].extraction_fps, port["clip"].extraction_fps) \
        == (1, 2)
    tconfig.sanity_check_multi(port, require_videos=False)
    assert port["clip"].output_path == str(tmp_path / "o" / "clip" /
                                           "ViT-B_32")
    for pkg in (tconfig, jconfig):
        with pytest.raises(ValueError, match="override block vggish"):
            pkg.load_multi_config(["resnet", "clip"],
                                  dict(over, vggish={"x": 1}))
    for bad, match in ((dict(on_extraction="print"), "file sink"),
                       (dict(show_pred=True), "show_pred"),
                       (dict(fps_mode="reencode"), "reencode")):
        for pkg in (tconfig, jconfig):
            per = pkg.load_multi_config(["resnet", "clip"],
                                        dict(over, **bad))
            with pytest.raises(ValueError, match=match):
                pkg.sanity_check_multi(per, require_videos=False)
    assert tconfig.parse_dotlist(["clip.extraction_fps=2", "a.b.c=x"]) == \
        jconfig.parse_dotlist(["clip.extraction_fps=2", "a.b.c=x"])


@pytest.mark.parametrize("spec,err", [
    ("resnet,clip", None), (" r21d , vggish ", None),
    ("resnet,nosuch", NotImplementedError), (",", NotImplementedError),
    ("clip,clip", ValueError)])
def test_parse_feature_types_like_jax(spec, err):
    from video_features_tpu import registry as jreg
    from video_features_tpu_torch import registry as treg
    assert treg.AUDIO_FAMILIES == jreg.AUDIO_FAMILIES
    if err is None:
        assert treg.parse_feature_types(spec) == \
            jreg.parse_feature_types(spec)
        return
    for reg in (treg, jreg):
        with pytest.raises(err):
            reg.parse_feature_types(spec)


@pytest.mark.parametrize("depth,ok", [(None, True), (2, True), (1, False)])
def test_fanout_depth_checked_like_jax(depth, ok, tmp_path):
    """``fanout_depth``, a launch-time key: 2 or more, default 64."""
    from video_features_tpu.parallel import fanout as jfanout
    from video_features_tpu_torch.extractors.multi import MultiExtractor
    per = tconfig.load_multi_config(["vggish"], {
        "fanout_depth": depth, "on_extraction": "save_numpy",
        "output_path": str(tmp_path / "o")})
    built = {"vggish": object()}  # no model: the check comes first
    if ok:
        multi = MultiExtractor(per, extractors=built)
        assert multi.fanout_depth == (depth or jfanout.DEFAULT_DEPTH)
        assert fanout.DEFAULT_DEPTH == jfanout.DEFAULT_DEPTH == 64
    else:
        with pytest.raises(ValueError, match="fanout_depth=1: need >= 2"):
            MultiExtractor(per, extractors=built)
