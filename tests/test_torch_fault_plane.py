"""The port's fault plane against the JAX package's.

- ``classify`` and ``demote`` give JAX's verdicts, explicit markers and
  worker-forwarded error strings included; ``RetryPolicy.from_config``
  reads ``video_deadline_s`` as JAX does and rejects ``<= 0``.
- The deadline watchdog: a video whose decode hangs (a read that only the
  watchdog's release unblocks) fails TRANSIENT with a journal record after
  its retries, while the videos around it in the same run succeed; a source
  registered after the deadline fired is cancelled at once; cancelling an
  inline, process or parallel source mid-stream raises
  ``DeadlineExceeded`` in the consumer, and leaves no child alive.
- The decode ladder: retries of a ``video_decode=parallel`` video run
  ``process`` then ``inline``, as in JAX's ``safe_extract``, and
  ``BaseExtractor.video_source`` builds the source of each rung and
  registers it.
- ``ProcessVideoSource`` and ``ParallelVideoSource`` give the port's
  ``VideoSource``'s frames, timestamps and indices exactly on
  tests/assets/v_synth_sample.mp4 (a host transform crossing into the
  child, batches with overlap, more segments than one); with metadata
  that reports no frames, ``ParallelVideoSource`` counts them by decode
  and gives the whole stream; a frame-wise extractor under
  ``video_decode=process|parallel`` gives its inline features exactly
  (``resize=device``: raw frames through the children's queues);
  every family's host transform pickles.
- ``inject``: one plan parses to JAX's rules and fires at JAX's hits for
  three seeds; a site of an unported plane raises ``NotImplementedError``
  naming its Queue 1 item (JAX accepts it); the sink sites raise as JAX's
  and leave no temp file; the cache sites fire as JAX's (``cache.store``
  fails the write, ``cache.lookup=torn`` drops the entry); the
  ``heartbeat.tick`` site fires as JAX's (``freeze`` skips a tick, ``eio``
  is a counted tick error); ``decode.read``
  fires in a spawned decode worker armed by ``VFT_INJECT``; the CLI arms a
  plan, prints the summary line JAX's plan gives for the same hits, and
  disarms it, and a failed cache store leaves the video done.

Spawned children cost a second or two each, so the sources run on a few
frames and each test spawns only what its assertion needs.
"""
import contextlib
import io
import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest

from video_features_tpu.utils import faults as jfaults
from video_features_tpu.utils import inject as jinject
from video_features_tpu.utils import sinks as jsinks
from video_features_tpu_torch.config import Config
from video_features_tpu_torch.utils import faults as tfaults
from video_features_tpu_torch.utils import inject as tinject
from video_features_tpu_torch.utils import io as tio
from video_features_tpu_torch.utils import sinks as tsinks

def _same_frames(got, want):
    assert len(got) == len(want)
    for (gf, gt, gi), (wf, wt, wi) in zip(got, want):
        assert (gt, gi) == (wt, wi)
        np.testing.assert_array_equal(gf, wf)


# -- taxonomy, ladder, policy ------------------------------------------------

EXCEPTIONS = [
    lambda m: m.DeadlineExceeded("v: deadline"),
    lambda m: m.PoisonError("bad"), lambda m: m.FatalError("no"),
    lambda m: RuntimeError("decode worker for v died without a result"),
    lambda m: RuntimeError("decode worker failed for v: ValueError: x"),
    lambda m: RuntimeError("decode worker failed for v: No decodable "
                           "frames in v"),
    lambda m: RuntimeError("decode worker failed: OSError: [Errno 28] No "
                           "space left on device"),
    lambda m: RuntimeError("decode worker failed: OSError: [Errno 5] EIO"),
    lambda m: ValueError("Cannot determine fps"), lambda m: KeyError("k"),
    lambda m: NotImplementedError("x"), lambda m: TypeError("t"),
    lambda m: MemoryError(), lambda m: OSError(5, "EIO"),
    lambda m: OSError(30, "Read-only file system"),
    lambda m: ConnectionError("reset")]


@pytest.mark.parametrize("make", EXCEPTIONS)
def test_classify_matches_jax(make):
    assert tfaults.classify(make(tfaults)) == jfaults.classify(make(jfaults))


def test_demote_matches_jax():
    assert tfaults.LADDER == jfaults.LADDER == ("parallel", "process",
                                                "inline")
    for mode in ("parallel", "process", "inline", None, "bogus"):
        assert tfaults.demote(mode) == jfaults.demote(mode)


@pytest.mark.parametrize("deadline", [None, 0.25, 30])
def test_retry_policy_from_config_matches_jax(deadline):
    cfg = {"retry_attempts": 2, "retry_backoff_s": 0.1,
           "video_deadline_s": deadline, "retry_failed": True}
    got, want = tfaults.RetryPolicy.from_config(cfg), \
        jfaults.RetryPolicy.from_config(cfg)
    assert (got.attempts, got.backoff_s, got.deadline_s, got.ladder,
            got.retry_failed) == (want.attempts, want.backoff_s,
                                  want.deadline_s, want.ladder,
                                  want.retry_failed)
    for bad in (0, -1):
        for mod in (tfaults, jfaults):
            with pytest.raises(ValueError, match="video_deadline_s"):
                mod.RetryPolicy.from_config({"video_deadline_s": bad})


# -- the deadline watchdog ---------------------------------------------------

def base_extractor(tmp_path, **over):
    from video_features_tpu_torch.extractors.base import BaseExtractor
    return BaseExtractor(Config(dict(
        feature_type="resnet", device="cpu", output_path=str(tmp_path / "o"),
        tmp_path=str(tmp_path / "t"), **over)))


def small_video(path, frames=12):
    """A 64x48 mp4 of ``frames`` flat frames (cv2's mp4v writer)."""
    import cv2
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                        (64, 48))
    for t in range(frames):
        w.write(np.full((48, 64, 3), 20 * t, np.uint8))
    w.release()
    return str(path)


def test_deadline_kills_hung_video_and_run_continues(tmp_path, monkeypatch):
    """The hung video's read blocks until the watchdog releases its
    capture; it fails TRANSIENT after both attempts, each cut at its 1 s
    deadline, and the (milliseconds-long) videos before and after it
    succeed."""
    read = tio._FrameStream.read

    def hanging_read(self):
        if "hang" not in self._path:
            return read(self)
        while self.cap is not None:  # a read stuck inside the decoder
            time.sleep(0.01)
        return None

    monkeypatch.setattr(tio._FrameStream, "read", hanging_read)
    ok = small_video(tmp_path / "ok.mp4")
    hang = small_video(tmp_path / "hang.mp4")
    ex = base_extractor(tmp_path)

    def extract(path):
        return {"n": np.array(len(list(ex.video_source(path).frames())))}

    journal = tfaults.FailureJournal(tmp_path / "o")
    policy = tfaults.RetryPolicy(attempts=2, backoff_s=0.0, deadline_s=1.0)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        statuses = [tsinks.safe_extract(extract, v, policy=policy,
                                        journal=journal)
                    for v in (ok, hang, ok)]
    assert statuses == ["done", "error", "done"]
    assert 2.0 <= time.monotonic() - t0 < 30.0
    assert out.getvalue().count("WATCHDOG") == 2
    rec = journal.load()[str(hang)]
    assert rec["category"] == tfaults.TRANSIENT and rec["attempts"] == 2
    assert rec["error"].startswith("DeadlineExceeded") and \
        "deadline" in rec["error"]


def test_register_after_expiry_cancels_immediately():
    cancelled = []

    class Src:
        def cancel(self, reason=""):
            cancelled.append(reason)

    with contextlib.redirect_stdout(io.StringIO()):
        with tfaults.FaultContext("v", deadline_s=0.05) as ctx:
            assert tfaults.current_context() is ctx
            limit = time.monotonic() + 5
            while not ctx.deadline_expired and time.monotonic() < limit:
                time.sleep(0.01)
            ctx.register(Src())
    assert ctx.deadline_expired and len(cancelled) == 1
    assert "deadline (0.05s) exceeded" in cancelled[0]
    assert tfaults.current_context() is None


def test_deadline_cancels_a_live_video_source(sample_video):
    """The watchdog's cancel on an inline source in the middle of its
    decode: the consumer raises ``DeadlineExceeded`` instead of ending
    short (the capture is released between two reads, or after the one in
    flight returns)."""
    src = tio.VideoSource(sample_video, batch_size=4)
    n = 0
    with contextlib.redirect_stdout(io.StringIO()):
        with tfaults.FaultContext("v", deadline_s=0.3) as ctx:
            ctx.register(src)
            with pytest.raises(tfaults.DeadlineExceeded):
                for batch, _, _ in src:
                    n += len(batch)
                    time.sleep(0.02)
    assert 0 < n < 355


@pytest.mark.parametrize("cls", ["ProcessVideoSource",
                                 "ParallelVideoSource"])
def test_cancel_kills_spawned_decode(sample_video, cls):
    """A slow consumer outlives the deadline: the consumer raises
    ``DeadlineExceeded`` mid-stream and every child is gone."""
    src = getattr(tio, cls)(sample_video)
    workers = list(src._workers)
    frames = src.frames()
    next(frames)  # the children are up
    n = 1
    with contextlib.redirect_stdout(io.StringIO()):
        with tfaults.FaultContext("v", deadline_s=0.3) as ctx:
            ctx.register(src)
            with pytest.raises(tfaults.DeadlineExceeded, match="deadline"):
                for _ in frames:
                    n += 1
                    time.sleep(0.02)
    assert 1 < n < 355
    assert workers and not any(w.proc.is_alive() for w in workers)


# -- the decode ladder -------------------------------------------------------

def test_ladder_demotes_like_jax():
    seen = {}
    for name, faults_mod, sinks_mod in (("jax", jfaults, jsinks),
                                        ("port", tfaults, tsinks)):
        overrides = []

        def extract(path, faults_mod=faults_mod, overrides=overrides):
            overrides.append(faults_mod.current_context().decode_override)
            raise RuntimeError("decode blip")

        policy = faults_mod.RetryPolicy(attempts=4, backoff_s=0.0)
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                contextlib.redirect_stderr(io.StringIO()):
            status = sinks_mod.safe_extract(extract, "v.mp4", policy=policy,
                                            decode_mode="parallel")
        assert status == "error"
        assert out.getvalue().count("DECODE LADDER") == 2
        seen[name] = overrides
    assert seen["port"] == seen["jax"] == [None, "process", "inline",
                                           "inline"]


def test_video_source_builds_each_rung_and_registers(tmp_path,
                                                     monkeypatch):
    from video_features_tpu_torch.extractors import base as tbase
    built = []

    def fake(kind):
        def make(path, **kwargs):
            built.append((kind, kwargs))
            return kind
        return make

    monkeypatch.setattr(tbase.vio, "VideoSource", fake("inline"))
    monkeypatch.setattr(tbase.vio, "ProcessVideoSource", fake("process"))
    monkeypatch.setattr(tbase.vio, "ParallelVideoSource", fake("parallel"))
    ex = base_extractor(tmp_path, video_decode="parallel", decode_workers=3,
                        decode_depth=4)
    assert ex.video_source("v", fps=2) == "parallel"
    assert built[-1] == ("parallel", dict(fps=2, decode_workers=3, depth=4))
    for override in ("process", "inline"):
        registered = []
        with tfaults.FaultContext("v", decode_override=override) as ctx:
            ctx.register = registered.append
            assert ex.video_source("v", fps=2) == override
        assert registered == [override] and built[-1][1] == dict(fps=2)
    with pytest.raises(ValueError, match="decode_workers"):
        base_extractor(tmp_path, decode_workers=0)


# -- the process and parallel sources ---------------------------------------

def test_process_source_with_transform_matches_inline(sample_video):
    """The edge resize crosses into the child; batches of 3 with a 1-frame
    overlap, as the flow families read them."""
    from video_features_tpu_torch.ops.host_transforms import EdgeResize
    kw = dict(fps=2, batch_size=3, overlap=1, transform=EdgeResize(64))
    src = tio.ProcessVideoSource(sample_video, **kw)
    want = tio.VideoSource(sample_video, **kw)
    assert (len(src), src.fps, src.height, src.width) == \
        (len(want), want.fps, want.height, want.width)
    got, ref = list(src), list(want)
    assert len(got) == len(ref) > 3
    for (gb, gt, gi), (wb, wt, wi) in zip(got, ref):
        assert (gt, gi) == (wt, wi)
        np.testing.assert_array_equal(np.stack(gb), np.stack(wb))
    assert gb[0].shape[0] == 64


def test_parallel_source_matches_inline(sample_video):
    """Three segments over 11 resampled frames."""
    src = tio.ParallelVideoSource(sample_video, total=11, decode_workers=3)
    assert len(src._workers) == 3
    _same_frames(list(src.frames()),
                 list(tio.VideoSource(sample_video, total=11).frames()))


def test_parallel_counts_frames_when_metadata_says_none(tmp_path,
                                                        monkeypatch):
    """Every source frame wanted and a container that reports 0 frames:
    the frames are counted by decode and the whole stream comes back (the
    JAX source gives an empty stream there); the inline source decodes to
    the end as it always did."""
    path = small_video(tmp_path / "small.mp4")
    props = tio.get_video_props

    def no_count(p):
        return dict(props(p), num_frames=0)

    monkeypatch.setattr(tio, "get_video_props", no_count)
    inline = list(tio.VideoSource(path).frames())
    assert len(inline) == 12
    with contextlib.redirect_stdout(io.StringIO()) as out:
        src = tio.ParallelVideoSource(path, decode_workers=2)
    assert "counted 12 by decode" in out.getvalue()
    assert len(src) == 12 and len(src._workers) == 2
    _same_frames(list(src.frames()), inline)


def test_host_transforms_pickle():
    """What crosses into a spawned child: every family's host transform."""
    from video_features_tpu_torch.ops import host_transforms as ht
    for tf in (ht.EdgeResize(256), ht.EdgeResize(64, False),
               ht.R21DTransform("uint8"), ht.S3DTransform("float32"),
               ht.ResizeCropTransform(256, 224, "bilinear", "uint8"),
               ht.ResizeCropTransform(224, 224, "bicubic", "yuv420")):
        frame = np.random.default_rng(0).integers(
            0, 255, (240, 320, 3), np.uint8)
        back = pickle.loads(pickle.dumps(tf))
        np.testing.assert_array_equal(back(frame), tf(frame))


@pytest.fixture(scope="module")
def resnet_inline(tmp_path_factory, sample_video):
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.resnet import ExtractResNet
    tmp = tmp_path_factory.mktemp("decode_modes")

    def make(mode):
        cfg = tconfig.load_config("resnet", dict(
            model_name="resnet18", device="cpu", allow_random_weights=True,
            batch_size=3, extraction_total=5, resize="device",
            video_decode=mode, decode_workers=2,
            output_path=str(tmp / mode / "o"), tmp_path=str(tmp / mode / "t"),
            video_paths=sample_video))
        tconfig.sanity_check(cfg)
        return ExtractResNet(cfg)

    return make, make("inline").extract(sample_video)


@pytest.mark.parametrize("mode", ["process", "parallel"])
def test_frame_wise_decode_modes_match_inline(resnet_inline, sample_video,
                                              mode):
    make, want = resnet_inline
    ex = make(mode)
    assert ex.video_decode == mode
    got = ex.extract(sample_video)
    assert got["resnet"].shape == want["resnet"].shape == (5, 512)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# -- fault injection ---------------------------------------------------------

PLAN = ("seed={seed};decode.read=eio@p0.3;sink.fsync=enospc@every3;"
        "sink.tmp_write=torn@n2;sink.rename=drop@after4;"
        "worker.kill=error@p0.5")


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_plan_parses_and_fires_like_jax(seed):
    spec = PLAN.format(seed=seed)
    plans = {"jax": jinject.parse_plan(spec), "port": tinject.parse_plan(spec)}
    rules = {name: {s: (r.kind, r.trigger, r.value)
                    for s, r in p.rules.items()} for name, p in plans.items()}
    assert rules["port"] == rules["jax"] and len(rules["jax"]) == 5
    fired = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, plan in plans.items():
            out = []
            for site in sorted(plan.rules):
                for hit in range(1, 41):
                    try:
                        fault = plan.check(site, {"hit": hit})
                    except (OSError, RuntimeError) as e:
                        fault = type(e).__name__ + str(getattr(e, "errno",
                                                               ""))
                    if fault is not None:
                        out.append((site, hit, str(fault)))
            fired[name] = out
    assert fired["port"] == fired["jax"]
    assert 20 < len(fired["port"]) < 120
    assert plans["port"].summary() == plans["jax"].summary()


@pytest.mark.parametrize("site,item", [
    ("queue.claim", 8),
    ("queue.steal_staging", 8), ("spool.claim", 8), ("spool.respond", 8),
    ("gateway.read", 8), ("gateway.spool_submit", 8), ("gc.evict", 8),
    ("gc.sweep", 8)])
def test_unported_sites_raise(site, item):
    spec = f"seed=1;{site}=eio@n1"
    jinject.parse_plan(spec)  # the JAX package hosts it
    with pytest.raises(NotImplementedError, match=f"Queue 1 #{item}"):
        tinject.parse_plan(spec)
    assert set(tinject.UNPORTED_SITES) | {
        "decode.read", "sink.tmp_write", "sink.fsync", "sink.rename",
        "worker.kill", "cache.store", "cache.lookup", "heartbeat.tick"} == \
        set(tinject.SITES) == set(jinject.SITES)


@pytest.mark.parametrize("rule", ["freeze@n2", "eio@n3"])
def test_heartbeat_tick_site_fires_like_jax(rule):
    """``heartbeat.tick`` through both packages' ``HeartbeatThread`` on a
    10 ms interval: ``freeze`` skips the second tick silently, ``eio``
    fails the third and is counted as a tick error; each plan fired once
    (the hit counts depend on the thread's timing)."""
    from video_features_tpu.telemetry import heartbeat as jhb
    from video_features_tpu_torch.telemetry import heartbeat as thb

    spec = f"seed=3;heartbeat.tick={rule}"
    got = {}
    for name, inj, hb in (("port", tinject, thb), ("jax", jinject, jhb)):
        plan = inj.arm_for_run(spec)
        ticks = []
        thread = hb.HeartbeatThread(lambda: ticks.append(1), 0.01)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                thread.start()
                deadline = time.monotonic() + 30
                while len(ticks) < 4 and time.monotonic() < deadline:
                    time.sleep(0.01)
                thread.stop()
        finally:
            inj.disarm()
        assert len(ticks) >= 4
        got[name] = (thread.frozen_ticks, thread.tick_errors_total,
                     dict(plan.fired))
    assert got["port"] == got["jax"]
    assert got["port"][2] == {"heartbeat.tick": 1}
    assert got["port"][:2] == ((1, 0) if rule.startswith("freeze")
                               else (0, 1))


@pytest.mark.parametrize("site,rule", [("cache.store", "eio@n2"),
                                       ("cache.lookup", "torn@n1")])
def test_cache_sites_fire_like_jax(site, rule, tmp_path):
    """One plan through both packages' ``FeatureCache`` on the same entry
    sequence: ``cache.store=eio`` fails the second store, leaving the first
    entry only; ``cache.lookup=torn`` truncates the entry before it is
    read, so it is dropped and the lookup misses. The plans fire at the
    same hits and summarise alike."""
    from video_features_tpu import cache as jcache
    from video_features_tpu_torch import cache as tcache

    content = tmp_path / "input.mp4"
    content.write_bytes(b"\x00" * 4096)
    feats = {"x": np.arange(6, dtype=np.float32)}
    spec = f"seed=2;{site}={rule}"
    outcomes, summaries = {}, {}
    for name, pkg, mod in (("port", tcache, tinject),
                           ("jax", jcache, jinject)):
        fc = pkg.FeatureCache(str(tmp_path / name), "resnet", "c" * 64,
                              "w" * 64)
        mod.arm_for_run(spec)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                got = []
                for _ in range(2):
                    try:
                        fc.store(str(content), feats)
                        got.append("stored")
                    except OSError as e:
                        got.append(f"OSError{e.errno}")
                    got.append(fc.lookup(str(content)) is not None)
            outcomes[name] = got
            summaries[name] = mod.active().summary()
        finally:
            mod.disarm()
    assert outcomes["port"] == outcomes["jax"]
    assert summaries["port"] == summaries["jax"]
    if site == "cache.store":
        assert outcomes["port"] == ["stored", True, "OSError5", True]
    else:
        assert outcomes["port"] == ["stored", False, "stored", True]


@pytest.mark.parametrize("spec", [
    "", "seed=x;decode.read=eio", "decode.read", "nosuch=eio",
    "decode.read=melt", "decode.read=torn", "decode.read=eio@p2",
    "decode.read=eio@n0", "decode.read=eio@sometimes", "seed=3"])
def test_malformed_plans_raise_like_jax(spec):
    with pytest.raises(ValueError) as want:
        jinject.parse_plan(spec)
    with pytest.raises(ValueError) as got:
        tinject.parse_plan(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rule,errno_", [
    ("sink.tmp_write=torn@n1", 5), ("sink.fsync=enospc@n1", 28),
    ("sink.rename=drop@n1", 5)])
def test_sink_sites_raise_like_jax_and_leave_no_temp(tmp_path, monkeypatch,
                                                     rule, errno_):
    for name, inj, sinks in (("jax", jinject, jsinks),
                             ("port", tinject, tsinks)):
        monkeypatch.setattr(inj, "_active", inj.parse_plan("seed=1;" + rule))
        target = tmp_path / name / "v_x.npy"
        with contextlib.redirect_stdout(io.StringIO()):
            with pytest.raises(OSError) as e:
                sinks._write_bytes_atomic(str(target), b"x" * 64)
            assert e.value.errno == errno_
            assert os.listdir(target.parent) == []
            sinks._write_bytes_atomic(str(target), b"y" * 64)  # hit 2
        assert target.read_bytes() == b"y" * 64


def test_decode_read_fires_inline_and_in_a_spawned_worker(sample_video,
                                                          monkeypatch):
    """Inline: the 3rd read raises the injected EIO. A ``process`` child
    armed by ``VFT_INJECT`` forwards it, TRANSIENT as JAX classifies it."""
    monkeypatch.setattr(tinject, "_active",
                        tinject.parse_plan("seed=1;decode.read=eio@n3"))
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(OSError, match="injected EIO at decode.read"):
            list(tio.VideoSource(sample_video, total=5).frames())
    monkeypatch.setattr(tinject, "_active", None)
    monkeypatch.setenv("VFT_INJECT", "seed=1;decode.read=eio@n3")
    src = tio.ProcessVideoSource(sample_video, total=5)
    with pytest.raises(RuntimeError, match="OSError.*injected EIO") as e:
        list(src.frames())
    assert tfaults.classify(e.value) == \
        jfaults.classify(RuntimeError(str(e.value))) == tfaults.TRANSIENT


def test_cli_arms_prints_and_disarms_like_jax(tmp_path):
    """One injected rename drop on the first write: the video recovers on
    its second attempt, the CLI prints the summary line JAX's plan gives
    for the same two hits (the JAX CLI prints ``plan.summary()`` too), and
    the plan is disarmed after the run. Then ``cache.store=eio`` under
    ``cache=true``: the store fails and is printed, and the video is done
    with its features on disk."""
    import wave
    from video_features_tpu_torch.cli import main

    wav = tmp_path / "tone.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        t = np.arange(16000) / 16000
        w.writeframes((0.3 * np.sin(2 * np.pi * 440 * t) * 32767).astype(
            "<i2").tobytes())
    spec = "seed=3;sink.rename=drop@n1"
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        main(["feature_type=vggish", "device=cpu",
              "allow_random_weights=true", "on_extraction=save_numpy",
              "retry_backoff_s=0", f"inject={spec}",
              f"output_path={tmp_path / 'o'}", f"tmp_path={tmp_path / 't'}",
              f"video_paths={wav}"])
    text = out.getvalue()
    assert "INJECT: sink.rename=drop fired (hit 1" in text
    assert 'Recovered "' in text
    assert (tmp_path / "o" / "vggish" / "tone_vggish.npy").exists()
    assert tinject.active() is None
    jplan = jinject.parse_plan(spec)
    with contextlib.redirect_stdout(io.StringIO()):
        for _ in range(2):
            jplan.check("sink.rename", {})
    assert [line for line in text.splitlines()
            if line.startswith("inject: seed=")] == [jplan.summary()] == [
        f"inject: seed=3 fired/hits {{sink.rename:1/2}} (plan {spec!r})"]
    # cache.store=eio with cache=true: the store fails and is printed, the
    # video is done and its features are on disk, as in the JAX package
    spec = "seed=1;cache.store=eio"
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        main(["feature_type=vggish", "device=cpu",
              "allow_random_weights=true", "on_extraction=save_numpy",
              "cache=true", f"cache_dir={tmp_path / 'c'}", f"inject={spec}",
              f"output_path={tmp_path / 'x'}", f"tmp_path={tmp_path / 'y'}",
              f"video_paths={wav}"])
    text = out.getvalue()
    assert "INJECT: cache.store=eio fired (hit 1" in text
    assert "cache: store failed for" in text and "1 extracted" in text
    assert (tmp_path / "x" / "vggish" / "tone_vggish.npy").exists()
    assert not list((tmp_path / "c").rglob("*.pkl"))
    assert tinject.active() is None


def test_video_decode_and_deadline_keys_are_accepted(tmp_path):
    """The keys of the fault plane pass ``sanity_check`` in every family
    and reach the policy; bad values raise as in JAX."""
    from video_features_tpu_torch import config as tconfig
    base = dict(device="cpu", video_paths="v.mp4",
                output_path=str(tmp_path / "o"), tmp_path=str(tmp_path / "t"))
    for family in ("i3d", "raft", "pwc", "r21d", "s3d", "resnet", "clip",
                   "vggish"):
        for mode in ("inline", "process", "parallel"):
            cfg = tconfig.load_config(family, dict(
                base, video_decode=mode, video_deadline_s=2.5,
                inject="seed=1;decode.read=eio@p0.1"))
            tconfig.sanity_check(cfg, require_videos=False)
            assert tfaults.RetryPolicy.from_config(cfg).deadline_s == 2.5
    for over, err in ((dict(video_decode="threads"), NotImplementedError),
                      (dict(video_deadline_s=0), ValueError),
                      (dict(inject=5), ValueError)):
        with pytest.raises(err, match=next(iter(over))):
            tconfig.sanity_check(tconfig.load_config("resnet", dict(
                base, **over)), require_videos=False)
