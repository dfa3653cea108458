"""The port's content-addressed feature cache (``cache.py``) against the JAX
package's.

- The identity components equal JAX's for the same inputs:
  ``file_sha256``, ``content_identity`` (the sha256 path and the
  decode-plan fallback), ``config_fingerprint``, ``weights_fingerprint`` and
  ``content_signature``; the key sets are JAX's and class every key of the
  port's YAMLs. ``entry_key`` differs from JAX's by its backend component
  only, so an entry the JAX ``FeatureCache`` stored in a shared
  ``cache_dir`` is a miss for the port, and the other way round, even for
  extractors whose config and weights fingerprints agree.
- Store and lookup round-trip bit for bit; a corrupted tensor, a torn entry,
  a stale schema or another key set is a miss and the entry is dropped;
  ``cache_scope=tenant`` never serves across tenants.
- On the port's extractors: a hit never decodes; a semantic config change
  or another weights file misses; ``resize=auto`` shares entries with the
  value it resolves to. The two-pass multi-family CLI hits every entry on
  its second pass, decodes nothing and is bit-identical. The
  ``cache.lookup`` and ``cache.store`` injection sites fire.
"""
import contextlib
import hashlib
import io
import os
import pickle
import shutil
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from video_features_tpu import cache as jcache
from video_features_tpu.telemetry import health as jhealth
from video_features_tpu.telemetry.context import use_request as j_use_request
from video_features_tpu_torch import cache as tcache
from video_features_tpu_torch import config as tconfig
from video_features_tpu_torch.telemetry import health as thealth
from video_features_tpu_torch.utils import inject as tinject
from video_features_tpu_torch.utils import io as tio
from video_features_tpu_torch.telemetry.context import use_request

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("i3d", "raft", "pwc", "r21d", "s3d", "resnet", "clip", "vggish")


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


# -- identity components against JAX -----------------------------------------

def test_file_sha256_and_content_identity_equal_jax(sample_video, tmp_path,
                                                    monkeypatch):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"x" * 4096)
    first = tcache.file_sha256(str(p))
    assert first == tcache.file_sha256(str(p)) == jcache.file_sha256(str(p))
    p.write_bytes(b"y" * 4097)  # new content: re-hashed, not the memo
    assert tcache.file_sha256(str(p)) == jcache.file_sha256(str(p)) != first
    cid = tcache.content_identity(sample_video)
    assert cid == jcache.content_identity(sample_video)
    assert cid.startswith("sha256:")
    for fps, total in ((4.0, None), (2.0, None), (None, 7)):
        plan = tcache.plan_identity(sample_video, fps, total)
        assert plan == jcache.plan_identity(sample_video, fps, total)
    monkeypatch.setattr(tcache, "file_sha256",
                        lambda p: (_ for _ in ()).throw(OSError("no bytes")))
    assert tcache.content_identity(sample_video, fps=4.0) == \
        tcache.plan_identity(sample_video, 4.0, None)
    assert tcache.content_identity(sample_video, fps=4.0) != \
        tcache.content_identity(sample_video, fps=2.0)


BASE = {"feature_type": "resnet", "model_name": "resnet18",
        "extraction_fps": 4, "batch_size": 16, "output_path": "./output",
        "video_workers": 1, "telemetry": False, "cache": True,
        "cache_dir": None, "device": "cpu"}


@pytest.mark.parametrize("over,resolved", [
    ({}, None), ({"resize": "auto"}, {"resize": "device"}),
    ({"resize": "host", "ingest": None}, {"ingest": "uint8"}),
    ({"video_workers": 8, "output_path": "/x", "mesh_devices": 2,
      "video_decode": "parallel", "retry_attempts": 5}, None),
    ({"extraction_fps": 2, "precision": "bfloat16"}, None)])
def test_config_fingerprint_equals_jax(over, resolved):
    cfg = dict(BASE, **over)
    assert tcache.config_fingerprint(cfg, resolved) == \
        jcache.config_fingerprint(cfg, resolved)


def test_config_fingerprint_keys_only_semantic_keys():
    fp = tcache.config_fingerprint(BASE)
    ops = dict(BASE, output_path="/o", video_workers=8, mesh_devices=4,
               video_decode="process", model_parallel=2, retry_attempts=5,
               cache_dir="/c", cache_scope="tenant", batch_size=64,
               fanout_depth=8, inject="seed=1;decode.read=eio@n1")
    assert tcache.config_fingerprint(ops) == fp
    assert tcache.config_fingerprint(dict(BASE, extraction_fps=2)) != fp
    assert tcache.config_fingerprint(dict(BASE, model_name="resnet50")) != fp
    assert tcache.config_fingerprint(dict(BASE, resize="auto"),
                                     {"resize": "device"}) == \
        tcache.config_fingerprint(dict(BASE, resize="device"))


def test_key_sets_are_jax_and_class_every_port_yaml_key():
    assert tcache.NON_SEMANTIC_KEYS == jcache.NON_SEMANTIC_KEYS
    assert tcache.SEMANTIC_KEYS == jcache.SEMANTIC_KEYS
    assert not tcache.NON_SEMANTIC_KEYS & tcache.SEMANTIC_KEYS
    for family in FAMILIES:
        keys = set(yaml.safe_load((REPO / "video_features_tpu_torch" /
                                   "configs" / f"{family}.yml").read_text()))
        unclassed = keys - tcache.NON_SEMANTIC_KEYS - tcache.SEMANTIC_KEYS
        assert not unclassed, (family, unclassed)


def test_weights_fingerprint_and_content_signature_equal_jax():
    a = {"model_key": "resnet18", "sha256": "a" * 64}
    b = {"model_key": "vggish", "sha256": "b" * 64}
    for cap in ([a, b], [b, a], [dict(a, sha256="c" * 64), b],
                [{"model_key": "resnet18", "random": True}], [], None):
        assert tcache.weights_fingerprint(cap) == \
            jcache.weights_fingerprint(cap)
    assert tcache.weights_fingerprint([a, b]) == \
        tcache.weights_fingerprint([b, a])
    assert tcache.weights_fingerprint(None) == "none"
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 512)).astype(np.float32)
    for arr in (x, x.astype(np.float64), np.float64(4.0),
                np.array([np.nan, np.inf, -np.inf, 1e30]),
                np.array([{"a": 1}], dtype=object), x + 1e-4):
        assert thealth.content_signature(arr) == \
            jhealth.content_signature(arr)
    assert thealth.SIG_GRID == jhealth.SIG_GRID
    assert thealth.content_signature(x + 0.1) != \
        thealth.content_signature(x)
    assert tcache.content_signature is thealth.content_signature


@pytest.mark.parametrize("tenant", [None, "alpha"])
def test_entry_key_differs_from_jax_by_the_backend_only(tenant):
    parts = ("sha256:" + "1" * 64, "2" * 64, "3" * 64)
    salt = f"\ntenant:{tenant}" if tenant else ""
    want = hashlib.sha256(
        f"{parts[0]}\n{parts[1]}\n{parts[2]}\nbackend:torch{salt}".encode()
    ).hexdigest()
    assert tcache.entry_key(*parts, tenant=tenant) == want
    assert jcache.entry_key(*parts, tenant=tenant) == hashlib.sha256(
        f"{parts[0]}\n{parts[1]}\n{parts[2]}{salt}".encode()).hexdigest()
    assert want != jcache.entry_key(*parts, tenant=tenant)
    assert tcache.SCHEMA_VERSION == jcache.SCHEMA_VERSION


# -- the store ---------------------------------------------------------------

@pytest.fixture
def store(tmp_path):
    """A port FeatureCache over a content file that needs no decode."""
    content = tmp_path / "input.mp4"
    content.write_bytes(os.urandom(1 << 14))
    fc = tcache.FeatureCache(str(tmp_path / "cache" / "resnet"), "resnet",
                             "cfg" + "0" * 61, "wts" + "0" * 61)
    return fc, str(content)


def _feats(seed=0):
    rng = np.random.default_rng(seed)
    return {"resnet": rng.standard_normal((7, 512)).astype(np.float32),
            "fps": np.float64(4.0),
            "timestamps_ms": (np.arange(7) * 250.0)}


def test_store_lookup_roundtrip_bit_identical(store):
    fc, video = store
    feats = _feats()
    assert fc.lookup(video) is None  # nothing stored yet
    key = fc.store(video, feats)
    path = Path(fc.entry_path(key))
    assert path.parent.name == key[:2] and path.parent.parent == \
        Path(fc.root)
    got = fc.lookup(video, expected_keys=list(feats))
    assert set(got) == set(feats)
    for k in feats:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(feats[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(feats[k]).dtype


def _rewrite(path, edit):
    with open(path, "rb") as f:
        entry = pickle.load(f)
    edit(entry)
    with open(path, "wb") as f:
        pickle.dump(entry, f)


@pytest.mark.parametrize("damage", ["tensor", "torn", "schema", "keys"])
def test_bad_entry_is_a_miss_and_is_dropped(store, damage):
    fc, video = store
    path = fc.entry_path(fc.store(video, _feats()))
    expected = list(_feats())
    if damage == "tensor":  # past the signature's lattice, sigs stale
        _rewrite(path, lambda e: e["feats"].update(
            resnet=e["feats"]["resnet"] + 0.1))
    elif damage == "torn":
        Path(path).write_bytes(b"\x80\x04 torn pickle")
    elif damage == "schema":
        _rewrite(path, lambda e: e.update(schema="vft.feature_cache/0"))
    else:
        expected = ["resnet", "fps"]
    assert _quiet(fc.lookup, video, expected_keys=expected) is None
    assert not os.path.exists(path)  # a recompute repopulates it


def test_tenant_scope_never_serves_across_tenants(store, tmp_path):
    _fc, video = store
    feats = _feats()
    scoped = tcache.FeatureCache(str(tmp_path / "t"), "resnet", "c" * 64,
                                 "w" * 64, scope="tenant")
    with use_request("alpha-r1"):
        key_a = scoped.store(video, feats)
        assert scoped.lookup(video) is not None
    with use_request("beta-r2"):
        assert scoped.lookup(video) is None
        assert scoped.key_for(video) != key_a
    with use_request("alpha-r9"):
        assert scoped.lookup(video) is not None
    assert scoped.lookup(video) is None  # untenanted: its own sentinel
    shared = tcache.FeatureCache(str(tmp_path / "s"), "resnet", "c" * 64,
                                 "w" * 64)
    with use_request("alpha-r1"):
        shared.store(video, feats)
    with use_request("beta-r2"):
        assert shared.lookup(video) is not None  # dedup across tenants


def test_jax_and_port_entries_never_serve_each_other(store, tmp_path):
    """Both packages' handles over one root, family and fingerprints: the
    same layout, other keys, and each one's entry a miss for the other."""
    _fc, video = store
    root = str(tmp_path / "shared" / "resnet")
    args = ("resnet", "c" * 64, "w" * 64)
    port = tcache.FeatureCache(root, *args)
    jax_ = jcache.FeatureCache(root, *args)
    feats = _feats()
    jkey = jax_.store(video, feats)
    assert port.lookup(video) is None and jax_.lookup(video) is not None
    tkey = port.store(video, feats)
    assert tkey != jkey and port.lookup(video) is not None
    os.unlink(jax_.entry_path(jkey))
    assert jax_.lookup(video) is None  # the port's entry does not serve JAX
    for fc, key in ((port, tkey), (jax_, jkey)):  # one layout
        assert fc.entry_path(key) == os.path.join(root, key[:2],
                                                  key + ".pkl")
    for scope_cache, use in ((tcache, use_request), (jcache, j_use_request)):
        scoped = scope_cache.FeatureCache(root, *args, scope="tenant")
        with use("alpha-r1"):
            scoped.store(video, feats)
    with use_request("alpha-r1"):
        assert tcache.FeatureCache(root, *args, scope="tenant").key_for(
            video) != jcache.FeatureCache(root, *args,
                                          scope="tenant").key_for(video)


# -- on the port's extractors ------------------------------------------------

@pytest.fixture(scope="module")
def resnet18_ckpts(tmp_path_factory):
    """Two seeded resnet18 checkpoints in torchvision's key layout, removed
    when the module's tests are done."""
    from video_features_tpu_torch.models.resnet import ResNet
    from video_features_tpu_torch.weights.bridge import seeded_init_
    td = tmp_path_factory.mktemp("cache_ckpt")
    paths = []
    for seed in (1, 2):
        paths.append(td / f"resnet18_{seed}.pt")
        torch.save(seeded_init_(ResNet("resnet18"), seed).state_dict(),
                   paths[-1])
    yield paths
    for path in paths:
        path.unlink(missing_ok=True)


def _raw_cfg(video, out, cache_dir, **over):
    return {"video_paths": video, "device": "cpu", "batch_size": 8,
            "extraction_total": 6, "model_name": "resnet18",
            "on_extraction": "save_numpy", "allow_random_weights": True,
            "cache": True, "cache_dir": str(cache_dir),
            "output_path": str(out / "out"), "tmp_path": str(out / "tmp"),
            **over}


def _resnet_cfg(video, out, cache_dir, **over):
    cfg = tconfig.load_config("resnet", _raw_cfg(video, out, cache_dir,
                                                 **over))
    tconfig.sanity_check(cfg)
    return cfg


def _resnet(video, out, cache_dir, **over):
    from video_features_tpu_torch.extractors.resnet import ExtractResNet
    return ExtractResNet(_resnet_cfg(video, out, cache_dir, **over))


def _boom(_):
    raise AssertionError("a cache hit must not extract")


def test_hit_never_decodes_and_writes_the_sink(sample_video, tmp_path):
    cache_dir = tmp_path / "cache"
    feats = _quiet(_resnet(sample_video, tmp_path / "a", cache_dir)._extract,
                   sample_video)
    ex2 = _resnet(sample_video, tmp_path / "b", cache_dir)
    ex2.extract = _boom
    before = tio.decoded_frames()
    got = _quiet(ex2._extract, sample_video)
    assert tio.decoded_frames() == before
    for k in feats:
        np.testing.assert_array_equal(got[k], feats[k], err_msg=k)
    stem = Path(sample_video).stem
    assert list((tmp_path / "b" / "out").rglob(f"{stem}_resnet.npy"))


def test_miss_on_semantic_config_change(sample_video, tmp_path):
    cache_dir = tmp_path / "cache"
    _quiet(_resnet(sample_video, tmp_path / "a", cache_dir)._extract,
           sample_video)
    ex2 = _resnet(sample_video, tmp_path / "b", cache_dir,
                  extraction_total=5)
    calls = []
    real = ex2.extract
    ex2.extract = lambda v: calls.append(v) or real(v)
    assert _quiet(ex2._extract, sample_video)["resnet"].shape == (5, 512)
    assert calls == [sample_video]


def test_miss_on_another_weights_file(sample_video, tmp_path,
                                      resnet18_ckpts):
    """A checkpoint re-written in place under one config: the config
    fingerprint stays, the weights fingerprint (the file's sha256 under the
    JAX package's model key) moves, and the old entry is a miss."""
    cache_dir = tmp_path / "cache"
    ckpt = tmp_path / "resnet18.pt"
    exs = []
    for i, src in enumerate(resnet18_ckpts):
        shutil.copyfile(src, ckpt)
        exs.append(_resnet(sample_video, tmp_path / str(i), cache_dir,
                           weights_path=str(ckpt),
                           allow_random_weights=False))
        assert exs[-1]._weights_capture == [{
            "model_key": "resnet18", "path": str(ckpt),
            "sha256": tcache.file_sha256(str(src))}]
    _quiet(exs[0]._extract, sample_video)
    fcs = [ex.feature_cache() for ex in exs]
    assert fcs[0].config_fp == fcs[1].config_fp
    assert fcs[0].weights_fp != fcs[1].weights_fp
    assert fcs[1].lookup(sample_video, exs[1].output_feat_keys) is None
    assert fcs[0].lookup(sample_video, exs[0].output_feat_keys) is not None


def test_resize_auto_shares_entries_with_its_resolved_value(sample_video,
                                                           tmp_path):
    cache_dir = tmp_path / "cache"
    auto = _resnet(sample_video, tmp_path / "a", cache_dir, resize="auto")
    explicit = _resnet(sample_video, tmp_path / "b", cache_dir,
                       resize="device")
    host = _resnet(sample_video, tmp_path / "c", cache_dir, resize="host")
    assert auto.resize_mode == "device"
    fp = auto.feature_cache().config_fp
    assert fp == explicit.feature_cache().config_fp
    assert fp != host.feature_cache().config_fp
    feats = _quiet(auto._extract, sample_video)
    explicit.extract = _boom
    got = _quiet(explicit._extract, sample_video)
    for k in feats:
        np.testing.assert_array_equal(got[k], feats[k], err_msg=k)


def test_port_extractor_keys_apart_from_the_jax_extractor(
        sample_video, tmp_path, resnet18_ckpts):
    """resnet18 on one checkpoint in both packages: the config and weights
    fingerprints agree, the keys differ by the backend, and neither
    package's stored entry serves the other."""
    from video_features_tpu.config import load_config, sanity_check
    from video_features_tpu.extractors.resnet import ExtractResNet as JRes
    cache_dir = tmp_path / "cache"
    over = dict(weights_path=str(resnet18_ckpts[0]),
                allow_random_weights=False)
    port = _resnet(sample_video, tmp_path / "p", cache_dir, **over)
    jcfg = load_config("resnet", _raw_cfg(sample_video, tmp_path / "j",
                                          cache_dir, **over))
    sanity_check(jcfg)
    jex = _quiet(JRes, jcfg)
    tfc, jfc = port.feature_cache(), jex.feature_cache()
    assert (tfc.root, tfc.family) == (jfc.root, jfc.family)
    assert tfc.config_fp == jfc.config_fp
    assert tfc.weights_fp == jfc.weights_fp
    assert tfc.key_for(sample_video) != jfc.key_for(sample_video)
    jfc.store(sample_video, _feats())
    calls = []
    real = port.extract
    port.extract = lambda v: calls.append(v) or real(v)
    feats = _quiet(port._extract, sample_video)
    assert calls == [sample_video]  # the JAX entry was a miss
    os.unlink(jfc.entry_path(jfc.key_for(sample_video)))
    assert jfc.lookup(sample_video) is None  # the port's does not serve
    assert tfc.lookup(sample_video)["resnet"].shape == \
        feats["resnet"].shape


# -- the CLI and the injection sites -----------------------------------------

def _fake_rip(video_path, tmp_path):
    stem = Path(video_path).stem
    t = np.arange(int(16000 * 2.5)) / 16000.0
    tone = (0.4 * np.sin(2 * np.pi * 330.0 * t) * 32767).astype("<i2")
    Path(tmp_path).mkdir(parents=True, exist_ok=True)
    wav, aac = Path(tmp_path) / f"{stem}.wav", Path(tmp_path) / f"{stem}.aac"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(tone.tobytes())
    aac.write_bytes(b"")
    return str(wav), str(aac)


def test_cli_two_pass_all_hits_never_decodes_bit_identical(
        sample_video, tmp_path, monkeypatch):
    """``feature_type=r21d,resnet,vggish`` with ``cache=true`` twice, each
    into a fresh ``output_path``, over two byte-identical copies of the
    sample: the first pass extracts the first copy it meets and serves the
    other from that entry; the second pass serves every family of both
    from the store, decodes no frame and rips no wav."""
    from video_features_tpu_torch.cli import main
    rips = []
    monkeypatch.setattr(
        "video_features_tpu_torch.extractors.vggish.extract_wav_from_mp4",
        lambda v, t: rips.append(v) or _fake_rip(v, t))
    vids = []
    for i in range(2):
        vids.append(str(tmp_path / f"v{i}.mp4"))
        shutil.copy(sample_video, vids[-1])
    base = ["feature_type=r21d,resnet,vggish", "device=cpu",
            "allow_random_weights=true", "on_extraction=save_numpy",
            "resnet.model_name=resnet18", "resnet.extraction_total=6",
            "resnet.batch_size=8", "r21d.extraction_fps=1",
            "r21d.stack_size=10", "r21d.step_size=10", "cache=true",
            f"cache_dir={tmp_path / 'cache'}", f"tmp_path={tmp_path / 't'}",
            "video_paths=[" + ",".join(vids) + "]"]
    decoded = []
    for name in ("p1", "p2"):
        rips.clear()
        before = tio.decoded_frames()
        _quiet(main, base + [f"output_path={tmp_path / name}"])
        decoded.append((tio.decoded_frames() - before, len(rips)))
    assert decoded[0][0] > 0 and decoded[0][1] == 1
    assert decoded[1] == (0, 0)
    p1 = sorted((tmp_path / "p1").rglob("*.npy"))
    p2 = sorted((tmp_path / "p2").rglob("*.npy"))
    assert [p.relative_to(tmp_path / "p1") for p in p1] == \
        [p.relative_to(tmp_path / "p2") for p in p2] and len(p1) == 10
    for a, b in zip(p1, p2):
        assert a.read_bytes() == b.read_bytes(), a.name
    stats = tcache.cache_stats(str(tmp_path / "cache"))
    assert {f: s["entries"] for f, s in stats["families"].items()} == \
        {"r21d": 1, "resnet": 1, "vggish": 1}
    for a in (p for p in p1 if p.name.startswith("v0_")):
        twin = a.with_name("v1_" + a.name[3:])  # one entry's features
        assert a.read_bytes() == twin.read_bytes(), a.name


@pytest.mark.parametrize("site", ["cache.lookup", "cache.store"])
def test_cache_sites_fire_in_the_extraction(sample_video, tmp_path, site):
    """Through ``_extract``: ``cache.lookup=torn`` truncates the stored
    entry, which is dropped, extracted again and stored anew;
    ``cache.store=eio`` fails the store, which is printed while the video's
    features reach the sink."""
    cache_dir = tmp_path / "cache"
    first = _quiet(_resnet(sample_video, tmp_path / "a", cache_dir)._extract,
                   sample_video) if site == "cache.lookup" else None
    ex = _resnet(sample_video, tmp_path / "b", cache_dir)
    calls = []
    real = ex.extract
    ex.extract = lambda v: calls.append(v) or real(v)
    tinject.arm_for_run(f"seed=1;{site}="
                        + ("torn" if site == "cache.lookup" else "eio"))
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                contextlib.redirect_stderr(io.StringIO()):
            feats = ex._extract(sample_video)
        assert tinject.active().fired == {site: 1}
    finally:
        tinject.disarm()
    text = out.getvalue()
    assert calls == [sample_video]
    entries = tcache.cache_stats(str(cache_dir))["entries"]
    stem = Path(sample_video).stem
    assert list((tmp_path / "b" / "out").rglob(f"{stem}_resnet.npy"))
    if site == "cache.lookup":
        assert "dropping corrupted entry" in text and entries == 1
        np.testing.assert_array_equal(feats["resnet"], first["resnet"])
    else:
        assert "cache: store failed" in text and entries == 0
