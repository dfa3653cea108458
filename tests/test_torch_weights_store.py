"""The port's weights store (``video_features_tpu_torch/weights/store.py``)
against the JAX package's (``tests/test_weights_fetch.py`` and
``tests/test_checkpoint_formats.py`` on the port).

- the tables (``HUB_FILENAMES``, ``WEIGHT_URLS``, ``REF_FILES``,
  ``CLIP_SHA256``), ``expected_digest`` and the converters' model keys
  equal JAX's;
- ``find_checkpoint``'s search order equals JAX's on every layout of a
  weights dir and a torch hub cache;
- the fetcher with the network mocked (``urllib.request.urlopen`` serves
  canned bytes; nothing is fetched): the flag, the published and prefix
  digests, the mutable-ref refusal before any network call, trust on first
  use, ``sweep_stale_parts`` on a fake clock;
- a JAX ``save_msgpack(init_params(...))`` file loads through the port's
  own reader (no flax, no msgpack) to a state dict bit-equal to
  ``weights/bridge.py`` on the in-memory tree; the reader equals flax's on
  a tree of every type it writes, chunked leaves included;
- the native layouts of ``tests/test_checkpoint_formats.py`` (module.-
  prefixed flow nets, repo-local ``.pt`` files, hub ``.pth`` files, the
  torchvggish release and its PCA twins, a TorchScript CLIP archive with
  float16 weights and metadata entries), built from seeded port modules,
  resolve through the store under their upstream filenames;
- the extractors' errors name ``weights_dir()``; the cache key's weights
  record equals JAX's for the same file.
"""
import hashlib
import io
import os

import numpy as np
import pytest
import torch

from video_features_tpu.weights import store as jstore
from video_features_tpu_torch.weights import bridge, converters, store
from video_features_tpu_torch.weights.bridge import seeded_init_

PAYLOAD = b"synthetic checkpoint bytes" * 64
PAYLOAD_SHA = hashlib.sha256(PAYLOAD).hexdigest()


class _FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.fixture()
def dirs(tmp_path, monkeypatch):
    """An empty weights dir and torch home, for both packages."""
    wd, th = tmp_path / "weights", tmp_path / "torch_home"
    monkeypatch.setenv("VFT_WEIGHTS_DIR", str(wd))
    monkeypatch.setenv("TORCH_HOME", str(th))
    monkeypatch.delenv("VFT_FETCH_WEIGHTS", raising=False)
    return wd, th


# -- the tables -------------------------------------------------------------

@pytest.mark.parametrize("name", ["HUB_FILENAMES", "WEIGHT_URLS",
                                  "REF_FILES", "CLIP_SHA256", "PART_STALE_S"])
def test_tables_equal_jax(name):
    assert getattr(store, name) == getattr(jstore, name)


def test_expected_digest_and_keys_equal_jax():
    from video_features_tpu.weights.converters import registry
    for fnames in store.HUB_FILENAMES.values():
        for f in fnames:
            assert store.expected_digest(f) == jstore.expected_digest(f)
    assert store.expected_digest("resnet18-f37072fd.pth") == (
        "sha256-prefix", "f37072fd")
    assert store.expected_digest("raft-sintel.pth") == (None, None)
    assert sorted(converters.registry()) == sorted(registry())
    assert store.weights_dir() == jstore.weights_dir()


# -- the search order ---------------------------------------------------------

LAYOUTS = {
    "empty": [],
    "msgpack_first": ["w/raft_sintel.msgpack", "w/raft_sintel.pt",
                      "w/raft_sintel.pth", "w/raft-sintel.pth"],
    "pt_before_pth": ["w/raft_sintel.pt", "w/raft_sintel.pth"],
    "pth": ["w/raft_sintel.pth", "th/hub/checkpoints/raft-sintel.pth"],
    "hub_before_dir": ["th/hub/checkpoints/raft-sintel.pth",
                       "w/raft-sintel.pth"],
    "upstream_name_in_dir": ["w/raft-sintel.pth"],
    "second_hub_name": ["w/resnet18-5c106cde.pth"],
    "hub_order": ["th/hub/checkpoints/resnet18-5c106cde.pth",
                  "w/resnet18-f37072fd.pth"],
    "pca_twin": ["w/vggish_pca_params.npz"],
}


@pytest.mark.parametrize("layout", list(LAYOUTS), ids=list(LAYOUTS))
def test_search_order_equals_jax(dirs, layout):
    wd, th = dirs
    for rel in LAYOUTS[layout]:
        p = (wd if rel.startswith("w/") else th) / rel.split("/", 1)[1]
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rel.encode())
    for key in ("raft_sintel", "resnet18", "vggish_pca", "i3d_rgb"):
        assert store.find_checkpoint(key) == jstore.find_checkpoint(key)
    explicit = wd.parent / "mine.pt"
    explicit.write_bytes(b"x")
    assert store.find_checkpoint("raft_sintel", str(explicit)) == explicit
    for mod in (store, jstore):
        with pytest.raises(FileNotFoundError, match="does not exist"):
            mod.find_checkpoint("raft_sintel", str(wd.parent / "no.pt"))


# -- the fetcher, network mocked -----------------------------------------------

@pytest.fixture()
def fake_upstream(dirs, monkeypatch):
    """A synthetic key served by a patched ``urlopen``; returns the key and
    the list of URLs asked for."""
    key = "fake_model"
    monkeypatch.setitem(store.HUB_FILENAMES, key, ("fake-model.pt",))
    monkeypatch.setitem(store.WEIGHT_URLS, "fake-model.pt",
                        "https://example.invalid/fake-model.pt")
    monkeypatch.setitem(store.CLIP_SHA256, "fake-model.pt", PAYLOAD_SHA)
    calls = []

    def fake_urlopen(url, timeout=None):
        calls.append(url)
        return _FakeResponse(PAYLOAD)

    import urllib.request
    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    return key, calls


def test_no_fetch_without_flag(fake_upstream):
    key, calls = fake_upstream
    assert store.find_checkpoint(key) is None
    assert calls == []


def test_fetch_verifies_and_caches(fake_upstream, monkeypatch, dirs):
    key, calls = fake_upstream
    monkeypatch.setenv("VFT_FETCH_WEIGHTS", "1")
    p = store.find_checkpoint(key)
    assert p is not None and p.read_bytes() == PAYLOAD
    assert len(calls) == 1 and not list(dirs[0].glob("*.part"))
    assert store.find_checkpoint(key) == p and len(calls) == 1


def test_fetch_refuses_digest_mismatch(fake_upstream, monkeypatch, dirs):
    key, _ = fake_upstream
    monkeypatch.setitem(store.CLIP_SHA256, "fake-model.pt", "0" * 64)
    monkeypatch.setenv("VFT_FETCH_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="does not match the published"):
        store.find_checkpoint(key)
    assert not list(dirs[0].iterdir())


def test_fetch_prefix_digest(fake_upstream, monkeypatch):
    key, _ = fake_upstream
    fname = f"fake-{PAYLOAD_SHA[:8]}.pth"
    monkeypatch.setitem(store.HUB_FILENAMES, key, (fname,))
    monkeypatch.setitem(store.WEIGHT_URLS, fname,
                        "https://example.invalid/" + fname)
    monkeypatch.setenv("VFT_FETCH_WEIGHTS", "1")
    assert store.find_checkpoint(key).name == fname


def test_fetch_failure_leaves_no_part(fake_upstream, monkeypatch, dirs):
    key, _ = fake_upstream
    import urllib.request

    def down(url, timeout=None):
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", down)
    monkeypatch.setenv("VFT_FETCH_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="download of .* failed"):
        store.find_checkpoint(key)
    assert not list(dirs[0].glob("*.part"))


def test_every_hub_filename_has_a_url_or_is_alt():
    for key, fnames in store.HUB_FILENAMES.items():
        assert any(f in store.WEIGHT_URLS for f in fnames), key


def test_ref_blob_refuses_mutable_master(dirs, monkeypatch):
    monkeypatch.setenv("VFT_FETCH_WEIGHTS", "1")
    monkeypatch.delenv("VFT_ALLOW_MUTABLE_REF", raising=False)
    monkeypatch.setattr(store, "_REF_COMMIT", "")
    calls = []
    import urllib.request
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout=None: calls.append(url))
    with pytest.raises(RuntimeError, match="VFT_REF_COMMIT"):
        store.find_checkpoint("raft_sintel")
    assert calls == [] and not dirs[0].exists()


def test_ref_blob_records_digest_then_verifies(dirs, monkeypatch):
    monkeypatch.setenv("VFT_FETCH_WEIGHTS", "1")
    monkeypatch.setenv("VFT_ALLOW_MUTABLE_REF", "1")
    payload = [PAYLOAD]
    import urllib.request
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout=None: _FakeResponse(payload[0]))
    p = store.find_checkpoint("raft_sintel")
    assert p is not None and p.read_bytes() == PAYLOAD
    assert store.recorded_digest("raft-sintel.pth") == PAYLOAD_SHA
    # the JAX package reads the port's record, and the other way round
    assert jstore.recorded_digest("raft-sintel.pth") == PAYLOAD_SHA
    p.unlink()
    payload[0] = b"tampered bytes" * 64
    with pytest.raises(RuntimeError, match="recorded digest"):
        store.find_checkpoint("raft_sintel")
    assert not (dirs[0] / "raft-sintel.pth").exists()
    payload[0] = PAYLOAD
    assert store.find_checkpoint("raft_sintel") is not None


def test_sweep_stale_parts_on_a_fake_clock(tmp_path):
    now = 1_000_000.0
    ages = {"old.part": 7200.0, "edge.part": store.PART_STALE_S,
            "young.part": 60.0, "keep.pt": 7200.0}
    for name, age in ages.items():
        p = tmp_path / name
        p.write_bytes(b"x")
        os.utime(p, (now - age, now - age))
    assert store.sweep_stale_parts(tmp_path, now=now) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "keep.pt", "young.part"]
    assert store.sweep_stale_parts(tmp_path, now=now, stale_s=30) == 1
    assert jstore.sweep_stale_parts(tmp_path, now=now) == 0
    assert store.sweep_stale_parts(tmp_path / "missing", now=now) == 0


# -- flax's msgpack --------------------------------------------------------------

def test_reader_equals_flax_on_every_type(monkeypatch):
    from flax import serialization
    rng = np.random.default_rng(19)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "i8": np.arange(-4, 4, dtype=np.int8),
        "u16": np.arange(300, dtype=np.uint16),
        "bool": np.array([True, False]),
        "zero_d": np.array(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(1.5),
        "ints": {"small": 3, "neg": -7, "big": 2 ** 40, "negbig": -2 ** 33,
                 "u8": 200, "i16": -300},
        "float": 0.25, "str": "résumé", "long_str": "k" * 300,
        "none": None, "true": True, "complex": 1 + 2j,
        "nested": {str(i): {"w": np.full((2,), i, np.float32)}
                   for i in range(20)},
        "chunked": rng.normal(size=(5, 7)).astype(np.float32),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    got = store.read_msgpack(data)
    want = serialization.msgpack_restore(data)

    def same(a, b, path="tree"):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        else:
            assert type(a) is type(b) and a == b, path

    same(got, want)
    with pytest.raises(ValueError, match="truncated"):
        store.read_msgpack(data[:-3])


@pytest.fixture(scope="module")
def resnet18_msgpack(tmp_path_factory):
    """``save_msgpack(init_params('resnet18'))`` of the JAX package, and
    the tree it saved."""
    from video_features_tpu.models import resnet as jresnet
    tree = jresnet.init_params("resnet18")
    path = tmp_path_factory.mktemp("msgpack") / "resnet18.msgpack"
    jstore.save_msgpack(tree, path)
    yield path, tree
    path.unlink(missing_ok=True)


def test_jax_msgpack_loads_bit_equal_to_bridge(resnet18_msgpack, dirs):
    import jax
    path, tree = resnet18_msgpack
    host = jax.tree_util.tree_map(np.asarray, tree)
    want = bridge.resnet_state_from_jax(host)
    got = store.load_state(path, "resnet18")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    # resolved from VFT_WEIGHTS_DIR with no weights path, recorded as JAX
    from video_features_tpu_torch.models import resnet as tresnet
    wd, _ = dirs
    wd.mkdir()
    (wd / "resnet18.msgpack").write_bytes(path.read_bytes())
    cap = store.start_weights_capture()
    net = store.resolve_params(tresnet.ResNet("resnet18"), "resnet18")
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    jcap = jstore.start_weights_capture()
    jstore._record_resolution({"model_key": "resnet18",
                               "path": str(wd / "resnet18.msgpack"),
                               "sha256": jstore._file_fingerprint(
                                   wd / "resnet18.msgpack")})
    assert cap == jcap
    with pytest.raises(ValueError, match="no converter"):
        store.load_state(path, "nosuch")


# -- the native layouts -----------------------------------------------------------

def _i3d(c):
    from video_features_tpu_torch.models import i3d
    return i3d.I3D(400, in_channels=c)


def _raft():
    from video_features_tpu_torch.models import raft
    return raft.RAFT(2)


def _pwc():
    from video_features_tpu_torch.models import pwc
    return pwc.PWCNet()


def _s3d():
    from video_features_tpu_torch.models import s3d
    return s3d.S3D(400)


def _r21d():
    from video_features_tpu_torch.models import r21d
    return r21d.R2Plus1D("r2plus1d_18_16_kinetics")


def _vggish():
    from video_features_tpu_torch.models import vggish
    return vggish.VGGish()


def _prefixed(sd):
    return {f"module.{k}": v for k, v in sd.items()}


FORMATS = {
    "raft_module_prefixed": ("raft_sintel", "raft-sintel.pth", _raft,
                             _prefixed),
    "pwc_module_prefixed": ("pwc_sintel", "pwc_net_sintel.pt", _pwc,
                            _prefixed),
    "i3d_rgb_repo_local": ("i3d_rgb", "i3d_rgb.pt", lambda: _i3d(3), dict),
    "i3d_flow_repo_local": ("i3d_flow", "i3d_flow.pt", lambda: _i3d(2),
                            dict),
    "s3d_torchified": ("s3d_kinetics400", "S3D_kinetics400_torchified.pt",
                       _s3d, dict),
    "r21d_hub_pth": ("r2plus1d_18_16_kinetics", "r2plus1d_18-91a641e6.pth",
                     _r21d, lambda sd: {"state_dict": sd}),
    "vggish_release": ("vggish", "vggish-10086976.pth", _vggish, dict),
}


@pytest.mark.parametrize("case", list(FORMATS), ids=list(FORMATS))
def test_native_layout_resolves(dirs, case):
    key, fname, build, layout = FORMATS[case]
    wd, _ = dirs
    wd.mkdir()
    sd = seeded_init_(build(), 19).state_dict()
    torch.save(layout(sd), wd / fname)
    assert store.find_checkpoint(key) == wd / fname
    net = store.resolve_params(build(), key)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    (wd / fname).unlink()


@pytest.mark.parametrize("kind", ["npz", "pth"])
def test_vggish_pca_formats(dirs, kind):
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.models import vggish
    wd, _ = dirs
    wd.mkdir()
    rng = np.random.default_rng(3)
    vectors = rng.normal(size=(128, 128)).astype(np.float32)
    means = rng.normal(size=(128,)).astype(np.float32)
    if kind == "npz":
        path = wd / "vggish_pca_params.npz"
        np.savez(path, pca_eigen_vectors=vectors, pca_means=means)
    else:
        path = wd / "vggish_pca_params-970ea276.pth"
        torch.save({"pca_eigen_vectors": torch.from_numpy(vectors),
                    "pca_means": torch.from_numpy(means)}, path)
    found = tconfig.pca_weights_path({"postprocess": True})
    assert found == str(path) == str(jstore.find_checkpoint("vggish_pca"))
    v, m = vggish.load_pca_params(found)
    np.testing.assert_array_equal(v, vectors)
    np.testing.assert_array_equal(m, means.reshape(-1, 1))
    path.unlink()
    with pytest.raises(FileNotFoundError, match=str(wd)):
        tconfig.pca_weights_path({"postprocess": True})


def test_clip_torchscript_archive(dirs):
    """The OpenAI CDN's format: a TorchScript archive with float16 weights
    and the metadata entries ``build_model`` drops, under its upstream
    filename (a tiny ViT stands in for ViT-B/32's widths)."""
    from video_features_tpu_torch.extractors.clip import model_key
    from video_features_tpu_torch.models import clip as tclip
    wd, _ = dirs
    wd.mkdir()
    cfg = tclip.CLIPConfig(32, 56, 2, 64, 14, 12, 128, 128, 2, 2)
    model = seeded_init_(tclip.CLIP(cfg), 5).eval()
    half = {k: v.half() for k, v in model.state_dict().items()}
    model.load_state_dict({k: v.float() for k, v in half.items()})
    for name, value in (("input_resolution", 56), ("context_length", 12),
                        ("vocab_size", 128)):
        model.register_buffer(name, torch.tensor(value))
    archive = torch.jit.trace_module(model, {"encode_image": torch.zeros(
        1, 56, 56, 3)})
    archive.half().save(str(wd / "ViT-B-32.pt"))
    saved = torch.jit.load(str(wd / "ViT-B-32.pt")).state_dict()
    assert saved["visual.conv1.weight"].dtype == torch.float16
    assert "input_resolution" in saved
    key = model_key("ViT-B/32")
    assert store.find_checkpoint(key) == wd / "ViT-B-32.pt"
    net = store.resolve_params(tclip.CLIP(cfg), key,
                               prepare=tclip.checkpoint_state)
    for k, v in net.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, half[k].float()), k


def test_missing_weights_name_the_store_dir(dirs):
    from video_features_tpu_torch.models import raft
    wd, _ = dirs
    for mod_err in (pytest.raises(FileNotFoundError, match=str(wd)),):
        with mod_err as e:
            store.resolve_params(raft.RAFT(2), "raft_sintel")
    assert "raft-sintel.pth" in str(e.value)
    cap = store.start_weights_capture()
    store.resolve_params(raft.RAFT(2), "raft_sintel", allow_random=True,
                         seed=3)
    assert cap == [{"model_key": "raft_sintel", "random": True}]
