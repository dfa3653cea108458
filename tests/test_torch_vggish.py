"""The port's VGGish family against the JAX package's.

Tolerances:

- the numpy frontend functions against JAX's (the same numpy code): 1e-12;
  ``read_wav`` round-trips 16-bit PCM and rejects other widths;
- the torch ``logmel_examples`` against ``logmel_examples_jnp`` and against
  the numpy frontend, on noise and on silence: 1e-4 (JAX's own
  device-against-numpy bar, tests/test_vggish.py);
- the network in float32 against the JAX module on a seeded ``init_params``
  tree carried across by ``vggish_state_from_jax``: atol 2e-5, rtol 1e-4;
  the bridge round-trips exactly; the port loads a seeded
  tests/torch_oracles.py ``TorchVGGish`` state dict with ``strict=True``
  and matches it at 1e-5 (an NCHW flatten would fail this one);
- bfloat16: the port closer to JAX bfloat16 than JAX float32 is (at the
  max and the median);
- ``postprocess`` against JAX's: 1e-5;
- ``ExtractVGGish`` on synthesised WAVs (16 kHz mono, 44.1 kHz stereo, and
  the short cases: under 240 samples the host frontend raises, shorter than
  one example gives (0, 128)) against JAX's extractor, both reading one
  seeded checkpoint through ``weights_path``: ``frontend=host`` 1e-4,
  ``frontend=device`` 1e-3 (tests/test_vggish.py); the CLI writes the JAX
  CLI's ``{stem}_vggish.npy`` at the same bars; the ffmpeg command lines
  of ``extract_wav_from_mp4`` (``subprocess.run`` and ``shutil.which``
  mocked) are JAX's, and the ripped temp files are removed unless
  ``keep_tmp_files``.

One seeded JAX tree, checkpoint and pair of extractors per frontend are
shared by the module; the audio is a few seconds long and ``batch_size=2``,
so a 3-example file runs a full batch and a short tail.
"""
import contextlib
import io
import subprocess
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_r21d import seeded_tree
from tests.torch_oracles import TorchVGGish
from video_features_tpu.models import vggish as jv
from video_features_tpu.ops import audio as ja
from video_features_tpu.parallel.mesh import cast_floating
from video_features_tpu_torch.models import vggish as tv
from video_features_tpu_torch.models.common import cast_floating_
from video_features_tpu_torch.ops import audio as ta
from video_features_tpu_torch.weights.bridge import vggish_state_from_jax

BATCH = 2


def write_wav(path, data_i16, rate=16000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.ascontiguousarray(data_i16).tobytes())
    return str(path)


def noise_i16(rng, shape, scale=0.3):
    return (scale * rng.standard_normal(shape) * 32767).clip(
        -32768, 32767).astype("<i2")


@pytest.fixture(scope="module")
def tree():
    return seeded_tree(jax.eval_shape(jv.init_params), 0)


@pytest.fixture(scope="module")
def port_model(tree):
    model = tv.VGGish()
    model.load_state_dict(vggish_state_from_jax(tree), strict=True)
    return model.eval()


# -- the numpy frontend ------------------------------------------------------

def test_numpy_frontend_matches_jax():
    rng = np.random.default_rng(0)
    wav = rng.normal(scale=0.1, size=48000)
    np.testing.assert_array_equal(ta.periodic_hann(400), ja.periodic_hann(400))
    np.testing.assert_array_equal(ta.frame(wav, 400, 160),
                                  ja.frame(wav, 400, 160))
    np.testing.assert_array_equal(ta.hertz_to_mel(np.arange(0.0, 8000, 7)),
                                  ja.hertz_to_mel(np.arange(0.0, 8000, 7)))
    np.testing.assert_allclose(ta.stft_magnitude(wav, 512, 160, 400),
                               ja.stft_magnitude(wav, 512, 160, 400),
                               rtol=1e-12, atol=1e-12)
    args = (64, 257, 16000, 125.0, 7500.0)
    np.testing.assert_allclose(ta.spectrogram_to_mel_matrix(*args),
                               ja.spectrogram_to_mel_matrix(*args),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ta.mel_matrix(),
                                  ja.spectrogram_to_mel_matrix(*args))
    kw = dict(audio_sample_rate=16000, log_offset=0.01,
              window_length_secs=0.025, hop_length_secs=0.010,
              num_mel_bins=64, lower_edge_hertz=125.0,
              upper_edge_hertz=7500.0)
    np.testing.assert_allclose(ta.log_mel_spectrogram(wav, **kw),
                               ja.log_mel_spectrogram(wav, **kw),
                               rtol=1e-12, atol=1e-12)
    for bad in (dict(lower_edge_hertz=-1.0), dict(upper_edge_hertz=9000.0),
                dict(lower_edge_hertz=8000.0, upper_edge_hertz=7000.0)):
        with pytest.raises(ValueError):
            ta.spectrogram_to_mel_matrix(64, 257, 16000, **{
                **dict(lower_edge_hertz=125.0, upper_edge_hertz=7500.0),
                **bad})


@pytest.mark.parametrize("rate,channels,seconds", [(16000, 1, 3.0),
                                                   (44100, 2, 2.2)])
def test_examples_and_chunks_match_jax(rate, channels, seconds):
    """Mono 16 kHz as it is; 44.1 kHz stereo through the mono mix and
    ``resample_poly``."""
    rng = np.random.default_rng(1)
    shape = (int(rate * seconds),) + ((channels,) if channels > 1 else ())
    wav = rng.normal(scale=0.1, size=shape)
    got, want = ta.waveform_to_examples(wav, rate), \
        ja.waveform_to_examples(wav, rate)
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.shape[0] == int(seconds / 0.96)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    chunks = ta.chunk_waveform(wav, rate)
    np.testing.assert_allclose(chunks, ja.chunk_waveform(wav, rate),
                               rtol=1e-12, atol=1e-12)
    assert chunks.shape == (got.shape[0], ta.EXAMPLE_CHUNK_SAMPLES)


@pytest.mark.parametrize("n", [100, 239, 240, 300, 8000, 15599, 15600])
def test_short_audio_matches_jax(n):
    """Under 240 samples the host frontend raises from ``frame`` (a
    negative frame count); up to one example it gives 0 examples, and so
    does ``chunk_waveform``."""
    wav = np.random.default_rng(2).normal(scale=0.1, size=n)
    if n < 240:
        with pytest.raises(ValueError):
            ja.waveform_to_examples(wav, 16000)
        with pytest.raises(ValueError):
            ta.waveform_to_examples(wav, 16000)
    else:
        assert ta.waveform_to_examples(wav, 16000).shape == \
            ja.waveform_to_examples(wav, 16000).shape == \
            (int(n >= 15600), 96, 64, 1)
    assert ta.chunk_waveform(wav, 16000).shape == \
        ja.chunk_waveform(wav, 16000).shape == (int(n >= 15600), 15600)


def test_read_wav_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    mono = noise_i16(rng, 1600)
    data, rate = ta.read_wav(write_wav(tmp_path / "m.wav", mono))
    assert rate == 16000 and data.dtype == np.float64
    np.testing.assert_array_equal(data, mono / 32768.0)
    stereo = noise_i16(rng, (800, 2))
    path = write_wav(tmp_path / "s.wav", stereo, 44100, 2)
    data, rate = ta.read_wav(path)
    assert rate == 44100 and data.shape == (800, 2)
    np.testing.assert_array_equal(data, ja.read_wav(path)[0])
    with wave.open(str(tmp_path / "u8.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(16000)
        w.writeframes(bytes(100))
    with pytest.raises(ValueError, match="16-bit"):
        ta.read_wav(str(tmp_path / "u8.wav"))


# -- the device frontend -----------------------------------------------------

@pytest.mark.parametrize("signal", ["noise", "silence"])
def test_logmel_examples_matches_jax(signal):
    """On silence every mel bin is 0 and the log is log(0.01) exactly;
    noise exercises the FFT."""
    rng = np.random.default_rng(4)
    wav = (rng.normal(scale=0.1, size=50000) if signal == "noise"
           else np.zeros(50000))
    chunks = ta.chunk_waveform(wav, 16000)
    want = np.asarray(jax.jit(ja.logmel_examples_jnp)(chunks))
    got = ta.logmel_examples(torch.from_numpy(chunks)).numpy()
    assert got.shape == want.shape == (3, 96, 64, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ta.waveform_to_examples(wav, 16000),
                               atol=1e-4, rtol=1e-4)


# -- the network -------------------------------------------------------------

def test_vggish_matches_jax(tree, port_model):
    x = np.random.default_rng(5).normal(size=(3, 96, 64, 1)).astype(
        np.float32)
    want = np.asarray(jax.jit(jv.VGGish().apply)({"params": tree}, x))
    with torch.inference_mode():
        got = port_model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, tv.EMBEDDING_SIZE)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_bridge_round_trips(tree):
    back = jv.params_from_torch(vggish_state_from_jax(tree))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want) == 18
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_loads_torch_oracle_strict():
    """torchvggish's key layout and flatten order: the oracle's state dict
    loads with ``strict=True`` and gives the oracle's embeddings."""
    torch.manual_seed(0)
    oracle = TorchVGGish().eval()
    port = tv.VGGish()
    port.load_state_dict(oracle.state_dict(), strict=True)
    x = np.random.default_rng(6).normal(size=(2, 96, 64, 1)).astype(
        np.float32)
    with torch.inference_mode():
        want = oracle(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bfloat16_closer_to_jax_bfloat16(tree, port_model):
    """flax rounds each conv's and dense layer's product to bfloat16 before
    the bias add; the port's ``Conv2d`` and ``Dense`` do the same."""
    x = np.random.default_rng(7).normal(size=(3, 96, 64, 1)).astype(
        np.float32)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        fn = jax.jit(lambda p, v, dt=dt: jv.VGGish().apply(
            {"params": p}, v.astype(dt)).astype(jnp.float32))
        want[dt] = np.asarray(fn(cast_floating(tree, dt), x))
    port = cast_floating_(tv.VGGish(), torch.bfloat16)
    port.load_state_dict(vggish_state_from_jax(tree))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x).bfloat16()).float().numpy()
    jb, jf = want[jnp.bfloat16], want[jnp.float32]
    ours, theirs = np.abs(got - jb), np.abs(jb - jf)
    assert ours.max() < theirs.max() and np.median(ours) <= np.median(theirs)
    assert np.median(theirs) > 0


@pytest.mark.parametrize("n", [5, 1])
def test_postprocess_matches_jax(n):
    """One example squeezes to (128,), as the reference's ``squeeze``."""
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(n, 128)).astype(np.float32)
    vectors = rng.normal(size=(128, 128)).astype(np.float32) / 8
    means = rng.normal(size=(128, 1)).astype(np.float32)
    got = tv.postprocess(emb, vectors, means)
    want = jv.postprocess(emb, vectors, means)
    assert got.shape == want.shape == ((n, 128) if n > 1 else (128,))
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- the extractor and the CLI -------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory, tree):
    """One seeded checkpoint in torchvggish's key layout, a PCA ``.npz``,
    and the WAVs: 3.5 s 16 kHz mono (3 examples), 2.2 s 44.1 kHz stereo
    (2), and the short ones."""
    d = tmp_path_factory.mktemp("vggish")
    ckpt = d / "vggish.pth"
    torch.save(vggish_state_from_jax(tree), ckpt)
    rng = np.random.default_rng(9)
    pca = d / "pca.npz"
    np.savez(pca, pca_eigen_vectors=rng.normal(size=(128, 128)) / 8,
             pca_means=rng.normal(size=(128,)))
    wavs = {"mono": write_wav(d / "mono.wav", noise_i16(rng, 56000)),
            "stereo": write_wav(d / "stereo.wav",
                                noise_i16(rng, (97020, 2)), 44100, 2),
            "s100": write_wav(d / "s100.wav", noise_i16(rng, 100)),
            "s8000": write_wav(d / "s8000.wav", noise_i16(rng, 8000))}
    yield dict(dir=d, ckpt=str(ckpt), pca=str(pca), wavs=wavs)
    ckpt.unlink(missing_ok=True)  # 276 MB, once the module is done


def _config(load_config, assets, sub, **over):
    cfg = {"device": "cpu", "batch_size": BATCH,
           "weights_path": assets["ckpt"],
           "output_path": str(assets["dir"] / sub / "o"),
           "tmp_path": str(assets["dir"] / sub / "t"),
           "video_paths": assets["wavs"]["mono"], **over}
    return load_config("vggish", cfg)


@pytest.fixture(scope="module")
def extractors(assets):
    """(port, jax) extractors per frontend, built once."""
    from video_features_tpu import config as jconfig
    from video_features_tpu.extractors.vggish import ExtractVGGish as JEx
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.vggish import \
        ExtractVGGish as TEx

    out = {}
    for frontend in ("host", "device"):
        pair = []
        for cfgmod, cls, sub in ((tconfig, TEx, "t"), (jconfig, JEx, "j")):
            cfg = _config(cfgmod.load_config, assets, sub + frontend,
                          frontend=frontend)
            cfgmod.sanity_check(cfg)
            pair.append(cls(cfg))
        out[frontend] = tuple(pair)
    return out


@pytest.mark.parametrize("frontend,atol", [("host", 1e-4), ("device", 1e-3)])
@pytest.mark.parametrize("wav", ["mono", "stereo", "s100", "s8000"])
def test_extract_matches_jax(extractors, assets, frontend, atol, wav):
    port, jax_ex = extractors[frontend]
    path = assets["wavs"][wav]
    if wav == "s100" and frontend == "host":
        for ex in (port, jax_ex):
            with pytest.raises(ValueError):
                ex.extract(path)
        return
    got, want = port.extract(path), jax_ex.extract(path)
    assert set(got) == set(want) == {"vggish"}
    rows = {"mono": 3, "stereo": 2, "s100": 0, "s8000": 0}[wav]
    assert got["vggish"].shape == want["vggish"].shape == (rows, 128)
    assert got["vggish"].dtype == np.float32
    np.testing.assert_allclose(got["vggish"], want["vggish"], atol=atol,
                               rtol=atol)


def test_postprocess_extract_matches_jax(extractors, assets):
    port, jax_ex = extractors["host"]
    raw = port.extract(assets["wavs"]["mono"])["vggish"]
    want = jv.postprocess(raw, *jv.load_pca_params(assets["pca"]))
    port._pca = tv.load_pca_params(assets["pca"])
    try:
        got = port.extract(assets["wavs"]["mono"])["vggish"]
    finally:
        port._pca = None
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.min() >= 0 and got.max() <= 255


def test_config_checks_vggish_keys(assets):
    from video_features_tpu_torch import config as tconfig
    for over, err in ((dict(frontend="gpu"), NotImplementedError),
                      (dict(postprocess="yes"), ValueError),
                      (dict(postprocess=True), FileNotFoundError),
                      (dict(postprocess=True, pca_weights_path="/no.npz"),
                       FileNotFoundError)):
        cfg = _config(tconfig.load_config, assets, "c", **over)
        with pytest.raises(err, match=next(iter(over))
                           if err is not FileNotFoundError
                           else "pca_weights_path"):
            tconfig.sanity_check(cfg)
    cfg = _config(tconfig.load_config, assets, "c", postprocess=True,
                  pca_weights_path=assets["pca"], precision="bfloat16")
    tconfig.sanity_check(cfg)
    with pytest.raises(NotImplementedError, match="show_pred"):
        from video_features_tpu_torch.extractors.vggish import ExtractVGGish
        ExtractVGGish(_config(tconfig.load_config, assets, "c",
                              show_pred=True))


def test_suffixes_and_mocked_ffmpeg_match_jax(extractors, assets,
                                              monkeypatch):
    """``.mp4`` goes through ``extract_wav_from_mp4``: the same two ffmpeg
    command lines as JAX's; the ripped files are removed after the
    extraction unless ``keep_tmp_files``. Any other suffix raises; no
    binary raises JAX's ``RuntimeError``."""
    import shutil
    from video_features_tpu.utils import io as jio
    from video_features_tpu_torch.utils import io as tio

    port, _ = extractors["host"]
    with pytest.raises(NotImplementedError, match="'.avi'"):
        port.extract("clip.avi")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for fn in (jio.extract_wav_from_mp4, tio.extract_wav_from_mp4):
        with pytest.raises(RuntimeError, match="ffmpeg is required"):
            fn("v.mp4", str(assets["dir"] / "rip"))
    monkeypatch.setattr(shutil, "which", lambda name: "/bin/ffmpeg")
    calls = []

    def fake_run(cmd, check):
        calls.append(list(cmd))
        if cmd[-1].endswith(".wav"):  # the second step writes the wav
            Path(cmd[-1]).write_bytes(
                Path(assets["wavs"]["mono"]).read_bytes())
        else:
            Path(cmd[-1]).write_bytes(b"aac")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    rip = str(assets["dir"] / "rip")
    want = jio.extract_wav_from_mp4("/v/a.mp4", rip)
    got = tio.extract_wav_from_mp4("/v/a.mp4", rip)
    assert got == want and len(calls) == 4 and calls[:2] == calls[2:]
    assert calls[0][-3:] == ["-acodec", "copy", str(Path(rip) / "a.aac")]
    out = port.extract("/v/clip.mp4")["vggish"]
    np.testing.assert_array_equal(
        out, port.extract(assets["wavs"]["mono"])["vggish"])
    tmp = Path(port.tmp_path)
    assert not (tmp / "clip.wav").exists() and not (tmp / "clip.aac").exists()
    port.keep_tmp_files = True
    try:
        port.extract("/v/clip.mp4")
    finally:
        port.keep_tmp_files = False
    assert (tmp / "clip.wav").exists() and (tmp / "clip.aac").exists()


@pytest.mark.parametrize("frontend,atol", [("host", 1e-4), ("device", 1e-3)])
def test_cli_writes_the_jax_clis_npy(assets, frontend, atol):
    from video_features_tpu.cli import main as jmain
    from video_features_tpu_torch.cli import main as tmain

    wav = assets["wavs"]["stereo"]
    got = {}
    for name, main in (("jax", jmain), ("port", tmain)):
        root = assets["dir"] / f"cli_{name}_{frontend}"
        with contextlib.redirect_stdout(io.StringIO()):
            main(["feature_type=vggish", "device=cpu",
                  f"weights_path={assets['ckpt']}", f"frontend={frontend}",
                  "on_extraction=save_numpy", f"batch_size={BATCH}",
                  f"output_path={root / 'o'}", f"tmp_path={root / 't'}",
                  f"video_paths={wav}"])
        files = sorted((root / "o" / "vggish").glob("*.npy"))
        assert [f.name for f in files] == ["stereo_vggish.npy"], name
        got[name] = np.load(files[0])
    assert got["port"].shape == got["jax"].shape == (2, 128)
    np.testing.assert_allclose(got["port"], got["jax"], atol=atol,
                               rtol=atol)
