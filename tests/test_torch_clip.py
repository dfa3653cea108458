"""The port's CLIP family against the JAX package's.

Weights: the JAX ``init_params`` trees of two tiny models (their structure
and shapes from ``jax.eval_shape``) filled with seeded numpy values, batch
norms and LayerNorms away from the identity, carried across by
``clip_state_from_jax``: a ViT (width 64, 2 + 2 layers, patch 14 on 56 px,
as tests/test_clip.py shapes it, its text tower 128 wide with 2 heads) and
a ModifiedResNet (one bottleneck per stage, width 16, 64 px: 8 heads in
the attention pool). Tolerances:

- ``encode_image`` and ``encode_text`` in float32: rtol 1e-4, atol 1e-5
  times the largest magnitude of the JAX output;
- bfloat16 ``encode_image``: the port closer to JAX bfloat16 than JAX
  float32 is (at the max and the median);
- the bridge round-trips: JAX tree -> port state dict -> JAX
  ``params_from_torch`` gives every leaf back exactly;
- ``config_from_state_dict`` equals JAX's on the tiny models and on every
  published configuration (state dicts on the meta device);
- ``ClipTokenizer`` equals JAX's (vocab, ids, rows, decode, errors) on
  prompts with digits, punctuation, contractions and non-ASCII text, over a
  merges file the test writes (no vocab file is fetched);
- a TorchScript archive and a float16 state dict load to the features of
  the float32 state dict of the same values, exactly;
- ``ExtractCLIP`` against the JAX extractor, both reading one seeded
  checkpoint through ``weights_path``, on the sample video with
  ``extraction_total=4``: ViT-B/32 under ``resize=host|device`` x
  ``ingest=uint8|yuv420``, and ``model_name=custom`` with the tiny
  ModifiedResNet; features within the value tier's atol 1e-2, ``fps`` and
  ``timestamps_ms`` exact; ``show_pred`` over ``pred_texts`` prints JAX's
  labels.
"""
import contextlib
import dataclasses
import gzip
import io
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.models import clip as jc
from video_features_tpu.parallel.mesh import cast_floating
from video_features_tpu_torch.models import clip as tc
from video_features_tpu_torch.models.common import cast_floating_
from video_features_tpu_torch.weights.bridge import (clip_state_from_jax,
                                                      seeded_init_)

#: (embed, resolution, vision layers, vision width, patch, context, vocab,
#: text width, text heads, text layers; heads = width // 64, as the
#: checkpoints imply)
TINY = {"vit": (32, 56, 2, 64, 14, 12, 128, 128, 2, 2),
        "rn": (64, 64, (1, 1, 1, 1), 16, None, 12, 128, 64, 1, 1)}


def configs(name):
    return jc.CLIPConfig(*TINY[name]), tc.CLIPConfig(*TINY[name])


def seeded_clip_tree(shapes, seed):
    """A JAX CLIP tree of ``shapes`` with seeded values: LeCun-normal
    kernels and projections, small biases and embeddings, batch norms and
    LayerNorms away from the identity."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = node["mean"].shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "mean": rng.uniform(-0.2, 0.2, c).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "logit_scale":
                out[k] = np.asarray(np.log(1 / 0.07), np.float32)
            elif k == "scale":  # a LayerNorm
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("kernel", "proj", "text_projection"):
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.normal(size=v.shape) / np.sqrt(fan_in)).astype(
                    np.float32)
            else:
                out[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        return out

    return walk(shapes)


@pytest.fixture(scope="module")
def params():
    out = {}
    for seed, name in enumerate(TINY):
        jcfg, _ = configs(name)
        r, n = TINY[name][1], TINY[name][5]
        shapes = jax.eval_shape(lambda c=jcfg, r=r, n=n: jc.CLIP(c).init(
            jax.random.PRNGKey(0), jnp.zeros((1, r, r, 3)),
            jnp.zeros((1, n), jnp.int32))["params"])
        out[name] = seeded_clip_tree(shapes, seed)
    return out


def _port(tree, name):
    model = tc.CLIP(configs(name)[1])
    model.load_state_dict(clip_state_from_jax(tree), strict=True)
    return model.eval()


def assert_close_to_scale(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()))


def images(name, n=3, seed=1):
    r = TINY[name][1]
    return np.random.default_rng(seed).normal(size=(n, r, r, 3)).astype(
        np.float32)


def tokens(n, ctx, vocab, seed=2):
    """Token rows whose strict maximum (the EOT) sits at a seeded place."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab - 1, size=(n, ctx)).astype(np.int32)
    for i in range(n):
        eot = rng.integers(2, ctx)
        toks[i, eot] = vocab - 1
        toks[i, eot + 1:] = 0
    return toks


@pytest.mark.parametrize("name", list(TINY))
def test_encode_image_matches_jax(params, name):
    x = images(name)
    want = np.asarray(jc.CLIP(configs(name)[0]).apply(
        {"params": params[name]}, x, method="encode_image"))
    with torch.inference_mode():
        got = _port(params[name], name).encode_image(
            torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, TINY[name][0])
    assert_close_to_scale(got, want)


@pytest.mark.parametrize("name", list(TINY))
def test_encode_text_matches_jax(params, name):
    toks = tokens(4, 12, 128)
    want = np.asarray(jc.CLIP(configs(name)[0]).apply(
        {"params": params[name]}, toks, method="encode_text"))
    with torch.inference_mode():
        got = _port(params[name], name).encode_text(
            torch.from_numpy(toks).long()).numpy()
    assert got.shape == want.shape == (4, TINY[name][0])
    assert_close_to_scale(got, want)


@pytest.mark.parametrize("name", list(TINY))
def test_bfloat16_closer_to_jax_bfloat16(params, name):
    x = images(name, seed=4)
    model = jc.CLIP(configs(name)[0])
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        fn = jax.jit(lambda p, v, dt=dt: model.apply(
            {"params": p}, v.astype(dt),
            method="encode_image").astype(jnp.float32))
        want[dt] = np.asarray(fn(cast_floating(params[name], dt), x))
    port = cast_floating_(_port(params[name], name), torch.bfloat16)
    with torch.inference_mode():
        got = port.encode_image(torch.from_numpy(x).bfloat16()).float()
    jb, jf = want[jnp.bfloat16], want[jnp.float32]
    ours, theirs = np.abs(got.numpy() - jb), np.abs(jb - jf)
    assert ours.max() < theirs.max() and np.median(ours) < np.median(theirs)


@pytest.mark.parametrize("name", list(TINY))
def test_bridge_round_trips(params, name):
    back = jc.params_from_torch(clip_state_from_jax(params[name]))
    want = jax.tree_util.tree_flatten_with_path(params[name])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("name", list(TINY) + list(tc.CONFIGS))
def test_config_from_state_dict_matches_jax(name):
    cfg = tc.CLIPConfig(*TINY[name]) if name in TINY else tc.CONFIGS[name]
    with torch.device("meta"):
        sd = tc.CLIP(cfg).state_dict()
    got = tc.config_from_state_dict(sd)
    assert got == cfg
    assert dataclasses.asdict(jc.config_from_state_dict(sd)) == \
        dataclasses.asdict(got)


def test_available_models_match_jax():
    assert tc.available_models() == jc.available_models()
    for name in tc.CONFIGS:
        assert dataclasses.asdict(tc.CONFIGS[name]) == \
            dataclasses.asdict(jc.CONFIGS[name])


# ---- tokenizer ----------------------------------------------------------

TEXTS = ["a photo of abseiling", "a photo of washing dishes",
         "Hello, World!  it's a   test...", "hyphenated-words & punctuation?!",
         "numbers 123 and 42nd", "café naïve déjà vu", "I'll we've can't",
         "日本語 text", ""]


def write_merges(path, corpus, n_merges=80):
    """A BPE merges file learnt from ``corpus`` as CLIP's trainer would
    write it: a version header, then one ``a b`` pair a line."""
    from video_features_tpu_torch.utils.tokenizer import byte_to_unicode
    import regex
    enc = byte_to_unicode()
    words = Counter()
    for text in corpus:
        for tok in regex.findall(r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
                                 text.lower()):
            mapped = "".join(enc[b] for b in tok.encode("utf-8"))
            words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w[:-1], w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    body = "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write(body)
    return path


@pytest.fixture(scope="module")
def bpe_file(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "bpe.txt.gz",
                        TEXTS * 3 + ["a photo of a cat", "photos photo"])


def test_tokenizer_matches_jax(bpe_file):
    from video_features_tpu.utils.tokenizer import ClipTokenizer as JTok
    from video_features_tpu_torch.utils.tokenizer import ClipTokenizer

    jtok, ttok = JTok(str(bpe_file)), ClipTokenizer(str(bpe_file))
    assert ttok.encoder == jtok.encoder and len(ttok.rank) > 20
    assert (ttok.sot_token, ttok.eot_token) == (jtok.sot_token,
                                                 jtok.eot_token)
    for text in TEXTS:
        assert ttok.encode(text) == jtok.encode(text), text
        assert ttok.decode(ttok.encode(text)) == \
            jtok.decode(jtok.encode(text))
    assert any(len(ttok.encode(t)) < len(t.encode("utf-8")) for t in TEXTS)
    np.testing.assert_array_equal(ttok.tokenize(TEXTS), jtok.tokenize(TEXTS))
    np.testing.assert_array_equal(
        ttok.tokenize(["word " * 40], context_length=16, truncate=True),
        jtok.tokenize(["word " * 40], context_length=16, truncate=True))
    for tok in (ttok, jtok):
        with pytest.raises(RuntimeError, match="too long"):
            tok.tokenize(["word " * 40], context_length=16)


def test_tokenizer_needs_a_vocab_path(tmp_path):
    from video_features_tpu_torch.utils.tokenizer import ClipTokenizer
    with pytest.raises(FileNotFoundError, match="bpe_path"):
        ClipTokenizer(None)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        ClipTokenizer(str(tmp_path / "missing.txt.gz"))


# ---- checkpoints and the extractor ---------------------------------------

def _port_config(tmp, video, **over):
    cfg = dict(video_paths=video, device="cpu", batch_size=3,
               extraction_total=4, output_path=str(tmp / "o"),
               tmp_path=str(tmp / "t"))
    cfg.update(over)
    return cfg


def _build(tmp, video, jax_too=True, **over):
    from video_features_tpu import config as jconfig
    from video_features_tpu.extractors.clip import ExtractCLIP as JEx
    from video_features_tpu_torch import config as tconfig
    from video_features_tpu_torch.extractors.clip import ExtractCLIP

    cfg = _port_config(tmp, video, **over)
    tcfg = tconfig.load_config("clip", cfg)
    tconfig.sanity_check(tcfg)
    if not jax_too:
        return ExtractCLIP(tcfg)
    jcfg = jconfig.load_config("clip", cfg)
    jconfig.sanity_check(jcfg)
    return JEx(jcfg), ExtractCLIP(tcfg)


def test_torchscript_and_float16_checkpoints_load_alike(tmp_path, params,
                                                        sample_video):
    """``model_name=custom`` on the tiny ViT: a float16 state dict, the
    float32 state dict of its values and a TorchScript archive of them
    give the same features."""
    model = _port(params["vit"], "vit")
    half = {k: v.half() for k, v in model.state_dict().items()}
    torch.save(half, tmp_path / "half.pt")
    torch.save({k: v.float() for k, v in half.items()}, tmp_path / "f32.pt")
    model.load_state_dict({k: v.float() for k, v in half.items()})
    torch.jit.trace_module(model, {"encode_image": torch.zeros(
        1, 56, 56, 3)}).save(str(tmp_path / "jit.pt"))
    feats = {}
    for name in ("half", "f32", "jit"):
        ex = _build(tmp_path / name, sample_video, jax_too=False,
                    model_name="custom", weights_path=str(
                        tmp_path / f"{name}.pt"), extraction_total=2)
        assert ex.cfg == tc.CLIPConfig(*TINY["vit"])
        assert all(p.dtype == torch.float32 for p in ex.model.parameters())
        feats[name] = ex.extract(sample_video)["clip"]
    assert feats["f32"].shape == (2, 32)
    np.testing.assert_array_equal(feats["half"], feats["f32"])
    np.testing.assert_array_equal(feats["jit"], feats["f32"])


def test_custom_needs_weights_path(tmp_path, sample_video):
    with pytest.raises(FileNotFoundError, match="weights_path"):
        _build(tmp_path, sample_video, jax_too=False, model_name="custom")


@pytest.fixture(scope="module")
def vit_b32_checkpoint(tmp_path_factory):
    """A seeded full-width ViT-B/32 checkpoint (577 MB), removed when the
    module's tests are done."""
    path = tmp_path_factory.mktemp("clip") / "vit_b32.pt"
    model = seeded_init_(tc.CLIP(tc.CONFIGS["ViT-B/32"]), 11)
    with torch.no_grad():
        model.logit_scale.fill_(float(np.log(1 / 0.07)))
    torch.save(model.state_dict(), path)
    yield path
    path.unlink(missing_ok=True)


def _compare(jex, tex, video, key_dim):
    want, got = jex.extract(video), tex.extract(video)
    assert set(got) == set(want) == {"clip", "fps", "timestamps_ms"}
    assert got["clip"].shape == want["clip"].shape == key_dim
    np.testing.assert_allclose(got["clip"], want["clip"], atol=1e-2, rtol=0)
    assert got["fps"] == want["fps"]
    np.testing.assert_array_equal(got["timestamps_ms"],
                                  want["timestamps_ms"])


@pytest.mark.parametrize("resize", ["host", "device"])
@pytest.mark.parametrize("ingest", ["uint8", "yuv420"])
def test_extract_vit_b32_matches_jax(tmp_path, sample_video,
                                     vit_b32_checkpoint, resize, ingest):
    jex, tex = _build(tmp_path, sample_video, resize=resize, ingest=ingest,
                      weights_path=str(vit_b32_checkpoint))
    assert tex.resize_mode == jex.resize_mode == resize
    _compare(jex, tex, sample_video, (4, 512))


def test_extract_custom_modified_resnet_matches_jax(tmp_path, params,
                                                    sample_video):
    ckpt = tmp_path / "rn.pt"
    torch.save(_port(params["rn"], "rn").state_dict(), ckpt)
    for resize in ("host", "device"):
        jex, tex = _build(tmp_path / resize, sample_video,
                          model_name="custom", weights_path=str(ckpt),
                          resize=resize)
        assert tex.cfg == tc.CLIPConfig(*TINY["rn"])
        _compare(jex, tex, sample_video, (4, 64))


def test_show_pred_prints_jax_labels(tmp_path, sample_video,
                                     vit_b32_checkpoint, bpe_file):
    texts = ["a photo of a cat", "a photo of washing dishes",
             "numbers 123", "hello, world!", "café naïve", "I'll go"]
    jex, tex = _build(tmp_path, sample_video, show_pred=True,
                      extraction_total=2, pred_texts=texts,
                      bpe_path=str(bpe_file),
                      weights_path=str(vit_b32_checkpoint))
    assert tex.resize_mode == "host"
    out = {}
    for name, ex in (("jax", jex), ("port", tex)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ex.extract(sample_video)
        out[name] = [ln.split("|")[-1] for ln in buf.getvalue().splitlines()]
    assert out["port"] == out["jax"]
    assert sum("Label" in ln for ln in out["port"]) == 2
