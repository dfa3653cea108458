"""The port's native writer (``video_features_tpu_torch/native/``) against
the JAX package's (``tests/test_native.py`` on the port).

- every case of JAX ``tests/test_native.py`` on the port: round trips of
  each dtype and shape, the ``.npy`` suffix, the validator on numpy's
  files, on a truncated file and on garbage, the object-dtype fallback,
  ``is_already_exist`` through the validator, the ``Prefetcher``;
- the two packages' libraries write byte-identical files for every case,
  and the Python path (``VFT_NATIVE=0``) writes the same bytes;
- ``utils/sinks.py write_numpy`` takes the native path when it can and the
  Python path with a digest or an armed inject plan.
"""
import threading
import time

import numpy as np
import pytest

from video_features_tpu import native as jnative
from video_features_tpu_torch import native
from video_features_tpu_torch.utils import inject, sinks
from video_features_tpu_torch.utils.io import Prefetcher

ARRAYS = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.arange(5, dtype=np.int64),
    np.float64(3.25),
    np.zeros((2, 0, 3), dtype=np.float32),
    np.array([[True, False], [False, True]]),
    np.random.default_rng(0).normal(size=(7, 13, 2)).astype(np.float16),
    np.arange(24, dtype=np.uint8).reshape(2, 3, 4)[:, ::2],
    np.random.default_rng(1).normal(size=(64, 1024)).astype(np.float32),
]
IDS = ["f32", "i64", "0d", "empty", "bool", "f16", "strided", "feature"]


@pytest.fixture()
def python_path(monkeypatch):
    """The port's native module with ``VFT_NATIVE=0``: its fallbacks."""
    monkeypatch.setenv("VFT_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    assert not native.available()


def test_builds_into_its_ignored_build_dir():
    assert native.available()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert (native.BUILD_DIR.parent / "vft_native.cpp").exists()


@pytest.mark.parametrize("arr", ARRAYS, ids=IDS)
def test_write_npy_atomic_roundtrip(tmp_path, arr):
    f = str(tmp_path / "x.npy")
    assert native.write_npy_atomic(f, arr)
    back = np.load(f)
    assert back.dtype == np.asanyarray(arr).dtype
    assert back.shape == np.asanyarray(arr).shape
    np.testing.assert_array_equal(back, np.asanyarray(arr))
    assert native.validate_npy(f) is True
    assert not list(tmp_path.glob("*.tmp.*"))


@pytest.mark.parametrize("arr", ARRAYS, ids=IDS)
def test_both_libraries_and_the_python_path_write_the_same_bytes(tmp_path,
                                                                 arr):
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    port, jax, py = (str(tmp_path / f"{n}.npy") for n in ("t", "j", "p"))
    assert native.write_npy_atomic(port, arr)
    assert jnative.write_npy_atomic(jax, arr)
    np.save(py, np.asarray(arr))
    data = open(port, "rb").read()
    assert data == open(jax, "rb").read() == open(py, "rb").read()


@pytest.mark.parametrize("arr", ARRAYS[:3], ids=IDS[:3])
def test_sink_python_path_equals_native(tmp_path, arr, python_path):
    f = str(tmp_path / "p.npy")
    assert sinks.write_numpy(f, arr) is None
    assert not native.write_npy_atomic(str(tmp_path / "n.npy"), arr)
    assert native.validate_npy(f) is None
    assert jnative.write_npy_atomic(str(tmp_path / "j.npy"), arr)
    assert open(f, "rb").read() == open(tmp_path / "j.npy", "rb").read()


def test_write_npy_appends_extension(tmp_path):
    f = str(tmp_path / "noext")
    assert native.write_npy_atomic(f, np.ones(3))
    np.testing.assert_array_equal(np.load(f + ".npy"), np.ones(3))


def test_validate_npy_accepts_numpy_written_files(tmp_path):
    f = str(tmp_path / "np.npy")
    np.save(f, np.arange(10, dtype=np.int32))
    assert native.validate_npy(f) is True


def test_validate_npy_detects_truncation(tmp_path):
    f = str(tmp_path / "t.npy")
    np.save(f, np.arange(1000, dtype=np.float64))
    data = open(f, "rb").read()
    open(f, "wb").write(data[:len(data) // 2])
    assert native.validate_npy(f) is False
    assert jnative.validate_npy(f) is False


def test_validate_npy_rejects_garbage(tmp_path):
    f = str(tmp_path / "g.npy")
    open(f, "wb").write(b"not a numpy file at all")
    assert native.validate_npy(f) is False


def test_object_arrays_fall_back(tmp_path):
    assert not native.write_npy_atomic(
        str(tmp_path / "o.npy"), np.array([{"a": 1}], dtype=object))


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "python"])
def test_is_already_exist_uses_validator(tmp_path, monkeypatch, native_on):
    if not native_on:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_failed", True)
    video = "/some/video.mp4"
    good = sinks.make_path(str(tmp_path), video, "feat", ".npy")
    np.save(good, np.ones((4, 8)))
    assert sinks.is_already_exist("save_numpy", str(tmp_path), video,
                                  ["feat"])
    data = open(good, "rb").read()
    open(good, "wb").write(data[:-5])
    assert not sinks.is_already_exist("save_numpy", str(tmp_path), video,
                                      ["feat"])


def test_write_numpy_routes_like_jax(tmp_path, monkeypatch):
    calls = []
    real = native.write_npy_atomic

    def spy(fpath, value):
        calls.append(fpath)
        return real(fpath, value)

    monkeypatch.setattr(native, "write_npy_atomic", spy)
    arr = np.arange(6, dtype=np.float32)
    assert sinks.write_numpy(str(tmp_path / "a.npy"), arr) is None
    size, digest = sinks.write_numpy(str(tmp_path / "b.npy"), arr,
                                     want_digest=True)
    monkeypatch.delenv("VFT_INJECT", raising=False)
    try:
        inject.arm_for_run("seed=0;sink.rename=drop@n99")
        sinks.write_numpy(str(tmp_path / "c.npy"), arr)
    finally:
        inject.disarm()
    assert calls == [str(tmp_path / "a.npy")]
    files = [open(tmp_path / f"{n}.npy", "rb").read() for n in "abc"]
    assert files[0] == files[1] == files[2] and size == len(files[0])


def test_prefetcher_matches_direct_iteration():
    items = [np.full((4,), i) for i in range(17)]
    got = list(Prefetcher(items, depth=3))
    assert len(got) == 17
    for a, b in zip(got, items):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_propagates_exceptions():
    def gen():
        yield 1
        raise RuntimeError("decode failed")

    it = iter(Prefetcher(gen()))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetcher_exception_with_full_queue_and_slow_consumer():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("decode failed late")

    got = []
    with pytest.raises(RuntimeError, match="decode failed late"):
        for item in Prefetcher(gen(), depth=1):
            time.sleep(0.3)
            got.append(item)
    assert got == [1, 2]


def test_prefetcher_abandoned_consumer_does_not_hang():
    started = threading.Event()

    def gen():
        started.set()
        for i in range(10_000):
            yield i

    it = iter(Prefetcher(gen(), depth=1))
    assert next(it) == 0
    it.close()
    assert started.is_set()
