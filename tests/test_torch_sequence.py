"""The port's ``parallel/sequence.py`` against the JAX package's, on the same
seeded numpy inputs.

- ``dense_attention`` and ``blockwise_attention`` against JAX's over ``(t,
  bs)`` in ``(32, 8), (37, 8), (16, 64)`` (block-divisible, ragged, block
  >= T), causal and not: atol 2e-5.
- The streaming-softmax fold on a block where one row is wholly masked:
  the accumulators equal JAX's and stay finite.
- ``ring_attention`` and ``ulysses_attention`` over a gloo group of four
  spawned CPU processes against JAX's ``dense_attention``, causal and not
  (1e-5), and ring at T=1024 (1e-4); a T that does not divide over the
  group, and for Ulysses an H that does not, raise ``ValueError``.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_features_tpu.parallel import sequence as jseq
from video_features_tpu_torch.parallel import sequence as tseq

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240


def _qkv(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,bs", [(32, 8), (37, 8), (16, 64)])
def test_dense_and_blockwise_match_jax(t, bs, causal):
    q, k, v = _qkv(t + bs, 2, t, 3, 8)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want_dense = np.asarray(jseq.dense_attention(jq, jk, jv, causal=causal))
    want_block = np.asarray(jseq.blockwise_attention(
        jq, jk, jv, block_size=bs, causal=causal))
    got_dense = tseq.dense_attention(tq, tk, tv, causal=causal).numpy()
    got_block = tseq.blockwise_attention(tq, tk, tv, block_size=bs,
                                         causal=causal).numpy()
    assert got_block.shape == want_block.shape == (2, t, 3, 8)
    np.testing.assert_allclose(got_dense, want_dense, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_block, want_block, atol=2e-5, rtol=0)
    # and the recurrence is the dense softmax's
    np.testing.assert_allclose(got_block, got_dense, atol=2e-5, rtol=0)


def test_fold_keeps_a_fully_masked_row_finite():
    """Row 0 of the block sees no valid key: its accumulators stay at the
    initial (0, -inf, 0) in both packages, and the finalised output is 0,
    not NaN."""
    q, k, v = _qkv(3, 1, 4, 2, 8)
    valid = np.ones((4, 4), bool)
    valid[0] = False
    ja = jseq._softmax_fold(jnp.asarray(q), jseq._fold_init(1, 2, 4, 8),
                            jnp.asarray(k), jnp.asarray(v), 0.5,
                            jnp.asarray(valid))
    ta = tseq._softmax_fold(torch.from_numpy(q),
                            tseq._fold_init(1, 2, 4, 8, torch.device("cpu")),
                            torch.from_numpy(k), torch.from_numpy(v), 0.5,
                            torch.from_numpy(valid))
    for got, want in zip(ta, ja):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)
    out = tseq._fold_finalize(ta[0], ta[2], torch.float32).numpy()
    assert np.isfinite(out).all() and not out[0, 0].any()


#: (name, kind, causal, (b, t, h, d), seed, tolerance)
CASES = [(f"{kind}-{'causal' if causal else 'full'}", kind, causal,
          (2, 64, 8, 16), 10 + i, 1e-5)
         for i, (kind, causal) in enumerate(
             (k, c) for k in ("ring", "ulysses") for c in (False, True))]
CASES.append(("ring-long", "ring", False, (1, 1024, 2, 8), 20, 1e-4))

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    from video_features_tpu_torch.parallel import sequence as seq

    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method={init!r}, rank=rank,
                            world_size={world})
    inputs = np.load({inputs!r})
    out = {{}}
    for name, kind, causal in {cases!r}:
        q, k, v = (torch.from_numpy(inputs[name + "_" + x]) for x in "qkv")
        fn = seq.ring_attention if kind == "ring" else seq.ulysses_attention
        out[name] = fn(q, k, v, causal=causal).numpy()
    errors = []
    for fn, shape in ((seq.ring_attention, (1, 66, 4, 8)),
                      (seq.ulysses_attention, (1, 64, 6, 8))):
        x = torch.zeros(shape)
        try:
            fn(x, x, x)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)
    if rank == 0:
        np.savez({result!r}, **out)
    dist.barrier()
    dist.destroy_process_group()
    print("SEQ_WORKER_DONE", rank)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Every case through ``ring_attention`` / ``ulysses_attention`` on a
    gloo group of :data:`WORLD` spawned processes, each with its own copy of
    the global inputs; rank 0's outputs (all ranks gather the same)."""
    tmp = tmp_path_factory.mktemp("sequence")
    inputs = {}
    for name, _, _, shape, seed, _ in CASES:
        for x, arr in zip("qkv", _qkv(seed, *shape)):
            inputs[f"{name}_{x}"] = arr
    np.savez(tmp / "inputs.npz", **inputs)
    script = _WORKER.format(
        repo=str(REPO), init=f"tcp://127.0.0.1:{_free_port()}",
        world=WORLD, inputs=str(tmp / "inputs.npz"),
        result=str(tmp / "result.npz"),
        cases=[(n, k, c) for n, k, c, *_ in CASES])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              stdout=log, stderr=subprocess.STDOUT, env=env)
             for r, log in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
    text = "".join((tmp / f"rank{r}.log").read_text()[-2000:]
                   for r in range(WORLD))
    assert rcs == [0] * WORLD, text
    assert text.count("SEQ_WORKER_DONE") == WORLD, text
    with np.load(tmp / "result.npz") as res:
        yield inputs, {k: res[k] for k in res.files}


@pytest.mark.parametrize("name,kind,causal,shape,seed,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_attention_matches_jax_dense(gloo_runs, name, kind, causal,
                                             shape, seed, tol):
    inputs, got = gloo_runs
    q, k, v = (jnp.asarray(inputs[f"{name}_{x}"]) for x in "qkv")
    want = np.asarray(jseq.dense_attention(q, k, v, causal=causal))
    assert got[name].shape == want.shape == shape
    np.testing.assert_allclose(got[name], want, atol=tol, rtol=tol)


def test_sharded_attention_rejects_shapes_that_do_not_divide(gloo_runs):
    _, got = gloo_runs
    errors = [str(e) for e in got["errors"]]
    assert len(errors) == 2
    assert "T=66" in errors[0] and "4 processes" in errors[0]
    assert "6 heads" in errors[1]


def test_one_process_runs_no_collective():
    """Without an initialised torch.distributed the world is one process:
    ring and Ulysses reduce to attention over the whole input, as JAX's do
    on a one-device mesh."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 12, 2, 4))
    want = tseq.dense_attention(q, k, v, causal=True)
    for fn in (tseq.ring_attention, tseq.ulysses_attention):
        torch.testing.assert_close(fn(q, k, v, causal=True), want,
                                   atol=1e-6, rtol=1e-6)
