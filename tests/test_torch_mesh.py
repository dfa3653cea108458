"""The port's mesh, data-parallel runner and result streams
(``video_features_tpu_torch/parallel/mesh.py``) against the JAX package's
(tests/test_mesh.py), on N replicas on the CPU.

- ``local_shard_of_list`` equals JAX's for 1-4 hosts over 50 stems;
  ``mesh_topology`` has JAX's keys;
- ``DataParallelApply`` over 2 and 4 CPU replicas, ragged batches of 1, 3
  and 7 rows, equal to the one-device run, for host arrays and for tensors
  (a chained stage): bit for bit for a row-wise function (JAX's ``b *
  scale + 1``), within 1e-6 for a small conv net (on the CPU a convolution
  or a matmul of another batch size may sum in another order);
- ``FeatureStream``: equal to the synchronous path in submit order with
  ``depth`` below the batch count, ``depth=0`` synchronous, the callback in
  order with its ctx, a runner-less stream fed ``submit_device``;
- CLIP's tensor parallelism over a ``(data=2, model=2)`` CPU mesh: the
  rules table cuts the blocks as JAX's does, each shard holds its slice
  (q, k and v split within each), and the features are within 2e-5 of the
  replicated run for a heads=1 ViT (JAX's own test model), a heads=2 ViT
  and a small RN (the attention-pool head, 4 heads over 3 shards too);
- the kernels' launch counters lose no count under 8 threads.
"""
import sys
import threading

import numpy as np
import pytest
import torch
from torch import nn

from video_features_tpu.parallel import mesh as jmesh
from video_features_tpu_torch.kernels import corr_lookup as tcl
from video_features_tpu_torch.models import clip as tclip
from video_features_tpu_torch.parallel.mesh import (
    TP_RULES_TRANSFORMER, DataParallelApply, FeatureStream, get_mesh,
    local_shard_of_list, mesh_topology, param_specs_by_rules, settle)
from video_features_tpu_torch.weights.bridge import seeded_init_

CPU = torch.device("cpu")


def _net(seed: int = 0) -> nn.Module:
    torch.manual_seed(seed)
    return nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                         nn.Flatten(), nn.Linear(8 * 6 * 6, 5)).eval()


def _apply(net, batch):
    return net(batch.permute(0, 3, 1, 2).float() / 255.0)


class _Affine(nn.Module):
    """JAX's ``b * p["scale"] + 1.0``, with the scale as a parameter."""

    def __init__(self) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(2.0))

    def forward(self, b: torch.Tensor) -> torch.Tensor:
        return b.float() * self.scale + 1.0


def test_local_shard_of_list_equals_jax():
    stems = [f"/data/{chr(97 + i % 26)}_video_{i:03d}.mp4" for i in range(50)]
    for hosts in range(1, 5):
        shards = []
        for host in range(hosts):
            got = local_shard_of_list(stems, host_id=host, num_hosts=hosts)
            assert got == jmesh.local_shard_of_list(stems, host_id=host,
                                                    num_hosts=hosts)
            shards += got
        assert sorted(shards) == sorted(stems)
    # without torch.distributed: rank 0 of 1 takes everything
    assert local_shard_of_list(stems) == stems


def test_mesh_topology_and_shapes():
    assert set(mesh_topology()) == set(jmesh.mesh_topology())
    assert mesh_topology()["process_count"] == 1
    m = get_mesh("cpu")
    assert m.size == 1 and m.data_devices == [CPU]
    m = get_mesh("cpu", n_devices=4, axis_names=("data", "model"),
                 shape=(2, 2))
    assert m.shape == {"data": 2, "model": 2}
    assert [len(r) for r in m.rows] == [2, 2] and len(m.data_devices) == 2
    with pytest.raises(ValueError):
        get_mesh("cpu", n_devices=3, axis_names=("data", "model"),
                 shape=(2, 2))


@pytest.mark.parametrize("n_devices", [2, 4])
@pytest.mark.parametrize("module", ["affine", "conv"])
def test_data_parallel_over_cpu_replicas(n_devices, module):
    rng = np.random.default_rng(0)
    make, fn, atol = {"affine": (_Affine, lambda m, b: m(b), 0.0),
                      "conv": (_net, _apply, 1e-6)}[module]
    one = DataParallelApply(fn, make(), get_mesh("cpu"))
    many = DataParallelApply(fn, make(), get_mesh("cpu",
                                                  n_devices=n_devices))
    assert many.n_devices == n_devices
    assert len({id(r) for r in many.replicas}) == n_devices
    for rows in (1, 3, 7):
        x = rng.integers(0, 256, size=(rows, 6, 6, 3)).astype(np.uint8)
        want = one(x)
        chunks = many.dispatch(x)
        # rows split in order, a device with no row skipped
        assert [len(c) for c in chunks] == [
            len(p) for p in np.array_split(np.arange(rows), n_devices)
            if len(p)]
        np.testing.assert_allclose(many(x), want, rtol=0, atol=atol)
        # a tensor input (a chained stage) splits the same way
        np.testing.assert_allclose(many(torch.from_numpy(x)), want, rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(many(x, n_valid=1), want[:1], rtol=0,
                                   atol=atol)
    assert settle(many.dispatch(x)) == pytest.approx(float(
        want.astype(np.float64).sum()), rel=1e-6)


def test_with_fn_shares_the_replicas():
    runner = DataParallelApply(_apply, _net(), get_mesh("cpu", n_devices=2))
    other = runner.with_fn(lambda net, b: _apply(net, b) * 2)
    assert other.replicas is runner.replicas
    x = np.ones((3, 6, 6, 3), np.uint8)
    np.testing.assert_array_equal(other(x), runner(x) * 2)


def test_feature_stream_matches_sync_path():
    runner = DataParallelApply(_apply, _net(), get_mesh("cpu", n_devices=2))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, size=(n, 6, 6, 3)).astype(np.uint8)
               for n in (8, 8, 5)]  # ragged tail
    stream = runner.stream(depth=2)  # depth < batches: pops mid-loop
    for b in batches:
        stream.submit(b)
        assert len(stream._inflight) <= 2
    got = stream.finish()
    want = [runner(b) for b in batches]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert stream.finish() == []  # drained and reusable
    stream.submit(batches[0], n_valid=4)
    (g,) = stream.finish()
    np.testing.assert_allclose(g, want[0][:4], rtol=0, atol=1e-6)


def test_feature_stream_depth_zero_is_synchronous():
    runner = DataParallelApply(lambda net, b: b + 1.0, nn.Identity(),
                               get_mesh("cpu"))
    stream = runner.stream(depth=0)
    x = np.zeros((2, 2), np.float32)
    stream.submit(x)
    assert len(stream._inflight) == 0  # materialized at once
    np.testing.assert_array_equal(stream.finish()[0], x + 1.0)


def test_feature_stream_callback_fires_in_order_with_ctx():
    runner = DataParallelApply(lambda net, b: b * 2.0, nn.Identity(),
                               get_mesh("cpu", n_devices=2))
    seen = []
    stream = runner.stream(depth=0, callback=lambda feats, ctx: seen.append(
        (feats.shape[0], ctx)))
    stream.submit(np.ones((3, 2), np.float32), ctx="a")
    assert seen == [(3, "a")]  # fired before submit returned
    stream.submit(np.ones((2, 2), np.float32), n_valid=1, ctx="b")
    assert seen == [(3, "a"), (1, "b")]
    assert len(stream.finish()) == 2


def test_feature_stream_submit_device_runnerless():
    runner = DataParallelApply(lambda net, b: b * 3.0, nn.Identity(),
                               get_mesh("cpu", n_devices=2))
    stream = FeatureStream(None, depth=2)
    batches = [np.full((4, 2), i, np.float32) for i in range(5)]
    for b in batches:
        stream.submit_device(runner.dispatch(b), n_valid=3)
        assert len(stream._inflight) <= 2
    got = stream.finish()
    assert [g.shape for g in got] == [(3, 2)] * 5
    for i, g in enumerate(got):  # submit order
        np.testing.assert_array_equal(g, batches[i][:3] * 3.0)


CLIP_CFGS = {
    # JAX's tests/test_mesh.py model: ViT, heads = 64 // 64 = 1
    "vit_heads1": tclip._cfg(128, 32, 2, 64, 16, 64, 2),
    "vit_heads2": tclip._cfg(128, 32, 2, 128, 16, 64, 2),
    # ModifiedResNet, attention-pool heads = 8 * 32 // 64 = 4
    "rn": tclip._cfg(64, 64, (1, 1, 1, 1), 8, None, 64, 1),
}


@pytest.mark.parametrize("name", sorted(CLIP_CFGS))
def test_tensor_parallel_clip_matches_replicated(name):
    cfg = CLIP_CFGS[name]
    model = seeded_init_(tclip.CLIP(cfg), 0).eval()
    specs = param_specs_by_rules(model, TP_RULES_TRANSFORMER)
    blk = "transformer.resblocks.0."
    assert specs[blk + "attn.in_proj_weight"] == "qkv"
    assert specs[blk + "attn.out_proj.weight"] == "row"
    assert blk + "attn.out_proj.bias" not in specs  # replicated
    assert specs[blk + "mlp.c_fc.weight"] == "column"
    assert specs[blk + "mlp.c_proj.weight"] == "row"
    assert "visual.conv1.weight" not in specs
    if not cfg.is_vit:
        assert specs["visual.attnpool.q_proj.weight"] == "column"
        assert specs["visual.attnpool.c_proj.weight"] == "row"

    def fwd(m, x):
        return m.encode_image(x)

    r = cfg.image_resolution
    x = np.random.default_rng(0).normal(size=(5, r, r, 3)).astype(np.float32)
    ref = DataParallelApply(fwd, model, get_mesh("cpu"))(x)
    mesh = get_mesh("cpu", n_devices=4, axis_names=("data", "model"),
                    shape=(2, 2))
    tp = DataParallelApply(fwd, model, mesh, shard=lambda m, devs:
                           tclip.tensor_parallel(m, devs, specs))
    assert len(tp.replicas) == 2
    e = cfg.vision_width
    if cfg.is_vit:
        attn = tp.replicas[0].visual.transformer.resblocks[0].attn
        assert [tuple(s.in_proj_weight.shape) for s in attn.shards] == \
            [(3 * e // 2, e)] * 2
        q_half = model.visual.transformer.resblocks[0].attn.in_proj_weight[
            e // 2:e]  # the second shard's q rows
        assert torch.equal(attn.shards[1].in_proj_weight[:e // 2], q_half)
        mlp = tp.replicas[0].visual.transformer.resblocks[0].mlp
        assert [tuple(s.c_proj_weight.shape) for s in mlp.shards] == \
            [(e, 2 * e)] * 2
    else:
        pool = tp.replicas[1].visual.attnpool
        w = e * 32
        assert [tuple(s.q_weight.shape) for s in pool.shards] == \
            [(w // 2, w)] * 2
        assert [tuple(s.c_weight.shape) for s in pool.shards] == \
            [(cfg.embed_dim, w // 2)] * 2
    np.testing.assert_allclose(tp(x), ref, rtol=0, atol=2e-5)
    # heads that do not divide evenly: q, k, v gathered before attention
    odd = tclip.tensor_parallel(model, [CPU] * 3, specs)
    with torch.inference_mode():
        got = odd.encode_image(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["vit_heads1", "vit_heads2"])
def test_tensor_parallel_clip_runs_blockwise(name):
    """``vision_attn=blockwise`` under ``model_parallel``: each shard's
    ``TPMHA`` takes the tower's implementation and runs blockwise over its
    own heads (or, where the heads do not divide, over the gathered ones),
    as JAX shards its blockwise ``MHA``; the features equal the replicated
    dense tower's."""
    cfg = CLIP_CFGS[name]
    dense = seeded_init_(tclip.CLIP(cfg), 0).eval()
    model = tclip.CLIP(cfg, vision_attn="blockwise").eval()
    model.load_state_dict(dense.state_dict(), strict=True)
    specs = param_specs_by_rules(model, TP_RULES_TRANSFORMER)
    r = cfg.image_resolution
    x = np.random.default_rng(1).normal(size=(5, r, r, 3)).astype(np.float32)
    with torch.inference_mode():
        ref = dense.encode_image(torch.from_numpy(x)).numpy()
    mesh = get_mesh("cpu", n_devices=4, axis_names=("data", "model"),
                    shape=(2, 2))
    tp = DataParallelApply(lambda m, v: m.encode_image(v), model, mesh,
                           shard=lambda m, devs:
                           tclip.tensor_parallel(m, devs, specs))
    attn = tp.replicas[0].visual.transformer.resblocks[0].attn
    assert isinstance(attn, tclip.TPMHA) and attn.attn_impl == "blockwise"
    assert tp.replicas[0].transformer.resblocks[0].attn.attn_impl == "dense"
    np.testing.assert_allclose(tp(x), ref, rtol=0, atol=2e-5)
    odd = tclip.tensor_parallel(model, [CPU] * 3, specs)
    with torch.inference_mode():
        got = odd.encode_image(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_launch_counters_lose_no_count_across_threads():
    wrappers = (tcl.corr_lookup_level_cuda, tcl.corr_lookup_proj_cuda,
                tcl.corr_lookup_packed_cuda)
    before = [w.launches for w in wrappers]
    n_threads, n_bumps = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tcl.count_launch(w) for _ in range(n_bumps) for w in wrappers])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    for w, b in zip(wrappers, before):
        assert w.launches - b == n_threads * n_bumps
        w.launches = b
