"""Sequence/context parallelism: ring attention and all-to-all (Ulysses).

Port of ``video_features_tpu/parallel/sequence.py`` on ``torch.distributed``.
Long-sequence attention as a primitive, so that temporal transformers over
thousands of frames (or high frame-token counts) shard across processes
instead of hitting one card's memory:

  - :func:`ring_attention` / :func:`ring_attention_sharded`: blockwise
    attention with the K/V shards rotated around the group by point-to-point
    sends to ``rank + 1`` (``dist.batch_isend_irecv``) and a streaming
    log-sum-exp softmax, so no process ever holds the full (T, T) score
    matrix or the full K/V. Memory per process: O(T/n * T/n) scores, O(T/n)
    K/V.
  - :func:`ulysses_attention` / :func:`ulysses_attention_sharded`:
    all-to-all context parallelism: heads are exchanged for sequence shards
    (``dist.all_to_all_single``), each process runs dense attention for H/n
    heads over the FULL sequence, then the layout is swapped back.
  - :func:`blockwise_attention`: the INTRA-device path, the same streaming
    recurrence over K/V blocks on one device (FlashAttention in plain torch
    ops), O(T * block_size) score memory. CLIP's ``vision_attn=blockwise``
    (``models/clip.py``) runs it.

All take (B, T, H, D) and share one streaming-softmax fold
(:func:`_softmax_fold`, float32 accumulators, -inf guards that keep a fully
masked row finite). The causal mask is built from global positions, so it is
exact across shards. The sharded pair take a process group (``None``: the
default group); without an initialised ``torch.distributed`` the world is
one process, and neither runs a collective then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

_Acc = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Reference single-device attention. (B, T, H, D) -> (B, T, H, D)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _fold_init(b: int, h: int, t: int, d: int,
               device: torch.device) -> _Acc:
    """Fresh streaming-softmax accumulator (o, m, l), float32."""
    return (torch.zeros((b, h, t, d), dtype=torch.float32, device=device),
            torch.full((b, h, t, 1), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.zeros((b, h, t, 1), dtype=torch.float32, device=device))


def _fold_finalize(o: torch.Tensor, l: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Normalise + (B, H, T, D) -> (B, T, H, D) in the caller's dtype."""
    out = o / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(dtype)


def _softmax_fold(q: torch.Tensor, acc: _Acc, ck: torch.Tensor,
                  cv: torch.Tensor, scale: float,
                  valid: Optional[torch.Tensor]) -> _Acc:
    """Fold one K/V block into the streaming-softmax accumulator
    ``(o, m, l)``: unnormalised output, running max, normaliser. ``valid``
    is an optional (tq, tk) bool mask (causal and/or padding); the -inf
    guards keep fully-masked rows finite. Shared by the ring and blockwise
    paths so the delicate numerics live once."""
    o, m, l = acc
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) * scale
    if valid is not None:
        s = s.masked_fill(~valid, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe)
    if valid is not None:
        p = torch.where(torch.isinf(s), 0.0, p)
    alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
    o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", p, cv.float())
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    return o, m_new, l


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device memory-efficient attention (B, T, H, D) -> same.

    A loop over K/V blocks with the streaming log-sum-exp softmax, so peak
    score memory is O(T * block_size) instead of O(T^2). T need not divide
    ``block_size``: the keys are zero-padded and the padding masked."""
    b, t, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    bs = min(block_size, t)
    n_blocks = -(-t // bs)
    pad = n_blocks * bs - t
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(t, device=q.device)
    acc = _fold_init(b, h, t, d, q.device)
    for i in range(n_blocks):
        k_pos = i * bs + torch.arange(bs, device=q.device)
        valid = k_pos[None, :] < t
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        acc = _softmax_fold(q, acc, kp[:, i * bs:(i + 1) * bs],
                            vp[:, i * bs:(i + 1) * bs], scale, valid)
    o, _, l = acc
    return _fold_finalize(o, l, q.dtype)


def _world(group) -> Tuple[int, int]:
    """(size, rank) of ``group``; one process when torch.distributed is not
    initialised."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _rotate(tensors, group, n: int, me: int):
    """Send each tensor to group rank ``me + 1`` and receive its twin from
    ``me - 1``, in one batch of point-to-point ops."""
    nxt = _global_rank(group, (me + 1) % n)
    prv = _global_rank(group, (me - 1) % n)
    tensors = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           group=None, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v are this process's LOCAL (B, T/n, H, D) sequence shards, shard
    ``rank`` of ``group``.

    n - 1 steps each attend the local queries to the K/V shard held now
    (with exact global-position causal masking), fold the block into the
    streaming-softmax accumulator, then rotate the K/V shard to the next
    process; the last held block is folded after the loop, so there is no
    final rotation whose result nobody reads."""
    n, me = _world(group)
    b, t_local, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    q_pos = me * t_local + torch.arange(t_local, device=q.device)

    def fold(acc, ck, cv, src):
        """Fold the K/V shard held now (originally rank ``src``'s)."""
        valid = None
        if causal:
            k_pos = src * t_local + torch.arange(t_local, device=q.device)
            valid = q_pos[:, None] >= k_pos[None, :]
        return _softmax_fold(q, acc, ck, cv, scale, valid)

    acc = _fold_init(b, h, t_local, d, q.device)
    ck, cv = k, v
    for i in range(n - 1):
        acc = fold(acc, ck, cv, (me - i) % n)
        ck, cv = _rotate((ck, cv), group, n, me)
    o, _, l = fold(acc, ck, cv, (me - (n - 1)) % n)
    return _fold_finalize(o, l, q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange the leading axis's n chunks: chunk j goes to group rank j,
    and chunk i of the result came from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _heads_for_sequence(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(B, T/n, H, D) sequence shard -> (B, T, H/n, D) head shard."""
    b, tl, h, d = x.shape
    chunks = x.reshape(b, tl, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _all_to_all(chunks, group)  # (n, B, T/n, H/n, D), by source
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * tl, h // n, d)


def _sequence_for_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """(B, T, H/n, D) head shard -> (B, T/n, H, D) sequence shard."""
    b, t, hl, d = x.shape
    chunks = x.reshape(b, n, t // n, hl, d).permute(1, 0, 2, 3, 4)
    got = _all_to_all(chunks, group)  # (n, B, T/n, H/n, D), by source
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hl, d)


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, group=None,
                              causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all heads<->sequence swap, dense attention on H/n heads x the
    full T, swap back; q/k/v are the LOCAL (B, T/n, H, D) shards. Requires
    H % n == 0."""
    n, _ = _world(group)
    if n == 1:
        return dense_attention(q, k, v, causal=causal, scale=scale)
    if q.shape[2] % n:
        raise ValueError(f"ulysses attention: {q.shape[2]} heads do not "
                         f"divide over {n} processes")
    qg, kg, vg = (_heads_for_sequence(x, n, group) for x in (q, k, v))
    out = dense_attention(qg, kg, vg, causal=causal, scale=scale)
    return _sequence_for_heads(out, n, group)


_BODIES = {"ring": ring_attention_sharded,
           "ulysses": ulysses_attention_sharded}


def _sharded_call(kind: str, group, causal: bool, scale: Optional[float],
                  q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Cut the global (B, T, H, D) inputs into this process's T shard, run
    the sharded body, and gather the shards' outputs on every process."""
    n, me = _world(group)
    t = q.shape[1]
    if t % n:
        raise ValueError(f"{kind} attention: T={t} does not divide over "
                         f"{n} processes")
    tl = t // n
    local = [x[:, me * tl:(me + 1) * tl] for x in (q, k, v)]
    out = _BODIES[kind](*local, group=group, causal=causal, scale=scale)
    if n == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Global-shape entry point: every process passes the same (B, T, H, D)
    inputs, each runs :func:`ring_attention_sharded` on its T shard, and
    every process gets the whole output. T must divide by the group's
    size."""
    return _sharded_call("ring", group, causal, scale, q, k, v)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Global-shape entry point for the all-to-all path. T and H must
    divide by the group's size."""
    return _sharded_call("ulysses", group, causal, scale, q, k, v)
