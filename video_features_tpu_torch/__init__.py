"""PyTorch + CUDA port of ``video_features_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports ``torch`` and
never ``jax``, ``flax`` or anything of ``video_features_tpu``. Public
functions keep the JAX package's layouts (NHWC / NDHWC, lookup coords
``(B, H, W, 2)`` as (x, y)) so the two can be compared like with like;
modules run NCHW / NCDHW internally.

Ported so far: ``feature_type=i3d`` (both streams, ``flow_type=pwc`` by
default or ``raft``, ``precision=float32`` by default or ``bfloat16``), and
the ``raft`` and ``pwc`` flow families (``precision=bfloat16`` by default, or
``float32``), with RAFT's correlation lookup in hand-written CUDA kernels
(``kernels/csrc/corr_lookup.cu``); PWC's cost volume is plain PyTorch, as it
is plain XLA in the JAX package. Entry point:
``python -m video_features_tpu_torch feature_type=i3d|raft|pwc ...``.
"""
