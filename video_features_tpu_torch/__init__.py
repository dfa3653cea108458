"""PyTorch + CUDA port of ``video_features_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports ``torch`` and
never ``jax``, ``flax`` or anything of ``video_features_tpu``. Public
functions keep the JAX package's layouts (NHWC / NDHWC, lookup coords
``(B, H, W, 2)`` as (x, y)) so the two can be compared like with like;
modules run NCHW / NCDHW internally.

Ported so far: ``feature_type=i3d flow_type=raft`` (both streams,
``precision=float32``) and the ``raft`` flow family (``precision=bfloat16``
by default, or ``float32``), with RAFT's correlation lookup in hand-written
CUDA kernels (``kernels/csrc/corr_lookup.cu``). Entry point:
``python -m video_features_tpu_torch feature_type=i3d flow_type=raft ...`` or
``python -m video_features_tpu_torch feature_type=raft ...``.
"""
