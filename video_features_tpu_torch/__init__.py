"""PyTorch + CUDA port of ``video_features_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports ``torch`` and
never ``jax``, ``flax`` or anything of ``video_features_tpu``. Public
functions keep the JAX package's layouts (NHWC / NDHWC, lookup coords
``(B, H, W, 2)`` as (x, y)) so the two can be compared like with like;
modules run NCHW / NCDHW internally.

Ported: every family: ``i3d`` (both streams, ``flow_type=pwc`` by default
or ``raft``), the ``raft`` and ``pwc`` flow families, the clip-stack
families ``r21d`` and ``s3d``, the frame-wise families ``resnet`` and
``clip`` and the audio family ``vggish``, each in ``float32`` and
``bfloat16``; and the fault plane (the per-video deadline, the decode
ladder over ``video_decode=inline|process|parallel``, seeded fault
injection). RAFT's correlation lookup runs in hand-written CUDA kernels
(``kernels/csrc/corr_lookup.cu``); every other family is dense layers
through plain torch ops, as it is plain XLA in the JAX package. Entry
point: ``python -m video_features_tpu_torch feature_type=<family> ...``.
"""
