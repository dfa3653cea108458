"""vft-lint over the port (port of ``video_features_tpu/lint/``): the JAX
package's contract-aware static analysis, pointed at
``video_features_tpu_torch/``. It proves the port's cross-file contracts
(the cache fingerprint's key classes, the config keys against the family
YAMLs, the inject sites against their call sites and ``docs/chaos.md``,
atomic durable writes, metric names, ``*_FIELDS`` against the schema
JSONs, locked globals in threaded modules) from the parsed tree, importing
nothing of the package it reads.

Entry points: ``python -m video_features_tpu_torch.lint`` and
``python -m video_features_tpu_torch lint``.
"""
from .engine import main, run_lint  # noqa: F401
