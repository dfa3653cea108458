"""VGGish (AudioSet audio embeddings) in PyTorch.

Port of ``video_features_tpu/models/vggish.py`` (reference
models/vggish/vggish_src/vggish_slim.py, the harritaylor/torchvggish port of
the TF-Slim original):

  - the conv stack ``[64, M, 128, M, 256, 256, M, 512, 512, M]`` on
    1-channel (96, 64) log-mel patches, 3x3 pad-1 convs with ReLU, 2x2 max
    pools (vggish_slim.py:102-112), on cuDNN through ``F.conv2d``;
  - the flatten before the MLP in NHWC order, the reference's transpose
    for TF compatibility (vggish_slim.py:27-37), so ``embeddings.0``'s rows
    need no permutation between the packages;
  - the embeddings MLP 12288 -> 4096 -> 4096 -> 128, ReLU after every layer
    (vggish_slim.py:19-25);
  - :func:`postprocess`, the optional PCA whitening, clip to [-2, 2] and
    8-bit quantization (vggish_slim.py:40-99), numpy on the host.

The convolutions and dense layers round as flax's ``Conv`` and ``Dense`` do
(``models/common.py``), so bfloat16 follows the JAX package. Module names
are the reference's state-dict keys (``features.{0,3,6,8,11,13}``,
``embeddings.{0,2,4}``), so a torchvggish checkpoint loads with
``load_state_dict(strict=True)``.

Public layout is the JAX one: ``(B, 96, 64, 1)`` log-mel examples in the
working dtype -> ``(B, 128)`` embeddings in that dtype.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from .common import Conv2d, Dense

EMBEDDING_SIZE = 128
_FEATURES = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M")
_EMBEDDINGS = (512 * 4 * 6, 4096, 4096, EMBEDDING_SIZE)


class VGGish(nn.Module):
    """(B, 96, 64, 1) log-mel examples -> (B, 128) embeddings."""

    def __init__(self) -> None:
        super().__init__()
        layers, cin = [], 1
        for v in _FEATURES:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        dense = []
        for cin, cout in zip(_EMBEDDINGS, _EMBEDDINGS[1:]):
            dense += [Dense(cin, cout), nn.ReLU()]
        self.embeddings = nn.Sequential(*dense)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return self.embeddings(x)


def postprocess(embeddings: np.ndarray, pca_eigen_vectors: np.ndarray,
                pca_means: np.ndarray) -> np.ndarray:
    """PCA-whiten and quantize to [0, 255] (Postprocessor.postprocess,
    vggish_slim.py:63-92); ``np.squeeze`` as the reference does, so one
    example gives a (128,) vector."""
    pca = (pca_eigen_vectors @ (embeddings.T - pca_means)).T
    clipped = np.clip(pca, -2.0, 2.0)
    return np.squeeze(np.round((clipped + 2.0) * (255.0 / 4.0)))


def load_pca_params(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(pca_eigen_vectors (128, 128), pca_means (128, 1)) from the
    torchvggish release ``.pth`` (a dict of arrays) or an ``.npz`` twin
    (vggish_postprocess.py:22-91)."""
    if path.endswith(".npz"):
        blob = np.load(path)
    else:
        blob = torch.load(path, map_location="cpu", weights_only=False)
    vectors = np.asarray(blob["pca_eigen_vectors"], dtype=np.float32)
    means = np.asarray(blob["pca_means"], dtype=np.float32).reshape(-1, 1)
    return vectors, means
