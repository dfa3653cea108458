"""VGGish audio extractor (port of ``video_features_tpu/extractors/vggish.py``,
reference models/vggish/extract_vggish.py).

An ``.mp4`` has its audio ripped to wav by ffmpeg (two steps via aac,
``utils/io.py extract_wav_from_mp4``), once per video in a multi-family run
(``parallel/fanout.py SharedDecodeSession.shared_wav``); a ``.wav`` is read
as it is; any other suffix raises. The waveform becomes 0.96 s examples and each batch of
``batch_size`` examples goes through the VGG on the card:

  - ``frontend=host`` (the default): the numpy log-mel frontend on the host
    (``ops/audio.py waveform_to_examples``), (B, 96, 64, 1) examples cast to
    the working dtype on the card;
  - ``frontend=device``: the host only mono-mixes, resamples and slices
    (B, 15600) waveform chunks; the log-mel runs on the card in float32
    (``ops/audio.py logmel_examples``) and is cast afterwards.

Each batch is split over the data mesh (``parallel/mesh.py``
``DataParallelApply``) and comes back through a ``FeatureStream``. The
last batch runs as it is (the JAX mesh pads it to ``batch_size``).
``show_pred`` raises (extract_vggish.py:25-26). Output key: ``[vggish]``,
with no fps or timestamps; 0 examples give ``(0, 128)``. ``postprocess=true``
applies the PCA whitening and quantization from ``pca_weights_path``. The
ripped temp files are removed unless ``keep_tmp_files``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, pca_weights_path
from ..models import vggish as vggish_model
from ..models.common import cast_floating_
from ..ops import audio
from ..parallel import fanout
from ..parallel.mesh import DataParallelApply, Mesh
from ..utils.io import extract_wav_from_mp4
from .base import BaseExtractor, load_weights

SEED_VGGISH = 8
FRONTENDS = ("host", "device")


class ExtractVGGish(BaseExtractor):

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
        if args.get("show_pred"):
            raise NotImplementedError(
                "show_pred is unsupported for vggish "
                "(reference extract_vggish.py:25-26)")
        self.output_feat_keys = [self.feature_type]
        self.batch_size = int(args.get("batch_size") or 32)
        self.keep_tmp_files = bool(args.get("keep_tmp_files", False))
        self.frontend = args.get("frontend") or "host"
        if self.frontend not in FRONTENDS:
            raise NotImplementedError(f"frontend={self.frontend!r}")
        model = load_weights(vggish_model.VGGish(), args.get("weights_path"),
                             self.allow_random, SEED_VGGISH, "vggish")
        self.model = cast_floating_(model, self.dtype).eval()
        self.runner = DataParallelApply(self._device_forward, self.model,
                                        self._data_mesh())
        self._pca = (vggish_model.load_pca_params(pca_weights_path(args))
                     if args.get("postprocess") else None)

    def _device_forward(self, model: vggish_model.VGGish,
                        batch: torch.Tensor) -> torch.Tensor:
        """(B, 96, 64, 1) examples, or (B, 15600) chunks under
        ``frontend=device``, -> (B, 128) float32 embeddings."""
        if self.frontend == "device":
            batch = audio.logmel_examples(batch)
        return model(batch.to(self.dtype)).float()

    def examples(self, data: np.ndarray, rate: int) -> np.ndarray:
        """The frontend's host part: (N, 96, 64, 1) log-mel examples, or
        (N, 15600) waveform chunks under ``frontend=device``."""
        if self.frontend == "device":
            return audio.chunk_waveform(data, rate)
        return audio.waveform_to_examples(data, rate)

    def embed(self, examples: np.ndarray) -> np.ndarray:
        """(N, 128) float32 embeddings of the frontend's host output, in
        batches of ``batch_size``, PCA-postprocessed when asked."""
        stream = self.feature_stream(self.runner)
        for start in range(0, len(examples), self.batch_size):
            stream.submit(examples[start:start + self.batch_size])
        feats = stream.finish()
        out = (np.concatenate(feats) if feats else
               np.zeros((0, vggish_model.EMBEDDING_SIZE), dtype=np.float32))
        if self._pca is not None:
            out = vggish_model.postprocess(out, *self._pca)
        return out

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        ext = Path(video_path).suffix
        wav_path = aac_path = None
        if ext == ".mp4":
            session = fanout.current_session()
            if session is not None:
                # a multi-family run: one rip per video for every audio
                # family; the session removes it when all have finished
                audio_path = session.shared_wav(video_path, self.tmp_path,
                                                extract_wav_from_mp4)
            else:
                wav_path, aac_path = extract_wav_from_mp4(video_path,
                                                          self.tmp_path)
                audio_path = wav_path
        elif ext == ".wav":
            audio_path = video_path
        else:
            raise NotImplementedError(
                f"vggish accepts .mp4 or .wav, got {ext!r} "
                "(reference extract_vggish.py:42-48)")
        try:
            data, rate = audio.read_wav(audio_path)
            return {self.feature_type: self.embed(self.examples(data, rate))}
        finally:
            if not self.keep_tmp_files and wav_path is not None:
                os.remove(wav_path)
                os.remove(aac_path)
