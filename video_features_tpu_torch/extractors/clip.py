"""CLIP frame-wise extractor (port of
``video_features_tpu/extractors/clip.py``, reference
models/clip/extract_clip.py).

Frame features from ``encode_image``. The transform follows the model's own
input resolution R: Resize(R) bicubic on the smaller edge -> CenterCrop(R)
on the host or the card (``frame_wise.py``), then on the card /255, the
CLIP normalisation in float32 and the cast to the working dtype
(extract_clip.py:69-78). ``model_name=custom`` builds the architecture from
the checkpoint at ``weights_path`` (extract_clip.py:55-61). ``show_pred`` is
zero-shot over ``pred_texts`` or the "a photo of {label}" Kinetics-400
prompts: the text tower runs once, from the float32 weights whatever the
``precision``, and the cosine logits are computed in float64 on the host
(extract_clip.py:86-108). Output keys: ``['clip', 'fps', 'timestamps_ms']``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..models import clip as clip_model
from ..models.common import cast_floating_
from ..ops import host_transforms as ht
from ..ops import preprocess as pp
from ..utils.labels import load_label_map, show_predictions_on_dataset
from .base import load_weights, read_state_dict
from .frame_wise import FrameWiseExtractor

SEED_CLIP = 6


class ExtractCLIP(FrameWiseExtractor):

    def __init__(self, args: Config) -> None:
        super().__init__(args)
        weights_path = args.get("weights_path")
        if self.model_name == "custom":
            if not weights_path:
                raise FileNotFoundError(
                    "model_name=custom requires weights_path=<checkpoint>")
        elif self.model_name not in clip_model.CONFIGS:
            raise NotImplementedError(f"Model {self.model_name} not found")
        if weights_path:
            state = clip_model.checkpoint_state(read_state_dict(weights_path))
            cfg = (clip_model.config_from_state_dict(state)
                   if self.model_name == "custom"
                   else clip_model.CONFIGS[self.model_name])
            model = clip_model.CLIP(cfg)
            model.load_state_dict(state, strict=True)
        else:
            cfg = clip_model.CONFIGS[self.model_name]
            model = load_weights(clip_model.CLIP(cfg), None,
                                 self.allow_random, SEED_CLIP,
                                 f"clip {self.model_name}")
        self.cfg = cfg
        size = cfg.image_resolution
        if self.ingest == "yuv420" and size % 2:
            raise NotImplementedError(
                f"ingest=yuv420 needs an even input resolution (I420 chroma "
                f"subsampling); {self.model_name} uses {size}")
        model = model.to(self.device).eval()
        if self.show_pred:
            self._prepare_text(model, args)
        self.model = cast_floating_(model, self.dtype)
        self.mean = torch.from_numpy(pp.CLIP_MEAN).to(self.device)
        self.std = torch.from_numpy(pp.CLIP_STD).to(self.device)
        self.resize_spec = (size, "bicubic")
        self.crop_size = size
        self.host_transform = ht.ResizeCropTransform(size, size, "bicubic",
                                                     self.ingest)

    def _prepare_text(self, model: clip_model.CLIP, args: Config) -> None:
        """Tokenise the prompts and run the float32 text tower once."""
        from ..utils.tokenizer import ClipTokenizer
        texts = args.get("pred_texts")
        self.pred_texts: List[str] = (
            [f"a photo of {x}" for x in load_label_map("kinetics")]
            if texts is None else list(texts))
        tokens = ClipTokenizer(args.get("bpe_path")).tokenize(
            self.pred_texts, context_length=self.cfg.context_length)
        with torch.inference_mode():
            self._text_feats = model.encode_text(
                torch.from_numpy(tokens).long().to(self.device)
            ).cpu().double().numpy()
        self._logit_scale = float(model.logit_scale.detach())

    def backbone_forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x.float() / 255.0 - self.mean) / self.std
        return self.model.encode_image(x.to(self.dtype)).float()

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        if not self.show_pred:
            return
        v = feats.astype(np.float64)
        t = self._text_feats
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        t = t / np.linalg.norm(t, axis=1, keepdims=True)
        logits = np.exp(self._logit_scale) * v @ t.T
        show_predictions_on_dataset(logits, self.pred_texts)
