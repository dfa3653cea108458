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

``model_parallel=N`` runs the image tower tensor-parallel over a ``(data,
model)`` mesh of shape ``(n/N, N)`` over the n devices of ``device`` and
``mesh_devices`` (``models/clip.py tensor_parallel``, cut by
``parallel/mesh.py TP_RULES_TRANSFORMER``); N must divide n.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..models import clip as clip_model
from ..models.common import Consts, cast_floating_
from ..ops import host_transforms as ht
from ..ops import preprocess as pp
from ..parallel.mesh import (TP_RULES_TRANSFORMER, DataParallelApply, Mesh,
                             get_mesh, param_specs_by_rules)
from ..utils.labels import load_label_map, show_predictions_on_dataset
from .base import load_weights, read_state_dict, record_weights
from .frame_wise import FrameWiseExtractor

SEED_CLIP = 6


def model_key(model_name: str) -> str:
    """The JAX package's weights key: 'ViT-B/32' -> 'clip_ViT-B-32'."""
    return "clip_" + model_name.replace("/", "-").replace("@", "-")


class ExtractCLIP(FrameWiseExtractor):

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
        weights_path = args.get("weights_path")
        if self.model_name == "custom":
            if not weights_path:
                raise FileNotFoundError(
                    "model_name=custom requires weights_path=<checkpoint>")
        elif self.model_name not in clip_model.CONFIGS:
            raise NotImplementedError(f"Model {self.model_name} not found")
        if weights_path:
            if self.model_name != "custom":
                # custom reads its architecture off the file: the JAX
                # package resolves (and records) no model key for it
                record_weights(model_key(self.model_name), weights_path)
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
                                 model_key(self.model_name))
        self.cfg = cfg
        size = cfg.image_resolution
        if self.ingest == "yuv420" and size % 2:
            raise NotImplementedError(
                f"ingest=yuv420 needs an even input resolution (I420 chroma "
                f"subsampling); {self.model_name} uses {size}")
        mesh = self._clip_mesh(int(args.get("model_parallel") or 1))
        model = model.eval()
        if self.show_pred:
            self._prepare_text(model, args, mesh.data_devices[0])
        self.model = cast_floating_(model, self.dtype)
        net = nn.ModuleDict({"model": self.model, "norm": Consts(
            mean=pp.CLIP_MEAN, std=pp.CLIP_STD)})
        shard = None
        if mesh.shape.get("model", 1) > 1:
            specs = param_specs_by_rules(net, TP_RULES_TRANSFORMER)
            shard = partial(clip_model.tensor_parallel, specs=specs)
            # the rows are cut from this copy, which then stays behind
            net.cpu()
        self.runner = DataParallelApply(self._device_forward, net, mesh,
                                        shard=shard)
        self.resize_spec = (size, "bicubic")
        self.crop_size = size
        self.host_transform = ht.ResizeCropTransform(size, size, "bicubic",
                                                     self.ingest)

    def _clip_mesh(self, mp: int) -> Mesh:
        """The data mesh, or for ``model_parallel`` ``mp`` > 1 a ``(data,
        model)`` mesh of shape ``(n / mp, mp)`` over its n devices (or the
        mesh given to the constructor, whose model axis must be ``mp``)."""
        if mp < 1:
            raise ValueError(f"model_parallel={mp}: need an int >= 1")
        if self._mesh is not None:
            if self._mesh.shape.get("model", 1) != mp:
                raise ValueError(f"model_parallel={mp} against a mesh of "
                                 f"shape {self._mesh.shape}")
            return self._mesh
        flat = self._data_mesh()
        if mp == 1:
            return flat
        n = flat.size
        if n % mp:
            raise ValueError(f"model_parallel={mp} must divide the device "
                             f"count ({n})")
        return get_mesh(devices=flat.devices, axis_names=("data", "model"),
                        shape=(n // mp, mp))

    def _prepare_text(self, model: clip_model.CLIP, args: Config,
                      device: torch.device) -> None:
        """Tokenise the prompts and run the float32 text tower once, on
        ``device``."""
        from ..utils.tokenizer import ClipTokenizer
        texts = args.get("pred_texts")
        self.pred_texts: List[str] = (
            [f"a photo of {x}" for x in load_label_map("kinetics")]
            if texts is None else list(texts))
        tokens = ClipTokenizer(args.get("bpe_path")).tokenize(
            self.pred_texts, context_length=self.cfg.context_length)
        model.to(device)
        with torch.inference_mode():
            self._text_feats = model.encode_text(
                torch.from_numpy(tokens).long().to(device)
            ).cpu().double().numpy()
        self._logit_scale = float(model.logit_scale.detach())

    def backbone_forward(self, net: nn.ModuleDict,
                         x: torch.Tensor) -> torch.Tensor:
        x = (x.float() / 255.0 - net["norm"].mean) / net["norm"].std
        return net["model"].encode_image(x.to(self.dtype)).float()

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        if not self.show_pred:
            return
        v = feats.astype(np.float64)
        t = self._text_feats
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        t = t / np.linalg.norm(t, axis=1, keepdims=True)
        logits = np.exp(self._logit_scale) * v @ t.T
        show_predictions_on_dataset(logits, self.pred_texts)
