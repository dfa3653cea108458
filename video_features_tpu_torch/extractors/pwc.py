"""PWC-Net flow extractor (port of ``video_features_tpu/extractors/pwc.py``,
reference models/pwc/extract_pwc.py): the sintel checkpoint, the optional
edge resize (``side_size``, ``resize``); no padder, since ``PWCNet`` resizes
to multiples of 64 inside and scales the flow back (pwc_net.py:267-296).

``precision=bfloat16`` (the YAML default) runs PWC's bfloat16 mode
(``models/pwc.py``): its weights stay float32 and are cast per layer at use,
and the flow tensors, warp coordinates and flow heads stay float32;
``float32`` is the parity path.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..models import pwc as pwc_model
from ..parallel.mesh import Mesh
from ..weights.store import resolve_params
from .flow import OpticalFlowExtractor
from .i3d_flow import SEED_PWC


class ExtractPWC(OpticalFlowExtractor):

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
        model = resolve_params(pwc_model.PWCNet(dtype=self.dtype),
                               "pwc_sintel", args.get("weights_path"),
                               self.allow_random, SEED_PWC)
        self.model = model.eval()
        self._build_runner()

    def flow(self, model: pwc_model.PWCNet,
             pairs: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W, 3) uint8 -> (B, H, W, 2) float32."""
        return model(pairs[:, 0], pairs[:, 1])
