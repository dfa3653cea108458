"""RAFT flow extractor (port of ``video_features_tpu/extractors/raft.py``,
reference models/raft/extract_raft.py): sintel/kitti weights, the optional
edge resize, edge padding to /8 (InputPadder 'sintel' mode) before the net
and unpadding after (base_flow_extractor.py:90, 108-114).

``precision=bfloat16`` (the YAML default) runs RAFT's bfloat16 mode with the
weights cast by ``cast_floating_`` (models/raft.py); ``float32`` is the
parity path.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..models import raft as raft_model
from ..models.common import cast_floating_
from ..parallel.mesh import Mesh
from ..weights.store import resolve_params
from .flow import OpticalFlowExtractor
from .i3d_flow import SEED_RAFT


class ExtractRAFT(OpticalFlowExtractor):

    def __init__(self, args: Config, mesh: Optional[Mesh] = None) -> None:
        super().__init__(args, mesh)
        finetuned_on = args.get("finetuned_on", "sintel")
        if finetuned_on not in ("sintel", "kitti"):
            raise NotImplementedError(
                f"finetuned_on={finetuned_on!r}; reference supports "
                "sintel/kitti (extract_raft.py:6-9)")
        raw = args.get("iters")
        iters = raft_model.ITERS if raw is None else int(raw)
        if iters < 1:
            raise ValueError(f"iters={iters}: RAFT needs at least one GRU "
                             "refinement iteration")
        model = raft_model.RAFT(iters, args.get("corr_lookup_impl"),
                                args.get("fuse_convc1"), dtype=self.dtype)
        model = resolve_params(model, f"raft_{finetuned_on}",
                               args.get("weights_path"), self.allow_random,
                               SEED_RAFT)
        self.model = cast_floating_(model, self.dtype).eval()
        self._build_runner()

    def flow(self, model: raft_model.RAFT,
             pairs: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W, 3) uint8 -> (B, H, W, 2) float32: pad to /8, RAFT,
        unpad."""
        flow, ((pt, pb), (pl, pr)) = raft_model.padded_flow(model,
                                                            pairs.float())
        hp, wp = flow.shape[1], flow.shape[2]
        return flow[:, pt:hp - pb, pl:wp - pr, :]
