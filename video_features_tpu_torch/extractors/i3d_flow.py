"""I3D flow stream: RAFT or PWC flow -> flow quantisation -> 2-channel I3D.

Port of ``video_features_tpu/extractors/i3d_flow.py`` (reference
models/i3d/extract_i3d.py:140-169): flow between consecutive frames of the
resized, uncropped stack. ``flow_type=raft`` edge-pads the stack to /8 and
never unpads, so TensorCenterCrop(224) -> Clamp(-20, 20) -> ToUInt8 crops
the centre of the *padded* field; ``flow_type=pwc`` has no padder (PWCNet
sizes its input inside) and crops the input-resolution field
(extract_i3d.py:154-155). ``ToUInt8`` is ``round(128 + 255/40 * x)`` on
floats (round half to even, as ``jnp.round``): the result can reach 256.0
and stays float, never a uint8 cast (reference models/transforms.py:168-176).
The whole chain stays on the device; only the (G, 1024) features leave it.

``precision=bfloat16``: the flow I3D's weights are cast (``cast_floating_``)
and its input is cast before ScaleTo1_1; RAFT runs ``RAFT(dtype=bfloat16)``
on cast weights; PWC runs ``PWCNet(dtype=bfloat16)`` on its float32 weights
(cast per layer at use, ``models/pwc.py``). The quantised flow is float32
in both modes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models import i3d as i3d_model
from ..models import pwc as pwc_model
from ..models import raft as raft_model
from ..models.common import cast_floating_
from ..weights.store import resolve_params

#: flow-net budget when the device reports no free memory (the CPU)
_FLOW_BUDGET_FALLBACK = 7 * 1024 ** 3
#: seeds of the random init (allow_random_weights=true)
SEED_RAFT = 2
SEED_PWC = 3
SEED_I3D_FLOW = 1
FLOW_TYPES = ("raft", "pwc")


def _crop_quantize(flow: torch.Tensor, crop: int) -> torch.Tensor:
    """TensorCenterCrop (floor rule) -> Clamp(-20, 20) -> ToUInt8 on an
    NHWC flow field; float out, values in [0, 256]."""
    hp, wp = flow.shape[1], flow.shape[2]
    i, j = (hp - crop) // 2, (wp - crop) // 2
    flow = flow[:, i:i + crop, j:j + crop, :].clamp(-20.0, 20.0)
    return torch.round(128.0 + 255.0 / 40.0 * flow)


def _raft_quantized_flow(model: raft_model.RAFT, crop: int,
                         pairs_u8: torch.Tensor) -> torch.Tensor:
    """(B, 2, H, W, 3) uint8 -> (B, crop, crop, 2) quantised flow floats."""
    flow, _ = raft_model.padded_flow(model, pairs_u8.float())
    return _crop_quantize(flow, crop)


def _pwc_quantized_flow(model: pwc_model.PWCNet, crop: int,
                        pairs_u8: torch.Tensor) -> torch.Tensor:
    """PWC twin of :func:`_raft_quantized_flow`: input-resolution flow, no
    padding, so the crop is of the unpadded field."""
    return _crop_quantize(model(pairs_u8[:, 0], pairs_u8[:, 1]), crop)


def pyramid_cells(h8: int, w8: int, levels: int = raft_model.CORR_LEVELS
                  ) -> int:
    """Cells per query of the unpadded pyramid of a /8 grid (h8, w8), each
    level floor-halved (the odd-drop pool of build_corr_pyramid)."""
    cells = 0
    for _ in range(levels):
        cells += h8 * w8
        h8, w8 = h8 // 2, w8 // 2
    return cells


def _flow_budget(device: torch.device) -> int:
    """Bytes one flow forward's dominant allocation may take: 7/16 of the
    free memory of the card (the mesh's first: the JAX package sizes its
    budget per device, and gave the flow net this share of it), or a fixed
    7 GiB off the card."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free * 7 // 16
    return _FLOW_BUDGET_FALLBACK


def _largest_k(per_stack: int, budget: int, cap: int) -> int:
    """The largest power of two <= ``cap`` whose ``k * per_stack`` fits."""
    k = 1
    while k * 2 <= cap and (k * 2) * per_stack <= budget:
        k *= 2
    return k


def _stacks_per_forward(t: int, h: int, w: int, device: torch.device,
                        cap: int = 4) -> int:
    """How many stacks' pair batches share one RAFT forward: the largest
    power of two <= ``cap`` whose float32 pyramids fit the budget. More
    queries per launch amortise per-launch and per-iteration costs."""
    h8, w8 = -(-h // 8), -(-w // 8)  # RAFT pads its inputs to /8
    per_stack = t * (h8 * w8) * 4 * pyramid_cells(h8, w8)
    return _largest_k(per_stack, _flow_budget(device), cap)


def _pwc_stacks_per_forward(t: int, h: int, w: int, device: torch.device,
                            cap: int = 4, bytes_per_el: int = 2) -> int:
    """PWC twin of :func:`_stacks_per_forward`, the JAX package's model of
    PWC's live set: not a pyramid but each pair's decoder activations, about
    70 elements per pixel of the /64-resized input (two extractor pyramids,
    the 1/4-resolution concat stack, the coarser levels), of
    ``bytes_per_el`` bytes: the flow dtype's width, 4 in float32 and 2 in
    bfloat16."""
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    per_stack = t * 70 * hp * wp * bytes_per_el
    return _largest_k(per_stack, _flow_budget(device), cap)


def i3d_forward(model: i3d_model.I3D, batch: torch.Tensor,
                dtype: torch.dtype = torch.float32,
                features: bool = True) -> torch.Tensor:
    """(B, T, 224, 224, C) uint8 rgb or quantised flow in [0, 256] -> cast
    to ``dtype`` -> ScaleTo1_1 (transforms.py:146-149) -> I3D -> float32.
    The scale is a ``dtype`` constant, as JAX rounds its weakly typed
    ``2 / 255`` to the array's dtype."""
    x = batch.to(dtype) * torch.tensor(2.0 / 255.0, dtype=dtype) - 1.0
    return model(x, features=features).float()


def i3d_heads(model: i3d_model.I3D, batch: torch.Tensor, dtype: torch.dtype,
              logits: bool) -> torch.Tensor:
    """The (B, 1024) features of :func:`i3d_forward`; with ``logits`` the
    (B, 400) Kinetics logits of a second forward on the same input
    (``features=False``, show_pred) follow them, (B, 1424)."""
    feats = i3d_forward(model, batch, dtype)
    if not logits:
        return feats
    return torch.cat([feats, i3d_forward(model, batch, dtype,
                                         features=False)], dim=-1)


class FlowStream(nn.Module):
    """RAFT or PWC + quantisation + flow I3D over a device group of stacks;
    a module, so that the data mesh replicates it whole. ``budget_device``
    is the card whose free memory sizes the flow forwards (the mesh's
    first)."""

    def __init__(self, parent, args, budget_device: torch.device) -> None:
        super().__init__()
        raw_sb = args.get("flow_stack_batch", "auto")
        self.stack_batch: Optional[int] = \
            None if raw_sb in (None, "auto") else int(raw_sb)
        if self.stack_batch is not None and self.stack_batch < 1:
            raise ValueError(
                f"flow_stack_batch={self.stack_batch}: need >= 1 or 'auto'")
        self.flow_type = parent.flow_type
        if self.flow_type not in FLOW_TYPES:
            raise NotImplementedError(
                f"flow_type={self.flow_type!r}; reference supports raft/pwc "
                "(extract_i3d.py:151-157)")
        self.crop = parent.central_crop_size
        self.budget_device = budget_device
        self.dtype = parent.dtype
        weights = args.get("flow_model_weights_path")
        #: the flow net: one of the two is set, by ``flow_type``
        self.raft: Optional[raft_model.RAFT] = None
        self.pwc: Optional[pwc_model.PWCNet] = None
        if self.flow_type == "raft":
            raw = args.get("flow_iters")
            iters = raft_model.ITERS if raw is None else int(raw)
            if iters < 1:
                raise ValueError(f"flow_iters={iters}: RAFT needs at least "
                                 "one GRU refinement iteration")
            raft = raft_model.RAFT(iters, args.get("corr_lookup_impl"),
                                   args.get("fuse_convc1"), dtype=self.dtype)
            raft = resolve_params(raft, "raft_sintel", weights,
                                  parent.allow_random, SEED_RAFT)
            self.raft = cast_floating_(raft, self.dtype).eval()
        else:
            # PWC's weights stay float32: its bfloat16 layers cast at use
            pwc = resolve_params(pwc_model.PWCNet(dtype=self.dtype),
                                 "pwc_sintel", weights, parent.allow_random,
                                 SEED_PWC)
            self.pwc = pwc.eval()
        i3d = resolve_params(i3d_model.I3D(400, in_channels=2), "i3d_flow",
                             args.get("flow_weights_path"),
                             parent.allow_random, SEED_I3D_FLOW)
        self.i3d = cast_floating_(i3d, self.dtype).eval()
        #: flow-net forwards run so far (one per chunk of stacks)
        self.forwards = 0

    def quantized_flow(self, group: torch.Tensor) -> torch.Tensor:
        """(G, T+1, H, W, 3) uint8 on the device -> (G, T, crop, crop, 2)
        quantised flow; up to ``k`` stacks' pairs share one flow forward."""
        g, t = group.shape[0], group.shape[1] - 1
        h, w = group.shape[2], group.shape[3]
        if self.stack_batch:
            k = self.stack_batch
        elif self.raft is not None:
            k = _stacks_per_forward(t, h, w, self.budget_device)
        else:
            k = _pwc_stacks_per_forward(t, h, w, self.budget_device,
                                        bytes_per_el=self.dtype.itemsize)
        outs = []
        for i in range(0, g, k):
            chunk = group[i:i + k]
            kc = chunk.shape[0]
            pairs = torch.stack([chunk[:, :-1], chunk[:, 1:]], dim=2)
            pairs = pairs.reshape((kc * t,) + tuple(pairs.shape[2:]))
            if self.raft is not None:
                q = _raft_quantized_flow(self.raft, self.crop, pairs)
            else:
                q = _pwc_quantized_flow(self.pwc, self.crop, pairs)
            self.forwards += 1
            outs.append(q.reshape((kc, t) + tuple(q.shape[1:])))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def forward(self, group: torch.Tensor,
                logits: bool = False) -> torch.Tensor:
        """(G, T+1, H, W, 3) uint8 on the device -> (G, 1024) features,
        with ``logits`` (show_pred) the logits of the same quantised crops
        after them, (G, 1424): the flow net runs once either way."""
        return i3d_heads(self.i3d, self.quantized_flow(group), self.dtype,
                         logits)
