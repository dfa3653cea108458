"""Device and precision resolution for the port.

``device=auto`` and ``device=cuda[:N]`` run on the card; ``device=cpu`` is
the only way onto the CPU. With no CUDA device and no explicit
``device=cpu`` the port raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

#: families whose ``precision=bfloat16`` mode is ported
BF16_FAMILIES = ("raft", "pwc", "i3d", "r21d", "s3d", "resnet", "clip")


def resolve_device(device: Optional[str]) -> torch.device:
    """Map a user device string to a ``torch.device``.

    ``auto`` (or ``None``) is ``cuda`` (the current card); ``cuda:N`` is that
    card; ``cpu`` is the CPU. Any CUDA request without a CUDA device raises
    ``RuntimeError``."""
    name = "auto" if device is None else str(device).strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto":
        name = "cuda"
    if name != "cuda" and not name.startswith("cuda:"):
        raise ValueError(f"device={device!r}: expected 'auto', 'cuda', "
                         "'cuda:N' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} needs a CUDA device and none is available; "
            "pass device=cpu to run on the CPU")
    dev = torch.device(name)
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(f"device={device!r}: only "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def precision_dtype(precision: Optional[str],
                    feature_type: Optional[str] = None) -> torch.dtype:
    """The working dtype of ``precision`` for ``feature_type``:
    ``float32`` everywhere, ``bfloat16`` for the families whose bfloat16
    mode is ported (``BF16_FAMILIES``); any other family raises
    ``NotImplementedError`` naming the ROADMAP queue that will port it."""
    precision = precision or "float32"
    if precision == "float32":
        return torch.float32
    if precision == "bfloat16":
        if feature_type not in BF16_FAMILIES:
            raise NotImplementedError(
                f"precision=bfloat16 is not ported yet for feature_type="
                f"{feature_type!r} (ROADMAP.md Queue 1); it is for "
                f"{', '.join(BF16_FAMILIES)}")
        return torch.bfloat16
    raise ValueError(f"precision={precision!r}: expected 'float32' or "
                     "'bfloat16'")


def set_precision(precision: Optional[str],
                  feature_type: Optional[str] = None) -> torch.dtype:
    """Validate ``precision`` for ``feature_type`` (:func:`precision_dtype`)
    and pin full-float32 matmuls and convolutions for both modes: cuDNN
    defaults to TF32 convolutions on Hopper, which keeps ~3 decimal digits
    and would break parity with the JAX reference's ``highest`` precision
    pin, and in ``bfloat16`` mode the float32 parts (RAFT's correlation
    pyramid and lookup, PWC's flow heads and upflow, the norm statistics)
    stay full float32 as on the JAX CPU reference. Returns the working
    dtype."""
    dtype = precision_dtype(precision, feature_type)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dtype
