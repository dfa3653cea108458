"""Device and precision resolution for the port.

``device=auto`` and ``device=cuda[:N]`` run on the card; ``device=cpu`` is
the only way onto the CPU. With no CUDA device and no explicit
``device=cpu`` the port raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

#: ROADMAP.md items that will port the keys this slice rejects
ROADMAP_BF16 = "ROADMAP.md Queue 1 'precision=bfloat16 for the port'"


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


def set_precision(precision: Optional[str]) -> None:
    """``float32`` pins full-f32 matmuls and convolutions: cuDNN defaults to
    TF32 convolutions on Hopper, which keeps ~3 decimal digits and would
    break parity with the JAX reference's ``highest`` precision pin."""
    precision = precision or "float32"
    if precision == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return
    if precision == "bfloat16":
        raise NotImplementedError(
            f"precision=bfloat16 is not ported yet ({ROADMAP_BF16})")
    raise ValueError(f"precision={precision!r}: expected 'float32'")
