"""Clip-window slicing (the port's copy of ``form_slices`` in
``video_features_tpu/utils/lists.py``, reference utils/utils.py:59-68)."""
from __future__ import annotations

from typing import List, Tuple


def form_slices(size: int, stack_size: int,
                step_size: int) -> List[Tuple[int, int]]:
    """Windows ``[i*step, i*step+stack)`` fully inside ``[0, size)``: the
    trailing partial stack is dropped, which shows in the feature counts and
    is part of the output contract."""
    full_stack_num = (size - stack_size) // step_size + 1
    return [(i * step_size, i * step_size + stack_size)
            for i in range(max(full_stack_num, 0))]
