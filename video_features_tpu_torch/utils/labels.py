"""``show_pred``: top-5 class printout against the Kinetics-400 label map
(the port's copy of ``video_features_tpu/utils/labels.py``, reference
utils/utils.py:20-51). The label map ships as package data."""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

KINETICS_CLASS_PATH = Path(__file__).resolve().parent / "K400_label_map.txt"


def load_kinetics_labels() -> List[str]:
    with open(KINETICS_CLASS_PATH) as f:
        return [x.strip() for x in f]


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def show_predictions_on_kinetics(logits: np.ndarray, k: int = 5) -> None:
    """Print per-row top-``k`` ``logit | prob | label`` tables."""
    classes = load_kinetics_labels()
    logits = np.asarray(logits, dtype=np.float32)
    probs = softmax(logits)
    top_idx = np.argsort(-probs, axis=-1)[:, :k]
    for b in range(logits.shape[0]):
        print('  Logits | Prob. | Label ')
        for idx in top_idx[b]:
            print(f'{logits[b, idx]:8.3f} | {probs[b, idx]:.3f} | '
                  f'{classes[idx]}')
        print()
