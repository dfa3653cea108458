"""``show_pred``: top-5 class printout against a label map (the port's copy
of ``video_features_tpu/utils/labels.py``, reference utils/utils.py:20-51).
The Kinetics-400 and ImageNet-1k label maps ship as package data."""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

_DATA_DIR = Path(__file__).resolve().parent
KINETICS_CLASS_PATH = _DATA_DIR / "K400_label_map.txt"
IMAGENET_CLASS_PATH = _DATA_DIR / "IN_label_map.txt"


def load_label_map(dataset: Union[str, Sequence[str]]) -> List[str]:
    """The class names of ``kinetics`` or ``imagenet``, or ``dataset``
    itself when it is a list of texts (CLIP's prompts)."""
    if isinstance(dataset, (list, tuple)):
        return list(dataset)
    paths = {"kinetics": KINETICS_CLASS_PATH, "imagenet": IMAGENET_CLASS_PATH}
    if dataset not in paths:
        raise NotImplementedError(f"dataset: {dataset}")
    with open(paths[dataset]) as f:
        return [x.strip() for x in f]


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def show_predictions_on_dataset(logits: np.ndarray,
                                dataset: Union[str, Sequence[str]],
                                k: int = 5) -> None:
    """Print per-row top-``k`` ``logit | prob | label`` tables."""
    classes = load_label_map(dataset)
    logits = np.asarray(logits, dtype=np.float32)
    probs = softmax(logits)
    top_idx = np.argsort(-probs, axis=-1)[:, :k]
    for b in range(logits.shape[0]):
        print('  Logits | Prob. | Label ')
        for idx in top_idx[b]:
            print(f'{logits[b, idx]:8.3f} | {probs[b, idx]:.3f} | '
                  f'{classes[idx]}')
        print()
