"""Output sinks and the idempotent resume contract (port of the parts of
``video_features_tpu/utils/sinks.py`` the CLI runs).

  - file name contract: ``{video_stem}_{key}{ext}`` under the (already
    namespaced) output dir;
  - sinks: ``print`` (max/mean/min summary), ``save_numpy`` (.npy),
    ``save_pickle`` (.pkl), each written atomically (temp file, fsync,
    rename);
  - :func:`is_already_exist`: every key file exists AND loads, so a file
    torn by a killed worker counts as absent and is extracted again.
"""
from __future__ import annotations

import io
import os
import pickle
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

EXTS = {"save_numpy": ".npy", "save_pickle": ".pkl"}


def make_path(output_root: str, video_path: str, output_key: str,
              ext: str) -> str:
    """``{output_root}/{stem}_{key}{ext}`` (reference utils/utils.py:53-57)."""
    return os.path.join(str(output_root),
                        f"{Path(video_path).stem}_{output_key}{ext}")


def _write_bytes_atomic(fpath: str, data: bytes) -> None:
    """Temp file in the target dir, flush + fsync, ``os.replace``; the
    temp file is removed if anything before the rename fails."""
    d = os.path.dirname(fpath) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(fpath) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fpath)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_numpy(fpath: str, value) -> None:
    buf = io.BytesIO()
    np.save(buf, np.asarray(value))
    _write_bytes_atomic(fpath, buf.getvalue())


def write_pickle(fpath: str, value) -> None:
    _write_bytes_atomic(fpath, pickle.dumps(value))


def _load(on_extraction: str, fpath: str) -> None:
    if on_extraction == "save_numpy":
        np.load(fpath)
    else:
        with open(fpath, "rb") as f:
            pickle.load(f)


def is_already_exist(on_extraction: str, output_path: str, video_path: str,
                     output_feat_keys: Sequence[str]) -> bool:
    """True iff every key file exists and loads cleanly (reference
    base_extractor.py:95-127); always False for the ``print`` sink."""
    if on_extraction == "print":
        return False
    if on_extraction not in EXTS:
        raise NotImplementedError(f"on_extraction: {on_extraction}")
    existing = 0
    for key in output_feat_keys:
        fpath = make_path(output_path, video_path, key, EXTS[on_extraction])
        if not os.path.exists(fpath):
            continue
        try:
            _load(on_extraction, fpath)
            existing += 1
        except Exception:
            print(f"Failed to load: {fpath}. Will extract again.")
    if existing == len(output_feat_keys):
        print(f'Features for "{video_path}" already exist in '
              f'"{output_path}" — skipping. Use a different `output_path` '
              "to extract again.")
        return True
    return False


def action_on_extraction(feats_dict: Dict[str, np.ndarray], video_path: str,
                         output_path: str, on_extraction: str) -> None:
    """Dispatch extracted features to the configured sink (reference
    base_extractor.py:55-93)."""
    if on_extraction == "print":
        print(f"\nFeatures for: {video_path}")
        for k, v in feats_dict.items():
            arr = np.asarray(v)
            print(k)
            print(arr)
            if arr.dtype != object and arr.size > 0:
                print(f"max: {arr.max():.8f}; mean: {arr.mean():.8f}; "
                      f"min: {arr.min():.8f}")
            print()
        return
    if on_extraction not in EXTS:
        raise NotImplementedError(f"on_extraction: {on_extraction}")
    os.makedirs(output_path, exist_ok=True)
    writer = write_numpy if on_extraction == "save_numpy" else write_pickle
    for key, value in feats_dict.items():
        if np.asarray(value).size == 0:
            print("Warning: the value is empty for", key, "@", video_path)
        writer(make_path(output_path, video_path, key, EXTS[on_extraction]),
               value)
