"""CLI: ``python -m video_features_tpu_torch feature_type=i3d key=value ...``
(or ``feature_type=raft``, ``feature_type=pwc``).

The JAX package's dotlist surface: the family's YAML defaults merged under
the ``key=value`` overrides, validated, then each video extracted with
per-video error isolation (a failing video is reported and the run goes
on), writing ``{output_path}/{feature_type}/{stem}_{key}.npy`` under
``save_numpy``.
"""
from __future__ import annotations

import sys
import traceback
from typing import List, Optional

from .config import load_config, parse_dotlist, sanity_check, video_list
from .registry import get_extractor_cls


def main(argv: Optional[List[str]] = None) -> int:
    overrides = parse_dotlist(sys.argv[1:] if argv is None else argv)
    feature_type = overrides.get("feature_type")
    if not feature_type:
        raise ValueError("feature_type=... is required")
    cls = get_extractor_cls(feature_type)
    args = load_config(feature_type, overrides)
    sanity_check(args)
    extractor = cls(args)
    failed = 0
    for path in video_list(args.get("video_paths"),
                           args.get("file_with_video_paths")):
        try:
            extractor._extract(path)
        except KeyboardInterrupt:
            raise
        except Exception:
            failed += 1
            print(f"An error occurred while extracting {path}:")
            traceback.print_exc()
    return 1 if failed else 0
