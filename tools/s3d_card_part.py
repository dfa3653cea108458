"""Where the s3d phase's "card part" goes, on one NVIDIA card.

    python3 tools/s3d_card_part.py      # from the root of a checkout

``chip_smoke.py`` times the card's part of an S3D run (transformed frames
through the windows, the copy, the forward and back) as one number. This
splits it into its steps for the s3d YAML defaults over the phase's 513
seeded frames (8 stacks of 64, one group), float32 and bfloat16: the
window ``np.stack``s, the group ``np.stack``, the pinned copy, the H2D
copy, the forward and back, and ``chip_smoke.card_part`` itself; medians
of five, in ms, as one JSON line. Run it from two checkouts in turns to
compare them on one card: the steps are host work around a fixed device
time, so a gap between runs of one checkout is the host's spread.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from video_features_tpu_torch.device import set_precision  # noqa: E402
from video_features_tpu_torch.extractors.s3d import ExtractS3D  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    set_precision("float32")
    dev = torch.device("cuda")
    frames = list(cs.synthetic_frames(cs.S3D_FRAMES, 31))
    out = {}
    for precision in ("float32", "bfloat16"):
        ex = ExtractS3D(cs.clip_config("s3d", precision=precision))
        wire, _ = cs.wire_frames(ex, frames)
        cs.card_part(ex, wire)  # cuDNN set-up at this shape
        times = {k: [] for k in ("windows", "group", "pin", "h2d",
                                 "forward", "card_part")}
        for _ in range(5):
            t0 = time.perf_counter()
            stacks = [np.stack([f for f, _, _ in wire[i * 64:(i + 1) * 64]])
                      for i in range(len(wire) // 64)]
            t1 = time.perf_counter()
            group = np.stack(stacks)
            t2 = time.perf_counter()
            pinned = torch.from_numpy(group).pin_memory()
            t3 = time.perf_counter()
            on_card = pinned.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            with torch.inference_mode():
                ex._device_forward(on_card).float().cpu()
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            for key, a, b in (("windows", t0, t1), ("group", t1, t2),
                              ("pin", t2, t3), ("h2d", t3, t4),
                              ("forward", t4, t5)):
                times[key].append((b - a) * 1e3)
            times["card_part"].append(cs.card_part(ex, wire) * 1e3)
            del stacks, group, pinned, on_card
        out[precision] = {k: float(np.median(v)) for k, v in times.items()}
        del ex, wire
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
