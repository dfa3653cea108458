"""Rates of the frame-wise and raft paths through ``extract_frames`` for the
package and ``chip_smoke.py`` under ROOT, one JSON line on stdout.

    python tools/parallel_probe.py ROOT

resnet50 and ViT-B/32 at ``batch_size=1`` (32 frames) and at 64 in float32
and bfloat16 (256 frames), and the raft family in float32 at
``batch_size=32`` and 16 (64 pairs), seeded 240x320 frames, three timed
runs each after one that sets up cuDNN. To compare two trees on one card,
unpack the other (``git archive``) into a git-ignored directory and run
both in turns in one call: ``for r in output/parent . . output/parent; do
python tools/parallel_probe.py $r; done``. Needs a CUDA card.
"""
import json
import sys

root = sys.argv[1]
sys.path.insert(0, root)

import chip_smoke as cs  # noqa: E402
from video_features_tpu_torch.device import set_precision  # noqa: E402
from video_features_tpu_torch.extractors.clip import ExtractCLIP  # noqa
from video_features_tpu_torch.extractors.raft import ExtractRAFT  # noqa
from video_features_tpu_torch.extractors.resnet import ExtractResNet  # noqa


def rates(ex, frames, reps: int = 3):
    ex.extract_frames(iter(frames[:ex.batch_size]), 25.0)
    return [len(frames) / cs.timed(ex, frames)[1] for _ in range(reps)]


def main() -> None:
    set_precision("float32")
    out = {"root": root, "card": cs.card_line()}
    frames = list(cs.synthetic_frames(256, 41))
    for fam, cls in (("resnet", ExtractResNet), ("clip", ExtractCLIP)):
        out[f"{fam}_b1"] = rates(cls(cs.frame_config(fam)), frames[:32])
        for precision in ("float32", "bfloat16"):
            out[f"{fam}_b64_{precision}"] = rates(cls(cs.frame_config(
                fam, batch_size=64, precision=precision)), frames)
    pairs = list(cs.synthetic_frames(65, 21))
    for batch in (32, 16):
        ex = ExtractRAFT(cs.raft_config("output/chip_smoke",
                                        precision="float32",
                                        batch_size=batch))
        out[f"raft_float32_b{batch}"] = [
            (len(pairs) - 1) / s for s in
            [cs.timed(ex, pairs)[1] for _ in range(4)][1:]]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
