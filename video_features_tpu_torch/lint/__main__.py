"""``python -m video_features_tpu_torch.lint``: the port's vft-lint."""
from .engine import main

if __name__ == "__main__":
    raise SystemExit(main())
