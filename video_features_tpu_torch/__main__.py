"""``python -m video_features_tpu_torch feature_type=i3d flow_type=raft ...``"""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
