"""``python -m video_features_tpu_torch feature_type=i3d flow_type=raft ...``"""
import sys

if __name__ == "__main__":
    # the storage, drill, compare and lint commands import neither torch
    # nor the extractors, so each starts in a fraction of a second
    if sys.argv[1:2] == ["gc"]:
        from .gc import main as gc_main
        sys.exit(gc_main(sys.argv[2:]))
    if sys.argv[1:2] == ["audit"]:
        from .audit import main as audit_main
        sys.exit(audit_main(sys.argv[2:]))
    if sys.argv[1:2] == ["loadgen"]:
        from .loadgen import loadgen_main
        sys.exit(loadgen_main(sys.argv[2:]))
    if sys.argv[1:2] == ["compare"]:
        from .compare_runs import main as compare_main
        sys.exit(compare_main(sys.argv[2:]))
    if sys.argv[1:2] == ["lint"]:
        from .lint.engine import main as lint_main
        sys.exit(lint_main(sys.argv[2:]))
    from .cli import main
    sys.exit(main())
