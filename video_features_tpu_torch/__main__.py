"""``python -m video_features_tpu_torch feature_type=i3d flow_type=raft ...``,
also installed as the ``vft-torch`` command (``pyproject.toml``)."""
import sys
from typing import List, Optional

USAGE = """\
usage: vft-torch feature_type=<family>[,<family>...] [key=value ...]
       vft-torch <subcommand> [arguments]

Extract video features on a CUDA card (device=cpu for the CPU); the keys
are those of video_features_tpu_torch/configs/<family>.yml.

subcommands:
  serve      the spool server (vft-torch-serve)
  gateway    the HTTP gateway in front of a spool (vft-torch-gateway)
  warmup     build and seal the kernels' compile-cache entries
             (vft-torch-warmup)
  parity     seam reports and certify (vft-torch-parity)
  gc         storage accounting and eviction (vft-torch-gc)
  audit      a run tree's invariants (vft-torch-audit)
  loadgen    seeded traffic drills (vft-torch-loadgen)
  compare    two runs' digests, stages and failures
  lint       vft-lint over the port (vft-torch-lint)
"""

#: the subcommands that import neither torch nor the extractors, so each
#: starts in a fraction of a second: (module, its entry point)
LIGHT = {"gc": ("gc", "main"), "audit": ("audit", "main"),
         "loadgen": ("loadgen", "loadgen_main"),
         "compare": ("compare_runs", "main"),
         "lint": ("lint.engine", "main")}


def main(argv: Optional[List[str]] = None) -> int:
    """The console command's entry point: the light subcommands without
    torch, the rest through ``cli.main``. Returns the exit code."""
    import importlib
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] in (["-h"], ["--help"]):
        print(USAGE, end="")
        return 0
    if argv[:1] and argv[0] in LIGHT:
        module, fn = LIGHT[argv[0]]
        entry = getattr(importlib.import_module(f"{__package__}.{module}"),
                        fn)
        return entry(argv[1:]) or 0
    from .cli import main as cli_main
    return cli_main(argv) or 0


if __name__ == "__main__":
    sys.exit(main())
