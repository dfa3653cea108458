"""Every outcome of ``ClipPacker`` under every interleaving of its feeders.

    python tools/packer_interleavings.py [--workers 3] [--batch 8] \
        [--contiguous] COUNTS...

Models the packer (``video_features_tpu_torch/parallel/packer.py``) fed as
``chip_smoke.py feed_videos`` feeds it: ``workers`` threads take videos
of COUNTS clips in order; a full group dispatches at once; a closing video
returns once none of its clips is left in the buffer; a keeper handle
holds the packer open until every video has been fed, so the only short
group is the last. It walks every order in which the threads' adds can
land (``--contiguous``: each video's adds together, as under the feed
lock) and prints the outcomes: the number of groups, or ``stall`` when
every thread is closing on a part-filled group while videos wait (without
the keeper, JAX's flush rule would send that group out short mid-run).
CPU only, exhaustive with memoisation.
"""
import argparse
from functools import lru_cache
from typing import Sequence, Set, Tuple, Union

Outcome = Union[int, str]


def outcomes(counts: Sequence[int], workers: int = 3, batch: int = 8,
             contiguous: bool = False) -> Set[Outcome]:
    counts = tuple(counts)

    @lru_cache(maxsize=None)
    def walk(nxt: int, threads: Tuple[Tuple[int, int], ...],
             buf: Tuple[int, ...], groups: int) -> frozenset:
        # a thread is (video, clips left to add); -1 left: closing;
        # video -1: idle
        threads = list(threads)
        moved = True
        while moved:
            moved = False
            for i, (v, left) in enumerate(threads):
                if v < 0 and nxt < len(counts):
                    threads[i] = (nxt, counts[nxt])
                    nxt += 1
                    moved = True
                elif v >= 0 and left == 0:
                    threads[i] = (v, -1)
                    moved = True
                elif v >= 0 and left < 0 and v not in buf:
                    threads[i] = (-1, 0)
                    moved = True
        adding = [i for i, (v, left) in enumerate(threads) if left > 0]
        if not adding:
            if nxt < len(counts):
                return frozenset({"stall"})
            return frozenset({groups + (1 if buf else 0)})
        out: Set[Outcome] = set()
        for i in adding:
            v, left = threads[i]
            steps = left if contiguous else 1
            b, g = buf, groups
            for _ in range(steps):
                b += (v,)
                if len(b) == batch:
                    b, g = (), g + 1
            nxt_threads = list(threads)
            nxt_threads[i] = (v, left - steps)
            out |= walk(nxt, tuple(nxt_threads), b, g)
        return frozenset(out)

    return set(walk(0, tuple((-1, 0) for _ in range(workers)), (), 0))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("counts", type=int, nargs="+")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--contiguous", action="store_true")
    a = ap.parse_args()
    print(sorted(outcomes(a.counts, a.workers, a.batch, a.contiguous),
                 key=str))


if __name__ == "__main__":
    main()
