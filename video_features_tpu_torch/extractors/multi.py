"""Multi-family driver: the port's per-family extractors over one decode
(port of ``video_features_tpu/extractors/multi.py``).

``feature_type=resnet,clip,r21d`` runs every requested family on each
video with one shared decode pass (``parallel/fanout.py``) instead of N
runs that each decode the video. Each family keeps its own extractor,
config (with per-family overrides such as ``clip.extraction_fps=2``),
namespaced output directory and skip, retry policy and failure journal;
the driver only coordinates. Per video:

  1. **Skip sweep**: families whose outputs already exist are tallied
     ``skipped`` up front; when every family skips, no decoder and no wav
     rip is built.
  2. **Shared session**: the other visual families subscribe to one
     ``FrameBus``; the audio families share one wav rip.
  3. **Per-family threads**: each family runs ``safe_extract`` on its own
     thread (its cache lookup first: a hit returns before the family
     subscribes, so an all-hit video decodes nothing), so the families'
     transforms and forwards run together, and one family's POISON
     failure or quarantine never touches its siblings' outputs.

A retry after a mid-stream failure cannot rejoin the one pass and decodes
privately; the decode ladder is a private-source matter, so
``safe_extract`` runs with ``decode_mode=None`` here.

With a telemetry recorder each (video, family) gets its own span, stamped
with the family and, for a shared stream, ``decode_shared_ms``; a family
skipped by the sweep counts ``vft_cache_bypass_total{family}``; with
``trace=true`` each family's job is a ``family`` span on its thread.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .. import telemetry
from ..config import Config
from ..parallel import fanout
from ..telemetry import NOOP_SPAN, trace
from ..registry import AUDIO_FAMILIES, get_extractor_cls
from ..utils import sinks
from ..utils.faults import FailureJournal, RetryPolicy


class MultiExtractor:
    """N per-family extractors driven through shared-decode sessions."""

    def __init__(self, per_family_args: Dict[str, Config],
                 extractors: Optional[Dict[str, object]] = None) -> None:
        """``extractors`` replaces the extractors built from the configs
        (``chip_smoke.py`` and the tests hand in ones with seeded
        weights)."""
        self.families: List[str] = list(per_family_args)
        self.args = dict(per_family_args)
        self.extractors = dict(extractors) if extractors is not None else {
            f: get_extractor_cls(f)(a) for f, a in per_family_args.items()}
        self.policies = {f: RetryPolicy.from_config(a)
                         for f, a in per_family_args.items()}
        # each family's journal in its own output dir: a quarantine is a
        # verdict on one family
        self.journals = {
            f: (FailureJournal(a.output_path)
                if a.get("on_extraction", "print") != "print" else None)
            for f, a in per_family_args.items()}
        first = next(iter(per_family_args.values()))
        raw_depth = first.get("fanout_depth")
        self.fanout_depth = (fanout.DEFAULT_DEPTH if raw_depth is None
                             else int(raw_depth))
        if self.fanout_depth < 2:
            raise ValueError(
                f"fanout_depth={self.fanout_depth}: need >= 2")
        self.keep_tmp = any(bool(a.get("keep_tmp_files", False))
                            for a in per_family_args.values())
        #: the session of the video run last (its bus's ``decoded`` and its
        #: ``rips`` say what the one decode cost)
        self.last_session: Optional[fanout.SharedDecodeSession] = None

    def run_video(self, video_path: str, failures: Optional[list] = None,
                  recorder=None) -> Dict[str, str]:
        """One video through every family: ``{family: status}`` in
        ``safe_extract``'s words; each terminal failure record, with its
        ``family``, is appended to ``failures``; ``recorder`` (a
        ``telemetry/recorder.py TelemetryRecorder``) gets one span per
        family."""
        statuses: Dict[str, str] = {}
        pending: List[str] = []
        for f in self.families:
            ext = self.extractors[f]
            # the filename skip only: cache lookups run inside each
            # family's _extract, where a hit returns before it subscribes
            if sinks.is_already_exist(ext.on_extraction, ext.output_path,
                                      video_path, ext.output_feat_keys):
                telemetry.inc("vft_cache_bypass_total", family=str(f))
                statuses[f] = "skipped"
                if recorder is not None:
                    with recorder.video_span(video_path,
                                             feature_type=f) as span:
                        span.annotate(status="skipped")
            else:
                pending.append(f)
        if not pending:
            return statuses

        visual = [f for f in pending if f not in AUDIO_FAMILIES]
        session = fanout.SharedDecodeSession(video_path, visual,
                                             depth=self.fanout_depth)
        self.last_session = session

        def family_job(f: str) -> None:
            ext = self.extractors[f]
            span_cm = (recorder.video_span(video_path, feature_type=f)
                       if recorder is not None else NOOP_SPAN)
            try:
                with fanout.use_session(session), \
                        trace.span("family", family=f,
                                   video=str(video_path)), \
                        span_cm as span:
                    statuses[f] = sinks.safe_extract(
                        ext._extract, video_path, policy=self.policies[f],
                        journal=self.journals.get(f), decode_mode=None,
                        on_terminal_failure=(
                            None if failures is None else
                            lambda rec: failures.append(
                                {**rec, "family": f})))
                    span.annotate(status=statuses[f])
                    ms = session.shared_ms(f)
                    if ms is not None:
                        span.annotate(decode_shared_ms=ms)
            except BaseException:
                # safe_extract re-raises only interpreter exits; on a
                # thread they end this family alone
                statuses.setdefault(f, "error")
                raise
            finally:
                # opens the barrier for a family that never subscribed
                # (a cache hit, a skip on re-check, a quarantine)
                session.family_done(f)

        threads = [threading.Thread(target=family_job, args=(f,),
                                    name=f"vft-family-{f}", daemon=True)
                   for f in pending]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            session.cleanup(keep_tmp=self.keep_tmp)
        for f in pending:  # a thread that died abnormally left no status
            statuses.setdefault(f, "error")
        return statuses
