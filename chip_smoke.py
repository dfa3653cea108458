"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

What it does, failing (exit code != 0, no result line) at the first phase
that goes wrong:

1. prints the card's ``nvidia-smi --query-gpu=name,power.limit`` line;
2. builds the CUDA kernels from ``video_features_tpu_torch/kernels/csrc``
   and prints each kernel's registers, shared memory and spills from the
   compiler's ``-Xptxas -v`` report; then prints the card's practical
   bf16 and read rates (``telemetry/roofline.py measure_peak``) beside the
   peak registry's entry for the card;
3. holds level (max abs error 1e-5), proj (1e-4) and packed (1e-5) against
   their plain versions on small ragged cases, whose query counts fill no
   whole tile: 3 pairs on a 7x11 grid (Q = 231), odd level sizes, whole
   windows outside the plane, a pyramid that pools to 1x1 and 0x0, and NaN,
   +-inf and +-1e30 coords (NaN in the same places, :func:`max_abs_err`);
4. for each kernel, at the shapes its path gives it, holds the kernel
   against its plain PyTorch version on the card and times the kernel, the
   plain version and one library call of the same function
   (``F.grid_sample`` as the reference formulates the lookup, over the
   unpacked levels, plus ``torch.matmul`` for proj; no library call reads
   the packed layout); beside proj, ``torch.matmul`` of its shapes alone:
   - the i3d slice's shapes (one 64-frame stack of 240x320 frames resized
     to 256x341 and padded to 256x344: a 32x43 grid, Q = 64 * 1376 =
     88,064 queries): level (max abs error 1e-5), proj (1e-4), packed
     (1e-5);
   - the raft family's shapes (32 pairs of 240x320 frames: a 30x40 grid,
     Q = 32 * 1200 = 38,400 queries): packed (1e-5), and proj (1e-4) with
     convc1's weight and bias rounded to bfloat16 and upcast, as the
     family's bfloat16 default feeds it;
   pyramids from seeded random fmaps;
5. holds RAFT with the kernels (fused, unfused, packed) against RAFT with
   the plain gather lookup on a small input, float32 (flow atol 1e-3 px);
6. drives the i3d slice, ``ExtractI3D(...).extract_frames(...)`` with
   ``flow_type=raft``, both streams, 20 GRU iterations, float32, seeded
   random weights and one stack per RAFT forward, over 129 seeded synthetic
   240x320 frames (two 64-frame stacks), with every launch count set to 0
   just before and read just after: the fused lookup + convc1 kernel must
   have run 20 times per RAFT forward. Then the same with
   ``fuse_convc1=false``: the level kernel must have run 20 times per
   forward (one launch per call, all four levels), and the features must
   match the fused run's (atol 1e-2, the value tier). One profiled run of
   the fused path over one stack (device time by kernel, the card's busy
   share). Last, the fused extractor's RAFT switched
   to ``corr_lookup_impl=packed``, counts set to 0 just before and read just
   after: the packed kernel 20 times per forward, proj and level none, the
   features within 1e-2 of the fused run's;
7. drives the raft family, ``ExtractRAFT(...).extract_frames(...)``, at the
   YAML defaults (``precision=bfloat16``, 20 iterations,
   ``corr_lookup_impl=null``) with ``batch_size=32``, over 65 seeded
   synthetic 240x320 frames (64 flows, two RAFT forwards), counts set to 0
   just before and read just after: proj 20 launches per forward, level and
   packed none; the flows ``(64, 2, 240, 320)`` and finite; the timestamps
   those of frames 0..64. Then the same with ``corr_lookup_impl=packed``:
   packed 20 launches per forward, proj none, and the flows within
   median 0.1 px and p99 1.0 px of the default path's (the JAX package's
   own bfloat16 bound: the fused kernel projects in float32, the packed
   path runs convc1 in bfloat16). Pairs/s of both in turns (D P), and
   one profiled run of the default path;
8. drives the pwc family, ``ExtractPWC(...).extract_frames(...)``, at the
   YAML defaults (``precision=bfloat16``) with ``batch_size=32``, over 65
   seeded synthetic 240x320 frames (64 flows, two PWC forwards): the flows
   ``(64, 2, 240, 320)`` and finite, the timestamps those of frames 0..64,
   no lookup kernel launched; then the same in ``float32``, the bfloat16
   flows within the JAX package's bfloat16 band of the float32 ones
   (cosine >= 0.98, max abs <= 2.0 px, ``telemetry/parity.py``). Pairs/s of
   both in turns (B F), one profiled run of the default path, with the
   device time of the cost volume and the warp read off profiler ranges;
9. drives I3D with PWC flow, ``ExtractI3D(...).extract_frames(...)`` at the
   i3d YAML defaults (``flow_type=pwc``, both streams, float32,
   ``flow_stack_batch=auto``) with ``clip_batch_size=2`` and
   ``resize=device``, over the slice's 129 frames (two 64-frame stacks at
   256x341, so PWC works at 256x384): features ``(2, 1024)`` per stream and
   finite, no lookup kernel launched; then ``precision=bfloat16``, its
   features within the head band of the float32 run's (cosine >= 0.99,
   max abs <= 0.5). Stacks/s of both in turns (F B), one profiled run
   of each (cost volume and warp ranges as above). Then ``flow_type=raft precision=bfloat16`` once,
   counts set to 0 just before and read just after: proj 20 launches per
   RAFT forward, its features in the same band against the slice's fused
   float32 run. Last, the plain cost volume alone (CUDA events) at the five
   decoder levels' shapes of one stack's 64 pairs, in float32 and
   bfloat16, its sum per stack and its share of the profiled run's device
   time;
10. drives R(2+1)D, ``ExtractR21D(...).extract_frames(...)`` at the r21d
   YAML defaults (``r2plus1d_18_16_kinetics``, stack = step = 16,
   ``clip_batch_size=8``, float32 with the float32 wire), over 257 seeded
   synthetic 240x320 frames through the port's ``R21DTransform`` (16 clips
   of 112x112 in two full groups): features ``(16, 512)`` and finite, the
   windows those of ``form_slices(257, 16, 16)``, no lookup kernel
   launched; then ``precision=bfloat16`` (the uint8 wire), its features
   within the head band of the float32 run's (cosine >= 0.99, max abs <=
   0.5); then ``ingest=yuv420`` once (float32): ``yuv420_packed_to_rgb`` on
   the card against its CPU result on frames packed by the port's numpy
   I420 encoder (max abs error 1e-4), and the features in the same band;
   then ``r2plus1d_34_8_ig65m_ft_kinetics`` once on 16 frames (2 clips of
   8): shape and finite values. Clips/s of the whole ``extract_frames``
   run of each dtype, the host transform's ms per frame, clips/s of the
   card's part (the transformed frames through the clip windows, the
   copy, the forward and back) in turns (F B), and one profiled
   ``extract_frames`` run of each dtype;
11. drives S3D, ``ExtractS3D(...).extract_frames(...)`` at the s3d YAML
   defaults (stack = step = 64, ``clip_batch_size=8``, float32), over 513
   seeded synthetic 240x320 frames at 25 fps through ``S3DTransform`` (8
   stacks of 224x224 in one full group): features ``(8, 1024)`` and
   finite, the windows those of ``form_slices(513, 64, 64)``, no lookup
   kernel launched; then ``precision=bfloat16``, within the head band.
   Stacks/s as for R(2+1)D;
12. drives ResNet, ``ExtractResNet(...).extract_frames(...)`` at the
   resnet YAML defaults (``resnet50``, ``batch_size=1``, float32) with
   ``resize=device``, over 32 seeded synthetic 240x320 frames; then
   ``batch_size=64`` in float32 and bfloat16 over 256 frames, then
   ``resize=host`` (PIL on the host), ``ingest=yuv420`` (I420 planes
   converted on the card) and ``resnet18`` once beside. Every run: the
   features ``(N, 2048)`` (``(N, 512)`` for resnet18) and finite, the
   timestamps those of frames 0..N-1, no lookup kernel launched (counts set
   to 0 just before and read just after). Bfloat16 within the head band
   of float32, batch 1 and ``resize=host`` within the value tier (max abs
   1e-2) of batch 64 with ``resize=device``, yuv420 against uint8 cosine
   >= 0.99. Frames/s of float32 and bfloat16 in turns (F B), FLOPs per
   frame (``torch.utils.flop_counter`` on meta tensors), one profiled run
   of each and of batch 1 (busy share, top device items, launches per
   batch);
13. drives CLIP the same way, ``ExtractCLIP`` at the clip YAML defaults
   (``ViT-B/32``, 512-d, bicubic to 224), with ``RN50`` (1024-d, the
   ModifiedResNet and its attention pool) once beside;
14. drives VGGish, ``ExtractVGGish(...).extract(path)`` on a seeded 600 s
   16 kHz mono WAV (625 examples, 600.015 s), at the vggish YAML defaults
   (``frontend=host``, float32, ``batch_size=32``), with
   ``frontend=device`` (the log-mel on the card: cuFFT and a float32
   matmul), and both in bfloat16; then a 20 s 44.1 kHz stereo WAV once
   (mono mix, ``resample_poly``). Every run: (N, 128) finite embeddings,
   no lookup kernel launched (counts set to 0 just before and read just
   after). The device frontend within 1e-3 of the host one in float32,
   the card's ``logmel_examples`` on the first batch within 1e-4 of the
   numpy frontend, bfloat16 within the head band of float32. Examples/s of
   each run and in turns, the host frontend's ms per example, FLOPs per
   example and the device TFLOP/s they imply, one profile of each float32
   frontend (busy share, top device items, launches per batch);
15. drives the parallel plane (every phase above already runs through
   ``DataParallelApply`` on a one-card mesh and a ``FeatureStream`` of
   depth 4) on two devices: two cards where the machine has them, else two
   replicas on ``cuda:0``. (a) The raft family in float32 with
   ``batch_size=32`` over 65 frames on the two devices: flows within 1e-3
   px of one device, proj 20 launches per forward on each replica (forward
   hooks), level and packed none. (b) r21d at its YAML defaults with
   ``cross_video_batching=true``: 6 seeded videos of 40, 56, ..., 120
   frames (27 clips) through ``extract_frames`` on 3 threads
   (:func:`feed_videos`): per-video features within 1e-4 of the unpacked
   run, groups [8, 8, 8, 3]. (c) CLIP ViT-B/32 with ``model_parallel=2``
   over a ``(data=1, model=2)`` mesh, 64 frames, float32,
   ``resize=device``: within 1e-4 of ``model_parallel=1``, each shard's
   ``in_proj_weight`` (1152, 768). (d) r21d ``extract_frames`` at stream
   depth 4 against 0: identical features, clips/s and the card's busy
   share of each. Rates of both sides of each in turns;
16. drives the multi-family run (:func:`multi_phase`) on the
   vendored ``tests/assets/v_synth_sample.mp4`` (320x240, 19.62 fps, 355
   frames): ``MultiExtractor`` over one shared decode with i3d two-stream
   ``flow_type=raft`` at its YAML defaults, r21d and vggish at theirs,
   resnet50 and ViT-B/32 at ``batch_size=64``, float32, seeded weights;
   vggish's rip is a seeded WAV writer (the sample has no audio track).
   Each family's outputs against its single-family run on the same
   extractors (max abs 1e-4), proj's launches equal in the shared and the
   single i3d run (counts set to 0 just before each and read just after),
   the frames the bus decoded below the private sources' sum; then two
   shared passes with ``cache=true`` into a fresh cache and fresh outputs:
   the second serves every family from the store with no frame decoded,
   no rip and no proj launch, bit-equal to the first. Shared and single
   runs (the singles once more, warm) and one profiled shared run;
17. drives the main path through the CLI with the run plane off and on
   (:func:`telemetry_phase`): ``cli.main`` on i3d two-stream
   ``flow_type=raft`` at the slice's widths (20 iterations, float32,
   ``flow_stack_batch=1``, ``clip_batch_size=2``, ``resize=device``,
   seeded weights) over the vendored sample decoded at 7.3 fps (132
   frames: two 64-frame stacks), once with every run-plane key off and
   once with ``telemetry=true trace=true health=true profile=true
   roofline=true parity=true profile_trace_dir=...``, counts set to 0 just
   before each and read just after; once more with those keys but no
   capture, so the capture's cost shows apart; and once with those keys
   over the sample and a copy of it ("repeat"), whose second dispatch at
   the same shape runs without the roofline's counting pass; every on run
   with ``history=true alerts=true`` too. Held: the
   features of every video equal bit for bit (max abs 0.0);
   proj 20 launches per stack in every run; the one ``_telemetry.jsonl`` span valid
   under the port's schema, ``done``, with ``decode``, ``h2d``, ``forward``
   and ``write`` all > 0; a final ``_heartbeat_*.json`` and a ``_run.json``
   whose topology names the card; one valid ``_health.jsonl`` record per
   output key with no NaN or Inf; a ``_trace.json`` that parses, with the
   required fields of every event and the load-bearing spans; the
   ``torch.profiler`` Chrome trace with the proj kernel among its device
   events; the profile summary printed; in each on run a ``_roofline.json``
   valid under the port's schema naming the card from the peak registry,
   its FLOPs at least the proj launches' declared operations at the
   slice's shapes, ``0 < mfu <= 1``, effective TFLOPS at most the peak and
   one of the four verdicts, and in the repeat run the one uncounted
   dispatch timed of two; ``_parity.jsonl`` records at the ``decode``,
   ``transform`` and ``head`` seams, each valid, and none at ``backbone``
   (as in JAX, the i3d path's RAFT flow stays on the card; the raft
   family's backbone seam is the certify phase's); the heartbeat's
   ``roofline`` and ``parity`` sections and the manifest's roofline
   filled; in each on run (:func:`check_alert_plane`) one
   ``_history_*.jsonl`` of ``vft.history_sample/1`` samples whose last is
   the final heartbeat's (its ``mfu`` the heartbeat's roofline MFU), the
   heartbeat's ``alerts`` section with no rule failure, both heartbeat
   hooks registered and none failed, and no firing record but
   ``mfu_regression``'s, which is printed as a finding, not failed. The
   walls, each stage's total, the roofline documents and the counting
   pass's cost (the capture_off window less the repeat run's);
18. drives the alerting on the main path (:func:`alerts_phase`): the same
   CLI over one 64-frame stack of the sample (4 fps) with ``telemetry
   trace roofline history alerts``, ``metrics_interval_s=0.3``,
   ``retry_attempts=1`` and ``inject=seed=0;sink.fsync=enospc@n1`` (an
   ENOSPC at the first feature write, after the stack's RAFT forward).
   Held: proj 20 launches; exactly one ``failure_spike`` record in the
   ``firing`` state, valid under ``alert.schema.json``; its bundle passes
   ``verify_incident``, holds the failure journal and a ``roofline.json``
   naming the card; the retained history ends with the failure; a later
   ``telemetry/alerts.py main([dir, "--window", "0.05"])`` resolves it and
   no alert is current after. Then the cost: the run plane without and
   with ``history=true alerts=true`` in turns (off, on) at
   ``metrics_interval_s=0.3`` and at the default, each run's features
   bit-equal to the first and proj 20 launches per stack, each on run held
   as in step 17, each off run without history or journal; then one
   evaluation of every rule over a clean on run's tree (``observe_root``
   and ``AlertEngine.evaluate``, what each heartbeat tick runs), the median
   of 20;
19. the fleet step (:func:`fleet_step`) over the telemetry and alerts
   phases' roots: ``fleet_report.aggregate`` finds every current host
   ``FINISHED``, i3d throughput from the spans and the roofline roll-up
   naming the card; ``build_prom_dump`` through ``prometheus_text``
   parses; ``stitch`` writes one trace with a lane per host trace and the
   ``video_attempt`` and ``forward`` spans the proj launches ran under; the
   run report (``telemetry/report.py``) renders the fault run, and its
   ``--fail-on-alert`` gate passes after the resolve;
20. certifies each bfloat16 default flip on the card
   (:func:`certify_phase`, ``telemetry/parity.py certify``): ``raft`` and
   ``pwc`` with ``--flip dtype=bf16`` over the vendored sample, reference
   arm float32 and candidate bfloat16 in one process; each verdict valid
   under the port's schema, every seam captured, ``decode`` and
   ``transform`` within their bands; PWC's verdict ``PASS``; RAFT's, whose
   ``PASS`` or ``FAIL`` rests on the random weight draw, held at
   ``backbone`` and ``head`` to its band's cosine and 1.5 times its max
   abs (:data:`DRAW_SPREAD`); the verdict, its first drifted seam and the
   per-seam ``max_abs`` and ``cos`` printed;
21. serves the main path through the gateway (:func:`serve_phase`): an
   in-process ``ServeLoop`` on the step-17 slice (i3d two-stream RAFT, 20
   iterations, float32, seeded weights, the sample at 7.3 fps) with
   ``cache=true`` behind a ``GatewayServer`` on ``127.0.0.1`` at an
   ephemeral port, answering three HTTP requests, counts set to 0 just
   before each and read just after: the sample (proj 20 launches per
   stack), a byte-identical copy (a feature-cache hit: no frame decoded,
   no launch, bit-equal outputs) and one whose ``timeout_s`` has passed
   (an ``expired/`` record, never a ``done/`` one). The final ``serve``
   heartbeat ``exited`` with 2 done and the expiry counted once (by the
   server or the gateway); request 1's features bit-equal to ``cli.main``'s
   on the sample. Each request's queue wait, service and round trip;
22. holds the kernel compile cache across processes
   (:func:`compile_cache_phase`): from a fresh store, ``python -m
   video_features_tpu_torch warmup`` of the slice's config builds the
   library once and seals the entry (library and ptxas report); a CLI run
   of the slice on the store joins warm (manifest ``compile_cache``: hits
   >= 1, misses 0, the library untouched); after a byte of the sealed
   library is flipped, the next run drops it (sha mismatch), rebuilds it
   (one miss) and re-seals it, never loading the corrupt one, with the
   features bit-equal to the warm run's. The warmup's and both joins'
   walls. Steps 22 and 23 run at once, each on a thread of its own
   (:func:`concurrent_phases`: both wait on their subprocesses), so the
   walls of each are taken beside the other's load;
23. drains the fleet queue (:func:`fleet_queue_phase`): three copies of the
   sample through the slice's CLI with ``telemetry=true health=true``: a
   static single-host run, one ``fleet=queue`` worker, then two concurrent
   ``fleet=queue`` processes on one root (each video done exactly once, 0
   quarantined, outputs bit-equal to the single-host run's, a ``fleet``
   section in both heartbeats) and a third host joining with
   ``fleet_canary=true``, which passes its canary on the digest band; then
   ``fleet_report.aggregate`` and ``telemetry/alerts.observe_root`` over
   the queue root and step 21's spool (the ``fleet``, ``compile_cache``
   and ``serve`` sections). Both makespans;
24. runs the storage lifecycle over those trees (:func:`storage_phase`,
   :data:`STORAGE_TREES`): ``python -m video_features_tpu_torch gc ROOT
   --dry-run --json`` over the serve spool with its cache, the compile
   store, the fleet queue's root, the telemetry and alerts runs and the
   multi phase's cache, all at once: every plane the phase wrote holds
   bytes, no file changes; a ``usage()`` walk of each timed. Then
   ``cli.main`` on the slice with ``telemetry history alerts gc=true`` and
   a ``gc_quota_gb`` twice the accounted stores' use: a heartbeat ``gc``
   section, the ``vft_gc_used_bytes`` gauge in the manifest's metrics, the
   last history sample's ``gc.used_bytes`` the heartbeat's, features
   bit-equal to step 17's off run, proj 20 launches per stack. Then
   eviction as a recoverable miss: a ``cache=true`` fill and a hit (no
   frame decoded, no launch), a sweep under a one-byte quota journals
   every entry to ``_gc_{host}.jsonl`` and deletes it, and the refill
   decodes and launches proj 20 per stack again, bit-equal to the fill.
   Then the refill's entry and two cold ones, and the ``gc`` command
   SIGKILLed by ``gc.evict=kill@n2``: the port's audit passes on the
   remains with a ``gc-journaled`` note, an un-faulted rerun empties the
   store and the audit passes without it. Then a copy of the compile
   store's entry under a foreign fingerprint, 1,000 s idle: a sweep with
   ``gc_compile_retention_s=60`` in a process attached to the card's
   entry prunes the copy and keeps the entry, and a warm join of the slice
   from the store hits (misses 0; the attach and the kernels' load) with
   features bit-equal. Last ``python -m video_features_tpu_torch audit
   --expect-complete`` over every tree and this phase's own: 0 violations
   each;
25. drives seeded traffic through the gateway (:func:`traffic_phase`):
   for ``scenarios/steady.yml`` and then ``scenarios/burst_shed.yml``,
   each on a fresh spool and cache, an in-process ``ServeLoop`` on step
   21's configuration (``cache=true``) behind a ``GatewayServer`` on
   ``127.0.0.1`` with the drill's tenant table
   (``loadgen.write_tenant_table``), and ``loadgen.DrillRunner`` issuing
   the scenario's offered schedule over HTTP at ``speedup=1``
   (:data:`TRAFFIC_SPEEDUP`: the scenarios' own rates on the wall clock)
   for part of each scenario's ``duration_s`` (:data:`TRAFFIC_DURATION_SCALE`:
   15 s of steady's 30, 10 s of burst_shed's 40)
   over a corpus of the sample with a suffix per item
   (``loadgen.synthesize_corpus``), counts set to 0 just before and read
   just after. Held: the drill's journal byte-identical to ``loadgen
   --dry-run`` of the spec; ``_scenario.json`` valid under the port's
   schema, admitted + rejected + shed + errors = offered, admitted =
   completed + expired; each served item's features bit-equal to step
   21's request 1 (the suffix leaves the decode unchanged); proj 20
   launches a stack on each item's cold request and none on a hit; the
   port's ``audit --expect-complete`` over each tree; steady's verdict
   ``PASS``; burst_shed's beta shed (its ``min_rejected`` objective).
   burst_shed's verdict and objectives, and each drill's p50/p95/p99 wait
   and service and its walls, are printed, not held;
26. runs the chaos matrix on the main path (:func:`chaos_phase`): the
   slice's CLI over two copies of the sample with ``fleet=queue
   telemetry=true health=true cache=true``, once clean and once per seed
   of :data:`CHAOS_PLANS` (``decode.read=eio@n3``, ``sink.fsync=eio@n1``:
   the tier-1 rows of the JAX package's matrix), counts set to 0 just
   before each and read just after. Held for each seed: the port's
   ``audit --expect-complete`` passes, the ``.npy`` bytes equal the clean
   run's, the port's ``compare`` against the clean run gives ``PASS``;
   proj 20 launches a stack of each extraction; ``compare --selftest``
   exits 0;
27. holds blockwise attention (:func:`sequence_phase`):
   ``parallel/sequence.py blockwise_attention`` against ``dense_attention``
   at CLIP ViT-L/14@336px's attention shape (16 frames, 577 tokens, 16
   heads of 64, float32, blocks of 256), causal and not, within atol 2e-5
   and rtol 1e-5 (the JAX package's band), each timed; then ``ExtractCLIP``
   at ``model_name=ViT-L/14@336px`` with seeded weights over 32 synthetic
   frames in batches of 16, once with ``vision_attn=dense`` and once with
   ``blockwise``, counts set to 0 just before each and read just after (no
   lookup kernel): the features within the same band, frames/s and
   ``torch.cuda.max_memory_allocated`` of each. Ring and Ulysses attention
   are not run: on one card their world is one process and runs no
   collective, and a process group here would shard the later phases;
28. drives ``show_pred`` on the flow paths (:func:`show_pred_phase`): the
   i3d slice (fused proj, ``resize=host``) over two stacks with
   ``show_pred=true``, then with it off, then on with RAFT's plain gather
   lookup, counts set to 0 just before each and read just after: the
   features with ``show_pred`` bit-equal to the run without it, proj's
   launches the same in both, ``At stack {n} ({stream} stream)`` printed
   for both streams of each stack, the logits within 5e-4 (the I3D logits
   band of the port against JAX) of the plain lookup's, and the printed
   top-5 equal wherever the plain lookup's top six logits lie further
   apart than twice the measured difference. Then the raft family
   (proj 20 launches per forward) and the pwc family (none) with
   ``show_pred=true`` over 65 and 33 frames, their cv2 window replaced by
   a recorder: one overlay per flow, equal to ``flow_to_image`` of the
   card's flow under its frame, the flow image the frame's shape and
   dtype;
29. runs the trace report over the telemetry phase's on run
   (:func:`trace_report_phase`): ``trace_report.main`` with ``--merge`` of
   that run's ``torch.profiler`` capture prints a ``*-bound`` verdict,
   which ``stage_summary`` gives too, with at least 100 ms of device time
   (the ``forward`` stages, which hold the dispatch's launch); the merged
   file holds every event of both, the host lanes under one pid above the
   capture's integer pids, ``"aligned": false``, and the capture's device
   lanes with the run's 40 proj kernels;
30. kills a queue worker (:func:`worker_kill_phase`): two ``fleet=queue``
   workers of the slice over step 23's copies, the first with
   ``VFT_INJECT=seed=11;worker.kill=kill@n2`` (a SIGKILL at its second
   video), the second started once the first has finished a video, a 2 s
   lease: the first exits by SIGKILL, the second reclaims its lease and
   drains the queue, every video done once, the outputs bit-equal to step
   23's static run, the port's ``audit --expect-complete`` ``PASS``;
31. re-encodes (:func:`reencode_phase`): the slice through the CLI over
   the sample re-encoded to 7.3 fps (``fps_mode=reencode``; the ``ffmpeg``
   backend where it is on ``PATH``, else cv2's ``mp4v`` writer; the line
   names which ran), counts set to 0 just before and read just after: the
   frame count and timestamps those of ``fps_mode=select``'s index map on
   the sample (rtol 1e-6), the features finite, proj 20 launches a stack,
   the temp file removed;
32. resolves weights (:func:`weights_phase`): seeded checkpoints of I3D
   RGB, I3D flow and RAFT written as ``i3d_rgb.pt``, ``i3d_flow.pt`` and
   ``raft-sintel.pth`` into a fresh ``VFT_WEIGHTS_DIR``; the slice through
   the CLI with their explicit paths, then with none (the store finds
   them), ``allow_random_weights=false`` and ``cache=true``: the features
   bit-equal, both cache entries keyed by the weights fingerprint of the
   three files' sha256, proj 20 launches a stack in each; with an empty
   ``VFT_WEIGHTS_DIR`` the run fails with the store's message;
33. writes through the native writer (:func:`native_phase`):
   ``native.available()`` (``g++`` builds ``native/vft_native.cpp`` into
   the git-ignored ``native/_build/``), every ``.npy`` of a slice run
   written by it and byte-equal to ``np.save`` of the same array,
   ``validate_npy`` flags a truncated file, which ``is_already_exist``
   then counts as absent; proj 20 launches a stack;
34. lints the checkout (:func:`lint_phase`): ``python -m
   video_features_tpu_torch lint --json`` exits 0, its counts and wall;
35. decodes in spawned children (:func:`spawned_decode_phase`): for
   ``video_decode=inline``, ``process`` and ``parallel decode_workers=2``,
   the sample at 7.3 fps drained from the source alone (its decode wall,
   spawns included), then the slice through the CLI, counts set to 0 just
   before and read just after, inside a :class:`ChildWatch`: frames and
   features bit-equal to inline's, proj 20 launches a stack, every child
   reaped when the run returns, none holding the card (no ``/dev/nvidia*``
   descriptor, its PID in no ``nvidia-smi --query-compute-apps`` list);
36. walks the decode ladder (:func:`ladder_phase`): the slice with
   ``video_decode=parallel`` and ``seed=0;decode.read=eio@n3`` armed in
   every decode child through ``VFT_INJECT``, with 3 and with 4 attempts:
   both demote ``parallel -> process -> inline``; with 3 the video fails,
   its one journal record ``TRANSIENT`` (the inline rung's injected EIO),
   no ``.npy``; with 4 it is recovered bit-equal to step 35's inline run,
   proj 20 launches a stack; the children reaped, none on the card;
37. holds the deadline watchdog (:func:`deadline_phase`): inline and under
   ``process``, a copy of the sample whose decode stalls (its last read
   blocks until the watchdog's release; its child stopped), then the
   sample, with ``video_deadline_s`` and ``telemetry=true``: one expiry
   counted, the copy journaled ``TRANSIENT`` with a ``DeadlineExceeded``
   and no ``.npy`` of it, the sample bit-equal to step 35's run of it
   alone, proj 20 launches for each stack dispatched;
38. runs several videos at once (:func:`video_workers_phase`): the slice
   with ``telemetry=true roofline=true`` over the sample and three copies
   with ``video_workers`` 1, 2 and ``auto``: every file bit-equal to the
   serial run's, proj 20 launches a stack of every video (160), one
   complete span a video; each run's wall and roofline numbers;
39. prints one JSON line each of the i3d slice's, the raft family's, the
   pwc family's, the i3d PWC phase's, the r21d, s3d, resnet, clip,
   vggish, parallel, multi, telemetry, alerts, fleet, certify, serve,
   compile-cache and fleet-queue phases' numbers, one of the alerting's
   numbers beside the card (:func:`alerts_plane_line`: history samples,
   transitions, the bundle's artifacts and bytes, one tick's evaluation,
   the walls), one of the storage phase's (deletions planned and done and
   their bytes by plane, the walls of a ``usage()`` walk and of a sweep,
   the refill's and the hit's walls, the audit verdicts), one each of the
   traffic, chaos, sequence, show_pred, trace-report, worker-kill,
   reencode, weights, native, lint, spawned-decode, ladder, deadline and
   video-workers steps', one of every phase's wall
   (``phase_walls_s``), one of the kernels' numbers, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and needs no ffmpeg (step 31 uses it where it
is on ``PATH``), and step 33 needs ``g++``: the frames and the WAVs are
synthetic (the WAVs written with the stdlib ``wave`` under
``output/chip_smoke``), the configs are built in code, and the clip-stack
transforms and the I420 encoder are numpy. The multi, telemetry, alerts,
certify, serving, storage, traffic, chaos, worker-kill, reencode, weights
and native phases decode a video, with cv2, and fail without it; the
telemetry, alerts, certify, serving, storage, traffic, chaos,
worker-kill, reencode, weights and native phases and the lint step read
YAML with yaml. The serving, storage, traffic, chaos, worker-kill and
lint phases start
``python -m video_features_tpu_torch`` subprocesses with this checkout on
``PYTHONPATH`` and wait for each (none outlives its phase), and the gateway
binds ``127.0.0.1`` only. PIL is needed by the frame-wise phases'
``resize=host`` runs and the show_pred phase's i3d; scipy by the vggish
phase's resampling. No phase opens a window.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

if __name__ != "__mp_main__":
    # multiprocessing's spawn runs this script again, as ``__mp_main__``,
    # in each decode child of a ``video_decode=process|parallel`` run (steps
    # 35-37); a child runs no phase and needs none of these, with which a
    # process source took 12.4 s to drain on the card's host against 1.1 s
    # without (NVIDIA H100 80GB HBM3, 700.00 W; a child of the CLI entry
    # imports none of them either)
    import numpy as np
    import torch
    import torch.nn.functional as F

    # the port's one copy of each lookup's declared work and of the peaks
    # its bounds are taken against, and of the bfloat16 bands
    from video_features_tpu_torch.kernels.corr_lookup import (
        F32_PEAK_FLOPS, HBM_BYTES_PER_S, kernel_work)
    from video_features_tpu_torch.telemetry import parity

    #: the bfloat16 bands of the port's telemetry/parity.py TOLERANCES (the
    #: JAX package's): PWC flows ("pwc", "backbone"), features ("*",
    #: "head")
    PWC_BF16_COS = parity.tolerance_for("pwc", "backbone")["cos"]
    PWC_BF16_MAX_PX = parity.tolerance_for("pwc", "backbone")["max_abs"]
    HEAD_COS = parity.tolerance_for("*", "head")["cos"]
    HEAD_MAX_ABS = parity.tolerance_for("*", "head")["max_abs"]

STACK = 64
FRAME_H, FRAME_W = 240, 320
GRID_H, GRID_W = 32, 43  # 256x341 resized, padded to 256x344, /8
ITERS = 20
RAFT_BATCH = 32  # raft family pairs per RAFT forward
RAFT_GRID_H, RAFT_GRID_W = FRAME_H // 8, FRAME_W // 8
#: the sleep that keeps the card busy while median_ms queues its calls:
#: about 50 ms at the H100's 1.98 GHz boost clock
QUEUE_AHEAD_CYCLES = 100_000_000
#: the bfloat16 flow bound of the JAX package (tests/test_raft.py)
BF16_MEDIAN_PX, BF16_P99_PX = 0.1, 1.0
PWC_BATCH = 32  # pwc family pairs per PWC forward
#: the clip-stack phases: frames, window (stack = step) and clips per group
R21D_FRAMES, R21D_STACK = 257, 16
S3D_FRAMES, S3D_STACK = 513, 64
CLIP_BATCH = 8
#: the frame-wise phases: frames and batch of the batched runs, and the
#: frames of the run at the YAML default batch_size=1
FRAME_FRAMES, FRAME_BATCH, FRAME_BATCH1_FRAMES = 256, 64, 32
#: the value tier (compare_runs bands): resize=device against resize=host
VALUE_ATOL = 1e-2
#: the vggish phase: examples of 16 kHz mono audio (625: 600.015 s, the
#: last example reading 240 samples past its 0.96 s) and seconds of 44.1
#: kHz stereo; the JAX package's bars (tests/test_vggish.py) for the
#: device frontend against the host one end to end and for the log-mel
#: alone
VGGISH_EXAMPLES, VGGISH_STEREO_SECONDS = 625, 20.0
VGGISH_FRONTEND_ATOL, VGGISH_LOGMEL_ATOL = 1e-3, 1e-4
#: PWC's decoder levels at 256x384 (256x341 frames resized to /64):
#: (level, H, W, C) of the cost volume's inputs
#: the parallel phase: the packed videos' frame counts (2..7 clips of 16
#: frames at r21d's defaults, 27 in all), the threads that feed them, and
#: the frames of the CLIP tensor-parallel run
PACKED_VIDEOS = (40, 56, 72, 88, 104, 120)
PACKED_WORKERS = 3
TP_FRAMES = 64
PWC_LEVELS = ((2, 64, 96, 32), (3, 32, 48, 64), (4, 16, 24, 96),
              (5, 8, 12, 128), (6, 4, 6, 196))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its own
    pair of CUDA events. The card first sleeps while the host queues every
    call, so a call whose host side outlasts its kernels (a wrapper around a
    0.05 ms kernel) is timed by its device work alone, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def grid_sample_lookup(pyramid, coords, radius: int = 4) -> torch.Tensor:
    """The reference's own lookup (corr.py:29-50, bilinear_sampler in
    utils/utils.py:59-73): ``F.grid_sample`` with align_corners=True and
    zeros padding. Timed as the library yardstick only."""
    b, h, w, _ = coords.shape
    q = b * h * w
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        pts = coords.reshape(q, 1, 1, 2) / 2 ** lvl + delta.view(1, 9, 9, 2)
        xg = 2 * pts[..., 0] / (wl - 1) - 1
        yg = 2 * pts[..., 1] / (hl - 1) - 1
        s = F.grid_sample(corr.reshape(q, 1, hl, wl),
                          torch.stack([xg, yg], dim=-1), align_corners=True)
        out.append(s.reshape(b, h, w, -1))
    return torch.cat(out, dim=-1)


def window_cells(shapes, coords, radius: int = 4) -> int:
    """In-plane cells of every query's (2r+2)^2 corner window, summed over
    the levels of ``shapes`` ((Hl, Wl) each): the pyramid bytes this run's
    coords need read."""
    cx = coords[..., 0].reshape(-1).double()
    cy = coords[..., 1].reshape(-1).double()
    n = 2 * radius + 2
    total = 0
    for lvl, (hl, wl) in enumerate(shapes):
        x0 = torch.floor(cx / 2 ** lvl - radius)
        y0 = torch.floor(cy / 2 ** lvl - radius)
        cols = (torch.minimum(x0 + n - 1, torch.tensor(wl - 1.0))
                - torch.clamp(x0, min=0) + 1).clamp(min=0)
        rows = (torch.minimum(y0 + n - 1, torch.tensor(hl - 1.0))
                - torch.clamp(y0, min=0) + 1).clamp(min=0)
        total += int((cols * rows).sum().item())
    return total


def level_shapes(pyramid):
    return [tuple(corr.shape[2:]) for corr in pyramid]


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of ``got`` against ``want`` where ``want`` is not NaN;
    inf unless ``got`` is NaN in exactly the same places (a bare
    ``(got - want).abs().max()`` is NaN as soon as one value is)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    diff = (got - want).abs()[~nan]
    return float(diff.max()) if diff.numel() else 0.0


def seeded_lookup(batch: int, grid_h: int, grid_w: int, seed: int):
    """Seeded random fmaps and coords spread +-12 px around the grid, as a
    RAFT forward of ``batch`` pairs on a (grid_h, grid_w) grid gives the
    lookup, on the CPU: (fmap1, fmap2, coords, the generator)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    f1 = torch.randn((batch, 256, grid_h, grid_w), generator=gen)
    f2 = torch.randn((batch, 256, grid_h, grid_w), generator=gen)
    gy, gx = torch.meshgrid(torch.arange(grid_h, dtype=torch.float32),
                            torch.arange(grid_w, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([gx, gy], -1).expand(batch, grid_h, grid_w, 2) \
        + (torch.rand((batch, grid_h, grid_w, 2), generator=gen) - 0.5) * 24
    return f1, f2, coords.contiguous(), gen


def lookup_inputs(dev, batch: int, grid_h: int, grid_w: int, seed: int):
    """The pyramid and coords of :func:`seeded_lookup` on ``dev``."""
    from video_features_tpu_torch.models.raft import build_corr_pyramid

    f1, f2, coords, gen = seeded_lookup(batch, grid_h, grid_w, seed)
    return build_corr_pyramid(f1.to(dev), f2.to(dev)), coords.to(dev), gen


def packed_row(cl, pyramid, coords) -> dict:
    """The packed kernel against its plain version (and the gather lookup
    of the unpacked levels), timed, with its bound."""
    packed, metas = cl.pack_pyramid(pyramid)
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    got = cl.corr_lookup_packed_cuda(packed, metas, coords)
    want = cl.corr_lookup_packed_ref(packed, metas, coords)
    gather = cl.corr_lookup_gather_ref(pyramid, coords)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    # the gather formulation rounds the bilinear weights at another
    # magnitude (floor(c/2^l + d) against floor(c/2^l - r) + d), a few 1e-6
    # relative, so it is held to the proj kernel's 1e-4
    err_gather = max_abs_err(got, gather)
    if not (err <= 1e-5 and err_gather <= 1e-4):
        raise AssertionError(f"corr_lookup_packed_cuda max abs err {err} "
                             f"(vs gather {err_gather})")
    del want, gather
    b_ms, b_by = bound(*kernel_work(
        "packed", q, window_cells(level_shapes(pyramid), coords)))
    return dict(
        queries=q, max_abs_err=err, max_abs_err_vs_gather=err_gather,
        ms=median_ms(lambda: cl.corr_lookup_packed_cuda(packed, metas,
                                                        coords)),
        plain_ms=median_ms(lambda: cl.corr_lookup_packed_ref(packed, metas,
                                                             coords)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: grid_sample_lookup(pyramid, coords)),
        packed_lanes_per_query=int(packed.shape[1]),
        metas=[list(m) for m in metas])


def proj_row(cl, pyramid, coords, weight, bias) -> dict:
    """The fused lookup + convc1 kernel against its plain version (max abs
    error 1e-4), timed, with its bound; the library call is ``grid_sample``
    and ``matmul``."""
    q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    got = cl.corr_lookup_proj_cuda(pyramid, coords, weight, bias)
    want = cl.corr_lookup_proj_ref(pyramid, coords, weight, bias)
    taps = torch.rand((q, 324), device=coords.device)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not err <= 1e-4:
        raise AssertionError(f"corr_lookup_proj_cuda max abs err {err}")
    del got, want
    b_ms, b_by = bound(*kernel_work(
        "proj", q, window_cells(level_shapes(pyramid), coords)))
    return dict(
        queries=q, max_abs_err=err,
        ms=median_ms(lambda: cl.corr_lookup_proj_cuda(
            pyramid, coords, weight, bias)),
        plain_ms=median_ms(lambda: cl.corr_lookup_proj_ref(
            pyramid, coords, weight, bias)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: torch.relu(torch.matmul(
            grid_sample_lookup(pyramid, coords), weight) + bias)),
        # cuBLAS's float32 product of the same shapes alone: what the
        # kernel's projection part could take at a library GEMM's rate
        matmul_ms=median_ms(lambda: torch.matmul(taps, weight)))


def check_kernels(dev):
    from video_features_tpu_torch.kernels import corr_lookup as cl

    pyramid, coords, gen = lookup_inputs(dev, STACK, GRID_H, GRID_W, 0)
    weight = (torch.randn((324, 256), generator=gen) / 18.0).to(dev)
    bias = (torch.randn((256,), generator=gen) * 0.1).to(dev)
    q = coords.shape[0] * GRID_H * GRID_W

    rows = []
    with torch.inference_mode():
        got = cl.corr_lookup_level_cuda(pyramid, coords)
        want = cl.corr_lookup_gather_ref(pyramid, coords)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if not err <= 1e-5:
            raise AssertionError(f"corr_lookup_level_cuda max abs err {err}")
        b_ms, b_by = bound(*kernel_work(
            "level", q, window_cells(level_shapes(pyramid), coords)))
        rows.append(dict(
            name="corr_lookup_level_cuda", route="cuda",
            source="video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
            replaces="video_features_tpu/kernels/corr_lookup.py:117",
            max_abs_err=err,
            ms=median_ms(lambda: cl.corr_lookup_level_cuda(pyramid, coords)),
            plain_ms=median_ms(
                lambda: cl.corr_lookup_gather_ref(pyramid, coords)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=median_ms(lambda: grid_sample_lookup(pyramid, coords)),
            queries=q))

        proj = dict(
            name="corr_lookup_proj_cuda", route="cuda",
            source="video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
            replaces="video_features_tpu/kernels/corr_lookup.py:380",
            **proj_row(cl, pyramid, coords, weight, bias))
        rows.append(proj)
        del got, want
        at_i3d = packed_row(cl, pyramid, coords)
        del pyramid, coords
        torch.cuda.empty_cache()

        # the packed row is at the raft family's shapes, whose packed path
        # counts its launches; the i3d shapes ride along
        pyramid, coords, _ = lookup_inputs(dev, RAFT_BATCH, RAFT_GRID_H,
                                           RAFT_GRID_W, 1)
        rows.append(dict(
            name="corr_lookup_packed_cuda", route="cuda",
            source="video_features_tpu_torch/kernels/csrc/corr_lookup.cu",
            replaces="video_features_tpu/kernels/corr_lookup.py:612",
            **packed_row(cl, pyramid, coords), at_i3d_shapes=at_i3d))
        # proj on the raft family's default path: its shapes, and convc1's
        # weight and bias rounded to bfloat16 and upcast, as
        # BasicMotionEncoder.convc1_matrix feeds the bfloat16 model's
        proj["at_raft_shapes"] = proj_row(
            cl, pyramid, coords, weight.bfloat16().float(),
            bias.bfloat16().float())
    del pyramid, coords
    torch.cuda.empty_cache()
    return rows


def ragged_inputs(dev, name: str):
    """The small cases of tests/test_torch_corr_lookup.py, with pyramids from
    the port's build_corr_pyramid on numpy-seeded fmaps: ``q231`` (3 pairs
    on a 7x11 grid, Q = 231, no whole 64-query tile), ``odd`` (odd level
    sizes, a level narrower than the 11-cell window), ``outside`` (whole
    windows out of every level), ``degenerate`` (levels of 1x1 and 0x0)
    and ``nonfinite`` (NaN, +-inf and +-1e30 coords)."""
    from video_features_tpu_torch.models.raft import build_corr_pyramid

    rng = np.random.default_rng({"q231": 7, "odd": 3, "outside": 2,
                                 "degenerate": 4, "nonfinite": 8}[name])
    b, h8, w8, c = {"q231": (3, 7, 11, 32), "odd": (2, 13, 11, 32),
                    "outside": (1, 12, 10, 64),
                    "degenerate": (1, 6, 5, 16),
                    "nonfinite": (1, 12, 10, 64)}[name]
    f1, f2 = (torch.from_numpy(rng.normal(size=(b, c, h8, w8)).astype(
        np.float32)).to(dev) for _ in range(2))
    pyramid = build_corr_pyramid(f1, f2)
    if name == "outside":
        gx, gy = np.meshgrid(np.arange(w8, dtype=np.float32),
                             np.arange(h8, dtype=np.float32))
        coords = np.broadcast_to(np.stack([gx, gy], -1),
                                 (b, h8, w8, 2)).copy()
        coords[:, 0] = -50.0
        coords[:, 1, :, 0] = w8 + 40.0
    else:
        coords = rng.uniform(-6.0, max(h8, w8) + 6.0,
                             size=(b, h8, w8, 2)).astype(np.float32)
    if name == "nonfinite":
        coords[0, 0, 0, 0] = np.nan
        coords[0, 0, 1, 1] = np.nan
        coords[0, 1, 2, 0] = np.inf
        coords[0, 2, 3, 1] = -np.inf
        coords[0, 3, 4, 0] = 1e30
        coords[0, 4, 5, 1] = -1e30
    return pyramid, torch.from_numpy(coords).to(dev)


def check_ragged(dev) -> dict:
    """Level (1e-5), proj (1e-4) and packed (1e-5) against their plain
    versions on the ragged cases; the max abs error of each, NaN in the same
    places (the packed lookup's NaN for a non-finite coord)."""
    from video_features_tpu_torch.kernels import corr_lookup as cl

    rng = np.random.default_rng(9)
    weight = torch.from_numpy((rng.normal(size=(324, 256)) * 0.05).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)).to(
        dev)
    errs = {}
    with torch.inference_mode():
        for name in ("q231", "odd", "outside", "degenerate", "nonfinite"):
            pyramid, coords = ragged_inputs(dev, name)
            packed, metas = cl.pack_pyramid(pyramid)
            e = dict(
                queries=coords.shape[0] * coords.shape[1] * coords.shape[2],
                levels=level_shapes(pyramid),
                level=max_abs_err(
                    cl.corr_lookup_level_cuda(pyramid, coords),
                    cl.corr_lookup_gather_ref(pyramid, coords)),
                proj=max_abs_err(
                    cl.corr_lookup_proj_cuda(pyramid, coords, weight, bias),
                    cl.corr_lookup_proj_ref(pyramid, coords, weight, bias)),
                packed=max_abs_err(
                    cl.corr_lookup_packed_cuda(packed, metas, coords),
                    cl.corr_lookup_packed_ref(packed, metas, coords)))
            if not (e["level"] <= 1e-5 and e["proj"] <= 1e-4
                    and e["packed"] <= 1e-5):
                raise AssertionError(f"ragged case {name}: {e}")
            errs[name] = e
    return errs


def check_small_raft(dev):
    """RAFT through the kernels (fused, unfused, packed) vs the plain gather
    lookup, small input, float32."""
    from video_features_tpu_torch.models.raft import RAFT
    from video_features_tpu_torch.weights.bridge import seeded_init_

    gen = torch.Generator().manual_seed(3)
    x1 = (torch.rand((2, 64, 96, 3), generator=gen) * 255).to(dev)
    x2 = (torch.rand((2, 64, 96, 3), generator=gen) * 255).to(dev)
    model = seeded_init_(RAFT(iters=4), 5).to(dev).eval()
    worst = 0.0
    with torch.inference_mode():
        model.corr_lookup_impl = "gather"
        want = model(x1, x2)
        for impl, fuse in ((None, True), (None, False), ("packed", True)):
            model.corr_lookup_impl, model.fuse_convc1 = impl, fuse
            err = float((model(x1, x2) - want).abs().max())
            if not err <= 1e-3:
                raise AssertionError(f"RAFT corr_lookup_impl={impl} "
                                     f"fuse_convc1={fuse} vs gather: max "
                                     f"abs err {err} px")
            worst = max(worst, err)
    return worst


def slice_config(out_dir: str, **over):
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="i3d", streams=None, flow_type="raft",
               flow_iters=ITERS, flow_stack_batch=1, stack_size=STACK,
               step_size=STACK, clip_batch_size=2, resize="device",
               extraction_fps=None, device="cuda", precision="float32",
               allow_random_weights=True, on_extraction="print",
               output_path=out_dir, tmp_path="tmp/chip_smoke",
               corr_lookup_impl=None, fuse_convc1=None)
    cfg.update(over)
    return Config(cfg)


def synthetic_frames(n: int, seed: int):
    """Smooth moving gradients plus seeded noise, uint8 RGB 240x320, at a
    nominal 25 fps: an iterator of ``(frame, timestamp_ms, index)``."""
    return iter(_synthetic_frames(n, seed))


@functools.lru_cache(maxsize=4)
def _synthetic_frames(n: int, seed: int) -> tuple:
    """:func:`synthetic_frames`'s frames, made once for each of the last
    four ``(n, seed)`` (the slice draws its few seeds again and again);
    the arrays are read-only, so no caller changes another's."""
    out = []
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W].astype(np.float32)
    for t in range(n):
        frame = np.stack([
            127 + 100 * np.sin(xx / 23 + t / 5),
            127 + 100 * np.sin(yy / 17 - t / 7),
            127 + 100 * np.sin((xx + yy) / 31 + t / 3)], axis=-1)
        frame += rng.normal(0, 8, frame.shape)
        frame = frame.clip(0, 255).astype(np.uint8)
        frame.flags.writeable = False
        out.append((frame, t / 25 * 1000.0, t))
    return tuple(out)


def annotated(module, names):
    """Wrap each function ``module.<name>`` in a profiler range of that name
    (undone by calling the returned function), so a profile can attribute
    device time to it."""
    saved = {name: getattr(module, name) for name in names}
    for name, fn in saved.items():
        def ranged(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)
        setattr(module, name, ranged)
    return lambda: [setattr(module, n, f) for n, f in saved.items()]


def profile_run(extractor, frames, ranges=None) -> dict:
    """Device time by kernel over one warm ``extract_frames`` run
    (:func:`profile_call`)."""
    return profile_call(lambda: extractor.extract_frames(iter(frames), 25.0),
                        ranges)


def profile_call(run, ranges=None) -> dict:
    """Device time by kernel over one warm call of ``run``
    (torch.profiler), the share of the wall time the card was busy (the
    union of the kernels' intervals, so nothing counts twice), the host's
    top operators by self CPU time, and the device time of each function
    of ``ranges`` (``(module, [names])``, wrapped by :func:`annotated`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    undo = annotated(*ranges) if ranges else None
    synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        if undo:
            undo()
    names = ranges[1] if ranges else []
    # a range also shows on the device as an annotation spanning its
    # kernels (gaps included): not a kernel, so left out of the spans
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.name not in names})
    if not spans:
        return {"device_time": "not measured (no CUDA events traced)",
                "wall_ms": wall_us / 1e3}
    busy_us, end_us = 0.0, float("-inf")
    by_name: dict = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # the host's operators by self CPU time, summed over the events already
    # parsed (key_averages() walks them again and took over 10 s on the
    # slice's trace)
    host_us: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            us, calls = host_us.get(e.key, (0.0, 0))
            host_us[e.key] = (us + e.self_cpu_time_total, calls + 1)
    host = sorted(host_us.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us,
           "kernel_ms_total": sum(v[0] for v in by_name.values()),
           "kernel_launches": sum(v[1] for v in by_name.values()),
           "top_kernels": [{"name": k[:90], "ms": v[0], "calls": v[1]}
                           for k, v in top],
           "top_host_ops": [{"name": k[:60], "self_cpu_ms": us / 1e3,
                             "calls": calls}
                            for k, (us, calls) in host]}
    if ranges:
        # the kernels launched inside each range, summed over its calls
        # (0 where the profiler linked none: then "not measured")
        kernel_us = dict.fromkeys(names, 0.0)
        for e in prof.events():
            if e.name in names and e.device_type == DeviceType.CPU:
                kernel_us[e.name] += e.device_time_total
        out["ranges"] = {
            name: ({"kernel_ms": us / 1e3, "share_of_busy": us / busy_us}
                   if us > 0 else "not measured")
            for name, us in kernel_us.items()}
    return out


def kernel_resources(build) -> dict:
    """Registers, static shared memory and spills of each kernel from the
    built library's ``-Xptxas -v`` report, by short name (``proj_kernel``,
    ``level_kernel``, ``packed_kernel``)."""
    report = build.report_path(build.library_path()).read_text()
    out = {}
    for mangled, res in build.kernel_resources(report).items():
        for short in ("proj_kernel", "level_kernel", "packed_kernel"):
            if short in mangled:
                out[short] = res
    missing = {"proj_kernel", "level_kernel", "packed_kernel"} - set(out)
    if missing:
        raise AssertionError(f"no ptxas report for {sorted(missing)}")
    return out


def reset_counts(cl) -> None:
    cl.corr_lookup_level_cuda.launches = 0
    cl.corr_lookup_proj_cuda.launches = 0
    cl.corr_lookup_packed_cuda.launches = 0


def read_counts(cl) -> dict:
    return {"level": cl.corr_lookup_level_cuda.launches,
            "proj": cl.corr_lookup_proj_cuda.launches,
            "packed": cl.corr_lookup_packed_cuda.launches}


def run_slice(dev):
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    from video_features_tpu_torch.kernels import corr_lookup as cl

    # each extractor runs once before its timed run: the first call at a
    # shape pays cuDNN's algorithm set-up, which is not steady state
    fused = ExtractI3D(slice_config("output/chip_smoke"))
    fused.extract_frames(synthetic_frames(2 * STACK + 1, 7), 25.0)
    fused.flow_stream.forwards = 0
    synthetic_frames(2 * STACK + 1, 11)  # made before the clock starts
    reset_counts(cl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = fused.extract_frames(synthetic_frames(2 * STACK + 1, 11), 25.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fused_counts = read_counts(cl)
    proj_launches = fused_counts["proj"]
    fwd = fused.flow_stream.forwards
    for s in ("rgb", "flow"):
        if feats[s].shape != (2, 1024) or not np.isfinite(feats[s]).all():
            raise AssertionError(f"{s}: shape {feats[s].shape} or non-finite")
    if feats["timestamps_ms"].tolist() != [STACK / 25 * 1000,
                                           2 * STACK / 25 * 1000]:
        raise AssertionError(f"timestamps {feats['timestamps_ms']}")
    if fwd < 1 or fused_counts != {"level": 0, "proj": ITERS * fwd,
                                   "packed": 0}:
        raise AssertionError(f"fused path: launches {fused_counts} for "
                             f"{fwd} RAFT forwards")

    profile = profile_run(fused, list(synthetic_frames(STACK + 1, 13)))
    profile["stacks"] = 1

    unfused = ExtractI3D(slice_config("output/chip_smoke",
                                      fuse_convc1=False))
    unfused.extract_frames(synthetic_frames(STACK + 1, 7), 25.0)
    unfused.flow_stream.forwards = 0
    reset_counts(cl)
    t0 = time.perf_counter()
    one = unfused.extract_frames(synthetic_frames(2 * STACK + 1, 11), 25.0)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    unfused_counts = read_counts(cl)
    level_launches = unfused_counts["level"]
    fwd_u = unfused.flow_stream.forwards
    if fwd_u < 1 or unfused_counts != {"level": ITERS * fwd_u,
                                       "proj": 0, "packed": 0}:
        raise AssertionError(f"unfused path: launches {unfused_counts} for "
                             f"{fwd_u} RAFT forwards")
    diffs = {s: float(np.abs(one[s] - feats[s]).max()) for s in
             ("rgb", "flow")}
    if not max(diffs.values()) <= 1e-2:
        raise AssertionError(f"unfused vs fused features differ: {diffs}")

    # the packed path: RAFT._lookup reads corr_lookup_impl on every forward
    raft = fused.flow_stream.raft
    raft.corr_lookup_impl = "packed"
    fused.flow_stream.forwards = 0
    reset_counts(cl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = fused.extract_frames(synthetic_frames(2 * STACK + 1, 11), 25.0)
    torch.cuda.synchronize()
    packed_s = time.perf_counter() - t0
    raft.corr_lookup_impl = None
    packed_counts = read_counts(cl)
    fwd_p = fused.flow_stream.forwards
    if fwd_p < 1 or packed_counts != {"level": 0, "proj": 0,
                                      "packed": ITERS * fwd_p}:
        raise AssertionError(f"i3d packed path: launches {packed_counts} "
                             f"for {fwd_p} RAFT forwards")
    diffs_p = {s: float(np.abs(packed[s] - feats[s]).max()) for s in
               ("rgb", "flow")}
    if not max(diffs_p.values()) <= 1e-2:
        raise AssertionError(f"packed vs fused features differ: {diffs_p}")
    return dict(stacks=2, seconds=seconds, stacks_per_s=2 / seconds,
                flow_forwards=fwd, proj_launches=proj_launches,
                unfused_stacks_per_s=2 / unfused_s,
                unfused_flow_forwards=fwd_u,
                level_launches=level_launches,
                unfused_vs_fused_max_abs=diffs,
                packed_stacks_per_s=2 / packed_s,
                packed_flow_forwards=fwd_p,
                packed_launches=packed_counts["packed"],
                packed_vs_fused_max_abs=diffs_p,
                profile=profile), proj_launches, level_launches, feats


def raft_config(out_dir: str, **over):
    """The raft family's YAML defaults (configs/raft.yml), on the card,
    with ``batch_size=32``."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="raft", extraction_fps=None,
               extraction_total=None, fps_mode="select", side_size=None,
               resize="auto", resize_to_smaller_edge=True,
               finetuned_on="sintel", iters=None, batch_size=RAFT_BATCH,
               device="cuda", video_decode="inline", on_extraction="print",
               output_path=out_dir, tmp_path="tmp/chip_smoke",
               weights_path=None, allow_random_weights=True,
               precision="bfloat16", corr_lookup_impl=None, fuse_convc1=None)
    cfg.update(over)
    return Config(cfg)


def run_raft_family(dev):
    """The raft family at its defaults (bfloat16, fused lookup) and with
    corr_lookup_impl=packed, over 65 synthetic frames: 64 flows in two RAFT
    forwards of 32 pairs."""
    from video_features_tpu_torch.extractors.raft import ExtractRAFT
    from video_features_tpu_torch.kernels import corr_lookup as cl

    n_frames = 2 * RAFT_BATCH + 1
    frames = list(synthetic_frames(n_frames, 21))
    forwards = -(-(n_frames - 1) // RAFT_BATCH)
    want_ts = [t / 25 * 1000.0 for t in range(n_frames)]
    runs = {}
    for name, impl, kernel in (("default", None, "proj"),
                               ("packed", "packed", "packed")):
        ex = ExtractRAFT(raft_config("output/chip_smoke",
                                     corr_lookup_impl=impl))
        if ex.model.dtype != torch.bfloat16 or ex.model.iters != ITERS:
            raise AssertionError(f"{name}: {ex.model.dtype}, {ex.model.iters}")
        ex.extract_frames(iter(frames), 25.0)  # cuDNN set-up at this shape
        reset_counts(cl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.extract_frames(iter(frames), 25.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(cl)
        want = {"level": 0, "proj": 0, "packed": 0}
        want[kernel] = ITERS * forwards
        if counts != want:
            raise AssertionError(f"raft {name}: launches {counts}, want "
                                 f"{want}")
        flow = out["raft"]
        if flow.shape != (n_frames - 1, 2, FRAME_H, FRAME_W) \
                or flow.dtype != np.float32 or not np.isfinite(flow).all():
            raise AssertionError(f"raft {name}: flow {flow.shape} "
                                 f"{flow.dtype} or non-finite")
        if out["timestamps_ms"].tolist() != want_ts:
            raise AssertionError(f"raft {name}: timestamps "
                                 f"{out['timestamps_ms']}")
        runs[name] = dict(extractor=ex, flow=flow, seconds=seconds,
                          counts=counts)
    d = np.abs(runs["packed"]["flow"] - runs["default"]["flow"])
    vs_default = dict(max_px=float(d.max()), median_px=float(np.median(d)),
                      p99_px=float(np.percentile(d, 99)),
                      median_limit_px=BF16_MEDIAN_PX,
                      p99_limit_px=BF16_P99_PX)
    if not (vs_default["median_px"] < BF16_MEDIAN_PX
            and vs_default["p99_px"] < BF16_P99_PX):
        raise AssertionError(f"raft packed vs default flow: {vs_default}")
    default_abs = np.abs(runs["default"]["flow"])
    # default and packed in turns (D P), to compare them within one call
    turns = {"default": [], "packed": []}
    for name in ("default", "packed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]["extractor"].extract_frames(iter(frames), 25.0)
        torch.cuda.synchronize()
        turns[name].append((n_frames - 1) / (time.perf_counter() - t0))
    profile = profile_run(runs["default"]["extractor"], frames)
    profile["pairs"] = n_frames - 1
    stats = dict(
        pairs=n_frames - 1, batch_size=RAFT_BATCH, flow_forwards=forwards,
        precision="bfloat16", iters=ITERS,
        flow_abs_px=dict(median=float(np.median(default_abs)),
                         max=float(default_abs.max())),
        packed_vs_default_flow=vs_default,
        turns_pairs_per_s=turns, profile=profile)
    for name in ("default", "packed"):
        stats[f"{name}_pairs_per_s"] = (n_frames - 1) / runs[name]["seconds"]
        stats[f"{name}_launches"] = runs[name]["counts"]
    return stats


def band(got: np.ndarray, want: np.ndarray) -> dict:
    """Cosine and max abs difference of ``got`` against ``want``."""
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return {"cos": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))),
            "max_abs": float(np.abs(a - b).max())}


def synchronize() -> None:
    """Wait for the card (nothing to wait for on the CPU, where the tests
    run the phases' helpers)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def empty_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def timed(extractor, frames):
    """(features, seconds) of one ``extract_frames`` run on the card."""
    synchronize()
    t0 = time.perf_counter()
    out = extractor.extract_frames(iter(frames), 25.0)
    synchronize()
    return out, time.perf_counter() - t0


def pwc_ranges():
    """PWC's plain cost volume and warp, for :func:`profile_run`."""
    from video_features_tpu_torch.models import pwc
    return pwc, ["correlation_volume", "bilinear_warp"]


def pwc_config(out_dir: str, **over):
    """The pwc family's YAML defaults (configs/pwc.yml), on the card, with
    ``batch_size=32``."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="pwc", extraction_fps=None,
               extraction_total=None, fps_mode="select", side_size=None,
               resize="auto", resize_to_smaller_edge=True,
               batch_size=PWC_BATCH, device="cuda", video_decode="inline",
               on_extraction="print", output_path=out_dir,
               tmp_path="tmp/chip_smoke", weights_path=None,
               allow_random_weights=True, precision="bfloat16")
    cfg.update(over)
    return Config(cfg)


def run_pwc_family(dev):
    """The pwc family at its defaults (bfloat16) and in float32, over 65
    synthetic frames: 64 flows in two PWC forwards of 32 pairs."""
    from video_features_tpu_torch.extractors.pwc import ExtractPWC
    from video_features_tpu_torch.kernels import corr_lookup as cl

    n_frames = 2 * PWC_BATCH + 1
    frames = list(synthetic_frames(n_frames, 23))
    want_ts = [t / 25 * 1000.0 for t in range(n_frames)]
    runs = {}
    for precision in ("bfloat16", "float32"):
        ex = ExtractPWC(pwc_config("output/chip_smoke", precision=precision))
        if ex.model.dtype != getattr(torch, precision):
            raise AssertionError(f"pwc {precision}: model {ex.model.dtype}")
        ex.extract_frames(iter(frames), 25.0)  # cuDNN set-up at this shape
        reset_counts(cl)
        out, seconds = timed(ex, frames)
        if any(read_counts(cl).values()):
            raise AssertionError(f"pwc {precision}: lookup kernels "
                                 f"launched {read_counts(cl)}")
        flow = out["pwc"]
        if flow.shape != (n_frames - 1, 2, FRAME_H, FRAME_W) \
                or flow.dtype != np.float32 or not np.isfinite(flow).all():
            raise AssertionError(f"pwc {precision}: flow {flow.shape} "
                                 f"{flow.dtype} or non-finite")
        if out["timestamps_ms"].tolist() != want_ts:
            raise AssertionError(f"pwc {precision}: timestamps "
                                 f"{out['timestamps_ms']}")
        runs[precision] = dict(extractor=ex, flow=flow, seconds=seconds)
    vs_f32 = band(runs["bfloat16"]["flow"], runs["float32"]["flow"])
    vs_f32.update(cos_limit=PWC_BF16_COS, max_abs_limit_px=PWC_BF16_MAX_PX)
    if not (vs_f32["cos"] >= PWC_BF16_COS
            and vs_f32["max_abs"] <= PWC_BF16_MAX_PX):
        raise AssertionError(f"pwc bfloat16 vs float32 flow: {vs_f32}")
    turns = {"bfloat16": [], "float32": []}
    for precision in ("bfloat16", "float32"):
        _, seconds = timed(runs[precision]["extractor"], frames)
        turns[precision].append((n_frames - 1) / seconds)
    profile = profile_run(runs["bfloat16"]["extractor"], frames,
                          pwc_ranges())
    profile["pairs"] = n_frames - 1
    f32_abs = np.abs(runs["float32"]["flow"])
    stats = dict(pairs=n_frames - 1, batch_size=PWC_BATCH,
                 flow_forwards=-(-(n_frames - 1) // PWC_BATCH),
                 flow_abs_px=dict(median=float(np.median(f32_abs)),
                                  max=float(f32_abs.max())),
                 bf16_vs_f32_flow=vs_f32, turns_pairs_per_s=turns,
                 profile=profile)
    for precision in ("bfloat16", "float32"):
        stats[f"{precision}_pairs_per_s"] = \
            (n_frames - 1) / runs[precision]["seconds"]
    return stats


def cost_volume_times(dev, busy_ms, stacks: int) -> dict:
    """The plain cost volume alone at the decoder levels' shapes of one
    stack's 64 pairs, float32 and bfloat16 (CUDA-event medians), with each
    level's bytes bound (the two inputs read once, the 81 channels written
    once, over the card's memory rate); the float32 sum per stack and its
    share of ``busy_ms``, the device busy time of a profiled run of
    ``stacks`` stacks (not measured when the profiler traced no device
    time)."""
    from video_features_tpu_torch.kernels.cost_volume import cost_volume_nchw

    gen = torch.Generator(device="cpu").manual_seed(29)
    out = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            levels = []
            for level, h, w, c in PWC_LEVELS:
                f1, f2 = (torch.randn((STACK, c, h, w), generator=gen).to(
                    dev, dtype) for _ in range(2))
                size = f1.element_size()
                bytes_moved = STACK * h * w * (2 * c + 81) * size
                levels.append(dict(
                    level=level, shape=[STACK, c, h, w],
                    ms=median_ms(lambda: cost_volume_nchw(f1, f2)),
                    bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3))
            name = "float32" if dtype == torch.float32 else "bfloat16"
            out[name] = dict(levels=levels, ms_per_stack=sum(
                lv["ms"] for lv in levels))
    out["share_of_profiled_busy"] = "not measured" if busy_ms is None \
        else out["float32"]["ms_per_stack"] * stacks / busy_ms
    return out


def run_i3d_pwc(dev, fused_feats):
    """I3D at its YAML defaults (flow_type=pwc, float32) and in bfloat16 on
    the slice's frames; then flow_type=raft in bfloat16 once, against the
    slice's fused float32 features ``fused_feats``."""
    from video_features_tpu_torch.extractors.i3d import ExtractI3D
    from video_features_tpu_torch.kernels import corr_lookup as cl

    frames = list(synthetic_frames(2 * STACK + 1, 11))
    runs = {}
    for precision in ("float32", "bfloat16"):
        ex = ExtractI3D(slice_config("output/chip_smoke", flow_type="pwc",
                                     flow_stack_batch="auto",
                                     precision=precision))
        ex.extract_frames(synthetic_frames(2 * STACK + 1, 7), 25.0)
        ex.flow_stream.forwards = 0
        reset_counts(cl)
        feats, seconds = timed(ex, frames)
        if any(read_counts(cl).values()):
            raise AssertionError(f"i3d pwc {precision}: lookup kernels "
                                 f"launched {read_counts(cl)}")
        for s in ("rgb", "flow"):
            if feats[s].shape != (2, 1024) or not np.isfinite(feats[s]).all():
                raise AssertionError(f"i3d pwc {precision} {s}: shape "
                                     f"{feats[s].shape} or non-finite")
        runs[precision] = dict(extractor=ex, feats=feats, seconds=seconds,
                               flow_forwards=ex.flow_stream.forwards)
    bf16_vs_f32 = {s: band(runs["bfloat16"]["feats"][s],
                           runs["float32"]["feats"][s])
                   for s in ("rgb", "flow")}
    if not all(b["cos"] >= HEAD_COS and b["max_abs"] <= HEAD_MAX_ABS
               for b in bf16_vs_f32.values()):
        raise AssertionError(f"i3d pwc bfloat16 vs float32: {bf16_vs_f32}")
    turns = {"float32": [], "bfloat16": []}
    for precision in ("float32", "bfloat16"):
        _, seconds = timed(runs[precision]["extractor"], frames)
        turns[precision].append(2 / seconds)
    profile = profile_run(runs["float32"]["extractor"], frames, pwc_ranges())
    profile["stacks"] = 2
    profile_bf16 = profile_run(runs["bfloat16"]["extractor"], frames,
                               pwc_ranges())
    stats = dict(stacks=2, bf16_vs_f32=bf16_vs_f32,
                 band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
                 turns_stacks_per_s=turns, profile=profile,
                 profile_bfloat16=profile_bf16)
    for precision in ("float32", "bfloat16"):
        stats[f"{precision}_stacks_per_s"] = 2 / runs[precision]["seconds"]
        stats[f"{precision}_flow_forwards"] = runs[precision]["flow_forwards"]
    del runs
    torch.cuda.empty_cache()

    raft = ExtractI3D(slice_config("output/chip_smoke",
                                   precision="bfloat16"))
    reset_counts(cl)
    feats, seconds = timed(raft, frames)
    counts = read_counts(cl)
    fwd = raft.flow_stream.forwards
    if fwd < 1 or counts != {"level": 0, "proj": ITERS * fwd, "packed": 0}:
        raise AssertionError(f"i3d raft bfloat16: launches {counts} for "
                             f"{fwd} RAFT forwards")
    raft_vs_fused = {s: band(feats[s], fused_feats[s])
                     for s in ("rgb", "flow")}
    if not all(b["cos"] >= HEAD_COS and b["max_abs"] <= HEAD_MAX_ABS
               for b in raft_vs_fused.values()):
        raise AssertionError(f"i3d raft bfloat16 vs fused float32: "
                             f"{raft_vs_fused}")
    stats["raft_bfloat16"] = dict(
        flow_forwards=fwd, launches=counts, vs_fused_float32=raft_vs_fused,
        cold_stacks_per_s=2 / seconds)
    del raft
    torch.cuda.empty_cache()
    stats["cost_volume"] = cost_volume_times(
        dev, profile.get("device_busy_ms"), 2)
    return stats, counts["proj"]


def clip_config(feature_type: str, **over):
    """The r21d or s3d YAML defaults (configs/*.yml), on the card."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type=feature_type, stack_size=None, step_size=None,
               clip_batch_size=CLIP_BATCH, extraction_fps=None,
               fps_mode="select", device="cuda", video_decode="inline",
               on_extraction="print", output_path="output/chip_smoke",
               tmp_path="tmp/chip_smoke", show_pred=False, weights_path=None,
               allow_random_weights=True, precision="float32", ingest=None)
    if feature_type == "r21d":
        cfg["model_name"] = "r2plus1d_18_16_kinetics"
    else:
        cfg.update(stack_size=S3D_STACK, step_size=S3D_STACK,
                   extraction_fps=25)
    cfg.update(over)
    return Config(cfg)


def clip_windows(extractor, n_frames: int):
    """The ``(start, end)`` windows ``extractor`` forms over ``n_frames``
    frames (placeholders: the windowing does not read them)."""
    return [w for w, _ in extractor._iter_stacks(
        (np.zeros(1), i / 25 * 1000.0, i) for i in range(n_frames))]


def in_head_band(b: dict) -> bool:
    return b["cos"] >= HEAD_COS and b["max_abs"] <= HEAD_MAX_ABS


def wire_frames(extractor, frames):
    """``frames`` through the extractor's host transform, and the mean ms
    per frame it took."""
    t0 = time.perf_counter()
    out = [(extractor.host_transform(f), t, i) for f, t, i in frames]
    return out, (time.perf_counter() - t0) * 1e3 / len(frames)


def card_part(extractor, wire) -> float:
    """Seconds of the card's part of a run: transformed frames through the
    clip windows, the copy, the forward and back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extractor._features(iter(wire))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def clip_phase(feature_type: str, n_frames: int, dim: int, unit: str):
    """One clip-stack family in float32 (the YAML default) and bfloat16
    over ``n_frames`` seeded frames: the main-path run of each through
    ``extract_frames`` with every launch count set to 0 just before and
    read just after (no lookup kernel runs), the checks, the host
    transform's ms per frame, the card's part in turns (F B), one
    profiled run of each. Returns (stats, the frames, the float32
    features)."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.extractors.s3d import ExtractS3D
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils.lists import form_slices

    cls = ExtractR21D if feature_type == "r21d" else ExtractS3D
    frames = list(synthetic_frames(n_frames, 31))
    runs = {}
    for precision in ("float32", "bfloat16"):
        ex = cls(clip_config(feature_type, precision=precision))
        wire, transform_ms = wire_frames(ex, frames)
        card_part(ex, wire)  # the first call at a shape sets up cuDNN
        reset_counts(cl)
        feats, seconds = timed(ex, frames)
        feats = feats[feature_type]
        if any(read_counts(cl).values()):
            raise AssertionError(f"{feature_type} {precision}: lookup "
                                 f"kernels launched {read_counts(cl)}")
        windows = form_slices(n_frames, ex.stack_size, ex.step_size)
        if clip_windows(ex, n_frames) != windows:
            raise AssertionError(f"{feature_type}: windows "
                                 f"{clip_windows(ex, n_frames)}")
        if feats.shape != (len(windows), dim) or \
                not np.isfinite(feats).all():
            raise AssertionError(f"{feature_type} {precision}: shape "
                                 f"{feats.shape} or non-finite")
        runs[precision] = dict(extractor=ex, feats=feats, seconds=seconds,
                               wire=wire, transform_ms=transform_ms,
                               ingest=ex.ingest)
    rows = len(runs["float32"]["feats"])
    vs_f32 = band(runs["bfloat16"]["feats"], runs["float32"]["feats"])
    if not in_head_band(vs_f32):
        raise AssertionError(f"{feature_type} bfloat16 vs float32: {vs_f32}")
    turns = {"float32": [], "bfloat16": []}
    for precision in ("float32", "bfloat16"):
        r = runs[precision]
        turns[precision].append(rows / card_part(r["extractor"], r["wire"]))
    stats = dict(frames=n_frames, rows=rows, clip_batch_size=CLIP_BATCH,
                 bf16_vs_f32=vs_f32,
                 band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
                 **{f"card_part_turns_{unit}_per_s": turns})
    for precision, r in runs.items():
        profile = profile_run(r["extractor"], frames)
        profile[unit] = rows
        stats[precision] = dict(
            ingest=r["ingest"], seconds=r["seconds"],
            **{f"{unit}_per_s": rows / r["seconds"]},
            host_transform_ms_per_frame=r["transform_ms"], profile=profile)
    feats = runs["float32"]["feats"]
    del runs
    torch.cuda.empty_cache()
    return stats, frames, feats


def run_r21d(dev):
    """R(2+1)D at the r21d YAML defaults and in bfloat16 (clip_phase),
    then ``ingest=yuv420`` once and the 34-layer variant once."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.ops import colorspace
    from video_features_tpu_torch.ops.host_transforms import R21DTransform

    stats, frames, feats = clip_phase("r21d", R21D_FRAMES, 512, "clips")
    to_u8 = R21DTransform("uint8")
    packed = np.stack([colorspace.rgb_to_yuv420(to_u8(f))
                       for f, _, _ in frames[:R21D_STACK]])
    want = colorspace.yuv420_packed_to_rgb(torch.from_numpy(packed), 112, 112)
    got = colorspace.yuv420_packed_to_rgb(torch.from_numpy(packed).to(dev),
                                          112, 112)
    err = max_abs_err(got.cpu(), want)
    if not err <= 1e-4:
        raise AssertionError(f"yuv420_packed_to_rgb card vs CPU: {err}")
    yuv = ExtractR21D(clip_config("r21d", ingest="yuv420"))
    yuv_feats, yuv_s = timed(yuv, frames)
    yuv_band = band(yuv_feats["r21d"], feats)
    if yuv_feats["r21d"].shape != feats.shape or not in_head_band(yuv_band):
        raise AssertionError(f"r21d yuv420 vs float32: {yuv_band}")
    del yuv
    r34 = ExtractR21D(clip_config(
        "r21d", model_name="r2plus1d_34_8_ig65m_ft_kinetics"))
    r34_feats, r34_s = timed(r34, frames[:16])
    if r34_feats["r21d"].shape != (2, 512) or \
            not np.isfinite(r34_feats["r21d"]).all():
        raise AssertionError(f"r34_8: {r34_feats['r21d'].shape}")
    del r34
    torch.cuda.empty_cache()
    stats["yuv420"] = dict(rgb_card_vs_cpu_max_abs_err=err,
                           vs_float32=yuv_band,
                           cold_clips_per_s=len(feats) / yuv_s)
    stats["r2plus1d_34_8"] = dict(clips=2, cold_seconds=r34_s)
    return stats


def run_s3d(dev):
    """S3D at the s3d YAML defaults and in bfloat16 (clip_phase)."""
    return clip_phase("s3d", S3D_FRAMES, 1024, "stacks")[0]


def frame_config(feature_type: str, **over):
    """The resnet or clip YAML defaults (configs/*.yml: resnet50 or
    ViT-B/32, ``batch_size=1``, float32), on the card, with
    ``resize=device``."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type=feature_type, batch_size=1, extraction_fps=None,
               extraction_total=None, fps_mode="select", device="cuda",
               video_decode="inline", on_extraction="print",
               output_path="output/chip_smoke", tmp_path="tmp/chip_smoke",
               show_pred=False, weights_path=None, allow_random_weights=True,
               precision="float32", ingest=None, resize="device")
    if feature_type == "resnet":
        cfg["model_name"] = "resnet50"
    else:
        cfg.update(model_name="ViT-B/32", pred_texts=None, bpe_path=None,
                   model_parallel=1, vision_attn="dense")
    cfg.update(over)
    return Config(cfg)


def frame_flops(extractor) -> float:
    """Forward FLOPs per frame of a frame-wise extractor's image backbone
    at its crop (``torch.utils.flop_counter`` on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    from video_features_tpu_torch.models import clip, resnet

    with torch.device("meta"):
        if extractor.feature_type == "resnet":
            forward = resnet.ResNet(extractor.model_name)
        else:
            forward = clip.CLIP(extractor.cfg).encode_image
        x = torch.zeros((1, extractor.crop_size, extractor.crop_size, 3))
    with FlopCounterMode(display=False) as counter:
        forward(x)
    return float(counter.get_total_flops())


def frame_phase(feature_type: str, dim: int, other_model: str,
                other_dim: int, n_frames: int = FRAME_FRAMES,
                batch: int = FRAME_BATCH, n_batch1: int = FRAME_BATCH1_FRAMES,
                **over) -> dict:
    """One frame-wise family: the YAML defaults (batch_size=1) over 32
    seeded frames; batch_size=64 in float32 and bfloat16 over 256; then
    resize=host, ingest=yuv420 and ``other_model`` once beside. Every
    extract_frames run is checked (shape, finite, timestamps, no lookup
    kernel launched, counts set to 0 just before and read just after);
    bfloat16 against float32 in the head band, batch 1 and resize=host
    against batch 64 in the value tier, yuv420 against uint8 at cosine
    0.99. Frames/s of float32 and bfloat16 in turns (F B), one
    profiled run of each and of batch 1. ``over`` goes into every config
    (the CPU tests run the phase with ``device=cpu`` and small models)."""
    from video_features_tpu_torch.extractors.clip import ExtractCLIP
    from video_features_tpu_torch.extractors.resnet import ExtractResNet
    from video_features_tpu_torch.kernels import corr_lookup as cl

    cls = ExtractResNet if feature_type == "resnet" else ExtractCLIP
    frames = list(synthetic_frames(n_frames, 41))

    def config(**kw):
        return frame_config(feature_type, **{**over, **kw})

    def run(ex, n_frames):
        """(features, seconds) of one checked run over the first
        ``n_frames`` frames, after one batch that sets up cuDNN."""
        used = frames[:n_frames]
        ex.extract_frames(iter(used[:ex.batch_size]), 25.0)
        reset_counts(cl)
        out, seconds = timed(ex, used)
        what = f"{feature_type} {ex.model_name} {ex.precision} " \
            f"batch {ex.batch_size} {ex.resize_mode} {ex.ingest}"
        if any(read_counts(cl).values()):
            raise AssertionError(f"{what}: lookup kernels launched "
                                 f"{read_counts(cl)}")
        feats = out[feature_type]
        want_dim = dim if ex.model_name == default_model else other_dim
        if feats.shape != (n_frames, want_dim) or feats.dtype != np.float32 \
                or not np.isfinite(feats).all():
            raise AssertionError(f"{what}: features {feats.shape} "
                                 f"{feats.dtype} or non-finite")
        if out["timestamps_ms"].tolist() != [t / 25 * 1000.0
                                             for t in range(n_frames)]:
            raise AssertionError(f"{what}: timestamps "
                                 f"{out['timestamps_ms']}")
        return feats, seconds

    batch1 = cls(config())
    default_model = batch1.model_name
    b1_feats, b1_s = run(batch1, n_batch1)
    b1_profile = profile_run(batch1, frames[:n_batch1])
    del batch1
    runs = {}
    for precision in ("float32", "bfloat16"):
        ex = cls(config(batch_size=batch, precision=precision))
        feats, seconds = run(ex, n_frames)
        runs[precision] = dict(extractor=ex, feats=feats, seconds=seconds)
    f32 = runs["float32"]["feats"]
    vs_f32 = band(runs["bfloat16"]["feats"], f32)
    if not in_head_band(vs_f32):
        raise AssertionError(f"{feature_type} bfloat16 vs float32: {vs_f32}")
    b1_vs_b64 = float(np.abs(b1_feats - f32[:n_batch1]).max())
    if not b1_vs_b64 <= VALUE_ATOL:
        raise AssertionError(f"{feature_type} batch 1 vs 64: {b1_vs_b64}")

    host = cls(config(batch_size=batch, resize="host"))
    host_feats, host_s = run(host, n_frames)
    _, transform_ms = wire_frames(host, frames[:batch])
    del host
    host_vs_device = band(host_feats, f32)
    if not host_vs_device["max_abs"] <= VALUE_ATOL:
        raise AssertionError(f"{feature_type} resize=host vs device: "
                             f"{host_vs_device}")
    yuv = cls(config(batch_size=batch, ingest="yuv420"))
    yuv_feats, yuv_s = run(yuv, n_frames)
    del yuv
    yuv_vs_uint8 = band(yuv_feats, f32)
    if not yuv_vs_uint8["cos"] >= HEAD_COS:
        raise AssertionError(f"{feature_type} yuv420 vs uint8: "
                             f"{yuv_vs_uint8}")
    other = cls(config(batch_size=batch, model_name=other_model))
    _, other_s = run(other, batch)
    del other
    empty_cache()

    turns = {"float32": [], "bfloat16": []}
    for precision in ("float32", "bfloat16"):
        _, seconds = timed(runs[precision]["extractor"], frames)
        turns[precision].append(n_frames / seconds)
    flops = frame_flops(runs["float32"]["extractor"])
    batches = -(-n_frames // batch)
    stats = dict(
        model=default_model, frames=n_frames, batch_size=batch,
        gflop_per_frame=flops / 1e9, bf16_vs_f32=vs_f32,
        band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
        turns_frames_per_s=turns)
    for precision, r in runs.items():
        profile = profile_run(r["extractor"], frames)
        profile["frames"] = n_frames
        if "kernel_launches" in profile:
            profile["launches_per_batch"] = \
                profile["kernel_launches"] / batches
            profile["device_tflop_per_s"] = \
                flops * n_frames / profile["device_busy_ms"] / 1e9
        stats[precision] = dict(seconds=r["seconds"],
                                frames_per_s=n_frames / r["seconds"],
                                profile=profile)
    del runs
    empty_cache()
    if "kernel_launches" in b1_profile:
        b1_profile["launches_per_batch"] = \
            b1_profile["kernel_launches"] / n_batch1
    stats["batch1"] = dict(frames=n_batch1, seconds=b1_s,
                           frames_per_s=n_batch1 / b1_s,
                           vs_batch64_max_abs=b1_vs_b64,
                           profile=b1_profile)
    stats["resize_host"] = dict(vs_device=host_vs_device,
                                max_abs_limit=VALUE_ATOL,
                                frames_per_s=n_frames / host_s,
                                host_transform_ms_per_frame=transform_ms)
    stats["yuv420"] = dict(vs_uint8=yuv_vs_uint8, cos_limit=HEAD_COS,
                           frames_per_s=n_frames / yuv_s)
    stats[other_model] = dict(frames=batch, dim=other_dim,
                              cold_seconds=other_s)
    return stats


def vggish_config(**over):
    """The vggish YAML defaults (configs/vggish.yml: ``frontend=host``,
    float32, ``batch_size=32``), on the card, with seeded weights."""
    from video_features_tpu_torch.config import Config
    cfg = dict(feature_type="vggish", batch_size=32, postprocess=False,
               pca_weights_path=None, device="cuda", video_decode="inline",
               on_extraction="print", output_path="output/chip_smoke",
               tmp_path="tmp/chip_smoke", keep_tmp_files=False,
               show_pred=False, weights_path=None, allow_random_weights=True,
               precision="float32", frontend="host")
    cfg.update(over)
    return Config(cfg)


def write_wav(path: str, seconds: float, rate: int, channels: int,
              seed: int) -> str:
    """A seeded 16-bit PCM WAV (stdlib ``wave``): noise under a few
    drifting tones, ``channels`` channels at ``rate`` Hz."""
    import wave
    rng = np.random.default_rng(seed)
    n = round(seconds * rate)
    t = np.arange(n) / rate
    tones = sum(0.1 * np.sin(2 * np.pi * f * t * (1 + 0.01 * np.sin(t / 7)))
                for f in (220.0, 440.0, 1375.0))
    data = np.stack([tones + rng.normal(0, 0.05, n) for _ in range(channels)],
                    axis=-1)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((data.clip(-1, 1) * 32767).astype("<i2").tobytes())
    return path


def vggish_flops() -> float:
    """Forward FLOPs per 0.96 s example of VGGish
    (``torch.utils.flop_counter`` on meta tensors)."""
    from torch.utils.flop_counter import FlopCounterMode
    from video_features_tpu_torch.models.vggish import VGGish

    with torch.device("meta"):
        model = VGGish()
        x = torch.zeros((1, 96, 64, 1))
    with FlopCounterMode(display=False) as counter:
        model(x)
    return float(counter.get_total_flops())


def vggish_phase(n_examples: int = VGGISH_EXAMPLES,
                 stereo_seconds: float = VGGISH_STEREO_SECONDS,
                 **over) -> dict:
    """VGGish through ``ExtractVGGish.extract(path)`` on a seeded 16 kHz
    mono WAV of ``n_examples`` examples (600.015 s for 625): the YAML
    defaults
    (``frontend=host``, float32, ``batch_size=32``), ``frontend=device``,
    and both frontends in bfloat16, in turns; then a 44.1 kHz stereo WAV
    of ``stereo_seconds`` once (the mono mix and ``resample_poly``). Each
    run: (N, 128) finite embeddings, no lookup kernel launched (counts set
    to 0 just before and read just after). Device frontend against host in
    float32 within 1e-3, the card's ``logmel_examples`` on the first batch
    against the numpy frontend within 1e-4, bfloat16 against float32 in
    the head band. Examples/s of each run, the host frontend's ms per
    example, FLOPs per example, the device TFLOP/s they imply, and one
    profile of each float32 frontend. ``over`` goes into every config
    (the CPU tests run the phase with ``device=cpu`` on short audio)."""
    import os
    from video_features_tpu_torch.extractors.vggish import ExtractVGGish
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.ops import audio

    wav_dir = os.path.join("output", "chip_smoke", "vggish")
    os.makedirs(wav_dir, exist_ok=True)
    seconds = ((n_examples - 1) * audio.EXAMPLE_HOP_SAMPLES
               + audio.EXAMPLE_CHUNK_SAMPLES) / audio.SAMPLE_RATE
    mono = write_wav(os.path.join(wav_dir, "mono16k.wav"), seconds, 16000,
                     1, 61)
    stereo = write_wav(os.path.join(wav_dir, "stereo44k.wav"),
                       stereo_seconds, 44100, 2, 62)

    def run(ex, path, rows):
        """(embeddings, seconds) of one checked ``extract(path)``."""
        reset_counts(cl)
        synchronize()
        t0 = time.perf_counter()
        out = ex.extract(path)
        synchronize()
        sec = time.perf_counter() - t0
        what = f"vggish {ex.frontend} {ex.precision} {path}"
        if any(read_counts(cl).values()):
            raise AssertionError(f"{what}: lookup kernels launched "
                                 f"{read_counts(cl)}")
        feats = out["vggish"]
        if set(out) != {"vggish"} or feats.shape != (rows, 128) \
                or feats.dtype != np.float32 or not np.isfinite(feats).all():
            raise AssertionError(f"{what}: embeddings {feats.shape} "
                                 f"{feats.dtype} or non-finite")
        return feats, sec

    names = [(f, p) for p in ("float32", "bfloat16")
             for f in ("host", "device")]
    exs = {(f, p): ExtractVGGish(vggish_config(**{**over, "frontend": f,
                                                  "precision": p}))
           for f, p in names}
    runs = {}
    for key in names:  # the first run of each sets up cuDNN and cuFFT
        run(exs[key], mono, n_examples)
        runs[key] = run(exs[key], mono, n_examples)
    host32, dev32 = runs[("host", "float32")][0], \
        runs[("device", "float32")][0]
    device_vs_host = float(np.abs(dev32 - host32).max())
    if not device_vs_host <= VGGISH_FRONTEND_ATOL:
        raise AssertionError(f"vggish device vs host frontend: "
                             f"{device_vs_host}")
    bands = {f"{f}_bf16_vs_f32": band(runs[(f, "bfloat16")][0],
                                      runs[(f, "float32")][0])
             for f in ("host", "device")}
    if not all(in_head_band(b) for b in bands.values()):
        raise AssertionError(f"vggish bfloat16 vs float32: {bands}")

    data, rate = audio.read_wav(mono)
    t0 = time.perf_counter()
    examples = audio.waveform_to_examples(data, rate)
    host_ms = (time.perf_counter() - t0) * 1e3 / len(examples)
    chunks = torch.from_numpy(audio.chunk_waveform(data, rate)[:32])
    dev = exs[("device", "float32")].device
    with torch.inference_mode():
        logmel = audio.logmel_examples(chunks.to(dev)).cpu().numpy()
    logmel_err = float(np.abs(logmel - examples[:32]).max())
    if not logmel_err <= VGGISH_LOGMEL_ATOL:
        raise AssertionError(f"vggish logmel_examples vs numpy: "
                             f"{logmel_err}")
    stereo_rows = 1 + (int(stereo_seconds * 16000)
                       - audio.EXAMPLE_CHUNK_SAMPLES) \
        // audio.EXAMPLE_HOP_SAMPLES
    _, stereo_s = run(exs[("host", "float32")], stereo, stereo_rows)

    turns = {f"{f}_{p}": [] for f, p in names}
    for key in names:
        _, sec = run(exs[key], mono, n_examples)
        turns[f"{key[0]}_{key[1]}"].append(n_examples / sec)
    flops = vggish_flops()
    batches = -(-n_examples // exs[names[0]].batch_size)
    stats = dict(seconds_of_audio=seconds, examples=n_examples,
                 batch_size=exs[names[0]].batch_size,
                 gflop_per_example=flops / 1e9,
                 host_frontend_ms_per_example=host_ms,
                 device_vs_host_f32_max_abs=device_vs_host,
                 device_vs_host_limit=VGGISH_FRONTEND_ATOL,
                 logmel_vs_numpy_max_abs=logmel_err,
                 logmel_limit=VGGISH_LOGMEL_ATOL, bands=bands,
                 band=dict(cos=HEAD_COS, max_abs=HEAD_MAX_ABS),
                 stereo44k=dict(seconds_of_audio=stereo_seconds,
                                examples=stereo_rows,
                                examples_per_s=stereo_rows / stereo_s),
                 turns_examples_per_s=turns)
    for (f, p), (_, sec) in runs.items():
        stats[f"{f}_{p}"] = dict(seconds=sec,
                                 examples_per_s=n_examples / sec)
    for f in ("host", "device"):
        ex = exs[(f, "float32")]
        profile = profile_call(lambda ex=ex: ex.extract(mono))
        if "kernel_launches" in profile:
            profile["launches_per_batch"] = \
                profile["kernel_launches"] / batches
            profile["device_tflop_per_s"] = \
                flops * n_examples / profile["device_busy_ms"] / 1e9
        stats[f"{f}_float32"]["profile"] = profile
    del exs
    empty_cache()
    return stats


def parallel_devices(dev) -> list:
    """The two devices of the parallel phase: two cards where the machine
    has them, else two replicas on ``cuda:0`` (the CPU twice in the
    tests)."""
    if dev.type != "cuda":
        return [dev, dev]
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)]
    return [torch.device("cuda", 0)] * 2


def parallel_raft(devices, n_frames: int = 2 * RAFT_BATCH + 1,
                  timed_turns: bool = True, **over):
    """(a) The raft family in float32 with ``batch_size=32`` on a two-device
    mesh against the one-device run: flows within 1e-3 px; on the card, proj
    launched 20 times per forward on each replica (counted by forward hooks
    around each replica's RAFT; a replica's forwards launch in turn on one
    thread), level and packed never; pairs/s of both in turns (O T).
    ``timed_turns=False`` (the CPU test) leaves the turns out, as in the
    other parts."""
    from video_features_tpu_torch.extractors.raft import ExtractRAFT
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.parallel.mesh import get_mesh

    frames = list(synthetic_frames(n_frames, 21))
    cfg = raft_config("output/chip_smoke", precision="float32", **over)
    one = ExtractRAFT(cfg)
    two = ExtractRAFT(cfg, mesh=get_mesh(devices=devices))
    per_replica = [{"forwards": 0, "proj": 0} for _ in two.runner.replicas]
    for replica, tally in zip(two.runner.replicas, per_replica):
        def pre(module, args, _tally=tally):
            _tally["start"] = cl.corr_lookup_proj_cuda.launches

        def post(module, args, out, _tally=tally):
            _tally["forwards"] += 1
            _tally["proj"] += cl.corr_lookup_proj_cuda.launches - \
                _tally.pop("start")
        replica.register_forward_pre_hook(pre)
        replica.register_forward_hook(post)
    if timed_turns:  # cuDNN set-up at these shapes
        one.extract_frames(iter(frames), 25.0)
        two.extract_frames(iter(frames), 25.0)
    want_flow = one.extract_frames(iter(frames), 25.0)["raft"]
    for tally in per_replica:
        tally.update(forwards=0, proj=0)
    reset_counts(cl)
    got, _ = timed(two, frames)
    counts = read_counts(cl)
    per_replica = [dict(t) for t in per_replica]  # the turns count on
    err = float(np.abs(got["raft"] - want_flow).max())
    if got["raft"].shape != want_flow.shape or not err <= 1e-3:
        raise AssertionError(f"raft on two devices vs one: {err} px")
    on_card = devices[0].type == "cuda"
    forwards = sum(t["forwards"] for t in per_replica)
    if on_card and (counts != {"level": 0, "packed": 0,
                               "proj": ITERS * forwards}
                    or any(t["proj"] != ITERS * t["forwards"]
                           or t["forwards"] == 0 for t in per_replica)):
        raise AssertionError(f"raft on two devices: launches {counts}, "
                             f"per replica {per_replica}")
    pairs = n_frames - 1
    stats = dict(devices=[str(d) for d in devices], pairs=pairs,
                 batch_size=two.batch_size, precision="float32",
                 vs_one_device_max_px=err, max_px_limit=1e-3,
                 launches=counts, per_replica=per_replica,
                 proj_per_forward_per_replica=[
                     t["proj"] / max(t["forwards"], 1) for t in per_replica])
    if timed_turns:
        turns = {"one": [], "two": []}
        for name in ("one", "two"):
            _, seconds = timed(one if name == "one" else two, frames)
            turns[name].append(pairs / seconds)
        stats["turns_pairs_per_s"] = turns
    return stats


class _GroupSizes:
    """``runner.dispatch`` that records each dispatched group's size."""

    def __init__(self, runner) -> None:
        self.runner = runner
        self.sizes = []

    def dispatch(self, group):
        self.sizes.append(len(group))
        return self.runner.dispatch(group)


def feed_videos(extractor, videos, workers: int, keep_open: bool):
    """Each video's frames through ``extractor.extract_frames`` on
    ``workers`` threads; returns (per-video features, seconds).

    A feed lock is held from a video's first frame to its last, so that its
    clips enter a packer contiguously, and with ``keep_open`` a keeper
    handle holds the packer open until every video has been fed (as a long
    video still decoding would). Without them a packed run can dispatch a
    short group before the end: the packer flushes when every open video
    is closing, and with 3 workers interleaved adds can leave all three
    closing on a part-filled group while videos wait, and a worker between
    two videos leaves the others alone with it. With contiguous adds of
    these clip counts no three closing videos hold the part-filled group
    in any interleaving (``tools/packer_interleavings.py``), so the keeper
    closes only when everything is fed."""
    from concurrent.futures import ThreadPoolExecutor
    import threading

    feed_lock = threading.Lock()
    fed = threading.Semaphore(0)

    def fed_frames(frames):
        with feed_lock:
            yield from frames
        fed.release()

    def one(frames):
        return extractor.extract_frames(fed_frames(frames), 25.0)[
            extractor.feature_type]

    packer = extractor._get_packer() if keep_open else None
    keeper = packer.open_video() if keep_open else None
    synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(one, frames) for frames in videos]
        stalled = not all(fed.acquire(timeout=120) for _ in videos)
        if keep_open:
            packer.close_video(keeper)
        feats = [f.result(timeout=300) for f in futures]
    synchronize()
    seconds = time.perf_counter() - t0
    if stalled:
        raise AssertionError("packed feed stalled: a part-filled group "
                             "held every worker")
    return feats, seconds


def parallel_packed(lengths=PACKED_VIDEOS, workers: int = PACKED_WORKERS,
                    timed_turns: bool = True, **over):
    """(b) r21d at its YAML defaults with ``cross_video_batching=true``:
    ``len(lengths)`` seeded videos through ``extract_frames`` on
    ``workers`` threads (:func:`feed_videos`), against the same videos
    unpacked: per-video features within 1e-4, ceil(clips / group) groups
    with only the last short; clips/s of both in turns (U P)."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D
    from video_features_tpu_torch.utils.lists import form_slices

    videos = [list(synthetic_frames(n, 50 + i))
              for i, n in enumerate(lengths)]
    plain = ExtractR21D(clip_config("r21d", **over))
    packed = ExtractR21D(clip_config("r21d", cross_video_batching=True,
                                     **over))
    clips = [len(form_slices(n, plain.stack_size, plain.step_size))
             for n in lengths]
    batch = packed.clip_batch_size
    packer = packed._get_packer()
    packer.runner = _GroupSizes(packer.runner)
    if timed_turns:
        plain.extract_frames(iter(videos[0]), 25.0)  # cuDNN set-up
    want, plain_s = feed_videos(plain, videos, workers, keep_open=False)
    packer.runner.sizes.clear()
    got, packed_s = feed_videos(packed, videos, workers, keep_open=True)
    sizes = list(packer.runner.sizes)
    total = sum(clips)
    if sizes != [batch] * (total // batch) + ([total % batch]
                                              if total % batch else []):
        raise AssertionError(f"packed groups {sizes} for {total} clips")
    err = 0.0
    for g, w, n in zip(got, want, clips):
        if g.shape != (n, 512) or w.shape != (n, 512):
            raise AssertionError(f"packed {g.shape} / plain {w.shape}")
        err = max(err, float(np.abs(g - w).max()))
    if not err <= 1e-4:
        raise AssertionError(f"packed vs unpacked r21d: {err}")
    stats = dict(videos=len(lengths), frames=list(lengths), clips=clips,
                 workers=workers, clip_batch_size=batch, group_sizes=sizes,
                 vs_unpacked_max_abs=err, max_abs_limit=1e-4,
                 first_clips_per_s=dict(unpacked=total / plain_s,
                                        packed=total / packed_s))
    if timed_turns:
        turns = {"unpacked": [], "packed": []}
        for name in ("unpacked", "packed"):
            ex = packed if name == "packed" else plain
            _, seconds = feed_videos(ex, videos, workers,
                                     keep_open=name == "packed")
            turns[name].append(total / seconds)
        stats["turns_clips_per_s"] = turns
    return stats


def parallel_clip_tp(devices, n_frames: int = TP_FRAMES,
                     timed_turns: bool = True, **over):
    """(c) CLIP at the clip YAML defaults (ViT-B/32, float32,
    ``resize=device``) with ``model_parallel=2`` over a ``(data=1,
    model=2)`` mesh of ``devices``, against ``model_parallel=1``: features
    within 1e-4; each shard's ``in_proj_weight`` (3E/2, E); frames/s of
    both in turns (R T)."""
    from video_features_tpu_torch.extractors.clip import ExtractCLIP
    from video_features_tpu_torch.parallel.mesh import get_mesh

    frames = list(synthetic_frames(n_frames, 61))
    cfg = dict(batch_size=n_frames, **over)
    ref = ExtractCLIP(frame_config("clip", **cfg))
    tp = ExtractCLIP(frame_config("clip", model_parallel=2, **cfg),
                     mesh=get_mesh(devices=devices,
                                   axis_names=("data", "model"),
                                   shape=(1, 2)))
    e = tp.cfg.vision_width
    attn = tp.runner.replicas[0]["model"].visual.transformer \
        .resblocks[0].attn
    shapes = [tuple(s.in_proj_weight.shape) for s in attn.shards]
    if shapes != [(3 * e // 2, e)] * 2 or \
            [s.device for s in attn.shards] != list(devices):
        raise AssertionError(f"TP shards {shapes} on "
                             f"{[str(s.device) for s in attn.shards]}")
    if timed_turns:  # cuDNN set-up
        ref.extract_frames(iter(frames), 25.0)
        tp.extract_frames(iter(frames), 25.0)
    want, _ = timed(ref, frames)
    got, _ = timed(tp, frames)
    err = float(np.abs(got["clip"] - want["clip"]).max())
    if got["clip"].shape != want["clip"].shape or not err <= 1e-4:
        raise AssertionError(f"CLIP model_parallel=2 vs 1: {err}")
    stats = dict(devices=[str(d) for d in devices],
                 mesh=tp.runner.mesh.shape, model=tp.model_name,
                 frames=n_frames, in_proj_weight_shards=shapes,
                 vs_replicated_max_abs=err, max_abs_limit=1e-4)
    if timed_turns:
        turns = {"replicated": [], "tensor_parallel": []}
        for name in ("replicated", "tensor_parallel"):
            _, seconds = timed(ref if name == "replicated" else tp, frames)
            turns[name].append(n_frames / seconds)
        stats["turns_frames_per_s"] = turns
    return stats


def parallel_stream(n_frames: int = R21D_FRAMES, timed_turns: bool = True,
                    **over):
    """(d) r21d ``extract_frames`` at the YAML defaults through its
    FeatureStream at depth 4 against depth 0 (synchronous), one extractor
    switched between them: the features identical; clips/s in turns (4 0 0
    4) and one profiled run of each (the card's busy share: how much the
    next group's host transform now overlaps the card)."""
    from video_features_tpu_torch.extractors.r21d import ExtractR21D

    frames = list(synthetic_frames(n_frames, 71))
    ex = ExtractR21D(clip_config("r21d", **over))
    if timed_turns:
        ex.extract_frames(iter(frames[:R21D_STACK]), 25.0)  # cuDNN set-up
    feats, turns = {}, {4: [], 0: []}
    for depth in (4, 0):
        ex.stream_depth = depth
        out, seconds = timed(ex, frames)
        feats.setdefault(depth, out["r21d"])
        turns[depth].append(len(out["r21d"]) / seconds)
    if not np.array_equal(feats[4], feats[0]):
        raise AssertionError("r21d depth=4 and depth=0 features differ: "
                             f"{float(np.abs(feats[4] - feats[0]).max())}")
    stats = dict(frames=n_frames, clips=len(feats[4]))
    if timed_turns:
        stats["turns_clips_per_s"] = {f"depth{d}": v
                                      for d, v in turns.items()}
        for depth in (4, 0):
            ex.stream_depth = depth
            stats[f"depth{depth}_profile"] = profile_run(ex, frames)
    return stats


def parallel_phase(dev) -> dict:
    """The parallel plane at full width: (a) raft over two devices, (b)
    r21d cross-video packing, (c) CLIP tensor parallelism, (d) the
    FeatureStream's overlap."""
    devices = parallel_devices(dev)
    stats = dict(devices=[str(d) for d in devices],
                 two_cards=devices[0] != devices[1])
    stats["raft"] = parallel_raft(devices)
    empty_cache()
    stats["packed_r21d"] = parallel_packed()
    stats["clip_tensor_parallel"] = parallel_clip_tp(devices)
    empty_cache()
    stats["feature_stream"] = parallel_stream()
    empty_cache()
    return stats


#: the multi phase: the vendored sample (320x240, 19.62 fps, 355 frames,
#: no audio track) and the seconds of the seeded WAV that stands in for
#: its rip
SAMPLE_VIDEO = "tests/assets/v_synth_sample.mp4"
SAMPLE_SECONDS = 355 / 19.62
#: families of the multi phase, in the order they are listed
MULTI_FAMILIES = ("i3d", "r21d", "resnet", "clip", "vggish")
#: shared against single runs: float32 on one card, expected 0.0
MULTI_ATOL = 1e-4


def multi_configs(root: str, cache_dir: str, **over) -> dict:
    """The multi phase's configs at published widths: i3d two-stream with
    ``flow_type=raft`` at its YAML defaults (20 iterations, stack = step =
    64, ``flow_stack_batch=auto``, ``clip_batch_size=8``, float32), r21d and
    vggish at their YAML defaults, resnet50 and ViT-B/32 at
    ``batch_size=64``; every family with ``save_numpy``, ``resize=auto``
    (the device resize) and ``cache=true`` into ``cache_dir``, its outputs
    under ``root/<family>``. ``over`` maps a family to its own overrides
    (the CPU test's small sizes)."""
    cfgs = {
        "i3d": slice_config(root, flow_iters=None, flow_stack_batch="auto",
                            clip_batch_size=8, resize="auto"),
        "r21d": clip_config("r21d"),
        "resnet": frame_config("resnet", batch_size=64, resize="auto"),
        "clip": frame_config("clip", batch_size=64, resize="auto"),
        "vggish": vggish_config(),
    }
    for family, cfg in cfgs.items():
        cfg.update(on_extraction="save_numpy", cache=True,
                   cache_dir=cache_dir, cache_scope="shared",
                   retry_attempts=1, output_path=f"{root}/{family}",
                   tmp_path=f"{root}/tmp/{family}")
        cfg.update(over.get(family, {}))
    return cfgs


class StubRip:
    """Stands in for ``utils/io.py extract_wav_from_mp4`` (the sample has no
    audio track and the card's machine no guaranteed ffmpeg): a seeded 16
    kHz mono WAV of ``seconds``, and an empty aac, per call."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.calls = 0

    def __call__(self, video_path: str, tmp_path: str):
        import os
        self.calls += 1
        os.makedirs(tmp_path, exist_ok=True)
        stem = os.path.splitext(os.path.basename(video_path))[0]
        wav = write_wav(os.path.join(tmp_path, f"{stem}.wav"), self.seconds,
                        16000, 1, seed=11)
        aac = os.path.join(tmp_path, f"{stem}.aac")
        open(aac, "wb").close()
        return wav, aac


def read_outputs(root: str) -> dict:
    """``{relative path: array}`` of every ``.npy`` under ``root``."""
    from pathlib import Path
    return {str(p.relative_to(root)): np.load(p)
            for p in sorted(Path(root).rglob("*.npy"))}


def multi_phase(video: str = SAMPLE_VIDEO, seconds: float = SAMPLE_SECONDS,
                timed_turns: bool = True, **over) -> dict:
    """The multi-family run on one video: ``MultiExtractor`` over one
    shared decode (``parallel/fanout.py``) against each family run alone
    (``_extract`` with a private decode), with the same extractors, so the
    same weights. (1) Equality: each family's outputs of the shared run
    against its single run (max abs, limit 1e-4), proj's launches equal in
    both i3d runs. (2) One decode: the frames the bus decoded against the
    sum of the private sources'. (3) Cache: two shared passes with
    ``cache=true`` into a fresh cache and fresh outputs; the second serves
    every family from the store: no frame decoded, no rip, no proj launch,
    outputs bit-equal to the first. (4) Times: the singles once more, warm
    (the storing pass is the warm shared run; into fresh outputs and a fresh
    cache), one profile of a shared run. ``over`` maps a family to its own
    overrides (the CPU test's small sizes)."""
    import cv2  # noqa: F401  (the decode of the mp4; fail here without it)
    import os
    import shutil

    from video_features_tpu_torch.cache import cache_stats
    from video_features_tpu_torch.extractors import vggish as vggish_mod
    from video_features_tpu_torch.extractors.multi import MultiExtractor
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.registry import get_extractor_cls
    from video_features_tpu_torch.utils import io as vio

    root, cache_dir = "output/chip_smoke/multi", "output/chip_smoke/mcache"
    cfgs = multi_configs(root, cache_dir, **over)
    t0 = time.perf_counter()
    exts = {f: get_extractor_cls(f)(cfg) for f, cfg in cfgs.items()}
    build_s = time.perf_counter() - t0
    multi = MultiExtractor(cfgs, extractors=exts)
    rip = StubRip(seconds)
    real_rip = vggish_mod.extract_wav_from_mp4
    vggish_mod.extract_wav_from_mp4 = rip

    def fresh(cache: bool = True) -> None:
        shutil.rmtree(root, ignore_errors=True)
        if cache:
            shutil.rmtree(cache_dir, ignore_errors=True)

    def shared() -> dict:
        """One shared run: wall seconds, frames decoded, rips, proj."""
        rip.calls = 0
        reset_counts(cl)
        synchronize()
        t = time.perf_counter()
        statuses = multi.run_video(video)
        synchronize()
        wall = time.perf_counter() - t
        if statuses != dict.fromkeys(MULTI_FAMILIES, "done"):
            raise AssertionError(f"multi: shared run statuses {statuses}")
        bus = multi.last_session.bus
        return dict(seconds=wall, decoded=bus.decoded if bus else 0,
                    rips=rip.calls, proj=read_counts(cl)["proj"])

    def singles() -> dict:
        """Each family alone, in turn: seconds each, frames decoded."""
        out = dict(seconds={}, decoded=0, rips=0, proj=0)
        rip.calls = 0
        for family, ext in exts.items():
            reset_counts(cl)
            before = vio.decoded_frames()
            synchronize()
            t = time.perf_counter()
            if ext._extract(video) is None:
                raise AssertionError(f"multi: single {family} skipped")
            synchronize()
            out["seconds"][family] = time.perf_counter() - t
            out["decoded"] += vio.decoded_frames() - before
            if family == "i3d":
                out["proj"] = read_counts(cl)["proj"]
        out["rips"] = rip.calls
        return out

    try:
        # the singles first: they set up cuDNN at every shape and give
        # each family's reference outputs
        fresh()
        single0 = singles()
        want = read_outputs(root)
        fresh()
        shared0 = shared()
        got = read_outputs(root)
        if sorted(got) != sorted(want) or not want:
            raise AssertionError(f"multi: outputs {sorted(got)} against "
                                 f"{sorted(want)}")
        max_abs = {}
        for family in MULTI_FAMILIES:
            errs = [float(np.abs(got[k].astype(np.float64)
                                 - want[k].astype(np.float64)).max())
                    if got[k].size else 0.0
                    for k in want if k.startswith(family + "/")]
            if not errs:
                raise AssertionError(f"multi: no outputs of {family}")
            max_abs[family] = max(errs)
            if not max_abs[family] <= MULTI_ATOL:
                raise AssertionError(f"multi: {family} shared vs single "
                                     f"max abs {max_abs[family]}")
        if shared0["proj"] != single0["proj"]:
            raise AssertionError(f"multi: proj launches shared "
                                 f"{shared0['proj']}, single "
                                 f"{single0['proj']}")
        on_card = next(iter(exts.values())).device.type == "cuda"
        if on_card and cfgs["i3d"].get("streams") in (None, "flow") \
                and shared0["proj"] == 0:
            raise AssertionError("multi: proj never launched")
        if not 0 < shared0["decoded"] < single0["decoded"]:
            raise AssertionError(f"multi: the bus decoded "
                                 f"{shared0['decoded']} frames, the "
                                 f"private sources {single0['decoded']}")
        if (shared0["rips"], single0["rips"]) != (1, 1):
            raise AssertionError(f"multi: rips shared {shared0['rips']}, "
                                 f"single {single0['rips']}")

        # (3) the cache: a miss that stores, then all hits
        fresh()
        store_pass = shared()
        first = {k: v.tobytes() for k, v in read_outputs(root).items()}
        fresh(cache=False)
        hit_pass = shared()
        second = {k: v.tobytes() for k, v in read_outputs(root).items()}
        if (hit_pass["decoded"], hit_pass["rips"], hit_pass["proj"]) != \
                (0, 0, 0):
            raise AssertionError(f"multi: the all-hit pass {hit_pass}")
        if second != first:
            raise AssertionError("multi: the all-hit pass's outputs differ "
                                 "from the storing pass's")
        stats = cache_stats(cache_dir)
        if stats["entries"] != len(MULTI_FAMILIES):
            raise AssertionError(f"multi: cache entries {stats}")
        lookup_ms = {}
        for family, ext in exts.items():
            t = time.perf_counter()
            if ext.feature_cache().lookup(video,
                                          ext.output_feat_keys) is None:
                raise AssertionError(f"multi: no entry for {family}")
            lookup_ms[family] = (time.perf_counter() - t) * 1e3

        # (4) times in turns, then one profiled shared run
        turns = {"shared_s": [], "singles_s": [], "singles_by_family": []}
        if timed_turns:
            for kind in ("singles",):
                fresh()
                if kind == "shared":
                    turns["shared_s"].append(shared()["seconds"])
                else:
                    each = singles()["seconds"]
                    turns["singles_s"].append(sum(each.values()))
                    turns["singles_by_family"].append(each)
        fresh()
        profile = profile_call(lambda: multi.run_video(video))
        # the profiled run's store stays: the storage phase accounts and
        # audits it
        fresh(cache=False)
    finally:
        vggish_mod.extract_wav_from_mp4 = real_rip
    n = len(MULTI_FAMILIES)
    shared_s = turns["shared_s"] or [shared0["seconds"]]
    singles_s = turns["singles_s"] or [sum(single0["seconds"].values())]
    return dict(
        video=video, families=list(MULTI_FAMILIES), rip="stub",
        build_s=build_s, max_abs_shared_vs_single=max_abs,
        max_abs_limit=MULTI_ATOL,
        proj_launches={"shared": shared0["proj"],
                       "single": single0["proj"],
                       "all_hit_pass": hit_pass["proj"]},
        frames_decoded={"shared_bus": shared0["decoded"],
                        "singles_sum": single0["decoded"],
                        "all_hit_pass": hit_pass["decoded"]},
        rips={"shared": shared0["rips"], "singles": single0["rips"],
              "all_hit_pass": hit_pass["rips"]},
        cache={"entries": stats["entries"], "bytes": stats["bytes"],
               "by_family": stats["families"],
               "store_pass_s": store_pass["seconds"],
               "hit_pass_s": hit_pass["seconds"],
               "lookup_ms_per_entry": lookup_ms},
        single_seconds_first_run=single0["seconds"],
        turns_seconds=turns,
        shared_extractions_per_s=[n / s for s in shared_s],
        singles_extractions_per_s=[n / s for s in singles_s],
        shared_profile=profile)


#: the telemetry phase: the sample at 7.3 fps is 132 frames, two 64-frame
#: stacks; the run-plane keys it turns on (profile_trace_dir beside them),
#: and the retained history and alerting on top of them
TELEMETRY_ROOT = "output/chip_smoke/telemetry"
TELEMETRY_FPS = 7.3
RUN_PLANE = ("telemetry=true", "trace=true", "health=true", "profile=true",
             "roofline=true", "parity=true")
ALERT_KEYS = ("history=true", "alerts=true")
TELEMETRY_ON = RUN_PLANE + ALERT_KEYS
#: the stages every span of the main path must show
TELEMETRY_STAGES = ("decode", "h2d", "forward", "write")
#: the trace spans the phase requires (profiler stages and the attempt)
TELEMETRY_SPANS = ("decode", "h2d", "forward", "write", "health",
                   "video_attempt")


def telemetry_argv(root: str, video: str, **over) -> list:
    """The CLI arguments of the telemetry phase: i3d two-stream RAFT at the
    slice's widths into ``root``; ``over`` replaces keys (the CPU test's
    small sizes)."""
    cfg = dict(feature_type="i3d", flow_type="raft", streams=None,
               flow_iters=None, flow_stack_batch=1, stack_size=STACK,
               step_size=STACK, clip_batch_size=2, resize="device",
               extraction_fps=TELEMETRY_FPS, device="cuda",
               precision="float32", allow_random_weights=True,
               on_extraction="save_numpy", retry_attempts=1,
               compile_cache=False, output_path=f"{root}/out",
               tmp_path=f"{root}/tmp", video_paths=video)
    cfg.update(over)
    return [f"{k}={'null' if v is None else v}" for k, v in cfg.items()]


def check_trace_events(doc: dict, required: dict, spans) -> set:
    """The ``X`` span names of a ``_trace.json`` document; raises unless
    every event carries its phase's required fields and every name of
    ``spans`` is there."""
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise AssertionError("telemetry: _trace.json has no events")
    for ev in events:
        missing = [k for k in required.get(ev.get("ph"), ("ph",))
                   if k not in ev]
        if missing:
            raise AssertionError(f"telemetry: trace event {ev} lacks "
                                 f"{missing}")
    names = {e["name"] for e in events if e["ph"] == "X"}
    if not set(spans) <= names:
        raise AssertionError(f"telemetry: trace spans {sorted(names)} lack "
                             f"{sorted(set(spans) - names)}")
    return names


def telemetry_phase(video: str = SAMPLE_VIDEO, **over) -> dict:
    """The main path through ``cli.main`` with the run plane off, then on
    (:data:`TELEMETRY_ON` and ``profile_trace_dir``), from the same seeded
    weights, each run's launch counts set to 0 just before and read just
    after; then every artifact of the on run checked (module docstring,
    step 17). ``over`` replaces CLI keys (the CPU test's small sizes)."""
    import glob
    import os
    import shutil

    import cv2  # noqa: F401  (the decode of the mp4; fail here without it)

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.telemetry import (health, roofline, schema,
                                                    trace)

    root = TELEMETRY_ROOT
    shutil.rmtree(root, ignore_errors=True)
    stem = os.path.splitext(os.path.basename(video))[0]
    again = f"{root}/{stem}_again.mp4"
    os.makedirs(root)
    shutil.copyfile(video, again)
    runs = {}
    # "capture_off": the run plane without the torch.profiler capture, so
    # the capture's own cost shows apart from the recorders'; "repeat": the
    # same over the sample and a copy, whose second dispatch at the same
    # shape runs without the counting pass
    for name, keys, paths in (
            ("off", (), video),
            ("on", TELEMETRY_ON + (f"profile_trace_dir={root}/prof",),
             video),
            ("capture_off", TELEMETRY_ON, video),
            ("repeat", TELEMETRY_ON, f"[{video}, {again}]")):
        argv = telemetry_argv(f"{root}/{name}", paths, **over) + list(keys)
        runs[name] = dict(run_cli(argv, cl), dir=f"{root}/{name}/out/i3d")
    on, off = runs["on"], runs["off"]
    for name, run in runs.items():
        n = 2 if name == "repeat" else 1
        if f"{n} extracted" not in run["stdout"]:
            raise AssertionError(f"telemetry: the {name} run did not "
                                 f"extract: {run['stdout'][-300:]}")

    # the features, bit for bit, and proj's launches in every run
    want = read_outputs(off["dir"])
    stacks = len(want.get(f"{stem}_timestamps_ms.npy", []))
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    proj_want = iters * stacks if on_card else 0
    max_abs = 0.0
    for name, run in runs.items():
        outs = read_outputs(run["dir"])
        again_keys = {k for k in outs if k.startswith(f"{stem}_again_")}
        # each video's outputs, the copy's under the sample's names
        videos = [{k: v for k, v in outs.items() if k not in again_keys}]
        if name == "repeat":
            videos.append({k.replace(f"{stem}_again_", f"{stem}_"): outs[k]
                           for k in again_keys})
        n = len(videos)
        for got in videos:
            if sorted(got) != sorted(want) or not want:
                raise AssertionError(f"telemetry: {name} outputs "
                                     f"{sorted(got)} against {sorted(want)}")
            err = max(float(np.abs(got[k].astype(np.float64)
                                   - want[k].astype(np.float64)).max())
                      if got[k].size else 0.0 for k in want)
            max_abs = max(max_abs, err)
            if err != 0.0 or any(got[k].tobytes() != want[k].tobytes()
                                 for k in want):
                raise AssertionError(f"telemetry: the {name} run's "
                                     f"features differ from the off run's "
                                     f"(max abs {err})")
        if run["launches"] != dict(level=0, proj=n * proj_want, packed=0):
            raise AssertionError(f"telemetry: the {name} run launched "
                                 f"{run['launches']}, proj expected "
                                 f"{n * proj_want} ({stacks} stacks a "
                                 f"video)")

    # the span
    spans = [json.loads(line) for line in
             open(f"{on['dir']}/_telemetry.jsonl") if line.strip()]
    if len(spans) != 1:
        raise AssertionError(f"telemetry: {len(spans)} spans")
    span = spans[0]
    errs = schema.validate(span, schema.load_span_schema())
    stage_s = {k: span["stages"].get(k, {}).get("s", 0.0)
               for k in TELEMETRY_STAGES}
    if errs or span["status"] != "done" or not all(
            v > 0 for v in stage_s.values()):
        raise AssertionError(f"telemetry: span {errs} {span['status']} "
                             f"{span['stages']}")

    # the heartbeat and the manifest
    beats = glob.glob(f"{on['dir']}/_heartbeat_*.json")
    if len(beats) != 1:
        raise AssertionError(f"telemetry: heartbeats {beats}")
    beat = json.load(open(beats[0]))
    manifest = json.load(open(f"{on['dir']}/_run.json"))
    card_name = torch.cuda.get_device_name(0) if on_card else None
    topo = manifest["topology"]
    if not beat["final"] or topo.get("device_name") != card_name or (
            on_card and card_name not in topo.get("device_kinds", [])):
        raise AssertionError(f"telemetry: heartbeat final {beat['final']}, "
                             f"topology {topo}")

    # one valid health record per output key, all finite
    records = [json.loads(line) for line in
               open(f"{on['dir']}/{health.HEALTH_FILENAME}")
               if line.strip()]
    keys = sorted(k[len(stem) + 1:-4] for k in want)
    bad = [r for r in records if health.validate_health(r)
           or r["nan"] or r["inf"]]
    if sorted(r["key"] for r in records) != keys or bad:
        raise AssertionError(f"telemetry: health records "
                             f"{[r['key'] for r in records]} for {keys}, "
                             f"bad {bad}")

    # the host trace and the device trace
    required = {"X": trace.REQUIRED_X_FIELDS, "i": trace.REQUIRED_I_FIELDS,
                "C": trace.REQUIRED_C_FIELDS, "M": trace.REQUIRED_M_FIELDS}
    host_spans = check_trace_events(
        json.load(open(f"{on['dir']}/{trace.TRACE_FILENAME}")), required,
        TELEMETRY_SPANS)
    prof = glob.glob(f"{root}/prof/*.pt.trace.json")
    if len(prof) != 1 or f"profile trace: {prof[0]}" not in on["stdout"]:
        raise AssertionError(f"telemetry: profiler traces {prof}")
    device_events = [e for e in json.load(open(prof[0]))["traceEvents"]
                     if e.get("cat") == "kernel"]
    proj_events = [e for e in device_events
                   if "proj_kernel" in e.get("name", "")]
    if on_card and len(proj_events) != proj_want:
        raise AssertionError(f"telemetry: the profiler trace holds "
                             f"{len(proj_events)} proj kernels of "
                             f"{len(device_events)} device events, "
                             f"{proj_want} expected")
    if "[profile: i3d x 1 videos] total accounted:" not in on["stdout"]:
        raise AssertionError("telemetry: no profile summary printed")
    rooflines = {name: check_roofline(
        json.load(open(f"{runs[name]['dir']}/{roofline.ROOFLINE_FILENAME}")),
        card_name, proj_want) for name in ("on", "capture_off", "repeat")}
    # the repeat run times its uncounted dispatch alone; the capture_off
    # run's one dispatch is its counted one, counting pass included
    rep = rooflines["repeat"]
    if rep["dispatches"] != 2 or rep["forward_calls"] != 1 or rooflines[
            "capture_off"]["forward_calls"] != 1:
        raise AssertionError(f"telemetry: repeat run dispatches "
                             f"{rep['dispatches']}, timed "
                             f"{rep['forward_calls']}")
    counting_pass_s = (rooflines["capture_off"]["forward_s"]
                       - rep["forward_s"])
    seams = check_parity(f"{on['dir']}/{parity.PARITY_FILENAME}")
    if not beat["roofline"].get("families") or not beat["parity"].get(
            "records") or manifest["roofline"].get("schema") != \
            roofline.SCHEMA_VERSION:
        raise AssertionError(f"telemetry: heartbeat roofline "
                             f"{beat['roofline']}, parity {beat['parity']}, "
                             f"manifest roofline {manifest['roofline']}")
    alert_plane = {name: check_alert_plane(runs[name]["dir"],
                                           runs[name]["stdout"])
                   for name in ("on", "capture_off", "repeat")}
    return dict(
        video=video, fps=TELEMETRY_FPS, stacks=stacks,
        wall_s={name: run["wall_s"] for name, run in runs.items()},
        max_abs_on_vs_off=max_abs,
        proj_launches={name: run["launches"]["proj"]
                       for name, run in runs.items()},
        span_stages=span["stages"], span_wall_s=span["wall_s"],
        stage_totals=manifest["stage_totals"],
        health_records=len(records), trace_spans=sorted(host_spans),
        trace_events=len(json.load(open(
            f"{on['dir']}/{trace.TRACE_FILENAME}"))["traceEvents"]),
        profiler_device_events=len(device_events),
        profiler_proj_kernels=len(proj_events),
        profiler_trace_bytes=os.path.getsize(prof[0]),
        topology_device_name=topo.get("device_name"),
        roofline=rooflines, counting_pass_s=counting_pass_s,
        parity_seams=seams,
        heartbeat_roofline=beat["roofline"], heartbeat_parity=beat["parity"],
        alert_plane=alert_plane)


def check_alert_plane(out_dir: str, stdout: str) -> dict:
    """The retained history and the alerting of one ``history=true
    alerts=true`` run in ``out_dir``: one ``_history_*.jsonl`` of at least
    two ``vft.history_sample/1`` samples, the last one the final
    heartbeat's (its ``mfu`` equal to the heartbeat's roofline MFU where
    the run counts it); the heartbeat's ``alerts`` section with no rule
    failure; both hooks registered and none failed; no history write
    failure in the manifest; no firing record but ``mfu_regression``'s,
    which is returned as a finding of the run rather than failed (its
    threshold is the JAX package's). Returns the sample count, the
    journal's (rule, state) transitions and those findings."""
    import glob
    import os

    from video_features_tpu_torch.telemetry import alerts, history, jsonl

    files = glob.glob(f"{out_dir}/{history.HISTORY_GLOB}")
    samples = history.read_history(out_dir)
    beat = json.load(open(glob.glob(f"{out_dir}/_heartbeat_*.json")[0]))
    series = samples.get(beat["host_id"], [])
    manifest = json.load(open(f"{out_dir}/_run.json"))
    if len(files) != 1 or len(series) < 2 or len(samples) != 1 or any(
            s.get("schema") != history.SAMPLE_SCHEMA for s in series):
        raise AssertionError(f"alerts: history {files}, {len(series)} "
                             f"samples of {list(samples)}")
    last = series[-1]
    fams = (beat.get("roofline") or {}).get("families") or {}
    if not last["final"] or last["videos"] != history.sample_from_heartbeat(
            beat)["videos"] or any(
            (last.get("mfu") or {}).get(f) != v.get("mfu")
            for f, v in fams.items()):
        raise AssertionError(f"alerts: the last sample {last} is not the "
                             f"final heartbeat's (roofline {fams})")
    section = beat.get("alerts")
    write_failures = [s for s in manifest["metrics"]["series"]
                      if s["name"] == "vft_telemetry_write_failures_total"]
    if not isinstance(section, dict) or section.get("eval_errors") != 0 \
            or "heartbeat hooks: 2 registered, 0 failed" not in stdout \
            or write_failures:
        raise AssertionError(f"alerts: heartbeat section {section}, write "
                             f"failures {write_failures}, hooks "
                             f"{[ln for ln in stdout.splitlines() if 'hook' in ln]}")
    records = list(jsonl.read_jsonl(
        os.path.join(out_dir, alerts.ALERTS_FILENAME)))
    firing = [r for r in records if r["state"] == "firing"]
    if any(alerts.validate_alert(r) for r in records) or any(
            r["rule"] != "mfu_regression" for r in firing):
        raise AssertionError(f"alerts: firing on a clean run: {firing}")
    return dict(samples=len(series), last_mfu=last.get("mfu"),
                samples_with_mfu=sum(
                    any(v is not None for v in (s.get("mfu") or {}).values())
                    for s in series),
                transitions=[(r["rule"], r["state"]) for r in records],
                mfu_regression=[{k: r[k] for k in (
                    "scope", "value", "threshold", "summary")}
                    for r in firing])


#: the alerts phase: one 64-frame stack of the sample (4 fps: 72 frames),
#: an ENOSPC injected at the first feature write, one attempt
ALERTS_FPS = 4.0
ALERTS_INJECT = "seed=0;sink.fsync=enospc@n1"
ALERTS_ROOT = "output/chip_smoke/alerts"
#: the heartbeat intervals of the cost turns (None: the YAML default, 30 s)
ALERTS_INTERVALS = (0.3, None)
#: evaluations timed on a clean run's tree
EVAL_REPS = 20
PROM_LINE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.e+-]+$'


def run_cli(argv, cl) -> dict:
    """``cli.main(argv)`` with the launch counts set to 0 just before and
    read just after: its wall, launches and stdout."""
    import contextlib
    import io

    from video_features_tpu_torch import cli

    buf = io.StringIO()
    reset_counts(cl)
    synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    synchronize()
    return dict(wall_s=time.perf_counter() - t, launches=read_counts(cl),
                stdout=buf.getvalue())


def alerts_phase(video: str = SAMPLE_VIDEO, intervals=ALERTS_INTERVALS,
                 **over) -> dict:
    """The alerting on the main path (module docstring, step 18): the
    telemetry phase's argv over one stack with :data:`ALERTS_INJECT`,
    ``retry_attempts=1``, ``metrics_interval_s=0.3`` and ``telemetry trace
    roofline history alerts`` fires one ``failure_spike`` with a bundle,
    which a later one-shot evaluation resolves; then the cost turns; then
    the rules' evaluation timed on a clean run's tree. ``over`` replaces
    CLI keys (the CPU test's small sizes)."""
    import contextlib
    import glob
    import io
    import os
    import shutil

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.telemetry import alerts, history, jsonl

    shutil.rmtree(ALERTS_ROOT, ignore_errors=True)
    os.makedirs(ALERTS_ROOT)
    stem = os.path.splitext(os.path.basename(video))[0]
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    card_name = torch.cuda.get_device_name(0) if on_card else None

    # the fault run: its one stack runs through RAFT, then the write fails
    argv = telemetry_argv(f"{ALERTS_ROOT}/fault", video, **{
        "extraction_fps": ALERTS_FPS, **over}) + [
        "telemetry=true", "trace=true", "roofline=true", *ALERT_KEYS,
        "metrics_interval_s=0.3", f"inject={ALERTS_INJECT}"]
    fault = run_cli(argv, cl)
    out_dir = f"{ALERTS_ROOT}/fault/out/i3d"
    proj_want = iters if on_card else 0
    if "0 extracted" not in fault["stdout"] or "1 failed" not in \
            fault["stdout"] or fault["launches"] != dict(
            level=0, proj=proj_want, packed=0):
        raise AssertionError(f"alerts: the fault run launched "
                             f"{fault['launches']}, proj expected "
                             f"{proj_want}: {fault['stdout'][-400:]}")
    records = list(jsonl.read_jsonl(
        f"{out_dir}/{alerts.ALERTS_FILENAME}"))
    firing = [r for r in records if r["state"] == "firing"]
    if any(alerts.validate_alert(r) for r in records) or \
            [r["rule"] for r in firing] != ["failure_spike"] or \
            not firing[0]["incident"]:
        raise AssertionError(f"alerts: records {records}")
    bundle = f"{out_dir}/{firing[0]['incident']}"
    errs = alerts.verify_incident(bundle)
    man = json.load(open(f"{bundle}/manifest.json"))
    paths = [a["path"] for a in man["artifacts"]]
    rf = (json.load(open(f"{bundle}/roofline.json"))
          if "roofline.json" in paths else {})
    beat = json.load(open(glob.glob(f"{out_dir}/_heartbeat_*.json")[0]))
    samples = history.read_history(out_dir).get(beat["host_id"], [])
    if errs or not (rf.get("device") or {}).get("device_kind") or (
            on_card and rf["device"]["device_kind"] != card_name) or not any(
            "_failures" in p for p in paths) or not samples or samples[-1][
            "videos"]["error"] != 1 or beat["alerts"]["eval_errors"] != 0 \
            or "heartbeat hooks: 2 registered, 0 failed" not in \
            fault["stdout"]:
        raise AssertionError(f"alerts: bundle {errs} {paths}, roofline "
                             f"{rf.get('device')}, {len(samples)} samples, "
                             f"heartbeat alerts {beat.get('alerts')}")
    # the failure leaves a window shrunk below the time since: resolved
    time.sleep(0.3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = alerts.main([out_dir, "--window", "0.05"])
    final = list(jsonl.read_jsonl(
        f"{out_dir}/{alerts.ALERTS_FILENAME}"))
    if rc != 0 or alerts.current_alerts(out_dir) or final[-1]["state"] != \
            "resolved" or final[-1]["alert_id"] != firing[0]["alert_id"]:
        raise AssertionError(f"alerts: not resolved: rc {rc}, "
                             f"{final[-1]}: {buf.getvalue()[-300:]}")
    fault_stats = dict(
        wall_s=fault["wall_s"], proj_launches=fault["launches"]["proj"],
        history_samples=len(samples),
        transitions=[(r["rule"], r["state"]) for r in final],
        bundle_artifacts=len(paths),
        bundle_bytes=sum(a["bytes"] for a in man["artifacts"]),
        bundle_paths=paths, bundle_roofline_device=rf["device"])

    # the cost turns: the run plane without and with history and alerts,
    # off then on at each interval; each run's launches and features, its
    # CLI wall and its video's span wall (the part the ticks run beside)
    walls, planes, last_on = {}, {}, None
    want = None
    for interval in intervals:
        key = str(interval or "default")
        walls[key] = {"off": [], "on": [], "span_off": [], "span_on": []}
        for turn, on in enumerate((False, True)):
            name = f"{key}_{'on' if on else 'off'}{turn}"
            argv = telemetry_argv(f"{ALERTS_ROOT}/{name}", video, **over) \
                + list(RUN_PLANE) + list(ALERT_KEYS if on else ()) + (
                    [f"metrics_interval_s={interval}"] if interval else [])
            run = run_cli(argv, cl)
            run_dir = f"{ALERTS_ROOT}/{name}/out/i3d"
            outs = read_outputs(run_dir)
            stacks = len(outs.get(f"{stem}_timestamps_ms.npy", []))
            want = outs if want is None else want
            if "1 extracted" not in run["stdout"] or sorted(outs) != sorted(
                    want) or any(outs[k].tobytes() != want[k].tobytes()
                                 for k in want) or run["launches"] != dict(
                    level=0, packed=0, proj=stacks * proj_want):
                raise AssertionError(f"alerts: turn {name} launched "
                                     f"{run['launches']} for {stacks} "
                                     f"stacks, or its features differ")
            walls[key]["on" if on else "off"].append(run["wall_s"])
            span, = jsonl.read_jsonl(f"{run_dir}/_telemetry.jsonl")
            walls[key]["span_on" if on else "span_off"].append(
                span["wall_s"])
            if on:
                planes[name] = check_alert_plane(run_dir, run["stdout"])
                last_on = run_dir
            elif glob.glob(f"{run_dir}/_history_*.jsonl") or os.path.exists(
                    f"{run_dir}/{alerts.ALERTS_FILENAME}"):
                raise AssertionError(f"alerts: turn {name} has history or "
                                     "alerts with both keys off")

    # what one tick's evaluation costs on a clean run's tree: the rules
    # over observe_root, as the heartbeat thread runs them
    eng = alerts.AlertEngine(last_on, capture_incidents=False)
    eval_s, observe_s = [], []
    for _ in range(EVAL_REPS):
        t = time.perf_counter()
        alerts.observe_root(last_on)
        observe_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        if eng.evaluate():
            raise AssertionError(f"alerts: a clean run's tree fires: "
                                 f"{alerts.current_alerts(last_on)}")
        eval_s.append(time.perf_counter() - t)
    return dict(
        fault=fault_stats, walls_s=walls, planes=planes,
        eval_ms_per_tick=1e3 * float(np.median(eval_s)),
        observe_root_ms=1e3 * float(np.median(observe_s)),
        eval_tree=last_on, eval_errors=eng.eval_errors)


def fleet_step(roots: dict, card_name=None) -> dict:
    """The fleet report over each phase root (module docstring, step 19):
    every current host ``FINISHED``, i3d throughput from the spans, the
    roofline roll-up naming the card; the Prometheus textfile parses; one
    stitched trace with a lane per host trace and their ``video_attempt``
    and ``forward`` spans, the host spans the proj launches ran under; the
    port's run report renders the alerts phase's fault run and its
    ``--fail-on-alert`` gate passes after the resolve."""
    import contextlib
    import io
    import re

    from video_features_tpu_torch import fleet_report
    from video_features_tpu_torch.telemetry import metrics, report

    out = {}
    line = re.compile(PROM_LINE)
    for name, root in roots.items():
        agg = fleet_report.aggregate(root)
        hosts = [e for e in agg["hosts"] if not e["prior_run"]]
        fam = agg["families"].get("i3d") or {}
        rf = agg["roofline"] or {}
        kind = (rf.get("device") or {}).get("device_kind")
        if not hosts or {e["state"] for e in hosts} != {"FINISHED"} or \
                not fam.get("done") or fam.get("s_per_video") is None or \
                not kind or (card_name is not None and kind != card_name):
            raise AssertionError(f"fleet {name}: hosts "
                                 f"{[e['state'] for e in hosts]}, i3d "
                                 f"{fam}, roofline device {kind}")
        text = metrics.prometheus_text(fleet_report.build_prom_dump(agg))
        body = [ln for ln in text.splitlines()
                if ln.strip() and not ln.startswith("#")]
        traces = fleet_report.find_trace_files(root)
        path, merged = fleet_report.stitch(root)
        names = {e["name"] for e in merged["traceEvents"]
                 if e.get("ph") == "X"}
        if not body or not all(line.match(ln) for ln in body) or \
                path is None or len(merged["otherData"]["hosts"]) != \
                len(traces) or not {"video_attempt", "forward"} <= names \
                or not merged["otherData"]["aligned"]:
            raise AssertionError(f"fleet {name}: prom {body[:3]}, stitch "
                                 f"{path} of {len(traces)} traces, spans "
                                 f"{sorted(names)}")
        out[name] = dict(hosts=len(hosts), i3d=fam, roofline_device=kind,
                         roofline_mfu=rf["families"].get("i3d", {}).get(
                             "mfu"),
                         prom_series=len(body), stitched_lanes=len(traces),
                         stitched_events=len(merged["traceEvents"]))
    fault_dir = f"{roots['alerts']}/fault/out/i3d"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = report.main([fault_dir, "--fail-on-alert"])
    text = buf.getvalue()
    if rc != 0 or "== heartbeats ==" not in text or "FATAL=1" not in text:
        raise AssertionError(f"fleet: report rc {rc}: {text[-400:]}")
    out["report_lines"] = len(text.splitlines())
    return out


def check_roofline(doc: dict, card_name, proj_want: int) -> dict:
    """A ``_roofline.json`` of the telemetry phase: valid under the port's
    schema, one i3d family with work counted. On a card: the device named
    from the registry, at least the proj launches' declared operations at
    the slice's shapes among the FLOPs, ``0 < mfu <= 1``, effective TFLOPS
    at most the peak and one of the four verdicts. Returns the family's
    numbers and the device block."""
    from video_features_tpu_torch.telemetry import roofline

    errs = roofline.validate_roofline(doc)
    fam = doc["families"].get("i3d") or {}
    if errs or not fam.get("flops_total", 0) > 0 or not fam.get(
            "dispatches"):
        raise AssertionError(f"telemetry: _roofline.json {errs} {fam}")
    dev = doc["device"]
    if card_name is not None:
        least = proj_want * kernel_work("proj", STACK * GRID_H * GRID_W,
                                        0)[1]
        mfu, eff = fam.get("mfu"), fam.get("effective_tflops")
        if dev.get("device_kind") != card_name \
                or dev.get("source") != "registry" \
                or fam["flops_total"] < least or mfu is None \
                or not 0 < mfu <= 1 or eff > dev["peak_tflops"] \
                or fam.get("verdict") not in roofline.VERDICTS:
            raise AssertionError(f"telemetry: roofline device {dev}, family "
                                 f"{fam}, proj's declared operations "
                                 f"{least}")
    return dict(device=dev, **{k: v for k, v in fam.items()
                               if k != "programs"},
                programs=fam["programs"])


#: the seams the i3d path taps, as JAX's i3d does: its RAFT flow stays on
#: the card, so the backbone seam is the raft family's (the certify phase)
I3D_SEAMS = ("decode", "transform", "head")


def check_parity(path: str) -> dict:
    """The ``_parity.jsonl`` of the telemetry phase: every record valid
    under the port's schema, records at each of :data:`I3D_SEAMS` and at
    no other seam. Returns the count per seam."""
    records = [json.loads(line) for line in open(path) if line.strip()]
    bad = [r for r in records if parity.validate_parity(r)]
    seams = {s: sum(r["seam"] == s for r in records) for s in parity.SEAMS}
    if bad or {s for s, n in seams.items() if n} != set(I3D_SEAMS):
        raise AssertionError(f"telemetry: parity records by seam {seams}, "
                             f"invalid {bad[:2]}")
    return seams


#: the certify phase: each family's bfloat16 flip over the vendored sample
CERTIFY_FLIPS = (("raft", "dtype=bf16"), ("pwc", "dtype=bf16"))
#: the families whose bfloat16 verdict on the port's seeded weights may be
#: the weight draw's FAIL, and the factor on their band's ``max_abs`` that
#: still holds them: RAFT's flip read 1.31-2.80 px over four seeded weight
#: draws, FAILing its 2.0 px band on two of them in the port and in the
#: JAX package alike (``tools/certify_seeds.py``, PERF.md). Its ``cos``
#: band holds as it stands.
DRAW_BOUND_FAMILIES = ("raft",)
DRAW_SPREAD = 1.5


def certify_phase(video: str = SAMPLE_VIDEO, **over) -> dict:
    """``parity.certify`` of each family's bfloat16 flip over the sample on
    the card (``over``: config overrides for both arms, the CPU test's
    small sizes). Held: each verdict valid under the port's schema, every
    seam captured, the ``decode`` and ``transform`` seams within their
    bands (host work in float32 that no numerics flip may reach: drift
    there is a leak), and the verdict ``PASS``. A family of
    :data:`DRAW_BOUND_FAMILIES` is held instead at ``backbone`` and
    ``head`` to its band's ``cos`` and to :data:`DRAW_SPREAD` times its
    ``max_abs``. Returns each verdict's per-seam numbers."""
    import os
    import shutil

    root = "output/chip_smoke/certify"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for family, flip in CERTIFY_FLIPS:
        t = time.perf_counter()
        doc = parity.certify(family, flip=flip, videos=[video],
                             out_dir=os.path.join(root, family),
                             extra_overrides=dict({"device": "cuda"},
                                                  **over))
        errs = parity.validate_verdict(doc)
        out[family] = dict(
            flip=flip, verdict=doc["verdict"],
            first_drift=doc["first_drift"], seconds=time.perf_counter() - t,
            seams={s: {k: m[k] for k in ("pairs", "max_abs", "mean_abs",
                                         "cos", "tol_max_abs", "tol_cos")}
                   for s, m in doc["seams"].items()})
        print(json.dumps({"certify": {family: out[family]}}))
        leaked = [s for s in ("decode", "transform")
                  if not doc["seams"][s]["ok"]]
        empty = [s for s, m in doc["seams"].items() if not m["pairs"]]
        if errs or leaked or empty:
            raise AssertionError(f"certify {family} {flip}: {errs}, drift "
                                 f"upstream of the device at {leaked}, no "
                                 f"captures at {empty}")
        if family in DRAW_BOUND_FAMILIES:
            off = [s for s in ("backbone", "head")
                   if not (doc["seams"][s]["cos"]
                           >= parity.tolerance_for(family, s)["cos"]
                           and doc["seams"][s]["max_abs"] <= DRAW_SPREAD
                           * parity.tolerance_for(family, s)["max_abs"])]
            if off:
                raise AssertionError(f"certify {family} {flip}: outside "
                                     f"{DRAW_SPREAD}x its band at {off}: "
                                     f"{out[family]['seams']}")
        elif doc["verdict"] != "PASS":
            raise AssertionError(f"certify {family} {flip}: "
                                 f"{doc['verdict']}, first drift at "
                                 f"{doc['first_drift']}: "
                                 f"{out[family]['seams']}")
    return out


def alerts_plane_line(telemetry_stats: dict, alerts_stats: dict,
                      card: str) -> dict:
    """The numbers of the retained history and the alerting, each run's
    beside the card's ``nvidia-smi`` name and power limit: history samples
    per run, the fault run's transitions and bundle, one tick's
    evaluation, and the main path's walls without and with ``history``
    and ``alerts`` at each heartbeat interval."""
    fault = alerts_stats["fault"]
    samples = {f"telemetry_{k}": v["samples"]
               for k, v in telemetry_stats["alert_plane"].items()}
    samples.update({f"turn_{k}": v["samples"]
                    for k, v in alerts_stats["planes"].items()})
    samples["fault"] = fault["history_samples"]
    findings = [f for p in list(telemetry_stats["alert_plane"].values())
                + list(alerts_stats["planes"].values())
                for f in p["mfu_regression"]]
    return dict(card=card, history_samples=samples,
                transitions=fault["transitions"],
                bundle_artifacts=fault["bundle_artifacts"],
                bundle_bytes=fault["bundle_bytes"],
                eval_ms_per_tick=alerts_stats["eval_ms_per_tick"],
                observe_root_ms=alerts_stats["observe_root_ms"],
                walls_s=alerts_stats["walls_s"],
                mfu_regression_on_clean_runs=findings)


# -- the serving plane (steps 21-23) ------------------------------------------

SERVE_ROOT = "output/chip_smoke/serve"
COMPILE_ROOT = "output/chip_smoke/compile_cache"
FLEET_ROOT = "output/chip_smoke/fleet_queue"
#: copies of the sample the fleet phase's queue drains
FLEET_VIDEOS = 3
#: seconds one request, CLI run or subprocess of the serving phases may
#: take before the phase fails
SERVING_TIMEOUT_S = 600


def http_json(base: str, method: str, path: str, body=None):
    """One HTTP call to the gateway: ``(status, JSON body)``."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_terminal(base: str, rid: str) -> dict:
    """Poll ``GET /v1/requests/{rid}`` until the terminal record."""
    deadline = time.monotonic() + SERVING_TIMEOUT_S
    while True:
        code, body = http_json(base, "GET", f"/v1/requests/{rid}")
        if code == 200:
            return body
        if code != 202 or time.monotonic() > deadline:
            raise AssertionError(f"serve: request {rid} -> {code} {body}")
        time.sleep(0.02)


def check_bit_equal(got: dict, want: dict, what: str) -> None:
    if not want or sorted(got) != sorted(want) or any(
            got[k].tobytes() != want[k].tobytes()
            or got[k].shape != want[k].shape for k in want):
        raise AssertionError(f"{what}: outputs {sorted(got)} differ from "
                             f"{sorted(want)}")


def stem_outputs(outs: dict, stem: str) -> dict:
    """The outputs of one video (``{stem}_{key}.npy``) under ``key``."""
    return {k[len(stem) + 1:]: v for k, v in outs.items()
            if k.startswith(f"{stem}_") and not k[len(stem) + 1:].startswith(
                ("copy_", "again_"))}


@contextlib.contextmanager
def running_server(cfg, tenants=None):
    """An in-process ``ServeLoop`` on ``cfg`` in a thread behind a
    ``GatewayServer`` on ``127.0.0.1`` at an ephemeral port (``tenants``
    its tenant table), yielded once the server is ready as a dict with
    ``loop``, ``base`` (the gateway's URL) and ``construction_s``; on exit
    both stop, the dict gains the gateway's final ``gateway_section`` and
    the loop's ``rc``, and the loop must have exited."""
    import threading

    from video_features_tpu_torch import gateway, serve

    spool = str(cfg.spool_dir)
    t0 = time.perf_counter()
    loop = serve.ServeLoop(cfg, out_root=str(cfg.output_path))
    server = dict(loop=loop, construction_s=time.perf_counter() - t0)
    rcs = []
    thread = threading.Thread(target=lambda: rcs.append(loop.run()),
                              name="chip-smoke-serve", daemon=True)
    thread.start()
    args = {"spool_dir": spool, "gateway_host": "127.0.0.1",
            "gateway_port": 0, "gateway_poll_interval_s": 0.02,
            "metrics_interval_s": 0.5}
    if tenants is not None:
        args["gateway_tenants"] = tenants
    gw = gateway.GatewayServer(args).start()
    server["base"] = f"http://127.0.0.1:{gw.port}"
    try:
        deadline = time.monotonic() + SERVING_TIMEOUT_S
        while serve.server_state(spool).get("state") != "ready":
            if time.monotonic() > deadline or not thread.is_alive():
                raise AssertionError(f"serve: not ready: "
                                     f"{serve.server_state(spool)}")
            time.sleep(0.02)
        yield server
    finally:
        loop.stop()
        thread.join(timeout=SERVING_TIMEOUT_S)
        server["gateway_section"] = gw._gateway_section()
        gw.stop()
    if thread.is_alive() or rcs not in ([0], [143]):
        raise AssertionError(f"serve: the loop did not exit ({rcs})")
    server["rc"] = rcs[0]


def serve_phase(video: str = SAMPLE_VIDEO, **over) -> dict:
    """Warm serving through the gateway (module docstring, step 21): an
    in-process ``ServeLoop`` on the telemetry phase's i3d RAFT slice with
    ``cache=true`` behind a ``GatewayServer`` on ``127.0.0.1`` at an
    ephemeral port; three HTTP requests (the sample, a byte-identical copy,
    one whose ``timeout_s`` has passed), counts set to 0 just before each
    and read just after; then ``cli.main`` on the sample."""
    import os
    import shutil

    from video_features_tpu_torch import serve
    from video_features_tpu_torch.config import (load_config, parse_dotlist,
                                                 sanity_check)
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils.io import decoded_frames

    root = SERVE_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    video = os.path.abspath(video)
    stem = os.path.splitext(os.path.basename(video))[0]
    copy = os.path.abspath(f"{root}/{stem}_copy.mp4")
    shutil.copyfile(video, copy)
    spool = f"{root}/spool"
    argv = telemetry_argv(f"{root}/served", video, **over) + [
        "cache=true", f"cache_dir={root}/cache", f"spool_dir={spool}",
        "serve_poll_interval_s=0.02", "metrics_interval_s=0.5",
        "serve_max_requests=3", f"serve_idle_exit_s={SERVING_TIMEOUT_S}"]
    cfg = load_config("i3d", parse_dotlist(argv))
    sanity_check(cfg, require_videos=False)
    requests = {}
    with running_server(cfg) as server:
        for name, path, timeout_s in (("first", video, None),
                                      ("copy", copy, None),
                                      ("expired", video, 1e-3)):
            body = {"video_paths": [path]}
            if timeout_s is not None:
                body["timeout_s"] = timeout_s
            synchronize()
            reset_counts(cl)
            frames0 = decoded_frames()
            t = time.perf_counter()
            code, accepted = http_json(server["base"], "POST",
                                       "/v1/extract", body)
            if code != 202:
                raise AssertionError(f"serve: {name} -> {code} {accepted}")
            term = wait_terminal(server["base"], accepted["id"])
            synchronize()
            requests[name] = dict(
                id=accepted["id"], status=term["status"],
                launches=read_counts(cl),
                frames_decoded=decoded_frames() - frames0,
                round_trip_s=time.perf_counter() - t,
                queue_wait_s=term.get("wait_s"),
                service_s=term.get("latency_s"),
                compile_cache=term.get("compile_cache"),
                expired_at=term.get("expired_at"))

    served = read_outputs(str(cfg.output_path))
    want = stem_outputs(served, stem)
    stacks = len(want.get("timestamps_ms.npy", []))
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    proj_want = iters * stacks if on_card else 0
    first, again, late = (requests[k] for k in ("first", "copy", "expired"))
    none = dict(level=0, proj=0, packed=0)
    if first["status"] != "done" or first["launches"] != dict(
            none, proj=proj_want) or not stacks:
        raise AssertionError(f"serve: request 1 {first}, {stacks} stacks, "
                             f"proj {proj_want} expected")
    # the copy: a feature-cache hit that decodes nothing and launches none
    if again["status"] != "done" or again["launches"] != none or \
            again["frames_decoded"] != 0:
        raise AssertionError(f"serve: request 2 (the copy) {again}")
    check_bit_equal(stem_outputs(served, f"{stem}_copy"), want,
                    "serve: the copy")
    expired_path = f"{spool}/{serve.EXPIRED_DIR}/{late['id']}.json"
    if late["status"] != "deadline_exceeded" or \
            serve.read_response(spool, late["id"]) is not None or \
            not os.path.exists(expired_path) or late["launches"] != none:
        raise AssertionError(f"serve: request 3 {late}")
    state = serve.server_state(spool)
    tallies = state.get("requests") or {}
    edge = server["gateway_section"]["tenants"].get("anon", {})
    if state.get("state") != "exited" or tallies.get("done") != 2 or any(
            tallies.get(k) for k in ("partial", "failed", "rejected")) or \
            tallies.get("deadline_exceeded", 0) + edge.get("expired", 0) \
            != 1 or edge.get("accepted") != 3 or \
            edge.get("responded") != 2:
        raise AssertionError(f"serve: final heartbeat {state}, gateway "
                             f"{edge}")

    # request 1's features against cli.main's on the same video
    cli_run = run_cli(telemetry_argv(f"{root}/cli", video, **over), cl)
    check_bit_equal(stem_outputs(read_outputs(f"{root}/cli/out/i3d"),
                                 stem), want, "serve: cli.main")
    if cli_run["launches"] != dict(none, proj=proj_want):
        raise AssertionError(f"serve: cli.main launched "
                             f"{cli_run['launches']}")
    return dict(
        video=video, stacks=stacks,
        warm_construction_s=server["construction_s"], requests=requests,
        server=state, gateway=edge, cli_wall_s=cli_run["wall_s"],
        loop_rc=server["rc"])


def module_env(**env) -> dict:
    """The environment of a ``python -m video_features_tpu_torch``
    subprocess: this one, the checkout on ``PYTHONPATH``, ``env`` over."""
    import os
    from pathlib import Path
    out = dict(os.environ)
    repo = str(Path(__file__).resolve().parent)
    out["PYTHONPATH"] = repo + (os.pathsep + out["PYTHONPATH"]
                                if out.get("PYTHONPATH") else "")
    out.update(env)
    return out


def start_module(args, env=None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "video_features_tpu_torch", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=module_env(**(env or {})))


def finish_module(proc: subprocess.Popen, what: str) -> dict:
    try:
        out, err = proc.communicate(timeout=SERVING_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: timed out") from None
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}: "
                             f"{(out + err)[-1500:]}")
    return dict(stdout=out, stderr=err)


def run_module(args, what: str, env=None) -> dict:
    """``python -m video_features_tpu_torch ARGS`` in a subprocess: its
    wall and its output; fails on a non-zero exit."""
    t = time.perf_counter()
    res = finish_module(start_module(args, env), what)
    return dict(res, wall_s=time.perf_counter() - t)


def compile_cache_phase(video: str = SAMPLE_VIDEO, env=None,
                        **over) -> dict:
    """The kernel compile cache across processes (module docstring, step
    22): from a fresh store, ``warmup`` of the slice's config, a warm
    join, and a join after the sealed library's bytes were flipped.
    ``env`` goes to every subprocess (the CPU test's stand-in ``nvcc``)."""
    import glob
    import hashlib
    import os
    import shutil

    from video_features_tpu_torch.kernels import build

    root = COMPILE_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    store = os.path.abspath(f"{root}/store")

    def keys(name):
        return telemetry_argv(f"{root}/{name}", video, **over) + [
            "telemetry=true", "compile_cache=true",
            f"compile_cache_dir={store}"]

    warm = run_module(["warmup", *keys("warmup")], "compile: warmup", env)
    entries = glob.glob(f"{store}/i3d/*/*/_entry.json")
    if len(entries) != 1 or "built 1 library" not in warm["stdout"]:
        raise AssertionError(f"compile: warmup entries {entries}: "
                             f"{warm['stdout'][-500:]}")
    entry_dir = os.path.dirname(entries[0])
    lib = os.path.join(entry_dir, build.library_name())

    def sealed() -> dict:
        with open(os.path.join(entry_dir, "_sums.json")) as f:
            return json.load(f)["files"]

    def sha(path) -> str:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    manifest = json.load(open(entries[0]))
    if not manifest["kernels"] or manifest["files"] != 2 or \
            sealed().get(build.library_name(), {}).get("sha256") != sha(lib):
        raise AssertionError(f"compile: the warmup entry {manifest}")

    def section(name) -> dict:
        return json.load(open(f"{root}/{name}/out/i3d/_run.json"))[
            "compile_cache"]

    before = (os.stat(lib).st_mtime_ns, sha(lib))
    hit = run_module(keys("warm"), "compile: warm join", env)
    warm_cc = section("warm")
    if warm_cc.get("misses") != 0 or warm_cc.get("hits", 0) < 1 or \
            not warm_cc.get("warm_at_attach") or warm_cc.get("dropped") or \
            (os.stat(lib).st_mtime_ns, sha(lib)) != before:
        raise AssertionError(f"compile: the warm join {warm_cc}")

    good = open(lib, "rb").read()
    flipped = bytearray(good)
    flipped[len(flipped) // 2] ^= 0xFF
    with open(lib, "wb") as f:
        f.write(bytes(flipped))
    flipped_sha = sha(lib)
    cold = run_module(keys("corrupt"), "compile: corrupt join", env)
    cold_cc = section("corrupt")
    # one nvcc run; on the card one hit after it (the kernel library's
    # load resolves the rebuilt file)
    if cold_cc.get("misses") != 1 or cold_cc.get("hits", 0) > 1 or \
            cold_cc.get("dropped", 0) < 1 or cold_cc.get("warm_at_attach") \
            or "sha mismatch" not in cold["stderr"] or \
            sha(lib) == flipped_sha or \
            sealed()[build.library_name()]["sha256"] != sha(lib):
        raise AssertionError(f"compile: the corrupt join {cold_cc}: "
                             f"{cold['stderr'][-500:]}")
    check_bit_equal(read_outputs(f"{root}/corrupt/out/i3d"),
                    read_outputs(f"{root}/warm/out/i3d"),
                    "compile: the rebuilt library's run")
    return dict(
        warmup_wall_s=warm["wall_s"], warm_join_wall_s=hit["wall_s"],
        cold_join_wall_s=cold["wall_s"], warm_join=warm_cc,
        cold_join=cold_cc, entry=manifest["env"], library_bytes=len(good),
        rebuilt_identical=open(lib, "rb").read() == good)


def fleet_corpus(video: str, n_videos: int = FLEET_VIDEOS) -> list:
    """The absolute paths of the fleet phase's copies of ``video``."""
    import os
    stem = os.path.splitext(os.path.basename(video))[0]
    return [os.path.abspath(f"{FLEET_ROOT}/{stem}_fleet{i}.mp4")
            for i in range(n_videos)]


def fleet_keys(root: str, videos, **over) -> list:
    """The CLI arguments of the fleet phase's runs over ``videos`` into
    ``root``: the slice with ``telemetry health``, a 0.5 s heartbeat, and
    ``compile_cache=false`` (a joiner's canary keeps the cold-build timing
    band; the compile-cache phase holds the warm join). ``over`` replaces
    keys (``fleet``, the CPU test's small sizes)."""
    return telemetry_argv(root, "[" + ",".join(videos) + "]", **over) + [
        "telemetry=true", "health=true", "metrics_interval_s=0.5",
        "compile_cache=false"]


def fleet_queue_phase(video: str = SAMPLE_VIDEO, n_videos: int = FLEET_VIDEOS,
                      **over) -> dict:
    """The work-stealing queue (module docstring, step 23): a static
    single-host run over copies of the sample, one ``fleet=queue`` worker,
    two concurrent workers on one root, a third host joining with
    ``fleet_canary=true``; then the fleet report and the alert
    observation over that queue root and the serve phase's spool."""
    import glob
    import os
    import shutil

    from video_features_tpu_torch import fleet_report
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.parallel.queue import QUEUE_DIRNAME
    from video_features_tpu_torch.telemetry import alerts

    root = FLEET_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    copies = fleet_corpus(video, n_videos)
    for copy in copies:
        shutil.copyfile(video, copy)

    def keys(name, **kw):
        return fleet_keys(f"{root}/{name}", copies, **over, **kw)

    single = run_cli(keys("single", fleet="static"), cl)
    want = read_outputs(f"{root}/single/out/i3d")
    one = run_module(keys("one", fleet="queue"), "fleet: one worker")
    t = time.perf_counter()
    workers = [start_module(keys("two", fleet="queue")) for _ in range(2)]
    outs = [finish_module(p, f"fleet: worker {i}")
            for i, p in enumerate(workers)]
    makespan_2 = time.perf_counter() - t
    qroot = f"{root}/two/out/i3d"
    done = [json.load(open(p)) for p in sorted(
        glob.glob(f"{qroot}/{QUEUE_DIRNAME}/done/*.json"))]
    counts = {d: len(os.listdir(f"{qroot}/{QUEUE_DIRNAME}/{d}"))
              for d in ("pending", "quarantined")}
    if sorted(d["video"] for d in done) != sorted(copies) or \
            any(counts.values()) or {d["status"] for d in done} != {"done"}:
        raise AssertionError(f"fleet: done {[d['video'] for d in done]}, "
                             f"{counts}")
    by_host = {}
    for d in done:
        by_host[d["by"]] = by_host.get(d["by"], 0) + 1
    for name in ("one", "two"):
        check_bit_equal(read_outputs(f"{root}/{name}/out/i3d"), want,
                        f"fleet: the {name}-worker queue")
    beats = [json.load(open(p))
             for p in glob.glob(f"{qroot}/_heartbeat_*.json")]
    fleets = [b.get("fleet") or {} for b in beats]
    if len(beats) != 2 or any(f.get("mode") != "queue" for f in fleets) or \
            sum(f.get("done", 0) for f in fleets) != n_videos:
        raise AssertionError(f"fleet: heartbeat fleet sections {fleets}")

    canary = run_module(keys("two", fleet="queue", fleet_canary="true"),
                        "fleet: the canary host")
    verdicts = [json.load(open(p)) for p in glob.glob(
        f"{qroot}/{QUEUE_DIRNAME}/canary/*.json")]
    digest_lines = [ln for v in verdicts for ln in v["lines"]
                    if "digest(s) compared" in ln]
    if len(verdicts) != 1 or not verdicts[0]["ok"] or not digest_lines or \
            not digest_lines[0].endswith("PASS") or \
            "0 extracted" not in canary["stdout"]:
        raise AssertionError(f"fleet: canary {verdicts}: "
                             f"{canary['stdout'][-500:]}")

    # the fleet report and the alert observation over both roots
    agg_q = fleet_report.aggregate(qroot)
    agg_s = fleet_report.aggregate(f"{SERVE_ROOT}/spool")
    obs_q = alerts.observe_root(qroot)
    obs_s = alerts.observe_root(f"{SERVE_ROOT}/spool")
    serve_hosts = [e for e in obs_s["hosts"]
                   if (e.get("hb") or {}).get("serve")]
    # the workers' kernel build: a hit on the card (the library this
    # process built), none on the CPU
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    if (agg_q["queue"] or {}).get("done") != n_videos or \
            (obs_q["queue"] or {}).get("done") != n_videos or \
            (agg_q["compile_cache"]["hits"] < 1) == on_card or \
            agg_q["compile_cache"]["misses"] or \
            agg_s["serve"]["totals"]["requests"] < 2 or not serve_hosts or \
            "hits" not in (serve_hosts[0]["hb"].get("compile_cache") or {}):
        raise AssertionError(f"fleet: report queue {agg_q['queue']}, "
                             f"compile cache {agg_q['compile_cache']}, "
                             f"serve {agg_s['serve']['totals']}")
    return dict(
        videos=n_videos, single_wall_s=single["wall_s"],
        single_proj_launches=single["launches"]["proj"],
        makespan_one_worker_s=one["wall_s"], makespan_two_workers_s=
        makespan_2, done_by_host=sorted(by_host.values()),
        canary_lines=verdicts[0]["lines"],
        report_queue=agg_q["queue"], report_compile_cache=agg_q[
            "compile_cache"], report_serve=agg_s["serve"]["totals"],
        observe_hosts={"queue": len(obs_q["hosts"]),
                       "spool": len(obs_s["hosts"])},
        worker_stdout_tail=[o["stdout"].splitlines()[-1:] for o in outs])


# -- the storage lifecycle plane (step 24) -------------------------------------

STORAGE_ROOT = "output/chip_smoke/storage"
#: the earlier phases' trees: each one's ``gc`` root, the stores accounted
#: with it, the planes that phase wrote (each must hold bytes), and the
#: root its audit runs over (``--expect-complete``: every phase drained)
#: with the store that audit re-verifies
STORAGE_TREES = {
    "serve": dict(root=f"{SERVE_ROOT}/spool", cache_dir=f"{SERVE_ROOT}/cache",
                  planes=("cache", "spool", "journals"), audit=SERVE_ROOT),
    "compile_cache": dict(root=COMPILE_ROOT,
                          compile_dir=f"{COMPILE_ROOT}/store",
                          planes=("compile",), audit=COMPILE_ROOT),
    "fleet_queue": dict(root=f"{FLEET_ROOT}/two/out/i3d",
                        planes=("journals",), audit=FLEET_ROOT),
    "telemetry": dict(root="output/chip_smoke/telemetry/on/out/i3d",
                      planes=("journals",),
                      audit="output/chip_smoke/telemetry"),
    "alerts": dict(root=f"{ALERTS_ROOT}/fault/out/i3d",
                   planes=("incidents", "journals"), audit=ALERTS_ROOT),
    "multi": dict(root="output/chip_smoke/mcache",
                  cache_dir="output/chip_smoke/mcache", planes=("cache",),
                  audit="output/chip_smoke/mcache",
                  audit_cache_dir="output/chip_smoke/mcache"),
}
#: a quota below any store (one byte; a quota must be > 0): every cache
#: entry is over it
EVICT_ALL_QUOTA_GB = 1e-9
#: a SIGKILL between the sweep's second journal append and that unlink
GC_KILL_INJECT = "seed=7;gc.evict=kill@n2"
#: the compile store's retention in the pruning sweep, and the planted
#: foreign entry's idle age
COMPILE_RETENTION_S = 60
FOREIGN_AGE_S = 1000


def tree_listing(*dirs) -> dict:
    """``{path: (bytes, mtime_ns)}`` of every file under ``dirs``."""
    import os
    out = {}
    for d in dirs:
        for dirpath, _dirs, files in os.walk(d):
            for fn in files:
                p = os.path.join(dirpath, fn)
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
    return out


def audit_trees(trees: dict, phase: str = "storage") -> dict:
    """``python -m video_features_tpu_torch audit`` over each tree's audit
    root with ``--expect-complete`` (and its store re-verified), all at
    once; fails unless each passes with 0 violations. Returns each one's
    verdict and counts."""
    import re
    procs = {}
    for name, tree in trees.items():
        args = ["audit", tree["audit"], "--expect-complete"]
        if tree.get("audit_cache_dir"):
            args += ["--cache-dir", tree["audit_cache_dir"]]
        procs[name] = start_module(args)
    verdicts = {}
    for name, proc in procs.items():
        out = finish_module(proc, f"{phase}: audit {name}")["stdout"]
        m = re.search(r"AUDIT: (PASS|FAIL) \((\d+) violation\(s\), (\d+) "
                      r"note\(s\)\)", out)
        if m is None or m.group(1) != "PASS" or m.group(2) != "0":
            raise AssertionError(f"{phase}: audit {name}: {out[-1500:]}")
        verdicts[name] = dict(verdict=m.group(1), violations=0,
                              notes=int(m.group(3)))
    return verdicts


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def storage_phase(video: str = SAMPLE_VIDEO, trees=None, reference=None,
                  env=None, **over) -> dict:
    """The storage lifecycle over the earlier phases' trees (module
    docstring, step 24): the ``gc`` command's dry-run accounting of each
    tree, the monitor on the main path (``gc=true``), eviction as a
    recoverable miss, a SIGKILLed sweep that audits clean and converges,
    the compile store's pruning with a warm join after it, and the audit
    of every tree. ``trees`` defaults to :data:`STORAGE_TREES`;
    ``reference`` is the outputs directory of a plain run of the slice
    (step 17's off run by default); ``env`` goes to the warm join's
    subprocess (the CPU test's stand-in ``nvcc``); ``over`` replaces CLI
    keys (the CPU test's small sizes)."""
    import glob
    import hashlib
    import os
    import shutil
    import signal

    from video_features_tpu_torch import compile_cache
    from video_features_tpu_torch import gc as vgc
    from video_features_tpu_torch.audit import audit_run
    from video_features_tpu_torch.config import (load_config, parse_dotlist,
                                                 sanity_check)
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.telemetry import history, jsonl
    from video_features_tpu_torch.utils.io import decoded_frames

    t_phase = time.perf_counter()
    trees = STORAGE_TREES if trees is None else trees
    reference = reference or "output/chip_smoke/telemetry/off/out/i3d"
    root = STORAGE_ROOT
    shutil.rmtree(root, ignore_errors=True)
    none_dir = os.path.abspath(f"{root}/none")  # a store no tree names
    os.makedirs(none_dir)
    stem = os.path.splitext(os.path.basename(video))[0]
    want = stem_outputs(read_outputs(reference), stem)
    stacks = len(want.get("timestamps_ms.npy", []))
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    proj_want = iters * stacks if on_card else 0
    none = dict(level=0, proj=0, packed=0)
    if not stacks:
        raise AssertionError(f"storage: no outputs in {reference}")

    def stores(tree: dict) -> dict:
        return dict(cache_dir=tree.get("cache_dir", none_dir),
                    compile_dir=tree.get("compile_dir", none_dir))

    # 1. accounting: a dry run of the gc command over each tree, all at
    # once; every plane that phase wrote holds bytes, nothing is deleted
    dirs = [d for t in trees.values() for d in (t["root"], *stores(
        t).values())]
    before = tree_listing(*dirs)
    procs = {name: start_module(
        ["gc", t["root"], "--cache-dir", stores(t)["cache_dir"],
         "--compile-dir", stores(t)["compile_dir"], "--dry-run", "--json"])
        for name, t in trees.items()}
    accounting, usage_walk_s = {}, {}
    for name, proc in procs.items():
        res = last_json(finish_module(proc, f"storage: gc {name}")["stdout"])
        planes = {p: v["bytes"] for p, v in res["usage"]["planes"].items()}
        if not res["dry_run"] or res["executed"] or any(
                not planes.get(p) for p in trees[name]["planes"]):
            raise AssertionError(f"storage: gc {name}: planes {planes}, "
                                 f"{trees[name]['planes']} wanted")
        accounting[name] = dict(planes=planes, planned=res["planned"],
                                total_bytes=res["usage"]["total_bytes"])
        t = time.perf_counter()
        vgc.usage(trees[name]["root"], **stores(trees[name]))
        usage_walk_s[name] = time.perf_counter() - t
    if tree_listing(*dirs) != before:
        raise AssertionError("storage: a dry run changed a tree")

    # 2. the monitor on the main path (gc=true), accounting the serve
    # phase's cache and the compile store as the stores' default
    # locations (where the JAX CLI's monitor walks), the quota twice their
    # measured use
    env_stores = {
        "VFT_CACHE_DIR": stores(trees.get("serve", {}))["cache_dir"],
        "VFT_COMPILE_CACHE_DIR":
            stores(trees.get("compile_cache", {}))["compile_dir"]}
    env_stores = {k: os.path.abspath(v) for k, v in env_stores.items()}
    mdir = f"{root}/monitor/out/i3d"
    measured = vgc.usage(mdir, cache_dir=env_stores["VFT_CACHE_DIR"],
                         compile_dir=env_stores["VFT_COMPILE_CACHE_DIR"])[
        "total_bytes"]
    quota_gb = 2.0 * measured / 1e9
    saved = {k: os.environ.get(k) for k in env_stores}
    os.environ.update(env_stores)
    try:
        monitor = run_cli(telemetry_argv(f"{root}/monitor", video, **over) + [
            "telemetry=true", "history=true", "alerts=true", "gc=true",
            f"gc_quota_gb={quota_gb!r}", "metrics_interval_s=0.5"], cl)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    beat = json.load(open(glob.glob(f"{mdir}/_heartbeat_*.json")[0]))
    gauge = [s.get("value") for s in json.load(open(f"{mdir}/_run.json"))[
        "metrics"]["series"] if s["name"] == "vft_gc_used_bytes"]
    samples = history.read_history(mdir).get(beat["host_id"], [])
    sec = beat.get("gc") or {}
    check_bit_equal(stem_outputs(read_outputs(mdir), stem), want,
                    "storage: the gc=true run")
    if monitor["launches"] != dict(none, proj=proj_want) or not measured \
            or not sec.get("used_bytes") or sec.get("quota_bytes") != int(
            quota_gb * 1e9) or not (sec.get("planes") or {}).get("cache") \
            or not (sec.get("planes") or {}).get("compile") or not gauge \
            or not gauge[0] or not samples or samples[-1].get(
            "gc", {}).get("used_bytes") != sec["used_bytes"] or \
            "heartbeat hooks: 2 registered, 0 failed" not in \
            monitor["stdout"] or beat["alerts"]["eval_errors"]:
        raise AssertionError(f"storage: the monitor run launched "
                             f"{monitor['launches']}, gc section {sec}, "
                             f"gauge {gauge}, {len(samples)} samples: "
                             f"{monitor['stdout'][-400:]}")
    disk_alerts = [r["state"] for r in jsonl.read_jsonl(
        f"{mdir}/_alerts.jsonl") if r["rule"] == "disk_pressure"]

    # 3. eviction is a recoverable miss: fill a cache, hit it, evict every
    # entry (each journaled before its unlink), run the video again
    cache = os.path.abspath(f"{root}/cache")
    gcroot = os.path.abspath(f"{root}/gcroot")
    os.makedirs(gcroot)

    def cached(name: str) -> dict:
        frames0 = decoded_frames()
        run = run_cli(telemetry_argv(f"{root}/{name}", video, **over) + [
            "cache=true", f"cache_dir={cache}"], cl)
        return dict(run, frames=decoded_frames() - frames0, outs=stem_outputs(
            read_outputs(f"{root}/{name}/out/i3d"), stem))

    def pkls() -> list:
        return sorted(glob.glob(f"{cache}/**/*.pkl", recursive=True))

    fill, hit = cached("fill"), cached("hit")
    entries = pkls()
    if fill["launches"] != dict(none, proj=proj_want) or \
            hit["launches"] != none or hit["frames"] or not entries:
        raise AssertionError(f"storage: fill {fill['launches']}, hit "
                             f"{hit['launches']} ({hit['frames']} frames), "
                             f"{len(entries)} entries")
    check_bit_equal(fill["outs"], want, "storage: the cache fill")
    check_bit_equal(hit["outs"], want, "storage: the cache hit")
    t = time.perf_counter()
    evict = vgc.sweep(gcroot, vgc.GcConfig.from_args(
        {"gc_quota_gb": EVICT_ALL_QUOTA_GB}), cache_dir=cache,
        compile_dir=none_dir)
    sweep_s = time.perf_counter() - t
    journal = [r for jp in glob.glob(f"{gcroot}/{vgc.GC_JOURNAL_GLOB}")
               for r in jsonl.read_jsonl(jp)]
    if pkls() or sorted(r["path"] for r in journal
                        if r["plane"] == "cache") != entries or \
            evict["executed"].get("cache", {}).get("deleted") != \
            len(entries):
        raise AssertionError(f"storage: eviction {evict['executed']}, "
                             f"journal {journal}")
    refill = cached("refill")
    if refill["launches"] != dict(none, proj=proj_want) or \
            not refill["frames"]:
        raise AssertionError(f"storage: the refill launched "
                             f"{refill['launches']} and decoded "
                             f"{refill['frames']} frames")
    check_bit_equal(refill["outs"], fill["outs"], "storage: the refill")

    # 4. crash-safe deletion: the refill's entry and two cold entries (the
    # planner reads only their mtimes), then the gc command SIGKILLed
    # between its second journal append and that unlink; the remains audit
    # clean with the journaled remnant as a note; a rerun converges
    old = time.time() - 3600.0
    for i in range(2):
        fake = f"{cache}/ff/ff{i:02d}dead.pkl"
        os.makedirs(os.path.dirname(fake), exist_ok=True)
        with open(fake, "wb") as f:
            f.write(b"x" * 2048)
        os.utime(fake, (old, old))
    n_entries = len(pkls())
    flags = [gcroot, "--cache-dir", cache, "--compile-dir", none_dir,
             "--quota-gb", repr(EVICT_ALL_QUOTA_GB)]
    proc = start_module(["gc", *flags], {"VFT_INJECT": GC_KILL_INJECT})
    try:
        _out, err = proc.communicate(timeout=SERVING_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("storage: the killed sweep timed out") \
            from None
    killed_audit = audit_run(gcroot)
    if proc.returncode != -signal.SIGKILL or len(pkls()) != n_entries - 1 \
            or not killed_audit[0] or not any(
            "gc-journaled" in n for n in killed_audit[2]):
        raise AssertionError(f"storage: the killed sweep exited "
                             f"{proc.returncode} with {len(pkls())} of "
                             f"{n_entries} entries, audit {killed_audit}: "
                             f"{err[-800:]}")
    rerun = last_json(run_module(["gc", *flags, "--json"],
                                 "storage: the gc rerun")["stdout"])
    converged_audit = audit_run(gcroot)
    if pkls() or not converged_audit[0] or any(
            "gc-journaled" in n for n in converged_audit[2]):
        raise AssertionError(f"storage: the rerun left {pkls()}, audit "
                             f"{converged_audit}")

    # 5. the compile store: a copy of the card's sealed entry under a
    # foreign fingerprint, idle FOREIGN_AGE_S, is pruned past
    # COMPILE_RETENTION_S by a sweep in a process attached to the card's
    # entry, which stays; then a warm join of the slice hits
    store = os.path.abspath(stores(trees.get("compile_cache", {}))[
        "compile_dir"])
    sealed = glob.glob(f"{store}/i3d/*/*/{compile_cache.MANIFEST_NAME}")
    if len(sealed) != 1:
        raise AssertionError(f"storage: compile store entries {sealed}")
    card_entry = os.path.dirname(sealed[0])
    foreign_key = hashlib.sha256(b"a foreign environment").hexdigest()
    foreign = f"{store}/i3d/{foreign_key[:2]}/{foreign_key}"
    shutil.copytree(card_entry, foreign)
    man_path = f"{foreign}/{compile_cache.MANIFEST_NAME}"
    man = json.load(open(man_path))
    man["env_fp"] = hashlib.sha256(b"another toolkit").hexdigest()
    with open(man_path, "w") as f:
        json.dump(man, f)
    os.utime(foreign, (time.time() - FOREIGN_AGE_S,) * 2)

    def join_keys(name: str) -> list:
        return telemetry_argv(f"{root}/{name}", video, **over) + [
            "telemetry=true", "compile_cache=true",
            f"compile_cache_dir={store}"]

    cfg = load_config("i3d", parse_dotlist(join_keys("attached")))
    sanity_check(cfg)
    attached_here = compile_cache.active() is None
    entry = compile_cache.attach_for_args("i3d", cfg)
    try:
        t = time.perf_counter()
        prune = vgc.sweep(os.path.abspath(f"{root}/compile_gc"),
                          vgc.GcConfig(compile_retention_s=COMPILE_RETENTION_S),
                          cache_dir=none_dir, compile_dir=store)
        prune_s = time.perf_counter() - t
    finally:
        if attached_here:
            compile_cache.detach_for_tests()
    if entry is None or entry.dir != card_entry or os.path.exists(
            foreign) or not os.path.isdir(card_entry) or \
            prune["executed"].get("compile", {}).get("deleted") != 1 or \
            prune["planned"] != 1:
        raise AssertionError(f"storage: the compile sweep {prune['executed']}"
                             f", attached {entry and entry.dir}, card entry "
                             f"{card_entry}")
    join = run_module(join_keys("join"), "storage: the warm join", env)
    join_cc = json.load(open(f"{root}/join/out/i3d/_run.json"))[
        "compile_cache"]
    # on the card the attach and the kernels' load each count a hit
    if join_cc.get("misses") != 0 or join_cc.get("hits", 0) < (
            2 if on_card else 1) or not join_cc.get("warm_at_attach"):
        raise AssertionError(f"storage: the warm join {join_cc}")
    check_bit_equal(stem_outputs(read_outputs(f"{root}/join/out/i3d"), stem),
                    want, "storage: the warm join")

    # 6. every tree audits clean, this phase's own among them
    audits = audit_trees(dict(trees, storage=dict(audit=root)))
    audits.update(
        gc_killed=dict(verdict="PASS", violations=0,
                       notes=len(killed_audit[2])),
        gc_converged=dict(verdict="PASS", violations=0,
                          notes=len(converged_audit[2])))

    def tally(res: dict) -> dict:
        return dict(planned=res["planned"],
                    planned_bytes=res["planned_bytes"],
                    executed=res["executed"])

    return dict(
        accounting=accounting, usage_walk_s=usage_walk_s,
        monitor=dict(wall_s=monitor["wall_s"], quota_bytes=int(
            quota_gb * 1e9), used_bytes=sec["used_bytes"],
            planes=sec["planes"], history_samples=len(samples),
            disk_pressure=disk_alerts,
            proj_launches=monitor["launches"]["proj"]),
        eviction=dict(tally(evict), entries=len(entries), sweep_s=sweep_s,
                      journal_records=len(journal)),
        fill_wall_s=fill["wall_s"], hit_wall_s=hit["wall_s"],
        refill_wall_s=refill["wall_s"],
        refill_proj_launches=refill["launches"]["proj"],
        killed_sweep=dict(exit=proc.returncode, entries=n_entries,
                          survivors=n_entries - 1, rerun=tally(rerun)),
        compile_prune=dict(tally(prune), sweep_s=prune_s,
                           kept=os.path.basename(card_entry)[:12],
                           pinned=entry.key[:12]),
        warm_join=dict(wall_s=join["wall_s"], compile_cache=join_cc),
        audits=audits, wall_s=time.perf_counter() - t_phase)


# -- seeded traffic and the chaos matrix (steps 25-26) ------------------------

TRAFFIC_ROOT = "output/chip_smoke/traffic"
CHAOS_ROOT = "output/chip_smoke/chaos"
#: the drills, in order, each on a fresh spool and cache
TRAFFIC_SCENARIOS = tuple(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios",
                 f"{name}.yml") for name in ("steady", "burst_shed"))
#: the drills' clock compression on the card. The YAMLs' speedups (30 and
#: 40) suit a 2 ms stub service; a cold served request of the slice takes
#: about 2 s of service on the card, more than steady's 15 s SLO
#: compressed 30-fold, so the card runs the scenarios' own rates on the
#: wall clock
TRAFFIC_SPEEDUP = 1.0
#: the card's cut of each drill's schedule (``duration_s``; the arrival
#: process, rates, tenants, corpus and objectives as the YAML has them):
#: at their own rates the two drills' 73.6 s were the longest phase
#: (NVIDIA H100 80GB HBM3, 700.00 W); steady
#: keeps 15 s (18 requests reach all 6 items), burst_shed 10 s (one whole
#: 5 s train)
TRAFFIC_DURATION_SCALE = {"steady": 0.5, "burst_shed": 0.25}
#: the journal identity of every drill (and of its dry run)
TRAFFIC_HOST = "lg-chip-smoke"
#: seed -> fault plan of the chaos phase: the tier-1 rows of the JAX
#: package's matrix (tests/test_chaos.py CHAOS_PLANS 0 and 1)
CHAOS_PLANS = {0: "seed=0;decode.read=eio@n3",
               1: "seed=1;sink.fsync=eio@n1"}
#: copies of the sample each chaos run extracts
CHAOS_VIDEOS = 2


def traffic_phase(video: str = SAMPLE_VIDEO, scenarios=TRAFFIC_SCENARIOS,
                  speedup=TRAFFIC_SPEEDUP, stub_s=None, reference=None,
                  duration_scale=None, **over) -> dict:
    """Seeded traffic through the gateway (module docstring, step 25): for
    each scenario, on a fresh spool and cache, an in-process ``ServeLoop``
    on step 21's configuration behind a ``GatewayServer`` with the
    drill's tenant table, and ``loadgen.DrillRunner`` driving the
    scenario's offered schedule at ``speedup`` (None: the YAML's) over a
    corpus of the sample with a suffix per item, counts set to 0 just
    before and read just after. ``reference`` is the outputs directory of
    step 21's server (its request 1); ``stub_s`` replaces the video step
    with a sleep (the CPU test's stub service, which writes no
    features); ``duration_scale`` maps a scenario's name to the factor of
    its ``duration_s`` (a copy of its YAML under the drill's root, which
    the dry run and the drill both read); ``over`` replaces CLI keys."""
    import os
    import shutil

    import yaml

    from video_features_tpu_torch import loadgen, serve
    from video_features_tpu_torch.config import (load_config, parse_dotlist,
                                                 sanity_check)
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.telemetry import schema as tschema
    from video_features_tpu_torch.utils.io import decoded_frames

    stem = os.path.splitext(os.path.basename(video))[0]
    want = {}
    if stub_s is None:
        want = stem_outputs(read_outputs(
            reference or f"{SERVE_ROOT}/served/out/i3d"), stem)
        if not want:
            raise AssertionError("traffic: no reference outputs")
    stacks = len(want.get("timestamps_ms.npy", []))
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    per_item = iters * stacks if on_card else 0
    none = dict(level=0, proj=0, packed=0)
    scenario_schema = tschema.load_schema(tschema.SCENARIO_SCHEMA_PATH)
    shutil.rmtree(TRAFFIC_ROOT, ignore_errors=True)
    drills, trees = {}, {}
    for path in scenarios:
        spec = loadgen.load_scenario(path)
        name = spec["scenario"]
        root = f"{TRAFFIC_ROOT}/{name}"
        os.makedirs(root)
        scale = (duration_scale or {}).get(name, 1.0)
        if scale != 1.0:
            with open(path) as f:
                raw = yaml.safe_load(f)
            raw["duration_s"] = spec["duration_s"] * scale
            path = f"{root}/{name}.yml"
            with open(path, "w") as f:
                yaml.safe_dump(raw, f, sort_keys=False)
            spec = loadgen.load_scenario(path)
        spool, cache = f"{root}/spool", f"{root}/cache"
        rate = float(speedup if speedup is not None else spec["speedup"])
        # the replay proof: the drill's journal is this dry run's
        if loadgen.loadgen_main([path, "--spool", spool, "--out",
                                 f"{root}/dry", "--host-id", TRAFFIC_HOST,
                                 "--dry-run"]) != 0:
            raise AssertionError(f"traffic: {name}: the dry run failed")
        tenants = f"{root}/tenants.yml"
        loadgen.write_tenant_table([spec], tenants, rate)
        corpus = loadgen.synthesize_corpus(f"{root}/corpus", [spec],
                                           sample=video)
        argv = telemetry_argv(f"{root}/served", video, **over) + [
            "cache=true", f"cache_dir={cache}", f"spool_dir={spool}",
            "serve_poll_interval_s=0.02", "metrics_interval_s=0.5"]
        cfg = load_config("i3d", parse_dotlist(argv))
        sanity_check(cfg, require_videos=False)
        with running_server(cfg, tenants) as server:
            if stub_s is not None:
                server["loop"]._run_one_video = \
                    lambda v, f=cfg.feature_type: (time.sleep(stub_s)
                                                   or {f: "done"})
            runner = loadgen.DrillRunner(
                [spec], spool, server["base"], corpus=corpus, speedup=rate,
                host_id=TRAFFIC_HOST, audit_root=root, cache_dir=cache,
                drain_timeout_s=SERVING_TIMEOUT_S, http_timeout_s=60)
            synchronize()
            reset_counts(cl)
            frames0 = decoded_frames()
            t = time.perf_counter()
            report = runner.run()
            synchronize()
            drill_s = time.perf_counter() - t
            launches = read_counts(cl)
            frames = decoded_frames() - frames0

        # the journal is the dry run's, byte for byte; the artifact is
        # valid and its tallies reconcile with the journal
        dry = f"{root}/dry/{loadgen.journal_filename(TRAFFIC_HOST)}"
        with open(runner.journal_path, "rb") as a, open(dry, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"traffic: {name}: the journal is not "
                                     "the dry run's")
        with open(f"{spool}/{loadgen.SCENARIO_FILENAME}") as f:
            art = json.load(f)
        errs = tschema.validate(art, scenario_schema)
        offered = [e for e in loadgen.offered_events(spec)
                   if e["event"] == "request"]
        tally = {k: art[k] for k in ("offered", "admitted", "completed",
                                     "expired", "rejected", "shed",
                                     "errors")}
        if errs or art != report or art["offered"] != len(offered) or \
                art["admitted"] + art["rejected"] + art["shed"] + \
                art["errors"] != art["offered"] or \
                art["admitted"] != art["completed"] + art["expired"]:
            raise AssertionError(f"traffic: {name}: the artifact {errs} "
                                 f"{tally}")
        # the items served: each one's first request ran cold (proj 20
        # launches a stack), every later one was a cache hit (none)
        videos = {e["id"]: e["videos"] for e in offered}
        done = sorted({v for lg_id, o in runner.outcomes.items()
                       if o["gw_id"] and (serve.read_terminal(
                           spool, o["gw_id"]) or {}).get("status") == "done"
                       for v in videos[lg_id]})
        if stub_s is None:
            served = read_outputs(str(cfg.output_path))
            for item in done:
                check_bit_equal(stem_outputs(served, item), want,
                                f"traffic: {name}: {item}")
        if launches != dict(none, proj=per_item * len(done)):
            raise AssertionError(f"traffic: {name}: launches {launches}, "
                                 f"{len(done)} cold items x {per_item}")
        if name == "steady" and art["verdict"] != "PASS":
            from video_features_tpu_torch.audit import audit_run
            raise AssertionError(
                f"traffic: steady {art['verdict']}: {art['objectives']}, "
                f"audit {art['audit']}: "
                f"{audit_run(root, cache_dir=cache, expect_complete=True)}")
        if name == "burst_shed" and not any(
                o.get("tenant") == "beta" and "min_rejected" in o
                and o["met"] for o in art["objectives"]):
            raise AssertionError(f"traffic: burst_shed: beta was not shed: "
                                 f"{art['objectives']}")
        trees[name] = dict(audit=root, audit_cache_dir=cache)
        drills[name] = dict(
            speedup=rate, verdict=art["verdict"], audit=art["audit"],
            objectives=[{k: o[k] for k in o if k != "scenario"}
                        for o in art["objectives"]],
            **tally,
            tenants={t: {k: v[k] for k in ("offered", "admitted",
                                           "completed", "rejected", "shed",
                                           "attainment_pct")}
                     for t, v in art["tenants"].items()},
            latency=art["latency"],
            items_served=len(done), stacks_per_item=stacks,
            launches=launches, frames_decoded=frames,
            warm_construction_s=server["construction_s"],
            drill_wall_s=drill_s,
            duration_s=spec["duration_s"])
    audits = audit_trees(trees, "traffic")
    for name, verdict in audits.items():
        drills[name]["audit_command"] = verdict
    return drills


def chaos_phase(video: str = SAMPLE_VIDEO, compare_min_stage_s=None,
                **over) -> dict:
    """The chaos matrix on the main path (module docstring, step 26): the
    slice's CLI over :data:`CHAOS_VIDEOS` copies of the sample with
    ``fleet=queue telemetry=true health=true cache=true`` (the YAML's
    ``retry_attempts``), once clean and once per seed of
    :data:`CHAOS_PLANS`, counts set to 0 just before each and read
    just after; then the port's ``audit --expect-complete`` over each
    tree, ``compare`` of each seed against the clean run and ``compare
    --selftest``; ``compare_min_stage_s`` is ``compare``'s
    ``--min-stage-s`` (None: its default). ``over`` replaces CLI keys."""
    import os
    import shutil
    from pathlib import Path

    from video_features_tpu_torch.kernels import corr_lookup as cl

    root = CHAOS_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    videos = []
    for i in range(CHAOS_VIDEOS):
        dst = os.path.abspath(f"{root}/v_chaos_{i}.mp4")
        shutil.copyfile(video, dst)
        videos.append(dst)
    iters = int(over.get("flow_iters") or ITERS)
    on_card = torch.device(over.get("device", "cuda")).type == "cuda"
    keys = dict(dict(retry_attempts=3), **over)

    def run(name, plan=None) -> dict:
        argv = telemetry_argv(f"{root}/{name}", "[" + ",".join(videos) + "]",
                              **keys) + [
            "fleet=queue", "telemetry=true", "health=true", "cache=true",
            f"cache_dir={root}/{name}/cache"]
        if plan is not None:
            argv.append(f"inject={plan}")
        res = run_cli(argv, cl)
        out = Path(f"{root}/{name}/out")
        res["npy"] = {str(p.relative_to(out)): p.read_bytes()
                      for p in sorted(out.rglob("*.npy"))}
        return res

    runs = {"clean": run("clean")}
    runs.update({f"seed{seed}": run(f"seed{seed}", plan)
                 for seed, plan in sorted(CHAOS_PLANS.items())})
    clean = runs["clean"]["npy"]
    stamps = [v for k, v in read_outputs(f"{root}/clean/out").items()
              if k.endswith("_timestamps_ms.npy")]
    if len(stamps) != CHAOS_VIDEOS or not len(stamps[0]):
        raise AssertionError(f"chaos: the clean run wrote {sorted(clean)}")
    per_video = iters * len(stamps[0])
    stats = {}
    for name, res in runs.items():
        if res["npy"] != clean:
            raise AssertionError(f"chaos: {name}: outputs differ from the "
                                 f"clean run's ({sorted(res['npy'])})")
        proj = res["launches"]["proj"]
        cold = proj // per_video if per_video else 0
        if res["launches"]["level"] or res["launches"]["packed"] or (
                on_card and (proj % per_video or not 1 <= cold <=
                             2 * CHAOS_VIDEOS)) or (not on_card and proj):
            raise AssertionError(f"chaos: {name}: launches "
                                 f"{res['launches']}, {per_video} a video")
        stats[name] = dict(wall_s=res["wall_s"], launches=res["launches"],
                           extractions=cold, plan=CHAOS_PLANS.get(
                               int(name[4:])) if name != "clean" else None)
    audits = audit_trees({name: dict(audit=f"{root}/{name}/out",
                                     audit_cache_dir=f"{root}/{name}/cache")
                          for name in runs}, "chaos")
    for name in runs:
        stats[name]["audit"] = audits[name]
        if name == "clean":
            continue
        floor = ([] if compare_min_stage_s is None else
                 ["--min-stage-s", str(compare_min_stage_s)])
        cmp = run_module(["compare", f"{root}/clean/out",
                          f"{root}/{name}/out", *floor],
                         f"chaos: compare {name}")
        verdict = cmp["stdout"].strip().splitlines()[-1]
        if not verdict.startswith("vft-compare: PASS"):
            raise AssertionError(f"chaos: compare {name}: {cmp['stdout']}")
        stats[name]["compare"] = verdict
    selftest = run_module(["compare", "--selftest"], "chaos: selftest")
    return dict(runs=stats, videos=CHAOS_VIDEOS, per_video_launches=per_video,
                npy_files=len(clean),
                selftest=selftest["stdout"].strip().splitlines()[-1])


# -- sequence attention, show_pred, the trace report, a killed worker
# (steps 27-30)

#: the one published CLIP tower whose attention crosses a key block: 577
#: tokens ((336 / 14)^2 + 1) of 16 heads of 64 in blocks of 256
SEQUENCE_MODEL = "ViT-L/14@336px"
SEQUENCE_TOKENS, SEQUENCE_HEADS, SEQUENCE_HEAD_DIM = 577, 16, 64
#: frames through each extractor run (batches of 16), and the batch of the
#: attention primitives
SEQUENCE_FRAMES, SEQUENCE_BATCH = 32, 16
#: blockwise against dense, features and primitives: the JAX package's
#: band (tests/test_clip.py)
SEQUENCE_ATOL, SEQUENCE_RTOL = 2e-5, 1e-5
SHOW_PRED_ROOT = "output/chip_smoke/show_pred"
#: the i3d logits through the proj kernel against the plain lookup: the
#: port's I3D logits band against JAX (tests/test_torch_i3d.py); the
#: quantised flow crops may step by one where the two lookups round apart
SHOW_PRED_LOGITS_ATOL = 5e-4
#: the trace report's device time over the telemetry phase's on run, at
#: least: the launch of two RAFT-20 stacks, a ``forward`` stage since the
#: dispatch's launch is one (``parallel/mesh.py``), takes over a second
TRACE_DEVICE_MS_MIN = 100.0
WORKER_KILL_ROOT = "output/chip_smoke/worker_kill"
#: the JAX package's replayable kill (tests/test_chaos.py): SIGKILL at the
#: worker's second per-video attempt
WORKER_KILL_PLAN = "seed=11;worker.kill=kill@n2"
#: the kill phase's lease: a dead worker's claim expires this soon
WORKER_KILL_LEASE_S = 2


def sequence_phase(model_name: str = SEQUENCE_MODEL,
                   n_frames: int = SEQUENCE_FRAMES,
                   batch: int = SEQUENCE_BATCH, shape=None,
                   **over) -> dict:
    """Blockwise attention on the card (module docstring, step 27):
    ``parallel/sequence.py blockwise_attention`` against
    ``dense_attention`` at ``shape`` (ViT-L/14@336px's by default),
    causal and not, each timed; then ``ExtractCLIP`` at ``model_name``
    with ``vision_attn=dense`` and ``blockwise`` over the same seeded
    frames, counts set to 0 just before each run and read just after (no
    lookup kernel), the features within :data:`SEQUENCE_ATOL` /
    :data:`SEQUENCE_RTOL`; frames/s and peak memory of each. No
    ``torch.distributed`` group is made here: ring and Ulysses need one,
    and a group in this process would shard the phases after it.
    ``over`` goes into both configs (the CPU test's ``device=cpu``)."""
    from video_features_tpu_torch.extractors.clip import ExtractCLIP
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.models import clip as clip_model
    from video_features_tpu_torch.parallel.sequence import (
        blockwise_attention, dense_attention)

    device = torch.device(over.get("device", "cuda"))
    on_card = device.type == "cuda"
    shape = shape or (batch, SEQUENCE_TOKENS, SEQUENCE_HEADS,
                      SEQUENCE_HEAD_DIM)
    gen = torch.Generator().manual_seed(27)
    q, k, v = (torch.randn(shape, generator=gen).to(device)
               for _ in range(3))
    prims = {}
    for causal in (False, True):
        def dense():
            return dense_attention(q, k, v, causal=causal)

        def block():
            return blockwise_attention(q, k, v, causal=causal,
                                       block_size=clip_model.BLOCK_SIZE)

        want, got = dense(), block()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=SEQUENCE_ATOL,
                              rtol=SEQUENCE_RTOL):
            raise AssertionError(f"sequence: blockwise against dense "
                                 f"(causal={causal}) max abs err {err}")
        prims["causal" if causal else "full"] = dict(
            max_abs_err=err,
            dense_ms=median_ms(dense, 5, 1) if on_card else None,
            blockwise_ms=median_ms(block, 5, 1) if on_card else None)
    del q, k, v
    empty_cache()

    frames = list(synthetic_frames(n_frames, 47))
    runs, feats = {}, {}
    for impl in clip_model.ATTN_IMPLS:
        ex = ExtractCLIP(frame_config("clip", model_name=model_name,
                                      vision_attn=impl, batch_size=batch,
                                      **over))
        ex.extract_frames(iter(frames[:batch]), 25.0)  # cuDNN set-up
        if on_card:
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(cl)
        out, seconds = timed(ex, frames)
        counts = read_counts(cl)
        f = out["clip"]
        if any(counts.values()) or f.shape != (
                n_frames, ex.cfg.embed_dim) or not np.isfinite(f).all():
            raise AssertionError(f"sequence: clip {model_name} "
                                 f"vision_attn={impl}: launches {counts}, "
                                 f"features {f.shape}")
        feats[impl] = f
        peak = torch.cuda.max_memory_allocated() if on_card else None
        runs[impl] = dict(
            frames_per_s=n_frames / seconds, seconds=seconds,
            launches=counts, max_memory_allocated=peak,
            peak_over_resident=None if peak is None else peak - resident)
        del ex
        empty_cache()
    diff = np.abs(feats["blockwise"].astype(np.float64)
                  - feats["dense"].astype(np.float64))
    if not np.allclose(feats["blockwise"], feats["dense"],
                       atol=SEQUENCE_ATOL, rtol=SEQUENCE_RTOL):
        raise AssertionError(f"sequence: blockwise features against dense: "
                             f"max abs {float(diff.max())}")
    return dict(model_name=model_name, frames=n_frames, batch=batch,
                attention_shape=list(shape),
                block_size=clip_model.BLOCK_SIZE, primitives=prims,
                runs=runs, features_max_abs=float(diff.max()),
                band=dict(atol=SEQUENCE_ATOL, rtol=SEQUENCE_RTOL))


@contextlib.contextmanager
def recorded_predictions(module):
    """Within the block, the rows ``module.show_predictions_on_dataset``
    prints are also appended to the yielded list."""
    rows = []
    original = module.show_predictions_on_dataset

    def record(logits, dataset, k=5):
        rows.append(np.asarray(logits, np.float32)[0].copy())
        original(logits, dataset, k)

    module.show_predictions_on_dataset = record
    try:
        yield rows
    finally:
        module.show_predictions_on_dataset = original


def top5(row: np.ndarray) -> list:
    return np.argsort(-row)[:5].tolist()


def show_pred_phase(stack: int = STACK, iters: int = ITERS,
                    raft_frames: int = 2 * RAFT_BATCH + 1,
                    pwc_frames: int = PWC_BATCH + 1,
                    device: str = "cuda") -> dict:
    """``show_pred`` on the flow paths (module docstring, step 28): i3d
    RAFT (fused proj) over two stacks with ``show_pred=true``, again with
    it off, and again with it on through the plain lookup, each run's
    counts set to 0 just before and read just after; then the raft family
    and the pwc family with ``show_pred=true``, whose windows are replaced
    by a recorder of the overlays they would show."""
    import io

    from video_features_tpu_torch.extractors import flow as flow_ex
    from video_features_tpu_torch.extractors import i3d as i3d_ex
    from video_features_tpu_torch.extractors.pwc import ExtractPWC
    from video_features_tpu_torch.extractors.raft import ExtractRAFT
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils.flow_viz import flow_to_image

    on_card = torch.device(device).type == "cuda"
    ex = i3d_ex.ExtractI3D(slice_config(
        SHOW_PRED_ROOT, show_pred=True, resize="host", stack_size=stack,
        step_size=stack, flow_iters=iters, device=device))
    frames = list(synthetic_frames(2 * stack + 1, 11))
    raft = ex.flow_stream.raft

    def run(show: bool, impl=None) -> dict:
        ex.show_pred = show
        raft.corr_lookup_impl = impl
        ex.flow_stream.forwards = 0
        buf = io.StringIO()
        with recorded_predictions(i3d_ex) as rows, \
                contextlib.redirect_stdout(buf):
            reset_counts(cl)
            out, seconds = timed(ex, frames)
            counts = read_counts(cl)
        raft.corr_lookup_impl = None
        return dict(out=out, seconds=seconds, launches=counts, rows=rows,
                    forwards=ex.flow_stream.forwards,
                    heads=[ln for ln in buf.getvalue().splitlines()
                           if ln.startswith("At stack")])

    shown_run = run(True)
    plain = run(False)
    gather = run(True, "gather")
    for key in ("rgb", "flow", "timestamps_ms"):
        a, b = shown_run["out"][key], plain["out"][key]
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"show_pred: i3d {key} with show_pred "
                                 f"differs from the run without it")
    want = dict(level=0, proj=iters * plain["forwards"] if on_card else 0,
                packed=0)
    if shown_run["launches"] != want or plain["launches"] != want or \
            any(gather["launches"].values()):
        raise AssertionError(
            f"show_pred: i3d launches {shown_run['launches']} (show_pred), "
            f"{plain['launches']} (features only), {gather['launches']} "
            f"(plain lookup); {want} expected")
    heads = [f"At stack {n} ({s} stream)" for s in ("rgb", "flow")
             for n in range(2)]
    if shown_run["heads"] != heads or gather["heads"] != heads or \
            plain["heads"] or len(shown_run["rows"]) != 4:
        raise AssertionError(f"show_pred: i3d printed {shown_run['heads']}")
    # two rows d apart entry by entry print the same ordered top-5 where
    # the plain lookup's top six are each more than 2 d apart
    logits_err = max(float(np.abs(got - ref).max())
                     for got, ref in zip(shown_run["rows"], gather["rows"]))
    if not logits_err <= SHOW_PRED_LOGITS_ATOL:
        raise AssertionError(f"show_pred: i3d logits against the plain "
                             f"lookup: max abs {logits_err}")
    compared, gaps = 0, []
    for head, got, ref in zip(heads, shown_run["rows"], gather["rows"]):
        gap = float(-np.diff(np.sort(ref)[::-1][:6]).min())
        gaps.append(gap)
        if gap > 2 * logits_err:
            compared += 1
            if top5(got) != top5(ref):
                raise AssertionError(f"show_pred: {head}: top-5 "
                                     f"{top5(got)} against the plain "
                                     f"lookup's {top5(ref)}")
    i3d_stats = dict(
        stacks=2, show_pred_s=shown_run["seconds"],
        features_only_s=plain["seconds"],
        launches=shown_run["launches"],
        features_only_launches=plain["launches"],
        flow_forwards=shown_run["forwards"],
        logits_max_abs_vs_plain_lookup=logits_err,
        top6_min_gaps=gaps, top5_compared=compared,
        top5=[top5(r) for r in shown_run["rows"]])

    stats = {"i3d": i3d_stats}
    for family, n_frames, build, config in (
            ("raft", raft_frames, ExtractRAFT,
             raft_config(SHOW_PRED_ROOT, show_pred=True, iters=iters,
                         device=device)),
            ("pwc", pwc_frames, ExtractPWC,
             pwc_config(SHOW_PRED_ROOT, show_pred=True, device=device))):
        fex = build(config)
        shown = []
        fex.show_flow = lambda i, bgr: shown.append(bgr)
        used = list(synthetic_frames(n_frames, 21))
        reset_counts(cl)
        out, seconds = timed(fex, used)
        counts = read_counts(cl)
        flows = out[family]
        forwards = -(-(n_frames - 1) // fex.batch_size)
        want = dict(level=0, proj=0, packed=0)
        if family == "raft" and on_card:
            want["proj"] = iters * forwards
        if counts != want or len(shown) != n_frames - 1 or \
                len(flows) != n_frames - 1:
            raise AssertionError(f"show_pred: {family} launches {counts} "
                                 f"({want} expected), {len(shown)} shown "
                                 f"of {len(flows)} flows")
        for i, flow in enumerate(flows):
            frame = used[i][0]
            vis = flow_to_image(flow.transpose(1, 2, 0))
            if vis.shape != frame.shape or vis.dtype != frame.dtype or \
                    not np.array_equal(shown[i], flow_ex.flow_overlay(
                        frame, flow.transpose(1, 2, 0))):
                raise AssertionError(f"show_pred: {family} flow {i}: image "
                                     f"{vis.shape} {vis.dtype} against the "
                                     f"frame's {frame.shape} {frame.dtype}")
        stats[family] = dict(flows=len(flows), seconds=seconds,
                             launches=counts, image_shape=list(vis.shape),
                             image_dtype=str(vis.dtype))
    return stats


def trace_report_phase(root: str = TELEMETRY_ROOT,
                       proj_want: int = 2 * ITERS) -> dict:
    """The trace report (module docstring, step 29) over the telemetry
    phase's on run: ``trace_report.main`` with ``--merge`` of that run's
    ``torch.profiler`` capture. Held: a ``*-bound`` verdict printed and in
    ``stage_summary``; the merged file holds every event of both inputs,
    the host lanes under one pid above the capture's integer pids,
    ``"aligned": false`` (the capture has no wall-clock anchor), and on
    the card the capture's device lanes with ``proj_want`` proj kernels."""
    import glob
    import io
    import re

    from video_features_tpu_torch import trace_report

    host_dir = f"{root}/on/out/i3d"
    out = f"{root}/_trace_merged.json"
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = trace_report.main([host_dir, "--merge", f"{root}/prof",
                                "--out", out])
    wall_s = time.perf_counter() - t
    m = re.search(r"^verdict: (\S+-bound)", buf.getvalue(), re.M)
    summary = trace_report.stage_summary(host_dir)
    if rc != 0 or m is None or summary["verdict"] != m.group(1):
        raise AssertionError(f"trace report: rc {rc}, summary {summary}: "
                             f"{buf.getvalue()[-800:]}")
    merged = json.load(open(out))
    host = json.load(open(f"{host_dir}/_trace.json"))["traceEvents"]
    capture = json.load(open(glob.glob(f"{root}/prof/*.pt.trace.json")[0]))[
        "traceEvents"]
    host_pid = max(e["pid"] for e in capture
                   if isinstance(e.get("pid"), int)) + 100000
    events = merged["traceEvents"]
    lanes = [e for e in events if e.get("pid") == host_pid]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    proj = [e for e in kernels if "proj_kernel" in e.get("name", "")]
    on_card = torch.cuda.is_available()
    if merged["otherData"]["aligned"] is not False or \
            (on_card and summary["device_ms"] < TRACE_DEVICE_MS_MIN) or \
            len(events) != len(host) + len(capture) or \
            len(lanes) != len(host) or \
            (on_card and len(proj) != proj_want) or \
            (not on_card and kernels):
        raise AssertionError(
            f"trace report: device {summary['device_ms']} ms (at least "
            f"{TRACE_DEVICE_MS_MIN} on the card), merged {len(events)} "
            f"events of {len(host)} + {len(capture)}, host lanes "
            f"{len(lanes)}, "
            f"{len(kernels)} device kernels, {len(proj)} proj "
            f"({proj_want} expected), aligned "
            f"{merged['otherData']['aligned']}")
    return dict(verdict=m.group(1), stage_summary=summary, wall_s=wall_s,
                merged_events=len(events), host_events=len(host),
                capture_events=len(capture), device_kernels=len(kernels),
                proj_kernels=len(proj), aligned=False)


def worker_kill_phase(video: str = SAMPLE_VIDEO,
                      n_videos: int = FLEET_VIDEOS,
                      reference: str = f"{FLEET_ROOT}/single/out/i3d",
                      **over) -> dict:
    """A queue worker killed mid-run (module docstring, step 30): two
    ``fleet=queue`` workers of the slice over the fleet phase's copies,
    the first with ``VFT_INJECT`` :data:`WORKER_KILL_PLAN`, the second
    started once the first has finished a video (so the plan's second
    attempt is the first worker's). Held: the first dies by SIGKILL with
    the plan fired; the second reclaims its lease, drains the queue and
    exits 0; every video done once, the reclaimed one by the survivor;
    the outputs bit-equal to ``reference`` (the fleet phase's static run);
    the port's ``audit --expect-complete`` passes."""
    import glob
    import os
    import shutil

    from video_features_tpu_torch.parallel.queue import QUEUE_DIRNAME

    root = WORKER_KILL_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    copies = fleet_corpus(video, n_videos)
    keys = fleet_keys(root, copies, fleet="queue",
                      fleet_lease_s=WORKER_KILL_LEASE_S, **over)
    qroot = f"{root}/out/i3d"
    done_dir = f"{qroot}/{QUEUE_DIRNAME}/done"
    t = time.perf_counter()
    victim = start_module(keys, env={"VFT_INJECT": WORKER_KILL_PLAN})
    survivor = None
    try:
        deadline = time.time() + SERVING_TIMEOUT_S
        while not glob.glob(f"{done_dir}/*.json") and \
                victim.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        survivor = start_module(keys)
        try:
            v_out, v_err = victim.communicate(timeout=SERVING_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError("worker kill: the victim did not exit") \
                from None
        surv = finish_module(survivor, "worker kill: the survivor")
    finally:
        for proc in (victim, survivor):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall_s = time.perf_counter() - t
    if victim.returncode != -9 or \
            "INJECT: worker.kill=kill fired" not in v_out:
        raise AssertionError(f"worker kill: the victim exited "
                             f"{victim.returncode}: {(v_out + v_err)[-800:]}")
    done = [json.load(open(p)) for p in sorted(
        glob.glob(f"{done_dir}/*.json"))]
    reclaimed = [d for d in done if d.get("reclaims", 0) >= 1]
    mark = f"-{victim.pid}-"
    if sorted(d["video"] for d in done) != sorted(copies) or \
            {d["status"] for d in done} != {"done"} or \
            len(reclaimed) != 1 or mark in reclaimed[0]["by"] or \
            os.listdir(f"{qroot}/{QUEUE_DIRNAME}/pending"):
        raise AssertionError(f"worker kill: done {done}")
    check_bit_equal(read_outputs(qroot), read_outputs(reference),
                    "worker kill: the reclaimed queue")
    audit = audit_trees({"worker_kill": dict(audit=qroot)}, "worker kill")
    return dict(videos=n_videos, wall_s=wall_s, victim_exit=-9,
                plan=WORKER_KILL_PLAN, lease_s=WORKER_KILL_LEASE_S,
                reclaimed=os.path.basename(reclaimed[0]["video"]),
                done_by_victim=sum(mark in d["by"] for d in done),
                survivor_tail=surv["stdout"].splitlines()[-1:],
                audit=audit["worker_kill"])


REENCODE_ROOT = "output/chip_smoke/reencode"
WEIGHTS_ROOT = "output/chip_smoke/weights"
NATIVE_ROOT = "output/chip_smoke/native"
#: the seeded checkpoints of the weights step, under their upstream
#: (hub) filenames: (model key, file, the config key of its explicit path)
WEIGHTS_FILES = (("i3d_rgb", "i3d_rgb.pt", "weights_path"),
                 ("i3d_flow", "i3d_flow.pt", "flow_weights_path"),
                 ("raft_sintel", "raft-sintel.pth",
                  "flow_model_weights_path"))
WEIGHTS_SEEDS = {"i3d_rgb": 41, "i3d_flow": 42, "raft_sintel": 43}


def stacks_of(outs: dict, stem: str) -> int:
    """The i3d stacks a run wrote for the video ``stem``."""
    return next(len(a) for k, a in outs.items()
                if k.endswith(f"{stem}_rgb.npy"))


def reencode_phase(video: str = SAMPLE_VIDEO, iters: int = ITERS,
                   **over) -> dict:
    """The slice through ``cli.main`` over a copy of ``video`` re-encoded to
    ``extraction_fps`` (``fps_mode=reencode``): the ``ffmpeg`` backend
    where ``ffmpeg`` is on ``PATH``, else ``cv2``'s ``mp4v`` writer. Held:
    a re-encoding source's frame indices and timestamps those of
    ``fps_mode=select``'s index map on the same video (rtol 1e-6), and the
    run's ``fps`` and per-stack timestamps those the select map gives;
    every feature finite; proj ``iters`` launches a stack; no temp file
    left. ``over`` replaces the slice's keys (the CPU test's small
    sizes)."""
    from pathlib import Path

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils import io as vio

    backend = "ffmpeg" if vio.which_ffmpeg() else "cv2"
    root = REENCODE_ROOT
    fps = float(over.get("extraction_fps", TELEMETRY_FPS))
    stack = int(over.get("stack_size", STACK))
    step = int(over.get("step_size", STACK))
    select = vio.VideoSource(video, fps=fps)
    want = [(i / select.fps * 1000.0, i)
            for i in range(len(select.index_map))]
    t = time.perf_counter()
    probe = vio.VideoSource(video, fps=fps, fps_mode="reencode",
                            tmp_path=f"{root}/probe")
    got = [(ts, i) for _, ts, i in probe.frames()]
    reencode_s = time.perf_counter() - t
    run = run_cli(telemetry_argv(root, video, **over)
                  + ["fps_mode=reencode"], cl)
    outs = read_outputs(f"{root}/out")
    stem = Path(video).stem
    n_stacks = stacks_of(outs, stem)
    ts = next(a for k, a in outs.items()
              if k.endswith(f"{stem}_timestamps_ms.npy"))
    run_fps = next(a for k, a in outs.items()
                   if k.endswith(f"{stem}_fps.npy"))
    # a stack of ``stack`` flows spans stack + 1 frames; its timestamp is
    # its last frame's
    want_ts = [want[last][0] for last in range(stack, len(want), step)]
    leftover = [str(p) for p in Path(root).rglob("*_new_fps.mp4")]
    finite = all(np.isfinite(a).all() for a in outs.values())
    timing = (len(got) == len(want)
              and [i for _, i in got] == [i for _, i in want]
              and np.allclose([x for x, _ in got], [x for x, _ in want],
                              rtol=1e-6, atol=0)
              and len(ts) == len(want_ts)
              and np.allclose(ts, want_ts, rtol=1e-6, atol=0)
              and np.allclose(run_fps, select.fps, rtol=1e-6, atol=0))
    if not timing or not finite or leftover or n_stacks < 1 or \
            run["launches"]["proj"] != iters * n_stacks * on_card():
        raise AssertionError(
            f"reencode ({backend}): {len(got)} frames against select's "
            f"{len(want)}, stack timestamps {list(ts)} against {want_ts}, "
            f"fps {run_fps} against {select.fps}, finite {finite}, temp "
            f"files left {leftover}, launches {run['launches']}")
    return dict(backend=backend, frames=len(got), select_frames=len(want),
                stacks=n_stacks, fps=float(run_fps), reencode_s=reencode_s,
                wall_s=run["wall_s"], launches=run["launches"],
                features={k: list(a.shape) for k, a in outs.items()})


def on_card() -> int:
    """1 where the lookup kernels run (a card), else 0: every proj count
    a step holds is ``iters * stacks * on_card()``."""
    return int(torch.cuda.is_available())


def weights_phase(video: str = SAMPLE_VIDEO, iters: int = ITERS,
                  **over) -> dict:
    """Weights resolution through ``weights/store.py``: seeded checkpoints
    of the slice's three models written under their upstream filenames
    into a fresh ``VFT_WEIGHTS_DIR`` (``TORCH_HOME`` an empty directory).
    The slice through ``cli.main`` with each file's explicit weights path,
    then with no weights path (the store finds them), both with
    ``allow_random_weights=false`` and ``cache=true`` into stores of their
    own. Held: the features bit-equal; each run's cache entry keyed by the
    same weights fingerprint, the sha256 of the three files; proj
    ``iters`` launches a stack in both; then, with an empty
    ``VFT_WEIGHTS_DIR``, the run fails with the store's message naming
    that directory."""
    import glob
    import hashlib
    import pickle
    from pathlib import Path

    from video_features_tpu_torch import cache
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.models import i3d as i3d_model
    from video_features_tpu_torch.models import raft as raft_model
    from video_features_tpu_torch.weights.bridge import seeded_init_

    root = Path(WEIGHTS_ROOT)
    wd = root / "weights_dir"
    wd.mkdir(parents=True, exist_ok=True)
    nets = {"i3d_rgb": lambda: i3d_model.I3D(400, in_channels=3),
            "i3d_flow": lambda: i3d_model.I3D(400, in_channels=2),
            "raft_sintel": lambda: raft_model.RAFT(iters)}
    capture = []
    for key, fname, _ in WEIGHTS_FILES:
        torch.save(seeded_init_(nets[key](), WEIGHTS_SEEDS[key]).state_dict(),
                   wd / fname)
        sha = hashlib.sha256((wd / fname).read_bytes()).hexdigest()
        capture.append({"model_key": key, "sha256": sha})
    want_fp = cache.weights_fingerprint(capture)
    saved = {k: os.environ.get(k) for k in ("VFT_WEIGHTS_DIR", "TORCH_HOME")}
    runs, fps = {}, {}
    try:
        os.environ["TORCH_HOME"] = str(root / "torch_home")
        for name, env_dir, paths in (
                ("explicit", root / "unused_dir", True),
                ("weights_dir", wd, False)):
            os.environ["VFT_WEIGHTS_DIR"] = str(env_dir)
            keys = {k: str(wd / f) for _, f, k in WEIGHTS_FILES} \
                if paths else {}
            argv = telemetry_argv(
                f"{root}/{name}", video, allow_random_weights="false",
                cache="true", cache_dir=f"{root}/{name}/cache",
                **dict(over, **keys))
            runs[name] = run_cli(argv, cl)
            entries = glob.glob(f"{root}/{name}/cache/**/*.pkl",
                                recursive=True)
            fps[name] = sorted({pickle.load(open(e, "rb"))["weights_fp"]
                                for e in entries})
        os.environ["VFT_WEIGHTS_DIR"] = str(root / "empty_dir")
        try:
            run_cli(telemetry_argv(f"{root}/empty", video,
                                   allow_random_weights="false", **over), cl)
            refusal = None
        except FileNotFoundError as e:
            refusal = str(e)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    a = read_outputs(f"{root}/explicit/out")
    b = read_outputs(f"{root}/weights_dir/out")
    stacks = stacks_of(a, Path(video).stem)
    check_bit_equal(b, a, "weights: the store's resolution")
    want = iters * stacks * on_card()
    if fps["explicit"] != [want_fp] or fps["weights_dir"] != [want_fp] or \
            any(r["launches"]["proj"] != want for r in runs.values()) or \
            refusal is None or str(root / "empty_dir") not in refusal or \
            "No weights for" not in refusal:
        raise AssertionError(
            f"weights: fingerprints {fps} (want {want_fp}), launches "
            f"{[r['launches'] for r in runs.values()]}, refusal {refusal!r}")
    return dict(files=[f for _, f, _ in WEIGHTS_FILES], weights_fp=want_fp,
                stacks=stacks, outputs=len(a), refusal=refusal,
                walls_s={k: r["wall_s"] for k, r in runs.items()},
                launches={k: r["launches"] for k, r in runs.items()})


def native_phase(video: str = SAMPLE_VIDEO, iters: int = ITERS,
                 **over) -> dict:
    """The native ``.npy`` writer (``native/vft_native.cpp``, built with
    ``g++`` on first use) on the main path. Held: ``native.available()``;
    the slice through ``cli.main`` writes every ``.npy`` through it (a
    counting wrapper), each file byte-equal to ``np.save`` of the array
    read back; ``validate_npy`` passes each and flags a truncated copy,
    which ``is_already_exist`` then counts as absent; proj ``iters``
    launches a stack."""
    import io
    from pathlib import Path

    from video_features_tpu_torch import native
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils import sinks

    if not native.available():
        raise AssertionError("native: the g++ build of vft_native.cpp did "
                             "not load; the run would take the fallback")
    # the library is built once a checkout (earlier steps wrote through
    # it): time a fresh build of the same source beside it
    t = time.perf_counter()
    native._build(Path(NATIVE_ROOT) / "timed_build.so")
    build_s = time.perf_counter() - t
    written = []
    real = native.write_npy_atomic

    def counted(fpath, value):
        ok = real(fpath, value)
        if ok:
            written.append(str(fpath))
        return ok

    native.write_npy_atomic = counted
    try:
        run = run_cli(telemetry_argv(NATIVE_ROOT, video, **over), cl)
    finally:
        native.write_npy_atomic = real
    files = sorted(Path(NATIVE_ROOT).rglob("*.npy"))
    mismatched = []
    for f in files:
        buf = io.BytesIO()
        np.save(buf, np.load(f))
        if buf.getvalue() != f.read_bytes() or native.validate_npy(
                str(f)) is not True:
            mismatched.append(f.name)
    stem = Path(video).stem
    stacks = stacks_of(read_outputs(NATIVE_ROOT), stem)
    flow = next(f for f in files if f.name == f"{stem}_flow.npy")
    present = sinks.is_already_exist("save_numpy", str(flow.parent), video,
                                     ["rgb", "flow"])
    data = flow.read_bytes()
    flow.write_bytes(data[:len(data) - 7])  # a copy torn by a killed writer
    torn_flagged = native.validate_npy(str(flow)) is False
    absent = not sinks.is_already_exist("save_numpy", str(flow.parent),
                                        video, ["rgb", "flow"])
    if len(written) != len(files) or sorted(written) != sorted(
            str(f) for f in files) or mismatched or not present or \
            not torn_flagged or not absent or \
            run["launches"]["proj"] != iters * stacks * on_card():
        raise AssertionError(
            f"native: {len(written)} native writes of {len(files)} files, "
            f"mismatched {mismatched}, present {present}, torn flagged "
            f"{torn_flagged}, absent after {absent}, launches "
            f"{run['launches']}")
    return dict(available=True, library=native.library_path().name,
                build_s=build_s, native_writes=len(written),
                files=[f.name for f in files], byte_equal_np_save=True,
                truncated_flagged=True, wall_s=run["wall_s"],
                launches=run["launches"])


def lint_phase() -> dict:
    """``python -m video_features_tpu_torch lint --json`` on this checkout:
    exit 0 (a non-zero exit fails the step), its finding counts and its
    wall."""
    from pathlib import Path
    root = str(Path(__file__).resolve().parent)
    res = run_module(["lint", root, "--json"], "lint")
    doc = json.loads(res["stdout"])
    if doc["schema"] != "vft.lint/1" or doc["counts"]["errors"]:
        raise AssertionError(f"lint: {doc['counts']}")
    return dict(counts=doc["counts"], findings=len(doc["findings"]),
                lint_elapsed_s=doc["elapsed_s"], wall_s=res["wall_s"])



SPAWNED_ROOT = "output/chip_smoke/spawned_decode"
LADDER_ROOT = "output/chip_smoke/ladder"
DEADLINE_ROOT = "output/chip_smoke/deadline"
WORKERS_ROOT = "output/chip_smoke/video_workers"
#: step 35's decode modes and the keys each adds to the slice
DECODE_MODES = {"inline": (), "process": (),
                "parallel": ("decode_workers=2",)}
#: the ladder's plan (the JAX chaos matrix's seed 0 row), armed in every
#: decode child through ``VFT_INJECT``, and the ladder runs' attempts: with
#: 3 every rung fails at its own process's third read (the inline rung's
#: is this process's first third read); with 4 the fourth attempt, inline
#: again, completes
LADDER_INJECT = "seed=0;decode.read=eio@n3"
LADDER_ATTEMPTS = (3, 4)
#: the deadline step's ``video_deadline_s`` by decode mode: over twice the
#: clean video's attempt on the card (1.6 s inline, 3.7 s under
#: ``process``, whose child starts in about 1 s; NVIDIA H100 80GB HBM3,
#: 700.00 W)
DEADLINE_S = {"inline": 4.0, "process": 8.0}
#: the tag in the stalled video's name (:func:`deadline_phase`)
STALL_TAG = "_stall"
#: copies of the sample step 38 extracts, and its ``video_workers`` values
WORKER_VIDEOS = 4
VIDEO_WORKERS = (1, 2, "auto")


class ChildWatch:
    """The decode children spawned inside the ``with`` block (each
    ``utils/io.py _WorkerQueue``'s process), watched while they live and
    held after it:

      - none may hold the card: no ``/dev/nvidia*`` descriptor among its
        open files (``/proc/PID/fd``, sampled every :attr:`POLL_S`), and,
        on the card, its PID in no ``nvidia-smi --query-compute-apps``
        list taken during the block; this process's own descriptors are
        the control (a card's process holds ``/dev/nvidia*``);
      - every one reaped when the block ends: no ``/proc`` entry left
        whose parent is this process, alive or zombie.

    Children left alive are killed on the way out, after the check."""

    POLL_S = 0.2
    SMI_EVERY = 5  # polls between two nvidia-smi queries (1 s)

    def __init__(self, card: bool) -> None:
        import threading
        self.card = card
        self.workers: list = []
        self.opened: dict = {}
        self.listed: set = set()
        self.smi_queries = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True,
                                        name="chip-smoke-child-watch")

    def __enter__(self) -> "ChildWatch":
        from video_features_tpu_torch.utils import io as vio
        self._vio = vio
        self._init = init = vio._WorkerQueue.__init__
        watch = self

        def recording(wq, *args, **kwargs):
            init(wq, *args, **kwargs)
            watch.workers.append(wq)

        vio._WorkerQueue.__init__ = recording
        self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        import signal
        self._vio._WorkerQueue.__init__ = self._init
        self._stop.set()
        self._thread.join(timeout=60)
        # the control: the block ran on the card in this process
        self.parent_card_fd = bool(self._card_fds(os.getpid()))
        self.unreaped = [p for p in self.pids()
                         if self._ppid(p) == os.getpid()]
        self.states = {p: self._state(p) for p in self.unreaped}
        for w in self.workers:
            if w.proc.is_alive():
                with contextlib.suppress(OSError):
                    os.kill(w.proc.pid, signal.SIGCONT)
                w.proc.kill()
                w.proc.join(timeout=10)
        return False

    def pids(self) -> list:
        return [w.proc.pid for w in self.workers]

    @staticmethod
    def _card_fds(pid: int) -> list:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            return []
        out = []
        for fd in fds:
            with contextlib.suppress(OSError):
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
                if target.startswith("/dev/nvidia"):
                    out.append(target)
        return out

    @staticmethod
    def _state(pid: int):
        """``/proc/PID/stat``'s state letter (``T``: stopped), None when
        gone."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            return None
        return stat[stat.rindex(")") + 2]

    @staticmethod
    def _ppid(pid: int):
        """The parent of ``pid`` (``/proc/PID/stat``'s fourth field, read
        after the command name's closing parenthesis), None when gone."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            return None
        return int(stat[stat.rindex(")") + 2:].split()[1])

    def _sample(self, query_smi: bool) -> None:
        for pid in self.pids():
            fds = self._card_fds(pid)
            if fds:
                self.opened[pid] = sorted(set(fds))
        if query_smi:
            res = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
            self.smi_queries += 1
            self.listed |= {int(t) for t in res.stdout.split()
                            if t.strip().isdigit()}

    def _poll(self) -> None:
        n = 0
        while not self._stop.wait(self.POLL_S):
            self._sample(self.card and n % self.SMI_EVERY == 0)
            n += 1

    def check(self, what: str, children: int, left=()) -> dict:
        """Raise unless ``children`` were spawned, every one reaped but
        those of ``left``, none on the card (and, on the card, this
        process's own descriptors show the card); the watch's numbers."""
        on_card = sorted({p for p in self.pids()
                          if p in self.opened or p in self.listed})
        if len(self.workers) != children or \
                sorted(self.unreaped) != sorted(left) or on_card or (
                self.card and not self.parent_card_fd):
            raise AssertionError(
                f"{what}: {len(self.workers)} decode children "
                f"({children} expected), unreaped {self.unreaped}, on the "
                f"card {on_card} ({self.opened}, nvidia-smi {self.listed}), "
                f"this process's card descriptors {self.parent_card_fd}")
        return dict(children=len(self.workers),
                    unreaped=len(self.unreaped),
                    children_on_card=0, smi_queries=self.smi_queries,
                    parent_listed_by_smi=os.getpid() in self.listed,
                    parent_card_fd=self.parent_card_fd)


def spawned_decode_phase(video: str = SAMPLE_VIDEO, iters: int = ITERS,
                         **over) -> dict:
    """Spawned decode on the main path (module docstring, step 35): for
    each of :data:`DECODE_MODES`, the source alone drained (its start: the
    spawn to the video's properties, and its decode wall, spawns included,
    and its frames), then the slice through
    ``cli.main`` with ``video_decode`` set, counts set to 0 just before
    and read just after, both inside a :class:`ChildWatch`. Held: the
    frames and the features bit-equal to ``inline``'s, proj ``iters``
    launches a stack, one child a ``process`` source and two a
    ``parallel`` one, each reaped, none on the card. ``over`` replaces
    the slice's keys (the CPU test's small sizes)."""
    import shutil

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils import io as vio

    root = SPAWNED_ROOT
    shutil.rmtree(root, ignore_errors=True)
    fps = float(over.get("extraction_fps", TELEMETRY_FPS))
    sources = {"inline": vio.VideoSource, "process": vio.ProcessVideoSource,
               "parallel": lambda v, fps: vio.ParallelVideoSource(
                   v, fps=fps, decode_workers=2)}
    children = {"inline": 0, "process": 2, "parallel": 4}
    modes, want_frames, want = {}, None, None
    for mode, keys in DECODE_MODES.items():
        with ChildWatch(bool(on_card())) as watch:
            t = time.perf_counter()
            src = sources[mode](video, fps=fps)
            start_s = time.perf_counter() - t
            frames = list(src.frames())
            decode_s = time.perf_counter() - t
            run = run_cli(telemetry_argv(f"{root}/{mode}", video, **over)
                          + [f"video_decode={mode}", *keys], cl)
        stats = watch.check(f"spawned decode ({mode})", children[mode])
        outs = read_outputs(f"{root}/{mode}/out")
        if want is None:
            want_frames, want = frames, outs
        stacks = stacks_of(outs, Path(video).stem)
        same_frames = len(frames) == len(want_frames) and all(
            (t1, i1) == (t2, i2) and f1.tobytes() == f2.tobytes()
            for (f1, t1, i1), (f2, t2, i2) in zip(frames, want_frames))
        check_bit_equal(outs, want, f"spawned decode ({mode})")
        if "1 extracted" not in run["stdout"] or not same_frames or \
                run["launches"] != dict(level=0, packed=0,
                                        proj=iters * stacks * on_card()):
            raise AssertionError(
                f"spawned decode ({mode}): frames equal {same_frames}, "
                f"launches {run['launches']}: {run['stdout'][-300:]}")
        modes[mode] = dict(stats, start_s=start_s, decode_s=decode_s,
                           frames=len(frames),
                           stacks=stacks, wall_s=run["wall_s"],
                           launches=run["launches"])
    return dict(modes=modes, bit_equal_to_inline=True,
                reference=f"{root}/inline/out")


def journal_records(root: str) -> list:
    """Every ``_failures.jsonl`` record under ``root``, in order."""
    return [json.loads(line) for f in sorted(Path(root).rglob(
        "_failures.jsonl")) for line in open(f) if line.strip()]


def ladder_phase(video: str = SAMPLE_VIDEO, iters: int = ITERS,
                 reference: str = f"{SPAWNED_ROOT}/inline/out",
                 **over) -> dict:
    """The decode ladder on the main path (module docstring, step 36): the
    slice through ``cli.main`` with ``video_decode=parallel
    decode_workers=2`` and :data:`LADDER_INJECT`, armed in this process
    and every decode child through ``VFT_INJECT``, once for each of
    :data:`LADDER_ATTEMPTS`, inside a :class:`ChildWatch`, counts set to 0
    just before and read just after. Held: both runs demote ``parallel ->
    process -> inline`` as ``utils/faults.py demote``; with 3 attempts the
    video fails and its one journal record is :func:`ladder_record`'s, no
    ``.npy`` written, no launch; with 4 it is recovered on the fourth
    attempt, no record, the features bit-equal to ``reference`` (step
    35's inline run), proj ``iters`` launches a stack; three children a
    run, each reaped, none on the card."""
    import shutil

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils import inject

    root = LADDER_ROOT
    shutil.rmtree(root, ignore_errors=True)
    want = read_outputs(reference)
    stacks = stacks_of(want, Path(video).stem)
    saved = os.environ.get("VFT_INJECT")
    os.environ["VFT_INJECT"] = LADDER_INJECT
    runs = {}
    try:
        for attempts in LADDER_ATTEMPTS:
            out = f"{root}/attempts{attempts}"
            with ChildWatch(bool(on_card())) as watch:
                run = run_cli(telemetry_argv(
                    out, video, **dict(over, retry_attempts=attempts))
                    + ["video_decode=parallel", "decode_workers=2",
                       "retry_backoff_s=0", f"inject={LADDER_INJECT}"], cl)
            runs[attempts] = dict(watch.check(f"ladder ({attempts})", 3),
                                  run=run, out=out)
    finally:
        if saved is None:
            os.environ.pop("VFT_INJECT", None)
        else:
            os.environ["VFT_INJECT"] = saved
        inject.disarm()
    result = {}
    for attempts, r in runs.items():
        stdout = r["run"]["stdout"]
        ladder = [line.split("video_decode=")[1].split(" ")[0]
                  for line in stdout.splitlines()
                  if line.startswith("DECODE LADDER")]
        records = [{k: rec[k] for k in ("category", "attempts", "error")}
                   for rec in journal_records(r["out"])]
        outs = read_outputs(f"{r['out']}/out")
        recovered = f"on attempt {attempts}/{attempts} (video_decode=inline)"
        if attempts == LADDER_ATTEMPTS[0]:
            ok = (records == [ladder_record(attempts)] and not outs
                  and r["run"]["launches"]["proj"] == 0)
        else:
            check_bit_equal(outs, want, f"ladder ({attempts})")
            ok = (not records and recovered in stdout and
                  r["run"]["launches"]["proj"] == iters * stacks * on_card())
        if ladder != ["process", "inline"] or not ok:
            raise AssertionError(
                f"ladder ({attempts}): demotions {ladder}, records "
                f"{records}, outputs {sorted(outs)}, launches "
                f"{r['run']['launches']}: {stdout[-400:]}")
        result[f"attempts{attempts}"] = dict(
            {k: v for k, v in r.items() if k not in ("run", "out")},
            demotions=ladder, journal=records, outputs=len(outs),
            recovered=bool(outs), wall_s=r["run"]["wall_s"],
            launches=r["run"]["launches"])
    return dict(result, plan=LADDER_INJECT, bit_equal_to_clean=True)


def ladder_record(attempts: int) -> dict:
    """The journal record of the ladder's video after ``attempts`` tries
    that all failed: the last, inline, rung's error is this process's
    third read."""
    return {"category": "TRANSIENT", "attempts": attempts,
            "error": "OSError: [Errno 5] injected EIO at decode.read "
                     "(hit 3, seed 0)"}


def stacks_from(frames: int, stack: int, step: int) -> int:
    """The stacks ``frames`` frames give (a stack reads ``stack + 1``)."""
    return max(0, (frames - stack - 1) // step + 1)


def deadline_phase(video: str = SAMPLE_VIDEO, iters: int = ITERS,
                   reference: str = f"{SPAWNED_ROOT}/inline/out",
                   deadlines=None, **over) -> dict:
    """The deadline watchdog on the main path (module docstring, step
    37): for ``inline`` and ``process`` decode, the slice through
    ``cli.main`` with ``telemetry=true``, ``retry_attempts=1`` and
    ``video_deadline_s`` (:data:`DEADLINE_S`, or ``deadlines``) over a
    copy of the sample whose decode stalls, then the sample, in that order
    (the work list's shuffle held), counts set to 0 just before and read
    just after. The stall does not depend on the host's speed: inline, the
    copy's last frame's read blocks until the watchdog's cancel releases
    its capture (so every stack before it went to the card); under
    ``process``, its child is stopped (``SIGSTOP``) as the parent asks for
    its first frame. Held: one watchdog expiry
    (``vft_deadline_expirations_total`` 1 in ``_run.json``), the copy's
    span ``error`` and first, its one journal record ``TRANSIENT`` with a
    ``DeadlineExceeded``, no ``.npy`` of it; the sample ``done``, bit-equal
    to ``reference`` (a run of it alone); proj ``iters`` launches a stack
    dispatched; none of the children on the card, the sample's reaped.
    The stopped child is not: the consumer's stop terminates it (SIGTERM,
    which a stopped process does not act on), waits 10 s and gives up, as
    the JAX package's does; the phase records its state and kills it."""
    import random
    import shutil
    import signal

    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.utils import io as vio

    root = DEADLINE_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stem = Path(video).stem
    stalled = f"{root}/{stem}{STALL_TAG}.mp4"
    shutil.copyfile(video, stalled)
    fps = float(over.get("extraction_fps", TELEMETRY_FPS))
    stack = int(over.get("stack_size", STACK))
    step = int(over.get("step_size", STACK))
    group = int(over.get("clip_batch_size", 2))
    n = len(vio.VideoSource(video, fps=fps).index_map)
    want = read_outputs(reference)
    per_video = iters * stacks_from(n, stack, step) * on_card()
    # inline: every full group of the n - 1 frames before the stall
    dispatched = {"inline": stacks_from(n - 1, stack, step) // group
                  * group * iters * on_card(), "process": 0}
    reads, stopped = {}, []
    real_read, real_get = vio._FrameStream.read, vio._WorkerQueue.get

    def stalling_read(stream):
        if STALL_TAG in stream._path:
            k = reads[id(stream)] = reads.get(id(stream), 0) + 1
            if k >= n:
                while stream.cap is not None:  # until the cancel's release
                    time.sleep(0.01)
                return None
        return real_read(stream)

    def stalling_get(wq, path, raise_if_cancelled):
        if STALL_TAG in path and wq.proc.pid not in stopped:
            os.kill(wq.proc.pid, signal.SIGSTOP)
            stopped.append(wq.proc.pid)
        return real_get(wq, path, raise_if_cancelled)

    real_shuffle = random.shuffle
    vio._FrameStream.read, vio._WorkerQueue.get = stalling_read, stalling_get
    random.shuffle = lambda x, *a, **k: None
    runs = {}
    try:
        for mode, deadline in (deadlines or DEADLINE_S).items():
            out = f"{root}/{mode}"
            with ChildWatch(bool(on_card())) as watch:
                run = run_cli(telemetry_argv(
                    out, f"[{stalled}, {video}]",
                    **dict(over, retry_attempts=1))
                    + ["telemetry=true", f"video_decode={mode}",
                       f"video_deadline_s={deadline}"], cl)
            # the stopped child outlives the consumer's stop (SIGTERM, a
            # 10 s join, no SIGKILL: the JAX package's stop too); the
            # watch kills it after its check
            runs[mode] = dict(watch.check(
                f"deadline ({mode})", 2 if mode == "process" else 0,
                left=stopped), run=run, out=out, deadline_s=deadline,
                stopped_child_state=[watch.states[p] for p in stopped])
            stopped.clear()
    finally:
        vio._FrameStream.read, vio._WorkerQueue.get = real_read, real_get
        random.shuffle = real_shuffle
    result = {}
    for mode, r in runs.items():
        run, out = r.pop("run"), r.pop("out")
        tel = f"{out}/out/i3d"
        spans = [json.loads(line) for line in
                 open(f"{tel}/_telemetry.jsonl") if line.strip()]
        by_video = {Path(s["video"]).stem: s for s in spans}
        records = journal_records(out)
        metrics = json.load(open(f"{tel}/_run.json"))["metrics"]["series"]
        expired = sum(m.get("value", 0) for m in metrics
                      if m.get("name") == "vft_deadline_expirations_total")
        outs = read_outputs(f"{out}/out")
        left = sorted(k for k in outs if f"{stem}{STALL_TAG}_" in k)
        stall_span = by_video.get(f"{stem}{STALL_TAG}", {})
        ok = (expired == 1 and run["stdout"].count("WATCHDOG:") == 1
              and [Path(s["video"]).stem for s in spans]
              == [f"{stem}{STALL_TAG}", stem]
              and stall_span.get("status") == "error"
              and by_video[stem].get("status") == "done"
              and len(records) == 1 and records[0]["video"] == stalled
              and records[0]["category"] == "TRANSIENT"
              and records[0]["attempts"] == 1
              and records[0]["error"].startswith("DeadlineExceeded")
              and not left and run["launches"] == dict(
                  level=0, packed=0, proj=per_video + dispatched[mode]))
        if not ok:
            raise AssertionError(
                f"deadline ({mode}): expirations {expired}, spans "
                f"{[(s['video'], s['status']) for s in spans]}, records "
                f"{records}, left {left}, launches {run['launches']}: "
                f"{run['stdout'][-400:]}")
        # no output of the stalled copy: every file is the sample's
        check_bit_equal(outs, want, f"deadline ({mode})")
        result[mode] = dict(
            r, expirations=expired, stalled_status=stall_span["status"],
            stalled_wall_s=stall_span.get("wall_s"),
            next_video_wall_s=by_video[stem].get("wall_s"),
            journal={k: records[0][k] for k in ("category", "attempts")},
            error=records[0]["error"][:160], npy_left=0,
            next_video_bit_equal=True, wall_s=run["wall_s"],
            launches=run["launches"])
    return result


def roofline_line(doc: dict, family: str = "i3d") -> dict:
    """A run's ``_roofline.json`` numbers of ``family`` that step 38
    prints beside each other."""
    fam = doc["families"][family]
    return {k: fam[k] for k in ("dispatches", "forward_calls", "forward_s",
                                "h2d_s", "wall_s", "device_share",
                                "effective_tflops", "mfu", "verdict")}


def video_workers_phase(video: str = SAMPLE_VIDEO, iters: int = ITERS,
                        n_videos: int = WORKER_VIDEOS,
                        workers=VIDEO_WORKERS, **over) -> dict:
    """Several videos at once (module docstring, step 38): the slice through
    ``cli.main`` with ``telemetry=true roofline=true`` over the sample and
    ``n_videos - 1`` copies, once for each of ``workers`` as
    ``video_workers``, counts set to 0 just before and read just after.
    Held: every feature file bit-equal to the first (serial) run's, proj
    ``iters`` launches a stack of every video, one span a video, each
    ``done`` with every stage of :data:`TELEMETRY_STAGES` timed; the
    walls and each run's roofline numbers (:func:`roofline_line`)
    printed."""
    import shutil

    from video_features_tpu_torch import cli
    from video_features_tpu_torch.kernels import corr_lookup as cl
    from video_features_tpu_torch.telemetry import roofline

    root = WORKERS_ROOT
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(f"{root}/corpus")
    stem = Path(video).stem
    paths = [video]
    for i in range(1, n_videos):
        paths.append(f"{root}/corpus/{stem}_w{i}.mp4")
        shutil.copyfile(video, paths[-1])
    runs, want = {}, None
    for w in workers:
        out = f"{root}/w{w}"
        run = run_cli(telemetry_argv(out, f"[{', '.join(paths)}]", **over)
                      + ["telemetry=true", "roofline=true",
                         f"video_workers={w}"], cl)
        outs = read_outputs(f"{out}/out")
        if want is None:
            want = outs
        check_bit_equal(outs, want, f"video_workers={w}")
        tel = f"{out}/out/i3d"
        spans = [json.loads(line) for line in
                 open(f"{tel}/_telemetry.jsonl") if line.strip()]
        stacks = stacks_of(outs, stem)
        complete = sorted(Path(s["video"]).stem for s in spans
                          if s["status"] == "done" and all(
                              s["stages"].get(k, {}).get("s", 0) > 0
                              for k in TELEMETRY_STAGES))
        if f"{n_videos} extracted" not in run["stdout"] or \
                complete != sorted(Path(p).stem for p in paths) or \
                len(spans) != n_videos or run["launches"] != dict(
                    level=0, packed=0,
                    proj=n_videos * iters * stacks * on_card()):
            raise AssertionError(
                f"video_workers={w}: spans {len(spans)}, complete "
                f"{complete}, launches {run['launches']}: "
                f"{run['stdout'][-300:]}")
        runs[str(w)] = dict(
            threads=cli._video_workers(w), wall_s=run["wall_s"],
            launches=run["launches"], spans=len(spans),
            span_wall_s=[s["wall_s"] for s in spans],
            roofline=roofline_line(json.load(
                open(f"{tel}/{roofline.ROOFLINE_FILENAME}"))))
    return dict(videos=n_videos, runs=runs, bit_equal_to_serial=True)


def concurrent_phases(walls: dict, *phases) -> list:
    """Each ``(name, fn)`` of ``phases`` on a thread of its own, all at once:
    phases whose time is their subprocesses' and that share no state in
    this process (the compile-cache and fleet-queue phases, 115 s one
    after the other, and the storage and worker-kill phases, 55 s, on an
    NVIDIA H100 80GB HBM3 at 700.00 W). Each one's wall goes into
    ``walls`` and the group's under the names joined by ``+``; the
    results come back in
    order, and the first failure is raised once every phase has ended."""
    import threading

    results, errors = {}, []

    def run(name, fn):
        t = time.perf_counter()
        try:
            results[name] = fn()
        except BaseException as e:  # raised below, on the caller's thread
            errors.append(e)
        finally:
            walls[name] = time.perf_counter() - t

    t = time.perf_counter()
    threads = [threading.Thread(target=run, args=phase,
                                name=f"chip-smoke-{phase[0]}")
               for phase in phases]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    group = "+".join(name for name, _ in phases)
    walls[group] = time.perf_counter() - t
    for name in [n for n, _ in phases] + [group]:
        print(json.dumps({"phase": name, "wall_s": walls[name]}),
              file=sys.stderr, flush=True)
    if errors:
        raise errors[0]
    return [results[name] for name, _ in phases]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from video_features_tpu_torch.device import set_precision
    from video_features_tpu_torch.kernels import build

    dev = torch.device("cuda")
    set_precision("float32")
    card = card_line()
    print(card)
    # a library left by an earlier build carries that build's report
    cached = build.library_path().exists()
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    print(json.dumps({"build_s": build_s, "library": build.library_path().name,
                      "built_in_this_run": not cached,
                      "ptxas": kernel_resources(build)}))
    # the card's practical bf16 and read rates, beside the registry's entry
    # that every roofline MFU of the port divides by
    from video_features_tpu_torch.telemetry import roofline
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"measure_peak": roofline.measure_peak(),
                      "registry": roofline.registry_peak(kind),
                      "device_kind": kind, "card": card}))

    # each phase's wall, printed on a line of its own before the kernels'
    walls = {}

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        # on stderr as it ends, so a run cut short still shows where
        print(json.dumps({"phase": name, "wall_s": walls[name]}),
              file=sys.stderr, flush=True)
        return out

    ragged = timed_phase("ragged", check_ragged, dev)
    print(json.dumps({"ragged_max_abs_err": ragged}))
    kernels = timed_phase("kernels", check_kernels, dev)
    raft_err = timed_phase("small_raft", check_small_raft, dev)
    slice_stats, proj_launches, level_launches, fused_feats = timed_phase(
        "slice", run_slice, dev)
    raft_stats = timed_phase("raft_family", run_raft_family, dev)
    torch.cuda.empty_cache()
    pwc_stats = timed_phase("pwc_family", run_pwc_family, dev)
    torch.cuda.empty_cache()
    i3d_pwc_stats, proj_launches_bf16 = timed_phase(
        "i3d_pwc", run_i3d_pwc, dev, fused_feats)
    torch.cuda.empty_cache()
    r21d_stats = timed_phase("r21d", run_r21d, dev)
    s3d_stats = timed_phase("s3d", run_s3d, dev)
    resnet_stats = timed_phase("resnet", frame_phase, "resnet", 2048,
                               "resnet18", 512)
    clip_stats = timed_phase("clip", frame_phase, "clip", 512, "RN50", 1024)
    vggish_stats = timed_phase("vggish", vggish_phase)
    parallel_stats = timed_phase("parallel", parallel_phase, dev)
    empty_cache()
    multi_stats = timed_phase("multi", multi_phase)
    empty_cache()
    telemetry_stats = timed_phase("telemetry", telemetry_phase)
    empty_cache()
    alerts_stats = timed_phase("alerts", alerts_phase)
    empty_cache()
    fleet_stats = timed_phase("fleet", fleet_step,
                              {"telemetry": TELEMETRY_ROOT,
                               "alerts": ALERTS_ROOT}, kind)
    certify_stats = timed_phase("certify", certify_phase)
    empty_cache()
    serve_stats = timed_phase("serve", serve_phase)
    empty_cache()
    compile_stats, fleet_queue_stats = concurrent_phases(
        walls, ("compile_cache", compile_cache_phase),
        ("fleet_queue", fleet_queue_phase))
    empty_cache()
    # step 30's killed worker beside step 24: it reads step 23's corpus
    # and static run, which the storage phase only accounts and audits
    storage_stats, kill_step = concurrent_phases(
        walls, ("storage", storage_phase), ("worker_kill", worker_kill_phase))
    kill_step["step_wall_s"] = walls["worker_kill"]
    empty_cache()
    traffic_stats = timed_phase("traffic", traffic_phase, SAMPLE_VIDEO,
                                TRAFFIC_SCENARIOS, TRAFFIC_SPEEDUP, None,
                                None, TRAFFIC_DURATION_SCALE)
    empty_cache()
    chaos_stats = timed_phase("chaos", chaos_phase)
    empty_cache()
    steps = {"worker_kill": kill_step}
    for name, step in (("sequence", sequence_phase),
                       ("show_pred", show_pred_phase),
                       ("trace_report", trace_report_phase),
                       ("reencode", reencode_phase),
                       ("weights", weights_phase),
                       ("native", native_phase),
                       ("lint", lint_phase),
                       ("spawned_decode", spawned_decode_phase),
                       ("ladder", ladder_phase),
                       ("deadline", deadline_phase),
                       ("video_workers", video_workers_phase)):
        steps[name] = timed_phase(name, step)
        steps[name]["step_wall_s"] = walls[name]
        empty_cache()
    sequence_stats, show_pred_stats, trace_stats, kill_stats = (
        steps[name] for name in ("sequence", "show_pred", "trace_report",
                                 "worker_kill"))
    # each kernel's launches on the path that runs it: the i3d slice for
    # proj (fused) and level (unfused), the raft family for packed
    launches = {"corr_lookup_proj_cuda": proj_launches,
                "corr_lookup_level_cuda": level_launches,
                "corr_lookup_packed_cuda":
                    raft_stats["packed_launches"]["packed"]}
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["card"] = card
    proj_row = next(r for r in kernels
                    if r["name"] == "corr_lookup_proj_cuda")
    proj_row["launches_raft_default"] = raft_stats["default_launches"]["proj"]
    proj_row["launches_i3d_raft_bfloat16"] = proj_launches_bf16
    proj_row["launches_telemetry_off_on"] = [
        telemetry_stats["proj_launches"]["off"],
        telemetry_stats["proj_launches"]["on"]]
    proj_row["launches_alerts_fault"] = alerts_stats["fault"]["proj_launches"]
    proj_row["launches_parallel_raft_per_replica"] = [
        t["proj"] for t in parallel_stats["raft"]["per_replica"]]
    proj_row["launches_serve_first_copy"] = [
        serve_stats["requests"][k]["launches"]["proj"]
        for k in ("first", "copy")]
    proj_row["launches_storage_refill"] = storage_stats[
        "refill_proj_launches"]
    proj_row["launches_traffic"] = {
        name: d["launches"]["proj"] for name, d in traffic_stats.items()}
    proj_row["launches_chaos"] = {
        name: r["launches"]["proj"] for name, r in chaos_stats["runs"].items()}
    proj_row["launches_show_pred"] = {
        "i3d": show_pred_stats["i3d"]["launches"]["proj"],
        "raft": show_pred_stats["raft"]["launches"]["proj"],
        "pwc": show_pred_stats["pwc"]["launches"]["proj"]}
    proj_row["launches_clip_blockwise"] = sequence_stats["runs"][
        "blockwise"]["launches"]["proj"]
    proj_row["launches_reencode"] = steps["reencode"]["launches"]["proj"]
    proj_row["launches_weights"] = {
        name: d["proj"] for name, d in steps["weights"]["launches"].items()}
    proj_row["launches_native"] = steps["native"]["launches"]["proj"]
    proj_row["launches_spawned_decode"] = {
        mode: d["launches"]["proj"]
        for mode, d in steps["spawned_decode"]["modes"].items()}
    proj_row["launches_ladder"] = {
        k: steps["ladder"][k]["launches"]["proj"]
        for k in steps["ladder"] if k.startswith("attempts")}
    proj_row["launches_deadline"] = {
        mode: d["launches"]["proj"] for mode, d in steps["deadline"].items()
        if isinstance(d, dict) and "launches" in d}
    proj_row["launches_video_workers"] = {
        w: d["launches"]["proj"]
        for w, d in steps["video_workers"]["runs"].items()}
    next(r for r in kernels if r["name"] == "corr_lookup_packed_cuda")[
        "launches_i3d"] = slice_stats["packed_launches"]
    slice_stats.update(card=card, small_raft_kernels_vs_gather_px=raft_err)
    raft_stats["card"] = card
    pwc_stats["card"] = card
    i3d_pwc_stats["card"] = card
    r21d_stats["card"] = card
    s3d_stats["card"] = card
    resnet_stats["card"] = card
    clip_stats["card"] = card
    vggish_stats["card"] = card
    parallel_stats["card"] = card
    multi_stats["card"] = card
    telemetry_stats["card"] = card
    alerts_stats["card"] = card
    fleet_stats["card"] = card
    certify_stats["card"] = card
    serve_stats["card"] = card
    compile_stats["card"] = card
    fleet_queue_stats["card"] = card
    storage_stats["card"] = card
    chaos_stats["card"] = card
    print(json.dumps({"slice": slice_stats}))
    print(json.dumps({"raft_family": raft_stats}))
    print(json.dumps({"pwc_family": pwc_stats}))
    print(json.dumps({"i3d_pwc": i3d_pwc_stats}))
    print(json.dumps({"r21d": r21d_stats}))
    print(json.dumps({"s3d": s3d_stats}))
    print(json.dumps({"resnet": resnet_stats}))
    print(json.dumps({"clip": clip_stats}))
    print(json.dumps({"vggish": vggish_stats}))
    print(json.dumps({"parallel": parallel_stats}))
    print(json.dumps({"multi": multi_stats}))
    print(json.dumps({"telemetry": telemetry_stats}))
    print(json.dumps({"alerts": alerts_stats}))
    print(json.dumps({"fleet": fleet_stats}))
    print(json.dumps({"certify": certify_stats}))
    print(json.dumps({"serve": serve_stats}))
    print(json.dumps({"compile_cache": compile_stats}))
    print(json.dumps({"fleet_queue": fleet_queue_stats}))
    print(json.dumps({"alerts_plane": alerts_plane_line(
        telemetry_stats, alerts_stats, card)}))
    print(json.dumps({"storage": storage_stats}))
    print(json.dumps({"traffic": dict(traffic_stats, card=card)}))
    print(json.dumps({"chaos": chaos_stats}))
    print(json.dumps({"sequence": dict(sequence_stats, card=card)}))
    print(json.dumps({"show_pred": dict(show_pred_stats, card=card)}))
    print(json.dumps({"trace_report": dict(trace_stats, card=card)}))
    print(json.dumps({"worker_kill": dict(kill_stats, card=card)}))
    for name in ("reencode", "weights", "native", "lint", "spawned_decode",
                 "ladder", "deadline", "video_workers"):
        print(json.dumps({name: dict(steps[name], card=card)}))
    print(json.dumps({"phase_walls_s": walls, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
