#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the root of the repository, with one card visible:

    python3 chip_smoke.py [--profile DIR]

Phases (each prints a line; any failure exits non-zero without a result):
  1. environment: torch, CUDA and nvcc versions; the card's name and power
     limit as nvidia-smi prints them;
  2. build every kernel from heimdall_tpu_torch/csrc (one nvcc per source,
     in parallel) and time the build;
  3. hold every kernel against its plain PyTorch version on the card,
     exactly (tolerance 0):
     a. the fused 640x480 kernel: bench frames in each input form,
        adversarial frames (also with K = 4, fewer slots than blobs) and an
        odd frame size; then the cases that attack its tiles
        (scene.tile_case_frames and scene.label_case_masks drawn as frames,
        BGR planes and Mono8, contrast 15 and -15) at 640x480, 477x631,
        13x17 and 3x3 with K = 64 and 4;
     b. the band-tiled 2 MP kernels (preprocess, flood fill, band labels,
        band merge, banded stats, bbox sums) at 1920x1080: bench Mono8 and
        BGR frames, adversarial frames and masks with K = 64 and K = 4, and
        a frame whose height is not a multiple of the band; then the cases
        that attack the redesigned kernels' tiles (scene.tile_case_masks /
        tile_case_frames: spiral and snake corridors closed and open, pixels
        meeting at tile corners diagonally, all foreground, all background,
        noise, contrast 15 and -15) at 3x3, 3x1920, 1080x3, 13x17,
        1037x1531 and 1920x1080, the flood fill and the preprocess (Mono8,
        BGR, BGR planes) exact, and the fill of a batch with active flags
        mixed, its skipped frames' prefilled outputs untouched; and the
        band labels with the merge after them on scene.label_case_masks
        (corridors across every tile edge and corner, pixels meeting only
        diagonally at tile corners, a component whose least pixel lies in a
        later tile, all foreground, all background, noise) at the same
        sizes, bands 128, 48, 16, 2 and 1, connectivity 8 and 4, and with
        active flags mixed over prefilled outputs; and the banded stats
        and bbox sums on scene.window_case_masks (the whole frame, a disk
        over all but the edge bands, full-height columns on the first and
        last column, the corners, blobs ending on band edges, more blobs in
        one band than slots, no blob) at 1920x1080 on random gray and
        colour, bands 128, 16 and 1, K = 64, 4 and 1, gray only, BGR frames
        and BGR planes, and with slot counts past K;
     c. the run-table 2 MP kernels (the preprocess with background tables,
        run extraction, border flood, fill + extraction, run labels,
        writeback) at 1920x1080: bench BGR frames NHWC and channel-major,
        adversarial frames, adversarial masks with K = 4, a mixed batch of
        masks that fit, trip the foreground guard and trip both guards, and
        odd-sized BGR frames, and 3b's tile-case masks and frames at its
        sizes; on each, the route with the detector's guards (per frame,
        tables or bands) equals the band route exactly; then the cases that
        attack the run extraction's lanes and steps (scene.run_case_masks:
        runs ending at, starting at and crossing the 16-column lane and
        512-column step edges, every other lane's columns, a run through
        the row, one-pixel runs on every second column, rows of 6 to 13
        runs, all foreground and all background) at the run-case sizes
        (widths 1, 3, 17, 531, 1920), 1920x1080 and 1037x1531: run
        extraction with R 8, 12 and 40, both inverts, fill + extraction with
        r_bg / r_fg 8 / 7, 12 / 10 and 40 / 7 (past 32 background slots the
        flags are read from memory) on random flags and the border flood's,
        and the route on them; then the cases whose components cross every
        row block of the union-finds many times (scene.fix_case_masks:
        serpentine corridors, a ring over the frame's height, a staircase
        diagonal and a comb whose teeth meet on the last row, as foreground
        and as background) at 1920x1080, 301x517 and heights 1, 7, 8 and 9
        (below, at and above the cluster's 8 blocks), the route and every
        kernel as above and the label fix also with band 16 and K = 4 and
        with band 1, both union-finds on their cluster path, every frame on
        the tables; tall frames at R 12, 5000 rows on the cluster path and
        16000 rows on the global-scratch path; and the CUDA kernels of one
        run extraction, border flood, fill + extraction and run-label call,
        traced: one launch each;
     d. the split kernels at 640x480 (the label kernel at every stage, the
        stats kernel on its labels): bench frames, adversarial frames with
        K = 64 and K = 4, 2 frames of 477x631, and a uniform frame with no
        foreground (contrast 15) and all foreground (contrast -15); then
        the tile and label cases that 3a runs through B1 (640x480,
        477x631, 13x17, 3x3) and the bit cases (scene.bit_case_frames at
        40x31, 40x32, 40x33, 70x641), contrast 15 and -15; on each,
        stats(labels) with the labels equals the fused kernel's outputs;
        and each stage's CUDA kernels, traced at 640x480 and 13x17 (one
        tile), equal hd_label_launches(stage, H, W) and name only the
        design's kernels (LABEL_STAGE_KERNELS);
     e. the preprocess and hole-fill probes at 640x480 on 3d's frames: the
        roll stages, the preprocess variants (the exact four also equal to
        the label kernel's "pre"; mxu_conv's mean within 1e-3 of the float32
        product, and its pre plane differing only within the morphology's
        reach of a mean near a half-integer), the run-id product, the nine
        sweep fills (each also equal to the label kernel's union-find
        "fill", and run by its (grow, guard) instance); then the nine fills
        alone (fill_mask) against the plain sweep fill and the tile
        union-find fill on scene.tile_case_masks, fix_case_masks and
        bit_case_masks at 640x480, 477x631, 13x17, 3x3, the bit cases'
        sizes and the largest planes the fill takes (1008x640, 636x1024),
        and on the label kernel's "pre" planes of 3d's frames; the CUDA
        kernels of one fill_sweeps call and one fill_mask call, traced (2
        and 1); the roll stages and the variants on scene.tile_case_frames
        at PROBE_CASE_SIZES (every tile a border tile, the wrap halo
        wrapping more than once at 6x6), contrast +-15, and the CUDA
        kernels of one call of each, traced (one k_pre_variant; mxu_conv
        also k_band_table); and the stats kernel on a label plane whose
        labels need not name a root;
     f. the labeling probes at 640x480 on 3e's frames: the fifteen CCL
        variants (sweeps and run tables at R = 12, 10, 8, 6) and the four
        joint variants against their plain versions, every fixpoint also
        against the label kernel's "ccl" stage (and the joint filled mask
        against its "fill" stage), fixed2 and the run tables' per-frame
        fits flags against their plain versions, each sweep kernel on the
        path the frame's shape picks (the cluster path at 640x480 and
        477x631: a cluster of 16 blocks a frame with both label planes in
        shared memory, ops/ccl_sweeps.py::choose_path) and on the global
        path; the run-table check's and the adversarial masks on each side
        of the cluster path's cut (LABEL_CUT_SHAPES: 544 / 545 rows of 640
        for the joint fixpoint, 608 / 609 for the sweep CCL), every variant
        on both paths where both run, with last_path checked; the run
        tables on scene.run_case_masks at RUN_CASE_SIZES (rows of exactly
        R and R + 1 runs, runs on the 16-column lanes' and 512-column
        steps' seams; each size a batch of frames that fit and frames that
        overflow) at R = 12, 10, 8, 6 on both paths, the run-id product's
        frames equal to those that do not fit; and the run-table check
        (scripts/check_runtable.py's 7 masks at R = 12 and 8: sweeps ==
        run tables == the plain labels, the overflow mask not fitting);
     g. the primitive microbench's 27 variants (scripts/microbench_vpu.py's
        steps, 480x640 planes, 960x640 for seg_min_step) against their
        plain versions, whole plane, at N = 1, 4 and 36, on the script's
        planes (batch 256) and on 16 planes of a second seed in [-60, 60);
        then at the edges of the kernels' layouts (PRIM_EDGE_SHAPES; the
        cross-row steps also at PRIM_CROSS_SHAPES), 4 planes of seed 3 in
        [-60, 60), at N = 0, 1 and 37, row 0 and the whole plane;
        each plain version and the cumsum variants' torch.cumsum step are
        timed there (N = 36 against N = 4);
  4. drive the detector's main paths, each with every kernel's launch count
     set to 0 just before and read just after:
     a. ContaminationDetector.run_device at 640x480x3 channel-major, batch
        256, K = 64, then verdict_device, then detect_batch with contours
        on 4 frames;
     b. the same three at 1920x1080 Mono8, batch 128 (the band-tiled
        route); one run_device call runs with CUDA sync debugging set to
        "error", so a host sync inside the route fails it; the first 2
        frames' table, confidence and gates must equal the CPU path;
     c. the same three at 1920x1080 BGR channel-major, batch 128 (the
        run-table route), with the same checks; prints how many frames took
        the tables and how many the bands;
     d. the system path, with every wrapper's count set to 0 just before
        and read just after, and every plain version guarded (none may run
        on a CUDA tensor): the five PipelineFactory types through
        process_batch on 8 bench frames at 1920x1080 BGR (the first 2
        frames' result image, contour_count and line_count equal to the
        CPU path; each type's ms per batch, and its host syncs with
        device_only under sync-debug "warn", none but Canny's convergence
        checks); ContaminationInspector.
        inspect_batch on 32 simulation frames (seed 0, defect probability
        0.3) at 1920x1080 and at 640x480 (the first 2 frames' defects, and
        those of 2 scene.ring_frames, equal to the CPU path; one call from
        numpy and one from the card under sync-debug "warn", host syncs
        and tables downloaded per call; ms per batch and frames/s from
        numpy; from frames on the card the host's ms per call until its
        work is queued and the pipeline's and the detector's share by CUDA
        events); a
        System with one inspector station (reject on) on a 1920x1080
        simulation camera for 3 s (every result a success); main -s
        --duration 3 (both stations past 0 frames) and main --diagnose;
        the CUDA kernels of one 2 MP inspect_batch and one bottle_base call
        and of one 640x480 inspect_batch, traced;
     e. the line path, with every wrapper's count set to 0 just before
        and read just after and every plain version guarded: the native
        library loaded, FrameRing on its ring and its camera producer
        running; the config #4 stream (50 SimulationImageSource frames,
        640x480, seed 1, defect probability 1.0, at 25 fps) through
        runtime/feeder.py's DeviceFeeder (pinned uploads) in push mode,
        then pull mode, with read -> verdict p50/p99; examples/
        line_simulation's main (4 simulated GigE cameras, 8 sets a batch,
        3 s) at 640x480 and 1920x1080 Mono8, and latency_main (one set a
        batch, 3 s): bottles/h, per-bottle p50/p95/p99, the floor (upload
        + no-op kernel + fetch), rejects, PASS or below against 90,000
        BPH and 10 ms; every stream frame's verdict (push and pull) and
        the first 4 batches' of each run equal to the plain versions'
        (contamination_fused_reference at 640x480, the band route's on
        the CPU at 1920x1080); the CUDA kernels of one line verdict_device
        call, traced (B1's 11); UniformityCalibrator.apply_on_device on
        the card equal to the CPU; one line batch's upload, pageable
        against the pinned slots, in MB/s;
     f. the serving path, with every wrapper's count set to 0 just before
        and read just after and every plain version guarded: the
        dashboard at its defaults (640x480, batch 4) on the card: /,
        /api/stats, /api/latest, /metrics, two /api/stream events with
        rising seq, a settings POST and a 404, the CLI's status, set,
        latest and metrics against it, its fps and per-frame EMA, stop
        with no loop thread left; main -s --dashboard --duration 3 (its
        dashboard past 0 frames); ResultsViewer on a temporary results
        directory; MultiClassDefectDetector.detect_batch on 32 bench
        frames at 640x480 (the fused kernel) and 8 at 1920x1080 Mono8 (the
        band route), the first 2 frames' defects equal to the CPU path;
        the models at full width from seeded weights (UNet base 16,
        classifier width 32, AE width 16) on 8 frames at 640x480:
        DefectSegmenter.predict within 1e-5 of the CPU path,
        SegmentationDetector on the card's map (6 of JAX's sweeps and
        blob_stats, PyTorch ops as JAX's are XLA ops) equal to the CPU
        path on that map, QuantizedSegmenter within 1e-6,
        DefectClassifier on extract_blob_patches of the detector's table
        and AnomalyDetector.score within 1e-2 (bf16); demosaic (4 Bayer
        patterns) and yuv422_to_bgr at 1920x1080 equal to the CPU path;
        each timed in ms per batch by CUDA events; the fused kernel, the
        band route's preprocess, fill, labels, merge, banded stats and
        bbox sums must each have launched;
     g. the multi-device path (heimdall_tpu_torch/parallel): the three
        shard entries (flood_fill_sp, band_ccl_sp, banded_stats_sp: B5b,
        B5a and B4a on a shard of a frame's rows) against their plain
        versions, exactly, on the 2 MP bench frames' binary planes and on
        scene.tile_case_masks and label_case_masks at 1920x1080 and 64x96,
        cut into 4 and 3 shards (random reached halos, bands of a shard
        and bands that cut it, K = 64 and 4, colour and gray), and each
        timed per call on a shard of 4x270x1920 beside its plain version
        and byte bound; then, with every wrapper's count set to 0 in each
        rank, make_tiled_spatial_step on 4 bench frames at 1920x1080 BGR
        over a 1x4 world on the one card (four processes started by
        parallel/launch.py, gloo, the collectives staged through pinned
        host buffers; every kernel on the card), each rank's table,
        confidence and gates equal to the single-card detector's, the
        ranks agreeing on the flood's rounds, each shard entry launched,
        and the step timed; and a 1-rank NCCL world through both
        data-parallel steps and the line step at 640x480 (8 frames) and
        1920x1080 BGR (4), equal to the single-card detector, the line
        totals equal to its tables';
     h. the training path (run last, after phase 5g), with every
        wrapper's count set to 0 just before and read just after and
        every plain version guarded: one step of
        ClassifierTrainer (width 32, 256 patches of 32x32), of
        DefectSegmenter.train_step (UNet base 16, 8 ring frames of 640x480
        with their dark rings as masks) and of the autoencoder (width 16,
        64 of those frames' tiles), each from the same seeded parameters
        on the card and the CPU, held by tests/_torch_step_rule.py (loss,
        gradients, parameters after the step; the bf16 models against the
        CPU's step, the float32 UNet against the CPU's step in float64 at
        the float32 tolerances, also with TF32 allowed process-wide: TF32
        off through its backward; its loss also against the CPU's float32
        step) and timed in ms a step by CUDA events; AnomalyDetector.fit
        for one epoch (560 tiles, batch 64) on both, loss and threshold
        within 1e-3; the sharded
        train step over a 1x4 world on the one card (gloo, staged) and a
        1-rank NCCL world, every rank's parameters bitwise equal and
        within tolerance of the card's ClassifierTrainer step on the whole
        batch, timed a step (slowest rank); examples/model_training at its
        own sizes (48 frames of 128x96, 80 steps; its lines printed, every
        loss finite), which must launch the fused kernel and the band
        route's labels, merge, banded stats and bbox sums; and a
        ProfilingSession.trace of a UNet step after all that training,
        taken once: it lists the card's kernels or raises (the profiler
        can lose them on these machines: ROADMAP.md, section C), and then
        5d's trace of the split kernels once more;
  5. times with CUDA events after warm-up, the timed runs queued behind a
     spin kernel so that the host's time per call stays out: each kernel,
     its plain version and its bound, and which of bytes and operations
     sets it (the f32 mean's 44 operations a pixel at one a lane and clock
     on 132 SMs x 128 FP32 lanes at clocks.max.sm); the main paths end to
     end (frames already on the card), each beside its host time per call
     (run_device's return, before the sync, no profiler):
     640x480x3, 1920x1080 Mono8, and 1920x1080 BGR through the run tables
     and through the band route, on the bench batch and on a mixed batch
     whose every fourth frame is adversarial (most of those overflow the
     tables and fall back; both routes must give the same table, and the
     bbox sums on its stats inputs equal their plain version); the
     CUDA kernels that one call of the fused detect and of the band labels
     launches, counted from a torch.profiler trace of that call (for the
     fused detect also at each phase 3a size, against what its C entry
     reports), and of one bbox sums call (one kernel); the B3 kernels and
     B2 (BGR) and the banded stats (Mono8) also at the main path's batch
     of 128 (kernels only; the plain versions at 32); the bbox sums at 128
     on scripts/profile_bbox_sums.py's three inputs (bench Mono8, bench BGR
     planes through the run tables, the window cases), each beside its
     byte bound, its time on empty slot lists and one empty kernel's time;
     d. the profiling path, with the split kernels' launch counts set to 0
        just before and read just after: the port's profile_fused and
        profile_preprocess (batch 256, 10 iterations; each stage's us/frame
        and the breakdown line) and examples/performance_analysis on the
        card (5 batches, its JSON report), and a ProfilingSession.trace of
        the split kernels after the 1-rank NCCL world of 4g, taken once:
        it lists their CUDA kernels (k_label_tiles among them, or the run
        fails) or raises, naming the loss; then each split kernel's plain
        version and bound;
     e. the probes path, with the probe kernels' launch counts set to 0
        just before and read just after: the port's profile_pre_variants
        and profile_fill_variants (batch 256, 10 iterations; every
        variant's us/frame with its pre stage and alone, its instance,
        mxu_conv's flips, the union-find fill beside the sweep fills) and
        the roll stages of 5d's profile_preprocess run (counted from 0 over
        that run); then each probe's plain version and bound, and the
        tensor-core products beside the PyTorch call that computes the same
        (torch.matmul of the banded matrices; the run ids, an entry of
        their own, beside torch.cumsum of the run starts), with their
        launch counts;
     f. the labeling probes path, with the labeling probes' launch counts
        set to 0 just before and read just after: the port's check_runtable
        (no timing), profile_ccl_variants and profile_joint_variants (batch
        256, 10 iterations; every variant's us/frame and launches, the
        frames on the run tables at each R, the frames fixed2 leaves short,
        the full detect classic against joint with equal gates); then each
        probe's plain version and bound, and the run-table check's masks
        timed as one batch; then each labeling kernel alone (ccl_mask on
        the label kernel's filled mask, joint_mask on its pre mask, run ids
        included), every variant on both paths, beside the plain versions
        of cur, the run tables and rowFull_col5 and the bounds (5 and 6
        B/px), with the cluster path's blocks, pass width, shared memory
        and clusters at once (cudaOccupancyMaxActiveClusters); the run
        tables' CUDA kernels of one call, traced (the tables, the two run-id
        launches and the sweep), and the frames its run-id product numbered
        on the bench batch, where every frame fits (0);
     g. the primitive microbench path, with its launch count set to 0 just
        before and read just after: the port's microbench_vpu (every
        variant at N = 4 and 36, one warm-up and 6 timed calls each: 378
        launches); then each variant's us/op/frame beside its plain
        version's, its bound (operations), twice its bound and, for the
        cumsum variants, the torch.cumsum step's;
  6. JSON lines: each route's end-to-end and host ms per call, the system
     path's times and traced launches, the line path's figures, the
     serving path's figures (times, launches, the card), the
     multi-device path's figures, the training path's figures (ms a step,
     the checks' readings, launches, the card), and every kernel with its
     check, times and launches on the system path, the line path, the
     serving path, the multi-device path and the training path;
then the last line {"ok": true, "device": {...}}.  With --profile DIR,
per-kernel breakdowns from torch.profiler go to
DIR/fused_detect_profile.txt, DIR/tiled_2mp_profile.txt (Mono8) and
DIR/tiled_2mp_bgr_profile.txt (BGR).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 256
K = 64
CONTRAST = 15
# The 2 MP design point (4 Basler acA1920 cameras): main-path batch, the
# batch at which each tiled kernel and its plain version are timed, and
# the band of the detector's tiled route.
BATCH_2MP = 128
TIME_BATCH_2MP = 32
H2, W2 = 1080, 1920
ODD_2MP = (1037, 1531)        # a height that is not a multiple of the band
# The CUDA kernels one call of the fused detect (640x480) and of the band
# labels (1920x1080) launch, each once.
# The CUDA kernels of one label_kernel call at each stage (hd_label): gray,
# or the one-pass preprocess stopped at the stage, then the tile fill and
# the tile labels (their merges only where the frame has more than one
# tile); and of one fill_sweeps call (the "pre" stage, then the carry
# fill).
_FILL = ("k_fill_tiles", "k_fill_merge", "k_fill_write")
_LABELS = ("k_label_tiles", "k_label_merge", "k_label_write")
LABEL_STAGE_KERNELS = {
    "gray": ("k_gray",), "blur5": ("k_preprocess",),
    "mean11": ("k_preprocess",), "pre": ("k_preprocess",),
    "fill": ("k_preprocess",) + _FILL,
    "ccl": ("k_preprocess",) + _FILL + _LABELS}
FILL_SWEEPS_KERNELS = {"k_preprocess": 1, "k_carry_fill": 1}
# The sweep fill's largest planes at 640 and 1024 columns (the limit of
# ops/fill_sweeps.py::_check_plane).
FILL_LARGEST = ((1008, 640), (636, 1024))
# The preprocess probes' small-frame cases (scene.tile_case_frames): frames
# below one tile and its 11-pixel halo, so that every tile is a border tile
# (at 6x6 the wrap halo wraps more than once), and a frame of interior and
# border tiles with partial tiles at its right and bottom.
PROBE_CASE_SIZES = ((6, 6), (7, 13), (13, 17), (70, 131), (200, 397))
# The run tables' cases (scene.run_case_masks): the bench width, an odd
# width (byte loads), a row of two 512-column steps, narrow frames.
RUN_CASE_SIZES = ((24, 640), (24, 531), (40, 1024), (9, 17), (33, 48))
FUSED_KERNELS = ("k_preprocess", "k_fill_tiles", "k_fill_merge",
                 "k_fill_write", "k_label_tiles", "k_label_merge",
                 "k_label_write", "k_row_roots", "k_frame_roots", "k_stats",
                 "k_bbox_sums")
BAND_CCL_KERNELS = ("k_label_tiles", "k_label_merge", "k_label_write",
                    "k_band_roots")
# Bands of the label cases: the route's, bands that cut the 32-row tiles of
# the labeling, and bands of 2 and 1 rows.
LABEL_BANDS = (128, 48, 16, 2, 1)
RT_BG, RT_FG = 8, 7           # the detector's run-table widths
# Bands and slot counts of the window cases (bbox sums): the route's band,
# bands that cut the windows into many pieces, and lists shorter than the
# blobs of a band.
WINDOW_BANDS = (128, 16, 1)
WINDOW_KS = (K, 4, 1)
# Table widths of the run cases: the detector's, the tests', and a
# background width past a warp's 32 lanes (the fill extraction then reads
# the flags from memory instead of a ballot).
RUN_R = (RT_BG, 12, 40)
FILL_R = ((RT_BG, RT_FG), (12, 10), (40, RT_FG))
# The B3 kernels, timed at the main path's batch as well.
B3_KERNELS = ("run_extract", "flood_fix", "fill_extract", "label_fix",
              "writeback")
# The system path (phase 4d): the pipelines' batch, the station's batch
# (tpu.batch_size's default) and the five PipelineFactory types.
PIPE_BATCH = 8
SYSTEM_BATCH = 32
PIPELINE_TYPES = ("basic", "bottle_base", "sidewall", "preform",
                  "contamination")
# The line path (phase 4e): the JAX bench's config #4 stream (frames, rate,
# feeder depth) and line runs (sets a batch, seconds), and the batches of
# each run held against the plain versions.
STREAM_FRAMES = 50
STREAM_FPS = 25
STREAM_IN_FLIGHT = 3
LINE_SETS = 8
LINE_SECONDS = 3.0
CHECK_BATCHES = 4
# The serving path (phase 4f): the multi-class detector's batches at
# 640x480 and 1920x1080 Mono8 and the models' batch; the float32 UNet's
# tolerance against the CPU path (cuDNN sums in another order; 1.2e-7 read
# on an H100) and the bf16 models' (the classifier's probabilities and the
# autoencoder's relative scores; 2.3e-5 and 0 read on frame 0 of an H100):
# a few times the readings, so that a missing bf16 step shows
SERVE_BATCH = 32
SERVE_BATCH_2MP = 8
MODEL_BATCH = 8
UNET_TOL = 1e-5
BF16_TOL = 1e-4
# the types whose Canny stage asks the host whether its hysteresis has
# converged (one sync every 16 rounds); the others make none
CANNY_TYPES = ("basic", "sidewall")
# Published peaks of one H100 SXM (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
# float operations per pixel of the f32 mean11: 11 multiplies and 10 adds
# per pass, 2 passes (counted as 44).  The kernels are built with
# -fmad=false, so each __fmul_rn and __fadd_rn is one instruction on an
# SM's 128 FP32 lanes: the bound divides them by 132 x 128 x clocks.max.sm
# (mean_ops_ms), not by the 67 TFLOP/s peak, which counts an FMA as two.
MEAN_FLOPS_PER_PX = 44
# TF32 operations per pixel of mxu_conv's band products: per 16 x 8 tile of
# out, 3 k tiles x 2 splits in the row pass and 4 x 3 in the column pass,
# each 16 x 8 x 8 multiply-adds
MXU_FLOPS_PER_PX = (3 * 2 + 4 * 3) * 16 * 8 * 8 * 2 // (16 * 8)
# mxu_conv's mean against the float32 product
MEAN_TOL = 1e-3
# The primitive microbench: integer operations per pixel of a frame per step
# of each primitive (seg_min_step: per pixel pair), counted from the
# script's bodies: a shifted read's index test and select, each min, max,
# or, and, add and compare, each penalty add (the TPU's precomputed masks);
# a roll or a transpose moves data and counts nothing.  The bound divides
# them by the SMs' dispatch rate at the card's clocks.max.sm: 132 SMs x 4
# warp instructions (128 lanes) a clock, one instruction per operation;
# no instruction mix dispatches faster (min, max and logic have only the 64
# INT32 lanes, adds also the FMA pipe as IMAD).
PRIM_OPS = {
    "min_scan_step": 3, "max_scan_step": 3, "or_roll": 1, "nbmin8": 12,
    "add": 1, "select": 3, "transpose_pair": 1, "seg_min_step": 8,
    "mxu_cumsum": 4, "cumsum_ladder": 21, "masked_min_step": 2,
    "masked_ladder5": 10, "nbmin_guard": 6, "nbmin_masked_sub": 10,
    "or_and_mask": 2, "max_ladder_full": 20, "sublane_mask_add": 2}
# 3g's shapes at the edges of the primitive kernels' layouts ((rows,
# columns); seg_min_step twice the rows): columns not a multiple of 32 or of
# a lane's 20 values, narrower than the ladders' shifts, 639 (the rolls'
# line buffer); and the cross-row steps' bands of 4 rows a warp, partly
# empty clusters, a cluster of 16 blocks (700 rows) and a frame of more
# than 1024 rows (k_cross_rows)
PRIM_EDGE_SHAPES = ((5, 20), (5, 21), (4, 31), (4, 32), (7, 63), (17, 639))
PRIM_CROSS_SHAPES = ((1, 640), (2, 640), (8, 640), (17, 640), (479, 640),
                     (479, 639), (700, 640), (1100, 64))
PRIM_EDGE_ITERS = (0, 1, 37)
# The primitive kernels' designs (csrc/primitives.cu), by variant family
PRIM_DESIGN = {
    "rows": "a warp per row, 20 values a lane in registers; shifted reads "
            "are register moves and warp shuffles (blocked layout x = 20 "
            "lane + j; the 10-rung ladders, add and select strided, x = 32 "
            "j + lane, rungs of 32 q register renames), no shared memory "
            "at W = 640",
    "transpose_pair": "a warp per 32x32 tile in registers as 8x8 blocks of "
                      "16-bit pairs (int32: low and high planes); each "
                      "transpose a movmatrix a block and a rename of the "
                      "blocks, no shared tile",
    "mxu_cumsum": "16 rows a block; the bf16 operand double-buffered in "
                  "shared memory, written by the products' epilogue, read "
                  "as ldmatrix.x4 fragments reused by a warp's 10 column "
                  "tiles; mma.sync m16n8k16 against the triangle; one "
                  "block barrier a step, no repack pass",
    "cross": "a frame per cluster (8 blocks at 480 rows), a band of 4 rows "
             "a warp in registers; edge rows into the neighbours' halo "
             "slots (distributed shared memory, double-buffered), one "
             "split cluster barrier a step with the interior rows between "
             "its arrival and wait; frames over 1024 rows in shared memory"}
H100_SMS = 132
# torch.profiler traces taken before a traced count or listing fails: the
# card has returned two incomplete traces in a row (cuda_kernels).
TRACE_TRIES = 8
DISPATCH_LANES_PER_SM = 128
BF16_FLOPS_PER_S = 989e12


def phase(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters):
    """Mean milliseconds of fn() over iters runs on the card alone, queued
    behind a spin kernel (heimdall_tpu_torch/scripts/timing.py)."""
    from heimdall_tpu_torch.scripts.timing import queued_ms
    return queued_ms(fn, iters)


def cuda_kernels(fn, runs=1):
    """The repo's CUDA kernels (their names start with k_) that one call of
    fn launches, counted from a torch.profiler trace of that call:
    {kernel name: launches}.  The profiler drops a trace's first kernel
    records once another process has used the card, and can
    record no kernel at all (heimdall_tpu_torch/scripts/check_trace.py), so
    each trace opens with ProfilingSession.trace's lead of
    profiling.LEAD_KERNELS kernels to lose, then runs fn between two kernels
    that no wrapper launches (torch.cuda._sleep's spin kernel), each behind
    a sync; it counts only when both spins were recorded, else it is taken
    again, up to TRACE_TRIES times.  With runs=2, fn runs twice, each call
    behind its own spin and the last followed by a third, and the kernels
    between the last two spins are counted: a call of a few hundred
    kernels can lose everything before it from its trace (the system
    path's calls, phase 4d), and the second call is then still
    bracketed."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from heimdall_tpu_torch.perf import profiling
    for attempt in range(TRACE_TRIES):
        time.sleep(0.2 if attempt else 0.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiling.lead("cuda")
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(runs):
                fn()
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        spins = [i for i, n in enumerate(names) if "spin" in n]
        if len(spins) == runs + 1 or (runs > 1 and len(spins) >= 2):
            names = names[spins[-2]:spins[-1]]
            break
        phase(f"trace {attempt} recorded {[n[:40] for n in names]}, not "
              f"both spin kernels: tracing again")
    else:
        fail("no trace recorded both of its bracketing kernels: launches "
             "not counted")
    counts = {}
    for name in names:
        m = re.search(r"(?:^|[\s:])(k_\w+)", name)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def max_abs_err(got, want):
    """Largest |a - b| over paired tensors (shapes must match)."""
    import torch
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    return err


def clocks_max_sm_mhz():
    """The card's clocks.max.sm, as nvidia-smi reports it."""
    if not hasattr(clocks_max_sm_mhz, "mhz"):
        clocks_max_sm_mhz.mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], check=True,
            capture_output=True, text=True).stdout.split()[0])
    return clocks_max_sm_mhz.mhz


def mean_ops_ms(px):
    """The f32 mean11's operation bound in ms for px pixels: one
    uncontracted float operation a lane and clock."""
    return (px * MEAN_FLOPS_PER_PX / (H100_SMS * DISPATCH_LANES_PER_SM *
                                      clocks_max_sm_mhz() * 1e6) * 1e3)


def host_ms(fn, iters=5):
    """Mean host milliseconds until fn() returns, its work queued but not
    waited for (each call starts on an idle card; no profiler)."""
    import torch
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def cuda_ms_only(setup, fn, iters):
    """Mean milliseconds of fn() alone over iters runs, each after setup()
    (not timed), with CUDA events."""
    import torch
    total = 0.0
    for _ in range(iters):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def tiled_stages(x, channel_major, k, band, mask=None, plain=False):
    """The tiled route's stages on frames x, by kernel or by plain version:
    {stage: outputs}.  With mask, the fill starts from it instead of the
    preprocess's binary plane."""
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import stats_tiled as st
    out = {}
    pre = fk.preprocess_reference if plain else fk.preprocess
    out["preprocess"] = gray, binary = pre(x, CONTRAST, channel_major)
    fill = ct.flood_reference if plain else ct.flood_fill
    filled = fill(binary if mask is None else mask)
    out["flood_fill"] = (filled,)
    bccl = ct.band_ccl_reference if plain else ct.band_ccl
    out["band_ccl"] = lab, roots, counts = bccl(filled, band, 8, max(k, 128))
    merge = ct.merge_reference if plain else ct.merge_bands
    out["merge_bands"] = labels, rl, n, sl, sc = merge(
        lab.clone(), roots, counts, band, 8, k)
    color = x if x.dim() == 4 and x.shape[1 if channel_major else -1] == 3 \
        else None
    stats = st.banded_stats_reference if plain else st.banded_stats
    out["banded_stats"] = sums, bbox = stats(labels, filled, gray, color, rl,
                                             n, k, channel_major)
    box = st.bbox_sums_reference if plain else st.bbox_sums
    out["bbox_sums"] = (box(bbox, sl, sc, band, gray, color, channel_major),)
    return out


def check_tiled(name, x, channel_major, k, band, mask=None):
    """Hold every tiled kernel against its plain version on one case; the
    largest error over all of them (0 or the run fails)."""
    import torch
    got = tiled_stages(x, channel_major, k, band, mask)
    torch.cuda.synchronize()
    want = tiled_stages(x, channel_major, k, band, mask, plain=True)
    torch.cuda.synchronize()
    errs = {s: max_abs_err(got[s], want[s]) for s in got}
    n = got["merge_bands"][2].tolist()
    phase(f"check 2MP {name}: n_blobs {n[:8]} max_abs_err {errs}")
    if any(errs.values()):
        fail(f"a tiled kernel differs from its plain version on {name}")
    return max(errs.values())


def check_tile_cases(dev):
    """Phase 3b's cases that attack the tiles: the hole fill and the
    preprocess against their plain versions on scene.tile_case_masks and
    tile_case_frames (contrast 15 and -15; Mono8, BGR and BGR planes) at
    the frame sizes that cut tiles and at 1920x1080; and the fill of a
    batch with active flags mixed, whose skipped frames must keep their
    prefilled outputs.  Returns the largest error (0 or the run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    err = 0
    for h, w in scene.TILE_CASE_SIZES + ((H2, W2),):
        masks = on(np.stack(list(scene.tile_case_masks(h, w).values())))
        u8 = masks.to(torch.uint8) * 255
        errs = {"flood_fill": max_abs_err((ct.flood_fill(masks),),
                                          (ct.flood_reference(masks),)),
                "flood_fill_u8": max_abs_err((ct.flood_fill(u8),),
                                             (ct.flood_reference(u8),))}
        frames = np.stack(list(scene.tile_case_frames(h, w).values()))
        for form, (x, cm) in {
                "mono8": (frames[..., 1], False), "bgr": (frames, False),
                "bgr_planes": (frames.transpose(0, 3, 1, 2), True)}.items():
            x = on(x)
            for c in (CONTRAST, -CONTRAST):
                errs[f"preprocess_{form}_{c}"] = max_abs_err(
                    fk.preprocess(x, c, cm), fk.preprocess_reference(x, c,
                                                                    cm))
        torch.cuda.synchronize()
        phase(f"check 2MP tile cases {h}x{w} ({len(masks)} masks, "
              f"{len(frames)} frames): max_abs_err {errs}")
        err = max(err, *errs.values())
    masks = on(np.stack(list(scene.tile_case_masks(*ODD_2MP).values())))
    active = torch.arange(len(masks), device=dev) % 3 != 1
    sentinel = on(np.random.RandomState(7).rand(*masks.shape) < 0.5)
    out = sentinel.clone()
    ct.flood_fill(masks, active=active, out=out)
    torch.cuda.synchronize()
    skip_err = max(
        max_abs_err((out[active],), (ct.flood_reference(masks)[active],)),
        max_abs_err((out[~active],), (sentinel[~active],)))
    phase(f"check 2MP tile cases: flood fill with active "
          f"{active.tolist()}, skipped frames prefilled: max_abs_err "
          f"{skip_err}")
    err = max(err, skip_err)
    if err:
        fail("a redesigned kernel differs from its plain version on the "
             "tile cases")
    return err


def check_label_cases(dev):
    """Phase 3b's cases that attack the foreground labeling's tiles: the
    band labels (B5a) and the merge after them against their plain versions
    on scene.label_case_masks at the frame sizes that cut tiles and at
    1920x1080, every band of LABEL_BANDS (bands that cut the 32-row tiles,
    and of 1 and 2 rows), connectivity 8 and 4; and the band labels of a
    batch with active flags mixed, whose skipped frames must keep their
    prefilled labels.  Returns the largest error (0 or the run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_tiled as ct

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    err = 0
    for h, w in scene.TILE_CASE_SIZES + ((H2, W2),):
        masks = on(np.stack(list(scene.label_case_masks(h, w).values())))
        errs, most = {}, 0
        for band in LABEL_BANDS:
            for conn in (8, 4):
                got = ct.band_ccl(masks, band, conn, 128)
                want = ct.band_ccl_reference(masks, band, conn, 128)
                merged = ct.merge_bands(got[0].clone(), got[1], got[2], band,
                                        conn, K)
                errs[f"b{band}c{conn}"] = max(
                    max_abs_err(got, want),
                    max_abs_err(merged, ct.merge_reference(
                        want[0], want[1], want[2], band, conn, K)))
                most = max(most, int(want[2].max()))
        torch.cuda.synchronize()
        phase(f"check 2MP label cases {h}x{w} ({len(masks)} masks, most "
              f"roots in a band {most}): band_ccl + merge_bands max_abs_err "
              f"{errs}")
        err = max(err, *errs.values())
    masks = on(np.stack(list(scene.label_case_masks(*ODD_2MP).values())))
    active = torch.arange(len(masks), device=dev) % 3 != 1
    sentinel = on(np.random.RandomState(8).randint(
        0, ODD_2MP[0] * ODD_2MP[1], masks.shape).astype(np.int32))
    for band, conn in ((128, 8), (48, 4)):
        out = sentinel.clone()
        got = ct.band_ccl(masks, band, conn, 128, active=active, out=out)
        torch.cuda.synchronize()
        want = ct.band_ccl_reference(masks, band, conn, 128)
        skip_err = max(
            max_abs_err(tuple(t[active] for t in got),
                        tuple(t[active] for t in want)),
            max_abs_err((out[~active],), (sentinel[~active],)))
        phase(f"check 2MP label cases: band_ccl (band {band}, connectivity "
              f"{conn}) with active {active.tolist()}, skipped frames "
              f"prefilled: max_abs_err {skip_err}")
        err = max(err, skip_err)
    if err:
        fail("the band labels differ from their plain version on the label "
             "cases")
    return err


def check_fused_tile_cases(dev):
    """Phase 3a's cases that attack B1's tiles: the fused kernel against
    its plain version on scene.tile_case_frames and the label cases drawn
    as frames, BGR planes and Mono8, contrast 15 and -15, K = 64 and 4, at
    640x480, 477x631, 13x17 and 3x3.  Returns the largest error (0 or the
    run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import _cuda
    from heimdall_tpu_torch.ops.fused_kernels import (
        contamination_fused, contamination_fused_reference)

    lib = _cuda.library("fused_detect")
    err = 0
    for h, w in ((480, 640), (477, 631), (13, 17), (3, 3)):
        frames = np.concatenate([
            np.stack(list(scene.tile_case_frames(h, w).values())),
            scene.mask_frames(list(scene.label_case_masks(h, w).values()))])
        errs = {}
        for form, (x, cm) in {
                "bgr_planes": (frames.transpose(0, 3, 1, 2), True),
                "mono8": (frames[..., 1], False)}.items():
            x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for k in (K, 4):
                for c in (CONTRAST, -CONTRAST):
                    got = contamination_fused(x, c, k, cm, return_labels=True)
                    want = contamination_fused_reference(x, c, k, cm,
                                                         return_labels=True)
                    errs[f"{form}_k{k}_{c}"] = max_abs_err(got, want)
        # the launches the C entry reports for this size, against a trace
        traced = sum(cuda_kernels(
            lambda: contamination_fused(x, CONTRAST, K, False)).values())
        told = lib.hd_fused_detect_launches(h, w)
        phase(f"check fused tile and label cases {h}x{w} ({len(frames)} "
              f"frames): max_abs_err {errs}; {traced} CUDA launches a call "
              f"traced, {told} reported")
        if traced != told:
            fail(f"fused_detect made {traced} launches at {h}x{w}, its C "
                 f"entry reports {told}")
        err = max(err, *errs.values())
    if err:
        fail("fused_detect differs from its plain version on the tile and "
             "label cases")
    return err


def stats_bytes(n):
    """Bytes the banded stats of n 2 MP frames must move: labels 4, mask
    1 and gray 1 B/px in, 12 sums a slot out."""
    return n * H2 * W2 * 6 + n * 12 * K * 4


def check_window_cases(dev):
    """Phase 3b's cases whose bbox windows attack the bbox sums' row walk
    (scripts/profile_bbox_sums.py's window_case_checks on
    scene.window_case_masks: the whole frame, a disk over all but the edge
    bands, full-height columns on the first and last column, the corners,
    blobs ending on band edges, more blobs in one band than slots, no blob)
    at 1920x1080 on random gray and colour: the banded stats and the bbox
    sums against their plain versions, bands WINDOW_BANDS, K WINDOW_KS,
    without colour, with BGR frames and with BGR planes, and the bbox sums
    also with the slot counts raised past K.  Returns the largest error (0
    or the run fails)."""
    import torch
    from heimdall_tpu_torch.ops import stats_tiled as st
    from heimdall_tpu_torch.scripts import profile_bbox_sums as pb

    errs = {}
    for band, name, stats, boxes in pb.window_case_checks(
            H2, W2, WINDOW_BANDS, WINDOW_KS, dev, seed=12):
        sums = st.banded_stats(*stats)
        e = max_abs_err(sums, st.banded_stats_reference(*stats))
        for box in boxes:
            e = max(e, max_abs_err((st.bbox_sums(sums[1], *box),),
                                   (st.bbox_sums_reference(sums[1], *box),)))
        errs.setdefault(band, {})[name] = e
    torch.cuda.synchronize()
    for band, e in errs.items():
        phase(f"check 2MP window cases {H2}x{W2} band {band}: banded_stats "
              f"+ bbox_sums max_abs_err {e}")
    err = max(max(e.values()) for e in errs.values())
    if err:
        fail("the bbox sums differ from their plain version on the window "
             "cases")
    return err


def tiled_phases(dev, smi, argv):
    """Phases 3b, 4b and 5 of the band-tiled 2 MP route; returns
    (largest check error, {kernel: launches}, {kernel: timings})."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import ContaminationDetector, scene
    from heimdall_tpu_torch.detectors.contamination_detector import TILED_BAND
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import stats_tiled as st
    from heimdall_tpu_torch.scripts import profile_bbox_sums as pb

    band = TILED_BAND
    wrappers = {"preprocess": fk.preprocess, "flood_fill": ct.flood_fill,
                "band_ccl": ct.band_ccl, "merge_bands": ct.merge_bands,
                "banded_stats": st.banded_stats, "bbox_sums": st.bbox_sums}

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # -- 3b. tiled kernels against their plain versions --------------------
    bench = scene.make_frames(4, H2, W2, seed=2)
    masks = scene.adversarial_masks(H2, W2, seed=1)
    adv = scene.mask_frames(list(masks.values()))
    adv_masks = on(np.stack(list(masks.values())))
    odd = scene.make_frames(2, *ODD_2MP, seed=5)
    err = 0
    for name, x, cm, k, mask in (
            ("bench4_mono8", on(bench[..., 1]), False, K, None),
            ("bench4_bgr_nhwc", on(bench), False, K, None),
            ("bench4_bgr_channel_major", on(bench.transpose(0, 3, 1, 2)),
             True, K, None),
            ("adversarial_frames", on(adv.transpose(0, 3, 1, 2)), True, K,
             None),
            ("adversarial_masks", on(adv[..., 0]), False, K, adv_masks),
            ("adversarial_masks_k4", on(adv[..., 0]), False, 4, adv_masks),
            ("bench2_odd_mono8", on(odd[..., 2]), False, K, None)):
        err = max(err, check_tiled(name, x, cm, k, band, mask))
    err = max(err, check_tile_cases(dev))
    err = max(err, check_label_cases(dev))
    err = max(err, check_window_cases(dev))

    # -- 4b. the 2 MP main path --------------------------------------------
    frames = scene.make_frames(BATCH_2MP, H2, W2, seed=2)
    mono_np = np.ascontiguousarray(frames[..., 1])
    x = on(mono_np)
    det = ContaminationDetector(config={"include_contours": False})
    det_c = ContaminationDetector(config={"include_contours": True})
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    table, conf, accepted = det.run_device(x)
    torch.cuda.set_sync_debug_mode("default")
    reject, max_conf = det.verdict_device(x)
    defects = det_c.detect_batch(mono_np[:2])
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    phase(f"main path 2MP: run_device + verdict_device + detect_batch "
          f"(1920x1080 Mono8, batch {BATCH_2MP}) launched {launches}; "
          f"run_device made no host sync")
    if not all(launches.values()):
        fail("the 2 MP main path did not go through every tiled kernel")
    if (table.area.shape != (BATCH_2MP, K)
            or not bool(torch.isfinite(conf).all())
            or not bool(torch.isfinite(table.area).all())):
        fail("2 MP outputs have the wrong shape or are not finite")
    cpu = ContaminationDetector(config={"include_contours": False},
                                device="cpu")
    t_cpu, c_cpu, a_cpu = cpu.run_device(mono_np[:2])
    for f in table._fields:
        if not torch.equal(getattr(table, f)[:2].cpu(), getattr(t_cpu, f)):
            fail(f"2 MP table field {f} differs from the CPU path")
    if not (torch.equal(conf[:2].cpu(), c_cpu)
            and torch.equal(accepted[:2].cpu(), a_cpu)):
        fail("2 MP confidence/gates differ from the CPU path")
    if not all(d and all("contour" in e.metadata for e in d) for d in defects):
        fail("2 MP detect_batch with contours returned no contoured defects")
    phase(f"main path 2MP: n_blobs[:8] {table.n_blobs[:8].tolist()} "
          f"rejects {int(reject.sum())}/{BATCH_2MP} "
          f"max conf {float(max_conf.max()):.6f} "
          f"defects/frame (contours) {[len(d) for d in defects]}; "
          f"first 2 frames equal to the CPU path")

    # -- 5. times: each tiled kernel, its plain version, its bound ----------
    xt = x[:TIME_BATCH_2MP]
    kern = tiled_stages(xt, False, K, band)
    gray, binary = kern["preprocess"]
    (filled,) = kern["flood_fill"]
    lab, roots, counts = kern["band_ccl"]
    labels, rl, n, sl, sc = kern["merge_bands"]
    sums, bbox = kern["banded_stats"]
    px = TIME_BATCH_2MP * H2 * W2
    buf = torch.empty_like(lab)
    calls = {
        "preprocess": (lambda: fk.preprocess(xt, CONTRAST),
                       lambda: fk.preprocess_reference(xt, CONTRAST)),
        "flood_fill": (lambda: ct.flood_fill(binary),
                       lambda: ct.flood_reference(binary)),
        "band_ccl": (lambda: ct.band_ccl(filled, band, 8, 128),
                     lambda: ct.band_ccl_reference(filled, band, 8, 128)),
        "merge_bands": (lambda: ct.merge_bands(buf, roots, counts, band, 8,
                                               K),
                        lambda: ct.merge_reference(lab, roots, counts, band,
                                                   8, K)),
        "banded_stats": (lambda: st.banded_stats(labels, filled, gray, None,
                                                 rl, n, K),
                         lambda: st.banded_stats_reference(
                             labels, filled, gray, None, rl, n, K)),
        "bbox_sums": (lambda: st.bbox_sums(bbox, sl, sc, band, gray),
                      lambda: st.bbox_sums_reference(bbox, sl, sc, band,
                                                     gray)),
    }
    # bytes each function must move: inputs read once, outputs written once
    R = -(-H2 // band)
    small = TIME_BATCH_2MP * (R * 128 + R + K + 1 + R * K + R) * 4
    moved = {
        "preprocess": px * 3,                       # frame in, gray + binary
        "flood_fill": px * 2,                       # mask in, filled out
        "band_ccl": px * 5 + small,                 # mask in, labels out
        "merge_bands": px * 8 + small,              # labels in and out
        "banded_stats": stats_bytes(TIME_BATCH_2MP),
        "bbox_sums": pb.window_bytes(bbox, sl, sc, band, 1),
    }
    # the CUDA kernels of one band labeling and one bbox sums call, from a
    # trace of each
    band_kernels = cuda_kernels(calls["band_ccl"][0])
    if band_kernels != dict.fromkeys(BAND_CCL_KERNELS, 1):
        fail(f"band_ccl launched {band_kernels}, not one each of "
             f"{BAND_CCL_KERNELS}")
    box_kernels = cuda_kernels(calls["bbox_sums"][0])
    phase(f"bbox_sums: CUDA kernels per call (traced) {box_kernels}")
    if box_kernels != {"k_bbox_sums": 1}:
        fail(f"bbox_sums launched {box_kernels}, not one k_bbox_sums")
    timings = {}
    for name, (kfn, pfn) in calls.items():
        if name == "merge_bands":      # merges in place: restore its input
            ms = cuda_ms_only(lambda: buf.copy_(lab), kfn, 10)
        else:
            kfn()
            ms = cuda_ms(kfn, 10)
        pfn()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(pfn, 1)
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = mean_ops_ms(px) if name == "preprocess" else 0.0
        timings[name] = dict(ms=ms, plain_ms=plain_ms,
                             bound_ms=max(bytes_ms, ops_ms),
                             bound_by="bytes" if bytes_ms >= ops_ms
                             else "operations", bytes=moved[name])
        if name == "band_ccl":
            timings[name]["cuda_kernels"] = band_kernels
        if name == "bbox_sums":
            timings[name]["cuda_kernels"] = box_kernels
        phase(f"{smi}: {name} {ms:.4f} ms per {TIME_BATCH_2MP} frames of "
              f"1920x1080 Mono8 ({ms / TIME_BATCH_2MP * 1e3:.3f} us/frame); "
              f"plain version {plain_ms:.2f} ms; bound "
              f"{timings[name]['bound_ms']:.4f} ms (by "
              f"{timings[name]['bound_by']}; {moved[name]} bytes)")

    # B4a also at the main path's batch (kernel only)
    kern = tiled_stages(x, False, K, band)
    gray, _ = kern["preprocess"]
    (filled,) = kern["flood_fill"]
    labels, rl, n, _, _ = kern["merge_bands"]
    del kern
    ms = cuda_ms(lambda: st.banded_stats(labels, filled, gray, None, rl, n,
                                         K), 10)
    bound_ms = stats_bytes(BATCH_2MP) / HBM_BYTES_PER_S * 1e3
    timings["banded_stats"].update(ms_batch_128=ms,
                                   bound_ms_batch_128=bound_ms)
    phase(f"{smi}: banded_stats {ms:.4f} ms per {BATCH_2MP} frames of "
          f"1920x1080 Mono8 ({ms / BATCH_2MP * 1e3:.3f} us/frame); bound "
          f"{bound_ms:.4f} ms (by bytes; {stats_bytes(BATCH_2MP)} bytes)")
    del gray, filled, labels, rl, n

    # B4b at the main path's batch on scripts/profile_bbox_sums.py's three
    # inputs (bench Mono8, bench BGR through the run tables, the window
    # cases), each beside its bound, its time on empty slot lists and one
    # empty kernel's time
    x_bgr = on(frames.transpose(0, 3, 1, 2))
    inputs, floor = pb.measure(pb.make_inputs(x, x_bgr, band, K))
    del x_bgr
    timings["bbox_sums"].update(
        ms_batch_128=inputs["bench_mono8"]["ms"][0],
        bound_ms_batch_128=inputs["bench_mono8"]["bound_ms"],
        inputs_batch_128=inputs, launch_floor_ms=floor)
    for name, r in inputs.items():
        phase(f"{smi}: bbox_sums on {name}: {r['ms'][0]:.4f} / "
              f"{r['ms'][1]:.4f} ms per {BATCH_2MP} frames of 1920x1080 "
              f"({r['ms'][0] / BATCH_2MP * 1e3:.4f} us/frame); empty slot "
              f"lists {r['empty_lists_ms'][0]:.4f} ms; bound "
              f"{r['bound_ms']:.4f} ms (by bytes; {r['bytes']} bytes); one "
              f"empty kernel {floor[0]:.4f} ms")

    det.run_device(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        det.run_device(x)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 5
    host = host_ms(lambda: det.run_device(x))
    e2e = {"2mp_mono8": {"ms": dt * 1e3, "host_ms": host}}
    phase(f"{smi}: main path 2MP mono8 end to end {dt * 1e3:.3f} ms per "
          f"batch of {BATCH_2MP} = {BATCH_2MP / dt:.1f} frames/s; host "
          f"time per run_device call (returned, before the sync) "
          f"{host:.3f} ms")

    if "--profile" in argv:
        out_dir = argv[argv.index("--profile") + 1]
        os.makedirs(out_dir, exist_ok=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                det.run_device(x)
            torch.cuda.synchronize()
        text = prof.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=40)
        with open(os.path.join(out_dir, "tiled_2mp_profile.txt"), "w") as fh:
            fh.write(f"{smi}\n3 x run_device, 1920x1080 Mono8, batch "
                     f"{BATCH_2MP}\n{text}\n")
        phase(f"profile: {out_dir}/tiled_2mp_profile.txt")
    return err, launches, timings, e2e


def runtable_stages(x, channel_major, k, band, mask=None, plain=False):
    """The run-table route's kernels on frames x, or with mask from the
    mask's background tables, by kernel or by plain version; every frame
    goes through every kernel: {kernel: outputs}."""
    from heimdall_tpu_torch.ops import preprocess_tiled as pt
    from heimdall_tpu_torch.ops import runtable_tiled as rt
    out = {}
    if mask is None:
        pre = (pt.contamination_preprocess_tiled_reference if plain
               else pt.contamination_preprocess_tiled)
        out["preprocess_tiled"] = pre(x, CONTRAST, channel_major, RT_BG)
        mask = out["preprocess_tiled"][0]
    W = mask.shape[-1]
    ext = rt.run_extract_reference if plain else rt.run_extract
    out["run_extract"] = runid, S, E, _ = ext(mask, RT_BG, True)
    fix = rt.flood_fix_reference if plain else rt.flood_fix
    out["flood_fix"] = (fix(S, E, W),)
    fill = rt.fill_extract_reference if plain else rt.fill_extract
    out["fill_extract"] = filled, runid_fg, S_fg, E_fg, _ = fill(
        mask, runid, out["flood_fix"][0], RT_FG)
    lab = rt.label_fix_reference if plain else rt.label_fix
    out["label_fix"] = lab(S_fg, E_fg, W, band, k)
    wb = rt.writeback_reference if plain else rt.writeback
    out["writeback"] = (wb(filled, runid_fg, out["label_fix"][0]),)
    return out


def check_runtable(name, x, channel_major, k, band, mask=None):
    """Hold every run-table kernel against its plain version on one case,
    and the route with the detector's guards against the band route; the
    largest error (0 or the run fails)."""
    import torch
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import runtable_tiled as rt
    got = runtable_stages(x, channel_major, k, band, mask)
    torch.cuda.synchronize()
    want = runtable_stages(x, channel_major, k, band, mask, plain=True)
    torch.cuda.synchronize()
    errs = {s: max_abs_err(got[s], want[s]) for s in got}
    binary = got["preprocess_tiled"][0] if mask is None else mask
    route = rt.fill_label_runtable_tiled(
        binary, band, max_blobs=k, r_bg=RT_BG, r_fg=RT_FG,
        pre_extracted=got["run_extract"])
    on_tables = rt.fill_label_runtable_tiled.last_route.tolist()
    filled = ct.fill_holes_tiled(binary, band=band)
    bands = (filled,) + ct.connected_components_tiled(
        filled, band=band, return_roots=k, band_slots=True)
    errs["route_vs_band_route"] = max_abs_err(route, bands)
    phase(f"check 2MP run tables {name}: n_blobs {route[3].tolist()[:8]} "
          f"frames on the tables {on_tables} max_abs_err {errs}")
    if any(errs.values()):
        fail(f"a run-table kernel differs from its plain version on {name}")
    return max(errs.values())


def check_run_cases(dev, band):
    """Phase 3c's cases that attack the run extraction's lanes and steps
    (scene.run_case_masks) at the run-case sizes, 1920x1080 and 1037x1531:
    run_extract (both inverts, R 8, 12, 40) and fill_extract (r_bg / r_fg
    8 / 7, 12 / 10, 40 / 7; flags drawn at random and the border flood's)
    against their plain versions, and the whole route on the masks (every
    kernel against its plain version, the route against the band route);
    then the CUDA kernels of one call of each, and of the two union-finds
    between them, from a trace, which must be one launch of its kernel.
    Returns (the largest error, 0 or the run fails; {wrapper: {CUDA kernel:
    launches}})."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import runtable_tiled as rt

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng = np.random.RandomState(11)
    err = 0
    for h, w in scene.RUN_CASE_SIZES + ((H2, W2), ODD_2MP):
        cases = np.stack(list(scene.run_case_masks(h, w).values()))
        masks = on(cases)
        u8 = masks.to(torch.uint8) * 255
        errs = {}
        for R in RUN_R:
            for inv in (False, True):
                errs[f"run_extract_{R}{'_inv' if inv else ''}"] = \
                    max_abs_err(rt.run_extract(u8, R, inv),
                                rt.run_extract_reference(u8, R, inv))
        for r_bg, r_fg in FILL_R:
            runid, S, E, _ = rt.run_extract(masks, r_bg, True)
            for how, F in (
                    ("random", on(rng.randint(0, 2, (len(cases), h, r_bg))
                                  .astype(np.int32))),
                    ("flood", rt.flood_fix(S, E, w))):
                errs[f"fill_extract_{r_bg}_{r_fg}_{how}"] = max_abs_err(
                    rt.fill_extract(masks, runid, F, r_fg),
                    rt.fill_extract_reference(masks, runid, F, r_fg))
        torch.cuda.synchronize()
        phase(f"check 2MP run cases {h}x{w} ({len(cases)} masks): "
              f"max_abs_err {errs}")
        err = max(err, *errs.values(),
                  check_runtable(f"run_case_masks_{h}x{w}", None, False, K,
                                 band, masks))
    traced = {}
    for h, w in ((H2, W2), ODD_2MP):
        masks = on(np.stack(list(scene.run_case_masks(h, w).values())))
        runid, S, E, _ = rt.run_extract(masks, RT_BG, True)
        F = rt.flood_fix(S, E, w)
        S_fg, E_fg = rt.fill_extract(masks, runid, F, RT_FG)[2:4]
        traced = {
            "run_extract": cuda_kernels(
                lambda: rt.run_extract(masks, RT_BG, True)),
            "flood_fix": cuda_kernels(lambda: rt.flood_fix(S, E, w)),
            "fill_extract": cuda_kernels(
                lambda: rt.fill_extract(masks, runid, F, RT_FG)),
            "label_fix": cuda_kernels(
                lambda: rt.label_fix(S_fg, E_fg, w, band, K))}
        phase(f"run cases {h}x{w}: CUDA kernels per call (traced) {traced}")
        for name, got in traced.items():
            if got != {"k_" + name: 1}:
                fail(f"{name} launched {got}, not one k_{name}")
    if err:
        fail("a run extraction kernel differs from its plain version on the "
             "run cases")
    return err, traced


def check_fix_cases(dev, band):
    """Phase 3c's cases whose components cross every row block of the
    union-finds (scene.fix_case_masks) at scene.FIX_CASE_SIZES: every
    run-table kernel against its plain version and the route against the
    band route (check_runtable), every frame on the tables, and the label
    fix also with band 16 and K 4 and with band 1, both union-finds on
    their cluster path; then two [h, 64] masks at R 12 (noise, a bar with a
    hole down most of its height): 5000 rows on the cluster path, 16000 on
    the global-scratch path.  Returns the largest error (0 or the run
    fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import runtable_tiled as rt

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def fixes(masks, r_bg, r_fg, labelings):
        W = masks.shape[-1]
        runid, S, E, _ = rt.run_extract(masks, r_bg, True)
        F = rt.flood_fix(S, E, W)
        errs = {"flood_fix": max_abs_err(
            (F,), (rt.flood_fix_reference(S, E, W),))}
        paths = {rt.flood_fix.last_path}
        S_fg, E_fg = rt.fill_extract(masks, runid, F, r_fg)[2:4]
        for b, k in labelings:
            errs[f"label_fix_band{b}_k{k}"] = max_abs_err(
                rt.label_fix(S_fg, E_fg, W, b, k),
                rt.label_fix_reference(S_fg, E_fg, W, b, k))
            paths.add(rt.label_fix.last_path)
        torch.cuda.synchronize()
        return errs, paths

    err = 0
    for h, w in scene.FIX_CASE_SIZES:
        masks = on(np.stack(list(scene.fix_case_masks(h, w).values())))
        err = max(err, check_runtable(f"fix_case_masks_{h}x{w}", None, False,
                                      K, band, masks))
        if not bool(rt.fill_label_runtable_tiled.last_route.all()):
            fail(f"a fix case at {h}x{w} did not take the run tables")
        errs, paths = fixes(masks, RT_BG, RT_FG, ((16, 4), (1, K)))
        phase(f"check 2MP fix cases {h}x{w} ({len(masks)} masks): "
              f"union-find paths {sorted(paths)} max_abs_err {errs}")
        if paths != {"cluster"}:
            fail(f"a union-find at {h}x{w} took {paths}, not its cluster")
        err = max(err, *errs.values())
    for h, path in ((5000, "cluster"), (16000, "scratch")):
        tall = np.zeros((2, h, 64), bool)
        tall[0] = np.random.RandomState(1).rand(h, 64) < 0.1
        tall[1, :, 10:20] = True
        tall[1, 100:h - 100, 14:16] = False
        errs, paths = fixes(on(tall), 12, 12, ((band, K),))
        phase(f"check tall tables {h}x64 R 12: union-find paths "
              f"{sorted(paths)} max_abs_err {errs}")
        if paths != {path}:
            fail(f"the union-finds at {h}x64 took {paths}, not {path}")
        err = max(err, *errs.values())
    if err:
        fail("a union-find kernel differs from its plain version on the fix "
             "cases")
    return err


def _stripes(h, w, n=8):
    """n full-height stripes from column 0 to column w-1: n - 1 background
    runs per row, n foreground runs (only the foreground guard trips)."""
    import numpy as np
    m = np.zeros((h, w), bool)
    for s in np.linspace(0, w - 4, n).astype(int):
        m[:, s:s + 4] = True
    return m


def runtable_calls(xt, band):
    """Phase 5's calls of each run-table kernel and its plain version on
    the frames xt (BGR channel-major), with their inputs made by the
    kernels, and the bytes each function must move (inputs read once,
    outputs written once): ({kernel: (kernel call, plain call)},
    {kernel: bytes})."""
    from heimdall_tpu_torch.ops import preprocess_tiled as pt
    from heimdall_tpu_torch.ops import runtable_tiled as rt
    kern = runtable_stages(xt, True, K, band)
    binary, gray, runid, S, E, nrun = kern["preprocess_tiled"]
    (F,) = kern["flood_fix"]
    filled, runid_fg, S_fg, E_fg, nrun_fg = kern["fill_extract"]
    L = kern["label_fix"][0]
    calls = {
        "preprocess_tiled": (
            lambda: pt.contamination_preprocess_tiled(xt, CONTRAST, True,
                                                      RT_BG),
            lambda: pt.contamination_preprocess_tiled_reference(
                xt, CONTRAST, True, RT_BG)),
        "run_extract": (lambda: rt.run_extract(binary, RT_BG, True),
                        lambda: rt.run_extract_reference(binary, RT_BG,
                                                         True)),
        "flood_fix": (lambda: rt.flood_fix(S, E, W2),
                      lambda: rt.flood_fix_reference(S, E, W2)),
        "fill_extract": (lambda: rt.fill_extract(binary, runid, F, RT_FG),
                         lambda: rt.fill_extract_reference(binary, runid, F,
                                                           RT_FG)),
        "label_fix": (lambda: rt.label_fix(S_fg, E_fg, W2, band, K),
                      lambda: rt.label_fix_reference(S_fg, E_fg, W2, band,
                                                     K)),
        "writeback": (lambda: rt.writeback(filled, runid_fg, L),
                      lambda: rt.writeback_reference(filled, runid_fg, L)),
    }
    n = len(xt)
    px, rows = n * H2 * W2, n * H2
    Rb = -(-H2 // band)

    def tables(r):          # S, E [rows, r] and nrun [rows, 1], int32
        return rows * (2 * r + 1) * 4

    moved = {
        "preprocess_tiled": px * 3 + px * 3 + tables(RT_BG),
        "run_extract": px * 2 + tables(RT_BG),
        "flood_fix": rows * RT_BG * 4 * 3,
        "fill_extract": px * 4 + rows * RT_BG * 4 + tables(RT_FG),
        "label_fix": rows * RT_FG * 4 * 3 + n * (K + 1 + Rb * K + Rb) * 4,
        "writeback": px * 6 + rows * RT_FG * 4,
    }
    return calls, moved


def runtable_phases(dev, smi, argv):
    """Phases 3c, 4c and 5 of the run-table 2 MP route (BGR); returns
    (largest check error, {kernel: launches}, {kernel: timings})."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import ContaminationDetector, scene
    from heimdall_tpu_torch.detectors.contamination_detector import (
        TILED_BAND, contamination_program)
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import preprocess_tiled as pt
    from heimdall_tpu_torch.ops import runtable_tiled as rt
    from heimdall_tpu_torch.ops import stats_tiled as st

    band = TILED_BAND
    new = {"preprocess_tiled": pt.contamination_preprocess_tiled,
           "run_extract": rt.run_extract, "flood_fix": rt.flood_fix,
           "fill_extract": rt.fill_extract, "label_fix": rt.label_fix,
           "writeback": rt.writeback}
    wrappers = dict(new, preprocess=fk.preprocess, flood_fill=ct.flood_fill,
                    band_ccl=ct.band_ccl, merge_bands=ct.merge_bands,
                    banded_stats=st.banded_stats, bbox_sums=st.bbox_sums)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # -- 3c. run-table kernels against their plain versions ----------------
    bench = scene.make_frames(4, H2, W2, seed=2)
    masks = scene.adversarial_masks(H2, W2, seed=1)
    adv = scene.mask_frames(list(masks.values()))
    checker = np.zeros((H2, W2), bool)
    checker[H2 // 3:H2 // 3 + 9] = np.arange(W2) % 6 < 3
    guards = np.stack([scene.make_frames(1, H2, W2, seed=3)[0, ..., 1] < 120,
                       _stripes(H2, W2), checker])
    odd = scene.make_frames(2, *ODD_2MP, seed=5)
    err = 0
    for name, x, cm, k, mask in (
            ("bench4_bgr_nhwc", on(bench), False, K, None),
            ("bench4_bgr_channel_major", on(bench.transpose(0, 3, 1, 2)),
             True, K, None),
            ("adversarial_frames", on(adv.transpose(0, 3, 1, 2)), True, K,
             None),
            ("adversarial_masks_k4", None, False, 4,
             on(np.stack(list(masks.values())))),
            ("guards_mixed_batch", None, False, K, on(guards)),
            ("bench2_odd_bgr", on(odd), False, K, None)):
        err = max(err, check_runtable(name, x, cm, k, band, mask))
    for h, w in scene.TILE_CASE_SIZES + ((H2, W2),):    # the tile cases
        tm = np.stack(list(scene.tile_case_masks(h, w).values()))
        tf = np.stack(list(scene.tile_case_frames(h, w).values()))
        err = max(err, check_runtable(f"tile_case_masks_{h}x{w}", None,
                                      False, K, band, on(tm)),
                  check_runtable(f"tile_case_frames_{h}x{w}", on(tf), False,
                                 K, band))
    run_err, traced = check_run_cases(dev, band)    # the run cases
    err = max(err, run_err, check_fix_cases(dev, band))

    # -- 4c. the BGR 2 MP main path ----------------------------------------
    frames = scene.make_frames(BATCH_2MP, H2, W2, seed=2)
    x = on(frames.transpose(0, 3, 1, 2))
    det = ContaminationDetector(config={"include_contours": False})
    det_c = ContaminationDetector(config={"include_contours": True})
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    table, conf, accepted = det.run_device(x, channel_major=True)
    on_tables = rt.fill_label_runtable_tiled.last_route.clone()
    torch.cuda.set_sync_debug_mode("default")
    reject, max_conf = det.verdict_device(x, channel_major=True)
    defects = det_c.detect_batch(frames[:2])
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    n_tables = int(on_tables.sum())
    phase(f"main path 2MP BGR: run_device + verdict_device + detect_batch "
          f"(1920x1080 BGR channel-major, batch {BATCH_2MP}) launched "
          f"{launches}; run_device made no host sync; frames on the run "
          f"tables {n_tables}, on the band route {BATCH_2MP - n_tables}")
    if not all(launches[n] for n in new):
        fail("the BGR 2 MP main path did not go through every run-table "
             "kernel")
    if (table.area.shape != (BATCH_2MP, K)
            or not bool(torch.isfinite(conf).all())
            or not bool(torch.isfinite(table.area).all())):
        fail("BGR 2 MP outputs have the wrong shape or are not finite")
    cpu = ContaminationDetector(config={"include_contours": False},
                                device="cpu")
    t_cpu, c_cpu, a_cpu = cpu.run_device(
        np.ascontiguousarray(frames[:2].transpose(0, 3, 1, 2)),
        channel_major=True)
    for f in table._fields:
        if not torch.equal(getattr(table, f)[:2].cpu(), getattr(t_cpu, f)):
            fail(f"BGR 2 MP table field {f} differs from the CPU path")
    if not (torch.equal(conf[:2].cpu(), c_cpu)
            and torch.equal(accepted[:2].cpu(), a_cpu)):
        fail("BGR 2 MP confidence/gates differ from the CPU path")
    if not all(d and all("contour" in e.metadata for e in d) for d in defects):
        fail("BGR 2 MP detect_batch with contours returned no contoured "
             "defects")
    phase(f"main path 2MP BGR: n_blobs[:8] {table.n_blobs[:8].tolist()} "
          f"rejects {int(reject.sum())}/{BATCH_2MP} "
          f"max conf {float(max_conf.max()):.6f} "
          f"defects/frame (contours) {[len(d) for d in defects]}; "
          f"first 2 frames equal to the CPU path")

    # -- 5. times: each run-table kernel, its plain version, its bound ------
    # at TIME_BATCH_2MP, and the B3 kernels (and B2, which launches B3a)
    # also at the main path's batch (kernels only)
    timings = {}
    for n in (TIME_BATCH_2MP, BATCH_2MP):
        calls, moved = runtable_calls(x[:n], band)
        for name, (kfn, pfn) in calls.items():
            if n != TIME_BATCH_2MP and name not in B3_KERNELS + (
                    "preprocess_tiled",):
                continue
            kfn()
            ms = cuda_ms(kfn, 10)
            bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
            ops_ms = (mean_ops_ms(n * H2 * W2) if name == "preprocess_tiled"
                      else 0.0)
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            if n != TIME_BATCH_2MP:
                timings[name].update(ms_batch_128=ms,
                                     bound_ms_batch_128=bound_ms)
                phase(f"{smi}: {name} {ms:.4f} ms per {n} frames of "
                      f"1920x1080 BGR ({ms / n * 1e3:.3f} us/frame); bound "
                      f"{bound_ms:.4f} ms (by {bound_by}; {moved[name]} "
                      f"bytes)")
                continue
            pfn()
            torch.cuda.synchronize()
            plain_ms = cuda_ms(pfn, 1)
            timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, bytes=moved[name])
            phase(f"{smi}: {name} {ms:.4f} ms per {n} frames of 1920x1080 "
                  f"BGR ({ms / n * 1e3:.3f} us/frame); plain version "
                  f"{plain_ms:.2f} ms; bound {bound_ms:.4f} ms (by "
                  f"{bound_by}; {moved[name]} bytes)")
        del calls
    for name in traced:
        timings[name]["cuda_kernels"] = traced[name]

    def band_route(xe):
        return contamination_program(xe, CONTRAST, 10.0, 3000.0, 0.25,
                                     max_blobs=K, tiled_band=band,
                                     channel_major=True, tiled_runtable=False)

    # every fourth frame of the bench batch replaced by an adversarial one
    mixed = x.clone()
    n_adv = mixed[::4].shape[0]
    advc = on(adv.transpose(0, 3, 1, 2))
    mixed[::4] = advc.repeat(-(-n_adv // len(advc)), 1, 1, 1)[:n_adv]
    got = det.run_device(mixed, channel_major=True)
    n_mixed = int(rt.fill_label_runtable_tiled.last_route.sum())
    want = band_route(mixed)
    if not (all(torch.equal(getattr(got[0], f), getattr(want[0], f))
                for f in got[0]._fields)
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
        fail("BGR 2 MP mixed batch: the run-table route with its fallback "
             "differs from the band route")
    phase(f"mixed batch 2MP BGR: frames on the run tables {n_mixed}, on the "
          f"band route {BATCH_2MP - n_mixed}; table, confidence and gates "
          f"equal to the band route's")
    # the bbox sums on the mixed batch's own stats inputs
    binary, gray, *tables = pt.contamination_preprocess_tiled(
        mixed, CONTRAST, True, bg_tables=RT_BG)
    filled, labels, rl, n, sl, sc = rt.fill_label_runtable_tiled(
        binary, band, max_blobs=K, r_bg=RT_BG, r_fg=RT_FG,
        pre_extracted=tables)
    bbox = st.banded_stats(labels, filled, gray, mixed, rl, n, K, True)[1]
    box = (bbox, sl, sc, band, gray, mixed, True)
    box_err = max_abs_err((st.bbox_sums(*box),),
                          (st.bbox_sums_reference(*box),))
    phase(f"mixed batch 2MP BGR: bbox_sums max_abs_err {box_err}")
    if box_err:
        fail("the bbox sums differ from their plain version on the mixed "
             "batch")
    del binary, gray, tables, filled, labels, rl, n, sl, sc, bbox, box
    e2e = {}
    for key, label, fn in (
            ("2mp_bgr_runtable", "bench, run tables (run_device)",
             lambda: det.run_device(x, channel_major=True)),
            ("2mp_bgr_bands", "bench, band route (tiled_runtable=False)",
             lambda: band_route(x)),
            ("2mp_bgr_mixed_runtable",
             f"mixed ({n_mixed} frames on the tables), run tables "
             f"(run_device)",
             lambda: det.run_device(mixed, channel_major=True)),
            ("2mp_bgr_mixed_bands", "mixed, band route (tiled_runtable="
             "False)", lambda: band_route(mixed))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
        host = host_ms(fn)
        e2e[key] = {"ms": dt * 1e3, "host_ms": host}
        phase(f"{smi}: main path 2MP bgr_channel_major {label} end to end "
              f"{dt * 1e3:.3f} ms per batch of {BATCH_2MP} = "
              f"{BATCH_2MP / dt:.1f} frames/s; host time per call "
              f"(returned, before the sync) {host:.3f} ms")
    del mixed

    if "--profile" in argv:
        out_dir = argv[argv.index("--profile") + 1]
        os.makedirs(out_dir, exist_ok=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                det.run_device(x, channel_major=True)
            torch.cuda.synchronize()
        text = prof.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=45)
        with open(os.path.join(out_dir, "tiled_2mp_bgr_profile.txt"),
                  "w") as fh:
            fh.write(f"{smi}\n3 x run_device, 1920x1080 BGR channel-major, "
                     f"batch {BATCH_2MP}\n{text}\n")
        phase(f"profile: {out_dir}/tiled_2mp_bgr_profile.txt")
    return err, {n: launches[n] for n in new}, timings, e2e


def guard_plains():
    """Wrap every plain version of the detector's and the pipelines' kernels
    so that a call on a CUDA tensor is recorded (the paths of phases 4d and
    4e must run none); returns the list of names recorded.
    guard_plains.restore() puts the plain versions back."""
    import torch
    from heimdall_tpu_torch.ops import ccl
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import stats_tiled as st
    on_card = []

    def guard(fn, name):
        def guarded(*args, **kwargs):
            # connected_components with sweeps or max_iters is JAX's sweep
            # labeling, the counterpart of XLA ops that the segmentation
            # detector runs on the card as JAX runs them on the TPU; no
            # kernel's plain version passes either
            sweep_labels = (kwargs.get("sweeps", 0) > 0
                            or kwargs.get("max_iters", 0) > 0)
            if not sweep_labels and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in list(args) + list(kwargs.values())):
                on_card.append(name)
            return fn(*args, **kwargs)
        return guarded

    plains = [(m, n, getattr(m, n)) for m, n in (
        (ccl, "connected_components"), (ccl, "fill_holes"),
        (ct, "connected_components"), (ct, "fill_holes"),
        (ct, "flood_reference"), (ct, "band_ccl_reference"),
        (ct, "merge_reference"), (st, "banded_stats_reference"),
        (st, "bbox_sums_reference"), (fk, "preprocess_reference"),
        (fk, "contamination_fused_reference"))]
    for m, n, f in plains:
        setattr(m, n, guard(f, f"{m.__name__}.{n}"))

    def restore():
        for m, n, f in plains:
            setattr(m, n, f)

    guard_plains.restore = restore
    return on_card


def _defect_lists(defects):
    """Per frame, each defect's type, position, size, confidence, bbox and
    scores (Defect.to_dict), for exact comparison."""
    return [[d.to_dict() for d in r] for r in defects]


def _defect_rows(results):
    """_defect_lists of inspection results."""
    return _defect_lists([r.defects for r in results])


def system_phases(dev, smi):
    """Phase 4d, the system path on the card: the five PipelineFactory types
    on 1920x1080 BGR batches, ContaminationInspector.inspect_batch at
    1920x1080 and 640x480, a System with one inspector station, and main
    -s and --diagnose.  Every wrapper's launch count is set to 0 just before
    and read just after, and no plain version may run on a CUDA tensor in
    between.  Returns ({wrapper: launches}, {kernel: traced launches of one
    2 MP inspect_batch and one bottle_base call}, {kernel: traced launches
    of one 640x480 inspect_batch}, the phase's times)."""
    import warnings
    import numpy as np
    import torch
    from heimdall_tpu_torch import main as cli
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.core.acquisition import SimulationImageSource
    from heimdall_tpu_torch.core.pipeline import PipelineFactory
    from heimdall_tpu_torch.core.system import System
    from heimdall_tpu_torch.detectors import contamination_detector as cd
    from heimdall_tpu_torch.inspection import ContaminationInspector
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import preprocess_tiled as pt
    from heimdall_tpu_torch.ops import runtable_tiled as rt
    from heimdall_tpu_torch.ops import stats_tiled as st

    wrappers = {"preprocess": fk.preprocess, "flood_fill": ct.flood_fill,
                "band_ccl": ct.band_ccl, "merge_bands": ct.merge_bands,
                "banded_stats": st.banded_stats, "bbox_sums": st.bbox_sums,
                "fused_detect": fk.contamination_fused}
    # the BGR run-table route: the inspector's detector sees Mono8 frames,
    # so these stay at 0
    others = {"preprocess_tiled": pt.contamination_preprocess_tiled,
              "run_extract": rt.run_extract, "flood_fix": rt.flood_fix,
              "fill_extract": rt.fill_extract, "label_fix": rt.label_fix,
              "writeback": rt.writeback}
    tables = []
    download_table = cd.download_table

    def counted_download(*args):
        tables.append(1)
        return download_table(*args)

    def count_syncs(fn):
        """Host syncs of one call of fn, by CUDA sync-debug "warn"."""
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(c.message) for c in caught)

    def sim(n, h, w):
        src = SimulationImageSource("cam", {"width": w, "height": h,
                                            "seed": 0,
                                            "defect_probability": 0.3})
        src.open()
        return src.read_batch(n)[1]

    times = {"card": smi}
    torch.cuda.synchronize()
    for w in list(wrappers.values()) + list(others.values()):
        w.launches = 0
    cd.download_table = counted_download
    plain_on_card = guard_plains()
    try:
        # -- the five pipeline types, batch 8 at 1920x1080 BGR -------------
        frames8 = scene.make_frames(PIPE_BATCH, H2, W2, seed=2)
        x8 = torch.from_numpy(frames8).to(dev)
        pipes = {t: PipelineFactory.create_pipeline(t, t)
                 for t in PIPELINE_TYPES}
        times["process_batch_ms"] = {}
        times["process_batch_device_only_syncs"] = syncs = {}
        for t, p in pipes.items():
            got = p.process_batch(x8)
            got2 = p.process_batch(frames8[:2])
            want = PipelineFactory.create_pipeline(
                t, t, device="cpu").process_batch(frames8[:2])
            same = (np.array_equal(got["result_image"][:2],
                                   want["result_image"])
                    and np.array_equal(got2["result_image"],
                                       want["result_image"])
                    and got2.get("contour_count") == want.get(
                        "contour_count")
                    and got.get("line_count") == got2.get("line_count")
                    == want.get("line_count")
                    and np.array_equal(got2.get("lines", 0),
                                       want.get("lines", 0)))
            if not same:
                fail(f"pipeline {t} on the card differs from the CPU path")
            for _ in range(2):
                p.process_batch(x8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                p.process_batch(x8)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
            times["process_batch_ms"][t] = ms
            syncs[t] = count_syncs(
                lambda: p.process_batch(x8, device_only=True))
            if syncs[t] and t not in CANNY_TYPES:
                fail(f"pipeline {t} made {syncs[t]} host syncs with "
                     f"device_only")
            phase(f"system path: pipeline {t}: first 2 frames equal to the "
                  f"CPU path (image, contour_count "
                  f"{want.get('contour_count')}, line_count "
                  f"{want.get('line_count')}); {smi}: process_batch "
                  f"{ms:.3f} ms per batch of {PIPE_BATCH} 1920x1080 BGR "
                  f"(frames on the card, results downloaded); host syncs "
                  f"with device_only {syncs[t]}")
        traced_2mp = cuda_kernels(lambda: pipes["bottle_base"].process_batch(
            x8, device_only=True), runs=2)

        # -- the inspector at 1920x1080 and 640x480 -------------------------
        times["inspect_batch"] = {}
        traced_640 = {}
        for h, w in ((H2, W2), (480, 640)):
            size = f"{w}x{h}"
            frames = sim(SYSTEM_BATCH, h, w)
            xs = torch.from_numpy(frames).to(dev)
            insp = ContaminationInspector("insp")
            cpu = ContaminationInspector("insp", device="cpu")
            rings = scene.ring_frames(2, h, w, seed=3)
            checked = []
            for name, batch in (("simulation", frames), ("rings", rings)):
                got = _defect_rows(insp.inspect_batch(batch)[:2])
                want = _defect_rows(cpu.inspect_batch(batch[:2]))
                if got != want:
                    fail(f"inspect_batch {size} {name}: defects differ "
                         f"from the CPU path")
                checked.append(sum(map(len, want)))
            syncs = {}
            for form, arg in (("numpy", frames), ("on the card", xs)):
                del tables[:]
                syncs[form] = (count_syncs(lambda: insp.inspect_batch(arg)),
                               len(tables))
            for _ in range(2):
                insp.inspect_batch(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                insp.inspect_batch(frames)
            ms = (time.perf_counter() - t0) / 3 * 1e3
            # on frames already on the card: the pipeline's and the
            # detector's share by CUDA events, and the host's time until
            # both are queued (before the table's download waits)
            det = insp.detectors[0]
            pipe_ms = det_ms = host = 0.0
            for _ in range(3):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[0].record()
                ctx = insp.pipeline.process_batch(xs, device_only=True)
                ev[1].record()
                out = det.run_device(ctx["result_image"])
                ev[2].record()
                host += (time.perf_counter() - t0) / 3 * 1e3
                download_table(*out[:3])
                pipe_ms += ev[0].elapsed_time(ev[1]) / 3
                det_ms += ev[1].elapsed_time(ev[2]) / 3
            times["inspect_batch"][size] = {
                "ms": ms, "frames_per_s": SYSTEM_BATCH / ms * 1e3,
                "host_ms": host, "pipeline_ms": pipe_ms,
                "detector_ms": det_ms, "syncs_numpy": syncs["numpy"][0],
                "syncs_on_card": syncs["on the card"][0],
                "tables_downloaded": syncs["numpy"][1]}
            phase(f"system path: inspect_batch {size}: first 2 frames' "
                  f"defects equal to the CPU path (simulation {checked[0]}, "
                  f"rings {checked[1]} defects); host syncs per call "
                  f"{syncs['numpy'][0]} from numpy, {syncs['on the card'][0]}"
                  f" from the card, tables downloaded per call "
                  f"{syncs['numpy'][1]}")
            phase(f"{smi}: inspect_batch {size} {ms:.3f} ms per batch of "
                  f"{SYSTEM_BATCH} (numpy frames, upload included) = "
                  f"{SYSTEM_BATCH / ms * 1e3:.1f} frames/s; from frames on "
                  f"the card: host {host:.3f} ms per call until its work "
                  f"is queued; pipeline {pipe_ms:.3f} ms, detector "
                  f"{det_ms:.3f} ms (CUDA events)")
            traced = cuda_kernels(lambda: insp.inspect_batch(xs), runs=2)
            if h == H2:
                for k, n in traced.items():
                    traced_2mp[k] = traced_2mp.get(k, 0) + n
            else:
                traced_640 = traced

        # -- a System with one inspector station ----------------------------
        sysm = System()
        sysm.config.add_camera("cam", {
            "type": "simulation", "width": W2, "height": H2, "seed": 0,
            "defect_probability": 0.3})
        sysm.add_station("insp", {"camera_id": "cam",
                                  "inspector": "contamination",
                                  "reject": True})
        station = sysm.stations["insp"]
        seen = []
        inspect = station.inspector.inspect_batch

        def recording(*args, **kwargs):
            out = inspect(*args, **kwargs)
            seen.extend(out)
            return out

        station.inspector.inspect_batch = recording
        sysm.start()
        time.sleep(3)
        sysm.stop()
        st_status = sysm.get_status()["stations"]["insp"]
        if not (station.frames_processed > 0 and
                len(seen) == station.frames_processed
                and all(r.success for r in seen)):
            fail(f"the inspector station processed {len(seen)} frames, not "
                 f"all successfully")
        times["station_avg_processing_ms"] = {
            "inspector_1920x1080": st_status["avg_processing_time"] * 1e3}
        phase(f"system path: inspector station (1920x1080, batch "
              f"{station.batch_size}, reject on): "
              f"{station.frames_processed} frames in 3 s, every result a "
              f"success, {station.defects_detected} defects, rejects "
              f"scheduled {station.rejector.stats()['scheduled']}; {smi}: "
              f"avg_processing_time "
              f"{st_status['avg_processing_time'] * 1e3:.3f} ms/frame")

        # -- main -s and --diagnose -----------------------------------------
        status = {}
        rc = cli.main(["-s", "--duration", "3"], status)
        stations = status.get("stations", {})
        if rc != 0 or not all(s["frames_processed"] > 0
                              for s in stations.values()):
            fail(f"main -s returned {rc} with stations {stations}")
        for sid, s in stations.items():
            times["station_avg_processing_ms"][sid] = (
                s["avg_processing_time"] * 1e3)
        phase(f"system path: main -s --duration 3 returned 0; "
              + "; ".join(f"{sid} {s['frames_processed']} frames, "
                          f"avg_processing_time "
                          f"{s['avg_processing_time'] * 1e3:.3f} ms/frame"
                          for sid, s in stations.items()) + f" ({smi})")
        if cli.main(["--diagnose"]) != 0:
            fail("main --diagnose did not pass on the card")
    finally:
        guard_plains.restore()
        cd.download_table = download_table
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    idle = {n: w.launches for n, w in others.items()}
    phase(f"system path launched {launches}; the run-table route {idle}; "
          f"traced CUDA kernels of one 2 MP inspect_batch and one "
          f"bottle_base call {traced_2mp}, of one 640x480 inspect_batch "
          f"{traced_640}")
    if plain_on_card:
        fail(f"plain versions ran on the card: {sorted(set(plain_on_card))}")
    if not all(launches.values()):
        fail("the system path did not go through every kernel of its path")
    want = set(BAND_CCL_KERNELS) | {"k_preprocess", "k_fill_tiles",
                                    "k_fill_merge", "k_fill_write",
                                    "k_banded_stats", "k_bbox_sums"}
    if not want <= set(traced_2mp) or set(traced_640) != set(FUSED_KERNELS):
        fail(f"the system path's traces lack kernels of its path: 2 MP "
             f"{sorted(want - set(traced_2mp))}, 640x480 "
             f"{sorted(set(FUSED_KERNELS) ^ set(traced_640))}")
    return launches, traced_2mp, traced_640, times


def plain_verdict(det, x, channel_major=False):
    """verdict_device's flags and confidences on a 640x480-class batch x by
    the fused kernel's plain version (contamination_fused_reference, on x's
    device), then det's table, gates and reduction."""
    import torch
    from heimdall_tpu_torch.ops import blobs
    from heimdall_tpu_torch.ops import fused_kernels as fk
    out = fk.contamination_fused_reference(
        x, int(det.contrast_threshold), det.max_blobs, channel_major)
    mono = x.dim() == 3 or (channel_major and x.shape[1] == 1)
    table = blobs.table_from_sums(*out[:4],
                                  use_color=det.use_color and not mono)
    conf, accepted = fk.gate(table, float(det.min_contaminant_size),
                             float(det.max_contaminant_size),
                             float(det.min_confidence), det.formula)
    return (accepted.any(dim=1),
            torch.where(accepted, conf, 0.0).max(dim=1).values)


def line_phases(dev, smi):
    """Phase 4e, the production line on the card: the native ring and
    producer; the JAX bench's config #4 stream (50 SimulationImageSource
    frames, 640x480, seed 1, defect probability 1.0, at 25 fps) through
    DeviceFeeder in push mode, then pull mode; examples/line_simulation's
    main at 640x480 and 1920x1080 Mono8 (8 sets a batch) and latency_main
    (one set a batch).  Every wrapper's launch count is set to 0 just
    before and read just after, and no plain version may run on a CUDA
    tensor in between.  Then the checks: each stream frame's verdict, and
    the first 4 batches' of each line run, equal to the plain versions'
    (contamination_fused_reference at 640x480, the band route's plain
    versions on the CPU at 1920x1080); the CUDA kernels of one line
    verdict_device call, traced; UniformityCalibrator.apply_on_device on
    the card against the CPU; one line batch's upload, pageable against
    the pinned slots.  Returns ({wrapper: launches}, the phase's
    figures)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import native_bridge
    from heimdall_tpu_torch.core.acquisition import SimulationImageSource
    from heimdall_tpu_torch.detectors.contamination_detector import (
        ContaminationDetector)
    from heimdall_tpu_torch.examples import line_simulation as ls
    from heimdall_tpu_torch.lighting.calibration import UniformityCalibrator
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import stats_tiled as st
    from heimdall_tpu_torch.runtime.feeder import (DeviceFeeder, FrameRing,
                                                   NativeCameraFeeder,
                                                   PinnedUploader)

    # -- the native runtime ------------------------------------------------
    if native_bridge._load() is None:
        fail("native/libheimdall_native.so did not load")
    ring = FrameRing(4, (480, 640))
    native_ring = ring._ring is not None
    ring.close()
    with NativeCameraFeeder(width=640, height=480, fps=200, capacity=16,
                            seed=1) as cam:
        got = cam.ring.pop_batch(4, timeout_s=2.0)
        cam_stats = cam.stats()
    if not native_ring or got.shape != (4, 480, 640) or \
            "frames_produced" not in cam_stats:
        fail(f"the native ring or producer is not in use (ring "
             f"{native_ring}, batch {got.shape}, stats {sorted(cam_stats)})")
    phase(f"line path: native library loaded; FrameRing on the native "
          f"ring; the native producer gave a batch {got.shape}")

    wrappers = {"preprocess": fk.preprocess, "flood_fill": ct.flood_fill,
                "band_ccl": ct.band_ccl, "merge_bands": ct.merge_bands,
                "banded_stats": st.banded_stats, "bbox_sums": st.bbox_sums,
                "fused_detect": fk.contamination_fused}
    det = ContaminationDetector(config={"include_contours": False})
    det_line = ContaminationDetector(config={"include_contours": False,
                                             "use_color": False})

    def stream(push):
        """Config #4: the 25 fps stream through DeviceFeeder; returns
        (frames, {frame: (flags, confs)}, read->verdict ms per frame)."""
        src = SimulationImageSource("bench", {"width": 640, "height": 480,
                                              "seed": 1,
                                              "defect_probability": 1.0})
        src.open()
        uploader = PinnedUploader(STREAM_IN_FLIGHT + 1, dev)
        frames, results, lat = [], {}, []

        def step(frame):
            x = uploader.upload(frame.transpose(2, 0, 1)[None])
            return det.verdict_device(x, channel_major=True)

        def on_done(out, meta):
            i, t_read = meta
            lat.append((time.perf_counter() - t_read) * 1e3)
            results[i] = out

        feeder = DeviceFeeder(step, STREAM_IN_FLIGHT,
                              on_done=on_done if push else None)
        t_next = time.perf_counter()
        for i in range(STREAM_FRAMES):
            now = time.perf_counter()
            if now < t_next:
                time.sleep(t_next - now)
            t_next = max(t_next + 1 / STREAM_FPS, time.perf_counter())
            t1 = time.perf_counter()
            _, frame = src.read()
            frames.append(frame)
            out = feeder.submit(frame, meta=(i, t1))
            if out is not None:
                on_done(*out)
        if push:
            feeder.close()
        else:
            for out, meta in feeder.drain():
                on_done(out, meta)
        return frames, results, np.asarray(lat)

    warm = np.zeros((1, 3, 480, 640), np.uint8)
    det.verdict_device(torch.from_numpy(warm).to(dev), channel_major=True)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    plain_on_card = guard_plains()
    try:
        frames, push_out, push_ms = stream(True)
        _, pull_out, pull_ms = stream(False)
        bph, p99, d640 = ls.main(LINE_SECONDS, LINE_SETS, return_detail=True,
                                 device=dev, keep_batches=CHECK_BATCHES)
        bph2, p99_2, d2mp = ls.main(LINE_SECONDS, LINE_SETS, width=W2,
                                    height=H2, return_detail=True,
                                    device=dev, keep_batches=CHECK_BATCHES)
        lat = ls.latency_main(LINE_SECONDS, return_detail=True, device=dev,
                              keep_batches=CHECK_BATCHES)
    finally:
        guard_plains.restore()
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    phase(f"line path launched {launches}")
    if plain_on_card:
        fail(f"plain versions ran on the card: {sorted(set(plain_on_card))}")
    if not all(launches.values()):
        fail("the line path did not go through every kernel of its path")

    # -- verdicts against the plain versions -------------------------------
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack(frames).transpose(0, 3, 1, 2))).to(dev)
    want = [t.cpu().numpy() for t in plain_verdict(det, x, True)]
    for name, out in (("push", push_out), ("pull", pull_out)):
        got = [np.concatenate([out[i][j] for i in range(STREAM_FRAMES)])
               for j in range(2)]
        if len(out) != STREAM_FRAMES or not all(
                np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"the stream's {name} verdicts differ from the plain "
                 f"version's")
    rejected = int(want[0].sum())

    def held(batches, name, on_cpu=False):
        cpu = ContaminationDetector(config={"include_contours": False,
                                            "use_color": False},
                                    device="cpu")
        memo = {}
        for frames_b, flags, confs in batches:
            if on_cpu:    # the band route's plain versions, each frame once
                for f in frames_b:
                    if f.tobytes() not in memo:
                        memo[f.tobytes()] = [t.numpy() for t in
                                             cpu.verdict_device(f[None])]
                want_b = [np.concatenate([memo[f.tobytes()][j]
                                          for f in frames_b])
                          for j in range(2)]
            else:
                want_b = [t.cpu().numpy() for t in plain_verdict(
                    det_line, torch.from_numpy(frames_b).to(dev))]
            if not (np.array_equal(flags, want_b[0])
                    and np.array_equal(confs, want_b[1])):
                fail(f"{name}: verdicts differ from the plain versions'")
        return sum(len(b[0]) for b in batches)

    n640 = held(d640["batches"], "line 640x480")
    n2mp = held(d2mp["batches"], "line 1920x1080", on_cpu=True)
    nlat = held(lat["batches"], "latency mode")
    phase(f"line path: verdicts equal to the plain versions' on the "
          f"stream's {STREAM_FRAMES} frames (push and pull, {rejected} "
          f"rejected) and on the first {CHECK_BATCHES} batches of each "
          f"line run ({n640}, {n2mp} and {nlat} frames)")

    figures = {"card": smi, "native_ring": native_ring}
    figures["stream_640x480"] = {
        "frames": STREAM_FRAMES, "fps": STREAM_FPS,
        "max_in_flight": STREAM_IN_FLIGHT,
        "push_read_to_verdict_ms": {"p50": float(np.percentile(push_ms, 50)),
                                    "p99": float(np.percentile(push_ms, 99)),
                                    "max": float(push_ms.max())},
        "pull_read_to_verdict_ms": {"p50": float(np.percentile(pull_ms, 50)),
                                    "p99": float(np.percentile(pull_ms, 99))},
        "rejected": rejected}
    s = figures["stream_640x480"]
    phase(f"{smi}: config #4 stream, {STREAM_FRAMES} frames 640x480 at "
          f"{STREAM_FPS} fps: read -> verdict push p50 "
          f"{s['push_read_to_verdict_ms']['p50']:.3f} ms, p99 "
          f"{s['push_read_to_verdict_ms']['p99']:.3f} ms; pull (a verdict "
          f"{STREAM_IN_FLIGHT} frames later) p50 "
          f"{s['pull_read_to_verdict_ms']['p50']:.3f} ms")
    for key, (b, p, d) in (("line_640x480", (bph, p99, d640)),
                           ("line_1920x1080", (bph2, p99_2, d2mp))):
        figures[key] = {
            "bph": b, "p50_ms": d["p50_ms"], "p95_ms": d["p95_ms"],
            "p99_ms": p, "floor_ms": d["floor_ms"], "net_bph": d["net_bph"],
            "bottles": d["bottles"], "rejects": d["rejects"],
            "n_batches": d["n_batches"], "acquire_s": d["acquire_s"],
            "elapsed_s": d["elapsed_s"], "sets_per_batch": LINE_SETS,
            "bph_pass": b >= ls.TARGET_BPH,
            "deadline_pass": p < ls.DEADLINE_MS}
        phase(f"{smi}: {key} ({LINE_SETS} sets a batch, {LINE_SECONDS} s): "
              f"{b:,.0f} BPH ({'PASS' if b >= ls.TARGET_BPH else 'below'} "
              f"90,000); per-bottle p50 {d['p50_ms']:.3f} / p95 "
              f"{d['p95_ms']:.3f} / p99 {p:.3f} ms "
              f"({'PASS' if p < ls.DEADLINE_MS else 'above'} 10 ms); floor "
              f"{d['floor_ms']:.3f} ms a batch; rejects {d['rejects']} of "
              f"{d['bottles']}; acquisition+assembly {d['acquire_s']:.2f} s "
              f"of {d['elapsed_s']:.2f} s")
    figures["latency_640x480"] = {k: v for k, v in lat.items()
                                  if k != "batches"}
    figures["latency_640x480"]["deadline_pass"] = lat["p99_ms"] < \
        ls.DEADLINE_MS
    phase(f"{smi}: latency mode 640x480 (one set a batch): {lat['bottles']} "
          f"bottles, per-bottle p50 {lat['p50_ms']:.3f} / p95 "
          f"{lat['p95_ms']:.3f} / p99 {lat['p99_ms']:.3f} ms "
          f"({'PASS' if lat['p99_ms'] < ls.DEADLINE_MS else 'above'} 10 "
          f"ms); floor p50 {lat['floor_ms']:.3f} ms; rejects "
          f"{lat['rejects']}")

    # -- the CUDA kernels of one line verdict_device call --------------------
    xb = torch.from_numpy(d640["batches"][0][0]).to(dev)
    traced = cuda_kernels(lambda: det_line.verdict_device(xb), runs=2)
    if traced != dict.fromkeys(FUSED_KERNELS, 1):
        fail(f"one line verdict_device call launched {traced}, not one "
             f"each of {FUSED_KERNELS}")
    figures["cuda_kernels_verdict_640x480"] = traced

    # -- the uniformity correction on the card -------------------------------
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:480, :640]
    vignette = 1.0 - 0.4 * (((yy - 240) / 240) ** 2 + ((xx - 320) / 320) ** 2)
    flat = np.clip(200 * vignette + rng.randn(8, 480, 640) * 2, 0,
                   255).astype(np.uint8)
    cal = UniformityCalibrator(smoothing_kernel=31)
    cal.build_map(flat)
    bgr = rng.randint(0, 256, (4, 480, 640, 3), np.uint8)
    for name, batch in (("mono8", flat), ("bgr", bgr)):
        on_card = cal.apply_on_device(torch.from_numpy(batch).to(dev))
        on_cpu = cal.apply_on_device(torch.from_numpy(batch))
        if not (on_card.is_cuda and torch.equal(on_card.cpu(), on_cpu)):
            fail(f"apply_on_device ({name}) on the card differs from the CPU")
    if not np.array_equal(cal.apply_on_device(torch.from_numpy(flat).to(
            dev)).cpu().numpy(), cal.apply(flat)):
        fail("apply_on_device differs from apply")
    phase("line path: UniformityCalibrator.apply_on_device on the card "
          "equal to the CPU (Mono8 and BGR) and to apply")

    # -- one line batch's upload: pageable against the pinned slots ---------
    def rate(fn, nbytes, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
        return nbytes / ((time.perf_counter() - t0) / iters) / 1e6

    figures["upload_mb_s"] = {}
    for h, w in ((480, 640), (H2, W2)):
        batch = np.random.RandomState(1).randint(
            0, 256, (4 * LINE_SETS, h, w), np.uint8)
        up = PinnedUploader(2, dev)
        shape = batch.shape
        r = {"bytes": batch.nbytes,
             "pageable": rate(lambda: torch.from_numpy(batch).to(dev),
                              batch.nbytes),
             "pinned_with_host_copy": rate(lambda: up.upload(batch),
                                           batch.nbytes),
             "pinned_slot": rate(lambda: up.upload(up.host_slot(shape)),
                                 batch.nbytes)}
        figures["upload_mb_s"][f"{w}x{h}"] = r
        phase(f"{smi}: upload of one line batch {shape} ({batch.nbytes / 1e6:.1f}"
              f" MB): pageable {r['pageable']:.0f} MB/s, pinned slot "
              f"{r['pinned_slot']:.0f} MB/s, pinned with the host copy "
              f"into the slot {r['pinned_with_host_copy']:.0f} MB/s")
    return launches, figures


def _http(port, path, data=None):
    """(status, body) of one request to a server of this process."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _sse_events(port, n, start):
    """The first n server-sent events of the dashboard's /api/stream, the
    stream opened before start() is called."""
    import socket
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        sock.sendall(b"GET /api/stream HTTP/1.1\r\nHost: localhost\r\n"
                     b"Accept: text/event-stream\r\n\r\n")
        sock.settimeout(120)
        start()
        buf, events = b"", []
        while len(events) < n:
            chunk = sock.recv(65536)
            if not chunk:
                fail("the dashboard's event stream closed early")
            buf += chunk
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                events += [json.loads(line[6:]) for line in
                           block.splitlines() if line.startswith(b"data: ")]
    finally:
        sock.close()
    return events[:n]


def serving_phases(dev, smi):
    """Phase 4f, the serving path on the card: the dashboard (every
    endpoint, two server-sent events, the CLI against it, stop with no loop
    thread left), main -s --dashboard, the results viewer, the multi-class
    detector at 640x480 and 1920x1080 Mono8, the models at full width
    (DefectSegmenter, SegmentationDetector on the card's mask,
    QuantizedSegmenter, DefectClassifier on the detector's blob patches,
    AnomalyDetector) and demosaic/YUV at 1920x1080.  Every wrapper's launch
    count is set to 0 just before and read just after, and no plain version
    may run on a CUDA tensor in between.  Returns ({wrapper: launches}, the
    phase's figures)."""
    import contextlib
    import io
    import tempfile
    import threading
    import numpy as np
    import torch
    from heimdall_tpu_torch import cli, scene
    from heimdall_tpu_torch import main as tmain
    from heimdall_tpu_torch.detectors.contamination_detector import (
        download_table)
    from heimdall_tpu_torch.detectors.multi_defect import (
        MultiClassDefectDetector)
    from heimdall_tpu_torch.models import (AnomalyDetector, DefectClassifier,
                                           DefectSegmenter,
                                           QuantizedSegmenter,
                                           SegmentationDetector,
                                           extract_blob_patches)
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import demosaic
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import preprocess_tiled as pt
    from heimdall_tpu_torch.ops import runtable_tiled as rt
    from heimdall_tpu_torch.ops import stats_tiled as st
    from heimdall_tpu_torch.serving import DashboardServer, ResultsViewer
    from heimdall_tpu_torch.serving import dashboard

    wrappers = {"preprocess": fk.preprocess, "flood_fill": ct.flood_fill,
                "band_ccl": ct.band_ccl, "merge_bands": ct.merge_bands,
                "banded_stats": st.banded_stats, "bbox_sums": st.bbox_sums,
                "fused_detect": fk.contamination_fused,
                "preprocess_tiled": pt.contamination_preprocess_tiled,
                "run_extract": rt.run_extract, "flood_fix": rt.flood_fix,
                "fill_extract": rt.fill_extract, "label_fix": rt.label_fix,
                "writeback": rt.writeback}
    must = ("fused_detect", "preprocess", "flood_fill", "band_ccl",
            "merge_bands", "banded_stats", "bbox_sums")
    figures = {"card": smi, "ms": {}}
    ms = figures["ms"]

    def timed(name, fn, iters=3):
        fn()
        ms[name] = cuda_ms_only(lambda: None, fn, iters)
        return ms[name]

    def loop_threads():
        return [t for t in threading.enumerate()
                if t.name == "dashboard-loop"]

    def quiet(fn):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fn()
        return rc, out.getvalue()

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    plain_on_card = guard_plains()
    try:
        # -- the dashboard at its defaults (640x480, batch 4) ---------------
        srv = DashboardServer(port=0, device=dev)
        srv.start_background()
        try:
            port = srv.port
            code, page = _http(port, "/")
            stats0 = json.loads(_http(port, "/api/stats")[1])
            events = _sse_events(
                port, 2, lambda: _http(port, "/api/start", b""))
            if not (code == 200 and b"Heimdall" in page
                    and stats0["running"] is False
                    and events[0]["seq"] < events[1]["seq"]
                    and events[1]["stats"]["frames_processed"] > 0):
                fail(f"dashboard: page {code}, first stats {stats0}, "
                     f"events {[e['seq'] for e in events]}")
            latest = json.loads(_http(port, "/api/latest")[1])
            code_m, metrics = _http(port, "/metrics")
            code_s, settings = _http(port, "/api/settings",
                                     json.dumps({"min_confidence": 0.3})
                                     .encode())
            code_404, _ = _http(port, "/no/such/path")
            rc_status, out_status = quiet(lambda: cli.main(
                ["--port", str(port), "status"]))
            rc_set, _ = quiet(lambda: cli.main(
                ["--port", str(port), "set", "batch_size", "4"]))
            rc_latest, out_latest = quiet(lambda: cli.main(
                ["--port", str(port), "latest"]))
            rc_metrics, out_metrics = quiet(lambda: cli.main(
                ["--port", str(port), "metrics"]))
            if not ("defect_count" in latest and code_m == 200
                    and b"heimdall_frames_total" in metrics
                    and code_s == 200
                    and json.loads(settings)["settings"]["batch_size"] == 4
                    and code_404 == 404
                    and rc_status == rc_set == rc_latest == rc_metrics == 0
                    and json.loads(out_status)["running"] is True
                    and "defect_count" in json.loads(out_latest)
                    and "heimdall_frames_total" in out_metrics):
                fail(f"dashboard endpoints or CLI: latest {sorted(latest)}, "
                     f"metrics {code_m}, settings {code_s}, 404 "
                     f"{code_404}, CLI {rc_status, rc_set, rc_latest}")
            time.sleep(2)
            stats = json.loads(_http(port, "/api/stats")[1])
            stopped = json.loads(_http(port, "/api/stop", b"")[1])
        finally:
            srv.shutdown()
        if stopped != {"stopped": True, "running": False} or loop_threads():
            fail(f"dashboard stop: {stopped}, loop threads {loop_threads()}")
        figures["dashboard"] = {k: stats[k] for k in (
            "frames_processed", "defects_detected", "fps",
            "avg_processing_time")}
        figures["dashboard"]["has_image"] = "image" in latest
        phase(f"serving path: dashboard (640x480, batch 4) served /, "
              f"/api/stats, /api/latest, /metrics, two events (seq "
              f"{events[0]['seq']}, {events[1]['seq']}), settings and a "
              f"404; the CLI's status, set, latest and metrics; stopped "
              f"with no loop thread left; {stats['frames_processed']} "
              f"frames; {smi}: fps {stats['fps']:.1f}, per-frame EMA "
              f"{stats['avg_processing_time'] * 1e3:.3f} ms; preview image "
              f"{'yes' if 'image' in latest else 'no (no cv2)'}")

        # -- main -s --dashboard, its server on a free port (main imports
        # DashboardServer when it starts one; a fixed port would meet
        # another run's dashboard) ------------------------------------------
        servers, real_server = [], dashboard.DashboardServer

        class FreePort(real_server):
            def __init__(self, port=0, **kwargs):
                super().__init__(port=0, **kwargs)
                servers.append(self)

        status = {}
        dashboard.DashboardServer = FreePort
        try:
            rc = tmain.main(["-s", "--dashboard", "--duration", "3"], status)
        finally:
            dashboard.DashboardServer = real_server
        served = status.get("dashboard", {}).get("frames_processed", 0)
        if rc != 0 or served == 0 or loop_threads() or len(servers) != 1:
            fail(f"main -s --dashboard returned {rc}, its dashboard "
                 f"served {served} frames")
        figures["main_dashboard_frames"] = served
        phase(f"serving path: main -s --dashboard --duration 3 returned 0;"
              f" its dashboard processed {served} frames")

        # -- the results viewer ---------------------------------------------
        with tempfile.TemporaryDirectory() as results:
            for i in (1, 2):
                for kind in ("original", "processed", "visualization"):
                    with open(os.path.join(results, f"{kind}_{i}.jpg"),
                              "wb") as fh:
                        fh.write(bytes([i]) * 64)
            viewer = ResultsViewer(results, port=0)
            viewer.start_background()
            try:
                images = json.loads(_http(viewer.port, "/api/images")[1])
                code, body = _http(viewer.port, "/images/original_2.jpg")
            finally:
                viewer.shutdown()
        if images["count"] != 6 or code != 200 or body != bytes([2]) * 64:
            fail(f"results viewer: {images}, image {code}")
        phase("serving path: ResultsViewer served 2 inspection sets of 3")

        # -- the multi-class detector ----------------------------------------
        multi = MultiClassDefectDetector(device=dev)
        multi_cpu = MultiClassDefectDetector(device="cpu")
        f640 = scene.make_frames(SERVE_BATCH, seed=0)
        f2mp = np.ascontiguousarray(scene.make_frames(
            SERVE_BATCH_2MP, H2, W2, seed=2)[..., 1])
        figures["multi_class_defects_first_2"] = {}
        for size, frames in (("640x480x3", f640), ("1920x1080_mono8", f2mp)):
            got = multi.detect_batch(frames)
            want = multi_cpu.detect_batch(frames[:2])
            if _defect_lists(got[:2]) != _defect_lists(want):
                fail(f"multi-class {size}: the first 2 frames' defects "
                     f"differ from the CPU path")
            t = timed(f"multi_class_{size}",
                      lambda: multi.detect_batch(frames))
            kinds = {}
            for d in sum(got, []):
                kinds[d.defect_type] = kinds.get(d.defect_type, 0) + 1
            figures["multi_class_defects_first_2"][size] = sum(map(len,
                                                                   want))
            phase(f"serving path: MultiClassDefectDetector {size}: first 2 "
                  f"frames equal to the CPU path; kinds {kinds}; {smi}: "
                  f"{t:.3f} ms per batch of {len(frames)}")

        # -- the models at full width ------------------------------------------
        frames = scene.ring_frames(MODEL_BATCH, 480, 640, seed=3)
        seg = DefectSegmenter(base=16, seed=0, device=dev)
        prob = seg.predict(frames)
        seg_cpu = DefectSegmenter(base=16, seed=0, device="cpu")
        err = float(np.abs(prob - seg_cpu.predict(frames)).max())
        if not (prob.shape == frames.shape[:3] and np.isfinite(prob).all()
                and err <= UNET_TOL):
            fail(f"DefectSegmenter on the card: shape {prob.shape}, "
                 f"max |card - cpu| {err}")
        figures["unet_max_abs_err"] = err
        timed("segmenter_predict", lambda: seg.predict(frames))

        class _Map:
            def predict(self, images):
                return prob

        # the seeded UNet's map is speckle with a few blobs: its top 0.5%,
        # every blob kept (a lone pixel's area by Pick's rule is -0.5)
        cfg = {"threshold": float(np.percentile(prob, 99.5)),
               "min_contaminant_size": -1}
        det = SegmentationDetector(_Map(), config=cfg, device=dev)
        got = det.detect_batch(frames)
        want = SegmentationDetector(_Map(), config=cfg,
                                    device="cpu").detect_batch(frames)
        if _defect_lists(got) != _defect_lists(want) or not sum(map(len,
                                                                    got)):
            fail("SegmentationDetector on the card's mask differs from the "
                 "CPU path or found nothing")
        figures["segmentation_defects"] = sum(map(len, got))
        timed("segmentation_detector", lambda: det.detect_batch(frames))

        q = QuantizedSegmenter.from_segmenter(seg, frames[:2])
        q_prob = q.predict(frames)
        q_cpu = QuantizedSegmenter(q.qparams, device="cpu")
        q_err = float(np.abs(q_prob - q_cpu.predict(frames)).max())
        if not (np.isfinite(q_prob).all() and q_err <= 1e-6):
            fail(f"QuantizedSegmenter on the card: max |card - cpu| "
                 f"{q_err}")
        figures["int8_max_abs_err"] = q_err
        figures["int8_vs_float_max_abs"] = float(np.abs(q_prob - prob).max())
        timed("quantized_predict", lambda: q.predict(frames))

        table = download_table(*multi._front.run_device(f640))[0]
        patches = extract_blob_patches(f640, table)
        clf = DefectClassifier(seed=0, device=dev)
        p = clf.predict(patches)
        c_err = float(np.abs(p - DefectClassifier(
            seed=0, device="cpu").predict(patches)).max())
        if not (len(patches) and p.shape == (len(patches), 2)
                and c_err <= BF16_TOL):
            fail(f"DefectClassifier on {len(patches)} patches: max |card - "
                 f"cpu| {c_err}")
        figures["classifier_patches"] = len(patches)
        figures["classifier_max_abs_err"] = c_err
        timed("classifier_predict", lambda: clf.predict(patches))

        ae = AnomalyDetector(seed=0, device=dev)
        gray = frames[..., 1]
        score = ae.score(gray)
        a_cpu = AnomalyDetector(seed=0, device="cpu").score(gray)
        a_err = float((np.abs(score - a_cpu) / a_cpu).max())
        if not (score.shape == (len(gray),) and a_err <= BF16_TOL):
            fail(f"AnomalyDetector.score: relative |card - cpu| {a_err}")
        figures["anomaly_rel_err"] = a_err
        timed("anomaly_score", lambda: ae.score(gray))
        phase(f"serving path: models at full width (UNet base 16, "
              f"classifier width 32, AE width 16), {MODEL_BATCH} ring "
              f"frames 640x480: UNet max |card - cpu| {err:.3g} (tolerance "
              f"{UNET_TOL}); SegmentationDetector {figures['segmentation_defects']}"
              f" defects equal to the CPU path on the card's map; int8 "
              f"{q_err:.3g} (1e-6); classifier on {len(patches)} blob "
              f"patches {c_err:.3g} and AE score {a_err:.3g} relative (bf16,"
              f" {BF16_TOL}); {smi}: " + ", ".join(
                  f"{k} {ms[k]:.3f} ms" for k in (
                      "segmenter_predict", "segmentation_detector",
                      "quantized_predict", "classifier_predict",
                      "anomaly_score")) + " per batch")

        # -- demosaic and YUV at 1920x1080 ---------------------------------------
        rng = np.random.RandomState(7)
        raw = rng.randint(0, 256, (H2, W2)).astype(np.uint8)
        raw_card = torch.from_numpy(raw).to(dev)
        for pattern in ("rg", "gr", "gb", "bg"):
            out = demosaic.demosaic_bilinear(raw_card, pattern)
            if not torch.equal(out.cpu(), demosaic.demosaic_bilinear(
                    raw, pattern, device="cpu")):
                fail(f"demosaic {pattern} on the card differs from the CPU")
            timed(f"demosaic_{pattern}",
                  lambda: demosaic.demosaic_bilinear(raw_card, pattern))
        yuv = rng.randint(0, 256, (H2, 2 * W2)).astype(np.uint8)
        yuv_card = torch.from_numpy(yuv).to(dev)
        if not torch.equal(demosaic.yuv422_to_bgr(yuv_card).cpu(),
                           demosaic.yuv422_to_bgr(yuv, device="cpu")):
            fail("yuv422_to_bgr on the card differs from the CPU")
        timed("yuv422_to_bgr", lambda: demosaic.yuv422_to_bgr(yuv_card))
        phase(f"serving path: demosaic (4 patterns) and yuv422_to_bgr at "
              f"1920x1080 equal to the CPU path; {smi}: " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in ms.items()
                  if k.startswith(("demosaic", "yuv"))))
    finally:
        guard_plains.restore()
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    phase(f"serving path launched {launches}")
    if plain_on_card:
        fail(f"plain versions ran on the card: {sorted(set(plain_on_card))}")
    if not all(launches[n] for n in must):
        fail(f"the serving path did not go through every kernel of its "
             f"path: {launches}")
    return launches, figures


def check_split(name, x, k, ct=CONTRAST):
    """Phase 3d on one case: the label kernel at every stage and the stats
    kernel on its labels against their plain versions, and B6a(B6b(x))
    against the fused kernel; the largest error (0 or the run fails)."""
    import torch
    from heimdall_tpu_torch.ops import split_kernels as sk
    from heimdall_tpu_torch.ops.fused_kernels import contamination_fused
    errs = {}
    for stage in sk.STAGES:
        got = sk.label_kernel(x, ct, stage)
        torch.cuda.synchronize()
        want = sk.label_kernel_reference(x, ct, stage)
        if got.dtype != want.dtype:
            fail(f"label_kernel stage {stage} gives {got.dtype}, its plain "
                 f"version {want.dtype}")
        errs[stage] = max_abs_err((got,), (want,))
    labels = sk.label_kernel(x, ct)
    got = sk.stats_kernel(x, labels, k)
    torch.cuda.synchronize()
    errs["stats"] = max_abs_err(got, sk.stats_kernel_reference(x, labels, k))
    fused = contamination_fused(x, ct, k, True, return_labels=True)
    errs["split_vs_fused"] = max_abs_err(got + (labels,), fused)
    phase(f"check split {name} (contrast {ct}, K {k}): n_blobs "
          f"{got[3].tolist()[:8]} max_abs_err {errs}")
    if any(errs.values()):
        fail(f"a split kernel differs from its plain version or B6a(B6b) "
             f"from the fused kernel on {name}")
    return max(errs.values())


def split_trace(dev, x, out_dir, when):
    """ProfilingSession.trace of the split kernels (label_kernel, then
    stats_kernel) on frames x, taken once.  Returns {"kernels": the card's
    kernels it lists} when it lists them, k_label_tiles among them (it
    fails if it lists the spins but no k_label_tiles, a kernel of the label
    kernel's design), or {"raised": its error} when it
    raised, as it must where the profiler lost the block's kernels (past
    the trace's lead, which it may drop; ROADMAP.md, section C)."""
    from heimdall_tpu_torch.ops import split_kernels as sk
    from heimdall_tpu_torch.perf.profiling import ProfilingSession
    session = ProfilingSession("split_trace", device=dev)
    try:
        with session.trace(os.path.join(out_dir, "trace")):
            sk.stats_kernel(x, sk.label_kernel(x, CONTRAST), K)
    except RuntimeError as e:
        phase(f"profiling path: ProfilingSession.trace {when} raised at its "
              f"first and only try: {e}")
        return {"raised": str(e)}
    if "k_label_tiles" not in session.trace_table:
        fail(f"ProfilingSession.trace {when} lists no k_label_tiles kernel")
    phase(f"profiling path: ProfilingSession.trace {when} listed "
          f"{session.trace_kernels} CUDA kernels at its first try "
          f"({os.path.getsize(session.trace_path)} bytes of Chrome trace)")
    return {"kernels": session.trace_kernels}


def check_split_cases(dev):
    """Phase 3d's cases that attack the label kernel's parts: the tile and
    label cases that 3a runs through B1 (scene.tile_case_frames and
    scene.label_case_masks drawn as frames at 640x480, 477x631, 13x17 and
    3x3) and the bit cases (scene.bit_case_frames at BIT_CASE_SIZES), at
    contrast 15 and -15, each through check_split; then each stage's CUDA
    kernels, traced at 640x480 and at 13x17 (one tile), against
    hd_label_launches(stage, H, W) and LABEL_STAGE_KERNELS.  Returns the
    largest error (0 or the run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import _cuda
    from heimdall_tpu_torch.ops import split_kernels as sk

    def planes(frames):
        return torch.from_numpy(np.ascontiguousarray(
            frames.transpose(0, 3, 1, 2))).to(dev)

    sets = [(f"tile and label cases {h}x{w}", planes(np.concatenate([
        np.stack(list(scene.tile_case_frames(h, w).values())),
        scene.mask_frames(list(scene.label_case_masks(h, w).values()))])))
        for h, w in ((480, 640), (477, 631), (13, 17), (3, 3))]
    sets += [(f"bit cases {h}x{w}", planes(scene.bit_case_frames(h, w)))
             for h, w in scene.BIT_CASE_SIZES]
    err = 0
    for name, x in sets:
        for c in (CONTRAST, -CONTRAST):
            err = max(err, check_split(name, x, K, c))
    lib = _cuda.library("fused_detect")
    for h, w in ((480, 640), (13, 17)):
        x = planes(scene.make_frames(2, h, w, seed=3))
        traced = {}
        for i, stage in enumerate(sk.STAGES):
            got = cuda_kernels(lambda: sk.label_kernel(x, CONTRAST, stage))
            traced[stage] = got
            told = lib.hd_label_launches(i, h, w)
            if (sum(got.values()) != told or max(got.values()) != 1
                    or set(got) - set(LABEL_STAGE_KERNELS[stage])):
                fail(f"label_kernel at {stage} on {h}x{w} launched {got}: "
                     f"not {told} of {LABEL_STAGE_KERNELS[stage]}")
        phase(f"label_kernel {h}x{w}: CUDA kernels per call (traced) "
              f"{traced}, as hd_label_launches reports")
    return err


STATS_KERNELS = {"k_chunk_roots": 1, "k_slot_sums": 1, "k_window_sums": 1}


def check_stats_cases(dev):
    """Phase 3d's cases that attack the stats kernel's passes (B6a):
    scene.stats_case_labels (the K-th root mid-row, roots past K, a root
    in the last row, every pixel a root, labels naming non-roots and roots
    ranked K or later, empty and full planes) at scene.STATS_CASE_SIZES
    with K 1, 64 and 1024, against the plain version; then one call's CUDA
    kernels at 640x480, traced, against hd_stats_from_labels_launches and
    STATS_KERNELS.  Returns the largest error (0 or the run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import _cuda
    from heimdall_tpu_torch.ops import split_kernels as sk

    err, first = 0, None
    for h, w in scene.STATS_CASE_SIZES:
        for k in (1, K, 1024):
            labels = torch.from_numpy(np.stack(list(
                scene.stats_case_labels(h, w, k, seed=1).values()))).to(dev)
            x = torch.from_numpy(scene.stats_case_frames(
                len(labels), h, w, seed=2)).to(dev)
            got = sk.stats_kernel(x, labels, k)
            torch.cuda.synchronize()
            e = max_abs_err(got, sk.stats_kernel_reference(x, labels, k))
            phase(f"check stats cases {h}x{w} K {k}: n_blobs "
                  f"{got[3].tolist()} max_abs_err {e}")
            if e:
                fail(f"the stats kernel differs from its plain version on "
                     f"the stats cases at {h}x{w}, K {k}")
            err = max(err, e)
            first = first or (x, labels)
    got = cuda_kernels(lambda: sk.stats_kernel(*first, K))
    told = _cuda.library("stats_labels").hd_stats_from_labels_launches()
    if got != STATS_KERNELS or sum(got.values()) != told:
        fail(f"stats_kernel launched {got}: not {told} of {STATS_KERNELS}")
    phase(f"stats_kernel {tuple(first[1].shape)}: CUDA kernels per call "
          f"(traced) {got}")
    return err


def split_phases(dev, smi, cases):
    """Phases 3d and 5d: the split kernels (B6b label_kernel at every stage,
    B6a stats_kernel) against their plain versions on phase 3's frames, then
    the profiling path (the port's profile_fused, profile_preprocess and
    performance_analysis) on the card with every count set to 0 just before
    and read just after; returns the split kernels' entries of the kernels
    line, and profile_preprocess's us/frame with the roll stages' launch
    counts from that run (the probes path reads them)."""
    import tempfile

    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.examples import performance_analysis
    from heimdall_tpu_torch.ops import _cuda
    from heimdall_tpu_torch.ops import pre_variants as pv
    from heimdall_tpu_torch.ops import split_kernels as sk
    from heimdall_tpu_torch.ops.fused_kernels import contamination_fused
    from heimdall_tpu_torch.scripts import (profile_fused, profile_preprocess,
                                            profile_stats_fill)

    # -- 3d. split kernels against their plain versions ---------------------
    uniform = torch.full((2, 3, 480, 640), 128, dtype=torch.uint8, device=dev)
    adv = [n for n in cases if n.startswith("adversarial_")]
    err = 0
    for name, x, k, ct in (
            ("bench8_channel_major", cases["bench8_channel_major"][0], K,
             CONTRAST),
            (adv[0], cases[adv[0]][0], K, CONTRAST),
            (adv[1], cases[adv[1]][0], 4, CONTRAST),
            ("bench2_477x631", cases["bench2_477x631"][0], K, CONTRAST),
            ("uniform_no_foreground", uniform, K, CONTRAST),
            ("uniform_full_foreground", uniform, K, -CONTRAST)):
        err = max(err, check_split(name, x, k, ct))
    err = max(err, check_split_cases(dev))
    err = max(err, check_stats_cases(dev))
    full = sk.label_kernel(uniform, -CONTRAST, "fill")
    if not bool(full.all()):
        fail("the full-foreground case is not all foreground")

    # -- 5d. the profiling path --------------------------------------------
    torch.cuda.synchronize()
    sk.label_kernel.launches = 0
    sk.label_kernel.stage_launches.clear()
    sk.stats_kernel.launches = 0
    contamination_fused.launches = 0
    pv.roll_stage.launches = 0
    pv.roll_stage.stage_launches.clear()
    t_fused = profile_fused.main([str(BATCH), "10"])
    t_pre = profile_preprocess.main([str(BATCH), "10"])
    roll_launches = (pv.roll_stage.launches,
                     dict(pv.roll_stage.stage_launches))
    with tempfile.TemporaryDirectory(dir=REPO) as out_dir:
        report, path = performance_analysis.main(
            ["--batches", "5", "--output-dir", out_dir])
        with open(path) as fh:
            saved = json.load(fh)
        traced = split_trace(dev, cases["bench8_channel_major"][0], out_dir,
                             "after the 1-rank NCCL world (4g)")
    torch.cuda.synchronize()
    launches = dict(sk.label_kernel.stage_launches,
                    stats=sk.stats_kernel.launches,
                    fused_detect=contamination_fused.launches)
    phase(f"profiling path: profile_fused + profile_preprocess + "
          f"performance_analysis launched {launches}")
    if not all(launches.get(s) for s in (*sk.STAGES, "stats",
                                         "fused_detect")):
        fail("the profiling path did not launch every split kernel stage")
    if (saved["counters"] != report.counters
            or report.counters.get("frames") != 40
            or not all(v > 0 for v in (*t_fused.values(), *t_pre.values()))):
        fail("the profiling path's report or timings are wrong")
    phase(f"profiling path: report saved with counters {report.counters}; "
          f"ProfilingSession.trace: {traced}")

    # -- 5. times of the plain versions, and bounds -------------------------
    x = torch.from_numpy(np.ascontiguousarray(
        scene.make_frames(BATCH, seed=0).transpose(0, 3, 1, 2))).to(dev)
    labels = sk.label_kernel(x, CONTRAST)
    px = BATCH * 480 * 640
    us = dict(t_pre, fill=t_fused["fill"], ccl=t_fused["ccl"],
              stats=t_fused["stats"])
    plain = {s: (lambda s=s: sk.label_kernel_reference(x, CONTRAST, s))
             for s in sk.STAGES}
    plain["stats"] = lambda: sk.stats_kernel_reference(x, labels, K)
    moved = {s: px * (3 + (4 if s == "ccl" else 1)) for s in sk.STAGES}
    moved["stats"] = profile_stats_fill.label_stats_bytes(
        labels, sk.stats_kernel_reference(x, labels, K))
    lib = _cuda.library("fused_detect")
    per_call = {s: lib.hd_label_launches(sk.STAGES.index(s), 480, 640)
                for s in sk.STAGES}
    per_call["stats"] = _cuda.library(
        "stats_labels").hd_stats_from_labels_launches()
    # B6a alone, queued behind a spin, and each of its launches (traced)
    stats_alone = profile_stats_fill.measure(
        "B6a stats_kernel 640x480", lambda: sk.stats_kernel(x, labels, K),
        10, moved["stats"], BATCH, "frame")
    every_byte = px * 7 + BATCH * (16 * K + 1) * 4
    per_launch = {n: round(t, 3) for n, t in stats_alone["kernels_us"].items()}
    phase(f"{smi}: split stats (B6a) alone {stats_alone['us_per_frame']:.3f} "
          f"us/frame against its bound "
          f"{moved['stats'] / HBM_BYTES_PER_S * 1e6 / BATCH:.3f} (this "
          f"run's bytes: labels, the windows' frame bytes, the tables) and "
          f"{every_byte / HBM_BYTES_PER_S * 1e6 / BATCH:.3f} (every frame "
          f"byte); each launch, us a call: {per_launch}")
    timings = {}
    for name, fn in plain.items():
        fn()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(fn, 1)
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = (mean_ops_ms(px)
                  if name in ("mean11", "pre", "fill", "ccl") else 0.0)
        timings[name] = dict(
            ms=us[name] * BATCH / 1e3, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        phase(f"{smi}: split {name} {us[name]:.3f} us/frame (profiling "
              f"path, batch {BATCH} of 640x480x3, {per_call[name]} CUDA "
              f"launches per call); plain version "
              f"{plain_ms / BATCH * 1e3:.1f} us/frame; bound "
              f"{timings[name]['bound_ms'] / BATCH * 1e3:.3f} us/frame "
              f"({moved[name] // BATCH} bytes/frame)")

    # name: (timing key, the TPU kernel it replaces)
    profiled = "scripts/profile_fused.py:102"
    staged = "scripts/profile_preprocess.py:100"
    names = {"label_kernel": ("ccl", "heimdall_tpu/ops/pallas_kernels.py:901"),
             "stats_kernel": ("stats",
                              "heimdall_tpu/ops/pallas_kernels.py:965"),
             "label_stage_gray": ("gray", staged),
             "label_stage_blur5": ("blur5", staged),
             "label_stage_mean11": ("mean11", staged),
             "label_stage_pre": ("pre", profiled),
             "label_stage_fill": ("fill", profiled),
             "label_stage_ccl": ("ccl", profiled)}
    design = {
        "gray": "k_gray, one launch",
        "blur5": "k_preprocess stopped at the blur, one launch",
        "mean11": "k_preprocess stopped at the threshold, one launch",
        "pre": "k_preprocess stopped at the closed mask, one launch",
        "fill": "k_preprocess, then the tile fill of tile_uf.cuh in place "
                "(4 launches)",
        "ccl": "k_preprocess, the tile fill, then the tile labels of "
               "tile_uf.cuh with one band of H rows (7 launches)",
        "stats": "two passes over the label plane, no scratch plane "
                 "(roots of 8192-pixel chunks; per-slot sums of 128x32 "
                 "strips), then the bbox windows (3 launches)"}
    entries = []
    for name, (key, replaces) in names.items():
        t = timings[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "heimdall_tpu_torch/csrc/" + (
                "stats_labels.cu" if key == "stats" else "fused_detect.cu"),
            "design": design[key],
            "replaces": replaces, "equal": err == 0,
            "launches": launches[key], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes it",
            "batch": BATCH, "frame": "640x480x3"})
        if name == "label_stage_pre":      # also the profiler's "full" stage
            entries[-1]["also_replaces"] = staged
        if key == "stats":      # also alone, queued behind a spin
            entries[-1].update(alone_ms=stats_alone["ms"],
                               kernels_us=stats_alone["kernels_us"])
    return entries, t_pre, roll_launches


def check_probes(name, x, ct):
    """Phase 3e on one case: the roll stages, the preprocess variants, the
    run-id product and the sweep fills against their plain versions (the
    exact variants also against the label kernel's "pre", the sweep fills
    against its union-find "fill"; mxu_conv's pre may differ only within
    flip_reach of its plain version's mean); returns (largest error,
    mxu_conv's largest mean error, mxu_conv's differing pre pixels)."""
    import torch
    from heimdall_tpu_torch.ops import fill_sweeps as fs
    from heimdall_tpu_torch.ops import pre_variants as pv
    from heimdall_tpu_torch.ops import split_kernels as sk
    errs = {}
    for stage in pv.ROLL_STAGES:
        errs[stage] = max_abs_err((pv.roll_stage(x, ct, stage),),
                                  (pv.roll_stage_reference(x, ct, stage),))
    pre = sk.label_kernel(x, ct, "pre")
    for v in pv.VARIANTS:
        if v != "mxu_conv":
            got = pv.pre_variant(x, ct, v)
            errs[v] = max(max_abs_err((got,), (pre,)), max_abs_err(
                (got,), (pv.pre_variant_reference(x, ct, v),)))
    blurred = sk.label_kernel(x, ct, "blur5")
    want = pv.mxu_mean_reference(blurred)
    mean_err = float((pv.mxu_mean(blurred) - want).abs().max())
    near_half = int(((want - want.floor() - 0.5).abs() <= MEAN_TOL).sum())
    differ = (pv.pre_variant(x, ct, "mxu_conv")
              != pv.pre_variant_reference(x, ct, "mxu_conv"))
    flips = int(differ.sum())
    # a pre pixel may differ only within the morphology's reach of a mean
    # that rint may round either way
    errs["mxu_conv_flips_out_of_reach"] = int(
        (differ & ~pv.flip_reach(want, MEAN_TOL)).sum())
    for guard in (False, True):
        for pack in ("mxu", "ladder"):
            errs[f"run_ids_{pack}_guard{int(guard)}"] = max_abs_err(
                fs.run_ids(pre, guard, pack), fs.run_ids_reference(pre, guard))
    uf = sk.label_kernel(x, ct, "fill")
    errs["sweep_plain_vs_union_find"] = max_abs_err(
        (fs.fill_sweeps_reference(x, ct),), (uf,))
    for v in fs.VARIANTS:
        errs[f"fill_{v}"] = max_abs_err((fs.fill_sweeps(x, ct, v),), (uf,))
        errs[f"fill_{v}_instance"] = int(
            fs.fill_mask.instance != fs.INSTANCES[v])
    torch.cuda.synchronize()
    phase(f"check probes {name} (contrast {ct}): max_abs_err {errs}; "
          f"mxu_conv mean max err {mean_err:.3e} (tolerance {MEAN_TOL}), "
          f"{flips} pre pixels differ from the float32 product "
          f"({near_half} means within {MEAN_TOL} of a half-integer)")
    if any(errs.values()) or mean_err > MEAN_TOL:
        fail(f"a probe kernel differs from its plain version, or a sweep "
             f"fill from the union-find fill, on {name}")
    return max(errs.values()), mean_err, flips


def check_probe_cases(dev):
    """Phase 3e's cases for the preprocess probes: every roll stage and
    variant against its plain version on scene.tile_case_frames at
    PROBE_CASE_SIZES, contrast +-15 (the exact variants also against the
    label kernel's "pre", mxu_conv's pre within flip_reach); then the CUDA
    kernels of one call of each on the bench frames, traced, against
    pre_variants.launches_per_call.  Returns (largest error, {name:
    traced kernels})."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import pre_variants as pv
    from heimdall_tpu_torch.ops import split_kernels as sk
    err = 0
    for h, w in PROBE_CASE_SIZES:
        frames = np.stack(list(scene.tile_case_frames(h, w, seed=2)
                               .values()))
        x = torch.from_numpy(np.ascontiguousarray(
            frames.transpose(0, 3, 1, 2))).to(dev)
        errs = {}
        for ct in (CONTRAST, -CONTRAST):
            for stage in pv.ROLL_STAGES:
                errs[f"{stage}_{ct}"] = max_abs_err(
                    (pv.roll_stage(x, ct, stage),),
                    (pv.roll_stage_reference(x, ct, stage),))
            pre = sk.label_kernel(x, ct, "pre")
            for v in pv.VARIANTS:
                got = pv.pre_variant(x, ct, v)
                if v == "mxu_conv":
                    mean = pv.mxu_mean_reference(
                        sk.label_kernel(x, ct, "blur5"))
                    differ = got != pv.pre_variant_reference(x, ct, v)
                    errs[f"{v}_{ct}_flips_out_of_reach"] = int(
                        (differ & ~pv.flip_reach(mean, MEAN_TOL)).sum())
                    continue
                errs[f"{v}_{ct}"] = max(
                    max_abs_err((got,), (pv.pre_variant_reference(x, ct, v),)),
                    max_abs_err((got,), (pre,)))
        torch.cuda.synchronize()
        phase(f"check probe cases {h}x{w} ({x.shape[0]} frames): "
              f"max_abs_err {errs}")
        err = max(err, *errs.values())
    if err:
        fail("a preprocess probe differs from its plain version on the "
             "small-frame cases")
    x = torch.from_numpy(np.ascontiguousarray(
        scene.make_frames(2, seed=3).transpose(0, 3, 1, 2))).to(dev)
    calls = {s: (lambda s=s: pv.roll_stage(x, CONTRAST, s))
             for s in pv.ROLL_STAGES}
    calls.update({v: (lambda v=v: pv.pre_variant(x, CONTRAST, v))
                  for v in pv.VARIANTS})
    traced = {}
    for name, fn in calls.items():
        traced[name] = cuda_kernels(fn)
        want = {"k_pre_variant": 1}
        if pv.launches_per_call(name) == 2:
            want["k_band_table"] = 1
        if traced[name] != want:
            fail(f"{name} launched {traced[name]}, not {want}")
    phase(f"preprocess probes: CUDA kernels per call (traced) {traced}")
    return err, traced


def check_fill_cases(dev):
    """Phase 3e's cases that attack the sweep fill's words and the tile
    fill's tiles: every variant of fill_mask against the plain sweep fill
    and the tile union-find fill (ccl_tiled.flood_fill) on
    scene.tile_case_masks, fix_case_masks and bit_case_masks at 640x480,
    477x631, 13x17, 3x3, the bit cases' sizes and FILL_LARGEST; then the
    CUDA kernels of one fill_sweeps and one fill_mask call, traced.
    Returns the largest error (0 or the run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_tiled
    from heimdall_tpu_torch.ops import fill_sweeps as fs
    from heimdall_tpu_torch.ops import split_kernels as sk

    makers = {"tile": scene.tile_case_masks, "fix": scene.fix_case_masks,
              "bit": scene.bit_case_masks}
    sizes = ((480, 640), (477, 631), (13, 17), (3, 3), *FILL_LARGEST)
    err = 0
    for kind, make in makers.items():
        for h, w in sizes + (scene.BIT_CASE_SIZES if kind == "bit" else ()):
            masks = make(h, w)
            mask = torch.from_numpy(np.stack(list(masks.values()))
                                    .astype(np.uint8)).to(dev)
            want = fs.sweep_fill_reference(mask)
            errs = {"plain_vs_union_find": max_abs_err(
                (want,), (ccl_tiled.flood_fill(mask),))}
            for v in fs.VARIANTS:
                errs[v] = max_abs_err((fs.fill_mask(mask, v),), (want,))
                if fs.fill_mask.instance != fs.INSTANCES[v]:
                    fail(f"fill_mask {v} ran {fs.fill_mask.instance}, not "
                         f"{fs.INSTANCES[v]}")
            torch.cuda.synchronize()
            phase(f"check fill {kind} cases {h}x{w} ({len(masks)} masks): "
                  f"max_abs_err {errs}")
            err = max(err, *errs.values())
    if err:
        fail("a sweep fill variant differs from the plain fill or the tile "
             "union-find fill on the fill cases")
    x = torch.from_numpy(np.ascontiguousarray(
        scene.make_frames(2, seed=3).transpose(0, 3, 1, 2))).to(dev)
    traced = {}
    for v in {i: v for v, i in reversed(fs.INSTANCES.items())}.values():
        traced[v] = cuda_kernels(lambda: fs.fill_sweeps(x, CONTRAST, v))
        if traced[v] != FILL_SWEEPS_KERNELS:
            fail(f"fill_sweeps {v} launched {traced[v]}, not "
                 f"{FILL_SWEEPS_KERNELS}")
    pre = sk.label_kernel(x, CONTRAST, "pre")
    alone = cuda_kernels(lambda: fs.fill_mask(pre))
    phase(f"fill_sweeps: CUDA kernels per call (traced, one variant of "
          f"each instance) {traced}; fill_mask alone {alone}")
    if alone != {"k_carry_fill": 1}:
        fail(f"fill_mask launched {alone}, not one k_carry_fill")
    return err


def probe_phases(dev, smi, cases, t_roll, roll_launches):
    """Phases 3e and 5e: the probe kernels (roll stages, preprocess
    variants, sweep fills) against their plain versions on phase 3d's
    frames and the repaired stats kernel on a non-root label plane, then the
    probes path (the port's profile_pre_variants and profile_fill_variants;
    the roll stages are phase 5d's profile_preprocess run, t_roll and
    roll_launches) with the probe kernels' counts set to 0 just before and
    read just after; returns the probes' entries of the kernels line."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import fill_sweeps as fs
    from heimdall_tpu_torch.ops import pre_variants as pv
    from heimdall_tpu_torch.ops import split_kernels as sk
    from heimdall_tpu_torch.ops.fused_kernels import kernel_taps
    from heimdall_tpu_torch.scripts import (profile_fill_variants,
                                            profile_pre_variants)

    # -- 3e. probe kernels against their plain versions ---------------------
    uniform = torch.full((2, 3, 480, 640), 128, dtype=torch.uint8, device=dev)
    adv = next(n for n in cases if n.startswith("adversarial_"))
    err, mean_err, flips = 0, 0.0, 0
    for name, x, ct in (
            ("bench8_channel_major", cases["bench8_channel_major"][0],
             CONTRAST),
            (adv, cases[adv][0], CONTRAST),
            ("bench2_477x631", cases["bench2_477x631"][0], CONTRAST),
            ("uniform_no_foreground", uniform, CONTRAST),
            ("uniform_full_foreground", uniform, -CONTRAST)):
        e, m, f = check_probes(name, x, ct)
        err, mean_err, flips = max(err, e), max(mean_err, m), flips + f
    fill_err = check_fill_cases(dev)
    case_err, probe_kernels = check_probe_cases(dev)
    err = max(err, case_err)
    x = torch.cat([cases["bench8_channel_major"][0], cases[adv][0]])
    labels = scene.non_root_labels(sk.label_kernel(x, CONTRAST))
    got = sk.stats_kernel(x, labels, K)
    torch.cuda.synchronize()
    stats_err = max_abs_err(got, sk.stats_kernel_reference(x, labels, K))
    phase(f"check stats on a non-root label plane (bench + adversarial): "
          f"n_blobs {got[3].tolist()} max_abs_err {stats_err}")
    if stats_err:
        fail("the stats kernel differs from its plain version on a label "
             "plane whose labels need not name a root")

    # -- 5e. the probes path -----------------------------------------------
    torch.cuda.synchronize()
    for w in (pv.pre_variant, fs.fill_sweeps, fs.fill_mask):
        w.launches = 0
    pv.pre_variant.variant_launches.clear()
    fs.fill_sweeps.variant_launches.clear()
    fs.fill_mask.variant_launches.clear()
    t_var, batch_flips = profile_pre_variants.main([str(BATCH), "10"])
    t_fill, t_alone = profile_fill_variants.main([str(BATCH), "10"])
    torch.cuda.synchronize()
    launches = {"roll_stages": roll_launches[0],
                "pre_variants": pv.pre_variant.launches,
                "fill_sweeps": fs.fill_sweeps.launches,
                "fill_mask": fs.fill_mask.launches}
    phase(f"probes path: profile_preprocess (phase 5d's run) + "
          f"profile_pre_variants + profile_fill_variants launched "
          f"{launches}; by stage {roll_launches[1]}, by variant "
          f"{dict(pv.pre_variant.variant_launches)} "
          f"{dict(fs.fill_sweeps.variant_launches)}; fill_mask by variant "
          f"{dict(fs.fill_mask.variant_launches)}")
    if not all(launches.values()) or set(
            fs.fill_mask.variant_launches) != set(fs.VARIANTS):
        fail("the probes path did not launch every probe kernel")
    if not all(v > 0 for v in (*t_roll.values(), *t_var.values(),
                                *t_fill.values(), *t_alone.values())):
        fail("the probes path's timings are wrong")
    phase(f"{smi}: sweep fill 'new' {t_fill['new']:.3f} us/frame with its "
          f"pre stage, {t_alone['new']:.3f} alone "
          f"({fs.INSTANCES['new']}), against the union-find fill "
          f"{t_fill['union_find']:.3f} (pre + fill, batch {BATCH}); "
          f"mxu_conv flips {batch_flips} in {BATCH} frames")

    # -- 5e. plain versions, bounds, the products and their library calls --
    x = torch.from_numpy(np.ascontiguousarray(
        scene.make_frames(BATCH, seed=0).transpose(0, 3, 1, 2))).to(dev)
    px = BATCH * 480 * 640
    blurred = sk.label_kernel(x, CONTRAST, "blur5")
    pre = sk.label_kernel(x, CONTRAST, "pre")
    k11 = list(kernel_taps()[1])
    tw = pv.band_matrix(640, k11, dev)
    th = pv.band_matrix(480, k11, dev).T.contiguous()
    xf = blurred.to(torch.float32)
    bg = (pre == 0).to(torch.int32)
    start_r = bg - bg * torch.nn.functional.pad(bg, (1, 0))[..., :-1]
    start_c = bg - bg * torch.nn.functional.pad(bg, (0, 0, 1, 0))[..., :-1, :]
    products = {
        "mxu_mean": (lambda: pv.mxu_mean(blurred),
                     lambda: torch.matmul(th, torch.matmul(xf, tw))),
        "run_ids": (lambda: fs.run_ids(pre),
                    lambda: (torch.cumsum(start_r, -1),
                             torch.cumsum(start_c, -2))),
    }
    prod_ms = {}
    pv.mxu_mean.launches = fs.run_ids.launches = 0
    for name, (kfn, lfn) in products.items():
        kfn(), lfn()
        torch.cuda.synchronize()
        prod_ms[name] = (cuda_ms(kfn, 10), cuda_ms(lfn, 10))
        phase(f"{smi}: {name} (tensor cores) {prod_ms[name][0]:.4f} ms per "
              f"{BATCH} frames; the PyTorch call of the same function "
              f"{prod_ms[name][1]:.4f} ms")
    phase(f"products timed: mxu_mean launched {pv.mxu_mean.launches}, "
          f"run_ids {fs.run_ids.launches} times (1 warm-up, then "
          f"cuda_ms's runs)")
    if (pv.mxu_mean.launches, fs.run_ids.launches) != (11, 11):
        fail("a tensor-core product was not launched once per timed call")
    run_ids_launches = fs.run_ids.launches
    plain = {"roll_stages": lambda: pv.roll_stage_reference(x, CONTRAST,
                                                            "full_roll"),
             "pre_variants": lambda: pv.pre_variant_reference(x, CONTRAST,
                                                              "mxu_conv"),
             "fill_sweeps": lambda: fs.fill_sweeps_reference(x, CONTRAST),
             "run_ids": lambda: fs.run_ids_reference(pre)}
    us = {"roll_stages": t_roll["full_roll"],
          "pre_variants": t_var["mxu_conv"], "fill_sweeps": t_fill["new"],
          "run_ids": prod_ms["run_ids"][0] / BATCH * 1e3}
    launches["run_ids"] = run_ids_launches
    variants = {"roll_stages": {s: t_roll[s] for s in pv.ROLL_STAGES},
                "pre_variants": t_var, "fill_sweeps": t_fill}
    # bytes and operations: frame in, plane out, the f32 mean (and
    # mxu_conv's products); the run ids: mask in, two int16 planes out
    bytes_ms = px * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = max(mean_ops_ms(px),
                 px * MXU_FLOPS_PER_PX / TF32_FLOPS_PER_S * 1e3)
    bounds = {n: (bytes_ms, ops_ms) for n in plain}
    bounds["run_ids"] = (px * 5 / HBM_BYTES_PER_S * 1e3, 0.0)
    replaces = {
        "roll_stages": "scripts/profile_preprocess.py:100",
        "pre_variants": "scripts/profile_pre_variants.py:186",
        "fill_sweeps": "scripts/profile_fill_variants.py:211",
        "run_ids": "scripts/profile_fill_variants.py:211"}
    sources = {"roll_stages": "pre_variants.cu",
               "pre_variants": "pre_variants.cu",
               "fill_sweeps": "fill_sweeps.cu", "run_ids": "fill_sweeps.cu"}
    design = {
        "roll_stages": "the one-pass tile preprocess with the wrap halo "
                       "loaded at wrapped frame positions (1 launch)",
        "pre_variants": "the one-pass tile preprocess, an instance a "
                        "variant (1 launch; mxu_conv 2: its band tables, "
                        "then the mean's products on the tensor cores "
                        "inside the tile)",
        "fill_sweeps": "hd_label's pre (k_preprocess), then k_carry_fill: "
                       "one 512-thread block a frame, bit planes in shared "
                       "memory, run-ORs as carries (2 launches)",
        "run_ids": "k_run_ids along the rows and the columns, a "
                   "tensor-core product each (2 launches)"}
    entries = []
    for name, fn in plain.items():
        fn()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(fn, 1)
        b_ms, o_ms = bounds[name]
        entry = {
            "name": name, "route": "cuda",
            "source": "heimdall_tpu_torch/csrc/" + sources[name],
            "design": design[name],
            "replaces": replaces[name], "equal": err == 0,
            "launches": launches[name], "max_abs_err": err,
            "ms": us[name] * BATCH / 1e3, "plain_ms": plain_ms,
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call computes it",
            "batch": BATCH, "frame": "640x480x3"}
        if name in variants:
            entry["variants"] = {v: t * BATCH / 1e3
                                 for v, t in variants[name].items()}
        if name in ("roll_stages", "pre_variants"):
            entry["cuda_kernels_per_call"] = {
                v: probe_kernels[v] for v in variants[name]}
            entry["max_abs_err_small_frames"] = case_err
        if name == "pre_variants":
            entry.update(
                library_ms=prod_ms["mxu_mean"][1],
                library_note="torch.matmul of mxu_conv's banded matrices "
                             "(its products alone; product_ms is the "
                             "kernel's)",
                product_ms=prod_ms["mxu_mean"][0], ms_of="mxu_conv",
                mxu_conv_mean_max_abs_err=mean_err,
                mxu_conv_flips=batch_flips)
        elif name == "fill_sweeps":
            alone_ms = px * 2 / HBM_BYTES_PER_S * 1e3  # mask in, plane out
            entry.update(
                ms_of="new", instances=fs.INSTANCES,
                max_abs_err_fill_cases=fill_err,
                launches_fill_mask=launches["fill_mask"],
                alone_ms={v: t * BATCH / 1e3 for v, t in t_alone.items()},
                alone_bound_ms=alone_ms, alone_bound_by="bytes",
                union_find_ms=t_fill["union_find"] * BATCH / 1e3)
        elif name == "run_ids":
            entry.update(
                library_ms=prod_ms["run_ids"][1],
                library_note="torch.cumsum of the run starts along the rows "
                             "and the columns",
                ms_of="mxu, no guard rows")
        else:
            entry["ms_of"] = "full_roll"
        entries.append(entry)
        if name == "run_ids":
            phase(f"{smi}: run_ids {us[name]:.3f} us/frame (batch {BATCH} "
                  f"of 640x480 masks); plain version "
                  f"{plain_ms / BATCH * 1e3:.1f} us/frame; torch.cumsum "
                  f"{prod_ms['run_ids'][1] / BATCH * 1e3:.3f} us/frame; "
                  f"bound {entry['bound_ms'] / BATCH * 1e3:.3f} us/frame")
            continue
        phase(f"{smi}: {name} ({entry['ms_of']}) {us[name]:.3f} us/frame "
              f"(probes path, batch {BATCH} of 640x480x3); plain version "
              f"{plain_ms / BATCH * 1e3:.1f} us/frame; bound "
              f"{entry['bound_ms'] / BATCH * 1e3:.3f} us/frame")
    return entries


def check_label_probes(name, x, ct):
    """Phase 3f on one case: every CCL variant and every joint variant on
    both paths (the one the frame's shape picks, and the global path)
    against its plain version and (fixpoints) the label kernel's "ccl" and
    "fill" stages, and the run tables' fits flags against their plain
    versions; returns the largest error (0 or the run fails)."""
    import torch
    from heimdall_tpu_torch.ops import ccl_sweeps as cs
    from heimdall_tpu_torch.ops import joint_label as jl
    from heimdall_tpu_torch.ops import split_kernels as sk
    errs = {}
    labels, filled = sk.label_kernel(x, ct), sk.label_kernel(x, ct, "fill")
    pre = sk.label_kernel(x, ct, "pre")
    H, W = x.shape[-2:]
    want_path = {"ccl": cs.choose_path(H, W)[0],
                 "joint": cs.choose_path(H, W, mask=True)[0]}
    for v in cs.VARIANTS:
        want = cs.ccl_mask_reference(filled, v)
        got = cs.ccl_variant(x, ct, v)
        if cs.ccl_mask.last_path != want_path["ccl"]:
            fail(f"ccl {v} at {H}x{W} took the {cs.ccl_mask.last_path} path")
        errs[f"ccl_{v}"] = max_abs_err((got,), (want,))
        errs[f"ccl_{v}_global"] = max_abs_err(
            (cs.ccl_mask(filled, v, path="global"),), (want,))
        if v != "fixed2":
            errs[f"ccl_{v}_vs_union_find"] = max_abs_err((got,), (labels,))
    fits = {}
    for r in sorted(set(cs.RUNTABLE_VARIANTS.values()), reverse=True):
        want = cs.runtable_reference(filled, r)
        got = cs.ccl_runtable(filled, r)
        errs[f"runtable{r}_fits"] = max_abs_err(got, want)
        errs[f"runtable{r}_fits_global"] = max_abs_err(
            cs.ccl_runtable(filled, r, path="global"), want)
        fits[r] = int(got[1].sum())
    for v in jl.VARIANTS:
        want = jl.joint_label_reference(x, ct, v)
        got = jl.joint_label(x, ct, v)
        if jl.joint_mask.last_path != want_path["joint"]:
            fail(f"joint {v} at {H}x{W} took the {jl.joint_mask.last_path} "
                 f"path")
        errs[f"joint_{v}"] = max_abs_err(got, want)
        errs[f"joint_{v}_global"] = max_abs_err(
            jl.joint_mask(pre, v, path="global"), want)
        errs[f"joint_{v}_vs_union_find"] = max_abs_err(got, (labels, filled))
    torch.cuda.synchronize()
    phase(f"check label probes {name} (contrast {ct}, paths {want_path} "
          f"and global): frames on the run tables by R {fits} of "
          f"{x.shape[0]}; max_abs_err {errs}")
    if any(errs.values()):
        fail(f"a labeling probe differs from its plain version or from the "
             f"label kernel on {name}")
    return max(errs.values())


# Shapes on each side of the cluster path's cut (ops/ccl_sweeps.py::
# band_layout): 16 blocks hold the sweep CCL's planes up to 608 rows of
# 640 and the joint fixpoint's (with its mask rows) up to 544.  The
# wrappers' limits (1008 x 1024) and 96 x 128 are the card tests'
# (tests/test_torch_ccl_cuda.py); 5f's run-table check runs 96 x 128.
LABEL_CUT_SHAPES = ((544, 640), (545, 640), (608, 640), (609, 640))


def check_label_cut(dev):
    """Phase 3f on the masks of the run-table check and the adversarial
    masks at LABEL_CUT_SHAPES: every sweep variant, the run tables at R 12
    (its fallback frames on the sweep kernel's path) and every joint
    variant, on the path the shape picks and the global path, against
    their plain versions, with the path checked; returns the largest
    error and {shape: paths}."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_sweeps as cs
    from heimdall_tpu_torch.ops import joint_label as jl
    err, paths = 0, {}
    for h, w in LABEL_CUT_SHAPES:
        m = torch.from_numpy(np.stack(
            list(scene.check_runtable_masks(h, w).values())
            + [a.astype(np.uint8) for a in scene.adversarial_masks(
                h, w, seed=2).values()])).to(dev)
        errs = {}
        path = cs.choose_path(h, w)[0]
        for v in cs.SWEEP_VARIANTS:
            want = cs.sweep_ccl_reference(m, v)
            errs[f"ccl_{v}"] = max_abs_err((cs.ccl_mask(m, v),), (want,))
            if cs.ccl_mask.last_path != path:
                fail(f"ccl {v} at {h}x{w} took {cs.ccl_mask.last_path}, "
                     f"not {path}")
            if path == "cluster":
                errs[f"ccl_{v}_global"] = max_abs_err(
                    (cs.ccl_mask(m, v, path="global"),), (want,))
        errs["runtable12"] = max_abs_err(cs.ccl_runtable(m, 12),
                                         cs.runtable_reference(m, 12))
        jpath = cs.choose_path(h, w, mask=True)[0]
        for v in jl.VARIANTS:
            want = jl.joint_mask_reference(m, v)
            errs[f"joint_{v}"] = max_abs_err(jl.joint_mask(m, v), want)
            if jl.joint_mask.last_path != jpath:
                fail(f"joint {v} at {h}x{w} took {jl.joint_mask.last_path}, "
                     f"not {jpath}")
            if jpath == "cluster":
                errs[f"joint_{v}_global"] = max_abs_err(
                    jl.joint_mask(m, v, path="global"), want)
        torch.cuda.synchronize()
        paths[f"{h}x{w}"] = {"ccl": path, "joint": jpath}
        phase(f"check label probes at the cut {h}x{w} ({m.shape[0]} masks; "
              f"paths ccl {path}, joint {jpath}, and global): max_abs_err "
              f"{errs}")
        if any(errs.values()):
            fail(f"a labeling probe differs from its plain version at "
                 f"{h}x{w}")
        err = max(err, *errs.values())
    return err, paths


def check_runtable_cases(dev):
    """Phase 3f's cases for the run tables: scene.run_case_masks (rows of
    exactly 6 to 13 runs, runs that start, end and cross the 16-column
    lanes and the 512-column steps, one-pixel runs, full rows) at
    RUN_CASE_SIZES, each size one batch of frames that fit and frames that
    overflow, at R 12, 10, 8, 6 on both paths: labels and fits against the
    plain version, and the run-id product's frames against the frames that
    do not fit.  Returns the largest error (0 or the run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_sweeps as cs
    err = 0
    for h, w in RUN_CASE_SIZES:
        m = torch.from_numpy(np.stack(list(scene.run_case_masks(h, w)
                                           .values())).astype(np.uint8))
        m = m.to(dev)
        errs, ran = {}, {}
        for r in (12, 10, 8, 6):
            want = cs.runtable_reference(m, r)
            for p in ("cluster", "global"):
                if p == "cluster" and cs.band_layout(h, w) is None:
                    continue
                got = cs.ccl_runtable(m, r, path=p)
                n = int(cs.ccl_runtable.runid_frames)
                errs[f"R{r}_{p}"] = max_abs_err(got, want)
                errs[f"R{r}_{p}_runid_frames"] = abs(
                    n - (m.shape[0] - int(want[1].sum())))
                ran[f"R{r}_{p}"] = f"{n} of {m.shape[0]}"
        torch.cuda.synchronize()
        phase(f"check run-table cases {h}x{w}: run-id frames {ran}; "
              f"max_abs_err {errs}")
        err = max(err, *errs.values())
    if err:
        fail("the run tables differ from their plain version on the run "
             "cases, or numbered run ids of frames that fit")
    return err


def label_probe_phases(dev, smi, cases):
    """Phases 3f and 5f: the labeling probes (sweep and run-table CCL,
    joint fixpoint) against their plain versions on phase 3e's frames and
    the run-table check, then the labeling probes path (the port's
    check_runtable, profile_ccl_variants and profile_joint_variants) with
    their launch counts set to 0 just before and read just after; returns
    their entries of the kernels line."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_sweeps as cs
    from heimdall_tpu_torch.ops import joint_label as jl
    from heimdall_tpu_torch.ops import split_kernels as sk
    from heimdall_tpu_torch.scripts import (check_runtable,
                                            profile_ccl_variants,
                                            profile_joint_variants)

    # -- 3f. labeling probes against their plain versions -------------------
    uniform = torch.full((2, 3, 480, 640), 128, dtype=torch.uint8, device=dev)
    adv = next(n for n in cases if n.startswith("adversarial_"))
    err = 0
    for name, x, ct in (
            ("bench8_channel_major", cases["bench8_channel_major"][0],
             CONTRAST),
            (adv, cases[adv][0], CONTRAST),
            ("bench2_477x631", cases["bench2_477x631"][0], CONTRAST),
            ("uniform_no_foreground", uniform, CONTRAST),
            ("uniform_full_foreground", uniform, -CONTRAST)):
        err = max(err, check_label_probes(name, x, ct))
    cut_err, cut_paths = check_label_cut(dev)
    err = max(err, cut_err, check_runtable_cases(dev))

    # -- 5f. the labeling probes path ----------------------------------------
    torch.cuda.synchronize()
    for w in (cs.ccl_mask, jl.joint_mask):
        w.launches = 0
        w.variant_launches.clear()
    failures = check_runtable.main([])
    torch.cuda.synchronize()
    s7_launches = cs.ccl_mask.launches
    if failures or s7_launches != 28:
        fail(f"check_runtable: {failures} failures, {s7_launches} launches "
             f"(7 masks x 2 R x 2 labelings: 28)")
    t_ccl, short, fits = profile_ccl_variants.main([str(BATCH), "10"])
    t_joint = profile_joint_variants.main([str(BATCH), "10"])
    torch.cuda.synchronize()
    launches = {"ccl_variants": cs.ccl_mask.launches - s7_launches,
                "joint_label": jl.joint_mask.launches,
                "check_runtable": s7_launches}
    by_variant = dict(cs.ccl_mask.variant_launches)
    phase(f"labeling probes path: check_runtable + profile_ccl_variants + "
          f"profile_joint_variants launched {launches}; by variant "
          f"{dict(cs.ccl_mask.variant_launches)} "
          f"{dict(jl.joint_mask.variant_launches)}")
    if not all(launches.values()) or not all(
            cs.ccl_mask.variant_launches[v] for v in cs.VARIANTS) or not all(
            jl.joint_mask.variant_launches[v] for v in jl.VARIANTS):
        fail("the labeling probes path did not launch every variant")
    if not all(v > 0 for v in (*t_ccl.values(), *t_joint.values())):
        fail("the labeling probes path's timings are wrong")
    phase(f"{smi}: ccl 'cur' {t_ccl['cur']:.3f}, runtable "
          f"{t_ccl['runtable']:.3f} us/frame against the union-find labels "
          f"{t_ccl['union_find']:.3f} (fill + labels, batch {BATCH}); frames "
          f"on the run tables by R {fits} of {BATCH}; fixed2 leaves {short} "
          f"short; joint {t_joint['rowFull_col5']:.3f} against classic "
          f"{t_joint['classic']:.3f} and the union-find "
          f"{t_joint['union_find']:.3f}; full detect classic "
          f"{t_joint['detect_classic']:.3f} against joint "
          f"{t_joint['detect_joint']:.3f} us/frame (accepted equal)")

    # -- 5f. plain versions and bounds ---------------------------------------
    x = torch.from_numpy(np.ascontiguousarray(
        scene.make_frames(BATCH, seed=0).transpose(0, 3, 1, 2))).to(dev)
    px = BATCH * 480 * 640
    alone, plain_alone, design = label_kernels_alone(smi, x)
    # the run tables on the bench batch: every frame fits, so the run-id
    # product numbers none; and the CUDA kernels of one call, traced
    filled = sk.label_kernel(x, CONTRAST, "fill")
    rt_fits = int(cs.ccl_runtable(filled, 12)[1].sum())
    rt_runid_frames = int(cs.ccl_runtable.runid_frames)
    rt_kernels = cuda_kernels(lambda: cs.ccl_runtable(filled, 12))
    phase(f"runtable (R 12) on the bench batch: {rt_fits} of {BATCH} "
          f"frames fit, the run-id product numbered {rt_runid_frames}; "
          f"CUDA kernels per call (traced) {rt_kernels}")
    if rt_runid_frames != BATCH - rt_fits:
        fail("the run-id product numbered frames that fit")
    if rt_kernels != {"k_runtable_ccl": 1, "k_run_ids": 2,
                      "k_sweep_ccl_cluster": 1}:
        fail(f"the run tables launched {rt_kernels}")
    masks = torch.from_numpy(np.stack(list(
        scene.check_runtable_masks().values()))).to(dev)
    mpx = masks.numel()
    cs.ccl_runtable(masks)
    torch.cuda.synchronize()
    s7_ms = cuda_ms(lambda: cs.ccl_runtable(masks), 10)
    runs = {    # name: (plain version, us/frame or ms, bytes, variants)
        "ccl_variants": (lambda: cs.ccl_variant_reference(x, CONTRAST),
                         t_ccl["cur"] * BATCH / 1e3, px * (3 + 4),
                         "cur"),
        "joint_label": (lambda: jl.joint_label_reference(x, CONTRAST),
                        t_joint["rowFull_col5"] * BATCH / 1e3,
                        px * (3 + 4 + 1), "rowFull_col5"),
        "check_runtable": (lambda: cs.runtable_reference(masks),
                           s7_ms, mpx * (1 + 4) + masks.shape[0] * 4,
                           "runtable (R = 12) on the 7 masks in one batch"),
    }
    replaces = {"ccl_variants": "scripts/profile_ccl_variants.py:348",
                "joint_label": "scripts/profile_joint_variants.py:98",
                "check_runtable": "scripts/check_runtable.py:42"}
    sources = {"ccl_variants": "ccl_sweeps.cu", "joint_label": "joint_label.cu",
               "check_runtable": "ccl_sweeps.cu"}
    entries = []
    for name, (fn, ms, moved, ms_of) in runs.items():
        fn()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(fn, 1)
        entry = {
            "name": name, "route": "cuda",
            "source": "heimdall_tpu_torch/csrc/" + sources[name],
            "replaces": replaces[name], "equal": err == 0,
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a CCL",
            "ms_of": ms_of, "batch": BATCH, "frame": "640x480x3"}
        if name == "ccl_variants":
            entry.update(variants={v: u * BATCH / 1e3
                                   for v, u in t_ccl.items()},
                         runtable_fits=fits, fixed2_short=short)
        elif name == "joint_label":
            entry.update(variants={v: u * BATCH / 1e3
                                   for v, u in t_joint.items()})
        else:
            entry.update(batch=masks.shape[0], frame="96x128 mask",
                         also_source="heimdall_tpu_torch/ops/ccl_sweeps.py")
        entries.append(entry)
        n = entry["batch"]
        phase(f"{smi}: {name} ({ms_of}) {ms / n * 1e3:.3f} us/frame "
              f"(batch {n}); plain version {plain_ms / n * 1e3:.1f} us/frame;"
              f" bound {entry['bound_ms'] / n * 1e3:.3f} us/frame")
    # each kernel alone (S5-sweep, S5-rt, S6), on the path the bench frames
    # pick, beside its probe
    rt_variants = tuple(cs.RUNTABLE_VARIANTS)
    sweep_launches = sum(n for v, n in by_variant.items()
                         if v in cs.SWEEP_VARIANTS)
    rt_launches = sum(by_variant.get(v, 0) for v in rt_variants)
    for name, kind, ms_of, variants, probe, n_launch, moved in (
            ("sweep_ccl", "ccl", "cur", cs.SWEEP_VARIANTS, "ccl_variants",
             sweep_launches, px * 5),
            ("runtable_ccl", "ccl", "runtable", rt_variants, "ccl_variants",
             rt_launches, px * 5 + BATCH * 4),
            ("joint_mask", "joint", "rowFull_col5", jl.VARIANTS,
             "joint_label", launches["joint_label"], px * 6)):
        entries.append({
            "name": name, "route": "cuda",
            "source": "heimdall_tpu_torch/csrc/" + sources[probe],
            "sources": ["heimdall_tpu_torch/csrc/" + sources[probe],
                        "heimdall_tpu_torch/csrc/sweep_cluster.cuh",
                        "heimdall_tpu_torch/csrc/common.cuh"],
            "replaces": replaces[probe], "equal": err == 0,
            "launches": n_launch, "max_abs_err": err,
            "ms": alone[kind][ms_of]["cluster"],
            "plain_ms": plain_alone[ms_of],
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a CCL",
            "ms_of": f"{ms_of} alone on a prepared mask, cluster path",
            "batch": BATCH, "frame": "640x480 mask",
            "variants_ms_by_path": {v: alone[kind][v] for v in variants},
            "design": design[kind], "cut_paths": cut_paths})
        if name == "runtable_ccl":
            entries[-1].update(
                cuda_kernels_per_call=rt_kernels,
                runid_frames_bench=rt_runid_frames, fits_bench=rt_fits,
                fallback_cluster=design[kind],
                design="tables from the mask's bits a warp a row, one "
                       "512-thread block a frame (two an SM), then the run "
                       "ids and the sweep CCL of the frames that do not "
                       "fit: 4 launches")
        e = entries[-1]
        phase(f"{smi}: {name} alone ({ms_of}, batch {BATCH} of 640x480 "
              f"masks) {e['ms'] / BATCH * 1e3:.3f} us/frame on the cluster "
              f"path, {alone[kind][ms_of]['global'] / BATCH * 1e3:.3f} on "
              f"the global path; plain version "
              f"{e['plain_ms'] / BATCH * 1e3:.1f} us/frame; bound "
              f"{e['bound_ms'] / BATCH * 1e3:.3f} us/frame; launches "
              f"{n_launch}")
    return entries


def label_kernels_alone(smi, x):
    """Phase 5f: the sweep CCL, the run tables and the joint fixpoint alone
    (ccl_mask on the label kernel's filled mask of frames x, joint_mask on
    its pre mask), every variant on both paths, and the plain versions of
    cur, the run tables (R 12) and rowFull_col5; returns ({"ccl" | "joint":
    {variant: {path: ms a call}}}, {variant: plain ms}, {"ccl" | "joint":
    the cluster path's blocks, pass width and clusters at once})."""
    import torch
    from heimdall_tpu_torch.ops import ccl_sweeps as cs
    from heimdall_tpu_torch.ops import joint_label as jl
    from heimdall_tpu_torch.ops import split_kernels as sk
    H, W = x.shape[-2:]
    masks = {"ccl": sk.label_kernel(x, CONTRAST, "fill"),
             "joint": sk.label_kernel(x, CONTRAST, "pre")}
    calls = {"ccl": cs.ccl_mask, "joint": jl.joint_mask}
    alone = {"ccl": {}, "joint": {}}
    for kind, variants in (("ccl", cs.VARIANTS), ("joint", jl.VARIANTS)):
        for v in variants:
            for p in cs.PATHS:
                def fn(kind=kind, v=v, p=p):
                    calls[kind](masks[kind], v, path=p)
                fn()
                torch.cuda.synchronize()
                alone[kind].setdefault(v, {})[p] = cuda_ms(fn, 5)
    plain = {}
    for v, fn in (("cur", lambda: cs.ccl_mask_reference(masks["ccl"])),
                  ("runtable", lambda: cs.runtable_reference(masks["ccl"])),
                  ("rowFull_col5",
                   lambda: jl.joint_mask_reference(masks["joint"]))):
        fn()
        torch.cuda.synchronize()
        plain[v] = cuda_ms(fn, 1)
    design = {}
    for kind, joint in (("ccl", False), ("joint", True)):
        C, P = cs.band_layout(H, W, joint)
        design[kind] = {
            "cluster_blocks": C, "pass_cols": P,
            "smem_bytes_a_block": cs.band_bytes(H, W, C, P, joint),
            "active_clusters": cs.active_clusters(H, W, joint)}
    phase(f"{smi}: labeling kernels alone at {H}x{W} (cluster path "
          f"{design}), ms a call of {x.shape[0]} frames by variant and "
          f"path: {json.dumps(alone)}")
    return alone, plain, design


def primitive_phases(dev, smi):
    """Phases 3g and 5g: the primitive microbench's variants against their
    plain versions (whole plane, N = 1, 4 and 36) on the script's planes and
    a second seed, then at the edges of the kernels' layouts
    (PRIM_EDGE_SHAPES, PRIM_CROSS_SHAPES; N = 0, 1, 37), timing the plain
    versions and the cumsum variants' torch.cumsum step on the script's
    planes by the same differencing; then
    the microbench path (the port's microbench_vpu) with its launch count
    set to 0 just before and read just after; returns its entries of the
    kernels line."""
    import numpy as np
    import torch
    from heimdall_tpu_torch.ops import primitives as pr
    from heimdall_tpu_torch.scripts import microbench_vpu as mb

    def step_ms(fn, x):
        """ms of one step of fn on x: (t(N_HI) - t(N_LO)) / (N_HI - N_LO),
        each t of one call between CUDA events after fn(x, 1)."""
        t = {}
        fn(x, 1)
        for n in (mb.N_LO, mb.N_HI):
            torch.cuda.synchronize()
            t[n] = cuda_ms(lambda: fn(x, n), 1)
        return (t[mb.N_HI] - t[mb.N_LO]) / (mb.N_HI - mb.N_LO)

    library = {    # one PyTorch call computing the step, where there is one
        "mxu_cumsum": lambda v: torch.cumsum(v & 1, -1, dtype=v.dtype) & 63,
        "cumsum_ladder": lambda v: torch.cumsum(v & 1, -1, dtype=v.dtype)}

    def repeat(step):
        def fn(x, n):
            for _ in range(n):
                x = step(x)
            return x
        return fn

    # -- 3g. every variant against its plain version -------------------------
    errs, plain_ms, lib_ms = {}, {}, {}
    rng = np.random.RandomState(1)
    for name, dtype, planes in pr.inputs():
        second = rng.randint(-60, 60, (16,) + planes.shape[1:])
        key = f"{name}/{dtype}"
        errs[key] = 0
        for x in (planes, second.astype(dtype)):
            x = torch.from_numpy(x).to(dev)
            for iters in (1, 4, 36):
                got = pr.primitive_steps(x, name, iters, x.shape[1])
                want = pr.primitive_steps_reference(x, name, iters,
                                                    x.shape[1])
                torch.cuda.synchronize()
                errs[key] = max(errs[key], max_abs_err((got,), (want,)))
            del got, want
        x = torch.from_numpy(planes).to(dev)
        plain_ms[key] = step_ms(repeat(lambda v: pr.step_reference(name, v)),
                                x)
        if name in ("add", "transpose_pair"):    # plain steps of one call
            lib_ms[key] = plain_ms[key]
        elif name in library:
            lib_ms[key] = step_ms(repeat(library[name]), x)
        del x
    rng = np.random.RandomState(3)
    for name, dtype, _, _ in pr.VARIANTS:
        key = f"{name}/{dtype}"
        shapes = PRIM_EDGE_SHAPES + (
            PRIM_CROSS_SHAPES if name in pr.CROSS_ROW else ())
        for rows, w in shapes:
            sub = 2 * rows if name == "seg_min_step" else rows
            x = torch.from_numpy(rng.randint(-60, 60, (4, sub, w))
                                 .astype(dtype)).to(dev)
            for iters in PRIM_EDGE_ITERS:
                want = pr.primitive_steps_reference(x, name, iters, sub)
                for out_rows in (1, sub):
                    got = pr.primitive_steps(x, name, iters, out_rows)
                    torch.cuda.synchronize()
                    errs[key] = max(errs[key], max_abs_err(
                        (got,), (want[:, :out_rows],)))
    phase(f"check primitives (27 variants, whole plane, N = 1, 4, 36, the "
          f"script's planes and seed 1; at the layouts' edges, N = 0, 1, "
          f"37, row 0 and the whole plane): max_abs_err {errs}")
    if any(errs.values()):
        fail("a primitive microbench kernel differs from its plain version")

    # -- 5g. the microbench path ----------------------------------------------
    torch.cuda.synchronize()
    pr.primitive_steps.launches = 0
    pr.primitive_steps.variant_launches.clear()
    results = mb.main([])
    torch.cuda.synchronize()
    launches = pr.primitive_steps.launches
    by_variant = dict(pr.primitive_steps.variant_launches)
    phase(f"primitive microbench path: microbench_vpu launched "
          f"primitive_steps {launches} times; by variant {by_variant}")
    want_launches = 2 * (1 + mb.REPS)
    if (launches != len(pr.VARIANTS) * want_launches
            or set(by_variant.values()) != {want_launches}
            or len(by_variant) != len(pr.VARIANTS)):
        fail(f"the microbench path did not launch every variant "
             f"{want_launches} times")
    if len(results) != len(pr.VARIANTS) or not all(
            np.isfinite(r["us_per_op"]) and r["us_per_op"] > 0
            for r in results):
        fail(f"the microbench's results are wrong: {results}")

    # -- 5g. bounds, plain versions and library calls --------------------------
    subs = {n: sub for n, _, sub, _ in pr.VARIANTS}
    mhz = clocks_max_sm_mhz()
    int_ops_per_s = H100_SMS * DISPATCH_LANES_PER_SM * mhz * 1e6
    px = mb.H * mb.W * mb.B
    entries = []
    for r in results:
        name, dtype = r["op"], r["dtype"]
        key = f"{name}/{dtype}"
        bound_ms = PRIM_OPS[name] * px / int_ops_per_s * 1e3
        if name == "mxu_cumsum":      # the triangle's useful multiply-adds
            bound_ms = max(bound_ms, 2 * mb.B * mb.H * mb.W * (mb.W + 1) / 2
                           / BF16_FLOPS_PER_S * 1e3)
        ms = r["us_per_op"] * mb.B / 1e3
        entries.append({
            "name": f"primitive_{name}_{dtype}", "route": "cuda",
            "source": "heimdall_tpu_torch/csrc/primitives.cu",
            "replaces": "scripts/microbench_vpu.py:280",
            "equal": errs[key] == 0, "launches": by_variant[key],
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms[key],
            "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": lib_ms.get(key),
            "design": PRIM_DESIGN[
                name if name in ("transpose_pair", "mxu_cumsum") else
                "cross" if name in pr.CROSS_ROW else "rows"],
            "library_note": {
                "mxu_cumsum": "torch.cumsum(v & 1) & 63 step",
                "cumsum_ladder": "torch.cumsum(v & 1) step",
                "add": "the plain step v + 1 is one PyTorch call",
                "transpose_pair": "the plain step v.clamp_max(63) is one "
                                  "PyTorch call"}.get(
                name, "no single PyTorch call computes the step"),
            "us_per_op": r["us_per_op"],
            "ms_of": "one step of the batch, (t(36) - t(4)) / 32",
            "batch": mb.B, "frame": f"{subs[name]}x{mb.W} {dtype}",
            "clocks_max_sm_mhz": mhz})
        lib = f"; library call {lib_ms[key] / mb.B * 1e3:.4f}" \
            if key in lib_ms else ""
        bound_us = bound_ms / mb.B * 1e3
        phase(f"{smi}: primitive {name} {dtype} {r['us_per_op']:.4f} "
              f"us/op/frame; bound {bound_us:.4f} (operations), twice the "
              f"bound {2 * bound_us:.4f}; plain version "
              f"{plain_ms[key] / mb.B * 1e3:.4f}{lib}")
    return entries


# The multi-device path (phase 4g): the 2 MP frames of the spatial step, its
# world (ranks x spatial shards on the one card), the band request of the
# JAX entry, the 1-rank data-parallel and line steps' batches, and the
# timed steps.
SP_BATCH = 4
SP_RANKS = 4
SP_BAND = 128
DP_BATCH_640 = 8
DP_BATCH_2MP = 4
SP_STEP_ITERS = 3
SP_GATES = (CONTRAST, 10.0, 3000.0, 0.25)   # the detector's defaults
SP_WRAPPERS = ("flood_fill_sp", "band_ccl_sp", "banded_stats_sp",
               "bbox_sums", "preprocess")


def _sp_wrappers():
    """Every wrapper that the multi-device path may launch, by name."""
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import preprocess_tiled as pt
    from heimdall_tpu_torch.ops import runtable_tiled as rt
    from heimdall_tpu_torch.ops import stats_tiled as st
    return {"flood_fill_sp": ct.flood_fill_sp, "band_ccl_sp": ct.band_ccl_sp,
            "banded_stats_sp": st.banded_stats_sp,
            "bbox_sums": st.bbox_sums, "preprocess": fk.preprocess,
            "flood_fill": ct.flood_fill, "band_ccl": ct.band_ccl,
            "merge_bands": ct.merge_bands, "banded_stats": st.banded_stats,
            "fused_detect": fk.contamination_fused,
            "preprocess_tiled": pt.contamination_preprocess_tiled,
            "run_extract": rt.run_extract, "flood_fix": rt.flood_fix,
            "fill_extract": rt.fill_extract, "label_fix": rt.label_fix,
            "writeback": rt.writeback}


def sp_rank(frames, k):
    """One rank of phase 4g's 1 x SP_RANKS world on the card: the
    spatially-sharded step on its rows of the 2 MP frames, the wrappers'
    counts from 0 around it, then SP_STEP_ITERS timed steps."""
    import torch
    import torch.distributed as dist
    from heimdall_tpu_torch.parallel.mesh import make_mesh
    from heimdall_tpu_torch.parallel.sharding import shard_batch
    from heimdall_tpu_torch.parallel.tiled_sp import (
        connected_components_tiled_sp, fill_holes_tiled_sp,
        make_tiled_spatial_step)

    mesh = make_mesh(data=1, spatial=dist.get_world_size())
    x = shard_batch(mesh, frames, spatial=True)
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    step = make_tiled_spatial_step(mesh, band=SP_BAND, max_blobs=k)
    wrappers = _sp_wrappers()
    sync()
    for w in wrappers.values():
        w.launches = 0
    table, conf, accepted = step(x, *SP_GATES)
    sync()
    launches = {n: w.launches for n, w in wrappers.items()}
    rounds = fill_holes_tiled_sp.last_rounds
    branch = connected_components_tiled_sp.last_branch
    times = []
    for _ in range(SP_STEP_ITERS):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        step(x, *SP_GATES)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"table": table, "conf": conf, "accepted": accepted,
            "launches": launches, "rounds": rounds, "branch": branch,
            "step_ms": times, "device": str(x.device),
            "backend": dist.get_backend(), "shard": tuple(x.shape)}


def dp_rank(frames_640, frames_2mp, k):
    """The 1-rank NCCL world of phase 4g: both data-parallel steps and the
    line step at 640x480 and 2 MP, the wrappers' counts from 0 around
    them."""
    import torch
    import torch.distributed as dist
    from heimdall_tpu_torch.parallel.inspect_step import (
        make_line_step, make_pallas_data_parallel_step,
        make_tiled_data_parallel_step)
    from heimdall_tpu_torch.parallel.mesh import make_mesh
    from heimdall_tpu_torch.parallel.sharding import shard_batch

    mesh = make_mesh(data=1, spatial=1)
    wrappers = _sp_wrappers()
    x640 = shard_batch(mesh, frames_640)
    sync = torch.cuda.synchronize if x640.is_cuda else (lambda: None)
    sync()
    for w in wrappers.values():
        w.launches = 0
    out = {"backend": dist.get_backend()}
    x2 = shard_batch(mesh, frames_2mp)
    out["pallas_dp_640"] = make_pallas_data_parallel_step(
        mesh, max_blobs=k)(x640, *SP_GATES)
    out["tiled_dp_2mp"] = make_tiled_data_parallel_step(
        mesh, max_blobs=k, band=SP_BAND)(x2, *SP_GATES)
    line = make_line_step(mesh, max_blobs=k)
    out["line_640"] = line(shard_batch(mesh, frames_640, spatial=True),
                           *SP_GATES, 0.7)
    out["line_2mp"] = line(shard_batch(mesh, frames_2mp, spatial=True),
                           *SP_GATES, 0.7)
    sync()
    out["launches"] = {n: w.launches for n, w in wrappers.items()}
    return out


def _shards(x, n):
    """The n row shards of a [B, H, ...] tensor, each contiguous."""
    hl = x.shape[1] // n
    return [x[:, i * hl:(i + 1) * hl].contiguous() for i in range(n)]


def check_sp_entries(dev):
    """Phase 4g's checks: the three shard entries (B5b-sp, B5a-sp, B4a-sp)
    against their plain versions on the card, exactly, on the 2 MP bench
    frames' closed binary planes and on scene.tile_case_masks and
    label_case_masks at 1920x1080 and 64x96, each cut into 4 (and 3)
    shards, with random reached halos on the cut rows (the fill) and the
    neighbours' mask rows (the stats; K = 64 and 4); the band labels with
    one band a shard and with bands that cut it.  Returns (largest error,
    the 2 MP bench shards' inputs for the timings and their whole
    frames' mask)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import fused_kernels as fk
    from heimdall_tpu_torch.ops import stats_tiled as st
    from heimdall_tpu_torch.ops.ccl import connected_components

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng = np.random.RandomState(11)
    bench = on(scene.make_frames(SP_BATCH, H2, W2, seed=2))
    gray_b, binary_b = fk.preprocess(bench, CONTRAST)
    sets = {
        "bench4_2mp": (binary_b > 0, gray_b, bench),
        "tile_cases_2mp": on(np.stack(list(
            scene.tile_case_masks(H2, W2).values()))),
        "label_cases_2mp": on(np.stack(list(
            scene.label_case_masks(H2, W2).values()))),
        "tile_cases_64x96": on(np.stack(list(
            scene.tile_case_masks(64, 96).values()))),
    }
    err, timing = 0, None
    for name, item in sets.items():
        mask, gray, color = item if isinstance(item, tuple) else (
            item, None, None)
        B, H, W = mask.shape
        if gray is None:
            gray = on(rng.randint(0, 256, (B, H, W), dtype=np.uint8))
            color = on(rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8))
        filled = ct.flood_reference(mask)
        labels = connected_components(filled, 8)
        errs = {}
        for n in (4, 3):
            hl = H // n
            if hl * n != H:
                continue
            masks, fills = _shards(mask, n), _shards(filled, n)
            labs = _shards(labels.reshape(B, H, W), n)
            grays, colors = _shards(gray, n), _shards(color, n)
            for i in range(n):
                ht = (on(rng.rand(B, W) < 0.5).to(torch.uint8)
                      if i > 0 else None)
                hb = (on(rng.rand(B, W) < 0.5).to(torch.uint8)
                      if i < n - 1 else None)
                key = f"{n}x{i}"
                errs[f"flood_fill_sp_{key}"] = max_abs_err(
                    (ct.flood_fill_sp(masks[i], i * hl, H, ht, hb),),
                    (ct.flood_sp_reference(masks[i], i * hl, H, ht, hb),))
                for band in sorted({hl, 54, 10, 1} if hl == 270 else
                                   {hl, 8} if hl % 8 == 0 else {hl}):
                    if hl % band:
                        continue
                    got = ct.band_ccl_sp(fills[i], band, i * hl * W, H * W)
                    want = ct.band_ccl_sp_reference(fills[i], band,
                                                    i * hl * W, H * W)
                    want += (ct.edge_rows(want[0], band),)
                    errs[f"band_ccl_sp_{key}_band{band}"] = max_abs_err(
                        got, want)
                fm = fills[i].to(torch.uint8)
                up = fills[i - 1][:, -1].to(torch.uint8) if i > 0 else None
                dn = (fills[i + 1][:, 0].to(torch.uint8) if i < n - 1
                      else None)
                for k in (K, 4):
                    rl, nb = ct._root_table(labels.reshape(B, H, W), k)
                    for c in (colors[i], None):
                        args = (labs[i], fm, grays[i], c, rl, nb)
                        errs[f"banded_stats_sp_{key}_k{k}"
                             f"{'_gray' if c is None else ''}"] = \
                            max_abs_err(
                                st.banded_stats_sp(*args, H * W, k, up, dn),
                                st.banded_stats_sp_reference(*args, k, up,
                                                             dn))
                if name == "bench4_2mp" and n == SP_RANKS and i == 1:
                    timing = (masks[i], fills[i], labs[i], fm, grays[i],
                              colors[i], ht, hb, up, dn, hl, H, W,
                              ct._root_table(labels.reshape(B, H, W), K),
                              mask)
        torch.cuda.synchronize()
        worst = max(errs.values())
        phase(f"check shard entries {name} ({B}x{H}x{W}, shards of 4 and "
              f"3): {len(errs)} checks, max_abs_err {worst}")
        if worst:
            fail(f"a shard entry differs from its plain version on {name}: "
                 f"{ {k: v for k, v in errs.items() if v} }")
        err = max(err, worst)
    return err, timing


def check_flood_sp_cases(dev):
    """Phase 4g's cases of B5b-sp's cluster design: the first, a middle and
    the last of 3 shards of 1, 14 and 270 rows, at 1920 columns (16-byte
    loads) and 517 (byte loads), with random reached halos, all-reached
    ones and none on the cut rows, on scene.tile_case_masks and
    label_case_masks and on scene.cut_maze_mask (a corridor that crosses
    a cut row twice); and a shard of 4100 columns, past the cluster's
    width, through the tile union-find.  Returns the largest error (0 or
    the run fails)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.ops import ccl_tiled as ct

    rng = np.random.RandomState(12)
    err, paths = 0, set()
    for hl, w in ((1, 1920), (14, 1920), (270, 1920), (1, 517), (14, 517),
                  (270, 517), (14, 4100)):
        h = 3 * hl
        masks = [*scene.tile_case_masks(h, w).values(),
                 *scene.label_case_masks(h, w).values()]
        if hl > 1:
            masks += [scene.cut_maze_mask(h, w, hl),
                      scene.cut_maze_mask(h, w, 2 * hl)]
        masks = torch.from_numpy(np.stack(masks)).to(dev)
        B = masks.shape[0]
        for i, m in enumerate(_shards(masks, 3)):
            for halo in ("random", "all", None):
                halos = [(torch.from_numpy(rng.rand(B, w) < 0.5) if halo ==
                          "random" else torch.ones(B, w, dtype=torch.bool))
                         .to(torch.uint8).to(dev)
                         if cut and halo else None for cut in (i > 0, i < 2)]
                got = ct.flood_fill_sp(m, i * hl, h, *halos)
                paths.add((w, ct.flood_fill_sp.last_path))
                err = max(err, max_abs_err(
                    (got,), (ct.flood_sp_reference(m, i * hl, h, *halos),)))
    torch.cuda.synchronize()
    want = {(1920, "cluster"), (517, "cluster"), (4100, "tiles")}
    phase(f"check flood_fill_sp cases (shards of 1, 14, 270 rows; first, "
          f"middle, last; halos random / all / none; mazes): max_abs_err "
          f"{err}; paths {sorted(paths)}")
    if err or paths != want:
        fail(f"flood_fill_sp differs from its plain version ({err}) or took "
             f"paths {paths}, not {want}")
    return err


def time_sp_entries(smi, timing):
    """Each shard entry's time per call on the 2 MP bench frames' second
    shard of four ([SP_BATCH, 270, 1920], both halos), its plain version's
    and its byte bound; {name: timings}."""
    import torch
    from heimdall_tpu_torch.ops import ccl_tiled as ct
    from heimdall_tpu_torch.ops import stats_tiled as st

    (mask, filled, labs, fm, gray, color, ht, hb, up, dn, hl, H, W,
     (rl, nb), full) = timing
    B = mask.shape[0]
    px = B * hl * W
    calls = {
        "flood_fill_sp": (
            lambda: ct.flood_fill_sp(mask, hl, H, ht, hb),
            lambda: ct.flood_sp_reference(mask, hl, H, ht, hb),
            2 * px + 2 * B * W),
        "band_ccl_sp": (
            lambda: ct.band_ccl_sp(filled, hl, hl * W, H * W),
            lambda: ct.band_ccl_sp_reference(filled, hl, hl * W, H * W),
            px * (1 + 4) + B * (128 + 1) * 4),
        "banded_stats_sp": (
            lambda: st.banded_stats_sp(labs, fm, gray, color, rl, nb, H * W,
                                       K, up, dn),
            lambda: st.banded_stats_sp_reference(labs, fm, gray, color, rl,
                                                 nb, K, up, dn),
            px * (4 + 1 + 1 + 3) + 2 * B * W + B * (K + 1) * 4
            + B * 12 * K * 4),
    }
    out = {}
    for name, (kernel, plain, nbytes) in calls.items():
        for _ in range(3):
            kernel()
        ms = cuda_ms(kernel, 20)
        plain()
        plain_ms = cuda_ms(plain, 2)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "bytes": nbytes,
                     "shard": [B, hl, W]}
        phase(f"{smi}: {name} {ms * 1e3:.3f} us per call on a shard of "
              f"{B}x{hl}x{W} ({ms / B * 1e3:.3f} us/frame-shard); plain "
              f"version {plain_ms:.3f} ms; bound {bound_ms * 1e3:.3f} us "
              f"(bytes)")
    # B5b-sp's launches, and B5b (the whole-frame fill, the frame's border
    # rules) at the same batch on the shard's masks and on whole frames
    from heimdall_tpu_torch.scripts.profile_stats_fill import measure
    fill = out["flood_fill_sp"]
    fill["kernels_us"] = measure(
        f"B5b-sp flood_fill_sp {B}x{hl}x{W}",
        lambda: ct.flood_fill_sp(mask, hl, H, ht, hb), 20,
        2 * px + 2 * B * W, 1, "call")["kernels_us"]
    fill["b5b_same_masks"] = measure(
        f"B5b flood_fill {B}x{hl}x{W}", lambda: ct.flood_fill(mask), 20,
        2 * px, 1, "call")
    fill["b5b_whole_frames"] = measure(
        f"B5b flood_fill {B}x{H}x{W}", lambda: ct.flood_fill(full), 20,
        2 * B * H * W, 1, "call")
    phase(f"{smi}: flood_fill_sp's launches, us a call: "
          f"{fill['kernels_us']}; B5b at batch {B}: "
          f"{fill['b5b_same_masks']['ms'] * 1e3:.3f} us a call on the same "
          f"{B}x{hl}x{W} masks, {fill['b5b_whole_frames']['ms'] * 1e3:.3f} "
          f"on {B}x{H}x{W}")
    return out


def parallel_phases(dev, smi):
    """Phase 4g, the multi-device path: the shard entries against their
    plain versions (check_sp_entries) and timed; make_tiled_spatial_step
    on SP_BATCH 2 MP BGR frames over a 1 x SP_RANKS world on the one card
    (gloo, the collectives staged through pinned host buffers; every
    kernel on the card), held equal to the single-card detector; a 1-rank
    NCCL world through both data-parallel steps and the line step at
    640x480 and 2 MP, held equal to the single-card detector.  Returns
    ({wrapper: launches over the spatial world's ranks}, the phase's
    figures, {entry: timings}, the entries' largest error)."""
    import numpy as np
    import torch
    from heimdall_tpu_torch import ContaminationDetector, scene
    from heimdall_tpu_torch.parallel.launch import launch

    err, timing = check_sp_entries(dev)
    err = max(err, check_flood_sp_cases(dev))
    times = time_sp_entries(smi, timing)

    det = ContaminationDetector(config={"include_contours": False})

    def same(name, got, want):
        table, conf, accepted = got[:3]
        wt, wc, wa = want
        for f in wt._fields:
            if not torch.equal(getattr(table, f), getattr(wt, f).cpu()):
                fail(f"{name}: table field {f} differs from the single-card "
                     "detector")
        if not (torch.equal(conf, wc.cpu()) and torch.equal(accepted,
                                                             wa.cpu())):
            fail(f"{name}: confidence/gates differ from the single-card "
                 "detector")

    # the spatially-sharded step over SP_RANKS ranks of the one card
    frames = scene.make_frames(SP_BATCH, H2, W2, seed=2)
    t0 = time.perf_counter()
    ranks = launch("chip_smoke:sp_rank", SP_RANKS, args=(frames, K),
                   device="cuda", timeout=600, sys_path=(REPO,))
    world_s = time.perf_counter() - t0
    want = det.run_device(frames)
    torch.cuda.synchronize()
    for r, res in enumerate(ranks):
        same(f"spatial step rank {r}",
             (res["table"], res["conf"], res["accepted"]), want)
    launches = {n: sum(r["launches"][n] for r in ranks)
                for n in ranks[0]["launches"]}
    rounds = {r["rounds"] for r in ranks}
    branches = {r["branch"] for r in ranks}
    if len(rounds) != 1 or len(branches) != 1:
        fail(f"ranks disagree on flood rounds {rounds} or branch "
             f"{branches}")
    missing = [n for n in ("flood_fill_sp", "band_ccl_sp",
                           "banded_stats_sp", "bbox_sums", "preprocess")
               if not launches[n]]
    if missing:
        fail(f"the multi-device path launched no {missing}: {launches}")
    step_ms = [max(r["step_ms"][i] for r in ranks)
               for i in range(SP_STEP_ITERS)]
    phase(f"multi-device path: make_tiled_spatial_step, {SP_BATCH}x{H2}x"
          f"{W2} BGR over a 1x{SP_RANKS} world on one card "
          f"({ranks[0]['backend']}, collectives staged through pinned host "
          f"buffers; shards {ranks[0]['shard']} on "
          f"{sorted({r['device'] for r in ranks})}): equal to the "
          f"single-card detector on every rank; flood rounds "
          f"{rounds.pop()}, root table branch {branches.pop()}; launched "
          f"{launches}; the world took {world_s:.1f} s")
    phase(f"{smi}: spatial step {SP_BATCH}x{H2}x{W2} over {SP_RANKS} ranks "
          f"of one card: {[round(t, 3) for t in step_ms]} ms a step "
          f"(slowest rank, host clock around the step and a sync)")

    # a 1-rank NCCL world through the data-parallel and line steps
    f640 = scene.make_frames(DP_BATCH_640, seed=0)
    f2 = frames[:DP_BATCH_2MP]
    (dp,) = launch("chip_smoke:dp_rank", 1, args=(f640, f2, K),
                   device="cuda", timeout=600, sys_path=(REPO,))
    want640 = det.run_device(f640)
    want2 = det.run_device(f2)
    same("pallas data-parallel step 640x480", dp["pallas_dp_640"], want640)
    same("tiled data-parallel step 2 MP", dp["tiled_dp_2mp"], want2)
    same("line step 640x480", dp["line_640"], want640)
    same("line step 2 MP", dp["line_2mp"], want2)
    for key, n in (("line_640", DP_BATCH_640), ("line_2mp", DP_BATCH_2MP)):
        stats = {k: int(v) for k, v in dp[key][3].items()}
        acc = dp[key][2]
        if stats != {"frames": n, "defects": int(acc.sum()),
                     "rejects": int((acc.any(-1) & (torch.where(
                         acc, dp[key][1], 0.0).max(-1).values >= 0.7))
                         .sum())}:
            fail(f"{key}: line totals {stats} do not match its tables")
    dp_launches = {n: v for n, v in dp["launches"].items() if v}
    if dp["backend"] != "nccl" or not dp_launches.get("fused_detect"):
        fail(f"the 1-rank world ran on {dp['backend']} with {dp_launches}")
    phase(f"multi-device path: a 1-rank {dp['backend']} world: the fused "
          f"and band-route data-parallel steps and the line step "
          f"({DP_BATCH_640}x640x480, {DP_BATCH_2MP}x{H2}x{W2} BGR) equal to "
          f"the single-card detector; launched {dp_launches}")
    figures = {"spatial_step_ms": step_ms, "ranks": SP_RANKS,
               "batch": SP_BATCH, "frame": f"{H2}x{W2} BGR",
               "backend": ranks[0]["backend"], "flood_rounds":
               ranks[0]["rounds"], "branch": ranks[0]["branch"],
               "world_s": world_s, "launches_1rank_world": dp_launches,
               "card": smi}
    return launches, figures, times, err


# The training path (phase 4h): the trainers at the models' default widths
# on what a line would train on (the classifier on 256 blob-sized patches,
# the segmenter and the autoencoder on 8 frames of 640x480: 560 tiles of
# 64x64 in batches of 64), the sharded train step over the spatial
# world's 4 ranks of the one card and a 1-rank NCCL world, and
# examples/model_training at its own sizes (48 frames of 128x96, 80
# steps).  Each step is held by tests/_torch_step_rule.py, the rule and
# tolerances of the CPU tests (tests/test_torch_training*.py).  The float32
# UNet is held against the same step in float64 on the CPU: at 8 x 640 x
# 480 a weight's gradient sums 2.46 M terms a channel pair, and the CPU's
# float32 gradient lies up to 1.5e-3 of a tensor's largest |g| from
# float64, the card's 2.5e-6 (a TF32 backward 1.2e-3, cuDNN's
# deterministic algorithms 1.5e-3), so only float64 tells float32's
# noise from a reduced-precision backward at the tests' 1e-5.
TRAIN_PATCHES = 256
TRAIN_FRAMES = 8
TRAIN_TIMED_STEPS = 5
TRAIN_RANKS = 4
TRAIN_LR = 1e-3


def train_inputs():
    """The classifier's batch: half random patches, half flat regions of
    five levels (tied maxima in the pools), and their labels."""
    import numpy as np
    rng = np.random.RandomState(13)
    half = TRAIN_PATCHES // 2
    levels = np.array([0, 40, 120, 200, 255], np.uint8)
    patches = np.concatenate([
        rng.randint(0, 256, (half, 32, 32, 1)).astype(np.uint8),
        levels[rng.randint(0, 5, (half, 32, 32, 1))]])
    return patches, rng.randint(0, 2, TRAIN_PATCHES)


def train_rank(patches, labels):
    """One rank of phase 4h's worlds: the sharded train step over every
    rank (1 x n), one step from seed 0, then TRAIN_TIMED_STEPS timed
    steps (host clock around a step and a sync, after a barrier)."""
    import torch
    import torch.distributed as dist
    from heimdall_tpu_torch.models import make_sharded_train_step
    from heimdall_tpu_torch.parallel.mesh import make_mesh

    train = make_sharded_train_step(make_mesh(data=1,
                                              spatial=dist.get_world_size()))
    device = next(train.state["params"].parameters()).device
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    loss = float(train(patches, labels))
    params = {k: v.detach().cpu().clone() for k, v in
              train.state["params"].state_dict().items()}
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        train(patches, labels)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": loss, "params": params, "step_ms": times,
            "device": str(device), "backend": dist.get_backend()}


def _grads(model):
    return {k: p.grad.detach().cpu().numpy().copy() for k, p in
            model.named_parameters()}


def _params(model):
    return {k: p.detach().cpu().numpy().copy() for k, p in
            model.named_parameters()}


def _step(loss, model):
    return {"loss": loss, "grads": _grads(model), "params": _params(model)}


def hold_step(name, ref, got, tols, loss_tol):
    """One train step on the card (got) against a reference step (ref),
    each {"loss", "grads" (or None), "params"}, by
    tests/_torch_step_rule.py; fails the run on a mismatch, else returns
    the figures."""
    import _torch_step_rule as rule
    try:
        return rule.hold_step(name, ref, got, tols, loss_tol, TRAIN_LR)
    except AssertionError as e:
        fail(f"{name}: {e}")


def trace_kernels(path):
    """The number of the card's kernels in a Chrome trace."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel")


def training_phases(dev, smi):
    """Phase 4h, the training path on the card: one step of each trainer
    at its default width (the classifier, width 32, on TRAIN_PATCHES
    patches; the UNet, base 16, on TRAIN_FRAMES ring frames of 640x480
    with their dark rings as masks; the autoencoder, width 16, on the
    first 64 of their tiles) against the same step on the CPU from the
    same parameters (the UNet's in float64), each timed in ms a step;
    AnomalyDetector.fit for one epoch on the card and the CPU; the sharded
    train step over a 1 x TRAIN_RANKS world on the one card (gloo,
    staged) and a 1-rank NCCL world, every rank's parameters bitwise equal
    and each world's step held against the card's ClassifierTrainer step;
    examples/model_training.main at its own sizes; and a
    ProfilingSession.trace of a UNet step after all of it.  Every
    wrapper's count is set to 0 just before and read just after, and no
    plain version may run on a CUDA tensor in between.  Returns ({wrapper:
    launches}, the phase's figures)."""
    import contextlib
    import io
    import math
    import tempfile
    import numpy as np
    import torch
    from heimdall_tpu_torch import scene
    from heimdall_tpu_torch.examples import model_training
    from heimdall_tpu_torch.models import (AnomalyDetector,
                                           ClassifierTrainer,
                                           DefectClassifier, DefectSegmenter)
    from heimdall_tpu_torch.models import segmentation
    from heimdall_tpu_torch.models.anomaly import _tile_frames
    from heimdall_tpu_torch.models.layers import float32_convs
    from heimdall_tpu_torch.parallel.launch import launch
    from heimdall_tpu_torch.perf.profiling import ProfilingSession
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import _torch_step_rule as rule

    wrappers = _sp_wrappers()
    # model_training's capture and classical detector run B1; its
    # segmentation detectors label with JAX's sweeps (PyTorch ops) and
    # launch no kernel of the repo's
    must = ("fused_detect",)
    figures = {"card": smi, "ms_a_step": {}, "held": {}}
    ms, held = figures["ms_a_step"], figures["held"]

    def timed(name, step):
        step()
        ms[name] = cuda_ms_only(lambda: None, step, TRAIN_TIMED_STEPS)

    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    plain_on_card = guard_plains()
    try:
        # -- the classifier ------------------------------------------------
        patches, labels = train_inputs()
        steps = {}
        for d in (dev, "cpu"):
            clf = DefectClassifier(seed=0, device=d)
            trainer = ClassifierTrainer(clf)
            steps[d] = _step(trainer.train_step(patches, labels), clf.model)
            if d == dev:
                timed("classifier", lambda: trainer.train_step(patches,
                                                               labels))
        clf_tols = rule.bf16_tols(steps["cpu"]["grads"], "Dense_1")
        held["classifier"] = hold_step("ClassifierTrainer", steps["cpu"],
                                       steps[dev], clf_tols,
                                       rule.BF16_LOSS_TOL)
        clf_card = steps[dev]

        # -- the segmenter: the card's float32 step against the CPU's in
        # float64 (and its loss against the CPU's float32 step) -----------
        frames = scene.ring_frames(TRAIN_FRAMES, 480, 640, seed=3)
        masks = frames[..., 1] < 60
        steps = {}
        for key, d, dtype in (("card", dev, torch.float32),
                              ("cpu_float64", "cpu", torch.float64),
                              ("cpu_float32", "cpu", torch.float32)):
            seg = DefectSegmenter(base=16, seed=0, device=d)
            seg.model.to(dtype)
            steps[key] = _step(seg.train_step(frames, masks), seg.model)
            if d == dev:
                card_seg = seg
                timed("segmenter", lambda: seg.train_step(frames, masks))
        f64 = steps["cpu_float64"]
        unet_tols = rule.f32_tols(f64["grads"])
        held["segmenter"] = hold_step("DefectSegmenter.train_step", f64,
                                      steps["card"], unet_tols,
                                      rule.F32_LOSS_TOL)
        cpu32 = steps["cpu_float32"]
        held["segmenter"]["loss_rel_err_cpu_float32"] = rel_loss = abs(
            steps["card"]["loss"] - cpu32["loss"]) / abs(cpu32["loss"])
        if rel_loss > rule.F32_LOSS_TOL:
            fail(f"DefectSegmenter.train_step: loss {steps['card']['loss']}"
                 f" on the card against {cpu32['loss']} on the CPU")
        held["segmenter"]["cpu_float32_max_grad_err"] = max(
            rule.grad_errors(f64["grads"], cpu32["grads"],
                             unet_tols).values())
        # the same step with cuDNN's TF32 allowed process-wide (PyTorch's
        # default; this script turns it off): the step must turn it off
        # through its backward, so it holds the float64 step as above;
        # beside it, for scale, a backward run in TF32 against the same
        # backward without it
        seg = DefectSegmenter(base=16, seed=0, device=dev)
        x, _ = segmentation._to_model_input(frames, dev)
        torch.backends.cudnn.allow_tf32 = True
        try:
            allowed = _step(seg.train_step(frames, masks), seg.model)
            seg.model.zero_grad()
            with float32_convs(dev):
                logits = seg.model(x)[:, 0]
            logits.pow(2).mean().backward()
            tf32 = _grads(seg.model)
            seg.model.zero_grad()
            with float32_convs(dev):
                seg.model(x)[:, 0].pow(2).mean().backward()
            plain = _grads(seg.model)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        held["segmenter"]["tf32_allowed"] = hold_step(
            "DefectSegmenter.train_step with TF32 allowed", f64, allowed,
            unet_tols, rule.F32_LOSS_TOL)["max_grad_err"]
        held["segmenter"]["tf32_backward_rel_err"] = max(
            rule.grad_errors(plain, tf32, unet_tols).values())

        # -- the autoencoder: one step, then a fit of one epoch ---------------
        gray = np.ascontiguousarray(frames[..., 1])
        tiles = _tile_frames(gray)[:64]
        steps, fits = {}, {}
        for d in (dev, "cpu"):
            ae = AnomalyDetector(seed=0, device=d)
            steps[d] = _step(float(ae._train_step(tiles)), ae.model)
            fit = AnomalyDetector(seed=0, device=d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[d] = (fit.fit(gray, epochs=1), fit.threshold)
            torch.cuda.synchronize()
            if d == dev:
                figures["fit_s"] = time.perf_counter() - t0
                timed("autoencoder", lambda: ae._train_step(tiles))
        held["autoencoder"] = hold_step(
            "AnomalyDetector step", steps["cpu"], steps[dev],
            rule.bf16_tols(steps["cpu"]["grads"], "ConvTranspose_2"),
            rule.BF16_LOSS_TOL)
        n_tiles = len(_tile_frames(gray))
        if not all(abs(a - b) <= rule.FIT_TOL * abs(b)
                   for a, b in zip(fits[dev], fits["cpu"])):
            fail(f"AnomalyDetector.fit: loss and threshold {fits[dev]} on "
                 f"the card against {fits['cpu']} on the CPU")
        held["fit"] = {"tiles": n_tiles, "loss": fits[dev][0],
                       "threshold": fits[dev][1], "cpu": fits["cpu"]}
        phase(f"training path: one step each, card against CPU: classifier"
              f" {held['classifier']}; UNet (against float64) "
              f"{held['segmenter']}; autoencoder {held['autoencoder']}; fit"
              f" of 1 epoch on {n_tiles} tiles: loss and threshold "
              f"{fits[dev]} against {fits['cpu']}; {smi}: " + ", ".join(
                  f"{k} {v:.3f} ms a step" for k, v in ms.items())
              + f"; the fit {figures['fit_s']:.3f} s")

        # -- the sharded train step in both worlds ------------------------
        figures["sharded"] = {}
        for ranks in (TRAIN_RANKS, 1):
            out = launch("chip_smoke:train_rank", ranks,
                         args=(patches, labels), device="cuda", timeout=600,
                         sys_path=(REPO,))
            for r in out:
                same = r["loss"] == out[0]["loss"] and all(
                    torch.equal(v, out[0]["params"][k])
                    for k, v in r["params"].items())
                if not same or not r["device"].startswith("cuda"):
                    fail(f"sharded train step, {ranks} ranks: the ranks' "
                         f"parameters differ or ran on {r['device']}")
            got = {"loss": out[0]["loss"], "grads": None,
                   "params": {k: v.numpy()
                              for k, v in out[0]["params"].items()}}
            step_ms = [max(r["step_ms"][i] for r in out)
                       for i in range(TRAIN_TIMED_STEPS)]
            key = f"{ranks}_ranks_{out[0]['backend']}"
            figures["sharded"][key] = dict(
                hold_step(f"sharded train step ({key})", clf_card, got,
                          clf_tols, rule.BF16_LOSS_TOL), step_ms=step_ms)
            phase(f"training path: make_sharded_train_step over {ranks} "
                  f"rank(s) of one card ({out[0]['backend']}): every rank's "
                  f"parameters bitwise equal, within tolerance of one "
                  f"ClassifierTrainer step on the whole batch; {smi}: "
                  f"{[round(t, 3) for t in step_ms]} ms a step (slowest "
                  f"rank, host clock around the step and a sync)")

        # -- examples/model_training at its own sizes ----------------------
        with tempfile.TemporaryDirectory() as tmp:
            real_tmp = tempfile.tempdir
            tempfile.tempdir = tmp
            text = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(text):
                    run = model_training.main(["--device", "cuda"])
            finally:
                tempfile.tempdir = real_tmp
            figures["model_training_s"] = time.perf_counter() - t0
        for line in text.getvalue().splitlines():
            phase(f"  model_training | {line}")
        if (len(run["losses"]) != 80
                or not all(map(math.isfinite, run["losses"]))):
            fail(f"examples/model_training: losses {run['losses']}")
        figures["model_training"] = dict(
            run, losses={0: run["losses"][0], 79: run["losses"][-1]})

        # -- a trace after training: ProfilingSession.trace of a UNet step
        # in this process, which has trained on the card ----------------------
        session = ProfilingSession("training_trace", device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            try:
                with session.trace(tmp):
                    card_seg.train_step(frames, masks)
                kernels = trace_kernels(session.trace_path)
                figures["trace_after_training"] = {"kernels": kernels}
                phase(f"training path: ProfilingSession.trace of a UNet step "
                      f"after training listed {kernels} CUDA kernels at its "
                      f"first try")
            except RuntimeError as e:
                figures["trace_after_training"] = {"raised": str(e)}
                phase(f"training path: ProfilingSession.trace of a UNet step "
                      f"after training raised at its first and only try: "
                      f"{e}")
    finally:
        guard_plains.restore()
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    phase(f"training path launched {launches}; model_training took "
          f"{figures['model_training_s']:.1f} s")
    if plain_on_card:
        fail(f"plain versions ran on the card: {sorted(set(plain_on_card))}")
    if not all(launches.get(n) for n in must):
        fail(f"the training path's example did not go through every kernel "
             f"of its path {must}: {launches}")
    return launches, figures


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    from heimdall_tpu_torch import ContaminationDetector, scene
    from heimdall_tpu_torch.ops import _cuda
    from heimdall_tpu_torch.ops.fused_kernels import (
        contamination_fused, contamination_fused_reference)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. environment ----------------------------------------------------
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    phase(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc "
          f"{nvcc.strip().splitlines()[-1]} devices "
          f"{torch.cuda.device_count()}")
    phase(smi)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _cuda.build()
    phase(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    # -- 3. kernels against their plain versions ----------------------------
    bench_nhwc = scene.make_frames(8, seed=0)
    masks = scene.adversarial_masks(480, 640, seed=1)
    adv = scene.mask_frames(list(masks.values()))

    def cm(x):
        return torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dev)

    adv_name = "adversarial_" + "_".join(masks)
    cases = {    # name: (frames, channel_major, K)
        "bench8_channel_major": (cm(bench_nhwc), True, K),
        "bench8_nhwc": (torch.from_numpy(bench_nhwc).to(dev), False, K),
        "bench8_mono8": (torch.from_numpy(
            np.ascontiguousarray(bench_nhwc[..., 1])).to(dev), False, K),
        "bench8_mono8_planes": (cm(bench_nhwc[..., 1:2]), True, K),
        adv_name: (cm(adv), True, K),
        adv_name + "_k4": (cm(adv), True, 4),
        "bench2_477x631": (cm(scene.make_frames(2, 477, 631, seed=5)), True,
                           K),
    }
    max_err = 0
    for name, (x, chm, k) in cases.items():
        got = contamination_fused(x, CONTRAST, k, chm, return_labels=True)
        torch.cuda.synchronize()
        want = contamination_fused_reference(x, CONTRAST, k, chm,
                                             return_labels=True)
        torch.cuda.synchronize()
        errs = [int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(got, want)]
        max_err = max(max_err, *errs)
        phase(f"check {name}: n_blobs {got[3].tolist()} max_abs_err "
              f"sums/bbox/bgsum/n/labels {errs}")
        if any(errs):
            fail(f"fused_detect differs from its plain version on {name}")
    max_err = max(max_err, check_fused_tile_cases(dev))
    n_first = contamination_fused(cases["bench8_channel_major"][0][:2],
                                  CONTRAST, K, True)[3].tolist()
    if n_first != [9, 10]:
        fail(f"bench frames 0-1 give n_blobs {n_first}; the JAX reference "
             "gives [9, 10]")

    # -- 4. the main path --------------------------------------------------
    frames_nhwc = scene.make_frames(BATCH, seed=0)
    x = cm(frames_nhwc)
    det = ContaminationDetector(config={"include_contours": False})
    det_c = ContaminationDetector(config={"include_contours": True})
    torch.cuda.synchronize()
    contamination_fused.launches = 0
    table, conf, accepted = det.run_device(x, channel_major=True)
    reject, max_conf = det.verdict_device(x, channel_major=True)
    defects = det_c.detect_batch(frames_nhwc[:4])
    torch.cuda.synchronize()
    launches = contamination_fused.launches
    phase(f"main path: run_device + verdict_device + detect_batch launched "
          f"fused_detect {launches} times")
    if launches < 3:
        fail("the main path did not go through the fused kernel")
    if (table.area.shape != (BATCH, K) or conf.shape != (BATCH, K)
            or not bool(torch.isfinite(conf).all())
            or not bool(torch.isfinite(table.area).all())):
        fail("main path outputs have the wrong shape or are not finite")
    cpu = ContaminationDetector(config={"include_contours": False},
                                device="cpu")
    t_cpu, c_cpu, a_cpu = cpu.run_device(frames_nhwc[:8])
    for f in table._fields:
        if not torch.equal(getattr(table, f)[:8].cpu(), getattr(t_cpu, f)):
            fail(f"main path table field {f} differs from the CPU path")
    if not (torch.equal(conf[:8].cpu(), c_cpu)
            and torch.equal(accepted[:8].cpu(), a_cpu)):
        fail("main path confidence/gates differ from the CPU path")
    if not all(d and all("contour" in e.metadata for e in d) for d in defects):
        fail("detect_batch with contours returned no contoured defects")
    phase(f"main path: n_blobs[:8] {table.n_blobs[:8].tolist()} "
          f"rejects {int(reject.sum())}/{BATCH} "
          f"max conf {float(max_conf.max()):.6f} "
          f"defects/frame (contours) {[len(d) for d in defects]}; "
          f"first 8 frames equal to the CPU path")

    # -- 5. times ------------------------------------------------------------
    def kernel():
        contamination_fused(x, CONTRAST, K, True)

    def plain():
        contamination_fused_reference(x, CONTRAST, K, True)

    def e2e():
        det.run_device(x, channel_major=True)

    for _ in range(3):
        kernel()
    kern_ms = cuda_ms(kernel, 20)
    plain()
    plain_ms = cuda_ms(plain, 2)
    e2e()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        det.run_device(x, channel_major=True)
    torch.cuda.synchronize()
    e2e_s = (time.perf_counter() - t0) / 20
    e2e_host = host_ms(e2e)
    # the CUDA kernels of one fused detect call, from a trace of it
    fused_kernels = cuda_kernels(kernel)
    launches_per_call = sum(fused_kernels.values())
    if (fused_kernels != dict.fromkeys(FUSED_KERNELS, 1)
            or launches_per_call != _cuda.library(
                "fused_detect").hd_fused_detect_launches(480, 640)):
        fail(f"fused_detect launched {fused_kernels}, not one each of "
             f"{FUSED_KERNELS}")
    in_bytes = x.numel()
    out_bytes = BATCH * (8 + 4 + 4) * K * 4 + BATCH * 4
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = mean_ops_ms(BATCH * 480 * 640)
    bound_ms = max(bytes_ms, ops_ms)
    phase(f"{smi}: fused_detect {kern_ms:.4f} ms per batch of {BATCH} "
          f"({kern_ms / BATCH * 1e3:.3f} us/frame, {launches_per_call} "
          f"CUDA launches per call); plain version {plain_ms:.2f} ms "
          f"({plain_ms / BATCH * 1e3:.1f} us/frame); bound {bound_ms:.4f} ms "
          f"({bound_ms / BATCH * 1e3:.3f} us/frame); main path end to end "
          f"{e2e_s * 1e3:.3f} ms = {BATCH / e2e_s:.1f} frames/s; host time "
          f"per run_device call (returned, before the sync) "
          f"{e2e_host:.3f} ms")

    if "--profile" in argv:
        out_dir = argv[argv.index("--profile") + 1]
        os.makedirs(out_dir, exist_ok=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                e2e()
            torch.cuda.synchronize()
        text = prof.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=40)
        with open(os.path.join(out_dir, "fused_detect_profile.txt"),
                  "w") as fh:
            fh.write(f"{smi}\n5 x run_device, batch {BATCH}\n{text}\n")
        phase(f"profile: {out_dir}/fused_detect_profile.txt")

    # -- 3b-5 for the band-tiled 2 MP route --------------------------------
    err2, launches2, times2, e2e2 = tiled_phases(dev, smi, argv)

    # -- 3c-5 for the run-table 2 MP route ---------------------------------
    err3, launches3, times3, e2e3 = runtable_phases(dev, smi, argv)

    # -- 4d: the system path -------------------------------------------------
    launches4, traced4, traced4_640, times4 = system_phases(dev, smi)

    # -- 4e: the line path ---------------------------------------------------
    launches4e, line = line_phases(dev, smi)

    # -- 4f: the serving path --------------------------------------------------
    launches4f, serving = serving_phases(dev, smi)

    # -- 4g: the multi-device path ---------------------------------------------
    launches4g, multi, times4g, err4g = parallel_phases(dev, smi)


    # -- 3d, 5d: the split kernels and the profiling path --------------------
    split, t_roll, roll_launches = split_phases(dev, smi, cases)

    # -- 3e, 5e: the preprocess and hole-fill probes -------------------------
    probes = probe_phases(dev, smi, cases, t_roll, roll_launches)

    # -- 3f, 5f: the labeling probes ----------------------------------------
    labeling = label_probe_phases(dev, smi, cases)

    # -- 3g, 5g: the primitive microbench ----------------------------------
    primitives = primitive_phases(dev, smi)

    # -- 4h: the training path, then 5d's trace once more ------------------
    launches4h, training = training_phases(dev, smi)
    with tempfile.TemporaryDirectory(dir=REPO) as out_dir:
        training["split_trace_after_4h"] = split_trace(
            dev, cases["bench8_channel_major"][0], out_dir,
            "after the training path (4h)")

    # -- 6. kernels lines -----------------------------------------------------
    csrc = "heimdall_tpu_torch/csrc/"
    tiled = {    # name: (source, the TPU kernel or XLA code it replaces)
        "band_ccl": ("ccl_tiled.cu", "heimdall_tpu/ops/ccl_tiled.py:68"),
        "flood_fill": ("ccl_tiled.cu", "heimdall_tpu/ops/ccl_tiled.py:837"),
        "banded_stats": ("stats_tiled.cu",
                         "heimdall_tpu/ops/stats_tiled.py:89"),
        "bbox_sums": ("stats_tiled.cu",
                      "heimdall_tpu/ops/stats_tiled.py:200"),
        # XLA work of the JAX package (no Pallas kernel), on the same path
        "merge_bands": ("ccl_tiled.cu", "heimdall_tpu/ops/ccl_tiled.py:653"),
        "preprocess": ("fused_detect.cu",
                       "heimdall_tpu/detectors/contamination_detector.py:151"),
    }
    runtable = {    # the run-table route of BGR frames
        # hd_preprocess (most of its time), then hd_run_extract
        "preprocess_tiled": (("fused_detect.cu", "runtable_tiled.cu"),
                             "heimdall_tpu/ops/preprocess_tiled.py:82"),
        "run_extract": ("runtable_tiled.cu",
                        "heimdall_tpu/ops/runtable_tiled.py:59"),
        "flood_fix": ("runtable_tiled.cu",
                      "heimdall_tpu/ops/runtable_tiled.py:120"),
        "fill_extract": ("runtable_tiled.cu",
                         "heimdall_tpu/ops/runtable_tiled.py:80"),
        "label_fix": ("runtable_tiled.cu",
                      "heimdall_tpu/ops/runtable_tiled.py:148"),
        "writeback": ("runtable_tiled.cu",
                      "heimdall_tpu/ops/runtable_tiled.py:103"),
    }

    def entry(name):
        if name in runtable:
            (src, replaces), t = runtable[name], times3[name]
            err, n, frame = err3, launches3[name], "1920x1080 BGR"
        else:
            (src, replaces), t = tiled[name], times2[name]
            err, n, frame = err2, launches2[name], "1920x1080 Mono8"
        srcs = [csrc + f for f in ((src,) if isinstance(src, str) else src)]
        out = {"name": name, "route": "cuda", "source": srcs[0],
               "sources": srcs,
               "replaces": replaces, "equal": err == 0,
               "launches": n, "max_abs_err": err,
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": None,
               "library_note": "no single PyTorch call computes it",
               "batch": TIME_BATCH_2MP, "frame": frame}
        for key in ("ms_batch_128", "bound_ms_batch_128", "cuda_kernels",
                    "inputs_batch_128", "launch_floor_ms"):
            if key in t:
                out[key] = t[key]
        return out

    kernels = [{
        "name": "fused_detect",
        "route": "cuda",
        "source": "heimdall_tpu_torch/csrc/fused_detect.cu",
        "replaces": "heimdall_tpu/ops/pallas_kernels.py:1081",
        "equal": max_err == 0,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes it",
        "batch": BATCH, "frame": "640x480x3",
        "cuda_launches_per_call": launches_per_call,
        "cuda_kernels": fused_kernels,
        "sources": [csrc + "fused_detect.cu", csrc + "tile_uf.cuh"],
        "design": "one-pass preprocess, tile fill and tile labels over "
                  "32x128 shared-memory tiles (tile_uf.cuh), stats",
    }] + [entry(n) for n in ("band_ccl", "flood_fill", "banded_stats",
                             "bbox_sums", *runtable)] + split + probes + \
        labeling + primitives
    band_kernels = times2["band_ccl"].pop("cuda_kernels")
    band_entry = next(k for k in kernels if k["name"] == "band_ccl")
    band_entry.update(
        sources=[csrc + "ccl_tiled.cu", csrc + "tile_uf.cuh"],
        cuda_launches_per_call=sum(band_kernels.values()),
        cuda_kernels=band_kernels,
        design="foreground tile labeling over 32x128 shared-memory tiles "
               "(tile_uf.cuh): labels written once, edges merged in the "
               "label plane, root tables from each band's first root")
    path_kernels = [entry("merge_bands"), entry("preprocess")]
    # the shard entries of the multi-device path (phase 4g)
    sp_entries = {
        "flood_fill_sp": ("ccl_tiled.cu",
                          "heimdall_tpu/parallel/tiled_sp.py:127"),
        "band_ccl_sp": ("ccl_tiled.cu", "heimdall_tpu/ops/ccl_tiled.py:268 "
                        "(called at heimdall_tpu/parallel/tiled_sp.py:214)"),
        "banded_stats_sp": ("stats_tiled.cu",
                            "heimdall_tpu/parallel/tiled_sp.py:352"),
    }
    for name, (src, replaces) in sp_entries.items():
        t = times4g[name]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "sources": [csrc + src] + ([csrc + "tile_uf.cuh"]
                                       if src == "ccl_tiled.cu" else []),
            "replaces": replaces, "equal": err4g == 0,
            "launches": launches4g[name], "max_abs_err": err4g,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes it",
            "batch": SP_BATCH, "frame": "a shard of 270x1920 of 1920x1080",
            "launches_path": "multi-device path (phase 4g, 4 ranks)"})
        if name == "flood_fill_sp":
            kernels[-1].update(
                design="one launch on a cluster of 16 blocks a frame-shard: "
                       "the shard as bits in shared memory, bit-parallel row "
                       "and column passes, edge rows traded in the cluster",
                kernels_us=t["kernels_us"],
                b5b_same_masks_ms=t["b5b_same_masks"]["ms"],
                b5b_whole_frames_ms=t["b5b_whole_frames"]["ms"])
    # the system path's launches (phase 4d): wrapper calls, and the CUDA
    # kernels traced in one 2 MP inspect_batch and one bottle_base call
    for k in kernels + path_kernels:
        if k["name"] in launches4:
            k["launches_system_path"] = launches4[k["name"]]
    for k in kernels:
        if k["name"] == "fused_detect":
            k["cuda_kernels_system_path_640x480"] = traced4_640
    # the line path's launches (phase 4e) and the serving path's (phase
    # 4f); 0 for kernels off that path
    for k in kernels + path_kernels:
        k["launches_line_path"] = launches4e.get(k["name"], 0)
        k["launches_serving_path"] = launches4f.get(k["name"], 0)
        k["launches_multi_device_path"] = launches4g.get(k["name"], 0)
        k["launches_multi_device_1rank_world"] = multi[
            "launches_1rank_world"].get(k["name"], 0)
        k["launches_training_path"] = launches4h.get(k["name"], 0)
    print(json.dumps({"path_kernels": path_kernels}), flush=True)
    print(json.dumps({"system_path": dict(
        times4, cuda_kernels_2mp=traced4, cuda_kernels_640x480=traced4_640,
        launches=launches4)}), flush=True)
    print(json.dumps({"line_path": dict(line, launches=launches4e)}),
          flush=True)
    print(json.dumps({"serving_path": dict(serving, launches=launches4f)}),
          flush=True)
    print(json.dumps({"multi_device_path": dict(
        multi, launches=launches4g, entries=times4g)}), flush=True)
    print(json.dumps({"training_path": dict(training, launches=launches4h)}),
          flush=True)
    print(json.dumps({"end_to_end": dict(
        {"640x480x3": {"ms": e2e_s * 1e3, "host_ms": e2e_host}}, **e2e2,
        **e2e3), "batch": {"640x480x3": BATCH, "2mp": BATCH_2MP},
        "card": smi}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
