#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--report details.json]

Builds the port's CUDA kernels from `dsp_slam_rgbd_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card, drives the main
path (batched object reconstruction at the full cars_64 decoder width,
with the committed fixture decoder) and checks its output, times each
kernel at the main path's shapes, then drives the per-frame tracking path
and the keyframe stage at KITTI size (phases 8 and 9a), bundle
adjustment at KITTI-00 scale (phases 9b and 9c), and the keyframe
`MappingStage` with its object stage, where the f32 kernels run inside
the SLAM loop (phase 10), the mono object pipeline (10c), monocular
initialization and loop closing (phase 11), the system loop and its
command line (phase 12), the scale-out tier and active mapping
(phase 13), the benches and aux tools (phase 14), whether every
decoder kernel repeats bit for bit inside the loop (phase 15), and a loop
closing at KITTI size with objects through the command line (phase 16), and
the fixed-order scatter-add against the CPU's `index_add_` at the scatters
those phases made (phase 17).  Exits non-zero, with no result line, if there
is no card or any phase fails.
Prints, before the last line, the card's name and power limit and one
JSON line of kernel numbers; the last line is {"ok": true, "device":
{...}}.  With --report, every measured number also goes to that JSON
file.

Phase 2 also counts the tensor-core (HGMMA) instructions in the SASS of
both bf16 kernels (value and Jacobian) and fails if there are none or if
either spills to local memory, and prints the f32 kernels' figures
(`mlp_sdf_f32_config`: shared memory, registers, local bytes, ring slots,
resident clusters, for each tiling: rows of a tile and CTAs of a cluster)
and fails if any spills; phase 3 also holds each kernel to its plain
version at ragged row counts up to past the main path's sizes, for
shared, per-row and per-object codes, at random weights (where a fault of
summation order would show): the f32 kernels at F32_ROWS with the tiling
the launcher picks, and at 1, 33 and 2,049 rows with each tiling forced.

Tolerances (kernel vs plain version, same inputs, on the card):
  * f32: sdf atol 2e-5; Jacobian atol 2e-4 on rows whose ReLU
    pre-activations all keep |pre| >= 1e-6 (nearer 0 another summation
    order may take the other mask; at most 10% of rows are left out, a
    share checked where a case has >= 100 rows);
  * bf16 vs plain bf16: sdf atol 1e-2, Jacobian Frobenius relative 2e-2
    (same rounding points, f32 sums in another order can flip a bf16
    rounding).  The bf16 Jacobian kernel also reports the ReLU masks it
    took (`masks_out`).  A change of summation order moves later
    pre-activations by a few 1e-3 through each layer's bf16 rounding, and
    a unit that near 0 takes the other side: at random weights about one
    unit in ten rows, which alone moves the whole Jacobian by 1-2.5%
    (tests/test_torch_jacobian_tiles.py shows it on the CPU with a model
    of the tensor cores' accumulation).  So the kernel is held to: its
    masks equal the plain version's at every unit with |pre| >= 1e-2
    (BF16_TIE), and differ at no more than 8 + n/5 units over n rows;
    the plain reverse sweep under its masks within 2e-2; and the plain
    version with its own masks within 2e-2 on the rows where no mask
    differs.  Each case also reports the largest |pre| of a unit whose
    masks differ, the error against the plain version's own masks over
    all rows, and the distance of kernel and plain version from the
    plain version with every product summed in f64 and rounded once;
  * bf16 vs f32: Jacobian row cosine >= 0.90, Frobenius relative <= 0.25;
  * one f32 GN iteration, kernels on the card vs plain versions on the
    CPU: pose and code atol 2e-3.

Phase 8 drives the per-frame tracking path, and phase 9 the keyframe
stage and bundle adjustment (torch ops on the card; they launch no
kernel of the port), at KITTI size: 1241x376 uint8 images, fx = fy =
718.856, baseline 0.537 m, `OrbConfig()` (2,000 features, 8 levels),
`MapConfig(max_kf=48, max_feat=2048, max_pts=32768, local_window=8)`,
`TrackingConfig(th_depth=35, max_frames_between_kf=5)`, the tilted-plane
world of `tools/bench_pipeline.py`
(`dsp_slam_rgbd_tpu_torch/tools/plane_world.py`):
  * 8a: `extract_pair` and `match_stereo` of one pair on the card and on
    the CPU: keypoints equal on >= 99% of each image, descriptors equal at
    every common keypoint, >= 100 common stereo matches with depths within
    1e-3 relative;
  * 8b / 8c: 24 stereo and 12 RGB-D frames with the full keyframe stage
    (`drive_tracking`: `kf_point_stage`, then `local_ba_and_cull_step`):
    >= 90% of frames OK, >= 2 keyframes, finite poses, at least one
    keyframe culled in the stereo run, and a largest translation error
    under STEREO_BAND / RGBD_BAND, 1.5x the JAX package's own on the same
    driver and world on the CPU (0.110393 m and 0.184753 m with 10 and 6
    keyframes, the stereo run culling slots 2 and 1; with the keyframe
    bootstrap alone, 3.403762 m and 0.184759 m:
    `JAX_PLATFORMS=cpu python tests/tracking_driver.py`); median ms per
    frame and per keyframe stage;
  * then per-frame times (ORB extraction, stereo match, the fused tracking
    stage, pose GN), host syncs of one frame
    (`torch.cuda.set_sync_debug_mode`), and launches, busy time and idle
    share of one traced frame, on the frames after 8b's;
  * 9a: one more keyframe stage on 8b's map: host syncs of the stage,
    launches, busy time and idle share of each half, the BA window's size;
  * 9b: BA on the KITTI-00-scale corridor map (`tools/corridor_map.py`:
    1,000 keyframes, 200,000 points), tests/test_ba_scale.py's criteria:
    local BA at keyframes 10, 500 and 990 with B <= 64 and the mean
    reprojection error cut below 0.7x; one `global_ba_pcg(n_iters=6)`
    with B >= 1,000, every live observation (> 150,000) in the problem, a
    finite result and the error cut below 0.5x; ms and launches of each;
  * 9c: the card against the CPU on the same problems: one LM step of each
    local problem within 1e-4 (poses and points), and on the 24-keyframe
    corridor the dense and PCG solvers each within 0.03 m of the truth
    and within 5e-3 of each other on both, card and CPU within 5e-3.

Phase 10 drives the port's `MappingStage.process` (point stage, object
stage, local BA + culling, no loop closing) at every keyframe of 24
stereo frames of the same KITTI-size world, with 8 objects of the fixture
decoder's ellipsoid family (`tools/object_world.py::kitti_objects`: 7
static ones 7-14 m ahead and a mover at 0.4 m a frame), 256 points and
512 rays a detection, `ReconConfig()` (f32, as the system runs it) and
`MapConfig(max_obj=8, max_oobs=256)`.  It fails unless: >= 90% of frames
OK and the largest translation error under OBJECTS_BAND (1.5x the JAX
package's 0.110393 m on the same run, `tests/tracking_driver.py`); all 8
objects valid at the end, each slot keeping its nearest truth from
creation on; every static center within 0.3 m of its truth
(tests/test_multi_object.py's criterion) and none dynamic, the mover
dynamic; the BA windows carry object edges; both f32 kernels
(`csrc/mlp_sdf_f32.cu`) launched inside the loop.  It prints per keyframe the
ms and kernel launches of association, refinement, new-object
reconstruction (with the batched `sdf_bbox`) and insertion and of the
whole `process`, then runs one keyframe again from its saved state for
its host syncs, launches, busy time and idle share, and the card against
the CPU on that keyframe's object stage: refined poses within 1e-3 m and
1e-3 rad, one f32 GN iteration of the new objects within 2e-3 (phase 5's
tolerance).  Then it times both f32 kernels at this phase's row counts
against their plain versions, f32 `torch.matmul` (TF32 off) and their
bound (bytes over the memory rate, FLOPs over 67 TFLOP/s, the data
sheet's f32 rate outside the tensor cores), with the tiling (rows of a
tile, CTAs of a cluster) the launcher picks and with each tiling forced,
and the rate at which their CTAs stream the weights from L2.  10c runs the mono object
pipeline over tests/test_mono_objects.py's 21-keyframe hand-built map
(an ellipsoid of the fixture family) on the card and on the CPU: the
object recovered, and the card held to the CPU up to the 180° turn
about the object's y axis that the PCA cuboid's eigenvector sign allows
(1e-3 through the first fit, 0.05 m after the second: `mono_phase`).

Phase 11 drives monocular initialization and loop closing (torch ops on
the card; they launch no kernel of the port), through
tests/tracking_driver.py's "mono", "loop" and "reloc" stages:
  * 11a: 14 monocular frames of `tools/plane_world.py`'s KITTI_FLOOR
    (phase 8's KITTI-size wall on a floor 1.65 m below the camera, 0.54 m
    a frame: tests/test_mono_e2e.py's parallax ratio), phase 8's
    configuration with OrbConfig()'s 2,000 features: the tracker's H/F
    initialization, `SLAMSystem._insert_mono_init` (through the driver), then
    `MappingStage.process` at every keyframe: initialized, >= 60% of frames
    OK, >= 2 keyframes, Sim(3)-aligned ATE under 8% of the path (the JAX
    test's bars); ms of the initialization step and of its RANSAC alone,
    ms per frame, host syncs with the line that makes each.  Then the same
    14 frames of the bare KITTI plane (`plane_world.KITTI`, no floor),
    held to the JAX package's outcome there (JAX_MONO_PLANE: it never
    initializes, so the port must not either, and must raise nothing;
    had it initialized, the port would have to within 2 frames, with an
    ATE within 1.5x).
  * a vocabulary of 10^4 words (branching 10, depth 4) trained here on
    110,000 descriptors as tests/test_vocab_scale.py makes them;
  * 11b: phase 8's 24 stereo frames with `MappingStage(vocab=...)` at every
    keyframe: no loop closure on a path without a revisit, the culled
    keyframes purged from the database, phase 8's bands; ms of
    `_update_bow` and `_loop_stage` per keyframe, launches, host syncs;
  * 11c: tests/test_loop_integration.py's revisit map built at phase 8's
    capacity (`tools/revisit_map.py`: 48 / 2,048 / 32,768 slots, 2,000
    points a side, KITTI intrinsics) through `_loop_stage` until the loop
    closes: >= 1 closure, 0 < the global-BA budget left < 10 and drained in
    <= 10 slices, KF7's error against KF0 below 0.6x its value before (the
    test's bars), and the card against the port on the CPU with the same
    CPU-drawn RANSAC samples: equal closures and fused points, keyframe
    poses within 1e-3; ms of `compute_loop_sim3`, `correct_loop`,
    `fuse_duplicate_points` and the first global-BA slice, syncs, and the
    seconds of each of its runs; the whole sequence's launches (this
    thread's, from a trace of the card's activity only, as phase 16
    counts them) are traced after phase 16 and printed there;
  * 11d: retrieval at KITTI-00 capacity (tests/test_loop_scale.py's map:
    2,048 keyframe slots / 1,200 live, 300,000 point slots / 150,000
    live, 1,024 words): the packed candidate matrix's shape, one host read
    per query, ms of `_loop_candidates_device` and of
    `detect_reloc_candidates_grouped` (mean of 3 queries);
  * 11e: tests/test_reloc_e2e.py's sequence on phase 8's stereo world (6
    frames, 2 blank frames, back at frame 2's viewpoint) with the
    tracker's candidates from `SLAMSystem._reloc_candidates`: LOST in
    the blackout, recovered with BoW candidates within 0.08 m.

Phase 12 drives the system loop (`system/slam.py::SLAMSystem`: the mapping
worker on its own CUDA stream, adoption after `async_kf_frames`, the
`FramePrefetcher`) through the command line,
`dsp_slam_rgbd_tpu_torch/tools/run_slam.py::main`, called in-process (the
smoke wraps `SLAMSystem.track_frame` and `MappingStage.process` to time
frames and jobs; `system_overrides` sets `async_kf_frames` or `pipelined`):
  * 12a: phase 10's world written as a KITTI directory
    (`tools/sequence_dirs.py::write_kitti_objects`: 24 frames of 1241x376
    uint8 pairs through the port's PNG codec, calib.txt with KITTI 00-02's
    P2 and Tr, a label npz a frame with the 8 objects, gt.txt, a yaml of
    phase 10's tracking configuration: 2,000 ORB features, ThDepth 35, 5
    frames at most between keyframes), run with the fixture decoder,
    `--labels`, `--bootstrap-vocab 24 --vocab-depth 4` and `--gt`.  The
    map is the command line's: 2,048 feature slots a keyframe for the
    yaml's 2,000 features (`run_slam.feature_slots`, as phase 10), and
    `MapConfig()`'s other capacities (local window 10 keyframes where
    phase 10 has 8; 128 keyframes, 16,384 points, 16 objects and 512
    object observations where it has 48, 32,768, 8 and 256, none of them
    reached).  It fails unless every frame has a row in
    CameraTrajectory.txt (12 floats), the ATE (rigid alignment) is within
    CLI_BAND and the largest translation error within CLI_ERR_BAND, 1.5x
    the JAX package's command line's own over the same directory and
    configuration on the CPU (`tests/tracking_driver.py cli`), each of the
    7 static objects has its own MapObjects.txt entry within 0.3 m of its
    truth, summary.json shows no keyframe dropped and no loop closed, and
    both f32 kernels launched.  It prints fps, tracking ms p50/p90/p99,
    the median ms of tracking-only frames with the worker idle and with a
    keyframe job in flight and of keyframe frames, the ms the main thread
    blocked in `_adopt` and `_prewait_mapping`, and one frame traced with
    a job in flight: busy ms, its idle share of the traced wall and of the
    untraced in-flight frames' median wall, each stream's kernels and busy
    ms (marker kernels traced before the first frame tell the tracker's
    and the worker's streams apart) and the ms in which the tracker's and
    the worker's kernels ran at once.  The frames traced are those that
    start while the worker is inside a job, from its second asynchronous
    job on (the first runs on a thread just started), until one shows the
    worker's kernels: a frame whose trace holds none is printed as a miss,
    and the phase fails if every such frame misses.  The segment-sum
    kernel must have launched in that run.  Then the same command line
    again at `async_kf_frames` 3, untraced, loading the vocabulary the
    first run saved: its CameraTrajectory.txt and MapObjects.txt must be
    the first run's byte for byte.  Then the same run at
    `async_kf_frames=0` (every keyframe stage inline), held to the same
    checks, and its fps beside the first.  Each run starts from empty BA
    capacity buckets, as a new process does;
  * 12b: phase 8c's 12 RGB-D frames as rgb/ + 16-bit depth/ PNGs, run
    with the synchronous and with the pipelined tracker (the stats read
    through a pinned copy and its event, frames finalized one call late),
    and phase 11a's 14 KITTI_FLOOR frames as an image directory
    (`SLAMSystem._insert_mono_init` inside the system), each with its
    phase's tracking configuration and the command line's map, held to
    that phase's bars: RGB-D >= 90% of frames, >= 2 keyframes, largest x
    error under RGBD_BAND; mono >= 60% of frames, >= 2 keyframes,
    Sim(3)-aligned ATE under 8% of the path.  Each RGB-D run is also held
    to the JAX command line's run of the same mode on the CPU (JAX_RGBD,
    `tests/tracking_driver.py pipelined`): the same keyframe count (4
    synchronous, 6 pipelined) and every frame's camera center within
    RGBD_FRAME_BAND.  The pipelined run goes twice, and its two runs'
    camera centers must be equal at every frame; each pipelined run must
    finalize >= 6 frames read through pinned copies, counted per run;
  * 12c, tests/test_long_run.py's small circuit through the same
    `SLAMSystem(vocab=...)` loop, is no longer driven here: phase 16 runs
    that loop (closure, remap adoption, the in-place write check) at
    KITTI size through the command line, and the small circuit's 117
    frames took 92-133 s of the script's 1,200.

Phase 13 drives the scale-out tier (`parallel/`) and active mapping
(`active/`); one card, so the group has one rank and scaling at N >= 2 is
not measured:
  * 13a: a world-size-1 NCCL group (`parallel/distributed.initialize`,
    `file://` rendezvous) and a (1, 1) mesh: `reconstruct_sharded` at
    phase 4's problem under `gpu_fast` bf16 and under `ReconConfig()` f32,
    each within 1e-5 of the unsharded fit with the same is_good and both
    of its dtype's kernels launched; `run_sharded_ba` on phase 9b's
    corridor window at keyframe 500 (one LM step of the window recentered,
    9c's gauge, within 1e-4 of the unsharded step; the whole run within
    1e-3 poses / 1e-2 points, the
    same gated edges, reprojection cut below 0.7x) and
    `global_ba_pcg_sharded` over the whole corridor against the same LM
    stages unsharded (2e-2 / 5e-2, cut below 0.5x); ms beside the
    unsharded ms;
  * 13b: `tools/run_slam.py --distributed --num-processes 1` (NCCL over
    tcp://localhost) over the first 8 frames of 12a's directory, twice:
    as it runs (one rank: no mesh), and with the system given a (1, 1)
    mesh in that group, so that the new objects are fitted through
    `reconstruct_sharded` and the ranks' agreement checks run from the
    mapping worker's thread and stream.  Each run's CameraTrajectory.txt and
    MapObjects.txt within 1e-5 of the run without --distributed, all three
    under `distributed.keep_replicas_identical` (deterministic algorithms,
    as `initialize` turns on for more than one rank); both f32 kernels launched
    in each run and inside the mesh run's `reconstruct_sharded` calls;
    the group joined on NCCL and left after;
  * 13c: `nbv.generate` on phase 10's final map from its last frame with
    the fixture decoder, aimed at the object that owns the most map
    points, and on a map of one object of the fixture's family with 200
    member points near its surface (tests/test_torch_active.py's case):
    each the same best candidate as the port on the CPU, the 37 rewards within 1e-4 of the largest, the
    uncertainty within 1e-4 relative, the f32 value kernel launched;
    `rrt.plan` over the card's and the CPU's obstacles gives the same
    path; `system/renderer.py` (every object composited at stride 16, the
    object nearest the optical axis at stride 8, 16 samples a ray) against its CPU run: hit masks
    differ at <= 0.1% of pixels, depth within 1e-3 m where both hit.
  Each of its paths has its own decoder launch counts, reset just before
  it and read just after, in the kernels line's `launches_by_path`
  (`launches` stays the kernel's main path: phase 4 for bf16, phase 10 for
  f32).

Phase 14 runs the port's benches and aux tools (`dsp_slam_rgbd_tpu_torch/
tools/`) through their `main`s, as a user would:
  * 14a: `bench.main` at its default shapes (B=8, 256 points, 512 rays, 10
    GN iterations, `gpu_fast` bf16, the fixture decoder, 10 chained calls;
    its pipeline part left to 14c): every fit finite and is_good, both
    bf16 kernels launched; fits/s printed beside phase 4's (not checked:
    the host sets both);
  * 14b: `bench_tracking.main --frames 10` at KITTI size (the tool's
    default is 30): ms a frame, fps, the launches of one frame;
  * 14c: `bench_pipeline.run(frames=6, passes=1)` (short; the tool's
    default is 36 frames and 3 passes): fps, tracking-only and keyframe
    frame ms, at least one keyframe and one object, the bf16 value kernel
    launched (`gpu_fast`'s value pass; the object stage's Jacobian is f32);
  * 14d: `bench_scaling.main` at one rank over NCCL: its row, both f32
    kernels launched;
  * 14e: the aux tools on 12a's output directory, card against CPU:
    `evaluate_ate` gives 12a's ATE within 1e-6 m; `extract_map_objects`
    and `visualize_map` (32^3, the fixture decoder) launch the f32 value
    kernel and every vertex lies within 1e-4 of the CPU run's nearest
    (a grid value within the card-CPU difference of 0 may take another
    marching case, which moves no vertex off its grid point), the PNGs
    equal; `render_objects` at stride 16 within 2e-5 m where both hit,
    hit masks differing at <= 0.1% of pixels; `train_fixture_decoder`'s
    3 full-width steps' losses within 1e-4 relative;
    `convert_reference_labels` on a synthesized `.lbl`.
  Each path's launches join `launches_by_path`, and the phase fails
  unless its paths launched all four kernels.

Phase 15 makes every decoder kernel call three times on the same inputs
and stream (`tools/kernel_repeat.py`) and fails if any call's three
results are not equal bit for bit:
  * loop-fast: the bf16 pair under `gpu_fast`, `bench_pipeline`'s system
    loop (6 frames, one pass), then `bench.py`'s batched fits over and
    over while a second thread runs that pipeline again;
  * stress: the object stage's and the fits' launch sizes for 1,500
    calls or 15 s, whichever comes first, on a stream of their own, beside a second thread launching the f32 pair,
    ORB extraction and memory-bound kernels (whose blocks share the SMs);
  * loop: the command line over the first 8 frames of 12a's directory
    (the f32 pair), once, under the deterministic algorithms (turned off
    again after, so that phase 16 runs as a user's process does).
  It prints calls, faults, tilings and row counts per kernel, fails unless
  the loop runs reached both pairs and the stress run all four kernels,
  and fails unless the f32 Jacobian calls would have caught the fault of
  its earlier kernel (no proxy fence in the ring) at least 5 times at the
  rates measured on it (`PARENT_FAULTS_PER_CALL`).  Nearly all of that
  power is stress's (~180 expected faults at 1,500 calls); the loop run's
  ~50 f32 Jacobian calls expect ~0.1 at the loop's rate, and the loops are there
  to cover the bf16 pair and the f32 call sizes the SLAM loop makes.

Phase 16 writes `tools/sequence_dirs.py::write_kitti_circuit`'s directory
(`tools/loop_world.py`'s KITTI-size circuit: 105 1241x376 stereo frames
of an ellipse whose return leg meets lap 1's start only through place
recognition, six static objects' label files) and runs the port's
command line over it on the card with the command line's default
`async_kf_frames` (the closure runs in the mapping worker on its own
stream), with the arguments of `tests/tracking_driver.py circuit`, whose
JAX run on the CPU over the same files is JAX_CIRCUIT; both load the
10^4-word vocabulary the JAX command line bootstrapped over those files
(`tracking_driver.CIRCUIT_VOCAB`).  With its system wrapped
(`correct_loop` timed on the worker's stream, `_adopt` watched for the
point remap, `MappingStage.process` checked for in-place writes), it checks a row for every frame, > 90% OK, no keyframe dropped,
>= 1 closure adopted with its remap, each closure joining the keyframes
of the same frames as JAX_CIRCUIT's (`correct_loop`'s query and candidate
slots through `kf_frame_id`, `tracking_driver.closure_pair`), the ATE,
the lap gap and the
largest lap-2 error within 1.5x JAX_CIRCUIT's, every static truth within
0.3 m of a map object, no truth with two map objects within 1.5 m, no
more map objects than JAX's, and both f32 kernels launched.  It prints
fps, track ms p50/p90/p99, `correct_loop`'s ms in the worker (untraced),
its first call twice again on the same inputs on this thread (launches
from a trace of the card's kernels, host syncs as 11c counts them), the
frame ms at the adoption and the ms blocked in `_adopt` and
`_prewait_mapping`; its f32 launches join `launches_by_path`.  Each call
again must give the worker's map bit for bit, and the two as many
launches.

Phase 9b runs each local BA and the PCG a second time and fails unless
the two results are equal bit for bit; it prints the scatters' device
time inside the PCG.  Phase 17 takes the first `ops/scatter.py` call
(`index_add`, or `scatter_adds`: several scatters in one launch, directly
or through `scatter_add`) from each line of the port on 9b's local BA
(keyframe 500) and PCG, in 12a's first run (the map normals) and in phase
16 (the pose graph), plus two heavy-duplicate cases (2^20 rows onto 1 and
onto 8 targets).  It holds the segment-sum kernel (`csrc/segment_sum.cu`)
to `index_add_` on the CPU bit for bit on each `index_add` and on the
first scatter onto each output of each `scatter_adds`, and each
`scatter_adds` call, in its one launch and in one launch a scatter, to
the CPU's `index_add_` calls in sequence and to the plain table on the
card, bit for bit; and the offsets kernel of the plans to
`torch.searchsorted`.  It prints, with `tools/scatter_split.py`'s rows
(`case_row`, `batched_row`), the device µs a call (the
profiler's kernel times) and the host µs a call (the host clock over 200
calls, no synchronise inside) of the kernel, its plan and `index_add_`
(atomics) on the card, of each batched launch beside one launch a
scatter, the plain version's ms (segments up to 512 rows), the bound
(the bytes it must move over the card's memory rate), and on each path
(9b, 12a's first run, 16) the segment-sum launches beside the scatter
calls they carried and the offsets launches, each of which must be at
least one.  These kernels replace no TPU kernel, so they have their own
line (`phase 17 {"segment_sum": {"kernels": [...], ...}}`), not a place
in the kernels line.
"""
import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ellipsoid_decoder_64.npz")

SDF_ATOL, JAC_ATOL, TIE = 2e-5, 2e-4, 1e-6
BF16_SDF_ATOL, BF16_JAC_FROB, BF16_TIE = 1e-2, 2e-2, 1e-2
# main path: bench.py's shapes
B, N_PTS, N_RAYS, ITERS = 8, 256, 512, 10
# bf16 kernel sweeps: around their 64-row tile, and past the main path's sizes
VALUE_ROWS = (1, 63, 64, 65, 300, 4097, 102417)
JAC_ROWS = (1, 63, 64, 65, 300, 2048, 2049, 8192, 8193)
# f32 kernel sweeps: around their 32-row tiles, refinement's 2,048 rows, the render term's
F32_ROWS = (1, 31, 33, 511, 2048, 2049, 14336)
# phase 8 bands on the largest translation error (m); see the docstring
STEREO_BAND, RGBD_BAND = 0.166, 0.277
# (bf16 dense tensor-core FLOP/s, memory bytes/s): NVIDIA data sheets
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn over `reps` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_fit(fit, untraced_ms):
    """Device time of one traced fit, from torch.profiler's kernel events:
    total busy time, the share the mlp_sdf kernels take, the five kernels
    that take the most, and the idle share of an untraced fit's wall time
    (tracing slows the host, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in p.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    check(busy > 0, "the profiler saw device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"traced_wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / untraced_ms,
            "mlp_sdf_ms": sum(v for k, v in by_name.items() if "mlp_sdf" in k),
            "n_kernels": sum(1 for e in p.events() if e.device_type == DeviceType.CUDA),
            "top": [(k[:60], v) for k, v in top]}


def hgmma_count(build, kernel):
    """HGMMA (wgmma) instructions in `kernel`'s SASS in the built library."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", build.lib_path], capture_output=True,
                          text=True, check=True).stdout
    sections = sass.split("Function : ")[1:]
    check(any(kernel in sec.splitlines()[0] for sec in sections), f"{kernel} in the SASS")
    return sum(sec.count("HGMMA") for sec in sections if kernel in sec.splitlines()[0])


def code_forms(n, gen, dev):
    """(form, code, xyz) over n rows for a shared, per-row and per-object code
    (the largest object count <= 20 that divides n)."""
    b = max(d for d in range(1, 21) if n % d == 0)
    xyz = gen.standard_normal((n, 3)) * 0.5
    for form, code, x in (("shared", gen.standard_normal(64), xyz),
                          ("per-row", gen.standard_normal((n, 64)), xyz),
                          ("per-object", gen.standard_normal((b, 64)), xyz.reshape(b, n // b, 3))):
        yield (form, torch.tensor(code * 0.2, dtype=torch.float32, device=dev),
               torch.tensor(x, dtype=torch.float32, device=dev))


def hold_f32(mlp_sdf, dec, code, xyz, tag):
    """Both f32 kernels against their plain version on the same inputs
    (tolerances above) -> the case's numbers, with the tilings the
    launches took."""
    f32 = torch.float32
    wb = dec.packed(f32)
    n = xyz.numel() // 3
    case = {"case": tag, "value_tiling": mlp_sdf.f32_tiling("value", n),
            "jacobian_tiling": mlp_sdf.f32_tiling("jacobian", n)}
    v_k = mlp_sdf.sdf_value_fused(wb, code, xyz, f32, dec.tiles(f32))
    s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, f32,
                                                    dec.tiles(f32, jacobian=True))
    s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, f32)
    keep = mlp_sdf.relu_margin(wb, code, xyz) >= TIE
    torch.cuda.synchronize()
    check(v_k.shape == s_k.shape == s_p.shape and g_k.shape == g_p.shape
          and all(bool(torch.isfinite(t).all()) for t in (v_k, s_k, g_k)),
          f"{tag}: finite kernel output of the plain version's shape")
    if n >= 100:
        check(float(keep.float().mean()) >= 0.9, f"{tag}: <=10% near-tie rows")
    case.update(value_sdf_err=float((v_k - s_p).abs().max()), sdf_err=float((s_k - s_p).abs().max()),
                jac_err=float((g_k - g_p)[keep].abs().max()) if bool(keep.any()) else 0.0,
                rows_checked=int(keep.sum()))
    check(case["value_sdf_err"] <= SDF_ATOL and case["sdf_err"] <= SDF_ATOL
          and case["jac_err"] <= JAC_ATOL, f"{tag}: {case}")
    return case


def frob_rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def f64_matmul(a, b):
    """a @ b with the sums in f64, rounded once to f32."""
    return (a.double() @ b.double()).float()


def hold_bf16_jacobian(mlp_sdf, wb, tiles, code, xyz, tag):
    """The bf16 Jacobian kernel against its plain version on the same
    inputs (tolerances above) -> (the kernel's sdf and Jacobian, the
    plain Jacobian under the kernel's masks, the case's numbers)."""
    bf = torch.bfloat16
    relu = torch.empty(xyz.shape[:-1] + (8, 512), dtype=torch.uint8, device=xyz.device)
    s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, bf, tiles, masks_out=relu)
    s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, bf)
    _, g_m = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, bf, masks=relu)
    _, g_64 = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, bf, matmul=f64_matmul)
    pre = mlp_sdf.relu_preactivations(wb, code, xyz, bf)
    torch.cuda.synchronize()
    check(s_k.shape == s_p.shape and g_k.shape == g_p.shape
          and bool(torch.isfinite(s_k).all()) and bool(torch.isfinite(g_k).all()),
          f"{tag}: finite kernel output of the plain version's shape")
    differ = relu.bool() != (pre > 0)
    n_rows, n_differ = s_k.numel(), int(differ.sum())
    agree = ~differ.reshape(n_rows, -1).any(1)   # rows whose masks all agree
    g_k1, g_p1 = g_k.reshape(n_rows, -1), g_p.reshape(n_rows, -1)
    case = {"case": tag, "sdf_err": float((s_k - s_p).abs().max()), "jac_err": frob_rel(g_k, g_m),
            "jac_err_own_masks_agreeing_rows":
                frob_rel(g_k1[agree], g_p1[agree]) if bool(agree.any()) else 0.0,
            "jac_err_own_masks": frob_rel(g_k, g_p), "mask_ties": n_differ,
            "tie_pre_max": float(pre[differ].abs().max()) if n_differ else 0.0,
            "kernel_vs_f64": frob_rel(g_k, g_64), "plain_vs_f64": frob_rel(g_p, g_64)}
    check(case["sdf_err"] <= BF16_SDF_ATOL and case["jac_err"] <= BF16_JAC_FROB
          and case["jac_err_own_masks_agreeing_rows"] <= BF16_JAC_FROB
          and case["tie_pre_max"] < BF16_TIE and n_differ <= 8 + n_rows // 5, f"{tag}: {case}")
    return s_k, g_k, g_m, case


def _median(xs):
    return float(np.median(xs)) if len(xs) else float("nan")


def drive_tracking(world, texture, sensor, n, dev):
    """Phase 8's driver: the port's tracker over n frames of the tilted-
    plane world with the full keyframe stage whenever it returns `new_kf`
    (`kf_point_stage`, then `local_ba_and_cull_step` over the local
    window; culled slots leave the host's keyframe mask): the "full" stage
    of tests/tracking_driver.py.  -> (tracker, keyframe count, culled
    slots, [(untraced wall ms of each frame with its keyframe stage,
    whether it made a keyframe)], [(ms of kf_point_stage, ms of
    local_ba_and_cull_step) per keyframe])."""
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk

    cfg = tracking_config(world, sensor)
    m = cfg.map
    tr = trk.Tracker(cfg, ms.empty(max_kf=m.max_kf, max_feat=m.max_feat, max_pts=m.max_pts,
                                   max_obj=m.max_obj, max_oobs=m.max_oobs, device=dev),
                     device=dev)
    kf_valid = np.zeros(m.max_kf, bool)
    n_kf = 0
    culled, frame_ms, kf_ms = [], [], []
    th_depth_m = cfg.tracking.th_depth * cfg.cam.bf / cfg.cam.fx
    for i in range(n):
        x = pw.gt_x(world, i)
        left = pw.render_u8(world, texture, x)
        right = pw.render_u8(world, texture, x + world.baseline) if sensor == "stereo" else None
        depth = pw.depth_map(world, x) if sensor == "rgbd" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tr.track(left, img_right=right, depth_map=depth, timestamp=i * 0.1)[-1]
        if out["new_kf"]:
            slot = int(ms.alloc_slots(kf_valid, 1)[0])
            if slot >= 0:
                kf_valid[slot] = True
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st = lm.kf_point_stage(tr.state, cfg.cam, slot, out["frame"], out["fid"],
                                       th_depth_m, n_kf, True, n_neighbors=10, min_obs_after=4)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                st, gone = lm.local_ba_and_cull_step(st, cfg.cam, slot, m.local_window)
                torch.cuda.synchronize()
                kf_ms.append(((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
                kf_valid[gone] = False
                culled += gone
                tr.state = st
                n_kf += 1
                tr.last_kf_frame_id = out["fid"]
                if tr.ref_kf < 0:
                    tr.ref_kf = slot
        torch.cuda.synchronize()
        frame_ms.append(((time.perf_counter() - t0) * 1e3, bool(out["new_kf"])))
    return tr, n_kf, culled, frame_ms, kf_ms


def tracking_config(world, sensor):
    """`tools/bench_pipeline.py:91-117`'s tracking configuration for `world`."""
    from dsp_slam_rgbd_tpu_torch import config
    from dsp_slam_rgbd_tpu_torch.frontend.orb import OrbConfig
    from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics

    cam = Intrinsics(fx=world.fx, fy=world.fx, cx=world.cx, cy=world.cy,
                     bf=world.fx * world.baseline)
    return config.SystemConfig(
        sensor=sensor, cam=cam, orb=OrbConfig(),
        tracking=config.TrackingConfig(fps=10.0, th_depth=35.0, max_frames_between_kf=5),
        map=config.MapConfig(max_kf=48, max_feat=2048, max_pts=32768, max_obj=8,
                             max_oobs=256, local_window=8))


def wall_ms(fn, reps):
    """Mean wall time of fn over reps calls, each ended by a synchronize
    (host-driven work: the launches and host reads are part of its time)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def tracking_phase(dev, smi):
    """Phases 8 and 9a: the per-frame tracking path and the keyframe stage
    at KITTI size (see the module docstring) -> the report's "tracking"
    entry."""
    from dsp_slam_rgbd_tpu_torch.frontend import orb, stereo
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.solvers import pose_gn
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk

    t_phase = time.perf_counter()
    world = pw.KITTI
    texture = pw.make_texture(world)
    rep = {"card": smi}
    bf = world.fx * world.baseline
    cfg_orb = orb.OrbConfig()

    # ---- 8a. frontend on the card against the same port code on the CPU
    left = pw.render_u8(world, texture, 0.0)
    right = pw.render_u8(world, texture, world.baseline)
    res = []
    for d in (dev, torch.device("cpu")):
        il, ir = orb.to_image(left, d), orb.to_image(right, d)
        fl, fr = orb.extract_pair(il, ir, cfg_orb, device=d)
        sm = stereo.match_stereo(fl, fr, il, ir, bf, min_z=bf / world.fx)
        res.append([t.cpu() for t in (fl.xy, fl.valid, fl.desc, fr.xy, fr.valid, fr.desc,
                                      sm.valid, sm.depth)])
    g, c = res
    same = [((g[i] == c[i]).all(1) & (g[i + 1] == c[i + 1])) for i in (0, 3)]
    kp_eq = [float(s.float().mean()) for s in same]
    desc_bad = [int((g[i + 2][s & g[i + 1]] != c[i + 2][s & g[i + 1]]).any(1).sum())
                for i, s in zip((0, 3), same)]
    common = g[6] & c[6] & same[0]
    depth_rel = float(((g[7] - c[7]).abs() / c[7])[common].max())
    rep["frontend_vs_cpu"] = {"keypoints_equal": kp_eq, "descriptors_differing": desc_bad,
                              "stereo_common": int(common.sum()), "stereo_valid_card": int(g[6].sum()),
                              "stereo_valid_cpu": int(c[6].sum()), "depth_rel_err": depth_rel}
    check(min(kp_eq) >= 0.99 and sum(desc_bad) == 0 and int(common.sum()) >= 100
          and depth_rel <= 1e-3, f"8a frontend on the card vs the CPU: {rep['frontend_vs_cpu']}")
    print(f"phase 8a frontend card vs CPU (KITTI 1241x376 pair, 2000 features, 8 levels): "
          f"keypoints equal {kp_eq[0]:.4f} / {kp_eq[1]:.4f} (left / right), descriptors "
          f"differing at common keypoints {desc_bad}, stereo matches {int(g[6].sum())} card / "
          f"{int(c[6].sum())} CPU, {int(common.sum())} common, largest depth difference "
          f"{depth_rel:.3g} relative on {smi}", flush=True)

    # ---- 8b / 8c. stereo and RGB-D sequences with the full keyframe stage
    # (the counts of the decoder kernels are read around them: the tracking
    # path launches none)
    trackers = {}
    for tag, sensor, n, band in (("8b", "stereo", 24, STEREO_BAND), ("8c", "rgbd", 12, RGBD_BAND)):
        mlp_sdf.reset_launch_counts()
        tr, n_kf, culled, frame_ms, kf_ms = drive_tracking(world, texture, sensor, n, dev)
        launches = dict(mlp_sdf.LAUNCHES)
        trackers[sensor] = tr, n_kf
        ok = np.array([bool(o) for _, _, o in tr.trajectory])
        T = np.stack([p.cpu().numpy() for _, p, _ in tr.trajectory]).astype(np.float64)
        gt = np.array([pw.gt_x(world, int(round(ts / 0.1))) for ts, _, _ in tr.trajectory])
        err = np.abs(-T[:, 0, 3] - gt)
        max_err = float(err[ok].max()) if ok.any() else float("inf")
        seq = {"frames": n, "tracked": len(ok), "ok_share": float(ok.mean()), "keyframes": n_kf,
               "culled": culled, "max_t_err_m": max_err, "band_m": band, "t_err_m": err.tolist(),
               "decoder_kernel_launches": launches,
               "frame_ms_track_only_median": _median([t for t, k in frame_ms[1:] if not k]),
               "frame_ms_keyframe_median": _median([t for t, k in frame_ms[1:] if k]),
               "frame_ms_first": frame_ms[0][0],
               "kf_point_stage_ms": [a for a, _ in kf_ms],
               "local_ba_and_cull_ms": [b for _, b in kf_ms]}
        rep[sensor] = seq
        check(len(ok) == n and ok.mean() >= 0.9 and n_kf >= 2 and np.isfinite(T).all()
              and max_err < band and (sensor != "stereo" or len(culled) >= 1),
              f"{tag} {sensor} sequence: {seq}")
        print(f"phase {tag} {sensor} sequence, full keyframe stage: {n} frames, ok "
              f"{ok.mean():.3f}, {n_kf} keyframes, culled {culled}, largest translation error "
              f"{max_err:.4f} m (band {band} m); median ms per frame "
              f"{seq['frame_ms_track_only_median']:.1f} tracking-only, "
              f"{seq['frame_ms_keyframe_median']:.1f} with a keyframe (first frame "
              f"{seq['frame_ms_first']:.0f} ms); median ms per keyframe: kf_point_stage "
              f"{_median(seq['kf_point_stage_ms'][1:]):.1f}, local_ba_and_cull_step "
              f"{_median(seq['local_ba_and_cull_ms'][1:]):.1f}; decoder kernels launched "
              f"{launches} on {smi}", flush=True)

    # ---- per-part times, syncs, launches, busy: the stereo tracker of 8b
    # on the frames after its checked sequence
    tr, n_kf = trackers["stereo"]
    nxt = pw.gt_x(world, 24)
    img_l = pw.render_u8(world, texture, nxt)
    img_r = pw.render_u8(world, texture, nxt + world.baseline)
    il, ir = orb.to_image(img_l, dev), orb.to_image(img_r, dev)
    fl, fr = orb.extract_pair(il, ir, cfg_orb)
    frame = tr.make_frame(img_l, img_r, timestamp=2.4)
    lf, cam = tr.last_frame, tr.cfg.cam

    def fused():
        return trk._track_frame_fused(
            cam, tr.state, lf.t_cw, tr.velocity, frame.feats.xy, frame.feats.desc,
            frame.feats.level, frame.feats.valid, frame.feats.angle, frame.ur, frame.depth,
            lf.pt_idx, lf.feats.angle, 7.0, tr._th_depth_m(), tr.cfg.map.local_window, True)

    t_cw, pt_idx, stats, _, _ = fused()
    pts_w = tr.state.pt_pos[torch.clamp_min(pt_idx, 0).long()]
    obs = torch.cat([frame.feats.xy, frame.ur[:, None]], -1)
    inv_s2 = 1.0 / (1.2 ** (2.0 * frame.feats.level.float()))
    matched = (pt_idx >= 0) & frame.feats.valid
    parts = {
        "orb_extract_ms_per_image": wall_ms(lambda: orb.extract(il, cfg_orb), 5),
        "stereo_match_ms": wall_ms(lambda: stereo.match_stereo(fl, fr, il, ir, bf,
                                                                min_z=bf / world.fx), 5),
        "fused_tracking_ms": wall_ms(fused, 5),
        "pose_gn_ms": wall_ms(lambda: pose_gn.optimize_pose(cam, lf.t_cw, pts_w, obs, inv_s2,
                                                            matched, stereo=True), 5),
        "fused_stats": stats.tolist()}

    def one_frame(i):
        x = pw.gt_x(world, i)
        out = tr.track(pw.render_u8(world, texture, x), img_right=pw.render_u8(
            world, texture, x + world.baseline), timestamp=i * 0.1)[-1]
        torch.cuda.synchronize()
        return out

    one_frame(24)
    t0 = time.perf_counter()
    one_frame(25)
    untraced = (time.perf_counter() - t0) * 1e3
    syncs = count_syncs(lambda: one_frame(26))
    n_kern, busy = traced(lambda: one_frame(27))
    check(busy > 0, "the profiler saw device time in a tracking frame")
    gn_launches, _ = traced(lambda: pose_gn.optimize_pose(cam, lf.t_cw, pts_w, obs, inv_s2,
                                                          matched, stereo=True))
    parts.update({"frame_ms_untraced": untraced, "host_syncs_per_frame": syncs,
                  "kernel_launches_per_frame": n_kern, "busy_ms": busy,
                  "idle_share": 1.0 - busy / untraced, "pose_gn_launches": gn_launches})
    rep["per_frame"] = parts
    print(f"phase 8 per frame (stereo, KITTI size): ORB extraction {parts['orb_extract_ms_per_image']:.2f}"
          f" ms per image, stereo match {parts['stereo_match_ms']:.2f} ms, fused tracking stage "
          f"{parts['fused_tracking_ms']:.2f} ms, pose GN {parts['pose_gn_ms']:.2f} ms; one frame "
          f"{untraced:.1f} ms untraced: {n_kern} kernel launches ({gn_launches} in one pose GN "
          f"call), {syncs} host syncs, device busy {busy:.2f} ms (idle share "
          f"{parts['idle_share']:.3f}) on {smi}", flush=True)

    # ---- 9a. the keyframe stage at KITTI size, on the stereo tracker's map
    rep["keyframe_stage"] = keyframe_stage_phase(tr, one_frame(28)["frame"], n_kf, smi)
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 8-9a took {rep['phase_s']:.0f} s", flush=True)
    return rep


def count_syncs(fn, sites=None):
    """Host syncs of one call of fn (`torch.cuda.set_sync_debug_mode`); with
    a dict `sites`, also each sync's count by the line that made it
    ("path:line", relative to the repo or to site-packages)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        for w in syncs:
            f = (os.path.relpath(w.filename, ROOT) if w.filename.startswith(ROOT)
                 else w.filename.split("site-packages/")[-1])
            key = f"{f}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return len(syncs)


def traced(fn, top=None):
    """(launches, device busy ms) of one traced call of fn; with `top`,
    also the `top` kernels that took the most device time [(name, ms)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    if top is None:
        return len(kern), busy
    by_name = {}
    for e in kern:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    return len(kern), busy, sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


# the fixed-order scatter-add on the main path: each phase's first call from each
# line of the port it captures, on the card: `index_add` calls ("phase file:line" ->
# (out before the add, plan, src)) and `scatter_adds` calls (-> [(n, [(plan, src),
# ...]), ...]); and the kernels' launches and the scatters they carried on each path
SCATTER_CASES, BATCH_CASES, SCATTER_LAUNCHES = {}, {}, {}
# traces of the card's activity only that an earlier phase leaves for after phase
# 16 (name -> a call giving `stream_launches`' result)
LATE_TRACES = {}


@contextlib.contextmanager
def capturing_scatters(label, files):
    """While the block runs (on any thread), the first `ops/scatter.py` call
    (`index_add`, or `scatter_adds` directly or through `scatter_add`) from
    each line of the port's `files` (basenames) is copied into SCATTER_CASES
    or BATCH_CASES under "label file:line"."""
    from dsp_slam_rgbd_tpu_torch.ops import scatter

    real_add, real_adds, lock = scatter.index_add, scatter.scatter_adds, threading.Lock()

    def site():
        f = sys._getframe(2)
        while f.f_code.co_filename == scatter.__file__:   # through scatter_add
            f = f.f_back
        name = os.path.basename(f.f_code.co_filename)
        return f"{label} {name}:{f.f_lineno}" if name in files else None

    def index_add(out, p, src):
        where = site()
        if where is not None:
            with lock:
                if where not in SCATTER_CASES:
                    SCATTER_CASES[where] = (out.clone(), p, src.clone())
        return real_add(out, p, src)

    def scatter_adds(*outputs):
        where = site()
        if where is not None:
            with lock:
                if where not in BATCH_CASES:
                    BATCH_CASES[where] = [(n, [(p, src.clone()) for p, src in adds])
                                          for n, *adds in outputs]
        return real_adds(*outputs)

    with mock.patch.object(scatter, "index_add", index_add), \
            mock.patch.object(scatter, "scatter_adds", scatter_adds):
        yield


@contextlib.contextmanager
def counting_scatters(path):
    """The segment-sum kernel's launches, the scatters they carried and the
    offsets kernel's launches (the plans) while the block runs, into
    SCATTER_LAUNCHES[path] (the counts reset just before, read just after)."""
    from dsp_slam_rgbd_tpu_torch.ops.cuda import segment_sum

    segment_sum.reset_launch_counts()
    try:
        yield
    finally:
        SCATTER_LAUNCHES[path] = {"segment_sum": segment_sum.LAUNCHES["segment_sum"],
                                  "scatters": segment_sum.SCATTERS["segment_sum"],
                                  "segment_offsets": segment_sum.LAUNCHES["segment_offsets"]}


def bits_equal(a, b) -> bool:
    """Whether two tensors (or NamedTuples of them) hold the same bits."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))
    if not isinstance(a, torch.Tensor):
        return a == b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return bool(torch.equal(a.cpu(), b.cpu()))


def stream_launches(fn, dev):
    """(fn's result, the kernels this thread launched in it, the kernels of
    those launches the trace holds, their busy ms): a trace of the card's
    activity only, after a throwaway one (the tracer drops a new trace's
    first kernels); a launch is a kernel launch of the CUDA runtime or
    driver made by this host thread, its kernel the one with its
    correlation id.  Another thread's launches do not count."""
    from torch.profiler import ProfilerActivity, profile

    stream = torch.cuda.current_stream()
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev)
        stream.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        out = fn()
        stream.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    # the tracer names a host thread by its pthread id's low 32 bits, as a
    # signed int whose sign it may drop
    low = threading.get_ident() & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= 1 << 31 else low
    tid = {low, signed, abs(signed), threading.get_native_id()}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "") and e.get("tid") in tid]
    corr = {e["args"].get("correlation") for e in launches}
    kern = [e for e in events if e.get("cat") == "kernel"
            and e["args"].get("correlation") in corr]
    # a launch counts from its host-side event: the tracer drops some of the
    # kernels themselves (9 and 2,212 of `correct_loop`'s 67,717 in two traces
    # on an H100), so the busy ms is that of the kernels it kept
    check(launches and kern,
          f"this thread's launches (tid {tid}) found in the trace with their kernels: "
          f"{len(launches)} launches, {len(kern)} kernels; launch events' tids "
          f"{sorted({e.get('tid') for e in events if e.get('cat') == 'cuda_runtime'})[:8]}")
    return out, len(launches), len(kern), sum(float(e.get("dur", 0.0)) for e in kern) / 1e3


def late_traces(report, smi):
    """11c's closing sequence traced once more after phase 16, when the
    system loop's worker threads have ended (see `loop_phase`): its
    launches and busy ms join the report's "loop" entry."""
    t0 = time.perf_counter()
    _, n, n_kern, busy = LATE_TRACES.pop("11c")()
    close = report["loop"]["loop_close"]
    close.update(sequence_launches=n, sequence_kernels_traced=n_kern, sequence_busy_ms=busy)
    close["seconds"]["traced"] = time.perf_counter() - t0
    print(f"phase 11c the whole sequence (upload, 8 BoW updates, 4 _loop_stage calls) traced "
          f"after phase 16: {n} launches ({n_kern} of their kernels in the trace, busy "
          f"{busy:.1f} ms); {close['seconds']['traced']:.1f} s on {smi}", flush=True)


def keyframe_stage_phase(tr, frame, kid, smi):
    """Phase 9a: one more keyframe stage on the stereo tracker's map after
    phase 8 (frame 28, keyframe id `kid`, into the first free slot): host
    syncs of the whole stage, launches, busy ms and idle share of each
    half, and the BA window's size.  The per-keyframe medians come from
    8b's run."""
    from dsp_slam_rgbd_tpu_torch.mapping import ba
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm

    cfg = tr.cfg
    cam, window = cfg.cam, cfg.map.local_window
    th_depth_m = cfg.tracking.th_depth * cam.bf / cam.fx
    state0 = tr.state
    slot = int(np.flatnonzero(~state0.kf_valid.cpu().numpy())[0])

    def point_stage():
        return lm.kf_point_stage(state0, cam, slot, frame, 28, th_depth_m, kid, True,
                                 n_neighbors=10, min_obs_after=4)

    st1 = point_stage()
    counts = lm._ba_counts_device(st1, slot, window, False).cpu().numpy()

    def ba_cull():
        return lm.local_ba_and_cull_step(st1, cam, slot, window)

    def whole():
        return lm.local_ba_and_cull_step(point_stage(), cam, slot, window)

    _, culled = ba_cull()
    torch.cuda.synchronize()
    ms_point = wall_ms(point_stage, 3)
    ms_ba = wall_ms(ba_cull, 3)
    # the BA+cull half's layers, each timed alone
    buckets = lm._bucket_memo[lm._shapes(state0) + (window, False)]
    prob, idx, _ = lm._ba_assemble_device(st1, slot, window, False, *buckets)
    res = ba.local_ba(cam, prob)
    layers = {"assemble_ms": wall_ms(lambda: lm._ba_assemble_device(
                  st1, slot, window, False, *buckets), 3),
              "local_ba_ms": wall_ms(lambda: ba.local_ba(cam, prob), 3),
              "apply_ms": wall_ms(lambda: lm.apply_ba_result(st1, idx, res), 3),
              "cull_ms": wall_ms(lambda: lm._cull_keyframes_device(st1, slot, 0.9, 2), 3),
              "local_ba_launches": traced(lambda: ba.local_ba(cam, prob))[0],
              "fuse_ms": wall_ms(lambda: lm.fuse_neighbors(st1, cam, slot), 3),
              "fuse_busy_ms": traced(lambda: lm.fuse_neighbors(st1, cam, slot))[1]}
    syncs = count_syncs(whole)
    n_point, busy_point, top_point = traced(point_stage, top=4)
    n_ba, busy_ba = traced(ba_cull)
    rep = {"slot": slot, "ba_counts": counts.tolist(),
           "ba_buckets": list(lm._bucket_memo[lm._shapes(state0) + (window, False)]),
           "culled": culled, "host_syncs_per_keyframe_stage": syncs,
           "kf_point_stage_ms": ms_point, "local_ba_and_cull_ms": ms_ba,
           "kf_point_stage_launches": n_point, "kf_point_stage_busy_ms": busy_point,
           "kf_point_stage_top_kernels": top_point,
           "kf_point_stage_idle_share": 1.0 - busy_point / ms_point,
           "local_ba_and_cull_launches": n_ba, "local_ba_and_cull_busy_ms": busy_ba,
           "local_ba_and_cull_idle_share": 1.0 - busy_ba / ms_ba, "layers": layers,
           "card": smi}
    check(busy_point > 0 and busy_ba > 0, "the profiler saw device time in the keyframe stage")
    n_kf, n_pt, n_obs, n_obj, _ = counts
    print(f"phase 9a keyframe stage (stereo KITTI map after 8b, slot {slot}): BA window "
          f"B={n_kf + n_obj} ({n_kf} keyframes), {n_pt} points, {n_obs} edges, buckets "
          f"{rep['ba_buckets']}, culled {culled}; kf_point_stage {ms_point:.1f} ms "
          f"({n_point} launches, busy {busy_point:.2f} ms, idle share "
          f"{rep['kf_point_stage_idle_share']:.3f}), local_ba_and_cull_step {ms_ba:.1f} ms "
          f"({n_ba} launches, busy {busy_ba:.2f} ms, idle share "
          f"{rep['local_ba_and_cull_idle_share']:.3f}; alone: assembly "
          f"{layers['assemble_ms']:.1f} ms, local_ba {layers['local_ba_ms']:.1f} ms in "
          f"{layers['local_ba_launches']} launches, apply {layers['apply_ms']:.1f} ms, cull "
          f"{layers['cull_ms']:.1f} ms; fusion alone {layers['fuse_ms']:.1f} ms, busy "
          f"{layers['fuse_busy_ms']:.2f} ms); {syncs} host syncs per keyframe stage; point stage "
          f"top: " + ", ".join(f"{k} {v:.2f} ms" for k, v in top_point) + f" on {smi}",
          flush=True)
    return rep


def mean_reproj(ba, cam, p):
    """Mean 2-D reprojection error (px) over a BA problem's live edges
    (tests/test_ba_scale.py's metric)."""
    r = ba._reproj_terms(cam, p)[0]
    live = p.obs_mask & p.pt_valid[p.obs_pt.long()] & p.kf_valid[p.obs_kf.long()]
    e = torch.linalg.vector_norm(r[:, :2], dim=-1)
    return float(torch.sum(torch.where(live, e, 0.0)) / torch.sum(live))


def recentered(fields):
    """A BA problem ({field: numpy array}) with the world origin moved to
    its keyframes' mean camera center: the same problem in another gauge.
    Along the corridor the map's coordinates reach 1,000 m, where one f32
    step is 6e-5 m; here they are window-sized."""
    T = fields["kf_pose"].astype(np.float64)
    centers = -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    m = centers[fields["kf_valid"]].mean(0)
    T[:, :3, 3] += np.einsum("kij,j->ki", T[:, :3, :3], m)
    obj = fields["obj_pose"].astype(np.float64)
    obj[:, :3, 3] -= m
    return dict(fields, kf_pose=T.astype(np.float32), pts=(fields["pts"] - m).astype(np.float32),
                obj_pose=obj.astype(np.float32))


def ba_scale_phase(dev, smi):
    """Phases 9b and 9c: bundle adjustment on the KITTI-00-scale corridor
    map (`tools/corridor_map.py`: 1,000 keyframes, 200,000 points, 200
    features per keyframe) on the card, held to tests/test_ba_scale.py's
    criteria, then the card against the CPU.  -> (report entry, the
    corridor's MapState on the card, for phase 13a)."""
    from dsp_slam_rgbd_tpu_torch.mapping import ba
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.tools import corridor_map as cm
    from dsp_slam_rgbd_tpu_torch.weights import (ba_problem_from_numpy, ba_problem_to_numpy,
                                                 map_state_from_numpy)

    cam = cm.CAM
    rep = {"card": smi}
    t0 = time.perf_counter()
    fields, _, _ = cm.build_corridor_map()
    state = map_state_from_numpy(fields, dev)
    rep["build_s"] = time.perf_counter() - t0

    # ---- 9b. local BA at three places along the corridor, then one global
    # BA (matrix-free PCG) over the whole map
    local = []
    for center in (10, 500, 990):
        prob, _ = lm.build_local_ba_problem(state, center, max_kfs=10)
        B = prob.kf_pose.shape[0] + prob.obj_pose.shape[0]
        ms_ = wall_ms(lambda: ba.local_ba(cam, prob), 2)
        with capturing_scatters("9b local", ("ba.py",)) if center == 500 \
                else contextlib.nullcontext(), counting_scatters(f"9b local BA at {center}"):
            res = ba.local_ba(cam, prob)
        launches, busy = traced(lambda: ba.local_ba(cam, prob))
        # two runs of one problem give the same bits
        repeats = bits_equal(ba.local_ba(cam, prob), res)
        before = mean_reproj(ba, cam, prob)
        after = mean_reproj(ba, cam, prob._replace(kf_pose=res.kf_pose, pts=res.pts))
        case = {"center": center, "B": B, "points": prob.pts.shape[0],
                "edges": int(prob.obs_mask.sum()), "ms": ms_, "launches": launches,
                "busy_ms": busy, "reproj_px_before": before, "reproj_px_after": after,
                "repeats": repeats}
        local.append(case)
        check(B <= 64 and np.isfinite(after) and after < 0.7 * before, f"9b local BA {case}")
        check(repeats, f"9b local BA at {center}: a second run equals the first bit for bit")
        print(f"phase 9b local BA at keyframe {center} of the corridor (1,000 KFs, 200,000 "
              f"points): B={B}, {case['points']} point slots, {case['edges']} edges; "
              f"reprojection {before:.3f} -> {after:.3f} px; {ms_:.1f} ms, {launches} launches, "
              f"busy {busy:.2f} ms; a second run bit for bit equal: {repeats} on {smi}",
              flush=True)
    gprob, gidx = lm.build_local_ba_problem(state, 0, 0, global_window=True)
    B = gprob.kf_pose.shape[0] + gprob.obj_pose.shape[0]
    n_live = int(ms._obs_ok(state).sum())
    n_in = int(gprob.obs_mask.sum())
    ms_ = wall_ms(lambda: ba.global_ba_pcg(cam, gprob, n_iters=6), 1)
    with capturing_scatters("9b PCG", ("ba.py",)), counting_scatters("9b global BA (PCG)"):
        res = ba.global_ba_pcg(cam, gprob, n_iters=6)
    launches, busy, top = traced(lambda: ba.global_ba_pcg(cam, gprob, n_iters=6), top=40)
    repeats = bits_equal(ba.global_ba_pcg(cam, gprob, n_iters=6), res)
    # the scatters' device time: the segment-sum kernel (and any index_add_ left)
    scatter_ms = sum(v for k, v in top if "segment_sum" in k or "indexFunc" in k)
    before = mean_reproj(ba, cam, gprob)
    after = mean_reproj(ba, cam, gprob._replace(kf_pose=res.kf_pose, pts=res.pts))
    state2 = lm.apply_ba_result(state, gidx, res)
    glob = {"B": B, "edges": n_in, "live_observations": n_live, "points": gprob.pts.shape[0],
            "ms": ms_, "launches": launches, "busy_ms": busy, "top_kernels": top,
            "scatter_ms": scatter_ms, "reproj_px_before": before, "reproj_px_after": after,
            "repeats": repeats}
    check(B >= 1000 and n_in == n_live > 150_000 and np.isfinite(after) and after < 0.5 * before
          and bool(torch.isfinite(state2.kf_pose).all()), f"9b global BA {glob}")
    check(repeats, "9b global BA (PCG): a second run equals the first bit for bit")
    rep.update(local_ba=local, global_ba_pcg=glob)
    print(f"phase 9b global BA (PCG, 6 LM iterations of 48 CG steps): B={B}, {n_in} edges "
          f"(every live observation), {glob['points']} point slots; reprojection {before:.3f} -> "
          f"{after:.3f} px; {ms_:.1f} ms, {launches} launches, busy {busy:.2f} ms, of it the "
          f"scatters {scatter_ms:.2f} ms; a second run bit for bit equal: {repeats}; top: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in top[:4]) + f" on {smi}", flush=True)

    # ---- 9c. the card against the CPU: one LM step of each local problem,
    # and the dense-vs-PCG agreement on the 24-KF corridor
    cpu = torch.device("cpu")
    steps = []
    for center in (10, 500, 990):
        prob, _ = lm.build_local_ba_problem(state, center, max_kfs=10)
        case = {"center": center}
        for gauge, fields in (("map", ba_problem_to_numpy(prob)),
                              ("local", recentered(ba_problem_to_numpy(prob)))):
            card, _ = ba._assemble_and_solve(cam, ba_problem_from_numpy(fields, dev), 1e-3)
            host, _ = ba._assemble_and_solve(cam, ba_problem_from_numpy(fields, cpu), 1e-3)
            for k in ("kf_pose", "pts"):
                case[f"{gauge}_{k}"] = float((getattr(card, k).cpu() - getattr(host, k)).abs().max())
        steps.append(case)
        check(max(case["local_kf_pose"], case["local_pts"]) <= 1e-4,
              f"9c one LM step, card vs CPU at {center}: {case}")
    fields, _, centers = cm.build_corridor_map(n_kf=24, n_pts=2000, feat_per_kf=120, noise=0.2,
                                               max_kf=32, max_pts=4096)
    small, poses = {}, {}
    for where, d in (("card", dev), ("cpu", cpu)):
        prob, idx = lm.build_local_ba_problem(map_state_from_numpy(fields, d), 0, 0,
                                              global_window=True)
        res_d = ba.global_ba(cam, prob, n_iters=10)
        res_p = ba.global_ba_pcg(cam, prob, n_iters=10, cg_iters=64, damping=1e-3)
        kf = idx.kf_idx.cpu().numpy()
        ok = kf >= 0
        poses[where] = [r.kf_pose.cpu().numpy()[ok] for r in (res_d, res_p)]
        for name, pose in zip(("dense", "pcg"), poses[where]):
            e = float(np.linalg.norm(-pose[:, :3, 3] - centers[kf[ok]], axis=-1).max())
            small[f"{where}_{name}_max_err_m"] = e
            check(e < 0.03, f"9c 24-KF corridor {where} {name}: {e}")
        small[f"{where}_dense_vs_pcg"] = float(np.abs(poses[where][0] - poses[where][1]).max())
        check(small[f"{where}_dense_vs_pcg"] < 5e-3, f"9c dense vs PCG on the {where}: {small}")
    small["card_vs_cpu_dense"] = float(np.abs(poses["card"][0] - poses["cpu"][0]).max())
    small["card_vs_cpu_pcg"] = float(np.abs(poses["card"][1] - poses["cpu"][1]).max())
    check(max(small["card_vs_cpu_dense"], small["card_vs_cpu_pcg"]) < 5e-3,
          f"9c 24-KF corridor card vs CPU: {small}")
    rep.update(step_card_vs_cpu=steps, corridor24=small)
    print(f"phase 9c card vs CPU: one LM step (largest differences in the map's coordinates "
          f"and recentered) {steps}; 24-KF corridor {small} on {smi}", flush=True)
    return rep, state


# ---------------------------------------------------------------------------
# phase 10: the object stage in the SLAM loop
OBJECTS_BAND = 0.166   # 1.5x the JAX package's 0.110393 m on the same run
# the JAX package's own run on the CPU (tests/tracking_driver.py): 11
# keyframes, slots 2 and 1 culled, each truth's center error (m) and the
# mover (truth 7) dynamic
JAX_OBJECTS = {"keyframes": 11, "culled": [2, 1], "max_t_err_m": 0.110393,
               "center_err_m": [0.024751, 0.023363, 0.024949, 0.021525, 0.027490, 0.021593,
                                0.030116, 0.018003],
               "dynamic": [False] * 7 + [True]}
F32_PEAK = 67e12       # float32 outside the tensor cores, H100 SXM data sheet
MONO_RECON = dict(num_depth_samples=24, num_iterations=6, scale_damping=20.0,
                  max_grad_points=512, max_valid_samples=2048)


class StageProbe:
    """While entered, wraps the object stage's steps (and the BA dispatch)
    so that each call ends in a synchronize: per keyframe, ms and decoder
    kernel launches of association, refinement, new-object reconstruction
    (with the batched `sdf_bbox`) and insertion, the row buckets they ran
    at, and the BA window's counts [n_kf, n_pt, n_obs, n_obj, n_oobs]."""
    PARTS = {"associate_dispatch": "association", "associate_read": "association",
             "refine_associated": "refinement", "recon_unmatched": "new_objects",
             "insert_new_objects": "insertion"}

    def __init__(self):
        from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
        from dsp_slam_rgbd_tpu_torch.system import object_stage as ostage

        self.lm, self.ostage = lm, ostage
        self.saved = {}
        self.rec = None

    def _wrap(self, name, part, fn):
        from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

        def run(*a, **k):
            if name == "refine_associated":
                self.rec["A_rows"] = int(a[4].shape[0])
            if name == "recon_unmatched":
                self.rec["U_rows"] = len(a[4])
            torch.cuda.synchronize()
            l0, t0 = dict(mlp_sdf.LAUNCHES), time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            r = self.rec.setdefault(part, {"ms": 0.0, "value": 0, "jacobian": 0})
            r["ms"] += (time.perf_counter() - t0) * 1e3
            r["value"] += mlp_sdf.LAUNCHES["mlp_sdf_value_f32"] - l0["mlp_sdf_value_f32"]
            r["jacobian"] += (mlp_sdf.LAUNCHES["mlp_sdf_jacobian_f32"]
                              - l0["mlp_sdf_jacobian_f32"])
            return out
        return run

    def _window(self, fn):
        def run(state, cam, center, max_kfs=10, *a, **k):
            self.rec["ba_counts"] = self.lm._ba_counts_device(
                state, center, max_kfs, False).cpu().tolist()
            return fn(state, cam, center, max_kfs, *a, **k)
        return run

    def __enter__(self):
        for name, part in self.PARTS.items():
            self.saved[name] = getattr(self.ostage, name)
            setattr(self.ostage, name, self._wrap(name, part, self.saved[name]))
        self.saved["ba_cull_dispatch"] = self.lm.ba_cull_dispatch
        self.lm.ba_cull_dispatch = self._window(self.lm.ba_cull_dispatch)
        return self

    def __exit__(self, *exc):
        self.lm.ba_cull_dispatch = self.saved.pop("ba_cull_dispatch")
        for name, fn in self.saved.items():
            setattr(self.ostage, name, fn)


def drive_objects(world, texture, truths, dec, n, dev, probe):
    """Phase 10's run: the port's tracker over n stereo frames of the
    tilted-plane world, and at every keyframe the port's
    `MappingStage.process` with the frame's detections
    (`object_world.frame_detections`, 256 points and 512 rays each), as
    tests/tracking_driver.py's "objects" stage drives the JAX package.
    -> (tracker, keyframe count, culled slots, ObjectLog, [(probe record,
    (pre-state, host keyframe mask, ring cursors, job))] per keyframe)."""
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.system import detections as det_mod
    from dsp_slam_rgbd_tpu_torch.system import mapping_stage as mstage
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk

    cfg = tracking_config(world, "stereo")
    m = cfg.map
    tr = trk.Tracker(cfg, ms.empty(max_kf=m.max_kf, max_feat=m.max_feat, max_pts=m.max_pts,
                                   max_obj=m.max_obj, max_oobs=m.max_oobs, device=dev),
                     device=dev)
    kf_valid = np.zeros(m.max_kf, bool)
    stage = mstage.MappingStage(cfg, tr.state, kf_valid, decoder=dec)
    log, kfs, culled, n_kf = ow.ObjectLog(truths), [], [], 0
    for i in range(n):
        x = pw.gt_x(world, i)
        out = tr.track(pw.render_u8(world, texture, x),
                       img_right=pw.render_u8(world, texture, x + world.baseline),
                       timestamp=i * 0.1)[-1]
        if not out["new_kf"]:
            continue
        slot = int(ms.alloc_slots(kf_valid, 1)[0])
        if slot < 0:
            continue
        kf_valid[slot] = True
        dets, _ = ow.frame_detections(det_mod, world, truths, i, 256, 512)
        job = mstage.KFJob(frame=out["frame"], detections=dets, kf_slot=slot, kid=n_kf,
                           frame_id=out["fid"], timestamp=out["timestamp"])
        saved = (tr.state, kf_valid.copy(), dict(stage._oobs_cursor), job)
        stage.state = tr.state
        probe.rec = {"frame": i, "slot": slot, "detections": len(dets)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = stage.process(job)
        torch.cuda.synchronize()
        probe.rec["process_ms"] = (time.perf_counter() - t0) * 1e3
        log(i, res.state)
        culled += [c for c, _, _ in res.culled]
        tr.state = res.state
        n_kf += 1
        tr.last_kf_frame_id = out["fid"]
        if tr.ref_kf < 0:
            tr.ref_kf = slot
        kfs.append((probe.rec, saved))
    return tr, n_kf, culled, log, kfs


def time_f32_kernel(mlp_sdf, dec, kind, rows, n_obj, mem_bw, dev):
    """The f32 kernel (`csrc/mlp_sdf_f32.cu`) at `rows` rows of n_obj
    objects: held to its plain version (sdf 2e-5, Jacobian 2e-4 off ReLU
    near-tie rows), its time with the tiling the launcher picks and with
    each tiling forced, the plain version's, one f32 torch.matmul per
    layer product (TF32 off), the bound, and the rate at which its CTAs
    stream the weights from L2 (each tile reads each stream once, and the
    Jacobian's w0ᵀ block once per CTA)."""
    from dsp_slam_rgbd_tpu_torch.tools import ellipsoid

    wb = dec.packed(torch.float32)
    w0, W, _ = wb
    g = np.random.default_rng(rows)
    code_np = g.standard_normal((n_obj, 64))
    dirs = g.standard_normal((n_obj, rows // n_obj, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    xyz_np = dirs * ellipsoid.code_to_axes(code_np)[:, None] * g.uniform(0.8, 1.2, dirs.shape[:2] + (1,))
    code = torch.tensor(code_np, dtype=torch.float32, device=dev)
    xyz = torch.tensor(xyz_np, dtype=torch.float32, device=dev)
    jac = kind == "jacobian"
    tiles = dec.tiles(torch.float32, jacobian=jac)
    kern = functools.partial(mlp_sdf.sdf_and_input_jacobian_fused if jac
                             else mlp_sdf.sdf_value_fused, tiles=tiles)
    plain = mlp_sdf.sdf_and_input_jacobian_plain if jac else mlp_sdf.sdf_value_plain
    out_k, out_p = kern(wb, code, xyz), plain(wb, code, xyz)
    if jac:
        keep = mlp_sdf.relu_margin(wb, code, xyz) >= TIE
        check(float(keep.float().mean()) >= 0.9, f"f32 {kind} at {rows} rows: <=10% near-tie rows")
        err = max(float((out_k[0] - out_p[0]).abs().max()),
                  float((out_k[1] - out_p[1])[keep].abs().max()))
        check(float((out_k[1] - out_p[1])[keep].abs().max()) <= JAC_ATOL, f"f32 jacobian {err}")
    else:
        err = float((out_k - out_p).abs().max())
    check(float(((out_k[0] if jac else out_k) - (out_p[0] if jac else out_p)).abs().max())
          <= SDF_ATOL, f"f32 {kind} at {rows} rows: sdf {err}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off for the f32 library time")
    rand = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, 128, device=dev, generator=rand)
    h = torch.randn(rows, 512, device=dev, generator=rand)

    def library():       # the same products, one f32 torch.matmul each
        torch.matmul(x, w0)
        for i in range(8):
            torch.matmul(h, W[i])
        if jac:
            for i in range(8):
                torch.matmul(h, W[i].T)

    ms = cuda_ms(lambda: kern(wb, code, xyz), 10)
    bm, cluster = mlp_sdf.f32_tiling(kind, rows)
    tiling_ms = {}
    try:
        for t in mlp_sdf.F32_TILINGS:
            mlp_sdf.force_f32_tiling(t)
            tiling_ms[f"{t[0]}x{t[1]}"] = cuda_ms(lambda: kern(wb, code, xyz), 10)
    finally:
        mlp_sdf.force_f32_tiling(None)
    plain_ms = cuda_ms(lambda: plain(wb, code, xyz), 3)
    library_ms = cuda_ms(library, 10)
    tiles_n = -(-rows // bm)
    l2_bytes = tiles_n * 4 * (mlp_sdf.F32_VALUE_FLOATS + (
        mlp_sdf.F32_BACKWARD_FLOATS + (cluster - 1) * 512 * 128 if jac else 0))
    fwd_macs = sum(i * o for i, o in dec.spec.layer_dims())
    flops = 2.0 * fwd_macs * rows * (2 if jac else 1)
    io = (sum(t.numel() * 4 for t in wb) + code.numel() * 4 + xyz.numel() * 4
          + rows * 4 * (1 + (67 if jac else 0)))
    t_ops, t_bytes = flops / F32_PEAK * 1e3, io / mem_bw * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err, "rows": rows, "dtype": "f32", "tflops": flops / ms / 1e9,
            "tiling": f"{bm}x{cluster}", "tiling_ms": tiling_ms, "l2_bytes": l2_bytes,
            "l2_tb_per_s": l2_bytes / ms / 1e9}


def rot_angle(Ra, Rb):
    """Angle (rad) between two rotations, from their chordal distance
    (||Ra - Rb||_F = 2·sqrt(2)·sin(θ/2)), exact near 0 where arccos of
    the trace is not."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def object_stage_card_vs_cpu(saved, dec, dec_cpu, cfg, dev):
    """One keyframe's object stage (association, refinement of the
    associated objects, and one f32 GN iteration of the unmatched
    detections' reconstruction) on the card and on the CPU from the same
    state and detections -> (largest refined translation and rotation
    differences, largest recon pose and code differences)."""
    import dataclasses

    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig
    from dsp_slam_rgbd_tpu_torch.system import mapping_stage as mstage
    from dsp_slam_rgbd_tpu_torch.weights import (frame_from_numpy, frame_to_numpy,
                                                 map_state_from_numpy, map_state_to_numpy)

    pre, kv, cursors, job = saved
    cfg1 = dataclasses.replace(cfg, recon=ReconConfig(num_iterations=1))
    fields = map_state_to_numpy(lm.insert_keyframe(pre, job.frame, job.kf_slot, job.frame_id))
    frame_np = frame_to_numpy(job.frame)
    out = {}
    for where, d, decoder in (("card", dev, dec), ("cpu", torch.device("cpu"), dec_cpu)):
        stage = mstage.MappingStage(cfg1, map_state_from_numpy(fields, d), kv.copy(), decoder=decoder)
        stage._oobs_cursor = dict(cursors)
        pending = stage._object_stage(job.kf_slot, frame_from_numpy(frame_np, d), job.detections,
                                      None, job.kid)
        out[where] = (stage.state.oobs_t_co.cpu().numpy(), stage.state.oobs_valid.cpu().numpy(),
                      None if pending is None else
                      (pending[0].t_cam_obj.cpu().numpy(), pending[0].code.cpu().numpy()))
    (tc, vc, rc), (th, vh, rh) = out["card"], out["cpu"]
    check((vc == vh).all(), "the same object edges on the card and the CPU")
    live = np.nonzero(vc)[0]
    diff = {"refined_t_m": float(np.abs(tc[live, :3, 3] - th[live, :3, 3]).max()),
            "refined_rot_rad": max(rot_angle(tc[q, :3, :3], th[q, :3, :3]) for q in live),
            "edges": int(len(live))}
    if rc is not None:
        diff.update(recon_pose=float(np.abs(rc[0] - rh[0]).max()),
                    recon_code=float(np.abs(rc[1] - rh[1]).max()), recon_objects=len(rc[0]))
    return diff


def objects_phase(dev, smi, mem_bw):
    """Phase 10: the port's `MappingStage.process` on every keyframe of the
    KITTI-size stereo world with 8 objects (see the module docstring) ->
    (the report's "objects" entry, the f32 kernels' JSON entries, (the final
    map, the run's configuration, the last frame's T_cw) for phase 13c)."""
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.system import mapping_stage as mstage
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw

    t_phase = time.perf_counter()
    world = pw.KITTI
    texture = pw.make_texture(world)
    truths = ow.kitti_objects(0)
    dec = deepsdf.load_npz(FIXTURE, device=dev)
    dec_cpu = deepsdf.load_npz(FIXTURE, device="cpu")
    n = 24
    mlp_sdf.reset_launch_counts()
    with StageProbe() as probe:
        tr, n_kf, culled, log, kfs = drive_objects(world, texture, truths, dec, n, dev, probe)
    launches = dict(mlp_sdf.LAUNCHES)
    ok = np.array([bool(o) for _, _, o in tr.trajectory])
    T = np.stack([p.cpu().numpy() for _, p, _ in tr.trajectory]).astype(np.float64)
    gt = np.array([pw.gt_x(world, int(round(ts / 0.1))) for ts, _, _ in tr.trajectory])
    err = np.abs(-T[:, 0, 3] - gt)
    max_err = float(err[ok].max()) if ok.any() else float("inf")
    summ = log.summary()
    statics = [s for s in summ["slots"] if not s["truth_dynamic"]]
    movers = [s for s in summ["slots"] if s["truth_dynamic"]]
    windows = [r["ba_counts"] for r, _ in kfs[1:]]
    rep = {"card": smi, "frames": n, "ok_share": float(ok.mean()), "keyframes": n_kf,
           "culled": culled, "max_t_err_m": max_err, "band_m": OBJECTS_BAND, "objects": summ,
           "decoder_kernel_launches": launches, "per_keyframe": [r for r, _ in kfs],
           "jax_cpu": JAX_OBJECTS}
    check(len(ok) == n and ok.mean() >= 0.9 and np.isfinite(T).all() and max_err < OBJECTS_BAND,
          f"10 camera: ok {ok.mean()}, largest error {max_err}")
    check(summ["valid"] == 8 and summ["identities_kept"], f"10 objects: {summ}")
    check(all(s["center_err_m"] < 0.3 and not s["dynamic"] for s in statics) and len(statics) == 7,
          f"10 static objects within 0.3 m, none dynamic: {statics}")
    check(len(movers) == 1 and movers[0]["dynamic"], f"10 the mover is dynamic: {movers}")
    check(max(w[3] for w in windows) > 0 and max(w[4] for w in windows) > 0,
          f"10 object edges in the BA windows: {windows}")
    check(launches["mlp_sdf_value_f32"] > 0 and launches["mlp_sdf_jacobian_f32"] > 0
          and launches["mlp_sdf_value"] == launches["mlp_sdf_jacobian"] == 0,
          f"10 both f32 kernels, and no bf16 one, launched in the SLAM loop: {launches}")
    print(f"phase 10 objects (KITTI stereo, {n} frames, 8 objects, 256 points and 512 rays a "
          f"detection, ReconConfig() f32): ok {ok.mean():.3f}, {n_kf} keyframes (JAX "
          f"{JAX_OBJECTS['keyframes']}), culled {culled} (JAX {JAX_OBJECTS['culled']}), largest "
          f"translation error {max_err:.6f} m (JAX {JAX_OBJECTS['max_t_err_m']}, band "
          f"{OBJECTS_BAND}); objects valid {summ['valid']}, identities kept "
          f"{summ['identities_kept']}; " + ", ".join(
              f"slot {s['slot']} truth {s['truth']}: center error {s['center_err_m']:.4f} m "
              f"(JAX {JAX_OBJECTS['center_err_m'][s['truth']]}), dynamic {s['dynamic']} (JAX "
              f"{JAX_OBJECTS['dynamic'][s['truth']]})" for s in summ["slots"])
          + f"; decoder kernels launched {launches} on {smi}", flush=True)
    for r, _ in kfs:
        parts = ", ".join(f"{p} {r[p]['ms']:.1f} ms ({r[p]['value']} value + {r[p]['jacobian']} "
                          f"jacobian launches)" for p in ("association", "refinement",
                                                          "new_objects", "insertion") if p in r)
        print(f"phase 10 keyframe at frame {r['frame']} (slot {r['slot']}, {r['detections']} "
              f"detections): process {r['process_ms']:.1f} ms; {parts}; BA window "
              f"{r['ba_counts']}", flush=True)

    # ---- one keyframe again, from its saved state: syncs, trace, card vs CPU
    both = [(r, sv) for r, sv in kfs if "refinement" in r and "new_objects" in r]
    rec, saved = (both or [(r, sv) for r, sv in kfs if "refinement" in r] or kfs)[-1]
    pre, kv, cursors, job = saved

    def replay():
        stage = mstage.MappingStage(tr.cfg, pre, kv.copy(), decoder=dec)
        stage._oobs_cursor = dict(cursors)
        stage.process(job)
        torch.cuda.synchronize()

    replay()
    t0 = time.perf_counter()
    replay()
    untraced = (time.perf_counter() - t0) * 1e3
    syncs = count_syncs(replay)
    n_kern, busy, top = traced(replay, top=5)
    check(busy > 0, "the profiler saw device time in a keyframe stage with objects")
    vs = object_stage_card_vs_cpu(saved, dec, dec_cpu, tr.cfg, dev)
    check(vs["refined_t_m"] <= 1e-3 and vs["refined_rot_rad"] <= 1e-3,
          f"10 refined poses card vs CPU: {vs}")
    check("recon_pose" not in vs or max(vs["recon_pose"], vs["recon_code"]) <= 2e-3,
          f"10 one GN iteration of the new objects card vs CPU: {vs}")
    rep["replay"] = {"frame": rec["frame"], "process_ms_untraced": untraced, "host_syncs": syncs,
                     "launches": n_kern, "busy_ms": busy, "idle_share": 1.0 - busy / untraced,
                     "top_kernels": top, "card_vs_cpu": vs}
    print(f"phase 10 one keyframe again (frame {rec['frame']}): process {untraced:.1f} ms "
          f"untraced, {syncs} host syncs, {n_kern} launches, busy {busy:.2f} ms (idle share "
          f"{1.0 - busy / untraced:.3f}); top: " + ", ".join(f"{k} {v:.2f} ms" for k, v in top)
          + f"; card vs CPU {vs} on {smi}", flush=True)

    # ---- the f32 kernels at this phase's row counts
    U = max(r.get("U_rows", 0) for r, _ in kfs)
    A = max(r.get("A_rows", 0) for r, _ in kfs)
    check(U > 0 and A > 0, f"10 new and associated objects in the run: U {U}, A {A}")
    cfg = tr.cfg.recon
    times = {"value_render": time_f32_kernel(mlp_sdf, dec, "value", U * cfg.max_valid_samples, U,
                                             mem_bw, dev),
             "value_bbox": time_f32_kernel(mlp_sdf, dec, "value", U * 24 ** 3, U, mem_bw, dev),
             "jacobian_render": time_f32_kernel(mlp_sdf, dec, "jacobian", U * cfg.max_grad_points,
                                                U, mem_bw, dev),
             "jacobian_refine": time_f32_kernel(mlp_sdf, dec, "jacobian", A * 256, A, mem_bw, dev)}
    rep["f32_timing"] = times
    for label, t in times.items():
        print(f"phase 10 f32 timing {label}: rows {t['rows']} kernel {t['ms']:.3f} ms at "
              f"{t['tiling']} ({t['tflops']:.1f} TFLOP/s; rows x cluster: " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in t["tiling_ms"].items())
              + f"), plain {t['plain_ms']:.3f} ms, torch.matmul f32 {t['library_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), weights from L2 "
              f"{t['l2_bytes'] / 1e9:.3f} GB = {t['l2_tb_per_s']:.2f} TB/s, max_abs_err "
              f"{t['max_abs_err']:.3g} on {smi}", flush=True)
    rep["mono"] = mono_phase(dev, dec, dec_cpu, smi)
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 10 took {rep['phase_s']:.0f} s", flush=True)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "rows",
            "dtype", "tiling")
    kernels = [
        dict(name="mlp_sdf_value_f32", route="cuda",
             source="dsp_slam_rgbd_tpu_torch/csrc/mlp_sdf_f32.cu",
             replaces="dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:237",
             launches=launches["mlp_sdf_value_f32"],
             **{k: v for k, v in times["value_render"].items() if k in keys},
             small={k: v for k, v in times["value_bbox"].items() if k in keys}),
        dict(name="mlp_sdf_jacobian_f32", route="cuda",
             source="dsp_slam_rgbd_tpu_torch/csrc/mlp_sdf_f32.cu",
             replaces="dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:159",
             launches=launches["mlp_sdf_jacobian_f32"],
             **{k: v for k, v in times["jacobian_render"].items() if k in keys},
             small={k: v for k, v in times["jacobian_refine"].items() if k in keys}),
    ]
    return rep, kernels, (tr.state, tr.cfg, tr.last_frame.t_cw)


def mono_phase(dev, dec, dec_cpu, smi):
    """Phase 10c: the mono object pipeline over the 21 keyframes of
    tests/test_mono_objects.py's hand-built map (`object_world.mono_*`,
    an ellipsoid of the fixture family), on the card and on the CPU: the
    object is recovered on both (valid, reconstructed at keyframes 15 and
    20, >90% of its surface points owned and no clutter, its center within
    0.3 of the largest true semi-axis), and the card holds to the CPU
    keyframe by keyframe: the same ownership, associations and flags, the
    pose within 1e-3 up to the 180° turn about the object's y axis that
    the PCA cuboid's eigenvector sign allows, and after the second fit
    (keyframe 20, 6 f32 iterations from first fits 2.7e-4 apart) within
    0.05 m, the band of tests/test_torch_recon.py's full fits."""
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig
    from dsp_slam_rgbd_tpu_torch.system import mono_objects
    from dsp_slam_rgbd_tpu_torch.system.detections import MonoDetection
    from dsp_slam_rgbd_tpu_torch.tools import ellipsoid
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow
    from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy, map_state_to_numpy

    cfg = ReconConfig(**MONO_RECON)
    fx, fy, cx, cy = ow.MONO_CAM
    cam = Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, bf=100.0)
    pts, truth = ow.mono_world(3)
    P = len(pts)
    runs = {}
    for where, d, decoder in (("card", dev, dec), ("cpu", torch.device("cpu"), dec_cpu)):
        st = ms.empty(max_kf=23, max_feat=P, max_pts=P + 16, max_obj=4, max_oobs=64, device=d)
        f = ow.mono_fields(map_state_to_numpy(st), pts)
        rng = np.random.default_rng(3)
        per_kf, n_obs = [], 0
        t0 = time.perf_counter()
        for i in range(21):
            f = ow.mono_keyframe(f, i, 0.08 * i)
            st = map_state_from_numpy(f, d)
            kp, bg = ow.mono_detection_inputs(rng)
            dets = [MonoDetection(kp, bg, True)]
            st, assoc = mono_objects.associate_by_projection(st, i, dets)
            st, assoc = mono_objects.create_new_objects(st, i, dets, assoc, kfseq=i)
            st, obs = mono_objects.process_detected_objects(st, cam, cfg, decoder, i, i, dets,
                                                            assoc)
            n_obs += len(obs)
            f = map_state_to_numpy(st)
            per_kf.append((assoc.tolist(), f["pt_object"].copy(), f["obj_valid"].copy(),
                           f["obj_recon"].copy(), f["obj_pose"][0].copy()))
        runs[where] = (per_kf, n_obs, f, (time.perf_counter() - t0) * 1e3)
    (kc, nc, fc, ms_c), (kh, nh, fh, ms_h) = runs["card"], runs["cpu"]
    turn = np.diag([-1.0, 1.0, -1.0])
    diffs = []   # per keyframe: (translation, rotation up to the turn, turned?)
    for a, b in zip(kc, kh):
        check(a[0] == b[0] and (a[1] == b[1]).all() and (a[2] == b[2]).all() and (a[3] == b[3]).all(),
              "10c the same associations, ownership and flags on the card and the CPU")
        R, Rh = a[4][:3, :3], b[4][:3, :3]
        d0, d1 = np.abs(R - Rh).max(), np.abs(R - Rh @ turn).max()
        diffs.append((float(np.abs(a[4][:3, 3] - b[4][:3, 3]).max()), float(min(d0, d1)),
                      bool(d1 < d0)))
    # up to the second reconstruction (keyframe 20) the 1e-3 band; that
    # fit starts from two first fits 2.7e-4 apart and its 6 f32 iterations
    # part by ~1e-2 (the chaotic loop), so it is held to the 0.05 m band of
    # tests/test_torch_recon.py's full fits
    pose_diff = max(max(t, r) for t, r, _ in diffs[:20])
    last_diff = max(diffs[20][:2])
    po = fc["pt_object"]
    center_err = float(np.linalg.norm(fc["obj_pose"][0][:3, 3] - truth.center))
    reach = 0.3 * ow.MONO_SCALE * ellipsoid.code_to_axes(truth.code).max()
    rep = {"observations": nc, "recon": bool(fc["obj_recon"][0]),
           "surface_owned": float((po[:ow.N_SURFACE] == 0).mean()),
           "clutter_owned": int((po[ow.N_SURFACE:P] == 0).sum()), "center_err_m": center_err,
           "center_band_m": float(reach), "scale": float(fc["obj_scale"][0]),
           "card_vs_cpu_pose": pose_diff, "card_vs_cpu_last": last_diff,
           "card_vs_cpu_per_keyframe": diffs, "card_ms": ms_c, "cpu_ms": ms_h, "card": smi}
    cpu_err = float(np.linalg.norm(fh["obj_pose"][0][:3, 3] - truth.center))
    check(nc == nh == 2 and rep["recon"] and rep["surface_owned"] > 0.9
          and rep["clutter_owned"] == 0 and max(center_err, cpu_err) < reach,
          f"10c mono object recovered on the card and the CPU: {rep}, CPU {cpu_err}")
    check(pose_diff <= 1e-3 and last_diff <= 0.05, f"10c mono card vs CPU pose up to the turn: "
          f"{pose_diff} to keyframe 19, {last_diff} at 20; per keyframe (translation, "
          f"rotation, turned): {diffs}")
    print(f"phase 10c mono objects (21 keyframes, fixture decoder): {nc} reconstructions, surface "
          f"owned {rep['surface_owned']:.3f}, clutter owned {rep['clutter_owned']}, center error "
          f"{center_err:.4f} m (CPU {cpu_err:.4f}, band {reach:.3f}), scale {rep['scale']:.3f} "
          f"(true {ow.MONO_SCALE}); card vs CPU pose {pose_diff:.3g} to keyframe 19 and "
          f"{last_diff:.3g} after the second fit, up to the turn (PCA seeds turned on "
          f"{sum(t for _, _, t in diffs)} keyframes); {ms_c:.0f} ms on the card, {ms_h:.0f} ms "
          f"on the CPU on {smi}", flush=True)
    return rep



# ---------------------------------------------------------------------------
# phase 11: monocular initialization and loop closing
# ---------------------------------------------------------------------------
# the JAX package's mono tracker with the keyframe stage on the bare KITTI plane
# (`plane_world.KITTI`, the wall without its floor), 11a's 14 frames, OrbConfig() and
# phase 8's configuration, on the CPU (`JAX_PLATFORMS=cpu python tests/tracking_driver.py
# mono-plane`): it never initializes (a single plane leaves the homography's two motions
# to choose from), so no frame is tracked, no keyframe made, and no ATE
JAX_MONO_PLANE = {"init_frame": -1, "ok_share": 0.0, "ate_m": None, "keyframes": 0}
# 11a's bars on the bare plane against JAX_MONO_PLANE, when it initializes: the first
# tracked frame within this many frames of JAX's, the ATE within 1.5x JAX's
MONO_PLANE_FRAMES, MONO_PLANE_BAND = 2, 1.5


def _timed(fn, times, name):
    """fn wrapped to append its synchronized wall ms to times[name]."""
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def with_syncs(fn, sites=None):
    """(fn(), host syncs of that call); `sites` as for `count_syncs`."""
    out = []
    n = count_syncs(lambda: out.append(fn()), sites)
    return out[0], n


def aliased_descriptors(rng, n_train=110_000, n_kf=100, per_kf=256):
    """tests/test_vocab_scale.py's training set: 100 keyframes of 256
    descriptors, half from one shared texture pool, half place-specific
    (60 places, KFs 60..99 revisit 0..39), each with 6 bits flipped, then
    random descriptors up to n_train."""
    def rand(n):
        return rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)

    def perturb(d, bits=6):
        d = d.copy()
        for _ in range(bits):
            d[np.arange(len(d)), rng.integers(0, 8, len(d))] ^= \
                np.uint32(1) << rng.integers(0, 32, len(d)).astype(np.uint32)
        return d

    pool = rand(2000)
    place = [rand(per_kf // 2) for _ in range(60)]
    kfs = [np.concatenate([perturb(pool[rng.choice(2000, per_kf // 2, replace=False)]),
                           perturb(place[k if k < 60 else k - 60])]) for k in range(n_kf)]
    return np.concatenate(kfs + [rand(n_train - n_kf * per_kf)])


def mono_plane_step(dev, smi, n=14):
    """11a on the bare KITTI plane: the mono tracker with the keyframe stage
    over `plane_world.KITTI`'s first n frames, held to JAX_MONO_PLANE."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import tracking_driver as td
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.system import mapping_stage as mstage
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk

    t0 = time.perf_counter()
    tr_p, n_kf_p, _ = td.drive(ms, lm, trk, tracking_config(pw.KITTI, "mono"),
                               td.frames(pw.KITTI, pw.make_texture(pw.KITTI), "mono", n, u8=True),
                               code_len=64, stage="mono", objects=td.loop_inputs(mstage, True),
                               device=dev)
    torch.cuda.synchronize()
    plane = dict(td.mono_outcome(pw.KITTI, tr_p.trajectory, n), keyframes=n_kf_p,
                 s=time.perf_counter() - t0)
    jp = JAX_MONO_PLANE
    if jp["init_frame"] < 0:
        check(plane["init_frame"] < 0 and n_kf_p == 0,
              f"11a bare KITTI plane: no initialization, as the JAX package's {jp}: {plane}")
    else:
        check(plane["init_frame"] >= 0
              and abs(plane["init_frame"] - jp["init_frame"]) <= MONO_PLANE_FRAMES
              and plane["ate_m"] is not None and plane["ate_m"] <= MONO_PLANE_BAND * jp["ate_m"],
              f"11a bare KITTI plane: initialized within {MONO_PLANE_FRAMES} frames of the JAX "
              f"package's, ATE within {MONO_PLANE_BAND}x: {plane} against {jp}")
    print(f"phase 11a mono on the bare KITTI plane (plane_world.KITTI, no floor, {n} frames): "
          f"initialized at frame {plane['init_frame']} (JAX on the CPU: {jp['init_frame']}; -1 "
          f"is never), ok {plane['ok_share']:.3f}, {n_kf_p} keyframes, ATE {plane['ate_m']} m "
          f"(JAX {jp['ate_m']}); {plane['s']:.1f} s on {smi}", flush=True)
    return plane


def loop_phase(dev, smi):
    """Phase 11 (see the module docstring) -> the report's "loop" entry."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import tracking_driver as td
    from dsp_slam_rgbd_tpu_torch.loop import keyframe_db, loop_closing, vocabulary
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms
    from dsp_slam_rgbd_tpu_torch.ops import lie
    from dsp_slam_rgbd_tpu_torch.solvers import initializer as init_mod
    from dsp_slam_rgbd_tpu_torch.solvers import sim3
    from dsp_slam_rgbd_tpu_torch.system import mapping_stage as mstage
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tools import revisit_map
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk
    from dsp_slam_rgbd_tpu_torch.weights import (bow_database_from_numpy,
                                                 map_state_from_numpy)

    t_phase = time.perf_counter()
    rep = {"card": smi}

    # ---- 11a. mono: H/F initialization, _insert_mono_init, the keyframe stage
    world = pw.KITTI_FLOOR
    cfg_m = tracking_config(world, "mono")
    n = 14
    tex_m = pw.make_texture(world)
    seq = td.frames(world, tex_m, "mono", n, u8=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr, n_kf, culled = td.drive(ms, lm, trk, cfg_m, seq, code_len=64, stage="mono",
                                objects=td.loop_inputs(mstage, True), device=dev)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    ok = np.array([bool(o) for _, _, o in tr.trajectory])
    T = torch.stack([p for _, p, o in tr.trajectory if o]) if ok.any() else None
    gt = torch.tensor([[round(ts / 0.1) * world.step, 0.0, 0.0]
                       for ts, _, o in tr.trajectory if o], device=dev)
    ate = float(sim3.align_trajectories(lie.inv_se3(T)[:, :3, 3], gt)[1]) if T is not None \
        else float("inf")
    path = float(gt[-1, 0] - gt[0, 0]) if T is not None else 0.0
    # the trajectory starts at the initializing frame
    init_frame = int(round(tr.trajectory[int(np.argmax(ok))][0] / 0.1)) if ok.any() else -1
    check(init_frame >= 1, f"11a mono initialized: {ok}")
    # the same frames again on a fresh tracker (the same CPU draws): the
    # initializing step whole (extraction included), its host syncs by the
    # line that makes them, and the RANSAC (draw + evaluation) alone
    tr2 = trk.Tracker(cfg_m, tr.state, device=dev)
    for i in range(init_frame):
        tr2.track(seq[i][0], timestamp=i * 0.1)
    init_sites = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2, init_syncs = with_syncs(lambda: tr2.track(seq[init_frame][0],
                                                    timestamp=init_frame * 0.1)[-1], init_sites)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    check(out2["ok"], "11a the initialization again on a fresh tracker")
    m, f_init = tr2.init_result["matches"], tr2.init_result["cur_frame"]
    uv1, uv2 = tr2.init_ref.feats.xy, f_init.feats.xy[torch.clamp_min(m.idx, 0)]
    ransac = lambda: init_mod.initialize(cfg_m.cam, uv1, uv2, m.valid,  # noqa: E731
                                         torch.Generator().manual_seed(0))
    ransac_ms = wall_ms(ransac, 3)
    ransac_sites = {}
    ransac_syncs = count_syncs(ransac, ransac_sites)
    one_ms = wall_ms(lambda: tr2._mono_init(f_init), 3)   # host-read inclusive
    frame_syncs = count_syncs(lambda: tr.track(pw.render_u8(world, tex_m, pw.gt_x(world, n)),
                                               timestamp=n * 0.1))
    rep["mono"] = {"world": "KITTI_FLOOR: 1241x376, wall 18 m away on a floor 1.65 m below, "
                            "0.54 m a frame", "features": cfg_m.orb.n_features, "frames": n,
                   "matches": int(torch.sum(m.valid)), "ok_share": float(ok.sum() / n),
                   "keyframes": n_kf, "init_frame": init_frame, "ate_m": ate, "path_m": path,
                   "ms_per_frame": run_ms / n, "init_step_ms": init_ms,
                   "init_step_ms_mean3": one_ms, "init_ransac_ms": ransac_ms,
                   "init_host_syncs": init_syncs, "init_sync_sites": init_sites,
                   "ransac_host_syncs": ransac_syncs, "ransac_sync_sites": ransac_sites,
                   "frame_host_syncs": frame_syncs}
    check(ok.sum() >= 0.6 * n and n_kf >= 2 and ate < 0.08 * path,
          f"11a mono: {rep['mono']}")
    print(f"phase 11a mono (KITTI_FLOOR 1241x376, OrbConfig() {cfg_m.orb.n_features} features, "
          f"phase 8's MapConfig, {n} frames): initialized at frame {init_frame} from "
          f"{int(torch.sum(m.valid))} matches, ok {ok.sum() / n:.3f}, {n_kf} keyframes, Sim(3)-"
          f"aligned ATE {ate:.4f} m of a {path:.2f} m path; {run_ms / n:.1f} ms per frame with "
          f"the keyframe stage; the initialization step {init_ms:.1f} ms ({init_syncs} host "
          f"syncs; {one_ms:.1f} ms mean of 3), its RANSAC alone {ransac_ms:.1f} ms "
          f"({ransac_syncs} host syncs: {ransac_sites}); the step's syncs by line: "
          f"{init_sites}; {frame_syncs} host syncs in a tracking frame on {smi}", flush=True)

    # ---- 11a on the bare KITTI plane, held to the JAX package's outcome there
    rep["mono_plane"] = mono_plane_step(dev, smi, n)

    # ---- vocabulary: depth 4, branching 10, trained here
    t0 = time.perf_counter()
    vocab = vocabulary.train(aliased_descriptors(np.random.default_rng(7)), branching=10,
                             depth=4, seed=0, device=dev)
    rep["vocab_train_s"] = time.perf_counter() - t0

    # ---- 11b. the stereo sequence with loop detection at every keyframe
    kworld = pw.KITTI
    texture = pw.make_texture(kworld)
    cfg_s = tracking_config(kworld, "stereo")
    times = {}

    def timed_stage(cfg, state, kv):
        mp = mstage.MappingStage(cfg, state, kv, vocab=vocab)
        for name in ("_update_bow", "_loop_stage", "process"):
            setattr(mp, name, _timed(getattr(mp, name), times, name))
        return mp

    inputs = td.loop_inputs(mstage, True, vocab=vocab)
    inputs["stage"] = timed_stage
    tr, n_kf, culled = td.drive(ms, lm, trk, cfg_s, td.frames(kworld, texture, "stereo", 24,
                                                               u8=True),
                                code_len=64, stage="loop", objects=inputs, device=dev)
    mp = tr.mapping
    ok = np.array([bool(o) for _, _, o in tr.trajectory])
    Tn = np.stack([p.cpu().numpy() for _, p, _ in tr.trajectory]).astype(np.float64)
    err = np.abs(-Tn[:, 0, 3] - np.array([pw.gt_x(kworld, i) for i in range(len(Tn))]))
    db_ok = np.array_equal(mp.db.kf_valid.cpu().numpy(), mp.kf_valid_host)
    slot = int(np.flatnonzero(mp.kf_valid_host)[-1])
    fid = int(mp.state.kf_frame_id[slot])
    bow_launches, bow_busy = traced(lambda: mp._update_bow(slot))
    _, bow_syncs = with_syncs(lambda: mp._update_bow(slot))
    loop_launches, loop_busy = traced(lambda: mp._loop_stage(slot, n_kf - 1, fid))
    _, loop_syncs = with_syncs(lambda: mp._loop_stage(slot, n_kf - 1, fid))
    rep["stereo_loop"] = {"keyframes": n_kf, "culled": culled, "ok_share": float(ok.mean()),
                          "max_t_err_m": float(err[ok].max()), "loop_closures": mp.loop_closures,
                          "db_matches_keyframes": db_ok,
                          "update_bow_ms": times.get("_update_bow", []),
                          "loop_stage_ms": times.get("_loop_stage", []),
                          "process_ms": times.get("process", []),
                          "update_bow_launches": bow_launches, "update_bow_busy_ms": bow_busy,
                          "update_bow_host_syncs": bow_syncs,
                          "loop_stage_launches": loop_launches, "loop_stage_busy_ms": loop_busy,
                          "loop_stage_host_syncs": loop_syncs,
                          "vocab_train_s": rep["vocab_train_s"]}
    check(mp.loop_closures == 0 and db_ok and len(culled) >= 1 and ok.mean() >= 0.9
          and float(err[ok].max()) < STEREO_BAND, f"11b stereo loop stage: {rep['stereo_loop']}")
    lms = times.get("_loop_stage", [])
    print(f"phase 11b stereo KITTI, 24 frames, MappingStage(vocab=10^4 words, trained in "
          f"{rep['vocab_train_s']:.1f} s): {n_kf} keyframes, culled {culled} (purged from the "
          f"database: {db_ok}), {mp.loop_closures} loop closures, largest error "
          f"{float(err[ok].max()):.4f} m; per keyframe _update_bow median "
          f"{_median(times.get('_update_bow', [])):.2f} ms, _loop_stage median {_median(lms):.2f} "
          f"ms ({len(lms)} calls), process median "
          f"{_median(times.get('process', [])):.1f} ms; on the last keyframe _update_bow "
          f"{bow_launches} launches / {bow_syncs} host syncs, _loop_stage {loop_launches} "
          f"launches (busy {loop_busy:.2f} ms) / {loop_syncs} host syncs on {smi}", flush=True)

    # ---- 11c. a loop closes on the revisit map at phase 8's capacity
    cam_k = cfg_s.cam
    fields, _ = revisit_map.build_revisit_state(
        np.random.default_rng(0), n_pts=2000, max_kf=48, max_feat=2048, max_pts=32768,
        max_obj=8, cam=(cam_k.fx, cam_k.fy, cam_k.cx, cam_k.cy))
    vocab_cpu = vocabulary.Vocabulary(tuple(c.cpu() for c in vocab.centroids), vocab.branching,
                                      vocab.depth)

    def close_loop(d, voc):
        """The revisit map's returning keyframes through `_loop_stage` (3
        consecutive detections, closing on the 4th) -> (stage, initial
        state, the closing call's result)."""
        st0 = map_state_from_numpy(fields, d)
        kv = np.zeros(48, bool)
        kv[:8] = True
        mpc = mstage.MappingStage(cfg_s, st0, kv, vocab=voc)
        for k in range(8):
            mpc._update_bow(k)
        out = None
        for q, f in ((5, 30), (6, 34), (7, 38), (7, 38)):
            out = mpc._loop_stage(q, 7, f)
        return mpc, st0, out

    patched = {(loop_closing, "compute_loop_sim3"), (loop_closing, "correct_loop"),
               (loop_closing, "fuse_duplicate_points"), (lm, "global_ba_step")}
    originals = {(mod, name): getattr(mod, name) for mod, name in patched}
    # the whole sequence's launches and busy ms: this thread's, from a trace of
    # the card's activity only (as phase 16 counts `correct_loop`'s), taken
    # after phase 16 (`late_traces`).  A trace of the host's ops over its
    # ~80,000 launches took the tracer ~100 s; and with a trace of the card's
    # activity only here, the process's first, 12a's traced frame (the worker
    # launching on its own thread) ended in a segmentation fault on an H100
    seconds = {}
    t0 = time.perf_counter()
    close_loop(dev, vocab)   # warms up
    seconds["warm"] = time.perf_counter() - t0
    LATE_TRACES["11c"] = lambda: stream_launches(lambda: close_loop(dev, vocab), dev)
    t0 = time.perf_counter()
    (_, _, _), closing_syncs = with_syncs(lambda: close_loop(dev, vocab))
    seconds["syncs"] = time.perf_counter() - t0
    parts = {}
    t0 = time.perf_counter()
    try:
        for mod, name in patched:
            setattr(mod, name, _timed(originals[(mod, name)], parts, name))
        mpc, st0, remap = close_loop(dev, vocab)
    finally:
        for (mod, name), f in originals.items():
            setattr(mod, name, f)
    seconds["timed"] = time.perf_counter() - t0
    closed_poses = mpc.state.kf_pose.cpu()
    gba_left = mpc._gba_iters_left
    drains = 0
    while mpc._gba_iters_left > 0 and drains <= 10:
        mpc._drain_gba_budget()
        drains += 1
    e_before = float(torch.linalg.vector_norm(lie.log_se3(st0.kf_pose[7] @ lie.inv_se3(
        st0.kf_pose[0]))))
    e_after = float(torch.linalg.vector_norm(lie.log_se3(mpc.state.kf_pose[7] @ lie.inv_se3(
        mpc.state.kf_pose[0]))))
    # the card against the CPU, the same draws (the CPU generator)
    t0 = time.perf_counter()
    mcpu, _, remap_cpu = close_loop(torch.device("cpu"), vocab_cpu)
    seconds["cpu"] = time.perf_counter() - t0
    pose_diff = float((closed_poses - mcpu.state.kf_pose).abs().max())
    fused = int((remap.cpu() != torch.arange(remap.shape[0])).sum()) if remap is not None else 0
    fused_cpu = int((remap_cpu != torch.arange(remap_cpu.shape[0])).sum()) \
        if remap_cpu is not None else 0
    rep["loop_close"] = {"closures": mpc.loop_closures, "gba_iters_left": gba_left,
                         "drains": drains, "kf7_err_before": e_before, "kf7_err_after": e_after,
                         "fused_points": fused, "fused_points_cpu": fused_cpu,
                         "card_vs_cpu_pose_diff": pose_diff,
                         "ms": {k: v for k, v in parts.items()},
                         "sequence_host_syncs": closing_syncs, "seconds": seconds}
    check(mpc.loop_closures >= 1 and 0 < gba_left < 10 and drains <= 10
          and mpc._gba_iters_left == 0 and e_after < 0.6 * e_before
          and mcpu.loop_closures >= 1 and fused == fused_cpu
          and pose_diff < 1e-3, f"11c loop closes: {rep['loop_close']}")
    print(f"phase 11c revisit map (8 keyframes, 2,000 points a side, capacity 48 / 2,048 / "
          f"32,768): {mpc.loop_closures} closure, global-BA budget left {gba_left} drained in "
          f"{drains} slices, KF7 error against KF0 {e_before:.4f} -> {e_after:.4f}, "
          f"{fused} points fused (CPU {fused_cpu}), card vs CPU poses {pose_diff:.2e}; ms: "
          + ", ".join(f"{k} {np.mean(v):.1f}" for k, v in parts.items())
          + f"; the whole sequence (upload, 8 BoW updates, 4 _loop_stage calls): "
          f"{closing_syncs} host syncs (launches traced after phase 16); s by run {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())} on {smi}",
          flush=True)

    # ---- 11d. retrieval at KITTI-00 capacity
    K = 2048
    fields_r, db_r = revisit_map.random_retrieval_map(np.random.default_rng(2), K, 1024,
                                                      300_000, 1200, 150_000, 200, 1024)
    st_r = map_state_from_numpy(fields_r, dev)
    db = bow_database_from_numpy(db_r, dev)
    del fields_r
    out = mstage._loop_candidates_device(st_r, db, 1100, 10_000, 8).cpu()
    check(tuple(out.shape) == (2 + 8, 8 + K), f"11d packed matrix shape {tuple(out.shape)}")
    q_ms = wall_ms(lambda: [mstage._loop_candidates_device(st_r, db, q, 10_000, 8).cpu()
                            for q in (900, 1000, 1150)], 1) / 3
    q_syncs = [with_syncs(lambda: mstage._loop_candidates_device(st_r, db, q, 10_000,
                                                                 8).cpu())[1]
               for q in (900, 1000, 1150)]
    r_ms = wall_ms(lambda: [keyframe_db.detect_reloc_candidates_grouped(
        db, db.bow[q], st_r, top_l=5)[0].cpu() for q in (900, 1000, 1150)], 1) / 3
    q_launches, q_busy = traced(lambda: mstage._loop_candidates_device(st_r, db, 1000, 10_000,
                                                                       8).cpu())
    rep["retrieval_kitti00"] = {"loop_candidates_ms": q_ms, "reloc_candidates_ms": r_ms,
                                "host_syncs_per_query": q_syncs, "launches": q_launches,
                                "busy_ms": q_busy}
    check(q_syncs == [1, 1, 1], f"11d one host read per query: {q_syncs}")
    print(f"phase 11d retrieval at KITTI-00 capacity (2,048 keyframe slots / 1,200 live, "
          f"300,000 point slots / 150,000 live, 1,024 words): _loop_candidates_device "
          f"{q_ms:.2f} ms per query (mean of 3, {q_launches} launches, busy {q_busy:.2f} ms, "
          f"{q_syncs} host reads), detect_reloc_candidates_grouped {r_ms:.2f} ms on {smi}",
          flush=True)
    del st_r, db

    # ---- 11e. BoW relocalization on the stereo world
    seq_r, frame_of = td.reloc_frames(kworld, texture)
    calls = []
    inputs = td.loop_inputs(mstage, True, vocab=vocab)
    hook = inputs["reloc"]
    inputs["reloc"] = lambda *a: (lambda f: calls.append(list(hook(*a)(f))) or calls[-1])
    tr, n_kf, _ = td.drive(ms, lm, trk, cfg_s, seq_r, code_len=64, stage="reloc",
                           objects=inputs, device=dev)
    ok = [bool(o) for _, _, o in tr.trajectory]
    back = [i for i in range(8, len(seq_r)) if ok[i]]
    est_x = -float(tr.trajectory[back[0]][1][0, 3]) if back else float("nan")
    rep["reloc"] = {"ok": ok, "keyframes": n_kf, "candidates": calls,
                    "recovered_frame": back[0] if back else -1,
                    "x_err_m": abs(est_x - pw.gt_x(kworld, frame_of[back[0]])) if back else None}
    check(all(ok[:6]) and not ok[6] and not ok[7] and back and any(calls)
          and rep["reloc"]["x_err_m"] < 0.08 and tr.status == "OK", f"11e reloc: {rep['reloc']}")
    print(f"phase 11e BoW relocalization (KITTI stereo, 6 frames, 2 blank, back at frame 2's "
          f"viewpoint): lost at frames 6-7, recovered at entry {back[0]} with BoW candidates "
          f"{calls}, x error {rep['reloc']['x_err_m']:.4f} m on {smi}", flush=True)
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 11 took {rep['phase_s']:.0f} s", flush=True)
    return rep


# ---------------------------------------------------------------------------
# phase 12: the system loop and the command line
# ---------------------------------------------------------------------------
# the JAX package's own command line (tools/run_slam.py) on the CPU over phase
# 12a's directory with 12a's arguments and feature slots (`JAX_PLATFORMS=cpu python
# tests/tracking_driver.py cli DIR`): ATE after a rigid alignment, largest
# translation error (frame 4), the 7 static objects' center errors in MapObjects.txt
JAX_CLI = {"ate_m": 0.076990507543087, "max_err_m": 0.2660200596, "keyframes": 8,
           "static_center_err_m": [0.0199, 0.0247, 0.0234, 0.0202, 0.0244, 0.0198, 0.0302]}
CLI_BAND, CLI_ERR_BAND = 1.5 * JAX_CLI["ate_m"], 1.5 * JAX_CLI["max_err_m"]
# phase 11a's bars on the mono run (tests/test_mono_e2e.py): ok share, ATE / path
MONO_OK, MONO_ATE_SHARE = 0.6, 0.08
# the JAX package's command line on the CPU over 12b's RGB-D layout, synchronous and with
# the pipelined tracker (`JAX_PLATFORMS=cpu python tests/tracking_driver.py pipelined DIR`):
# keyframes, and the camera center of every frame (CameraTrajectory_TUM.txt, frames 0-11)
JAX_RGBD = {
    "sync": {"keyframes": 4, "centers": [
        [0.0, 0.0, 0.0], [0.304203, 0.003549, -0.030795], [0.605039, 0.303048, -0.038897],
        [1.036382, 0.371508, 0.043988], [1.402747, -0.049641, 0.017623],
        [1.76821, 0.013488, -0.010552], [2.109262, 0.040399, -0.013512],
        [2.453847, 0.040915, -0.01173], [2.797793, 0.036182, -0.006956],
        [3.178231, 0.04568, -0.026788], [3.473174, 0.056981, -0.006821],
        [3.812508, 0.040617, -0.004054]]},
    "pipelined": {"keyframes": 6, "centers": [
        [0.0, 0.0, 0.0], [0.304203, 0.003549, -0.030795], [0.605039, 0.303048, -0.038897],
        [1.036384, 0.371505, 0.043989], [1.40274, -0.049638, 0.017624],
        [1.754833, -0.000572, 0.003416], [2.109961, 0.032435, -0.006265],
        [2.46128, 0.040466, -0.010358], [2.78442, 0.021996, 0.006322],
        [3.155051, 0.024952, -0.007925], [3.493958, 0.070364, -0.008457],
        [3.793778, 0.052862, 0.005552]]}}
# 12b's frame-by-frame band on the camera centers against JAX_RGBD (m). The CPU parity
# tests hold the port's frames to JAX's within 1e-2 m (tests/test_torch_tracking.py). The
# card sums its products and reductions in other orders than XLA on the CPU, and a
# converged LM's accept tests turn on the last bits: before the port's scatter-adds took
# a fixed order, two pipelined runs on the card differed from each other by up to
# 0.009718 m at a frame from the fifth on (PERF.md), and this band, twice that, stays
# the bar against JAX. Two runs on the card now give the same bits (12b checks it).
RGBD_FRAME_BAND = 2e-2


def _union(intervals):
    """Merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(iv):
    return sum(e - s for s, e in iv)


def _intersection(a, b):
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _kernels(trace_path):
    with open(trace_path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]


def mark_streams(dev, worker_stream, path):
    """Trace marker kernels into `path` for `stream_names`: one on the
    current (the tracker's) stream, two on `worker_stream`, after the
    tracer has settled (it drops the first kernels of a trace)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(8):
            torch.zeros(1, device=dev)
        torch.cuda.synchronize()
        time.sleep(0.2)
        torch.cuda._sleep(100)
        with torch.cuda.stream(worker_stream):
            torch.cuda._sleep(100)
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(0.2)
    p.export_chrome_trace(path)


def stream_names(marker_trace):
    """{stream id: name} from a short trace of marker kernels only
    (`torch.cuda._sleep`, named "spin"): one on the tracker's stream, two
    on the worker's.  Kept apart from the frame's trace, where the tracer
    may drop a marker among ~50,000 kernels."""
    spins = {}
    for e in _kernels(marker_trace):
        if "spin" in e.get("name", ""):
            st = e["args"].get("stream")
            spins[st] = spins.get(st, 0) + 1
    return {st: {1: "tracker stream", 2: "worker stream"}[n]
            for st, n in spins.items() if n in (1, 2)}


def stream_overlap(trace_path, wall_ms, names):
    """From a Chrome trace of one frame: each stream's kernels (count, busy
    ms; streams named by `names`, others, the prefetcher's, by their id),
    the ms in which the tracker's and the worker's streams both ran a
    kernel, and the idle share of the frame's wall."""
    by_stream = {}
    for e in _kernels(trace_path):
        t0 = float(e["ts"])
        by_stream.setdefault(e["args"].get("stream"), []).append(
            (t0, t0 + float(e.get("dur", 0.0))))
    iv = {names.get(st, f"stream {st}"): (len(v), _union(v)) for st, v in by_stream.items()}
    busy = _length(_union([x for v in by_stream.values() for x in v])) / 1e3
    return {"streams": {k: {"kernels": n, "busy_ms": _length(u) / 1e3}
                        for k, (n, u) in iv.items()},
            "overlap_ms": _intersection(iv.get("tracker stream", (0, []))[1],
                                        iv.get("worker stream", (0, []))[1]) / 1e3,
            "busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms > 0 else None}


def _center_errors(truths, map_objects):
    """Each truth's nearest MapObjects entry: [(truth index, slot id, m)]."""
    ids, poses, _ = map_objects
    out = []
    for k, t in enumerate(truths):
        d = np.linalg.norm(poses[:, :3, 3] - t.center, axis=1) if len(ids) else np.array([np.inf])
        out.append((k, int(ids[int(np.argmin(d))]) if len(ids) else -1, float(d.min())))
    return out


@contextlib.contextmanager
def system_overrides(**fields):
    """`SLAMSystem`s built inside the block (by the command line) take their
    configuration with `fields` replaced: a `SystemConfig` field, or
    `pipelined`, which goes into its `TrackingConfig`."""
    from unittest import mock

    from dsp_slam_rgbd_tpu_torch import config
    from dsp_slam_rgbd_tpu_torch.system import slam

    init = slam.SLAMSystem.__init__

    def overridden(self, cfg, *a, **k):
        if "pipelined" in fields:
            cfg = config.replace(cfg, tracking=config.replace(cfg.tracking,
                                                              pipelined=fields["pipelined"]))
        cfg = config.replace(cfg, **{f: v for f, v in fields.items() if f != "pipelined"})
        init(self, cfg, *a, **k)

    with mock.patch.object(slam.SLAMSystem, "__init__", overridden):
        yield


def cli_objects_run(dev, paths, out, vocab, async_kf_frames, trace_path=None):
    """One run of the command line over 12a's directory with `async_kf_frames`.
    Wraps `SLAMSystem.track_frame` (each frame's host span and card events,
    whether a keyframe job was in flight) and `MappingStage.process` (each
    job's host span and events on the worker's stream, which is current
    there), and, given `trace_path`, names the streams by marker kernels
    before the first frame and traces the frames that start while the
    worker is inside its second or a later asynchronous job, until one
    holds the worker's kernels -> (run_slam.main's result, the record:
    "traced" that frame's streams, "misses" the frames traced before it)."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.system import mapping_stage, slam
    from dsp_slam_rgbd_tpu_torch.tools import run_slam

    rec = {"spans": [], "events": [], "inflight": [], "jobs": [], "job_events": [],
           "in_job": 0, "names": None, "traced": {}, "misses": []}
    track_frame, process = slam.SLAMSystem.track_frame, mapping_stage.MappingStage.process

    def timed_process(self, job):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        rec["in_job"] += 1
        t = time.perf_counter()
        ev[0].record()
        try:
            res = process(self, job)
        finally:
            rec["in_job"] -= 1
        ev[1].record()
        rec["jobs"].append((t, time.perf_counter()))
        rec["job_events"].append(ev)
        return res

    def timed_track_frame(self, frame, detections=None):
        busy = bool(self._pending) and not self._pending[-1][2].is_set() \
            and self._pending[-1][3] > self.tracker.frame_id + 1
        rec["inflight"].append(busy)
        if trace_path and rec["names"] is None and self._map_stream is not None:
            mark_streams(dev, self._map_stream, trace_path + ".markers")
            rec["names"] = stream_names(trace_path + ".markers")
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        # the worker is inside a job, and has finished one asynchronous job
        # before it (the two bootstrap jobs run inline, in their frames)
        if trace_path and busy and not rec["traced"] and self._worker is not None \
                and rec["in_job"] and len(rec["jobs"]) >= 3:
            # the card's kernels only: recording the host's ops slows the frame
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                t = time.perf_counter()
                r = track_frame(self, frame, detections)
                t1 = time.perf_counter()
            p.export_chrome_trace(trace_path)
            got = dict(stream_overlap(trace_path, (t1 - t) * 1e3, rec["names"]),
                       frame=len(rec["spans"]))
            if "worker stream" in got["streams"]:
                rec["traced"] = got
            else:
                rec["misses"].append(got)
        else:
            t = time.perf_counter()
            r = track_frame(self, frame, detections)
            t1 = time.perf_counter()
        ev[1].record()
        rec["spans"].append((t, t1))
        rec["events"].append(ev)
        return r

    argv = [paths["seq"], out, "--yaml", paths["yaml"], "--labels", paths["labels"],
            "--deepsdf", FIXTURE, "--vocab", vocab, "--bootstrap-vocab", "24",
            "--vocab-depth", "4", "--gt", paths["gt"]]
    # every run starts as a new process does, with no BA capacity buckets (the
    # module keeps the last ones per map shape, and other buckets pad the sums)
    lm._bucket_memo.clear()
    with system_overrides(async_kf_frames=async_kf_frames), \
            mock.patch.object(slam.SLAMSystem, "track_frame", timed_track_frame), \
            mock.patch.object(mapping_stage.MappingStage, "process", timed_process):
        res = run_slam.main(argv)
    torch.cuda.synchronize()
    return res, rec


def cli_objects_check(paths, out, res):
    """12a's checks on one run's files -> the numbers they read."""
    from dsp_slam_rgbd_tpu_torch.solvers import sim3
    from dsp_slam_rgbd_tpu_torch.system import io as io_mod
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd

    summ = res["summary"]
    rows = np.loadtxt(os.path.join(out, "CameraTrajectory.txt"), ndmin=2)
    gt = np.loadtxt(paths["gt"], ndmin=2)[:, [3, 7, 11]]
    m = min(len(rows), len(gt))
    ate = float(sim3.align_trajectories(torch.tensor(rows[:m, [3, 7, 11]], dtype=torch.float32),
                                        torch.tensor(gt[:m], dtype=torch.float32),
                                        fix_scale=True)[1])
    max_err = float(np.abs(rows[:m, [3, 7, 11]] - gt[:m]).max())
    objs = io_mod.load_map_objects(os.path.join(out, "MapObjects.txt"))
    statics = _center_errors(ow.kitti_objects()[:7], objs)
    n = sd.KITTI_OBJECTS_FRAMES
    check(rows.shape == (n, 12), f"12a every frame in CameraTrajectory.txt: {rows.shape}")
    check(ate <= CLI_BAND, f"12a ATE {ate} within 1.5x the JAX command line's {JAX_CLI['ate_m']}")
    check(max_err <= CLI_ERR_BAND, f"12a largest translation error {max_err} within 1.5x the "
          f"JAX command line's {JAX_CLI['max_err_m']}")
    check(all(e < 0.3 for _, _, e in statics) and len({s for _, s, _ in statics}) == 7,
          f"12a the 7 static objects in MapObjects.txt within 0.3 m: {statics}")
    check(summ["kf_slots_exhausted"] == 0 and summ["loop_closures"] == 0,
          f"12a no keyframe dropped, no loop closed: {summ}")
    return {"ate_m": ate, "max_err_m": max_err, "rows": list(rows.shape),
            "map_objects": len(objs[0]), "static_center_err_m": statics}


def cli_objects_phase(dev, smi, tmp):
    """12a: the port's command line in-process on phase 10's world written
    as a KITTI directory, with the asynchronous keyframe stage and again
    with it inline (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd

    t0 = time.perf_counter()
    paths = sd.write_kitti_objects(os.path.join(tmp, "kitti"))
    write_s = time.perf_counter() - t0
    vocab = os.path.join(tmp, "vocab12a.npz")
    with profile(activities=[ProfilerActivity.CUDA]):   # the tracer's first start is slow
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    mlp_sdf.reset_launch_counts()
    t0 = time.perf_counter()
    with counting_scatters("12a command line"), \
            capturing_scatters("12a", ("local_mapping.py",)):
        res, rec = cli_objects_run(dev, paths, os.path.join(tmp, "out12a"), vocab, 3,
                                   trace_path=os.path.join(tmp, "frame_trace.json"))
    run_s = time.perf_counter() - t0
    launches = dict(mlp_sdf.LAUNCHES)
    check(launches["mlp_sdf_value_f32"] > 0 and launches["mlp_sdf_jacobian_f32"] > 0,
          f"12a both f32 kernels launched from the command line's run: {launches}")
    check(SCATTER_LAUNCHES["12a command line"]["segment_sum"] > 0,
          f"12a the segment-sum kernel launched from the command line's run: {SCATTER_LAUNCHES}")
    got = cli_objects_check(paths, os.path.join(tmp, "out12a"), res)
    summ, traced, misses = res["summary"], rec["traced"], rec["misses"]
    for m in misses:
        print(f"phase 12a traced frame {m['frame']} (the worker inside a job as it began) holds "
              f"no kernel of the worker's stream: traced wall {m['wall_ms']:.1f} ms, " + "; ".join(
                  f"{k}: {v['kernels']} kernels, {v['busy_ms']:.1f} ms busy"
                  for k, v in m["streams"].items()), flush=True)
    check({"tracker stream", "worker stream"} <= set(traced.get("streams", {})),
          f"12a a frame traced with a keyframe job in flight, both streams found "
          f"(streams {rec['names']}): {traced}; misses {misses}")
    traced_frames = [traced["frame"]] + [m["frame"] for m in misses]
    ms_ = np.asarray(res["track_ms"])
    kf = np.zeros(len(ms_), bool)
    kf[res["kf_frames"]] = True
    busy = np.asarray(rec["inflight"], bool)
    # frames per second without the first frame (its keyframe stage, 7 new
    # objects, runs inline in both modes) and the traced ones (the tracer's cost)
    steady = np.delete(ms_, [0] + traced_frames)
    # how much of the worker's keyframe stages ran while a frame was tracked
    # (the first two jobs, the bootstrap keyframes, run inline in their frame),
    # on the host clock and on the card's (each job's first to last work)
    jobs = _union(rec["jobs"][2:])
    job_s, overlap_s = _length(jobs), _intersection(jobs, _union(rec["spans"]))
    ref = rec["events"][0][0]
    dev_jobs = _union([(ref.elapsed_time(a), ref.elapsed_time(b))
                       for a, b in rec["job_events"][2:]])
    dev_frames = _union([(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in rec["events"]])
    dev_job_ms, dev_overlap_ms = _length(dev_jobs), _intersection(dev_jobs, dev_frames)
    # the idle share of a frame with a job in flight, from the traced frame's
    # busy time over the untraced such frames' median wall
    untraced_busy = np.delete(np.arange(len(ms_)), traced_frames)
    inflight_wall = _median(ms_[untraced_busy][~kf[untraced_busy] & busy[untraced_busy]])
    rep = {"card": smi, "write_s": write_s, "run_s": run_s, "summary": summ, **got,
           "band_m": CLI_BAND, "jax_cli_cpu": JAX_CLI, "launches": launches,
           "track_ms": ms_.tolist(), "kf_frames": res["kf_frames"], "job_in_flight": busy.tolist(),
           "blocked_ms": res["blocked_ms"], "traced_frame": traced, "trace_misses": misses,
           "ms_tracking_idle_worker": _median(ms_[~kf & ~busy]),
           "ms_tracking_job_in_flight": _median(ms_[~kf & busy]),
           "ms_keyframe_frames": _median(ms_[kf]), "worker_jobs_s": job_s,
           "worker_overlapping_tracking_s": overlap_s, "worker_stream_ms": dev_job_ms,
           "worker_stream_in_frames_ms": dev_overlap_ms,
           "fps_steady": float(steady.size / max(steady.sum() / 1e3, 1e-9)),
           "idle_share_in_flight_untraced": 1.0 - traced["busy_ms"] / inflight_wall}
    print(f"phase 12a command line (phase 10's world and tracking configuration as a KITTI "
          f"directory: {summ['frames']} 1241x376 stereo frames, 2,000 ORB features, ThDepth 35, "
          f"5 frames at most between keyframes, 8 objects' label files, fixture decoder, "
          f"10^4-word vocabulary bootstrapped from 24 frames, async_kf_frames 3, "
          f"FramePrefetcher): {summ['fps']} fps, track ms p50/p90/p99 {summ['track_ms_p50']}/"
          f"{summ['track_ms_p90']}/{summ['track_ms_p99']}; {rep['fps_steady']:.3f} fps without "
          f"the first frame (the bootstrap keyframe stage with 7 new objects runs inline) and the "
          f"traced ones; median ms: tracking with the worker idle "
          f"{rep['ms_tracking_idle_worker']:.1f} ({int((~kf & ~busy).sum())} frames), tracking "
          f"with a job in flight {rep['ms_tracking_job_in_flight']:.1f} "
          f"({int((~kf & busy).sum())}), keyframe frames {rep['ms_keyframe_frames']:.1f} "
          f"({int(kf.sum())}); the worker's jobs {job_s:.2f} s on the host, {overlap_s:.2f} s of "
          f"them while a frame was tracked; on the card the worker's jobs span "
          f"{dev_job_ms:.1f} ms, {dev_overlap_ms:.1f} ms of them inside the tracker's frames; "
          f"blocked in _adopt {res['blocked_ms']['adopt']:.1f} ms, in _prewait_mapping "
          f"{res['blocked_ms']['prewait']:.1f} ms; {summ['n_kf']} keyframes, {summ['n_points']} "
          f"points, ATE {got['ate_m']:.6f} m (band {CLI_BAND:.6f}, JAX CPU "
          f"{JAX_CLI['ate_m']:.6f}), largest error {got['max_err_m']:.6f} m (band "
          f"{CLI_ERR_BAND:.6f}), {got['map_objects']} map objects, static centers "
          f"{min(e for _, _, e in got['static_center_err_m']):.4f}-"
          f"{max(e for _, _, e in got['static_center_err_m']):.4f} m; decoder launches "
          f"{launches}; write {write_s:.1f} s, run {run_s:.1f} s on {smi}", flush=True)
    print(f"phase 12a traced frame {traced['frame']} (a keyframe job in flight; streams named "
          f"by marker kernels traced before the first frame; {len(misses)} frames traced before "
          f"it held none of the worker's kernels): traced wall {traced['wall_ms']:.1f} "
          f"ms, busy {traced['busy_ms']:.1f} ms, idle share of the traced wall "
          f"{traced['idle_share']:.3f}, of the untraced in-flight frames' median wall "
          f"({inflight_wall:.1f} ms) {rep['idle_share_in_flight_untraced']:.3f}; " + "; ".join(
              f"{k}: {v['kernels']} kernels, {v['busy_ms']:.1f} ms busy"
              for k, v in traced["streams"].items())
          + f"; the tracker's and the worker's kernels ran at once for "
          f"{traced['overlap_ms']:.2f} ms on {smi}", flush=True)
    # the same command line again (loading the vocabulary the first run
    # bootstrapped and saved): two runs of one build write the same files
    t0 = time.perf_counter()
    res2, _ = cli_objects_run(dev, paths, os.path.join(tmp, "out12a_again"), vocab, 3)
    same = {}
    for f in ("CameraTrajectory.txt", "MapObjects.txt"):
        with open(os.path.join(tmp, "out12a", f), "rb") as a, \
                open(os.path.join(tmp, "out12a_again", f), "rb") as b:
            same[f] = a.read() == b.read()
    rep["again"] = {"files_identical": same, "summary": res2["summary"],
                    "run_s": time.perf_counter() - t0}
    print(f"phase 12a again at async_kf_frames 3 (the vocabulary loaded): {res2['summary']['fps']} "
          f"fps, {res2['summary']['n_kf']} keyframes; byte-identical to the first run: {same}; "
          f"run {rep['again']['run_s']:.1f} s on {smi}", flush=True)
    check(all(same.values()), f"12a a second run at async_kf_frames 3 writes the first run's "
          f"CameraTrajectory.txt and MapObjects.txt byte for byte: {same}")
    # the same run with every keyframe stage inline in its frame
    t0 = time.perf_counter()
    res0, _ = cli_objects_run(dev, paths, os.path.join(tmp, "out12a_sync"), vocab, 0)
    got0 = cli_objects_check(paths, os.path.join(tmp, "out12a_sync"), res0)
    ms0 = np.asarray(res0["track_ms"])
    rep["sync"] = {"summary": res0["summary"], **got0, "track_ms": ms0.tolist(),
                   "fps_steady": float((ms0.size - 1) / max(ms0[1:].sum() / 1e3, 1e-9)),
                   "run_s": time.perf_counter() - t0}
    s0 = res0["summary"]
    print(f"phase 12a again at async_kf_frames 0 (every keyframe stage inline): {s0['fps']} fps "
          f"(async_kf_frames 3: {summ['fps']}), {rep['sync']['fps_steady']:.3f} fps without the "
          f"first frame (async 3: {rep['fps_steady']:.3f}), track ms p50/p90/p99 "
          f"{s0['track_ms_p50']}/{s0['track_ms_p90']}/{s0['track_ms_p99']}; {s0['n_kf']} "
          f"keyframes, ATE {got0['ate_m']:.6f} m, largest error {got0['max_err_m']:.6f} m, static "
          f"centers {min(e for _, _, e in got0['static_center_err_m']):.4f}-"
          f"{max(e for _, _, e in got0['static_center_err_m']):.4f} m; run "
          f"{rep['sync']['run_s']:.1f} s on {smi}", flush=True)
    return rep


def _layout_write(tmp, name, world, sensor, n):
    """Write `world` in `sensor`'s layout with a yaml of phase 8's tracking
    configuration (2,000 features, ThDepth 35, 5 frames at most between
    keyframes) -> (sequence dir, yaml)."""
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd

    root = os.path.join(tmp, name)
    (sd.write_rgbd if sensor == "rgbd" else sd.write_mono)(root, world, pw.make_texture(world), n)
    yaml = os.path.join(tmp, f"{name}.yaml")
    sd.write_yaml(yaml, world, fps=5.0)
    return root, yaml


def _layout_run(tmp, root, yaml, out, sensor, **overrides):
    """The command line over a layout written by `_layout_write` -> (result,
    TUM camera centers, frame index of each row)."""
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.tools import run_slam

    lm._bucket_memo.clear()   # as a new process starts (see cli_objects_run)
    with system_overrides(**overrides):
        res = run_slam.main([root, os.path.join(tmp, out), "--sensor", sensor, "--yaml", yaml])
    rows = np.loadtxt(os.path.join(tmp, out, "CameraTrajectory_TUM.txt"), ndmin=2)
    return res, rows[:, 1:4], np.round(rows[:, 0] * 5.0).astype(int)


def cli_layouts_phase(dev, smi, tmp):
    """12b: the RGB-D and image-directory layouts through the command line,
    held to phases 8c's and 11a's bands; the RGB-D run again with the
    pipelined tracker."""
    from unittest import mock

    from dsp_slam_rgbd_tpu_torch.solvers import sim3
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw
    from dsp_slam_rgbd_tpu_torch.tracking import tracker as trk

    rep = {"card": smi}
    root, yaml = _layout_write(tmp, "rgbd", pw.KITTI, "rgbd", 12)
    copies, finals = [], []
    copy, finalize = trk._copy_to_host_async, trk.Tracker._finalize_one

    def counted_copy(stats):
        out = copy(stats)
        copies.append(out[1] is not None)   # a pinned copy with its event
        return out

    def counted_finalize(self, infl, speculative):
        outs = finalize(self, infl, speculative)
        finals.append(len(outs))
        return outs

    runs = {}
    for mode, tag in (("sync", "sync"), ("pipelined", "pipelined"),
                      ("pipelined", "pipelined_again")):
        copies.clear()   # each run's own counts
        finals.clear()
        t0 = time.perf_counter()
        with mock.patch.object(trk, "_copy_to_host_async", counted_copy), \
                mock.patch.object(trk.Tracker, "_finalize_one", counted_finalize):
            res, cen, fi = _layout_run(tmp, root, yaml, f"out_rgbd_{tag}", "rgbd",
                                       pipelined=mode == "pipelined")
        runs[tag] = cen
        err = np.abs(cen[:, 0] - np.array([pw.gt_x(pw.KITTI, f) for f in fi]))
        s = res["summary"]
        jax = JAX_RGBD[mode]
        jax_dist = np.linalg.norm(cen - np.asarray(jax["centers"])[fi], axis=1) \
            if fi.max() < len(jax["centers"]) else np.full(len(fi), np.inf)
        rep[f"rgbd_{tag}"] = r = {"summary": s, "rows": len(fi), "max_x_err_m": float(err.max()),
                                   "band_m": RGBD_BAND, "pinned_copies": len(copies),
                                   "finalized": len(finals), "s": time.perf_counter() - t0,
                                   "jax_keyframes": jax["keyframes"],
                                   "jax_frame_dist_m": jax_dist.tolist()}
        check(len(fi) >= 0.9 * 12 and s["n_kf"] >= 2 and np.isfinite(cen).all()
              and err.max() < RGBD_BAND, f"12b RGB-D {mode}: {r}")
        check(s["n_kf"] == jax["keyframes"] and len(fi) == len(jax["centers"])
              and jax_dist.max() < RGBD_FRAME_BAND,
              f"12b RGB-D {mode} held to the JAX command line's {mode} run frame by frame: {r}")
        if mode == "pipelined":
            check(len(finals) >= 6 and len(copies) >= 6 and all(copies),
                  f"12b the pipelined tracker finalized frames read through pinned copies: {r}")
        print(f"phase 12b RGB-D {tag} (rgb/ + 16-bit depth/ PNGs, 12 KITTI-size frames, phase "
              f"8c's tracking configuration): {len(fi)} rows, {s['n_kf']} keyframes (JAX "
              f"{jax['keyframes']}), camera centers within {jax_dist.max():.6f} m of JAX's frame "
              f"by frame (band {RGBD_FRAME_BAND}), largest x "
              f"error {err.max():.6f} m (band {RGBD_BAND}), {s['fps']} fps, track ms p50 "
              f"{s['track_ms_p50']}; {len(finals)} frames finalized one frame late, "
              f"{len(copies)} stats copies to pinned memory on {smi}", flush=True)
    a, b = runs["pipelined"], runs["pipelined_again"]
    spread = np.linalg.norm(a - b, axis=1) if a.shape == b.shape else np.full(len(a), np.inf)
    rep["rgbd_pipelined_run_to_run_m"] = spread.tolist()
    check(spread.max() == 0.0,
          f"12b two pipelined runs give the same camera centers: {spread.tolist()}")
    print(f"phase 12b RGB-D pipelined, run to run on the card: camera centers within "
          f"{spread.max():.6f} m of each other (frame by frame "
          f"{', '.join(f'{x:.6f}' for x in spread)}) on {smi}", flush=True)
    t0 = time.perf_counter()
    world = pw.KITTI_FLOOR
    root, yaml = _layout_write(tmp, "mono", world, "mono", 14)
    res, cen, fi = _layout_run(tmp, root, yaml, "out_mono", "mono")
    s = res["summary"]
    gt = torch.tensor([[pw.gt_x(world, f), 0.0, 0.0] for f in fi], dtype=torch.float32)
    ate = float(sim3.align_trajectories(torch.tensor(cen, dtype=torch.float32), gt)[1]) \
        if len(fi) >= 3 else float("inf")
    path = float(gt[-1, 0] - gt[0, 0]) if len(fi) else 0.0
    rep["mono"] = {"summary": s, "rows": len(fi), "ate_m": ate, "path_m": path,
                   "s": time.perf_counter() - t0}
    check(len(fi) >= MONO_OK * 14 and s["n_kf"] >= 2 and ate < MONO_ATE_SHARE * path,
          f"12b mono: {rep['mono']}")
    print(f"phase 12b mono (an image directory of 14 KITTI_FLOOR frames, phase 11a's "
          f"tracking configuration, SLAMSystem._insert_mono_init): {len(fi)} rows from frame "
          f"{fi[0]}, {s['n_kf']} keyframes, Sim(3)-aligned ATE {ate:.4f} m of a {path:.2f} m "
          f"path (bar {MONO_ATE_SHARE:.0%}), {s['fps']} fps on {smi}", flush=True)
    return rep


def system_phase(dev, smi, keep):
    """Phase 12 (see the module docstring) -> the report's "system" entry.
    12a's output directory, with the sequence's gt.txt, is copied to
    `keep`/out12a for phase 14."""
    import shutil

    t_phase = time.perf_counter()
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        rep["cli_objects"] = cli_objects_phase(dev, smi, tmp)
        shutil.copytree(os.path.join(tmp, "out12a"), os.path.join(keep, "out12a"))
        shutil.copy(os.path.join(tmp, "kitti", "seq", "gt.txt"), os.path.join(keep, "out12a"))
        rep["cli_layouts"] = cli_layouts_phase(dev, smi, tmp)
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 12 took {rep['phase_s']:.0f} s", flush=True)
    return rep


# ---------------------------------------------------------------------------
# phase 13: the scale-out tier and active mapping
# ---------------------------------------------------------------------------
# tolerances: the sharded reconstruction against the unsharded one 1e-5 (a one-rank group
# sums nothing, so only launch sizes differ); one LM step of BA 1e-4 (9c's, and
# tests/test_parallel.py's); whole sharded LM runs at tests/test_distributed_2proc.py's
# (poses 1e-3, points 1e-2: a converged LM's accept tests sit at f32 rounding, and the
# sharded problem is padded and summed across ranks, so its products take other
# orders than the unsharded run's; each run repeats bit for bit); sharded PCG at
# tests/test_parallel.py's (poses 2e-2, points 5e-2)
RECON_SHARD_TOL = 1e-5
NBV_RTOL = 1e-4
RENDER_HIT_SHARE, RENDER_DEPTH_TOL = 1e-3, 1e-3


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _diff(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def sharded_recon_step(fixture, cfg, dtype, batch, mesh, tag, smi):
    """13a: `reconstruct_sharded` at phase 4's problem against the unsharded
    fit, the decoder kernels it launched, and both times."""
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.parallel import sharded_recon
    from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt

    def sharded():
        return sharded_recon.reconstruct_sharded(fixture, cfg, batch, mesh, compute_dtype=dtype)

    def unsharded():
        return opt.reconstruct_objects_batched(
            fixture, cfg, *(batch[k] for k in sharded_recon.BATCH_KEYS[:-1]),
            code_init=batch["code_init"], compute_dtype=dtype)

    mlp_sdf.reset_launch_counts()
    got = sharded()
    torch.cuda.synchronize()
    launches = dict(mlp_sdf.LAUNCHES)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    own = [mlp_sdf.kernel_name(op, dtype) for op in ("mlp_sdf_value", "mlp_sdf_jacobian")]
    others = [mlp_sdf.kernel_name(op, other) for op in ("mlp_sdf_value", "mlp_sdf_jacobian")]
    want = unsharded()
    case = {"tag": tag, "launches": launches, "pose_err": _diff(got.t_cam_obj, want.t_cam_obj),
            "code_err": _diff(got.code, want.code), "good": int(got.is_good.sum()),
            "ms": wall_ms(sharded, 3), "unsharded_ms": wall_ms(unsharded, 3)}
    check(max(case["pose_err"], case["code_err"]) <= RECON_SHARD_TOL
          and torch.equal(got.is_good, want.is_good), f"13a sharded recon {tag}: {case}")
    check(all(launches[k] > 0 for k in own) and not any(launches[k] for k in others),
          f"13a both {tag} kernels, and neither of the other type, launched under the mesh: "
          f"{launches}")
    print(f"phase 13a reconstruct_sharded {tag} at phase 4's problem on a (1, 1) mesh: pose "
          f"{case['pose_err']:.3g}, code {case['code_err']:.3g} from the unsharded fit (tolerance "
          f"{RECON_SHARD_TOL}), {case['good']} good; kernels launched {launches}; "
          f"{case['ms']:.1f} ms, unsharded {case['unsharded_ms']:.1f} ms on {smi}", flush=True)
    return case


def sharded_ba_step(state, mesh, smi, center=500):
    """13a: sharded local BA (the window at keyframe `center`) and sharded
    PCG (the whole map) on phase 9b's corridor against their unsharded
    counterparts."""
    from dsp_slam_rgbd_tpu_torch.mapping import ba
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.parallel import sharded_ba
    from dsp_slam_rgbd_tpu_torch.tools import corridor_map as cm
    from dsp_slam_rgbd_tpu_torch.weights import ba_problem_from_numpy, ba_problem_to_numpy

    cam, group = cm.CAM, mesh.group("ray")
    prob, _ = lm.build_local_ba_problem(state, center, max_kfs=10)
    # one LM step in the window's own coordinates (9c's gauge: hundreds of metres
    # from the map's origin, f32 rounding alone moves a step by ~1e-4)
    local_prob = ba_problem_from_numpy(recentered(ba_problem_to_numpy(prob)), prob.pts.device)
    step_s, _ = ba._assemble_and_solve(cam, sharded_ba.shard_problem(local_prob, mesh), 1e-3,
                                       group)
    step_u, _ = ba._assemble_and_solve(cam, local_prob, 1e-3)
    got, want = sharded_ba.run_sharded_ba(cam, prob, mesh), ba.local_ba(cam, prob)
    before = mean_reproj(ba, cam, prob)
    local = {"step_pose_err": _diff(step_s.kf_pose, step_u.kf_pose),
             "step_pts_err": _diff(step_s.pts, step_u.pts),
             "pose_err": _diff(got.kf_pose, want.kf_pose), "pts_err": _diff(got.pts, want.pts),
             "reproj_px_before": before,
             "reproj_px_after": mean_reproj(ba, cam, prob._replace(kf_pose=got.kf_pose,
                                                                 pts=got.pts)),
             "ms": wall_ms(lambda: sharded_ba.run_sharded_ba(cam, prob, mesh), 2),
             "unsharded_ms": wall_ms(lambda: ba.local_ba(cam, prob), 2)}
    check(max(local["step_pose_err"], local["step_pts_err"]) <= 1e-4
          and local["pose_err"] <= 1e-3 and local["pts_err"] <= 1e-2
          and torch.equal(got.obs_mask, want.obs_mask)
          and local["reproj_px_after"] < 0.7 * before, f"13a sharded local BA: {local}")
    gprob, _ = lm.build_local_ba_problem(state, 0, 0, global_window=True)

    def pcg_sharded():
        return sharded_ba.global_ba_pcg_sharded(cam, gprob, mesh)

    def pcg_unsharded():   # the same LM stages and CG depth without the mesh
        return ba._two_stage(cam, gprob, 3, 7, 1e-3,
                             lambda p, lam: ba._pcg_gn_step(cam, p, lam, 32))

    got, want = pcg_sharded(), pcg_unsharded()
    before = mean_reproj(ba, cam, gprob)
    glob = {"pose_err": _diff(got.kf_pose, want.kf_pose), "pts_err": _diff(got.pts, want.pts),
            "reproj_px_before": before,
            "reproj_px_after": mean_reproj(ba, cam, gprob._replace(kf_pose=got.kf_pose,
                                                                 pts=got.pts)),
            "ms": wall_ms(pcg_sharded, 1), "unsharded_ms": wall_ms(pcg_unsharded, 1)}
    check(glob["pose_err"] <= 2e-2 and glob["pts_err"] <= 5e-2
          and glob["reproj_px_after"] < 0.5 * before, f"13a sharded PCG: {glob}")
    print(f"phase 13a run_sharded_ba at keyframe {center} of the corridor: one LM step (the "
          f"window recentered, 9c's gauge) pose "
          f"{local['step_pose_err']:.3g} points {local['step_pts_err']:.3g} from the unsharded "
          f"step, the whole run pose {local['pose_err']:.3g} points {local['pts_err']:.3g}; "
          f"reprojection {before:.3f} -> {local['reproj_px_after']:.3f} px; {local['ms']:.1f} ms, "
          f"unsharded {local['unsharded_ms']:.1f} ms; global_ba_pcg_sharded (3 + 7 LM "
          f"iterations of 32 CG steps) pose {glob['pose_err']:.3g} points {glob['pts_err']:.3g}, "
          f"reprojection {glob['reproj_px_before']:.3f} -> {glob['reproj_px_after']:.3f} px; "
          f"{glob['ms']:.1f} ms, unsharded {glob['unsharded_ms']:.1f} ms on {smi}",
          flush=True)
    return {"local": local, "pcg": glob}


def distributed_cli_step(dev, smi, tmp):
    """13b: the command line with --distributed (one process, NCCL) over the
    first 8 frames of 12a's directory, again with the system given a (1, 1)
    mesh in that group (the sharded reconstruction and the ranks'
    agreement checks from the mapping worker's thread and stream), and
    without --distributed; all three under `keep_replicas_identical` (what
    `initialize` turns on for more than one rank), each from cleared BA
    capacity buckets -> (report, each distributed run's launches)."""
    from unittest import mock

    import torch.distributed as tdist

    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping as lm
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
    from dsp_slam_rgbd_tpu_torch.parallel import mesh as mesh_mod
    from dsp_slam_rgbd_tpu_torch.parallel import sharded_recon
    from dsp_slam_rgbd_tpu_torch.system import io as io_mod
    from dsp_slam_rgbd_tpu_torch.system import slam
    from dsp_slam_rgbd_tpu_torch.tools import run_slam
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd

    f32 = ("mlp_sdf_value_f32", "mlp_sdf_jacobian_f32")
    paths = sd.write_kitti_objects(os.path.join(tmp, "kitti"))
    seen, init = {}, slam.SLAMSystem.__init__
    real_recon, real_agree = sharded_recon.reconstruct_sharded, dist.agree
    under_mesh = {"calls": 0, "agreement_checks": 0, **{k: 0 for k in f32}}

    def watched(mode):
        def run(self, *a, **k):
            init(self, *a, **k)
            if mode == "mesh":   # what the system builds at N > 1 ranks, at one
                self.recon_mesh = self.mapping._recon_mesh = mesh_mod.make_mesh(1, 1)
            seen[mode] = {"backend": tdist.get_backend() if tdist.is_initialized() else None,
                          "mesh": None if self.recon_mesh is None else self.recon_mesh.shape}
        return run

    def counted_recon(*a, **k):
        before = dict(mlp_sdf.LAUNCHES)
        out = real_recon(*a, **k)
        under_mesh["calls"] += 1
        for key in f32:
            under_mesh[key] += mlp_sdf.LAUNCHES[key] - before[key]
        return out

    def counted_agree(*a, **k):
        under_mesh["agreement_checks"] += 1
        return real_agree(*a, **k)

    runs, launches = {}, {}
    was = torch.are_deterministic_algorithms_enabled()
    dist.keep_replicas_identical()
    try:
        for mode in ("distributed", "mesh", "plain"):
            out = os.path.join(tmp, f"out_{mode}")
            argv = [paths["seq"], out, "--yaml", paths["yaml"], "--labels", paths["labels"],
                    "--deepsdf", FIXTURE, "--max-frames", "8", "--device", dev.type]
            if mode != "plain":
                argv += ["--distributed", "--coordinator", f"localhost:{_free_port()}",
                         "--num-processes", "1", "--process-id", "0"]
            # every run starts from no BA capacity buckets (the module keeps the
            # last ones per map shape, and other buckets pad the sums otherwise)
            lm._bucket_memo.clear()
            mlp_sdf.reset_launch_counts()
            t0 = time.perf_counter()
            with mock.patch.object(slam.SLAMSystem, "__init__", watched(mode)), \
                    mock.patch.object(sharded_recon, "reconstruct_sharded", counted_recon), \
                    mock.patch.object(dist, "agree", counted_agree):
                res = run_slam.main(argv)
            torch.cuda.synchronize()
            if mode != "plain":
                launches[mode] = dict(mlp_sdf.LAUNCHES)
            runs[mode] = {"s": time.perf_counter() - t0, "summary": res["summary"],
                          "traj": np.loadtxt(os.path.join(out, "CameraTrajectory.txt"), ndmin=2),
                          "objects": io_mod.load_map_objects(os.path.join(out, "MapObjects.txt"))}
    finally:
        torch.use_deterministic_algorithms(was)
    p = runs["plain"]
    rep = {"joined": seen, "launches": launches, "under_mesh": under_mesh,
           "s": {m: r["s"] for m, r in runs.items()}, "group_left": not tdist.is_initialized()}
    for mode in ("distributed", "mesh"):
        d = runs[mode]
        same = d["traj"].shape == p["traj"].shape \
            and list(d["objects"][0]) == list(p["objects"][0])
        rep[mode] = {
            "rows": len(d["traj"]), "objects": len(d["objects"][0]),
            "traj_err": float(np.abs(d["traj"] - p["traj"]).max()) if same else float("inf"),
            "objects_err": float(max(np.abs(np.asarray(a) - np.asarray(b)).max()
                                     for a, b in zip(d["objects"][1:], p["objects"][1:])))
            if same and len(d["objects"][0]) else float("inf")}
        check(same and rep[mode]["rows"] == 8 and rep[mode]["objects"] > 0
              and max(rep[mode]["traj_err"], rep[mode]["objects_err"]) <= 1e-5,
              f"13b {mode}: CameraTrajectory.txt and MapObjects.txt as without --distributed: "
              f"{rep}")
        check(all(launches[mode][k] > 0 for k in f32),
              f"13b both f32 kernels in the {mode} run: {launches}")
    nccl = "nccl" if dev.type == "cuda" else "gloo"
    check(seen["distributed"] == {"backend": nccl, "mesh": None}
          and seen["mesh"] == {"backend": nccl, "mesh": {"obj": 1, "ray": 1}}
          and seen["plain"]["backend"] is None and rep["group_left"],
          f"13b --distributed joined an NCCL group (the second run with a (1, 1) mesh in it) "
          f"and left it: {rep}")
    check(under_mesh["calls"] > 0 and all(under_mesh[k] > 0 for k in f32)
          and under_mesh["agreement_checks"] >= 2 * under_mesh["calls"] + 1,
          f"13b the mesh run fitted its new objects through reconstruct_sharded, the f32 "
          f"kernels launched inside it, and the ranks' agreement checks ran: {under_mesh}")
    print(f"phase 13b run_slam --distributed --num-processes 1 (NCCL) over 8 frames of 12a's "
          f"directory: {rep['distributed']['rows']} rows, {rep['distributed']['objects']} map "
          f"objects; trajectory within {rep['distributed']['traj_err']:.3g}, objects within "
          f"{rep['distributed']['objects_err']:.3g} of the run without --distributed; with a "
          f"(1, 1) mesh: within {rep['mesh']['traj_err']:.3g} / {rep['mesh']['objects_err']:.3g}, "
          f"{under_mesh['calls']} reconstruct_sharded calls launching "
          f"{under_mesh['mlp_sdf_value_f32']} value + {under_mesh['mlp_sdf_jacobian_f32']} "
          f"jacobian f32 kernels, {under_mesh['agreement_checks']} agreement checks (all three "
          f"runs under keep_replicas_identical); kernels {launches}; "
          + ", ".join(f"{m} {r['s']:.1f} s" for m, r in runs.items()) + f" on {smi}",
          flush=True)
    return rep, launches


def fixture_object_map(dev):
    """A map with one object of the fixture decoder's family 6 m ahead and
    200 member points at 0.3-0.9 of its unit sphere (the map of
    tests/test_torch_active.py's fixture case) -> (on the card, on the CPU)."""
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as ms

    rng = np.random.default_rng(1)
    st = ms.empty(max_kf=4, max_feat=8, max_pts=256, max_obj=2, code_len=64, device="cpu")
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.5, 0.0, 6.0])
    d = rng.standard_normal((200, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = torch.tensor(pose[:3, 3].numpy() + d * rng.uniform(0.3, 0.9, (200, 1)),
                       dtype=torch.float32)
    live = torch.arange(256) < 200
    host = st._replace(
        obj_pose=torch.stack([pose, torch.eye(4)]), obj_valid=torch.tensor([True, False]),
        obj_scale=torch.ones(2),
        obj_code=torch.tensor(rng.standard_normal((2, 64)) * 0.3, dtype=torch.float32),
        pt_pos=torch.cat([pts, torch.zeros(56, 3)]), pt_valid=live,
        pt_object=torch.where(live, 0, -1).to(torch.int32))
    return type(host)(*(t.to(dev) for t in host)), host


def nbv_card_vs_cpu(state, host, target, cam_t_wc, cam, fixture, dec_cpu, tag):
    """13c: `nbv.generate` aimed at `target` on the card against the CPU ->
    (report, the card run's decoder launches, the CPU's plan)."""
    from dsp_slam_rgbd_tpu_torch.active import nbv
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

    def card_nbv():
        return nbv.generate(state, cam_t_wc, decoder=fixture, cam=cam, target=target)

    mlp_sdf.reset_launch_counts()
    got = card_nbv()
    torch.cuda.synchronize()
    launches = dict(mlp_sdf.LAUNCHES)
    want = nbv.generate(host, cam_t_wc, decoder=dec_cpu, cam=cam, target=target)
    scale = float(np.abs(want.rewards).max())
    rep = {"map": tag, "target": got.target_obj, "best": int(np.argmax(got.rewards)),
           "best_cpu": int(np.argmax(want.rewards)),
           "reward_err": float(np.abs(got.rewards - want.rewards).max()), "reward_scale": scale,
           "score": got.score, "score_cpu": want.score, "launches": launches,
           "ms": wall_ms(card_nbv, 3)}
    check(got.target_obj == want.target_obj and got.rewards.shape == (nbv.N_DIVIDE + 1,)
          and rep["best"] == rep["best_cpu"] and rep["reward_err"] <= NBV_RTOL * scale
          and abs(got.score - want.score) <= NBV_RTOL * max(abs(want.score), 1e-3),
          f"13c NBV card vs CPU on {tag}: {rep}")
    check(launches["mlp_sdf_value_f32"] > 0, f"13c NBV launched the f32 value kernel: {rep}")
    print(f"phase 13c nbv.generate on {tag} (object {target}, the fixture decoder): best "
          f"candidate {rep['best']} (CPU {rep['best_cpu']}), {nbv.N_DIVIDE + 1} rewards within "
          f"{rep['reward_err']:.3g} of the CPU's (scale {scale:.4g}, tolerance {NBV_RTOL} "
          f"relative), uncertainty {got.score:.6f} (CPU {want.score:.6f}); {rep['ms']:.1f} ms "
          f"a call; kernels {launches}", flush=True)
    return rep, launches, want


def active_step(dev, smi, fixture, object_map):
    """13c: next-best-view and RRT on phase 10's map, and the renderer over
    its objects, each on the card against the port on the CPU."""
    from dsp_slam_rgbd_tpu_torch.active import rrt
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.ops import lie
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.system import renderer
    from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw

    state, cfg, t_cw = object_map
    dec_cpu = deepsdf.load_npz(FIXTURE, device="cpu")
    host = type(state)(*(t.cpu() for t in state))
    cam = cfg.cam
    cam_t_wc = lie.inv_se3(t_cw).cpu().numpy()
    launches = {}
    # the NBV target: the valid object that owns the most map points (the
    # synthetic objects carry no texture, so few map points, if any, fall inside one)
    valid = np.nonzero(host.obj_valid.numpy())[0]
    owner = host.pt_object.numpy()[host.pt_valid.numpy()]
    members = {int(o): int((owner == o).sum()) for o in valid}
    target = int(max(valid, key=lambda o: members[int(o)]))
    rep, launches["nbv"], want = nbv_card_vs_cpu(state, host, target, cam_t_wc, cam, fixture,
                                                 dec_cpu, "phase 10's map")
    rep["members"] = members
    # and an object whose member points sit near its surface (tests/test_torch_active.py's
    # fixture case), where the SDF errors weigh in the rewards
    small, small_host = fixture_object_map(dev)
    rep["fixture_object"], launches["nbv_fixture"], _ = nbv_card_vs_cpu(
        small, small_host, 0, np.eye(4, dtype=np.float32), cam, fixture, dec_cpu,
        "an object of the fixture's family with 200 members")
    start, goal = cam_t_wc[:3, 3], want.view_t_wc[:3, 3]
    t0 = time.perf_counter()
    path = rrt.plan(start, goal, rrt.obstacles_from_map(state)).path
    rep["rrt_ms"] = (time.perf_counter() - t0) * 1e3
    path_cpu = rrt.plan(start, goal, rrt.obstacles_from_map(host)).path
    rep["rrt_waypoints"] = None if path is None else len(path)
    check((path is None and path_cpu is None)
          or (path is not None and path_cpu is not None and np.array_equal(path, path_cpu)),
          f"13c RRT path on the card's obstacles equals the CPU's: {rep}")

    # the renderer: every object composited at stride 16, one object at stride 8
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]])
    hw = (pw.KITTI.h, pw.KITTI.w)
    mlp_sdf.reset_launch_counts()
    t0 = time.perf_counter()
    comp = renderer.render_map_objects(fixture, state, K, t_cw, hw, n_samples=16, stride=16)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    # one object alone: the valid one nearest the optical axis in front of the camera
    centers = (t_cw.cpu() @ host.obj_pose[valid])[:, :3, 3].numpy()
    ahead = centers[:, 2] > 0
    off_axis = np.where(ahead, np.linalg.norm(centers[:, :2], axis=1) / np.maximum(
        centers[:, 2], 1e-6), np.inf)
    o = int(valid[int(np.argmin(off_axis))])
    t_co = (t_cw @ state.obj_pose[o]).clone()
    t_co[:3, :3] *= state.obj_scale[o]
    one = renderer.render_object_depth(fixture, state.obj_code[o], t_co, K, hw, n_samples=16,
                                       stride=8)
    torch.cuda.synchronize()
    launches["render"] = dict(mlp_sdf.LAUNCHES)
    comp_cpu = renderer.render_map_objects(dec_cpu, host, K, t_cw.cpu(), hw, n_samples=16,
                                           stride=16)
    one_cpu = renderer.render_object_depth(dec_cpu, host.obj_code[o], t_co.cpu(), K, hw,
                                           n_samples=16, stride=8)
    cases = []
    for name, d, h, d_c, h_c in (("composite", comp, comp > 0, comp_cpu, comp_cpu > 0),
                                 ("object", one[0].cpu().numpy(), one[1].cpu().numpy(),
                                  one_cpu[0].numpy(), one_cpu[1].numpy())):
        both = h & h_c
        cases.append({"image": name, "pixels": int(h.size), "hit": int(h.sum()),
                      "hit_differs": float((h != h_c).mean()),
                      "depth_err_m": float(np.abs(d - d_c)[both].max()) if both.any() else 0.0})
    rep.update(render=cases, render_ms=render_ms, render_launches=launches["render"])
    check(all(c["hit"] > 0 and c["hit_differs"] <= RENDER_HIT_SHARE
              and c["depth_err_m"] <= RENDER_DEPTH_TOL for c in cases)
          and launches["render"]["mlp_sdf_value_f32"] > 0, f"13c renderer card vs CPU: {rep}")
    rep["render_object"] = o
    print(f"phase 13c rrt.plan on phase 10's map: {rep['rrt_ms']:.1f} ms, "
          f"{rep['rrt_waypoints']} waypoints, equal to the CPU's; member points by object "
          f"{members}; renderer: " + "; ".join(
              f"{c['image']} {c['pixels']} px, {c['hit']} hit, hit masks differ at "
              f"{c['hit_differs']:.4%}, depth within {c['depth_err_m']:.3g} m" for c in cases)
          + f" of the CPU's; composite {render_ms:.1f} ms, kernels {launches['render']} on {smi}",
          flush=True)
    return rep, launches


def scale_out_phase(dev, smi, fixture, recon_args, corridor, object_map):
    """Phase 13 (see the module docstring) -> (the report's "scale_out" entry,
    each kernel's launches on this phase's paths)."""
    import torch.distributed as tdist

    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
    from dsp_slam_rgbd_tpu_torch.parallel import mesh as mesh_mod
    from dsp_slam_rgbd_tpu_torch.parallel import sharded_recon
    from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt

    t_phase = time.perf_counter()
    rep = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        dist.initialize(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        try:
            rep["backend"] = tdist.get_backend()
            mesh = mesh_mod.make_mesh(1, 1)
            batch = dict(zip(sharded_recon.BATCH_KEYS[:-1], recon_args))
            batch["code_init"] = torch.zeros(recon_args[0].shape[0], 64, device=dev)
            rep["recon"] = [
                sharded_recon_step(fixture, opt.ReconConfig.gpu_fast(num_iterations=ITERS),
                                   opt.FAST_DTYPE, batch, mesh, "gpu_fast bf16", smi),
                sharded_recon_step(fixture, opt.ReconConfig(), torch.float32, batch, mesh,
                                   "ReconConfig() f32", smi)]
            rep["ba"] = sharded_ba_step(corridor, mesh, smi)
        finally:
            tdist.destroy_process_group()
        rep["cli"], cli = distributed_cli_step(dev, smi, tmp)
    rep["active"], act = active_step(dev, smi, fixture, object_map)
    # each path's own counts, read just after it (each reset just before it)
    paths = {"13a gpu_fast bf16": rep["recon"][0]["launches"],
             "13a ReconConfig() f32": rep["recon"][1]["launches"],
             "13b --distributed": cli["distributed"], "13b (1, 1) mesh": cli["mesh"],
             "13c nbv on phase 10's map": act["nbv"],
             "13c nbv on a fixture object": act["nbv_fixture"], "13c renderer": act["render"]}
    rep["launches_by_path"] = paths
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13 launches by path {paths}; phase 13 took {rep['phase_s']:.0f} s; "
          f"scaling at N >= 2 ranks not measured (one card)", flush=True)
    return rep, paths


# ---------------------------------------------------------------------------
# phase 14: the benches and the aux tools
# ---------------------------------------------------------------------------
# card against CPU in 14e: extracted vertices within 1e-4 (each vertex's nearest
# neighbour in the other mesh: a grid value within the card-CPU difference of 0 may
# take the other marching case, which moves no vertex off its grid point);
# render_objects depths within 2e-5 m where both hit (tests/test_torch_renderer.py),
# hit masks differing at <= 0.1% of pixels (13c's); ATE within 1e-6 m of 12a's;
# three training steps' losses within 1e-4 relative
TOOLS_VERTEX_TOL, TOOLS_DEPTH_TOL, TOOLS_HIT_SHARE = 1e-4, 2e-5, 1e-3
TOOLS_ATE_TOL, TOOLS_LOSS_RTOL = 1e-6, 1e-4


def _ply_vertices(path):
    with open(path) as f:
        lines = f.read().splitlines()
    nv = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
    nf = int(next(ln for ln in lines if ln.startswith("element face")).split()[-1])
    body = lines[lines.index("end_header") + 1:]
    return np.array([ln.split()[:3] for ln in body[:nv]], np.float64).reshape(-1, 3), nf


def _vertex_gap(a, b):
    """The largest distance from a vertex of either mesh to the other's nearest."""
    from scipy.spatial import cKDTree

    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else float("inf")
    return float(max(cKDTree(b).query(a)[0].max(), cKDTree(a).query(b)[0].max()))


def _launched(fn):
    """(fn's result, each decoder kernel's launches in it, seconds)."""
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf

    mlp_sdf.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(mlp_sdf.LAUNCHES), time.perf_counter() - t0


def aux_tools_step(dev, smi, keep, ate12a):
    """14e: the aux tools on 12a's output directory, card against CPU ->
    (report entry, launches by path)."""
    import shutil

    from dsp_slam_rgbd_tpu_torch.system import png
    from dsp_slam_rgbd_tpu_torch.system.sequence import load_label_file
    from dsp_slam_rgbd_tpu_torch.tools import (convert_reference_labels, evaluate_ate,
                                               extract_map_objects, render_objects,
                                               train_fixture_decoder, visualize_map)

    out12a = os.path.join(keep, "out12a")
    rep, paths, secs = {}, {}, {}
    # evaluate_ate: 12a's ATE on the card
    ate, _, secs["evaluate_ate"] = _launched(lambda: evaluate_ate.main(
        [os.path.join(out12a, "CameraTrajectory.txt"), os.path.join(out12a, "gt.txt")]))
    rep["ate_m"] = ate["ate_rmse"]
    check(abs(ate["ate_rmse"] - ate12a) <= TOOLS_ATE_TOL,
          f"14e evaluate_ate {ate['ate_rmse']} within {TOOLS_ATE_TOL} m of 12a's {ate12a}")
    # extract_map_objects and visualize_map, card and CPU, each into its own copy
    runs = {}
    for device in ("cuda", "cpu"):
        d = os.path.join(keep, f"map14_{device}")
        shutil.copytree(out12a, d)
        dev_args = ["--device", device]
        meshes, n_ext, s_ext = _launched(lambda: extract_map_objects.main(
            [d, FIXTURE, "--voxels", "32", *dev_args]))
        scene, n_viz, s_viz = _launched(lambda: visualize_map.main(
            [d, "--deepsdf", FIXTURE, "--png", os.path.join(d, "map.png"), *dev_args]))
        runs[device] = (d, meshes, scene)
        if device == "cuda":
            paths["14e extract_map_objects"], paths["14e visualize_map"] = n_ext, n_viz
            secs["extract_map_objects"], secs["visualize_map"] = s_ext, s_viz
        else:
            secs["extract_map_objects_cpu"], secs["visualize_map_cpu"] = s_ext, s_viz
    (dg, mg, sg), (dc, mc, sc) = runs["cuda"], runs["cpu"]
    check(sorted(mg) == sorted(mc) and len(mg) >= 7, f"14e the same objects: {sorted(mg)}")
    gaps = {}
    for oid in mg:
        vg, fg = _ply_vertices(os.path.join(dg, "meshes", f"{oid}.ply"))
        vc, fc = _ply_vertices(os.path.join(dc, "meshes", f"{oid}.ply"))
        check(len(vg) > 0 and fg > 0, f"14e object {oid} meshed on the card")
        gaps[oid] = (_vertex_gap(vg, vc), fg, fc)
    gap = max(g for g, _, _ in gaps.values())
    check(gap <= TOOLS_VERTEX_TOL, f"14e extract_map_objects card vs CPU vertices: {gaps}")
    vg, fg = _ply_vertices(os.path.join(dg, "scene.ply"))
    vc, fc = _ply_vertices(os.path.join(dc, "scene.ply"))
    scene_gap = _vertex_gap(vg, vc)
    check(scene_gap <= TOOLS_VERTEX_TOL and fg > 0,
          f"14e visualize_map scene.ply card vs CPU: {scene_gap}, faces {fg} / {fc}")
    img = png.read_png(os.path.join(dg, "map.png"))
    check(np.array_equal(img, png.read_png(os.path.join(dc, "map.png")))
          and int(np.all(img == visualize_map.TRAJECTORY_RGB, -1).sum()) > 0,
          "14e visualize_map's PNG: the card's equals the CPU's, trajectory drawn")
    for name in ("extract_map_objects", "visualize_map"):
        n = paths[f"14e {name}"]
        check(n["mlp_sdf_value_f32"] > 0, f"14e {name} launched the f32 value kernel: {n}")
    rep.update(extract_vertex_gap=gap, extract_faces={int(k): [f1, f2] for k, (_, f1, f2)
                                                      in gaps.items()},
               scene_vertex_gap=scene_gap, scene_faces=[fg, fc])
    # render_objects at stride 16 (the CPU's share of the comparison stays short)
    rend = {}
    for device in ("cuda", "cpu"):
        rend[device], n, s = _launched(lambda: render_objects.main(
            [out12a, os.path.join(keep, f"render14_{device}"), "--decoder", FIXTURE,
             "--stride", "16", "--device", device]))
        if device == "cuda":
            paths["14e render_objects"], secs["render_objects"] = n, s
        else:
            secs["render_objects_cpu"] = s
    check(paths["14e render_objects"]["mlp_sdf_value_f32"] > 0,
          f"14e render_objects launched the f32 value kernel: {paths['14e render_objects']}")
    d_err, hit_diff, hits = 0.0, 0, 0
    for o, (dg_, hg) in rend["cuda"].items():
        dc_, hc = rend["cpu"][o]
        both = hg & hc
        hits += int(hg.sum())
        hit_diff += int((hg != hc).sum())
        if both.any():
            d_err = max(d_err, float(np.abs(dg_[both] - dc_[both]).max()))
    n_px = sum(h.size for _, h in rend["cuda"].values())
    check(hits > 0 and d_err <= TOOLS_DEPTH_TOL and hit_diff <= TOOLS_HIT_SHARE * n_px,
          f"14e render_objects card vs CPU: depth {d_err}, hit masks differ at {hit_diff} of "
          f"{n_px} px ({hits} hit)")
    rep.update(render_depth_err=d_err, render_hit_diff=hit_diff, render_px=n_px,
               render_hits=hits)
    # train_fixture_decoder: 3 full-width steps on each, the same weights and batches
    losses = {}
    for device in ("cuda", "cpu"):
        res, _, s = _launched(lambda: train_fixture_decoder.main(
            ["--steps", "3", "--out", os.path.join(keep, f"train14_{device}.npz"),
             "--device", device]))
        losses[device] = res["losses"]
        secs[f"train_fixture_decoder_3_steps_{device}"] = s
    rel = float(np.abs(losses["cuda"] - losses["cpu"]).max() / np.abs(losses["cpu"]).max())
    check(rel <= TOOLS_LOSS_RTOL, f"14e train_fixture_decoder losses card {losses['cuda']} vs "
          f"CPU {losses['cpu']}: {rel} relative")
    rep.update(train_losses_card=losses["cuda"].tolist(), train_losses_cpu=losses["cpu"].tolist(),
               train_loss_rel=rel)
    # convert_reference_labels on a synthesized .lbl (host only)
    lbl = os.path.join(keep, "lbl14")
    os.makedirs(lbl)
    torch.save({"boxes": torch.tensor([[2.0, 1.5, 14.0, 4.0, 1.6, 1.8, 0.3]])},
               os.path.join(lbl, "000000.lbl"))
    counts, _, secs["convert_reference_labels"] = _launched(lambda: convert_reference_labels.main(
        [lbl, os.path.join(keep, "labels14")]))
    dets = load_label_file(os.path.join(keep, "labels14", "000000.npz"))
    check(counts == {"000000": 1} and len(dets) == 1 and abs(dets[0].scale - 2.0) < 1e-6,
          f"14e convert_reference_labels: {counts}")
    rep["seconds"] = secs
    print(f"phase 14e aux tools on 12a's output directory: evaluate_ate {rep['ate_m']:.6f} m "
          f"(12a {ate12a:.6f}); extract_map_objects {len(mg)} objects at 32^3, vertices within "
          f"{gap:.3g} of the CPU's, faces card/CPU "
          + ", ".join(f"{k}: {f1}/{f2}" for k, (_, f1, f2) in sorted(gaps.items()))
          + f"; visualize_map scene.ply {len(vg)} vertices, {fg} faces (CPU {fc}), within "
          f"{scene_gap:.3g}, the PNGs equal; render_objects (stride 16) {hits} hit px, depth "
          f"within {d_err:.3g} m of the CPU's, hit masks differ at {hit_diff} of {n_px} px; "
          f"train_fixture_decoder 3 steps, losses card {losses['cuda'].tolist()} CPU "
          f"{losses['cpu'].tolist()} ({rel:.3g} relative); convert_reference_labels "
          f"{counts}; seconds " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f"; decoder launches by path {paths} on {smi}", flush=True)
    return rep, paths


def tools_phase(dev, smi, keep, phase4_fits_per_s, ate12a):
    """Phase 14 (see the module docstring) -> (the report's "tools" entry,
    each kernel's launches on this phase's paths)."""
    from dsp_slam_rgbd_tpu_torch.tools import bench, bench_pipeline, bench_scaling, bench_tracking

    t_phase = time.perf_counter()
    rep, paths = {"card": smi}, {}
    # ---- 14a. the fits/s bench at its default shapes
    (line, res), n, s = _launched(lambda: bench.main(["--pipeline-frames", "0"]))
    paths["14a bench"] = n
    check(n["mlp_sdf_value"] > 0 and n["mlp_sdf_jacobian"] > 0,
          f"14a both bf16 kernels launched by the bench: {n}")
    check(bool(torch.isfinite(res.t_cam_obj).all()) and bool(res.is_good.all()),
          f"14a every fit finite and is_good: {res.is_good.tolist()}")
    rep["bench"] = dict(line, seconds=s, is_good=res.is_good.tolist())
    print(f"phase 14a tools/bench.py (B=8, 256 points, 512 rays, 10 GN iterations, gpu_fast "
          f"bf16, fixture decoder, 10 chained calls): {line['value']:.2f} fits/s (phase 4 in "
          f"this call: {phase4_fits_per_s:.2f}), mfu {line['mfu']}, {line['model_tflops']:.3f} "
          f"TFLOP/s; every fit is_good; launches {n}; {s:.1f} s on {smi}", flush=True)
    # ---- 14b. the tracking bench at KITTI size
    (line, launches), n, s = _launched(lambda: bench_tracking.main(["--frames", "10"]))
    check(np.isfinite(line["per_frame_ms"]) and launches > 0, f"14b tracking bench: {line}")
    rep["tracking"] = dict(line, launches_per_frame=launches, seconds=s)
    print(f"phase 14b tools/bench_tracking.py (1241x376, 2,000 features, 8 levels, 10 frames): "
          f"{line['per_frame_ms']:.2f} ms a frame ({line['value']:.2f} fps), {launches} "
          f"launches a frame; {s:.1f} s on {smi}", flush=True)
    # ---- 14c. the whole pipeline, short: 6 frames, one timed pass
    p, n, s = _launched(lambda: bench_pipeline.run(frames=6, passes=1, device=dev))
    paths["14c bench_pipeline"] = n
    check(p["keyframes"] >= 1 and p["objects"] >= 1 and np.isfinite(p["value"]),
          f"14c at least one keyframe and one object: {p}")
    check(n["mlp_sdf_value"] > 0, f"14c the bf16 value kernel launched (gpu_fast): {n}")
    rep["pipeline"] = dict(p, seconds=s)
    print(f"phase 14c tools/bench_pipeline.run(frames=6, passes=1) (short: the tool's default "
          f"is 36 frames, 3 passes): {p['value']:.3f} fps, tracking-only {p['track_only_ms']} ms, "
          f"keyframe frames {p['kf_frame_ms']} ms, {p['keyframes']} keyframes, {p['objects']} "
          f"objects, sync rtt {p['sync_rtt_ms']:.3f} ms; launches {n}; {s:.1f} s on {smi}",
          flush=True)
    # ---- 14d. sharded reconstruction at one rank over NCCL
    rows, n, s = _launched(lambda: bench_scaling.main([]))
    paths["14d bench_scaling"] = n
    check(len(rows) == 1 and rows[0]["devices"] == 1 and n["mlp_sdf_value_f32"] > 0
          and n["mlp_sdf_jacobian_f32"] > 0, f"14d one rank, both f32 kernels: {rows} {n}")
    rep["scaling"] = dict(rows[0], seconds=s)
    print(f"phase 14d tools/bench_scaling.py (one rank, NCCL; ReconConfig() f32, 8 objects, "
          f"256 points, 512 rays, 3 calls): {rows[0]}; launches {n}; {s:.1f} s on {smi}; "
          f"N >= 2 ranks not measured (one card)", flush=True)
    # ---- 14e. the aux tools
    rep["aux"], aux_paths = aux_tools_step(dev, smi, keep, ate12a)
    paths.update(aux_paths)
    seen = {k for n in paths.values() for k, v in n.items() if v > 0}
    check(seen == {"mlp_sdf_value", "mlp_sdf_jacobian", "mlp_sdf_value_f32",
                   "mlp_sdf_jacobian_f32"}, f"phase 14 launched all four kernels: {paths}")
    rep["launches_by_path"] = paths
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14 launches by path {paths}; phase 14 took {rep['phase_s']:.0f} s", flush=True)
    return rep, paths


# ---------------------------------------------------------------------------
# phase 15: the decoder kernels repeat bit for bit inside the SLAM loop
# ---------------------------------------------------------------------------
# The f32 Jacobian kernel before its ring's proxy fence (the parent commit's):
# calls whose three results differed, per call, on an H100 80GB HBM3 at 700 W
# (`kernel_repeat loop --runs 12 --deterministic`: 1 of 600; this phase's
# stress run: 707 of 3,741; PERF.md §6)
PARENT_FAULTS_PER_CALL = {"loop": 1 / 600, "stress": 707 / 3741}
REPEAT_LOOP_RUNS, REPEAT_LOOP_FAST_FRAMES = 1, 6
REPEAT_STRESS_S, REPEAT_STRESS_CALLS = 15.0, 1500
REPEAT_MIN_EXPECTED = 5.0
ALL_KERNELS = ("mlp_sdf_value", "mlp_sdf_jacobian", "mlp_sdf_value_f32", "mlp_sdf_jacobian_f32")


def repeat_phase(smi):
    """Phase 15 (see the module docstring) -> the report's "repeat" entry."""
    from dsp_slam_rgbd_tpu_torch.tools import kernel_repeat as kr

    t_phase = time.perf_counter()
    runs = {"loop-fast": kr.loop_fast(1, frames=REPEAT_LOOP_FAST_FRAMES),
            "stress": kr.stress(REPEAT_STRESS_CALLS, REPEAT_STRESS_S, kr.NOISE),
            # under the deterministic algorithms, which it turns off again after
            "loop": kr.loop(REPEAT_LOOP_RUNS, deterministic=True)}
    for mode, s in runs.items():
        for name, k in s["kernels"].items():
            print(f"phase 15 {mode}: {name} {k['differ']} of {k['calls']} calls differ; "
                  f"(calls, differ) by tiling {k['tilings']}; rows {k['rows']}", flush=True)
    f32_jac = {m: s["kernels"].get("mlp_sdf_jacobian_f32", {"calls": 0})["calls"]
               for m, s in runs.items()}
    by_mode = {m: f32_jac[m] * rate for m, rate in PARENT_FAULTS_PER_CALL.items()}
    expected = sum(by_mode.values())
    rep = {"runs": {m: {k: s[k] for k in ("calls", "differ", "kernels", "findings")}
                    for m, s in runs.items()},
           "parent_expected_faults": expected, "parent_expected_faults_by_mode": by_mode,
           "card": smi}
    rep["phase_s"] = time.perf_counter() - t_phase
    rounded = {m: round(e, 2) for m, e in by_mode.items()}
    print(f"phase 15 the f32 Jacobian kernel without its proxy fence would have given "
          f"{expected:.1f} faults ({rounded} by mode) in these {f32_jac} calls; "
          f"phase 15 took {rep['phase_s']:.0f} s on {smi}", flush=True)
    for m, s in runs.items():
        check(s["differ"] == 0, f"15 {m}: every decoder kernel call repeats: {s['findings']}")
    check(set(runs["loop"]["kernels"]) >= {"mlp_sdf_value_f32", "mlp_sdf_jacobian_f32"}
          and set(runs["loop-fast"]["kernels"]) >= {"mlp_sdf_value", "mlp_sdf_jacobian"}
          and set(runs["stress"]["kernels"]) == set(ALL_KERNELS),
          f"15 all four kernels inside the loop and under stress: "
          f"{ {m: sorted(s['kernels']) for m, s in runs.items()} }")
    check(expected >= REPEAT_MIN_EXPECTED,
          f"15 enough calls to catch the fault without the fence: {expected:.1f} expected")
    return rep


# ---------------------------------------------------------------------------
# phase 16: a loop closes at KITTI size with objects through the command line
# ---------------------------------------------------------------------------
# the JAX package's command line on the CPU over phase 16's directory with phase 16's
# arguments and the port's feature slots (`JAX_PLATFORMS=cpu python
# tests/tracking_driver.py circuit DIR`, the world frozen before the port's first card
# run), both runs loading the vocabulary the JAX command line bootstrapped there
# (`tracking_driver.CIRCUIT_VOCAB`; with its own, JAX closes as the port does with the
# port's: the vocabulary, not the loop path, moves these numbers):
# the ATE of CameraTrajectory_TUM.txt's rows after a rigid alignment, the largest
# translation error, the gap between frames 0 and 90, the largest lap-2 error against
# lap 1, the closures, keyframes and dropped keyframes, the map objects, and each static
# truth's nearest map object (m), and the map objects within 1.5 m of each truth.
# The lap gap moves with the vocabulary: JAX's own bootstrap with k-medians seeds 1-3
# (`circuit DIR --train --seed S`) closes at 0.003378, 0.011437 and 0.018885 m (ATE
# 0.0229 m, lap-2 0.0418-0.0457 m), so the gap's band holds for this vocabulary only
JAX_CIRCUIT = {"rows": 105, "ate_m": 0.02401210181415081, "max_err_m": 0.09534947330267496,
               "lap_gap_m": 0.013105206973565889, "lap2_max_m": 0.04282593765511781,
               "loop_closures": 1, "keyframes": 31, "kf_slots_exhausted": 0, "map_objects": 6,
               "truth_nearest_m": [0.013450478533414047, 0.027309904655167014,
                                   0.025082025021968803, 0.017401720353472417,
                                   0.03244585199036251, 0.03542012767798931],
               "truth_objects_within_1_5m": [1, 1, 1, 1, 1, 1],
               # each closure's keyframes as frame ids [query, candidate]
               "closure_pairs": [[88, 10]]}
# phase 16's bars against JAX_CIRCUIT: 12a's band on the ATE, the lap gap and the
# lap-2 error; 12a's 0.3 m on each truth's nearest map object;
# `fuse_duplicate_objects`' 1.5 m
CIRCUIT_BAND, CIRCUIT_OBJ_M, CIRCUIT_FUSE_M = 1.5, 0.3, 1.5


def circuit_phase(dev, smi):
    """Phase 16: the port's command line over `write_kitti_circuit`'s
    directory on the card with the default `async_kf_frames`, held to
    JAX_CIRCUIT -> (the report's "circuit" entry, {path: decoder launches})."""
    import shutil
    from unittest import mock

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import tracking_driver as td
    from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
    from dsp_slam_rgbd_tpu_torch.system import mapping_stage as mstage
    from dsp_slam_rgbd_tpu_torch.system import slam
    from dsp_slam_rgbd_tpu_torch.tools import run_slam
    from dsp_slam_rgbd_tpu_torch.tools import sequence_dirs as sd

    t_phase = time.perf_counter()
    correct_ms, correct_calls, adopted, unchanged, prewait = [], [], [], [], {}
    pairs = []   # the keyframes each closure joins, as frame ids
    correct_loop = mstage.loop_closing.correct_loop
    adopt, process, prewait_mapping = (slam.SLAMSystem._adopt, mstage.MappingStage.process,
                                       slam.SLAMSystem._prewait_mapping)

    def timed_correct_loop(*a, **k):   # on the worker's thread and stream, untraced
        pairs.append(td.closure_pair(a))
        torch.cuda.current_stream().synchronize()
        t = time.perf_counter()
        r = correct_loop(*a, **k)
        torch.cuda.current_stream().synchronize()
        correct_ms.append((time.perf_counter() - t) * 1e3)
        correct_calls[:] = correct_calls or [(a, k, r)]   # the first call's inputs and result
        return r

    def watched_adopt(self, entry):
        b = self.blocked_ms["adopt"]
        adopt(self, entry)
        res = entry[1]["result"]
        if res.pt_remap is not None:
            adopted.append({"frame": self.tracker.frame_id + 1, "kid": res.kid,
                            "blocked_ms": self.blocked_ms["adopt"] - b})

    def watched_prewait(self):
        b = self.blocked_ms["prewait"]
        prewait_mapping(self)
        prewait[self.tracker.frame_id] = self.blocked_ms["prewait"] - b   # the frame tracked

    def checked_process(self, job):   # no job writes its input state's tensors in place
        state = self.state
        before = [getattr(state, k)._version for k in state._fields]
        res = process(self, job)
        unchanged.append([getattr(state, k)._version for k in state._fields] == before)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = sd.write_kitti_circuit(os.path.join(tmp, "circuit"))
        write_s = time.perf_counter() - t0
        out = os.path.join(tmp, "out16")
        vocab = os.path.join(tmp, "vocab16.npz")   # loaded: the JAX run's, as JAX_CIRCUIT's
        shutil.copy(td.CIRCUIT_VOCAB, vocab)
        mlp_sdf.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(mstage.loop_closing, "correct_loop", timed_correct_loop), \
                mock.patch.object(slam.SLAMSystem, "_adopt", watched_adopt), \
                mock.patch.object(slam.SLAMSystem, "_prewait_mapping", watched_prewait), \
                mock.patch.object(mstage.MappingStage, "process", checked_process), \
                counting_scatters("16 loop circuit"), capturing_scatters("16", ("pose_graph.py",)):
            res = run_slam.main(td.circuit_args(paths, out, vocab))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(mlp_sdf.LAUNCHES)
        got = td.circuit_metrics(paths, out)
    system, summ = res["system"], res["summary"]
    ok = np.array([bool(o) for _, _, o in system.tracker.trajectory])
    ms_ = np.asarray(res["track_ms"])
    at_adoption = [float(ms_[a["frame"]]) for a in adopted if a["frame"] < len(ms_)]
    # correct_loop's launches and host syncs: its first call again on its own
    # inputs, twice, on this thread (the worker's call, timed untraced, shared
    # the card with the tracker's thread); syncs as 11c counts them, launches
    # from a trace of the card's kernels launched by this thread only (the
    # host's ops of ~70,000 launches would take the tracer a minute).  Each
    # replay must give the worker's bits, and the two as many launches.
    t0 = time.perf_counter()
    cl_launches, cl_kernels, cl_busy, cl_syncs, replay_equal = [], [], 0.0, 0, False
    if correct_calls:
        a, k, worker_out = correct_calls[0]
        replay_equal = True
        for _ in range(2):
            replay, n, n_kern, cl_busy = stream_launches(lambda: correct_loop(*a, **k), dev)
            replay_equal = replay_equal and bits_equal(replay, worker_out)
            cl_launches.append(n)
            cl_kernels.append(n_kern)
        _, cl_syncs = with_syncs(lambda: correct_loop(*a, **k))
    replay_s = time.perf_counter() - t0
    rep = {"card": smi, "frames": got["frames"], "rows": got["rows"], "ok_share": float(ok.mean()),
           **{key: got[key] for key in ("ate_m", "max_err_m", "lap_gap_m", "lap2_max_m",
                                        "loop_closures", "keyframes", "kf_slots_exhausted",
                                        "map_objects", "truth_nearest_m",
                                        "truth_objects_within_1_5m")},
           "summary": summ, "jax_circuit_cpu": JAX_CIRCUIT, "remaps_adopted": adopted,
           "closure_pairs": pairs,
           "correct_loop_ms": correct_ms, "correct_loop_launches": cl_launches,
           "correct_loop_kernels_traced": cl_kernels,
           "correct_loop_replay_equal": replay_equal,
           "correct_loop_busy_ms": cl_busy, "correct_loop_host_syncs": cl_syncs,
           "frame_ms_at_adoption": at_adoption,
           # the job adopted at frame A is waited for in frames A-2 and A-1
           # (`_prewait_mapping` takes the job due by the frame after next)
           "prewait_ms_before_adoption": [[prewait.get(a["frame"] - d, 0.0) for d in (2, 1)]
                                          for a in adopted],
           "frame_ms_before_adoption": [[float(ms_[a["frame"] - d]) for d in (2, 1)]
                                        for a in adopted],
           "blocked_ms": res["blocked_ms"], "frame_ms_median": _median(ms_),
           "track_ms": ms_.tolist(), "kf_frames": res["kf_frames"], "launches": launches,
           "write_s": write_s, "run_s": run_s, "replay_s": replay_s}
    rep["phase_s"] = time.perf_counter() - t_phase
    jc = JAX_CIRCUIT
    print(f"phase 16 loop circuit at KITTI size (loop_world.KITTI: {got['frames']} 1241x376 "
          f"stereo frames, 6 static objects' label files, fixture decoder, the 10^4-word "
          f"vocabulary the JAX command line bootstrapped from {td.CIRCUIT_VOCAB_FRAMES} frames, "
          f"async_kf_frames "
          f"{system.cfg.async_kf_frames}): {summ['fps']} fps, track ms p50/p90/p99 "
          f"{summ['track_ms_p50']}/{summ['track_ms_p90']}/{summ['track_ms_p99']}; ok "
          f"{ok.mean():.3f}, {got['keyframes']} keyframes, {got['loop_closures']} closure(s), "
          f"remaps adopted at {adopted}; correct_loop in the worker "
          f"{', '.join(f'{x:.1f}' for x in correct_ms)} ms; twice again on this thread "
          f"{cl_launches} launches ({cl_kernels} of their kernels in the trace, the second's "
          f"busy {cl_busy:.1f} ms), {cl_syncs} host syncs, each result "
          f"bit for bit the worker's: {replay_equal}; "
          f"segment-sum launches {SCATTER_LAUNCHES['16 loop circuit']}; frame ms at the adoption "
          f"{', '.join(f'{x:.1f}' for x in at_adoption)} (median frame "
          f"{rep['frame_ms_median']:.1f}), the two frames before it "
          f"{rep['frame_ms_before_adoption']} ms, waiting in _prewait_mapping "
          f"{rep['prewait_ms_before_adoption']} ms; blocked in _adopt "
          f"{res['blocked_ms']['adopt']:.1f} ms, in _prewait_mapping "
          f"{res['blocked_ms']['prewait']:.1f} ms over the run", flush=True)
    print(f"phase 16 against the JAX command line on the CPU: ATE {got['ate_m']:.6f} m (JAX "
          f"{jc['ate_m']:.6f}), largest error {got['max_err_m']:.6f} m (JAX "
          f"{jc['max_err_m']:.6f}), lap gap {got['lap_gap_m']:.6f} m (JAX {jc['lap_gap_m']:.6f}), "
          f"lap-2 {got['lap2_max_m']:.6f} m (JAX {jc['lap2_max_m']:.6f}); {got['map_objects']} "
          f"map objects (JAX {jc['map_objects']}), each truth's nearest "
          f"{', '.join(f'{d:.4f}' for d in got['truth_nearest_m'])} m, map objects within "
          f"{CIRCUIT_FUSE_M} m {got['truth_objects_within_1_5m']}; closures join keyframes of "
          f"frames {pairs} (JAX {jc['closure_pairs']}); decoder launches {launches}; "
          f"write {write_s:.1f} s, run {run_s:.1f} s, correct_loop again {replay_s:.1f} s, "
          f"phase {rep['phase_s']:.0f} s on {smi}",
          flush=True)
    # the bars, after the numbers are printed
    check(got["rows"] == got["frames"] and ok.mean() > 0.9 and got["kf_slots_exhausted"] == 0,
          f"16 a row for every frame, > 90% tracked, no keyframe dropped: {rep}")
    check(got["loop_closures"] >= 1 and adopted, f"16 a closure adopted with its remap: {rep}")
    check(pairs == jc["closure_pairs"],
          f"16 the closures join the JAX command line's keyframes: frames {pairs}, JAX "
          f"{jc['closure_pairs']}")
    for key in ("ate_m", "lap_gap_m", "lap2_max_m"):
        check(got[key] <= CIRCUIT_BAND * jc[key], f"16 {key} {got[key]} within "
              f"{CIRCUIT_BAND}x the JAX command line's {jc[key]}")
    check(max(got["truth_nearest_m"]) < CIRCUIT_OBJ_M,
          f"16 every static truth within {CIRCUIT_OBJ_M} m of a map object: {rep}")
    check(max(got["truth_objects_within_1_5m"]) <= 1 and got["map_objects"] <= jc["map_objects"],
          f"16 no truth left with two map objects within {CIRCUIT_FUSE_M} m, no more map "
          f"objects than the JAX command line's {jc['map_objects']}: {rep}")
    check(unchanged and all(unchanged),
          f"16 no MapState tensor written in place by a job: {unchanged}")
    check(launches["mlp_sdf_value_f32"] > 0 and launches["mlp_sdf_jacobian_f32"] > 0,
          f"16 both f32 kernels launched from the command line's run: {launches}")
    check(replay_equal and len(cl_launches) == 2 and cl_launches[0] == cl_launches[1],
          f"16 correct_loop twice again on the worker's inputs gives the worker's map bit for "
          f"bit, with as many launches each time: equal {replay_equal}, launches {cl_launches}")
    return rep, {"16 loop circuit at KITTI size": launches}


# ---------------------------------------------------------------------------
# phase 17: the fixed-order scatter-add against the CPU's index_add_
# ---------------------------------------------------------------------------
PLAIN_MAX_SEGMENT = 512   # the plain version loops over a segment's rows: timed up to this


def scatter_phase(dev, smi, mem_bw):
    """Phase 17: the segment-sum kernel (`csrc/segment_sum.cu`, through
    `ops/scatter.py`) on every scatter the main path captured (9b's local
    BA and PCG, 12a's map normals, phase 16's pose graph: each `index_add`
    call, and each first scatter onto an output of each `scatter_adds`
    call) and on two heavy-duplicate cases, each bit for bit against
    `index_add_` on the CPU; each captured `scatter_adds` call (one launch)
    bit for bit against the CPU's `index_add_` calls in sequence and
    against the plain table on the card.  Times each with
    `tools/scatter_split.py` (`case_row`, `batched_row`): device µs a call
    from the profiler, host µs a call from the host clock over 200 calls,
    for the kernel, its plan and `index_add_`; the batched launch beside
    one launch a scatter -> the report's "segment_sum" entry."""
    from dsp_slam_rgbd_tpu_torch.ops import scatter
    from dsp_slam_rgbd_tpu_torch.ops.cuda import segment_sum as ss
    from dsp_slam_rgbd_tpu_torch.tools import scatter_split as sp

    t_phase = time.perf_counter()
    cases = dict(SCATTER_CASES)
    for site, outputs in BATCH_CASES.items():
        for k, (n, adds) in enumerate(outputs):
            p, src = adds[0]
            cases[f"{site} output {k}"] = (torch.zeros((n,) + tuple(src.shape[1:]),
                                                       dtype=src.dtype, device=dev), p, src)
    # heavy-duplicate cases beside the main path's
    cases.update(sp.heavy_cases(np.random.default_rng(17), dev))
    out = []
    for site, (out0, p, src) in cases.items():
        row = sp.case_row(site, out0, p, src)
        o, srcc = out0.clone(), src.contiguous()
        row["plain_ms"] = (cuda_ms(lambda: ss.segment_sum_plain(o, p.perm, p.offsets, srcc), 2)
                           if row["longest_segment"] <= PLAIN_MAX_SEGMENT else None)
        row["bound_ms"], row["bound_by"] = row["bytes"] / mem_bw * 1e3, "bytes"
        out.append(row)
        print(f"phase 17 segment_sum {sp.describe(row)}; plain "
              + (f"{row['plain_ms']:.3f} ms" if row["plain_ms"] is not None else "not measured")
              + f", bound {row['bound_ms'] * 1e3:.3f} us (bytes) on {smi}", flush=True)
    batched = []
    for site, outputs in BATCH_CASES.items():
        row = sp.batched_row(site, [(n, *adds) for n, adds in outputs])
        got = scatter.scatter_adds(*[(n, *adds) for n, adds in outputs])
        plain = [torch.full_like(o, float("nan")) for o in got]
        ss.segment_sum_table_plain([(o, p.perm, p.offsets, s.contiguous(), j == 0)
                                    for o, (_, adds) in zip(plain, outputs)
                                    for j, (p, s) in enumerate(adds)])
        row["plain_equal"] = all(bits_equal(a, b) for a, b in zip(got, plain))
        row["bound_ms"] = row["bytes"] / mem_bw * 1e3
        batched.append(row)
        print(f"phase 17 segment_sum batched {sp.describe_batched(row)}; the plain table on the "
              f"card: {row['plain_equal']}; bound {row['bound_ms'] * 1e3:.3f} us (bytes) on "
              f"{smi}", flush=True)
    # the plan's offsets kernel against its plain version at the main path's largest plan
    p = max((c[1] for site, c in cases.items() if not site.startswith("heavy")),
            key=lambda q: q.idx.numel())
    keys = torch.sort(torch.where(p.keep, p.idx, p.n) if p.keep is not None else p.idx).values
    keys = keys.int()
    offsets_equal = bool(torch.equal(ss.segment_offsets(keys, p.n),
                                     ss.segment_offsets_plain(keys, p.n)))
    offsets_row = sp.split(lambda: ss.segment_offsets(keys, p.n))
    plain_row = sp.split(lambda: ss.segment_offsets_plain(keys, p.n))
    for path, n in SCATTER_LAUNCHES.items():
        print(f"phase 17 launches on {path}: segment_sum {n['segment_sum']} carrying "
              f"{n['scatters']} scatter calls, segment_offsets {n['segment_offsets']}", flush=True)
    # the kernels' line: the main path's (12a's) launches and its scatter's times
    main = SCATTER_LAUNCHES.get("12a command line", {})
    at = next((r for r in out if r["site"].startswith("12a")), out[0])
    rep = {"kernels": [
        {"name": "segment_sum", "route": "cuda",
         "source": "dsp_slam_rgbd_tpu_torch/csrc/segment_sum.cu", "replaces": None,
         "launches": main.get("segment_sum"),
         "max_abs_err": 0.0 if all(r["bit_equal"] for r in out + batched) else None,
         "ms": at["kernel"]["device_us"] / 1e3, "plain_ms": at["plain_ms"],
         "bound_ms": at["bound_ms"], "bound_by": "bytes",
         "library_ms": at["index_add_"]["device_us"] / 1e3, "site": at["site"]},
        {"name": "segment_offsets", "route": "cuda",
         "source": "dsp_slam_rgbd_tpu_torch/csrc/segment_sum.cu", "replaces": None,
         "launches": main.get("segment_offsets"), "max_abs_err": 0.0 if offsets_equal else None,
         "ms": offsets_row["device_us"] / 1e3, "plain_ms": plain_row["device_us"] / 1e3,
         "bound_ms": (keys.numel() * 4 + (p.n + 1) * 8) / mem_bw * 1e3, "bound_by": "bytes",
         "library_ms": plain_row["device_us"] / 1e3, "rows": keys.numel()}],
        "launches_by_path": dict(SCATTER_LAUNCHES), "cases": out, "batched": batched,
        "offsets_host_us": offsets_row["host_us"], "card": smi,
        "phase_s": time.perf_counter() - t_phase}
    print(f"phase 17 segment_offsets at {keys.numel()} sorted keys onto {p.n} targets: equal to "
          f"torch.searchsorted: {offsets_equal}; device {offsets_row['device_us']:.2f} us, host "
          f"{offsets_row['host_us']:.2f} us (searchsorted device {plain_row['device_us']:.2f} "
          f"us); phase {rep['phase_s']:.0f} s on {smi}", flush=True)
    print("phase 17 " + json.dumps({"segment_sum": rep}), flush=True)
    check(all(r["bit_equal"] for r in out) and len(out) >= len(sp.HEAVY) + 4,
          f"17 the segment-sum kernel equals index_add_ on the CPU bit for bit: "
          f"{[(r['site'], r['bit_equal']) for r in out]}")
    check(batched and all(r["bit_equal"] and r["plain_equal"] for r in batched),
          f"17 every batched call site equals the CPU's index_add_ calls in sequence and the "
          f"plain table bit for bit: {[(r['site'], r['bit_equal'], r['plain_equal']) for r in batched]}")
    check(offsets_equal, "17 the offsets kernel equals its plain version")
    captured = {s.rsplit(" ", 1)[0] for s in list(SCATTER_CASES) + list(BATCH_CASES)}
    check({"9b local", "9b PCG", "12a", "16"} <= captured,
          f"17 scatters captured on every path: {sorted(captured)}")
    check(all(v["segment_sum"] > 0 and v["segment_offsets"] > 0
              for v in SCATTER_LAUNCHES.values()),
          f"17 the segment-sum and offsets kernels launched on every path: {SCATTER_LAUNCHES}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="write the measured numbers to this JSON file")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dsp_slam_rgbd_tpu_torch.models import deepsdf, mesh
    from dsp_slam_rgbd_tpu_torch.ops.cuda import build, mlp_sdf
    from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt
    from dsp_slam_rgbd_tpu_torch.tools import ellipsoid

    dev = torch.device("cuda")
    report = {}

    # ---- 1. device
    smi = smi_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| nvcc {nvcc}", flush=True)
    peak_bf16, mem_bw = next(v for k, v in PEAKS.items() if k in name)

    # ---- 2. build
    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    report["build"] = {"seconds": build_s, "ptxas": ptxas}
    print(f"phase 2 build: {build_s:.1f} s (nvcc {build.build_seconds} s); "
          f"{' / '.join(ptxas[:8])}", flush=True)
    cfgs = {}
    for kind, kernel, config in (("value", "mlp_sdf_value_tc_kernel", mlp_sdf.value_kernel_config),
                                 ("jacobian", "mlp_sdf_jacobian_tc_kernel",
                                  mlp_sdf.jacobian_kernel_config)):
        cfg_k = cfgs[kind] = config()
        n_hgmma = hgmma_count(build, kernel)
        check(n_hgmma > 0, f"HGMMA instructions in the bf16 {kind} kernel")
        check(cfg_k["local_bytes"] == 0, f"the bf16 {kind} kernel does not spill: {cfg_k}")
        report["build"][f"{kind}_kernel"] = dict(cfg_k, hgmma=n_hgmma)
        print(f"phase 2 bf16 {kind} kernel: {n_hgmma} HGMMA in its SASS; stage "
              f"{cfg_k['stage']}, {cfg_k['smem_bytes']} B shared memory per block, "
              f"{cfg_k['threads']} threads, {cfg_k['rows_per_block']} rows per block, "
              f"{cfg_k['registers']} registers, {cfg_k['local_bytes']} B local", flush=True)
    vcfg, jcfg = cfgs["value"], cfgs["jacobian"]
    f32cfg = mlp_sdf.f32_kernel_config()
    report["build"]["f32_kernels"] = f32cfg
    for kind, tilings in f32cfg.items():
        for cfg_k in tilings:
            check(cfg_k["local_bytes"] == 0, f"the f32 {kind} kernel does not spill: {cfg_k}")
        print(f"phase 2 f32 {kind} kernel (csrc/mlp_sdf_f32.cu): " + "; ".join(
            f"{k['rows_per_tile']} rows x C={k['cluster']}: {k['smem_bytes']} B shared memory "
            f"per CTA, {k['threads']} threads, {k['ring_slots']} ring slots of {k['slot_bytes']} "
            f"B, {k['registers']} registers, {k['local_bytes']} B local, "
            f"{k['clusters_resident']} clusters resident" for k in tilings)
            + "; tiling by rows: " + ", ".join(
            f"{n}: {mlp_sdf.f32_tiling(kind, n)}"
            for n in (1, 512, 1024, 2048, 4096, 14336, 57344, 96768)), flush=True)

    # ---- 3. kernels vs plain versions at cars_64 width
    dec = deepsdf.init_decoder(deepsdf.DecoderSpec(), seed=0, device=dev)
    gen = np.random.default_rng(0)
    cases = []
    for n, per_row in ((300, False), (700, True)):
        code = torch.tensor(gen.standard_normal((n, 64) if per_row else 64) * 0.2,
                            dtype=torch.float32, device=dev)
        xyz = torch.tensor(gen.standard_normal((n, 3)) * 0.5, dtype=torch.float32,
                           device=dev)
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            wb = dec.packed(dt)
            tag = f"n={n} {'per-row' if per_row else 'shared'} {dt}"
            v_k = mlp_sdf.sdf_value_fused(wb, code, xyz, dt, dec.tiles(dt))
            if dt == torch.float32:
                s_k, g_k = mlp_sdf.sdf_and_input_jacobian_fused(wb, code, xyz, dt,
                                                                dec.tiles(dt, jacobian=True))
                s_p, g_p = mlp_sdf.sdf_and_input_jacobian_plain(wb, code, xyz, dt)
                torch.cuda.synchronize()
                for t in (s_k, g_k):
                    check(bool(torch.isfinite(t).all()), f"{tag}: finite kernel output")
                keep = mlp_sdf.relu_margin(wb, code, xyz) >= TIE
                check(float(keep.float().mean()) >= 0.9, f"{tag}: <=10% near-tie rows")
                e_g = float((g_k - g_p)[keep].abs().max())
                case = {"case": tag, "sdf_err": float((s_k - s_p).abs().max()), "jac_err": e_g}
                check(case["sdf_err"] <= SDF_ATOL and e_g <= JAC_ATOL, f"{tag}: {case}")
            else:
                s_k, g_k, _, case = hold_bf16_jacobian(mlp_sdf, wb, dec.jacobian_tiles, code,
                                                       xyz, tag)
                s_p = mlp_sdf.sdf_value_plain(wb, code, xyz, dt)
            check(bool(torch.isfinite(v_k).all()), f"{tag}: finite value kernel output")
            e_v = float((v_k - s_p).abs().max())
            check(e_v <= (SDF_ATOL if dt == torch.float32 else BF16_SDF_ATOL),
                  f"{tag}: value kernel sdf {e_v}")
            case["value_sdf_err"] = e_v
            res[dt] = g_k
            cases.append(case)
        jf, jb = res[torch.float32], res[torch.bfloat16]
        cos = (jf * jb).sum(1) / (jf.norm(dim=1) * jb.norm(dim=1) + 1e-12)
        check(float(cos.min()) >= 0.90 and frob_rel(jb, jf) <= 0.25,
              f"n={n}: bf16 vs f32 cos {float(cos.min())} frob {frob_rel(jb, jf)}")
        cases.append({"case": f"n={n} bf16 vs f32", "cos_min": float(cos.min()),
                      "frob": frob_rel(jb, jf)})
    # the bf16 value kernel at ragged sizes and every code form, random weights
    bf = torch.bfloat16
    for n in VALUE_ROWS:
        for form, code, xyz in code_forms(n, gen, dev):
            v_k = mlp_sdf.sdf_value_fused(dec.packed(bf), code, xyz, bf, dec.value_tiles)
            v_p = mlp_sdf.sdf_value_plain(dec.packed(bf), code, xyz, bf)
            torch.cuda.synchronize()
            tag = f"value n={n} {form} bf16"
            check(v_k.shape == v_p.shape and bool(torch.isfinite(v_k).all()),
                  f"{tag}: finite kernel output of the plain version's shape")
            e_s = float((v_k - v_p).abs().max())
            check(e_s <= BF16_SDF_ATOL, f"{tag}: sdf {e_s}")
            cases.append({"case": tag, "sdf_err": e_s})
    # the bf16 Jacobian kernel likewise
    for n in JAC_ROWS:
        for form, code, xyz in code_forms(n, gen, dev):
            cases.append(hold_bf16_jacobian(mlp_sdf, dec.packed(bf), dec.jacobian_tiles, code,
                                            xyz, f"jacobian n={n} {form} bf16")[3])
    # both f32 kernels at ragged sizes and every code form, with the tiling
    # the launcher picks and with each tiling forced
    f32_seen = set()
    for force, rows in ((None, F32_ROWS),) + tuple((t, (1, 33, 2049))
                                                   for t in mlp_sdf.F32_TILINGS):
        mlp_sdf.force_f32_tiling(force)
        try:
            for n in rows:
                for form, code, xyz in code_forms(n, gen, dev):
                    case = hold_f32(mlp_sdf, dec, code, xyz, f"f32 n={n} {form} "
                                    + (f"{force} forced" if force else "tiling picked"))
                    f32_seen |= {("value", case["value_tiling"]),
                                 ("jacobian", case["jacobian_tiling"])}
                    cases.append(case)
        finally:
            mlp_sdf.force_f32_tiling(None)
    check(f32_seen == {(k, t) for k in ("value", "jacobian") for t in mlp_sdf.F32_TILINGS},
          f"every f32 kernel ran at every tiling: {sorted(f32_seen)}")
    report["kernel_vs_plain"] = cases
    print("phase 3 kernels vs plain: " + "; ".join(
        f"{c['case']}: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                     for k, v in c.items() if k != "case")
        for c in cases), flush=True)

    # ---- 4. the main path: batched reconstruction, bench.py's shapes
    fixture = deepsdf.load_npz(FIXTURE, device=dev)
    probs = [ellipsoid.make_problem(100 + i, N_PTS, N_RAYS) for i in range(B)]

    def stack(k, dtype=None):
        return torch.tensor(np.stack([p[k] for p in probs]), dtype=dtype, device=dev)

    args = (stack("T_init"), stack("pts"), torch.ones(B, N_PTS, dtype=torch.bool, device=dev),
            stack("rays"), torch.ones(B, N_RAYS, dtype=torch.bool, device=dev),
            stack("depth"), stack("fg_mask"))
    cfg = opt.ReconConfig.gpu_fast(num_iterations=ITERS)

    def fit():
        return opt.reconstruct_objects_batched(fixture, cfg, *args,
                                               compute_dtype=opt.FAST_DTYPE)

    mlp_sdf.reset_launch_counts()
    out = fit()
    torch.cuda.synchronize()
    launches = dict(mlp_sdf.LAUNCHES)
    check(launches["mlp_sdf_value"] > 0 and launches["mlp_sdf_jacobian"] > 0
          and launches["mlp_sdf_value_f32"] == launches["mlp_sdf_jacobian_f32"] == 0,
          f"both bf16 kernels, and no f32 one, on the main path: {launches}")
    check(bool(out.is_good.all()), f"every fit is_good: {out.is_good.tolist()}")
    check(bool(torch.isfinite(out.t_cam_obj).all()), "finite poses")
    T_fit = out.t_cam_obj.cpu().numpy()
    err0 = np.mean([ellipsoid.pose_errors(p["T_init"], p)[0] for p in probs])
    errs = np.array([ellipsoid.pose_errors(T_fit[i], p) for i, p in enumerate(probs)])
    check(errs[:, 0].mean() < err0, f"mean translation error {errs[:, 0].mean()} < {err0}")
    reps = 3
    fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fit()
    torch.cuda.synchronize()
    fit_s = (time.perf_counter() - t0) / reps
    prof = profile_fit(fit, fit_s * 1e3)
    report["main_path"] = {
        "launches": launches, "fits_per_s": B / fit_s, "batch_s": fit_s,
        "t_err_init_mean": float(err0), "errors_mean": errs.mean(0).tolist(),
        "profile": prof, "card": smi}
    print(f"phase 4 main path: B={B} pts={N_PTS} rays={N_RAYS} iters={ITERS} gpu_fast bf16: "
          f"launches {launches}; mean t_err {err0:.4f} -> {errs[:, 0].mean():.4f} m, "
          f"s_err {errs[:, 1].mean():.4f}, r_err {errs[:, 2].mean():.2f} deg; "
          f"{B / fit_s:.2f} fits/s ({fit_s * 1e3:.1f} ms/batch) on {smi}", flush=True)
    print(f"phase 4 profile (one traced fit): traced wall {prof['traced_wall_ms']:.1f} ms, busy "
          f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}), mlp_sdf kernels "
          f"{prof['mlp_sdf_ms']:.1f} ms, {prof['n_kernels']} kernel launches; top: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in prof["top"]), flush=True)

    # ---- 5. f32 parity: one GN iteration, kernels (card) vs plain (CPU)
    rng = np.random.default_rng(3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, 6.0]
    pts = (rng.standard_normal((64, 3)) * 0.4 + [0, 0, 6.0]).astype(np.float32)
    rays = (rng.standard_normal((32, 3)) * 0.03 + [0, 0, 1.0]).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    one = (T, pts, np.ones(64, bool), rays, np.ones(32, bool), np.full(32, 6.0, np.float32),
           np.ones(32, bool))
    cfg1 = opt.ReconConfig(num_iterations=1, num_depth_samples=12, max_grad_points=256,
                           max_valid_samples=512)
    r_k = opt.reconstruct_object(dec, cfg1, *(torch.tensor(a, device=dev) for a in one))
    r_p = opt.reconstruct_object(deepsdf.init_decoder(deepsdf.DecoderSpec(), seed=0, device="cpu"),
                                 cfg1, *(torch.tensor(a) for a in one))
    e_t = float((r_k.t_cam_obj.cpu() - r_p.t_cam_obj).abs().max())
    e_c = float((r_k.code.cpu() - r_p.code).abs().max())
    check(e_t <= 2e-3 and e_c <= 2e-3 and bool(r_k.is_good) == bool(r_p.is_good),
          f"f32 parity pose {e_t} code {e_c}")
    report["f32_parity"] = {"pose_err": e_t, "code_err": e_c}
    print(f"phase 5 f32 parity (1 GN iteration, card kernels vs CPU plain): pose {e_t:.3g} "
          f"code {e_c:.3g}", flush=True)

    # ---- 6. mesh from one fitted code (64^3 decode through the value kernel)
    m = mesh.MeshExtractor(fixture).extract_mesh_from_code(out.code[0])
    nv, nf = len(m["vertices"]), len(m["faces"])
    check(nv > 0 and nf > 0, f"mesh {nv} vertices {nf} faces")
    report["mesh"] = {"vertices": nv, "faces": nf}
    print(f"phase 6 mesh: {nv} vertices, {nf} faces", flush=True)

    # ---- 7. kernel times at the main path's shapes (bf16, as gpu_fast runs)
    wb = fixture.packed(bf)
    w0, W, _ = wb
    fwd_macs = sum(i * o for i, o in fixture.spec.layer_dims())
    w_bytes = sum(t.numel() * t.element_size() for t in wb)

    def timing(kind, rows, n_obj):
        # object codes and points near their ellipsoid surfaces, where
        # tanh is not saturated and the Jacobian is not 0
        g = np.random.default_rng(rows)
        code_np = g.standard_normal((n_obj, 64))
        dirs = g.standard_normal((n_obj, rows // n_obj, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        xyz_np = (dirs * ellipsoid.code_to_axes(code_np)[:, None]
                  * g.uniform(0.8, 1.2, dirs.shape[:2] + (1,)))
        code = torch.tensor(code_np, dtype=torch.float32, device=dev)
        xyz = torch.tensor(xyz_np, dtype=torch.float32, device=dev)
        jac = kind == "jacobian"
        kern = (functools.partial(mlp_sdf.sdf_and_input_jacobian_fused,
                                  tiles=fixture.jacobian_tiles) if jac else
                functools.partial(mlp_sdf.sdf_value_fused, tiles=fixture.value_tiles))
        plain = mlp_sdf.sdf_and_input_jacobian_plain if jac else mlp_sdf.sdf_value_plain
        # held to the bf16 tolerances at the main path's shapes
        if jac:
            _, g_k, g_m, _ = hold_bf16_jacobian(mlp_sdf, wb, fixture.jacobian_tiles, code, xyz,
                                                f"jacobian at {rows} rows")
            err = float((g_k - g_m).abs().max())
        else:
            err = float((kern(wb, code, xyz, bf) - plain(wb, code, xyz, bf)).abs().max())
            check(err <= BF16_SDF_ATOL, f"value at {rows} rows: sdf {err}")
        rand = torch.Generator(device=dev).manual_seed(rows)
        x = torch.randn(rows, 128, device=dev, dtype=bf, generator=rand)
        h = torch.randn(rows, 512, device=dev, dtype=bf, generator=rand)

        def library():       # the same products, one torch.matmul each
            torch.matmul(x, w0)
            for i in range(8):
                torch.matmul(h, W[i])
            if jac:
                for i in range(8):
                    torch.matmul(h, W[i].T)

        ms = cuda_ms(lambda: kern(wb, code, xyz, bf), 20)
        plain_ms = cuda_ms(lambda: plain(wb, code, xyz, bf), 5)
        library_ms = cuda_ms(library, 20)
        flops = 2.0 * fwd_macs * rows * (2 if jac else 1)
        io = w_bytes + code.numel() * 4 + xyz.numel() * 4 + rows * 4 * (1 + (67 if jac else 0))
        t_ops, t_bytes = flops / peak_bf16 * 1e3, io / mem_bw * 1e3
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "max_abs_err": err, "rows": rows, "dtype": "bf16",
                "tflops": flops / ms / 1e9}

    t_val = timing("value", B * N_RAYS * cfg.coarse_samples, B)
    t_jac = timing("jacobian", B * cfg.max_grad_points, B)
    t_jac_sdf = timing("jacobian", B * N_PTS, B)
    # every block of the value kernel streams the whole packed weight stack from L2
    blocks = -(-t_val["rows"] // vcfg["rows_per_block"])
    t_val["l2_bytes"] = blocks * mlp_sdf.VALUE_STAGES * mlp_sdf.VALUE_STAGE_BYTES
    t_val["l2_tb_per_s"] = t_val["l2_bytes"] / t_val["ms"] / 1e9
    t_val.update({k: vcfg[k] for k in ("stage", "smem_bytes", "registers")})
    # every block of the Jacobian kernel streams both weight streams, one
    # stage after another: at these sizes (one wave) the chain sets the time
    jac_stages = mlp_sdf.VALUE_STAGES + mlp_sdf.BACKWARD_STAGES + mlp_sdf.W0T_STAGES
    for t in (t_jac, t_jac_sdf):
        t.update({k: jcfg[k] for k in ("stage", "smem_bytes", "registers")})
        blocks = -(-t["rows"] // jcfg["rows_per_block"])
        t["l2_bytes"] = blocks * (mlp_sdf.VALUE_STAGES * mlp_sdf.VALUE_STAGE_BYTES
                                  + mlp_sdf.BACKWARD_BYTES)
        t["l2_tb_per_s"] = t["l2_bytes"] / t["ms"] / 1e9
        t["us_per_stage"] = t["ms"] * 1e3 / jac_stages
    report["timing"] = {"value": t_val, "jacobian_render": t_jac, "jacobian_sdf": t_jac_sdf,
                        "card": smi}
    for label, t in (("value", t_val), ("jacobian render", t_jac),
                     ("jacobian sdf", t_jac_sdf)):
        print(f"phase 7 timing {label}: rows {t['rows']} kernel {t['ms']:.3f} ms "
              f"({t['tflops']:.1f} TFLOP/s), plain {t['plain_ms']:.3f} ms, torch.matmul "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"max_abs_err {t['max_abs_err']:.3g} on {smi}", flush=True)
    print(f"phase 7 value kernel: stage {t_val['stage']}, {t_val['smem_bytes']} B shared "
          f"memory per block, {t_val['registers']} registers; weight stream from L2 "
          f"{t_val['l2_bytes'] / 1e9:.3f} GB per launch = {t_val['l2_tb_per_s']:.2f} TB/s",
          flush=True)
    print(f"phase 7 jacobian kernel: stage {jcfg['stage']}, {jcfg['smem_bytes']} B shared "
          f"memory per block, {jcfg['registers']} registers; weight streams from L2 "
          + ", ".join(f"{t['l2_bytes'] / 1e9:.3f} GB = {t['l2_tb_per_s']:.2f} TB/s, "
                      f"{t['us_per_stage']:.3f} us per stage at {t['rows']} rows"
                      for t in (t_jac, t_jac_sdf)), flush=True)
    # ---- 8 / 9a. per-frame tracking and the keyframe stage at KITTI size
    report["tracking"] = tracking_phase(dev, smi)
    # ---- 9b / 9c. bundle adjustment at KITTI-00 scale, and card vs CPU
    t0 = time.perf_counter()
    report["ba_scale"], corridor = ba_scale_phase(dev, smi)
    print(f"phase 9b-9c took {time.perf_counter() - t0:.0f} s", flush=True)
    # ---- 10. the object stage in the SLAM loop (f32 kernels), and 10c mono
    report["objects"], kernels_f32, object_map = objects_phase(dev, smi, mem_bw)
    # ---- 11. monocular initialization and loop closing (no kernel of the port)
    report["loop"] = loop_phase(dev, smi)
    with tempfile.TemporaryDirectory() as keep:
        # ---- 12. the system loop and the command line (f32 kernels in the worker)
        report["system"] = system_phase(dev, smi, keep)
        # ---- 13. the scale-out tier (NCCL, world size 1) and active mapping
        report["scale_out"], paths13 = scale_out_phase(dev, smi, fixture, args, corridor,
                                                          object_map)
        # ---- 14. the benches and the aux tools
        report["tools"], paths14 = tools_phase(dev, smi, keep, report["main_path"]["fits_per_s"],
                                               report["system"]["cli_objects"]["ate_m"])
    # ---- 15. every decoder kernel repeats bit for bit inside the loop and under stress
    report["repeat"] = repeat_phase(smi)
    # ---- 16. a loop closes at KITTI size with objects through the command line
    report["circuit"], paths16 = circuit_phase(dev, smi)
    late_traces(report, smi)
    # ---- 17. the fixed-order scatter-add on the main path's scatters
    report["segment_sum"] = scatter_phase(dev, smi, mem_bw)

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "rows", "dtype")
    kernels = [
        dict(name="mlp_sdf_value", route="cuda",
             source="dsp_slam_rgbd_tpu_torch/csrc/mlp_sdf_value_tc.cu",
             replaces="dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:237",
             **{k: v for k, v in dict(t_val, launches=launches["mlp_sdf_value"]).items()
                if k in keys}),
        dict(name="mlp_sdf_jacobian", route="cuda",
             source="dsp_slam_rgbd_tpu_torch/csrc/mlp_sdf_jacobian_tc.cu",
             replaces="dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:159",
             **{k: v for k, v in dict(t_jac, launches=launches["mlp_sdf_jacobian"]).items()
                if k in keys},
             # the main path's other Jacobian launch size (the SDF term)
             small={k: v for k, v in t_jac_sdf.items() if k in keys}),
    ] + kernels_f32
    # `launches`: the kernel's main path (phase 4 for bf16, phase 10 for f32);
    # beside it, its count on each path of phases 13, 14 and 16
    for k in kernels:
        k["launches_by_path"] = {path: n[k["name"]]
                                 for path, n in {**paths13, **paths14, **paths16}.items()}
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)), exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
