"""Run the SLAM system over a sequence directory (the `dsp_slam` /
`dsp_slam_mono` command line, reference `dsp_slam.cc:33`).

Counterpart of `tools/run_slam.py`, with the same arguments and the same
`summary.json`, plus `--device` (default the card; `--device cpu` runs on
the CPU, and without a card and without it the run stops with an error):

  python -m dsp_slam_rgbd_tpu_torch.tools.run_slam <sequence_dir> <out_dir> \
      [--sensor stereo|rgbd|mono] [--yaml cfg.yaml] [--json cfg.json] \
      [--labels labels_dir] [--deepsdf checkpoint.npz] [--max-frames N] \
      [--vocab vocab.npz] [--bootstrap-vocab N] [--device cuda|cpu] \
      [--distributed --coordinator HOST:PORT --num-processes N --process-id R]

With `--distributed` each of N processes (one per card; gloo with
`--device cpu`) joins a `torch.distributed` group at the coordinator and
runs the whole sequence; the new-object reconstruction shards over them
(`system/slam.py`).  Every process writes the same outputs: give each its
own out_dir.

The vocabulary enables loop closing and BoW relocalization.  `--vocab`
loads a trained npz; when the file does not exist and `--bootstrap-vocab
N` is given, a k-medians vocabulary is trained on ORB descriptors from N
frames sampled across the sequence and saved to the `--vocab` path.
Frames are read, uploaded and ORB-extracted one frame ahead on a thread of
their own (`system/prefetch.FramePrefetcher`).  A keyframe keeps as many
feature slots as a frame has features (`feature_slots`; the JAX command
line keeps 1,024 at any `ORBextractor.nFeatures`).  It writes
CameraTrajectory.txt (KITTI), CameraTrajectory_TUM.txt, MapPoints.txt,
MapObjects.txt, Cameras.txt and summary.json into out_dir.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _bootstrap_vocab(seq, cfg, sensor: str, n_frames: int, branching: int = 10,
                     depth: int = 3, device="cuda"):
    """A k-medians vocabulary on ORB descriptors from `n_frames` frames
    sampled evenly across the sequence (the stand-in for the reference's
    shipped ORBvoc.bin)."""
    from dsp_slam_rgbd_tpu_torch.frontend import orb
    from dsp_slam_rgbd_tpu_torch.loop import vocabulary

    idxs = np.unique(np.linspace(0, len(seq) - 1, min(n_frames, len(seq))).astype(int))
    descs = []
    for i in idxs:
        fr = seq.frame(int(i))
        f = orb.extract(fr[0] if isinstance(fr, tuple) else fr, cfg.orb, device=device)
        descs.append(f.desc[f.valid].cpu().numpy())
    all_desc = np.concatenate(descs) if descs else np.zeros((0, 8), np.int32)
    print(f"training vocabulary on {len(all_desc)} descriptors from {len(idxs)} frames "
          f"(branching={branching}, depth={depth}, {branching**depth} words)")
    return vocabulary.train(all_desc, branching=branching, depth=depth, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("out_dir")
    ap.add_argument("--sensor", default="stereo", choices=["stereo", "rgbd", "mono"])
    ap.add_argument("--yaml", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--labels", default=None)
    ap.add_argument("--deepsdf", default=None,
                    help="decoder checkpoint (.npz, or a reference experiment dir)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--map-preset", default=None, choices=["kitti_large"],
                    help="map capacity preset (kitti_large: 2048 KFs / 300k points for "
                         "full KITTI odometry sequences)")
    ap.add_argument("--vocab", default=None,
                    help="ORB vocabulary npz (enables loop closing + BoW relocalization)")
    ap.add_argument("--bootstrap-vocab", type=int, default=0, metavar="N",
                    help="if --vocab does not exist, train it on ORB descriptors from N "
                         "frames of this sequence")
    ap.add_argument("--vocab-branching", type=int, default=10,
                    help="vocabulary tree branching factor (bootstrap mode)")
    ap.add_argument("--vocab-depth", type=int, default=3,
                    help="vocabulary tree depth: words = branching**depth (depth 4-5 at "
                         "KITTI scale)")
    ap.add_argument("--live-port", type=int, default=0, metavar="PORT",
                    help="serve a live top-down map view over HTTP")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="write a top-down map/trajectory PNG every N frames")
    ap.add_argument("--gt", default=None,
                    help="ground-truth trajectory (KITTI format) for summary.json's ATE")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed group before running: one process "
                         "per device, every process runs the same sequence, and the "
                         "new-object reconstruction shards over them")
    ap.add_argument("--coordinator", default="localhost:9911",
                    help="host:port of rank 0's rendezvous (or a tcp:// / file:// URL)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def coordinator_url(address: str) -> str:
    """`host:port` -> `tcp://host:port`; a URL is kept."""
    return address if "://" in address else f"tcp://{address}"


def feature_slots(cfg) -> int:
    """A keyframe's feature slots (`MapConfig.max_feat`): at least as many
    as the extractor gives a frame (`ORBextractor.nFeatures`), in whole
    1,024s.  The JAX command line keeps `MapConfig`'s 1,024 whatever the
    yaml's feature count, and a keyframe of a 2,000-feature frame then
    loses the slots past 1,024."""
    return max(cfg.map.max_feat, -(-cfg.orb.n_features // 1024) * 1024)


def main(argv=None) -> dict:
    """Run the command line `argv`.  Returns {"summary", "track_ms" (per
    frame), "kf_frames" (frames that made a keyframe), "blocked_ms",
    "system"}."""
    args = parse_args(argv)
    if not args.distributed:
        return _run(args)
    # join the group before anything else runs; leave the one joined here
    import torch.distributed as tdist

    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist_mod

    joined = not tdist.is_initialized()
    dist_mod.initialize(coordinator_url(args.coordinator), args.num_processes,
                        args.process_id, device=args.device)
    try:
        return _run(args)
    finally:
        if joined:
            tdist.destroy_process_group()


def _run(args) -> dict:
    from dsp_slam_rgbd_tpu_torch import config as cfg_mod
    from dsp_slam_rgbd_tpu_torch import device as device_mod
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.system import sequence as seq_mod
    from dsp_slam_rgbd_tpu_torch.system.prefetch import FramePrefetcher
    from dsp_slam_rgbd_tpu_torch.system.slam import SLAMSystem

    dev = device_mod.resolve(args.device)
    if args.yaml:
        cfg = cfg_mod.from_reference_yaml_json(args.yaml, args.json, sensor=args.sensor)
    else:
        cfg = cfg_mod.SystemConfig(sensor=args.sensor)
    if args.map_preset == "kitti_large":
        cfg = cfg_mod.replace(cfg, map=cfg_mod.MapConfig.kitti_large())
    cfg = cfg_mod.replace(cfg, map=cfg_mod.replace(cfg.map, max_feat=feature_slots(cfg)))

    decoder = None
    if args.deepsdf:
        decoder = (deepsdf.load_npz(args.deepsdf, device=dev) if args.deepsdf.endswith(".npz")
                   else deepsdf.load_torch_checkpoint(args.deepsdf, device=dev))

    seq = seq_mod.get_sequence(args.sequence, cfg)
    if len(seq) == 0:
        sys.exit(f"error: no frames found in sequence dir {args.sequence!r} "
                 "(expected image_2/ + image_3/, rgb/ + depth/, or images)")
    if args.labels:
        seq.labels_dir = args.labels

    vocab = None
    if args.vocab:
        from dsp_slam_rgbd_tpu_torch.loop import vocabulary

        if os.path.isfile(args.vocab):
            vocab = vocabulary.load_npz(args.vocab, device=dev)
            print(f"vocabulary loaded: {args.vocab} ({vocab.n_words} words)")
        elif args.bootstrap_vocab > 0:
            vocab = _bootstrap_vocab(seq, cfg, args.sensor, args.bootstrap_vocab,
                                     branching=args.vocab_branching, depth=args.vocab_depth,
                                     device=dev)
            vocabulary.save_npz(args.vocab, vocab)
            print(f"vocabulary trained + saved: {args.vocab} ({vocab.n_words} words)")
        else:
            sys.exit(f"error: vocabulary file {args.vocab!r} not found "
                     "(pass --bootstrap-vocab N to train one)")

    system = SLAMSystem(cfg, decoder=decoder, vocab=vocab, device=dev)
    n = min(len(seq), args.max_frames) if args.max_frames else len(seq)

    def frames():
        for i in range(n):
            f = seq.frame(i)
            yield f if isinstance(f, tuple) else (f,)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.viz_every:
        os.makedirs(os.path.join(args.out_dir, "viz"), exist_ok=True)
    viewer = None
    if args.live_port:
        from dsp_slam_rgbd_tpu_torch.system.live_viewer import LiveViewer

        viewer = LiveViewer(system, port=args.live_port)
        print(f"live map view: http://0.0.0.0:{viewer.port}/")

    times, kf_frames = [], []
    try:
        with FramePrefetcher(system.tracker, frames(), sensor=args.sensor,
                             fps=cfg.tracking.fps, depth=2) as pf:
            for i, frame in enumerate(pf):
                n_kf = system.n_kf
                t0 = time.perf_counter()
                system.track_frame(frame, detections=seq.detections(i) or None)
                times.append(time.perf_counter() - t0)
                if system.n_kf != n_kf:
                    kf_frames.append(i)
                if i % 25 == 0:
                    print(f"frame {i}/{n}  {times[-1] * 1e3:.1f} ms  "
                          f"status={system.tracker.status}  kf={system.n_kf}")
                if args.viz_every and i % args.viz_every == 0:
                    from dsp_slam_rgbd_tpu_torch.system import viz

                    st = system.state
                    kv = st.kf_valid.cpu().numpy()
                    viz.trajectory_figure(
                        st.kf_pose.cpu().numpy()[kv],
                        st.pt_pos.cpu().numpy()[st.pt_valid.cpu().numpy()],
                        os.path.join(args.out_dir, "viz", f"map_{i:06d}.png"))
        system.save_trajectory_kitti(os.path.join(args.out_dir, "CameraTrajectory.txt"))
        system.save_trajectory_tum(os.path.join(args.out_dir, "CameraTrajectory_TUM.txt"))
        system.save_entire_map(args.out_dir)
    finally:
        if viewer is not None:
            viewer.close()
        system.shutdown()

    med = sorted(times)[len(times) // 2] if times else 0.0
    # the reference prints median/mean tracking time at exit (`dsp_slam.cc:109-118`)
    print(f"median tracking time: {med * 1e3:.1f} ms ({1.0 / max(med, 1e-9):.1f} FPS)")
    print(f"mean tracking time: {sum(times) / max(len(times), 1) * 1e3:.1f} ms")
    print(f"keyframes: {system.n_kf}, loop closures: {system.loop_closures}")

    st = system.state
    ts_arr = np.asarray(times) if times else np.zeros(1)
    summary = {
        "frames": len(times),
        "fps": round(len(times) / max(float(ts_arr.sum()), 1e-9), 2),
        "track_ms_p50": round(float(np.percentile(ts_arr, 50)) * 1e3, 1),
        "track_ms_p90": round(float(np.percentile(ts_arr, 90)) * 1e3, 1),
        "track_ms_p99": round(float(np.percentile(ts_arr, 99)) * 1e3, 1),
        "n_kf": system.n_kf,
        "n_kf_live": int(st.kf_valid.sum()),
        "n_points": int(st.pt_valid.sum()),
        "n_objects": int(st.obj_valid.sum()),
        "loop_closures": system.loop_closures,
        "kf_slots_exhausted": system.kf_slots_exhausted,
        # no silent caps: frames whose covisible window overflowed LOCAL_PTS,
        # object pose edges lost to ring wrap
        "local_pts_overflows": system.tracker.local_pts_overflows,
        "oobs_overwrites": system.mapping.oobs_overwrites,
        "final_status": system.tracker.status,
    }
    if args.gt and os.path.isfile(args.gt):
        import torch

        from dsp_slam_rgbd_tpu_torch.solvers.sim3 import align_trajectories

        gt = np.loadtxt(args.gt, ndmin=2)[:, [3, 7, 11]]
        est = np.loadtxt(os.path.join(args.out_dir, "CameraTrajectory.txt"),
                         ndmin=2)[:, [3, 7, 11]]
        m = min(len(gt), len(est))
        if m >= 3:
            _, ate = align_trajectories(torch.tensor(est[:m], dtype=torch.float32),
                                        torch.tensor(gt[:m], dtype=torch.float32),
                                        fix_scale=True)
            summary["ate_rmse"] = round(float(ate), 4)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("summary:", json.dumps(summary))
    return {"summary": summary, "track_ms": [t * 1e3 for t in times], "kf_frames": kf_frames,
            "blocked_ms": dict(system.blocked_ms), "system": system}


if __name__ == "__main__":
    main()
