"""Typed configuration tree.

Counterpart of `dsp_slam_rgbd_tpu/config.py`, same fields and defaults.
It replaces the reference's two-tier config split — OpenCV FileStorage YAML per
sequence (`configs/KITTI00-02.yaml`, parsed at `Tracking.cc:53-156`) + json
per dataset (`configs/config_kitti.json`, parsed by `reconstruct/utils.py:87`)
— with one dataclass tree.  `from_reference_yaml_json` ingests the
reference's own config files so its sequences run unmodified.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, replace  # noqa: F401  (re-exported)

from dsp_slam_rgbd_tpu_torch.frontend.orb import OrbConfig
from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics
from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig


@dataclass(frozen=True)
class TrackingConfig:
    fps: float = 10.0
    th_depth: float = 35.0          # close/far stereo point threshold
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30 # defaults to fps
    min_tracked_for_ok: int = 30
    reloc_min_inliers: int = 50
    # NeedNewKeyFrame close-point census (reference `bNeedToInsertClose`,
    # Tracking.cc:1085-1100): insert when < close_tracked_th close points
    # are tracked while > close_free_th close depth features are unclaimed.
    # The reference constants (100/70) assume ~2000 features/frame — scale
    # them with n_features or small-feature configs insert a keyframe
    # nearly every frame and exhaust the keyframe pool.
    close_tracked_th: int = 100
    close_free_th: int = 70
    # EXPERIMENTAL one-frame-deep pipelined tracking in the steady OK
    # state: this frame's fused program dispatches BEFORE the previous
    # frame's stats are fetched, so the per-frame round trip rides under
    # the next frame's device compute.  Decisions (keyframe census,
    # OK/LOST) then lag one frame; state-machine transitions drain the
    # pipeline and run synchronously.  Default OFF: the one-frame decision
    # lag measurably costs accuracy on aggressive motion (max per-frame
    # trajectory error 0.05 -> 0.07 on the e2e fixture) — latency-critical
    # deployments can trade that; see tests/test_pipelined_tracking.py.
    pipelined: bool = False


@dataclass(frozen=True)
class MapConfig:
    max_kf: int = 128
    max_feat: int = 1024
    max_pts: int = 16384
    max_obj: int = 16
    max_oobs: int = 512
    local_window: int = 10

    @classmethod
    def kitti_large(cls, **overrides) -> "MapConfig":
        """KITTI-00-scale capacities (the reference builds ~1.3k KFs and
        >100k points on sequence 00): headroom for 2k KFs / 300k points.
        Local BA stays small via window compaction; global BA takes the
        matrix-free PCG path (`ba.global_ba_pcg`)."""
        base = dict(max_kf=2048, max_feat=1024, max_pts=300_000,
                    max_obj=64, max_oobs=8192)
        base.update(overrides)
        return cls(**base)


@dataclass(frozen=True)
class SystemConfig:
    sensor: str = "stereo"          # stereo | rgbd | mono
    cam: Intrinsics = Intrinsics(fx=718.856, fy=718.856, cx=607.1928,
                                 cy=185.2157, bf=386.1448)
    orb: OrbConfig = OrbConfig()
    recon: ReconConfig = ReconConfig()
    tracking: TrackingConfig = TrackingConfig()
    map: MapConfig = MapConfig()
    depth_scale: float = 1.0        # RGB-D depth map factor
    detect_online: bool = False     # offline-label mode is first-class
    deepsdf_dir: str = ""
    voxels_dim: int = 32
    # fork feature: ground-frame initialization from a known first camera
    # pose (reference `Tracking.cc:759-794` + `Tworld_camera.*` yaml keys);
    # 4x4 row-major T_wc of the first frame, or None for identity
    t_world_camera0: tuple | None = None
    # asynchronous keyframe stage (the reference's LocalMapping/LoopClosing
    # threads, `System.cc:120-143`): keyframe mapping jobs run on a worker
    # thread and their results are adopted exactly this many frames after
    # enqueue (deterministic bounded staleness).  0 = fully synchronous.
    async_kf_frames: int = 3


def _parse_opencv_yaml(path: str) -> dict:
    """Minimal parser for OpenCV FileStorage YAML (flat `Key.sub: value`)."""
    out = {}
    for line in open(path):
        line = line.split("#")[0].strip()
        m = re.match(r"^([\w.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip().strip('"')
        try:
            out[key] = float(val) if "." in val or "e" in val.lower() \
                else int(val)
        except ValueError:
            out[key] = val
    return out


def from_reference_yaml_json(yaml_path: str, json_path: str | None = None,
                             sensor: str = "stereo") -> SystemConfig:
    """Build a SystemConfig from the reference's own config files."""
    y = _parse_opencv_yaml(yaml_path)
    cam = Intrinsics(
        fx=float(y["Camera.fx"]), fy=float(y["Camera.fy"]),
        cx=float(y["Camera.cx"]), cy=float(y["Camera.cy"]),
        dist=(float(y.get("Camera.k1", 0.0)), float(y.get("Camera.k2", 0.0)),
              float(y.get("Camera.p1", 0.0)), float(y.get("Camera.p2", 0.0)),
              float(y.get("Camera.k3", 0.0))),
        bf=float(y.get("Camera.bf", 0.0)),
    )
    orb = OrbConfig(
        n_features=int(y.get("ORBextractor.nFeatures", 2000)),
        n_levels=int(y.get("ORBextractor.nLevels", 8)),
        scale=float(y.get("ORBextractor.scaleFactor", 1.2)),
        fast_threshold=float(y.get("ORBextractor.iniThFAST", 20)),
        fast_min_threshold=float(y.get("ORBextractor.minThFAST", 7)),
    )
    tracking = TrackingConfig(
        fps=float(y.get("Camera.fps", 10.0)),
        th_depth=float(y.get("ThDepth", 35.0)),
        max_frames_between_kf=int(float(y.get("Camera.fps", 10.0))),
    )
    # fork's ground-truth first pose (Tworld_camera.* keys in e.g.
    # freiburg_001.yaml): translation + quaternion (x, y, z, w)
    t_wc0 = None
    if "Tworld_camera.tx" in y:
        import numpy as _np
        import torch as _torch

        from dsp_slam_rgbd_tpu_torch.ops import lie as _lie

        q = _torch.tensor([
            float(y.get("Tworld_camera.qw", 1.0)),
            float(y.get("Tworld_camera.qx", 0.0)),
            float(y.get("Tworld_camera.qy", 0.0)),
            float(y.get("Tworld_camera.qz", 0.0)),
        ], dtype=_torch.float32)
        T = _np.eye(4, dtype=_np.float32)
        T[:3, :3] = _lie.quat_to_rot(q).numpy()
        T[:3, 3] = [float(y["Tworld_camera.tx"]),
                    float(y.get("Tworld_camera.ty", 0.0)),
                    float(y.get("Tworld_camera.tz", 0.0))]
        t_wc0 = tuple(map(tuple, T.tolist()))
    recon = ReconConfig()
    deepsdf_dir = ""
    voxels = 32
    detect_online = False
    if json_path:
        j = json.load(open(json_path))
        o = j.get("optimizer", {})
        jo = o.get("joint_optim", {})
        recon = ReconConfig(
            code_len=int(o.get("code_len", 64)),
            num_depth_samples=int(o.get("num_depth_samples", 50)),
            cut_off_threshold=float(o.get("cut_off_threshold", 0.01)),
            k1=float(jo.get("k1", 1.0)), k2=float(jo.get("k2", 100.0)),
            k3=float(jo.get("k3", 0.25)), k4=float(jo.get("k4", 1e7)),
            b1=float(jo.get("b1", 0.20)), b2=float(jo.get("b2", 0.025)),
            num_iterations=int(jo.get("num_iterations", 10)),
            learning_rate=float(jo.get("learning_rate", 1.0)),
            scale_damping=float(jo.get("scale_damping", 1.0)),
            pose_only_iterations=int(
                o.get("pose_only_optim", {}).get("num_iterations", 5)
            ),
        )
        deepsdf_dir = j.get("DeepSDF_DIR", "")
        voxels = int(j.get("voxels_dim", 32))
        detect_online = bool(j.get("detect_online", False))
    return SystemConfig(
        sensor=sensor, cam=cam, orb=orb, recon=recon, tracking=tracking,
        depth_scale=1.0 / float(y["DepthMapFactor"])
        if "DepthMapFactor" in y else 1.0,
        deepsdf_dir=deepsdf_dir, voxels_dim=voxels,
        detect_online=detect_online, t_world_camera0=t_wc0,
    )
