"""The port's command line (`python -m dsp_slam_rgbd_tpu_torch.tools.run_slam`)
end to end on the CPU, as tests/test_cli_e2e.py runs the JAX package's:
the same PIL-written stereo and RGB-D sequence directories, the same yaml,
`--device cpu`, and that test's checks (exit 0, the exit-time median, a
KITTI row for every tracked frame, ~the commanded +x path, the map files),
plus MapObjects.txt, summary.json with the JAX command line's keys and
the `--viz-every` map pictures.  A keyframe's feature slots follow the
yaml's feature count (`run_slam.feature_slots`, a divergence from the JAX
command line's fixed 1,024).
Without a card and without `--device cpu` the run must stop with the
"CUDA is not available" error.  The long loop-closing run
(`tools/loop_world.py` with `--bootstrap-vocab`) is `chip_smoke.py`
phase 12c's: on the CPU it takes minutes.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from test_system_e2e import BASELINE, STEP, make_texture, render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = ("Camera.fx: 200.0\nCamera.fy: 200.0\nCamera.cx: 112.0\nCamera.cy: 80.0\n"
        "Camera.bf: 100.0\nCamera.fps: 10.0\nThDepth: 60.0\nORBextractor.nFeatures: 400\n"
        "ORBextractor.nLevels: 3\n")
SUMMARY_KEYS = {"frames", "fps", "track_ms_p50", "track_ms_p90", "track_ms_p99", "n_kf",
                "n_kf_live", "n_points", "n_objects", "loop_closures", "kf_slots_exhausted",
                "local_pts_overflows", "oobs_overwrites", "final_status"}


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """tests/test_cli_e2e.py's stereo and RGB-D directories (PIL PNGs)."""
    from test_rgbd_e2e import depth_map

    root = tmp_path_factory.mktemp("cli")
    texture = make_texture(np.random.default_rng(0))
    for sub in ("stereo/image_2", "stereo/image_3", "rgbd/rgb", "rgbd/depth"):
        (root / sub).mkdir(parents=True)
    for i in range(10):
        x = i * STEP
        for sub, cam_x in (("stereo/image_2", x), ("stereo/image_3", x + BASELINE)):
            img = np.clip(render(texture, cam_x), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / sub / f"{i:06d}.png")
        img = np.clip(render(texture, x), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / "rgbd" / "rgb" / f"{i:06d}.png")
        Image.fromarray((depth_map(x) * 1000.0).astype(np.uint16)).save(
            root / "rgbd" / "depth" / f"{i:06d}.png")
    (root / "cam.yaml").write_text(YAML)
    return root


def run_cli(*args, timeout=500):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "dsp_slam_rgbd_tpu_torch.tools.run_slam",
                           *map(str, args)], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("sensor", ["stereo", "rgbd"])
def test_run_slam_cli_on_cpu(seqs, tmp_path, sensor):
    out = tmp_path / "out"
    proc = run_cli(seqs / sensor, out, "--sensor", sensor, "--yaml", seqs / "cam.yaml",
                   "--max-frames", 10, "--device", "cpu", "--viz-every", 5)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "median tracking time" in proc.stdout
    rows = np.loadtxt(out / "CameraTrajectory.txt", ndmin=2)
    assert rows.shape[0] >= 8 and rows.shape[1] == 12
    assert 0.7 < rows[-1, 3] < 1.6       # moved ~the commanded +x path
    tum = np.loadtxt(out / "CameraTrajectory_TUM.txt", ndmin=2)
    assert tum.shape == (rows.shape[0], 8)
    assert np.loadtxt(out / "MapPoints.txt", ndmin=2).shape[1] == 3
    for name in ("Cameras.txt", "MapObjects.txt", "viz/map_000000.png", "viz/map_000005.png"):
        assert (out / name).exists(), name
    summary = json.loads((out / "summary.json").read_text())
    assert set(summary) == SUMMARY_KEYS
    assert summary["frames"] == 10 and summary["final_status"] == "OK"


def test_run_slam_cli_needs_a_card_or_cpu(seqs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    proc = run_cli(seqs / "stereo", tmp_path / "out", "--yaml", seqs / "cam.yaml")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "out" / "CameraTrajectory.txt").exists()


def test_run_slam_distributed_names_the_slice(seqs, tmp_path):
    """--distributed (the scale-out slice, ported): the command line joins a
    gloo group on the CPU before the run and leaves it after."""
    from unittest import mock

    import torch.distributed as tdist

    from dsp_slam_rgbd_tpu_torch.tools import run_slam

    def run(args):
        return {"backend": tdist.get_backend(), "world": tdist.get_world_size(),
                "rank": tdist.get_rank()}

    with mock.patch.object(run_slam, "_run", run):
        out = run_slam.main([str(seqs / "stereo"), str(tmp_path / "out"), "--distributed",
                             "--coordinator", f"file://{tmp_path / 'rendezvous'}",
                             "--num-processes", "1", "--process-id", "0", "--device", "cpu"])
    assert out == {"backend": "gloo", "world": 1, "rank": 0}
    assert not tdist.is_initialized()
    assert run_slam.coordinator_url("localhost:9911") == "tcp://localhost:9911"


@pytest.mark.parametrize("n_features, preset, slots", [
    (400, None, 1024), (1024, None, 1024), (2000, None, 2048), (2000, "kitti_large", 2048),
    (3000, None, 3072)])
def test_feature_slots_follow_the_feature_count(n_features, preset, slots):
    from dsp_slam_rgbd_tpu_torch import config
    from dsp_slam_rgbd_tpu_torch.frontend.orb import OrbConfig
    from dsp_slam_rgbd_tpu_torch.tools import run_slam

    cfg = config.SystemConfig(orb=OrbConfig(n_features=n_features))
    if preset:
        cfg = config.replace(cfg, map=config.MapConfig.kitti_large())
    assert run_slam.feature_slots(cfg) == slots
