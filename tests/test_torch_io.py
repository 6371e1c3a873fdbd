"""The port's trajectory and map writers and its checkpoints against the
JAX package's, on the CPU.

The writers must give the same bytes as the JAX package's for the same
poses and map state (`weights.map_state_from_numpy` carries the state
across): the camera-to-world translation is held to XLA's fused
multiply-add order (`io.fma32`), so no field is held at an ulp instead.
Checkpoints use the JAX package's npz keys, so each package loads the
other's, exactly.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.ops import lie as jlie
from dsp_slam_rgbd_tpu.system import io as jio
from dsp_slam_rgbd_tpu.utils import checkpoint as jckpt
from dsp_slam_rgbd_tpu.utils import timers as jtimers
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.system import io as tio
from dsp_slam_rgbd_tpu_torch.utils import checkpoint as tckpt
from dsp_slam_rgbd_tpu_torch.utils import timers as ttimers
from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy, map_state_to_numpy


def random_poses(n, seed=0, spread=30.0):
    """(n, 4, 4) f32 T_cw with rotations of every size, some near π."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, 3))
    w *= rng.uniform(0, np.pi, (n, 1)) / np.linalg.norm(w, axis=1, keepdims=True)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = np.asarray(jlie.exp_so3(jnp.asarray(w, jnp.float32)))
    T[:, :3, 3] = rng.standard_normal((n, 3)) * spread
    return T


def random_map(seed=0):
    """A JAX `MapState` with live points, keyframes and static and dynamic
    objects at random values."""
    rng = np.random.default_rng(seed)
    K, P, O = 12, 300, 6
    st = jms.empty(max_kf=K, max_feat=16, max_pts=P, max_obj=O, code_len=8, max_oobs=16)
    f = {k: np.array(v) for k, v in st._asdict().items()}
    f["kf_pose"] = random_poses(K, seed + 1, 10.0)
    f["kf_valid"] = rng.uniform(size=K) > 0.3
    f["pt_pos"] = (rng.standard_normal((P, 3)) * 20).astype(np.float32)
    f["pt_valid"] = rng.uniform(size=P) > 0.4
    f["obj_pose"] = random_poses(O, seed + 2, 8.0)
    f["obj_scale"] = rng.uniform(0.5, 3.0, O).astype(np.float32)
    f["obj_code"] = rng.standard_normal((O, 8)).astype(np.float32)
    f["obj_valid"] = np.array([True, True, False, True, True, True])
    f["obj_dynamic"] = np.array([False, True, False, False, False, True])
    return jms.MapState(**{k: jnp.asarray(v) for k, v in f.items()}), f


def test_fma32_is_one_rounding():
    """fma32 gives the f32 nearest to the exact a·b + c (ties to even)."""
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(20000).astype(np.float32) * s for s in (3, 5, 40))
    got = tio.fma32(a, b, c)
    for i in range(0, 20000, 97):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the f32 nearest to the exact value (ties to even)
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                         int(np.float32(x).view(np.int32)) & 1))
        assert got[i] == best, i


@pytest.mark.parametrize("seed", [0, 1])
def test_trajectory_writers_byte_identical(tmp_path, seed):
    T = random_poses(400, seed)
    ts = np.arange(400) * 0.1 + 1e9 * seed
    ok = np.random.default_rng(seed).uniform(size=400) > 0.1
    for name, j, t in (
            ("kitti", lambda p: jio.save_trajectory_kitti(p, T, ok),
             lambda p: tio.save_trajectory_kitti(p, torch.from_numpy(T), ok)),
            ("tum", lambda p: jio.save_trajectory_tum(p, T, ts, ok),
             lambda p: tio.save_trajectory_tum(p, T, ts, ok))):
        j(str(tmp_path / f"{name}_j"))
        t(str(tmp_path / f"{name}_t"))
        a = (tmp_path / f"{name}_j").read_bytes()
        assert a.count(b"\n") == ok.sum()
        assert a == (tmp_path / f"{name}_t").read_bytes(), name


def test_map_writers_byte_identical(tmp_path):
    js, fields = random_map()
    ts = map_state_from_numpy(fields, device="cpu")
    frames = random_poses(40, 7)
    jio.save_entire_map(str(tmp_path / "j"), js, frames, np.ones(40, bool))
    tio.save_entire_map(str(tmp_path / "t"), ts, frames, np.ones(40, bool))
    for name in ("MapPoints.txt", "MapObjects.txt", "Cameras.txt", "FrameTrajectory.txt"):
        a = (tmp_path / "j" / name).read_bytes()
        assert len(a) > 0 and a == (tmp_path / "t" / name).read_bytes(), name
    # only the static valid objects: slots 0, 3, 4
    ids, poses, codes = tio.load_map_objects(str(tmp_path / "t" / "MapObjects.txt"))
    assert ids.tolist() == [0, 3, 4]


def test_load_map_objects_round_trip(tmp_path):
    js, fields = random_map(5)
    tio.save_entire_map(str(tmp_path), map_state_from_numpy(fields, device="cpu"))
    ids, poses, codes = tio.load_map_objects(str(tmp_path / "MapObjects.txt"))
    jids, jposes, jcodes = jio.load_map_objects(str(tmp_path / "MapObjects.txt"))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(poses, jposes)
    np.testing.assert_array_equal(codes, jcodes)
    for k, o in enumerate(ids):
        sim3 = fields["obj_pose"][o].copy()
        sim3[:3, :3] *= fields["obj_scale"][o]
        np.testing.assert_allclose(poses[k], sim3, atol=1e-8 + 1e-9 * 30)
        np.testing.assert_allclose(codes[k], fields["obj_code"][o], atol=1e-9)
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert tio.load_map_objects(str(empty))[0].shape == (0,)


def test_checkpoints_cross_load(tmp_path):
    js, fields = random_map(9)
    fields["pt_desc"] = np.random.default_rng(0).integers(0, 2**32, (300, 8), dtype=np.uint32)
    js = js._replace(pt_desc=jnp.asarray(fields["pt_desc"]))
    ts = map_state_from_numpy(fields, device="cpu")
    # the port's file, read by the JAX package
    tckpt.save_state(str(tmp_path / "t.npz"), ts, extra={"n_kf": 7})
    back_j, extra = jckpt.load_state(str(tmp_path / "t.npz"))
    assert int(extra["n_kf"]) == 7
    for k in jms.MapState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back_j, k)), fields[k], err_msg=k)
    # the JAX package's file, read by the port
    jckpt.save_state(str(tmp_path / "j.npz"), js, extra={"frame_id": 42})
    back_t, extra = tckpt.load_state(str(tmp_path / "j.npz"), device="cpu")
    assert int(extra["frame_id"]) == 42
    got = map_state_to_numpy(back_t)
    for k in tms.MapState._fields:
        np.testing.assert_array_equal(got[k], fields[k], err_msg=k)
    # a file missing a field takes empty()'s default for it
    z = dict(np.load(tmp_path / "j.npz"))
    del z["pt_outlier"]
    np.savez(tmp_path / "old.npz", **z)
    old, _ = tckpt.load_state(str(tmp_path / "old.npz"), device="cpu")
    assert not bool(old.pt_outlier.any()) and old.pt_outlier.shape == (300,)


def test_stage_timers_match_jax_summary_keys():
    for mod in (ttimers, jtimers):
        t = mod.StageTimers()
        for name in ("a", "a", "b"):
            with t.stage(name):
                sum(range(1000))
        s = t.summary()
        assert s["a"]["n"] == 2 and s["b"]["n"] == 1
        assert set(s["a"]) == {"n", "mean_ms", "median_ms", "p90_ms", "total_s"}
        assert "a" in t.report()
    sync = ttimers.StageTimers(sync=True, device="cpu")
    with sync.stage("c"):
        pass
    assert sync.summary()["c"]["n"] == 1


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with ttimers.profiler_trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
