"""The port's active mapping (`dsp_slam_rgbd_tpu_torch/active/`) against the
JAX package's, on tests/test_active.py's cases, with the same inputs.

  * RRT: the same seed gives the same path, node for node (both draw from
    numpy's `default_rng`), and the same failure;
  * NBV with tests/test_active.py's analytic sphere decoder (the port's
    `AnalyticSdfDecoder` over a torch callable of the same function): the
    37 candidate poses within 1e-5, the rewards within 1e-4 relative, the
    same chosen candidate, the uncertainty score within 1e-5, the same
    RRT path;
  * the same `generate` with the trained fixture decoder (cars_64 layout,
    the f32 value kernel's route; its plain version here) on members near
    its surface: the same tolerances.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.active import nbv as jnbv
from dsp_slam_rgbd_tpu.active import rrt as jrrt
from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.ops import camera as jcam
from dsp_slam_rgbd_tpu_torch.active import nbv as tnbv
from dsp_slam_rgbd_tpu_torch.active import rrt as trrt
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy, map_state_from_numpy
from test_active import _sphere_fn, _world_with_object

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ellipsoid_decoder_64.npz")
JCAM = jcam.Intrinsics(fx=200.0, fy=200.0, cx=112.0, cy=80.0)
TCAM = tcam.Intrinsics(fx=200.0, fy=200.0, cx=112.0, cy=80.0)


def sphere_sdf(code, xyz):
    """tests/test_active.py::_sphere_fn in torch: a sphere of radius 0.5."""
    return torch.linalg.vector_norm(xyz, dim=-1) - 0.5


def _port_state(jstate):
    return map_state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields},
                                "cpu")


def _same_path(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(a, b)


def _box(center, half):
    return (np.asarray(center, np.float32), np.eye(3, dtype=np.float32),
            np.asarray(half, np.float32))


@pytest.mark.parametrize("case", [
    dict(boxes=[], step=0.5, seed=1, max_iters=2000),
    dict(boxes=[_box([1.5, 0, 0], [0.5, 1.0, 1.0])], step=0.4, seed=2, max_iters=5000),
    dict(boxes=[_box([3, 0, 0], [1.0, 1.0, 1.0])], step=0.4, seed=3, max_iters=300),
], ids=["straight", "around_box", "goal_enclosed"])
def test_rrt_plans_the_jax_path(case):
    kw = dict(step=case["step"], seed=case["seed"], max_iters=case["max_iters"])
    j = jrrt.plan([0, 0, 0], [3, 0, 0], [jrrt.BoxObstacle(*b) for b in case["boxes"]], **kw)
    t = trrt.plan([0, 0, 0], [3, 0, 0], [trrt.BoxObstacle(*b) for b in case["boxes"]], **kw)
    _same_path(t.path, j.path)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    if case["seed"] == 3:
        assert t.path is None          # the goal is inside the box
    else:
        assert t.path is not None and np.allclose(t.path[-1], [3, 0, 0])


def test_obstacles_from_map_match_jax():
    jst, _, _ = _world_with_object()
    j = jrrt.obstacles_from_map(jst)
    t = trrt.obstacles_from_map(_port_state(jst))
    assert len(t) == len(j) == 1
    for a, b in zip(t, j):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_rotate_candidates_match_jax():
    base = np.eye(4, dtype=np.float32)
    base[:3, :3] = np.asarray(jnp.asarray(
        [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]))
    base[:3, 3] = [1.0, 2.0, 3.0]
    j = np.asarray(jnbv.rotate_candidates(jnp.asarray(base)))
    t = tnbv.rotate_candidates(torch.tensor(base)).numpy()
    assert t.shape == (37, 4, 4)
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t[18], base, atol=1e-5)


def test_score_candidates_match_jax():
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((40, 3)) * 0.5 + [0, 0, 5.0]).astype(np.float32)
    err = rng.random(40).astype(np.float32)
    mask = rng.random(40) > 0.2
    base = np.eye(4, dtype=np.float32)
    cands = np.asarray(jnbv.rotate_candidates(jnp.asarray(base)))
    cur = np.eye(4, dtype=np.float32)
    cur[:3, 3] = [0.3, 0.0, -0.5]
    j = np.asarray(jnbv.score_candidates(JCAM, jnp.asarray(cands), jnp.asarray(cur),
                                         jnp.asarray(pts), jnp.asarray(err),
                                         jnp.asarray(mask)))
    t = tnbv.score_candidates(TCAM, torch.tensor(cands), torch.tensor(cur), torch.tensor(pts),
                              torch.tensor(err), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5)
    assert int(np.argmax(t)) == int(np.argmax(j))


def test_generate_without_decoder_matches_jax():
    st = jms.empty(max_kf=4, max_feat=8, max_pts=16, max_obj=2)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0, 0, 5]
    st = st._replace(obj_pose=jnp.asarray(np.stack([pose, np.eye(4)])),
                     obj_valid=jnp.asarray([True, False]))
    j = jnbv.generate(st, np.eye(4))
    t = tnbv.generate(_port_state(st), np.eye(4))
    assert t.target_obj == j.target_obj == 0 and t.candidates is None
    np.testing.assert_allclose(t.view_t_wc, np.asarray(j.view_t_wc), atol=1e-6)
    np.testing.assert_allclose(t.view_t_wc[:3, 3], [0, 0, 10], atol=1e-4)
    _same_path(t.path, j.path)
    assert t.score == j.score == 0.0
    empty = jms.empty(max_kf=4, max_feat=8, max_pts=16, max_obj=2)
    assert tnbv.generate(_port_state(empty), np.eye(4)) is None


def _hold_plans(t, j):
    assert t.target_obj == j.target_obj
    np.testing.assert_allclose(t.candidates, j.candidates, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.rewards, j.rewards, rtol=1e-4, atol=1e-5)
    assert int(np.argmax(t.rewards)) == int(np.argmax(j.rewards))
    np.testing.assert_allclose(t.view_t_wc, j.view_t_wc, atol=1e-5)
    np.testing.assert_allclose(t.score, j.score, rtol=1e-4, atol=1e-5)
    _same_path(t.path, j.path)


def test_generate_with_candidates_matches_jax():
    jst, params, spec = _world_with_object()
    assert spec.fn is _sphere_fn
    j = jnbv.generate(jst, np.eye(4), decoder_params=params, decoder_spec=spec, cam=JCAM)
    dec = decoder_from_numpy([], spec, device="cpu", fn=sphere_sdf)
    t = tnbv.generate(_port_state(jst), np.eye(4), decoder=dec, cam=TCAM)
    assert t.candidates.shape == (37, 4, 4) and t.rewards.shape == (37,)
    np.testing.assert_allclose(t.view_t_wc, t.candidates[int(np.argmax(t.rewards))])
    assert t.score > 0.0
    _hold_plans(t, j)


def test_generate_with_the_fixture_decoder_matches_jax():
    """The cars_64 fixture decoder (the f32 value kernel's route on the
    card) scoring an object of its ellipsoid family."""
    jparams, jspec = jdeepsdf.load_npz(FIXTURE)
    tdec = tdeepsdf.load_npz(FIXTURE, device="cpu")
    rng = np.random.default_rng(1)
    L = tdec.spec.latent_size
    st = jms.empty(max_kf=4, max_feat=8, max_pts=256, max_obj=2, code_len=L)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.5, 0.0, 6.0]
    code = (rng.standard_normal(L) * 0.3).astype(np.float32)
    d = rng.standard_normal((200, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (pose[:3, 3] + d * rng.uniform(0.3, 0.9, (200, 1))).astype(np.float32)
    st = st._replace(
        obj_pose=jnp.asarray(np.stack([pose, np.eye(4, dtype=np.float32)])),
        obj_valid=jnp.asarray([True, False]), obj_scale=st.obj_scale.at[0].set(1.0),
        obj_code=st.obj_code.at[0].set(jnp.asarray(code)),
        pt_pos=st.pt_pos.at[:200].set(jnp.asarray(pts)), pt_valid=st.pt_valid.at[:200].set(True),
        pt_object=st.pt_object.at[:200].set(0))
    j = jnbv.generate(st, np.eye(4), decoder_params=jparams, decoder_spec=jspec, cam=JCAM)
    t = tnbv.generate(_port_state(st), np.eye(4), decoder=tdec, cam=TCAM)
    _hold_plans(t, j)
