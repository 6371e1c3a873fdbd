"""The port's scale-out tier (`dsp_slam_rgbd_tpu_torch/parallel/`) against
the single-process port and the JAX package, on the CPU.

Two processes (tests/torch_parallel_worker.py, one thread each) join a
gloo group through a `file://` rendezvous under tmp_path, with a 120 s
collective timeout so that a rank that hangs fails the run, and run:
  * the distribution helpers: a host array's shard and its gather, and a
    broadcast from rank 0;
  * `sharded_recon.reconstruct_sharded` at meshes (2, 1) and (1, 2) on
    tests/test_parallel.py's batch and configuration (8 spheres, 128
    points, 96 rays, 3 GN iterations) with the analytic sphere decoder:
    within 1e-4 of the single-process port and of the JAX package's
    `reconstruct_sharded` at the same mesh shape (conftest's 8 virtual CPU
    devices);
  * bundle adjustment with the edges sharded over a (1, 2) mesh, on
    tests/test_parallel.py's problems (and one with object edges): one LM
    step of the dense solver and one of PCG, each within 1e-4 (poses) and
    1e-3 (points) of the port's unsharded step; the whole two-stage
    `run_sharded_ba` within 1e-3 / 1e-2 of the unsharded `local_ba` and
    the same gated edges; `global_ba_pcg_sharded` at
    tests/test_parallel.py's tolerances against the port's `global_ba_pcg`
    (poses 2e-2, points 5e-2, and the ground-truth check).  The whole
    LM runs are held at tests/test_distributed_2proc.py's tolerances, not
    one step's: once converged, their costs sit at f32 rounding, so the
    order of the sums decides accept tests, and the unsharded solver alone
    moves by more than 1e-4 when the edges are listed in another order
    (test_edge_order_alone_moves_a_converged_local_ba);
  * a `SLAMSystem` over tests/test_torch_slam_system.py's world with its
    sphere detections, at `async_kf_frames` 3 (the collectives come from
    the mapping worker's thread): each rank builds a (2,) reconstruction
    mesh, and both ranks give the single-process run's trajectory and
    objects within 1e-4;
  * the same world with rank 1 given no detections from frame 1 on: the
    replicated maps split, and both ranks raise at the next keyframe job's
    agreement check, long before the collective timeout.
The reference runs of this process overlap the workers' runs.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from dsp_slam_rgbd_tpu.parallel import mesh as jmesh
from dsp_slam_rgbd_tpu.parallel import sharded_recon as jsr
from dsp_slam_rgbd_tpu.recon.optimizer import ReconConfig as JRecon
from dsp_slam_rgbd_tpu_torch.mapping import ba as tba
from dsp_slam_rgbd_tpu_torch.models.deepsdf import AnalyticSdfDecoder
from dsp_slam_rgbd_tpu_torch.ops import camera as tcam
from dsp_slam_rgbd_tpu_torch.parallel import mesh as tmesh
from dsp_slam_rgbd_tpu_torch.parallel import sharded_recon as tsr
from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconConfig as TRecon
from dsp_slam_rgbd_tpu_torch.system import detections as tdet
from dsp_slam_rgbd_tpu_torch.system import slam as tslam
from dsp_slam_rgbd_tpu_torch.weights import (ba_problem_from_numpy, ba_result_to_numpy,
                                             decoder_from_numpy)
from test_mapping import CAM, pose_errors, sim_ba_problem
from test_parallel import make_batch
from test_recon import CODE_LEN, PARAMS, SPEC
from test_torch_slam_system import SPEC as SLAM_SPEC
from test_torch_slam_system import configs, detections, frames, sphere_layers

HERE = os.path.dirname(os.path.abspath(__file__))
RECON_CFG = dict(code_len=CODE_LEN, num_iterations=3, k4=0.0, cut_off_threshold=0.05,
                 b2=0.05, max_grad_points=256)
MESHES = ((2, 1), (1, 2))
TCAM = tcam.Intrinsics(*CAM)


def _fields(prob) -> dict:
    return {f: np.asarray(getattr(prob, f)) for f in prob._fields}


def _slam_run(inputs):
    """The single-process port over the same sequence (worker.slam's loop)."""
    return worker.slam(inputs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel")
    batch = {k: np.asarray(v) for k, v in make_batch(B=8).items()}
    ba_local = [_fields(sim_ba_problem(np.random.default_rng(11), stereo=True)[0]),
                _fields(sim_ba_problem(np.random.default_rng(12), stereo=True,
                                       with_objects=True)[0])]
    prob13, kf_true13, _, _ = sim_ba_problem(np.random.default_rng(13), stereo=True)
    _, tc = configs(3)
    slam_in = {"cfg": tc, "layers": sphere_layers(), "spec": SLAM_SPEC, "imgs": frames(),
               "dets": detections(tdet)}
    inputs = {"helpers": {"x": np.arange(15, dtype=np.float32).reshape(5, 3)},
              "recon": {"batch": batch, "cfg": RECON_CFG, "code_len": CODE_LEN,
                        "meshes": MESHES},
              "ba": {"cam": tuple(CAM), "local": ba_local, "pcg": _fields(prob13)},
              "slam": slam_in}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"), str(r), "2",
         str(tmp / "rendezvous"), str(tmp / "in.pkl"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]

    # meanwhile, the references in this process
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tdec = AnalyticSdfDecoder(worker.sphere_sdf, CODE_LEN)
        tbatch = {k: torch.tensor(v) for k, v in batch.items()}
        ref = {"recon_single": tsr.reconstruct_sharded(tdec, TRecon(**RECON_CFG), tbatch,
                                                       tmesh.make_mesh()),
               "recon_jax": {}}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        for shape in MESHES:
            ref["recon_jax"][shape] = jsr.reconstruct_sharded(
                PARAMS, SPEC, JRecon(**RECON_CFG), jbatch, jmesh.make_mesh(*shape))
        ref["local"], ref["local_step"] = [], []
        for p in ba_local:
            prob = ba_problem_from_numpy(p, "cpu")
            ref["local"].append(ba_result_to_numpy(tba.local_ba(TCAM, prob)))
            ref["local_step"].append(tba._assemble_and_solve(TCAM, prob, 1e-3)[0])
        prob = ba_problem_from_numpy(_fields(prob13), "cpu")
        ref["pcg"] = ba_result_to_numpy(tba.global_ba_pcg(TCAM, prob))
        ref["pcg_step"] = tba._pcg_gn_step(TCAM, prob, 1e-3, 32)[0]
        ref["kf_true13"] = kf_true13
        ref["slam"] = _slam_run(slam_in)
    finally:
        torch.set_num_threads(prev)

    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = []
    for r in range(2):
        with open(tmp / f"out_{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs, ref


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_distribution_helpers(runs):
    """`shard_global` gives each rank its contiguous share (padded to the
    group size), `fetch` gathers the shares back without the padding, and
    `replicate` gives every rank rank 0's tensor."""
    outs, _ = runs
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    padded = np.concatenate([x, np.zeros((1, 3), np.float32)])
    for r, out in enumerate(outs):
        h = out["helpers"]
        assert h["mesh"] == {"obj": 1, "ray": 2}
        np.testing.assert_array_equal(h["local"], padded[3 * r:3 * r + 3])
        np.testing.assert_array_equal(h["fetched"], x)
        np.testing.assert_array_equal(h["replicated"], np.zeros(3, np.float32))


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_recon_matches_single_process_and_jax(runs, shape):
    outs, ref = runs
    single, jres = ref["recon_single"], ref["recon_jax"][shape]
    for out in outs:
        got = out["recon"][shape]
        for k in ("t_cam_obj", "code"):
            _close(got[k], getattr(single, k).numpy(), 1e-4)
            _close(got[k], getattr(jres, k), 1e-4)
        assert got["is_good"].all() and np.array_equal(got["is_good"], single.is_good.numpy())
        assert np.array_equal(got["is_good"], np.asarray(jres.is_good))
        # gathered over `obj` as packed rows, every field comes back contiguous,
        # as the unsharded fit returns it (the decoder kernels take no other code)
        assert got["contiguous"]


@pytest.mark.parametrize("case", [0, 1])
def test_sharded_local_ba_matches_unsharded(runs, case):
    outs, ref = runs
    step, want = ref["local_step"][case], ref["local"][case]
    for out in outs:
        _close(out["ba"]["local_step"][case]["kf_pose"], step.kf_pose.numpy(), 1e-4)
        _close(out["ba"]["local_step"][case]["pts"], step.pts.numpy(), 1e-3)
        got = out["ba"]["local"][case]
        _close(got["kf_pose"], want["kf_pose"], 1e-3)
        _close(got["pts"], want["pts"], 1e-2)
        _close(got["obj_pose"], want["obj_pose"], 1e-3)
        # the gathered masks: the whole edge set, padding cut
        assert np.array_equal(got["obs_mask"], want["obs_mask"])
        assert np.array_equal(got["oobs_mask"], want["oobs_mask"])
    assert np.array_equal(outs[0]["ba"]["local"][case]["kf_pose"],
                          outs[1]["ba"]["local"][case]["kf_pose"])   # one step on every rank


def test_sharded_pcg_matches_replicated(runs):
    outs, ref = runs
    want = ref["pcg"]
    kf_true = ref["kf_true13"]
    for out in outs:
        _close(out["ba"]["pcg_step"]["kf_pose"], ref["pcg_step"].kf_pose.numpy(), 1e-4)
        _close(out["ba"]["pcg_step"]["pts"], ref["pcg_step"].pts.numpy(), 1e-3)
        got = out["ba"]["pcg"]
        _close(got["kf_pose"], want["kf_pose"], 2e-2)
        _close(got["pts"], want["pts"], 5e-2)
        err = pose_errors(got["kf_pose"], kf_true)
        err_ref = pose_errors(want["kf_pose"], kf_true)
        assert err.mean() < max(0.05, 1.5 * err_ref.mean())
        assert got["obs_mask"].shape == want["obs_mask"].shape


def test_two_rank_slam_system_matches_one_process(runs):
    outs, ref = runs
    want = ref["slam"]
    assert want["mesh"] is None and want["obj_valid"].any()
    for out in outs:
        got = out["slam"]
        assert got["mesh"] == {"obj": 2, "ray": 1}
        assert got["n_kf"] == want["n_kf"]
        assert np.array_equal(got["ok"], want["ok"]) and np.array_equal(got["ts"], want["ts"])
        _close(got["poses"], want["poses"], 1e-4)
        assert np.array_equal(got["obj_valid"], want["obj_valid"])
        assert np.array_equal(got["kf_valid"], want["kf_valid"])
        for k in ("obj_pose", "obj_scale", "obj_code", "kf_pose"):
            _close(got[k], want[k], 1e-4)


def test_split_ranks_raise_instead_of_hanging(runs):
    """Ranks whose inputs differ disagree at the first keyframe job after
    the split (its detection count), and every rank raises there: none
    waits in a collective the other never makes."""
    outs, _ = runs
    for out in outs:
        got = out["slam_split"]
        assert got["error"] is not None and "ranks disagree at keyframe job" in got["error"]
        assert got["seconds"] < 60.0


def test_agreement_check_without_a_group():
    """One process: `agree` checks nothing, and the map fingerprint moves
    with a valid point but not with an invalid slot."""
    from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
    from dsp_slam_rgbd_tpu_torch.parallel import distributed as tdist_mod
    from dsp_slam_rgbd_tpu_torch.system.mapping_stage import map_fingerprint

    tdist_mod.agree("anything", [1, 2, 3])
    st = tms.empty(max_kf=4, max_feat=8, max_pts=16, max_obj=2, code_len=4, device="cpu")
    base = map_fingerprint(st)
    assert base.dtype == torch.float64 and torch.isfinite(base).all()
    hidden = st._replace(pt_pos=st.pt_pos.index_fill(0, torch.tensor([3]), float("nan")))
    assert torch.equal(map_fingerprint(hidden), base)
    seen = st._replace(pt_pos=st.pt_pos.index_fill(0, torch.tensor([3]), 1.0),
                       pt_valid=st.pt_valid.index_fill(0, torch.tensor([3]), True))
    assert not torch.equal(map_fingerprint(seen), base)


def test_edge_order_alone_moves_a_converged_local_ba():
    """Why whole sharded LM runs are held at 1e-3 / 1e-2, not one step's
    1e-4 / 1e-3: the unsharded `local_ba` on tests/test_parallel.py's
    problem, with its edges listed in another order, moves by more than
    1e-4 (5.7e-4 in poses on the CPU; printed): the accept tests of
    the converged LM sit at f32 rounding.  It stays inside the whole
    runs' tolerances."""
    f = _fields(sim_ba_problem(np.random.default_rng(11), stereo=True)[0])
    ref = tba.local_ba(TCAM, ba_problem_from_numpy(f, "cpu"))
    perm = np.random.default_rng(0).permutation(len(f["obs_kf"]))
    g = dict(f, **{k: f[k][perm] for k in ("obs_kf", "obs_pt", "obs_uv", "obs_info",
                                           "obs_mask")})
    out = tba.local_ba(TCAM, ba_problem_from_numpy(g, "cpu"))
    moved = float((out.kf_pose - ref.kf_pose).abs().max())
    print(f"edge order moves the poses by {moved:.3g}")
    assert moved < 1e-3
    assert float((out.pts - ref.pts).abs().max()) < 1e-2


def test_mesh_build_checks_the_world():
    """One process without a group: a (1, 1) mesh with no groups; a mesh
    larger than the world raises, it does not shrink."""
    m = tmesh.make_mesh()
    assert m.shape == {"obj": 1, "ray": 1} and m.group("obj") is None and m.index("ray") == 0
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.make_mesh(n_obj=2)
    with pytest.raises(ValueError, match="axis"):
        m.group("batch")
