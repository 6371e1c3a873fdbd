"""The port's mesh extraction, detection containers, label files and the
single-frame reconstruction tool against the JAX package's, on the CPU.

Grid decodes are compared at atol 2e-5 (f32); the numpy triangulation is
the same code in both packages and must give identical meshes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.models import mesh as jmesh
from dsp_slam_rgbd_tpu.system import detections as jdet
from dsp_slam_rgbd_tpu.system import sequence as jseq
from dsp_slam_rgbd_tpu_torch.models import deepsdf as tdeepsdf
from dsp_slam_rgbd_tpu_torch.models import mesh as tmesh
from dsp_slam_rgbd_tpu_torch.system import detections as tdet
from dsp_slam_rgbd_tpu_torch.system import sequence as tseq
from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy

SPEC = jdeepsdf.DecoderSpec(latent_size=8, dims=(32, 32, 32), latent_in=(2,))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the port's decoder): a small decoder whose last bias
    puts its zero level set through the middle of the grid."""
    params = jdeepsdf.init_params(SPEC, jax.random.PRNGKey(0))
    layers = [(np.asarray(W), np.asarray(b)) for W, b in params["layers"]]
    grid = tmesh.create_voxel_grid(16)
    pre = np.arctanh(decoder_from_numpy(layers, SPEC, device="cpu")
                     .query(torch.zeros(8), grid).numpy())
    layers[-1] = (layers[-1][0], np.full(1, -np.median(pre), np.float32))
    return ({"layers": [(jnp.asarray(W), jnp.asarray(b)) for W, b in layers]},
            decoder_from_numpy(layers, SPEC, device="cpu"))


def test_voxel_grid_matches_jax():
    np.testing.assert_allclose(tmesh.create_voxel_grid(9, 1.1).numpy(),
                               np.asarray(jmesh.create_voxel_grid(9, 1.1)), atol=1e-7)


def test_marching_tetrahedra_is_the_reference_triangulation():
    g = np.asarray(jmesh.create_voxel_grid(20)).reshape(20, 20, 20, 3)
    sdf = np.linalg.norm(g, axis=-1) - 0.6
    vt, ft = tmesh.marching_tetrahedra(sdf)
    vj, fj = jmesh.marching_tetrahedra(sdf)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(vt) > 100 and len(ft) > 100
    r = np.linalg.norm(vt, axis=1)
    assert np.all(np.abs(r - 0.6) < 0.05)
    empty = tmesh.marching_tetrahedra(np.ones((4, 4, 4), np.float32))
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_mesh_extractor_matches_jax(pair):
    params, dec = pair
    code = (np.random.default_rng(0).standard_normal(8) * 0.1).astype(np.float32)
    t = tmesh.MeshExtractor(dec, code_len=8, voxels_dim=16)
    j = jmesh.MeshExtractor(params, SPEC, code_len=8, voxels_dim=16)
    np.testing.assert_allclose(t.decode(code).numpy().reshape(-1),
                               np.asarray(j._decode(jnp.asarray(code))), atol=2e-5)
    mt, mj = t.extract_mesh_from_code(code), j.extract_mesh_from_code(code)
    assert len(mt["faces"]) > 0
    assert abs(len(mt["faces"]) - len(mj["faces"])) <= 0.01 * len(mj["faces"])


def test_sdf_bbox_matches_jax(pair):
    params, dec = pair
    code = np.zeros(8, np.float32)
    bt = tmesh.sdf_bbox(dec, torch.tensor(code), vol_dim=12)
    bj = jmesh.sdf_bbox(params, SPEC, jnp.asarray(code), vol_dim=12)
    for a, b in zip(bt, bj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_write_ply_matches_jax(tmp_path):
    v = np.random.default_rng(1).random((5, 3)).astype(np.float32)
    f = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    tmesh.write_ply(str(tmp_path / "t.ply"), v, f)
    jmesh.write_ply(str(tmp_path / "j.ply"), v, f)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


def _detection(mod, seed):
    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] *= 1.7
    T[:3, 3] = [0.2, 0.1, 4.0]
    pts = (rng.standard_normal((40, 3)) * 0.3 + [0.2, 0.1, 4.0]).astype(np.float32)
    rays = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    return mod.make_detection(T, pts=pts, rays=rays, depth=np.linalg.norm(pts, axis=1),
                              n_fg=30)


def test_make_detection_matches_jax():
    t, j = _detection(tdet, 2), _detection(jdet, 2)
    assert tdet.ObjectDetection._fields == jdet.ObjectDetection._fields
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_label_files_cross_read(tmp_path):
    dets = [_detection(tdet, 3), _detection(tdet, 4)]
    tseq.save_label_file(str(tmp_path / "t.npz"), dets)
    for loaded in (tseq.load_label_file(str(tmp_path / "t.npz")),
                   jseq.load_label_file(str(tmp_path / "t.npz"))):
        assert len(loaded) == 2
        for a, b in zip(loaded[1], dets[1]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jseq.save_label_file(str(tmp_path / "j.npz"), [_detection(jdet, 5)])
    (back,) = tseq.load_label_file(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(back.pts, _detection(jdet, 5).pts)
    assert tseq.load_label_file(str(tmp_path / "missing.npz")) == []


def test_reconstruct_frame_tool_on_cpu(tmp_path, pair):
    from dsp_slam_rgbd_tpu_torch.tools import reconstruct_frame

    _, dec = pair
    tdeepsdf.save_npz(str(tmp_path / "dec.npz"), dec)
    tseq.save_label_file(str(tmp_path / "labels.npz"), [_detection(tdet, 6)])
    out = tmp_path / "out"
    reconstruct_frame.main([str(tmp_path / "labels.npz"), str(tmp_path / "dec.npz"),
                            str(out), "--iters", "2", "--device", "cpu"])
    pose = np.load(out / "det0_pose.npy")
    assert pose.shape == (4, 4) and np.isfinite(pose).all()
    assert np.load(out / "det0_code.npy").shape == (8,)
    assert (out / "det0.ply").read_text().startswith("ply")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reconstruct_frame.main([str(tmp_path / "labels.npz"), str(tmp_path / "dec.npz"),
                                    str(out)])
