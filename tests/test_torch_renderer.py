"""The port's object depth renderer, frame/map pictures and live viewer on
the CPU.

`render_object_depth` and `render_map_objects` are held to the JAX
package's at 2e-5 (depths) with equal hit masks, on a small decoder fitted
to a sphere family (tests/test_torch_slam_system.py's) carried across as
numpy; the sphere's depth is also checked against its geometry.  The
viz functions and `LiveViewer` run as tests/test_utils_aux.py runs the
JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsp_slam_rgbd_tpu.mapping import map_state as jms
from dsp_slam_rgbd_tpu.models import deepsdf as jdeepsdf
from dsp_slam_rgbd_tpu.system import renderer as jrender
from dsp_slam_rgbd_tpu.system import viz as jviz
from dsp_slam_rgbd_tpu_torch.mapping import map_state as tms
from dsp_slam_rgbd_tpu_torch.system import renderer as trender
from dsp_slam_rgbd_tpu_torch.system import viz as tviz
from dsp_slam_rgbd_tpu_torch.weights import decoder_from_numpy, map_state_from_numpy
from test_torch_slam_system import SPEC, sphere_layers

K = np.array([[100.0, 0, 64.0], [0, 100.0, 48.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def decoders():
    layers = sphere_layers()
    return ({"layers": [(jnp.asarray(W), jnp.asarray(b)) for W, b in layers]},
            jdeepsdf.DecoderSpec(*SPEC), decoder_from_numpy(layers, SPEC, device="cpu"))


@pytest.mark.parametrize("stride", [1, 3])
def test_render_object_depth_matches_jax(decoders, stride):
    params, spec, dec = decoders
    code = np.array([0.5, 0.0, 0.0, 0.0], np.float32)     # radius ~0.6
    t_co = np.eye(4, dtype=np.float32)
    t_co[:3, :3] *= 2.0
    t_co[:3, 3] = [0.3, -0.2, 8.0]
    dj, hj = jrender.render_object_depth(params, spec, jnp.asarray(code), jnp.asarray(t_co),
                                         jnp.asarray(K), (96, 128), n_samples=48,
                                         stride=stride)
    dt, ht = trender.render_object_depth(dec, torch.tensor(code), torch.tensor(t_co), K,
                                         (96, 128), n_samples=48, stride=stride)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=2e-5, rtol=0)
    h = ht.numpy()
    assert h.any() and not h[0, 0]
    if stride == 1:
        # the nearest surface on the center ray: 8 m less the world radius (~1.2 m)
        r, c = int(48 - 0.2 * 100 / 8.0), int(64 + 0.3 * 100 / 8.0)
        assert abs(float(dt[r, c]) - (8.0 - 1.2)) < 0.15


def test_render_map_objects_matches_jax(decoders):
    params, spec, dec = decoders
    st = jms.empty(max_kf=2, max_feat=8, max_pts=8, max_obj=4, code_len=4)
    f = {k: np.array(v) for k, v in st._asdict().items()}
    f["obj_pose"][0, :3, 3] = [0.0, 0.0, 6.0]
    f["obj_pose"][1, :3, 3] = [0.4, 0.1, 12.0]
    f["obj_scale"][:2] = [1.0, 1.5]
    f["obj_code"][:2, 0] = 0.5
    f["obj_valid"][:2] = True
    t_cw = np.eye(4, dtype=np.float32)
    t_cw[0, 3] = 0.1
    dj = jrender.render_map_objects(params, spec, jms.MapState(**{
        k: jnp.asarray(v) for k, v in f.items()}), K, jnp.asarray(t_cw), (96, 128),
        n_samples=48, stride=2)
    dt = trender.render_map_objects(dec, map_state_from_numpy(f, device="cpu"), K, t_cw,
                                    (96, 128), n_samples=48, stride=2)
    assert dt.shape == dj.shape == (48, 64)
    np.testing.assert_allclose(dt, dj, atol=2e-5, rtol=0)
    assert (dt > 0).sum() > 50


def test_viz_matches_jax(tmp_path):
    from dsp_slam_rgbd_tpu.frontend.orb import Features as JFeatures
    from dsp_slam_rgbd_tpu.tracking.tracker import Frame as JFrame
    from dsp_slam_rgbd_tpu_torch.weights import frame_from_numpy

    rng = np.random.default_rng(0)
    F = 60
    feats = {"xy": rng.uniform(0, 100, (F, 2)).astype(np.float32),
             "level": np.zeros(F, np.int32), "angle": np.zeros(F, np.float32),
             "score": np.zeros(F, np.float32), "desc": np.zeros((F, 8), np.uint32),
             "valid": rng.uniform(size=F) > 0.2}
    pt_idx = np.where(rng.uniform(size=F) > 0.5, 3, -1).astype(np.int32)
    jframe = JFrame(JFeatures(**{k: jnp.asarray(v) for k, v in feats.items()}),
                    jnp.full(F, -1.0), jnp.full(F, -1.0), jnp.eye(4), jnp.asarray(pt_idx), 0.0)
    tframe = frame_from_numpy({"feats": feats, "ur": np.full(F, -1.0, np.float32),
                               "depth": np.full(F, -1.0, np.float32),
                               "t_cw": np.eye(4, dtype=np.float32), "pt_idx": pt_idx,
                               "timestamp": 0.0}, device="cpu")
    img = rng.integers(0, 255, (90, 110)).astype(np.uint8)
    a = tviz.draw_frame(img, tframe)
    np.testing.assert_array_equal(a, jviz.draw_frame(img, jframe))
    tviz.save_frame_png(str(tmp_path / "f.png"), img, tframe)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.png")), a)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, 0, 3] = -np.arange(5, dtype=np.float32)
    np.testing.assert_allclose(tviz.camera_centers(torch.from_numpy(poses))[:, 0], np.arange(5))
    tviz.trajectory_figure(poses, rng.standard_normal((50, 3)), str(tmp_path / "map.png"))
    assert Image.open(tmp_path / "map.png").size[0] > 100


def test_live_viewer_serves_map():
    import time
    import urllib.request

    from dsp_slam_rgbd_tpu_torch.config import MapConfig, SystemConfig
    from dsp_slam_rgbd_tpu_torch.system.live_viewer import LiveViewer
    from dsp_slam_rgbd_tpu_torch.system.slam import SLAMSystem

    s = SLAMSystem(SystemConfig(map=MapConfig(max_kf=4, max_feat=32, max_pts=64, max_obj=2,
                                              max_oobs=8)), device="cpu")
    s.state = s.state._replace(kf_valid=torch.tensor([True, False, True, False]),
                               obj_valid=torch.tensor([True, False]))
    viewer = LiveViewer(s, port=0, refresh_s=0.1)
    try:
        for _ in range(50):   # wait for the first render
            page = urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/", timeout=5).read()
            png = urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/map.png",
                                         timeout=5).read()
            if png[:8] == b"\x89PNG\r\n\x1a\n":
                break
            time.sleep(0.1)
        assert b"live map" in page
        assert png[:8] == b"\x89PNG\r\n\x1a\n", viewer.last_error
    finally:
        viewer.close()
        s.shutdown()
