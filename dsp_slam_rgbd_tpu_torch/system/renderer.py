"""Object depth renderer: the fitted SDF drawn along camera rays.

Counterpart of `dsp_slam_rgbd_tpu/system/renderer.py`, the role of the
reference's offscreen GLSL renderer (`include/Renderer.hpp:24-80`, driven
by `ObjectDrawer.cc:53-132`): instead of rasterizing a mesh, every pixel
ray is sampled along its chord through the object's unit sphere
(`recon/losses.chord_sample_depths`), the decoder's SDF is evaluated at
the samples (`DeepSDFDecoder.query`: on the card the f32 value kernel for
the kernels' layouts, latent 64 or 256), and the render loss's termination-probability
model turns it into an expected depth and a hit mask.  Host code only
composites objects.
"""
from __future__ import annotations

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.ops import lie
from dsp_slam_rgbd_tpu_torch.recon import losses


def render_object_depth(decoder, code, t_cam_obj, cam_K, hw, n_samples: int = 32,
                        stride: int = 1, th: float = 0.02):
    """One object's depth image.

    t_cam_obj: (4, 4) Sim(3) object→camera (scale in the rotation block);
    cam_K: (3, 3) intrinsics; hw: (H, W) output size; `stride` renders every
    stride-th pixel.  Tensors on the decoder's device.

    Returns (depth (H', W'), hit (H', W')): the expected depth along each
    pixel ray, and whether the ray meets the decoded surface (accumulated
    opacity > 0.5)."""
    dev = decoder.device
    H, W = hw
    cam_K = torch.as_tensor(cam_K, dtype=torch.float32, device=dev)
    u = torch.arange(0, W, stride, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(0, H, stride, dtype=torch.float32, device=dev) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rays = torch.stack([(uu - cam_K[0, 2]) / cam_K[0, 0], (vv - cam_K[1, 2]) / cam_K[1, 1],
                        torch.ones_like(uu)], -1).reshape(-1, 3)      # (R, 3), z = 1

    t_obj_cam = lie.inv_sim3(torch.as_tensor(t_cam_obj, dtype=torch.float32, device=dev))
    depths, hit = losses.chord_sample_depths(t_obj_cam, rays, n_samples)
    R, M = depths.shape
    pts_obj = lie.transform_points(t_obj_cam, (rays[:, None, :] * depths[:, :, None]).reshape(-1, 3))
    sdf = decoder.query(torch.as_tensor(code, dtype=torch.float32, device=dev),
                        pts_obj).reshape(R, M)
    inside = torch.linalg.vector_norm(pts_obj.reshape(R, M, 3), dim=-1) < 1.0
    occ = torch.where(inside & hit[:, None], losses.sdf_to_occupancy(sdf, th), 0.0)
    acc = torch.cumprod(1.0 - occ, dim=-1)
    acc_prev = torch.cat([torch.ones(R, 1, device=dev), acc[:, :-1]], dim=-1)
    p = occ * acc_prev                        # termination probabilities
    w = torch.sum(p, dim=-1)                  # accumulated opacity
    d = torch.sum(depths * p, dim=-1) / torch.clamp_min(w, 1e-9)
    hit_px = hit & (w > 0.5)
    H2, W2 = (H + stride - 1) // stride, (W + stride - 1) // stride
    return torch.where(hit_px, d, 0.0).reshape(H2, W2), hit_px.reshape(H2, W2)


def render_map_objects(decoder, state, cam_K, t_cw, hw, n_samples: int = 32,
                       stride: int = 1) -> np.ndarray:
    """Composite depth of every valid map object seen from camera pose t_cw
    (the `ObjectDrawer::DrawObjects` role: each object's pose, scale and
    code from the map; the nearest surface wins).  -> (H', W') f32."""
    H2, W2 = (hw[0] + stride - 1) // stride, (hw[1] + stride - 1) // stride
    depth = np.zeros((H2, W2), np.float32)
    dev = decoder.device
    t_cw = torch.as_tensor(t_cw, dtype=torch.float32, device=dev)
    for o in np.nonzero(state.obj_valid.cpu().numpy())[0]:
        t_co = t_cw @ state.obj_pose[int(o)]
        t_co = torch.cat([t_co[:3, :3] * state.obj_scale[int(o)], t_co[:3, 3:]], 1)
        t_co = torch.cat([t_co, t_cw.new_tensor([[0.0, 0.0, 0.0, 1.0]])])
        d, h = render_object_depth(decoder, state.obj_code[int(o)], t_co, cam_K, hw,
                                   n_samples=n_samples, stride=stride)
        d, h = d.cpu().numpy(), h.cpu().numpy()
        closer = h & ((depth == 0) | (d < depth))
        depth[closer] = d[closer]
    return depth
