"""Objects of the fixture decoder's ellipsoid family placed in a plane world.

The object stage's fixture, beside `plane_world.py`: the camera of a
`plane_world.World` translates along x (frame i at world x = gt_x(i),
no rotation; a `loop_world.Circuit`'s drives its ellipse in x and y),
and `Truth` objects of the family that
`tests/fixtures/ellipsoid_decoder_64.npz` was trained on
(`ellipsoid.code_to_axes`, scale 2, up = −y) stand in front of it, static
or moving at a constant world velocity.  `detections` builds each visible
object's `make_detection` inputs in a given camera frame as
`ellipsoid.make_problem` does: surface points, 3/4 foreground rays with
their first-hit depths, background rays, and a seeded small perturbation
of the measured pose about the object's center (`NOISE`: 0.1 m and 0.03
rad σ per axis, scale +5%), about what a 3D detector's box is off by.  The objects are not drawn into the
images: they exist as detections only.  numpy only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from dsp_slam_rgbd_tpu_torch.tools import ellipsoid

SCALE = 2.0
NOISE = (0.1, 0.03)   # σ of the measured pose's translation (m) and rotation (rad)


class Truth(NamedTuple):
    code: np.ndarray      # (64,) f32 latent of the ellipsoid family
    center: np.ndarray    # (3,) world center at frame 0
    yaw: float            # rotation about the up axis
    velocity: np.ndarray  # (3,) world metres per frame (0 for a static object)

    @property
    def dynamic(self) -> bool:
        return bool(np.any(self.velocity != 0.0))

    def center_at(self, frame: int) -> np.ndarray:
        return self.center + frame * self.velocity

    def t_wo(self, frame: int) -> np.ndarray:
        """(4, 4) Sim(3) object→world pose at `frame` (rotation block s·R)."""
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ np.diag([1.0, -1.0, -1.0])
        T = np.eye(4)
        T[:3, :3] = SCALE * R
        T[:3, 3] = self.center_at(frame)
        return T


def make_objects(centers, velocities=None, seed: int = 0) -> list:
    """Truths at `centers` (n, 3) with seeded codes and yaws; `velocities`
    (n, 3) metres per frame, zero when omitted."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(centers, np.float64)
    vel = np.zeros_like(centers) if velocities is None else np.asarray(velocities, np.float64)
    return [Truth(rng.standard_normal(64).astype(np.float32), c, float(rng.uniform(-0.6, 0.6)), v)
            for c, v in zip(centers, vel)]


def kitti_objects(seed: int = 0) -> list:
    """The KITTI-size world's 8 objects (`bench.py`'s B=8): 7 static ones
    7-14 m ahead, spread along the 24-frame path (x 0 to 8 m), and one
    mover 4.5 m ahead at 0.4 m a frame along x, in a lane of its own
    (>= 2.5 m from every static object on the ground plane)."""
    statics = [[-1.5, 0.4, 7.0], [0.5, 0.4, 11.0], [2.5, 0.4, 8.5], [4.5, 0.4, 13.0],
               [6.5, 0.4, 7.5], [8.5, 0.4, 10.0], [10.5, 0.4, 12.5]]
    return make_objects(statics + [[0.0, 0.4, 4.5]],
                        [[0.0, 0.0, 0.0]] * 7 + [[0.4, 0.0, 0.0]], seed)


def small_objects(seed: int = 0) -> list:
    """The 224x160 world's 3 objects: 2 static ones 6.5 and 7.5 m ahead and
    a mover 4 m ahead at 0.4 m a frame along x."""
    return make_objects([[1.0, 0.0, 6.5], [-1.5, 0.0, 7.5], [-1.0, 0.3, 4.0]],
                        [[0.0, 0.0, 0.0]] * 2 + [[0.4, 0.0, 0.0]], seed)


def t_cw(world, frame: int) -> np.ndarray:
    """The true (4, 4) world→camera pose of `frame` in a plane world or a
    circuit (R = I, the camera at `world.center(frame)`)."""
    T = np.eye(4)
    T[:3, 3] -= world.center(frame)
    return T


def visible(world, T_cw: np.ndarray, truth: Truth, frame: int) -> bool:
    """The object's center projects into the image, in front of the camera."""
    c = T_cw[:3, :3] @ truth.center_at(frame) + T_cw[:3, 3]
    if c[2] <= 1.0:
        return False
    u = world.fx * c[0] / c[2] + world.cx
    v = world.fx * c[1] / c[2] + world.cy
    return 0.0 <= u < world.w and 0.0 <= v < world.h


def detections(T_cw: np.ndarray, objects, rng, n_pts: int, n_rays: int,
               frame: int = 0, world=None) -> list:
    """`make_detection` keyword inputs of every object at `frame` seen from
    a camera at T_cw (with `world`, only the objects in its image):
    [{"t_co_sim3", "pts", "rays", "depth", "n_fg", "truth"}], "truth" the
    object's index in `objects`."""
    out = []
    for i, obj in enumerate(objects):
        if world is not None and not visible(world, T_cw, obj, frame):
            continue
        T_co = np.asarray(T_cw, np.float64) @ obj.t_wo(frame)
        o = ellipsoid.observe(rng, ellipsoid.code_to_axes(obj.code), T_co, n_pts, n_rays,
                              sigma=NOISE, at_object=True)
        out.append({"t_co_sim3": o["T_init"], "pts": o["pts"], "rays": o["rays"],
                    "depth": o["depth"], "n_fg": int(o["fg_mask"].sum()), "truth": i})
    return out


def frame_detections(det_mod, world, truths, frame: int, n_pts: int, n_rays: int,
                     seed: int = 0):
    """The detections of `frame` as `det_mod` (either package's detections
    module) packs them, from the true camera pose with rng seed (seed,
    frame): both packages get the same numpy.  -> (detections, truth
    indices)."""
    raw = detections(t_cw(world, frame), truths, np.random.default_rng((seed, frame)), n_pts,
                     n_rays, frame=frame, world=world)
    return ([det_mod.make_detection(d["t_co_sim3"], pts=d["pts"], rays=d["rays"],
                                    depth=d["depth"], n_fg=d["n_fg"]) for d in raw],
            [d["truth"] for d in raw])


def _host(a) -> np.ndarray:
    """A tensor of either package (or an array) as a numpy array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def path_distances(truths, frame: int, center: np.ndarray) -> np.ndarray:
    """(n,) distance of `center` from each truth's path over frames
    0..frame (a static truth's path is its center)."""
    return np.array([min(np.linalg.norm(t.center_at(f) - center) for f in range(frame + 1))
                     for t in truths])


class ObjectLog:
    """Per keyframe, the map's objects against the truths: call it with
    (frame, state) after each keyframe stage; `summary()` then says how the
    run went.  A slot's identity is its nearest truth when it first appears
    valid, nearest by the distance from the truth's path so far: the map
    keeps a dynamic object's pose where it was created (BA leaves dynamic
    objects out), on the mover's path but behind it."""

    def __init__(self, truths):
        self.truths = truths
        self.identity = {}      # slot -> truth index at creation
        self.kept = True        # every slot kept its identity
        self.last = None

    def __call__(self, frame: int, state) -> None:
        valid = _host(state.obj_valid)
        centers = _host(state.obj_pose)[:, :3, 3]
        dist = {}
        for o in np.nonzero(valid)[0]:
            dist[int(o)] = d = path_distances(self.truths, frame, centers[o])
            if self.identity.setdefault(int(o), int(np.argmin(d))) != int(np.argmin(d)):
                self.kept = False
        self.last = (frame, valid, dist, _host(state.obj_dynamic))

    def summary(self) -> dict:
        """{"valid", "identities_kept", "slots": [{slot, truth, center_err_m
        (from the truth's path), dynamic, truth_dynamic}]} at the last
        call."""
        frame, valid, dist, dyn = self.last
        slots = []
        for o in np.nonzero(valid)[0]:
            k = self.identity[int(o)]
            slots.append({"slot": int(o), "truth": k, "center_err_m": float(dist[int(o)][k]),
                          "dynamic": bool(dyn[o]), "truth_dynamic": self.truths[k].dynamic})
        truths = [s["truth"] for s in slots]
        return {"frame": frame, "valid": int(valid.sum()),
                "identities_kept": self.kept and len(set(truths)) == len(truths),
                "slots": slots}


# ---------------------------------------------------------------------------
# the mono object map of tests/test_mono_objects.py, with an ellipsoid of
# the fixture family in place of its analytic sphere
MONO_CAM = (200.0, 200.0, 112.0, 80.0)   # fx, fy, cx, cy
MONO_CENTER = np.array([0.5, 0.0, 6.0])
MONO_SCALE = 1.5
N_SURFACE, N_CLUTTER = 120, 40


def mono_world(seed: int = 3):
    """(points (N_SURFACE + N_CLUTTER, 3) f32 world, Truth): surface points
    of one static ellipsoid at MONO_CENTER (scale MONO_SCALE), then far
    background clutter."""
    rng = np.random.default_rng(seed)
    truth = Truth(rng.standard_normal(64).astype(np.float32), MONO_CENTER, 0.3, np.zeros(3))
    axes = ellipsoid.code_to_axes(truth.code)
    d = rng.standard_normal((N_SURFACE, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    T = truth.t_wo(0)
    surface = (T[:3, :3] / SCALE * MONO_SCALE @ (d * axes).T).T + T[:3, 3]
    clutter = rng.uniform(-4, 4, (N_CLUTTER, 3))
    clutter[:, 2] = rng.uniform(9.0, 14.0, N_CLUTTER)   # far background
    return np.concatenate([surface, clutter]).astype(np.float32), truth


def mono_fields(fields: dict, pts_w: np.ndarray) -> dict:
    """A map's {field: array} (from an empty map of either package, with
    max_feat >= len(pts_w)) with the points in slots 0..N-1."""
    f = {k: np.array(v) for k, v in fields.items()}
    P = len(pts_w)
    f["pt_pos"][:P] = pts_w
    f["pt_valid"][:P] = True
    return f


def mono_keyframe(fields: dict, k: int, cam_x: float) -> dict:
    """`fields` with keyframe k inserted: a camera at world x = cam_x that
    observes every point slot 0..N-1 at its exact projection (feature j ↔
    point j), as tests/test_mono_objects.py's `_insert_kf` does."""
    f = {n: np.array(v) for n, v in fields.items()}
    P = N_SURFACE + N_CLUTTER
    fx, fy, cx, cy = MONO_CAM
    t_cw = np.eye(4, dtype=np.float32)
    t_cw[0, 3] = -cam_x
    pc = f["pt_pos"][:P] + t_cw[:3, 3]
    f["kf_pose"][k] = t_cw
    f["kf_valid"][k] = True
    f["kf_frame_id"][k] = k
    f["kf_xy"][k, :P] = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                                  fy * pc[:, 1] / pc[:, 2] + cy], -1).astype(np.float32)
    f["kf_feat_valid"][k, :P] = True
    f["kf_feat_pt"][k, :P] = np.arange(P)
    return f


def mono_detection_inputs(rng):
    """(keypoint indices inside the mask, background rays (64, 3) f32):
    the surface points' keypoints, and rays at the plane behind the object."""
    bg = rng.standard_normal((64, 3)).astype(np.float32) * 0.05
    bg[:, 2] = 1.0
    bg[:, 0] += MONO_CENTER[0] / MONO_CENTER[2]
    return np.arange(N_SURFACE), bg
