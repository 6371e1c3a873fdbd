"""Write the synthetic plane worlds as sequence directories on disk.

The three layouts `system/sequence.get_sequence` reads, with the port's
PNG codec (numpy and zlib only):

  * `write_kitti`: image_2/ and image_3/ uint8 stereo pairs, calib.txt
    (KITTI odometry 00-02's P0-P3 and Tr), gt.txt (KITTI rows of the true
    camera-to-world poses) and, given objects, one label npz a frame
    (`object_world.frame_detections`);
  * `write_rgbd`: rgb/ uint8 images and depth/ 16-bit millimetre PNGs;
  * `write_mono`: a directory of uint8 images;

and `write_yaml`, the reference-style camera yaml of a world;
`write_kitti_objects` and `write_kitti_circuit` write whole directories.
As a script it writes the directory of `chip_smoke.py` phase 12a (or,
with `--circuit`, phase 16's KITTI-size loop circuit), so that the JAX
package can run the same files (`tests/tracking_driver.py cli DIR`,
`circuit DIR`):

    python -m dsp_slam_rgbd_tpu_torch.tools.sequence_dirs DIR [--circuit]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dsp_slam_rgbd_tpu_torch.system import png
from dsp_slam_rgbd_tpu_torch.system.sequence import save_label_file
from dsp_slam_rgbd_tpu_torch.tools import plane_world as pw

KITTI_CALIB = """\
P0: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 0.000000000000e+00 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 0.000000000000e+00
P1: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 -3.861448000000e+02 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 0.000000000000e+00
P2: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 4.538225000000e+01 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 -1.130887000000e-01 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 3.779761000000e-03
P3: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 -3.372877000000e+02 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 2.369057000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 4.915215000000e-03
Tr: 4.276802385584e-04 -9.999672484946e-01 -8.084491683471e-03 -1.198459927713e-02 -7.210626507497e-03 8.081198471645e-03 -9.999413164504e-01 -5.403984729748e-02 9.999738645903e-01 4.859485810390e-04 -7.206933692422e-03 -2.921968648686e-01
"""

# chip_smoke.py phase 12a: phase 10's world, objects and detection sizes
KITTI_OBJECTS_FRAMES, KITTI_OBJECTS_PTS, KITTI_OBJECTS_RAYS = 24, 256, 512


def _name(i: int) -> str:
    return f"{i:06d}.png"


def write_gt(path: str, world: pw.World, n: int) -> None:
    """KITTI rows of the true T_wc: frame i at (gt_x(i), 0, 0), no rotation."""
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"1 0 0 {pw.gt_x(world, i):.9e} 0 1 0 0 0 0 1 0\n")


def write_kitti(root: str, world: pw.World, texture, n: int, truths=None,
                n_pts: int = 256, n_rays: int = 512, seed: int = 0,
                labels_dir: str | None = None) -> None:
    """A KITTI-layout stereo sequence of `world` (and label files in
    `labels_dir` when `truths` are given)."""
    from dsp_slam_rgbd_tpu_torch.system import detections as det_mod
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow

    for sub in ("image_2", "image_3"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    if truths is not None:
        os.makedirs(labels_dir, exist_ok=True)
    for i in range(n):
        x = pw.gt_x(world, i)
        png.write_png(os.path.join(root, "image_2", _name(i)), pw.render_u8(world, texture, x))
        png.write_png(os.path.join(root, "image_3", _name(i)),
                      pw.render_u8(world, texture, x + world.baseline))
        if truths is not None:
            dets, _ = ow.frame_detections(det_mod, world, truths, i, n_pts, n_rays, seed)
            save_label_file(os.path.join(labels_dir, f"{i:06d}.npz"), dets)
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(KITTI_CALIB)
    write_gt(os.path.join(root, "gt.txt"), world, n)


def write_rgbd(root: str, world: pw.World, texture, n: int) -> None:
    """rgb/ uint8 images and depth/ uint16 millimetre depth PNGs (the
    RGB-D loader's default scale, 1/1000)."""
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        x = pw.gt_x(world, i)
        png.write_png(os.path.join(root, "rgb", _name(i)), pw.render_u8(world, texture, x))
        png.write_png(os.path.join(root, "depth", _name(i)),
                      (pw.depth_map(world, x) * 1000.0).astype(np.uint16))
    write_gt(os.path.join(root, "gt.txt"), world, n)


def write_mono(root: str, world: pw.World, texture, n: int) -> None:
    """A directory of uint8 images (the mono loader's layout)."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        png.write_png(os.path.join(root, _name(i)),
                      pw.render_u8(world, texture, pw.gt_x(world, i)))


def write_yaml(path: str, world: pw.World, fps: float = 10.0, th_depth: float = 35.0,
               n_features: int = 2000, n_levels: int = 8) -> None:
    """A reference-style camera yaml for `world`, a `plane_world.World` or a
    `loop_world.Circuit` (`config.from_reference_yaml_json` in either
    package; max_frames_between_kf becomes int(fps))."""
    with open(path, "w") as f:
        f.write(f"Camera.fx: {world.fx}\nCamera.fy: {world.fx}\nCamera.cx: {world.cx}\n"
                f"Camera.cy: {world.cy}\nCamera.bf: {world.fx * world.baseline}\n"
                f"Camera.fps: {fps:.1f}\nThDepth: {th_depth:.1f}\n"
                f"ORBextractor.nFeatures: {n_features}\nORBextractor.nLevels: {n_levels}\n"
                "ORBextractor.scaleFactor: 1.2\nORBextractor.iniThFAST: 20\n"
                "ORBextractor.minThFAST: 7\n")


def write_kitti_objects(root: str) -> dict:
    """chip_smoke.py phase 12a's directory: 24 KITTI-size stereo frames of
    `plane_world.KITTI`, the 8 objects of `object_world.kitti_objects`
    (256 points and 512 rays a detection), and a yaml of phase 10's
    tracking configuration: `OrbConfig()`'s 2,000 features in 8 levels,
    ThDepth 35, and Camera.fps 5, which the yaml readers turn into phase
    10's 5 frames at most between keyframes (the timestamps, i / fps, steer
    nothing).  -> the paths."""
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow

    world = pw.KITTI
    paths = {"seq": os.path.join(root, "seq"), "labels": os.path.join(root, "labels"),
             "yaml": os.path.join(root, "cam.yaml")}
    write_kitti(paths["seq"], world, pw.make_texture(world), KITTI_OBJECTS_FRAMES,
                truths=ow.kitti_objects(), n_pts=KITTI_OBJECTS_PTS,
                n_rays=KITTI_OBJECTS_RAYS, labels_dir=paths["labels"])
    write_yaml(paths["yaml"], world, fps=5.0)
    paths["gt"] = os.path.join(paths["seq"], "gt.txt")
    return paths


def write_kitti_circuit(root: str, n_frames: int | None = None) -> dict:
    """chip_smoke.py phase 16's directory: `loop_world.KITTI`'s circuit
    (105 1241x376 stereo frames) as image_2/ and image_3/, calib.txt,
    gt.txt (the true T_wc rows, R = I), one label npz a frame of the six
    static objects of `loop_world.kitti_objects` (256 points and 512 rays
    a detection), and a yaml of `OrbConfig()`'s 2,000 features in 8
    levels, ThDepth 35, Camera.fps 10 (KITTI's); `n_frames` cuts the
    circuit to its first frames.  Up to 8 threads render the images
    (numpy releases the interpreter lock).  -> the paths."""
    from concurrent.futures import ThreadPoolExecutor

    from dsp_slam_rgbd_tpu_torch.system import detections as det_mod
    from dsp_slam_rgbd_tpu_torch.tools import loop_world as lw
    from dsp_slam_rgbd_tpu_torch.tools import object_world as ow

    c = lw.KITTI
    paths = {"seq": os.path.join(root, "seq"), "labels": os.path.join(root, "labels"),
             "yaml": os.path.join(root, "cam.yaml")}
    paths["gt"] = os.path.join(paths["seq"], "gt.txt")
    for d in (paths["labels"], os.path.join(paths["seq"], "image_2"),
              os.path.join(paths["seq"], "image_3")):
        os.makedirs(d, exist_ok=True)
    texture, truths = lw.circuit_texture(c), lw.kitti_objects()
    xys = c.path()[:n_frames]

    def write_frame(i):
        for sub, img in zip(("image_2", "image_3"), lw.stereo_pair(c, texture, i)):
            png.write_png(os.path.join(paths["seq"], sub, _name(i)),
                          np.clip(img, 0, 255).astype(np.uint8))

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(write_frame, range(len(xys))))
    for i in range(len(xys)):
        dets, _ = ow.frame_detections(det_mod, c, truths, i, KITTI_OBJECTS_PTS,
                                      KITTI_OBJECTS_RAYS)
        save_label_file(os.path.join(paths["labels"], f"{i:06d}.npz"), dets)
    with open(os.path.join(paths["seq"], "calib.txt"), "w") as f:
        f.write(KITTI_CALIB)
    with open(paths["gt"], "w") as f:
        for x, y in xys:
            f.write(f"1 0 0 {x:.9e} 0 1 0 {y:.9e} 0 0 1 0\n")
    write_yaml(paths["yaml"], c, fps=10.0)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="directory to write chip_smoke.py phase 12a's files into")
    ap.add_argument("--circuit", action="store_true",
                    help="write phase 16's KITTI-size loop circuit instead")
    args = ap.parse_args(argv)
    paths = write_kitti_circuit(args.root) if args.circuit \
        else write_kitti_objects(args.root)
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
