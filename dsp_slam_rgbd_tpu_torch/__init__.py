"""dsp_slam_rgbd_tpu_torch — the object-SLAM framework in PyTorch and CUDA.

The port of `dsp_slam_rgbd_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  It mirrors the JAX package's module paths so each counterpart
is easy to find; the decoder's two fused TPU kernels are hand-written CUDA
for sm_90a under `csrc/`, built at first use (`ops/cuda/build.py`).

Layout (every module of the JAX package has its counterpart):
  ops/       Lie groups, robust norms, camera; ops/cuda: the fused decoder kernels
  models/    DeepSDF decoder (nn.Module) + mesh extraction
  recon/     object shape+pose Gauss-Newton optimizer (the FLOPs core)
  frontend/  ORB extraction, matching, stereo
  solvers/   pose GN, PnP, triangulation, two-view initialization, Sim(3)
  mapping/   map state, covisibility, keyframe point stage, BA, map objects,
             the essential-graph pose graph
  tracking/  the synchronous tracker
  loop/      BoW vocabulary and database, loop detection and correction
  system/    detections, label files, the object stage, the mono object
             pipeline, the keyframe MappingStage with loop closing, and
             slam.py's monocular map insertion and relocalization candidates
  parallel/  the scale-out tier: an (obj, ray) mesh over torch.distributed
             ranks, sharded reconstruction, local BA and PCG
  active/    next-best-view scoring and RRT path planning
  tools/     the command line, single-frame reconstruction and the
             synthetic worlds
  entry.py   the flagship reconstruction step with example inputs

Entry points take a `device` and default to "cuda"; without a card they
raise unless the caller passes device="cpu".  On CPU tensors every kernel
wrapper runs its plain PyTorch version.
"""

import torch as _torch

# Geometry / Gauss-Newton math is float32 and precision-critical (the JAX
# package forces "highest" matmul precision for the same reason).  TF32
# keeps ~3 decimal digits, so it is off for matmuls and convolutions; the
# decoder's bf16 mode is explicit and dtype-driven, unaffected by this.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
