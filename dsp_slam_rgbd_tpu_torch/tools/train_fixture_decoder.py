"""Train a DeepSDF decoder (8×512, latent re-injected at layer 4) on an
analytic shape family, as a deterministic test and bench fixture.

Counterpart of `tools/train_fixture_decoder.py`, which trains the
cars_64 layout only.  The reference ships trained DeepSDF weights
(`deep_sdf/workspace.py`); none exist here, and fits on random weights
diverge chaotically.  This trains the full decoder at a latent size of 64
(DSP-SLAM's cars, `ellipsoid_decoder_64.npz`) or 256 (DeepSDF's published
ShapeNet setting, `ellipsoid_decoder_256.npz`) to represent ellipsoids
whose axes come from the first three code dims:

    axes a_i = 0.30 + 0.12 * tanh(c_i),  i = 0..2      (c ~ N(0, 1))
    sdf(p; a) ~= k0 * (k0 - 1) / k1      (k0 = |p / a|, k1 = |p / a^2|)

With `--code-ramp` each code's dims past the first three are scaled by a
factor drawn per code in [0, 1), so that the decoder also learns codes
near 0 there: a fit starts from the zero code, and its prior holds it
near there.  Trained at 256 without it, the decoder reads a constant
~0.096 at every code whose other dims are small, the fits' codes.  The
64 fixture was trained without it.  Training uses
the clamped L1 loss of DeepSDF (±0.1) and Adam (lr 5e-4, betas
(0.9, 0.999), eps 1e-8 outside the square root, as optax's).  The forward
is the plain layer-by-layer sweep under autograd on leaf weight tensors
(no decoder kernel has a weight gradient), in f32 without TF32.  Each step
draws its codes and points from a CPU `torch.Generator` seeded by `--seed`
(JAX's PRNG streams cannot be reproduced).  The trained decoder is written
once at the end, in `deepsdf.save_npz`'s layout with the weights in f16.

Usage:
  python -m dsp_slam_rgbd_tpu_torch.tools.train_fixture_decoder \
      [--steps 4000] [--latent-size 64|256] [--code-ramp] \
      [--out tests/fixtures/ellipsoid_decoder_<latent>.npz] \
      [--dims 512 ... --latent-in 4] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE

CLAMP = 0.1


def fixture_path(latent: int) -> str:
    """The fixture of a latent size: `ellipsoid_decoder_<latent>.npz`."""
    return os.path.join(os.path.dirname(FIXTURE), f"ellipsoid_decoder_{latent}.npz")


def ellipsoid_sdf(p: torch.Tensor, axes: torch.Tensor) -> torch.Tensor:
    """Approximate SDF of an axis-aligned ellipsoid with semi-axes `axes`."""
    k0 = torch.linalg.vector_norm(p / axes, dim=-1)
    k1 = torch.linalg.vector_norm(p / (axes * axes), dim=-1)
    return k0 * (k0 - 1.0) / torch.clamp_min(k1, 1e-9)


def code_to_axes(code: torch.Tensor) -> torch.Tensor:
    return 0.30 + 0.12 * torch.tanh(code[..., :3])


def init_layers(spec, seed: int = 0, device="cpu") -> list:
    """He-normal weights (as `deepsdf.init_decoder`) with the last layer's
    scaled by 0.01, so the net starts near sdf = 0, inside the clamp band;
    leaf tensors that require gradients."""
    gen = torch.Generator().manual_seed(seed)
    dims = spec.layer_dims()
    layers = []
    for i, (in_dim, out_dim) in enumerate(dims):
        W = torch.randn(in_dim, out_dim, generator=gen) * np.sqrt(2.0 / in_dim)
        if i == len(dims) - 1:
            W = W * 0.01
        layers.append((W.to(device).requires_grad_(), torch.zeros(out_dim, device=device,
                                                                  requires_grad=True)))
    return layers


def forward(layers, spec, inputs: torch.Tensor) -> torch.Tensor:
    """The plain decoder sweep (`deepsdf.DeepSDFDecoder.apply` in f32)."""
    x = inputs
    for i, (W, b) in enumerate(layers):
        if i in spec.latent_in:
            x = torch.cat([x, inputs], dim=-1)
        x = x @ W + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return torch.tanh(x[..., 0]) if spec.use_tanh_out else x[..., 0]


def loss_fn(layers, spec, codes: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Mean |decoder − clamped ellipsoid SDF| over codes (B, L), pts (B, P, 3)."""
    target = torch.clamp(ellipsoid_sdf(pts, code_to_axes(codes)[:, None, :]), -CLAMP, CLAMP)
    B, P, _ = pts.shape
    inp = torch.cat([codes[:, None, :].expand(B, P, codes.shape[1]), pts], -1)
    pred = forward(layers, spec, inp.reshape(B * P, -1)).reshape(B, P)
    return torch.mean(torch.abs(pred - target))


def draw_batch(gen: torch.Generator, batch_codes: int, pts_per_code: int, latent: int,
               code_ramp: bool = False):
    """(codes (B, L), pts (B, P, 3)) on the CPU: half uniform volume
    samples in [-1.1, 1.1]³, half near the surface (unit directions scaled
    to the ellipsoid, with 8% radial noise).  code_ramp: each code's dims
    past the first three scaled by a factor drawn per code in [0, 1)."""
    codes = torch.randn(batch_codes, latent, generator=gen)
    if code_ramp:
        codes[:, 3:] *= torch.rand(batch_codes, 1, generator=gen)
    half = pts_per_code // 2
    pts_u = torch.rand(batch_codes, half, 3, generator=gen) * 2.2 - 1.1
    dirs = torch.randn(batch_codes, half, 3, generator=gen)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    noise = torch.randn(batch_codes, half, 1, generator=gen)
    pts_s = dirs * code_to_axes(codes)[:, None, :] * (1.0 + 0.08 * noise)
    return codes, torch.cat([pts_u, pts_s], 1)


def make_optimizer(layers, lr: float = 5e-4) -> torch.optim.Adam:
    return torch.optim.Adam([t for wb in layers for t in wb], lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def step(layers, spec, opt: torch.optim.Optimizer, codes, pts) -> torch.Tensor:
    """One Adam step on one batch; returns the loss before the update."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(layers, spec, codes, pts)
    loss.backward()
    opt.step()
    return loss.detach()


def save(path: str, layers, spec) -> None:
    """`deepsdf.save_npz`'s layout, W{i} in f16 and b{i} in f32."""
    flat = {"latent_size": np.asarray(spec.latent_size), "dims": np.asarray(spec.dims),
            "latent_in": np.asarray(spec.latent_in)}
    for i, (W, b) in enumerate(layers):
        flat[f"W{i}"] = W.detach().cpu().numpy().astype(np.float16)
        flat[f"b{i}"] = b.detach().cpu().numpy().astype(np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def main(argv=None) -> dict:
    from dsp_slam_rgbd_tpu_torch.models.deepsdf import DecoderSpec

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch-codes", type=int, default=32)
    ap.add_argument("--pts-per-code", type=int, default=512)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--latent-size", type=int, default=DecoderSpec().latent_size)
    ap.add_argument("--code-ramp", action="store_true",
                    help="scale each code's dims past the first three by a factor in [0, 1)")
    ap.add_argument("--dims", type=int, nargs="+", default=list(DecoderSpec().dims))
    ap.add_argument("--latent-in", type=int, nargs="*", default=list(DecoderSpec().latent_in))
    ap.add_argument("--out", default=None,
                    help="default: tests/fixtures/ellipsoid_decoder_<latent>.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dsp_slam_rgbd_tpu_torch import device as device_mod

    dev = device_mod.resolve(args.device)
    spec = DecoderSpec(latent_size=args.latent_size, dims=tuple(args.dims),
                       latent_in=tuple(args.latent_in))
    out = args.out or fixture_path(spec.latent_size)
    layers = init_layers(spec, args.seed, dev)
    opt = make_optimizer(layers, args.lr)
    gen = torch.Generator().manual_seed(args.seed + 1)
    losses = []
    for i in range(args.steps):
        codes, pts = draw_batch(gen, args.batch_codes, args.pts_per_code, spec.latent_size,
                                args.code_ramp)
        losses.append(step(layers, spec, opt, codes.to(dev), pts.to(dev)))
        if i % 500 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(losses[-1]):.5f}", flush=True)
    save(out, layers, spec)
    print("saved", os.path.abspath(out))
    return {"losses": torch.stack(losses).cpu().numpy(), "out": out}


if __name__ == "__main__":
    main()
