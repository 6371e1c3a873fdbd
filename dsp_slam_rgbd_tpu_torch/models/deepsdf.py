"""DeepSDF decoder as a PyTorch module.

Counterpart of `dsp_slam_rgbd_tpu/models/deepsdf.py` (reference
`deep_sdf/deep_sdf_decoder.py:75-110`: an 8-layer MLP over [code, xyz]
with latent re-injection at `latent_in` and a final tanh).

Weights keep the JAX layout, W_i (in, out), so a layer is x @ W + b.
Weight norm is folded at load time (inference only).

Two ways to query the decoder:
  * `apply` / `sdf` / `sdf_and_input_jacobian`: the plain layer-by-layer
    sweep for any architecture (the counterpart of the JAX package's XLA
    path);
  * `query` / `query_with_jacobian`: what the reconstruction uses.  For
    the kernels' layouts (`mlp_sdf.LAYOUTS`: the cars/chairs_64 layout,
    latent 64, and DeepSDF's ShapeNet layout, latent 256, each 8x512 with
    latent_in (4,)) they go through the fused kernels of
    `ops/cuda/mlp_sdf.py` (on a CPU tensor, their plain versions); any
    other architecture takes the plain sweep.  A dispatch on architecture.

`AnalyticSdfDecoder` stands in for the MLP with a closed-form SDF (the
JAX package's `AnalyticSdfSpec`, `models/deepsdf.py:58,96`): the same
methods, its Jacobian from `torch.func`, no kernel.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from dsp_slam_rgbd_tpu_torch import device as device_mod
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf


class DecoderSpec(NamedTuple):
    latent_size: int = 64
    dims: tuple = (512,) * 8
    latent_in: tuple = (4,)
    use_tanh_out: bool = True  # reference always applies final `th` tanh

    @property
    def in_dim(self) -> int:
        return self.latent_size + 3

    def layer_dims(self) -> list[tuple[int, int]]:
        """(in, out) per linear layer (`deep_sdf_decoder.py:29-56`): at a
        latent_in layer the input is concat(x, input), so the preceding
        layer's out_dim shrinks by in_dim."""
        dims = [self.in_dim] + list(self.dims) + [1]
        out = []
        for layer in range(len(dims) - 1):
            out_dim = dims[layer + 1]
            if (layer + 1) in self.latent_in:
                out_dim -= self.in_dim
            out.append((dims[layer], out_dim))
        return out


def _rows(code: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Input rows [code | xyz] for a shared (L,) code, per-row codes of
    xyz's leading shape, or per-object (B, L) codes over xyz (B, N, 3)."""
    if code.dim() == xyz.dim() - 1 and code.dim() > 1:    # per object
        code = code[:, None, :]
    code = code.expand(xyz.shape[:-1] + (code.shape[-1],))
    return torch.cat([code, xyz], dim=-1)


class DeepSDFDecoder(nn.Module):
    """The DeepSDF MLP.  Buffers W{i} (in, out) and b{i} (out,).

    For the kernels' layouts (latent 64 or 256, 8x512, latent_in (4,)) the
    fused kernels' packed weights are built at construction and rebuilt on every `.to()`/`.cuda()`, in f32
    and as a bf16 copy (`packed`), with the kernels' weight streams beside
    them: in bf16 the forward's (`value_tiles`) and the Jacobian's backward
    sweep's (`backward_tiles`), which the Jacobian kernel reads both of
    (`jacobian_tiles`); in f32 `value_tiles_f32` and `backward_tiles_f32`.
    `tiles(compute_dtype, jacobian)` gives the ones a kernel takes.
    """

    def __init__(self, spec: DecoderSpec, layers):
        super().__init__()
        self.spec = spec
        dims = spec.layer_dims()
        if len(layers) != len(dims):
            raise ValueError(f"{len(layers)} layers for a spec of {len(dims)}")
        for i, ((W, b), shape) in enumerate(zip(layers, dims)):
            W = torch.as_tensor(W, dtype=torch.float32)
            b = torch.as_tensor(b, dtype=torch.float32)
            if tuple(W.shape) != shape or tuple(b.shape) != (shape[1],):
                raise ValueError(f"layer {i}: W {tuple(W.shape)}, b {tuple(b.shape)} "
                                 f"!= {shape}")
            self.register_buffer(f"W{i}", W.contiguous())
            self.register_buffer(f"b{i}", b.contiguous())
        self._packed: dict = {}
        self._pack()

    @property
    def layers(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        n = len(self.spec.layer_dims())
        return [(getattr(self, f"W{i}"), getattr(self, f"b{i}")) for i in range(n)]

    @property
    def device(self) -> torch.device:
        return self.W0.device

    @property
    def fused(self) -> bool:
        """True when `query`/`query_with_jacobian` take the fused kernels."""
        return mlp_sdf.compatible(self.spec)

    def _pack(self) -> None:
        self._packed = {}
        self.value_tiles = self.backward_tiles = None
        self.value_tiles_f32 = self.backward_tiles_f32 = None
        if self.fused:
            wb = mlp_sdf.pack_params(self.layers, self.spec)
            w0, W, b = self._packed[torch.bfloat16] = mlp_sdf.cast_packed(wb, torch.bfloat16)
            self._packed[torch.float32] = wb
            self.value_tiles = mlp_sdf.pack_value_tiles(w0, W)
            self.backward_tiles = mlp_sdf.pack_backward_tiles(w0, W)
            self.value_tiles_f32 = mlp_sdf.pack_value_tiles_f32(wb[0], wb[1])
            self.backward_tiles_f32 = mlp_sdf.pack_backward_tiles_f32(wb[0], wb[1])

    @property
    def jacobian_tiles(self):
        """(forward, backward) weight streams of the bf16 Jacobian kernel."""
        return self.value_tiles, self.backward_tiles

    def tiles(self, compute_dtype=torch.float32, jacobian=False):
        """The weight stream(s) the kernels read in compute_dtype: the
        forward stream for the value kernel, the (forward, backward) pair
        for the Jacobian kernel."""
        if compute_dtype == torch.bfloat16:
            return self.jacobian_tiles if jacobian else self.value_tiles
        return ((self.value_tiles_f32, self.backward_tiles_f32) if jacobian
                else self.value_tiles_f32)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._pack()
        return self

    def packed(self, compute_dtype=torch.float32):
        """Packed (w0, W, b) for the fused kernels, weights in compute_dtype."""
        if not self._packed:
            raise ValueError("the fused kernels do not take this decoder's "
                             f"architecture ({self.spec}); they take "
                             f"{mlp_sdf.LAYOUT_NAMES}")
        return self._packed[compute_dtype]

    # -- the plain sweep (any architecture) ---------------------------------

    def _forward_sweep(self, inputs, compute_dtype, keep_masks):
        rnd = mlp_sdf.rounder(compute_dtype)
        x = rnd(inputs.float())
        inp = x
        masks = []
        layers = self.layers
        for i, (W, b) in enumerate(layers):
            if i in self.spec.latent_in:
                x = torch.cat([x, inp], dim=-1)
            x = x @ rnd(W) + b
            if i < len(layers) - 1:
                if keep_masks:
                    masks.append(x > 0.0)
                x = torch.relu(x)
            x = rnd(x)
        return x[..., 0], masks

    def apply(self, inputs: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
        """Forward pass: inputs (…, latent+3) -> sdf (…,).

        Mirrors the JAX `apply`: in bf16 each layer's operands and output
        are rounded to bf16 with f32 accumulation, bias and ReLU.
        """
        x, _ = self._forward_sweep(inputs, compute_dtype, False)
        return torch.tanh(x) if self.spec.use_tanh_out else x

    forward = apply

    def sdf(self, code, xyz, compute_dtype=torch.float32) -> torch.Tensor:
        """SDF at xyz (…, 3) with a shared, per-row or per-object code."""
        return self.apply(_rows(code, xyz), compute_dtype)

    def sdf_and_input_jacobian(self, code, xyz, compute_dtype=torch.float32):
        """Value + per-row input Jacobian: (sdf (…,), d sdf/d[code, xyz]
        (…, latent+3)) from one forward and one reverse sweep (each output
        row depends only on its own input row)."""
        rnd = mlp_sdf.rounder(compute_dtype)
        inputs = _rows(code, xyz)
        pre, masks = self._forward_sweep(inputs, compute_dtype, True)
        val = torch.tanh(pre) if self.spec.use_tanh_out else pre
        g = (1.0 - val * val if self.spec.use_tanh_out else torch.ones_like(val))
        g = g[..., None]
        extra = torch.zeros_like(inputs, dtype=torch.float32)
        layers = self.layers
        for i in range(len(layers) - 1, -1, -1):
            if i < len(layers) - 1:
                g = g * masks[i]
            g = rnd(g) @ rnd(layers[i][0]).T
            if i in self.spec.latent_in:
                w = g.shape[-1] - self.spec.in_dim
                extra = extra + g[..., w:]
                g = g[..., :w]
        return val, g + extra

    # -- the route the reconstruction takes ---------------------------------

    def query(self, code, xyz, compute_dtype=torch.float32) -> torch.Tensor:
        """SDF values: the fused value kernel for the kernels' layouts
        (latent 64 or 256), the plain sweep otherwise."""
        if self.fused:
            return mlp_sdf.sdf_value_fused(self.packed(compute_dtype), code,
                                           xyz, compute_dtype, self.tiles(compute_dtype))
        return self.sdf(code, xyz, compute_dtype)

    def query_with_jacobian(self, code, xyz, compute_dtype=torch.float32):
        """(sdf, input Jacobian): the fused kernel for the kernels' layouts
        (latent 64 or 256), the plain sweep otherwise."""
        if self.fused:
            return mlp_sdf.sdf_and_input_jacobian_fused(
                self.packed(compute_dtype), code, xyz, compute_dtype,
                self.tiles(compute_dtype, jacobian=True))
        return self.sdf_and_input_jacobian(code, xyz, compute_dtype)


class AnalyticSdfSpec(NamedTuple):
    """An analytic decoder's spec: its code length and SDF callable."""
    latent_size: int
    fn: object


class AnalyticSdfDecoder(nn.Module):
    """A closed-form SDF in place of the MLP decoder: `fn(code, xyz)` maps
    codes (…, L) and points (…, 3) of one leading shape to SDF values (…),
    in torch ops that `torch.func.vmap` can batch.  The reconstruction,
    object, mono and renderer code call it as they call `DeepSDFDecoder`;
    it computes in f32 whatever the compute dtype, and no kernel route
    reaches it."""

    fused = False

    def __init__(self, fn, latent_size: int):
        super().__init__()
        self.spec = AnalyticSdfSpec(latent_size, fn)
        self.register_buffer("_anchor", torch.zeros(0))   # carries the device

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def _split(self, inputs):
        L = self.spec.latent_size
        return inputs[..., :L], inputs[..., L:]

    def apply(self, inputs: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """inputs (…, L+3) [code | xyz] -> sdf (…,)."""
        return self.spec.fn(*self._split(inputs.float()))

    forward = apply

    def sdf(self, code, xyz, compute_dtype=torch.float32) -> torch.Tensor:
        return self.apply(_rows(code, xyz), compute_dtype)

    def sdf_and_input_jacobian(self, code, xyz, compute_dtype=torch.float32):
        """(sdf (…,), d sdf/d[code, xyz] (…, L+3)): one gradient per row,
        vmapped over the rows (`torch.func`)."""
        inputs = _rows(code, xyz).float()
        flat = inputs.reshape(-1, inputs.shape[-1])
        grad, val = torch.func.vmap(torch.func.grad_and_value(
            lambda row: self.spec.fn(*self._split(row))))(flat)
        return val.reshape(inputs.shape[:-1]), grad.reshape(inputs.shape)

    query = sdf
    query_with_jacobian = sdf_and_input_jacobian


def init_decoder(spec: DecoderSpec = DecoderSpec(), seed: int = 0,
                 device="cuda") -> DeepSDFDecoder:
    """He-normal random weights, zero biases, from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    layers = []
    for in_dim, out_dim in spec.layer_dims():
        W = torch.randn(in_dim, out_dim, generator=gen) * np.sqrt(2.0 / in_dim)
        layers.append((W, torch.zeros(out_dim)))
    return DeepSDFDecoder(spec, layers).to(device_mod.resolve(device))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def load_torch_checkpoint(experiment_dir: str, checkpoint: str = "latest",
                          device="cuda") -> DeepSDFDecoder:
    """Load a reference-format DeepSDF experiment dir (`specs.json` +
    `ModelParameters/<checkpoint>.pth`, weight-normed `lin{i}` layers,
    optionally under a DataParallel `module.` prefix).  Weight norm is
    folded: W = g * v / ||v||_row."""
    with open(os.path.join(experiment_dir, "specs.json")) as f:
        specs = json.load(f)
    ns = specs["NetworkSpecs"]
    spec = DecoderSpec(
        latent_size=specs["CodeLength"],
        dims=tuple(ns["dims"]),
        latent_in=tuple(ns.get("latent_in", ())),
        use_tanh_out=True,
    )
    state = torch.load(
        os.path.join(experiment_dir, "ModelParameters", checkpoint + ".pth"),
        map_location="cpu", weights_only=False,
    )["model_state_dict"]
    state = {k.removeprefix("module."): v for k, v in state.items()}
    layers = []
    for i in range(len(spec.layer_dims())):
        pre = f"lin{i}."
        if pre + "weight_g" in state:
            g = state[pre + "weight_g"].float()  # (out, 1)
            v = state[pre + "weight_v"].float()  # (out, in)
            W = g * v / torch.linalg.norm(v, dim=1, keepdim=True)
        else:
            W = state[pre + "weight"].float()
        layers.append((W.T, state[pre + "bias"].float()))
    return DeepSDFDecoder(spec, layers).to(device_mod.resolve(device))


def save_npz(path: str, decoder: DeepSDFDecoder) -> None:
    """Native checkpoint format: flat npz of layer weights + spec."""
    flat = {}
    for i, (W, b) in enumerate(decoder.layers):
        flat[f"W{i}"] = W.detach().cpu().numpy()
        flat[f"b{i}"] = b.detach().cpu().numpy()
    spec = decoder.spec
    flat["latent_size"] = np.asarray(spec.latent_size)
    flat["dims"] = np.asarray(spec.dims)
    flat["latent_in"] = np.asarray(spec.latent_in)
    np.savez(path, **flat)


def load_npz(path: str, device="cuda") -> DeepSDFDecoder:
    """Read the npz format (weights may be stored fp16; computed in f32)."""
    with np.load(path) as z:
        spec = DecoderSpec(
            latent_size=int(z["latent_size"]),
            dims=tuple(int(d) for d in z["dims"]),
            latent_in=tuple(int(i) for i in z["latent_in"]),
        )
        layers = []
        i = 0
        while f"W{i}" in z:
            layers.append((z[f"W{i}"].astype(np.float32),
                           z[f"b{i}"].astype(np.float32)))
            i += 1
    return DeepSDFDecoder(spec, layers).to(device_mod.resolve(device))
