"""Operation and byte counts of the decoder work a fit batch needs.

Rows are counted from the shapes the fit runs at (configuration and
traffic), not read from the program: with per-ray chord sampling the
render term's value pass queries every sample of every ray it keeps
(`objects x rays x samples` rows an iteration: every ray in the coarse
iterations at `coarse_samples`, `ceil(rays x active_ray_fraction)` rays in
the fine ones at `num_depth_samples`), and the SDF term's Jacobian pass
queries every surface point.  The render term's Jacobian pass runs over
`max_grad_points` slots of which only the live ones are work; their count
depends on the data, so it is left out (an undercount) until the program
counts them.  A forward pass over one row costs 2 sum(in x out) over the
decoder's layers; the input Jacobian adds one backward sweep of the same
products.
"""
from __future__ import annotations

import math


def layer_dims(decoder: dict) -> list[tuple[int, int]]:
    """(in, out) of each linear layer of a DeepSDF decoder: the layer before
    a `latent_in` layer outputs hidden - (latent + 3), and the latent_in
    layer takes the raw input back in."""
    in_dim = int(decoder["latent_size"]) + 3
    dims = [in_dim] + [int(d) for d in decoder["dims"]] + [1]
    out = []
    for i in range(len(dims) - 1):
        o = dims[i + 1] - (in_dim if (i + 1) in decoder["latent_in"] else 0)
        out.append((dims[i], o))
    return out


def forward_flops_per_row(decoder: dict) -> int:
    return sum(2 * i * o for i, o in layer_dims(decoder))


def weight_count(decoder: dict) -> tuple[int, int]:
    """(weights, biases) of the decoder."""
    dims = layer_dims(decoder)
    return sum(i * o for i, o in dims), sum(o for _, o in dims)


def _phases(recon: dict, rays: int) -> list[tuple[int, int, int]]:
    """(iterations, rays, samples a ray) of each phase of a fit."""
    n_it = int(recon["num_iterations"])
    nc = min(int(recon["coarse_iterations"]), n_it) if int(recon["coarse_samples"]) > 0 else 0
    fine_rays = rays
    if nc > 0 and float(recon["active_ray_fraction"]) < 1.0:
        fine_rays = max(int(math.ceil(rays * float(recon["active_ray_fraction"]))), 1)
    return [(nc, rays, int(recon["coarse_samples"])),
            (n_it - nc, fine_rays, int(recon["num_depth_samples"]))]


def value_calls_and_rows(recon: dict, objects: int, rays: int) -> list[int]:
    """Rows of each value-pass call of one batch (one call an iteration),
    or None where the rows depend on the data (global-linspace sampling
    compacts the in-sphere samples)."""
    if not recon["chord_sampling"]:
        return None
    return [objects * r * m for n, r, m in _phases(recon, rays) for _ in range(n)]


def surface_jacobian_rows(recon: dict, objects: int, points: int) -> int:
    """Rows of the SDF term's Jacobian calls in one batch."""
    return int(recon["num_iterations"]) * objects * points


def render_jacobian_slots(recon: dict, objects: int) -> int:
    """Slots (live or padding) of the render term's Jacobian calls in one
    batch: the rows the kernel is launched over."""
    return int(recon["num_iterations"]) * objects * int(recon["max_grad_points"])


def value_pass_work(decoder: dict, recon: dict, objects: int, rays: int,
                    weight_bytes: int) -> tuple[float, float] | None:
    """(FLOPs, bytes) the value pass of one batch needs: each call reads its
    rows' xyz (3 float32) and the objects' codes once, writes one float32
    a row, and reads the weights (`weight_bytes` an element) and float32
    biases once."""
    rows = value_calls_and_rows(recon, objects, rays)
    if rows is None:
        return None
    f = forward_flops_per_row(decoder)
    w, b = weight_count(decoder)
    code = objects * int(decoder["latent_size"]) * 4
    byts = sum(n * 16 + code + w * weight_bytes + b * 4 for n in rows)
    return float(sum(rows) * f), float(byts)


def model_flops_per_batch(decoder: dict, recon: dict, objects: int, points: int,
                          rays: int) -> float | None:
    """The decoder FLOPs a batch needs whose rows the shapes fix: the value
    pass, and the SDF term's value + input Jacobian (2 forward's worth).
    The render term's Jacobian is left out (see the module docstring)."""
    rows = value_calls_and_rows(recon, objects, rays)
    if rows is None:
        return None
    f = forward_flops_per_row(decoder)
    return float(sum(rows) * f + surface_jacobian_rows(recon, objects, points) * 2 * f)
