"""Multi-process distribution over `torch.distributed`.

Counterpart of `dsp_slam_rgbd_tpu/parallel/distributed.py` (:26-87).  The
JAX package joins processes into one device collective and lets GSPMD
place the collectives; here one process drives one device (a card, or the
CPU in tests), and the sharded modules make their collectives
themselves through the helpers below.  The backend follows the device:
NCCL for "cuda", gloo for "cpu".

Usage (per process)::

    from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
    dist.initialize("tcp://localhost:29500", world_size=2, rank=RANK)
    mesh = dist.global_mesh("obj")      # or mesh_mod.make_mesh(n_obj, n_ray)
    # ... sharded_recon / sharded_ba over `mesh`

`psum`, `gather_rows` and `fetch` take `group=None` to mean "no process
group": a single process, where the collective is the identity.

Replicas.  The system runs the whole loop on every rank (the JAX
package's SPMD), so the ranks make the same collectives only while their
maps stay bit-identical.  The port's own path already gives the same bits
on every run (its scatter-adds sum in a fixed order, `ops/scatter.py`);
for more than one rank `initialize` also turns on
`torch.use_deterministic_algorithms` (`keep_replicas_identical`), which
guards every other op against a nondeterministic CUDA version, and the
mapping stage checks with `agree`, once or twice a keyframe, that the
ranks hold the same job and the same map, so a split raises at once
instead of hanging in a collective.
"""
from __future__ import annotations

import datetime
import os
import zlib

import numpy as np
import torch
import torch.distributed as tdist

from dsp_slam_rgbd_tpu_torch import device as device_mod

DEFAULT_TIMEOUT_S = 600.0
AGREE_LEN = 16   # numbers per rank in an `agree` check


def initialize(init_method: str, world_size: int, rank: int, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group (once per process) and return this
    rank's device.  `init_method`: "tcp://host:port" or "file:///path".
    On "cuda" the rank takes card `rank % device_count` and the group runs
    on NCCL; on "cpu" it runs on gloo.  A rank that waits longer than
    `timeout_s` in a collective fails instead of hanging."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if world_size > 1:
            keep_replicas_identical()
    if not tdist.is_initialized():
        tdist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def keep_replicas_identical() -> None:
    """Make every op on the card take its deterministic version, so that
    ranks fed the same inputs keep the same map even where a path reaches
    an op the port does not route itself: PyTorch's sorted `index_add_`
    and `index_put_(accumulate=True)` (several launches a call; the port's
    own scatter-adds go through `ops/scatter.py` and repeat without this),
    a fixed cuBLAS workspace, and `torch.empty` filled with NaN.  An op
    with no deterministic version raises.  Process-global: the mapping
    worker's thread shares it.  Call before the first cuBLAS call
    (`initialize` does)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


def agree(what: str, values, fingerprint: torch.Tensor | None = None) -> None:
    """Raise on every rank of the default group when the ranks disagree on
    the check's name `what`, on `values` (ints) or on the bits of
    `fingerprint` (floats on this rank's device, e.g. sums of the map).
    Every rank must call it at the same point.  One all_gather of
    AGREE_LEN numbers and one host read; nothing without a group."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if tdist.get_backend() == "nccl" else torch.device("cpu")
    row = torch.zeros(AGREE_LEN, dtype=torch.float64, device=dev)
    head = [float(zlib.crc32(what.encode()))] + [float(v) for v in values]
    row[:len(head)] = torch.tensor(head, dtype=torch.float64)
    if fingerprint is not None:
        row[len(head):len(head) + fingerprint.numel()] = fingerprint.reshape(-1)
    rows = _all_gather_flat(row[None], tdist.group.WORLD).view(torch.int64).cpu()
    if not bool((rows == rows[:1]).all()):
        raise RuntimeError(
            f"ranks disagree at {what}: the replicated maps split (one row per rank: "
            f"{rows.view(torch.float64).numpy().tolist()})")


def world() -> tuple[int, int]:
    """(world size, rank): (1, 0) without a process group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def group_size(group) -> int:
    return 1 if group is None else tdist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else tdist.get_rank(group)


def psum(tensors, group):
    """Sum each tensor over the group with ONE all_reduce (the tensors are
    packed into one f32 buffer).  Returns new tensors; without a group,
    the inputs themselves."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    tdist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _all_gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """(g·n, …) from every rank's (n, …), in group-rank order."""
    out = x.new_empty((group_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    tdist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's equal-shaped `x` along `dim`, in group-rank
    order (`all_gather_into_tensor`).  Bool tensors travel as uint8."""
    if group is None:
        return x
    dim = dim % x.dim()
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    # gathered along the first axis, every rank's rows in turn: the
    # concatenation along that axis
    out = _all_gather_flat(src.movedim(dim, 0), group).movedim(0, dim)
    return out.bool() if x.dtype == torch.bool else out


def shard_range(n: int, group) -> tuple[int, int, int]:
    """(start, stop, padded n) of this rank's contiguous share of n rows,
    n padded up to a multiple of the group size."""
    g = group_size(group)
    per = -(-n // g)
    r = group_rank(group)
    return r * per, (r + 1) * per, per * g


def pad_rows(x: torch.Tensor, n: int, dim: int = 0, fill=0) -> torch.Tensor:
    """`x` padded with `fill` along `dim` up to n rows."""
    extra = n - x.shape[dim]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim)


# -- the JAX package's helpers --------------------------------------------

def global_mesh(axis: str = "obj"):
    """A 1-D mesh over every rank of the default group, along `axis`."""
    from dsp_slam_rgbd_tpu_torch.parallel import mesh as mesh_mod

    n, _ = world()
    return mesh_mod.make_mesh(n, 1) if axis == "obj" else mesh_mod.make_mesh(1, n)


def shard_global(x, group, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous share of a host array that every rank holds
    (rows padded with zeros to a multiple of the group size)."""
    t = torch.as_tensor(np.asarray(x))
    start, stop, n = shard_range(t.shape[dim], group)
    return pad_rows(t, n, dim).narrow(dim, start, stop - start)


def replicate(x: torch.Tensor, group=None, src: int = 0) -> torch.Tensor:
    """Every rank gets rank `src`'s tensor (`broadcast`, in place)."""
    if group is not None or (tdist.is_available() and tdist.is_initialized()):
        tdist.broadcast(x, src=src, group=group)
    return x


def fetch(x: torch.Tensor, group=None, n: int | None = None) -> np.ndarray:
    """Every rank's shard gathered along the first axis to every rank (the
    padding past `n` rows dropped), as numpy."""
    out = gather_rows(x, group, 0)
    return out[: n if n is not None else out.shape[0]].cpu().numpy()
