"""The global BA's conjugate-gradient loop and edge sums
(`csrc/schur_pcg.cu`) and their plain versions.

`solve` runs `steps` steps of block-Jacobi-preconditioned CG on the reduced
(pose + object) system of one GN step of `mapping/ba.py::_pcg_gn_step`,
matrix-free: S x = Hcc x - Hcp Hpp⁻¹ Hcpᵀ x + (object couplings) + damping,
with Hcp given edge by edge (`Edges`: one 6x3 block `Ccp` an edge, summed
by the problem's scatter plans `kf` and `pt`, with their `perm`, `offsets`
and kept rows; the object edges by `okf` and `oobj`).  It returns the
solution x (B, 6).  `point_sums` and `pose_sums` are the two sides' edge
sums alone, the GN step's products outside the loop.

It replaces no TPU kernel: the JAX package runs the loop as einsums and
segment sums, as `solve_plain` does.  On the card those ops were ~40
launches a CG step, each edge einsum a cuBLAS batched gemv of one tiny
matrix a batch entry; the kernels do a step in 3 launches, 1 + 3 S a solve,
all from one host call, summing in one fixed order (the source says which).

Routing, by the layout `edges` gives the blocks (no option):
  * CUDA tensors: laid out for the kernels (`Edges.path` "kernels"); the
    solve and the edge sums launch them, or raise; nothing falls back.
    With a `group` (`parallel/sharded_ba.py`: this rank's share of the
    edges) the host runs the loop, 1 + 4 launches a CG step, and
    all-reduces each matvec's point sums and then its pose side's edge and
    object sums between the launches;
  * CPU tensors: the plain versions, op by op with the port's fixed-order
    scatters (`ops/scatter.py`), all-reducing at the same two places with
    a `group`.  They run on whatever device their operands lie on, so the
    card's tests hold the kernels to them with `Edges(plans, Ccp)`.

The kernels take float32 only; the plain versions float32 or float64.
`check` raises on operands that are not one problem's on one device.
`LAUNCHES` counts the kernels' launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dsp_slam_rgbd_tpu_torch.ops import scatter
from dsp_slam_rgbd_tpu_torch.ops.cuda import build
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist

LAUNCHES = 0     # kernel launches since the last reset (the plain versions count none)
_fn: dict = {}   # the library's entry points, looked up at the first launch
# csrc/schur_pcg.cu's Operands after B and P, in order
FIELDS = ("ccp_pt", "kf_pt", "pt_off", "hpp_inv", "ccp_kf", "pt_kf", "kf_off", "hcc", "damp",
          "free", "ko", "okf_perm", "okf_off", "okf_idx", "oobj_perm", "oobj_off", "oobj_idx",
          "minv", "b", "x", "r", "z", "p", "ap", "v", "dot", "rz")
# csrc/schur_pcg.cu's Op: `schur_pcg_launch`'s kernel and mode
POINT_SUMS, POSE_SUMS, POINT_U, POINT_V, POSE_EDGES, UPDATE_INIT, UPDATE_FROM_SUMS = range(7)


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


class Edges(NamedTuple):
    """One GN step's edge blocks and the plans that sum them.  Laid out for
    the kernels, also each plan's order of the blocks and of the edges'
    other index, so that both sides stream them (the kept rows first)."""
    plans: object              # mapping/ba.py::BAPlans
    Ccp: torch.Tensor          # (N, 6, 3)
    ccp_pt: torch.Tensor | None = None   # (N, 6, 3) in point-plan order
    kf_pt: torch.Tensor | None = None    # (N,) int32 their pose blocks
    ccp_kf: torch.Tensor | None = None   # (N, 6, 3) in pose-plan order
    pt_kf: torch.Tensor | None = None    # (N,) int32 their points

    @property
    def path(self) -> str:
        """"kernels" where the blocks are laid out for the kernels, else "ops"."""
        return "ops" if self.ccp_pt is None else "kernels"


def edges(plans, Ccp: torch.Tensor) -> Edges:
    """The edge blocks `Ccp` (N, 6, 3) of the plans' edges: laid out for the
    kernels on a CUDA device, for the plain versions on the CPU."""
    if tuple(Ccp.shape[1:]) != (6, 3):
        raise ValueError(f"Ccp is {tuple(Ccp.shape)}; the edges want (N, 6, 3)")
    if Ccp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the CG solve takes CPU or CUDA tensors; got {Ccp.device}")
    if Ccp.device.type == "cpu":
        return Edges(plans, Ccp)
    if Ccp.dtype != torch.float32:
        raise ValueError(f"the CG kernels take float32; got {Ccp.dtype}")
    return Edges(plans, Ccp, Ccp.index_select(0, plans.pt.perm),
                 plans.kf.idx.index_select(0, plans.pt.perm).int(),
                 Ccp.index_select(0, plans.kf.perm),
                 plans.pt.idx.index_select(0, plans.kf.perm).int())


def check(e: Edges, Hcc, Hpp_inv, ko, damp_vec, free, Minv, b) -> None:
    """Raise unless the operands are one reduced system: B pose blocks, P
    points, N edges and M object edges of the plans, floats of one dtype,
    all on one CPU or CUDA device (CUDA where laid out for the kernels)."""
    plans, Ccp = e.plans, e.Ccp
    B, P = Hcc.shape[0], Hpp_inv.shape[0]
    N, M = Ccp.shape[0], ko.shape[0]
    want = {"Hcc": (Hcc, (B, 6, 6)), "Ccp": (Ccp, (N, 6, 3)), "Hpp_inv": (Hpp_inv, (P, 3, 3)),
            "ko": (ko, (M, 6, 6)), "damp_vec": (damp_vec, (B, 6)), "free": (free, (B,)),
            "Minv": (Minv, (B, 6, 6)), "b": (b, (B, 6))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}; the system wants {shape}")
    targets = {"kf": (plans.kf, B, N), "pt": (plans.pt, P, N), "okf": (plans.okf, B, M),
               "oobj": (plans.oobj, B, M)}
    for name, (p, n, rows) in targets.items():
        if p.n != n or p.idx.shape != (rows,):
            raise ValueError(f"plan {name} scatters {tuple(p.idx.shape)} rows onto {p.n} "
                             f"targets; the system has {rows} rows onto {n}")
    floats = [t for t, _ in want.values() if t is not free]
    if Hcc.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != Hcc.dtype for t in floats) or free.dtype != torch.bool:
        raise ValueError(f"the CG solve takes float32 or float64 operands of one dtype and a "
                         f"bool free mask; got {[t.dtype for t in floats]}, {free.dtype}")
    devices = {t.device for t, _ in want.values()} \
        | {t.device for p, _, _ in targets.values() for t in (p.idx, p.perm, p.offsets)} \
        | {t.device for t in e[2:] if t is not None}
    if len(devices) != 1:
        raise ValueError(f"the CG solve's operands lie on several devices: "
                         f"{sorted(map(str, devices))}")
    device, = devices
    if device.type not in ("cpu", "cuda") or (e.path == "kernels" and device.type != "cuda"):
        raise ValueError(f"the CG solve takes CPU or CUDA tensors, the kernels' layout CUDA "
                         f"tensors; got the {e.path} layout on {device}")


def solve(e: Edges, Hcc, Hpp_inv, ko, damp_vec, free, Minv, b, steps: int, group=None):
    """x (B, 6) after `steps` CG steps on S x = b from x = 0 (b zero where
    not `free`); the kernels or `solve_plain` by the edges' layout."""
    check(e, Hcc, Hpp_inv, ko, damp_vec, free, Minv, b)
    if e.path == "ops":
        return solve_plain(e, Hcc, Hpp_inv, ko, damp_vec, free, Minv, b, steps, group)
    B = Hcc.shape[0]
    f32 = dict(dtype=torch.float32, device=b.device)
    state = torch.empty((5, B, 6), **f32)     # x, r, z, p, Ap
    plans = e.plans
    fields = dict(hpp_inv=Hpp_inv, hcc=Hcc, damp=damp_vec, free=free, ko=ko, minv=Minv, b=b,
                  okf_perm=plans.okf.perm, okf_off=plans.okf.offsets, okf_idx=plans.okf.idx,
                  oobj_perm=plans.oobj.perm, oobj_off=plans.oobj.offsets,
                  oobj_idx=plans.oobj.idx, x=state[0], r=state[1], z=state[2], p=state[3],
                  ap=state[4], v=torch.empty((Hpp_inv.shape[0], 3), **f32),
                  dot=torch.empty((B,), **f32), rz=torch.empty((1,), **f32))
    if group is None:
        _launch("schur_pcg_solve", steps, 1 + 3 * steps, e, **fields)
        return state[0]
    # this rank's edges: each side's sums over the ranks between launches
    _launch("schur_pcg_launch", UPDATE_INIT, 1, e, **fields)
    for _ in range(steps):
        _launch("schur_pcg_launch", POINT_U, 1, e, **fields)
        fields["v"], = dist.psum([fields["v"]], group)
        _launch("schur_pcg_launch", POINT_V, 1, e, **fields)
        fields["ap"] = state[4]
        _launch("schur_pcg_launch", POSE_EDGES, 1, e, **fields)
        fields["ap"], = dist.psum([fields["ap"]], group)
        _launch("schur_pcg_launch", UPDATE_FROM_SUMS, 1, e, **fields)
    return state[0]


def point_sums(e: Edges, x: torch.Tensor) -> torch.Tensor:
    """(P, 3): for every point, the sum over its kept edges of Ccp_nᵀ x[kf_n]
    (x (B, 6)), in point-plan order from +0.0."""
    plans = e.plans
    P = plans.pt.n
    _check_vector(e, x, (plans.kf.n, 6))
    if e.path == "ops":
        return scatter.scatter_add(P, plans.pt, torch.einsum("nij,ni->nj", e.Ccp, x[plans.kf.idx]))
    out = torch.empty((P, 3), dtype=x.dtype, device=x.device)
    _launch("schur_pcg_launch", POINT_SUMS, 1, e, p=x, v=out)
    return out


def pose_sums(e: Edges, v: torch.Tensor) -> torch.Tensor:
    """(B, 6): for every pose block, the sum over its kept edges of
    Ccp_n v[pt_n] (v (P, 3)): in plan order from +0.0, or (the kernel) a
    fixed tree of the edges in plan order."""
    plans = e.plans
    B = plans.kf.n
    _check_vector(e, v, (plans.pt.n, 3))
    if e.path == "ops":
        return scatter.scatter_add(B, plans.kf, torch.einsum("nij,nj->ni", e.Ccp, v[plans.pt.idx]))
    out = torch.empty((B, 6), dtype=v.dtype, device=v.device)
    _launch("schur_pcg_launch", POSE_SUMS, 1, e, v=v, ap=out)
    return out


def _check_vector(e: Edges, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != shape or t.dtype != e.Ccp.dtype or t.device != e.Ccp.device:
        raise ValueError(f"the edge sums take a {shape} {e.Ccp.dtype} tensor on {e.Ccp.device}; "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def solve_plain(e: Edges, Hcc, Hpp_inv, ko, damp_vec, free, Minv, b, steps: int, group=None):
    """`solve` op by op on any device: gathers, einsums and fixed-order
    scatters, with `group`'s all_reduces of each matvec's point side and
    pose side."""
    def ps(*ts):
        return ts if group is None else dist.psum(ts, group)

    plans, Ccp = e.plans, e.Ccp
    B, P = Hcc.shape[0], Hpp_inv.shape[0]
    obs_kf, obs_pt, okf, oobj = plans.kf.idx, plans.pt.idx, plans.okf.idx, plans.oobj.idx

    def matvec(x):
        x = torch.where(free[:, None], x, 0.0)
        y = torch.einsum("bij,bj->bi", Hcc, x)
        u, = ps(scatter.scatter_add(P, plans.pt, torch.einsum("nij,ni->nj", Ccp, x[obs_kf])))
        v = torch.einsum("pij,pj->pi", Hpp_inv, u)
        y_edge, = ps(*scatter.scatter_adds(
            (B, (plans.kf, -torch.einsum("nij,nj->ni", Ccp, v[obs_pt])),
             (plans.okf, torch.einsum("mij,mj->mi", ko, x[oobj])),
             (plans.oobj, torch.einsum("mij,mi->mj", ko, x[okf])))))
        y = y + y_edge + damp_vec * x
        return torch.where(free[:, None], y, 0.0)

    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("bij,bj->bi", Minv, b)
    p = z
    rz = torch.sum(b * z)
    for _ in range(steps):
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("bij,bj->bi", Minv, r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, 1e-20)
        p = z + beta * p
        rz = rz_new
    return x


def _launch(entry: str, arg: int, launches: int, e: Edges, **fields) -> None:
    """One call of the library's `entry` with the edges' and `fields`'
    tensors in the table (0 for what it does not read), on the current
    stream; raise on a failed launch."""
    global LAUNCHES
    plans = e.plans
    fields.update(ccp_pt=e.ccp_pt, kf_pt=e.kf_pt, pt_off=plans.pt.offsets, ccp_kf=e.ccp_kf,
                  pt_kf=e.pt_kf, kf_off=plans.kf.offsets)
    tensors = {k: t.contiguous() for k, t in fields.items() if t is not None}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or devices.pop().type != "cuda":
        raise ValueError(f"the CG kernels' operands must lie on one card; got "
                         f"{sorted(str(t.device) for t in tensors.values())}")
    fn = _fn.get(entry)
    if fn is None:
        fn = _fn[entry] = getattr(build.load(), entry)
    B, P = plans.kf.n, plans.pt.n
    vals = [B, P] + [tensors[k].data_ptr() if k in tensors else 0 for k in FIELDS]
    dev = e.Ccp.get_device()
    err = fn((ctypes.c_int64 * len(vals))(*vals), len(vals), arg,
             torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        msg = build.load().mlp_sdf_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")
    LAUNCHES += launches
