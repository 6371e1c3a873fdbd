"""The object fit's normal equations and their solve (`csrc/normal_solve.cu`)
and their plain version.

`solve` forms, for every object of a batch, the damped Gauss-Newton system
of one iteration of `recon/optimizer.py::_gn_iteration` and solves it.
Over the live rows of each term (J = [jac_pose | jac_code], r the robust
residuals, n the live count, at least 1):

    H = k2 J_sᵀJ_s / n_s + k1 J_rᵀJ_r / n_r
        + k3 I on the code block, + k4 drot drotᵀ + I on the pose block,
        + scale_damping at (6, 6)
    b = −k2 J_sᵀr_s / n_s − k1 J_rᵀr_r / n_r
        − k3 code on the code block, + k4 drot res_rot on the pose block

(reference optimizer.py:163-186: the Huber weight scales the residual in b
only; H uses the raw J).  It returns dx = H⁻¹ b (B, 7 + L), the solve's
info (B,) (0 where it succeeded) and the loss k1 Σr_r²/n_r + k2 Σr_s²/n_s
(B,), the squares over all rows.  With a `group` (the ranks split each
object's rows, `parallel/sharded_recon.py`) the sums JᵀJ, Jᵀr, Σr² and the
live counts are all-reduced before the normalization, so every rank solves
the same system.

Routing, by what the call can observe (no option, nothing falls back):
  * CUDA tensors whose system fits one block's shared memory (7 + L ≤
    `max_width()`, 321 unknowns): two kernels, `sums` (JᵀJ's lower
    triangle, Jᵀr, Σr² and the count of each term, read in place from the
    terms' tensors) and `solve` (H and b, the loss, Cholesky and the
    triangular solves), with the sums all-reduced between them where a
    group splits the rows; the sums split each object's live rows into
    parts when the batch is too small to fill the card.  The sums' layout,
    the parts and the widest system are the library's (`sizes`);
  * CPU tensors, and CUDA systems wider than that: `solve_plain`, op by op
    (the batched LU of `torch.linalg.solve_ex`; on the CPU one thread for
    two or more systems past `CPU_THREADED_SOLVE_MAX` unknowns).

`check` raises on operands that are not one batch's on one device, not
float32 (the masks bool), or without unit stride on their last axis.
`LAUNCHES` counts the kernels' launches: 2 a call.  `gaps` and `within`
hold the kernels to the op route and to the f64 solve (`f64_solve`) at
the tolerances `DX_TOL` and `LOSS_TOL`.
"""
from __future__ import annotations

import ctypes

import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import build
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
from dsp_slam_rgbd_tpu_torch.utils import timers

LAUNCHES = 0      # kernel launches since the last reset (the plain version counts none)
_fn: dict = {}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


def sizes(B: int, n: int) -> dict:
    """The library's sizes at B objects of n unknowns (`normal_solve_sizes`
    in `csrc/normal_solve.cu`): `stride`, the f32 values a (object, chunk,
    term) of the sums (the packed lower triangle of [J | r]ᵀ[J | r], the
    masked rows' Σr², the live count; a multiple of 4); `count_at`, the live
    count's place among them; `chunks`, the parts each object's live rows
    are split into; `max_width`, the widest system the solve holds."""
    fn = _fn.get("sizes")
    if fn is None:
        fn = _fn["sizes"] = build.load().normal_solve_sizes
    out = (ctypes.c_int64 * 4)()
    if fn(n, B, out) != 0:
        raise ValueError(f"no sizes for {B} objects of {n} unknowns")
    return dict(zip(("stride", "count_at", "chunks", "max_width"), out))


def max_width() -> int:
    """The widest system the kernels take (the solve's packed triangle and
    panel in one block's shared memory)."""
    if "max_width" not in _fn:
        _fn["max_width"] = sizes(0, 1)["max_width"]
    return _fn["max_width"]


def route(device: torch.device, n: int) -> str:
    """"kernels" for CUDA systems of n ≤ max_width() unknowns, else "ops"."""
    return "kernels" if device.type == "cuda" and n <= max_width() else "ops"


def check(code, sdf, ren, drot, res_rot) -> None:
    """Raise unless the operands are one batch of B objects with L code
    dims on one CPU or CUDA device: code (B, L), each term (jac_pose (B, R,
    7), jac_code (B, R, L), mask (B, R) bool, rr (B, R)), drot (B, 7),
    res_rot (B,); floats f32, every last axis of unit stride, drot and
    res_rot contiguous."""
    if code.dim() != 2:
        raise ValueError(f"code is {tuple(code.shape)}; the fit wants (B, L)")
    B, L = code.shape
    want = {"code": (code, (B, L)), "drot": (drot, (B, 7)), "res_rot": (res_rot, (B,))}
    for name, (jac_pose, jac_code, mask, rr) in (("sdf", sdf), ("render", ren)):
        R = jac_pose.shape[1] if jac_pose.dim() == 3 else -1
        want.update({f"{name}.jac_pose": (jac_pose, (B, R, 7)),
                     f"{name}.jac_code": (jac_code, (B, R, L)),
                     f"{name}.mask": (mask, (B, R)), f"{name}.rr": (rr, (B, R))})
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}; the system wants {shape}")
    for name, (t, _) in want.items():
        dtype = torch.bool if name.endswith(".mask") else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}; the normal equations take {dtype}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} has stride {t.stride()}; the last axis must be of "
                             f"unit stride")
    for name in ("drot", "res_rot"):
        if not want[name][0].is_contiguous():
            raise ValueError(f"{name} must be contiguous; it has stride {want[name][0].stride()}")
    devices = {t.device for t, _ in want.values()}
    if len(devices) != 1:
        raise ValueError(f"the normal equations' operands lie on several devices: "
                         f"{sorted(map(str, devices))}")
    device, = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the normal equations take CPU or CUDA tensors; got {device}")


def solve(cfg, code, sdf, ren, drot, res_rot, group=None, span=timers.OFF):
    """(dx (B, 7 + L), info (B,), loss (B,)) of the batch's damped systems
    (see the module docstring).  `cfg` gives k1, k2, k3, k4 and
    scale_damping (`recon.optimizer.ReconConfig`); `sdf` and `ren` are the
    terms' (jac_pose, jac_code, mask, rr); `span` (the iteration's) gets the
    render term's Jacobian slots and this rank's live rows."""
    check(code, sdf, ren, drot, res_rot)
    B, L = code.shape
    n = 7 + L
    if route(code.device, n) == "ops":
        return solve_plain(cfg, code, sdf, ren, drot, res_rot, group, span)
    sz = sizes(B, n)
    f32 = dict(dtype=torch.float32, device=code.device)
    sums = torch.empty((B, sz["chunks"], 2, sz["stride"]), **f32)
    span.set(jac_slots=ren[2].numel(), jac_live=sums[:, :, 1, sz["count_at"]])
    outs = dict(sums=sums, dx=torch.empty((B, n), **f32),
                info=torch.empty((B,), dtype=torch.int32, device=code.device),
                loss=torch.empty((B,), **f32))
    _launch(0, cfg, code, sdf, ren, drot, res_rot, sz, outs)
    if group is not None:   # this rank's rows: the sums over the ranks
        outs["sums"], = dist.psum([sums], group)
    _launch(1, cfg, code, sdf, ren, drot, res_rot, sz, outs)
    return outs["dx"], outs["info"], outs["loss"]


def solve_plain(cfg, code, sdf, ren, drot, res_rot, group=None, span=timers.OFF):
    """`solve` op by op on any device: per term the masked J (`where`), JᵀJ
    and Jᵀr as batched products, Σr² and the count, all-reduced over
    `group`, normalized, the damping, then `solve_batched`."""
    B, L = code.shape
    sums = []
    for jac_pose, jac_code, mask, rr in (sdf, ren):
        J = torch.where(mask[..., None], torch.cat([jac_pose, jac_code], -1), 0.0)
        sums += [J.transpose(1, 2) @ J,
                 (J.transpose(1, 2) @ torch.where(mask, rr, 0.0)[..., None])[..., 0],
                 torch.sum(rr * rr, dim=-1), mask.sum(-1)]
    span.set(jac_slots=ren[2].numel(), jac_live=sums[7])
    sums = dist.psum(sums, group)
    H = torch.zeros(B, 7 + L, 7 + L, device=code.device)
    b = torch.zeros(B, 7 + L, device=code.device)
    term_loss = []
    for k, (JtJ, Jtr, rsq, count) in zip((cfg.k2, cfg.k1), (sums[:4], sums[4:])):
        n = torch.clamp_min(count, 1).float()[:, None]
        H = H + k * JtJ / n[..., None]
        b = b - k * Jtr / n
        term_loss.append(rsq / torch.clamp_min(count, 1))
    sdf_loss, ren_loss = term_loss
    loss = cfg.k1 * ren_loss + cfg.k2 * sdf_loss
    eye_code = torch.eye(L, device=code.device)
    H[:, 7:, 7:] += cfg.k3 * eye_code
    b[:, 7:] -= cfg.k3 * code
    H[:, :7, :7] += cfg.k4 * drot[:, :, None] * drot[:, None, :]
    # the reference's J_rot is −dE/dω and its double negative
    # `b -= k4·(−Jᵀr)` (optimizer.py:179-181) gives b += k4·J·r, the descent
    # direction of the true gradient.  Kept as it is:
    b[:, :7] += cfg.k4 * drot * res_rot[:, None]
    H[:, :7, :7] += torch.eye(7, device=code.device)
    H[:, 6, 6] += cfg.scale_damping

    dx, info = solve_batched(H, b)
    return dx, info, loss


# the widest systems the CPU's batched LU is run on more than one thread for
CPU_THREADED_SOLVE_MAX = 128


def solve_batched(H, b):
    """`torch.linalg.solve_ex(H, b)`; on the CPU, two or more systems wider
    than `CPU_THREADED_SOLVE_MAX` are solved on one thread: PyTorch 2.13's
    CPU build (oneMKL 2024.2) fails in the threaded batched LU from ~150
    unknowns (SLASWP rejects its parameter 6, then the call hangs or
    returns invalid pivots), and the 263-wide systems of a latent-256
    decoder are past that."""
    if H.device.type != "cpu" or H.shape[0] < 2 or H.shape[-1] <= CPU_THREADED_SOLVE_MAX:
        return torch.linalg.solve_ex(H, b)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.linalg.solve_ex(H, b)
    finally:
        torch.set_num_threads(prev)


def _launch(op: int, cfg, code, sdf, ren, drot, res_rot, sz: dict, outs: dict) -> None:
    """One launch of the library's `normal_solve_launch` (op 0 the sums, 1
    the solve) on the current stream, at the `sizes` sz; raise on a failed
    launch."""
    global LAUNCHES
    fn = _fn.get("launch")
    if fn is None:
        fn = _fn["launch"] = build.load().normal_solve_launch
    B, L = code.shape
    raw = [B, L, sz["chunks"], sz["stride"]]
    for jac_pose, jac_code, mask, rr in (sdf, ren):
        raw += [jac_pose.data_ptr(), jac_pose.stride(0), jac_pose.stride(1),
                jac_code.data_ptr(), jac_code.stride(0), jac_code.stride(1),
                mask.data_ptr(), mask.stride(0), rr.data_ptr(), rr.stride(0), mask.shape[1]]
    raw += [code.data_ptr(), code.stride(0), drot.data_ptr(), res_rot.data_ptr(),
            outs["sums"].data_ptr(), outs["dx"].data_ptr(), outs["info"].data_ptr(),
            outs["loss"].data_ptr()]
    k = [cfg.k1, cfg.k2, cfg.k3, cfg.k4, cfg.scale_damping]
    err = fn((ctypes.c_int64 * len(raw))(*raw), len(raw), (ctypes.c_float * len(k))(*k), len(k),
             op, torch._C._cuda_getCurrentRawStream(code.get_device()))
    if err != 0:
        msg = build.load().mlp_sdf_error_string(err).decode()
        raise RuntimeError(f"normal_solve launch {op} failed: CUDA error {err} ({msg})")
    if B:
        LAUNCHES += 1


def flops(B: int, n: int, live_rows: int) -> float:
    """The operations the kernels need: 2 (n + 1)(n + 2) / 2 a live row for
    the sums ([J | r]'s triangle), n³/3 + 2n² an object for the
    factorisation and the two solves."""
    return 2.0 * live_rows * (n + 1) * (n + 2) / 2 + B * (n ** 3 / 3.0 + 2.0 * n * n)


def io_bytes(B: int, n: int, live_rows: int, slots: int) -> float:
    """The bytes the kernels need: the live rows of [J | r] once, every
    slot's mask byte, code and drot, dx, info and loss."""
    return 4.0 * live_rows * (n + 1) + slots + 4.0 * B * (n - 7 + 8 + 1) + 4.0 * B * (n + 2)


# ---------------------------------------------------------------------------
# holding the kernels to the op route
#
# The fits' systems are ill conditioned (cond(H) ~1e7: the k4 pose block
# against the code block; f32 eps 6e-8), so every f32 route sits a visible
# way from the f64 solve.  On the fits' own systems (2 seeds x 10 GN
# iterations x both bf16 cells, H100) the first iteration is the worst:
# forming H in f32 alone moves dx by up to 4.5e-3 of an object's largest
# |dx|, the op route's f32 LU reads up to 3.3e-3, cuSOLVER's f32 Cholesky
# of the op route's H 7.0e-3, the kernels 8.7e-3.  So both routes' dx are
# held within DX_TOL of the f64 solve of the same operands, and of each
# other; the loss (f32 sums of squares in another order) within LOSS_TOL,
# relative.
DX_TOL, LOSS_TOL = 2e-2, 1e-5


def f64_solve(cfg, code, sdf, ren, drot, res_rot):
    """The op route in float64 on the operands' device (the CPU's threaded
    batched LU hangs past ~150 unknowns): (dx, loss, per term (JᵀJ, Jᵀr,
    Σr², max(count, 1))), on the CPU."""
    d = lambda ts: tuple(t.double() if t.is_floating_point() else t for t in ts)  # noqa: E731
    code, drot, res_rot = (t.double() for t in (code, drot, res_rot))
    B, L = code.shape
    f64 = dict(dtype=torch.float64, device=code.device)
    sums = []
    for jac_pose, jac_code, mask, rr in (d(sdf), d(ren)):
        J = torch.where(mask[..., None], torch.cat([jac_pose, jac_code], -1), 0.0)
        sums.append((J.transpose(1, 2) @ J, (J.transpose(1, 2) @ rr[..., None])[..., 0],
                     torch.sum(rr * rr, -1), torch.clamp_min(mask.sum(-1), 1).double()))
    H = torch.zeros(B, 7 + L, 7 + L, **f64)
    b = torch.zeros(B, 7 + L, **f64)
    loss = torch.zeros(B, **f64)
    for k, (JtJ, Jtr, rsq, n) in zip((cfg.k2, cfg.k1), sums):
        H += k * JtJ / n[:, None, None]
        b -= k * Jtr / n[:, None]
        loss += k * rsq / n
    H[:, 7:, 7:] += cfg.k3 * torch.eye(L, **f64)
    b[:, 7:] -= cfg.k3 * code
    H[:, :7, :7] += cfg.k4 * drot[:, :, None] * drot[:, None, :] + torch.eye(7, **f64)
    H[:, 6, 6] += cfg.scale_damping
    b[:, :7] += cfg.k4 * drot * res_rot[:, None]
    sums = [tuple(x.cpu() for x in term) for term in sums]
    return torch.linalg.solve_ex(H, b)[0].cpu(), loss.cpu(), sums


def solved(dx, info, loss):
    """Whether each object's step is usable, as `_gn_iteration` judges it:
    finite dx and loss, info 0."""
    return torch.isfinite(loss) & torch.isfinite(dx).all(-1) & (info == 0)


def gaps(cfg, args, got, op) -> dict:
    """The kernels' answer `got` and the op route's `op` (dx, info, loss) on
    the operands `args` (code, sdf, ren, drot, res_rot), against the f64
    solve of the same operands: whether both routes judge the same objects
    ok, and over those objects the largest gap of the kernels' dx from the
    f64 dx (`dx_f64`), of the op route's (`op_f64`) and of the kernels'
    from the op route's (`dx_op`), each relative to the object's largest
    |dx|, and of the loss, relative; with `ok_objects` their count and
    `info_ok` whether the kernels' info is 0 on each."""
    ref, loss64, _ = f64_solve(cfg, *args)
    ok_k, ok_op = solved(*got).cpu(), solved(*op).cpu()
    keep = ok_k & ok_op
    dx_k, dx_op, ref = got[0].double().cpu()[keep], op[0].double().cpu()[keep], ref[keep]
    scale = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    loss_k, loss64 = got[2].double().cpu()[keep], loss64[keep]
    empty = not bool(keep.any())
    return {"same_ok": bool(torch.equal(ok_k, ok_op)), "ok_objects": int(keep.sum()),
            "dx_f64": 0.0 if empty else float(((dx_k - ref).abs() / scale).max()),
            "op_f64": 0.0 if empty else float(((dx_op - ref).abs() / scale).max()),
            "dx_op": 0.0 if empty else float(((dx_k - dx_op).abs() / scale).max()),
            "loss": 0.0 if empty else float(((loss_k - loss64).abs()
                                             / loss64.abs().clamp_min(1e-30)).max()),
            "info_ok": bool((got[1].cpu()[keep] == 0).all())}


def within(g: dict) -> bool:
    """`gaps` inside the tolerances: both routes' dx within DX_TOL of the
    f64 solve, the kernels' within DX_TOL of the op route's, the loss
    within LOSS_TOL."""
    return (g["same_ok"] and g["info_ok"] and max(g["dx_f64"], g["op_f64"], g["dx_op"]) <= DX_TOL
            and g["loss"] <= LOSS_TOL)
