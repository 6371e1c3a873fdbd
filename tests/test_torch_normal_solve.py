"""The fit's normal equations and their solve (`ops/cuda/normal_solve.py`,
`csrc/normal_solve.cu`).

On the CPU:
  * CPU tensors take the op route, which equals, bit for bit, the op-by-op
    `_solve_normal` that `recon/optimizer.py` ran before the normal
    equations moved into the wrapper (frozen below as `_parent_solve_normal`,
    with its `_solve_batched`), at 71 and 263 unknowns and render live
    shares of 0, ~17% and 100%; `LAUNCHES` stays 0;
  * the checks raise on a wrong dtype, shape, device mix or an input
    without unit stride on its last axis;
  * a CPU fit's `recon.normal` spans carry `path` "ops"; `route` sends CUDA
    systems up to `max_width()` unknowns to the kernels (the library's
    width, stubbed here), wider ones and CPU ones to the ops;
  * with a `group` the op route all-reduces once (`dist.psum` stubbed here:
    one process), between the sums and the solve;
  * `gaps` / `within` pass the op route held to itself and fail a dx moved
    past `DX_TOL`, a loss past `LOSS_TOL` or another set of failed objects.

On the card (`pytest --noconftest -m cuda tests/test_torch_normal_solve.py`;
this file imports no JAX): the sums' layout and the row chunks the library
takes from (B, n); the kernels against the op route on the same card at
(B, n) = (8, 71), (128, 71), (128, 263), render live shares 0, ~17% and
100%, k4 = 1e7 (the fit's) and one object with a NaN in a live SDF row,
which both routes leave not ok.  Tolerances: `normal_solve.DX_TOL` and
`LOSS_TOL` (their reasons stand beside them); on these inputs (the CPU)
f32 LU reads 2.2e-4 and f32 Cholesky 3.0e-4 of each object's largest
|dx|; the sums within 1e-5 of the largest diagonal entry of the f64 sums
(f32 sums over ≤ 1,280 rows in another order).  Two runs give the same
bits, the padding's place and contents (NaN in masked rows) change no
bit, 2 launches a call, with a group the all-reduce between them.
"""
from __future__ import annotations

import types

import pytest
import torch

from dsp_slam_rgbd_tpu_torch.ops.cuda import normal_solve
from dsp_slam_rgbd_tpu_torch.ops.cuda.normal_solve import gaps, within
from dsp_slam_rgbd_tpu_torch.parallel import distributed as dist
from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt
from dsp_slam_rgbd_tpu_torch.utils import timers

SHARES = (0.0, 0.17, 1.0)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _parent_solve_normal(cfg, code, sdf_t, rr_sdf, ren, rr_ren, drot, res_rot, group, span):
    """`recon/optimizer.py::_solve_normal` before the kernels, as it was."""
    B, L = code.shape
    sums = []
    for jac_pose, jac_code, mask, rr in (
            (sdf_t.jac_pose, sdf_t.jac_code, sdf_t.mask, rr_sdf),
            (ren.jac_pose, ren.jac_code, ren.mask, rr_ren)):
        J = torch.where(mask[..., None], torch.cat([jac_pose, jac_code], -1), 0.0)
        sums += [J.transpose(1, 2) @ J,
                 (J.transpose(1, 2) @ torch.where(mask, rr, 0.0)[..., None])[..., 0],
                 torch.sum(rr * rr, dim=-1), mask.sum(-1)]
    span.set(jac_slots=ren.mask.numel(), jac_live=sums[7])
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
    b[:, :7] += cfg.k4 * drot * res_rot[:, None]
    H[:, :7, :7] += torch.eye(7, device=code.device)
    H[:, 6, 6] += cfg.scale_damping

    dx, info = _parent_solve_batched(H, b)
    return dx, info, loss


def _parent_solve_batched(H, b):
    if H.device.type != "cpu" or H.shape[0] < 2 or H.shape[-1] <= 128:
        return torch.linalg.solve_ex(H, b)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.linalg.solve_ex(H, b)
    finally:
        torch.set_num_threads(prev)


def _term(B, L, R, share, gen):
    """One term's (jac_pose, jac_code, mask, rr) as the fit lays them out:
    jac_code a view of the decoder's (B, R, L + 3) gradients, the robust
    residuals zero on masked rows; about `share` of the rows live."""
    jac_pose = torch.randn(B, R, 7, generator=gen)
    jac_code = (torch.randn(B, R, L + 3, generator=gen) * 0.1)[..., :L]
    mask = torch.rand(B, R, generator=gen) < share
    rr = torch.where(mask, torch.randn(B, R, generator=gen) * 0.05, 0.0)
    return jac_pose, jac_code, mask, rr


def _problem(B, L, share, seed, nan_object=None):
    """Operands of one GN iteration's normal equations at the bf16 cells'
    row counts (256 surface points, all live; 1,024 render slots)."""
    gen = torch.Generator().manual_seed(seed)
    sdf = _term(B, L, 256, 1.0, gen)
    ren = _term(B, L, 1024, share, gen)
    code = torch.randn(B, L, generator=gen) * 0.3
    drot = torch.zeros(B, 7)
    drot[:, 3:6] = torch.randn(B, 3, generator=gen) * 0.2
    res_rot = torch.rand(B, generator=gen) * 1e-2
    if nan_object is not None:
        sdf[0][nan_object, 5, 2] = float("nan")
    return code, sdf, ren, drot, res_rot


def _to(args, device):
    return tuple(tuple(x.to(device) for x in a) if isinstance(a, tuple) else a.to(device)
                 for a in args)


class _Span:
    def __init__(self):
        self.attrs = {}

    def set(self, **attrs):
        self.attrs.update(attrs)


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("L", [64, 256])
def test_cpu_route_is_the_parents_op_by_op_solve_bit_for_bit(L, share):
    cfg = opt.ReconConfig(code_len=L)
    code, sdf, ren, drot, res_rot = _problem(3, L, share, seed=L + int(100 * share))
    normal_solve.reset_launch_counts()
    mine, theirs = _Span(), _Span()
    got = normal_solve.solve(cfg, code, sdf, ren, drot, res_rot, span=mine)
    ns = lambda t: types.SimpleNamespace(jac_pose=t[0], jac_code=t[1], mask=t[2])  # noqa: E731
    want = _parent_solve_normal(cfg, code, ns(sdf), sdf[3], ns(ren), ren[3], drot, res_rot,
                                None, theirs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool((got[1] == 0).all())
    assert mine.attrs["jac_slots"] == theirs.attrs["jac_slots"] == 3 * 1024
    assert torch.equal(mine.attrs["jac_live"], theirs.attrs["jac_live"])
    assert normal_solve.LAUNCHES == 0


def _faults(L=64):
    code, sdf, ren, drot, res_rot = _problem(2, L, 0.5, seed=1)
    meta = torch.empty(2, 7, device="meta")
    return {
        "f64 jac_code": (code, (sdf[0], sdf[1].double(), sdf[2], sdf[3]), ren, drot, res_rot),
        "jac_pose 6 wide": (code, (sdf[0][..., :6], *sdf[1:]), ren, drot, res_rot),
        "mask of floats": (code, sdf, (*ren[:2], ren[2].float(), ren[3]), drot, res_rot),
        "code of another width": (code[:, :-1], sdf, ren, drot, res_rot),
        "rows of two counts": (code, sdf, (ren[0], ren[1][:, :-1], *ren[2:]), drot, res_rot),
        "device mix": (code, sdf, ren, meta, res_rot),
        "jac_code across rows": (code, (sdf[0], sdf[1].transpose(1, 2).contiguous()
                                        .transpose(1, 2), *sdf[2:]), ren, drot, res_rot),
        "drot not contiguous": (code, sdf, ren, torch.zeros(7, 2).t(), res_rot),
    }


@pytest.mark.parametrize("fault", list(_faults()))
def test_checks_raise(fault):
    args = _faults()[fault]
    with pytest.raises(ValueError):
        normal_solve.solve(opt.ReconConfig(), *args)


def test_a_cpu_fit_records_the_ops_route_and_routing_follows_device_and_width(monkeypatch):
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import make_problem

    dec = deepsdf.init_decoder(deepsdf.DecoderSpec(dims=(96,) * 4, latent_in=(2,)), seed=0,
                               device="cpu")
    cfg = opt.ReconConfig(num_iterations=3, max_grad_points=32)
    p = {k: torch.as_tensor(v)[None] for k, v in make_problem(4, n_pts=12, n_rays=12).items()
         if k in ("T_init", "pts", "rays", "depth", "fg_mask")}
    ones = torch.ones(1, 12, dtype=torch.bool)
    args = (p["T_init"], p["pts"], ones, p["rays"], ones, p["depth"], p["fg_mask"])
    timers.clear()
    with timers.recording():
        opt.reconstruct_objects_batched(dec, cfg, *args)
    normal = [s for s in timers.spans() if s.name == "recon.normal"]
    timers.clear()
    assert len(normal) == 3 and all(s.attrs["path"] == "ops" for s in normal)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.setitem(normal_solve._fn, "max_width", 321)   # the library's, on an H100
    assert normal_solve.route(cuda, 71) == normal_solve.route(cuda, 263) == "kernels"
    assert normal_solve.route(cuda, 321) == "kernels" and normal_solve.route(cuda, 322) == "ops"
    assert normal_solve.route(cpu, 71) == normal_solve.route(cpu, 263) == "ops"


def test_group_route_all_reduces_once_between_the_sums_and_the_solve(monkeypatch):
    L = 64
    cfg = opt.ReconConfig(code_len=L)
    args = _problem(3, L, 0.17, seed=5)
    calls = []

    def psum(tensors, group):
        calls.append(("psum", len(tensors), group))
        return tensors

    solve_batched = normal_solve.solve_batched

    def solve(H, b):
        calls.append(("solve",))
        return solve_batched(H, b)

    monkeypatch.setattr(dist, "psum", psum)
    monkeypatch.setattr(normal_solve, "solve_batched", solve)
    group = object()
    got = normal_solve.solve(cfg, *args, group=group)
    assert calls == [("psum", 8, group), ("solve",)]
    want = normal_solve.solve(cfg, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_tolerance_holds_the_op_route_and_catches_a_moved_answer():
    L = 64
    cfg = opt.ReconConfig(code_len=L)
    args = _problem(4, L, 0.17, seed=9, nan_object=2)
    op = normal_solve.solve_plain(cfg, *args)
    g = gaps(cfg, args, op, op)
    assert within(g) and g["ok_objects"] == 3 and g["dx_op"] == 0.0, g
    assert g["op_f64"] <= normal_solve.DX_TOL
    dx, info, loss = op
    scale = dx.abs().amax(-1, keepdim=True)
    moved = dx + torch.where(torch.arange(L + 7) == 3, 1.5 * normal_solve.DX_TOL * scale, 0.0)
    assert not within(gaps(cfg, args, (moved, info, loss), op))
    assert not within(gaps(cfg, args, (dx, info, loss * (1 + 3 * normal_solve.LOSS_TOL)), op))
    failed = info.clone()
    failed[0] = 1
    assert not within(gaps(cfg, args, (dx, failed, loss), op))


# ---------------------------------------------------------------------------
# on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sums_layout_and_row_chunks():
    _cuda()
    sizes = normal_solve.sizes
    # [J | r]'s packed triangle, the masked rows' squares, the count; padded to 4
    assert sizes(128, 71)["stride"] == 2632 and sizes(128, 263)["stride"] == 34984
    assert all(sizes(8, n)["stride"] % 4 == 0
               and sizes(8, n)["count_at"] == (n + 1) * (n + 2) // 2 + 1 < sizes(8, n)["stride"]
               for n in range(8, 340))
    # the bf16 cells fill the card with one chunk; b8 splits its rows
    assert sizes(128, 71)["chunks"] == sizes(128, 263)["chunks"] == 1
    assert sizes(8, 71)["chunks"] == 6 and sizes(8, 263)["chunks"] == 2
    assert sizes(1, 71)["chunks"] == 16
    # the solve's panel, its scaled diagonal block, the augmented triangle,
    # pivots, x and scalars in an H100 block's 232,448 B: 321 unknowns
    assert normal_solve.max_width() == sizes(1, 8)["max_width"] == 321
    with pytest.raises(ValueError):
        sizes(-1, 71)


# ---------------------------------------------------------------------------
# on the card


def _unpack(buf, n):
    """(B, C, 2, S) sums -> per term (JᵀJ (B, n, n) lower, Jᵀr, count), chunks added."""
    s = buf.double().sum(1).cpu()
    rows, cols = torch.tril_indices(n, n)
    out = []
    for t in range(2):
        JtJ = torch.zeros(s.shape[0], n, n, dtype=torch.float64)
        JtJ[:, rows, cols] = s[:, t, :n * (n + 1) // 2]
        m = n + 1
        out.append((JtJ, s[:, t, n * (n + 1) // 2:n * (n + 1) // 2 + n], s[:, t, m * (m + 1) // 2 + 1]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("B,L", [(8, 64), (128, 64), (128, 256)])
def test_kernels_match_the_op_route_on_the_card(B, L, share):
    dev = _cuda()
    cfg = opt.ReconConfig(code_len=L)
    cpu_args = _problem(B, L, share, seed=7 * B + L, nan_object=1)
    args = _to(cpu_args, dev)
    normal_solve.reset_launch_counts()
    got = normal_solve.solve(cfg, *args)
    assert normal_solve.LAUNCHES == 2
    op = normal_solve.solve_plain(cfg, *args)
    torch.cuda.synchronize()
    ok_k = normal_solve.solved(*got).cpu()
    assert not bool(ok_k[1]) and bool(ok_k[torch.arange(B) != 1].all())
    g = gaps(cfg, args, got, op)
    assert within(g) and g["ok_objects"] == B - 1, g


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(8, 64), (128, 256)])
def test_the_sums_on_the_card(B, L, monkeypatch):
    dev = _cuda()
    cfg = opt.ReconConfig(code_len=L)
    cpu_args = _problem(B, L, 0.17, seed=3)
    bufs = []
    psum = dist.psum

    def keep(tensors, group):
        bufs.append(tensors[0].clone())
        return psum(tensors, None)

    monkeypatch.setattr(dist, "psum", keep)
    args = _to(cpu_args, dev)
    normal_solve.solve(cfg, *args, group=object())
    _, _, sums64 = normal_solve.f64_solve(cfg, *args)
    n = 7 + L
    for (JtJ, Jtr, count), (JtJ64, Jtr64, _, n64), mask in zip(
            _unpack(bufs[0], n), sums64, (cpu_args[1][2], cpu_args[2][2])):
        big = JtJ64.diagonal(dim1=1, dim2=2).amax(-1)[:, None, None]
        assert float(((JtJ - JtJ64.tril()).abs() / big).max()) <= 1e-5
        assert float(((Jtr - Jtr64).abs() / big[:, :, 0]).max()) <= 1e-5
        assert torch.equal(count, mask.sum(-1).double())


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(8, 64), (128, 256)])
def test_kernels_repeat_bit_for_bit_wherever_the_padding_lies(B, L):
    dev = _cuda()
    cfg = opt.ReconConfig(code_len=L)
    code, sdf, ren, drot, res_rot = _problem(B, L, 0.17, seed=11)
    runs = [normal_solve.solve(cfg, *_to((code, sdf, ren, drot, res_rot), dev)) for _ in range(2)]
    # the same live rows in the same order at other slots, NaN in the padding
    jac_pose, jac_code, mask, rr = ren
    R = mask.shape[1]
    moved = [torch.full_like(jac_pose, float("nan")), torch.full((B, R, L + 3), float("nan")),
             torch.zeros_like(mask), torch.zeros_like(rr)]
    gen = torch.Generator().manual_seed(12)
    for i in range(B):
        live = mask[i].nonzero()[:, 0]
        slots = torch.sort(torch.randperm(R, generator=gen)[:live.numel()])[0]
        moved[0][i, slots] = jac_pose[i, live]
        moved[1][i, slots, :L] = jac_code[i, live]
        moved[2][i, slots] = True
        moved[3][i, slots] = rr[i, live]
    moved[1] = moved[1][..., :L]
    runs.append(normal_solve.solve(cfg, *_to((code, sdf, tuple(moved), drot, res_rot), dev)))
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_launches_and_the_group_route_on_the_card(monkeypatch):
    dev = _cuda()
    cfg = opt.ReconConfig()
    args = _to(_problem(16, 64, 0.17, seed=2), dev)
    normal_solve.reset_launch_counts()
    want = normal_solve.solve(cfg, *args)
    assert normal_solve.LAUNCHES == 2
    seen = []

    def psum(tensors, group):
        seen.append(normal_solve.LAUNCHES)
        return tensors

    monkeypatch.setattr(dist, "psum", psum)
    got = normal_solve.solve(cfg, *args, group=object())
    assert seen == [3] and normal_solve.LAUNCHES == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the widest system one block holds takes the kernels (the library
    # refuses a wider one or a sums stride of another layout: the wrapper's
    # sizes are the kernels'); one unknown more, the op route, no launch
    for L, launches in ((normal_solve.max_width() - 7, 6), (normal_solve.max_width() - 6, 6)):
        cfg = opt.ReconConfig(code_len=L)
        args = _to(_problem(2, L, 0.17, seed=4), dev)
        got = normal_solve.solve(cfg, *args)
        assert normal_solve.LAUNCHES == launches
        assert within(gaps(cfg, args, got, normal_solve.solve_plain(cfg, *args)))


@pytest.mark.cuda
def test_a_fit_on_the_card_takes_the_kernels():
    from dsp_slam_rgbd_tpu_torch.models import deepsdf
    from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE, make_problem

    dev = _cuda()
    dec = deepsdf.load_npz(FIXTURE, device=dev)
    cfg = opt.ReconConfig.gpu_fast(num_iterations=3, coarse_iterations=1)
    ps = [make_problem(s, n_pts=64, n_rays=64) for s in range(4)]
    st = lambda k: torch.stack([torch.as_tensor(p[k]) for p in ps]).to(dev)  # noqa: E731
    ones = torch.ones(4, 64, dtype=torch.bool, device=dev)
    normal_solve.reset_launch_counts()
    timers.clear()
    with timers.recording():
        out = opt.reconstruct_objects_batched(dec, cfg, st("T_init"), st("pts"), ones, st("rays"),
                                              ones, st("depth"), st("fg_mask"),
                                              compute_dtype=torch.bfloat16)
    normal = [s for s in timers.spans() if s.name == "recon.normal"]
    timers.clear()
    assert normal_solve.LAUNCHES == 2 * 3
    assert len(normal) == 3 and all(s.attrs["path"] == "kernels" for s in normal)
    assert bool(torch.isfinite(out.t_cam_obj).all())
