"""The port's span registry (`dsp_slam_rgbd_tpu_torch/utils/timers.py`),
the spans at the fit's and the BA's layer boundaries, and the benchmark's
readers of them (`benchmark/metrics/`).

  * off (no profiler, no `recording()`), `span` is the shared no-op and a
    fit records nothing and never enters `record_function`;
  * under a CPU `torch.profiler` session a fit's chrome trace holds one
    `recon.fit` and one `recon.gn` a GN iteration, with one `recon.normal`
    (the normal equations and their solve) inside each, as
    `user_annotation` events, nested as the registry's parent and root ids
    say;
  * `jac_slots` is B x K and `jac_live` the live-row count the normal
    equations summed;
  * a global BA records one `ba.global`, and on the PCG path one `ba.cg`
    a GN step, inside it, whose `path` names the CG loop's route;
  * each reader gives the number its docstring defines on a fabricated
    registry, and None where nothing was recorded or the port has no
    registry;
  * on the card (marker `cuda`): every span has card ms, the trace holds
    the spans as `gpu_user_annotation` events, and `mlp_sdf.ROWS` counts
    the rows the fit's shapes launch.
No JAX here, so the card test runs with `--noconftest`.
"""
import importlib.util
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from dsp_slam_rgbd_tpu_torch.mapping import local_mapping
from dsp_slam_rgbd_tpu_torch.models import deepsdf
from dsp_slam_rgbd_tpu_torch.ops.cuda import mlp_sdf
from dsp_slam_rgbd_tpu_torch.recon import losses
from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt
from dsp_slam_rgbd_tpu_torch.tools import corridor_map
from dsp_slam_rgbd_tpu_torch.tools.ellipsoid import FIXTURE, make_problem
from dsp_slam_rgbd_tpu_torch.utils import timers
from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = opt.ReconConfig(num_iterations=4, max_grad_points=64, coarse_iterations=2,
                      coarse_samples=8, active_ray_fraction=0.5)
B, N, R = 3, 16, 16
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _empty_registry():
    timers.clear()
    yield
    timers.clear()


def _batch(device="cpu"):
    ps = [make_problem(s, n_pts=N, n_rays=R) for s in range(B)]
    t = {k: torch.as_tensor(np.stack([p[k] for p in ps]), device=device)
         for k in ("T_init", "pts", "rays", "depth", "fg_mask")}
    ones = lambda n: torch.ones(B, n, dtype=torch.bool, device=device)  # noqa: E731
    return (t["T_init"], t["pts"], ones(N), t["rays"], ones(R), t["depth"], t["fg_mask"])


@pytest.fixture(scope="module")
def decoder():
    spec = deepsdf.DecoderSpec(dims=(96,) * 4, latent_in=(2,))
    return deepsdf.init_decoder(spec, seed=0, device="cpu")


def _fit(decoder, cfg=CFG, **kw):
    return opt.reconstruct_objects_batched(decoder, cfg, *_batch(), **kw)


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"test_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_off_a_fit_records_nothing_and_never_enters_record_function(decoder, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert timers.span("recon.fit", B=1) is timers.OFF
    with timers.span("x") as sp:
        sp.set(a=1)
        sp.count("rows", mlp_sdf.ROWS)
    assert sp is timers.OFF
    _fit(decoder)
    assert timers.spans() == []


def test_fit_spans_nest_in_a_cpu_profiler_trace(decoder, tmp_path):
    with timers.profiler_trace(str(tmp_path)):
        _fit(decoder)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    fits = [e for e in ann if e["name"] == "recon.fit"]
    gns = [e for e in ann if e["name"] == "recon.gn"]
    normals = [e for e in ann if e["name"] == "recon.normal"]
    assert len(fits) == 1 and len(gns) == len(normals) == CFG.num_iterations
    f0, f1 = fits[0]["ts"], fits[0]["ts"] + fits[0]["dur"]
    assert all(f0 <= e["ts"] and e["ts"] + e["dur"] <= f1 for e in gns)
    assert all(g["ts"] <= e["ts"] and e["ts"] + e["dur"] <= g["ts"] + g["dur"]
               for g, e in zip(gns, normals))

    sp = timers.spans()
    assert [s.name for s in sp] == \
        ["recon.fit"] + ["recon.gn", "recon.normal"] * CFG.num_iterations
    fit, gn, normal = sp[0], sp[1::2], sp[2::2]
    assert fit.parent is None and fit.root == fit.id and fit.attrs["B"] == B
    assert fit.attrs["latent"] == CFG.code_len
    assert all(s.parent == fit.id and s.root == fit.id for s in gn)
    assert all(s.parent == g.id and s.root == fit.id for g, s in zip(gn, normal))
    assert all(s.attrs["params"] == 7 + CFG.code_len for s in normal)
    assert all(s.attrs["rows"] == {"sdf": N, "render": CFG.max_grad_points} for s in normal)
    assert all(g.host_ms >= s.host_ms for g, s in zip(gn, normal))
    assert [s.attrs["phase"] for s in gn] == ["coarse"] * 2 + ["fine"] * 2
    assert [s.attrs["samples"] for s in gn] == [8, 8, 50, 50]
    assert [s.attrs["rays"] for s in gn] == [R, R, R // 2, R // 2]
    assert all(s.host_ms > 0 and s.device_ms is None for s in sp)
    assert fit.host_ms >= sum(s.host_ms for s in gn)
    # the plain decoder on the CPU launches no kernel
    assert fit.attrs["rows"] == {} and fit.attrs["launches"] == {}


def test_gn_span_counts_the_render_jacobian_rows(decoder, monkeypatch):
    masks = []
    render = losses.compute_render_loss

    def keep(*a, **k):
        out = render(*a, **k)
        masks.append(out.mask.clone())
        return out

    monkeypatch.setattr(losses, "compute_render_loss", keep)
    with timers.recording():
        _fit(decoder)
    gn = [s for s in timers.spans() if s.name == "recon.gn"]
    assert len(gn) == len(masks) == CFG.num_iterations
    for s, m in zip(gn, masks):
        assert s.attrs["jac_slots"] == B * CFG.max_grad_points == m.numel()
        assert s.attrs["jac_live"] == int(m.sum())
    assert sum(s.attrs["jac_live"] for s in gn) > 0


@pytest.fixture(scope="module")
def corridor():
    fields, _, _ = corridor_map.build_corridor_map(n_kf=24, n_pts=1000, feat_per_kf=80,
                                                   noise=0.2, max_kf=32, max_pts=2048)
    return map_state_from_numpy(fields, "cpu"), corridor_map.CAM


@pytest.mark.parametrize("path,limit", [("pcg", 8), ("dense", 96)])
def test_global_ba_records_one_call_and_a_cg_span_a_step(corridor, path, limit):
    state, cam = corridor
    with timers.recording():
        local_mapping.global_ba_step(state, cam, n_iters=4, dense_limit=limit)
    sp = timers.spans()
    calls = [s for s in sp if s.name == "ba.global"]
    cg = [s for s in sp if s.name == "ba.cg"]
    assert len(calls) == 1 and calls[0].parent is None
    a = calls[0].attrs
    assert a["path"] == path and a["pose_blocks"] >= 24 and a["points"] > 0
    assert len(cg) == (4 if path == "pcg" else 0)
    assert all(s.root == calls[0].id and s.attrs["steps"] == 48 for s in cg)
    assert all(0 < s.host_ms < calls[0].host_ms for s in cg)


def test_cg_span_names_the_path_the_loop_took(corridor, monkeypatch):
    """`ba.cg` carries `path`: "ops" for CPU tensors (the plain loop);
    "kernels" where the edges are laid out for the kernels, as CUDA
    tensors' are."""
    from dsp_slam_rgbd_tpu_torch.mapping import ba
    from dsp_slam_rgbd_tpu_torch.ops.cuda import schur_pcg

    state, cam = corridor
    with timers.recording():
        local_mapping.global_ba_step(state, cam, n_iters=2, dense_limit=8)
    cg = [s for s in timers.spans() if s.name == "ba.cg"]
    assert len(cg) == 2 and all(s.attrs["path"] == "ops" for s in cg)
    # the path the span names is the layout the solve is given
    seen = []

    def kernel_edges(plans, Ccp):
        seen.append(schur_pcg.Edges(plans, Ccp, ccp_pt=Ccp))
        return seen[-1]

    monkeypatch.setattr(schur_pcg, "edges", kernel_edges)
    monkeypatch.setattr(schur_pcg, "solve", lambda *a: seen.append(a[0]) or a[7])
    monkeypatch.setattr(schur_pcg, "point_sums", lambda e, x: torch.zeros(e.plans.pt.n, 3))
    monkeypatch.setattr(schur_pcg, "pose_sums", lambda e, v: torch.zeros(e.plans.kf.n, 6))
    prob, _ = local_mapping.build_local_ba_problem(state, 0, 0, global_window=True)
    timers.clear()
    with timers.recording():
        ba._pcg_gn_step(cam, prob, 1e-3, 4)
    cg = [s for s in timers.spans() if s.name == "ba.cg"]
    assert [s.attrs["path"] for s in cg] == ["kernels"]
    assert len(seen) == 2 and seen[1] is seen[0] and seen[0].path == "kernels"


def test_stage_timers_summarize_the_registry():
    t = timers.StageTimers()
    with t.stage("a"):
        pass
    with timers.recording(), timers.span("other"):
        pass
    assert [s.name for s in timers.spans()] == ["a", "other"]
    assert set(t.summary()) == {"a"} and t.summary()["a"]["n"] == 1
    timers.clear()
    assert t.summary() == {}


def test_spans_sum_tensor_attributes_and_keep_until_cleared():
    with timers.recording():
        with timers.span("outer", n=torch.tensor([2, 3])) as o:
            o.count("rows", mlp_sdf.ROWS)
            mlp_sdf.ROWS["mlp_sdf_value"] += 7
            with timers.span("inner"):
                pass
        mlp_sdf.ROWS["mlp_sdf_value"] -= 7
    outer, inner = timers.spans()
    assert outer.attrs == {"n": 5, "rows": {"mlp_sdf_value": 7}}
    assert inner.parent == outer.id and inner.root == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert len(timers.spans()) == 2
    timers.clear()
    assert timers.spans() == []


def test_rows_counter_resets_with_the_launch_counter():
    mlp_sdf.ROWS["mlp_sdf_jacobian"] += 3
    mlp_sdf.reset_launch_counts()
    assert set(mlp_sdf.ROWS) == set(mlp_sdf.LAUNCHES)
    assert all(v == 0 for v in mlp_sdf.ROWS.values())


def _fabricate():
    """Two fit batches of two GN iterations and two BA calls of three CG
    solves, with card ms set by hand."""
    with timers.recording():
        for i in range(2):
            with timers.span("recon.fit", B=4) as f:
                f.set(rows={"mlp_sdf_jacobian": 1000, "mlp_sdf_value": 9},
                      launches={"mlp_sdf_jacobian": 4, "mlp_sdf_value": 2})
                for live in (10, 30):
                    with timers.span("recon.gn", jac_slots=100,
                                     jac_live=torch.tensor([live // 2, live - live // 2])):
                        pass
        for i in range(2):
            with timers.span("ba.global", path="pcg"):
                for _ in range(3):
                    with timers.span("ba.cg", steps=48):
                        pass
        with timers.span("ba.cg", steps=48):   # outside any BA call: not counted
            pass
    sp = timers.spans()
    for k, s in enumerate(sp):
        s.device_ms = 1.0 + k
        s.end_ns = s.start_ns + int(1e6 * (2.0 + k))   # host_ms = 2 + k
    return sp


def test_readers_on_a_fabricated_registry():
    sp = _fabricate()
    gn = [k for k, s in enumerate(sp) if s.name == "recon.gn"]
    ctx = {"device_name": H100, "units": 2, "trace": {"kernels": {}}}
    assert _reader("recon_gn_host_ms")(ctx) == pytest.approx(np.mean([2.0 + k for k in gn]))
    assert _reader("recon_gn_device_ms")(ctx) == pytest.approx(np.mean([1.0 + k for k in gn]))
    assert _reader("render_jacobian_live_share")(ctx) == pytest.approx(100.0 * 80 / 400)
    cg = [k for k, s in enumerate(sp) if s.name == "ba.cg" and s.parent is not None]
    assert len(cg) == 6
    assert _reader("gba_cg_host_ms_per_solve")(ctx) == pytest.approx(
        sum(2.0 + k for k in cg) / 2)
    assert _reader("gba_cg_device_ms_per_solve")(ctx) == pytest.approx(
        sum(1.0 + k for k in cg) / 2)
    # the roofline: 2,000 Jacobian rows in 8 launches of 4 objects, in 1 ms
    roof = _reader("mlp_sdf_jacobian_tc_roofline")
    assert roof(ctx) is None   # no kernel time in the trace
    ctx["trace"]["kernels"] = {"void mlp_sdf_jacobian_tc_kernel<...>": 1e-3}
    fwd = 2 * (67 * 512 + 6 * 512 * 512 + 512 * 445 + 512 * 1)
    w = fwd // 2
    b = 7 * 512 + 445 + 1
    work = 2000 * 2.0 * fwd
    byts = 2000 * 4 * 71 + 8 * (2 * w * 2 + b * 4) + 8 * 4 * 64 * 4
    want = 100.0 * max(work / 989e12, byts / 3.35e12) / 1e-3
    assert roof(ctx) == pytest.approx(want)
    assert math.isfinite(want) and 0 < want < 100


def test_256_readers_on_a_fabricated_registry():
    """The latent-256 cell's readers: `recon_normal_device_ms` sums the
    `recon.normal` card ms per `recon.gn`; the two 256 rooflines count the
    folded kernels' work (`yardstick/decoder_work.py`) for the rows,
    launches and codes of the `recon.fit` spans at latent 256 over the
    device time of the kernels named `mlp_sdf256_*_tc` (fold kernels
    included).  A registry without those spans, or a trace without those
    kernels (the parent commit's), gives nothing."""
    with timers.recording():
        with timers.span("recon.fit", B=4, latent=256) as f:
            f.set(rows={"mlp_sdf_jacobian": 1000, "mlp_sdf_value": 3000},
                  launches={"mlp_sdf_jacobian": 2, "mlp_sdf_value": 1})
            for _ in range(2):
                with timers.span("recon.gn", jac_slots=0, jac_live=0):
                    with timers.span("recon.normal", params=263,
                                     rows={"sdf": 256, "render": 1024}):
                        pass
    sp = timers.spans()
    for k, s in enumerate(sp):
        s.device_ms = 1.0 + k
    ctx = {"device_name": H100, "units": 1, "trace": {"kernels": {}}}
    normal = [1.0 + k for k, s in enumerate(sp) if s.name == "recon.normal"]
    assert _reader("recon_normal_device_ms")(ctx) == pytest.approx(sum(normal) / 2)
    value, jac = _reader("mlp_sdf256_value_tc_roofline"), _reader("mlp_sdf256_jacobian_tc_roofline")
    assert value(ctx) is None and jac(ctx) is None
    ctx["trace"]["kernels"] = {"(anonymous namespace)::mlp_sdf256_value_tc_kernel(...)": 2e-3,
                               "(anonymous namespace)::mlp_sdf256_value_tc_fold_kernel(...)": 1e-3,
                               "(anonymous namespace)::mlp_sdf_value_tc_kernel(...)": 5.0,
                               "(anonymous namespace)::mlp_sdf256_jacobian_tc_kernel(...)": 1e-3}
    # per row: layer 0 over xyz, layers 1, 2, 5, 6, 7 whole, layer 3 to 253
    # outputs, layer 4 over 256 inputs, layer 8; per code 2 x 256 x 512
    row = 2 * (3 * 512 + 5 * 512 * 512 + 512 * 253 + 256 * 512 + 512)
    full = 2 * (259 * 512 + 6 * 512 * 512 + 512 * 253 + 512)
    fold = 2 * 2 * 256 * 512
    v_ops = 3000 * row + 4 * fold
    assert value(ctx) == pytest.approx(100.0 * v_ops / 989e12 / 3e-3)
    j_ops = 1000 * (row + full) + 8 * fold
    assert jac(ctx) == pytest.approx(100.0 * j_ops / 989e12 / 1e-3)
    timers.clear()
    with timers.recording():
        with timers.span("recon.fit", B=4) as f:   # the parent's span: no latent
            f.set(rows={"mlp_sdf_value": 3000}, launches={"mlp_sdf_value": 1})
            with timers.span("recon.gn", jac_slots=0, jac_live=0):
                pass
    assert value(ctx) is None and _reader("recon_normal_device_ms")(ctx) is None


def test_decoder_work_counts_the_model_at_64():
    """Without the fold (latent 64) a row of the value kernel does the
    model's forward pass (`yardstick/flops.py`), of the Jacobian two."""
    from benchmark.yardstick import decoder_work, flops

    dec = {"latent_size": 64, "dims": [512] * 8, "latent_in": [4]}
    f = flops.forward_flops_per_row(dec)
    assert not decoder_work.folded(64) and decoder_work.folded(256)
    assert decoder_work.row_flops(64, False) == f and decoder_work.row_flops(64, True) == 2 * f
    assert decoder_work.code_flops(64) == 0.0
    assert decoder_work.value_stream_bytes(64) == mlp_sdf.VALUE_STAGES * mlp_sdf.VALUE_STAGE_BYTES
    assert decoder_work.value_stream_bytes(256) == \
        mlp_sdf.LAYOUTS[256].value_stages * mlp_sdf.VALUE_STAGE_BYTES
    assert decoder_work.backward_stream_bytes(256) == mlp_sdf.LAYOUTS[256].backward_bytes


def test_readers_report_nothing_without_spans(monkeypatch):
    ctx = {"device_name": H100, "units": 1,
           "trace": {"kernels": {"mlp_sdf_jacobian_tc_kernel": 1e-3}}}
    names = ("recon_gn_host_ms", "recon_gn_device_ms", "render_jacobian_live_share",
             "mlp_sdf_jacobian_tc_roofline", "gba_cg_host_ms_per_solve",
             "gba_cg_device_ms_per_solve")
    for name in names:
        assert _reader(name)(ctx) is None, name
    # card ms are None on the CPU: the card readers report nothing
    with timers.recording():
        with timers.span("ba.global"), timers.span("ba.cg"):
            pass
        with timers.span("recon.gn", jac_slots=0, jac_live=0):
            pass
    for name in ("recon_gn_device_ms", "gba_cg_device_ms_per_solve",
                 "render_jacobian_live_share"):
        assert _reader(name)(ctx) is None, name
    # a port without the registry (no `timers.spans`)
    from benchmark.yardstick import spans

    assert spans.of(types.SimpleNamespace(), "recon.gn") == []


@pytest.mark.cuda
def test_spans_on_the_card(tmp_path):
    """On the card, a bf16 fit of the fixture decoder under
    `profiler_trace`: every span has card ms, the trace holds the spans as
    `gpu_user_annotation` events, and `mlp_sdf.ROWS` counts the rows the
    shapes launch (the value pass dense over every ray's samples, the
    Jacobian over the surface points and the render term's K slots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dec = deepsdf.load_npz(FIXTURE, device="cuda")
    cfg = opt.ReconConfig.gpu_fast(num_iterations=4, coarse_iterations=2)
    batch = _batch("cuda")
    opt.reconstruct_objects_batched(dec, cfg, *batch, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    timers.clear()
    mlp_sdf.reset_launch_counts()
    with timers.profiler_trace(str(tmp_path)):
        opt.reconstruct_objects_batched(dec, cfg, *batch, compute_dtype=torch.bfloat16)
    sp = timers.spans()
    assert [s.name for s in sp] == ["recon.fit"] + ["recon.gn", "recon.normal"] * 4
    assert all(s.device_ms is not None and s.device_ms > 0 for s in sp)
    R_f = math.ceil(R * cfg.active_ray_fraction)
    want = {"mlp_sdf_jacobian": 4 * B * (N + cfg.max_grad_points),
            "mlp_sdf_value": B * (2 * R * cfg.coarse_samples + 2 * R_f * cfg.num_depth_samples)}
    assert sp[0].attrs["rows"] == want == {k: v for k, v in mlp_sdf.ROWS.items() if v}
    assert sp[0].attrs["launches"] == {"mlp_sdf_jacobian": 8, "mlp_sdf_value": 4}
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    gpu = [e["name"] for e in events if e.get("cat") == "gpu_user_annotation"]
    assert gpu.count("recon.gn") == gpu.count("recon.normal") == 4
    assert gpu.count("recon.fit") == 1
