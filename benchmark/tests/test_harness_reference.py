"""The plain references against the port at test sizes on the CPU, where
the port runs its kernels' plain versions: the decoder row by row, one
Gauss-Newton iteration of a fit batch in both precisions, and the global
BA on the PCG path."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny
from benchmark.reference.decoder import PlainDecoder


@pytest.mark.parametrize("precision,dtype,tol", [("f32", torch.float32, 2e-5),
                                                 ("bf16", torch.bfloat16, 2e-2)])
def test_decoder_rows(precision, dtype, tol):
    from dsp_slam_rgbd_tpu_torch.models import deepsdf

    c = tiny.cell("recon_b8.f32")
    path = tiny.ROOT + "/" + c["config"]["decoder"]["weights"]
    port = deepsdf.load_npz(path, device="cpu")
    ref = PlainDecoder(path, "cpu", precision)
    rng = np.random.default_rng(0)
    code = torch.tensor(rng.standard_normal((3, 64)) * 0.5, dtype=torch.float32)
    xyz = torch.tensor(rng.uniform(-0.8, 0.8, (3, 200, 3)), dtype=torch.float32)
    v_p = port.query(code, xyz, dtype)
    s_p, j_p = port.query_with_jacobian(code, xyz, dtype)
    v_r = ref.value(code, xyz)
    s_r, j_r = ref.value_and_jacobian(code, xyz)
    assert float((v_p - v_r).abs().max()) <= tol
    assert float((s_p - s_r).abs().max()) <= tol
    scale = float(j_r.abs().max())
    assert float((j_p - j_r).abs().max()) <= tol * scale


@pytest.mark.parametrize("name,tol", [("recon_b8.f32", 1e-5), ("recon_b128.gpu_fast", 1e-5)])
def test_one_gauss_newton_iteration(name, tol):
    d = tiny.driver(tiny.fit_cell(name, iterations=1, objects=3, check=3), 21)
    d.window(0.0)
    d.release()
    g = d.check()
    assert g["good_mismatch"] == 0 and g["nonfinite"] == 0, g
    assert max(g["pose_max"], g["code_max"], g["loss_max"]) <= tol, g


def test_global_ba_pcg():
    d = tiny.driver(tiny.gba_cell("gba_kitti00.f32"), 4)
    d.window(0.0)
    d.release()
    g = d.check()
    assert g["nonfinite"] == 0 and max(g["kf_gap"], g["pt_gap"], g["cost_gap"]) <= 1e-5, g
