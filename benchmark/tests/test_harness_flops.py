"""The yardstick's row counts equal the rows the port's decoder is called
with, on both fit paths, and its FLOPs a row are the decoder's layers'."""
from __future__ import annotations

import pytest
import torch

import tiny
from benchmark.yardstick import flops


def test_flops_per_row_match_the_layers():
    from dsp_slam_rgbd_tpu_torch.models.deepsdf import DecoderSpec

    dec = tiny.cell("recon_b8.f32")["config"]["decoder"]
    spec = DecoderSpec(dec["latent_size"], tuple(dec["dims"]), tuple(dec["latent_in"]))
    assert flops.layer_dims(dec) == spec.layer_dims()
    assert flops.forward_flops_per_row(dec) == sum(2 * i * o for i, o in spec.layer_dims())


@pytest.mark.parametrize("name", ["recon_b128.gpu_fast", "recon_b8.f32"])
def test_rows_equal_the_decoder_calls(name):
    c = tiny.fit_cell(name, iterations=8, objects=2, points=16, rays=40)
    d = tiny.driver(c, 9)
    calls = []
    q, qj = d.decoder.query, d.decoder.query_with_jacobian

    def value(code, xyz, dtype=torch.float32):
        calls.append(("v", xyz.shape[:-1].numel()))
        return q(code, xyz, dtype)

    def jac(code, xyz, dtype=torch.float32):
        calls.append(("j", xyz.shape[:-1].numel()))
        return qj(code, xyz, dtype)

    d.decoder.query, d.decoder.query_with_jacobian = value, jac
    d.fit(0)
    recon, tr = d.recon, c["traffic"]
    B, N, R = tr["objects_per_batch"], tr["points"], tr["rays"]
    assert [n for k, n in calls if k == "v"] == flops.value_calls_and_rows(recon, B, R)
    jac_rows = [n for k, n in calls if k == "j"]
    assert sum(jac_rows[0::2]) == flops.surface_jacobian_rows(recon, B, N)
    assert sum(jac_rows[1::2]) == flops.render_jacobian_slots(recon, B)
    f = flops.forward_flops_per_row(c["config"]["decoder"])
    vf, _ = flops.value_pass_work(c["config"]["decoder"], recon, B, R, 2)
    assert vf == sum(flops.value_calls_and_rows(recon, B, R)) * f
    assert flops.model_flops_per_batch(c["config"]["decoder"], recon, B, N, R) == \
        vf + flops.surface_jacobian_rows(recon, B, N) * 2 * f
