"""`correct` comes out false when the timed path is broken underneath, and
when the control stands in for the program; true for the sound program.

Each cell runs at a test size on the CPU (`tiny.py`) through the driver the
harness uses, past the harness's look for a card, and is judged by the
cell's own limits (`workloads/<cell>.json`).  Every answer of the window is
compared (the sample covers every object), as on the card a sample does."""
from __future__ import annotations

import pytest
import torch

import tiny
from benchmark import run as harness

FIT_CELLS = ["recon_b128.gpu_fast", "recon_b8.f32"]
GBA_CELLS = ["gba_kitti00.f32"]


def _judge(c, d):
    d.window(0.0)
    d.window(0.0)     # every pool batch once
    d.release()
    return harness.judge(d.check(), c["cell"]["checks"])[0]


def _fit_cell(name, objects=4):
    return tiny.fit_cell(name, iterations=4, objects=objects, pool=8 // objects, check=8)


def _broken_fit(kind, real):
    from dsp_slam_rgbd_tpu_torch.recon.optimizer import ReconResult

    def fit(decoder, cfg, t, *args, **kw):
        B = t.shape[0]
        if kind == "unchanged":
            return ReconResult(t, torch.zeros(B, cfg.code_len), torch.ones(B, dtype=torch.bool),
                               torch.zeros(B))
        if kind == "half":
            h = B // 2
            r = real(decoder, cfg, t[:h], *(a[:h] for a in args), **kw)
            return ReconResult(torch.cat([r.t_cam_obj, t[h:]]),
                               torch.cat([r.code, torch.zeros(B - h, cfg.code_len)]),
                               torch.cat([r.is_good, torch.ones(B - h, dtype=torch.bool)]),
                               torch.cat([r.loss, r.loss[:1].expand(B - h)]))
        # "altered": a quarter of the batch answered with the next object's
        # fit; "one_in_eight": one object in eight
        r = real(decoder, cfg, t, *args, **kw)
        src = torch.arange(B)
        src[:max(1, B // (4 if kind == "altered" else 8))] += 1
        return ReconResult(*(x[src] for x in r))
    return fit


@pytest.mark.parametrize("name", FIT_CELLS)
def test_sound_fit_is_correct(name):
    c = _fit_cell(name)
    assert _judge(c, tiny.driver(c, 31))


@pytest.mark.parametrize("name", FIT_CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "one_in_eight"])
def test_broken_fit_is_not_correct(name, kind, monkeypatch):
    from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt

    c = _fit_cell(name, objects=8 if kind == "one_in_eight" else 4)
    monkeypatch.setattr(opt, "reconstruct_objects_batched",
                        _broken_fit(kind, opt.reconstruct_objects_batched))
    assert not _judge(c, tiny.driver(c, 31))


@pytest.mark.parametrize("name", FIT_CELLS)
def test_fit_control_is_not_correct(name):
    c = _fit_cell(name)
    d = tiny.driver(c, 31)
    d.window(0.0)
    d.window(0.0)
    d.release()
    assert not harness.judge(d.check(control=True), c["cell"]["checks"])[0]


def _broken_ba(kind, real):
    def step(state, cam, n_iters=10, **kw):
        if kind == "unchanged":
            return state
        out = real(state, cam, n_iters, **kw)
        if kind == "half":
            K = int(state.kf_valid.sum())
            kf = out.kf_pose.clone()
            kf[K // 2:] = state.kf_pose[K // 2:]
            return out._replace(kf_pose=kf)
        kf = out.kf_pose.clone()     # "altered": one keyframe moved 0.2 m
        kf[K_ALTERED, 0, 3] += 0.2
        return out._replace(kf_pose=kf)
    return step


K_ALTERED = 50


@pytest.mark.parametrize("name", GBA_CELLS)
def test_sound_ba_is_correct(name):
    c = tiny.gba_cell(name)
    assert _judge(c, tiny.driver(c, 8))


@pytest.mark.parametrize("name", GBA_CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_ba_is_not_correct(name, kind, monkeypatch):
    from dsp_slam_rgbd_tpu_torch.mapping import local_mapping

    c = tiny.gba_cell(name)
    monkeypatch.setattr(local_mapping, "global_ba_step",
                        _broken_ba(kind, local_mapping.global_ba_step))
    assert not _judge(c, tiny.driver(c, 8))


@pytest.mark.parametrize("name", GBA_CELLS)
def test_ba_control_is_not_correct(name):
    c = tiny.gba_cell(name)
    d = tiny.driver(c, 8)
    d.window(0.0)
    d.release()
    assert not harness.judge(d.check(control=True), c["cell"]["checks"])[0]
