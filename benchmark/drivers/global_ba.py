"""Back-to-back global bundle adjustments through the port's
`mapping/local_mapping.py::global_ba_step`, the loop stage's entry.

Set-up builds the configuration's corridor map from the seed
(`traffic/corridor.py`), puts it on the card and runs the call twice,
which builds the kernels and fixes the problem's capacity buckets.  Every
call of the window starts from that same perturbed map; each ends in the
call's own read of the problem's counts, so the host clock times whole
calls.  Afterwards `check` solves the same map once with the plain
reference and holds every call's keyframe poses and points to it.
"""
from __future__ import annotations

import time

import torch

from benchmark.drivers import clock
from benchmark.reference import ba as ref_ba
from benchmark.reference import compare
from benchmark.reference.precision import Products
from benchmark.traffic import corridor
from benchmark.yardstick import trace


class Driver:
    def __init__(self, root, config, traffic, cell, seed, dev):
        from dsp_slam_rgbd_tpu_torch.mapping import local_mapping
        from dsp_slam_rgbd_tpu_torch.ops.camera import Intrinsics
        from dsp_slam_rgbd_tpu_torch.weights import map_state_from_numpy

        self.config, self.cell, self.dev = config, cell, dev
        self.map = config["map"]
        self.ba = config["global_ba"]
        self.fields = corridor.build(self.map, traffic, seed)
        self.state = map_state_from_numpy(self.fields, dev)
        self.cam = Intrinsics(**self.map["camera"])
        self.lm = local_mapping
        self.outs = []
        self.work = {}

    def call(self):
        return self.lm.global_ba_step(self.state, self.cam, n_iters=int(self.ba["n_iters"]))

    def warm(self):
        for _ in range(2):
            self.call()
            clock.sync(self.dev)

    def window(self, seconds: float) -> dict:
        clock.sync(self.dev)
        t0 = time.perf_counter()
        k = 0
        while k == 0 or time.perf_counter() - t0 < seconds:
            out = self.call()
            self.outs.append((out.kf_pose, out.pt_pos))
            k += 1
        clock.sync(self.dev)
        wall = time.perf_counter() - t0
        self.unit_s = wall / k
        bad = sum(int(not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())))
                  for a, b in self.outs)
        return {"metrics": {"gba_ms": wall / k * 1e3}, "attempted": k, "failed": bad,
                "units": k, "wall_s": wall}

    def trace(self) -> tuple[dict, int]:
        return trace.profile(self.call), 1

    def release(self):
        self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False, detail: bool = False) -> dict:
        """The numbers that decide `correct` (see `reference/compare.py`): every
        call's map against the reference's, or with `control` the control
        (the reference with its products in the precision below) against it.
        The map has no per-object detail: `detail` is the fit driver's."""
        cam = {k: float(self.map["camera"][k]) for k in ("fx", "fy", "cx", "cy", "bf")}
        pr = ref_ba.Problem(self.fields, cam, self.dev)
        args = (int(self.ba["n_iters"]), int(self.ba["cg_iters"]), float(self.ba["damping"]))
        kf, pt, mask = ref_ba.solve(pr, *args)

        def cost(kf_pose, pts):
            return ref_ba.robust_cost(Products("f32"), pr, kf_pose, pts, mask)

        if control:
            kf_c, pt_c, _ = ref_ba.solve(pr, *args, products=self.config["precision"]["control"])
            outs = [(kf_c, pt_c)]
        else:
            outs = self.outs
        return compare.map_gaps(cost, (kf, pt), outs, pr.kf_valid, pr.pt_live & pr.observed)
