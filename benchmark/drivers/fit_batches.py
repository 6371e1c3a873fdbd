"""Closed loop of batched object fits through the port's
`recon/optimizer.py::reconstruct_objects_batched`.

Set-up loads the decoder from its raw file, builds a pool of
`pool_batches` input batches from the seed (`traffic/ellipsoid.py`) on the
card and fits two of them, which builds and loads every kernel.  The window
then sends the pool's batches back to back, in turn, with no host read: a
CUDA event after each batch marks its completion.  Every fit starts from
its generated initial pose and a zero code, so the work of a batch does not
depend on the batches before it.

Afterwards `check` draws `check_objects` objects from the seed among the
pool batches that the window ran, fits them with the plain reference from
the same inputs, and holds every answer the window gave for them to it.
"""
from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from benchmark.drivers import clock
from benchmark.reference import compare
from benchmark.reference import recon as ref_recon
from benchmark.reference.decoder import PlainDecoder
from benchmark.traffic import ellipsoid
from benchmark.yardstick import flops, stats, trace

SAMPLE_STREAM = 0x5EED


def weights_path(root: str, decoder: dict) -> str:
    """The decoder's raw file, checked against the configuration's hash."""
    path = os.path.join(root, decoder["weights"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != decoder["weights_sha256"]:
        raise RuntimeError(f"{decoder['weights']}: sha256 {digest}, the configuration "
                           f"states {decoder['weights_sha256']}")
    return path


class Driver:
    def __init__(self, root, config, traffic, cell, seed, dev):
        from dsp_slam_rgbd_tpu_torch.models import deepsdf
        from dsp_slam_rgbd_tpu_torch.recon import optimizer as opt

        self.config, self.traffic, self.cell, self.seed, self.dev = config, traffic, cell, seed, dev
        self.path = weights_path(root, config["decoder"])
        self.recon = {**config["optimizer"], **config["preset"]}
        self.opt = opt
        self.rcfg = opt.ReconConfig(**self.recon)
        self.dtype = getattr(torch, config["compute_dtype"])
        self.decoder = deepsdf.load_npz(self.path, device=dev)
        self.pool_np = ellipsoid.make_pool(traffic, seed)
        B, N, R = (int(traffic[k]) for k in ("objects_per_batch", "points", "rays"))
        self.B = B
        self.pool = [(torch.as_tensor(p["T_init"], device=dev),
                      torch.as_tensor(p["pts"], device=dev),
                      torch.ones(B, N, dtype=torch.bool, device=dev),
                      torch.as_tensor(p["rays"], device=dev),
                      torch.ones(B, R, dtype=torch.bool, device=dev),
                      torch.as_tensor(p["depth"], device=dev),
                      torch.as_tensor(p["fg_mask"], device=dev)) for p in self.pool_np]
        self.results = []
        w_bytes = 2 if self.dtype == torch.bfloat16 else 4
        dec = config["decoder"]
        self.work = {"value_pass": flops.value_pass_work(dec, self.recon, B, R, w_bytes),
                     "model_flops": flops.model_flops_per_batch(dec, self.recon, B, N, R),
                     "compute_dtype": config["compute_dtype"]}

    def fit(self, i):
        return self.opt.reconstruct_objects_batched(self.decoder, self.rcfg, *self.pool[i],
                                                    compute_dtype=self.dtype)

    def warm(self):
        for i in range(min(2, len(self.pool))):
            self.fit(i)
            clock.sync(self.dev)

    def window(self, seconds: float) -> dict:
        P = len(self.pool)
        clock.sync(self.dev)
        marks = [clock.mark(self.dev)]
        t0 = time.perf_counter()
        k = 0
        while k == 0 or time.perf_counter() - t0 < seconds:
            self.results.append((k % P, self.fit(k % P)))
            marks.append(clock.mark(self.dev))
            k += 1
        clock.sync(self.dev)
        wall = time.perf_counter() - t0
        gaps_ms = [clock.elapsed_ms(a, b) for a, b in zip(marks[:-1], marks[1:])]
        self.unit_s = wall / k
        good = torch.stack([r.is_good for _, r in self.results])
        return {"metrics": {"fits_per_s": k * self.B / wall, "fit_batch_p95_ms": stats.p95(gaps_ms)
                            if k >= 20 else None},
                "attempted": k * self.B, "failed": int((~good).sum()), "units": k, "wall_s": wall}

    def trace(self) -> tuple[dict, int]:
        n, P = int(self.cell["trace_batches"]), len(self.pool)
        return trace.profile(lambda: [self.fit(i % P) for i in range(n)]), n

    def release(self):
        """Keeps the window's answers; frees the program's state."""
        self.results = [(p, tuple(t.detach() for t in r)) for p, r in self.results]
        self.decoder = self.pool = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        used = sorted({p for p, _ in self.results})
        cand = [(p, o) for p in used for o in range(self.B)]
        rng = np.random.default_rng((self.seed, SAMPLE_STREAM))
        pick = rng.choice(len(cand), size=min(int(self.cell["check_objects"]), len(cand)),
                          replace=False)
        return [cand[i] for i in sorted(pick)]

    def _reference(self, sample, precision, products):
        dev = self.dev
        take = lambda k, dt=None: torch.as_tensor(  # noqa: E731
            np.stack([self.pool_np[p][k][o] for p, o in sample]), dtype=dt, device=dev)
        n, N, R = len(sample), int(self.traffic["points"]), int(self.traffic["rays"])
        dec = PlainDecoder(self.path, dev, precision)
        return ref_recon.fit(dec, self.recon, take("T_init"), take("pts"),
                             torch.ones(n, N, dtype=torch.bool, device=dev), take("rays"),
                             torch.ones(n, R, dtype=torch.bool, device=dev), take("depth"),
                             take("fg_mask"), products=products)

    def check(self, control: bool = False, detail: bool = False) -> dict:
        """The numbers that decide `correct` (see `reference/compare.py`): the
        window's answers against the reference, or with `control` the
        control (the reference in the precision below) against it.  With
        `detail`, the per-object gaps too."""
        sample = self._sample()
        prec = self.config["precision"]
        ref = self._reference(sample, prec["reference"], "f32")
        if control:
            ctl = self._reference(sample, prec["control"], prec["control_products"])
            outs = [(torch.arange(len(sample), device=self.dev), ctl)]
        else:
            rows_of = {}
            for j, (p, o) in enumerate(sample):
                rows_of.setdefault(p, []).append((j, o))
            outs = []
            for p, r in self.results:
                if p in rows_of:
                    j, o = (torch.tensor(v, device=self.dev) for v in zip(*rows_of[p]))
                    outs.append((j, tuple(t[o] for t in r)))
        gap, counts = compare.fit_object_gaps(ref, outs)
        out = compare.fit_numbers(gap, counts, self.cell["over"])
        if detail:
            out["objects"] = {k: v.tolist() for k, v in gap.items()}
        return out
