"""What the harness and the reference load: never JAX or the JAX package
(top-level module names compared whole, so the port's name, which begins
with the JAX package's, passes), and the reference nothing of the port."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import tiny

DRIVE = """
import sys, torch
sys.path.insert(0, {tests!r})
import tiny
from benchmark import run as h
for name in [w["name"] for w in tiny.bench()["workloads"]]:
    c = tiny.fit_cell(name, iterations=1) if "recon" in name else tiny.gba_cell(name)
    for m in h.find_cell(tiny.bench(), name)["per_layer"]:
        h.reader(m["name"])
    d = tiny.driver(c, 5)
    d.window(0.0)
    d.release()
    d.check()
print("FOUND", h.forbidden_modules(), sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys, numpy as np, torch
sys.path.insert(0, {tests!r})
import tiny
from benchmark.reference import ba, decoder, recon
from benchmark.traffic import corridor, ellipsoid
c = tiny.fit_cell("recon_b8.f32", iterations=1, objects=2)
p = ellipsoid.make_pool(c["traffic"], 3)[0]
dec = decoder.PlainDecoder(tiny.ROOT + "/" + c["config"]["decoder"]["weights"], "cpu")
t = lambda k: torch.as_tensor(p[k])
n, N, R = 2, c["traffic"]["points"], c["traffic"]["rays"]
recon.fit(dec, {{**c["config"]["optimizer"], **c["config"]["preset"]}}, t("T_init"), t("pts"),
          torch.ones(n, N, dtype=torch.bool), t("rays"), torch.ones(n, R, dtype=torch.bool),
          t("depth"), t("fg_mask"))
g = tiny.gba_cell("gba_kitti00.f32", keyframes=24, points=240)
f = corridor.build(g["config"]["map"], g["traffic"], 3)
ba.solve(ba.Problem(f, g["config"]["map"]["camera"], "cpu"), 2, 4, 3e-3)
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code.format(tests=os.path.dirname(__file__))],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_loads_no_jax():
    line = next(s for s in _run(DRIVE).splitlines() if s.startswith("FOUND"))
    found, top = line.split("] ", 1)
    assert found == "FOUND [", line
    assert "dsp_slam_rgbd_tpu_torch" in top and "'jax'" not in top


def test_reference_loads_nothing_of_the_program():
    line = next(s for s in _run(REFERENCE).splitlines() if s.startswith("TOP"))
    for name in ("dsp_slam_rgbd_tpu_torch", "dsp_slam_rgbd_tpu", "jax", "jaxlib", "flax"):
        assert f"'{name}'" not in line, line


def test_reference_sources_import_only_plain_libraries():
    allowed = {"__future__", "math", "numpy", "torch", "benchmark"}
    here = os.path.join(tiny.ROOT, "benchmark")
    for path in glob.glob(os.path.join(here, "reference", "*.py")) + \
            glob.glob(os.path.join(here, "traffic", "*.py")) + \
            glob.glob(os.path.join(here, "yardstick", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top in allowed or top in sys.stdlib_module_names, (path, n)
                if top == "benchmark":
                    assert n.split(".")[1] in ("reference", "yardstick", "traffic"), (path, n)
