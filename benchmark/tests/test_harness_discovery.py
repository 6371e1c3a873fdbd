"""A cell, a traffic mix and a per-layer metric added as files and entries
to a copy of the benchmark are found with no edit of its code; and a
checkout that holds only the benchmark cannot run it."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import tiny


def _copy(tmp_path):
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")


def _python(tmp_path, code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(tmp_path)))


def test_added_cell_and_metric_are_found(tmp_path):
    _copy(tmp_path)
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "recon_b4.f32", "config": "kitti_cars64_f32",
                           "traffic": "ellipsoid_b4", "chips": 1, "why": "a test cell"})
    for m in b["end_to_end"]:
        if m["name"] == "fits_per_s.f32":
            m["workloads"].append("recon_b4.f32")
    b["per_layer"].append({"name": "test_metric", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "fits_per_s.f32",
                           "workloads": ["recon_b4.f32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((tmp_path / "benchmark/traffic/ellipsoid_b8.json").read_text())
    traffic["objects_per_batch"] = 4
    (tmp_path / "benchmark/traffic/ellipsoid_b4.json").write_text(json.dumps(traffic))
    shutil.copy(tmp_path / "benchmark/workloads/recon_b8.f32.json",
                tmp_path / "benchmark/workloads/recon_b4.f32.json")
    (tmp_path / "benchmark/metrics/test_metric.py").write_text(
        "def read(ctx):\n    return 1000.0 * ctx['trace']['busy_s'] / ctx['units']\n")
    out = _python(tmp_path, (
        "from benchmark import run as h\n"
        "c = h.find_cell(h.load_json(h.ROOT, 'BENCHMARK.json'), 'recon_b4.f32')\n"
        "print(c['traffic']['objects_per_batch'], [m['name'] for m in c['end_to_end']],"
        " [m['name'] for m in c['per_layer']],"
        " h.reader('test_metric')({'trace': {'busy_s': 0.5}, 'units': 2}))\n"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4", "['fits_per_s.f32',", "'setup_s']", "['test_metric']",
                                  "250.0"]


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run exits non-zero and prints no result line."""
    _copy(tmp_path)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "gba_kitti00.f32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
