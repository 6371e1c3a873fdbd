"""The benchmark of the PyTorch/CUDA port `dsp_slam_rgbd_tpu_torch`.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cell's cards.  The
cell is an entry of `BENCHMARK.json`'s `workloads`: its configuration
(`configs/<config>.json`), its traffic (`traffic/<traffic>.json`, whose
`driver` names the module of `drivers/` that drives it) and its own file
(`workloads/<cell>.json`: the limits of its correctness numbers, the
thresholds of its shares and how many answers they are read over).  An
end-to-end metric `<quantity>.<qualifier>` is the driver's `<quantity>` in
the cells it lists; a per-layer metric `<quantity>` or
`<quantity>.<qualifier>` is read by `metrics/<quantity>.py` in the cells it
lists.  Adding a cell, a configuration, a traffic mix or a metric adds
files and entries; no code here names one.

A run: set-up (inputs from the seed, the program's kernels built and its
shapes warmed), the window of `--seconds`, the peak memory, a check that
no JAX module was loaded, with `--trace 1` a profiler trace of a few more
units of work, then the comparison with the plain reference
(`reference/`).  It prints the card's name and power limit, the numbers
compared beside their limits as the last lines of standard error, and one
JSON line as the last line of standard output: the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics.  Without enough CUDA
cards, or with JAX loaded, it prints no result and exits non-zero.
"""
from __future__ import annotations

import os
import sys


def _process_start() -> float:
    """The process's start on the clock of `time.time()` (Linux /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# build and kernel caches at fixed places inside the checkout; the port's
# nvcc builds stay in its own `csrc/_build/`
CACHE = os.path.join(HERE, "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dsp_slam_rgbd_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    """-> {workload, config (its file's contents), traffic, cell,
    end_to_end [entries], per_layer [entries]} for cell `name`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return {"workload": w, "config": load_json(ROOT, cfg["file"]),
            "traffic": load_json(HERE, "traffic", w["traffic"] + ".json"),
            "cell": load_json(HERE, "workloads", name + ".json"),
            "end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    """`metrics/<quantity>.py`'s `read(ctx)` for the metric `<quantity>` or
    `<quantity>.<qualifier>`."""
    base = name.split(".")[0]
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{base}",
                                                  os.path.join(HERE, "metrics", base + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def judge(gaps: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    missing = sorted(set(limits) - set(gaps))
    if missing:
        raise RuntimeError(f"no reading for the limits {missing}")
    ok = all(gaps[k] <= limits[k] for k in limits)   # False on a NaN
    checks = {k: {"value": gaps[k] if math.isfinite(gaps[k]) else repr(gaps[k]),
                  "limit": limits[k]} for k in limits}
    return ok, checks


def run(args, log=sys.stderr) -> dict:
    bench = load_json(ROOT, "BENCHMARK.json")
    c = find_cell(bench, args.workload)
    chips = int(c["workload"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA card(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    print(f"card: {card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    drv = importlib.import_module("benchmark.drivers." + c["traffic"]["driver"])
    d = drv.Driver(ROOT, c["config"], c["traffic"], c["cell"], args.seed, dev)
    d.warm()
    setup_s = time.time() - START
    print(f"set-up {setup_s:.3f} s", file=log, flush=True)
    win = d.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"window {win['wall_s']:.3f} s, {win['units']} units, {win['attempted']} attempted, "
          f"{win['failed']} failed", file=log, flush=True)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {found}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
              "memory_peak_bytes": int(peak)}
    out = {"correct": None, "attempted": win["attempted"], "failed": win["failed"]}
    units = {m["name"]: m["unit"] for m in c["end_to_end"] + c["per_layer"]}
    if args.trace:
        summary, n = d.trace()
        ctx = {"trace": summary, "units": n, "unit_s": d.unit_s, "device_name": device["kind"],
               "work": d.work}
        values = {m["name"]: reader(m["name"])(ctx) for m in c["per_layer"]}
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        print(f"trace: {n} units, {summary['launches']} launches {summary['launches_by_api']}, "
              f"{summary['n_device_ops']} device ops, busy {summary['busy_s']:.6f} s of "
              f"{summary['window_s']:.6f} s", file=log, flush=True)
    else:
        # `<quantity>.<qualifier>` (`fits_per_s.f32`) reads the driver's `<quantity>`
        values = dict(win["metrics"], setup_s=setup_s)
        values = {m["name"]: values.get(m["name"].split(".")[0]) for m in c["end_to_end"]}
        if any(v is None for v in values.values()):
            raise RuntimeError(f"no value for {[k for k, v in values.items() if v is None]}")
    out["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                      if v is not None}
    out["device"] = device
    d.release()
    correct, checks = judge(d.check(), c["cell"]["checks"])
    out["correct"] = correct
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=log, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    out = run(ap.parse_args(argv))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
