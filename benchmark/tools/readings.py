"""Readings that the limits of `correct` are set from, on the card.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1 2 3 [--seconds 3]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then the comparison numbers of the program against the
plain reference (the lower reading) and of the control, the reference in
the precision below the configuration's, against it (the upper reading).
One JSON line a seed; the runs of the benchmark itself never run the
control.
"""
from __future__ import annotations

import argparse
import importlib
import json
import time

import torch

from benchmark import run as harness


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    c = harness.find_cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(f"card: {harness.card_line()}", flush=True)
    drv = importlib.import_module("benchmark.drivers." + c["traffic"]["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        d = drv.Driver(harness.ROOT, c["config"], c["traffic"], c["cell"], seed,
                       torch.device("cuda", 0))
        d.warm()
        win = d.window(args.seconds)
        d.release()
        t1 = time.perf_counter()
        line = {"seed": seed, "units": win["units"], "metrics": win["metrics"],
                "program": d.check(detail=True)}
        t2 = time.perf_counter()
        line["control"] = d.check(control=True, detail=True)
        line["seconds"] = {"run": t1 - t0, "check": t2 - t1, "control": time.perf_counter() - t2}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
