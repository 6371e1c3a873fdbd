"""Test sizes of the benchmark's cells for the CPU: the cells' own
configurations with fewer iterations, objects, points and rays, or a
smaller corridor (past the port's dense-BA limit of 96 pose blocks, so the
PCG path runs)."""
from __future__ import annotations

import copy
import json
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def bench():
    return load("BENCHMARK.json")


def cell(name: str) -> dict:
    """{config, traffic, cell} of a cell of BENCHMARK.json."""
    w = next(w for w in bench()["workloads"] if w["name"] == name)
    cfg = next(c for c in bench()["configs"] if c["name"] == w["config"])
    return {"config": load(cfg["file"]),
            "traffic": load("benchmark", "traffic", w["traffic"] + ".json"),
            "cell": load("benchmark", "workloads", name + ".json")}


def fit_cell(name: str, iterations: int = 2, objects: int = 4, points: int = 32,
             rays: int = 64, pool: int = 2, check: int = 4) -> dict:
    c = copy.deepcopy(cell(name))
    c["config"]["optimizer"]["num_iterations"] = iterations
    c["traffic"].update(objects_per_batch=objects, points=points, rays=rays, pool_batches=pool)
    c["cell"].update(check_objects=check, trace_batches=1)
    return c


def gba_cell(name: str, keyframes: int = 100, points: int = 900, features: int = 60) -> dict:
    c = copy.deepcopy(cell(name))
    c["config"]["map"].update(keyframes=keyframes, points=points, features_per_keyframe=features,
                              max_kf=128, max_pts=8192)
    return c


def driver(c: dict, seed: int):
    import importlib

    mod = importlib.import_module("benchmark.drivers." + c["traffic"]["driver"])
    return mod.Driver(ROOT, c["config"], c["traffic"], c["cell"], seed, CPU)
