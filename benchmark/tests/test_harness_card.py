"""On the card, at each cell's own size: the program's readings within the
cell's limits and the control's outside them, on three seeds.

    python3 -m pytest -m cuda benchmark/tests/test_harness_card.py
"""
from __future__ import annotations

import importlib

import pytest
import torch

import tiny
from benchmark import run as harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in tiny.bench()["workloads"]])
def test_program_within_and_control_outside_the_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = tiny.cell(name)
    mod = importlib.import_module("benchmark.drivers." + c["traffic"]["driver"])
    for seed in (9001, 9002, 9003):
        d = mod.Driver(tiny.ROOT, c["config"], c["traffic"], c["cell"], seed,
                       torch.device("cuda", 0))
        d.warm()
        d.window(5.0)
        d.release()
        assert harness.judge(d.check(), c["cell"]["checks"])[0]
        assert not harness.judge(d.check(control=True), c["cell"]["checks"])[0]
