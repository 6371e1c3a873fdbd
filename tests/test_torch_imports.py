"""The port imports neither JAX nor the JAX package.

Every `.py` under `dsp_slam_rgbd_tpu_torch/`, and `chip_smoke.py`, is parsed
with `ast` (nothing is executed) and each `import`/`from … import` is
checked: no `jax` (or `jaxlib`) module, and no `dsp_slam_rgbd_tpu` module
other than the port's own `dsp_slam_rgbd_tpu_torch`.  Relative imports
stay inside the port.  Imports inside functions count too.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dsp_slam_rgbd_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(PORT):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return out


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "dsp_slam_rgbd_tpu"


def imported_modules(source: str) -> list:
    """(line, module) of every absolute import in `source`."""
    mods = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            mods += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append((node.lineno, node.module))
    return mods


def test_the_checker_catches_each_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jax import lax\nimport os, jaxlib\n"
           "from dsp_slam_rgbd_tpu.models import deepsdf\nimport dsp_slam_rgbd_tpu\n"
           "def f():\n    from dsp_slam_rgbd_tpu.ops import lie\n"
           "from dsp_slam_rgbd_tpu_torch.ops import lie\nimport jaxtyping\n")
    bad = [ln for ln, m in imported_modules(src) if forbidden(m)]
    assert bad == [1, 2, 3, 4, 5, 6, 8]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    with open(path) as f:
        bad = [(ln, m) for ln, m in imported_modules(f.read()) if forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
