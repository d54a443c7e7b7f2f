"""The port stands alone: importing every module of repro_torch loads no
jax and nothing of the JAX package repro (checked in a fresh interpreter,
since this test process has both loaded)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    n_modules, bad = int(out[0]), out[1].strip()
    assert n_modules >= 34, n_modules      # serving + training slices
    assert bad == "[]", bad


_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "repro")))
"""


@pytest.mark.parametrize("module", [
    "repro_torch.nn.params", "repro_torch.parallel.sharding",
    "repro_torch.launch.mesh", "repro_torch.models.context",
    "repro_torch.launch.steps", "repro_torch.launch.train"])
def test_distribution_layer_imports_no_jax(module):
    """Each module of the distribution layer, imported alone in a fresh
    interpreter, loads no jax and nothing of repro."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ONE, module], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]", out
