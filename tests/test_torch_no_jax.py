"""The port imports no JAX: every module of ``universal_differential_equations_torch``
imports in a fresh interpreter where ``import jax`` fails, and none of them
loads the JAX package."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import universal_differential_equations_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jaxlib", "optax", "universal_differential_equations_tpu"))
print(json.dumps(dict(names=names, leaked=leaked)))
"""


def test_every_module_of_the_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["leaked"] == []
    pkg = "universal_differential_equations_torch."
    for name in ("deepbsde.solver", "solvers.sde", "utils.profiling", "examples.hjb_100d",
                 "ops.stencil", "solvers.bdf", "examples.run_loops", "parallel",
                 "parallel.mesh", "parallel.distributed", "parallel.collectives",
                 "parallel.launch", "parallel.dryrun", "viz"):
        assert pkg + name in res["names"]
