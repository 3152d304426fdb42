"""The port imports neither JAX, Flax, optax, orbax nor the JAX package:
every module of ``gnn_fluid_dynamics_tpu_torch`` (and ``chip_smoke.py``) is
imported in a fresh interpreter, which must then hold none of them, nor
``h5py``, which only the HDF5 reader and writer import, when called."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHECK = r"""
import importlib, pkgutil, sys
import gnn_fluid_dynamics_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "h5py", "gnn_fluid_dynamics_tpu"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_never_imports_jax():
    res = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_importing_builds_nothing():
    """Kernels build at first launch, never on import."""
    code = ("import gnn_fluid_dynamics_tpu_torch.ops.kernels as k; "
            "import sys; sys.exit(1 if k._libs else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
