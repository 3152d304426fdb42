"""The port imports neither JAX, Flax, optax, orbax nor the JAX package:
every module of ``gnn_fluid_dynamics_tpu_torch`` (and ``chip_smoke.py``) is
imported in a fresh interpreter, which must then hold none of them, nor the
optional packages that only the functions needing them import, when called:
``h5py`` (the HDF5 reader and writer), ``tensorflow`` (the tfrecord
converter), ``tensorboard`` and ``wandb`` (the logger's sinks), ``gmsh``
(the mesh generator) and ``pyvista``. Importing them builds nothing: no
kernel library is loaded and no compiler is started."""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
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
                                    "h5py", "tensorflow", "tensorboard",
                                    "wandb", "gmsh", "pyvista",
                                    "gnn_fluid_dynamics_tpu"))
new = {"gnn_fluid_dynamics_tpu_torch." + m for m in (
    "native", "generate.mesh", "generate.mesh_refine", "generate.simulation",
    "generate.foam", "generate.conversion", "data.vtk_io", "data.openfoam",
    "data.cylinderflow", "data.preproc", "training.profiling",
    "training.diagnose", "training.sweep")}
missing = sorted(new - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 15 else 0)
"""


def test_port_never_imports_jax():
    res = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


BUILDS_NOTHING = r"""
import importlib, pkgutil, subprocess, sys
started = []
def record(name, real):
    def run(*args, **kwargs):
        started.append((name, args[:1]))
        return real(*args, **kwargs)
    return run
subprocess.run = record("run", subprocess.run)
subprocess.Popen = record("Popen", subprocess.Popen)
import gnn_fluid_dynamics_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from gnn_fluid_dynamics_tpu_torch import native
from gnn_fluid_dynamics_tpu_torch.ops import kernels
print(started, kernels._libs, native._lib, native._lib_failed)
sys.exit(1 if started or kernels._libs or native._lib is not None
         or native._lib_failed else 0)
"""


def test_importing_builds_nothing():
    """Kernels and the C++ graph builder build at first use, never on
    import: importing every module of the port starts no process and loads
    no library."""
    code = BUILDS_NOTHING
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
