"""The port's data generators (``generate/``) against the JAX package's: the
same seeds and meshes through both packages' mesh CLI, built-in projection
solver, refinement tool, OpenFOAM staging and conversion, and the gmsh branch
through one recording stand-in for the ``gmsh`` module that both call.

Tolerance: none. Every generator is numpy/scipy host code that the port
keeps as a copy, on the same connectivity tables (the C++ builder or numpy,
bit-equal), so arrays and texts are compared for equality; the HDF5 files
are compared as each package's ``load_dataset`` reads them.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest

from gnn_fluid_dynamics_tpu.data.hdf5 import load_dataset as jax_load
from gnn_fluid_dynamics_tpu.data.node_types import NodeType as JaxNodeType
from gnn_fluid_dynamics_tpu.data.synthetic import (
    make_geometry as jax_make_geometry,
    structured_channel_mesh as jax_structured)
from gnn_fluid_dynamics_tpu.generate import conversion as jconv
from gnn_fluid_dynamics_tpu.generate import foam as jfoam
from gnn_fluid_dynamics_tpu.generate import mesh as jmesh
from gnn_fluid_dynamics_tpu.generate import mesh_refine as jrefine
from gnn_fluid_dynamics_tpu.generate import simulation as jsim
from gnn_fluid_dynamics_tpu.ops.connectivity import (
    build_geometry as jax_build_geometry)

from gnn_fluid_dynamics_tpu_torch.data.hdf5 import load_dataset
from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.data.synthetic import (
    make_geometry, structured_channel_mesh)
from gnn_fluid_dynamics_tpu_torch.generate import conversion as conv
from gnn_fluid_dynamics_tpu_torch.generate import foam
from gnn_fluid_dynamics_tpu_torch.generate import mesh as gmesh
from gnn_fluid_dynamics_tpu_torch.generate import mesh_refine as refine
from gnn_fluid_dynamics_tpu_torch.generate import simulation as sim
from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry

FIELDS = ("cell_velocity", "cell_pressure", "face_velocity", "face_pressure",
          "face_flux")


def _assert_same_npz(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_trajectories(got, want):
    assert [t.mesh_id for t in got] == [t.mesh_id for t in want]
    for g, w in zip(got, want):
        assert g.dt == w.dt and g.reynolds == w.reynolds
        assert sorted(g.geom) == sorted(w.geom)
        for k in w.geom:
            np.testing.assert_array_equal(g.geom[k], w.geom[k], err_msg=k)
        assert sorted(g.fields) == sorted(w.fields)
        for k in w.fields:
            np.testing.assert_array_equal(g.fields[k], w.fields[k], err_msg=k)


@pytest.mark.parametrize("regime", ["viscosity", "inflow"])
def test_random_case_params_and_cfl_dt(regime):
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        pj = jmesh.random_case_params(rj, regime=regime)
        pt = gmesh.random_case_params(rt, regime=regime)
        assert pt == pj
        for h in (0.03, 0.08):
            assert gmesh.cfl_dt(pt, h) == jmesh.cfl_dt(pj, h)


@pytest.mark.parametrize("args", [
    ["--num", "2", "--h", "0.08", "--regime", "inflow", "--dt", "0.01",
     "--seed", "0"],
    ["--num", "2", "--h", "0.1", "--seed", "5"]])
def test_mesh_main_matches_jax(tmp_path, args):
    jmesh.main(args + ["--out", str(tmp_path / "j")])
    gmesh.main(args + ["--out", str(tmp_path / "t")])
    for i in range(2):
        case = f"mesh_{i}"
        _assert_same_npz(tmp_path / "t" / case / "mesh.npz",
                         tmp_path / "j" / case / "mesh.npz")
        assert ((tmp_path / "t" / case / "meta.json").read_text()
                == (tmp_path / "j" / case / "meta.json").read_text())


def _obstacle_case(pkg_make_geometry):
    geom = pkg_make_geometry("cylinder", n_points=500, seed=3)
    params = {"u_in": 1.0, "rx": 0.1, "ry": 0.1, "Re": 100.0,
              "ly": float(geom["vertex_pos"][:, 1].max()), "dt": 0.01}
    return geom, params


@pytest.mark.parametrize("mesh", ["structured", "obstacle"])
def test_simulate_projection_matches_jax(mesh):
    """The built-in solver on JAX ``tests/test_generate.py:36-56``'s
    structured channel and on an obstacle mesh: every saved field equal,
    bit for bit (the same numpy/scipy arithmetic on the same tables)."""
    if mesh == "structured":
        params = {"u_in": 1.0, "Re": 150.0, "rx": 0.1, "ly": 1.0, "dt": 0.03}
        pj = jax_structured(nx=20, ny=10)
        pt = structured_channel_mesh(nx=20, ny=10)
        gj = jax_build_geometry(*pj, JaxNodeType)
        gt = build_geometry(*pt, NodeType)
        steps, every, spinup = 30, 1, 0
    else:
        gj, params = _obstacle_case(jax_make_geometry)
        gt, _ = _obstacle_case(make_geometry)
        steps, every, spinup = 12, 2, 2
    want = jsim.simulate_projection(gj, params, steps, save_every=every,
                                    spinup_saves=spinup)
    got = sim.simulate_projection(gt, params, steps, save_every=every,
                                  spinup_saves=spinup)
    assert sorted(got) == sorted(want) == sorted(FIELDS)
    for k in FIELDS:
        assert got[k].shape[0] == steps
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the saved flux is discretely divergence-free
    flux = got["face_flux"][-1][:, 0].astype(np.float64)
    div = np.abs((flux[gt["face_index"].T] * gt["cell_face_sign"]).sum(1))
    assert div.max() < 1e-6


def test_mesh_refine_matches_jax(tmp_path):
    pos, cells, vt = structured_channel_mesh(nx=5, ny=3)
    got = refine.refine_uniform(pos, cells, vt)
    want = jrefine.refine_uniform(pos, cells, vt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    f = np.sin(pos[:, 0]) + pos[:, 1]
    np.testing.assert_array_equal(
        refine.prolongate_vertex_field(f, pos, cells),
        jrefine.prolongate_vertex_field(f, pos, cells))
    assert (refine.quality_report(*got[:2])
            == jrefine.quality_report(*want[:2]))
    src = tmp_path / "mesh_0"
    src.mkdir()
    np.savez(src / "mesh.npz", vertex_pos=pos, cells=cells, vertex_types=vt)
    (src / "meta.json").write_text(json.dumps({"Re": 100.0, "dt": 0.01}))
    jrefine.main(["--mesh", str(src), "--out", str(tmp_path / "j"),
                  "--levels", "2"])
    refine.main(["--mesh", str(src), "--out", str(tmp_path / "t"),
                 "--levels", "2"])
    _assert_same_npz(tmp_path / "t" / "mesh.npz", tmp_path / "j" / "mesh.npz")
    assert ((tmp_path / "t" / "meta.json").read_text()
            == (tmp_path / "j" / "meta.json").read_text())


def _small_mesh():
    pos, cells, vt = structured_channel_mesh(nx=8, ny=5)
    return {"vertex_pos": pos, "cells": cells, "vertex_types": vt}


def test_foam_texts_match_jax(tmp_path):
    mesh = _small_mesh()
    got = foam.write_msh2_extruded(**mesh, path=str(tmp_path / "t.msh"))
    want = jfoam.write_msh2_extruded(**mesh, path=str(tmp_path / "j.msh"))
    assert got == want
    assert (tmp_path / "t.msh").read_text() == (tmp_path / "j.msh").read_text()
    edges = foam._boundary_edges(mesh["cells"])
    np.testing.assert_array_equal(
        foam.classify_boundary_edges(edges, mesh["vertex_pos"],
                                     mesh["vertex_types"]),
        jfoam.classify_boundary_edges(edges, mesh["vertex_pos"],
                                      mesh["vertex_types"]))
    sample = "".join(
        f"    {name}\n    {{\n        type            patch;\n"
        f"        physicalType    patch;\n        nFaces          {n};\n    }}\n"
        for name, n in (("frontAndBack", 100), ("walls", 40),
                        ("obstacle", 24), ("inlet", 8), ("outlet", 8)))
    sample = f"5\n(\n{sample})\n"
    assert foam.patch_boundary_file(sample) == jfoam.patch_boundary_file(sample)
    assert "type            empty;" in foam.patch_boundary_file(sample)
    for name, mod in (("t", foam), ("j", jfoam)):
        p = tmp_path / f"{name}.dict"
        p.write_text("deltaT 1;\nendTime    5;\n")
        mod.set_foam_entry(str(p), "deltaT", 0.01)
        mod.set_foam_entry(str(p), "writeInterval", 0.02)
    assert (tmp_path / "t.dict").read_text() == (tmp_path / "j.dict").read_text()


@pytest.mark.skipif(shutil.which("gmshToFoam") is not None,
                    reason="OpenFOAM present; staging would go on to convert")
@pytest.mark.parametrize("template", ["laminar_ellipse", "taylor_green",
                                      "turbulent", "manufactured"])
def test_stage_case_without_openfoam(tmp_path, template):
    """Staging copies the port's own template, writes the mesh and the dict
    entries, then stops with the JAX package's message; the staged case is
    the JAX package's, file for file."""
    params = {"u_in": 1.0, "rx": 0.1, "Re": 400.0, "dt": 0.01}
    here = os.path.join(os.path.dirname(foam.__file__), "openfoam", template)
    there = os.path.join(os.path.dirname(jfoam.__file__), "openfoam", template)
    assert "gnn_fluid_dynamics_tpu_torch" in here
    for name, mod, src in (("t", foam, here), ("j", jfoam, there)):
        with pytest.raises(RuntimeError, match="OpenFOAM not installed"):
            mod.stage_case(src, str(tmp_path / name), _small_mesh(), params,
                           num_steps=100)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "t")
        for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    for rel in files:
        assert ((tmp_path / "t" / rel).read_bytes()
                == (tmp_path / "j" / rel).read_bytes()), rel
    tp = (tmp_path / "t" / "constant" / "transportProperties").read_text()
    assert "nu [0 2 -1 0 0 0 0] 0.0005" in tp


def test_openfoam_backend_stops_without_openfoam(tmp_path):
    """``run_openfoam_case`` stages and then stops where OpenFOAM is absent,
    as the JAX package's does."""
    if shutil.which("gmshToFoam") is not None:
        pytest.skip("OpenFOAM present")
    template = os.path.join(os.path.dirname(sim.__file__), "openfoam",
                            "laminar_ellipse")
    params = {"u_in": 1.0, "rx": 0.1, "Re": 400.0, "dt": 0.01}
    with pytest.raises(RuntimeError, match="OpenFOAM not installed"):
        sim.run_openfoam_case(template, str(tmp_path / "case"), _small_mesh(),
                              params, 10)
    assert sim.have_openfoam() == jsim.have_openfoam()


def _write_case(meshes, i, nx, ny):
    pos, cells, vt = structured_channel_mesh(nx=nx, ny=ny)
    case = os.path.join(meshes, f"mesh_{i}")
    os.makedirs(case)
    np.savez(os.path.join(case, "mesh.npz"), vertex_pos=pos, cells=cells,
             vertex_types=vt)
    with open(os.path.join(case, "meta.json"), "w") as f:
        json.dump({"u_in": 1.0, "Re": 150.0, "rx": 0.1, "ly": 1.0,
                   "lx": 2.0, "cx": 0.5, "cy": 0.5, "ry": 0.1,
                   "angle": 0.0, "dt": 0.03}, f)


def test_simulation_and_conversion_main_match_jax(tmp_path, capsys):
    """The CLIs end to end: both simulation CLIs (sharded 2 ways, with
    the resume marker) write the same ``fields.npz`` and ``meta.json``;
    both conversion CLIs write HDF5 files that both packages'
    ``load_dataset`` read equal; ``convert_case`` in memory is the file's
    trajectory."""
    meshes = str(tmp_path / "m")
    for i, (nx, ny) in enumerate([(12, 6), (10, 5), (9, 6)]):
        _write_case(meshes, i, nx, ny)
    for name, mod in (("j", jsim), ("t", sim)):
        for shard in ("0", "1"):
            mod.main(["--meshes", meshes, "--out", str(tmp_path / name / "raw"),
                      "--steps", "4", "--backend", "builtin", "--spinup", "1",
                      "--spinup-crossings", "0.05", "--shard-index", shard,
                      "--num-shards", "2"])
    for i in range(3):
        case = f"mesh_{i}"
        _assert_same_npz(tmp_path / "t/raw" / case / "fields.npz",
                         tmp_path / "j/raw" / case / "fields.npz")
        for f in ("meta.json",):
            assert ((tmp_path / "t/raw" / case / f).read_text()
                    == (tmp_path / "j/raw" / case / f).read_text())
        assert (tmp_path / "t/raw" / case / "time.log").exists()
        assert not (tmp_path / "t/raw" / case / "fields.tmp.npz").exists()
    capsys.readouterr()
    sim.main(["--meshes", meshes, "--out", str(tmp_path / "t" / "raw"),
              "--steps", "4", "--backend", "builtin"])
    assert capsys.readouterr().out.count("already done, skipping") == 3

    subsets = tmp_path / "subsets.json"
    subsets.write_text(json.dumps({"train": [0, 2], "valid": [1]}))
    for name, mod in (("j", jconv), ("t", conv)):
        mod.main(["--raw", str(tmp_path / name / "raw"), "--meshes", meshes,
                  "--out", str(tmp_path / name / "h5"),
                  "--subsets", str(subsets)])
    for subset in ("train", "valid"):
        jpath = str(tmp_path / "j" / "h5" / f"{subset}.h5")
        tpath = str(tmp_path / "t" / "h5" / f"{subset}.h5")
        want = jax_load(jpath)
        _assert_same_trajectories(load_dataset(tpath), want)
        _assert_same_trajectories(jax_load(tpath), want)
        _assert_same_trajectories(load_dataset(jpath), want)
    mem = conv.convert_case(str(tmp_path / "t/raw/mesh_2"),
                            os.path.join(meshes, "mesh_2"), "mesh_1")
    _assert_same_trajectories([mem], [load_dataset(
        str(tmp_path / "t/h5/train.h5"))[1]])


class _FakeGmsh(types.ModuleType):
    """A stand-in for the ``gmsh`` module: records every call by its dotted
    name and arguments, and meshes a structured channel (node tags from
    101, shuffled) when asked for nodes and elements."""

    def __init__(self, calls, pos, cells):
        super().__init__("gmsh")
        self._calls, self._pos, self._cells = calls, pos, cells
        rng = np.random.default_rng(0)
        self._tags = 101 + rng.permutation(pos.shape[0])

    def _call(self, name, *args, **kwargs):
        self._calls.append((name, repr(args), repr(sorted(kwargs.items()))))
        if name == "model.occ.cut":
            return [(2, 1)], []
        if name == "model.getBoundary":
            return [(1, 1), (1, 2), (1, 3)]
        if name == "model.mesh.field.add":
            return sum(1 for c in self._calls if c[0] == name)
        if name == "model.mesh.getNodes":
            coords = np.zeros((self._pos.shape[0], 3))
            coords[:, :2] = self._pos
            return self._tags, coords.reshape(-1), None
        if name == "model.mesh.getElements":
            return [2], None, [self._tags[self._cells].reshape(-1)]
        return 1

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _FakeNamespace(self, name)


class _FakeNamespace:
    def __init__(self, root, path):
        self._root, self._path = root, path

    def __getattr__(self, name):
        return _FakeNamespace(self._root, f"{self._path}.{name}")

    def __call__(self, *args, **kwargs):
        return self._root._call(self._path, *args, **kwargs)


def test_gmsh_branch_matches_jax(monkeypatch):
    """With ``gmsh`` importable (one recording stand-in that both packages
    call), ``generate_mesh`` takes the gmsh branch in both: the same calls
    with the same arguments, in order, and the same (pos, cells, vertex
    types)."""
    params = jmesh.random_case_params(np.random.default_rng(0),
                                      regime="inflow")
    params = {**params, "lx": 2.0, "ly": 1.0}
    pos, cells, _ = structured_channel_mesh(nx=10, ny=6, lx=2.0, ly=1.0)
    out = {}
    for name, mod in (("j", jmesh), ("t", gmesh)):
        calls = []
        monkeypatch.setitem(sys.modules, "gmsh", _FakeGmsh(calls, pos, cells))
        assert mod.have_gmsh()
        out[name] = (calls, mod.generate_mesh(params, h=0.05))
    (jcalls, jres), (tcalls, tres) = out["j"], out["t"]
    assert tcalls == jcalls
    assert jcalls[0][0] == "initialize" and jcalls[-1][0] == "finalize"
    assert [c[0] for c in jcalls].count("model.mesh.field.add") == 4
    for g, w in zip(tres, jres):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tres[0], pos)
    assert set(np.unique(tres[2])) <= {int(t) for t in NodeType}
