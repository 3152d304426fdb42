"""The port's data tools against the JAX package's: the VTK XML reader and
writer (``data/vtk_io.py``), the OpenFOAM preprocessing
(``data/openfoam.py``), the DeepMind cylinder-flow converters
(``data/cylinderflow.py``), ``ops/geometry.py``'s ``interpolate_centroid``
and ``face_to_centroid``, and the preprocessing CLI (``data/preproc.py``)
for each of its four modules, on the same inputs made from seeds.

Tolerance: none for the host tools (numpy copies on the same connectivity
tables: arrays equal); ``face_to_centroid``, a mean of three f32 values on
tensors, within F2C_ULPS of the largest face value of the JAX package's
(XLA sums the three in another order: 1 ulp apart seen).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import base64
import json
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data import _write_wedge_case

from gnn_fluid_dynamics_tpu.data import cylinderflow as jcyl
from gnn_fluid_dynamics_tpu.data import openfoam as jof
from gnn_fluid_dynamics_tpu.data import preproc as jpreproc
from gnn_fluid_dynamics_tpu.data import vtk_io as jvtk
from gnn_fluid_dynamics_tpu.data.hdf5 import load_dataset as jax_load
from gnn_fluid_dynamics_tpu.generate import mesh as jmesh
from gnn_fluid_dynamics_tpu.generate import simulation as jsim
from gnn_fluid_dynamics_tpu.ops import geometry as jgeo

from gnn_fluid_dynamics_tpu_torch.data import cylinderflow as cyl
from gnn_fluid_dynamics_tpu_torch.data import openfoam as of
from gnn_fluid_dynamics_tpu_torch.data import preproc
from gnn_fluid_dynamics_tpu_torch.data import vtk_io as vtk
from gnn_fluid_dynamics_tpu_torch.data.hdf5 import load_dataset
from gnn_fluid_dynamics_tpu_torch.data.node_types import (CylinderNodeType,
                                                          NodeType)
from gnn_fluid_dynamics_tpu_torch.data.synthetic import (
    make_geometry, structured_channel_mesh, taylor_green_trajectory)
from gnn_fluid_dynamics_tpu_torch.ops import geometry

F2C_ULPS = 2.0 ** -22      # two f32 ulps, relative
PACKAGES = {"jax": (jvtk, jof, jcyl, jpreproc), "torch": (vtk, of, cyl, preproc)}


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


# ---- vtk_io -------------------------------------------------------------------

def _encoded_vtp(path, pts, fmt, header_dtype, compress):
    """A PolyData file holding ``pts`` as JAX ``tests/test_data.py:434-489``
    writes them: appended raw or inline base64, UInt32 or UInt64 headers,
    zlib-compressed or not."""
    raw = pts.tobytes()
    hd = np.dtype(header_dtype)
    comp_attr = ' compressor="vtkZLibDataCompressor"' if compress else ""
    if compress:
        comp = zlib.compress(raw)
        payload = np.array([1, len(raw), len(raw), len(comp)], hd).tobytes() \
            + comp
    else:
        payload = np.array([len(raw)], hd).tobytes() + raw
    if fmt == "appended":
        body = ('<Points><DataArray type="Float32" NumberOfComponents="3" '
                'format="appended" offset="0"/></Points>')
        app = b'<AppendedData encoding="raw">_' + payload + b"</AppendedData>"
    else:
        body = ('<Points><DataArray type="Float32" NumberOfComponents="3" '
                f'format="binary">{base64.b64encode(payload).decode()}'
                "</DataArray></Points>")
        app = b""
    htname = {4: "UInt32", 8: "UInt64"}[hd.itemsize]
    xml = (f'<?xml version="1.0"?><VTKFile type="PolyData" '
           f'byte_order="LittleEndian" header_type="{htname}"{comp_attr}>'
           '<PolyData><Piece NumberOfPoints="4" NumberOfPolys="0">'
           f"{body}<PointData/></Piece></PolyData></VTKFile>").encode()
    if app:
        xml = xml.replace(b"</VTKFile>", app + b"</VTKFile>")
    path.write_bytes(xml)
    return str(path)


@pytest.mark.parametrize("fmt", ["appended", "binary"])
@pytest.mark.parametrize("header", [np.uint32, np.uint64])
@pytest.mark.parametrize("compress", [False, True])
def test_vtk_encodings_read_by_both(tmp_path, fmt, header, compress):
    pts = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    path = _encoded_vtp(tmp_path / "t.vtp", pts, fmt, header, compress)
    got, want = vtk.read_vtp(path), jvtk.read_vtp(path)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.points, pts)
    assert got.point_data.keys() == want.point_data.keys()


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_vtk_files_written_by_one_read_by_the_other(tmp_path, writer, reader):
    """vtu, vtp and vtm files (ascii) that either package writes read the
    same through the other, and as the writer's own reader reads them."""
    w, r = PACKAGES[writer][0], PACKAGES[reader][0]
    rng = np.random.default_rng(1)
    geom = make_geometry("structured", nx=5, ny=4)
    tris = np.asarray(geom["vertex_face"]).T
    V, C = geom["vertex_pos"].shape[0], tris.shape[0]
    pts = np.concatenate([geom["vertex_pos"], np.zeros((V, 1))], axis=1)
    cell_data = {"U": rng.standard_normal((C, 3)), "p": rng.standard_normal(C),
                 "id": np.arange(C)}
    w.write_vtu(str(tmp_path / "a.vtu"), pts, tris.reshape(-1),
                np.arange(1, C + 1) * 3, np.full(C, 5, np.uint8),
                cell_data=cell_data, point_data={"q": rng.standard_normal(V)})
    w.write_vtp(str(tmp_path / "b.vtp"), pts,
                point_data={"phi": rng.standard_normal(V)})
    w.write_vtm(str(tmp_path / "c.vtm"), [("internal", "a.vtu"),
                                          ("inlet", "b.vtp")])
    for name in ("a.vtu", "b.vtp"):
        got, want = r.read(str(tmp_path / name)), w.read(str(tmp_path / name))
        for attr in ("points", "connectivity", "offsets", "types"):
            a, b = getattr(got, attr), getattr(want, attr)
            assert (a is None) == (b is None), attr
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=attr)
        for d in ("cell_data", "point_data"):
            a, b = getattr(got, d), getattr(want, d)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert got.n_cells == want.n_cells
    np.testing.assert_array_equal(r.read_vtu(str(tmp_path / "a.vtu"))
                                  .cell_vertices(2), tris[2])
    assert (r.read(str(tmp_path / "c.vtm"))
            == w.read(str(tmp_path / "c.vtm"))
            == [("internal", str(tmp_path / "a.vtu")),
                ("inlet", str(tmp_path / "b.vtp"))])
    with pytest.raises(ValueError, match="unsupported VTK file"):
        r.read(str(tmp_path / "d.vtk"))


# ---- openfoam -----------------------------------------------------------------

def _wedge_case(tmp_path, name="mesh_0", nx=8, ny=5, steps=3):
    geom = make_geometry("structured", nx=nx, ny=ny)
    fields = taylor_green_trajectory(geom, num_timesteps=steps, dt=0.01)
    case = str(tmp_path / name)
    _write_wedge_case(case, geom, fields, n_steps=steps)
    return case


def test_preprocess_vtk_series_matches_jax(tmp_path):
    """JAX ``tests/test_data.py:356-430``'s synthetic foamToVTK case (wedges,
    patch VTPs, surface phi with random owner signs and decoy points):
    the same trajectory from both packages."""
    case = _wedge_case(tmp_path)
    got = of.preprocess_vtk_series(case, "mesh_0", dt=0.01, reynolds=100.0)
    want = jof.preprocess_vtk_series(case, "mesh_0", dt=0.01, reynolds=100.0)
    _assert_same_trajectories([got], [want])
    assert np.abs(got.fields["face_flux"]).max() > 0
    with pytest.raises(FileNotFoundError, match="no VTK output"):
        of.preprocess_vtk_series(str(tmp_path / "nothing"), "m", dt=0.01)


def test_openfoam_helpers_match_jax():
    geom = make_geometry("structured", nx=7, ny=5)
    rng = np.random.default_rng(2)
    F, C = geom["face_pos"].shape[0], geom["cell_pos"].shape[0]
    vals = rng.standard_normal((C, 2))
    bvals = rng.standard_normal((F, 2))
    for b in (None, bvals):
        np.testing.assert_array_equal(
            of.cell_fields_to_faces(vals, geom, boundary_values=b),
            jof.cell_fields_to_faces(vals, geom, boundary_values=b))
    face_u = rng.standard_normal((F, 2))
    flip = np.where(rng.random(F) < 0.5, -1.0, 1.0)
    phi = np.sum(face_u * geom["face_normal"], axis=1) * flip
    pts = np.concatenate([np.repeat(geom["face_pos"], 2, axis=0),
                          rng.random((5, 2)) + 5.0])
    phi_pts = np.concatenate([np.repeat(phi, 2), np.ones(5)])
    for args in ((phi_pts, pts), (phi_pts[:0], pts[:0])):
        np.testing.assert_array_equal(
            of.map_phi_surface_to_faces(*args, geom["face_pos"],
                                        geom["face_normal"], face_u),
            jof.map_phi_surface_to_faces(*args, geom["face_pos"],
                                         geom["face_normal"], face_u))
    pos = geom["vertex_pos"]
    x, y = pos[:, 0], pos[:, 1]
    z = lambda m: np.concatenate([pos[m], np.zeros((m.sum(), 1))], axis=1)
    patches = {"inlet": z(x < 1e-9), "outlet": z(x > x.max() - 1e-9),
               "walls": z((y < 1e-9) | (y > y.max() - 1e-9)),
               "frontAndBack": z(x < 1.0)}
    types = of.classify_vertices_by_patches(pos, patches)
    np.testing.assert_array_equal(
        types, jof.classify_vertices_by_patches(pos, patches))
    assert (types[(x < 1e-9) & (y < 1e-9)] == NodeType.WALL_BOUNDARY).all()
    pts3 = np.concatenate([np.concatenate([pos, np.zeros((len(pos), 1))], 1),
                           np.concatenate([pos, np.ones((len(pos), 1))], 1)])
    for a, b in zip(of.slice_midplane(pts3), jof.slice_midplane(pts3)):
        np.testing.assert_array_equal(a, b)
    assert of.have_pyvista() == jof.have_pyvista()


# ---- cylinderflow -------------------------------------------------------------

def _deepmind_arrays(seed=0, nx=5, ny=4, T=3):
    pos, cells, vt = structured_channel_mesh(nx=nx, ny=ny)
    ntype = np.full(pos.shape[0], int(CylinderNodeType.NORMAL))
    ntype[vt == NodeType.INFLOW] = CylinderNodeType.INFLOW
    ntype[vt == NodeType.OUTFLOW] = CylinderNodeType.OUTFLOW
    ntype[vt == NodeType.WALL_BOUNDARY] = CylinderNodeType.WALL_BOUNDARY
    ntype[0] = CylinderNodeType.OBSTACLE
    rng = np.random.default_rng(seed)
    vel = rng.standard_normal((T, pos.shape[0], 2)).astype(np.float32)
    prs = rng.standard_normal((T, pos.shape[0], 1)).astype(np.float32)
    return pos, cells, ntype, vel, prs


def test_cylinderflow_conversion_matches_jax():
    np.testing.assert_array_equal(cyl.remap_node_types(np.arange(8)),
                                  jcyl.remap_node_types(np.arange(8)))
    pos, cells, ntype, vel, prs = _deepmind_arrays()
    for p in (prs, prs[..., 0]):
        got = cyl.trajectory_from_vertex_fields("mesh_0", pos, cells, ntype,
                                                vel, p)
        want = jcyl.trajectory_from_vertex_fields("mesh_0", pos, cells, ntype,
                                                  vel, p)
        _assert_same_trajectories([got], [want])


def _write_deepmind_h5(path, n=2):
    import h5py
    with h5py.File(path, "w") as f:
        for i in range(n):
            pos, cells, ntype, vel, prs = _deepmind_arrays(seed=i, nx=5 + i)
            g = f.create_group(f"{i:03d}")
            g["mesh_pos"] = pos[None]          # (1, V, 2): a static field
            g["cells"] = cells
            g["node_type"] = ntype[None, :, None]
            g["velocity"] = vel
            g["pressure"] = prs


def test_convert_deepmind_h5_matches_jax(tmp_path):
    _write_deepmind_h5(str(tmp_path / "in.h5"), n=3)
    got = cyl.convert_deepmind_h5(str(tmp_path / "in.h5"),
                                  str(tmp_path / "t.h5"), sim_limit=2)
    want = jcyl.convert_deepmind_h5(str(tmp_path / "in.h5"),
                                    str(tmp_path / "j.h5"), sim_limit=2)
    _assert_same_trajectories(got, want)
    _assert_same_trajectories(load_dataset(str(tmp_path / "t.h5")),
                              jax_load(str(tmp_path / "j.h5")))


def _write_tfrecord(tf, root, n=2):
    """DeepMind-schema records (JAX ``tests/test_data.py:150-214``'s)."""
    V, T, C = None, 4, None
    examples = []
    for i in range(n):
        pos, cells, _ = structured_channel_mesh(nx=5, ny=4)
        pos, cells = pos.astype(np.float32), cells.astype(np.int32)
        V, C = pos.shape[0], cells.shape[0]
        rng = np.random.RandomState(i)
        vel = rng.rand(T, V, 2).astype(np.float32)
        prs = rng.rand(T, V, 1).astype(np.float32)
        ntype = np.zeros((V, 1), np.int32)
        feat = lambda a: tf.train.Feature(bytes_list=tf.train.BytesList(
            value=[a.tobytes()]))
        examples.append(tf.train.Example(features=tf.train.Features(feature={
            "mesh_pos": feat(pos[None]), "cells": feat(cells[None]),
            "node_type": feat(ntype[None]), "velocity": feat(vel),
            "pressure": feat(prs)})))
    meta = {"trajectory_length": T,
            "field_names": ["mesh_pos", "cells", "node_type", "velocity",
                            "pressure"],
            "features": {
                "mesh_pos": {"type": "static", "shape": [1, V, 2],
                             "dtype": "float32"},
                "cells": {"type": "static", "shape": [1, C, 3],
                          "dtype": "int32"},
                "node_type": {"type": "static", "shape": [1, V, 1],
                              "dtype": "int32"},
                "velocity": {"type": "dynamic", "shape": [T, V, 2],
                             "dtype": "float32"},
                "pressure": {"type": "dynamic", "shape": [T, V, 1],
                             "dtype": "float32"}}}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    with tf.io.TFRecordWriter(os.path.join(root, "train.tfrecord")) as w:
        for ex in examples:
            w.write(ex.SerializeToString())


def test_convert_tfrecord_matches_jax(tmp_path):
    tf = pytest.importorskip("tensorflow")
    _write_tfrecord(tf, str(tmp_path))
    rec, meta = str(tmp_path / "train.tfrecord"), str(tmp_path / "meta.json")
    got = cyl.convert_tfrecord(rec, meta, str(tmp_path / "t.h5"), sim_limit=1)
    want = jcyl.convert_tfrecord(rec, meta, str(tmp_path / "j.h5"),
                                 sim_limit=1)
    assert len(got) == 1
    _assert_same_trajectories(got, want)
    _assert_same_trajectories(load_dataset(str(tmp_path / "t.h5")),
                              jax_load(str(tmp_path / "j.h5")))


# ---- ops/geometry -------------------------------------------------------------

def test_interpolate_centroid_and_face_to_centroid_match_jax():
    geom = make_geometry("cylinder", n_points=300, seed=4)
    rng = np.random.default_rng(3)
    V, F = geom["vertex_pos"].shape[0], geom["face_pos"].shape[0]
    cells = np.asarray(geom["vertex_face"]).T
    for shape in ((V, 1), (V, 2)):
        vals = rng.standard_normal(shape)
        np.testing.assert_array_equal(
            geometry.interpolate_centroid(vals, cells, geom["vertex_pos"],
                                          geom["cell_pos"]),
            jgeo.interpolate_centroid(vals, cells, geom["vertex_pos"],
                                      geom["cell_pos"]))
    fv = rng.standard_normal((F, 1)).astype(np.float32)
    got = geometry.face_to_centroid(torch.from_numpy(fv),
                                    torch.from_numpy(geom["face_index"]))
    want = np.asarray(jgeo.face_to_centroid(jnp.asarray(fv),
                                            jnp.asarray(geom["face_index"])))
    assert got.shape == want.shape == (geom["cell_pos"].shape[0], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F2C_ULPS * np.abs(fv).max())


# ---- preproc ------------------------------------------------------------------

def _preproc_sources(module, root):
    """The raw inputs of ``module`` under ``root``: the ``preproc.vtk_dpath``
    to read."""
    if module == "openfoam":
        for i, (nx, ny) in enumerate([(8, 5), (7, 4)]):
            _wedge_case(root, f"mesh_{i}", nx=nx, ny=ny)
        (root / "mesh_0" / "meta.json").write_text(json.dumps({"Re": 120.0}))
        (root / "subsets.json").write_text(json.dumps({"train": [0, 1],
                                                       "valid": [1]}))
    elif module == "cylinderflow":
        _write_deepmind_h5(str(root / "train.h5"), n=2)
        _write_deepmind_h5(str(root / "valid.h5"), n=1)
    elif module == "tfrecord":
        tf = pytest.importorskip("tensorflow")
        _write_tfrecord(tf, str(root))
    else:
        meshes, raw = root / "meshes", root / "raw"
        jmesh.main(["--num", "3", "--h", "0.12", "--regime", "inflow",
                    "--dt", "0.01", "--seed", "0", "--out", str(meshes)])
        jsim.main(["--meshes", str(meshes), "--out", str(raw), "--steps",
                   "3", "--backend", "builtin", "--spinup", "1"])
        return raw
    return root


@pytest.mark.parametrize("module", ["openfoam", "cylinderflow", "tfrecord",
                                    "builtin"])
def test_preproc_main_matches_jax(tmp_path, module):
    """``preproc.main`` of both packages on the same sources: the same
    subsets, the same files as both packages' ``load_dataset`` read them."""
    (tmp_path / "src").mkdir()
    src = _preproc_sources(module, tmp_path / "src")
    subsets = {"openfoam": ["train", "valid"],
               "cylinderflow": ["train", "valid"], "tfrecord": ["train"],
               "builtin": ["train"]}[module]
    out = {}
    for name, pkg in (("jax", jpreproc), ("torch", preproc)):
        out[name] = tmp_path / f"out_{name}"
        cfg = tmp_path / f"{name}.json"
        cfg.write_text(json.dumps({
            "dataset": {"module": module, "dpath": str(out[name])},
            "preproc": {"vtk_dpath": str(src), "out_dpath": str(out[name])}}))
        pkg.main(["--config", str(cfg), "--subsets", *subsets])
    files = sorted(os.listdir(out["jax"]))
    assert files == sorted(os.listdir(out["torch"]))
    assert {f"{s}.h5" for s in subsets} <= set(files)
    for f in files:
        _assert_same_trajectories(load_dataset(str(out["torch"] / f)),
                                  jax_load(str(out["jax"] / f)))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"dataset": {"module": "nope"}}))
    with pytest.raises(ValueError, match="unknown preprocessing module"):
        preproc.main(["--config", str(bad), "--subsets", "train"])
