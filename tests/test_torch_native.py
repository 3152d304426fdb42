"""The port's C++ graph builder (``native/``) against the numpy paths and
the JAX package's ``native``: connectivity, the vertex incidence table and
the banded one-hot fill, bit for bit; where its library is built (under
``build/native/``, never inside either package); a changed source forcing
a rebuild; a compiler failure falling back to numpy with the compiler's
message printed once; and ``graph.from_geometry`` the same with and without
the native path.

Tolerance: none. The builder computes the same integers, and the same f32
sums in the same order, as the numpy paths.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu import native as jax_native
from gnn_fluid_dynamics_tpu.ops.segment import (
    build_vertex_incidence as jax_incidence)

from gnn_fluid_dynamics_tpu_torch import native
from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.data.synthetic import (
    channel_flow_trajectory, cylinder_channel_mesh, make_geometry,
    structured_channel_mesh)
from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.ops import banded, connectivity
from gnn_fluid_dynamics_tpu_torch.ops.reorder import rcm_reorder_geometry

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {
    "structured": lambda: structured_channel_mesh(nx=7, ny=5),
    "jittered": lambda: structured_channel_mesh(nx=9, ny=6, jitter=0.2,
                                                seed=1),
    "cylinder": lambda: cylinder_channel_mesh(n_points=400, seed=3),
    "cylinder_large": lambda: cylinder_channel_mesh(n_points=3000, seed=0),
}


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    """The JAX package's library for this module, built by its own loader
    (``get_lib``: its compiler call, its source, its bindings) into a
    directory of this module's and loaded from there; the loader's state
    is put back afterwards.

    The loader compiles straight onto its one path inside the JAX package,
    with no lock, and latches a failed load for the rest of the process.
    Under pytest-xdist every worker collects ``tests/test_native.py``, whose
    module-level ``native_available()`` makes each of them build and load
    that one file at once: a worker can then load a file that another's
    linker is still writing, or latch the failure. A path written by this
    process alone cannot be raced, and the build is asserted: a case that
    compares with the JAX package never finds its library missing."""
    patch = pytest.MonkeyPatch()
    where = tmp_path_factory.mktemp("jax_native")
    patch.setattr(jax_native, "_LIB_PATH", str(where / "libgraph_builder.so"))
    patch.setattr(jax_native, "_HASH_PATH",
                  str(where / "libgraph_builder.so.srchash"))
    patch.setattr(jax_native, "_lib", None)
    patch.setattr(jax_native, "_lib_failed", False)
    try:
        lib = jax_native.get_lib()
        assert lib is not None, "the JAX package's library did not build"
        assert jax_native._binary_is_current()
        yield lib
    finally:
        patch.undo()


@pytest.fixture(autouse=True)
def _fresh_library_state(monkeypatch):
    """Each test sees the module's state as at import, and leaves it so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_connectivity_matches_numpy_and_jax(mesh):
    pos, cells, _ = MESHES[mesh]()
    got = native.compute_connectivity(cells, pos)
    assert got is not None
    want = connectivity.compute_connectivity_full(cells, pos,
                                                  use_native=False)
    theirs = jax_native.compute_connectivity(cells, pos)
    for g, w, t in zip(got, want, theirs):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, t)
    routed = connectivity.compute_connectivity_full(cells, pos)
    for g, r in zip(got, routed):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mesh", ["structured", "cylinder"])
@pytest.mark.parametrize("max_degree", [0, 16])
def test_incidence_matches_numpy_and_jax(mesh, max_degree):
    pos, cells, _ = MESHES[mesh]()
    _, _, vei = connectivity.compute_connectivity(cells, pos)
    V = pos.shape[0]
    edge_id, half, valid = native.build_vertex_incidence(vei, V, max_degree)
    want = jax_incidence(vei, V, max_degree)
    np.testing.assert_array_equal(edge_id, want.edge_id)
    np.testing.assert_array_equal(half, want.half)
    np.testing.assert_array_equal(valid, want.valid)
    for g, t in zip((edge_id, half, valid),
                    jax_native.build_vertex_incidence(vei, V, max_degree)):
        np.testing.assert_array_equal(g, t)
    with pytest.raises(ValueError, match="exceeds max_degree"):
        native.build_vertex_incidence(vei, V, 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_fill_matches_numpy_and_jax(seed):
    """Random triples with duplicates (which accumulate in order): the same
    f32 table, bit for bit, as ``np.add.at`` and the JAX package's fill;
    an entry outside its band raises on both of the port's paths."""
    rng = np.random.RandomState(seed)
    Tn, tile, B, S, nnz = 3, 128, 256, 512, 3000
    tgt = rng.randint(0, Tn * tile, nnz).astype(np.int64)
    offsets = (rng.randint(0, (S - B) // 8 + 1, Tn) * 8).astype(np.int32)
    src = (offsets[tgt // tile] + rng.randint(0, B, nnz)).astype(np.int64)
    w = rng.rand(nnz).astype(np.float32)
    got = native.banded_fill(tgt, src, w, Tn * tile, tile, B, offsets)
    ref = np.zeros((Tn, tile, B), np.float32)
    np.add.at(ref.reshape(-1), tgt * B + (src - offsets[tgt // tile]), w)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jax_native.banded_fill(tgt, src, w, Tn * tile, tile, B, offsets))
    routed = banded._onehot_fill(tgt, src, w, Tn, tile, B,
                                 offsets.astype(np.int64), tgt // tile)
    np.testing.assert_array_equal(routed, ref)
    bad = src.copy()
    bad[7] = offsets[tgt[7] // tile] + B
    with pytest.raises(ValueError, match="outside band width"):
        native.banded_fill(tgt, bad, w, Tn * tile, tile, B, offsets)
    with pytest.raises(ValueError, match="outside band width"):
        banded._onehot_fill(tgt, bad, w, Tn, tile, B,
                            offsets.astype(np.int64), tgt // tile)


def _package_files():
    """Every file under both packages, with its size and modification time."""
    out = {}
    for pkg in ("gnn_fluid_dynamics_tpu", "gnn_fluid_dynamics_tpu_torch"):
        for dirpath, _, files in os.walk(ROOT / pkg):
            if "__pycache__" in dirpath:
                continue
            for f in files:
                p = os.path.join(dirpath, f)
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
    return out


def test_library_is_built_under_build_native_only(tmp_path, monkeypatch):
    """The default library lives under ``<repo>/build/native/``; a build
    (forced here into an empty directory) writes there and nowhere in either
    package; the port's package holds no binary."""
    assert native.lib_path() == ROOT / "build" / "native" / native.LIB_NAME
    assert native.get_lib() is not None
    assert native.lib_path().exists()
    before = _package_files()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    assert native.native_available()
    assert sorted(os.listdir(tmp_path / "native")) == [
        native.LIB_NAME, native.LIB_NAME + ".srchash"]
    assert _package_files() == before
    assert not [p for p in before
                if "gnn_fluid_dynamics_tpu_torch" in p
                and p.endswith((".so", ".srchash"))]


def test_changed_source_rebuilds(tmp_path, monkeypatch):
    """A binary whose recorded hash is not the source's is rebuilt, never
    loaded; a current one is loaded without building."""
    src = tmp_path / "graph_builder.cpp"
    src.write_bytes(native.SRC.read_bytes())
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    builds = []
    compile_ = native._compile
    monkeypatch.setattr(native, "_compile",
                        lambda: builds.append(1) or compile_())
    assert native.get_lib() is not None and len(builds) == 1
    monkeypatch.setattr(native, "_lib", None)
    assert native.get_lib() is not None and len(builds) == 1
    src.write_text(src.read_text() + "\n// changed\n")
    monkeypatch.setattr(native, "_lib", None)
    assert not native._binary_is_current()
    assert native.get_lib() is not None and len(builds) == 2
    assert native._binary_is_current()
    assert (tmp_path / "build" / (native.LIB_NAME + ".srchash")
            ).read_text() == native._src_hash()


def test_compiler_failure_falls_back_loudly_once(tmp_path, monkeypatch,
                                                 capsys):
    src = tmp_path / "graph_builder.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    pos, cells, vt = MESHES["structured"]()
    geom = connectivity.build_geometry(pos, cells, vt, NodeType)
    out = capsys.readouterr().out
    assert out.count("native graph builder: g++ exited") == 1
    assert native.get_lib() is None and not native.native_available()
    assert native.banded_fill(np.zeros(1, np.int64), np.zeros(1, np.int64),
                              np.ones(1, np.float32), 128, 128, 128,
                              np.zeros(1, np.int32)) is None
    connectivity.build_geometry(pos, cells, vt, NodeType)
    assert capsys.readouterr().out == ""
    want = connectivity.build_geometry(pos, cells, vt, NodeType,
                                       use_native=False)
    for k in want:
        np.testing.assert_array_equal(geom[k], want[k], err_msg=k)


def test_from_geometry_same_with_and_without_native(monkeypatch):
    geom_n = rcm_reorder_geometry(make_geometry("cylinder", n_points=600,
                                                seed=2))
    fields = channel_flow_trajectory(geom_n, num_timesteps=3, dt=0.01)
    with_native = from_geometry(geom_n, fields, dt=0.01, pad_multiple=128,
                                with_banded=True, device="cpu")
    monkeypatch.setattr(native, "_lib_failed", True)
    pos, cells, vt = cylinder_channel_mesh(n_points=600, seed=2)
    geom_p = rcm_reorder_geometry(connectivity.build_geometry(
        pos, cells, vt, NodeType, use_native=False))
    for k in geom_n:
        np.testing.assert_array_equal(geom_n[k], geom_p[k], err_msg=k)
    without = from_geometry(geom_p, fields, dt=0.01, pad_multiple=128,
                            with_banded=True, device="cpu")
    n = 0
    for f in dataclasses.fields(with_native):
        a, b = getattr(with_native, f.name), getattr(without, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
            n += 1
        else:
            assert a == b, f.name
    assert n > 20 and with_native.es_onehot is not None
