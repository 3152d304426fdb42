"""What the redesigned K3 (edge -> vertex sum) and K5 (3-vertex cell mean)
rest on, checked on the CPU: their plain versions agree with the JAX
package's Pallas kernels (interpret mode) on padded graphs whose pad vertex
has a CSR row longer than one of the new K3's rounds; K3's summation order
(rounds of 32 incidences, four lane groups, two shuffles) gives the plain
version's sums; the programmatic-dependent-launch header is in the build's
hash; the ctypes signatures match the C entry points; and the PDL kernels'
sources keep the header's three rules.

Tolerances: bf16 against the Pallas kernels and against the plain version,
2**-7 relative plus 2**-7 absolute (one bf16 rounding step taken on the
other side of a boundary, from f32 sums in another order); signatures and
rules exactly.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import make_geometry
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands
from gnn_fluid_dynamics_tpu.ops import pallas_agg
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry

from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.ops import kernels

H = 128
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
ROUND = 32  # incidence ids per round of K3 (csrc/edge_vertex.cu)


@pytest.fixture(scope="module", params=[(300, 0), (500, 2)],
                ids=["cyl300", "cyl500"])
def padded(request):
    n_points, seed = request.param
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=n_points,
                                              seed=seed))
    gj = to_static_bands(jax_from_geometry(geom, pad_multiple=128,
                                           with_banded=True))
    gt = from_geometry(geom, pad_multiple=128, device="cpu")
    return gj, gt


def _row_lengths(g) -> np.ndarray:
    p = g.vertex_inc_ptr.numpy()
    return p[1:] - p[:-1]


def _bf16_edges(seed, n):
    x = np.random.default_rng(seed).normal(size=(n, H)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- K3 and K3 -> K5 against the Pallas kernels, the pad vertex's long row --

def test_pad_vertex_row_spans_several_rounds(padded):
    _, gt = padded
    lengths = _row_lengths(gt)
    pad = gt.num_vertices - 1
    assert lengths[pad] > ROUND
    assert lengths[pad] == lengths.max()
    assert lengths[pad] == 2 * (gt.num_faces - int(gt.face_mask.sum()))


def test_edges_to_vertices_matches_pallas_on_the_pad_vertex(padded):
    gj, gt = padded
    ej, et = _bf16_edges(21, gt.num_faces)
    want = _np(pallas_agg.aggregate_edges_to_vertices_pallas(ej, gj)[:, :H // 2])
    got = kernels.edges_to_vertices(et, gt)        # CPU tensors: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (gt.num_vertices, H // 2)
    np.testing.assert_allclose(_np(got), want, **BF16_TOL)
    pad = gt.num_vertices - 1
    assert np.abs(want[pad]).max() > 1.0          # a long, nonzero row is held
    np.testing.assert_allclose(_np(got)[pad], want[pad], **BF16_TOL)


def test_edges_to_vertices_then_cells_matches_pallas(padded):
    gj, gt = padded
    ej, et = _bf16_edges(22, gt.num_faces)
    want = pallas_agg.aggregate_vertices_to_cells_pallas(
        pallas_agg.aggregate_edges_to_vertices_pallas(ej, gj), gj)
    got = kernels.vertices_to_cells(kernels.edges_to_vertices(et, gt), gt)
    assert got.dtype == torch.float32 and got.shape == (gt.num_cells, H // 2)
    live = gt.cell_mask.numpy()
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], **BF16_TOL)


# ---- K3's summation order ---------------------------------------------------

def k3_order(edges: torch.Tensor, ptr: np.ndarray, inc_row: np.ndarray):
    """K3's sums as the kernel takes them, in f32: per vertex, rounds of 32
    incidences; in a round, lane group g adds incidences g, g + 4, ..., in
    order; the groups meet as (g0 + g1) + (g2 + g3); one rounding to bf16."""
    half = edges.float().reshape(-1, H // 2).numpy()
    out = np.zeros((len(ptr) - 1, H // 2), np.float32)
    for v in range(len(ptr) - 1):
        groups = np.zeros((4, H // 2), np.float32)
        for base in range(ptr[v], ptr[v + 1], ROUND):
            for i in range(min(ptr[v + 1] - base, ROUND)):
                groups[i % 4] += half[inc_row[base + i]]
        out[v] = (groups[0] + groups[1]) + (groups[2] + groups[3])
    return torch.from_numpy(out).to(torch.bfloat16)


def test_k3_summation_order_gives_the_plain_sums(padded):
    _, gt = padded
    _, et = _bf16_edges(23, gt.num_faces)
    got = k3_order(et, gt.vertex_inc_ptr.numpy(), gt.vertex_inc_row.numpy())
    want = kernels.edges_to_vertices_ref(et, gt)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


# ---- the build and the C signatures -----------------------------------------

def test_pdl_header_is_in_the_build_hash(tmp_path, monkeypatch):
    assert "pdl.cuh" in kernels.HEADERS
    for p in kernels.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels._library_path(n) for n in ("edge_vertex", "vertex_cell")}
    text = (tmp_path / "pdl.cuh").read_text()
    (tmp_path / "pdl.cuh").write_text(text + "\n// a changed header\n")
    assert all(kernels._library_path(n) != p for n, p in before.items())


def _source_of(entry: str) -> str:
    """The text of the library that exports ``entry``: its source and the
    headers the source includes."""
    name = entry.removeprefix("gfd_")
    for lib, extra in kernels._EXTRA_ENTRIES.items():
        if entry in extra:
            name = lib
            break
    text = (kernels.CSRC / kernels.SOURCES[name]).read_text()
    included = re.findall(r'#include "([^"]+)"', text)
    return text + "".join((kernels.CSRC / h).read_text() for h in included)


def _c_params(text: str, fn: str) -> list:
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"no extern \"C\" entry point {fn}"
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("entry", sorted(kernels._ARGTYPES))
def test_argtypes_match_the_entry_points(entry):
    """Each ctypes signature has the C entry point's arity, an int where the
    C parameter is an int and a pointer where it is a pointer."""
    text = _source_of(entry)
    params = _c_params(text, entry)
    argtypes = kernels._ARGTYPES[entry]
    assert len(argtypes) == len(params)
    for p, a in zip(params, argtypes):
        want = kernels._P if "*" in p else kernels._I
        assert a is want, f"{entry}: {p!r} bound as {a.__name__}"


# ---- the PDL rules, read from the sources -------------------------------------

# kernel -> (source, the pointer parameters it may read before its wait)
PDL_KERNELS = {
    "edge_vertex_kernel": ("edge_vertex.cu", {"ptr", "inc_row"}),
    "vertex_cell_kernel": ("vertex_cell.cu", {"v0", "v1", "v2"}),
    "launch_floor_kernel": ("edge_vertex.cu", set()),
}


def _kernel(text: str, name: str):
    """(pointer parameter names, body) of the __global__ function ``name``."""
    m = re.search(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+"
                  + name + r"\(([^)]*)\)\s*\{", text)
    assert m, f"no kernel {name}"
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
    pointers = {re.findall(r"\w+", p)[-1] for p in m.group(1).split(",")
                if "*" in p}
    return pointers, text[m.end():i - 1]


@pytest.mark.parametrize("name", sorted(PDL_KERNELS))
def test_pdl_kernels_keep_the_rules(name):
    """Before ``pdl_wait()``: no return, and no pointer parameter named but
    the constant index vectors (so no store, and no read of what the kernel
    before it writes). The wait is reached at the body's top level, not
    inside a branch or loop."""
    fname, allowed = PDL_KERNELS[name]
    pointers, body = _kernel((kernels.CSRC / fname).read_text(), name)
    assert body.count("pdl_wait();") == 1
    before = body[:body.index("pdl_wait();")]
    code = re.sub(r"//[^\n]*", "", before)
    assert "return" not in code
    named = {p for p in pointers if re.search(r"\b" + p + r"\b", code)}
    assert named <= allowed, f"{name} names {named - allowed} before its wait"
    assert code.count("{") == code.count("}")     # the wait is not nested


@pytest.mark.parametrize("entry,kernel,triggers", [
    ("gfd_edge_vertex", "edge_vertex_kernel", True),    # K5 may start early
    ("gfd_vertex_cell", "vertex_cell_kernel", False)])
def test_k3_and_k5_launch_through_pdl(entry, kernel, triggers):
    text = _source_of(entry)
    start = text.index(f'extern "C" int {entry}(')
    body = text[start:text.index("\n}\n", start)]
    # the kernel, or its instantiation for the call's width, goes to
    # launch_pdl
    assert re.search(r"launch_pdl\([^;]*\b" + kernel + r"\b", body)
    assert "<<<" not in body
    assert ("pdl_launch_dependents();" in _kernel(text, kernel)[1]) == triggers


def test_launch_floor_is_refused_off_the_card():
    with pytest.raises(ValueError, match="card"):
        kernels.launch_floor("cpu", 1, 32)


def test_hazard_writer_is_refused_off_the_card():
    x = torch.zeros(4, H, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="card"):
        kernels.slow_writer(x, x.clone(), True, 1000)


def test_every_pdl_library_exports_the_switch():
    """Each library that launches by PDL has ``gfd_set_pdl`` bound, so that
    ``without_pdl`` turns off the attribute of every PDL launch."""
    for name in kernels.PDL_LIBRARIES:
        assert "gfd_set_pdl" in kernels._EXTRA_ENTRIES[name]
        assert '#include "pdl.cuh"' in (kernels.CSRC / kernels.SOURCES[name]).read_text()
    pdl_sources = {n for n, f in kernels.SOURCES.items()
                   if "launch_pdl(" in (kernels.CSRC / f).read_text()}
    assert pdl_sources == set(kernels.PDL_LIBRARIES)
