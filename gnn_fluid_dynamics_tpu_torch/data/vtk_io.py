"""Minimal self-contained VTK XML reader and writer (counterpart of
``data/vtk_io.py``; no pyvista or vtk dependency).

Reads exactly what the OpenFOAM ``foamToVTK`` pipeline produces (reference
``generate/conversion.py`` runs ``foamToVTK -surfaceFields``):

* ``.vtm``  — vtkMultiBlockDataSet index: named blocks referencing files
* ``.vtu``  — UnstructuredGrid: points, cells (connectivity/offsets/types),
  cell/point data arrays
* ``.vtp``  — PolyData: points + point data (the ``surfaceFields_*.vtp``
  carrying the face flux ``phi``)

Supported encodings: ``ascii``, inline ``binary`` (base64), and ``appended``
(raw or base64), with optional ``vtkZLibDataCompressor`` compression and
UInt32/UInt64 header types — the combinations foamToVTK and ParaView emit.
Only little-endian files are handled (VTK's default on every relevant
platform).
"""

from __future__ import annotations

import base64
import os
import xml.etree.ElementTree as ET
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_DTYPES = {
    "Int8": np.int8, "UInt8": np.uint8,
    "Int16": np.int16, "UInt16": np.uint16,
    "Int32": np.int32, "UInt32": np.uint32,
    "Int64": np.int64, "UInt64": np.uint64,
    "Float32": np.float32, "Float64": np.float64,
}

# VTK cell type ids we understand (enough for extruded 2-D meshes)
VTK_TRIANGLE = 5
VTK_QUAD = 9
VTK_TETRA = 10
VTK_HEXAHEDRON = 12
VTK_WEDGE = 13
VTK_POLYHEDRON = 42


class VtkGrid:
    """Parsed piece: points (N, 3) + cells + named data arrays."""

    def __init__(self, points, connectivity, offsets, types,
                 cell_data, point_data):
        self.points = points
        self.connectivity = connectivity
        self.offsets = offsets
        self.types = types
        self.cell_data: Dict[str, np.ndarray] = cell_data
        self.point_data: Dict[str, np.ndarray] = point_data

    @property
    def n_cells(self) -> int:
        return 0 if self.offsets is None else self.offsets.shape[0]

    def cell_vertices(self, i: int) -> np.ndarray:
        lo = 0 if i == 0 else int(self.offsets[i - 1])
        return self.connectivity[lo:int(self.offsets[i])]


def _decompress(raw: bytes, header_dtype, compressed: bool) -> bytes:
    hd = np.dtype(header_dtype)
    if not compressed:
        n = int(np.frombuffer(raw[: hd.itemsize], hd)[0])
        return raw[hd.itemsize: hd.itemsize + n]
    # zlib header: [nblocks, block_size, last_block_size, csize_0..csize_n-1]
    nblocks = int(np.frombuffer(raw[: hd.itemsize], hd)[0])
    head = np.frombuffer(raw[: (3 + nblocks) * hd.itemsize], hd)
    csizes = head[3: 3 + nblocks].astype(np.int64)
    pos = (3 + nblocks) * hd.itemsize
    out = []
    for cs in csizes:
        out.append(zlib.decompress(raw[pos: pos + int(cs)]))
        pos += int(cs)
    return b"".join(out)


def _read_dataarray(elem, appended: Optional[bytes], header_dtype,
                    compressed: bool) -> np.ndarray:
    dtype = _DTYPES[elem.get("type")]
    ncomp = int(elem.get("NumberOfComponents", "1"))
    fmt = elem.get("format", "ascii")
    if fmt == "ascii":
        arr = np.array((elem.text or "").split(), dtype=dtype)
    elif fmt == "binary":
        raw = base64.b64decode("".join((elem.text or "").split()))
        payload = _decompress(raw, header_dtype, compressed)
        arr = np.frombuffer(payload, dtype=dtype)
    elif fmt == "appended":
        assert appended is not None, "appended data block missing"
        off = int(elem.get("offset", "0"))
        payload = _decompress(appended[off:], header_dtype, compressed)
        arr = np.frombuffer(payload, dtype=dtype)
    else:
        raise ValueError(f"unsupported DataArray format {fmt!r}")
    if ncomp > 1:
        arr = arr.reshape(-1, ncomp)
    return np.array(arr)   # own the memory (frombuffer views are read-only)


def _parse_vtkfile(path: str):
    """Returns (root Element, appended bytes or None, header dtype,
    compressed flag)."""
    with open(path, "rb") as f:
        data = f.read()
    # appended raw data is not valid XML: split it off before parsing
    appended = None
    marker = data.find(b"<AppendedData")
    if marker != -1:
        enc_start = data.find(b'encoding="', marker)
        encoding = data[enc_start + 10: data.find(b'"', enc_start + 10)]
        payload_start = data.find(b"_", data.find(b">", marker)) + 1
        payload_end = data.rfind(b"</AppendedData>")
        payload = data[payload_start:payload_end]
        if encoding == b"base64":
            appended = base64.b64decode(b"".join(payload.split()))
        else:
            appended = payload.rstrip(b"\n ")
        data = data[:payload_start - 1] + b"</AppendedData>" \
            + data[payload_end + len(b"</AppendedData>"):]
    root = ET.fromstring(data.decode("utf-8", errors="replace"))
    header_dtype = _DTYPES[root.get("header_type", "UInt32")]
    compressed = root.get("compressor") is not None
    byte_order = root.get("byte_order", "LittleEndian")
    assert byte_order == "LittleEndian", byte_order
    return root, appended, header_dtype, compressed


def _read_named_arrays(parent, appended, hd, comp) -> Dict[str, np.ndarray]:
    out = {}
    if parent is None:
        return out
    for da in parent.findall("DataArray"):
        name = da.get("Name")
        if name:
            out[name] = _read_dataarray(da, appended, hd, comp)
    return out


def read_vtu(path: str) -> VtkGrid:
    """Read an UnstructuredGrid (.vtu) file."""
    root, appended, hd, comp = _parse_vtkfile(path)
    piece = root.find(".//Piece")
    pts_el = piece.find("Points/DataArray")
    points = _read_dataarray(pts_el, appended, hd, comp).reshape(-1, 3)
    cells = piece.find("Cells")
    conn = offs = types = None
    if cells is not None:
        arrs = _read_named_arrays(cells, appended, hd, comp)
        conn = arrs.get("connectivity")
        offs = arrs.get("offsets")
        types = arrs.get("types")
    cell_data = _read_named_arrays(piece.find("CellData"), appended, hd, comp)
    point_data = _read_named_arrays(piece.find("PointData"), appended, hd, comp)
    return VtkGrid(points, conn, offs, types, cell_data, point_data)


def read_vtp(path: str) -> VtkGrid:
    """Read a PolyData (.vtp) file — points + point/cell data (the polys
    themselves are parsed when present but unused by the pipeline)."""
    root, appended, hd, comp = _parse_vtkfile(path)
    piece = root.find(".//Piece")
    pts_el = piece.find("Points/DataArray")
    points = _read_dataarray(pts_el, appended, hd, comp).reshape(-1, 3)
    conn = offs = None
    polys = piece.find("Polys")
    if polys is not None:
        arrs = _read_named_arrays(polys, appended, hd, comp)
        conn, offs = arrs.get("connectivity"), arrs.get("offsets")
    cell_data = _read_named_arrays(piece.find("CellData"), appended, hd, comp)
    point_data = _read_named_arrays(piece.find("PointData"), appended, hd, comp)
    return VtkGrid(points, conn, offs, None, cell_data, point_data)


def read_vtm(path: str) -> List[Tuple[str, str]]:
    """Read a vtkMultiBlockDataSet index: [(block name, absolute file path)].

    Block names follow foamToVTK's layout: the internal mesh block is named
    ``internal`` and boundary patches carry their patch names (possibly under
    a ``boundary`` group block)."""
    root, _, _, _ = _parse_vtkfile(path)
    base = os.path.dirname(os.path.abspath(path))
    out: List[Tuple[str, str]] = []

    def walk(elem, prefix):
        for child in elem:
            name = child.get("name") or child.get("index") or ""
            if child.tag == "DataSet" and child.get("file"):
                out.append((name or prefix,
                            os.path.join(base, child.get("file"))))
            elif child.tag == "Block":
                walk(child, name)
    mb = root.find("vtkMultiBlockDataSet")
    if mb is not None:
        walk(mb, "")
    return out


def read(path: str):
    """pyvista.read-alike dispatch by extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".vtu":
        return read_vtu(path)
    if ext == ".vtp":
        return read_vtp(path)
    if ext == ".vtm":
        return read_vtm(path)
    raise ValueError(f"unsupported VTK file {path!r}")


# ---------------------------------------------------------------------------
# Writer (test/tooling support): enough to round-trip what the reader needs
# ---------------------------------------------------------------------------

def _ascii(arr) -> str:
    return " ".join(str(x) for x in np.asarray(arr).reshape(-1))


def write_vtu(path: str, points: np.ndarray,
              connectivity: np.ndarray, offsets: np.ndarray,
              types: np.ndarray,
              cell_data: Optional[Dict[str, np.ndarray]] = None,
              point_data: Optional[Dict[str, np.ndarray]] = None):
    """Write a (ascii) UnstructuredGrid file readable by this module, pyvista,
    and ParaView — used by tests and the mesh-export tooling."""
    def da(name, arr, vtype):
        arr = np.asarray(arr)
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        nm = f' Name="{name}"' if name else ""
        return (f'<DataArray type="{vtype}"{nm} '
                f'NumberOfComponents="{ncomp}" format="ascii">'
                f"{_ascii(arr)}</DataArray>")

    def data_block(tag, d):
        if not d:
            return f"<{tag}/>"
        inner = "".join(
            da(k, v, "Float64" if np.asarray(v).dtype.kind == "f" else "Int64")
            for k, v in d.items())
        return f"<{tag}>{inner}</{tag}>"

    xml = (
        '<?xml version="1.0"?>'
        '<VTKFile type="UnstructuredGrid" version="0.1" '
        'byte_order="LittleEndian">'
        "<UnstructuredGrid>"
        f'<Piece NumberOfPoints="{points.shape[0]}" '
        f'NumberOfCells="{offsets.shape[0]}">'
        f"<Points>{da(None, np.asarray(points, np.float64), 'Float64')}</Points>"
        "<Cells>"
        f"{da('connectivity', np.asarray(connectivity, np.int64), 'Int64')}"
        f"{da('offsets', np.asarray(offsets, np.int64), 'Int64')}"
        f"{da('types', np.asarray(types, np.uint8), 'UInt8')}"
        "</Cells>"
        f"{data_block('CellData', cell_data or {})}"
        f"{data_block('PointData', point_data or {})}"
        "</Piece></UnstructuredGrid></VTKFile>")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(xml)


def write_vtp(path: str, points: np.ndarray,
              point_data: Optional[Dict[str, np.ndarray]] = None):
    def da(name, arr, vtype):
        arr = np.asarray(arr)
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        nm = f' Name="{name}"' if name else ""
        return (f'<DataArray type="{vtype}"{nm} '
                f'NumberOfComponents="{ncomp}" format="ascii">'
                f"{_ascii(arr)}</DataArray>")
    pd = "".join(da(k, np.asarray(v, np.float64), "Float64")
                 for k, v in (point_data or {}).items())
    xml = (
        '<?xml version="1.0"?>'
        '<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian">'
        "<PolyData>"
        f'<Piece NumberOfPoints="{points.shape[0]}" NumberOfPolys="0">'
        f"<Points>{da(None, np.asarray(points, np.float64), 'Float64')}</Points>"
        f"<PointData>{pd}</PointData>"
        "</Piece></PolyData></VTKFile>")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(xml)


def write_vtm(path: str, blocks: List[Tuple[str, str]]):
    """blocks: [(name, relative file path)]."""
    inner = "".join(
        f'<DataSet index="{i}" name="{name}" file="{rel}"/>'
        for i, (name, rel) in enumerate(blocks))
    xml = ('<?xml version="1.0"?>'
           '<VTKFile type="vtkMultiBlockDataSet" version="1.0" '
           'byte_order="LittleEndian">'
           f"<vtkMultiBlockDataSet>{inner}</vtkMultiBlockDataSet></VTKFile>")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(xml)
