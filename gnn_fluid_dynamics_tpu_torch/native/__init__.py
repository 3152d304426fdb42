"""The C++ graph builder with ctypes bindings (counterpart of
``native/__init__.py``).

The reference builds its host-side graph tables in Python dict loops
(``src/utils/geometry.py:64-170``); the same contracts run here through a
small C++ library (``graph_builder.cpp``, the JAX package's source copied
unchanged). It is compiled with ``g++`` at first use into
``build/native/`` at the repository root, never beside the source, and a
binary is loaded only when its recorded source hash matches the source.
Where no library can be built, the callers take their numpy paths, which
give identical results; the compiler's message is printed once, so that the
fallback is never silent. Nothing is built on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libgraph_builder.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_failed = False


def lib_path() -> Path:
    return BUILD_DIR / LIB_NAME


def _hash_path() -> Path:
    return BUILD_DIR / (LIB_NAME + ".srchash")


def _src_hash() -> str:
    return hashlib.sha256(SRC.read_bytes()).hexdigest()


def _compile() -> bool:
    """Build the library into BUILD_DIR (a temporary name renamed into
    place, so that processes building at once never load a partial file),
    then record the source's hash. On failure print the compiler's message
    and return False."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path().with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"native graph builder: g++ could not run ({exc}); "
              "using the numpy paths")
        return False
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        print(f"native graph builder: g++ exited {res.returncode}; using the "
              f"numpy paths\n{res.stdout}{res.stderr}")
        return False
    os.replace(tmp, lib_path())
    htmp = _hash_path().with_suffix(f".{os.getpid()}.tmp")
    htmp.write_text(_src_hash())
    os.replace(htmp, _hash_path())
    return True


def _binary_is_current() -> bool:
    """The binary is trusted only if its recorded source hash matches the
    source: modification times are unreliable on a fresh checkout, and a
    stale binary must never load silently (JAX ``native/__init__.py:46-57``)."""
    try:
        return (lib_path().exists()
                and _hash_path().read_text().strip() == _src_hash())
    except OSError:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built first where it is missing or stale; None
    where it cannot be built or loaded."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if not _binary_is_current() and not _compile():
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(lib_path()))
    except OSError as exc:
        print(f"native graph builder: {lib_path()} does not load ({exc}); "
              "using the numpy paths")
        _lib_failed = True
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.connectivity_count.restype = ctypes.c_int64
    lib.connectivity_count.argtypes = [i64p, ctypes.c_int64]
    lib.connectivity_fill.restype = ctypes.c_int
    lib.connectivity_fill.argtypes = [
        i64p, ctypes.c_int64, f64p, i64p, i64p, i64p, f32p, i64p,
        ctypes.c_int64]
    lib.incidence_max_degree.restype = ctypes.c_int64
    lib.incidence_max_degree.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64]
    lib.incidence_fill.restype = ctypes.c_int
    lib.incidence_fill.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, i32p, i32p, u8p]
    lib.banded_band_limits.restype = None
    lib.banded_band_limits.argtypes = [i64p, i64p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       i64p, i64p]
    lib.banded_onehot_fill.restype = None
    lib.banded_onehot_fill.argtypes = [i64p, i64p, f32p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       i32p, f32p]
    lib.banded_fill_flat.restype = ctypes.c_int64
    lib.banded_fill_flat.argtypes = [i64p, i64p, f32p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     i32p, f32p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def compute_connectivity(cells: np.ndarray, vertex_pos: np.ndarray
                         ) -> Optional[Tuple[np.ndarray, ...]]:
    """Connectivity and its derived tables, or None without the library:
    (face_index (3, C), cell_edge_index (2, F), vertex_edge_index (2, F),
    cell_face_sign (C, 3), owner_local_slot (F,)), those of
    ``ops.connectivity.compute_connectivity_full``'s numpy path."""
    lib = get_lib()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, np.int64)
    C = cells.shape[0]
    centroids = np.ascontiguousarray(
        vertex_pos[cells].mean(axis=1), np.float64)
    F = int(lib.connectivity_count(cells, C))
    face_index = np.zeros((3, C), np.int64)
    cei = np.zeros((2, F), np.int64)
    vei = np.zeros((2, F), np.int64)
    sign = np.zeros((C, 3), np.float32)
    slot = np.zeros(F, np.int64)
    rc = lib.connectivity_fill(cells, C, centroids, face_index, cei, vei,
                               sign, slot, F)
    if rc != 0:
        raise ValueError(f"native connectivity failed (code {rc}): "
                         "non-manifold or inconsistent mesh")
    return face_index, cei, vei, sign, slot


def build_vertex_incidence(vertex_edge_index: np.ndarray, num_vertices: int,
                           max_degree: int = 0):
    """The vertex <- edge incidence table (edge_id, half, valid), each
    (V, D), or None without the library; ``max_degree`` pads the width
    (0: the mesh's largest degree)."""
    lib = get_lib()
    if lib is None:
        return None
    vei = np.ascontiguousarray(vertex_edge_index, np.int64)
    F = vei.shape[1]
    D = int(lib.incidence_max_degree(vei, F, num_vertices))
    if max_degree:
        if D > max_degree:
            raise ValueError(f"vertex degree {D} exceeds max_degree")
        D = max_degree
    edge_id = np.zeros((num_vertices, D), np.int32)
    half = np.zeros((num_vertices, D), np.int32)
    valid = np.zeros((num_vertices, D), np.uint8)
    rc = lib.incidence_fill(vei, F, num_vertices, D, edge_id, half, valid)
    if rc != 0:
        raise ValueError("native incidence fill overflow")
    return edge_id, half, valid.astype(bool)


def banded_fill(tgt, src, w, rows: int, tile: int, B: int, offsets):
    """The dense banded one-hot table (rows // tile, tile, B) float32 from
    flat (target, source, weight) triples, duplicates accumulating in order;
    None without the library (the caller then takes ``np.add.at``)."""
    lib = get_lib()
    if lib is None:
        return None
    tgt = np.ascontiguousarray(tgt, np.int64)
    src = np.ascontiguousarray(src, np.int64)
    w = np.ascontiguousarray(w, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    onehot = np.zeros((rows, B), np.float32)
    dropped = lib.banded_fill_flat(tgt, src, w, len(tgt), tile, B, offsets,
                                   onehot)
    if dropped:
        raise ValueError(
            f"banded_fill: {dropped} entries outside band width {B}: the "
            "band offsets and width are inconsistent with the sources")
    return onehot.reshape(rows // tile, tile, B)
