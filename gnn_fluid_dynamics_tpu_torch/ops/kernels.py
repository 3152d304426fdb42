"""The rollout's GN-block kernels, hand-written in CUDA C++ for Hopper.

Counterpart of ``gnn_fluid_dynamics_tpu/ops/pallas_agg.py``. Each kernel has a
wrapper, a plain PyTorch version of the same function, and a launch counter:

=====  =======================  ===================================  ==========================
name   wrapper                  plain version                        source
=====  =======================  ===================================  ==========================
K1     :func:`fused_face_block`  :func:`fused_face_block_ref`        ``csrc/face_block.cu``
K2     :func:`fused_cell_block`  :func:`fused_cell_block_ref`        ``csrc/cell_block.cu``
K3     :func:`edges_to_vertices` :func:`edges_to_vertices_ref`       ``csrc/edge_vertex.cu``
K4     :func:`gather_face_cells` :func:`gather_face_cells_ref`       ``csrc/face_gather.cu``
K5     :func:`vertices_to_cells` :func:`vertices_to_cells_ref`       ``csrc/vertex_cell.cu``
K6     :func:`table_dual`        :func:`table_dual_ref`              ``csrc/table_dual.cu``
K7     :func:`table_single`      :func:`table_single_ref`            ``csrc/table_single.cu``
K8     :func:`mlp_block`         :func:`mlp_block_ref`               ``csrc/mlp_block.cu``
=====  =======================  ===================================  ==========================

K1-K3 carry the fused GN block; K3, K5 and K4 carry the unfused one's
aggregations (a block with a step scalar, as in FvgnF), and K8 each of its
sub-blocks' MLP -> LayerNorm -> residual on their outputs; K3 -> K5 carry
the Conservative family's twice message passing, whose f32 MLPs run
outside the kernels. K1-K5 read the graph's index vectors. K6 and K7 read
its banded one-hot tables instead (a graph on the table route,
:mod:`gnn_fluid_dynamics_tpu_torch.graph`): per block K6 on the es/er tables
and K7 on vc in place of K3 and K5, and K6 on the cf tables in place of K4,
each feeding K8 as those do. Each launches once per table application to a
whole batch of graphs, and takes tables of any band width, as the TPU
kernels do: each streams a tile's band through shared memory.

The latents are H = 128 channels wide. K3 and K6's roll form also take
edge latents of 2H = 256 channels (``WIDTHS``), and K5 and K7 the (., H)
vertex sums those give: ConservativeH/J/K's twice message passing runs on
``[e_s | e_s]`` of their H-wide symmetric latents. Each width is its own
instantiation of the kernel's template, one launch a call.

A wrapper given tensors on the CPU returns its plain version; given CUDA
tensors it launches its kernel or raises. Each launch adds one to the
wrapper's ``launches`` attribute. K3 and K5 launch by programmatic dependent
launch (``csrc/pdl.cuh``): each may start while the kernel before it in the
stream still runs, reading only the graph's constant index vectors until it
has waited for that kernel.

The sources are compiled with ``nvcc`` for ``sm_90a`` into plain-C shared
libraries under ``build/torch_kernels/`` at the checkout's root, at first use
(one ``nvcc`` per source, all started together), keyed by a hash of the
sources and flags, and loaded with ``ctypes``. That first use is the span
``setup.kernels``; each ``nvcc`` process adds one to the counter
``kernels.builds``, each library loaded one to ``kernels.loads``
(:mod:`~gnn_fluid_dynamics_tpu_torch.training.profiling`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from gnn_fluid_dynamics_tpu_torch.ops.segment import (
    aggregate_edges_to_vertices_scatter)
from gnn_fluid_dynamics_tpu_torch.training import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = {"face_block": "face_block.cu", "cell_block": "cell_block.cu",
           "edge_vertex": "edge_vertex.cu", "face_gather": "face_gather.cu",
           "vertex_cell": "vertex_cell.cu", "table_dual": "table_dual.cu",
           "table_single": "table_single.cu", "mlp_block": "mlp_block.cu"}
HEADERS = ("async_copy.cuh", "common.cuh", "gn_wgmma.cuh", "pdl.cuh",
           "table_mma.cuh", "wgmma.cuh")
H = 128          # the latent width the kernels are built for
# the edge-latent widths K3 and K6's roll form take: every GN block's H, and
# ConservativeH/J/K's [e_s | e_s]; K5 and K7 take the vertex sums, half of
# each
WIDTHS = (H, 2 * H)
VERTEX_WIDTHS = tuple(w // 2 for w in WIDTHS)
LN_EPS = 1e-5

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "gfd_face_block": [_I] + [_P] * 4 + [_I] + [_P] * 11,
    "gfd_cell_block": [_I] + [_P] * 5 + [_I] + [_P] * 11,
    "gfd_edge_vertex": [_I] + [_P] * 3 + [_I] * 2 + [_P] * 2,
    "gfd_face_gather": [_I] + [_P] * 3 + [_I] * 2 + [_P] * 3,
    "gfd_vertex_cell": [_I] + [_P] * 4 + [_I] * 2 + [_P] * 2,
    "gfd_table_dual": [_I] + [_P] * 4 + [_I] * 6 + [_P] * 3,
    "gfd_table_single": [_I] + [_P] * 3 + [_I] * 5 + [_P] * 2,
    "gfd_mlp_block": [_I] * 2 + [_P] * 3 + [_I] + [_P] * 13,
    "gfd_mlp_block_silu": [_I] + [_P] * 2,
    "gfd_launch_floor": [_I] * 3 + [_P],
    "gfd_slow_writer": [_I, _P] + [_I] * 4 + [_P] * 2,
    "gfd_set_pdl": [_I],
}
TABLE_TILE = 128  # target rows per table tile
# the table dtypes K6/K7 read, by the code their C entry points take
TABLE_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# the cell latents K4 reads, by the code its C entry point takes
GATHER_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_ENTRY = {name: "gfd_" + name for name in SOURCES}
# entry points beside a library's kernel, for measuring and checking: the
# empty kernel of K3's launch path (the launch floor), the PDL hazard check's
# writer, the PDL switch of the libraries that launch by PDL, and K8's SiLU
# on every bf16 value
PDL_LIBRARIES = ("edge_vertex", "vertex_cell")
_EXTRA_ENTRIES = {"edge_vertex": ("gfd_launch_floor", "gfd_slow_writer",
                                  "gfd_set_pdl"),
                  "vertex_cell": ("gfd_set_pdl",),
                  "mlp_block": ("gfd_mlp_block_silu",)}

_libs: dict = {}
_lock = threading.Lock()


class BlockWeights(NamedTuple):
    """One GN sub-block's MLP + LayerNorm as the fused kernels' plain
    versions read it (the kernels read :class:`PackedWeights`): each matrix
    (inputs, outputs) row-major and every tensor in the latents' dtype.
    ``w0``'s rows follow the kernel's gathered input, ``[e | x[owner] |
    x[neighbour]]`` for K1 and ``[c | vertex mean]`` for K2."""
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    ln_g: torch.Tensor
    ln_b: torch.Tensor


class PackedWeights(NamedTuple):
    """The fused kernels' weights (K1's and K2's): ``mlp``, which their plain
    versions read, and ``packed``, ``mlp``'s three matrices in the layout the
    kernels copy into shared memory. Made by :func:`packed_weights` from
    ``mlp``, so the two never disagree."""
    mlp: BlockWeights
    packed: torch.Tensor


def _core_matrices(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) matrix as the products' K-major operand of N rows: 8 x 8
    blocks, element (k, n) at ((k // 8) * (N // 8) + n // 8) * 64 + (n % 8)
    * 8 + k % 8 (``csrc/gn_wgmma.cuh``). Flat."""
    K, N = w.shape
    return w.reshape(K // 8, 8, N // 8, 8).permute(0, 2, 3, 1).reshape(-1)


def pack_weights(w0: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """W0, W1 and W2 ((K0, H), (H, H), (H, H), inputs x outputs) in the
    layout K1 and K2 copy into shared memory as it stands, one after the
    other in one flat tensor."""
    return torch.cat([_core_matrices(w) for w in (w0, w1, w2)]).contiguous()


def packed_weights(w: BlockWeights) -> PackedWeights:
    """The fused kernels' weights from an MLP's: ``w`` and its matrices
    packed (:func:`pack_weights`). Made once per set of weights
    (``MLP.kernel_weights(packed=True)`` caches it), never per launch."""
    return PackedWeights(w, pack_weights(w.w0, w.w1, w.w2))


def _unpacked(w) -> BlockWeights:
    return w.mlp if isinstance(w, PackedWeights) else w


class MlpBlockWeights(NamedTuple):
    """K8's weights, one sub-block MLP's (``MLP.kernel_weights(mlp_block=
    True)``): ``dense``, its three (weight, bias) pairs in bf16 as
    ``F.linear`` takes them ((outputs, inputs); the plain version's);
    ``ln_g`` and ``ln_b``, its LayerNorm's parameters in f32;
    ``packed``, the three matrices as K8 copies them into shared memory
    (:func:`pack_mlp_block`), W0 without its step-scalar row; ``w0_step``,
    that row, (H,) bf16, or None for an MLP without one."""
    dense: tuple
    ln_g: torch.Tensor
    ln_b: torch.Tensor
    packed: torch.Tensor
    w0_step: Optional[torch.Tensor]


# K8's permutations (csrc/mlp_block.cu). Inputs: in each 16-column k step,
# the product's row p holds input column _K_STEP[p], so that the four values
# a thread's A fragment holds of a row (rows 2q, 2q+1, 2q+8, 2q+9) are the
# neighbouring columns 4q..4q+3. Outputs: W2's column n holds output column
# _OUT[n], so that a thread's accumulator (columns 8i+2q, 8i+2q+1) holds
# columns 16m+4q..16m+4q+3 of its rows.
_K_STEP = [4 * ((p % 8) // 2) + p % 2 + 2 * (p // 8) for p in range(16)]
_OUT = [16 * (n // 16) + 4 * ((n % 8) // 2) + 2 * ((n // 8) % 2) + n % 2
        for n in range(H)]


def pack_mlp_block(w0: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor) -> torch.Tensor:
    """W0 ((K0, H), K0 a multiple of 16), W1 and W2 ((H, H)), inputs x
    outputs, in the layout K8 copies into shared memory: W0's rows and
    W2's columns permuted (``_K_STEP``, ``_OUT``), then
    :func:`pack_weights`."""
    k0 = w0.shape[0]
    rows = torch.tensor([16 * (p // 16) + _K_STEP[p % 16] for p in range(k0)],
                        device=w0.device)
    cols = torch.tensor(_OUT, device=w2.device)
    return pack_weights(w0[rows], w1, w2[:, cols])


def mlp_block_weights(dense, ln_g: torch.Tensor,
                      ln_b: torch.Tensor) -> MlpBlockWeights:
    """K8's weights from an MLP's: ``dense`` its three (weight, bias) pairs
    in bf16 as ``F.linear`` takes them; W0's inputs past the last multiple
    of 16 (one: the step scalar's column) become ``w0_step``. Made once per
    set of weights (``MLP.kernel_weights(mlp_block=True)`` caches it)."""
    w0 = dense[0][0]
    k0 = w0.shape[1] - w0.shape[1] % 16
    packed = pack_mlp_block(w0[:, :k0].t(), dense[1][0].t(), dense[2][0].t())
    step = w0[:, k0].contiguous() if w0.shape[1] > k0 else None
    return MlpBlockWeights(tuple(dense), ln_g, ln_b, packed, step)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + HEADERS:
        digest.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_kernels() -> float:
    """Compile every kernel library not yet built: one ``nvcc`` process per
    source, all started together. Returns the wall seconds it took (0 when
    nothing was missing)."""
    missing = {n: _library_path(n) for n in SOURCES
               if not _library_path(n).exists()}
    if not missing:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in missing.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
        profiling.count("kernels.builds")
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock, profiling.span("setup.kernels"):
        if not _libs:
            build_kernels()
            for n in SOURCES:
                dll = ctypes.CDLL(str(_library_path(n)))
                profiling.count("kernels.loads")
                for entry in (_ENTRY[n],) + _EXTRA_ENTRIES.get(n, ()):
                    fn = getattr(dll, entry)
                    fn.argtypes = _ARGTYPES[entry]
                    fn.restype = ctypes.c_int
                dll.gfd_error_name.argtypes = [ctypes.c_int]
                dll.gfd_error_name.restype = ctypes.c_char_p
                _libs[n] = dll
    return _libs[name]


def _launch(name: str, device: torch.device, *args, entry=None) -> None:
    lib = _library(name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, entry or _ENTRY[name])(device.index or 0, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc} "
                           f"({lib.gfd_error_name(rc).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, what: str, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} is not 16-byte aligned")


def _width(t: torch.Tensor, what: str, widths) -> int:
    """The channels of the 2-D ``t``, which must be one of ``widths``."""
    if t.ndim != 2 or t.shape[1] not in widths:
        raise ValueError(f"{what} has shape {tuple(t.shape)}; the kernel takes "
                         f"(rows, w) for w in {tuple(widths)}")
    return t.shape[1]


def _check_packed(w, k0: int, device, kernel: str) -> None:
    """What a fused kernel reads of its :class:`PackedWeights`: the packed
    matrices for input width ``k0`` and the five vectors, bf16 on
    ``device``."""
    if not isinstance(w, PackedWeights):
        raise ValueError(f"{kernel} reads its weights packed: pass "
                         "packed_weights(w) (MLP.kernel_weights(packed=True))")
    _check(w.packed, "packed", device, torch.bfloat16, ((k0 + 2 * H) * H,))
    for field in ("b0", "b1", "b2", "ln_g", "ln_b"):
        _check(getattr(w.mlp, field), field, device, torch.bfloat16, (H,))


def _packed_ptrs(w: PackedWeights, k0: int) -> tuple:
    """The kernel's pointer arguments: W0, b0, W1, b1, W2, b2, ln_g, ln_b."""
    m = w.mlp
    p0 = w.packed.data_ptr()
    p1 = p0 + k0 * H * 2                               # bf16 bytes
    p2 = p1 + H * H * 2
    return (p0, _ptr(m.b0), p1, _ptr(m.b1), p2, _ptr(m.b2), _ptr(m.ln_g),
            _ptr(m.ln_b))


def _check_bands(src_off: torch.Tensor, band: int, rows: int) -> None:
    """Every band inside the source: 0 <= off and off + band <= rows (the
    kernels read source rows without bounds checks). The offsets are read
    back once, and again only after they change in place or are checked
    against another band or row count: a rollout passes the same offsets
    every step. (An inference tensor keeps no version count, so its
    offsets are read back on every call.)"""
    if src_off.numel() == 0:
        return
    key = (None if src_off.is_inference() else src_off._version, band, rows)
    if key[0] is not None and getattr(src_off, "_bands_checked", None) == key:
        return
    lo, hi = (int(v) for v in torch.aminmax(src_off))
    if lo < 0 or hi + band > rows:
        raise ValueError(f"src_off runs from {lo} to {hi}: bands of {band} "
                         f"rows must lie inside the {rows} source rows")
    src_off._bands_checked = key


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mlp_ln_tail_ref(base: torch.Tensor, h0: torch.Tensor, w: BlockWeights):
    """SiLU -> W1 -> SiLU -> W2 -> LayerNorm on the f32 pre-activation
    ``h0``, with the products' operands rounded to the latents' dtype and
    everything else in f32 (``pallas_agg.py::_mlp_ln_tail``). Returns (raw,
    base + raw) in the latents' dtype."""
    wdt = base.dtype
    h = F.silu(h0)
    h = h.to(wdt).float() @ w.w1.float() + w.b1.float()
    h = F.silu(h)
    h = h.to(wdt).float() @ w.w2.float() + w.b2.float()
    mu = h.mean(dim=1, keepdim=True)
    var = (h * h).mean(dim=1, keepdim=True) - mu * mu
    hn = (h - mu) * torch.rsqrt(var + LN_EPS) * w.ln_g.float() + w.ln_b.float()
    return hn.to(wdt), (base.float() + hn).to(wdt)


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm as Flax computes it: f32 statistics with var = E[x^2] -
    mean^2 clamped at 0, the f32 parameters as they are, result in ``x``'s
    dtype; without ``bias`` none is added."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def mlp_block_ref(parts, extra, w: MlpBlockWeights, residual: bool = True,
                  dual_out: bool = False):
    """Plain version of K8: the sub-block's MLP (``models/arch.py``'s
    ``MLP.forward`` in bf16) on ``parts`` concatenated, with the (1, 1) step
    scalar ``extra`` appended to every row when given, and the residual
    ``parts[0] + raw``. The parts are ``[cell latents, vertex mean]`` (the
    cell form) or ``[edge latents, x[owner], x[neighbour]]`` (the face
    form). Returns raw (bf16) without ``residual``; else the residual (f32),
    or (raw, residual) with ``dual_out``."""
    rows = parts[0].shape[0]
    cols = list(parts)
    if extra is not None:
        cols.append(extra.expand(rows, extra.shape[-1]))
    # parts of mixed dtypes are promoted by the concatenation (exactly)
    h = torch.cat(cols, dim=-1).to(torch.bfloat16)
    for i, (weight, bias) in enumerate(w.dense):
        # the product and the bias add each round to bf16
        h = F.linear(h, weight) + bias
        if i < 2:
            h = F.silu(h)
    raw = layer_norm_ref(h, w.ln_g, w.ln_b)
    if not residual:
        return raw
    res = parts[0] + raw.float()
    return (raw, res) if dual_out else res


def fused_face_block_ref(cell_attr, edge_attr, graph, w, dual_out: bool = False):
    """Plain version of K1: the face block's MLP on ``[e | x[owner] |
    x[neighbour]]``, LayerNorm and residual, with the weights ``w`` (a
    :class:`BlockWeights`, or its :class:`PackedWeights`). Returns the
    residualed edge latents, or (raw, residualed) with ``dual_out``."""
    w = _unpacked(w)
    own, nbr = graph.cell_edge_index[0], graph.cell_edge_index[1]
    x = torch.cat([edge_attr, cell_attr[own], cell_attr[nbr]], dim=1)
    h0 = x.float() @ w.w0.float() + w.b0.float()
    raw, res = _mlp_ln_tail_ref(edge_attr, h0, w)
    return (raw, res) if dual_out else res


def fused_cell_block_ref(cell_attr, vtx, graph, w, dual_out: bool = False):
    """Plain version of K2: the cell block's MLP on ``[c | mean of the 3
    vertex rows]`` (``vtx`` is K3's (V, H/2) sum), LayerNorm and residual,
    with the weights ``w`` (a :class:`BlockWeights`, or its
    :class:`PackedWeights`). The mean is taken in f32 and rounded to the
    latents' dtype, as the TPU kernel does."""
    w = _unpacked(w)
    vf = graph.vertex_face
    v = vtx.float()
    agg = (v[vf[0]] + v[vf[1]] + v[vf[2]]) * (1.0 / 3.0)
    x = torch.cat([cell_attr, agg.to(cell_attr.dtype)], dim=1)
    h0 = x.float() @ w.w0.float() + w.b0.float()
    raw, res = _mlp_ln_tail_ref(cell_attr, h0, w)
    return (raw, res) if dual_out else res


def edges_to_vertices_ref(edge_attr, graph):
    """Plain version of K3: the f32 scatter-sum of forward halves onto
    senders and reverse halves onto receivers (``ops/segment.py``), rounded
    to the latents' dtype. (F, W) -> (V, W/2), any W."""
    e = edge_attr.float()
    h2 = e.shape[1] // 2
    out = aggregate_edges_to_vertices_scatter(
        e[:, :h2], e[:, h2:], graph.vertex_edge_index, graph.num_vertices)
    return out.to(edge_attr.dtype)


def gather_face_cells_ref(cell_attr, graph):
    """Plain version of K4: the cell latents rounded to bf16 (to nearest,
    ties to even: ``gather_face_cells_pallas``'s cast), then the owner and
    neighbour rows per face, (C, H) -> two (F, H) bf16."""
    x = cell_attr.to(torch.bfloat16)
    return x[graph.cell_edge_index[0]], x[graph.cell_edge_index[1]]


def vertices_to_cells_ref(vtx, graph):
    """Plain version of K5: each cell's 3 rows of K3's (V, W/2) vertex sums,
    summed in f32 and rounded to their dtype, then divided by 3 in f32
    (``pallas_agg.py::aggregate_vertices_to_cells_pallas``). -> (C, W/2)
    f32, any width."""
    vf = graph.vertex_face
    v = vtx.float()
    return (v[vf[0]] + v[vf[1]] + v[vf[2]]).to(vtx.dtype).float() / 3.0


def _table_bands(src: torch.Tensor, src_off: torch.Tensor, band: int):
    """(T, B, W) f32: each tile's band of source rows."""
    idx = src_off.long()[:, None] + torch.arange(band, device=src.device)
    return src.float()[idx]


def _table_apply(oh: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    """One f32 einsum of the table, its weights rounded to bf16 first, with
    the bands: (T, 128, B) x (T, B, W) -> (T * 128, W) f32."""
    w = oh.to(torch.bfloat16).float()
    return torch.einsum("tib,tbh->tih", w, bands).reshape(-1, bands.shape[2])


def table_dual_ref(oh_a, oh_b, src_off, src, combine_roll: bool = False):
    """Plain version of K6: both tables applied to each tile's band of the
    bf16 (S, W) source (``src_off`` the bands' first rows in ``src``), in
    f32, each stored in ``src``'s dtype. With ``combine_roll`` only the
    vertex sum ``A[:, :W/2] + B[:, W/2:]``, rounded once: (T*128, W/2);
    else (A, B), two (T*128, W). Any width."""
    bands = _table_bands(src, src_off, oh_a.shape[2])
    a, b = _table_apply(oh_a, bands), _table_apply(oh_b, bands)
    if combine_roll:
        h2 = src.shape[1] // 2
        return (a[:, :h2] + b[:, h2:]).to(src.dtype)
    return a.to(src.dtype), b.to(src.dtype)


def table_single_ref(oh, src_off, src):
    """Plain version of K7: the table applied to each tile's band of the
    bf16 (S, W/2) vertex sums in f32, rounded to ``src``'s dtype, then
    divided by 3 in f32 (``aggregate_vertices_to_cells_pallas``'s
    epilogue). -> (T*128, W/2) f32, any width."""
    s = _table_apply(oh, _table_bands(src, src_off, oh.shape[2]))
    return s.to(src.dtype).float() / 3.0


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fused_face_block(cell_attr, edge_attr, graph, w, dual_out: bool = False):
    """K1: the fused face block. See :func:`fused_face_block_ref`. On the
    card ``w`` must be :class:`PackedWeights` (:func:`packed_weights`)."""
    if edge_attr.device.type == "cpu":
        return fused_face_block_ref(cell_attr, edge_attr, graph, w, dual_out)
    dev = edge_attr.device
    nf, nc = graph.num_faces, graph.num_cells
    _check(edge_attr, "edge_attr", dev, torch.bfloat16, (nf, H))
    _check(cell_attr, "cell_attr", dev, torch.bfloat16, (nc, H))
    _check(graph.cell_edge_index, "cell_edge_index", dev, torch.int32, (2, nf))
    _check_packed(w, 3 * H, dev, "K1")
    res = torch.empty_like(edge_attr)
    raw = torch.empty_like(edge_attr) if dual_out else None
    _launch("face_block", dev, _ptr(edge_attr), _ptr(cell_attr),
            _ptr(graph.cell_edge_index[0]), _ptr(graph.cell_edge_index[1]),
            nf, *_packed_ptrs(w, 3 * H), _ptr(raw), _ptr(res))
    fused_face_block.launches += 1
    return (raw, res) if dual_out else res


def fused_cell_block(cell_attr, vtx, graph, w, dual_out: bool = False):
    """K2: the fused cell block. See :func:`fused_cell_block_ref`. On the
    card ``w`` must be :class:`PackedWeights` (:func:`packed_weights`)."""
    if cell_attr.device.type == "cpu":
        return fused_cell_block_ref(cell_attr, vtx, graph, w, dual_out)
    dev = cell_attr.device
    nc, nv = graph.num_cells, graph.num_vertices
    _check(cell_attr, "cell_attr", dev, torch.bfloat16, (nc, H))
    _check(vtx, "vtx", dev, torch.bfloat16, (nv, H // 2))
    _check(graph.vertex_face, "vertex_face", dev, torch.int32, (3, nc))
    _check_packed(w, H + H // 2, dev, "K2")
    res = torch.empty_like(cell_attr)
    raw = torch.empty_like(cell_attr) if dual_out else None
    vf = graph.vertex_face
    _launch("cell_block", dev, _ptr(cell_attr), _ptr(vtx), _ptr(vf[0]),
            _ptr(vf[1]), _ptr(vf[2]), nc, *_packed_ptrs(w, H + H // 2),
            _ptr(raw), _ptr(res))
    fused_cell_block.launches += 1
    return (raw, res) if dual_out else res


def edges_to_vertices(edge_attr, graph):
    """K3: the edge->vertex half sum of (F, W) latents, W in ``WIDTHS``.
    See :func:`edges_to_vertices_ref`."""
    if edge_attr.device.type == "cpu":
        return edges_to_vertices_ref(edge_attr, graph)
    dev = edge_attr.device
    nf, nv = graph.num_faces, graph.num_vertices
    w = _width(edge_attr, "edge_attr", WIDTHS)
    _check(edge_attr, "edge_attr", dev, torch.bfloat16, (nf, w))
    _check(graph.vertex_inc_ptr, "vertex_inc_ptr", dev, torch.int32, (nv + 1,))
    _check(graph.vertex_inc_row, "vertex_inc_row", dev, torch.int32, (2 * nf,))
    out = torch.empty((nv, w // 2), dtype=torch.bfloat16, device=dev)
    _launch("edge_vertex", dev, _ptr(edge_attr), _ptr(graph.vertex_inc_ptr),
            _ptr(graph.vertex_inc_row), nv, w, _ptr(out))
    edges_to_vertices.launches += 1
    return out


def gather_face_cells(cell_attr, graph):
    """K4: the owner/neighbour gather of the latents rounded to bf16. See
    :func:`gather_face_cells_ref`. On the card the latents are f32 (rounded
    in the kernel) or bf16 (copied)."""
    if cell_attr.device.type == "cpu":
        return gather_face_cells_ref(cell_attr, graph)
    dev = cell_attr.device
    nf, nc = graph.num_faces, graph.num_cells
    if cell_attr.dtype not in GATHER_DTYPES:
        raise ValueError(f"cell_attr has dtype {cell_attr.dtype}, expected one "
                         f"of {tuple(GATHER_DTYPES)}")
    _check(cell_attr, "cell_attr", dev, cell_attr.dtype, (nc, H))
    _check(graph.cell_edge_index, "cell_edge_index", dev, torch.int32, (2, nf))
    own = torch.empty((nf, H), dtype=torch.bfloat16, device=dev)
    nbr = torch.empty_like(own)
    _launch("face_gather", dev, _ptr(cell_attr), _ptr(graph.cell_edge_index[0]),
            _ptr(graph.cell_edge_index[1]), nf, GATHER_DTYPES[cell_attr.dtype],
            _ptr(own), _ptr(nbr))
    gather_face_cells.launches += 1
    return own, nbr


def vertices_to_cells(vtx, graph):
    """K5: the 3-vertex cell mean of (V, W/2) vertex sums, W in ``WIDTHS``.
    See :func:`vertices_to_cells_ref`."""
    if vtx.device.type == "cpu":
        return vertices_to_cells_ref(vtx, graph)
    dev = vtx.device
    nc, nv = graph.num_cells, graph.num_vertices
    half = _width(vtx, "vtx", VERTEX_WIDTHS)
    _check(vtx, "vtx", dev, torch.bfloat16, (nv, half))
    _check(graph.vertex_face, "vertex_face", dev, torch.int32, (3, nc))
    out = torch.empty((nc, half), dtype=torch.float32, device=dev)
    vf = graph.vertex_face
    _launch("vertex_cell", dev, _ptr(vtx), _ptr(vf[0]), _ptr(vf[1]),
            _ptr(vf[2]), nc, half, _ptr(out))
    vertices_to_cells.launches += 1
    return out


def launch_floor(device, blocks: int, threads: int) -> None:
    """One launch of an empty kernel of ``blocks`` x ``threads`` on
    ``device`` through K3's and K5's launch path, with the programmatic
    dependent launch attribute unless inside :func:`without_pdl`: what a
    launch costs the card before any work. For measuring; counts nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the launch floor is measured on a card, not {device}")
    _launch("edge_vertex", device, blocks, threads, entry="gfd_launch_floor")


@contextlib.contextmanager
def without_pdl():
    """K3, K5 and the launch floor's kernel launch without the programmatic
    dependent launch attribute inside the block: each then starts after the
    kernel before it has ended, as a plain launch does. Timed back to back
    with the attribute, a kernel overlaps its own next launch, which no path
    does; this is for timing it without that. Measuring only."""
    libs = [_library(n) for n in PDL_LIBRARIES]
    for lib in libs:
        lib.gfd_set_pdl(0)
    try:
        yield
    finally:
        for lib in libs:
            lib.gfd_set_pdl(1)


def slow_writer(src, dst, negate: bool, cycles: int, blocks: int = 4) -> None:
    """The PDL hazard check's writer: a plain launch of ``blocks`` blocks
    that lets a PDL launch behind it start at once, idles ``cycles`` clock
    cycles, then writes ``dst = src`` (negated when ``negate``); bf16 of one
    size on one card. A kernel behind it that read ``dst`` before its wait
    would read the values from before. For checking; counts nothing."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"the hazard writer runs on a card, not {dev}")
    _check(dst, "dst", dev, torch.bfloat16, src.shape)
    _check(src, "src", dev, torch.bfloat16, src.shape)
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("src and dst must be contiguous")
    _launch("edge_vertex", dev, _ptr(src), src.numel(), int(negate), cycles,
            blocks, _ptr(dst), entry="gfd_slow_writer")


def mlp_block_silu_table(device) -> torch.Tensor:
    """K8's SiLU of every bf16 value, (65536,) bf16, entry ``i`` that of
    the value whose bits are ``i``: to hold against PyTorch's SiLU of the
    same values, which K8 computes otherwise than PyTorch does where the
    two round to the same bf16 (``csrc/mlp_block.cu``). On a card only;
    counts nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"K8's SiLU table is read on a card, not {device}")
    out = torch.empty(65536, dtype=torch.bfloat16, device=device)
    _launch("mlp_block", device, _ptr(out), entry="gfd_mlp_block_silu")
    return out


def _check_table(oh, what, dev, like=None) -> None:
    """A (T, 128, B) table, B a positive multiple of 128 of any width (as
    ``banded_dual_pallas`` and ``banded_single_pallas`` take), in one of the
    table dtypes (or ``like``'s dtype and shape)."""
    if oh.dtype not in TABLE_DTYPES:
        raise ValueError(f"{what} has dtype {oh.dtype}, expected one of "
                         f"{tuple(TABLE_DTYPES)}")
    if (oh.ndim != 3 or oh.shape[1] != TABLE_TILE or oh.shape[2] % 128
            or oh.shape[2] == 0):
        raise ValueError(f"{what} has shape {tuple(oh.shape)}, expected "
                         f"(T, {TABLE_TILE}, a multiple of 128)")
    like = oh if like is None else like
    _check(oh, what, dev, like.dtype, like.shape)


def table_dual(oh_a, oh_b, src_off, src, combine_roll: bool = False):
    """K6: the dense-table dual apply. See :func:`table_dual_ref`. The
    source is (S, H), or with ``combine_roll`` (S, W) for W in ``WIDTHS``;
    the bands must lie inside it (``off + B <= S``, checked) and may be of
    any width: the kernel streams each tile's band through shared memory.
    Tables too large for the card raise as its allocator does; there is no
    fallback."""
    if src.device.type == "cpu":
        return table_dual_ref(oh_a, oh_b, src_off, src, combine_roll)
    dev = src.device
    _check_table(oh_a, "oh_a", dev)
    _check_table(oh_b, "oh_b", dev, like=oh_a)
    T, _, band = oh_a.shape
    _check(src_off, "src_off", dev, torch.int32, (T,))
    w = _width(src, "src", WIDTHS if combine_roll else (H,))
    _check(src, "src", dev, torch.bfloat16, (src.shape[0], w))
    _check_bands(src_off, band, src.shape[0])
    rows = T * TABLE_TILE
    if combine_roll:
        out_a = torch.empty((rows, w // 2), dtype=torch.bfloat16, device=dev)
        out_b = None
    else:
        out_a = torch.empty((rows, H), dtype=torch.bfloat16, device=dev)
        out_b = torch.empty_like(out_a)
    _launch("table_dual", dev, _ptr(oh_a), _ptr(oh_b), _ptr(src_off),
            _ptr(src), src.shape[0], rows, band, TABLE_DTYPES[oh_a.dtype],
            int(combine_roll), w, _ptr(out_a), _ptr(out_b))
    table_dual.launches += 1
    return out_a if combine_roll else (out_a, out_b)


def table_single(oh, src_off, src):
    """K7: the dense-table single apply with the 1/3 epilogue on (S, W/2)
    vertex sums, W in ``WIDTHS``. See :func:`table_single_ref`; the bands
    must lie inside ``src`` and may be of any width, as for
    :func:`table_dual`."""
    if src.device.type == "cpu":
        return table_single_ref(oh, src_off, src)
    dev = src.device
    _check_table(oh, "oh", dev)
    T, _, band = oh.shape
    half = _width(src, "src", VERTEX_WIDTHS)
    _check(src_off, "src_off", dev, torch.int32, (T,))
    _check(src, "src", dev, torch.bfloat16, (src.shape[0], half))
    _check_bands(src_off, band, src.shape[0])
    rows = T * TABLE_TILE
    out = torch.empty((rows, half), dtype=torch.float32, device=dev)
    _launch("table_single", dev, _ptr(oh), _ptr(src_off), _ptr(src),
            src.shape[0], rows, band, TABLE_DTYPES[oh.dtype], half, _ptr(out))
    table_single.launches += 1
    return out


def mlp_block(parts, extra, w: MlpBlockWeights, residual: bool = True,
              dual_out: bool = False):
    """K8: a sub-block's MLP -> LayerNorm -> residual. See
    :func:`mlp_block_ref`. On the card the parts are ``[(R, H) f32, (R,
    H/2) f32]`` (cell form: K5's or K7's vertex mean) or ``[(R, H) f32,
    (R, H) bf16, (R, H) bf16]`` (face form: K4's or K6's rows), and
    ``extra`` is given exactly when ``w`` has a step-scalar row."""
    base = parts[0]
    if base.device.type == "cpu":
        return mlp_block_ref(parts, extra, w, residual, dual_out)
    dev = base.device
    rows = base.shape[0]
    if len(parts) not in (2, 3):
        raise ValueError(f"K8 takes 2 parts (cell) or 3 (face), not {len(parts)}")
    face = len(parts) == 3
    k0 = 3 * H if face else H + H // 2
    _check(w.packed, "packed", dev, torch.bfloat16, ((k0 + 2 * H) * H,))
    for name, (_, bias) in zip(("b0", "b1", "b2"), w.dense):
        _check(bias, name, dev, torch.bfloat16, (H,))
    _check(w.ln_g, "ln_g", dev, torch.float32, (H,))
    _check(w.ln_b, "ln_b", dev, torch.float32, (H,))
    if (extra is None) != (w.w0_step is None):
        raise ValueError("K8 takes the step scalar exactly when W0 has its row")
    if extra is not None:
        _check(w.w0_step, "w0_step", dev, torch.bfloat16, (H,))
        # a row of the step scalars: read as one f32, so any alignment
        if (extra.device, extra.dtype, tuple(extra.shape)) != (
                dev, torch.float32, (1, 1)):
            raise ValueError(f"extra is {extra.dtype} {tuple(extra.shape)} on "
                             f"{extra.device}, expected float32 (1, 1) on {dev}")
    _check(base, "parts[0]", dev, torch.float32, (rows, H))
    for i, p in enumerate(parts[1:], 1):
        _check(p, f"parts[{i}]", dev, torch.bfloat16 if face else torch.float32,
               (rows, H if face else H // 2))
    raw = (torch.empty((rows, H), dtype=torch.bfloat16, device=dev)
           if dual_out or not residual else None)
    res = (torch.empty((rows, H), dtype=torch.float32, device=dev)
           if residual else None)
    p0 = w.packed.data_ptr()
    p1 = p0 + k0 * H * 2                               # bf16 bytes
    p2 = p1 + H * H * 2
    _launch("mlp_block", dev, int(face), _ptr(base), _ptr(parts[1]),
            _ptr(parts[2]) if face else None, rows, _ptr(extra), p0, p1, p2,
            _ptr(w.w0_step), *(_ptr(b) for _, b in w.dense), _ptr(w.ln_g),
            _ptr(w.ln_b), _ptr(raw), _ptr(res))
    mlp_block.launches += 1
    if not residual:
        return raw
    return (raw, res) if dual_out else res


fused_face_block.launches = 0
fused_cell_block.launches = 0
edges_to_vertices.launches = 0
gather_face_cells.launches = 0
vertices_to_cells.launches = 0
table_dual.launches = 0
table_single.launches = 0
mlp_block.launches = 0
