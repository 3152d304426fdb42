// Native mesh graph builder.
//
// C++ implementation of the host-side preprocessing hot loops — the
// triangles_to_faces-compatible connectivity construction (the reference's
// dict-based Python loops, src/utils/geometry.py:64-170), the vertex-edge
// incidence table, and the banded one-hot table fill. These run per mesh at
// dataset build time; for production-size meshes (100k+ cells) the Python
// versions take minutes while this runs in milliseconds.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image). Two-phase
// where output sizes are data-dependent: *_count then *_fill.
//
// Build: g++ -O3 -shared -fPIC -o libgraph_builder.so graph_builder.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Connectivity (reference contract: ops/connectivity.compute_connectivity)
// ---------------------------------------------------------------------------

// Returns the number of unique faces for `cells` (C,3).
int64_t connectivity_count(const int64_t* cells, int64_t num_cells) {
    std::vector<std::pair<int64_t, int64_t>> edges;
    edges.reserve(3 * num_cells);
    for (int64_t i = 0; i < num_cells; ++i) {
        const int64_t v0 = cells[3 * i], v1 = cells[3 * i + 1],
                      v2 = cells[3 * i + 2];
        auto pack = [](int64_t a, int64_t b) {
            return std::make_pair(std::max(a, b), std::min(a, b));
        };
        edges.push_back(pack(v0, v1));
        edges.push_back(pack(v1, v2));
        edges.push_back(pack(v2, v0));
    }
    std::sort(edges.begin(), edges.end());
    edges.erase(std::unique(edges.begin(), edges.end()), edges.end());
    return static_cast<int64_t>(edges.size());
}

// Fills all connectivity outputs. Buffers sized by the caller:
//   face_index       (3, C)  int64
//   cell_edge_index  (2, F)  int64  [owner, neighbour], centroid-rule oriented
//   vertex_edge_index(2, F)  int64  [sender=max, receiver=min]
//   cell_face_sign   (C, 3)  float  +1 owner / -1 interior neighbour
//   owner_local_slot (F,)    int64
// centroids: (C, 2) float64. Returns 0 on success, <0 on mesh errors.
int connectivity_fill(const int64_t* cells, int64_t num_cells,
                      const double* centroids,
                      int64_t* face_index, int64_t* cell_edge_index,
                      int64_t* vertex_edge_index, float* cell_face_sign,
                      int64_t* owner_local_slot, int64_t num_faces) {
    struct HalfEdge { int64_t u, v, flat; };
    std::vector<HalfEdge> half;
    half.reserve(3 * num_cells);
    // flat order must be CELL-major (i*3+j) so the first cell seen per face
    // is the lowest-index cell — the reference dict-insertion owner rule
    for (int64_t i = 0; i < num_cells; ++i) {
        const int64_t vv[3] = {cells[3 * i], cells[3 * i + 1], cells[3 * i + 2]};
        for (int j = 0; j < 3; ++j) {
            int64_t a = vv[j], b = vv[(j + 1) % 3];
            half.push_back({std::max(a, b), std::min(a, b), i * 3 + j});
        }
    }
    std::sort(half.begin(), half.end(), [](const HalfEdge& x, const HalfEdge& y) {
        if (x.u != y.u) return x.u < y.u;
        if (x.v != y.v) return x.v < y.v;
        return x.flat < y.flat;
    });

    int64_t fid = -1;
    int64_t prev_u = -1, prev_v = -1;
    std::vector<int64_t> owner(num_faces, -1), neigh(num_faces, -1);
    std::vector<int64_t> owner_slot(num_faces, -1), neigh_slot(num_faces, -1);
    for (const auto& h : half) {
        if (h.u != prev_u || h.v != prev_v) {
            ++fid;
            if (fid >= num_faces) return -1;
            vertex_edge_index[fid] = h.u;               // row 0: senders
            vertex_edge_index[num_faces + fid] = h.v;   // row 1: receivers
            prev_u = h.u; prev_v = h.v;
            owner[fid] = h.flat / 3;
            owner_slot[fid] = h.flat % 3;
        } else {
            if (neigh[fid] != -1) return -2;            // non-manifold
            neigh[fid] = h.flat / 3;
            neigh_slot[fid] = h.flat % 3;
        }
        face_index[(h.flat % 3) * num_cells + (h.flat / 3)] = fid;
    }
    if (fid + 1 != num_faces) return -3;

    for (int64_t f = 0; f < num_faces; ++f) {
        int64_t o = owner[f];
        int64_t n = neigh[f] == -1 ? o : neigh[f];
        int64_t o_slot = owner_slot[f];
        int64_t n_slot = neigh[f] == -1 ? o_slot : neigh_slot[f];
        // centroid orientation rule (reference reorder_face,
        // geometry.py:173-202): keep (o, n) iff dx>0 or (dx==0 && dy>0)
        if (o != n) {
            double dx = centroids[2 * o] - centroids[2 * n];
            double dy = centroids[2 * o + 1] - centroids[2 * n + 1];
            bool keep = dx > 0.0 || (dx == 0.0 && dy > 0.0);
            if (!keep) {
                std::swap(o, n);
                std::swap(o_slot, n_slot);
            }
        }
        cell_edge_index[f] = o;
        cell_edge_index[num_faces + f] = n;
        owner_local_slot[f] = o_slot;
        cell_face_sign[o * 3 + o_slot] = 1.0f;
        if (o != n) cell_face_sign[n * 3 + n_slot] = -1.0f;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Vertex incidence (ops/segment.build_vertex_incidence)
// ---------------------------------------------------------------------------

// Returns the max vertex degree (table width).
int64_t incidence_max_degree(const int64_t* vertex_edge_index,
                             int64_t num_faces, int64_t num_vertices) {
    std::vector<int64_t> deg(num_vertices, 0);
    for (int64_t e = 0; e < num_faces; ++e) {
        ++deg[vertex_edge_index[e]];
        ++deg[vertex_edge_index[num_faces + e]];
    }
    return *std::max_element(deg.begin(), deg.end());
}

// Fills edge_id/half/valid tables of shape (V, D).
int incidence_fill(const int64_t* vertex_edge_index, int64_t num_faces,
                   int64_t num_vertices, int64_t D,
                   int32_t* edge_id, int32_t* half, uint8_t* valid) {
    std::vector<int64_t> cursor(num_vertices, 0);
    for (int h = 0; h < 2; ++h) {
        const int64_t* verts = vertex_edge_index + h * num_faces;
        for (int64_t e = 0; e < num_faces; ++e) {
            int64_t v = verts[e];
            int64_t j = cursor[v]++;
            if (j >= D) return -1;
            edge_id[v * D + j] = static_cast<int32_t>(e);
            half[v * D + j] = h;
            valid[v * D + j] = 1;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Banded table fill (ops/banded._build_table inner loops)
// ---------------------------------------------------------------------------

// Generic banded band computation: for each target, sources given as a CSR
// (indptr (T+1,), indices (nnz,)). Writes per-tile [lo, hi] into band_lo/hi.
void banded_band_limits(const int64_t* indptr, const int64_t* indices,
                        int64_t num_targets, int64_t tile, int64_t num_sources,
                        int64_t* band_lo, int64_t* band_hi) {
    int64_t num_tiles = (num_targets + tile - 1) / tile;
    for (int64_t t = 0; t < num_tiles; ++t) {
        band_lo[t] = num_sources;
        band_hi[t] = 0;
    }
    for (int64_t tgt = 0; tgt < num_targets; ++tgt) {
        int64_t t = tgt / tile;
        for (int64_t k = indptr[tgt]; k < indptr[tgt + 1]; ++k) {
            band_lo[t] = std::min(band_lo[t], indices[k]);
            band_hi[t] = std::max(band_hi[t], indices[k]);
        }
    }
}

// Fills the dense one-hot (T, tile, B) given CSR sources + weights.
void banded_onehot_fill(const int64_t* indptr, const int64_t* indices,
                        const float* weights, int64_t num_targets,
                        int64_t tile, int64_t B, const int32_t* band_start,
                        float* onehot) {
    for (int64_t tgt = 0; tgt < num_targets; ++tgt) {
        int64_t t = tgt / tile, r = tgt % tile;
        float* row = onehot + (t * tile + r) * B;
        for (int64_t k = indptr[tgt]; k < indptr[tgt + 1]; ++k) {
            int64_t off = indices[k] - band_start[t];
            if (off >= 0 && off < B) row[off] += weights[k];
        }
    }
}

// Flat-triple variant: (target, source, weight) in any order; offsets are
// per-tile band starts. onehot is (rows, B) zero-initialized by the caller.
// Returns the number of out-of-band entries that could not be placed — the
// Python wrapper raises when this is nonzero (a dropped entry means the
// aggregation silently loses a mesh edge; see ops/banded._build_table).
int64_t banded_fill_flat(const int64_t* tgt, const int64_t* srcs,
                         const float* w, int64_t nnz, int64_t tile, int64_t B,
                         const int32_t* offsets, float* onehot) {
    int64_t dropped = 0;
    for (int64_t k = 0; k < nnz; ++k) {
        int64_t t = tgt[k] / tile;
        int64_t col = srcs[k] - offsets[t];
        if (col >= 0 && col < B) onehot[tgt[k] * B + col] += w[k];
        else ++dropped;
    }
    return dropped;
}

}  // extern "C" 
