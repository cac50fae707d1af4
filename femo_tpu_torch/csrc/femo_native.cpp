// femo_tpu native runtime components (C ABI, ctypes-loaded).
//
// The reference inherits its native mesh/runtime layer from dolfinx C++
// (SURVEY.md N2): partitioning, dof orderings, topology derivation.  These
// are the host-side equivalents here, used to prepare device-friendly
// layouts: RCB cell partitioning for SPMD sharding, reverse Cuthill-McKee
// dof ordering for banded/dense factorizations, greedy cell coloring for
// conflict-free scatter schedules, and sort-based unique-facet extraction.
//
// Build: g++ -O3 -shared -fPIC femo_native.cpp -o libfemo_native.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Recursive coordinate bisection over cell centroids.
// centroids: (n, dim) row-major; out_part: (n,) int32 in [0, nparts)
// nparts must be a power of two.
// ---------------------------------------------------------------------------
static void rcb_recurse(const double* c, int dim, int32_t* part,
                        std::vector<int64_t>& idx, int64_t lo, int64_t hi,
                        int32_t p0, int32_t np) {
  if (np == 1) {
    for (int64_t i = lo; i < hi; ++i) part[idx[i]] = p0;
    return;
  }
  // split along the widest axis
  int axis = 0;
  double best = -1.0;
  for (int d = 0; d < dim; ++d) {
    double mn = 1e300, mx = -1e300;
    for (int64_t i = lo; i < hi; ++i) {
      double v = c[idx[i] * dim + d];
      mn = std::min(mn, v);
      mx = std::max(mx, v);
    }
    if (mx - mn > best) { best = mx - mn; axis = d; }
  }
  int64_t mid = lo + (hi - lo) / 2;
  std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                   [&](int64_t a, int64_t b) {
                     return c[a * dim + axis] < c[b * dim + axis];
                   });
  rcb_recurse(c, dim, part, idx, lo, mid, p0, np / 2);
  rcb_recurse(c, dim, part, idx, mid, hi, p0 + np / 2, np - np / 2);
}

void rcb_partition(const double* centroids, int64_t n, int dim,
                   int32_t nparts, int32_t* out_part) {
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  rcb_recurse(centroids, dim, out_part, idx, 0, n, 0, nparts);
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering of a CSR graph.
// indptr (n+1), indices (nnz); out_perm (n): new-to-old permutation.
// ---------------------------------------------------------------------------
void rcm_order(const int64_t* indptr, const int32_t* indices, int64_t n,
               int32_t* out_perm) {
  std::vector<int32_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = int32_t(indptr[i + 1] - indptr[i]);
  std::vector<char> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<int32_t> nbrs;
  for (;;) {
    // lowest-degree unvisited seed
    int64_t seed = -1;
    int32_t dmin = INT32_MAX;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && degree[i] < dmin) { dmin = degree[i]; seed = i; }
    if (seed < 0) break;
    std::queue<int32_t> q;
    q.push(int32_t(seed));
    visited[seed] = 1;
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      order.push_back(u);
      nbrs.clear();
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int32_t v = indices[k];
        if (!visited[v]) { visited[v] = 1; nbrs.push_back(v); }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });
      for (int32_t v : nbrs) q.push(v);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) out_perm[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------------
// Greedy cell coloring: cells sharing a dof get different colors.
// cell_dofs: (n_cells, nd) int32; out_color: (n_cells,) int32.
// Returns number of colors.
// ---------------------------------------------------------------------------
int32_t greedy_color(const int32_t* cell_dofs, int64_t n_cells, int32_t nd,
                     int64_t n_dofs, int32_t* out_color) {
  // dof -> last color seen per cell pass; use per-dof color usage marks
  std::vector<std::vector<int32_t>> dof_cells(n_dofs);
  for (int64_t c = 0; c < n_cells; ++c)
    for (int32_t k = 0; k < nd; ++k) dof_cells[cell_dofs[c * nd + k]].push_back(int32_t(c));
  std::vector<int32_t> mark;  // colors used by neighbors
  int32_t ncolors = 0;
  for (int64_t c = 0; c < n_cells; ++c) {
    mark.clear();
    for (int32_t k = 0; k < nd; ++k) {
      for (int32_t nb : dof_cells[cell_dofs[c * nd + k]]) {
        if (nb < c && out_color[nb] >= 0) mark.push_back(out_color[nb]);
      }
    }
    std::sort(mark.begin(), mark.end());
    int32_t col = 0;
    for (int32_t m : mark) {
      if (m == col) ++col;
      else if (m > col) break;
    }
    out_color[c] = col;
    ncolors = std::max(ncolors, col + 1);
  }
  return ncolors;
}

// ---------------------------------------------------------------------------
// Unique facet extraction: keys (n_keys, nvf) sorted-vertex facet tuples.
// Outputs: out_ids (n_keys) mapping each key to its unique facet index;
// returns number of unique facets. Keys assumed pre-sorted per row.
// ---------------------------------------------------------------------------
int64_t unique_facets(const int32_t* keys, int64_t n_keys, int32_t nvf,
                      int64_t* out_ids) {
  std::vector<int64_t> order(n_keys);
  std::iota(order.begin(), order.end(), 0);
  auto cmp = [&](int64_t a, int64_t b) {
    return std::lexicographical_compare(
        keys + a * nvf, keys + (a + 1) * nvf,
        keys + b * nvf, keys + (b + 1) * nvf);
  };
  std::sort(order.begin(), order.end(), cmp);
  int64_t uid = -1;
  for (int64_t i = 0; i < n_keys; ++i) {
    if (i == 0 || cmp(order[i - 1], order[i])) ++uid;
    out_ids[order[i]] = uid;
  }
  return uid + 1;
}

// ---------------------------------------------------------------------------
// Block-tridiagonal destination map (BlockTridiagTemplate.__init__ hot
// loop).  For one element-matrix block of shape (ne, nr, nc) with global
// row/col index tables, computes for every (e, i, j) entry the flattened
// destination id in the (D, L, U) accumulator, or `dump` when the entry is
// masked (BC row/col or off-tridiagonal).  One fused pass replaces ~40
// full-array numpy passes over ne*nr*nc int64 temporaries (measured 125 s
// -> seconds at 39M entries on this box's single core).
//
// rows: (ne, nr) int64 global dof rows; cols: (ne, nc) int64 global cols;
// iperm: (n,) int64 old->new RCM dof map; free_mask: (n,) uint8 or null;
// out: (ne*nr*nc,) int64.
// ---------------------------------------------------------------------------
void bt_dest_map(const int64_t* rows, const int64_t* cols, int64_t ne,
                 int32_t nr, int32_t nc, const int64_t* iperm,
                 const uint8_t* free_mask, int64_t B, int64_t nb,
                 int64_t dump, int64_t* out) {
  std::vector<int64_t> bj(nc), lj(nc);
  std::vector<uint8_t> cfree(nc);
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t* ce = cols + e * nc;
    for (int32_t j = 0; j < nc; ++j) {
      int64_t g = ce[j];
      int64_t p = iperm[g];
      bj[j] = p / B;
      lj[j] = p % B;
      cfree[j] = free_mask ? free_mask[g] : 1;
    }
    const int64_t* re = rows + e * nr;
    int64_t* oe = out + e * (int64_t)nr * nc;
    for (int32_t i = 0; i < nr; ++i) {
      int64_t g = re[i];
      int64_t p = iperm[g];
      int64_t bi = p / B, li = p % B;
      uint8_t rfree = free_mask ? free_mask[g] : 1;
      int64_t* oi = oe + (int64_t)i * nc;
      for (int32_t j = 0; j < nc; ++j) {
        int64_t which;
        if (bi == bj[j]) which = 0;
        else if (bi == bj[j] + 1) which = 1;
        else if (bi + 1 == bj[j]) which = 2;
        else which = -1;
        if (which < 0 || !rfree || !cfree[j]) {
          oi[j] = dump;
        } else {
          oi[j] = ((which * nb + bi) * B + li) * B + lj[j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CSR sparsity pattern from COO entry lists (duplicates collapsed).
// gr/gc: (n_entries,) int32 row/col ids; n: matrix dimension.
// out_indptr: (n+1,) int64; out_indices: (n_entries,) int32 buffer, the
// unique column ids packed per row in ascending order.  Returns nnz.
// Counting-sort by row then per-row sort+unique — replaces the scipy
// coo_tocsr + f64 value machinery when only the graph is needed (RCM).
// ---------------------------------------------------------------------------
int64_t csr_pattern_finalize(const int64_t* off, int32_t* cols_buf,
                             int64_t n, int64_t* out_indptr,
                             int32_t* out_indices);

int64_t csr_pattern(const int32_t* gr, const int32_t* gc, int64_t n_entries,
                    int64_t n, int64_t* out_indptr, int32_t* out_indices) {
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t k = 0; k < n_entries; ++k) ++count[gr[k] + 1];
  std::vector<int64_t> off(n + 1);
  off[0] = 0;
  for (int64_t i = 0; i < n; ++i) off[i + 1] = off[i] + count[i + 1];
  std::vector<int32_t> cols(n_entries);
  {
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (int64_t k = 0; k < n_entries; ++k) cols[cur[gr[k]]++] = gc[k];
  }
  return csr_pattern_finalize(off.data(), cols.data(), n, out_indptr,
                              out_indices);
}

// ---------------------------------------------------------------------------
// Blockwise CSR pattern build: the (ne,nr)x(ne,nc) element row/col id arrays
// are expanded straight into the counting-sort buffers, so the n_entries-
// sized COO id arrays are never materialized on the Python side.
// Call csr_block_count per block (accumulates pair counts per row into
// count[r+1]), cumsum on the host, then csr_block_fill per block (packs the
// column ids using the running cursor), then csr_pattern_finalize once
// (per-row sort + unique).  Returns nnz.
// ---------------------------------------------------------------------------
void csr_block_count(const int32_t* rows, int64_t ne, int64_t nr,
                     int64_t nc, int64_t* count) {
  for (int64_t k = 0; k < ne * nr; ++k) count[rows[k] + 1] += nc;
}

void csr_block_fill(const int32_t* rows, const int32_t* cols, int64_t ne,
                    int64_t nr, int64_t nc, int64_t* cur,
                    int32_t* cols_buf) {
  for (int64_t e = 0; e < ne; ++e) {
    const int32_t* ce = cols + e * nc;
    for (int64_t i = 0; i < nr; ++i) {
      int64_t& p = cur[rows[e * nr + i]];
      for (int64_t j = 0; j < nc; ++j) cols_buf[p + j] = ce[j];
      p += nc;
    }
  }
}

int64_t csr_pattern_finalize(const int64_t* off, int32_t* cols_buf,
                             int64_t n, int64_t* out_indptr,
                             int32_t* out_indices) {
  int64_t nnz = 0;
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t* beg = cols_buf + off[i];
    int32_t* end = cols_buf + off[i + 1];
    std::sort(beg, end);
    int32_t* last = std::unique(beg, end);
    for (int32_t* p = beg; p != last; ++p) out_indices[nnz++] = *p;
    out_indptr[i + 1] = nnz;
  }
  return nnz;
}

// max |iperm[r] - iperm[c]| over the CSR pattern (RCM bandwidth check)
int64_t csr_bandwidth(const int64_t* indptr, const int32_t* indices,
                      const int64_t* iperm, int64_t n) {
  int64_t bw = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t pi = iperm[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int64_t d = pi - iperm[indices[k]];
      if (d < 0) d = -d;
      if (d > bw) bw = d;
    }
  }
  return bw;
}

}  // extern "C"
