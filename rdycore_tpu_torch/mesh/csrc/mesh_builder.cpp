// The native mesh builder of rdycore_tpu_torch: the setup-time core of the
// DMPlex replacement (reference: src/rdymesh.c RDyEdgesCreateFromDM).
//
//   - rdy_extract_edges: edge extraction and deduplication from cell ->
//     vertex connectivity (an open-addressing hash, one pass over cells)
//   - rdy_rcm_order: reverse Cuthill-McKee ordering of the cell graph
//   - rdy_cell_geometry: areas, centroids, bed slopes and the
//     vertex-averaged elevation, a bitwise twin of the numpy geometry in
//     mesh/core.py when compiled with -ffp-contract=off
//
// The port's own copy of these three entry points of the JAX package's
// csrc/mesh_builder.cpp, with the same results. Built at first use by
// rdycore_tpu_torch/mesh/build.py and bound with ctypes in mesh/native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

// Extract unique edges from tri/quad cells.
//
// cell_vertices: [num_cells * 4], -1 padded; CCW orientation assumed.
// Outputs (caller-allocated, capacity 4 * num_cells), numbered in order of
// first appearance over cells and their vertex slots:
//   edge_left/right: adjacent cell ids (right = -1 on boundary),
//     left = smaller cell id of the pair
//   edge_lslot/rslot: local edge slot (0..3) within left/right cell
// Returns the number of unique edges, or -1 on a non-manifold edge.
int64_t rdy_extract_edges(int64_t num_cells, int64_t num_points,
                          const int32_t* cell_vertices,
                          const int32_t* cell_nverts, int32_t* edge_left,
                          int32_t* edge_right, int32_t* edge_lslot,
                          int32_t* edge_rslot) {
  // open-addressing hash table keyed by (vmin, vmax)
  const int64_t max_edges = 4 * num_cells;
  int64_t cap = 1;
  while (cap < 2 * max_edges) cap <<= 1;
  const int64_t mask = cap - 1;
  std::vector<int64_t> keys(cap, -1);
  std::vector<int64_t> slots(cap, -1);  // -> edge index

  int64_t num_edges = 0;
  for (int64_t c = 0; c < num_cells; ++c) {
    const int32_t nv = cell_nverts[c];
    for (int32_t k = 0; k < nv; ++k) {
      const int32_t a = cell_vertices[4 * c + k];
      const int32_t b = cell_vertices[4 * c + ((k + 1) % nv)];
      const int64_t vmin = a < b ? a : b;
      const int64_t vmax = a < b ? b : a;
      const int64_t key = vmin * num_points + vmax;
      // splitmix-style scramble
      uint64_t h = (uint64_t)key;
      h ^= h >> 33;
      h *= 0xff51afd7ed558ccdULL;
      h ^= h >> 33;
      int64_t pos = (int64_t)(h & (uint64_t)mask);
      for (;;) {
        if (keys[pos] == -1) {
          // new edge
          keys[pos] = key;
          slots[pos] = num_edges;
          edge_left[num_edges] = (int32_t)c;
          edge_right[num_edges] = -1;
          edge_lslot[num_edges] = k;
          edge_rslot[num_edges] = -1;
          ++num_edges;
          break;
        }
        if (keys[pos] == key) {
          const int64_t e = slots[pos];
          if (edge_right[e] != -1) return -1;  // non-manifold
          // second cell: keep left = smaller cell id
          if ((int32_t)c < edge_left[e]) {
            edge_right[e] = edge_left[e];
            edge_rslot[e] = edge_lslot[e];
            edge_left[e] = (int32_t)c;
            edge_lslot[e] = k;
          } else {
            edge_right[e] = (int32_t)c;
            edge_rslot[e] = k;
          }
          break;
        }
        pos = (pos + 1) & mask;
      }
    }
  }
  return num_edges;
}

// Reverse Cuthill-McKee ordering of the cell adjacency graph (via edges):
// each component from its lowest unvisited cell, breadth first, the
// neighbours of a cell by (degree, id), the whole order reversed. After
// reordering, edge endpoints are close in index space, so gathers touch
// nearby state.
// edge_left/right: [num_edges]; perm_out: [num_cells] (new order: old ids).
void rdy_rcm_order(int64_t num_cells, int64_t num_edges,
                   const int32_t* edge_left, const int32_t* edge_right,
                   int32_t* perm_out) {
  // build adjacency (CSR)
  std::vector<int32_t> degree(num_cells, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    if (edge_right[e] >= 0) {
      ++degree[edge_left[e]];
      ++degree[edge_right[e]];
    }
  }
  std::vector<int64_t> offset(num_cells + 1, 0);
  for (int64_t c = 0; c < num_cells; ++c) offset[c + 1] = offset[c] + degree[c];
  std::vector<int32_t> adj(offset[num_cells]);
  std::vector<int64_t> fill(offset.begin(), offset.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t l = edge_left[e], r = edge_right[e];
    if (r >= 0) {
      adj[fill[l]++] = r;
      adj[fill[r]++] = l;
    }
  }

  std::vector<char> visited(num_cells, 0);
  std::vector<int32_t> order;
  order.reserve(num_cells);
  for (int64_t start = 0; start < num_cells; ++start) {
    if (visited[start]) continue;
    std::queue<int32_t> q;
    q.push((int32_t)start);
    visited[start] = 1;
    order.push_back((int32_t)start);
    while (!q.empty()) {
      const int32_t c = q.front();
      q.pop();
      // push neighbors in increasing-degree order
      std::vector<int32_t> nbrs;
      for (int64_t i = offset[c]; i < offset[c + 1]; ++i) {
        const int32_t n = adj[i];
        if (!visited[n]) {
          visited[n] = 1;
          nbrs.push_back(n);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int32_t x, int32_t y) {
        return degree[x] != degree[y] ? degree[x] < degree[y] : x < y;
      });
      for (int32_t n : nbrs) {
        order.push_back(n);
        q.push(n);
      }
    }
  }
  // reverse
  for (int64_t i = 0; i < num_cells; ++i) {
    perm_out[i] = order[num_cells - 1 - i];
  }
}

// Cell geometry: areas, centroids, bed slopes, vertex-averaged elevation.
// Bitwise twin of mesh/core.py _polygon_areas_centroids + _cell_slopes +
// _vertex_mean_z (same per-cell accumulation order, f64, no fp
// contraction: compiled with -ffp-contract=off so a*b - c*d stays two
// roundings like numpy).
void rdy_cell_geometry(
    int64_t num_cells, const double* pts /* [N,3] */,
    const int32_t* cv /* [C,4] */, const int32_t* nvs /* [C] */,
    double* area_o, double* cx_o, double* cy_o, double* cz_o,
    double* dzdx_o, double* dzdy_o, double* cellz_o) {
  const int MAXV = 4;
  for (int64_t c = 0; c < num_cells; ++c) {
    const int32_t nv = nvs[c];
    int32_t vids[4];
    for (int k = 0; k < MAXV; ++k) {
      const int32_t v = cv[4 * c + k];
      vids[k] = v >= 0 ? v : cv[4 * c + 0];
    }
    auto X = [&](int32_t v) { return pts[3 * v + 0]; };
    auto Y = [&](int32_t v) { return pts[3 * v + 1]; };
    auto Z = [&](int32_t v) { return pts[3 * v + 2]; };

    double area = 0.0, cx = 0.0, cy = 0.0;
    for (int k = 0; k < MAXV; ++k) {
      const int k2 = (k + 1) % MAXV;
      const int32_t a = vids[k];
      int32_t b = (k2 < nv) ? vids[k2] : vids[0];
      if (!(k < nv)) b = a;  // padded slot: degenerate
      const double cross = X(a) * Y(b) - X(b) * Y(a);
      area += cross;
      cx += (X(a) + X(b)) * cross;
      cy += (Y(a) + Y(b)) * cross;
    }
    area *= 0.5;
    cx /= 6.0 * area;
    cy /= 6.0 * area;

    double zw = 0.0, wsum = 0.0;
    for (int k = 0; k < MAXV; ++k) {
      const int k2 = (k + 1) % MAXV;
      const int32_t a = vids[k];
      int32_t b = (k2 < nv) ? vids[k2] : vids[0];
      if (!(k < nv)) b = a;
      const double tri =
          0.5 * std::abs((X(a) - cx) * (Y(b) - cy) -
                         (X(b) - cx) * (Y(a) - cy));
      zw += tri * ((Z(a) + Z(b)) / 3.0);
      wsum += tri;
    }
    double zmean = 0.0;
    for (int k = 0; k < MAXV; ++k)
      zmean += (k < nv) ? Z(vids[k]) : 0.0;
    zmean /= (double)nv;
    const double cz =
        zw / std::max(wsum, 1e-300) + zmean / 3.0;

    area_o[c] = std::abs(area);
    cx_o[c] = cx;
    cy_o[c] = cy;
    cz_o[c] = cz;

    // slopes (rdymesh.c:747-860 via the plane-fit form)
    auto tri_slopes = [&](double x0, double y0, double z0, double x1,
                          double y1, double z1, double x2, double y2,
                          double z2, double* sx, double* sy) {
      const double nx = (y1 - y0) * (z2 - z0) - (z1 - z0) * (y2 - y0);
      const double ny = (z1 - z0) * (x2 - x0) - (x1 - x0) * (z2 - z0);
      const double nz = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
      *sx = (nz != 0.0) ? -nx / nz : 0.0;
      *sy = (nz != 0.0) ? -ny / nz : 0.0;
    };
    if (nv == 3) {
      double sx, sy;
      tri_slopes(X(vids[0]), Y(vids[0]), Z(vids[0]), X(vids[1]),
                 Y(vids[1]), Z(vids[1]), X(vids[2]), Y(vids[2]),
                 Z(vids[2]), &sx, &sy);
      dzdx_o[c] = sx;
      dzdy_o[c] = sy;
    } else {
      double ax_ = 0.0, ay_ = 0.0, aa_ = 0.0;
      for (int k = 0; k < 4; ++k) {
        const int32_t a = vids[k];
        const int32_t b = vids[(k + 1) % 4];
        const double ak =
            0.5 * std::abs((X(b) - X(a)) * (cy - Y(a)) -
                           (cx - X(a)) * (Y(b) - Y(a)));
        double sx, sy;
        tri_slopes(X(a), Y(a), Z(a), X(b), Y(b), Z(b), cx, cy, cz, &sx,
                   &sy);
        ax_ += ak * sx;
        ay_ += ak * sy;
        aa_ += ak;
      }
      dzdx_o[c] = ax_ / aa_;
      dzdy_o[c] = ay_ / aa_;
    }

    // vertex-averaged bed elevation (masked mean over real vertices)
    double zsum = 0.0;
    for (int k = 0; k < MAXV; ++k) {
      const int32_t v = cv[4 * c + k];
      zsum += (v >= 0) ? Z(v >= 0 ? v : 0) : 0.0;
    }
    cellz_o[c] = zsum / (double)nv;
  }
}

}  // extern "C"
