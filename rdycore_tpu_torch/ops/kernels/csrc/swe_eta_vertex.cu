// K5 swe_eta_vertex: the BS2002 free-surface elevation at every vertex.
//
// Replaces the TPU kernels _route_kernel / route_gather
// (rdycore_tpu/ops/pallas/routed.py :204 / :227) and _accum_kernel /
// accumulate (:264 / :284) as rdycore_tpu/ops/swe/bs2002.py eta_slotted
// (:366-406) chains them: cell eta routed to (vertex, cell) pairs and
// averaged per vertex, then routed to the edges' begin and end slots. The
// card gathers, so no route plan is ported: this kernel forms the vertex
// average, and K1a (csrc/swe_edge_flux.cu, kWbBS2002) reads eta at its
// two endpoints itself.
//
// One thread per vertex v. It pulls the cells of vertex_cells[v, :K] in
// slot order (cells ascending; the padding id C is skipped), forms each
// cell's eta from its sorted vertex beds z1 <= z2 <= z3 and its depth h
// (rdy::eta_cell, the plain version's eta_cells), sums them in slot order
// and writes eta_v[v] = sum * vertex_inv_count[v]. No atomics, so the
// result does not depend on the launch configuration.
//
// A cell's eta is formed inline by each of its (3 or 4) vertices rather
// than by a per-cell pass first: that pass would write C values and read
// them back, where the inline form repeats about 30 operations (a cube
// root or a square root on a partly wet cell) that the card's arithmetic
// rate hides. Bound: device memory. It reads K int32 ids and one inverse
// count per vertex and z1, z2, z3 and h of every cell (each counted once),
// and writes one value per vertex: for the 1,444,653 vertices (K = 6) and
// 2,884,416 triangles of a 1448x996 mesh in f32 about 92 MB, at least
// 0.028 ms at the H100's 3.35 TB/s. Design: consecutive threads take
// consecutive vertices, so the id rows, counts and output are coalesced;
// the cell gathers hit neighbouring cells for neighbouring vertices on a
// row-major mesh.
#include "swe_physics.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) swe_eta_vertex_kernel(
    const int32_t* __restrict__ vertex_cells, int K,
    const T* __restrict__ inv_count, int64_t NV, const T* __restrict__ z1,
    const T* __restrict__ z2, const T* __restrict__ z3,
    const T* __restrict__ h, int64_t C, T tiny_h, T* __restrict__ eta_v) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (v >= NV) return;
  T sum = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t c = vertex_cells[v * K + k];
    if (c < C) sum += rdy::eta_cell(z1[c], z2[c], z3[c], h[c], tiny_h);
  }
  eta_v[v] = sum * inv_count[v];
}

template <typename T>
int launch(const void* vertex_cells, int K, const void* inv_count,
           int64_t NV, const void* z1, const void* z2, const void* z3,
           const void* h, int64_t C, T tiny_h, void* eta_v, void* stream) {
  if (NV == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int64_t blocks = (NV + threads - 1) / threads;
  swe_eta_vertex_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)vertex_cells, K, (const T*)inv_count, NV,
      (const T*)z1, (const T*)z2, (const T*)z3, (const T*)h, C, tiny_h,
      (T*)eta_v);
  return (int)cudaGetLastError();
}

}  // namespace

// vertex_cells [NV, K] int32 (padded with C), inv_count [NV], the cells'
// sorted vertex beds z1, z2, z3 [C] and depths h [C]; writes eta_v [NV].
// Returns cudaGetLastError().
#define RDY_ETA_VERTEX_API(SUFFIX, T)                                       \
  extern "C" int rdy_swe_eta_vertex_##SUFFIX(                               \
      const void* vertex_cells, int K, const void* inv_count, int64_t NV,   \
      const void* z1, const void* z2, const void* z3, const void* h,        \
      int64_t C, T tiny_h, void* eta_v, void* stream) {                     \
    return launch<T>(vertex_cells, K, inv_count, NV, z1, z2, z3, h, C,      \
                     tiny_h, eta_v, stream);                                \
  }

RDY_ETA_VERTEX_API(f32, float)
RDY_ETA_VERTEX_API(f64, double)
