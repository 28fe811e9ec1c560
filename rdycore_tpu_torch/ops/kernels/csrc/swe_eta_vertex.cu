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
// Two phases, the structure of the plain version (ops/swe/bs2002.py
// eta_vertices: eta_cells, then the gather):
// - the cell phase: one thread per cell c writes eta_c[c] =
//   rdy::eta_cell(z1, z2, z3, h), the cell's eta from its sorted vertex
//   beds z1 <= z2 <= z3 and its depth h; it reads 16 bytes and writes 4
//   per cell (f32), coalesced;
// - the vertex phase: one thread per vertex v sums eta_c over the cells of
//   vertex_cells[v, :K] in slot order (cells ascending; the padding id C
//   is skipped) and writes eta_v[v] = sum * vertex_inv_count[v].
// Two launches on one stream, the second after the first; the wrapper
// allocates eta_c. No atomics, so the result does not depend on the launch
// configuration, and a shard (the same rows in the same slot order) gives
// the single device's values bit for bit.
//
// Bound: device memory. Counted once: K int32 ids and one inverse count
// per vertex, z1, z2, z3 and h of every cell, one value written per vertex
// (eta_c, which stays in the L2, is not counted): for the 1,444,653
// vertices (K = 6) and 2,884,416 triangles of a 1448x996 mesh in f32 about
// 92 MB, at least 0.028 ms at the H100's 3.35 TB/s. What binds is the
// sectors the vertex gathers touch: a 4-byte gather costs a whole 32-byte
// sector wherever neighbouring threads share no cells, as on a shard whose
// cells are in RCM order and whose vertices are in global-id order. Forming
// each cell's eta inside the vertex loop would gather z1, z2, z3 and h
// (four arrays, up to 4K sectors a vertex); after the cell phase a vertex
// gathers one array (11.5 MB at 2.88M cells in f32, held by the 50 MB L2),
// at most K sectors, for C values written and read back. eta_c holds the
// same values as an inline eta_cell would give the sum (0.5 * x is exact,
// so no contraction into the sum changes a bit).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, f32
// (tools/torch_kernel_times.py --cases gathers, the one-pass kernel timed
// in the same call): rank 0's shard of 2 of the BS2002 deck above under
// RCM (1,446,209 cells, 723,852 vertices) 0.0359-0.0360 ms against the
// one-pass kernel's 0.1149-0.1170 (bound 0.0138); the whole mesh in the
// generator's order 0.0461-0.0463 against 0.0422 (bound 0.0276: the
// second launch and eta_c's round trip); the same values to the bit. With
// the shard's vertices renumbered by their first cell the one-pass kernel
// takes 0.0228-0.0233 ms and this one 0.0224: the vertex order is most of
// the cost.
#include "swe_physics.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) swe_eta_cell_kernel(
    const T* __restrict__ z1, const T* __restrict__ z2,
    const T* __restrict__ z3, const T* __restrict__ h, int64_t C, T tiny_h,
    T* __restrict__ eta_c) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= C) return;
  eta_c[c] = rdy::eta_cell(z1[c], z2[c], z3[c], h[c], tiny_h);
}

template <typename T>
__global__ void __launch_bounds__(256) swe_eta_vertex_kernel(
    const int32_t* __restrict__ vertex_cells, int K,
    const T* __restrict__ inv_count, int64_t NV, const T* __restrict__ eta_c,
    int64_t C, T* __restrict__ eta_v) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (v >= NV) return;
  T sum = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t c = vertex_cells[v * K + k];
    if (c < C) sum += eta_c[c];
  }
  eta_v[v] = sum * inv_count[v];
}

template <typename T>
int launch(const void* vertex_cells, int K, const void* inv_count,
           int64_t NV, const void* z1, const void* z2, const void* z3,
           const void* h, int64_t C, T tiny_h, void* eta_c, void* eta_v,
           void* stream) {
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  if (C > 0) {
    swe_eta_cell_kernel<T><<<(unsigned)((C + threads - 1) / threads),
                             threads, 0, st>>>(
        (const T*)z1, (const T*)z2, (const T*)z3, (const T*)h, C, tiny_h,
        (T*)eta_c);
    const int status = (int)cudaGetLastError();
    if (status != 0) return status;
  }
  if (NV > 0) {
    swe_eta_vertex_kernel<T><<<(unsigned)((NV + threads - 1) / threads),
                               threads, 0, st>>>(
        (const int32_t*)vertex_cells, K, (const T*)inv_count, NV,
        (const T*)eta_c, C, (T*)eta_v);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vertex_cells [NV, K] int32 (padded with C), inv_count [NV], the cells'
// sorted vertex beds z1, z2, z3 [C] and depths h [C]; eta_c [C] is the
// cell phase's scratch; writes eta_v [NV]. Returns cudaGetLastError().
#define RDY_ETA_VERTEX_API(SUFFIX, T)                                       \
  extern "C" int rdy_swe_eta_vertex_##SUFFIX(                               \
      const void* vertex_cells, int K, const void* inv_count, int64_t NV,   \
      const void* z1, const void* z2, const void* z3, const void* h,        \
      int64_t C, T tiny_h, void* eta_c, void* eta_v, void* stream) {        \
    return launch<T>(vertex_cells, K, inv_count, NV, z1, z2, z3, h, C,      \
                     tiny_h, eta_c, eta_v, stream);                         \
  }

RDY_ETA_VERTEX_API(f32, float)
RDY_ETA_VERTEX_API(f64, double)
