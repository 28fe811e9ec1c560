// K1b swe_cell_stage: per-cell flux divergence, sources and RK stage.
//
// Replaces the cell phase of the TPU kernel _fused_step_kernel
// (rdycore_tpu/ops/pallas/slotted.py :2551-2743), the divergence of
// _fused_kernel (:2125) and _cell_kernel (:1441, non-drain), for the flow
// equations (3 unknowns).
//
// One thread per cell. It pulls its edge fluxes over cell_edges in slot
// order, div = sum_k coef[c,k] * flux[:, cell_edges[c,k]] (no atomics, so
// the result does not depend on the launch configuration), adds the
// sources of the chosen method (semi-implicit, XQ2018 or none), and then
//   stage mode: q_out = alpha*qA + beta*(qB + dt*(div + src)), or qB when
//               dt <= 0 (a step past the interval end leaves the state),
//               plus the primitives (h, u, v) of qB when prim != NULL;
//   rhs mode:   flux_div = div and rhs = div + src (and prim when asked).
// dt is read from device memory, so the step loop needs no host sync.
//
// Bound: device memory. Per cell in stage mode (f32, 4 edge slots) it
// reads 4 int32 edge ids, 4 coefficients, 3 state values (6 with qA),
// Manning's n, two bed slopes (and 3 external sources when given) and
// writes 3 values (6 with prim), plus the gathered fluxes, each edge's 12
// bytes counted once: about 104 bytes per cell with prim and no sources,
// 300 MB on the 2.88M-cell dam break, at least 0.090 ms at the H100's
// 3.35 TB/s. Design: consecutive
// threads take consecutive cells, so the per-cell streams are coalesced;
// the [C, 4] index and coefficient rows are read as one 16-byte (f32) or
// 32-byte (f64) row per thread, and the flux gathers hit neighbouring
// columns for neighbouring cells on a row-major raster.
#include "swe_physics.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) swe_cell_stage_kernel(
    const T* __restrict__ flux, int64_t flux_ld,
    const int32_t* __restrict__ cell_edges, const T* __restrict__ coef,
    int K, const T* __restrict__ q, const T* __restrict__ qA,
    const T* __restrict__ dt_ptr, const T* __restrict__ ext,
    const T* __restrict__ mann, const T* __restrict__ dzdx,
    const T* __restrict__ dzdy, int64_t C, T tiny_h, T h_anuga,
    T xq_threshold, int method, T alpha, T beta, T* __restrict__ q_out,
    T* __restrict__ flux_div, T* __restrict__ rhs, T* __restrict__ prim) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= C) return;
  T d0 = T(0), d1 = T(0), d2 = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t e = cell_edges[c * K + k];
    const T w = coef[c * K + k];
    d0 += flux[e] * w;
    d1 += flux[flux_ld + e] * w;
    d2 += flux[2 * flux_ld + e] * w;
  }
  const T dt = *dt_ptr;
  const T h = q[c], hu = q[C + c], hv = q[2 * C + c];
  const T e0 = ext ? ext[c] : T(0);
  const T e1 = ext ? ext[C + c] : T(0);
  const T e2 = ext ? ext[2 * C + c] : T(0);
  T s1, s2;
  rdy::momentum_sources(method, h, hu, hv, d1, d2, e1, e2, mann[c], dzdx[c],
                        dzdy[c], dt, tiny_h, xq_threshold, s1, s2);
  const T r0 = d0 + e0;
  const T r1 = d1 + s1;
  const T r2 = d2 + s2;
  if (q_out) {
    T o0 = h, o1 = hu, o2 = hv;
    if (dt > T(0)) {
      o0 = beta * (h + dt * r0);
      o1 = beta * (hu + dt * r1);
      o2 = beta * (hv + dt * r2);
      if (qA) {
        o0 = alpha * qA[c] + o0;
        o1 = alpha * qA[C + c] + o1;
        o2 = alpha * qA[2 * C + c] + o2;
      }
    }
    q_out[c] = o0;
    q_out[C + c] = o1;
    q_out[2 * C + c] = o2;
  }
  if (flux_div) {
    flux_div[c] = d0;
    flux_div[C + c] = d1;
    flux_div[2 * C + c] = d2;
  }
  if (rhs) {
    rhs[c] = r0;
    rhs[C + c] = r1;
    rhs[2 * C + c] = r2;
  }
  if (prim) {
    const T denom = h * h + h_anuga * h_anuga;
    const T denom_safe = denom > T(0) ? denom : T(1);
    const bool wet = h >= tiny_h;
    prim[c] = h;
    prim[C + c] = wet ? hu * h / denom_safe : T(0);
    prim[2 * C + c] = wet ? hv * h / denom_safe : T(0);
  }
}

template <typename T>
int launch(const void* flux, int64_t flux_ld, const void* cell_edges,
           const void* coef, int K, const void* q, const void* qA,
           const void* dt, const void* ext, const void* mann,
           const void* dzdx, const void* dzdy, int64_t C, T tiny_h,
           T h_anuga, T xq_threshold, int method, T alpha, T beta,
           void* q_out, void* flux_div, void* rhs, void* prim,
           void* stream) {
  if (C == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int64_t blocks = (C + threads - 1) / threads;
  swe_cell_stage_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)flux, flux_ld, (const int32_t*)cell_edges, (const T*)coef, K,
      (const T*)q, (const T*)qA, (const T*)dt, (const T*)ext,
      (const T*)mann, (const T*)dzdx, (const T*)dzdy, C, tiny_h, h_anuga,
      xq_threshold, method, alpha, beta, (T*)q_out, (T*)flux_div, (T*)rhs,
      (T*)prim);
  return (int)cudaGetLastError();
}

}  // namespace

#define RDY_CELL_STAGE_API(SUFFIX, T)                                        \
  extern "C" int rdy_swe_cell_stage_##SUFFIX(                                \
      const void* flux, int64_t flux_ld, const void* cell_edges,             \
      const void* coef, int K, const void* q, const void* qA,                \
      const void* dt, const void* ext, const void* mann, const void* dzdx,   \
      const void* dzdy, int64_t C, T tiny_h, T h_anuga, T xq_threshold,      \
      int method, T alpha, T beta, void* q_out, void* flux_div, void* rhs,   \
      void* prim, void* stream) {                                            \
    return launch<T>(flux, flux_ld, cell_edges, coef, K, q, qA, dt, ext,     \
                     mann, dzdx, dzdy, C, tiny_h, h_anuga, xq_threshold,     \
                     method, alpha, beta, q_out, flux_div, rhs, prim,        \
                     stream);                                                \
  }

RDY_CELL_STAGE_API(f32, float)
RDY_CELL_STAGE_API(f64, double)
