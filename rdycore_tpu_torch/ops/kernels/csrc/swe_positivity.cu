// K3b swe_positivity: the Audusse donor-cell positivity limiter of the
// second-order unstructured flux, in two entry kernels.
//
// Replaces the TPU kernels _cell_kernel(drain=True) / cell_drain_slotted
// (rdycore_tpu/ops/pallas/slotted.py :1441 / :1597) and _pos_scale_kernel
// / positivity_scale_slotted (:1654 / :1712), i.e. the JAX package's
// SWEOperator._apply_positivity_limit (operator.py:1084-1115).
//
// drain: one thread per cell pulls the h-flux of each of its cell_edges
//   slots in order, drain = -sum_k min(f_h[e_k] * coef[c, k], 0) (boundary
//   edges included, padding slots are the zero column E), and writes the
//   donor factor s = clip(h / (dt * drain), 0, 1), or 1 where drain = 0.
//   A step with dt <= 0 divides by 1 instead of dt, as the raster kernel
//   does (structured_step.py:513): a dry donor (h = 0, drain > 0) then
//   gives s = 0, not 0/0, and the step's dt * rhs is zero anyway.
// scale: one thread per edge scales every row of its flux in place by its
//   donor's factor: an interior edge by s[int_left] where f_h > 0, else
//   s[int_right]; a boundary edge by s[bnd_left] where f_h > 0, else 1
//   (inflow through a boundary is not limited). flux[:, Ei:E] is so the
//   scaled boundary flux that the accumulators read, as in the JAX package.
// Wet cells get s = 1 exactly, so their fluxes are unchanged. No atomics,
// a fixed slot order: the result does not depend on the launch
// configuration.
//
// Bound: device memory. drain reads 4 edge ids and 4 coefficients per cell
// and h, gathers the h-fluxes (each edge's value counted once) and writes
// s: about 138 MB in f32 at 2,883,584 cells, at least 0.041 ms at the
// H100's 3.35 TB/s. scale reads the h-flux, two cell ids and two factors
// per edge and reads and writes the 3 flux rows: about 196 MB, 0.059 ms.
#include "swe_physics.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) swe_positivity_drain_kernel(
    const T* __restrict__ flux_h, const int32_t* __restrict__ cell_edges,
    const T* __restrict__ coef, int K, const T* __restrict__ h,
    const T* __restrict__ dt_ptr, int64_t C, T* __restrict__ s) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= C) return;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const T contrib = flux_h[cell_edges[c * K + k]] * coef[c * K + k];
    acc += contrib < T(0) ? contrib : T(0);
  }
  const T drain = -acc;
  const T dt = *dt_ptr;
  const T dt_s = dt > T(0) ? dt : T(1);
  T sc = T(1);
  if (drain > T(0)) {
    sc = h[c] / (dt_s * drain);
    sc = sc < T(0) ? T(0) : (sc > T(1) ? T(1) : sc);
  }
  s[c] = sc;
}

template <typename T>
__global__ void __launch_bounds__(256) swe_positivity_scale_kernel(
    T* __restrict__ flux, int64_t flux_ld, int ndof,
    const int32_t* __restrict__ int_left,
    const int32_t* __restrict__ int_right, int64_t Ei,
    const int32_t* __restrict__ bnd_left, int64_t Eb,
    const T* __restrict__ s) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= Ei + Eb) return;
  const T fh = flux[e];
  T sc;
  if (e < Ei) {
    sc = fh > T(0) ? s[int_left[e]] : s[int_right[e]];
  } else {
    sc = fh > T(0) ? s[bnd_left[e - Ei]] : T(1);
  }
  for (int k = 0; k < ndof; ++k) flux[k * flux_ld + e] *= sc;
}

template <typename T>
int launch_drain(const void* flux_h, const void* cell_edges,
                 const void* coef, int K, const void* h, const void* dt,
                 int64_t C, void* s, void* stream) {
  if (C < 1) return 0;
  const int threads = 256;
  const int64_t blocks = (C + threads - 1) / threads;
  swe_positivity_drain_kernel<T><<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const T*)flux_h, (const int32_t*)cell_edges, (const T*)coef, K,
      (const T*)h, (const T*)dt, C, (T*)s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scale(void* flux, int64_t flux_ld, int ndof, const void* int_left,
                 const void* int_right, int64_t Ei, const void* bnd_left,
                 int64_t Eb, const void* s, void* stream) {
  const int64_t n = Ei + Eb;
  if (n < 1) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  swe_positivity_scale_kernel<T><<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (T*)flux, flux_ld, ndof, (const int32_t*)int_left,
      (const int32_t*)int_right, Ei, (const int32_t*)bnd_left, Eb,
      (const T*)s);
  return (int)cudaGetLastError();
}

}  // namespace

// drain: s[C] from the h-flux row flux_h[E + 1] (column E zero), the
// [C, K] cell_edges and coefficients, h[C] and dt (device memory). scale:
// flux[ndof, flux_ld] scaled in place over its first Ei + Eb columns.
// Both return cudaGetLastError().
#define RDY_POSITIVITY_API(SUFFIX, T)                                        \
  extern "C" int rdy_swe_positivity_drain_##SUFFIX(                          \
      const void* flux_h, const void* cell_edges, const void* coef, int K,   \
      const void* h, const void* dt, int64_t C, void* s, void* stream) {     \
    return launch_drain<T>(flux_h, cell_edges, coef, K, h, dt, C, s,         \
                           stream);                                          \
  }                                                                          \
  extern "C" int rdy_swe_positivity_scale_##SUFFIX(                          \
      void* flux, int64_t flux_ld, int ndof, const void* int_left,           \
      const void* int_right, int64_t Ei, const void* bnd_left, int64_t Eb,   \
      const void* s, void* stream) {                                         \
    return launch_scale<T>(flux, flux_ld, ndof, int_left, int_right, Ei,     \
                           bnd_left, Eb, s, stream);                         \
  }

RDY_POSITIVITY_API(f32, float)
RDY_POSITIVITY_API(f64, double)
