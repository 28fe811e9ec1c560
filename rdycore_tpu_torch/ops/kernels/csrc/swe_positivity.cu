// K3b swe_positivity: the Audusse donor-cell positivity limiter of the
// second-order unstructured flux, in two entry kernels.
//
// Replaces the TPU kernels _cell_kernel(drain=True) / cell_drain_slotted
// (rdycore_tpu/ops/pallas/slotted.py :1441 / :1597) and _pos_scale_kernel
// / positivity_scale_slotted (:1654 / :1712), i.e. the JAX package's
// SWEOperator._apply_positivity_limit (operator.py:1084-1115).
//
// Both read K1a's flux records, flux[E + 1, ndof] (each edge's ndof fluxes
// side by side, record E the zero dummy; csrc/swe_edge_flux.cu).
// drain: one thread per cell pulls the h-flux of each of its cell_edges
//   slots in order, drain = -sum_k min(f_h[e_k] * coef[c, k], 0) (boundary
//   edges included, padding slots are the zero record E), and writes the
//   donor factor s = clip(h / (dt * drain), 0, 1), or 1 where drain = 0.
//   A step with dt <= 0 divides by 1 instead of dt, as the raster kernel
//   does (structured_step.py:513): a dry donor (h = 0, drain > 0) then
//   gives s = 0, not 0/0, and the step's dt * rhs is zero anyway.
// scale: one thread per edge scales its record in place by its donor's
//   factor: an interior edge by s[int_left] where f_h > 0, else
//   s[int_right]; a boundary edge by s[bnd_left] where f_h > 0, else 1
//   (inflow through a boundary is not limited). Records Ei:E are so the
//   scaled boundary fluxes that the accumulators read, as in the JAX
//   package.
// Wet cells get s = 1 exactly, so their fluxes are unchanged. No atomics,
// a fixed slot order: the result does not depend on the launch
// configuration.
//
// Bound: device memory. drain reads 4 edge ids and 4 coefficients per cell
// and h, gathers the h-fluxes (each edge's value counted once) and writes
// s: about 138 MB in f32 at 2,883,584 cells, at least 0.041 ms at the
// H100's 3.35 TB/s. scale reads the h-flux, two cell ids and two factors
// per edge and reads and writes the 3 flux rows: about 196 MB, 0.059 ms.
// What binds drain is the sectors of its h-flux gathers. With records a
// sector also holds the momentum fluxes, which drain does not read, and
// the h-fluxes span ndof times the memory (52 MB at 4.33M edges in f32,
// more than the 50 MB L2, against 17 MB as a row). scale reads and writes
// each record whole, in edge order. Measured on an NVIDIA H100 80GB HBM3
// at 700 W, f32, on the 2,884,416-triangle valley and the 2048x1408 dam
// break (tools/torch_kernel_times.py --cases gathers, the kernels on a
// row-major flux timed in the same call): drain 0.1079 ms against 0.0590
// in a shuffled file order, 0.0550 against 0.0463-0.0465 under RCM,
// 0.0604 against 0.0472-0.0473 on the dam break; scale 0.0740 against
// 0.0961, 0.0693 against 0.0911, 0.0888-0.0938 against 0.1151; the same
// outputs to the bit.
#include "swe_physics.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) swe_positivity_drain_kernel(
    const T* __restrict__ flux, int ndof,
    const int32_t* __restrict__ cell_edges, const T* __restrict__ coef,
    int K, const T* __restrict__ h, const T* __restrict__ dt_ptr, int64_t C,
    T* __restrict__ s) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= C) return;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int64_t e = cell_edges[c * K + k];
    const T contrib = flux[e * ndof] * coef[c * K + k];
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
    T* __restrict__ flux, int ndof, const int32_t* __restrict__ int_left,
    const int32_t* __restrict__ int_right, int64_t Ei,
    const int32_t* __restrict__ bnd_left, int64_t Eb,
    const T* __restrict__ s) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= Ei + Eb) return;
  T* __restrict__ rec = flux + e * ndof;
  const T fh = rec[0];
  T sc;
  if (e < Ei) {
    sc = fh > T(0) ? s[int_left[e]] : s[int_right[e]];
  } else {
    sc = fh > T(0) ? s[bnd_left[e - Ei]] : T(1);
  }
  for (int k = 0; k < ndof; ++k) rec[k] *= sc;
}

template <typename T>
int launch_drain(const void* flux, int ndof, const void* cell_edges,
                 const void* coef, int K, const void* h, const void* dt,
                 int64_t C, void* s, void* stream) {
  if (C < 1) return 0;
  const int threads = 256;
  const int64_t blocks = (C + threads - 1) / threads;
  swe_positivity_drain_kernel<T><<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const T*)flux, ndof, (const int32_t*)cell_edges, (const T*)coef, K,
      (const T*)h, (const T*)dt, C, (T*)s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scale(void* flux, int ndof, const void* int_left,
                 const void* int_right, int64_t Ei, const void* bnd_left,
                 int64_t Eb, const void* s, void* stream) {
  const int64_t n = Ei + Eb;
  if (n < 1) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  swe_positivity_scale_kernel<T><<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (T*)flux, ndof, (const int32_t*)int_left,
      (const int32_t*)int_right, Ei, (const int32_t*)bnd_left, Eb,
      (const T*)s);
  return (int)cudaGetLastError();
}

}  // namespace

// drain: s[C] from the h-fluxes of the records flux[E + 1, ndof] (record E
// zero), the [C, K] cell_edges and coefficients, h[C] and dt (device
// memory). scale: the records flux[E + 1, ndof] scaled in place over the
// first Ei + Eb. Both return cudaGetLastError().
#define RDY_POSITIVITY_API(SUFFIX, T)                                        \
  extern "C" int rdy_swe_positivity_drain_##SUFFIX(                          \
      const void* flux, int ndof, const void* cell_edges, const void* coef,  \
      int K, const void* h, const void* dt, int64_t C, void* s,              \
      void* stream) {                                                        \
    return launch_drain<T>(flux, ndof, cell_edges, coef, K, h, dt, C, s,     \
                           stream);                                          \
  }                                                                          \
  extern "C" int rdy_swe_positivity_scale_##SUFFIX(                          \
      void* flux, int ndof, const void* int_left, const void* int_right,     \
      int64_t Ei, const void* bnd_left, int64_t Eb, const void* s,           \
      void* stream) {                                                        \
    return launch_scale<T>(flux, ndof, int_left, int_right, Ei, bnd_left,    \
                           Eb, s, stream);                                   \
  }

RDY_POSITIVITY_API(f32, float)
RDY_POSITIVITY_API(f64, double)
