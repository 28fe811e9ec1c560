// K3a swe_muscl_grad: the weighted least-squares gradients of (h, hu, hv)
// of every cell of the unstructured mesh, for MUSCL reconstruction.
//
// Replaces the TPU kernels _grad_kernel / muscl_grad_slotted
// (rdycore_tpu/ops/pallas/slotted.py :3066 / :3107) and the per-edge
// differences of _muscl_pre_kernel (:2946), which exist on the TPU to
// route edge values into slot planes; here each cell gathers them itself.
//
// One thread per cell walks its cell_edges slots in order. For each
// interior edge e (e < Ei) it forms dq = q[int_right[e]] - q[int_left[e]]
// and accumulates cell_ls_cx[c, k] * dq and cell_ls_cy[c, k] * dq (the
// host-built LS coefficients, zero on boundary and padding slots), as
// ops/swe/muscl.py ls_gradients gathers them. Output grad[6, C]: d/dx of
// h, hu, hv, then d/dy. A fixed slot order and no atomics: the result does
// not depend on the launch configuration.
//
// Bound: device memory. Per cell it reads 4 edge ids, 8 coefficients and
// its 3 state values, per interior edge its two cell ids, and writes 6
// gradient values; the gathered neighbour states come from L1/L2. In f32
// at 2,883,584 cells (5.77M interior edges): about 219 MB, at least
// 0.065 ms at the H100's 3.35 TB/s. Arithmetic: 12 multiply-adds per slot.
#include "swe_physics.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) swe_muscl_grad_kernel(
    const T* __restrict__ q, int64_t C, const int32_t* __restrict__ int_left,
    const int32_t* __restrict__ int_right, int64_t Ei,
    const int32_t* __restrict__ cell_edges, const T* __restrict__ cx,
    const T* __restrict__ cy, int K, T* __restrict__ grad) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= C) return;
  T gx[3] = {T(0), T(0), T(0)};
  T gy[3] = {T(0), T(0), T(0)};
  for (int k = 0; k < K; ++k) {
    const int64_t e = cell_edges[c * K + k];
    if (e >= Ei) continue;  // boundary edge or padding: no contribution
    const int64_t l = int_left[e];
    const int64_t r = int_right[e];
    const T wx = cx[c * K + k];
    const T wy = cy[c * K + k];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const T dq = q[m * C + r] - q[m * C + l];
      gx[m] += dq * wx;
      gy[m] += dq * wy;
    }
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    grad[m * C + c] = gx[m];
    grad[(3 + m) * C + c] = gy[m];
  }
}

template <typename T>
int launch(const void* q, int64_t C, const void* int_left,
           const void* int_right, int64_t Ei, const void* cell_edges,
           const void* cx, const void* cy, int K, void* grad, void* stream) {
  if (C < 1) return 0;
  const int threads = 256;
  const int64_t blocks = (C + threads - 1) / threads;
  swe_muscl_grad_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)q, C, (const int32_t*)int_left, (const int32_t*)int_right, Ei,
      (const int32_t*)cell_edges, (const T*)cx, (const T*)cy, K, (T*)grad);
  return (int)cudaGetLastError();
}

}  // namespace

// grad[6, C] of the flow rows of q[3, C]; cell_edges, cx and cy are
// [C, K] row-major. Returns cudaGetLastError().
#define RDY_MUSCL_GRAD_API(SUFFIX, T)                                        \
  extern "C" int rdy_swe_muscl_grad_##SUFFIX(                                \
      const void* q, int64_t C, const void* int_left, const void* int_right, \
      int64_t Ei, const void* cell_edges, const void* cx, const void* cy,    \
      int K, void* grad, void* stream) {                                     \
    return launch<T>(q, C, int_left, int_right, Ei, cell_edges, cx, cy, K,   \
                     grad, stream);                                          \
  }

RDY_MUSCL_GRAD_API(f32, float)
RDY_MUSCL_GRAD_API(f64, double)
