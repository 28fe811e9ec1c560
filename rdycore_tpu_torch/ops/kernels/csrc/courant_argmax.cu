// K1c courant_argmax: max of courant[E] and the lowest index attaining it.
//
// Replaces the o_cmax/o_cidx Courant fold of the TPU kernel
// _fused_step_kernel (rdycore_tpu/ops/pallas/slotted.py :2463), which
// carries an (8, 128) running max/argmax across its sequential grid. Blocks
// on the card run in no order, so the fold is two passes: pass 1 reduces a
// grid-stride slice per block to (max, index); pass 2, one block, reduces
// the per-block partials and, when given the running interval maximum,
// folds the step Courant number max*dt into it (the XLA interval loop's
// `bigger = step_courant > cmax`, timestepping.py:351-354) on the device.
// Ties go to the lowest index and NaN counts as the largest value, as in
// jnp.argmax / torch.argmax.
//
// Bound: device memory; it reads E values once (4 bytes each in f32) and
// writes a few bytes: 23 MB and at least 0.007 ms on the 5.77M edges of
// the 2048x1408 dam break. Design: pass 1 reads coalesced with grid-stride
// loops and reduces in registers, then warp shuffles, then shared memory;
// pass 2 is one block of 1024 threads over at most 1024 partials.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBlocks = 1024;

template <typename T>
__device__ __forceinline__ bool better(T v, int64_t i, T bv, int64_t bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

template <typename T>
__device__ __forceinline__ void block_reduce(T& v, int64_t& i) {
  __shared__ T sv[kThreads / 32];
  __shared__ int64_t si[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int64_t oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : sv[0];
    i = lane < nw ? si[lane] : si[0];
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, v, off);
      const int64_t oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) argmax_partial(
    const T* __restrict__ x, int64_t n, T* __restrict__ pval,
    int64_t* __restrict__ pidx) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // every thread starts from a real element (n >= gridDim.x * blockDim.x
  // is not required: threads past n start from element 0)
  T bv = x[i < n ? i : 0];
  int64_t bi = i < n ? i : 0;
  for (i += stride; i < n; i += stride) {
    const T v = x[i];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  block_reduce(bv, bi);
  if (threadIdx.x == 0) {
    pval[blockIdx.x] = bv;
    pidx[blockIdx.x] = bi;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) argmax_final(
    const T* __restrict__ pval, const int64_t* __restrict__ pidx, int nb,
    T* __restrict__ out_max, int32_t* __restrict__ out_idx,
    const T* __restrict__ dt, T* __restrict__ run_max,
    int32_t* __restrict__ run_idx) {
  const int t = threadIdx.x;
  T v = pval[t < nb ? t : 0];
  int64_t i = pidx[t < nb ? t : 0];
  block_reduce(v, i);
  if (t == 0) {
    out_max[0] = v;
    out_idx[0] = (int32_t)i;
    if (run_max) {
      const T step = v * dt[0];
      if (step > run_max[0]) {
        run_max[0] = step;
        run_idx[0] = (int32_t)i;
      }
    }
  }
}

template <typename T>
int launch(const void* x, int64_t n, void* pval, void* pidx, void* out_max,
           void* out_idx, const void* dt, void* run_max, void* run_idx,
           void* stream) {
  int64_t nb = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (nb > kMaxBlocks) nb = kMaxBlocks;
  if (nb < 1) nb = 1;
  cudaStream_t s = (cudaStream_t)stream;
  argmax_partial<T><<<(unsigned)nb, kThreads, 0, s>>>((const T*)x, n,
                                                       (T*)pval,
                                                       (int64_t*)pidx);
  int err = (int)cudaGetLastError();
  if (err) return err;
  argmax_final<T><<<1, kThreads, 0, s>>>(
      (const T*)pval, (const int64_t*)pidx, (int)nb, (T*)out_max,
      (int32_t*)out_idx, (const T*)dt, (T*)run_max, (int32_t*)run_idx);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: pval and pidx must hold rdy_courant_argmax_max_blocks() entries
extern "C" int rdy_courant_argmax_max_blocks() { return kMaxBlocks; }

#define RDY_ARGMAX_API(SUFFIX, T)                                           \
  extern "C" int rdy_courant_argmax_##SUFFIX(                               \
      const void* x, int64_t n, void* pval, void* pidx, void* out_max,      \
      void* out_idx, const void* dt, void* run_max, void* run_idx,          \
      void* stream) {                                                       \
    return launch<T>(x, n, pval, pidx, out_max, out_idx, dt, run_max,       \
                     run_idx, stream);                                      \
  }

RDY_ARGMAX_API(f32, float)
RDY_ARGMAX_API(f64, double)
