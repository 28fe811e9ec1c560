// K1c courant_argmax: max of x[n] and the lowest index attaining it, in one
// launch.
//
// Replaces the o_cmax/o_cidx Courant fold of the TPU kernel
// _fused_step_kernel (rdycore_tpu/ops/pallas/slotted.py :2150-2170,
// :1982-1985), which carries an (8, 128) running max/argmax across its
// sequential grid, and the Courant fold of the raster steppers over the
// per-block maxima of K2 and K2 MUSCL. When given the running interval
// maximum it also folds the step Courant number max*dt into it (the XLA
// interval loop's `bigger = step_courant > cmax`, timestepping.py:351-354)
// on the device. Ties go to the lowest index and NaN counts as the largest
// value, as in jnp.argmax / torch.argmax; indices are int32 (the wrapper
// refuses n >= 2^31).
//
// Bound: device memory; it reads n values once and writes a few bytes: 23
// MB and at least 0.0069 ms on the 5.77M edges of the 2048x1408 dam break.
// At the raster's 11,264 block maxima the bound is nanoseconds and a
// launch's fixed cost is all of the time, so the kernel is one launch:
// - each block reduces a contiguous chunk of the values to one (value,
//   index) pair in registers (16-byte loads, float4 / double2, with a
//   scalar head and tail where the pointer or n is not aligned, so a slice
//   of a tensor may be passed), then warp shuffles, then shared memory;
// - with one block (n up to kOneBlock values) it writes the result itself;
// - with more, it writes its pair to the workspace, fences, and takes a
//   ticket; the block that takes the last ticket folds every pair in block
//   order and writes the result. atomicInc wraps the ticket back to 0 for
//   the next call. Max and argmax are exact and order-free, so the result
//   does not depend on which block finishes last, and no float atomics are
//   used.
// The grid is sized to the card by the caller (max_blocks: a few blocks of
// kThreads per SM, the workspace's capacity), at most one block per
// kPerThread * kThreads values.
//
// The workspace (ticket and partial pairs) is the caller's and must not be
// shared by launches that may run at the same time: two launches on two
// streams with one ticket would race. The wrapper keeps one workspace per
// (device, stream), on which launches run in order (ops/kernels/courant.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSM = 4;
// values per thread below which a block takes no more of the grid
constexpr int kPerThread = 8;
// the most values one block reduces alone, without the ticket
constexpr int64_t kOneBlock = 32 * kThreads;

// (v, i) beats (bv, bi): an index < 0 is an empty pair and never wins; NaN
// beats everything else; then the larger value; then the lower index
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  const bool vn = v != v, bn = bv != bv;
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// fold value v at index i into (bv, bi), where i exceeds every index
// folded into (bv, bi) so far: a tie keeps bi
template <typename T>
__device__ __forceinline__ void take(T v, int i, T& bv, int& bi) {
  if (bi < 0 || v > bv || (v != v && bv == bv)) {
    bv = v;
    bi = i;
  }
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
__device__ __forceinline__ void take_vec(const typename Vec<T>::type& w,
                                         int i, T& bv, int& bi) {
  if constexpr (Vec<T>::n == 4) {
    take(w.x, i, bv, bi);
    take(w.y, i + 1, bv, bi);
    take(w.z, i + 2, bv, bi);
    take(w.w, i + 3, bv, bi);
  } else {
    take(w.x, i, bv, bi);
    take(w.y, i + 1, bv, bi);
  }
}

template <typename T>
__device__ __forceinline__ void warp_reduce(T& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// the block's pair, in thread 0
template <typename T>
__device__ __forceinline__ void block_reduce(T& v, int& i) {
  __shared__ T sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  warp_reduce(v, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = sv[lane < kThreads / 32 ? lane : 0];
    i = lane < kThreads / 32 ? si[lane] : -1;
    warp_reduce(v, i);
  }
}

template <typename T>
__device__ __forceinline__ void finish(T v, int i, T* __restrict__ out_max,
                                       int32_t* __restrict__ out_idx,
                                       const T* __restrict__ dt,
                                       T* __restrict__ run_max,
                                       int32_t* __restrict__ run_idx) {
  out_max[0] = v;
  out_idx[0] = i;
  if (run_max) {
    const T step = v * dt[0];
    if (step > run_max[0]) {
      run_max[0] = step;
      run_idx[0] = i;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) courant_argmax_kernel(
    const T* __restrict__ x, int n, unsigned* __restrict__ ticket,
    T* __restrict__ pval, int* __restrict__ pidx, T* __restrict__ out_max,
    int32_t* __restrict__ out_idx, const T* __restrict__ dt,
    T* __restrict__ run_max, int32_t* __restrict__ run_idx) {
  using V = typename Vec<T>::type;
  constexpr int kV = Vec<T>::n;
  const int t = threadIdx.x, b = blockIdx.x, nb = gridDim.x;
  // the scalar head before the first 16-byte boundary, the vectors, the
  // scalar tail
  const int mis = (int)(((uintptr_t)x & 15u) / sizeof(T));
  const int head = mis ? min(n, kV - mis) : 0;
  const int nvec = (n - head) / kV;
  const int tail0 = head + nvec * kV;
  const V* xv = reinterpret_cast<const V*>(x + head);
  // block b takes the vectors [v0, v1); block 0 the head, the last the tail
  const int per = (nvec + nb - 1) / nb;
  const int v0 = min(nvec, b * per), v1 = min(nvec, v0 + per);

  T bv = T(0);
  int bi = -1;
  if (b == 0 && t < head) take(x[t], t, bv, bi);
  for (int k = v0 + t; k < v1; k += kThreads) {
    const V w = xv[k];
    take_vec<T>(w, head + k * kV, bv, bi);
  }
  if (b == nb - 1 && tail0 + t < n) take(x[tail0 + t], tail0 + t, bv, bi);
  block_reduce(bv, bi);

  if (nb == 1) {
    if (t == 0) finish(bv, bi, out_max, out_idx, dt, run_max, run_idx);
    return;
  }
  __shared__ bool last;
  if (t == 0) {
    pval[b] = bv;
    pidx[b] = bi;
    __threadfence();
    // wraps to 0 at the last ticket, ready for the next launch
    last = atomicInc(ticket, (unsigned)nb - 1u) == (unsigned)nb - 1u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  bv = T(0);
  bi = -1;
  for (int k = t; k < nb; k += kThreads) {
    // the other blocks' pairs, read past L1
    const T v = __ldcg(pval + k);
    const int i = __ldcg(pidx + k);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  block_reduce(bv, bi);
  if (t == 0) finish(bv, bi, out_max, out_idx, dt, run_max, run_idx);
}

template <typename T>
int launch(const void* x, int64_t n, void* work, int max_blocks,
           void* out_max, void* out_idx, const void* dt, void* run_max,
           void* run_idx, void* stream) {
  if (n < 1 || n > INT32_MAX || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  int64_t nb = 1;
  if (n > kOneBlock) {
    nb = (n + kPerThread * kThreads - 1) / (kPerThread * kThreads);
    if (nb > max_blocks) nb = max_blocks;
  }
  // workspace: the ticket, then nb values (16-byte aligned), then nb indices
  char* w = (char*)work;
  T* pval = (T*)(w + 16);
  int* pidx = (int*)(w + 16 + max_blocks * sizeof(double));
  courant_argmax_kernel<T><<<(unsigned)nb, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)x, (int)n, (unsigned*)w, pval, pidx, (T*)out_max,
      (int32_t*)out_idx, (const T*)dt, (T*)run_max, (int32_t*)run_idx);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks a launch may take per SM; the workspace of a launch with
// max_blocks blocks holds rdy_courant_argmax_work_bytes(max_blocks) bytes,
// zero before its first use.
extern "C" int rdy_courant_argmax_blocks_per_sm() { return kBlocksPerSM; }
extern "C" int rdy_courant_argmax_work_bytes(int max_blocks) {
  return 16 + max_blocks * (int)(sizeof(double) + sizeof(int));
}

// out_max, out_idx (int32): the maximum and its first index; with run_max
// non-NULL, max*dt[0] is folded into run_max/run_idx (int32). Returns
// cudaGetLastError().
#define RDY_ARGMAX_API(SUFFIX, T)                                          \
  extern "C" int rdy_courant_argmax_##SUFFIX(                              \
      const void* x, int64_t n, void* work, int max_blocks, void* out_max, \
      void* out_idx, const void* dt, void* run_max, void* run_idx,         \
      void* stream) {                                                      \
    return launch<T>(x, n, work, max_blocks, out_max, out_idx, dt,         \
                     run_max, run_idx, stream);                            \
  }

RDY_ARGMAX_API(f32, float)
RDY_ARGMAX_API(f64, double)
