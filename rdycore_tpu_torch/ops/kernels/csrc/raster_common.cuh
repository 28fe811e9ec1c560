// Device helpers shared by the raster kernels (swe_raster_step.cu, K2, and
// swe_raster_muscl.cu, K2 MUSCL): the cell state, the inline wall ghosts of
// fill_ghost_frame (rdycore_tpu/ops/pallas/structured_step.py _ghost
// :60-80), the flow sources and stage output of the TPU kernel _kernel
// (:579-656), and the per-block Courant maximum.
#pragma once

#include "swe_physics.cuh"

namespace rdy {

// threads per block of the raster kernels
constexpr int kRasterThreads = 256;

struct Cell {
  float h, hu, hv;
};

__device__ __forceinline__ Cell load_cell(const float* __restrict__ q,
                                          int64_t C, int64_t c) {
  return Cell{q[c], q[C + c], q[2 * C + c]};
}

// wall ghost of interior cell s with outward normal (sn, cn) (_ghost): the
// prescribed (h, hu, hv) at position pos of a Dirichlet wall of n cells,
// else (hg, hg*ug, hg*vg) of the reflecting mirror or of the critical-
// outflow ghost (the ghost only: the interior state is left as it is) of
// the regularized state
__device__ __forceinline__ Cell wall_ghost(int bc, Cell s, float sn, float cn,
                                           const float* __restrict__ bv,
                                           int64_t pos, int64_t n,
                                           float tiny_h, float h_anuga) {
  if (bc == kDirichlet) return Cell{bv[pos], bv[n + pos], bv[2 * n + pos]};
  float u, v;
  regularized_velocity(s.h, s.hu, s.hv, tiny_h, h_anuga, u, v);
  float hg, ug, vg;
  if (bc == kReflecting) {
    const float dum1 = sn * sn - cn * cn;
    const float dum2 = 2.0f * sn * cn;
    hg = s.h;
    ug = u * dum1 - v * dum2;
    vg = -u * dum2 - v * dum1;
  } else {  // critical outflow: the ghost only
    const float g = float(kGravity);
    const float uperp = u * cn + v * sn;
    const float qn = s.h * fabsf(uperp);
    const float h_crit = cbrtf(qn * qn / g);
    const float vel = sqrtf(g * h_crit);
    const bool out = uperp >= 0.0f;
    hg = out ? h_crit : 0.0f;
    ug = out ? vel * cn : 0.0f;
    vg = out ? vel * sn : 0.0f;
  }
  return Cell{hg, hg * ug, hg * vg};
}

// max that keeps a NaN from either side, as jnp.max does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The flow RHS of the cell with state s from its flux divergence (dh, dhu,
// dhv): bed slope and semi-implicit Manning friction (wet at h >= tiny_h)
// and the rain rate src[c] (src may be NULL) on the h row (_kernel
// :579-599); c indexes the owned rows' planes dzx, dzy, mann and src. cd, uu and vv are kept for the tracer sources. The planes are
// read here, where each value is first needed, as K2 always read them.
struct FlowRhs {
  float rh, rhu, rhv, cd, uu, vv;
};

__device__ __forceinline__ FlowRhs flow_rhs(
    Cell s, float dh, float dhu, float dhv, const float* __restrict__ dzx,
    const float* __restrict__ dzy, const float* __restrict__ mann,
    const float* __restrict__ src, int64_t c, float dt, float tiny_h) {
  const float g = float(kGravity);
  const float bedx = dzx[c] * g * s.h;
  const float bedy = dzy[c] * g * s.h;
  const bool wet = s.h >= tiny_h;
  const float h_safe = wet ? s.h : 1.0f;
  const float inv_h = 1.0f / h_safe;
  FlowRhs r;
  r.uu = s.hu * inv_h;
  r.vv = s.hv * inv_h;
  const float n = mann[c];
  r.cd = g * n * n * powf(h_safe, -1.0f / 3.0f);
  const float speed = sqrtf(r.uu * r.uu + r.vv * r.vv);
  const float tb = r.cd * speed * inv_h;
  const float factor = tb / (1.0f + dt * tb);
  const float tbx = wet ? (s.hu + dt * dhu - dt * bedx) * factor : 0.0f;
  const float tby = wet ? (s.hv + dt * dhv - dt * bedy) * factor : 0.0f;
  r.rh = dh + (src ? src[c] : 0.0f);
  r.rhu = dhu - bedx - tbx;
  r.rhv = dhv - bedy - tby;
  return r;
}

// The flow rows of cell c: rhs mode out = rhs, stage mode out = alpha*qA +
// beta*(s + dt*rhs) (qA may be NULL)
__device__ __forceinline__ void store_flow(float* __restrict__ out,
                                           const float* __restrict__ qA,
                                           int64_t C, int64_t c, int rhs_mode,
                                           float alpha, float beta, Cell s,
                                           float dt, const FlowRhs& r) {
  if (rhs_mode) {
    out[c] = r.rh;
    out[C + c] = r.rhu;
    out[2 * C + c] = r.rhv;
  } else {
    float o0 = beta * (s.h + dt * r.rh);
    float o1 = beta * (s.hu + dt * r.rhu);
    float o2 = beta * (s.hv + dt * r.rhv);
    if (qA) {
      o0 = alpha * qA[c] + o0;
      o1 = alpha * qA[C + c] + o1;
      o2 = alpha * qA[2 * C + c] + o2;
    }
    out[c] = o0;
    out[C + c] = o1;
    out[2 * C + c] = o2;
  }
}

// The maximum of cm over the block (warp shuffles, then one warp over the
// warp maxima), written to cmax[block] row-major by block. Every thread of
// the block must call it.
__device__ __forceinline__ void store_block_max(float cm,
                                                float* __restrict__ cmax) {
  __shared__ float wmax[kRasterThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    cm = nanmax(cm, __shfl_down_sync(0xffffffffu, cm, off));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) wmax[warp] = cm;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x * blockDim.y) >> 5;
    cm = lane < nw ? wmax[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      cm = nanmax(cm, __shfl_down_sync(0xffffffffu, cm, off));
    if (lane == 0) cmax[blockIdx.y * (int64_t)gridDim.x + blockIdx.x] = cm;
  }
}

// Row strips. A launch owns the rows [row0, row0 + rows) of a raster of ny
// rows, held in a strip buffer of halo_lo + rows + halo_hi rows: halo_lo
// rows below the owned ones, copies of the strip beneath, and halo_hi rows
// above. A strip's bottom (top) is the raster's wall exactly where it has
// no halo rows there; elsewhere a kernel that reads `depth` rows beyond its
// own needs that many halo rows. The whole raster is the strip (0, ny, 0,
// 0), whose buffer is the raster itself.
inline bool strip_ok(int64_t ny, int64_t row0, int64_t rows, int halo_lo,
                     int halo_hi, int depth) {
  return row0 >= 0 && rows >= 1 && row0 + rows <= ny &&
         (row0 == 0 ? halo_lo == 0 : halo_lo >= depth) &&
         (row0 + rows == ny ? halo_hi == 0 : halo_hi >= depth);
}

}  // namespace rdy
