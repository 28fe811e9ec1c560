// K2 swe_raster_step: one whole step (or RK stage, or RHS) of the shallow
// water equations on a uniform [ny, nx] raster, flow only, first order.
//
// Replaces the TPU kernel _kernel of rdycore_tpu/ops/pallas/structured_step.py
// (:172) in its modes base, emit_rhs and with_src, as called by
// make_fused_structured_stepper (:659): x/y Roe faces with wall ghosts, flux
// divergence, bed slope, semi-implicit Manning friction, an external water
// source, and the stage update, plus the Courant maximum per block.
//
// One thread per cell (i = column, j = row); threads along x take
// neighbouring addresses, so every plane is read and written coalesced. A
// thread loads its cell and its four neighbours, forms the ghost state of a
// wall neighbour inline (_ghost :60-80: the Dirichlet values; the reflecting
// mirror; the critical-outflow ghost ONLY, the interior state left as it is),
// regularizes every velocity and takes sqrt(max(h, 0)) once per cell, and
// solves its four faces: west roe(W, c) and east roe(c, E) with normal +x,
// south roe(S, c) and north roe(c, N) with normal +y, each with the
// both-dry mask of the pure-flow kernel (hL < tiny_h and hR < tiny_h) and
// 1/chat from rsqrt (roe_flux(fast=True)). Then
//   div    = -((fE - fW) / dx + (fN - fS) / dy)
//   rhs    = div + sources (rain on the h row only)
//   stage: out = alpha*qA + beta*(q + dt*rhs)  (qA may be NULL)
//   rhs:   out = rhs
// and, when prim != NULL, the primitives (h, u, v) of q. dt is read from
// device memory. Each block writes the largest Courant coefficient
// amax/dx, amax/dy of its cells' faces (wall faces included) to cmax[block];
// a second pass (K1c) folds max*dt into the interval maximum. Max is exact
// and order-free, and no sum uses atomics, so the result does not depend on
// the launch configuration.
//
// Bound: device memory. Per cell it reads q (3 planes), dz/dx, dz/dy and
// Manning's n, writes 3 planes, and reads the rain plane, qA (3 planes) and
// writes prim (3 planes) when asked: 9 to 16 f32 planes, 36 to 64 bytes per
// cell, 104 MB (euler) to 138 MB (with prim) on the 2,883,584-cell raster,
// at least 0.031 / 0.041 ms at the H100's 3.35 TB/s. The arithmetic is
// about 700 operations per cell (each interior face is solved twice, once
// by each of its cells; a divide, square root or pow counted as one), 2.0
// Gop per launch there, 0.030 ms at 67 TFLOP/s f32, just below the bytes
// bound; each divide, square root and pow takes several instructions, so
// the instruction rate may bind first.
// What this simple design leaves on the table: the neighbour loads go
// through L1/L2 rather than a shared-memory tile with a halo, the four Roe
// solves per cell double the face work, and no cp.async/TMA overlaps loads
// with compute.
#include "swe_physics.cuh"

namespace {

using rdy::kCriticalOutflow;
using rdy::kDirichlet;
using rdy::kReflecting;

constexpr int kThreads = 256;

struct Cell {
  float h, hu, hv;
};

struct Prep {
  float h, u, v, sq;
};

__device__ __forceinline__ Cell load(const float* __restrict__ q, int64_t C,
                                     int64_t c) {
  return Cell{q[c], q[C + c], q[2 * C + c]};
}

// wall ghost of interior cell s with outward normal (sn, cn) (_ghost): the
// prescribed (h, hu, hv) for Dirichlet, else (hg, hg*ug, hg*vg) of the
// reflecting or critical-outflow ghost of the regularized state
__device__ __forceinline__ Cell wall_ghost(int bc, Cell s, float sn, float cn,
                                           const float* __restrict__ bv,
                                           int64_t pos, int64_t n,
                                           float tiny_h, float h_anuga) {
  if (bc == kDirichlet) return Cell{bv[pos], bv[n + pos], bv[2 * n + pos]};
  float u, v;
  rdy::regularized_velocity(s.h, s.hu, s.hv, tiny_h, h_anuga, u, v);
  float hg, ug, vg;
  if (bc == kReflecting) {
    const float dum1 = sn * sn - cn * cn;
    const float dum2 = 2.0f * sn * cn;
    hg = s.h;
    ug = u * dum1 - v * dum2;
    vg = -u * dum2 - v * dum1;
  } else {  // critical outflow: the ghost only
    const float g = float(rdy::kGravity);
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

__device__ __forceinline__ Prep prep(Cell s, float tiny_h, float h_anuga) {
  Prep p;
  p.h = s.h;
  rdy::regularized_velocity(s.h, s.hu, s.hv, tiny_h, h_anuga, p.u, p.v);
  p.sq = sqrtf(rdy::clamp_min0(s.h));
  return p;
}

// masked Roe flux of one face with normal (sn, cn) = (0, 1) or (1, 0)
__device__ __forceinline__ void face(const Prep& l, const Prep& r, float sn,
                                     float cn, float tiny_h, float f[3],
                                     float& a) {
  rdy::roe_flux_sqrt<float, true>(l.h, l.u, l.v, r.h, r.u, r.v, l.sq, r.sq,
                                  sn, cn, f, a);
  const float m = (l.h < tiny_h && r.h < tiny_h) ? 0.0f : 1.0f;
  f[0] *= m;
  f[1] *= m;
  f[2] *= m;
  a *= m;
}

// max that keeps a NaN from either side, as jnp.max does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads) swe_raster_step_kernel(
    const float* __restrict__ q, const float* __restrict__ qA,
    const float* __restrict__ dzx, const float* __restrict__ dzy,
    const float* __restrict__ mann, const float* __restrict__ src,
    const float* __restrict__ dt_ptr, int bc_l, int bc_r, int bc_b, int bc_t,
    const float* __restrict__ bv_l, const float* __restrict__ bv_r,
    const float* __restrict__ bv_b, const float* __restrict__ bv_t,
    int64_t nx, int64_t ny, float tiny_h, float h_anuga, float inv_dx,
    float inv_dy, int rhs_mode, float alpha, float beta,
    float* __restrict__ out, float* __restrict__ prim,
    float* __restrict__ cmax) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y * (int64_t)blockDim.y + threadIdx.y;
  float cm = 0.0f;
  if (i < nx && j < ny) {
    const int64_t C = nx * ny;
    const int64_t c = j * nx + i;
    const Cell s = load(q, C, c);
    const Cell w = i > 0 ? load(q, C, c - 1)
                         : wall_ghost(bc_l, s, 0.0f, -1.0f, bv_l, j, ny,
                                      tiny_h, h_anuga);
    const Cell e = i < nx - 1 ? load(q, C, c + 1)
                              : wall_ghost(bc_r, s, 0.0f, 1.0f, bv_r, j, ny,
                                           tiny_h, h_anuga);
    const Cell so = j > 0 ? load(q, C, c - nx)
                          : wall_ghost(bc_b, s, -1.0f, 0.0f, bv_b, i, nx,
                                       tiny_h, h_anuga);
    const Cell no = j < ny - 1 ? load(q, C, c + nx)
                               : wall_ghost(bc_t, s, 1.0f, 0.0f, bv_t, i, nx,
                                            tiny_h, h_anuga);
    const Prep pc = prep(s, tiny_h, h_anuga);
    float fw[3], fe[3], fs[3], fn[3], aw, ae, as, an;
    face(prep(w, tiny_h, h_anuga), pc, 0.0f, 1.0f, tiny_h, fw, aw);
    face(pc, prep(e, tiny_h, h_anuga), 0.0f, 1.0f, tiny_h, fe, ae);
    face(prep(so, tiny_h, h_anuga), pc, 1.0f, 0.0f, tiny_h, fs, as);
    face(pc, prep(no, tiny_h, h_anuga), 1.0f, 0.0f, tiny_h, fn, an);
    cm = nanmax(nanmax(aw * inv_dx, ae * inv_dx),
                nanmax(as * inv_dy, an * inv_dy));

    const float dh = -((fe[0] - fw[0]) * inv_dx + (fn[0] - fs[0]) * inv_dy);
    const float dhu = -((fe[1] - fw[1]) * inv_dx + (fn[1] - fs[1]) * inv_dy);
    const float dhv = -((fe[2] - fw[2]) * inv_dx + (fn[2] - fs[2]) * inv_dy);

    // semi-implicit bed slope and Manning friction (_kernel :579-599)
    const float dt = *dt_ptr;
    const float g = float(rdy::kGravity);
    const float bedx = dzx[c] * g * s.h;
    const float bedy = dzy[c] * g * s.h;
    const bool wet = s.h >= tiny_h;
    const float h_safe = wet ? s.h : 1.0f;
    const float inv_h = 1.0f / h_safe;
    const float uu = s.hu * inv_h;
    const float vv = s.hv * inv_h;
    const float n = mann[c];
    const float cd = g * n * n * powf(h_safe, -1.0f / 3.0f);
    const float speed = sqrtf(uu * uu + vv * vv);
    const float tb = cd * speed * inv_h;
    const float factor = tb / (1.0f + dt * tb);
    const float tbx = wet ? (s.hu + dt * dhu - dt * bedx) * factor : 0.0f;
    const float tby = wet ? (s.hv + dt * dhv - dt * bedy) * factor : 0.0f;
    const float rh = dh + (src ? src[c] : 0.0f);
    const float rhu = dhu - bedx - tbx;
    const float rhv = dhv - bedy - tby;

    if (rhs_mode) {
      out[c] = rh;
      out[C + c] = rhu;
      out[2 * C + c] = rhv;
    } else {
      float o0 = beta * (s.h + dt * rh);
      float o1 = beta * (s.hu + dt * rhu);
      float o2 = beta * (s.hv + dt * rhv);
      if (qA) {
        o0 = alpha * qA[c] + o0;
        o1 = alpha * qA[C + c] + o1;
        o2 = alpha * qA[2 * C + c] + o2;
      }
      out[c] = o0;
      out[C + c] = o1;
      out[2 * C + c] = o2;
    }
    if (prim) {
      prim[c] = s.h;
      prim[C + c] = pc.u;
      prim[2 * C + c] = pc.v;
    }
  }

  // block maximum of cm: warp shuffles, then one warp over the warp maxima
  __shared__ float wmax[kThreads / 32];
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

}  // namespace

// One launch over the [ny, nx] raster with blocks of bx x by threads
// (bx * by a multiple of 32, at most 256); cmax holds ceil(nx/bx) *
// ceil(ny/by) floats, row-major by block. rhs_mode != 0 writes the RHS to
// out, else the stage alpha*qA + beta*(q + dt*rhs). Returns
// cudaGetLastError().
extern "C" int rdy_swe_raster_step_f32(
    const void* q, const void* qA, const void* dzx, const void* dzy,
    const void* mann, const void* src, const void* dt, int bc_l, int bc_r,
    int bc_b, int bc_t, const void* bv_l, const void* bv_r, const void* bv_b,
    const void* bv_t, int64_t nx, int64_t ny, float tiny_h, float h_anuga,
    float inv_dx, float inv_dy, int rhs_mode, float alpha, float beta,
    void* out, void* prim, void* cmax, int bx, int by, void* stream) {
  const int64_t gx = (nx + bx - 1) / bx, gy = (ny + by - 1) / by;
  if (bx * by > kThreads || (bx * by) % 32 != 0 || nx < 1 || ny < 1 ||
      gy > 65535 || gx > 2147483647)
    return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  swe_raster_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)qA, (const float*)dzx, (const float*)dzy,
      (const float*)mann, (const float*)src, (const float*)dt, bc_l, bc_r,
      bc_b, bc_t, (const float*)bv_l, (const float*)bv_r, (const float*)bv_b,
      (const float*)bv_t, nx, ny, tiny_h, h_anuga, inv_dx, inv_dy, rhs_mode,
      alpha, beta, (float*)out, (float*)prim, (float*)cmax);
  return (int)cudaGetLastError();
}
