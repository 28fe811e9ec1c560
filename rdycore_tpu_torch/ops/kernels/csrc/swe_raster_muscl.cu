// K2 MUSCL: one second-order step (or RK stage, or RHS) of the shallow
// water equations on a uniform [ny, nx] raster, flow only, float32, in two
// launches.
//
// Replaces the second_order mode of the TPU kernel _kernel of
// rdycore_tpu/ops/pallas/structured_step.py (:341-559), as called by
// make_fused_structured_stepper(second_order=True) (:659): masked LS
// gradients, limited face reconstruction (minmod, van Leer or none; a
// template parameter), h >= 0 clamp, Roe, the both-dry mask on the
// reconstructed depths, the Audusse positivity pass, then the divergence,
// sources and stage update of K2. The TPU kernel does it all in one row
// tile with a 3-row halo. With one thread per cell, a face's flux depends
// on states up to two cells away and a cell's positivity factor on its
// neighbours' faces, a radius-3 stencil; this port splits at the faces:
//
// faces: one thread per cell computes its east face (i+1/2) and north face
//   (j+1/2), and its west or south wall face where it has one. Each face
//   needs the normal gradients of its two cells, gx = cE*(qE - q) +
//   cW*(q - qW) with cE, cW = 1/(2dx) where both neighbours are interior,
//   1/dx where only one is, 0 beyond a wall (_kernel :366-410), so a
//   thread reads a 1x4 and a 4x1 stencil. The extrapolations are g * hdx
//   with hdx = 0.5 / (1/dx) in float32; wall faces take zero
//   extrapolation, i.e. first order on the inline ghost (K2's), with h
//   clamped >= 0 as on every face. It writes fx[3, ny, nx + 1] (face i =
//   west face of column i) and fy[3, ny + 1, nx] (face j = south face of
//   row j), and each block the largest amax/dx, amax/dy of its cells' own
//   faces (K1c folds them; the Courant number is taken before the
//   positivity scaling, as in the TPU kernel).
// update: one thread per cell computes the donor factor
//   s = clip(h / (dt_s * drain), 0, 1) (1 where drain = 0; dt_s = dt, or 1
//   where dt <= 0: :495-533) of itself from its four face h-fluxes, and of
//   the neighbour across each face whose flux flows into it (a ghost
//   donor keeps s = 1), scales the face by its donor's s (:548-559), and
//   forms the divergence, the semi-implicit sources of the raw state, the
//   rain plane, the stage or rhs output and the primitives, as K2 does.
// Each face is solved once. Max is exact and order-free, no sum uses
// atomics: the result does not depend on the launch configuration.
//
// Bound: device memory. faces reads the 3 state planes and writes 6 face
// planes (plus the block maxima), update reads the 3 state planes, the 6
// face planes, 3 geometry planes (and the rain plane and qA when given)
// and writes 3 planes (6 with prim): in f32 on the 2,883,584-cell raster
// 104 MB and 173 MB (euler stage with prim), at least 0.031 and 0.052 ms
// at the H100's 3.35 TB/s. The arithmetic, about 400 operations per cell
// in faces (two Roe solves, four gradients, twelve limited slopes) and
// 100 in update, is 1.4 Gop, 0.021 ms at 67 TFLOP/s. What this simple
// design leaves on the table: the face planes make a round trip through
// device memory (a shared-memory tile with a halo would keep them on
// chip), and the neighbours' donor factors are recomputed by each of
// their neighbours.
#include "raster_common.cuh"

namespace {

using rdy::Cell;
using rdy::kRasterThreads;
using rdy::load_cell;
using rdy::nanmax;
using rdy::wall_ghost;

// the normal gradient of a cell with state c, lower neighbour lo and upper
// neighbour hi (each taken only where present) along an axis of spacing
// 1/inv_d
__device__ __forceinline__ void gradient(const Cell& lo, const Cell& c,
                                         const Cell& hi, bool has_lo,
                                         bool has_hi, float inv_d,
                                         float g[3]) {
  const float half_inv = 0.5f * inv_d;
  const float c_hi = has_hi ? (has_lo ? half_inv : inv_d) : 0.0f;
  const float c_lo = has_lo ? (has_hi ? half_inv : inv_d) : 0.0f;
  const float qc[3] = {c.h, c.hu, c.hv};
  const float qh[3] = {hi.h, hi.hu, hi.hv};
  const float ql[3] = {lo.h, lo.hu, lo.hv};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float up = has_hi ? c_hi * (qh[k] - qc[k]) : 0.0f;
    const float dn = has_lo ? c_lo * (qc[k] - ql[k]) : 0.0f;
    g[k] = up + dn;
  }
}

// masked Roe flux of the face between states l and r with normal (sn, cn)
// from the limited extrapolations el (of l) and er (of r); zero ones make a
// first-order face
template <int kLim>
__device__ __forceinline__ void muscl_face(const Cell& l, const Cell& r,
                                           const float el[3],
                                           const float er[3], float sn,
                                           float cn, float tiny_h,
                                           float h_anuga, float f[3],
                                           float& a) {
  const float ql[3] = {l.h, l.hu, l.hv};
  const float qr[3] = {r.h, r.hu, r.hv};
  float fl[3], fr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dq = qr[k] - ql[k];
    fl[k] = ql[k] + rdy::limit_slope<float, kLim>(el[k], 0.5f * dq);
    fr[k] = qr[k] + rdy::limit_slope<float, kLim>(er[k], -0.5f * dq);
  }
  const float hl = rdy::clamp_min0(fl[0]);
  const float hr = rdy::clamp_min0(fr[0]);
  float ul, vl, ur, vr;
  rdy::regularized_velocity(hl, fl[1], fl[2], tiny_h, h_anuga, ul, vl);
  rdy::regularized_velocity(hr, fr[1], fr[2], tiny_h, h_anuga, ur, vr);
  rdy::roe_flux_sqrt<float, true>(hl, ul, vl, hr, ur, vr, sqrtf(hl),
                                  sqrtf(hr), sn, cn, f, a);
  const float m = (hl < tiny_h && hr < tiny_h) ? 0.0f : 1.0f;
  f[0] *= m;
  f[1] *= m;
  f[2] *= m;
  a *= m;
}

__device__ __forceinline__ void store3(float* __restrict__ p, int64_t plane,
                                       int64_t at, const float f[3]) {
  p[at] = f[0];
  p[plane + at] = f[1];
  p[2 * plane + at] = f[2];
}

template <int kLim>
__global__ void __launch_bounds__(kRasterThreads)
    swe_raster_muscl_faces_kernel(
    const float* __restrict__ q, int bc_l, int bc_r, int bc_b, int bc_t,
    const float* __restrict__ bv_l, const float* __restrict__ bv_r,
    const float* __restrict__ bv_b, const float* __restrict__ bv_t,
    int64_t nx, int64_t ny, float tiny_h, float h_anuga, float inv_dx,
    float inv_dy, float* __restrict__ fx, float* __restrict__ fy,
    float* __restrict__ cmax) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y * (int64_t)blockDim.y + threadIdx.y;
  float cm = 0.0f;
  if (i < nx && j < ny) {
    const int64_t C = nx * ny;
    const int64_t c = j * nx + i;
    const int64_t px = ny * (nx + 1), py = (ny + 1) * nx;
    const float hdx = 0.5f / inv_dx, hdy = 0.5f / inv_dy;
    const float zero[3] = {0.0f, 0.0f, 0.0f};
    const Cell s = load_cell(q, C, c);
    float f[3], a, el[3], er[3];
    // east face: the right wall's first-order ghost face, or MUSCL
    // between this cell and its east neighbour
    if (i == nx - 1) {
      const Cell g = wall_ghost(bc_r, s, 0.0f, 1.0f, bv_r, j, ny, tiny_h,
                                h_anuga);
      muscl_face<kLim>(s, g, zero, zero, 0.0f, 1.0f, tiny_h, h_anuga, f, a);
    } else {
      const Cell w = i > 0 ? load_cell(q, C, c - 1) : s;
      const Cell e = load_cell(q, C, c + 1);
      const Cell e2 = i + 2 < nx ? load_cell(q, C, c + 2) : e;
      float gc[3], ge[3];
      gradient(w, s, e, i > 0, true, inv_dx, gc);
      gradient(s, e, e2, true, i + 2 < nx, inv_dx, ge);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        el[k] = gc[k] * hdx;
        er[k] = -ge[k] * hdx;
      }
      muscl_face<kLim>(s, e, el, er, 0.0f, 1.0f, tiny_h, h_anuga, f, a);
    }
    store3(fx, px, j * (nx + 1) + i + 1, f);
    cm = a * inv_dx;
    // north face
    if (j == ny - 1) {
      const Cell g = wall_ghost(bc_t, s, 1.0f, 0.0f, bv_t, i, nx, tiny_h,
                                h_anuga);
      muscl_face<kLim>(s, g, zero, zero, 1.0f, 0.0f, tiny_h, h_anuga, f, a);
    } else {
      const Cell so = j > 0 ? load_cell(q, C, c - nx) : s;
      const Cell n = load_cell(q, C, c + nx);
      const Cell n2 = j + 2 < ny ? load_cell(q, C, c + 2 * nx) : n;
      float gc[3], gn[3];
      gradient(so, s, n, j > 0, true, inv_dy, gc);
      gradient(s, n, n2, true, j + 2 < ny, inv_dy, gn);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        el[k] = gc[k] * hdy;
        er[k] = -gn[k] * hdy;
      }
      muscl_face<kLim>(s, n, el, er, 1.0f, 0.0f, tiny_h, h_anuga, f, a);
    }
    store3(fy, py, (j + 1) * nx + i, f);
    cm = nanmax(cm, a * inv_dy);
    // the wall faces west of column 0 and south of row 0
    if (i == 0) {
      const Cell g = wall_ghost(bc_l, s, 0.0f, -1.0f, bv_l, j, ny, tiny_h,
                                h_anuga);
      muscl_face<kLim>(g, s, zero, zero, 0.0f, 1.0f, tiny_h, h_anuga, f, a);
      store3(fx, px, j * (nx + 1), f);
      cm = nanmax(cm, a * inv_dx);
    }
    if (j == 0) {
      const Cell g = wall_ghost(bc_b, s, -1.0f, 0.0f, bv_b, i, nx, tiny_h,
                                h_anuga);
      muscl_face<kLim>(g, s, zero, zero, 1.0f, 0.0f, tiny_h, h_anuga, f, a);
      store3(fy, py, i, f);
      cm = nanmax(cm, a * inv_dy);
    }
  }
  rdy::store_block_max(cm, cmax);
}

__device__ __forceinline__ float relu(float x) { return x > 0.0f ? x : 0.0f; }

// the donor factor of cell (i, j) of depth h (K3b's, on the raster): its
// drain is the outgoing h-flux rate of its four faces
__device__ __forceinline__ float donor_factor(
    const float* __restrict__ fxh, const float* __restrict__ fyh,
    const float* __restrict__ q, int64_t nx, int64_t i, int64_t j,
    float inv_dx, float inv_dy, float dt_s) {
  const float fe = fxh[j * (nx + 1) + i + 1], fw = fxh[j * (nx + 1) + i];
  const float fn = fyh[(j + 1) * nx + i], fs = fyh[j * nx + i];
  const float drain =
      (relu(fe) + relu(-fw)) * inv_dx + (relu(fn) + relu(-fs)) * inv_dy;
  if (!(drain > 0.0f)) return 1.0f;
  const float sc = q[j * nx + i] / (dt_s * drain);
  return sc < 0.0f ? 0.0f : (sc > 1.0f ? 1.0f : sc);
}

__global__ void __launch_bounds__(kRasterThreads)
    swe_raster_muscl_update_kernel(
    const float* __restrict__ q, const float* __restrict__ qA,
    const float* __restrict__ fx, const float* __restrict__ fy,
    const float* __restrict__ dzx, const float* __restrict__ dzy,
    const float* __restrict__ mann, const float* __restrict__ src,
    int64_t nx, int64_t ny, float tiny_h, float h_anuga, float inv_dx,
    float inv_dy, int rhs_mode, float alpha, float beta,
    const float* __restrict__ dt_ptr, float* __restrict__ out,
    float* __restrict__ prim) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y * (int64_t)blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int64_t C = nx * ny;
  const int64_t c = j * nx + i;
  const int64_t px = ny * (nx + 1), py = (ny + 1) * nx;
  const float dt = *dt_ptr;
  const float dt_s = dt > 0.0f ? dt : 1.0f;
  const int64_t iw = j * (nx + 1) + i, ie = iw + 1;
  const int64_t is = j * nx + i, in = is + nx;
  const float sc = donor_factor(fx, fy, q, nx, i, j, inv_dx, inv_dy, dt_s);
  // each face's donor: this cell where the flux leaves it, else the
  // neighbour across it (a ghost beyond a wall keeps s = 1)
  auto donor = [&](bool out_of_cell, bool has_nbr, int64_t ni, int64_t nj) {
    if (out_of_cell) return sc;
    return has_nbr ? donor_factor(fx, fy, q, nx, ni, nj, inv_dx, inv_dy,
                                  dt_s)
                   : 1.0f;
  };
  const float se = donor(fx[ie] > 0.0f, i + 1 < nx, i + 1, j);
  const float sw = donor(!(fx[iw] > 0.0f), i > 0, i - 1, j);
  const float sn = donor(fy[in] > 0.0f, j + 1 < ny, i, j + 1);
  const float ss = donor(!(fy[is] > 0.0f), j > 0, i, j - 1);
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float fe = fx[k * px + ie] * se, fw = fx[k * px + iw] * sw;
    const float fn = fy[k * py + in] * sn, fs = fy[k * py + is] * ss;
    d[k] = -((fe - fw) * inv_dx + (fn - fs) * inv_dy);
  }
  const Cell s = load_cell(q, C, c);
  const rdy::FlowRhs fr = rdy::flow_rhs(s, d[0], d[1], d[2], dzx, dzy, mann,
                                        src, c, dt, tiny_h);
  rdy::store_flow(out, qA, C, c, rhs_mode, alpha, beta, s, dt, fr);
  if (prim) {
    float u, v;
    rdy::regularized_velocity(s.h, s.hu, s.hv, tiny_h, h_anuga, u, v);
    prim[c] = s.h;
    prim[C + c] = u;
    prim[2 * C + c] = v;
  }
}

}  // namespace

// faces: fx[3, ny, nx + 1], fy[3, ny + 1, nx] and cmax (ceil(nx/bx) *
// ceil(ny/by) floats, row-major by block) of the flow state q[3, ny*nx]
// with the wall codes and Dirichlet walls' values (bv_*: [3, n], n = ny
// for left/right, nx for bottom/top), limiter = kLimMinmod, kLimVanLeer or
// kLimNone. update: out (rhs_mode != 0: the RHS; else alpha*qA + beta*(q +
// dt*rhs), qA may be NULL) and prim (may be NULL) from q and those faces.
// Blocks of bx x by threads (bx * by a multiple of 32, at most 256). Both
// return cudaGetLastError().
extern "C" int rdy_swe_raster_muscl_faces_f32(
    const void* q, int bc_l, int bc_r, int bc_b, int bc_t, const void* bv_l,
    const void* bv_r, const void* bv_b, const void* bv_t, int64_t nx,
    int64_t ny, float tiny_h, float h_anuga, float inv_dx, float inv_dy,
    int limiter, void* fx, void* fy, void* cmax, int bx, int by,
    void* stream) {
  if (!rdy::raster_launch_ok(nx, ny, bx, by))
    return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const dim3 grid((unsigned)((nx + bx - 1) / bx),
                  (unsigned)((ny + by - 1) / by));
  auto run = [&](auto kernel) {
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)q, bc_l, bc_r, bc_b, bc_t, (const float*)bv_l,
        (const float*)bv_r, (const float*)bv_b, (const float*)bv_t, nx, ny,
        tiny_h, h_anuga, inv_dx, inv_dy, (float*)fx, (float*)fy,
        (float*)cmax);
    return (int)cudaGetLastError();
  };
  switch (limiter) {
    case rdy::kLimMinmod:
      return run(swe_raster_muscl_faces_kernel<rdy::kLimMinmod>);
    case rdy::kLimVanLeer:
      return run(swe_raster_muscl_faces_kernel<rdy::kLimVanLeer>);
    case rdy::kLimNone:
      return run(swe_raster_muscl_faces_kernel<rdy::kLimNone>);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rdy_swe_raster_muscl_update_f32(
    const void* q, const void* qA, const void* fx, const void* fy,
    const void* dzx, const void* dzy, const void* mann, const void* src,
    int64_t nx, int64_t ny, float tiny_h, float h_anuga, float inv_dx,
    float inv_dy, int rhs_mode, float alpha, float beta, const void* dt,
    void* out, void* prim, int bx, int by, void* stream) {
  if (!rdy::raster_launch_ok(nx, ny, bx, by))
    return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const dim3 grid((unsigned)((nx + bx - 1) / bx),
                  (unsigned)((ny + by - 1) / by));
  swe_raster_muscl_update_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)qA, (const float*)fx, (const float*)fy,
      (const float*)dzx, (const float*)dzy, (const float*)mann,
      (const float*)src, nx, ny, tiny_h, h_anuga, inv_dx, inv_dy, rhs_mode,
      alpha, beta, (const float*)dt, (float*)out, (float*)prim);
  return (int)cudaGetLastError();
}
