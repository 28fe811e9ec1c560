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
// Strip mode: one launch pair per row strip replaces the same kernel run
// per shard by make_sharded_fused_structured_stepper(second_order=True)
// (:1019, pallas_call :1211). The strip buffer carries 3 halo rows where
// its bottom or top is not the raster's wall (the TPU stepper's HR = 3,
// :1144-1148): faces also solves the faces of one halo row below and
// above, since the donor factor of a halo cell scales the face it shares
// with an owned cell, and that factor needs all four of the halo cell's
// faces; its south (north) face needs the gradient of the next halo row,
// which reads the third. The gradients' one-sidedness, the wall faces and
// the donors' presence test the cell's global row (the TPU kernel's masks
// on global rows, :250-261, :354-393, :465-473, :527-531), and the
// y face between two halo rows goes through the same y_face as the
// north face of that row on the whole raster, so strips reproduce the
// single launch bit for bit.
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

// the MUSCL face between the cell s at c (raster row g) and the cell
// above it, neither on the raster's top row: the normal gradients of both
// from their rows below and above (where the raster has them), then the
// limited face (the north face of row g, the south face of row g + 1)
template <int kLim>
__device__ __forceinline__ void y_face(const float* __restrict__ q,
                                       int64_t C, int64_t c, int64_t g,
                                       const Cell& s, int64_t nx, int64_t ny,
                                       float inv_dy, float hdy, float tiny_h,
                                       float h_anuga, float f[3], float& a) {
  const Cell so = g > 0 ? load_cell(q, C, c - nx) : s;
  const Cell n = load_cell(q, C, c + nx);
  const Cell n2 = g + 2 < ny ? load_cell(q, C, c + 2 * nx) : n;
  float gc[3], gn[3], el[3], er[3];
  gradient(so, s, n, g > 0, true, inv_dy, gc);
  gradient(s, n, n2, true, g + 2 < ny, inv_dy, gn);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    el[k] = gc[k] * hdy;
    er[k] = -gn[k] * hdy;
  }
  muscl_face<kLim>(s, n, el, er, 1.0f, 0.0f, tiny_h, h_anuga, f, a);
}

// one thread per cell of the face rows: the owned rows, and one halo row
// below (above) where the strip has halo rows there, whose faces the
// update kernel needs for the halo cells' donor factors
template <int kLim, bool kStrip>
__global__ void __launch_bounds__(kRasterThreads)
    swe_raster_muscl_faces_kernel(
    const float* __restrict__ q, int bc_l, int bc_r, int bc_b, int bc_t,
    const float* __restrict__ bv_l, const float* __restrict__ bv_r,
    const float* __restrict__ bv_b, const float* __restrict__ bv_t,
    int64_t nx, int64_t ny, int64_t row0, int64_t rows, int64_t halo_lo,
    int64_t x_lo, int64_t face_rows, int64_t buf_rows, float tiny_h,
    float h_anuga, float inv_dx, float inv_dy, float* __restrict__ fx,
    float* __restrict__ fy, float* __restrict__ cmax) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y * (int64_t)blockDim.y + threadIdx.y;
  float cm = 0.0f;
  if (i < nx && j < face_rows) {
    // j: the face row; r the strip's row (-1 and rows are halo rows), jb
    // its row in the buffer, g on the raster (the whole raster, !kStrip:
    // all four are j, and the buffer and face rows the raster's rows)
    const int64_t r = kStrip ? j - x_lo : j;
    const int64_t jb = kStrip ? r + halo_lo : j;
    const int64_t g = kStrip ? row0 + r : j;
    const bool owned = !kStrip || (r >= 0 && r < rows);
    const int64_t nb = kStrip ? buf_rows : rows;
    const int64_t nf = kStrip ? face_rows : rows;
    const int64_t C = nx * nb;
    const int64_t c = jb * nx + i;
    const int64_t px = nf * (nx + 1), py = (nf + 1) * nx;
    const float hdx = 0.5f / inv_dx, hdy = 0.5f / inv_dy;
    const float zero[3] = {0.0f, 0.0f, 0.0f};
    const Cell s = load_cell(q, C, c);
    float f[3], a, el[3], er[3];
    // east face: the right wall's first-order ghost face, or MUSCL
    // between this cell and its east neighbour
    if (i == nx - 1) {
      const Cell gh = wall_ghost(bc_r, s, 0.0f, 1.0f, bv_r, jb, nb, tiny_h,
                                 h_anuga);
      muscl_face<kLim>(s, gh, zero, zero, 0.0f, 1.0f, tiny_h, h_anuga, f, a);
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
    // the Courant maximum of the owned cells' faces alone
    if (owned) cm = a * inv_dx;
    // north face
    if (g == ny - 1) {
      const Cell gh = wall_ghost(bc_t, s, 1.0f, 0.0f, bv_t, i, nx, tiny_h,
                                 h_anuga);
      muscl_face<kLim>(s, gh, zero, zero, 1.0f, 0.0f, tiny_h, h_anuga, f, a);
    } else {
      y_face<kLim>(q, C, c, g, s, nx, ny, inv_dy, hdy, tiny_h, h_anuga, f,
                   a);
    }
    store3(fy, py, (j + 1) * nx + i, f);
    if (owned) cm = nanmax(cm, a * inv_dy);
    // the wall face west of column 0, and the south face of the first face
    // row: the raster's bottom wall, or below the strip's lowest halo face
    // row the face between two halo rows
    if (i == 0) {
      const Cell gh = wall_ghost(bc_l, s, 0.0f, -1.0f, bv_l, jb, nb, tiny_h,
                                 h_anuga);
      muscl_face<kLim>(gh, s, zero, zero, 0.0f, 1.0f, tiny_h, h_anuga, f, a);
      store3(fx, px, j * (nx + 1), f);
      if (owned) cm = nanmax(cm, a * inv_dx);
    }
    if (j == 0) {
      if (!kStrip || g == 0) {
        const Cell gh = wall_ghost(bc_b, s, -1.0f, 0.0f, bv_b, i, nx, tiny_h,
                                   h_anuga);
        muscl_face<kLim>(gh, s, zero, zero, 1.0f, 0.0f, tiny_h, h_anuga, f,
                         a);
        cm = nanmax(cm, a * inv_dy);
      } else {
        y_face<kLim>(q, C, c - nx, g - 1, load_cell(q, C, c - nx), nx, ny,
                     inv_dy, hdy, tiny_h, h_anuga, f, a);
      }
      store3(fy, py, i, f);
    }
  }
  rdy::store_block_max(cm, cmax);
}

__device__ __forceinline__ float relu(float x) { return x > 0.0f ? x : 0.0f; }

// the donor factor of the cell in column i of face row jf and buffer row
// jb (K3b's, on the raster): its drain is the outgoing h-flux rate of its
// four faces
__device__ __forceinline__ float donor_factor(
    const float* __restrict__ fxh, const float* __restrict__ fyh,
    const float* __restrict__ q, int64_t nx, int64_t i, int64_t jf,
    int64_t jb, float inv_dx, float inv_dy, float dt_s) {
  const float fe = fxh[jf * (nx + 1) + i + 1], fw = fxh[jf * (nx + 1) + i];
  const float fn = fyh[(jf + 1) * nx + i], fs = fyh[jf * nx + i];
  const float drain =
      (relu(fe) + relu(-fw)) * inv_dx + (relu(fn) + relu(-fs)) * inv_dy;
  if (!(drain > 0.0f)) return 1.0f;
  const float sc = q[jb * nx + i] / (dt_s * drain);
  return sc < 0.0f ? 0.0f : (sc > 1.0f ? 1.0f : sc);
}

template <bool kStrip>
__global__ void __launch_bounds__(kRasterThreads)
    swe_raster_muscl_update_kernel(
    const float* __restrict__ q, const float* __restrict__ qA,
    const float* __restrict__ fx, const float* __restrict__ fy,
    const float* __restrict__ dzx, const float* __restrict__ dzy,
    const float* __restrict__ mann, const float* __restrict__ src,
    int64_t nx, int64_t ny, int64_t row0, int64_t rows, int64_t halo_lo,
    int64_t x_lo, int64_t face_rows, int64_t buf_rows, float tiny_h,
    float h_anuga, float inv_dx, float inv_dy, int rhs_mode, float alpha,
    float beta, const float* __restrict__ dt_ptr, float* __restrict__ out,
    float* __restrict__ prim) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y * (int64_t)blockDim.y + threadIdx.y;
  if (i >= nx || j >= rows) return;
  // j: the owned row; jf its face row, jb its buffer row, g on the raster
  // (the whole raster, !kStrip: all four are j)
  const int64_t jf = kStrip ? j + x_lo : j;
  const int64_t jb = kStrip ? j + halo_lo : j;
  const int64_t g = kStrip ? row0 + j : j;
  const int64_t C = nx * (kStrip ? buf_rows : rows);
  const int64_t c = jb * nx + i;
  const int64_t nf = kStrip ? face_rows : rows;
  const int64_t px = nf * (nx + 1), py = (nf + 1) * nx;
  const float dt = *dt_ptr;
  const float dt_s = dt > 0.0f ? dt : 1.0f;
  const int64_t iw = jf * (nx + 1) + i, ie = iw + 1;
  const int64_t is = jf * nx + i, in = is + nx;
  const float sc =
      donor_factor(fx, fy, q, nx, i, jf, jb, inv_dx, inv_dy, dt_s);
  // each face's donor: this cell where the flux leaves it, else the
  // neighbour across it, a halo cell beyond the strip's bottom or top (a
  // ghost beyond a wall keeps s = 1)
  auto donor = [&](bool out_of_cell, bool has_nbr, int64_t ni, int64_t dj) {
    if (out_of_cell) return sc;
    return has_nbr ? donor_factor(fx, fy, q, nx, ni, jf + dj, jb + dj,
                                  inv_dx, inv_dy, dt_s)
                   : 1.0f;
  };
  const float se = donor(fx[ie] > 0.0f, i + 1 < nx, i + 1, 0);
  const float sw = donor(!(fx[iw] > 0.0f), i > 0, i - 1, 0);
  const float sn = donor(fy[in] > 0.0f, g + 1 < ny, i, 1);
  const float ss = donor(!(fy[is] > 0.0f), g > 0, i, -1);
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float fe = fx[k * px + ie] * se, fw = fx[k * px + iw] * sw;
    const float fn = fy[k * py + in] * sn, fs = fy[k * py + is] * ss;
    d[k] = -((fe - fw) * inv_dx + (fn - fs) * inv_dy);
  }
  const Cell s = load_cell(q, C, c);
  // the geometry, rain and primitive planes hold the owned rows alone
  const int64_t Co = nx * rows, co = j * nx + i;
  const rdy::FlowRhs fr = rdy::flow_rhs(s, d[0], d[1], d[2], dzx, dzy, mann,
                                        src, co, dt, tiny_h);
  rdy::store_flow(out, qA, C, c, rhs_mode, alpha, beta, s, dt, fr);
  if (prim) {
    float u, v;
    rdy::regularized_velocity(s.h, s.hu, s.hv, tiny_h, h_anuga, u, v);
    prim[co] = s.h;
    prim[Co + co] = u;
    prim[2 * Co + co] = v;
  }
}

}  // namespace

// Both launch over the owned rows [row0, row0 + rows) of the [ny, nx]
// raster (strip_ok of raster_common.cuh, depth 3: a halo cell's donor
// factor needs its south face, whose lower cell's gradient reads a third
// row; the whole raster: 0, ny, 0, 0). q and qA are strip buffers [3,
// (halo_lo + rows + halo_hi) * nx]. The face rows are the owned rows and
// one halo row below (x_lo = 1) and above (x_hi = 1) where the strip has
// halo rows there: face_rows = x_lo + rows + x_hi.
// faces: fx[3, face_rows, nx + 1], fy[3, face_rows + 1, nx] and cmax
// (ceil(nx/bx) * ceil(face_rows/by) floats, row-major by block, over the
// owned cells' faces) of the flow state q with the wall codes and the
// Dirichlet walls' values (bv_l, bv_r: [3, halo_lo + rows + halo_hi] by
// buffer row; bv_b, bv_t: [3, nx], read only by a strip that holds that
// wall), limiter = kLimMinmod, kLimVanLeer or kLimNone. update: the owned
// rows of out (rhs_mode != 0: the RHS; else alpha*qA + beta*(q + dt*rhs),
// qA may be NULL), a strip buffer like q, and prim [3, rows * nx] (may be
// NULL) from q and those faces, with dzx, dzy, mann and src [rows, nx].
// Blocks of bx x by threads (bx * by a multiple of 32, at most 256). Both
// return cudaGetLastError().
namespace {

struct StripRows {
  int64_t x_lo, face_rows, buf_rows;
};

StripRows strip_rows(int64_t rows, int halo_lo, int halo_hi) {
  const int64_t x_lo = halo_lo > 0, x_hi = halo_hi > 0;
  return StripRows{x_lo, x_lo + rows + x_hi, halo_lo + rows + halo_hi};
}

}  // namespace

extern "C" int rdy_swe_raster_muscl_faces_f32(
    const void* q, int bc_l, int bc_r, int bc_b, int bc_t, const void* bv_l,
    const void* bv_r, const void* bv_b, const void* bv_t, int64_t nx,
    int64_t ny, int64_t row0, int64_t rows, int halo_lo, int halo_hi,
    float tiny_h, float h_anuga, float inv_dx, float inv_dy, int limiter,
    void* fx, void* fy, void* cmax, int bx, int by, void* stream) {
  const StripRows sr = strip_rows(rows, halo_lo, halo_hi);
  if (!rdy::raster_launch_ok(nx, sr.face_rows, bx, by) ||
      !rdy::strip_ok(ny, row0, rows, halo_lo, halo_hi, 3))
    return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const dim3 grid((unsigned)((nx + bx - 1) / bx),
                  (unsigned)((sr.face_rows + by - 1) / by));
  auto run = [&](auto kernel) {
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)q, bc_l, bc_r, bc_b, bc_t, (const float*)bv_l,
        (const float*)bv_r, (const float*)bv_b, (const float*)bv_t, nx, ny,
        row0, rows, (int64_t)halo_lo, sr.x_lo, sr.face_rows, sr.buf_rows,
        tiny_h, h_anuga, inv_dx, inv_dy, (float*)fx, (float*)fy,
        (float*)cmax);
    return (int)cudaGetLastError();
  };
  // the whole raster takes the instances without strip arithmetic
  const bool strip = halo_lo > 0 || halo_hi > 0;
  switch (limiter) {
    case rdy::kLimMinmod:
      return strip ? run(swe_raster_muscl_faces_kernel<rdy::kLimMinmod, true>)
                   : run(swe_raster_muscl_faces_kernel<rdy::kLimMinmod, false>);
    case rdy::kLimVanLeer:
      return strip
                 ? run(swe_raster_muscl_faces_kernel<rdy::kLimVanLeer, true>)
                 : run(swe_raster_muscl_faces_kernel<rdy::kLimVanLeer, false>);
    case rdy::kLimNone:
      return strip ? run(swe_raster_muscl_faces_kernel<rdy::kLimNone, true>)
                   : run(swe_raster_muscl_faces_kernel<rdy::kLimNone, false>);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rdy_swe_raster_muscl_update_f32(
    const void* q, const void* qA, const void* fx, const void* fy,
    const void* dzx, const void* dzy, const void* mann, const void* src,
    int64_t nx, int64_t ny, int64_t row0, int64_t rows, int halo_lo,
    int halo_hi, float tiny_h, float h_anuga, float inv_dx, float inv_dy,
    int rhs_mode, float alpha, float beta, const void* dt, void* out,
    void* prim, int bx, int by, void* stream) {
  const StripRows sr = strip_rows(rows, halo_lo, halo_hi);
  if (!rdy::raster_launch_ok(nx, rows, bx, by) ||
      !rdy::strip_ok(ny, row0, rows, halo_lo, halo_hi, 3))
    return (int)cudaErrorInvalidValue;
  const dim3 block(bx, by);
  const dim3 grid((unsigned)((nx + bx - 1) / bx),
                  (unsigned)((rows + by - 1) / by));
  auto kernel = halo_lo > 0 || halo_hi > 0
                    ? swe_raster_muscl_update_kernel<true>
                    : swe_raster_muscl_update_kernel<false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)qA, (const float*)fx, (const float*)fy,
      (const float*)dzx, (const float*)dzy, (const float*)mann,
      (const float*)src, nx, ny, row0, rows, (int64_t)halo_lo, sr.x_lo,
      sr.face_rows, sr.buf_rows, tiny_h, h_anuga, inv_dx, inv_dy, rhs_mode,
      alpha, beta, (const float*)dt, (float*)out, (float*)prim);
  return (int)cudaGetLastError();
}
