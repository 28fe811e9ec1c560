// K2 swe_raster_step: one whole step (or RK stage, or RHS) of the shallow
// water equations on a uniform [ny, nx] raster, first order, flow only or
// with NT tracers.
//
// Replaces the TPU kernel _kernel of rdycore_tpu/ops/pallas/structured_step.py
// (:172) in its modes base, emit_rhs, with_src and nt, as called by
// make_fused_structured_stepper (:659): x/y Roe faces with wall ghosts, flux
// divergence, bed slope, semi-implicit Manning friction, an external water
// source, Hairsine-Rose sediment sources, and the stage update, plus the
// Courant maximum per block.
//
// Strip mode: one launch per row strip replaces the same kernel run per
// shard by make_sharded_fused_structured_stepper (:1019, pallas_call
// :1211), first order. A launch owns the rows [row0, row0 + rows) of the
// raster, held in a strip buffer with halo rows below and above (one row
// each at first order, copies of the neighbour strips' rows made between
// launches); the tests for a neighbour take the raster's global row, so a
// strip's bottom or top reads its halo row where it is not the raster's
// wall, and only the raster's walls take ghosts. Each cell does the same
// arithmetic on the same values as on the whole raster, so P strips give
// the single launch's result bit for bit. The whole raster is the strip
// at row 0 with no halo rows.
//
// One thread per cell (i = column, j = row); threads along x take
// neighbouring addresses, so every plane is read and written coalesced. A
// thread loads its cell and its four neighbours, forms the ghost state of a
// wall neighbour inline (_ghost :60-80: the Dirichlet values; the reflecting
// mirror; the critical-outflow ghost ONLY, the interior state left as it is),
// regularizes every velocity and takes sqrt(max(h, 0)) once per cell, and
// solves its four faces: west roe(W, c) and east roe(c, E) with normal +x,
// south roe(S, c) and north roe(c, N) with normal +y, each with 1/chat from
// rsqrt (roe_flux(fast=True)). Then
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
// The tracer count NT is a template parameter (0..kMaxTracers, dispatched
// at launch), so the five cells' concentrations and the four faces' tracer
// fluxes of a thread stay in registers. NT = 0 is the flow-only kernel with
// the pure-flow face mask (both sides below tiny_h: zero). The nt mode
// (structured_step.py :277-339, :601-641) reads the tracer masses, rows
// 3.. of q, beside the flow; a wall ghost's tracer mass is the prescribed
// row of a Dirichlet wall, else h_ghost * c_interior (fill_ghost_frame
// _ghost_hc :104-113); each face's tracer flux comes from the same fast
// Roe eigensystem (Roe advected waves, or upwind-Roe), and every row of a
// face is kept where either side is wet (h > tiny_h, strict). The flow
// sources keep their semantics (wet at h >= tiny_h); the sediment classes
// get erosion minus deposition where h > tiny_h; the primitive rows of the
// tracers are their concentrations.
//
// Bound: device memory. Per cell it reads q (3 + NT planes), dz/dx, dz/dy
// and Manning's n, writes 3 + NT planes, and reads the rain plane, qA
// (3 + NT planes) and writes prim (3 + NT planes) when asked: flow only 9 to
// 16 f32 planes, 104 MB (euler) to 138 MB (with prim) on the 2,883,584-cell
// raster, at least 0.031 / 0.041 ms at the H100's 3.35 TB/s; with NT = 3
// and prim, 21 planes, 242 MB, 0.072 ms. The arithmetic is about 700
// operations per cell flow-only (each interior face is solved twice, once
// by each of its cells; a divide, square root or pow counted as one), 2.0
// Gop per launch there, 0.030 ms at 67 TFLOP/s f32, just below the bytes
// bound, plus about 75 per tracer; each divide, square root and pow takes
// several instructions, so the instruction rate may bind first.
// What this simple design leaves on the table: the neighbour loads go
// through L1/L2 rather than a shared-memory tile with a halo, the four Roe
// solves per cell double the face work, and no cp.async/TMA overlaps loads
// with compute.
#include "raster_common.cuh"

namespace {

using rdy::Cell;
using rdy::kDirichlet;
using rdy::kRasterThreads;
using rdy::load_cell;
using rdy::nanmax;
using rdy::wall_ghost;

struct Prep {
  float h, u, v, sq;
};

__device__ __forceinline__ Prep prep(Cell s, float tiny_h, float h_anuga) {
  Prep p;
  p.h = s.h;
  rdy::regularized_velocity(s.h, s.hu, s.hv, tiny_h, h_anuga, p.u, p.v);
  p.sq = sqrtf(rdy::clamp_min0(s.h));
  return p;
}

// the NT tracer masses of a cell, and of a wall ghost (_ghost_hc): the
// prescribed rows 3.. of a Dirichlet wall, else the ghost depth hg times
// the interior cell s's concentration
template <int NT>
struct Tracers {
  float m[NT > 0 ? NT : 1];
};

template <int NT>
__device__ __forceinline__ Tracers<NT> load_hc(const float* __restrict__ q,
                                               int64_t C, int64_t c) {
  Tracers<NT> t;
#pragma unroll
  for (int j = 0; j < NT; ++j) t.m[j] = q[(3 + j) * C + c];
  return t;
}

template <int NT>
__device__ __forceinline__ Tracers<NT> ghost_hc(
    int bc, float h_int, const Tracers<NT>& hc_int, float hg,
    const float* __restrict__ bv, int64_t pos, int64_t n, float tiny_h) {
  Tracers<NT> t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (bc == kDirichlet) {
      t.m[j] = bv[(3 + j) * n + pos];
    } else {
      const float hden = fabsf(h_int) > 0.0f ? h_int : 1.0f;
      t.m[j] = hg * (h_int > tiny_h ? hc_int.m[j] / hden : 0.0f);
    }
  }
  return t;
}

// concentrations of the tracer masses m of a cell of depth h (safe_div)
template <int NT>
__device__ __forceinline__ Tracers<NT> conc(float h, const Tracers<NT>& m,
                                            float tiny_h) {
  Tracers<NT> c;
#pragma unroll
  for (int j = 0; j < NT; ++j) c.m[j] = rdy::safe_div(m.m[j], h, h, tiny_h);
  return c;
}

// masked Roe flux of one face with normal (sn, cn) = (0, 1) or (1, 0):
// flow only (NT = 0), the both-dry mask of the pure-flow kernel; with
// tracers also their fluxes ft, and every row and a under the strict
// either-wet mask of the coupled system
template <int NT, bool kUpwind>
__device__ __forceinline__ void face(const Prep& l, const Prep& r,
                                     const Tracers<NT>& cl,
                                     const Tracers<NT>& cr, float sn,
                                     float cn, float tiny_h, float f[3],
                                     float& a, Tracers<NT>& ft) {
  rdy::roe_flux_sqrt<float, true, NT, kUpwind>(l.h, l.u, l.v, r.h, r.u, r.v,
                                               l.sq, r.sq, sn, cn, f, a,
                                               cl.m, cr.m, ft.m);
  float m;
  if constexpr (NT == 0) {
    m = (l.h < tiny_h && r.h < tiny_h) ? 0.0f : 1.0f;
  } else {
    m = (l.h > tiny_h || r.h > tiny_h) ? 1.0f : 0.0f;
  }
  f[0] *= m;
  f[1] *= m;
  f[2] *= m;
  a *= m;
#pragma unroll
  for (int j = 0; j < NT; ++j) ft.m[j] *= m;
}

template <int NT, bool kUpwind, bool kStrip>
__global__ void __launch_bounds__(kRasterThreads) swe_raster_step_kernel(
    const float* __restrict__ q, const float* __restrict__ qA,
    const float* __restrict__ dzx, const float* __restrict__ dzy,
    const float* __restrict__ mann, const float* __restrict__ src,
    const float* __restrict__ dt_ptr, int bc_l, int bc_r, int bc_b, int bc_t,
    const float* __restrict__ bv_l, const float* __restrict__ bv_r,
    const float* __restrict__ bv_b, const float* __restrict__ bv_t,
    int64_t nx, int64_t ny, int64_t row0, int64_t rows, int64_t halo_lo,
    int64_t buf_rows, float tiny_h, float h_anuga, float inv_dx,
    float inv_dy, int rhs_mode, float alpha, float beta, int num_sediment,
    rdy::SedimentParams<float> sp, float* __restrict__ out,
    float* __restrict__ prim, float* __restrict__ cmax) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t j = blockIdx.y * (int64_t)blockDim.y + threadIdx.y;
  float cm = 0.0f;
  if (i < nx && j < rows) {
    // j: the owned row; jb its row in the strip buffer, g on the raster
    // (the whole raster, !kStrip: all three are j, and the buffer the
    // raster itself)
    const int64_t nb = kStrip ? buf_rows : rows;  // rows of the buffer
    const int64_t C = nx * nb;
    const int64_t jb = kStrip ? j + halo_lo : j;
    const int64_t g = kStrip ? row0 + j : j;
    const int64_t c = jb * nx + i;
    const Cell s = load_cell(q, C, c);
    const Cell w = i > 0 ? load_cell(q, C, c - 1)
                         : wall_ghost(bc_l, s, 0.0f, -1.0f, bv_l, jb, nb,
                                      tiny_h, h_anuga);
    const Cell e = i < nx - 1 ? load_cell(q, C, c + 1)
                              : wall_ghost(bc_r, s, 0.0f, 1.0f, bv_r, jb, nb,
                                           tiny_h, h_anuga);
    const Cell so = g > 0 ? load_cell(q, C, c - nx)
                          : wall_ghost(bc_b, s, -1.0f, 0.0f, bv_b, i, nx,
                                       tiny_h, h_anuga);
    const Cell no = g < ny - 1 ? load_cell(q, C, c + nx)
                               : wall_ghost(bc_t, s, 1.0f, 0.0f, bv_t, i, nx,
                                            tiny_h, h_anuga);
    // tracer masses of the cell and its neighbours, then concentrations
    Tracers<NT> mc, cc, cw, ce, cs, cnn;
    if constexpr (NT > 0) {
      mc = load_hc<NT>(q, C, c);
      cc = conc<NT>(s.h, mc, tiny_h);
      cw = conc<NT>(w.h,
                    i > 0 ? load_hc<NT>(q, C, c - 1)
                          : ghost_hc<NT>(bc_l, s.h, mc, w.h, bv_l, jb, nb,
                                         tiny_h),
                    tiny_h);
      ce = conc<NT>(e.h,
                    i < nx - 1 ? load_hc<NT>(q, C, c + 1)
                               : ghost_hc<NT>(bc_r, s.h, mc, e.h, bv_r, jb,
                                              nb, tiny_h),
                    tiny_h);
      cs = conc<NT>(so.h,
                    g > 0 ? load_hc<NT>(q, C, c - nx)
                          : ghost_hc<NT>(bc_b, s.h, mc, so.h, bv_b, i, nx,
                                         tiny_h),
                    tiny_h);
      cnn = conc<NT>(no.h,
                     g < ny - 1 ? load_hc<NT>(q, C, c + nx)
                                : ghost_hc<NT>(bc_t, s.h, mc, no.h, bv_t, i,
                                               nx, tiny_h),
                     tiny_h);
    }
    const Prep pc = prep(s, tiny_h, h_anuga);
    float fw[3], fe[3], fs[3], fn[3], aw, ae, as, an;
    Tracers<NT> tw, te, ts, tn;
    face<NT, kUpwind>(prep(w, tiny_h, h_anuga), pc, cw, cc, 0.0f, 1.0f,
                      tiny_h, fw, aw, tw);
    face<NT, kUpwind>(pc, prep(e, tiny_h, h_anuga), cc, ce, 0.0f, 1.0f,
                      tiny_h, fe, ae, te);
    face<NT, kUpwind>(prep(so, tiny_h, h_anuga), pc, cs, cc, 1.0f, 0.0f,
                      tiny_h, fs, as, ts);
    face<NT, kUpwind>(pc, prep(no, tiny_h, h_anuga), cc, cnn, 1.0f, 0.0f,
                      tiny_h, fn, an, tn);
    cm = nanmax(nanmax(aw * inv_dx, ae * inv_dx),
                nanmax(as * inv_dy, an * inv_dy));

    const float dh = -((fe[0] - fw[0]) * inv_dx + (fn[0] - fs[0]) * inv_dy);
    const float dhu = -((fe[1] - fw[1]) * inv_dx + (fn[1] - fs[1]) * inv_dy);
    const float dhv = -((fe[2] - fw[2]) * inv_dx + (fn[2] - fs[2]) * inv_dy);

    // semi-implicit bed slope and Manning friction (_kernel :579-599);
    // the geometry, rain and primitive planes hold the owned rows alone
    const float dt = *dt_ptr;
    const int64_t Co = nx * rows;
    const int64_t co = j * nx + i;
    const rdy::FlowRhs fr =
        rdy::flow_rhs(s, dh, dhu, dhv, dzx, dzy, mann, src, co, dt, tiny_h);
    rdy::store_flow(out, qA, C, c, rhs_mode, alpha, beta, s, dt, fr);
    if (prim) {
      prim[co] = s.h;
      prim[Co + co] = pc.u;
      prim[2 * Co + co] = pc.v;
    }
    if constexpr (NT > 0) {
      // tracer rows (_kernel :601-641): the divergence, Hairsine-Rose
      // erosion minus deposition on the sediment classes under the strict
      // wet test, and the primitive row, the concentration under it
      const bool wet_t = s.h > tiny_h;
      const float tau_b =
          0.5f * sp.rhow * fr.cd * (fr.uu * fr.uu + fr.vv * fr.vv);
      const float ero = sp.kp * (tau_b - sp.tau_ce) / sp.tau_ce;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const float ck = wet_t ? mc.m[k] / (wet_t ? s.h : 1.0f) : 0.0f;
        float rhc = -((te.m[k] - tw.m[k]) * inv_dx +
                      (tn.m[k] - ts.m[k]) * inv_dy);
        if (num_sediment) {
          const float dep = sp.ws * ck * (1.0f - tau_b / sp.tau_cd);
          float ed = wet_t ? ero - dep : 0.0f;
          if (num_sediment < NT) ed = ed * (k < num_sediment ? 1.0f : 0.0f);
          rhc = rhc + ed;
        }
        const int64_t r = (3 + k) * C + c;
        if (rhs_mode) {
          out[r] = rhc;
        } else {
          float o = beta * (mc.m[k] + dt * rhc);
          if (qA) o = alpha * qA[r] + o;
          out[r] = o;
        }
        if (prim) prim[(3 + k) * Co + co] = ck;
      }
    }
  }

  rdy::store_block_max(cm, cmax);
}

}  // namespace

// One launch over the owned rows [row0, row0 + rows) of the [ny, nx]
// raster (strip_ok of raster_common.cuh, depth 1; the whole raster: 0, ny,
// 0, 0) with blocks of bx x by threads (bx * by a multiple of 32, at most
// 256); cmax holds ceil(nx/bx) * ceil(rows/by) floats, row-major by block.
// q, qA and out are strip buffers [ndof, (halo_lo + rows + halo_hi) * nx],
// of which out's owned rows are written; dzx, dzy, mann, src [rows, nx]
// and prim [ndof, rows * nx] hold the owned rows; the Dirichlet values
// bv_l, bv_r [ndof, halo_lo + rows + halo_hi] follow the buffer's rows,
// bv_b and bv_t [ndof, nx] are read only by a strip that holds that wall.
// A neighbour row beyond the strip is its halo row, the wall ghost only on
// the raster's bottom and top. rhs_mode != 0 writes the RHS to out, else
// the stage alpha*qA + beta*(q + dt*rhs). nt: tracer rows of q, qA, the
// Dirichlet walls' values, out and prim beyond (h, hu, hv), the first
// num_sediment of them sediment classes with the Hairsine-Rose parameters
// kp, ws, tau_ce, tau_cd, rhow; upwind != 0 takes upwind-Roe tracer
// fluxes. Returns cudaGetLastError().
extern "C" int rdy_swe_raster_step_f32(
    const void* q, const void* qA, const void* dzx, const void* dzy,
    const void* mann, const void* src, const void* dt, int bc_l, int bc_r,
    int bc_b, int bc_t, const void* bv_l, const void* bv_r, const void* bv_b,
    const void* bv_t, int64_t nx, int64_t ny, int64_t row0, int64_t rows,
    int halo_lo, int halo_hi, float tiny_h, float h_anuga, float inv_dx,
    float inv_dy, int rhs_mode, float alpha, float beta, int nt, int upwind,
    int num_sediment, float kp, float ws, float tau_ce, float tau_cd,
    float rhow, void* out, void* prim, void* cmax, int bx, int by,
    void* stream) {
  if (!rdy::raster_launch_ok(nx, rows, bx, by) ||
      !rdy::strip_ok(ny, row0, rows, halo_lo, halo_hi, 1))
    return (int)cudaErrorInvalidValue;
  const int64_t gx = (nx + bx - 1) / bx, gy = (rows + by - 1) / by;
  const int64_t buf_rows = halo_lo + rows + halo_hi;
  const dim3 block(bx, by);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const rdy::SedimentParams<float> sp{kp, ws, tau_ce, tau_cd, rhow};
  // the whole raster takes the instance without strip arithmetic
  const bool strip = halo_lo > 0 || halo_hi > 0;
  return rdy::dispatch_nt(nt, upwind != 0, [&](auto tag) {
    using Tag = decltype(tag);
    auto kernel = strip ? swe_raster_step_kernel<Tag::nt, Tag::upwind, true>
                        : swe_raster_step_kernel<Tag::nt, Tag::upwind, false>;
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)qA, (const float*)dzx,
        (const float*)dzy, (const float*)mann, (const float*)src,
        (const float*)dt, bc_l, bc_r, bc_b, bc_t, (const float*)bv_l,
        (const float*)bv_r, (const float*)bv_b, (const float*)bv_t, nx,
        ny, row0, rows, (int64_t)halo_lo, buf_rows, tiny_h, h_anuga,
        inv_dx, inv_dy, rhs_mode, alpha, beta,
        num_sediment, sp, (float*)out, (float*)prim, (float*)cmax);
    return (int)cudaGetLastError();
  });
}
