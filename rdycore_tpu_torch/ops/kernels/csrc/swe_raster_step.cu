// K2 swe_raster_step: one whole step (or RK stage, or RHS) of the shallow
// water equations on a uniform [ny, nx] raster, first order, flow only or
// with NT tracers.
//
// Replaces the TPU kernel _kernel of rdycore_tpu/ops/pallas/structured_step.py
// (:172) in its modes base, emit_rhs, with_src and nt, as called by
// make_fused_structured_stepper (:659): x/y Roe faces with wall ghosts, flux
// divergence, bed slope, semi-implicit Manning friction, an external water
// source, Hairsine-Rose sediment sources, and the stage update, plus the
// Courant maximum per tile.
//
// Strip mode: one launch per row strip replaces the same kernel run per
// shard by make_sharded_fused_structured_stepper (:1019, pallas_call
// :1211), first order. A launch owns the rows [row0, row0 + rows) of the
// raster, held in a strip buffer with halo rows below and above (one row
// each at first order, copies of the neighbour strips' rows made between
// launches); the tests for a neighbour take the raster's global row, so a
// strip's bottom or top reads its halo row where it is not the raster's
// wall, and only the raster's walls take ghosts. The strip arithmetic is
// runtime (the whole raster is the strip at row 0 with no halo rows), so
// the whole raster and every strip run the same instructions on the same
// values: P strips give the single launch's result bit for bit.
//
// Design: a block owns a tile of TX x TY cells (32 x 16 flow only, 32 x 8
// with tracers; 256 threads) and works in three phases over shared
// memory, with a barrier between:
// A. each tile-plus-halo cell once: the buffer's state, or the ghost of a
//    wall cell beside the raster (_ghost :60-80: the Dirichlet values; the
//    reflecting mirror; the critical-outflow ghost ONLY, the interior
//    state left as it is; a ghost's tracer masses the prescribed rows of a
//    Dirichlet wall, else h_ghost * c_interior, _ghost_hc :104-113); then
//    its regularized velocity, sqrt(max(h, 0)) and concentrations;
// B. each of the tile's (TX + 1) TY x faces roe(west, east), normal +x,
//    and TX (TY + 1) y faces roe(south, north), normal +y, once, with
//    1/chat from rsqrt (roe_flux(fast=True)) and the face mask, into
//    shared memory (3 + NT flux rows and a);
// C. each tile cell:
//      div    = -((fE - fW) / dx + (fN - fS) / dy)
//      rhs    = div + sources (rain on the h row only)
//      stage: out = alpha*qA + beta*(q + dt*rhs)  (qA may be NULL)
//      rhs:   out = rhs
//    and, when prim != NULL, the primitives (h, u, v) of q. dt is read from
//    device memory.
// Each block writes the largest Courant coefficient amax/dx, amax/dy of its
// cells' faces (wall faces included) to cmax[block], row-major by tile;
// K1c folds max*dt into the interval maximum. Max is exact and order-free,
// and no sum uses atomics, so the result does not depend on the launch
// configuration.
//
// The tracer count NT is a template parameter (0..kMaxTracers, dispatched
// at launch), so the tracer arrays of a thread stay in registers. NT = 0 is
// the flow-only kernel with the pure-flow face mask (both sides below
// tiny_h: zero). The nt mode (structured_step.py :277-339, :601-641) reads
// the tracer masses, rows 3.. of q, beside the flow; each face's tracer
// flux comes from the same fast Roe eigensystem (Roe advected waves, or
// upwind-Roe), and every row of a face is kept where either side is wet
// (h > tiny_h, strict). The flow sources keep their semantics (wet at h >=
// tiny_h); the sediment classes get erosion minus deposition where h >
// tiny_h; the primitive rows of the tracers are their concentrations.
//
// Bound: device memory. Per cell it reads q (3 + NT planes), dz/dx, dz/dy
// and Manning's n, writes 3 + NT planes, and reads the rain plane, qA
// (3 + NT planes) and writes prim (3 + NT planes) when asked: flow only 9 to
// 16 f32 planes, 104 MB (euler) to 138 MB (with prim) on the 2,883,584-cell
// raster, at least 0.031 / 0.041 ms at the H100's 3.35 TB/s; with NT = 3
// and prim, 21 planes, 242 MB, 0.072 ms. The arithmetic the function needs
// is about 360 operations per cell flow-only (two Roe solves of ~140, each
// face once; one regularization and square root; the divergence, sources,
// stage and Courant maxima; a divide, square root or pow counted as one),
// 1.0 Gop per launch, 0.016 ms at 67 TFLOP/s f32, plus about 60 per tracer.
// Each divide, square root and pow takes several instructions. The earlier
// design (one thread per cell and its four faces) solved every interior
// face twice and prepared five cells per thread; the tile solves 2.09
// faces (32 x 16; 2.16 at 32 x 8) and prepares 1.19 cells (1.31) per cell.
// The Roe solves and the cell phase (its divides, pow and six stores) take
// most of the time, not the loads (tools/torch_k2_ablation.py times the
// kernel with phases taken out; PERF.md gives the times and the other
// designs tried); a taller tile amortizes the halo and the barriers.
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
// the interior cell's concentration
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

// The rows of a tile of 32 columns with NT tracer rows: a taller tile
// prepares fewer halo cells and solves fewer faces per cell, but with
// tracers it takes so much shared memory per block that fewer blocks fit
// an SM (tools/torch_k2_ablation.py times the other choice)
template <int NT>
constexpr int kTileRows = NT == 0 ? 16 : 8;

// The shared memory of a TX x TY tile, in floats, plane after plane:
//   cells: h, u, v, sqrt(max(h, 0)) and the NT concentrations of the
//     (TX + 2) x (TY + 2) tile-plus-halo cells, row-major (zero where no
//     face of the tile reads them: corners, beyond a ragged edge);
//   raw: h, hu, hv and the NT masses of the TX x TY tile cells;
//   fx: the 3 flux rows, a and the NT tracer fluxes of the (TX + 1) x TY
//     x faces (face k of a row is the west face of the tile's column k);
//   fy: the same of the TX x (TY + 1) y faces (face row k is the south face
//     of the tile's row k).
template <int TX, int TY, int NT>
struct Tile {
  static constexpr int kRowThreads = kRasterThreads / TX;  // blockDim.y
  static_assert(kRasterThreads % TX == 0 && TY % kRowThreads == 0,
                "a tile is rows of whole thread rows");
  static constexpr int kW = TX + 2, kHalo = (TX + 2) * (TY + 2);
  static constexpr int kCells = TX * TY;
  static constexpr int kFx = (TX + 1) * TY, kFy = TX * (TY + 1);
  // x faces padded to whole warps, so that a warp of phase B solves faces
  // of one direction
  static constexpr int kFxPad = (kFx + 31) / 32 * 32;
  static constexpr int kCellOff = 0;
  static constexpr int kRawOff = (4 + NT) * kHalo;
  static constexpr int kFxOff = kRawOff + (3 + NT) * kCells;
  static constexpr int kFyOff = kFxOff + (4 + NT) * kFx;
  static constexpr int kBytes = (kFyOff + (4 + NT) * kFy) * 4;
};

// The launch's arguments (see rdy_swe_raster_step_f32); the whole raster
// is the strip row0 = 0, rows = ny, halo_lo = 0, buf_rows = ny.
struct StepArgs {
  const float* q;
  const float* qA;
  const float* dzx;
  const float* dzy;
  const float* mann;
  const float* src;
  const float* dt;
  int bc_l, bc_r, bc_b, bc_t;
  const float* bv_l;
  const float* bv_r;
  const float* bv_b;
  const float* bv_t;
  int64_t nx, ny, row0, rows, halo_lo, buf_rows;
  float tiny_h, h_anuga, inv_dx, inv_dy;
  int rhs_mode;
  float alpha, beta;
  int num_sediment;
  rdy::SedimentParams<float> sp;
  float* out;
  float* prim;
  float* cmax;
};

// phase B: the face between tile-plus-halo cells l and r into the face
// planes F (n faces) at k
template <int TX, int TY, int NT, bool kUpwind>
__device__ __forceinline__ void solve_face(const float* __restrict__ P,
                                           int l, int r, float sn, float cn,
                                           float tiny_h, float* __restrict__ F,
                                           int n, int k) {
  using T = Tile<TX, TY, NT>;
  constexpr int H = T::kHalo;
  const Prep pl{P[l], P[H + l], P[2 * H + l], P[3 * H + l]};
  const Prep pr{P[r], P[H + r], P[2 * H + r], P[3 * H + r]};
  Tracers<NT> cl, cr, ft;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    cl.m[j] = P[(4 + j) * H + l];
    cr.m[j] = P[(4 + j) * H + r];
  }
  float f[3], a;
  face<NT, kUpwind>(pl, pr, cl, cr, sn, cn, tiny_h, f, a, ft);
  F[k] = f[0];
  F[n + k] = f[1];
  F[2 * n + k] = f[2];
  F[3 * n + k] = a;
#pragma unroll
  for (int j = 0; j < NT; ++j) F[(4 + j) * n + k] = ft.m[j];
}

// One block per tile, in three phases with a barrier between. No loop
// whose body does arithmetic is unrolled, and the strip arithmetic is
// runtime, so a cell or face goes through the same instructions wherever
// the tiles of a launch, or the strips of a raster, put it.
template <int TX, int TY, int NT, bool kUpwind>
__global__ void __launch_bounds__(kRasterThreads)
    swe_raster_step_kernel(const StepArgs p) {
  using T = Tile<TX, TY, NT>;
  constexpr int H = T::kHalo, W = T::kW, NC = T::kCells;
  extern __shared__ float smem[];
  float* __restrict__ P = smem + T::kCellOff;
  float* __restrict__ S = smem + T::kRawOff;
  float* __restrict__ FX = smem + T::kFxOff;
  float* __restrict__ FY = smem + T::kFyOff;
  const float* __restrict__ q = p.q;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int64_t nx = p.nx, ny = p.ny, rows = p.rows, hl = p.halo_lo;
  const int64_t nb = p.buf_rows, C = nx * nb;
  const int64_t i0 = blockIdx.x * (int64_t)TX, j0 = blockIdx.y * (int64_t)TY;
  const float tiny_h = p.tiny_h, h_anuga = p.h_anuga;

  // A: the tile-plus-halo cells. Cell k = (li, lj) = (k % W, k / W) is
  // column i = i0 + li - 1 and owned row j = j0 + lj - 1 (j = -1 and j =
  // rows: the buffer's rows below and above the owned ones, halo rows or
  // beyond the raster's walls), global row g = row0 + j: the buffer's cell
  // or a wall's ghost, then its regularized velocity, sqrt(max(h, 0)) and
  // concentrations, once.
#pragma unroll 1
  for (int k = tid; k < H; k += kRasterThreads) {
    const int li = k % W, lj = k / W;
    const int64_t i = i0 + li - 1, j = j0 + lj - 1, g = p.row0 + j;
    const bool col = i >= 0 && i < nx, row = j >= 0 && j < rows;
    Cell s{0.0f, 0.0f, 0.0f};
    Tracers<NT> m;
#pragma unroll
    for (int t = 0; t < NT; ++t) m.m[t] = 0.0f;
    if (col && j >= -1 && j <= rows && g >= 0 && g < ny) {
      const int64_t c = (j + hl) * nx + i;
      s = load_cell(q, C, c);
      m = load_hc<NT>(q, C, c);
      if (row && li >= 1 && li <= TX && lj >= 1 && lj <= TY) {
        // a tile cell's raw state, for the cell phase
        const int o = (lj - 1) * TX + (li - 1);
        S[o] = s.h;
        S[NC + o] = s.hu;
        S[2 * NC + o] = s.hv;
#pragma unroll
        for (int t = 0; t < NT; ++t) S[(3 + t) * NC + o] = m.m[t];
      }
    } else if ((col && ((j == -1 && g == -1) || (j == rows && g == ny))) ||
               (row && (i == -1 || i == nx))) {
      // a wall's ghost, from the wall cell beside it (by column below and
      // above, by buffer row left and right)
      const bool bottom = col && j == -1, top = col && j == rows;
      const bool left = !col && i == -1;
      const int64_t jw = bottom ? 0 : top ? rows - 1 : j;
      const int64_t iw = left ? 0 : !col ? nx - 1 : i;
      const int64_t c = (jw + hl) * nx + iw;
      const int bc = bottom ? p.bc_b : top ? p.bc_t : left ? p.bc_l : p.bc_r;
      const float* bv = bottom ? p.bv_b : top ? p.bv_t : left ? p.bv_l
                                                              : p.bv_r;
      const int64_t pos = col ? i : j + hl, n = col ? nx : nb;
      const Cell w = load_cell(q, C, c);
      s = wall_ghost(bc, w, bottom ? -1.0f : top ? 1.0f : 0.0f,
                     !col ? (left ? -1.0f : 1.0f) : 0.0f, bv, pos, n, tiny_h,
                     h_anuga);
      if constexpr (NT > 0)
        m = ghost_hc<NT>(bc, w.h, load_hc<NT>(q, C, c), s.h, bv, pos, n,
                         tiny_h);
    }
    const Prep pr = prep(s, tiny_h, h_anuga);
    P[k] = pr.h;
    P[H + k] = pr.u;
    P[2 * H + k] = pr.v;
    P[3 * H + k] = pr.sq;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      P[(4 + t) * H + k] = rdy::safe_div(m.m[t], s.h, s.h, tiny_h);
  }
  __syncthreads();

  // B: every face of the tile once; a warp takes faces of one direction
#pragma unroll 1
  for (int k = tid; k < T::kFxPad + T::kFy; k += kRasterThreads) {
    if (k < T::kFxPad) {
      if (k < T::kFx) {
        const int l = (k / (TX + 1) + 1) * W + k % (TX + 1);
        solve_face<TX, TY, NT, kUpwind>(P, l, l + 1, 0.0f, 1.0f, tiny_h, FX,
                                        T::kFx, k);
      }
    } else {
      const int f = k - T::kFxPad;
      const int l = (f / TX) * W + f % TX + 1;
      solve_face<TX, TY, NT, kUpwind>(P, l, l + W, 1.0f, 0.0f, tiny_h, FY,
                                      T::kFy, f);
    }
  }
  __syncthreads();

  // C: the cells, a thread row per TX cells
  float cm = 0.0f;
  const float dt = *p.dt;
  const float inv_dx = p.inv_dx, inv_dy = p.inv_dy;
  const int lx = threadIdx.x;
  const int64_t Co = nx * rows;
#pragma unroll 1
  for (int ly = threadIdx.y; ly < TY; ly += T::kRowThreads) {
    const int64_t i = i0 + lx, j = j0 + ly;
    if (i >= nx || j >= rows) continue;
    const int o = ly * TX + lx, h = (ly + 1) * W + lx + 1;
    const int fw = ly * (TX + 1) + lx, fs = ly * TX + lx;  // west, south
    const Cell s{S[o], S[NC + o], S[2 * NC + o]};
    const float aw = FX[3 * T::kFx + fw], ae = FX[3 * T::kFx + fw + 1];
    const float as = FY[3 * T::kFy + fs], an = FY[3 * T::kFy + fs + TX];
    cm = nanmax(cm, nanmax(nanmax(aw * inv_dx, ae * inv_dx),
                           nanmax(as * inv_dy, an * inv_dy)));
    float d[3];
#pragma unroll
    for (int w = 0; w < 3; ++w)
      d[w] = -((FX[w * T::kFx + fw + 1] - FX[w * T::kFx + fw]) * inv_dx +
               (FY[w * T::kFy + fs + TX] - FY[w * T::kFy + fs]) * inv_dy);

    // semi-implicit bed slope and Manning friction (_kernel :579-599);
    // the geometry, rain and primitive planes hold the owned rows alone
    const int64_t c = (j + hl) * nx + i;
    const int64_t co = j * nx + i;
    const rdy::FlowRhs fr = rdy::flow_rhs(s, d[0], d[1], d[2], p.dzx, p.dzy,
                                          p.mann, p.src, co, dt, tiny_h);
    rdy::store_flow(p.out, p.qA, C, c, p.rhs_mode, p.alpha, p.beta, s, dt,
                    fr);
    if (p.prim) {
      p.prim[co] = s.h;
      p.prim[Co + co] = P[H + h];
      p.prim[2 * Co + co] = P[2 * H + h];
    }
    if constexpr (NT > 0) {
      // tracer rows (_kernel :601-641): the divergence, Hairsine-Rose
      // erosion minus deposition on the sediment classes under the strict
      // wet test, and the primitive row, the concentration under it
      const rdy::SedimentParams<float> sp = p.sp;
      const bool wet_t = s.h > tiny_h;
      const float tau_b =
          0.5f * sp.rhow * fr.cd * (fr.uu * fr.uu + fr.vv * fr.vv);
      const float ero = sp.kp * (tau_b - sp.tau_ce) / sp.tau_ce;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float mc = S[(3 + t) * NC + o];
        const float ck = wet_t ? mc / (wet_t ? s.h : 1.0f) : 0.0f;
        const float* tx = FX + (4 + t) * T::kFx;
        const float* ty = FY + (4 + t) * T::kFy;
        float rhc = -((tx[fw + 1] - tx[fw]) * inv_dx +
                      (ty[fs + TX] - ty[fs]) * inv_dy);
        if (p.num_sediment) {
          const float dep = sp.ws * ck * (1.0f - tau_b / sp.tau_cd);
          float ed = wet_t ? ero - dep : 0.0f;
          if (p.num_sediment < NT) ed = ed * (t < p.num_sediment ? 1.0f : 0.0f);
          rhc = rhc + ed;
        }
        const int64_t r = (3 + t) * C + c;
        if (p.rhs_mode) {
          p.out[r] = rhc;
        } else {
          float o2 = p.beta * (mc + dt * rhc);
          if (p.qA) o2 = p.alpha * p.qA[r] + o2;
          p.out[r] = o2;
        }
        if (p.prim) p.prim[(3 + t) * Co + co] = ck;
      }
    }
  }

  rdy::store_block_max(cm, p.cmax);
}

template <int TX, int TY, int NT, bool kUpwind>
int launch_tile(const StepArgs& a, cudaStream_t stream) {
  using T = Tile<TX, TY, NT>;
  const auto kernel = swe_raster_step_kernel<TX, TY, NT, kUpwind>;
  if (T::kBytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
    if (err) return err;
  }
  const dim3 grid((unsigned)((a.nx + TX - 1) / TX),
                  (unsigned)((a.rows + TY - 1) / TY));
  kernel<<<grid, dim3(TX, T::kRowThreads), T::kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over the owned rows [row0, row0 + rows) of the [ny, nx]
// raster (strip_ok of raster_common.cuh, depth 1; the whole raster: 0, ny,
// 0, 0) in tiles of bx x by cells, 32 x kTileRows<nt> (the caller names
// the tile, by which it sizes cmax): cmax holds ceil(nx/bx) *
// ceil(rows/by) floats, row-major by tile. q, qA and out are strip
// buffers [ndof, (halo_lo + rows + halo_hi) * nx], of which out's owned
// rows are written; dzx, dzy, mann, src [rows, nx] and prim [ndof, rows *
// nx] hold the owned rows; the Dirichlet values bv_l, bv_r [ndof, halo_lo
// + rows + halo_hi] follow the buffer's rows, bv_b and bv_t [ndof, nx] are
// read only by a strip that holds that wall. A neighbour row beyond the
// strip is its halo row, the wall ghost only on the raster's bottom and
// top. rhs_mode != 0 writes the RHS to out, else the stage alpha*qA +
// beta*(q + dt*rhs). nt: tracer rows of q, qA, the Dirichlet walls'
// values, out and prim beyond (h, hu, hv), the first num_sediment of them
// sediment classes with the Hairsine-Rose parameters kp, ws, tau_ce,
// tau_cd, rhow; upwind != 0 takes upwind-Roe tracer fluxes. Returns
// cudaGetLastError().
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
  if (nx < 1 || rows < 1 || (rows + by - 1) / by > 65535 ||
      !rdy::strip_ok(ny, row0, rows, halo_lo, halo_hi, 1))
    return (int)cudaErrorInvalidValue;
  const StepArgs a{
      (const float*)q, (const float*)qA, (const float*)dzx,
      (const float*)dzy, (const float*)mann, (const float*)src,
      (const float*)dt, bc_l, bc_r, bc_b, bc_t, (const float*)bv_l,
      (const float*)bv_r, (const float*)bv_b, (const float*)bv_t, nx, ny,
      row0, rows, (int64_t)halo_lo, (int64_t)(halo_lo + rows + halo_hi),
      tiny_h, h_anuga, inv_dx, inv_dy, rhs_mode, alpha, beta, num_sediment,
      rdy::SedimentParams<float>{kp, ws, tau_ce, tau_cd, rhow}, (float*)out,
      (float*)prim, (float*)cmax};
  const cudaStream_t s = (cudaStream_t)stream;
  return rdy::dispatch_nt(nt, upwind != 0, [&](auto tag) {
    using Tag = decltype(tag);
    constexpr int ty = kTileRows<Tag::nt>;
    if (bx != 32 || by != ty) return (int)cudaErrorInvalidValue;
    return launch_tile<32, ty, Tag::nt, Tag::upwind>(a, s);
  });
}

// Dynamic shared memory of one block of the instance with nt tracer rows,
// in bytes.
extern "C" int rdy_swe_raster_step_smem(int nt) {
  return rdy::dispatch_nt(nt, false, [](auto tag) {
    using Tag = decltype(tag);
    return Tile<32, kTileRows<Tag::nt>, Tag::nt>::kBytes;
  });
}
