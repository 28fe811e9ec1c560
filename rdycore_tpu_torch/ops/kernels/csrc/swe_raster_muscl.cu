// K2 MUSCL swe_raster_muscl_step: one second-order step (or RK stage, or
// RHS) of the shallow water equations on a uniform [ny, nx] raster, flow
// only, float32, in one launch.
//
// Replaces the second_order mode of the TPU kernel _kernel of
// rdycore_tpu/ops/pallas/structured_step.py (:341-559), as called by
// make_fused_structured_stepper(second_order=True) (:659): masked LS
// gradients, limited face reconstruction (minmod, van Leer or none; a
// template parameter), h >= 0 clamp, Roe, the both-dry mask on the
// reconstructed depths, first-order wall faces on the inline ghost, the
// Audusse positivity pass, then the divergence, sources and stage update
// of K2, and the Courant maximum per tile.
//
// Stencil. An owned cell's update needs its four faces and the donor
// factors of itself and of its four neighbours. A donor factor needs all
// four faces of its cell (its drain), so the tile needs every face of the
// ring of cells around it; a MUSCL face needs the normal gradients of its
// two cells, and a gradient reads one cell further. So a tile reads three
// cells beyond its edges along each axis (MUSCL_HALO = 3, raster_muscl.py),
// two and one towards its corners, and nothing beyond.
//
// Design: a block owns a tile of TX x TY = 32 x 16 cells (256 threads) and
// works in four phases over shared memory, with a barrier between each:
// A. each cell of the stencil once, in a box of TX + 6 by TY + 6 cells
//    less its corners: the strip buffer's state, or the ghost of a wall
//    cell beside the raster (_ghost :60-80: the Dirichlet values; the
//    reflecting mirror; the critical-outflow ghost), else zero;
// B. every face the tile needs, once, into shared memory (the h, hu and hv
//    fluxes): the x faces of the tile's rows from the west face of the
//    column west of the tile to the east face of the column east of it
//    (TX + 3 a row) and the tile's own x faces in the rows below and above
//    it (TX + 1 each); the y faces likewise. A face forms the normal
//    gradients of its two cells, g = cE*(qE - q) + cW*(q - qW) with cE, cW
//    = 1/(2d) where both neighbours are on the raster, 1/d where only one
//    is, 0 beyond a wall (:366-410), their extrapolations g * hd (hd =
//    0.5 / (1/d) in float32; -g * hd on the face's upper side), the
//    limited states, h clamped >= 0, the regularized velocities, Roe with
//    1/chat from rsqrt (roe_flux(fast=True)) and the both-dry mask; a
//    wall face takes zero extrapolations on the inline ghost. Each thread
//    keeps the largest amax/dx, amax/dy of the faces the tile's cells own
//    (east and north, and the west or south wall face where the cell has
//    one), taken before the positivity scaling as in the TPU kernel;
// C. the donor factor s = clip(h / (dt_s * drain), 0, 1) (1 where drain =
//    0; dt_s = dt, or 1 where dt <= 0: :495-533) of the tile's cells and
//    of the ring around them;
// D. each tile cell: each face scaled by its donor's s (this cell where
//    the flux leaves it, else the neighbour across the face; a ghost donor
//    keeps s = 1: :548-559), the divergence, the semi-implicit sources of
//    the raw state, the rain plane, the stage or rhs output and the
//    primitives, as K2.
// The tile maximum of B goes to cmax[tile], row-major by tile (K1c folds
// it). Max is exact and order-free, and no sum uses atomics.
//
// Determinism. Two neighbouring tiles both solve the faces along and just
// beyond their shared edge, and both form the donor factors of the cells
// there: tile A's factor for a cell of tile B's must be tile B's own, bit
// for bit. Every face (x and y alike) and every donor factor therefore
// has one call site, in a runtime loop over the tile's entries that is
// never unrolled (no separate code for the interior and the ring, which
// nvcc could contract into FMAs differently), and every test of a
// neighbour (the gradients' one-sidedness, the wall faces, the donors'
// presence) takes the global row and column.
//
// Strip mode: one launch per row strip replaces the same kernel run per
// shard by make_sharded_fused_structured_stepper(second_order=True)
// (:1019, pallas_call :1211). The strip buffer carries 3 halo rows where
// its bottom or top is not the raster's wall (the TPU stepper's HR = 3,
// :1144-1148), exactly what a tile's stencil reaches; only the raster's
// walls take ghosts. The strip arithmetic is runtime (the whole raster is
// the strip at row 0 with no halo rows), so strips reproduce the single
// launch bit for bit.
//
// Bound: device memory. The function reads q (3 planes), dz/dx, dz/dy and
// Manning's n, writes out (3 planes) and prim (3 planes): an euler stage
// with the primitives moves 12 f32 planes, 138 MB on the 2,883,584-cell
// raster, at least 0.0413 ms at the H100's 3.35 TB/s; qA adds 3 planes
// (0.0517 ms), the rain plane one, a strip its halo rows. The arithmetic,
// about 500 operations a cell (two MUSCL faces of about 190: six limited
// slopes, two regularizations and square roots, Roe; two gradients; the
// donor factor; the divergence, sources and stage), is 1.4 Gop, 0.022 ms
// at 67 TFLOP/s. The tile solves 2.48 faces a cell (2.80 at 32 x 8)
// against the 2 that each face once needs, and the face planes of the
// former two-launch design (faces, then update) no longer make a round
// trip through device memory. What binds is the instruction stream of the
// faces and of the cell phase, not the bytes (tools/torch_k2_ablation.py
// --muscl times the kernel with phases taken out, in the 32 x 8 tile, and
// with the gradients formed once per tile in a phase of their own, which
// is slower than each face forming its cells' gradients; PERF.md gives
// the times). The arithmetic is IEEE float32, as the plain version's.
#include "raster_common.cuh"

namespace {

using rdy::Cell;
using rdy::kRasterThreads;
using rdy::load_cell;
using rdy::nanmax;
using rdy::wall_ghost;

// the tile, in cells along x and y
constexpr int kTileX = 32, kTileY = 16;

// The shared memory of a TX x TY tile, in floats, plane after plane; a
// tile-relative column li and row lj (0 .. TX - 1, 0 .. TY - 1 inside the
// tile) index each array as below:
//   box: h, hu, hv of the stencil, li -3 .. TX + 2, lj -3 .. TY + 2;
//   f: the h, hu and hv fluxes of the x faces, face fi the west face of
//     column fi, -1 .. TX + 1, rows lj -1 .. TY; then of the y faces, face
//     fj the south face of row fj, -1 .. TY + 1, columns li -1 .. TX;
//   sd: the donor factors, li -1 .. TX, lj -1 .. TY.
template <int TX, int TY>
struct MusclTile {
  static constexpr int kRowThreads = kRasterThreads / TX;  // blockDim.y
  static_assert(kRasterThreads % TX == 0 && TY % kRowThreads == 0,
                "a tile is rows of whole thread rows");
  static constexpr int kBW = TX + 6, kBox = kBW * (TY + 6);
  static constexpr int kFXW = TX + 3, kFX = kFXW * (TY + 2);
  static constexpr int kFYW = TX + 2, kFY = kFYW * (TY + 3);
  static constexpr int kF = kFX + kFY;
  static constexpr int kSW = TX + 2, kS = kSW * (TY + 2);
  // the faces phase B solves: the x faces of the tile's rows (TX + 3 a
  // row) and of the rows below and above it (TX + 1 each), then the y
  // faces of the tile's columns and of the columns beside it
  static constexpr int kXTile = TY * (TX + 3), kX = kXTile + 2 * (TX + 1);
  static constexpr int kYTile = TX * (TY + 3), kY = kYTile + 2 * (TY + 1);
  static constexpr int kBoxOff = 0;
  static constexpr int kFOff = kBoxOff + 3 * kBox;
  static constexpr int kSOff = kFOff + 3 * kF;
  static constexpr int kBytes = (kSOff + kS) * 4;

  __device__ static int box(int li, int lj) { return (lj + 3) * kBW + li + 3; }
  __device__ static int fx(int fi, int lj) { return (lj + 1) * kFXW + fi + 1; }
  __device__ static int fy(int li, int fj) {
    return kFX + (fj + 1) * kFYW + li + 1;
  }
  __device__ static int sd(int li, int lj) { return (lj + 1) * kSW + li + 1; }
};

// The launch's arguments (see rdy_swe_raster_muscl_step_f32); the whole
// raster is the strip row0 = 0, rows = ny, halo_lo = 0, buf_rows = ny.
struct MusclArgs {
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
  float tiny_h, h_anuga, inv_dx, inv_dy, hdx, hdy;
  int rhs_mode;
  float alpha, beta;
  float* out;
  float* prim;
  float* cmax;
};

// phase B: the masked Roe flux of the face between box cells l and r = l +
// d (d = 1 across an x face, the box's width across a y face) with normal
// (sn, cn), their neighbours l - d and r + d. The extrapolations e = g *
// hd of both cells come from the normal gradients g = cE*(qE - q) +
// cW*(q - qW), cE, cW = 1/(2d) where both neighbours are on the raster,
// 1/d where only one is (has_lo: l's lower neighbour; has_hi: r's upper
// one; each cell's neighbour across the face always is); a wall face takes
// zero extrapolations. The fluxes go to F (planes of nf floats) at k; the
// wave speed is returned.
template <int kLim>
__device__ __forceinline__ float muscl_face(
    const float* __restrict__ B, int nb, int l, int d, bool has_lo,
    bool has_hi, bool wall, float inv_d, float hd, float sn, float cn,
    float tiny_h, float h_anuga, float* __restrict__ F, int nf, int k) {
  const float half_inv = 0.5f * inv_d;
  // l's weights (its upper neighbour r is on the raster) and r's
  const float cl_hi = has_lo ? half_inv : inv_d;
  const float cl_lo = has_lo ? half_inv : 0.0f;
  const float cr_hi = has_hi ? half_inv : 0.0f;
  const float cr_lo = has_hi ? half_inv : inv_d;
  const int r = l + d;
  float fl[3], fr[3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const float* Bw = B + w * nb;
    const float ql = Bw[l], qr = Bw[r];
    const float dq = qr - ql;
    // every product rounded as the plain version rounds it (no FMA): a
    // gradient's two terms, and a thin cell's state ql + xl, can cancel
    const float gl = __fmul_rn(cl_hi, dq) + __fmul_rn(cl_lo, ql - Bw[l - d]);
    const float gr = __fmul_rn(cr_hi, Bw[r + d] - qr) + __fmul_rn(cr_lo, dq);
    const float xl = wall ? 0.0f : __fmul_rn(gl, hd);
    const float xr = wall ? 0.0f : -__fmul_rn(gr, hd);
    fl[w] = ql + rdy::limit_slope<float, kLim>(xl, 0.5f * dq);
    fr[w] = qr + rdy::limit_slope<float, kLim>(xr, -0.5f * dq);
  }
  const float hl = rdy::clamp_min0(fl[0]);
  const float hr = rdy::clamp_min0(fr[0]);
  float ul, vl, ur, vr, f[3], a;
  rdy::regularized_velocity(hl, fl[1], fl[2], tiny_h, h_anuga, ul, vl);
  rdy::regularized_velocity(hr, fr[1], fr[2], tiny_h, h_anuga, ur, vr);
  rdy::roe_flux_sqrt<float, true>(hl, ul, vl, hr, ur, vr, sqrtf(hl),
                                  sqrtf(hr), sn, cn, f, a);
  const float m = (hl < tiny_h && hr < tiny_h) ? 0.0f : 1.0f;
  F[k] = f[0] * m;
  F[nf + k] = f[1] * m;
  F[2 * nf + k] = f[2] * m;
  return a * m;
}

__device__ __forceinline__ float relu(float x) { return x > 0.0f ? x : 0.0f; }

// phase C: the donor factor of a cell of depth h whose faces carry the
// h-fluxes fe, fw, fn, fs: its drain is their outgoing rate
__device__ __forceinline__ float donor_factor(float h, float fe, float fw,
                                              float fn, float fs, float inv_dx,
                                              float inv_dy, float dt_s) {
  const float drain =
      (relu(fe) + relu(-fw)) * inv_dx + (relu(fn) + relu(-fs)) * inv_dy;
  if (!(drain > 0.0f)) return 1.0f;
  const float sc = h / (dt_s * drain);
  return sc < 0.0f ? 0.0f : (sc > 1.0f ? 1.0f : sc);
}

// One block per tile, in four phases with a barrier between each; the
// loops over a phase's entries stay rolled (#pragma unroll 1). The launch
// bounds hold the registers to 48 a thread, so that five blocks fit an SM
// (four at the 51-52 that ptxas takes unbounded; 4% faster on the H100).
template <int TX, int TY, int kLim>
__global__ void __launch_bounds__(kRasterThreads, 5)
    swe_raster_muscl_step_kernel(const MusclArgs p) {
  using T = MusclTile<TX, TY>;
  constexpr int NB = T::kBox, NF = T::kF, NS = T::kS;
  extern __shared__ float smem[];
  float* __restrict__ B = smem + T::kBoxOff;
  float* __restrict__ F = smem + T::kFOff;
  float* __restrict__ SD = smem + T::kSOff;
  const float* __restrict__ q = p.q;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // rows and columns in int (the launch takes rasters below 2^30 a side),
  // offsets into the planes in int64
  const int nx = (int)p.nx, ny = (int)p.ny, rows = (int)p.rows;
  const int hl = (int)p.halo_lo, nb = (int)p.buf_rows, row0 = (int)p.row0;
  const int64_t C = p.nx * p.buf_rows;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int g0 = row0 + j0;  // the tile's first row on the raster
  const float tiny_h = p.tiny_h, h_anuga = p.h_anuga;
  const float inv_dx = p.inv_dx, inv_dy = p.inv_dy;

  // A: the stencil. Box cell k = (li, lj) is column i = i0 + li and owned
  // row j = j0 + lj (j < 0 and j >= rows: the buffer's halo rows, or
  // beyond the raster's walls), global row g = row0 + j: the buffer's cell
  // or a wall's ghost; zero where no face reads it.
#pragma unroll 1
  for (int k = tid; k < NB; k += kRasterThreads) {
    const int li = k % T::kBW - 3, lj = k / T::kBW - 3;
    const int ox = li < 0 ? -li : (li >= TX ? li - TX + 1 : 0);
    const int oy = lj < 0 ? -lj : (lj >= TY ? lj - TY + 1 : 0);
    const int omin = ox < oy ? ox : oy, omax = ox < oy ? oy : ox;
    const int i = i0 + li, j = j0 + lj, g = row0 + j;
    const bool col = i >= 0 && i < nx;
    const bool buf = j >= -hl && j < nb - hl && g >= 0 && g < ny;
    Cell s{0.0f, 0.0f, 0.0f};
    if ((omin == 0 && omax <= 3) || (omin == 1 && omax <= 2)) {
      if (col && buf) {
        s = load_cell(q, C, (int64_t)(j + hl) * nx + i);
      } else if ((col && ((j == -1 && g == -1) || (j == rows && g == ny))) ||
                 (buf && (i == -1 || i == nx))) {
        // a wall's ghost, from the wall cell beside it (by column below and
        // above, by buffer row left and right)
        const bool bottom = col && j == -1, top = col && j == rows;
        const bool left = !col && i == -1;
        const int jw = bottom ? 0 : top ? rows - 1 : j;
        const int iw = left ? 0 : !col ? nx - 1 : i;
        const int bc = bottom ? p.bc_b : top ? p.bc_t : left ? p.bc_l
                                                             : p.bc_r;
        const float* bv = bottom ? p.bv_b : top ? p.bv_t : left ? p.bv_l
                                                                : p.bv_r;
        const int pos = col ? i : j + hl, n = col ? nx : nb;
        s = wall_ghost(bc, load_cell(q, C, (int64_t)(jw + hl) * nx + iw),
                       bottom ? -1.0f : top ? 1.0f : 0.0f,
                       !col ? (left ? -1.0f : 1.0f) : 0.0f, bv, pos, n,
                       tiny_h, h_anuga);
      }
    }
    B[k] = s.h;
    B[NB + k] = s.hu;
    B[2 * NB + k] = s.hv;
  }
  __syncthreads();

  // B: the faces, x then y, each through the one call site of muscl_face,
  // and the Courant maximum of the faces the tile's cells own. Face k lies
  // at `along` (fi or fj) on the line `across` (lj or li) of its axis; pos
  // is the global column or row of its lower cell.
  const float hdx = p.hdx, hdy = p.hdy;
  float cm = 0.0f;
#pragma unroll 1
  for (int k = tid; k < T::kX + T::kY; k += kRasterThreads) {
    const bool x = k < T::kX;
    const int e = x ? k : k - T::kX;
    const int la = x ? TX : TY, lc = x ? TY : TX;  // along, across extents
    const int ntile = x ? T::kXTile : T::kYTile;
    const int e2 = e - ntile;  // a face of the lines beside the tile
    // the tile's own lines: TX + 3 (TY + 3) faces each
    const int line = x ? e / (TX + 3) : e / (TY + 3);
    const int across = e < ntile ? line : (e2 <= la ? -1 : lc);
    const int along = e < ntile ? e - line * (la + 3) - 1
                                : (e2 <= la ? e2 : e2 - (la + 1));
    const int o_along = x ? i0 : j0, o_across = x ? j0 : i0;
    const int m_along = x ? nx : rows, m_across = x ? rows : nx;
    const int pos = (x ? i0 : g0) + along - 1;
    const int n_axis = x ? nx : ny;
    const int li = x ? along - 1 : across, lj = x ? across : along - 1;
    const float a = muscl_face<kLim>(
        B, NB, T::box(li, lj), x ? 1 : T::kBW, pos > 0, pos + 2 < n_axis,
        pos == -1 || pos + 1 == n_axis, x ? inv_dx : inv_dy, x ? hdx : hdy,
        x ? 0.0f : 1.0f, x ? 1.0f : 0.0f, tiny_h, h_anuga, F, NF,
        x ? T::fx(along, across) : T::fy(across, along));
    // the east (north) face of an owned cell, or the west (south) wall
    // face of the raster's first column (row)
    if (across >= 0 && across < lc && o_across + across < m_across &&
        ((along >= 1 && along <= la && o_along + along <= m_along) ||
         pos == -1))
      cm = nanmax(cm, a * (x ? inv_dx : inv_dy));
  }
  __syncthreads();

  // C: the donor factors of the tile's cells and the ring around them
  const float dt = *p.dt;
  const float dt_s = dt > 0.0f ? dt : 1.0f;
#pragma unroll 1
  for (int k = tid; k < NS; k += kRasterThreads) {
    const int li = k % T::kSW - 1, lj = k / T::kSW - 1;
    if ((li < 0 || li >= TX) && (lj < 0 || lj >= TY)) continue;
    SD[k] = donor_factor(B[T::box(li, lj)], F[T::fx(li + 1, lj)],
                         F[T::fx(li, lj)], F[T::fy(li, lj + 1)],
                         F[T::fy(li, lj)], inv_dx, inv_dy, dt_s);
  }
  __syncthreads();

  // D: the cells, a thread row per TX cells
  const int lx = threadIdx.x;
  const int64_t Co = p.nx * p.rows;
#pragma unroll 1
  for (int ly = threadIdx.y; ly < TY; ly += T::kRowThreads) {
    const int i = i0 + lx, j = j0 + ly, g = g0 + ly;
    if (i >= nx || j >= rows) continue;
    const int ie = T::fx(lx + 1, ly), iw = T::fx(lx, ly);
    const int in = T::fy(lx, ly + 1), is = T::fy(lx, ly);
    const float sc = SD[T::sd(lx, ly)];
    // each face's donor: this cell where the flux leaves it, else the
    // neighbour across it (a ghost beyond a wall keeps s = 1)
    const float se = F[ie] > 0.0f ? sc
                     : i + 1 < nx  ? SD[T::sd(lx + 1, ly)]
                                   : 1.0f;
    const float sw = !(F[iw] > 0.0f) ? sc
                     : i > 0         ? SD[T::sd(lx - 1, ly)]
                                     : 1.0f;
    const float sn = F[in] > 0.0f ? sc
                     : g + 1 < ny  ? SD[T::sd(lx, ly + 1)]
                                   : 1.0f;
    const float ss = !(F[is] > 0.0f) ? sc
                     : g > 0         ? SD[T::sd(lx, ly - 1)]
                                     : 1.0f;
    float d[3];
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const float* Fw = F + w * NF;
      const float fe = Fw[ie] * se, fw = Fw[iw] * sw;
      const float fn = Fw[in] * sn, fs = Fw[is] * ss;
      d[w] = -((fe - fw) * inv_dx + (fn - fs) * inv_dy);
    }
    const int b = T::box(lx, ly);
    const Cell s{B[b], B[NB + b], B[2 * NB + b]};
    // the geometry, rain and primitive planes hold the owned rows alone
    const int64_t c = (int64_t)(j + hl) * nx + i, co = (int64_t)j * nx + i;
    const rdy::FlowRhs fr = rdy::flow_rhs(s, d[0], d[1], d[2], p.dzx, p.dzy,
                                          p.mann, p.src, co, dt, tiny_h);
    rdy::store_flow(p.out, p.qA, C, c, p.rhs_mode, p.alpha, p.beta, s, dt,
                    fr);
    if (p.prim) {
      float u, v;
      rdy::regularized_velocity(s.h, s.hu, s.hv, tiny_h, h_anuga, u, v);
      p.prim[co] = s.h;
      p.prim[Co + co] = u;
      p.prim[2 * Co + co] = v;
    }
  }

  rdy::store_block_max(cm, p.cmax);
}

template <int kLim>
int launch(const MusclArgs& a, cudaStream_t stream) {
  constexpr int TX = kTileX, TY = kTileY;
  using T = MusclTile<TX, TY>;
  const auto kernel = swe_raster_muscl_step_kernel<TX, TY, kLim>;
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
// raster (strip_ok of raster_common.cuh, depth 3; the whole raster: 0, ny,
// 0, 0) in tiles of 32 x 16 cells: cmax holds ceil(nx/32) * ceil(rows/16)
// floats, row-major by tile. q, qA and out are strip buffers [3, (halo_lo
// + rows + halo_hi) * nx], of which out's owned rows are written; dzx,
// dzy, mann, src [rows, nx] and prim [3, rows * nx] hold the owned rows;
// the Dirichlet values bv_l, bv_r [3, halo_lo + rows + halo_hi] follow the
// buffer's rows, bv_b and bv_t [3, nx] are read only by a strip that holds
// that wall. hdx = 0.5 / inv_dx and hdy (float32) are the centre-to-face
// distances. rhs_mode != 0 writes the RHS to out, else the stage alpha*qA
// + beta*(q + dt*rhs) (qA may be NULL); prim and src may be NULL. limiter =
// kLimMinmod, kLimVanLeer or kLimNone. Returns cudaGetLastError().
extern "C" int rdy_swe_raster_muscl_step_f32(
    const void* q, const void* qA, const void* dzx, const void* dzy,
    const void* mann, const void* src, const void* dt, int bc_l, int bc_r,
    int bc_b, int bc_t, const void* bv_l, const void* bv_r, const void* bv_b,
    const void* bv_t, int64_t nx, int64_t ny, int64_t row0, int64_t rows,
    int halo_lo, int halo_hi, float tiny_h, float h_anuga, float inv_dx,
    float inv_dy, float hdx, float hdy, int rhs_mode, float alpha,
    float beta, int limiter, void* out, void* prim, void* cmax,
    void* stream) {
  if (nx < 1 || rows < 1 || (rows + kTileY - 1) / kTileY > 65535 ||
      nx > (1 << 30) || ny > (1 << 30) ||
      !rdy::strip_ok(ny, row0, rows, halo_lo, halo_hi, 3))
    return (int)cudaErrorInvalidValue;
  const MusclArgs a{
      (const float*)q, (const float*)qA, (const float*)dzx,
      (const float*)dzy, (const float*)mann, (const float*)src,
      (const float*)dt, bc_l, bc_r, bc_b, bc_t, (const float*)bv_l,
      (const float*)bv_r, (const float*)bv_b, (const float*)bv_t, nx, ny,
      row0, rows, (int64_t)halo_lo, (int64_t)(halo_lo + rows + halo_hi),
      tiny_h, h_anuga, inv_dx, inv_dy, hdx, hdy, rhs_mode, alpha, beta,
      (float*)out, (float*)prim, (float*)cmax};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (limiter) {
    case rdy::kLimMinmod:
      return launch<rdy::kLimMinmod>(a, s);
    case rdy::kLimVanLeer:
      return launch<rdy::kLimVanLeer>(a, s);
    case rdy::kLimNone:
      return launch<rdy::kLimNone>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block, in bytes.
extern "C" int rdy_swe_raster_muscl_step_smem() {
  return MusclTile<kTileX, kTileY>::kBytes;
}
