// K1a swe_edge_flux: the Roe flux of every edge of the unstructured mesh.
//
// Replaces the edge phase of the TPU kernels _fused_step_kernel and
// _fused_kernel (rdycore_tpu/ops/pallas/slotted.py _edge_phase_tiles :1909,
// _tile_edge_fluxes :1106) and _edge_kernel (:1254), for the flow
// equations and for the coupled flow + tracer system (ndof = 3 + NT, the
// tracer ghosts of :1196-1245), with their hydrostatic-reconstruction and
// BS2002 branches (:1180-1184, :1220-1246; :1919, :1966).
//
// One thread per edge over all E = Ei + Eb edges (interior first, then
// boundary edges in segment order). A thread gathers its left/right cell
// states, regularizes the velocities, forms the ghost state of a boundary
// edge from its BC code, solves Roe, applies the dry mask and writes
//   flux[ndof, E + 1]  (column E = 0, the dummy slot of cell_edges)
//   courant[E]         amax * edge_courant_coef
// flux[:, Ei:E] is the raw boundary flux the time-series accumulators use.
//
// The tracer count NT is a template parameter (0..kMaxTracers, dispatched
// at launch), so each thread's concentrations and fluxes stay in registers;
// NT = 0 is the flow-only kernel: roe_flux and the both-dry mask (hl <
// tiny_h and hr < tiny_h). With NT > 0 the thread follows the coupled
// system of operator.py (the JAX package's _apply_tracer/_finish_tracer):
// concentrations safe_div(hc, h, h, tiny_h); a Dirichlet ghost takes the
// prescribed tracer masses, reflecting and critical-outflow ghosts keep the
// interior concentration (critical outflow into the domain dries both
// sides, as in the flow case); roe_flux_sqrt with the NT tracer waves
// (Roe, or upwind-Roe with kUpwind); and the either-wet mask (hl > tiny_h or hr > tiny_h) on every
// row and on amax.
//
// MUSCL mode (flow only; kLim = kLimMinmod, kLimVanLeer or kLimNone, a
// template parameter; 0 is first order) replaces the TPU kernels
// _muscl_flux_kernel (slotted.py:3180) and, with K3a's
// gradients, _muscl_pre_kernel (:2946): an interior edge reconstructs
// q_c + limit(grad_c . d_c, +-dq/2) on both sides from the gradients
// grad[6, C] and the centroid -> midpoint offsets d (int_dxl/dyl/dxr/dyr),
// clamps h >= 0 and solves Roe with the both-dry mask on the reconstructed
// depths; boundary edges stay first order on the raw state. The extra
// streams are 4 offsets per interior edge and 6 gradient values per cell
// (about 404 MB in f32 at 2,883,584 cells, at least 0.12 ms).
//
// Well-balancing mode kWb (a template parameter; kWbNone is the kernel
// above, unchanged):
// - kWbHR, first order at any NT: an interior edge reconstructs its depths
//   max(0, h + z - max(zl, zr)) from the cells' bed `cell_z` (velocities
//   and concentrations from the raw states) and solves Roe on them; the
//   flow-only mask zeroes the edge where both raw depths are < tiny_h or
//   both reconstructed depths are <= tiny_h, the tracer mask keeps it where
//   a raw and a reconstructed depth are > tiny_h (operator.py:449-456,
//   :752-772). Boundary edges are not reconstructed, as in the JAX
//   package. The beds are gathered per cell rather than read as per-edge
//   drops built at setup: C values (11.5 MB in f32 at 2.88M cells,
//   counted once) against 2*Ei (34.6 MB at 4.33M interior edges);
// - kWbBS2002, flow only, first order or MUSCL: every edge reads its two
//   endpoint vertex ids and beds and the vertex eta of K5 at both, and adds
//   g*dhv^2/24*(cn, sn) to its momentum fluxes after Roe and before the
//   dry mask (operator.py:436-460, :1060-1074). In MUSCL mode the mask
//   sees the reconstructed depths and eta comes from the raw h. This also
//   replaces the TPU's two routes of eta_v to the edge endpoints
//   (rdycore_tpu/ops/swe/bs2002.py eta_slotted): the card gathers. The
//   extra streams are two int32 ids and two beds per edge and the eta
//   gathers, about 75 MB in f32 at 4.33M edges.
//
// Bound: device memory. Per interior edge it streams two int32 indices, two
// normals and one Courant coefficient in, and ndof fluxes + 1 Courant value
// out (36 bytes in f32 flow-only, 48 with NT = 3), plus the gathered
// states, each cell's 4*ndof bytes counted once: for the 5.77M edges of the
// 2048x1408 dam break about 242 MB (flow only, at least 0.072 ms at the
// H100's 3.35 TB/s) or 346 MB (NT = 3, 0.103 ms). The arithmetic (~165
// operations, 3 sqrt and a few divides, plus ~20 per tracer) is far below
// the card's rate at that intensity. Design: consecutive threads take
// consecutive edges, so every per-edge stream is read and written
// coalesced; the cell-state gathers are coalesced as far as the mesh
// numbering keeps neighbouring edges on neighbouring cells (row-major
// rasters do). No shared memory, no atomics.
#include "swe_physics.cuh"

namespace {

// the arrays of the well-balancing modes (NULL where a mode needs none)
template <typename T>
struct WbArrays {
  const T* cell_z;             // [C] HR: cell beds
  const T* eta_v;              // [NV] BS2002: vertex eta of K5
  const int32_t* vbeg[2];      // BS2002: begin vertex, interior / boundary
  const int32_t* vend[2];      //         end vertex
  const T* zvbeg[2];           //         bed at the begin vertex
  const T* zvend[2];           //         bed at the end vertex
};

template <typename T, int NT, bool kUpwind, int kLim, int kWb>
__global__ void __launch_bounds__(256) swe_edge_flux_kernel(
    const T* __restrict__ q, int64_t C, const int32_t* __restrict__ int_left,
    const int32_t* __restrict__ int_right, const T* __restrict__ int_cn,
    const T* __restrict__ int_sn, int64_t Ei,
    const int32_t* __restrict__ bnd_left, const T* __restrict__ bnd_cn,
    const T* __restrict__ bnd_sn, const int8_t* __restrict__ bnd_code,
    const T* __restrict__ bvals, int64_t bvals_ld, int64_t Eb,
    const T* __restrict__ ccoef, T tiny_h, T h_anuga, T* __restrict__ flux,
    T* __restrict__ courant, const T* __restrict__ grad,
    const T* __restrict__ dxl, const T* __restrict__ dyl,
    const T* __restrict__ dxr, const T* __restrict__ dyr,
    const WbArrays<T> wb) {
  static_assert(kLim == 0 || NT == 0, "MUSCL faces are flow only");
  static_assert(kWb != rdy::kWbHR || kLim == 0,
                "hydrostatic reconstruction is first order");
  static_assert(kWb != rdy::kWbBS2002 || NT == 0, "BS2002 is flow only");
  constexpr int ND = 3 + NT;
  const int64_t E = Ei + Eb;
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e > E) return;
  const int64_t ld = E + 1;
  if (e == E) {
#pragma unroll
    for (int k = 0; k < ND; ++k) flux[k * ld + e] = T(0);
    return;
  }
  T hl, ul, vl, hr, ur, vr, sn, cn;
  // the depths before hydrostatic reconstruction (for the masks)
  T hl_raw, hr_raw;
  // tracer concentrations of the left and right states
  T cil[NT > 0 ? NT : 1], cir[NT > 0 ? NT : 1];
  if (e < Ei) {
    const int64_t l = int_left[e];
    const int64_t r = int_right[e];
    T ql[3] = {q[l], q[C + l], q[2 * C + l]};
    T qr[3] = {q[r], q[C + r], q[2 * C + r]};
    if constexpr (kLim != 0) {
      // limited second-order face states (muscl.py
      // reconstruct_interior_states), h clamped >= 0
      const T xl = dxl[e], yl = dyl[e], xr = dxr[e], yr = dyr[e];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T dq = qr[k] - ql[k];
        const T el = grad[k * C + l] * xl + grad[(3 + k) * C + l] * yl;
        const T er = grad[k * C + r] * xr + grad[(3 + k) * C + r] * yr;
        ql[k] = ql[k] + rdy::limit_slope<T, kLim>(el, T(0.5) * dq);
        qr[k] = qr[k] + rdy::limit_slope<T, kLim>(er, T(-0.5) * dq);
      }
      ql[0] = rdy::clamp_min0(ql[0]);
      qr[0] = rdy::clamp_min0(qr[0]);
    }
    hl = ql[0];
    hr = qr[0];
    rdy::regularized_velocity(hl, ql[1], ql[2], tiny_h, h_anuga, ul, vl);
    rdy::regularized_velocity(hr, qr[1], qr[2], tiny_h, h_anuga, ur, vr);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      cil[j] = rdy::safe_div(q[(3 + j) * C + l], hl, hl, tiny_h);
      cir[j] = rdy::safe_div(q[(3 + j) * C + r], hr, hr, tiny_h);
    }
    sn = int_sn[e];
    cn = int_cn[e];
    hl_raw = hl;
    hr_raw = hr;
    if constexpr (kWb == rdy::kWbHR) {
      const T zl = wb.cell_z[l];
      const T zr = wb.cell_z[r];
      const T zmax = rdy::max_(zl, zr);
      hl = rdy::hr_depth(hl, zl, zmax);
      hr = rdy::hr_depth(hr, zr, zmax);
    }
  } else {
    const int64_t b = e - Ei;
    const int64_t l = bnd_left[b];
    hl = q[l];
    rdy::regularized_velocity(hl, q[C + l], q[2 * C + l], tiny_h, h_anuga,
                              ul, vl);
    // the interior concentration, before a critical-outflow ghost may dry
    // the left state
#pragma unroll
    for (int j = 0; j < NT; ++j)
      cil[j] = rdy::safe_div(q[(3 + j) * C + l], hl, hl, tiny_h);
    sn = bnd_sn[b];
    cn = bnd_cn[b];
    const int code = bnd_code[b];
    rdy::ghost_state<T>(code, hl, ul, vl, sn, cn, bvals[b],
                        bvals[bvals_ld + b], bvals[2 * bvals_ld + b], tiny_h,
                        h_anuga, hr, ur, vr);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      cir[j] = code == rdy::kDirichlet
                   ? rdy::safe_div(bvals[(3 + j) * bvals_ld + b], hr, hr,
                                   tiny_h)
                   : cil[j];
    hl_raw = hl;
    hr_raw = hr;
  }
  // the inner guard of hydrostatic reconstruction, on interior edges
  const bool rec = kWb == rdy::kWbHR && e < Ei;
  if constexpr (NT == 0) {
    T f[3], amax;
    rdy::roe_flux(hl, ul, vl, hr, ur, vr, sn, cn, f, amax);
    if constexpr (kWb == rdy::kWbBS2002) {
      const int side = e < Ei ? 0 : 1;
      const int64_t i = e < Ei ? e : e - Ei;
      rdy::bs2002_correction(wb.eta_v[wb.vbeg[side][i]],
                             wb.eta_v[wb.vend[side][i]], wb.zvbeg[side][i],
                             wb.zvend[side][i], cn, sn, f[1], f[2]);
    }
    const bool dry = (hl_raw < tiny_h && hr_raw < tiny_h) ||
                     (rec && hl <= tiny_h && hr <= tiny_h);
    const T mask = dry ? T(0) : T(1);
    flux[e] = f[0] * mask;
    flux[ld + e] = f[1] * mask;
    flux[2 * ld + e] = f[2] * mask;
    courant[e] = amax * mask * ccoef[e];
  } else {
    T f[ND], amax;
    rdy::roe_flux_sqrt<T, false, NT, kUpwind>(
        hl, ul, vl, hr, ur, vr, sqrt(rdy::clamp_min0(hl)),
        sqrt(rdy::clamp_min0(hr)), sn, cn, f, amax, cil, cir, f + 3);
    const bool wet = (hl_raw > tiny_h || hr_raw > tiny_h) &&
                     (!rec || hl > tiny_h || hr > tiny_h);
    const T mask = wet ? T(1) : T(0);
#pragma unroll
    for (int k = 0; k < ND; ++k) flux[k * ld + e] = f[k] * mask;
    courant[e] = amax * mask * ccoef[e];
  }
}

template <typename T>
int launch(const void* q, int64_t C, const void* int_left,
           const void* int_right, const void* int_cn, const void* int_sn,
           int64_t Ei, const void* bnd_left, const void* bnd_cn,
           const void* bnd_sn, const void* bnd_code, const void* bvals,
           int64_t bvals_ld, int64_t Eb, const void* ccoef, T tiny_h,
           T h_anuga, void* flux, void* courant, int nt, int upwind,
           const void* grad, const void* dxl, const void* dyl,
           const void* dxr, const void* dyr, int limiter, int wb_mode,
           const WbArrays<T>& wb, void* stream) {
  const int64_t n = Ei + Eb + 1;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  auto run = [&](auto kernel) {
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)q, C, (const int32_t*)int_left, (const int32_t*)int_right,
        (const T*)int_cn, (const T*)int_sn, Ei, (const int32_t*)bnd_left,
        (const T*)bnd_cn, (const T*)bnd_sn, (const int8_t*)bnd_code,
        (const T*)bvals, bvals_ld, Eb, (const T*)ccoef, tiny_h, h_anuga,
        (T*)flux, (T*)courant, (const T*)grad, (const T*)dxl, (const T*)dyl,
        (const T*)dxr, (const T*)dyr, wb);
    return (int)cudaGetLastError();
  };
  if (wb_mode == rdy::kWbHR && (wb.cell_z == nullptr || limiter != 0))
    return (int)cudaErrorInvalidValue;
  if (wb_mode == rdy::kWbBS2002) {
    if (nt != 0 || wb.eta_v == nullptr) return (int)cudaErrorInvalidValue;
    for (int side = 0; side < 2; ++side)
      if (!wb.vbeg[side] || !wb.vend[side] || !wb.zvbeg[side] ||
          !wb.zvend[side])
        return (int)cudaErrorInvalidValue;
  } else if (wb_mode != rdy::kWbNone && wb_mode != rdy::kWbHR) {
    return (int)cudaErrorInvalidValue;
  }
  const bool bs = wb_mode == rdy::kWbBS2002;
  if (limiter != 0) {
    if (nt != 0 || grad == nullptr) return (int)cudaErrorInvalidValue;
    switch (limiter) {
      case rdy::kLimMinmod:
        return bs ? run(swe_edge_flux_kernel<T, 0, false, rdy::kLimMinmod,
                                             rdy::kWbBS2002>)
                  : run(swe_edge_flux_kernel<T, 0, false, rdy::kLimMinmod,
                                             rdy::kWbNone>);
      case rdy::kLimVanLeer:
        return bs ? run(swe_edge_flux_kernel<T, 0, false, rdy::kLimVanLeer,
                                             rdy::kWbBS2002>)
                  : run(swe_edge_flux_kernel<T, 0, false, rdy::kLimVanLeer,
                                             rdy::kWbNone>);
      case rdy::kLimNone:
        return bs ? run(swe_edge_flux_kernel<T, 0, false, rdy::kLimNone,
                                             rdy::kWbBS2002>)
                  : run(swe_edge_flux_kernel<T, 0, false, rdy::kLimNone,
                                             rdy::kWbNone>);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (bs) return run(swe_edge_flux_kernel<T, 0, false, 0, rdy::kWbBS2002>);
  return rdy::dispatch_nt(nt, upwind != 0, [&](auto tag) {
    using Tag = decltype(tag);
    return wb_mode == rdy::kWbHR
               ? run(swe_edge_flux_kernel<T, Tag::nt, Tag::upwind, 0,
                                          rdy::kWbHR>)
               : run(swe_edge_flux_kernel<T, Tag::nt, Tag::upwind, 0,
                                          rdy::kWbNone>);
  });
}

}  // namespace

// nt: tracer rows of q, bvals and flux beyond (h, hu, hv); upwind != 0
// takes upwind-Roe tracer fluxes. limiter != 0 (kLim* of swe_physics.cuh,
// nt = 0 only) takes MUSCL faces from grad [6, C] and the interior edges'
// offsets dxl, dyl, dxr, dyr [Ei] (else those may be NULL). wb (kWb* of
// swe_physics.cuh): kWbHR reconstructs the interior depths on cell_z [C]
// (limiter 0); kWbBS2002 (nt 0) corrects every edge from eta_v [NV] and
// the endpoint ids and beds int_vbeg, int_vend, int_zvbeg, int_zvend [Ei]
// and bnd_vbeg, bnd_vend, bnd_zvbeg, bnd_zvend [Eb]; arrays a mode does
// not read may be NULL. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a combination without an instance.
#define RDY_EDGE_FLUX_API(SUFFIX, T)                                         \
  extern "C" int rdy_swe_edge_flux_##SUFFIX(                                 \
      const void* q, int64_t C, const void* int_left, const void* int_right, \
      const void* int_cn, const void* int_sn, int64_t Ei,                    \
      const void* bnd_left, const void* bnd_cn, const void* bnd_sn,          \
      const void* bnd_code, const void* bvals, int64_t bvals_ld, int64_t Eb, \
      const void* ccoef, T tiny_h, T h_anuga, void* flux, void* courant,     \
      int nt, int upwind, const void* grad, const void* dxl,                 \
      const void* dyl, const void* dxr, const void* dyr, int limiter,        \
      int wb, const void* cell_z, const void* eta_v, const void* int_vbeg,   \
      const void* int_vend, const void* int_zvbeg, const void* int_zvend,    \
      const void* bnd_vbeg, const void* bnd_vend, const void* bnd_zvbeg,     \
      const void* bnd_zvend, void* stream) {                                 \
    const WbArrays<T> arrays{                                                \
        (const T*)cell_z,                                                    \
        (const T*)eta_v,                                                     \
        {(const int32_t*)int_vbeg, (const int32_t*)bnd_vbeg},                \
        {(const int32_t*)int_vend, (const int32_t*)bnd_vend},                \
        {(const T*)int_zvbeg, (const T*)bnd_zvbeg},                          \
        {(const T*)int_zvend, (const T*)bnd_zvend}};                         \
    return launch<T>(q, C, int_left, int_right, int_cn, int_sn, Ei,          \
                     bnd_left, bnd_cn, bnd_sn, bnd_code, bvals, bvals_ld, Eb, \
                     ccoef, tiny_h, h_anuga, flux, courant, nt, upwind,      \
                     grad, dxl, dyl, dxr, dyr, limiter, wb, arrays, stream); \
  }

RDY_EDGE_FLUX_API(f32, float)
RDY_EDGE_FLUX_API(f64, double)
