// K1b swe_cell_stage: per-cell flux divergence, sources and RK stage.
//
// Replaces the cell phase of the TPU kernel _fused_step_kernel
// (rdycore_tpu/ops/pallas/slotted.py :2551-2743, the tracer cell phase with
// Hairsine-Rose at :2611-2639 and :2700-2731), the divergence of
// _fused_kernel (:2125) and _cell_kernel (:1441, non-drain), for the flow
// equations and for the coupled flow + tracer system (ndof = 3 + NT).
//
// One thread per cell. It pulls its edge fluxes over cell_edges in slot
// order, div = sum_k coef[c,k] * flux[cell_edges[c,k], :] (no atomics, so
// the result does not depend on the launch configuration), adds the
// sources, and then
//   stage mode: q_out = alpha*qA + beta*(qB + dt*(div + src)), or qB when
//               dt <= 0 (a step past the interval end leaves the state),
//               plus the primitives of qB when prim != NULL;
//   rhs mode:   flux_div = div and rhs = div + src (and prim when asked).
// dt is read from device memory, so the step loop needs no host sync.
//
// The tracer count NT is a template parameter (0..kMaxTracers, dispatched
// at launch). NT = 0 is the flow-only kernel: the sources of the chosen
// method (semi-implicit, XQ2018 or none, ops/swe/sources.py) and the
// primitives (h, u, v) with the wet test h >= tiny_h. NT > 0 takes the
// coupled system's sources (ops/tracer/sources.py tracer_source_terms):
// wet is h > tiny_h, u and v are zero where dry, friction (dropped by the
// method none) groups dt*(div - bed), Hairsine-Rose erosion and deposition
// act on the first num_sediment tracers, and every tracer takes its
// external source; the primitives are (h, u, v, concentrations). XQ2018
// with tracers is refused by SWEOperator, so the kernel never sees it.
//
// Hydrostatic-reconstruction mode (kHR, a template parameter, at any NT)
// drops the bed-slope term of every source method and adds the pressure
// correction of the JAX package's _hr_pressure_correction
// (operator.py:1117-1151), the XLA code that follows every TPU divergence
// kernel on an HR deck, inside the same slot-order loop: per slot
// 0.5*g*(h^2 - h*^2)*coef*(cn, sn), h* = max(0, h + z - max(z, z_nbr)),
// zero where h and h_nbr are both < tiny_h, summed in slot order and added
// to the momentum rows of the divergence. The neighbour and normal of a
// slot come from its edge id: int_left + int_right - c and int_cn/int_sn
// on an interior edge, the cell itself and bnd_cn/bnd_sn on a boundary
// edge (whose reconstruction h + z - z the JAX package keeps too), the cell
// and 0 on the dummy. That reads each interior edge's two ids and normal
// (16 bytes in f32, about 70 MB at 4.33M edges, counted once) and cell_z,
// against 3 x [C, 4] per-slot tables (about 140 MB at 2.88M cells).
//
// Bound: device memory. Per cell in stage mode (4 edge slots) it reads 4
// int32 edge ids, 4 coefficients, ndof state values (2*ndof with qA),
// Manning's n, two bed slopes (and ndof external sources when given) and
// writes ndof values (2*ndof with prim), plus the gathered fluxes, each
// edge's 4*ndof bytes counted once. In f32 on the 2.88M-cell dam break
// with prim and no sources: about 104 bytes per cell flow-only, 300 MB, at
// least 0.090 ms at the H100's 3.35 TB/s; about 164 bytes per cell with
// NT = 3, 471 MB, 0.141 ms. What binds is the sectors of the flux
// gathers. The fluxes come from K1a (csrc/swe_edge_flux.cu) as records,
// flux[E + 1, ndof], each edge's ndof values side by side (record E the
// zero dummy), so a slot gathers ndof adjacent values: in f32 on average
// 1.25 32-byte sectors at ndof = 3 and 1.5 at ndof = 6. A row-major
// flux[ndof, E + 1] would cost a sector per row where neighbouring cells
// share no edges: a triangle's three slots 9 sectors (288 bytes) for 36
// useful bytes in a shuffled file order, about 870 MB of traffic a launch
// on the 2,884,416-triangle valley against its 283 MB bound. Records are
// not padded to 16 bytes for vector loads: that would add 4 bytes an edge
// to K1a's writes and K1b's reads on every path. Design: consecutive
// threads take consecutive cells, so the per-cell streams are coalesced;
// the [C, 4] index and coefficient rows are read as one 16-byte (f32) or
// 32-byte (f64) row per thread, and the flux gathers hit neighbouring
// records for neighbouring cells on a row-major raster or under RCM.
// Measured in an euler stage with the primitives on an NVIDIA H100 80GB
// HBM3 at 700 W, f32 (tools/torch_kernel_times.py --cases gathers, the
// kernel on a row-major flux timed in the same call): the valley in its
// Exodus file order 0.1591-0.1592 ms against 0.2506-0.2507 (bound
// 0.0844), under RCM 0.0929-0.0930 against 0.0933-0.0935, in the
// generator's order 0.1079 against 0.1083-0.1096, the 2048x1408 dam break
// 0.0967-0.0973 against 0.0982-0.0984 (bound 0.0895); the same outputs
// to the bit.
#include "swe_physics.cuh"

namespace {

// the edge arrays of hydrostatic-reconstruction mode (NULL otherwise)
template <typename T>
struct HrArrays {
  const int32_t* int_left;  // [Ei]
  const int32_t* int_right;
  const T* int_cn;
  const T* int_sn;
  const T* bnd_cn;          // [Eb]
  const T* bnd_sn;
  const T* cell_z;          // [C]
  int64_t Ei;
};

template <typename T, int NT, bool kHR>
__global__ void __launch_bounds__(256) swe_cell_stage_kernel(
    const T* __restrict__ flux, int64_t num_rec,
    const int32_t* __restrict__ cell_edges, const T* __restrict__ coef,
    int K, const T* __restrict__ q, const T* __restrict__ qA,
    const T* __restrict__ dt_ptr, const T* __restrict__ ext,
    const T* __restrict__ mann, const T* __restrict__ dzdx,
    const T* __restrict__ dzdy, int64_t C, T tiny_h, T h_anuga,
    T xq_threshold, int method, int num_sediment, rdy::SedimentParams<T> sp,
    T alpha, T beta, T* __restrict__ q_out, T* __restrict__ flux_div,
    T* __restrict__ rhs, T* __restrict__ prim, const HrArrays<T> hr) {
  constexpr int ND = 3 + NT;
  const int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (c >= C) return;
  T d[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) d[k] = T(0);
  // the HR pressure correction, and the depth and bed of the cell it reads
  T dc1 = T(0), dc2 = T(0), hc = T(0), z = T(0);
  if constexpr (kHR) {
    hc = q[c];
    z = hr.cell_z[c];
  }
  for (int k = 0; k < K; ++k) {
    const int64_t e = cell_edges[c * K + k];
    const T w = coef[c * K + k];
    // the slot's edge record: its ND fluxes side by side
    const T* __restrict__ rec = flux + e * ND;
#pragma unroll
    for (int r = 0; r < ND; ++r) d[r] += rec[r] * w;
    if constexpr (kHR) {
      T hn = hc, zn = z, cn = T(0), sn = T(0);
      if (e < hr.Ei) {
        const int64_t n = (int64_t)hr.int_left[e] + hr.int_right[e] - c;
        hn = q[n];
        zn = hr.cell_z[n];
        cn = hr.int_cn[e];
        sn = hr.int_sn[e];
      } else if (e < num_rec - 1) {
        cn = hr.bnd_cn[e - hr.Ei];
        sn = hr.bnd_sn[e - hr.Ei];
      }
      const T corr = rdy::hr_pressure(hc, z, hn, zn, tiny_h);
      dc1 += corr * cn * w;
      dc2 += corr * sn * w;
    }
  }
  if constexpr (kHR) {
    d[1] += dc1;
    d[2] += dc2;
  }
  const T dt = *dt_ptr;
  T s[ND];  // the state of the cell
#pragma unroll
  for (int r = 0; r < ND; ++r) s[r] = q[r * C + c];
  const T h = s[0], hu = s[1], hv = s[2];
  T e[ND];  // its external sources
#pragma unroll
  for (int r = 0; r < ND; ++r) e[r] = ext ? ext[r * C + c] : T(0);
  T r_[ND];  // rhs = div + sources
  T ci[NT > 0 ? NT : 1];
  T s1, s2;
  // hydrostatic reconstruction drops the bed-slope term
  const T sx = kHR ? T(0) : dzdx[c];
  const T sy = kHR ? T(0) : dzdy[c];
  if constexpr (NT == 0) {
    rdy::momentum_sources(method, h, hu, hv, d[1], d[2], e[1], e[2], mann[c],
                          sx, sy, dt, tiny_h, xq_threshold, s1, s2);
  } else {
    T st[NT];
    rdy::tracer_sources<T, NT>(method != rdy::kSourceNone, h, hu, hv, s + 3,
                               d[1], d[2], e[1], e[2], e + 3, mann[c], sx,
                               sy, dt, tiny_h, num_sediment, sp, s1, s2, st,
                               ci);
#pragma unroll
    for (int j = 0; j < NT; ++j) r_[3 + j] = d[3 + j] + st[j];
  }
  r_[0] = d[0] + e[0];
  r_[1] = d[1] + s1;
  r_[2] = d[2] + s2;
  if (q_out) {
#pragma unroll
    for (int r = 0; r < ND; ++r) {
      T o = s[r];
      if (dt > T(0)) {
        o = beta * (s[r] + dt * r_[r]);
        if (qA) o = alpha * qA[r * C + c] + o;
      }
      q_out[r * C + c] = o;
    }
  }
  if (flux_div) {
#pragma unroll
    for (int r = 0; r < ND; ++r) flux_div[r * C + c] = d[r];
  }
  if (rhs) {
#pragma unroll
    for (int r = 0; r < ND; ++r) rhs[r * C + c] = r_[r];
  }
  if (prim) {
    const T denom = h * h + h_anuga * h_anuga;
    const T denom_safe = denom > T(0) ? denom : T(1);
    // the flow-only primitives are wet at h >= tiny_h, the coupled
    // system's at h > tiny_h
    const bool wet = NT == 0 ? h >= tiny_h : h > tiny_h;
    prim[c] = h;
    prim[C + c] = wet ? hu * h / denom_safe : T(0);
    prim[2 * C + c] = wet ? hv * h / denom_safe : T(0);
#pragma unroll
    for (int j = 0; j < NT; ++j) prim[(3 + j) * C + c] = ci[j];
  }
}

template <typename T>
int launch(const void* flux, int64_t num_rec, const void* cell_edges,
           const void* coef, int K, const void* q, const void* qA,
           const void* dt, const void* ext, const void* mann,
           const void* dzdx, const void* dzdy, int64_t C, T tiny_h,
           T h_anuga, T xq_threshold, int method, int nt, int num_sediment,
           T kp, T ws, T tau_ce, T tau_cd, T rhow, T alpha, T beta,
           void* q_out, void* flux_div, void* rhs, void* prim, int hr_mode,
           const HrArrays<T>& hr, void* stream) {
  if (C == 0) return (int)cudaGetLastError();
  if (hr_mode && (!hr.int_left || !hr.int_right || !hr.int_cn ||
                  !hr.int_sn || !hr.bnd_cn || !hr.bnd_sn || !hr.cell_z))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (C + threads - 1) / threads;
  const rdy::SedimentParams<T> sp{kp, ws, tau_ce, tau_cd, rhow};
  auto run = [&](auto kernel) {
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)flux, num_rec, (const int32_t*)cell_edges, (const T*)coef,
        K, (const T*)q, (const T*)qA, (const T*)dt, (const T*)ext,
        (const T*)mann, (const T*)dzdx, (const T*)dzdy, C, tiny_h, h_anuga,
        xq_threshold, method, num_sediment, sp, alpha, beta, (T*)q_out,
        (T*)flux_div, (T*)rhs, (T*)prim, hr);
    return (int)cudaGetLastError();
  };
  return rdy::dispatch_nt(nt, false, [&](auto tag) {
    using Tag = decltype(tag);
    return hr_mode ? run(swe_cell_stage_kernel<T, Tag::nt, true>)
                   : run(swe_cell_stage_kernel<T, Tag::nt, false>);
  });
}

}  // namespace

// nt: tracer rows of flux, q, qA, ext and the outputs beyond (h, hu, hv);
// num_sediment of them are sediment classes with the Hairsine-Rose
// parameters kp, ws, tau_ce, tau_cd, rhow. hr != 0: hydrostatic-
// reconstruction mode on the interior edges' int_left, int_right, int_cn,
// int_sn [Ei], the boundary edges' bnd_cn, bnd_sn [Eb] and cell_z [C]
// (else those may be NULL; num_rec = Ei + Eb + 1). Returns
// cudaGetLastError().
#define RDY_CELL_STAGE_API(SUFFIX, T)                                        \
  extern "C" int rdy_swe_cell_stage_##SUFFIX(                                \
      const void* flux, int64_t num_rec, const void* cell_edges,             \
      const void* coef, int K, const void* q, const void* qA,                \
      const void* dt, const void* ext, const void* mann, const void* dzdx,   \
      const void* dzdy, int64_t C, T tiny_h, T h_anuga, T xq_threshold,      \
      int method, int nt, int num_sediment, T kp, T ws, T tau_ce, T tau_cd,  \
      T rhow, T alpha, T beta, void* q_out, void* flux_div, void* rhs,       \
      void* prim, int hr, const void* int_left, const void* int_right,       \
      const void* int_cn, const void* int_sn, int64_t Ei,                    \
      const void* bnd_cn, const void* bnd_sn, const void* cell_z,            \
      void* stream) {                                                        \
    const HrArrays<T> arrays{(const int32_t*)int_left,                       \
                             (const int32_t*)int_right, (const T*)int_cn,    \
                             (const T*)int_sn, (const T*)bnd_cn,             \
                             (const T*)bnd_sn, (const T*)cell_z, Ei};        \
    return launch<T>(flux, num_rec, cell_edges, coef, K, q, qA, dt, ext,     \
                     mann, dzdx, dzdy, C, tiny_h, h_anuga, xq_threshold,     \
                     method, nt, num_sediment, kp, ws, tau_ce, tau_cd, rhow, \
                     alpha, beta, q_out, flux_div, rhs, prim, hr, arrays,    \
                     stream);                                                \
  }

RDY_CELL_STAGE_API(f32, float)
RDY_CELL_STAGE_API(f64, double)
