// Pointwise shallow-water physics shared by the edge and cell kernels.
//
// Each function repeats, operation for operation, the plain PyTorch
// version in rdycore_tpu_torch/ops/swe/ (riemann.py, boundary.py,
// sources.py) or ops/tracer/ (flux.py, sources.py), which in turn repeats
// rdycore_tpu/ops/swe/ or rdycore_tpu/ops/tracer/. nvcc contracts
// multiply-adds into FMAs and its pow/cbrt are not those of the host
// libraries, so results agree with the plain versions to rounding, not
// bitwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rdy {

constexpr double kGravity = 9.806;

// BC codes of ops/swe/boundary.py
constexpr int kDirichlet = 0;
constexpr int kReflecting = 1;
constexpr int kCriticalOutflow = 2;

// source methods of ops/swe/sources.py
constexpr int kSemiImplicit = 0;
constexpr int kXQ2018 = 1;
constexpr int kSourceNone = 2;

// MUSCL slope limiters (ops/swe/muscl.py LIMITERS); 0 is first order
constexpr int kLimMinmod = 1;
constexpr int kLimVanLeer = 2;
constexpr int kLimNone = 3;

// well-balancing modes of the edge kernel (ops/kernels/edge_flux.py WB_*)
constexpr int kWbNone = 0;
constexpr int kWbHR = 1;
constexpr int kWbBS2002 = 2;

// most tracers a state carries: MAX_NUM_SEDIMENT_CLASSES (5), salinity and
// heat. Each kernel is instantiated for every count 0..kMaxTracers, so the
// tracer arrays of a thread live in registers; count 0 is the flow-only
// kernel.
constexpr int kMaxTracers = 7;

template <int N, bool U>
struct NtTag {
  static constexpr int nt = N;
  static constexpr bool upwind = U;
};

// Calls f(NtTag<nt, upwind>{}) for a runtime tracer count and Riemann
// option (the upwind option only where nt > 0); cudaErrorInvalidValue for
// a count above kMaxTracers.
template <int N = 0, typename F>
int dispatch_nt(int nt, bool upwind, F&& f) {
  if constexpr (N > kMaxTracers) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nt != N) return dispatch_nt<N + 1>(nt, upwind, f);
    if constexpr (N == 0) {
      return f(NtTag<0, false>{});
    } else {
      return upwind ? f(NtTag<N, true>{}) : f(NtTag<N, false>{});
    }
  }
}

template <typename T>
__device__ __forceinline__ T clamp_min0(T x) {
  return x > T(0) ? x : T(0);
}

// a / b where cond > tiny, else 0; b == 0 divides by 1 (tracer/flux.py
// safe_div)
template <typename T>
__device__ __forceinline__ T safe_div(T a, T b, T cond, T tiny) {
  const T b_safe = fabs(b) > T(0) ? b : T(1);
  return cond > tiny ? a / b_safe : T(0);
}

// limited slope of a face extrapolation against half the jump across the
// face (muscl.py limit_slope): minmod, van Leer or none
template <typename T, int kLim>
__device__ __forceinline__ T limit_slope(T extrap, T half_dq) {
  if constexpr (kLim == kLimNone) {
    return extrap;
  } else {
    const T prod = extrap * half_dq;
    if constexpr (kLim == kLimVanLeer) {
      const T s = extrap + half_dq;
      const T s_safe = s != T(0) ? s : T(1);
      return prod > T(0) ? T(2) * prod / s_safe : T(0);
    } else {
      static_assert(kLim == kLimMinmod, "unknown limiter");
      return prod <= T(0) ? T(0)
                          : (fabs(extrap) < fabs(half_dq) ? extrap : half_dq);
    }
  }
}

// ANUGA velocity regularization u = hu*h/(h^2 + h_anuga^2), zero when dry
template <typename T>
__device__ __forceinline__ void regularized_velocity(T h, T hu, T hv,
                                                     T tiny_h, T h_anuga,
                                                     T& u, T& v) {
  const T denom = h * h + h_anuga * h_anuga;
  const T denom_safe = denom > T(0) ? denom : T(1);
  const T scale = h >= tiny_h ? h / denom_safe : T(0);
  u = hu * scale;
  v = hv * scale;
}

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// Roe flux with the critical-flow (entropy) fix (riemann.py roe_flux), given
// duml = sqrt(max(hl, 0)) and dumr = sqrt(max(hr, 0)). kFast takes 1/chat
// from rsqrt and chat = c2 * (1/chat), as roe_flux(fast=True) does. With
// NT > 0 it also writes the NT tracer fluxes ftr of the concentrations
// cil/cir on this eigensystem (roe_flux(cil=, cir=, upwind=)); nothing is
// masked here.
template <typename T, bool kFast, int NT = 0, bool kUpwind = false>
__device__ __forceinline__ void roe_flux_sqrt(T hl, T ul, T vl, T hr, T ur,
                                              T vr, T duml, T dumr, T sn,
                                              T cn, T f[3], T& amax,
                                              const T* cil = nullptr,
                                              const T* cir = nullptr,
                                              T* ftr = nullptr) {
  const T g = T(kGravity);
  const T sqrt_g = sqrt(g);
  const T half = T(0.5);

  const T hl_s = clamp_min0(hl);
  const T hr_s = clamp_min0(hr);
  const T cl = sqrt_g * duml;
  const T cr = sqrt_g * dumr;
  const T hhat = duml * dumr;
  const T denom = duml + dumr;
  const T inv_denom = T(1) / (denom > T(0) ? denom : T(1));
  const T uhat = (duml * ul + dumr * ur) * inv_denom;
  const T vhat = (duml * vl + dumr * vr) * inv_denom;
  const T c2 = half * g * (hl_s + hr_s);
  T chat, inv_chat;
  if constexpr (kFast) {
    inv_chat = rsqrt_(c2 > T(0) ? c2 : T(1));
    chat = c2 * inv_chat;
  } else {
    chat = sqrt(c2);
    inv_chat = T(1) / (chat > T(0) ? chat : T(1));
  }
  const T uperp = uhat * cn + vhat * sn;

  const T dh = hr - hl;
  const T du = ur - ul;
  const T dv = vr - vl;
  const T dupar = -du * sn + dv * cn;
  const T duperp = du * cn + dv * sn;

  const T uperpl = ul * cn + vl * sn;
  const T uperpr = ur * cn + vr * sn;
  T a1 = fabs(uperp - chat);
  const T a2 = fabs(uperp);
  T a3 = fabs(uperp + chat);

  const T da1 = clamp_min0(T(2) * ((uperpr - cr) - (uperpl - cl)));
  const T da1_safe = da1 > T(0) ? da1 : T(1);
  if (a1 < da1) a1 = half * (a1 * a1 / da1_safe + da1);
  const T da3 = clamp_min0(T(2) * ((uperpr + cr) - (uperpl + cl)));
  const T da3_safe = da3 > T(0) ? da3 : T(1);
  if (a3 < da3) a3 = half * (a3 * a3 / da3_safe + da3);

  const T hdup_c = hhat * duperp * inv_chat;
  const T dW0 = half * (dh - hdup_c);
  const T dW1 = hhat * dupar;
  const T dW2 = half * (dh + hdup_c);

  const T fl_h = uperpl * hl_s;
  const T fl_hu = ul * uperpl * hl_s + half * g * hl_s * hl_s * cn;
  const T fl_hv = vl * uperpl * hl_s + half * g * hl_s * hl_s * sn;
  const T fr_h = uperpr * hr_s;
  const T fr_hu = ur * uperpr * hr_s + half * g * hr_s * hr_s * cn;
  const T fr_hv = vr * uperpr * hr_s + half * g * hr_s * hr_s * sn;

  const T A0dW0 = a1 * dW0;
  const T A1dW1 = a2 * dW1;
  const T A2dW2 = a3 * dW2;

  f[0] = half * (fl_h + fr_h - A0dW0 - A2dW2);
  f[1] = half * (fl_hu + fr_hu - (uhat - chat * cn) * A0dW0 - (-sn) * A1dW1 -
                 (uhat + chat * cn) * A2dW2);
  f[2] = half * (fl_hv + fr_hv - (vhat - chat * sn) * A0dW0 - cn * A1dW1 -
                 (vhat + chat * sn) * A2dW2);
  amax = chat + fabs(uperp);
  if constexpr (NT > 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (kUpwind) {
        ftr[j] = f[0] * (f[0] >= T(0) ? cil[j] : cir[j]);
      } else {
        const T fl_c = hl_s * uperpl * cil[j];
        const T fr_c = hr_s * uperpr * cir[j];
        const T cihat = (duml * cil[j] + dumr * cir[j]) * inv_denom;
        const T dch = cir[j] * hr_s - cil[j] * hl_s;
        const T dW_c = dch - cihat * dh;
        ftr[j] = half * (fl_c + fr_c - cihat * (A0dW0 + A2dW2) - a2 * dW_c);
      }
    }
  }
}

// Roe flux with the critical-flow (entropy) fix (riemann.py roe_flux)
template <typename T>
__device__ __forceinline__ void roe_flux(T hl, T ul, T vl, T hr, T ur, T vr,
                                         T sn, T cn, T f[3], T& amax) {
  roe_flux_sqrt<T, false>(hl, ul, vl, hr, ur, vr, sqrt(clamp_min0(hl)),
                          sqrt(clamp_min0(hr)), sn, cn, f, amax);
}

// Ghost right state of a boundary edge by BC code (boundary.py
// ghost_states). Critical outflow into the domain dries both sides, so it
// may rewrite the left state too.
template <typename T>
__device__ __forceinline__ void ghost_state(int code, T& hl, T& ul, T& vl,
                                            T sn, T cn, T bh, T bhu, T bhv,
                                            T tiny_h, T h_anuga, T& hr,
                                            T& ur, T& vr) {
  if (code == kDirichlet) {
    hr = bh;
    regularized_velocity(bh, bhu, bhv, tiny_h, h_anuga, ur, vr);
  } else if (code == kCriticalOutflow) {
    const T g = T(kGravity);
    const T uperp = ul * cn + vl * sn;
    if (uperp >= T(0)) {
      const T qn = hl * fabs(uperp);
      const T h_crit = cbrt(qn * qn / g);
      const T vel = sqrt(g * h_crit);
      hr = h_crit;
      ur = vel * cn;
      vr = vel * sn;
    } else {
      hl = ul = vl = T(0);
      hr = ur = vr = T(0);
    }
  } else {  // reflecting
    const T dum1 = sn * sn - cn * cn;
    const T dum2 = T(2) * sn * cn;
    hr = hl;
    ur = ul * dum1 - vl * dum2;
    vr = -ul * dum2 - vl * dum1;
  }
}

// Source part of the momentum RHS rows (sources.py); div1/div2 are the flux
// divergence of the momentum rows. Returns s1 = -bedx - tbx + e1 and
// s2 = -bedy - tby + e2.
template <typename T>
__device__ __forceinline__ void momentum_sources(
    int method, T h, T hu, T hv, T div1, T div2, T e1, T e2, T mann, T dzdx,
    T dzdy, T dt, T tiny_h, T xq_threshold, T& s1, T& s2) {
  const T g = T(kGravity);
  const T bedx = dzdx * g * h;
  const T bedy = dzdy * g * h;
  const bool wet = h >= tiny_h;
  const T h_safe = wet ? h : T(1);
  T tbx = T(0), tby = T(0);
  if (method == kSemiImplicit) {
    const T u = hu / h_safe;
    const T v = hv / h_safe;
    const T cd = g * mann * mann * pow(h_safe, T(-1.0 / 3.0));
    const T speed = sqrt(u * u + v * v);
    const T tb = cd * speed / h_safe;
    const T factor = tb / (T(1) + dt * tb);
    if (wet) {
      tbx = (hu + dt * div1 - dt * bedx) * factor;
      tby = (hv + dt * div2 - dt * bedy) * factor;
    }
  } else if (method == kXQ2018) {
    const T mx = hu + (div1 - bedx) * dt;
    const T my = hv + (div2 - bedy) * dt;
    const T n2g = g * mann * mann;
    const T ux = mx / h_safe;
    const T uy = my / h_safe;
    const T lam = n2g * pow(h_safe, T(-4.0 / 3.0)) * sqrt(ux * ux + uy * uy);
    const T dtlam = dt * lam;
    const T dtlam_safe = dtlam > T(0) ? dtlam : T(1);
    T qx1 = mx, qy1 = my;
    if (!(dtlam < xq_threshold)) {
      const T root = sqrt(T(1) + T(4) * dtlam);
      qx1 = (mx - mx * root) / (T(-2) * dtlam_safe);
      qy1 = (my - my * root) / (T(-2) * dtlam_safe);
    }
    if (wet) {
      const T qmag = sqrt(qx1 * qx1 + qy1 * qy1);
      const T h73 = n2g * pow(h_safe, T(-7.0 / 3.0));
      tbx = h73 * qx1 * qmag;
      tby = h73 * qy1 * qmag;
    }
  }
  s1 = -bedx - tbx + e1;
  s2 = -bedy - tby + e2;
}

// Hairsine-Rose parameters (tracer/sources.py SedimentParams)
template <typename T>
struct SedimentParams {
  T kp, ws, tau_ce, tau_cd, rhow;
};

// Sources of the coupled flow + tracer system (tracer/sources.py
// tracer_source_terms): strict wet test h > tiny_h, u and v zero where dry,
// semi-implicit friction on (hu + dt*(div - bed)) unless !friction (source
// method none), and Hairsine-Rose erosion minus deposition on the first
// num_sediment tracers. hc: the NT tracer masses; e: the NT external
// tracer sources. Returns the momentum sources s1, s2 (as momentum_sources)
// and, per tracer, st[j] = ed_j + e[j] and its concentration ci[j].
template <typename T, int NT>
__device__ __forceinline__ void tracer_sources(
    bool friction, T h, T hu, T hv, const T* hc, T div1, T div2, T e1, T e2,
    const T* e, T mann, T dzdx, T dzdy, T dt, T tiny_h, int num_sediment,
    const SedimentParams<T>& sp, T& s1, T& s2, T* st, T* ci) {
  const T g = T(kGravity);
  const T bedx = dzdx * g * h;
  const T bedy = dzdy * g * h;
  const bool wet = h > tiny_h;
  const T h_safe = wet ? h : T(1);
  const T u = wet ? hu / h_safe : T(0);
  const T v = wet ? hv / h_safe : T(0);
  const T cd = g * mann * mann * pow(h_safe, T(-1.0 / 3.0));
  const T speed = sqrt(u * u + v * v);
  const T tb = cd * speed / h_safe;
  const T factor = tb / (T(1) + dt * tb);
  T tbx = T(0), tby = T(0);
  if (friction && wet) {
    tbx = (hu + dt * (div1 - bedx)) * factor;
    tby = (hv + dt * (div2 - bedy)) * factor;
  }
  s1 = -bedx - tbx + e1;
  s2 = -bedy - tby + e2;
  const T tau_b = T(0.5) * sp.rhow * cd * (u * u + v * v);
  const T ero = sp.kp * (tau_b - sp.tau_ce) / sp.tau_ce;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    ci[j] = wet ? hc[j] / h_safe : T(0);
    const T dep = sp.ws * ci[j] * (T(1) - tau_b / sp.tau_cd);
    T ed = wet ? ero - dep : T(0);
    if (num_sediment < NT) ed = ed * (j < num_sediment ? T(1) : T(0));
    st[j] = ed + e[j];
  }
}

// Hydrostatic reconstruction of the depth h of a cell with bed z against
// an edge whose higher bed is zmax: max(0, h + z - zmax), the XLA form of
// the JAX package's operator.py:424-427 (its TPU kernel forms h - dz).
template <typename T>
__device__ __forceinline__ T hr_depth(T h, T z, T zmax) {
  return clamp_min0(h + z - zmax);
}

template <typename T>
__device__ __forceinline__ T max_(T a, T b) {
  return a > b ? a : b;
}

// The hydrostatic pressure correction of one side of an edge
// (operator.py _hr_pressure_correction :1117-1151): 0.5*g*(h^2 - h*^2)
// with h* = hr_depth(h, z, max(z, z_nbr)), zero where both h and h_nbr
// are below tiny_h. The caller multiplies it by coef*(cn, sn).
template <typename T>
__device__ __forceinline__ T hr_pressure(T h, T z, T h_nbr, T z_nbr,
                                         T tiny_h) {
  const T h_rec = hr_depth(h, z, max_(z, z_nbr));
  const T corr = T(0.5) * T(kGravity) * (h * h - h_rec * h_rec);
  return (h < tiny_h && h_nbr < tiny_h) ? T(0) : corr;
}

// BS2002 partial-wetting free-surface elevation of a cell with sorted
// vertex beds z1 <= z2 <= z3 and depth h (ops/swe/bs2002.py eta_cells,
// swe_well_balancing.h:30-85): dry, all, one or two vertices submerged.
template <typename T>
__device__ __forceinline__ T eta_cell(T z1, T z2, T z3, T h, T tiny_h) {
  if (h <= tiny_h) return z1;
  const T mean = (z1 + z2 + z3) / T(3);
  const T h3 = z3 - mean;
  if (h >= h3) return mean + h;
  const T dz31 = z3 - z1;
  const T dz31_safe = dz31 != T(0) ? dz31 : T(1);
  const T h2 = z2 < z3 ? (z2 - z1) * (z2 - z1) / (T(3) * dz31_safe) : h3;
  if (h > T(0) && h <= h2)
    return z1 + cbrt(clamp_min0(T(3) * h * (z2 - z1) * dz31));
  const T b = z3 - T(3) * z1;
  const T c = z1 * z2 + z1 * z1 - z3 * z2 - T(3) * h * dz31;
  return T(0.5) * (-b + sqrt(clamp_min0(b * b - T(4) * c)));
}

// BS2002 momentum flux correction of an edge (bs2002.py dhv_correction,
// swe_roe_flux_ceed.h:117-119): with the vertex eta and bed at its begin
// and end vertex, dhv = max(eta_e - z_e, 0) - max(eta_b - z_b, 0), and
// f1, f2 gain g*dhv^2/24*(cn, sn), formed as the XLA path forms it.
template <typename T>
__device__ __forceinline__ void bs2002_correction(T eta_b, T eta_e, T z_b,
                                                  T z_e, T cn, T sn, T& f1,
                                                  T& f2) {
  const T dhv = clamp_min0(eta_e - z_e) - clamp_min0(eta_b - z_b);
  const T corr = T(kGravity) * dhv * dhv / T(24);
  f1 = f1 + corr * cn;
  f2 = f2 + corr * sn;
}

}  // namespace rdy
