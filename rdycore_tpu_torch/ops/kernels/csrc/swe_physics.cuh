// Pointwise shallow-water physics shared by the edge and cell kernels.
//
// Each function repeats, operation for operation, the plain PyTorch
// version in rdycore_tpu_torch/ops/swe/ (riemann.py, boundary.py,
// sources.py), which in turn repeats rdycore_tpu/ops/swe/. nvcc contracts
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

template <typename T>
__device__ __forceinline__ T clamp_min0(T x) {
  return x > T(0) ? x : T(0);
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
// from rsqrt and chat = c2 * (1/chat), as roe_flux(fast=True) does.
template <typename T, bool kFast>
__device__ __forceinline__ void roe_flux_sqrt(T hl, T ul, T vl, T hr, T ur,
                                              T vr, T duml, T dumr, T sn,
                                              T cn, T f[3], T& amax) {
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

}  // namespace rdy
