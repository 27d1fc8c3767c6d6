// SRHD primitive recovery for one cell: the Newton iteration on the
// pressure that kernels B5 (sedov_step.cu) and B4 (cloud_update.cu) run
// inside the kernel.
//
// Device twin of mara3_tpu_torch/kernels/srhd_recover.py (the plain
// version), itself the port of mara3_tpu/kernels/cloud_update.py:267-344
// (_recover_window) with `_rcp` (:35). It is the reciprocal-first spelling,
// with gamma = 4/3: three reciprocals and an rsqrt an update, 1/D hoisted,
// and the relative floor 8 eps (|tau| + D + |p|) on in every dtype. The TPU
// iterates all cells until every one is done or 50 updates have run; a cell
// stops changing once it is done, so a per-thread loop that stops at the
// cell's own convergence gives each cell the same result.
//
// Rounding: built with --fmad=false, every operation rounds as the plain
// version's torch op does; 1/x is the IEEE quotient (torch.reciprocal), and
// rsqrt is the CUDA math library's (2 ulps in float32), the function
// torch.rsqrt calls on the card. The NaN-propagating min and max copy
// torch.clamp's, and max_nan torch.maximum's.

#pragma once

#include <cfloat>
#include <math.h>

namespace srhd {

constexpr double kGamma = 4.0 / 3.0;
constexpr int kNewtonIterMax = 50;
constexpr double kErrorTolerance = 1e-10;

__device__ __forceinline__ float machine_eps(float) { return FLT_EPSILON; }
__device__ __forceinline__ double machine_eps(double) { return DBL_EPSILON; }

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// torch.clamp(x, max=hi) and torch.clamp(x, min=lo): a NaN x stays NaN
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) { return x > hi ? hi : x; }
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

// torch.maximum: a NaN in either operand wins
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? b : a));
}

// Primitives (rho, u1, u2, u3, p) of the conserved densities
// (D, S1, S2, S3, tau), from the pressure guess p0. With tfloor > 0 the
// pressure is floored at tfloor D / W before the primitives are formed
// (cloud_update.py:339-344); at tfloor == 0 that branch is skipped, as the
// TPU kernel's static `if tfloor > 0.0` skips it. *p_final is the final
// pressure before the floor (sedov's warm start; cloud carries the floored
// prim[4]); returns the count of Newton updates, at most kNewtonIterMax
// (the cell did not converge when it is kNewtonIterMax and *done is false).
template <typename T>
__device__ __forceinline__ int recover(T D, T S1, T S2, T S3, T tau, T p0,
                                       T tfloor, T prim[5], T* p_final,
                                       bool* done) {
  const T SS = S1 * S1 + S2 * S2 + S3 * S3;
  const T eps_rel = T(8) * machine_eps(T(0));
  const T f_floor = eps_rel * (fabs(tau) + D);
  const T invD = T(1) / D;
  T p = p0, Wc = T(1);
  bool is_done = false;
  int it = 0;
  for (; it < kNewtonIterMax && !is_done; ++it) {
    const T invdp = T(1) / (tau + D + p);
    const T v2 = clamp_max(SS * invdp * invdp, T(1.0 - 1e-10));
    const T W = rsqrt_(T(1) - v2);
    const T invW = (T(1) - v2) * W;
    const T W2 = W * W;
    const T e = (tau + D * (T(1) - W) + p * (T(1) - W2)) * (invD * invW);
    const T d = D * invW;
    const T invd = invD * W;
    const T h = T(1) + e + p * invd;
    const T f = d * e * T(kGamma - 1.0) - p;
    const T p_next = p - f * h * (T(1) / (v2 * T(kGamma) * p * invd - h));
    if (fabs(f) < T(kErrorTolerance) + f_floor + eps_rel * fabs(p)) {
      Wc = W;
      is_done = true;
    }
    p = p_next;
  }
  const T invW = T(1) / Wc;
  *p_final = p;
  if (tfloor > T(0)) p = max_nan(p, tfloor * D * invW);
  const T inv_denom = T(1) / (tau + D + p);
  prim[0] = D * invW;
  prim[1] = Wc * S1 * inv_denom;
  prim[2] = Wc * S2 * inv_denom;
  prim[3] = Wc * S3 * inv_denom;
  prim[4] = p;
  *done = is_done;
  return it;
}

}  // namespace srhd
