// The per-face and per-cell arithmetic of the periodic iso2d step (PLM with
// sign-bit half-slopes, HLLE or HLLC, the conservative update), shared by
// kernels B1 and B9 (the column march, iso2d_march.cuh) and kernels B8 and
// B10a-c (iso2d_ladder.cu).
//
// Each function copies the TPU kernels' own operation order
// (mara3_tpu/kernels/iso2d_step.py: _plm_half, _hlle_1d, _hllc_1d; the
// update of iso2d_step_v4._step_stripe; iso2d_step_li.py's _cs2_at, _hlle_li
// and positions), as the plain PyTorch versions in
// mara3_tpu_torch/kernels/iso2d_step.py and iso2d_step_li.py do. Built with
// --fmad=false, every kernel that calls them rounds each cell as every other
// does, so B1, B9 and B10a-c agree bit for bit on the cells they share.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cmath>

namespace iso2d {

template <typename T>
struct Params {
  T cs2, cs, dtdx, dtdy, half_theta;
};

// The scalars in T: cast first, cs = sqrt(cs2) correctly rounded in T, and
// 0.5 * theta formed in T, as the TPU kernels cast their scalar operands.
template <typename T>
Params<T> make_params(double cs2, double dtdx, double dtdy, double theta) {
  Params<T> p;
  p.cs2 = T(cs2);
  p.cs = std::sqrt(p.cs2);
  p.dtdx = T(dtdx);
  p.dtdy = T(dtdy);
  p.half_theta = T(0.5) * T(theta);
  return p;
}

// the sign bits of a, b and c agree: the sign bit of (a ^ b) | (b ^ c) is
// clear (one three-input logic operation and a test)
__device__ __forceinline__ bool same_sign(float a, float b, float c) {
  const int ia = __float_as_int(a), ib = __float_as_int(b),
            ic = __float_as_int(c);
  return ((ia ^ ib) | (ib ^ ic)) >= 0;
}

__device__ __forceinline__ bool same_sign(double a, double b, double c) {
  const long long ia = __double_as_longlong(a), ib = __double_as_longlong(b),
                  ic = __double_as_longlong(c);
  return ((ia ^ ib) | (ib ^ ic)) >= 0;
}

// 0.5 * the minmod slope: copysign(min |.|, a) when the three sign bits
// agree, else 0 (mara3_tpu/kernels/iso2d_step.py::_plm_half)
template <typename T>
__device__ __forceinline__ T plm_half(T yl, T y0, T yr, T half_theta) {
  const T a = (y0 - yl) * half_theta;
  const T b = (yr - yl) * T(0.25);
  const T c = (yr - y0) * half_theta;
  const T m = fmin(fmin(fabs(a), fabs(b)), fabs(c));
  return same_sign(a, b, c) ? copysign(m, a) : T(0);
}

// HLLE flux along the face normal from (density, normal velocity,
// transverse velocity) face states at the face's cs^2 and cs
// (iso2d_step.py::_hlle_1d; kernel B8 forms both per face,
// iso2d_step_li.py::_hlle_li)
template <typename T>
__device__ __forceinline__ void hlle(T sgl, T vnl, T vtl, T sgr, T vnr,
                                     T vtr, T cs2, T cs, T f[3]) {
  const T ap = fmax(fmax(vnl + cs, vnr + cs), T(0));
  const T am = fmin(fmin(vnl - cs, vnr - cs), T(0));
  const T ul1 = sgl * vnl, ul2 = sgl * vtl;
  const T ur1 = sgr * vnr, ur2 = sgr * vtr;
  const T pl = sgl * cs2, pr = sgr * cs2;
  const T fl0 = vnl * sgl, fl1 = vnl * ul1 + pl, fl2 = vnl * ul2;
  const T fr0 = vnr * sgr, fr1 = vnr * ur1 + pr, fr2 = vnr * ur2;
  const T den = T(1) / (ap - am);
  f[0] = (fl0 * ap - fr0 * am - (sgl - sgr) * ap * am) * den;
  f[1] = (fl1 * ap - fr1 * am - (ul1 - ur1) * ap * am) * den;
  f[2] = (fl2 * ap - fr2 * am - (ul2 - ur2) * ap * am) * den;
}

// HLLC flux, Toro 3rd ed. sec 10.6, isothermal (iso2d_step.py::_hllc_1d)
template <typename T>
__device__ __forceinline__ void hllc(T sgl, T vnl, T vtl, T sgr, T vnr,
                                     T vtr, T cs2, T cs, T f[3]) {
  const T pl = sgl * cs2, pr = sgr * cs2;
  const T ppvrs = T(0.5) * (pl + pr) - T(0.25) * (vnr - vnl) * (sgl + sgr) * cs;
  const T pstar = fmax(ppvrs, T(0));
  const T ql = fmax(sqrt(pstar / pl), T(1));
  const T qr = fmax(sqrt(pstar / pr), T(1));
  const T sl = vnl - cs * ql;
  const T sr = vnr + cs * qr;
  const T kl = sgl * (sl - vnl);
  const T kr = sgr * (sr - vnr);
  const T sstar = (pr - pl + vnl * kl - vnr * kr) / (kl - kr);
  const T ul1 = sgl * vnl, ul2 = sgl * vtl;
  const T ur1 = sgr * vnr, ur2 = sgr * vtr;
  const T fl0 = vnl * sgl, fl1 = vnl * ul1 + pl, fl2 = vnl * ul2;
  const T fr0 = vnr * sgr, fr1 = vnr * ur1 + pr, fr2 = vnr * ur2;
  if (sl >= T(0)) {
    f[0] = fl0; f[1] = fl1; f[2] = fl2;
  } else if (sstar >= T(0)) {
    const T dl = kl / (sl - sstar);
    f[0] = fl0 + sl * (dl - sgl);
    f[1] = fl1 + sl * (dl * sstar - ul1);
    f[2] = fl2 + sl * (dl * vtl - ul2);
  } else if (sr >= T(0)) {
    const T dr = kr / (sr - sstar);
    f[0] = fr0 + sr * (dr - sgr);
    f[1] = fr1 + sr * (dr * sstar - ur1);
    f[2] = fr2 + sr * (dr * vtr - ur2);
  } else {
    f[0] = fr0; f[1] = fr1; f[2] = fr2;
  }
}

template <typename T, bool HLLC>
__device__ __forceinline__ void riemann(T sgl, T vnl, T vtl, T sgr, T vnr,
                                        T vtr, T cs2, T cs, T f[3]) {
  if (HLLC) {
    hllc(sgl, vnl, vtl, sgr, vnr, vtr, cs2, cs, f);
  } else {
    hlle(sgl, vnl, vtl, sgr, vnr, vtr, cs2, cs, f);
  }
}

// The half-slopes gh of a cell's primitives (sigma, vx, vy) c from its
// neighbours lo and hi along one axis: face_flux's first step, which the
// column march (iso2d_march.cuh) takes once a cell and axis
template <typename T>
__device__ __forceinline__ void half_slopes(const T lo[3], const T c[3],
                                            const T hi[3], T half_theta,
                                            T gh[3]) {
  for (int q = 0; q < 3; ++q) gh[q] = plm_half(lo[q], c[q], hi[q], half_theta);
}

// The flux through the face between cells a and b along x (Y false) or y
// (Y true), from their primitives and half-slopes (ga, gb), at the face's
// cs^2 and cs: face_flux's second step. For a y face the normal velocity is
// vy, so the solver's normal-momentum flux is the y one.
template <typename T, bool HLLC, bool Y>
__device__ __forceinline__ void face_from_slopes(const T a[3], const T ga[3],
                                                 const T b[3], const T gb[3],
                                                 T cs2, T cs, T f[3]) {
  T L[3], R[3];
  for (int q = 0; q < 3; ++q) {
    L[q] = a[q] + ga[q];
    R[q] = b[q] - gb[q];
  }
  if (Y) {
    T g[3];
    riemann<T, HLLC>(L[0], L[2], L[1], R[0], R[2], R[1], cs2, cs, g);
    f[0] = g[0];
    f[1] = g[2];
    f[2] = g[1];
  } else {
    riemann<T, HLLC>(L[0], L[1], L[2], R[0], R[1], R[2], cs2, cs, f);
  }
}

// The flux through the face between cells a and b at the face's cs^2 and
// cs, from the primitives of the four cells m, a, b, pp in a row along the
// face normal: x (Y false) or y (Y true); the two steps above
template <typename T, bool HLLC, bool Y>
__device__ __forceinline__ void face_flux(const T m[3], const T a[3],
                                          const T b[3], const T pp[3],
                                          T half_theta, T cs2, T cs,
                                          T f[3]) {
  T ga[3], gb[3];
  half_slopes(m, a, b, half_theta, ga);
  half_slopes(a, b, pp, half_theta, gb);
  face_from_slopes<T, HLLC, Y>(a, ga, b, gb, cs2, cs, f);
}

// at the constant cs^2 and cs of p (kernels B1, B9, B10a-c)
template <typename T, bool HLLC, bool Y>
__device__ __forceinline__ void face_flux(const T m[3], const T a[3],
                                          const T b[3], const T pp[3],
                                          const Params<T>& p, T f[3]) {
  face_flux<T, HLLC, Y>(m, a, b, pp, p.half_theta, p.cs2, p.cs, f);
}

// A face's coordinate o + (i + d) dx, wrapped periodically into [lo, lo + L)
// as x - L floor((x - lo) / L) (iso2d_step_li.py:63-70)
template <typename T>
__device__ __forceinline__ T wrapped_coord(T o, int i, T d, T dx, T lo,
                                           T L) {
  const T x = o + (T(i) + d) * dx;
  return x - L * floor((x - lo) / L);
}

// The axisymmetric locally isothermal cs^2 = 1 / (M^2 sqrt(x^2 + y^2 +
// r_s^2)) (iso2d_step_li.py:30-32); sqrt and the division correctly rounded
template <typename T>
__device__ __forceinline__ T cs2_at(T x, T y, T mach2, T rsoft2) {
  return T(1) / (mach2 * sqrt(x * x + y * y + rsoft2));
}

// The forward-Euler update of one component of a cell from its x faces
// (left, right) and y faces (left, right)
template <typename T>
__device__ __forceinline__ T cell_update(T u, T fxl, T fxr, T fyl, T fyr,
                                         const Params<T>& p) {
  const T d = (fxr - fxl) * p.dtdx + (fyr - fyl) * p.dtdy;
  return u - d;
}

}  // namespace iso2d
