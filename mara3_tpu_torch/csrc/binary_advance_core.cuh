// The per-cell and per-face device code of the flagship advance, shared by
// kernel B2 (binary_advance.cu: one advance per launch) and kernel B3
// (binary_multi.cu: K whole steps per launch); kernels B11b and B11c
// (binary_update.cu, binary_advance_strips.cu) share its slopes, per-cell
// update (update_cell) and totals.
//
// It computes what make_advance(fused=False) computes in
// mara3_tpu/schemes/binary_scheme.py, in the callers' component-last
// [B, bs, bs, 3] layout: the guard cells from the neighbors (same, coarse
// or fine), PLM(theta) slopes, locally-isothermal HLLE/HLLC plus viscous
// stress through every face, the angular-momentum flux transform, the
// coarse-fine flux correction, the flux divergence with the gravity/sink/
// buffer/floor (and geometric) sources, the accounting totals, and the
// accretion work done on each body (binary_scheme.work_done).
//
// Arithmetic follows the plain PyTorch version operation for operation. The
// files that include this header are built with --fmad=false, so every
// product is rounded as the plain version rounds it.
//
// No pointer here is __restrict__ or read through the read-only cache: in
// kernel B3 the same arrays are written and read again within one launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mara {

constexpr int kThreads = 256;
// totals: slot 2*q + body for the eight per-body quantities q (mass,
// angular momentum, torque, momentum x, momentum y, force x, force y, work
// done; the order of schemes/binary_scheme.PAIR_TOTALS), then the buffer's
// mass and angular momentum, then the fault count
constexpr int kTotals = 19;
constexpr int kWork = 14, kMassEjected = 16, kAngmomEjected = 17,
              kFaults = 18;
// the values an advance takes at run time: dt, theta, then the bodies'
// (mass, x, y, vx, vy) rows
constexpr int kDynamic = 12;

struct Params {
  double dt, theta;
  double body[2][5];            // (mass, x, y, vx, vy)
  double rs2, sink_r2, sink_rate, M2, mach, density_floor, gst2;
  double alpha, alpha_cutoff, nu, domain_radius, boundary_tol;
  int axisym, conserve_p, hllc;
};

// the 24 doubles and the flag bits of kernels/binary_advance.kernel_params
inline Params read_params(const double* h, int flags) {
  Params prm;
  prm.dt = h[0];
  prm.theta = h[1];
  for (int k = 0; k < 2; ++k)
    for (int c = 0; c < 5; ++c) prm.body[k][c] = h[2 + 5 * k + c];
  prm.rs2 = h[12];
  prm.sink_r2 = h[13];
  prm.sink_rate = h[14];
  prm.M2 = h[15];
  prm.mach = h[16];
  prm.density_floor = h[17];
  prm.gst2 = h[18];
  prm.alpha = h[19];
  prm.alpha_cutoff = h[20];
  prm.nu = h[21];
  prm.domain_radius = h[22];
  prm.boundary_tol = h[23];
  prm.axisym = flags & 1;
  prm.conserve_p = (flags >> 1) & 1;
  prm.hllc = (flags >> 2) & 1;
  return prm;
}

// dt, theta and the bodies from a device buffer of kDynamic doubles, when
// there is one (the same values a host Params would carry)
__device__ __forceinline__ void load_dynamic(Params& prm, const double* dyn) {
  if (dyn == nullptr) return;
  prm.dt = dyn[0];
  prm.theta = dyn[1];
  for (int k = 0; k < 2; ++k)
    for (int c = 0; c < 5; ++c) prm.body[k][c] = dyn[2 + 5 * k + c];
}

template <typename T>
__device__ __forceinline__ T sign_or_one(T a) {
  return a < T(0) ? T(-1) : T(1);
}

template <typename T>
__device__ __forceinline__ T plm(T yl, T y0, T yr, T theta) {
  T a = (y0 - yl) * theta;
  T b = (yr - yl) * T(0.5);
  T c = (yr - y0) * theta;
  T sa = sign_or_one(a), sb = sign_or_one(b), sc = sign_or_one(c);
  T mn = fmin(fmin(fabs(a), fabs(b)), fabs(c));
  return T(0.25) * fabs(sa + sb) * (sa + sc) * mn;
}

template <typename T>
__device__ __forceinline__ T cs2_at(T x, T y, const Params& prm) {
  if (prm.axisym) {
    T r = sqrt(x * x + y * y);
    return T(1) / r / T(prm.M2);
  }
  T phi[2];
  for (int k = 0; k < 2; ++k) {
    T dx = x - T(prm.body[k][1]);
    T dy = y - T(prm.body[k][2]);
    T dr2 = dx * dx + dy * dy;
    phi[k] = -T(prm.body[k][0]) / sqrt(dr2 + T(prm.rs2));
  }
  return -(phi[0] + phi[1]) / T(prm.M2);
}

// per-block coordinate rows: 0 cell-center x (by i), 1 cell-center y (by
// j), 2 x-face x (by i, bs+1), 3 x-face y (by j), 4 y-face x (by i),
// 5 y-face y (by j, bs+1)
__device__ __forceinline__ double axis_coord(const double* axes, int b,
                                             int bs, int row, int k) {
  return axes[((long long)b * 6 + row) * (bs + 1) + k];
}

// The C values that the guard cell outside face f of block b at position p
// takes from the neighbors' cells of v [B, bs, bs, C]: a copy for a
// same-level neighbor, the matching half-cell for a coarser one, the 2x2
// average for two finer ones (block_layout.build_guard_gather, with the
// same cells in the same order).
template <typename T, int C>
__device__ void neighbor_values(const T* v, const int* tab, int b, int bs,
                                int f, int p, T out[C]) {
  const int* t = tab + (b * 4 + f) * 6;
  const int axis = f >> 1, side = f & 1;
  const int edge = side == 0 ? bs - 1 : 0;
  if (t[0] != 2) {
    const int nb = t[0] == 0 ? t[1] : t[2];
    const int q = t[0] == 0 ? p : t[3] * (bs / 2) + p / 2;
    const int ci = axis == 0 ? edge : q, cj = axis == 0 ? q : edge;
    const T* src = v + (((long long)nb * bs + ci) * bs + cj) * C;
    for (int c = 0; c < C; ++c) out[c] = src[c];
    return;
  }
  const int nb = p < bs / 2 ? t[4] : t[5];
  const int q = (2 * p) % bs;
  const int e0 = side == 0 ? bs - 2 : 1, e1 = side == 0 ? bs - 1 : 0;
  long long cell[4];
  if (axis == 0) {
    cell[0] = ((long long)nb * bs + e0) * bs + q;
    cell[1] = ((long long)nb * bs + e0) * bs + q + 1;
    cell[2] = ((long long)nb * bs + e1) * bs + q;
    cell[3] = ((long long)nb * bs + e1) * bs + q + 1;
  } else {
    cell[0] = ((long long)nb * bs + q) * bs + e0;
    cell[1] = ((long long)nb * bs + q + 1) * bs + e0;
    cell[2] = ((long long)nb * bs + q) * bs + e1;
    cell[3] = ((long long)nb * bs + q + 1) * bs + e1;
  }
  for (int c = 0; c < C; ++c) {
    out[c] = T(0.25) * v[cell[0] * C + c] + T(0.25) * v[cell[1] * C + c]
           + T(0.25) * v[cell[2] * C + c] + T(0.25) * v[cell[3] * C + c];
  }
}

// Where the primitive guard cells come from: strips gathered beforehand
// (B2, whose wrapper gathers them with torch), or the neighbors' cells of
// the primitive field itself (B3).
template <typename T>
struct StripGuard {
  const T* pg;   // [B, 4, bs, 3] (faces x-lo, x-hi, y-lo, y-hi)
  __device__ void operator()(int b, int f, int pos, int bs, T out[3]) const {
    const T* s = pg + (((long long)b * 4 + f) * bs + pos) * 3;
    for (int c = 0; c < 3; ++c) out[c] = s[c];
  }
};

template <typename T>
struct GatherGuard {
  const T* p;    // [B, bs, bs, 3]
  const int* tab;
  __device__ void operator()(int b, int f, int pos, int bs, T out[3]) const {
    neighbor_values<T, 3>(p, tab, b, bs, f, pos, out);
  }
};

// iso2d flux of state P along `axis` with pressure sigma * cs2
// (physics/iso2d.flux with an axis unit normal)
template <typename T>
__device__ __forceinline__ void iso_flux(int axis, const T P[3], T cs2,
                                         T F[3]) {
  const T vn = P[1 + axis];
  const T pres = P[0] * cs2;
  const T vs = vn * P[0];
  F[0] = vs;
  F[1] = axis == 0 ? vs * P[1] + pres : vs * P[1];
  F[2] = axis == 0 ? vs * P[2] : vs * P[2] + pres;
}

// fhat * face length at one face (schemes/binary_scheme.block_fluxes, then
// to_angmom_fluxes in the angular-momentum formulation)
template <typename T>
__device__ void face_flux(int axis, const T pl[3], const T pr[3],
                          const T gl[3], const T gr[3], const T hl[3],
                          const T hr[3], T x, T y, T s, const Params& prm,
                          T out[3]) {
  T Pl[3], Pr[3];
  for (int c = 0; c < 3; ++c) {
    Pl[c] = pl[c] + gl[c] * T(0.5) * s;
    Pr[c] = pr[c] - gr[c] * T(0.5) * s;
  }
  const T cs2 = cs2_at(x, y, prm);
  const T r = sqrt(x * x + y * y);
  const T profile = prm.alpha_cutoff > 0.0
      ? T(0.5) * (T(1) + tanh(T(3) * (r - T(prm.alpha_cutoff))))
      : T(1);
  const T nu = prm.nu > 0.0
      ? profile * T(prm.nu)
      : profile * T(prm.alpha) * sqrt(cs2) * (r / T(prm.mach));
  const T mu = T(0.5) * nu * (Pl[0] + Pr[0]);

  const T ul = Pl[1 + axis], ur = Pr[1 + axis];
  const T Ul[3] = {Pl[0], Pl[0] * Pl[1], Pl[0] * Pl[2]};
  const T Ur[3] = {Pr[0], Pr[0] * Pr[1], Pr[0] * Pr[2]};
  T f[3];
  if (prm.hllc) {
    // Toro 3rd ed. sec 10.6, isothermal (physics_iso2d.hpp:610-712);
    // cs2 is the same on both sides of the face
    const T a = sqrt(cs2);
    const T sigma_bar = T(0.5) * (Pl[0] + Pr[0]);
    const T a_bar = T(0.5) * (a + a);
    const T press_l = Pl[0] * cs2, press_r = Pr[0] * cs2;
    const T ppvrs = T(0.5) * (press_l + press_r)
                  - T(0.5) * (ur - ul) * sigma_bar * a_bar;
    const T pstar = fmax(ppvrs, T(0));
    const T ql = fmax(sqrt(pstar / press_l), T(1));
    const T qr = fmax(sqrt(pstar / press_r), T(1));
    const T sl = ul - a * ql;
    const T sr = ur + a * qr;
    const T den = Pl[0] * (sl - ul) - Pr[0] * (sr - ur);
    const T sstar = (press_r - press_l + ul * Pl[0] * (sl - ul)
                     - ur * Pr[0] * (sr - ur)) / den;
    T Fl[3], Fr[3];
    iso_flux(axis, Pl, a * a, Fl);
    iso_flux(axis, Pr, a * a, Fr);
    if (sl >= T(0)) {
      for (int c = 0; c < 3; ++c) f[c] = Fl[c];
    } else if (sstar >= T(0)) {
      const T d = Pl[0] * (sl - ul) / (sl - sstar);
      const T Us[3] = {d, axis == 0 ? d * sstar : d * Pl[1],
                       axis == 0 ? d * Pl[2] : d * sstar};
      for (int c = 0; c < 3; ++c) f[c] = Fl[c] + (Us[c] - Ul[c]) * sl;
    } else if (sr >= T(0)) {
      const T d = Pr[0] * (sr - ur) / (sr - sstar);
      const T Us[3] = {d, axis == 0 ? d * sstar : d * Pr[1],
                       axis == 0 ? d * Pr[2] : d * sstar};
      for (int c = 0; c < 3; ++c) f[c] = Fr[c] + (Us[c] - Ur[c]) * sr;
    } else {
      for (int c = 0; c < 3; ++c) f[c] = Fr[c];
    }
  } else {
    // HLLE (physics_iso2d.hpp:488-520)
    const T cs = sqrt(cs2);
    T Fl[3], Fr[3];
    iso_flux(axis, Pl, cs2, Fl);
    iso_flux(axis, Pr, cs2, Fr);
    const T ap = fmax(fmax(ul + cs, ur + cs), T(0));
    const T am = fmin(fmin(ul - cs, ur - cs), T(0));
    for (int c = 0; c < 3; ++c) {
      f[c] = (Fl[c] * ap - Fr[c] * am - (Ul[c] - Ur[c]) * ap * am)
             / (ap - am);
    }
  }

  // viscous stress (subprog_binary_scheme.cpp:220-262): g* the slopes
  // along the face normal, h* the transverse ones
  if (axis == 0) {
    const T dx_ux = T(0.5) * (gl[1] + gr[1]);
    const T dx_uy = T(0.5) * (gl[2] + gr[2]);
    const T dy_ux = T(0.5) * (hl[1] + hr[1]);
    const T dy_uy = T(0.5) * (hl[2] + hr[2]);
    f[1] = f[1] - mu * (dx_ux - dy_uy);
    f[2] = f[2] - mu * (dx_uy + dy_ux);
  } else {
    const T dx_ux = T(0.5) * (hl[1] + hr[1]);
    const T dx_uy = T(0.5) * (hl[2] + hr[2]);
    const T dy_ux = T(0.5) * (gl[1] + gr[1]);
    const T dy_uy = T(0.5) * (gl[2] + gr[2]);
    f[1] = f[1] - mu * (dx_uy + dy_ux);
    f[2] = f[2] - (-mu) * (dx_ux - dy_uy);
  }
  for (int c = 0; c < 3; ++c) f[c] = f[c] * s;

  if (prm.conserve_p) {
    for (int c = 0; c < 3; ++c) out[c] = f[c];
    return;
  }
  const T coord = axis == 0 ? x : y;
  const bool at_boundary =
      fabs(fabs(coord) - T(prm.domain_radius)) <= T(prm.boundary_tol);
  out[0] = f[0];
  out[1] = x * f[1] + y * f[2];
  out[2] = at_boundary ? T(0) : x * f[2] - y * f[1];
}

// ---- primitive recovery of cell idx -----------------------------------------
// physics/iso2d.recover_primitive, or recover_primitive_angmom at the cell
// center
template <typename T>
__device__ __forceinline__ void recover_at(const T* u, const double* axes,
                                           long long idx, int bs,
                                           int conserve_p, T P[3]) {
  const T s = u[idx * 3];
  if (conserve_p) {
    P[0] = s;
    P[1] = u[idx * 3 + 1] / s;
    P[2] = u[idx * 3 + 2] / s;
    return;
  }
  const int j = idx % bs;
  const int i = (idx / bs) % bs;
  const int b = idx / ((long long)bs * bs);
  const T x = T(axis_coord(axes, b, bs, 0, i));
  const T y = T(axis_coord(axes, b, bs, 1, j));
  const T sr = u[idx * 3 + 1] / s;
  const T lz = u[idx * 3 + 2] / s;
  const T r2 = x * x + y * y;
  P[0] = s;
  P[1] = (sr * x - lz * y) / r2;
  P[2] = (sr * y + lz * x) / r2;
}

// ---- limited slopes of cell idx -----------------------------------------
// g [B, bs, bs, 6] = (gx | gy) / spacing; the guard cells close the
// stencils at the block edges.
template <typename T, typename Guard>
__device__ void slopes_at(const T* p, const Guard& guard,
                          const double* spacing, T* g, long long idx, int bs,
                          T theta) {
  const int j = idx % bs;
  const int i = (idx / bs) % bs;
  const int b = idx / ((long long)bs * bs);
  const T sp = T(spacing[b]);
  T xl[3], xr[3], yl[3], yr[3];
  if (i > 0) {
    for (int c = 0; c < 3; ++c) xl[c] = p[(idx - bs) * 3 + c];
  } else {
    guard(b, 0, j, bs, xl);
  }
  if (i < bs - 1) {
    for (int c = 0; c < 3; ++c) xr[c] = p[(idx + bs) * 3 + c];
  } else {
    guard(b, 1, j, bs, xr);
  }
  if (j > 0) {
    for (int c = 0; c < 3; ++c) yl[c] = p[(idx - 1) * 3 + c];
  } else {
    guard(b, 2, i, bs, yl);
  }
  if (j < bs - 1) {
    for (int c = 0; c < 3; ++c) yr[c] = p[(idx + 1) * 3 + c];
  } else {
    guard(b, 3, i, bs, yr);
  }
  for (int c = 0; c < 3; ++c) {
    const T y0 = p[idx * 3 + c];
    g[idx * 6 + c] = plm(xl[c], y0, xr[c], theta) / sp;
    g[idx * 6 + 3 + c] = plm(yl[c], y0, yr[c], theta) / sp;
  }
}

// ---- the flux through face idx ------------------------------------------
// idx runs over the x-faces fx [B, bs+1, bs, 3], then the y-faces fy
// [B, bs, bs+1, 3]; a face on a block edge takes its outer state from the
// guard and its outer slopes from the neighbor's slopes.
template <typename T, typename Guard>
__device__ void face_at(const T* p, const Guard& guard, const T* g,
                        const int* tab, const double* axes,
                        const double* spacing, T* fx, T* fy, long long idx,
                        int B, int bs, const Params& prm) {
  const long long nf = (long long)B * (bs + 1) * bs;
  const int axis = idx >= nf;
  const long long r = axis ? idx - nf : idx;
  const int per_block = (bs + 1) * bs;
  const int b = r / per_block;
  const int rem = r % per_block;
  const int i = axis == 0 ? rem / bs : rem / (bs + 1);
  const int j = axis == 0 ? rem % bs : rem % (bs + 1);
  // the two cells beside the face: lower (l) and upper (r) along the axis
  const int k = axis == 0 ? i : j;         // face index along the axis
  const int pos = axis == 0 ? j : i;       // position along the face
  T pl[3], pr[3], gL[6], gR[6];
  if (k == 0) {
    guard(b, 2 * axis, pos, bs, pl);
    neighbor_values<T, 6>(g, tab, b, bs, 2 * axis, pos, gL);
  } else {
    const long long cell = axis == 0
        ? ((long long)b * bs + (i - 1)) * bs + j
        : ((long long)b * bs + i) * bs + (j - 1);
    for (int c = 0; c < 3; ++c) pl[c] = p[cell * 3 + c];
    for (int c = 0; c < 6; ++c) gL[c] = g[cell * 6 + c];
  }
  if (k == bs) {
    guard(b, 2 * axis + 1, pos, bs, pr);
    neighbor_values<T, 6>(g, tab, b, bs, 2 * axis + 1, pos, gR);
  } else {
    const long long cell = ((long long)b * bs + i) * bs + j;
    for (int c = 0; c < 3; ++c) pr[c] = p[cell * 3 + c];
    for (int c = 0; c < 6; ++c) gR[c] = g[cell * 6 + c];
  }
  // slopes along the face normal (long) and across it (tran)
  const int lo = axis == 0 ? 0 : 3, tr = axis == 0 ? 3 : 0;
  const T x = T(axis_coord(axes, b, bs, axis == 0 ? 2 : 4, i));
  const T y = T(axis_coord(axes, b, bs, axis == 0 ? 3 : 5, j));
  T out[3];
  face_flux(axis, pl, pr, gL + lo, gR + lo, gL + tr, gR + tr, x, y,
            T(spacing[b]), prm, out);
  T* dst = axis == 0 ? fx : fy;
  for (int c = 0; c < 3; ++c) dst[r * 3 + c] = out[c];
}

// restrict_extrinsic of the two finer neighbors' fluxes through face f at
// position p (schemes/binary_scheme.correct_coarse_fine_fluxes)
template <typename T>
__device__ __forceinline__ T restricted_flux(const T* fx, const T* fy,
                                             const int* t, int bs, int f,
                                             int p, int c) {
  const int nb = p < bs / 2 ? t[4] : t[5];
  const int q = (2 * p) % bs;
  if ((f >> 1) == 0) {
    const int e = f == 0 ? bs : 0;
    const long long base = ((long long)nb * (bs + 1) + e) * bs;
    return fx[(base + q) * 3 + c] + fx[(base + q + 1) * 3 + c];
  }
  const int e = f == 2 ? bs : 0;
  return fy[(((long long)nb * bs + q) * (bs + 1) + e) * 3 + c]
       + fy[(((long long)nb * bs + q + 1) * (bs + 1) + e) * 3 + c];
}

// ---- sources, update and totals of one cell ---------------------------------
// U, P: the cell's state and primitives; in: its initial state; brc: its
// buffer damping rate; div: the divergence of its face fluxes; (x, y): its
// position; dA: its area. V = the updated state; acc += the cell's
// contributions to the totals (before their final negation).
// kTpuGeometric groups the geometric source as the TPU kernels of the split
// and jnp_strips advances do, 2 (Ek + pg) ramp, then dt
// (mara3_tpu/kernels/binary_update.py:96, binary_advance.py:375); otherwise
// as the reference-semantics scheme does, 2 (Ek + pg) (ramp dt).
template <typename T, bool kTpuGeometric = false>
__device__ __forceinline__ void update_cell(const T U[3], const T P[3],
                                            const T in[3], T brc,
                                            const T div[3], T x, T y, T dA,
                                            const Params& prm, T V[3],
                                            double acc[kTotals]) {
  const T dt = T(prm.dt);

  // sources (schemes/binary_scheme.source_terms)
  const T sigma = U[0];
  T s[3] = {T(0), T(0), T(0)};
  T sg[2][3], ss[2][3], fg[2][2];
  for (int k = 0; k < 2; ++k) {
    const T dx = x - T(prm.body[k][1]);
    const T dy = y - T(prm.body[k][2]);
    const T dr2 = dx * dx + dy * dy;
    const T q = T(prm.body[k][0]) / pow(dr2 + T(prm.rs2), T(1.5));
    fg[k][0] = -dx * q * sigma;
    fg[k][1] = -dy * q * sigma;
    sg[k][0] = T(0);
    if (prm.conserve_p) {
      sg[k][1] = fg[k][0] * dt;
      sg[k][2] = fg[k][1] * dt;
    } else {
      sg[k][1] = (x * fg[k][0] + y * fg[k][1]) * dt;
      sg[k][2] = (x * fg[k][1] - y * fg[k][0]) * dt;
    }
    const T a2 = dr2 / T(prm.sink_r2) / T(2);
    const T sink = T(prm.sink_rate) * exp(-a2);
    for (int c = 0; c < 3; ++c) ss[k][c] = -U[c] * sink * dt;
  }
  T sb[3], sf[3];
  const T floor_mask = sigma < T(prm.density_floor) ? T(1) : T(0);
  for (int c = 0; c < 3; ++c) {
    sb[c] = (in[c] - U[c]) * brc * dt;
    sf[c] = U[c] * T(0.01) * floor_mask;
    s[c] = sg[0][c] + sg[1][c] + ss[0][c] + ss[1][c] + sb[c] + sf[c];
  }
  if (!prm.conserve_p) {
    const T r2 = x * x + y * y;
    const T ramp = T(1) - exp(-r2 / T(prm.gst2));
    const T cs2 = cs2_at(x, y, prm);
    const T Ek = T(0.5) * P[0] * (P[1] * P[1] + P[2] * P[2]);
    const T pg = P[0] * cs2;
    if (kTpuGeometric)
      s[1] = s[1] + T(2) * (Ek + pg) * ramp * dt;
    else
      s[1] = s[1] + T(2) * (Ek + pg) * (ramp * dt);
  }

  for (int c = 0; c < 3; ++c) V[c] = U[c] - div[c] * dt / dA + s[c];

  // accounting totals (negated when the sums are final)
  const T r2 = x * x + y * y;
  for (int k = 0; k < 2; ++k) {
    const T lz_sink = prm.conserve_p ? x * ss[k][2] - y * ss[k][1] : ss[k][2];
    const T lz_grav = prm.conserve_p ? x * sg[k][2] - y * sg[k][1] : sg[k][2];
    const T dpx = prm.conserve_p ? ss[k][1] : (ss[k][1] * x - ss[k][2] * y) / r2;
    const T dpy = prm.conserve_p ? ss[k][2] : (ss[k][1] * y + ss[k][2] * x) / r2;
    acc[0 + k] = double(ss[k][0] * dA);
    acc[2 + k] = double(lz_sink * dA);
    acc[4 + k] = double(lz_grav * dA);
    acc[6 + k] = double(dpx * dA);
    acc[8 + k] = double(dpy * dA);
    acc[10 + k] = double(fg[k][0] * dt * dA);
    acc[12 + k] = double(fg[k][1] * dt * dA);
  }
  acc[kMassEjected] = double(sb[0] * dA);
  acc[kAngmomEjected] =
      double((prm.conserve_p ? x * sb[2] - y * sb[1] : sb[2]) * dA);
  acc[kFaults] = (V[0] < T(0) || isnan(V[0])) ? 1.0 : 0.0;
}

// ---- divergence, sources and update of cell idx -----------------------------
// the coarse-fine flux correction applied in place, then update_cell
template <typename T>
__device__ void update_at(const T* u0, const T* p, const T* init,
                          const T* br, const T* fx, const T* fy,
                          const int* tab, const double* axes,
                          const double* spacing, long long idx, int bs,
                          const Params& prm, T V[3], double acc[kTotals]) {
  const int j = idx % bs;
  const int i = (idx / bs) % bs;
  const int b = idx / ((long long)bs * bs);
  const T x = T(axis_coord(axes, b, bs, 0, i));
  const T y = T(axis_coord(axes, b, bs, 1, j));
  const T dA = T(spacing[b] * spacing[b]);
  const int* tb = tab + b * 4 * 6;
  T U[3], P[3], in[3];
  for (int c = 0; c < 3; ++c) {
    U[c] = u0[idx * 3 + c];
    P[c] = p[idx * 3 + c];
    in[c] = init[idx * 3 + c];
  }

  // flux divergence with the coarse-fine correction in place
  const long long fxl = ((long long)b * (bs + 1) + i) * bs + j;
  const long long fyl = ((long long)b * bs + i) * (bs + 1) + j;
  T div[3];
  for (int c = 0; c < 3; ++c) {
    T xl = fx[fxl * 3 + c], xr = fx[(fxl + bs) * 3 + c];
    T yl = fy[fyl * 3 + c], yr = fy[(fyl + 1) * 3 + c];
    if (i == 0 && tb[0 * 6] == 2) xl = restricted_flux(fx, fy, tb + 0 * 6, bs, 0, j, c);
    if (i == bs - 1 && tb[1 * 6] == 2) xr = restricted_flux(fx, fy, tb + 1 * 6, bs, 1, j, c);
    if (j == 0 && tb[2 * 6] == 2) yl = restricted_flux(fx, fy, tb + 2 * 6, bs, 2, i, c);
    if (j == bs - 1 && tb[3 * 6] == 2) yr = restricted_flux(fx, fy, tb + 3 * 6, bs, 3, i, c);
    div[c] = (xr - xl) + (yr - yl);
  }
  update_cell<T>(U, P, in, br[idx], div, x, y, dA, prm, V, acc);
}

// Sum of each acc[t] over the CTA (kThreads threads, all of which call
// it), in a fixed order; out[t] for t < N is written by thread t.
template <int N>
__device__ void block_sum(double (&acc)[N], double* out) {
  __shared__ double warp_sums[kThreads / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();   // a previous call's readers are done with warp_sums
  for (int t = 0; t < N; ++t) {
    double v = acc[t];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double v = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) v += warp_sums[w][threadIdx.x];
    out[threadIdx.x] = v;
  }
}

// Total t of the per-CTA partials [parts, kTotals], summed in a fixed order
// by one CTA: thread k takes the partials k, k + kThreads, ..., then
// block_sum. Negated, as the plain version's totals are, unless it is the
// fault count. All kThreads threads call it and get the value.
__device__ __forceinline__ double sum_total(const double* partials,
                                            int parts, int t) {
  double acc[1] = {0.0};
  for (int k = threadIdx.x; k < parts; k += kThreads)
    acc[0] += partials[(long long)k * kTotals + t];
  __shared__ double sum[1];
  block_sum(acc, sum);
  __syncthreads();
  return t == kFaults ? sum[0] : -sum[0];
}

// Accretion work on each body from the totals and the bodies' (mass, x, y,
// vx, vy) rows (one thread). A difference of nearly equal squares
// (subprog_binary_scheme.cpp:394-409), evaluated in the run's type with the
// square sums fused, as the JAX package's compiled code and
// binary_scheme.work_done evaluate it.
template <typename T, typename Body>
__device__ __forceinline__ void work_done(double* totals,
                                          const Body (&body)[2][5]) {
  for (int k = 0; k < 2; ++k) {
    const T M0 = T(body[k][0]);
    const T px0 = M0 * T(body[k][3]), py0 = M0 * T(body[k][4]);
    const T M1 = M0 + T(totals[0 + k]);
    const T px1 = px0 + T(totals[6 + k]), py1 = py0 + T(totals[8 + k]);
    const T w = T(0.5) * (fma(px1, px1, py1 * py1) / M1
                          - fma(px0, px0, py0 * py0) / M0);
    totals[kWork + k] = double(w);
  }
}

}  // namespace mara
