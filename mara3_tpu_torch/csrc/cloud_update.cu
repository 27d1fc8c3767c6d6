// Kernel B4: the cloud subprogram's SRHD stage on the spherical (r, theta)
// mesh, the state u [5, nr, nq] (extrinsic: U * dv per cell, one plane per
// component). Four entries, as the JAX package has them:
//
//   B4a  b4_flux_update   replaces mara3_tpu/kernels/cloud_update.py:200
//                         (fused_flux_update): the stage after recovery,
//                         from the BC-extended primitives Pe [5, nr+2, nq];
//   B4b  b4_run, n=1 rk=1 replaces cloud_update.py:462 (fused_stage): one
//                         stage, the Newton recovery inside;
//   B4c  b4_run, n=1 rk=2 replaces cloud_update.py:770 (fused_step_rk2): a
//                         whole RK2 step, two stage launches, the second
//                         with the Shu-Osher average 0.5 u0 + 0.5 u2 in its
//                         epilogue;
//   B4d  b4_run, any n    replaces cloud_update.py:910 (fused_run_rk2): n
//                         whole steps (rk 1 or 2), a C loop of stage
//                         launches on the caller's stream, step s reading
//                         rows s and s + 1 of the inflow stack [n+1, 5, nq].
//
// It computes what kernels/cloud_update.py's plain versions compute,
// operation for operation. A stage: 1/dv times u, the SRHD Newton of
// srhd_recover.cuh from max(p_guess, 0) with the pressure floored at
// tfloor D / W, the inflow guard row (r = -1) and the zero-gradient outer
// guard (r = nr, a copy of the last row's primitives), pcm or plm face
// states with zero slopes on both guard rows and both pole columns, the
// reciprocal-first HLLE of the TPU kernel (cloud_update.py:57-101) on the
// nr + 1 radial and nq + 1 polar faces, zero polar flux through both poles,
// the spherical sources with 1/r and cot(theta) given, and the update
// u + ((lr + lq) + s dv) dt. The stage writes the floored pressure of its
// own cells: the next stage's warm start.
//
// Bound: a call must read the state, the warm pressure and the vertices
// once and write the state and the pressure once (12 values a cell, 101 MB
// at 2,048 x 1,024 in float32, 0.03 ms at 3.35 TB/s). A stage does about
// 1,100 operations a cell (counted in chip_smoke.py), 0.07 ms at 33.5e12 a
// second, so a stage, and a call of many, is bound by operations, of which
// the Newton's and the HLLE's divides, square roots and rsqrt are the
// dearest.
//
// What the design does: one thread a cell, a CTA of 8 radial x 32 polar
// cells (the polar index is the contiguous one). The CTA recovers the
// primitives of its cells and of a halo of 2 cells a side into shared
// memory, recomputing the halo's: recovery is per cell, so a halo cell gets
// what its own CTA gives it, as on the TPU window (cloud_update.py:372-386).
// It then computes its 9 x 32 radial and 8 x 33 polar face fluxes once into
// shared memory and updates its cells. The state and the warm pressure are
// ping-ponged between two buffers each; the stage's geometry rows stay in
// device memory (the 50 MB L2 holds them at 2,048 x 1,024 in float32).
// wgmma, TMA, temporal blocking and a persistent kernel are later work.
//
// Built with --fmad=false, with IEEE divides and square roots, CUDA's rsqrt
// (the function torch.rsqrt calls on the card), the scalars cast to the
// state's type as the plain version casts them, and NaN-propagating min and
// max, the results match the plain version on the card to round-off.

#include <cuda_runtime.h>
#include <math.h>

#include "srhd_recover.cuh"

namespace {

constexpr int kTileR = 8;
constexpr int kTileQ = 32;
constexpr int kHalo = 2;
constexpr int kWinR = kTileR + 2 * kHalo;
constexpr int kWinQ = kTileQ + 2 * kHalo;
constexpr int kThreads = kTileR * kTileQ;

// torch.minimum: NaN wins (torch.maximum is srhd::max_nan)
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

// cloud_update.py:46-54 (_plm): the signs by a >= 0
template <typename T>
__device__ __forceinline__ T plm(T yl, T y0, T yr, T theta) {
  const T a = (y0 - yl) * theta;
  const T b = (yr - yl) * T(0.5);
  const T c = (yr - y0) * theta;
  const T sa = a >= T(0) ? T(1) : T(-1);
  const T sb = b >= T(0) ? T(1) : T(-1);
  const T sc = c >= T(0) ? T(1) : T(-1);
  const T m = min_nan(min_nan(fabs(a), fabs(b)), fabs(c));
  return T(0.25) * fabs(sa + sb) * (sa + sc) * m;
}

template <typename T>
struct Params {
  T dt, theta, tfloor, gamma, K;
};

// one side of cloud_update.py:57-101 (_hlle_t) along r (AXIS 0) or theta
template <typename T, int AXIS>
__device__ __forceinline__ void side(const T P[5], const Params<T>& prm,
                                     T U[5], T F[5], T* am, T* ap) {
  const T rho = P[0], u1 = P[1], u2 = P[2], u3 = P[3], p = P[4];
  const T uu = u1 * u1 + u2 * u2 + u3 * u3;
  const T invW = srhd::rsqrt_(T(1) + uu);
  const T W = (T(1) + uu) * invW;
  const T hd = rho + p * prm.K;
  const T D = rho * W;
  U[0] = D;
  U[1] = W * u1 * hd;
  U[2] = W * u2 * hd;
  U[3] = W * u3 * hd;
  U[4] = W * W * hd - p - D;
  const T un = AXIS == 0 ? u1 : u2;
  const T vn = un * invW;
  const T c2 = prm.gamma * p * (T(1) / hd);
  const T vv = T(1) - invW * invW;
  const T v2 = vn * vn;
  const T k0 = sqrt(c2 * (T(1) - vv) * (T(1) - vv * c2 - v2 * (T(1) - c2)));
  const T invd = T(1) / (T(1) - vv * c2);
  *am = (vn * (T(1) - c2) - k0) * invd;
  *ap = (vn * (T(1) - c2) + k0) * invd;
  F[0] = vn * U[0];
  F[1] = vn * U[1];
  F[2] = vn * U[2];
  F[3] = vn * U[3];
  F[4] = vn * U[4] + p * vn;
  F[1 + AXIS] = F[1 + AXIS] + p;
}

template <typename T, int AXIS>
__device__ __forceinline__ void hlle(const T L[5], const T R[5],
                                     const Params<T>& prm, T F[5]) {
  T Ul[5], Ur[5], Fl[5], Fr[5], alm, alp, arm, arp;
  side<T, AXIS>(L, prm, Ul, Fl, &alm, &alp);
  side<T, AXIS>(R, prm, Ur, Fr, &arm, &arp);
  const T ap = srhd::max_nan(T(0), srhd::max_nan(alp, arp));
  const T am = min_nan(T(0), min_nan(alm, arm));
  const T inv = T(1) / (ap - am);
  for (int q = 0; q < 5; ++q) {
    F[q] = (Fl[q] * ap - Fr[q] * am - (Ul[q] - Ur[q]) * ap * am) * inv;
  }
}

template <typename T>
struct Geometry {
  const T* dv;    // [nr, nq]
  const T* dAr;   // [nr + 1, nq]: face r between rows r - 1 and r
  const T* dAq;   // [nr, nq + 1]: face j between columns j - 1 and j
  const T* invr;  // [nr]
  const T* cotq;  // [nq]
};

// One stage on the CTA's 8 x 32 cells. RECOVER: the primitives are
// recovered from src (warm-started from p_in, floored, their pressure
// written to p_out) with the inflow row `inflow` [5, nq]; otherwise they
// are read from pe [5, nr + 2, nq], guard rows included. dst = the update
// of src, or, with avg, 0.5 avg + 0.5 (the update of src).
template <typename T, int METHOD, bool RECOVER>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* __restrict__ src, const T* __restrict__ avg,
             T* __restrict__ dst, const T* __restrict__ p_in,
             T* __restrict__ p_out, const T* __restrict__ inflow,
             const T* __restrict__ pe, Geometry<T> geo, int nr, int nq,
             Params<T> prm) {
  __shared__ T sP[5][kWinR][kWinQ];
  __shared__ T sFr[5][kTileR + 1][kTileQ];
  __shared__ T sFq[5][kTileR][kTileQ + 1];
  const int r0 = blockIdx.y * kTileR;
  const int q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const long long plane = (long long)nr * nq;

  // the window's primitives: rows r0 - 2 .. r0 + 9 (only -1 .. nr exist),
  // columns q0 - 2 .. q0 + 33 (only 0 .. nq - 1 are read)
  for (int w = tid; w < kWinR * kWinQ; w += kThreads) {
    const int wr = w / kWinQ, wq = w % kWinQ;
    const int g = r0 - kHalo + wr, j = q0 - kHalo + wq;
    if (g < -1 || g > nr || j < 0 || j >= nq) continue;
    T prim[5];
    if (!RECOVER) {
      for (int q = 0; q < 5; ++q) {
        prim[q] = pe[q * (long long)(nr + 2) * nq + (long long)(g + 1) * nq
                     + j];
      }
    } else if (g == -1) {
      for (int q = 0; q < 5; ++q) prim[q] = inflow[q * nq + j];
    } else {
      // the outer guard row recovers the last row again: the same cell
      // from the same guess gives the same primitives
      const int r = g == nr ? nr - 1 : g;
      const long long i = (long long)r * nq + j;
      const T inv_dv = T(1) / geo.dv[i];
      T Ut[5];
      for (int q = 0; q < 5; ++q) Ut[q] = src[q * plane + i] * inv_dv;
      const T p0 = srhd::clamp_min(p_in[i], T(0));
      T p_unfloored;
      bool done;
      srhd::recover(Ut[0], Ut[1], Ut[2], Ut[3], Ut[4], p0, prm.tfloor, prim,
                    &p_unfloored, &done);
      if (g < nr && g >= r0 && g < r0 + kTileR && j >= q0
          && j < q0 + kTileQ) {
        p_out[i] = prim[4];
      }
    }
    for (int q = 0; q < 5; ++q) sP[q][wr][wq] = prim[q];
  }
  __syncthreads();

  // component q at row g, column j (g in -1 .. nr, j in 0 .. nq - 1)
  const auto at = [&](int q, int g, int j) -> T {
    return sP[q][g - r0 + kHalo][j - q0 + kHalo];
  };
  // the limited radial slope at row g: zero on the guard rows
  const auto slope_r = [&](int q, int g, int j) -> T {
    if (METHOD == 1 || g == -1 || g == nr) return T(0);
    return plm(at(q, g - 1, j), at(q, g, j), at(q, g + 1, j), prm.theta);
  };
  // the limited polar slope at column j: zero on the pole columns
  const auto slope_q = [&](int q, int g, int j) -> T {
    if (METHOD == 1 || j == 0 || j == nq - 1) return T(0);
    return plm(at(q, g, j - 1), at(q, g, j), at(q, g, j + 1), prm.theta);
  };

  // radial faces r0 .. r0 + 8 (face f between rows f - 1 and f)
  for (int t = tid; t < (kTileR + 1) * kTileQ; t += kThreads) {
    const int tr = t / kTileQ, tq = t % kTileQ;
    const int f = r0 + tr, j = q0 + tq;
    if (f > nr || j >= nq) continue;
    T L[5], R[5], flux[5];
    for (int q = 0; q < 5; ++q) {
      if (METHOD == 1) {
        L[q] = at(q, f - 1, j);
        R[q] = at(q, f, j);
      } else {
        L[q] = at(q, f - 1, j) + T(0.5) * slope_r(q, f - 1, j);
        R[q] = at(q, f, j) - T(0.5) * slope_r(q, f, j);
      }
    }
    hlle<T, 0>(L, R, prm, flux);
    for (int q = 0; q < 5; ++q) sFr[q][tr][tq] = flux[q];
  }
  // polar faces q0 .. q0 + 32 (face j between columns j - 1 and j), zero
  // through both poles
  for (int t = tid; t < kTileR * (kTileQ + 1); t += kThreads) {
    const int tr = t / (kTileQ + 1), tq = t % (kTileQ + 1);
    const int g = r0 + tr, j = q0 + tq;
    if (g >= nr || j > nq) continue;
    T flux[5];
    if (j == 0 || j == nq) {
      for (int q = 0; q < 5; ++q) flux[q] = T(0);
    } else {
      T L[5], R[5];
      for (int q = 0; q < 5; ++q) {
        if (METHOD == 1) {
          L[q] = at(q, g, j - 1);
          R[q] = at(q, g, j);
        } else {
          L[q] = at(q, g, j - 1) + T(0.5) * slope_q(q, g, j - 1);
          R[q] = at(q, g, j) - T(0.5) * slope_q(q, g, j);
        }
      }
      hlle<T, 1>(L, R, prm, flux);
    }
    for (int q = 0; q < 5; ++q) sFq[q][tr][tq] = flux[q];
  }
  __syncthreads();

  const int tr = tid / kTileQ, tq = tid % kTileQ;
  const int r = r0 + tr, j = q0 + tq;
  if (r >= nr || j >= nq) return;
  const long long i = (long long)r * nq + j;
  // the spherical sources (cloud_update.py:446-454)
  const T rho = at(0, r, j), ur = at(1, r, j), uq = at(2, r, j),
          up = at(3, r, j), pg = at(4, r, j);
  const T invr = geo.invr[r], cotq = geo.cotq[j];
  const T H = rho + pg * prm.K;
  T s[5];
  s[0] = T(0);
  s[1] = (T(2) * pg + H * (uq * uq + up * up)) * invr;
  s[2] = (cotq * pg + H * (up * up * cotq - ur * uq)) * invr;
  s[3] = -up * H * (ur + uq * cotq) * invr;
  s[4] = T(0);
  const T dv = geo.dv[i];
  const T ar_lo = geo.dAr[i], ar_hi = geo.dAr[i + nq];
  const long long iq = (long long)r * (nq + 1) + j;
  const T aq_lo = geo.dAq[iq], aq_hi = geo.dAq[iq + 1];
  for (int q = 0; q < 5; ++q) {
    const T lr = -(sFr[q][tr + 1][tq] * ar_hi - sFr[q][tr][tq] * ar_lo);
    const T lq = sFq[q][tr][tq] * aq_lo - sFq[q][tr][tq + 1] * aq_hi;
    const T u1 = src[q * plane + i] + (lr + lq + s[q] * dv) * prm.dt;
    dst[q * plane + i] = avg ? T(0.5) * avg[q * plane + i] + T(0.5) * u1
                             : u1;
  }
}

template <typename T>
Params<T> make_params(double dt, double theta, double tfloor, double gamma) {
  Params<T> prm;
  prm.dt = T(dt);
  prm.theta = T(theta);
  prm.tfloor = T(tfloor);
  prm.gamma = T(gamma);
  prm.K = T(1.0 + 1.0 / (gamma - 1.0));   // Python's 1.0 + 1.0/(GAMMA - 1.0)
  return prm;
}

dim3 grid_of(int nr, int nq) {
  return dim3((nq + kTileQ - 1) / kTileQ, (nr + kTileR - 1) / kTileR);
}

template <typename T, bool RECOVER>
cudaError_t launch(int method, const T* src, const T* avg, T* dst,
                   const T* p_in, T* p_out, const T* inflow, const T* pe,
                   const Geometry<T>& geo, int nr, int nq,
                   const Params<T>& prm, cudaStream_t stream) {
  const dim3 grid = grid_of(nr, nq);
  if (method == 1) {
    stage_kernel<T, 1, RECOVER><<<grid, kThreads, 0, stream>>>(
        src, avg, dst, p_in, p_out, inflow, pe, geo, nr, nq, prm);
  } else if (method == 2) {
    stage_kernel<T, 2, RECOVER><<<grid, kThreads, 0, stream>>>(
        src, avg, dst, p_in, p_out, inflow, pe, geo, nr, nq, prm);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// n steps of rk stages each. Step s reads its state (u for s = 0) and
// writes the next to out when n - 1 - s is even, else to scr, so the last
// lands in out; rk 2's first stage writes to st and its second averages
// with the step's state. Stage k of the m = n rk stages writes its pressure
// to p_out when m - k is even, else to p_scr, so the last lands in p_out;
// stage 1 reads p_guess. Step s's stages read inflow rows s and s + 1.
template <typename T>
int run(const T* u, T* out, T* scr, T* st, const T* p_guess, T* p_out,
        T* p_scr, const T* inflows, const Geometry<T>& geo, int nr, int nq,
        int n, int rk, int method, double dt, double theta, double tfloor,
        double gamma, void* stream) {
  if (rk != 1 && rk != 2) return static_cast<int>(cudaErrorInvalidValue);
  const Params<T> prm = make_params<T>(dt, theta, tfloor, gamma);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n * rk;
  const T* state = u;
  const T* p_in = p_guess;
  int k = 0;
  cudaError_t err = cudaSuccess;
  const auto stage = [&](const T* src, const T* avg, T* dst,
                         const T* inflow) {
    ++k;
    T* p_dst = (m - k) % 2 == 0 ? p_out : p_scr;
    err = launch<T, true>(method, src, avg, dst, p_in, p_dst, inflow,
                          nullptr, geo, nr, nq, prm, s);
    p_in = p_dst;
  };
  for (int step = 0; step < n && err == cudaSuccess; ++step) {
    T* next = (n - 1 - step) % 2 == 0 ? out : scr;
    const T* inflow = inflows + (long long)step * 5 * nq;
    if (rk == 1) {
      stage(state, nullptr, next, inflow);
    } else {
      stage(state, nullptr, st, inflow);
      if (err == cudaSuccess) stage(st, state, next, inflow + 5 * nq);
    }
    state = next;
  }
  return static_cast<int>(err);
}

template <typename T>
int flux_update(const T* pe, const T* u0, T* out, const Geometry<T>& geo,
                int nr, int nq, int method, double dt, double theta,
                double gamma, void* stream) {
  const Params<T> prm = make_params<T>(dt, theta, 0.0, gamma);
  return static_cast<int>(launch<T, false>(
      method, u0, nullptr, out, nullptr, nullptr, nullptr, pe, geo, nr, nq,
      prm, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

const char* b4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B4b, B4c and B4d: n steps (rk 1 or 2 stages each) of u [5, nr, nq] into
// out, with the warm pressure p_guess [nr, nq] and the inflow rows inflows
// [n + 1, 5, nq]; the last stage's recovered (floored) pressure lands in
// p_out. scr and st are scratch of u's size, p_scr of p_out's. The geometry
// dv [nr, nq], dAr [nr + 1, nq], dAq [nr, nq + 1], invr [nr], cotq [nq] is
// in u's type. method 1 pcm, 2 plm. Returns a cudaError_t.
int b4_run_f32(const float* u, float* out, float* scr, float* st,
               const float* p_guess, float* p_out, float* p_scr,
               const float* inflows, const float* dv, const float* dAr,
               const float* dAq, const float* invr, const float* cotq,
               int nr, int nq, int n, int rk, int method, double dt,
               double theta, double tfloor, double gamma, void* stream) {
  const Geometry<float> geo{dv, dAr, dAq, invr, cotq};
  return run<float>(u, out, scr, st, p_guess, p_out, p_scr, inflows, geo, nr,
                    nq, n, rk, method, dt, theta, tfloor, gamma, stream);
}

int b4_run_f64(const double* u, double* out, double* scr, double* st,
               const double* p_guess, double* p_out, double* p_scr,
               const double* inflows, const double* dv, const double* dAr,
               const double* dAq, const double* invr, const double* cotq,
               int nr, int nq, int n, int rk, int method, double dt,
               double theta, double tfloor, double gamma, void* stream) {
  const Geometry<double> geo{dv, dAr, dAq, invr, cotq};
  return run<double>(u, out, scr, st, p_guess, p_out, p_scr, inflows, geo,
                     nr, nq, n, rk, method, dt, theta, tfloor, gamma, stream);
}

// B4a: the update of u0 [5, nr, nq] into out from the BC-extended
// primitives pe [5, nr + 2, nq].
int b4_flux_update_f32(const float* pe, const float* u0, float* out,
                       const float* dv, const float* dAr, const float* dAq,
                       const float* invr, const float* cotq, int nr, int nq,
                       int method, double dt, double theta, double gamma,
                       void* stream) {
  const Geometry<float> geo{dv, dAr, dAq, invr, cotq};
  return flux_update<float>(pe, u0, out, geo, nr, nq, method, dt, theta,
                            gamma, stream);
}

int b4_flux_update_f64(const double* pe, const double* u0, double* out,
                       const double* dv, const double* dAr, const double* dAq,
                       const double* invr, const double* cotq, int nr, int nq,
                       int method, double dt, double theta, double gamma,
                       void* stream) {
  const Geometry<double> geo{dv, dAr, dAq, invr, cotq};
  return flux_update<double>(pe, u0, out, geo, nr, nq, method, dt, theta,
                             gamma, stream);
}

}  // extern "C"
