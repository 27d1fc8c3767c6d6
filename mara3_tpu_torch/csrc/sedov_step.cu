// Kernel B5: n steps of the 1D spherical sedov scheme (Euler, or SRHD with
// the Newton recovery of srhd_recover.cuh) on a log-radial grid, the state
// u [nr, 5] (extrinsic: U * dv per cell, components contiguous).
//
// Replaces mara3_tpu/kernels/sedov_step.py:250 (advance_n_pallas). It
// computes what kernels/sedov_step.py's advance_n_plain computes, operation
// for operation: per step, 1/dv times U, primitive recovery (Euler's, or the
// SRHD Newton warm-started from the previous step's pressure), pcm, plm or
// weno5 face states with a reflecting inner guard and zero-gradient outer
// guards (at the outer face too, where the TPU kernel reads cells nr-1,
// nr-1, nr-1, nr-2, nr-3 for weno5's right state), HLLE at the nr + 1
// faces, the spherical source and the update
// u + (-(F[r+1] dA[r+1] - F[r] dA[r]) + s dv) dt.
//
// Bound: a call of n steps need only read the state and the vertices once
// and write the state once: 10 float32 values and a float64 vertex a cell,
// 25.2 MB at 524,288 cells, 0.0075 ms at 3.35 TB/s. The operations (about
// 147 a cell and step for Euler pcm and 210 plus 40 a Newton update for
// SRHD pcm, counted in chip_smoke.py) are 0.002-0.01 ms a step at 33.5e12 a
// second, so a call of more than a step or two is bound by operations, of
// which the SRHD Newton's divides, square roots and rsqrt are the dearest.
// What the design does:
//   - one thread a cell, a CTA of 256 cells. A CTA recovers the primitives
//     of its cells and of a halo of 1 (pcm), 2 (plm) or 3 (weno5) cells a
//     side into shared memory (recomputing the halo's), computes the 257
//     faces of its cells once into shared memory, then updates its cells;
//   - one launch a step; a C loop issues all n on the caller's stream, with
//     the state and the warm pressure ping-ponged between two buffers each.
//     A step reads the previous step's pressure for every window cell, so a
//     halo cell recovers from the same guess as in its own CTA, and writes
//     the converged pressure of its own cells to the other buffer;
//   - between steps the state and geometry (29 MB at 524,288 cells in
//     float32) stay in device memory, where the 50 MB L2 can hold them.
// A persistent kernel with a grid barrier a step, as B3 has, is later work.
//
// Built with --fmad=false, with IEEE divides and square roots, the scalars
// (dt, theta, gamma - 1, ...) cast to the state's type as the plain version
// casts them, and NaN-propagating min and max: the results then match the
// plain version on the card to round-off (rsqrt is the function torch.rsqrt
// calls there).

#include <cuda_runtime.h>
#include <math.h>

#include "srhd_recover.cuh"

namespace {

constexpr int kThreads = 256;

// torch.maximum / torch.minimum: NaN wins
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? b : a));
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

// mathx/plm.py::_sign_or_one: torch.sign, with 0 (and NaN, whose
// torch.sign is 0) counted as +1
template <typename T>
__device__ __forceinline__ T sign_or_one(T a) {
  return a < T(0) ? T(-1) : T(1);
}

template <typename T>
__device__ __forceinline__ T plm(T yl, T y0, T yr, T theta) {
  const T a = (y0 - yl) * theta;
  const T b = (yr - yl) * T(0.5);
  const T c = (yr - y0) * theta;
  const T sa = sign_or_one(a), sb = sign_or_one(b), sc = sign_or_one(c);
  const T m = min_nan(min_nan(fabs(a), fabs(b)), fabs(c));
  return T(0.25) * fabs(sa + sb) * (sa + sc) * m;
}

template <typename T>
__device__ __forceinline__ T sq(T x) { return x * x; }

// mathx/weno.py::_weno5_left
template <typename T>
__device__ __forceinline__ T weno5_left(T qm2, T qm1, T q0, T qp1, T qp2) {
  const T c13 = T(13.0 / 12.0);
  const T b0 = c13 * sq(qm2 - T(2) * qm1 + q0)
               + T(0.25) * sq(qm2 - T(4) * qm1 + T(3) * q0);
  const T b1 = c13 * sq(qm1 - T(2) * q0 + qp1) + T(0.25) * sq(qm1 - qp1);
  const T b2 = c13 * sq(q0 - T(2) * qp1 + qp2)
               + T(0.25) * sq(T(3) * q0 - T(4) * qp1 + qp2);
  const T a0 = T(0.1) / sq(T(1e-6) + b0);
  const T a1 = T(0.6) / sq(T(1e-6) + b1);
  const T a2 = T(0.3) / sq(T(1e-6) + b2);
  const T asum = a0 + a1 + a2;
  const T p0 = (T(2) * qm2 - T(7) * qm1 + T(11) * q0) / T(6);
  const T p1 = (-qm1 + T(5) * q0 + T(2) * qp1) / T(6);
  const T p2 = (T(2) * q0 + T(5) * qp1 - qp2) / T(6);
  return (a0 * p0 + a1 * p1 + a2 * p2) / asum;
}

// HLLE along nhat = (1, 0, 0): physics/euler.py and physics/srhd.py
// riemann_hlle_t, with the dot products against nhat spelled out
template <typename T, bool SRHD>
__device__ __forceinline__ void side(const T P[5], T gamma, T gm1, T K,
                                     T U[5], T F[5], T* am, T* ap) {
  const T rho = P[0], u1 = P[1], u2 = P[2], u3 = P[3], p = P[4];
  T v;
  if (SRHD) {
    const T W = sqrt(T(1) + u1 * u1 + u2 * u2 + u3 * u3);
    const T h = (rho + p * K) / rho;
    const T D = rho * W;
    U[0] = D;
    U[1] = D * u1 * h;
    U[2] = D * u2 * h;
    U[3] = D * u3 * h;
    U[4] = D * h * W - p - D;
    const T c2 = gamma * p / (rho + p * K);
    const T vn = (T(1) * u1 + T(0) * u2 + T(0) * u3) / W;
    const T uu = u1 * u1 + u2 * u2 + u3 * u3;
    const T vv = uu / (T(1) + uu);
    const T v2 = vn * vn;
    const T k0 = sqrt(c2 * (T(1) - vv) * (T(1) - vv * c2 - v2 * (T(1) - c2)));
    *am = (vn * (T(1) - c2) - k0) / (T(1) - vv * c2);
    *ap = (vn * (T(1) - c2) + k0) / (T(1) - vv * c2);
    v = vn;   // flux_t's v: the same operations on the same values
  } else {
    U[0] = rho;
    U[1] = rho * u1;
    U[2] = rho * u2;
    U[3] = rho * u3;
    U[4] = T(0.5) * rho * (u1 * u1 + u2 * u2 + u3 * u3) + p / gm1;
    const T cs = sqrt(gamma * p / rho);
    const T vn = T(1) * u1 + T(0) * u2 + T(0) * u3;
    *am = vn - cs;
    *ap = vn + cs;
    v = vn;
  }
  F[0] = v * U[0];
  F[1] = v * U[1] + p * T(1);
  F[2] = v * U[2] + p * T(0);
  F[3] = v * U[3] + p * T(0);
  F[4] = v * U[4] + p * v;
}

template <typename T, bool SRHD>
__device__ __forceinline__ void hlle(const T L[5], const T R[5], T gamma,
                                     T gm1, T K, T F[5]) {
  T Ul[5], Ur[5], Fl[5], Fr[5], alm, alp, arm, arp;
  side<T, SRHD>(L, gamma, gm1, K, Ul, Fl, &alm, &alp);
  side<T, SRHD>(R, gamma, gm1, K, Ur, Fr, &arm, &arp);
  const T ap = max_nan(T(0), max_nan(alp, arp));
  const T am = min_nan(T(0), min_nan(alm, arm));
  for (int q = 0; q < 5; ++q) {
    F[q] = (Fl[q] * ap - Fr[q] * am - (Ul[q] - Ur[q]) * ap * am) / (ap - am);
  }
}

template <typename T>
struct Params {
  T dt, theta, gamma, gm1, K;
};

// One step on the CTA's 256 cells: dst = E(src); the SRHD Newton starts
// from max(p_in, 0) (p_in null: from 0) and writes its result to p_out.
template <typename T, int METHOD, bool SRHD>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ src, T* __restrict__ dst,
            const T* __restrict__ geo, const T* __restrict__ p_in,
            T* __restrict__ p_out, int nr, Params<T> prm) {
  constexpr int H = METHOD == 1 ? 1 : (METHOD == 2 ? 2 : 3);
  constexpr int W = kThreads + 2 * H;
  __shared__ T P[5][W];
  __shared__ T F[5][kThreads + 1];
  const int c0 = blockIdx.x * kThreads;
  const int lo = c0 - H;              // the cell of window slot 0
  const T* dv = geo;
  const T* dal = geo + nr;
  const T* dar = geo + 2 * (long long)nr;
  const T* rc = geo + 3 * (long long)nr;

  // primitives of the window's cells
  for (int w = threadIdx.x; w < W; w += kThreads) {
    const int j = lo + w;
    if (j < 0 || j >= nr) continue;
    const T inv_dv = T(1) / dv[j];
    T Ut[5], prim[5];
    for (int q = 0; q < 5; ++q) Ut[q] = src[5 * (long long)j + q] * inv_dv;
    if (SRHD) {
      const T p0 = p_in ? srhd::clamp_min(p_in[j], T(0)) : T(0);
      T p_final;
      bool done;
      srhd::recover(Ut[0], Ut[1], Ut[2], Ut[3], Ut[4], p0, T(0), prim,
                    &p_final, &done);
      if (p_out && j >= c0 && j < c0 + kThreads) p_out[j] = p_final;
    } else {
      const T d = Ut[0];
      const T p_squared = Ut[1] * Ut[1] + Ut[2] * Ut[2] + Ut[3] * Ut[3];
      prim[0] = d;
      prim[1] = Ut[1] / d;
      prim[2] = Ut[2] / d;
      prim[3] = Ut[3] / d;
      prim[4] = (Ut[4] - T(0.5) * p_squared / d) * prm.gm1;
    }
    for (int q = 0; q < 5; ++q) P[q][w] = prim[q];
  }
  __syncthreads();

  // component q of cell j with the guards: mirrored (velocity sign flipped)
  // inside, zero-gradient outside
  const auto cell = [&](int q, int j) -> T {
    if (j < 0) return (q == 1 ? T(-1) : T(1)) * P[q][-j - 1 - lo];
    if (j >= nr) return P[q][nr - 1 - lo];
    return P[q][j - lo];
  };

  // the faces c0 .. c0 + 256 (face f: between cells f - 1 and f)
  for (int t = threadIdx.x; t <= kThreads; t += kThreads) {
    const int f = c0 + t;
    if (f > nr) continue;
    T L[5], R[5], flux[5];
    for (int q = 0; q < 5; ++q) {
      if (METHOD == 1) {
        L[q] = cell(q, f - 1);
        R[q] = cell(q, f);
      } else if (METHOD == 2) {
        const T cm2 = cell(q, f - 2), cm1 = cell(q, f - 1), c = cell(q, f),
                cp1 = cell(q, f + 1);
        L[q] = cm1 + T(0.5) * plm(cm2, cm1, c, prm.theta);
        R[q] = c - T(0.5) * plm(cm1, c, cp1, prm.theta);
      } else {
        L[q] = weno5_left(cell(q, f - 3), cell(q, f - 2), cell(q, f - 1),
                          cell(q, f), cell(q, f + 1));
        R[q] = weno5_left(cell(q, f + 2), cell(q, f + 1), cell(q, f),
                          cell(q, f - 1), cell(q, f - 2));
      }
    }
    if (METHOD == 3 && (L[0] <= T(0) || L[4] <= T(0) || R[0] <= T(0)
                        || R[4] <= T(0))) {
      // positivity fallback to the first-order states
      for (int q = 0; q < 5; ++q) {
        L[q] = cell(q, f - 1);
        R[q] = cell(q, f);
      }
    }
    hlle<T, SRHD>(L, R, prm.gamma, prm.gm1, prm.K, flux);
    for (int q = 0; q < 5; ++q) F[q][t] = flux[q];
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int r = c0 + t;
  if (r >= nr) return;
  const T rho = P[0][r - lo], uq = P[2][r - lo], pg = P[4][r - lo];
  // the radial source: (2 p + H uq uq) / rc, H = rho h (SRHD) or rho
  const T Hd = SRHD ? rho + pg * prm.K : rho;
  const T s1 = (T(2) * pg + Hd * uq * uq) / rc[r];
  const T dvr = dv[r], dalr = dal[r], darr = dar[r];
  for (int q = 0; q < 5; ++q) {
    const T s = q == 1 ? s1 : T(0);
    const long long i = 5 * (long long)r + q;
    dst[i] = src[i] + (-(F[q][t + 1] * darr - F[q][t] * dalr) + s * dvr)
                      * prm.dt;
  }
}

template <typename T, int METHOD, bool SRHD>
cudaError_t run(const T* u, T* out, T* scr, const T* geo, T* p_a, T* p_b,
                int nr, int n, bool warm, const Params<T>& prm,
                cudaStream_t stream) {
  const dim3 grid((nr + kThreads - 1) / kThreads);
  cudaError_t err = cudaSuccess;
  const T* src = u;
  // step k writes out when n - k is even, so the last step lands in out;
  // step k reads the pressure step k - 1 wrote (step 1: the zeroed p_a)
  T* p_in = p_a;
  T* p_out = p_b;
  for (int k = 1; k <= n && err == cudaSuccess; ++k) {
    T* dst = ((n - k) % 2 == 0) ? out : scr;
    step_kernel<T, METHOD, SRHD><<<grid, kThreads, 0, stream>>>(
        src, dst, geo, (SRHD && warm) ? p_in : nullptr,
        (SRHD && warm) ? p_out : nullptr, nr, prm);
    err = cudaGetLastError();
    src = dst;
    T* swap = p_in;
    p_in = p_out;
    p_out = swap;
  }
  return err;
}

template <typename T, bool SRHD>
cudaError_t run_method(int method, const T* u, T* out, T* scr, const T* geo,
                       T* p_a, T* p_b, int nr, int n, bool warm,
                       const Params<T>& prm, cudaStream_t stream) {
  switch (method) {
    case 1:
      return run<T, 1, SRHD>(u, out, scr, geo, p_a, p_b, nr, n, warm, prm,
                             stream);
    case 2:
      return run<T, 2, SRHD>(u, out, scr, geo, p_a, p_b, nr, n, warm, prm,
                             stream);
    case 3:
      return run<T, 3, SRHD>(u, out, scr, geo, p_a, p_b, nr, n, warm, prm,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int advance_n(const T* u, T* out, T* scr, const T* geo, T* p_a, T* p_b,
              int nr, int n, int method, int srhd_system, int warm,
              double dt, double theta, double gamma, void* stream) {
  Params<T> prm;
  prm.dt = T(dt);
  prm.theta = T(theta);
  prm.gamma = T(gamma);
  prm.gm1 = T(gamma - 1.0);                      // Python's gamma - 1.0
  prm.K = T(1.0 + 1.0 / (gamma - 1.0));          // 1 + 1/(gamma - 1)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      srhd_system ? run_method<T, true>(method, u, out, scr, geo, p_a, p_b,
                                        nr, n, warm != 0, prm, s)
                  : run_method<T, false>(method, u, out, scr, geo, p_a, p_b,
                                         nr, n, warm != 0, prm, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* b5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n steps of u [nr, 5] into out; scr is a second buffer of u's size, geo
// the [4, nr] geometry (dv, r0^2, r1^2, rc) in u's type, p_a and p_b two
// buffers of nr values, p_a zeroed (the warm pressure). method 1 pcm, 2 plm,
// 3 weno5; srhd 0 (Euler) or 1; warm 0 or 1 (SRHD only). Returns a
// cudaError_t.
int b5_advance_n_f32(const float* u, float* out, float* scr, const float* geo,
                     float* p_a, float* p_b, int nr, int n, int method,
                     int srhd, int warm, double dt, double theta,
                     double gamma, void* stream) {
  return advance_n<float>(u, out, scr, geo, p_a, p_b, nr, n, method, srhd,
                          warm, dt, theta, gamma, stream);
}

int b5_advance_n_f64(const double* u, double* out, double* scr,
                     const double* geo, double* p_a, double* p_b, int nr,
                     int n, int method, int srhd, int warm, double dt,
                     double theta, double gamma, void* stream) {
  return advance_n<double>(u, out, scr, geo, p_a, p_b, nr, n, method, srhd,
                           warm, dt, theta, gamma, stream);
}

}  // extern "C"
