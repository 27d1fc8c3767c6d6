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
// The design: a segment march in one cooperative launch a call
// (resident_loop.cuh). CTA g owns the cells starts[g] .. starts[g + 1] (at
// least 3, from the wrapper's plan) for all n steps; 1/dv is formed once a
// call, by the same division as the plain version's. A step:
//   1. recover every cell of the segment once, at full width (one thread a
//      cell, kThreads cells a round), into the segment's primitives; the
//      SRHD Newton starts from the pressure the cell's own last step
//      converged to (warm), kept by its owner, and writes its new one back;
//      the first and last three cells' primitives go to the edge buffer of
//      the step's parity (the halo crosses as the owner's recovered
//      primitives, so no cell is recovered twice and a halo cell carries
//      its owner's warm start and bits);
//   2. one grid barrier;
//   3. the H = 1 (pcm), 2 (plm) or 3 (weno5) halo cells an end from the
//      neighbors' edges, or the mirrored and zero-gradient guards at the
//      domain's ends;
//   4. march the segment's faces in tiles of kThreads, each face computed
//      once into a ring of 2 kThreads faces, each cell updated once its two
//      faces are in the ring.
// Where the segment's state, warm pressure, 1/dv and primitives fit in
// shared memory beside the ring (float32 at 524,288 cells: 1,324 cells and
// 74 KB a CTA, three CTAs an SM), they stay there for the call (resident)
// and the state is read from device memory once and written once. Where
// they do not (float64 at 524,288 cells), the same march keeps them in
// device memory, updated in place by their owner (streaming). The wrapper
// chooses from the sizes alone (kernels/sedov_step.py march_plan). Each
// update's geometry (device memory, the L2) is loaded before the face it
// waits on is computed, so the face hides the load.
//
// Built with --fmad=false, with IEEE divides and square roots, the scalars
// (dt, theta, gamma - 1, ...) cast to the state's type as the plain version
// casts them, and NaN-propagating min and max: the results then match the
// plain version on the card to round-off (rsqrt is the function torch.rsqrt
// calls there).

#include <cuda_runtime.h>
#include <math.h>

#include "resident_loop.cuh"
#include "srhd_recover.cuh"

namespace {

constexpr int kThreads = 256;
// the launch bounds' CTAs an SM: three in float32 (at most 80 registers),
// two in float64
template <typename T>
struct CtasPerSm {
  static constexpr int value = sizeof(T) == 4 ? 3 : 2;
};
constexpr int kRing = 2 * kThreads;    // the face ring
constexpr int kEdge = 3;               // edge-buffer cells a segment end

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

template <int METHOD>
__host__ __device__ constexpr int halo() {
  return METHOD == 1 ? 1 : (METHOD == 2 ? 2 : 3);
}

template <typename T>
struct MarchArgs {
  const T* u;         // [nr, 5] the call's input
  T* out;             // [nr, 5] the result (streaming: the state)
  const T* geo;       // [4, nr] dv, r0^2, r1^2, rc
  T* pw;              // streaming: [nr] the warm pressure, zeroed
  T* inv_dv;          // streaming: [nr] scratch for 1/dv
  T* prim;            // streaming: [5, nr + 2 kEdge G] the primitives
  const int* starts;  // [G + 1] the segments
  T* edges;           // two buffers of [G, 2, kEdge, 5]
  int nr, lmax, n, warm;
  Params<T> prm;
};

// Dynamic shared memory of a CTA with segments of at most lmax cells: the
// face ring, and (resident) the state [5, lmax], warm pressure and 1/dv
// [lmax] and primitives [5, lmax + 2H].
template <typename T>
size_t march_smem(int method, bool resident_state, int lmax) {
  const int H = method == 1 ? 1 : (method == 2 ? 2 : 3);
  size_t v = 5 * (size_t)kRing;
  if (resident_state) v += 7 * (size_t)lmax + 5 * (size_t)(lmax + 2 * H);
  return v * sizeof(T);
}

template <typename T, int METHOD, bool SRHD, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, CtasPerSm<T>::value)
march_kernel(MarchArgs<T> a) {
  constexpr int H = halo<METHOD>();
  constexpr int kMask = kRing - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, G = gridDim.x, t = threadIdx.x;
  const int s0 = a.starts[g], L = a.starts[g + 1] - s0;
  const int lmax = a.lmax, nr = a.nr;
  const Params<T> prm = a.prm;
  T* Fr = reinterpret_cast<T*>(smem);             // [5, kRing]
  T* Us = Fr + 5 * kRing;                         // resident: [5, lmax]
  T* pws = Us + 5 * lmax;                         // resident: [lmax]
  T* invs = pws + lmax;                           // resident: [lmax]
  // the primitives of local cell l (-H <= l < L + H) at P[q * pst + l + H]
  T* P = RESIDENT ? invs + lmax : a.prim + s0 + 2 * kEdge * g;
  const long long pst = RESIDENT ? lmax + 2 * H
                                 : (long long)nr + 2 * kEdge * G;
  const T* dv = a.geo;
  const T* dal = a.geo + nr;
  const T* dar = a.geo + 2 * (long long)nr;
  const T* rc = a.geo + 3 * (long long)nr;
  const long long edge_size = (long long)G * 2 * kEdge * 5;

  for (int l = t; l < L; l += kThreads) {
    const int j = s0 + l;
    const T inv = T(1) / dv[j];
    if (RESIDENT) {
      invs[l] = inv;
      pws[l] = T(0);
      for (int q = 0; q < 5; ++q) Us[q * lmax + l] = a.u[5 * (long long)j + q];
    } else {
      a.inv_dv[j] = inv;
    }
  }

  for (int step = 0; step < a.n; ++step) {
    T* E = resident::edge_buffer(a.edges, edge_size, step);
    // streaming: the state is the input until the first update
    const T* Uin = step == 0 ? a.u : a.out;

    // 1. recover every cell of the segment once
    for (int l = t; l < L; l += kThreads) {
      const int j = s0 + l;
      T Ut[5], prim[5];
      const T inv = RESIDENT ? invs[l] : a.inv_dv[j];
      for (int q = 0; q < 5; ++q) {
        Ut[q] = (RESIDENT ? Us[q * lmax + l] : Uin[5 * (long long)j + q])
                * inv;
      }
      if (SRHD) {
        T* pj = RESIDENT ? pws + l : a.pw + j;
        const T p0 = a.warm ? srhd::clamp_min(*pj, T(0)) : T(0);
        T p_final;
        bool done;
        srhd::recover(Ut[0], Ut[1], Ut[2], Ut[3], Ut[4], p0, T(0), prim,
                      &p_final, &done);
        if (a.warm) *pj = p_final;
      } else {
        const T d = Ut[0];
        const T p_squared = Ut[1] * Ut[1] + Ut[2] * Ut[2] + Ut[3] * Ut[3];
        prim[0] = d;
        prim[1] = Ut[1] / d;
        prim[2] = Ut[2] / d;
        prim[3] = Ut[3] / d;
        prim[4] = (Ut[4] - T(0.5) * p_squared / d) * prm.gm1;
      }
      for (int q = 0; q < 5; ++q) P[q * pst + l + H] = prim[q];
      if (l < kEdge) {
        for (int q = 0; q < 5; ++q) {
          resident::store_edge(E + ((g * 2) * kEdge + l) * 5 + q, prim[q]);
        }
      }
      if (L - 1 - l < kEdge) {
        for (int q = 0; q < 5; ++q) {
          resident::store_edge(E + ((g * 2 + 1) * kEdge + L - 1 - l) * 5 + q,
                               prim[q]);
        }
      }
    }

    // 2. one grid barrier
    resident::grid_sync();

    // 3. the halo: cell -1 - t at slot H - 1 - t, cell L + t at L + H + t
    if (t < H) {
      for (int q = 0; q < 5; ++q) {
        P[q * pst + H - 1 - t] =
            g > 0 ? resident::load_edge(E + (((g - 1) * 2 + 1) * kEdge + t)
                                                * 5 + q)
                  : (q == 1 ? T(-1) : T(1)) * P[q * pst + t + H];
        P[q * pst + L + H + t] =
            g < G - 1 ? resident::load_edge(E + (((g + 1) * 2) * kEdge + t)
                                                    * 5 + q)
                      : P[q * pst + L - 1 + H];
      }
    }
    __syncthreads();

    // 4. the faces 0 .. L (face f between cells f - 1 and f) in tiles;
    // cell f - 1 is updated once face f is in the ring
    const auto cell = [&](int q, int l) -> T { return P[q * pst + l + H]; };
    for (int f0 = 0; f0 <= L; f0 += kThreads) {
      const int f = f0 + t;
      const int l = f - 1;
      const bool upd = f <= L && l >= 0;
      const int r = s0 + (upd ? l : 0);
      // the update's geometry, loaded before the face is computed
      const T rcr = rc[r], dvr = dv[r], dalr = dal[r], darr = dar[r];
      if (f <= L) {
        T Lq[5], Rq[5], flux[5];
        for (int q = 0; q < 5; ++q) {
          if (METHOD == 1) {
            Lq[q] = cell(q, f - 1);
            Rq[q] = cell(q, f);
          } else if (METHOD == 2) {
            const T cm2 = cell(q, f - 2), cm1 = cell(q, f - 1),
                    c = cell(q, f), cp1 = cell(q, f + 1);
            Lq[q] = cm1 + T(0.5) * plm(cm2, cm1, c, prm.theta);
            Rq[q] = c - T(0.5) * plm(cm1, c, cp1, prm.theta);
          } else {
            Lq[q] = weno5_left(cell(q, f - 3), cell(q, f - 2),
                               cell(q, f - 1), cell(q, f), cell(q, f + 1));
            Rq[q] = weno5_left(cell(q, f + 2), cell(q, f + 1), cell(q, f),
                               cell(q, f - 1), cell(q, f - 2));
          }
        }
        if (METHOD == 3 && (Lq[0] <= T(0) || Lq[4] <= T(0) || Rq[0] <= T(0)
                            || Rq[4] <= T(0))) {
          // positivity fallback to the first-order states
          for (int q = 0; q < 5; ++q) {
            Lq[q] = cell(q, f - 1);
            Rq[q] = cell(q, f);
          }
        }
        hlle<T, SRHD>(Lq, Rq, prm.gamma, prm.gm1, prm.K, flux);
        for (int q = 0; q < 5; ++q) Fr[q * kRing + (f & kMask)] = flux[q];
      }
      __syncthreads();
      if (upd) {
        const T rho = cell(0, l), uq = cell(2, l), pg = cell(4, l);
        // the radial source: (2 p + H uq uq) / rc, H = rho h (SRHD) or rho
        const T Hd = SRHD ? rho + pg * prm.K : rho;
        const T s1 = (T(2) * pg + Hd * uq * uq) / rcr;
        for (int q = 0; q < 5; ++q) {
          const T s = q == 1 ? s1 : T(0);
          const T Fhi = Fr[q * kRing + (f & kMask)];
          const T Flo = Fr[q * kRing + (l & kMask)];
          if (RESIDENT) {
            T& U = Us[q * lmax + l];
            U = U + (-(Fhi * darr - Flo * dalr) + s * dvr) * prm.dt;
          } else {
            const long long i = 5 * (long long)r + q;
            a.out[i] = Uin[i] + (-(Fhi * darr - Flo * dalr) + s * dvr)
                                * prm.dt;
          }
        }
      }
      __syncthreads();
    }
  }

  if (RESIDENT) {
    for (int l = t; l < L; l += kThreads) {
      for (int q = 0; q < 5; ++q) {
        a.out[5 * (long long)(s0 + l) + q] = Us[q * lmax + l];
      }
    }
  }
}

template <typename T, int METHOD, bool SRHD, bool RESIDENT>
cudaError_t launch(const MarchArgs<T>& a, int ctas, cudaStream_t stream) {
  return resident::launch(march_kernel<T, METHOD, SRHD, RESIDENT>, ctas,
                          kThreads, march_smem<T>(METHOD, RESIDENT, a.lmax),
                          stream, a);
}

template <typename T, int METHOD, bool SRHD, bool RESIDENT>
cudaError_t info(int lmax, int* out) {
  const size_t smem = march_smem<T>(METHOD, RESIDENT, lmax);
  out[4] = (int)smem;
  return resident::kernel_info(march_kernel<T, METHOD, SRHD, RESIDENT>,
                               kThreads, smem, out);
}

// f(<METHOD, SRHD, RESIDENT>) for the runtime choice
template <typename T, template <typename, int, bool, bool> class F,
          typename... Args>
cudaError_t dispatch(int method, int srhd_system, int resident_state,
                     Args... args) {
#define B5_CASE(M, S, R)                                       \
  if (method == M && (srhd_system != 0) == S                   \
      && (resident_state != 0) == R)                           \
    return F<T, M, S, R>::run(args...);
  B5_CASE(1, false, false) B5_CASE(1, false, true)
  B5_CASE(1, true, false) B5_CASE(1, true, true)
  B5_CASE(2, false, false) B5_CASE(2, false, true)
  B5_CASE(2, true, false) B5_CASE(2, true, true)
  B5_CASE(3, false, false) B5_CASE(3, false, true)
  B5_CASE(3, true, false) B5_CASE(3, true, true)
#undef B5_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int M, bool S, bool R>
struct Launch {
  static cudaError_t run(const MarchArgs<T>& a, int ctas, cudaStream_t s) {
    return launch<T, M, S, R>(a, ctas, s);
  }
};

template <typename T, int M, bool S, bool R>
struct Info {
  static cudaError_t run(int lmax, int* out) {
    return info<T, M, S, R>(lmax, out);
  }
};

template <typename T>
int advance_n(const T* u, T* out, const T* geo, T* pw, T* inv_dv, T* prim,
              const int* starts, T* edges, int ctas, int lmax,
              int resident_state, int nr, int n, int method,
              int srhd_system, int warm, double dt, double theta,
              double gamma, void* stream) {
  MarchArgs<T> a;
  a.u = u;
  a.out = out;
  a.geo = geo;
  a.pw = pw;
  a.inv_dv = inv_dv;
  a.prim = prim;
  a.starts = starts;
  a.edges = edges;
  a.nr = nr;
  a.lmax = lmax;
  a.n = n;
  a.warm = srhd_system && warm;
  a.prm.dt = T(dt);
  a.prm.theta = T(theta);
  a.prm.gamma = T(gamma);
  a.prm.gm1 = T(gamma - 1.0);                      // Python's gamma - 1.0
  a.prm.K = T(1.0 + 1.0 / (gamma - 1.0));          // 1 + 1/(gamma - 1)
  return static_cast<int>(dispatch<T, Launch>(
      method, srhd_system, resident_state, a, ctas,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

const char* b5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// (SMs, shared memory a CTA can opt into, shared memory an SM, shared
// memory reserved a CTA) of the current card
int b5_device_limits(int* out) {
  return static_cast<int>(resident::device_limits(out));
}

// The march kernel's registers, local bytes, static shared memory, CTAs an
// SM (out[0..3]) and dynamic shared memory (out[4]) at segments of lmax
int b5_kernel_info(int f64, int method, int srhd, int resident_state,
                   int lmax, int* out) {
  const cudaError_t err =
      f64 ? dispatch<double, Info>(method, srhd, resident_state, lmax, out)
          : dispatch<float, Info>(method, srhd, resident_state, lmax, out);
  return static_cast<int>(err);
}

// n steps of u [nr, 5] into out in one cooperative launch of `ctas` CTAs,
// CTA g owning cells starts[g] .. starts[g + 1] (at least 3, at most lmax);
// geo the [4, nr] geometry (dv, r0^2, r1^2, rc) in u's type; edges two
// buffers of [ctas, 2, 3, 5] in u's type. With resident 0 also pw ([nr],
// zeroed: the warm pressure), inv_dv ([nr]) and prim ([5, nr + 6 ctas]) in
// u's type; with resident 1 they are unused. method 1 pcm, 2 plm, 3 weno5;
// srhd 0 (Euler) or 1; warm 0 or 1 (SRHD only). Returns a cudaError_t.
int b5_advance_n_f32(const float* u, float* out, const float* geo, float* pw,
                     float* inv_dv, float* prim, const int* starts,
                     float* edges, int ctas, int lmax, int resident_state,
                     int nr, int n, int method, int srhd, int warm, double dt,
                     double theta, double gamma, void* stream) {
  return advance_n<float>(u, out, geo, pw, inv_dv, prim, starts, edges, ctas,
                          lmax, resident_state, nr, n, method, srhd, warm,
                          dt, theta, gamma, stream);
}

int b5_advance_n_f64(const double* u, double* out, const double* geo,
                     double* pw, double* inv_dv, double* prim,
                     const int* starts, double* edges, int ctas, int lmax,
                     int resident_state, int nr, int n, int method, int srhd,
                     int warm, double dt, double theta, double gamma,
                     void* stream) {
  return advance_n<double>(u, out, geo, pw, inv_dv, prim, starts, edges,
                           ctas, lmax, resident_state, nr, n, method, srhd,
                           warm, dt, theta, gamma, stream);
}

}  // extern "C"
