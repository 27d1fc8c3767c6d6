// Kernel B1: n periodic steps of the 2D isothermal Godunov scheme (PLM +
// HLLE or HLLC, forward Euler or SSP-RK2) on a uniform grid, state
// u [3, nx, ny] with y contiguous.
//
// Replaces mara3_tpu/kernels/iso2d_step_v5.py:179 (advance_n_pallas_v5,
// with its step body iso2d_step_v4._step_stripe and the solvers and
// half-slope of iso2d_step.py). It computes what kernels/iso2d_step.py's
// advance_n_plain computes, operation for operation.
//
// Bound: on this card both limits are near. A step needs about 194
// operations a cell with HLLE (212 with HLLC, counted in chip_smoke.py),
// 0.025 ms at 2048^2 in float32 at 33.5e12 operations a second (no FMAs
// under --fmad=false); an n-step call need only read and write the state
// once (6 values a cell), so it is bound by operations. But a design that
// keeps the state in device memory between steps moves it every step:
// 100.7 MB at 2048^2 float32, 0.030 ms a step at 3.35 TB/s, which is the
// floor of this design. What the design does:
//   - one launch per stage; a C loop issues all n steps (2n launches for
//     rk2) on the caller's stream, so n is any count >= 0 and nothing waits
//     on the host. The wrapper's output and scratch buffers ping-pong, and
//     no launch reads what another CTA of the same launch writes (rk2's
//     second stage writes the average in place over the step's start,
//     which each thread reads only at its own cell);
//   - each CTA loads a 16 x 32 tile of the three primitives with a two-cell
//     periodic halo (index arithmetic, any nx, ny >= 4) into shared memory
//     once, computes every x- and y-face flux of the tile once into shared
//     memory, then updates its cells: each value is read from device memory
//     about 1.4 times a stage (the halo) and written once;
//   - the half-slopes are recomputed for the two faces of a cell instead of
//     stored, trading about 66 operations a face for shared memory and a
//     barrier.
// Temporal blocking (several steps per pass over the state, as v5's
// G = 4 steps per stripe on the TPU) is left for later work.
//
// Built with --fmad=false, with the scalars cast to the state's type before
// use and 0.5 * theta formed in that type, 1 / (ap - am) taken before the
// multiply, and the half-slope's sign test on sign bits: the results then
// match the plain version to an ulp or two in float32 and float64.

#include <cuda_runtime.h>
#include <math.h>

#include <cmath>

namespace {

constexpr int kTX = 16;          // tile rows (x)
constexpr int kTY = 32;          // tile columns (y, contiguous)
constexpr int kHalo = 2;
constexpr int kPX = kTX + 2 * kHalo;
constexpr int kPY = kTY + 2 * kHalo;
constexpr int kThreads = 256;

template <typename T>
struct Params {
  T cs2, cs, dtdx, dtdy, half_theta;
};

// 0.5 * the minmod slope: copysign(min |.|, a) when the three sign bits
// agree, else 0 (mara3_tpu/kernels/iso2d_step.py::_plm_half)
template <typename T>
__device__ __forceinline__ T plm_half(T yl, T y0, T yr, T half_theta) {
  const T a = (y0 - yl) * half_theta;
  const T b = (yr - yl) * T(0.25);
  const T c = (yr - y0) * half_theta;
  const bool sa = signbit(a), sb = signbit(b), sc = signbit(c);
  const T m = fmin(fmin(fabs(a), fabs(b)), fabs(c));
  return (sa == sb && sb == sc) ? copysign(m, a) : T(0);
}

// HLLE flux along the face normal from (density, normal velocity,
// transverse velocity) face states (iso2d_step.py::_hlle_1d)
template <typename T>
__device__ __forceinline__ void hlle(T sgl, T vnl, T vtl, T sgr, T vnr,
                                     T vtr, const Params<T>& p, T f[3]) {
  const T ap = fmax(fmax(vnl + p.cs, vnr + p.cs), T(0));
  const T am = fmin(fmin(vnl - p.cs, vnr - p.cs), T(0));
  const T ul1 = sgl * vnl, ul2 = sgl * vtl;
  const T ur1 = sgr * vnr, ur2 = sgr * vtr;
  const T pl = sgl * p.cs2, pr = sgr * p.cs2;
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
                                     T vtr, const Params<T>& p, T f[3]) {
  const T cs = p.cs;
  const T pl = sgl * p.cs2, pr = sgr * p.cs2;
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
                                        T vtr, const Params<T>& p, T f[3]) {
  if (HLLC) {
    hllc(sgl, vnl, vtl, sgr, vnr, vtr, p, f);
  } else {
    hlle(sgl, vnl, vtl, sgr, vnr, vtr, p, f);
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// One stage on one 16 x 32 tile: dst = E(src), or with `base` (rk2's second
// stage) dst = 0.5 * (base + E(src)); base may be dst itself.
template <typename T, bool HLLC>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* __restrict__ src, const T* base, T* dst, int nx,
             int ny, Params<T> p) {
  __shared__ T P[3][kPX][kPY];          // sigma, vx, vy with the halo
  __shared__ T FX[3][kTX + 1][kTY];     // x face a: between rows a-1 and a
  __shared__ T FY[3][kTX][kTY + 1];     // y face b: between columns b-1 and b
  const int i0 = blockIdx.y * kTX, j0 = blockIdx.x * kTY;
  const long long plane = (long long)nx * ny;

  for (int k = threadIdx.x; k < kPX * kPY; k += kThreads) {
    const int a = k / kPY, b = k % kPY;
    const long long c = (long long)wrap(i0 + a - kHalo, nx) * ny
                        + wrap(j0 + b - kHalo, ny);
    const T sg = src[c];
    P[0][a][b] = sg;
    P[1][a][b] = src[plane + c] / sg;
    P[2][a][b] = src[2 * plane + c] / sg;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < (kTX + 1) * kTY; k += kThreads) {
    const int a = k / kTY, b = k % kTY;
    const int r = a + 1, s = b + kHalo;     // L cell's row in P
    T L[3], R[3], f[3];
    for (int q = 0; q < 3; ++q) {
      const T m = P[q][r - 1][s], c0 = P[q][r][s], c1 = P[q][r + 1][s],
              pp = P[q][r + 2][s];
      L[q] = c0 + plm_half(m, c0, c1, p.half_theta);
      R[q] = c1 - plm_half(c0, c1, pp, p.half_theta);
    }
    riemann<T, HLLC>(L[0], L[1], L[2], R[0], R[1], R[2], p, f);
    for (int q = 0; q < 3; ++q) FX[q][a][b] = f[q];
  }
  for (int k = threadIdx.x; k < kTX * (kTY + 1); k += kThreads) {
    const int a = k / (kTY + 1), b = k % (kTY + 1);
    const int r = a + kHalo, s = b + 1;     // L cell's column in P
    T L[3], R[3], f[3];
    for (int q = 0; q < 3; ++q) {
      const T m = P[q][r][s - 1], c0 = P[q][r][s], c1 = P[q][r][s + 1],
              pp = P[q][r][s + 2];
      L[q] = c0 + plm_half(m, c0, c1, p.half_theta);
      R[q] = c1 - plm_half(c0, c1, pp, p.half_theta);
    }
    // the normal is vy: the solver's normal-momentum flux is the y one
    riemann<T, HLLC>(L[0], L[2], L[1], R[0], R[2], R[1], p, f);
    FY[0][a][b] = f[0];
    FY[1][a][b] = f[2];
    FY[2][a][b] = f[1];
  }
  __syncthreads();

  for (int k = threadIdx.x; k < kTX * kTY; k += kThreads) {
    const int a = k / kTY, b = k % kTY;
    const int i = i0 + a, j = j0 + b;
    if (i >= nx || j >= ny) continue;
    const long long c = (long long)i * ny + j;
    for (int q = 0; q < 3; ++q) {
      const T d = (FX[q][a + 1][b] - FX[q][a][b]) * p.dtdx
                  + (FY[q][a][b + 1] - FY[q][a][b]) * p.dtdy;
      const T e = src[q * plane + c] - d;
      dst[q * plane + c] = base ? T(0.5) * (base[q * plane + c] + e) : e;
    }
  }
}

template <typename T, bool HLLC>
cudaError_t run(const T* u, T* out, T* scr, int nx, int ny, int n, int rk,
                const Params<T>& p, cudaStream_t stream) {
  const dim3 grid((ny + kTY - 1) / kTY, (nx + kTX - 1) / kTX);
  const auto stage = [&](const T* src, const T* base, T* dst) {
    stage_kernel<T, HLLC><<<grid, kThreads, 0, stream>>>(src, base, dst, nx,
                                                         ny, p);
    return cudaGetLastError();
  };
  cudaError_t err = cudaSuccess;
  if (rk == 1) {
    // step k writes out when n - k is even, so the last step lands in out
    const T* src = u;
    for (int k = 1; k <= n && err == cudaSuccess; ++k) {
      T* dst = ((n - k) % 2 == 0) ? out : scr;
      err = stage(src, nullptr, dst);
      src = dst;
    }
  } else {
    // scr = E(cur); out = 0.5 * (cur + E(scr)), cur = u, then out in place
    const T* cur = u;
    for (int k = 0; k < n && err == cudaSuccess; ++k) {
      err = stage(cur, nullptr, scr);
      if (err == cudaSuccess) err = stage(scr, cur, out);
      cur = out;
    }
  }
  return err;
}

template <typename T>
int advance_n(const T* u, T* out, T* scr, int nx, int ny, int n, int rk,
              int hllc, double cs2, double dtdx, double dtdy, double theta,
              void* stream) {
  Params<T> p;
  p.cs2 = T(cs2);
  p.cs = std::sqrt(p.cs2);   // correctly rounded in T, as on the device
  p.dtdx = T(dtdx);
  p.dtdy = T(dtdy);
  p.half_theta = T(0.5) * T(theta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hllc ? run<T, true>(u, out, scr, nx, ny, n, rk, p, s)
           : run<T, false>(u, out, scr, nx, ny, n, rk, p, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* b1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n steps of u [3, nx, ny] into out; scr is a second buffer of u's size.
// rk 1 or 2; hllc 0 (HLLE) or 1 (HLLC). Returns a cudaError_t.
int b1_advance_n_f32(const float* u, float* out, float* scr, int nx, int ny,
                     int n, int rk, int hllc, double cs2, double dtdx,
                     double dtdy, double theta, void* stream) {
  return advance_n<float>(u, out, scr, nx, ny, n, rk, hllc, cs2, dtdx, dtdy,
                          theta, stream);
}

int b1_advance_n_f64(const double* u, double* out, double* scr, int nx,
                     int ny, int n, int rk, int hllc, double cs2, double dtdx,
                     double dtdy, double theta, void* stream) {
  return advance_n<double>(u, out, scr, nx, ny, n, rk, hllc, cs2, dtdx, dtdy,
                           theta, stream);
}

}  // extern "C"
