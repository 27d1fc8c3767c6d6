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
// G = 4 steps per stripe on the TPU) is not done here; kernels B9 and B10c
// (iso2d_ladder.cu) do it, on the same per-face and per-cell arithmetic
// (iso2d_cell.cuh).
//
// Built with --fmad=false, with the scalars cast to the state's type before
// use and 0.5 * theta formed in that type, 1 / (ap - am) taken before the
// multiply, and the half-slope's sign test on sign bits: the results then
// match the plain version to an ulp or two in float32 and float64.

#include <cuda_runtime.h>

#include "iso2d_cell.cuh"

namespace {

using iso2d::Params;

constexpr int kTX = 16;          // tile rows (x)
constexpr int kTY = 32;          // tile columns (y, contiguous)
constexpr int kHalo = 2;
constexpr int kPX = kTX + 2 * kHalo;
constexpr int kPY = kTY + 2 * kHalo;
constexpr int kThreads = 256;

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
    const long long c = (long long)iso2d::wrap(i0 + a - kHalo, nx) * ny
                        + iso2d::wrap(j0 + b - kHalo, ny);
    const T sg = src[c];
    P[0][a][b] = sg;
    P[1][a][b] = src[plane + c] / sg;
    P[2][a][b] = src[2 * plane + c] / sg;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < (kTX + 1) * kTY; k += kThreads) {
    const int a = k / kTY, b = k % kTY;
    const int r = a + 1, s = b + kHalo;     // L cell's row in P
    T m[3], c0[3], c1[3], pp[3], f[3];
    for (int q = 0; q < 3; ++q) {
      m[q] = P[q][r - 1][s];
      c0[q] = P[q][r][s];
      c1[q] = P[q][r + 1][s];
      pp[q] = P[q][r + 2][s];
    }
    iso2d::face_flux<T, HLLC, false>(m, c0, c1, pp, p, f);
    for (int q = 0; q < 3; ++q) FX[q][a][b] = f[q];
  }
  for (int k = threadIdx.x; k < kTX * (kTY + 1); k += kThreads) {
    const int a = k / (kTY + 1), b = k % (kTY + 1);
    const int r = a + kHalo, s = b + 1;     // L cell's column in P
    T m[3], c0[3], c1[3], pp[3], f[3];
    for (int q = 0; q < 3; ++q) {
      m[q] = P[q][r][s - 1];
      c0[q] = P[q][r][s];
      c1[q] = P[q][r][s + 1];
      pp[q] = P[q][r][s + 2];
    }
    iso2d::face_flux<T, HLLC, true>(m, c0, c1, pp, p, f);
    for (int q = 0; q < 3; ++q) FY[q][a][b] = f[q];
  }
  __syncthreads();

  for (int k = threadIdx.x; k < kTX * kTY; k += kThreads) {
    const int a = k / kTY, b = k % kTY;
    const int i = i0 + a, j = j0 + b;
    if (i >= nx || j >= ny) continue;
    const long long c = (long long)i * ny + j;
    for (int q = 0; q < 3; ++q) {
      const T e = iso2d::cell_update(src[q * plane + c], FX[q][a][b],
                                     FX[q][a + 1][b], FY[q][a][b],
                                     FY[q][a][b + 1], p);
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
  const Params<T> p = iso2d::make_params<T>(cs2, dtdx, dtdy, theta);
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
