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
//   - each stage is the column march of iso2d_march.cuh on the periodic
//     plane (rows wrap, addressed once a chunk): CTAs of W = 64 columns
//     and chunks of up to R = 64 rows (kMarchW, kMarchR); each primitive,
//     half-slope and face flux is computed once, each value read from
//     device memory about (R + 4) / R times a stage and written once.
// Temporal blocking (several steps per pass over the state, as v5's
// G = 4 steps per stripe on the TPU) is not done here; the x-sharded
// kernel B9 (iso2d_ladder.cu) runs the same march in stripe windows, and
// B10c (iso2d_ladder.cu) blocks in time on the same per-face and per-cell
// arithmetic (iso2d_cell.cuh).
//
// Built with --fmad=false, with the scalars cast to the state's type before
// use and 0.5 * theta formed in that type, 1 / (ap - am) taken before the
// multiply, and the half-slope's sign test on sign bits: the results then
// match the plain version to an ulp or two in float32 and float64.

#include <cuda_runtime.h>

#include "iso2d_march.cuh"

namespace {

using iso2d::Params;

template <typename T, bool HLLC>
cudaError_t run(const T* u, T* out, T* scr, int nx, int ny, int n, int rk,
                const Params<T>& p, cudaStream_t stream) {
  const auto stage = [&](const T* src, const T* base, T* dst) {
    const iso2d::Rows<T> b = base ? iso2d::plane_rows(base, nx, ny)
                                  : iso2d::Rows<T>();
    return iso2d::march_stage<T, HLLC>(
        iso2d::plane_rows(src, nx, ny), b, iso2d::plane_rows(dst, nx, ny),
        base != nullptr, 0, nx, ny, 1, p, stream);
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

// The march kernel's registers, local bytes, static shared memory and CTAs
// an SM (out[0..3]); f64 and hllc 0 or 1
int b1_kernel_info(int f64, int hllc, int* out) {
  cudaError_t err;
  if (f64) {
    err = hllc ? iso2d::march_info<double, true>(out)
               : iso2d::march_info<double, false>(out);
  } else {
    err = hllc ? iso2d::march_info<float, true>(out)
               : iso2d::march_info<float, false>(out);
  }
  return static_cast<int>(err);
}

}  // extern "C"
