// Kernel B11c: the flagship advance of the "jnp_strips" variant
// (make_advance(fused="jnp_strips")), with its guard strips built outside.
//
// Replaces mara3_tpu/kernels/binary_advance.py::fused_advance_core (body
// _kernel and _main_update_vals): B2's advance, except that
//   - the guard primitives and the guard slopes come from one packed strip
//     tensor [B, 4, bs, 9] (faces x-lo, x-hi, y-lo, y-hi; components
//     p | gx | gy), built by the scheme's torch front;
//   - cell and face positions are formed from each block's (x0, y0, dx)
//     and the cell index, x = x0 + (i + 1/2) dx, as the TPU kernel forms
//     them from an iota, and the buffer damping rate from the position;
//   - the coarse-fine flux correction is not applied here: the kernel
//     leaves the uncorrected update and its edge fluxes, and the scheme's
//     edge fixup adds (restricted fine flux - own flux) dt / dA.
// The face flux is the TPU kernel's (binary_tpu_flux.cuh, HLLE or HLLC);
// the slopes and the per-cell update are binary_advance_core.cuh's.
//
// Bound: device memory, as B2 (about 26 live values a cell for some
// hundreds of flops). Three passes (slopes, face fluxes, update), one thread
// a cell or face, and a fixed-order sum of the per-CTA totals.
//
// Built with --fmad=false, so every product is rounded as the plain version
// (kernels/binary_advance.advance_core_strips_plain) rounds it.

#include "binary_tpu_flux.cuh"

namespace {

using namespace mara;

constexpr int kStrip = 9;   // p | gx | gy

// guard primitives from the packed strips [B, 4, bs, 9]
template <typename T>
struct PackedGuard {
  const T* strips;
  __device__ void operator()(int b, int f, int pos, int bs, T out[3]) const {
    const T* s = strips + (((long long)b * 4 + f) * bs + pos) * kStrip;
    for (int c = 0; c < 3; ++c) out[c] = s[c];
  }
};

// the block's (x0, y0, dx) and the position k + off along it
template <typename T>
__device__ __forceinline__ T iota_coord(T x0, T dx, int k, T off) {
  return x0 + (T(k) + off) * dx;
}

// ---- pass 1: limited slopes of every cell --------------------------------
template <typename T>
__global__ void slopes_kernel(const T* __restrict__ p,
                              const T* __restrict__ strips,
                              const double* __restrict__ spacing,
                              T* __restrict__ g, int B, int bs, Params prm,
                              const double* __restrict__ dyn) {
  const long long n = (long long)B * bs * bs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  load_dynamic(prm, dyn);
  slopes_at(p, PackedGuard<T>{strips}, spacing, g, idx, bs, T(prm.theta));
}

// ---- pass 2: fluxes through every face -------------------------------------
// idx runs over the x-faces fx [B, bs+1, bs, 3], then the y-faces fy
// [B, bs, bs+1, 3]; a face on a block edge takes its outer state and slopes
// from the packed strips
template <typename T>
__global__ void faces_kernel(const T* __restrict__ p,
                             const T* __restrict__ strips,
                             const T* __restrict__ g,
                             const T* __restrict__ geo,
                             T* __restrict__ fx, T* __restrict__ fy, int B,
                             int bs, Params prm,
                             const double* __restrict__ dyn) {
  const long long nf = (long long)B * (bs + 1) * bs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * nf) return;
  load_dynamic(prm, dyn);
  const int axis = idx >= nf;
  const long long r = axis ? idx - nf : idx;
  const int per_block = (bs + 1) * bs;
  const int b = r / per_block;
  const int rem = r % per_block;
  const int i = axis == 0 ? rem / bs : rem / (bs + 1);
  const int j = axis == 0 ? rem % bs : rem % (bs + 1);
  const int k = axis == 0 ? i : j;         // face index along the axis
  const int pos = axis == 0 ? j : i;       // position along the face
  T pl[3], pr[3], gL[6], gR[6];
  if (k == 0) {
    const T* s = strips + (((long long)b * 4 + 2 * axis) * bs + pos) * kStrip;
    for (int c = 0; c < 3; ++c) pl[c] = s[c];
    for (int c = 0; c < 6; ++c) gL[c] = s[3 + c];
  } else {
    const long long cell = axis == 0
        ? ((long long)b * bs + (i - 1)) * bs + j
        : ((long long)b * bs + i) * bs + (j - 1);
    for (int c = 0; c < 3; ++c) pl[c] = p[cell * 3 + c];
    for (int c = 0; c < 6; ++c) gL[c] = g[cell * 6 + c];
  }
  if (k == bs) {
    const T* s =
        strips + (((long long)b * 4 + 2 * axis + 1) * bs + pos) * kStrip;
    for (int c = 0; c < 3; ++c) pr[c] = s[c];
    for (int c = 0; c < 6; ++c) gR[c] = s[3 + c];
  } else {
    const long long cell = ((long long)b * bs + i) * bs + j;
    for (int c = 0; c < 3; ++c) pr[c] = p[cell * 3 + c];
    for (int c = 0; c < 6; ++c) gR[c] = g[cell * 6 + c];
  }
  // x-faces sit at x0 + i dx, y0 + (j + 1/2) dx; y-faces at
  // x0 + (i + 1/2) dx, y0 + j dx
  const T x0 = geo[b * 3], y0 = geo[b * 3 + 1], dx = geo[b * 3 + 2];
  const T x = iota_coord(x0, dx, i, axis == 0 ? T(0) : T(0.5));
  const T y = iota_coord(y0, dx, j, axis == 0 ? T(0.5) : T(0));
  const int lo = axis == 0 ? 0 : 3, tr = axis == 0 ? 3 : 0;
  T out[3];
  face_flux_tpu(axis, pl, pr, gL + lo, gR + lo, gL + tr, gR + tr, x, y, dx,
                prm, false, out);
  T* dst = axis == 0 ? fx : fy;
  for (int c = 0; c < 3; ++c) dst[r * 3 + c] = out[c];
}

// ---- pass 3: divergence, sources, update, partial totals -------------------
template <typename T>
__global__ void update_kernel(const T* __restrict__ u0,
                              const T* __restrict__ p,
                              const T* __restrict__ init,
                              const T* __restrict__ geo,
                              const T* __restrict__ fx,
                              const T* __restrict__ fy,
                              T* __restrict__ u1,
                              double* __restrict__ partials, int B, int bs,
                              double buffer_rate, Params prm,
                              const double* __restrict__ dyn) {
  const long long n = (long long)B * bs * bs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  load_dynamic(prm, dyn);
  double acc[kTotals];
  for (int t = 0; t < kTotals; ++t) acc[t] = 0.0;
  if (idx < n) {
    const int j = idx % bs;
    const int i = (idx / bs) % bs;
    const int b = idx / ((long long)bs * bs);
    const T x0 = geo[b * 3], y0 = geo[b * 3 + 1], dx = geo[b * 3 + 2];
    const T x = iota_coord(x0, dx, i, T(0.5));
    const T y = iota_coord(y0, dx, j, T(0.5));
    // the buffer damping rate at the cell (subprog_binary_solver_data.cpp:
    // 61-76), formed here as the TPU kernel forms it
    const T r_cell = sqrt(x * x + y * y);
    const T brc = T(buffer_rate)
        * (T(1) + tanh(T(3) * (r_cell - T(prm.domain_radius))));
    const long long fxl = ((long long)b * (bs + 1) + i) * bs + j;
    const long long fyl = ((long long)b * bs + i) * (bs + 1) + j;
    T U[3], P[3], in[3], div[3], V[3];
    for (int c = 0; c < 3; ++c) {
      U[c] = u0[idx * 3 + c];
      P[c] = p[idx * 3 + c];
      in[c] = init[idx * 3 + c];
      div[c] = (fx[(fxl + bs) * 3 + c] - fx[fxl * 3 + c])
             + (fy[(fyl + 1) * 3 + c] - fy[fyl * 3 + c]);
    }
    update_cell<T, true>(U, P, in, brc, div, x, y, dx * dx, prm, V, acc);
    for (int c = 0; c < 3; ++c) u1[idx * 3 + c] = V[c];
  }
  block_sum(acc, partials + (long long)blockIdx.x * kTotals);
}

// ---- pass 4: fixed-order sum of the per-CTA partials, one CTA a total ------
__global__ void totals_kernel(const double* __restrict__ partials, int parts,
                              double* __restrict__ totals) {
  const double v = sum_total(partials, parts, blockIdx.x);
  if (threadIdx.x == 0) totals[blockIdx.x] = v;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename T>
int advance(const T* u0, const T* p, const T* strips, const T* geo,
            const T* init, const double* spacing, T* g, T* fx, T* fy, T* u1,
            double* partials, double* totals, int B, int bs,
            double buffer_rate, const double* hparams, int flags,
            const double* dyn, cudaStream_t stream) {
  const Params prm = read_params(hparams, flags);
  const long long cells = (long long)B * bs * bs;
  const long long faces = 2LL * B * (bs + 1) * bs;
  const int parts = blocks_for(cells);
  slopes_kernel<T><<<blocks_for(cells), kThreads, 0, stream>>>(
      p, strips, spacing, g, B, bs, prm, dyn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  faces_kernel<T><<<blocks_for(faces), kThreads, 0, stream>>>(
      p, strips, g, geo, fx, fy, B, bs, prm, dyn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  update_kernel<T><<<parts, kThreads, 0, stream>>>(
      u0, p, init, geo, fx, fy, u1, partials, B, bs, buffer_rate, prm, dyn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  totals_kernel<<<kTotals, kThreads, 0, stream>>>(partials, parts, totals);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b11c_num_partials(int B, int bs) {
  return blocks_for((long long)B * bs * bs);
}

int b11c_num_totals() { return kTotals; }

const char* b11c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dyn: kDynamic doubles on the device (dt, theta, the bodies), or null to
// take them from hparams
int b11c_advance_f32(const float* u0, const float* p, const float* strips,
                     const float* geo, const float* init,
                     const double* spacing, float* g, float* fx, float* fy,
                     float* u1, double* partials, double* totals, int B,
                     int bs, double buffer_rate, const double* hparams,
                     int flags, const double* dyn, void* stream) {
  return advance<float>(u0, p, strips, geo, init, spacing, g, fx, fy, u1,
                        partials, totals, B, bs, buffer_rate, hparams, flags,
                        dyn, static_cast<cudaStream_t>(stream));
}

int b11c_advance_f64(const double* u0, const double* p, const double* strips,
                     const double* geo, const double* init,
                     const double* spacing, double* g, double* fx,
                     double* fy, double* u1, double* partials,
                     double* totals, int B, int bs, double buffer_rate,
                     const double* hparams, int flags, const double* dyn,
                     void* stream) {
  return advance<double>(u0, p, strips, geo, init, spacing, g, fx, fy, u1,
                         partials, totals, B, bs, buffer_rate, hparams, flags,
                         dyn, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
