// Kernel B2: one advance of the flagship circumbinary-disk scheme on the
// quadtree block layout, after primitive recovery and the primitive guard
// gather.
//
// Replaces mara3_tpu/kernels/binary_advance.py::fused_advance_core2 (with
// its body _kernel2, _main_update_vals and _hlle_viscous). It computes what
// make_advance(fused=True) computes in mara3_tpu/schemes/binary_scheme.py:
// the gradient guard strips from the neighbors' slopes (same, coarse or
// fine neighbor), PLM(theta), locally-isothermal HLLE/HLLC plus viscous
// stress, the angular-momentum flux transform, the coarse-fine flux
// correction, the flux divergence with the gravity/sink/buffer/floor (and
// geometric) sources, the accounting totals with the accretion work done
// on each body (binary_scheme._work_done), and the fault count. The per-cell
// and per-face code is binary_advance_core.cuh, which kernel B3 shares.
//
// Bound: device memory. The update touches about 26 live values per cell
// (per the TPU kernel's own count) for some hundreds of flops per cell: a
// few flops per byte, under the ~20 flops per byte at which an H100's
// published float32 rate (67 TFLOP/s over 3.35 TB/s) would bound it. The
// design keeps that traffic small and the code simple:
//   - three passes (slopes, face fluxes, update) and two small ones (the
//     totals' sum, the work done), one thread per cell or face, in the
//     callers' component-last [B, bs, bs, 3] layout so no transposes
//     surround it; consecutive threads touch consecutive cells;
//   - cell and face positions come from per-block coordinate rows
//     (6 x (bs+1) doubles per block, cache-resident) instead of per-cell
//     position arrays;
//   - the coarse-fine correction is applied inside the update by reading
//     the finer neighbors' boundary fluxes, so no fixup pass rereads the
//     state;
//   - the totals are per-CTA partial sums in double with a second,
//     fixed-order pass: deterministic, unlike atomics; the work done on
//     the bodies is computed from them on the device, so the host reads
//     one small array per advance.
// Shared-memory tiles, fusing the three passes, and CUDA graphs over a step
// are left for later work.
//
// Two entries: b2_advance_* reads dt, theta and the bodies from host
// memory (the reference-shaped loop, where they are host numbers);
// b2_advance_dev_* reads them from a device buffer of kDynamic doubles
// inside the kernels (the device-resident step, where they are tensors
// that the host never reads). Both run the same code on the same values.
//
// Built with --fmad=false so every product is rounded as the plain version
// rounds it; the card's f64 results then agree with the plain version to
// the last few ulps, and the f32 results to round-off.

#include "binary_advance_core.cuh"

namespace {

using namespace mara;

// ---- pass 1: limited slopes of every cell --------------------------------
// the block's own guard strips pg [B, 4, bs, 3] close the stencils
template <typename T>
__global__ void slopes_kernel(const T* __restrict__ p,
                              const T* __restrict__ pg,
                              const double* __restrict__ spacing,
                              T* __restrict__ g, int B, int bs, Params prm,
                              const double* __restrict__ dyn) {
  const long long n = (long long)B * bs * bs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  load_dynamic(prm, dyn);
  slopes_at(p, StripGuard<T>{pg}, spacing, g, idx, bs, T(prm.theta));
}

// ---- pass 2: fluxes through every face -------------------------------------
template <typename T>
__global__ void faces_kernel(const T* __restrict__ p,
                             const T* __restrict__ pg,
                             const T* __restrict__ g,
                             const int* __restrict__ tab,
                             const double* __restrict__ axes,
                             const double* __restrict__ spacing,
                             T* __restrict__ fx, T* __restrict__ fy,
                             int B, int bs, Params prm,
                             const double* __restrict__ dyn) {
  const long long nf = (long long)B * (bs + 1) * bs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * nf) return;
  load_dynamic(prm, dyn);
  face_at(p, StripGuard<T>{pg}, g, tab, axes, spacing, fx, fy, idx, B, bs,
          prm);
}

// ---- pass 3: divergence, sources, update, partial totals -------------------
template <typename T>
__global__ void update_kernel(const T* __restrict__ u0,
                              const T* __restrict__ p,
                              const T* __restrict__ init,
                              const T* __restrict__ br,
                              const T* __restrict__ fx,
                              const T* __restrict__ fy,
                              const int* __restrict__ tab,
                              const double* __restrict__ axes,
                              const double* __restrict__ spacing,
                              T* __restrict__ u1,
                              double* __restrict__ partials,
                              int B, int bs, Params prm,
                              const double* __restrict__ dyn) {
  const long long n = (long long)B * bs * bs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  load_dynamic(prm, dyn);
  double acc[kTotals];
  for (int t = 0; t < kTotals; ++t) acc[t] = 0.0;
  if (idx < n) {
    T V[3];
    update_at(u0, p, init, br, fx, fy, tab, axes, spacing, idx, bs, prm, V,
              acc);
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

// ---- pass 5: accretion work on each body from the totals -------------------
template <typename T>
__global__ void work_done_kernel(double* __restrict__ totals, Params prm,
                                 const double* __restrict__ dyn) {
  load_dynamic(prm, dyn);
  work_done<T>(totals, prm.body);
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename T>
int advance(const T* u0, const T* p, const T* pg, const T* init, const T* br,
            const int* tab, const double* axes, const double* spacing,
            T* g, T* fx, T* fy, T* u1, double* partials, double* totals,
            int B, int bs, const double* hparams, int flags,
            const double* dyn, cudaStream_t stream) {
  const Params prm = read_params(hparams, flags);
  const long long cells = (long long)B * bs * bs;
  const long long faces = 2LL * B * (bs + 1) * bs;
  const int parts = blocks_for(cells);
  slopes_kernel<T><<<blocks_for(cells), kThreads, 0, stream>>>(
      p, pg, spacing, g, B, bs, prm, dyn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  faces_kernel<T><<<blocks_for(faces), kThreads, 0, stream>>>(
      p, pg, g, tab, axes, spacing, fx, fy, B, bs, prm, dyn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  update_kernel<T><<<parts, kThreads, 0, stream>>>(
      u0, p, init, br, fx, fy, tab, axes, spacing, u1, partials, B, bs, prm,
      dyn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  totals_kernel<<<kTotals, kThreads, 0, stream>>>(partials, parts, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  work_done_kernel<T><<<1, 1, 0, stream>>>(totals, prm, dyn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b2_num_partials(int B, int bs) { return blocks_for((long long)B * bs * bs); }

int b2_num_totals() { return kTotals; }

const char* b2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dt, theta and the bodies from hparams on the host ...
int b2_advance_f32(const float* u0, const float* p, const float* pg,
                   const float* init, const float* br, const int* tab,
                   const double* axes, const double* spacing, float* g,
                   float* fx, float* fy, float* u1, double* partials,
                   double* totals, int B, int bs, const double* hparams,
                   int flags, void* stream) {
  return advance<float>(u0, p, pg, init, br, tab, axes, spacing, g, fx, fy,
                        u1, partials, totals, B, bs, hparams, flags, nullptr,
                        static_cast<cudaStream_t>(stream));
}

int b2_advance_f64(const double* u0, const double* p, const double* pg,
                   const double* init, const double* br, const int* tab,
                   const double* axes, const double* spacing, double* g,
                   double* fx, double* fy, double* u1, double* partials,
                   double* totals, int B, int bs, const double* hparams,
                   int flags, void* stream) {
  return advance<double>(u0, p, pg, init, br, tab, axes, spacing, g, fx, fy,
                         u1, partials, totals, B, bs, hparams, flags,
                         nullptr, static_cast<cudaStream_t>(stream));
}

// ... or from dyn, kDynamic doubles on the device
int b2_advance_dev_f32(const float* u0, const float* p, const float* pg,
                       const float* init, const float* br, const int* tab,
                       const double* axes, const double* spacing, float* g,
                       float* fx, float* fy, float* u1, double* partials,
                       double* totals, int B, int bs, const double* hparams,
                       int flags, const double* dyn, void* stream) {
  return advance<float>(u0, p, pg, init, br, tab, axes, spacing, g, fx, fy,
                        u1, partials, totals, B, bs, hparams, flags, dyn,
                        static_cast<cudaStream_t>(stream));
}

int b2_advance_dev_f64(const double* u0, const double* p, const double* pg,
                       const double* init, const double* br, const int* tab,
                       const double* axes, const double* spacing, double* g,
                       double* fx, double* fy, double* u1, double* partials,
                       double* totals, int B, int bs, const double* hparams,
                       int flags, const double* dyn, void* stream) {
  return advance<double>(u0, p, pg, init, br, tab, axes, spacing, g, fx, fy,
                         u1, partials, totals, B, bs, hparams, flags, dyn,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
